"""Continuous-batching scheduler.

Plans work in fixed shapes — prefill chunks padded to buckets, decode
as a constant-width slot batch — as the JAX engine's scheduler does.
A step is one batch of prefill chunks or one decode batch over all
running sequences; the two alternate when both have work so neither
starves. With the unified step on, prefill chunks are admitted INTO
decode steps instead (``_plan_mixed``), and ``plan_ahead`` plans
decode step N+1 while step N is in flight (the async pipeline).

Ported: the bimodal plans, the mixed plan, the plan-ahead, decode
bursts (a pure decode plan's ``window`` of ``decode_steps`` tokens a
row) and speculative drafts from the n-gram proposer (engine/spec.py),
planned as verify steps or carried by the mixed step's decode rows. Not
ported yet: context-parallel whole-prompt prefill, offload
restore/evict hooks and disaggregated handoffs.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Deque, Dict, List, Optional

from production_stack_tpu_torch.engine.config import (
    CacheConfig,
    SchedulerConfig,
)
from production_stack_tpu_torch.engine.kv_cache import (
    OutOfPagesError,
    PagedCacheManager,
)
from production_stack_tpu_torch.engine.sequence import (
    FinishReason,
    Sequence,
    SequenceState,
    decode_budget,
)
from production_stack_tpu_torch.engine.spec import NgramProposer
from production_stack_tpu_torch.utils.log import init_logger

logger = init_logger(__name__)

# Sustained overload preempts on every planning pass; the per-victim
# warning is rate-limited to one line per interval (with a
# suppressed-count) so logging can't become the bottleneck.
_PREEMPT_LOG_INTERVAL_S = 5.0


@dataclass
class PrefillChunk:
    seq: Sequence
    chunk_start: int  # absolute position of first token in chunk
    chunk_tokens: List[int]
    is_last_chunk: bool


@dataclass
class PrefillPlan:
    """One batched prefill step: the next chunk of up to
    ``prefill_batch_size`` DISTINCT waiting sequences, padded to a
    fixed row count."""

    chunks: List[PrefillChunk]


@dataclass
class DecodePlan:
    seqs: List[Sequence]
    # Decode iterations of this dispatch (1 = single step). Decided
    # here so the page reservation and the runner's burst agree on the
    # same lookahead.
    window: int = 1
    # Speculative verify step: per-row draft tokens parallel to
    # ``seqs`` ([] = a plain single-token row in the same block).
    # None = normal decode.
    drafts: Optional[List[List[int]]] = None


@dataclass
class StepPlan:
    prefill: Optional[PrefillPlan] = None
    decode: Optional[DecodePlan] = None

    @property
    def empty(self) -> bool:
        return self.prefill is None and self.decode is None


class Scheduler:
    def __init__(self, config: SchedulerConfig, cache_config: CacheConfig,
                 cache_manager: PagedCacheManager, guided_advance=None):
        # Optional hook(seq, token) advancing a guided row's automaton
        # state as its tokens are appended (the engine binds it, so the
        # host state mirrors the device's).
        self.guided_advance = guided_advance
        self.config = config
        self.page_size = cache_config.page_size
        self.cache = cache_manager
        self.waiting: Deque[Sequence] = deque()
        self.running: List[Sequence] = []
        self._last_was_prefill = False
        self._preempt_log_ts = float("-inf")
        self._preempt_log_suppressed = 0
        # Sequences aborted by the scheduler itself (oversized prompts,
        # permanent cache starvation); the engine drains this to emit
        # terminal outputs to their clients.
        self.newly_aborted: List[Sequence] = []
        # Cumulative count of sequences preempted for KV-cache
        # pressure (vllm:num_preemptions_total parity).
        self.num_preemptions = 0
        # Prefill token budget a unified (mixed) step may admit: a
        # dedicated prefill step's full bandwidth.
        self.mixed_prefill_budget = (config.prefill_chunk_size
                                     * config.prefill_batch_size)
        # Draft-free speculative decoding: the prompt-lookup proposer
        # drafts from each sequence's own history; None when off.
        self.proposer = (NgramProposer(config.speculative_k,
                                       config.speculative_min_match)
                         if config.speculative_k > 0 else None)

    # ---- queue management -------------------------------------------------

    def add_sequence(self, seq: Sequence) -> None:
        if len(self.waiting) >= self.config.max_queue_len:
            seq.transition(SequenceState.ABORTED)
            seq.finish_reason = FinishReason.ABORT
            raise RuntimeError("Scheduler queue full")
        if seq.num_prompt_tokens >= self.config.max_model_len:
            seq.transition(SequenceState.ABORTED)
            seq.finish_reason = FinishReason.ABORT
            raise ValueError(
                f"Prompt is {seq.num_prompt_tokens} tokens but "
                f"max_model_len is {self.config.max_model_len}"
            )
        max_prompt_pages = (self.config.max_pages_per_seq(self.page_size)
                            * self.page_size)
        if seq.num_prompt_tokens >= min(
                max_prompt_pages,
                (self.cache.config.num_pages - 1) * self.page_size):
            seq.transition(SequenceState.ABORTED)
            seq.finish_reason = FinishReason.ABORT
            raise ValueError(
                f"Prompt of {seq.num_prompt_tokens} tokens cannot fit "
                "in the KV cache"
            )
        if seq.num_prompt_tokens + seq.sampling.max_tokens > \
                self.config.max_model_len:
            # Clamp generation to fit the model length budget.
            seq.sampling.max_tokens = max(
                1, self.config.max_model_len - seq.num_prompt_tokens
            )
        self.waiting.append(seq)

    def abort_sequence(self, seq: Sequence) -> None:
        self._finish(seq, FinishReason.ABORT)
        if seq in self.running:
            self.running.remove(seq)
        try:
            self.waiting.remove(seq)
        except ValueError:
            pass

    @property
    def num_waiting(self) -> int:
        return len(self.waiting)

    @property
    def num_running(self) -> int:
        return len(self.running)

    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

    @staticmethod
    def _needs_row_inputs(seq: Sequence, ahead: int = 0) -> bool:
        """Rows with per-row sampling inputs that unified, verify and
        ahead steps do not carry (the JAX scheduler's exclusion set):
        penalties, a seed, ``logit_bias``, ``min_tokens`` still to reach
        and a guided automaton state. ``ahead`` counts the tokens an
        in-flight step will have committed first (plan-ahead: 1).
        Logprobs are not in the set: every step kind returns them."""
        sp = seq.sampling
        return (sp.needs_penalties or sp.seed is not None
                or bool(sp.logit_bias)
                or sp.min_tokens > seq.num_generated + ahead
                or seq.fsm_state is not None)

    # ---- planning ---------------------------------------------------------

    def plan_step(self) -> StepPlan:
        want_prefill = bool(
            self.waiting
            and len(self.running) < self.config.max_num_seqs
        )
        want_decode = bool(self.running)
        if self.config.unified_step and want_prefill and want_decode:
            # Unified ragged step: admit prefill chunks INTO the decode
            # step under a token budget instead of alternating whole
            # steps. Falls through to the bimodal alternation when a
            # row needs per-token host state the ragged program does
            # not carry.
            plan = self._plan_mixed()
            if plan is not None and not plan.empty:
                return plan
        if want_prefill and want_decode:
            # Alternate so neither side starves.
            do_prefill = not self._last_was_prefill
        else:
            do_prefill = want_prefill
        if do_prefill:
            plan = self._plan_prefill()
            if plan is not None:
                self._last_was_prefill = True
                return StepPlan(prefill=plan)
            want_decode = bool(self.running)
        if want_decode:
            self._last_was_prefill = False
            if self.proposer is not None:
                plan = self._plan_spec()
                if plan is not None:
                    return StepPlan(decode=plan)
            window = self._decode_window()
            self._ensure_decode_capacity(window)
            if self.running:
                return StepPlan(decode=DecodePlan(
                    seqs=list(self.running), window=window))
        return StepPlan()

    def _propose(self) -> Dict[str, List[int]]:
        """Each running row's drafts, capped by its emit budget; rows
        the proposer has nothing for are left out."""
        drafts: Dict[str, List[int]] = {}
        for seq in self.running:
            d = self.proposer.propose(seq, self._draft_limit(seq))
            if d:
                drafts[seq.seq_id] = d
        return drafts

    def _plan_spec(self) -> Optional[DecodePlan]:
        """Plan one speculative verify step, or None to fall back to
        plain decode (no row drafted anything, or a row needs per-row
        inputs the verify step does not carry). Every running row
        rides the same [B, K + 1] block: rows without drafts decode
        one token in it."""
        if any(self._needs_row_inputs(seq) for seq in self.running):
            return None
        drafts = self._propose()
        if not drafts:
            return None
        # Hybrid profitability gate: a verify step displaces a decode
        # burst of `window` tokens a row; take it only when, at full
        # acceptance, it emits at least as many tokens (each row emits
        # accepted + 1), else defer: the drafts regrow from the same
        # history on a later step. With decode_steps 1 it always passes.
        window = self._decode_window()
        if (sum(len(d) for d in drafts.values()) + len(self.running)
                < window * len(self.running)):
            return None
        # Reserve pages for 1 + draft_len tokens per row; preemption
        # inside the pass may shrink `running` (victims' drafts are
        # dropped with them).
        self._ensure_decode_capacity(per_seq={
            s.seq_id: 1 + len(drafts.get(s.seq_id, ()))
            for s in self.running})
        plan_drafts = [drafts.get(s.seq_id, []) for s in self.running]
        if not any(plan_drafts):
            return None
        return DecodePlan(seqs=list(self.running), drafts=plan_drafts)

    def _plan_mixed(self) -> Optional[StepPlan]:
        """Plan one unified ragged step: every running sequence as a
        decode row (with prompt-lookup drafts when the proposer has
        them: a draft row is a verify row of the same block) plus
        waiting prefill chunks admitted under a token budget matching
        a dedicated prefill step's full bandwidth
        (``prefill_chunk_size * prefill_batch_size``), so admission
        proceeds exactly as fast as alternation would while decode rows
        keep emitting. Returns None to fall back to bimodal alternation
        when a running row needs per-row inputs the ragged step does
        not carry, or a waiting one does (its first token must be
        sampled in a prefill step, through its options; the JAX
        scheduler checks running rows only, and samples such a row's
        first token without them)."""
        if any(self._needs_row_inputs(seq)
               for seq in list(self.running) + list(self.waiting)):
            return None
        drafts = self._propose() if self.proposer is not None else {}
        # Reserve decode-side pages first (1 + draft_len per row);
        # preemption here shrinks `running` before prefill admission
        # competes for the pages.
        self._ensure_decode_capacity(per_seq={
            s.seq_id: 1 + len(drafts.get(s.seq_id, ()))
            for s in self.running})
        if not self.running:
            return None
        prefill = self._plan_prefill(
            max_tokens=self.mixed_prefill_budget)
        plan_drafts = [drafts.get(s.seq_id, []) for s in self.running]
        if not any(plan_drafts):
            plan_drafts = None
        if prefill is None and plan_drafts is None:
            # Nothing ragged about this step (prefill could not admit,
            # no drafts): let the bimodal path plan it, which can take
            # a decode burst.
            return None
        # Without prefill this is a verify step (the engine runs it as
        # one).
        self._last_was_prefill = prefill is not None
        return StepPlan(prefill=prefill,
                        decode=DecodePlan(seqs=list(self.running),
                                          drafts=plan_drafts))

    def plan_ahead(self, inflight_rows) -> Optional[List[
            Optional[Sequence]]]:
        """Plan decode step N+1 while step N is still in flight:
        assume every running row commits exactly one token, pre-allocate
        the boundary pages that assumption needs, and return a row list
        ALIGNED to ``inflight_rows`` (None = slot masked: the row is
        gone or provably finishes when step N commits). The engine
        feeds step N's sampled-token device tensor straight into step
        N+1, so row slots must not shift.

        Returns None to break the pipeline (the engine then completes
        step N and re-plans synchronously with full knowledge):
        - prefill work is waiting and could admit (matches
          plan_step's want_prefill, so prefill never starves),
        - a row needs per-token host state the ahead plan would compute
          one token stale,
        - boundary pages cannot be allocated (never preempt with a
          step in flight: the victim's pages are inputs of the running
          step).
        """
        if (self.waiting
                and len(self.running) < self.config.max_num_seqs):
            return None
        rows: List[Optional[Sequence]] = []
        any_live = False
        for seq in inflight_rows:
            if seq is None or seq.state != SequenceState.RUNNING:
                rows.append(None)
                continue
            if self._needs_row_inputs(seq, ahead=1):
                return None
            if self._seq_budget(seq) <= 1:
                # Step N's token exhausts the row's budget: it will
                # finish with reason=length at reconcile. Mask the slot
                # now — a live row here would write KV past the row's
                # page budget.
                rows.append(None)
                continue
            rows.append(seq)
            any_live = True
        if not any_live:
            return None
        for seq in rows:
            if seq is None:
                continue
            # Before a decode step, capacity covers total_len + 1
            # tokens; after step N commits, total_len grows by one, so
            # reserve total_len + 2 now.
            needed = self._pages_needed(seq, seq.total_len + 2)
            if needed == 0:
                continue
            try:
                seq.pages.extend(self.cache.allocate_pages(needed))
            except OutOfPagesError:
                return None
        self._last_was_prefill = False
        return rows

    def _decode_window(self) -> int:
        """Tokens a pure decode dispatch may emit per row. The burst
        evaluates each row's budget and stop set on the device
        (model_runner._burst_impl), so the full window is always safe:
        a row with fewer tokens left goes inactive mid-burst."""
        return max(1, self.config.decode_steps)

    def _seq_budget(self, seq: Sequence) -> int:
        return decode_budget(seq, self.config.max_model_len)

    def _draft_limit(self, seq: Sequence) -> int:
        """Longest draft this row may carry: emitted tokens (accepted +
        1) never exceed the row's budget, so no draft writes KV past
        max_model_len."""
        return self._seq_budget(seq) - 1

    def _plan_prefill(self, max_tokens: Optional[int] = None
                      ) -> Optional[PrefillPlan]:
        # ``max_tokens`` caps the total prompt tokens admitted this
        # step (unified steps budget prefill work so decode rows
        # sharing the batch keep their ITL); the final chunk is
        # truncated to fit, resuming next step.
        chunks: List[PrefillChunk] = []
        tokens_planned = 0
        admitting = 0  # rows that will join `running` this step
        for seq in sorted(self.waiting,
                          key=lambda s: (s.priority, s.arrival_time)):
            if len(chunks) >= self.config.prefill_batch_size:
                break
            if seq.state == SequenceState.ABORTED:
                self.waiting.remove(seq)
                continue
            if (len(self.running) + admitting
                    >= self.config.max_num_seqs):
                break
            if (max_tokens is not None
                    and tokens_planned >= max_tokens):
                break
            if seq.num_computed_tokens == 0 and not seq.pages:
                # First touch: reuse cached prefix pages, then allocate
                # the remainder for the whole prompt up front.
                matched = self.cache.match_prefix(
                    seq.prompt_token_ids, seq.cache_salt)
                seq.pages = matched
                seq.num_hashed_pages = len(matched)
                seq.num_computed_tokens = len(matched) * self.page_size
                needed = self._pages_needed(seq, seq.num_prompt_tokens)
                try:
                    seq.pages.extend(self.cache.allocate_pages(needed))
                except OutOfPagesError:
                    self.cache.free_sequence(seq.pages)
                    seq.pages = []
                    seq.num_computed_tokens = 0
                    if chunks:
                        break  # run what we already gathered
                    if not self.running:
                        # Nothing will ever free pages: permanent.
                        logger.error(
                            "Request %s can never fit in the KV cache; "
                            "aborting", seq.seq_id
                        )
                        self.waiting.remove(seq)
                        self._finish(seq, FinishReason.ABORT)
                        self.newly_aborted.append(seq)
                        continue
                    logger.warning(
                        "KV cache full: request %s waits", seq.seq_id
                    )
                    return None
            start = seq.num_computed_tokens
            end = min(start + self.config.prefill_chunk_size,
                      seq.num_prompt_tokens)
            if max_tokens is not None:
                end = min(end, start + (max_tokens - tokens_planned))
            is_last = end == seq.num_prompt_tokens
            if seq.first_scheduled_time is None:
                seq.first_scheduled_time = time.time()
            chunks.append(PrefillChunk(
                seq=seq,
                chunk_start=start,
                chunk_tokens=seq.prompt_token_ids[start:end],
                is_last_chunk=is_last,
            ))
            tokens_planned += end - start
            if is_last:
                admitting += 1
        if not chunks:
            return None
        return PrefillPlan(chunks=chunks)

    def _pages_needed(self, seq: Sequence, target_tokens: int) -> int:
        have = len(seq.pages) * self.page_size
        if target_tokens <= have:
            return 0
        return -(-(target_tokens - have) // self.page_size)

    def _ensure_decode_capacity(self, lookahead: int = 1,
                                per_seq: Optional[Dict[str, int]]
                                = None) -> None:
        """Every running sequence needs page slots for its next
        dispatch: ``lookahead`` tokens (a burst's window), or with
        ``per_seq`` (speculative plans) 1 + its draft length, capped by
        its remaining budget. Preempt the lowest-priority, newest
        sequence when the cache cannot provide them."""
        for seq in list(self.running):
            if seq.state != SequenceState.RUNNING:
                # Preempted earlier in this very pass (we iterate a
                # snapshot): allocating pages to a WAITING victim
                # would leak them when prefill re-allocates from
                # scratch.
                continue
            ahead = (lookahead if per_seq is None
                     else per_seq.get(seq.seq_id, 1))
            ahead = max(1, min(ahead, self._seq_budget(seq)))
            needed = self._pages_needed(seq, seq.total_len + ahead)
            if needed == 0:
                continue
            try:
                seq.pages.extend(self.cache.allocate_pages(needed))
            except OutOfPagesError:
                victim = max(self.running,
                             key=lambda s: (s.priority, s.arrival_time))
                self._preempt(victim)
                if victim is seq:
                    continue
                try:
                    seq.pages.extend(self.cache.allocate_pages(needed))
                except OutOfPagesError:
                    self._preempt(seq)

    def _preempt(self, seq: Sequence) -> None:
        self._log_preemption(seq)
        self.num_preemptions += 1
        self.running.remove(seq)
        self.cache.free_sequence(seq.pages)
        seq.pages = []
        seq.num_hashed_pages = 0
        # Recompute everything including generated tokens as "prompt";
        # num_prior_output_tokens keeps the generated-so-far budgets
        # counting across the fold.
        seq.num_prior_output_tokens += len(seq.output_token_ids)
        seq.prompt_token_ids = seq.all_token_ids
        seq.output_token_ids = []
        seq.num_computed_tokens = 0
        seq.transition(SequenceState.WAITING)
        self.waiting.appendleft(seq)

    def _log_preemption(self, seq: Sequence) -> None:
        now = time.monotonic()
        if now - self._preempt_log_ts < _PREEMPT_LOG_INTERVAL_S:
            self._preempt_log_suppressed += 1
            return
        if self._preempt_log_suppressed:
            logger.warning(
                "Preempting %s (KV cache pressure; %d preemptions "
                "suppressed in the last %.0fs)", seq.seq_id,
                self._preempt_log_suppressed, _PREEMPT_LOG_INTERVAL_S)
        else:
            logger.warning("Preempting %s (KV cache pressure)",
                           seq.seq_id)
        self._preempt_log_ts = now
        self._preempt_log_suppressed = 0

    # ---- completion callbacks (driven by the engine) ----------------------

    def on_prefill_executed(self, chunk: PrefillChunk,
                            sampled_token: Optional[int]) -> None:
        seq = chunk.seq
        if seq.state in (SequenceState.ABORTED, SequenceState.FINISHED):
            return  # aborted while the chunk was in flight on device
        seq.num_computed_tokens = (chunk.chunk_start
                                   + len(chunk.chunk_tokens))
        self.cache.commit_full_pages(
            seq.prompt_token_ids[:seq.num_computed_tokens],
            seq.pages, seq.num_hashed_pages, seq.cache_salt,
        )
        seq.num_hashed_pages = min(
            len(seq.pages),
            seq.num_computed_tokens // self.page_size,
        )
        if chunk.is_last_chunk:
            if sampled_token is None:
                raise RuntimeError(
                    f"last prefill chunk of {seq.seq_id} sampled nothing")
            try:
                self.waiting.remove(seq)
            except ValueError:
                return  # raced with an abort that already dequeued it
            seq.transition(SequenceState.RUNNING)
            seq.first_token_time = time.time()
            self.running.append(seq)
            self._append_token(seq, sampled_token)

    def on_spec_executed(self, seq: Sequence) -> None:
        """Post-verify accounting: the verify step wrote KV through
        ``total_len_before + draft_len`` positions, but only the
        accepted prefix and the bonus token were appended. The
        committed count follows the kept tokens; the rejected tail's
        KV lies past ``total_len``, causally invisible, and the next
        step overwrites it."""
        if seq.state == SequenceState.RUNNING:
            seq.num_computed_tokens = seq.total_len

    def append_decode_token(self, seq: Sequence, token: int) -> bool:
        """Append one decoded token; returns False if the sequence is
        no longer running."""
        if seq.state != SequenceState.RUNNING:
            return False
        self._append_token(seq, token)
        return seq.state == SequenceState.RUNNING

    def _append_token(self, seq: Sequence, token: int) -> None:
        seq.output_token_ids.append(token)
        if self.guided_advance is not None and seq.fsm_state is not None:
            self.guided_advance(seq, token)
        stop_ids = seq.sampling.stop_token_ids
        # min_tokens: the device suppresses stop ids while under the
        # minimum, but only STOP_SET_WIDTH of them; a wider set's
        # overflow must not end the sequence early.
        past_min = seq.num_generated > seq.sampling.min_tokens
        if (not seq.sampling.ignore_eos and token in stop_ids
                and past_min):
            self._finish(seq, FinishReason.STOP)
            self.running.remove(seq)
        elif seq.num_generated >= seq.sampling.max_tokens:
            self._finish(seq, FinishReason.LENGTH)
            self.running.remove(seq)
        elif seq.total_len >= self.config.max_model_len:
            self._finish(seq, FinishReason.LENGTH)
            self.running.remove(seq)

    def _finish(self, seq: Sequence, reason: FinishReason) -> None:
        if seq.state in (SequenceState.FINISHED, SequenceState.ABORTED):
            return
        seq.transition(SequenceState.ABORTED if reason == FinishReason.ABORT
                       else SequenceState.FINISHED)
        seq.finish_reason = reason
        seq.finish_time = time.time()
        if self.proposer is not None:
            self.proposer.drop(seq.seq_id)
        if seq.pages:
            self.cache.free_sequence(seq.pages)
            seq.pages = []
