"""LLMEngine: ties scheduler + cache manager + model runner together.

Synchronous core (one ``step()`` = one device step) with ``generate``
conveniences for tests and benchmarks; the HTTP server
(engine/server.py) drives the same core from a background thread.
With ``scheduler.async_scheduling`` decode runs through the overlapped
pipeline: step N+1 is planned and queued on the card before step N's
tokens are read back. With ``scheduler.speculative_k`` decode steps
whose rows drafted become verify steps, which commit 1..K + 1 tokens a
row; under the pipeline, the successor of a verify step assumes one
token and its stale rows are dropped (``_complete``). With
``scheduler.decode_steps`` K > 1 a pure decode step is a burst that
commits up to K tokens a row through the same commit path; it runs
synchronously, also under the pipeline.
"""

from __future__ import annotations

import threading
import time
import uuid
from dataclasses import dataclass
from typing import Dict, List, Optional

from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.kv_cache import PagedCacheManager
from production_stack_tpu_torch.engine.metrics import EngineMetrics
from production_stack_tpu_torch.engine.model_runner import ModelRunner
from production_stack_tpu_torch.engine.scheduler import Scheduler
from production_stack_tpu_torch.engine.sequence import (
    SamplingParams,
    Sequence,
    SequenceState,
)
from production_stack_tpu_torch.engine.tokenizer import (
    BaseTokenizer,
    get_tokenizer,
)


def _check_ported(sp: SamplingParams) -> None:
    """Raise on a sampling feature the port's steps do not apply yet,
    rather than sample as if it were not set."""
    unported = [name for name, on in (
        ("penalties", sp.needs_penalties),
        ("logprobs", sp.logprobs or sp.top_logprobs > 0),
        ("logit_bias", bool(sp.logit_bias)),
        ("min_tokens", sp.min_tokens > 0),
        ("guided decoding", sp.guided is not None)) if on]
    if unported:
        raise NotImplementedError(
            f"{', '.join(unported)}: not supported by this engine yet")


@dataclass
class StepOutput:
    seq_id: str
    new_token: Optional[int]
    finished: bool
    finish_reason: Optional[str]


class LLMEngine:
    """The serving engine on one device: ``cuda`` unless the caller
    passes ``device="cpu"``; with no card and no such argument it
    raises. On the card each step replays a CUDA graph of its kind and
    bucket shape; ``cuda_graphs=False`` runs them eagerly (to compare:
    the server has no such flag, as the JAX server has none)."""

    def __init__(self, config: EngineConfig, params=None,
                 tokenizer: Optional[BaseTokenizer] = None, device=None,
                 cuda_graphs: bool = True):
        self.config = config
        self.tokenizer = tokenizer or get_tokenizer(None)
        self.cache_manager = PagedCacheManager(config.cache)
        self.scheduler = Scheduler(config.scheduler, config.cache,
                                   self.cache_manager)
        self.runner = ModelRunner(config, params=params, device=device,
                                  cuda_graphs=cuda_graphs)
        self.sequences: Dict[str, Sequence] = {}
        self._lock = threading.Lock()
        self.metrics = EngineMetrics()
        # Overlapped async pipeline state: at most ONE dispatched-but-
        # unread decode step. ``_idle_mark`` timestamps the moment the
        # device drained its queue so the next dispatch can account the
        # idle gap — the quantity the pipeline exists to shrink.
        self._in_flight = None
        self._idle_mark: Optional[float] = None

    # ---- request API ------------------------------------------------------

    def add_request(self, prompt_token_ids: List[int],
                    sampling: Optional[SamplingParams] = None,
                    seq_id: Optional[str] = None,
                    output_sink=None) -> str:
        sampling = sampling or SamplingParams()
        _check_ported(sampling)
        stop_ids = list(sampling.stop_token_ids)
        if (not sampling.ignore_eos
                and self.tokenizer.eos_token_id is not None
                and self.tokenizer.eos_token_id not in stop_ids):
            stop_ids.append(self.tokenizer.eos_token_id)
        sampling.stop_token_ids = stop_ids
        seq = Sequence(
            seq_id=seq_id or f"seq-{uuid.uuid4().hex[:16]}",
            prompt_token_ids=list(prompt_token_ids),
            sampling=sampling,
            output_sink=output_sink,
        )
        with self._lock:
            self.sequences[seq.seq_id] = seq
            try:
                self.scheduler.add_sequence(seq)
            except Exception:
                self.sequences.pop(seq.seq_id, None)
                raise
        return seq.seq_id

    def abort_request(self, seq_id: str) -> None:
        with self._lock:
            seq = self.sequences.pop(seq_id, None)
            if seq is not None:
                self.scheduler.abort_sequence(seq)
                self.metrics.on_finished(seq)

    def has_work(self) -> bool:
        # A dispatched-but-unread decode step is work: the loop must
        # come back to reconcile it even if every row since finished.
        return self._in_flight is not None or self.scheduler.has_work()

    # ---- engine step ------------------------------------------------------

    def step(self) -> List[StepOutput]:
        """Plan + execute one device step; returns per-seq deltas."""
        if self.config.scheduler.async_scheduling:
            return self._step_async()
        return self._step_sync()

    def _plan_locked(self, outputs: List[StepOutput]):
        with self._lock:
            plan = self.scheduler.plan_step()
            for seq in self.scheduler.newly_aborted:
                outputs.append(self._delta(seq, None))
            self.scheduler.newly_aborted.clear()
        return plan

    def _step_sync(self) -> List[StepOutput]:
        outputs: List[StepOutput] = []
        t0 = time.perf_counter()
        plan = self._plan_locked(outputs)
        if plan.empty:
            for out in outputs:
                self.sequences.pop(out.seq_id, None)
            return outputs
        if plan.prefill is not None and plan.decode is not None:
            wait_s = self._execute_unified(plan, outputs)
        elif plan.prefill is not None:
            wait_s = self._execute_prefill(plan, outputs)
        else:
            wait_s = self._execute_decode_sync(plan, outputs)
        self.metrics.on_pipeline_step(
            host_s=(time.perf_counter() - t0) - wait_s,
            device_wait_s=wait_s, ahead=False)
        self._pop_finished(outputs)
        return outputs

    def _execute_prefill(self, plan, outputs) -> float:
        td = time.perf_counter()
        self._note_dispatch(td)
        sampled = self.runner.run_prefill(plan.prefill)
        tr = time.perf_counter()
        self._idle_mark = tr
        with self._lock:
            for chunk, token in zip(plan.prefill.chunks, sampled):
                self.scheduler.on_prefill_executed(chunk, token)
                if chunk.is_last_chunk:
                    outputs.append(self._delta(chunk.seq, token))
        return tr - td

    def _commit_decode(self, seqs, token_lists, outputs, drafts=None,
                       expected_lens=None) -> None:
        """Commit decode rows' tokens (caller holds the lock).

        ``drafts`` (verify steps): per-row draft lists; each row emits
        accepted + 1 tokens, counted before any stop truncation so the
        acceptance rate reflects the model, not request budgets.
        ``expected_lens`` (the assume-one-token successor of a verify
        step): rows whose total_len differs from it are stale — the
        verify committed more than one token, so this sample came from
        incomplete context — and are dropped. Their KV write was
        correct either way: it fed the first committed token."""
        now = time.time()
        drafted = accepted = 0
        for i, (seq, toks) in enumerate(zip(seqs, token_lists)):
            if seq is None:  # plan-ahead masked slot
                continue
            if expected_lens is not None and (
                    expected_lens[i] is None
                    or seq.total_len != expected_lens[i]):
                continue
            if drafts is not None:
                drafted += len(drafts[i])
                accepted += len(toks) - 1
                seq.spec_drafted_total += len(drafts[i])
                seq.spec_accepted_total += max(0, len(toks) - 1)
            emitted = 0
            for tok in toks:
                if seq.state != SequenceState.RUNNING:
                    break  # stop hit mid-span: drop the tail
                self.scheduler.append_decode_token(seq, tok)
                emitted += 1
                outputs.append(self._delta(seq, tok))
            self.metrics.on_decode_tokens(seq, emitted, now)
            if drafts is not None:
                self.scheduler.on_spec_executed(seq)
        if drafts is not None:
            self.metrics.on_spec_step(drafted, accepted)

    def _execute_decode_sync(self, plan, outputs) -> float:
        td = time.perf_counter()
        self._note_dispatch(td)
        token_lists = self.runner.run_decode(plan.decode)
        tr = time.perf_counter()
        self._idle_mark = tr
        with self._lock:
            self._commit_decode(plan.decode.seqs, token_lists, outputs,
                                drafts=plan.decode.drafts)
        return tr - td

    def _execute_unified(self, plan, outputs) -> float:
        """One unified ragged step: decode rows (through the verify
        contract, 1..K + 1 tokens each) and prefill chunk rows commit
        out of a single device step."""
        td = time.perf_counter()
        self._note_dispatch(td)
        token_lists, prefill_toks = self.runner.run_unified(plan)
        tr = time.perf_counter()
        self._idle_mark = tr
        seqs = plan.decode.seqs[: self.runner.decode_width]
        chunks = plan.prefill.chunks[: self.runner.prefill_width]
        self.metrics.on_ragged_step(
            prefill_rows=len(chunks), decode_rows=len(seqs),
            pad_rows=(self.runner.last_unified_rows
                      - len(chunks) - len(seqs)))
        with self._lock:
            self._commit_decode(seqs, token_lists, outputs,
                                drafts=plan.decode.drafts)
            for chunk, token in zip(chunks, prefill_toks):
                self.scheduler.on_prefill_executed(chunk, token)
                if chunk.is_last_chunk:
                    outputs.append(self._delta(chunk.seq, token))
        return tr - td

    # ---- overlapped async pipeline ------------------------------------------

    def _step_async(self) -> List[StepOutput]:
        """One pipeline turn, depth 1: when a decode step is in flight,
        plan and queue its successor BEFORE reading its results. The
        successor consumes the in-flight step's sampled-token device
        tensor directly, so the card starts step N+1 while the host is
        still committing step N's tokens."""
        handle = self._in_flight
        if handle is not None:
            t0 = time.perf_counter()
            rows = None
            if handle.expected_lens is None:
                with self._lock:
                    rows = self.scheduler.plan_ahead(handle.rows)
            # else: this handle is the assume-one-token successor of a
            # verify step. Complete it (dropping its stale rows) and
            # re-plan from fresh host state: chaining another step off
            # a possibly stale token source never recovers.
            if rows is not None:
                nxt = self.runner.dispatch_decode(
                    rows, token_source=handle.token_source, ahead=True)
                if handle.is_spec:
                    # The successor assumed each row commits exactly one
                    # token; record the total_len that predicts.
                    nxt.expected_lens = [
                        None if seq is None else seq.total_len + 1
                        for seq in rows]
                self._in_flight = nxt
                outputs, wait_s = self._complete(handle)
                # No _idle_mark here: step N+1 was queued before step
                # N's results were read — the device never idled.
                self.metrics.on_pipeline_step(
                    host_s=(time.perf_counter() - t0) - wait_s,
                    device_wait_s=wait_s, ahead=True)
                return outputs
            # Pipeline break (prefill waiting / ineligible row / no
            # boundary pages): drain the in-flight step, then let the
            # next step() re-plan synchronously with full knowledge.
            self._in_flight = None
            self.metrics.set_inflight_depth(0)
            outputs, wait_s = self._complete(handle)
            self._idle_mark = time.perf_counter()
            self.metrics.on_pipeline_step(
                host_s=(time.perf_counter() - t0) - wait_s,
                device_wait_s=wait_s, ahead=False)
            return outputs
        outputs: List[StepOutput] = []
        t0 = time.perf_counter()
        plan = self._plan_locked(outputs)
        if plan.empty:
            for out in outputs:
                self.sequences.pop(out.seq_id, None)
            return outputs
        if plan.prefill is not None:
            # Prefill (and the mixed ragged step) stays synchronous:
            # each chunk's commit feeds the next chunk's plan.
            if plan.decode is not None:
                wait_s = self._execute_unified(plan, outputs)
            else:
                wait_s = self._execute_prefill(plan, outputs)
            self.metrics.on_pipeline_step(
                host_s=(time.perf_counter() - t0) - wait_s,
                device_wait_s=wait_s, ahead=False)
            self._pop_finished(outputs)
            return outputs
        if plan.decode.drafts is None and plan.decode.window > 1:
            # A burst already hides the host's work for window - 1 of
            # its iterations, so it runs synchronously rather than
            # through the depth-1 pipeline (stacking both would
            # speculate a whole window ahead).
            wait_s = self._execute_decode_sync(plan, outputs)
            self.metrics.on_pipeline_step(
                host_s=(time.perf_counter() - t0) - wait_s,
                device_wait_s=wait_s, ahead=False)
            self._pop_finished(outputs)
            return outputs
        # Pure-decode or verify plan: queue it and return without
        # waiting; the next turn plans ahead against it (a verify
        # step's commit count is data-dependent, so its successor
        # assumes one token and reconciles in _complete).
        self._note_dispatch(time.perf_counter())
        if plan.decode.drafts is not None:
            self._in_flight = self.runner.dispatch_spec(plan.decode)
        else:
            self._in_flight = self.runner.dispatch_decode(
                plan.decode.seqs[: self.runner.decode_width])
        self.metrics.set_inflight_depth(1)
        self.metrics.on_pipeline_step(
            host_s=time.perf_counter() - t0, device_wait_s=0.0,
            ahead=False)
        self._pop_finished(outputs)
        return outputs

    def _complete(self, handle) -> tuple:
        """Read back + reconcile one queued decode or verify step
        through the same commit path as the sync loop. Rows that
        finished or were aborted mid-flight drop their token;
        plan-ahead boundary pages ride seq.pages and return through the
        ordinary free path. A successor of a verify step drops its
        stale rows (``expected_lens``)."""
        tw = time.perf_counter()
        token_lists = handle.result()
        wait_s = time.perf_counter() - tw
        outputs: List[StepOutput] = []
        with self._lock:
            self._commit_decode(handle.rows, token_lists, outputs,
                                drafts=handle.drafts,
                                expected_lens=handle.expected_lens)
        self._pop_finished(outputs)
        return outputs, wait_s

    def _pop_finished(self, outputs: List[StepOutput]) -> None:
        for out in outputs:
            if out.finished:
                seq = self.sequences.pop(out.seq_id, None)
                if seq is not None:
                    self.metrics.on_finished(seq)

    def _note_dispatch(self, now: float) -> None:
        """Device-idle accounting: accumulate the gap between the
        device draining its queue and the next dispatch."""
        if self._idle_mark is not None:
            self.metrics.on_device_idle(now - self._idle_mark)
            self._idle_mark = None

    @staticmethod
    def _delta(seq: Sequence, token: Optional[int]) -> StepOutput:
        finished = seq.state in (
            SequenceState.FINISHED, SequenceState.ABORTED
        )
        return StepOutput(
            seq_id=seq.seq_id,
            new_token=token,
            finished=finished,
            finish_reason=(seq.finish_reason.value
                           if seq.finish_reason else None),
        )

    # ---- metrics ----------------------------------------------------------

    def stats(self) -> Dict[str, float]:
        m = self.metrics
        return {
            "num_requests_running": self.scheduler.num_running,
            "num_requests_waiting": self.scheduler.num_waiting,
            "gpu_cache_usage_perc": self.cache_manager.usage_perc(),
            "gpu_prefix_cache_hit_rate":
                self.cache_manager.prefix_hit_rate(),
            "num_preemptions_total": self.scheduler.num_preemptions,
            "engine_step_host_seconds_total": m.step_host_seconds_total,
            "engine_step_device_wait_seconds_total":
                m.step_device_wait_seconds_total,
            "engine_device_idle_seconds_total":
                m.device_idle_seconds_total,
            "engine_pipeline_steps_total": m.pipeline_steps_total,
            "engine_pipeline_ahead_steps_total":
                m.pipeline_ahead_steps_total,
            "engine_async_inflight_depth": m.async_inflight_depth,
            "engine_step_prefill_rows": m.last_prefill_rows,
            "engine_step_decode_rows": m.last_decode_rows,
            "engine_step_pad_rows": m.last_pad_rows,
            "engine_ragged_steps_total": m.ragged_steps_total,
            "engine_ragged_rows_total": m.ragged_rows_total,
            "engine_ragged_pad_rows_total": m.ragged_pad_rows_total,
            "spec_decode_num_draft_tokens_total":
                m.spec_draft_tokens_total,
            "spec_decode_num_accepted_tokens_total":
                m.spec_accepted_tokens_total,
            "engine_kv_cache_page_capacity":
                self.config.cache.num_pages - 1,
            "engine_kv_bytes_per_decode_step":
                self.config.scheduler.max_num_seqs
                * self.config.cache.kv_bytes_per_token(self.config.model),
        }

    # ---- convenience ------------------------------------------------------

    def generate(self, prompt_token_ids: List[int],
                 sampling: Optional[SamplingParams] = None) -> Sequence:
        """Blocking single-prompt generation (tests/benchmarks)."""
        seq_id = self.add_request(prompt_token_ids, sampling)
        seq = self.sequences[seq_id]
        while seq.state not in (SequenceState.FINISHED,
                                SequenceState.ABORTED):
            self.step()
        # Reconcile a decode step still queued behind the finish.
        while self._in_flight is not None:
            self.step()
        return seq

    def generate_batch(self, prompts: List[List[int]],
                       sampling: Optional[SamplingParams] = None,
                       ) -> List[Sequence]:
        seqs = []
        for p in prompts:
            sp = (SamplingParams(**vars(sampling))
                  if sampling else SamplingParams())
            seq_id = self.add_request(p, sp)
            seqs.append(self.sequences[seq_id])
        while any(s.state not in (SequenceState.FINISHED,
                                  SequenceState.ABORTED) for s in seqs):
            self.step()
        while self._in_flight is not None:
            self.step()
        return seqs
