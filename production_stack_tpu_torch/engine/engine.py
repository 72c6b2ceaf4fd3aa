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

Every per-row sampling option of the JAX engine is served: penalties,
``logit_bias``, ``min_tokens``, guided JSON (``SamplingParams.guided``
"json", for the byte-range tokenizers, whose automaton is built at
start-up) and logprobs, returned on each ``StepOutput`` in the JAX
engine's form. With ``config.lora.enable`` a request may name a
registered LoRA adapter (``register_lora``): its rows run with the
adapter's slot, and its prefix-cache pages live in the adapter's own
namespace (the sequence's ``cache_salt``); weight-only int8
(``ModelConfig.quantization``) is the runner's.

With an offload tier (``config.offload``: a host RAM pool and/or a
remote cache server, engine/offload.py) pages leave the card on
eviction, on preemption (preempt-to-offload) and at stream checkpoints,
and come back at a first-touch prefix miss. Every
``checkpoint_interval_tokens`` generated tokens a running stream ships
its new full pages and stages a resume descriptor (the token journal)
for the server's SSE stream; ``add_resume`` continues such a stream on
another engine, parked in AWAITING_KV until its pages are reachable or
recomputing from the journal on a miss. Requests carry a QoS
``priority`` (the scheduler's admission order and preemption victim)
and ``spec_off``.

Disaggregated serving: a ``handoff_prefill`` request (a prefill-role
engine's) retires after its first token, its committed pages shipped to
the offload tier and a descriptor staged for the server
(``take_handoff_info``); ``add_handoff`` takes such a request on a
decode-role engine, parked in AWAITING_KV until its pages are reachable
(or recomputing on a miss), and streams from the second token.

Accounting: every step fans out once (``_account_step``) to the
pipeline metrics, the runner's observatory (seconds waited on the
read-back, committed tokens, by kind) and, when a tracer is installed
(``tracer``, engine/tracing.py), its step flight recorder; the tracer
also gets each request's lifecycle events. Without a tracer the engine
allocates no span or step record.
"""

from __future__ import annotations

import threading
import time
import uuid
from dataclasses import dataclass
from typing import Dict, List, Optional

from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.guided import build_json_fsm
from production_stack_tpu_torch.engine.lora import load_peft_adapter
from production_stack_tpu_torch.engine.kv_cache import (
    OutOfPagesError,
    PagedCacheManager,
)
from production_stack_tpu_torch.engine.metrics import EngineMetrics
from production_stack_tpu_torch.engine.model_runner import ModelRunner
from production_stack_tpu_torch.engine.offload import (
    HostKVPool,
    KVOffloadManager,
    RemoteKVClient,
    payload_nbytes,
    wire_dtype_name,
)
from production_stack_tpu_torch.engine.scheduler import Scheduler
from production_stack_tpu_torch.engine.sequence import (
    SamplingParams,
    Sequence,
    SequenceState,
    in_vocab,
)
from production_stack_tpu_torch.engine.tokenizer import (
    BaseTokenizer,
    ByteTokenizer,
    get_tokenizer,
)
from production_stack_tpu_torch.qos import parse_priority
from production_stack_tpu_torch.utils.log import init_logger

logger = init_logger(__name__)


@dataclass
class StepOutput:
    seq_id: str
    new_token: Optional[int]
    finished: bool
    finish_reason: Optional[str]
    # (sampled_logprob, [(token_id, logprob), ...]) when the request
    # asked for logprobs; None otherwise.
    logprobs: Optional[tuple] = None


class LLMEngine:
    """The serving engine on one device: ``cuda`` unless the caller
    passes ``device="cpu"``; with no card and no such argument it
    raises. On the card each step replays a CUDA graph of its kind and
    bucket shape; ``cuda_graphs=False`` runs them eagerly (to compare:
    the server has no such flag, as the JAX server has none). Under
    tensor, pipeline or context parallelism this is rank 0: ``tp``,
    ``pp`` and ``sp`` its groups (parallel/collectives.py), ``bridge``
    the step bridge its runner publishes through
    (parallel/distributed.py), ``params`` the full weights (the runner
    keeps its shard and stage), and ``tp_runtime`` the workers
    ``close`` stops. Under context parallelism a cold prompt of at
    least ``long_prefill_threshold`` tokens (default 2 x
    prefill_chunk_size, JAX's) prefills in one dispatch."""

    def __init__(self, config: EngineConfig, params=None,
                 tokenizer: Optional[BaseTokenizer] = None, device=None,
                 cuda_graphs: bool = True, tp=None, bridge=None,
                 tp_runtime=None, pp=None, sp=None):
        self.config = config
        self.tokenizer = tokenizer or get_tokenizer(None)
        self.cache_manager = PagedCacheManager(config.cache)
        # Guided JSON: the automaton is built at start-up for the
        # byte-range tokenizers (the bench tokenizer is one); None for
        # any other, whose guided requests are refused.
        self.guided_fsm = (build_json_fsm(self.tokenizer)
                           if isinstance(self.tokenizer, ByteTokenizer)
                           else None)
        sp_threshold = None
        if config.parallel.context_parallel_size > 1:
            sp_threshold = (config.parallel.long_prefill_threshold
                            or 2 * config.scheduler.prefill_chunk_size)
        self.scheduler = Scheduler(config.scheduler, config.cache,
                                   self.cache_manager,
                                   sp_threshold=sp_threshold,
                                   guided_advance=self._guided_advance)
        self.runner = ModelRunner(config, params=params, device=device,
                                  cuda_graphs=cuda_graphs, tp=tp, pp=pp,
                                  sp=sp)
        if bridge is not None:
            self.runner.attach_bridge(bridge)
        self.tp_runtime = tp_runtime
        if self.guided_fsm is not None:
            self.runner.set_guided_tables(self.guided_fsm)
        self.sequences: Dict[str, Sequence] = {}
        self._lock = threading.Lock()
        self.metrics = EngineMetrics()
        # Overlapped async pipeline state: at most ONE dispatched-but-
        # unread decode step. ``_idle_mark`` timestamps the moment the
        # device drained its queue so the next dispatch can account the
        # idle gap — the quantity the pipeline exists to shrink.
        self._in_flight = None
        self._idle_mark: Optional[float] = None
        # (kind, committed tokens) of the step about to be accounted,
        # staged by the execute helpers for the observatory (a tuple,
        # always); and its row detail for the flight recorder (a dict,
        # only with a tracer). Both drained by _account_step.
        self._obs_note: Optional[tuple] = None
        self._step_note: Optional[dict] = None
        # QoS: the class of requests that carry none.
        self.default_priority = int(
            parse_priority(config.qos.default_priority))
        self.offload: Optional[KVOffloadManager] = None
        if config.offload.enable:
            self._init_offload()
        # Stream checkpoints: the latest unsent resume descriptor of
        # each live stream (drained by the server, relayed to the
        # router as an SSE comment frame), each stream's cadence and
        # shipped-page bookkeeping, and the counters.
        self._checkpoints: Dict[str, dict] = {}
        self._ckpt_last_tokens: Dict[str, int] = {}
        self._ckpt_shipped_pages: Dict[str, int] = {}
        self.checkpoint_ships = 0
        self.checkpoint_kv_bytes = 0
        self.stream_resumes = 0
        # Disaggregated serving: the descriptor payload of each finished
        # prefill handoff (drained by the server) and the role counters.
        self._handoff_info: Dict[str, dict] = {}
        self.disagg_prefill_requests = 0
        self.disagg_decode_requests = 0
        self.disagg_kv_bytes_shipped = 0
        # Request tracing: None unless one is installed (the server
        # installs one by default); every emission is behind an
        # ``is None`` check.
        self._tracer = None

    def close(self) -> None:
        """Stop the parallel ranks, if this engine has any: its step
        graphs released first (they may hold the collectives' group).
        A ``--distributed`` coordinator cannot join another host's
        processes: its runtime sends the shutdown record (bounded),
        joins only the ranks this process spawned and leaves the world;
        each other process leaves its loop on that record and exits."""
        if self.tp_runtime is not None:
            if self.runner.graphs is not None:
                self.runner.graphs.release()
            self.tp_runtime.close()

    @property
    def tracer(self):
        return self._tracer

    @tracer.setter
    def tracer(self, tracer) -> None:
        # Mirrored onto the scheduler, which emits the chunk, first
        # token, preemption and restore events.
        self._tracer = tracer
        self.scheduler.tracer = tracer

    # ---- offload tiers ------------------------------------------------------

    def _init_offload(self) -> None:
        # A per-process requester id: the managed cluster cache counts
        # DISTINCT requesters demanding a chain for admission.
        remote = (RemoteKVClient(
                      self.config.offload.remote_url,
                      requester=f"engine-{uuid.uuid4().hex[:12]}")
                  if self.config.offload.remote_url else None)
        # Tier keys are namespaced by the page storage format (int8, or
        # the model's dtype), as the JAX engine names it.
        kv_dtype = ("int8" if self.runner.kv_quantized else
                    wire_dtype_name(self.config.model.torch_dtype))
        self.offload = KVOffloadManager(
            host_pool=HostKVPool(
                self.config.offload.host_pool_bytes,
                watermark_high=self.config.kvecon.watermark_high,
                watermark_low=self.config.kvecon.watermark_low),
            remote=remote, kv_dtype=kv_dtype)
        self.cache_manager.evict_listener = self._on_page_evicted
        self.scheduler.restore_hook = self._restore_offloaded_prefix
        if self.config.qos.preempt_to_offload:
            self.scheduler.evict_hook = self._evict_sequence_kv
        logger.info("KV offload enabled (host pool %d MiB%s)",
                    self.config.offload.host_pool_bytes // 2 ** 20,
                    ", remote tier" if remote else "")

    def _on_page_evicted(self, page_id: int, page_hash) -> None:
        self.offload.offload_page(page_hash,
                                  *self.runner.read_page(page_id))

    def _ship_pages(self, seq: Sequence, start: int = 0,
                    keys: Optional[List[str]] = None) -> tuple:
        """Ship ``seq``'s committed full pages from the ``start``-th
        on to the offload tier: (pages in the committed chain, pages
        shipped, bytes shipped); each shipped page's tier key is
        appended to ``keys`` when given. Caller holds the lock.

        The restorable prefix is every token but the last (the prefix
        cache's bound: the final token must prefill again to give
        logits), and its KV is all written by the steps queued so far:
        decode writes a token's KV one step after sampling it, so
        positions 0..total_len-2 are on the card at a plan boundary,
        and ``read_page`` waits for a step still in flight. The pages
        are first committed to the hash table (prompt-time hashing
        stopped at the prompt), so the shipped chain and a first-touch
        restore's chain are the same hashes."""
        usable = seq.total_len - 1
        tokens = seq.all_token_ids[:usable]
        self.cache_manager.commit_full_pages(
            tokens, seq.pages, seq.num_hashed_pages, seq.cache_salt)
        hashes = PagedCacheManager.chain_hashes(
            tokens, self.cache_manager.page_size, seq.cache_salt)
        pairs = list(zip(seq.pages, hashes))
        chain = self.offload.chain_id(hashes[0]) if hashes else None
        shipped = kv_bytes = 0
        for page_id, page_hash in pairs[start:]:
            payload = self.runner.read_page(page_id)
            self.offload.offload_page(page_hash, *payload, chain=chain)
            kv_bytes += payload_nbytes(payload)
            shipped += 1
            if keys is not None:
                keys.append(self.offload.key_for(page_hash))
        return len(pairs), shipped, kv_bytes

    def _evict_sequence_kv(self, seq: Sequence) -> int:
        """Preempt-to-offload (the scheduler's evict hook): ship the
        victim's committed KV pages before the scheduler frees them;
        returns the count shipped."""
        if self.offload is None or not seq.pages:
            return 0
        return self._ship_pages(seq)[1]

    def _restore_offloaded_prefix(self, prompt_token_ids, matched_pages,
                                  cache_salt=0) -> List[int]:
        """After a device prefix miss, pull further pages from the
        host or remote tier into freshly allocated pages (the
        scheduler's restore hook)."""
        usable = len(prompt_token_ids) - 1
        hashes = PagedCacheManager.chain_hashes(
            prompt_token_ids[:usable], self.cache_manager.page_size,
            cache_salt)
        remaining = hashes[len(matched_pages):]
        n = self.offload.lookup_chain(remaining)
        if n == 0:
            return []
        try:
            pages = self.cache_manager.allocate_pages(n)
        except OutOfPagesError:
            return []
        t0 = time.perf_counter()
        restored: List[int] = []
        # One batched round trip for every remote miss in the chain.
        payloads = self.offload.fetch_many(remaining[:n])
        arity = 4 if self.runner.kv_quantized else 2
        for page_id, page_hash, payload in zip(pages, remaining[:n],
                                               payloads):
            if payload is None or len(payload) != arity:
                # The tier raced an eviction (or holds a payload of
                # another page format): stop here.
                self.cache_manager.free_sequence(pages[len(restored):])
                break
            self.runner.write_page(page_id, *payload)
            self.cache_manager.register_restored_page(page_id, page_hash)
            restored.append(page_id)
        self.offload.restored_pages += len(restored)
        if restored:
            self.cache_manager.prefix_hit_tokens += (
                len(restored) * self.cache_manager.page_size)
            # vllm:preempt_restore_latency_seconds: the page transfer
            # that replaced a prompt recompute.
            self.metrics.on_preempt_restore(time.perf_counter() - t0)
        return restored

    # ---- request API ------------------------------------------------------

    def add_request(self, prompt_token_ids: List[int],
                    sampling: Optional[SamplingParams] = None,
                    seq_id: Optional[str] = None,
                    output_sink=None,
                    lora_name: Optional[str] = None,
                    handoff_prefill: bool = False,
                    request_id: Optional[str] = None,
                    priority: Optional[int] = None,
                    spec_off: bool = False) -> str:
        """Queue one request. ``lora_name``: a registered adapter (a
        ValueError with LoRA off, a KeyError for an unknown name).
        ``handoff_prefill`` (a prefill-role engine's request): retire
        after the first token, the prompt's committed pages shipped and
        a descriptor staged (``take_handoff_info``)."""
        lora_id = 0
        if lora_name is not None:
            if self.runner.lora_registry is None:
                raise ValueError("LoRA is not enabled on this engine")
            lora_id = self.runner.lora_registry.slot_for(lora_name)
        sampling = sampling or SamplingParams()
        fsm_state = None
        if sampling.guided is not None:
            if sampling.guided != "json":
                raise ValueError(
                    f"unsupported guided mode {sampling.guided!r} "
                    "(supported: 'json')")
            if self.guided_fsm is None:
                raise ValueError(
                    "guided JSON decoding requires a byte-range "
                    "tokenizer")
            fsm_state = 0
        self._stop_ids(sampling)
        seq = Sequence(
            seq_id=seq_id or f"seq-{uuid.uuid4().hex[:16]}",
            prompt_token_ids=self._in_vocab(prompt_token_ids),
            sampling=sampling,
            output_sink=output_sink,
            lora_id=lora_id,
            cache_salt=(self.runner.lora_registry.cache_root(lora_id)
                        if lora_id else 0),
            fsm_state=fsm_state,
            handoff_prefill=handoff_prefill,
            request_id=request_id,
            priority=(self.default_priority if priority is None
                      else int(priority)),
            spec_off=spec_off,
        )
        with self._lock:
            if (not handoff_prefill
                    and self._cold_start_target(seq) is not None):
                # Shared cluster cache: another engine may hold this
                # prompt's prefix KV. Park in AWAITING_KV so the step
                # loop probes the shared tier (one HEAD) before prefill:
                # a hit restores instead of computing; a miss or a tier
                # that is down computes.
                seq.transition(SequenceState.AWAITING_KV)
                seq.cold_start_probe = True
                seq.handoff_arrival_time = time.time()
            self._add(seq)
            if self._tracer is not None:
                self._tracer.start(seq.seq_id, request_id=request_id,
                                   prompt_tokens=seq.num_prompt_tokens)
                if seq.cold_start_probe:
                    self._tracer.event(seq.seq_id, "awaiting_kv_park")
        return seq.seq_id

    def _in_vocab(self, token_ids) -> List[int]:
        """Prompt ids as the JAX model's embedding gather reads them
        (``sequence.in_vocab``). Sampled ids are always in the
        vocabulary, so only the host's ids are mapped, once, here."""
        return in_vocab(token_ids, self.config.model.vocab_size)

    def _add(self, seq: Sequence) -> None:
        """Queue ``seq`` (caller holds the lock)."""
        self.sequences[seq.seq_id] = seq
        try:
            self.scheduler.add_sequence(seq)
        except Exception:
            self.sequences.pop(seq.seq_id, None)
            raise

    def _cold_start_target(self, seq: Sequence):
        """The first full usable prompt page neither on the card nor
        hashed here: the page whose presence in the shared cluster
        cache decides whether a cold prompt restores or computes. None
        without a remote tier or prefix caching, or when the local
        cache covers the prompt. Caller holds the lock."""
        if (self.offload is None or self.offload.remote is None
                or not self.config.cache.enable_prefix_caching):
            return None
        usable = len(seq.prompt_token_ids) - 1
        hashes = PagedCacheManager.chain_hashes(
            seq.prompt_token_ids[:usable], self.cache_manager.page_size,
            seq.cache_salt)
        for page_hash in hashes:
            if page_hash not in self.cache_manager._hash_to_page:
                return page_hash
        return None

    def _stop_ids(self, sampling: SamplingParams) -> None:
        """Add the tokenizer's EOS to the request's stop ids unless it
        ignores EOS."""
        stop_ids = list(sampling.stop_token_ids)
        if (not sampling.ignore_eos
                and self.tokenizer.eos_token_id is not None
                and self.tokenizer.eos_token_id not in stop_ids):
            stop_ids.append(self.tokenizer.eos_token_id)
        sampling.stop_token_ids = stop_ids

    def _add_parked(self, seq: Sequence, sampling: SamplingParams,
                    **trace_event) -> None:
        """Queue ``seq`` parked in AWAITING_KV, with the admission
        clamp undone (it counts the folded output as prompt, which would
        end generation early: ``num_prior_output_tokens`` and the
        max_model_len check already bound the sequence as a monolithic
        engine would). Without an offload tier it recomputes at once.
        ``trace_event`` (name and fields) is traced before the park."""
        orig_max_tokens = sampling.max_tokens
        with self._lock:
            self._add(seq)
            if self._tracer is not None:
                self._tracer.start(seq.seq_id, request_id=seq.request_id,
                                   prompt_tokens=seq.num_prompt_tokens)
                if trace_event:
                    self._tracer.event(seq.seq_id, **trace_event)
                self._tracer.event(seq.seq_id, "awaiting_kv_park")
            sampling.max_tokens = orig_max_tokens
            if self.offload is None:
                seq.transition(SequenceState.WAITING)
                self.metrics.on_handoff_admitted(0.0)
                if self._tracer is not None:
                    self._tracer.event(seq.seq_id, "awaiting_kv_restore",
                                       waited_ms=0.0, outcome="no_tier")

    def add_handoff(self, prompt_token_ids: List[int], first_token: int,
                    sampling: Optional[SamplingParams] = None,
                    seq_id: Optional[str] = None,
                    output_sink=None,
                    request_id: Optional[str] = None) -> str:
        """Take a disaggregated prefill-to-decode handoff: park the
        sequence in AWAITING_KV until its shipped pages are reachable in
        an offload tier (or the handoff timeout degrades it to a
        recompute). The prefill engine's first token is folded into the
        prompt as a preemption folds generated tokens, with
        ``num_prior_output_tokens = 1`` keeping every budget counting;
        the caller sends that token to the client itself, and this
        engine streams from the second."""
        sampling = sampling or SamplingParams()
        self._stop_ids(sampling)
        if sampling.guided is not None:
            raise ValueError(
                "guided decoding is not supported across a disagg "
                "handoff (automaton state does not transfer)")
        seq = Sequence(
            seq_id=seq_id or f"seq-{uuid.uuid4().hex[:16]}",
            prompt_token_ids=self._in_vocab(
                list(prompt_token_ids) + [int(first_token)]),
            sampling=sampling,
            output_sink=output_sink,
            state=SequenceState.AWAITING_KV,
            num_prior_output_tokens=1,
            handoff_arrival_time=time.time(),
            request_id=request_id,
        )
        self._add_parked(seq, sampling)
        with self._lock:
            self.disagg_decode_requests += 1
        return seq.seq_id

    def add_resume(self, token_ids: List[int],
                   num_prior_output_tokens: int,
                   sampling: Optional[SamplingParams] = None,
                   seq_id: Optional[str] = None,
                   output_sink=None,
                   request_id: Optional[str] = None) -> str:
        """Resume a stream whose engine died mid-generation:
        ``token_ids`` is the journaled committed context (the prompt
        and every token generated up to the last checkpoint), folded
        into the prompt as a preemption folds generated tokens, with
        ``num_prior_output_tokens`` keeping every budget counting. The
        sequence parks in AWAITING_KV; the probe then restores the
        checkpointed pages from the offload tier, or a miss recomputes
        from the journal. Greedy generation continues byte-identically
        either way; nothing is replayed to the client (the server skips
        the text already delivered)."""
        sampling = sampling or SamplingParams()
        self._stop_ids(sampling)
        if sampling.guided is not None:
            raise ValueError(
                "guided decoding is not supported across a resume "
                "(automaton state does not transfer)")
        seq = Sequence(
            seq_id=seq_id or f"seq-{uuid.uuid4().hex[:16]}",
            prompt_token_ids=self._in_vocab(token_ids),
            sampling=sampling,
            output_sink=output_sink,
            state=SequenceState.AWAITING_KV,
            num_prior_output_tokens=int(num_prior_output_tokens),
            handoff_arrival_time=time.time(),
            request_id=request_id,
        )
        self._add_parked(seq, sampling, name="resume_restore",
                         prior_tokens=int(num_prior_output_tokens))
        with self._lock:
            self.stream_resumes += 1
        return seq.seq_id

    def take_checkpoint(self, seq_id: str) -> Optional[dict]:
        """Drain the latest unsent resume descriptor of ``seq_id``
        (None when no checkpoint landed since the last take)."""
        with self._lock:
            return self._checkpoints.pop(seq_id, None)

    def _checkpoint_tick(self) -> None:
        """Every ``checkpoint_interval_tokens`` generated tokens, ship
        a running stream's new committed pages to the offload tier
        (incrementally: pages shipped before are skipped) and stage a
        resume descriptor journaling its whole committed token context.
        Guided and LoRA streams are skipped (the automaton state and the
        adapter's identity do not transfer). Without an offload tier the
        journal alone is staged, so a resume recomputes."""
        interval = self.config.checkpoint_interval_tokens
        with self._lock:
            for seq in list(self.scheduler.running):
                if (seq.state != SequenceState.RUNNING
                        or seq.sampling.guided is not None
                        or seq.lora_id != 0):
                    continue
                last = self._ckpt_last_tokens.get(seq.seq_id, 0)
                if seq.num_generated - last < interval:
                    continue
                self._ckpt_last_tokens[seq.seq_id] = seq.num_generated
                shipped = kv_bytes = 0
                if self.offload is not None and seq.pages:
                    done = self._ckpt_shipped_pages.get(seq.seq_id, 0)
                    total, shipped, kv_bytes = self._ship_pages(seq, done)
                    self._ckpt_shipped_pages[seq.seq_id] = total
                self.checkpoint_ships += 1
                self.checkpoint_kv_bytes += kv_bytes
                self._checkpoints[seq.seq_id] = {
                    "tokens": [int(t) for t in seq.all_token_ids],
                    "prompt_tokens": seq.total_len - seq.num_generated,
                    "output_tokens": seq.num_generated,
                    "num_pages": self._ckpt_shipped_pages.get(
                        seq.seq_id, 0),
                    "kv_bytes": kv_bytes,
                }
                if self._tracer is not None:
                    self._tracer.event(
                        seq.seq_id, "checkpoint_ship", pages=shipped,
                        kv_bytes=kv_bytes, tokens=seq.num_generated)

    def _drop_checkpoint_state(self, seq_id: str) -> None:
        """Caller holds the lock (or the sequence is retired)."""
        self._checkpoints.pop(seq_id, None)
        self._ckpt_last_tokens.pop(seq_id, None)
        self._ckpt_shipped_pages.pop(seq_id, None)

    def take_handoff_info(self, seq_id: str) -> Optional[dict]:
        """Drain the descriptor payload staged when ``seq_id`` finished
        its prefill handoff (None if it never shipped)."""
        with self._lock:
            return self._handoff_info.pop(seq_id, None)

    def _ship_handoff(self, seq: Sequence) -> None:
        """A prefill-role request's first token is committed: ship the
        prompt's committed full pages to the offload tier, stage the
        descriptor payload (pages, bytes, tier keys) for the server and
        retire the sequence, so that its pages free for the next
        prefill. Without a tier nothing ships and the decode side
        recomputes. Caller holds the lock."""
        info = {"num_pages": 0, "kv_bytes": 0, "page_keys": []}
        if self.offload is not None and seq.pages:
            _, info["num_pages"], info["kv_bytes"] = self._ship_pages(
                seq, keys=info["page_keys"])
        self._handoff_info[seq.seq_id] = info
        self.disagg_prefill_requests += 1
        self.disagg_kv_bytes_shipped += info["kv_bytes"]
        if self._tracer is not None:
            self._tracer.event(seq.seq_id, "handoff_ship",
                               num_pages=info["num_pages"],
                               kv_bytes=info["kv_bytes"])
        self.scheduler.finish_handoff(seq)

    def _handoff_kv_ready(self, seq: Sequence) -> Optional[bool]:
        """Whether a parked sequence's KV is reachable. Pages ship in
        chain order, so probing the LAST page (one HEAD at most)
        answers for the whole chain; True/False is definitive, None a
        tier that could not be reached. A cold-start probe asks whether
        the shared cache extends the local prefix, so it probes the
        FIRST page the local cache lacks (the HEAD also records this
        engine's demand, which promotes shared chains)."""
        if seq.cold_start_probe:
            target = self._cold_start_target(seq)
            if target is None:
                return True  # the local cache caught up meanwhile
            return self.offload.handoff_ready(target)
        usable = len(seq.prompt_token_ids) - 1
        hashes = PagedCacheManager.chain_hashes(
            seq.prompt_token_ids[:usable], self.cache_manager.page_size,
            seq.cache_salt)
        if not hashes:
            return True  # shorter than a page: recompute
        return self.offload.handoff_ready(hashes[-1])

    def _admit_handoffs(self) -> None:
        """Flip AWAITING_KV sequences to WAITING once their pages are
        reachable (the first-touch restore then pulls them), or degrade
        to recompute on a definitive miss or after
        ``handoff_timeout_s`` of an unreachable tier. Either way the
        request completes."""
        now = time.time()
        with self._lock:
            for seq in list(self.scheduler.waiting):
                if seq.state != SequenceState.AWAITING_KV:
                    continue
                ready = self._handoff_kv_ready(seq)
                if ready is None and not seq.cold_start_probe:
                    if (now - seq.handoff_arrival_time
                            < self.config.handoff_timeout_s):
                        continue
                    logger.warning(
                        "%s timed out waiting for KV; degrading to "
                        "recompute", seq.seq_id)
                elif ready is False and not seq.cold_start_probe:
                    logger.warning(
                        "%s KV not in any offload tier; degrading to "
                        "recompute", seq.seq_id)
                seq.transition(SequenceState.WAITING)
                if not seq.cold_start_probe:
                    # Cold-start parks are admission probes, not
                    # transfers: they stay out of the histogram.
                    self.metrics.on_handoff_admitted(
                        now - seq.handoff_arrival_time)
                if self._tracer is not None:
                    probe = seq.cold_start_probe
                    self._tracer.event(
                        seq.seq_id, "awaiting_kv_restore",
                        waited_ms=round(
                            (now - seq.handoff_arrival_time) * 1e3, 2),
                        outcome=("ready" if ready
                                 else "tier_down" if ready is None and probe
                                 else "timeout" if ready is None
                                 else "miss" if probe else "lost"))

    def register_lora(self, name_or_path: str,
                      name: Optional[str] = None) -> int:
        """Load a PEFT adapter directory and serve it under ``name``
        (default: the directory's name); returns its slot. The slot is
        written in place, so steps already captured as graphs see it."""
        if self.runner.lora_registry is None:
            raise ValueError("LoRA is not enabled on this engine")
        adapter = load_peft_adapter(name_or_path, self.config.model,
                                    self.config.lora.max_lora_rank,
                                    name=name)
        with self._lock:
            return self.runner.register_lora(adapter)

    def lora_names(self) -> List[str]:
        if self.runner.lora_registry is None:
            return []
        return self.runner.lora_registry.names()

    def abort_request(self, seq_id: str) -> None:
        with self._lock:
            seq = self.sequences.pop(seq_id, None)
            if seq is not None:
                self.scheduler.abort_sequence(seq)
                self.metrics.on_finished(seq)
                self._drop_checkpoint_state(seq_id)
                if self._tracer is not None:
                    self._trace_finish(seq)

    def _trace_finish(self, seq: Sequence) -> None:
        """Close ``seq``'s span (the caller checked the tracer)."""
        self._tracer.finish(
            seq.seq_id,
            reason=seq.finish_reason.value if seq.finish_reason else None,
            arrival_ts=seq.arrival_time,
            first_scheduled_ts=seq.first_scheduled_time,
            first_token_ts=seq.first_token_time,
            finish_ts=seq.finish_time,
            prompt_tokens=seq.num_prompt_tokens,
            output_tokens=seq.num_generated)

    def has_work(self) -> bool:
        # A dispatched-but-unread decode step is work: the loop must
        # come back to reconcile it even if every row since finished.
        return self._in_flight is not None or self.scheduler.has_work()

    # ---- engine step ------------------------------------------------------

    def step(self) -> List[StepOutput]:
        """Plan + execute one device step; returns per-seq deltas.
        Parked sequences are admitted and checkpoints shipped first, at
        the plan boundary."""
        if self.scheduler.num_awaiting_kv:
            self._admit_handoffs()
        if self.config.checkpoint_interval_tokens > 0:
            self._checkpoint_tick()
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
        self._account_step(host_s=(time.perf_counter() - t0) - wait_s,
                           wait_s=wait_s, ahead=False)
        self._pop_finished(outputs)
        return outputs

    def _account_step(self, host_s: float, wait_s: float, ahead: bool,
                      pipeline_break: bool = False, **extra) -> None:
        """One step's accounting fan-out: the pipeline metrics, the
        observatory's step ledger (the seconds waited on the read-back
        and the committed tokens the execute helper staged) and, with a
        tracer, a flight-recorder record with the staged row detail."""
        self.metrics.on_pipeline_step(host_s=host_s, device_wait_s=wait_s,
                                      ahead=ahead)
        obs_note, self._obs_note = self._obs_note, None
        obs = self.runner.observatory
        if obs_note is not None and obs is not None:
            obs.on_step(obs_note[0], wait_s, obs_note[1])
        if self._tracer is not None:
            note = self._step_note or {}
            self._step_note = None
            note.update(extra)
            self._tracer.on_step(
                host_ms=round(host_s * 1e3, 3),
                device_wait_ms=round(wait_s * 1e3, 3),
                ahead=ahead, pipeline_break=pipeline_break, **note)

    def _execute_prefill(self, plan, outputs) -> float:
        td = time.perf_counter()
        self._note_dispatch(td)
        sampled, lps = self.runner.run_prefill(plan.prefill)
        tr = time.perf_counter()
        self._idle_mark = tr
        chunks = plan.prefill.chunks
        with self._lock:
            self._commit_prefill(chunks, sampled, lps, outputs)
            if self._tracer is not None:
                self._step_note = {"kind": "prefill",
                                   "prefill_rows": len(chunks),
                                   "row_bucket": self.runner.prefill_width}
        self._obs_note = ("prefill", sum(len(c.chunk_tokens)
                                         for c in chunks))
        return tr - td

    def _commit_prefill(self, chunks, tokens, lps, outputs) -> None:
        """Commit prefill chunks; a last chunk's sampled token is the
        row's first, and a prefill-role row still running after it is
        shipped and retired (caller holds the lock)."""
        for i, (chunk, token) in enumerate(zip(chunks, tokens)):
            self.scheduler.on_prefill_executed(chunk, token)
            if chunk.is_last_chunk:
                if (chunk.seq.handoff_prefill
                        and chunk.seq.state == SequenceState.RUNNING):
                    self._ship_handoff(chunk.seq)
                outputs.append(self._delta(chunk.seq, token,
                                           lps[i] if lps else None))

    def _commit_decode(self, seqs, token_lists, outputs, lp_lists=None,
                       drafts=None, expected_lens=None) -> tuple:
        """Commit decode rows' tokens (caller holds the lock), each with
        its logprob entry where ``lp_lists`` has one; returns (tokens
        committed, drafted, accepted).

        ``drafts`` (verify steps): per-row draft lists; each row emits
        accepted + 1 tokens, counted before any stop truncation so the
        acceptance rate reflects the model, not request budgets.
        ``expected_lens`` (the assume-one-token successor of a verify
        step): rows whose total_len differs from it are stale — the
        verify committed more than one token, so this sample came from
        incomplete context — and are dropped. Their KV write was
        correct either way: it fed the first committed token."""
        now = time.time()
        drafted = accepted = committed = 0
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
            for k, tok in enumerate(toks):
                if seq.state != SequenceState.RUNNING:
                    break  # stop hit mid-span: drop the tail
                self.scheduler.append_decode_token(seq, tok)
                emitted += 1
                outputs.append(self._delta(
                    seq, tok, lp_lists[i][k] if lp_lists else None))
            committed += emitted
            self.metrics.on_decode_tokens(seq, emitted, now)
            if drafts is not None:
                self.scheduler.on_spec_executed(seq)
        if drafts is not None:
            self.metrics.on_spec_step(drafted, accepted)
        return committed, drafted, accepted

    def _execute_decode_sync(self, plan, outputs) -> float:
        td = time.perf_counter()
        self._note_dispatch(td)
        token_lists, lp_lists = self.runner.run_decode(plan.decode)
        tr = time.perf_counter()
        self._idle_mark = tr
        spec = plan.decode.drafts is not None
        with self._lock:
            committed, drafted, accepted = self._commit_decode(
                plan.decode.seqs, token_lists, outputs, lp_lists,
                drafts=plan.decode.drafts)
            if self._tracer is not None:
                self._step_note = {
                    "kind": "spec" if spec else "decode",
                    "decode_rows": len(plan.decode.seqs),
                    "row_bucket": self.runner.decode_width,
                    "window": plan.decode.window,
                    "spec_drafted": drafted, "spec_accepted": accepted}
        self._obs_note = ("spec" if spec else "decode", committed)
        return tr - td

    def _execute_unified(self, plan, outputs) -> float:
        """One unified ragged step: decode rows (through the verify
        contract, 1..K + 1 tokens each) and prefill chunk rows commit
        out of a single device step."""
        td = time.perf_counter()
        self._note_dispatch(td)
        (token_lists, lp_lists, prefill_toks,
         prefill_lps) = self.runner.run_unified(plan)
        tr = time.perf_counter()
        self._idle_mark = tr
        seqs = plan.decode.seqs[: self.runner.decode_width]
        chunks = plan.prefill.chunks[: self.runner.prefill_width]
        pad_rows = self.runner.last_unified_rows - len(chunks) - len(seqs)
        self.metrics.on_ragged_step(prefill_rows=len(chunks),
                                    decode_rows=len(seqs),
                                    pad_rows=pad_rows)
        with self._lock:
            committed, drafted, accepted = self._commit_decode(
                seqs, token_lists, outputs, lp_lists,
                drafts=plan.decode.drafts)
            self._commit_prefill(chunks, prefill_toks, prefill_lps,
                                 outputs)
            if self._tracer is not None:
                self._step_note = {
                    "kind": "unified", "prefill_rows": len(chunks),
                    "decode_rows": len(seqs), "pad_rows": pad_rows,
                    "row_bucket": self.runner.last_unified_rows,
                    "window": plan.decode.window,
                    "spec_drafted": drafted, "spec_accepted": accepted}
        self._obs_note = ("unified", committed + sum(
            len(c.chunk_tokens) for c in chunks))
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
                self._account_step(
                    host_s=(time.perf_counter() - t0) - wait_s,
                    wait_s=wait_s, ahead=True)
                return outputs
            # Pipeline break (prefill waiting / ineligible row / no
            # boundary pages): drain the in-flight step, then let the
            # next step() re-plan synchronously with full knowledge.
            self._in_flight = None
            self.metrics.set_inflight_depth(0)
            outputs, wait_s = self._complete(handle)
            self._idle_mark = time.perf_counter()
            self._account_step(
                host_s=(time.perf_counter() - t0) - wait_s,
                wait_s=wait_s, ahead=False, pipeline_break=True)
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
            self._account_step(
                host_s=(time.perf_counter() - t0) - wait_s,
                wait_s=wait_s, ahead=False, pipeline_break=True)
            self._pop_finished(outputs)
            return outputs
        if plan.decode.drafts is None and plan.decode.window > 1:
            # A burst already hides the host's work for window - 1 of
            # its iterations, so it runs synchronously rather than
            # through the depth-1 pipeline (stacking both would
            # speculate a whole window ahead).
            wait_s = self._execute_decode_sync(plan, outputs)
            self._account_step(
                host_s=(time.perf_counter() - t0) - wait_s,
                wait_s=wait_s, ahead=False)
            self._pop_finished(outputs)
            return outputs
        # Pure-decode or verify plan: queue it and return without
        # waiting; the next turn plans ahead against it (a verify
        # step's commit count is data-dependent, so its successor
        # assumes one token and reconciles in _complete).
        self._note_dispatch(time.perf_counter())
        if plan.decode.drafts is not None:
            self._in_flight = self.runner.dispatch_spec(plan.decode)
            kind = "spec_dispatch"
        else:
            self._in_flight = self.runner.dispatch_decode(
                plan.decode.seqs[: self.runner.decode_width])
            kind = "decode_dispatch"
        self.metrics.set_inflight_depth(1)
        self._account_step(host_s=time.perf_counter() - t0, wait_s=0.0,
                           ahead=False, kind=kind)
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
        token_lists, lp_lists = handle.result()
        wait_s = time.perf_counter() - tw
        outputs: List[StepOutput] = []
        with self._lock:
            committed, drafted, accepted = self._commit_decode(
                handle.rows, token_lists, outputs, lp_lists,
                drafts=handle.drafts, expected_lens=handle.expected_lens)
            if self._tracer is not None:
                self._step_note = {
                    "kind": "spec" if handle.is_spec else "decode",
                    "decode_rows": sum(1 for seq in handle.rows
                                       if seq is not None),
                    "row_bucket": self.runner.decode_width,
                    "spec_drafted": drafted, "spec_accepted": accepted}
        self._obs_note = ("spec" if handle.is_spec else "decode",
                          committed)
        self._pop_finished(outputs)
        return outputs, wait_s

    def _pop_finished(self, outputs: List[StepOutput]) -> None:
        for out in outputs:
            if out.finished:
                seq = self.sequences.pop(out.seq_id, None)
                if seq is not None:
                    self.metrics.on_finished(seq)
                    self._drop_checkpoint_state(out.seq_id)
                    if self._tracer is not None:
                        self._trace_finish(seq)

    def _note_dispatch(self, now: float) -> None:
        """Device-idle accounting: accumulate the gap between the
        device draining its queue and the next dispatch."""
        if self._idle_mark is not None:
            self.metrics.on_device_idle(now - self._idle_mark)
            self._idle_mark = None

    @staticmethod
    def _delta(seq: Sequence, token: Optional[int],
               logprobs: Optional[tuple] = None) -> StepOutput:
        finished = seq.state in (
            SequenceState.FINISHED, SequenceState.ABORTED
        )
        return StepOutput(
            seq_id=seq.seq_id,
            new_token=token,
            finished=finished,
            finish_reason=(seq.finish_reason.value
                           if seq.finish_reason else None),
            logprobs=logprobs,
        )

    def _guided_advance(self, seq: Sequence, token: int) -> None:
        """The host's mirror of a guided row's automaton (the
        scheduler's hook): a token the automaton rejects (only a stop
        id past the device's suppression width can be one) leaves the
        state as it was."""
        state = self.guided_fsm.advance(seq.fsm_state, token)
        if state >= 0:
            seq.fsm_state = state

    # ---- metrics ----------------------------------------------------------

    def stats(self) -> Dict[str, float]:
        m = self.metrics
        out = {
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
            "disagg_prefill_requests_total": self.disagg_prefill_requests,
            "disagg_decode_requests_total": self.disagg_decode_requests,
            "disagg_kv_bytes_shipped_total": self.disagg_kv_bytes_shipped,
            "disagg_awaiting_kv_requests": self.scheduler.num_awaiting_kv,
            "checkpoint_ships_total": self.checkpoint_ships,
            "checkpoint_kv_bytes_total": self.checkpoint_kv_bytes,
            "stream_resumes_total": self.stream_resumes,
        }
        if self.offload is not None:
            out.update({f"kv_offload_{k}": v
                        for k, v in self.offload.stats().items()})
        return out

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
