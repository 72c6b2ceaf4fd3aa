"""Model runner: owns the device state and runs each step.

The JAX engine's runner compiles a program per shape and donates the
caches through it; here PyTorch runs eagerly and the KV buffers (a
list of per-layer buffers, or one stacked buffer per k/v) are updated
in place. The shapes stay the JAX engine's closed sets — prefill
chunks padded to power-of-two buckets, decode at a fixed slot width,
unified [R, W] blocks on a row-bucket lattice — so the
kernels see the same shapes on both, and a later CUDA-graph capture
has a small set to capture.

One kernel per step kind on the card, named by the runner (never
inferred from shapes): decode steps go through the decode kernel,
prefill steps through the chunked-prefill kernel, unified mixed steps
and speculative verify steps through the ragged kernel
(models/llama.dispatch_attention). The JAX runner's lowering probes
and impl ladders have no counterpart; its verify program attends
through the prefill path, the port's through the ragged kernel, whose
contract on live slots is the same. A decode burst (``decode_steps``
> 1) is K chained decode iterations with the sampled tokens and each
row's lifecycle kept on the device: one host read per K tokens.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.scheduler import (
    DecodePlan,
    PrefillPlan,
    StepPlan,
)
from production_stack_tpu_torch.engine.sequence import (
    Sequence,
    decode_budget,
)
from production_stack_tpu_torch.models.registry import get_model
from production_stack_tpu_torch.ops.paged_kv_common import (
    check_kernel_shapes,
)
from production_stack_tpu_torch.ops.quant_kv import quant_cache_zeros
from production_stack_tpu_torch.ops.sampling import (
    burst_sample_step,
    sample_tokens,
    spec_verify,
)
from production_stack_tpu_torch.utils.log import init_logger

logger = init_logger(__name__)

KIND_PREFILL = 1
KIND_DECODE = 2
KIND_SPEC = 4
KIND_UNIFIED = 5


def resolve_device(device=None) -> torch.device:
    """The engine's device: ``cuda`` unless the caller asks for the
    CPU. Raises when CUDA is asked for (or defaulted to) and there is
    no card — never falls back to the CPU quietly."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (or "
            "--device cpu) to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def prefill_buckets(chunk_size: int) -> List[int]:
    buckets, b = [], 16
    while b < chunk_size:
        buckets.append(b)
        b *= 2
    buckets.append(chunk_size)
    return buckets


def unified_row_buckets(rows: int) -> List[int]:
    """The doubling row lattice (2, 3, 4, 6, 8, 12, ...) capped at
    ``rows``, so a lightly mixed step does not pay for full-width pad
    rows."""
    buckets, b = [], 2
    while b < rows:
        buckets.append(b)
        if b + b // 2 < rows:
            buckets.append(b + b // 2)
        b *= 2
    buckets.append(rows)
    return buckets


class DecodeStepHandle:
    """One dispatched-but-unread decode: a single step, or a burst of
    K iterations.

    The kernels are queued on the card's stream; ``token_source`` is
    the sampled-token CUDA tensor the NEXT step consumes without a
    host round trip (single steps only), and ``result()`` is the
    step's one ``.cpu()``.
    """

    is_spec = False
    drafts = None

    def __init__(self, rows, sampled: torch.Tensor):
        # List[Optional[Sequence]]: None rows are plan-ahead slots
        # whose sequence was already known to finish (dispatched as
        # masked pad rows so row alignment with token_source holds).
        self.rows = rows
        # [B] for a single step; [B, K] for a burst, -1 where a row
        # was frozen.
        self.sampled = sampled
        # Set on the assume-one-token successor of a verify step: per
        # row, the total_len that assumption predicts. The engine
        # drops the rows whose verify committed more (their sample
        # came from incomplete context).
        self.expected_lens: Optional[List[Optional[int]]] = None

    @property
    def token_source(self) -> torch.Tensor:
        """The [B] sampled-token device tensor (async feed-forward)."""
        return self.sampled

    def result(self) -> List[List[int]]:
        host = self.sampled.cpu().tolist()
        if self.sampled.dim() == 1:
            return [[host[i]] for i in range(len(self.rows))]
        return [[t for t in host[i] if t >= 0]
                for i in range(len(self.rows))]


class SpecStepHandle:
    """One dispatched-but-unread speculative verify step.

    The async pipeline treats a verify step as a decode step with a
    data-dependent commit count (1..K + 1 tokens a row).
    ``token_source`` is the [B] device tensor of each row's FIRST
    emitted token: whatever the acceptance, it is committed, and the
    assume-one-token successor that feeds it at position L writes
    position L's correct KV either way (the verify step's own write of
    the accepted first draft again, up to the decode kernel's order of
    sums, or a repair of the rejected draft's KV). ``result()`` is the
    step's one ``.cpu()``.
    """

    is_spec = True
    # A verify step is never dispatched behind an unread verify step
    # (the engine breaks the pipeline instead).
    expected_lens = None

    def __init__(self, rows, drafts, sampled: torch.Tensor):
        self.rows = rows  # List[Sequence], no None slots
        self.drafts = drafts  # per-row draft lists, parallel to rows
        self.sampled = sampled  # [B, K + 1], -1 past each row's tokens

    @property
    def token_source(self) -> torch.Tensor:
        return self.sampled[:, 0]

    def result(self) -> List[List[int]]:
        host = self.sampled.cpu().tolist()
        return [[t for t in host[i] if t >= 0]
                for i in range(len(self.rows))]


class ModelRunner:
    def __init__(self, config: EngineConfig, params=None, device=None):
        self.config = config
        self.device = resolve_device(device)
        model_config = config.model
        if config.cache.cache_layout == "auto":
            # The JAX engine's rule: stacked only for pipeline or
            # context parallelism, which the port does not serve.
            config.cache.cache_layout = "per_layer"
        self.cache_layout = config.cache.cache_layout
        init_fn, self._forward = get_model(model_config)
        if params is None:
            logger.info("Initializing random weights for %s",
                        model_config.name)
            gen = torch.Generator(device=self.device)
            gen.manual_seed(config.seed)
            params = init_fn(model_config, gen, self.device)
        self.params = params.to(self.device)
        # int8 KV: pages quantized on write with per-slot f32 scales
        # (ops/quant_kv.py), dequantized inside the kernels.
        self.kv_quantized = config.cache.resolved_kv_dtype() == "int8"
        cache_dtype = (torch.int8 if self.kv_quantized
                       else model_config.torch_dtype)
        if self.device.type == "cuda":
            # Fail at start-up, not at the first step: the kernel
            # library is built (or found) and loaded now, and the
            # geometry (with the cache's dtype, and for int8 a page
            # size that is a multiple of 16) must be one it is built
            # for.
            check_kernel_shapes(
                model_config.num_attention_heads,
                model_config.num_key_value_heads, model_config.head_dim,
                config.cache.page_size, model_config.torch_dtype,
                cache_dtype)

        # per_layer: one [kv_heads, pages, d, page_size] buffer per
        # layer, k and v; stacked: one [L, kv_heads, pages, d,
        # page_size] buffer each, written and read in place at the
        # layer index. For int8 each is a QuantKV of int8 pages and
        # their [(L,) kv_heads, pages, page_size] scales.
        layers = model_config.num_hidden_layers
        shape = (model_config.num_key_value_heads, config.cache.num_pages,
                 model_config.head_dim, config.cache.page_size)

        def cache(shape):
            if self.kv_quantized:
                return quant_cache_zeros(shape, self.device)
            return torch.zeros(shape, dtype=cache_dtype, device=self.device)

        if self.cache_layout == "stacked":
            self.k_cache = cache((layers,) + shape)
            self.v_cache = cache((layers,) + shape)
        else:
            self.k_cache = [cache(shape) for _ in range(layers)]
            self.v_cache = [cache(shape) for _ in range(layers)]

        self.max_pages_per_seq = config.scheduler.max_pages_per_seq(
            config.cache.page_size)
        self.decode_width = config.scheduler.max_num_seqs
        self.prefill_width = config.scheduler.prefill_batch_size
        self._buckets = prefill_buckets(
            config.scheduler.prefill_chunk_size)
        self.unified_rows = self.decode_width + self.prefill_width
        self.unified_row_buckets = unified_row_buckets(self.unified_rows)
        # Speculative verify blocks are [decode_width, K + 1]; a unified
        # block is at least K + 1 wide, so a decode row carries its
        # drafts in it.
        self.spec_width = (config.scheduler.speculative_k + 1
                           if config.scheduler.speculative_k > 0 else 0)
        self.unified_span = max(self.spec_width, 1)
        # Last dispatched ragged shape, for occupancy metrics.
        self.last_unified_rows = 0
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(config.seed + 1)

    # ---- steps --------------------------------------------------------------

    def _to_device(self, arrays: dict) -> dict:
        return {name: (arr if isinstance(arr, torch.Tensor)
                       else torch.from_numpy(arr)).to(self.device,
                                                       non_blocking=True)
                for name, arr in arrays.items()}

    @staticmethod
    def _knobs(payload: dict):
        """Per-row sampling knobs as CPU tensors (host decisions)."""
        return (torch.from_numpy(payload["temperature"]),
                torch.from_numpy(payload["top_p"]),
                torch.from_numpy(payload["top_k"]))

    def _step_impl(self, payload: dict, sample_index_mode: str
                   ) -> torch.Tensor:
        """Prefill ("last": sample each row's final prompt position) or
        single-step decode ("first": T == 1)."""
        dev = self._to_device({k: payload[k] for k in (
            "tokens", "positions", "page_table", "kv_lens", "valid",
            "last_index")})
        tokens = dev["tokens"]
        if tokens.dim() == 1:
            # Decode feeds [B] tokens so an ahead dispatch can consume
            # the previous step's [B] sampled tensor verbatim.
            tokens = tokens[:, None]
        positions = dev["positions"].reshape(tokens.shape)
        valid = dev["valid"].reshape(tokens.shape)
        select = (dev["last_index"].long()[:, None]
                  if sample_index_mode == "last" else None)
        logits = self._forward(
            self.params, self.config.model, tokens, positions,
            dev["page_table"], dev["kv_lens"], valid, self.k_cache,
            self.v_cache, select=select,
            kind="decode" if sample_index_mode == "first" else "prefill")
        seeding = {}
        if "seeds" in payload:
            seeding = {name: torch.from_numpy(payload[name])
                       for name in ("seeds", "emitted", "seed_mask")}
        return sample_tokens(logits[:, 0], *self._knobs(payload),
                             generator=self.generator, **seeding)

    def _unified_impl(self, payload: dict) -> torch.Tensor:
        """One ragged [R, W] step through the ragged kernel: decode
        rows occupy their first 1 + draft_len slots ([last committed,
        d_1 .. d_k] at total_len - 1 ..), prefill chunk rows up to W
        slots, pad slots are masked by ``valid``. A verify step is the
        same block with decode rows only. Sampling goes through the
        verify rule over each row's span ``logits[i, last_index_i -
        draft_lens_i + j]``; a draft-free row's span is its last real
        position, and at temperature 0 the rule is the plain argmax.

        Rejected drafts need no rollback on the card: their KV lies
        past the committed length in the row's own pages, causally
        invisible until the next step overwrites it."""
        dev = self._to_device({k: payload[k] for k in (
            "tokens", "positions", "page_table", "kv_lens", "valid",
            "last_index", "drafts", "draft_lens")})
        tokens = dev["tokens"]
        s = dev["drafts"].shape[-1] + 1
        start = torch.clamp(dev["last_index"].long()
                            - dev["draft_lens"].long(), min=0)
        idx = torch.clamp(start[:, None] + torch.arange(
            s, device=self.device)[None, :], 0, tokens.shape[1] - 1)
        span = self._forward(
            self.params, self.config.model, tokens, dev["positions"],
            dev["page_table"], dev["kv_lens"], dev["valid"],
            self.k_cache, self.v_cache, select=idx, kind="ragged")
        return spec_verify(span, dev["drafts"], dev["draft_lens"],
                           *self._knobs(payload),
                           generator=self.generator)

    def execute_payload(self, kind: int, payload: dict) -> torch.Tensor:
        """Run one step from a payload of numpy arrays (a decode step's
        tokens may instead be the previous step's device tensor).
        Returns the sampled tokens as a device tensor: [B] for prefill
        and decode, [R, span] for unified and verify steps."""
        with torch.inference_mode():
            if kind in (KIND_UNIFIED, KIND_SPEC):
                return self._unified_impl(payload)
            if kind not in (KIND_PREFILL, KIND_DECODE):
                raise ValueError(f"unknown step kind {kind}")
            return self._step_impl(
                payload, "last" if kind == KIND_PREFILL else "first")

    def _bucket_for(self, n: int) -> int:
        for b in self._buckets:
            if n <= b:
                return b
        return self._buckets[-1]

    def _row_bucket_for(self, n: int) -> int:
        for b in self.unified_row_buckets:
            if n <= b:
                return b
        return self.unified_row_buckets[-1]

    @staticmethod
    def _knob_arrays(rows: int):
        # Pad rows stay temperature 0 so an all-greedy batch keeps the
        # sampler's sort-free fast path.
        return (np.zeros((rows,), np.float32), np.ones((rows,), np.float32),
                np.zeros((rows,), np.int32))

    def _seed_payload(self, seqs: "List[Optional[Sequence]]",
                      pad_to: int) -> dict:
        """Per-row seeds for seeded requests, or {} when no row is
        seeded. A seeded row's randomness derives only from (seed,
        tokens emitted so far)."""
        if not any(s is not None and s.sampling.seed is not None
                   for s in seqs):
            return {}
        seeds = np.zeros((pad_to,), np.int64)
        emitted = np.zeros((pad_to,), np.int64)
        mask = np.zeros((pad_to,), bool)
        for i, seq in enumerate(seqs):
            if seq is None or seq.sampling.seed is None:
                continue
            seeds[i] = seq.sampling.seed
            emitted[i] = seq.num_generated
            mask[i] = True
        return {"seeds": seeds, "emitted": emitted, "seed_mask": mask}

    # ---- prefill ------------------------------------------------------------

    def run_prefill(self, plan: PrefillPlan) -> List[Optional[int]]:
        """Execute one batched prefill step (the next chunk of up to
        ``prefill_batch_size`` distinct sequences, rows padded to the
        fixed width). Returns one sampled token per chunk — None for
        rows whose prompt is not yet fully prefilled."""
        chunks = plan.chunks
        b = self.prefill_width
        t = self._bucket_for(max(len(c.chunk_tokens) for c in chunks))
        tokens = np.zeros((b, t), np.int32)
        positions = np.zeros((b, t), np.int32)
        valid = np.zeros((b, t), bool)
        kv_lens = np.zeros((b,), np.int32)
        last_index = np.zeros((b,), np.int32)
        temperature, top_p, top_k = self._knob_arrays(b)
        for i, chunk in enumerate(chunks):
            n = len(chunk.chunk_tokens)
            tokens[i, :n] = chunk.chunk_tokens
            positions[i, :n] = np.arange(chunk.chunk_start,
                                         chunk.chunk_start + n)
            valid[i, :n] = True
            kv_lens[i] = chunk.chunk_start + n
            last_index[i] = n - 1
            sp = chunk.seq.sampling
            temperature[i] = sp.temperature
            top_p[i] = sp.top_p
            top_k[i] = sp.top_k
        payload = {
            "tokens": tokens, "positions": positions, "valid": valid,
            "page_table": self._page_table_rows(
                [c.seq for c in chunks], pad_to=b),
            "kv_lens": kv_lens, "last_index": last_index,
            "temperature": temperature, "top_p": top_p, "top_k": top_k,
        }
        # Only rows whose LAST chunk is in this step keep their sample.
        payload.update(self._seed_payload(
            [c.seq if c.is_last_chunk else None for c in chunks], b))
        sampled = self.execute_payload(KIND_PREFILL, payload)
        if not any(c.is_last_chunk for c in chunks):
            return [None] * len(chunks)
        host = sampled.cpu().tolist()
        return [host[i] if c.is_last_chunk else None
                for i, c in enumerate(chunks)]

    # ---- decode -------------------------------------------------------------

    def dispatch_decode(self, rows, token_source: Optional[torch.Tensor]
                        = None, ahead: bool = False,
                        window: int = 1) -> DecodeStepHandle:
        """Build and queue ONE decode dispatch with no host read on the
        path. ``rows``: the batch's sequences, None entries masked pad
        rows (row alignment with ``token_source`` never shifts).
        ``token_source``: the previous step's [B] sampled-token device
        tensor, consumed without touching the host. ``ahead`` shifts
        positions/kv_lens by the one token the in-flight step will have
        committed by the time these inputs are read. ``window`` > 1
        queues a burst of that many chained iterations instead of one
        step (never ahead: the engine runs bursts synchronously)."""
        b = self.decode_width
        rows = list(rows)[:b]
        off = 1 if ahead else 0
        tokens = np.zeros((b,), np.int32)
        positions = np.zeros((b, 1), np.int32)
        valid = np.zeros((b, 1), bool)
        kv_lens = np.zeros((b,), np.int32)
        temperature, top_p, top_k = self._knob_arrays(b)
        page_table = np.zeros((b, self.max_pages_per_seq), np.int32)
        for i, seq in enumerate(rows):
            if seq is None:
                continue
            if token_source is None:
                tokens[i] = (seq.output_token_ids[-1]
                             if seq.output_token_ids
                             else seq.prompt_token_ids[-1])
            positions[i, 0] = seq.total_len - 1 + off
            kv_lens[i] = seq.total_len + off
            valid[i, 0] = True
            sp = seq.sampling
            temperature[i] = sp.temperature
            top_p[i] = sp.top_p
            top_k[i] = sp.top_k
            n = min(len(seq.pages), self.max_pages_per_seq)
            page_table[i, :n] = seq.pages[:n]
        payload = {
            "tokens": tokens if token_source is None else token_source,
            "positions": positions, "valid": valid,
            "page_table": page_table, "kv_lens": kv_lens,
            "last_index": np.zeros((b,), np.int32),
            "temperature": temperature, "top_p": top_p, "top_k": top_k,
        }
        if not ahead:
            # Plan-ahead eligibility excludes seeded rows (their
            # emitted index would be one token stale).
            payload.update(self._seed_payload(rows, b))
        if window > 1:
            payload.update(self._burst_payload(rows, b))
            with torch.inference_mode():
                sampled = self._burst_impl(payload, window)
            return DecodeStepHandle(rows, sampled)
        return DecodeStepHandle(rows,
                                self.execute_payload(KIND_DECODE, payload))

    def _burst_payload(self, rows, pad_to: int) -> dict:
        """Per-row lifecycle inputs of a burst: each row's token budget
        (``decode_budget``, the number the scheduler reserved pages
        for) and its stop set, -1 padded (none for ignore_eos rows)."""
        budgets = np.zeros((pad_to,), np.int32)
        stops = [[] if seq is None or seq.sampling.ignore_eos
                 else list(seq.sampling.stop_token_ids) for seq in rows]
        stop_tokens = np.full((pad_to, max([1] + [len(x) for x in stops])),
                              -1, np.int32)
        for i, seq in enumerate(rows):
            if seq is None:
                continue
            budgets[i] = decode_budget(seq,
                                       self.config.scheduler.max_model_len)
            stop_tokens[i, :len(stops[i])] = stops[i]
        return {"budgets": budgets, "stop_tokens": stop_tokens}

    def _burst_impl(self, payload: dict, window: int) -> torch.Tensor:
        """``window`` chained decode iterations with no host sync between
        them (the JAX runner's ``_decode_burst_impl`` with eager KV
        writes). The carry (last tokens, positions, kv_lens, active,
        emitted) stays on the device: each iteration writes the active
        rows' KV (a frozen row's write goes to trash page 0), attends,
        samples, and freezes rows at a stop token or their budget; a
        frozen row's position and kv_len stop advancing and its slots
        emit -1. A seeded row's emitted index at iteration k is its
        host-known start plus k. Returns the [B, window] tokens."""
        dev = self._to_device({k: payload[k] for k in (
            "tokens", "positions", "page_table", "kv_lens", "valid",
            "budgets", "stop_tokens")})
        seeding, emitted_start = {}, None
        if "seeds" in payload:
            seeding = {"seeds": torch.from_numpy(payload["seeds"]),
                       "seed_mask": torch.from_numpy(payload["seed_mask"])}
            emitted_start = payload["emitted"]
        tok = dev["tokens"][:, None]
        pos, kv_lens = dev["positions"], dev["kv_lens"]
        active = dev["valid"][:, 0]
        emitted = torch.zeros_like(kv_lens)
        out = []
        for k in range(window):
            logits = self._forward(
                self.params, self.config.model, tok, pos,
                dev["page_table"], kv_lens, active[:, None], self.k_cache,
                self.v_cache, kind="decode")
            if emitted_start is not None:
                seeding["emitted_index"] = torch.from_numpy(
                    emitted_start + k)
            step_out, sampled, emitted, nxt = burst_sample_step(
                logits[:, 0], active, emitted, dev["budgets"],
                dev["stop_tokens"], *self._knobs(payload),
                generator=self.generator, **seeding)
            step = nxt.to(pos.dtype)
            tok = torch.where(active, sampled.to(tok.dtype),
                              tok[:, 0])[:, None]
            pos = pos + step[:, None]
            kv_lens = kv_lens + step
            active = nxt
            out.append(step_out)
        return torch.stack(out, dim=1)

    def run_decode(self, plan: DecodePlan) -> List[List[int]]:
        """One synchronous decode (or, with drafts, verify) step over
        all running sequences: the async pipeline's dispatch path plus
        an immediate read, so sync and async greedy decoding share one
        code path. A plan window > 1 runs a burst: up to ``window``
        tokens a row out of one dispatch and one read, fewer for a row
        that stops or reaches its budget mid-burst."""
        if plan.drafts is not None:
            return self.dispatch_spec(plan).result()
        return self.dispatch_decode(plan.seqs[: self.decode_width],
                                    window=plan.window).result()

    # ---- speculative verify -------------------------------------------------

    def dispatch_spec(self, plan: DecodePlan) -> SpecStepHandle:
        """Build and queue ONE speculative verify step with no host read
        on the path. Every running row rides the same [B, K + 1] block
        as a ragged row with ``last_index = draft_len``: rows with a
        draft verify it, rows without decode one token. The handle's
        ``result()`` gives each row's accepted prefix plus the
        bonus/resample token (1..K + 1 tokens). The scheduler
        guarantees row eligibility and pages for total_len +
        draft_len tokens."""
        seqs = plan.seqs[: self.decode_width]
        b, s = self.decode_width, self.spec_width
        tokens = np.zeros((b, s), np.int32)
        positions = np.zeros((b, s), np.int32)
        valid = np.zeros((b, s), bool)
        kv_lens = np.zeros((b,), np.int32)
        drafts = np.full((b, s - 1), -1, np.int32)
        draft_lens = np.zeros((b,), np.int32)
        temperature, top_p, top_k = self._knob_arrays(b)
        for i, seq in enumerate(seqs):
            d = plan.drafts[i]
            n = 1 + len(d)
            tokens[i, 0] = (seq.output_token_ids[-1]
                            if seq.output_token_ids
                            else seq.prompt_token_ids[-1])
            tokens[i, 1:n] = d
            positions[i, :n] = np.arange(seq.total_len - 1,
                                         seq.total_len - 1 + n)
            valid[i, :n] = True
            kv_lens[i] = seq.total_len + len(d)
            drafts[i, :len(d)] = d
            draft_lens[i] = len(d)
            temperature[i] = seq.sampling.temperature
            top_p[i] = seq.sampling.top_p
            top_k[i] = seq.sampling.top_k
        payload = {
            "tokens": tokens, "positions": positions, "valid": valid,
            "page_table": self._page_table_rows(seqs, pad_to=b),
            "kv_lens": kv_lens,
            # A verify row's last live slot is its last draft, and its
            # sampling span starts at slot 0.
            "last_index": draft_lens.copy(),
            "drafts": drafts, "draft_lens": draft_lens,
            "temperature": temperature, "top_p": top_p, "top_k": top_k,
        }
        return SpecStepHandle(
            list(seqs), [list(plan.drafts[i]) for i in range(len(seqs))],
            self.execute_payload(KIND_SPEC, payload))

    # ---- unified ragged step ------------------------------------------------

    def run_unified(self, plan: StepPlan
                    ) -> Tuple[List[List[int]], List[Optional[int]]]:
        """Execute one mixed step: decode rows (with their drafts, if
        any) and prefill chunk rows in ONE [R, W] block. Rows are
        compact — decode rows at 0..len(seqs)-1, prefill chunk rows
        right after, pads only at the tail; R snaps to the row-bucket
        lattice, W to the prefill buckets and at least K + 1. Returns
        (decode token lists, prefill tokens): decode rows commit
        1..K + 1 tokens each (the verify contract), prefill rows one
        sampled token for last chunks (None mid-prompt)."""
        seqs = plan.decode.seqs[: self.decode_width]
        chunks = plan.prefill.chunks[: self.prefill_width]
        spec_drafts = plan.decode.drafts
        off = len(seqs)
        r = self._row_bucket_for(off + len(chunks))
        self.last_unified_rows = r
        s = self.unified_span
        w = max(self._bucket_for(max(len(c.chunk_tokens)
                                     for c in chunks)), s)
        tokens = np.zeros((r, w), np.int32)
        positions = np.zeros((r, w), np.int32)
        valid = np.zeros((r, w), bool)
        kv_lens = np.zeros((r,), np.int32)
        last_index = np.zeros((r,), np.int32)
        drafts = np.full((r, s - 1), -1, np.int32)
        draft_lens = np.zeros((r,), np.int32)
        temperature, top_p, top_k = self._knob_arrays(r)
        page_table = np.zeros((r, self.max_pages_per_seq), np.int32)

        def row(i, seq, toks, start):
            n = len(toks)
            tokens[i, :n] = toks
            positions[i, :n] = np.arange(start, start + n)
            valid[i, :n] = True
            kv_lens[i] = start + n
            last_index[i] = n - 1
            temperature[i] = seq.sampling.temperature
            top_p[i] = seq.sampling.top_p
            top_k[i] = seq.sampling.top_k
            m = min(len(seq.pages), self.max_pages_per_seq)
            page_table[i, :m] = seq.pages[:m]

        for i, seq in enumerate(seqs):
            last = (seq.output_token_ids[-1] if seq.output_token_ids
                    else seq.prompt_token_ids[-1])
            d = spec_drafts[i] if spec_drafts is not None else []
            row(i, seq, [last] + list(d), seq.total_len - 1)
            drafts[i, :len(d)] = d
            draft_lens[i] = len(d)
        for j, chunk in enumerate(chunks):
            row(off + j, chunk.seq, chunk.chunk_tokens, chunk.chunk_start)

        payload = {
            "tokens": tokens, "positions": positions, "valid": valid,
            "page_table": page_table, "kv_lens": kv_lens,
            "last_index": last_index,
            "drafts": drafts, "draft_lens": draft_lens,
            "temperature": temperature, "top_p": top_p, "top_k": top_k,
        }
        host = self.execute_payload(KIND_UNIFIED, payload).cpu().tolist()
        token_lists = [[tok for tok in host[i] if tok >= 0]
                       for i in range(len(seqs))]
        prefill_out = [host[off + j][0] if c.is_last_chunk else None
                       for j, c in enumerate(chunks)]
        return token_lists, prefill_out

    # ---- page-granular IO ---------------------------------------------------

    @staticmethod
    def _layers(caches) -> list:
        """The per-layer caches in either layout: the per_layer list
        itself, or the views of a stacked cache's layers (what is
        written through them lands in the stacked cache)."""
        if isinstance(caches, list):
            return caches
        return [caches[layer] for layer in range(caches.shape[0])]

    def read_page(self, page_id: int) -> Tuple[np.ndarray, ...]:
        """Copy one page's KV out of device memory: [L, kv, d, page_size]
        each in either layout (the JAX engine's wire shape), as f32
        numpy (numpy has no bf16; the conversion is exact). An int8
        cache gives the JAX engine's 4-tuple (k, v, k_scale, v_scale):
        int8 pages and f32 [L, kv, page_size] scales."""
        k_layers, v_layers = self._layers(self.k_cache), self._layers(
            self.v_cache)
        if self.kv_quantized:
            def leaf(caches, name):
                return torch.stack([getattr(c, name)[:, page_id]
                                    for c in caches]).cpu().numpy()
            return (leaf(k_layers, "data"), leaf(v_layers, "data"),
                    leaf(k_layers, "scale"), leaf(v_layers, "scale"))
        k = torch.stack([kc[:, page_id] for kc in k_layers])
        v = torch.stack([vc[:, page_id] for vc in v_layers])
        return k.float().cpu().numpy(), v.float().cpu().numpy()

    def write_page(self, page_id: int, k_page: np.ndarray,
                   v_page: np.ndarray,
                   k_scale: Optional[np.ndarray] = None,
                   v_scale: Optional[np.ndarray] = None) -> None:
        """Restore one page's KV into device memory, in place: what
        ``read_page`` gave (for an int8 cache, with its scales)."""
        k_layers, v_layers = self._layers(self.k_cache), self._layers(
            self.v_cache)
        if self.kv_quantized:
            if k_scale is None or v_scale is None:
                raise ValueError(
                    "a quantized cache's page restore needs "
                    "k_scale/v_scale")
            for caches, page, scale in ((k_layers, k_page, k_scale),
                                        (v_layers, v_page, v_scale)):
                data = torch.from_numpy(np.asarray(page, np.int8))
                scales = torch.from_numpy(np.asarray(scale, np.float32))
                for layer, cache in enumerate(caches):
                    cache.data[:, page_id] = data[layer].to(self.device)
                    cache.scale[:, page_id] = scales[layer].to(self.device)
            return
        k = torch.from_numpy(np.asarray(k_page, np.float32))
        v = torch.from_numpy(np.asarray(v_page, np.float32))
        for layer, (kc, vc) in enumerate(zip(k_layers, v_layers)):
            kc[:, page_id] = k[layer].to(kc.device, kc.dtype)
            vc[:, page_id] = v[layer].to(vc.device, vc.dtype)

    def _page_table_rows(self, seqs: List[Sequence],
                         pad_to: Optional[int] = None) -> np.ndarray:
        rows = pad_to or len(seqs)
        table = np.zeros((rows, self.max_pages_per_seq), np.int32)
        for i, seq in enumerate(seqs):
            n = min(len(seq.pages), self.max_pages_per_seq)
            table[i, :n] = seq.pages[:n]
        return table
