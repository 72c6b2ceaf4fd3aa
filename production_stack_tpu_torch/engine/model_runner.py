"""Model runner: owns the device state and runs each step.

The JAX engine's runner compiles a program per step kind and shape and
donates the caches through it. Here, on the card, each step is ONE CUDA
graph per (kind, bucket shape, sampler mode, option set), captured at
the key's first use and replayed from static device buffers after it
(engine/step_graphs.py; the constructor's ``cuda_graphs=False`` runs
every step eagerly instead, to compare). The KV buffers (a list of
per-layer buffers, or one stacked buffer per k/v) are allocated once
and updated in place, so their addresses are what the graphs hold. The
shapes stay the JAX engine's closed sets — prefill chunks padded to
power-of-two buckets, decode at a fixed slot width, unified [R, W]
blocks on a row-bucket lattice — so the kernels see the same shapes on
both, and the graphs are few. On the card a step runs without a graph
only when a row is seeded (its draw uses a generator built on the host
for that row); such steps are counted. The CPU has no graphs and runs
every step eagerly.

One kernel per step kind on the card, named by the runner (never
inferred from shapes): decode steps go through the decode kernel,
prefill steps through the chunked-prefill kernel, unified mixed steps
and speculative verify steps through the ragged kernel
(models/llama.dispatch_attention). The JAX runner's lowering probes
and impl ladders have no counterpart; its verify program attends
through the prefill path, the port's through the ragged kernel, whose
contract on live slots is the same. A decode burst (``decode_steps``
> 1) is K chained decode iterations with the sampled tokens and each
row's lifecycle kept on the device, one graph for the K iterations:
one host read per K tokens.

The per-row sampling options are optional inputs of a step, as in the
JAX runner: penalties, ``logit_bias``, ``min_tokens`` suppression and
the guided-JSON state ride prefill, single-step decode and burst steps
(the scheduler keeps rows that carry them out of unified, verify and
ahead steps); logprobs ride every step kind, taken from the raw logits
at the fixed width TOP_LOGPROBS_WIDTH and trimmed on the host to each
request's ``top_logprobs``. Each payload function returns {} when no row
needs its option, so a plain batch keeps its plain graph. A burst
carries the occurrence counts and the automaton state on the device.
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
from production_stack_tpu_torch.engine.step_graphs import StepGraphs
from production_stack_tpu_torch.models.registry import get_model
from production_stack_tpu_torch.ops.paged_kv_common import (
    check_kernel_shapes,
)
from production_stack_tpu_torch.ops.quant_kv import quant_cache_zeros
from production_stack_tpu_torch.ops.sampling import (
    apply_sampling_options,
    burst_sample_step,
    guided_advance,
    sample_tokens,
    sampler_mode,
    spec_verify,
    token_logprobs,
)
from production_stack_tpu_torch.utils.log import init_logger

logger = init_logger(__name__)

# The per-row sampling knobs every step takes.
KNOBS = ("temperature", "top_p", "top_k")
# The inputs of a unified or verify (ragged) step.
RAGGED_INPUTS = ("tokens", "positions", "valid", "page_table", "kv_lens",
                 "last_index", "drafts", "draft_lens")
# A burst's stop sets are padded with -1 to at least this width, and to
# a power of two, so that the stop-set width rarely makes a new key.
MIN_STOP_WIDTH = 4
# ``min_tokens`` suppresses at most this many stop ids a row on the
# device; the host's finish guard covers the rest
# (scheduler._append_token).
STOP_SET_WIDTH = 16
# Logprob alternatives computed per position: the OpenAI maximum of
# ``top_logprobs``, so one width serves every request.
TOP_LOGPROBS_WIDTH = 20
# The per-row sampling options, in the order a step graph's key names
# them, with their payload names (logprobs has no input).
OPTION_INPUTS = {
    "penalties": ("pen_counts", "pen_prompt_mask", "pen_presence",
                  "pen_frequency", "pen_repetition"),
    "bias": ("logit_bias",),
    "suppress": ("sup_ids", "sup_rem"),
    "guided": ("fsm_state",),
    "logprobs": (),
}


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


def _lp_entry(seq: Sequence, slp, tids, tlps) -> tuple:
    """One position's logprobs, trimmed to the row's request:
    ``(sampled logprob, [(token id, logprob), ...])`` with
    ``top_logprobs`` alternatives (host lists in, as ``.tolist()``
    gives them)."""
    k = min(max(seq.sampling.top_logprobs, 0), TOP_LOGPROBS_WIDTH)
    return float(slp), [(int(tids[j]), float(tlps[j])) for j in range(k)]


def _host(out):
    """A step's outputs as host lists: tokens, or (tokens, sampled
    logprobs, top ids, top logprobs). The step's one read."""
    if isinstance(out, tuple):
        return tuple(t.cpu().tolist() for t in out)
    return out.cpu().tolist()


def _row_results(rows, out) -> Tuple[List[List[int]], Optional[list]]:
    """(token lists, logprob lists or None) of a step whose outputs are
    [B, S] per row (a burst's window or a verify span), -1 where a slot
    emitted nothing; a None row (a masked slot) gets no entries, and a
    row that asked for no logprobs gets None entries."""
    host = _host(out)
    toks = host[0] if isinstance(host, tuple) else host
    tokens, lps = [], []
    for i, seq in enumerate(rows):
        keep = [j for j, t in enumerate(toks[i]) if t >= 0]
        tokens.append([toks[i][j] for j in keep])
        if isinstance(host, tuple):
            want = seq is not None and seq.sampling.logprobs
            lps.append([_lp_entry(seq, host[1][i][j], host[2][i][j],
                                 host[3][i][j]) if want else None
                        for j in keep])
    return tokens, (lps if isinstance(host, tuple) else None)


class DecodeStepHandle:
    """One dispatched-but-unread decode: a single step, or a burst of
    K iterations.

    The kernels are queued on the card's stream; ``token_source`` is
    the sampled-token CUDA tensor the NEXT step consumes without a
    host round trip (single steps only), and ``result()`` is the
    step's one read: (token lists, logprob lists or None), the JAX
    runner's form.
    """

    is_spec = False
    drafts = None

    def __init__(self, rows, sampled):
        # List[Optional[Sequence]]: None rows are plan-ahead slots
        # whose sequence was already known to finish (dispatched as
        # masked pad rows so row alignment with token_source holds).
        self.rows = rows
        # [B] for a single step; [B, K] for a burst, -1 where a row
        # was frozen. With logprobs, a tuple of that, the sampled
        # logprobs ([B] or [B, K]), top ids and top logprobs ([..., 20]).
        self.sampled = sampled
        # Set on the assume-one-token successor of a verify step: per
        # row, the total_len that assumption predicts. The engine
        # drops the rows whose verify committed more (their sample
        # came from incomplete context).
        self.expected_lens: Optional[List[Optional[int]]] = None

    @property
    def token_source(self) -> torch.Tensor:
        """The [B] sampled-token device tensor (async feed-forward)."""
        return (self.sampled[0] if isinstance(self.sampled, tuple)
                else self.sampled)

    def result(self) -> Tuple[List[List[int]], Optional[list]]:
        if self.token_source.dim() == 2:
            return _row_results(self.rows, self.sampled)
        one = (tuple(t[:, None] for t in self.sampled)
               if isinstance(self.sampled, tuple) else self.sampled[:, None])
        return _row_results(self.rows, one)


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
    step's one read, as ``DecodeStepHandle.result``.
    """

    is_spec = True
    # A verify step is never dispatched behind an unread verify step
    # (the engine breaks the pipeline instead).
    expected_lens = None

    def __init__(self, rows, drafts, sampled):
        self.rows = rows  # List[Sequence], no None slots
        self.drafts = drafts  # per-row draft lists, parallel to rows
        # [B, K + 1], -1 past each row's tokens; with logprobs a tuple
        # as in DecodeStepHandle, per span position.
        self.sampled = sampled

    @property
    def token_source(self) -> torch.Tensor:
        out = (self.sampled[0] if isinstance(self.sampled, tuple)
               else self.sampled)
        return out[:, 0]

    def result(self) -> Tuple[List[List[int]], Optional[list]]:
        return _row_results(self.rows, self.sampled)


class ModelRunner:
    """``cuda_graphs``: on the card, run each step as a CUDA graph per
    key (``StepGraphs``); False runs every step eagerly, to compare
    with. The CPU always runs eagerly."""

    def __init__(self, config: EngineConfig, params=None, device=None,
                 cuda_graphs: bool = True):
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
        self.graphs: Optional[StepGraphs] = (
            StepGraphs(self.device, generators=[self.generator])
            if cuda_graphs and self.device.type == "cuda" else None)
        # The guided-decoding automaton's tables on the device
        # (set_guided_tables), or None: no guided row is served.
        self._guided_trans: Optional[torch.Tensor] = None
        self._guided_mask: Optional[torch.Tensor] = None
        # (key, matrix) of the last logit-bias payload (_bias_payload).
        self._bias_cache = None

    def set_guided_tables(self, fsm) -> None:
        """Upload the guided-decoding automaton's tables
        (engine/guided.py) once. The steps read them at these fixed
        addresses: each gathers mask[state] rows, and a burst advances
        state = transition[state, token] on the device."""
        self._guided_trans = torch.from_numpy(fsm.transition).to(
            self.device)
        self._guided_mask = torch.from_numpy(fsm.mask).to(self.device)

    # ---- steps --------------------------------------------------------------

    def _to_device(self, arrays: dict) -> dict:
        return {name: torch.from_numpy(arr).to(self.device,
                                               non_blocking=True)
                for name, arr in arrays.items()}

    def _dispatch(self, kind: str, shape: Tuple[int, ...], payload: dict,
                  names: Tuple[str, ...], body,
                  token_source: Optional[torch.Tensor] = None,
                  options: Tuple[str, ...] = ()):
        """Run one step: ``body(inputs, mode)`` maps the payload's
        ``names`` and sampling knobs, as tensors, to the step's output
        (the sampled tokens, or with logprobs a tuple); ``mode`` is the
        sampler's host branch, read from the numpy knobs; ``options``
        the per-row options the step carries, whose inputs
        (OPTION_INPUTS) join ``names``. ``token_source`` (a device
        tensor) replaces the tokens. On the card the step replays its
        (kind, shape, mode, options) graph, captured at the key's first
        use; it runs eagerly on the CPU, and on the card only when a
        row is seeded (counted)."""
        mode = sampler_mode(*(payload[k] for k in KNOBS))
        names = names + tuple(n for o in options for n in OPTION_INPUTS[o])
        with torch.inference_mode():
            if self.graphs is not None and "seeds" not in payload:
                return self.graphs.run(
                    kind, shape, mode,
                    {k: payload[k] for k in names + KNOBS},
                    lambda inputs: body(inputs, mode),
                    token_source=token_source, options=options)
            if self.graphs is not None:
                self.graphs.count_eager("seeded")
            inputs = self._to_device({k: payload[k] for k in names})
            if token_source is not None:
                inputs["tokens"] = token_source
            # The knobs stay on the host: the sampler moves what it
            # needs.
            inputs.update({k: torch.from_numpy(payload[k]) for k in KNOBS})
            return body(inputs, mode)

    @staticmethod
    def _seeding(payload: dict) -> dict:
        """A seeded step's per-row seeds, as the sampler takes them (CPU
        tensors), or {}."""
        if "seeds" not in payload:
            return {}
        return {name: torch.from_numpy(payload[name])
                for name in ("seeds", "emitted", "seed_mask")}

    def _sample_rows(self, logits: torch.Tensor, dev: dict, mode: str,
                     options: Tuple[str, ...],
                     seeding: Optional[dict] = None):
        """Sample one token a row from [B, vocab] raw logits through the
        option chain; with logprobs, a tuple (tokens, sampled logprobs,
        top ids, top logprobs) from the raw logits."""
        sampled = sample_tokens(
            apply_sampling_options(logits, dev,
                                   guided_mask=self._guided_mask),
            dev["temperature"], dev["top_p"], dev["top_k"],
            generator=self.generator, mode=mode, **(seeding or {}))
        if "logprobs" in options:
            return (sampled,) + token_logprobs(logits, sampled,
                                               TOP_LOGPROBS_WIDTH)
        return sampled

    def _step_body(self, dev: dict, mode: str, kind: str,
                   options: Tuple[str, ...] = (),
                   seeding: Optional[dict] = None):
        """Prefill (``kind`` "prefill": sample each row's last prompt
        position, ``last_index``) or single-step decode ("decode": T ==
        1). Returns the [B] sampled tokens (a tuple with logprobs)."""
        tokens = dev["tokens"]
        if tokens.dim() == 1:
            # Decode feeds [B] tokens so an ahead dispatch can consume
            # the previous step's [B] sampled tensor verbatim.
            tokens = tokens[:, None]
        positions = dev["positions"].reshape(tokens.shape)
        valid = dev["valid"].reshape(tokens.shape)
        select = (dev["last_index"].long()[:, None]
                  if kind == "prefill" else None)
        logits = self._forward(
            self.params, self.config.model, tokens, positions,
            dev["page_table"], dev["kv_lens"], valid, self.k_cache,
            self.v_cache, select=select, kind=kind)
        return self._sample_rows(logits[:, 0], dev, mode, options, seeding)

    def _unified_body(self, dev: dict, mode: str,
                      options: Tuple[str, ...] = ()):
        """One ragged [R, W] step through the ragged kernel: decode
        rows occupy their first 1 + draft_len slots ([last committed,
        d_1 .. d_k] at total_len - 1 ..), prefill chunk rows up to W
        slots, pad slots are masked by ``valid``. A verify step is the
        same block with decode rows only. Sampling goes through the
        verify rule over each row's span ``logits[i, last_index_i -
        draft_lens_i + j]``; a draft-free row's span is its last real
        position, and at temperature 0 the rule is the plain argmax.
        Returns the [R, span] sampled tokens; with logprobs a tuple
        with each span position's raw-logit logprobs.

        Rejected drafts need no rollback on the card: their KV lies
        past the committed length in the row's own pages, causally
        invisible until the next step overwrites it."""
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
        out = spec_verify(span, dev["drafts"], dev["draft_lens"],
                          dev["temperature"], dev["top_p"], dev["top_k"],
                          generator=self.generator, mode=mode)
        if "logprobs" not in options:
            return out
        # Positions past a row's emitted count are dropped on the host.
        r, _, v = span.shape
        lp = token_logprobs(span.reshape(r * s, v),
                            torch.clamp(out, min=0).reshape(r * s),
                            TOP_LOGPROBS_WIDTH)
        return (out,) + tuple(x.reshape((r, s) + x.shape[1:]) for x in lp)

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

    # ---- per-row sampling options -------------------------------------------

    def _penalty_payload(self, seqs: "List[Optional[Sequence]]",
                         pad_to: int) -> dict:
        """Per-row penalty inputs, or {} when no row needs them: [B,
        vocab] output-token counts and prompt-token mask, and the three
        [B] penalties (no-op defaults for None rows and rows without
        penalties)."""
        if not any(s is not None and s.sampling.needs_penalties
                   for s in seqs):
            return {}
        v = self.config.model.vocab_size
        counts = np.zeros((pad_to, v), np.int32)
        pmask = np.zeros((pad_to, v), bool)
        presence = np.zeros((pad_to,), np.float32)
        frequency = np.zeros((pad_to,), np.float32)
        repetition = np.ones((pad_to,), np.float32)
        for i, seq in enumerate(seqs):
            if seq is None:
                continue
            sp = seq.sampling
            presence[i] = sp.presence_penalty
            frequency[i] = sp.frequency_penalty
            repetition[i] = sp.repetition_penalty
            if sp.needs_penalties:
                if seq.output_token_ids:
                    np.add.at(counts[i], np.asarray(seq.output_token_ids,
                                                    np.int64), 1)
                pmask[i, np.asarray(seq.prompt_token_ids, np.int64)] = True
        return {"pen_counts": counts, "pen_prompt_mask": pmask,
                "pen_presence": presence, "pen_frequency": frequency,
                "pen_repetition": repetition}

    def _bias_payload(self, seqs: "List[Optional[Sequence]]",
                      pad_to: int) -> dict:
        """The per-row [B, vocab] logit-bias matrix, or {} when no row
        uses one. It is constant while the rows and their biases are,
        so the last one is kept and reused (by row sequence and bias)."""
        if not any(s is not None and s.sampling.logit_bias for s in seqs):
            return {}
        key = (pad_to, tuple(
            (s.seq_id, tuple(sorted(s.sampling.logit_bias.items())))
            if s is not None and s.sampling.logit_bias else None
            for s in seqs))
        if self._bias_cache is not None and self._bias_cache[0] == key:
            return {"logit_bias": self._bias_cache[1]}
        v = self.config.model.vocab_size
        bias = np.zeros((pad_to, v), np.float32)
        for i, seq in enumerate(seqs):
            if seq is None or not seq.sampling.logit_bias:
                continue
            for tid, b in seq.sampling.logit_bias.items():
                # The server refuses ids outside the vocabulary; direct
                # callers' are dropped here.
                if 0 <= int(tid) < v:
                    bias[i, int(tid)] = float(b)
        self._bias_cache = (key, bias)
        return {"logit_bias": bias}

    def _suppress_payload(self, seqs: "List[Optional[Sequence]]",
                          pad_to: int) -> dict:
        """``min_tokens`` inputs, or {} when no row is under its
        minimum: each row's stop ids (EOS included; -1 padded to
        STOP_SET_WIDTH) and the tokens it must still emit before a stop
        may be generated."""
        if not any(s is not None and s.sampling.min_tokens > s.num_generated
                   for s in seqs):
            return {}
        ids = np.full((pad_to, STOP_SET_WIDTH), -1, np.int32)
        rem = np.zeros((pad_to,), np.int32)
        for i, seq in enumerate(seqs):
            if seq is None:
                continue
            r = seq.sampling.min_tokens - seq.num_generated
            if r <= 0:
                continue
            rem[i] = r
            sids = seq.sampling.stop_token_ids[:STOP_SET_WIDTH]
            ids[i, :len(sids)] = sids
        return {"sup_ids": ids, "sup_rem": rem}

    def _guided_payload(self, seqs: "List[Optional[Sequence]]",
                        pad_to: int) -> dict:
        """Per-row automaton states ([B], -1 = unconstrained), or {}
        when no row is guided."""
        if not any(s is not None and s.fsm_state is not None for s in seqs):
            return {}
        state = np.full((pad_to,), -1, np.int32)
        for i, seq in enumerate(seqs):
            if seq is not None and seq.fsm_state is not None:
                state[i] = seq.fsm_state
        return {"fsm_state": state}

    def _options_payload(self, seqs: "List[Optional[Sequence]]",
                         pad_to: int, row_inputs: bool = True
                         ) -> Tuple[dict, Tuple[str, ...]]:
        """The step's per-row option inputs and its option set (the
        order of OPTION_INPUTS). ``row_inputs`` False (unified, verify
        and ahead steps, whose rows the scheduler keeps free of them)
        leaves only logprobs."""
        payload = {}
        if row_inputs:
            payload.update(self._penalty_payload(seqs, pad_to))
            payload.update(self._bias_payload(seqs, pad_to))
            payload.update(self._suppress_payload(seqs, pad_to))
            payload.update(self._guided_payload(seqs, pad_to))
        options = tuple(o for o, names in OPTION_INPUTS.items()
                        if names and names[0] in payload)
        if any(s is not None and s.sampling.logprobs for s in seqs):
            options += ("logprobs",)
        return payload, options

    # ---- prefill ------------------------------------------------------------

    def run_prefill(self, plan: PrefillPlan
                    ) -> Tuple[List[Optional[int]], Optional[list]]:
        """Execute one batched prefill step (the next chunk of up to
        ``prefill_batch_size`` distinct sequences, rows padded to the
        fixed width). Returns (tokens, logprobs): one sampled token per
        chunk — None for rows whose prompt is not yet fully prefilled —
        and, when a sampling row asked for logprobs, each row's entry
        (else None)."""
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
        # Only rows whose LAST chunk is in this step keep their sample:
        # the others carry no options.
        sampling_rows = [c.seq if c.is_last_chunk else None for c in chunks]
        payload.update(self._seed_payload(sampling_rows, b))
        opts, options = self._options_payload(sampling_rows, b)
        payload.update(opts)
        seeding = self._seeding(payload)
        sampled = self._dispatch(
            "step", (b, t), payload, ("tokens", "positions", "valid",
                                      "page_table", "kv_lens",
                                      "last_index"),
            lambda dev, mode: self._step_body(dev, mode, "prefill",
                                              options, seeding),
            options=options)
        if not any(c.is_last_chunk for c in chunks):
            return [None] * len(chunks), None
        toks, lps = DecodeStepHandle(sampling_rows, sampled).result()
        return ([tk[0] if c.is_last_chunk else None
                 for tk, c in zip(toks, chunks)],
                None if lps is None else
                [lp[0] if c.is_last_chunk else None
                 for lp, c in zip(lps, chunks)])

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
        committed by the time these inputs are read; its rows carry no
        per-row option inputs but logprobs (the scheduler's plan-ahead
        eligibility). ``window`` > 1 queues a burst of that many chained
        iterations instead of one step (never ahead: the engine runs
        bursts synchronously)."""
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
            "tokens": tokens, "positions": positions, "valid": valid,
            "page_table": page_table, "kv_lens": kv_lens,
            "temperature": temperature, "top_p": top_p, "top_k": top_k,
        }
        if not ahead:
            # Plan-ahead eligibility excludes seeded rows (their
            # emitted index would be one token stale).
            payload.update(self._seed_payload(rows, b))
        opts, options = self._options_payload(rows, b, row_inputs=not ahead)
        payload.update(opts)
        names = ("tokens", "positions", "valid", "page_table", "kv_lens")
        if window > 1:
            payload.update(self._burst_payload(rows, b))
            seeding = self._seeding(payload)
            sampled = self._dispatch(
                "decode_burst", (b, window, payload["stop_tokens"].shape[1]),
                payload, names + ("budgets", "stop_tokens"),
                lambda dev, mode: self._burst_body(dev, mode, window,
                                                   options, seeding),
                options=options)
            return DecodeStepHandle(rows, sampled)
        seeding = self._seeding(payload)
        return DecodeStepHandle(rows, self._dispatch(
            "step", (b, 1), payload, names,
            lambda dev, mode: self._step_body(dev, mode, "decode", options,
                                              seeding),
            token_source=token_source, options=options))

    def _burst_payload(self, rows, pad_to: int) -> dict:
        """Per-row lifecycle inputs of a burst: each row's token budget
        (``decode_budget``, the number the scheduler reserved pages
        for) and its stop set, -1 padded (none for ignore_eos rows) to
        a power of two of at least MIN_STOP_WIDTH entries."""
        budgets = np.zeros((pad_to,), np.int32)
        stops = [[] if seq is None or seq.sampling.ignore_eos
                 else list(seq.sampling.stop_token_ids) for seq in rows]
        width = MIN_STOP_WIDTH
        while width < max([0] + [len(x) for x in stops]):
            width *= 2
        stop_tokens = np.full((pad_to, width), -1, np.int32)
        for i, seq in enumerate(rows):
            if seq is None:
                continue
            budgets[i] = decode_budget(seq,
                                       self.config.scheduler.max_model_len)
            stop_tokens[i, :len(stops[i])] = stops[i]
        return {"budgets": budgets, "stop_tokens": stop_tokens}

    def _burst_body(self, dev: dict, mode: str, window: int,
                    options: Tuple[str, ...] = (),
                    seeding: Optional[dict] = None):
        """``window`` chained decode iterations with no host sync between
        them (the JAX runner's ``_decode_burst_impl`` with eager KV
        writes). The carry (last tokens, positions, kv_lens, active,
        emitted, and with those options the occurrence counts and the
        automaton states) stays on the device: each iteration writes
        the active rows' KV (a frozen row's write goes to trash page 0),
        attends, applies the option chain (``min_tokens`` against the
        burst's own ``emitted``), samples, and freezes rows at a stop
        token or their budget; a frozen row's position and kv_len stop
        advancing and its slots emit -1. A seeded row's emitted index
        at iteration k is its host-known start plus k. Returns the [B,
        window] tokens; with logprobs a tuple with the [B, window]
        sampled logprobs and [B, window, 20] top ids and logprobs."""
        seeding = dict(seeding or {})
        emitted_start = seeding.pop("emitted", None)
        tok = dev["tokens"][:, None]
        pos, kv_lens = dev["positions"], dev["kv_lens"]
        active = dev["valid"][:, 0]
        emitted = torch.zeros_like(kv_lens)
        counts = dev.get("pen_counts")
        state = dev.get("fsm_state")
        outs = []
        for k in range(window):
            logits = self._forward(
                self.params, self.config.model, tok, pos,
                dev["page_table"], kv_lens, active[:, None], self.k_cache,
                self.v_cache, kind="decode")[:, 0]
            if emitted_start is not None:
                seeding["emitted_index"] = emitted_start + k
            step_out, sampled, emitted_next, nxt = burst_sample_step(
                apply_sampling_options(logits, dev, counts=counts,
                                       emitted=emitted, state=state,
                                       guided_mask=self._guided_mask),
                active, emitted, dev["budgets"],
                dev["stop_tokens"], dev["temperature"], dev["top_p"],
                dev["top_k"], generator=self.generator, mode=mode,
                **seeding)
            if "logprobs" in options:
                outs.append((step_out,) + token_logprobs(
                    logits, sampled, TOP_LOGPROBS_WIDTH))
            else:
                outs.append((step_out,))
            if counts is not None:
                # Later iterations penalize the tokens this burst drew.
                counts = counts.scatter_add(
                    1, sampled[:, None], active.to(counts.dtype)[:, None])
            if state is not None:
                state = guided_advance(state, sampled, active,
                                       self._guided_trans)
            step = nxt.to(pos.dtype)
            tok = torch.where(active, sampled.to(tok.dtype),
                              tok[:, 0])[:, None]
            pos = pos + step[:, None]
            kv_lens = kv_lens + step
            active = nxt
            emitted = emitted_next
        stacked = tuple(torch.stack(x, dim=1) for x in zip(*outs))
        return stacked if len(stacked) > 1 else stacked[0]

    def run_decode(self, plan: DecodePlan
                   ) -> Tuple[List[List[int]], Optional[list]]:
        """One synchronous decode (or, with drafts, verify) step over
        all running sequences: the async pipeline's dispatch path plus
        an immediate read, so sync and async greedy decoding share one
        code path. A plan window > 1 runs a burst: up to ``window``
        tokens a row out of one dispatch and one read, fewer for a row
        that stops or reaches its budget mid-burst. Returns (token
        lists, logprob lists or None)."""
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
        _, options = self._options_payload(seqs, b, row_inputs=False)
        return SpecStepHandle(
            list(seqs), [list(plan.drafts[i]) for i in range(len(seqs))],
            self._dispatch(
                "spec_verify", (b, s), payload, RAGGED_INPUTS,
                lambda dev, mode: self._unified_body(dev, mode, options),
                options=options))

    # ---- unified ragged step ------------------------------------------------

    def run_unified(self, plan: StepPlan
                    ) -> Tuple[List[List[int]], Optional[list],
                               List[Optional[int]], Optional[list]]:
        """Execute one mixed step: decode rows (with their drafts, if
        any) and prefill chunk rows in ONE [R, W] block. Rows are
        compact — decode rows at 0..len(seqs)-1, prefill chunk rows
        right after, pads only at the tail; R snaps to the row-bucket
        lattice, W to the prefill buckets and at least K + 1. Returns
        (decode token lists, their logprob lists, prefill tokens, their
        logprobs), the logprobs None unless a sampling row asked:
        decode rows commit 1..K + 1 tokens each (the verify contract),
        prefill rows one sampled token for last chunks (None
        mid-prompt)."""
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
        rows = list(seqs) + [c.seq if c.is_last_chunk else None
                             for c in chunks]
        _, options = self._options_payload(rows, r, row_inputs=False)
        toks, lps = _row_results(rows, self._dispatch(
            "unified", (r, w), payload, RAGGED_INPUTS,
            lambda dev, mode: self._unified_body(dev, mode, options),
            options=options))
        prefill_out = [toks[off + j][0] if c.is_last_chunk else None
                       for j, c in enumerate(chunks)]
        prefill_lps = (None if lps is None else
                       [lps[off + j][0] if c.is_last_chunk else None
                        for j, c in enumerate(chunks)])
        return (toks[:off], None if lps is None else lps[:off],
                prefill_out, prefill_lps)

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
