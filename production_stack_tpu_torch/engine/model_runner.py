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

Weight-only int8 (``ModelConfig.quantization``): the projections are
``QuantLinear``s, made directly as int8 when the runner draws random
weights (``init_random_quantized``) or quantized from the given dense
ones; decode-sized products run the int8-weight kernel. Multi-LoRA
(``config.lora``): the adapter stacks (``engine/lora.LoRARegistry``)
are allocated once on the device, and with LoRA on every step kind
takes one more input, ``lora_ids`` (each row's adapter slot, 0 for the
base model and pad rows), a static input of the step graphs and never
part of a key.

Tensor parallelism (``tp``, a ``parallel/collectives`` group): the
runner holds its rank's shard of the weights (``parallel/mesh``: cut
from the full set after any int8 quantization, as JAX quantizes before
it places), the rank's kv heads of the cache and adapter stacks of the
rank's widths; the forward closes its row-parallel products with
all-reduces and gathers the logits, so every rank samples from the same
full logits with a generator seeded alike and draws the same tokens
(no broadcast of the sampled tokens: the async pipeline's feed-forward
and a burst's chained iterations stay on each rank's card). Rank 0
owns the scheduler; with a step bridge attached (``attach_bridge``,
parallel/distributed.py) every dispatch publishes its host payload and
a description of its body first, and ranks 1..N-1 replay it through
``execute``. A gloo group cannot run inside the step graphs: such a
runner must be built with ``cuda_graphs=False`` on the card.

Pipeline and context parallelism (``pp``, ``sp``: the rank's groups
along those axes, parallel/collectives.py). Under pp the runner holds
its stage: L/S layers of its tp shard (made alone: parallel/mesh.py),
those layers of the stacked cache and of the adapter stacks, and runs
every step through ``parallel/pipeline_serving.pp_paged_forward``
instead of the model's forward; a page is joined from the stages' layer
slices (and the tp ranks' heads) on read and cut the same way on write.
Under sp every rank holds the whole tp-cut model and a replica of the
cache; a cold prompt of at least the scheduler's threshold prefills in
ONE dispatch (``run_sp_prefill``: ring attention over the sp ranks,
parallel/context_serving.py), always eagerly (counted as reason
``sp_prefill``: its T buckets reach the model's length); a unified or
verify block splits its rows over the sp ranks (``shard_rows_forward``:
R padded to an sp multiple, the live slots' K/V shared, the span's
logits gathered; counted in ``sp_split_rows``), every other step runs
replicated on each rank, and a page write goes to every replica. Both
force the stacked cache layout (``cache_layout`` auto
resolves stacked, per_layer is refused: JAX's rule), and both ride the
step bridge as tp does; the JAX runner's refusals are ``check_parallel``.

Deferred KV writes (``SchedulerConfig.deferred_kv_writes``; the JAX
runner's ``_decode_burst_deferred_impl``): a burst keeps each layer's
new K/V in dense [B, K, kv, d] tails in the model dtype, attends over
the pages and the tail through the decode kernel's tail form, and
flushes the tails to the pages once, at the end of the burst, through
``write_to_pages``; the pages hold the pre-burst tokens throughout, so
the cached-token count stays ``positions[:, 0]``.

``PSTPU_TIMING`` (read as the JAX runner reads it): each dispatch is
clocked by kind, as in JAX ("prefill", "decode" with t the burst's
window, "spec", "unified"), from its launch to the read of its sampled
tokens, logged as ``timing <kind> t=<n> <s>`` and folded into the
observatory (``/debug/compiles``' ``timings``). No sync is added: an
async step's clock stops where the engine reads its result, and a
prefill chunk whose token nobody reads (not its prompt's last) stops at
its dispatch's return, its card time then landing in the next read.
Unset, no clock is read.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.lora import LoRARegistry
from production_stack_tpu_torch.engine.quantization import (
    has_quantized_leaves,
    init_random_quantized,
    quantize_params,
)
from production_stack_tpu_torch.engine.scheduler import (
    DecodePlan,
    PrefillPlan,
    StepPlan,
)
from production_stack_tpu_torch.engine.sequence import (
    Sequence,
    decode_budget,
)
from production_stack_tpu_torch.engine.perf_observatory import (
    PerfObservatory,
)
from production_stack_tpu_torch.engine.step_graphs import (
    SP_PREFILL,
    STEP_KINDS,
    StepGraphs,
)
from production_stack_tpu_torch.models import llama
from production_stack_tpu_torch.models.registry import get_model
from production_stack_tpu_torch.ops.attention import write_to_pages
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
from production_stack_tpu_torch.parallel import mesh
from production_stack_tpu_torch.parallel.context_serving import (
    share_slots,
    shard_rows_forward,
    sp_prefill_forward,
)
from production_stack_tpu_torch.parallel.pipeline_serving import (
    pp_encode,
    pp_paged_forward,
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
    # Not a row option: the key mark of a burst with deferred KV writes
    # (its tails are buffers of its own graph).
    "deferred": (),
}


# PSTPU_TIMING=1: log each dispatch's wall (its launch to the read of
# its sampled tokens) as "timing <kind> t=<window|bucket> <seconds>" and
# fold it into the observatory by kind.
_TIMING = (os.environ.get("PSTPU_TIMING", "0").strip().lower()
           in ("1", "true", "yes", "on"))


def _timing_log(kind: str, t: int, wall: float) -> None:
    logger.info("timing %s t=%d %.4f", kind, t, wall)


# Model families served by the deferred-KV-write burst (the kv_tail
# path of models/llama.py, which also serves mistral and qwen2).
DEFERRED_KV_FAMILIES = ("llama", "mistral", "qwen2")


def deferred_kv_eligible(architecture: str, decode_steps: int,
                         attention_impl: str, pipeline_parallel: int = 1,
                         context_parallel: int = 1,
                         speculative_k: int = 0) -> bool:
    """The one eligibility predicate for deferred KV writes, the JAX
    runner's, arguments and all: the runner's guard (an explicit
    ineligible 'on' raises) and the server's ``--deferred-kv-writes
    auto`` both read it. Speculative decoding excludes deferral (the
    verify step writes draft KV eagerly so later drafts attend to
    earlier ones). On the card ``auto`` attention is the decode
    kernel, whose tail form reads the burst's tail."""
    return (decode_steps > 1
            and architecture in DEFERRED_KV_FAMILIES
            and attention_impl in ("xla", "auto")
            and pipeline_parallel == 1
            and context_parallel == 1
            and speculative_k == 0)


def check_deferred_kv(config: EngineConfig) -> None:
    """The JAX runner's refusals of an explicit deferred_kv_writes the
    runner cannot serve (engine/model_runner.py, the ``_deferred``
    guard)."""
    model = config.model
    if config.scheduler.decode_steps <= 1:
        raise ValueError(
            "deferred_kv_writes needs decode_steps > 1 (the tail "
            "flushes once per multi-step burst)")
    if model.architecture not in DEFERRED_KV_FAMILIES:
        raise NotImplementedError(
            "deferred_kv_writes serves the llama family (got "
            f"{model.architecture!r})")
    if model.attention_impl not in ("xla", "auto"):
        raise NotImplementedError(
            "deferred_kv_writes reads the burst tail through the auto "
            f"decode path (decode impl {model.attention_impl!r})")


def check_parallel(config: EngineConfig) -> None:
    """The JAX runner's refusals of a pipeline- or context-parallel
    engine it cannot serve, with its messages
    (engine/model_runner.py), after ``cache_layout`` auto resolved."""
    model, par = config.model, config.parallel
    pp, cp, tp = (par.pipeline_parallel_size, par.context_parallel_size,
                  par.tensor_parallel_size)
    heads_split = tp > 1 and (model.num_key_value_heads % tp
                              or model.num_attention_heads % tp)
    if pp > 1:
        from production_stack_tpu_torch.parallel.pipeline_serving import (
            PP_FAMILIES,
        )
        if model.architecture not in PP_FAMILIES:
            raise NotImplementedError(
                f"pipeline parallelism serves {'/'.join(PP_FAMILIES)} "
                f"(got {model.architecture!r})")
        if model.num_hidden_layers % pp:
            raise ValueError(
                f"layers {model.num_hidden_layers} must divide by "
                f"pipeline_parallel_size {pp}")
        if heads_split:
            raise ValueError(
                "pp x tp needs attention/kv heads divisible by "
                f"tensor_parallel_size {tp}")
    if cp > 1:
        from production_stack_tpu_torch.parallel.context_serving import (
            SP_FAMILIES,
        )
        if model.architecture not in SP_FAMILIES:
            raise NotImplementedError(
                f"context parallelism serves {'/'.join(SP_FAMILIES)} "
                f"(got {model.architecture!r})")
        if pp > 1:
            raise NotImplementedError(
                "context parallelism with pipeline parallelism (sp "
                "composes with tp; pp shards the layer axis the sp "
                "prefill walks in full)")
        if heads_split:
            raise ValueError(
                "sp x tp needs attention/kv heads divisible by "
                f"tensor_parallel_size {tp}")
    if config.scheduler.deferred_kv_writes and (pp > 1 or cp > 1):
        if config.scheduler.decode_steps <= 1:
            raise ValueError(
                "deferred_kv_writes needs decode_steps > 1 (the tail "
                "flushes once per multi-step burst)")
        raise NotImplementedError(
            "deferred_kv_writes with pipeline/context parallelism (the "
            "pp/sp runners use their own burst bodies)")
    if config.cache.cache_layout == "per_layer" and (pp > 1 or cp > 1):
        raise NotImplementedError(
            "cache_layout='per_layer' with pipeline/context parallelism "
            "(pp shards the stacked L axis; use the stacked layout)")


def _check_group(group, size: int, axis: str, flag: str) -> None:
    got = 1 if group is None else group.size
    if got != size:
        raise ValueError(
            f"{flag} {size} needs the rank's {axis} group of that size "
            f"(got {got}; parallel/distributed.start_parallel makes the "
            "ranks)")


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


def check_engine_geometry(config: EngineConfig) -> None:
    """On the card: raise, naming the rule it breaks, unless the
    kernels serve the model's geometry with the cache's dtype
    (``kernel_geometry_supported``: bf16, f16 or f32 over the same type
    or int8, any query group, any head_dim of 1 or more: up to 256
    padded in the kernel to its tile of 32, 64, 80, 128 or 256, above
    256 as slabs of 128 (``kernel_head_dim_slabs``); and
    ``kernel_page_size_supported``: any page of 1 token or more), then
    build (or find) and load the kernel library and hold it to the same
    answers.
    The card never serves through the plain versions."""
    model = config.model
    check_kernel_shapes(
        model.num_attention_heads, model.num_key_value_heads,
        model.head_dim, config.cache.page_size, model.torch_dtype,
        torch.int8 if config.cache.resolved_kv_dtype() == "int8"
        else model.torch_dtype)


def unified_step_eligible(engine_role: str = "both",
                          distributed: bool = False) -> bool:
    """The eligibility rule of the unified ragged step, the JAX
    runner's: out for a disaggregated role engine, which by
    construction never holds prefill and decode work at once, and for a
    multi-host (``distributed``) server, as in JAX (the server's
    ``--unified-step auto`` resolves through it)."""
    return engine_role == "both" and not distributed


def async_scheduling_eligible(decode_steps: int, speculative_k: int,
                              distributed: bool = False) -> bool:
    """The eligibility rule of the async pipeline, the JAX runner's:
    single-step decode (a burst already amortizes the host round trip,
    a verify step's commit count is data-dependent) on one host (the
    server's ``--async-scheduling auto`` resolves through it; a
    prefill-role server resolves it off besides)."""
    return decode_steps == 1 and speculative_k == 0 and not distributed


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

    def __init__(self, rows, sampled, clock=None):
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
        # PSTPU_TIMING: the runner's clock of this dispatch
        # (ModelRunner._clock), stopped by the step's one read.
        self.clock = clock

    @property
    def token_source(self) -> torch.Tensor:
        """The [B] sampled-token device tensor (async feed-forward)."""
        return (self.sampled[0] if isinstance(self.sampled, tuple)
                else self.sampled)

    def result(self) -> Tuple[List[List[int]], Optional[list]]:
        if self.token_source.dim() == 2:
            out = _row_results(self.rows, self.sampled)
        else:
            one = (tuple(t[:, None] for t in self.sampled)
                   if isinstance(self.sampled, tuple)
                   else self.sampled[:, None])
            out = _row_results(self.rows, one)
        _stop(self)
        return out


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

    def __init__(self, rows, drafts, sampled, clock=None):
        self.rows = rows  # List[Sequence], no None slots
        self.drafts = drafts  # per-row draft lists, parallel to rows
        # [B, K + 1], -1 past each row's tokens; with logprobs a tuple
        # as in DecodeStepHandle, per span position.
        self.sampled = sampled
        self.clock = clock

    @property
    def token_source(self) -> torch.Tensor:
        out = (self.sampled[0] if isinstance(self.sampled, tuple)
               else self.sampled)
        return out[:, 0]

    def result(self) -> Tuple[List[List[int]], Optional[list]]:
        out = _row_results(self.rows, self.sampled)
        _stop(self)
        return out


def _stop(handle) -> None:
    """Stop a handle's PSTPU_TIMING clock, once, after its read."""
    if handle.clock is not None:
        handle.clock()
        handle.clock = None


class ModelRunner:
    """``cuda_graphs``: on the card, run each step as a CUDA graph per
    key (``StepGraphs``); False runs every step eagerly, to compare
    with. The CPU always runs eagerly."""

    def __init__(self, config: EngineConfig, params=None, device=None,
                 cuda_graphs: bool = True, tp=None, pp=None, sp=None):
        self.config = config
        self.device = resolve_device(device)
        model_config = config.model
        par = config.parallel
        if config.cache.cache_layout == "auto":
            # The JAX engine's rule: stacked for pipeline or context
            # parallelism (pp cuts the stacked L axis, the sp prefill
            # writes it whole), per_layer otherwise.
            config.cache.cache_layout = (
                "stacked" if (par.pipeline_parallel_size > 1
                              or par.context_parallel_size > 1)
                else "per_layer")
        check_parallel(config)
        _check_group(pp, par.pipeline_parallel_size, "pp",
                     "pipeline_parallel_size")
        _check_group(sp, par.context_parallel_size, "sp",
                     "context_parallel_size")
        # Tensor parallelism: this rank's group (None: one device);
        # pipeline and context parallelism: its pp and sp groups. The
        # config of the rank's shard (its heads; a stage's layer
        # count) is what the forward reads.
        self.tp, self.pp, self.sp = tp, pp, sp
        tp_size = 1 if tp is None else tp.size
        self.layers = (None if pp is None else mesh.stage_layers(
            model_config.num_hidden_layers, pp.rank, pp.size))
        self.shard_config = mesh.stage_model_config(
            model_config, tp_size, *((pp.rank, pp.size) if pp else ()))
        self._fwd_args = {} if tp is None else {"tp": tp}
        groups = [g for g in (tp, pp, sp) if g is not None]
        if (any(not g.capturable for g in groups) and cuda_graphs
                and self.device.type == "cuda"):
            backend = next(g.backend for g in groups if not g.capturable)
            raise ValueError(
                f"a {backend} group cannot run inside the step graphs: "
                "build the runner with cuda_graphs=False, or give each "
                "rank its own card (nccl)")
        self.deferred = config.scheduler.deferred_kv_writes
        if self.deferred:
            check_deferred_kv(config)
        # The step bridge (parallel/distributed.py) of rank 0 under tp,
        # pp or sp, and the last dispatch's handle (what an ahead step
        # feeds on).
        self.bridge = None
        self._last_handle = None
        self.cache_layout = config.cache.cache_layout
        # int8 KV: pages quantized on write with per-slot f32 scales
        # (ops/quant_kv.py), dequantized inside the kernels.
        self.kv_quantized = config.cache.resolved_kv_dtype() == "int8"
        cache_dtype = (torch.int8 if self.kv_quantized
                       else model_config.torch_dtype)
        if self.device.type == "cuda":
            # Fail at start-up, before the weights are made.
            check_engine_geometry(config)
        _, self._forward = get_model(model_config)
        if pp is not None:
            self._forward = functools.partial(pp_paged_forward, pp=pp)
        if sp is not None:
            # Unified and verify dispatches split their rows over sp.
            self._forward = shard_rows_forward(self._forward, sp)
        quantized = model_config.quantization == "int8"
        rank = 0 if tp is None else tp.rank
        if params is None and quantized:
            # Straight to int8: a full-precision init then quantize
            # would peak at the dense weights plus their int8 copy.
            logger.info("Initializing random int8 weights for %s",
                        model_config.name)
            params = init_random_quantized(model_config, config.seed,
                                           self.device, rank, tp_size,
                                           self.layers)
        elif params is None:
            # The families' init_params draws, leaf by leaf, each module
            # cut to the rank's shard (and stage) before the next is
            # drawn.
            logger.info("Initializing random weights for %s",
                        model_config.name)
            gen = torch.Generator(device=self.device)
            gen.manual_seed(config.seed)
            params = mesh.build_rank_params(
                model_config, lambda path, shape, dtype: llama.random_leaf(
                    path, shape, dtype, gen, self.device), rank, tp_size,
                layers=self.layers)
        if (self.layers is not None
                and len(params.layers) == model_config.num_hidden_layers):
            # Given the whole model: the stage's layers, cut in place.
            mesh.keep_layers(params, self.layers)
        self.params = params.to(self.device)
        if quantized and not has_quantized_leaves(self.params):
            # Given dense weights: quantized here, in place.
            logger.info("Quantizing projection weights to int8 "
                        "(weight-only)")
            quantize_params(self.params, model_config)
        if tp is not None:
            # Given full weights: the rank's shard, cut from the full
            # (quantized) set; a rank's shard as built stays.
            mesh.shard_params(self.params, model_config, tp.rank, tp.size)
        # Multi-LoRA: the adapter stacks, allocated once before the KV
        # pages and written in place by register_lora (the step graphs
        # hold their addresses). None when LoRA is off.
        self.lora_registry: Optional[LoRARegistry] = (
            LoRARegistry(self.shard_config, config.lora.max_loras,
                         config.lora.max_lora_rank, self.device,
                         shard=(None if tp is None and pp is None else
                                self._shard_adapter))
            if config.lora.enable else None)

        # per_layer: one [kv_heads, pages, d, page_size] buffer per
        # layer, k and v; stacked: one [L, kv_heads, pages, d,
        # page_size] buffer each, written and read in place at the
        # layer index. For int8 each is a QuantKV of int8 pages and
        # their [(L,) kv_heads, pages, page_size] scales.
        layers = self.shard_config.num_hidden_layers
        shape = (self.shard_config.num_key_value_heads,
                 config.cache.num_pages, model_config.head_dim,
                 config.cache.page_size)

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
        # Context-parallel whole-prompt prefills dispatched, and per
        # split kind ("unified", "spec_verify") the [dispatches, rows
        # this rank computed, rows of the blocks] of the split ragged
        # dispatches (shard_rows_forward).
        self.sp_prefill_steps = 0
        self.sp_split_rows = {}
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(config.seed + 1)
        # The device performance observatory (engine/perf_observatory.py):
        # exact parameter sizes, the card's name for the peak table, the
        # capture ledger the step graphs feed, and the attention path of
        # each phase: the kernels on the card, the plain versions on the
        # CPU (the wrappers raise rather than fall back on the card).
        # Set to None to turn every hook off.
        # Every leaf of the weights: parameters and the int8 projections'
        # buffers (values and scales), as the JAX ledger sums its tree.
        weights = (list(self.params.parameters())
                   + list(self.params.buffers()))
        self.observatory: Optional[PerfObservatory] = PerfObservatory(
            config, param_count=sum(p.numel() for p in weights),
            params_bytes=sum(p.numel() * p.element_size() for p in weights),
            device=self.device, tp_size=tp_size)
        for kind in STEP_KINDS:
            self.observatory.register_kind(kind)
        impl = "cuda" if self.device.type == "cuda" else "plain"
        for phase in ("decode", "prefill", "unified"):
            self.observatory.set_attention_impl(phase, impl)
        self.graphs: Optional[StepGraphs] = (
            StepGraphs(self.device, generators=[self.generator],
                       observatory=self.observatory)
            if cuda_graphs and self.device.type == "cuda" else None)
        if self.graphs is not None and sp is not None:
            # Counted from the start, as the other reasons are.
            self.graphs.eager_steps.setdefault(SP_PREFILL, 0)
        # The guided-decoding automaton's tables on the device
        # (set_guided_tables), or None: no guided row is served.
        self._guided_trans: Optional[torch.Tensor] = None
        self._guided_mask: Optional[torch.Tensor] = None
        # (key, matrix) of the last logit-bias payload (_bias_payload).
        self._bias_cache = None

    def _shard_adapter(self, adapter):
        """An adapter's pairs cut to this rank: the stage's layers,
        then the tp cut of its base projections."""
        adapter = mesh.stage_lora_adapter(adapter, self.layers)
        if self.tp is None:
            return adapter
        return mesh.shard_lora_adapter(adapter, self.tp.rank, self.tp.size)

    def set_guided_tables(self, fsm) -> None:
        """Upload the guided-decoding automaton's tables
        (engine/guided.py) once. The steps read them at these fixed
        addresses: each gathers mask[state] rows, and a burst advances
        state = transition[state, token] on the device. Under tp every
        rank takes the same tables."""
        with self._bridge_lock():
            self._publish({"op": "guided", "transition": fsm.transition,
                           "mask": fsm.mask})
            self._set_guided(fsm.transition, fsm.mask)

    def _set_guided(self, transition: np.ndarray, mask: np.ndarray) -> None:
        self._guided_trans = torch.from_numpy(transition).to(self.device)
        self._guided_mask = torch.from_numpy(mask).to(self.device)

    # ---- tensor parallelism: the step bridge --------------------------------

    def attach_bridge(self, bridge) -> None:
        """Rank 0 of a tp group: publish every dispatch, adapter
        install, guided table and embedding chunk through ``bridge``
        (parallel/distributed.StepBridge) before running it here."""
        bridge.runner = self
        self.bridge = bridge

    def _publish(self, record: dict) -> None:
        if self.bridge is not None:
            self.bridge.publish(record)

    def _bridge_lock(self):
        """Publish-and-run is atomic under tp: the ranks must run their
        collectives in one order (the engine loop's steps, an HTTP
        thread's adapter install)."""
        return (self.bridge.lock if self.bridge is not None
                else contextlib.nullcontext())

    def execute(self, record: dict):
        """Ranks 1..N-1: replay one record rank 0 published, on this
        rank's shard (the bridge's worker loop calls it)."""
        op = record["op"]
        if op == "step":
            token_source = None
            if record["token_source"]:
                if self._last_handle is None:
                    raise RuntimeError("an ahead step with no step before "
                                       "it to feed on")
                token_source = self._last_handle.token_source
            out = self._run_step(record["kind"], tuple(record["shape"]),
                                 record["payload"], tuple(record["names"]),
                                 tuple(record["body"]), token_source,
                                 tuple(record["options"]))
            self._last_handle = self._handle_for(record, out)
            return out
        if op == "guided":
            return self._set_guided(record["transition"], record["mask"])
        if op == "lora":
            return self.lora_registry.register(record["adapter"])
        if op == "embed":
            return self._encode(torch.from_numpy(record["tokens"]).to(
                self.device))
        if op == "read_page":
            return self._read_page(record["page_id"])
        if op == "write_page":
            return self._write_page(record["page_id"], record["pages"])
        raise ValueError(f"unknown bridge record {op!r}")

    @staticmethod
    def _handle_for(record: dict, out):
        """The handle rank 0 built for a dispatch: what a following
        ahead step takes its tokens from (None after a step no ahead
        step follows: prefill, unified)."""
        body = record["body"][0]
        if record["kind"] == "spec_verify":
            return SpecStepHandle(None, None, out)
        if body in ("decode", "burst"):
            return DecodeStepHandle(None, out)
        return None

    def _record_timing(self, kind: str, t: int, wall: float) -> None:
        """PSTPU_TIMING walls: the log line, and the same wall folded
        into the observatory's dispatch ledger."""
        _timing_log(kind, t, wall)
        if self.observatory is not None:
            self.observatory.on_timing(kind, wall)

    def _clock(self, kind: str, t: int):
        """With PSTPU_TIMING set, a clock started now: calling it records
        the wall of a dispatch of ``kind``; None otherwise (no clock is
        read)."""
        if not _TIMING:
            return None
        t0 = time.perf_counter()
        return lambda: self._record_timing(kind, t,
                                           time.perf_counter() - t0)

    def register_lora(self, adapter) -> int:
        """Install an adapter (the full A/B pairs): under tp every rank
        installs its own shard of it, in the same slot."""
        with self._bridge_lock():
            self._publish({"op": "lora", "adapter": adapter})
            return self.lora_registry.register(adapter)

    def encode(self, tokens: torch.Tensor) -> torch.Tensor:
        """The pooled routes' dense forward (models/llama.encode) over
        [B, T] tokens on the device, every rank on its shard."""
        with self._bridge_lock():
            if self.bridge is not None:
                self._publish({"op": "embed",
                               "tokens": tokens.cpu().numpy()})
            return self._encode(tokens)

    def _encode(self, tokens: torch.Tensor) -> torch.Tensor:
        if self.pp is not None:
            return pp_encode(self.params, self.shard_config, tokens,
                             self.pp, self.tp)
        return llama.encode(self.params, self.shard_config, tokens,
                            **self._fwd_args)

    # ---- steps --------------------------------------------------------------

    def _to_device(self, arrays: dict) -> dict:
        return {name: torch.from_numpy(arr).to(self.device,
                                               non_blocking=True)
                for name, arr in arrays.items()}

    def _dispatch(self, kind: str, shape: Tuple[int, ...], payload: dict,
                  names: Tuple[str, ...], body: Tuple,
                  token_source: Optional[torch.Tensor] = None,
                  options: Tuple[str, ...] = ()):
        """Run one step: ``body`` names the step's function (see
        ``_body``: ("prefill",), ("decode",), ("burst", window) or
        ("ragged",)), which maps the payload's ``names`` and sampling
        knobs, as tensors, to the step's output (the sampled tokens, or
        with logprobs a tuple); ``options`` the per-row options the step
        carries, whose inputs (OPTION_INPUTS) join ``names``.
        ``token_source`` (a device tensor: the previous dispatch's
        sampled tokens) replaces the tokens. On the card the step
        replays its (kind, shape, mode, options) graph, captured at the
        key's first use; it runs eagerly on the CPU, and on the card
        only when a row is seeded (counted). Under tp, rank 0 publishes
        the step first (``execute`` replays it on the other ranks)."""
        with self._bridge_lock():
            if self.bridge is not None:
                if token_source is not None and (
                        self._last_handle is None
                        or token_source.data_ptr()
                        != self._last_handle.token_source.data_ptr()):
                    raise RuntimeError(
                        "under tp an ahead step feeds only on the step "
                        "dispatched just before it")
                self._publish({
                    "op": "step", "kind": kind, "shape": tuple(shape),
                    "payload": payload, "names": tuple(names),
                    "body": tuple(body),
                    "token_source": token_source is not None,
                    "options": tuple(options)})
            return self._run_step(kind, shape, payload, names, body,
                                  token_source, options)

    def _body(self, spec: Tuple, options: Tuple[str, ...],
              seeding: dict):
        """A step's function ``(inputs, mode) -> output`` from its
        description (the form the bridge publishes)."""
        name = spec[0]
        if name in ("prefill", "decode"):
            return lambda dev, mode: self._step_body(dev, mode, name,
                                                     options, seeding)
        if name == "burst":
            return lambda dev, mode: self._burst_body(dev, mode, spec[1],
                                                      options, seeding)
        if name == "ragged":
            return lambda dev, mode: self._unified_body(dev, mode, options)
        if name == "sp_prefill":
            return lambda dev, mode: self._sp_prefill_body(dev, mode,
                                                           options, seeding)
        raise ValueError(f"unknown step body {spec!r}")

    def _run_step(self, kind: str, shape: Tuple[int, ...], payload: dict,
                  names: Tuple[str, ...], body: Tuple,
                  token_source: Optional[torch.Tensor],
                  options: Tuple[str, ...]):
        fn = self._body(body, options, self._seeding(payload))
        mode = sampler_mode(*(payload[k] for k in KNOBS))
        if "share_slots" in payload:
            rows = shape[0]
            counts = self.sp_split_rows.setdefault(kind, [0, 0, 0])
            for i, n in enumerate((1, rows // self.sp.size, rows)):
                counts[i] += n
        names = names + tuple(n for o in options for n in OPTION_INPUTS[o])
        if "lora_ids" in payload:
            names += ("lora_ids",)
        # The sp whole-prompt prefill runs eagerly: its T buckets reach
        # the model's length, one graph and its pool a bucket.
        eager = ("seeded" if "seeds" in payload else
                 SP_PREFILL if body[0] == "sp_prefill" else None)
        with torch.inference_mode():
            if self.graphs is not None and eager is None:
                return self.graphs.run(
                    kind, shape, mode,
                    {k: payload[k] for k in names + KNOBS},
                    lambda inputs: fn(inputs, mode),
                    token_source=token_source, options=options)
            if self.graphs is not None:
                self.graphs.count_eager(eager)
            inputs = self._to_device({k: payload[k] for k in names})
            if token_source is not None:
                inputs["tokens"] = token_source
            # The knobs stay on the host: the sampler moves what it
            # needs.
            inputs.update({k: torch.from_numpy(payload[k]) for k in KNOBS})
            return fn(inputs, mode)

    @staticmethod
    def _seeding(payload: dict) -> dict:
        """A seeded step's per-row seeds, as the sampler takes them (CPU
        tensors), or {}."""
        if "seeds" not in payload:
            return {}
        return {name: torch.from_numpy(payload[name])
                for name in ("seeds", "emitted", "seed_mask")}

    def _lora_payload(self, seqs: "List[Optional[Sequence]]",
                      pad_to: int) -> dict:
        """With LoRA on, each row's adapter slot ([pad_to] int32; pad and
        None rows 0, the base model); else {}."""
        if self.lora_registry is None:
            return {}
        ids = np.zeros((pad_to,), np.int32)
        for i, seq in enumerate(seqs):
            if seq is not None:
                ids[i] = seq.lora_id
        return {"lora_ids": ids}

    def _lora_args(self, dev: dict) -> dict:
        """The forward's adapter arguments: the registry's stacks and
        the step's ``lora_ids``, or none with LoRA off."""
        if self.lora_registry is None:
            return {}
        return {"lora": self.lora_registry.stack,
                "lora_ids": dev["lora_ids"]}

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
            self.params, self.shard_config, tokens, positions,
            dev["page_table"], dev["kv_lens"], valid, self.k_cache,
            self.v_cache, select=select, kind=kind, **self._lora_args(dev),
            **self._fwd_args)
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
        split = ({"share_slots": dev["share_slots"]}
                 if "share_slots" in dev else {})
        span = self._forward(
            self.params, self.shard_config, tokens, dev["positions"],
            dev["page_table"], dev["kv_lens"], dev["valid"],
            self.k_cache, self.v_cache, select=idx, kind="ragged",
            **self._lora_args(dev), **self._fwd_args, **split)
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
        (else None). A context-parallel plan (``plan.sp``) runs as
        ``run_sp_prefill``."""
        if plan.sp:
            return self.run_sp_prefill(plan)
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
        payload.update(self._lora_payload([c.seq for c in chunks], b))
        # Only rows whose LAST chunk is in this step keep their sample:
        # the others carry no options.
        sampling_rows = [c.seq if c.is_last_chunk else None for c in chunks]
        payload.update(self._seed_payload(sampling_rows, b))
        opts, options = self._options_payload(sampling_rows, b)
        payload.update(opts)
        clock = self._clock("prefill", t)
        sampled = self._dispatch(
            "step", (b, t), payload, ("tokens", "positions", "valid",
                                      "page_table", "kv_lens",
                                      "last_index"),
            ("prefill",), options=options)
        self._last_handle = None
        handle = DecodeStepHandle(sampling_rows, sampled, clock)
        if not any(c.is_last_chunk for c in chunks):
            _stop(handle)  # no read: the wall of the dispatch alone
            return [None] * len(chunks), None
        toks, lps = handle.result()
        return ([tk[0] if c.is_last_chunk else None
                 for tk, c in zip(toks, chunks)],
                None if lps is None else
                [lp[0] if c.is_last_chunk else None
                 for lp, c in zip(lps, chunks)])

    def run_sp_prefill(self, plan: PrefillPlan
                       ) -> Tuple[List[Optional[int]], Optional[list]]:
        """Context-parallel whole-prompt prefill (the JAX runner's
        ``run_sp_prefill``): ONE dispatch covers the plan's one prompt,
        its T bucketed to a power of two of at least 16 and then to an
        sp multiple, the sequence sharded over the sp ranks
        (parallel/context_serving.py). The sampling chain's options and
        logprobs ride it as they ride a prefill step. Returns
        ([first token], [its logprobs] or None)."""
        chunk = plan.chunks[0]
        seq = chunk.seq
        n = len(chunk.chunk_tokens)
        t = 16
        while t < n:
            t *= 2
        t += (-t) % self.sp.size
        tokens = np.zeros((1, t), np.int32)
        valid = np.zeros((1, t), bool)
        tokens[0, :n] = chunk.chunk_tokens
        valid[0, :n] = True
        sp = seq.sampling
        payload = {
            "tokens": tokens, "valid": valid,
            "page_table": self._page_table_rows([seq]),
            "last_index": np.asarray([n - 1], np.int32),
            "temperature": np.asarray([sp.temperature], np.float32),
            "top_p": np.asarray([sp.top_p], np.float32),
            "top_k": np.asarray([sp.top_k], np.int32),
        }
        payload.update(self._lora_payload([seq], 1))
        payload.update(self._seed_payload([seq], 1))
        opts, options = self._options_payload([seq], 1)
        payload.update(opts)
        clock = self._clock("prefill", t)
        sampled = self._dispatch(
            "step", (1, t), payload,
            ("tokens", "valid", "page_table", "last_index"),
            ("sp_prefill",), options=options)
        self._last_handle = None
        self.sp_prefill_steps += 1
        toks, lps = DecodeStepHandle([seq], sampled, clock).result()
        return [toks[0][0]], None if lps is None else [lps[0][0]]

    def _sp_prefill_body(self, dev: dict, mode: str,
                         options: Tuple[str, ...] = (),
                         seeding: Optional[dict] = None):
        logits = sp_prefill_forward(
            self.params, self.shard_config, dev["tokens"],
            dev["page_table"], dev["valid"], dev["last_index"],
            self.k_cache, self.v_cache, sp=self.sp,
            **self._lora_args(dev), **self._fwd_args)
        return self._sample_rows(logits, dev, mode, options, seeding)

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
        payload.update(self._lora_payload(rows, b))
        if not ahead:
            # Plan-ahead eligibility excludes seeded rows (their
            # emitted index would be one token stale).
            payload.update(self._seed_payload(rows, b))
        opts, options = self._options_payload(rows, b, row_inputs=not ahead)
        payload.update(opts)
        names = ("tokens", "positions", "valid", "page_table", "kv_lens")
        clock = self._clock("decode", window)
        if window > 1:
            payload.update(self._burst_payload(rows, b))
            if self.deferred:
                options += ("deferred",)
            sampled = self._dispatch(
                "decode_burst", (b, window, payload["stop_tokens"].shape[1]),
                payload, names + ("budgets", "stop_tokens"),
                ("burst", window), options=options)
        else:
            sampled = self._dispatch(
                "step", (b, 1), payload, names, ("decode",),
                token_source=token_source, options=options)
        self._last_handle = DecodeStepHandle(rows, sampled, clock)
        return self._last_handle

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
        sampled logprobs and [B, window, 20] top ids and logprobs.

        With deferred KV writes (the JAX runner's
        ``_decode_burst_deferred_impl``) the iterations leave the pages
        as they are: each layer's K/V go into its [B, window, kv, d]
        tails (buffers of this step, graph-owned on the card), attention
        reads pages and tail (slot s at position positions[:, 0] + s),
        and one ``write_to_pages`` a layer flushes each row's first
        ``emitted`` slots at the end."""
        seeding = dict(seeding or {})
        emitted_start = seeding.pop("emitted", None)
        tok = dev["tokens"][:, None]
        pos, kv_lens = dev["positions"], dev["kv_lens"]
        active = dev["valid"][:, 0]
        emitted = torch.zeros_like(kv_lens)
        counts = dev.get("pen_counts")
        state = dev.get("fsm_state")
        tails = (self._burst_tails(tok.shape[0], window) if self.deferred
                 else None)
        # Deferred: the pages hold the tokens before the burst all along.
        kv_lens0 = pos[:, 0].clone()
        outs = []
        for k in range(window):
            logits = self._forward(
                self.params, self.shard_config, tok, pos,
                dev["page_table"], kv_lens0 if self.deferred else kv_lens,
                active[:, None], self.k_cache, self.v_cache, kind="decode",
                **self._lora_args(dev), **self._fwd_args,
                **({} if tails is None else {"kv_tail": tails}))[:, 0]
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
        if tails is not None:
            self._flush_tails(tails, dev["page_table"], kv_lens0, emitted)
        stacked = tuple(torch.stack(x, dim=1) for x in zip(*outs))
        return stacked if len(stacked) > 1 else stacked[0]

    def _burst_tails(self, batch: int, window: int):
        """Zeroed per-layer [B, window, kv, d] K and V tails in the model
        dtype (JAX's ``m.jax_dtype`` tails), the rank's kv heads."""
        m = self.shard_config
        shape = (batch, window, m.num_key_value_heads, m.head_dim)
        return tuple([torch.zeros(shape, dtype=m.torch_dtype,
                                  device=self.device)
                      for _ in range(m.num_hidden_layers)]
                     for _ in range(2))

    def _flush_tails(self, tails, page_table: torch.Tensor,
                     kv_lens0: torch.Tensor, emitted: torch.Tensor) -> None:
        """The burst's one write a layer: each row's first ``emitted``
        tail slots to positions kv_lens0 + s of its pages (quantized on
        write for an int8 cache), the rest to trash page 0."""
        window = tails[0][0].shape[1]
        steps = torch.arange(window, device=self.device)[None, :]
        tail_pos = kv_lens0.long()[:, None] + steps
        tail_valid = steps < emitted[:, None]
        stacked = not isinstance(self.k_cache, list)
        for layer in range(len(tails[0])):
            for cache, tail in ((self.k_cache, tails[0][layer]),
                                (self.v_cache, tails[1][layer])):
                write_to_pages(cache if stacked else cache[layer], tail,
                               page_table, tail_pos, tail_valid,
                               layer=layer if stacked else None)

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
        b, s = self._split_rows(self.decode_width), self.spec_width
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
        payload.update(self._lora_payload(seqs, b))
        _, options = self._options_payload(seqs, b, row_inputs=False)
        shape, names = self._ragged_split(payload, (b, s))
        clock = self._clock("spec", s)
        self._last_handle = SpecStepHandle(
            list(seqs), [list(plan.drafts[i]) for i in range(len(seqs))],
            self._dispatch("spec_verify", shape, payload, names,
                           ("ragged",), options=options), clock)
        return self._last_handle

    def _split_rows(self, rows: int) -> int:
        """A ragged block's row count, padded to a multiple of the sp
        size under context parallelism (each rank runs R/sp rows)."""
        return rows if self.sp is None else rows + (-rows) % self.sp.size

    def _ragged_split(self, payload: dict, shape: Tuple[int, int]):
        """(key shape, input names) of a ragged dispatch; under context
        parallelism the payload gains each rank's live slots
        (``share_slots``), whose width joins the key (a step graph a
        width)."""
        if self.sp is None or shape[1] <= 1:
            return shape, RAGGED_INPUTS
        payload["share_slots"] = share_slots(payload["valid"],
                                             self.sp.size)
        return (shape + (payload["share_slots"].shape[1],),
                RAGGED_INPUTS + ("share_slots",))

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
        r = self._split_rows(self._row_bucket_for(off + len(chunks)))
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
        payload.update(self._lora_payload(
            list(seqs) + [c.seq for c in chunks], r))
        rows = list(seqs) + [c.seq if c.is_last_chunk else None
                             for c in chunks]
        _, options = self._options_payload(rows, r, row_inputs=False)
        shape, names = self._ragged_split(payload, (r, w))
        clock = self._clock("unified", w)
        toks, lps = _row_results(rows, self._dispatch(
            "unified", shape, payload, names, ("ragged",),
            options=options))
        if clock is not None:
            clock()
        self._last_handle = None
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

    def _page_planes(self) -> list:
        """The cache tensors a page spans, in wire order: k and v (an
        int8 cache: k and v data, then k and v scales), each as
        (tensor, stacked) with the page axis at 2 when stacked and at
        1 when a list of per-layer tensors."""
        if self.kv_quantized:
            leaves = [(c, leaf) for leaf in ("data", "scale")
                      for c in (self.k_cache, self.v_cache)]
        else:
            leaves = [(self.k_cache, None), (self.v_cache, None)]
        planes = []
        for cache, leaf in leaves:
            if isinstance(cache, list):
                planes.append(([getattr(c, leaf) if leaf else c
                                for c in cache], False))
            else:
                planes.append((getattr(cache, leaf) if leaf else cache,
                               True))
        return planes

    def read_page(self, page_id: int) -> Tuple[torch.Tensor, ...]:
        """Copy one page's KV out of device memory, in the JAX engine's
        wire shape and the cache's own element type, as CPU tensors:
        (k, v) each [L, kv, d, page_size] (bf16 stays 2 bytes an
        element), or for an int8 cache the 4-tuple (k, v, k_scale,
        v_scale) of int8 pages and f32 [L, kv, page_size] scales.

        The copy is queued on the stream the steps run on, so it waits
        for the step that wrote the page (an async step still in
        flight, a burst's writes) and for nothing else on the card. On
        the CPU the page is a copy too, never a view of the cache (a
        pool holding a view would see the page's slot reused). Under tp
        every rank reads its kv heads and the page is gathered along
        the head axis, under pp each stage its layers and the page is
        gathered along the layer axis: the full page, as the JAX engine
        reads it off its mesh, the read published to the other ranks
        first. The sp ranks' replicas are alike; each reads its own."""
        with self._bridge_lock():
            self._publish({"op": "read_page", "page_id": int(page_id)})
            return self._read_page(page_id)

    def _read_page(self, page_id: int) -> Tuple[torch.Tensor, ...]:
        out = []
        for plane, stacked in self._page_planes():
            page = (plane[:, :, page_id] if stacked
                    else torch.stack([c[:, page_id] for c in plane]))
            if self.tp is not None:
                page = self.tp.all_gather(page, dim=1)
            if self.pp is not None:
                page = self.pp.all_gather(page, dim=0)
            out.append(page.to("cpu", copy=True))
        return tuple(out)

    def write_page(self, page_id: int, k_page: torch.Tensor,
                   v_page: torch.Tensor,
                   k_scale: Optional[torch.Tensor] = None,
                   v_scale: Optional[torch.Tensor] = None) -> None:
        """Restore one page's KV into device memory, in place (the step
        graphs hold the caches' addresses): what ``read_page`` gave, in
        the cache's element type (for an int8 cache, with its scales).
        One host-to-device copy a plane, queued on the steps' stream
        before any step that reads the page. Under tp, pp and sp the
        full page is published and every rank writes its part of it:
        its kv heads, its stage's layers, each sp replica the same."""
        pages = [k_page, v_page]
        if self.kv_quantized:
            if k_scale is None or v_scale is None:
                raise ValueError(
                    "a quantized cache's page restore needs "
                    "k_scale/v_scale")
            pages += [k_scale, v_scale]
        pages = [torch.as_tensor(page) for page in pages]
        for (plane, stacked), page in zip(self._page_planes(), pages):
            dtype = plane.dtype if stacked else plane[0].dtype
            if page.dtype != dtype:
                raise TypeError(f"page of {page.dtype} for a cache of "
                                f"{dtype}")
        with self._bridge_lock():
            self._publish({"op": "write_page", "page_id": int(page_id),
                           "pages": pages})
            self._write_page(page_id, pages)

    def _write_page(self, page_id: int, pages) -> None:
        """Each plane of a full page into this rank's cache: under pp
        its stage's layers, under tp its kv heads of them."""
        for (plane, stacked), page in zip(self._page_planes(), pages):
            if self.layers is not None:
                page = page[self.layers[0]:self.layers[1]]
            if self.tp is not None:
                page = mesh.cut(page, 1, self.tp.rank, self.tp.size)
            page = page.to(self.device)
            if stacked:
                plane[:, :, page_id] = page
            else:
                for layer, cache in enumerate(plane):
                    cache[:, page_id] = page[layer]

    def _page_table_rows(self, seqs: List[Sequence],
                         pad_to: Optional[int] = None) -> np.ndarray:
        rows = pad_to or len(seqs)
        table = np.zeros((rows, self.max_pages_per_seq), np.int32)
        for i, seq in enumerate(seqs):
            n = min(len(seq.pages), self.max_pages_per_seq)
            table[i, :n] = seq.pages[:n]
        return table
