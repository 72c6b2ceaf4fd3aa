"""The device performance observatory: the JAX engine's four ledgers
(``production_stack_tpu/engine/perf_observatory.py``) for the card.

- **Capture ledger**, in place of the JAX compile ledger: the step
  graphs (``engine/step_graphs.py``) report each capture with its kind,
  its seconds (warm-up included) and its bucket-shape key. The
  ``/metrics`` compile counters and ``GET /debug/compiles`` both read
  it, so they cannot disagree. ``executable_cache_sizes`` is the number
  of graphs held a kind.
- **Memory ledger**: an analytic breakdown of device bytes (weights as
  the exact sum over the parameter tensors, KV pages and int8 scales
  from the page math, step buffers), plus the numeric fields of
  ``torch.cuda.memory_stats`` on the card (absent on the CPU). Under
  tensor parallelism it is one rank's: its shard of the weights, its
  kv heads of the pages, and rank 0's device (the server's process).
- **Step-time / MFU ledger**: per-kind seconds the host waited on a
  step's read-back and the committed tokens it produced, turned into a
  model-FLOPs utilization against a peak table of NVIDIA cards (or
  ``--device-peak-flops``). An unknown device, the CPU included,
  reports MFU 0 rather than a guess.
- **Attention-impl one-hot**: which attention path each step phase
  runs, ``cuda`` (the hand-written kernels) on the card and ``plain``
  on the CPU. The kernel wrappers raise on CUDA tensors rather than fall
  back, so a phase served by the plain version on the card cannot
  occur; the gauge shows which kernel each phase ran.

- **Dispatch timing fold-in**: with ``PSTPU_TIMING`` set, the runner
  clocks each dispatch from its launch to the read of its sampled
  tokens (engine/model_runner.py) and folds the wall in here by kind
  (``on_timing``); ``compile_report``'s ``timings`` carries ``{kind:
  {count, wall_seconds}}``, as the JAX ledger's does, and stays empty
  with the variable unset.

Everything is counter arithmetic on the engine's step thread: no device
transfer and no synchronization. Readers (the ``/metrics`` handler, the
debug routes) see monotone snapshots, so no lock is taken.
"""

from __future__ import annotations

import collections
import statistics
import time
from typing import Any, Deque, Dict, List, Optional, Tuple

import torch

# Dense bf16 tensor-core peak FLOP/s per card for the MFU estimate,
# prefix-matched (case-insensitively) against
# ``torch.cuda.get_device_name()``. "NVIDIA H100 80GB HBM3" is the SXM5
# card: 989.4 TFLOP/s dense bf16 in NVIDIA's H100 datasheet (1,979
# with 2:4 sparsity), the figure chip_smoke.py's bounds divide by. An
# unknown device, the CPU included, resolves to 0.
PEAK_FLOPS_BY_DEVICE_KIND = {
    "NVIDIA H100 80GB HBM3": 989e12,
}


def resolve_peak_flops(device_kind: Optional[str],
                       override: float = 0.0) -> float:
    """Per-card peak FLOP/s: an explicit override wins, then the table,
    then 0.0 (unknown)."""
    if override and override > 0:
        return float(override)
    if device_kind:
        lowered = device_kind.lower()
        for kind, peak in PEAK_FLOPS_BY_DEVICE_KIND.items():
            if lowered.startswith(kind.lower()):
                return peak
    return 0.0


def device_kind(device: torch.device) -> str:
    """The card's name for the peak table; "" for the CPU."""
    if device.type != "cuda":
        return ""
    return torch.cuda.get_device_name(device)


class PerfObservatory:
    """Host-side performance ledgers of one model runner. Written by the
    engine's step thread only."""

    def __init__(self, config, *, param_count: int = 0,
                 params_bytes: int = 0,
                 device: Optional[torch.device] = None,
                 compile_ring_size: int = 128, tp_size: int = 1):
        self.config = config
        # The rank's share: ``param_count`` and ``params_bytes`` are its
        # shard's, its pages hold kv heads / tp_size.
        self.tp_size = int(tp_size)
        self.param_count = int(param_count)
        self.params_bytes = int(params_bytes)
        self.device = device or torch.device("cpu")
        self.device_kind = device_kind(self.device)
        self.peak_flops = resolve_peak_flops(
            self.device_kind, float(config.device_peak_flops or 0.0))
        # Dense decoder forward: about 2 FLOPs a parameter a token.
        self.flops_per_token = 2.0 * self.param_count

        # Capture ledger.
        self._compile_events: Dict[str, int] = {}
        self._compile_seconds: Dict[str, float] = {}
        self._cache_sizes: Dict[str, int] = {}
        self._compile_ring: Deque[Dict[str, Any]] = collections.deque(
            maxlen=compile_ring_size)

        # Step / MFU ledger, with a bounded ring of recent step times a
        # kind for the median gauge.
        self._device_seconds: Dict[str, float] = {}
        self._tokens: Dict[str, int] = {}
        self.device_seconds_total = 0.0
        self.tokens_total = 0
        self._step_durations: Dict[str, Deque[float]] = {}
        self._step_ring_size = 512

        # Attention impl by phase.
        self._attention_impls: Dict[str, str] = {}

        # PSTPU_TIMING dispatch walls by kind.
        self._dispatch_count: Dict[str, int] = {}
        self._dispatch_seconds: Dict[str, float] = {}

    # ---- capture ledger ----------------------------------------------------

    def register_kind(self, kind: str) -> None:
        """Zero-init a step kind, so its gauges exist (at 0) before its
        first capture."""
        self._compile_events.setdefault(kind, 0)
        self._compile_seconds.setdefault(kind, 0.0)
        self._cache_sizes.setdefault(kind, 0)

    def on_compile(self, kind: str, key: Optional[Tuple[int, ...]],
                   seconds: float, cache_size: int) -> None:
        """One capture of ``kind`` at bucket shape ``key``, which took
        ``seconds``; ``cache_size`` graphs of the kind are now held."""
        self._compile_events[kind] = self._compile_events.get(kind, 0) + 1
        self._compile_seconds[kind] = (
            self._compile_seconds.get(kind, 0.0) + float(seconds))
        self._cache_sizes[kind] = int(cache_size)
        self._compile_ring.append({
            "kind": kind,
            "key": list(key) if key is not None else None,
            "seconds": round(float(seconds), 6),
            "cache_size": int(cache_size),
            "ts": time.time(),
        })

    def compile_events_by_kind(self) -> Dict[str, int]:
        return dict(self._compile_events)

    def compile_seconds_by_kind(self) -> Dict[str, float]:
        return dict(self._compile_seconds)

    def compile_events_total(self, kind: Optional[str] = None) -> int:
        if kind is not None:
            return self._compile_events.get(kind, 0)
        return sum(self._compile_events.values())

    def executable_cache_sizes(self) -> Dict[str, int]:
        """Graphs held per kind (a graph is never evicted, so this is
        the capture count)."""
        return dict(self._cache_sizes)

    def recent_compiles(self, limit: int = 32) -> List[Dict[str, Any]]:
        items = list(self._compile_ring)
        if limit >= 0:
            items = items[-limit:]
        return items

    # ---- dispatch timing ---------------------------------------------------

    def on_timing(self, kind: str, wall: float) -> None:
        """One clocked dispatch of ``kind`` that took ``wall`` seconds."""
        self._dispatch_count[kind] = self._dispatch_count.get(kind, 0) + 1
        self._dispatch_seconds[kind] = (
            self._dispatch_seconds.get(kind, 0.0) + float(wall))

    def dispatch_timings(self) -> Dict[str, Dict[str, float]]:
        return {kind: {"count": self._dispatch_count[kind],
                       "wall_seconds": round(
                           self._dispatch_seconds.get(kind, 0.0), 6)}
                for kind in sorted(self._dispatch_count)}

    def compile_report(self, limit: int = 32) -> Dict[str, Any]:
        return {
            "events": self.compile_events_by_kind(),
            "seconds": {k: round(v, 6)
                        for k, v in self._compile_seconds.items()},
            "executable_cache_sizes": self.executable_cache_sizes(),
            "recent": self.recent_compiles(limit),
            "timings": self.dispatch_timings(),
        }

    # ---- memory ledger -----------------------------------------------------

    def hbm_bytes(self) -> Dict[str, int]:
        """Analytic device bytes by category, as the JAX ledger computes
        them: ``kv_pages`` + ``kv_scales`` is exactly ``num_pages *
        page_size * kv_bytes_per_token`` (the int8 budget after its page
        expansion), ``weights`` the exact sum over the parameters."""
        model = self.config.model
        cache = self.config.cache
        sched = self.config.scheduler
        slots = (2 * model.num_hidden_layers * model.num_key_value_heads
                 // self.tp_size)
        tokens = cache.num_pages * cache.page_size
        if cache.resolved_kv_dtype() == "int8":
            kv_pages = slots * tokens * model.head_dim  # int8 data
            kv_scales = slots * tokens * 4  # f32 scale a slot
        else:
            kv_pages = (slots * tokens * model.head_dim
                        * model.torch_dtype.itemsize)
            kv_scales = 0
        rows = sched.max_num_seqs + sched.prefill_batch_size
        width = sched.prefill_chunk_size
        # One f32 logits plane and the i32 token block of the widest
        # mixed batch.
        step_buffers = rows * model.vocab_size * 4 + rows * width * 4
        return {
            "weights": int(self.params_bytes),
            "kv_pages": int(kv_pages),
            "kv_scales": int(kv_scales),
            "step_buffers": int(step_buffers),
        }

    def memory_report(self) -> Dict[str, Any]:
        analytic = self.hbm_bytes()
        report: Dict[str, Any] = {
            "analytic": analytic,
            "total_analytic_bytes": sum(analytic.values()),
            "kv_cache_dtype": self.config.cache.resolved_kv_dtype(),
            "num_pages": self.config.cache.num_pages,
            "page_size": self.config.cache.page_size,
            "param_count": self.param_count,
            "tensor_parallel_size": self.tp_size,
        }
        if self.device.type == "cuda":
            stats = torch.cuda.memory_stats(self.device)
            report["device"] = {k: int(v) for k, v in stats.items()
                                if isinstance(v, (int, float))}
        return report

    # ---- step-time / MFU ledger --------------------------------------------

    def on_step(self, kind: str, device_s: float, tokens: int) -> None:
        """One step of ``kind``: ``device_s`` the seconds the host
        waited on its read-back, ``tokens`` the tokens it committed."""
        self._device_seconds[kind] = (
            self._device_seconds.get(kind, 0.0) + float(device_s))
        self._tokens[kind] = self._tokens.get(kind, 0) + int(tokens)
        self.device_seconds_total += float(device_s)
        self.tokens_total += int(tokens)
        ring = self._step_durations.get(kind)
        if ring is None:
            ring = self._step_durations[kind] = collections.deque(
                maxlen=self._step_ring_size)
        ring.append(float(device_s))

    def device_seconds_by_kind(self) -> Dict[str, float]:
        return dict(self._device_seconds)

    def step_time_medians(self) -> Dict[str, float]:
        """Median recent step time a kind, over the bounded ring."""
        return {kind: statistics.median(ring)
                for kind, ring in self._step_durations.items() if ring}

    def tokens_by_kind(self) -> Dict[str, int]:
        return dict(self._tokens)

    def mfu(self) -> float:
        """Useful-token MFU: committed tokens (prefill chunk tokens and
        emitted decode tokens) at 2 FLOPs a parameter, over the waited
        seconds, over the peak; rejected drafts and pad rows count as
        lost. 0.0 when the peak is unknown."""
        if (self.peak_flops <= 0 or self.device_seconds_total <= 0
                or self.tokens_total <= 0):
            return 0.0
        achieved = self.flops_per_token * self.tokens_total
        return achieved / self.device_seconds_total / self.peak_flops

    # ---- attention impls ---------------------------------------------------

    def set_attention_impl(self, phase: str, impl: str) -> None:
        self._attention_impls[phase] = impl

    def attention_impls(self) -> Dict[str, str]:
        return dict(self._attention_impls)
