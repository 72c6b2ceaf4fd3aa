"""Each engine step as one CUDA graph per bucket shape.

The JAX runner compiles one program per step kind and bucket shape at
its first call (``jax.jit``) and counts the compiles by kind
(``InstrumentedJit``, ``engine/perf_observatory.py``); the shapes are
closed sets so that the programs are few. This module is the port's
counterpart: ``StepGraphs`` captures a step as a CUDA graph at the
first use of its key and replays it on every later step of that key,
so a step costs a handful of host calls instead of one launch per
kernel.

A key is (kind, shape, sampler mode, option set). The kinds are the
JAX ledger's labels: ``step`` (prefill and decode; shape [B, T]),
``decode_burst`` ([B, K, stop-set width]), ``spec_verify`` ([B, K + 1])
and ``unified`` ([R, W]). The sampler mode is the host branch the
sampler takes (``ops/sampling.sampler_mode``). The option set names the
per-row sampling options the step carries (penalties, ``logit_bias``,
``min_tokens`` suppression, the guided mask, logprobs: the keys of
``engine/model_runner.OPTION_INPUTS``),
the counterpart of the JAX jit lattice, where an absent option input or
``want_logprobs`` is a program of its own. Each entry holds:

- its static inputs: one device buffer that holds every input of the
  step (tokens, positions, valid, page table, kv lens, ..., the
  sampling knobs, the options' [B, vocab] tensors) as typed views,
  filled by ONE host-to-device copy
  from a pinned staging buffer. There are two staging buffers a key,
  used in turn, each guarded by an event: the async pipeline fills step
  N + 1's inputs while step N's copy may still wait in the stream. A
  step that feeds on the previous step's sampled tokens gets them by a
  device-to-device copy into its tokens view;
- its graph, captured after one eager warm-up run of the same closure
  on a side stream (each kernel sets its shared-memory limit at its
  first launch, and cuBLAS sets up its workspace; neither may happen
  under capture). Every graph allocates from one memory pool. That is
  safe because steps run one at a time on one stream, the static
  inputs live outside the pool, and a graph's output is copied out
  right after its replay, before any other graph runs: a block one
  graph captured as scratch and a later capture took for its output
  is read before it is written again;
- its static output (the sampled tokens, or with logprobs a tuple of
  tokens, sampled logprobs, top ids and top logprobs), cloned after
  every replay, so that an in-flight step's outputs survive the next
  replay of its key (and of any other);
- the kernel launches its capture recorded. The launch counters
  (``COUNTERS``) are Python counts, bumped while the capture records
  kernels that do not run; they are taken back then and added on every
  replay, so the counters say what the card ran.

The closure captured is replayed as it is: it must read nothing but the
entry's static inputs. A capture or a replay that fails raises; there
is no eager fallback.
"""

from __future__ import annotations

import functools
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from production_stack_tpu_torch.ops.paged_kv_common import COUNTERS

# The JAX compile ledger's kinds, and why a step on the card may run
# without a graph.
STEP_KINDS = ("step", "decode_burst", "spec_verify", "unified")
EAGER_REASONS = ("seeded",)

# Alignment of each input's view in the packed buffer, in bytes.
_ALIGN = 16


class CudaGraph:
    """``torch.cuda.CUDAGraph`` behind the three calls ``StepGraphs``
    makes of a graph (a test injects a stand-in with the same calls):
    ``warm(fn)`` runs ``fn`` eagerly on a side stream; ``capture(fn)``
    records ``fn`` and returns its output (a tensor or a tuple of
    tensors), which every ``replay()`` refills."""

    def __init__(self, pool, generators: Sequence[torch.Generator]):
        self._graph = torch.cuda.CUDAGraph()
        self._pool = pool
        self._generators = generators

    def warm(self, fn: Callable[[], object]) -> None:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)

    def capture(self, fn: Callable[[], object]) -> object:
        # A generator drawn from under capture is registered with the
        # graph: each replay then advances it, so unseeded draws differ
        # from step to step and repeat from run to run at one seed.
        for gen in self._generators:
            self._graph.register_generator_state(gen)
        with torch.cuda.graph(self._graph, pool=self._pool):
            out = fn()
        return out

    def replay(self) -> None:
        self._graph.replay()


class _Entry:
    """One key's static inputs, staging buffers, graph and output."""

    def __init__(self, arrays: Dict[str, np.ndarray],
                 device: torch.device):
        self.fields: Dict[str, Tuple[int, int, np.dtype, tuple]] = {}
        offset = 0
        for name, arr in arrays.items():
            arr = np.asarray(arr)
            self.fields[name] = (offset, arr.nbytes, arr.dtype, arr.shape)
            offset += -(-arr.nbytes // _ALIGN) * _ALIGN
        cuda = device.type == "cuda"
        self.buffer = torch.empty((max(offset, 1),), dtype=torch.uint8,
                                  device=device)
        self.static = {
            name: self.buffer[off:off + n].view(
                torch.from_numpy(np.empty(0, dtype)).dtype).view(shape)
            for name, (off, n, dtype, shape) in self.fields.items()}
        self.staging = [torch.empty(self.buffer.shape, dtype=torch.uint8,
                                    pin_memory=cuda) for _ in range(2)]
        self.copied = ([torch.cuda.Event() for _ in range(2)] if cuda
                       else None)
        self.turn = 0
        self.graph = None
        self.output = None  # a tensor or a tuple of tensors
        self.launches: Dict[str, int] = {}

    def load(self, arrays: Dict[str, np.ndarray],
             token_source: Optional[torch.Tensor]) -> None:
        """Pack ``arrays`` into a staging buffer and copy it to the
        static inputs in one copy; then ``token_source`` (a device
        tensor) over the tokens view."""
        if arrays.keys() != self.fields.keys():
            raise ValueError(f"step inputs {sorted(arrays)} differ from "
                             f"the key's {sorted(self.fields)}")
        turn, self.turn = self.turn, self.turn ^ 1
        staging = self.staging[turn]
        if self.copied is not None:
            # The copy that last read this buffer (two steps ago).
            self.copied[turn].synchronize()
        host = staging.numpy()
        for name, (off, n, dtype, shape) in self.fields.items():
            arr = np.asarray(arrays[name])
            if arr.dtype != dtype or arr.shape != shape:
                raise ValueError(
                    f"step input {name}: {arr.dtype} {arr.shape}, the "
                    f"key's static input is {dtype} {shape}")
            host[off:off + n] = np.ascontiguousarray(arr).reshape(
                -1).view(np.uint8)
        self.buffer.copy_(staging, non_blocking=True)
        if self.copied is not None:
            self.copied[turn].record()
        if token_source is not None:
            self.static["tokens"].copy_(token_source)


class StepGraphs:
    """The graph cache of one runner, and its compile ledger.

    ``run(kind, shape, mode, arrays, body, options=...)`` runs one
    step: ``body`` maps the key's static inputs (a dict of device
    tensors named as ``arrays``) to the step's output, a tensor or a
    tuple of tensors; it is called (warmed up
    and captured) at the key's first use only, and must read nothing
    but those inputs and state that lives at fixed addresses (weights,
    KV caches, registered generators). ``graph_factory`` builds a graph
    (default: ``CudaGraph`` in the shared pool)."""

    def __init__(self, device: torch.device,
                 generators: Sequence[torch.Generator] = (),
                 graph_factory: Optional[Callable[[], object]] = None):
        self.device = device
        self._pool = None
        if graph_factory is None:
            self._pool = torch.cuda.graph_pool_handle()
            graph_factory = functools.partial(CudaGraph, self._pool,
                                              list(generators))
        self._graph_factory = graph_factory
        self._entries: Dict[tuple, _Entry] = {}
        # The JAX names' counters: captures and their seconds (warm-up
        # included) by kind; replays by kind; steps run without a graph
        # on the card, by reason.
        self.captures: Dict[str, int] = dict.fromkeys(STEP_KINDS, 0)
        self.capture_seconds: Dict[str, float] = dict.fromkeys(
            STEP_KINDS, 0.0)
        self.replays: Dict[str, int] = dict.fromkeys(STEP_KINDS, 0)
        self.eager_steps: Dict[str, int] = dict.fromkeys(EAGER_REASONS, 0)

    def keys(self) -> List[tuple]:
        return list(self._entries)

    def count_eager(self, reason: str) -> None:
        self.eager_steps[reason] += 1

    def run(self, kind: str, shape: Tuple[int, ...], mode: str,
            arrays: Dict[str, np.ndarray],
            body: Callable[[Dict[str, torch.Tensor]], object],
            token_source: Optional[torch.Tensor] = None,
            options: Tuple[str, ...] = ()):
        """One step of key (kind, shape, mode, options) on ``arrays``
        (numpy), the tokens view then overwritten from
        ``token_source``; returns a fresh copy of the step's output (a
        tuple's tensors each copied)."""
        key = (kind, tuple(shape), mode, tuple(options))
        entry = self._entries.get(key)
        if entry is None:
            entry = _Entry(arrays, self.device)
            entry.load(arrays, token_source)
            self._capture(kind, entry, body)
            self._entries[key] = entry
        else:
            entry.load(arrays, token_source)
        entry.graph.replay()
        COUNTERS.add(entry.launches)
        self.replays[kind] += 1
        if isinstance(entry.output, tuple):
            return tuple(t.clone() for t in entry.output)
        return entry.output.clone()

    def _capture(self, kind: str, entry: _Entry, body) -> None:
        fn = functools.partial(body, entry.static)
        graph = self._graph_factory()
        t0 = time.perf_counter()
        graph.warm(fn)
        before = dict(COUNTERS.launches)
        output = graph.capture(fn)
        recorded = {name: n - before.get(name, 0)
                    for name, n in COUNTERS.launches.items()
                    if n != before.get(name, 0)}
        # Nothing ran while the graph was recorded: take the counts
        # back; every replay adds them.
        COUNTERS.add(recorded, sign=-1)
        if not (isinstance(output, torch.Tensor) or (
                isinstance(output, tuple) and output
                and all(isinstance(t, torch.Tensor) for t in output))):
            raise TypeError("a step graph's body must return a tensor or "
                            "a tuple of tensors")
        entry.graph, entry.output, entry.launches = graph, output, recorded
        self.captures[kind] += 1
        self.capture_seconds[kind] += time.perf_counter() - t0

    def pool_bytes(self) -> int:
        """Device bytes the graphs' shared pool holds (CUDA only)."""
        if self._pool is None:
            return 0
        return sum(seg["total_size"]
                   for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ()))
                   == tuple(self._pool))
