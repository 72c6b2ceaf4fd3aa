"""The collectives of tensor parallelism, written out.

The JAX package has no counterpart: it places weights under
``NamedSharding``s and GSPMD inserts the collectives. Here a rank runs
its shard of every layer and the models call the group themselves
(models/llama.py ``row_parallel``, ``lm_logits``;
models/mixtral.py's expert combine):

- ``all_reduce`` sums the row-parallel partials (attention's output
  projection, the MLP's down projection, the experts' combine), in
  place;
- ``all_gather`` joins the vocab-sharded logits along their last axis
  (and a page read off the ranks' caches along its kv-head axis).

``TPGroup`` rides a ``torch.distributed`` process group: NCCL whenever
each rank has its own card, gloo only where a caller asks for it (two
ranks sharing one card, and the CPU). A step graph may capture NCCL
collectives; capturing one over gloo raises (gloo's collectives run on
the host and cannot be recorded), so a gloo group never turns a
graphed step eager without saying so. ``FakeTPGroup`` is N ranks in one
process, one thread each, for the unit tests: its reduction sums the
ranks' partials in rank order.

Each collective counts one in ``COUNTERS`` under ``tp_all_reduce`` or
``tp_all_gather``, as the kernel wrappers count their launches, so a
step graph's recorded launches show the collectives it captured and
every replay adds them.
"""

from __future__ import annotations

import datetime
import threading
from typing import List, Optional

import torch

from production_stack_tpu_torch.ops.paged_kv_common import COUNTERS

BACKENDS = ("nccl", "gloo")
ALL_REDUCE = "tp_all_reduce"
ALL_GATHER = "tp_all_gather"


def _capturing(t: torch.Tensor) -> bool:
    return t.is_cuda and torch.cuda.is_current_stream_capturing()


class TPGroup:
    """One rank's view of its tensor-parallel group (the default
    process group): ``rank``, ``size`` and its ``backend``."""

    def __init__(self, rank: int, size: int, backend: str):
        if backend not in BACKENDS:
            raise ValueError(f"tp backend must be one of {BACKENDS} "
                             f"(got {backend!r})")
        self.rank, self.size, self.backend = rank, size, backend

    @property
    def capturable(self) -> bool:
        """Whether a step graph may record this group's collectives."""
        return self.backend == "nccl"

    def _check(self, t: torch.Tensor) -> None:
        if not self.capturable and _capturing(t):
            raise RuntimeError(
                f"a {self.backend} collective cannot be captured in a "
                "CUDA graph: run this tp group with cuda_graphs=False, "
                "or give each rank its own card (NCCL)")

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the ranks, in place; returns it."""
        import torch.distributed as dist
        self._check(t)
        dist.all_reduce(t)
        COUNTERS.launched(ALL_REDUCE)
        return t

    def all_gather(self, t: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """The ranks' ``t`` joined along ``dim``, rank order."""
        import torch.distributed as dist
        self._check(t)
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t)
        COUNTERS.launched(ALL_GATHER)
        return torch.cat(parts, dim=dim)


def init_tp_group(rank: int, size: int, backend: str, init_method: str,
                  device: torch.device,
                  timeout_s: float = 600.0) -> TPGroup:
    """Join the default process group (``init_method``
    tcp://host:port, world ``size``) with ``backend`` and return this
    rank's ``TPGroup``. NCCL needs a card a rank (``device``); one
    all-reduce runs at once, eagerly, so the communicator exists before
    any step graph is captured."""
    import torch.distributed as dist
    if backend not in BACKENDS:
        raise ValueError(f"tp backend must be one of {BACKENDS} "
                         f"(got {backend!r})")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("the nccl backend needs a CUDA device a rank")
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, init_method=init_method, world_size=size, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))
    group = TPGroup(rank, size, backend)
    warm = torch.zeros((1,), device=device)
    dist.all_reduce(warm)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return group


class _FakeWorld:
    """The shared state of a FakeTPGroup's ranks: one slot a rank and a
    barrier."""

    def __init__(self, size: int, timeout_s: float):
        self.size = size
        self.slots: List[Optional[torch.Tensor]] = [None] * size
        self.barrier = threading.Barrier(size, timeout=timeout_s)


class FakeTPGroup:
    """One rank of N ranks in one process, each driven from its own
    thread (``FakeTPGroup.world(n)`` makes the N views). Collectives
    meet at a barrier; the reduction sums the partials in rank order,
    so every rank gets the same bits."""

    backend = "fake"
    capturable = False

    def __init__(self, rank: int, world: _FakeWorld):
        self.rank, self.size, self._world = rank, world.size, world

    @staticmethod
    def world(size: int, timeout_s: float = 60.0) -> List["FakeTPGroup"]:
        shared = _FakeWorld(size, timeout_s)
        return [FakeTPGroup(r, shared) for r in range(size)]

    def _exchange(self, t: torch.Tensor) -> List[torch.Tensor]:
        w = self._world
        w.slots[self.rank] = t.clone()
        w.barrier.wait()
        parts = list(w.slots)
        w.barrier.wait()
        return parts

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        parts = self._exchange(t)
        total = parts[0]
        for p in parts[1:]:
            total = total + p
        t.copy_(total)
        COUNTERS.launched(ALL_REDUCE)
        return t

    def all_gather(self, t: torch.Tensor, dim: int = -1) -> torch.Tensor:
        parts = self._exchange(t.contiguous())
        COUNTERS.launched(ALL_GATHER)
        return torch.cat(parts, dim=dim)


def run_ranks(groups, fn):
    """Run ``fn(group)`` for each fake rank in its own thread; returns
    the results in rank order and raises the first rank's error."""
    results: List[object] = [None] * len(groups)
    errors: List[Optional[BaseException]] = [None] * len(groups)

    def main(i):
        try:
            results[i] = fn(groups[i])
        except BaseException as exc:  # re-raised below, in rank order
            errors[i] = exc
            groups[i]._world.barrier.abort()

    threads = [threading.Thread(target=main, args=(i,))
               for i in range(len(groups))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    # A rank's own error first: the others then only saw the barrier
    # broken.
    errors = sorted((e for e in errors if e is not None),
                    key=lambda e: isinstance(e, threading.BrokenBarrierError))
    if errors:
        raise errors[0]
    return results
