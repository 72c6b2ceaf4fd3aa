"""The collectives of tensor, pipeline and context parallelism, written
out.

The JAX package has no counterpart: it places weights under
``NamedSharding``s over a (dp, pp, sp, tp) mesh, GSPMD inserts the
tp collectives and its pp and sp bodies call ``ppermute``/``psum``/
``all_gather`` inside ``shard_map``. Here a rank runs its shard and the
models call its groups themselves:

- tp (models/llama.py ``row_parallel``, ``lm_logits``; models/mixtral.py's
  expert combine): ``all_reduce`` sums the row-parallel partials in
  place; ``all_gather`` joins the vocab-sharded logits along their last
  axis (and a page read off the ranks' caches along its kv-head axis);
- pp (parallel/pipeline_serving.py): ``shift`` is the stage-to-stage hop
  (JAX ``ppermute`` with perm i -> i + 1 mod n: rank r receives rank
  r - 1's tensor); ``masked_sum`` returns the last stage's hidden states
  to every stage (JAX's psum of ``where(stage == S - 1, x, 0)``);
  ``all_gather`` joins a page's layer slices;
- sp (ops/ring_attention.py, parallel/context_serving.py): ``shift``
  rotates a K/V block around the ring; ``all_gather`` joins the ranks'
  sequence shards;
- dp (parallel/context.py's dense forward only; serving has no dp):
  ``all_gather`` joins the ranks' batch shards.

Training (the dense forwards of parallel/context.py and pipeline.py
under autograd) goes through ``hop``, ``gather`` and ``masked_sum``,
``torch.autograd.Function``s over the same collectives, used only while
autograd records (grad mode on and an input that requires grad): every
inference path calls the plain methods and counts what it did before.
Their semantics are those of a replicated loss: every rank holds the
same gathered logits and computes the same scalar. A hop's backward is
the reverse hop (i -> i - 1 mod n, counted ``<axis>_hop_back``); a
gather's takes this rank's slice of the incoming gradient, and a masked
sum's passes it to the keeping rank and zeros to the others, neither
with a collective. ``sync_grads`` then sums the gradients of the
replicated leaves over the data-splitting axes (sp, dp), after which
every rank holds the one-process gradient. A backward collective runs
on every rank of its group in one order or deadlocks, so the forwards
make every training hop record a node that every rank's backward
reaches (``hop``'s ``link``).

``TPGroup`` is one rank's view of one axis group, riding a
``torch.distributed`` process group (the default group, or a subgroup
of the world when several axes are > 1): NCCL whenever each rank has
its own card, gloo only where a caller asks for it (ranks sharing one
card, and the CPU). ``shift`` is an all-gather over the axis from which
each rank keeps its predecessor's part: one collective that NCCL runs
inside a step graph and gloo runs on CUDA tensors (gloo's send/recv
take CPU tensors only, and NCCL refuses two ranks on one card). Whether
a step graph may record a group's collectives is its backend's,
decided up front (``capturable``); capturing one over gloo raises, so a
gloo group never turns a graphed step eager without saying so.
``init_mesh_groups`` joins the world and makes every axis group, every
rank creating each group in one order. ``FakeTPGroup`` is N ranks in
one process, one thread each, for the unit tests (``fake_mesh`` the
groups of a tp x sp x pp world): its reduction sums the ranks' partials
in rank order.

Each collective counts one in ``COUNTERS`` under ``<axis>_all_reduce``,
``<axis>_all_gather``, ``<axis>_hop`` or ``<axis>_sum`` (``tp_all_reduce``,
``pp_hop``, ``sp_all_gather``, ...), as the kernel wrappers count their
launches, so a step graph's recorded launches show the collectives it
captured and every replay adds them.
"""

from __future__ import annotations

import dataclasses
import datetime
import threading
from typing import List, Optional

import torch

from production_stack_tpu_torch.ops.paged_kv_common import COUNTERS

BACKENDS = ("nccl", "gloo")
# Outermost first, as in JAX's AXIS_ORDER (parallel/topology.py).
AXES = ("dp", "pp", "sp", "tp")


def _capturing(t: torch.Tensor) -> bool:
    return t.is_cuda and torch.cuda.is_current_stream_capturing()


class TPGroup:
    """One rank's view of one axis group: ``rank`` and ``size`` along
    ``axis`` ("dp", "pp", "sp" or "tp"), its ``backend`` and its process
    group (``group``; None: the default group, the whole world)."""

    def __init__(self, rank: int, size: int, backend: str,
                 axis: str = "tp", group=None):
        if backend not in BACKENDS:
            raise ValueError(f"tp backend must be one of {BACKENDS} "
                             f"(got {backend!r})")
        if axis not in AXES:
            raise ValueError(f"axis must be one of {AXES} (got {axis!r})")
        self.rank, self.size, self.backend = rank, size, backend
        self.axis, self.group = axis, group

    @property
    def capturable(self) -> bool:
        """Whether a step graph may record this group's collectives."""
        return self.backend == "nccl"

    def _check(self, t: torch.Tensor) -> None:
        if not self.capturable and _capturing(t):
            raise RuntimeError(
                f"a {self.backend} collective cannot be captured in a "
                f"CUDA graph: run this {self.axis} group with "
                "cuda_graphs=False, or give each rank its own card (nccl)")

    def _parts(self, t: torch.Tensor) -> List[torch.Tensor]:
        import torch.distributed as dist
        self._check(t)
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t, group=self.group)
        return parts

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the ranks, in place; returns it."""
        import torch.distributed as dist
        self._check(t)
        dist.all_reduce(t, group=self.group)
        COUNTERS.launched(f"{self.axis}_all_reduce")
        return t

    def all_gather(self, t: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """The ranks' ``t`` joined along ``dim``, rank order."""
        parts = self._parts(t)
        COUNTERS.launched(f"{self.axis}_all_gather")
        return torch.cat(parts, dim=dim)

    def shift(self, t: torch.Tensor) -> torch.Tensor:
        """The previous rank's ``t`` (rank 0 gets the last rank's): JAX
        ``ppermute`` with perm i -> i + 1 mod n."""
        parts = self._parts(t)
        COUNTERS.launched(f"{self.axis}_hop")
        return parts[(self.rank - 1) % self.size]

    def shift_back(self, t: torch.Tensor) -> torch.Tensor:
        """The next rank's ``t`` (the last rank gets rank 0's): the
        reverse hop, i -> i - 1 mod n, a hop's backward."""
        parts = self._parts(t)
        COUNTERS.launched(f"{self.axis}_hop_back")
        return parts[(self.rank + 1) % self.size]

    def masked_sum(self, t: torch.Tensor, keep: bool) -> torch.Tensor:
        """The sum over the ranks of ``t`` where ``keep``, zeros
        elsewhere: with one keeping rank, its ``t`` on every rank."""
        import torch.distributed as dist
        out = t.clone() if keep else torch.zeros_like(t)
        self._check(out)
        dist.all_reduce(out, group=self.group)
        COUNTERS.launched(f"{self.axis}_sum")
        return out


@dataclasses.dataclass
class MeshGroups:
    """A rank's groups along the axes of a dp x pp x sp x tp world, None
    along an axis of size 1 (dp is the dense training forward's only)."""

    tp: Optional[object] = None
    pp: Optional[object] = None
    sp: Optional[object] = None
    dp: Optional[object] = None

    def _groups(self) -> list:
        return [g for g in (self.tp, self.pp, self.sp, self.dp)
                if g is not None]

    @property
    def capturable(self) -> bool:
        """Whether a step graph may record every group's collectives."""
        return all(g.capturable for g in self._groups())

    def abort(self) -> None:
        """Release the fake ranks waiting on these groups."""
        for g in self._groups():
            g.abort()


def axis_ranks(axis: str, tp: int = 1, pp: int = 1, sp: int = 1,
               dp: int = 1) -> List[List[int]]:
    """The global ranks of each group along ``axis``, the mesh laid out
    (dp, pp, sp, tp) with tp fastest (``parallel/topology.AXIS_ORDER``):
    rank = ((dp_index * pp + pp_index) * sp + sp_index) * tp + tp_index.
    dp defaults to 1, so a serving world is laid out as (pp, sp, tp)."""
    if axis not in AXES:
        raise ValueError(f"axis must be one of {AXES} (got {axis!r})")
    groups = {}
    for r in range(dp * pp * sp * tp):
        key = tuple(v for a, v in rank_coords(r, tp, pp, sp, dp).items()
                    if a != axis)
        groups.setdefault(key, []).append(r)
    return [groups[k] for k in sorted(groups)]


def rank_coords(rank: int, tp: int = 1, pp: int = 1, sp: int = 1,
                dp: int = 1) -> dict:
    """(dp, pp, sp, tp) indices of global ``rank``."""
    return {"dp": rank // (pp * sp * tp), "pp": rank // (sp * tp) % pp,
            "sp": rank // tp % sp, "tp": rank % tp}


def init_mesh_groups(rank: int, backend: str, init_method: Optional[str],
                     device: torch.device, tp: int = 1, pp: int = 1,
                     sp: int = 1, timeout_s: float = 600.0,
                     store=None, dp: int = 1) -> MeshGroups:
    """Join the default process group (``init_method`` tcp://host:port,
    or a rendezvous ``store`` already made; world dp x pp x sp x tp)
    with ``backend`` and return this rank's groups.
    An axis that spans the whole world rides the default group; with
    two axes > 1 every rank creates every group of each axis in one
    order (``dist.new_group``'s rule). NCCL needs a card a rank
    (``device``); one all-reduce runs on each group at once, eagerly,
    so its communicator exists before any step graph is captured."""
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
    size = dp * tp * pp * sp
    dist.init_process_group(
        backend, init_method=init_method, store=store, world_size=size,
        rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
    sizes = {"dp": dp, "pp": pp, "sp": sp, "tp": tp}
    groups = MeshGroups()
    for axis in AXES:
        if sizes[axis] == 1:
            continue
        mine = None
        for ranks in axis_ranks(axis, tp=tp, pp=pp, sp=sp, dp=dp):
            handle = (None if len(ranks) == size else dist.new_group(
                ranks, backend=backend,
                timeout=datetime.timedelta(seconds=timeout_s)))
            if rank in ranks:
                mine = TPGroup(ranks.index(rank), sizes[axis], backend,
                               axis=axis, group=handle)
        setattr(groups, axis, mine)
    warm = torch.zeros((1,), device=device)
    dist.all_reduce(warm)
    for g in (groups.dp, groups.pp, groups.sp, groups.tp):
        if g is not None:
            dist.all_reduce(warm, group=g.group)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return groups


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

    def __init__(self, rank: int, world: _FakeWorld, axis: str = "tp"):
        self.rank, self.size, self._world = rank, world.size, world
        self.axis = axis

    @staticmethod
    def world(size: int, timeout_s: float = 60.0,
              axis: str = "tp") -> List["FakeTPGroup"]:
        shared = _FakeWorld(size, timeout_s)
        return [FakeTPGroup(r, shared, axis) for r in range(size)]

    def abort(self) -> None:
        self._world.barrier.abort()

    def _exchange(self, t: torch.Tensor) -> List[torch.Tensor]:
        # Detached: no rank's autograd graph reaches another thread's.
        w = self._world
        w.slots[self.rank] = t.detach().clone()
        w.barrier.wait()
        parts = list(w.slots)
        w.barrier.wait()
        return parts

    def _sum(self, t: torch.Tensor) -> torch.Tensor:
        parts = self._exchange(t)
        total = parts[0]
        for p in parts[1:]:
            total = total + p
        return t.copy_(total)

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        self._sum(t)
        COUNTERS.launched(f"{self.axis}_all_reduce")
        return t

    def all_gather(self, t: torch.Tensor, dim: int = -1) -> torch.Tensor:
        parts = self._exchange(t.contiguous())
        COUNTERS.launched(f"{self.axis}_all_gather")
        return torch.cat(parts, dim=dim)

    def shift(self, t: torch.Tensor) -> torch.Tensor:
        parts = self._exchange(t.contiguous())
        COUNTERS.launched(f"{self.axis}_hop")
        return parts[(self.rank - 1) % self.size]

    def shift_back(self, t: torch.Tensor) -> torch.Tensor:
        parts = self._exchange(t.contiguous())
        COUNTERS.launched(f"{self.axis}_hop_back")
        return parts[(self.rank + 1) % self.size]

    def masked_sum(self, t: torch.Tensor, keep: bool) -> torch.Tensor:
        out = self._sum(t.clone() if keep else torch.zeros_like(t))
        COUNTERS.launched(f"{self.axis}_sum")
        return out


def fake_mesh(tp: int = 1, pp: int = 1, sp: int = 1,
              timeout_s: float = 60.0, dp: int = 1) -> List[MeshGroups]:
    """Each global rank's MeshGroups of a fake dp x pp x sp x tp world,
    in rank order (``axis_ranks``'s layout), for threads of one
    process."""
    sizes = {"dp": dp, "pp": pp, "sp": sp, "tp": tp}
    out = [MeshGroups() for _ in range(dp * tp * pp * sp)]
    for axis in AXES:
        if sizes[axis] == 1:
            continue
        for ranks in axis_ranks(axis, tp=tp, pp=pp, sp=sp, dp=dp):
            views = FakeTPGroup.world(len(ranks), timeout_s, axis)
            for view, r in zip(views, ranks):
                setattr(out[r], axis, view)
    return out


# ---- autograd over the collectives (training) --------------------------------


def recording(*tensors) -> bool:
    """Whether autograd records an op on ``tensors``: grad mode on and
    one of them requires grad."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


class _Hop(torch.autograd.Function):
    """``shift`` forward, the reverse hop backward; a ``link`` rides
    along unchanged, its gradient passing straight through."""

    @staticmethod
    def forward(ctx, group, t, *link):
        ctx.group = group
        return (group.shift(t),) + tuple(x.clone() for x in link)

    @staticmethod
    def backward(ctx, grad, *link_grads):
        return (None, ctx.group.shift_back(grad)) + link_grads


class _Gather(torch.autograd.Function):
    """``all_gather`` along ``dim`` forward; backward this rank's slice
    of the (replicated) gradient, no collective."""

    @staticmethod
    def forward(ctx, group, t, dim):
        ctx.rank, ctx.dim, ctx.width = group.rank, dim, t.shape[dim]
        return group.all_gather(t, dim=dim)

    @staticmethod
    def backward(ctx, grad):
        return None, grad.narrow(ctx.dim, ctx.rank * ctx.width,
                                 ctx.width), None


class _MaskedSum(torch.autograd.Function):
    """``masked_sum`` forward; backward the (replicated) gradient to the
    keeping rank and zeros to the others, no collective."""

    @staticmethod
    def forward(ctx, group, t, keep):
        ctx.keep = keep
        return group.masked_sum(t, keep)

    @staticmethod
    def backward(ctx, grad):
        return None, grad if ctx.keep else torch.zeros_like(grad), None


def hop(group, t: torch.Tensor, link: Optional[torch.Tensor] = None):
    """``group.shift(t)``, differentiable while autograd records. With
    ``link`` (a 0-dim tensor that requires grad, threaded from hop to
    hop and into what every rank's loss reads) returns (shifted, link):
    the hop then records even where ``t`` needs no gradient (a bubble),
    and every rank's backward takes every reverse hop, in reverse order,
    whether or not the shifted tensor was used."""
    links = () if link is None else (link,)
    if not recording(t, *links):
        out = group.shift(t)
        return out if link is None else (out, link)
    out = _Hop.apply(group, t, *links)
    return out[0] if link is None else out


def gather(group, t: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``group.all_gather(t, dim)``, differentiable while autograd
    records."""
    if not recording(t):
        return group.all_gather(t, dim=dim)
    return _Gather.apply(group, t, dim)


def masked_sum(group, t: torch.Tensor, keep: bool) -> torch.Tensor:
    """``group.masked_sum(t, keep)``, differentiable while autograd
    records."""
    if not recording(t):
        return group.masked_sum(t, keep)
    return _MaskedSum.apply(group, t, keep)


def sync_grads(params, *groups) -> None:
    """Sum, in place, the gradients of ``params``' leaves over each of
    ``groups`` (the data-splitting axes, sp and dp; None skipped), one
    all-reduce a leaf that has a gradient. After a replicated-loss
    backward every rank then holds the one-process gradient of the
    whole batch. Every rank of a group must hold gradients on the same
    leaves."""
    leaves = [p.grad for p in params.parameters() if p.grad is not None]
    for group in groups:
        if group is None:
            continue
        for g in leaves:
            group.all_reduce(g)


def run_ranks(groups, fn):
    """Run ``fn(group)`` for each fake rank in its own thread (``groups``
    FakeTPGroups, or a ``fake_mesh``'s MeshGroups); returns the results
    in rank order and raises the first rank's error."""
    results: List[object] = [None] * len(groups)
    errors: List[Optional[BaseException]] = [None] * len(groups)

    def main(i):
        try:
            results[i] = fn(groups[i])
        except BaseException as exc:  # re-raised below, in rank order
            errors[i] = exc
            for g in groups:
                g.abort()

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
