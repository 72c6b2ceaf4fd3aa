"""The step bridge of tensor, pipeline and context parallelism: one
scheduler, N ranks.

The JAX package's ``parallel/distributed.py`` (``MultihostStepBridge``)
in the port. Rank 0, the server's process, owns the scheduler, the page
allocator and the engine; ranks 1..N-1 own only a runner holding their
shard. Before rank 0 runs a step it publishes the step's host payload
(the numpy inputs) and a description of its body (kind, shape, step
function, options, whether its tokens come from the step before); the
other ranks run ``worker_loop``, receive each record and replay the
same runner call on their own card (``ModelRunner.execute``). All ranks
then meet in the same collectives in the same order, with identical
inputs, and no per-step consensus is needed. Adapter installs, the
guided-decoding tables and the pooled routes' encode chunks ride the
same records.

The bridge speaks through an endpoint: ``TorchBroadcastEndpoint`` (a
``torch.distributed`` gloo group beside the tp group: the records are
host objects, and an idle server's workers wait on it for as long as
it stays idle), or ``FakeTransport``'s in-process queues, with which
the tests drive the real publish/worker_loop sequence, message check
and follower ordering included, without processes.

``start_parallel`` is how the server starts a tp x sp x pp engine
(``ParallelConfig``'s sizes): it spawns ranks 1..N-1 (one card each,
``torch.multiprocessing`` spawn), joins rank 0 to the world, makes
every rank's axis groups (parallel/collectives.init_mesh_groups) and
returns the groups, the bridge and the handle that tears the workers
down (``TensorParallelRuntime.close``). Each worker makes its own
stage's (pp) or replica's (sp) tp shard and replays every record: a
pipeline step's hops and sum, a context-parallel prefill's ring, and
the page reads and writes that join or cut a page over the stages.
This is single-host SPMD: the JAX bridge's multi-host half (its slice
liveness, ``init_distributed`` and the ``--distributed``,
``--coordinator-address``, ``--num-processes`` and ``--process-id``
flags) is not ported yet.
"""

from __future__ import annotations

import copy
import datetime
import queue
import socket
import threading
import time
from typing import List, Optional, Sequence

import torch

from production_stack_tpu_torch.parallel.collectives import (
    MeshGroups,
    init_mesh_groups,
    rank_coords,
)
from production_stack_tpu_torch.utils.log import init_logger

logger = init_logger(__name__)

KIND_SHUTDOWN = 0
KIND_RECORD = 1

# An idle server's workers wait on the bridge between requests: its
# group's timeout is that long.
BRIDGE_TIMEOUT = datetime.timedelta(days=365)


# ---- transports --------------------------------------------------------


class TorchBroadcastEndpoint:
    """Real transport: rank 0's value reaches every rank through
    ``broadcast_object_list`` on ``group`` (a gloo group). A collective:
    its completion means every rank took part."""

    def __init__(self, group=None):
        self.group = group

    @property
    def process_index(self) -> int:
        import torch.distributed as dist
        return dist.get_rank()

    def broadcast(self, value):
        import torch.distributed as dist
        box = [value if self.process_index == 0 else None]
        dist.broadcast_object_list(box, src=0, group=self.group)
        return box[0]


class FakeTransport:
    """In-process stand-in for the broadcast: one queue per follower.
    ``endpoint(i)`` is process i's view: 0 publishes, 1..N-1 receive in
    their own threads."""

    def __init__(self, num_processes: int):
        if num_processes < 2:
            raise ValueError("FakeTransport needs >= 2 processes")
        self.num_processes = num_processes
        self._queues = [queue.Queue() for _ in range(num_processes)]

    def endpoint(self, process_index: int) -> "_FakeEndpoint":
        return _FakeEndpoint(self, process_index)


class _FakeEndpoint:
    def __init__(self, transport: FakeTransport, process_index: int):
        self._transport = transport
        self.process_index = process_index
        # Enough for a slow test machine, short enough that a wedged
        # test fails instead of hanging.
        self.recv_timeout_s = 30.0

    def broadcast(self, value):
        if self.process_index == 0:
            for q in self._transport._queues[1:]:
                q.put(copy.deepcopy(value))
            return value
        return self._transport._queues[self.process_index].get(
            timeout=self.recv_timeout_s)


# ---- the bridge ----------------------------------------------------------


class StepBridge:
    """Rank 0 -> ranks 1..N-1 broadcast of each record the runner
    publishes, one message a record: (kind, sequence number, record, a
    dict of host values). Followers execute the records in the order
    published.

    ``lock`` makes publish-and-run atomic on rank 0: the engine loop's
    steps and an HTTP thread's adapter install must reach the ranks, and
    their collectives, in one order."""

    def __init__(self, runner, endpoint):
        self.runner = runner
        self.endpoint = endpoint
        self.lock = threading.RLock()
        self.published = 0

    # -- rank 0 ---------------------------------------------------------------

    def publish(self, record: dict) -> None:
        self.endpoint.broadcast((KIND_RECORD, self.published, record))
        self.published += 1

    def shutdown(self) -> None:
        """Release the followers from their loop."""
        with self.lock:
            self.endpoint.broadcast((KIND_SHUTDOWN, self.published, None))

    # -- followers -------------------------------------------------------------

    def worker_loop(self) -> int:
        """Receive and execute records until shutdown; returns how many
        were executed."""
        pid = self.endpoint.process_index
        logger.info("tp rank %d entering its step loop", pid)
        seq = 0
        while True:
            message = self.endpoint.broadcast(None)
            if not (isinstance(message, tuple) and len(message) == 3
                    and message[0] in (KIND_RECORD, KIND_SHUTDOWN)):
                raise ValueError(f"tp rank {pid}: a message that does not "
                                 f"match (kind, seq, record): {message!r}")
            kind, sent, record = message
            if kind == KIND_SHUTDOWN:
                logger.info("tp rank %d shutting down after %d records",
                            pid, seq)
                return seq
            if sent != seq:
                raise RuntimeError(f"tp rank {pid} expected record {seq}, "
                                   f"got {sent}")
            self.runner.execute(record)
            seq += 1


# ---- processes ------------------------------------------------------------


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _sizes(config) -> dict:
    par = config.parallel
    return {"tp": par.tensor_parallel_size,
            "sp": par.context_parallel_size,
            "pp": par.pipeline_parallel_size}


def _load_params(config, weights: Optional[str], device: torch.device,
                 rank: int):
    """Global rank ``rank``'s part of a checkpoint directory's weights:
    its stage's layers (pp) of its tp shard (every rank reads the
    checkpoint and keeps its own part of each module); or None (random,
    from the config's seed: the runner draws the same full leaves on
    every rank and keeps its part)."""
    if weights is None:
        return None
    from production_stack_tpu_torch.engine.weights import load_weights
    from production_stack_tpu_torch.parallel.mesh import stage_layers
    sizes = _sizes(config)
    at = rank_coords(rank, **sizes)
    layers = (None if sizes["pp"] == 1 else stage_layers(
        config.model.num_hidden_layers, at["pp"], sizes["pp"]))
    return load_weights(weights, config.model, device=device,
                        rank=at["tp"], tp=sizes["tp"], layers=layers)


def _join_groups(config, rank: int, device: torch.device, backend: str,
                 init_method: str):
    """The rank's axis groups and the bridge's gloo group beside them."""
    import torch.distributed as dist
    groups = init_mesh_groups(rank, backend, init_method, device,
                              **_sizes(config))
    bridge_group = dist.new_group(backend="gloo", timeout=BRIDGE_TIMEOUT)
    return groups, bridge_group


def worker_main(config, weights: Optional[str], rank: int, device: str,
                backend: str, init_method: str, cuda_graphs: bool,
                report=None) -> None:
    """Rank ``rank`` > 0: join the groups, build the runner on the
    rank's shard (its stage under pp, a replica under sp) and replay
    rank 0's records until shutdown; then put (rank, the kernel launch
    counts of the rank's run) on ``report``."""
    import torch.distributed as dist
    from production_stack_tpu_torch.engine.model_runner import ModelRunner
    from production_stack_tpu_torch.ops.paged_kv_common import COUNTERS
    dev = torch.device(device)
    groups, bridge_group = _join_groups(config, rank, dev, backend,
                                        init_method)
    try:
        runner = ModelRunner(config, params=_load_params(config, weights,
                                                         dev, rank),
                             device=dev, cuda_graphs=cuda_graphs,
                             tp=groups.tp, pp=groups.pp, sp=groups.sp)
        StepBridge(runner, TorchBroadcastEndpoint(bridge_group)
                   ).worker_loop()
        if runner.graphs is not None:
            # Before the group goes: the graphs may hold its collectives.
            runner.graphs.release()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        if report is not None:
            report.put((rank, dict(COUNTERS.launches)))
    finally:
        dist.destroy_process_group()


class TensorParallelRuntime:
    """Rank 0's side of a parallel engine: ``groups`` (its
    MeshGroups), ``bridge`` (the runner publishes through it) and the
    worker processes. ``close`` releases the workers and waits for
    them."""

    def __init__(self, groups: MeshGroups, bridge: StepBridge,
                 procs: List, devices: Sequence[torch.device],
                 report=None):
        self.groups, self.bridge = groups, bridge
        self.procs = procs
        self.devices = list(devices)
        self.closed = False
        self._report = report
        # After close: each worker rank's kernel launch counts over its
        # run ({rank: {counter: launches}}).
        self.worker_launches = {}

    def engine_args(self) -> dict:
        """The LLMEngine arguments of rank 0 (its groups, the bridge,
        this runtime)."""
        return {"tp": self.groups.tp, "pp": self.groups.pp,
                "sp": self.groups.sp, "bridge": self.bridge,
                "tp_runtime": self,
                "cuda_graphs": self.groups.capturable}

    def close(self, timeout_s: float = 30.0) -> None:
        """Release the workers, wait for them and leave the world. Each
        stage is bounded by ``timeout_s``: a bridge or a process group
        that does not let go raises (the workers stopped first) rather
        than hang the caller."""
        import torch.distributed as dist
        if self.closed:
            return
        self.closed = True
        try:
            _bounded(self.bridge.shutdown, timeout_s,
                     "the step bridge's shutdown record")
            deadline = time.monotonic() + timeout_s
            while (self._report is not None
                   and len(self.worker_launches) < len(self.procs)):
                try:
                    rank, counts = self._report.get(
                        timeout=max(0.1, deadline - time.monotonic()))
                except queue.Empty:
                    break
                self.worker_launches[rank] = counts
        finally:
            _stop(self.procs, timeout_s)
            if dist.is_initialized():
                _bounded(dist.destroy_process_group, timeout_s,
                         "rank 0's process group teardown (a collective "
                         "left in flight, or a step graph still holding "
                         "its communicator)")


def _bounded(fn, timeout_s: float, what: str) -> None:
    """Run ``fn`` on a daemon thread; raise if it does not return
    within ``timeout_s`` (the thread is left blocked), and re-raise
    what it raised."""
    failure: List[BaseException] = []

    def call():
        try:
            fn()
        except BaseException as e:  # re-raised on the caller's thread
            failure.append(e)

    t = threading.Thread(target=call, name="parallel-close", daemon=True)
    t.start()
    t.join(timeout_s)
    if t.is_alive():
        raise RuntimeError(f"{what} did not finish in {timeout_s} s")
    if failure:
        raise failure[0]


def _stop(procs, timeout_s: float) -> None:
    deadline = time.monotonic() + timeout_s
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    for p in procs:
        if p.is_alive():
            p.terminate()
            p.join(5.0)
        if p.is_alive():
            p.kill()
            p.join()


def start_parallel(config, devices: Sequence[torch.device],
                   backend: Optional[str] = None,
                   weights: Optional[str] = None,
                   cuda_graphs: Optional[bool] = None
                   ) -> TensorParallelRuntime:
    """Spawn ranks 1..N-1 of the config's tp x sp x pp world on
    ``devices[1:]`` (N = ``ParallelConfig.world_size``, global rank
    order (pp, sp, tp), tp fastest) and join rank 0 (this process, on
    ``devices[0]``). ``backend``: NCCL when every rank has its own
    card, which is the default on CUDA devices; gloo is taken only
    where the caller names it (ranks sharing one card) or on the CPU.
    ``weights``: a checkpoint directory every rank reads, or None for
    random weights from the config's seed. ``cuda_graphs``: the step
    graphs on every rank (default: on exactly when the backend is
    NCCL). A failed start stops the workers before it raises."""
    devices = [torch.device(d) for d in devices]
    size = len(devices)
    if size < 2:
        raise ValueError("a parallel engine needs at least two ranks")
    if size != config.parallel.world_size:
        raise ValueError(
            f"{size} devices for a world of {config.parallel.world_size} "
            "ranks (tensor x context x pipeline parallel sizes)")
    cuda = devices[0].type == "cuda"
    if backend is None:
        if cuda and len({str(d) for d in devices}) < size:
            raise ValueError(
                "ranks that share a card need an explicit backend "
                "('gloo'); NCCL refuses two ranks on one device")
        backend = "nccl" if cuda else "gloo"
    if cuda_graphs is None:
        cuda_graphs = backend == "nccl"
    init_method = f"tcp://127.0.0.1:{free_port()}"
    ctx = torch.multiprocessing.get_context("spawn")
    report = ctx.Queue()
    procs = [ctx.Process(
        target=worker_main, daemon=True,
        args=(config, weights, rank, str(devices[rank]), backend,
              init_method, cuda_graphs, report))
        for rank in range(1, size)]
    for p in procs:
        p.start()
    try:
        groups, bridge_group = _join_groups(config, 0, devices[0], backend,
                                            init_method)
    except BaseException:
        _stop(procs, 0.0)
        raise
    bridge = StepBridge(None, TorchBroadcastEndpoint(bridge_group))
    logger.info("parallel engine: %s ranks (tp x sp x pp) over %s on %s",
                "x".join(str(n) for n in _sizes(config).values()), backend,
                ", ".join(str(d) for d in devices))
    return TensorParallelRuntime(groups, bridge, procs, devices, report)
