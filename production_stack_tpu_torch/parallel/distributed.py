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

Multi-host serving (``--distributed``) is the same world over several
server processes, one a host: ``init_distributed`` takes the
coordinator's address, the process count and this process's id, and
``start_distributed`` joins the process's ranks, ``p * L .. p * L + L -
1`` of the world's tp x sp x pp (``L`` = world / processes, global rank
order unchanged), spawning the process's other L - 1 ranks as
``start_parallel`` does. Process 0's first rank is the coordinator: it
serves HTTP and publishes; every other process's first rank runs
``worker_main``'s loop and never serves. Before any group is made each
rank publishes its card's identity (host name and device UUID) through
the rendezvous store: NCCL when every rank has a card of its own, gloo
otherwise (two processes sharing one card, the CPU). ``SliceLiveness``
is the JAX ledger of which slices (``parallel/topology.slice_of_process``)
were seen within ``timeout_s``: over the real broadcast a completed
record marks every slice live (a collective completes only if every
rank took part), over ``FakeTransport`` each follower acks the records
it ran. An idle server's slices therefore read dead once ``timeout_s``
passes with no step, as they do in JAX.
"""

from __future__ import annotations

import copy
import dataclasses
import datetime
import json
import queue
import socket
import threading
import time
from typing import Dict, List, Optional, Sequence

import torch

from production_stack_tpu_torch.parallel.collectives import (
    MeshGroups,
    init_mesh_groups,
    rank_coords,
)
from production_stack_tpu_torch.parallel.topology import slice_of_process
from production_stack_tpu_torch.utils.log import init_logger

logger = init_logger(__name__)

KIND_SHUTDOWN = 0
KIND_RECORD = 1

# An idle server's workers wait on the bridge between requests: its
# group's timeout is that long.
BRIDGE_TIMEOUT = datetime.timedelta(days=365)
# How long a distributed world's ranks wait for each other to arrive.
RENDEZVOUS_TIMEOUT = datetime.timedelta(seconds=300)


# ---- liveness ----------------------------------------------------------


class SliceLiveness:
    """Per-slice liveness ledger (JAX's): a slice is live while at
    least one of its processes was seen within ``timeout_s``. Fed by
    follower acks (``FakeTransport``) or a completed collective (the
    real broadcast), so a dead host names ONE slice on /metrics."""

    def __init__(self, num_slices: int = 1, timeout_s: float = 10.0):
        self.num_slices = max(1, int(num_slices))
        self.timeout_s = timeout_s
        now = time.monotonic()
        self._last: Dict[int, float] = {
            i: now for i in range(self.num_slices)}
        self._lock = threading.Lock()

    def heartbeat(self, slice_id: int,
                  now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else now
        with self._lock:
            if slice_id in self._last:
                self._last[slice_id] = max(self._last[slice_id], now)

    def mark_all(self, now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else now
        with self._lock:
            for i in self._last:
                self._last[i] = max(self._last[i], now)

    def snapshot(self, now: Optional[float] = None) -> Dict[int, bool]:
        """slice_id -> live?"""
        now = time.monotonic() if now is None else now
        with self._lock:
            return {i: (now - t) <= self.timeout_s
                    for i, t in sorted(self._last.items())}

    def dead_slices(self, now: Optional[float] = None) -> List[int]:
        return [i for i, live in self.snapshot(now).items() if not live]


# ---- transports --------------------------------------------------------


class TorchBroadcastEndpoint:
    """Real transport: rank 0's value reaches every rank through
    ``broadcast_object_list`` on ``group`` (a gloo group). A collective:
    its completion means every rank took part, so it needs no acks."""

    collective = True

    def __init__(self, group=None):
        self.group = group

    @property
    def process_index(self) -> int:
        import torch.distributed as dist
        return dist.get_rank()

    @property
    def num_processes(self) -> int:
        import torch.distributed as dist
        return dist.get_world_size()

    def broadcast(self, value):
        import torch.distributed as dist
        box = [value if self.process_index == 0 else None]
        dist.broadcast_object_list(box, src=0, group=self.group)
        return box[0]

    def ack(self, seq: int) -> None:
        del seq  # the collective already met every rank

    def drain_acks(self) -> list:
        return []


class FakeTransport:
    """In-process stand-in for the broadcast: one queue per follower and
    a shared ack queue back to the publisher. ``endpoint(i)`` is process
    i's view: 0 publishes, 1..N-1 receive in their own threads."""

    def __init__(self, num_processes: int):
        if num_processes < 2:
            raise ValueError("FakeTransport needs >= 2 processes")
        self.num_processes = num_processes
        self._queues = [queue.Queue() for _ in range(num_processes)]
        self._acks: "queue.Queue" = queue.Queue()

    def endpoint(self, process_index: int) -> "_FakeEndpoint":
        return _FakeEndpoint(self, process_index)


class _FakeEndpoint:
    collective = False

    def __init__(self, transport: FakeTransport, process_index: int):
        self._transport = transport
        self.process_index = process_index
        self.num_processes = transport.num_processes
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

    def ack(self, seq: int) -> None:
        self._transport._acks.put(
            (self.process_index, seq, time.monotonic()))

    def drain_acks(self) -> list:
        out = []
        while True:
            try:
                out.append(self._transport._acks.get_nowait())
            except queue.Empty:
                return out


# ---- the bridge ----------------------------------------------------------


class StepBridge:
    """Rank 0 -> ranks 1..N-1 broadcast of each record the runner
    publishes, one message a record: (kind, sequence number, record, a
    dict of host values). Followers execute the records in the order
    published and ack each one.

    ``lock`` makes publish-and-run atomic on rank 0: the engine loop's
    steps and an HTTP thread's adapter install must reach the ranks, and
    their collectives, in one order. ``num_slices`` sizes the liveness
    ledger; processes map to slices contiguously, slice-major
    (``parallel/topology.slice_of_process``)."""

    def __init__(self, runner, endpoint, num_slices: int = 1,
                 liveness_timeout_s: float = 10.0):
        self.runner = runner
        self.endpoint = endpoint
        self.lock = threading.RLock()
        self.published = 0
        self.num_slices = max(1, int(num_slices))
        self.liveness = SliceLiveness(self.num_slices, liveness_timeout_s)

    def slice_of_process(self, process_index: int) -> int:
        """The slice of a process (contiguous, slice-major)."""
        return slice_of_process(process_index, self.endpoint.num_processes,
                                self.num_slices)

    # -- rank 0 ---------------------------------------------------------------

    def publish(self, record: dict) -> None:
        self._send(KIND_RECORD, record)

    def _send(self, kind: int, record) -> None:
        self.endpoint.broadcast((kind, self.published, record))
        if kind == KIND_RECORD:
            self.published += 1
        if self.endpoint.collective:
            # A completed broadcast: every rank took part.
            self.liveness.mark_all()
        else:
            # The publisher's own slice is live; the followers' acks
            # speak for theirs.
            self.liveness.heartbeat(self.slice_of_process(
                self.endpoint.process_index))
            self.pump_acks()

    def pump_acks(self) -> None:
        """Fold the followers' acks into the liveness ledger."""
        for process_index, _seq, when in self.endpoint.drain_acks():
            self.liveness.heartbeat(self.slice_of_process(process_index),
                                    when)

    def check_liveness(self) -> Dict[int, bool]:
        """slice_id -> live, the pending acks drained first (what the
        /metrics slice gauges render)."""
        self.pump_acks()
        return self.liveness.snapshot()

    def shutdown(self) -> None:
        """Release the followers from their loop."""
        with self.lock:
            self._send(KIND_SHUTDOWN, None)

    # -- followers -------------------------------------------------------------

    def worker_loop(self) -> int:
        """Receive and execute records until shutdown, acking each;
        returns how many were executed."""
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
            self.endpoint.ack(seq)


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


def card_identity(device: torch.device) -> str:
    """What tells one rank's card from another's across hosts: the host
    name and the device's UUID; "cpu" for a CPU rank."""
    if device.type != "cuda":
        return "cpu"
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    return (f"{socket.gethostname()}/"
            f"{torch.cuda.get_device_properties(index).uuid}")


def choose_backend(identities: Sequence[str]) -> str:
    """The world's backend from its ranks' card identities: NCCL when
    every rank has a card of its own, gloo when a card is named twice
    (NCCL refuses two ranks on one device) or a rank is on the CPU."""
    if "cpu" in identities or len(set(identities)) < len(identities):
        return "gloo"
    return "nccl"


def _rendezvous(address: str, rank: int, world: int,
                device: torch.device):
    """(store, backend) of a distributed world: the rendezvous store at
    ``address`` (host:port; global rank 0 hosts it), where each rank
    publishes its card's identity and reads everyone's before any group
    is made. A rank that does not arrive within RENDEZVOUS_TIMEOUT
    raises."""
    import torch.distributed as dist
    host, _, port = address.rpartition(":")
    store = dist.TCPStore(host, int(port), world_size=world,
                          is_master=rank == 0, timeout=RENDEZVOUS_TIMEOUT,
                          wait_for_workers=False)
    store.set(f"card/{rank}", card_identity(device))
    keys = [f"card/{r}" for r in range(world)]
    store.wait(keys)
    backend = choose_backend([store.get(k).decode() for k in keys])
    return dist.PrefixStore("world", store), backend


def _join_groups(config, rank: int, device: torch.device,
                 backend: Optional[str], init_method: str):
    """The rank's axis groups, the bridge's gloo group beside them and
    the world's backend. ``backend`` None: a distributed world, whose
    backend the ranks' cards decide at the rendezvous store
    ``init_method`` names (tcp://host:port)."""
    import torch.distributed as dist
    store = None
    if backend is None:
        store, backend = _rendezvous(
            init_method.removeprefix("tcp://"), rank,
            config.parallel.world_size, device)
        init_method = None
    groups = init_mesh_groups(rank, backend, init_method, device,
                              store=store, **_sizes(config))
    bridge_group = dist.new_group(backend="gloo", timeout=BRIDGE_TIMEOUT)
    return groups, bridge_group, backend


def worker_main(config, weights: Optional[str], rank: int, device: str,
                backend: Optional[str], init_method: str,
                cuda_graphs: Optional[bool], report=None) -> dict:
    """Rank ``rank`` > 0: join the groups, build the runner on the
    rank's shard (its stage under pp, a replica under sp) and replay
    rank 0's records until shutdown; then put (rank, the kernel launch
    counts of the rank's run, its split ragged rows:
    ``ModelRunner.sp_split_rows``) on ``report`` and return the
    counts.
    ``backend`` None: a distributed world (``_join_groups``);
    ``cuda_graphs`` None: on exactly when the backend is NCCL."""
    import torch.distributed as dist
    from production_stack_tpu_torch.engine.model_runner import ModelRunner
    from production_stack_tpu_torch.ops.paged_kv_common import COUNTERS
    dev = torch.device(device)
    groups, bridge_group, backend = _join_groups(config, rank, dev, backend,
                                                 init_method)
    if cuda_graphs is None:
        cuda_graphs = backend == "nccl"
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
        counts = dict(COUNTERS.launches)
        if report is not None:
            report.put((rank, counts, runner.sp_split_rows))
        return counts
    finally:
        dist.destroy_process_group()


class TensorParallelRuntime:
    """Rank 0's side of a parallel engine: ``groups`` (its
    MeshGroups), ``bridge`` (the runner publishes through it) and the
    worker processes. ``close`` releases the workers and waits for
    them."""

    def __init__(self, groups: MeshGroups, bridge: StepBridge,
                 procs: List, devices: Sequence[torch.device],
                 report=None,
                 process: Optional["DistributedProcess"] = None):
        self.groups, self.bridge = groups, bridge
        # A multi-host world's process 0: this process's place in it
        # (its ``procs`` are its own ranks only; the other processes
        # leave when the shutdown record reaches them).
        self.process = process
        self.procs = procs
        self.devices = list(devices)
        self.closed = False
        self._report = report
        # After close: each worker rank's kernel launch counts over its
        # run ({rank: {counter: launches}}) and its split ragged rows
        # ({rank: ModelRunner.sp_split_rows}).
        self.worker_launches = {}
        self.worker_split_rows = {}

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
                    rank, counts, split = self._report.get(
                        timeout=max(0.1, deadline - time.monotonic()))
                except queue.Empty:
                    break
                self.worker_launches[rank] = counts
                self.worker_split_rows[rank] = split
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
    procs, report = _spawn(config, weights, range(1, size), devices[1:],
                           backend, init_method, cuda_graphs)
    try:
        groups, bridge_group, _ = _join_groups(config, 0, devices[0],
                                               backend, init_method)
    except BaseException:
        _stop(procs, 0.0)
        raise
    bridge = StepBridge(None, TorchBroadcastEndpoint(bridge_group))
    logger.info("parallel engine: %s ranks (tp x sp x pp) over %s on %s",
                "x".join(str(n) for n in _sizes(config).values()), backend,
                ", ".join(str(d) for d in devices))
    return TensorParallelRuntime(groups, bridge, procs, devices, report)


def _spawn(config, weights, ranks, devices, backend, init_method,
           cuda_graphs):
    """Start ``worker_main`` for each of ``ranks`` on its device; returns
    the processes and the queue they report their launch counts on."""
    ctx = torch.multiprocessing.get_context("spawn")
    report = ctx.Queue()
    procs = [ctx.Process(
        target=worker_main, daemon=True,
        args=(config, weights, rank, str(device), backend, init_method,
              cuda_graphs, report))
        for rank, device in zip(ranks, devices)]
    for p in procs:
        p.start()
    return procs, report


# ---- multi-host serving -----------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DistributedProcess:
    """This server process's place in a multi-host world: the
    coordinator's host:port (the rendezvous store), the process count
    and this process's id (0 serves HTTP)."""

    coordinator_address: str
    num_processes: int
    process_id: int

    def local_ranks(self, world: int) -> range:
        """The global ranks this process holds: ``p * L .. p * L + L -
        1``, L = world / processes (refused when it does not divide)."""
        if world % self.num_processes:
            raise ValueError(
                f"a world of {world} ranks (tensor x context x pipeline "
                f"parallel sizes) does not divide over "
                f"{self.num_processes} processes")
        per = world // self.num_processes
        return range(self.process_id * per, (self.process_id + 1) * per)


def init_distributed(coordinator_address: Optional[str],
                     num_processes: Optional[int],
                     process_id: Optional[int]) -> DistributedProcess:
    """This process's place in a multi-host world (``--distributed``).
    The port has no metadata server to discover them from, so all three
    are required; the world itself is joined by ``start_distributed``
    and ``run_distributed_worker`` (rendezvous at
    tcp://``coordinator_address``, process 0 hosting the store)."""
    if coordinator_address is None or num_processes is None or (
            process_id is None):
        raise ValueError("--distributed needs --coordinator-address, "
                         "--num-processes and --process-id")
    host, _, port = coordinator_address.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError("--coordinator-address must be host:port (got "
                         f"{coordinator_address!r})")
    if num_processes < 1 or not 0 <= process_id < num_processes:
        raise ValueError(f"--process-id {process_id} is not one of "
                         f"--num-processes {num_processes}")
    return DistributedProcess(coordinator_address, num_processes,
                              process_id)


def is_coordinator(process: Optional[DistributedProcess]) -> bool:
    """Whether this process serves: process 0 of a multi-host world, or
    a process in none (None)."""
    return process is None or process.process_id == 0


def _process_ranks(config, devices, process: DistributedProcess):
    """(this process's global ranks, its devices, the rendezvous
    init_method)."""
    ranks = process.local_ranks(config.parallel.world_size)
    devices = [torch.device(d) for d in devices]
    if len(devices) != len(ranks):
        raise ValueError(f"{len(devices)} devices for the {len(ranks)} "
                         f"ranks of process {process.process_id}")
    return ranks, devices, f"tcp://{process.coordinator_address}"


def start_distributed(config, devices: Sequence[torch.device],
                      process: DistributedProcess, num_slices: int = 1,
                      weights: Optional[str] = None
                      ) -> TensorParallelRuntime:
    """Process 0 of a multi-host world: spawn its other L - 1 ranks on
    ``devices[1:]``, join rank 0 on ``devices[0]`` and return the
    runtime whose bridge rank 0 publishes through. The backend is the
    cards' (``choose_backend`` at the rendezvous) and the step graphs
    are on exactly when it is NCCL. ``close`` releases every rank of
    the world but joins only this process's own."""
    ranks, devices, init_method = _process_ranks(config, devices, process)
    procs, report = _spawn(config, weights, ranks[1:], devices[1:], None,
                           init_method, None)
    try:
        groups, bridge_group, backend = _join_groups(
            config, 0, devices[0], None, init_method)
    except BaseException:
        _stop(procs, 0.0)
        raise
    bridge = StepBridge(None, TorchBroadcastEndpoint(bridge_group),
                        num_slices=num_slices)
    logger.info("distributed engine: %s ranks (tp x sp x pp) over %d "
                "processes at %s, backend %s (step graphs %s); this "
                "process's ranks on %s",
                "x".join(str(n) for n in _sizes(config).values()),
                process.num_processes, process.coordinator_address, backend,
                "on" if groups.capturable else "off",
                ", ".join(str(d) for d in devices))
    return TensorParallelRuntime(groups, bridge, procs, devices, report,
                                 process)


def run_distributed_worker(config, devices: Sequence[torch.device],
                           process: DistributedProcess,
                           weights: Optional[str] = None) -> dict:
    """A process other than 0: spawn its other L - 1 ranks, run its first
    rank's step loop here until the coordinator's shutdown record, then gather
    its ranks' kernel launch counts ({rank: counts}), log them on a line
    of their own and return them."""
    ranks, devices, init_method = _process_ranks(config, devices, process)
    procs, report = _spawn(config, weights, ranks[1:], devices[1:], None,
                           init_method, None)
    try:
        launches = {ranks[0]: worker_main(config, weights, ranks[0],
                                          str(devices[0]), None,
                                          init_method, None)}
        for _ in procs:
            rank, counts, _ = report.get(timeout=30.0)
            launches[rank] = counts
    finally:
        _stop(procs, 30.0)
    logger.info("distributed process %d: kernel launches by rank %s",
                process.process_id, json.dumps(launches, sort_keys=True))
    return launches
