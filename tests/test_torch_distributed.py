"""Multi-host serving in the port against the JAX package's, on the CPU.

The JAX package serves a multi-host slice through ``jax.distributed``
and its ``MultihostStepBridge`` (``parallel/distributed.py``); the port
joins its server processes with ``torch.distributed`` at
``--coordinator-address`` and replays process 0's steps through its
``StepBridge`` (``production_stack_tpu_torch/parallel/distributed.py``).

Held here: the bridge over ``FakeTransport`` (records executed in order
with their values, acks folded into the slice ledger, a missing
follower naming its one slice), ``SliceLiveness`` and the process ->
slice map against JAX's; the backend the cards decide; the mesh plan
checked against the processes as JAX checks it; the refusals with JAX's
messages; ``--async-scheduling`` and ``--unified-step`` ``auto`` under
``--distributed`` as JAX resolves them; a rendezvous that never
completes raising; and two real server processes (``--distributed
--device cpu --num-processes 2``) at tp 2 and at pp 2 over a checkpoint
the test writes: greedy completions byte-identical to the JAX engine's,
embeddings within 1e-4 of a one-process server's, both slices live on
/metrics, and the worker leaving with code 0 and its launch counts.
"""

import argparse
import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from production_stack_tpu.engine import server as jax_server
from production_stack_tpu.parallel import distributed as jax_dist
from production_stack_tpu.parallel import topology as jax_topology
from production_stack_tpu_torch.engine import server
from production_stack_tpu_torch.engine.tokenizer import get_tokenizer
from production_stack_tpu_torch.parallel import distributed, topology
from production_stack_tpu_torch.parallel.distributed import (
    FakeTransport,
    SliceLiveness,
    StepBridge,
    choose_backend,
)
from tests import test_model_parity as parity
from tests import test_torch_pipeline as pipe

ROOT = Path(__file__).resolve().parents[1]


# ---- the bridge over FakeTransport ----------------------------------------


class _Runner:
    def __init__(self):
        self.executed = []

    def execute(self, record):
        self.executed.append(record)


def _bridges(num_slices=2, timeout_s=10.0):
    transport = FakeTransport(2)
    return tuple(StepBridge(_Runner(), transport.endpoint(i),
                            num_slices=num_slices,
                            liveness_timeout_s=timeout_s) for i in (0, 1))


def test_follower_runs_the_records_in_order_and_acks_them():
    """The follower executes each record in order with its values; after
    a publish and its ack both slices read live (the leader heartbeats
    its own, the follower's ack speaks for slice 1)."""
    leader, follower = _bridges()
    worker = threading.Thread(target=follower.worker_loop)
    worker.start()
    records = [{"op": "step", "tokens": np.full((2, 8), 7, np.int32)},
               {"op": "step", "kv_lens": np.arange(4, dtype=np.int32)}]
    for record in records:
        with leader.lock:
            leader.publish(record)
    leader.shutdown()
    worker.join(timeout=30)
    assert not worker.is_alive()
    got = follower.runner.executed
    assert [sorted(r) for r in got] == [sorted(r) for r in records]
    assert (got[0]["tokens"] == 7).all()
    assert got[1]["kv_lens"].tolist() == [0, 1, 2, 3]
    assert leader.check_liveness() == {0: True, 1: True}
    assert leader.liveness.dead_slices() == []


def test_a_missing_follower_names_one_slice():
    """No follower: its acks never come, so once the window passes
    exactly its slice reads dead; the leader's own stays live."""
    leader, _ = _bridges(timeout_s=0.05)
    with leader.lock:
        leader.publish({"op": "step"})
    time.sleep(0.1)
    with leader.lock:
        leader.publish({"op": "step"})
    live = leader.check_liveness()
    assert live == {0: True, 1: False}
    assert leader.liveness.dead_slices() == [1]


def test_the_real_broadcast_marks_every_slice():
    """Over the collective transport a completed publish marks every
    slice (no acks), as JAX's does; an idle world's slices read dead
    once the window passes with no step."""
    class Collective:
        collective = True
        process_index, num_processes = 0, 4

        def broadcast(self, value):
            return value

        def drain_acks(self):
            return []

    bridge = StepBridge(None, Collective(), num_slices=2,
                        liveness_timeout_s=0.05)
    time.sleep(0.1)
    assert bridge.check_liveness() == {0: False, 1: False}
    bridge.publish({"op": "step"})
    assert bridge.check_liveness() == {0: True, 1: True}


def test_slice_liveness_is_the_jax_ledger():
    """The same heartbeats, mark_alls and snapshot times give the same
    snapshots and dead slices as JAX's SliceLiveness."""
    rng = np.random.RandomState(3)
    for num_slices, timeout_s in ((1, 10.0), (3, 0.5), (4, 2.0)):
        ours = SliceLiveness(num_slices, timeout_s)
        theirs = jax_dist.SliceLiveness(num_slices, timeout_s)
        now = time.monotonic()
        for _ in range(60):
            now += float(rng.uniform(0.0, 1.0))
            event = rng.randint(3)
            if event == 0:
                slice_id = int(rng.randint(num_slices + 1))  # one unknown
                ours.heartbeat(slice_id, now)
                theirs.heartbeat(slice_id, now)
            elif event == 1:
                ours.mark_all(now)
                theirs.mark_all(now)
            at = now + float(rng.uniform(0.0, 3.0))
            assert ours.snapshot(at) == theirs.snapshot(at)
            assert ours.dead_slices(at) == theirs.dead_slices(at)


@pytest.mark.parametrize("processes,slices", [(1, 1), (2, 2), (4, 2),
                                               (6, 3), (8, 4), (3, 1)])
def test_processes_map_to_slices_as_in_jax(processes, slices):
    """Contiguous, slice-major: the port's slice of each process equals
    JAX's MultihostStepBridge.slice_of_process."""
    theirs = jax_dist.MultihostStepBridge(
        None, endpoint=(jax_dist.FakeTransport(processes).endpoint(0)
                        if processes > 1 else argparse.Namespace(
                            num_processes=1)),
        num_slices=slices)
    assert topology.process_slices(processes, slices) == slices
    for p in range(processes):
        assert topology.slice_of_process(p, processes, slices) == (
            theirs.slice_of_process(p))
    # --num-slices 0 under --distributed: a slice a process.
    assert topology.process_slices(processes, 0) == processes


@pytest.mark.parametrize("identities,backend", [
    (["a/GPU-0", "a/GPU-1"], "nccl"),
    (["a/GPU-0", "b/GPU-0", "b/GPU-1", "a/GPU-1"], "nccl"),
    (["a/GPU-0", "a/GPU-0"], "gloo"),
    (["a/GPU-0", "b/GPU-1", "a/GPU-0"], "gloo"),
    (["cpu", "cpu"], "gloo"),
    (["cpu", "a/GPU-0"], "gloo")])
def test_the_cards_choose_the_backend(identities, backend):
    """NCCL when every rank has its own card; a card named twice (two
    processes sharing it) or a CPU rank takes gloo."""
    assert choose_backend(identities) == backend


def test_a_cpu_rank_is_its_own_identity():
    assert distributed.card_identity(torch.device("cpu")) == "cpu"


class _FakeDevice:
    def __init__(self, process_index, i):
        self.process_index, self.id = process_index, i


@pytest.mark.parametrize("tp,pp,placement", [
    (2, 1, "auto"), (2, 1, "tp=any"), (1, 2, "auto"), (2, 2, "auto"),
    (4, 1, "auto"), (2, 2, "tp=any")])
def test_the_mesh_plan_is_checked_against_the_processes(tp, pp, placement):
    """Two processes, world / 2 ranks each: the port refuses exactly the
    plans JAX refuses on its process-grouped devices (an "ici" axis
    that crosses a process), with the same message."""
    per = tp * pp // 2
    jax_devices = [_FakeDevice(p, i) for p in range(2) for i in range(per)]
    jtopo = jax_topology.discover_topology(jax_devices)
    assert jtopo.source == "process"

    def outcome(plan_cls, topo):
        try:
            plan_cls(tp=tp, pp=pp, placement=(
                jax_topology if plan_cls is jax_topology.MeshPlan
                else topology).parse_placement(placement)).validate(topo)
            return None
        except ValueError as e:
            return re.sub(r"\(.*\)\.|\s*Shrink.*", "", str(e))

    want = outcome(jax_topology.MeshPlan, jtopo)
    got = outcome(topology.MeshPlan, topology.process_topology(2, per))
    assert got == want


def test_a_world_that_does_not_divide_over_the_processes_is_refused():
    process = distributed.DistributedProcess("127.0.0.1:1", 2, 1)
    assert list(process.local_ranks(4)) == [2, 3]
    assert not distributed.is_coordinator(process)
    assert distributed.is_coordinator(
        distributed.DistributedProcess("127.0.0.1:1", 2, 0))
    assert distributed.is_coordinator(None)  # no multi-host world
    with pytest.raises(ValueError, match="does not divide over 2"):
        process.local_ranks(3)


# ---- the server's refusals and resolutions --------------------------------


JAX_SOURCE = re.sub(r'"\s*\n\s*"', "", (
    ROOT / "production_stack_tpu/engine/server.py").read_text())
DIST = ["--distributed", "--coordinator-address", "127.0.0.1:1",
        "--num-processes", "2", "--process-id", "0", "--device", "cpu"]


@pytest.mark.parametrize("flags", [
    ["--enable-kv-offload"], ["--kv-remote-url", "http://127.0.0.1:1"],
    ["--context-parallel-size", "2"]], ids=["offload", "remote", "cp"])
def test_distributed_refusals_are_the_jax_servers(flags):
    """The offload tiers and cp > 1 under --distributed are refused at
    start-up, with the JAX server's messages, before any rank joins."""
    with pytest.raises(ValueError) as err:
        server.build_engine_from_args(server.parse_args(DIST + flags))
    assert str(err.value) in JAX_SOURCE
    with pytest.raises(ValueError, match=re.escape(str(err.value))):
        server.run_worker_from_args(server.parse_args(DIST + flags))


@pytest.mark.parametrize("missing", ["--coordinator-address",
                                     "--num-processes", "--process-id"])
def test_distributed_needs_its_three_values(missing):
    i = DIST.index(missing)
    with pytest.raises(ValueError, match="--distributed needs"):
        server.build_engine_from_args(server.parse_args(
            DIST[:i] + DIST[i + 2:]))


def test_a_distributed_process_with_no_card_raises(monkeypatch):
    """No card and no --device cpu: the process raises rather than
    serve or replay on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = server.parse_args(DIST[:-2])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        server.build_engine_from_args(args)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        server.run_worker_from_args(args)


def test_a_rendezvous_that_never_completes_raises(monkeypatch):
    """Rank 0 of a two-rank world whose other rank never arrives: the
    rendezvous store's wait raises."""
    import datetime
    monkeypatch.setattr(distributed, "RENDEZVOUS_TIMEOUT",
                        datetime.timedelta(seconds=1))
    t0 = time.monotonic()
    with pytest.raises(Exception, match="(?i)timeout|timed out|wait"):
        distributed._rendezvous(f"127.0.0.1:{pipe._free_port()}", 0, 2,
                                torch.device("cpu"))
    assert time.monotonic() - t0 < 30


@pytest.mark.parametrize("flags", [
    [], ["--decode-steps", "4"], ["--speculative-k", "2"],
    ["--engine-role", "decode"], ["--engine-role", "prefill"],
    ["--async-scheduling", "on"], ["--unified-step", "on"],
    ["--unified-step", "off", "--async-scheduling", "off"]])
@pytest.mark.parametrize("dist", [False, True], ids=["one_host",
                                                     "distributed"])
def test_auto_resolution_is_the_jax_servers(flags, dist):
    """--async-scheduling and --unified-step auto resolve as the JAX
    server resolves them (async_scheduling_eligible and
    unified_step_eligible with distributed=...): off under
    --distributed; an explicit value honoured."""
    argv = flags + (["--distributed"] if dist else [])
    config, _ = server.engine_config_from_args(
        server.parse_args(argv + ["--device", "cpu"]), torch.device("cpu"))
    jargs = jax_server.parse_args(argv)
    assert config.scheduler.async_scheduling == (
        jax_server._resolve_async_scheduling(jargs))
    assert config.scheduler.unified_step == (
        jax_server._resolve_unified_step(jargs))


# ---- two real server processes ----------------------------------------------


SERVER_FLAGS = ["--tokenizer", "bench", "--device", "cpu", "--dtype",
                "float32", "--page-size", "16", "--num-pages", "64",
                "--max-num-seqs", "4", "--max-model-len", "128",
                "--prefill-chunk-size", "32", "--prefill-batch-size", "2",
                "--host", "127.0.0.1"]
EMBED_INPUT = [[1, 2, 3], [4, 5, 6, 7]]  # token ids, as JAX's EMBED leg


def _get(url):
    with urllib.request.urlopen(url, timeout=20) as r:
        return r.read().decode()


def _wait_health(base, proc, deadline):
    while True:
        try:
            _get(base + "/health")
            return
        except OSError:
            if proc.poll() is not None or time.monotonic() > deadline:
                raise AssertionError("the coordinator did not come up")
            time.sleep(0.3)


def _serve_distributed(path, flags, prompts, deadline_s=110):
    """Two ``--distributed`` server processes over ``path``: process 0
    serves; returns (completion texts, embeddings, /metrics before and
    after the requests, each process's (exit code, output)). SIGTERM
    stops process 0; process 1 must leave by itself."""
    port, coord = pipe._free_port(), pipe._free_port()
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    procs = [subprocess.Popen(
        [sys.executable, "-m", "production_stack_tpu_torch.engine.server",
         "--model", path, *SERVER_FLAGS, "--port", str(port), *flags,
         "--distributed", "--coordinator-address", f"127.0.0.1:{coord}",
         "--num-processes", "2", "--process-id", str(i)],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)
        for i in range(2)]
    base = f"http://127.0.0.1:{port}"
    deadline = time.monotonic() + deadline_s
    outs = [None, None]
    try:
        _wait_health(base, procs[0], deadline)
        before = _get(base + "/metrics")
        texts = [pipe._post(base + "/v1/completions", {
            "prompt": p, "max_tokens": 8, "temperature": 0,
            "ignore_eos": True})["choices"][0]["text"] for p in prompts]
        vectors = [d["embedding"] for d in pipe._post(
            base + "/v1/embeddings", {"input": EMBED_INPUT})["data"]]
        after = _get(base + "/metrics")
    finally:
        procs[0].send_signal(signal.SIGTERM)
        for i, proc in enumerate(procs):
            try:
                out = proc.communicate(timeout=max(
                    5.0, deadline - time.monotonic()))[0]
            except subprocess.TimeoutExpired:
                proc.kill()
                out = proc.communicate()[0]
            outs[i] = (proc.returncode, out.decode())
    return texts, vectors, before, after, outs


def _one_process_embeddings(path):
    """The one-process port server's embeddings of EMBED_INPUT."""
    from tests.test_torch_server import _serve
    url, stop = _serve(server.make_server(
        ["--model", path, *SERVER_FLAGS, "--port", "0"]))
    try:
        return [d["embedding"] for d in pipe._post(
            url + "/v1/embeddings", {"input": EMBED_INPUT})["data"]]
    finally:
        stop()


@pytest.mark.parametrize("flags,parallel", [
    (["--tensor-parallel-size", "2", "--mesh-placement", "tp=any"],
     dict(tensor_parallel_size=2)),
    (["--pipeline-parallel-size", "2"], dict(pipeline_parallel_size=2))],
    ids=["tp2", "pp2"])
def test_two_distributed_processes_match_jax(tmp_path, flags, parallel):
    """Process 0 (HTTP) and process 1 (a worker: no HTTP) over a llama
    checkpoint, one rank each, gloo: greedy completions byte-identical
    to the JAX engine's on its mesh of that size (async and unified off,
    as --distributed resolves them), embeddings within 1e-4 of a
    one-process server's; /metrics reads slice 0 and, after the
    requests, both slices live; the worker leaves with code 0 and logs
    its rank's kernel launches."""
    path, _ = parity._save_tiny_llama(tmp_path)
    prompts = pipe.PROMPTS
    theirs = pipe.jax_checkpoint_streams(path, prompts, parallel)
    texts, vectors, before, after, outs = _serve_distributed(
        path, flags, prompts)
    (code0, out0), (code1, out1) = outs
    tok = get_tokenizer("bench")
    assert texts == [tok.decode(ids) for ids in theirs], out0[-3000:]
    np.testing.assert_allclose(vectors, _one_process_embeddings(path),
                               atol=1e-4, rtol=0)
    assert "vllm:engine_slice_id 0.0" in before.splitlines()
    for s in ("0", "1"):
        assert f'vllm:engine_slice_live{{slice="{s}"}} 1.0' in (
            after.splitlines()), after
    axis = "tp" if "tensor_parallel_size" in parallel else "pp"
    assert f'vllm:engine_mesh_shape{{axis="{axis}"}} 2.0' in after
    assert "backend gloo (step graphs off)" in out0, out0[-3000:]
    assert code1 == 0, out1[-3000:]
    assert "tp rank 1 shutting down" in out1
    launches = json.loads(re.search(
        r"distributed process 1: kernel launches by rank (\{.*\})",
        out1).group(1))
    collective = "tp_all_reduce" if axis == "tp" else "pp_hop"
    assert launches["1"].get(collective, 0) > 0, launches
    assert "Serving" not in out1  # the worker never serves HTTP
