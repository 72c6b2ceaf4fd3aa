"""Request tracing in the port (``engine/tracing.py``), modelled on the
reference's engine-side cases in ``tests/test_tracing.py``: the span
line's schema and its vocabulary against the JAX module's, an engine
with no tracer by default and the same greedy output with one, the
lifecycle events of a request and the step records, the fleet routes'
events (a migrate cut, a watchdog trip), ``/debug/trace`` and
``/debug/steps``, the profiler routes' 409 guards and spans, and the
repo's ``traceview`` stitching a router span with a prefill-role and a
decode-role port server's span lines.

Tiny-llama with the JAX package's random weights, converted; greedy
streams must be byte-identical.
"""

import asyncio
import json
import time

import numpy as np
import pytest
import torch

import jax

from production_stack_tpu import traceview
from production_stack_tpu.engine import config as jax_config
from production_stack_tpu.engine import tracing as jax_tracing
from production_stack_tpu.models import llama as jax_llama
from production_stack_tpu_torch.engine.sequence import SamplingParams
from production_stack_tpu_torch.engine.server import make_server
from production_stack_tpu_torch.engine.tracing import (
    SPAN_EVENTS,
    EngineTracer,
)
from tests.test_torch_crash_recovery import (
    PortServer,
    engine_config,
    port_engine,
    request,
    serve_cache,
)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def weights():
    cfg = jax_config.tiny_model_config("llama")
    return {k: np.asarray(v) for k, v in
            jax_llama.init_params(cfg, jax.random.PRNGKey(11)).items()}


def _engine(weights, **extra):
    # Chunks of 32: a 45-token prompt prefills in two chunks.
    return port_engine(weights, engine_config(
        None, checkpoint=0, scheduler={"prefill_chunk_size": 32},
        **extra))


def _greedy_run(engine, request_id=None):
    sid = engine.add_request([5, 6, 7] * 15, SamplingParams(
        temperature=0.0, max_tokens=6, ignore_eos=True),
        request_id=request_id)
    seq = engine.sequences[sid]
    for _ in range(200):
        engine.step()
        if not engine.has_work():
            break
    assert not engine.has_work()
    return list(seq.output_token_ids)


def test_span_events_are_the_jax_vocabulary():
    assert SPAN_EVENTS == jax_tracing.SPAN_EVENTS


def test_engine_span_schema_roundtrip(tmp_path):
    """The span line the JAX tracer writes, field for field."""
    lines = {}
    t0 = time.time()
    for name, cls in (("port", EngineTracer),
                      ("jax", jax_tracing.EngineTracer)):
        path = str(tmp_path / f"{name}.jsonl")
        tracer = cls(span_log_path=path, ring_size=4, role="prefill")
        tracer.start("seq-1", request_id="rid-9", prompt_tokens=7)
        tracer.event("seq-1", "prefill_chunk", start=0, tokens=7,
                     last=True)
        tracer.event("seq-1", "first_token", token=3)
        tracer.finish("seq-1", reason="stop", arrival_ts=t0,
                      first_scheduled_ts=t0 + 0.001,
                      first_token_ts=t0 + 0.002, finish_ts=t0 + 0.003,
                      prompt_tokens=7, output_tokens=4)
        # finish is idempotent: the abort and drain paths may race.
        tracer.finish("seq-1", reason="abort")
        text = open(path).read().splitlines()
        assert len(text) == 1
        lines[name] = json.loads(text[0])
        assert tracer.lookup("rid-9")["spans"][0]["seq_id"] == "seq-1"
        assert tracer.lookup("seq-1") is not None
        assert tracer.lookup("nope") is None
    port, ref = lines["port"], lines["jax"]
    assert list(port) == list(ref)
    assert [e["event"] for e in port["events"]] == [
        "enqueue", "prefill_chunk", "first_token", "finish"]
    for key in ("span", "request_id", "seq_id", "role", "finish_reason",
                "prompt_tokens", "output_tokens", "queue_ms", "ttft_ms",
                "decode_ms", "latency_ms"):
        assert port[key] == ref[key], key
    assert port["span"] == "engine_request" and port["ttft_ms"] == 2.0


def test_engine_tracer_default_none_and_output_identical(weights):
    plain = _engine(weights)
    assert plain.tracer is None and plain.scheduler.tracer is None
    baseline = _greedy_run(plain)

    traced = _engine(weights)
    traced.tracer = EngineTracer(ring_size=8)
    assert traced.scheduler.tracer is traced.tracer
    assert _greedy_run(traced, request_id="rid-trace") == baseline

    found = traced.tracer.lookup("rid-trace")
    events = [e["event"] for e in found["spans"][0]["events"]]
    assert events[0] == "enqueue" and events[-1] == "finish"
    assert events.count("prefill_chunk") == 2  # 45 tokens, chunks of 32
    assert events.index("prefill_chunk") < events.index("first_token")
    summary = found["spans"][0]
    assert summary["finish_reason"] == "length"
    assert summary["output_tokens"] == 6
    for key in ("queue_ms", "ttft_ms", "decode_ms", "latency_ms"):
        assert summary[key] is not None and summary[key] >= 0
    steps = traced.tracer.recent_steps()
    assert {"prefill", "decode"} <= {s.get("kind") for s in steps}
    for s in steps:
        assert s["host_ms"] >= 0 and "row_bucket" in s


def test_untraced_engine_allocates_no_step_record(weights):
    """No tracer: the execute helpers stage no row detail."""
    engine = _engine(weights)
    notes = []
    account = engine._account_step

    def spy(**kw):
        notes.append(engine._step_note)
        account(**kw)

    engine._account_step = spy
    _greedy_run(engine)
    assert notes and all(n is None for n in notes)


@pytest.mark.parametrize("async_on", [False, True])
def test_server_tracer_on_and_off_give_identical_streams(weights, async_on):
    """The server's default tracer against --trace-ring-size 0 (no
    tracer): greedy streams byte-identical."""
    prompts = [[5, 6, 7] * 15, list(range(20, 90)), [9] * 5]
    outs = []
    for ring in ("256", "0"):
        server = make_server(["--device", "cpu", "--port", "0",
                              "--max-model-len", "256",
                              "--prefill-chunk-size", "32",
                              "--trace-ring-size", ring,
                              "--async-scheduling",
                              "on" if async_on else "off"])
        assert (server.app.engine.tracer is None) == (ring == "0")
        engine = server.app.engine
        outs.append([engine.generate(p, SamplingParams(
            temperature=0.0, max_tokens=10, ignore_eos=True)
        ).output_token_ids for p in prompts])
        server.server_close()
    assert outs[0] == outs[1]


def test_debug_trace_and_steps_routes(weights):
    engine = _engine(weights)
    engine.tracer = EngineTracer(ring_size=8)
    with PortServer(engine) as srv:
        status, _, _ = request("POST", srv.url + "/v1/completions", {
            "prompt": [5, 6, 7] * 5, "max_tokens": 3, "temperature": 0,
            "ignore_eos": True}, headers={"x-request-id": "rid-dbg"})
        assert status == 200
        status, text, _ = request("GET", srv.url + "/debug/trace/rid-dbg")
        assert status == 200
        span = json.loads(text)["spans"][0]
        events = [e["event"] for e in span["events"]]
        assert events[0] == "enqueue" and events[-1] == "finish"
        assert {"prefill_chunk", "first_token"} <= set(events)
        status, _, _ = request("GET", srv.url + "/debug/trace/"
                               + span["seq_id"])
        assert status == 200
        assert request("GET", srv.url + "/debug/trace/unknown")[0] == 404
        status, text, _ = request("GET", srv.url + "/debug/steps?limit=2")
        steps = json.loads(text)["steps"]
        assert status == 200 and len(steps) == 2
        assert request("GET", srv.url + "/debug/steps?limit=x")[0] == 400
        engine.tracer = None
        assert request("GET", srv.url + "/debug/trace/rid-dbg")[0] == 404
        assert request("GET", srv.url + "/debug/steps")[0] == 404


def test_profiler_start_stop_guard_and_spans(weights, tmp_path):
    engine = _engine(weights)
    engine.tracer = EngineTracer(ring_size=8)
    with PortServer(engine, profile_dir=str(tmp_path / "default")) as srv:
        url = srv.url + "/debug/profiler/"
        assert request("POST", url + "stop")[0] == 409
        status, text, _ = request("POST", url + f"start?dir={tmp_path}")
        assert status == 200
        assert json.loads(text) == {"status": "started",
                                    "dir": str(tmp_path)}
        assert request("POST", url + "start")[0] == 409
        assert request("POST", srv.url + "/v1/completions", {
            "prompt": [5, 6, 7], "max_tokens": 2, "temperature": 0})[0] == 200
        status, text, _ = request("POST", url + "stop")
        assert status == 200
        trace = json.loads(text)["trace"]
        assert trace.startswith(str(tmp_path))
        # The step thread's operations are in the trace.
        assert "aten::" in open(trace).read()
        assert request("POST", url + "stop")[0] == 409
        # Without ?dir=, --profile-dir.
        status, text, _ = request("POST", url + "start")
        assert json.loads(text)["dir"] == str(tmp_path / "default")
        assert request("POST", url + "stop")[0] == 200
    span = list(engine.tracer._ring)[-1]
    names = [e["event"] for e in span.events]
    assert "profiler_start" in names and "profiler_stop" in names
    assert span.seq_id.startswith("prof-")


def test_traceview_stitches_router_and_port_spans(weights, tmp_path):
    """The repo's router and a prefill-role and a decode-role port
    server, each writing span lines: traceview stitches the router's
    span and both engines' under the router's request id."""
    from aiohttp.test_utils import TestClient, TestServer

    from production_stack_tpu.router.app import build_app
    from production_stack_tpu.router.parser import parse_args
    from production_stack_tpu.router.tracing import initialize_span_logger

    cache_url, cache = serve_cache()
    paths = {name: str(tmp_path / f"{name}.jsonl")
             for name in ("router", "prefill", "decode")}
    servers = []
    try:
        for role in ("prefill", "decode"):
            engine = port_engine(weights, engine_config(
                cache_url, checkpoint=0, engine_role=role))
            engine.tracer = EngineTracer(span_log_path=paths[role],
                                         role=role)
            servers.append(PortServer(engine))

        async def run():
            args = parse_args([
                "--service-discovery", "static",
                "--static-backends", ",".join(s.url for s in servers),
                "--static-models", "tiny-llama,tiny-llama",
                "--static-roles", "prefill,decode",
                "--routing-logic", "roundrobin",
                "--request-span-log", paths["router"]])
            client = TestClient(TestServer(build_app(args)))
            await client.start_server()
            try:
                resp = await client.post("/v1/chat/completions", json={
                    "model": "tiny-llama", "max_tokens": 4,
                    "temperature": 0, "ignore_eos": True,
                    "messages": [{"role": "user", "content": "hi " * 12}]},
                    headers={"x-request-id": "rid-stitch"})
                assert resp.status == 200
                await resp.read()
            finally:
                await client.close()

        asyncio.run(run())
    finally:
        initialize_span_logger(None)
        for srv in servers:
            srv.stop()
        cache.shutdown()
    spans = traceview.load_spans(list(paths.values()))
    mine = traceview.stitch(spans, "rid-stitch")
    assert [s["span"] for s in mine] == ["request", "engine_request",
                                         "engine_request"]
    assert {s.get("role") for s in mine[1:]} == {"prefill", "decode"}
    assert {s["finish_reason"] for s in mine[1:]} == {"handoff", "length"}
    text = traceview.render_waterfall(spans, "rid-stitch")
    for event in ("handoff_ship", "awaiting_kv_park", "first_token"):
        assert event in text
    assert "engine[prefill" in text and "engine[decode" in text


def test_fleet_events_migrate_ship_and_watchdog_trip(weights):
    """The fleet routes' events: a migrate cut after a checkpoint frame
    (checkpoint_ship, then migrate_ship on the request's span) and a
    step-watchdog trip (a span of its own)."""
    import http.client
    import threading

    engine = port_engine(weights, engine_config(None, checkpoint=4,
                                                step_watchdog_s=0.2))
    engine.tracer = EngineTracer(ring_size=8)
    release = threading.Event()
    release.set()
    step = engine.step

    def gated_step():
        release.wait(30)
        return step()

    engine.step = gated_step
    with PortServer(engine) as srv:
        srv.app.migrate_drain = True
        host, port = srv.http.server_address[:2]
        conn = http.client.HTTPConnection(host, port, timeout=60)
        conn.request("POST", "/v1/chat/completions", json.dumps({
            "messages": [{"role": "user", "content": "hello " * 4}],
            "max_tokens": 12, "temperature": 0, "ignore_eos": True,
            "stream": True}), {"Content-Type": "application/json",
                               "x-request-id": "rid-migrate"})
        with pytest.raises(http.client.IncompleteRead) as cut:
            conn.getresponse().read()
        conn.close()
        assert b": migrating" in cut.value.partial
        events = [e["event"] for span in engine.tracer.lookup(
            "rid-migrate")["spans"] for e in span["events"]]
        assert events.index("checkpoint_ship") < events.index(
            "migrate_ship")
        srv.app.migrate_drain = False

        release.clear()
        client = threading.Thread(target=request, args=(
            "POST", srv.url + "/v1/completions",
            {"prompt": [5, 6], "max_tokens": 2}))
        client.start()
        deadline, status = time.time() + 30, 200
        while status == 200 and time.time() < deadline:
            time.sleep(0.05)
            status = request("GET", srv.url + "/health")[0]
        release.set()
        client.join(timeout=60)
    assert status == 503
    trips = [s for s in engine.tracer._ring
             if s.seq_id.startswith("watchdog-")]
    assert len(trips) == 1
    assert [e["event"] for e in trips[0].events] == [
        "enqueue", "watchdog_trip", "finish"]
