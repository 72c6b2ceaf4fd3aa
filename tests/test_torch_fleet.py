"""The port server's fleet contract against the JAX server's: ``/version``,
``/drain`` (503 with Retry-After, ``/health`` draining, a migrate drain
cutting a stream at its checkpoint frame, the in-process exit once
idle), the priority matrix and the shed gate (twins of
``tests/test_qos.py``), a bad ``x-priority``, the step watchdog,
``/kv/summary`` against the JAX tracker, preempt-to-offload against a
recompute and against the JAX engine, the new ``/metrics`` names, and
the repo's router, unchanged, in front of two port servers: a migrate
drain on one mid-stream is resumed on the other.

Tiny-llama with the JAX package's random weights, converted; greedy
streams must be byte-identical.
"""

import asyncio
import json
import re
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from production_stack_tpu.kvecon.summary import (
    PrefixSummaryTracker as JaxTracker,
    routable_text as jax_routable_text,
)
from production_stack_tpu.models import llama as jax_llama
from production_stack_tpu_torch.engine import config as port_config
from production_stack_tpu_torch.engine.sequence import (
    SamplingParams,
    Sequence,
    SequenceState,
)
from production_stack_tpu_torch.qos import (
    DEFAULT_PRIORITY,
    Priority,
    parse_priority,
    shed_retry_after_s,
)
from production_stack_tpu_torch.version import __version__
from tests.test_torch_crash_recovery import (
    LONG_CHAT,
    PortServer,
    delta_content,
    engine_config,
    parse_stream,
    port_engine,
    request,
    serve_cache,
)

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def weights():
    from production_stack_tpu.engine import config as jax_config
    cfg = jax_config.tiny_model_config("llama")
    return {k: np.asarray(v) for k, v in
            jax_llama.init_params(cfg, jax.random.PRNGKey(11)).items()}


@pytest.fixture(scope="module")
def cache_url():
    url, server = serve_cache()
    yield url
    server.shutdown()


def _slowed(engine, seconds=0.01):
    """``engine`` with each step held back ``seconds``, so a stream is
    still running when a test acts on it."""
    step = engine.step

    def slow_step():
        time.sleep(seconds)
        return step()

    engine.step = slow_step
    return engine


def _chat(max_tokens=6, stream=False, content="hello"):
    return {"model": "tiny-llama", "max_tokens": max_tokens,
            "temperature": 0, "ignore_eos": True, "stream": stream,
            "messages": [{"role": "user", "content": content}]}


# ---- /version, /health, /drain -------------------------------------------------


def test_version_and_health_carry_the_build_id(weights):
    from production_stack_tpu.version import __version__ as jax_version
    with PortServer(port_engine(weights, engine_config(None)),
                    build_id="rev-7") as srv:
        status, text, _ = request("GET", srv.url + "/version")
        assert status == 200
        # The JAX server's fields, and the engine's role.
        assert json.loads(text) == {"version": jax_version,
                                    "build_id": "rev-7", "role": "both"}
        assert __version__ == jax_version
        status, text, _ = request("GET", srv.url + "/health")
        assert status == 200 and json.loads(text) == {
            "status": "ok", "role": "both", "draining": False,
            "active_requests": 0, "build_id": "rev-7"}


def test_drain_turns_new_requests_away_and_exits_when_idle(weights):
    """After POST /drain a new generation request answers 503 with
    Retry-After, /health shows draining and the build id, /version
    answers, and with "exit" the server stops once idle (its serve
    thread returns)."""
    srv = PortServer(port_engine(weights, engine_config(None)),
                     build_id="rev-8")
    status, text, _ = request("POST", srv.url + "/v1/chat/completions",
                              _chat())
    assert status == 200
    status, text, _ = request("POST", srv.url + "/drain", {})
    assert status == 200 and json.loads(text) == {
        "status": "draining", "active_requests": 0, "running": 0,
        "waiting": 0}
    for path in ("/v1/chat/completions", "/v1/completions", "/v1/resume"):
        status, text, headers = request("POST", srv.url + path, _chat())
        assert status == 503 and headers["Retry-After"] == "1", path
        assert "draining" in json.loads(text)["error"]["message"]
    status, text, _ = request("GET", srv.url + "/health")
    health = json.loads(text)
    assert status == 200 and health["draining"] is True
    assert health["build_id"] == "rev-8"
    assert request("GET", srv.url + "/version")[0] == 200
    metrics = request("GET", srv.url + "/metrics")[1]
    assert "vllm:engine_draining 1.0" in metrics
    status, _, _ = request("POST", srv.url + "/drain", {"exit": True})
    assert status == 200
    srv.thread.join(timeout=30)
    assert not srv.thread.is_alive()


def test_drain_exit_waits_for_the_stream_in_flight(weights):
    """The exit waits for a generation in flight: a stream admitted
    before the drain finishes whole, then the server stops."""
    srv = PortServer(_slowed(port_engine(weights, engine_config(None))))
    result = {}

    def client():
        result["answer"] = request("POST", srv.url + "/v1/chat/completions",
                                   _chat(max_tokens=30, stream=True))

    thread = threading.Thread(target=client)
    thread.start()
    deadline = time.time() + 30
    while srv.app._active == 0 and time.time() < deadline:
        time.sleep(0.005)
    status, text, _ = request("POST", srv.url + "/drain", {"exit": True})
    assert status == 200 and json.loads(text)["active_requests"] == 1
    thread.join(timeout=60)
    srv.thread.join(timeout=30)
    assert not srv.thread.is_alive()
    status, raw, _ = result["answer"]
    assert status == 200 and raw.rstrip().endswith("data: [DONE]")
    datas = [e for kind, e in parse_stream(raw) if kind == "data"]
    assert datas[-1]["choices"][0]["finish_reason"] == "length"


def test_migrate_drain_cuts_a_stream_at_its_checkpoint_frame(weights,
                                                             cache_url):
    """Under a migrate drain a checkpointed stream ends right after a
    checkpoint frame, with the ``: migrating`` marker and without its
    end (no finish chunk, no [DONE], the chunked body cut short)."""
    import http.client
    engine = _slowed(port_engine(weights, engine_config(cache_url)))
    with PortServer(engine) as srv:
        host, port = srv.http.server_address[:2]
        conn = http.client.HTTPConnection(host, port, timeout=60)
        conn.request("POST", "/v1/chat/completions",
                     json.dumps(dict(LONG_CHAT, max_tokens=40)),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 200
        assert resp.getheader("Transfer-Encoding") == "chunked"
        raw = b""
        while b": checkpoint " not in raw:
            raw += resp.read1(65536)
        with engine._lock:  # no step commits while the drain lands
            srv.app.drain({"migrate": True})
        with pytest.raises(http.client.IncompleteRead) as cut:
            while True:
                chunk = resp.read1(65536)
                if not chunk:
                    break
                raw += chunk
        raw += cut.value.partial
        conn.close()
    events = parse_stream(raw.decode())
    kinds = [kind for kind, _ in events]
    assert kinds[-2:] == ["ckpt", "migrating"]
    assert b"[DONE]" not in raw
    assert all(e["choices"][0]["finish_reason"] is None
               for kind, e in events if kind == "data")
    desc = events[-2][1]
    assert desc["output_tokens"] < 40


# ---- QoS --------------------------------------------------------------------


def test_priority_admission_matrix(weights):
    """Waiting sequences are admitted priority first, arrival second,
    whatever the submission order; unlabeled requests take the
    default class."""
    engine = port_engine(weights, engine_config(
        None, num_pages=128, max_num_seqs=8,
        scheduler={"prefill_batch_size": 8}))
    submitted = [
        engine.add_request(list(range(100 * (i + 1), 100 * (i + 1) + 8)),
                           SamplingParams(max_tokens=4, temperature=0.0),
                           priority=int(p))
        for i, p in enumerate([Priority.BACKGROUND, Priority.BATCH,
                               Priority.INTERACTIVE, Priority.BATCH,
                               Priority.INTERACTIVE])]
    order = [c.seq.seq_id for c in engine.scheduler.plan_step().prefill.chunks]
    assert order == [submitted[i] for i in (2, 4, 1, 3, 0)]
    sid = engine.add_request([5, 6, 7], SamplingParams(max_tokens=2))
    assert engine.sequences[sid].priority == int(DEFAULT_PRIORITY)
    assert engine.default_priority == int(DEFAULT_PRIORITY)


def test_invalid_priority_rejected_everywhere(weights):
    with pytest.raises(ValueError, match="invalid priority"):
        parse_priority("urgent")
    with pytest.raises(ValueError, match="invalid priority"):
        port_config.QoSConfig(default_priority="realtime")
    for bad in (0.0, -0.5, 1.5):
        with pytest.raises(ValueError):
            port_config.QoSConfig(shed_threshold=bad)
    assert parse_priority(" Interactive ") == Priority.INTERACTIVE
    assert shed_retry_after_s(0, 4.0) == 1 and shed_retry_after_s(
        10, 0.0) == 1 and shed_retry_after_s(10, 4.0) == 2
    with PortServer(port_engine(weights, engine_config(None))) as srv:
        status, text, _ = request("POST", srv.url + "/v1/chat/completions",
                                  _chat(), headers={"x-priority": "urgent"})
        assert status == 400
        assert "invalid priority 'urgent'" in json.loads(text)["error"][
            "message"]
        status, _, _ = request("POST", srv.url + "/v1/chat/completions",
                               _chat(), headers={"x-priority": "background",
                                                 "x-qos-spec-off": "1"})
        assert status == 200


def test_spec_off_rows_are_not_drafted(weights):
    """``x-qos-spec-off: 1`` keeps a request's rows from drafting under
    --speculative-k (they ride verify steps as plain rows); without it
    the same repeating prompt drafts. The greedy text is the same."""
    body = {"model": "tiny-llama", "prompt": "abcabcabcabcabcabcabcabc",
            "max_tokens": 16, "temperature": 0, "ignore_eos": True}
    drafted, texts = {}, {}
    for spec_off in (False, True):
        engine = port_engine(weights, engine_config(
            None, scheduler={"speculative_k": 4}))
        with PortServer(engine) as srv:
            status, text, _ = request(
                "POST", srv.url + "/v1/completions", body,
                headers={"x-qos-spec-off": "1"} if spec_off else {})
            assert status == 200
            texts[spec_off] = json.loads(text)["choices"][0]["text"]
            drafted[spec_off] = engine.metrics.spec_draft_tokens_total
    assert drafted[False] > 0 and drafted[True] == 0
    assert texts[False] == texts[True]


def _park(engine, n):
    """Queue ``n`` sequences while the caller holds the engine lock (the
    loop can neither admit nor plan meanwhile)."""
    for i in range(n):
        engine._add(Sequence(seq_id=f"parked-{i}",
                             prompt_token_ids=[3 + i] * 8,
                             sampling=SamplingParams(max_tokens=2)))


@pytest.mark.parametrize("priority,shed", [
    ("interactive", False), ("batch", True), ("background", True),
    (None, True)])
def test_shed_gate_answers_429_to_non_interactive(weights, priority, shed):
    """With the waiting queue at the threshold (half of a queue of 4), a
    batch, background or unlabeled request is shed with 429 and the
    Retry-After of queue depth over running rows; an interactive one is
    admitted. Shed requests are counted by class on /metrics."""
    engine = port_engine(weights, engine_config(
        None, scheduler={"max_queue_len": 4},
        qos=port_config.QoSConfig(shed_threshold=0.5)))
    with PortServer(engine) as srv:
        headers = {"x-priority": priority} if priority else {}
        with engine._lock:
            _park(engine, 2)
            req = urllib.request.Request(
                srv.url + "/v1/chat/completions",
                data=json.dumps(_chat(stream=True)).encode(),
                headers={"Content-Type": "application/json", **headers})
            try:
                with urllib.request.urlopen(req, timeout=60) as resp:
                    status, retry = resp.status, None
            except urllib.error.HTTPError as e:
                status, retry = e.code, e.headers.get("Retry-After")
                body = json.loads(e.read())
        if shed:
            assert status == 429 and retry == "2"  # 2 waiting, 1 row
            assert body["error"]["type"] == "overloaded_error"
        else:
            assert status == 200
        metrics = request("GET", srv.url + "/metrics")[1]
        cls = priority or "batch"
        assert (f'vllm:qos_shed_total{{class="{cls}"}} '
                f'{1.0 if shed else 0.0}') in metrics


# ---- the step watchdog ----------------------------------------------------------


def test_watchdog_flips_health_with_a_stalled_step(weights):
    """A step running past --step-watchdog-s turns /health into 503
    {"status": "watchdog"}; it recovers when the step returns. An idle
    loop reads 0."""
    engine = port_engine(weights, engine_config(None,
                                                step_watchdog_s=0.2))
    release = threading.Event()
    step = engine.step

    def stalled_step():
        release.wait(30)
        return step()

    engine.step = stalled_step
    with PortServer(engine) as srv:
        assert srv.app.loop.current_step_s() == 0.0
        assert request("GET", srv.url + "/health")[0] == 200
        client = threading.Thread(target=request, args=(
            "POST", srv.url + "/v1/chat/completions", _chat()))
        client.start()
        deadline = time.time() + 30
        status = 200
        while status == 200 and time.time() < deadline:
            time.sleep(0.05)
            status, text, _ = request("GET", srv.url + "/health")
        assert status == 503
        health = json.loads(text)
        assert health["status"] == "watchdog"
        assert health["stuck_step_s"] > 0.2 and "build_id" in health
        assert srv.app._watchdog_tripped
        release.set()
        client.join(timeout=60)
        deadline = time.time() + 30
        while status != 200 and time.time() < deadline:
            time.sleep(0.05)
            status, _, _ = request("GET", srv.url + "/health")
        assert status == 200 and not srv.app._watchdog_tripped


# ---- /kv/summary ------------------------------------------------------------------


def test_kv_summary_matches_the_jax_tracker(weights):
    """The hot chains the port advertises are those the JAX tracker
    computes for the same request sequence (the router compares them
    with its own text-domain chains)."""
    long_a = "system prompt " * 25
    long_b = "another prefix " * 20
    bodies = [
        _chat(content=long_a), _chat(content=long_a + "q1"),
        _chat(content=long_b),
        {"model": "tiny-llama", "prompt": long_b + "tail",
         "max_tokens": 2, "temperature": 0},
        {"model": "tiny-llama", "prompt": long_b + "tail2",
         "max_tokens": 2, "temperature": 0},
    ]
    # admit_hits 1: a chain seen twice a moment apart has decayed to
    # just under 2 hits (and one seen once to just under 1, so only the
    # two shared first blocks are hot).
    engine = port_engine(weights, engine_config(
        None, num_pages=256, scheduler={"max_model_len": 512},
        kvecon=port_config.KVEconConfig(admit_hits=1)))
    with PortServer(engine) as srv:
        for body in bodies:
            path = ("/v1/chat/completions" if "messages" in body
                    else "/v1/completions")
            assert request("POST", srv.url + path, body)[0] == 200
        status, text, _ = request("GET", srv.url + "/kv/summary")
    summary = json.loads(text)
    ref = JaxTracker(top_k=64, admit_hits=1, ttl_s=900.0)
    for body in bodies:
        ref.observe_text(jax_routable_text(body))
    expect = ref.snapshot()
    assert status == 200 and len(expect) == 2
    # The same chains with the same decayed hits (the two trackers saw
    # them at slightly different times, so ties may order otherwise).
    got = dict(summary["hot_chains"])
    assert set(got) == {h for h, _ in expect}
    assert all(abs(got[h] - v) < 1e-2 for h, v in expect)
    assert summary["top_k"] == 64 and summary["kv_dtype"] == "bf16"
    assert summary["total_pages"] == 255
    assert 0 < summary["free_pages"] <= 255


# ---- preempt-to-offload ---------------------------------------------------------------


INTER_PROMPT = list(range(100, 148))
BG_PROMPT = list(range(500, 548))


def _run_pair_under_pressure(engine, sampling_cls, states):
    """Two 48-token prompts, 48 greedy tokens each, on a cache too small
    for both: the generated suffix of each ('inter', 'bg'). Preemption
    folds generated tokens into the prompt, so the suffix of
    ``all_token_ids`` is the stream."""
    ids = [engine.add_request(list(p), sampling_cls(
               max_tokens=48, temperature=0.0, ignore_eos=True),
               priority=int(pri))
           for p, pri in ((INTER_PROMPT, Priority.INTERACTIVE),
                          (BG_PROMPT, Priority.BACKGROUND))]
    seqs = [engine.sequences[i] for i in ids]
    for _ in range(3000):
        if all(s.state in (states.FINISHED, states.ABORTED) for s in seqs):
            break
        engine.step()
    assert all(s.state == states.FINISHED for s in seqs)
    return {"inter": seqs[0].all_token_ids[len(INTER_PROMPT):],
            "bg": seqs[1].all_token_ids[len(BG_PROMPT):]}


def _pressure_engine(weights, kv_dtype, offload, preempt_to_offload=True,
                     num_pages=None, async_on=False, unified=False,
                     layout="auto"):
    pages = num_pages or (3 if kv_dtype == "int8" else 12)
    return port_engine(weights, engine_config(
        None, kv_dtype=kv_dtype, checkpoint=0, num_pages=pages,
        layout=layout,
        enable_offload=offload, host_pool_bytes=256 * 1024 ** 2,
        qos=port_config.QoSConfig(preempt_to_offload=preempt_to_offload),
        scheduler={"async_scheduling": async_on,
                   "unified_step": unified}))


@pytest.fixture(scope="module")
def jax_pressure_streams(weights):
    """The JAX engine's streams under the same pressure, with
    preempt-to-offload, for bf16-family and int8 KV."""
    import jax.numpy as jnp

    from production_stack_tpu.engine import config as jc
    from production_stack_tpu.engine.engine import LLMEngine as JaxEngine
    from production_stack_tpu.engine.sequence import (
        SamplingParams as JaxSampling,
        SequenceState as JaxStates,
    )
    out = {}
    for kv_dtype in ("auto", "int8"):
        engine = JaxEngine(jc.EngineConfig(
            model=jc.tiny_model_config("llama"),
            cache=jc.CacheConfig(page_size=16,
                                 num_pages=3 if kv_dtype == "int8" else 12,
                                 kv_cache_dtype=kv_dtype),
            scheduler=jc.SchedulerConfig(max_num_seqs=2, max_model_len=256,
                                         prefill_chunk_size=64),
            offload=jc.OffloadConfig(enable=True,
                                     host_pool_bytes=256 * 1024 ** 2)),
            params={k: jnp.asarray(v) for k, v in weights.items()})
        out[kv_dtype] = (_run_pair_under_pressure(engine, JaxSampling,
                                                   JaxStates),
                         dict(engine.scheduler.preempt_offload_outcomes))
    return out


@pytest.mark.parametrize("async_on,unified", [(False, False),
                                              (True, True)])
@pytest.mark.parametrize("kv_dtype", ["auto", "int8"])
def test_preempt_to_offload_parity(weights, jax_pressure_streams, kv_dtype,
                                   async_on, unified):
    """A preempted victim whose KV shipped to the host tier and came
    back continues byte-identically: equal to a recompute, to an
    unpressured run and to the JAX engine under the same pressure."""
    ref = _run_pair_under_pressure(_pressure_engine(
        weights, kv_dtype, False, False, num_pages=128), SamplingParams,
        SequenceState)
    offl = _pressure_engine(weights, kv_dtype, True, async_on=async_on,
                            unified=unified)
    got = _run_pair_under_pressure(offl, SamplingParams, SequenceState)
    outcomes = offl.scheduler.preempt_offload_outcomes
    assert offl.scheduler.num_preemptions > 0 and outcomes["offloaded"] > 0
    assert offl.offload.offloaded_pages > 0
    reco = _pressure_engine(weights, kv_dtype, True, False,
                            async_on=async_on, unified=unified)
    assert _run_pair_under_pressure(reco, SamplingParams,
                                    SequenceState) == got
    assert reco.scheduler.preempt_offload_outcomes["offloaded"] == 0
    assert reco.scheduler.preempt_offload_outcomes["recompute"] > 0
    assert got == ref
    jax_streams, jax_outcomes = jax_pressure_streams[kv_dtype]
    assert got == jax_streams and jax_outcomes["offloaded"] > 0


@pytest.mark.parametrize("kv_dtype", ["auto", "int8"])
def test_preempt_to_offload_parity_stacked(weights, jax_pressure_streams,
                                           kv_dtype):
    """The same pressure over the stacked cache layout, async and
    unified steps on, on a budget (8 pages in bf16) where the victim's
    cached pages are reused before it returns: its pages come back from
    the host pool, and the streams are byte-identical to a recompute's,
    an unpressured run's and the JAX engine's. (A stacked page read on
    the CPU used to be a view of the cache, so the pool's copy changed
    with the reused slot.)"""
    pages = 8 if kv_dtype == "auto" else None
    ref = _run_pair_under_pressure(_pressure_engine(
        weights, kv_dtype, False, False, num_pages=128, layout="stacked"),
        SamplingParams, SequenceState)
    offl = _pressure_engine(weights, kv_dtype, True, num_pages=pages,
                            async_on=True, unified=True, layout="stacked")
    got = _run_pair_under_pressure(offl, SamplingParams, SequenceState)
    assert offl.scheduler.preempt_offload_outcomes["offloaded"] > 0
    assert offl.offload.restored_pages > 0
    reco = _pressure_engine(weights, kv_dtype, True, False, num_pages=pages,
                            async_on=True, unified=True, layout="stacked")
    assert _run_pair_under_pressure(reco, SamplingParams,
                                    SequenceState) == got
    assert got == ref == jax_pressure_streams[kv_dtype][0]


def test_abort_while_evicted_releases_everything(weights):
    """A victim parked in AWAITING_KV (its KV shipped) is aborted: no
    page leaks, no queue residue, and the other request finishes."""
    engine = _pressure_engine(weights, "auto", True)
    inter = engine.add_request(list(INTER_PROMPT), SamplingParams(
        max_tokens=48, temperature=0.0, ignore_eos=True),
        priority=int(Priority.INTERACTIVE))
    bg = engine.add_request(list(BG_PROMPT), SamplingParams(
        max_tokens=48, temperature=0.0, ignore_eos=True),
        priority=int(Priority.BACKGROUND))
    bg_seq = engine.sequences[bg]
    for _ in range(3000):
        if bg_seq.state == SequenceState.AWAITING_KV:
            break
        engine.step()
    assert bg_seq.state == SequenceState.AWAITING_KV
    engine.abort_request(bg)
    inter_seq = engine.sequences[inter]
    for _ in range(3000):
        if inter_seq.state == SequenceState.FINISHED:
            break
        engine.step()
    assert inter_seq.state == SequenceState.FINISHED
    assert not engine.has_work() and engine.scheduler.num_waiting == 0
    assert engine.cache_manager.num_used_pages == 0


# ---- /metrics ---------------------------------------------------------------------


FLEET_METRICS = [
    "vllm:engine_draining", 'vllm:qos_shed_total{class="batch"}',
    'vllm:qos_shed_total{class="interactive"}',
    'vllm:qos_shed_total{class="background"}',
    "vllm:kv_summary_hot_chains", "vllm:kv_cluster_hits_total",
    "vllm:kv_cluster_misses_total", "vllm:kv_cluster_admissions_total",
    "vllm:kv_cluster_rejections_total",
    'vllm:preempt_offload_total{outcome="offloaded"}',
    'vllm:preempt_offload_total{outcome="recompute"}',
    "vllm:disagg_awaiting_kv_requests",
    "vllm:preempt_restore_latency_seconds_count",
    "vllm:disagg_handoff_latency_seconds_count",
]
# The engine's checkpoint, resume and offload-tier counters, under the
# names of the JAX engine's stats().
STATS_METRICS = [
    "checkpoint_ships_total", "checkpoint_kv_bytes_total",
    "stream_resumes_total", "kv_offload_host_pages",
    "kv_offload_host_bytes", "kv_offload_host_hit_rate",
    "kv_offload_offloaded_pages", "kv_offload_restored_pages",
]


def test_fleet_metrics_use_the_reference_names(weights, cache_url):
    with PortServer(port_engine(weights, engine_config(cache_url))) as srv:
        capture = request("POST", srv.url + "/v1/chat/completions",
                          LONG_CHAT)
        assert capture[0] == 200
        text = request("GET", srv.url + "/metrics")[1]
    jax_server = (ROOT / "production_stack_tpu/engine/server.py").read_text()
    jax_metrics = (ROOT / "production_stack_tpu/engine/metrics.py"
                   ).read_text()
    jax_engine = (ROOT / "production_stack_tpu/engine/engine.py").read_text()
    jax_offload = (ROOT / "production_stack_tpu/engine/offload.py"
                   ).read_text()
    for name in FLEET_METRICS:
        assert re.search("^" + re.escape(name) + " ", text, re.M), name
        base = re.sub(r"\{.*|_count$", "", name)
        assert base in jax_server or base in jax_metrics, name
    for name in STATS_METRICS:
        assert re.search(f"^vllm:{name} ", text, re.M), name
        key = name.replace("kv_offload_", "")
        assert f'"{key}"' in jax_engine or f'"{key}"' in jax_offload, name
    ships = float(re.search(r"^vllm:checkpoint_ships_total (\S+)", text,
                            re.M).group(1))
    assert ships > 0


# ---- the router in front of two port servers ------------------------------------------


def test_router_resumes_a_migrated_stream_on_the_other_server(weights,
                                                             cache_url):
    """The repo's router, unchanged, over two port servers sharing a
    remote KV tier: a migrate drain on the server streaming a greedy
    chat cuts it at a checkpoint frame, the router resumes it on the
    other server, and the client's text is byte-identical to an
    uninterrupted run."""
    from aiohttp.test_utils import TestClient, TestServer

    from production_stack_tpu.router.app import build_app
    from production_stack_tpu.router.resilience import (
        ResilienceConfig,
        initialize_resilience,
    )
    from production_stack_tpu.router.routing.logic import (
        initialize_routing_logic,
    )
    from production_stack_tpu.router.service_discovery import (
        initialize_service_discovery,
    )
    from production_stack_tpu.router.services import request_service
    from production_stack_tpu.router.services.rewriter import (
        initialize_request_rewriter,
    )
    from production_stack_tpu.router.stats.engine_stats import (
        initialize_engine_stats_scraper,
    )
    from production_stack_tpu.router.stats.request_stats import (
        initialize_request_stats_monitor,
    )

    body = dict(LONG_CHAT, max_tokens=64)
    servers = [PortServer(_slowed(port_engine(weights, engine_config(
        cache_url)), 0.02)) for _ in range(2)]
    try:
        # The uninterrupted run, straight from a third server.
        with PortServer(port_engine(weights, engine_config(
                cache_url, checkpoint=0))) as ref:
            status, raw, _ = request("POST", ref.url +
                                     "/v1/chat/completions", body)
        expected = "".join(delta_content(e) for kind, e in
                           parse_stream(raw) if kind == "data")
        assert parse_stream(raw)[-1][1]["choices"][0][
            "finish_reason"] == "length"

        async def run():
            request_service.stream_resumes_by_outcome.clear()
            request_service._poison_crashes.clear()
            urls = [s.url for s in servers]
            initialize_service_discovery("static", urls=urls,
                                         models=["tiny-llama"] * 2)
            initialize_request_stats_monitor(60.0)
            initialize_engine_stats_scraper(3600.0)
            initialize_routing_logic("roundrobin")
            initialize_request_rewriter("noop")
            initialize_resilience(ResilienceConfig(
                max_retries=2, backend_connect_timeout=5.0,
                backend_timeout=60.0, health_check_interval=0.0))
            client = TestClient(TestServer(build_app()))
            await client.start_server()
            try:
                resp = await client.post("/v1/chat/completions", json=body)
                assert resp.status == 200
                text = ""
                drained = None
                async for chunk in resp.content.iter_any():
                    text += chunk.decode()
                    if drained is None and text.count("data: ") >= 4:
                        drained = next(s for s in servers
                                       if s.app._active > 0)
                        with drained.engine._lock:
                            drained.app.drain({"migrate": True})
                return text, drained, dict(
                    request_service.stream_resumes_by_outcome)
            finally:
                await client.close()

        text, drained, outcomes = asyncio.run(run())
    finally:
        for s in servers:
            s.stop()
    assert drained is not None
    other = next(s for s in servers if s is not drained)
    assert outcomes.get("migrated", 0) == 1, outcomes
    events = parse_stream(text)
    got = "".join(delta_content(e) for kind, e in events if kind == "data")
    assert got == expected
    assert "ckpt" not in [k for k, _ in events]  # the router strips them
    assert text.rstrip().endswith("data: [DONE]")
    assert other.engine.stats()["stream_resumes_total"] == 1
    assert other.engine.offload.restored_pages > 0
