"""The port's device performance observatory
(``engine/perf_observatory.py``), modelled on the reference's
``tests/test_perf_observatory.py``: the peak table (NVIDIA cards only;
an unknown device gives 0), useful-token MFU arithmetic against the JAX
engine's token count on the same run, the capture ledger (first run then
stable, one event a new bucket shape) driven through ``StepGraphs``'
stand-in graph class, the memory ledger's bytes equal to the JAX
ledger's at the same config (f32, bf16 and int8 KV), ``/debug/compiles``
and ``/debug/memory`` and their 404 without an observatory, the
PSTPU_TIMING dispatch ledger under ``/debug/compiles``' ``timings``
against the JAX server's on the same greedy requests, and the
``/metrics`` names against the JAX server's text and the router's
parser.

Tiny-llama with the JAX package's random weights, converted.
"""

import dataclasses
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from production_stack_tpu.engine import config as jax_config
from production_stack_tpu.engine import model_runner as jax_model_runner
from production_stack_tpu.engine.engine import LLMEngine as JaxEngine
from production_stack_tpu.engine.server import EngineServer as JaxServer
from production_stack_tpu.engine.sequence import (
    SamplingParams as JaxSampling,
)
from production_stack_tpu.models import llama as jax_llama
from production_stack_tpu.router.stats.engine_stats import EngineStats
from production_stack_tpu_torch.engine import config as port_config
from production_stack_tpu_torch.engine import model_runner
from production_stack_tpu_torch.engine.engine import LLMEngine
from production_stack_tpu_torch.engine.perf_observatory import (
    PEAK_FLOPS_BY_DEVICE_KIND,
    resolve_peak_flops,
)
from production_stack_tpu_torch.engine.sequence import SamplingParams
from production_stack_tpu_torch.engine.step_graphs import (
    STEP_KINDS,
    StepGraphs,
)
from production_stack_tpu_torch.models.convert import params_from_numpy
from tests.test_torch_crash_recovery import (
    PortServer,
    _serve_app_in_thread,
    request,
)
from tests.test_torch_step_graphs import RecordingGraph

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def weights():
    cfg = jax_config.tiny_model_config("llama")
    return {k: np.asarray(v) for k, v in
            jax_llama.init_params(cfg, jax.random.PRNGKey(11)).items()}


def _config(cfg, kv_dtype="auto", dtype=None, **sched):
    model = cfg.tiny_model_config("llama")
    if dtype is not None:
        model = dataclasses.replace(model, dtype=dtype)
    return cfg.EngineConfig(
        model=model,
        cache=cfg.CacheConfig(page_size=16, num_pages=128,
                              kv_cache_dtype=kv_dtype),
        scheduler=cfg.SchedulerConfig(max_num_seqs=4, max_model_len=256,
                                      prefill_chunk_size=32, **sched))


def _engine(weights, kv_dtype="auto", graphed=False):
    cfg = _config(port_config, kv_dtype)
    engine = LLMEngine(cfg, params=params_from_numpy(weights, cfg.model,
                                                     "cpu"), device="cpu")
    if graphed:
        engine.runner.graphs = StepGraphs(
            torch.device("cpu"), generators=[engine.runner.generator],
            graph_factory=RecordingGraph,
            observatory=engine.runner.observatory)
    return engine


def _run(engine, prompt, max_tokens=4, sampling=SamplingParams):
    sid = engine.add_request(list(prompt), sampling(
        temperature=0.0, max_tokens=max_tokens, ignore_eos=True))
    seq = engine.sequences[sid]
    while engine.has_work():
        engine.step()
    return list(seq.output_token_ids)


# ---- the peak table ----------------------------------------------------------


def test_resolve_peak_flops():
    assert resolve_peak_flops("NVIDIA H100 80GB HBM3", 123.0) == 123.0
    assert resolve_peak_flops("NVIDIA H100 80GB HBM3") == 989e12
    assert resolve_peak_flops("nvidia h100 80gb hbm3") == 989e12
    # Unknown devices, the CPU included, report 0 and never a guess;
    # no TPU entry is in the port's table.
    for kind in ("cpu", "", None, "TPU v5e", "TPU v4", "NVIDIA A100"):
        assert resolve_peak_flops(kind) == 0.0
    assert all(k.startswith("NVIDIA ") for k in PEAK_FLOPS_BY_DEVICE_KIND)


def test_mfu_arithmetic_and_tokens_against_jax(weights):
    engine = _engine(weights)
    obs = engine.runner.observatory
    assert obs.peak_flops == 0.0 and obs.device_kind == ""
    assert _run(engine, range(2, 12)) and obs.mfu() == 0.0
    # Committed tokens: the 10 prompt tokens of the prefill step and
    # the 3 decode tokens after the first; the JAX ledger counts the
    # same on the same run.
    jax_engine = JaxEngine(_config(jax_config), params={
        k: jnp.asarray(v) for k, v in weights.items()})
    _run(jax_engine, range(2, 12), sampling=JaxSampling)
    jax_obs = jax_engine.runner.observatory
    assert obs.tokens_total == jax_obs.tokens_total == 13
    assert obs.tokens_by_kind() == jax_obs.tokens_by_kind()
    assert obs.param_count == jax_obs.param_count
    assert obs.device_seconds_total > 0
    obs.peak_flops = 1e9
    assert obs.mfu() == pytest.approx(
        2.0 * obs.param_count * 13 / obs.device_seconds_total / 1e9)
    medians = obs.step_time_medians()
    assert set(medians) == {"prefill", "decode"}
    assert all(v > 0 for v in medians.values())
    # The override flag wins over the table.
    cfg = dataclasses.replace(_config(port_config), device_peak_flops=5e12)
    assert LLMEngine(cfg, device="cpu").runner.observatory.peak_flops == 5e12


def test_observatory_none_is_passthrough_byte_identical(weights):
    expected = _run(_engine(weights), range(2, 20), max_tokens=8)
    bare = _engine(weights)
    bare.runner.observatory = None
    assert _run(bare, range(2, 20), max_tokens=8) == expected


# ---- the capture ledger --------------------------------------------------------


def test_capture_ledger_first_run_then_stable(weights):
    engine = _engine(weights, graphed=True)
    obs = engine.runner.observatory
    graphs = engine.runner.graphs
    assert obs.compile_events_by_kind() == dict.fromkeys(STEP_KINDS, 0)
    assert len(_run(engine, range(2, 12))) == 4
    first = obs.compile_events_total("step")
    assert first == graphs.captures["step"] == len(graphs.keys()) == 2
    assert obs.compile_seconds_by_kind()["step"] > 0
    assert obs.executable_cache_sizes()["step"] == first
    for entry in obs.recent_compiles():
        assert entry["kind"] == "step" and entry["seconds"] > 0
        assert isinstance(entry["key"], list) and entry["cache_size"] >= 1
    # The same shapes again capture nothing.
    _run(engine, range(30, 40))
    assert obs.compile_events_total("step") == first
    # A prompt in the next prefill bucket (16 -> 32) captures once more,
    # and the ring records its shape.
    _run(engine, range(2, 22))
    assert obs.compile_events_total("step") == first + 1
    assert obs.recent_compiles()[-1]["key"][-1] == 32
    assert obs.compile_events_by_kind() == graphs.captures


def test_compiles_route_and_metrics_agree_with_the_graphs(weights):
    engine = _engine(weights, graphed=True)
    with PortServer(engine) as srv:
        body = {"prompt": list(range(2, 30)), "max_tokens": 4,
                "temperature": 0, "ignore_eos": True}
        assert request("POST", srv.url + "/v1/completions", body)[0] == 200
        status, text, _ = request("GET", srv.url + "/debug/compiles")
        report = json.loads(text)
        metrics = request("GET", srv.url + "/metrics")[1]
        assert request("GET", srv.url + "/debug/compiles?limit=1")[1]
        one = json.loads(request("GET", srv.url
                                 + "/debug/compiles?limit=1")[1])
        assert request("GET", srv.url
                       + "/debug/compiles?limit=nope")[0] == 400
    assert status == 200
    captures = engine.runner.graphs.captures
    assert report["events"] == captures and captures["step"] == 2
    assert report["executable_cache_sizes"]["step"] == 2
    assert len(report["recent"]) == 2 and len(one["recent"]) == 1
    assert report["timings"] == {}  # PSTPU_TIMING unset: no clock
    stats = EngineStats.from_prometheus_text(metrics)
    assert stats.compile_events_by_kind == {k: float(v)
                                            for k, v in captures.items()}
    assert stats.executable_cache_size_by_kind["step"] == 2.0


# ---- the PSTPU_TIMING dispatch ledger --------------------------------------------


def _timed_requests(engine, sampling):
    """The same greedy requests on either engine: two prompts prefilled
    together, two decode steps, a third prompt arriving (unified mixed
    steps, one over a 40-token prompt's two chunks), then to the end."""
    def add(prompt):
        return engine.sequences[engine.add_request(prompt, sampling(
            temperature=0.0, max_tokens=6, ignore_eos=True))]

    seqs = [add(list(range(2 + i, 14 + i))) for i in range(2)]
    for _ in range(2):
        engine.step()
    seqs.append(add(list(range(40, 80))))
    while engine.has_work():
        engine.step()
    return [list(seq.output_token_ids) for seq in seqs]


@pytest.mark.parametrize("timing,spec_k", [(True, 0), (False, 0),
                                            (True, 2)])
def test_timings_carry_the_jax_servers_dispatch_kinds(weights, monkeypatch,
                                                      timing, spec_k):
    """With PSTPU_TIMING on (both packages' flag monkeypatched), the same
    greedy requests through the port's engine and the JAX engine (unified
    step on, async off; and with prompt-lookup drafts of 2): each
    ``/debug/compiles`` ``timings`` has the same kinds with the same
    dispatch counts, every wall positive, and the port logs JAX's
    ``timing <kind> t=<n> <s>`` line. Off, both read {}."""
    monkeypatch.setattr(model_runner, "_TIMING", timing)
    monkeypatch.setattr(jax_model_runner, "_TIMING", timing)
    cfg = _config(port_config, unified_step=True, speculative_k=spec_k)
    engine = LLMEngine(cfg, params=params_from_numpy(weights, cfg.model,
                                                     "cpu"), device="cpu")
    lines = []
    monkeypatch.setattr(model_runner, "_timing_log",
                        lambda kind, t, wall: lines.append((kind, t, wall)))
    ours = _timed_requests(engine, SamplingParams)
    jax_engine = JaxEngine(_config(jax_config, unified_step=True,
                                   speculative_k=spec_k), params={
        k: jnp.asarray(v) for k, v in weights.items()})
    theirs = _timed_requests(jax_engine, JaxSampling)
    assert ours == theirs
    with PortServer(engine) as srv:
        got = json.loads(request("GET", srv.url + "/debug/compiles")[1])
    url, stop = _serve_app_in_thread(
        JaxServer(jax_engine, "tiny-llama").build_app())
    try:
        want = json.loads(request("GET", url + "/debug/compiles")[1])
    finally:
        stop()
    if not timing:
        assert got["timings"] == want["timings"] == {} and not lines
        return
    assert set(got["timings"]) == set(want["timings"]) == (
        {"decode", "prefill", "unified"} | ({"spec"} if spec_k else set()))
    assert {k: v["count"] for k, v in got["timings"].items()} == {
        k: v["count"] for k, v in want["timings"].items()}
    assert all(v["wall_seconds"] > 0 for v in got["timings"].values())
    assert len(lines) == sum(v["count"] for v in got["timings"].values())
    assert {kind for kind, _, _ in lines} == set(got["timings"])
    assert (("spec", spec_k + 1) if spec_k else ("decode", 1)) in {
        (kind, t) for kind, t, _ in lines}


def test_async_decodes_are_clocked_at_their_read(weights, monkeypatch):
    """Under async scheduling each decode dispatch is clocked from its
    launch to the engine's read of its result (no read of its own): one
    wall a dispatch, the greedy streams those of the unclocked engine."""
    cfg = _config(port_config, async_scheduling=True)

    def engine():
        return LLMEngine(cfg, params=params_from_numpy(weights, cfg.model,
                                                       "cpu"), device="cpu")

    want = _timed_requests(engine(), SamplingParams)
    monkeypatch.setattr(model_runner, "_TIMING", True)
    clocked = engine()
    runner = clocked.runner
    dispatched = []
    dispatch = runner.dispatch_decode
    monkeypatch.setattr(runner, "dispatch_decode", lambda *a, **k: (
        dispatched.append(1), dispatch(*a, **k))[1])
    assert _timed_requests(clocked, SamplingParams) == want
    timings = runner.observatory.dispatch_timings()
    assert timings["decode"]["count"] == len(dispatched) > 0
    assert timings["decode"]["wall_seconds"] > 0


# ---- the memory ledger -----------------------------------------------------------


@pytest.mark.parametrize("kv_dtype,dtype", [("auto", None),
                                            ("int8", None),
                                            ("auto", "bfloat16"),
                                            ("int8", "bfloat16")])
def test_hbm_ledger_equals_the_jax_ledger(weights, kv_dtype, dtype):
    """The analytic bytes of every category equal the JAX ledger's at
    the same config: weights over the same parameter shapes, pages and
    int8 scales from the page math (after the int8 page expansion),
    step buffers."""
    cfg = _config(port_config, kv_dtype, dtype)
    if dtype is None:
        params = params_from_numpy(weights, cfg.model, "cpu")
        jax_params = {k: jnp.asarray(v) for k, v in weights.items()}
    else:
        params = jax_params = None  # each side's own random init
    port = LLMEngine(cfg, params=params, device="cpu").runner.observatory
    ref = JaxEngine(_config(jax_config, kv_dtype, dtype),
                    params=jax_params).runner.observatory
    hbm = port.hbm_bytes()
    assert hbm == ref.hbm_bytes()
    model, cache = cfg.model, cfg.cache
    tokens = cache.num_pages * cache.page_size
    assert hbm["kv_pages"] + hbm["kv_scales"] == (
        tokens * cache.kv_bytes_per_token(model))
    if kv_dtype == "int8":
        slots = 2 * model.num_hidden_layers * model.num_key_value_heads
        assert hbm["kv_scales"] == slots * tokens * 4
        full_slot = model.head_dim * model.torch_dtype.itemsize
        assert cache.num_pages == 128 * full_slot // (model.head_dim + 4)
    else:
        assert hbm["kv_scales"] == 0
    report = port.memory_report()
    assert report["total_analytic_bytes"] == sum(hbm.values())
    assert report["num_pages"] == cache.num_pages
    assert "device" not in report  # the CPU has no allocator stats


def test_memory_route_and_404s_without_observatory(weights):
    engine = _engine(weights)
    with PortServer(engine) as srv:
        status, text, _ = request("GET", srv.url + "/debug/memory")
        assert status == 200
        mem = json.loads(text)
        assert mem["analytic"]["weights"] == sum(
            p.numel() * p.element_size()
            for p in engine.runner.params.parameters())
        assert mem["kv_cache_dtype"] == "bf16"
        engine.runner.observatory = None
        for path in ("/debug/compiles", "/debug/memory"):
            status, text, _ = request("GET", srv.url + path)
            assert status == 404
            assert "observatory" in json.loads(text)["error"]["message"]
        metrics = request("GET", srv.url + "/metrics")[1]
    assert "vllm:engine_mfu" not in metrics
    assert "vllm:engine_eager_steps_total" in metrics


# ---- /metrics -----------------------------------------------------------------------

OBSERVATORY_METRICS = {
    "engine_compile_events_total": "counter",
    "engine_compile_seconds_total": "counter",
    "engine_executable_cache_size": "gauge",
    "engine_hbm_bytes": "gauge",
    "engine_step_device_seconds_total": "counter",
    "engine_step_time_median_seconds": "gauge",
    "engine_mfu": "gauge",
    "engine_attention_impl": "gauge",
    "disagg_prefill_requests_total": "counter",
    "disagg_decode_requests_total": "counter",
    "disagg_kv_bytes_shipped_total": "counter",
    "disagg_awaiting_kv_requests": "gauge",
}


def test_metrics_names_and_types_are_the_jax_servers(weights):
    engine = _engine(weights)
    with PortServer(engine) as srv:
        assert request("POST", srv.url + "/v1/completions", {
            "prompt": list(range(2, 12)), "max_tokens": 3,
            "temperature": 0})[0] == 200
        text = request("GET", srv.url + "/metrics")[1]
    # The JAX server's source, its split string literals joined.
    src = re.sub(r'"\s*\n\s*"', "", (
        ROOT / "production_stack_tpu/engine/server.py").read_text())
    for name, kind in OBSERVATORY_METRICS.items():
        type_line = f"# TYPE vllm:{name} {kind}"
        assert type_line in src, name
        assert type_line in text.splitlines(), name
    for needle in ('vllm:engine_compile_events_total{kind="step"} 0.0',
                   'vllm:engine_hbm_bytes{category="weights"}',
                   'vllm:engine_step_device_seconds_total{kind="prefill"}',
                   "vllm:engine_mfu 0.0",
                   'vllm:engine_attention_impl{phase="decode",'
                   'impl="plain"} 1.0',
                   'vllm:engine_attention_impl{phase="unified",'
                   'impl="plain"} 1.0'):
        assert needle in text, needle
    stats = EngineStats.from_prometheus_text(text)
    assert stats.hbm_bytes_by_category["weights"] > 0
    assert stats.step_device_seconds_by_kind["prefill"] > 0
    assert stats.step_time_median_by_kind["decode"] > 0
    assert stats.engine_mfu == 0.0  # the CPU: no peak, honest zero
    assert stats.attention_impl_by_phase == {
        "decode": "plain", "prefill": "plain", "unified": "plain"}
