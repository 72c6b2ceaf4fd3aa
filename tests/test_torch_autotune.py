"""The port's self-tuning controllers (production_stack_tpu_torch/
autotune/) against the JAX package's, modelled on the reference's
``tests/test_autotune.py``.

- The framework and the guardrail: one scripted scenario a case (mode
  gating, cadence, dead-band, clamps, holds and missing signals, a
  controller that raises, the allowlist, freeze, latch and reset of one
  controller and of all, drift and burn trips) runs through the JAX
  ``Autotuner`` and the port's with a fake clock; every step's applied
  targets, counters, ``status()``, freezes and decision span events
  must be equal.
- ``AutotuneConfig`` refuses the same values with the same messages.
- Each controller of the catalog, fed one scripted signal sequence
  (acceptance windows, ITL observations, free-page headroom with hit
  rates, resume counts, queue depths) through fakes built from its own
  package's histogram, config, sequence, pool and summary types, and
  ticked by its package's ``Autotuner``: equal decisions, knob
  trajectories and payloads, step by step; the drift flags likewise.
- Engines: tiny-llama with the same weights, speculative_k 3, unified
  step on, ``spec_k`` and ``qos_shed`` ticked by hand every few steps:
  greedy streams, draft counts and knob trajectories equal to the JAX
  engine's; ``shadow`` gives the ``off`` streams with every knob left
  at its static value.
- The capture lattice: on a runner with stand-in step graphs, every
  prefill budget in [chunk, chunk * prefill_batch] and every draft cap
  in [min_spec_k, K] captures only keys of the unified and verify
  lattices, each once.
- The server: ``/autotune/status`` and ``/autotune/reset`` answer the
  JAX payloads, ``/metrics`` carries the ``vllm:autotune_*`` lines.
"""

import dataclasses
import json
import threading
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax

from production_stack_tpu import autotune as jax_autotune
from production_stack_tpu.engine import config as jax_config
from production_stack_tpu.engine import metrics as jax_metrics
from production_stack_tpu.engine import offload as jax_offload
from production_stack_tpu.engine import sequence as jax_sequence
from production_stack_tpu.engine.engine import LLMEngine as JaxEngine
from production_stack_tpu.kvecon import summary as jax_summary
from production_stack_tpu.models import llama as jax_llama
from production_stack_tpu_torch import autotune as port_autotune
from production_stack_tpu_torch.engine import config as port_config
from production_stack_tpu_torch.engine import metrics as port_metrics
from production_stack_tpu_torch.engine import offload as port_offload
from production_stack_tpu_torch.engine import sequence as port_sequence
from production_stack_tpu_torch.engine.engine import LLMEngine
from production_stack_tpu_torch.engine.model_runner import (
    prefill_buckets,
    unified_row_buckets,
)
from production_stack_tpu_torch.engine.server import (
    EngineHTTPServer,
    EngineServer,
)
from production_stack_tpu_torch.engine.step_graphs import StepGraphs
from production_stack_tpu_torch.kvecon import summary as port_summary
from production_stack_tpu_torch.models.convert import params_from_numpy
from tests.test_torch_step_graphs import RecordingGraph

torch.set_num_threads(2)

JAX = SimpleNamespace(at=jax_autotune, cfg=jax_config, metrics=jax_metrics,
                      seq=jax_sequence, offload=jax_offload,
                      summary=jax_summary)
PORT = SimpleNamespace(at=port_autotune, cfg=port_config,
                       metrics=port_metrics, seq=port_sequence,
                       offload=port_offload, summary=port_summary)


class FakeClock:
    def __init__(self):
        self.now = 100.0

    def __call__(self):
        return self.now


class FakeTracer:
    """Records each decision event's fields (span ids are random)."""

    def __init__(self):
        self.events = []

    def start(self, sid, **kw):
        pass

    def event(self, sid, name, **fields):
        self.events.append((name, fields))

    def finish(self, sid, **kw):
        pass


def _scripted(pkg, name="scripted", lo=0.0, hi=100.0, value=10.0):
    """A controller of ``pkg`` that proposes its scripted signal."""

    class Scripted(pkg.at.Controller):
        def observe(self):
            if self.broken:
                raise RuntimeError("tick bomb")
            return self.signal

        def current(self):
            return self.value

        def propose(self, signal):
            return None if self.hold else signal

        def apply(self, target):
            self.applied.append(target)
            self.value = target

    Scripted.name = name
    c = Scripted(lo=lo, hi=hi)
    c.value, c.signal, c.applied = value, None, []
    c.hold = c.broken = False
    return c


# Each scenario: (autotune config, controllers as (name, lo, hi, value),
# ops). An op: ("signal", name, value), ("hold"|"break", name, bool),
# ("advance", seconds), ("tick",), ("maybe_tick",), ("flag", phase,
# value), ("burn", value), ("reset", name or None).
SCENARIOS = {
    "off_mode": (dict(mode="off"), [("scripted", 0, 100, 10)], [
        ("signal", "scripted", 99.0), ("maybe_tick",), ("advance", 10.0),
        ("maybe_tick",), ("advance", 10.0), ("maybe_tick",)]),
    "shadow_mode": (dict(mode="shadow"), [("scripted", 0, 100, 10)], [
        ("signal", "scripted", 20.0), ("tick",), ("signal", "scripted",
                                                  30.0), ("tick",)]),
    "on_mode": (dict(mode="on"), [("scripted", 0, 100, 10)], [
        ("signal", "scripted", 20.0), ("tick",), ("signal", "scripted",
                                                  40.0), ("tick",)]),
    "cadence": (dict(interval_s=2.0), [("scripted", 0, 100, 10)], [
        ("signal", "scripted", 20.0), ("maybe_tick",),
        ("signal", "scripted", 30.0), ("advance", 1.0), ("maybe_tick",),
        ("advance", 1.0), ("maybe_tick",), ("advance", 0.5),
        ("maybe_tick",)]),
    "dead_band": (dict(dead_band=0.1), [("scripted", 0, 200, 100)], [
        ("signal", "scripted", 105.0), ("tick",), ("signal", "scripted",
                                                   120.0), ("tick",),
        ("signal", "scripted", 110.0), ("tick",)]),
    "clamp": (dict(), [("scripted", 5, 15, 10)], [
        ("signal", "scripted", 1000.0), ("tick",),
        ("signal", "scripted", -1000.0), ("tick",)]),
    "hold_and_no_signal": (dict(), [("scripted", 0, 100, 10)], [
        ("tick",), ("hold", "scripted", True), ("signal", "scripted",
                                                50.0), ("tick",),
        ("hold", "scripted", False), ("tick",)]),
    "contained_exception": (dict(), [("boom", 0, 100, 1),
                                     ("scripted", 0, 100, 10)], [
        ("break", "boom", True), ("signal", "scripted", 20.0), ("tick",),
        ("break", "boom", False), ("signal", "boom", 7.0), ("tick",)]),
    "allowlist": (dict(controllers="other, scripted"),
                  [("scripted", 0, 100, 10), ("other", 0, 100, 10),
                   ("dropped", 0, 100, 10)], [
        ("signal", "other", 50.0), ("signal", "dropped", 50.0),
        ("tick",)]),
    "freeze_latch_reset_all": (dict(), [("scripted", 0, 100, 10)], [
        ("signal", "scripted", 20.0), ("tick",), ("advance", 5.0),
        ("flag", "decode", 1.0), ("signal", "scripted", 30.0), ("tick",),
        ("advance", 60.0), ("signal", "scripted", 40.0), ("tick",),
        ("advance", 60.0), ("tick",), ("reset", None),
        ("signal", "scripted", 50.0), ("tick",)]),
    "freeze_reset_one": (dict(freeze_window_s=10.0),
                         [("a", 0, 100, 10), ("b", 0, 100, 10),
                          ("c", 0, 100, 10)], [
        ("signal", "a", 20.0), ("signal", "b", 20.0), ("tick",),
        ("advance", 20.0), ("signal", "b", 30.0), ("signal", "c", 30.0),
        ("signal", "a", 20.0), ("tick",), ("advance", 1.0),
        ("flag", "prefill", 1.0), ("signal", "a", 60.0),
        ("signal", "b", 60.0), ("signal", "c", 60.0), ("tick",),
        ("reset", "b"), ("reset", "missing"), ("signal", "b", 70.0),
        ("signal", "c", 70.0), ("tick",), ("flag", "prefill", 0.0),
        ("tick",), ("reset", None), ("signal", "c", 90.0), ("tick",)]),
    "burn_trip": (dict(burn_threshold=1.0), [("scripted", 0, 100, 10)], [
        ("burn", 0.2), ("signal", "scripted", 20.0), ("tick",),
        ("burn", 0.5), ("signal", "scripted", 30.0), ("tick",),
        ("burn", 1.5), ("signal", "scripted", 45.0), ("tick",),
        ("burn", 0.1), ("signal", "scripted", 60.0), ("tick",)]),
}


def _run_scenario(pkg, name):
    cfg_kw, specs, ops = SCENARIOS[name]
    clock, tracer = FakeClock(), FakeTracer()
    flags, burn = {}, {"v": 0.0}
    ctrls = {n: _scripted(pkg, n, lo, hi, v) for n, lo, hi, v in specs}
    cfg = pkg.cfg.AutotuneConfig(**{"mode": "on", "interval_s": 1.0,
                                    "dead_band": 0.05, **cfg_kw})
    tuner = pkg.at.Autotuner(cfg, list(ctrls.values()), tracer=tracer,
                             clock=clock, drift_flags=lambda: dict(flags),
                             burn_rate=lambda: burn["v"])
    trail = []
    for op in ops:
        out = None
        if op[0] == "signal":
            ctrls[op[1]].signal = op[2]
        elif op[0] in ("hold", "break"):
            setattr(ctrls[op[1]], "hold" if op[0] == "hold" else "broken",
                    op[2])
        elif op[0] == "advance":
            clock.now += op[1]
        elif op[0] == "tick":
            tuner.tick()
        elif op[0] == "maybe_tick":
            out = tuner.maybe_tick()
        elif op[0] == "flag":
            flags[op[1]] = op[2]
        elif op[0] == "burn":
            burn["v"] = op[1]
        elif op[0] == "reset":
            out = tuner.reset(op[1])
        trail.append((op, out, {n: list(c.applied)
                                for n, c in ctrls.items()},
                      dict(tuner.decisions_total),
                      dict(tuner.applied_total), tuner.status(),
                      tuner.frozen_flags(), tuner.active_count(),
                      tuner.knob_values(), list(tracer.events)))
    return trail


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_framework_matches_jax_step_by_step(name):
    got, ref = _run_scenario(PORT, name), _run_scenario(JAX, name)
    for step, (a, b) in enumerate(zip(got, ref)):
        assert a == b, (name, step)
    assert len(got) == len(ref)


def test_scenarios_exercise_what_they_name():
    """The scenarios are not vacuous: the port's trail shows each
    behaviour (the JAX one is held equal above)."""
    def last(name):
        return _run_scenario(PORT, name)[-1]
    assert last("off_mode")[2] == {"scripted": []}
    assert last("shadow_mode")[3] == {"scripted": 2}
    assert last("shadow_mode")[2] == {"scripted": []}
    assert last("on_mode")[2] == {"scripted": [20.0, 40.0]}
    assert last("cadence")[2] == {"scripted": [20.0, 30.0]}
    assert last("dead_band")[2] == {"scripted": [120.0]}
    assert last("clamp")[2] == {"scripted": [15.0, 5.0]}
    assert last("hold_and_no_signal")[2] == {"scripted": [50.0]}
    assert last("contained_exception")[2] == {"boom": [7.0],
                                              "scripted": [20.0]}
    assert [c["name"] for c in last("allowlist")[5]["controllers"]] == [
        "scripted", "other"]
    trail = _run_scenario(PORT, "freeze_latch_reset_all")
    assert trail[5][6] == {"scripted": True}
    assert trail[-1][2] == {"scripted": [20.0, 50.0]}
    trail = _run_scenario(PORT, "freeze_reset_one")
    assert trail[13][6] == {"a": False, "b": True, "c": True}
    assert trail[14][1] == ["b"] and trail[15][1] == []
    assert _run_scenario(PORT, "burn_trip")[-1][6] == {"scripted": True}


@pytest.mark.parametrize("pkg", [JAX, PORT], ids=["jax", "port"])
def test_guardrail_burn_rise_and_single_reset(pkg):
    """The reference's guardrail cases, run in both packages with equal
    outcomes (the port's against the JAX expectations)."""
    clock = FakeClock()
    burn = {"v": 0.2}
    rail = pkg.at.DriftGuardrail(freeze_window_s=30.0, burn_threshold=1.0,
                                 burn_rate=lambda: burn["v"], clock=clock)
    rail.note_applied("old")
    clock.now += 100.0
    rail.note_applied("recent")
    clock.now += 1.0
    burn["v"] = 0.5
    assert rail.scan() == []
    burn["v"] = 1.5
    assert rail.scan() == ["recent"]
    assert rail.is_frozen("recent") and not rail.is_frozen("old")
    burn["v"] = 0.1
    rail.note_applied("old")
    assert rail.scan() == []
    assert rail.frozen() == {"recent": clock.now}
    assert rail.reset("missing") == []
    assert rail.reset("recent") == ["recent"] and rail.frozen() == {}
    broken = pkg.at.DriftGuardrail(drift_flags=lambda: 1 / 0,
                                   burn_rate=lambda: 1 / 0, clock=clock)
    broken.note_applied("x")
    assert broken.scan() == []  # signals that raise never trip


@pytest.mark.parametrize("kw", [
    dict(mode="auto"),
    dict(interval_s=0.0),
    dict(dead_band=1.0),
    dict(dead_band=-0.1),
    dict(freeze_window_s=-1.0),
    dict(min_spec_k=0),
    dict(min_checkpoint_interval_tokens=0),
    dict(min_checkpoint_interval_tokens=8192,
         max_checkpoint_interval_tokens=4096),
    dict(min_shed_threshold=0.0),
    dict(min_shed_threshold=1.5),
])
def test_autotune_config_refuses_what_jax_refuses(kw):
    with pytest.raises(ValueError) as ref:
        jax_config.AutotuneConfig(**kw)
    with pytest.raises(ValueError) as got:
        port_config.AutotuneConfig(**kw)
    assert str(got.value) == str(ref.value)


def test_autotune_config_fields_and_defaults_are_jaxs():
    assert (dataclasses.asdict(port_config.AutotuneConfig())
            == dataclasses.asdict(jax_config.AutotuneConfig()))
    assert port_config.AutotuneConfig().mode == "off"
    assert port_config.EngineConfig().autotune == (
        port_config.AutotuneConfig())
    assert port_autotune.MODES == jax_autotune.MODES
    assert set(port_autotune.__all__) == (
        set(jax_autotune.__all__) - {"PoolSplitController"})
    from production_stack_tpu.autotune.controller import (
        _parse_selection as jax_parse,
    )
    from production_stack_tpu_torch.autotune.controller import (
        _parse_selection as port_parse,
    )
    for spec in ("", "all", " all ", "spec_k", "spec_k, qos_shed,", None):
        assert port_parse(spec) == jax_parse(spec)


# ---- the catalog, one scripted signal sequence a controller ---------------


def _cfg(pkg, **kw):
    return pkg.cfg.AutotuneConfig(**{"mode": "on", "interval_s": 1.0,
                                     "dead_band": 0.05, **kw})


def _seq(pkg, seq_id):
    return pkg.seq.Sequence(seq_id=seq_id, prompt_token_ids=[1, 2, 3],
                            sampling=pkg.seq.SamplingParams())


def _spec_k_case(pkg):
    rng = np.random.RandomState(1)
    running = [_seq(pkg, f"s{i}") for i in range(4)]
    engine = SimpleNamespace(
        config=SimpleNamespace(
            scheduler=pkg.cfg.SchedulerConfig(speculative_k=6)),
        scheduler=SimpleNamespace(running=running))
    ctrl = pkg.at.SpecKController(engine, _cfg(pkg, min_spec_k=1))

    def feed(t):
        # Acceptance regimes: collapse, recovery, middling; a row
        # arrives and one finishes along the way.
        if t == 6:
            running.append(_seq(pkg, "late"))
        if t == 9:
            running.pop(0)
        rate = 0.05 if t < 5 else (0.95 if t < 12 else 0.55)
        for seq in running:
            d = int(rng.randint(0, 8))
            seq.spec_drafted_total += d
            seq.spec_accepted_total += int(rng.binomial(d, rate))
        return [(s.seq_id, s.spec_k_cap) for s in running]

    return ctrl, feed


def _prefill_budget_case(pkg):
    rng = np.random.RandomState(2)
    engine = SimpleNamespace(
        config=SimpleNamespace(scheduler=pkg.cfg.SchedulerConfig(
            unified_step=True, prefill_chunk_size=64,
            prefill_batch_size=4)),
        scheduler=SimpleNamespace(mixed_prefill_budget=256),
        metrics=pkg.metrics.EngineMetrics())
    ctrl = pkg.at.PrefillBudgetController(engine,
                                          _cfg(pkg, target_itl_ms=50.0))

    def feed(t):
        # Over target, then a window too small, then headroom, then the
        # +inf tail, then the dead zone between half and the target.
        n = 3 if t == 4 else 32
        scale = [0.2, 0.2, 0.2, 0.2, 0.2, 0.004, 0.004, 0.004, 0.004,
                 0.004, 50.0, 0.004, 0.04, 0.04][t % 14]
        for x in rng.uniform(0.5, 1.0, size=n) * scale:
            engine.metrics.itl.observe(float(x))
        return engine.scheduler.mixed_prefill_budget

    return ctrl, feed


def _kvecon_case(pkg):
    rng = np.random.RandomState(3)
    cm = SimpleNamespace(config=pkg.cfg.CacheConfig(num_pages=101),
                         num_free_pages=90, prefix_hit_tokens=0,
                         prefix_query_tokens=0)
    pool = pkg.offload.HostKVPool(max_bytes=1 << 20, watermark_high=1.0,
                                  watermark_low=0.9)
    kve = pkg.cfg.KVEconConfig(watermark_high=1.0, watermark_low=0.9)
    engine = SimpleNamespace(cache_manager=cm,
                             offload=SimpleNamespace(host=pool),
                             config=SimpleNamespace(kvecon=kve))
    tracker = pkg.summary.PrefixSummaryTracker(top_k=8, admit_hits=2)
    ctrl = pkg.at.KVEconController(engine, tracker, _cfg(pkg))

    def feed(t):
        # Page pressure with a weak hit rate, then headroom with a
        # paying one, then headroom with a weak one.
        cm.num_free_pages = int(rng.randint(0, 10) if t < 8
                                else rng.randint(60, 100))
        queries = int(rng.randint(50, 200))
        cm.prefix_query_tokens += queries
        cm.prefix_hit_tokens += int(queries * (0.05 if t < 8 else
                                               0.6 if t < 14 else 0.1))
        return (tracker.admit_hits, pool.watermark_high, pool.watermark_low)

    return ctrl, feed


def _checkpoint_case(pkg):
    engine = SimpleNamespace(
        config=pkg.cfg.EngineConfig(checkpoint_interval_tokens=1024),
        stream_resumes=0)
    ctrl = pkg.at.CheckpointIntervalController(
        engine, _cfg(pkg, min_checkpoint_interval_tokens=64,
                     max_checkpoint_interval_tokens=4096))

    def feed(t):
        engine.stream_resumes += [0, 2, 0, 1, 3, 0, 0, 0, 0, 0, 0, 0, 0,
                                  0, 0, 0, 0, 0][t % 18]
        return engine.config.checkpoint_interval_tokens

    return ctrl, feed


def _qos_case(pkg):
    engine = SimpleNamespace(
        config=pkg.cfg.EngineConfig(
            qos=pkg.cfg.QoSConfig(shed_threshold=0.95),
            scheduler=pkg.cfg.SchedulerConfig(max_queue_len=100)),
        scheduler=SimpleNamespace(num_waiting=10, spec_degrade_clamp=False))
    ctrl = pkg.at.QoSShedController(engine, _cfg(pkg, min_shed_threshold=0.5))
    depths = [10, 40, 60, 80, 85, 85, 30, 5, 2, 1, 0, 0, 20, 30, 3, 0]

    def feed(t):
        engine.scheduler.num_waiting = depths[t % len(depths)]
        return (engine.config.qos.shed_threshold,
                engine.scheduler.spec_degrade_clamp)

    return ctrl, feed


CATALOG = {"spec_k": _spec_k_case, "prefill_budget": _prefill_budget_case,
           "kvecon": _kvecon_case, "checkpoint_interval": _checkpoint_case,
           "qos_shed": _qos_case}


def _run_catalog(pkg, name, ticks=18):
    ctrl, feed = CATALOG[name](pkg)
    clock, tracer = FakeClock(), FakeTracer()
    tuner = pkg.at.Autotuner(_cfg(pkg), [ctrl], tracer=tracer, clock=clock)
    trail = []
    for t in range(ticks):
        knobs = feed(t)
        clock.now += 1.0
        tuner.tick()
        trail.append((knobs, tuner.status(),
                      dict(tuner.decisions_total),
                      dict(tuner.applied_total), ctrl.current(),
                      list(tracer.events)))
    return trail, tuner


@pytest.mark.parametrize("name", sorted(CATALOG))
def test_controller_trajectories_match_jax(name):
    got, port_tuner = _run_catalog(PORT, name)
    ref, _ = _run_catalog(JAX, name)
    for step, (a, b) in enumerate(zip(got, ref)):
        assert a == b, (name, step)
    # Each script moves its knob both ways or at least once.
    assert sum(port_tuner.applied_total.values()) >= 2, name


def test_drift_flags_match_jax():
    medians = {}
    runner = SimpleNamespace(observatory=SimpleNamespace(
        step_time_medians=lambda: dict(medians)))
    port = port_autotune.observatory_drift_flags(runner, band=0.25)
    ref = jax_autotune.observatory_drift_flags(runner, band=0.25)
    script = [{}, {"decode": 0.0}, {"decode": 0.01, "prefill": 0.2},
              {"decode": 0.0124, "prefill": 0.26},
              {"decode": 0.0126, "prefill": 0.1},
              {"decode": 0.011, "prefill": 0.3, "spec": 0.5}]
    for m in script:
        medians.clear()
        medians.update(m)
        assert port() == ref()
    assert port() == {"decode": 0.0, "prefill": 1.0, "spec": 0.0}
    assert port_autotune.observatory_drift_flags(
        SimpleNamespace(observatory=None))() == {}


# ---- engines: the JAX engine and the port's, ticked by hand ----------------


@pytest.fixture(scope="module")
def weights():
    cfg = jax_config.tiny_model_config("llama")
    return {k: np.asarray(v) for k, v in
            jax_llama.init_params(cfg, jax.random.PRNGKey(11)).items()}


def _engine_config(cfg, mode, async_on=False):
    return cfg.EngineConfig(
        model=cfg.tiny_model_config("llama"),
        cache=cfg.CacheConfig(page_size=16, num_pages=128),
        scheduler=cfg.SchedulerConfig(
            max_num_seqs=2, max_model_len=256, prefill_chunk_size=32,
            unified_step=True, async_scheduling=async_on, speculative_k=3,
            max_queue_len=8),
        autotune=cfg.AutotuneConfig(mode=mode, interval_s=1.0,
                                    controllers="spec_k,qos_shed",
                                    min_shed_threshold=0.5))


def _waves():
    """Prompts in three waves (tick: [(prompt, priority)]), so the
    waiting queue grows deep, then drains: the first wave interactive
    (it keeps drafting under the degrade clamp), the others batch.
    Repeated random blocks draft and are mostly rejected; short loops
    draft and are mostly accepted."""
    rs = np.random.RandomState(5)
    prompts = []
    for i in range(9):
        block = [int(x) for x in rs.randint(1, 500, size=2 + i % 3)]
        prompts.append((block * 30)[:24 + 5 * i])
    return {0: [(p, 0) for p in prompts[:3]],
            2: [(p, 1) for p in prompts[3:6]],
            4: [(p, 1) for p in prompts[6:]]}


def _drive(pkg, engine, every=3):
    """Submit the waves, step, tick every ``every`` steps; returns the
    greedy streams and, per tick, the knob values, status and each
    row's (cap, drafted)."""
    server = SimpleNamespace(
        engine=engine, kv_summary=pkg.summary.PrefixSummaryTracker())
    at = engine.config.autotune
    clock = FakeClock()
    tuner = pkg.at.Autotuner(at, pkg.at.build_engine_controllers(server, at),
                             clock=clock)
    sampling = pkg.seq.SamplingParams
    waves, seqs, trail = _waves(), [], []
    step = tick = 0
    while tick in waves or engine.has_work():
        if step % every == 0:
            for p, priority in waves.pop(tick, []):
                sid = engine.add_request(p, sampling(
                    temperature=0.0, max_tokens=40, ignore_eos=True),
                    priority=priority)
                seqs.append(engine.sequences[sid])
            clock.now += 1.0
            tuner.tick(clock.now)
            trail.append((tuner.knob_values(), tuner.status(),
                          [(s.spec_k_cap, s.spec_drafted_total)
                           for s in seqs], engine.scheduler.num_waiting))
            tick += 1
        engine.step()
        step += 1
        assert step < 2000
    return [list(s.output_token_ids) for s in seqs], trail, tuner


def _jax_engine(weights, mode, async_on=False):
    return JaxEngine(_engine_config(jax_config, mode, async_on),
                     params={k: jax.numpy.asarray(v)
                             for k, v in weights.items()})


def _port_engine(weights, mode, async_on=False):
    cfg = _engine_config(port_config, mode, async_on)
    return LLMEngine(cfg, params=params_from_numpy(weights, cfg.model,
                                                   "cpu"), device="cpu")


@pytest.mark.parametrize("async_on", [False, True],
                         ids=["sync", "async"])
def test_engine_autotune_on_matches_jax(weights, async_on):
    """Manual ticks between steps; with an explicit async pipeline under
    speculation too, where a tick runs between a dispatch and its read
    (in both packages this workload then rides the ahead plans, which
    draft nothing, so only the shed gate moves)."""
    ref_streams, ref_trail, _ = _drive(
        JAX, _jax_engine(weights, "on", async_on))
    engine = _port_engine(weights, "on", async_on)
    streams, trail, tuner = _drive(PORT, engine)
    assert streams == ref_streams
    for i, (a, b) in enumerate(zip(trail, ref_trail)):
        assert a == b, i
    assert len(trail) == len(ref_trail)
    # The loops closed: the queue's growth pulled the shed gate down and
    # set the degrade clamp at least once; in sync, the caps moved.
    assert tuner.applied_total["qos_shed"] > 0
    assert min(t[0]["qos_shed"] for t in trail) < 0.95
    if not async_on:
        assert tuner.applied_total["spec_k"] > 0
        assert engine.metrics.spec_draft_tokens_total > 0


def test_engine_autotune_shadow_is_off(weights):
    off_streams, off_trail, _ = _drive(PORT, _port_engine(weights, "off"))
    engine = _port_engine(weights, "shadow")
    streams, trail, tuner = _drive(PORT, engine)
    assert streams == off_streams
    assert sum(tuner.decisions_total.values()) > 0
    assert sum(tuner.applied_total.values()) == 0
    for knobs, _, rows, _ in trail:
        assert knobs == {"spec_k": 3.0, "qos_shed": 0.95}
        assert all(cap is None for cap, _ in rows)
    assert [r for _, _, r, _ in trail] == [r for _, _, r, _ in off_trail]
    assert engine.config.qos.shed_threshold == 0.95
    assert engine.scheduler.spec_degrade_clamp is False


def _hook_rows(pkg):
    rows = []
    for seq_id, priority in (("a", 0), ("b", 1)):
        seq = pkg.seq.Sequence(
            seq_id=seq_id, prompt_token_ids=[5, 6, 7] * 12,
            sampling=pkg.seq.SamplingParams(temperature=0.0,
                                            max_tokens=30),
            priority=priority)
        seq.output_token_ids = [5, 6]  # the period goes on: it drafts
        rows.append(seq)
    return rows


def test_scheduler_hooks_cap_and_clamp_drafts(weights):
    """The two hooks the controllers drive: a row's cap bounds its draft
    (the JAX scheduler's ``_draft_limit`` gives the same limits), and
    the degrade clamp drafts for interactive rows only."""
    sched = _port_engine(weights, "off").scheduler
    ref = _jax_engine(weights, "off").scheduler
    a, b = sched.running = _hook_rows(PORT)
    ref_rows = _hook_rows(JAX)
    for cap in (None, 3, 2, 1):
        a.spec_k_cap = b.spec_k_cap = ref_rows[0].spec_k_cap = cap
        assert sched._draft_limit(a) == ref._draft_limit(ref_rows[0])
        assert {len(d) for d in sched._propose().values()} == {
            min(3, cap or 3)}
    assert sched._draft_limit(a) == 1
    sched.spec_degrade_clamp = True
    assert set(sched._propose()) == {"a"}
    sched.spec_degrade_clamp = False
    assert set(sched._propose()) == {"a", "b"}


# ---- knob moves capture nothing outside the lattices ------------------------


def test_knob_sweep_stays_inside_the_capture_lattice(weights):
    cfg = _engine_config(port_config, "off")
    cfg.scheduler.max_num_seqs = 4
    cfg.scheduler.max_queue_len = 64
    engine = LLMEngine(cfg, params=params_from_numpy(weights, cfg.model,
                                                     "cpu"), device="cpu")
    runner = engine.runner
    graphs = runner.graphs = StepGraphs(
        torch.device("cpu"), generators=[runner.generator],
        graph_factory=RecordingGraph)
    sched_cfg = cfg.scheduler
    chunk, k = sched_cfg.prefill_chunk_size, sched_cfg.speculative_k
    budgets = list(range(chunk, chunk * sched_cfg.prefill_batch_size + 1))
    caps = list(range(port_config.AutotuneConfig().min_spec_k, k + 1))
    span = k + 1
    buckets = prefill_buckets(chunk)
    lattice = (
        {("step", (runner.prefill_width, t)) for t in buckets}
        | {("step", (runner.decode_width, 1)),
           ("spec_verify", (runner.decode_width, span))}
        | {("unified", (r, max(w, span)))
           for r in unified_row_buckets(runner.unified_rows)
           for w in buckets})
    rs = np.random.RandomState(9)
    sampling = port_sequence.SamplingParams(temperature=0.0, max_tokens=12,
                                            ignore_eos=True)
    seqs = []
    for i in range(len(budgets) + 1):
        if i < len(budgets):
            if i % 4 == 0:
                # Prompts of 9 to 200 tokens: chunked prefill, and rows
                # that repeat themselves, so verify steps draft.
                block = [int(x) for x in rs.randint(1, 500, size=4 + i % 5)]
                for n in (9 + i * 2, 40 + i, 200 - i):
                    sid = engine.add_request((block * 60)[:n], sampling)
                    seqs.append(engine.sequences[sid])
            engine.scheduler.mixed_prefill_budget = budgets[i]
            for j, seq in enumerate(engine.scheduler.running):
                seq.spec_k_cap = caps[(i + j) % len(caps)]
        engine.step()
    while engine.has_work():
        engine.step()
    keys = graphs.keys()
    assert {(kind, shape) for kind, shape, _, _ in keys} <= lattice
    assert sum(graphs.captures.values()) == len(keys) == len(set(keys))
    assert graphs.captures["unified"] > 0
    assert graphs.captures["spec_verify"] > 0
    assert engine.metrics.spec_draft_tokens_total > 0
    assert all(len(s.output_token_ids) == 12 for s in seqs)


# ---- the server -------------------------------------------------------------


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as resp:
        return resp.status, resp.read().decode()


def _post(url, data=b""):
    req = urllib.request.Request(url, data=data, method="POST",
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.status, resp.read().decode()


def test_server_autotune_routes_and_metrics_match_jax(weights):
    """The port server's autotuner against a JAX autotuner over the JAX
    engine's catalog at the same config: equal payloads before and after
    a freeze and the resets."""
    app = EngineServer(_port_engine(weights, "on"), "tiny-llama")
    assert [c.name for c in app.autotuner.controllers] == ["spec_k",
                                                            "qos_shed"]
    ref_engine = _jax_engine(weights, "on")
    at = ref_engine.config.autotune
    ref = jax_autotune.Autotuner(at, jax_autotune.build_engine_controllers(
        SimpleNamespace(engine=ref_engine,
                        kv_summary=jax_summary.PrefixSummaryTracker()), at))
    http = EngineHTTPServer(("127.0.0.1", 0), app)
    thread = threading.Thread(target=http.serve, daemon=True)
    thread.start()
    base = "http://127.0.0.1:%d" % http.server_address[1]
    try:
        status, text = _get(base + "/autotune/status")
        assert status == 200 and json.loads(text) == ref.status()
        for tuner in (app.autotuner, ref):
            tuner.guardrail._frozen["spec_k"] = 1.0
        assert json.loads(_get(base + "/autotune/status")[1]) == (
            ref.status())
        _, text = _get(base + "/metrics")
        for line in ("vllm:autotune_active_controllers 1.0",
                     'vllm:autotune_frozen{controller="spec_k"} 1.0',
                     'vllm:autotune_frozen{controller="qos_shed"} 0.0',
                     'vllm:autotune_knob_value{controller="spec_k"} 3.0',
                     'vllm:autotune_knob_value{controller="qos_shed"} 0.95',
                     'vllm:autotune_decisions_total{controller="spec_k"} '
                     "0.0"):
            assert "\n" + line + "\n" in text, line
        assert json.loads(_post(base + "/autotune/reset",
                                b'{"controller": "spec_k"}')[1]) == {
            "reset": ref.reset("spec_k")}
        for body in (b"", b"not json", b"[1]"):
            # No controller named: reset all (none left frozen).
            status, text = _post(base + "/autotune/reset", body)
            assert status == 200 and json.loads(text) == {
                "reset": ref.reset()}
        assert json.loads(_get(base + "/autotune/status")[1]) == (
            ref.status())
    finally:
        http.shutdown()
        thread.join(timeout=30)


def test_stub_engine_gets_an_empty_autotuner():
    """An engine without the scheduler and metrics the catalog reads
    (a stub) still gets a live autotuner, empty, so /autotune/status
    answers, as in the JAX server."""
    engine = SimpleNamespace(
        config=SimpleNamespace(kvecon=port_config.KVEconConfig(),
                               autotune=port_config.AutotuneConfig(
                                   mode="on")),
        tokenizer=None, tracer=None)
    app = EngineServer(engine, "stub")
    assert app.autotuner.controllers == []
    assert app.loop.autotuner is app.autotuner
    assert app.autotune_status() == (200, jax_autotune.Autotuner(
        jax_config.AutotuneConfig(mode="on"), []).status(), {})
    assert app.autotuner.maybe_tick() is False
