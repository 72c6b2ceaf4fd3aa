"""The step graphs of the port (engine/step_graphs.py) on the CPU.

The CPU has no CUDA graphs, so these tests drive ``StepGraphs`` with a
stand-in graph (``RecordingGraph``): its capture records the closure
(and runs it once for its output tensor), and each replay runs that
same closure with no arguments and writes the result into the captured
output, counting no kernel launch, as a replayed graph runs no Python.
A closure that read anything but its key's static inputs would replay
stale data here as on the card.

Greedy streams through the graphed runner are held byte for byte to the
eager runner's and to the JAX engine's, over the staggered mixed run of
``tests/test_torch_engine.py`` (tiny f32 llama, the same weights in
both), in sync and async scheduling, unified step off and on,
speculative decoding, bf16 (f32 here) and int8 KV, per-layer and
stacked caches, and decode bursts.
"""

import jax
import numpy as np
import pytest
import torch

from production_stack_tpu.engine import config as jax_config
from production_stack_tpu.engine.engine import LLMEngine as JaxEngine
from production_stack_tpu.engine.sequence import (
    SamplingParams as JaxSamplingParams,
    SequenceState as JaxSequenceState,
)
from production_stack_tpu.models import llama as jax_llama
from production_stack_tpu_torch.engine import config
from production_stack_tpu_torch.engine.engine import LLMEngine
from production_stack_tpu_torch.engine.sequence import (
    SamplingParams,
    SequenceState,
)
from production_stack_tpu_torch.engine.step_graphs import (
    STEP_KINDS,
    StepGraphs,
)
from production_stack_tpu_torch.models.convert import params_from_numpy
from production_stack_tpu_torch.ops.paged_kv_common import COUNTERS
from tests.test_torch_engine import _MAX_TOKENS, _prompts, _run_mixed

torch.set_num_threads(2)

CPU = torch.device("cpu")


class RecordingGraph:
    """A CUDA graph's stand-in: ``capture`` records the closure and
    returns its output (a tensor or a tuple of tensors); ``replay`` runs
    the recorded closure again, with no arguments, into that output, and
    leaves the launch counters as they were (a graph's replay runs no
    Python)."""

    def __init__(self):
        self.fn = None
        self.output = None
        self.warmed = 0
        self.replays = 0

    def warm(self, fn):
        self.warmed += 1
        fn()

    def capture(self, fn):
        self.fn = fn
        self.output = fn()
        return self.output

    def replay(self):
        counted = dict(COUNTERS.launches)
        result = self.fn()
        COUNTERS.launches.clear()
        COUNTERS.launches.update(counted)
        if isinstance(self.output, tuple):
            for out, new in zip(self.output, result):
                out.copy_(new)
        else:
            self.output.copy_(result)
        self.replays += 1


def _graphed(engine):
    """Give ``engine``'s runner step graphs with the stand-in."""
    engine.runner.graphs = StepGraphs(
        CPU, generators=[engine.runner.generator],
        graph_factory=RecordingGraph)
    return engine.runner.graphs


@pytest.fixture(scope="module")
def weights():
    cfg = jax_config.tiny_model_config("llama")
    return {k: np.asarray(v) for k, v in
            jax_llama.init_params(cfg, jax.random.PRNGKey(11)).items()}


def _config(cfg, unified=False, async_on=False, spec_k=0, kv="auto",
            layout="per_layer", decode_steps=1):
    return cfg.EngineConfig(
        model=cfg.tiny_model_config("llama"),
        cache=cfg.CacheConfig(page_size=16, num_pages=128,
                              kv_cache_dtype=kv, cache_layout=layout),
        scheduler=cfg.SchedulerConfig(
            max_num_seqs=4, max_model_len=256, prefill_chunk_size=32,
            unified_step=unified, async_scheduling=async_on,
            speculative_k=spec_k, decode_steps=decode_steps))


def _engine(weights, graphs, **kw):
    cfg = _config(config, **kw)
    engine = LLMEngine(cfg, params=params_from_numpy(weights, cfg.model,
                                                     "cpu"), device="cpu")
    if graphs:
        _graphed(engine)
    return engine


# ---- StepGraphs plumbing ----------------------------------------------------


def _double(inputs):
    return inputs["x"].long() * 2 + inputs["temperature"].long()


def _arrays(x, t=0.0):
    return {"x": np.asarray(x, np.int32),
            "temperature": np.full((len(x),), t, np.float32)}


def test_each_key_is_captured_once_and_replayed():
    graphs = StepGraphs(CPU, graph_factory=RecordingGraph)
    out = [graphs.run("step", (3, 1), "greedy", _arrays(x), _double)
           for x in ([1, 2, 3], [4, 5, 6], [7, 8, 9])]
    assert [o.tolist() for o in out] == [[2, 4, 6], [8, 10, 12],
                                         [14, 16, 18]]
    assert graphs.captures == {**dict.fromkeys(STEP_KINDS, 0), "step": 1}
    assert graphs.replays["step"] == 3
    assert graphs.keys() == [("step", (3, 1), "greedy", ())]
    assert graphs.capture_seconds["step"] > 0


def test_released_graphs_are_captured_anew():
    """``release`` drops every graph (a parallel engine's close does so
    before its process group goes); the next use of a key captures it
    again, with the same outputs."""
    graphs = StepGraphs(CPU, graph_factory=RecordingGraph)
    graphs.run("step", (3, 1), "greedy", _arrays([1, 2, 3]), _double)
    graphs.release()
    assert graphs.keys() == []
    out = graphs.run("step", (3, 1), "greedy", _arrays([4, 5, 6]), _double)
    assert out.tolist() == [8, 10, 12]
    assert graphs.captures["step"] == 2


def test_sampler_modes_and_shapes_are_separate_keys():
    graphs = StepGraphs(CPU, graph_factory=RecordingGraph)
    graphs.run("step", (3, 1), "greedy", _arrays([1, 2, 3]), _double)
    graphs.run("step", (3, 1), "random", _arrays([1, 2, 3], 1.0), _double)
    graphs.run("step", (2, 1), "greedy", _arrays([1, 2]), _double)
    graphs.run("unified", (3, 1), "greedy", _arrays([1, 2, 3]), _double)
    graphs.run("step", (3, 1), "random", _arrays([3, 2, 1], 1.0), _double)
    assert graphs.captures["step"] == 3 and graphs.captures["unified"] == 1
    assert len(graphs.keys()) == 4


def test_outputs_are_fresh_copies():
    """Each run returns a copy: a later replay of the same key never
    rewrites a result already handed out."""
    graphs = StepGraphs(CPU, graph_factory=RecordingGraph)
    first = graphs.run("step", (2, 1), "greedy", _arrays([1, 2]), _double)
    second = graphs.run("step", (2, 1), "greedy", _arrays([5, 6]), _double)
    assert first.tolist() == [2, 4] and second.tolist() == [10, 12]


def test_a_closure_over_stale_inputs_is_caught():
    """What the runner's tests below guard against: a body that reads
    its first call's values instead of the static inputs replays them.
    The replayed result then differs from the eager one."""
    graphs = StepGraphs(CPU, graph_factory=RecordingGraph)
    first = _arrays([1, 2])

    def stale(inputs):
        return torch.from_numpy(first["x"]).long() * 2

    graphs.run("step", (2, 1), "greedy", first, stale)
    got = graphs.run("step", (2, 1), "greedy", _arrays([5, 6]), stale)
    assert got.tolist() == [2, 4] != [10, 12]


def test_token_source_overwrites_the_tokens_input():
    graphs = StepGraphs(CPU, graph_factory=RecordingGraph)
    arrays = {"tokens": np.zeros((3,), np.int32),
              "temperature": np.zeros((3,), np.float32)}

    def body(inputs):
        return inputs["tokens"].long() + 1

    src = torch.tensor([7, 8, 9])
    assert graphs.run("step", (3, 1), "greedy", arrays, body,
                      token_source=src).tolist() == [8, 9, 10]
    # A strided source (a verify step's first column) copies as well.
    block = torch.tensor([[1, 0], [2, 0], [3, 0]])
    assert graphs.run("step", (3, 1), "greedy", arrays, body,
                      token_source=block[:, 0]).tolist() == [2, 3, 4]


def test_inputs_that_do_not_match_the_key_raise():
    graphs = StepGraphs(CPU, graph_factory=RecordingGraph)
    graphs.run("step", (2, 1), "greedy", _arrays([1, 2]), _double)
    with pytest.raises(ValueError, match="static input"):
        graphs.run("step", (2, 1), "greedy", _arrays([1, 2, 3]), _double)
    with pytest.raises(ValueError, match="differ from the key"):
        graphs.run("step", (2, 1), "greedy",
                   {"y": np.zeros(2, np.int32)}, _double)


def test_replayed_launches_are_added_to_the_counters():
    """The capture's launches are counted once while recording (when
    nothing runs): taken back then, added on every replay."""
    COUNTERS.reset()
    try:
        graphs = StepGraphs(CPU, graph_factory=RecordingGraph)

        def body(inputs):
            COUNTERS.launched("paged_decode")
            COUNTERS.launched("paged_decode")
            COUNTERS.launched("paged_ragged")
            return inputs["x"].clone()

        graphs.run("step", (2, 1), "greedy", _arrays([1, 2]), body)
        # The warm-up ran eagerly (1 + 1 counted), the capture recorded
        # (taken back), the first replay added its launches.
        assert COUNTERS.launches == {"paged_decode": 4, "paged_ragged": 2}
        for _ in range(3):
            graphs.run("step", (2, 1), "greedy", _arrays([3, 4]), body)
        assert COUNTERS.launches == {"paged_decode": 10, "paged_ragged": 5}
        assert not COUNTERS.plain_cuda_calls
    finally:
        COUNTERS.reset()


class _FailingCapture(RecordingGraph):
    def capture(self, fn):
        raise RuntimeError("capture failed: operation not permitted")


class _FailingReplay(RecordingGraph):
    def replay(self):
        raise RuntimeError("replay failed")


@pytest.mark.parametrize("graph_cls,message", [
    (_FailingCapture, "capture failed"), (_FailingReplay, "replay failed")])
def test_a_graph_failure_raises_with_no_eager_fallback(weights, graph_cls,
                                                       message):
    engine = _engine(weights, graphs=False)
    engine.runner.graphs = StepGraphs(CPU, graph_factory=graph_cls)
    engine.add_request([4, 5, 6] * 5, SamplingParams(
        temperature=0.0, max_tokens=4, ignore_eos=True))
    with pytest.raises(RuntimeError, match=message):
        engine.step()
    if graph_cls is _FailingCapture:
        # A failed capture leaves no entry behind to replay.
        assert engine.runner.graphs.keys() == []
        assert engine.runner.graphs.captures["step"] == 0


# ---- the runner through its graphs ------------------------------------------


@pytest.fixture(scope="module")
def jax_streams(weights):
    """The JAX engine's greedy streams by config (sync: the JAX async
    pipeline commits the same tokens)."""
    cache = {}

    def get(**kw):
        kw = dict(kw, async_on=False)
        key = tuple(sorted(kw.items()))
        if key not in cache:
            engine = JaxEngine(_config(jax_config, **kw),
                               params={k: jax.numpy.asarray(v)
                                       for k, v in weights.items()})
            cache[key] = _run_mixed(engine, JaxSamplingParams,
                                    JaxSequenceState.FINISHED)
        return cache[key]
    return get


FORMS = [
    dict(),
    dict(unified=True),
    dict(async_on=True),
    dict(unified=True, async_on=True),
    dict(unified=True, async_on=True, kv="int8"),
    dict(unified=True, async_on=True, layout="stacked"),
    dict(unified=True, async_on=True, kv="int8", layout="stacked"),
    dict(spec_k=3),
    dict(spec_k=3, async_on=True, layout="stacked"),
    dict(spec_k=3, unified=True, async_on=True, kv="int8"),
    dict(decode_steps=4),
    dict(decode_steps=4, unified=True, kv="int8", layout="stacked"),
]


def _form_id(form):
    return "-".join(f"{k}={v}" for k, v in form.items()) or "sync"


@pytest.mark.parametrize("form", FORMS, ids=_form_id)
def test_greedy_streams_match_eager_and_jax(weights, jax_streams, form):
    graphed = _engine(weights, graphs=True, **form)
    got = _run_mixed(graphed, SamplingParams, SequenceState.FINISHED)
    eager = _run_mixed(_engine(weights, graphs=False, **form),
                       SamplingParams, SequenceState.FINISHED)
    assert got == eager == jax_streams(**form)
    assert [len(t) for t in got] == _MAX_TOKENS
    graphs = graphed.runner.graphs
    # Every step went through a graph: one capture a key, replays on
    # every step, no eager step.
    assert sum(graphs.captures.values()) == len(graphs.keys()) > 0
    assert sum(graphs.replays.values()) >= sum(graphs.captures.values())
    assert graphs.eager_steps == {"seeded": 0, "embed": 0}
    kinds = {key[0] for key in graphs.keys()}
    assert "step" in kinds  # prefill steps, at least
    if form.get("unified"):
        assert "unified" in kinds
    if form.get("spec_k") and not form.get("unified"):
        assert "spec_verify" in kinds
    if form.get("decode_steps", 1) > 1:
        assert "decode_burst" in kinds
        # The stop sets pad to a fixed width: no key per width.
        assert {key[1][2] for key in graphs.keys()
                if key[0] == "decode_burst"} == {4}


def _decode_ready(weights, graphs):
    """An engine whose three rows have just finished their prefill."""
    engine = _engine(weights, graphs=graphs)
    seqs = []
    for prompt in _prompts()[:3]:
        sid = engine.add_request(prompt, SamplingParams(
            temperature=0.0, max_tokens=20, ignore_eos=True))
        seqs.append(engine.sequences[sid])
    while any(not s.output_token_ids for s in seqs):
        engine.step()
    return engine, seqs


def test_two_steps_with_different_inputs_give_the_eager_tokens(weights):
    """Two decode steps of one key with different inputs (rows, tokens,
    positions, pages) each give the eager runner's tokens: the
    captured closure reads the static inputs, never its first call's."""
    results = {}
    for graphs in (False, True):
        engine, seqs = _decode_ready(weights, graphs)
        runner = engine.runner
        a = runner.dispatch_decode(seqs).result()
        b = runner.dispatch_decode([seqs[2], None, seqs[0]]).result()
        results[graphs] = (a, b)
        if graphs:
            # One decode key, captured once: the second step replayed.
            decode = ("step", (4, 1), "greedy", ())
            assert decode in runner.graphs.keys()
            assert runner.graphs.captures["step"] == len(
                runner.graphs.keys())
    assert results[True] == results[False]
    assert results[True][0] != results[True][1]


def test_an_in_flight_handle_survives_the_next_ahead_dispatch(weights):
    """The async pipeline's order: step N queued, step N + 1 dispatched
    ahead from N's device tokens, THEN N read. N's tokens must be N's
    (the replay of N + 1 refills the key's static output)."""
    results = {}
    for graphs in (False, True):
        engine, seqs = _decode_ready(weights, graphs)
        runner = engine.runner
        first = runner.dispatch_decode(seqs)
        second = runner.dispatch_decode(seqs,
                                        token_source=first.token_source,
                                        ahead=True)
        results[graphs] = (first.result(), second.result())
    assert results[True] == results[False]
    first_tokens, second_tokens = results[True]
    assert first_tokens != second_tokens


def test_stochastic_steps_use_their_own_keys_and_repeat_at_one_seed(
        weights):
    def run():
        engine = _engine(weights, graphs=True)
        prompts = _prompts()
        # Alone, a greedy row's steps; then a masked stochastic row that
        # ends early beside an unmasked one.
        out = [engine.generate(prompts[0], SamplingParams(
            temperature=0.0, max_tokens=6, ignore_eos=True))]
        for prompt, sampling in (
                (prompts[1], dict(temperature=0.9, top_p=0.8, max_tokens=3)),
                (prompts[2], dict(temperature=0.7, max_tokens=10))):
            sid = engine.add_request(prompt, SamplingParams(
                ignore_eos=True, **sampling))
            out.append(engine.sequences[sid])
        while engine.has_work():
            engine.step()
        return [list(s.output_token_ids) for s in out], engine.runner.graphs

    a, graphs = run()
    b, _ = run()
    assert a == b  # the same seed: the same draws
    modes = {key[2] for key in graphs.keys()}
    assert modes == {"greedy", "random", "random_masked"}
    assert sum(graphs.captures.values()) == len(graphs.keys())


def test_a_seeded_step_runs_eagerly_and_is_counted(weights):
    sampling = dict(temperature=0.8, top_p=0.95, max_tokens=8, seed=5,
                    ignore_eos=True)
    got = {}
    for graphs in (False, True):
        engine = _engine(weights, graphs=graphs)
        # One prefill chunk: every step has the seeded row.
        seq = engine.generate([4, 5, 6] * 10, SamplingParams(**sampling))
        got[graphs] = list(seq.output_token_ids)
        if graphs:
            g = engine.runner.graphs
            assert g.eager_steps["seeded"] == (
                engine.metrics.pipeline_steps_total) == 8
            assert sum(g.captures.values()) == 0
    assert got[True] == got[False]
    assert len(got[True]) == 8


def test_the_cpu_runs_eagerly_by_default(weights):
    assert _engine(weights, graphs=False).runner.graphs is None
