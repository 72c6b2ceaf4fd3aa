"""The per-row sampling options of the port against the JAX engine.

Ops: ``apply_penalties``, ``token_logprobs``, the ``min_tokens``
suppression and the guided mask of ``ops/sampling.py`` against the JAX
package's on the same numpy arrays (made from a seed), to 1e-6, and the
runner's payload functions against the JAX runner's, array for array.

Engine: both engines serve the tiny f32 llama with the same weights (the
JAX ``init_params`` dict, carried across with ``params_from_numpy``);
JAX attends through its XLA reference on the CPU, the port through its
kernels' plain versions. Ten greedy rows submitted together, one
prefill step for all: a free row, each penalty alone, ``logit_bias``
(a ban and small biases, and +100 forcing a token), ``min_tokens``
deferring EOS (forced by its bias) and deferring a stop id the row's
greedy stream would emit first, and two guided JSON rows (one pushed
past the start state's whitespace, one whose structural bytes are
biased so that it writes a key and a value); each guided output must
pass ``json.loads``. The streams must be byte-identical to the JAX
engine's at decode_steps 1 and 4, async on and off, unified on. The
twins of the reference's ``test_sampling.py:66,91``,
``test_multistep_decode.py:100``, ``test_logit_bias.py:53,83``,
``test_min_tokens.py:45,58,69`` and ``test_guided_json.py:65,74,100``.

Logprobs (top 20) against JAX in every step kind: prefill, decode,
burst, unified mixed and spec verify. The sampled logprob and the top
values agree to 1e-4 absolute; the top ids are equal except where the
values tie within that tolerance (``torch.topk`` does not promise the
tie order of ``lax.top_k``).

Step graphs: through the CPU stand-in graph of
``tests/test_torch_step_graphs.py``, one capture per (kind, shape,
mode, option set), tuple outputs that survive the next replay, and the
same streams as eager.
"""

import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from production_stack_tpu.engine import config as jax_config
from production_stack_tpu.engine.engine import LLMEngine as JaxEngine
from production_stack_tpu.engine.model_runner import (
    ModelRunner as JaxRunner,
)
from production_stack_tpu.engine.sequence import (
    SamplingParams as JaxSamplingParams,
    Sequence as JaxSequence,
)
from production_stack_tpu.models import llama as jax_llama
from production_stack_tpu.ops import sampling as jax_sampling
from production_stack_tpu_torch.engine import config
from production_stack_tpu_torch.engine.engine import LLMEngine
from production_stack_tpu_torch.engine.guided import build_json_fsm
from production_stack_tpu_torch.engine.model_runner import (
    STOP_SET_WIDTH,
    TOP_LOGPROBS_WIDTH,
    ModelRunner,
)
from production_stack_tpu_torch.engine.sequence import (
    SamplingParams,
    Sequence,
)
from production_stack_tpu_torch.engine.step_graphs import StepGraphs
from production_stack_tpu_torch.engine.tokenizer import ByteTokenizer
from production_stack_tpu_torch.models.convert import params_from_numpy
from production_stack_tpu_torch.ops import sampling
from tests.test_torch_step_graphs import RecordingGraph

torch.set_num_threads(2)

VOCAB = 512
EOS = 257
LP_TOL = 1e-4


def _logits(seed, b=6, scale=3.0):
    return (np.random.RandomState(seed).randn(b, VOCAB) * scale).astype(
        np.float32)


# ---- ops --------------------------------------------------------------------


def test_apply_penalties_equals_jax():
    rs = np.random.RandomState(0)
    logits = _logits(1)
    counts = rs.randint(0, 3, size=logits.shape).astype(np.int32)
    pmask = rs.rand(*logits.shape) < 0.2
    presence = rs.uniform(-2, 2, 6).astype(np.float32)
    frequency = rs.uniform(-2, 2, 6).astype(np.float32)
    repetition = rs.uniform(0.5, 2, 6).astype(np.float32)
    repetition[0], presence[1], frequency[1] = 1.0, 0.0, 0.0
    expected = np.asarray(jax_sampling.apply_penalties(*map(
        jnp.asarray, (logits, counts, pmask, presence, frequency,
                      repetition))))
    got = sampling.apply_penalties(*map(torch.from_numpy, (
        logits, counts, pmask, presence, frequency, repetition)))
    np.testing.assert_allclose(got.numpy(), expected, rtol=1e-6, atol=1e-6)


def test_apply_penalties_semantics():
    """The reference's worked example: repetition first on the raw
    logit, then presence and frequency."""
    out = sampling.apply_penalties(
        torch.tensor([[2.0, -1.0, 0.5, 3.0]]),
        torch.tensor([[2, 0, 1, 0]], dtype=torch.int32),
        torch.tensor([[False, True, False, False]]),
        torch.tensor([0.5]), torch.tensor([0.25]), torch.tensor([2.0]))[0]
    np.testing.assert_allclose(out.numpy(), [2.0 / 2.0 - 0.5 - 0.5,
                                             -2.0, 0.5 / 2.0 - 0.5 - 0.25,
                                             3.0])


def test_token_logprobs_equals_jax():
    logits = _logits(2)
    sampled = np.random.RandomState(3).randint(0, VOCAB, 6)
    e_slp, e_ids, e_top = (np.asarray(x) for x in jax_sampling.token_logprobs(
        jnp.asarray(logits), jnp.asarray(sampled, jnp.int32),
        TOP_LOGPROBS_WIDTH))
    slp, ids, top = (x.numpy() for x in sampling.token_logprobs(
        torch.from_numpy(logits), torch.from_numpy(sampled),
        TOP_LOGPROBS_WIDTH))
    np.testing.assert_allclose(slp, e_slp, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(top, e_top, rtol=1e-6, atol=1e-6)
    # Random normals: no ties, so the ids are equal.
    np.testing.assert_array_equal(ids, e_ids)


@pytest.mark.parametrize("emitted", [None, [0, 1, 2, 3, 0, 5]])
def test_suppression_equals_jax(emitted):
    logits = _logits(4)
    ids = np.full((6, STOP_SET_WIDTH), -1, np.int32)
    ids[:, 0] = EOS
    ids[1, 1:3] = [7, 7]  # a repeated id is suppressed twice, as in JAX
    ids[2, 1] = 0
    rem = np.asarray([0, 3, 1, 2, 4, 5], np.int32)
    em = None if emitted is None else np.asarray(emitted, np.int32)
    expected = np.asarray(JaxRunner._apply_suppression(
        jnp.asarray(logits), (jnp.asarray(ids), jnp.asarray(rem)),
        emitted=None if em is None else jnp.asarray(em)))
    got = sampling.apply_suppression(
        torch.from_numpy(logits), torch.from_numpy(ids),
        torch.from_numpy(rem), None if em is None else torch.from_numpy(em))
    np.testing.assert_allclose(got.numpy(), expected, rtol=1e-6, atol=1e-6)


def test_guided_mask_and_advance_equal_jax():
    fsm = build_json_fsm(ByteTokenizer())
    logits = _logits(5)
    state = np.asarray([-1, 0, 1, 5, 40, 0], np.int32)
    runner = types.SimpleNamespace(
        _guided_mask=jnp.asarray(fsm.mask),
        _guided_trans=jnp.asarray(fsm.transition))
    expected = np.asarray(JaxRunner._apply_guided_mask(
        runner, jnp.asarray(logits), jnp.asarray(state)))
    got = sampling.apply_guided_mask(torch.from_numpy(logits),
                                     torch.from_numpy(state),
                                     torch.from_numpy(fsm.mask))
    np.testing.assert_array_equal(got.numpy(), expected)
    sampled = torch.tensor([5, ord("{"), ord('"'), ord("a"), EOS, ord(" ")])
    active = torch.tensor([True, True, True, True, True, False])
    nxt = sampling.guided_advance(torch.from_numpy(state), sampled, active,
                                  torch.from_numpy(fsm.transition))
    host = [s if not a or s < 0 else fsm.advance(s, t) for s, t, a in zip(
        state.tolist(), sampled.tolist(), active.tolist())]
    assert nxt.tolist() == host


def _payload_rows(seq_cls, sp_cls):
    rows = [
        seq_cls(seq_id="a", prompt_token_ids=[3, 4, 4, 9], sampling=sp_cls(
            presence_penalty=0.5, repetition_penalty=1.2, min_tokens=5,
            stop_token_ids=[EOS, 11], logit_bias={5: 2.0, 600: 1.0})),
        None,
        seq_cls(seq_id="b", prompt_token_ids=[1, 2], sampling=sp_cls(
            frequency_penalty=0.25, guided="json", min_tokens=1,
            stop_token_ids=[EOS])),
        seq_cls(seq_id="c", prompt_token_ids=[6], sampling=sp_cls()),
    ]
    rows[0].output_token_ids = [4, 4, 8]
    rows[2].output_token_ids = [123]
    rows[2].fsm_state = 17
    return rows


def test_payload_functions_equal_jax():
    """The four option payloads, array for array, and {} for a batch
    that needs none."""
    model = types.SimpleNamespace(vocab_size=VOCAB)
    jax_runner = types.SimpleNamespace(
        config=types.SimpleNamespace(model=model))
    # They read only the config and the bias cache.
    runner = ModelRunner.__new__(ModelRunner)
    runner.config, runner._bias_cache = jax_runner.config, None
    jrows = _payload_rows(JaxSequence, JaxSamplingParams)
    prows = _payload_rows(Sequence, SamplingParams)
    for name in ("_penalty_payload", "_bias_payload", "_suppress_payload",
                 "_guided_payload"):
        expected = getattr(JaxRunner, name)(jax_runner, jrows, 6)
        got = getattr(runner, name)(prows, 6)
        assert expected.keys() == got.keys() and got, name
        for key in got:
            np.testing.assert_array_equal(got[key], expected[key])
        assert getattr(runner, name)([prows[3], None], 6) == {}
    _, options = runner._options_payload(prows, 6)
    assert options == ("penalties", "bias", "suppress", "guided")
    prows[3].sampling.logprobs = True
    _, options = runner._options_payload(prows, 6, row_inputs=False)
    assert options == ("logprobs",)


# ---- greedy streams against the JAX engine ----------------------------------


@pytest.fixture(scope="module")
def weights():
    cfg = jax_config.tiny_model_config("llama")
    return {k: np.asarray(v) for k, v in
            jax_llama.init_params(cfg, jax.random.PRNGKey(11)).items()}


def _config(cfg, decode_steps=1, async_on=False, unified=True, spec_k=0,
            rows=10):
    return cfg.EngineConfig(
        model=cfg.tiny_model_config("llama"),
        cache=cfg.CacheConfig(page_size=16, num_pages=256),
        scheduler=cfg.SchedulerConfig(
            max_num_seqs=rows, max_model_len=256, prefill_chunk_size=32,
            prefill_batch_size=rows, decode_steps=decode_steps,
            async_scheduling=async_on, unified_step=unified,
            speculative_k=spec_k))


def _port(weights, graphs=False, **kw):
    cfg = _config(config, **kw)
    engine = LLMEngine(cfg, params=params_from_numpy(weights, cfg.model,
                                                     "cpu"), device="cpu")
    if graphs:
        engine.runner.graphs = StepGraphs(
            torch.device("cpu"), generators=[engine.runner.generator],
            graph_factory=RecordingGraph)
    return engine


def _jax(weights, **kw):
    return JaxEngine(_config(jax_config, **kw),
                     params={k: jnp.asarray(v) for k, v in weights.items()})


# Guided rows whose structural bytes are biased so that greedy decoding
# writes {"":""} and stops.
CLOSING_BIAS = {ord("{"): 60.0, ord('"'): 100.0, ord(":"): 80.0,
                ord("}"): 50.0, EOS: 100.0}


def _prompts():
    rs = np.random.RandomState(5)
    return [[int(x) for x in rs.randint(1, 500, size=n)]
            for n in (12, 17, 20, 25, 29, 14, 22, 31, 19, 27)]


def _cases(stop_id):
    """(name, sampling kwargs) of the ten rows; every row greedy."""
    base = dict(temperature=0.0, max_tokens=12)
    return [
        ("free", dict(base, ignore_eos=True)),
        ("presence", dict(base, ignore_eos=True, presence_penalty=1.5)),
        ("frequency", dict(base, ignore_eos=True, frequency_penalty=1.0)),
        ("repetition", dict(base, ignore_eos=True, repetition_penalty=1.3)),
        ("bias", dict(base, ignore_eos=True,
                      logit_bias={77: 5.0, 300: -100.0, 12: 2.5})),
        ("forced", dict(base, ignore_eos=True, logit_bias={123: 100.0})),
        ("min_tokens_eos", dict(base, min_tokens=5,
                                logit_bias={EOS: 100.0})),
        ("min_tokens_stop", dict(base, min_tokens=4,
                                 stop_token_ids=[stop_id])),
        # A small push past the start state's whitespace; the rest is
        # the model's own choice among the admissible bytes.
        ("guided", dict(base, max_tokens=20, guided="json",
                        logit_bias={ord("{"): 8.0})),
        ("guided_closing", dict(base, max_tokens=30, guided="json",
                                logit_bias=CLOSING_BIAS)),
    ]


def _run(engine, sp_cls, cases, prompts):
    seqs = [engine.sequences[engine.add_request(p, sp_cls(**kw))]
            for p, (_, kw) in zip(prompts, cases)]
    for _ in range(400):
        if not engine.has_work():
            break
        engine.step()
    assert not engine.has_work()
    return [list(s.output_token_ids) for s in seqs]


@pytest.fixture(scope="module")
def stop_id(weights):
    """The greedy first token of the min_tokens_stop row's prompt: a
    stop that would fire at once without min_tokens."""
    engine = _port(weights)
    return engine.generate(_prompts()[7], SamplingParams(
        temperature=0.0, max_tokens=1, ignore_eos=True)).output_token_ids[0]


@pytest.fixture(scope="module")
def jax_streams(weights, stop_id):
    cases = _cases(stop_id)
    return {k: _run(_jax(weights, decode_steps=k), JaxSamplingParams,
                    cases, _prompts()) for k in (1, 4)}


MODES = [dict(decode_steps=k, async_on=a) for k in (1, 4)
         for a in (False, True)]


@pytest.mark.parametrize("mode", MODES, ids=lambda m: "K={decode_steps}-"
                         "async={async_on}".format(**m))
def test_option_streams_match_jax(weights, stop_id, jax_streams, mode):
    cases = _cases(stop_id)
    engine = _port(weights, **mode)
    got = _run(engine, SamplingParams, cases, _prompts())
    expected = jax_streams[mode["decode_steps"]]
    for (name, _), g, e in zip(cases, got, expected):
        assert g == e, name
    rows = dict(zip([name for name, _ in cases], got))
    # What each option did, in the port's stream.
    assert rows["forced"] == [123] * 12
    assert 300 not in rows["bias"]
    # EOS forced by its bias, held back for the first five tokens.
    assert len(rows["min_tokens_eos"]) == 6
    assert rows["min_tokens_eos"][-1] == EOS
    assert EOS not in rows["min_tokens_eos"][:5]
    assert stop_id not in rows["min_tokens_stop"][:4]
    assert len(rows["min_tokens_stop"]) >= 4
    fsm = engine.guided_fsm
    for name in ("guided", "guided_closing"):
        state = 0
        for t in rows[name]:
            state = fsm.advance(state, t)
            assert state >= 0, name
    for name, doc in (("guided", {}), ("guided_closing", {"": ""})):
        assert rows[name][-1] == EOS
        assert json.loads(bytes(t for t in rows[name] if t < 256)) == doc
    if mode["decode_steps"] > 1:
        assert engine.metrics.pipeline_steps_total < sum(map(len, got))


GROUPS = {"penalties": ("presence", "frequency", "repetition"),
          "logit_bias": ("bias", "forced"),
          "min_tokens": ("min_tokens_eos", "min_tokens_stop"),
          "guided": ("guided", "guided_closing")}


@pytest.mark.parametrize("mode", MODES, ids=lambda m: "K={decode_steps}-"
                         "async={async_on}".format(**m))
@pytest.mark.parametrize("group", sorted(GROUPS))
def test_each_option_alone_matches_jax(weights, stop_id, jax_streams, mode,
                                       group):
    """Each option's rows without the others: the async pipeline can
    then plan ahead of a row whose options end (``min_tokens`` reached,
    as the JAX plan-ahead's ``> num_generated + 1``). Greedy rows do
    not interact, so the JAX batch's streams are the reference."""
    names = [name for name, _ in _cases(stop_id)]
    rows = [names.index(name) for name in GROUPS[group]]
    cases = [_cases(stop_id)[i] for i in rows]
    prompts = [_prompts()[i] for i in rows]
    got = _run(_port(weights, **mode), SamplingParams, cases, prompts)
    assert got == [jax_streams[mode["decode_steps"]][i] for i in rows]


def test_a_late_option_row_is_prefilled_with_its_options(
        weights, stop_id, jax_streams):
    """A guided row that arrives while a plain row decodes, unified on:
    its first token comes from a prefill step, through the guided mask
    and its bias (the reference's mixed plan would sample it in a
    unified step without them), so its stream is the one it has alone."""
    engine = _port(weights, rows=4)
    plain = engine.sequences[engine.add_request(_prompts()[0], SamplingParams(
        temperature=0.0, max_tokens=20, ignore_eos=True))]
    while len(plain.output_token_ids) < 2:
        engine.step()
    names = [name for name, _ in _cases(stop_id)]
    i = names.index("guided_closing")
    late = engine.sequences[engine.add_request(
        _prompts()[i], SamplingParams(**_cases(stop_id)[i][1]))]
    while engine.has_work():
        engine.step()
    assert late.output_token_ids == jax_streams[1][i]
    assert engine.metrics.ragged_steps_total == 0


def test_jax_streams_agree_across_decode_steps(jax_streams):
    """The reference itself: its single steps and bursts agree."""
    assert jax_streams[1] == jax_streams[4]


# ---- logprobs in every step kind --------------------------------------------


def _record(engine, sp_cls, prompts, sampling, late=None):
    """Run ``prompts`` (and ``late`` once the first row finishes) and
    return each row's [(token, logprobs)]."""
    seqs, late_added = [], late is None
    for p in prompts:
        seqs.append(engine.sequences[engine.add_request(p, sp_cls(
            **sampling))])
    got = {s.seq_id: [] for s in seqs}
    for _ in range(400):
        if not engine.has_work():
            break
        for out in engine.step():
            if out.new_token is not None:
                got[out.seq_id].append((out.new_token, out.logprobs))
        if not late_added and seqs[0].output_token_ids and len(
                seqs[0].output_token_ids) >= sampling["max_tokens"] // 2:
            late_added = True
            seqs.append(engine.sequences[engine.add_request(
                late, sp_cls(**sampling))])
            got[seqs[-1].seq_id] = []
    assert not engine.has_work()
    return [got[s.seq_id] for s in seqs]


def _assert_logprobs_match(got, expected):
    assert [[t for t, _ in row] for row in got] == [
        [t for t, _ in row] for row in expected]
    for row_g, row_e in zip(got, expected):
        for (_, (slp, tops)), (_, (e_slp, e_tops)) in zip(row_g, row_e):
            assert abs(slp - e_slp) <= LP_TOL
            assert len(tops) == len(e_tops) == TOP_LOGPROBS_WIDTH
            e_vals = [v for _, v in e_tops]
            for j, ((tid, v), (e_tid, e_v)) in enumerate(zip(tops, e_tops)):
                assert abs(v - e_v) <= LP_TOL
                if tid != e_tid:
                    # Only a tie within the tolerance may reorder ids.
                    ties = [k for k, ev in enumerate(e_vals)
                            if k != j and abs(ev - e_v) <= LP_TOL]
                    assert ties or j == TOP_LOGPROBS_WIDTH - 1, (j, tops,
                                                                 e_tops)


LP_SAMPLING = dict(temperature=0.0, max_tokens=8, ignore_eos=True,
                   logprobs=True, top_logprobs=TOP_LOGPROBS_WIDTH)

KINDS = {
    # Prefill (first tokens) and single-step decode.
    "prefill_decode": dict(unified=False),
    # Bursts of 4.
    "burst": dict(unified=False, decode_steps=4),
    # A late prompt admitted into unified mixed steps.
    "unified": dict(unified=True),
    # Prompt-lookup drafts verified in spec steps.
    "spec_verify": dict(unified=False, spec_k=3),
}


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_logprobs_match_jax_in_every_step_kind(weights, kind):
    rs = np.random.RandomState(9)
    prompts = [[4, 5, 6] * 9, [8, 9] * 11,
               [int(x) for x in rs.randint(1, 500, size=23)]]
    late = [int(x) for x in rs.randint(1, 500, size=45)]
    kw = KINDS[kind]
    if kind != "unified":
        late = None
    expected = _record(_jax(weights, rows=4, **kw), JaxSamplingParams,
                       prompts, LP_SAMPLING, late)
    engine = _port(weights, rows=4, async_on=kind == "prefill_decode",
                   **kw)
    got = _record(engine, SamplingParams, prompts, LP_SAMPLING, late)
    _assert_logprobs_match(got, expected)
    m = engine.metrics
    if kind == "unified":
        assert m.ragged_steps_total > 0
    if kind == "spec_verify":
        assert m.spec_draft_tokens_total > 0
    if kind == "prefill_decode":
        assert m.pipeline_ahead_steps_total > 0


def test_logprobs_are_raw_under_the_options(weights):
    """A +100-forced token is sampled, but its logprob is the raw
    distribution's (the reference's ``test_logit_bias.py:83``)."""
    engine = _port(weights)
    outs = []
    sid = engine.add_request(_prompts()[0], SamplingParams(
        temperature=0.0, max_tokens=4, ignore_eos=True, logprobs=True,
        top_logprobs=3, logit_bias={123: 100.0}, presence_penalty=1.0))
    while engine.has_work():
        outs += [o for o in engine.step() if o.seq_id == sid]
    assert [o.new_token for o in outs] == [123] * 4
    assert all(o.logprobs[0] < -1.0 and len(o.logprobs[1]) == 3
               for o in outs)


# ---- step graphs ------------------------------------------------------------


@pytest.mark.parametrize("decode_steps", [1, 4])
def test_option_keys_are_captured_once_with_eager_streams(
        weights, stop_id, jax_streams, decode_steps):
    cases = _cases(stop_id)
    engine = _port(weights, graphs=True, decode_steps=decode_steps)
    got = _run(engine, SamplingParams, cases, _prompts())
    assert got == jax_streams[decode_steps]
    graphs = engine.runner.graphs
    keys = graphs.keys()
    assert sum(graphs.captures.values()) == len(keys) == len(set(keys))
    assert graphs.eager_steps == {"seeded": 0, "embed": 0}
    option_sets = {key[3] for key in keys}
    assert ("penalties", "bias", "suppress", "guided") in option_sets
    kind = "decode_burst" if decode_steps > 1 else "step"
    assert any(key[0] == kind and "penalties" in key[3] for key in keys)


def test_tuple_outputs_survive_the_next_replay(weights):
    """Two decode steps of one logprobs key: the first handle, read
    after the second replay, still holds its own tokens and logprobs,
    as eager."""
    results = {}
    for graphs in (False, True):
        engine = _port(weights, graphs=graphs, rows=4, unified=False)
        seqs = [engine.sequences[engine.add_request(p, SamplingParams(
            **LP_SAMPLING))] for p in _prompts()[:3]]
        while any(not s.output_token_ids for s in seqs):
            engine.step()
        runner = engine.runner
        first = runner.dispatch_decode(seqs)
        second = runner.dispatch_decode(seqs,
                                        token_source=first.token_source,
                                        ahead=True)
        assert isinstance(first.sampled, tuple) and len(first.sampled) == 4
        results[graphs] = (first.result(), second.result())
        if graphs:
            assert ("step", (4, 1), "greedy", ("logprobs",)) in (
                runner.graphs.keys())
    assert results[True] == results[False]
    (tok1, lp1), (tok2, lp2) = results[True]
    assert tok1 != tok2 and lp1 != lp2
