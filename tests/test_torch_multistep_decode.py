"""Decode bursts (``decode_steps`` K > 1) in the port, against the
port's single-step decoding and the JAX engine's bursts.

The cases of the JAX package's ``tests/test_multistep_decode.py``: a
K = 4 burst generates exactly what single-step greedy decoding
generates, stops mid-window at a stop token and at ``max_tokens``,
keeps greedy rows deterministic beside a stochastic row, penalizes
with the counts it keeps on the device exactly as single steps do
with the counts rebuilt on the host (against the JAX engine too), and
reproduces seeded requests at K = 1 and K = 4. Then the
greedy streams against the JAX engine at K = 4, per_layer and stacked,
unified off and on, async on, int8 KV and speculative_k 3 (the
spec/burst hybrid); the hybrid gate's plan decisions against the JAX
scheduler's on the same drafts; and the server's ``--decode-steps``
with ``--async-scheduling auto``.

Both engines serve the tiny f32 llama with the same weights (the JAX
``init_params`` dict, carried across with ``params_from_numpy``); JAX
attends through its XLA reference on the CPU, the port through its
kernels' plain versions. Greedy streams: exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from production_stack_tpu.engine import config as jax_config
from production_stack_tpu.engine.engine import LLMEngine as JaxEngine
from production_stack_tpu.engine.kv_cache import (
    PagedCacheManager as JaxCacheManager,
)
from production_stack_tpu.engine.scheduler import Scheduler as JaxScheduler
from production_stack_tpu.engine.sequence import (
    SamplingParams as JaxSamplingParams,
    Sequence as JaxSequence,
    SequenceState as JaxSequenceState,
)
from production_stack_tpu.models import llama as jax_llama
from production_stack_tpu_torch.engine import config
from production_stack_tpu_torch.engine.engine import LLMEngine
from production_stack_tpu_torch.engine.kv_cache import PagedCacheManager
from production_stack_tpu_torch.engine.scheduler import Scheduler
from production_stack_tpu_torch.engine.sequence import (
    SamplingParams,
    Sequence,
    SequenceState,
)
from production_stack_tpu_torch.engine.server import (
    build_engine_from_args,
    parse_args,
)
from production_stack_tpu_torch.models.convert import params_from_numpy
from tests.test_torch_engine import _MAX_TOKENS, _run_mixed

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def weights():
    cfg = jax_config.tiny_model_config("llama")
    return {k: np.asarray(v) for k, v in
            jax_llama.init_params(cfg, jax.random.PRNGKey(31)).items()}


def _config(cfg, decode_steps, layout="auto", unified=False,
            async_on=False, spec_k=0, kv_dtype="auto", max_num_seqs=4):
    """The JAX multistep tests' engine (tests/test_multistep_decode.py)."""
    return cfg.EngineConfig(
        model=cfg.tiny_model_config("llama"),
        cache=cfg.CacheConfig(page_size=16, num_pages=128,
                              cache_layout=layout, kv_cache_dtype=kv_dtype),
        scheduler=cfg.SchedulerConfig(
            max_num_seqs=max_num_seqs, max_model_len=256,
            prefill_chunk_size=32, decode_steps=decode_steps,
            unified_step=unified, async_scheduling=async_on,
            speculative_k=spec_k))


def _engine(weights, decode_steps, **kw):
    cfg = _config(config, decode_steps, **kw)
    return LLMEngine(cfg, params=params_from_numpy(weights, cfg.model,
                                                   "cpu"), device="cpu")


def _jax_engine(weights, decode_steps, **kw):
    return JaxEngine(_config(jax_config, decode_steps, **kw),
                     params={k: jnp.asarray(v) for k, v in weights.items()})


def _gen(engine, prompts, sampling_cls=SamplingParams, **kw):
    sampling = dict(max_tokens=12, temperature=0.0, ignore_eos=True)
    sampling.update(kw)
    seqs = []
    for p in prompts:
        sid = engine.add_request(p, sampling_cls(**sampling))
        seqs.append(engine.sequences[sid])
    while engine.has_work():
        engine.step()
    return [list(s.output_token_ids) for s in seqs]


def _prompts():
    rs = np.random.RandomState(1)
    return [[int(x) for x in rs.randint(1, 500, size=n)]
            for n in (7, 20, 41)]


# ---- the burst against single steps -----------------------------------------


def test_multistep_matches_single_step_greedy(weights):
    expected = _gen(_engine(weights, 1), _prompts())
    engine = _engine(weights, 4)
    got = _gen(engine, _prompts())
    assert got == expected
    assert all(len(t) == 12 for t in got)
    # Every page came back: no burst wrote past its reservation.
    assert engine.cache_manager.num_used_pages == 0


def test_window_respects_max_tokens(weights):
    """max_tokens not divisible by K: the last burst stops each row at
    its budget on the device, and the budget is met exactly."""
    prompts = [[5, 6, 7, 8], [9] * 30]
    for max_tokens in (10, 3, 1):
        engine = _engine(weights, 4)
        got = _gen(engine, prompts, max_tokens=max_tokens)
        assert [len(t) for t in got] == [max_tokens] * 2
        assert got == _gen(_engine(weights, 1), prompts,
                           max_tokens=max_tokens)
        assert engine.cache_manager.num_used_pages == 0


def test_stop_token_mid_window_discards_tail(weights):
    """The greedy continuation's second token as a stop token fires
    mid-window at K = 4: the device freezes the row and the tail is
    dropped."""
    prompts = [[9, 10, 11, 12, 13]]
    ref = _gen(_engine(weights, 1), prompts, max_tokens=8)[0]
    stop = ref[1]
    kw = dict(max_tokens=8, ignore_eos=False, stop_token_ids=[stop])
    got1 = _gen(_engine(weights, 1), prompts, **kw)[0]
    got4 = _gen(_engine(weights, 4), prompts, **kw)[0]
    assert got1 == got4
    assert got4[-1] == stop
    assert len(got4) == ref.index(stop) + 1


def test_mixed_sampling_batch_keeps_greedy_rows_deterministic(weights):
    rs = np.random.RandomState(3)
    greedy_prompt = [int(x) for x in rs.randint(1, 500, size=23)]
    stoch_prompt = [int(x) for x in rs.randint(1, 500, size=17)]
    solo = _gen(_engine(weights, 4), [greedy_prompt])[0]
    engine = _engine(weights, 4)
    sids = [
        engine.add_request(greedy_prompt, SamplingParams(
            max_tokens=12, temperature=0.0, ignore_eos=True)),
        engine.add_request(stoch_prompt, SamplingParams(
            max_tokens=12, temperature=0.9, top_p=0.9, ignore_eos=True)),
    ]
    seqs = [engine.sequences[s] for s in sids]
    while engine.has_work():
        engine.step()
    assert seqs[0].output_token_ids == solo
    assert len(seqs[1].output_token_ids) == 12


def test_penalized_burst_matches_single_step(weights):
    """Greedy with all three penalties: bursts (counts carried on the
    device) against single steps (counts rebuilt on the host each
    dispatch), and both against the JAX engine's bursts."""
    prompt = [list(range(1, 30))]
    sp = dict(max_tokens=12, presence_penalty=1.5, frequency_penalty=0.5,
              repetition_penalty=1.3)
    burst = _gen(_engine(weights, 6), prompt, **sp)
    assert burst == _gen(_engine(weights, 1), prompt, **sp)
    assert burst == _gen(_jax_engine(weights, 6), prompt,
                         JaxSamplingParams, **sp)
    assert burst != _gen(_engine(weights, 6), prompt)


def test_seeded_requests_reproduce(weights):
    """A seeded row draws from (seed, emitted index) alone, with the
    index known on the host at every iteration of a burst: the same
    tokens across engines and burst widths; another seed diverges."""
    prompt = list(range(1, 30))

    def gen(steps, seed):
        # A high temperature: the tiny model's distributions are
        # peaked, and two seeds must have room to diverge.
        return _gen(_engine(weights, steps), [prompt], max_tokens=10,
                    temperature=4.0, seed=seed)[0]

    a, b, c, d = gen(4, 1234), gen(4, 1234), gen(1, 1234), gen(4, 999)
    assert a == b == c
    assert d != a
    assert len(a) == 10


# ---- against the JAX engine -------------------------------------------------


# mode -> (layout, unified, async, speculative_k, kv dtype), each at
# decode_steps 4 over the staggered mixed run of
# tests/test_torch_engine.py (chunked prefills, a late request). JAX
# runs each synchronously: its async pipeline is byte-identical to its
# sync loop.
MODES = {
    "per_layer": ("per_layer", False, False, 0, "auto"),
    "stacked": ("stacked", False, False, 0, "auto"),
    "per_layer_unified": ("per_layer", True, False, 0, "auto"),
    "stacked_unified_async": ("stacked", True, True, 0, "auto"),
    "stacked_int8": ("stacked", False, False, 0, "int8"),
    "stacked_spec3": ("stacked", False, False, 3, "auto"),
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_burst_greedy_streams_match_jax(weights, mode):
    layout, unified, async_on, spec_k, kv_dtype = MODES[mode]
    ref = _jax_engine(weights, 4, layout=layout, unified=unified,
                      spec_k=spec_k, kv_dtype=kv_dtype)
    expected = _run_mixed(ref, JaxSamplingParams, JaxSequenceState.FINISHED)
    engine = _engine(weights, 4, layout=layout, unified=unified,
                     async_on=async_on, spec_k=spec_k, kv_dtype=kv_dtype)
    got = _run_mixed(engine, SamplingParams, SequenceState.FINISHED)
    assert got == expected
    assert [len(t) for t in got] == _MAX_TOKENS
    assert engine.runner.cache_layout == layout
    if spec_k:
        assert (engine.metrics.spec_draft_tokens_total
                == ref.stats()["spec_decode_num_draft_tokens_total"])
    assert engine.cache_manager.num_used_pages == 0


# ---- the spec/burst hybrid gate ---------------------------------------------


def _gate_plans(pkg, histories):
    """The plan ``plan_step`` makes over running rows with the given
    (prompt, output) histories at speculative_k 3 and a window of 4:
    (drafts, window)."""
    (cfg, manager_cls, scheduler_cls, seq_cls, sampling_cls,
     state) = pkg
    cache_cfg = cfg.CacheConfig(page_size=16, num_pages=64)
    sched_cfg = cfg.SchedulerConfig(max_num_seqs=4, max_model_len=256,
                                    speculative_k=3, decode_steps=4)
    manager = manager_cls(cache_cfg)
    sched = scheduler_cls(sched_cfg, cache_cfg, manager)
    for i, (prompt, output) in enumerate(histories):
        seq = seq_cls(seq_id=f"s{i}", prompt_token_ids=list(prompt),
                      sampling=sampling_cls(max_tokens=64,
                                            temperature=0.0,
                                            ignore_eos=True))
        seq.transition(state.RUNNING)
        seq.output_token_ids = list(output)
        seq.num_computed_tokens = seq.total_len
        seq.pages = manager.allocate_pages(-(-seq.total_len // 16))
        sched.running.append(seq)
    plan = sched.plan_step().decode
    return plan.drafts, plan.window


@pytest.mark.parametrize("drafting", [0, 1, 2, 3, 4])
def test_spec_hybrid_gate_matches_jax(drafting):
    """A verify step displaces a K-token burst: it runs only when, at
    full acceptance, the drafts (plus one token a row) emit at least K
    tokens a row. With ``drafting`` of 4 rows drafting 3 tokens each,
    that is 3 * drafting + 4 >= 16, so only drafting = 4 verifies."""
    rs = np.random.RandomState(drafting)
    histories = []
    for i in range(4):
        if i < drafting:
            histories.append(([5 + i, 6, 7, 8] * 5, [5 + i, 6, 7]))
        else:
            histories.append(([int(x) for x in rs.randint(100, 500,
                                                          size=20)], [3]))
    port = _gate_plans((config, PagedCacheManager, Scheduler, Sequence,
                        SamplingParams, SequenceState), histories)
    ref = _gate_plans((jax_config, JaxCacheManager, JaxScheduler,
                       JaxSequence, JaxSamplingParams, JaxSequenceState),
                      histories)
    assert port == ref
    assert (port[0] is not None) == (drafting == 4)
    assert port[1] == (1 if drafting == 4 else 4)


# ---- server -----------------------------------------------------------------


def test_server_decode_steps_resolves_async_off():
    base = ["--model", "tiny-llama", "--device", "cpu"]
    assert parse_args(base).decode_steps == 1
    cases = [([], True, 1), (["--decode-steps", "4"], False, 4),
             (["--decode-steps", "4", "--async-scheduling", "on"], True, 4)]
    for extra, async_on, k in cases:
        engine, _ = build_engine_from_args(parse_args(base + extra))
        sched = engine.config.scheduler
        assert sched.decode_steps == k
        assert sched.async_scheduling == async_on
