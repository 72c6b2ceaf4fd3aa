"""The slice's acceptance test: the port's engine against the JAX one.

Both engines serve the tiny f32 llama with the same weights (the JAX
``init_params`` dict, carried across with ``params_from_numpy``) over
the staggered mixed run of ``tests/test_unified_step.py``: chunked
prefills, a late request admitted mid-decode, rows finishing at
different steps. Greedy token streams must be byte-identical, with the
unified step on and off, and under the async pipeline. JAX attends
through its XLA reference on the CPU (page_size 16), the port through
its kernels' plain versions.
"""

import numpy as np
import pytest
import torch

import jax

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
from production_stack_tpu_torch.models.convert import params_from_numpy

torch.set_num_threads(2)

_MAX_TOKENS = [18, 9, 14, 25]


def _prompts():
    rs = np.random.RandomState(7)
    return [
        [4, 5, 6] * 13,
        [8] * 10,
        [21, 22, 23, 24] * 20,  # 80 tokens: 3 chunks of 32
        [int(x) for x in rs.randint(1, 500, size=41)],
    ]


def _config(cfg, unified, async_on):
    return cfg.EngineConfig(
        model=cfg.tiny_model_config("llama"),
        cache=cfg.CacheConfig(page_size=16, num_pages=128),
        scheduler=cfg.SchedulerConfig(
            max_num_seqs=4, max_model_len=256, prefill_chunk_size=32,
            unified_step=unified, async_scheduling=async_on),
    )


def _run_mixed(engine, sampling_cls, finished_state):
    """The fourth prompt arrives only after the second finishes, so its
    chunks are admitted INTO live decode steps when unified is on."""
    prompts = _prompts()
    seqs = []

    def add(i):
        sid = engine.add_request(prompts[i], sampling_cls(
            temperature=0.0, max_tokens=_MAX_TOKENS[i], ignore_eos=True))
        seqs.append(engine.sequences[sid])

    for i in range(3):
        add(i)
    late_added = False
    for _ in range(500):
        engine.step()
        if not late_added and seqs[1].state == finished_state:
            add(3)
            late_added = True
        if late_added and not engine.has_work():
            break
    assert late_added and not engine.has_work()
    return [list(s.output_token_ids) for s in seqs]


@pytest.fixture(scope="module")
def weights():
    cfg = jax_config.tiny_model_config("llama")
    return {k: np.asarray(v) for k, v in
            jax_llama.init_params(cfg, jax.random.PRNGKey(11)).items()}


@pytest.fixture(scope="module")
def jax_streams(weights):
    params = {k: jax.numpy.asarray(v) for k, v in weights.items()}
    streams = {}
    for unified in (False, True):
        engine = JaxEngine(_config(jax_config, unified, False),
                           params=params)
        streams[unified] = _run_mixed(engine, JaxSamplingParams,
                                      JaxSequenceState.FINISHED)
    return streams


@pytest.mark.parametrize("unified,async_on", [
    (False, False), (True, False), (False, True), (True, True)])
def test_greedy_streams_match_jax(weights, jax_streams, unified,
                                  async_on):
    cfg = _config(config, unified, async_on)
    engine = LLMEngine(cfg, params=params_from_numpy(weights, cfg.model,
                                                     "cpu"),
                       device="cpu")
    got = _run_mixed(engine, SamplingParams, SequenceState.FINISHED)
    assert got == jax_streams[unified]
    assert [len(t) for t in got] == _MAX_TOKENS
    if unified:
        assert engine.metrics.ragged_steps_total > 0
    else:
        assert engine.metrics.ragged_steps_total == 0
    if async_on and not unified:
        assert engine.metrics.pipeline_ahead_steps_total > 0


@pytest.mark.parametrize("unified", [False, True])
def test_page_pressure_matches_jax(weights, unified):
    """Ten pages (nine usable) for prompts needing twelve: preemption,
    recompute and a request that can never fit, in both engines."""
    jcfg = _config(jax_config, unified, False)
    pcfg = _config(config, unified, True)
    jcfg.cache.num_pages = pcfg.cache.num_pages = 10
    ref = JaxEngine(jcfg, params={k: jax.numpy.asarray(v)
                                  for k, v in weights.items()})
    expected = _run_mixed(ref, JaxSamplingParams,
                          JaxSequenceState.FINISHED)
    engine = LLMEngine(pcfg, params=params_from_numpy(weights, pcfg.model,
                                                      "cpu"),
                       device="cpu")
    got = _run_mixed(engine, SamplingParams, SequenceState.FINISHED)
    assert got == expected
    assert (engine.scheduler.num_preemptions
            == ref.scheduler.num_preemptions > 0)


def test_jax_modes_agree(jax_streams):
    """The reference itself: bimodal and unified JAX streams agree, so
    every port mode is held to one stream."""
    assert jax_streams[False] == jax_streams[True]


def test_entry_points_need_a_card_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LLMEngine(_config(config, False, False))


@pytest.mark.parametrize("option", [
    dict(presence_penalty=0.5),
    dict(repetition_penalty=1.2),
    dict(logprobs=True, top_logprobs=2),
    dict(logit_bias={5: 3.0}),
    dict(min_tokens=4),
    dict(guided="json")],
    ids=["presence", "repetition", "logprobs", "logit_bias", "min_tokens",
         "guided"])
def test_sampling_options_are_served(weights, option):
    """The options the engine refused before it served them run to the
    end of a request (their parity with the JAX engine:
    tests/test_torch_sampling_options.py)."""
    cfg = _config(config, True, True)
    engine = LLMEngine(cfg, params=params_from_numpy(weights, cfg.model,
                                                     "cpu"), device="cpu")
    outputs = []
    sid = engine.add_request([4, 5, 6] * 5, SamplingParams(
        temperature=0.0, max_tokens=4, **option))
    seq = engine.sequences[sid]
    while engine.has_work():
        outputs += [o for o in engine.step() if o.seq_id == sid]
    assert seq.state == SequenceState.FINISHED
    assert 1 <= len(seq.output_token_ids) <= 4
    lps = [o.logprobs for o in outputs if o.new_token is not None]
    if option.get("logprobs"):
        assert [len(tops) for _, tops in lps] == [2] * len(lps)
    else:
        assert lps == [None] * len(seq.output_token_ids)
    if "min_tokens" in option:
        assert len(seq.output_token_ids) == 4
    if "guided" in option:
        state = 0
        for t in seq.output_token_ids:
            state = engine.guided_fsm.advance(state, t)
            assert state >= 0
        assert seq.fsm_state == state


def test_lora_adapters_raise():
    engine = LLMEngine(_config(config, True, True), device="cpu")
    with pytest.raises(NotImplementedError, match="LoRA"):
        engine.add_request([4, 5, 6], SamplingParams(max_tokens=4),
                           lora_name="my-adapter")
    assert not engine.sequences and not engine.has_work()


def test_seeded_requests_reproduce(weights):
    cfg = _config(config, True, True)
    engine = LLMEngine(cfg, params=params_from_numpy(weights, cfg.model,
                                                     "cpu"),
                       device="cpu")
    sp = dict(temperature=0.8, top_p=0.95, max_tokens=12, seed=5,
              ignore_eos=True)
    a, b = engine.generate_batch([_prompts()[0]] * 2,
                                 SamplingParams(**sp))
    c = engine.generate([4, 5, 6] * 13, SamplingParams(**sp))
    assert a.output_token_ids == b.output_token_ids == c.output_token_ids
    assert len(a.output_token_ids) == 12
