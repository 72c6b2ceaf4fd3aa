"""Prompt-lookup speculative decoding in the port against the JAX
package's.

- The port's ``NgramProposer`` drafts what the JAX one drafts on the
  same histories (the cases of ``tests/test_spec_components.py``,
  random and periodic histories, several k and min_match).
- Greedy token streams of the port's engine with ``speculative_k`` > 0
  are byte-identical to the JAX engine's with the same config, and to
  the port's own with speculation off: sync with the unified step off,
  sync with it on, and async with it on and a late-admitted request
  (``tests/test_unified_step.py``'s spec-under-async run). Both serve
  the tiny f32 llama with the same weights (the JAX ``init_params``
  dict, carried across with ``params_from_numpy``); JAX attends
  through its XLA reference on the CPU, the port through its kernels'
  plain versions (verify rows through the ragged kernel's).
- Drafts were proposed, and a row that finishes inside a verify step
  releases its pages.
"""

from types import SimpleNamespace

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
from production_stack_tpu.engine.spec import NgramProposer as JaxProposer
from production_stack_tpu.models import llama as jax_llama
from production_stack_tpu_torch.engine import config
from production_stack_tpu_torch.engine.engine import LLMEngine
from production_stack_tpu_torch.engine.sequence import (
    SamplingParams,
    SequenceState,
)
from production_stack_tpu_torch.engine.server import (
    build_engine_from_args,
    parse_args,
)
from production_stack_tpu_torch.engine.spec import NgramProposer
from production_stack_tpu_torch.models.convert import params_from_numpy

torch.set_num_threads(2)


# ---- the proposer -----------------------------------------------------------


def _seq(tokens, seq_id="s0"):
    return SimpleNamespace(seq_id=seq_id, all_token_ids=list(tokens))


def _histories():
    rs = np.random.RandomState(3)
    loop = [11, 12, 13]
    return {
        "basic_lookup": [1, 7, 8, 9, 10, 2, 3, 7, 8],
        "no_match": [1, 2, 3, 4, 5, 6],
        "short": [1, 2],
        "periodic": loop * 6,
        "period_one": [3, 9, 9, 9, 9, 9],
        "longer_backward_match": [40, 41, 1, 2, 77, 77, 50, 1, 2, 88, 88,
                                  40, 41, 1, 2],
        "constant": [7] * 5000,
        "random_small_vocab": [int(x) for x in rs.randint(0, 6, size=300)],
        "random_wide_vocab": [int(x) for x in rs.randint(0, 500, size=300)],
        "repeated_block": [int(x) for x in rs.randint(0, 500, size=37)] * 4,
    }


@pytest.mark.parametrize("name", sorted(_histories()))
def test_proposer_matches_jax(name):
    hist = _histories()[name]
    for k in (1, 3, 4, 8):
        for min_match in (1, 2, 3):
            port = NgramProposer(k, min_match)
            ref = JaxProposer(k, min_match)
            for max_len in (0, 1, 2, k, 10):
                # Growing histories: the index extends incrementally.
                for end in (len(hist) // 2, len(hist)):
                    seq = _seq(hist[:end])
                    assert (port.propose(seq, max_len)
                            == ref.propose(seq, max_len)), (
                        k, min_match, max_len, end)


def test_proposer_drafts_full_loops_and_drops_index():
    p = NgramProposer(k=8, min_match=2)
    assert p.propose(_seq([11, 12, 13] * 6, "a"), 8) == (
        [11, 12, 13] * 3)[:8]
    assert "a" in p._index
    p.drop("a")
    assert "a" not in p._index
    p.drop("never-indexed")  # idempotent


def test_proposer_and_config_validate_args():
    with pytest.raises(ValueError):
        NgramProposer(k=0)
    with pytest.raises(ValueError):
        NgramProposer(k=2, min_match=0)
    for cfg in (config, jax_config):
        with pytest.raises(ValueError):
            cfg.EngineConfig(scheduler=cfg.SchedulerConfig(
                speculative_k=2, speculative_min_match=0))
        # min_match is not read while speculation is off.
        cfg.EngineConfig(scheduler=cfg.SchedulerConfig(
            speculative_k=0, speculative_min_match=0))
    with pytest.raises(ValueError):
        config.SchedulerConfig(speculative_k=-1)


def test_server_flags_and_async_auto():
    """--speculative-k reaches the scheduler, and --async-scheduling
    auto resolves off with it (an explicit 'on' stays on)."""
    base = ["--model", "tiny-llama", "--device", "cpu"]
    cases = [([], False, 0), (["--speculative-k", "3"], False, 3),
             (["--speculative-k", "3", "--async-scheduling", "on"], True,
              3)]
    for extra, async_on, k in cases:
        engine, _ = build_engine_from_args(parse_args(base + extra))
        sched = engine.config.scheduler
        assert sched.async_scheduling == (async_on or k == 0)
        assert sched.speculative_k == k
        assert sched.unified_step
        assert (engine.scheduler.proposer is not None) == (k > 0)


# ---- the engine -------------------------------------------------------------


def _prompt_mix():
    """Repetitive histories (the drafting case, one longer than the
    prefill chunk) and a random prompt (rarely drafts)."""
    rs = np.random.RandomState(7)
    return [
        [5, 6, 7] * 12,
        [9, 9, 9, 9, 9, 9, 9, 9],
        [11, 12, 13, 14] * 20,  # 80 tokens > chunk 32
        [int(x) for x in rs.randint(1, 500, size=23)],
    ]


def _config(cfg, unified, async_on, spec_k):
    return cfg.EngineConfig(
        model=cfg.tiny_model_config("llama"),
        cache=cfg.CacheConfig(page_size=16, num_pages=128),
        scheduler=cfg.SchedulerConfig(
            max_num_seqs=4, max_model_len=256, prefill_chunk_size=32,
            unified_step=unified, async_scheduling=async_on,
            speculative_k=spec_k),
    )


def _run_batch(engine, sampling_cls, finished_state):
    seqs = []
    for p in _prompt_mix():
        sid = engine.add_request(p, sampling_cls(
            temperature=0.0, max_tokens=16, ignore_eos=True))
        seqs.append(engine.sequences[sid])
    while engine.has_work():
        engine.step()
    assert all(s.state == finished_state for s in seqs)
    return [list(s.output_token_ids) for s in seqs]


def _run_late(engine, sampling_cls, finished_state):
    """A late request arrives when the first finishes: its prefill is a
    pipeline break, and the re-plan after it consults the proposer."""
    base = [3, 9, 27, 9] * 14
    prompts = [base, base[:24] * 2, list(reversed(base))]
    seqs = []
    for p, m in zip(prompts, [14, 26, 20]):
        sid = engine.add_request(p, sampling_cls(
            temperature=0.0, max_tokens=m, ignore_eos=True))
        seqs.append(engine.sequences[sid])
    late_added = False
    for _ in range(500):
        engine.step()
        if not late_added and seqs[0].state == finished_state:
            sid = engine.add_request(base[:20] * 2, sampling_cls(
                temperature=0.0, max_tokens=10, ignore_eos=True))
            seqs.append(engine.sequences[sid])
            late_added = True
        if late_added and not engine.has_work():
            break
    assert late_added and not engine.has_work()
    return [list(s.output_token_ids) for s in seqs]


# mode -> (unified, async, speculative_k, run)
MODES = {
    "sync": (False, False, 4, _run_batch),
    "sync_unified": (True, False, 4, _run_batch),
    "async_unified_late": (True, True, 3, _run_late),
}


@pytest.fixture(scope="module")
def weights():
    cfg = jax_config.tiny_model_config("llama")
    return {k: np.asarray(v) for k, v in
            jax_llama.init_params(cfg, jax.random.PRNGKey(11)).items()}


def _port_engine(weights, unified, async_on, spec_k):
    cfg = _config(config, unified, async_on, spec_k)
    return LLMEngine(cfg, params=params_from_numpy(weights, cfg.model,
                                                   "cpu"),
                     device="cpu")


@pytest.mark.parametrize("mode", sorted(MODES))
def test_spec_greedy_streams_match_jax_and_spec_off(weights, mode):
    unified, async_on, spec_k, run = MODES[mode]
    ref = JaxEngine(_config(jax_config, unified, async_on, spec_k),
                    params={k: jax.numpy.asarray(v)
                            for k, v in weights.items()})
    expected = run(ref, JaxSamplingParams, JaxSequenceState.FINISHED)
    assert ref.stats()["spec_decode_num_draft_tokens_total"] > 0

    engine = _port_engine(weights, unified, async_on, spec_k)
    got = run(engine, SamplingParams, SequenceState.FINISHED)
    assert got == expected
    off = run(_port_engine(weights, unified, async_on, 0), SamplingParams,
              SequenceState.FINISHED)
    assert got == off
    stats = engine.stats()
    assert stats["spec_decode_num_draft_tokens_total"] > 0
    assert 0 < stats["spec_decode_num_accepted_tokens_total"] <= (
        stats["spec_decode_num_draft_tokens_total"])
    if unified:
        assert engine.metrics.ragged_steps_total > 0
    if async_on:
        # The pipeline engaged around the verify steps.
        assert engine.metrics.pipeline_ahead_steps_total > 0
    assert engine._in_flight is None
    assert engine.cache_manager.num_used_pages == 0


def test_pages_released_after_finish_mid_speculation(weights):
    """A row ending inside a verify step (max_tokens hit on an accepted
    draft) releases every page, and its hashed prompt pages stay
    reusable: the same prompt again prefix-hits and reproduces the
    output."""
    engine = _port_engine(weights, False, False, 4)
    cm = engine.cache_manager
    prompt = [5, 6, 7] * 12
    sp = dict(temperature=0.0, max_tokens=13, ignore_eos=True)
    first = engine.generate(prompt, SamplingParams(**sp))
    assert engine.metrics.spec_draft_tokens_total > 0
    assert cm.num_used_pages == 0, "pages leaked by a mid-spec finish"
    hits = cm.prefix_hit_tokens
    second = engine.generate(prompt, SamplingParams(**sp))
    assert second.output_token_ids == first.output_token_ids
    assert len(first.output_token_ids) == 13
    assert cm.prefix_hit_tokens > hits
    assert cm.num_used_pages == 0
