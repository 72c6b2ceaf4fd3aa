"""The port's sampling against the JAX package's.

Greedy paths must agree exactly (an argmax of the same f32 logits);
the top-k/top-p mask must keep the same set of logits. Random draws
differ by construction (``torch.Generator`` against ``jax.random``
keys), so stochastic rows are checked for determinism under a seed,
not for equal bits.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from production_stack_tpu.ops import sampling as jax_sampling
from production_stack_tpu_torch.ops import sampling

torch.set_num_threads(2)

VOCAB = 97


def _logits(seed, *shape, scale=3.0):
    return np.random.RandomState(seed).randn(*shape, VOCAB).astype(
        np.float32) * scale


def _knobs(b, temperature=0.0, top_p=1.0, top_k=0):
    return (np.full((b,), temperature, np.float32),
            np.full((b,), top_p, np.float32),
            np.full((b,), top_k, np.int32))


def test_greedy_sample_tokens_equals_jax():
    logits = _logits(0, 16)
    temperature, top_p, top_k = _knobs(16, top_p=0.5, top_k=3)
    expected = np.asarray(jax_sampling.sample_tokens(
        jnp.asarray(logits), jnp.asarray(temperature), jnp.asarray(top_p),
        jnp.asarray(top_k), jax.random.PRNGKey(0)))
    got = sampling.sample_tokens(
        torch.from_numpy(logits), torch.from_numpy(temperature),
        torch.from_numpy(top_p), torch.from_numpy(top_k),
        generator=torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(got.numpy(), expected)


def test_greedy_rows_stay_argmax_in_a_mixed_batch():
    logits = _logits(1, 8)
    temperature, top_p, top_k = _knobs(8, top_p=0.9)
    temperature[::2] = 0.7
    got = sampling.sample_tokens(
        torch.from_numpy(logits), torch.from_numpy(temperature),
        torch.from_numpy(top_p), torch.from_numpy(top_k),
        generator=torch.Generator().manual_seed(3)).numpy()
    np.testing.assert_array_equal(got[1::2], logits[1::2].argmax(-1))
    assert ((got >= 0) & (got < VOCAB)).all()


@pytest.mark.parametrize("top_p,top_k", [(1.0, 5), (0.8, 0), (0.6, 12)])
def test_top_k_top_p_mask_equals_jax(top_p, top_k):
    # Unit-scale logits keep every top-p boundary far from float
    # rounding: with a very peaked row, the exclusive cumulative
    # probability of the last tokens rounds to 1.0 in one framework and
    # not the other, and top_p = 1.0 then masks a different tail.
    logits = _logits(2, 6, scale=1.0)
    _, p, k = _knobs(6, top_p=top_p, top_k=top_k)
    p[0], k[0] = 1.0, 0  # one row with both disabled
    expected = np.asarray(jax_sampling._mask_top_k_top_p(
        jnp.asarray(logits), jnp.asarray(p), jnp.asarray(k)))
    got = sampling._mask_top_k_top_p(
        torch.from_numpy(logits), torch.from_numpy(p),
        torch.from_numpy(k)).numpy()
    np.testing.assert_array_equal(got <= sampling.NEG_INF,
                                  expected <= jax_sampling.NEG_INF)
    kept = expected > jax_sampling.NEG_INF
    np.testing.assert_array_equal(got[kept], expected[kept])


def test_greedy_spec_verify_equals_jax():
    b, s = 6, 4
    logits = _logits(4, b, s)
    argmax = logits.argmax(-1)
    drafts = np.full((b, s - 1), -1, np.int32)
    draft_lens = np.array([0, 1, 3, 3, 2, 3], np.int32)
    for i, n in enumerate(draft_lens):
        drafts[i, :n] = argmax[i, :n]
    drafts[3, 1] = (argmax[3, 1] + 1) % VOCAB  # rejected mid-span
    drafts[5, 0] = (argmax[5, 0] + 1) % VOCAB  # rejected at once
    temperature, top_p, top_k = _knobs(b)
    expected = np.asarray(jax_sampling.spec_verify(
        jnp.asarray(logits), jnp.asarray(drafts), jnp.asarray(draft_lens),
        jnp.asarray(temperature), jnp.asarray(top_p), jnp.asarray(top_k),
        jax.random.PRNGKey(0)))
    got = sampling.spec_verify(
        torch.from_numpy(logits), torch.from_numpy(drafts),
        torch.from_numpy(draft_lens), torch.from_numpy(temperature),
        torch.from_numpy(top_p), torch.from_numpy(top_k),
        generator=torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(got.numpy(), expected)


def test_draft_free_spec_verify_is_the_argmax():
    """How the unified step samples: span width 1, no drafts."""
    logits = _logits(5, 8, 1)
    temperature, top_p, top_k = _knobs(8)
    got = sampling.spec_verify(
        torch.from_numpy(logits), torch.zeros((8, 0), dtype=torch.int32),
        torch.zeros((8,), dtype=torch.int32),
        torch.from_numpy(temperature), torch.from_numpy(top_p),
        torch.from_numpy(top_k))
    np.testing.assert_array_equal(got.numpy()[:, 0],
                                  logits[:, 0].argmax(-1))


def test_seeded_rows_are_deterministic_across_batches():
    logits = torch.from_numpy(_logits(6, 4))
    logits[1] = logits[0]
    temperature, top_p, top_k = (torch.from_numpy(x)
                                 for x in _knobs(4, 1.0, 0.95))
    seeds = torch.tensor([11, 11, 12, 0])
    emitted = torch.tensor([3, 3, 3, 0])
    mask = torch.tensor([True, True, True, False])

    def draw(stream_seed, order):
        out = sampling.sample_tokens(
            logits[order], temperature, top_p, top_k,
            generator=torch.Generator().manual_seed(stream_seed),
            seeds=seeds[order], emitted=emitted[order],
            seed_mask=mask[order])
        return dict(zip(order.tolist(), out.tolist()))

    first = draw(0, torch.arange(4))
    second = draw(99, torch.tensor([2, 1, 0, 3]))
    # Rows 0 and 1 share seed, emitted index and logits.
    assert first[0] == first[1]
    # A seeded row's draw ignores the engine stream and its batch slot.
    for i in (0, 1, 2):
        assert first[i] == second[i]
    with pytest.raises(ValueError):
        sampling.sample_tokens(logits, temperature, top_p, top_k,
                               seeds=seeds)


def test_seeded_draws_follow_the_request_seed():
    """Two seeds at the same emitted index draw from different streams
    on the CPU too (whose generator keeps only 32 bits of its seed), and
    one seed at two indices as well."""
    logits = torch.zeros((8, VOCAB))  # uniform: the draw is the noise
    temperature, top_p, top_k = (torch.from_numpy(x)
                                 for x in _knobs(8, 1.0, 1.0))
    mask = torch.ones((8,), dtype=torch.bool)

    def draw(seed, emitted):
        return sampling.sample_tokens(
            logits, temperature, top_p, top_k,
            seeds=torch.full((8,), seed), emitted=torch.full((8,), emitted),
            seed_mask=mask)

    assert torch.equal(draw(1234, 0), draw(1234, 0))
    assert not torch.equal(draw(1234, 0), draw(999, 0))
    assert not torch.equal(draw(1234, 0), draw(1234, 1))


def test_stochastic_draws_follow_the_generator():
    logits = torch.from_numpy(_logits(7, 32))
    temperature, top_p, top_k = (torch.from_numpy(x)
                                 for x in _knobs(32, 1.0, 1.0, 8))

    def draw(seed):
        return sampling.sample_tokens(
            logits, temperature, top_p, top_k,
            generator=torch.Generator().manual_seed(seed))

    assert torch.equal(draw(5), draw(5))
    # Every draw lies inside its row's top-8 set.
    top8 = torch.topk(logits, 8, dim=-1).indices
    assert (top8 == draw(6)[:, None]).any(-1).all()
