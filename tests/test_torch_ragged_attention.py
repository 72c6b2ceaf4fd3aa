"""The port's ragged paged attention against the JAX package's.

Inputs are made with numpy from a seed, as the JAX package's own
ragged-kernel tests make them (``tests/test_pallas_attention.py``): the
unified step's rows from explicit descriptors (kv_len, last_index,
draft_len), with the [R, W] positions the XLA path reads rebuilt
through the layout invariant q_start = kv_len - 1 - last_index. The
Pallas kernel runs in interpret mode on the CPU; the port's wrapper
takes its plain version for CPU tensors (the CUDA kernel is held
against that plain version on the card by ``chip_smoke.py`` and
``tests/test_torch_cuda_kernels.py``).

The plain version is held against the Pallas kernel on EVERY slot,
dead slots and pad rows included (both write exact 0 there), and
against the XLA reference on the live slots only (XLA attends pad
slots too, and the sampler never reads them).

Tolerance: f32 at atol = rtol = 1e-5. Both sides do the same f32
arithmetic with sums in another order (the port walks 128-token
chunks, the Pallas kernel 2-page chunks, XLA one softmax over every
page).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from production_stack_tpu.ops.attention import (
    paged_attention as jax_paged_attention,
)
from production_stack_tpu.ops.ragged_attention_pallas import (
    paged_ragged_attention as jax_paged_ragged_attention,
)
from production_stack_tpu_torch.ops.paged_kv_common import COUNTERS
from production_stack_tpu_torch.ops.ragged_attention_cuda import (
    paged_ragged_attention,
    paged_ragged_attention_plain,
)

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)

# name -> the row descriptors and geometry of one block. Pad rows have
# kv_len 0; the engine gives them last_index -1 (position 0), the JAX
# tests 0, and both must write 0.
CASES = {
    "pure_decode": dict(kv_lens=[17, 1, 48, 33], last_index=[0, 0, 0, 0],
                        seed=43),
    "pure_prefill": dict(kv_lens=[8, 29], last_index=[7, 7], seed=47),
    "mixed_rows_and_pads": dict(
        kv_lens=[20, 23, 13, 30, 0, 0], last_index=[0, 3, 4, 7, 0, -1],
        draft_lens=[0, 3, 0, 0, 0, 0], seed=53),
    "verify_spans": dict(kv_lens=[25, 41], last_index=[3, 2],
                         draft_lens=[3, 2], seed=59),
    "gqa_wide": dict(kv_lens=[20, 23, 30, 0], last_index=[0, 2, 5, 0],
                     draft_lens=[0, 2, 0, 0], kv_heads=4, q_heads=16,
                     w=16, seed=67),
    # Rows over several of the port's 128-token walk chunks, at the
    # serving page size's ratio of pages to chunk; the last row's
    # last_index lies past the block (every slot live, at kv_len - 1 -
    # last_index + t).
    "long_rows": dict(kv_lens=[150, 300, 0, 129, 200],
                      last_index=[0, 7, -1, 4, 12],
                      draft_lens=[0, 0, 0, 4, 0], page_size=16,
                      max_pages=20, num_pages=64, seed=71),
}


def _setup(kv_lens, last_index, draft_lens=None, w=8, num_pages=64,
           page_size=8, kv_heads=2, q_heads=8, head_dim=64, max_pages=8,
           seed=0):
    """numpy inputs of one ragged block, and the positions the XLA
    path reads (clamped at 0 for pad rows)."""
    rng = np.random.RandomState(seed)
    r = len(kv_lens)
    kv_lens = np.asarray(kv_lens, np.int32)
    last_index = np.asarray(last_index, np.int32)
    q = rng.randn(r, w, q_heads, head_dim).astype(np.float32)
    k_cache = rng.randn(kv_heads, num_pages, head_dim,
                        page_size).astype(np.float32)
    v_cache = rng.randn(kv_heads, num_pages, head_dim,
                        page_size).astype(np.float32)
    page_table = np.zeros((r, max_pages), np.int32)
    next_page = 1
    for i in range(r):
        for j in range(-(-int(kv_lens[i]) // page_size)):
            page_table[i, j] = next_page % num_pages or 1
            next_page += 1
    positions = np.maximum(
        (kv_lens - 1 - last_index)[:, None]
        + np.arange(w, dtype=np.int32)[None], 0).astype(np.int32)
    dl = None if draft_lens is None else np.asarray(draft_lens, np.int32)
    return q, k_cache, v_cache, page_table, kv_lens, last_index, dl, positions


def _t(x):
    return None if x is None else torch.from_numpy(np.asarray(x))


def _j(x):
    return None if x is None else jnp.asarray(np.asarray(x))


def _live(kv_lens, last_index, w):
    """[R, W] mask of the live slots."""
    slot = np.arange(w)[None]
    return (slot <= last_index[:, None]) & (kv_lens[:, None] > 0)


def _plain(case):
    q, k, v, pt, kv, li, dl, _ = case
    return paged_ragged_attention_plain(_t(q), _t(k), _t(v), _t(pt),
                                        _t(kv), _t(li), _t(dl)).numpy()


@pytest.mark.parametrize("name", sorted(CASES))
def test_ragged_plain_matches_pallas_interpret_on_every_slot(name):
    case = _setup(**CASES[name])
    q, k, v, pt, kv, li, dl, _ = case
    # The Pallas kernel takes a pad row's last_index as given; clamp
    # the engine's -1 to its 0 (both describe no live slot).
    expected = np.asarray(jax_paged_ragged_attention(
        _j(q), _j(k), _j(v), _j(pt), _j(kv), _j(np.maximum(li, 0)),
        _j(dl), interpret=True))
    got = _plain(case)
    np.testing.assert_allclose(got, expected, **TOL)
    dead = ~_live(kv, li, q.shape[1])
    assert not got[dead].any()  # dead slots and pad rows: exact 0
    assert not expected[dead].any()


@pytest.mark.parametrize("name", sorted(CASES))
def test_ragged_plain_matches_xla_on_live_slots(name):
    case = _setup(**CASES[name])
    q, k, v, pt, kv, li, _, pos = case
    expected = np.asarray(jax_paged_attention(
        _j(q), _j(k), _j(v), _j(pt), _j(pos), _j(kv)))
    got = _plain(case)
    live = _live(kv, li, q.shape[1])
    assert live.any()
    np.testing.assert_allclose(got[live], expected[live], **TOL)


def test_ragged_plain_is_invariant_to_draft_lens():
    """The draft span masks itself causally: draft_lens rides the
    interface and changes nothing (as in the Pallas kernel)."""
    q, k, v, pt, kv, li, dl, _ = _setup(**CASES["verify_spans"])
    with_dl = paged_ragged_attention_plain(_t(q), _t(k), _t(v), _t(pt),
                                           _t(kv), _t(li), _t(dl))
    without = paged_ragged_attention_plain(_t(q), _t(k), _t(v), _t(pt),
                                           _t(kv), _t(li))
    torch.testing.assert_close(with_dl, without, rtol=0, atol=0)


def test_ragged_decode_rows_match_the_decode_route():
    """A decode row of a ragged block (last_index 0) is the decode
    kernel's function at its first slot."""
    from production_stack_tpu_torch.ops.paged_attention_cuda import (
        paged_decode_attention_plain,
    )
    q, k, v, pt, kv, li, dl, _ = _setup(**CASES["pure_decode"])
    ragged = _plain((q, k, v, pt, kv, li, dl, None))
    decode = paged_decode_attention_plain(_t(q[:, 0]), _t(k), _t(v),
                                          _t(pt), _t(kv)).numpy()
    np.testing.assert_allclose(ragged[:, 0], decode, **TOL)
    assert not ragged[:, 1:].any()


def test_ragged_wrapper_takes_plain_version_for_cpu_tensors():
    COUNTERS.reset()
    q, k, v, pt, kv, li, dl, _ = (
        _t(x) for x in _setup(**CASES["mixed_rows_and_pads"]))
    torch.testing.assert_close(
        paged_ragged_attention(q, k, v, pt, kv, li, dl),
        paged_ragged_attention_plain(q, k, v, pt, kv, li, dl),
        rtol=0, atol=0)
    # Neither a launch nor a plain call on a CUDA tensor was counted.
    assert COUNTERS.launches == {}
    assert COUNTERS.plain_cuda_calls == {}


@pytest.mark.parametrize("form", ["int8", "stacked"])
def test_ragged_wrapper_raises_on_unported_cache_forms(form):
    """Bare int8 pages lack their scales (an int8 cache is a QuantKV:
    ValueError); a stacked cache without its layer index disagrees with
    its rank (ValueError; with the index it is served:
    tests/test_torch_cache_layout.py)."""
    if form == "int8":
        cache = torch.zeros(2, 4, 64, 16, dtype=torch.int8)
        raises = pytest.raises(ValueError, match="scales")
    else:
        cache = torch.zeros(3, 2, 4, 64, 16)
        raises = pytest.raises(ValueError,
                               match="layer index and cache rank")
    ones = torch.ones(1, dtype=torch.int32)
    with raises:
        paged_ragged_attention(torch.zeros(1, 4, 8, 64), cache, cache,
                               torch.zeros(1, 2, dtype=torch.int32), ones,
                               ones)
