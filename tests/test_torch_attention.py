"""The port's paged-KV attention against the JAX package's.

Inputs are made with numpy from a seed and go through both. The JAX
Pallas kernels run in interpret mode on the CPU, as the JAX package's
own tests run them; the port's wrappers take their plain versions for
CPU tensors (the CUDA kernels are held against those plain versions on
the card by ``chip_smoke.py``).

Tolerance: f32 at atol = rtol = 1e-5. Both sides do the same f32
arithmetic; the sums run in another order (the port walks 128-token
chunks, the TPU kernels 4- or 2-page chunks, the XLA reference one
softmax over every page).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from production_stack_tpu.ops.attention import (
    paged_attention as jax_paged_attention,
    write_to_pages as jax_write_to_pages,
)
from production_stack_tpu.ops.paged_attention_pallas import (
    paged_decode_attention as jax_paged_decode_attention,
)
from production_stack_tpu.ops.prefill_attention_pallas import (
    paged_prefill_attention as jax_paged_prefill_attention,
)
from production_stack_tpu_torch.models.llama import dispatch_attention
from production_stack_tpu_torch.ops.attention import (
    paged_attention,
    write_to_pages,
)
from production_stack_tpu_torch.ops.paged_attention_cuda import (
    paged_decode_attention,
    paged_decode_attention_plain,
)
from production_stack_tpu_torch.ops.paged_kv_common import COUNTERS
from production_stack_tpu_torch.ops.prefill_attention_cuda import (
    paged_prefill_attention,
    paged_prefill_attention_plain,
)
from production_stack_tpu_torch.ops.ragged_attention_cuda import (
    paged_ragged_attention_plain,
)

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _j(x):
    return jnp.asarray(np.asarray(x))


def _cache_and_table(rng, b, kv_heads, head_dim, page_size, num_pages,
                     max_pages, kv_lens):
    """Random caches and a page table of distinct pages (page 0, the
    trash page, is never handed out)."""
    k_cache = rng.randn(kv_heads, num_pages, head_dim,
                        page_size).astype(np.float32)
    v_cache = rng.randn(kv_heads, num_pages, head_dim,
                        page_size).astype(np.float32)
    page_table = np.zeros((b, max_pages), np.int32)
    free = list(rng.permutation(np.arange(1, num_pages)))
    for i, n in enumerate(kv_lens):
        for j in range(-(-int(n) // page_size)):
            page_table[i, j] = free.pop()
    return k_cache, v_cache, page_table


def _decode_case(seed, page_size, kv_heads, q_heads, head_dim=64,
                 max_pages=None):
    """Decode inputs with rows spanning several 128-token walk chunks,
    a one-token row and a pad row (kv_len 0)."""
    rng = np.random.RandomState(seed)
    max_pages = max_pages or 160 // page_size
    kv_lens = np.array([1, 0, 130, max_pages * page_size - 3,
                        rng.randint(2, max_pages * page_size)], np.int32)
    b = len(kv_lens)
    q = rng.randn(b, q_heads, head_dim).astype(np.float32)
    k_cache, v_cache, page_table = _cache_and_table(
        rng, b, kv_heads, head_dim, page_size, b * max_pages + 1,
        max_pages, kv_lens)
    return q, k_cache, v_cache, page_table, kv_lens


def _prefill_case(seed, page_size, kv_heads, q_heads, first_chunk,
                  chunk=24, head_dim=64, max_pages=None):
    """A chunk of T queries per row at positions start + t, with the
    cached context before it (none for a first chunk), a row whose
    chunk is shorter than T (pad slots at its tail) and a pad row."""
    rng = np.random.RandomState(seed)
    max_pages = max_pages or 192 // page_size
    b = 3
    lengths = np.array([chunk, chunk - 7, 0], np.int32)
    starts = (np.zeros(b, np.int32) if first_chunk else
              np.array([140, 37, 0], np.int32))
    kv_lens = np.where(lengths > 0, starts + lengths, 0).astype(np.int32)
    positions = np.zeros((b, chunk), np.int32)
    valid = np.zeros((b, chunk), bool)
    for i in range(b):
        if lengths[i]:
            positions[i] = starts[i] + np.arange(chunk)
            valid[i, :lengths[i]] = True
    q = rng.randn(b, chunk, q_heads, head_dim).astype(np.float32)
    k_cache, v_cache, page_table = _cache_and_table(
        rng, b, kv_heads, head_dim, page_size, b * max_pages + 1,
        max_pages, kv_lens)
    return q, k_cache, v_cache, page_table, positions, kv_lens, valid


# ---- page writes and the gather reference -------------------------------


@pytest.mark.parametrize("page_size", [8, 16])
def test_write_to_pages_matches_jax(page_size):
    rng = np.random.RandomState(1)
    kv_heads, head_dim, b, t = 2, 32, 3, 5
    cache = rng.randn(kv_heads, 24, head_dim, page_size).astype(np.float32)
    new_kv = rng.randn(b, t, kv_heads, head_dim).astype(np.float32)
    page_table = np.array([[3, 7, 0], [5, 0, 0], [9, 11, 2]], np.int32)
    positions = np.array([[6, 7, 8, 9, 10],
                          [0, 1, 2, 3, 4],
                          [page_size - 2, page_size - 1, page_size,
                           page_size + 1, page_size + 2]], np.int32)
    valid = np.ones((b, t), bool)
    valid[1, 3:] = False  # pad slots land on trash page 0
    expected = np.asarray(jax_write_to_pages(
        _j(cache), _j(new_kv), _j(page_table), _j(positions), _j(valid)))
    port_cache = _t(cache.copy())
    out = write_to_pages(port_cache, _t(new_kv), _t(page_table),
                         _t(positions), _t(valid))
    assert out is port_cache  # in place
    # Page 0 takes the pad slots: which of them wins is unspecified.
    np.testing.assert_array_equal(out.numpy()[:, 1:], expected[:, 1:])


def test_write_to_pages_rejects_stacked_cache():
    """A stacked cache comes with its layer index (written in place at
    that layer: tests/test_torch_cache_layout.py); without it, the rank
    and the missing index disagree."""
    cache = torch.zeros(2, 2, 4, 8, 8)
    with pytest.raises(ValueError, match="layer index and cache rank"):
        write_to_pages(cache, torch.zeros(1, 1, 4, 8),
                       torch.zeros(1, 1, dtype=torch.int32),
                       torch.zeros(1, 1, dtype=torch.int32),
                       torch.ones(1, 1, dtype=torch.bool))


@pytest.mark.parametrize("first_chunk", [True, False])
def test_paged_attention_matches_jax_xla(first_chunk):
    q, k, v, pt, pos, kv_lens, valid = _prefill_case(
        3, 16, 2, 8, first_chunk, head_dim=32)
    expected = np.asarray(jax_paged_attention(
        _j(q), _j(k), _j(v), _j(pt), _j(pos), _j(kv_lens)))
    got = paged_attention(_t(q), _t(k), _t(v), _t(pt), _t(pos),
                          _t(kv_lens)).numpy()
    live = kv_lens > 0
    np.testing.assert_allclose(got[live], expected[live], **TOL)


# ---- decode page walk -----------------------------------------------------


@pytest.mark.parametrize("page_size,kv_heads,q_heads",
                         [(8, 2, 8), (16, 4, 8)])
def test_decode_plain_matches_pallas_interpret(page_size, kv_heads,
                                               q_heads):
    q, k, v, pt, kv_lens = _decode_case(5, page_size, kv_heads, q_heads)
    expected = np.asarray(jax_paged_decode_attention(
        _j(q), _j(k), _j(v), _j(pt), _j(kv_lens), interpret=True))
    got = paged_decode_attention_plain(_t(q), _t(k), _t(v), _t(pt),
                                       _t(kv_lens)).numpy()
    np.testing.assert_allclose(got, expected, **TOL)
    assert not got[kv_lens == 0].any()  # a pad row writes exact 0


@pytest.mark.parametrize("page_size,kv_heads,q_heads",
                         [(8, 2, 8), (16, 2, 2), (16, 1, 8)])
def test_decode_plain_matches_xla_at_t1(page_size, kv_heads, q_heads):
    q, k, v, pt, kv_lens = _decode_case(6, page_size, kv_heads, q_heads)
    expected = np.asarray(jax_paged_attention(
        _j(q[:, None]), _j(k), _j(v), _j(pt),
        _j(np.maximum(kv_lens - 1, 0)[:, None]), _j(kv_lens)))[:, 0]
    got = paged_decode_attention_plain(_t(q), _t(k), _t(v), _t(pt),
                                       _t(kv_lens)).numpy()
    live = kv_lens > 0
    np.testing.assert_allclose(got[live], expected[live], **TOL)


# ---- chunked-prefill page walk ---------------------------------------------


@pytest.mark.parametrize("page_size,first_chunk",
                         [(8, True), (16, False)])
def test_prefill_plain_matches_pallas_interpret(page_size, first_chunk):
    q, k, v, pt, pos, kv_lens, _ = _prefill_case(
        7, page_size, 2, 8, first_chunk)
    expected = np.asarray(jax_paged_prefill_attention(
        _j(q), _j(k), _j(v), _j(pt), _j(pos), _j(kv_lens),
        interpret=True))
    got = paged_prefill_attention_plain(_t(q), _t(k), _t(v), _t(pt),
                                        _t(pos), _t(kv_lens)).numpy()
    # The plain version mirrors the kernel, pad slots included (query t
    # sits at start + t) and a pad row's exact 0.
    np.testing.assert_allclose(got, expected, **TOL)
    assert not got[kv_lens == 0].any()


@pytest.mark.parametrize("page_size,kv_heads,q_heads,first_chunk",
                         [(8, 2, 8, True), (16, 2, 8, False),
                          (16, 4, 4, False)])
def test_prefill_plain_matches_xla(page_size, kv_heads, q_heads,
                                   first_chunk):
    q, k, v, pt, pos, kv_lens, valid = _prefill_case(
        8, page_size, kv_heads, q_heads, first_chunk)
    expected = np.asarray(jax_paged_attention(
        _j(q), _j(k), _j(v), _j(pt), _j(pos), _j(kv_lens)))
    got = paged_prefill_attention_plain(_t(q), _t(k), _t(v), _t(pt),
                                        _t(pos), _t(kv_lens)).numpy()
    np.testing.assert_allclose(got[valid], expected[valid], **TOL)


# ---- wrappers ---------------------------------------------------------------


def test_wrappers_take_plain_version_for_cpu_tensors():
    COUNTERS.reset()
    q, k, v, pt, kv_lens = (_t(x) for x in _decode_case(9, 16, 2, 8))
    torch.testing.assert_close(
        paged_decode_attention(q, k, v, pt, kv_lens),
        paged_decode_attention_plain(q, k, v, pt, kv_lens), rtol=0, atol=0)
    q, k, v, pt, pos, kv_lens, _ = (
        _t(x) for x in _prefill_case(9, 16, 2, 8, False))
    torch.testing.assert_close(
        paged_prefill_attention(q, k, v, pt, pos, kv_lens),
        paged_prefill_attention_plain(q, k, v, pt, pos, kv_lens),
        rtol=0, atol=0)
    # Neither a launch nor a plain call on a CUDA tensor was counted.
    assert COUNTERS.launches == {}
    assert COUNTERS.plain_cuda_calls == {}


@pytest.mark.parametrize("form", ["int8", "stacked"])
def test_wrappers_raise_on_unported_cache_forms(form):
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
    pt = torch.zeros(1, 2, dtype=torch.int32)
    kv_lens = torch.ones(1, dtype=torch.int32)
    with raises:
        paged_decode_attention(torch.zeros(1, 8, 64), cache, cache, pt,
                               kv_lens)
    with raises:
        paged_prefill_attention(torch.zeros(1, 4, 8, 64), cache, cache, pt,
                                torch.zeros(1, 4, dtype=torch.int32),
                                kv_lens)


def test_dispatch_attention_routes_by_step_shape():
    """The runner names the step kind; each kind takes its kernel's
    route. A ragged block rebuilds each row's last_index from the
    layout invariant positions[:, 0] == kv_lens - 1 - last_index."""
    q, k, v, pt, kv_lens = (_t(x) for x in _decode_case(10, 16, 2, 8))
    out = dispatch_attention(None, q[:, None], k, v, pt,
                             (kv_lens - 1)[:, None], kv_lens, "decode")
    torch.testing.assert_close(
        out[:, 0], paged_decode_attention_plain(q, k, v, pt, kv_lens),
        rtol=0, atol=0)
    q, k, v, pt, pos, kv_lens, valid = (
        _t(x) for x in _prefill_case(10, 16, 2, 8, False))
    out = dispatch_attention(None, q, k, v, pt, pos, kv_lens, "prefill",
                             impl="cuda")
    torch.testing.assert_close(
        out, paged_prefill_attention_plain(q, k, v, pt, pos, kv_lens),
        rtol=0, atol=0)
    # The same block as a ragged step: each row's live slots are its
    # valid ones (rows 0 and 1 end at their chunk's last token).
    last_index = (kv_lens - 1 - pos[:, 0]).to(torch.int32)
    out = dispatch_attention(None, q, k, v, pt, pos, kv_lens, "ragged",
                             impl="cuda")
    torch.testing.assert_close(
        out, paged_ragged_attention_plain(q, k, v, pt, kv_lens,
                                          last_index), rtol=0, atol=0)
    torch.testing.assert_close(
        out[valid], paged_prefill_attention_plain(
            q, k, v, pt, pos, kv_lens)[valid], **TOL)
    assert not out[~valid].any()  # dead slots and the pad row
    with pytest.raises(ValueError):
        dispatch_attention(None, q, k, v, pt, pos, kv_lens, "prefill",
                           impl="xla")
    with pytest.raises(ValueError, match="step kind"):
        dispatch_attention(None, q, k, v, pt, pos, kv_lens, "verify")
