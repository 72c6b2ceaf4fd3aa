"""The port at every page size the JAX engine serves, against the JAX
package.

Inputs are made with numpy from a seed and go through both packages.
The JAX Pallas kernels run in interpret mode on the CPU, as the JAX
package's own tests run them (``tests/test_pallas_attention.py``), and
its XLA reference beside them; the port's wrappers take their plain
versions for CPU tensors (the CUDA kernels are held against those plain
versions at these page sizes on the card by ``chip_smoke.py``'s pages
phase).

A chunk of the port's walk is 128 tokens of a row whatever the page:
token t at page ``page_table[row, t // page_size]``, slot ``t %
page_size``. Covered at pages 1, 8, 24, 48, 200, 256 and 384 (pages
that divide 128, pages that straddle chunk edges, pages of two and
three chunks): the three plain page walks (decode per layer and
stacked, its burst-tail form, prefill, ragged) over f32, bf16 and int8
caches; the plain walk itself (bitwise the whole-page staging at pages
16 and 128; at page 256 a decode split's ``chunk_range`` covers the
128-token chunks that ``decode_splits`` counts); the paths that move
whole pages at page 256 and at an int8 page of 8 (the quantized page
write, the runner's page read and write and their wire frame,
disaggregated handoff through the cache server, deferred burst tails);
greedy streams of the port's engine against the JAX engine's at tiny
widths (two layers) at page 256, page 48 and an int8 page of 8
stacked; and the start-up rule (``kernel_page_size_supported``).

Tolerances: f32 outputs at atol = rtol = 1e-4 (the same f32 arithmetic,
sums in another order: the port walks 128-token chunks, the Pallas
kernels 4-page chunks, the XLA reference one softmax); bf16 outputs at
atol = rtol = 2e-2, compared in f32 (the inputs carry bf16's rounding;
each side rounds its output once). Greedy streams: f32 byte-identical;
bf16 byte-identical or parting only where the JAX engine's own margin
between its token and the port's is under ``NEAR_TIE_LOGITS`` (0.125,
chip_smoke.py's rule), printed.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from production_stack_tpu.engine import config as jax_config
from production_stack_tpu.engine.engine import LLMEngine as JaxEngine
from production_stack_tpu.engine.sequence import (
    SamplingParams as JaxSamplingParams,
)
from production_stack_tpu.models import llama as jax_llama
from production_stack_tpu.models import registry as jax_registry
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
from production_stack_tpu.ops.quant_kv import QuantKV as JaxQuantKV
from production_stack_tpu.ops.quant_kv import quantize_kv as jax_quantize_kv
from production_stack_tpu.ops.ragged_attention_pallas import (
    paged_ragged_attention as jax_paged_ragged_attention,
)
from production_stack_tpu_torch.engine import config
from production_stack_tpu_torch.engine.engine import LLMEngine
from production_stack_tpu_torch.engine.sequence import (
    SamplingParams,
    SequenceState,
)
from production_stack_tpu_torch.models.convert import params_from_numpy
from production_stack_tpu_torch.ops import paged_kv_common
from production_stack_tpu_torch.ops.attention import write_to_pages
from production_stack_tpu_torch.ops.paged_attention_cuda import (
    decode_splits,
    paged_decode_attention,
    paged_decode_attention_plain,
    paged_decode_tail_attention,
)
from production_stack_tpu_torch.ops.paged_kv_common import (
    CHUNK_TOKENS,
    NEG_INF,
    kernel_page_size_refusal,
    kernel_page_size_supported,
    page_walk_partial,
    page_walk_plain,
)
from production_stack_tpu_torch.ops.prefill_attention_cuda import (
    paged_prefill_attention_plain,
)
from production_stack_tpu_torch.ops.quant_kv import QuantKV
from production_stack_tpu_torch.ops.ragged_attention_cuda import (
    paged_ragged_attention_plain,
)

torch.set_num_threads(2)

F32_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
NEAR_TIE_LOGITS = 0.125
PAGES = [1, 8, 24, 48, 200, 256, 384]
# The Pallas kernels in interpret mode take about 60 ms a grid step (a
# row, a kv head, four pages) and seconds to trace: they check the row
# of each case that crosses the chunk edge, the page table cut to its
# pages, over f32 and int8 caches (bf16 and stacked take the same
# kernel code) at pages of 8 and more; every row of every case is held
# to the XLA reference.
PALLAS_MIN_PAGE = 8
PALLAS_FORMS = ("f32", "int8")
# Cache forms: f32 and bf16 pages of the query's type, int8 pages with
# f32 scales under f32 queries, and bf16 pages stacked (layer 1 of 2).
FORMS = ["f32", "bf16", "int8", "stacked"]
KV_HEADS, GROUP, HEAD_DIM = 2, 2, 32


def _j(x, dtype="f32"):
    """numpy f32 -> a JAX array in ``dtype`` (bf16 rounds to nearest
    even, as torch does)."""
    a = jnp.asarray(np.asarray(x, np.float32))
    return a.astype(jnp.bfloat16) if dtype == "bf16" else a


def _t(x, dtype="f32"):
    t = torch.from_numpy(np.asarray(x, np.float32))
    return t.to(torch.bfloat16) if dtype == "bf16" else t


def _i(x):
    return torch.from_numpy(np.asarray(x))


def _qdtype(form):
    return "bf16" if form in ("bf16", "stacked") else "f32"


def _close(got, expected, dtype):
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(jnp.asarray(expected, jnp.float32)),
        **(BF16_TOL if dtype == "bf16" else F32_TOL))


def _table(kv_lens, page, max_pages):
    """Pages of each row in a shuffled order from page 1 on (page 0 is
    the trash page), zeros past each row's pages; returns the table and
    the page count to allocate."""
    need = [-(-int(n) // page) for n in kv_lens]
    ids = np.random.RandomState(page).permutation(sum(need)) + 1
    table = np.zeros((len(kv_lens), max_pages), np.int32)
    at = 0
    for i, n in enumerate(need):
        table[i, :n] = ids[at:at + n]
        at += n
    return table, sum(need) + 1


def _edge_lens(page):
    """kv lens that end just before, at and just after a page edge and
    the first chunk edge, and past a second chunk."""
    return [page - 1 if page > 1 else 1, page, page + 1, 127, 128, 129,
            2 * page + 7 if page > 128 else 300]


def _pallas_rows(rows, table, kv_lens, page):
    """The rows the Pallas kernel checks and the table cut to their
    pages."""
    width = max(1, -(-int(kv_lens[rows].max()) // page))
    return rows, table[rows][:, :width]


def _xla(q, jk, jv, table, positions, kv_lens, form, dtype):
    """The XLA reference (one softmax over the gathered pages) at query
    positions [B, T]."""
    return jax_paged_attention(_j(q, dtype), jk, jv, jnp.asarray(table),
                               jnp.asarray(positions), jnp.asarray(kv_lens),
                               **_layer(form))


def _caches(rng, pages, page, form):
    """(JAX k, v, port k, v) of the same content in ``form``."""
    def one():
        return rng.randn(KV_HEADS, pages, HEAD_DIM, page).astype(np.float32)
    if form == "int8":
        out = []
        for _ in range(2):
            q8, scale = jax_quantize_kv(jnp.transpose(_j(one()),
                                                      (0, 1, 3, 2)))
            out.append((np.asarray(jnp.transpose(q8, (0, 1, 3, 2))),
                        np.asarray(scale)))
        return (JaxQuantKV(jnp.asarray(out[0][0]), jnp.asarray(out[0][1])),
                JaxQuantKV(jnp.asarray(out[1][0]), jnp.asarray(out[1][1])),
                QuantKV(_i(out[0][0]), _i(out[0][1])),
                QuantKV(_i(out[1][0]), _i(out[1][1])))
    dtype = _qdtype(form)
    k, v = one(), one()
    if form == "stacked":
        k, v = np.stack([one(), k]), np.stack([one(), v])
    return _j(k, dtype), _j(v, dtype), _t(k, dtype), _t(v, dtype)


def _layer(form):
    return {"layer": 1} if form == "stacked" else {}


def _first(out):
    """The JAX stacked form returns (out, k, v)."""
    return out[0] if isinstance(out, tuple) else out


# ---- the plain page walks against the Pallas kernels and XLA -------------


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("page", PAGES)
def test_decode_plain_matches_pallas_and_xla(page, form):
    """Rows ending around a page edge and the chunk edge, one past two
    chunks (at pages over 128, past two pages), and a pad row (exact
    0), against the Pallas kernel in interpret mode and the XLA
    reference; at the wrapper's split and at one split."""
    rng = np.random.RandomState(page * 10 + FORMS.index(form))
    kv_lens = np.array(_edge_lens(page) + [0], np.int32)
    max_pages = -(-int(kv_lens.max()) // page) + 1
    table, pages = _table(kv_lens, page, max_pages)
    jk, jv, tk, tv = _caches(rng, pages, page, form)
    dtype = _qdtype(form)
    q = rng.randn(len(kv_lens), KV_HEADS * GROUP, HEAD_DIM)
    xla = _xla(q[:, None], jk, jv, table,
               np.maximum(kv_lens - 1, 0)[:, None], kv_lens, form,
               dtype)[:, 0]
    for splits in (1, 3):
        got = paged_decode_attention_plain(_t(q, dtype), tk, tv, _i(table),
                                           _i(kv_lens), num_splits=splits,
                                           **_layer(form))
        _close(got[:-1], xla[:-1], dtype)
        assert not got[-1].any()
    if page >= PALLAS_MIN_PAGE and form in PALLAS_FORMS:
        rows, cut = _pallas_rows([5], table, kv_lens, page)
        _close(got[rows], _first(jax_paged_decode_attention(
            _j(q[rows], dtype), jk, jv, jnp.asarray(cut),
            jnp.asarray(kv_lens[rows]), interpret=True, **_layer(form))),
            dtype)


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("page", PAGES)
def test_prefill_plain_matches_pallas_interpret(page, form):
    """Chunks of 16 queries starting before and across a page edge and
    the chunk edge, a short chunk (pad slots) and a pad row."""
    rng = np.random.RandomState(page * 10 + FORMS.index(form) + 1)
    t = 16
    starts = np.array([max(page - 5, 0), 120, 250, 37, 0], np.int32)
    lengths = np.array([t, t, t, t - 5, 0], np.int32)
    kv_lens = np.where(lengths > 0, starts + lengths, 0).astype(np.int32)
    positions = np.zeros((len(starts), t), np.int32)
    for i in range(len(starts)):
        if lengths[i]:
            positions[i] = starts[i] + np.arange(t)
    max_pages = -(-int(kv_lens.max()) // page) + 1
    table, pages = _table(kv_lens, page, max_pages)
    jk, jv, tk, tv = _caches(rng, pages, page, form)
    dtype = _qdtype(form)
    q = rng.randn(len(starts), t, KV_HEADS * GROUP, HEAD_DIM)
    got = paged_prefill_attention_plain(_t(q, dtype), tk, tv, _i(table),
                                        _i(positions), _i(kv_lens),
                                        **_layer(form))
    assert not got[-1].any()
    if page >= PALLAS_MIN_PAGE and form in PALLAS_FORMS:
        rows, cut = _pallas_rows([1], table, kv_lens, page)
        _close(got[rows], _first(jax_paged_prefill_attention(
            _j(q[rows], dtype), jk, jv, jnp.asarray(cut),
            jnp.asarray(positions[rows]), jnp.asarray(kv_lens[rows]),
            interpret=True, **_layer(form))), dtype)
    # The XLA reference on the live slots.
    xla = np.asarray(jnp.asarray(_xla(q, jk, jv, table, positions, kv_lens,
                                      form, dtype), jnp.float32))
    for i, n in enumerate(lengths):
        _close(got[i, :n], xla[i, :n], dtype)


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("page", PAGES)
def test_ragged_plain_matches_pallas_interpret(page, form):
    """A decode row at a page edge, a verify row across the chunk edge,
    a chunk row past two chunks and a pad row; dead slots and the pad
    row are exact 0. 16-bit queries take the tensor-core walk's
    rounding (``p_dtype``), as the card's kernel rounds."""
    rng = np.random.RandomState(page * 10 + FORMS.index(form) + 2)
    w = 6
    kv_lens = np.array([page, 130, 300, 0], np.int32)
    last_index = np.array([0, 3, 5, -1], np.int32)
    max_pages = -(-int(kv_lens.max()) // page) + 1
    table, pages = _table(kv_lens, page, max_pages)
    jk, jv, tk, tv = _caches(rng, pages, page, form)
    dtype = _qdtype(form)
    q = rng.randn(4, w, KV_HEADS * GROUP, HEAD_DIM)
    p16 = {"p_dtype": torch.bfloat16} if dtype == "bf16" else {}
    got = paged_ragged_attention_plain(_t(q, dtype), tk, tv, _i(table),
                                       _i(kv_lens), _i(last_index),
                                       **_layer(form), **p16)
    live = ((np.arange(w)[None] <= last_index[:, None])
            & (kv_lens[:, None] > 0))
    assert not got[torch.from_numpy(~live)].any()
    if page >= PALLAS_MIN_PAGE and form in PALLAS_FORMS:
        rows, cut = _pallas_rows([1], table, kv_lens, page)
        _close(got[rows], _first(jax_paged_ragged_attention(
            _j(q[rows], dtype), jk, jv, jnp.asarray(cut),
            jnp.asarray(kv_lens[rows]),
            jnp.asarray(np.maximum(last_index[rows], 0)), interpret=True,
            **_layer(form))), dtype)
    # The XLA reference on the live slots: slot t of row r sits at
    # kv_len - 1 - last_index + t.
    positions = np.maximum(
        kv_lens[:, None] - 1 - np.maximum(last_index, 0)[:, None]
        + np.arange(w)[None], 0).astype(np.int32)
    xla = np.asarray(jnp.asarray(_xla(q, jk, jv, table, positions, kv_lens,
                                      form, dtype), jnp.float32))
    _close(got[torch.from_numpy(live)], xla[live], dtype)


@pytest.mark.parametrize("form", ["f32", "int8", "stacked"])
@pytest.mark.parametrize("page", [8, 48, 256])
def test_decode_tail_plain_matches_xla(page, form):
    """The burst-tail form over pages and a 4-slot tail, rows frozen
    after 1 to 4 slots, against the XLA reference with ``k_tail``."""
    rng = np.random.RandomState(page * 10 + FORMS.index(form) + 3)
    kv_lens = np.array([page - 1 if page > 1 else 1, page + 1, 129, 300],
                       np.int32)
    table, pages = _table(kv_lens, page, -(-300 // page) + 1)
    jk, jv, tk, tv = _caches(rng, pages, page, form)
    dtype = _qdtype(form)
    b, s = len(kv_lens), 4
    q = rng.randn(b, KV_HEADS * GROUP, HEAD_DIM)
    k_tail, v_tail = (rng.randn(b, s, KV_HEADS, HEAD_DIM) for _ in range(2))
    q_pos = kv_lens + np.array([0, 1, 2, 3], np.int32)
    expected = jax_paged_attention(
        _j(q, dtype)[:, None], jk, jv, jnp.asarray(table),
        jnp.asarray(q_pos)[:, None], jnp.asarray(kv_lens),
        k_tail=_j(k_tail, dtype), v_tail=_j(v_tail, dtype),
        **_layer(form))[:, 0]
    got = paged_decode_tail_attention(
        _t(q, dtype), tk, tv, _i(table), _i(kv_lens), _t(k_tail, dtype),
        _t(v_tail, dtype), _i(q_pos), **_layer(form))
    _close(got, expected, dtype)


# ---- the plain walk itself -------------------------------------------------


def _whole_page_walk(q_rows, k_cache, v_cache, page_table, kv_lens,
                     mask_fn, k_scale=None, v_scale=None):
    """The plain walk as it was written for pages that divide 128 alone
    (chunks of 128 // page_size whole pages), kept here to hold the
    walk that serves every page to the same bits at those pages."""
    b, kvh, rows, d = q_rows.shape
    page_size = k_cache.shape[-1]
    per = CHUNK_TOKENS // page_size
    kv_lens = kv_lens.long()
    max_pages = page_table.shape[1]
    n_chunks = -(-max_pages // per)
    if max_pages % per:
        page_table = torch.nn.functional.pad(
            page_table, (0, n_chunks * per - max_pages))
    page_table = page_table.long()
    pages_needed = -(-kv_lens // page_size)
    row_chunks = -(-kv_lens // CHUNK_TOKENS)
    walk = min(n_chunks, int(row_chunks.max()))
    m = torch.full((b, kvh, rows, 1), NEG_INF)
    l = torch.zeros((b, kvh, rows, 1))
    acc = torch.zeros((b, kvh, rows, d))
    lane = torch.arange(per)
    for c in range(walk):
        ids = page_table[:, c * per:(c + 1) * per]
        live = (c * per + lane)[None] < pages_needed[:, None]

        def stage(cache):
            tile = cache[:, ids].float()
            tile = torch.where(live[None, :, :, None, None], tile, 0.0)
            return tile.permute(1, 0, 3, 2, 4).reshape(b, kvh, d,
                                                       CHUNK_TOKENS)

        def stage_scale(scales):
            tile = torch.where(live[None, :, :, None], scales[:, ids], 0.0)
            return tile.permute(1, 0, 2, 3).reshape(b, kvh, 1,
                                                    CHUNK_TOKENS)

        k, v = stage(k_cache), stage(v_cache)
        s = (q_rows.float() @ k) * (1.0 / d ** 0.5)
        if k_scale is not None:
            s = s * stage_scale(k_scale)
        s = torch.where(mask_fn(c * CHUNK_TOKENS
                                + torch.arange(CHUNK_TOKENS)), s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        active = (c < row_chunks)[:, None, None, None]
        l = torch.where(active, l * alpha + p.sum(-1, keepdim=True), l)
        if v_scale is not None:
            p = p * stage_scale(v_scale)
        acc = torch.where(active, acc * alpha + p @ v.transpose(-1, -2), acc)
        m = torch.where(active, m_new, m)
    return acc / torch.clamp(l, min=1e-30)


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("page", [16, 128])
def test_plain_walk_is_bitwise_the_whole_page_walk(page, int8):
    gen = torch.Generator().manual_seed(page)
    kv_lens = torch.tensor([130, 0, 400, 16], dtype=torch.int32)
    max_pages = -(-400 // page) + 1
    table_np, pages = _table(kv_lens.numpy(), page, max_pages)
    table = _i(table_np)
    k = torch.randn((KV_HEADS, pages, HEAD_DIM, page), generator=gen)
    v = torch.randn((KV_HEADS, pages, HEAD_DIM, page), generator=gen)
    scales = ()
    if int8:
        k = (k * 40).round().clamp(-127, 127).to(torch.int8)
        v = (v * 40).round().clamp(-127, 127).to(torch.int8)
        scales = tuple(torch.rand((KV_HEADS, pages, page), generator=gen)
                       for _ in range(2))
    q = torch.randn((4, KV_HEADS, 3, HEAD_DIM), generator=gen)
    lens = kv_lens.long()[:, None, None, None]

    def mask(pos):
        return pos < lens

    got = page_walk_plain(q, k, v, table, kv_lens, mask, *scales)
    assert torch.equal(got, _whole_page_walk(q, k, v, table, kv_lens, mask,
                                             *scales))


def test_decode_split_at_page_256_covers_the_counted_chunks():
    """At page 256 a split's ``chunk_range`` walks the 128-token chunks
    ``decode_splits`` counts: chunk c is tokens [128 c, 128 c + 128),
    half a page, and the splits cover every chunk of the table once."""
    page, max_pages = 256, 4
    splits, per = decode_splits(1, KV_HEADS, max_pages, page)
    assert splits * per >= max_pages * page // CHUNK_TOKENS == 8
    rng = np.random.RandomState(5)
    kv_lens = np.array([900], np.int32)
    table, pages = _table(kv_lens, page, max_pages)
    k = _t(rng.randn(KV_HEADS, pages, HEAD_DIM, page))
    v = _t(rng.randn(KV_HEADS, pages, HEAD_DIM, page))
    q = _t(rng.randn(1, KV_HEADS, GROUP, HEAD_DIM))
    lens = torch.tensor([[[[900]]]])
    # The dense keys of the row, token-major: [KV, 900, D].
    dense_k = k[:, _i(table[0]).long()].permute(0, 1, 3, 2).reshape(
        KV_HEADS, -1, HEAD_DIM)[:, :900]
    covered = []
    for c in range(8):
        m, l, _ = page_walk_partial(q, k, v, _i(table), _i(kv_lens),
                                    lambda pos: pos < lens,
                                    chunk_range=(c, c + 1))
        lo, hi = c * CHUNK_TOKENS, min((c + 1) * CHUNK_TOKENS, 900)
        if lo >= 900:
            assert (m == NEG_INF).all() and not l.any()
            continue
        scores = torch.einsum("bhgd,htd->bhgt", q, dense_k[:, lo:hi]) / (
            HEAD_DIM ** 0.5)
        torch.testing.assert_close(m[..., 0], scores.amax(-1), **F32_TOL)
        torch.testing.assert_close(
            l[..., 0], torch.exp(scores - scores.amax(-1, keepdim=True))
            .sum(-1), **F32_TOL)
        covered.append((lo, hi))
    assert covered[0] == (0, 128) and covered[-1] == (896, 900)
    whole = paged_decode_attention(q.reshape(1, -1, HEAD_DIM), k, v,
                                   _i(table), _i(kv_lens))
    for n in (2, 4, 8):
        torch.testing.assert_close(
            paged_decode_attention(q.reshape(1, -1, HEAD_DIM), k, v,
                                   _i(table), _i(kv_lens), num_splits=n),
            whole, **F32_TOL)


# ---- the start-up rule -----------------------------------------------------


@pytest.mark.parametrize("cache", [torch.bfloat16, torch.float16,
                                   torch.float32, torch.int8])
def test_every_page_of_one_token_or_more_is_served(cache, monkeypatch):
    """The rule takes every page of 1 token or more, and the start-up
    check passes it over every cache dtype up to the library (stubbed
    here to say yes)."""
    monkeypatch.setattr(paged_kv_common, "kernel_lib", _YesLibrary)
    dtype = torch.bfloat16 if cache is torch.int8 else cache
    for page in PAGES + [2, 3, 5, 12, 16, 96, 128, 512, 1000]:
        assert kernel_page_size_supported(page), page
        assert kernel_page_size_refusal(page) is None
        paged_kv_common.check_kernel_shapes(8, 2, 64, page, dtype, cache)


class _YesLibrary:
    """A kernel library that serves every geometry and page asked."""

    @staticmethod
    def pstt_kernel_supports(*args):
        return 1

    @staticmethod
    def pstt_page_size_supported(page_size):
        return 1


@pytest.mark.parametrize("page", [0, -16])
def test_pages_under_one_token_are_refused_naming_the_rule(page,
                                                           monkeypatch):
    """The rule refuses, and the start-up check raises by it before it
    asks the library (which it never reaches here)."""
    assert not kernel_page_size_supported(page)
    assert f"1 token or more, not {page}" in kernel_page_size_refusal(page)

    def no_library():
        raise AssertionError("the check asked the library")

    monkeypatch.setattr(paged_kv_common, "kernel_lib", no_library)
    with pytest.raises(NotImplementedError,
                       match=f"page_size {page} is not served"):
        paged_kv_common.check_kernel_shapes(8, 2, 64, page, torch.bfloat16,
                                            torch.int8)


# ---- the paths that move whole pages ---------------------------------------


@pytest.mark.parametrize("page,kv", [(256, "f32"), (8, "int8")])
def test_page_write_matches_jax(page, kv):
    """The write of prefill and decode slots (across a page edge, pad
    slots on trash page 0) into pages of 256 and int8 pages of 8, bit
    for bit JAX's on every page but the trash page."""
    rng = np.random.RandomState(page)
    b, t, pages = 3, 5, 12
    new_kv = rng.randn(b, t, KV_HEADS, HEAD_DIM).astype(np.float32)
    table = np.array([[3, 7, 0], [5, 0, 0], [9, 11, 2]], np.int32)
    positions = np.array([[6, 7, 8, 9, 10], [0, 1, 2, 3, 4],
                          [page - 2 + i for i in range(t)]], np.int32)
    valid = np.ones((b, t), bool)
    valid[1, 3:] = False
    base = rng.randn(KV_HEADS, pages, HEAD_DIM, page).astype(np.float32)
    if kv == "int8":
        q8, scale = jax_quantize_kv(jnp.transpose(_j(base), (0, 1, 3, 2)))
        data = np.asarray(jnp.transpose(q8, (0, 1, 3, 2)))
        scale = np.asarray(scale)
        expected = jax_write_to_pages(
            JaxQuantKV(jnp.asarray(data), jnp.asarray(scale)), _j(new_kv),
            jnp.asarray(table), jnp.asarray(positions), jnp.asarray(valid))
        cache = QuantKV(_i(data.copy()), _i(scale.copy()))
        write_to_pages(cache, _t(new_kv), _i(table), _i(positions),
                       _i(valid))
        np.testing.assert_array_equal(cache.data.numpy()[:, 1:],
                                      np.asarray(expected.data)[:, 1:])
        np.testing.assert_array_equal(cache.scale.numpy()[:, 1:],
                                      np.asarray(expected.scale)[:, 1:])
        return
    expected = jax_write_to_pages(_j(base), _j(new_kv), jnp.asarray(table),
                                  jnp.asarray(positions),
                                  jnp.asarray(valid))
    cache = _t(base.copy())
    write_to_pages(cache, _t(new_kv), _i(table), _i(positions), _i(valid))
    np.testing.assert_array_equal(cache.numpy()[:, 1:],
                                  np.asarray(expected)[:, 1:])


@pytest.fixture(scope="module")
def weights():
    cfg = jax_config.tiny_model_config("llama")
    return {k: np.asarray(v) for k, v in
            jax_llama.init_params(cfg, jax.random.PRNGKey(31)).items()}


def _tiny_config(module, page, kv="auto", layout="auto", num_pages=None,
                 **sched):
    return module.EngineConfig(
        model=module.tiny_model_config("llama"),
        cache=module.CacheConfig(
            page_size=page, num_pages=num_pages or max(16, 4096 // page),
            kv_cache_dtype=kv, cache_layout=layout),
        scheduler=module.SchedulerConfig(**{
            "max_num_seqs": 4, "max_model_len": 1024,
            "prefill_chunk_size": 64, **sched}))


def _port(weights, cfg, **kw):
    return LLMEngine(cfg, params=params_from_numpy(weights, cfg.model, "cpu"),
                     device="cpu", **kw)


@pytest.mark.parametrize("page,kv,layout", [(256, "auto", "per_layer"),
                                            (8, "int8", "stacked")],
                         ids=["f32-256", "int8-8-stacked"])
def test_page_read_and_write_round_trip_and_wire_match_jax(weights, page,
                                                           kv, layout):
    """The runner's ``read_page`` / ``write_page`` (the offload tier's
    and the handoff's unit) at page 256 and at an int8 page of 8: a
    page written is read back bitwise, and its tensors equal the JAX
    runner's read of the same page written there."""
    engine = _port(weights, _tiny_config(config, page, kv, layout))
    m = engine.config.model
    shape = (m.num_hidden_layers, m.num_key_value_heads, m.head_dim, page)
    gen = torch.Generator().manual_seed(page)
    if kv == "int8":
        page_data = (torch.randint(-127, 128, shape, generator=gen,
                                   dtype=torch.int8),
                     torch.randint(-127, 128, shape, generator=gen,
                                   dtype=torch.int8),
                     torch.rand(shape[:2] + (page,), generator=gen),
                     torch.rand(shape[:2] + (page,), generator=gen))
    else:
        page_data = tuple(torch.randn(shape, generator=gen)
                          for _ in range(2))
    engine.runner.write_page(3, *page_data)
    got = engine.runner.read_page(3)
    assert all(torch.equal(a, b) and a.dtype == b.dtype
               for a, b in zip(got, page_data))
    ref = JaxEngine(_tiny_config(jax_config, page, kv, layout),
                    params={k: jnp.asarray(v) for k, v in weights.items()})
    ref.runner.write_page(3, *[jnp.asarray(t.numpy()) for t in page_data])
    for a, b in zip(got, ref.runner.read_page(3)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _jax_stream(weights, cfg, prompt, max_tokens):
    engine = JaxEngine(cfg, params={k: jnp.asarray(v)
                                    for k, v in weights.items()})
    return engine.generate(list(prompt), JaxSamplingParams(
        max_tokens=max_tokens, temperature=0.0,
        ignore_eos=True)).output_token_ids


@pytest.mark.parametrize("page,kv,layout", [(256, "auto", "per_layer"),
                                            (8, "int8", "stacked")],
                         ids=["f32-256", "int8-8-stacked"])
def test_disaggregated_handoff_matches_monolithic_and_jax(weights, page,
                                                          kv, layout):
    """A prefill-role engine ships a prompt's committed pages to the
    port's cache server; a decode-role engine restores them and
    continues. The stream equals the monolithic engine's and JAX's."""
    from tests.test_torch_crash_recovery import serve_cache
    url, server = serve_cache()
    try:
        prompt = list(range(1, 2 * page + 40 if page > 64 else 70))
        sampling = SamplingParams(max_tokens=12, temperature=0.0,
                                  ignore_eos=True)

        def engine(role):
            cfg = _tiny_config(config, page, kv, layout)
            cfg = dataclasses.replace(
                cfg, engine_role=role,
                offload=config.OffloadConfig(enable=True, remote_url=url,
                                             host_pool_bytes=0))
            return _port(weights, cfg)

        mono = _port(weights, _tiny_config(config, page, kv, layout)
                     ).generate(prompt, sampling).output_token_ids
        pre = engine("prefill")
        sid = pre.add_request(prompt, sampling, handoff_prefill=True)
        outs = []
        while not outs or not outs[-1].finished:
            outs.extend(pre.step())
        first, info = outs[-1].new_token, pre.take_handoff_info(sid)
        assert info["num_pages"] == len(prompt) // page
        dec = engine("decode")
        seq = dec.sequences[dec.add_handoff(prompt, first, sampling)]
        while seq.state != SequenceState.FINISHED:
            dec.step()
        assert dec.offload.restored_pages == len(prompt) // page
        assert [first] + seq.output_token_ids == mono == _jax_stream(
            weights, _tiny_config(jax_config, page, kv, layout), prompt, 12)
    finally:
        server.shutdown()


def test_deferred_burst_tails_at_page_256_match_jax(weights):
    """Decode bursts of 4 with deferred KV writes at page 256 (a row's
    burst tail flushes into the middle of a page), against the eager
    burst and the JAX engine's deferred burst. An int8 page of 8,
    stacked, runs in tests/test_torch_deferred_kv.py."""
    rs = np.random.RandomState(3)
    prompts = [[int(t) for t in rs.randint(1, 500, n)]
               for n in (7, 250, 41, 300)]
    sp = dict(max_tokens=14, temperature=0.0, ignore_eos=True)

    def run(engine, sampling_cls):
        return [list(s.output_token_ids) for s in engine.generate_batch(
            prompts, sampling_cls(**sp))]

    kw = dict(decode_steps=4)
    deferred = run(_port(weights, _tiny_config(
        config, 256, deferred_kv_writes=True, **kw)), SamplingParams)
    eager = run(_port(weights, _tiny_config(config, 256, **kw)),
                SamplingParams)
    theirs = run(JaxEngine(
        _tiny_config(jax_config, 256, deferred_kv_writes=True, **kw),
        params={k: jnp.asarray(v) for k, v in weights.items()}),
        JaxSamplingParams)
    assert deferred == eager == theirs


# ---- greedy streams against the JAX engine --------------------------------

# (label, page, KV dtype, layout, model dtype): page 256 (two chunks a
# page), page 48 (pages straddling chunk edges) and an int8 page of 8,
# stacked.
ENGINES = [("page256-f32", 256, "auto", "per_layer", "float32"),
           ("page48-bf16", 48, "auto", "per_layer", "bfloat16"),
           ("int8-page8-stacked", 8, "int8", "stacked", "float32")]


def _model(cls, dtype):
    return cls(name="tiny-llama", architecture="llama", vocab_size=512,
               hidden_size=128, intermediate_size=192, num_hidden_layers=2,
               num_attention_heads=4, num_key_value_heads=2, head_dim=32,
               max_position_embeddings=1024, dtype=dtype)


def _near_tie(engine, context, got_token):
    """The JAX engine's margin (its best logprob minus its logprob of
    ``got_token``) at the token after ``context``."""
    sid = engine.add_request(list(context), JaxSamplingParams(
        temperature=0.0, max_tokens=1, logprobs=True, top_logprobs=20,
        ignore_eos=True))
    entry = None
    while entry is None:
        for out in engine.step():
            if out.seq_id == sid and out.logprobs is not None:
                entry = out.logprobs
    while engine.has_work():
        engine.step()
    tops = dict(entry[1])
    return max(tops.values()) - tops.get(got_token, float("-inf"))


@pytest.mark.parametrize("label,page,kv,layout,dtype", ENGINES,
                         ids=[e[0] for e in ENGINES])
def test_greedy_streams_match_jax(label, page, kv, layout, dtype):
    """Four prompts of 5 to 300 tokens, 16 greedy tokens each, submitted
    together: prefill chunks, decode steps and rows that cross page and
    chunk edges."""
    def engine_config(module):
        return module.EngineConfig(
            model=_model(module.ModelConfig, dtype),
            cache=module.CacheConfig(page_size=page,
                                     num_pages=max(16, 4096 // page),
                                     kv_cache_dtype=kv, cache_layout=layout),
            scheduler=module.SchedulerConfig(max_num_seqs=4,
                                             max_model_len=512,
                                             prefill_chunk_size=64))

    jax_model = _model(jax_config.ModelConfig, dtype)
    init, _ = jax_registry.get_model(jax_model)
    weights = {k: np.asarray(v, np.float32) for k, v in init(
        jax_model, jax.random.PRNGKey(19)).items()}
    jax_params = {k: jnp.asarray(v).astype(jax_model.jax_dtype)
                  for k, v in weights.items()}
    ref_engine = JaxEngine(engine_config(jax_config), params=jax_params)
    port_model = _model(config.ModelConfig, dtype)
    port = LLMEngine(engine_config(config),
                     params=params_from_numpy(weights, port_model, "cpu"),
                     device="cpu")
    rng = np.random.RandomState(8)
    prompts = [rng.randint(1, 500, size=n).tolist() for n in (5, 47, 130,
                                                              300)]
    sp = dict(temperature=0.0, max_tokens=16, ignore_eos=True)
    ref = [list(s.output_token_ids) for s in ref_engine.generate_batch(
        prompts, JaxSamplingParams(**sp))]
    got = [list(s.output_token_ids) for s in port.generate_batch(
        prompts, SamplingParams(**sp))]
    if dtype == "float32":
        assert got == ref
        return
    for i, (r, g) in enumerate(zip(ref, got)):
        assert len(g) == len(r)
        flip = next((j for j, (x, y) in enumerate(zip(r, g)) if x != y),
                    None)
        if flip is None:
            continue
        margin = _near_tie(ref_engine, prompts[i] + r[:flip], g[flip])
        print(f"{label}: stream {i} parts at token {flip}, JAX margin "
              f"{margin:.4f}")
        assert margin < NEAR_TIE_LOGITS, (label, i, flip, margin)
