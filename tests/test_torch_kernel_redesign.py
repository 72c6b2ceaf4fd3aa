"""The redesigned decode, prefill and ragged kernels' algorithms on the CPU.

The CUDA kernels run only on the card (tests/test_torch_cuda_kernels.py,
``chip_smoke.py``); what can be held here is their arithmetic, which the
plain versions repeat step for step:

- the split decode walk (``paged_decode_attention_plain(...,
  num_splits=S)``: the table's chunks cut into S ranges, each walked to
  its unnormalised softmax state, the states merged in split order by
  ``merge_partials_plain``) against the JAX XLA reference and the Pallas
  decode kernel in interpret mode;
- ``decode_splits``, which picks S and the chunks of a split from
  host-known shapes only;
- the prefill and the ragged walks with the tensor-core kernel's
  rounding (probabilities rounded to bf16 before p . v, l from the
  unrounded ones) against the Pallas prefill and ragged kernels in
  interpret mode, and their defaults unchanged;
- the model's ``plain_bf16p`` attention, which routes the prefill and
  ragged steps of bf16 queries through that rounding;
- the CPU wrappers still taking the plain versions.

Inputs are made with numpy from a seed and go through both packages.
Tolerance: f32 at atol = rtol = 1e-5 (the same f32 arithmetic, sums in
another order: the split walk merges S partial sums); the bf16-rounded
prefill and ragged walks at 2e-2 (one bf16 rounding of probabilities of
order 1).
"""

import inspect

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from production_stack_tpu.ops.attention import (
    paged_attention as jax_paged_attention,
)
from production_stack_tpu.ops.paged_attention_pallas import (
    paged_decode_attention as jax_paged_decode_attention,
)
from production_stack_tpu.ops.prefill_attention_pallas import (
    paged_prefill_attention as jax_paged_prefill_attention,
)
from production_stack_tpu.ops.ragged_attention_pallas import (
    paged_ragged_attention as jax_paged_ragged_attention,
)
from production_stack_tpu.ops.quant_kv import (
    QuantKV as JaxQuantKV,
    quantize_kv as jax_quantize_kv,
)
from production_stack_tpu_torch.ops.paged_attention_cuda import (
    TARGET_BLOCKS,
    decode_splits,
    paged_decode_attention,
    paged_decode_attention_plain,
)
from production_stack_tpu_torch.ops.paged_kv_common import (
    CHUNK_TOKENS,
    COUNTERS,
    NEG_INF,
    merge_partials_plain,
    page_walk_partial,
    page_walk_plain,
)
from production_stack_tpu_torch.ops.prefill_attention_cuda import (
    paged_prefill_attention,
    paged_prefill_attention_plain,
)
from production_stack_tpu_torch.ops.quant_kv import QuantKV
from production_stack_tpu_torch.ops.ragged_attention_cuda import (
    paged_ragged_attention,
    paged_ragged_attention_plain,
)
from tests.test_torch_ragged_attention import CASES as RAGGED_CASES
from tests.test_torch_ragged_attention import _live, _setup

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)
BF16_P_TOL = dict(rtol=2e-2, atol=2e-2)
PAGE_SIZE = 16
MAX_PAGES = 64  # a 1024-token table: 8 chunks of 128
LAYERS, LAYER = 3, 1


def _t(x):
    return torch.from_numpy(np.array(x))


def _j(x):
    return jnp.asarray(np.asarray(x))


def _bf16_valued(x):
    """f32 values that bf16 holds exactly."""
    return _t(x.astype(np.float32)).to(torch.bfloat16).float().numpy()


def _decode_case(seed, cache, stacked):
    """Rows over a 1024-token table: a one-token row, a pad row, a row
    shorter than the first split of every S > 1 tried (37 < 128), rows
    ending on chunk edges (128, 512), one past (129), a full row.
    Returns the JAX and the port operands."""
    rng = np.random.RandomState(seed)
    kv_lens = np.array([1, 0, 37, 128, 129, 512, 1024, 700], np.int32)
    b, kv_heads, q_heads, d = len(kv_lens), 2, 8, 32
    table = np.zeros((b, MAX_PAGES), np.int32)
    nxt = 1
    for i, n in enumerate(kv_lens):
        for j in range(-(-int(n) // PAGE_SIZE)):
            table[i, j] = nxt
            nxt += 1
    lead = (LAYERS,) if stacked else ()
    shape = lead + (kv_heads, nxt + 1, d, PAGE_SIZE)
    q = _bf16_valued(rng.randn(b, q_heads, d))
    k, v = (_bf16_valued(rng.randn(*shape)) for _ in range(2))
    if cache == "int8":
        def quant(x):
            q8, scale = jax_quantize_kv(jnp.swapaxes(_j(x), -1, -2))
            return np.asarray(jnp.swapaxes(q8, -1, -2)), np.asarray(scale)
        (kd, ks), (vd, vs) = quant(k), quant(v)
        jk, jv = JaxQuantKV(_j(kd), _j(ks)), JaxQuantKV(_j(vd), _j(vs))
        tk, tv = QuantKV(_t(kd), _t(ks)), QuantKV(_t(vd), _t(vs))
    else:
        jk, jv, tk, tv = _j(k), _j(v), _t(k), _t(v)
    return dict(kv_lens=kv_lens, jax=(_j(q), jk, jv, _j(table), _j(kv_lens)),
                port=(_t(q), tk, tv, _t(table), _t(kv_lens)))


# ---- (a) the split decode walk ----------------------------------------------


@pytest.mark.parametrize("num_splits", [1, 2, 3, 8])
@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("cache", ["bf16_valued", "int8"])
def test_split_decode_plain_matches_pallas_and_xla(cache, stacked,
                                                   num_splits):
    c = _decode_case(3, cache, stacked)
    layer = LAYER if stacked else None
    got = paged_decode_attention_plain(*c["port"], layer=layer,
                                       num_splits=num_splits).numpy()
    jq, jk, jv, jtable, jlens = c["jax"]
    pallas = jax_paged_decode_attention(jq, jk, jv, jtable, jlens,
                                        layer=layer, interpret=True)
    pallas = np.asarray(pallas[0] if stacked else pallas)
    np.testing.assert_allclose(got, pallas, **TOL)
    pad = c["kv_lens"] == 0
    assert not got[pad].any()  # exact 0, and so no NaN
    assert np.isfinite(got).all()
    xla = np.asarray(jax_paged_attention(
        jq[:, None], jk, jv, jtable,
        _j(np.maximum(c["kv_lens"] - 1, 0)[:, None]), jlens,
        **({"layer": layer} if stacked else {})))[:, 0]
    np.testing.assert_allclose(got[~pad], xla[~pad], **TOL)


@pytest.mark.parametrize("num_splits", [2, 3, 8])
def test_split_decode_plain_agrees_with_the_single_walk(num_splits):
    c = _decode_case(4, "bf16_valued", False)
    one = paged_decode_attention_plain(*c["port"])
    split = paged_decode_attention_plain(*c["port"], num_splits=num_splits)
    torch.testing.assert_close(split, one, **TOL)


def test_one_split_is_the_unsplit_walk_bit_for_bit():
    c = _decode_case(5, "int8", False)
    q, k, v, table, lens = c["port"]
    default = paged_decode_attention_plain(q, k, v, table, lens)
    qg = q.reshape(q.shape[0], 2, 4, q.shape[-1])
    kv = lens.long()[:, None, None, None]
    walk = page_walk_plain(qg, k.data, v.data, table, lens,
                           lambda pos: pos < kv, k.scale, v.scale)
    assert torch.equal(default, walk.reshape(q.shape))


def test_empty_splits_merge_to_exact_zero_without_nan():
    """A split past its row's kv_len keeps the empty state (-1e30, 0,
    0); a row whose every split is empty merges to exact 0."""
    c = _decode_case(6, "bf16_valued", False)
    q, k, v, table, lens = c["port"]
    qg = q.reshape(q.shape[0], 2, 4, q.shape[-1])
    kv = lens.long()[:, None, None, None]
    # Chunks [1, 2) hold tokens 128..255: rows of kv_len <= 128 have none.
    m, l, acc = page_walk_partial(qg, k, v, table, lens,
                                  lambda pos: pos < kv, chunk_range=(1, 2))
    short = c["kv_lens"] <= CHUNK_TOKENS
    assert (m[short] == NEG_INF).all()
    assert not l[short].any() and not acc[short].any()
    assert (l[~short] > 0).all()
    s = 5
    empty = merge_partials_plain(torch.full((s, 3, 1), NEG_INF),
                                 torch.zeros(s, 3, 1), torch.zeros(s, 3, 4))
    assert not empty.any() and torch.isfinite(empty).all()
    # One live split among empty ones gives that split's own softmax.
    m1 = torch.full((s, 1, 1), NEG_INF)
    l1, acc1 = torch.zeros(s, 1, 1), torch.zeros(s, 1, 4)
    m1[2], l1[2], acc1[2] = 0.5, 2.0, torch.tensor([[2.0, 4.0, 6.0, 8.0]])
    torch.testing.assert_close(merge_partials_plain(m1, l1, acc1),
                               torch.tensor([[1.0, 2.0, 3.0, 4.0]]))


# ---- (b) the split picker -----------------------------------------------------


@pytest.mark.parametrize("batch", [1, 2, 4, 8, 32, 64, 256])
@pytest.mark.parametrize("max_pages,page_size",
                         [(8, 128), (32, 128), (64, 16), (10, 16), (1, 128),
                          (3, 64)])
def test_decode_splits_cover_every_chunk_once(batch, max_pages, page_size):
    kv_heads = 8
    splits, per = decode_splits(batch, kv_heads, max_pages, page_size)
    chunks = max(1, -(-max_pages * page_size // CHUNK_TOKENS))
    assert 1 <= splits <= chunks and per >= 1
    covered = [c for s in range(splits)
               for c in range(s * per, min((s + 1) * per, chunks))]
    assert covered == list(range(chunks))  # each once, in order
    assert (splits - 1) * per < chunks  # no split is empty by shape
    # No more blocks than aimed for, unless one split already is.
    assert splits == 1 or batch * kv_heads * (splits - 1) < TARGET_BLOCKS


def test_decode_splits_is_a_function_of_shapes_only():
    """The async step and the burst keep kv_lens on the card: the split
    may not depend on a tensor."""
    params = inspect.signature(decode_splits).parameters
    assert list(params) == ["batch", "num_kv_heads", "max_pages",
                            "page_size"]
    assert all(p.annotation in (int, "int") for p in params.values())
    assert decode_splits(32, 8, 8, 128) == decode_splits(32, 8, 8, 128)
    # A small batch over a long table splits; a large batch does not.
    assert decode_splits(1, 8, 32, 128)[0] > 1
    assert decode_splits(256, 8, 8, 128) == (1, 8)


@pytest.mark.parametrize("bad", [0, 9, -1])
def test_split_outside_the_table_is_refused(bad):
    c = _decode_case(7, "bf16_valued", False)
    with pytest.raises(ValueError, match="num_splits"):
        paged_decode_attention_plain(*c["port"], num_splits=bad)


# ---- (c) the prefill and ragged walks with the tensor-core rounding ---------


def _prefill_case(seed, first_chunk):
    rng = np.random.RandomState(seed)
    chunk, kv_heads, q_heads, d = 24, 2, 8, 64
    lengths = np.array([chunk, chunk - 7, 0, 1], np.int32)
    starts = (np.zeros(4, np.int32) if first_chunk else
              np.array([140, 37, 0, 128], np.int32))
    kv_lens = np.where(lengths > 0, starts + lengths, 0).astype(np.int32)
    positions = np.zeros((4, chunk), np.int32)
    for i in range(4):
        if lengths[i]:
            positions[i] = starts[i] + np.arange(chunk)
    table = np.zeros((4, 192 // PAGE_SIZE), np.int32)
    nxt = 1
    for i, n in enumerate(kv_lens):
        for j in range(-(-int(n) // PAGE_SIZE)):
            table[i, j] = nxt
            nxt += 1
    q = rng.randn(4, chunk, q_heads, d).astype(np.float32)
    k, v = (rng.randn(kv_heads, nxt + 1, d, PAGE_SIZE).astype(np.float32)
            for _ in range(2))
    return q, k, v, table, positions, kv_lens


@pytest.mark.parametrize("first_chunk", [True, False])
def test_prefill_plain_bf16_probabilities_match_pallas(first_chunk):
    args = _prefill_case(8, first_chunk)
    expected = np.asarray(jax_paged_prefill_attention(
        *(_j(x) for x in args), interpret=True))
    targs = [_t(x) for x in args]
    got = paged_prefill_attention_plain(*targs, p_dtype=torch.bfloat16)
    np.testing.assert_allclose(got.numpy(), expected, **BF16_P_TOL)
    assert not got[args[-1] == 0].any()
    # The rounding is really applied: the f32 walk differs in some bit.
    assert not torch.equal(got, paged_prefill_attention_plain(*targs))


@pytest.mark.parametrize("first_chunk", [True, False])
def test_prefill_plain_default_is_the_f32_walk_bit_for_bit(first_chunk):
    q, k, v, table, pos, lens = (
        _t(x) for x in _prefill_case(9, first_chunk))
    default = paged_prefill_attention_plain(q, k, v, table, pos, lens)
    b, t, nh, d = q.shape
    qg = (q.reshape(b, t, 2, 4, d).permute(0, 2, 3, 1, 4)
          .reshape(b, 2, 4 * t, d))
    rows = torch.arange(4 * t)
    q_pos = (pos[:, :1].long() + (rows % t)[None, :])[:, None, :, None]
    kv = lens.long()[:, None, None, None]
    walk = page_walk_plain(qg, k, v, table, lens,
                           lambda p: (p <= q_pos) & (p < kv))
    walk = (walk.reshape(b, 2, 4, t, d).permute(0, 3, 1, 2, 4)
            .reshape(b, t, nh, d))
    assert torch.equal(default, walk)
    expected = np.asarray(jax_paged_prefill_attention(
        _j(q), _j(k), _j(v), _j(table), _j(pos), _j(lens), interpret=True))
    np.testing.assert_allclose(default.numpy(), expected, **TOL)


@pytest.mark.parametrize("name", sorted(RAGGED_CASES))
def test_ragged_plain_bf16_probabilities_match_pallas(name):
    q, k, v, pt, kv, li, dl, _ = _setup(**RAGGED_CASES[name])
    # The Pallas kernel takes a pad row's last_index as given; clamp the
    # engine's -1 to its 0 (both describe no live slot).
    expected = np.asarray(jax_paged_ragged_attention(
        _j(q), _j(k), _j(v), _j(pt), _j(kv), _j(np.maximum(li, 0)),
        None if dl is None else _j(dl), interpret=True))
    targs = [None if x is None else _t(x) for x in (q, k, v, pt, kv, li, dl)]
    got = paged_ragged_attention_plain(*targs, p_dtype=torch.bfloat16)
    np.testing.assert_allclose(got.numpy(), expected, **BF16_P_TOL)
    dead = ~_live(kv, li, q.shape[1])
    assert not got.numpy()[dead].any()  # dead slots and pad rows: exact 0
    # The rounding is really applied: the f32 walk differs in some bit.
    assert not torch.equal(got, paged_ragged_attention_plain(*targs))


@pytest.mark.parametrize("name", sorted(RAGGED_CASES))
def test_ragged_plain_default_is_the_f32_walk_bit_for_bit(name):
    q, k, v, pt, kv, li, dl, _ = (
        None if x is None else _t(x) for x in _setup(**RAGGED_CASES[name]))
    default = paged_ragged_attention_plain(q, k, v, pt, kv, li, dl)
    assert torch.equal(default, paged_ragged_attention_plain(
        q, k, v, pt, kv, li, dl, p_dtype=None))
    # The walk written out: slot-major rows (t, g), q at q_start + t.
    r, w, nh, d = q.shape
    kvh = k.shape[0]
    g = nh // kvh
    qg = (q.reshape(r, w, kvh, g, d).permute(0, 2, 1, 3, 4)
          .reshape(r, kvh, w * g, d))
    slot = (torch.arange(w * g) // g)[None, None, :, None]
    lens = kv.long()[:, None, None, None]
    last = li.long()[:, None, None, None]
    live = (slot <= last) & (lens > 0)
    q_pos = lens - 1 - last + slot
    walk = page_walk_plain(qg, k, v, pt, kv,
                           lambda pos: live & (pos <= q_pos) & (pos < lens))
    walk = torch.where(live, walk, 0.0)
    walk = (walk.reshape(r, kvh, w, g, d).permute(0, 2, 1, 3, 4)
            .reshape(r, w, nh, d))
    assert torch.equal(default, walk)


# ---- (d) the model's plain_bf16p attention ------------------------------


def _dispatch_case(kind, dtype):
    """The mixed ragged case in ``dtype`` as dispatch_attention takes
    it: [R, W] positions at q_start + t (one slot for decode)."""
    q, k, v, pt, kv, _, _, pos = _setup(**RAGGED_CASES["mixed_rows_and_pads"])
    if kind == "decode":
        q, pos = q[:, :1], pos[:, :1]
    return [_t(x).to(dtype) if x.dtype == np.float32 else _t(x)
            for x in (q, k, v, pt, pos, kv)]


@pytest.mark.parametrize("kind", ["decode", "prefill", "ragged"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_plain_bf16p_rounds_only_where_the_card_does(kind, dtype):
    from production_stack_tpu_torch.models.llama import (
        ATTENTION_IMPLS,
        dispatch_attention,
    )
    assert ATTENTION_IMPLS == ("cuda", "plain", "plain_bf16p")
    q, k, v, pt, pos, kv = _dispatch_case(kind, dtype)
    call = lambda impl: dispatch_attention(  # noqa: E731
        None, q, k, v, pt, pos, kv, kind=kind, impl=impl)
    rounded, plain = call("plain_bf16p"), call("plain")
    if dtype == torch.bfloat16 and kind != "decode":
        # The prefill and ragged walks feed bf16 probabilities to p . v.
        assert not torch.equal(rounded, plain)
        torch.testing.assert_close(rounded.float(), plain.float(),
                                   **BF16_P_TOL)
    else:
        # Decode's split walk and every f32 walk stay in f32 on the card.
        assert torch.equal(rounded, plain)


# ---- (e) the CPU wrappers ----------------------------------------------


def test_cpu_wrappers_still_take_the_plain_versions():
    COUNTERS.reset()
    c = _decode_case(10, "int8", True)
    assert torch.equal(
        paged_decode_attention(*c["port"], layer=LAYER),
        paged_decode_attention_plain(*c["port"], layer=LAYER))
    assert torch.equal(
        paged_decode_attention(*c["port"], layer=LAYER, num_splits=3),
        paged_decode_attention_plain(*c["port"], layer=LAYER, num_splits=3))
    targs = [_t(x) for x in _prefill_case(10, False)]
    assert torch.equal(paged_prefill_attention(*targs),
                       paged_prefill_attention_plain(*targs))
    rargs = [None if x is None else _t(x)
             for x in _setup(**RAGGED_CASES["verify_spans"])[:7]]
    assert torch.equal(paged_ragged_attention(*rargs),
                       paged_ragged_attention_plain(*rargs))
    assert COUNTERS.launches == {}
    assert COUNTERS.plain_cuda_calls == {}
