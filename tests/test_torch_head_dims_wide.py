"""The port at every head_dim above 256, against the JAX package.

Above the widest tile (256) the kernels run a head_dim as n =
ceil(head_dim / 128) slabs of the tile 128 (``kernel_head_dim_slabs``;
csrc/paged_kv_common.cuh's slab design): a block owns one output slab,
sums the scores q . k^T over every slab in slab order, runs one online
softmax with the real 1 / sqrt(head_dim), and takes p . v from its own
V slab; the last slab is padded in the kernel. (The prefill kernel's
16-bit forms run head dims up to 512 on the wide form of its wgmma walk
instead: tests/test_torch_prefill_wgmma.py.) On the CPU the wrappers
take their plain versions, which sum the scores in the same slab order
(``slab_scores``); the CUDA kernels are held against those plain
versions on the card (``chip_smoke.py``'s geometries phase,
``tests/test_torch_cuda_kernels.py``).

Inputs are made with numpy from a seed and go through both packages.
The JAX Pallas kernels run in interpret mode at these widths on the
CPU, as the JAX package's own tests run them (they pad head_dim to
their 128-lane tile: 288 to 384, 576 to 640); the burst-tail form and
one prefill case a point are held to its XLA reference
(``ops/attention.paged_attention``), which no Pallas kernel serves.

Covered: the three plain page walks (decode, prefill, ragged) per
layer, stacked and over an int8 cache, and the decode kernel's
burst-tail form, at head_dim 288, 320, 512 and 576, query groups 1 and
3, f32, bf16 and f16, pages 8 and 128; the slab rule over head dims 0
to 1100 with a stub of the library's answer read from the
instantiation list; the decode scratch by the slab; ``models/convert``
carrying an explicit head_dim; greedy streams of the port's engine
(f32) byte-identical to the JAX engine's for a tiny llama at head_dim
320 and at an explicit head_dim 512.

Tolerances: f32 outputs at atol = rtol = 1e-4 (the same f32
arithmetic, sums in another order: the port walks 128-token chunks and
128-wide slabs, the Pallas kernels a few pages at a time over the
padded head_dim, the XLA reference one softmax); bf16 and f16 outputs
at atol = rtol = 2e-2, compared in f32 (the inputs carry the type's
rounding; each side rounds its output once).
"""

import re
from pathlib import Path

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
from production_stack_tpu.models import registry as jax_registry
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
from production_stack_tpu_torch.engine import config
from production_stack_tpu_torch.engine.engine import LLMEngine
from production_stack_tpu_torch.engine.sequence import SamplingParams
from production_stack_tpu_torch.models.convert import (
    params_from_numpy,
    params_to_numpy,
)
from production_stack_tpu_torch.ops import paged_kv_common
from production_stack_tpu_torch.ops.paged_attention_cuda import (
    _partials,
    decode_group_tile,
    paged_decode_attention,
    paged_decode_attention_plain,
    paged_decode_tail_attention,
    paged_decode_tail_attention_plain,
)
from production_stack_tpu_torch.ops.paged_kv_common import (
    KERNEL_HEAD_DIM_TILES,
    SLAB_HEAD_DIM,
    check_kernel_shapes,
    kernel_geometry_refusal,
    kernel_head_dim_slabs,
    kernel_head_dim_tile,
    slab_scores,
)
from production_stack_tpu_torch.ops.prefill_attention_cuda import (
    WG_WIDE_WIDTHS,
    paged_prefill_attention_plain,
)
from production_stack_tpu_torch.ops.ragged_attention_cuda import (
    paged_ragged_attention_plain,
)
from tests.test_torch_head_dims import (
    DTYPES,
    KV_HEADS,
    _caches,
    _close,
    _engine_config,
    _first,
    _i,
    _j,
    _layer,
    _model,
    _t,
    _table,
)

torch.set_num_threads(2)

# (head_dim, query group, dtype, page size, form): each head dim in all
# three dtypes and all three forms, at both groups and both pages; 288
# and 320 pad their third slab, 512 is four whole slabs, 576 pads a
# fifth.
POINTS = [(288, 1, "f32", 8, "plain"), (288, 3, "bf16", 128, "stacked"),
          (288, 1, "f16", 128, "int8"),
          (320, 3, "f16", 8, "plain"), (320, 1, "f32", 128, "stacked"),
          (320, 3, "bf16", 8, "int8"),
          (512, 1, "bf16", 128, "plain"), (512, 3, "f16", 8, "stacked"),
          (512, 1, "f32", 8, "int8"),
          (576, 3, "bf16", 8, "plain"), (576, 1, "f16", 128, "stacked"),
          (576, 3, "f32", 128, "int8")]
IDS = [f"d{d}-g{g}-{t}-ps{ps}-{f}" for d, g, t, ps, f in POINTS]


# ---- the plain page walks against the Pallas kernels and XLA -------------


@pytest.mark.parametrize("d,group,dtype,page,form", POINTS, ids=IDS)
def test_decode_plain_matches_pallas_interpret(d, group, dtype, page, form):
    """Rows past one and two 128-token chunks, a one-token row and a
    pad row; a pad row writes exact 0. The split walk (partials one
    slab wide) computes the same function."""
    rng = np.random.RandomState(d * 10 + group)
    kv_lens = np.array([130, 0, 1, 260], np.int32)
    table, pages = _table(kv_lens, page, -(-260 // page) + 1)
    jk, jv, tk, tv = _caches(rng, pages, d, page, form, dtype)
    q = rng.randn(4, KV_HEADS * group, d)
    expected = _first(jax_paged_decode_attention(
        _j(q, dtype), jk, jv, jnp.asarray(table), jnp.asarray(kv_lens),
        interpret=True, **_layer(form)))
    got = paged_decode_attention_plain(_t(q, dtype), tk, tv, _i(table),
                                       _i(kv_lens), **_layer(form))
    assert got.dtype == DTYPES[dtype][0] and got.shape == q.shape
    _close(got, expected, dtype)
    assert not got[1].any()
    split = paged_decode_attention_plain(_t(q, dtype), tk, tv, _i(table),
                                         _i(kv_lens), num_splits=3,
                                         **_layer(form))
    _close(split, expected, dtype)
    assert torch.equal(paged_decode_attention(
        _t(q, dtype), tk, tv, _i(table), _i(kv_lens), **_layer(form)), got)


@pytest.mark.parametrize("d,group,dtype,page,form", POINTS, ids=IDS)
def test_prefill_plain_matches_pallas_interpret(d, group, dtype, page,
                                                form):
    """A chunk past the 128-token edge, a shorter chunk (pad slots at
    its tail) and a pad row."""
    rng = np.random.RandomState(d * 10 + group + 1)
    chunk = 16
    lengths = np.array([chunk, chunk - 5, 0], np.int32)
    starts = np.array([120, 37, 0], np.int32)
    kv_lens = np.where(lengths > 0, starts + lengths, 0).astype(np.int32)
    positions = np.zeros((3, chunk), np.int32)
    for i in range(3):
        if lengths[i]:
            positions[i] = starts[i] + np.arange(chunk)
    table, pages = _table(kv_lens, page, -(-136 // page) + 1)
    jk, jv, tk, tv = _caches(rng, pages, d, page, form, dtype)
    q = rng.randn(3, chunk, KV_HEADS * group, d)
    expected = _first(jax_paged_prefill_attention(
        _j(q, dtype), jk, jv, jnp.asarray(table), jnp.asarray(positions),
        jnp.asarray(kv_lens), interpret=True, **_layer(form)))
    got = paged_prefill_attention_plain(_t(q, dtype), tk, tv, _i(table),
                                        _i(positions), _i(kv_lens),
                                        **_layer(form))
    _close(got, expected, dtype)
    assert not got[2].any()
    # The XLA reference (one softmax over the gathered pages) on the
    # live slots of the first row, whose chunk is whole.
    xla = _first(jax_paged_attention(
        _j(q[:1], dtype), jk, jv, jnp.asarray(table[:1]),
        jnp.asarray(positions[:1]), jnp.asarray(kv_lens[:1]),
        **_layer(form)))
    _close(got[:1], xla, dtype)


@pytest.mark.parametrize("d,group,dtype,page,form", POINTS, ids=IDS)
def test_ragged_plain_matches_pallas_interpret(d, group, dtype, page, form):
    """A decode row, a verify row, a chunk row past the 128-token edge
    and a pad row; dead slots and the pad row are exact 0. The port's
    plain version with the tensor-core walk's rounding for 16-bit
    queries (``p_dtype``), as the card's kernel rounds."""
    rng = np.random.RandomState(d * 10 + group + 2)
    w = 5
    kv_lens = np.array([40, 23, 140, 0], np.int32)
    last_index = np.array([0, 3, 4, -1], np.int32)
    table, pages = _table(kv_lens, page, -(-140 // page) + 1)
    jk, jv, tk, tv = _caches(rng, pages, d, page, form, dtype)
    q = rng.randn(4, w, KV_HEADS * group, d)
    expected = _first(jax_paged_ragged_attention(
        _j(q, dtype), jk, jv, jnp.asarray(table), jnp.asarray(kv_lens),
        jnp.asarray(np.maximum(last_index, 0)), interpret=True,
        **_layer(form)))
    p16 = {} if dtype == "f32" else {"p_dtype": DTYPES[dtype][0]}
    got = paged_ragged_attention_plain(_t(q, dtype), tk, tv, _i(table),
                                       _i(kv_lens), _i(last_index),
                                       **_layer(form), **p16)
    _close(got, expected, dtype)
    live = ((np.arange(w)[None] <= last_index[:, None])
            & (kv_lens[:, None] > 0))
    assert not got[torch.from_numpy(~live)].any()


@pytest.mark.parametrize("d,group,dtype,page,form", POINTS, ids=IDS)
def test_decode_tail_plain_matches_xla(d, group, dtype, page, form):
    """The decode kernel's burst-tail form (the page walk in splits,
    the tail as one more, its scores summed slab by slab) against JAX's
    tailed XLA attention at T = 1 (no Pallas kernel serves the tail):
    rows attending 1 to 4 tail slots, a pad row attending its tail
    alone."""
    rng = np.random.RandomState(d * 10 + group + 4)
    s_len = 4
    kv_lens = np.array([13, 0, 150], np.int32)
    live = np.array([1, 3, 4], np.int32)
    q_pos = (kv_lens + live - 1).astype(np.int32)
    table, pages = _table(kv_lens, page, -(-150 // page) + 1)
    jk, jv, tk, tv = _caches(rng, pages, d, page, form, dtype)
    q = rng.randn(3, KV_HEADS * group, d)
    kt = rng.randn(3, s_len, KV_HEADS, d)
    vt = rng.randn(3, s_len, KV_HEADS, d)
    expected = jax_paged_attention(
        _j(q[:, None], dtype), jk, jv, jnp.asarray(table),
        jnp.asarray(q_pos[:, None]), jnp.asarray(kv_lens),
        k_tail=_j(kt, dtype), v_tail=_j(vt, dtype), **_layer(form))[:, 0]
    args = (_t(q, dtype), tk, tv, _i(table), _i(kv_lens), _t(kt, dtype),
            _t(vt, dtype), _i(q_pos))
    for splits in (1, 2):
        got = paged_decode_tail_attention_plain(*args, num_splits=splits,
                                                **_layer(form))
        _close(got, expected, dtype)
    assert torch.equal(paged_decode_tail_attention(*args, **_layer(form)),
                       paged_decode_tail_attention_plain(*args,
                                                         **_layer(form)))


def test_slab_scores_sum_the_slabs_in_order():
    """Above 256 the plain walks' scores are the slabs' products summed
    in slab order, as the kernels sum them; up to 256 one product."""
    rng = np.random.RandomState(3)
    for d in (100, 256, 257, 512, 1000):
        q = torch.from_numpy(rng.randn(2, 5, d).astype(np.float32))
        k = torch.from_numpy(rng.randn(2, d, 7).astype(np.float32))
        n, width = kernel_head_dim_slabs(d)
        want = q @ k if n == 1 else sum(
            q[..., j * width:(j + 1) * width]
            @ k[..., j * width:(j + 1) * width, :] for j in range(n))
        assert torch.equal(slab_scores(q, k), want)
        torch.testing.assert_close(slab_scores(q, k), q @ k, rtol=1e-5,
                                   atol=1e-4)


# ---- the slab rule and the library's answer -------------------------------


class _StubKernelLib:
    """The library's answer as its instantiation list reads
    (csrc/paged_kv_common.cuh): the (dtype code, cache code) pairs of
    PSTT_FOR_EACH_GEOMETRY, any query group of 1 or more, any head_dim
    up to the widest tile of PSTT_FOR_EACH_HEAD_DIM at the smallest tile
    at or above it, and any wider one as slabs of the slab instance's
    tile (head_dim_tile, head_dim_slabs)."""

    _SRC_DIR = (Path(__file__).resolve().parents[1]
                / "production_stack_tpu_torch" / "csrc")
    _SRC = (_SRC_DIR / "paged_kv_common.cuh").read_text()
    PAIRS = {tuple(map(int, x)) for x in re.findall(
        r"PSTT_FOR_EACH_HEAD_DIM\(X, (\d), [\w ]+, (\d), [\w ]+\)", _SRC)}
    INSTANCES = [(int(d), s == "true") for d, s in re.findall(
        r"X\(code, T, ccode, C, (\d+), (true|false)\)", _SRC)]
    TILES = [d for d, slab in INSTANCES if not slab]
    SLAB = next(d for d, slab in INSTANCES if slab)

    def head_dim_slabs(self, head_dim):
        if head_dim < 1:
            return 0, 0
        tile = next((t for t in self.TILES if head_dim <= t), None)
        if tile is not None:
            return 1, tile
        return -(-head_dim // self.SLAB), self.SLAB

    def pstt_kernel_supports(self, dtype, cache_dtype, group, head_dim):
        return int((dtype, cache_dtype) in self.PAIRS and group >= 1
                   and self.head_dim_slabs(head_dim)[0] > 0)

    def pstt_page_size_supported(self, page_size):
        return int(page_size >= 1)


def test_instances_are_the_tiles_and_one_slab():
    assert _StubKernelLib.TILES == list(KERNEL_HEAD_DIM_TILES)
    assert _StubKernelLib.SLAB == SLAB_HEAD_DIM == 128
    assert len(_StubKernelLib.INSTANCES) == len(KERNEL_HEAD_DIM_TILES) + 1
    # The prefill kernel's 16-bit sources add the wgmma walk's wide form
    # at its widths (csrc/paged_walk_wgmma.cuh PSTT_FOR_EACH_WG_WIDTH),
    # over a cache of the query's type and int8, ahead of the slab
    # instance, which keeps the head dims above the widest; the f32
    # source and the decode kernel have none, and the ragged kernel's
    # are in sources of their own (paged_ragged_wgmma_{bf16,f16}.cu).
    csrc = _StubKernelLib._SRC_DIR
    walk = (csrc / "paged_walk_wgmma.cuh").read_text()
    widths = [int(w) for w in re.findall(
        r"^  X\(code, T, ccode, C, (\d+)\)", walk, re.M)]
    assert tuple(widths) == WG_WIDE_WIDTHS == (384, 512)
    assert widths[0] > KERNEL_HEAD_DIM_TILES[-1]
    assert all(w % SLAB_HEAD_DIM == 0 for w in widths)
    prefill = (csrc / "paged_prefill.cuh").read_text()
    for code, t, cache in (("0", "__nv_bfloat16", "__nv_bfloat16"),
                           ("0", "__nv_bfloat16", "int8_t"),
                           ("3", "__half", "__half"),
                           ("3", "__half", "int8_t")):
        ccode = {"__nv_bfloat16": "0", "__half": "3", "int8_t": "2"}[cache]
        assert (f"PSTT_FOR_EACH_WG_WIDTH(X, {code}, {t}, {ccode}, {cache})"
                in prefill)
    for name in ("paged_prefill_f32.cu", "paged_decode_bf16.cu",
                 "paged_ragged_bf16.cu", "paged_decode_slab_bf16.cu"):
        assert "WIDE" not in (csrc / name).read_text(), name


@pytest.mark.parametrize("lo,hi", [(0, 300), (300, 700), (700, 1101)])
def test_every_head_dim_to_1100_against_the_rule_and_the_stub(lo, hi):
    """Every head_dim of 1 or more is served, in every dtype over both
    caches: up to 256 at its tile, above as ceil(d / 128) slabs of 128;
    0 is refused with the rule named. The stub library answers the
    same, slab count and width included."""
    stub = _StubKernelLib()
    codes = {torch.bfloat16: 0, torch.float32: 1, torch.float16: 3,
             torch.int8: 2}
    for d in range(lo, hi):
        slabs = kernel_head_dim_slabs(d)
        if d < 1:
            assert slabs is None and kernel_head_dim_tile(d) is None
            assert stub.head_dim_slabs(d) == (0, 0)
        else:
            assert slabs == stub.head_dim_slabs(d)
            assert kernel_head_dim_tile(d) == slabs[1]
            n, width = slabs
            assert (n == 1) == (d <= 256)
            assert n * width >= d > (n - 1) * width or n == 1
        for dtype in (torch.bfloat16, torch.float16, torch.float32):
            for cache in (dtype, torch.int8):
                rule = kernel_geometry_refusal(dtype, cache, 3, d)
                assert (rule is None) == (d >= 1), (d, rule)
                if rule is not None:
                    assert "every head_dim of 1 or more" in rule
                    assert f"not {d}" in rule
                assert bool(stub.pstt_kernel_supports(
                    codes[dtype], codes[cache], 3, d)) == (rule is None)


@pytest.mark.parametrize("d,slabs", [(257, 3), (288, 3), (320, 3),
                                     (384, 3), (448, 4), (512, 4),
                                     (576, 5), (640, 5), (1024, 8)])
def test_wide_head_dims_pass_the_gate_with_slab_scratch(monkeypatch, d,
                                                        slabs):
    """The start-up check passes with the stub library (the card's
    answer) in every dtype over both caches; the decode kernel's group
    tile is the tile 128's and its scratch one slab wide, slab-major
    within a group tile."""
    monkeypatch.setattr(paged_kv_common, "kernel_lib", _StubKernelLib)
    assert kernel_head_dim_slabs(d) == (slabs, 128)
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        for cache in (dtype, torch.int8):
            check_kernel_shapes(6, 2, d, 16, dtype, cache)
    assert decode_group_tile(3, d) == 4 and decode_group_tile(8, d) == 4
    assert tuple(_partials(torch.zeros(2, 6, d), 2, 3).shape) == (
        2, 2 * slabs, 3, 4, 130)
    assert tuple(_partials(torch.zeros(2, 16, d), 2, 2).shape) == (
        2, 2 * 2 * slabs, 2, 4, 130)


# ---- weights and greedy streams against the JAX engine --------------------

# (label, q heads, kv heads, head_dim, hidden): a llama at head_dim 320
# (hidden / heads) and one at an explicit head_dim 512 wider than
# hidden / heads (a config.json naming its head_dim, as Falcon3's do).
ENGINES = [("llama-g1-d320", 2, 2, 320, 640),
           ("llama-g3-d512-explicit", 3, 1, 512, 96)]


@pytest.mark.parametrize("label,nh,nkv,d,hidden", ENGINES,
                         ids=[e[0] for e in ENGINES])
def test_greedy_streams_match_jax(label, nh, nkv, d, hidden):
    """f32 greedy streams byte-identical to the JAX engine's, the
    weights of its own initialisation carried across by
    ``models/convert.py`` with no new conversion: the attention
    projections keep the explicit head_dim's widths, bitwise."""
    jax_model = _model(jax_config.ModelConfig, nh, nkv, d, hidden)
    port_model = _model(config.ModelConfig, nh, nkv, d, hidden)
    assert jax_model.head_dim == port_model.head_dim == d
    init, _ = jax_registry.get_model(jax_model)
    weights = {k: np.asarray(v, np.float32) for k, v in init(
        jax_model, jax.random.PRNGKey(21)).items()}
    params = params_from_numpy(weights, port_model, "cpu")
    back = params_to_numpy(params, port_model)
    layers = jax_model.num_hidden_layers
    for name, width in (("wq", nh * d), ("wk", nkv * d), ("wv", nkv * d)):
        assert weights[name].shape == (layers, hidden, width)
        assert np.array_equal(back[name], weights[name]), name
    assert weights["wo"].shape == (layers, nh * d, hidden)
    assert np.array_equal(back["wo"], weights["wo"])
    ref_engine = JaxEngine(_engine_config(jax_config, jax_model),
                           params={k: jnp.asarray(v)
                                   for k, v in weights.items()})
    port = LLMEngine(_engine_config(config, port_model), params=params,
                     device="cpu")
    rng = np.random.RandomState(11)
    prompts = [rng.randint(1, 500, size=n).tolist() for n in (5, 17, 40, 70)]
    sp = dict(temperature=0.0, max_tokens=12, ignore_eos=True)
    ref = [list(s.output_token_ids) for s in ref_engine.generate_batch(
        prompts, JaxSamplingParams(**sp))]
    got = [list(s.output_token_ids) for s in port.generate_batch(
        prompts, SamplingParams(**sp))]
    assert got == ref, label
