"""The port at every head_dim up to 256, against the JAX package.

The kernels are built for the head-dim tiles 32, 64, 80, 128 and 256;
any other head_dim from 1 to 256 runs at the smallest tile at or above
it, padded inside the kernel (``kernel_head_dim_tile``), as the Pallas
kernels pad head_dim to their 128-lane tile. On the CPU the wrappers
take their plain versions, which walk the real head_dim; the CUDA
kernels are held against those plain versions on the card
(``chip_smoke.py``'s geometries phase, ``tests/test_torch_cuda_kernels.py``).

Inputs are made with numpy from a seed and go through both packages.
The JAX Pallas kernels run in interpret mode, as the JAX package's own
tests run them on the CPU, and its XLA reference beside them.

Covered: the three plain page walks (decode, prefill, ragged) per
layer, stacked and over an int8 cache, and the decode kernel's
burst-tail form, at head_dim 96, 100, 160 and 256, query groups 1 and
3, f32, bf16 and f16, pages 8 and 128; the tile and refusal rule over
head dims 0 to 1100 (above 256 the slabs of tests/test_torch_head_dims_wide.py)
and over published configurations, with a stub of the library's
answer read from the instantiation list; greedy streams
of the port's engine (f32) byte-identical to the JAX engine's for a
tiny llama at head_dim 100 and at an explicit head_dim 256.

Tolerances: f32 outputs at atol = rtol = 1e-4 (the same f32 arithmetic,
sums in another order: the port walks 128-token chunks, the Pallas
kernels a few pages at a time, the XLA reference one softmax); bf16 and
f16 outputs at atol = rtol = 2e-2, compared in f32 (the inputs carry
the type's rounding; each side rounds its output once).
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
from production_stack_tpu.ops.quant_kv import QuantKV as JaxQuantKV
from production_stack_tpu.ops.quant_kv import quantize_kv as jax_quantize_kv
from production_stack_tpu.ops.ragged_attention_pallas import (
    paged_ragged_attention as jax_paged_ragged_attention,
)
from production_stack_tpu_torch.engine import config
from production_stack_tpu_torch.engine.engine import LLMEngine
from production_stack_tpu_torch.engine.sequence import SamplingParams
from production_stack_tpu_torch.models.convert import params_from_numpy
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
    check_kernel_shapes,
    kernel_geometry_refusal,
    kernel_geometry_supported,
    kernel_head_dim_slabs,
    kernel_head_dim_tile,
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
HALF_TOL = dict(rtol=2e-2, atol=2e-2)
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16),
          "f16": (torch.float16, jnp.float16)}
KV_HEADS = 2
# (head_dim, query group, dtype, page size, form): each head dim in all
# three dtypes and all three forms, at both groups and both pages.
POINTS = [(96, 1, "f32", 8, "plain"), (96, 3, "bf16", 128, "stacked"),
          (96, 1, "f16", 128, "int8"),
          (100, 3, "f16", 8, "plain"), (100, 1, "f32", 128, "stacked"),
          (100, 3, "bf16", 8, "int8"),
          (160, 1, "bf16", 128, "plain"), (160, 3, "f16", 8, "stacked"),
          (160, 1, "f32", 8, "int8"),
          (256, 3, "bf16", 8, "plain"), (256, 1, "f16", 128, "stacked"),
          (256, 3, "f32", 128, "int8")]
IDS = [f"d{d}-g{g}-{t}-ps{ps}-{f}" for d, g, t, ps, f in POINTS]


def _j(x, dtype="f32"):
    """numpy f32 -> a JAX array in ``dtype`` (the same rounding to
    nearest even as torch's)."""
    return jnp.asarray(np.asarray(x, np.float32)).astype(DTYPES[dtype][1])


def _t(x, dtype="f32"):
    return torch.from_numpy(np.asarray(x, np.float32)).to(DTYPES[dtype][0])


def _i(x):
    return torch.from_numpy(np.asarray(x))


def _close(got, expected, dtype):
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(jnp.asarray(expected, jnp.float32)),
        **(F32_TOL if dtype == "f32" else HALF_TOL))


def _table(kv_lens, page, max_pages):
    """Distinct pages per row from page 1 on (page 0 is the trash
    page), in a shuffled order; returns the table and the pages used."""
    rng = np.random.RandomState(int(sum(kv_lens)) + page)
    need = [-(-int(n) // page) for n in kv_lens]
    ids = rng.permutation(sum(need)) + 1
    table = np.zeros((len(kv_lens), max_pages), np.int32)
    used = 0
    for i, n in enumerate(need):
        table[i, :n] = ids[used:used + n]
        used += n
    return table, used + 1


def _caches(rng, pages, d, page, form, dtype):
    """(JAX k, v, port k, v) of the same content: ``form`` "plain" in
    ``dtype``, "int8" quantized per (page, slot, kv head) row, or
    "stacked" as layer 1 of a [2, ...] stack."""
    def one():
        return rng.randn(KV_HEADS, pages, d, page).astype(np.float32)
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
    k, v = one(), one()
    if form == "stacked":
        k = np.stack([one(), k])
        v = np.stack([one(), v])
    return _j(k, dtype), _j(v, dtype), _t(k, dtype), _t(v, dtype)


def _layer(form):
    return {"layer": 1} if form == "stacked" else {}


def _first(out):
    """The JAX stacked form returns (out, k, v)."""
    return out[0] if isinstance(out, tuple) else out


# ---- the plain page walks against the Pallas kernels and XLA -------------


@pytest.mark.parametrize("d,group,dtype,page,form", POINTS, ids=IDS)
def test_decode_plain_matches_pallas_interpret(d, group, dtype, page, form):
    """Rows past one and two 128-token chunks, a one-token row and a
    pad row; a pad row writes exact 0."""
    rng = np.random.RandomState(d * 10 + group)
    kv_lens = np.array([130, 0, 1, 300], np.int32)
    table, pages = _table(kv_lens, page, -(-300 // page) + 1)
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
    # The kernel's split walk (its partials at the head-dim tile's
    # width) computes the same function, and the wrapper takes the
    # plain version for CPU tensors.
    split = paged_decode_attention_plain(_t(q, dtype), tk, tv, _i(table),
                                         _i(kv_lens), num_splits=3,
                                         **_layer(form))
    _close(split, expected, dtype)
    assert torch.equal(paged_decode_attention(
        _t(q, dtype), tk, tv, _i(table), _i(kv_lens), **_layer(form)), got)


@pytest.mark.parametrize("d,group,dtype,page,form", POINTS, ids=IDS)
def test_prefill_plain_matches_pallas_interpret(d, group, dtype, page,
                                                form):
    """A second chunk past the 128-token edge, a shorter chunk (pad
    slots at its tail) and a pad row."""
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


@pytest.mark.parametrize("d,group,dtype,page,form", POINTS, ids=IDS)
def test_ragged_plain_matches_pallas_interpret(d, group, dtype, page, form):
    """A decode row, a verify row, a chunk row past the 128-token edge
    and a pad row; dead slots and the pad row are exact 0. The port's
    plain version with the tensor-core walk's rounding for 16-bit
    queries (``p_dtype``), as the card's kernel rounds."""
    rng = np.random.RandomState(d * 10 + group + 2)
    w = 6
    kv_lens = np.array([40, 23, 140, 0], np.int32)
    last_index = np.array([0, 3, 5, -1], np.int32)
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


@pytest.mark.parametrize("d,group,dtype,page,form", POINTS[::2],
                         ids=IDS[::2])
def test_prefill_plain_matches_xla(d, group, dtype, page, form):
    """The XLA reference (one softmax over the gathered pages) on the
    live slots."""
    rng = np.random.RandomState(d * 10 + group + 3)
    chunk = 12
    kv_lens = np.array([140, 12], np.int32)
    positions = (kv_lens - chunk)[:, None] + np.arange(chunk,
                                                      dtype=np.int32)
    table, pages = _table(kv_lens, page, -(-140 // page) + 1)
    jk, jv, tk, tv = _caches(rng, pages, d, page, form, dtype)
    q = rng.randn(2, chunk, KV_HEADS * group, d)
    expected = _first(jax_paged_attention(
        _j(q, dtype), jk, jv, jnp.asarray(table), jnp.asarray(positions),
        jnp.asarray(kv_lens), **_layer(form)))
    got = paged_prefill_attention_plain(_t(q, dtype), tk, tv, _i(table),
                                        _i(positions), _i(kv_lens),
                                        **_layer(form))
    _close(got, expected, dtype)


@pytest.mark.parametrize("d,group,dtype,page,form", POINTS, ids=IDS)
def test_decode_tail_plain_matches_xla(d, group, dtype, page, form):
    """The decode kernel's burst-tail form (the page walk in splits,
    the tail as one more) against JAX's tailed XLA attention at T = 1:
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


# ---- the tile, the rule and the library's answer --------------------------


class _StubKernelLib:
    """The library's answer as its instantiation list reads
    (csrc/paged_kv_common.cuh): the (dtype code, cache code) pairs of
    PSTT_FOR_EACH_GEOMETRY, any query group of 1 or more, and any
    head_dim of 1 or more: up to the widest tile of
    PSTT_FOR_EACH_HEAD_DIM at the smallest tile at or above it, past it
    at the slab instance's tile (head_dim_tile)."""

    _SRC = (Path(__file__).resolve().parents[1] / "production_stack_tpu_torch"
            / "csrc" / "paged_kv_common.cuh").read_text()
    PAIRS = {tuple(map(int, x)) for x in re.findall(
        r"PSTT_FOR_EACH_HEAD_DIM\(X, (\d), [\w ]+, (\d), [\w ]+\)", _SRC)}
    INSTANCES = re.findall(r"X\(code, T, ccode, C, (\d+), (true|false)\)",
                           _SRC)
    TILES = [int(d) for d, slab in INSTANCES if slab == "false"]
    SLAB = next(int(d) for d, slab in INSTANCES if slab == "true")

    def head_dim_tile(self, head_dim):
        if head_dim < 1:
            return 0
        return next((t for t in self.TILES if head_dim <= t), self.SLAB)

    def pstt_kernel_supports(self, dtype, cache_dtype, group, head_dim):
        return int((dtype, cache_dtype) in self.PAIRS and group >= 1
                   and self.head_dim_tile(head_dim) > 0)

    def pstt_page_size_supported(self, page_size):
        return int(page_size >= 1)


def test_tiles_are_the_instantiation_list():
    assert _StubKernelLib.TILES == list(KERNEL_HEAD_DIM_TILES)
    assert KERNEL_HEAD_DIM_TILES == (32, 64, 80, 128, 256)
    assert list(KERNEL_HEAD_DIM_TILES) == sorted(KERNEL_HEAD_DIM_TILES)


@pytest.mark.parametrize("lo,hi", [(0, 100), (100, 200), (200, 1101)])
def test_every_head_dim_to_300_against_the_rule_and_the_stub(lo, hi):
    """Head dims 1 to 256 are served at the smallest tile at or above
    them, in every dtype over both caches, and 257 to 1100 as slabs of
    128 (tile 128); 0 is refused with the rule named. The stub library
    answers the same."""
    stub = _StubKernelLib()
    codes = {torch.bfloat16: 0, torch.float32: 1, torch.float16: 3,
             torch.int8: 2}
    for d in range(lo, hi):
        tile = kernel_head_dim_tile(d)
        if 1 <= d <= 256:
            assert tile == min(t for t in KERNEL_HEAD_DIM_TILES if t >= d)
        elif d > 256:
            assert tile == 128 and kernel_head_dim_slabs(d) == (
                -(-d // 128), 128)
        else:
            assert tile is None
        assert stub.head_dim_tile(d) == (tile or 0)
        for dtype in (torch.bfloat16, torch.float16, torch.float32):
            for cache in (dtype, torch.int8):
                rule = kernel_geometry_refusal(dtype, cache, 3, d)
                assert (rule is None) == (d >= 1), (d, rule)
                if rule is not None:
                    assert ("every head_dim of 1 or more" in rule
                            and f"not {d}" in rule)
                assert bool(stub.pstt_kernel_supports(
                    codes[dtype], codes[cache], 3, d)) == (rule is None)


# (source config.json, q heads, kv heads, head_dim, its tile): public
# llama-architecture checkpoints whose head_dim is none of the head dims
# the kernels took before the tile rule (32, 64, 80, 128), and neighbours
# that are.
PUBLISHED = [
    ("tiiuae/Falcon3-1B-Base", 8, 4, 256, 256),
    ("tiiuae/Falcon3-3B-Base", 12, 4, 256, 256),
    ("tiiuae/Falcon3-7B-Base", 12, 4, 256, 256),
    ("tiiuae/Falcon3-10B-Base", 12, 4, 256, 256),
    ("openlm-research/open_llama_3b", 32, 32, 100, 128),
    ("openlm-research/open_llama_3b_v2", 32, 32, 100, 128),
    ("openlm-research/open_llama_7b", 32, 32, 128, 128),
    ("meta-llama/Meta-Llama-3-8B", 32, 8, 128, 128),
    ("facebook/opt-2.7b", 32, 32, 80, 80),
    ("Qwen/Qwen2-0.5B", 14, 2, 64, 64),
]


@pytest.mark.parametrize("source,nh,nkv,d,tile", PUBLISHED,
                         ids=[p[0] for p in PUBLISHED])
def test_published_configs_run_at_their_tile(monkeypatch, source, nh, nkv,
                                             d, tile):
    """Every dtype over a cache of its type and over int8; the start-up
    check passes with the stub library (the card's answer); the decode
    kernel's group tile and scratch at the head dim's tile."""
    monkeypatch.setattr(paged_kv_common, "kernel_lib", _StubKernelLib)
    assert kernel_head_dim_tile(d) == tile
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        for cache in (dtype, torch.int8):
            assert kernel_geometry_supported(dtype, cache, nh // nkv, d)
            check_kernel_shapes(nh, nkv, d, 16, dtype, cache)
    gt = decode_group_tile(nh // nkv, d)
    widest = 8 if tile <= 64 else 4 if tile <= 128 else 2
    assert gt == (1 if nh == nkv else min(4 if nh // nkv <= 4 else 8,
                                          widest))
    assert tuple(_partials(torch.zeros(2, nh, d), nkv, 3).shape) == (
        2, nkv * -(-(nh // nkv) // gt), 3, gt, tile + 2)


@pytest.mark.parametrize("d", [0, 257, 288, 320])
def test_head_dims_past_the_widest_tile_are_refused(monkeypatch, d):
    """Only a head_dim under 1 is refused: the start-up check raises
    before asking the library, naming the rule, and the decode scratch
    has no tile to size itself by. Past the widest tile a head_dim runs
    as ceil(d / 128) slabs of 128: the check passes, and the decode
    kernel's group tile and scratch are the tile 128's, one slab wide,
    the slabs along the scratch's grid axis."""
    monkeypatch.setattr(paged_kv_common, "kernel_lib", _StubKernelLib)
    if d < 1:
        with pytest.raises(NotImplementedError,
                           match=f"every head_dim of 1 or more.*not {d}"):
            check_kernel_shapes(12, 4, d, 16, torch.bfloat16)
        with pytest.raises(ValueError, match=f"head_dim {d}"):
            decode_group_tile(3, d)
        return
    check_kernel_shapes(12, 4, d, 16, torch.bfloat16)
    assert kernel_head_dim_slabs(d) == (3, 128)
    assert decode_group_tile(3, d) == 4
    assert tuple(_partials(torch.zeros(2, 12, d), 4, 3).shape) == (
        2, 4 * 3, 3, 4, 130)


# ---- greedy streams against the JAX engine --------------------------------

# (label, q heads, kv heads, head_dim, hidden): a llama at head_dim 100
# (hidden / heads, OpenLLaMA-3B's) and one at an explicit head_dim 256
# wider than hidden / heads (Falcon3's config names its head_dim).
ENGINES = [("llama-g1-d100", 2, 2, 100, 200),
           ("llama-g3-d256-explicit", 3, 1, 256, 96)]


def _model(cls, nh, nkv, d, hidden):
    return cls(name="tiny-llama", architecture="llama", vocab_size=512,
               hidden_size=hidden, intermediate_size=192,
               num_hidden_layers=2, num_attention_heads=nh,
               num_key_value_heads=nkv, head_dim=d,
               max_position_embeddings=512, dtype="float32")


def _engine_config(cfg, model):
    return cfg.EngineConfig(
        model=model,
        cache=cfg.CacheConfig(page_size=16, num_pages=64),
        scheduler=cfg.SchedulerConfig(max_num_seqs=4, max_model_len=256,
                                      prefill_chunk_size=32))


@pytest.mark.parametrize("label,nh,nkv,d,hidden", ENGINES,
                         ids=[e[0] for e in ENGINES])
def test_greedy_streams_match_jax(label, nh, nkv, d, hidden):
    """f32 greedy streams byte-identical to the JAX engine's, the
    weights of its own initialisation carried across by
    ``models/convert.py``."""
    jax_model = _model(jax_config.ModelConfig, nh, nkv, d, hidden)
    port_model = _model(config.ModelConfig, nh, nkv, d, hidden)
    assert jax_model.head_dim == port_model.head_dim == d
    init, _ = jax_registry.get_model(jax_model)
    weights = {k: np.asarray(v, np.float32) for k, v in init(
        jax_model, jax.random.PRNGKey(20)).items()}
    ref_engine = JaxEngine(_engine_config(jax_config, jax_model),
                           params={k: jnp.asarray(v)
                                   for k, v in weights.items()})
    port = LLMEngine(_engine_config(config, port_model),
                     params=params_from_numpy(weights, port_model, "cpu"),
                     device="cpu")
    rng = np.random.RandomState(10)
    prompts = [rng.randint(1, 500, size=n).tolist() for n in (5, 17, 40, 70)]
    sp = dict(temperature=0.0, max_tokens=12, ignore_eos=True)
    ref = [list(s.output_token_ids) for s in ref_engine.generate_batch(
        prompts, JaxSamplingParams(**sp))]
    got = [list(s.output_token_ids) for s in port.generate_batch(
        prompts, SamplingParams(**sp))]
    assert got == ref, label
