"""The prefill kernel's wgmma walk (csrc/paged_walk_wgmma.cuh), as far as
the CPU can hold it.

The walk runs only on the card (tests/test_torch_cuda_kernels.py and
``chip_smoke.py`` hold it against the plain version there). Here:

- the host's mirror of its plan (``prefill_walk_plan``: tile rows and
  consumer warpgroups, ring and raw stages, the copy path by page size,
  shared bytes a block) against the constants, the rules and the
  instance table of the source, whose ``PSTT_WG_PLAN`` lines the
  compiler checks against ``WgSmem`` on the card; every instance within
  the 232,448 bytes a block may have;
- that the prefill kernels launch the wgmma walk and no longer the
  ``mma.sync`` walk, which the ragged kernel keeps at the tiles up to
  128 (its 16-bit head dims 129 to 512 take the wgmma walk too:
  tests/test_torch_ragged_wgmma.py);
- the walk's wide form (16-bit head dims 257 to 512, at widths 384 and
  512: two consumer warpgroups on a 64-row tile, each owning half of
  the output dims; ring units of one plane): its widths and plans
  against the source's, the walk ``prefill_walk_plan`` names at every
  head_dim (``wgmma_wide`` to 512, ``mma_slab`` above, ``f32`` for
  f32 queries), and its dispatch ahead of the slab walk;
- the plain version with the walk's rounding (bf16 probabilities into
  p . v) against the Pallas prefill kernel in interpret mode at the
  shapes where the plan changes: one consumer warpgroup at G * T = 64,
  two at 65, tiles 80 and 256 (a head_dim of 160 padded), an int8 cache
  at a page of 8 (token copies) and pages of 1 and 48; and at the wide
  form's head dims 320 and 512, per layer, stacked and over int8.

Inputs are made with numpy from a seed and go through both packages.
Tolerance: bf16-rounded probabilities at atol = rtol = 2e-2 (one bf16
rounding of probabilities of order 1); the plain version is the f32
walk otherwise.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from production_stack_tpu.ops.prefill_attention_pallas import (
    paged_prefill_attention as jax_paged_prefill_attention,
)
from production_stack_tpu.ops.quant_kv import QuantKV as JaxQuantKV
from production_stack_tpu.ops.quant_kv import quantize_kv as jax_quantize_kv
from production_stack_tpu_torch.ops.paged_kv_common import (
    KERNEL_HEAD_DIM_TILES,
)
from production_stack_tpu_torch.ops.prefill_attention_cuda import (
    MAX_BLOCK_SMEM,
    WG_MAX_CONSUMERS,
    WG_MAX_STAGES,
    WG_ROWS,
    WG_SPAN_TOKENS,
    WG_WIDE_WIDTHS,
    paged_prefill_attention,
    paged_prefill_attention_plain,
    prefill_walk_plan,
    wide_head_dim_width,
)
from production_stack_tpu_torch.ops.quant_kv import QuantKV
from tests.test_torch_head_dims import (
    DTYPES,
    KV_HEADS,
    _caches,
    _close,
    _first,
    _i,
    _j,
    _layer,
    _t,
    _table,
)

torch.set_num_threads(2)

CSRC = Path(__file__).resolve().parents[1] / "production_stack_tpu_torch" / "csrc"
WALK = (CSRC / "paged_walk_wgmma.cuh").read_text()
COMMON = (CSRC / "paged_kv_common.cuh").read_text()
BF16_P_TOL = dict(rtol=2e-2, atol=2e-2)


def _constant(src, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


# (cache is int8, tile) -> (stages, raw stages, bytes) as the source's
# PSTT_WG_PLAN lines state them.
SOURCE_PLAN = {
    (c == "int8_t", int(d)): (int(s), int(r), int(b))
    for c, d, s, r, b in re.findall(
        r"^PSTT_WG_PLAN\((\w+), (\d+), (\d+), (\d+), (\d+)\)", WALK, re.M)
}


def test_constants_are_the_sources():
    assert _constant(WALK, "kWgSpan") == WG_SPAN_TOKENS
    assert _constant(WALK, "kWgRows") == WG_ROWS
    assert _constant(WALK, "kWgMaxConsumers") == WG_MAX_CONSUMERS
    assert _constant(WALK, "kWgMaxStages") == WG_MAX_STAGES
    assert _constant(COMMON, "kMaxBlockSmem") == MAX_BLOCK_SMEM
    # One producer warpgroup beside the consumers; the registers it
    # gives up cover the consumers' rise (a 384-thread block at 168),
    # at the tile 256 and below it.
    regs = {name: tuple(map(int, re.search(
        rf"int {name}\(int d\) \{{\s*return d > 128 \? (\d+) : (\d+);",
        WALK).groups())) for name in ("wg_producer_regs", "wg_consumer_regs")}
    entry = 65536 // ((WG_MAX_CONSUMERS + 1) * 128) // 8 * 8
    assert entry == 168
    for producer, consumer in zip(regs["wg_producer_regs"],
                                  regs["wg_consumer_regs"]):
        assert producer * 128 + consumer * 128 * WG_MAX_CONSUMERS <= (
            entry * 128 * (WG_MAX_CONSUMERS + 1))
        assert producer % 8 == 0 and consumer % 8 == 0 and consumer <= 256


def test_the_source_plans_every_instance_once():
    # Every tile and every width of the wide form, over both caches.
    assert sorted(SOURCE_PLAN) == sorted(
        (int8, d) for int8 in (False, True)
        for d in KERNEL_HEAD_DIM_TILES + WG_WIDE_WIDTHS)
    assert len(re.findall(r"^PSTT_WG_PLAN\(", WALK, re.M)) == len(SOURCE_PLAN)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("tile", KERNEL_HEAD_DIM_TILES)
def test_plan_mirrors_the_source_and_fits_a_block(int8, tile):
    cache = torch.int8 if int8 else torch.bfloat16
    plan = prefill_walk_plan(torch.bfloat16, cache, 4, 512, tile, 128)
    assert plan["walk"] == "wgmma" and plan["tile"] == tile
    assert (plan["stages"], plan["raw_stages"], plan["smem_bytes"]) == (
        SOURCE_PLAN[(int8, tile)])
    assert plan["smem_bytes"] <= MAX_BLOCK_SMEM
    assert 2 <= plan["stages"] <= WG_MAX_STAGES
    assert plan["raw_stages"] == (0 if not int8 else
                                  1 if tile == 256 else 2)
    assert plan["q_slots"] == (1 if tile > 128 else 2)
    # f16 queries take the same plan as bf16 (the same 16-bit planes).
    assert prefill_walk_plan(torch.float16, torch.float16 if not int8
                             else torch.int8, 4, 512, tile, 128) == plan


@pytest.mark.parametrize("group,tokens,consumers", [
    (1, 1, 1), (4, 16, 1), (1, 64, 1), (2, 32, 1), (1, 65, 2), (4, 17, 2),
    (3, 512, 2), (8, 512, 2), (16, 16, 2)])
def test_tile_rows_by_the_rows_of_a_kv_head(group, tokens, consumers):
    """One consumer warpgroup (64-row tiles) where G * T fits in 64, two
    (128-row tiles) above: the source's wg_consumers."""
    rule = re.search(r"return rows <= (\w+) \? 1 : (\w+);", WALK)
    assert rule.groups() == ("kWgRows", "kWgMaxConsumers")
    plan = prefill_walk_plan(torch.bfloat16, torch.bfloat16, group, tokens,
                             64, 16)
    assert plan["consumers"] == consumers
    assert plan["tile_rows"] == consumers * WG_ROWS


@pytest.mark.parametrize("page_size", [1, 2, 4, 8, 12, 16, 24, 32, 48, 64,
                                       96, 128, 200, 256, 512])
def test_copy_path_by_page_size(page_size):
    """Whole pages with 16-byte copies where the page is a power of two
    whose head-dim row holds 16 bytes or more (8 tokens of bf16, 16 of
    int8), token copies elsewhere: the source's wg_whole_pages."""
    rule = re.search(r"bool wg_whole_pages\(int page_size\) \{\s*return "
                     r"([^;]+);", WALK).group(1)
    assert "(page_size & (page_size - 1)) == 0" in rule
    assert "page_size * (int)sizeof(C) >= 16" in rule
    pow2 = page_size & (page_size - 1) == 0
    for cache, esz in ((torch.bfloat16, 2), (torch.int8, 1)):
        plan = prefill_walk_plan(torch.bfloat16, cache, 4, 64, 64, page_size)
        assert plan["copies"] == (
            "pages" if pow2 and page_size * esz >= 16 else "tokens")


def test_other_walks_keep_their_plans():
    assert prefill_walk_plan(torch.float32, torch.float32, 2, 64, 32,
                             16)["walk"] == "f32"
    assert prefill_walk_plan(torch.float32, torch.int8, 2, 64, 256,
                             16)["walk"] == "f32"
    # 512 is the wide form's (its own test below); the slab walk keeps
    # the 16-bit head dims above it.
    assert prefill_walk_plan(torch.bfloat16, torch.int8, 3, 512, 512,
                             16)["walk"] == "wgmma_wide"
    slab = prefill_walk_plan(torch.bfloat16, torch.int8, 3, 512, 576, 16)
    assert slab == {"walk": "mma_slab", "tile": 128, "tile_rows": 64,
                    "slabs": 5}


# ---- the wide form ------------------------------------------------------------


def test_wide_widths_are_the_sources():
    """The widths of PSTT_FOR_EACH_WG_WIDTH, ascending, from above the
    widest tile; the width rule (wg_wide_width) and its mirror agree
    on every head_dim up to 1100."""
    listed = re.search(r"#define PSTT_FOR_EACH_WG_WIDTH\(X, code, T, ccode, "
                       r"C\)((?:[^\n]*\\\n)*[^\n]*)", WALK).group(1)
    widths = tuple(int(w) for w in re.findall(r"X\(code, T, ccode, C, "
                                              r"(\d+)\)", listed))
    assert widths == WG_WIDE_WIDTHS == (384, 512)
    assert widths[0] > KERNEL_HEAD_DIM_TILES[-1]
    assert re.search(r"if \(head_dim <= kMaxHeadDim\) return 0;", WALK)
    for d in range(0, 1101):
        want = next((w for w in widths if d <= w), None) if d > 256 else None
        assert wide_head_dim_width(d) == want, d


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("width", WG_WIDE_WIDTHS)
def test_wide_plan_mirrors_the_source_and_fits_a_block(int8, width):
    """Ring slots of one plane (two at 512, three at 384), one raw
    slot for int8, one q slot of 64 rows both warpgroups read, the
    64-token span and the 128-byte swizzle: within a block, and the
    source's PSTT_WG_PLAN line."""
    cache = torch.int8 if int8 else torch.bfloat16
    plan = prefill_walk_plan(torch.bfloat16, cache, 3, 512, width, 128)
    assert plan["walk"] == "wgmma_wide" and plan["width"] == width
    assert (plan["slots"], plan["raw_stages"], plan["smem_bytes"]) == (
        SOURCE_PLAN[(int8, width)])
    assert plan["smem_bytes"] <= MAX_BLOCK_SMEM
    assert plan["slots"] == (3 if width == 384 else 2)
    assert plan["raw_stages"] == (1 if int8 else 0)
    assert (plan["consumers"], plan["tile_rows"], plan["q_slots"]) == (
        WG_MAX_CONSUMERS, WG_ROWS, 1)
    # The plane, the q tile and the second warpgroup's half of V start
    # at swizzle atoms.
    assert width * 128 % 1024 == 0 and width // 2 * 128 % 1024 == 0
    assert prefill_walk_plan(torch.float16, torch.float16 if not int8
                             else torch.int8, 1, 64, width, 16) == dict(
        plan, copies="pages")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("cache", ["same", "int8"])
def test_plan_names_the_wide_walk_from_257_to_512(dtype, cache):
    kv = torch.int8 if cache == "int8" else dtype
    for d in (257, 288, 320, 384):
        plan = prefill_walk_plan(dtype, kv, 3, 512, d, 128)
        assert (plan["walk"], plan["width"]) == ("wgmma_wide", 384), d
    for d in (385, 448, 512):
        plan = prefill_walk_plan(dtype, kv, 3, 512, d, 128)
        assert (plan["walk"], plan["width"]) == ("wgmma_wide", 512), d
    for d, slabs in ((513, 5), (576, 5), (1024, 8)):
        plan = prefill_walk_plan(dtype, kv, 3, 512, d, 128)
        assert plan == {"walk": "mma_slab", "tile": 128, "tile_rows": 64,
                        "slabs": slabs}, d
    for d in (256, 100):
        assert prefill_walk_plan(dtype, kv, 3, 512, d, 128)["walk"] == (
            "wgmma")
    for d in (257, 320, 512, 576):
        assert prefill_walk_plan(torch.float32, torch.float32 if cache ==
                                 "same" else torch.int8, 3, 512, d,
                                 128)["walk"] == "f32"


def test_wide_form_dispatches_ahead_of_the_slab_walk():
    """The 16-bit sources try the wide widths before the tiles and
    the slab instance (which serves only what the wide form leaves:
    above 512); the f32 source has no wide form. The wide kernel runs
    the same walk (page_walk_block_wgmma) under a name of its own."""
    prefill = (CSRC / "paged_prefill.cuh").read_text()
    assert "paged_prefill_wgmma_wide_kernel" in prefill
    assert prefill.count("page_walk_block_wgmma<T, C, W>(a)") == 1
    assert "pstt::wg_wide_width(args.head_dim) == W" in prefill
    for src, wide, geometry in (("bf16", "BF16_WIDE", "BF16_GEOMETRY"),
                                ("f16", "F16_WIDE", "F16_GEOMETRY")):
        body = (CSRC / f"paged_prefill_{src}.cu").read_text()
        assert body.index(f"PSTT_FOR_EACH_{wide}(PSTT_PREFILL_WIDE_CASE)") < (
            body.index(f"PSTT_FOR_EACH_{geometry}(PSTT_PREFILL_CASE)"))
    assert "WIDE" not in (CSRC / "paged_prefill_f32.cu").read_text()
    # The wide form shares the walk's code: one producer, one consumer.
    assert WALK.count("void wg_produce(") == 1
    assert WALK.count("void wg_consume(") == 1
    # A launch that fails its attribute or its register check returns
    # the error; no launch goes to another walk.
    launch = prefill[prefill.index("int launch(const PrefillArgs& a)"):]
    launch = launch[:launch.index("\n}\n")]
    assert "if (attr != cudaSuccess) return attr;" in launch
    assert "return cudaErrorInvalidConfiguration;" in launch


def test_prefill_launches_the_wgmma_walk_and_ragged_keeps_mma_sync():
    prefill = (CSRC / "paged_prefill.cuh").read_text()
    ragged = (CSRC / "paged_ragged.cuh").read_text()
    old_walk = re.compile(r"\bpage_walk_block_mma\b(?!_slab)")
    assert not old_walk.search(prefill)
    assert "page_walk_block_wgmma<T, C, D>(" in prefill
    # Ragged keeps page_walk_block_mma at the tiles up to 128; no
    # mma.sync instance of its 16-bit tile 256 is built (those head dims
    # and 257 to 512 run the wgmma walk).
    assert old_walk.search(ragged)
    tiles = re.findall(r"X\(code, T, ccode, C, (\d+), false\)", re.search(
        r"#define PSTT_FOR_EACH_RAGGED_MMA_HEAD_DIM\(X, code, T, ccode, C\)"
        r"((?:[^\n]*\\\n)*[^\n]*)", ragged).group(1))
    assert tiles == ["32", "64", "80", "128"]
    assert "static_assert(D <= 128" in (CSRC / "paged_walk_mma.cuh").read_text()
    # The walk issues wgmma from descriptors and waits on mbarriers; it
    # has no block-wide barrier after its roles part.
    assert "wgmma.mma_async" in (CSRC / "wgmma.cuh").read_text()
    body = WALK[WALK.index("void page_walk_block_wgmma("):]
    assert body.count("__syncthreads()") == 1
    assert "setmaxnreg.dec" in body and "setmaxnreg.inc" in body
    for name in ("wg_produce", "wg_consume"):
        fn = WALK[WALK.index(f"void {name}("):]
        fn = fn[:fn.index("\n}\n")]
        assert "__syncthreads" not in fn
    assert "cp.async.mbarrier.arrive.noinc" in WALK


# ---- the plain version at the walk's corner shapes --------------------------

# (group, tokens, head_dim, page_size, int8, first_chunk): one consumer
# at G * T = 64, two at 65 (a tile across query heads), tiles 80 and
# 256 (160 padded), int8 at a page of 8, pages of 1 and 48.
CORNERS = [(4, 16, 64, 16, False, True), (1, 65, 64, 16, False, False),
           (2, 40, 80, 48, False, False), (3, 24, 160, 16, True, True),
           (2, 24, 64, 8, True, False), (1, 24, 32, 1, False, False)]


def _case(seed, group, tokens, d, page_size, int8, first_chunk):
    rng = np.random.RandomState(seed)
    kv_heads = 2
    lengths = np.array([tokens, tokens - 5, 0, 1], np.int32)
    starts = (np.zeros(4, np.int32) if first_chunk
              else np.array([70, 130, 0, 63], np.int32))
    kv_lens = np.where(lengths > 0, starts + lengths, 0).astype(np.int32)
    positions = np.zeros((4, tokens), np.int32)
    for i in range(4):
        if lengths[i]:
            positions[i] = starts[i] + np.arange(tokens)
    max_pages = -(-int(kv_lens.max()) // page_size) + 1
    table = np.zeros((4, max_pages), np.int32)
    nxt = 1
    for i, n in enumerate(kv_lens):
        for j in range(-(-int(n) // page_size)):
            table[i, j] = nxt
            nxt += 1
    q = rng.randn(4, tokens, group * kv_heads, d).astype(np.float32)
    k, v = (rng.randn(kv_heads, nxt + 1, d, page_size).astype(np.float32)
            for _ in range(2))
    return q, k, v, table, positions, kv_lens


@pytest.mark.parametrize("group,tokens,d,page_size,int8,first_chunk",
                         CORNERS)
def test_plain_walk_with_bf16_probabilities_matches_pallas(
        group, tokens, d, page_size, int8, first_chunk):
    q, k, v, table, pos, lens = _case(22, group, tokens, d, page_size, int8,
                                      first_chunk)
    if int8:
        # The same int8 pages and scales on both sides ([.., d, page]
        # token-minor, quantized over the head dim of each token).
        kq, ks = jax_quantize_kv(jnp.asarray(k).transpose(0, 1, 3, 2))
        vq, vs = jax_quantize_kv(jnp.asarray(v).transpose(0, 1, 3, 2))
        kq, vq = (np.asarray(x).transpose(0, 1, 3, 2) for x in (kq, vq))
        ks, vs = np.asarray(ks), np.asarray(vs)
        jk, jv = (JaxQuantKV(jnp.asarray(kq), jnp.asarray(ks)),
                  JaxQuantKV(jnp.asarray(vq), jnp.asarray(vs)))
        tk = QuantKV(torch.from_numpy(np.ascontiguousarray(kq)),
                     torch.from_numpy(ks))
        tv = QuantKV(torch.from_numpy(np.ascontiguousarray(vq)),
                     torch.from_numpy(vs))
    else:
        jk, jv = jnp.asarray(k), jnp.asarray(v)
        tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    expected = np.asarray(jax_paged_prefill_attention(
        jnp.asarray(q), jk, jv, jnp.asarray(table), jnp.asarray(pos),
        jnp.asarray(lens), interpret=True))
    args = (torch.from_numpy(q), tk, tv, torch.from_numpy(table),
            torch.from_numpy(pos), torch.from_numpy(lens))
    got = paged_prefill_attention_plain(*args, p_dtype=torch.bfloat16)
    np.testing.assert_allclose(got.numpy(), expected, **BF16_P_TOL)
    assert not got[2].any()  # kv_len 0: exact 0
    # The CPU wrapper takes the plain version (the f32 walk).
    assert torch.equal(paged_prefill_attention(*args),
                       paged_prefill_attention_plain(*args))


# (head_dim, query group, dtype, page size, form) at the wide form's
# widths: 320 (384, padded) and 512, per layer, stacked and over int8.
WIDE_POINTS = [(320, 3, "bf16", 8, "plain"), (320, 1, "f16", 128, "stacked"),
               (320, 3, "f16", 16, "int8"), (512, 1, "bf16", 128, "plain"),
               (512, 3, "f16", 8, "stacked"), (512, 3, "bf16", 16, "int8")]


@pytest.mark.parametrize("d,group,dtype,page,form", WIDE_POINTS,
                         ids=[f"d{d}-g{g}-{t}-ps{ps}-{f}"
                              for d, g, t, ps, f in WIDE_POINTS])
def test_wide_plain_walk_with_16_bit_probabilities_matches_pallas(
        d, group, dtype, page, form):
    """The plain walk rounded as the wide form rounds (probabilities
    into p . v in the query's type) against the Pallas prefill kernel in
    interpret mode: a first chunk, a chunk past the 128-token edge with
    pad slots at its tail, and a kv_len-0 row (exact 0)."""
    rng = np.random.RandomState(d + group)
    chunk = 24
    lengths = np.array([chunk, chunk - 5, 0], np.int32)
    starts = np.array([0, 120, 0], np.int32)
    kv_lens = np.where(lengths > 0, starts + lengths, 0).astype(np.int32)
    positions = np.zeros((3, chunk), np.int32)
    for i in range(3):
        if lengths[i]:
            positions[i] = starts[i] + np.arange(chunk)
    table, pages = _table(kv_lens, page, -(-144 // page) + 1)
    jk, jv, tk, tv = _caches(rng, pages, d, page, form, dtype)
    q = rng.randn(3, chunk, KV_HEADS * group, d)
    expected = _first(jax_paged_prefill_attention(
        _j(q, dtype), jk, jv, jnp.asarray(table), jnp.asarray(positions),
        jnp.asarray(kv_lens), interpret=True, **_layer(form)))
    got = paged_prefill_attention_plain(
        _t(q, dtype), tk, tv, _i(table), _i(positions), _i(kv_lens),
        p_dtype=DTYPES[dtype][0], **_layer(form))
    assert prefill_walk_plan(DTYPES[dtype][0], DTYPES[dtype][0], group,
                             chunk, d, page)["walk"] == "wgmma_wide"
    _close(got, expected, dtype)
    assert not got[2].any()


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("start", [0, 70])
def test_kernel_times_sdpa_yardstick_computes_the_prefill_function(int8,
                                                                  start):
    """tools/kernel_times.py times one SDPA call beside each prefill key
    (``library_paged_prefill*``): over the same pages gathered dense,
    with the same causal and length mask, it computes the wrapper's
    function (rows with kv_len 0 aside: SDPA has nothing to attend
    there)."""
    from production_stack_tpu_torch.tools.kernel_times import _sdpa_call
    q, k, v, table, pos, lens = _case(23, 2, 24, 32, 16, False, True)
    pos = pos + np.where(lens[:, None] > 0, start, 0).astype(np.int32)
    lens = np.where(lens > 0, lens + start, 0).astype(np.int32)
    max_pages = -(-int(lens.max()) // 16) + 1
    k, v = (np.concatenate([x, np.random.RandomState(5).randn(
        2, 4 * max_pages, 32, 16).astype(np.float32)], axis=1)
        for x in (k, v))
    table = np.zeros((4, max_pages), np.int32)
    nxt = 1
    for i, n in enumerate(lens):
        for j in range(-(-int(n) // 16)):
            table[i, j] = nxt
            nxt += 1
    tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    if int8:
        from production_stack_tpu_torch.ops.quant_kv import quantize_kv

        def quant(c):
            q8, scale = quantize_kv(c.permute(0, 1, 3, 2))
            return QuantKV(q8.permute(0, 1, 3, 2).contiguous(),
                           scale.contiguous())
        tk, tv = quant(tk), quant(tv)
    args = (torch.from_numpy(q), tk, tv, torch.from_numpy(table),
            torch.from_numpy(pos), torch.from_numpy(lens))
    want = paged_prefill_attention_plain(*args)
    got = _sdpa_call(*args, group=2)().transpose(1, 2)
    live = torch.from_numpy(lens) > 0
    torch.testing.assert_close(got[live], want[live], rtol=1e-4, atol=1e-4)
