"""The ragged kernel's 16-bit head dims 129 to 512 on the wgmma walk
(csrc/paged_walk_wgmma.cuh with the ragged tile policy of
csrc/paged_ragged.cuh), as far as the CPU can hold it.

The walk runs only on the card (tests/test_torch_cuda_kernels.py
``-k ragged_wgmma`` and ``chip_smoke.py``'s geometries phase hold it
against the plain version there, and its walk counter against the
plan). Here:

- the host's mirror of the launch's choice (``ragged_walk_plan``)
  against the sources: the walk by query type and head_dim (``mma`` to
  128, ``wgmma`` at 129 to 256, ``wgmma_wide`` at 257 to 512,
  ``mma_slab`` above, ``f32`` for f32 queries), the 16-bit sources
  handing the wgmma walk's head dims to their own sources first and
  those trying the wide widths before the tile 256, the consumer rule,
  the plans' shared bytes equal to the source's ``PSTT_WG_PLAN`` lines,
  the walk counter's order, and a launch that returns its error rather
  than falling back to another walk;
- the host's mirror of the walk's ragged tile order (``ragged_wg_tile``)
  over random rows with pad rows and verify rows: a bijection over a
  pair's tiles, its live tiles first and heaviest first, every pair's
  heaviest live tile before any dead tile of a later round;
- the plain version with the walk's rounding (16-bit probabilities into
  p . v) against the Pallas ragged kernel in interpret mode at head dims
  200, 256, 257, 320, 384 and 512: unified and verify blocks, per layer,
  stacked and over int8, pages 8, 16 and 48, dead slots exact 0.

Inputs are made with numpy from a seed and go through both packages.
Tolerance: 16-bit outputs at atol = rtol = 2e-2, compared in f32 (one
rounding of probabilities of order 1 in the query's type; each side
rounds its output once).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from production_stack_tpu.ops.ragged_attention_pallas import (
    paged_ragged_attention as jax_paged_ragged_attention,
)
from production_stack_tpu_torch.ops.prefill_attention_cuda import (
    MAX_BLOCK_SMEM,
    WG_ROWS,
    WG_WIDE_WIDTHS,
    prefill_walk_plan,
)
from production_stack_tpu_torch.ops.ragged_attention_cuda import (
    RAGGED_WALKS,
    paged_ragged_attention,
    paged_ragged_attention_plain,
    ragged_live_tiles,
    ragged_walk_plan,
    ragged_wg_tile,
)
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
RAGGED = (CSRC / "paged_ragged.cuh").read_text()
RAGGED_CU = (CSRC / "paged_ragged.cu").read_text()

# (cache is int8, tile or width) -> (stages, raw stages, bytes) as the
# walk's PSTT_WG_PLAN lines state them.
SOURCE_PLAN = {
    (c == "int8_t", int(d)): (int(s), int(r), int(b))
    for c, d, s, r, b in re.findall(
        r"^PSTT_WG_PLAN\((\w+), (\d+), (\d+), (\d+), (\d+)\)", WALK, re.M)
}
HALF = (torch.bfloat16, torch.float16)


def _walk_by_rule(dtype, head_dim):
    if dtype == torch.float32:
        return "f32"
    if head_dim <= 128:
        return "mma"
    if head_dim <= 256:
        return "wgmma"
    return "wgmma_wide" if head_dim <= 512 else "mma_slab"


@pytest.mark.parametrize("dtype", HALF + (torch.float32,))
@pytest.mark.parametrize("int8", [False, True])
def test_plan_names_the_walk_by_type_and_head_dim(dtype, int8):
    cache = torch.int8 if int8 else dtype
    for d in range(1, 1101):
        plan = ragged_walk_plan(dtype, cache, 3, 512, d, 16)
        assert plan["walk"] == _walk_by_rule(dtype, d), d
        if plan["walk"] == "mma":
            # PR 6's walk keeps every tile up to 128.
            assert plan["tile"] <= 128 and plan["tile_rows"] == 64
        if plan["walk"] == "mma_slab":
            assert plan["slabs"] == -(-d // 128)
    # A 16-bit head_dim takes the walk prefill takes there, but up to
    # 128, where ragged keeps the mma.sync walk.
    for d in (129, 200, 256, 257, 320, 384, 448, 512, 513, 640):
        pre = prefill_walk_plan(HALF[0], HALF[0], 3, 512, d, 16)["walk"]
        assert ragged_walk_plan(HALF[0], HALF[0], 3, 512, d, 16)["walk"] == (
            pre)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("d", [129, 200, 256, 257, 320, 384, 385, 512])
def test_wgmma_plans_are_the_sources(int8, d):
    """The ragged plans' ring, raw stages and shared bytes are prefill's
    at the same tile or width (the same WgSmem), as the source's
    PSTT_WG_PLAN lines state them; every one fits a block."""
    cache = torch.int8 if int8 else torch.bfloat16
    plan = ragged_walk_plan(torch.bfloat16, cache, 3, 512, d, 128)
    at = plan.get("width", plan.get("tile"))
    stages = plan.get("slots", plan.get("stages"))
    assert (stages, plan["raw_stages"], plan["smem_bytes"]) == (
        SOURCE_PLAN[(int8, at)])
    assert plan["smem_bytes"] <= MAX_BLOCK_SMEM
    assert plan["q_slots"] == 1
    assert at == (256 if d <= 256 else 384 if d <= 384 else 512)
    assert ragged_walk_plan(torch.float16, torch.int8 if int8 else
                            torch.float16, 3, 512, d, 128) == plan


@pytest.mark.parametrize("group,width,consumers", [
    (3, 5, 1), (8, 8, 1), (1, 64, 1), (1, 65, 2), (3, 512, 2), (12, 5, 1),
    (16, 5, 2), (4, 16, 1), (4, 17, 2)])
def test_consumers_by_the_rows_of_a_pair(group, width, consumers):
    """At the tile 256, one consumer warpgroup (64-row tiles) where the
    G * W rows of a (row, kv head) pair fit in 64 (a verify block), two
    (128-row tiles) above: prefill's rule, the source's wg_consumers;
    the wide form always two on 64 rows."""
    assert re.search(r"WIDE \? kWgMaxConsumers : wg_consumers\(group \* "
                     r"a\.width\)", RAGGED)
    plan = ragged_walk_plan(torch.bfloat16, torch.bfloat16, group, width,
                            256, 16)
    assert (plan["consumers"], plan["tile_rows"]) == (consumers,
                                                      consumers * WG_ROWS)
    wide = ragged_walk_plan(torch.bfloat16, torch.bfloat16, group, width,
                            512, 16)
    assert (wide["consumers"], wide["tile_rows"]) == (2, WG_ROWS)


@pytest.mark.parametrize("page_size", [1, 8, 12, 16, 48, 128, 256])
def test_copy_path_by_page_size(page_size):
    pow2 = page_size & (page_size - 1) == 0
    for cache, esz in ((torch.bfloat16, 2), (torch.int8, 1)):
        for d in (256, 512):
            plan = ragged_walk_plan(torch.bfloat16, cache, 3, 512, d,
                                    page_size)
            assert plan["copies"] == (
                "pages" if pow2 and page_size * esz >= 16 else "tokens")


def test_sources_dispatch_the_wgmma_walk_first():
    """The 16-bit ragged sources hand ragged_wgmma_head_dim's head dims
    (129 to 512) to the wgmma sources before PR 6's tiles and the slab
    walk; those try the wide widths before the tile 256, over a cache of
    the query's type and int8; the f32 source has no wgmma walk. The
    wgmma kernels run the one walk (page_walk_block_wgmma with
    WgRaggedTiles), each source with its own tile scheduler."""
    for t, T in (("bf16", "BF16"), ("f16", "F16")):
        body = (CSRC / f"paged_ragged_{t}.cu").read_text()
        assert body.index(f"return ragged_wgmma_launch_{t}(args") < (
            body.index(f"PSTT_FOR_EACH_{T}_RAGGED_MMA(PSTT_RAGGED_CASE)"))
        assert "if (ragged_wgmma_head_dim(args.head_dim))" in body
        wg = (CSRC / f"paged_ragged_wgmma_{t}.cu").read_text()
        assert f"PSTT_FOR_EACH_{T}_RAGGED_WG(PSTT_RAGGED_WG_CASE)" in wg
    f32 = (CSRC / "paged_ragged_f32.cu").read_text()
    assert "wgmma" not in f32
    listed = re.search(r"#define PSTT_FOR_EACH_RAGGED_WG\(X, code, T, ccode, "
                       r"C\)((?:[^\n]*\\\n)*[^\n]*)", RAGGED).group(1)
    assert listed.index("PSTT_FOR_EACH_WG_WIDTH") < listed.index(
        "X(code, T, ccode, C, 256)")
    for line in ("PSTT_FOR_EACH_RAGGED_WG(X, 0, __nv_bfloat16, 0, "
                 "__nv_bfloat16)",
                 "PSTT_FOR_EACH_RAGGED_WG(X, 0, __nv_bfloat16, 2, int8_t)",
                 "PSTT_FOR_EACH_RAGGED_WG(X, 3, __half, 3, __half)",
                 "PSTT_FOR_EACH_RAGGED_WG(X, 3, __half, 2, int8_t)"):
        assert line in RAGGED
    rule = re.search(r"bool ragged_wgmma_head_dim\(int head_dim\) \{\s*"
                     r"return ([^;]+);", RAGGED).group(1)
    assert "head_dim_tile(head_dim) == kMaxHeadDim" in rule
    assert "wg_wide_width(head_dim) != 0" in rule
    assert RAGGED.count("page_walk_block_wgmma<T, C, D, WgRaggedTiles>(a)") == 1
    assert RAGGED.count("page_walk_block_wgmma<T, C, W, WgRaggedTiles>(a)") == 1
    assert "static __device__ int wg_next_tile;" in WALK
    # One walk: one producer and one consumer, prefill's policy the
    # default.
    assert WALK.count("void wg_produce(") == 1
    assert WALK.count("void wg_consume(") == 1
    assert WALK.count("typename Tiles = WgPrefillTiles>") == 3


def test_launch_returns_its_error_and_builds_no_mma_tile_256():
    """A wgmma launch that fails its attribute or its register check
    returns the error (no other walk, no plain version); the 16-bit
    mma.sync instance at the tile 256, which the wgmma walk replaced, is
    not built."""
    launch = RAGGED[RAGGED.index("int launch_wgmma(const RaggedArgs& a)"):]
    launch = launch[:launch.index("\n}\n")]
    assert "if (attr != cudaSuccess) return attr;" in launch
    assert "return cudaErrorInvalidConfiguration;" in launch
    assert "launch<" not in launch
    # The 16-bit sources instantiate the mma.sync walks at the tiles up
    # to 128 and the slab only (PSTT_FOR_EACH_RAGGED_MMA_HEAD_DIM).
    listed = re.search(
        r"#define PSTT_FOR_EACH_RAGGED_MMA_HEAD_DIM\(X, code, T, ccode, C\)"
        r"((?:[^\n]*\\\n)*[^\n]*)", RAGGED).group(1)
    assert re.findall(r"X\(code, T, ccode, C, (\d+), (\w+)\)", listed) == [
        ("32", "false"), ("64", "false"), ("80", "false"),
        ("128", "false"), ("128", "true")]
    for t, T in (("bf16", "BF16"), ("f16", "F16")):
        body = (CSRC / f"paged_ragged_{t}.cu").read_text()
        assert "_GEOMETRY(" not in body
        assert f"PSTT_FOR_EACH_{T}_RAGGED_MMA(PSTT_RAGGED_CASE)" in body


def test_walk_counter_order_is_the_sources():
    """pstt_ragged_walk_launches's index: RaggedWalk's order, which the
    C interface's note and RAGGED_WALKS state."""
    enum = re.search(r"enum RaggedWalk \{([^}]*)\}", RAGGED).group(1)
    names = [n.strip() for n in enum.split(",") if n.strip()]
    assert names == ["kRaggedMma", "kRaggedWgmma", "kRaggedWgmmaWide",
                     "kRaggedMmaSlab", "kRaggedF32", "kRaggedWalks"]
    assert RAGGED_WALKS == ("mma", "wgmma", "wgmma_wide", "mma_slab", "f32")
    assert ("(0 mma, 1 wgmma, 2 wgmma_wide, 3 mma_slab, 4 f32)"
            in " ".join(RAGGED_CU.replace("//", "").split()))


# ---- the tile order -----------------------------------------------------------


def _tile_rows_live(kv_len, last, group, width, tile_rows, tile):
    """(live rows, rows) of tile ``tile`` of a pair, as WgRaggedTiles
    computes them."""
    live = max(0, (min(last if kv_len > 0 else -1, width - 1) + 1) * group)
    row0 = tile * tile_rows
    end = min(tile_rows, group * width - row0)
    return max(0, min(live - row0, end)), end


def test_tile_order_mirrors_the_source():
    assert re.search(r"int ragged_wg_tile\(int z, int live_tiles\) \{\s*"
                     r"return z < live_tiles \? live_tiles - 1 - z : z;",
                     RAGGED)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("group,width,tile_rows", [
    (3, 512, 128), (3, 512, 64), (1, 5, 64), (3, 5, 64), (8, 160, 128),
    (6, 64, 64), (1, 700, 128)])
def test_tile_order_is_a_bijection_live_tiles_first(seed, group, width,
                                                    tile_rows):
    rng = np.random.RandomState(seed * 100 + group * 10 + tile_rows)
    rows = []
    for _ in range(24):
        kind = rng.randint(4)
        if kind == 0:  # a pad row
            rows.append((0, int(rng.choice([-1, 0]))))
        elif kind == 1:  # a decode row
            rows.append((int(rng.randint(1, 2000)), 0))
        elif kind == 2:  # a verify row
            k = int(rng.randint(0, min(5, width)))
            rows.append((int(rng.randint(k + 1, 2000)), k))
        else:  # a chunk row
            n = int(rng.randint(1, width + 1))
            rows.append((int(rng.randint(0, 1000)) + n, n - 1))
    kv_heads = 2
    tiles = -(-group * width // tile_rows)
    pairs = kv_heads * len(rows)
    heaviest, first_dead_later = [], []
    for pair in range(pairs):
        kv_len, last = rows[pair // kv_heads]
        live_tiles = ragged_live_tiles(kv_len, last, group, width, tile_rows)
        order = [ragged_wg_tile(z, live_tiles) for z in range(tiles)]
        assert sorted(order) == list(range(tiles))
        # Live tiles first, heaviest (the highest slots) first.
        assert order[:live_tiles] == list(range(live_tiles))[::-1]
        for z, tile in enumerate(order):
            nrows, end = _tile_rows_live(kv_len, last, group, width,
                                         tile_rows, tile)
            assert (nrows > 0) == (z < live_tiles), (pair, z, tile)
            assert 0 < end <= tile_rows
        if live_tiles:
            heaviest.append(pair)  # launch index 0 * pairs + pair
        first_dead_later += [z * pairs + pair
                             for z in range(max(live_tiles, 1), tiles)]
    if heaviest and first_dead_later:
        assert max(heaviest) < min(first_dead_later)


# ---- the plain version at the new forms -----------------------------------------

# (head_dim, query group, dtype, page size, form, block): each head dim
# in a unified and a verify block, over int8 at each; per layer and
# stacked; pages 8, 16 and 48; both 16-bit types.
POINTS = [(200, 3, "bf16", 8, "plain", "unified"),
          (200, 1, "f16", 16, "int8", "verify"),
          (256, 3, "f16", 48, "int8", "unified"),
          (256, 1, "bf16", 16, "stacked", "verify"),
          (257, 3, "bf16", 16, "int8", "verify"),
          (257, 1, "f16", 8, "plain", "unified"),
          (320, 3, "f16", 8, "stacked", "unified"),
          (320, 1, "bf16", 48, "int8", "verify"),
          (384, 1, "bf16", 16, "plain", "unified"),
          (384, 3, "f16", 48, "int8", "verify"),
          (512, 3, "bf16", 48, "int8", "unified"),
          (512, 1, "f16", 8, "stacked", "verify")]
IDS = [f"d{d}-g{g}-{t}-ps{ps}-{f}-{b}" for d, g, t, ps, f, b in POINTS]
# (W, [(kv_len, last_index), ...]): a unified block (a decode row, a
# first chunk, a chunk past the 128-token edge, a pad row) and a verify
# block (draft lens 0, 2 and 4, a pad row).
BLOCKS = {"unified": (24, [(40, 0), (24, 23), (147, 16), (0, -1)]),
          "verify": (5, [(23, 0), (140, 2), (64, 4), (0, -1)])}


@pytest.mark.parametrize("d,group,dtype,page,form,block", POINTS, ids=IDS)
def test_plain_walk_with_16_bit_probabilities_matches_pallas(
        d, group, dtype, page, form, block):
    w, rows = BLOCKS[block]
    kv_lens = np.array([n for n, _ in rows], np.int32)
    last_index = np.array([li for _, li in rows], np.int32)
    rng = np.random.RandomState(d * 10 + group)
    table, pages = _table(kv_lens, page, -(-int(kv_lens.max()) // page) + 1)
    jk, jv, tk, tv = _caches(rng, pages, d, page, form, dtype)
    q = rng.randn(len(rows), w, KV_HEADS * group, d)
    expected = _first(jax_paged_ragged_attention(
        _j(q, dtype), jk, jv, jnp.asarray(table), jnp.asarray(kv_lens),
        jnp.asarray(np.maximum(last_index, 0)), interpret=True,
        **_layer(form)))
    torch_dtype = DTYPES[dtype][0]
    args = (_t(q, dtype), tk, tv, _i(table), _i(kv_lens), _i(last_index))
    got = paged_ragged_attention_plain(*args, p_dtype=torch_dtype,
                                       **_layer(form))
    _close(got, expected, dtype)
    live = ((np.arange(w)[None] <= last_index[:, None])
            & (kv_lens[:, None] > 0))
    assert not got[torch.from_numpy(~live)].any()  # exact 0
    cache = torch.int8 if form == "int8" else torch_dtype
    assert ragged_walk_plan(torch_dtype, cache, group, w, d, page)[
        "walk"] == ("wgmma" if d <= 256 else "wgmma_wide")
    # The CPU wrapper takes the plain version (the f32 walk).
    assert torch.equal(paged_ragged_attention(*args, **_layer(form)),
                       paged_ragged_attention_plain(*args, **_layer(form)))


def test_wide_widths_cover_the_wgmma_head_dims():
    assert WG_WIDE_WIDTHS == (384, 512)
    assert all(ragged_walk_plan(torch.bfloat16, torch.bfloat16, 3, 5, d,
                                16)["walk"] == "wgmma_wide"
               for d in range(257, 513))


def test_chip_smoke_holds_the_rows_to_the_plan():
    """``chip_smoke.py``'s geometries phase reads the library's ragged
    walk counter in RAGGED_WALKS' order and holds g3_d256 to ``wgmma``,
    g3_d512 and g1_d320 to ``wgmma_wide``, bench-1b, g4_d128 and g1_d64
    to ``mma``: the walks the plan names there (loaded from its file, so
    nothing of it runs at import)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    assert chip_smoke.RAGGED_WALKS == RAGGED_WALKS
    for row, walk in chip_smoke.RAGGED_ROW_WALKS.items():
        nh, kv, d, dtype, forms = chip_smoke.GEOMETRY_ROWS[row]
        for int8 in forms:
            assert ragged_walk_plan(dtype, torch.int8 if int8 else dtype,
                                    nh // kv, 512, d, 128)["walk"] == walk
    assert set(chip_smoke.RAGGED_ROW_WALKS) == {
        row for row, (_, _, d, dtype, _) in chip_smoke.GEOMETRY_ROWS.items()
        if dtype != torch.float32 and d > 128}
    for nh, kv, d in chip_smoke.RAGGED_MMA_CONTROLS.values():
        for cache in (torch.bfloat16, torch.int8):
            assert ragged_walk_plan(torch.bfloat16, cache, nh // kv, 512, d,
                                    128)["walk"] == "mma"
