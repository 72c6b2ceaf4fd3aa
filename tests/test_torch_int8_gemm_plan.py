"""The int8-weight GEMM's plan (``ops/int8_matmul_cuda.int8_weight_plan``),
as far as the CPU can hold it.

The kernel (csrc/int8_weight_gemm.cu: one launch a product, the K split
reduced inside a thread block cluster, a TMA ring, wgmma with the
weights converted in registers) runs only on the card, where
tests/test_torch_cuda_kernels.py and ``chip_smoke.py`` hold it against
its plain version. Here:

- the host's constants against the source's (the activation buckets,
  the stage's k values, a warpgroup's rows, the cluster, ring and
  shared-memory limits, the warpgroup rule), and a wgmma width in
  wgmma.cuh for every bucket in both 16-bit types;
- the plan at every M from 1 to 160, at bench-1b's four projections,
  OPT-2.7b's fc1 and tile-edge shapes (N 200, K 192, K 2816 for a tp-2
  ``down``): the bucket is the smallest at or above M, the cluster at
  most 8 blocks, the ranks' K spans cover K exactly once (each rank at
  least one stage), the shared memory is the source's formula and
  within 227 KB, the ring as deep as it allows, and the grid fits one
  wave of the card's clusters with the most blocks any (W, C) gives,
  two warpgroups where several plans give as many;
- the plan's refusals (an f32 x, a K that is not a multiple of 16,
  more than 160 rows);
- the port's product (the plain version on the CPU) against the JAX
  package's ``dequant_matmul`` at the tile-edge shapes, in bf16 and
  f16, inputs made with numpy from a seed (2e-2 of the largest output:
  JAX rounds the product to x's type before the scale).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from production_stack_tpu.engine import quantization as jax_quant
from production_stack_tpu_torch.ops.int8_matmul_cuda import (
    INT8_KERNEL_MAX_ROWS,
    MAX_ACTIVE_CLUSTERS,
    MAX_CLUSTER,
    MAX_RING,
    MAX_SMEM,
    PUSH_MAX_BUCKET,
    RED_PAD,
    STAGE_K,
    W8_BUCKETS,
    WG_ROWS,
    int8_weight_matmul,
    int8_weight_plan,
    max_warpgroups,
    smem_bytes,
)

CSRC = (Path(__file__).resolve().parents[1] / "production_stack_tpu_torch"
        / "csrc")
SRC = (CSRC / "int8_weight_gemm.cu").read_text()
WGMMA = (CSRC / "wgmma.cuh").read_text()
SMS = 132

# (K, N): bench-1b's projections, OPT-2.7b's fc1, and tile-edge shapes.
SHAPES = {"qkv": (2048, 3072), "o": (2048, 2048), "gate_up": (2048, 11264),
          "down": (5632, 2048), "fc1": (2560, 10240), "n200": (128, 200),
          "k192": (192, 2048), "down_tp2": (2816, 2048)}
DTYPES = [torch.bfloat16, torch.float16]


def _constant(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC).group(1))


def test_the_host_mirrors_the_sources_constants():
    buckets = re.search(r"#define PSTT_W8_FOR_EACH_BUCKET\(X\)([^\n]*)",
                        SRC).group(1)
    assert tuple(int(b) for b in re.findall(r"X\((\d+)\)", buckets)) \
        == W8_BUCKETS
    assert list(W8_BUCKETS) == sorted(W8_BUCKETS)
    assert W8_BUCKETS[-1] == INT8_KERNEL_MAX_ROWS
    assert _constant("kStageK") == STAGE_K
    assert _constant("kWgRows") == WG_ROWS
    assert _constant("kMaxCluster") == MAX_CLUSTER
    assert _constant("kMaxRing") == MAX_RING
    assert _constant("kMaxSmem") == MAX_SMEM
    assert _constant("kRedPad") == RED_PAD
    assert _constant("kPushMaxBucket") == PUSH_MAX_BUCKET
    rule = re.search(r"max_warpgroups\(int nb\) \{\s*return nb >= (\d+) "
                     r"\? (\d) : (\d);", SRC)
    edge, wide, narrow = (int(g) for g in rule.groups())
    for nb in W8_BUCKETS:
        assert max_warpgroups(nb) == (wide if nb >= edge else narrow)
    assert sorted(MAX_ACTIVE_CLUSTERS) == list(range(1, MAX_CLUSTER + 1))
    for c, n in MAX_ACTIVE_CLUSTERS.items():
        assert n * c <= SMS


@pytest.mark.parametrize("dtype", ["__nv_bfloat16", "__half"])
def test_wgmma_has_a_register_form_at_every_bucket(dtype):
    for nb in W8_BUCKETS:
        body = WGMMA.split(f"struct Wgmma<{dtype}, {nb}> {{")[1]
        body = body.split("};")[0]
        assert f"rs(float (&d)[{nb // 8}][4]" in body
        assert f"m64n{nb}k16" in body


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f16"])
@pytest.mark.parametrize("name", list(SHAPES))
def test_the_plan_at_every_m(name, dtype):
    k, n = SHAPES[name]
    for m in range(1, INT8_KERNEL_MAX_ROWS + 1):
        p = int8_weight_plan(m, n, k, dtype)
        nb, w, c = p["bucket"], p["warpgroups"], p["cluster"]
        # The smallest bucket at or above M.
        assert nb >= m and all(b < m for b in W8_BUCKETS if b < nb)
        assert 1 <= w <= max_warpgroups(nb)
        assert p["tile_rows"] == WG_ROWS * w
        assert p["tiles"] == -(-n // p["tile_rows"])
        assert 1 <= c <= MAX_CLUSTER
        # The ranks' K spans cover K exactly once, each at least a stage.
        assert p["stage_k"] == STAGE_K
        assert p["stages"] * STAGE_K >= k > (p["stages"] - 1) * STAGE_K
        per, end = p["stages_a_rank"], 0
        for r in range(c):
            lo, hi = r * per, min((r + 1) * per, p["stages"])
            assert hi > lo and lo * STAGE_K == end
            end = min(hi * STAGE_K, k)
        assert end == k
        # Shared memory: the source's formula, within a block's 227 KB,
        # the ring as deep as it allows.
        assert p["smem"] == smem_bytes(nb, w, p["ring"], c) <= MAX_SMEM
        assert 1 <= p["ring"] <= MAX_RING
        assert (p["ring"] == MAX_RING
                or smem_bytes(nb, w, p["ring"] + 1, c) > MAX_SMEM)
        assert p["smem"] > MAX_SMEM // 2  # one block an SM
        # One wave where N allows, with the most blocks any plan gives.
        assert p["blocks"] == p["tiles"] * c
        widest = -(-n // (WG_ROWS * max_warpgroups(nb)))
        if widest > MAX_ACTIVE_CLUSTERS[1]:
            assert (w, c) == (max_warpgroups(nb), 1)
            continue
        assert p["tiles"] <= MAX_ACTIVE_CLUSTERS[c]
        assert p["blocks"] <= SMS
        for w2 in range(1, max_warpgroups(nb) + 1):
            tiles = -(-n // (WG_ROWS * w2))
            for c2 in range(1, min(MAX_CLUSTER, p["stages"]) + 1):
                per2 = -(-p["stages"] // c2)
                if ((c2 - 1) * per2 < p["stages"]
                        and tiles <= MAX_ACTIVE_CLUSTERS[c2]):
                    assert (tiles * c2, -abs(w2 - 2), -c2) <= (
                        p["blocks"], -abs(w - 2), -c)


def test_the_headline_plans():
    # gate_up at a decode batch of 32: three warpgroups, K split in two,
    # 59 tiles x 2 = 118 blocks; o at the verify block's 160 rows: 16
    # tiles of 128 rows x 6; qkv: 24 x 4.
    p = int8_weight_plan(32, 11264, 2048, torch.bfloat16)
    assert (p["bucket"], p["warpgroups"], p["cluster"], p["blocks"]) == \
        (32, 3, 2, 118)
    p = int8_weight_plan(160, 2048, 2048, torch.bfloat16)
    assert (p["bucket"], p["warpgroups"], p["cluster"], p["blocks"]) == \
        (160, 2, 6, 96)
    p = int8_weight_plan(1, 3072, 2048, torch.bfloat16)
    assert (p["bucket"], p["warpgroups"], p["cluster"], p["blocks"]) == \
        (8, 2, 4, 96)


def test_the_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="bfloat16 or float16"):
        int8_weight_plan(8, 256, 256, torch.float32)
    with pytest.raises(ValueError, match="multiple of 16"):
        int8_weight_plan(8, 256, 120, torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 16"):
        int8_weight_plan(8, 256, 0, torch.bfloat16)
    with pytest.raises(ValueError, match="exceed"):
        int8_weight_plan(INT8_KERNEL_MAX_ROWS + 1, 256, 256, torch.bfloat16)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("name", ["n200", "k192", "down_tp2"])
def test_the_product_at_tile_edges_matches_jax(name, dtype):
    k, n = SHAPES[name]
    rs = np.random.RandomState(k + n)
    w = rs.randn(k, n).astype(np.float32)
    x = rs.randn(37, k).astype(np.float32)
    jq, js = jax_quant.quantize_weight(jnp.asarray(w))
    ref = np.asarray(jax_quant.dequant_matmul(
        jnp.asarray(x, getattr(jnp, dtype)), (jq, js))).astype(np.float32)
    q = torch.from_numpy(np.array(jq)).t().contiguous()
    scale = torch.from_numpy(np.array(js))
    got = int8_weight_matmul(torch.from_numpy(x).to(getattr(torch, dtype)),
                             q, scale)
    assert got.dtype == getattr(torch, dtype) and got.shape == (37, n)
    err = np.abs(got.float().numpy() - ref).max()
    assert err <= 2e-2 * np.abs(ref).max()
