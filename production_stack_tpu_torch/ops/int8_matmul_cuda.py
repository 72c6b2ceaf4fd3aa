"""Weight-only int8 projection of a decode-sized step:
``y[M, N] = (x[M, K] . q[N, K]^T) * scale[N]``.

The counterpart of the JAX package's dequantizing matmul
(production_stack_tpu/engine/quantization.py:58, ``dequant_matmul``),
which XLA computes as one dot whose int8 operand is converted on the
way in, so only int8 weight bytes cross HBM. It is no Pallas kernel,
but the plain torch form (``engine/quantization.dequant_matmul``)
writes and reads a bf16 copy of the weight on every call, about five
times the bytes of the int8 weight; the port therefore ships the
CUDA kernel of ``csrc/int8_weight_gemm.cu`` (its design is described
there) for products of at most ``INT8_KERNEL_MAX_ROWS`` rows: decode
batches, the speculative verify block, burst iterations. A larger
product (a prefill chunk, a unified step) amortises the conversion
over thousands of rows and takes the plain form; that is a fixed shape
rule of the projection (``engine/quantization.QuantLinear``), not a
fallback.

What bounds it on the card: the weight bytes, N * K int8 values read
once (plus the activations and the output), against 2 * M * N * K
operations: for M up to a few hundred rows the bytes, at M = 160 about
the tensor cores' ridge.

The 16-bit kernel (bf16 or f16 x) is one launch a product on Hopper's
warpgroup products: a tile of 64 W weight rows is split over K between
the C blocks of one thread block cluster, whose f32 partial tiles meet
through distributed shared memory, each row summed by one rank in rank
order (pushed to it up to 16 activation rows, read by it above; no
second launch, no partials in device memory, the same bits every
launch); a
producer warp fills a ring of 128-value stages of K with TMA (weights
and activations, zeros past every edge), and W consumer warpgroups run
wgmma with the weights converted in registers as A. Its plan comes from
``int8_weight_plan``, from shapes alone: the activation rows' bucket
(``W8_BUCKETS``: 8, 16, 32, 64, 128, 160, the wgmma widths the source
is built for), W and C giving the most blocks that fit one wave of the
H100's clusters (``MAX_ACTIVE_CLUSTERS``), two warpgroups a block
where several plans give that many, and the deepest ring the shared
memory holds. Every shape takes
that one kernel; no shape rule sends a small M elsewhere. An f32 x
(the tiny test model) takes an f32 FMA kernel.

``int8_weight_matmul`` launches the kernel for CUDA tensors (or
raises) and takes ``int8_weight_matmul_plain`` for CPU tensors. The
plain version is the kernel's own arithmetic: an f32 sum of exact
products, the scale in f32, one rounding to x's dtype.
"""

from __future__ import annotations

import torch

from production_stack_tpu_torch.ops.paged_kv_common import (
    COUNTERS,
    check_launch,
    dtype_code,
    kernel_lib,
    stream_ptr,
)

KERNEL_NAME = "int8_weight_matmul"

# Products of at most this many rows take the kernel; larger ones the
# dequantize-then-matmul form. From the times of the four bench-1b
# projections on an H100 (chip_smoke.py's weights phase, in PERF.md): at
# M = 160, the speculative verify block, the kernel is still faster than
# the dequantize-then-matmul form it would otherwise take.
INT8_KERNEL_MAX_ROWS = 160

# The 16-bit kernel's activation-row buckets, ascending
# (PSTT_W8_FOR_EACH_BUCKET in csrc/int8_weight_gemm.cu): a product's
# rows run at the smallest at or above them, the rows past M as zeros.
W8_BUCKETS = (8, 16, 32, 64, 128, 160)
# k values a ring stage holds, weight rows a consumer warpgroup, and the
# kernel's limits (csrc/int8_weight_gemm.cu): blocks a cluster, stages
# of the ring, a block's shared memory on an H100, the f32 padding of a
# partial tile's rows.
STAGE_K = 128
WG_ROWS = 64
MAX_CLUSTER = 8
MAX_RING = 16
MAX_SMEM = 232448
RED_PAD = 4
SCALE_BYTES = 4 * 4 * WG_ROWS
# Buckets up to this one push their partials to the summing rank,
# beside the ring; larger ones leave them in their drained ring
# (kPushMaxBucket).
PUSH_MAX_BUCKET = 16
# Clusters of C blocks an H100 80GB HBM3 (132 SMs) runs at once at the
# plans' shared memory (over 114 KB: one block an SM), by C:
# cudaOccupancyMaxActiveClusters on the card, which chip_smoke.py's
# weights phase reads again for each plan it runs
# (pstt_int8_weight_active_clusters).
MAX_ACTIVE_CLUSTERS = {1: 132, 2: 66, 3: 39, 4: 30, 5: 22, 6: 17, 7: 15,
                       8: 15}


def w8_bucket(m: int) -> int:
    """The activation-row bucket of a product of ``m`` rows."""
    for nb in W8_BUCKETS:
        if m <= nb:
            return nb
    raise ValueError(f"{m} rows exceed the kernel's {W8_BUCKETS[-1]}")


def max_warpgroups(nb: int) -> int:
    """Consumer warpgroups a block may have at the bucket ``nb`` (the
    accumulators of NB 128 and 160 leave room for three)."""
    return 3 if nb >= 128 else 4


def smem_bytes(nb: int, w: int, ring: int, c: int) -> int:
    """A block's shared memory: the ring's barriers, the tile's f32
    scales (room for four warpgroups), the slack to a 1024-byte swizzle
    atom, then the ring (each stage the [128][64 w] int8 weight tile and
    the [128][nb] activations) and the partials: up to PUSH_MAX_BUCKET
    those a rank receives (from each of the c ranks, ceil(nb / c) rows
    of 64 w + RED_PAD f32) beside the ring, above it the block's own
    partial tile ([nb][64 w + RED_PAD] f32) over the drained ring."""
    stage = WG_ROWS * w * STAGE_K + nb * STAGE_K * 2
    row = (WG_ROWS * w + RED_PAD) * 4
    body = (ring * stage + c * -(-nb // c) * row if nb <= PUSH_MAX_BUCKET
            else max(ring * stage, nb * row))
    return 16 * ring + SCALE_BYTES + 1024 + body


def int8_weight_plan(m: int, n: int, k: int, dtype: torch.dtype) -> dict:
    """The 16-bit kernel's plan for x [m, k] (bf16 or f16) against q
    [n, k], from shapes alone.

    ``bucket``: the activation rows a block runs (``W8_BUCKETS``);
    ``warpgroups`` W and ``tile_rows`` 64 W; ``tiles`` over N;
    ``cluster`` C, the blocks splitting K; ``stage_k`` (128) and
    ``stages`` (ceil(k / 128); the last one's tail zero-filled);
    ``stages_a_rank``: rank r takes stages [r per, (r + 1) per), every
    rank at least one; ``ring``: the deepest ring under MAX_SMEM (at
    most MAX_RING); ``smem``; ``blocks``: tiles x C. W and C give the
    most blocks that fit one wave (tiles <= MAX_ACTIVE_CLUSTERS[C]),
    then W nearest 2, then the smallest C (two warpgroups a block were
    the fastest of the plans with the most blocks at bench-1b's qkv, o
    and down on an H100, PERF.md); where no W fits N in one wave, the
    widest tile at C = 1."""
    if dtype not in (torch.bfloat16, torch.float16):
        raise ValueError(f"the wgmma kernel takes bfloat16 or float16, "
                         f"not {dtype}")
    if k <= 0 or k % 16:
        raise ValueError(f"K = {k} must be a positive multiple of 16")
    nb = w8_bucket(max(m, 1))
    stages = -(-k // STAGE_K)
    best = None
    for w in range(1, max_warpgroups(nb) + 1):
        tiles = -(-n // (WG_ROWS * w))
        for c in range(1, min(MAX_CLUSTER, stages) + 1):
            per = -(-stages // c)
            if (c - 1) * per >= stages or tiles > MAX_ACTIVE_CLUSTERS[c]:
                continue
            key = (tiles * c, -abs(w - 2), -c)
            if best is None or key > best[0]:
                best = (key, w, c, per)
    if best is None:
        w, c, per = max_warpgroups(nb), 1, stages
    else:
        _, w, c, per = best
    ring = max(r for r in range(1, MAX_RING + 1)
               if smem_bytes(nb, w, r, c) <= MAX_SMEM)
    tiles = -(-n // (WG_ROWS * w))
    return {"bucket": nb, "warpgroups": w, "tile_rows": WG_ROWS * w,
            "tiles": tiles, "cluster": c, "stage_k": STAGE_K,
            "stages": stages, "stages_a_rank": per, "ring": ring,
            "smem": smem_bytes(nb, w, ring, c), "blocks": tiles * c}


def _check(x2: torch.Tensor, q: torch.Tensor, scale: torch.Tensor
           ) -> None:
    dev = x2.device
    if dev.type != "cuda":
        raise ValueError("kernel operands must be CUDA tensors")
    if x2.dtype not in (torch.bfloat16, torch.float16, torch.float32):
        raise ValueError(f"x must be bfloat16, float16 or float32, got "
                         f"{x2.dtype}")
    if q.device != dev or q.dtype != torch.int8 or q.dim() != 2:
        raise ValueError(f"q must be a [N, K] int8 tensor on {dev}")
    if (scale.device != dev or scale.dtype != torch.float32
            or tuple(scale.shape) != (q.shape[0],)):
        raise ValueError(f"scale must be float32 [{q.shape[0]}] on {dev}")
    for name, t in (("x", x2), ("q", q), ("scale", scale)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    k = q.shape[1]
    if x2.shape[1] != k:
        raise ValueError(f"x has {x2.shape[1]} columns, q {k}")
    step = 4 if x2.dtype == torch.float32 else 16
    if k % step:
        raise ValueError(f"K = {k} must be a multiple of {step} for "
                         f"{x2.dtype} activations")
    if x2.shape[0] > INT8_KERNEL_MAX_ROWS:
        raise ValueError(f"{x2.shape[0]} rows: the kernel takes at most "
                         f"INT8_KERNEL_MAX_ROWS = {INT8_KERNEL_MAX_ROWS}")


def int8_weight_matmul(x: torch.Tensor, q: torch.Tensor,
                       scale: torch.Tensor) -> torch.Tensor:
    """``(x @ q^T) * scale`` in x's dtype: x [..., K] (bf16, f16 or f32),
    q [N, K] int8, scale [N] f32 -> [..., N].

    CPU tensors take the plain version; CUDA tensors launch the kernel
    or raise (more than ``INT8_KERNEL_MAX_ROWS`` rows, another dtype, a
    K the kernel does not tile, a non-contiguous operand)."""
    k = q.shape[-1]
    x2 = x.reshape(-1, k)
    if x.device.type == "cpu":
        return int8_weight_matmul_plain(x, q, scale)
    _check(x2, q, scale)
    m, n = x2.shape[0], q.shape[0]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if x.dtype != torch.float32:  # the wgmma kernel, bf16 or f16
        p = int8_weight_plan(m, n, k, x.dtype)
        plan = (p["bucket"], p["warpgroups"], p["cluster"],
                p["stages_a_rank"], p["ring"], p["smem"])
    else:
        plan = (0,) * 6
    err = kernel_lib().pstt_int8_weight_matmul(
        dtype_code(x.dtype), x2.data_ptr(), q.data_ptr(),
        scale.data_ptr(), out.data_ptr(), m, n, k, *plan, stream_ptr())
    check_launch(KERNEL_NAME, err)
    COUNTERS.launched(KERNEL_NAME)
    return out.reshape(*x.shape[:-1], n)


def int8_weight_matmul_plain(x: torch.Tensor, q: torch.Tensor,
                             scale: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic in torch: f32 products summed in f32,
    times the f32 scale, rounded once to x's dtype."""
    if x.is_cuda:
        COUNTERS.plain_on_cuda(KERNEL_NAME)
    out = torch.matmul(x.float(), q.float().t()) * scale.float()
    return out.to(x.dtype)
