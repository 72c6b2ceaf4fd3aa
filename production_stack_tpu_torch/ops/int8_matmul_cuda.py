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
operations: for M up to a few hundred rows the bytes.

``int8_weight_matmul`` launches the kernel for CUDA tensors (or
raises) and takes ``int8_weight_matmul_plain`` for CPU tensors. The
plain version is the kernel's own arithmetic: an f32 sum of exact
products, the scale in f32, one rounding to x's dtype.
"""

from __future__ import annotations

from typing import Tuple

import torch

from production_stack_tpu_torch.ops.paged_kv_common import (
    COUNTERS,
    check_launch,
    data_ptr,
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

# Activation rows a tile of the 16-bit (bf16 or f16) kernel, and the
# row tiles it is built for with the 64-value steps of K a chunk holds
# at each (PSTT_W8_FOR_EACH_TILES in csrc/int8_weight_gemm.cu): the
# activations' chunk, staged in shared memory, stays under 48 KB.
ROWS_A_TILE = 8
X_TILES = {1: 4, 2: 4, 4: 4, 8: 4, 12: 2, 16: 2, 20: 2}
# Weight rows a block (eight warps of 16).
BLOCK_ROWS = 128
STEP_K = 64
# Blocks a launch aims to put on the card: two for each of the H100's
# 132 SMs (a split over K adds them where N alone gives too few).
TARGET_BLOCKS = 2 * 132


def x_tiles(m: int) -> int:
    """The bf16 kernel's activation row tiles for ``m`` rows."""
    need = -(-m // ROWS_A_TILE)
    for tiles in X_TILES:
        if need <= tiles:
            return tiles
    raise ValueError(f"{m} rows exceed the kernel's "
                     f"{ROWS_A_TILE * max(X_TILES)}")


def int8_weight_splits(m: int, n: int, k: int) -> Tuple[int, int]:
    """(splits, K values a split) of a bf16 launch, from shapes only.

    A split is a whole number of chunks (64 * X_TILES[tiles] values).
    Blocks over N come first; the split over K grows until the launch
    reaches ``TARGET_BLOCKS``, as long as the f32 partial sums (splits *
    m * n * 4 bytes) stay within the weight's own bytes."""
    chunk = STEP_K * X_TILES[x_tiles(max(m, 1))]
    chunks = -(-k // chunk)
    blocks_n = -(-n // BLOCK_ROWS)
    want = -(-TARGET_BLOCKS // blocks_n)
    splits = max(1, min(want, chunks, k // (4 * max(m, 1))))
    per = -(-chunks // splits) * chunk
    return -(-k // per), per


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
    step = 4 if x2.dtype == torch.float32 else STEP_K
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
    if x.dtype != torch.float32:  # the tensor-core kernel, bf16 or f16
        tiles = x_tiles(max(m, 1))
        splits, per = int8_weight_splits(m, n, k)
    else:
        tiles, splits, per = 0, 1, k
    partial = (torch.empty((splits, m, n), dtype=torch.float32,
                           device=x.device) if splits > 1 else None)
    err = kernel_lib().pstt_int8_weight_matmul(
        dtype_code(x.dtype), x2.data_ptr(), q.data_ptr(),
        scale.data_ptr(), out.data_ptr(), data_ptr(partial), m, n, k,
        tiles, splits, per, stream_ptr())
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
