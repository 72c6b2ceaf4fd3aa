"""Paged chunked-prefill attention: T query tokens per row against the
row's pages, causal.

Replaces the Pallas TPU kernel ``paged_prefill_attention``
(production_stack_tpu/ops/prefill_attention_pallas.py:149, body
``_prefill_kernel`` at :76) with the CUDA kernel in
``csrc/paged_prefill.cu``. It serves prefill steps; unified mixed
steps and verify steps go through the ragged kernel
(ops/ragged_attention_cuda.py).

What bounds it on the card: at long T, operations. A 512-token chunk
does 4 * num_q_heads * head_dim * (visible tokens) operations per
query while the KV it reads is shared by the G * T query rows of a kv
head, so it sits far above the ~295 operations per byte ridge, and the
products have to run on the tensor cores. For bf16 and f16 queries
(over a cache of their type or int8) the kernel is the tensor-core walk
of ``csrc/paged_walk_mma.cuh``: blocks of 64 query rows (grid: query
tile, kv_head, batch; any query group, its G * T rows cut into tiles),
four warps of 16 rows with q in registers; q.k^T and p.v as
``mma.sync`` in the query's type with f32 accumulation, K and V fed by
``ldmatrix`` from the pages as they lie (token-minor, nothing
transposed); scores, probabilities, m, l and the output accumulator in
registers (softmax with quad shuffles and ``exp2f``), the probabilities
packed to the query's type in place as the next product's operand; K/V
staged in 16 bits through two stages of asynchronous copies (68 KB a
block, three blocks an SM, at head_dim 64); the mask compared only
where it cuts. An int8 cache (a QuantKV) stages its raw pages and
scales with the same copies, converts each chunk once to the query's
type (exact) and folds the scales into the scores and the
probabilities in the Pallas order. A tile stops walking at the last
chunk its highest query position can see. f32 queries (held to 1e-4)
keep the f32 FMA walk of ``csrc/paged_kv_common.cuh``. Any head_dim
from 1 to 256, run at its tile (32, 64, 80, 128 or 256,
``paged_kv_common.kernel_head_dim_tile``) and padded in the kernel
below it, as the Pallas kernel pads head_dim to its lane tile: no copy
of q or of the cache. At the tile 256 the walk stages half a chunk at a
time and reads q from shared memory. Above 256, as slabs of 128
(``paged_kv_common.kernel_head_dim_slabs``): a block writes one slab of
the output, sums the scores over every slab (q and K staged a slab at
a time) and takes p . v from its own V slab.

Contract (the Pallas kernel's): q [B, T, num_q_heads, head_dim]; the
per-layer or, with ``layer``, the stacked cache, as the decode kernel
takes them (ops/paged_attention_cuda.py); q_positions [B, T] int32
contiguous per row — only the row start ``q_positions[:, 0]`` reaches
the kernel, which rebuilds query t's position as start + t (pad slots
included); mask ``token_pos <= q_pos & token_pos < kv_len``; a row
with kv_len 0 writes exact 0.
"""

from __future__ import annotations

from typing import Optional

import torch

from production_stack_tpu_torch.ops.paged_kv_common import (
    COUNTERS,
    cache_code,
    check_cache,
    check_kernel_operands,
    check_launch,
    counter_name,
    data_ptr,
    dtype_code,
    kernel_lib,
    layer_args,
    page_walk_plain,
    split_cache,
    stream_ptr,
)

KERNEL_NAME = "paged_prefill"


def paged_prefill_attention(q: torch.Tensor, k_cache: torch.Tensor,
                            v_cache: torch.Tensor,
                            page_table: torch.Tensor,
                            q_positions: torch.Tensor,
                            kv_lens: torch.Tensor,
                            layer: Optional[int] = None) -> torch.Tensor:
    """Chunked-prefill attention against a sequence's cached pages.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (its int8 form for a QuantKV cache, its stacked form with
    ``layer``) or raise. Raises ValueError on bare int8 pages without
    their scales and on a cache rank that disagrees with ``layer``.
    """
    check_cache(k_cache, v_cache, layer)
    if q.device.type == "cpu":
        return paged_prefill_attention_plain(
            q, k_cache, v_cache, page_table, q_positions, kv_lens, layer)
    kc, vc, ks, vs = split_cache(k_cache, v_cache)
    b, t, num_q_heads, head_dim = q.shape
    num_kv_heads, num_pages, _, page_size = kc.shape[-4:]
    out = torch.empty_like(q)
    check_kernel_operands(
        q, kc, vc,
        (("page_table", page_table), ("q_positions", q_positions),
         ("kv_lens", kv_lens)), out, ks, vs)
    if (kv_lens.shape != (b,) or page_table.shape[0] != b
            or q_positions.shape != (b, t)):
        raise ValueError("page_table/q_positions/kv_lens rows must "
                         "match the batch")
    name = counter_name(KERNEL_NAME, ks, layer)
    err = kernel_lib().pstt_paged_prefill(
        dtype_code(q.dtype), cache_code(kc.dtype), q.data_ptr(),
        kc.data_ptr(), vc.data_ptr(), data_ptr(ks), data_ptr(vs),
        page_table.data_ptr(), q_positions.data_ptr(),
        kv_lens.data_ptr(), out.data_ptr(), b, t, num_q_heads,
        num_kv_heads, head_dim, num_pages, page_size,
        page_table.shape[1], *layer_args(kc, ks, layer), stream_ptr())
    check_launch(name, err)
    COUNTERS.launched(name)
    return out


def paged_prefill_attention_plain(q: torch.Tensor, k_cache: torch.Tensor,
                                  v_cache: torch.Tensor,
                                  page_table: torch.Tensor,
                                  q_positions: torch.Tensor,
                                  kv_lens: torch.Tensor,
                                  layer: Optional[int] = None,
                                  p_dtype: Optional[torch.dtype] = None
                                  ) -> torch.Tensor:
    """The kernel's function in plain torch: the same chunked page walk,
    query positions rebuilt as ``q_positions[:, 0] + t``, the causal
    mask, the online softmax and, for a QuantKV cache, the same fold of
    its scales; a stacked cache is walked at ``layer``. ``p_dtype`` =
    the query's 16-bit type gives the tensor-core kernel's rounding:
    the probabilities enter p . v rounded to it while l sums the
    unrounded ones. The default is the f32 walk."""
    check_cache(k_cache, v_cache, layer)
    kc, vc, ks, vs = split_cache(k_cache, v_cache)
    if q.is_cuda:
        COUNTERS.plain_on_cuda(counter_name(KERNEL_NAME, ks, layer))
    b, t, num_q_heads, head_dim = q.shape
    num_kv_heads = kc.shape[-4]
    group = num_q_heads // num_kv_heads
    # Rows of one kv head's block are (g, t) flattened g-major, as in
    # the kernel: row r is query head g = r // T at chunk offset r % T.
    qg = (q.reshape(b, t, num_kv_heads, group, head_dim)
          .permute(0, 2, 3, 1, 4)
          .reshape(b, num_kv_heads, group * t, head_dim))
    rows = torch.arange(group * t, device=q.device)
    q_pos = (q_positions[:, :1].long()
             + (rows % t)[None, :])[:, None, :, None]  # [B, 1, R, 1]
    kv = kv_lens.long()[:, None, None, None]
    out = page_walk_plain(qg, kc, vc, page_table, kv_lens,
                          lambda pos: (pos <= q_pos) & (pos < kv), ks, vs,
                          layer, p_dtype=p_dtype)
    return (out.reshape(b, num_kv_heads, group, t, head_dim)
            .permute(0, 3, 1, 2, 4)
            .reshape(b, t, num_q_heads, head_dim).to(q.dtype))
