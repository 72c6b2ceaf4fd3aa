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
products have to run on the tensor cores at Hopper's rate: ``wgmma``.
For bf16 and f16 queries (over a cache of their type or int8) up to
head_dim 256 the kernel is the walk of ``csrc/paged_walk_wgmma.cuh``
(grid: kv head, batch, query tile heaviest first; any query group, its
G * T rows cut into tiles of 128 rows, or 64 where they fit in 64): a
block is one or two consumer warpgroups of 64 rows and a producer
warpgroup (``setmaxnreg``: 56 registers against 224). The producer
resolves a span's page ids once and fills a ring of 2 to 4 stages, each
the K and V of 64 tokens in the 128-byte swizzle that ``wgmma``
descriptors read, with ``cp.async`` copies (16 bytes a copy at every
page that is a power of two of 16 bytes or more, as wide as the page
row allows at any other) that report to an ``mbarrier``; an int8 cache
(a QuantKV) is copied raw into a ring of its own and converted to the
query's type (exact) by the producer, off the consumers' path, its
scales staged beside it. The consumers run q . k^T (m64n64k16, K as it
lies: the transpose bit) and p . v (m64nDk16, V as it lies) as
``wgmma`` from shared memory with q and p as register operands (q from
a swizzled shared tile at head_dim 256), the scores, the online softmax
(``exp2f``, the int8 scales folded in the Pallas order) and the output
in registers, and release each stage to the producer on a second
barrier. ``prefill_walk_plan`` mirrors the plan. f32 queries (held to
1e-4) keep the f32 FMA walk of ``csrc/paged_kv_common.cuh``. Any
head_dim from 1 to 256 runs at its tile (32, 64, 80, 128 or 256,
``paged_kv_common.kernel_head_dim_tile``), padded in the kernel below
it, as the Pallas kernel pads head_dim to its lane tile: no copy of q
or of the cache. From 257 to 512, bf16 and f16 queries take the wgmma
walk's wide form at a width of 384 or 512 (``wide_head_dim_width``,
padded below it): a 64-row tile goes to both consumer warpgroups, each
running q . k^T over the whole width (the same m, l and p in both) and
p . v over half of the output dims, K and V in a ring of single
planes. f32 queries above 256, and 16-bit ones above 512, run as slabs
of 128 (``paged_kv_common.kernel_head_dim_slabs``), 16-bit on the
``mma.sync`` slab walk of ``csrc/paged_walk_mma.cuh``: a block writes
one slab of the output, sums the scores over every slab (q and K
staged a slab at a time) and takes p . v from its own V slab.

Contract (the Pallas kernel's): q [B, T, num_q_heads, head_dim]; the
per-layer or, with ``layer``, the stacked cache, as the decode kernel
takes them (ops/paged_attention_cuda.py); q_positions [B, T] int32
contiguous per row — only the row start ``q_positions[:, 0]`` reaches
the kernel, which rebuilds query t's position as start + t (pad slots
included); mask ``token_pos <= q_pos & token_pos < kv_len``; a row
with kv_len 0 writes exact 0.
"""

from __future__ import annotations

from typing import Dict, Optional

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
    kernel_head_dim_slabs,
    kernel_lib,
    layer_args,
    page_walk_plain,
    split_cache,
    stream_ptr,
)
# The wgmma walk's plan, shared with the ragged kernel (the constants
# also named here by the tools and the tests).
from production_stack_tpu_torch.ops.wgmma_plan import (  # noqa: F401
    MAX_BLOCK_SMEM,
    WG_MAX_CONSUMERS,
    WG_MAX_STAGES,
    WG_ROWS,
    WG_SPAN_TOKENS,
    WG_WIDE_WIDTHS,
    wg_consumers,
    wg_copies,
    wg_smem,
    wide_head_dim_width,
)

KERNEL_NAME = "paged_prefill"


def prefill_walk_plan(dtype: torch.dtype, cache_dtype: torch.dtype,
                      group: int, tokens: int, head_dim: int,
                      page_size: int) -> Dict[str, object]:
    """The walk the prefill kernel runs on the card for these shapes,
    as the launch picks it: ``walk`` is ``wgmma`` (bf16 or f16 queries
    up to head_dim 256), ``wgmma_wide`` (16-bit at 257 to 512),
    ``mma_slab`` (16-bit above 512) or ``f32``. For the wgmma walk: the
    head-dim ``tile``, ``consumers`` warpgroups (one where the G * T
    rows fit in 64) and ``tile_rows``, ring ``stages`` and int8
    ``raw_stages``, the producer's ``copies`` (``pages``: whole-page
    16-byte copies at a power of two of 16 bytes or more; ``tokens``
    otherwise), ``q_slots`` and ``smem_bytes`` a block. For its wide
    form: the ``width``, two consumers over ``tile_rows`` 64, ring
    ``slots`` of one plane, ``raw_stages``, ``copies``, ``q_slots`` and
    ``smem_bytes``."""
    int8 = cache_dtype == torch.int8
    copies = wg_copies(int8, page_size)
    slabs, tile = kernel_head_dim_slabs(head_dim)
    if dtype == torch.float32:
        return {"walk": "f32", "tile": tile, "tile_rows": 64}
    width = wide_head_dim_width(head_dim)
    if width is not None:
        slots, raw, smem = wg_smem(int8, width)
        return {"walk": "wgmma_wide", "width": width,
                "consumers": WG_MAX_CONSUMERS, "tile_rows": WG_ROWS,
                "slots": slots, "raw_stages": raw, "copies": copies,
                "q_slots": 1, "smem_bytes": smem}
    if slabs > 1:
        return {"walk": "mma_slab", "tile": tile, "tile_rows": 64,
                "slabs": slabs}
    consumers = wg_consumers(group * tokens)
    stages, raw, smem = wg_smem(int8, tile)
    return {"walk": "wgmma", "tile": tile, "consumers": consumers,
            "tile_rows": consumers * WG_ROWS, "stages": stages,
            "raw_stages": raw, "copies": copies,
            "q_slots": 1 if tile > 128 else 2, "smem_bytes": smem}


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
