"""Paged ragged attention: the unified step's [R, W] block, one row
descriptor per row.

Replaces the Pallas TPU kernel ``paged_ragged_attention``
(production_stack_tpu/ops/ragged_attention_pallas.py:174, body
``_ragged_kernel`` at :93) with the CUDA kernel in
``csrc/paged_ragged.cu``. It serves the unified mixed steps (decode
rows, prefill-chunk rows and pad rows in one block) and the
speculative verify steps (a verify row is a ragged row whose live
slots are its last token and its drafts).

What bounds it on the card: at the widest mixed step, the bytes of
the decode rows' cached K/V and of the block's output (every slot,
dead ones included, is written); the chunk rows' arithmetic comes
next. The prefill kernel the unified step used before computed every
slot of a decode row against the row's whole cache — 511 of 512 slots
were pad. This kernel masks them per row: query rows are flattened
slot-major, so a row's live slots are one prefix of its tiles; a tile
past them writes zeros without reading K/V, and a tile with few live
rows walks the row's pages once for all of them. For bf16 and f16
queries (over a cache of their type or int8) the walk is the prefill
kernel's tensor-core walk (``csrc/paged_walk_mma.cuh``: four warps of 16
rows, ``mma.sync`` in the query's type, probabilities entering p.v in
that type, K/V through two stages of asynchronous copies, three blocks
an SM at head_dim 64), one row block for every tile: a warp with no
live row skips its products, so a decode row's tile (G live rows)
multiplies on one warp and a verify row's ((K + 1) * G) on two. f32
queries (held to 1e-4) keep the f32 FMA walk with a narrow row block.
An int8 cache (a QuantKV) stages as int8 pages and their per-slot
scales, folded in as in the Pallas kernel. Any query group; any
head_dim from 1 to 256, run at its tile (32, 64, 80, 128 or 256,
``paged_kv_common.kernel_head_dim_tile``) and padded in the kernel
below it, as the Pallas kernel pads head_dim to its lane tile; above
256, as slabs of 128 (``paged_kv_common.kernel_head_dim_slabs``), a
block one output slab, the scores summed over every slab.

Which walk serves which form (``ragged_walk_plan`` mirrors the launch;
the library's ``pstt_ragged_walk_launches`` counts each): bf16 and f16
up to head_dim 128 take the ``mma.sync`` walk above (``mma``); from 129
to 256, the prefill kernel's ``wgmma`` walk
(``csrc/paged_walk_wgmma.cuh``) with the ragged rows, mask and tile
order (``wgmma``: persistent blocks of a producer warpgroup and one or
two consumer warpgroups, a 128-row tile, 64 where G * W fits in 64);
from 257 to 512, its wide form at the width 384 or 512
(``wgmma_wide``: 64-row tiles, both consumers each owning half the
output dims); above 512 the ``mma.sync`` slab walk (``mma_slab``); f32
queries the f32 walk at every head_dim (``f32``). On the wgmma walk a
(row, kv head) pair's live tiles come first, heaviest first
(``ragged_wg_tile``), and the consumer warpgroups write the zeros of
dead rows (a live tile's after its output, a tile with no live row's
from every consumer); a tile with no live row takes no shared-memory
stage and no product.

Contract (the Pallas kernel's): q [R, W, num_q_heads, head_dim]; the
per-layer or, with ``layer``, the stacked cache, as the decode kernel
takes them (ops/paged_attention_cuda.py); page_table [R, max_pages],
kv_lens / last_index / draft_lens [R] int32. Slot t of row r is live
when t <= last_index[r] and sits at q_start + t with q_start = kv_len
- 1 - last_index; it attends ``token_pos <= q_start + t & token_pos <
kv_len``. Dead slots and pad rows (kv_len 0) write exact 0.
``draft_lens`` is taken and not read: a verify row's draft span masks
itself causally.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from production_stack_tpu_torch.ops.paged_kv_common import (
    COUNTERS,
    MAX_KERNEL_HEAD_DIM,
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
from production_stack_tpu_torch.ops.wgmma_plan import (
    WG_MAX_CONSUMERS,
    WG_ROWS,
    wg_consumers,
    wg_copies,
    wg_smem,
    wide_head_dim_width,
)

KERNEL_NAME = "paged_ragged"
# The walks, by their index in the library's pstt_ragged_walk_launches
# (csrc/paged_ragged.cu).
RAGGED_WALKS = ("mma", "wgmma", "wgmma_wide", "mma_slab", "f32")


def ragged_wg_tile(z: int, live_tiles: int) -> int:
    """The tile a (row, kv head) pair gives the wgmma walk's round ``z``
    (csrc/paged_ragged.cuh ``ragged_wg_tile``): its live tiles from the
    last (the highest slots, which see the most tokens) down, then its
    dead tiles in order."""
    return live_tiles - 1 - z if z < live_tiles else z


def ragged_live_tiles(kv_len: int, last_index: int, group: int,
                      width: int, tile_rows: int) -> int:
    """Tiles of ``tile_rows`` slot-major rows holding a pair's live rows:
    ceil((last_index + 1) * G / tile_rows), 0 for a pad row (kv_len 0)."""
    last = last_index if kv_len > 0 else -1
    live = max(0, (min(last, width - 1) + 1) * group)
    return -(-live // tile_rows)


def ragged_walk_plan(dtype: torch.dtype, cache_dtype: torch.dtype,
                     group: int, width: int, head_dim: int,
                     page_size: int) -> Dict[str, object]:
    """The walk the ragged kernel runs on the card for a block of width
    ``width`` (W), as the launch picks it: ``walk`` is ``mma`` (bf16 or
    f16 up to head_dim 128), ``wgmma`` (16-bit at 129 to 256),
    ``wgmma_wide`` (16-bit at 257 to 512), ``mma_slab`` (16-bit above
    512) or ``f32``. For the wgmma walk: the head-dim ``tile`` (256),
    ``consumers`` warpgroups (one where the G * W rows of a pair fit in
    64, else two: prefill's rule) and ``tile_rows``, ring ``stages`` and
    int8 ``raw_stages``, the producer's ``copies`` (``pages`` or
    ``tokens``), ``q_slots`` and ``smem_bytes`` a block: prefill's plan
    at the same tile (the same WgSmem). For its wide form: the
    ``width``, two consumers over ``tile_rows`` 64, ring ``slots`` of
    one plane, ``raw_stages``, ``copies``, ``q_slots`` and
    ``smem_bytes``."""
    int8 = cache_dtype == torch.int8
    copies = wg_copies(int8, page_size)
    slabs, tile = kernel_head_dim_slabs(head_dim)
    if dtype == torch.float32:
        return {"walk": "f32", "tile": tile, "tile_rows": 64}
    wide = wide_head_dim_width(head_dim)
    if wide is not None:
        slots, raw, smem = wg_smem(int8, wide)
        return {"walk": "wgmma_wide", "width": wide,
                "consumers": WG_MAX_CONSUMERS, "tile_rows": WG_ROWS,
                "slots": slots, "raw_stages": raw, "copies": copies,
                "q_slots": 1, "smem_bytes": smem}
    if slabs > 1:
        return {"walk": "mma_slab", "tile": tile, "tile_rows": 64,
                "slabs": slabs}
    if tile < MAX_KERNEL_HEAD_DIM:
        return {"walk": "mma", "tile": tile, "tile_rows": 64}
    consumers = wg_consumers(group * width)
    stages, raw, smem = wg_smem(int8, tile)
    return {"walk": "wgmma", "tile": tile, "consumers": consumers,
            "tile_rows": consumers * WG_ROWS, "stages": stages,
            "raw_stages": raw, "copies": copies, "q_slots": 1,
            "smem_bytes": smem}


def paged_ragged_attention(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor,
                           page_table: torch.Tensor,
                           kv_lens: torch.Tensor,
                           last_index: torch.Tensor,
                           draft_lens: Optional[torch.Tensor] = None,
                           layer: Optional[int] = None) -> torch.Tensor:
    """Fused ragged attention over a unified [R, W] block.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (its int8 form for a QuantKV cache, its stacked form with
    ``layer``) or raise. Raises ValueError on bare int8 pages without
    their scales and on a cache rank that disagrees with ``layer``.
    """
    check_cache(k_cache, v_cache, layer)
    if q.device.type == "cpu":
        return paged_ragged_attention_plain(
            q, k_cache, v_cache, page_table, kv_lens, last_index,
            draft_lens, layer)
    kc, vc, ks, vs = split_cache(k_cache, v_cache)
    r, w, num_q_heads, head_dim = q.shape
    num_kv_heads, num_pages, _, page_size = kc.shape[-4:]
    out = torch.empty_like(q)
    ints = [("page_table", page_table), ("kv_lens", kv_lens),
            ("last_index", last_index)]
    if draft_lens is not None:
        ints.append(("draft_lens", draft_lens))
    check_kernel_operands(q, kc, vc, tuple(ints), out, ks, vs)
    if page_table.shape[0] != r or any(
            t.shape != (r,) for _, t in ints[1:]):
        raise ValueError("page_table/kv_lens/last_index/draft_lens rows "
                         "must match the block's rows")
    name = counter_name(KERNEL_NAME, ks, layer)
    err = kernel_lib().pstt_paged_ragged(
        dtype_code(q.dtype), cache_code(kc.dtype), q.data_ptr(),
        kc.data_ptr(), vc.data_ptr(), data_ptr(ks), data_ptr(vs),
        page_table.data_ptr(), kv_lens.data_ptr(), last_index.data_ptr(),
        data_ptr(draft_lens), out.data_ptr(), r, w, num_q_heads,
        num_kv_heads, head_dim, num_pages, page_size,
        page_table.shape[1], *layer_args(kc, ks, layer), stream_ptr())
    check_launch(name, err)
    COUNTERS.launched(name)
    return out


def paged_ragged_attention_plain(q: torch.Tensor, k_cache: torch.Tensor,
                                 v_cache: torch.Tensor,
                                 page_table: torch.Tensor,
                                 kv_lens: torch.Tensor,
                                 last_index: torch.Tensor,
                                 draft_lens: Optional[torch.Tensor] = None,
                                 layer: Optional[int] = None,
                                 p_dtype: Optional[torch.dtype] = None
                                 ) -> torch.Tensor:
    """The kernel's function in plain torch: the same chunked page walk
    with the ragged mask and the online softmax, dead slots zeroed; a
    stacked cache is walked at ``layer``. ``draft_lens`` is not read,
    as in the kernel. ``p_dtype`` = the query's 16-bit type gives the
    tensor-core kernel's rounding: the probabilities enter p . v rounded
    to it while l sums the unrounded ones. The default is the f32
    walk."""
    del draft_lens
    check_cache(k_cache, v_cache, layer)
    kc, vc, ks, vs = split_cache(k_cache, v_cache)
    if q.is_cuda:
        COUNTERS.plain_on_cuda(counter_name(KERNEL_NAME, ks, layer))
    r, w, num_q_heads, head_dim = q.shape
    num_kv_heads = kc.shape[-4]
    group = num_q_heads // num_kv_heads
    # Rows of one kv head's block are (t, g) flattened slot-major, as in
    # the kernel: row j is query head g = j % G at slot t = j // G.
    qg = (q.reshape(r, w, num_kv_heads, group, head_dim)
          .permute(0, 2, 1, 3, 4)
          .reshape(r, num_kv_heads, w * group, head_dim))
    slot = (torch.arange(w * group, device=q.device)
            // group)[None, None, :, None]  # [1, 1, W*G, 1]
    kv = kv_lens.long()[:, None, None, None]
    last = last_index.long()[:, None, None, None]
    q_pos = kv - 1 - last + slot
    live = (slot <= last) & (kv > 0)
    out = page_walk_plain(qg, kc, vc, page_table, kv_lens,
                          lambda pos: live & (pos <= q_pos) & (pos < kv),
                          ks, vs, layer, p_dtype=p_dtype)
    out = torch.where(live, out, 0.0)
    return (out.reshape(r, num_kv_heads, w, group, head_dim)
            .permute(0, 2, 1, 3, 4)
            .reshape(r, w, num_q_heads, head_dim).to(q.dtype))
