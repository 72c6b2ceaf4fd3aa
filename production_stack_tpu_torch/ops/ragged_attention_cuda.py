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
rows walks the row's pages once for all of them. For bf16 queries (over
a bf16 or an int8 cache) the walk is the prefill kernel's tensor-core
walk (``csrc/paged_walk_mma.cuh``: four warps of 16 rows, bf16
``mma.sync``, probabilities entering p.v as bf16, K/V through two
stages of asynchronous copies, three blocks an SM), one row block for
every tile: a warp with no live row skips its products, so a decode
row's tile (G live rows) multiplies on one warp and a verify row's
((K + 1) * G) on two. f32 queries (tiny-llama, held to 1e-4) keep the
f32 FMA walk with a narrow row block. An int8 cache (a QuantKV) stages
as int8 pages and their per-slot scales, folded in as in the Pallas
kernel.

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

KERNEL_NAME = "paged_ragged"


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
    as in the kernel. ``p_dtype`` = torch.bfloat16 gives the tensor-core
    kernel's rounding: the probabilities enter p . v rounded to bf16
    while l sums the unrounded ones. The default is the f32 walk."""
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
