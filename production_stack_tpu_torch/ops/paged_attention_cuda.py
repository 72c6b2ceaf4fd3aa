"""Paged decode attention: one query token per row against its pages.

Replaces the Pallas TPU kernel ``paged_decode_attention``
(production_stack_tpu/ops/paged_attention_pallas.py:147, body
``_decode_kernel`` at :86) with the CUDA kernel in
``csrc/paged_decode.cu``.

What bounds it on the card: the bytes of the cached K and V. A step
reads 2 * kv_len * kv_heads * head_dim elements for 4 * num_q_heads *
head_dim * kv_len operations — about one operation per byte in bf16,
far below the ~295 operations per byte where the H100's tensor cores
and not its memory become the limit. The design therefore reads each
KV byte once per step: the grid is (batch, kv_head), so the G query
heads that share a kv head share every staged page; pages arrive with
16-byte coalesced loads into shared memory; the walk stops at
ceil(kv_len / 128) chunks; a pad row (kv_len 0) loads nothing and
writes exact 0. An int8 cache (a QuantKV: int8 pages, one f32 scale
per kv head, page and slot) halves those bytes: the kernel stages the
int8 pages with the same 16-byte loads (16 tokens a load) and each
chunk's 128 K and V scales beside them, and folds them in as the
Pallas kernel does. Not yet done: a split-KV variant that puts more
blocks on the card at small batch, and asynchronous copies that
overlap the next page with the current one's arithmetic.

Contract (the Pallas kernel's): q [B, num_q_heads, head_dim];
k/v cache [kv_heads, num_pages, head_dim, page_size] (token-minor
pages), or the stacked [L, kv_heads, ...] cache with ``layer`` (read in
place at that layer, never sliced into a copy), full precision or a
QuantKV of that layout; page_table [B, max_pages] int32; kv_lens [B]
int32; attends positions < kv_len; returns [B, num_q_heads,
head_dim].
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

KERNEL_NAME = "paged_decode"


def paged_decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor,
                           page_table: torch.Tensor,
                           kv_lens: torch.Tensor,
                           layer: Optional[int] = None) -> torch.Tensor:
    """Single-token paged attention.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (its int8 form for a QuantKV cache, its stacked form with
    ``layer``) or raise. Raises ValueError on bare int8 pages without
    their scales and on a cache rank that disagrees with ``layer``.
    """
    check_cache(k_cache, v_cache, layer)
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_cache, v_cache,
                                            page_table, kv_lens, layer)
    kc, vc, ks, vs = split_cache(k_cache, v_cache)
    b, num_q_heads, head_dim = q.shape
    num_kv_heads, num_pages, _, page_size = kc.shape[-4:]
    out = torch.empty_like(q)
    check_kernel_operands(
        q, kc, vc, (("page_table", page_table), ("kv_lens", kv_lens)),
        out, ks, vs)
    if kv_lens.shape != (b,) or page_table.shape[0] != b:
        raise ValueError("page_table/kv_lens rows must match the batch")
    name = counter_name(KERNEL_NAME, ks, layer)
    err = kernel_lib().pstt_paged_decode(
        dtype_code(q.dtype), cache_code(kc.dtype), q.data_ptr(),
        kc.data_ptr(), vc.data_ptr(), data_ptr(ks), data_ptr(vs),
        page_table.data_ptr(), kv_lens.data_ptr(), out.data_ptr(), b,
        num_q_heads, num_kv_heads, head_dim, num_pages, page_size,
        page_table.shape[1], *layer_args(kc, ks, layer), stream_ptr())
    check_launch(name, err)
    COUNTERS.launched(name)
    return out


def paged_decode_attention_plain(q: torch.Tensor, k_cache: torch.Tensor,
                                 v_cache: torch.Tensor,
                                 page_table: torch.Tensor,
                                 kv_lens: torch.Tensor,
                                 layer: Optional[int] = None
                                 ) -> torch.Tensor:
    """The kernel's function in plain torch: the same chunked page walk
    with mask ``pos < kv_len``, the same online softmax and, for a
    QuantKV cache, the same fold of its scales; a stacked cache is
    walked at ``layer``."""
    check_cache(k_cache, v_cache, layer)
    kc, vc, ks, vs = split_cache(k_cache, v_cache)
    if q.is_cuda:
        COUNTERS.plain_on_cuda(counter_name(KERNEL_NAME, ks, layer))
    b, num_q_heads, head_dim = q.shape
    num_kv_heads = kc.shape[-4]
    qg = q.reshape(b, num_kv_heads, num_q_heads // num_kv_heads,
                   head_dim)
    kv = kv_lens.long()[:, None, None, None]
    out = page_walk_plain(qg, kc, vc, page_table, kv_lens,
                          lambda pos: pos < kv, ks, vs, layer)
    return out.reshape(b, num_q_heads, head_dim).to(q.dtype)
