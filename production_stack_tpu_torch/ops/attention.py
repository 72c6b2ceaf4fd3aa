"""Attention over the paged KV cache: page writes and the gather-based
reference.

Cache layout (shared with the CUDA kernels): one
[kv_heads, num_pages, head_dim, page_size] buffer per layer, or one
stacked [L, kv_heads, num_pages, head_dim, page_size] buffer whose
writers and readers take the layer index (``cache_layout``), kv-head
axis major and each page stored token-minor, so a page is one
contiguous block. Page 0 is the engine's trash page: the allocator
never hands it out, and padded slots write there instead of needing
predication. An int8 cache is a ``QuantKV`` (ops/quant_kv.py): int8
pages plus one f32 scale per (kv head, page, slot); writes quantize,
and readers fold the scales in.

``paged_attention`` gathers a row's whole page list and runs one
softmax: the plain reference for the page-walking kernels
(ops/paged_attention_cuda.py, ops/prefill_attention_cuda.py) and the
counterpart of the JAX package's XLA path.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from production_stack_tpu_torch.ops.paged_kv_common import (
    validate_layer_arg,
)
from production_stack_tpu_torch.ops.quant_kv import QuantKV, quantize_kv

NEG_INF = -1e30

Cache = Union[torch.Tensor, QuantKV]


def gather_pages(cache_layer: Cache, page_table: torch.Tensor) -> Cache:
    """[kv, num_pages, d, page] gathered to [kv, B, max_pages, d, page]
    (a QuantKV's scales to [kv, B, max_pages, page])."""
    return cache_layer[:, page_table.long()]


def page_slots(page_table: torch.Tensor, positions: torch.Tensor,
               valid: torch.Tensor,
               page_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flat (physical page, in-page offset) of every [B, T] slot, as
    int64 [B*T] index tensors; invalid slots go to trash page 0. One
    computation serves every layer's write in a forward."""
    positions = positions.long()
    logical_page = positions // page_size
    physical_page = torch.take_along_dim(page_table.long(), logical_page,
                                         dim=1)
    physical_page = torch.where(valid, physical_page, 0)
    return physical_page.reshape(-1), (positions % page_size).reshape(-1)


def write_slots(cache: Cache, new_kv: torch.Tensor,
                pages: torch.Tensor, offsets: torch.Tensor,
                layer: Optional[int] = None) -> None:
    """Scatter [B, T, kv, d] entries into their (page, offset) slots IN
    PLACE (the JAX version returns an updated copy). A QuantKV cache
    takes each (token, kv head) row quantized, its int8 values into
    the data leaf and its scale into the same slot of the scale leaf.
    A stacked cache takes ``layer`` and is written through its
    ``[layer]`` view: an out-of-place update of the stacked array would
    copy every layer on every layer's write.

    Several padded slots may land on trash page 0 in one call; which
    of them wins is not deterministic on the card, for data and scale
    alike, and that is harmless because page 0 is never attended
    unmasked.
    """
    if validate_layer_arg(cache, layer):
        cache = cache[layer]
    if isinstance(cache, QuantKV):
        q8, scale = quantize_kv(new_kv)  # [B, T, kv, d] / [B, T, kv]
        cache.data[:, pages, :, offsets] = q8.reshape(-1, *q8.shape[2:])
        # Adjacent advanced indices (page, slot) stay in place: the
        # values are [kv, B*T].
        cache.scale[:, pages, offsets] = scale.reshape(
            -1, scale.shape[-1]).T
        return
    flat_kv = new_kv.reshape(-1, *new_kv.shape[2:]).to(cache.dtype)
    # Advanced indices on the page and slot dims broadcast to the
    # front: the values are [B*T, kv, d].
    cache[:, pages, :, offsets] = flat_kv


def write_to_pages(cache: Cache, new_kv: torch.Tensor,
                   page_table: torch.Tensor, positions: torch.Tensor,
                   valid: torch.Tensor,
                   layer: Optional[int] = None) -> Cache:
    """Scatter new KV entries into their pages, in place (quantized on
    write for a QuantKV cache).

    Args:
      cache:       [kv_heads, num_pages, head_dim, page_size], or the
                   stacked [L, ...] cache when ``layer`` is given, or a
                   QuantKV of either layout
      new_kv:      [B, T, kv_heads, head_dim]
      page_table:  [B, max_pages] int32 physical page ids
      positions:   [B, T] absolute token positions
      valid:       [B, T] bool; False entries are redirected to page 0

    Returns ``cache`` (updated in place). Raises ValueError when the
    cache's rank and ``layer`` disagree.
    """
    validate_layer_arg(cache, layer)
    pages, offsets = page_slots(page_table, positions, valid,
                                cache.shape[-1])
    write_slots(cache, new_kv, pages, offsets, layer)
    return cache


def write_to_tail(tail: torch.Tensor, new_kv: torch.Tensor,
                  slot: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """One decode token into its burst-tail slot (a deferred KV write),
    IN PLACE; returns ``tail``. The JAX function returns a new array;
    here the tails are buffers a burst owns (a step graph's, on the
    card), so the write keeps their addresses.

    Args:
      tail:   [B, S, kv_heads, head_dim]
      new_kv: [B, 1, kv_heads, head_dim], this step's K or V
      slot:   [B] tail slot per row (query position - frozen kv_len)
      active: [B] bool, rows decoding this step; a frozen row's tail is
              untouched (its stale slots stay out of attention by
              position and out of the flush by the emitted count)
    """
    s = tail.shape[1]
    hit = ((torch.arange(s, device=tail.device)[None, :]
            == slot.long()[:, None]) & active[:, None])
    tail.copy_(torch.where(hit[..., None, None], new_kv.to(tail.dtype),
                           tail))
    return tail


def paged_attention(q: torch.Tensor, k_cache_layer: Cache,
                    v_cache_layer: Cache, page_table: torch.Tensor,
                    q_positions: torch.Tensor,
                    kv_lens: torch.Tensor,
                    layer: Optional[int] = None,
                    k_tail: Optional[torch.Tensor] = None,
                    v_tail: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Causal attention of q against a sequence's cached pages.

    Args:
      q:           [B, T, num_q_heads, head_dim]
      k/v_cache_layer: [num_kv_heads, num_pages, head_dim, page_size],
                   or the stacked [L, ...] cache when ``layer`` is
                   given (read through its ``[layer]`` view), or
                   QuantKVs of either layout
      page_table:  [B, max_pages]
      q_positions: [B, T] absolute positions of the queries
      kv_lens:     [B] number of valid cached tokens
      k_tail/v_tail: optional [B, S, kv_heads, head_dim] deferred-write
                   burst tails of tokens not yet in the pages: slot s is
                   position ``kv_lens + s`` (kv_lens frozen for the
                   burst), masked by position only, one softmax over
                   pages and tail (the JAX function's)

    An int8 cache keeps its pages int8 through the products and folds
    the per-slot scales in afterwards, as the JAX version does: the K
    scales into the scores, the V scales into the probabilities
    (each scale is constant along the contracted head_dim).

    Returns [B, T, num_q_heads, head_dim].
    """
    if validate_layer_arg(k_cache_layer, layer):
        k_cache_layer = k_cache_layer[layer]
        v_cache_layer = v_cache_layer[layer]
    b, t, num_q_heads, head_dim = q.shape
    num_kv_heads = k_cache_layer.shape[0]
    group = num_q_heads // num_kv_heads
    scale = 1.0 / head_dim ** 0.5

    k = gather_pages(k_cache_layer, page_table)  # [kv, B, P, d, c]
    v = gather_pages(v_cache_layer, page_table)
    quantized = isinstance(k, QuantKV)
    if quantized:
        # [B, kv, 1 (group), 1 (T), P, c], to broadcast over the scores.
        k_scale = k.scale.permute(1, 0, 2, 3)[:, :, None, None]
        v_scale = v.scale.permute(1, 0, 2, 3)[:, :, None, None]
        k, v = k.data, v.data
    k, v = k.float(), v.float()
    p_cnt, page = k.shape[2], k.shape[4]

    qg = q.float().reshape(b, t, num_kv_heads, group, head_dim)
    scores = torch.einsum("btkgd,kbpdc->bkgtpc", qg, k) * scale
    if quantized:
        scores = scores * k_scale

    token_pos = (torch.arange(p_cnt, device=q.device)[:, None] * page
                 + torch.arange(page, device=q.device)[None, :])
    causal = (token_pos[None, None]
              <= q_positions.long()[:, :, None, None])  # [B, T, P, c]
    in_len = token_pos[None] < kv_lens.long()[:, None, None]  # [B, P, c]
    mask = causal & in_len[:, None]
    scores = torch.where(mask[:, None, None], scores, NEG_INF)

    shape = scores.shape
    flat = scores.reshape(*shape[:-2], p_cnt * page)
    if k_tail is not None:
        s_len = k_tail.shape[1]
        t_scores = torch.einsum("btkgd,bskd->bkgts", qg,
                                k_tail.float()) * scale
        tail_pos = (kv_lens.long()[:, None]
                    + torch.arange(s_len, device=q.device)[None, :])
        t_mask = tail_pos[:, None, :] <= q_positions.long()[:, :, None]
        t_scores = torch.where(t_mask[:, None, None], t_scores, NEG_INF)
        probs = torch.softmax(torch.cat([flat, t_scores], dim=-1), dim=-1)
        p_pages = probs[..., :p_cnt * page].reshape(shape)
        p_tail = probs[..., p_cnt * page:]
        if quantized:
            p_pages = p_pages * v_scale
        out = (torch.einsum("bkgtpc,kbpdc->btkgd", p_pages, v)
               + torch.einsum("bkgts,bskd->btkgd", p_tail,
                              v_tail.float()))
        return out.reshape(b, t, num_q_heads, head_dim).to(q.dtype)
    probs = torch.softmax(flat, dim=-1).reshape(shape)
    if quantized:
        probs = probs * v_scale
    out = torch.einsum("bkgtpc,kbpdc->btkgd", probs, v)
    return out.reshape(b, t, num_q_heads, head_dim).to(q.dtype)
