"""Paged decode attention: one query token per row against its pages.

Replaces the Pallas TPU kernel ``paged_decode_attention``
(production_stack_tpu/ops/paged_attention_pallas.py:147, body
``_decode_kernel`` at :86) with the CUDA kernel in
``csrc/paged_decode.cu``.

What bounds it on the card: the bytes of the cached K and V. A step
reads 2 * kv_len * kv_heads * head_dim elements for 4 * num_q_heads *
head_dim * kv_len operations — about one operation per byte in bf16,
far below the ~295 operations per byte where the H100's tensor cores
and not its memory become the limit. So the design reads each KV byte
once per step and keeps bytes in flight on every SM:

- the G query heads that share a kv head share every staged page (one
  block serves all of them);
- split-KV: a (row, kv head) pair's 128-token chunks are cut into
  ``num_splits`` ranges, one block each, so that a small batch or a few
  long rows still fill the card's 132 SMs; each block writes its
  softmax state (acc, m, l) in f32 to scratch and a second small kernel
  merges the states in split order (no float atomics: the same bits
  every launch). ``decode_splits`` picks the split from host-known
  shapes only (batch, kv heads, the page table's width), never from
  ``kv_lens``, which stays on the card; a block whose range lies past
  its row's kv_len loads nothing, and a pad row (kv_len 0) merges to
  exact 0. One split is the same kernel writing the output directly;
- pages stage as they lie in device memory, in the cache's own type,
  through two stages of asynchronous 16-byte copies (cp.async): the
  next chunk arrives while this one is used, and nothing is expanded
  to f32 in shared memory (64 KB of stages a block at bf16, three
  blocks an SM);
- an int8 cache (a QuantKV: int8 pages, one f32 scale per kv head, page
  and slot) halves the bytes: its pages and each chunk's 128 K and V
  scales stage with the same copies and fold in as the Pallas kernel
  folds them.

Contract (the Pallas kernel's): q [B, num_q_heads, head_dim];
k/v cache [kv_heads, num_pages, head_dim, page_size] (token-minor
pages), or the stacked [L, kv_heads, ...] cache with ``layer`` (read in
place at that layer, never sliced into a copy), full precision or a
QuantKV of that layout; page_table [B, max_pages] int32; kv_lens [B]
int32; attends positions < kv_len; returns [B, num_q_heads,
head_dim].
"""

from __future__ import annotations

from typing import Optional, Tuple

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
    CHUNK_TOKENS,
    kernel_lib,
    layer_args,
    merge_partials_plain,
    page_walk_partial,
    page_walk_plain,
    split_cache,
    stream_ptr,
)

KERNEL_NAME = "paged_decode"


# Blocks the split aims to put on the card: four for each of the
# H100's 132 SMs (three fit an SM at once; a block of a short row ends
# early).
TARGET_BLOCKS = 4 * 132


def decode_splits(batch: int, num_kv_heads: int, max_pages: int,
                  page_size: int) -> Tuple[int, int]:
    """(number of splits, chunks of one split) of a decode launch.

    A function of host-known shapes only: the table's width gives the
    most chunks a row can hold, and the split grows until batch *
    kv heads * splits reaches ``TARGET_BLOCKS`` or every split holds one
    chunk. The splits cover every chunk of the table exactly once:
    split s walks chunks [s * per, min((s + 1) * per, chunks))."""
    chunks = max(1, -(-max_pages * page_size // CHUNK_TOKENS))
    want = -(-TARGET_BLOCKS // max(1, batch * num_kv_heads))
    per = -(-chunks // max(1, min(chunks, want)))
    return -(-chunks // per), per


def _split_for(num_splits: Optional[int], batch: int, num_kv_heads: int,
               max_pages: int, page_size: int) -> Tuple[int, int]:
    """The launch's (splits, chunks a split): ``decode_splits``' choice,
    or ``num_splits`` ranges of equal length where the caller asks."""
    if num_splits is None:
        return decode_splits(batch, num_kv_heads, max_pages, page_size)
    chunks = max(1, -(-max_pages * page_size // CHUNK_TOKENS))
    if not 1 <= num_splits <= chunks:
        raise ValueError(f"num_splits must lie in 1..{chunks} (the "
                         f"table's chunks), got {num_splits}")
    per = -(-chunks // num_splits)
    return -(-chunks // per), per


def paged_decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor,
                           page_table: torch.Tensor,
                           kv_lens: torch.Tensor,
                           layer: Optional[int] = None,
                           num_splits: Optional[int] = None
                           ) -> torch.Tensor:
    """Single-token paged attention.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (its int8 form for a QuantKV cache, its stacked form with
    ``layer``) or raise. ``num_splits`` overrides ``decode_splits``'
    choice (the tests hold both against the plain version); the engine
    never passes it. Raises ValueError on bare int8 pages without
    their scales and on a cache rank that disagrees with ``layer``.
    """
    check_cache(k_cache, v_cache, layer)
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_cache, v_cache,
                                            page_table, kv_lens, layer,
                                            num_splits or 1)
    kc, vc, ks, vs = split_cache(k_cache, v_cache)
    b, num_q_heads, head_dim = q.shape
    num_kv_heads, num_pages, _, page_size = kc.shape[-4:]
    out = torch.empty_like(q)
    check_kernel_operands(
        q, kc, vc, (("page_table", page_table), ("kv_lens", kv_lens)),
        out, ks, vs)
    if kv_lens.shape != (b,) or page_table.shape[0] != b:
        raise ValueError("page_table/kv_lens rows must match the batch")
    splits, per = _split_for(num_splits, b, num_kv_heads,
                             page_table.shape[1], page_size)
    # Each split's softmax state of every query head: acc[D], m, l.
    partials = None if splits == 1 else torch.empty(
        (b, num_kv_heads, splits, num_q_heads // num_kv_heads,
         head_dim + 2), dtype=torch.float32, device=q.device)
    name = counter_name(KERNEL_NAME, ks, layer)
    err = kernel_lib().pstt_paged_decode(
        dtype_code(q.dtype), cache_code(kc.dtype), q.data_ptr(),
        kc.data_ptr(), vc.data_ptr(), data_ptr(ks), data_ptr(vs),
        page_table.data_ptr(), kv_lens.data_ptr(), out.data_ptr(),
        data_ptr(partials), b, num_q_heads, num_kv_heads, head_dim,
        num_pages, page_size, page_table.shape[1], splits, per,
        *layer_args(kc, ks, layer), stream_ptr())
    check_launch(name, err)
    COUNTERS.launched(name)
    return out


def paged_decode_attention_plain(q: torch.Tensor, k_cache: torch.Tensor,
                                 v_cache: torch.Tensor,
                                 page_table: torch.Tensor,
                                 kv_lens: torch.Tensor,
                                 layer: Optional[int] = None,
                                 num_splits: int = 1) -> torch.Tensor:
    """The kernel's function in plain torch: the same chunked page walk
    with mask ``pos < kv_len``, the same online softmax and, for a
    QuantKV cache, the same fold of its scales; a stacked cache is
    walked at ``layer``. With ``num_splits`` > 1 it is the kernel's
    split walk: the table's chunks cut into that many ranges, each
    walked to its unnormalised state, the states merged in split order
    (``merge_partials_plain``)."""
    check_cache(k_cache, v_cache, layer)
    kc, vc, ks, vs = split_cache(k_cache, v_cache)
    if q.is_cuda:
        COUNTERS.plain_on_cuda(counter_name(KERNEL_NAME, ks, layer))
    b, num_q_heads, head_dim = q.shape
    num_kv_heads = kc.shape[-4]
    qg = q.reshape(b, num_kv_heads, num_q_heads // num_kv_heads,
                   head_dim)
    kv = kv_lens.long()[:, None, None, None]

    def mask(pos):
        return pos < kv

    if num_splits == 1:
        out = page_walk_plain(qg, kc, vc, page_table, kv_lens, mask, ks,
                              vs, layer)
    else:
        splits, per = _split_for(num_splits, b, num_kv_heads,
                                 page_table.shape[1], kc.shape[-1])
        states = [page_walk_partial(qg, kc, vc, page_table, kv_lens, mask,
                                    ks, vs, layer,
                                    chunk_range=(s * per, (s + 1) * per))
                  for s in range(splits)]
        out = merge_partials_plain(*(torch.stack(x) for x in zip(*states)))
    return out.reshape(b, num_q_heads, head_dim).to(q.dtype)
