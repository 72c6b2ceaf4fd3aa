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

- the G query heads that share a kv head share every staged page: one
  block serves a group tile of them (``decode_group_tile``: the whole
  group up to 4, or 8 at head_dim 64 and below; 2 at the head-dim tile
  256; 4 again above 256, where a block serves one 128-wide slab of the
  output and sums the scores over every slab, K staged a slab at a
  time; a larger group runs ceil(G / tile) blocks a kv head, the last
  one's spare heads loading zeros and never written);
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
  through two stages of asynchronous copies (cp.async; 16 bytes, or as
  wide as a page row of any other size allows): the
  next chunk arrives while this one is used, and nothing is expanded
  to f32 in shared memory (64 KB of stages a block at bf16, three
  blocks an SM);
- an int8 cache (a QuantKV: int8 pages, one f32 scale per kv head, page
  and slot) halves the bytes: its pages and each chunk's 128 K and V
  scales stage with the same copies and fold in as the Pallas kernel
  folds them.

The burst-tail form (``paged_decode_tail_attention``) serves a decode
burst with deferred KV writes (the JAX runner's
``_decode_burst_deferred_impl``; its XLA attention,
production_stack_tpu/ops/attention.py ``paged_attention`` with
``k_tail``/``v_tail``, runs no Pallas kernel): the burst's tokens not
yet flushed to the pages lie in a dense [B, S <= 32, kv_heads,
head_dim] tail in the query's type, slot s of row b at position
``kv_lens[b] + s``, attending iff that position is at most the row's
query position. On the card the tail is one more split of the same
launch: a small kernel writes its softmax state after the walk's
splits, and the merge folds it in last. Its extra bytes are the
tail's 2 * S * kv_heads * head_dim elements a row, read once.

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
    NEG_INF,
    cache_code,
    check_cache,
    check_kernel_operands,
    check_launch,
    counter_name,
    data_ptr,
    dtype_code,
    CHUNK_TOKENS,
    kernel_head_dim_slabs,
    kernel_lib,
    layer_args,
    merge_partials_plain,
    page_walk_partial,
    page_walk_plain,
    split_cache,
    stream_ptr,
)

KERNEL_NAME = "paged_decode"
TAIL_KERNEL_NAME = "paged_decode_tail"
# The most tail slots a burst carries (csrc/paged_decode.cu kMaxTail).
MAX_TAIL = 32


# Blocks the split aims to put on the card: four for each of the
# H100's 132 SMs (three fit an SM at once; a block of a short row ends
# early).
TARGET_BLOCKS = 4 * 132


def decode_group_tile(group: int, head_dim: int) -> int:
    """The query heads one decode block covers (csrc/paged_decode.cuh
    ``group_tile`` at the head dim's tile or slab; the library's
    ``pstt_decode_group_tile``): 1 for a group of 1, else 4 up to 4 and
    8 above, at most the widest tile of the head-dim tile (8 at 64 and
    below, 4 to 128 and for the slabs of 128 above 256, 2 at 256),
    where more heads' accumulators would pass a thread's 255 registers.
    Raises ValueError for a head_dim under 1."""
    slabs = kernel_head_dim_slabs(head_dim)
    if slabs is None:
        raise ValueError(f"no kernel tile holds head_dim {head_dim}")
    tile = slabs[1]
    widest = 8 if tile <= 64 else 4 if tile <= 128 else 2
    if group <= 1:
        return 1
    return min(4 if group <= 4 else 8, widest)


def _partials(q: torch.Tensor, num_kv_heads: int, slots: int
              ) -> torch.Tensor:
    """f32 scratch of the splits' (and a tail's) softmax states, tile-
    major within a kv head, slab fastest: [B, kv_heads * tiles * slabs,
    slots, tile, slab width + 2] (acc over the head-dim tile, or one
    128-wide slab above 256, m, l of each head of the group tile)."""
    b, num_q_heads, head_dim = q.shape
    group = num_q_heads // num_kv_heads
    tile = decode_group_tile(group, head_dim)
    slabs, width = kernel_head_dim_slabs(head_dim)
    return torch.empty((b, num_kv_heads * -(-group // tile) * slabs, slots,
                        tile, width + 2),
                       dtype=torch.float32, device=q.device)


def decode_splits(batch: int, num_kv_heads: int, max_pages: int,
                  page_size: int) -> Tuple[int, int]:
    """(number of splits, chunks of one split) of a decode launch.

    A function of host-known shapes only: the table's width gives the
    most 128-token chunks a row can hold, whatever the page size (a page
    of 256 tokens is two chunks, and a split's ``chunk_range`` means the
    same tokens in the kernel and in ``page_walk_partial``), and the
    split grows until batch * kv heads * splits reaches
    ``TARGET_BLOCKS`` or every split holds one chunk. The splits cover every chunk of the table exactly once:
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
    partials = None if splits == 1 else _partials(q, num_kv_heads, splits)
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


def check_tail(q: torch.Tensor, k_tail: torch.Tensor, v_tail: torch.Tensor,
               q_pos: torch.Tensor, num_kv_heads: int) -> None:
    """A burst tail's operands: k/v tails [B, S, kv_heads, head_dim] in
    q's dtype on q's device, 1 <= S <= MAX_TAIL, contiguous; q_pos [B]
    int32. Raises on anything else."""
    b, _, head_dim = q.shape
    shape = k_tail.shape
    if (k_tail.dim() != 4 or v_tail.shape != shape or shape[0] != b
            or shape[2] != num_kv_heads or shape[3] != head_dim
            or not 1 <= shape[1] <= MAX_TAIL):
        raise ValueError(
            f"k/v tails must be [B, 1..{MAX_TAIL}, kv_heads, head_dim] = "
            f"[{b}, S, {num_kv_heads}, {head_dim}], got "
            f"{tuple(shape)} and {tuple(v_tail.shape)}")
    for name, t in (("k_tail", k_tail), ("v_tail", v_tail)):
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} must be {q.dtype} on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if (q_pos.shape != (b,) or q_pos.dtype != torch.int32
            or q_pos.device != q.device or not q_pos.is_contiguous()):
        raise ValueError("q_pos must be a contiguous int32 [B] on q's "
                         "device")


def paged_decode_tail_attention(q: torch.Tensor, k_cache: torch.Tensor,
                                v_cache: torch.Tensor,
                                page_table: torch.Tensor,
                                kv_lens: torch.Tensor,
                                k_tail: torch.Tensor, v_tail: torch.Tensor,
                                q_pos: torch.Tensor,
                                layer: Optional[int] = None,
                                num_splits: Optional[int] = None
                                ) -> torch.Tensor:
    """Single-token paged attention over the pages (positions <
    ``kv_lens``) and a burst tail: slot s of row b at position
    ``kv_lens[b] + s``, attending iff it is at most ``q_pos[b]``. One
    softmax over both.

    CPU tensors take the plain version; CUDA tensors launch the tail
    form of the kernel (int8 pages for a QuantKV cache, stacked with
    ``layer``) or raise. ``num_splits`` as in
    ``paged_decode_attention``."""
    check_cache(k_cache, v_cache, layer)
    kc, vc, ks, vs = split_cache(k_cache, v_cache)
    num_kv_heads, num_pages, _, page_size = kc.shape[-4:]
    check_tail(q, k_tail, v_tail, q_pos, num_kv_heads)
    if q.device.type == "cpu":
        return paged_decode_tail_attention_plain(
            q, k_cache, v_cache, page_table, kv_lens, k_tail, v_tail,
            q_pos, layer, num_splits or 1)
    b, num_q_heads, head_dim = q.shape
    out = torch.empty_like(q)
    check_kernel_operands(
        q, kc, vc, (("page_table", page_table), ("kv_lens", kv_lens)),
        out, ks, vs)
    if kv_lens.shape != (b,) or page_table.shape[0] != b:
        raise ValueError("page_table/kv_lens rows must match the batch")
    splits, per = _split_for(num_splits, b, num_kv_heads,
                             page_table.shape[1], page_size)
    # The walk's splits and the tail's slot after them.
    partials = _partials(q, num_kv_heads, splits + 1)
    name = counter_name(TAIL_KERNEL_NAME, ks, layer)
    err = kernel_lib().pstt_paged_decode_tail(
        dtype_code(q.dtype), cache_code(kc.dtype), q.data_ptr(),
        kc.data_ptr(), vc.data_ptr(), data_ptr(ks), data_ptr(vs),
        page_table.data_ptr(), kv_lens.data_ptr(), out.data_ptr(),
        partials.data_ptr(), k_tail.data_ptr(), v_tail.data_ptr(),
        q_pos.data_ptr(), b, num_q_heads, num_kv_heads, head_dim,
        num_pages, page_size, page_table.shape[1], splits, per,
        k_tail.shape[1], *layer_args(kc, ks, layer), stream_ptr())
    check_launch(name, err)
    COUNTERS.launched(name)
    return out


def tail_partial_plain(q: torch.Tensor, k_tail: torch.Tensor,
                       v_tail: torch.Tensor, kv_lens: torch.Tensor,
                       q_pos: torch.Tensor):
    """The tail's softmax state (m, l, acc) in f32, [B, KV, G, 1 | D]:
    the tail kernel's function. Slots that do not attend score -1e30
    and weigh 0; a row with none keeps the empty state (-1e30, 0, 0)."""
    b, num_q_heads, head_dim = q.shape
    num_kv_heads, s_len = k_tail.shape[2], k_tail.shape[1]
    qg = q.float().reshape(b, num_kv_heads, num_q_heads // num_kv_heads,
                           head_dim)
    kt = k_tail.float().permute(0, 2, 3, 1)  # [B, KV, D, S]
    vt = v_tail.float().permute(0, 2, 1, 3)  # [B, KV, S, D]
    slot_pos = (kv_lens.long()[:, None]
                + torch.arange(s_len, device=q.device)[None, :])
    live = (slot_pos <= q_pos.long()[:, None])[:, None, None, :]
    scores = torch.where(live, (qg @ kt) * (1.0 / head_dim ** 0.5),
                         NEG_INF)
    m = scores.amax(-1, keepdim=True)
    p = torch.where(live, torch.exp(scores - m), 0.0)
    return m, p.sum(-1, keepdim=True), p @ vt


def paged_decode_tail_attention_plain(q: torch.Tensor,
                                      k_cache: torch.Tensor,
                                      v_cache: torch.Tensor,
                                      page_table: torch.Tensor,
                                      kv_lens: torch.Tensor,
                                      k_tail: torch.Tensor,
                                      v_tail: torch.Tensor,
                                      q_pos: torch.Tensor,
                                      layer: Optional[int] = None,
                                      num_splits: int = 1) -> torch.Tensor:
    """The tail form's function in plain torch: the page walk of
    ``paged_decode_attention_plain`` in ``num_splits`` ranges to their
    unnormalised states, the tail's state as one more chunk
    (``tail_partial_plain``), all merged in split order, the tail last,
    as the kernel merges them."""
    check_cache(k_cache, v_cache, layer)
    kc, vc, ks, vs = split_cache(k_cache, v_cache)
    if q.is_cuda:
        COUNTERS.plain_on_cuda(counter_name(TAIL_KERNEL_NAME, ks, layer))
    b, num_q_heads, head_dim = q.shape
    num_kv_heads = kc.shape[-4]
    qg = q.reshape(b, num_kv_heads, num_q_heads // num_kv_heads,
                   head_dim)
    kv = kv_lens.long()[:, None, None, None]

    def mask(pos):
        return pos < kv

    splits, per = _split_for(num_splits, b, num_kv_heads,
                             page_table.shape[1], kc.shape[-1])
    states = [page_walk_partial(qg, kc, vc, page_table, kv_lens, mask, ks,
                                vs, layer,
                                chunk_range=(s * per, (s + 1) * per))
              for s in range(splits)]
    states.append(tail_partial_plain(q, k_tail, v_tail, kv_lens, q_pos))
    out = merge_partials_plain(*(torch.stack(x) for x in zip(*states)))
    return out.reshape(b, num_q_heads, head_dim).to(q.dtype)
