"""The plan of the wgmma walk (csrc/paged_walk_wgmma.cuh) that the
prefill and ragged kernels share: its constants, the shared memory a
block takes at a head-dim tile or a width of its wide form, its
consumer rule and its copy path, mirrored on the host for
``prefill_walk_plan``, ``ragged_walk_plan``, the tools and the CPU
tests, which hold it against the source."""

from __future__ import annotations

from typing import Optional, Tuple

from production_stack_tpu_torch.ops.paged_kv_common import (
    MAX_KERNEL_HEAD_DIM,
)

# csrc/paged_walk_wgmma.cuh's kWgSpan, kWgRows, kWgMaxConsumers and
# kWgMaxStages; paged_kv_common.cuh's kMaxBlockSmem.
WG_SPAN_TOKENS = 64
WG_ROWS = 64
WG_MAX_CONSUMERS = 2
WG_MAX_STAGES = 4
MAX_BLOCK_SMEM = 232448
# The wide form's widths (PSTT_FOR_EACH_WG_WIDTH): 16-bit queries at a
# head_dim above the widest tile run at the smallest at or above it.
WG_WIDE_WIDTHS = (384, 512)


def wide_head_dim_width(head_dim: int) -> Optional[int]:
    """The width of the wgmma walk's wide form a head_dim runs at
    (csrc/paged_walk_wgmma.cuh ``wg_wide_width``): the smallest of
    ``WG_WIDE_WIDTHS`` at or above it, above the widest tile; None where
    another walk takes it (a tile below, the slab walk above)."""
    if head_dim <= MAX_KERNEL_HEAD_DIM:
        return None
    return next((w for w in WG_WIDE_WIDTHS if head_dim <= w), None)


def wg_smem(int8: bool, tile: int) -> Tuple[int, int, int]:
    """(ring stages, raw stages, shared bytes) of the wgmma walk at a
    head-dim tile or a width of the wide form (WgSmem): q slots (two up
    to 128, one above) of two consumers' 64 rows (the wide form: one
    tile of 64 rows both read) in 64-column blocks, as many ring units
    as fit up to four (a 64-token span's K and V planes; the wide form
    one plane a unit, and two spans' page ids), two raw int8 units where
    they fit (the wide form: beside the most units that fit with one),
    the scales, the page ids, the tile ring, the barriers and 1024 bytes
    of alignment."""
    wide = tile > MAX_KERNEL_HEAD_DIM
    planes = 1 if wide else 2
    slot = planes * tile * 128
    scales = planes * WG_SPAN_TOKENS * 4 if int8 else 0
    q_slots = 1 if tile > 128 else 2
    q_tile = WG_ROWS * (-(-tile // 64) * 64) * 2
    q_slot = q_tile if wide else WG_MAX_CONSUMERS * q_tile
    raw_slot = (planes * (tile * WG_SPAN_TOKENS + WG_SPAN_TOKENS * 4)
                if int8 else 0)
    page_ids = (2 if wide else 1) * WG_SPAN_TOKENS * 4

    def size(stages, raw):
        return (stages * (slot + scales) + q_slots * q_slot + raw * raw_slot
                + page_ids + 2 * 4 * 4
                + (2 * stages + 4 + 2 * q_slots) * 8 + 1024)

    def stages_at(raw):
        return next(s for s in (WG_MAX_STAGES, 3, 2)
                    if s == 2 or size(s, raw) <= MAX_BLOCK_SMEM)

    if not int8:
        raw = 0
    elif wide:
        raw = 2 if size(stages_at(1), 2) <= MAX_BLOCK_SMEM else 1
    else:
        raw = 2 if size(2, 2) <= MAX_BLOCK_SMEM else 1
    stages = stages_at(raw)
    return stages, raw, size(stages, raw)


def wg_consumers(rows: int) -> int:
    """Consumer warpgroups at a head-dim tile (``wg_consumers``): one
    where the rows of a tile's (row, kv head) pair fit in 64, else two
    on a 128-row tile. The wide form always runs two."""
    return 1 if rows <= WG_ROWS else WG_MAX_CONSUMERS


def wg_copies(int8: bool, page_size: int) -> str:
    """The producer's copy path (``wg_whole_pages``): ``pages``, whole
    16-byte page copies, at a power-of-two page of 16 bytes or more;
    ``tokens`` otherwise."""
    pow2 = page_size & (page_size - 1) == 0
    return "pages" if pow2 and page_size * (1 if int8 else 2) >= 16 \
        else "tokens"
