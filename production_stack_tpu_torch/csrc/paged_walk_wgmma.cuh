// The chunked-prefill walk for 16-bit queries (bf16 or f16, T) on
// Hopper's warpgroup products, over a cache of the query's type or
// int8 (C), at every head-dim tile D (32, 64, 80, 128, 256). It keeps
// the contract of page_walk_block (paged_kv_common.cuh): a tile of query
// rows of one (row, kv head) pair walks the row's pages up to the last
// token any of its rows can see; l sums the unrounded probabilities and
// p enters p . v rounded to T; an int8 cache's scales fold in the
// Pallas order (k_scale on each score column after the product, l over
// the unscaled p, p * v_scale before the conversion to T); a row with
// nothing to see writes exact 0, rows at or past a tile's end are never
// written.
//
// The tile is the walk's template policy (Tiles): prefill's chunk rows
// (WgPrefillTiles, below), or the ragged kernel's slot-major rows with
// their dead slots (WgRaggedTiles, paged_ragged.cuh: its 16-bit head
// dims 129 to 512). One producer and one consumer serve both; with
// dead rows, the consumers write them exact 0 (a live tile's after its
// output; a tile with no live row, which takes no q slot, no ring unit
// and no product, all of them together), and the producer passes a tile
// with no live row.
//
// What bounds it is the latency between the products, not the products:
// a tile's spans are few (a 512-token chunk is 8 spans of 64), and a
// block that loads its q, waits for its first K/V and stores its output
// before the next tile starts spends most of its time waiting. So the
// walk keeps the tensor cores fed across tiles:
//
//   - Persistent blocks, one an SM: `consumers` warpgroups of 64 query
//     rows (two, a 128-row tile; one where the G * T rows of a (row, kv
//     head) pair fit in 64) and one producer warpgroup, each on its own
//     path from the start (setmaxnreg: the producer gives its registers
//     to the consumers). Tiles come from a scheduler, heaviest first
//     (wg_fetch_tile), so a block that drew light tiles takes more.
//   - The producer runs ahead of the consumers: it fetches the next tile
//     and publishes it (a ring of two tile slots), copies its q into a
//     ring of q slots in the 128-byte swizzle (two slots up to D 128,
//     one at 256), and fills a ring of kStages stages, each the K and V
//     of one 64-token span as [D][64] planes of T in the same swizzle,
//     with a `full` and an `empty` mbarrier a slot. No block-wide
//     barrier stands between copies and products.
//   - Copies: the producer resolves a span's page ids once (loaded a
//     span ahead), then cp.async, 16 bytes of one head dim a copy where
//     the page is a power of two of 16 bytes or more, any other page as
//     wide as its row allows (copy_elems). The whole-page copies end in
//     cp.async.mbarrier.arrive.noinc (the slot is full when every
//     producer thread's copies have landed, and the producer moves on at
//     once); the general copies wait and arrive. Pages past the row's
//     live ones stage as zeros. TMA is not used: a span is one page row
//     of at most 128 bytes a head dim, which the 128 producer threads
//     issue in 8 to 32 copies each.
//   - An int8 cache: the producer copies the raw planes and the scales
//     of span c + kRawStages - 1 into a raw ring while it converts span
//     c (exact: |x| <= 127) into the stage's T planes and signals it;
//     the consumers never wait on a conversion barrier.
//   - Each consumer warpgroup runs S = q . K^T as wgmma m64n64k16 from
//     shared memory (D / 16 k steps; K pages lie [D, page] token-minor,
//     so K is B in MN-major form: the transpose bit), and O += P . V as
//     m64nDk16 with P in registers and V as it lies (K-major). The
//     scores' accumulator is mma.sync's m16n8 layout: scaled (log2 e /
//     sqrt(hd) folded), masked where the span cuts a row's limit,
//     softmaxed online in registers and packed in place to T. The
//     products run a span ahead of the softmax (wg_consume), and the
//     16-token groups past the warpgroup's last visible token skip p . v.
//   - The output goes through the warpgroup's q slot: written there in
//     the swizzle, then stored a 16-byte chunk a thread, rows whole.
//   - Rows d >= head_dim of the stages are zeroed once; q's are copied
//     as zeros.
//
// Head dims 257 to 512 take the walk's wide form, at a width W of 384
// or 512 (wg_wide_width: the smallest at or above the head_dim, padded
// in the kernel below it), where 64 rows of accumulators at the full
// width would pass what a thread can hold:
//   - A tile is 64 query rows of a (row, kv head) pair, and both consumer
//     warpgroups take all of it: warpgroup w owns the output head dims
//     [w W / 2, (w + 1) W / 2), at most 128 accumulators a thread (the
//     tile 256's). Each runs q . k^T over all W head dims, from the same
//     operands in the same order, so the two compute the same m, l and p
//     bit for bit and exchange nothing; then p . v over its half of the
//     V plane (a descriptor offset). The scores are computed twice a
//     tile, not once a 128-wide slab as in the slab walk, and q, K and V
//     are read from memory once a tile.
//   - A ring unit is one plane: a span's K and its V are two units, so
//     that the producer stages K of the next span while the consumers
//     run p . v over V of this one (two 64 KB units beside the 64 KB q
//     tile at 512, three at 384). Units go K0, K1, V0, K2, V1, ..., the
//     order the consumers release them in (K(c) once span c's scores
//     are in, V(c - 1) once its p . v is), with the page ids of two spans
//     kept. An int8 cache's raw ring holds one plane a unit too; its V
//     scales come with V's unit, which the consumers wait for before
//     they pack p.
//   - The warpgroups share the q tile: both pass a pair barrier before
//     either writes its half of the output there.

#pragma once

#include "paged_kv_common.cuh"
#include "mbarrier.cuh"
#include "paged_walk_mma.cuh"
#include "wgmma.cuh"

namespace pstt {

constexpr int kWgSpan = 64;     // tokens a ring stage holds, a softmax step
constexpr int kWgRows = 64;     // query rows of a consumer warpgroup
constexpr int kWgThreads = 128;  // a warpgroup
constexpr int kWgMaxConsumers = 2;
constexpr int kWgBlockThreads = (kWgMaxConsumers + 1) * kWgThreads;
// Registers a thread of the producer gives up to and the consumers rise
// to, from the 168 of a 384-thread block's entry: 40 and 232 at the tile
// 256 (128 output accumulators a consumer thread), else 56 and 224.
__host__ __device__ constexpr int wg_producer_regs(int d) {
  return d > 128 ? 40 : 56;
}
__host__ __device__ constexpr int wg_consumer_regs(int d) {
  return d > 128 ? 232 : 224;
}
constexpr int kWgMaxStages = 4;
constexpr int kWgProducerBar = 1;  // named barrier of the producer warpgroup
constexpr int kWgQBar = 2;         // + consumer index: its q slot
// Both consumer warpgroups of the wide form: their shared q tile.
constexpr int kWgPairBar = kWgQBar + kWgMaxConsumers;

// Consumer warpgroups of a block for `rows` = G * T query rows of a
// (row, kv head) pair: one where they fit in 64, else two (a 128-row
// tile). The host's ops/prefill_attention_cuda.prefill_walk_plan is the
// same rule. (The wide form always runs two, over 64-row tiles.)
__host__ __device__ constexpr int wg_consumers(int rows) {
  return rows <= kWgRows ? 1 : kWgMaxConsumers;
}

// The wide form's widths, ascending; the host's
// ops/prefill_attention_cuda.WG_WIDE_WIDTHS is this list.
#define PSTT_FOR_EACH_WG_WIDTH(X, code, T, ccode, C) \
  X(code, T, ccode, C, 384)                          \
  X(code, T, ccode, C, 512)

// The width a head_dim runs at in the wide form: the smallest of
// PSTT_FOR_EACH_WG_WIDTH at or above it, above kMaxHeadDim; 0 where the
// head_dim takes another walk (the tiles below, the slab walk above).
__host__ __device__ constexpr int wg_wide_width(int head_dim) {
  if (head_dim <= kMaxHeadDim) return 0;
#define PSTT_WIDTH_AT_LEAST(code, T, ccode, C, W) \
  if (head_dim <= W) return W;
  PSTT_FOR_EACH_WG_WIDTH(PSTT_WIDTH_AT_LEAST, 0, float, 0, float)
#undef PSTT_WIDTH_AT_LEAST
  return 0;
}

// The producer's copy path: whole pages with 16-byte copies where the
// page is a power of two whose row of one head dim holds 16 bytes or
// more (bf16 and f16 from 8 tokens, int8 from 16); token by token, as
// wide as the page row allows, at any other page.
template <typename C>
__host__ __device__ constexpr bool wg_whole_pages(int page_size) {
  return page_size >= 1 && (page_size & (page_size - 1)) == 0 &&
         page_size * (int)sizeof(C) >= 16;
}

// Shared memory of one block, in bytes from a 1024-byte aligned base:
//   tiles   [kStages][K plane, V plane], a plane [D][64] of T (128 bytes
//           a head dim, 16-byte chunks XORed by d % 8: the 128-byte
//           swizzle)
//   q       [kQSlots][consumers][64 rows][D rounded up to 64] of T in the
//           same swizzle, column blocks of [64][64]; a warpgroup's rows
//           also carry its output out at the end of a tile
//   raw     [kRawStages][raw K, raw V: [D][64] int8; K, V scales: 64
//           f32 each] (int8 caches only)
//   scales  [kStages][K, V: 64 f32 each] (int8 caches only)
//   pages   the span's page ids, 64 int32
//   ring    two tile slots: index, kv_len, chunk start
//   bars    full[kStages], empty[kStages], tile_full[2], tile_empty[2],
//           q_full[kQSlots], q_empty[kQSlots]
// plus 1024 bytes to align the base. Two q slots up to D 128 (the next
// tile's q lands while this tile's products run), one at 256; as many
// stages as fit up to kWgMaxStages (a span is 0.5 to 2 us of products,
// about one device memory latency), and two raw stages where they fit
// (one at D = 256).
//
// The wide form (D a width of PSTT_FOR_EACH_WG_WIDTH) keeps the layout
// with one plane a ring unit (a stage above: tiles [kStages][plane],
// scales [kStages][64 f32], raw [kRawStages][raw plane, 64 f32]), one q
// tile of [64 rows][D] a q slot, both warpgroups', and the page ids of
// two spans. It takes as many units as fit with one raw unit, then a
// second raw unit where it fits beside them: a unit more in the ring
// keeps K a span ahead of the products, a raw unit more only the copy.
template <typename C, int D>
struct WgSmem {
  static constexpr bool kQuant = kQuantized<C>;
  static constexpr bool kWide = D > kMaxHeadDim;
  static constexpr int kUnitPlanes = kWide ? 1 : 2;  // planes a ring unit
  static constexpr int kPlane = D * 128;
  static constexpr int kSlot = kUnitPlanes * kPlane;
  static constexpr int kScales = kQuant ? kUnitPlanes * kWgSpan * 4 : 0;
  static constexpr int kQSlots = D > 128 ? 1 : 2;
  static constexpr int kQTile = kWgRows * ((D + 63) / 64 * 64) * 2;
  static constexpr int kQSlot = kWide ? kQTile : kWgMaxConsumers * kQTile;
  static constexpr int kRawPlane = kQuant ? D * kWgSpan : 0;
  static constexpr int kRawSlot =
      kQuant ? kUnitPlanes * (kRawPlane + kWgSpan * 4) : 0;
  static constexpr int kPageIds = (kWide ? 2 : 1) * kWgSpan * 4;
  static constexpr int kRing = 2 * 4 * 4;
  static constexpr int bytes_at(int stages, int raw_stages) {
    return stages * (kSlot + kScales) + kQSlots * kQSlot +
           raw_stages * kRawSlot + kPageIds + kRing +
           (2 * stages + 4 + 2 * kQSlots) * 8 + 1024;
  }
  static constexpr int stages_at(int raw_stages) {
    return bytes_at(4, raw_stages) <= kMaxBlockSmem
               ? 4
               : (bytes_at(3, raw_stages) <= kMaxBlockSmem ? 3 : 2);
  }
  static constexpr int kRawStages =
      !kQuant ? 0
      : kWide ? (bytes_at(stages_at(1), 2) <= kMaxBlockSmem ? 2 : 1)
              : (bytes_at(2, 2) <= kMaxBlockSmem ? 2 : 1);
  static constexpr int kStages = stages_at(kRawStages);
  static constexpr int tiles = 0;
  static constexpr int q = tiles + kStages * kSlot;
  static constexpr int raw = q + kQSlots * kQSlot;
  static constexpr int scales = raw + kRawStages * kRawSlot;
  static constexpr int pages = scales + kStages * kScales;
  static constexpr int ring = pages + kPageIds;
  static constexpr int bars = ring + kRing;
  static constexpr int bytes = bytes_at(kStages, kRawStages);
  static_assert(bytes <= kMaxBlockSmem, "a wgmma walk block's shared memory");
  static_assert(kPlane % 1024 == 0 && kQTile % 1024 == 0 &&
                    (!kWide || D / 2 * 128 % 1024 == 0),
                "planes, q tiles and half planes start at swizzle atoms");
};

// The plan of every instance (cache, D: stages, raw stages, bytes; the
// wide form's D is its width and its stages are ring units), checked
// here by the compiler and read by the CPU tests against the host's
// mirror (ops/prefill_attention_cuda.prefill_walk_plan).
#define PSTT_WG_PLAN(C, D, STAGES, RAW, BYTES)                        \
  static_assert(WgSmem<C, D>::kStages == STAGES &&                    \
                    WgSmem<C, D>::kRawStages == RAW &&                \
                    WgSmem<C, D>::bytes == BYTES,                     \
                "the wgmma walk's plan");
PSTT_WG_PLAN(__nv_bfloat16, 32, 4, 0, 66976)
PSTT_WG_PLAN(__nv_bfloat16, 64, 4, 0, 99744)
PSTT_WG_PLAN(__nv_bfloat16, 80, 4, 0, 148896)
PSTT_WG_PLAN(__nv_bfloat16, 128, 4, 0, 198048)
PSTT_WG_PLAN(__nv_bfloat16, 256, 2, 0, 198000)
PSTT_WG_PLAN(int8_t, 32, 4, 2, 78240)
PSTT_WG_PLAN(int8_t, 64, 4, 2, 119200)
PSTT_WG_PLAN(int8_t, 80, 4, 2, 172448)
PSTT_WG_PLAN(int8_t, 128, 3, 2, 200592)
PSTT_WG_PLAN(int8_t, 256, 2, 1, 232304)
PSTT_WG_PLAN(__nv_bfloat16, 384, 3, 0, 198272)
PSTT_WG_PLAN(__nv_bfloat16, 512, 2, 0, 198256)
PSTT_WG_PLAN(int8_t, 384, 3, 1, 223872)
PSTT_WG_PLAN(int8_t, 512, 2, 1, 231792)
#undef PSTT_WG_PLAN

// ---- barriers ---------------------------------------------------------------

// (mbar_*, cp_async_mbar_arrive and fence_proxy_async: mbarrier.cuh.)

__device__ __forceinline__ void named_bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Byte offset of head dim d, token `byte / 2` of a [D][64] 16-bit plane
// in the 128-byte swizzle (`byte` < 128: the offset in the row).
__device__ __forceinline__ uint32_t swz128(int d, int byte) {
  return (uint32_t)d * 128u +
         ((((uint32_t)byte >> 4) ^ ((uint32_t)d & 7u)) << 4) +
         ((uint32_t)byte & 15u);
}

// ---- a launch and its tiles ------------------------------------------------

// One launch's operands and shapes (the kernel's parameter).
template <typename T, typename C>
struct WgArgs {
  const T* q;
  const C* k_cache;
  const C* v_cache;
  const float* k_scale;
  const float* v_scale;
  const int* page_table;
  const int* q_positions;
  const int* kv_lens;
  T* out;
  int batch, tokens, num_q_heads, num_kv_heads, group, num_pages,
      page_size, max_pages, hd;
  LayerOffsets layer;
  int consumers;  // consumer warpgroups a block
  int tiles;      // tiles of one (row, kv head) pair
  int total;      // tiles of the launch: kv_heads * batch * tiles
  // The ragged walk's [R] last_index (its `tokens` is the block's width
  // W, `batch` its rows R); unused by prefill.
  const int* last_index = nullptr;
};

// A tile of a launch: its (kv head, row) pair, where its query rows lie
// (Rows: offset(r) of row r), what they see (Mask: limit(r) and
// max_limit(n)), its `nrows` live rows (a prefix), the `end` rows it
// holds (rows [nrows, end) are written exact 0; prefill's equal nrows)
// and the spans its live rows see.
template <typename Rows, typename Mask>
struct WgTile {
  int h, b, nrows, end, n_spans;
  Rows rows;
  Mask mask;
};

// Query rows a tile at D: a warpgroup's 64 each, or 64 in the wide
// form, whose warpgroups share them.
template <int D, typename T, typename C>
__device__ __forceinline__ int wg_tile_rows(const WgArgs<T, C>& a) {
  return D > kMaxHeadDim ? kWgRows : a.consumers * kWgRows;
}

// The walk's tile policy: which tile a launch index is, and what the
// producer publishes beside the row's kv_len for the consumers to
// rebuild it (`info`). Prefill's tiles (this policy) are chunk rows
// g-major (RowMap, CausalMask), every row live, `info` the chunk's
// start; the ragged kernel's (paged_ragged.cuh, WgRaggedTiles) are
// slot-major (SlotMajorRows, RaggedMask), `info` the row's last_index,
// with dead rows and dead tiles (kDeadRows).
//
// Prefill's order: every pair's heaviest tile comes first, then every
// pair's next: where a tile holds rows of one query head, from the
// highest positions down across every head; else from the last tile
// down.
struct WgPrefillTiles {
  static constexpr bool kDeadRows = false;
  using Tile = WgTile<RowMap, CausalMask>;

  template <typename T, typename C>
  static __device__ __forceinline__ int info(const WgArgs<T, C>& a, int b) {
    return a.q_positions[(size_t)b * a.tokens];
  }

  template <int D, typename T, typename C>
  static __device__ __forceinline__ Tile tile(const WgArgs<T, C>& a,
                                              int index, int kv_len,
                                              int q_start) {
    Tile t;
    const int pairs = a.num_kv_heads * a.batch;
    const int z = index / pairs;
    const int pair = index - z * pairs;
    t.h = pair % a.num_kv_heads;
    t.b = pair / a.num_kv_heads;
    const int tile_rows = wg_tile_rows<D>(a);
    int tile;
    if (a.tokens % tile_rows == 0) {
      const int per_head = a.tokens / tile_rows;
      tile = (z % a.group) * per_head + per_head - 1 - z / a.group;
    } else {
      tile = a.tiles - 1 - z;
    }
    const int row0 = tile * tile_rows;
    t.nrows = min(tile_rows, a.group * a.tokens - row0);
    t.end = t.nrows;
    t.rows = RowMap{((size_t)t.b * a.tokens * a.num_q_heads +
                     (size_t)t.h * a.group) * a.hd,
                    a.tokens, a.num_q_heads, a.hd, row0};
    t.mask = CausalMask{kv_len, q_start, a.tokens, row0};
    t.n_spans = (t.mask.max_limit(t.nrows) + kWgSpan - 1) / kWgSpan;
    return t;
  }
};

// The launch's tile scheduler: the persistent blocks take tiles in
// index order (heaviest first) from this counter, one fetch at a time.
// The launch's last fetch (each block's first fetch past the tiles is
// counted: total + blocks fetches) sets it back to 0 for the next launch
// on the stream; a CUDA graph's replays find it at 0 as well. One
// counter a source file (launches of one stream are ordered).
static __device__ int wg_next_tile;

__device__ __forceinline__ int wg_fetch_tile(int total) {
  const int index = atomicAdd(&wg_next_tile, 1);
  if (index == total + (int)gridDim.x - 1) atomicExch(&wg_next_tile, 0);
  return index < total ? index : -1;
}

// Whether q's and out's rows move as 16-byte units: hd a multiple of 8
// and both tensors 16-byte aligned (a row then starts at 16 bytes).
template <typename T, typename C>
__device__ __forceinline__ bool wg_rows_in_16(const WgArgs<T, C>& a) {
  return a.hd % 8 == 0 &&
         ((reinterpret_cast<uintptr_t>(a.q) |
           reinterpret_cast<uintptr_t>(a.out)) & 15) == 0;
}

// Bytes a copy of q's rows moves: the widest of 16, 8 and 4 that divides
// a row (hd * 2 bytes) and q's address; 2 otherwise (an odd hd).
template <typename T, typename C>
__device__ __forceinline__ int wg_q_copy_bytes(const WgArgs<T, C>& a) {
  const uint32_t align = (uint32_t)(a.hd * 2) |
                         (uint32_t)reinterpret_cast<uintptr_t>(a.q);
  return (align & 15) == 0 ? 16 : (align & 7) == 0 ? 8
                                  : (align & 3) == 0 ? 4 : 2;
}

// Rows [begin, end) of a tile (its row map `rows`) written exact 0 by
// the threads `tid` in [0, threads): stores of the widest of 16, 8, 4 and 2 bytes that
// divides a row (hd * 2 bytes) and out's address (16 at an aligned row
// of a multiple of 8 head dims, 2 at an odd head_dim such as 257). A
// thread keeps one word of a row and steps over rows where a row's
// words fit the threads (every 16-byte row up to head_dim 1024).
template <typename T, typename C, typename Rows>
__device__ __forceinline__ void wg_zero_rows(const WgArgs<T, C>& a,
                                             const Rows& rows, int begin,
                                             int end, int tid, int threads) {
  const uint32_t align = (uint32_t)(a.hd * 2) |
                         (uint32_t)reinterpret_cast<uintptr_t>(a.out);
  auto zero = [&](auto width) {
    constexpr int ZB = decltype(width)::value;
    using Word = std::conditional_t<
        ZB == 16, uint4,
        std::conditional_t<ZB == 8, uint2,
                           std::conditional_t<ZB == 4, uint32_t, uint16_t>>>;
    const int per_row = a.hd * 2 / ZB;
    if (per_row <= threads) {
      const int step = threads / per_row;  // rows a pass
      const int j = tid % per_row;
      if (tid < step * per_row)
        for (int r = begin + tid / per_row; r < end; r += step)
          reinterpret_cast<Word*>(a.out + rows.offset(r))[j] = Word{};
    } else {
      for (int i = tid; i < (end - begin) * per_row; i += threads) {
        const int r = i / per_row;
        reinterpret_cast<Word*>(a.out + rows.offset(begin + r))
            [i - r * per_row] = Word{};
      }
    }
  };
  if ((align & 15) == 0)
    zero(std::integral_constant<int, 16>());
  else if ((align & 7) == 0)
    zero(std::integral_constant<int, 8>());
  else if ((align & 3) == 0)
    zero(std::integral_constant<int, 4>());
  else
    zero(std::integral_constant<int, 2>());
}

// The barriers of a block: stage full/empty, tile slot full/empty, q
// slot full/empty.
template <typename C, int D>
struct WgBars {
  using L = WgSmem<C, D>;
  uint32_t full, empty, tile_full, tile_empty, q_full, q_empty;
  __device__ __forceinline__ explicit WgBars(uint32_t base)
      : full(base + L::bars),
        empty(full + L::kStages * 8),
        tile_full(empty + L::kStages * 8),
        tile_empty(tile_full + 2 * 8),
        q_full(tile_empty + 2 * 8),
        q_empty(q_full + L::kQSlots * 8) {}
};

// ---- the producer -----------------------------------------------------------

// The ring units of a tile of n spans in the wide form, in the order the
// producer fills them and the consumers release them: K0, K1, V0, K2,
// V1, ..., K(n - 1), V(n - 2), V(n - 1). The unit of span c's K and of
// its V, and the span and plane (V) of unit p.
__device__ __forceinline__ int wg_wide_k_unit(int c) {
  return c == 0 ? 0 : 2 * c - 1;
}
__device__ __forceinline__ int wg_wide_v_unit(int c, int n) {
  return min(2 * c + 2, 2 * n - 1);
}
__device__ __forceinline__ int wg_wide_unit_span(int p, int n, bool& v) {
  v = p == 2 * n - 1 || (p > 0 && (p & 1) == 0);
  return p == 2 * n - 1 ? n - 1 : v ? p / 2 - 1 : (p + 1) / 2;
}

// The producer warpgroup's walk. For each tile k it takes from the
// scheduler (thread 0): publish it in tile slot k % 2 with its row's
// kv_len and the policy's info (prefill: the chunk start), copy its q
// into the next q slot, and stage its spans: page ids, copies, int8
// conversion, `full` arrivals; an `empty` wait before a slot is reused.
// g counts the block's ring units (unit g fills stage g % kStages,
// across tiles): a span's one unit, or the wide form's two. Tiles with
// dead rows (Tiles::kDeadRows): the consumers write their zeros; a tile
// with no live row takes no q slot and no ring unit (q slots count live
// tiles, kq, published with the tile).
template <typename T, typename C, int D, typename Tiles = WgPrefillTiles>
__device__ __forceinline__ void wg_produce(const WgArgs<T, C>& a,
                                           unsigned char* smem,
                                           uint32_t base) {
  using L = WgSmem<C, D>;
  constexpr bool QUANT = kQuantized<C>;
  constexpr bool WIDE = L::kWide;
  constexpr int U = WIDE ? 2 : 1;  // ring units a span
  constexpr int S = L::kStages;
  constexpr int QS = L::kQSlots;
  const int tid = threadIdx.x % kWgThreads;
  const int hd = a.hd;
  const int page_size = a.page_size;
  const WgBars<C, D> bars(base);
  const uint32_t full = bars.full;
  const uint32_t empty = bars.empty;
  int* ring = reinterpret_cast<int*>(smem + L::ring);

  // Rows d >= hd of every stage: zero for the whole walk.
  // (16-byte words: 8 a row; the planes lie one after another.)
  const int pad_words = (D - hd) * 8;
  for (int i = tid; i < L::kUnitPlanes * S * pad_words; i += kWgThreads) {
    const int plane = i / pad_words;
    reinterpret_cast<uint4*>(smem + L::tiles + plane * L::kPlane)
        [hd * 8 + i - plane * pad_words] = make_uint4(0, 0, 0, 0);
  }
  fence_proxy_async();

  const bool whole = wg_whole_pages<C>(page_size);
  const int ps_shift = whole ? log2_pow2(page_size) : 0;
  int g = 0;
  int kq = 0;  // live tiles (a q slot each)
  // Thread 0 fetches each tile a tile ahead: the atomic's latency runs
  // under the last tile's copies.
  int next = tid == 0 ? wg_fetch_tile(a.total) : 0;
  for (int k = 0;; ++k) {
    const int slot = k & 1;
    int* entry = ring + slot * 4;
    if (k >= 2) mbar_wait(bars.tile_empty + slot * 8, ((k >> 1) - 1) & 1);
    if (tid == 0) entry[0] = next;
    named_bar_sync(kWgProducerBar, kWgThreads);
    const int index = entry[0];
    if (index < 0) {
      if (tid == 0) mbar_arrive(bars.tile_full + slot * 8);
      break;
    }
    const int pairs = a.num_kv_heads * a.batch;
    const int b = (index % pairs) / a.num_kv_heads;
    const int kv_len = a.kv_lens[b];
    const int info = Tiles::info(a, b);
    const auto t = Tiles::template tile<D>(a, index, kv_len, info);
    if (tid == 0) {
      entry[1] = kv_len;
      entry[2] = info;
      if constexpr (Tiles::kDeadRows) entry[3] = kq;  // q slots taken
      mbar_arrive(bars.tile_full + slot * 8);
      next = wg_fetch_tile(a.total);
    }
    if constexpr (Tiles::kDeadRows) {
      if (t.nrows == 0) continue;  // the consumers write its zeros
    }

    // q of the tile's rows into q slot kq % QS, as the consumers read it
    // (warpgroup w's rows 64 w .. 64 w + 63 at w * kQTile, D / 64 column
    // blocks of [64][64] in the swizzle; the wide form's one tile of 64
    // rows); rows past nrows and head dims past hd as zeros.
    const int lq = Tiles::kDeadRows ? kq++ : k;
    const int qs = lq % QS;
    if (lq >= QS) mbar_wait(bars.q_empty + qs * 8, ((lq / QS) - 1) & 1);
    const uint32_t q_slot = base + L::q + qs * L::kQSlot;
    const int rows = wg_tile_rows<D>(a);
    auto q_at = [&](int r, int d) {
      return q_slot + (r >> 6) * L::kQTile + (d >> 6) * (kWgRows * 128) +
             swz128(r & 63, (d & 63) * 2);
    };
    // Copies of qb bytes: the widest that divides a row and q's address
    // (16, 8 or 4 bytes, asynchronous; 2 at an odd head_dim, a load and
    // a store that the producer waits for).
    auto copy_q = [&](auto width) {
      constexpr int QB = decltype(width)::value;
      constexpr int kPerRow = D * 2 / QB;
#pragma unroll 2
      for (int i = tid; i < rows * kPerRow; i += kWgThreads) {
        const int r = i / kPerRow;
        const int d = (i - r * kPerRow) * (QB / 2);
        const bool live = r < t.nrows && d < hd;
        cp_async_bytes(q_at(r, d), live ? a.q + t.rows.offset(r) + d : a.q,
                       QB, live);
      }
    };
    const int qb = wg_q_copy_bytes(a);
    if (qb == 16)
      copy_q(std::integral_constant<int, 16>());
    else if (qb == 8)
      copy_q(std::integral_constant<int, 8>());
    else if (qb == 4)
      copy_q(std::integral_constant<int, 4>());
    else
      copy_q(std::integral_constant<int, 2>());
    if (qb >= 4) {
      cp_async_mbar_arrive(bars.q_full + qs * 8);
    } else {
      cp_async_commit();
      cp_async_wait<0>();
      fence_proxy_async();
      mbar_arrive(bars.q_full + qs * 8);
    }

    // This kv head's pages and scales: offsets from the caches' bases,
    // one for K and V alike (fewer registers held across the spans).
    const size_t head_off =
        a.layer.data() + t.h * (size_t)a.num_pages * hd * page_size;
    const size_t scale_off =
        a.layer.scale() + t.h * (size_t)a.num_pages * page_size;
    const int* pt_row = a.page_table + (size_t)t.b * a.max_pages;
    const int pages_live = min((kv_len + page_size - 1) / page_size,
                               a.max_pages);

    // Page j = tid of span c's pages, or -1 (none, or past the live ones).
    auto page_id = [&](int c) {
      const int first = c * kWgSpan / page_size;
      const int lp = first + tid;
      return tid <= (c * kWgSpan + kWgSpan - 1) / page_size - first &&
                     lp < pages_live
                 ? pt_row[lp]
                 : -1;
    };
    // The ids of the span being staged, loaded a span ahead (their load
    // runs under the last span's copies) and published in shared memory
    // (the wide form: two spans' ids, span c's at c % 2, as V(c - 1) is
    // staged after K(c)).
    int* pids = reinterpret_cast<int*>(smem + L::pages);
    int id = t.n_spans > 0 ? page_id(0) : -1;

    // Copies of span c's K (planes & 1) and V (planes & 2): rows d < hd,
    // a unit of T planes, or raw int8 planes of 64 bytes a row; and,
    // int8, the planes' 64 scales each at `scales` (K's, then V's). A
    // span's K is staged first, and publishes its page ids.
    auto stage = [&](int c, int planes, uint32_t dst_k, uint32_t dst_v,
                     uint32_t scales) {
      // The ids published last (the wide form: two spans back) and,
      // int8, the raw slot are read.
      named_bar_sync(kWgProducerBar, kWgThreads);
      int* ids = pids + (WIDE ? (c & 1) * kWgSpan : 0);
      if (planes & 1) {
        if (tid < kWgSpan) ids[tid] = id;
        named_bar_sync(kWgProducerBar, kWgThreads);
        if (c + 1 < t.n_spans) id = page_id(c + 1);
      }
      const int pos0 = c * kWgSpan;
      const int first = pos0 / page_size;
      if (whole) {
        constexpr int kVec = 16 / sizeof(C);  // tokens a copy
        const int tp_shift = min(ps_shift, 6);  // tokens of a page a span
        const int lo = pos0 - (first << ps_shift);
#pragma unroll 2
        for (int i = tid; i < D * kWgSpan / kVec; i += kWgThreads) {
          const int e = i * kVec;  // (j * D + d) * tp + col
          const int jd = e >> tp_shift;
          const int j = jd / D;
          const int d = jd - j * D;
          const int col = e & ((1 << tp_shift) - 1);
          const int pid = ids[j];
          const bool live = pid >= 0 && d < hd;
          const size_t src =
              live ? ((((size_t)pid * hd + d) << ps_shift) + lo + col) : 0;
          const int tok = (j << tp_shift) + col;
          const uint32_t o = QUANT ? (uint32_t)(d * kWgSpan + tok)
                                   : swz128(d, tok * 2);
          if (planes & 1)
            cp_async16(dst_k + o, a.k_cache + head_off + src, live);
          if (planes & 2)
            cp_async16(dst_v + o, a.v_cache + head_off + src, live);
        }
      } else {
        constexpr int esz = sizeof(C);
        const int vec = copy_elems(page_size, esz);
        const int row_shift = log2_pow2(kWgSpan / vec);  // copies a row
        for (int i = tid; i < hd << row_shift; i += kWgThreads) {
          const int d = i >> row_shift;
          const int col = (i - (d << row_shift)) * vec;
          const int pos = pos0 + col;
          const int lp = pos / page_size;
          const int pid = ids[lp - first];
          const bool live = pid >= 0;
          const size_t src = live ? (((size_t)pid * hd + d) * page_size +
                                     (pos - lp * page_size)) * esz
                                  : 0;
          const uint32_t o = QUANT ? (uint32_t)(d * kWgSpan + col)
                                   : swz128(d, col * 2);
          if (planes & 1)
            cp_async_bytes(dst_k + o,
                           reinterpret_cast<const unsigned char*>(
                               a.k_cache + head_off) + src,
                           vec * esz, live);
          if (planes & 2)
            cp_async_bytes(dst_v + o,
                           reinterpret_cast<const unsigned char*>(
                               a.v_cache + head_off) + src,
                           vec * esz, live);
        }
      }
      if constexpr (QUANT) {
        // One scale a thread: K's 64, then V's (the wide form: its
        // plane's 64).
        const bool v_scale = WIDE ? planes == 2 : tid >= kWgSpan;
        if (!WIDE || tid < kWgSpan) {
          const int pos = pos0 + (tid & (kWgSpan - 1));
          const int lp = pos / page_size;
          const int pid = ids[lp - first];
          const bool live = pid >= 0;
          const size_t src =
              live ? (size_t)pid * page_size + (pos - lp * page_size) : 0;
          cp_async_bytes(scales + tid * 4,
                         (v_scale ? a.v_scale : a.k_scale) + scale_off + src,
                         4, live);
        }
      }
    };
    // Unit p of the tile into the ring unit at `dst` (T planes, or raw
    // planes and their scales at `scales`).
    auto stage_unit = [&](int p, uint32_t dst, uint32_t scales) {
      if constexpr (WIDE) {
        bool v;
        const int c = wg_wide_unit_span(p, t.n_spans, v);
        stage(c, v ? 2 : 1, dst, dst, scales);
      } else {
        stage(p, 3, dst, dst + (QUANT ? L::kRawPlane : L::kPlane), scales);
      }
    };
    const int units = t.n_spans * U;

    if constexpr (!QUANT) {
      for (int p = 0; p < units; ++p, ++g) {
        const int s = g % S;
        if (g >= S) mbar_wait(empty + s * 8, ((g / S) - 1) & 1);
        stage_unit(p, base + L::tiles + s * L::kSlot, 0);
        if (whole) {
          cp_async_mbar_arrive(full + s * 8);
        } else {
          cp_async_commit();
          cp_async_wait<0>();
          fence_proxy_async();
          mbar_arrive(full + s * 8);
        }
      }
    } else {
      constexpr int RS = L::kRawStages;
      constexpr int kScaleCount = L::kUnitPlanes * kWgSpan;
      // Unit p's raw planes and scales into raw slot p % RS; one group
      // committed a call, empty past the tile, so that the wait below
      // counts groups the same way at every unit.
      auto issue_raw = [&](int p) {
        if (p < units) {
          const uint32_t r = base + L::raw + (p % RS) * L::kRawSlot;
          stage_unit(p, r, r + L::kUnitPlanes * L::kRawPlane);
        }
        cp_async_commit();
      };
      for (int j = 0; j < RS; ++j) issue_raw(j);
      for (int p = 0; p < units; ++p, ++g) {
        cp_async_wait<RS - 1>();
        named_bar_sync(kWgProducerBar, kWgThreads);  // unit p's raw is in
        const int s = g % S;
        if (g >= S) mbar_wait(empty + s * 8, ((g / S) - 1) & 1);
        const unsigned char* raw = smem + L::raw + (p % RS) * L::kRawSlot;
        unsigned char* tile = smem + L::tiles + s * L::kSlot;
        // 16 raw tokens of one head dim a step, K's plane then V's (the
        // wide form: its one plane): two swizzled 16-byte chunks of T.
        for (int i = tid; i < hd * 4 * L::kUnitPlanes; i += kWgThreads) {
          const int which = i >= hd * 4;
          const int e = i - which * hd * 4;  // d * 4 + chunk pair
          const int d = e >> 2;
          const uint4 rv = *reinterpret_cast<const uint4*>(
              raw + which * L::kRawPlane + e * 16);
          const int8_t* x = reinterpret_cast<const int8_t*>(&rv);
          unsigned char* row = tile + which * L::kPlane;
#pragma unroll
          for (int h = 0; h < 2; ++h)
            *reinterpret_cast<uint4*>(row + swz128(d, (e & 3) * 32 + h * 16)) =
                make_uint4(pack2<T>((float)x[8 * h], (float)x[8 * h + 1]),
                           pack2<T>((float)x[8 * h + 2], (float)x[8 * h + 3]),
                           pack2<T>((float)x[8 * h + 4], (float)x[8 * h + 5]),
                           pack2<T>((float)x[8 * h + 6], (float)x[8 * h + 7]));
        }
        if (kScaleCount == kWgThreads || tid < kScaleCount)
          reinterpret_cast<float*>(smem + L::scales + s * L::kScales)[tid] =
              reinterpret_cast<const float*>(
                  raw + L::kUnitPlanes * L::kRawPlane)[tid];
        fence_proxy_async();
        mbar_arrive(full + s * 8);
        // stage() starts with a producer barrier: every thread has read
        // raw slot p % RS before unit p + RS's copies overwrite it.
        issue_raw(p + RS);
      }
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
}

// ---- the consumers ----------------------------------------------------------

// Two floats of shared memory at `addr`, read where the code stands (an
// int8 cache's scales: the compiler does not gather a span's sixteen
// loads ahead into registers the tile 256 has none of).
__device__ __forceinline__ float2 ld_shared_f2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y)
               : "r"(addr));
  return v;
}

// exp2 on the multi-function unit, subnormal results flushed to 0 (a
// probability under 2^-126 of the row's largest).
__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The first half of one span's online softmax for this thread's two
// rows: scores `s` (64 tokens from cbase) masked where the span cuts a
// row's limit, the new row maxima m (in units of log2, the scale
// log2(e) / sqrt(hd) folded), and p = exp2(s * scale - m) in place of s
// as one fused multiply-add and an exp2 (an int8 cache first scales
// each column by its k_scale); l rescaled and summed over the unrounded
// p. Returns the rescale factors of acc (a0, a1): it needs no product
// to have completed, so it runs while the last span's p . v does.
template <bool QUANT>
__device__ __forceinline__ void wg_softmax_p(
    float (&s)[kWgSpan / 8][4], float& m0, float& m1, float& l0, float& l1,
    float& a0, float& a1, int cbase, int lim0, int lim1, float scale_log2,
    uint32_t kss, int quad) {
  const bool cut = cbase + kWgSpan > min(lim0, lim1);
  float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
  for (int nt = 0; nt < kWgSpan / 8; ++nt) {
    const int tok = nt * 8 + quad * 2;
    if constexpr (QUANT) {
      const float2 k2 = ld_shared_f2(kss + tok * 4);
      const float f0 = scale_log2 * k2.x, f1 = scale_log2 * k2.y;
      s[nt][0] *= f0;
      s[nt][1] *= f1;
      s[nt][2] *= f0;
      s[nt][3] *= f1;
    }
    if (cut) {
      const int pos = cbase + tok;
      if (pos >= lim0) s[nt][0] = kNegInf;
      if (pos + 1 >= lim0) s[nt][1] = kNegInf;
      if (pos >= lim1) s[nt][2] = kNegInf;
      if (pos + 1 >= lim1) s[nt][3] = kNegInf;
    }
    mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
    mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  const float f = QUANT ? 1.f : scale_log2;  // the scale not yet applied
  const float mn0 = fmaxf(m0, mx0 * f);
  const float mn1 = fmaxf(m1, mx1 * f);
  a0 = ex2_ftz(m0 - mn0);
  a1 = ex2_ftz(m1 - mn1);
  m0 = mn0;
  m1 = mn1;
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int nt = 0; nt < kWgSpan / 8; ++nt) {
    s[nt][0] = ex2_ftz(fmaf(s[nt][0], f, -mn0));
    s[nt][1] = ex2_ftz(fmaf(s[nt][1], f, -mn0));
    s[nt][2] = ex2_ftz(fmaf(s[nt][2], f, -mn1));
    s[nt][3] = ex2_ftz(fmaf(s[nt][3], f, -mn1));
    sum0 += s[nt][0] + s[nt][1];
    sum1 += s[nt][2] + s[nt][3];
  }
  l0 = l0 * a0 + sum0;
  l1 = l1 * a1 + sum1;
}

// The second half, once the last span's p . v has completed: acc
// rescaled, and p (times v_scale, an int8 cache) packed to T as the A
// fragments of p . v.
template <typename T, bool QUANT, int DN>
__device__ __forceinline__ void wg_softmax_pack(
    const float (&p)[kWgSpan / 8][4], float (&acc)[DN][4],
    uint32_t (&pa)[kWgSpan / 16][4], float a0, float a1,
    uint32_t vss, int quad) {
#pragma unroll
  for (int i = 0; i < DN; ++i) {
    acc[i][0] *= a0;
    acc[i][1] *= a0;
    acc[i][2] *= a1;
    acc[i][3] *= a1;
  }
#pragma unroll
  for (int nt = 0; nt < kWgSpan / 8; ++nt) {
    float p0 = p[nt][0], p1 = p[nt][1], p2 = p[nt][2], p3 = p[nt][3];
    if constexpr (QUANT) {
      const float2 v2 =
          ld_shared_f2(vss + (nt * 8 + quad * 2) * 4);
      p0 *= v2.x;
      p1 *= v2.y;
      p2 *= v2.x;
      p3 *= v2.y;
    }
    pa[nt >> 1][(nt & 1) * 2 + 0] = pack2<T>(p0, p1);
    pa[nt >> 1][(nt & 1) * 2 + 1] = pack2<T>(p2, p3);
  }
}

// Wait until at most n (0, 1 or 2) of the warpgroup's product groups are
// pending.
__device__ __forceinline__ void wgmma_wait_at_most(int n) {
  if (n == 0)
    wgmma_wait<0>();
  else if (n == 1)
    wgmma_wait<1>();
  else
    wgmma_wait<2>();
}

// The walk of one consumer warpgroup: its 64 rows [wg * 64, wg * 64 +
// 64) of each tile the producer publishes (the wide form: all 64 rows
// of the tile, and the output head dims [wg * D / 2, (wg + 1) * D / 2)).
// Fragment coordinates as in page_walk_block_mma: lane = 4 * grp + quad
// holds rows warp * 16 + grp and + 8. g counts the block's ring units,
// as the producer counts them.
//
// The products run ahead of the softmax: span c's p . v is in flight
// while span c + 1's softmax runs, and (PIPE, D <= 128, where a second
// score buffer fits beside the accumulators) span c + 1's q . k^T while
// span c's does. A unit is released once its last product has completed
// (the wide form's K once the span's scores are in and scaled), the q
// slot once the output has left it. With dead rows (Tiles::kDeadRows),
// the warpgroup's rows past the live ones are then written exact 0; a
// tile with no live row is only zeros, from every consumer warpgroup.
template <typename T, typename C, int D, typename Tiles = WgPrefillTiles>
__device__ __forceinline__ void wg_consume(const WgArgs<T, C>& a,
                                           unsigned char* smem,
                                           uint32_t base, int wg) {
  using L = WgSmem<C, D>;
  constexpr bool QUANT = kQuantized<C>;
  constexpr bool WIDE = L::kWide;
  constexpr bool PIPE = D <= 128;
  // At the tile 256 (no second score buffer), the early release:
  // span c's p . v is issued before span c + 1's q . k^T waits for its
  // stage, and span c - 1's stage is released as soon as span c's
  // scores are in (p . v of c - 1, issued before them, is in too): the
  // copy of span c + 1 then runs under span c's softmax and p . v
  // instead of after them. (Where a tile's rows are few, as a decode
  // row's, a span's time is its copy's.) Both tile policies take it
  // (tools/kernel_times.py A/B medians, L2 flushed, H100 80GB HBM3,
  // 700 W; ms): ragged's g3_d256 unified block 0.1929 -> 0.1720;
  // prefill's g3_d256 first chunk 0.0912 -> 0.0856 (int8 0.1266 ->
  // 0.1172), second chunk 0.1922 -> 0.1709 (int8 0.2721 -> 0.2497).
  constexpr bool EARLY = !PIPE && !WIDE;
  constexpr int S = L::kStages;
  constexpr int QS = L::kQSlots;
  constexpr int KS = D / 16;           // k steps of q . k^T
  constexpr int DO = WIDE ? D / 2 : D;  // output head dims a warpgroup
  constexpr int DN = DO / 8;           // n tiles of the output
  static_assert(D % 16 == 0, "a head-dim tile must tile the k step");
  const int hd = a.hd;
  const int tid = threadIdx.x % kWgThreads;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int grp = lane >> 2;
  const int quad = lane & 3;
  const int r0 = warp * 16 + grp;
  const int r1 = r0 + 8;
  const int col0 = WIDE ? wg * DO : 0;  // this warpgroup's first output dim
  const WgBars<C, D> bars(base);
  const uint32_t full = bars.full;
  const uint32_t empty = bars.empty;
  const int* ring = reinterpret_cast<const int*>(smem + L::ring);
  const float scale_log2 = rsqrtf((float)hd) * kLog2e;

  int g = 0;
  for (int k = 0;; ++k) {
    const int slot = k & 1;
    mbar_wait(bars.tile_full + slot * 8, (k >> 1) & 1);
    const int index = ring[slot * 4];
    const int kv_len = ring[slot * 4 + 1];
    const int info = ring[slot * 4 + 2];
    // Dead rows: the live tiles before this one (their q slots), as the
    // producer counted them; read from the slot, not held across tiles.
    const int lq = Tiles::kDeadRows ? ring[slot * 4 + 3] : k;
    __syncwarp();
    if (lane == 0) mbar_arrive(bars.tile_empty + slot * 8);
    if (index < 0) break;
    auto t = Tiles::template tile<D>(a, index, kv_len, info);
    if constexpr (Tiles::kDeadRows) {
      if (t.nrows == 0) {  // its zeros, from every consumer warpgroup
        wg_zero_rows(a, t.rows, 0, t.end, (int)threadIdx.x,
                     a.consumers * kWgThreads);
        continue;
      }
    }
    const int n_spans = t.n_spans;
    int wrows = t.nrows;
    if constexpr (!WIDE) {
      wrows = max(0, min(kWgRows, t.nrows - wg * kWgRows));
      t.rows.row0 += wg * kWgRows;
      t.mask.row0 += wg * kWgRows;
    }
    const int lim0 = r0 < wrows ? t.mask.limit(r0) : 0;
    const int lim1 = r1 < wrows ? t.mask.limit(r1) : 0;
    const int wmax = wrows > 0 ? t.mask.max_limit(wrows) : 0;
    const int wspans = (wmax + kWgSpan - 1) / kWgSpan;  // warpgroup-uniform
    const int qs = lq % QS;
    const int q_off = L::q + qs * L::kQSlot + (WIDE ? 0 : wg * L::kQTile);
    const uint32_t q_tile = base + q_off;
    // The ring units of span c's K and V (the wide form's order; one
    // unit for both in the others).
    auto k_unit = [&](int c) { return g + (WIDE ? wg_wide_k_unit(c) : c); };
    auto v_unit = [&](int c) {
      return g + (WIDE ? wg_wide_v_unit(c, n_spans) : c);
    };
    auto wait_full = [&](int u) {
      mbar_wait(full + (u % S) * 8, (u / S) & 1);
      fence_proxy_async();
    };

    float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
    float acc[DN][4];
    float sa[kWgSpan / 8][4], sb[kWgSpan / 8][4];
#pragma unroll
    for (int i = 0; i < DN; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll
    for (int i = 0; i < kWgSpan / 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sa[i][j] = sb[i][j] = 0.f;
    if constexpr (WIDE) {
      // The zeros in place before the first product is issued: sunk
      // past it, ptxas serializes every wgmma of the kernel.
      wgmma_fence_regs(acc);
      wgmma_fence_regs(sa);
    }
    mbar_wait(bars.q_full + qs * 8, (lq / QS) & 1);

    // S = q . K^T of span c into `dst` (one committed group): q's slot is
    // A (K-major, 32 bytes a k step within a 64-column block); K's
    // [D][64] plane is B with N (the token) contiguous, k steps of 16
    // head dims (2048 bytes).
    auto issue_s = [&](int c, float (&dst)[kWgSpan / 8][4]) {
      const int u = k_unit(c);
      wait_full(u);
      const uint32_t k_plane = base + L::tiles + (u % S) * L::kSlot;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        Wgmma<T, kWgSpan>::template ss<1>(
            dst,
            wg_desc(q_tile + (kk >> 2) * (kWgRows * 128) + (kk & 3) * 32, 16,
                    1024),
            wg_desc(k_plane + kk * 2048, L::kPlane, 1024), kk > 0);
      wgmma_commit();
    };
    auto release = [&](int u) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + (u % S) * 8);
    };

    // Span c of the warpgroup's walk: S(c) in `cur` was issued (and,
    // PIPE, is issued into `nxt` for span c + 1 here); pending before
    // the first wait: S(c), p . v of c - 1, S(c + 1) (PIPE).
    auto span = [&](int c, float (&cur)[kWgSpan / 8][4],
                    float (&nxt)[kWgSpan / 8][4]) {
      const bool next = c + 1 < wspans;
      if (PIPE && next) issue_s(c + 1, nxt);
      // S(c) is in (EARLY: and p . v of c - 1, issued before it).
      wgmma_wait_at_most(EARLY ? 0 : (c > 0) + (PIPE && next));
      wgmma_fence_regs(cur);
      if (EARLY && c > 0) {
        wgmma_fence_regs(acc);
        release(v_unit(c - 1));
      }
      const int cbase = c * kWgSpan;
      const int sk = k_unit(c) % S;
      const int sv = v_unit(c) % S;
      const uint32_t kss = base + L::scales + sk * L::kScales;
      const uint32_t vss =
          WIDE ? base + L::scales + sv * L::kScales : kss + kWgSpan * 4;
      float a0, a1;
      wg_softmax_p<QUANT>(cur, m0, m1, l0, l1, a0, a1, cbase, lim0, lim1,
                          scale_log2, kss, quad);
      if (WIDE) release(k_unit(c));  // K(c) and its scales are read
      if (!EARLY && c > 0) {
        wgmma_wait_at_most(PIPE && next);  // p . v of c - 1 is in
        wgmma_fence_regs(acc);
        release(v_unit(c - 1));
      }
      // The wide form's V unit: before p's pack where it carries the
      // scales (int8), else after S(c + 1) is issued.
      if (WIDE && QUANT) wait_full(v_unit(c));
      uint32_t pa[kWgSpan / 16][4];
      wg_softmax_pack<T, QUANT, DN>(cur, acc, pa, a0, a1, vss, quad);
      if (!PIPE && !EARLY && next) issue_s(c + 1, cur);
      if (WIDE && !QUANT) wait_full(v_unit(c));
      // O += P . V over the 16-token groups any row here can see: V's
      // plane (from this warpgroup's first output dim) is B with K (the
      // token) contiguous, 32 bytes a k step.
      const uint32_t v_plane = base + L::tiles + sv * L::kSlot +
                               (WIDE ? col0 * 128 : L::kPlane);
      const int groups = min(kWgSpan / 16, (wmax - cbase + 15) >> 4);
      wgmma_fence();
#pragma unroll
      for (int kt = 0; kt < kWgSpan / 16; ++kt)
        if (kt < groups)
          Wgmma<T, DO>::template rs<0>(
              acc, pa[kt], wg_desc(v_plane + kt * 32, 16, 1024), 1);
      wgmma_commit();
      if (EARLY && next) issue_s(c + 1, cur);
    };

    if (wspans > 0) issue_s(0, sa);
    for (int c = 0; c < wspans; c += 2) {
      span(c, sa, PIPE ? sb : sa);
      if (c + 1 < wspans) span(c + 1, PIPE ? sb : sa, sa);
    }
    // (The wide form waits whatever wspans is: ptxas, which does not
    // tie this test to the one that issued the products, otherwise
    // serializes every wgmma of the kernel.)
    if (WIDE || wspans > 0) {
      wgmma_wait<0>();
      wgmma_fence_regs(acc);
      if (wspans > 0) release(v_unit(wspans - 1));
    }
    // Spans past this warpgroup's rows: released as they fill, in order
    // (none in the wide form, whose warpgroups see every row).
    if constexpr (!WIDE) {
      for (int c = wspans; c < n_spans; ++c) {
        mbar_wait(full + ((g + c) % S) * 8, ((g + c) / S) & 1);
        release(g + c);
      }
    }
    g += n_spans * (WIDE ? 2 : 1);
    // Above 128 the row map is rebuilt rather than held across the spans
    // (the accumulators leave no register to spare).
    auto rows = t.rows;
    int end = t.end;
    if constexpr (D > 128) {
      const auto tt = Tiles::template tile<D>(a, index, kv_len, info);
      rows = tt.rows;
      end = tt.end;
      if constexpr (!WIDE) rows.row0 += wg * kWgRows;
    }

    if (!wg_rows_in_16(a)) {
      // Rows that are not whole 16-byte units: stored from registers
      // (mma_store_rows adds the quad's four parts of l).
      mma_store_rows<T, DN>(a.out, rows, r0, r1, wrows, acc, l0, l1, col0,
                            WIDE ? min(DO, hd - col0) : hd, hd, quad);
    } else {
      // The rows acc / l into the q slot (its last reader, this
      // warpgroup's q . k^T, has completed; the wide form's, both
      // warpgroups': the pair barrier) in the swizzle, then rows out of
      // it a 16-byte chunk a thread.
      l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
      l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
      const float inv0 = 1.f / fmaxf(l0, 1e-30f);
      const float inv1 = 1.f / fmaxf(l1, 1e-30f);
      unsigned char* o_tile = smem + q_off;
      if constexpr (WIDE) named_bar_sync(kWgPairBar, 2 * kWgThreads);
#pragma unroll
      for (int i = 0; i < DN; ++i) {
        const int d = col0 + i * 8 + quad * 2;
        unsigned char* col = o_tile + (d >> 6) * (kWgRows * 128);
        *reinterpret_cast<uint32_t*>(col + swz128(r0, (d & 63) * 2)) =
            pack2<T>(acc[i][0] * inv0, acc[i][1] * inv0);
        *reinterpret_cast<uint32_t*>(col + swz128(r1, (d & 63) * 2)) =
            pack2<T>(acc[i][2] * inv1, acc[i][3] * inv1);
      }
      named_bar_sync(kWgQBar + wg, kWgThreads);
#pragma unroll 4
      for (int i = tid; i < wrows * (DO / 8); i += kWgThreads) {
        const int r = i / (DO / 8);
        const int d = col0 + (i - r * (DO / 8)) * 8;
        if (d < hd)
          *reinterpret_cast<uint4*>(a.out + rows.offset(r) + d) =
              *reinterpret_cast<const uint4*>(
                  o_tile + (d >> 6) * (kWgRows * 128) +
                  swz128(r, (d & 63) * 2));
      }
      named_bar_sync(kWgQBar + wg, kWgThreads);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(bars.q_empty + qs * 8);
    if constexpr (Tiles::kDeadRows) {
      // The tile's dead rows after its live ones: this warpgroup's 64
      // (the wide form: the tile's, shared by both warpgroups).
      if constexpr (WIDE)
        wg_zero_rows(a, rows, wrows, end, tid + wg * kWgThreads,
                     2 * kWgThreads);
      else
        wg_zero_rows(a, rows, wrows,
                     min(kWgRows, max(0, end - wg * kWgRows)), tid,
                     kWgThreads);
    }
  }
}

// ---- the block --------------------------------------------------------------

// One persistent block of `consumers` consumer warpgroups and one
// producer warpgroup (threadIdx.x / 128 == consumers), walking the tiles
// the scheduler gives it.
template <typename T, typename C, int D, typename Tiles = WgPrefillTiles>
__device__ __forceinline__ void page_walk_block_wgmma(const WgArgs<T, C>& a) {
  using L = WgSmem<C, D>;
  extern __shared__ unsigned char smem_wg[];
  const uint32_t raw_base = smem_u32(smem_wg);
  const uint32_t pad = ((raw_base + 1023u) & ~1023u) - raw_base;
  unsigned char* smem = smem_wg + pad;
  const uint32_t base = raw_base + pad;

  const WgBars<C, D> bars(base);
  if (threadIdx.x == 0) {
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(bars.full + s * 8, kWgThreads);
      mbar_init(bars.empty + s * 8, a.consumers * 4);  // a consumer warp each
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(bars.tile_full + s * 8, 1);
      mbar_init(bars.tile_empty + s * 8, a.consumers * 4);
    }
    for (int s = 0; s < L::kQSlots; ++s) {
      mbar_init(bars.q_full + s * 8, kWgThreads);
      mbar_init(bars.q_empty + s * 8, a.consumers * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x / kWgThreads == a.consumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        wg_producer_regs(D)));
    wg_produce<T, C, D, Tiles>(a, smem, base);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        wg_consumer_regs(D)));
    wg_consume<T, C, D, Tiles>(a, smem, base, threadIdx.x / kWgThreads);
  }
}

}  // namespace pstt
