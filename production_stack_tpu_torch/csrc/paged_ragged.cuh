// The ragged kernels' templates and their launch (paged_ragged.cu
// describes the design and holds the C interface). paged_ragged_bf16.cu,
// paged_ragged_f16.cu and paged_ragged_f32.cu instantiate them a query
// type each, and paged_ragged_wgmma_bf16.cu and paged_ragged_wgmma_f16.cu
// the 16-bit forms on the wgmma walk (head dims 129 to 512), so the five
// compile in parallel.

#pragma once

#include <limits.h>

#include <algorithm>

#include "paged_kv_common.cuh"
#include "paged_walk_mma.cuh"
#include "paged_walk_wgmma.cuh"

namespace pstt {

// One launch's operands and shapes.
struct RaggedArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* ks;
  const void* vs;
  const void* pt;
  const void* kv_lens;
  const void* last_index;
  void* out;
  int rows, width, num_q_heads, num_kv_heads, head_dim, num_pages,
      page_size, max_pages;
  LayerOffsets layer;
  cudaStream_t stream;
};

// The walks a launch can take, in the order of
// pstt_ragged_walk_launches's index (paged_ragged.cu): PR 6's mma.sync
// walk (16-bit, head dims up to 128), the wgmma walk at the tile 256
// and its wide form (16-bit, 129 to 256 and 257 to 512), the mma.sync
// slab walk (16-bit above 512) and the f32 walk.
enum RaggedWalk { kRaggedMma, kRaggedWgmma, kRaggedWgmmaWide,
                  kRaggedMmaSlab, kRaggedF32, kRaggedWalks };

// Adds one to the walk's count of launches the runtime took
// (paged_ragged.cu).
void count_ragged_walk(RaggedWalk walk);

// Whether a 16-bit head_dim runs on the wgmma walk: at the tile 256
// (129 to 256) or at a width of its wide form (257 to 512).
__host__ __device__ constexpr bool ragged_wgmma_head_dim(int head_dim) {
  return head_dim_slabs(head_dim) == 1 ? head_dim_tile(head_dim) == kMaxHeadDim
                                       : wg_wide_width(head_dim) != 0;
}

// The wgmma walk's ragged tile order, mirrored by the host
// (ops/ragged_attention_cuda.ragged_wg_tile): of a (row, kv head) pair
// whose live rows fill `live_tiles` tiles (ceil((last_index + 1) * G /
// tile rows), 0 for a pad row), round z takes tile live_tiles - 1 - z
// while z < live_tiles, then tile z. A bijection over the pair's tiles,
// from last_index alone; launch index z * pairs + pair, so every pair's
// heaviest live tile (its highest slots, which see the most tokens)
// comes before its lighter ones, and every live tile of round z before
// any tile of round z + 1.
__host__ __device__ constexpr int ragged_wg_tile(int z, int live_tiles) {
  return z < live_tiles ? live_tiles - 1 - z : z;
}

// The ragged kernel's tiles on the wgmma walk (paged_walk_wgmma.cuh's
// tile policy): the G * W query rows of a (row, kv head) pair slot-major
// (SlotMajorRows), a row's live slots one prefix of them; the
// RaggedMask; `info` the row's last_index (-1 for a pad row, kv_len 0).
// A tile's nrows is its live prefix, its end its rows; the consumer
// warpgroups write rows [nrows, end) exact 0 (a live tile's after its
// output; a tile with no live row, only zeros, from every consumer).
struct WgRaggedTiles {
  static constexpr bool kDeadRows = true;
  using Tile = WgTile<SlotMajorRows, RaggedMask>;

  template <typename T, typename C>
  static __device__ __forceinline__ int info(const WgArgs<T, C>& a, int b) {
    return a.last_index[b];
  }

  template <int D, typename T, typename C>
  static __device__ __forceinline__ Tile tile(const WgArgs<T, C>& a,
                                              int index, int kv_len,
                                              int last_index) {
    Tile t;
    const int pairs = a.num_kv_heads * a.batch;
    const int z = index / pairs;
    const int pair = index - z * pairs;
    t.h = pair % a.num_kv_heads;
    t.b = pair / a.num_kv_heads;
    const int tile_rows = wg_tile_rows<D>(a);
    const int last = kv_len > 0 ? last_index : -1;
    const int live = max(0, (min(last, a.tokens - 1) + 1) * a.group);
    const int row0 =
        ragged_wg_tile(z, (live + tile_rows - 1) / tile_rows) * tile_rows;
    t.end = min(tile_rows, a.group * a.tokens - row0);
    t.nrows = max(0, min(live - row0, t.end));
    t.rows = SlotMajorRows{((size_t)t.b * a.tokens * a.num_q_heads +
                            (size_t)t.h * a.group) * a.hd,
                           a.group, a.num_q_heads, a.hd, row0};
    t.mask = RaggedMask{kv_len, last, a.group, row0};
    t.n_spans = t.nrows > 0 ? (t.mask.max_limit(t.nrows) + kWgSpan - 1) /
                                  kWgSpan
                            : 0;
    return t;
  }
};

namespace {

// cudaGetLastError() after a launch of `walk`, counted where it is 0.
inline int counted_ragged_launch(RaggedWalk walk) {
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) count_ragged_walk(walk);
  return err;
}

constexpr int kRaggedTile = kMmaRows;
constexpr int kRaggedThreads = 256;  // the f32 walk
constexpr int kMmaWarps = kRaggedTile / 16;  // a warp owns 16 rows
constexpr int kMmaThreads = kMmaWarps * 32;

// This block's tile: where its rows live, their mask, and how many of
// them (a prefix) are live.
struct RaggedTile {
  SlotMajorRows rows;
  RaggedMask mask;
  int tile_rows;  // rows of the tile (the last tile may be short)
  int live;       // live rows, a prefix of them
};

__device__ __forceinline__ RaggedTile ragged_tile(
    const int* __restrict__ kv_lens, const int* __restrict__ last_index,
    int width, int num_q_heads, int group, int hd, int h) {
  const int row0 = blockIdx.x * kRaggedTile;
  const int b = blockIdx.z;
  const int tile_rows = min(kRaggedTile, group * width - row0);
  const int kv_len = kv_lens[b];
  const int last = kv_len > 0 ? last_index[b] : -1;
  const int live =
      max(0, min((min(last, width - 1) + 1) * group - row0, tile_rows));
  return {SlotMajorRows{((size_t)b * width * num_q_heads +
                         (size_t)h * group) * hd,
                        group, num_q_heads, hd, row0},
          RaggedMask{kv_len, last, group, row0}, tile_rows, live};
}

// Zeros of `bytes` (1, 2, 4, 8 or 16, aligned) at dst.
__device__ __forceinline__ void store_zero_bytes(void* dst, int bytes) {
  switch (bytes) {
    case 16:
      *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
      break;
    case 8:
      *reinterpret_cast<uint2*>(dst) = make_uint2(0, 0);
      break;
    case 4:
      *reinterpret_cast<uint32_t*>(dst) = 0u;
      break;
    case 2:
      *reinterpret_cast<uint16_t*>(dst) = 0;
      break;
    default:
      *reinterpret_cast<uint8_t*>(dst) = 0;
  }
}

// Rows [tile.live, tile.tile_rows) of the tile: exact 0, one store of
// the widest power of two up to 16 bytes that divides a row (a row is
// hd * sizeof(T) bytes, and starts at a multiple of them): 16 bytes at
// a tile's own head dim (the rows' vectors counted at compile time), 8
// at head_dim 100 in 16 bits. A slab block zeroes its own head dims
// [col0, col0 + cols) of each row (col0 a multiple of kSlabDim).
template <typename T, int D, int NT>
__device__ __forceinline__ void zero_dead_rows(T* __restrict__ out,
                                               const RaggedTile& tile,
                                               int hd, int col0, int cols) {
  if (hd == D) {
    constexpr int kVecs = D * (int)sizeof(T) / 16;
    static_assert(D * sizeof(T) % 16 == 0, "a tile row is whole 16 bytes");
    for (int i = tile.live * kVecs + threadIdx.x;
         i < tile.tile_rows * kVecs; i += NT) {
      const int r = i / kVecs;
      reinterpret_cast<uint4*>(out + tile.rows.offset(r))[i - r * kVecs] =
          make_uint4(0, 0, 0, 0);
    }
    return;
  }
  const int row_bytes = hd * (int)sizeof(T);
  const int seg_bytes = cols * (int)sizeof(T);
  const int vb = min(min(row_bytes & -row_bytes, seg_bytes & -seg_bytes), 16);
  const int per_row = seg_bytes / vb;
  for (int i = tile.live * per_row + threadIdx.x;
       i < tile.tile_rows * per_row; i += NT) {
    const int r = i / per_row;
    store_zero_bytes(reinterpret_cast<unsigned char*>(
                         out + tile.rows.offset(r) + col0) +
                         (i - r * per_row) * vb,
                     vb);
  }
}

// This kv head's (h) pages and (int8 cache) scales, at the launch's
// layer.
template <typename C>
struct RaggedHead {
  const C* k;
  const C* v;
  const float* ks;
  const float* vs;

  __device__ __forceinline__ RaggedHead(const C* k_cache, const C* v_cache,
                                        const float* k_scale,
                                        const float* v_scale,
                                        int num_pages, int page_size,
                                        int hd, LayerOffsets layer, int h) {
    const size_t head_elems = (size_t)num_pages * hd * page_size;
    const size_t head_slots = (size_t)num_pages * page_size;
    k = k_cache + layer.data() + h * head_elems;
    v = v_cache + layer.data() + h * head_elems;
    ks = kQuantized<C> ? k_scale + layer.scale() + h * head_slots : nullptr;
    vs = kQuantized<C> ? v_scale + layer.scale() + h * head_slots : nullptr;
  }
};

// f32 queries: f32 FMA over f32 tiles, with the narrowest row block
// that holds the tile's live rows. SLAB: the slab walk of a head_dim
// above kMaxHeadDim (D = kSlabDim), grid y over kv heads x `slabs`
// slabs, a block one output slab.
template <typename T, typename C, int D, bool SLAB>
__global__ void __launch_bounds__(kRaggedThreads)
paged_ragged_kernel(const T* __restrict__ q, const C* __restrict__ k_cache,
                    const C* __restrict__ v_cache,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int* __restrict__ page_table,
                    const int* __restrict__ kv_lens,
                    const int* __restrict__ last_index, T* __restrict__ out,
                    int width, int num_q_heads, int group, int num_pages,
                    int page_size, int max_pages, LayerOffsets layer,
                    int hd, int slabs) {
  const int h = SLAB ? blockIdx.y / slabs : blockIdx.y;
  const int slab = blockIdx.y - h * slabs;
  const RaggedTile tile =
      ragged_tile(kv_lens, last_index, width, num_q_heads, group, hd, h);
  zero_dead_rows<T, D, kRaggedThreads>(out, tile, hd, SLAB ? slab * D : 0,
                                       SLAB ? slab_rows(hd, slab) : hd);
  if (tile.live == 0) return;
  const RaggedHead<C> head(k_cache, v_cache, k_scale, v_scale, num_pages,
                           page_size, hd, layer, h);
  const int* pt_row = page_table + (size_t)blockIdx.z * max_pages;
  const int kv_len = tile.mask.kv_len;
  if (tile.live <= 8) {
    page_walk_block<T, C, D, 8, 8, kRaggedThreads, SLAB>(
        q, out, tile.rows, head.k, head.v, head.ks, head.vs, pt_row,
        max_pages, page_size, kv_len, tile.mask, tile.live, hd, slabs, slab);
  } else if (tile.live <= 32) {
    page_walk_block<T, C, D, 32, 8, kRaggedThreads, SLAB>(
        q, out, tile.rows, head.k, head.v, head.ks, head.vs, pt_row,
        max_pages, page_size, kv_len, tile.mask, tile.live, hd, slabs, slab);
  } else {
    page_walk_block<T, C, D, kRaggedTile, 16, kRaggedThreads, SLAB>(
        q, out, tile.rows, head.k, head.v, head.ks, head.vs, pt_row,
        max_pages, page_size, kv_len, tile.mask, tile.live, hd, slabs, slab);
  }
}

// 16-bit queries (T bf16 or f16): the same tile and grid on the
// tensor-core walk (SLAB: its slab walk), one row block for every tile
// (warps with no live row skip their products).
template <typename T, typename C, int D, bool SLAB>
__global__ void __launch_bounds__(kMmaThreads,
                                  SLAB ? mma_slab_blocks_per_sm<C>()
                                       : mma_blocks_per_sm<C, D>())
paged_ragged_mma_kernel(const T* __restrict__ q,
                        const C* __restrict__ k_cache,
                        const C* __restrict__ v_cache,
                        const float* __restrict__ k_scale,
                        const float* __restrict__ v_scale,
                        const int* __restrict__ page_table,
                        const int* __restrict__ kv_lens,
                        const int* __restrict__ last_index,
                        T* __restrict__ out, int width,
                        int num_q_heads, int group, int num_pages,
                        int page_size, int max_pages, LayerOffsets layer,
                        int hd, int slabs) {
  const int h = SLAB ? blockIdx.y / slabs : blockIdx.y;
  const int slab = blockIdx.y - h * slabs;
  const RaggedTile tile =
      ragged_tile(kv_lens, last_index, width, num_q_heads, group, hd, h);
  zero_dead_rows<T, D, kMmaThreads>(out, tile, hd, SLAB ? slab * D : 0,
                                    SLAB ? slab_rows(hd, slab) : hd);
  if (tile.live == 0) return;
  const RaggedHead<C> head(k_cache, v_cache, k_scale, v_scale, num_pages,
                           page_size, hd, layer, h);
  const int* pt_row = page_table + (size_t)blockIdx.z * max_pages;
  if constexpr (SLAB)
    page_walk_block_mma_slab<T, C, kMmaWarps>(
        q, out, tile.rows, head.k, head.v, head.ks, head.vs, pt_row,
        max_pages, page_size, tile.mask.kv_len, tile.mask, tile.live, hd,
        slabs, slab);
  else
    page_walk_block_mma<T, C, D, kMmaWarps>(
        q, out, tile.rows, head.k, head.v, head.ks, head.vs, pt_row,
        max_pages, page_size, tile.mask.kv_len, tile.mask, tile.live, hd);
}

// 16-bit queries at head dims 129 to 256: the wgmma walk
// (paged_walk_wgmma.cuh) at the tile 256 with the ragged tiles, one
// persistent block an SM of consumer warpgroups and a producer
// warpgroup, taking tiles from the walk's scheduler.
template <typename T, typename C, int D>
__global__ void __launch_bounds__(kWgBlockThreads, 1)
paged_ragged_wgmma_kernel(const __grid_constant__ WgArgs<T, C> a) {
  page_walk_block_wgmma<T, C, D, WgRaggedTiles>(a);
}

// 16-bit queries at head dims 257 to 512: the wgmma walk's wide form at
// the width W (wg_wide_width), two consumer warpgroups over each 64-row
// tile, each owning half of the output's head dims.
template <typename T, typename C, int W>
__global__ void __launch_bounds__(kWgBlockThreads, 1)
paged_ragged_wgmma_wide_kernel(const __grid_constant__ WgArgs<T, C> a) {
  page_walk_block_wgmma<T, C, W, WgRaggedTiles>(a);
}

// The wgmma walk's kernel at D: the wide form's above kMaxHeadDim.
template <typename T, typename C, int D>
constexpr auto ragged_wgmma_kernel_at() {
  if constexpr (D > kMaxHeadDim)
    return &paged_ragged_wgmma_wide_kernel<T, C, D>;
  else
    return &paged_ragged_wgmma_kernel<T, C, D>;
}

// The launch of the wgmma walk at D (the tile 256, or a width of the
// wide form), as prefill launches it (paged_prefill.cuh): persistent,
// min(tiles, SMs) blocks; an error from the shared-memory attribute or
// the register check is returned, no other walk tried.
template <typename T, typename C, int D>
int launch_wgmma(const RaggedArgs& a) {
  if (kQuantized<C> && (a.ks == nullptr || a.vs == nullptr))
    return cudaErrorInvalidValue;
  constexpr bool WIDE = D > kMaxHeadDim;
  const int group = a.num_q_heads / a.num_kv_heads;
  // Consumer warpgroups: prefill's rule at the tile 256 (wg_consumers:
  // one where a pair's G * W rows fit in 64, a verify block, else two
  // on a 128-row tile; faster than one on 64-row tiles on the unified
  // block, paged_ragged.cu), two over 64-row tiles in the wide form.
  const int consumers =
      WIDE ? kWgMaxConsumers : wg_consumers(group * a.width);
  const int tile_rows = WIDE ? kWgRows : consumers * kWgRows;
  const int tiles = (group * a.width + tile_rows - 1) / tile_rows;
  const long long total = (long long)a.num_kv_heads * a.rows * tiles;
  if (total > INT_MAX) return cudaErrorInvalidValue;
  const WgArgs<T, C> args{static_cast<const T*>(a.q),
                          static_cast<const C*>(a.k),
                          static_cast<const C*>(a.v),
                          static_cast<const float*>(a.ks),
                          static_cast<const float*>(a.vs),
                          static_cast<const int*>(a.pt),
                          nullptr,
                          static_cast<const int*>(a.kv_lens),
                          static_cast<T*>(a.out),
                          a.rows, a.width, a.num_q_heads, a.num_kv_heads,
                          group, a.num_pages, a.page_size, a.max_pages,
                          a.head_dim, a.layer, consumers, tiles, (int)total,
                          static_cast<const int*>(a.last_index)};
  constexpr int smem = WgSmem<C, D>::bytes;
  auto kernel = ragged_wgmma_kernel_at<T, C, D>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  // setmaxnreg moves registers within the block's allocation: the
  // consumers' rise must fit what the producer gives up, or it would
  // wait forever. Refuse a build whose entry count is too small.
  static const int entry_regs = [&] {
    cudaFuncAttributes f{};
    return cudaFuncGetAttributes(&f, kernel) == cudaSuccess ? f.numRegs : 0;
  }();
  if (entry_regs * (consumers + 1) <
      wg_producer_regs(D) + consumers * wg_consumer_regs(D))
    return cudaErrorInvalidConfiguration;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  kernel<<<(int)std::min<long long>(total, std::max(sms, 1)),
           (consumers + 1) * kWgThreads, smem, a.stream>>>(args);
  return counted_ragged_launch(WIDE ? kRaggedWgmmaWide : kRaggedWgmma);
}

template <typename T, typename C, int D, bool SLAB>
int launch(const RaggedArgs& a) {
  if (kQuantized<C> && (a.ks == nullptr || a.vs == nullptr))
    return cudaErrorInvalidValue;
  const int group = a.num_q_heads / a.num_kv_heads;
  const int tiles = (group * a.width + kRaggedTile - 1) / kRaggedTile;
  const int slabs = head_dim_slabs(a.head_dim);
  const dim3 grid(tiles, a.num_kv_heads * slabs, a.rows);
  if constexpr (!std::is_same<T, float>::value) {
    constexpr size_t smem =
        SLAB ? MmaSlabSmem<C>::bytes : MmaSmem<C, D>::bytes;
    auto kernel = paged_ragged_mma_kernel<T, C, D, SLAB>;
    static const cudaError_t attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (attr != cudaSuccess) return attr;
    kernel<<<grid, kMmaThreads, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const C*>(a.k),
        static_cast<const C*>(a.v), static_cast<const float*>(a.ks),
        static_cast<const float*>(a.vs), static_cast<const int*>(a.pt),
        static_cast<const int*>(a.kv_lens),
        static_cast<const int*>(a.last_index), static_cast<T*>(a.out),
        a.width, a.num_q_heads, group, a.num_pages, a.page_size,
        a.max_pages, a.layer, a.head_dim, slabs);
    return counted_ragged_launch(SLAB ? kRaggedMmaSlab : kRaggedMma);
  } else {
    // The widest row block's layout; the narrower ones use a prefix of
    // it, and place their scales by their own layout, inside it.
    constexpr size_t smem = SmemLayout<D, kRaggedTile, kQuantized<C>>::bytes;
    auto kernel = paged_ragged_kernel<T, C, D, SLAB>;
    static const cudaError_t attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (attr != cudaSuccess) return attr;
    kernel<<<grid, kRaggedThreads, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const C*>(a.k),
        static_cast<const C*>(a.v), static_cast<const float*>(a.ks),
        static_cast<const float*>(a.vs), static_cast<const int*>(a.pt),
        static_cast<const int*>(a.kv_lens),
        static_cast<const int*>(a.last_index), static_cast<T*>(a.out),
        a.width, a.num_q_heads, group, a.num_pages, a.page_size,
        a.max_pages, a.layer, a.head_dim, slabs);
    return counted_ragged_launch(kRaggedF32);
  }
}

}  // namespace

// The launch of one query type (the dtype code's T) at any cache type
// and head dim of PSTT_FOR_EACH_GEOMETRY: paged_ragged_{bf16,f16,f32}.cu
// instantiate the kernels a query type each. cudaErrorInvalidValue for a
// cache dtype or head dim the list lacks.
int ragged_launch_bf16(const RaggedArgs& args, int cache_dtype);
int ragged_launch_f16(const RaggedArgs& args, int cache_dtype);
int ragged_launch_f32(const RaggedArgs& args, int cache_dtype);
// The 16-bit forms on the wgmma walk (ragged_wgmma_head_dim):
// paged_ragged_wgmma_{bf16,f16}.cu, each with its own tile scheduler.
int ragged_wgmma_launch_bf16(const RaggedArgs& args, int cache_dtype);
int ragged_wgmma_launch_f16(const RaggedArgs& args, int cache_dtype);

}  // namespace pstt

// The body of a ragged_launch_<type>: one case a line of the type's
// list, at the head dim's tile, the slab walk above kMaxHeadDim (the
// 16-bit sources first hand ragged_wgmma_head_dim's to the wgmma walk).
#define PSTT_RAGGED_CASE(code, T, ccode, C, D, SLABS)                    \
  if (cache_dtype == ccode && pstt::head_dim_tile(args.head_dim) == D &&  \
      (pstt::head_dim_slabs(args.head_dim) > 1) == SLABS)                 \
    return pstt::launch<T, C, D, SLABS>(args);
// The 16-bit forms on the mma.sync walks: the tiles up to 128 and the
// slabs above 512 (the wgmma walk serves 129 to 512).
#define PSTT_FOR_EACH_RAGGED_MMA_HEAD_DIM(X, code, T, ccode, C) \
  X(code, T, ccode, C, 32, false)                             \
  X(code, T, ccode, C, 64, false)                             \
  X(code, T, ccode, C, 80, false)                             \
  X(code, T, ccode, C, 128, false)                            \
  X(code, T, ccode, C, 128, true)
#define PSTT_FOR_EACH_BF16_RAGGED_MMA(X)                                  \
  PSTT_FOR_EACH_RAGGED_MMA_HEAD_DIM(X, 0, __nv_bfloat16, 0, __nv_bfloat16) \
  PSTT_FOR_EACH_RAGGED_MMA_HEAD_DIM(X, 0, __nv_bfloat16, 2, int8_t)
#define PSTT_FOR_EACH_F16_RAGGED_MMA(X)                     \
  PSTT_FOR_EACH_RAGGED_MMA_HEAD_DIM(X, 3, __half, 3, __half) \
  PSTT_FOR_EACH_RAGGED_MMA_HEAD_DIM(X, 3, __half, 2, int8_t)
// The body of a ragged_wgmma_launch_<type>: the wide form's widths,
// then the tile 256.
#define PSTT_RAGGED_WG_CASE(code, T, ccode, C, D)                         \
  if (cache_dtype == ccode &&                                            \
      (D > pstt::kMaxHeadDim                                             \
           ? pstt::wg_wide_width(args.head_dim) == D                     \
           : pstt::head_dim_slabs(args.head_dim) == 1 &&                 \
                 pstt::head_dim_tile(args.head_dim) == D))               \
    return pstt::launch_wgmma<T, C, D>(args);
#define PSTT_FOR_EACH_RAGGED_WG(X, code, T, ccode, C) \
  PSTT_FOR_EACH_WG_WIDTH(X, code, T, ccode, C)        \
  X(code, T, ccode, C, 256)
#define PSTT_FOR_EACH_BF16_RAGGED_WG(X)                             \
  PSTT_FOR_EACH_RAGGED_WG(X, 0, __nv_bfloat16, 0, __nv_bfloat16)    \
  PSTT_FOR_EACH_RAGGED_WG(X, 0, __nv_bfloat16, 2, int8_t)
#define PSTT_FOR_EACH_F16_RAGGED_WG(X)              \
  PSTT_FOR_EACH_RAGGED_WG(X, 3, __half, 3, __half) \
  PSTT_FOR_EACH_RAGGED_WG(X, 3, __half, 2, int8_t)
