// The chunked-prefill kernels' templates and their launch
// (paged_prefill.cu describes the design and holds the C interface).
// paged_prefill_bf16.cu, paged_prefill_f16.cu and paged_prefill_f32.cu
// instantiate them a query type each, so the three compile in parallel.

#pragma once

#include <limits.h>

#include <algorithm>

#include "paged_kv_common.cuh"
#include "paged_walk_mma.cuh"
#include "paged_walk_wgmma.cuh"

namespace pstt {

// One launch's operands and shapes.
struct PrefillArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* ks;
  const void* vs;
  const void* pt;
  const void* q_positions;
  const void* kv_lens;
  void* out;
  int batch, tokens, num_q_heads, num_kv_heads, head_dim, num_pages,
      page_size, max_pages;
  LayerOffsets layer;
  cudaStream_t stream;
};

// The walks a launch can take, in the order of
// pstt_prefill_walk_launches's index (paged_prefill.cu).
enum PrefillWalk { kWalkWgmma, kWalkWgmmaWide, kWalkMmaSlab, kWalkF32,
                   kPrefillWalks };

// Adds one to the walk's count of launches the runtime took
// (paged_prefill.cu).
void count_prefill_walk(PrefillWalk walk);

namespace {

// cudaGetLastError() after a launch of `walk`, counted where it is 0.
inline int counted_launch(PrefillWalk walk) {
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) count_prefill_walk(walk);
  return err;
}

constexpr int kTileRows = kMmaRows;
// The f32 walk: 16 x 16 threads, 4 rows x 8 tokens each (4 at tile 256).
constexpr int kPrefillThreads = 256;
constexpr int kTileTY = 16;

// Where a block's rows and its kv head's pages lie, at the real head
// dim `hd`: kv head h (blockIdx.y, or blockIdx.y / slabs with slabs).
struct PrefillTile {
  RowMap rows;
  CausalMask mask;
  int nrows;
  int kv_len;
  size_t head_elems, head_slots;

  __device__ __forceinline__ PrefillTile(
      const int* __restrict__ q_positions, const int* __restrict__ kv_lens,
      int tokens, int num_q_heads, int group, int num_pages, int page_size,
      int hd, int h) {
    const int row0 = blockIdx.x * kTileRows;
    const int b = blockIdx.z;
    nrows = min(kTileRows, group * tokens - row0);
    kv_len = kv_lens[b];
    const int q_start = q_positions[(size_t)b * tokens];
    head_elems = (size_t)num_pages * hd * page_size;
    head_slots = (size_t)num_pages * page_size;
    rows = RowMap{((size_t)b * tokens * num_q_heads + (size_t)h * group) * hd,
                  tokens, num_q_heads, hd, row0};
    mask = CausalMask{kv_len, q_start, tokens, row0};
  }
};

// SLAB: the slab walk of a head_dim above kMaxHeadDim (D = kSlabDim),
// grid y over kv heads x `slabs` slabs, a block one output slab.
template <typename T, typename C, int D, bool SLAB>
__global__ void __launch_bounds__(kPrefillThreads)
paged_prefill_kernel(const T* __restrict__ q, const C* __restrict__ k_cache,
                     const C* __restrict__ v_cache,
                     const float* __restrict__ k_scale,
                     const float* __restrict__ v_scale,
                     const int* __restrict__ page_table,
                     const int* __restrict__ q_positions,
                     const int* __restrict__ kv_lens, T* __restrict__ out,
                     int tokens, int num_q_heads, int group, int num_pages,
                     int page_size, int max_pages, LayerOffsets layer,
                     int hd, int slabs) {
  const int h = SLAB ? blockIdx.y / slabs : blockIdx.y;
  const PrefillTile t(q_positions, kv_lens, tokens, num_q_heads, group,
                      num_pages, page_size, hd, h);
  page_walk_block<T, C, D, kTileRows, kTileTY, kPrefillThreads, SLAB>(
      q, out, t.rows, k_cache + layer.data() + h * t.head_elems,
      v_cache + layer.data() + h * t.head_elems,
      kQuantized<C> ? k_scale + layer.scale() + h * t.head_slots : nullptr,
      kQuantized<C> ? v_scale + layer.scale() + h * t.head_slots : nullptr,
      page_table + (size_t)blockIdx.z * max_pages, max_pages, page_size,
      t.kv_len, t.mask, t.nrows, hd, slabs, blockIdx.y - h * slabs);
}

constexpr int kMmaWarps = kTileRows / 16;  // a warp owns 16 rows
constexpr int kMmaThreads = kMmaWarps * 32;

// 16-bit queries (T bf16 or f16) above kMaxHeadDim: the slab walk on
// mma.sync, the tile and grid of the f32 walk.
template <typename T, typename C>
__global__ void __launch_bounds__(kMmaThreads, mma_slab_blocks_per_sm<C>())
paged_prefill_mma_slab_kernel(const T* __restrict__ q,
                              const C* __restrict__ k_cache,
                              const C* __restrict__ v_cache,
                              const float* __restrict__ k_scale,
                              const float* __restrict__ v_scale,
                              const int* __restrict__ page_table,
                              const int* __restrict__ q_positions,
                              const int* __restrict__ kv_lens,
                              T* __restrict__ out, int tokens,
                              int num_q_heads, int group, int num_pages,
                              int page_size, int max_pages,
                              LayerOffsets layer, int hd, int slabs) {
  const int h = blockIdx.y / slabs;
  const PrefillTile t(q_positions, kv_lens, tokens, num_q_heads, group,
                      num_pages, page_size, hd, h);
  page_walk_block_mma_slab<T, C, kMmaWarps>(
      q, out, t.rows, k_cache + layer.data() + h * t.head_elems,
      v_cache + layer.data() + h * t.head_elems,
      kQuantized<C> ? k_scale + layer.scale() + h * t.head_slots : nullptr,
      kQuantized<C> ? v_scale + layer.scale() + h * t.head_slots : nullptr,
      page_table + (size_t)blockIdx.z * max_pages, max_pages, page_size,
      t.kv_len, t.mask, t.nrows, hd, slabs, blockIdx.y - h * slabs);
}

// 16-bit queries up to kMaxHeadDim: the wgmma walk (paged_walk_wgmma.cuh),
// one persistent block an SM of consumer warpgroups and a producer
// warpgroup, taking tiles from the walk's scheduler.
template <typename T, typename C, int D>
__global__ void __launch_bounds__(kWgBlockThreads, 1)
paged_prefill_wgmma_kernel(const __grid_constant__ WgArgs<T, C> a) {
  page_walk_block_wgmma<T, C, D>(a);
}

// 16-bit queries at head dims 257 to 512: the wgmma walk's wide form at
// the width W (wg_wide_width), two consumer warpgroups over each 64-row
// tile, each owning half of the output's head dims.
template <typename T, typename C, int W>
__global__ void __launch_bounds__(kWgBlockThreads, 1)
paged_prefill_wgmma_wide_kernel(const __grid_constant__ WgArgs<T, C> a) {
  page_walk_block_wgmma<T, C, W>(a);
}

// The wgmma walk's kernel at D: the wide form's above kMaxHeadDim.
template <typename T, typename C, int D>
constexpr auto wgmma_kernel() {
  if constexpr (D > kMaxHeadDim)
    return &paged_prefill_wgmma_wide_kernel<T, C, D>;
  else
    return &paged_prefill_wgmma_kernel<T, C, D>;
}

template <typename T, typename C, int D, bool SLAB>
int launch(const PrefillArgs& a) {
  if (kQuantized<C> && (a.ks == nullptr || a.vs == nullptr))
    return cudaErrorInvalidValue;
  const int group = a.num_q_heads / a.num_kv_heads;
  const int slabs = head_dim_slabs(a.head_dim);
  const auto q = static_cast<const T*>(a.q);
  const auto k = static_cast<const C*>(a.k);
  const auto v = static_cast<const C*>(a.v);
  const auto ks = static_cast<const float*>(a.ks);
  const auto vs = static_cast<const float*>(a.vs);
  const auto pt = static_cast<const int*>(a.pt);
  const auto qp = static_cast<const int*>(a.q_positions);
  const auto kl = static_cast<const int*>(a.kv_lens);
  const auto out = static_cast<T*>(a.out);
  if constexpr (!std::is_same<T, float>::value && !SLAB) {
    // The wide form: both consumer warpgroups on every 64-row tile.
    constexpr bool WIDE = D > kMaxHeadDim;
    const int consumers =
        WIDE ? kWgMaxConsumers : wg_consumers(group * a.tokens);
    const int tile_rows = WIDE ? kWgRows : consumers * kWgRows;
    const int tiles = (group * a.tokens + tile_rows - 1) / tile_rows;
    const long long total = (long long)a.num_kv_heads * a.batch * tiles;
    if (total > INT_MAX) return cudaErrorInvalidValue;
    const WgArgs<T, C> args{q, k, v, ks, vs, pt, qp, kl, out, a.batch,
                            a.tokens, a.num_q_heads, a.num_kv_heads, group,
                            a.num_pages, a.page_size, a.max_pages,
                            a.head_dim, a.layer, consumers, tiles,
                            (int)total};
    constexpr int smem = WgSmem<C, D>::bytes;
    auto kernel = wgmma_kernel<T, C, D>();
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
    if (entry_regs * (consumers + 1) < wg_producer_regs(D) +
                                          consumers * wg_consumer_regs(D))
      return cudaErrorInvalidConfiguration;
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    kernel<<<(int)std::min<long long>(total, std::max(sms, 1)),
             (consumers + 1) * kWgThreads, smem, a.stream>>>(args);
    return counted_launch(WIDE ? kWalkWgmmaWide : kWalkWgmma);
  }
  const int tiles = (group * a.tokens + kTileRows - 1) / kTileRows;
  const dim3 grid(tiles, a.num_kv_heads * slabs, a.batch);
  if constexpr (!std::is_same<T, float>::value && SLAB) {
    constexpr size_t smem = MmaSlabSmem<C>::bytes;
    auto kernel = paged_prefill_mma_slab_kernel<T, C>;
    static const cudaError_t attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (attr != cudaSuccess) return attr;
    kernel<<<grid, kMmaThreads, smem, a.stream>>>(
        q, k, v, ks, vs, pt, qp, kl, out, a.tokens, a.num_q_heads, group,
        a.num_pages, a.page_size, a.max_pages, a.layer, a.head_dim, slabs);
    return counted_launch(kWalkMmaSlab);
  } else if constexpr (std::is_same<T, float>::value) {
    constexpr size_t smem = SmemLayout<D, kTileRows, kQuantized<C>>::bytes;
    auto kernel = paged_prefill_kernel<T, C, D, SLAB>;
    static const cudaError_t attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (attr != cudaSuccess) return attr;
    kernel<<<grid, kPrefillThreads, smem, a.stream>>>(
        q, k, v, ks, vs, pt, qp, kl, out, a.tokens, a.num_q_heads, group,
        a.num_pages, a.page_size, a.max_pages, a.layer, a.head_dim, slabs);
    return counted_launch(kWalkF32);
  }
  return cudaGetLastError();
}

}  // namespace

// The launch of one query type (the dtype code's T) at any cache type
// and head dim of PSTT_FOR_EACH_GEOMETRY: paged_prefill_{bf16,f16,f32}.cu
// instantiate the kernels a query type each. cudaErrorInvalidValue for a
// cache dtype or head dim the list lacks.
int prefill_launch_bf16(const PrefillArgs& args, int cache_dtype);
int prefill_launch_f16(const PrefillArgs& args, int cache_dtype);
int prefill_launch_f32(const PrefillArgs& args, int cache_dtype);

}  // namespace pstt

// The body of a prefill_launch_<type>: one case a line of the type's
// list, at the head dim's tile, the slab walk above kMaxHeadDim; before
// them (bf16 and f16), the wgmma walk's wide form at its widths, which
// takes the head dims up to the widest from the slab walk.
#define PSTT_PREFILL_CASE(code, T, ccode, C, D, SLABS)                   \
  if (cache_dtype == ccode && pstt::head_dim_tile(args.head_dim) == D &&  \
      (pstt::head_dim_slabs(args.head_dim) > 1) == SLABS)                 \
    return pstt::launch<T, C, D, SLABS>(args);
#define PSTT_PREFILL_WIDE_CASE(code, T, ccode, C, W)                \
  if (cache_dtype == ccode && pstt::wg_wide_width(args.head_dim) == W) \
    return pstt::launch<T, C, W, false>(args);
#define PSTT_FOR_EACH_BF16_WIDE(X)                                     \
  PSTT_FOR_EACH_WG_WIDTH(X, 0, __nv_bfloat16, 0, __nv_bfloat16)        \
  PSTT_FOR_EACH_WG_WIDTH(X, 0, __nv_bfloat16, 2, int8_t)
#define PSTT_FOR_EACH_F16_WIDE(X)              \
  PSTT_FOR_EACH_WG_WIDTH(X, 3, __half, 3, __half) \
  PSTT_FOR_EACH_WG_WIDTH(X, 3, __half, 2, int8_t)
