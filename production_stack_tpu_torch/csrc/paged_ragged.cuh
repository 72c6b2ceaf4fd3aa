// The ragged kernels' templates and their launch (paged_ragged.cu
// describes the design and holds the C interface). paged_ragged_bf16.cu,
// paged_ragged_f16.cu and paged_ragged_f32.cu instantiate them a query
// type each, so the three compile in parallel.

#pragma once

#include "paged_kv_common.cuh"
#include "paged_walk_mma.cuh"

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

namespace {

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
  }
  return cudaGetLastError();
}

}  // namespace

// The launch of one query type (the dtype code's T) at any cache type
// and head dim of PSTT_FOR_EACH_GEOMETRY: paged_ragged_{bf16,f16,f32}.cu
// instantiate the kernels a query type each. cudaErrorInvalidValue for a
// cache dtype or head dim the list lacks.
int ragged_launch_bf16(const RaggedArgs& args, int cache_dtype);
int ragged_launch_f16(const RaggedArgs& args, int cache_dtype);
int ragged_launch_f32(const RaggedArgs& args, int cache_dtype);

}  // namespace pstt

// The body of a ragged_launch_<type>: one case a line of the type's
// list, at the head dim's tile, the slab walk above kMaxHeadDim.
#define PSTT_RAGGED_CASE(code, T, ccode, C, D, SLABS)                    \
  if (cache_dtype == ccode && pstt::head_dim_tile(args.head_dim) == D &&  \
      (pstt::head_dim_slabs(args.head_dim) > 1) == SLABS)                 \
    return pstt::launch<T, C, D, SLABS>(args);
