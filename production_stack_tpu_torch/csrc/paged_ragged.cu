// Paged ragged attention for Hopper (sm_90a): the unified [R, W] step.
//
// Replaces the Pallas TPU kernel paged_ragged_attention
// (production_stack_tpu/ops/ragged_attention_pallas.py:174, body
// _ragged_kernel at :93). Each row of the block carries the descriptor
// (kv_len, last_index, draft_len): slot t is live when t <= last_index
// and sits at q_start + t, q_start = kv_len - 1 - last_index; it
// attends pos <= q_start + t and pos < kv_len (RaggedMask). draft_len
// is taken and not read: a verify row's draft span masks itself
// causally. Dead slots and pad rows (kv_len 0) write exact 0.
//
// Grid (query tile, kv_head, row). The G * W query rows of a (row, kv
// head) pair are flattened slot-major, (t, g), and cut into tiles of
// 64, so a row's live queries are one prefix of its rows: a decode
// row's G queries sit in its first tile, a verify row's (K + 1) * G in
// its first one or two. A tile with no live row writes its zeros
// (16-byte stores) and returns without staging K/V. A tile with live
// rows walks the row's pages once for all of them and stops at the
// last chunk its highest live slot can see.
//
// What bounds it: at the widest mixed step, the chunk rows' arithmetic
// (the work of a first and a second prefill chunk) and the bytes of
// the decode rows' K/V and of the block's output (every slot, dead
// ones included, is written). So bf16 and f16 queries (over a cache
// of their type or int8) take the tensor-core walk of
// paged_walk_mma.cuh, as prefill does: one block of 4 warps, each warp
// 16 rows with q in registers, mma.sync in the query's type for q.k^T
// and p.v (the probabilities enter p.v in that type), K/V staged in
// 16 bits through two cp.async stages, 68 KB a
// block and three blocks an SM at head_dim 64 (at 128 one stage of 68
// KB, two blocks an SM). One row block serves every tile: a warp
// none of whose 16 rows is live skips every product, so a decode row's
// tile (G = 4 live rows) multiplies on one warp and a verify row's
// ((K + 1) * G = 20) on two, while all four share the copies. f32
// queries (held to 1e-4) keep page_walk_block (paged_kv_common.cuh,
// f32 FMA) with the narrowest of three row blocks (8, 32 or 64 rows)
// that holds the tile's live rows. The choice is by type, at compile
// time; the query group is a run-time value (any group: G * W slot-
// major rows cut into tiles). An int8 cache stages as int8 pages and
// their scales, folded in the Pallas order.
//
// C interface (loaded with ctypes by ops/paged_kv_common.py):
//   q/out [R, W, num_q_heads, D]; k/v cache [kv_heads, num_pages, D,
//   page_size], or the stacked [L, kv_heads, ...] cache read at
//   `layer`; k/v scale [(L,) kv_heads, num_pages, page_size] f32 for an
//   int8 cache, else null; page_table [R, max_pages], kv_lens [R],
//   last_index [R], draft_lens [R] or null, all int32; dtype (q, out)
//   0 = bf16, 1 = f32, 3 = f16; cache_dtype the same code, or 2 =
//   int8;
//   layer_stride / scale_layer_stride as in paged_decode.cu.
// Launches on `stream`, allocates nothing, does not synchronise, and
// returns cudaGetLastError() after the launch.

#include "paged_kv_common.cuh"
#include "paged_walk_mma.cuh"

namespace pstt {
namespace {

constexpr int kRaggedTile = 64;
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

template <int D>
__device__ __forceinline__ RaggedTile ragged_tile(
    const int* __restrict__ kv_lens, const int* __restrict__ last_index,
    int width, int num_q_heads, int group) {
  const int row0 = blockIdx.x * kRaggedTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tile_rows = min(kRaggedTile, group * width - row0);
  const int kv_len = kv_lens[b];
  const int last = kv_len > 0 ? last_index[b] : -1;
  const int live =
      max(0, min((min(last, width - 1) + 1) * group - row0, tile_rows));
  return {SlotMajorRows{((size_t)b * width * num_q_heads +
                         (size_t)h * group) * D,
                        group, num_q_heads, D, row0},
          RaggedMask{kv_len, last, group, row0}, tile_rows, live};
}

// Rows [tile.live, tile.tile_rows) of the tile: exact 0, one 16-byte
// store a thread at a time (a row is D * sizeof(T) bytes, a multiple
// of 16 at every head dim and type built).
template <typename T, int D, int NT>
__device__ __forceinline__ void zero_dead_rows(T* __restrict__ out,
                                               const RaggedTile& tile) {
  constexpr int kVecs = D * (int)sizeof(T) / 16;
  static_assert(D * sizeof(T) % 16 == 0, "a row must be whole 16 bytes");
  for (int i = tile.live * kVecs + threadIdx.x; i < tile.tile_rows * kVecs;
       i += NT) {
    const int r = i / kVecs;
    reinterpret_cast<uint4*>(out + tile.rows.offset(r))[i - r * kVecs] =
        make_uint4(0, 0, 0, 0);
  }
}

// This kv head's pages and (int8 cache) scales, at the launch's layer.
template <typename C, int D>
struct RaggedHead {
  const C* k;
  const C* v;
  const float* ks;
  const float* vs;

  __device__ __forceinline__ RaggedHead(const C* k_cache, const C* v_cache,
                                        const float* k_scale,
                                        const float* v_scale,
                                        int num_pages, int page_size,
                                        LayerOffsets layer) {
    const size_t head_elems = (size_t)num_pages * D * page_size;
    const size_t head_slots = (size_t)num_pages * page_size;
    const int h = blockIdx.y;
    k = k_cache + layer.data() + h * head_elems;
    v = v_cache + layer.data() + h * head_elems;
    ks = kQuantized<C> ? k_scale + layer.scale() + h * head_slots : nullptr;
    vs = kQuantized<C> ? v_scale + layer.scale() + h * head_slots : nullptr;
  }
};

// f32 queries: f32 FMA over f32 tiles, with the narrowest row block
// that holds the tile's live rows.
template <typename T, typename C, int D>
__global__ void __launch_bounds__(kRaggedThreads)
paged_ragged_kernel(const T* __restrict__ q, const C* __restrict__ k_cache,
                    const C* __restrict__ v_cache,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int* __restrict__ page_table,
                    const int* __restrict__ kv_lens,
                    const int* __restrict__ last_index, T* __restrict__ out,
                    int width, int num_q_heads, int group, int num_pages,
                    int page_size, int max_pages, LayerOffsets layer) {
  const RaggedTile tile =
      ragged_tile<D>(kv_lens, last_index, width, num_q_heads, group);
  zero_dead_rows<T, D, kRaggedThreads>(out, tile);
  if (tile.live == 0) return;
  const RaggedHead<C, D> head(k_cache, v_cache, k_scale, v_scale, num_pages,
                              page_size, layer);
  const int* pt_row = page_table + (size_t)blockIdx.z * max_pages;
  const int kv_len = tile.mask.kv_len;
  if (tile.live <= 8) {
    page_walk_block<T, C, D, 8, 8, kRaggedThreads>(
        q, out, tile.rows, head.k, head.v, head.ks, head.vs, pt_row,
        max_pages, page_size, kv_len, tile.mask, tile.live);
  } else if (tile.live <= 32) {
    page_walk_block<T, C, D, 32, 8, kRaggedThreads>(
        q, out, tile.rows, head.k, head.v, head.ks, head.vs, pt_row,
        max_pages, page_size, kv_len, tile.mask, tile.live);
  } else {
    page_walk_block<T, C, D, kRaggedTile, 16, kRaggedThreads>(
        q, out, tile.rows, head.k, head.v, head.ks, head.vs, pt_row,
        max_pages, page_size, kv_len, tile.mask, tile.live);
  }
}

// 16-bit queries (T bf16 or f16): the same tile and grid on the
// tensor-core walk, one row block for every tile (warps with no live
// row skip their products).
template <typename T, typename C, int D>
__global__ void __launch_bounds__(kMmaThreads, mma_blocks_per_sm<C, D>())
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
                        int page_size, int max_pages, LayerOffsets layer) {
  const RaggedTile tile =
      ragged_tile<D>(kv_lens, last_index, width, num_q_heads, group);
  zero_dead_rows<T, D, kMmaThreads>(out, tile);
  if (tile.live == 0) return;
  const RaggedHead<C, D> head(k_cache, v_cache, k_scale, v_scale, num_pages,
                              page_size, layer);
  page_walk_block_mma<T, C, D, kMmaWarps>(
      q, out, tile.rows, head.k, head.v, head.ks, head.vs,
      page_table + (size_t)blockIdx.z * max_pages, max_pages, page_size,
      tile.mask.kv_len, tile.mask, tile.live);
}

template <typename T, typename C, int D>
int launch(const void* q, const void* k, const void* v, const void* ks,
           const void* vs, const void* pt, const void* kv_lens,
           const void* last_index, void* out, int rows, int width,
           int num_q_heads, int num_kv_heads, int num_pages, int page_size,
           int max_pages, LayerOffsets layer, cudaStream_t stream) {
  if (kQuantized<C> && (ks == nullptr || vs == nullptr))
    return cudaErrorInvalidValue;
  const int group = num_q_heads / num_kv_heads;
  const int tiles = (group * width + kRaggedTile - 1) / kRaggedTile;
  const dim3 grid(tiles, num_kv_heads, rows);
  if constexpr (!std::is_same<T, float>::value) {
    constexpr size_t smem = MmaSmem<C, D>::bytes;
    auto kernel = paged_ragged_mma_kernel<T, C, D>;
    static const cudaError_t attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (attr != cudaSuccess) return attr;
    kernel<<<grid, kMmaThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const C*>(k),
        static_cast<const C*>(v), static_cast<const float*>(ks),
        static_cast<const float*>(vs), static_cast<const int*>(pt),
        static_cast<const int*>(kv_lens),
        static_cast<const int*>(last_index), static_cast<T*>(out), width,
        num_q_heads, group, num_pages, page_size, max_pages, layer);
  } else {
    // The widest row block's layout; the narrower ones use a prefix of
    // it, and place their scales by their own layout, inside it.
    constexpr size_t smem = SmemLayout<D, kRaggedTile, kQuantized<C>>::bytes;
    auto kernel = paged_ragged_kernel<T, C, D>;
    static const cudaError_t attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (attr != cudaSuccess) return attr;
    kernel<<<grid, kRaggedThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const C*>(k),
        static_cast<const C*>(v), static_cast<const float*>(ks),
        static_cast<const float*>(vs), static_cast<const int*>(pt),
        static_cast<const int*>(kv_lens),
        static_cast<const int*>(last_index), static_cast<T*>(out), width,
        num_q_heads, group, num_pages, page_size, max_pages, layer);
  }
  return cudaGetLastError();
}

}  // namespace
}  // namespace pstt

extern "C" int pstt_paged_ragged(int dtype, int cache_dtype, const void* q,
                                 const void* k, const void* v,
                                 const void* k_scale, const void* v_scale,
                                 const void* page_table,
                                 const void* kv_lens,
                                 const void* last_index,
                                 const void* draft_lens, void* out,
                                 int rows, int width, int num_q_heads,
                                 int num_kv_heads, int head_dim,
                                 int num_pages, int page_size,
                                 int max_pages, int layer,
                                 long long layer_stride,
                                 long long scale_layer_stride,
                                 void* stream) {
  (void)draft_lens;  // the draft span masks itself causally
  if (num_kv_heads <= 0 || num_q_heads % num_kv_heads ||
      !pstt::page_size_ok(page_size) || layer < 0 ||
      layer_stride < 0 || scale_layer_stride < 0)
    return cudaErrorInvalidValue;
  const pstt::LayerOffsets offsets{layer, layer_stride, scale_layer_stride};
  if (rows == 0 || width == 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
#define PSTT_RAGGED_CASE(code, T, ccode, C, D)                             \
  if (dtype == code && cache_dtype == ccode && head_dim == D)              \
    return pstt::launch<T, C, D>(q, k, v, k_scale, v_scale, page_table,    \
                                 kv_lens, last_index, out, rows, width,    \
                                 num_q_heads, num_kv_heads, num_pages,     \
                                 page_size, max_pages, offsets, s);
  PSTT_FOR_EACH_GEOMETRY(PSTT_RAGGED_CASE)
#undef PSTT_RAGGED_CASE
  return cudaErrorInvalidValue;
}
