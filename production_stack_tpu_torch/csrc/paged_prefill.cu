// Paged chunked-prefill attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel paged_prefill_attention
// (production_stack_tpu/ops/prefill_attention_pallas.py:149). Grid
// (query tile, kv_head, batch); the G * T query rows of a (row, kv
// head) pair are flattened g-major and cut into tiles of 64 rows.
// Query t of a row sits at q_positions[b, 0] + t; a tile stops at the
// last chunk its highest query position can see, which skips only
// fully masked work. A row with kv_len 0 writes 0.
//
// What bounds it: operations. A 512-token chunk does 4 * heads *
// head_dim operations per visible (query, token) pair over K/V that
// the G * T rows of a kv head share, far above the card's ridge of
// about 295 bf16 operations per byte; so the products have to run on
// the tensor cores. The bf16 geometries (bf16 or int8 cache) take the
// tensor-core walk of paged_walk_mma.cuh: one block of 4 warps, each
// warp 16 rows with q in registers, bf16 mma.sync for q.k^T and p.v,
// scores and probabilities in registers, K/V staged in 16 bits through
// two cp.async stages (68 KB a block, three blocks an SM). The f32
// geometries (tiny-llama, held to 1e-4) keep page_walk_block
// (paged_kv_common.cuh): f32 FMA over f32 tiles, one block of 256
// threads a tile. The choice is by type, at compile time.
//
// C interface (loaded with ctypes by ops/paged_kv_common.py):
//   q/out [B, T, num_q_heads, D]; k/v cache [kv_heads, num_pages, D,
//   page_size], or the stacked [L, kv_heads, ...] cache read at
//   `layer`; k/v scale [(L,) kv_heads, num_pages, page_size] f32 for an
//   int8 cache, else null; page_table [B, max_pages], q_positions
//   [B, T] (row starts read only), kv_lens [B], all int32; dtype (q,
//   out) 0 = bf16, 1 = f32; cache_dtype 0 = bf16, 1 = f32, 2 = int8;
//   layer_stride / scale_layer_stride as in paged_decode.cu.
// Launches on `stream`, allocates nothing, does not synchronise, and
// returns cudaGetLastError() after the launch.

#include "paged_kv_common.cuh"
#include "paged_walk_mma.cuh"

namespace pstt {
namespace {

constexpr int kTileRows = 64;
// The f32 walk: 16 x 16 threads, 4 rows x 8 tokens each.
constexpr int kPrefillThreads = 256;
constexpr int kTileTY = 16;

template <typename T, typename C, int D>
__global__ void __launch_bounds__(kPrefillThreads)
paged_prefill_kernel(const T* __restrict__ q, const C* __restrict__ k_cache,
                     const C* __restrict__ v_cache,
                     const float* __restrict__ k_scale,
                     const float* __restrict__ v_scale,
                     const int* __restrict__ page_table,
                     const int* __restrict__ q_positions,
                     const int* __restrict__ kv_lens, T* __restrict__ out,
                     int tokens, int num_q_heads, int group, int num_pages,
                     int page_size, int max_pages, LayerOffsets layer) {
  const int tile = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int row0 = tile * kTileRows;
  const int nrows = min(kTileRows, group * tokens - row0);
  const int kv_len = kv_lens[b];
  const int q_start = q_positions[(size_t)b * tokens];
  const size_t head_elems = (size_t)num_pages * D * page_size;
  const size_t head_slots = (size_t)num_pages * page_size;
  RowMap rows{((size_t)b * tokens * num_q_heads + (size_t)h * group) * D,
              tokens, num_q_heads, D, row0};
  page_walk_block<T, C, D, kTileRows, kTileTY, kPrefillThreads>(
      q, out, rows, k_cache + layer.data() + h * head_elems,
      v_cache + layer.data() + h * head_elems,
      kQuantized<C> ? k_scale + layer.scale() + h * head_slots : nullptr,
      kQuantized<C> ? v_scale + layer.scale() + h * head_slots : nullptr,
      page_table + (size_t)b * max_pages, max_pages, page_size, kv_len,
      CausalMask{kv_len, q_start, tokens, row0}, nrows);
}

constexpr int kMmaWarps = kTileRows / 16;  // a warp owns 16 rows
constexpr int kMmaThreads = kMmaWarps * 32;

// The bf16 geometries: the same tile and grid on the tensor-core walk.
template <typename C, int D>
__global__ void __launch_bounds__(kMmaThreads, 3)
paged_prefill_mma_kernel(const __nv_bfloat16* __restrict__ q,
                         const C* __restrict__ k_cache,
                         const C* __restrict__ v_cache,
                         const float* __restrict__ k_scale,
                         const float* __restrict__ v_scale,
                         const int* __restrict__ page_table,
                         const int* __restrict__ q_positions,
                         const int* __restrict__ kv_lens,
                         __nv_bfloat16* __restrict__ out, int tokens,
                         int num_q_heads, int group, int num_pages,
                         int page_size, int max_pages, LayerOffsets layer) {
  const int tile = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int row0 = tile * kTileRows;
  const int nrows = min(kTileRows, group * tokens - row0);
  const int kv_len = kv_lens[b];
  const int q_start = q_positions[(size_t)b * tokens];
  const size_t head_elems = (size_t)num_pages * D * page_size;
  const size_t head_slots = (size_t)num_pages * page_size;
  RowMap rows{((size_t)b * tokens * num_q_heads + (size_t)h * group) * D,
              tokens, num_q_heads, D, row0};
  page_walk_block_mma<C, D, kMmaWarps>(
      q, out, rows, k_cache + layer.data() + h * head_elems,
      v_cache + layer.data() + h * head_elems,
      kQuantized<C> ? k_scale + layer.scale() + h * head_slots : nullptr,
      kQuantized<C> ? v_scale + layer.scale() + h * head_slots : nullptr,
      page_table + (size_t)b * max_pages, max_pages, page_size, kv_len,
      CausalMask{kv_len, q_start, tokens, row0}, nrows);
}

template <typename T, typename C, int D>
int launch(const void* q, const void* k, const void* v, const void* ks,
           const void* vs, const void* pt, const void* q_positions,
           const void* kv_lens, void* out, int batch, int tokens,
           int num_q_heads, int num_kv_heads, int num_pages, int page_size,
           int max_pages, LayerOffsets layer, cudaStream_t stream) {
  if (kQuantized<C> && (ks == nullptr || vs == nullptr))
    return cudaErrorInvalidValue;
  const int group = num_q_heads / num_kv_heads;
  const int tiles = (group * tokens + kTileRows - 1) / kTileRows;
  const dim3 grid(tiles, num_kv_heads, batch);
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    constexpr size_t smem = MmaSmem<C, D>::bytes;
    auto kernel = paged_prefill_mma_kernel<C, D>;
    static const cudaError_t attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (attr != cudaSuccess) return attr;
    kernel<<<grid, kMmaThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const C*>(k),
        static_cast<const C*>(v), static_cast<const float*>(ks),
        static_cast<const float*>(vs), static_cast<const int*>(pt),
        static_cast<const int*>(q_positions),
        static_cast<const int*>(kv_lens), static_cast<T*>(out), tokens,
        num_q_heads, group, num_pages, page_size, max_pages, layer);
  } else {
    constexpr size_t smem = SmemLayout<D, kTileRows, kQuantized<C>>::bytes;
    auto kernel = paged_prefill_kernel<T, C, D>;
    static const cudaError_t attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (attr != cudaSuccess) return attr;
    kernel<<<grid, kPrefillThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const C*>(k),
        static_cast<const C*>(v), static_cast<const float*>(ks),
        static_cast<const float*>(vs), static_cast<const int*>(pt),
        static_cast<const int*>(q_positions),
        static_cast<const int*>(kv_lens), static_cast<T*>(out), tokens,
        num_q_heads, group, num_pages, page_size, max_pages, layer);
  }
  return cudaGetLastError();
}

}  // namespace
}  // namespace pstt

extern "C" int pstt_paged_prefill(int dtype, int cache_dtype,
                                  const void* q, const void* k,
                                  const void* v, const void* k_scale,
                                  const void* v_scale,
                                  const void* page_table,
                                  const void* q_positions,
                                  const void* kv_lens, void* out, int batch,
                                  int tokens, int num_q_heads,
                                  int num_kv_heads, int head_dim,
                                  int num_pages, int page_size,
                                  int max_pages, int layer,
                                  long long layer_stride,
                                  long long scale_layer_stride,
                                  void* stream) {
  if (num_kv_heads <= 0 || num_q_heads % num_kv_heads ||
      page_size <= 0 || pstt::kChunk % page_size || layer < 0 ||
      layer_stride < 0 || scale_layer_stride < 0)
    return cudaErrorInvalidValue;
  const pstt::LayerOffsets offsets{layer, layer_stride, scale_layer_stride};
  if (batch == 0 || tokens == 0) return cudaSuccess;
  const int group = num_q_heads / num_kv_heads;
  auto s = static_cast<cudaStream_t>(stream);
#define PSTT_PREFILL_CASE(code, T, ccode, C, G, D)                         \
  if (dtype == code && cache_dtype == ccode && group == G &&               \
      head_dim == D)                                                       \
    return pstt::launch<T, C, D>(q, k, v, k_scale, v_scale, page_table,    \
                                 q_positions, kv_lens, out, batch, tokens, \
                                 num_q_heads, num_kv_heads, num_pages,     \
                                 page_size, max_pages, offsets, s);
  PSTT_FOR_EACH_GEOMETRY(PSTT_PREFILL_CASE)
#undef PSTT_PREFILL_CASE
  return cudaErrorInvalidValue;
}
