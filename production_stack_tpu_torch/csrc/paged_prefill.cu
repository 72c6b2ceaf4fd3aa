// Paged chunked-prefill attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel paged_prefill_attention
// (production_stack_tpu/ops/prefill_attention_pallas.py:149). Grid
// (query tile, kv_head, batch); the G * T query rows of a (row, kv
// head) pair are flattened g-major and cut into tiles of 64 rows, and
// one block of 256 threads walks the row's pages for its tile, reusing
// each staged chunk for all 64 rows. Query t of a row sits at
// q_positions[b, 0] + t; a tile stops at the last chunk its highest
// query position can see, which skips only fully masked work. A row
// with kv_len 0 writes 0. An int8 cache stages as int8 pages and their
// scales, folded in (paged_kv_common.cuh).
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

namespace pstt {
namespace {

constexpr int kPrefillThreads = 256;
constexpr int kTileRows = 64;
constexpr int kTileTY = 16;  // 16 x 16 threads: 4 rows x 8 tokens each

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

template <typename T, typename C, int D>
int launch(const void* q, const void* k, const void* v, const void* ks,
           const void* vs, const void* pt, const void* q_positions,
           const void* kv_lens, void* out, int batch, int tokens,
           int num_q_heads, int num_kv_heads, int num_pages, int page_size,
           int max_pages, LayerOffsets layer, cudaStream_t stream) {
  if (kQuantized<C> && (ks == nullptr || vs == nullptr))
    return cudaErrorInvalidValue;
  constexpr size_t smem = SmemLayout<D, kTileRows, kQuantized<C>>::bytes;
  auto kernel = paged_prefill_kernel<T, C, D>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return attr;
  const int group = num_q_heads / num_kv_heads;
  const int tiles = (group * tokens + kTileRows - 1) / kTileRows;
  kernel<<<dim3(tiles, num_kv_heads, batch), kPrefillThreads, smem,
           stream>>>(
      static_cast<const T*>(q), static_cast<const C*>(k),
      static_cast<const C*>(v), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(pt),
      static_cast<const int*>(q_positions),
      static_cast<const int*>(kv_lens), static_cast<T*>(out), tokens,
      num_q_heads, group, num_pages, page_size, max_pages, layer);
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
