// Paged decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel paged_decode_attention
// (production_stack_tpu/ops/paged_attention_pallas.py:147). Grid
// (batch, kv_head); one block of 128 threads walks its row's pages
// once for all G query heads of its kv head, so each KV byte is read
// from device memory once per step (decode is bound by those bytes).
// A row with kv_len 0 (a pad row) walks nothing and writes 0. An int8
// cache halves the bytes of the walk: its pages stage with the same
// 16-byte loads, and their scales fold in (paged_kv_common.cuh). A
// stacked [L, ...] cache is read in place at its layer (LayerOffsets),
// as Pallas reads it at its prefetched layer index: the same bytes and
// blocks as the per-layer form, one more multiply-add of an address.
//
// C interface (loaded with ctypes by ops/paged_kv_common.py):
//   q [B, num_q_heads, D]; k/v cache [kv_heads, num_pages, D, page_size],
//   or the stacked [L, kv_heads, num_pages, D, page_size] cache read at
//   `layer`; k/v scale [(L,) kv_heads, num_pages, page_size] f32 for an
//   int8 cache, else null; page_table [B, max_pages] int32; kv_lens [B]
//   int32; out [B, num_q_heads, D]; dtype (q, out) 0 = bf16, 1 = f32;
//   cache_dtype 0 = bf16, 1 = f32, 2 = int8; layer_stride /
//   scale_layer_stride: elements between two layers of the data / the
//   scales (the per-layer form is layer 0 with strides 0).
// Launches on `stream`, allocates nothing, does not synchronise, and
// returns cudaGetLastError() after the launch. Geometries outside
// PSTT_FOR_EACH_GEOMETRY return cudaErrorInvalidValue;
// pstt_kernel_supports(dtype, cache_dtype, group, head_dim) tells the
// host first.

#include "paged_kv_common.cuh"

namespace pstt {
namespace {

constexpr int kDecodeThreads = 128;

template <int G, int D>
struct DecodeRows {
  // Enough rows that the 128 threads tile the head dim (TX = 128 /
  // rows must divide D); rows past G compute and are never written.
  static constexpr int kMin = kDecodeThreads / D < 2 ? 2 : kDecodeThreads / D;
  static constexpr int kRows = G < kMin ? kMin : G;
};

template <typename T, typename C, int D, int G>
__global__ void __launch_bounds__(kDecodeThreads)
paged_decode_kernel(const T* __restrict__ q, const C* __restrict__ k_cache,
                    const C* __restrict__ v_cache,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int* __restrict__ page_table,
                    const int* __restrict__ kv_lens, T* __restrict__ out,
                    int num_q_heads, int num_pages, int page_size,
                    int max_pages, LayerOffsets layer) {
  constexpr int ROWS = DecodeRows<G, D>::kRows;
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int kv_len = kv_lens[b];
  const size_t head_elems = (size_t)num_pages * D * page_size;
  const size_t head_slots = (size_t)num_pages * page_size;
  RowMap rows{((size_t)b * num_q_heads + (size_t)h * G) * D, 1,
              num_q_heads, D, 0};
  page_walk_block<T, C, D, ROWS, ROWS, kDecodeThreads>(
      q, out, rows, k_cache + layer.data() + h * head_elems,
      v_cache + layer.data() + h * head_elems,
      kQuantized<C> ? k_scale + layer.scale() + h * head_slots : nullptr,
      kQuantized<C> ? v_scale + layer.scale() + h * head_slots : nullptr,
      page_table + (size_t)b * max_pages, max_pages, page_size, kv_len,
      DecodeMask{kv_len}, G);
}

template <typename T, typename C, int D, int G>
int launch(const void* q, const void* k, const void* v, const void* ks,
           const void* vs, const void* pt, const void* kv_lens, void* out,
           int batch, int num_q_heads, int num_kv_heads, int num_pages,
           int page_size, int max_pages, LayerOffsets layer,
           cudaStream_t stream) {
  if (kQuantized<C> && (ks == nullptr || vs == nullptr))
    return cudaErrorInvalidValue;
  constexpr size_t smem =
      SmemLayout<D, DecodeRows<G, D>::kRows, kQuantized<C>>::bytes;
  auto kernel = paged_decode_kernel<T, C, D, G>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return attr;
  kernel<<<dim3(batch, num_kv_heads), kDecodeThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const C*>(k),
      static_cast<const C*>(v), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(pt),
      static_cast<const int*>(kv_lens), static_cast<T*>(out), num_q_heads,
      num_pages, page_size, max_pages, layer);
  return cudaGetLastError();
}

}  // namespace
}  // namespace pstt

extern "C" int pstt_paged_decode(int dtype, int cache_dtype, const void* q,
                                 const void* k, const void* v,
                                 const void* k_scale, const void* v_scale,
                                 const void* page_table,
                                 const void* kv_lens, void* out, int batch,
                                 int num_q_heads, int num_kv_heads,
                                 int head_dim, int num_pages, int page_size,
                                 int max_pages, int layer,
                                 long long layer_stride,
                                 long long scale_layer_stride,
                                 void* stream) {
  if (num_kv_heads <= 0 || num_q_heads % num_kv_heads ||
      page_size <= 0 || pstt::kChunk % page_size || layer < 0 ||
      layer_stride < 0 || scale_layer_stride < 0)
    return cudaErrorInvalidValue;
  const pstt::LayerOffsets offsets{layer, layer_stride, scale_layer_stride};
  if (batch == 0) return cudaSuccess;
  const int group = num_q_heads / num_kv_heads;
  auto s = static_cast<cudaStream_t>(stream);
#define PSTT_DECODE_CASE(code, T, ccode, C, G, D)                          \
  if (dtype == code && cache_dtype == ccode && group == G &&               \
      head_dim == D)                                                       \
    return pstt::launch<T, C, D, G>(q, k, v, k_scale, v_scale, page_table, \
                                    kv_lens, out, batch, num_q_heads,      \
                                    num_kv_heads, num_pages, page_size,    \
                                    max_pages, offsets, s);
  PSTT_FOR_EACH_GEOMETRY(PSTT_DECODE_CASE)
#undef PSTT_DECODE_CASE
  return cudaErrorInvalidValue;
}

// 1 if the kernels (decode, prefill, ragged: all three dispatch through
// PSTT_FOR_EACH_GEOMETRY) are built for this dtype code, cache dtype
// code, query group and head dim, else 0.
extern "C" int pstt_kernel_supports(int dtype, int cache_dtype, int group,
                                    int head_dim) {
#define PSTT_SUPPORTS_CASE(code, T, ccode, C, G, D)                     \
  if (dtype == code && cache_dtype == ccode && group == G &&            \
      head_dim == D)                                                    \
    return 1;
  PSTT_FOR_EACH_GEOMETRY(PSTT_SUPPORTS_CASE)
#undef PSTT_SUPPORTS_CASE
  return 0;
}
