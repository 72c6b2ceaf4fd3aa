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
// its first one or two. A tile with no live row writes its zeros and
// returns without staging K/V. A tile with live rows walks the row's
// pages once for all of them (paged_kv_common.cuh page_walk_block),
// with the narrowest of three row blocks (8, 32 or 64 rows) that holds
// them, so a decode row does not pay for 64 rows of arithmetic. The
// walk stops at the last chunk the tile's highest live slot can see.
// An int8 cache stages as int8 pages and their scales, folded in
// (paged_kv_common.cuh).
//
// C interface (loaded with ctypes by ops/paged_kv_common.py):
//   q/out [R, W, num_q_heads, D]; k/v cache [kv_heads, num_pages, D,
//   page_size], or the stacked [L, kv_heads, ...] cache read at
//   `layer`; k/v scale [(L,) kv_heads, num_pages, page_size] f32 for an
//   int8 cache, else null; page_table [R, max_pages], kv_lens [R],
//   last_index [R], draft_lens [R] or null, all int32; dtype (q, out)
//   0 = bf16, 1 = f32; cache_dtype 0 = bf16, 1 = f32, 2 = int8;
//   layer_stride / scale_layer_stride as in paged_decode.cu.
// Launches on `stream`, allocates nothing, does not synchronise, and
// returns cudaGetLastError() after the launch.

#include "paged_kv_common.cuh"

namespace pstt {
namespace {

constexpr int kRaggedThreads = 256;
constexpr int kRaggedTile = 64;

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
  const int tile = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int row0 = tile * kRaggedTile;
  const int tile_rows = min(kRaggedTile, group * width - row0);
  const int kv_len = kv_lens[b];
  const int last = kv_len > 0 ? last_index[b] : -1;
  const int live =
      max(0, min((min(last, width - 1) + 1) * group - row0, tile_rows));
  const SlotMajorRows rows{
      ((size_t)b * width * num_q_heads + (size_t)h * group) * D, group,
      num_q_heads, D, row0};

  // Dead slots of this tile: exact 0.
  for (int i = live * D + threadIdx.x; i < tile_rows * D;
       i += kRaggedThreads) {
    const int r = i / D;
    out[rows.offset(r) + (i - r * D)] = from_f32<T>(0.f);
  }
  if (live == 0) return;

  const size_t head_elems = (size_t)num_pages * D * page_size;
  const size_t head_slots = (size_t)num_pages * page_size;
  const C* k_head = k_cache + layer.data() + h * head_elems;
  const C* v_head = v_cache + layer.data() + h * head_elems;
  const float* ks_head =
      kQuantized<C> ? k_scale + layer.scale() + h * head_slots : nullptr;
  const float* vs_head =
      kQuantized<C> ? v_scale + layer.scale() + h * head_slots : nullptr;
  const int* pt_row = page_table + (size_t)b * max_pages;
  const RaggedMask mask{kv_len, last, group, row0};
  if (live <= 8) {
    page_walk_block<T, C, D, 8, 8, kRaggedThreads>(
        q, out, rows, k_head, v_head, ks_head, vs_head, pt_row, max_pages,
        page_size, kv_len, mask, live);
  } else if (live <= 32) {
    page_walk_block<T, C, D, 32, 8, kRaggedThreads>(
        q, out, rows, k_head, v_head, ks_head, vs_head, pt_row, max_pages,
        page_size, kv_len, mask, live);
  } else {
    page_walk_block<T, C, D, kRaggedTile, 16, kRaggedThreads>(
        q, out, rows, k_head, v_head, ks_head, vs_head, pt_row, max_pages,
        page_size, kv_len, mask, live);
  }
}

template <typename T, typename C, int D>
int launch(const void* q, const void* k, const void* v, const void* ks,
           const void* vs, const void* pt, const void* kv_lens,
           const void* last_index, void* out, int rows, int width,
           int num_q_heads, int num_kv_heads, int num_pages, int page_size,
           int max_pages, LayerOffsets layer, cudaStream_t stream) {
  if (kQuantized<C> && (ks == nullptr || vs == nullptr))
    return cudaErrorInvalidValue;
  // The widest row block's layout; the narrower ones use a prefix of
  // it, and place their scales by their own layout, inside it.
  constexpr size_t smem = SmemLayout<D, kRaggedTile, kQuantized<C>>::bytes;
  auto kernel = paged_ragged_kernel<T, C, D>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return attr;
  const int group = num_q_heads / num_kv_heads;
  const int tiles = (group * width + kRaggedTile - 1) / kRaggedTile;
  kernel<<<dim3(tiles, num_kv_heads, rows), kRaggedThreads, smem,
           stream>>>(
      static_cast<const T*>(q), static_cast<const C*>(k),
      static_cast<const C*>(v), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(pt),
      static_cast<const int*>(kv_lens),
      static_cast<const int*>(last_index), static_cast<T*>(out), width,
      num_q_heads, group, num_pages, page_size, max_pages, layer);
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
      page_size <= 0 || pstt::kChunk % page_size || layer < 0 ||
      layer_stride < 0 || scale_layer_stride < 0)
    return cudaErrorInvalidValue;
  const pstt::LayerOffsets offsets{layer, layer_stride, scale_layer_stride};
  if (rows == 0 || width == 0) return cudaSuccess;
  const int group = num_q_heads / num_kv_heads;
  auto s = static_cast<cudaStream_t>(stream);
#define PSTT_RAGGED_CASE(code, T, ccode, C, G, D)                          \
  if (dtype == code && cache_dtype == ccode && group == G &&               \
      head_dim == D)                                                       \
    return pstt::launch<T, C, D>(q, k, v, k_scale, v_scale, page_table,    \
                                 kv_lens, last_index, out, rows, width,    \
                                 num_q_heads, num_kv_heads, num_pages,     \
                                 page_size, max_pages, offsets, s);
  PSTT_FOR_EACH_GEOMETRY(PSTT_RAGGED_CASE)
#undef PSTT_RAGGED_CASE
  return cudaErrorInvalidValue;
}
