// Paged chunked-prefill attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel paged_prefill_attention
// (production_stack_tpu/ops/prefill_attention_pallas.py:149). Grid
// (query tile, kv_head, batch; the wgmma walk: kv head, batch, query
// tile); the G * T query rows of a (row, kv head) pair are flattened
// g-major and cut into tiles of 64 rows (128 on the wgmma walk).
// Query t of a row sits at q_positions[b, 0] + t; a tile stops at the
// last chunk its highest query position can see, which skips only
// fully masked work. A row with kv_len 0 writes 0.
//
// What bounds it: operations. A 512-token chunk does 4 * heads *
// head_dim operations per visible (query, token) pair over K/V that
// the G * T rows of a kv head share, far above the card's ridge of
// about 295 bf16 operations per byte; so the products have to run on
// the tensor cores at Hopper's rate, which only wgmma reaches, and the
// copies, the int8 conversion and the softmax must stay off the
// products' path. bf16 and f16 queries (over a cache of their type or
// int8) up to head_dim 256 take the walk of paged_walk_wgmma.cuh: a
// block of one or two consumer warpgroups (64-row tiles where G * T
// fits in 64, else 128) and a producer warpgroup with few registers
// (setmaxnreg). The producer resolves a span's page ids once and fills
// a ring of 2 to 4 stages of 64 tokens' K and V in the 128-byte
// swizzle, with cp.async copies reporting to a `full` mbarrier; an int8
// cache is copied raw and converted by the producer, off the
// consumers' path. Each consumer warpgroup runs q . k^T (m64n64k16, K
// as it lies: the transpose bit) and p . v (m64nDk16, V as it lies) as
// wgmma from the stage's descriptors, q and p as register operands (q
// from a swizzled shared tile at 256), the online softmax in
// registers, and frees the stage on an `empty` mbarrier: no block-wide
// barrier between copies and products. Tiles are launched heaviest
// first. f32 queries (held to 1e-4) keep page_walk_block
// (paged_kv_common.cuh): f32 FMA over f32 tiles, one block of 256
// threads a tile (194 KB of shared memory at head_dim 128; at 256 half
// a chunk at a time, 212 KB). The choice is by type, at compile time;
// the query group is a run-time value of both walks (any group: G * T
// rows cut into tiles). Any head_dim from 1 to 256 runs at its tile
// (head_dim_tile, paged_kv_common.cuh), padded in the kernel below it.
// bf16 and f16 queries from 257 to 512 take the wgmma walk's wide form
// at a width of 384 or 512 (wg_wide_width, paged_walk_wgmma.cuh): a
// 64-row tile a block, both consumer warpgroups running q . k^T over the
// whole width and p . v over half of the output dims each, K and V in a
// ring of single planes. f32 queries above 256, and 16-bit ones above
// 512, run as slabs of 128 (the slab design in paged_kv_common.cuh),
// grid y over kv heads x slabs, on the mma.sync slab walk
// (page_walk_block_mma_slab, paged_walk_mma.cuh: 90 KB, two blocks an
// SM) or the f32 walk's slab form.
//
// The kernels' templates are in paged_prefill.cuh;
// paged_prefill_bf16.cu, paged_prefill_f16.cu and paged_prefill_f32.cu
// instantiate them a query type each, so that the build compiles the
// three in parallel.
//
// C interface (loaded with ctypes by ops/paged_kv_common.py):
//   q/out [B, T, num_q_heads, head_dim]; k/v cache [kv_heads,
//   num_pages, head_dim, page_size], or the stacked [L, kv_heads, ...] cache read at
//   `layer`; k/v scale [(L,) kv_heads, num_pages, page_size] f32 for an
//   int8 cache, else null; page_table [B, max_pages], q_positions
//   [B, T] (row starts read only), kv_lens [B], all int32; dtype (q,
//   out) 0 = bf16, 1 = f32, 3 = f16; cache_dtype the same code, or 2 =
//   int8;
//   layer_stride / scale_layer_stride as in paged_decode.cu.
// Launches on `stream`, allocates nothing, does not synchronise, and
// returns cudaGetLastError() after the launch.
// pstt_prefill_walk_launches(walk) is the number of launches of a walk
// (0 wgmma, 1 its wide form, 2 mma_slab, 3 f32) that the runtime took
// since the library was loaded, -1 for another index.

#include <atomic>

#include "paged_prefill.cuh"

namespace pstt {
namespace {
std::atomic<long long> walk_launches[kPrefillWalks];
}  // namespace

void count_prefill_walk(PrefillWalk walk) {
  walk_launches[walk].fetch_add(1, std::memory_order_relaxed);
}
}  // namespace pstt

extern "C" long long pstt_prefill_walk_launches(int walk) {
  if (walk < 0 || walk >= pstt::kPrefillWalks) return -1;
  return pstt::walk_launches[walk].load(std::memory_order_relaxed);
}

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
      !pstt::page_size_ok(page_size) || layer < 0 ||
      layer_stride < 0 || scale_layer_stride < 0)
    return cudaErrorInvalidValue;
  if (batch == 0 || tokens == 0) return cudaSuccess;
  const pstt::PrefillArgs args{
      q, k, v, k_scale, v_scale, page_table, q_positions, kv_lens, out,
      batch, tokens, num_q_heads, num_kv_heads, head_dim, num_pages,
      page_size, max_pages,
      pstt::LayerOffsets{layer, layer_stride, scale_layer_stride},
      static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case 0:
      return pstt::prefill_launch_bf16(args, cache_dtype);
    case 3:
      return pstt::prefill_launch_f16(args, cache_dtype);
    case 1:
      return pstt::prefill_launch_f32(args, cache_dtype);
    default:
      return cudaErrorInvalidValue;
  }
}
