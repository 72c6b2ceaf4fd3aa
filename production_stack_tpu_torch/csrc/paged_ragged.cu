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
// ones included, is written). So bf16 and f16 queries up to head_dim
// 128 (over a cache of their type or int8) take the tensor-core walk of
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
// their scales, folded in the Pallas order. Any head_dim from 1 to 256
// runs at its tile (head_dim_tile, paged_kv_common.cuh), padded in the
// kernel below the tile; dead rows are zeroed with the widest store
// that divides a row (8 bytes at head_dim 100 in 16 bits). Above 256 a
// head_dim runs as slabs of 128 (paged_kv_common.cuh's slab design),
// grid y over kv heads x slabs: the tensor-core slab walk
// (page_walk_block_mma_slab) or the f32 walk's slab form, a block
// zeroing and writing its own slab's head dims.
//
// Which walk serves which form (pstt_ragged_walk_launches counts them):
//   - bf16/f16 up to head_dim 128: the mma.sync walk above (mma);
//   - bf16/f16 at 129 to 256: the wgmma walk (paged_walk_wgmma.cuh,
//     prefill's, with the ragged tile policy WgRaggedTiles) at the tile
//     256 (wgmma); at 257 to 512 its wide form at the width 384 or 512
//     (wgmma_wide);
//   - bf16/f16 above 512: the mma.sync slab walk (mma_slab);
//   - f32 at every head_dim: the f32 walk (f32).
// On the wgmma walk, persistent blocks (min(tiles, SMs)) take tiles
// from a scheduler: the pair's live tiles first, heaviest first, then
// its dead ones (ragged_wg_tile). A tile is 128 rows of two consumer
// warpgroups at the tile 256 (64 of one where G * W fits in 64: a
// verify block), 64 rows of both in the wide form. A tile with no live
// row takes no q slot, no ring stage and no product: the producer
// passes it and the consumer warpgroups write its zeros; a live tile's
// dead rows each consumer warpgroup writes after its output. A dead
// tile so costs its zeros' bytes, where the mma.sync walk's block
// reserved a whole walk's shared memory to write them (at g3_d256,
// 3284 of the unified block's 3840 blocks were dead).
//
// Decided by A/B (tools/kernel_times.py --kernels ragged, medians of
// two turns in one call, L2 flushed, H100 80GB HBM3, 700 W; ms, bf16,
// the dead-tile block / the unified block):
//   - who writes a dead tile's zeros: the producer alone 0.1234 /
//     0.2157 at g3_d256 and 0.1778 / 0.3874 at g3_d512, all three
//     warpgroups 0.1085 / 0.1945 and 0.1775 / 0.2850 (one call); the
//     consumers alone 0.1086 / 0.1911 and 0.1768 / 0.3219, all three
//     with the producer writing live tiles' dead rows 0.1104 / 0.1974
//     and 0.1786 / 0.3198 (another call). The consumers alone: as fast,
//     and the producer (40 registers at these widths) keeps no zero
//     code, which spilled there.
//   - consumers at the tile 256: prefill's rule (two on 128-row tiles
//     above 64 rows) 0.2157 at g3_d256 against one on 64-row tiles
//     0.2550 (int8 0.2577 against 0.3091).
//
// The kernels' templates are in paged_ragged.cuh; paged_ragged_bf16.cu,
// paged_ragged_f16.cu and paged_ragged_f32.cu instantiate them a query
// type each, and paged_ragged_wgmma_bf16.cu and paged_ragged_wgmma_f16.cu
// the wgmma walk's forms, so that the build compiles the five in
// parallel.
//
// C interface (loaded with ctypes by ops/paged_kv_common.py):
//   q/out [R, W, num_q_heads, head_dim]; k/v cache [kv_heads,
//   num_pages, head_dim, page_size], or the stacked [L, kv_heads, ...] cache read at
//   `layer`; k/v scale [(L,) kv_heads, num_pages, page_size] f32 for an
//   int8 cache, else null; page_table [R, max_pages], kv_lens [R],
//   last_index [R], draft_lens [R] or null, all int32; dtype (q, out)
//   0 = bf16, 1 = f32, 3 = f16; cache_dtype the same code, or 2 =
//   int8;
//   layer_stride / scale_layer_stride as in paged_decode.cu.
// Launches on `stream`, allocates nothing, does not synchronise, and
// returns cudaGetLastError() after the launch.
// pstt_ragged_walk_launches(walk) is the number of launches of a walk
// (0 mma, 1 wgmma, 2 wgmma_wide, 3 mma_slab, 4 f32) that the runtime
// took since the library was loaded, -1 for another index.

#include <atomic>

#include "paged_ragged.cuh"

namespace pstt {
namespace {
std::atomic<long long> walk_launches[kRaggedWalks];
}  // namespace

void count_ragged_walk(RaggedWalk walk) {
  walk_launches[walk].fetch_add(1, std::memory_order_relaxed);
}
}  // namespace pstt

extern "C" long long pstt_ragged_walk_launches(int walk) {
  if (walk < 0 || walk >= pstt::kRaggedWalks) return -1;
  return pstt::walk_launches[walk].load(std::memory_order_relaxed);
}

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
  if (rows == 0 || width == 0) return cudaSuccess;
  const pstt::RaggedArgs args{
      q, k, v, k_scale, v_scale, page_table, kv_lens, last_index, out,
      rows, width, num_q_heads, num_kv_heads, head_dim, num_pages,
      page_size, max_pages,
      pstt::LayerOffsets{layer, layer_stride, scale_layer_stride},
      static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case 0:
      return pstt::ragged_launch_bf16(args, cache_dtype);
    case 3:
      return pstt::ragged_launch_f16(args, cache_dtype);
    case 1:
      return pstt::ragged_launch_f32(args, cache_dtype);
    default:
      return cudaErrorInvalidValue;
  }
}
