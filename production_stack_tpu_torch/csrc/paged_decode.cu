// Paged decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel paged_decode_attention
// (production_stack_tpu/ops/paged_attention_pallas.py:147).
//
// What bounds it: the bytes of the cached K and V (about one operation
// per byte). Two things follow, and the design is built on them.
//
//   - Enough blocks, whatever the batch: the grid is (batch, kv_head,
//     split). The chunks of a (row, kv head) pair are cut into
//     `num_splits` ranges of `chunks_per_split`; a block walks one
//     range for a group tile of GT query heads of its kv head (each KV
//     byte is read from device memory once a step for each tile; one
//     tile holds the whole group up to GT) and, with more than one
//     split, writes its partial (acc[GT][D], m, l) in f32 to scratch,
//     which a
//     second small kernel merges in split order: no float atomics, the
//     same bits every launch. With one split the walk kernel writes the
//     output itself. The split comes from host-known shapes only; a
//     block whose range starts at or past its row's kv_len loads
//     nothing and writes the empty partial (0, -1e30, 0), and a row
//     whose every split is empty (a pad row) merges to exact 0.
//   - Bytes in flight the whole time: a chunk's K and V pages stage as
//     they lie in device memory, in the cache's own type (bf16, f32 or
//     int8 plus its scales), through two stages of cp.async (16 bytes
//     a copy, or as wide as a page row allows: stage_chunk_async), so
//     chunk c + 1 arrives while chunk c is used. Nothing is expanded to
//     f32 in shared memory: 64 KB of stages a block at bf16 (32 KB at
//     int8), three blocks an SM, at head_dim 64; twice that at head_dim
//     128, one block an SM at bf16. An f32 cache at head_dim 128 would
//     need 256 KB for two stages: it takes one (128 KB), and its copies
//     no longer overlap the arithmetic of the block before. At head_dim
//     256 a bf16 or f16 cache takes one stage (128 KB), an int8 one two
//     (64 KB each), and an f32 one stages K, then V, through one 128 KB
//     plane (DecodeSmem::kSerial).
//
// The query group G (q heads per kv head) is a run-time value. A block
// covers a compile-time group tile of GT query heads; the grid's y axis
// runs over kv heads x ceil(G / GT) tiles, and in the last tile the
// heads past G load zeros and are never written. GT is the fewest of
// 1, 4 and 8 that holds G, at most 8 at head_dim 64 and below, 4 up to
// 128 and 2 at 256 (group_tile(): a thread holds GT * D / 4 f32
// accumulators, and GT = 8 at head_dim 80 or 128, or 4 at 256, would
// pass the 255 registers a thread may have). G = 1 and bench-1b's G = 4
// run exactly their own tile; Llama-3-70B's G = 8 at head_dim 128 runs
// two tiles of 4, and Falcon3's G = 3 at 256 two tiles of 2 (the second
// with one live head): each reads the kv head's pages twice.
//
// Head dims: every head_dim from 1 to 256 runs at its tile
// (head_dim_tile, paged_kv_common.cuh), padded below it: q's and out's
// rows and the pages are read at the real head_dim, the planes' rows
// past it are zero (written once a block), and the partials keep the
// tile's width (GT x (tile + 2) words). Above 256 a head_dim runs as
// head_dim_slabs() slabs of 128 (paged_kv_common.cuh's slab design;
// paged_decode_slab_kernel): a block a (row, kv head, group tile,
// slab, split), K staged a slab at a time through a ring of two planes
// and the own V slab beside them, the scores summed over the slabs,
// the partials (and the merge's and the tail's grids) one slab each,
// GT x (128 + 2) words, the group tile that of the tile 128.
//
// The arithmetic stays under the copy with plain f32 FMA: thread
// (token group, head-dim quarter) of 128 reads 4 adjacent tokens of one
// head dim as one 4-, 8- or 16-byte word and shares it between the GT
// query heads of its tile (16 FMAs a load at GT = 4). A swizzle of the
// row offset by head dim keeps the four quarters of a warp on different
// banks. Each warp runs its own online softmax over its 32 tokens of
// every chunk in registers and shuffles; the four warps merge once, at
// the end of the walk. An int8 cache folds its scales in the Pallas order.
//
// The burst-tail form (pstt_paged_decode_tail) serves a decode burst
// with deferred KV writes: the burst's tokens not yet flushed to the
// pages lie in a dense tail [B, S <= 32, kv_heads, D] in the query's
// type, slot s of row b at position kv_lens[b] + s, attending iff that
// position is at most the row's query position q_pos[b]. The tail is
// one more split: the walk writes its splits' partials as always, a
// small kernel writes the tail's partial (f32 FMA, one block a (row, kv
// head), S * D elements of K and of V, read once) into the slot after
// them, and the merge combines all of them in split order, the tail
// last. So the form always merges, and its bits are the same launch to
// launch.
//
// C interface (loaded with ctypes by ops/paged_kv_common.py):
//   q [B, num_q_heads, D]; k/v cache [kv_heads, num_pages, D, page_size]
//   (D the real head_dim), or the stacked [L, kv_heads, num_pages, D,
//   page_size] cache read at `layer`; k/v scale [(L,) kv_heads, num_pages, page_size] f32 for an
//   int8 cache, else null; page_table [B, max_pages] int32; kv_lens [B]
//   int32; out [B, num_q_heads, D]; partials: f32 scratch [B, kv_heads
//   * tiles * slabs, num_splits, GT, tile + 2], tile-major within a kv
//   head (slab fastest), with tile = head_dim_tile(D), slabs =
//   head_dim_slabs(D), GT = pstt_decode_group_tile(G, D) and tiles =
//   ceil(G / GT) (null with one split); dtype (q, out) 0 = bf16, 1 = f32, 3 = f16;
//   cache_dtype the same code, or 2 = int8;
//   layer_stride / scale_layer_stride: elements between two layers of
//   the data / the scales (the per-layer form is layer 0 with strides 0).
// The tail form adds k_tail / v_tail [B, tail_len, kv_heads, D] (dtype)
// and q_pos [B] int32; its partials hold num_splits + 1 slots.
// Launches on `stream`, allocates nothing, does not synchronise, and
// returns cudaGetLastError() after the launch. A dtype outside
// PSTT_FOR_EACH_GEOMETRY, a head dim under 1, or a page size under 1
// (page_size_ok), returns cudaErrorInvalidValue;
// pstt_kernel_supports(dtype, cache_dtype, group, head_dim) and
// pstt_page_size_supported(page_size) tell the host first.
// Any page size of 1 or more: a split's chunks are 128 tokens of the
// row, a page of 256 tokens two of them.
//
// The kernels' templates are in paged_decode.cuh; paged_decode_bf16.cu,
// paged_decode_f16.cu and paged_decode_f32.cu instantiate them a query
// type each, so that the build compiles the three in parallel.

#include "paged_decode.cuh"

namespace {

int paged_decode_entry(int dtype, int cache_dtype, const void* q,
                       const void* k, const void* v, const void* k_scale,
                       const void* v_scale, const void* page_table,
                       const void* kv_lens, void* out, void* partials,
                       int batch, int num_q_heads, int num_kv_heads,
                       int head_dim, int num_pages, int page_size,
                       int max_pages, int num_splits, int chunks_per_split,
                       const void* k_tail, const void* v_tail,
                       const void* q_pos, int tail_len, int layer,
                       long long layer_stride, long long scale_layer_stride,
                       void* stream) {
  const bool tail = k_tail != nullptr;
  if (num_kv_heads <= 0 || num_q_heads < num_kv_heads ||
      num_q_heads % num_kv_heads || !pstt::page_size_ok(page_size) ||
      layer < 0 || layer_stride < 0 ||
      scale_layer_stride < 0 || num_splits < 1 || chunks_per_split < 1 ||
      ((num_splits > 1 || tail) && partials == nullptr) ||
      (tail && (v_tail == nullptr || q_pos == nullptr || tail_len < 1 ||
                tail_len > pstt::kMaxTail)))
    return cudaErrorInvalidValue;
  if (batch == 0) return cudaSuccess;
  const pstt::DecodeArgs args{
      q, k, v, k_scale, v_scale, page_table, kv_lens, out, partials, batch,
      num_q_heads, num_kv_heads, num_pages, page_size, max_pages,
      num_splits, chunks_per_split,
      pstt::LayerOffsets{layer, layer_stride, scale_layer_stride}, k_tail,
      v_tail, q_pos, tail_len, head_dim,
      static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case 0:
      return pstt::decode_launch_bf16(args, cache_dtype);
    case 3:
      return pstt::decode_launch_f16(args, cache_dtype);
    case 1:
      return pstt::decode_launch_f32(args, cache_dtype);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int pstt_paged_decode(int dtype, int cache_dtype, const void* q,
                                 const void* k, const void* v,
                                 const void* k_scale, const void* v_scale,
                                 const void* page_table,
                                 const void* kv_lens, void* out,
                                 void* partials, int batch,
                                 int num_q_heads, int num_kv_heads,
                                 int head_dim, int num_pages, int page_size,
                                 int max_pages, int num_splits,
                                 int chunks_per_split, int layer,
                                 long long layer_stride,
                                 long long scale_layer_stride,
                                 void* stream) {
  return paged_decode_entry(
      dtype, cache_dtype, q, k, v, k_scale, v_scale, page_table, kv_lens,
      out, partials, batch, num_q_heads, num_kv_heads, head_dim, num_pages,
      page_size, max_pages, num_splits, chunks_per_split, nullptr, nullptr,
      nullptr, 0, layer, layer_stride, scale_layer_stride, stream);
}

extern "C" int pstt_paged_decode_tail(
    int dtype, int cache_dtype, const void* q, const void* k, const void* v,
    const void* k_scale, const void* v_scale, const void* page_table,
    const void* kv_lens, void* out, void* partials, const void* k_tail,
    const void* v_tail, const void* q_pos, int batch, int num_q_heads,
    int num_kv_heads, int head_dim, int num_pages, int page_size,
    int max_pages, int num_splits, int chunks_per_split, int tail_len,
    int layer, long long layer_stride, long long scale_layer_stride,
    void* stream) {
  if (k_tail == nullptr) return cudaErrorInvalidValue;
  return paged_decode_entry(
      dtype, cache_dtype, q, k, v, k_scale, v_scale, page_table, kv_lens,
      out, partials, batch, num_q_heads, num_kv_heads, head_dim, num_pages,
      page_size, max_pages, num_splits, chunks_per_split, k_tail, v_tail,
      q_pos, tail_len, layer, layer_stride, scale_layer_stride, stream);
}

// 1 if the kernels (decode, prefill, ragged: all three dispatch through
// PSTT_FOR_EACH_GEOMETRY) are built for this dtype code, cache dtype
// code, query group and head dim, else 0. The group is any of 1 or
// more (the kernels take it at run time); the head dim any of 1 or
// more, run at its tile up to kMaxHeadDim and as head_dim_slabs()
// slabs of the tile kSlabDim above it.
extern "C" int pstt_kernel_supports(int dtype, int cache_dtype, int group,
                                    int head_dim) {
  if (group < 1) return 0;
  const int tile = pstt::head_dim_tile(head_dim);
  const bool slabs = pstt::head_dim_slabs(head_dim) > 1;
#define PSTT_SUPPORTS_CASE(code, T, ccode, C, D, SLABS)                  \
  if (dtype == code && cache_dtype == ccode && tile == D && slabs == SLABS) \
    return 1;
  PSTT_FOR_EACH_GEOMETRY(PSTT_SUPPORTS_CASE)
#undef PSTT_SUPPORTS_CASE
  return 0;
}

// 1 if the kernels (decode, prefill, ragged) walk pages of this many
// tokens, else 0: every page of 1 token or more (page_size_ok), over
// every cache the kernels read.
extern "C" int pstt_page_size_supported(int page_size) {
  return pstt::page_size_ok(page_size) ? 1 : 0;
}

// The decode kernel's group tile for this query group and head dim
// (the partials' GT; the host sizes the scratch from it, with rows of
// the head dim's tile or slab + 2 words); 0 for a head dim under 1.
extern "C" int pstt_decode_group_tile(int group, int head_dim) {
  const int tile = pstt::head_dim_tile(head_dim);
  return tile ? pstt::group_tile(group, tile) : 0;
}
