// What the paged decode, chunked-prefill and ragged attention kernels
// share (paged_decode.cu, paged_prefill.cu, paged_ragged.cu): the
// geometries they are built for, the layer offsets, row maps and masks,
// the asynchronous staging of a chunk (cp.async), and page_walk_block,
// the f32 FMA page walk. f32 prefill and ragged run page_walk_block;
// bf16 and f16 prefill run the wgmma walk of paged_walk_wgmma.cuh (its
// slabs the mma.sync slab walk), bf16 and f16 ragged the tensor-core
// walk of paged_walk_mma.cuh, decode its own split walk
// (paged_decode.cu). The contract below is the same for all of them.
//
// Counterpart of make_page_dma / run_page_walk in the JAX package's
// ops/paged_kv_common.py. One block owns one (row, kv head) pair and a
// block of ROWS query rows of that kv head. For each 128-token chunk
// of the row (tokens [128 c, 128 c + 128), token t at page
// page_table[row, t / page_size], slot t % page_size, for any page
// size: a page of 256 tokens is two chunks, one of 48 straddles chunk
// edges) it
//   - stages the chunk's K and V tokens (each page [head_dim,
//     page_size], token-minor) from device memory into shared memory
//     with coalesced loads (16 bytes, or as wide as the page row
//     allows: stage_chunk), converting to f32; tokens of pages past
//     ceil(kv_len / page_size) are not read and stage as zeros (at
//     head-dim tile 256, half a chunk at a time: walk_span);
//   - computes q.k^T / sqrt(head_dim) in f32 and sets scores outside
//     the mask to -1e30;
//   - runs the online softmax (m, l, acc in f32) and accumulates p.v.
// It stops at the last chunk any of its rows can see and writes
// acc / max(l, 1e-30): exact 0 for a row with kv_len 0.
//
// The cache's element type C is a template parameter apart from the
// query/output type T. With C = int8_t the cache is quantized: int8
// pages (16 tokens a 16-byte load at whole pages) plus one f32 scale
// per (kv head, page, slot), [kv_heads, num_pages, page_size]. The
// chunk's 128 K and V scales are staged beside its pages (zeros past
// the live pages) and folded in as the Pallas kernels fold them: the scores are
// (q . k_int8) / sqrt(head_dim) * k_scale[token], l sums the unscaled
// probabilities, and p * v_scale[token] enters p . v. That is the
// plain version's order exactly, and costs 2 * ROWS * 128 multiplies
// a chunk where scaling each staged element would cost 2 * D * 128.
//
// The mask is a template parameter (the counterpart of run_page_walk's
// mask_fn): it gives each row the exclusive upper bound of the token
// positions it attends. So is the map from a block's rows to query
// rows in device memory (RowMap, g-major; SlotMajorRows, slot-major).
// Shared-memory rows have an odd stride in words, so a warp reading one
// column of K, V or the scores touches 32 different banks.

// Head dims above the widest tile (kMaxHeadDim, 256) run as slabs:
// n = ceil(head_dim / kSlabDim) slabs of the tile kSlabDim = 128
// (head_dim_slabs), the last one padded in the kernel as a head_dim
// below its tile is. The slab is a grid axis: a block owns one output
// slab, so its p . v accumulators, its V plane and its output are the
// tile 128's. It builds the scores over the whole head_dim, walking q
// . k^T a slab at a time: each span stages one K slab and one q slab
// (into the same planes, or rings of two of them, whatever the
// head_dim), adds into the scores, and stages its own V slab with the
// last K slab; one online softmax over the full scores, with the real
// 1 / sqrt(head_dim), and the int8 scales folded in the Pallas order.
// Every block of a (row, kv head) computes the same m and l, so the
// decode kernel's partials and merge only gain the slab in their grid
// axis. Shared memory and registers stay those of the tile 128,
// whatever the head_dim. The price: each of the n blocks reads all of
// K (K is read n times, V once) and computes all of q . k^T.
//
// Why 128 and not 256: at 256 every layout is at the card's limit (the
// tensor-core walk's 128 accumulators a thread, decode's group tile of
// 2 at 255 registers, an f32 decode cache's K then V through one 128
// KB plane, the f32 walk's 212 KB), and a slab walk needs room beside
// them for a ring of K slabs, a q slab and the scores a span. At 128
// each of them fits: decode keeps a group tile of 4 (Falcon3's group
// 3 in one tile, where 256 would take two and read K twice more) and
// stages even an f32 cache's two K slabs and its V slab in 192 KB; the
// tensor-core walk keeps 64 accumulators and stages q, K and V slabs
// of 64 tokens (90 KB, two blocks an SM); the f32 walk keeps its
// tile-128 layout (194 KB). 256 would read K half as often (n halves)
// and is left to a later measurement.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace pstt {

constexpr int kChunk = 128;           // tokens per walk step
constexpr float kNegInf = -1e30f;

// What the kernels are built for: every query and output type (codes:
// 0 bf16, 1 f32, 3 f16, the host's _DTYPE_CODES) over a cache of the
// same type or int8 (cache code 2, the host's _CACHE_CODES), at every
// head_dim of 1 or more. The query group (q heads per kv head) is a
// run-time value of every kernel: any group of 1 or more.
// All three kernels dispatch through PSTT_FOR_EACH_GEOMETRY, and
// pstt_kernel_supports() (paged_decode.cu) answers the host from it;
// ops/paged_kv_common.kernel_geometry_supported is the same rule.
//
// Head dims: each kernel is built for the head-dim tiles below, in
// ascending order, and a head_dim up to the widest runs at the smallest
// tile at or above it (head_dim_tile), as the Pallas kernels pad
// head_dim to their lane tile. One instance a tile serves its own
// head_dim and every smaller one: the tile D sizes the shared memory,
// the registers and the products at compile time, the real head_dim is
// a run-time value. A kernel reads and writes only head dims d <
// head_dim of the cache, q and out; shared-memory rows d >= head_dim
// are zero, written once a block (the Pallas kernels' zero_pad_sublanes),
// and so are q's; the scale is 1 / sqrt(head_dim). The staging loops
// run over the tile's D rows (rows past head_dim copy zeros), so their
// trip counts stay constants and the tile's own head_dim keeps its time
// without an instance of its own (one doubled the build). The cache
// keeps its real head_dim: [kv_heads, num_pages, head_dim, page_size].
// Head dims that are a tile: 64 (bench-1b, TinyLlama, Qwen2-0.5B, OPT
// to 1.3b, GPT-2), 80 (OPT-2.7b), 128 (Llama, Mistral, Mixtral, the
// larger Qwen2 and OPT checkpoints), 256 (the Falcon3 family) and 32
// (the tiny test configs); padded, for example, 100 at 128
// (OpenLLaMA-3B), 96 at 128, 160 at 256. The last instance (SLABS true)
// is the slab walk of the tile kSlabDim: every head_dim above 256, in
// head_dim_slabs() slabs (see the slab design above).
#define PSTT_FOR_EACH_HEAD_DIM(X, code, T, ccode, C) \
  X(code, T, ccode, C, 32, false)                    \
  X(code, T, ccode, C, 64, false)                    \
  X(code, T, ccode, C, 80, false)                    \
  X(code, T, ccode, C, 128, false)                   \
  X(code, T, ccode, C, 256, false)                   \
  X(code, T, ccode, C, 128, true)
#define PSTT_FOR_EACH_BF16_GEOMETRY(X)                          \
  PSTT_FOR_EACH_HEAD_DIM(X, 0, __nv_bfloat16, 0, __nv_bfloat16) \
  PSTT_FOR_EACH_HEAD_DIM(X, 0, __nv_bfloat16, 2, int8_t)
#define PSTT_FOR_EACH_F16_GEOMETRY(X)           \
  PSTT_FOR_EACH_HEAD_DIM(X, 3, __half, 3, __half) \
  PSTT_FOR_EACH_HEAD_DIM(X, 3, __half, 2, int8_t)
#define PSTT_FOR_EACH_F32_GEOMETRY(X)         \
  PSTT_FOR_EACH_HEAD_DIM(X, 1, float, 1, float) \
  PSTT_FOR_EACH_HEAD_DIM(X, 1, float, 2, int8_t)
#define PSTT_FOR_EACH_GEOMETRY(X) \
  PSTT_FOR_EACH_BF16_GEOMETRY(X)  \
  PSTT_FOR_EACH_F16_GEOMETRY(X)   \
  PSTT_FOR_EACH_F32_GEOMETRY(X)

template <typename C>
constexpr bool kQuantized = std::is_same<C, int8_t>::value;

constexpr int kMaxHeadDim = 256;  // the widest tile
constexpr int kSlabDim = 128;     // the slab width above it
constexpr int kMaxBlockSmem = 232448;  // most shared memory a block may have

// The tile a head_dim runs at: the smallest of PSTT_FOR_EACH_HEAD_DIM at
// or above it up to kMaxHeadDim, the slab width kSlabDim above it; 0
// for a head_dim under 1.
__host__ __device__ constexpr int head_dim_tile(int head_dim) {
  if (head_dim < 1) return 0;
#define PSTT_TILE_AT_LEAST(code, T, ccode, C, D, SLABS) \
  if (!SLABS && head_dim <= D) return D;
  PSTT_FOR_EACH_HEAD_DIM(PSTT_TILE_AT_LEAST, 0, float, 0, float)
#undef PSTT_TILE_AT_LEAST
  return kSlabDim;
}

// The slabs a head_dim runs as: 1 up to kMaxHeadDim (its tile), else
// ceil(head_dim / kSlabDim) (the last one padded in the kernel). The
// host's ops/paged_kv_common.kernel_head_dim_slabs is the same rule.
__host__ __device__ constexpr int head_dim_slabs(int head_dim) {
  return head_dim <= kMaxHeadDim ? 1 : (head_dim + kSlabDim - 1) / kSlabDim;
}

// The head dims of slab `slab` a block fills from the cache and q:
// kSlabDim, or fewer in the last slab.
__host__ __device__ constexpr int slab_rows(int head_dim, int slab) {
  return head_dim - slab * kSlabDim < kSlabDim ? head_dim - slab * kSlabDim
                                               : kSlabDim;
}

// Tokens a walk stages at a time at head-dim tile D: a 128-token chunk,
// or half of one at tile 256, where a chunk of K and V staged whole
// passes the block's shared memory (page_walk_block: two f32 planes of
// 256 x 129 words are 264 KB). A chunk stays 128 tokens of a row: the
// decode kernel's splits and the plain walk count in chunks.
__host__ __device__ constexpr int walk_span(int d) {
  return d > 128 ? kChunk / 2 : kChunk;
}

// The page sizes the kernels walk: every page of 1 token or more (a
// chunk is 128 tokens of a row whatever the page; see stage_chunk). The
// launchers refuse any other, and pstt_page_size_supported()
// (paged_decode.cu) answers the host from it;
// ops/paged_kv_common.kernel_page_size_supported is the same rule.
__host__ __device__ constexpr bool page_size_ok(int page_size) {
  return page_size >= 1;
}

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <>
__device__ __forceinline__ float to_f32<__half>(__half x) {
  return __half2float(x);
}
template <>
__device__ __forceinline__ float to_f32<int8_t>(int8_t x) {
  return (float)x;
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}

// Shared memory of one block of page_walk_block, in floats. A quantized
// cache (QUANT) adds the span's K and V scales. K and V stage a span of
// walk_span(D) tokens: a chunk up to head_dim 128 (194 KB at 128 and 64
// rows); half a chunk at 256 (212 KB at 64 rows), where a whole one
// would need 264 KB for K and V alone. Staging K then V in one plane
// would not fit either (q, one 256 x 129 plane and the scores are 227.3
// KB at 64 rows), and half chunks keep the one-pass body of the walk.
template <int D, int ROWS, bool QUANT = false>
struct SmemLayout {
  static constexpr int kSpan = walk_span(D);
  static constexpr int kSStride = kSpan + 1;  // row stride of K, V, scores
  static constexpr int kQStride = D + 1;
  static constexpr int kScales = QUANT ? kSpan : 0;
  static constexpr int q = 0;                          // [ROWS][D + 1]
  static constexpr int k = q + ROWS * kQStride;        // [D][kSStride]
  static constexpr int v = k + D * kSStride;           // [D][kSStride]
  static constexpr int s = v + D * kSStride;           // [ROWS][kSStride]
  static constexpr int m = s + ROWS * kSStride;        // [ROWS]
  static constexpr int l = m + ROWS;                   // [ROWS]
  static constexpr int alpha = l + ROWS;               // [ROWS]
  static constexpr int ks = alpha + ROWS;              // [kScales]
  static constexpr int vs = ks + kScales;              // [kScales]
  static constexpr int total = vs + kScales;
  static constexpr size_t bytes = total * sizeof(float);
  static_assert(bytes <= kMaxBlockSmem, "a walk block's shared memory");
};

// Where one layer of a stacked [L, kv_heads, num_pages, D, page_size]
// cache (and of its [L, kv_heads, num_pages, page_size] scales) starts:
// `layer` strides past the base pointer, the counterpart of Pallas's
// k_hbm.at[layer_ref[0], h, page]. The product is taken in 64 bits: a
// stacked cache at a full card's page budget holds more than 2^31
// elements. The per-layer [kv_heads, ...] form is layer 0, strides 0.
struct LayerOffsets {
  int layer;
  long long data_stride;   // elements between two layers of the pages
  long long scale_stride;  // elements between two layers of the scales

  __device__ __forceinline__ size_t data() const {
    return (size_t)layer * (size_t)data_stride;
  }
  __device__ __forceinline__ size_t scale() const {
    return (size_t)layer * (size_t)scale_stride;
  }
};

// Where query/output row r of a block lives: rows are (g, t) pairs
// flattened g-major over the G query heads of one kv head and the T
// tokens of the row (decode: T = 1).
struct RowMap {
  size_t base;  // element offset of (row b, token 0, q head h * G)
  int tokens;   // T
  int num_q_heads;
  int head_dim;
  int row0;     // first flattened row of this block

  __device__ __forceinline__ size_t offset(int r) const {
    const int rg = row0 + r;
    const int g = rg / tokens;
    const int t = rg - g * tokens;
    return base + ((size_t)t * num_q_heads + g) * head_dim;
  }
};

// Where query/output row r of a block lives when the rows are (t, g)
// pairs flattened slot-major: the G query heads of one slot are
// adjacent, so the live slots of a ragged row form one prefix of its
// rows and a decode row's G queries share one tile.
struct SlotMajorRows {
  size_t base;  // element offset of (row b, slot 0, q head h * G)
  int group;    // G
  int num_q_heads;
  int head_dim;
  int row0;     // first flattened row of this block

  __device__ __forceinline__ size_t offset(int r) const {
    const int rg = row0 + r;
    const int t = rg / group;
    const int g = rg - t * group;
    return base + ((size_t)t * num_q_heads + g) * head_dim;
  }
};

// Decode: every row attends pos < kv_len.
struct DecodeMask {
  int kv_len;
  __device__ __forceinline__ int limit(int) const { return kv_len; }
  __device__ __forceinline__ int max_limit(int) const { return kv_len; }
};

// Chunked prefill: query t sits at q_start + t and attends
// pos <= q_start + t and pos < kv_len.
struct CausalMask {
  int kv_len;
  int q_start;
  int tokens;  // T
  int row0;
  __device__ __forceinline__ int limit(int r) const {
    const int t = (row0 + r) % tokens;
    return min(q_start + t + 1, kv_len);
  }
  // Largest limit over this block's rows [0, nrows).
  __device__ __forceinline__ int max_limit(int nrows) const {
    if (nrows >= tokens) return min(q_start + tokens, kv_len);
    const int first = row0 % tokens;
    const int last = (row0 + nrows - 1) % tokens;
    const int t_max = first <= last ? last : tokens - 1;
    return min(q_start + t_max + 1, kv_len);
  }
};

// Ragged row of a unified block (rows slot-major): slot t is live when
// t <= last_index, sits at q_start + t with q_start = kv_len - 1 -
// last_index, and attends pos <= q_start + t and pos < kv_len. A dead
// slot's limit is 0.
struct RaggedMask {
  int kv_len;
  int last_index;
  int group;  // G
  int row0;
  __device__ __forceinline__ int limit(int r) const {
    const int t = (row0 + r) / group;
    return t <= last_index
               ? min(kv_len - 1 - last_index + t + 1, kv_len)
               : 0;
  }
  // Largest limit over this block's rows [0, nrows), all live: the
  // slot of the last row has the largest.
  __device__ __forceinline__ int max_limit(int nrows) const {
    return limit(nrows - 1);
  }
};

// How a chunk is staged at a page size. A power of two up to 128 whose
// page row holds a multiple of 16 bytes of C (bf16 and f16 from 8
// tokens, f32 from 4, int8 from 16) takes whole pages a chunk with
// 16-byte copies, the position shifted where it could be divided (the
// path of page 128 and of the server's default 16, kept for its
// speed). Any other page takes the general staging:
// each token's page and slot by division, with the widest copy that no
// page edge cuts and that keeps the page row's alignment
// (copy_elems). The launch picks the path by page size at run time.
template <typename C>
__host__ __device__ __forceinline__ bool whole_page_staging(int page_size) {
  return page_size <= kChunk && (page_size & (page_size - 1)) == 0 &&
         page_size * (int)sizeof(C) % 16 == 0;
}

// Elements of `esz` bytes a copy of the general staging moves: the
// largest power of two that divides the page size, at most 16 bytes. A copy starts at
// a multiple of it in the row's token order, so it never crosses a page
// edge (a multiple of the page size) or a chunk edge (of 128), and its
// source lies at a multiple of its own width in bytes: every page row
// starts at a multiple of page_size elements from the 256-byte aligned
// cache. Copies of 16, 8 or 4 bytes; 2 or 1 where the page size is
// odd, or is 2 mod 4 in int8.
__device__ __forceinline__ int copy_elems(int page_size, int esz) {
  return min(page_size & -page_size, 16 / esz);
}

// `bytes` (1, 2, 4, 8 or 16, aligned) of device memory, zero-extended
// into a 16-byte word.
__device__ __forceinline__ uint4 load_bytes(const void* src, int bytes) {
  uint4 r = make_uint4(0, 0, 0, 0);
  switch (bytes) {
    case 16:
      r = *reinterpret_cast<const uint4*>(src);
      break;
    case 8: {
      const uint2 x = *reinterpret_cast<const uint2*>(src);
      r.x = x.x;
      r.y = x.y;
      break;
    }
    case 4:
      r.x = *reinterpret_cast<const uint32_t*>(src);
      break;
    case 2:
      r.x = *reinterpret_cast<const uint16_t*>(src);
      break;
    default:
      r.x = *reinterpret_cast<const uint8_t*>(src);
  }
  return r;
}

// The general staging of stage_chunk (a page that whole_page_staging
// does not take): copy_elems tokens of one head dim a load, each
// token's page and slot by division. Not inlined, the head dim, the
// span and the thread count taken at run time: one body a cache type
// serves every instance of page_walk_block, which keeps its registers
// and the build as they were before the general path.
template <typename C>
__device__ __noinline__ void stage_chunk_any(
    const C* __restrict__ k_head, const C* __restrict__ v_head,
    const int* __restrict__ pt_row, int pos0, int span, int pages_live,
    int page_size, int head_dim, int nthreads, float* __restrict__ ks,
    float* __restrict__ vs) {
  constexpr int kVec = 16 / sizeof(C);
  const int vec = copy_elems(page_size, sizeof(C));
  const int row_shift = __ffs(span / vec) - 1;  // log2 copies a row
  for (int i = threadIdx.x; i < head_dim << row_shift; i += nthreads) {
    const int d = i >> row_shift;
    const int col = (i - (d << row_shift)) * vec;
    const int pos = pos0 + col;
    const int lp = pos / page_size;
    uint4 kraw = make_uint4(0, 0, 0, 0);
    uint4 vraw = make_uint4(0, 0, 0, 0);
    if (lp < pages_live) {
      const size_t src = ((size_t)pt_row[lp] * head_dim + d) * page_size +
                         (pos - lp * page_size);
      kraw = load_bytes(k_head + src, vec * (int)sizeof(C));
      vraw = load_bytes(v_head + src, vec * (int)sizeof(C));
    }
    const C* ke = reinterpret_cast<const C*>(&kraw);
    const C* ve = reinterpret_cast<const C*>(&vraw);
    float* kd = ks + d * (span + 1) + col;
    float* vd = vs + d * (span + 1) + col;
#pragma unroll
    for (int x = 0; x < kVec; ++x) {
      if (x < vec) {
        kd[x] = to_f32(ke[x]);
        vd[x] = to_f32(ve[x]);
      }
    }
  }
}

// The general staging of a slab walk's stage_chunk (SLAB): the planes
// named, rows d < rows, inlined into the slab instances (a call from
// their loop spilled around it).
template <typename C>
__device__ __forceinline__ void stage_chunk_any_rows(
    const C* __restrict__ k_head, const C* __restrict__ v_head,
    const int* __restrict__ pt_row, int pos0, int span, int pages_live,
    int page_size, int head_dim, int rows, int planes, int nthreads,
    float* __restrict__ ks, float* __restrict__ vs) {
  constexpr int kVec = 16 / sizeof(C);
  const int vec = copy_elems(page_size, sizeof(C));
  const int row_shift = __ffs(span / vec) - 1;  // log2 copies a row
  for (int i = threadIdx.x; i < rows << row_shift; i += nthreads) {
    const int d = i >> row_shift;
    const int col = (i - (d << row_shift)) * vec;
    const int pos = pos0 + col;
    const int lp = pos / page_size;
    uint4 kraw = make_uint4(0, 0, 0, 0);
    uint4 vraw = make_uint4(0, 0, 0, 0);
    if (lp < pages_live) {
      const size_t src = ((size_t)pt_row[lp] * head_dim + d) * page_size +
                         (pos - lp * page_size);
      if (planes & 1) kraw = load_bytes(k_head + src, vec * (int)sizeof(C));
      if (planes & 2) vraw = load_bytes(v_head + src, vec * (int)sizeof(C));
    }
    const C* ke = reinterpret_cast<const C*>(&kraw);
    const C* ve = reinterpret_cast<const C*>(&vraw);
    float* kd = ks + d * (span + 1) + col;
    float* vd = vs + d * (span + 1) + col;
#pragma unroll
    for (int x = 0; x < kVec; ++x) {
      if (x < vec) {
        if (planes & 1) kd[x] = to_f32(ke[x]);
        if (planes & 2) vd[x] = to_f32(ve[x]);
      }
    }
  }
}

// Stage the W tokens [pos0, pos0 + W) of a row's K and V (pos0 a
// multiple of W; W = walk_span(D)) into shared memory as f32 [D][W + 1]
// tiles: token pos0 + t fills column t, head dims d < rows from the
// cache (rows of head_dim elements a page: a slab's pointers start at
// its first head dim) and rows d >= rows as zeros. With whole pages
// (whole_page_staging), the span's part of page j fills columns
// [j * tp, (j + 1) * tp), tp = min(page_size, W) tokens from slot
// pos0 % page_size, with 16-byte loads (8 bf16 or f16, 4 f32 or 16
// int8 tokens of one head dim); any other page takes stage_chunk_any.
// PLANES names the planes staged (kPlaneK, kPlaneV or both); SLAB: the
// slab walk's call (rows may be fewer than head_dim), where the tile
// instances call the general staging's entry they always have.
template <typename C, int D, int NT, int W, int PLANES = 3, bool SLAB = false>
__device__ __forceinline__ void stage_chunk(
    const C* __restrict__ k_head, const C* __restrict__ v_head,
    const int* __restrict__ pt_row, int pos0, int pages_live,
    int page_size, int head_dim, int rows, float* __restrict__ ks,
    float* __restrict__ vs) {
  if (!whole_page_staging<C>(page_size)) {
    if constexpr (!SLAB)
      stage_chunk_any<C>(k_head, v_head, pt_row, pos0, W, pages_live,
                         page_size, head_dim, NT, ks, vs);
    else
      stage_chunk_any_rows<C>(k_head, v_head, pt_row, pos0, W, pages_live,
                              page_size, head_dim, rows, PLANES, NT, ks, vs);
    return;
  }
  constexpr int kVec = 16 / sizeof(C);
  constexpr bool kWhole = W == kChunk;  // whole pages of the chunk
  const int tp = kWhole ? page_size : min(page_size, W);
  const int lo = kWhole ? 0 : pos0 % page_size;
  const int first_page = pos0 / page_size;
  const int span_elems = D * tp;  // of one page in the span, tile rows
  for (int i = threadIdx.x; i < D * W / kVec; i += NT) {
    const int e = i * kVec;
    const int j = e / span_elems;
    const int rem = e - j * span_elems;
    const int d = rem / tp;
    const int col = rem - d * tp;
    const int lp = first_page + j;
    uint4 kraw = make_uint4(0, 0, 0, 0);
    uint4 vraw = make_uint4(0, 0, 0, 0);
    if (lp < pages_live && d < (SLAB ? rows : head_dim)) {
      const size_t src =
          ((size_t)pt_row[lp] * head_dim + d) * page_size + lo + col;
      if constexpr ((PLANES & 1) != 0)
        kraw = *reinterpret_cast<const uint4*>(k_head + src);
      if constexpr ((PLANES & 2) != 0)
        vraw = *reinterpret_cast<const uint4*>(v_head + src);
    }
    const C* ke = reinterpret_cast<const C*>(&kraw);
    const C* ve = reinterpret_cast<const C*>(&vraw);
    float* kd = ks + d * (W + 1) + j * tp + col;
    float* vd = vs + d * (W + 1) + j * tp + col;
#pragma unroll
    for (int x = 0; x < kVec; ++x) {
      if constexpr ((PLANES & 1) != 0) kd[x] = to_f32(ke[x]);
      if constexpr ((PLANES & 2) != 0) vd[x] = to_f32(ve[x]);
    }
  }
}

// Stage the span's W K and V scales of a quantized cache: token pos0 + t
// reads slot (pos0 + t) % page_size of its page's scale row, whatever
// the page size; tokens of pages past the live ones stage as zeros
// (their scores are masked).
template <int NT, int W>
__device__ __forceinline__ void stage_scales(
    const float* __restrict__ k_scale_head,
    const float* __restrict__ v_scale_head,
    const int* __restrict__ pt_row, int pos0, int pages_live,
    int page_size, float* __restrict__ kss, float* __restrict__ vss) {
  for (int i = threadIdx.x; i < W; i += NT) {
    const int pos = pos0 + i;
    const int lp = pos / page_size;
    float kx = 0.f, vx = 0.f;
    if (lp < pages_live) {
      const size_t src =
          (size_t)pt_row[lp] * page_size + (pos - lp * page_size);
      kx = k_scale_head[src];
      vx = v_scale_head[src];
    }
    kss[i] = kx;
    vss[i] = vx;
  }
}

// Zero words [first, last) of shared memory with NT threads: the pad
// rows d >= head_dim of a staged plane, once a block.
template <typename Word, int NT>
__device__ __forceinline__ void zero_words(Word* __restrict__ base,
                                           int first, int last) {
  for (int i = first + threadIdx.x; i < last; i += NT) {
    if constexpr (std::is_same<Word, uint4>::value)
      base[i] = make_uint4(0, 0, 0, 0);
    else
      base[i] = Word(0);
  }
}

// ---- asynchronous staging (cp.async) ---------------------------------------
//
// The redesigned kernels (paged_walk_mma.cuh, paged_decode.cu) stage a
// chunk as it lies in device memory, in the cache's own element type,
// with cp.async copies that land in shared memory while the block
// computes on the chunk before: 16 bytes a copy with whole pages
// (whole_page_staging), copy_elems tokens a copy at any other page. A
// copy with `live` false reads nothing and writes zeros: pages past the
// live ones stage as zeros, as stage_chunk stages them.

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool live) {
  const int n = live ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Copy `bytes` (1, 2, 4, 8 or 16, aligned at both ends) from device to
// shared memory, or zeros where `live` is false. cp.async takes 4, 8 and
// 16 bytes; 2 and 1 (an odd page, or an int8 page of 2 mod 4 tokens)
// are a load and a store, done when the barrier after the wait passes.
__device__ __forceinline__ void cp_async_bytes(uint32_t dst, const void* src,
                                               int bytes, bool live) {
  const int n = live ? bytes : 0;
  switch (bytes) {
    case 16:
      cp_async16(dst, src, live);
      break;
    case 8:
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
                   "l"(src), "r"(n)
                   : "memory");
      break;
    case 4:
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
                   "l"(src), "r"(n)
                   : "memory");
      break;
    case 2: {
      const unsigned short x =
          live ? *reinterpret_cast<const unsigned short*>(src) : 0;
      asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(dst), "h"(x) : "memory");
      break;
    }
    default: {
      const unsigned short x =
          live ? *reinterpret_cast<const unsigned char*>(src) : 0;
      asm volatile("st.shared.u8 [%0], %1;\n" ::"r"(dst), "h"(x) : "memory");
    }
  }
}

// Wait until at most N of this thread's committed groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// log2 of a power of two (with whole pages the page size is one: the
// staging loops shift where the general staging divides; head dims need
// not be powers of two, 80 is one, and are divided by as compile-time
// constants).
__device__ __forceinline__ int log2_pow2(int x) { return __ffs(x) - 1; }

// Where head dim d, chunk token col lands in a destination plane of
// staged K or V, in bytes: rows of `row_bytes` a head dim (padded for
// ldmatrix in the tensor-core walk), the row offset XORed by the head
// dim where `swizzle` (the decode kernel's reads: each quarter of a
// warp on its own banks). Either keeps an aligned run of up to 16 bytes
// contiguous.
struct PlaneLayout {
  int row_bytes;
  bool swizzle;
  __device__ __forceinline__ uint32_t offset(int d, int col,
                                             int esz) const {
    const uint32_t swz =
        swizzle ? ((uint32_t)(d & 3) * 32u * (uint32_t)esz) & 127u : 0u;
    return (uint32_t)d * (uint32_t)row_bytes +
           (((uint32_t)col * (uint32_t)esz) ^ swz);
  }
};

// The general staging of stage_chunk_async (a page whole_page_staging
// does not take): copy_elems tokens of one head dim a copy, each token's
// page and slot by division. Not inlined and untemplated (head dim,
// span, element size, thread count and the planes to copy, K's bit 1
// and V's bit 2, at run time): one body serves every kernel instance,
// so the instances keep their registers and the build its time.
static __device__ __noinline__ void stage_chunk_async_any(
    const unsigned char* __restrict__ k_head,
    const unsigned char* __restrict__ v_head,
    const int* __restrict__ pt_row, int pos0, int span, int pages_live,
    int page_size, int head_dim, int esz, int nthreads, int planes,
    uint32_t k_dst, uint32_t v_dst, PlaneLayout layout) {
  const int vec = copy_elems(page_size, esz);
  const int bytes = vec * esz;
  const int row_shift = __ffs(span / vec) - 1;  // log2 copies a row
  for (int i = threadIdx.x; i < head_dim << row_shift; i += nthreads) {
    const int d = i >> row_shift;
    const int col = (i - (d << row_shift)) * vec;
    const int pos = pos0 + col;
    const int lp = pos / page_size;
    const bool live = lp < pages_live;
    const size_t src =
        live ? (((size_t)pt_row[lp] * head_dim + d) * page_size +
                (pos - lp * page_size)) * esz
             : (size_t)0;
    const uint32_t o = layout.offset(d, col, esz);
    if (planes & 1) cp_async_bytes(k_dst + o, k_head + src, bytes, live);
    if (planes & 2) cp_async_bytes(v_dst + o, v_head + src, bytes, live);
  }
}

// The general staging of a slab walk (stage_chunk_async with SLAB):
// stage_chunk_async_any's copies, rows d < rows only (the last slab's
// live head dims), its own body so that the tile instances' call and
// callee stay as they were.
static __device__ __noinline__ void stage_chunk_async_any_rows(
    const unsigned char* __restrict__ k_head,
    const unsigned char* __restrict__ v_head,
    const int* __restrict__ pt_row, int pos0, int span, int pages_live,
    int page_size, int head_dim, int rows, int esz, int nthreads,
    int planes, uint32_t k_dst, uint32_t v_dst, PlaneLayout layout) {
  const int vec = copy_elems(page_size, esz);
  const int bytes = vec * esz;
  const int row_shift = __ffs(span / vec) - 1;  // log2 copies a row
  for (int i = threadIdx.x; i < rows << row_shift; i += nthreads) {
    const int d = i >> row_shift;
    const int col = (i - (d << row_shift)) * vec;
    const int pos = pos0 + col;
    const int lp = pos / page_size;
    const bool live = lp < pages_live;
    const size_t src =
        live ? (((size_t)pt_row[lp] * head_dim + d) * page_size +
                (pos - lp * page_size)) * esz
             : (size_t)0;
    const uint32_t o = layout.offset(d, col, esz);
    if (planes & 1) cp_async_bytes(k_dst + o, k_head + src, bytes, live);
    if (planes & 2) cp_async_bytes(v_dst + o, v_head + src, bytes, live);
  }
}

// The planes stage_chunk_async copies: K and V, or one of them (the
// decode kernel's f32 cache at tile 256 stages K, then V, through one
// plane).
constexpr int kPlaneK = 1;
constexpr int kPlaneV = 2;
constexpr int kPlanesKV = kPlaneK | kPlaneV;

// Start the copies of the W tokens [pos0, pos0 + W) of a row's K and V
// (pos0 a multiple of W) into planes of D rows laid out as `layout`
// says: head dims d < rows from the cache (its pages rows of head_dim
// elements: a slab's pointers start at the slab's first head dim),
// rows d >= rows as zeros, each row's tokens in order. The caller
// commits the group. Whole pages (whole_page_staging) copy 16 bytes a
// copy, page by page (tp = min(page_size, W) tokens of each from slot
// pos0 % page_size), over the tile's D rows so that the loop's trip
// count is a constant; any other page takes stage_chunk_async_any,
// which leaves rows d >= rows as they were. SLAB: the slab walks' call
// (rows may be fewer than head_dim); the tile instances pass rows =
// head_dim to the general staging's entry they have always called.
template <typename C, int D, int NT, int W = kChunk,
          int PLANES = kPlanesKV, bool SLAB = false>
__device__ __forceinline__ void stage_chunk_async(
    const C* __restrict__ k_head, const C* __restrict__ v_head,
    const int* __restrict__ pt_row, int pos0, int pages_live,
    int page_size, int head_dim, int rows, uint32_t k_dst, uint32_t v_dst,
    PlaneLayout layout) {
  if (!whole_page_staging<C>(page_size)) {
    if constexpr (SLAB)
      stage_chunk_async_any_rows(
          reinterpret_cast<const unsigned char*>(k_head),
          reinterpret_cast<const unsigned char*>(v_head), pt_row, pos0, W,
          pages_live, page_size, head_dim, rows, (int)sizeof(C), NT, PLANES,
          k_dst, v_dst, layout);
    else
      stage_chunk_async_any(reinterpret_cast<const unsigned char*>(k_head),
                            reinterpret_cast<const unsigned char*>(v_head),
                            pt_row, pos0, W, pages_live, page_size,
                            head_dim, (int)sizeof(C), NT, PLANES, k_dst,
                            v_dst, layout);
    return;
  }
  constexpr int kVec = 16 / sizeof(C);
  constexpr bool kWhole = W == kChunk;  // whole pages of the chunk
  const int ps_shift = log2_pow2(page_size);
  const int tp_shift = kWhole ? ps_shift : min(ps_shift, log2_pow2(W));
  const int lo = kWhole ? 0 : pos0 & (page_size - 1);
  const int first_page = pos0 >> ps_shift;
  for (int i = threadIdx.x; i < D * W / kVec; i += NT) {
    const int e = i * kVec;
    // e = (j * D + d) * tp + col: page j of the span, head dim d of the
    // tile, token col of the page's part.
    const int jd = e >> tp_shift;
    const int j = jd / D;
    const int d = jd - j * D;
    const int col = e & ((1 << tp_shift) - 1);
    const int lp = first_page + j;
    const bool live = lp < pages_live && d < (SLAB ? rows : head_dim);
    const size_t src =
        live ? ((((size_t)pt_row[lp] * head_dim + d) << ps_shift) + lo +
                col)
             : (size_t)0;
    const uint32_t o = layout.offset(d, (j << tp_shift) + col, sizeof(C));
    if constexpr ((PLANES & kPlaneK) != 0)
      cp_async16(k_dst + o, k_head + src, live);
    if constexpr ((PLANES & kPlaneV) != 0)
      cp_async16(v_dst + o, v_head + src, live);
  }
}

// The general staging of stage_scales_async: copy_elems scales a copy
// (at most 4), each token's page and slot by division; not inlined, as
// stage_chunk_async_any.
static __device__ __noinline__ void stage_scales_async_any(
    const float* __restrict__ k_scale_head,
    const float* __restrict__ v_scale_head,
    const int* __restrict__ pt_row, int pos0, int span, int pages_live,
    int page_size, int nthreads, uint32_t ks_dst, uint32_t vs_dst) {
  const int vec = copy_elems(page_size, 4);
  for (int i = threadIdx.x; i < span / vec; i += nthreads) {
    const int tok = i * vec;
    const int pos = pos0 + tok;
    const int lp = pos / page_size;
    const bool live = lp < pages_live;
    const size_t src =
        live ? (size_t)pt_row[lp] * page_size + (pos - lp * page_size)
             : (size_t)0;
    cp_async_bytes(ks_dst + tok * 4, k_scale_head + src, vec * 4, live);
    cp_async_bytes(vs_dst + tok * 4, v_scale_head + src, vec * 4, live);
  }
}

// Start the copies of the span's W K and V scales of a quantized cache:
// 4 scales a copy where the page is a power of two from 4 to 128
// (shifted), else stage_scales_async_any.
template <int NT, int W = kChunk>
__device__ __forceinline__ void stage_scales_async(
    const float* __restrict__ k_scale_head,
    const float* __restrict__ v_scale_head,
    const int* __restrict__ pt_row, int pos0, int pages_live,
    int page_size, uint32_t ks_dst, uint32_t vs_dst) {
  if (!whole_page_staging<float>(page_size)) {
    stage_scales_async_any(k_scale_head, v_scale_head, pt_row, pos0, W,
                           pages_live, page_size, NT, ks_dst, vs_dst);
    return;
  }
  const int ps_shift = log2_pow2(page_size);
  for (int i = threadIdx.x; i < W / 4; i += NT) {
    const int tok = i * 4;
    const int pos = pos0 + tok;
    const int lp = pos >> ps_shift;
    const int col = pos & (page_size - 1);
    const bool live = lp < pages_live;
    const size_t src =
        live ? ((size_t)pt_row[lp] << ps_shift) + col : (size_t)0;
    cp_async16(ks_dst + tok * 4, k_scale_head + src, live);
    cp_async16(vs_dst + tok * 4, v_scale_head + src, live);
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// The walk for one block. Threads form a TY x TX grid: thread (ty, tx)
// computes scores of rows ty*RM .. ty*RM+RM-1 at tokens tx + TX*j, and
// owns the outputs of the same rows at head dims tx + TX*j. It steps
// walk_span(D) tokens at a time (a chunk; half of one at tile 256).
//
//   q, out:      the layer's [B, T, num_q_heads, head_dim] query/output
//   k/v_head:    this kv head's [num_pages, head_dim, page_size] pages
//   k/v_scale_head: this kv head's [num_pages, page_size] scales (int8
//                cache only; null otherwise)
//   pt_row:      this row's page-table entries (max_pages of them)
//   nrows:       valid rows of the block (<= ROWS); the rest are pad
//   hd:          the real head dim, at most D: rows d >= hd of q, K
//                and V are zero in shared memory
//   SLAB:        the slab walk (D = kSlabDim, hd above kMaxHeadDim):
//                `slabs` slabs, the block's output and V are slab
//                `slab`'s; each span stages q and K a slab at a time
//                into the same planes and sums the scores over them
template <typename T, typename C, int D, int ROWS, int TY, int NT,
          bool SLAB = false, class Mask, class Rows>
__device__ void page_walk_block(const T* __restrict__ q,
                                T* __restrict__ out, Rows rows,
                                const C* __restrict__ k_head,
                                const C* __restrict__ v_head,
                                const float* __restrict__ k_scale_head,
                                const float* __restrict__ v_scale_head,
                                const int* __restrict__ pt_row,
                                int max_pages, int page_size, int kv_len,
                                Mask mask, int nrows, int hd,
                                int slabs = 1, int slab = 0) {
  static_assert(!SLAB || D == kSlabDim, "the slab walk is the tile 128's");
  constexpr bool QUANT = kQuantized<C>;
  constexpr int W = walk_span(D);
  constexpr int TX = NT / TY;
  constexpr int RM = ROWS / TY;
  constexpr int TN = W / TX;
  // Head dims a thread owns: tx + TX * j < D (the last j is cut where
  // TX does not divide D, as at 80 over 32 columns).
  constexpr int DN = (D + TX - 1) / TX;
  static_assert(ROWS % TY == 0 && W % TX == 0,
                "thread layout must tile the rows and the span");
  using L = SmemLayout<D, ROWS, QUANT>;
  constexpr int QS = L::kQStride;
  constexpr int S = L::kSStride;
  extern __shared__ float smem[];
  float* qs = smem + L::q;
  float* ks = smem + L::k;
  float* vs = smem + L::v;
  float* ss = smem + L::s;
  float* ms = smem + L::m;
  float* ls = smem + L::l;
  float* as = smem + L::alpha;
  float* kss = smem + L::ks;  // QUANT only
  float* vss = smem + L::vs;

  const int tid = threadIdx.x;
  const int ty = tid / TX;
  const int tx = tid - ty * TX;
  const int warp = tid / 32;
  const int lane = tid & 31;
  const float scale = rsqrtf((float)hd);
  // The slab this block writes (head dims [own0, own0 + own_rows)); q
  // and K are staged a slab at a time below.
  const int own0 = SLAB ? slab * D : 0;
  const int own_rows = SLAB ? slab_rows(hd, slab) : hd;

  // q of slab j (all of q without slabs): rows d >= the slab's live
  // head dims are zero.
  auto stage_q = [&](int j, int live) {
    for (int i = tid; i < ROWS * D; i += NT) {
      const int r = i / D;
      const int d = i - r * D;
      qs[r * QS + d] = r < nrows && d < live
                           ? to_f32(q[rows.offset(r) + j * D + d])
                           : 0.f;
    }
  };
  if constexpr (!SLAB) {
    stage_q(0, hd);
    zero_words<float, NT>(ks, hd * S, D * S);
  }
  zero_words<float, NT>(vs, own_rows * S, D * S);
  for (int r = tid; r < ROWS; r += NT) {
    ms[r] = kNegInf;
    ls[r] = 0.f;
  }
  int lim[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) lim[i] = mask.limit(ty * RM + i);
  float acc[RM][DN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < DN; ++j) acc[i][j] = 0.f;

  const int pages_live = min((kv_len + page_size - 1) / page_size, max_pages);
  const int n_spans = (mask.max_limit(nrows) + W - 1) / W;

  for (int c = 0; c < n_spans; ++c) {
    // Scores: [RM] x [TN] register tile, contracted over the real head
    // dims, a slab at a time with slabs (q and K of slab j staged into
    // the q and K planes; V of the block's own slab with slab 0).
    float sacc[RM][TN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) sacc[i][j] = 0.f;
    for (int sj = 0; sj < (SLAB ? slabs : 1); ++sj) {
      __syncthreads();  // the previous span's (slab's) readers are done
      const int live = SLAB ? slab_rows(hd, sj) : hd;
      if constexpr (SLAB) {
        stage_q(sj, live);
        stage_chunk<C, D, NT, W, 1, true>(k_head + (size_t)sj * D * page_size,
                                    v_head, pt_row, c * W, pages_live,
                                    page_size, hd, live, ks, vs);
        if (sj == 0)
          stage_chunk<C, D, NT, W, 2, true>(
              k_head, v_head + (size_t)own0 * page_size, pt_row, c * W,
              pages_live, page_size, hd, own_rows, ks, vs);
      } else {
        stage_chunk<C, D, NT, W>(k_head, v_head, pt_row, c * W, pages_live,
                                 page_size, hd, hd, ks, vs);
      }
      if constexpr (QUANT)
        if (sj == 0)
          stage_scales<NT, W>(k_scale_head, v_scale_head, pt_row, c * W,
                              pages_live, page_size, kss, vss);
      __syncthreads();

      for (int d = 0; d < live; ++d) {
        float qv[RM], kv[TN];
#pragma unroll
        for (int i = 0; i < RM; ++i) qv[i] = qs[(ty * RM + i) * QS + d];
#pragma unroll
        for (int j = 0; j < TN; ++j) kv[j] = ks[d * S + tx + TX * j];
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            sacc[i][j] = fmaf(qv[i], kv[j], sacc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int tok = tx + TX * j;
        const int pos = c * W + tok;
        float sc = sacc[i][j] * scale;
        if constexpr (QUANT) sc *= kss[tok];  // fold the K scales
        ss[(ty * RM + i) * S + tok] = pos < lim[i] ? sc : kNegInf;
      }
    __syncthreads();

    // Online softmax, one warp per row.
    for (int r = warp; r < ROWS; r += NT / 32) {
      float* row = ss + r * S;
      float mx = kNegInf;
#pragma unroll
      for (int x = lane; x < W; x += 32) mx = fmaxf(mx, row[x]);
      mx = warp_max(mx);
      const float m_old = ms[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int x = lane; x < W; x += 32) {
        const float p = expf(row[x] - m_new);
        // l sums p; p . v takes p * v_scale (the V scales' fold).
        if constexpr (QUANT)
          row[x] = p * vss[x];
        else
          row[x] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        as[r] = alpha;
        ls[r] = ls[r] * alpha + sum;
        ms[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p . v
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const float alpha = as[ty * RM + i];
#pragma unroll
      for (int j = 0; j < DN; ++j) acc[i][j] *= alpha;
    }
    for (int t = 0; t < W; ++t) {
      float pv[RM], vv[DN];
#pragma unroll
      for (int i = 0; i < RM; ++i) pv[i] = ss[(ty * RM + i) * S + t];
#pragma unroll
      for (int j = 0; j < DN; ++j)
        vv[j] = (D % TX == 0 || tx + TX * j < D)
                    ? vs[(tx + TX * j) * S + t]
                    : 0.f;
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < DN; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = ty * RM + i;
    if (r >= nrows) continue;
    const float denom = fmaxf(ls[r], 1e-30f);
    T* dst = out + rows.offset(r) + own0;
#pragma unroll
    for (int j = 0; j < DN; ++j)
      if (tx + TX * j < own_rows)
        dst[tx + TX * j] = from_f32<T>(acc[i][j] / denom);
  }
}

}  // namespace pstt
