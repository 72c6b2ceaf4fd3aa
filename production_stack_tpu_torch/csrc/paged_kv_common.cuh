// What the paged decode, chunked-prefill and ragged attention kernels
// share (paged_decode.cu, paged_prefill.cu, paged_ragged.cu): the
// geometries they are built for, the layer offsets, row maps and masks,
// the asynchronous staging of a chunk (cp.async), and page_walk_block,
// the f32 FMA page walk. The f32 prefill and ragged geometries run
// page_walk_block; the bf16 prefill and ragged geometries run the
// tensor-core walk of paged_walk_mma.cuh, decode its own split walk
// (paged_decode.cu). The contract below is the same for all of them.
//
// Counterpart of make_page_dma / run_page_walk in the JAX package's
// ops/paged_kv_common.py. One block owns one (row, kv head) pair and a
// block of ROWS query rows of that kv head. For each 128-token chunk
// of the row's pages (128 / page_size whole pages) it
//   - stages the chunk's K and V pages ([head_dim, page_size] each,
//     token-minor) from device memory into shared memory with 16-byte
//     coalesced loads, converting to f32; pages past
//     ceil(kv_len / page_size) are not read and stage as zeros;
//   - computes q.k^T / sqrt(head_dim) in f32 and sets scores outside
//     the mask to -1e30;
//   - runs the online softmax (m, l, acc in f32) and accumulates p.v.
// It stops at the last chunk any of its rows can see and writes
// acc / max(l, 1e-30): exact 0 for a row with kv_len 0.
//
// The cache's element type C is a template parameter apart from the
// query/output type T. With C = int8_t the cache is quantized: int8
// pages (16 tokens a 16-byte load) plus one f32 scale per (kv head,
// page, slot), [kv_heads, num_pages, page_size]. The chunk's 128 K and
// V scales are staged beside its pages (zeros past the live pages)
// and folded in as the Pallas kernels fold them: the scores are
// (q . k_int8) / sqrt(D) * k_scale[token], l sums the unscaled
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

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace pstt {

constexpr int kChunk = 128;           // tokens per walk step
constexpr int kStride = kChunk + 1;   // smem row stride of K, V, scores
constexpr float kNegInf = -1e30f;

// The one list of what the kernels are built for: X(dtype code, query
// and output type, cache dtype code, cache element type, query group =
// q heads per kv head, head dim), one entry per model config and KV
// cache dtype the engine serves. Codes: 0 bf16, 1 f32, 2 int8 (the
// host's _DTYPE_CODES / _CACHE_CODES). All three kernels dispatch
// through it, and pstt_kernel_supports() (paged_decode.cu) answers the
// host from it.
// Add a line when a config needs another geometry.
#define PSTT_FOR_EACH_GEOMETRY(X)                                  \
  X(0, __nv_bfloat16, 0, __nv_bfloat16, 4, 64) /* bench-1b */      \
  X(0, __nv_bfloat16, 2, int8_t, 4, 64)  /* bench-1b, int8 KV */   \
  X(1, float, 1, float, 2, 32)           /* tiny-llama */          \
  X(1, float, 2, int8_t, 2, 32)          /* tiny-llama, int8 KV */

template <typename C>
constexpr bool kQuantized = std::is_same<C, int8_t>::value;

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
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

// Shared memory of one block, in floats. A quantized cache (QUANT)
// adds the chunk's K and V scales.
template <int D, int ROWS, bool QUANT = false>
struct SmemLayout {
  static constexpr int kQStride = D + 1;
  static constexpr int kScales = QUANT ? kChunk : 0;
  static constexpr int q = 0;                          // [ROWS][D + 1]
  static constexpr int k = q + ROWS * kQStride;        // [D][kStride]
  static constexpr int v = k + D * kStride;            // [D][kStride]
  static constexpr int s = v + D * kStride;            // [ROWS][kStride]
  static constexpr int m = s + ROWS * kStride;         // [ROWS]
  static constexpr int l = m + ROWS;                   // [ROWS]
  static constexpr int alpha = l + ROWS;               // [ROWS]
  static constexpr int ks = alpha + ROWS;              // [kScales]
  static constexpr int vs = ks + kScales;              // [kScales]
  static constexpr int total = vs + kScales;
  static constexpr size_t bytes = total * sizeof(float);
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

// Stage one 128-token chunk of K and V pages into shared memory as
// f32 [D][kStride] tiles. Page j of the chunk fills columns
// [j * page_size, (j + 1) * page_size). A 16-byte load holds 8 bf16,
// 4 f32 or 16 int8 tokens of one head dim, so the page size must hold
// a multiple of 16 bytes (the host checks it).
template <typename C, int D, int NT>
__device__ __forceinline__ void stage_chunk(
    const C* __restrict__ k_head, const C* __restrict__ v_head,
    const int* __restrict__ pt_row, int chunk, int pages_live,
    int page_size, float* __restrict__ ks, float* __restrict__ vs) {
  constexpr int kVec = 16 / sizeof(C);
  const int pages_per_chunk = kChunk / page_size;
  const int page_elems = D * page_size;
  for (int i = threadIdx.x; i < D * kChunk / kVec; i += NT) {
    const int e = i * kVec;
    const int j = e / page_elems;
    const int rem = e - j * page_elems;
    const int d = rem / page_size;
    const int col = rem - d * page_size;
    const int lp = chunk * pages_per_chunk + j;
    uint4 kraw = make_uint4(0, 0, 0, 0);
    uint4 vraw = make_uint4(0, 0, 0, 0);
    if (lp < pages_live) {
      const size_t src = (size_t)pt_row[lp] * page_elems + rem;
      kraw = *reinterpret_cast<const uint4*>(k_head + src);
      vraw = *reinterpret_cast<const uint4*>(v_head + src);
    }
    const C* ke = reinterpret_cast<const C*>(&kraw);
    const C* ve = reinterpret_cast<const C*>(&vraw);
    float* kd = ks + d * kStride + j * page_size + col;
    float* vd = vs + d * kStride + j * page_size + col;
#pragma unroll
    for (int x = 0; x < kVec; ++x) {
      kd[x] = to_f32(ke[x]);
      vd[x] = to_f32(ve[x]);
    }
  }
}

// Stage the chunk's 128 K and V scales of a quantized cache: token
// col of page j of the chunk reads slot col of that page's scale row;
// pages past the live ones stage as zeros (their scores are masked).
template <int NT>
__device__ __forceinline__ void stage_scales(
    const float* __restrict__ k_scale_head,
    const float* __restrict__ v_scale_head,
    const int* __restrict__ pt_row, int chunk, int pages_live,
    int page_size, float* __restrict__ kss, float* __restrict__ vss) {
  const int pages_per_chunk = kChunk / page_size;
  for (int i = threadIdx.x; i < kChunk; i += NT) {
    const int j = i / page_size;
    const int col = i - j * page_size;
    const int lp = chunk * pages_per_chunk + j;
    float kx = 0.f, vx = 0.f;
    if (lp < pages_live) {
      const size_t src = (size_t)pt_row[lp] * page_size + col;
      kx = k_scale_head[src];
      vx = v_scale_head[src];
    }
    kss[i] = kx;
    vss[i] = vx;
  }
}

// ---- asynchronous staging (cp.async) ---------------------------------------
//
// The redesigned kernels (paged_walk_mma.cuh, paged_decode.cu) stage a
// chunk as it lies in device memory, in the cache's own element type,
// with 16-byte cp.async copies that land in shared memory while the
// block computes on the chunk before. A copy with `live` false reads
// nothing and writes 16 zero bytes: pages past the live ones stage as
// zeros, as stage_chunk stages them.

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

// Wait until at most N of this thread's committed groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// log2 of a power of two (page sizes divide 128, head dims are 32 or
// 64: the staging loops shift where stage_chunk divides).
__device__ __forceinline__ int log2_pow2(int x) { return __ffs(x) - 1; }

// Start the copies of one 128-token chunk of K and V pages. `off(d,
// col)` is the byte offset of head dim d, chunk token col inside a
// destination plane (the caller's layout: padded rows for ldmatrix, a
// swizzle for the decode kernel's reads). The caller commits the group.
template <typename C, int D, int NT, class Off>
__device__ __forceinline__ void stage_chunk_async(
    const C* __restrict__ k_head, const C* __restrict__ v_head,
    const int* __restrict__ pt_row, int chunk, int pages_live,
    int page_size, uint32_t k_dst, uint32_t v_dst, Off off) {
  constexpr int kVec = 16 / sizeof(C);
  const int ps_shift = log2_pow2(page_size);
  const int page_shift = ps_shift + log2_pow2(D);  // D * page_size elems
  const int first_page = chunk << (log2_pow2(kChunk) - ps_shift);
  for (int i = threadIdx.x; i < D * kChunk / kVec; i += NT) {
    const int e = i * kVec;
    const int j = e >> page_shift;
    const int rem = e - (j << page_shift);
    const int d = rem >> ps_shift;
    const int col = rem - (d << ps_shift);
    const int lp = first_page + j;
    const bool live = lp < pages_live;
    const size_t src =
        live ? ((size_t)pt_row[lp] << page_shift) + rem : (size_t)0;
    const uint32_t o = off(d, (j << ps_shift) + col);
    cp_async16(k_dst + o, k_head + src, live);
    cp_async16(v_dst + o, v_head + src, live);
  }
}

// Start the copies of the chunk's 128 K and V scales of a quantized
// cache (4 scales a copy; an int8 page holds a multiple of 16 tokens).
template <int NT>
__device__ __forceinline__ void stage_scales_async(
    const float* __restrict__ k_scale_head,
    const float* __restrict__ v_scale_head,
    const int* __restrict__ pt_row, int chunk, int pages_live,
    int page_size, uint32_t ks_dst, uint32_t vs_dst) {
  const int ps_shift = log2_pow2(page_size);
  const int first_page = chunk << (log2_pow2(kChunk) - ps_shift);
  for (int i = threadIdx.x; i < kChunk / 4; i += NT) {
    const int tok = i * 4;
    const int j = tok >> ps_shift;
    const int col = tok - (j << ps_shift);
    const int lp = first_page + j;
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
// owns the outputs of the same rows at head dims tx + TX*j.
//
//   q, out:      the layer's [B, T, num_q_heads, D] query/output
//   k/v_head:    this kv head's [num_pages, D, page_size] pages
//   k/v_scale_head: this kv head's [num_pages, page_size] scales (int8
//                cache only; null otherwise)
//   pt_row:      this row's page-table entries (max_pages of them)
//   nrows:       valid rows of the block (<= ROWS); the rest are pad
template <typename T, typename C, int D, int ROWS, int TY, int NT,
          class Mask, class Rows>
__device__ void page_walk_block(const T* __restrict__ q,
                                T* __restrict__ out, Rows rows,
                                const C* __restrict__ k_head,
                                const C* __restrict__ v_head,
                                const float* __restrict__ k_scale_head,
                                const float* __restrict__ v_scale_head,
                                const int* __restrict__ pt_row,
                                int max_pages, int page_size, int kv_len,
                                Mask mask, int nrows) {
  constexpr bool QUANT = kQuantized<C>;
  constexpr int TX = NT / TY;
  constexpr int RM = ROWS / TY;
  constexpr int TN = kChunk / TX;
  constexpr int DN = D / TX;
  static_assert(ROWS % TY == 0 && D % TX == 0 && kChunk % TX == 0,
                "thread layout must tile the rows, head dim and chunk");
  using L = SmemLayout<D, ROWS, QUANT>;
  constexpr int QS = L::kQStride;
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
  const float scale = rsqrtf((float)D);

  for (int i = tid; i < ROWS * D; i += NT) {
    const int r = i / D;
    const int d = i - r * D;
    qs[r * QS + d] = r < nrows ? to_f32(q[rows.offset(r) + d]) : 0.f;
  }
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
  const int n_chunks = (mask.max_limit(nrows) + kChunk - 1) / kChunk;

  for (int c = 0; c < n_chunks; ++c) {
    __syncthreads();  // the previous chunk's readers are done
    stage_chunk<C, D, NT>(k_head, v_head, pt_row, c, pages_live,
                          page_size, ks, vs);
    if constexpr (QUANT)
      stage_scales<NT>(k_scale_head, v_scale_head, pt_row, c, pages_live,
                       page_size, kss, vss);
    __syncthreads();

    // Scores: [RM] x [TN] register tile, contracted over D.
    float sacc[RM][TN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) sacc[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[RM], kv[TN];
#pragma unroll
      for (int i = 0; i < RM; ++i) qv[i] = qs[(ty * RM + i) * QS + d];
#pragma unroll
      for (int j = 0; j < TN; ++j) kv[j] = ks[d * kStride + tx + TX * j];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) sacc[i][j] = fmaf(qv[i], kv[j], sacc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int tok = tx + TX * j;
        const int pos = c * kChunk + tok;
        float sc = sacc[i][j] * scale;
        if constexpr (QUANT) sc *= kss[tok];  // fold the K scales
        ss[(ty * RM + i) * kStride + tok] = pos < lim[i] ? sc : kNegInf;
      }
    __syncthreads();

    // Online softmax, one warp per row.
    for (int r = warp; r < ROWS; r += NT / 32) {
      float* row = ss + r * kStride;
      float mx = kNegInf;
#pragma unroll
      for (int x = lane; x < kChunk; x += 32) mx = fmaxf(mx, row[x]);
      mx = warp_max(mx);
      const float m_old = ms[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int x = lane; x < kChunk; x += 32) {
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
    for (int t = 0; t < kChunk; ++t) {
      float pv[RM], vv[DN];
#pragma unroll
      for (int i = 0; i < RM; ++i) pv[i] = ss[(ty * RM + i) * kStride + t];
#pragma unroll
      for (int j = 0; j < DN; ++j) vv[j] = vs[(tx + TX * j) * kStride + t];
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
    T* dst = out + rows.offset(r);
#pragma unroll
    for (int j = 0; j < DN; ++j) dst[tx + TX * j] = from_f32<T>(acc[i][j] / denom);
  }
}

}  // namespace pstt
