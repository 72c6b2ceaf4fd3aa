// The tensor-core page walk for 16-bit queries, bf16 or f16 (T), over
// a cache of the same type or int8 (paged_prefill.cu with
// CausalMask / RowMap, paged_ragged.cu with RaggedMask / SlotMajorRows:
// the mask and the row map are template parameters exactly as in
// page_walk_block).
//
// Same contract as page_walk_block (paged_kv_common.cuh): one block
// owns WARPS * 16 query rows of one (row, kv head) pair and walks the
// row's pages in 128-token chunks up to the last chunk any of its rows
// can see; a row with nothing to see writes exact 0, rows >= nrows are
// never written. What differs is how the card is used:
//
//   - q.k^T and p.v run on the tensor cores as mma.sync m16n8k16 in
//     the query's type (its bf16 or f16 form, f32 accumulation): D / 16
//     k steps of q.k^T and D / 8 n tiles of p.v (five and ten at
//     head_dim 80). Each warp owns 16 query rows and
//     keeps their q fragments in registers for the whole walk. A page
//     of one kv head is [D, page_size] token-minor, so K as it lies is
//     the B operand of q.k^T with n (the token) contiguous: ldmatrix
//     with .trans; and V as it lies is the B operand of p.v with k
//     (the token) contiguous: plain ldmatrix. Nothing is transposed.
//   - Scores never touch shared memory. The accumulator fragment of
//     q.k^T is scaled, masked and exponentiated in registers (row max
//     over the quad with two shuffles; exp2f with log2(e) / sqrt(D)
//     folded into the scale), and packed to T in place as the A
//     fragment of p.v (the m16n8 accumulator layout is the m16k16 A
//     layout). m, l and the output accumulator stay in registers; l
//     sums the unrounded probabilities. The softmax steps 64 tokens at
//     a time, which halves the score registers.
//   - K and V stage in 16 bits, never as f32: a chunk of both is 32 KB
//     at head_dim 64, in two stages filled with cp.async
//     (stage_chunk_async: any page size, a page that straddles a chunk
//     edge staged token by token, dead pages as zeros), so chunk
//     c + 1 arrives while chunk c is multiplied. Rows are padded by 16
//     bytes (272 a row): the eight 16-byte rows of an ldmatrix tile
//     then fall on eight different bank groups. 68 KB a block, three
//     blocks an SM. At head_dim 80, two stages of 85 KB, two blocks an
//     SM. At head_dim 128 every tile, and each warp's output
//     accumulators, double: one stage of 68 KB, two blocks an SM (the
//     other block's products overlap a block's copies). Wider head dims
//     take the wgmma walk (paged_walk_wgmma.cuh) or, above 512, the
//     slab walk below.
//   - Head dims pad to the tile D as in page_walk_block: the walk loads
//     q's and stores out's head dims d < head_dim only (load_pair,
//     store_pair), stages K and V rows d < head_dim, and zeroes the
//     tiles' rows d >= head_dim once a block; the products run over
//     the whole tile.
//   - An int8 cache stages its raw pages (two stages of 16 KB) and its
//     scales with the same copies; each chunk is then converted once
//     to the T tile (exact in bf16 and f16: |x| <= 127) and runs the
//     same products.
//     The scales fold in the Pallas order: score column t times
//     k_scale[t] after the product, l sums the unscaled p, p *
//     v_scale[t] before the conversion to T.
//   - The mask is applied only where it cuts: a 64-token step wholly
//     below every limit of the warp skips the compares, and 16-token
//     groups past the warp's highest limit skip their products.

#pragma once

#include "paged_kv_common.cuh"

namespace pstt {

constexpr int kMmaStep = 64;   // tokens per softmax step
constexpr int kMmaRows = 64;   // query rows of a block: four warps of 16
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory of one block, in bytes. Full precision: kStages stages
// of 16-bit K and V tiles of a span (walk_span(D) tokens, rows padded by
// 16 bytes). Quantized: one 16-bit tile pair, kStages stages of raw int8
// planes and two of the span's scales (the products read span c's
// scales while span c + 1's arrive). Up to head_dim 80, two stages of
// chunks; one at 128, where two would leave one block (four warps) an
// SM. The walk serves head-dim tiles up to 128.
template <typename C, int D>
struct MmaSmem {
  static_assert(D <= 128, "the mma.sync walk's tiles are 32 to 128");
  static constexpr bool kQuant = kQuantized<C>;
  static constexpr int kSpan = walk_span(D);
  static constexpr int kRowBytes = kSpan * 2 + 16;  // a padded tile row
  static constexpr int kStages = D <= 80 ? 2 : 1;
  static constexpr int kTile = D * kRowBytes;
  static constexpr int kTileStages = kQuant ? 1 : kStages;
  static constexpr int kRaw = kQuant ? D * kSpan : 0;
  static constexpr int kScale = kQuant ? kSpan * 4 : 0;
  static constexpr int tiles = 0;  // [kTileStages][2][kTile]
  static constexpr int raw =
      tiles + kTileStages * 2 * kTile;  // [kStages][2][kRaw]
  static constexpr int scales = raw + kStages * 2 * kRaw;  // [2][2][kSpan]
  static constexpr int bytes = scales + 2 * 2 * kScale;
  static_assert(bytes <= kMaxBlockSmem, "a walk block's shared memory");
};

// Blocks of the walk an SM holds, the minimum its __launch_bounds__
// promise: as many as the SM's 233,472 bytes of shared memory take (1
// KB of it reserved a block), at most three at head_dim 64 (68 KB a
// block: 170 registers a thread) and two above (85 KB at 80; 68 KB and
// 102 KB int8 at 128: 255 registers, where a warp's 64 f32 output
// accumulators fit).
template <typename C, int D>
constexpr int mma_blocks_per_sm() {
  constexpr int fit = 233472 / (MmaSmem<C, D>::bytes + 1024);
  constexpr int most = D <= 64 ? 3 : 2;
  return fit < 1 ? 1 : (fit > most ? most : fit);
}

// Two f32 values as one word of two T (bf16 or f16), lo in the low half.
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo,
                                                         float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  const __half2 h = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// Elements d and d + 1 (d even) of a 16-bit row as one word (d in the
// low half), zeros at d >= head_dim: one 4-byte load where head_dim is
// even (every row then starts at a multiple of 4 bytes), else (ODD) two
// 2-byte loads. The caller picks ODD once, outside its unrolled loops,
// so that the loads of a fragment set issue together.
template <bool ODD, typename T>
__device__ __forceinline__ uint32_t load_pair(const T* row, int d,
                                              int head_dim) {
  if constexpr (!ODD) {
    return d < head_dim ? *reinterpret_cast<const uint32_t*>(row + d) : 0u;
  } else {
    const uint16_t* h = reinterpret_cast<const uint16_t*>(row);
    const uint32_t lo = d < head_dim ? h[d] : 0u;
    const uint32_t hi = d + 1 < head_dim ? h[d + 1] : 0u;
    return lo | (hi << 16);
  }
}

// Store the word of load_pair: head dims d >= head_dim are not written.
template <bool ODD, typename T>
__device__ __forceinline__ void store_pair(T* row, int d, int head_dim,
                                           uint32_t w) {
  if constexpr (!ODD) {
    if (d < head_dim) *reinterpret_cast<uint32_t*>(row + d) = w;
  } else {
    uint16_t* h = reinterpret_cast<uint16_t*>(row);
    if (d < head_dim) h[d] = (uint16_t)(w & 0xffffu);
    if (d + 1 < head_dim) h[d + 1] = (uint16_t)(w >> 16);
  }
}

// f(std::true_type) for an odd head_dim, f(std::false_type) for an even
// one: the parity as a compile-time value of f's body.
template <class F>
__device__ __forceinline__ void by_parity(int head_dim, F f) {
  if (head_dim & 1)
    f(std::true_type());
  else
    f(std::false_type());
}

// c += a (16 x 16, row) * b (16 x 8, col), T (bf16 or f16) in, f32
// accumulate.
template <typename T>
__device__ __forceinline__ void mma16(float (&c)[4], const uint32_t (&a)[4],
                                      uint32_t b0, uint32_t b1) {
  if constexpr (std::is_same<T, __half>::value) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

// Convert an int8 cache's raw planes of a span (W tokens a row, rows of
// W bytes, at byte offsets raw_k / raw_v of shared memory) to T tiles
// (rows of RB bytes, at tile_k / tile_v): exact, |x| <= 127. PLANES
// names the pairs converted (K's bit 1, V's bit 2).
template <typename T, int D, int W, int RB, int NT, int PLANES = kPlanesKV>
__device__ __forceinline__ void convert_raw(unsigned char* smem, int raw_k,
                                            int raw_v, int tile_k,
                                            int tile_v) {
  for (int i = threadIdx.x; i < D * W / 16; i += NT) {
    const int d = i / (W / 16);
    const int col = (i - d * (W / 16)) * 16;
#pragma unroll
    for (int which = 0; which < 2; ++which) {
      if (((PLANES >> which) & 1) == 0) continue;
      const uint4 rawv = *reinterpret_cast<const uint4*>(
          smem + (which ? raw_v : raw_k) + i * 16);
      const int8_t* x = reinterpret_cast<const int8_t*>(&rawv);
      uint32_t w[8];
#pragma unroll
      for (int p = 0; p < 8; ++p)
        w[p] = pack2<T>((float)x[2 * p], (float)x[2 * p + 1]);
      uint4* dst = reinterpret_cast<uint4*>(
          smem + (which ? tile_v : tile_k) + d * RB + col * 2);
      dst[0] = make_uint4(w[0], w[1], w[2], w[3]);
      dst[1] = make_uint4(w[4], w[5], w[6], w[7]);
    }
  }
}

// The end of a walk: l summed over each quad, then this thread's two
// rows' outputs acc / max(l, 1e-30) in T at head dims [col0, col0 +
// cols) of their rows (rows >= nrows not written). by_parity picks the
// store width from hd, the row stride (col0 is even).
template <typename T, int DN, class Rows>
__device__ __forceinline__ void mma_store_rows(
    T* __restrict__ out, const Rows& rows, int r0, int r1, int nrows,
    float (&acc)[DN][4], float l0, float l1, int col0, int cols, int hd,
    int quad) {
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float den0 = fmaxf(l0, 1e-30f);
  const float den1 = fmaxf(l1, 1e-30f);
  by_parity(hd, [&](auto odd) {
    constexpr bool ODD = decltype(odd)::value;
    if (r0 < nrows) {
      T* dst = out + rows.offset(r0) + col0;
#pragma unroll
      for (int i = 0; i < DN; ++i)
        store_pair<ODD>(dst, i * 8 + quad * 2, cols,
                        pack2<T>(acc[i][0] / den0, acc[i][1] / den0));
    }
    if (r1 < nrows) {
      T* dst = out + rows.offset(r1) + col0;
#pragma unroll
      for (int i = 0; i < DN; ++i)
        store_pair<ODD>(dst, i * 8 + quad * 2, cols,
                        pack2<T>(acc[i][2] / den1, acc[i][3] / den1));
    }
  });
}

// The tail of one softmax step of a warp: its 16 rows' scores `s` over
// the 64 tokens [cbase + tok0, cbase + tok0 + 64) are scaled (the K
// scales `kss` folded in, an int8 cache), masked where the step is cut
// (below wmin no row is), run through the online softmax in registers
// (m, l, acc; l sums the unrounded p), packed to T as p . v's A
// fragments (p * v_scale first, an int8 cache) and multiplied into
// acc over the `groups` visible 16-token groups of the V tile (rows of
// RB bytes). The walk and the slab walk share it.
template <typename T, bool QUANT, int KS, int RB>
__device__ __forceinline__ void mma_softmax_pv(
    float (&s)[kMmaStep / 8][4], float (&acc)[2 * KS][4], float& m0,
    float& m1, float& l0, float& l1, int cbase, int tok0, int groups,
    int lim0, int lim1, int wmin, float scale_log2,
    const float* __restrict__ kss, const float* __restrict__ vss,
    uint32_t v_tile, int lane) {
  constexpr int STEP_TILES = kMmaStep / 8;
  constexpr int DN = 2 * KS;
  const int quad = lane & 3;
  // Scale (and fold the K scales), mask where the step is cut.
  const bool cut = cbase + tok0 + kMmaStep > wmin;
  float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
  for (int nt = 0; nt < STEP_TILES; ++nt) {
    const int tok = tok0 + nt * 8 + quad * 2;
    float f0 = scale_log2, f1 = scale_log2;
    if constexpr (QUANT) {
      const float2 k2 = *reinterpret_cast<const float2*>(kss + tok);
      f0 *= k2.x;
      f1 *= k2.y;
    }
    s[nt][0] *= f0;
    s[nt][1] *= f1;
    s[nt][2] *= f0;
    s[nt][3] *= f1;
    if (cut) {
      const int pos = cbase + tok;
      if (pos >= lim0) s[nt][0] = kNegInf;
      if (pos + 1 >= lim0) s[nt][1] = kNegInf;
      if (pos >= lim1) s[nt][2] = kNegInf;
      if (pos + 1 >= lim1) s[nt][3] = kNegInf;
    }
    mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
    mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));

  // Online softmax in registers (base 2: the scale carries log2 e).
  const float mn0 = fmaxf(m0, mx0);
  const float mn1 = fmaxf(m1, mx1);
  const float a0 = exp2f(m0 - mn0);
  const float a1 = exp2f(m1 - mn1);
  m0 = mn0;
  m1 = mn1;
  l0 *= a0;
  l1 *= a1;
#pragma unroll
  for (int i = 0; i < DN; ++i) {
    acc[i][0] *= a0;
    acc[i][1] *= a0;
    acc[i][2] *= a1;
    acc[i][3] *= a1;
  }
  // p, packed to T as the A fragments of p.v: score tiles 2 g2
  // and 2 g2 + 1 are the low and high k halves of k step g2.
  uint32_t pa[kMmaStep / 16][4];
#pragma unroll
  for (int nt = 0; nt < STEP_TILES; ++nt) {
    float p0 = exp2f(s[nt][0] - mn0);
    float p1 = exp2f(s[nt][1] - mn0);
    float p2 = exp2f(s[nt][2] - mn1);
    float p3 = exp2f(s[nt][3] - mn1);
    l0 += p0 + p1;
    l1 += p2 + p3;
    if constexpr (QUANT) {
      const float2 v2 = *reinterpret_cast<const float2*>(
          vss + tok0 + nt * 8 + quad * 2);
      p0 *= v2.x;
      p1 *= v2.y;
      p2 *= v2.x;
      p3 *= v2.y;
    }
    pa[nt >> 1][(nt & 1) * 2 + 0] = pack2<T>(p0, p1);
    pa[nt >> 1][(nt & 1) * 2 + 1] = pack2<T>(p2, p3);
  }

  // acc += p . v over the visible 16-token groups.
#pragma unroll
  for (int g2 = 0; g2 < kMmaStep / 16; ++g2) {
    if (g2 < groups) {
#pragma unroll
      for (int dp = 0; dp < KS; ++dp) {
        // Four 8 x 8 tiles of V: head dims 16 dp + {0, 8} by
        // tokens 16 g2 + {0, 8}.
        const int d = dp * 16 + (lane >> 4) * 8 + (lane & 7);
        const int tok = tok0 + g2 * 16 + ((lane >> 3) & 1) * 8;
        uint32_t b[4];
        ldmatrix_x4(b, v_tile + d * RB + tok * 2);
        mma16<T>(acc[2 * dp], pa[g2], b[0], b[1]);
        mma16<T>(acc[2 * dp + 1], pa[g2], b[2], b[3]);
      }
    }
  }
}

// The walk for one block of WARPS * 16 rows. Fragment coordinates of
// lane = 4 * grp + quad: accumulator values 0, 1 sit at row grp,
// columns 2 * quad + {0, 1} of their 16 x 8 tile, values 2, 3 at row
// grp + 8.
//
//   q, out:      the layer's query/output, in T
//   k/v_head:    this kv head's [num_pages, head_dim, page_size] pages
//   k/v_scale_head: this kv head's [num_pages, page_size] scales (int8
//                cache only; null otherwise)
//   pt_row:      this row's page-table entries (max_pages of them)
//   nrows:       valid rows of the block; the rest are pad
//   hd:          the real head dim, at most D
template <typename T, typename C, int D, int WARPS, class Mask,
          class Rows>
__device__ void page_walk_block_mma(
    const T* __restrict__ q, T* __restrict__ out,
    Rows rows, const C* __restrict__ k_head, const C* __restrict__ v_head,
    const float* __restrict__ k_scale_head,
    const float* __restrict__ v_scale_head, const int* __restrict__ pt_row,
    int max_pages, int page_size, int kv_len, Mask mask, int nrows,
    int hd) {
  constexpr bool QUANT = kQuantized<C>;
  constexpr int NT = WARPS * 32;
  constexpr int KS = D / 16;  // k steps of q.k^T, n-tile pairs of p.v
  constexpr int DN = D / 8;   // n tiles of the output
  constexpr int STEP_TILES = kMmaStep / 8;
  static_assert(D % 16 == 0, "a head-dim tile must tile the mma k step");
  static_assert(WARPS * 16 == kMmaRows, "a block is kMmaRows rows");
  using L = MmaSmem<C, D>;
  constexpr int W = L::kSpan;
  constexpr int RB = L::kRowBytes;
  extern __shared__ uint4 smem_mma[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem_mma);
  const uint32_t base = smem_u32(smem);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int grp = lane >> 2;
  const int quad = lane & 3;
  const int r0 = warp * 16 + grp;
  const int r1 = r0 + 8;

  // q: the A operand of every q.k^T product of the walk, in registers.
  uint32_t qa[KS][4];
  by_parity(hd, [&](auto odd) {
    constexpr bool ODD = decltype(odd)::value;
    const T* p0 = q + (r0 < nrows ? rows.offset(r0) : rows.offset(0));
    const T* p1 = q + (r1 < nrows ? rows.offset(r1) : rows.offset(0));
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const int d = kk * 16 + quad * 2;
      qa[kk][0] = r0 < nrows ? load_pair<ODD>(p0, d, hd) : 0u;
      qa[kk][1] = r1 < nrows ? load_pair<ODD>(p1, d, hd) : 0u;
      qa[kk][2] = r0 < nrows ? load_pair<ODD>(p0, d + 8, hd) : 0u;
      qa[kk][3] = r1 < nrows ? load_pair<ODD>(p1, d + 8, hd) : 0u;
    }
  });
  // The tiles' rows d >= head_dim: zero for the whole walk (the
  // whole-page copies write them as zeros, the general staging of other
  // pages not at all).
#pragma unroll
  for (int t = 0; t < L::kTileStages * 2; ++t)
    zero_words<uint4, NT>(
        reinterpret_cast<uint4*>(smem + L::tiles + t * L::kTile),
        hd * RB / 16, D * RB / 16);

  // Limits of this thread's two rows, and the warp's lowest and
  // highest: pad rows see nothing.
  const int lim0 = r0 < nrows ? mask.limit(r0) : 0;
  const int lim1 = r1 < nrows ? mask.limit(r1) : 0;
  int wmax = max(lim0, lim1);
  int wmin = min(lim0, lim1);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    wmax = max(wmax, __shfl_xor_sync(0xffffffffu, wmax, o));
    wmin = min(wmin, __shfl_xor_sync(0xffffffffu, wmin, o));
  }

  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  float acc[DN][4];
#pragma unroll
  for (int i = 0; i < DN; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  const float scale_log2 = rsqrtf((float)hd) * kLog2e;

  const int pages_live = min((kv_len + page_size - 1) / page_size, max_pages);
  const int n_spans = nrows > 0 ? (mask.max_limit(nrows) + W - 1) / W : 0;

  // Start the copies of span c (tokens [c W, c W + W)): K/V into stage
  // c & 1 (stage 0 with one stage), an int8 cache's scales into stage
  // c & 1.
  auto start_copies = [&](int c) {
    const int st = c & 1;
    const int sd = L::kStages == 2 ? st : 0;
    if constexpr (QUANT) {
      stage_chunk_async<C, D, NT, W>(
          k_head, v_head, pt_row, c * W, pages_live, page_size, hd, hd,
          base + L::raw + (sd * 2 + 0) * L::kRaw,
          base + L::raw + (sd * 2 + 1) * L::kRaw, PlaneLayout{W, false});
      stage_scales_async<NT, W>(k_scale_head, v_scale_head, pt_row, c * W,
                                pages_live, page_size,
                                base + L::scales + (st * 2 + 0) * L::kScale,
                                base + L::scales + (st * 2 + 1) * L::kScale);
    } else {
      stage_chunk_async<C, D, NT, W>(
          k_head, v_head, pt_row, c * W, pages_live, page_size, hd, hd,
          base + L::tiles + (sd * 2 + 0) * L::kTile,
          base + L::tiles + (sd * 2 + 1) * L::kTile, PlaneLayout{RB, false});
    }
    cp_async_commit();
  };

  if (n_spans > 0) start_copies(0);
  for (int c = 0; c < n_spans; ++c) {
    const int st = c & 1;
    const int sd = L::kStages == 2 ? st : 0;
    uint32_t k_tile, v_tile;
    if constexpr (QUANT) {
      // The raw span has landed and every warp is done with the tile:
      // convert it, start the next span's copies, then compute.
      cp_async_wait<0>();
      __syncthreads();
      convert_raw<T, D, W, RB, NT>(smem, L::raw + (sd * 2 + 0) * L::kRaw,
                                   L::raw + (sd * 2 + 1) * L::kRaw,
                                   L::tiles, L::tiles + L::kTile);
      // One raw stage: every thread's conversion reads of it come
      // first.
      if constexpr (L::kStages == 1) __syncthreads();
      if (c + 1 < n_spans) start_copies(c + 1);
      __syncthreads();
      k_tile = base + L::tiles;
      v_tile = base + L::tiles + L::kTile;
    } else {
      if constexpr (L::kStages == 2) {
        // Start span c + 1 into the stage span c - 1 left (its readers
        // passed the barrier that ended that iteration), wait for span
        // c.
        if (c + 1 < n_spans) {
          start_copies(c + 1);
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
      } else {
        // One stage: span c's copies start once the barrier that ended
        // the last iteration freed it; the SM's other block computes
        // meanwhile.
        if (c > 0) start_copies(c);
        cp_async_wait<0>();
      }
      __syncthreads();
      k_tile = base + L::tiles + (sd * 2 + 0) * L::kTile;
      v_tile = base + L::tiles + (sd * 2 + 1) * L::kTile;
    }
    const float* kss =
        reinterpret_cast<const float*>(smem + L::scales) + (st * 2) * W;
    const float* vss = kss + W;

    const int cbase = c * W;
#pragma unroll 1
    for (int step = 0; step < W / kMmaStep; ++step) {
      const int tok0 = step * kMmaStep;  // in the span
      const int visible = wmax - (cbase + tok0);
      if (visible <= 0) break;  // nothing more for this warp here
      // 16-token groups of this step any row of the warp can see.
      const int groups = min(kMmaStep / 16, (visible + 15) >> 4);

      // Scores: 16 rows x 64 tokens, contracted over D.
      float s[STEP_TILES][4];
#pragma unroll
      for (int i = 0; i < STEP_TILES; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t(&a)[4] = qa[kk];
#pragma unroll
        for (int g2 = 0; g2 < kMmaStep / 16; ++g2) {
          if (g2 < groups) {
            // Four 8 x 8 tiles of K^T: head dims 16 kk + {0, 8} by
            // tokens 16 g2 + {0, 8}; lane / 8 picks the tile.
            const int d = kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
            const int tok = tok0 + g2 * 16 + (lane >> 4) * 8;
            uint32_t b[4];
            ldmatrix_x4_trans(b, k_tile + d * RB + tok * 2);
            mma16<T>(s[2 * g2], a, b[0], b[1]);
            mma16<T>(s[2 * g2 + 1], a, b[2], b[3]);
          }
        }
      }

      mma_softmax_pv<T, QUANT, KS, RB>(s, acc, m0, m1, l0, l1, cbase, tok0,
                                       groups, lim0, lim1, wmin,
                                       scale_log2, kss, vss, v_tile, lane);
    }
    if constexpr (!QUANT) __syncthreads();  // stage st is free again
  }

  // l was summed per thread: mma_store_rows adds the quad's four parts.
  mma_store_rows<T, DN>(out, rows, r0, r1, nrows, acc, l0, l1, 0, hd, hd,
                        quad);
}

// ---- the slab walk: head dims above kMaxHeadDim ---------------------------
//
// Shared memory of one block of the slab walk (D = kSlabDim; see the
// slab design in paged_kv_common.cuh), in bytes. A span is one softmax
// step (64 tokens), walked in units: unit (span c, slab j) stages the
// K slab j of the span and q's slab j, and the last unit of a span the
// block's own V slab too. Full precision: a ring of two K tiles (the
// unit computing and the unit in flight), one V tile, a ring of two q
// tiles; 90 KB, two blocks an SM. Quantized: one K and one V tile
// (converted a unit at a time), a ring of two raw K planes, one raw V
// plane, the span's K and V scales, the q ring; 97 KB.
template <typename C>
struct MmaSlabSmem {
  static constexpr bool kQuant = kQuantized<C>;
  static constexpr int kSpan = kMmaStep;
  static constexpr int kRowBytes = kSpan * 2 + 16;  // a padded tile row
  static constexpr int kTile = kSlabDim * kRowBytes;
  static constexpr int kQRow = kSlabDim * 2 + 16;
  static constexpr int kQTile = kMmaRows * kQRow;
  static constexpr int kRaw = kQuant ? kSlabDim * kSpan : 0;
  static constexpr int kScale = kQuant ? kSpan * 4 : 0;
  static constexpr int k_tiles = 0;  // [kQuant ? 1 : 2][kTile]
  static constexpr int v_tile = k_tiles + (kQuant ? 1 : 2) * kTile;
  static constexpr int raw = v_tile + kTile;          // [3][kRaw]: K ring, V
  static constexpr int scales = raw + 3 * kRaw;       // [2][kSpan]: K, V
  static constexpr int q = scales + 2 * kScale;       // [2][kQTile]
  static constexpr int bytes = q + 2 * kQTile;
  static_assert(bytes <= kMaxBlockSmem, "a slab block's shared memory");
};

// Blocks of the slab walk an SM holds, its __launch_bounds__ promise:
// two (255 registers a thread).
template <typename C>
constexpr int mma_slab_blocks_per_sm() {
  constexpr int fit = 233472 / (MmaSlabSmem<C>::bytes + 1024);
  return fit < 2 ? 1 : 2;
}

// The walk of page_walk_block_mma for one output slab of a head_dim
// above kMaxHeadDim: the block's rows and mask as there, its output
// the head dims [slab * kSlabDim, + slab_rows) of each row. The scores
// of a span sum q . k^T over the `slabs` slabs in slab order, in f32
// registers (each unit's k steps add into the same fragment); then one
// softmax step (mma_softmax_pv, the real 1 / sqrt(hd), the K scales
// folded after the sum) and p . v with the own V slab. q's slabs stage
// with cp.async beside K where every row's slab starts at 16 bytes (hd
// a multiple of 8, q aligned), else with loads at the unit. Rows of a
// short last slab past hd are zero in its tiles (copies, or stores
// where the general staging leaves them).
template <typename T, typename C, int WARPS, class Mask, class Rows>
__device__ void page_walk_block_mma_slab(
    const T* __restrict__ q, T* __restrict__ out, Rows rows,
    const C* __restrict__ k_head, const C* __restrict__ v_head,
    const float* __restrict__ k_scale_head,
    const float* __restrict__ v_scale_head, const int* __restrict__ pt_row,
    int max_pages, int page_size, int kv_len, Mask mask, int nrows, int hd,
    int slabs, int slab) {
  constexpr bool QUANT = kQuantized<C>;
  constexpr int D = kSlabDim;
  constexpr int NT = WARPS * 32;
  constexpr int KS = D / 16;
  constexpr int DN = D / 8;
  constexpr int STEP_TILES = kMmaStep / 8;
  static_assert(WARPS * 16 == kMmaRows, "a block is kMmaRows rows");
  using L = MmaSlabSmem<C>;
  constexpr int W = L::kSpan;
  constexpr int RB = L::kRowBytes;
  constexpr int KROW = QUANT ? W : RB;  // a staged K or V row's bytes
  extern __shared__ uint4 smem_mma[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem_mma);
  const uint32_t base = smem_u32(smem);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int grp = lane >> 2;
  const int quad = lane & 3;
  const int r0 = warp * 16 + grp;
  const int r1 = r0 + 8;

  const int own0 = slab * D;
  const int own_rows = slab_rows(hd, slab);
  const C* v_own = v_head + (size_t)own0 * page_size;
  const bool q_async =
      (hd & 7) == 0 && (reinterpret_cast<uintptr_t>(q) & 15) == 0;
  const int v_plane = QUANT ? L::raw + 2 * L::kRaw : L::v_tile;
  zero_words<uint4, NT>(reinterpret_cast<uint4*>(smem + v_plane),
                        own_rows * KROW / 16, D * KROW / 16);

  const int lim0 = r0 < nrows ? mask.limit(r0) : 0;
  const int lim1 = r1 < nrows ? mask.limit(r1) : 0;
  int wmax = max(lim0, lim1);
  int wmin = min(lim0, lim1);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    wmax = max(wmax, __shfl_xor_sync(0xffffffffu, wmax, o));
    wmin = min(wmin, __shfl_xor_sync(0xffffffffu, wmin, o));
  }

  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  float acc[DN][4];
  float s[STEP_TILES][4];
#pragma unroll
  for (int i = 0; i < DN; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll
  for (int i = 0; i < STEP_TILES; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
  const float scale_log2 = rsqrtf((float)hd) * kLog2e;

  const int pages_live = min((kv_len + page_size - 1) / page_size, max_pages);
  const int n_spans = nrows > 0 ? (mask.max_limit(nrows) + W - 1) / W : 0;
  const int units = n_spans * slabs;

  // Start the copies of unit u into ring slot u & 1: K slab j of span
  // c (its rows past a short slab zeroed first), q's slab j (q_async),
  // and with the last slab the own V slab and an int8 cache's scales.
  auto start_unit = [&](int u) {
    const int c = u / slabs;
    const int j = u - c * slabs;
    const int slot = u & 1;
    const int live = slab_rows(hd, j);
    const int kp = QUANT ? L::raw + slot * L::kRaw : L::k_tiles + slot * L::kTile;
    if (live < D)
      zero_words<uint4, NT>(reinterpret_cast<uint4*>(smem + kp),
                            live * KROW / 16, D * KROW / 16);
    stage_chunk_async<C, D, NT, W, kPlaneK, true>(
        k_head + (size_t)j * D * page_size, k_head, pt_row, c * W,
        pages_live, page_size, hd, live, base + kp, base + kp,
        PlaneLayout{KROW, false});
    if (j == slabs - 1) {
      stage_chunk_async<C, D, NT, W, kPlaneV, true>(
          v_own, v_own, pt_row, c * W, pages_live, page_size, hd, own_rows,
          base + v_plane, base + v_plane, PlaneLayout{KROW, false});
      if constexpr (QUANT)
        stage_scales_async<NT, W>(k_scale_head, v_scale_head, pt_row, c * W,
                                  pages_live, page_size, base + L::scales,
                                  base + L::scales + L::kScale);
    }
    if (q_async) {
      const uint32_t qt = base + L::q + slot * L::kQTile;
      for (int i = tid; i < kMmaRows * (D / 8); i += NT) {
        const int r = i / (D / 8);
        const int d = (i - r * (D / 8)) * 8;
        const bool ok = r < nrows && d < live;
        cp_async16(qt + r * L::kQRow + d * 2,
                   ok ? q + rows.offset(r) + j * D + d : q, ok);
      }
    }
    cp_async_commit();
  };
  // q's slab of unit u by loads (not q_async): rows past nrows and head
  // dims past the slab's zero.
  auto load_q = [&](int u) {
    const int j = u % slabs;
    const int live = slab_rows(hd, j);
    unsigned char* qt = smem + L::q + (u & 1) * L::kQTile;
    by_parity(hd, [&](auto odd) {
      constexpr bool ODD = decltype(odd)::value;
      for (int i = tid; i < kMmaRows * (D / 2); i += NT) {
        const int r = i / (D / 2);
        const int d = (i - r * (D / 2)) * 2;
        *reinterpret_cast<uint32_t*>(qt + r * L::kQRow + d * 2) =
            r < nrows ? load_pair<ODD>(q + rows.offset(r) + j * D, d, live)
                      : 0u;
      }
    });
  };

  // Iteration u starts unit u + 1 (iteration -1 only unit 0), so that
  // start_unit has one call site.
  for (int u = -1; u < units; ++u) {
    const int c = u / slabs;
    const int j = u - c * slabs;
    const int slot = u & 1;
    if constexpr (QUANT) {
      // Unit u's raw planes have landed and every warp is done with
      // the tiles: convert them, start unit u + 1 (its raw slot was
      // converted a unit ago), then compute.
      if (u >= 0) {
        cp_async_wait<0>();
        __syncthreads();
        if (j == slabs - 1)
          convert_raw<T, D, W, RB, NT>(smem, L::raw + slot * L::kRaw,
                                       L::raw + 2 * L::kRaw, L::k_tiles,
                                       L::v_tile);
        else
          convert_raw<T, D, W, RB, NT, kPlaneK>(
              smem, L::raw + slot * L::kRaw, 0, L::k_tiles, 0);
      }
      if (u + 1 < units) start_unit(u + 1);
      if (u < 0) continue;
    } else {
      // Unit u + 1 into the slot unit u - 1 left, then wait for unit u.
      if (u + 1 < units) start_unit(u + 1);
      if (u < 0) continue;
      if (u + 1 < units)
        cp_async_wait<1>();
      else
        cp_async_wait<0>();
    }
    if (!q_async) load_q(u);
    __syncthreads();
    const uint32_t k_tile =
        base + L::k_tiles + (QUANT ? 0 : slot * L::kTile);
    const uint32_t q_tile = base + L::q + slot * L::kQTile;
    const int cbase = c * W;
    const int visible = wmax - cbase;
    if (visible > 0) {
      const int groups = min(kMmaStep / 16, (visible + 15) >> 4);
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t a[4];
        const int r = warp * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
        ldmatrix_x4(a, q_tile + r * L::kQRow + (kk * 16 + (lane >> 4) * 8) * 2);
#pragma unroll
        for (int g2 = 0; g2 < kMmaStep / 16; ++g2) {
          if (g2 < groups) {
            const int d = kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
            const int tok = g2 * 16 + (lane >> 4) * 8;
            uint32_t b[4];
            ldmatrix_x4_trans(b, k_tile + d * RB + tok * 2);
            mma16<T>(s[2 * g2], a, b[0], b[1]);
            mma16<T>(s[2 * g2 + 1], a, b[2], b[3]);
          }
        }
      }
      if (j == slabs - 1) {
        const float* kss = reinterpret_cast<const float*>(smem + L::scales);
        mma_softmax_pv<T, QUANT, KS, RB>(
            s, acc, m0, m1, l0, l1, cbase, 0, groups, lim0, lim1, wmin,
            scale_log2, kss, kss + W, base + L::v_tile, lane);
#pragma unroll
        for (int i = 0; i < STEP_TILES; ++i)
#pragma unroll
          for (int x = 0; x < 4; ++x) s[i][x] = 0.f;
      }
    }
    if constexpr (!QUANT) __syncthreads();  // slot u & 1 is free again
  }
  mma_store_rows<T, DN>(out, rows, r0, r1, nrows, acc, l0, l1, own0,
                        own_rows, hd, quad);
}

}  // namespace pstt
