// The tensor-core page walk for 16-bit queries (paged_prefill.cu with
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
//   - q.k^T and p.v run on the tensor cores as bf16 mma.sync
//     (m16n8k16, f32 accumulation). Each warp owns 16 query rows and
//     keeps their q fragments in registers for the whole walk. A page
//     of one kv head is [D, page_size] token-minor, so K as it lies is
//     the B operand of q.k^T with n (the token) contiguous: ldmatrix
//     with .trans; and V as it lies is the B operand of p.v with k
//     (the token) contiguous: plain ldmatrix. Nothing is transposed.
//   - Scores never touch shared memory. The accumulator fragment of
//     q.k^T is scaled, masked and exponentiated in registers (row max
//     over the quad with two shuffles; exp2f with log2(e) / sqrt(D)
//     folded into the scale), and packed to bf16 in place as the A
//     fragment of p.v (the m16n8 accumulator layout is the m16k16 A
//     layout). m, l and the output accumulator stay in registers; l
//     sums the unrounded probabilities. The softmax steps 64 tokens at
//     a time, which halves the score registers.
//   - K and V stage as bf16, never as f32: a chunk of both is 32 KB,
//     in two stages filled with cp.async, so chunk c + 1 arrives while
//     chunk c is multiplied. Rows are padded by 16 bytes (272 a row):
//     the eight 16-byte rows of an ldmatrix tile then fall on eight
//     different bank groups. 68 KB a block, three blocks an SM.
//   - An int8 cache stages its raw pages (two stages of 16 KB) and its
//     scales with the same copies; each chunk is then converted once
//     to the bf16 tile (exact: |x| <= 127) and runs the same products.
//     The scales fold in the Pallas order: score column t times
//     k_scale[t] after the product, l sums the unscaled p, p *
//     v_scale[t] before the conversion to bf16.
//   - The mask is applied only where it cuts: a 64-token step wholly
//     below every limit of the warp skips the compares, and 16-token
//     groups past the warp's highest limit skip their products.

#pragma once

#include "paged_kv_common.cuh"

namespace pstt {

constexpr int kMmaRowBytes = kChunk * 2 + 16;  // a padded bf16 tile row
constexpr int kMmaStep = 64;                   // tokens per softmax step
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory of one block, in bytes. Full precision: two stages of
// bf16 K and V tiles. Quantized: one bf16 tile pair, two stages of raw
// int8 planes and of the chunk's scales.
template <typename C, int D>
struct MmaSmem {
  static constexpr bool kQuant = kQuantized<C>;
  static constexpr int kTile = D * kMmaRowBytes;
  static constexpr int kTileStages = kQuant ? 1 : 2;
  static constexpr int kRaw = kQuant ? D * kChunk : 0;
  static constexpr int kScale = kQuant ? kChunk * 4 : 0;
  static constexpr int tiles = 0;  // [kTileStages][2][kTile]
  static constexpr int raw = tiles + kTileStages * 2 * kTile;  // [2][2][kRaw]
  static constexpr int scales = raw + 2 * 2 * kRaw;  // [2][2][kChunk] f32
  static constexpr int bytes = scales + 2 * 2 * kScale;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
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

// c += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The walk for one block of WARPS * 16 rows. Fragment coordinates of
// lane = 4 * grp + quad: accumulator values 0, 1 sit at row grp,
// columns 2 * quad + {0, 1} of their 16 x 8 tile, values 2, 3 at row
// grp + 8.
//
//   q, out:      the layer's bf16 query/output
//   k/v_head:    this kv head's [num_pages, D, page_size] pages
//   k/v_scale_head: this kv head's [num_pages, page_size] scales (int8
//                cache only; null otherwise)
//   pt_row:      this row's page-table entries (max_pages of them)
//   nrows:       valid rows of the block; the rest are pad
template <typename C, int D, int WARPS, class Mask, class Rows>
__device__ void page_walk_block_mma(
    const __nv_bfloat16* __restrict__ q, __nv_bfloat16* __restrict__ out,
    Rows rows, const C* __restrict__ k_head, const C* __restrict__ v_head,
    const float* __restrict__ k_scale_head,
    const float* __restrict__ v_scale_head, const int* __restrict__ pt_row,
    int max_pages, int page_size, int kv_len, Mask mask, int nrows) {
  constexpr bool QUANT = kQuantized<C>;
  constexpr int NT = WARPS * 32;
  constexpr int KS = D / 16;  // k steps of q.k^T, n-tile pairs of p.v
  constexpr int DN = D / 8;   // n tiles of the output
  constexpr int STEP_TILES = kMmaStep / 8;
  static_assert(D % 16 == 0, "head dim must tile the mma k step");
  using L = MmaSmem<C, D>;
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

  // q fragments: the A operand of every q.k^T product of the walk.
  uint32_t qa[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const int d = kk * 16 + quad * 2;
    const uint32_t* p0 = reinterpret_cast<const uint32_t*>(
        q + (r0 < nrows ? rows.offset(r0) : rows.offset(0)) + d);
    const uint32_t* p1 = reinterpret_cast<const uint32_t*>(
        q + (r1 < nrows ? rows.offset(r1) : rows.offset(0)) + d);
    qa[kk][0] = r0 < nrows ? p0[0] : 0u;
    qa[kk][1] = r1 < nrows ? p1[0] : 0u;
    qa[kk][2] = r0 < nrows ? p0[4] : 0u;
    qa[kk][3] = r1 < nrows ? p1[4] : 0u;
  }

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
  const float scale_log2 = rsqrtf((float)D) * kLog2e;

  const int pages_live = min((kv_len + page_size - 1) / page_size, max_pages);
  const int n_chunks =
      nrows > 0 ? (mask.max_limit(nrows) + kChunk - 1) / kChunk : 0;

  // Start the copies of chunk c into stage c & 1.
  auto start_copies = [&](int c) {
    const int st = c & 1;
    if constexpr (QUANT) {
      stage_chunk_async<C, D, NT>(
          k_head, v_head, pt_row, c, pages_live, page_size,
          base + L::raw + (st * 2 + 0) * L::kRaw,
          base + L::raw + (st * 2 + 1) * L::kRaw,
          [](int d, int col) { return (uint32_t)(d * kChunk + col); });
      stage_scales_async<NT>(k_scale_head, v_scale_head, pt_row, c,
                             pages_live, page_size,
                             base + L::scales + (st * 2 + 0) * L::kScale,
                             base + L::scales + (st * 2 + 1) * L::kScale);
    } else {
      stage_chunk_async<C, D, NT>(
          k_head, v_head, pt_row, c, pages_live, page_size,
          base + L::tiles + (st * 2 + 0) * L::kTile,
          base + L::tiles + (st * 2 + 1) * L::kTile, [](int d, int col) {
            return (uint32_t)(d * kMmaRowBytes + col * 2);
          });
    }
    cp_async_commit();
  };

  if (n_chunks > 0) start_copies(0);
  for (int c = 0; c < n_chunks; ++c) {
    const int st = c & 1;
    uint32_t k_tile, v_tile;
    if constexpr (QUANT) {
      // The raw chunk has landed and every warp is done with the tile:
      // convert it, start the next chunk's copies, then compute.
      cp_async_wait<0>();
      __syncthreads();
      for (int i = tid; i < D * kChunk / 16; i += NT) {
        const int d = i >> 3;
        const int col = (i & 7) * 16;
#pragma unroll
        for (int which = 0; which < 2; ++which) {
          const uint4 rawv = *reinterpret_cast<const uint4*>(
              smem + L::raw + (st * 2 + which) * L::kRaw + i * 16);
          const int8_t* x = reinterpret_cast<const int8_t*>(&rawv);
          uint32_t w[8];
#pragma unroll
          for (int p = 0; p < 8; ++p)
            w[p] = pack_bf16((float)x[2 * p], (float)x[2 * p + 1]);
          uint4* dst = reinterpret_cast<uint4*>(
              smem + L::tiles + which * L::kTile + d * kMmaRowBytes +
              col * 2);
          dst[0] = make_uint4(w[0], w[1], w[2], w[3]);
          dst[1] = make_uint4(w[4], w[5], w[6], w[7]);
        }
      }
      if (c + 1 < n_chunks) start_copies(c + 1);
      __syncthreads();
      k_tile = base + L::tiles;
      v_tile = base + L::tiles + L::kTile;
    } else {
      // Start chunk c + 1 into the stage chunk c - 1 left (its readers
      // passed the barrier that ended that iteration), wait for chunk c.
      if (c + 1 < n_chunks) {
        start_copies(c + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      k_tile = base + L::tiles + (st * 2 + 0) * L::kTile;
      v_tile = base + L::tiles + (st * 2 + 1) * L::kTile;
    }
    const float* kss =
        reinterpret_cast<const float*>(smem + L::scales) + (st * 2) * kChunk;
    const float* vss = kss + kChunk;

    const int cbase = c * kChunk;
#pragma unroll 1
    for (int step = 0; step < kChunk / kMmaStep; ++step) {
      const int tok0 = step * kMmaStep;  // in the chunk
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
#pragma unroll
        for (int g2 = 0; g2 < kMmaStep / 16; ++g2) {
          if (g2 < groups) {
            // Four 8 x 8 tiles of K^T: head dims 16 kk + {0, 8} by
            // tokens 16 g2 + {0, 8}; lane / 8 picks the tile.
            const int d = kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
            const int tok = tok0 + g2 * 16 + (lane >> 4) * 8;
            uint32_t b[4];
            ldmatrix_x4_trans(b, k_tile + d * kMmaRowBytes + tok * 2);
            mma_bf16(s[2 * g2], qa[kk], b[0], b[1]);
            mma_bf16(s[2 * g2 + 1], qa[kk], b[2], b[3]);
          }
        }
      }

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
      // p, packed to bf16 as the A fragments of p.v: score tiles 2 g2
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
        pa[nt >> 1][(nt & 1) * 2 + 0] = pack_bf16(p0, p1);
        pa[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(p2, p3);
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
            ldmatrix_x4(b, v_tile + d * kMmaRowBytes + tok * 2);
            mma_bf16(acc[2 * dp], pa[g2], b[0], b[1]);
            mma_bf16(acc[2 * dp + 1], pa[g2], b[2], b[3]);
          }
        }
      }
    }
    if constexpr (!QUANT) __syncthreads();  // stage st is free again
  }

  // l was summed per thread: add the quad's four parts.
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float den0 = fmaxf(l0, 1e-30f);
  const float den1 = fmaxf(l1, 1e-30f);
  if (r0 < nrows) {
    uint32_t* dst = reinterpret_cast<uint32_t*>(out + rows.offset(r0));
#pragma unroll
    for (int i = 0; i < DN; ++i)
      dst[i * 4 + quad] = pack_bf16(acc[i][0] / den0, acc[i][1] / den0);
  }
  if (r1 < nrows) {
    uint32_t* dst = reinterpret_cast<uint32_t*>(out + rows.offset(r1));
#pragma unroll
    for (int i = 0; i < DN; ++i)
      dst[i * 4 + quad] = pack_bf16(acc[i][2] / den1, acc[i][3] / den1);
  }
}

}  // namespace pstt
