// The decode kernels' templates: the split walk, the merge, the
// burst-tail kernel and their launch (paged_decode.cu describes the
// design and holds the C interface). paged_decode_bf16.cu,
// paged_decode_f16.cu and paged_decode_f32.cu instantiate them a query
// type each.

#pragma once

#include "paged_kv_common.cuh"

namespace pstt {

// One launch's operands and shapes.
struct DecodeArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* ks;
  const void* vs;
  const void* pt;
  const void* kv_lens;
  void* out;
  void* partials;
  int batch, num_q_heads, num_kv_heads, num_pages, page_size, max_pages;
  int num_splits, chunks_per_split;
  LayerOffsets layer;
  const void* k_tail;
  const void* v_tail;
  const void* q_pos;
  int tail_len;
  int head_dim;
  cudaStream_t stream;
};

namespace {

constexpr int kDecodeThreads = 128;
constexpr int kDecodeWarps = kDecodeThreads / 32;
constexpr int kTok = 4;  // adjacent tokens a thread owns in a chunk
constexpr int kDQ = 4;   // head-dim quarters: thread dq owns d = dq + 4 i
static_assert(kDecodeWarps * (32 / kDQ) * kTok == kChunk,
              "the threads' tokens must tile the chunk");

// The widest group tile at head-dim tile D, and the tile a group runs
// (the host's ops/paged_attention_cuda.decode_group_tile): a thread
// holds GT * D / 4 f32 accumulators, which must stay well within its
// 255 registers (128 at GT 4 and D 128, and at GT 2 and D 256).
constexpr int max_group_tile(int d) { return d <= 64 ? 8 : d <= 128 ? 4 : 2; }
constexpr int group_tile(int group, int d) {
  if (group <= 1) return 1;
  const int gt = group <= 4 ? 4 : 8;
  return gt < max_group_tile(d) ? gt : max_group_tile(d);
}

// Shared memory of one block, in bytes: the stages of the chunk's K and
// V planes in the cache's type (and of its scales), q as f32, and the
// warps' partials for the merge at the end. Two stages where they fit
// a block, else one (an f32 cache at head_dim 128, a bf16 or f16 one at
// 256: 128 KB). Where not even one stage of both planes fits (an f32
// cache at 256: 256 KB), the chunk stages K, then V, through one plane
// (kSerial): its copies then overlap no arithmetic of the block.
template <typename C, int D, int GT>
struct DecodeSmem {
  static constexpr bool kQuant = kQuantized<C>;
  static constexpr int kRow = kChunk * (int)sizeof(C);
  static constexpr int kPlane = D * kRow;
  static constexpr int kScale = kQuant ? kChunk * 4 : 0;
  static constexpr int kPart = GT * (D + 2) * 4;  // acc[GT][D], m, l
  static constexpr int kRest = 2 * 2 * kScale + D * GT * 4 +
                               kDecodeWarps * kPart;
  static constexpr int kStages =
      2 * 2 * kPlane + kRest <= kMaxBlockSmem ? 2 : 1;
  static constexpr bool kSerial = 2 * kPlane + kRest > kMaxBlockSmem;
  static constexpr int kPlanes = kSerial ? 1 : kStages * 2;
  static constexpr int stages = 0;  // [kStages][2][kPlane], or [kPlane]
  static constexpr int scales =
      stages + kPlanes * kPlane;                    // [2][2][kChunk]
  static constexpr int q = scales + 2 * 2 * kScale;  // [D][GT] f32
  static constexpr int parts = q + D * GT * 4;       // [kDecodeWarps][kPart]
  static constexpr int bytes = parts + kDecodeWarps * kPart;
  static_assert(bytes <= kMaxBlockSmem, "a decode block's shared memory");
};

// Shared memory of one block of the slab walk (head dims above
// kMaxHeadDim, D = kSlabDim; see paged_kv_common.cuh), in bytes: a ring
// of two K planes (the unit computing, the unit in flight), the own V
// slab's plane, the chunk's K and V scales, q's slab as f32 [D][GT], the
// warps' partials. An f32 cache at a group tile of 4: 202 KB; bf16 106
// KB; int8 59 KB.
template <typename C, int GT>
struct DecodeSlabSmem {
  static constexpr bool kQuant = kQuantized<C>;
  static constexpr int D = kSlabDim;
  static constexpr int kRow = kChunk * (int)sizeof(C);
  static constexpr int kPlane = D * kRow;
  static constexpr int kScale = kQuant ? kChunk * 4 : 0;
  static constexpr int kPart = GT * (D + 2) * 4;
  static constexpr int k_planes = 0;                 // [2][kPlane]
  static constexpr int v_plane = k_planes + 2 * kPlane;
  static constexpr int scales = v_plane + kPlane;    // [2][kChunk]: K, V
  static constexpr int q = scales + 2 * kScale;      // [D][GT] f32
  static constexpr int parts = q + D * GT * 4;       // [kDecodeWarps][kPart]
  static constexpr int bytes = parts + kDecodeWarps * kPart;
  static_assert(bytes <= kMaxBlockSmem, "a decode slab block's shared memory");
};

// Byte offset of (head dim d, chunk token col) in a staged plane, rows
// of kChunk tokens swizzled (PlaneLayout{kChunk * sizeof(C), true}, the
// layout stage_chunk_async fills). The four head dims d..d+3 a warp
// reads together land on different banks: each quarter's 8 lanes read
// one 32 * sizeof(C)-byte window of a row.
template <typename C>
__device__ __forceinline__ uint32_t plane_offset(int d, int col) {
  return PlaneLayout{kChunk * (int)sizeof(C), true}.offset(d, col,
                                                           sizeof(C));
}

// Four adjacent tokens of one head dim, as f32.
__device__ __forceinline__ void load_tok4(const unsigned char* p,
                                          float (&f)[4], float) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  f[0] = x.x;
  f[1] = x.y;
  f[2] = x.z;
  f[3] = x.w;
}
__device__ __forceinline__ void load_tok4(const unsigned char* p,
                                          float (&f)[4], __nv_bfloat16) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  const float2 lo =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x.x));
  const float2 hi =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x.y));
  f[0] = lo.x;
  f[1] = lo.y;
  f[2] = hi.x;
  f[3] = hi.y;
}
__device__ __forceinline__ void load_tok4(const unsigned char* p,
                                          float (&f)[4], __half) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __half22float2(*reinterpret_cast<const __half2*>(&x.x));
  const float2 hi = __half22float2(*reinterpret_cast<const __half2*>(&x.y));
  f[0] = lo.x;
  f[1] = lo.y;
  f[2] = hi.x;
  f[3] = hi.y;
}
__device__ __forceinline__ void load_tok4(const unsigned char* p,
                                          float (&f)[4], int8_t) {
  const char4 x = *reinterpret_cast<const char4*>(p);
  f[0] = (float)x.x;
  f[1] = (float)x.y;
  f[2] = (float)x.z;
  f[3] = (float)x.w;
}

// Where block (b, y, split) writes, and the merge reads, its partial;
// y = kv head * tiles + group tile runs over gridDim.y = ys.
template <int D, int GT>
__device__ __forceinline__ size_t partial_offset(int b, int y, int ys,
                                                 int num_splits, int split) {
  return (((size_t)b * ys + y) * num_splits + split) * (GT * (D + 2));
}

// The group tile of grid row y (blockIdx.y for the tile kernels, the
// first constructor; blockIdx.y / slabs for the slab ones): its kv
// head, where its first query head starts in q and out (rows of the
// real head dim hd), and how many of its GT heads are live (< G).
template <int GT>
struct GroupTile {
  int h;
  int live;
  size_t row_offset;

  __device__ __forceinline__ GroupTile(int b, int num_q_heads, int group,
                                       int tiles, int hd) {
    h = blockIdx.y / tiles;
    const int g0 = (blockIdx.y - h * tiles) * GT;
    live = min(GT, group - g0);
    row_offset = ((size_t)b * num_q_heads + (size_t)h * group + g0) * hd;
  }
  __device__ __forceinline__ GroupTile(int b, int num_q_heads, int group,
                                       int tiles, int hd, int y) {
    h = y / tiles;
    const int g0 = (y - h * tiles) * GT;
    live = min(GT, group - g0);
    row_offset = ((size_t)b * num_q_heads + (size_t)h * group + g0) * hd;
  }
};

// The slab kernel's pieces of paged_decode_kernel's walk (that kernel
// keeps them inline: called there, they moved its tile-256 instances,
// at 254 to 255 registers, into spills).
//
// The end of a chunk's scores: sum the four head-dim quarters (every
// lane of a quad then holds its 4 tokens' scores), scale, fold the K
// scales, mask tokens at or past kv_len (pos0: the first token's
// position), and run the warp's online softmax over them: m, l and acc
// rescaled, l summing the unscaled p, and s left holding p (times the V
// scales, an int8 cache) for p . v.
template <bool QUANT, int GT, int DI>
__device__ __forceinline__ void decode_softmax(
    float (&s)[GT][kTok], float (&m)[GT], float (&l)[GT],
    float (&acc)[GT][DI], const float* kss, const float* vss, int pos0,
    int tok0, int kv_len, float scale) {
#pragma unroll
  for (int g = 0; g < GT; ++g)
#pragma unroll
    for (int x = 0; x < kTok; ++x) {
      s[g][x] += __shfl_xor_sync(0xffffffffu, s[g][x], 1);
      s[g][x] += __shfl_xor_sync(0xffffffffu, s[g][x], 2);
    }

  // Scale, fold the K scales, mask; the warp's online softmax.
  bool valid[kTok];
  float kscale[kTok], vscale[kTok];
#pragma unroll
  for (int x = 0; x < kTok; ++x) {
    valid[x] = pos0 + x < kv_len;
    kscale[x] = vscale[x] = 1.f;
    if constexpr (QUANT) {
      kscale[x] = kss[tok0 + x];
      vscale[x] = vss[tok0 + x];
    }
  }
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    float mx = kNegInf;
#pragma unroll
    for (int x = 0; x < kTok; ++x) {
      float sc = s[g][x] * scale;
      if constexpr (QUANT) sc *= kscale[x];
      s[g][x] = valid[x] ? sc : kNegInf;
      mx = fmaxf(mx, s[g][x]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
    const float m_new = fmaxf(m[g], mx);
    const float alpha = expf(m[g] - m_new);
    m[g] = m_new;
    l[g] *= alpha;
#pragma unroll
    for (int i = 0; i < DI; ++i) acc[g][i] *= alpha;
#pragma unroll
    for (int x = 0; x < kTok; ++x) {
      const float p = valid[x] ? expf(s[g][x] - m_new) : 0.f;
      l[g] += p;  // l sums the unscaled p
      s[g][x] = QUANT ? p * vscale[x] : p;
    }
  }
}

// acc += p . v over this thread's tokens and head dims, V from the
// staged plane vp.
template <typename C, int GT, int DI>
__device__ __forceinline__ void decode_pv(const float (&s)[GT][kTok],
                                          float (&acc)[GT][DI],
                                          const unsigned char* vp, int dq,
                                          int tok0) {
#pragma unroll
  for (int i = 0; i < DI; ++i) {
    const int d = dq + kDQ * i;
    float vf[kTok];
    load_tok4(vp + plane_offset<C>(d, tok0), vf, C());
#pragma unroll
    for (int g = 0; g < GT; ++g)
#pragma unroll
      for (int x = 0; x < kTok; ++x)
        acc[g][i] = fmaf(s[g][x], vf[x], acc[g][i]);
  }
}

// The end of a block's walk: each warp's totals into the parts, then
// the four warps merged in warp order into the output of the live heads
// (one split: head g's head dims d < cols at o[g * stride + d]) or the
// block's partial (every head of the tile).
template <typename T, int D, int GT, int DI>
__device__ __forceinline__ void decode_block_out(
    float (&acc)[GT][DI], float (&m)[GT], float (&l)[GT],
    float* __restrict__ parts, T* __restrict__ o, int stride, int cols,
    int live, float* __restrict__ part, int part_splits) {
  constexpr int NT = kDecodeThreads;
  constexpr int PW = D + 2;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int dq = lane & (kDQ - 1);
  // The warp's totals: sum acc and l over its 8 token groups (l was
  // summed per thread; the four quarters of a group hold the same l).
#pragma unroll
  for (int g = 0; g < GT; ++g) {
#pragma unroll
    for (int o2 = kDQ; o2 < 32; o2 <<= 1) {
      l[g] += __shfl_xor_sync(0xffffffffu, l[g], o2);
#pragma unroll
      for (int i = 0; i < DI; ++i)
        acc[g][i] += __shfl_xor_sync(0xffffffffu, acc[g][i], o2);
    }
  }
  if (lane < kDQ) {
    float* mine = parts + warp * (GT * PW);
#pragma unroll
    for (int g = 0; g < GT; ++g) {
#pragma unroll
      for (int i = 0; i < DI; ++i) mine[g * PW + dq + kDQ * i] = acc[g][i];
      if (lane == 0) {
        mine[g * PW + D] = m[g];
        mine[g * PW + D + 1] = l[g];
      }
    }
  }
  __syncthreads();

  // Merge the four warps in warp order; write the output of the live
  // heads (one split) or this block's partial (every head of the tile).
  for (int i = tid; i < GT * D; i += NT) {
    const int g = i / D;
    const int d = i - g * D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kDecodeWarps; ++w)
      mx = fmaxf(mx, parts[w * (GT * PW) + g * PW + D]);
    float tot = 0.f, tot_l = 0.f;
#pragma unroll
    for (int w = 0; w < kDecodeWarps; ++w) {
      const float* pw = parts + w * (GT * PW) + g * PW;
      const float e = expf(pw[D] - mx);
      tot = fmaf(e, pw[d], tot);
      tot_l = fmaf(e, pw[D + 1], tot_l);
    }
    if (part_splits == 1) {
      if (g < live && d < cols)
        o[g * stride + d] = from_f32<T>(tot / fmaxf(tot_l, 1e-30f));
    } else {
      part[g * PW + d] = tot;
      if (d == 0) {
        part[g * PW + D] = mx;
        part[g * PW + D + 1] = tot_l;
      }
    }
  }
}

template <typename T, typename C, int D, int GT>
__global__ void __launch_bounds__(kDecodeThreads)
paged_decode_kernel(const T* __restrict__ q, const C* __restrict__ k_cache,
                    const C* __restrict__ v_cache,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int* __restrict__ page_table,
                    const int* __restrict__ kv_lens, T* __restrict__ out,
                    float* __restrict__ partials, int num_q_heads,
                    int group, int tiles, int num_pages, int page_size,
                    int max_pages, int part_splits, int chunks_per_split,
                    LayerOffsets layer, int hd) {
  constexpr bool QUANT = kQuantized<C>;
  constexpr int NT = kDecodeThreads;
  constexpr int DI = D / kDQ;  // head dims a thread owns
  constexpr int PW = D + 2;    // words of one query head's partial
  static_assert(D % kDQ == 0, "head dim must split in quarters");
  using L = DecodeSmem<C, D, GT>;
  extern __shared__ uint4 smem_decode[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem_decode);
  const uint32_t base = smem_u32(smem);
  float* qs = reinterpret_cast<float*>(smem + L::q);
  float* parts = reinterpret_cast<float*>(smem + L::parts);

  const int b = blockIdx.x;
  const GroupTile<GT> tile(b, num_q_heads, group, tiles, hd);
  const int h = tile.h;
  const int split = blockIdx.z;
  const int tid = threadIdx.x;
  const int kv_len = kv_lens[b];
  const int n_chunks = (kv_len + kChunk - 1) / kChunk;
  const int c_begin = split * chunks_per_split;
  const int c_end = min(c_begin + chunks_per_split, n_chunks);
  T* o = out + tile.row_offset;
  // part_splits counts the partials' slots: the walk's splits, and a
  // burst tail's slot after them. One slot: the walk writes the output.
  float* part = part_splits > 1
                    ? partials + partial_offset<D, GT>(b, blockIdx.y,
                                                       gridDim.y,
                                                       part_splits, split)
                    : nullptr;

  if (c_begin >= c_end) {
    // Nothing of this row lies in the range: no load. One split: the
    // row is a pad row and its output is exact 0.
    if (part_splits == 1) {
      for (int i = tid; i < tile.live * hd; i += NT) o[i] = from_f32<T>(0.f);
    } else {
      for (int i = tid; i < GT * PW; i += NT)
        part[i] = (i % PW == D) ? kNegInf : 0.f;
    }
    return;
  }

  const size_t head_elems = (size_t)num_pages * hd * page_size;
  const size_t head_slots = (size_t)num_pages * page_size;
  const C* k_head = k_cache + layer.data() + h * head_elems;
  const C* v_head = v_cache + layer.data() + h * head_elems;
  const float* ks_head =
      QUANT ? k_scale + layer.scale() + h * head_slots : nullptr;
  const float* vs_head =
      QUANT ? v_scale + layer.scale() + h * head_slots : nullptr;
  const int* pt_row = page_table + (size_t)b * max_pages;
  const int pages_live = min((kv_len + page_size - 1) / page_size, max_pages);

  // Start the copies of chunk c into stage st: K and V, or (kSerial)
  // the planes named, into the one plane (and the scales with K).
  auto start_copies = [&](int c, int st, auto planes) {
    constexpr int P = decltype(planes)::value;
    stage_chunk_async<C, D, NT, kChunk, P>(
        k_head, v_head, pt_row, c * kChunk, pages_live, page_size, hd, hd,
        base + L::stages + (st * 2 + 0) * L::kPlane,
        base + L::stages + (L::kSerial ? 0 : st * 2 + 1) * L::kPlane,
        PlaneLayout{kChunk * (int)sizeof(C), true});
    if constexpr (QUANT && (P & kPlaneK) != 0)
      stage_scales_async<NT>(ks_head, vs_head, pt_row, c * kChunk,
                             pages_live, page_size,
                             base + L::scales + (st * 2 + 0) * L::kScale,
                             base + L::scales + (st * 2 + 1) * L::kScale);
    cp_async_commit();
  };
  using KV = std::integral_constant<int, kPlanesKV>;
  using KOnly = std::integral_constant<int, kPlaneK>;
  using VOnly = std::integral_constant<int, kPlaneV>;
  // The planes' rows d >= head_dim: zero for the whole walk (the
  // whole-page copies write them as zeros, the general staging of other
  // pages not at all).
  for (int p = 0; p < L::kPlanes; ++p)
    zero_words<uint4, NT>(
        reinterpret_cast<uint4*>(smem + L::stages + p * L::kPlane),
        hd * L::kRow / 16, D * L::kRow / 16);
  if constexpr (L::kSerial)
    start_copies(c_begin, 0, KOnly());
  else
    start_copies(c_begin, 0, KV());

  // q of the tile's GT query heads, as f32 [D][GT] (zeros past G and
  // past head_dim): one broadcast read a head dim.
  for (int i = tid; i < GT * D; i += NT) {
    const int g = i / D;
    const int d = i - g * D;
    qs[d * GT + g] = g < tile.live && d < hd
                         ? to_f32(q[tile.row_offset + g * hd + d])
                         : 0.f;
  }

  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int dq = lane & (kDQ - 1);
  const int tok0 = (warp * (32 / kDQ) + lane / kDQ) * kTok;  // in the chunk
  const float scale = rsqrtf((float)hd);

  float m[GT], l[GT], acc[GT][DI];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < DI; ++i) acc[g][i] = 0.f;
  }

  for (int c = c_begin; c < c_end; ++c) {
    const int st = L::kStages == 2 ? (c - c_begin) & 1 : 0;
    if constexpr (L::kSerial) {
      // K through the one plane; V follows once the scores are taken.
      if (c > c_begin) start_copies(c, 0, KOnly());
      cp_async_wait<0>();
    } else if constexpr (L::kStages == 2) {
      // Start chunk c + 1 into the stage chunk c - 1 left (its readers
      // passed the barrier that ended that iteration), wait for chunk c.
      if (c + 1 < c_end) {
        start_copies(c + 1, st ^ 1, KV());
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
    } else {
      // One stage: chunk c's copies start once the barrier that ended
      // the last iteration freed it.
      if (c > c_begin) start_copies(c, 0, KV());
      cp_async_wait<0>();
    }
    __syncthreads();
    const unsigned char* kp = smem + L::stages + (st * 2 + 0) * L::kPlane;
    const unsigned char* vp =
        smem + L::stages + (L::kSerial ? 0 : st * 2 + 1) * L::kPlane;
    const float* kss =
        reinterpret_cast<const float*>(smem + L::scales) + (st * 2) * kChunk;
    const float* vss = kss + kChunk;

    // Partial scores of this thread's 4 tokens over its head dims.
    float s[GT][kTok];
#pragma unroll
    for (int g = 0; g < GT; ++g)
#pragma unroll
      for (int x = 0; x < kTok; ++x) s[g][x] = 0.f;
#pragma unroll
    for (int i = 0; i < DI; ++i) {
      const int d = dq + kDQ * i;
      float kf[kTok];
      load_tok4(kp + plane_offset<C>(d, tok0), kf, C());
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        const float qv = qs[d * GT + g];
#pragma unroll
        for (int x = 0; x < kTok; ++x) s[g][x] = fmaf(qv, kf[x], s[g][x]);
      }
    }
    // Sum the four quarters: every lane of a quad then holds the scores.
#pragma unroll
    for (int g = 0; g < GT; ++g)
#pragma unroll
      for (int x = 0; x < kTok; ++x) {
        s[g][x] += __shfl_xor_sync(0xffffffffu, s[g][x], 1);
        s[g][x] += __shfl_xor_sync(0xffffffffu, s[g][x], 2);
      }

    // Scale, fold the K scales, mask; the warp's online softmax.
    bool valid[kTok];
    float kscale[kTok], vscale[kTok];
#pragma unroll
    for (int x = 0; x < kTok; ++x) {
      valid[x] = c * kChunk + tok0 + x < kv_len;
      kscale[x] = vscale[x] = 1.f;
      if constexpr (QUANT) {
        kscale[x] = kss[tok0 + x];
        vscale[x] = vss[tok0 + x];
      }
    }
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      float mx = kNegInf;
#pragma unroll
      for (int x = 0; x < kTok; ++x) {
        float sc = s[g][x] * scale;
        if constexpr (QUANT) sc *= kscale[x];
        s[g][x] = valid[x] ? sc : kNegInf;
        mx = fmaxf(mx, s[g][x]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
      const float m_new = fmaxf(m[g], mx);
      const float alpha = expf(m[g] - m_new);
      m[g] = m_new;
      l[g] *= alpha;
#pragma unroll
      for (int i = 0; i < DI; ++i) acc[g][i] *= alpha;
#pragma unroll
      for (int x = 0; x < kTok; ++x) {
        const float p = valid[x] ? expf(s[g][x] - m_new) : 0.f;
        l[g] += p;  // l sums the unscaled p
        s[g][x] = QUANT ? p * vscale[x] : p;
      }
    }

    if constexpr (L::kSerial) {
      // Every thread is done with K: V into the same plane.
      __syncthreads();
      start_copies(c, 0, VOnly());
      cp_async_wait<0>();
      __syncthreads();
    }

    // acc += p . v over this thread's tokens and head dims.
#pragma unroll
    for (int i = 0; i < DI; ++i) {
      const int d = dq + kDQ * i;
      float vf[kTok];
      load_tok4(vp + plane_offset<C>(d, tok0), vf, C());
#pragma unroll
      for (int g = 0; g < GT; ++g)
#pragma unroll
        for (int x = 0; x < kTok; ++x)
          acc[g][i] = fmaf(s[g][x], vf[x], acc[g][i]);
    }
    __syncthreads();  // stage st is free again
  }

  // The warp's totals: sum acc and l over its 8 token groups (l was
  // summed per thread; the four quarters of a group hold the same l).
#pragma unroll
  for (int g = 0; g < GT; ++g) {
#pragma unroll
    for (int o2 = kDQ; o2 < 32; o2 <<= 1) {
      l[g] += __shfl_xor_sync(0xffffffffu, l[g], o2);
#pragma unroll
      for (int i = 0; i < DI; ++i)
        acc[g][i] += __shfl_xor_sync(0xffffffffu, acc[g][i], o2);
    }
  }
  if (lane < kDQ) {
    float* mine = parts + warp * (GT * PW);
#pragma unroll
    for (int g = 0; g < GT; ++g) {
#pragma unroll
      for (int i = 0; i < DI; ++i) mine[g * PW + dq + kDQ * i] = acc[g][i];
      if (lane == 0) {
        mine[g * PW + D] = m[g];
        mine[g * PW + D + 1] = l[g];
      }
    }
  }
  __syncthreads();

  // Merge the four warps in warp order; write the output of the live
  // heads (one split) or this block's partial (every head of the tile).
  for (int i = tid; i < GT * D; i += NT) {
    const int g = i / D;
    const int d = i - g * D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kDecodeWarps; ++w)
      mx = fmaxf(mx, parts[w * (GT * PW) + g * PW + D]);
    float tot = 0.f, tot_l = 0.f;
#pragma unroll
    for (int w = 0; w < kDecodeWarps; ++w) {
      const float* pw = parts + w * (GT * PW) + g * PW;
      const float e = expf(pw[D] - mx);
      tot = fmaf(e, pw[d], tot);
      tot_l = fmaf(e, pw[D + 1], tot_l);
    }
    if (part_splits == 1) {
      if (g < tile.live && d < hd)
        o[g * hd + d] = from_f32<T>(tot / fmaxf(tot_l, 1e-30f));
    } else {
      part[g * PW + d] = tot;
      if (d == 0) {
        part[g * PW + D] = mx;
        part[g * PW + D + 1] = tot_l;
      }
    }
  }
}

// The split walk of one output slab of a head_dim above kMaxHeadDim
// (D = kSlabDim, `slabs` slabs; paged_kv_common.cuh's slab design):
// grid y runs over kv heads x group tiles x slabs, slab fastest, so
// the partials of a slab lie at its own y. A chunk is walked in units,
// one a slab: unit (c, j) stages K slab j of the chunk into ring slot
// u & 1 (the own V slab and the scales with the last K slab), loads q's
// slab j as f32 and adds its head dims into the thread's partial
// scores; after the last slab the scores are summed over the quarters
// and the chunk runs the softmax and p . v of paged_decode_kernel.
// Every slab's block computes the same m and l.
template <typename T, typename C, int GT>
__global__ void __launch_bounds__(kDecodeThreads)
paged_decode_slab_kernel(const T* __restrict__ q,
                         const C* __restrict__ k_cache,
                         const C* __restrict__ v_cache,
                         const float* __restrict__ k_scale,
                         const float* __restrict__ v_scale,
                         const int* __restrict__ page_table,
                         const int* __restrict__ kv_lens, T* __restrict__ out,
                         float* __restrict__ partials, int num_q_heads,
                         int group, int tiles, int num_pages, int page_size,
                         int max_pages, int part_splits,
                         int chunks_per_split, LayerOffsets layer, int hd,
                         int slabs) {
  constexpr bool QUANT = kQuantized<C>;
  constexpr int NT = kDecodeThreads;
  constexpr int D = kSlabDim;
  constexpr int DI = D / kDQ;
  constexpr int PW = D + 2;
  using L = DecodeSlabSmem<C, GT>;
  extern __shared__ uint4 smem_decode[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem_decode);
  const uint32_t base = smem_u32(smem);
  float* qs = reinterpret_cast<float*>(smem + L::q);
  float* parts = reinterpret_cast<float*>(smem + L::parts);

  const int b = blockIdx.x;
  const int y = blockIdx.y / slabs;
  const int slab = blockIdx.y - y * slabs;
  const GroupTile<GT> tile(b, num_q_heads, group, tiles, hd, y);
  const int h = tile.h;
  const int own0 = slab * D;
  const int own_rows = slab_rows(hd, slab);
  const int split = blockIdx.z;
  const int tid = threadIdx.x;
  const int kv_len = kv_lens[b];
  const int n_chunks = (kv_len + kChunk - 1) / kChunk;
  const int c_begin = split * chunks_per_split;
  const int c_end = min(c_begin + chunks_per_split, n_chunks);
  T* o = out + tile.row_offset + own0;
  float* part = part_splits > 1
                    ? partials + partial_offset<D, GT>(b, blockIdx.y,
                                                       gridDim.y,
                                                       part_splits, split)
                    : nullptr;

  if (c_begin >= c_end) {
    if (part_splits == 1) {
      for (int i = tid; i < tile.live * own_rows; i += NT) {
        const int g = i / own_rows;
        o[g * hd + i - g * own_rows] = from_f32<T>(0.f);
      }
    } else {
      for (int i = tid; i < GT * PW; i += NT)
        part[i] = (i % PW == D) ? kNegInf : 0.f;
    }
    return;
  }

  const size_t head_elems = (size_t)num_pages * hd * page_size;
  const size_t head_slots = (size_t)num_pages * page_size;
  const C* k_head = k_cache + layer.data() + h * head_elems;
  const C* v_own =
      v_cache + layer.data() + h * head_elems + (size_t)own0 * page_size;
  const float* ks_head =
      QUANT ? k_scale + layer.scale() + h * head_slots : nullptr;
  const float* vs_head =
      QUANT ? v_scale + layer.scale() + h * head_slots : nullptr;
  const int* pt_row = page_table + (size_t)b * max_pages;
  const int pages_live = min((kv_len + page_size - 1) / page_size, max_pages);
  const int units = (c_end - c_begin) * slabs;
  const PlaneLayout layout{L::kRow, true};

  // Start unit u: K slab j of chunk c into ring slot u & 1 (rows past a
  // short slab zeroed first: the general staging leaves them); with the
  // last slab, the own V slab and the chunk's scales.
  auto start_unit = [&](int u) {
    const int c = c_begin + u / slabs;
    const int j = u % slabs;
    const int live = slab_rows(hd, j);
    const int kp = L::k_planes + (u & 1) * L::kPlane;
    if (live < D)
      zero_words<uint4, NT>(reinterpret_cast<uint4*>(smem + kp),
                            live * L::kRow / 16, D * L::kRow / 16);
    stage_chunk_async<C, D, NT, kChunk, kPlaneK, true>(
        k_head + (size_t)j * D * page_size, k_head, pt_row, c * kChunk,
        pages_live, page_size, hd, live, base + kp, base + kp, layout);
    if (j == slabs - 1) {
      stage_chunk_async<C, D, NT, kChunk, kPlaneV, true>(
          v_own, v_own, pt_row, c * kChunk, pages_live, page_size, hd,
          own_rows, base + L::v_plane, base + L::v_plane, layout);
      if constexpr (QUANT)
        stage_scales_async<NT>(ks_head, vs_head, pt_row, c * kChunk,
                               pages_live, page_size, base + L::scales,
                               base + L::scales + L::kScale);
    }
    cp_async_commit();
  };
  zero_words<uint4, NT>(reinterpret_cast<uint4*>(smem + L::v_plane),
                        own_rows * L::kRow / 16, D * L::kRow / 16);

  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int dq = lane & (kDQ - 1);
  const int tok0 = (warp * (32 / kDQ) + lane / kDQ) * kTok;
  const float scale = rsqrtf((float)hd);

  float m[GT], l[GT], acc[GT][DI], s[GT][kTok];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < DI; ++i) acc[g][i] = 0.f;
#pragma unroll
    for (int x = 0; x < kTok; ++x) s[g][x] = 0.f;
  }

  // Iteration u starts unit u + 1 into the slot unit u - 1 left (the V
  // plane and the scales were last read a chunk ago; iteration -1 only
  // starts unit 0), then waits for unit u.
  for (int u = -1; u < units; ++u) {
    if (u + 1 < units) start_unit(u + 1);
    if (u < 0) continue;
    if (u + 1 < units)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    const int c = c_begin + u / slabs;
    const int j = u % slabs;
    // q's slab j of the tile's GT heads, as f32 [D][GT] (zeros past G
    // and past the slab's head dims).
    const int live = slab_rows(hd, j);
    for (int i = tid; i < GT * D; i += NT) {
      const int g = i / D;
      const int d = i - g * D;
      qs[d * GT + g] = g < tile.live && d < live
                           ? to_f32(q[tile.row_offset + g * hd + j * D + d])
                           : 0.f;
    }
    __syncthreads();
    const unsigned char* kp = smem + L::k_planes + (u & 1) * L::kPlane;
#pragma unroll
    for (int i = 0; i < DI; ++i) {
      const int d = dq + kDQ * i;
      float kf[kTok];
      load_tok4(kp + plane_offset<C>(d, tok0), kf, C());
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        const float qv = qs[d * GT + g];
#pragma unroll
        for (int x = 0; x < kTok; ++x) s[g][x] = fmaf(qv, kf[x], s[g][x]);
      }
    }
    if (j == slabs - 1) {
      const float* kss = reinterpret_cast<const float*>(smem + L::scales);
      decode_softmax<QUANT>(s, m, l, acc, kss, kss + kChunk,
                            c * kChunk + tok0, tok0, kv_len, scale);
      decode_pv<C>(s, acc, smem + L::v_plane, dq, tok0);
#pragma unroll
      for (int g = 0; g < GT; ++g)
#pragma unroll
        for (int x = 0; x < kTok; ++x) s[g][x] = 0.f;
    }
    __syncthreads();  // slot u & 1, q (and the V plane) are free again
  }

  decode_block_out<T, D, GT>(acc, m, l, parts, o, hd, own_rows, tile.live,
                             part, part_splits);
}

// Merge the splits' partials of one (row, kv head, group tile) in split
// order: thread (g, d) of GT * D (at most 512). A row whose every split
// is empty has m = -1e30 and l = 0 everywhere: weights exp(0) = 1 over
// zeros, exact 0. Heads past G and head dims past head_dim are not
// written. SLAB: grid y runs over the slabs too (slab fastest), and a
// block merges its slab's head dims.
template <typename T, int D, int GT, bool SLAB>
__global__ void __launch_bounds__(GT* D)
paged_decode_merge_kernel(const float* __restrict__ partials,
                          T* __restrict__ out, int num_q_heads, int group,
                          int tiles, int num_splits, int hd, int slabs) {
  constexpr int PW = D + 2;
  const int b = blockIdx.x;
  const int y = SLAB ? blockIdx.y / slabs : blockIdx.y;
  const int col0 = SLAB ? (blockIdx.y - y * slabs) * D : 0;
  const GroupTile<GT> tile(b, num_q_heads, group, tiles, hd, y);
  const int g = threadIdx.x / D;
  const int d = threadIdx.x - g * D;
  if (g >= tile.live || col0 + d >= hd) return;
  const float* p = partials +
                   partial_offset<D, GT>(b, blockIdx.y, gridDim.y,
                                         num_splits, 0) +
                   g * PW;
  float mx = kNegInf;
  for (int s = 0; s < num_splits; ++s)
    mx = fmaxf(mx, p[(size_t)s * (GT * PW) + D]);
  float tot = 0.f, tot_l = 0.f;
  for (int s = 0; s < num_splits; ++s) {
    const float* ps = p + (size_t)s * (GT * PW);
    const float e = expf(ps[D] - mx);
    tot = fmaf(e, ps[d], tot);
    tot_l = fmaf(e, ps[D + 1], tot_l);
  }
  out[tile.row_offset + (size_t)g * hd + col0 + d] =
      from_f32<T>(tot / fmaxf(tot_l, 1e-30f));
}


// The most tail slots a burst carries (the JAX tail's bound).
constexpr int kMaxTail = 32;

// A burst tail's partial of one (row, kv head, group tile), into the
// slot `tail_slot` of the partials: thread (g, slot) scores, one thread
// a query head the softmax over at most 32 slots, thread (g, d) p . v.
// Slot s attends iff kv_lens[b] + s <= q_pos[b]; a row none of whose
// slots attends writes the empty partial (0, -1e30, 0). Heads past G
// score with q = 0; the merge never writes them. The tail's rows are
// of the real head dim hd; the partial's head dims past it hold 0.
// SLAB: grid y runs over the slabs too (slab fastest); each score runs
// over the whole head_dim in one thread, q read from device memory (qs
// would grow with head_dim), and p . v fills the block's own slab.
template <typename T, int D, int GT, bool SLAB>
__global__ void __launch_bounds__(kDecodeThreads)
paged_decode_tail_kernel(const T* __restrict__ q,
                         const T* __restrict__ k_tail,
                         const T* __restrict__ v_tail,
                         const int* __restrict__ kv_lens,
                         const int* __restrict__ q_pos,
                         float* __restrict__ partials, int num_q_heads,
                         int group, int tiles, int kv_heads, int tail_len,
                         int part_splits, int hd, int slabs) {
  constexpr int NT = kDecodeThreads;
  constexpr int PW = D + 2;
  __shared__ float qs[GT * D];
  __shared__ float ps[GT * kMaxTail];
  __shared__ float ms[GT];
  __shared__ float ls[GT];
  const int b = blockIdx.x;
  const int y = SLAB ? blockIdx.y / slabs : blockIdx.y;
  const int col0 = SLAB ? (blockIdx.y - y * slabs) * D : 0;
  const GroupTile<GT> tile(b, num_q_heads, group, tiles, hd, y);
  const int h = tile.h;
  const int tid = threadIdx.x;
  const int live = max(0, min(tail_len, q_pos[b] - kv_lens[b] + 1));
  const float scale = rsqrtf((float)hd);
  if constexpr (!SLAB) {
    for (int i = tid; i < GT * D; i += NT) {
      const int g = i / D;
      const int d = i - g * D;
      qs[i] = g < tile.live && d < hd
                  ? to_f32(q[tile.row_offset + g * hd + d])
                  : 0.f;
    }
    __syncthreads();

    for (int i = tid; i < GT * tail_len; i += NT) {
      const int g = i / tail_len;
      const int s = i - g * tail_len;
      const T* kr = k_tail + (((size_t)b * tail_len + s) * kv_heads + h) * hd;
      float acc = 0.f;
#pragma unroll 8
      for (int d = 0; d < hd; ++d) acc = fmaf(qs[g * D + d], to_f32(kr[d]), acc);
      ps[g * kMaxTail + s] = s < live ? acc * scale : kNegInf;
    }
  } else {
    // Each (g, slot)'s score over the whole head_dim, q read from
    // device memory (GT rows of hd elements, cached) rather than staged:
    // no buffer of the block grows with head_dim. Heads past G score 0.
    for (int i = tid; i < GT * tail_len; i += NT) {
      const int g = i / tail_len;
      const int s = i - g * tail_len;
      const T* kr = k_tail + (((size_t)b * tail_len + s) * kv_heads + h) * hd;
      const T* qr = q + tile.row_offset + (size_t)g * hd;
      float acc = 0.f;
      if (g < tile.live)
        for (int d = 0; d < hd; ++d) acc = fmaf(to_f32(qr[d]), to_f32(kr[d]), acc);
      ps[g * kMaxTail + s] = s < live ? acc * scale : kNegInf;
    }
  }
  __syncthreads();
  if (tid < GT) {
    float* p = ps + tid * kMaxTail;
    float mx = kNegInf;
    for (int s = 0; s < live; ++s) mx = fmaxf(mx, p[s]);
    float l = 0.f;
    for (int s = 0; s < tail_len; ++s) {
      const float e = s < live ? expf(p[s] - mx) : 0.f;
      p[s] = e;
      l += e;
    }
    ms[tid] = mx;
    ls[tid] = l;
  }
  __syncthreads();
  float* part = partials + partial_offset<D, GT>(b, blockIdx.y, gridDim.y,
                                                 part_splits,
                                                 part_splits - 1);
  for (int i = tid; i < GT * D; i += NT) {
    const int g = i / D;
    const int d = i - g * D;
    float acc = 0.f;
    if (col0 + d < hd) {
      const T* vr =
          v_tail + ((size_t)b * tail_len * kv_heads + h) * hd + col0 + d;
      for (int s = 0; s < tail_len; ++s)
        acc = fmaf(ps[g * kMaxTail + s],
                   to_f32(vr[(size_t)s * kv_heads * hd]), acc);
    }
    part[g * PW + d] = acc;
    if (d == 0) {
      part[g * PW + D] = ms[g];
      part[g * PW + D + 1] = ls[g];
    }
  }
}



// SLAB: the slab walk (D = kSlabDim) of a head_dim above kMaxHeadDim,
// its grid's y axis (and the partials') `slabs` times as long.
template <typename T, typename C, int D, int GT, bool SLAB>
int launch(const DecodeArgs& a) {
  if (kQuantized<C> && (a.ks == nullptr || a.vs == nullptr))
    return cudaErrorInvalidValue;
  const bool tail = a.k_tail != nullptr;
  const int hd = a.head_dim;
  const int part_splits = a.num_splits + (tail ? 1 : 0);
  const int group = a.num_q_heads / a.num_kv_heads;
  const int tiles = (group + GT - 1) / GT;
  const int slabs = head_dim_slabs(hd);
  const dim3 grid(a.batch, a.num_kv_heads * tiles * slabs);
  cudaError_t err;
  if constexpr (SLAB) {
    constexpr size_t smem = DecodeSlabSmem<C, GT>::bytes;
    auto kernel = paged_decode_slab_kernel<T, C, GT>;
    static const cudaError_t attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (attr != cudaSuccess) return attr;
    kernel<<<dim3(grid.x, grid.y, a.num_splits), kDecodeThreads, smem,
             a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const C*>(a.k),
        static_cast<const C*>(a.v), static_cast<const float*>(a.ks),
        static_cast<const float*>(a.vs), static_cast<const int*>(a.pt),
        static_cast<const int*>(a.kv_lens), static_cast<T*>(a.out),
        static_cast<float*>(a.partials), a.num_q_heads, group, tiles,
        a.num_pages, a.page_size, a.max_pages, part_splits,
        a.chunks_per_split, a.layer, hd, slabs);
  } else {
    constexpr size_t smem = DecodeSmem<C, D, GT>::bytes;
    auto kernel = paged_decode_kernel<T, C, D, GT>;
    static const cudaError_t attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (attr != cudaSuccess) return attr;
    kernel<<<dim3(grid.x, grid.y, a.num_splits), kDecodeThreads, smem,
             a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const C*>(a.k),
        static_cast<const C*>(a.v), static_cast<const float*>(a.ks),
        static_cast<const float*>(a.vs), static_cast<const int*>(a.pt),
        static_cast<const int*>(a.kv_lens), static_cast<T*>(a.out),
        static_cast<float*>(a.partials), a.num_q_heads, group, tiles,
        a.num_pages, a.page_size, a.max_pages, part_splits,
        a.chunks_per_split, a.layer, hd);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || part_splits == 1) return err;
  if (tail) {
    paged_decode_tail_kernel<T, D, GT, SLAB>
        <<<grid, kDecodeThreads, 0, a.stream>>>(
            static_cast<const T*>(a.q), static_cast<const T*>(a.k_tail),
            static_cast<const T*>(a.v_tail),
            static_cast<const int*>(a.kv_lens),
            static_cast<const int*>(a.q_pos),
            static_cast<float*>(a.partials), a.num_q_heads, group, tiles,
            a.num_kv_heads, a.tail_len, part_splits, hd, slabs);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  paged_decode_merge_kernel<T, D, GT, SLAB><<<grid, GT * D, 0, a.stream>>>(
      static_cast<const float*>(a.partials), static_cast<T*>(a.out),
      a.num_q_heads, group, tiles, part_splits, hd, slabs);
  return cudaGetLastError();
}

// The launch at the group tile group_tile() picks (a tile wider than
// max_group_tile(D) is never built).
template <typename T, typename C, int D, bool SLAB>
int launch_tiled(const DecodeArgs& a) {
  const int gt = group_tile(a.num_q_heads / a.num_kv_heads, D);
  if (gt == 1) return launch<T, C, D, 1, SLAB>(a);
  if constexpr (max_group_tile(D) == 2) {
    if (gt == 2) return launch<T, C, D, 2, SLAB>(a);
  }
  if constexpr (max_group_tile(D) >= 4) {
    if (gt == 4) return launch<T, C, D, 4, SLAB>(a);
  }
  if constexpr (max_group_tile(D) >= 8) {
    if (gt == 8) return launch<T, C, D, 8, SLAB>(a);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// The slab walk's launch (head dims above kMaxHeadDim) at query type T
// over cache C: paged_decode_slab_{bf16,f16,f32}.cu define it
// (PSTT_DECODE_SLAB_LAUNCH), so the slab kernels compile in sources of
// their own, beside the tile kernels and not after them.
template <typename T, typename C>
int decode_slab_launch(const DecodeArgs& args);

namespace {

// One line of PSTT_FOR_EACH_GEOMETRY: the tile's launch, or the slab
// walk's in its own source.
template <typename T, typename C, int D, bool SLABS>
int decode_case(const DecodeArgs& args) {
  if constexpr (SLABS)
    return decode_slab_launch<T, C>(args);
  else
    return launch_tiled<T, C, D, false>(args);
}

}  // namespace

// The launch of one query type (the dtype code's T) at any cache type
// and head-dim tile of PSTT_FOR_EACH_GEOMETRY: paged_decode_{bf16,f16,
// f32}.cu instantiate the kernels a query type each, so the three
// compile in parallel. cudaErrorInvalidValue for a cache dtype or head
// dim the list lacks.
int decode_launch_bf16(const DecodeArgs& args, int cache_dtype);
int decode_launch_f16(const DecodeArgs& args, int cache_dtype);
int decode_launch_f32(const DecodeArgs& args, int cache_dtype);

}  // namespace pstt

// The body of a paged_decode_slab_<type>.cu: the slab launch of query
// type T over cache C.
#define PSTT_DECODE_SLAB_LAUNCH(T, C)                                     \
  template <>                                                             \
  int pstt::decode_slab_launch<T, C>(const pstt::DecodeArgs& args) {      \
    return pstt::launch_tiled<T, C, pstt::kSlabDim, true>(args);          \
  }

// The body of a decode_launch_<type>: one case a line of the type's
// list, at the head dim's tile, the slab walk above kMaxHeadDim.
#define PSTT_DECODE_CASE(code, T, ccode, C, D, SLABS)                    \
  if (cache_dtype == ccode && pstt::head_dim_tile(args.head_dim) == D &&  \
      (pstt::head_dim_slabs(args.head_dim) > 1) == SLABS)                 \
    return pstt::decode_case<T, C, D, SLABS>(args);
