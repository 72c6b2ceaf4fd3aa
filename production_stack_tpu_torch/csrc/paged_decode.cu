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
//     range for all G query heads of its kv head (each KV byte is read
//     from device memory once a step) and, with more than one split,
//     writes its partial (acc[G][D], m, l) in f32 to scratch, which a
//     second small kernel merges in split order: no float atomics, the
//     same bits every launch. With one split the walk kernel writes the
//     output itself. The split comes from host-known shapes only; a
//     block whose range starts at or past its row's kv_len loads
//     nothing and writes the empty partial (0, -1e30, 0), and a row
//     whose every split is empty (a pad row) merges to exact 0.
//   - Bytes in flight the whole time: a chunk's K and V pages stage as
//     they lie in device memory, in the cache's own type (bf16, f32 or
//     int8 plus its scales), through two stages of 16-byte cp.async, so
//     chunk c + 1 arrives while chunk c is used. Nothing is expanded to
//     f32 in shared memory: 64 KB of stages a block at bf16 (32 KB at
//     int8), three blocks an SM.
//
// The arithmetic stays under the copy with plain f32 FMA: thread
// (token group, head-dim quarter) of 128 reads 4 adjacent tokens of one
// head dim as one 4-, 8- or 16-byte word and shares it between the G
// query heads (16 FMAs a load at G = 4). A swizzle of the row offset by
// head dim keeps the four quarters of a warp on different banks. Each
// warp runs its own online softmax over its 32 tokens of every chunk in
// registers and shuffles; the four warps merge once, at the end of the
// walk. An int8 cache folds its scales in the Pallas order.
//
// C interface (loaded with ctypes by ops/paged_kv_common.py):
//   q [B, num_q_heads, D]; k/v cache [kv_heads, num_pages, D, page_size],
//   or the stacked [L, kv_heads, num_pages, D, page_size] cache read at
//   `layer`; k/v scale [(L,) kv_heads, num_pages, page_size] f32 for an
//   int8 cache, else null; page_table [B, max_pages] int32; kv_lens [B]
//   int32; out [B, num_q_heads, D]; partials: f32 scratch [B, kv_heads,
//   num_splits, G, D + 2] (null with one split); dtype (q, out) 0 =
//   bf16, 1 = f32; cache_dtype 0 = bf16, 1 = f32, 2 = int8;
//   layer_stride / scale_layer_stride: elements between two layers of
//   the data / the scales (the per-layer form is layer 0 with strides 0).
// Launches on `stream`, allocates nothing, does not synchronise, and
// returns cudaGetLastError() after the launch. Geometries outside
// PSTT_FOR_EACH_GEOMETRY return cudaErrorInvalidValue;
// pstt_kernel_supports(dtype, cache_dtype, group, head_dim) tells the
// host first.

#include "paged_kv_common.cuh"

namespace pstt {
namespace {

constexpr int kDecodeThreads = 128;
constexpr int kDecodeWarps = kDecodeThreads / 32;
constexpr int kTok = 4;  // adjacent tokens a thread owns in a chunk
constexpr int kDQ = 4;   // head-dim quarters: thread dq owns d = dq + 4 i
static_assert(kDecodeWarps * (32 / kDQ) * kTok == kChunk,
              "the threads' tokens must tile the chunk");

// Shared memory of one block, in bytes: two stages of the chunk's K and
// V planes in the cache's type (and of its scales), q as f32, and the
// warps' partials for the merge at the end.
template <typename C, int D, int G>
struct DecodeSmem {
  static constexpr bool kQuant = kQuantized<C>;
  static constexpr int kRow = kChunk * (int)sizeof(C);
  static constexpr int kPlane = D * kRow;
  static constexpr int kScale = kQuant ? kChunk * 4 : 0;
  static constexpr int kPart = G * (D + 2) * 4;  // acc[G][D], m, l
  static constexpr int stages = 0;               // [2][2][kPlane]
  static constexpr int scales = stages + 2 * 2 * kPlane;  // [2][2][kChunk]
  static constexpr int q = scales + 2 * 2 * kScale;       // [D][G] f32
  static constexpr int parts = q + D * G * 4;    // [kDecodeWarps][kPart]
  static constexpr int bytes = parts + kDecodeWarps * kPart;
};

// Byte offset of (head dim d, chunk token col) in a staged plane. The
// four head dims d..d+3 a warp reads together land on different banks:
// each quarter's 8 lanes read one 32 * sizeof(C)-byte window of a row.
template <typename C>
__device__ __forceinline__ uint32_t plane_offset(int d, int col) {
  const uint32_t swz = ((uint32_t)(d & 3) * 32u * sizeof(C)) & 127u;
  return (uint32_t)d * (kChunk * sizeof(C)) +
         (((uint32_t)col * sizeof(C)) ^ swz);
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
                                          float (&f)[4], int8_t) {
  const char4 x = *reinterpret_cast<const char4*>(p);
  f[0] = (float)x.x;
  f[1] = (float)x.y;
  f[2] = (float)x.z;
  f[3] = (float)x.w;
}

// Where block (b, h, split) writes, and the merge reads, its partial.
template <int D, int G>
__device__ __forceinline__ size_t partial_offset(int b, int h, int kv_heads,
                                                 int num_splits, int split) {
  return (((size_t)b * kv_heads + h) * num_splits + split) * (G * (D + 2));
}

template <typename T, typename C, int D, int G>
__global__ void __launch_bounds__(kDecodeThreads)
paged_decode_kernel(const T* __restrict__ q, const C* __restrict__ k_cache,
                    const C* __restrict__ v_cache,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int* __restrict__ page_table,
                    const int* __restrict__ kv_lens, T* __restrict__ out,
                    float* __restrict__ partials, int num_q_heads,
                    int num_pages, int page_size, int max_pages,
                    int num_splits, int chunks_per_split,
                    LayerOffsets layer) {
  constexpr bool QUANT = kQuantized<C>;
  constexpr int NT = kDecodeThreads;
  constexpr int DI = D / kDQ;  // head dims a thread owns
  constexpr int PW = D + 2;    // words of one query head's partial
  using L = DecodeSmem<C, D, G>;
  extern __shared__ uint4 smem_decode[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem_decode);
  const uint32_t base = smem_u32(smem);
  float* qs = reinterpret_cast<float*>(smem + L::q);
  float* parts = reinterpret_cast<float*>(smem + L::parts);

  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int split = blockIdx.z;
  const int tid = threadIdx.x;
  const int kv_len = kv_lens[b];
  const int n_chunks = (kv_len + kChunk - 1) / kChunk;
  const int c_begin = split * chunks_per_split;
  const int c_end = min(c_begin + chunks_per_split, n_chunks);
  // Where the G query heads of this kv head start in q and out.
  const size_t row_offset = ((size_t)b * num_q_heads + (size_t)h * G) * D;
  T* o = out + row_offset;
  float* part =
      num_splits > 1
          ? partials + partial_offset<D, G>(b, h, gridDim.y, num_splits, split)
          : nullptr;

  if (c_begin >= c_end) {
    // Nothing of this row lies in the range: no load. One split: the
    // row is a pad row and its output is exact 0.
    if (num_splits == 1) {
      for (int i = tid; i < G * D; i += NT) o[i] = from_f32<T>(0.f);
    } else {
      for (int i = tid; i < G * PW; i += NT)
        part[i] = (i % PW == D) ? kNegInf : 0.f;
    }
    return;
  }

  const size_t head_elems = (size_t)num_pages * D * page_size;
  const size_t head_slots = (size_t)num_pages * page_size;
  const C* k_head = k_cache + layer.data() + h * head_elems;
  const C* v_head = v_cache + layer.data() + h * head_elems;
  const float* ks_head =
      QUANT ? k_scale + layer.scale() + h * head_slots : nullptr;
  const float* vs_head =
      QUANT ? v_scale + layer.scale() + h * head_slots : nullptr;
  const int* pt_row = page_table + (size_t)b * max_pages;
  const int pages_live = min((kv_len + page_size - 1) / page_size, max_pages);

  // Start the copies of chunk c into stage st.
  auto start_copies = [&](int c, int st) {
    stage_chunk_async<C, D, NT>(
        k_head, v_head, pt_row, c, pages_live, page_size,
        base + L::stages + (st * 2 + 0) * L::kPlane,
        base + L::stages + (st * 2 + 1) * L::kPlane,
        [](int d, int col) { return plane_offset<C>(d, col); });
    if constexpr (QUANT)
      stage_scales_async<NT>(ks_head, vs_head, pt_row, c, pages_live,
                             page_size,
                             base + L::scales + (st * 2 + 0) * L::kScale,
                             base + L::scales + (st * 2 + 1) * L::kScale);
    cp_async_commit();
  };
  start_copies(c_begin, 0);

  // q of the G query heads, as f32 [D][G]: one broadcast read a head dim.
  for (int i = tid; i < G * D; i += NT) {
    const int g = i / D;
    const int d = i - g * D;
    qs[d * G + g] = to_f32(q[row_offset + i]);
  }

  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int dq = lane & (kDQ - 1);
  const int tok0 = (warp * (32 / kDQ) + lane / kDQ) * kTok;  // in the chunk
  const float scale = rsqrtf((float)D);

  float m[G], l[G], acc[G][DI];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < DI; ++i) acc[g][i] = 0.f;
  }

  for (int c = c_begin; c < c_end; ++c) {
    const int st = (c - c_begin) & 1;
    // Start chunk c + 1 into the stage chunk c - 1 left (its readers
    // passed the barrier that ended that iteration), wait for chunk c.
    if (c + 1 < c_end) {
      start_copies(c + 1, st ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const unsigned char* kp = smem + L::stages + (st * 2 + 0) * L::kPlane;
    const unsigned char* vp = smem + L::stages + (st * 2 + 1) * L::kPlane;
    const float* kss =
        reinterpret_cast<const float*>(smem + L::scales) + (st * 2) * kChunk;
    const float* vss = kss + kChunk;

    // Partial scores of this thread's 4 tokens over its head dims.
    float s[G][kTok];
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int x = 0; x < kTok; ++x) s[g][x] = 0.f;
#pragma unroll
    for (int i = 0; i < DI; ++i) {
      const int d = dq + kDQ * i;
      float kf[kTok];
      load_tok4(kp + plane_offset<C>(d, tok0), kf, C());
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float qv = qs[d * G + g];
#pragma unroll
        for (int x = 0; x < kTok; ++x) s[g][x] = fmaf(qv, kf[x], s[g][x]);
      }
    }
    // Sum the four quarters: every lane of a quad then holds the scores.
#pragma unroll
    for (int g = 0; g < G; ++g)
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
    for (int g = 0; g < G; ++g) {
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

    // acc += p . v over this thread's tokens and head dims.
#pragma unroll
    for (int i = 0; i < DI; ++i) {
      const int d = dq + kDQ * i;
      float vf[kTok];
      load_tok4(vp + plane_offset<C>(d, tok0), vf, C());
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int x = 0; x < kTok; ++x)
          acc[g][i] = fmaf(s[g][x], vf[x], acc[g][i]);
    }
    __syncthreads();  // stage st is free again
  }

  // The warp's totals: sum acc and l over its 8 token groups (l was
  // summed per thread; the four quarters of a group hold the same l).
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int o2 = kDQ; o2 < 32; o2 <<= 1) {
      l[g] += __shfl_xor_sync(0xffffffffu, l[g], o2);
#pragma unroll
      for (int i = 0; i < DI; ++i)
        acc[g][i] += __shfl_xor_sync(0xffffffffu, acc[g][i], o2);
    }
  }
  if (lane < kDQ) {
    float* mine = parts + warp * (G * PW);
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int i = 0; i < DI; ++i) mine[g * PW + dq + kDQ * i] = acc[g][i];
      if (lane == 0) {
        mine[g * PW + D] = m[g];
        mine[g * PW + D + 1] = l[g];
      }
    }
  }
  __syncthreads();

  // Merge the four warps in warp order; write the output (one split)
  // or this block's partial.
  for (int i = tid; i < G * D; i += NT) {
    const int g = i / D;
    const int d = i - g * D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kDecodeWarps; ++w)
      mx = fmaxf(mx, parts[w * (G * PW) + g * PW + D]);
    float tot = 0.f, tot_l = 0.f;
#pragma unroll
    for (int w = 0; w < kDecodeWarps; ++w) {
      const float* pw = parts + w * (G * PW) + g * PW;
      const float e = expf(pw[D] - mx);
      tot = fmaf(e, pw[d], tot);
      tot_l = fmaf(e, pw[D + 1], tot_l);
    }
    if (num_splits == 1) {
      o[i] = from_f32<T>(tot / fmaxf(tot_l, 1e-30f));
    } else {
      part[g * PW + d] = tot;
      if (d == 0) {
        part[g * PW + D] = mx;
        part[g * PW + D + 1] = tot_l;
      }
    }
  }
}

// Merge the splits' partials of one (row, kv head) pair in split order:
// thread (g, d) of G * D. A row whose every split is empty has m =
// -1e30 and l = 0 everywhere: weights exp(0) = 1 over zeros, exact 0.
template <typename T, int D, int G>
__global__ void __launch_bounds__(G* D)
paged_decode_merge_kernel(const float* __restrict__ partials,
                          T* __restrict__ out, int num_q_heads,
                          int num_splits) {
  constexpr int PW = D + 2;
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int g = threadIdx.x / D;
  const int d = threadIdx.x - g * D;
  const float* p =
      partials + partial_offset<D, G>(b, h, gridDim.y, num_splits, 0) + g * PW;
  float mx = kNegInf;
  for (int s = 0; s < num_splits; ++s)
    mx = fmaxf(mx, p[(size_t)s * (G * PW) + D]);
  float tot = 0.f, tot_l = 0.f;
  for (int s = 0; s < num_splits; ++s) {
    const float* ps = p + (size_t)s * (G * PW);
    const float e = expf(ps[D] - mx);
    tot = fmaf(e, ps[d], tot);
    tot_l = fmaf(e, ps[D + 1], tot_l);
  }
  out[((size_t)b * num_q_heads + (size_t)h * G + g) * D + d] =
      from_f32<T>(tot / fmaxf(tot_l, 1e-30f));
}

template <typename T, typename C, int D, int G>
int launch(const void* q, const void* k, const void* v, const void* ks,
           const void* vs, const void* pt, const void* kv_lens, void* out,
           void* partials, int batch, int num_q_heads, int num_kv_heads,
           int num_pages, int page_size, int max_pages, int num_splits,
           int chunks_per_split, LayerOffsets layer, cudaStream_t stream) {
  if (kQuantized<C> && (ks == nullptr || vs == nullptr))
    return cudaErrorInvalidValue;
  constexpr size_t smem = DecodeSmem<C, D, G>::bytes;
  auto kernel = paged_decode_kernel<T, C, D, G>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return attr;
  kernel<<<dim3(batch, num_kv_heads, num_splits), kDecodeThreads, smem,
           stream>>>(
      static_cast<const T*>(q), static_cast<const C*>(k),
      static_cast<const C*>(v), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(pt),
      static_cast<const int*>(kv_lens), static_cast<T*>(out),
      static_cast<float*>(partials), num_q_heads, num_pages, page_size,
      max_pages, num_splits, chunks_per_split, layer);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || num_splits == 1) return err;
  paged_decode_merge_kernel<T, D, G>
      <<<dim3(batch, num_kv_heads), G * D, 0, stream>>>(
          static_cast<const float*>(partials), static_cast<T*>(out),
          num_q_heads, num_splits);
  return cudaGetLastError();
}

}  // namespace
}  // namespace pstt

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
  if (num_kv_heads <= 0 || num_q_heads % num_kv_heads ||
      page_size <= 0 || pstt::kChunk % page_size || layer < 0 ||
      layer_stride < 0 || scale_layer_stride < 0 || num_splits < 1 ||
      chunks_per_split < 1 || (num_splits > 1 && partials == nullptr))
    return cudaErrorInvalidValue;
  const pstt::LayerOffsets offsets{layer, layer_stride, scale_layer_stride};
  if (batch == 0) return cudaSuccess;
  const int group = num_q_heads / num_kv_heads;
  auto s = static_cast<cudaStream_t>(stream);
#define PSTT_DECODE_CASE(code, T, ccode, C, G, D)                          \
  if (dtype == code && cache_dtype == ccode && group == G &&               \
      head_dim == D)                                                       \
    return pstt::launch<T, C, D, G>(                                       \
        q, k, v, k_scale, v_scale, page_table, kv_lens, out, partials,     \
        batch, num_q_heads, num_kv_heads, num_pages, page_size, max_pages, \
        num_splits, chunks_per_split, offsets, s);
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
