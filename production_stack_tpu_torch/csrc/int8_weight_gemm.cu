// int8_weight_matmul: y[M, N] = (x[M, K] . q[N, K]^T) * scale[N], the
// weight-only int8 projection of a decode-sized step (M <= the host's
// INT8_KERNEL_MAX_ROWS = 160).
//
// Counterpart of the JAX package's dequantizing matmul
// (engine/quantization.py dequant_matmul, ``(x @ q.astype(x.dtype)) *
// scale``), which XLA fuses into one dot whose int8 operand is
// converted on the way in, so only int8 weight bytes cross HBM. It is
// not a Pallas kernel; the port writes it by hand because the plain
// torch form materialises a 16-bit copy of every weight on every call.
//
// What bounds it on the card: the weight bytes. At M = 32 a product
// does 2 * M = 64 operations per int8 byte of q, far below the ~295 at
// which the H100's bf16 tensor cores and not its memory become the
// limit; at M = 160 (320 a byte) it sits at that ridge. The matrices
// are small (4 to 23 MB), so what the card waits for is latency: the
// time to the first bytes, bytes kept in flight, and the fixed cost of
// a launch. The 16-bit kernel (bf16 or f16 x, w8_wgmma_kernel) is built
// for that:
//
//   - One launch a product, no f32 partials in device memory. A tile
//     of 64 W weight rows (W consumer warpgroups, 1 to 4) is split over
//     K between the C blocks (1 to 8) of one thread block cluster
//     (cudaLaunchKernelEx with the cluster dimension): rank r walks the
//     stages [r per, (r + 1) per) of K. The blocks' f32 partial tiles
//     meet through distributed shared memory (mapa, st/ld.shared::
//     cluster), each activation row summed by one rank, adding the C
//     partials in rank order, scaling in f32 (the tile's scales fetched
//     into shared memory while the ring fills), rounding once and
//     writing four outputs a store. Up to 16 activation rows
//     (kPushMaxBucket) each block pushes its accumulators to the summing
//     ranks, into shared memory beside the ring, as soon as it is done:
//     one cluster barrier, then local reads (reduce_rows). Above, where
//     those partials would crowd the ring, each block leaves its tile in
//     its drained ring and the summing ranks read it after a barrier,
//     with a second barrier before any block leaves (reduce_slice);
//     pushing there measured slower on an H100. No atomics: the same
//     bits on every launch.
//   - A ring of shared-memory stages of 128 k values, filled with TMA
//     by a producer warp: the weight tile [128 k][64 W rows] int8 and
//     the activations [128 k][NB rows] T (two boxes of 64), both in the
//     128-byte swizzle, completing on a `full` mbarrier a stage; the
//     consumers free a stage on its `empty` mbarrier. The warp's lanes
//     make the slots' barriers together, then one thread copies the
//     stages in order (stages copied at once from several lanes landed
//     together, the first as late as the last). The tensor maps are encoded on the host at each launch
//     (cuTensorMapEncodeTiled through cudaGetDriverEntryPoint: no
//     -lcuda); past K, past N and past M the copy fills zeros, so any K
//     that is a multiple of 16 (the maps' 16-byte row stride) runs and
//     a K tail inside a stage adds nothing. The ring is as deep as 227
//     KB allows (at most 16 stages), so a block's K range is in flight
//     from the start.
//   - wgmma with A from registers: a consumer warpgroup owns 64 weight
//     rows and runs out^T = q . x^T as m64nNBk16, A the weights (each
//     thread reads its m16n8k16 fragment from the swizzled stage, two
//     4-byte loads a row a k step, and converts it exactly in
//     registers, four instructions a pair: i8_pair), B the activations
//     through a shared-memory descriptor (K-major, 128-byte swizzle),
//     the sum in f32 registers. A stage is two groups of four k steps (one
//     activation box each); a group's products run while the next
//     group converts (two register buffers, wgmma_wait<1>).
//   - NB, the activation rows rounded up to a bucket: 8, 16, 32, 64,
//     128 or 160 (PSTT_W8_FOR_EACH_BUCKET; ops/int8_matmul_cuda.
//     W8_BUCKETS). W is at most 4 (3 at NB 128 and 160, where NB / 2
//     accumulators a thread leave no room for a fourth warpgroup's
//     registers; at 13 warps a thread has 128 registers, and ptxas
//     serializes the NB 160 instances' wgmma for want of more, C7512).
//   - The plan (W, C, the ring's depth, the stages a rank and the
//     shared-memory bytes) comes from the host (ops/int8_matmul_cuda.
//     int8_weight_plan, from shapes alone: the most blocks that fit one
//     wave of the H100's clusters, then W nearest 2, then the smallest
//     cluster); the entry point refuses a plan it was not built for and
//     corrects none.
//
// The sum is f32, the scale is applied in f32 and the result is rounded
// once to the output type, as the plain version
// (ops/int8_matmul_cuda.int8_weight_matmul_plain) computes it. An f32
// activation (the tiny test geometry) takes an f32 FMA kernel instead:
// a warp a weight row, lanes over K, a fixed shuffle reduction.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <cudaTypedefs.h>

#include <stdint.h>
#include <type_traits>

#include "mbarrier.cuh"
#include "wgmma.cuh"

namespace pstt_w8 {

using pstt::fence_mbar_init;
using pstt::mbar_arrive;
using pstt::mbar_arrive_expect_tx;
using pstt::mbar_init;
using pstt::mbar_wait;
using pstt::tma_load_2d;
using pstt::wg_desc;
using pstt::Wgmma;

constexpr int kStageK = 128;     // k values a ring stage holds
constexpr int kWgRows = 64;      // weight rows a consumer warpgroup
constexpr int kMaxCluster = 8;   // blocks a cluster (the portable limit)
constexpr int kMaxRing = 16;     // stages of the ring
constexpr int kMaxSmem = 232448;  // a block's shared memory on an H100
constexpr int kRedPad = 4;       // f32 padding of a partial tile's rows
constexpr int kScaleBytes = 4 * 4 * kWgRows;  // the tile's scales, f32
constexpr int kFmaWarps = 8;  // f32 kernel: weight rows a block
constexpr int kFmaRows = 8;   // f32 kernel: activation rows a block

// Consumer warpgroups a block may have at the bucket nb.
__host__ __device__ constexpr int max_warpgroups(int nb) {
  return nb >= 128 ? 3 : 4;
}
__host__ __device__ constexpr int max_threads(int nb) {
  return 128 * max_warpgroups(nb) + 32;
}

// Buckets up to this one push their partials to the rank that sums
// them, into shared memory beside the ring; larger ones leave them in
// their own drained ring, where the summing ranks read them.
constexpr int kPushMaxBucket = 16;

// The bytes of one ring stage (the weight tile, then the activations'
// two boxes), of the partials a rank receives when they are pushed
// (from each of the C ranks, its ceil(nb / C) activation rows of
// [64 w + kRedPad] f32) or of the block's own partial tile when they
// are read ([nb][64 w + kRedPad] f32), and of the whole block: the
// barriers, the tile's scales, the slack to a 1024-byte swizzle atom,
// then the ring and the pushed partials beside it, or the larger of the
// ring and the partial tile over it.
__host__ __device__ constexpr int stage_bytes(int nb, int w) {
  return kWgRows * w * kStageK + nb * kStageK * 2;
}
__host__ __device__ constexpr int recv_bytes(int nb, int w, int c) {
  return c * ((nb + c - 1) / c) * (kWgRows * w + kRedPad) * 4;
}
__host__ __device__ constexpr int tile_bytes(int nb, int w) {
  return nb * (kWgRows * w + kRedPad) * 4;
}
__host__ __device__ constexpr int smem_bytes(int nb, int w, int ring,
                                             int c) {
  return 16 * ring + kScaleBytes + 1024 +
         (nb <= kPushMaxBucket
              ? ring * stage_bytes(nb, w) + recv_bytes(nb, w, c)
              : (ring * stage_bytes(nb, w) > tile_bytes(nb, w)
                     ? ring * stage_bytes(nb, w)
                     : tile_bytes(nb, w)));
}

// One launch's operands (the kernel's parameter; the maps are read by
// TMA from the parameter space).
struct Params {
  CUtensorMap wmap;  // q [N, K] int8: boxes of [128 k][64 W rows]
  CUtensorMap xmap;  // x [M, K] T: boxes of [64 k][NB rows]
  const float* scale;
  void* out;
  int M, N, K;
  int stages;  // ceil(K / kStageK)
  int per;     // stages a cluster rank
  int ring;    // stages of the ring
};

__device__ __forceinline__ __nv_bfloat16 round_to(float x, __nv_bfloat16) {
  return __float2bfloat16_rn(x);
}
__device__ __forceinline__ __half round_to(float x, __half) {
  return __float2half_rn(x);
}


// Two int8 of the word w (its bytes that `sel` places in the low bytes
// of the two 16-bit halves, 0x4140 for bytes 0 and 1, 0x4342 for 2 and
// 3) to a pair of T, exactly, in four instructions:
//   bf16: b = r - 128 s (s its sign bit, r its low seven bits); the bf16
//   words 0x4300 | r (128 + r) and 0x4300 | s << 7 (128 + 128 s) are
//   exact, and so is their difference (|b| <= 128).
//   f16: b + 128 in the low mantissa byte of 1024 (0x6400 | b ^ 0x80),
//   less 1152 (0x6480), is b.
template <typename T>
__device__ __forceinline__ uint32_t i8_pair(uint32_t w, uint32_t sel) {
  uint32_t d;
  if constexpr (std::is_same<T, __half>::value) {
    const uint32_t t = __byte_perm(w ^ 0x80808080u, 0x64646464u, sel);
    asm("sub.rn.f16x2 %0, %1, %2;\n" : "=r"(d) : "r"(t), "r"(0x64806480u));
  } else {
    const uint32_t t = __byte_perm(w, 0u, sel);
    asm("sub.rn.bf16x2 %0, %1, %2;\n"
        : "=r"(d)
        : "r"((t & 0x007f007fu) | 0x43004300u),
          "r"((t & 0x00800080u) | 0x43004300u));
  }
  return d;
}

__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ void sts32(uint32_t addr, float v) {
  asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(addr), "f"(v) : "memory");
}

__device__ __forceinline__ float4 lds128(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr));
  return v;
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_blocks() {
  uint32_t n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(n));
  return n;
}

// Every thread of every block of the cluster: writes before it are
// visible to reads after it, across the cluster's shared memory.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release;\n"
      "barrier.cluster.wait.acquire;\n" ::
          : "memory");
}

// Four f32 of block `rank`'s shared memory at this block's offset `addr`.
__device__ __forceinline__ float4 ld_cluster4(uint32_t addr, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(addr), "r"(rank));
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(remote)
               : "memory");
  return v;
}

// One f32 into block `rank`'s shared memory at this block's offset
// `addr` (distributed shared memory; the block's own included).
__device__ __forceinline__ void st_cluster(uint32_t addr, uint32_t rank,
                                           float v) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(addr), "r"(rank));
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(remote), "f"(v)
               : "memory");
}

// The rounded T of four f32, packed for one 8-byte store.
template <typename T>
__device__ __forceinline__ uint2 pack4(const float (&v)[4]) {
  const T a = round_to(v[0], T()), b = round_to(v[1], T()),
          c = round_to(v[2], T()), d = round_to(v[3], T());
  uint2 u;
  u.x = static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(&a)) |
        static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(&b)) << 16;
  u.y = static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(&c)) |
        static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(&d)) << 16;
  return u;
}

// A rank's slice of the cluster's sum. The cluster's threads cover the
// tile as (activation row m, group of four weight rows cg): thread t of
// the cluster (rank r, t = r blockDim + tid) takes group t % groups of
// rows t / groups + i rows_a_pass; each element is the C partials at the
// same offset of every rank's shared memory added in rank order, scaled
// and rounded once. The loads of 8 / C rows are in flight together.
template <int C, typename T>
__device__ __forceinline__ void reduce_slice(T* out, const float* scales,
                                             uint32_t base, int rstride,
                                             int M, int N, int n0, int TR,
                                             int rank) {
  constexpr int U = kMaxCluster / C;
  const int groups = TR / 4;
  const int rows_a_pass = C * static_cast<int>(blockDim.x) / groups;
  const int t = rank * static_cast<int>(blockDim.x) + threadIdx.x;
  if (t >= rows_a_pass * groups) return;
  const int n = (t % groups) * 4;
  const bool whole = N % 4 == 0 && n0 + n + 4 <= N;
  for (int m0 = t / groups; m0 < M; m0 += U * rows_a_pass) {
    float4 v[U][C];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int m = m0 + u * rows_a_pass;
      if (m < M) {
        const uint32_t off = base + (m * rstride + n) * 4;
#pragma unroll
        for (int r = 0; r < C; ++r) v[u][r] = ld_cluster4(off, r);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int m = m0 + u * rows_a_pass;
      if (m >= M) break;
      float4 sum = v[u][0];
#pragma unroll
      for (int r = 1; r < C; ++r) {
        sum.x += v[u][r].x;
        sum.y += v[u][r].y;
        sum.z += v[u][r].z;
        sum.w += v[u][r].w;
      }
      const float vals[4] = {sum.x * scales[n], sum.y * scales[n + 1],
                             sum.z * scales[n + 2], sum.w * scales[n + 3]};
      T* row = out + static_cast<size_t>(m) * N + n0 + n;
      if (whole) {
        *reinterpret_cast<uint2*>(row) = pack4<T>(vals);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (n0 + n + e < N) row[e] = round_to(vals[e], T());
      }
    }
  }
}

// This rank's `count` rows of the cluster's sum (activation rows m0 +
// r), from the partials it received ([C][rows][TR + kRedPad] f32 at
// `recv`): thread t of the block takes the group of four weight rows
// t % groups of rows t / groups + i rows_a_pass; each element is the C
// partials added in rank order, scaled and rounded once.
template <typename T>
__device__ __forceinline__ void reduce_rows(T* out, const float* scales,
                                            uint32_t recv, int rstride,
                                            int C, int rows, int count,
                                            int m0, int N, int n0, int TR) {
  const int groups = TR / 4;
  const int rows_a_pass = static_cast<int>(blockDim.x) / groups;
  const int t = threadIdx.x;
  if (t >= rows_a_pass * groups) return;
  const int n = (t % groups) * 4;
  const bool whole = N % 4 == 0 && n0 + n + 4 <= N;
  const uint32_t plane = rows * rstride * 4;  // one rank's partials
  for (int r = t / groups; r < count; r += rows_a_pass) {
    const uint32_t off = recv + (r * rstride + n) * 4;
    float4 sum = lds128(off);
    for (int c = 1; c < C; ++c) {
      const float4 v = lds128(off + c * plane);
      sum.x += v.x;
      sum.y += v.y;
      sum.z += v.z;
      sum.w += v.w;
    }
    const float vals[4] = {sum.x * scales[n], sum.y * scales[n + 1],
                           sum.z * scales[n + 2], sum.w * scales[n + 3]};
    T* row = out + static_cast<size_t>(m0 + r) * N + n0 + n;
    if (whole) {
      *reinterpret_cast<uint2*>(row) = pack4<T>(vals);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (n0 + n + e < N) row[e] = round_to(vals[e], T());
    }
  }
}

// One block: W = (blockDim.x - 32) / 128 consumer warpgroups over the
// tile's 64 W weight rows and every activation row (NB, rows >= M read
// as zeros and are never written), and a producer warp; the stages
// [rank per, (rank + 1) per) of K; then the cluster's sum of its slice.
template <typename T, int NB>
__global__ void __launch_bounds__(max_threads(NB), 1)
    w8_wgmma_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) unsigned char w8_smem[];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int W = (blockDim.x - 32) >> 7;
  const int TR = kWgRows * W;
  const uint32_t raw =
      static_cast<uint32_t>(__cvta_generic_to_shared(w8_smem));
  const uint32_t full = raw;
  const uint32_t empty = raw + 8 * p.ring;
  float* scales = reinterpret_cast<float*>(w8_smem + 16 * p.ring);
  const uint32_t base = (raw + 16 * p.ring + kScaleBytes + 1023) & ~1023u;
  const uint32_t sbytes = stage_bytes(NB, W);
  const uint32_t wbytes = TR * kStageK;  // the stage's weight tile
  const uint32_t C = cluster_blocks();
  const uint32_t rank = cluster_rank();
  const int n0 = (blockIdx.x / C) * TR;
  const int s0 = rank * p.per;
  const int mine = min(p.per, p.stages - s0);

  // Stage j of this rank into its ring slot (the producer thread).
  auto issue = [&](int j) {
    const int slot = j % p.ring;
    const uint32_t st = base + slot * sbytes;
    const uint32_t bar = full + 8 * slot;
    const int k = (s0 + j) * kStageK;
    mbar_arrive_expect_tx(bar, sbytes);
    tma_load_2d(st, &p.wmap, k, n0, bar);
    tma_load_2d(st + wbytes, &p.xmap, k, 0, bar);
    tma_load_2d(st + wbytes + NB * 128, &p.xmap, k + 64, 0, bar);
  };
  const bool producer = warp == 4 * W;
  if (producer) {
    // Lane i of the producer warp makes slot i's barriers (one thread
    // making them all took a microsecond); then the producer thread
    // fills the ring, stage by stage in order, before the block's first
    // barrier (stages copied at once from several lanes land together,
    // the first as late as the last).
    if (lane < p.ring) {
      mbar_init(full + 8 * lane, 1);
      mbar_init(empty + 8 * lane, 4 * W);
      fence_mbar_init();
      pstt::fence_proxy_async();
    }
    __syncwarp();
    if (lane == 0)
      for (int j = 0; j < min(mine, p.ring); ++j) issue(j);
  }
  __syncthreads();

  const int grp = lane >> 2;
  const int quad = lane & 3;
  const int r0 = (warp >> 2) * kWgRows + (warp & 3) * 16 + grp;
  float acc[NB / 8][4];
  if (producer) {
    // The producer thread keeps the ring full; the warp's other lanes
    // fetch the tile's scales for the epilogue, all loads in flight
    // together.
    if (lane == 0) {
      for (int j = p.ring; j < mine; ++j) {
        mbar_wait(empty + 8 * (j % p.ring), ((j / p.ring) - 1) & 1);
        issue(j);
      }
    } else {
      constexpr int kPer = (4 * kWgRows + 30) / 31;
      float v[kPer];
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        const int i = lane - 1 + 31 * u;
        v[u] = i < TR && n0 + i < p.N ? p.scale[n0 + i] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kPer; ++u)
        if (lane - 1 + 31 * u < TR) scales[lane - 1 + 31 * u] = v[u];
    }
  } else {
#pragma unroll
    for (int i = 0; i < NB / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
    // The zeros in place before the first product is issued.
    pstt::wgmma_fence_regs(acc);
    // Rows r0 and r0 + 8 of the weight tile: 128 bytes a row, the 16-byte
    // chunk of k step kk at (kk ^ (row % 8)) (row % 8 == grp for both).
    // This thread's k pairs 2 quad, +1 and 2 quad + 8, +9 of a step lie
    // in the chunk's words quad / 2 and quad / 2 + 2.
    const uint32_t row0 = r0 * 128 + 4 * (quad >> 1);
    const uint32_t row1 = row0 + 8 * 128;
    const uint32_t sel = (quad & 1) ? 0x4342u : 0x4140u;
    uint32_t a[2][4][4];
    auto release = [&](int j) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * (j % p.ring));
    };
    for (int j = 0; j < mine; ++j) {
      const int slot = j % p.ring;
      mbar_wait(full + 8 * slot, (j / p.ring) & 1);
      const uint32_t st = base + slot * sbytes;
      const uint32_t xs = st + wbytes;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const uint32_t c = ((4 * h + s) ^ grp) << 4;
          a[h][s][0] = i8_pair<T>(lds32(st + row0 + c), sel);
          a[h][s][1] = i8_pair<T>(lds32(st + row1 + c), sel);
          a[h][s][2] = i8_pair<T>(lds32(st + row0 + c + 8), sel);
          a[h][s][3] = i8_pair<T>(lds32(st + row1 + c + 8), sel);
        }
        pstt::wgmma_fence();
#pragma unroll
        for (int s = 0; s < 4; ++s)
          Wgmma<T, NB>::template rs<0>(
              acc, a[h][s], wg_desc(xs + h * NB * 128 + s * 32, 16, 1024),
              1);
        pstt::wgmma_commit();
        // The other group's products are in: its registers are free
        // and, after a stage's last group, its stage.
        pstt::wgmma_wait<1>();
        if (h == 0 && j > 0) release(j - 1);
      }
    }
    pstt::wgmma_wait<0>();
    pstt::wgmma_fence_regs(acc);
    if (mine > 0) release(mine - 1);
  }
  const int rstride = TR + kRedPad;
  if constexpr (NB <= kPushMaxBucket) {
    // Pushed: rank r sums activation rows [r rows, (r + 1) rows) of the
    // tile, rows = ceil(M / C), and receives them from every rank
    // (itself included) as [C][rows][TR + kRedPad] f32 beside the ring,
    // written from the accumulators through distributed shared memory
    // as soon as a block is done; one cluster barrier, then each block
    // reads only its own shared memory.
    const uint32_t recv = base + p.ring * sbytes;
    const int rows = (p.M + C - 1) / C;
    if (warp < 4 * W) {
#pragma unroll
      for (int i = 0; i < NB / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = 8 * i + 2 * quad + (e & 1);
          const int n = r0 + (e >= 2 ? 8 : 0);
          if (m < p.M) {
            const int owner = m / rows;
            st_cluster(
                recv + ((rank * rows + m - owner * rows) * rstride + n) * 4,
                owner, acc[i][e]);
          }
        }
    }
    cluster_sync();
    const int count = min(rows, p.M - static_cast<int>(rank) * rows);
    if (count > 0)
      reduce_rows(static_cast<T*>(p.out), scales, recv, rstride,
                  static_cast<int>(C), rows, count, rank * rows, p.N, n0,
                  TR);
  } else {
    // Read: every block's drained ring takes its partial tile, [m][TR +
    // kRedPad] f32; after a cluster barrier each rank sums its slice
    // from every rank's shared memory, and a second barrier keeps every
    // block until the others have read it.
    __syncthreads();
    if (warp < 4 * W) {
#pragma unroll
      for (int i = 0; i < NB / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = 8 * i + 2 * quad + (e & 1);
          const int n = r0 + (e >= 2 ? 8 : 0);
          if (m < p.M) sts32(base + (m * rstride + n) * 4, acc[i][e]);
        }
    }
    cluster_sync();
    T* out = static_cast<T*>(p.out);
    switch (C) {
#define PSTT_W8_REDUCE(CL)                                                 \
  case CL:                                                                 \
    reduce_slice<CL>(out, scales, base, rstride, p.M, p.N, n0, TR, rank); \
    break;
      PSTT_W8_REDUCE(1) PSTT_W8_REDUCE(2) PSTT_W8_REDUCE(3)
      PSTT_W8_REDUCE(4) PSTT_W8_REDUCE(5) PSTT_W8_REDUCE(6)
      PSTT_W8_REDUCE(7) PSTT_W8_REDUCE(8)
#undef PSTT_W8_REDUCE
    }
    cluster_sync();
  }
}

// f32 activations: a warp a weight row, kFmaRows activation rows a
// block, lanes over K four values at a time; the lanes' sums meet in a
// fixed butterfly.
__global__ void __launch_bounds__(kFmaWarps * 32)
    w8_fma_f32_kernel(const float* __restrict__ x,
                      const int8_t* __restrict__ q,
                      const float* __restrict__ scale,
                      float* __restrict__ out, int M, int N, int K) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * kFmaWarps + warp;
  const int m0 = blockIdx.y * kFmaRows;
  if (n >= N) return;
  float acc[kFmaRows];
#pragma unroll
  for (int r = 0; r < kFmaRows; ++r) acc[r] = 0.f;
  const int8_t* qrow = q + static_cast<size_t>(n) * K;
  for (int k = 4 * lane; k < K; k += 128) {
    const char4 w = *reinterpret_cast<const char4*>(qrow + k);
#pragma unroll
    for (int r = 0; r < kFmaRows; ++r) {
      if (m0 + r >= M) break;
      const float4 v = *reinterpret_cast<const float4*>(
          x + static_cast<size_t>(m0 + r) * K + k);
      float s = acc[r];
      s = fmaf(v.x, static_cast<float>(w.x), s);
      s = fmaf(v.y, static_cast<float>(w.y), s);
      s = fmaf(v.z, static_cast<float>(w.z), s);
      s = fmaf(v.w, static_cast<float>(w.w), s);
      acc[r] = s;
    }
  }
#pragma unroll
  for (int r = 0; r < kFmaRows; ++r)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], off);
  if (lane == 0) {
    for (int r = 0; r < kFmaRows && m0 + r < M; ++r)
      out[static_cast<size_t>(m0 + r) * N + n] = acc[r] * scale[n];
  }
}


// cuTensorMapEncodeTiled from the driver, found once through the
// runtime (the library does not link libcuda).
inline PFN_cuTensorMapEncodeTiled_v12000 encode_fn() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(ptr);
  }
  return fn;
}

// A 2D map of a row-major [rows, cols] matrix, boxes of [box_cols]
// [box_rows] in the 128-byte swizzle, zeros past its edges.
inline bool encode_2d(CUtensorMap* map, CUtensorMapDataType type,
                      const void* ptr, int rows, int cols, int elem_bytes,
                      int box_cols, int box_rows) {
  auto fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {
      static_cast<cuuint64_t>(cols) * static_cast<cuuint64_t>(elem_bytes)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem_strides[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(ptr), dims, strides, box,
            elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int NB>
int launch_wgmma(const void* x, const void* q, const void* scale, void* out,
                 int M, int N, int K, int w, int cluster, int per, int ring,
                 int smem, cudaStream_t stream) {
  Params p;
  const CUtensorMapDataType xtype = std::is_same<T, __half>::value
                                        ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                        : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  if (!encode_2d(&p.wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, q, N, K, 1,
                 kStageK, kWgRows * w) ||
      !encode_2d(&p.xmap, xtype, x, M, K, 2, 64, NB))
    return cudaErrorInvalidValue;
  p.scale = static_cast<const float*>(scale);
  p.out = out;
  p.M = M;
  p.N = N;
  p.K = K;
  p.stages = (K + kStageK - 1) / kStageK;
  p.per = per;
  p.ring = ring;
  auto kernel = w8_wgmma_kernel<T, NB>;
  // Above 48 KB a block's shared memory is opted into once, at the
  // first launch (never under a graph's capture: the engine warms every
  // step up before capturing it).
  static bool opted_in = false;
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
          cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  const int tiles = (N + kWgRows * w - 1) / (kWgRows * w);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * cluster);
  cfg.blockDim = dim3(128 * w + 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Clusters of `cluster` blocks of the instance at (w, smem) that the
// card runs at once; -1 where the runtime cannot say.
template <typename T, int NB>
int active_clusters(int w, int cluster, int smem) {
  auto kernel = w8_wgmma_kernel<T, NB>;
  if (cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kMaxSmem) != cudaSuccess)
    return -1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(128 * w + 32);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = -1;
  if (cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) != cudaSuccess)
    return -1;
  return n;
}

}  // namespace pstt_w8

// The activation-row buckets the 16-bit kernel is built for, ascending;
// the host's ops/int8_matmul_cuda.W8_BUCKETS is this list.
#define PSTT_W8_FOR_EACH_BUCKET(X) X(8) X(16) X(32) X(64) X(128) X(160)

// dtype: 0 bf16 or 3 f16 (wgmma; K a multiple of 16), 1 f32 (FMA; K a
// multiple of 4). x [M, K], q [N, K] int8, scale [N] f32, out [M, N] in
// x's type. The 16-bit kernel's plan (ops/int8_matmul_cuda.
// int8_weight_plan): nb the activation bucket (M <= nb), w the
// consumer warpgroups (64 w weight rows a tile), cluster the blocks
// splitting K (1 to 8), per the 128-value stages a rank, ring the
// ring's stages, smem the block's shared-memory bytes; a plan the
// kernel was not built for is refused (f32: all six 0). Returns
// cudaGetLastError() after the launch.
extern "C" int pstt_int8_weight_matmul(int dtype, const void* x,
                                       const void* q, const void* scale,
                                       void* out, int M, int N, int K,
                                       int nb, int w, int cluster, int per,
                                       int ring, int smem, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (M < 0 || N < 0 || K < 0) return cudaErrorInvalidValue;
  if (M == 0 || N == 0) return cudaSuccess;
  if (dtype == 1) {
    if (K % 4 || nb || w || cluster || per || ring || smem)
      return cudaErrorInvalidValue;
    const dim3 grid((N + pstt_w8::kFmaWarps - 1) / pstt_w8::kFmaWarps,
                    (M + pstt_w8::kFmaRows - 1) / pstt_w8::kFmaRows);
    pstt_w8::w8_fma_f32_kernel<<<grid, pstt_w8::kFmaWarps * 32, 0, s>>>(
        static_cast<const float*>(x), static_cast<const int8_t*>(q),
        static_cast<const float*>(scale), static_cast<float*>(out), M, N,
        K);
    return cudaGetLastError();
  }
  const int stages = (K + pstt_w8::kStageK - 1) / pstt_w8::kStageK;
  if ((dtype != 0 && dtype != 3) || K == 0 || K % 16 || M > nb ||
      w < 1 || w > pstt_w8::max_warpgroups(nb) || cluster < 1 ||
      cluster > pstt_w8::kMaxCluster || per < 1 ||
      (cluster - 1) * per >= stages || cluster * per < stages ||
      ring < 1 || ring > pstt_w8::kMaxRing ||
      smem != pstt_w8::smem_bytes(nb, w, ring, cluster) ||
      smem > pstt_w8::kMaxSmem)
    return cudaErrorInvalidValue;
#define PSTT_W8_CASE(NB)                                                  \
  if (nb == NB)                                                           \
    return dtype == 3                                                     \
               ? pstt_w8::launch_wgmma<__half, NB>(x, q, scale, out, M, N, \
                                                   K, w, cluster, per,     \
                                                   ring, smem, s)          \
               : pstt_w8::launch_wgmma<__nv_bfloat16, NB>(                 \
                     x, q, scale, out, M, N, K, w, cluster, per, ring,     \
                     smem, s);
  PSTT_W8_FOR_EACH_BUCKET(PSTT_W8_CASE)
#undef PSTT_W8_CASE
  return cudaErrorInvalidValue;
}

// The clusters of a plan (dtype 0 bf16 or 3 f16, the bucket nb, w
// warpgroups, cluster blocks, smem bytes) that the card runs at once
// (cudaOccupancyMaxActiveClusters: the host's MAX_ACTIVE_CLUSTERS is
// read from it); -1 for a plan the kernel is not built for.
extern "C" int pstt_int8_weight_active_clusters(int dtype, int nb, int w,
                                                int cluster, int smem) {
  if ((dtype != 0 && dtype != 3) || w < 1 ||
      w > pstt_w8::max_warpgroups(nb) || cluster < 1 ||
      cluster > pstt_w8::kMaxCluster || smem > pstt_w8::kMaxSmem)
    return -1;
#define PSTT_W8_ACTIVE(NB)                                               \
  if (nb == NB)                                                          \
    return dtype == 3                                                    \
               ? pstt_w8::active_clusters<__half, NB>(w, cluster, smem)  \
               : pstt_w8::active_clusters<__nv_bfloat16, NB>(w, cluster, \
                                                             smem);
  PSTT_W8_FOR_EACH_BUCKET(PSTT_W8_ACTIVE)
#undef PSTT_W8_ACTIVE
  return -1;
}
