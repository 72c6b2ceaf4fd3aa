// int8_weight_matmul: y[M, N] = (x[M, K] . q[N, K]^T) * scale[N], the
// weight-only int8 projection of a decode-sized step (M <= the host's
// INT8_KERNEL_MAX_ROWS).
//
// Counterpart of the JAX package's dequantizing matmul
// (engine/quantization.py dequant_matmul, ``(x @ q.astype(x.dtype)) *
// scale``), which XLA fuses into one dot whose int8 operand is
// converted on the way in, so only int8 weight bytes cross HBM. It is
// not a Pallas kernel; the port writes it by hand because the plain
// torch form materialises a bf16 copy of every weight on every call.
//
// What bounds it on the card: the weight bytes. At M = 32 a product
// does 2 * M = 64 operations per int8 byte of q, far below the ~295 at
// which the H100's bf16 tensor cores and not its memory become the
// limit. At decode sizes the matrices are small (4 to 23 MB), so what
// the card waits for is mostly latency: a warp that holds one step of
// weights in flight and waits for it before the next pays one HBM round
// trip a step. So the design puts a block's whole weight range in
// flight at once and never stages q:
//
//   - the product runs transposed on the tensor cores, out^T = q . x^T:
//     q is the A operand of mma.sync m16n8k16 (16 weight rows a warp)
//     and x the B operand (8 activation rows a tile), so M = 1 wastes 7
//     of 8 rows, not 15 of 16;
//   - a block (8 warps, 128 weight rows) walks its K range in chunks of
//     64 * STEPS values. Each thread loads 16 contiguous int8 of each of
//     its two weight rows a step (one 16-byte load a row), every step of
//     the chunk at once, and the next chunk's while this one multiplies;
//   - the mma's k order is permuted so that those registers ARE the A
//     fragments: thread quad t holds k values 2t, 2t + 1, 2t + 8, 2t + 9
//     of a 16-wide step, which here are the physical k 16t + 4s + {0, 1,
//     2, 3} of step s. The same permutation on x (16 contiguous bf16 of
//     an activation row a thread, two 16-byte shared-memory loads) leaves
//     the sum unchanged;
//   - the activations' chunk (at most 160 rows) is staged once a block in
//     shared memory with asynchronous 16-byte copies (cp.async), the
//     next chunk's while this one is read (two buffers, one barrier a
//     chunk), rows padded by 16 bytes (conflict-free 16-byte reads), and
//     read by all eight warps;
//   - int8 becomes bf16 exactly in registers (byte_perm into the
//     mantissa of 2^23 + 128 + b, one f32 subtraction, the upper half),
//     or f16 (the same f32 values, packed by the conversion
//     instruction: exact, |b| <= 128);
//   - a split over K (grid.y) keeps enough blocks on the 132 SMs when N
//     is small; each split writes f32 partial sums and a second small
//     kernel adds them in split order, scales and rounds once (no
//     atomics: the same bits every launch). With one split the product
//     kernel scales and rounds itself. (Adding them in the last block of
//     each column tile instead measured slower on an H100 at M = 32: one
//     block's serial sum became the launch's tail.)
//
// The sum is f32, the scale is applied in f32 and the result is rounded
// once to the output type, as the plain version
// (ops/int8_matmul_cuda.int8_weight_matmul_plain) computes it. bf16
// and f16 activations (T) take the same tensor-core kernel, with
// mma.sync in their form (the JAX dot runs in any dtype: --quantization
// int8 --dtype float16 serves through the f16 form). An f32
// activation (the tiny test geometry) takes an f32 FMA kernel instead:
// a warp a weight row, lanes over K, a fixed shuffle reduction.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <type_traits>
#include <stdint.h>

namespace pstt_w8 {

constexpr int kWarps = 8;                 // warps a block
constexpr int kThreads = kWarps * 32;
constexpr int kBlockRows = kWarps * 16;   // weight rows a block
constexpr int kStepK = 64;                // k values a step
constexpr int kFmaWarps = 8;  // f32 kernel: weight rows a block
constexpr int kFmaRows = 8;   // f32 kernel: activation rows a block

// The activations' chunk in shared memory: 8 * XT rows of 64 * STEPS
// 16-bit values, each row padded by 16 bytes. A block holds two.
template <int XT, int STEPS>
struct Chunk {
  static constexpr int kRows = 8 * XT;
  static constexpr int kK = STEPS * kStepK;
  static constexpr int kRowBytes = kK * 2 + 16;
  static constexpr int kBytes = kRows * kRowBytes;
  static constexpr int kPieces = kRows * (kK / 8);  // 16-byte pieces
};

// c += a (16 x 16, row) * b (16 x 8, col), T (bf16 or f16) in, f32
// accumulate.
template <typename T>
__device__ __forceinline__ void mma16(float (&c)[4], uint32_t a0,
                                      uint32_t a1, uint32_t a2, uint32_t a3,
                                      uint32_t b0, uint32_t b1) {
  if constexpr (std::is_same<T, __half>::value) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  }
}

__device__ __forceinline__ __nv_bfloat16 round_to(float x, __nv_bfloat16) {
  return __float2bfloat16_rn(x);
}
__device__ __forceinline__ __half round_to(float x, __half) {
  return __float2half_rn(x);
}

// Four int8 of one word to two words of T pairs (bf16 or f16),
// exactly: lo holds bytes 0 and 1 (byte 0 in its low half), hi bytes 2
// and 3. Byte b + 128 goes into the low mantissa byte of 2^23;
// subtracting 2^23 + 128 leaves b as an f32, whose upper 16 bits are its
// bf16, and which the f16 conversion packs exactly.
template <typename T>
__device__ __forceinline__ void i8x4_to_16x4(uint32_t w, uint32_t& lo,
                                             uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  const uint32_t magic = 0x4B000000u;
  const float bias = 8388736.0f;  // 2^23 + 128
  const float f0 = __uint_as_float(__byte_perm(u, magic, 0x7650)) - bias;
  const float f1 = __uint_as_float(__byte_perm(u, magic, 0x7651)) - bias;
  const float f2 = __uint_as_float(__byte_perm(u, magic, 0x7652)) - bias;
  const float f3 = __uint_as_float(__byte_perm(u, magic, 0x7653)) - bias;
  if constexpr (std::is_same<T, __half>::value) {
    const __half2 l2 = __floats2half2_rn(f0, f1);
    const __half2 h2 = __floats2half2_rn(f2, f3);
    lo = *reinterpret_cast<const uint32_t*>(&l2);
    hi = *reinterpret_cast<const uint32_t*>(&h2);
  } else {
    lo = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
    hi = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
  }
}

// 16 bytes from global to shared memory, asynchronously (cp.async);
// zeros where ``valid`` is false (``src`` is then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// This thread's 16 weight bytes of each step of the chunk at kc, for
// its two rows (zero past the row count or the K range).
template <int STEPS>
__device__ __forceinline__ void load_weights(int4 (&dst)[STEPS][2],
                                             const int4* row0,
                                             const int4* row1, bool ok0,
                                             bool ok1, int kc, int k_end) {
  const int4 zero = make_int4(0, 0, 0, 0);
#pragma unroll
  for (int s = 0; s < STEPS; ++s) {
    const int k = kc + s * kStepK;
    dst[s][0] = ok0 && k < k_end ? __ldcs(row0 + k / 16) : zero;
    dst[s][1] = ok1 && k < k_end ? __ldcs(row1 + k / 16) : zero;
  }
}

// The activations' chunk at kc into ``dst`` with asynchronous 16-byte
// copies, zeros past M and past the K range.
template <int XT, int STEPS, typename T>
__device__ __forceinline__ void stage_activations(
    unsigned char* dst, const T* x, int M, int K, int kc,
    int k_end) {
  using C = Chunk<XT, STEPS>;
  for (int p = threadIdx.x; p < C::kPieces; p += kThreads) {
    const int r = p / (C::kK / 8);
    const int c = p % (C::kK / 8);
    const int k = kc + 8 * c;
    const bool valid = r < M && k < k_end;
    cp_async16(dst + r * C::kRowBytes + 16 * c,
               valid ? x + static_cast<size_t>(r) * K + k : x, valid);
  }
}

// One block: kWarps warps, each over 16 weight rows, the block's K
// range [k_begin, k_end) in chunks, every activation row (XT tiles of
// 8; rows >= M read as zero and are never written).
template <typename T, int XT, int STEPS>
__global__ void __launch_bounds__(kThreads)
    w8_mma_kernel(const T* __restrict__ x, const int8_t* __restrict__ q,
                  const float* __restrict__ scale, T* __restrict__ out,
                  float* __restrict__ partial, int M, int N, int K,
                  int k_per_split) {
  using C = Chunk<XT, STEPS>;
  // Two buffers of the activations' chunk: the next one is copied in
  // while this one is read.
  extern __shared__ __align__(16) unsigned char w8_smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int grp = lane >> 2;
  const int quad = lane & 3;
  const int n0 = blockIdx.x * kBlockRows + warp * 16;
  // A warp past N still stages activations and meets every barrier.
  const bool active = n0 < N;
  const int k_begin = blockIdx.y * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);

  const bool ok0 = n0 + grp < N;
  const bool ok1 = n0 + 8 + grp < N;
  const int4* row0 = reinterpret_cast<const int4*>(
      q + static_cast<size_t>(ok0 ? n0 + grp : 0) * K + 16 * quad);
  const int4* row1 = reinterpret_cast<const int4*>(
      q + static_cast<size_t>(ok1 ? n0 + 8 + grp : 0) * K + 16 * quad);

  float acc[XT][4];
#pragma unroll
  for (int j = 0; j < XT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  int4 cur[STEPS][2], nxt[STEPS][2];
  stage_activations<XT, STEPS>(w8_smem, x, M, K, k_begin, k_end);
  load_weights<STEPS>(cur, row0, row1, ok0 && active, ok1 && active,
                      k_begin, k_end);
  int buf = 0;
  for (int kc = k_begin; kc < k_end; kc += C::kK, buf ^= 1) {
    // This chunk's activations have landed and are visible to every
    // warp, and every warp is done with the other buffer.
    cp_async_wait_all();
    __syncthreads();
    const unsigned char* xs = w8_smem + buf * C::kBytes;
    // The next chunk's activations and weights, in flight while this
    // one multiplies.
    const int kn = kc + C::kK;
    if (kn < k_end)
      stage_activations<XT, STEPS>(w8_smem + (buf ^ 1) * C::kBytes, x, M,
                                   K, kn, k_end);
    load_weights<STEPS>(nxt, row0, row1, ok0 && active, ok1 && active, kn,
                        k_end);
    if (active) {
#pragma unroll
      for (int s = 0; s < STEPS; ++s) {
        // A fragments: a[h][w] is the T pair of k 16 quad + 2w, +1 of
        // row half h.
        uint32_t a[2][8];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          i8x4_to_16x4<T>(static_cast<uint32_t>(cur[s][h].x), a[h][0],
                         a[h][1]);
          i8x4_to_16x4<T>(static_cast<uint32_t>(cur[s][h].y), a[h][2],
                         a[h][3]);
          i8x4_to_16x4<T>(static_cast<uint32_t>(cur[s][h].z), a[h][4],
                         a[h][5]);
          i8x4_to_16x4<T>(static_cast<uint32_t>(cur[s][h].w), a[h][6],
                         a[h][7]);
        }
#pragma unroll
        for (int j = 0; j < XT; ++j) {
          const unsigned char* src = xs + (8 * j + grp) * C::kRowBytes +
                                     (s * kStepK + 16 * quad) * 2;
          const uint4 lo = *reinterpret_cast<const uint4*>(src);
          const uint4 hi = *reinterpret_cast<const uint4*>(src + 16);
          const uint32_t b[8] = {lo.x, lo.y, lo.z, lo.w,
                                 hi.x, hi.y, hi.z, hi.w};
#pragma unroll
          for (int t = 0; t < 4; ++t)
            mma16<T>(acc[j], a[0][2 * t], a[1][2 * t], a[0][2 * t + 1],
                     a[1][2 * t + 1], b[2 * t], b[2 * t + 1]);
        }
      }
    }
#pragma unroll
    for (int s = 0; s < STEPS; ++s) {
      cur[s][0] = nxt[s][0];
      cur[s][1] = nxt[s][1];
    }
  }
  if (!active) return;

  // Accumulator e of tile j: weight row grp (+ 8 for e >= 2), activation
  // row 8 j + 2 quad (+ 1 for odd e).
#pragma unroll
  for (int j = 0; j < XT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = n0 + grp + (e >= 2 ? 8 : 0);
      const int m = 8 * j + 2 * quad + (e & 1);
      if (n >= N || m >= M) continue;
      if (partial != nullptr) {
        partial[(static_cast<size_t>(blockIdx.y) * M + m) * N + n] =
            acc[j][e];
      } else {
        out[static_cast<size_t>(m) * N + n] =
            round_to(acc[j][e] * scale[n], T());
      }
    }
}

// The splits' partial sums, added in split order, scaled, rounded once.
template <typename T>
__global__ void w8_reduce_kernel(const float* __restrict__ partial,
                                 const float* __restrict__ scale,
                                 T* __restrict__ out, int M, int N,
                                 int splits) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
  const size_t total = static_cast<size_t>(M) * N;
  if (i >= total) return;
  float sum = 0.f;
  for (int s = 0; s < splits; ++s) sum += partial[s * total + i];
  out[i] = round_to(sum * scale[i % N], T());
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

template <typename T, int XT, int STEPS>
int launch_mma(const void* x, const void* q, const void* scale, void* out,
               void* partial, int M, int N, int K, int splits,
               int k_per_split, cudaStream_t stream) {
  if (k_per_split % Chunk<XT, STEPS>::kK) return cudaErrorInvalidValue;
  const int smem = 2 * Chunk<XT, STEPS>::kBytes;
  // Above 48 KB a block's shared memory is opted into once, at the
  // first launch (never under a graph's capture: the engine warms every
  // step up before capturing it).
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        w8_mma_kernel<T, XT, STEPS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  const dim3 grid((N + kBlockRows - 1) / kBlockRows, splits);
  w8_mma_kernel<T, XT, STEPS><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(q),
      static_cast<const float*>(scale), static_cast<T*>(out),
      splits > 1 ? static_cast<float*>(partial) : nullptr, M, N, K,
      k_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const size_t total = static_cast<size_t>(M) * N;
  w8_reduce_kernel<T><<<static_cast<unsigned>((total + 255) / 256), 256, 0,
                        stream>>>(static_cast<const float*>(partial),
                                  static_cast<const float*>(scale),
                                  static_cast<T*>(out), M, N, splits);
  return cudaGetLastError();
}

}  // namespace pstt_w8

// The activation row tiles the bf16 kernel is built for (8 rows a tile:
// M <= 8 * XT), each with the steps of 64 k values a chunk holds; the
// host (ops/int8_matmul_cuda.X_TILES) rounds a product's rows up to one
// of them and cuts K into whole chunks a split.
#define PSTT_W8_FOR_EACH_TILES(X) \
  X(1, 4) X(2, 4) X(4, 4) X(8, 4) X(12, 2) X(16, 2) X(20, 2)

// dtype: 0 bf16 or 3 f16 (tensor cores; K a multiple of 64), 1 f32
// (FMA; K a multiple of 4). x [M, K], q [N, K] int8, scale [N] f32, out
// [M, N] in x's type; partial: f32 [splits, M, N] scratch when splits >
// 1 (bf16 and f16 only). x_tiles: the activation row tiles of the
// launch (a line of PSTT_W8_FOR_EACH_TILES). Returns cudaGetLastError()
// after the launches.
extern "C" int pstt_int8_weight_matmul(int dtype, const void* x,
                                       const void* q, const void* scale,
                                       void* out, void* partial, int M,
                                       int N, int K, int x_tiles,
                                       int splits, int k_per_split,
                                       void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (M < 0 || N < 0 || K < 0) return cudaErrorInvalidValue;
  if (M == 0 || N == 0) return cudaSuccess;
  if (dtype == 1) {
    if (K % 4 || splits != 1) return cudaErrorInvalidValue;
    const dim3 grid((N + pstt_w8::kFmaWarps - 1) / pstt_w8::kFmaWarps,
                    (M + pstt_w8::kFmaRows - 1) / pstt_w8::kFmaRows);
    pstt_w8::w8_fma_f32_kernel<<<grid, pstt_w8::kFmaWarps * 32, 0, s>>>(
        static_cast<const float*>(x), static_cast<const int8_t*>(q),
        static_cast<const float*>(scale), static_cast<float*>(out), M, N,
        K);
    return cudaGetLastError();
  }
  if ((dtype != 0 && dtype != 3) || K % pstt_w8::kStepK || splits < 1 ||
      k_per_split % pstt_w8::kStepK || k_per_split <= 0 ||
      static_cast<long long>(splits - 1) * k_per_split >= K ||
      (splits > 1 && partial == nullptr) || M > 8 * x_tiles)
    return cudaErrorInvalidValue;
#define PSTT_W8_CASE(XT, STEPS)                                          \
  if (x_tiles == XT)                                                     \
    return dtype == 3 ? pstt_w8::launch_mma<__half, XT, STEPS>(          \
                            x, q, scale, out, partial, M, N, K, splits,  \
                            k_per_split, s)                              \
                      : pstt_w8::launch_mma<__nv_bfloat16, XT, STEPS>(   \
                            x, q, scale, out, partial, M, N, K, splits,  \
                            k_per_split, s);
  PSTT_W8_FOR_EACH_TILES(PSTT_W8_CASE)
#undef PSTT_W8_CASE
  return cudaErrorInvalidValue;
}
