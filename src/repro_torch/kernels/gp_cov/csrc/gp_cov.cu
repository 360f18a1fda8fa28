// Matérn-5/2 GP covariance on NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/gp_cov/gp_cov.py
// (matern52_pallas / _cov_kernel).  For float32 X1 (n, d) and X2 (m, d),
// row-major, writes the float32 (n, m) matrix
//     d2 = sum_k (x_k - z_k)^2,   r = sqrt(max(d2, 1e-12)) / lengthscale,
//     K  = (1 + sqrt(5) r + 5 r^2 / 3) exp(-sqrt(5) r),
// the function of repro.core.optimizer.matern52 (the covariance the BO
// engine's gp_posterior builds, twice per BO iteration).
//
// What bounds it on the H100: 4 (n + m) d bytes read and 4 n m written at
// 3.35 TB/s, against about n m (3 d + 15) FP32 operations (a subtract and
// a fused multiply-add per feature, then the square root, the scale and
// the exponential) at 67 TFLOP/s.  At d = 62 a pair costs ~200 operations
// for 4 bytes written, so large matrices are bound by FP32 issue: 2 d + ~25
// instructions a pair (the issue floor's count; this kernel's epilogue
// takes fewer) over 132 SMs x 128 lanes, ~75 us at (4096, 4096, 62) and
// 1.98 GHz.  At the BO engine's shapes ((512, 11, 62), (11, 11, 62))
// both bounds are far under a microsecond and the call is bound by its
// launch.
//
// Design.  The TPU kernel forms d2 as |x|^2 + |z|^2 - 2 x.z so that the
// bulk of the work is one MXU product per tile.  That rewrite cancels
// badly when x and z are close, and the BO candidates include small
// perturbations of the incumbent while K(X, X) gets only 1e-4 of noise
// before its Cholesky; so this kernel sums direct differences in FP32, as
// the reference engine does, and needs no tensor core (so no TF32 either).
// It is laid out as a SIMT GEMM with the product replaced: each block owns
// a BM x BN output tile and each thread an RM x RN sub-tile of it, its
// sums in registers.  Features are staged feature-major in shared memory
// (a row of BM x values and one of BN z values per feature), KC features
// a round, double-buffered with 4-byte cp.async copies (rows of d floats
// need not be 16-byte aligned), so the next round's loads fly while this
// one is summed.  For each feature a thread reads its RM x values and RN z
// values as 16-byte loads (two each at 8) and does RM RN subtracts and
// RM RN FMAs: 4 shared-memory loads for 128 FP32 operations at 8 x 8,
// where the previous kernel paid 5 loads for 8.  The feature loop is
// unrolled by 4 and stops at d rounded up to 4.  The epilogue
// (square root, scale, exponential on the special-function unit) runs
// from registers with one store per output (16-byte stores when m is a
// multiple of 4).
//
// Tiles are chosen by m: 128 x 128 tiles of 8 x 8 (256 threads) for wide
// outputs, and for the BO engine's thin ones (m = number of observations,
// at most 64 here) 64 x 16 tiles of 4 x 4 (64 threads) with 32 features a
// round, so (512, 11, 62) runs as 8 blocks in two rounds.  The ragged
// edges (n, m not multiples of the tile, d not a multiple of KC) are
// zero-filled by the copies: out-of-range rows write nothing, and zero
// features add nothing to d2.  The lengthscale is a launch argument, so
// one build serves any value.  The kernel launches on the caller's stream
// and the C entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr float kSqrt5 = 2.2360679774997896f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kPad = 4;     // floats past each staged feature row

__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Rows [first, first + ROWS) of a row-major (rows, d) array, features
// [k0, k0 + KC), into the feature-major tile dst[KC][ROWS + kPad]; rows at
// or past `rows` and features at or past d are zero-filled.
template <int ROWS, int KC, int THREADS>
__device__ __forceinline__ void stage(float* dst, const float* src, int first,
                                      int rows, int k0, int d, int tid) {
  static_assert(ROWS * KC % THREADS == 0, "whole copies per thread");
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
#pragma unroll
  for (int i = 0; i < ROWS * KC / THREADS; ++i) {
    const int e = tid + i * THREADS;
    const int row = e / KC;
    const int k = k0 + e % KC;
    const bool ok = first + row < rows && k < d;
    const float* p = ok ? src + static_cast<size_t>(first + row) * d + k : src;
    cp_async4(base + 4 * ((e % KC) * (ROWS + kPad) + row), p, ok);
  }
}

// The special-function unit's 1/sqrt(x) and 2^x, each within ~2^-22 of
// the exact value: K moves by under 1e-6 against the 1e-5 tolerance, for
// 2 instructions where sqrtf and expf take ~20 together.  Flushing
// subnormals skips their range fix-ups: the input d2 >= 1e-12 is normal,
// and an exponential below 2^-126 becomes 0, which moves K by < 1e-33.
__device__ __forceinline__ float rsqrt_approx(float x) {
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// One 16-byte shared-memory load into four registers.
__device__ __forceinline__ void unpack4(float* dst, const float* src) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  dst[0] = v.x;
  dst[1] = v.y;
  dst[2] = v.z;
  dst[3] = v.w;
}

// RM x RN outputs a thread: rows g * (BM / GM) + 4 ty + {0..3} for the GM =
// RM / 4 row groups g, columns likewise, so each group is one 16-byte load
// and a warp's loads of z fall on consecutive addresses.
template <int BM, int BN, int RM, int RN, int KC>
__global__ void __launch_bounds__((BM / RM) * (BN / RN), 2)
matern52_kernel(const float* __restrict__ x1, const float* __restrict__ x2,
                float* __restrict__ out, int n, int m, int d,
                float inv_lengthscale) {
  constexpr int TX = BN / RN;
  constexpr int kThreads = (BM / RM) * TX;
  constexpr int GM = RM / 4;
  constexpr int GN = RN / 4;
  __shared__ __align__(16) float s_x[2][KC][BM + kPad];
  __shared__ __align__(16) float s_z[2][KC][BN + kPad];

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int i0 = blockIdx.y * BM;
  const int j0 = blockIdx.x * BN;

  float acc[RM][RN];
#pragma unroll
  for (int a = 0; a < RM; ++a)
#pragma unroll
    for (int b = 0; b < RN; ++b) acc[a][b] = 0.0f;

  const int rounds = (d + KC - 1) / KC;
  if (rounds > 0) {
    stage<BM, KC, kThreads>(&s_x[0][0][0], x1, i0, n, 0, d, tid);
    stage<BN, KC, kThreads>(&s_z[0][0][0], x2, j0, m, 0, d, tid);
  }
  cp_async_commit();
  for (int c = 0; c < rounds; ++c) {
    const int buf = c & 1;
    if (c + 1 < rounds) {
      stage<BM, KC, kThreads>(&s_x[buf ^ 1][0][0], x1, i0, n, (c + 1) * KC,
                              d, tid);
      stage<BN, KC, kThreads>(&s_z[buf ^ 1][0][0], x2, j0, m, (c + 1) * KC,
                              d, tid);
    }
    cp_async_commit();
    cp_async_wait1();     // round c has landed (round c + 1 may fly)
    __syncthreads();
    // the round's features rounded up to 4 (the zero-filled rest adds 0)
    const int kc = min(KC, (d - c * KC + 3) & ~3);
    for (int k0 = 0; k0 < kc; k0 += 4) {
#pragma unroll
      for (int k = k0; k < k0 + 4; ++k) {
        float xv[RM];
        float zv[RN];
#pragma unroll
        for (int g = 0; g < GM; ++g)
          unpack4(xv + 4 * g, &s_x[buf][k][g * (BM / GM) + 4 * ty]);
#pragma unroll
        for (int g = 0; g < GN; ++g)
          unpack4(zv + 4 * g, &s_z[buf][k][g * (BN / GN) + 4 * tx]);
#pragma unroll
        for (int a = 0; a < RM; ++a)
#pragma unroll
          for (int b = 0; b < RN; ++b) {
            const float diff = xv[a] - zv[b];
            acc[a][b] = fmaf(diff, diff, acc[a][b]);
          }
      }
    }
    __syncthreads();      // every thread is done with this buffer
  }

  const bool vec =
      (m & 3) == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
#pragma unroll
  for (int a = 0; a < RM; ++a) {
    const int gi = i0 + (a / 4) * (BM / GM) + 4 * ty + a % 4;
    if (gi >= n) continue;
    float* row = out + static_cast<size_t>(gi) * m;
#pragma unroll
    for (int g = 0; g < GN; ++g) {
      const int gj = j0 + g * (BN / GN) + 4 * tx;
      float kv[4];
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const float d2 = fmaxf(acc[a][4 * g + b], 1e-12f);
        const float s5r = d2 * rsqrt_approx(d2) * (kSqrt5 * inv_lengthscale);
        kv[b] = (1.0f + s5r + s5r * s5r * (1.0f / 3.0f)) *
                ex2_approx(-s5r * kLog2e);
      }
      if (vec && gj < m) {
        *reinterpret_cast<float4*>(row + gj) =
            make_float4(kv[0], kv[1], kv[2], kv[3]);
      } else {
#pragma unroll
        for (int b = 0; b < 4; ++b)
          if (gj + b < m) row[gj + b] = kv[b];
      }
    }
  }
}

template <int BM, int BN, int RM, int RN, int KC>
int launch(const float* x1, const float* x2, float* out, int n, int m, int d,
           float lengthscale, cudaStream_t stream) {
  const dim3 grid((m + BN - 1) / BN, (n + BM - 1) / BM);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  matern52_kernel<BM, BN, RM, RN, KC>
      <<<grid, (BM / RM) * (BN / RN), 0, stream>>>(x1, x2, out, n, m, d,
                                                   1.0f / lengthscale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface, loaded with ctypes.  x1: (n, d) and x2: (m, d) float32
// row-major; out: (n, m) float32; stream: the
// cudaStream_t to launch on.  Returns a cudaError_t code (0 = launched).
extern "C" int gp_cov_matern52(const float* x1, const float* x2, float* out,
                               int n, int m, int d, float lengthscale,
                               void* stream) {
  if (n <= 0 || m <= 0) return static_cast<int>(cudaSuccess);
  if (d < 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m <= 64)
    return launch<64, 16, 4, 4, 32>(x1, x2, out, n, m, d, lengthscale, s);
  return launch<128, 128, 8, 8, 16>(x1, x2, out, n, m, d, lengthscale, s);
}
