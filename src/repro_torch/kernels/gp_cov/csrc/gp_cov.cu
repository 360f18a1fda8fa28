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
// a fused multiply-add per feature, then the square root, division and
// exponential) at 67 TFLOP/s.  At d = 62 a pair costs ~200 operations for
// 4 bytes written, so large matrices are bound by FP32 throughput; at the
// BO engine's shapes ((512, 11, 62), (11, 11, 62)) both bounds are far
// under a microsecond and the call is bound by its launch.
//
// Design.  The TPU kernel forms d2 as |x|^2 + |z|^2 - 2 x.z so that the
// bulk of the work is one MXU product per tile.  That rewrite cancels
// badly when x and z are close, and the BO candidates include small
// perturbations of the incumbent while K(X, X) gets only 1e-4 of noise
// before its Cholesky; so this kernel sums direct differences in FP32, as
// the reference engine does, and needs no tensor core (so no TF32 either).
// Each block owns one kTile x kTile output tile.  The kTile rows of X1 and
// of X2 it needs are staged in shared memory kChunk features at a time
// (coalesced loads along d; a row pitch of kChunk + 1 keeps the column
// reads conflict-free).  Each thread owns kRowsPerThread outputs of one
// column: it reads its X2 row once per feature and the X1 rows as
// shared-memory broadcasts, and keeps its sums in registers.  The ragged
// edges (n, m not multiples of kTile, d not a multiple of kChunk) are
// masked here: out-of-range rows load zeros and write nothing, and zero
// features add nothing to d2.  The lengthscale is a launch argument, so
// one build serves any value.  The kernel launches on the caller's stream
// and the C entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kTile = 32;            // output tile edge; blockDim.x
constexpr int kRowsPerThread = 4;    // outputs per thread, one column
constexpr int kThreadsY = kTile / kRowsPerThread;   // blockDim.y
constexpr int kThreads = kTile * kThreadsY;
constexpr int kChunk = 32;           // features staged per round
constexpr float kSqrt5 = 2.2360679774997896f;

__global__ void __launch_bounds__(kThreads)
matern52_kernel(const float* __restrict__ x1, const float* __restrict__ x2,
                float* __restrict__ out, int n, int m, int d,
                float lengthscale) {
  __shared__ float s_x[kTile][kChunk + 1];
  __shared__ float s_z[kTile][kChunk + 1];

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kTile + tx;
  const int i0 = blockIdx.y * kTile;
  const int j0 = blockIdx.x * kTile;

  float acc[kRowsPerThread];
#pragma unroll
  for (int q = 0; q < kRowsPerThread; ++q) acc[q] = 0.0f;

  for (int k0 = 0; k0 < d; k0 += kChunk) {
    __syncthreads();   // every thread is done with the previous chunk
    for (int e = tid; e < kTile * kChunk; e += kThreads) {
      const int row = e / kChunk;
      const int k = k0 + e % kChunk;
      const int gi = i0 + row;
      const int gj = j0 + row;
      s_x[row][e % kChunk] =
          (gi < n && k < d) ? x1[static_cast<size_t>(gi) * d + k] : 0.0f;
      s_z[row][e % kChunk] =
          (gj < m && k < d) ? x2[static_cast<size_t>(gj) * d + k] : 0.0f;
    }
    __syncthreads();
    const int kc = min(kChunk, d - k0);
    for (int c = 0; c < kc; ++c) {
      const float z = s_z[tx][c];
#pragma unroll
      for (int q = 0; q < kRowsPerThread; ++q) {
        const float diff = s_x[ty + q * kThreadsY][c] - z;
        acc[q] = fmaf(diff, diff, acc[q]);
      }
    }
  }

  const int gj = j0 + tx;
  if (gj >= m) return;
#pragma unroll
  for (int q = 0; q < kRowsPerThread; ++q) {
    const int gi = i0 + ty + q * kThreadsY;
    if (gi < n) {
      const float r = sqrtf(fmaxf(acc[q], 1e-12f)) / lengthscale;
      const float s5r = kSqrt5 * r;
      out[static_cast<size_t>(gi) * m + gj] =
          (1.0f + s5r + 5.0f * r * r / 3.0f) * expf(-s5r);
    }
  }
}

}  // namespace

// C interface, loaded with ctypes.  x1: (n, d) and x2: (m, d) float32
// row-major; out: (n, m) float32; stream: the cudaStream_t to launch on.
// Returns a cudaError_t code (0 = launched).
extern "C" int gp_cov_matern52(const float* x1, const float* x2, float* out,
                               int n, int m, int d, float lengthscale,
                               void* stream) {
  if (n <= 0 || m <= 0) return static_cast<int>(cudaSuccess);
  if (d < 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((m + kTile - 1) / kTile, (n + kTile - 1) / kTile);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(kTile, kThreadsY);
  matern52_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      x1, x2, out, n, m, d, lengthscale);
  return static_cast<int>(cudaGetLastError());
}
