// Mamba-1 selective scan on NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/mamba_scan/mamba_scan.py
// (selective_scan_pallas / _scan_kernel).  For float32 u, delta (B, S, Di),
// A (Di, Ds), Bc, Cc (B, S, Ds) and an optional h0 (B, Di, Ds), all
// row-major, walks time sequentially:
//     h_t = exp(delta_t A) * h_{t-1} + (delta_t u_t) B_t^T,
//     y_t = h_t C_t,
// and writes y (B, S, Di) and the final state h_T (B, Di, Ds), float32.
//
// What bounds it on the H100: it reads u, delta, Bc, Cc, A (and h0) once
// and writes y and h_T once, at 3.35 TB/s, against ~6 FP32 operations per
// (b, t, di, n) state element (the product delta A, its exponential, the
// update FMA, the output FMA) at 67 TFLOP/s.  At the Hymba prefill shape
// (u (4, 1152, 3200), Ds 16) that is ~179 MB, 53 us, against 1.4e9
// operations, 21 us: bound by bytes.  A decode step (S = 1, h0 carried)
// moves ~1.6 MB of state, under a microsecond: bound by its launch.
//
// Design.  The TPU kernel walks time in a fori_loop over a VMEM-resident
// (Di, Ds) state and carries it across a sequential chunk grid axis.  Here
// the state lives in registers: a group of G lanes (G = Ds rounded up to a
// power of two, 4..32) of one warp owns one (b, di) channel, one state
// element per lane, so the grid has B * Di * G threads (204,800 at the
// prefill shape, enough for 132 SMs; one thread per channel would give
// 12,800).  y_t is a shuffle reduction over the G lanes.  A block of 256
// threads holds 256 / G channels of one batch row; it stages u, delta
// (one coalesced row of channels per step) and B_t, C_t (shared by all
// the block's channels) in shared memory kChunk steps at a time, and
// collects y there too, so every global access is a contiguous row.  Any
// S works (1152 in prefill, 1 in decode); lanes past Ds and channels past
// Di carry zeros and write nothing.  expf, not __expf: __expf's error
// grows with |delta A| (2 + 1.17 |x| ulp), which reaches tens in prefill,
// and the error of each step carries into the next through h; expf keeps
// each step within 2 ulp, far inside the 1e-4 tolerance, and the kernel is
// bound by bytes, not by the exponential.  The kernel launches on the
// caller's stream and the C entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 32;      // time steps staged per round

template <int G>
__global__ void __launch_bounds__(kThreads)
scan_kernel(const float* __restrict__ u, const float* __restrict__ delta,
            const float* __restrict__ A, const float* __restrict__ Bc,
            const float* __restrict__ Cc, const float* __restrict__ h0,
            float* __restrict__ y, float* __restrict__ hT, int S, int Di,
            int Ds) {
  constexpr int kCh = kThreads / G;         // channels per block
  __shared__ float s_u[kChunk][kCh];
  __shared__ float s_d[kChunk][kCh];
  __shared__ float s_y[kChunk][kCh];
  __shared__ float s_b[kChunk][G];
  __shared__ float s_c[kChunk][G];

  const int tid = threadIdx.x;
  const int c = tid / G;                    // channel within the block
  const int n = tid % G;                    // state index
  const int b = blockIdx.y;
  const int di0 = blockIdx.x * kCh;
  const int di = di0 + c;
  const bool live = di < Di && n < Ds;

  const size_t state = (static_cast<size_t>(b) * Di + di) * Ds + n;
  const float a = live ? A[static_cast<size_t>(di) * Ds + n] : 0.0f;
  float h = (live && h0 != nullptr) ? h0[state] : 0.0f;

  for (int t0 = 0; t0 < S; t0 += kChunk) {
    const int steps = min(kChunk, S - t0);
    __syncthreads();   // the previous chunk's y rows are stored
    for (int e = tid; e < kChunk * kCh; e += kThreads) {
      const int t = e / kCh;
      const int cc = e % kCh;
      const bool in = t < steps && di0 + cc < Di;
      const size_t at = (static_cast<size_t>(b) * S + t0 + t) * Di + di0 + cc;
      s_u[t][cc] = in ? u[at] : 0.0f;
      s_d[t][cc] = in ? delta[at] : 0.0f;
    }
    for (int e = tid; e < kChunk * G; e += kThreads) {
      const int t = e / G;
      const int nn = e % G;
      const bool in = t < steps && nn < Ds;
      const size_t at = (static_cast<size_t>(b) * S + t0 + t) * Ds + nn;
      s_b[t][nn] = in ? Bc[at] : 0.0f;
      s_c[t][nn] = in ? Cc[at] : 0.0f;
    }
    __syncthreads();

    for (int t = 0; t < steps; ++t) {
      const float d = s_d[t][c];
      h = fmaf(expf(d * a), h, (d * s_u[t][c]) * s_b[t][n]);
      float yp = h * s_c[t][n];
#pragma unroll
      for (int off = G / 2; off > 0; off >>= 1)
        yp += __shfl_xor_sync(0xffffffffu, yp, off, G);
      if (n == 0) s_y[t][c] = yp;
    }
    __syncthreads();
    for (int e = tid; e < kChunk * kCh; e += kThreads) {
      const int t = e / kCh;
      const int cc = e % kCh;
      if (t < steps && di0 + cc < Di)
        y[(static_cast<size_t>(b) * S + t0 + t) * Di + di0 + cc] = s_y[t][cc];
    }
  }
  if (live) hT[state] = h;
}

template <int G>
int launch(const float* u, const float* delta, const float* A,
           const float* Bc, const float* Cc, const float* h0, float* y,
           float* hT, int B, int S, int Di, int Ds, cudaStream_t stream) {
  constexpr int kCh = kThreads / G;
  const dim3 grid((Di + kCh - 1) / kCh, B);
  scan_kernel<G><<<grid, kThreads, 0, stream>>>(u, delta, A, Bc, Cc, h0, y,
                                                hT, S, Di, Ds);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface, loaded with ctypes.  u, delta: (B, S, Di); A: (Di, Ds);
// Bc, Cc: (B, S, Ds); h0: (B, Di, Ds) or NULL for zeros; y: (B, S, Di);
// hT: (B, Di, Ds); all float32, contiguous.  S may be 0 (then hT = h0).
// stream: the cudaStream_t to launch on.  Returns a cudaError_t code
// (0 = launched).
extern "C" int mamba_selective_scan(const float* u, const float* delta,
                                    const float* A, const float* Bc,
                                    const float* Cc, const float* h0,
                                    float* y, float* hT, int B, int S,
                                    int Di, int Ds, void* stream) {
  if (B <= 0 || Di <= 0 || Ds <= 0) return static_cast<int>(cudaSuccess);
  if (S < 0 || Ds > 32 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Ds <= 4) return launch<4>(u, delta, A, Bc, Cc, h0, y, hT, B, S, Di, Ds, s);
  if (Ds <= 8) return launch<8>(u, delta, A, Bc, Cc, h0, y, hT, B, S, Di, Ds, s);
  if (Ds <= 16)
    return launch<16>(u, delta, A, Bc, Cc, h0, y, hT, B, S, Di, Ds, s);
  return launch<32>(u, delta, A, Bc, Cc, h0, y, hT, B, S, Di, Ds, s);
}
