// Mamba-1 selective-scan backward on NVIDIA Hopper (sm_90a).
//
// Replaces no TPU kernel: the TPU reference differentiates the scan by
// autodiff of its associative form selective_scan_assoc
// (src/repro/kernels/mamba_scan/ops.py), which keeps every state; without
// this kernel the port's forward (mamba_scan.cu) could not be
// differentiated on the card.  For the forward's float32 inputs u, delta
// (B, S, Di), A (Di, Ds), Bc, Cc (B, S, Ds), h0 (B, Di, Ds) or NULL, and
// the gradients dy (B, S, Di) and dhT (B, Di, Ds) or NULL of its outputs,
// with a_t = exp(delta_t A) and h_t = a_t h_{t-1} + delta_t u_t B_t, it
// walks time backwards:
//     g_t = C_t dy_t + a_{t+1} g_{t+1}          (g_{S-1} adds dhT)
//     du_t = delta_t sum_n g_t B_t
//     ddelta_t = sum_n g_t (h_{t-1} a_t A + u_t B_t)
//     dA = sum_{b,t} g_t h_{t-1} a_t delta_t
//     dB_t = sum_di g_t delta_t u_t,  dC_t = sum_di dy_t h_t
//     dh0 = a_0 g_0
// and writes du, ddelta (B, S, Di), dA (Di, Ds), dB, dC (B, S, Ds) and
// dh0 (B, Di, Ds; when h0 is given), all float32.  Any S >= 1, any Di,
// 1 <= Ds <= 32.
//
// What bounds it on the H100: the inputs (u, delta, dy, Bc, Cc, A, h0,
// dhT) read once and the gradients written once, at 3.35 TB/s; at Hymba's
// training shape ((4, 1152, 3200), Ds 16) ~236 MB, 70 us.  The
// exponentials are 3 a (b, t, di, n) here (two forward recomputations and
// the backward's), 0.7 G at 16 per SM per clock: ~170 us at 1.98 GHz.
//
// Design (simple first).  A block of 256 threads owns CH = 256 / DSP
// channels of one batch row, a thread one state n of one channel (DSP = Ds
// rounded up to a power of two, so a channel's states are DSP adjacent
// lanes of one warp), as the forward kernel keeps its state in registers.
// It never stores the (B, S, Di, Ds) states: a forward pass keeps h at the
// start of every chunk of kChunk steps (a scratch of B * ceil(S / kChunk)
// * Di * Ds floats), then the reverse pass walks the chunks last to first,
// recomputes the chunk's h_t into shared memory (kChunk x 256 floats),
// and runs the reverse recurrence over it.  Sums over n (du, ddelta) are
// shuffles within the channel's lanes; sums over the block's channels (dB,
// dC) go through shared memory in channel order, one partial a block and
// step; dA accumulates over t in each thread's registers, a partial a
// batch row.  A second kernel sums the partials across blocks (dB, dC) and
// batch rows (dA) in a fixed order.  The long sums (dA over S steps, the
// partials over the blocks) are compensated (Kahan): a plain float32 sum
// of thousands of terms drifts by ~1e-5 of their magnitude, more than the
// 1e-4 tolerance leaves where the terms cancel.  No atomics: two calls on
// the same inputs are bitwise equal.  expf throughout.
// The launches run on the caller's stream; the entry returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;   // threads per block
constexpr int kChunk = 32;      // time steps between stored states

__host__ __device__ int n_chunks(int S) {
  return (S + kChunk - 1) / kChunk;
}

// s += x, compensated: c carries the low-order bits s could not hold
__device__ __forceinline__ void kahan_add(float& s, float& c, float x) {
  const float y = x - c;
  const float t = s + y;
  c = (t - s) - y;
  s = t;
}

template <int DSP>
__global__ void __launch_bounds__(kThreads)
scan_bwd_kernel(const float* __restrict__ u, const float* __restrict__ delta,
                const float* __restrict__ A, const float* __restrict__ Bc,
                const float* __restrict__ Cc, const float* __restrict__ h0,
                const float* __restrict__ dy, const float* __restrict__ dhT,
                float* __restrict__ du, float* __restrict__ ddelta,
                float* __restrict__ dh0, float* __restrict__ dA_part,
                float* __restrict__ dB_part, float* __restrict__ dC_part,
                float* __restrict__ ckpt, int S, int Di, int Ds) {
  constexpr int CH = kThreads / DSP;      // channels per block
  __shared__ float hist[kChunk][kThreads];
  __shared__ float red_b[CH][DSP];
  __shared__ float red_c[CH][DSP];

  const int tid = threadIdx.x;
  const int n = tid % DSP;
  const int ch = tid / DSP;
  const int blk = blockIdx.x;
  const int nblk = gridDim.x;
  const int b = blockIdx.y;
  const int di = blk * CH + ch;
  const bool chan = di < Di;
  const bool live = chan && n < Ds;
  const float a_n = live ? A[static_cast<size_t>(di) * Ds + n] : 0.0f;
  const int nc = n_chunks(S);
  const size_t state = (static_cast<size_t>(b) * Di + di) * Ds + n;
  const auto row = [&](int t) {         // (b, t, di) in u, delta, dy, du
    return (static_cast<size_t>(b) * S + t) * Di + di;
  };
  const auto bc = [&](int t) {          // (b, t, n) in Bc, Cc
    return (static_cast<size_t>(b) * S + t) * Ds + n;
  };
  const auto at_ckpt = [&](int c) {
    return ((static_cast<size_t>(b) * nc + c) * Di + di) * Ds + n;
  };

  // forward: h at the start of every chunk
  float h = (live && h0 != nullptr) ? h0[state] : 0.0f;
  for (int t = 0; t < S; ++t) {
    if (t % kChunk == 0 && live) ckpt[at_ckpt(t / kChunk)] = h;
    if (live) {
      const float dl = delta[row(t)];
      h = fmaf(expf(dl * a_n), h, dl * u[row(t)] * Bc[bc(t)]);
    }
  }

  // backward, chunk by chunk from the last
  float g = (live && dhT != nullptr) ? dhT[state] : 0.0f;   // a_{t+1} g_{t+1}
  float dA_acc = 0.0f, dA_c = 0.0f;
  for (int c = nc - 1; c >= 0; --c) {
    const int t0 = c * kChunk;
    const int t1 = min(S, t0 + kChunk);
    const float h_start = live ? ckpt[at_ckpt(c)] : 0.0f;
    float hh = h_start;
    for (int t = t0; t < t1; ++t) {
      if (live) {
        const float dl = delta[row(t)];
        hh = fmaf(expf(dl * a_n), hh, dl * u[row(t)] * Bc[bc(t)]);
      }
      hist[t - t0][tid] = hh;            // read back by this thread only
    }
    for (int t = t1 - 1; t >= t0; --t) {
      const float dl = chan ? delta[row(t)] : 0.0f;
      const float uu = chan ? u[row(t)] : 0.0f;
      const float dyv = chan ? dy[row(t)] : 0.0f;
      const float bn = live ? Bc[bc(t)] : 0.0f;
      const float cn = live ? Cc[bc(t)] : 0.0f;
      const float h_t = hist[t - t0][tid];
      const float h_prev = t > t0 ? hist[t - t0 - 1][tid] : h_start;
      const float a_t = live ? expf(dl * a_n) : 0.0f;
      const float gt = fmaf(cn, dyv, g);               // dL/dh_t
      const float gha = gt * h_prev * a_t;
      float dd = fmaf(gha, a_n, gt * uu * bn);
      float dux = gt * dl * bn;
      kahan_add(dA_acc, dA_c, gha * dl);
      g = a_t * gt;
#pragma unroll
      for (int off = DSP / 2; off > 0; off >>= 1) {
        dd += __shfl_xor_sync(0xffffffffu, dd, off);
        dux += __shfl_xor_sync(0xffffffffu, dux, off);
      }
      if (n == 0 && chan) {
        ddelta[row(t)] = dd;
        du[row(t)] = dux;
      }
      red_b[ch][n] = gt * dl * uu;
      red_c[ch][n] = dyv * h_t;
      __syncthreads();
      if (tid < Ds) {
        float sb = 0.0f, sc = 0.0f;
        for (int cc = 0; cc < CH; ++cc) {
          sb += red_b[cc][tid];
          sc += red_c[cc][tid];
        }
        const size_t p = ((static_cast<size_t>(b) * S + t) * nblk + blk) * Ds
                         + tid;
        dB_part[p] = sb;
        dC_part[p] = sc;
      }
      __syncthreads();
    }
  }
  if (live) {
    dA_part[state] = dA_acc;
    if (dh0 != nullptr) dh0[state] = g;
  }
}

// out[r, x] = sum_j part[r, j, x] over j = 0 .. J - 1 in order, for
// part (rows, J, inner): the cross-block and cross-batch sums.
__global__ void sum_middle_kernel(const float* __restrict__ part,
                                  float* __restrict__ out, int rows, int J,
                                  int inner) {
  const size_t o = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (o >= static_cast<size_t>(rows) * inner) return;
  const size_t r = o / inner;
  const size_t x = o % inner;
  const float* p = part + r * J * inner + x;
  float s = 0.0f, c = 0.0f;
  for (int j = 0; j < J; ++j)
    kahan_add(s, c, p[static_cast<size_t>(j) * inner]);
  out[o] = s;
}

int sum_middle(const float* part, float* out, int rows, int J, int inner,
               cudaStream_t stream) {
  const size_t n = static_cast<size_t>(rows) * inner;
  sum_middle_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0,
                      stream>>>(part, out, rows, J, inner);
  return static_cast<int>(cudaGetLastError());
}

int dsp_of(int Ds) {
  int d = 1;
  while (d < Ds) d *= 2;
  return d;
}

int blocks_of(int Di, int Ds) {
  const int ch = kThreads / dsp_of(Ds);
  return (Di + ch - 1) / ch;
}

template <int DSP>
int launch(const float* u, const float* delta, const float* A,
           const float* Bc, const float* Cc, const float* h0, const float* dy,
           const float* dhT, float* du, float* ddelta, float* dh0,
           float* dA_part, float* dB_part, float* dC_part, float* ckpt, int B,
           int S, int Di, int Ds, cudaStream_t stream) {
  const dim3 grid(blocks_of(Di, Ds), B);
  scan_bwd_kernel<DSP><<<grid, kThreads, 0, stream>>>(
      u, delta, A, Bc, Cc, h0, dy, dhT, du, ddelta, dh0, dA_part, dB_part,
      dC_part, ckpt, S, Di, Ds);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Floats of scratch that mamba_selective_scan_bwd needs for this shape:
// the chunk states, dA's per-row partials and dB's and dC's per-block
// partials.
extern "C" long long mamba_scan_bwd_scratch(int B, int S, int Di, int Ds) {
  if (B <= 0 || S <= 0 || Di <= 0 || Ds <= 0 || Ds > 32) return 0;
  const long long states = static_cast<long long>(B) * Di * Ds;
  const long long per_block = static_cast<long long>(B) * S *
                              blocks_of(Di, Ds) * Ds;
  return states * n_chunks(S) + states + 2 * per_block;
}

// C interface, loaded with ctypes.  The forward's inputs u, delta (B, S,
// Di), A (Di, Ds), Bc, Cc (B, S, Ds), h0 (B, Di, Ds) or NULL; dy (B, S, Di)
// and dhT (B, Di, Ds) or NULL (zeros); outputs du, ddelta (B, S, Di), dA
// (Di, Ds), dB, dC (B, S, Ds), dh0 (B, Di, Ds; NULL when h0 is NULL);
// scratch: mamba_scan_bwd_scratch(B, S, Di, Ds) floats.  All float32,
// contiguous.  S >= 1.  Four launches on stream.  Returns a cudaError_t
// code (0 = launched).
extern "C" int mamba_selective_scan_bwd(
    const float* u, const float* delta, const float* A, const float* Bc,
    const float* Cc, const float* h0, const float* dy, const float* dhT,
    float* du, float* ddelta, float* dA, float* dB, float* dC, float* dh0,
    float* scratch, int B, int S, int Di, int Ds, void* stream) {
  if (B <= 0 || Di <= 0 || Ds <= 0) return static_cast<int>(cudaSuccess);
  if (S <= 0 || Ds > 32 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long states = static_cast<long long>(B) * Di * Ds;
  const int nblk = blocks_of(Di, Ds);
  const long long per_block = static_cast<long long>(B) * S * nblk * Ds;
  float* ckpt = scratch;
  float* dA_part = ckpt + states * n_chunks(S);
  float* dB_part = dA_part + states;
  float* dC_part = dB_part + per_block;
  int rc;
  switch (dsp_of(Ds)) {
    case 1: rc = launch<1>(u, delta, A, Bc, Cc, h0, dy, dhT, du, ddelta, dh0,
                           dA_part, dB_part, dC_part, ckpt, B, S, Di, Ds, s);
            break;
    case 2: rc = launch<2>(u, delta, A, Bc, Cc, h0, dy, dhT, du, ddelta, dh0,
                           dA_part, dB_part, dC_part, ckpt, B, S, Di, Ds, s);
            break;
    case 4: rc = launch<4>(u, delta, A, Bc, Cc, h0, dy, dhT, du, ddelta, dh0,
                           dA_part, dB_part, dC_part, ckpt, B, S, Di, Ds, s);
            break;
    case 8: rc = launch<8>(u, delta, A, Bc, Cc, h0, dy, dhT, du, ddelta, dh0,
                           dA_part, dB_part, dC_part, ckpt, B, S, Di, Ds, s);
            break;
    case 16: rc = launch<16>(u, delta, A, Bc, Cc, h0, dy, dhT, du, ddelta,
                             dh0, dA_part, dB_part, dC_part, ckpt, B, S, Di,
                             Ds, s);
             break;
    default: rc = launch<32>(u, delta, A, Bc, Cc, h0, dy, dhT, du, ddelta,
                             dh0, dA_part, dB_part, dC_part, ckpt, B, S, Di,
                             Ds, s);
  }
  if (rc != 0) return rc;
  rc = sum_middle(dA_part, dA, 1, B, Di * Ds, s);
  if (rc != 0) return rc;
  rc = sum_middle(dB_part, dB, B * S, nblk, Ds, s);
  if (rc != 0) return rc;
  return sum_middle(dC_part, dC, B * S, nblk, Ds, s);
}
