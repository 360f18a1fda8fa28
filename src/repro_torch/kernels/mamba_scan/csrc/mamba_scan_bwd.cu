// Mamba-1 selective-scan backward on NVIDIA Hopper (sm_90a).
//
// Replaces no TPU kernel: the TPU reference differentiates the scan by
// autodiff of its associative form selective_scan_assoc
// (src/repro/kernels/mamba_scan/ops.py), which keeps every state; without
// this kernel the port's forward (mamba_scan.cu) could not be
// differentiated on the card.  For the forward's float32 inputs u, delta
// (B, S, Di), A (Di, Ds), Bc, Cc (B, S, Ds), its states at the start of
// every chunk of kT = kStateChunk = 16 steps (mamba_scan_chunk.cuh; B,
// ceil(S / kT), Di, Ds; chunk 0's is h0 or zeros;
// mamba_selective_scan_states writes them), and the gradients dy (B, S,
// Di) and dhT (B, Di, Ds) or NULL of its outputs, with a_t =
// exp(delta_t A) and h_t = a_t h_{t-1} + delta_t u_t B_t, it walks time
// backwards:
//     g_t = C_t dy_t + a_{t+1} g_{t+1}          (g_{S-1} adds dhT)
//     du_t = delta_t sum_n g_t B_t
//     ddelta_t = sum_n g_t (h_{t-1} a_t A + u_t B_t)
//     dA = sum_{b,t} g_t h_{t-1} a_t delta_t
//     dB_t = sum_di g_t delta_t u_t,  dC_t = sum_di dy_t h_t
//     dh0 = a_0 g_0
// and writes du, ddelta (B, S, Di), dA (Di, Ds), dB, dC (B, S, Ds) and
// dh0 (B, Di, Ds; when asked), all float32.  Any S >= 1, any Di,
// 1 <= Ds <= 32.
//
// What bounds it on the H100.  Two floors, at Hymba's training shape
// ((4, 1152, 3200), Ds 16): bytes, the inputs (u, delta, dy, Bc, Cc, A,
// dhT) read once and the gradients written once, ~296 MB at 3.35 TB/s,
// 88.5 us; exponentials, one exp(delta A) per (b, t, di, n) that the
// gradient needs, 235.9 M on the special-function units at 16 per SM per
// clock, 56-64 us at 1.98-1.755 GHz.  This kernel takes 2.5 (the
// recomputation, half of it twice, and the reverse walk; the forward's
// own is paid in the forward) and reads the saved states (59 MB at that
// shape).  Every (b, di, n) is a chain over all S steps, so only B Di Ds
// / NS threads exist (1600 warps at that shape) and what bounds it in
// practice is running ~160 instructions a thread and step (~40 a state:
// the recomputation, the reverse step's 11 operations, the sums) at the
// ~0.45 instructions a clock that 14 warps an SM reach: registers (128 a
// thread, two 7-warp blocks an SM) allow no more warps.
//
// Design.  A thread owns NS states of one channel, G threads a channel
// (as the forward kernel), W warps a block (CH = 32 W / G channels of one
// batch row; W is chosen per shape so that the busiest SM holds the
// fewest warps: the grid fills the card in balanced waves).  Chunks of kT
// = 16 steps are walked from the last, each in two halves of kF = 8 steps:
// the chunk's inputs (u, delta, dy side by side, Bc, Cc) are staged into
// shared memory by cp.async one chunk ahead, so the walks read shared
// memory only; the chunk's start state comes from the forward (loaded a
// chunk ahead); a half's 8 states are recomputed into registers
// (ex2.approx(delta A log2 e), the forward's very arithmetic, so they
// equal the forward's bit for bit; the second half of a chunk first
// recomputes the first half's 8 steps to reach its start), and the
// reverse recurrence runs over them with no test per step (a full half;
// the last, ragged chunk takes a tested path).  Sums over n (du, ddelta)
// are in-thread sums plus shuffles among the channel's G lanes.  Sums
// over the block's channels (dB, dC): each step a thread stores its dB and
// dC terms to a padded row of a buffer in shared memory; after a half one
// barrier, kParts threads a column sum its channels' rows in fixed ranges
// and order, and the ranges are added in order into the block's partial:
// no block barrier per step.  dA accumulates over each chunk in registers
// and across chunks compensated (Kahan), a partial a batch row.  A second
// kernel sums the partials across blocks (dB, dC, compensated, in block
// order) and batch rows (dA): a plain float32 sum of thousands of terms
// drifts by ~1e-5 of their magnitude, more than the 1e-4 tolerance leaves
// where the terms cancel.  No atomics: two calls on the same inputs are
// bitwise equal.
// The launches run on the caller's stream; the entry returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stddef.h>

#include <type_traits>

#include "mamba_scan_chunk.cuh"

namespace {

constexpr int kT = kStateChunk; // steps a chunk: the forward's state spacing
constexpr int kF = 8;           // steps between flushes of the channel sums
constexpr int kMaxWarps = 8;    // warps a block, at most
constexpr int kMinWarps = 4;    // and at least
constexpr int kParts = 2;       // threads that share a column's channel sum
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// s += x, compensated: c carries the low-order bits s could not hold
__device__ __forceinline__ void kahan_add(float& s, float& c, float x) {
  const float y = x - c;
  const float t = s + y;
  c = (t - s) - y;
  s = t;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__host__ __device__ constexpr int n_chunks(int S) { return (S + kT - 1) / kT; }

// Floats of shared memory a block of W warps uses: the staged inputs of
// two chunks (u, delta, dy of each channel and step side by side, padded
// to 4: kT x CH x 4; Bc, Cc: kT x 2 x DSP) and the channel-sum buffer (kF
// x CH rows of kRow floats: a channel's dB and dC terms, 2 DSP, padded
// against bank conflicts).
template <int NS, int G>
__host__ __device__ constexpr int smem_floats(int W) {
  return 2 * kT * 4 * (32 / G) * W + 2 * kT * 2 * NS * G +
         kF * (32 / G) * W * (2 * NS * G + 4) + kF * 2 * NS * G * kParts;
}

// NS consecutive floats of shared memory from v, or into v (16-byte
// aligned when NS is 4).
template <int NS>
__device__ __forceinline__ void store_shared(float* p, const float (&v)[NS]) {
  if constexpr (NS == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < NS; ++j) p[j] = v[j];
  }
}

template <int NS>
__device__ __forceinline__ void load_shared(float (&v)[NS], const float* p) {
  if constexpr (NS == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  } else {
#pragma unroll
    for (int j = 0; j < NS; ++j) v[j] = p[j];
  }
}

template <int NS, int G>
__global__ void __launch_bounds__(32 * kMaxWarps, 2)
scan_bwd_kernel(const float* __restrict__ u, const float* __restrict__ delta,
                const float* __restrict__ A, const float* __restrict__ Bc,
                const float* __restrict__ Cc,
                const float* __restrict__ states,
                const float* __restrict__ dy, const float* __restrict__ dhT,
                float* __restrict__ du, float* __restrict__ ddelta,
                float* __restrict__ dh0, float* __restrict__ dA_part,
                float* __restrict__ bc_part, int S, int Di, int Ds) {
  constexpr int DSP = NS * G;          // states a channel, padded
  constexpr int CW = 32 / G;           // channels a warp
  constexpr int kRow = 2 * DSP + 4;    // floats a channel row of s_red
  static_assert(kT == 2 * kF, "a chunk is two halves of kF steps");
  const int W = blockDim.x / 32;
  const int CH = CW * W;               // channels a block
  extern __shared__ float smem[];
  float* s_in = smem;                          // [2][kT][CH][4]
  float* s_bc = s_in + 2 * kT * 4 * CH;        // [2][kT][2][DSP]
  float* s_red = s_bc + 2 * kT * 2 * DSP;      // [kF][CH][kRow]
  float* s_part = s_red + kF * CH * kRow;      // [kF][2 DSP][kParts]

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int c = warp * CW + lane % CW;         // channel in the block
  const int n0 = (lane / CW) * NS;             // first state of the thread
  const int blk = blockIdx.x;
  const int nblk = gridDim.x;
  const int b = blockIdx.y;
  const int di0 = blk * CH;
  const int di = di0 + c;
  const bool live = di < Di;
  const bool writer = live && n0 == 0;
  const int nc = n_chunks(S);
  const size_t brow = static_cast<size_t>(b) * S;   // (b, 0) of B * S rows

  // chunk k's rows of u, delta, dy (the block's channels, side by side)
  // and of Bc, Cc into stage k % 2, 4 bytes a copy; channels past Di and
  // states past Ds are zero-filled, so padded states and channels carry
  // zeros
  const auto stage = [&](int k) {
    const int t0 = k * kT;
    const int steps = min(kT, S - t0);
    float* in = s_in + (k & 1) * kT * 4 * CH;
    for (int rw = warp; rw < 3 * steps; rw += W) {
      const int i = rw / 3, which = rw - 3 * i;
      const float* src = which == 0 ? u : which == 1 ? delta : dy;
      for (int q = lane; q < CH; q += 32) {
        const bool ok = di0 + q < Di;
        cp_async4(in + (i * CH + q) * 4 + which,
                  src + (brow + t0 + i) * Di + (ok ? di0 + q : 0), ok);
      }
    }
    float* bc = s_bc + (k & 1) * kT * 2 * DSP;
    for (int rw = warp; rw < 2 * steps; rw += W) {
      const int i = rw >> 1;
      const float* src = (rw & 1) ? Cc : Bc;
      for (int q = lane; q < DSP; q += 32) {
        const bool ok = q < Ds;
        cp_async4(bc + rw * DSP + q, src + (brow + t0 + i) * Ds + (ok ? q : 0),
                  ok);
      }
    }
  };
  const auto load_state = [&](float (&h)[NS], int k) {
    const float* row =
        states + ((static_cast<size_t>(b) * nc + k) * Di + di) * Ds;
#pragma unroll
    for (int j = 0; j < NS; ++j)
      h[j] = live && n0 + j < Ds ? __ldg(row + n0 + j) : 0.0f;
  };

  stage(nc - 1);
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  float a2[NS], an[NS], g[NS], hnext[NS];
  float dA_s[NS], dA_c[NS];
  const size_t st = (static_cast<size_t>(b) * Di + di) * Ds;
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    const bool in = live && n0 + j < Ds;
    an[j] = in ? A[static_cast<size_t>(di) * Ds + n0 + j] : 0.0f;
    a2[j] = an[j] * kLog2e;
    g[j] = in && dhT != nullptr ? dhT[st + n0 + j] : 0.0f;
    dA_s[j] = dA_c[j] = 0.0f;
  }
  load_state(hnext, nc - 1);

  for (int k = nc - 1; k >= 0; --k) {
    // chunk k has landed; every thread is done with chunk k + 1's stage
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    if (k > 0) stage(k - 1);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    float hs[NS];                       // h_{t0 - 1}
#pragma unroll
    for (int j = 0; j < NS; ++j) hs[j] = hnext[j];
    if (k > 0) load_state(hnext, k - 1);

    const int t0 = k * kT;
    const int steps = min(kT, S - t0);
    const float* in = s_in + (k & 1) * kT * 4 * CH + c * 4;
    const float* bc = s_bc + (k & 1) * kT * 2 * DSP + n0;
    float* du_k = du + (brow + t0) * Di + di;
    float* dd_k = ddelta + (brow + t0) * Di + di;
    float dAk[NS];
#pragma unroll
    for (int j = 0; j < NS; ++j) dAk[j] = 0.0f;

    // One half of the chunk: steps lo .. lo + n - 1 (lo 0 or kF), in a
    // full half (kFull: n == kF) with no test of n.  Recomputes their
    // states from h_{t0 - 1} into registers, walks them backwards, then
    // writes the block's sums of dB and dC over its channels for them.
    const auto half = [&](auto full, int lo, int n) {
      constexpr bool kFull = decltype(full)::value;
      float h[NS];
#pragma unroll
      for (int j = 0; j < NS; ++j) h[j] = hs[j];
      if (lo > 0) {                     // to h_{t0 + kF - 1}
#pragma unroll
        for (int i = 0; i < kF; ++i) {
          const float4 x = *reinterpret_cast<const float4*>(in + i * CH * 4);
          float bv[NS];
          load_shared(bv, bc + 2 * i * DSP);
          const float dlu = x.y * x.x;
#pragma unroll
          for (int j = 0; j < NS; ++j)
            h[j] = fmaf(ex2(x.y * a2[j]), h[j], dlu * bv[j]);
        }
      }
      float hp0[NS];                    // h_{t0 + lo - 1}
#pragma unroll
      for (int j = 0; j < NS; ++j) hp0[j] = h[j];
      float hist[kF][NS];               // h_{t0 + lo + i}
#pragma unroll
      for (int i = 0; i < kF; ++i) {
        if (kFull || i < n) {
          const float4 x =
              *reinterpret_cast<const float4*>(in + (lo + i) * CH * 4);
          float bv[NS];
          load_shared(bv, bc + 2 * (lo + i) * DSP);
          const float dlu = x.y * x.x;
#pragma unroll
          for (int j = 0; j < NS; ++j)
            h[j] = fmaf(ex2(x.y * a2[j]), h[j], dlu * bv[j]);
        }
#pragma unroll
        for (int j = 0; j < NS; ++j) hist[i][j] = h[j];
      }
#pragma unroll
      for (int i = kF - 1; i >= 0; --i) {
        if (kFull || i < n) {
          const float4 x =
              *reinterpret_cast<const float4*>(in + (lo + i) * CH * 4);
          const float uu = x.x, dl = x.y, dyv = x.z;
          const float dlu = dl * uu;
          float bv[NS], cv[NS];
          load_shared(bv, bc + 2 * (lo + i) * DSP);
          load_shared(cv, bc + (2 * (lo + i) + 1) * DSP);
          float dd = 0.0f, gb = 0.0f;
          float vb[NS], vc[NS];        // this step's dB and dC terms
#pragma unroll
          for (int j = 0; j < NS; ++j) {
            const float a = ex2(dl * a2[j]);
            const float hp = i > 0 ? hist[i > 0 ? i - 1 : 0][j] : hp0[j];
            const float gt = fmaf(cv[j], dyv, g[j]);    // dL / dh_t
            const float gha = gt * (a * hp);
            dd = fmaf(gha, an[j], dd);
            gb = fmaf(gt, bv[j], gb);
            dAk[j] = fmaf(gha, dl, dAk[j]);
            g[j] = a * gt;
            vb[j] = gt * dlu;
            vc[j] = dyv * hist[i][j];
          }
#pragma unroll
          for (int off = CW; off < 32; off <<= 1) {
            dd += __shfl_xor_sync(0xffffffffu, dd, off);
            gb += __shfl_xor_sync(0xffffffffu, gb, off);
          }
          if (writer) {
            dd_k[(lo + i) * Di] = fmaf(uu, gb, dd);
            du_k[(lo + i) * Di] = dl * gb;
          }
          float* row = s_red + (i * CH + c) * kRow + n0;
          store_shared(row, vb);
          store_shared(row + DSP, vc);
        }
      }
      // the block's sums over its channels: kVec columns of a step (column
      // x = which DSP + state of the 2 DSP) a work item, its channels in
      // kParts ranges summed by kParts threads, then the ranges in order
      // (states past Ds are not written)
      __syncthreads();
      constexpr int kVec = DSP % 4 == 0 ? 4 : 1;
      constexpr int kCols = 2 * DSP / kVec;
      const int items = n * kCols;
      const int per = (CH + kParts - 1) / kParts;
      for (int o = tid; o < items * kParts; o += blockDim.x) {
        const int item = o / kParts, part = o % kParts;
        const int ii = item / kCols, x = kVec * (item % kCols);
        const float* col = s_red + ii * CH * kRow + x;
        float sum[kVec];
#pragma unroll
        for (int e = 0; e < kVec; ++e) sum[e] = 0.0f;
        for (int cc = part * per; cc < min(CH, part * per + per); ++cc) {
          float t[kVec];
          load_shared(t, col + cc * kRow);
#pragma unroll
          for (int e = 0; e < kVec; ++e) sum[e] += t[e];
        }
        store_shared(s_part + o * kVec, sum);
      }
      __syncthreads();
      for (int item = tid; item < items; item += blockDim.x) {
        const int ii = item / kCols, x = kVec * (item % kCols);
        float sum[kVec];
        load_shared(sum, s_part + item * kParts * kVec);
        for (int part = 1; part < kParts; ++part) {
          float t[kVec];
          load_shared(t, s_part + (item * kParts + part) * kVec);
#pragma unroll
          for (int e = 0; e < kVec; ++e) sum[e] += t[e];
        }
        float* out = bc_part + ((brow + t0 + lo + ii) * nblk + blk) * 2 * Ds;
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          const int nn = (x + e) % DSP;
          if (nn < Ds) out[(x + e) / DSP * Ds + nn] = sum[e];
        }
      }
      __syncthreads();
    };
    using Full = std::integral_constant<bool, true>;
    using Ragged = std::integral_constant<bool, false>;
    if (steps == kT) {
      half(Full{}, kF, kF);
      half(Full{}, 0, kF);
    } else {
      if (steps > kF) half(Ragged{}, kF, steps - kF);
      half(Ragged{}, 0, min(steps, kF));
    }
#pragma unroll
    for (int j = 0; j < NS; ++j) kahan_add(dA_s[j], dA_c[j], dAk[j]);
  }

#pragma unroll
  for (int j = 0; j < NS; ++j) {
    if (!live || n0 + j >= Ds) continue;
    dA_part[st + n0 + j] = dA_s[j];
    if (dh0 != nullptr) dh0[st + n0 + j] = g[j];
  }
}

// dB, dC (B * S rows of Ds) from the per-block partials (B * S, nblk, 2 Ds)
// in block order, and dA (Di * Ds) from the per-row partials (B, Di * Ds)
// in row order; compensated sums.
__global__ void sum_partials_kernel(const float* __restrict__ bc_part,
                                    const float* __restrict__ dA_part,
                                    float* __restrict__ dB,
                                    float* __restrict__ dC,
                                    float* __restrict__ dA, int rows,
                                    int nblk, int B, int DiDs, int Ds) {
  const size_t o = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const size_t n_bc = static_cast<size_t>(rows) * 2 * Ds;
  float s = 0.0f, c = 0.0f;
  if (o < n_bc) {
    const size_t r = o / (2 * Ds);
    const int v = static_cast<int>(o % (2 * Ds));
    const float* p = bc_part + r * nblk * 2 * Ds + v;
    for (int j = 0; j < nblk; ++j)
      kahan_add(s, c, p[static_cast<size_t>(j) * 2 * Ds]);
    if (v < Ds) dB[r * Ds + v] = s;
    else dC[r * Ds + v - Ds] = s;
  } else if (o < n_bc + DiDs) {
    const size_t x = o - n_bc;
    for (int j = 0; j < B; ++j)
      kahan_add(s, c, dA_part[static_cast<size_t>(j) * DiDs + x]);
    dA[x] = s;
  }
}

template <int NS_, int G_>
struct Variant {
  static constexpr int NS = NS_, G = G_;
};

// The variant for a state size: NS states a thread (at most 4, so a
// chunk's states fit registers), G threads a channel.
template <class F>
int dispatch(int Ds, F&& f) {
  if (Ds <= 1) return f(Variant<1, 1>{});
  if (Ds <= 2) return f(Variant<2, 1>{});
  if (Ds <= 4) return f(Variant<4, 1>{});
  if (Ds <= 8) return f(Variant<4, 2>{});
  if (Ds <= 16) return f(Variant<4, 4>{});
  return f(Variant<4, 8>{});
}

// The launch for (B, Di) and a variant: out[0] = warps a block, out[1] =
// blocks a batch row, out[2] = blocks one SM holds at once, out[3] =
// dynamic shared memory bytes.  W (kMinWarps .. kMaxWarps: fewer warps a
// block would multiply the partials) minimizes the warps the busiest SM
// runs, ceil(blocks / SMs) x W in one wave, waves x (blocks an SM holds)
// x W in more; on a tie the larger W, whose fewer blocks write fewer
// partials.
template <int NS, int G>
cudaError_t plan(int B, int Di, int* out) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(
        scan_bwd_kernel<NS, G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(sizeof(float)) * smem_floats<NS, G>(kMaxWarps));
  if (e != cudaSuccess) return e;
  long long best = -1;
  for (int W = kMaxWarps; W >= kMinWarps; --W) {
    const int ch = W * (32 / G);
    const int per_row = (Di + ch - 1) / ch;
    const int smem = static_cast<int>(sizeof(float)) * smem_floats<NS, G>(W);
    int per_sm = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, scan_bwd_kernel<NS, G>, 32 * W, smem);
    if (e != cudaSuccess) return e;
    if (per_sm == 0) continue;
    const long long blocks = static_cast<long long>(B) * per_row;
    const long long per_sm_needed = (blocks + sms - 1) / sms;
    const long long cost =
        per_sm_needed <= per_sm
            ? per_sm_needed * W
            : (blocks + sms * per_sm - 1) / (sms * per_sm) * per_sm * W;
    if (best < 0 || cost < best) {
      best = cost;
      out[0] = W;
      out[1] = per_row;
      out[2] = per_sm;
      out[3] = smem;
    }
  }
  return best < 0 ? cudaErrorInvalidConfiguration : cudaSuccess;
}

}  // namespace

// The launch a scan backward of this shape gets: out[0] = warps a block,
// out[1] = blocks a batch row, out[2] = blocks one SM can hold at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), out[3] = dynamic shared
// memory bytes, out[4] = G (threads a channel), out[5] = NS (states a
// thread).  Returns a cudaError_t code.
extern "C" int mamba_scan_bwd_split(int B, int Di, int Ds, int* out) {
  if (B <= 0 || Di <= 0 || Ds <= 0 || Ds > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(Ds, [&](auto v) {
    using V = decltype(v);
    out[4] = V::G;
    out[5] = V::NS;
    return static_cast<int>(plan<V::NS, V::G>(B, Di, out));
  });
}

// C interface, loaded with ctypes.  The forward's inputs u, delta (B, S,
// Di), A (Di, Ds), Bc, Cc (B, S, Ds) and its chunk states (B, ceil(S /
// kStateChunk), Di, Ds) from mamba_selective_scan_states; dy (B, S, Di) and
// dhT (B, Di, Ds) or NULL (zeros); outputs du, ddelta (B, S, Di), dA (Di,
// Ds), dB, dC (B, S, Ds), dh0 (B, Di, Ds) or NULL (not wanted); split: the
// six ints mamba_scan_bwd_split gave for (B, Di, Ds) on this device (the
// caller keeps them: the plan and its occupancy queries run once a shape);
// scratch: B Di Ds + B S split[1] 2 Ds floats (dA's per-row partials, dB's
// and dC's per-block partials).  All float32, contiguous.  S >= 1.  Two
// launches on stream.  Returns a cudaError_t code (0 = launched).
extern "C" int mamba_selective_scan_bwd(
    const float* u, const float* delta, const float* A, const float* Bc,
    const float* Cc, const float* states, const float* dy, const float* dhT,
    float* du, float* ddelta, float* dA, float* dB, float* dC, float* dh0,
    const int* split, float* scratch, int B, int S, int Di, int Ds,
    void* stream) {
  if (B <= 0 || Di <= 0 || Ds <= 0) return static_cast<int>(cudaSuccess);
  if (S <= 0 || Ds > 32 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rc = dispatch(Ds, [&](auto v) {
    using V = decltype(v);
    const bool fits = split[4] == V::G && split[5] == V::NS &&
                      split[0] >= kMinWarps && split[0] <= kMaxWarps &&
                      static_cast<long long>(split[1]) * split[0] *
                              (32 / V::G) >= Di;
    return static_cast<int>(fits ? cudaSuccess : cudaErrorInvalidValue);
  });
  if (rc != 0) return rc;
  float* dA_part = scratch;
  float* bc_part = dA_part + static_cast<size_t>(B) * Di * Ds;
  const dim3 grid(split[1], B);
  const int threads = 32 * split[0];
  const int err = dispatch(Ds, [&](auto v) {
    using V = decltype(v);
    scan_bwd_kernel<V::NS, V::G><<<grid, threads, split[3], s>>>(
        u, delta, A, Bc, Cc, states, dy, dhT, du, ddelta, dh0, dA_part,
        bc_part, S, Di, Ds);
    return static_cast<int>(cudaGetLastError());
  });
  if (err != 0) return err;
  const size_t n = static_cast<size_t>(B) * S * 2 * Ds +
                   static_cast<size_t>(Di) * Ds;
  sum_partials_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, s>>>(
      bc_part, dA_part, dB, dC, dA, B * S, split[1], B, Di * Ds, Ds);
  return static_cast<int>(cudaGetLastError());
}
