// Mamba-1 selective scan on NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/mamba_scan/mamba_scan.py
// (selective_scan_pallas / _scan_kernel).  For float32 u, delta (B, S, Di),
// A (Di, Ds), Bc, Cc (B, S, Ds) and an optional h0 (B, Di, Ds), all
// row-major, walks time sequentially:
//     h_t = exp(delta_t A) * h_{t-1} + (delta_t u_t) B_t^T,
//     y_t = h_t C_t,
// and writes y (B, S, Di) and the final state h_T (B, Di, Ds), float32.
// Any S >= 0, any Di, 1 <= Ds <= 32.
//
// What bounds it on the H100.  Two floors, at the Hymba prefill shape
// (u (4, 1152, 3200), Ds 16):
// - bytes: u, delta and y (plus the small A, Bc, Cc, h0, h_T) once each,
//   ~179 MB at 3.35 TB/s: 53 us;
// - exponentials: one exp(delta A) per (b, t, di, n), 235.9 M of them, on
//   the special-function units at 16 per SM per clock: 56-64 us at
//   1.98-1.755 GHz.  The rest is 4 FP32 operations per element (the two
//   products, the update FMA, the output FMA), ~14 us at 67 TFLOP/s.
// Tensor cores do not apply: Mamba-1's decay exp(delta_t A[di, n]) differs
// per (di, n), so the chunked matrix form of Mamba-2 (one scalar decay per
// head and step, which turns the scan into products of a decay-masked
// matrix) does not exist here.  The work stays on the FP32 pipes and the
// SFUs, and the SFU floor sits above the byte floor.
//
// Design.  The TPU kernel walks time in a fori_loop over a VMEM-resident
// (Di, Ds) state and carries it across a sequential chunk grid axis.  Here
// the state lives in registers and a block (one warp) owns 32 / G (b, di)
// channels for the whole sequence (no split of time: a chunked scan would
// need a second pass of exponentials or a fix-up, doubling the SFU floor,
// and the channels already fill the card).
// - A thread owns NS states of one channel and G threads (G = Ds / NS
//   rounded up to a power of two, NS <= 8) share the channel, so y_t is NS
//   in-thread FMAs plus log2(G) shuffles.  At Ds 16, G = 2: 800 warps for
//   the card's 528 schedulers (SM sub-partitions).  Each sub-partition has
//   its own 4 SFU lanes, so the floor is set by the busiest one: with 800
//   warps some hold 2, i.e. 2 x 8 states x 1152 steps x 8 clocks per warp
//   exponential = 147 k clocks, 74-84 us.  G = 1 (400 warps of 16 states)
//   and G = 4 (1600 warps of 4) give the same busiest sub-partition, and
//   ran slower (fewer warps to hide latency; more shuffles).
// - Exponentials run ahead of the update: a'_n = a_n log2(e) is held in
//   registers, exp(delta a_n) = ex2.approx.ftz(delta a'_n) is one MUFU.EX2
//   with no range reduction, and each run of U staged steps computes all
//   its exponentials (they depend on delta and a only, not on h) before
//   its updates, so the SFUs work under the FMA chain.  Accuracy: the
//   argument carries ~1 ulp of relative error from rounding a' and the
//   product, so exp's relative error is at most ~|delta a| 2^-23 plus
//   ex2's own ~2^-22; its absolute error is below max_x |x| e^-|x| 2^-23
//   + 2^-22, i.e. ~3e-7 at any delta.  Unlike __expf (whose error grows
//   as 2 + 1.17 |x| ulp through its own scaling), nothing here grows with
//   |x| beyond the rounding of the argument, and where |x| is large exp
//   is tiny: each step's error stays ~1e-7 of |h|, and the decay damps it
//   as it carries through h, far inside the 1e-4 tolerance.
// - u, delta, Bc and Cc are staged in shared memory by cp.async in a ring
//   of kStages tiles of kSteps time steps, kStages - 1 tiles ahead of the
//   compute: 16-byte copies from addresses each thread computes once when
//   every row is 16-byte aligned (Di and Ds multiples of 4), else 4-byte
//   copies; channels past Di and states past Ds are zero-filled by the
//   copy (src-size 0), so padded states carry zeros.  Bc and Cc rows are
//   read as float4 broadcasts.  y_t is stored straight from the registers
//   of the channel's first thread: a warp writes 32 / G consecutive floats
//   of a row per step.  The ring is static shared memory, 24 KB at Ds 16:
//   occupancy lets 9 blocks share an SM, and the 800-block prefill grid
//   puts at most 7 on one of the 132 SMs, so it runs in one wave.  The
//   same ring as dynamic shared memory ran slower on the H100.
// - What bounds it in practice is issuing ~53 instructions per warp
//   and step (8 each of the two products, the exponential and the two
//   FMAs, and the loads, shuffle and store around them) on sub-partitions
//   that hold 2 warps, beside the SFU floor: taking away the exponentials,
//   or the B/C loads (each thread receives its 8 B and 8 C values a step
//   through shared memory), or the staging, each made it faster, and none
//   alone reached the floors.
// - One kernel for every S: the full tiles run the unrolled path, the last
//   partial tile (all of a decode step, S = 1) one step at a time; nothing
//   is staged or computed past S.  No atomics: the result is bitwise the
//   same from run to run.
// - With a non-null `states` (training: mamba_selective_scan_states) it
//   also writes h at the start of every chunk of kStateChunk = 16 steps,
//   (B, ceil(S / 16), Di, Ds), which the backward (mamba_scan_bwd.cu)
//   starts its recomputation from.  That is an instantiation of its own
//   (kKeep): with states null the kernel is the serving one, unchanged in
//   code, bits and time.
// The kernel launches on the caller's stream and the C entry returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "mamba_scan_chunk.cuh"

namespace {

constexpr int kWarps = 1;       // warps per block
constexpr int kSteps = 32;      // time steps per staged tile
constexpr int kStages = 3;      // tiles in the cp.async ring
constexpr float kLog2e = 1.4426950408889634f;

template <int CH, int DSP>
struct __align__(16) Tiles {
  float u[kStages][kSteps][CH];
  float d[kStages][kSteps][CH];
  float b[kStages][kSteps][DSP];
  float c[kStages][kSteps][DSP];
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Copy kBytes (16 or 4) from global to shared memory, or zero-fill the
// destination when !in (src-size 0: nothing is read).
template <int kBytes>
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool in) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = in ? kBytes : 0;
  if constexpr (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(n) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(n) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stage rows row .. row + steps - 1 (of the B * S rows; steps <= kSteps)
// of the block's channels of u and delta and of Bc, Cc into ring slot s,
// 4 bytes a copy.
template <int CH, int DSP, int NT>
__device__ __forceinline__ void stage(Tiles<CH, DSP>& sm, int s,
                                      const float* __restrict__ u,
                                      const float* __restrict__ delta,
                                      const float* __restrict__ Bc,
                                      const float* __restrict__ Cc,
                                      size_t row, int steps, int Di, int Ds,
                                      int di0) {
  const int tid = threadIdx.x;
  for (int e = tid; e < steps * CH; e += NT) {
    const int t = e / CH, q = e % CH;
    const bool in = di0 + q < Di;
    const size_t at = (row + t) * Di + (in ? di0 + q : 0);
    cp_async<4>(&sm.u[s][t][q], u + at, in);
    cp_async<4>(&sm.d[s][t][q], delta + at, in);
  }
  for (int e = tid; e < steps * DSP; e += NT) {
    const int t = e / DSP, q = e % DSP;
    const bool in = q < Ds;
    const size_t at = (row + t) * Ds + (in ? q : 0);
    cp_async<4>(&sm.b[s][t][q], Bc + at, in);
    cp_async<4>(&sm.c[s][t][q], Cc + at, in);
  }
}

// The same, 16 bytes a copy, when every row is 16-byte aligned: each
// thread copies the same 16-byte pieces of rows kRows apart, from
// addresses it computes once.  kFull: steps == kSteps, known at compile
// time (a full tile checks no step bound).
template <int CH, int DSP, int NT, bool kFull>
__device__ __forceinline__ void stage16(Tiles<CH, DSP>& sm, int s,
                                        const float* __restrict__ u,
                                        const float* __restrict__ delta,
                                        const float* __restrict__ Bc,
                                        const float* __restrict__ Cc,
                                        size_t row, int steps, int Di, int Ds,
                                        int di0) {
  static_assert(DSP % 4 == 0, "16-byte pieces of B and C rows");
  const int tid = threadIdx.x;
  constexpr int kQ = CH / 4, kRows = NT / kQ;
  const int q = 4 * (tid % kQ);
  const bool in = di0 + q < Di;
  const size_t at = (row + tid / kQ) * Di + (in ? di0 + q : 0);
#pragma unroll
  for (int p = 0; p < (kSteps + kRows - 1) / kRows; ++p) {
    const int t = tid / kQ + p * kRows;
    if (kFull || t < steps) {
      const size_t off = at + static_cast<size_t>(p * kRows) * Di;
      cp_async<16>(&sm.u[s][t][q], u + off, in);
      cp_async<16>(&sm.d[s][t][q], delta + off, in);
    }
  }
  constexpr int kQs = DSP / 4, kRowsBC = NT / kQs;
  const int qs = 4 * (tid % kQs);
  const bool ins = qs < Ds;
  const size_t ats = (row + tid / kQs) * Ds + (ins ? qs : 0);
#pragma unroll
  for (int p = 0; p < (kSteps + kRowsBC - 1) / kRowsBC; ++p) {
    const int t = tid / kQs + p * kRowsBC;
    if (kFull || t < steps) {
      const size_t off = ats + static_cast<size_t>(p * kRowsBC) * Ds;
      cp_async<16>(&sm.b[s][t][qs], Bc + off, ins);
      cp_async<16>(&sm.c[s][t][qs], Cc + off, ins);
    }
  }
}

// v[j] = row[n0 + j] for n0 + j < Ds, else 0.
template <int NS>
__device__ __forceinline__ void load_states(float (&v)[NS],
                                            const float* __restrict__ row,
                                            int n0, int Ds, bool vec) {
  if constexpr (NS % 4 == 0) {
    if (vec) {
#pragma unroll
      for (int q = 0; q < NS; q += 4) {
        const float4 x = n0 + q < Ds
            ? __ldg(reinterpret_cast<const float4*>(row + n0 + q))
            : make_float4(0.f, 0.f, 0.f, 0.f);
        v[q] = x.x; v[q + 1] = x.y; v[q + 2] = x.z; v[q + 3] = x.w;
      }
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < NS; ++j) v[j] = n0 + j < Ds ? __ldg(row + n0 + j) : 0.f;
}

template <int NS>
__device__ __forceinline__ void store_states(const float (&v)[NS],
                                             float* __restrict__ row, int n0,
                                             int Ds, bool vec) {
  if constexpr (NS % 4 == 0) {
    if (vec) {
#pragma unroll
      for (int q = 0; q < NS; q += 4)
        if (n0 + q < Ds)
          *reinterpret_cast<float4*>(row + n0 + q) =
              make_float4(v[q], v[q + 1], v[q + 2], v[q + 3]);
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < NS; ++j)
    if (n0 + j < Ds) row[n0 + j] = v[j];
}

// NS consecutive floats of shared memory (16-byte aligned when NS % 4 == 0).
template <int NS>
__device__ __forceinline__ void load_shared(float (&v)[NS], const float* p) {
  if constexpr (NS % 4 == 0) {
#pragma unroll
    for (int q = 0; q < NS; q += 4) {
      const float4 x = *reinterpret_cast<const float4*>(p + q);
      v[q] = x.x; v[q + 1] = x.y; v[q + 2] = x.z; v[q + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < NS; ++j) v[j] = p[j];
  }
}

// One time step of the thread's NS states from precomputed decays dA:
// h = dA h + du B, then y = sum over the channel's G threads of h C, stored
// by the channel's first thread.
template <int NS, int G>
__device__ __forceinline__ void update(float (&h)[NS], const float (&dA)[NS],
                                       float du, const float* b,
                                       const float* c, float* yp,
                                       bool store) {
  float bv[NS], cv[NS];
  load_shared(bv, b);
  load_shared(cv, c);
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    h[j] = fmaf(dA[j], h[j], du * bv[j]);
    acc = fmaf(h[j], cv[j], acc);
  }
#pragma unroll
  for (int off = 32 / G; off < 32; off <<= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (store) *yp = acc;
}

// One block: kWarps warps, CH = 32 kWarps / G channels (di0 .. di0 + CH - 1
// of batch row blockIdx.y) x G threads; thread (c, g) holds states
// g*NS .. g*NS + NS - 1 of channel c.
// U: steps whose exponentials are computed ahead of their updates.
template <int NS, int G, int U, bool kKeep>
__global__ void __launch_bounds__(32 * kWarps)
scan_kernel(const float* __restrict__ u, const float* __restrict__ delta,
            const float* __restrict__ A, const float* __restrict__ Bc,
            const float* __restrict__ Cc, const float* __restrict__ h0,
            float* __restrict__ y, float* __restrict__ hT,
            float* __restrict__ states, int S, int Di, int Ds, bool vec) {
  constexpr int NT = 32 * kWarps;
  constexpr int CH = NT / G;           // channels per block
  constexpr int DSP = NS * G;
  constexpr int kCW = 32 / G;          // channels per warp
  static_assert(kSteps % U == 0, "U must divide kSteps");
  static_assert(kSteps % kStateChunk == 0 && kStateChunk % U == 0,
                "a kept state starts a run of U steps");
  __shared__ Tiles<CH, DSP> sm;

  const int lane = threadIdx.x & 31;
  const int c = (threadIdx.x >> 5) * kCW + lane % kCW;
  const int n0 = (lane / kCW) * NS;
  const int b = blockIdx.y;
  const int di0 = blockIdx.x * CH;
  const int di = di0 + c;
  const bool live = di < Di;
  const bool writer = live && n0 == 0;

  const size_t row0 = static_cast<size_t>(b) * S;
  float* ycol = y + row0 * Di + (live ? di : 0);
  const int ntiles = (S + kSteps - 1) / kSteps;
  auto stage_tile = [&](int k) {
    const int steps = min(kSteps, S - k * kSteps);
    if constexpr (DSP % 4 == 0) {
      if (vec) {
        if (steps == kSteps)
          stage16<CH, DSP, NT, true>(sm, k % kStages, u, delta, Bc, Cc,
                                     row0 + k * kSteps, steps, Di, Ds, di0);
        else
          stage16<CH, DSP, NT, false>(sm, k % kStages, u, delta, Bc, Cc,
                                      row0 + k * kSteps, steps, Di, Ds, di0);
        return;
      }
    }
    stage<CH, DSP, NT>(sm, k % kStages, u, delta, Bc, Cc, row0 + k * kSteps,
                       steps, Di, Ds, di0);
  };
  // the first tiles are in flight while A and h0 load
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) {
    if (k < ntiles) stage_tile(k);
    cp_async_commit();
  }

  float a2[NS], h[NS];
  if (live) {
    load_states(a2, A + static_cast<size_t>(di) * Ds, n0, Ds, vec);
  } else {
#pragma unroll
    for (int j = 0; j < NS; ++j) a2[j] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < NS; ++j) a2[j] *= kLog2e;
  const size_t state = (static_cast<size_t>(b) * Di + (live ? di : 0)) * Ds;
  if (live && h0 != nullptr) {
    load_states(h, h0 + state, n0, Ds, vec);
  } else {
#pragma unroll
    for (int j = 0; j < NS; ++j) h[j] = 0.f;
  }

  // h before step t into states (B, ceil(S / kStateChunk), Di, Ds)
  const int n_kept = (S + kStateChunk - 1) / kStateChunk;
  const auto keep = [&](int t) {
    store_states(h, states + ((static_cast<size_t>(b) * n_kept +
                               t / kStateChunk) * Di + di) * Ds,
                 n0, Ds, vec);
  };
  const bool keeps = kKeep && live;

  for (int k = 0; k < ntiles; ++k) {
    cp_async_wait<kStages - 2>();   // tile k has landed (this thread's part)
    __syncthreads();                // ... everyone's; slot k - 1 is free
    if (k + kStages - 1 < ntiles) stage_tile(k + kStages - 1);
    cp_async_commit();

    const int s = k % kStages;
    const int t0 = k * kSteps;
    float* yk = ycol + static_cast<size_t>(t0) * Di;
    if (t0 + kSteps <= S) {
#pragma unroll
      for (int i0 = 0; i0 < kSteps; i0 += U) {
        if (keeps && i0 % kStateChunk == 0) keep(t0 + i0);
        float dA[U][NS], du[U];
#pragma unroll
        for (int i = 0; i < U; ++i) {
          const float d = sm.d[s][i0 + i][c];
          du[i] = d * sm.u[s][i0 + i][c];
#pragma unroll
          for (int j = 0; j < NS; ++j) dA[i][j] = ex2(d * a2[j]);
        }
#pragma unroll
        for (int i = 0; i < U; ++i)
          update<NS, G>(h, dA[i], du[i], &sm.b[s][i0 + i][n0],
                        &sm.c[s][i0 + i][n0],
                        yk + static_cast<size_t>(i0 + i) * Di, writer);
      }
    } else {
      for (int i = 0; i < S - t0; ++i) {
        if (keeps && i % kStateChunk == 0) keep(t0 + i);
        const float d = sm.d[s][i][c];
        float dA[NS];
#pragma unroll
        for (int j = 0; j < NS; ++j) dA[j] = ex2(d * a2[j]);
        update<NS, G>(h, dA, d * sm.u[s][i][c], &sm.b[s][i][n0],
                      &sm.c[s][i][n0], yk + static_cast<size_t>(i) * Di,
                      writer);
      }
    }
  }
  if (live) store_states(h, hT + state, n0, Ds, vec);
}

template <int NS_, int G_, int U_>
struct Variant {
  static constexpr int NS = NS_, G = G_, U = U_;
};

// The variant for a state size: NS states a thread (at most 8), G threads
// a channel, U = 64 / NS steps of exponentials ahead (at most kSteps).
template <class F>
int dispatch(int Ds, F&& f) {
  if (Ds <= 1) return f(Variant<1, 1, 16>{});
  if (Ds <= 2) return f(Variant<2, 1, 16>{});
  if (Ds <= 4) return f(Variant<4, 1, 16>{});
  if (Ds <= 8) return f(Variant<8, 1, 8>{});
  if (Ds <= 16) return f(Variant<8, 2, 8>{});
  return f(Variant<8, 4, 8>{});
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <int NS, int G, int U>
int launch(const float* u, const float* delta, const float* A,
           const float* Bc, const float* Cc, const float* h0, float* y,
           float* hT, float* states, int B, int S, int Di, int Ds,
           cudaStream_t stream) {
  const bool vec = Di % 4 == 0 && Ds % 4 == 0 && aligned16(u) &&
                   aligned16(delta) && aligned16(A) && aligned16(Bc) &&
                   aligned16(Cc) && aligned16(h0) && aligned16(hT) &&
                   aligned16(states);
  constexpr int CH = 32 * kWarps / G;
  const dim3 grid((Di + CH - 1) / CH, B);
  if (states != nullptr)
    scan_kernel<NS, G, U, true><<<grid, 32 * kWarps, 0, stream>>>(
        u, delta, A, Bc, Cc, h0, y, hT, states, S, Di, Ds, vec);
  else
    scan_kernel<NS, G, U, false><<<grid, 32 * kWarps, 0, stream>>>(
        u, delta, A, Bc, Cc, h0, y, hT, nullptr, S, Di, Ds, vec);
  return static_cast<int>(cudaGetLastError());
}

int scan(const float* u, const float* delta, const float* A, const float* Bc,
         const float* Cc, const float* h0, float* y, float* hT,
         float* states, int B, int S, int Di, int Ds, void* stream) {
  if (B <= 0 || Di <= 0 || Ds <= 0) return static_cast<int>(cudaSuccess);
  if (S < 0 || Ds > 32 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch(Ds, [&](auto v) {
    using V = decltype(v);
    return launch<V::NS, V::G, V::U>(u, delta, A, Bc, Cc, h0, y, hT, states,
                                     B, S, Di, Ds, s);
  });
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
  return scan(u, delta, A, Bc, Cc, h0, y, hT, nullptr, B, S, Di, Ds, stream);
}

// The same, also writing the state at the start of every chunk of
// kStateChunk steps into states: (B, ceil(S / kStateChunk), Di, Ds)
// float32, contiguous; chunk 0's is h0 (zeros without h0).  What the
// backward starts from.
extern "C" int mamba_selective_scan_states(const float* u,
                                           const float* delta,
                                           const float* A, const float* Bc,
                                           const float* Cc, const float* h0,
                                           float* y, float* hT,
                                           float* states, int B, int S,
                                           int Di, int Ds, void* stream) {
  return scan(u, delta, A, Bc, Cc, h0, y, hT, states, B, S, Di, Ds, stream);
}

// Steps between the states mamba_selective_scan_states writes.
extern "C" int mamba_scan_state_chunk() { return kStateChunk; }

// The launch a scan of this shape gets: out[0] = G (threads a channel),
// out[1] = NS (states a thread), out[2] = threads a block, out[3] = blocks,
// out[4] = blocks one SM can hold at once.  Returns a cudaError_t code.
extern "C" int mamba_scan_split(int B, int Di, int Ds, int* out) {
  if (B <= 0 || Di <= 0 || Ds <= 0 || Ds > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(Ds, [&](auto v) {
    using V = decltype(v);
    out[0] = V::G;
    out[1] = V::NS;
    constexpr int CH = 32 * kWarps / V::G;
    out[2] = 32 * kWarps;
    out[3] = (Di + CH - 1) / CH * B;
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[4], scan_kernel<V::NS, V::G, V::U, false>, 32 * kWarps, 0));
  });
}
