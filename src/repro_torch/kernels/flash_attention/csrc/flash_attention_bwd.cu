// Flash-attention backward on NVIDIA Hopper (sm_90a).
//
// Replaces no TPU kernel: the TPU reference differentiates its attention
// through the custom VJP of src/repro/kernels/flash_attention/ops.py
// (_fa_diff_fwd / _fa_diff_bwd), which saves the forward's log-sum-exp and
// recomputes the probabilities block by block.  Without this kernel the
// port's forwards (flash_attention.cu, flash_attention_wgmma.cu) could not
// be differentiated on the card.  For q (B, Sq, H, D), k (B, Sk, KV, D),
// v (B, Sk, KV, Dv), the forward's out (B, Sq, H, Dv) and lse (B, H, Sq,
// float32), and the gradient dout of out, all row-major, float32 or
// bfloat16 (one type), it writes dq, dk, dv in the inputs' type:
//     delta_i = sum_d dout_i,d out_i,d
//     P_ij = exp(q_i . k_j / sqrt(D) - lse_i)    on the visible (i, j)
//     dv_j = sum_i P_ij dout_i
//     dS_ij = P_ij (dout_i . v_j - delta_i)
//     dq_i = sum_j dS_ij k_j / sqrt(D),  dk_j = sum_i dS_ij q_i / sqrt(D)
// with GQA folded back: dk and dv of KV head g sum over its H / KV query
// heads.  Masks as the forward: "causal" (k <= q), "window" (k <= q and
// q - k < window) or "none", plus k < kv_valid_len, the queries at
// absolute positions q_offset + i.  Everything is computed in float32.
//
// What bounds it on the H100: 4 (D + Dv) operations per visible (q, k)
// pair and head for the four products that need P (S = q k, dP = dout v,
// dv += P dout, dk += dS q) and 2 D more for dq += dS k, i.e. 5 of the
// forward's 2 matrix products, at 67 TFLOP/s in FP32, against q, k, v, out,
// dout, lse read once and dq, dk, dv written once at 3.35 TB/s.  At Hymba's
// training shape (q (4, 1152, 25, 64), window 1024) that is 4.2e10
// operations, 627 us, against 71 MB, 21 us: bound by operations.
//
// Design (simple first; tensor cores and TMA are later work).  Three
// launches in FlashAttention-2's order, none with atomics, so two runs on
// the same inputs are bitwise equal:
// 1. delta: one warp a (b, i, h) row.
// 2. dk / dv: one block a (b, KV head, tile of keys); L threads share a key
//    (each holds every L-th 16-byte piece of its k and v rows and of their
//    float32 gradients in registers, partial dot products added with
//    shuffles).  The block loops over the group's query heads and over
//    tiles of kBQ query rows staged in shared memory (q, dout, lse,
//    delta), and only over the rows the mask lets see one of its keys.
//    Summing the group's heads inside the block folds GQA without atomics.
// 3. dq: one block a (b, head, tile of queries), L threads a query as in
//    the forward's SIMT kernel, looping over tiles of kBK keys staged in
//    shared memory and only over the keys its queries may see.
// P is recomputed from lse (expf, not __expf: its error stays within the
// float32 gradient tolerance of the reference, 3e-5).  Keys at or past
// kv_valid_len get zero gradients.  Head dims are padded to the forward's
// classes (PD, PV) = (16, 16), (32, 32), (64, 64), (128, 128), (192, 128).
// The launches run on the caller's stream; the entry returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;   // threads per block of the dk/dv and dq kernels
constexpr int kBQ = 32;         // query rows per staged tile (dk/dv kernel)
constexpr int kBK = 32;         // keys per staged tile (dq kernel)
constexpr float kNegInf = -3.4028234663852886e38f;   // finfo(float32).min

enum MaskKind { kCausal = 0, kWindow = 1, kNone = 2 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16(x);   // round to nearest even, as torch's cast
}

// threads that share one key (dk/dv) or one query (dq): keeps the float32
// rows and gradients of a thread at or below 128 registers
template <int PD>
__host__ __device__ constexpr int lanes() {
  return PD <= 32 ? 1 : PD == 64 ? 2 : PD == 128 ? 4 : 8;
}

__device__ __forceinline__ bool visible(int key, int qpos, int mask_kind,
                                        int window) {
  bool ok = true;
  if (mask_kind != kNone) ok = key <= qpos;
  if (mask_kind == kWindow) ok = ok && qpos - key < window;
  return ok;
}

template <typename T>
__global__ void attn_bwd_delta_kernel(const T* __restrict__ out,
                                      const T* __restrict__ dout,
                                      float* __restrict__ delta, int rows,
                                      int Sq, int H, int Dv) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;                 // the whole warp leaves together
  const T* o = out + static_cast<size_t>(row) * Dv;
  const T* g = dout + static_cast<size_t>(row) * Dv;
  float s = 0.0f;
  for (int d = lane; d < Dv; d += 32) s = fmaf(to_f(o[d]), to_f(g[d]), s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) {
    const int h = row % H;
    const int bi = row / H;                // b * Sq + i
    delta[(static_cast<size_t>(bi / Sq) * H + h) * Sq + bi % Sq] = s;
  }
}

// Rows [i0, i0 + kBQ) of q and dout of head h, as float32, zero past
// i_hi or past the head dims; lse and delta beside them.
template <typename T, int PD, int PV>
__device__ __forceinline__ void stage_rows(
    float* s_q, float* s_do, float* s_lse, float* s_delta,
    const T* __restrict__ q, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta, int b,
    int h, int i0, int i_hi, int Sq, int H, int D, int Dv) {
  const int tid = threadIdx.x;
  for (int e = tid; e < kBQ * PD; e += kThreads) {
    const int i = i0 + e / PD;
    const int d = e % PD;
    s_q[e] = (i < i_hi && d < D)
        ? to_f(q[((static_cast<size_t>(b) * Sq + i) * H + h) * D + d])
        : 0.0f;
  }
  for (int e = tid; e < kBQ * PV; e += kThreads) {
    const int i = i0 + e / PV;
    const int d = e % PV;
    s_do[e] = (i < i_hi && d < Dv)
        ? to_f(dout[((static_cast<size_t>(b) * Sq + i) * H + h) * Dv + d])
        : 0.0f;
  }
  if (tid < kBQ) {
    const int i = i0 + tid;
    const size_t at = (static_cast<size_t>(b) * H + h) * Sq + i;
    s_lse[tid] = i < i_hi ? lse[at] : 0.0f;
    s_delta[tid] = i < i_hi ? delta[at] : 0.0f;
  }
}

template <typename T, int PD, int PV>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int Sq, int Sk, int H, int KV, int D,
                     int Dv, float scale, int mask_kind, int window,
                     int valid_len, int q_offset) {
  constexpr int L = lanes<PD>();
  constexpr int kKeys = kThreads / L;     // keys per block
  constexpr int kQ4 = PD / 4 / L;         // 16-byte pieces of a k row a thread
  constexpr int kV4 = PV / 4 / L;
  __shared__ __align__(16) float s_q[kBQ * PD];
  __shared__ __align__(16) float s_do[kBQ * PV];
  __shared__ float s_lse[kBQ];
  __shared__ float s_delta[kBQ];

  const int tid = threadIdx.x;
  const int part = tid % L;
  const int k0 = blockIdx.x * kKeys;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int key = k0 + tid / L;
  const int rep = H / KV;
  const int kv_end = min(valid_len, Sk);
  const bool kin = key < kv_end;

  float kr[4 * kQ4], vr[4 * kV4], dkr[4 * kQ4], dvr[4 * kV4];
  {
    const size_t kv = (static_cast<size_t>(b) * Sk + key) * KV + kvh;
#pragma unroll
    for (int c = 0; c < kQ4; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 4 * (part + L * c) + e;
        kr[4 * c + e] = (kin && d < D) ? to_f(k[kv * D + d]) : 0.0f;
        dkr[4 * c + e] = 0.0f;
      }
#pragma unroll
    for (int c = 0; c < kV4; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 4 * (part + L * c) + e;
        vr[4 * c + e] = (kin && d < Dv) ? to_f(v[kv * Dv + d]) : 0.0f;
        dvr[4 * c + e] = 0.0f;
      }
  }

  // query rows that may see one of the block's keys [k0, k_last]
  const int k_last = min(k0 + kKeys, kv_end) - 1;
  int i_lo = 0, i_hi = Sq;
  if (mask_kind != kNone) i_lo = max(0, k0 - q_offset);
  if (mask_kind == kWindow) i_hi = min(Sq, k_last + window - q_offset);
  if (k_last < k0) i_hi = i_lo;            // no valid key in this block

  for (int hh = 0; hh < rep; ++hh) {
    const int h = kvh * rep + hh;
    for (int i0 = i_lo; i0 < i_hi; i0 += kBQ) {
      __syncthreads();   // every thread is done with the previous tile
      stage_rows<T, PD, PV>(s_q, s_do, s_lse, s_delta, q, dout, lse, delta,
                            b, h, i0, i_hi, Sq, H, D, Dv);
      __syncthreads();
      const int n_rows = min(kBQ, i_hi - i0);
      for (int r = 0; r < n_rows; ++r) {
        const float4* qrow =
            reinterpret_cast<const float4*>(s_q + r * PD) + part;
        const float4* grow =
            reinterpret_cast<const float4*>(s_do + r * PV) + part;
        float s = 0.0f, dp = 0.0f;
#pragma unroll
        for (int c = 0; c < kQ4; ++c) {
          const float4 x = qrow[L * c];
          s = fmaf(x.x, kr[4 * c + 0], s);
          s = fmaf(x.y, kr[4 * c + 1], s);
          s = fmaf(x.z, kr[4 * c + 2], s);
          s = fmaf(x.w, kr[4 * c + 3], s);
        }
#pragma unroll
        for (int c = 0; c < kV4; ++c) {
          const float4 x = grow[L * c];
          dp = fmaf(x.x, vr[4 * c + 0], dp);
          dp = fmaf(x.y, vr[4 * c + 1], dp);
          dp = fmaf(x.z, vr[4 * c + 2], dp);
          dp = fmaf(x.w, vr[4 * c + 3], dp);
        }
#pragma unroll
        for (int lane = 1; lane < L; lane *= 2) {
          s += __shfl_xor_sync(0xffffffffu, s, lane);
          dp += __shfl_xor_sync(0xffffffffu, dp, lane);
        }
        const bool ok =
            kin && visible(key, i0 + r + q_offset, mask_kind, window);
        const float p = ok ? expf(s * scale - s_lse[r]) : 0.0f;
        const float ds = p * (dp - s_delta[r]);
#pragma unroll
        for (int c = 0; c < kQ4; ++c) {
          const float4 x = qrow[L * c];
          dkr[4 * c + 0] = fmaf(ds, x.x, dkr[4 * c + 0]);
          dkr[4 * c + 1] = fmaf(ds, x.y, dkr[4 * c + 1]);
          dkr[4 * c + 2] = fmaf(ds, x.z, dkr[4 * c + 2]);
          dkr[4 * c + 3] = fmaf(ds, x.w, dkr[4 * c + 3]);
        }
#pragma unroll
        for (int c = 0; c < kV4; ++c) {
          const float4 x = grow[L * c];
          dvr[4 * c + 0] = fmaf(p, x.x, dvr[4 * c + 0]);
          dvr[4 * c + 1] = fmaf(p, x.y, dvr[4 * c + 1]);
          dvr[4 * c + 2] = fmaf(p, x.z, dvr[4 * c + 2]);
          dvr[4 * c + 3] = fmaf(p, x.w, dvr[4 * c + 3]);
        }
      }
    }
  }

  if (key >= Sk) return;
  const size_t kv = (static_cast<size_t>(b) * Sk + key) * KV + kvh;
#pragma unroll
  for (int c = 0; c < kQ4; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = 4 * (part + L * c) + e;
      if (d < D) dk[kv * D + d] = from_f<T>(dkr[4 * c + e] * scale);
    }
#pragma unroll
  for (int c = 0; c < kV4; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = 4 * (part + L * c) + e;
      if (d < Dv) dv[kv * Dv + d] = from_f<T>(dvr[4 * c + e]);
    }
}

template <typename T, int PD, int PV>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, T* __restrict__ dq,
                   int Sq, int Sk, int H, int KV, int D, int Dv, float scale,
                   int mask_kind, int window, int valid_len, int q_offset) {
  constexpr int L = lanes<PD>();
  constexpr int kRows = kThreads / L;     // queries per block
  constexpr int kQ4 = PD / 4 / L;
  constexpr int kV4 = PV / 4 / L;
  __shared__ __align__(16) float s_k[kBK * PD];
  __shared__ __align__(16) float s_v[kBK * PV];

  const int tid = threadIdx.x;
  const int part = tid % L;
  const int q0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int row = q0 + tid / L;
  const bool active = row < Sq;
  const int qpos = row + q_offset;

  float qr[4 * kQ4], gr[4 * kV4], dqr[4 * kQ4];
  {
    const size_t at = (static_cast<size_t>(b) * Sq + row) * H + h;
#pragma unroll
    for (int c = 0; c < kQ4; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 4 * (part + L * c) + e;
        qr[4 * c + e] = (active && d < D) ? to_f(q[at * D + d]) : 0.0f;
        dqr[4 * c + e] = 0.0f;
      }
#pragma unroll
    for (int c = 0; c < kV4; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 4 * (part + L * c) + e;
        gr[4 * c + e] = (active && d < Dv) ? to_f(dout[at * Dv + d]) : 0.0f;
      }
  }
  const size_t row_at = (static_cast<size_t>(b) * H + h) * Sq + row;
  const float lse_r = active ? lse[row_at] : 0.0f;
  const float delta_r = active ? delta[row_at] : 0.0f;

  // keys any query of this block may see: [lo, hi), as the forward
  const int kv_end = min(valid_len, Sk);
  const int first_q = q0 + q_offset;
  const int last_q = min(q0 + kRows, Sq) - 1 + q_offset;
  int hi = kv_end;
  int lo = 0;
  if (mask_kind != kNone) hi = min(hi, last_q + 1);
  if (mask_kind == kWindow) lo = max(0, first_q - window + 1);

  for (int k0 = lo; k0 < hi; k0 += kBK) {
    __syncthreads();   // every thread is done with the previous tile
    for (int e = tid; e < kBK * PD; e += kThreads) {
      const int key = k0 + e / PD;
      const int d = e % PD;
      s_k[e] = (key < hi && d < D)
          ? to_f(k[((static_cast<size_t>(b) * Sk + key) * KV + kvh) * D + d])
          : 0.0f;
    }
    for (int e = tid; e < kBK * PV; e += kThreads) {
      const int key = k0 + e / PV;
      const int d = e % PV;
      s_v[e] = (key < hi && d < Dv)
          ? to_f(v[((static_cast<size_t>(b) * Sk + key) * KV + kvh) * Dv + d])
          : 0.0f;
    }
    __syncthreads();
    const int n_keys = min(kBK, hi - k0);
    for (int j = 0; j < n_keys; ++j) {
      const float4* krow = reinterpret_cast<const float4*>(s_k + j * PD) + part;
      const float4* vrow = reinterpret_cast<const float4*>(s_v + j * PV) + part;
      float s = 0.0f, dp = 0.0f;
#pragma unroll
      for (int c = 0; c < kQ4; ++c) {
        const float4 x = krow[L * c];
        s = fmaf(qr[4 * c + 0], x.x, s);
        s = fmaf(qr[4 * c + 1], x.y, s);
        s = fmaf(qr[4 * c + 2], x.z, s);
        s = fmaf(qr[4 * c + 3], x.w, s);
      }
#pragma unroll
      for (int c = 0; c < kV4; ++c) {
        const float4 x = vrow[L * c];
        dp = fmaf(gr[4 * c + 0], x.x, dp);
        dp = fmaf(gr[4 * c + 1], x.y, dp);
        dp = fmaf(gr[4 * c + 2], x.z, dp);
        dp = fmaf(gr[4 * c + 3], x.w, dp);
      }
#pragma unroll
      for (int lane = 1; lane < L; lane *= 2) {
        s += __shfl_xor_sync(0xffffffffu, s, lane);
        dp += __shfl_xor_sync(0xffffffffu, dp, lane);
      }
      const bool ok = active && visible(k0 + j, qpos, mask_kind, window);
      const float p = ok ? expf(s * scale - lse_r) : 0.0f;
      const float ds = p * (dp - delta_r);
#pragma unroll
      for (int c = 0; c < kQ4; ++c) {
        const float4 x = krow[L * c];
        dqr[4 * c + 0] = fmaf(ds, x.x, dqr[4 * c + 0]);
        dqr[4 * c + 1] = fmaf(ds, x.y, dqr[4 * c + 1]);
        dqr[4 * c + 2] = fmaf(ds, x.z, dqr[4 * c + 2]);
        dqr[4 * c + 3] = fmaf(ds, x.w, dqr[4 * c + 3]);
      }
    }
  }

  if (!active) return;
  const size_t at = (static_cast<size_t>(b) * Sq + row) * H + h;
#pragma unroll
  for (int c = 0; c < kQ4; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = 4 * (part + L * c) + e;
      if (d < D) dq[at * D + d] = from_f<T>(dqr[4 * c + e] * scale);
    }
}

template <typename T, int PD, int PV>
int launch(const void* q, const void* k, const void* v, const void* out,
           const void* lse, const void* dout, void* dq, void* dk, void* dv,
           float* delta, int B, int Sq, int Sk, int H, int KV, int D, int Dv,
           int mask_kind, int window, int valid_len, int q_offset,
           cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  const float* ls = static_cast<const float*>(lse);
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  const int rows = B * Sq * H;
  attn_bwd_delta_kernel<T><<<(rows + 7) / 8, 256, 0, stream>>>(
      static_cast<const T*>(out), dot, delta, rows, Sq, H, Dv);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  if (Sk > 0) {
    constexpr int kKeys = kThreads / lanes<PD>();
    const dim3 grid((Sk + kKeys - 1) / kKeys, KV, B);
    attn_bwd_dkdv_kernel<T, PD, PV><<<grid, kThreads, 0, stream>>>(
        qt, kt, vt, dot, ls, delta, static_cast<T*>(dk), static_cast<T*>(dv),
        Sq, Sk, H, KV, D, Dv, scale, mask_kind, window, valid_len, q_offset);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  constexpr int kRows = kThreads / lanes<PD>();
  const dim3 grid((Sq + kRows - 1) / kRows, H, B);
  attn_bwd_dq_kernel<T, PD, PV><<<grid, kThreads, 0, stream>>>(
      qt, kt, vt, dot, ls, delta, static_cast<T*>(dq), Sq, Sk, H, KV, D, Dv,
      scale, mask_kind, window, valid_len, q_offset);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* out,
             const void* lse, const void* dout, void* dq, void* dk, void* dv,
             float* delta, int B, int Sq, int Sk, int H, int KV, int D,
             int Dv, int mask_kind, int window, int valid_len, int q_offset,
             cudaStream_t s) {
  const int need = D > Dv ? D : Dv;
  if (need <= 16)
    return launch<T, 16, 16>(q, k, v, out, lse, dout, dq, dk, dv, delta, B,
                             Sq, Sk, H, KV, D, Dv, mask_kind, window,
                             valid_len, q_offset, s);
  if (need <= 32)
    return launch<T, 32, 32>(q, k, v, out, lse, dout, dq, dk, dv, delta, B,
                             Sq, Sk, H, KV, D, Dv, mask_kind, window,
                             valid_len, q_offset, s);
  if (need <= 64)
    return launch<T, 64, 64>(q, k, v, out, lse, dout, dq, dk, dv, delta, B,
                             Sq, Sk, H, KV, D, Dv, mask_kind, window,
                             valid_len, q_offset, s);
  if (need <= 128)
    return launch<T, 128, 128>(q, k, v, out, lse, dout, dq, dk, dv, delta, B,
                               Sq, Sk, H, KV, D, Dv, mask_kind, window,
                               valid_len, q_offset, s);
  return launch<T, 192, 128>(q, k, v, out, lse, dout, dq, dk, dv, delta, B,
                             Sq, Sk, H, KV, D, Dv, mask_kind, window,
                             valid_len, q_offset, s);
}

}  // namespace

// C interface, loaded with ctypes.  q, k, v, out as flash_attention_fwd;
// lse: (B, H, Sq) float32 from flash_attention_fwd_lse; dout: (B, Sq, H,
// Dv); dq, dk, dv: the gradients, shaped as q, k, v; delta: (B, H, Sq)
// float32 scratch.  All contiguous; q, k, v, out, dout, dq, dk, dv of one
// type: dtype 0 = float32, 1 = bfloat16.  mask_kind, valid_len, q_offset
// as the forward.  D at most 192, Dv at most 128.  Three launches on
// stream.  Returns a cudaError_t code (0 = launched).
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* out,
                                   const void* lse, const void* dout,
                                   void* dq, void* dk, void* dv, void* delta,
                                   int dtype, int B, int Sq, int Sk, int H,
                                   int KV, int D, int Dv, int mask_kind,
                                   int window, int valid_len, int q_offset,
                                   void* stream) {
  if (B <= 0 || Sq <= 0 || H <= 0) return static_cast<int>(cudaSuccess);
  if (KV <= 0 || H % KV != 0 || D <= 0 || Dv <= 0 || D > 192 || Dv > 128 ||
      mask_kind < 0 || mask_kind > 2 || H > 65535 || B > 65535 || Sk < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dl = static_cast<float*>(delta);
  if (dtype == 0)
    return dispatch<float>(q, k, v, out, lse, dout, dq, dk, dv, dl, B, Sq,
                           Sk, H, KV, D, Dv, mask_kind, window, valid_len,
                           q_offset, s);
  if (dtype == 1)
    return dispatch<bf16>(q, k, v, out, lse, dout, dq, dk, dv, dl, B, Sq,
                          Sk, H, KV, D, Dv, mask_kind, window, valid_len,
                          q_offset, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
