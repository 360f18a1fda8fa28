// Flash-attention forward on NVIDIA Hopper (sm_90a): the C entry and the
// float32 kernel.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/flash_attention.py
// (flash_attention_pallas / _attn_kernel).  The entry flash_attention_fwd
// sends bfloat16 inputs to the tensor-core kernel of
// flash_attention_wgmma.cu and float32 inputs to the SIMT kernel below (on
// tensor cores float32 would run as TF32, which misses the 2e-5 float32
// tolerance).  For q (B, Sq, H, D) and k/v (B, Sk, KV, D | Dv), row-major
// float32, the SIMT kernel writes out (B, Sq, H, Dv) in float32:
// online-softmax attention with float32 running max, sum and
// accumulator; query head h reads KV head h / (H / KV) (GQA, K/V never
// repeated in memory); q scaled by 1/sqrt(D) before the product; masks
// "causal" (k <= q), "window" (k <= q and q - k < window) or "none", plus
// k < kv_valid_len, with the queries at absolute positions
// q_offset + i (q_offset = kv_valid_len - Sq, or 0).
//
// What bounds it on the H100: 4 D operations per visible (q, k) pair per
// (b, h) — the two products — at 67 TFLOP/s for float32 FMAs against
// reading q, k, v once and writing out once at 3.35 TB/s.  At the Hymba
// prefill shape (q (4, 1152, 25, 64), window 1024) that is 1.68e10
// operations, 251 us, against 71 MB, 21 us: bound by operations.
//
// Design.  The TPU kernel carries m, l and acc across a sequential kv grid
// axis in VMEM scratch.  Here one block of 128 threads owns (b, h, a tile
// of queries), and T threads one query (T = 1, or 2 above PD = 64): they
// keep the query's scaled q row and its accumulator acc (float32), split
// between them, and each its own copy of the running max m and sum l, in
// registers, and loop over KV tiles of kBK keys staged in shared memory as
// float32 (every query reads the same key: shared-memory broadcasts).
// Within a tile they take 16 keys at a time: 16 scores, one rescale of
// acc, 16 exponentials.  Head dims are padded with zeros to a class
// (PD, PV): PD for q and K, PV for V and acc, (P, P) with P in {16, 32,
// 64, 128} (max of D and Dv), so one instantiation serves D != Dv, and
// (192, 128) for MLA (D = 128 + 64 rope dims, Dv = 128).  Above PD = 64 a
// whole q row beside acc does not fit the 255 registers a thread may hold
// (at (192, 128) it would take ~330), so two threads share a query: each
// holds every other 16-byte piece of q and acc (their reads of a K or V
// row fall in different banks), adds its half of each score to its
// partner's with one shuffle, and updates its own half of acc (both run
// the same softmax).  Ragged Sq and Sk (any prompt length plus the meta
// tokens) are masked here, not padded by the caller.  KV tiles wholly
// outside every query's visible range (past the last query under
// causal/window, before the first query's window, at or past
// kv_valid_len) are skipped: a masked key adds exactly nothing, so
// skipping them changes no bit.  Fully masked rows follow the TPU kernel:
// safe_m = 0 while m is still -inf, alpha = 0, l clamped to >= 1e-20, so
// such a row writes 0.  expf, not __expf: the product leaves ~16 FMAs per
// exponential, so the accurate one costs little against the 2e-5 float32
// tolerance.  With a non-null lse the kernel also writes each query row's
// log-sum-exp of its scaled scores, m + log(l) (float32, (B, H, Sq); -FLT_MAX
// for a fully masked row), which the backward (flash_attention_bwd.cu)
// recomputes P from; with lse null nothing else changes.  The kernel
// launches on the caller's stream and the C entry returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 128;   // threads per block
constexpr int kGroup = 16;      // keys per online-softmax step
constexpr float kNegInf = -3.4028234663852886e38f;   // finfo(float32).min

enum MaskKind { kCausal = 0, kWindow = 1, kNone = 2 };

// threads a query: two above a padded head dim of 64 (see above)
template <int PD>
__host__ __device__ constexpr int threads_per_query() {
  return PD > 64 ? 2 : 1;
}

template <int PD, int PV>
__global__ void __launch_bounds__(kThreads)
attn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, float* __restrict__ out,
                float* __restrict__ lse, int Sq,
                int Sk, int H, int KV, int D, int Dv, float scale,
                int mask_kind, int window, int valid_len, int q_offset) {
  constexpr int kT = threads_per_query<PD>();
  constexpr int kBQ = kThreads / kT;      // queries per block
  constexpr int kQ4 = PD / 4 / kT;        // 16-byte pieces of q a thread
  constexpr int kV4 = PV / 4 / kT;        // 16-byte pieces of acc a thread
  constexpr int kBK = (PD <= 64 && PV <= 64) ? 64 : 32;   // keys per tile
  __shared__ __align__(16) float s_k[kBK * PD];
  __shared__ __align__(16) float s_v[kBK * PV];

  const int tid = threadIdx.x;
  const int part = tid % kT;        // pieces part, part + kT, ... of a row
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int row = q0 + tid / kT;
  const bool active = row < Sq;
  const int qpos = row + q_offset;

  float qr[4 * kQ4];
  float acc[4 * kV4];
  {
    const float* qp = q + ((static_cast<size_t>(b) * Sq + row) * H + h) * D;
#pragma unroll
    for (int c = 0; c < kQ4; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 4 * (part + kT * c) + e;
        qr[4 * c + e] = (active && d < D) ? qp[d] * scale : 0.0f;
      }
    }
#pragma unroll
    for (int d = 0; d < 4 * kV4; ++d) acc[d] = 0.0f;
  }
  float m = kNegInf;
  float l = 0.0f;

  // keys any query of this block may see: [lo, hi)
  const int first_q = q0 + q_offset;
  const int last_q = min(q0 + kBQ, Sq) - 1 + q_offset;
  int hi = min(valid_len, Sk);
  int lo = 0;
  if (mask_kind != kNone) hi = min(hi, last_q + 1);
  if (mask_kind == kWindow) lo = max(0, first_q - window + 1);

  for (int k0 = lo; k0 < hi; k0 += kBK) {
    __syncthreads();   // every thread is done with the previous tile
    for (int e = tid; e < kBK * PD; e += kThreads) {
      const int key = k0 + e / PD;
      const int d = e % PD;
      s_k[e] = (key < hi && d < D)
          ? k[((static_cast<size_t>(b) * Sk + key) * KV + kvh) * D + d]
          : 0.0f;
    }
    for (int e = tid; e < kBK * PV; e += kThreads) {
      const int key = k0 + e / PV;
      const int d = e % PV;
      s_v[e] = (key < hi && d < Dv)
          ? v[((static_cast<size_t>(b) * Sk + key) * KV + kvh) * Dv + d]
          : 0.0f;
    }
    __syncthreads();

    const int n_keys = min(kBK, hi - k0);
    for (int g = 0; g < n_keys; g += kGroup) {
      // the head dim outside the keys: 16 independent FMA chains
      float s[kGroup];
#pragma unroll
      for (int jj = 0; jj < kGroup; ++jj) s[jj] = 0.0f;
#pragma unroll
      for (int c = 0; c < kQ4; ++c) {
#pragma unroll
        for (int jj = 0; jj < kGroup; ++jj) {
          const float4* kr =
              reinterpret_cast<const float4*>(s_k + (g + jj) * PD) + part;
          const float4 kk = kr[kT * c];
          s[jj] = fmaf(qr[4 * c + 0], kk.x, s[jj]);
          s[jj] = fmaf(qr[4 * c + 1], kk.y, s[jj]);
          s[jj] = fmaf(qr[4 * c + 2], kk.z, s[jj]);
          s[jj] = fmaf(qr[4 * c + 3], kk.w, s[jj]);
        }
      }
#pragma unroll
      for (int jj = 0; jj < kGroup; ++jj) {
#pragma unroll
        for (int lane = 1; lane < kT; lane *= 2)
          s[jj] += __shfl_xor_sync(0xffffffffu, s[jj], lane);
      }
      float m_cur = kNegInf;
#pragma unroll
      for (int jj = 0; jj < kGroup; ++jj) {
        const int key = k0 + g + jj;
        bool ok = g + jj < n_keys;              // key < hi <= valid_len
        if (mask_kind != kNone) ok = ok && key <= qpos;
        if (mask_kind == kWindow) ok = ok && (qpos - key) < window;
        s[jj] = ok ? s[jj] : kNegInf;
        m_cur = fmaxf(m_cur, s[jj]);
      }
      const float m_new = fmaxf(m, m_cur);
      // guard fully masked rows (m == -inf) against NaNs, as the TPU does
      const float safe = m_new <= kNegInf / 2 ? 0.0f : m_new;
      const float alpha = m <= kNegInf / 2 ? 0.0f : expf(m - safe);
      float psum = 0.0f;
#pragma unroll
      for (int jj = 0; jj < kGroup; ++jj) {
        s[jj] = s[jj] <= kNegInf / 2 ? 0.0f : expf(s[jj] - safe);
        psum += s[jj];
      }
      l = alpha * l + psum;
#pragma unroll
      for (int d = 0; d < 4 * kV4; ++d) acc[d] *= alpha;
#pragma unroll
      for (int jj = 0; jj < kGroup; ++jj) {
        const float p = s[jj];
        const float4* vr =
            reinterpret_cast<const float4*>(s_v + (g + jj) * PV) + part;
#pragma unroll
        for (int c = 0; c < kV4; ++c) {
          const float4 vv = vr[kT * c];
          acc[4 * c + 0] = fmaf(p, vv.x, acc[4 * c + 0]);
          acc[4 * c + 1] = fmaf(p, vv.y, acc[4 * c + 1]);
          acc[4 * c + 2] = fmaf(p, vv.z, acc[4 * c + 2]);
          acc[4 * c + 3] = fmaf(p, vv.w, acc[4 * c + 3]);
        }
      }
      m = m_new;
    }
  }

  if (!active) return;
  if (lse != nullptr && part == 0)
    lse[(static_cast<size_t>(b) * H + h) * Sq + row] =
        m <= kNegInf / 2 ? kNegInf : m + logf(fmaxf(l, 1e-20f));
  const float inv = 1.0f / fmaxf(l, 1e-20f);
  float* op = out + ((static_cast<size_t>(b) * Sq + row) * H + h) * Dv;
#pragma unroll
  for (int c = 0; c < kV4; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = 4 * (part + kT * c) + e;
      if (d < Dv) op[d] = acc[4 * c + e] * inv;
    }
  }
}

template <int PD, int PV>
int launch(const void* q, const void* k, const void* v, void* out,
           float* lse, int B, int Sq, int Sk, int H, int KV, int D, int Dv,
           int mask_kind, int window, int valid_len, int q_offset,
           cudaStream_t stream) {
  constexpr int kBQ = kThreads / threads_per_query<PD>();
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  attn_fwd_kernel<PD, PV><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, Sq, Sk, H,
      KV, D, Dv, 1.0f / sqrtf(static_cast<float>(D)), mask_kind, window,
      valid_len, q_offset);
  return static_cast<int>(cudaGetLastError());
}

int dispatch_f32(const void* q, const void* k, const void* v, void* out,
                 float* lse, int B, int Sq, int Sk, int H, int KV, int D,
                 int Dv, int mask_kind, int window, int valid_len,
                 int q_offset, cudaStream_t stream) {
  const int need = D > Dv ? D : Dv;
  if (need <= 16)
    return launch<16, 16>(q, k, v, out, lse, B, Sq, Sk, H, KV, D, Dv,
                          mask_kind, window, valid_len, q_offset, stream);
  if (need <= 32)
    return launch<32, 32>(q, k, v, out, lse, B, Sq, Sk, H, KV, D, Dv,
                          mask_kind, window, valid_len, q_offset, stream);
  if (need <= 64)
    return launch<64, 64>(q, k, v, out, lse, B, Sq, Sk, H, KV, D, Dv,
                          mask_kind, window, valid_len, q_offset, stream);
  if (need <= 128)
    return launch<128, 128>(q, k, v, out, lse, B, Sq, Sk, H, KV, D, Dv,
                            mask_kind, window, valid_len, q_offset, stream);
  return launch<192, 128>(q, k, v, out, lse, B, Sq, Sk, H, KV, D, Dv,
                          mask_kind, window, valid_len, q_offset, stream);
}

}  // namespace

// The bf16 tensor-core kernel (flash_attention_wgmma.cu).
int flash_attention_wgmma(const void* q, const void* k, const void* v,
                          void* out, float* lse, int B, int Sq, int Sk,
                          int H, int KV, int D, int Dv, int mask_kind,
                          int window, int valid_len, int q_offset,
                          cudaStream_t stream);

namespace {

int forward(const void* q, const void* k, const void* v, void* out,
            float* lse, int dtype, int B, int Sq, int Sk, int H, int KV,
            int D, int Dv, int mask_kind, int window, int valid_len,
            int q_offset, void* stream) {
  if (B <= 0 || Sq <= 0 || H <= 0) return static_cast<int>(cudaSuccess);
  if (KV <= 0 || H % KV != 0 || D <= 0 || Dv <= 0 || D > 192 || Dv > 128 ||
      mask_kind < 0 || mask_kind > 2 || H > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_f32(q, k, v, out, lse, B, Sq, Sk, H, KV, D, Dv,
                        mask_kind, window, valid_len, q_offset, s);
  if (dtype == 1)
    return flash_attention_wgmma(q, k, v, out, lse, B, Sq, Sk, H, KV, D, Dv,
                                 mask_kind, window, valid_len, q_offset, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// C interface, loaded with ctypes.  q: (B, Sq, H, D), k: (B, Sk, KV, D),
// v: (B, Sk, KV, Dv), out: (B, Sq, H, Dv), all contiguous, of one type:
// dtype 0 = float32, 1 = bfloat16.  mask_kind 0 = causal, 1 = window,
// 2 = none.  valid_len: keys at or past it are masked (Sk when the caller
// gave no kv_valid_len); q_offset: absolute position of query 0.  stream:
// the cudaStream_t to launch on.  D at most 192, Dv at most 128.
// bfloat16 needs D and Dv multiples of 8 and 16-byte aligned pointers.
// Returns a cudaError_t code (0 = launched).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out, int dtype,
                                   int B, int Sq, int Sk, int H, int KV,
                                   int D, int Dv, int mask_kind, int window,
                                   int valid_len, int q_offset,
                                   void* stream) {
  return forward(q, k, v, out, nullptr, dtype, B, Sq, Sk, H, KV, D, Dv,
                 mask_kind, window, valid_len, q_offset, stream);
}

// flash_attention_fwd that also writes lse (B, H, Sq) float32: each query
// row's log-sum-exp of its scaled scores, the residual of the backward.
extern "C" int flash_attention_fwd_lse(const void* q, const void* k,
                                       const void* v, void* out, void* lse,
                                       int dtype, int B, int Sq, int Sk,
                                       int H, int KV, int D, int Dv,
                                       int mask_kind, int window,
                                       int valid_len, int q_offset,
                                       void* stream) {
  return forward(q, k, v, out, static_cast<float*>(lse), dtype, B, Sq, Sk,
                 H, KV, D, Dv, mask_kind, window, valid_len, q_offset,
                 stream);
}
