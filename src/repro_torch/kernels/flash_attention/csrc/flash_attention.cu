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
// axis in VMEM scratch.  Here one block owns (b, h, a tile of kBQ queries),
// one thread one query: the thread keeps its scaled q row, its running max
// m, sum l and accumulator acc (all float32) in registers and loops over
// KV tiles of kBK keys staged in shared memory as float32 (every thread
// reads the same key: shared-memory broadcasts).  Within a tile it takes 16
// keys at a time: 16 scores, one rescale of acc, 16 exponentials.  Head
// dims are padded with zeros to a class P in {16, 32, 64, 128} (max of D
// and Dv), so one instantiation serves D != Dv.  Ragged Sq and Sk (any
// prompt length plus the meta tokens) are masked here, not padded by the
// caller.  KV tiles wholly outside every query's visible range (past the
// last query under causal/window, before the first query's window, at or
// past kv_valid_len) are skipped: a masked key adds exactly nothing, so
// skipping them changes no bit.  Fully masked rows follow the TPU kernel:
// safe_m = 0 while m is still -inf, alpha = 0, l clamped to >= 1e-20, so
// such a row writes 0.  expf, not __expf: the product leaves ~16 FMAs per
// exponential, so the accurate one costs little against the 2e-5 float32
// tolerance.  The kernel launches on the caller's stream and the C entry
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kBQ = 128;        // queries per block = threads per block
constexpr int kGroup = 16;      // keys per online-softmax step
constexpr float kNegInf = -3.4028234663852886e38f;   // finfo(float32).min

enum MaskKind { kCausal = 0, kWindow = 1, kNone = 2 };

template <int P>
__global__ void __launch_bounds__(kBQ)
attn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, float* __restrict__ out, int Sq,
                int Sk, int H, int KV, int D, int Dv, float scale,
                int mask_kind, int window, int valid_len, int q_offset) {
  constexpr int kBK = P <= 64 ? 64 : 32;    // keys per staged tile
  __shared__ __align__(16) float s_k[kBK * P];
  __shared__ __align__(16) float s_v[kBK * P];

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int row = q0 + tid;
  const bool active = row < Sq;
  const int qpos = row + q_offset;

  float qr[P];
  float acc[P];
  {
    const float* qp = q + ((static_cast<size_t>(b) * Sq + row) * H + h) * D;
#pragma unroll
    for (int d = 0; d < P; ++d) {
      qr[d] = (active && d < D) ? qp[d] * scale : 0.0f;
      acc[d] = 0.0f;
    }
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
    for (int e = tid; e < kBK * P; e += kBQ) {
      const int j = e / P;
      const int d = e % P;
      const int key = k0 + j;
      float kk = 0.0f, vv = 0.0f;
      if (key < hi) {
        const size_t base =
            (static_cast<size_t>(b) * Sk + key) * KV + kvh;
        if (d < D) kk = k[base * D + d];
        if (d < Dv) vv = v[base * Dv + d];
      }
      s_k[e] = kk;
      s_v[e] = vv;
    }
    __syncthreads();

    const int n_keys = min(kBK, hi - k0);
    for (int g = 0; g < n_keys; g += kGroup) {
      float s[kGroup];
      float m_cur = kNegInf;
#pragma unroll
      for (int jj = 0; jj < kGroup; ++jj) {
        const int key = k0 + g + jj;
        const float4* kr =
            reinterpret_cast<const float4*>(s_k + (g + jj) * P);
        float dot = 0.0f;
#pragma unroll
        for (int d4 = 0; d4 < P / 4; ++d4) {
          const float4 kk = kr[d4];
          dot = fmaf(qr[4 * d4 + 0], kk.x, dot);
          dot = fmaf(qr[4 * d4 + 1], kk.y, dot);
          dot = fmaf(qr[4 * d4 + 2], kk.z, dot);
          dot = fmaf(qr[4 * d4 + 3], kk.w, dot);
        }
        bool ok = g + jj < n_keys;              // key < hi <= valid_len
        if (mask_kind != kNone) ok = ok && key <= qpos;
        if (mask_kind == kWindow) ok = ok && (qpos - key) < window;
        s[jj] = ok ? dot : kNegInf;
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
      for (int d = 0; d < P; ++d) acc[d] *= alpha;
#pragma unroll
      for (int jj = 0; jj < kGroup; ++jj) {
        const float p = s[jj];
        const float4* vr =
            reinterpret_cast<const float4*>(s_v + (g + jj) * P);
#pragma unroll
        for (int d4 = 0; d4 < P / 4; ++d4) {
          const float4 vv = vr[d4];
          acc[4 * d4 + 0] = fmaf(p, vv.x, acc[4 * d4 + 0]);
          acc[4 * d4 + 1] = fmaf(p, vv.y, acc[4 * d4 + 1]);
          acc[4 * d4 + 2] = fmaf(p, vv.z, acc[4 * d4 + 2]);
          acc[4 * d4 + 3] = fmaf(p, vv.w, acc[4 * d4 + 3]);
        }
      }
      m = m_new;
    }
  }

  if (!active) return;
  const float inv = 1.0f / fmaxf(l, 1e-20f);
  float* op = out + ((static_cast<size_t>(b) * Sq + row) * H + h) * Dv;
#pragma unroll
  for (int d = 0; d < P; ++d) {
    if (d < Dv) op[d] = acc[d] * inv;
  }
}

template <int P>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Sk, int H, int KV, int D, int Dv, int mask_kind,
           int window, int valid_len, int q_offset, cudaStream_t stream) {
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  attn_fwd_kernel<P><<<grid, kBQ, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), Sq, Sk, H, KV,
      D, Dv, 1.0f / sqrtf(static_cast<float>(D)), mask_kind, window,
      valid_len, q_offset);
  return static_cast<int>(cudaGetLastError());
}

int dispatch_f32(const void* q, const void* k, const void* v, void* out,
                 int B, int Sq, int Sk, int H, int KV, int D, int Dv,
                 int mask_kind, int window, int valid_len, int q_offset,
                 cudaStream_t stream) {
  const int need = D > Dv ? D : Dv;
  if (need <= 16)
    return launch<16>(q, k, v, out, B, Sq, Sk, H, KV, D, Dv, mask_kind,
                      window, valid_len, q_offset, stream);
  if (need <= 32)
    return launch<32>(q, k, v, out, B, Sq, Sk, H, KV, D, Dv, mask_kind,
                      window, valid_len, q_offset, stream);
  if (need <= 64)
    return launch<64>(q, k, v, out, B, Sq, Sk, H, KV, D, Dv, mask_kind,
                      window, valid_len, q_offset, stream);
  return launch<128>(q, k, v, out, B, Sq, Sk, H, KV, D, Dv, mask_kind,
                     window, valid_len, q_offset, stream);
}

}  // namespace

// The bf16 tensor-core kernel (flash_attention_wgmma.cu).
int flash_attention_wgmma(const void* q, const void* k, const void* v,
                          void* out, int B, int Sq, int Sk, int H, int KV,
                          int D, int Dv, int mask_kind, int window,
                          int valid_len, int q_offset, cudaStream_t stream);

// C interface, loaded with ctypes.  q: (B, Sq, H, D), k: (B, Sk, KV, D),
// v: (B, Sk, KV, Dv), out: (B, Sq, H, Dv), all contiguous, of one type:
// dtype 0 = float32, 1 = bfloat16.  mask_kind 0 = causal, 1 = window,
// 2 = none.  valid_len: keys at or past it are masked (Sk when the caller
// gave no kv_valid_len); q_offset: absolute position of query 0.  stream:
// the cudaStream_t to launch on.  bfloat16 needs D and Dv multiples of 8
// and 16-byte aligned pointers.  Returns a cudaError_t code (0 =
// launched).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out, int dtype,
                                   int B, int Sq, int Sk, int H, int KV,
                                   int D, int Dv, int mask_kind, int window,
                                   int valid_len, int q_offset,
                                   void* stream) {
  if (B <= 0 || Sq <= 0 || H <= 0) return static_cast<int>(cudaSuccess);
  if (KV <= 0 || H % KV != 0 || D <= 0 || Dv <= 0 || D > 128 || Dv > 128 ||
      mask_kind < 0 || mask_kind > 2 || H > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_f32(q, k, v, out, B, Sq, Sk, H, KV, D, Dv, mask_kind,
                        window, valid_len, q_offset, s);
  if (dtype == 1)
    return flash_attention_wgmma(q, k, v, out, B, Sq, Sk, H, KV, D, Dv,
                                 mask_kind, window, valid_len, q_offset, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
