// Flash-attention backward on NVIDIA Hopper (sm_90a): the C entry and the
// delta kernel.
//
// Replaces no TPU kernel: the TPU reference differentiates its attention
// through the custom VJP of src/repro/kernels/flash_attention/ops.py
// (_fa_diff_bwd / _fa_diff_fwd), which saves the forward's log-sum-exp and
// recomputes the probabilities block by block.  Without these kernels the
// port's forwards (flash_attention_wgmma.cu, flash_attention_tf32.cu) could
// not be differentiated on the card.  For q (B, Sq, H, D), k (B, Sk, KV,
// D), v (B, Sk, KV, Dv), the forward's out (B, Sq, H, Dv) and lse (B, H,
// Sq, float32), and the gradient dout of out, all row-major, float32 or
// bfloat16 (one type), it writes dq, dk, dv in the inputs' type:
//     delta_i = sum_d dout_i,d out_i,d
//     P_ij = exp(q_i . k_j / sqrt(D) - lse_i)    on the visible (i, j)
//     dv_j = sum_i P_ij dout_i
//     dS_ij = P_ij (dout_i . v_j - delta_i)
//     dq_i = sum_j dS_ij k_j / sqrt(D),  dk_j = sum_i dS_ij q_i / sqrt(D)
// with GQA folded back: dk and dv of KV head g sum over its H / KV query
// heads.  Masks as the forward: "causal" (k <= q), "window" (k <= q and
// q - k < window) or "none", plus k < kv_valid_len, the queries at
// absolute positions q_offset + i.
//
// Three launches in FlashAttention-2's order, none with atomics, so two
// runs on the same inputs are bitwise equal: the delta kernel below (one
// warp a (b, i, h) row; what it reads and writes, 2 Dv floats a row, is
// bytes against the products' operations, so it is not where the time
// goes), then the dk / dv kernel and the dq kernel on tensor cores:
// bfloat16 in flash_attention_bwd_wgmma.cu, float32 as 3xTF32 in
// flash_attention_bwd_tf32.cu (what bounds each and its design are in
// those files).  The launches run on the caller's stream; the entry
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

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

}  // namespace

// The dk / dv and dq kernels on tensor cores, after the delta kernel; their
// arguments as flash_attention_bwd's: bf16 (flash_attention_bwd_wgmma.cu)
// and float32 (flash_attention_bwd_tf32.cu).
int flash_attention_bwd_wgmma(const void* q, const void* k, const void* v,
                              const void* dout, const float* lse,
                              const float* delta, void* dq, void* dk,
                              void* dv, int B, int Sq, int Sk, int H, int KV,
                              int D, int Dv, int mask_kind, int window,
                              int valid_len, int q_offset,
                              cudaStream_t stream);
int flash_attention_bwd_tf32(const void* q, const void* k, const void* v,
                             const void* dout, const float* lse,
                             const float* delta, void* dq, void* dk, void* dv,
                             int B, int Sq, int Sk, int H, int KV, int D,
                             int Dv, int mask_kind, int window, int valid_len,
                             int q_offset, cudaStream_t stream);

// C interface, loaded with ctypes.  q, k, v, out as flash_attention_fwd;
// lse: (B, H, Sq) float32 from flash_attention_fwd_lse; dout: (B, Sq, H,
// Dv); dq, dk, dv: the gradients, shaped as q, k, v; delta: (B, H, Sq)
// float32 scratch.  All contiguous; q, k, v, out, dout, dq, dk, dv of one
// type: dtype 0 = float32, 1 = bfloat16 (D and Dv multiples of 8).
// mask_kind, valid_len, q_offset as the forward.  D at most 192, Dv at
// most 128.  Three launches on stream (two when Sk is 0).  Returns a
// cudaError_t code (0 = launched).
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
  if (dtype != 0 && dtype != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int rows = B * Sq * H;
  if (dtype == 0)
    attn_bwd_delta_kernel<float><<<(rows + 7) / 8, 256, 0, s>>>(
        static_cast<const float*>(out), static_cast<const float*>(dout), dl,
        rows, Sq, H, Dv);
  else
    attn_bwd_delta_kernel<bf16><<<(rows + 7) / 8, 256, 0, s>>>(
        static_cast<const bf16*>(out), static_cast<const bf16*>(dout), dl,
        rows, Sq, H, Dv);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const float* ls = static_cast<const float*>(lse);
  if (dtype == 0)
    return flash_attention_bwd_tf32(q, k, v, dout, ls, dl, dq, dk, dv, B, Sq,
                                    Sk, H, KV, D, Dv, mask_kind, window,
                                    valid_len, q_offset, s);
  return flash_attention_bwd_wgmma(q, k, v, dout, ls, dl, dq, dk, dv, B, Sq,
                                   Sk, H, KV, D, Dv, mask_kind, window,
                                   valid_len, q_offset, s);
}
