// Flash-attention forward on NVIDIA Hopper (sm_90a): the C entries.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/flash_attention.py
// (flash_attention_pallas / _attn_kernel).  The entries check their
// arguments and send bfloat16 inputs to the tensor-core kernel of
// flash_attention_wgmma.cu and float32 inputs to the 3xTF32 tensor-core
// kernels of flash_attention_tf32.cu (a tile kernel, and a key-split
// kernel when a KV head's query rows number at most 8); what each computes,
// what bounds it and its design are in those files.  Every launch is on
// the caller's stream; an entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stddef.h>

// The bf16 tensor-core kernel (flash_attention_wgmma.cu) and the float32
// ones (flash_attention_tf32.cu).
int flash_attention_wgmma(const void* q, const void* k, const void* v,
                          void* out, float* lse, int B, int Sq, int Sk,
                          int H, int KV, int D, int Dv, int mask_kind,
                          int window, int valid_len, int q_offset,
                          cudaStream_t stream);
int flash_attention_tf32(const void* q, const void* k, const void* v,
                         void* out, float* lse, int B, int Sq, int Sk, int H,
                         int KV, int D, int Dv, int mask_kind, int window,
                         int valid_len, int q_offset, cudaStream_t stream);

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
    return flash_attention_tf32(q, k, v, out, lse, B, Sq, Sk, H, KV, D, Dv,
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
