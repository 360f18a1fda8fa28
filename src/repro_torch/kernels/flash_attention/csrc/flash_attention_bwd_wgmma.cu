// Flash-attention backward for bfloat16 on Hopper tensor cores (sm_90a).
//
// Replaces no TPU kernel: the TPU reference differentiates its attention
// through the custom VJP of src/repro/kernels/flash_attention/ops.py
// (_fa_diff_bwd), which recomputes the probabilities from the forward's
// log-sum-exp.  flash_attention_bwd.cu's entry calls this file for
// bfloat16 inputs after its delta kernel (delta_i = sum_d dout_i,d out_i,d);
// float32 runs the 3xTF32 tensor-core kernels of
// flash_attention_bwd_tf32.cu (one TF32 product would miss the 3e-5
// float32 gradient tolerance).  For q
// (B, Sq, H, D), k (B, Sk, KV, D), v (B, Sk, KV, Dv), dout (B, Sq, H, Dv),
// all row-major bf16, and the forward's lse and delta (B, H, Sq, float32),
// it writes dq, dk, dv in bf16:
//     P_ij = exp(q_i . k_j / sqrt(D) - lse_i)     on the visible (i, j)
//     dS_ij = P_ij (dout_i . v_j - delta_i)
//     dv_j = sum_i P_ij dout_i,  dk_j = sum_i dS_ij q_i / sqrt(D),
//     dq_i = sum_j dS_ij k_j / sqrt(D)
// with dk and dv of KV head g summed over its H / KV query heads, and the
// masks of the forward ("causal", "window", "none", k < kv_valid_len,
// queries at q_offset + i).  D and Dv are multiples of 8, D at most 192,
// Dv at most 128.
//
// What bounds it on the H100: 2 (3 D + 2 Dv) operations per visible
// (q, k) pair and head (S = q k, dP = dout v, dv += P dout, dk += dS q,
// dq += dS k) at 989 TFLOP/s against q, k, v, out, dout, lse read once
// and dq, dk, dv written once at 3.35 TB/s.  At Hymba's training shape (q
// (4, 1152, 25, 64), k/v 5 heads, window 1024) that is 4.2e10 operations,
// 42.4 us, against 30 MB, 9 us: bound by operations.  Recomputing S and dP
// in the dq kernel (below) adds 4 D per pair: 7 products where an atomic
// dq would need 5.  One exponential per pair and kernel, 2 x 65.6 M at 16
// per SM per clock, ~36 us, has to overlap with the products.
//
// Design: FlashAttention-2's order without atomics, so two calls on the
// same inputs are bitwise equal; every product on wgmma with float32
// accumulators, P and dS rounded to bf16 as the register A operand of the
// products they feed (what every tensor-core backward does;
// ref.flash_attention_bwd_tc_mirror repeats this arithmetic on the CPU).
// The 1/sqrt(D) scale multiplies S in float32 after the product (folded
// with log2 e into one FMA before ex2.approx, as the forward) and dq, dk
// once at the end.  Tiles sit in shared memory under the forward's
// 128-byte swizzle, filled by 16-byte cp.async copies that zero-fill rows
// past Sq, keys past kv_valid_len and the padded head-dim columns
// (wgmma_common.cuh); head dims are padded to the forward's classes (PD,
// PV) = (64, 64), (128, 128), (192, 128).  One warpgroup (128 threads) a
// block, so a block barrier is four warps.
// 1. dk / dv kernel: one block a (b, KV head, 64 keys).  K and V stay in
//    shared memory; the block walks the H / KV query heads of its group
//    (GQA folded inside the block) and, for each, the tiles of BQ query
//    rows the mask lets see one of its keys, each tile (Q, dO, lse,
//    delta) arriving through a ring of kStages stages, two in flight.  Per
//    tile, in the transposed roles: S^T = K Q^T and dP^T = V dO^T (SS,
//    M = the 64 keys, N = BQ queries, both operands K-major as the
//    forward's S = Q K^T); P^T = exp2(S^T c - lse log2 e) with lse a
//    column constant (each thread holds 2 BQ / 8 columns, read from the
//    staged lse); dS^T = P^T (dP^T - delta); then dV += P^T dO and dK +=
//    dS^T Q (RS: P^T and dS^T in bf16 from the accumulator registers, dO
//    and Q read with the transpose bit, as the forward reads V), one
//    m64n64 product a 64-column block of dV and dK.  The accumulator
//    layout of S^T is already the A-fragment layout of P^T (the columns
//    become K), so no shuffle moves a value.  dK alone is 64 x PD float32
//    accumulators, PD / 2 registers a thread (96 at MLA's 192); BQ = 32 at
//    the wide classes keeps S^T, dP^T and their fragments to 48 registers
//    so that (192, 128) fits 255 registers.
// 2. dq kernel: one block a (b, head, 64 queries) with Q, dO, lse and
//    delta staged once, walking the visible 64-key tiles through a K / V
//    ring: S = Q K^T and dP = dO V^T (SS), dS = P (dP - delta) with lse
//    and delta row constants, dQ += dS K (RS, K with the transpose bit).
// Masks only where they bite: tiles wholly outside every visible range
// are never loaded, and positions are compared only on tiles that cross
// the diagonal, the window's edge, kv_valid_len or Sq; a masked pair's P
// is set to 0, so a fully masked row (lse = -FLT_MAX) and zero-filled
// keys add nothing, and keys at or past kv_valid_len get zero gradients.
// The launches run on the caller's stream; the entry returns
// cudaGetLastError().

#include <type_traits>

#include "wgmma_common.cuh"

namespace {

constexpr int kThreads = 128;       // one warpgroup a block
constexpr int kBK = 64;             // keys a dk / dv block, keys a dq tile
constexpr int kBQdq = 64;           // queries a dq block
constexpr int kStages = 3;          // ring depth: two tiles in flight
constexpr float kLog2e = 1.4426950408889634f;

enum MaskKind { kCausal = 0, kWindow = 1, kNone = 2 };

__device__ __forceinline__ bool visible(int key, int qpos, int kv_end,
                                        int mask_kind, int window) {
  bool ok = key < kv_end;
  if (mask_kind != kNone) ok = ok && key <= qpos;
  if (mask_kind == kWindow) ok = ok && qpos - key < window;
  return ok;
}

// 4-byte global -> shared copy of a float; zero-fills when !valid.
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// Waits for the ring tile that cp.async group `t` brought, then makes it
// visible to every thread and to the tensor cores (the async proxy).
__device__ __forceinline__ void tile_ready() {
  cp_async_wait<kStages - 2>();
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
}

// acc (64 x P, as P / 64 blocks of 64 columns) * scale -> bf16 rows
// [row0, row0 + 64) of an array with `stride` elements between rows,
// `width` columns, rows below n_rows only.
template <int P>
__device__ __forceinline__ void store_rows(const float (&acc)[P / 64][32],
                                           bf16* base, size_t stride,
                                           int row0, int n_rows, int width,
                                           float scale) {
  const int lane = threadIdx.x % 32;
  const int r = row0 + 16 * (threadIdx.x / 32) + lane / 4;
  const int cq = 2 * (lane % 4);
#pragma unroll
  for (int jb = 0; jb < P / 64; ++jb)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 64 * jb + 8 * j + cq;
      if (col >= width) continue;
      if (r < n_rows)
        *reinterpret_cast<__nv_bfloat162*>(base + r * stride + col) =
            __floats2bfloat162_rn(acc[jb][4 * j] * scale,
                                  acc[jb][4 * j + 1] * scale);
      if (r + 8 < n_rows)
        *reinterpret_cast<__nv_bfloat162*>(base + (r + 8) * stride + col) =
            __floats2bfloat162_rn(acc[jb][4 * j + 2] * scale,
                                  acc[jb][4 * j + 3] * scale);
    }
}

// acc (64 x N) = A (64 rows x P, shared) B (N rows x P, shared)^T,
// started asynchronously: P / 16 steps of 16, both operands K-major
// swizzled tiles of a_rows and N rows.  The caller zeroes acc before its wgmma.fence.
template <int P, int N>
__device__ __forceinline__ void mma_ss(float (&acc)[N / 2], uint32_t a,
                                         int a_rows, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < P / 16; ++kk) {
    const uint32_t aa = a + (kk / 4) * (a_rows * 128) + (kk % 4) * 32;
    const uint32_t bb = b + (kk / 4) * (N * 128) + (kk % 4) * 32;
    wgmma_ss<N>(acc, smem_desc(aa, 16, 1024), smem_desc(bb, 16, 1024),
                kk > 0);
  }
}

// acc (64 x P, as P / 64 blocks) += A (64 x K, K / 16 bf16 fragments) B,
// B a swizzled tile of K rows x P columns read with the transpose bit;
// started asynchronously.
template <int P, int K>
__device__ __forceinline__ void mma_rs(float (&acc)[P / 64][32],
                                         const uint32_t (&a)[K / 16][4],
                                         uint32_t b) {
#pragma unroll
  for (int jb = 0; jb < P / 64; ++jb)
#pragma unroll
    for (int kk = 0; kk < K / 16; ++kk)
      wgmma_rs<64>(acc[jb], a[kk],
                   smem_desc(b + jb * (K * 128) + kk * 16 * 128, K * 128,
                             1024));
}

template <int PD, int PV, int BQ>
__global__ void __launch_bounds__(kThreads, PD <= 64 ? 2 : 1)
attn_bwd_dkdv_wgmma_kernel(const bf16* __restrict__ q,
                           const bf16* __restrict__ k,
                           const bf16* __restrict__ v,
                           const bf16* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           bf16* __restrict__ dk, bf16* __restrict__ dv,
                           int Sq, int Sk, int H, int KV, int D, int Dv,
                           float scale_log2, float scale, int mask_kind,
                           int window, int valid_len, int q_offset) {
  constexpr int kKBytes = (PD / 64) * kBK * 128;
  constexpr int kVBytes = (PV / 64) * kBK * 128;
  constexpr int kQBytes = (PD / 64) * BQ * 128;
  constexpr int kOBytes = (PV / 64) * BQ * 128;
  constexpr int kStageBytes = kQBytes + kOBytes;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base =
      (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023) &
      ~1023u;                     // the swizzle repeats every 1024 bytes
  const uint32_t s_k = base;
  const uint32_t s_v = base + kKBytes;
  const uint32_t s_ring = s_v + kVBytes;
  // lse and delta of each stage: 2 BQ floats, after the tiles
  float* s_ld = reinterpret_cast<float*>(
      smem_raw + (s_ring + kStages * kStageBytes - static_cast<uint32_t>(
                      __cvta_generic_to_shared(smem_raw))));

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int k0 = blockIdx.x * kBK;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int rep = H / KV;
  const int kv_end = min(valid_len, Sk);

  // query rows that may see one of the block's keys [k0, k_last]
  const int k_last = min(k0 + kBK, kv_end) - 1;
  int i_lo = 0, i_hi = Sq;
  if (mask_kind != kNone) i_lo = max(0, k0 - q_offset);
  if (mask_kind == kWindow) i_hi = min(Sq, k_last + window - q_offset);
  if (k_last < k0) i_hi = i_lo;            // no valid key in this block
  const int n_qt = i_hi > i_lo ? (i_hi - i_lo + BQ - 1) / BQ : 0;
  const int n_iter = rep * n_qt;

  const bf16* kb = k + (static_cast<size_t>(b) * Sk * KV + kvh) * D;
  const bf16* vb = v + (static_cast<size_t>(b) * Sk * KV + kvh) * Dv;
  // tile t: query head kvh * rep + t / n_qt, rows from i_lo + (t % n_qt) BQ
  const auto load_stage = [&](int t) {
    const int h = kvh * rep + t / n_qt;
    const int i0 = i_lo + (t % n_qt) * BQ;
    const uint32_t st = s_ring + (t % kStages) * kStageBytes;
    load_tile<PD, BQ, kThreads>(
        st, q + (static_cast<size_t>(b) * Sq * H + h) * D,
        static_cast<size_t>(H) * D, i0, Sq - i0, D, tid);
    load_tile<PV, BQ, kThreads>(
        st + kQBytes, dout + (static_cast<size_t>(b) * Sq * H + h) * Dv,
        static_cast<size_t>(H) * Dv, i0, Sq - i0, Dv, tid);
    float* ld = s_ld + (t % kStages) * 2 * BQ;
    const size_t row = (static_cast<size_t>(b) * H + h) * Sq;
    for (int e = tid; e < 2 * BQ; e += kThreads) {
      const int i = i0 + e % BQ;
      const float* src = (e < BQ ? lse : delta) + row + (i < Sq ? i : 0);
      cp_async4(ld + e, src, i < Sq);
    }
  };

  float dk_acc[PD / 64][32], dv_acc[PV / 64][32];
#pragma unroll
  for (int jb = 0; jb < PD / 64; ++jb)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk_acc[jb][i] = 0.0f;
#pragma unroll
  for (int jb = 0; jb < PV / 64; ++jb)
#pragma unroll
    for (int i = 0; i < 32; ++i) dv_acc[jb][i] = 0.0f;

  if (n_iter > 0) {
    load_tile<PD, kBK, kThreads>(s_k, kb, static_cast<size_t>(KV) * D, k0,
                                 kv_end - k0, D, tid);
    load_tile<PV, kBK, kThreads>(s_v, vb, static_cast<size_t>(KV) * Dv, k0,
                                 kv_end - k0, Dv, tid);
    load_stage(0);
    cp_async_commit();
    for (int t = 1; t < kStages - 1; ++t) {
      if (t < n_iter) load_stage(t);
      cp_async_commit();
    }
  }

  // this thread's keys (rows of S^T) and query columns
  const int r0 = 16 * warp + lane / 4;
  const int cq = 2 * (lane % 4);
  const float nl2e = -kLog2e;
  for (int t = 0; t < n_iter; ++t) {
    tile_ready();                  // tile t landed; stage t - 1 is free
    if (t + kStages - 1 < n_iter) load_stage(t + kStages - 1);
    cp_async_commit();

    const int i0 = i_lo + (t % n_qt) * BQ;
    const uint32_t st = s_ring + (t % kStages) * kStageBytes;
    const float* ld = s_ld + (t % kStages) * 2 * BQ;
    float s[BQ / 2], dp[BQ / 2];
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) s[i] = dp[i] = 0.0f;
    wgmma_fence();
    mma_ss<PD, BQ>(s, s_k, kBK, st);
    mma_ss<PV, BQ>(dp, s_v, kBK, st + kQBytes);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<BQ / 2>(s);
    fence_regs<BQ / 2>(dp);

    const int qp0 = i0 + q_offset;           // position of query column 0
    const bool bite = k0 + kBK > kv_end || i0 + BQ > Sq ||
                      (mask_kind != kNone && qp0 < k0 + kBK - 1) ||
                      (mask_kind == kWindow && qp0 + BQ - 1 - k0 >= window);
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
      const int col = 8 * j + cq;
      const float2 l2 = *reinterpret_cast<const float2*>(ld + col);
      const float2 d2 = *reinterpret_cast<const float2*>(ld + BQ + col);
      const float nl[2] = {l2.x * nl2e, l2.y * nl2e};
      const float dl[2] = {d2.x, d2.y};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * j + e;
        float p = ex2(fmaf(s[i], scale_log2, nl[e & 1]));
        if (bite) {
          const int key = k0 + r0 + 8 * (e >> 1);
          const int qi = i0 + col + (e & 1);
          if (!(qi < Sq &&
                visible(key, qi + q_offset, kv_end, mask_kind, window)))
            p = 0.0f;
        }
        s[i] = p;
        dp[i] = p * (dp[i] - dl[e & 1]);
      }
    }
    uint32_t pa[BQ / 16][4], da[BQ / 16][4];
    pack_frags<BQ>(s, pa);
    pack_frags<BQ>(dp, da);
    wgmma_fence();
    mma_rs<PV, BQ>(dv_acc, pa, st + kQBytes);
    mma_rs<PD, BQ>(dk_acc, da, st);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int jb = 0; jb < PV / 64; ++jb) fence_regs<32>(dv_acc[jb]);
#pragma unroll
    for (int jb = 0; jb < PD / 64; ++jb) fence_regs<32>(dk_acc[jb]);
    fence_frags<BQ / 16>(pa);
    fence_frags<BQ / 16>(da);
  }
  cp_async_wait<0>();

  const size_t kv0 = static_cast<size_t>(b) * Sk * KV + kvh;
  store_rows<PD>(dk_acc, dk + kv0 * D, static_cast<size_t>(KV) * D, k0, Sk,
                 D, scale);
  store_rows<PV>(dv_acc, dv + kv0 * Dv, static_cast<size_t>(KV) * Dv, k0, Sk,
                 Dv, 1.0f);
}

template <int PD, int PV>
__global__ void __launch_bounds__(kThreads, PD <= 64 ? 2 : 1)
attn_bwd_dq_wgmma_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         bf16* __restrict__ dq, int Sq, int Sk, int H, int KV,
                         int D, int Dv, float scale_log2, float scale,
                         int mask_kind, int window, int valid_len,
                         int q_offset) {
  constexpr int kQBytes = (PD / 64) * kBQdq * 128;
  constexpr int kOBytes = (PV / 64) * kBQdq * 128;
  constexpr int kKBytes = (PD / 64) * kBK * 128;
  constexpr int kVBytes = (PV / 64) * kBK * 128;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t s_q =
      (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023) &
      ~1023u;
  const uint32_t s_do = s_q + kQBytes;
  const uint32_t s_ring = s_do + kOBytes;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int q0 = blockIdx.x * kBQdq;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);

  // keys any query of this block may see: [lo, hi), lo rounded down to a
  // tile, as the forward
  const int kv_end = min(valid_len, Sk);
  const int first_q = q0 + q_offset;
  const int last_q = min(q0 + kBQdq, Sq) - 1 + q_offset;
  int hi = kv_end;
  int lo = 0;
  if (mask_kind != kNone) hi = min(hi, last_q + 1);
  if (mask_kind == kWindow) lo = max(0, first_q - window + 1);
  lo -= lo % kBK;
  const int n_tiles = hi > lo ? (hi - lo + kBK - 1) / kBK : 0;

  const bf16* kb = k + (static_cast<size_t>(b) * Sk * KV + kvh) * D;
  const bf16* vb = v + (static_cast<size_t>(b) * Sk * KV + kvh) * Dv;
  const auto stage = [&](int t) {
    return s_ring + (t % kStages) * (kKBytes + kVBytes);
  };
  const auto load_kv = [&](int t) {
    const int key0 = lo + t * kBK;
    load_tile<PD, kBK, kThreads>(stage(t), kb, static_cast<size_t>(KV) * D,
                                 key0, kv_end - key0, D, tid);
    load_tile<PV, kBK, kThreads>(stage(t) + kKBytes, vb,
                                 static_cast<size_t>(KV) * Dv, key0,
                                 kv_end - key0, Dv, tid);
  };

  // this thread's rows and their lse (times -log2 e) and delta
  const int r0 = 16 * warp + lane / 4;
  const int cq = 2 * (lane % 4);
  float nl[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + 8 * r;
    const size_t at = (static_cast<size_t>(b) * H + h) * Sq + row;
    nl[r] = row < Sq ? lse[at] * -kLog2e : 0.0f;
    dl[r] = row < Sq ? delta[at] : 0.0f;
  }

  float dq_acc[PD / 64][32];
#pragma unroll
  for (int jb = 0; jb < PD / 64; ++jb)
#pragma unroll
    for (int i = 0; i < 32; ++i) dq_acc[jb][i] = 0.0f;

  if (n_tiles > 0) {
    const size_t row0 = static_cast<size_t>(b) * Sq * H + h;
    load_tile<PD, kBQdq, kThreads>(s_q, q + row0 * D,
                                   static_cast<size_t>(H) * D, q0, Sq - q0,
                                   D, tid);
    load_tile<PV, kBQdq, kThreads>(s_do, dout + row0 * Dv,
                                   static_cast<size_t>(H) * Dv, q0, Sq - q0,
                                   Dv, tid);
    load_kv(0);
    cp_async_commit();
    for (int t = 1; t < kStages - 1; ++t) {
      if (t < n_tiles) load_kv(t);
      cp_async_commit();
    }
  }

  for (int t = 0; t < n_tiles; ++t) {
    tile_ready();
    if (t + kStages - 1 < n_tiles) load_kv(t + kStages - 1);
    cp_async_commit();

    const int key0 = lo + t * kBK;
    float s[kBK / 2], dp[kBK / 2];
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) s[i] = dp[i] = 0.0f;
    wgmma_fence();
    mma_ss<PD, kBK>(s, s_q, kBQdq, stage(t));
    mma_ss<PV, kBK>(dp, s_do, kBQdq, stage(t) + kKBytes);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<kBK / 2>(s);
    fence_regs<kBK / 2>(dp);

    const bool bite = key0 + kBK > kv_end ||
                      (mask_kind != kNone && key0 + kBK - 1 > first_q) ||
                      (mask_kind == kWindow &&
                       q0 + kBQdq - 1 + q_offset - key0 >= window);
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) {
      const int r = (i >> 1) & 1;
      float p = ex2(fmaf(s[i], scale_log2, nl[r]));
      if (bite) {
        const int key = key0 + 8 * (i / 4) + cq + (i & 1);
        if (!visible(key, q0 + r0 + 8 * r + q_offset, kv_end, mask_kind,
                     window))
          p = 0.0f;
      }
      s[i] = p * (dp[i] - dl[r]);
    }
    uint32_t a[kBK / 16][4];
    pack_frags<kBK>(s, a);
    wgmma_fence();
    mma_rs<PD, kBK>(dq_acc, a, stage(t));
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int jb = 0; jb < PD / 64; ++jb) fence_regs<32>(dq_acc[jb]);
    fence_frags<kBK / 16>(a);
  }
  cp_async_wait<0>();

  store_rows<PD>(dq_acc, dq + (static_cast<size_t>(b) * Sq * H + h) * D,
                 static_cast<size_t>(H) * D, q0, Sq, D, scale);
}

template <int PD, int PV, int BQ>
constexpr int dkdv_smem() {
  return 1024 + 128 * kBK * (PD / 64 + PV / 64) +
         kStages * (128 * BQ * (PD / 64 + PV / 64) + 2 * BQ * 4);
}

template <int PD, int PV>
constexpr int dq_smem() {
  return 1024 + 128 * kBQdq * (PD / 64 + PV / 64) +
         kStages * 128 * kBK * (PD / 64 + PV / 64);
}

template <int PD, int PV, int BQ>
int launch(const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
           const float* lse, const float* delta, bf16* dq, bf16* dk,
           bf16* dv, int B, int Sq, int Sk, int H, int KV, int D, int Dv,
           int mask_kind, int window, int valid_len, int q_offset,
           cudaStream_t stream) {
  constexpr int kDkdvSmem = dkdv_smem<PD, PV, BQ>();
  constexpr int kDqSmem = dq_smem<PD, PV>();
  static_assert(kDkdvSmem <= 232448 && kDqSmem <= 232448,
                "tiles and rings exceed shared memory");
  const double rs = 1.0 / sqrt(static_cast<double>(D));
  const float scale_log2 = static_cast<float>(1.4426950408889634 * rs);
  const float scale = static_cast<float>(rs);
  cudaError_t e;
  if (Sk > 0) {
    e = cudaFuncSetAttribute(attn_bwd_dkdv_wgmma_kernel<PD, PV, BQ>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kDkdvSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    const dim3 grid((Sk + kBK - 1) / kBK, KV, B);
    attn_bwd_dkdv_wgmma_kernel<PD, PV, BQ><<<grid, kThreads, kDkdvSmem,
                                             stream>>>(
        q, k, v, dout, lse, delta, dk, dv, Sq, Sk, H, KV, D, Dv, scale_log2,
        scale, mask_kind, window, valid_len, q_offset);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  e = cudaFuncSetAttribute(attn_bwd_dq_wgmma_kernel<PD, PV>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kDqSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((Sq + kBQdq - 1) / kBQdq, H, B);
  attn_bwd_dq_wgmma_kernel<PD, PV><<<grid, kThreads, kDqSmem, stream>>>(
      q, k, v, dout, lse, delta, dq, Sq, Sk, H, KV, D, Dv, scale_log2, scale,
      mask_kind, window, valid_len, q_offset);
  return static_cast<int>(cudaGetLastError());
}

// The class of (D, Dv): f(PD, PV, BQ) as integral constants.
template <class F>
int dispatch(int D, int Dv, F&& f) {
  if (D <= 64 && Dv <= 64)
    return f(std::integral_constant<int, 64>{},
             std::integral_constant<int, 64>{},
             std::integral_constant<int, 64>{});
  if (D <= 128)
    return f(std::integral_constant<int, 128>{},
             std::integral_constant<int, 128>{},
             std::integral_constant<int, 32>{});
  return f(std::integral_constant<int, 192>{},
           std::integral_constant<int, 128>{},
           std::integral_constant<int, 32>{});
}

}  // namespace

// Called by flash_attention_bwd (flash_attention_bwd.cu) for bf16 inputs,
// after its delta kernel, with its arguments checked there; D and Dv
// multiples of 8, D at most 192, Dv at most 128.  Two launches (one when
// Sk is 0: dk and dv are then empty).
int flash_attention_bwd_wgmma(const void* q, const void* k, const void* v,
                              const void* dout, const float* lse,
                              const float* delta, void* dq, void* dk,
                              void* dv, int B, int Sq, int Sk, int H, int KV,
                              int D, int Dv, int mask_kind, int window,
                              int valid_len, int q_offset,
                              cudaStream_t stream) {
  if (D % 8 != 0 || Dv % 8 != 0 || D > 192 || Dv > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(D, Dv, [&](auto pd, auto pv, auto bq) {
    return launch<decltype(pd)::value, decltype(pv)::value,
                  decltype(bq)::value>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse,
        delta, static_cast<bf16*>(dq), static_cast<bf16*>(dk),
        static_cast<bf16*>(dv), B, Sq, Sk, H, KV, D, Dv, mask_kind, window,
        valid_len, q_offset, stream);
  });
}

// The launch shape of the two kernels for (D, Dv): out[0..2] = dk / dv
// threads a block, dynamic shared memory bytes, blocks one SM can hold at
// once; out[3..5] the same for the dq kernel.  Returns a cudaError_t code.
extern "C" int flash_attention_bwd_occupancy(int D, int Dv, int* out) {
  if (D <= 0 || Dv <= 0 || D > 192 || Dv > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(D, Dv, [&](auto pd, auto pv, auto bq) {
    constexpr int PD = decltype(pd)::value, PV = decltype(pv)::value,
                  BQ = decltype(bq)::value;
    constexpr int kDkdvSmem = dkdv_smem<PD, PV, BQ>();
    constexpr int kDqSmem = dq_smem<PD, PV>();
    cudaError_t e = cudaFuncSetAttribute(
        attn_bwd_dkdv_wgmma_kernel<PD, PV, BQ>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kDkdvSmem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(attn_bwd_dq_wgmma_kernel<PD, PV>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kDqSmem);
    out[0] = out[3] = kThreads;
    out[1] = kDkdvSmem;
    out[4] = kDqSmem;
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &out[2], attn_bwd_dkdv_wgmma_kernel<PD, PV, BQ>, kThreads,
          kDkdvSmem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &out[5], attn_bwd_dq_wgmma_kernel<PD, PV>, kThreads, kDqSmem);
    return static_cast<int>(e);
  });
}
