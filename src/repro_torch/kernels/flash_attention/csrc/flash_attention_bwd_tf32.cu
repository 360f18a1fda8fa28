// Flash-attention backward for float32 on Hopper tensor cores (sm_90a), as
// 3xTF32 on wgmma.
//
// Replaces no TPU kernel: the TPU reference differentiates its attention
// through the custom VJP of src/repro/kernels/flash_attention/ops.py
// (_fa_diff_bwd), which recomputes the probabilities from the forward's
// log-sum-exp.  flash_attention_bwd.cu's entry calls this file for float32
// inputs after its delta kernel (delta_i = sum_d dout_i,d out_i,d); bfloat16
// runs flash_attention_bwd_wgmma.cu.  For q (B, Sq, H, D), k (B, Sk, KV, D),
// v (B, Sk, KV, Dv), dout (B, Sq, H, Dv), row-major float32, and the
// forward's lse and delta (B, H, Sq, float32), it writes dq, dk, dv in
// float32:
//     P_ij = exp(q_i . k_j / sqrt(D) - lse_i)     on the visible (i, j)
//     dS_ij = P_ij (dout_i . v_j - delta_i)
//     dv_j = sum_i P_ij dout_i,  dk_j = sum_i dS_ij q_i / sqrt(D),
//     dq_i = sum_j dS_ij k_j / sqrt(D)
// with dk and dv of KV head g summed over its H / KV query heads, and the
// masks of the forward ("causal", "window", "none", k < kv_valid_len,
// queries at q_offset + i).  Any D up to 192 over any Dv up to 128, at any
// alignment; head dims are zero-filled to the forward's classes (PD, PV) =
// (64, 64), (128, 128), (192, 128).
//
// Why 3xTF32: every product runs as three TF32 products of the operands'
// high and low parts (tf32_common.cuh), about 2^-21 of |a b| a product;
// one TF32 product (2^-11 a term) would miss the reference's 3e-5 float32
// gradient tolerance.  P and dS are not rounded to a narrower type: they
// are split into hi and lo like every other operand.
//
// What bounds it on the H100: 2 (3 D + 2 Dv) operations per visible
// (q, k) pair and head (S = q k, dP = dout v, dv += P dout, dk += dS q,
// dq += dS k), three TF32 products each at 495 TFLOP/s, against q, k, v,
// out, dout, lse read once and dq, dk, dv written once at 3.35 TB/s.  At
// Hymba's training shape (q (4, 1152, 25, 64), k/v 5 heads, window 1024)
// that is 4.2e10 operations, 254.4 us, against 59 MB, 18 us: bound by
// operations.  Recomputing S and dP in the dq kernel adds 4 D per pair.
//
// Design: the bf16 backward's (flash_attention_bwd_wgmma.cu), with its
// products rearranged for TF32, which wgmma reads K-major only: a factor
// whose sum index is not contiguous in memory becomes the A operand, read
// element by element into registers from a tile in either orientation
// (tf32_common.cuh), and the other factor the B operand, a hi / lo tile
// pair in shared memory.  No atomics, so two calls on the same inputs are
// bitwise equal.  One warpgroup (128 threads) a block.
// 1. dk / dv kernel: one block a (b, KV head, 64 keys).  K and V stay in
//    shared memory as float32; the block walks the H / KV query heads of
//    its group (GQA folded inside the block) and, for each, the tiles of
//    32 query rows the mask lets see one of its keys: Q, dO, lse and
//    delta arrive by cp.async and Q and dO are split in place into hi and
//    lo tiles.  S^T = K Q^T and dP^T = V dO^T (M = the 64 keys, N = 32
//    queries, one pipeline of wgmma for both; K's and V's fragments from
//    hi / lo tiles split once at (128, 128), split in registers on every
//    tile at the other classes; Q and dO as stored are the K-major B
//    operands); P^T = exp2(S^T c - lse log2 e),
//    dS^T = P^T (dP^T - delta), both split into B tiles (keys x queries,
//    the queries contiguous).  Then dV^T += dO^T P and dK^T += Q^T dS,
//    their A fragments read across dO's and Q's hi / lo tiles, so the
//    accumulators hold dV^T (Dv x keys) and dK^T (D x keys), written out
//    transposed at the end; each tile's terms land in fresh accumulators
//    first (tf32_common.cuh: the tensor cores' sums drift over thousands
//    of steps into one accumulator).  At (192, 128) the accumulators take
//    160 registers a thread (ptxas spills a few hundred bytes), and shared
//    memory holds K, V, Q / dO hi / lo and P^T / dS^T hi / lo, 193 KB: one
//    block an SM (two at (64, 64)).  The first key blocks, which the most
//    queries see under a causal mask, start first.
// 2. dq kernel: one block a (b, head, 64 queries) with Q and dO staged once
//    as float32 (Q split once into hi / lo tiles at (128, 128)), walking
//    the visible 32-key tiles through a staging tile split into K and V
//    hi / lo tiles (the next tile's copies overlap the products): S = Q
//    K^T and dP = dO V^T (one pipeline, the roles of the forward's S),
//    dS = P (dP - delta) with lse and delta row constants, split into a B
//    tile (queries x keys), then dQ^T += K^T dS^T with K^T's fragments read
//    across K's hi / lo tiles, a fresh accumulator a tile.  The last query
//    tiles start first, as in the forward.
// The 1/sqrt(D) scale multiplies S in float32 after the product (folded
// with log2 e into one FMA before ex2.approx, as the forward) and dq, dk
// once at the end.  Masks only where they bite: tiles wholly outside every
// visible range are never loaded, and positions are compared only on
// tiles that cross the diagonal, the window's edge, kv_valid_len or Sq; a
// masked pair's P is set to 0, so a fully masked row (lse = -FLT_MAX) and
// zero-filled keys add nothing, and keys at or past kv_valid_len get zero
// gradients.  The launches run on the caller's stream; the entry returns
// cudaGetLastError().

#include <type_traits>

#include "tf32_common.cuh"

namespace {

constexpr int kBK = 64;        // keys a dk / dv block
constexpr int kBQ = 32;        // queries a dk / dv tile
constexpr int kBQdq = 64;      // queries a dq block
constexpr int kBKdq = 32;      // keys a dq tile
constexpr float kLog2e = 1.4426950408889634f;

enum MaskKind { kCausal = 0, kWindow = 1, kNone = 2 };

__device__ __forceinline__ bool visible(int key, int qpos, int kv_end,
                                        int mask_kind, int window) {
  bool ok = key < kv_end;
  if (mask_kind != kNone) ok = ok && key <= qpos;
  if (mask_kind == kWindow) ok = ok && qpos - key < window;
  return ok;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// K and V (dk / dv kernel) and Q (dq kernel), read on every tile, are
// split into hi and lo tiles once where shared memory holds both: at (128,
// 128).  Elsewhere they stay float32 and their fragments are split on
// every tile (at (64, 64) so that two blocks fit an SM, at (192, 128)
// because the split tiles do not fit).
template <int PD>
constexpr bool kPresplit = PD == 128;

// Shared memory of the dk / dv kernel, in bytes from a 1024-byte boundary:
// K (and its lo tile), V (and its lo tile), then the query tile's.
template <int PD, int PV>
struct DkdvSmem {
  static constexpr int kK = kBK * PD * 4;
  static constexpr int kV = kBK * PV * 4;
  static constexpr int kQ = kBQ * PD * 4;
  static constexpr int kO = kBQ * PV * 4;
  static constexpr int kP = kBK * kBQ * 4;
  static constexpr int kCopies = kPresplit<PD> ? 2 : 1;
  static constexpr int oKl = kK;
  static constexpr int oV = kCopies * kK;
  static constexpr int oVl = oV + kV;
  static constexpr int oQh = oV + kCopies * kV;
  static constexpr int oQl = oQh + kQ;
  static constexpr int oOh = oQl + kQ;
  static constexpr int oOl = oOh + kO;
  static constexpr int oPh = oOl + kO;
  static constexpr int oPl = oPh + kP;
  static constexpr int oDh = oPl + kP;
  static constexpr int oDl = oDh + kP;
  static constexpr int oLD = oDl + kP;        // lse, delta: 2 x kBQ floats
  static constexpr int kBytes = oLD + 2 * kBQ * 4 + 1024;
  static_assert(kBytes <= 232448, "tiles exceed shared memory");
};

// Shared memory of the dq kernel, in bytes from a 1024-byte boundary: Q
// (and its lo tile), dO, then the key tile's.
template <int PD, int PV>
struct DqSmem {
  static constexpr int kQ = kBQdq * PD * 4;
  static constexpr int kO = kBQdq * PV * 4;
  static constexpr int kK = kBKdq * PD * 4;
  static constexpr int kV = kBKdq * PV * 4;
  static constexpr int kS = kBQdq * kBKdq * 4;
  static constexpr int oQl = kQ;
  static constexpr int oO = (kPresplit<PD> ? 2 : 1) * kQ;
  static constexpr int oKh = oO + kO;
  static constexpr int oKl = oKh + kK;
  static constexpr int oVh = oKl + kK;
  static constexpr int oVl = oVh + kV;
  static constexpr int oKs = oVl + kV;        // staging of the next tile
  static constexpr int oVs = oKs + kK;
  static constexpr int oSh = oVs + kV;
  static constexpr int oSl = oSh + kS;
  static constexpr int kBytes = oSl + kS + 1024;
  static_assert(kBytes <= 232448, "tiles exceed shared memory");
};

// The transposed accumulators (P / 64 blocks of 64 rows of the head dim x
// 64 columns) * scale, written to rows [row0, row0 + 64) of an array with
// `stride` floats between rows, `width` columns, rows below n_rows only.
template <int P>
__device__ __forceinline__ void store_t(const float (&acc)[P / 64][32],
                                        float* base, size_t stride, int row0,
                                        int n_rows, int width, float scale) {
  const int lane = threadIdx.x % 32;
  const int r = 16 * (threadIdx.x / 32) + lane / 4;
  const int cq = 2 * (lane % 4);
#pragma unroll
  for (int mb = 0; mb < P / 64; ++mb)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 64 * mb + r + 8 * (e >> 1);
        const int row = row0 + 8 * j + cq + (e & 1);
        if (col < width && row < n_rows)
          base[static_cast<size_t>(row) * stride + col] =
              acc[mb][4 * j + e] * scale;
      }
}

template <int PD, int PV>
__global__ void __launch_bounds__(128, PD <= 64 ? 2 : 1)
attn_bwd_dkdv_tf32_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          float* __restrict__ dk, float* __restrict__ dv,
                          int Sq, int Sk, int H, int KV, int D, int Dv,
                          float scale_log2, float scale, int mask_kind,
                          int window, int valid_len, int q_offset, int vec) {
  using L = DkdvSmem<PD, PV>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  uint8_t* sm = smem_raw + (base - smem_u32(smem_raw));
  float* ld = reinterpret_cast<float*>(sm + L::oLD);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  // the first key blocks, which the most queries see under a causal mask,
  // start first
  const int k0 = blockIdx.y * kBK;
  const int kvh = blockIdx.x;
  const int b = blockIdx.z;
  const int rep = H / KV;
  const int kv_end = min(valid_len, Sk);

  // query rows that may see one of the block's keys [k0, k_last]
  const int k_last = min(k0 + kBK, kv_end) - 1;
  int i_lo = 0, i_hi = Sq;
  if (mask_kind != kNone) i_lo = max(0, k0 - q_offset);
  if (mask_kind == kWindow) i_hi = min(Sq, k_last + window - q_offset);
  if (k_last < k0) i_hi = i_lo;            // no valid key in this block
  const int n_qt = i_hi > i_lo ? (i_hi - i_lo + kBQ - 1) / kBQ : 0;
  const int n_iter = rep * n_qt;

  float dk_acc[PD / 64][32], dv_acc[PV / 64][32];
#pragma unroll
  for (int mb = 0; mb < PD / 64; ++mb)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk_acc[mb][i] = 0.0f;
#pragma unroll
  for (int mb = 0; mb < PV / 64; ++mb)
#pragma unroll
    for (int i = 0; i < 32; ++i) dv_acc[mb][i] = 0.0f;

  if (n_iter > 0) {
    load_f32_tile<PD, kBK, 128>(
        base, k + (static_cast<size_t>(b) * Sk * KV + kvh) * D,
        static_cast<size_t>(KV) * D, k0, kv_end - k0, D, vec, tid);
    load_f32_tile<PV, kBK, 128>(
        base + L::oV, v + (static_cast<size_t>(b) * Sk * KV + kvh) * Dv,
        static_cast<size_t>(KV) * Dv, k0, kv_end - k0, Dv, vec, tid);
  }

  // this thread's keys (rows of S^T) and query columns
  const int r0 = 16 * warp + lane / 4;
  const int cq = 2 * (lane % 4);
  const float nl2e = -kLog2e;
  for (int t = 0; t < n_iter; ++t) {
    // tile t: query head kvh * rep + t / n_qt, rows from i_lo + (t % n_qt)
    // BQ, with its lse and delta, into the hi tiles
    const int h = kvh * rep + t / n_qt;
    const int i0 = i_lo + (t % n_qt) * kBQ;
    __syncthreads();               // every product of tile t - 1 has landed
    load_f32_tile<PD, kBQ, 128>(
        base + L::oQh, q + (static_cast<size_t>(b) * Sq * H + h) * D,
        static_cast<size_t>(H) * D, i0, Sq - i0, D, vec, tid);
    load_f32_tile<PV, kBQ, 128>(
        base + L::oOh, dout + (static_cast<size_t>(b) * Sq * H + h) * Dv,
        static_cast<size_t>(H) * Dv, i0, Sq - i0, Dv, vec, tid);
    {
      const size_t row = (static_cast<size_t>(b) * H + h) * Sq;
      for (int e = tid; e < 2 * kBQ; e += 128) {
        const int i = i0 + e % kBQ;
        const float* src = (e < kBQ ? lse : delta) + row + (i < Sq ? i : 0);
        cp_async4(base + L::oLD + 4 * e, src, i < Sq);
      }
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    split_tile<L::kQ, 128>(sm + L::oQh, sm + L::oQh, sm + L::oQl, tid);
    split_tile<L::kO, 128>(sm + L::oOh, sm + L::oOh, sm + L::oOl, tid);
    if (kPresplit<PD> && t == 0) {
      split_tile<L::kK, 128>(sm, sm, sm + L::oKl, tid);
      split_tile<L::kV, 128>(sm + L::oV, sm + L::oV, sm + L::oVl, tid);
    }
    fence_proxy_async();
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T (64 keys x kBQ queries)
    float s[kBQ / 2], dp[kBQ / 2];
    chain2<kBQ, PD / 8, PV / 8, 2>(
        s,
        [&](int kk, uint32_t(&fh)[4], uint32_t(&fl)[4]) {
          if constexpr (kPresplit<PD>)
            frag_hl(sm, sm + L::oKl, kBK, 0, 8 * kk, fh, fl);
          else
            frag_split(sm, kBK, 0, 8 * kk, fh, fl);
        },
        base + L::oQh, base + L::oQl, dp,
        [&](int kk, uint32_t(&fh)[4], uint32_t(&fl)[4]) {
          if constexpr (kPresplit<PD>)
            frag_hl(sm + L::oV, sm + L::oVl, kBK, 0, 8 * kk, fh, fl);
          else
            frag_split(sm + L::oV, kBK, 0, 8 * kk, fh, fl);
        },
        base + L::oOh, base + L::oOl);

    const int qp0 = i0 + q_offset;           // position of query column 0
    const bool bite = k0 + kBK > kv_end || i0 + kBQ > Sq ||
                      (mask_kind != kNone && qp0 < k0 + kBK - 1) ||
                      (mask_kind == kWindow && qp0 + kBQ - 1 - k0 >= window);
#pragma unroll
    for (int j = 0; j < kBQ / 8; ++j) {
      const int col = 8 * j + cq;
      const float2 l2 = *reinterpret_cast<const float2*>(ld + col);
      const float2 d2 = *reinterpret_cast<const float2*>(ld + kBQ + col);
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
    store_split<kBQ>(s, sm + L::oPh, sm + L::oPl);
    store_split<kBQ>(dp, sm + L::oDh, sm + L::oDl);
    fence_proxy_async();
    __syncthreads();

    // dV^T += dO^T P and dK^T += Q^T dS (head dim x 64 keys), each tile's
    // terms in a fresh accumulator
#pragma unroll
    for (int mb = 0; mb < PV / 64; ++mb) {
      float part[32];
      chain<kBK, kBQ / 8, 2, 3>(
          part,
          [&](int kk, uint32_t(&fh)[4], uint32_t(&fl)[4]) {
            frag_t(sm + L::oOh, sm + L::oOl, kBQ, 64 * mb, 8 * kk, fh, fl);
          },
          base + L::oPh, base + L::oPl);
#pragma unroll
      for (int i = 0; i < 32; ++i) dv_acc[mb][i] += part[i];
    }
#pragma unroll
    for (int mb = 0; mb < PD / 64; ++mb) {
      float part[32];
      chain<kBK, kBQ / 8, 2, 3>(
          part,
          [&](int kk, uint32_t(&fh)[4], uint32_t(&fl)[4]) {
            frag_t(sm + L::oQh, sm + L::oQl, kBQ, 64 * mb, 8 * kk, fh, fl);
          },
          base + L::oDh, base + L::oDl);
#pragma unroll
      for (int i = 0; i < 32; ++i) dk_acc[mb][i] += part[i];
    }
  }
  cp_async_wait<0>();

  const size_t kv0 = static_cast<size_t>(b) * Sk * KV + kvh;
  store_t<PD>(dk_acc, dk + kv0 * D, static_cast<size_t>(KV) * D, k0, Sk, D,
              scale);
  store_t<PV>(dv_acc, dv + kv0 * Dv, static_cast<size_t>(KV) * Dv, k0, Sk,
              Dv, 1.0f);
}

template <int PD, int PV>
__global__ void __launch_bounds__(128, PD <= 64 ? 2 : 1)
attn_bwd_dq_tf32_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dq, int Sq, int Sk, int H, int KV,
                        int D, int Dv, float scale_log2, float scale,
                        int mask_kind, int window, int valid_len,
                        int q_offset, int vec) {
  using L = DqSmem<PD, PV>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  uint8_t* sm = smem_raw + (base - smem_u32(smem_raw));

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  // the last query tiles, which see the most keys under a causal mask,
  // start first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQdq;
  const int h = blockIdx.x;
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
  lo -= lo % kBKdq;
  const int n_tiles = hi > lo ? (hi - lo + kBKdq - 1) / kBKdq : 0;

  const float* kb = k + (static_cast<size_t>(b) * Sk * KV + kvh) * D;
  const float* vb = v + (static_cast<size_t>(b) * Sk * KV + kvh) * Dv;
  const auto load_kv = [&](int t) {
    const int key0 = lo + t * kBKdq;
    load_f32_tile<PD, kBKdq, 128>(base + L::oKs, kb,
                                  static_cast<size_t>(KV) * D, key0,
                                  kv_end - key0, D, vec, tid);
    load_f32_tile<PV, kBKdq, 128>(base + L::oVs, vb,
                                  static_cast<size_t>(KV) * Dv, key0,
                                  kv_end - key0, Dv, vec, tid);
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
  for (int mb = 0; mb < PD / 64; ++mb)
#pragma unroll
    for (int i = 0; i < 32; ++i) dq_acc[mb][i] = 0.0f;

  if (n_tiles > 0) {
    const size_t row0 = static_cast<size_t>(b) * Sq * H + h;
    load_f32_tile<PD, kBQdq, 128>(base, q + row0 * D,
                                  static_cast<size_t>(H) * D, q0, Sq - q0, D,
                                  vec, tid);
    load_f32_tile<PV, kBQdq, 128>(base + L::oO, dout + row0 * Dv,
                                  static_cast<size_t>(H) * Dv, q0, Sq - q0,
                                  Dv, vec, tid);
    load_kv(0);
  }
  cp_async_commit();

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<0>();
    __syncthreads();
    split_tile<L::kK, 128>(sm + L::oKs, sm + L::oKh, sm + L::oKl, tid);
    split_tile<L::kV, 128>(sm + L::oVs, sm + L::oVh, sm + L::oVl, tid);
    if (kPresplit<PD> && t == 0)
      split_tile<L::kQ, 128>(sm, sm, sm + L::oQl, tid);
    fence_proxy_async();
    __syncthreads();
    if (t + 1 < n_tiles) load_kv(t + 1);
    cp_async_commit();

    const int key0 = lo + t * kBKdq;
    float s[kBKdq / 2], dp[kBKdq / 2];
    chain2<kBKdq, PD / 8, PV / 8, 4>(
        s,
        [&](int kk, uint32_t(&fh)[4], uint32_t(&fl)[4]) {
          if constexpr (kPresplit<PD>)
            frag_hl(sm, sm + L::oQl, kBQdq, 0, 8 * kk, fh, fl);
          else
            frag_split(sm, kBQdq, 0, 8 * kk, fh, fl);
        },
        base + L::oKh, base + L::oKl, dp,
        [&](int kk, uint32_t(&fh)[4], uint32_t(&fl)[4]) {
          frag_split(sm + L::oO, kBQdq, 0, 8 * kk, fh, fl);
        },
        base + L::oVh, base + L::oVl);

    const bool bite = key0 + kBKdq > kv_end ||
                      (mask_kind != kNone && key0 + kBKdq - 1 > first_q) ||
                      (mask_kind == kWindow &&
                       q0 + kBQdq - 1 + q_offset - key0 >= window);
#pragma unroll
    for (int i = 0; i < kBKdq / 2; ++i) {
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
    store_split<kBKdq>(s, sm + L::oSh, sm + L::oSl);
    fence_proxy_async();
    __syncthreads();

    // dQ^T (head dim x 64 queries) += K^T dS^T, the tile's terms in a
    // fresh accumulator
#pragma unroll
    for (int mb = 0; mb < PD / 64; ++mb) {
      float part[32];
      chain<kBQdq, kBKdq / 8, 2, 3>(
          part,
          [&](int kk, uint32_t(&fh)[4], uint32_t(&fl)[4]) {
            frag_t(sm + L::oKh, sm + L::oKl, kBKdq, 64 * mb, 8 * kk, fh, fl);
          },
          base + L::oSh, base + L::oSl);
#pragma unroll
      for (int i = 0; i < 32; ++i) dq_acc[mb][i] += part[i];
    }
  }
  cp_async_wait<0>();

  store_t<PD>(dq_acc, dq + (static_cast<size_t>(b) * Sq * H + h) * D,
              static_cast<size_t>(H) * D, q0, Sq, D, scale);
}

// The class of (D, Dv): f(PD, PV) as integral constants.
template <class F>
int dispatch(int D, int Dv, F&& f) {
  if (D <= 64 && Dv <= 64)
    return f(std::integral_constant<int, 64>{},
             std::integral_constant<int, 64>{});
  if (D <= 128)
    return f(std::integral_constant<int, 128>{},
             std::integral_constant<int, 128>{});
  return f(std::integral_constant<int, 192>{},
           std::integral_constant<int, 128>{});
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <int PD, int PV>
int launch(const float* q, const float* k, const float* v, const float* dout,
           const float* lse, const float* delta, float* dq, float* dk,
           float* dv, int B, int Sq, int Sk, int H, int KV, int D, int Dv,
           int mask_kind, int window, int valid_len, int q_offset, int vec,
           cudaStream_t stream) {
  constexpr int kDkdvSmem = DkdvSmem<PD, PV>::kBytes;
  constexpr int kDqSmem = DqSmem<PD, PV>::kBytes;
  const double rs = 1.0 / sqrt(static_cast<double>(D));
  const float scale_log2 = static_cast<float>(1.4426950408889634 * rs);
  const float scale = static_cast<float>(rs);
  cudaError_t e;
  if (Sk > 0) {
    e = cudaFuncSetAttribute(attn_bwd_dkdv_tf32_kernel<PD, PV>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kDkdvSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    const dim3 grid(KV, (Sk + kBK - 1) / kBK, B);
    attn_bwd_dkdv_tf32_kernel<PD, PV><<<grid, 128, kDkdvSmem, stream>>>(
        q, k, v, dout, lse, delta, dk, dv, Sq, Sk, H, KV, D, Dv, scale_log2,
        scale, mask_kind, window, valid_len, q_offset, vec);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  e = cudaFuncSetAttribute(attn_bwd_dq_tf32_kernel<PD, PV>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kDqSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(H, (Sq + kBQdq - 1) / kBQdq, B);
  attn_bwd_dq_tf32_kernel<PD, PV><<<grid, 128, kDqSmem, stream>>>(
      q, k, v, dout, lse, delta, dq, Sq, Sk, H, KV, D, Dv, scale_log2, scale,
      mask_kind, window, valid_len, q_offset, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Called by flash_attention_bwd (flash_attention_bwd.cu) for float32
// inputs, after its delta kernel, with its arguments checked there; D at
// most 192, Dv at most 128.  Two launches (one when Sk is 0: dk and dv are
// then empty).
int flash_attention_bwd_tf32(const void* q, const void* k, const void* v,
                             const void* dout, const float* lse,
                             const float* delta, void* dq, void* dk, void* dv,
                             int B, int Sq, int Sk, int H, int KV, int D,
                             int Dv, int mask_kind, int window, int valid_len,
                             int q_offset, cudaStream_t stream) {
  if (D > 192 || Dv > 128) return static_cast<int>(cudaErrorInvalidValue);
  const int vec = D % 4 == 0 && Dv % 4 == 0 && aligned16(q) &&
                  aligned16(k) && aligned16(v) && aligned16(dout);
  return dispatch(D, Dv, [&](auto pd, auto pv) {
    return launch<decltype(pd)::value, decltype(pv)::value>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse,
        delta, static_cast<float*>(dq), static_cast<float*>(dk),
        static_cast<float*>(dv), B, Sq, Sk, H, KV, D, Dv, mask_kind, window,
        valid_len, q_offset, vec, stream);
  });
}
