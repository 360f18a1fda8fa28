// Flash-attention forward for float32 on Hopper tensor cores (sm_90a), as
// 3xTF32 on wgmma.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/flash_attention.py
// (flash_attention_pallas / _attn_kernel) for float32 inputs; bfloat16 runs
// flash_attention_wgmma.cu.  For q (B, Sq, H, D) and k/v (B, Sk, KV, D |
// Dv), row-major float32, it writes out (B, Sq, H, Dv) in float32:
// online-softmax attention with float32 running max, sum and accumulator;
// query head h reads KV head h / (H / KV) (GQA); masks "causal" (k <= q),
// "window" (k <= q and q - k < window) or "none", plus k < kv_valid_len,
// with the queries at absolute positions q_offset + i.  Any D up to 192
// (MLA's 128 + 64 rope dims) over any Dv up to 128, at any alignment; head
// dims are zero-filled up to a class (PD, PV) in {(64, 64), (128, 128),
// (192, 128)}.  With a non-null lse it also writes each row's log-sum-exp
// of its scaled scores (float32, (B, H, Sq); -FLT_MAX for a fully masked
// row), the residual of the backward.
//
// Why 3xTF32.  On the tensor cores float32 runs as TF32, 10 mantissa bits:
// one TF32 product is off by up to 2^-11 of each term, which misses the
// 2e-5 float32 tolerance.  Each float32 operand is split into a TF32 high and
// low part and every product runs as three TF32 products (tf32_common.cuh),
// about 2^-21 of |a b| a product, as PyTorch's own float32 attention does
// (the memory-efficient kernel, OpMultiplyAddFastF32 on mma.sync).  The
// probe entry flash_attention_tf32_probe below runs one such product on
// wgmma (ops.tf32_probe; chip_smoke.py's phase 3 measures it against
// float64 at D = 64, 128 and 192): on an H100 its error stays within
// 6e-7 of the terms' magnitudes, about 2^-21, where one TF32 product is
// off by 1.3e-4 to 2.3e-4; a float32 FMA product is about 2e-7.  The
// tensor cores' float32 sums do drift when a long sum keeps adding small
// terms to one accumulator, so each tile's P V lands in a fresh
// accumulator (tf32_common.cuh).
//
// What bounds it on the H100: 4 D operations per visible (q, k) pair per
// (b, h), as three TF32 products each, at 495 TFLOP/s, against q, k, v
// read once and out written once at 3.35 TB/s.  At DeepSeek-V2's width
// (q (1, 512, 128, 192), Dv 128, causal) that is 1.08e10 operations,
// 65.2 us, against 101 MB, 30 us: bound by operations.  Decode (Sq = 1)
// is bound by the bytes of K and V (MLA decode, 4 x 128 heads over 1057
// keys: 200.7 us).
//
// Two kernels, chosen by a fixed rule on the shape: when the query rows of
// one KV head, Sq * H / KV, number at most 8 (every decode step, whisper's
// cross-attention at Sq = 1) the key-split kernel serves the call, else
// the tile kernel.
//
// The tile kernel.  One block owns (b, h, WG x 64 queries), one warpgroup
// (128 threads) a 64-query tile: WG = 2 at (128, 128), else 1; the blocks
// of the last query tiles, which see the most keys under a causal mask,
// start first (the grid's slowest index runs over the tiles backwards),
// so that short blocks fill the last wave.  The Q tile
// is staged once in shared memory as float32; K/V tiles of 32 keys arrive
// through cp.async into a staging tile (16-byte copies where the rows allow
// it, 4-byte ones otherwise; keys past kv_valid_len and padded columns
// zero-filled) and are split once into hi and lo tiles, after which the
// next tile's copies start, so they overlap this tile's products.  S = Q
// K^T is wgmma m64n32k8 with Q's fragments split in registers and K's hi
// and lo tiles the B operand (keys x D, K-major as stored).  P V needs V
// K-major along the keys, which TF32 cannot read with a transpose bit, so
// the kernel computes O^T (Dv x queries) += V^T P^T instead: V^T's
// fragments come from V's hi / lo tiles read across (frag_t), and P, split,
// is written to shared memory as the B operand (queries x keys, K-major).
// The accumulator then holds O^T, so each row's softmax factor reaches the
// threads that hold its column through shared memory (64 floats a tile).
// The softmax is the bf16 kernel's: the 1/sqrt(D) scale folded with log2 e
// into one FMA before ex2.approx, the TPU's guards for fully masked rows
// (safe_m = 0 while m is -inf, alpha = 0, l >= 1e-20).  KV tiles wholly
// outside every query's visible range are never loaded; positions are
// compared only on tiles that cross the diagonal, the window's edge or
// kv_valid_len.  Shared memory: Q 48 KB, K hi / lo 48 KB, V hi / lo 32 KB,
// their staging 40 KB and P hi / lo 16 KB at (192, 128), 185 KB; one block
// an SM (two at (64, 64)).
//
// The key-split kernel.  Query rows are few, keys many: it stacks the
// H / KV query heads of one KV head (and the Sq <= 8 queries) as the 8
// columns of S^T = K Q^T (wgmma m64n8k8: the 64 keys of a tile are the M
// dimension, so nothing of the product is padding but the unused columns),
// so a K/V tile is read once for the whole group.  K's fragments are split
// in registers straight from the staged float32 tile; O^T (Dv x 8) += V^T
// P^T takes V^T's fragments the same way, P split into a small B tile.
// The keys are split over S blocks of one cluster (S <= 8; as many as make
// about two blocks an SM, no more than the tiles), each block walking its
// tiles through a two-stage cp.async ring and keeping its own (m, l,
// O^T); the cluster then combines the partials through distributed shared
// memory in a fixed order of blocks (each block one row), so no atomics
// and two calls on the same inputs are bitwise equal.  One launch.
//
// The wgmma wrappers, splits, tiles and fragments are in tf32_common.cuh,
// shared with the backward (flash_attention_bwd_tf32.cu).  The kernels
// launch on the caller's stream; the entry returns cudaGetLastError().

#include <cooperative_groups.h>
#include <type_traits>

#include "tf32_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kBK = 32;            // keys a tile (tile kernel)
constexpr int kSplitBK = 64;       // keys a tile (key-split kernel)
constexpr int kRows = 8;           // query rows of the key-split kernel
constexpr int kMaxSplits = 8;      // blocks of a cluster: portable maximum
constexpr int kTargetBlocks = 264; // two blocks for each of 132 SMs
constexpr float kNegInf = -3.4028234663852886e38f;   // finfo(float32).min
constexpr float kLn2 = 0.6931471805599453f;

enum MaskKind { kCausal = 0, kWindow = 1, kNone = 2 };

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Shared memory of the tile kernel, in bytes from a 1024-byte boundary.
template <int PD, int PV, int WG>
struct TileSmem {
  static constexpr int kQ = 64 * PD * 4;     // one warpgroup's Q tile
  static constexpr int kK = kBK * PD * 4;
  static constexpr int kV = kBK * PV * 4;
  static constexpr int kP = 64 * kBK * 4;    // P hi or lo, one warpgroup
  static constexpr int oKh = WG * kQ;
  static constexpr int oKl = oKh + kK;
  static constexpr int oVh = oKl + kK;
  static constexpr int oVl = oVh + kV;
  static constexpr int oKs = oVl + kV;       // staging of the next tile
  static constexpr int oVs = oKs + kK;
  static constexpr int oP = oVs + kV;
  static constexpr int oX = oP + WG * 2 * kP;   // 64 row factors a warpgroup
  static constexpr int kBytes = oX + WG * 64 * 4 + 1024;
  static_assert(kBytes <= 232448, "tiles exceed shared memory");
};

// One online-softmax step on a tile of BK scores in the accumulator layout
// (this thread: rows pos and pos + 8, columns 8 j + cq and + 1): masks the
// tile if `bite`, updates the rows' running max m and sum l, and turns s
// into P = exp2(S c - m c).  alpha is the factor for what was accumulated
// under the old max.
template <int BK>
__device__ __forceinline__ void softmax_step(float (&s)[BK / 2],
                                             float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], float c,
                                             bool bite, int k0, int pos,
                                             int cq, int kv_end,
                                             int mask_kind, int window) {
  if (bite) {
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int key = k0 + 8 * (i / 4) + cq + (i & 1);
      const int qp = pos + 8 * ((i >> 1) & 1);
      bool ok = key < kv_end;
      if (mask_kind != kNone) ok = ok && key <= qp;
      if (mask_kind == kWindow) ok = ok && qp - key < window;
      if (!ok) s[i] = kNegInf;
    }
  }
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int i = 0; i < BK / 2; ++i)
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
  float nb[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float mn = fmaxf(m[r], mx[r]);
    // guard fully masked rows (m == -inf) against NaNs, as the TPU does
    const float safe = mn <= kNegInf / 2 ? 0.0f : mn;
    alpha[r] = m[r] <= kNegInf / 2 ? 0.0f : ex2((m[r] - safe) * c);
    nb[r] = -safe * c;
    m[r] = mn;
  }
  float ps[2] = {0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    s[i] = ex2(fmaf(s[i], c, nb[(i >> 1) & 1]));
    ps[(i >> 1) & 1] += s[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = alpha[r] * l[r] + ps[r];
}

template <int PD, int PV, int WG>
__global__ void __launch_bounds__(128 * WG, 1)
attn_fwd_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     float* __restrict__ lse, int Sq, int Sk, int H, int KV,
                     int D, int Dv, float scale_log2, int mask_kind,
                     int window, int valid_len, int q_offset, int vec) {
  using L = TileSmem<PD, PV, WG>;
  constexpr int kNT = 128 * WG;
  constexpr int kBQ = 64 * WG;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  uint8_t* sm = smem_raw + (base - smem_u32(smem_raw));

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  // the last query tiles, which see the most keys under a causal mask,
  // start first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int h = blockIdx.x;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);

  // keys any query of this block may see: [lo, hi), lo rounded down to a
  // tile so that tiles line up with the diagonal
  const int kv_end = min(valid_len, Sk);
  const int first_q = q0 + q_offset;
  const int last_q = min(q0 + kBQ, Sq) - 1 + q_offset;
  int hi = kv_end;
  int lo = 0;
  if (mask_kind != kNone) hi = min(hi, last_q + 1);
  if (mask_kind == kWindow) lo = max(0, first_q - window + 1);
  lo -= lo % kBK;
  const int n_tiles = hi > lo ? (hi - lo + kBK - 1) / kBK : 0;

  const int wg_first = first_q + 64 * wg;
  const int wg_last = wg_first + 63;
  const int r0 = 16 * warp + lane / 4;
  const int cq = 2 * (lane % 4);
  const uint8_t* q_tile = sm + wg * L::kQ;
  uint8_t* p_hi = sm + L::oP + wg * 2 * L::kP;
  uint8_t* p_lo = p_hi + L::kP;
  float* rowf = reinterpret_cast<float*>(sm + L::oX) + 64 * wg;

  const float* kb = k + (static_cast<size_t>(b) * Sk * KV + kvh) * D;
  const float* vb = v + (static_cast<size_t>(b) * Sk * KV + kvh) * Dv;
  const auto load_kv = [&](int t) {
    const int k0 = lo + t * kBK;
    load_f32_tile<PD, kBK, kNT>(base + L::oKs, kb,
                                static_cast<size_t>(KV) * D, k0,
                                kv_end - k0, D, vec, tid);
    load_f32_tile<PV, kBK, kNT>(base + L::oVs, vb,
                                static_cast<size_t>(KV) * Dv, k0,
                                kv_end - k0, Dv, vec, tid);
  };
  if (n_tiles > 0) {
    const int qr = q0 + 64 * wg;
    load_f32_tile<PD, 64, 128>(
        base + wg * L::kQ, q + (static_cast<size_t>(b) * Sq * H + h) * D,
        static_cast<size_t>(H) * D, qr, Sq - qr, D, vec, tid % 128);
    load_kv(0);
  }
  cp_async_commit();

  // Masks are applied only on tiles that cross this warpgroup's diagonal,
  // window edge or kv_valid_len.
  const auto bites = [&](int t) {
    const int k0 = lo + t * kBK;
    return k0 + kBK > kv_end ||
           (mask_kind != kNone && k0 + kBK - 1 > wg_first) ||
           (mask_kind == kWindow && wg_last - k0 >= window);
  };

  float o[PV / 64][32];
#pragma unroll
  for (int mb = 0; mb < PV / 64; ++mb)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[mb][i] = 0.0f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.0f, 0.0f};

  for (int t = 0; t < n_tiles; ++t) {
    // tile t has landed, and every warpgroup is done with tile t - 1
    cp_async_wait<0>();
    __syncthreads();
    split_tile<L::kK, kNT>(sm + L::oKs, sm + L::oKh, sm + L::oKl, tid);
    split_tile<L::kV, kNT>(sm + L::oVs, sm + L::oVh, sm + L::oVl, tid);
    fence_proxy_async();
    __syncthreads();
    if (t + 1 < n_tiles) load_kv(t + 1);
    cp_async_commit();

    // S = Q K^T (64 x kBK)
    float s[kBK / 2];
    chain<kBK, PD / 8, 4, 3>(
        s,
        [&](int kk, uint32_t(&fh)[4], uint32_t(&fl)[4]) {
          frag_split(q_tile, 64, 0, 8 * kk, fh, fl);
        },
        base + L::oKh, base + L::oKl);
    float alpha[2];
    softmax_step<kBK>(s, m, l, alpha, scale_log2, bites(t), lo + t * kBK,
                      wg_first + r0, cq, kv_end, mask_kind, window);
    store_split<kBK>(s, p_hi, p_lo);
    if ((lane & 3) == 0) {
      rowf[r0] = alpha[0];
      rowf[r0 + 8] = alpha[1];
    }
    fence_proxy_async();
    warpgroup_sync(wg);

    // O^T (PV x 64) = alpha O^T + V^T P^T, one 64-row block of Dv at a
    // time, the tile's V^T P^T in a fresh accumulator
#pragma unroll
    for (int mb = 0; mb < PV / 64; ++mb) {
      float pv[32];
      chain<64, kBK / 8, 2, 3>(
          pv,
          [&](int kk, uint32_t(&fh)[4], uint32_t(&fl)[4]) {
            frag_t(sm + L::oVh, sm + L::oVl, kBK, 64 * mb, 8 * kk, fh, fl);
          },
          base + L::oP + wg * 2 * L::kP,
          base + L::oP + wg * 2 * L::kP + L::kP);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 a = *reinterpret_cast<const float2*>(rowf + 8 * j + cq);
        o[mb][4 * j] = fmaf(o[mb][4 * j], a.x, pv[4 * j]);
        o[mb][4 * j + 1] = fmaf(o[mb][4 * j + 1], a.y, pv[4 * j + 1]);
        o[mb][4 * j + 2] = fmaf(o[mb][4 * j + 2], a.x, pv[4 * j + 2]);
        o[mb][4 * j + 3] = fmaf(o[mb][4 * j + 3], a.y, pv[4 * j + 3]);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const int row0 = q0 + 64 * wg + r0;
  warpgroup_sync(wg);              // every thread has read the last factors
  if ((lane & 3) == 0) {
    rowf[r0] = 1.0f / fmaxf(l[0], 1e-20f);
    rowf[r0 + 8] = 1.0f / fmaxf(l[1], 1e-20f);
    if (lse != nullptr) {
      const float to_ln = scale_log2 * kLn2;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        if (row < Sq)
          lse[(static_cast<size_t>(b) * H + h) * Sq + row] =
              m[r] <= kNegInf / 2 ? kNegInf
                                  : m[r] * to_ln + logf(fmaxf(l[r], 1e-20f));
      }
    }
  }
  warpgroup_sync(wg);
  // O^T element (dv, query): dv = 64 mb + r0 (+ 8), query 8 j + cq (+ 1)
  float* ob = out + (static_cast<size_t>(b) * Sq * H + h) * Dv;
  const size_t stride = static_cast<size_t>(H) * Dv;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 inv = *reinterpret_cast<const float2*>(rowf + 8 * j + cq);
    const int row = q0 + 64 * wg + 8 * j + cq;
#pragma unroll
    for (int mb = 0; mb < PV / 64; ++mb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int dv = 64 * mb + r0 + 8 * (e >> 1);
        const int rr = row + (e & 1);
        if (dv < Dv && rr < Sq)
          ob[rr * stride + dv] = o[mb][4 * j + e] * ((e & 1) ? inv.y : inv.x);
      }
  }
}

// Shared memory of the key-split kernel, in bytes from a 1024-byte
// boundary: two stages of K and V, Q and P hi / lo, the partials.
template <int PD, int PV>
struct SplitSmem {
  static constexpr int kK = kSplitBK * PD * 4;
  static constexpr int kV = kSplitBK * PV * 4;
  static constexpr int kStage = kK + kV;
  static constexpr int kQ = kRows * PD * 4;
  static constexpr int kP = kRows * kSplitBK * 4;
  static constexpr int oQh = 2 * kStage;
  static constexpr int oQl = oQh + kQ;
  static constexpr int oPh = oQl + kQ;
  static constexpr int oPl = oPh + kP;
  static constexpr int oRed = oPl + kP;          // 4 warps x 8 columns
  static constexpr int oM = oRed + 4 * kRows * 4;
  static constexpr int oL = oM + kRows * 4;
  static constexpr int oO = oL + kRows * 4;      // O^T partial, 8 x PV
  static constexpr int kBytes = oO + kRows * PV * 4 + 1024;
  static_assert(kBytes <= 232448, "stages exceed shared memory");
};

__device__ __forceinline__ bool visible(int key, int qpos, int kv_end,
                                        int mask_kind, int window) {
  bool ok = key < kv_end;
  if (mask_kind != kNone) ok = ok && key <= qpos;
  if (mask_kind == kWindow) ok = ok && qpos - key < window;
  return ok;
}

template <int PD, int PV>
__global__ void __launch_bounds__(128, 1)
attn_fwd_split_tf32_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           float* __restrict__ out, float* __restrict__ lse,
                           int Sq, int Sk, int H, int KV, int D, int Dv,
                           float scale_log2, int mask_kind, int window,
                           int valid_len, int q_offset, int vec, int lo,
                           int n_tiles) {
  using L = SplitSmem<PD, PV>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  uint8_t* sm = smem_raw + (base - smem_u32(smem_raw));
  float* red = reinterpret_cast<float*>(sm + L::oRed);
  float* part_m = reinterpret_cast<float*>(sm + L::oM);
  float* part_l = reinterpret_cast<float*>(sm + L::oL);
  float* part_o = reinterpret_cast<float*>(sm + L::oO);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int split = blockIdx.x;
  const int splits = gridDim.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int grp = H / KV;
  const int n = Sq * grp;                 // stacked rows: j = i * grp + hh
  const int t0 = split * n_tiles / splits;
  const int t1 = (split + 1) * n_tiles / splits;
  const int kv_end = min(valid_len, Sk);
  const int cq = 2 * (lane % 4);

  const float* kb = k + (static_cast<size_t>(b) * Sk * KV + kvh) * D;
  const float* vb = v + (static_cast<size_t>(b) * Sk * KV + kvh) * Dv;
  const auto load_kv = [&](int t, int st) {
    const int k0 = lo + t * kSplitBK;
    load_f32_tile<PD, kSplitBK, 128>(base + st * L::kStage, kb,
                                     static_cast<size_t>(KV) * D, k0,
                                     kv_end - k0, D, vec, tid);
    load_f32_tile<PV, kSplitBK, 128>(base + st * L::kStage + L::kK, vb,
                                     static_cast<size_t>(KV) * Dv, k0,
                                     kv_end - k0, Dv, vec, tid);
  };
  if (t0 < t1) load_kv(t0, 0);
  cp_async_commit();
  if (t0 + 1 < t1) load_kv(t0 + 1, 1);
  cp_async_commit();

  // the group's query rows, split, as the B operand of S^T = K Q^T
  for (int e = tid; e < kRows * PD; e += 128) {
    const int j = e / PD;
    const int d = e % PD;
    float x = 0.0f;
    if (j < n && d < D)
      x = q[((static_cast<size_t>(b) * Sq + j / grp) * H + kvh * grp +
             j % grp) * D + d];
    uint32_t xh, xl;
    split_tf32(x, xh, xl);
    const uint32_t off = sw_off(kRows, j, d);
    *reinterpret_cast<uint32_t*>(sm + L::oQh + off) = xh;
    *reinterpret_cast<uint32_t*>(sm + L::oQl + off) = xl;
  }
  fence_proxy_async();

  float m[2] = {kNegInf, kNegInf};        // columns cq, cq + 1
  float lp[2] = {0.0f, 0.0f};             // this thread's part of l
  float o[PV / 64][4];
#pragma unroll
  for (int mb = 0; mb < PV / 64; ++mb)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[mb][i] = 0.0f;

  for (int t = t0; t < t1; ++t) {
    const int st = (t - t0) & 1;
    const uint8_t* k_tile = sm + st * L::kStage;
    const uint8_t* v_tile = k_tile + L::kK;
    cp_async_wait<1>();
    __syncthreads();

    // S^T (64 keys x 8 rows) = K Q^T
    float s[4];
    chain<kRows, PD / 8, 4, 3>(
        s,
        [&](int kk, uint32_t(&fh)[4], uint32_t(&fl)[4]) {
          frag_split(k_tile, kSplitBK, 0, 8 * kk, fh, fl);
        },
        base + L::oQh, base + L::oQl);
    const int key0 = lo + t * kSplitBK + 16 * warp + lane / 4;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = cq + (e & 1);
      if (!(j < n && visible(key0 + 8 * (e >> 1), j / grp + q_offset,
                             kv_end, mask_kind, window)))
        s[e] = kNegInf;
    }
    // the tile's max of each column: over the warp's keys, then the warps
    float mx[2] = {fmaxf(s[0], s[2]), fmaxf(s[1], s[3])};
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int off = 4; off < 32; off *= 2)
        mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], off));
    if (lane < 4) {
      red[warp * kRows + cq] = mx[0];
      red[warp * kRows + cq + 1] = mx[1];
    }
    __syncthreads();
    float alpha[2], nb[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float tm = red[cq + e];
#pragma unroll
      for (int w = 1; w < 4; ++w) tm = fmaxf(tm, red[w * kRows + cq + e]);
      const float mn = fmaxf(m[e], tm);
      const float safe = mn <= kNegInf / 2 ? 0.0f : mn;
      alpha[e] = m[e] <= kNegInf / 2 ? 0.0f : ex2((m[e] - safe) * scale_log2);
      nb[e] = -safe * scale_log2;
      m[e] = mn;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) s[e] = ex2(fmaf(s[e], scale_log2, nb[e & 1]));
    lp[0] = alpha[0] * lp[0] + s[0] + s[2];
    lp[1] = alpha[1] * lp[1] + s[1] + s[3];
    // P (rows x keys), split, as the B operand of O^T += V^T P^T
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      uint32_t ph, pl;
      split_tf32(s[e], ph, pl);
      const uint32_t off =
          sw_off(kRows, cq + (e & 1), 16 * warp + lane / 4 + 8 * (e >> 1));
      *reinterpret_cast<uint32_t*>(sm + L::oPh + off) = ph;
      *reinterpret_cast<uint32_t*>(sm + L::oPl + off) = pl;
    }
    fence_proxy_async();
    __syncthreads();
#pragma unroll
    for (int mb = 0; mb < PV / 64; ++mb) {
      float pv[4];
      chain<kRows, kSplitBK / 8, 4, 3>(
          pv,
          [&](int kk, uint32_t(&fh)[4], uint32_t(&fl)[4]) {
            frag_split_t(v_tile, kSplitBK, 64 * mb, 8 * kk, fh, fl);
          },
          base + L::oPh, base + L::oPl);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[mb][e] = fmaf(o[mb][e], alpha[e & 1], pv[e]);
    }
    __syncthreads();               // stage st and P are free again
    if (t + 2 < t1) load_kv(t + 2, st);
    cp_async_commit();
  }
  cp_async_wait<0>();

  // this block's partials: m and l of each row, O^T unnormalized
#pragma unroll
  for (int e = 0; e < 2; ++e)
#pragma unroll
    for (int off = 4; off < 32; off *= 2)
      lp[e] += __shfl_xor_sync(0xffffffffu, lp[e], off);
  __syncthreads();
  if (lane < 4) {
    red[warp * kRows + cq] = lp[0];
    red[warp * kRows + cq + 1] = lp[1];
  }
#pragma unroll
  for (int mb = 0; mb < PV / 64; ++mb)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      part_o[(cq + (e & 1)) * PV + 64 * mb + 16 * warp + lane / 4 +
             8 * (e >> 1)] = o[mb][e];
  __syncthreads();
  if (tid < 4) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float sum = 0.0f;
#pragma unroll
      for (int w = 0; w < 4; ++w) sum += red[w * kRows + cq + e];
      part_m[cq + e] = m[e];
      part_l[cq + e] = sum;
    }
  }

  // the cluster's blocks combine the partials, block `split` rows split,
  // split + splits, ...; every block in the order of its rank
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  for (int j = split; j < n; j += splits) {
    float mm = kNegInf;
    for (int s2 = 0; s2 < splits; ++s2)
      mm = fmaxf(mm, cluster.map_shared_rank(part_m, s2)[j]);
    const bool empty = mm <= kNegInf / 2;
    float ll = 0.0f;
    for (int s2 = 0; s2 < splits; ++s2) {
      const float ms = cluster.map_shared_rank(part_m, s2)[j];
      const float w = (empty || ms <= kNegInf / 2)
                          ? 0.0f : ex2((ms - mm) * scale_log2);
      ll += w * cluster.map_shared_rank(part_l, s2)[j];
    }
    const float inv = 1.0f / fmaxf(ll, 1e-20f);
    const int i = j / grp;
    const int h = kvh * grp + j % grp;
    for (int dv = tid; dv < Dv; dv += 128) {
      float acc = 0.0f;
      for (int s2 = 0; s2 < splits; ++s2) {
        const float ms = cluster.map_shared_rank(part_m, s2)[j];
        const float w = (empty || ms <= kNegInf / 2)
                            ? 0.0f : ex2((ms - mm) * scale_log2);
        acc += w * cluster.map_shared_rank(part_o, s2)[j * PV + dv];
      }
      out[((static_cast<size_t>(b) * Sq + i) * H + h) * Dv + dv] = acc * inv;
    }
    if (tid == 0 && lse != nullptr)
      lse[(static_cast<size_t>(b) * H + h) * Sq + i] =
          empty ? kNegInf
                : mm * scale_log2 * kLn2 + logf(fmaxf(ll, 1e-20f));
  }
  cluster.sync();                  // no block leaves while others read it
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
int launch_tile(const float* q, const float* k, const float* v, float* out,
                float* lse, int B, int Sq, int Sk, int H, int KV, int D,
                int Dv, float scale_log2, int mask_kind, int window,
                int valid_len, int q_offset, int vec, cudaStream_t stream) {
  constexpr int WG = (PD == 128) ? 2 : 1;
  constexpr int kSmem = TileSmem<PD, PV, WG>::kBytes;
  const cudaError_t e = cudaFuncSetAttribute(
      attn_fwd_tf32_kernel<PD, PV, WG>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(H, (Sq + 64 * WG - 1) / (64 * WG), B);
  attn_fwd_tf32_kernel<PD, PV, WG><<<grid, 128 * WG, kSmem, stream>>>(
      q, k, v, out, lse, Sq, Sk, H, KV, D, Dv, scale_log2, mask_kind, window,
      valid_len, q_offset, vec);
  return static_cast<int>(cudaGetLastError());
}

template <int PD, int PV>
int launch_split(const float* q, const float* k, const float* v, float* out,
                 float* lse, int B, int Sq, int Sk, int H, int KV, int D,
                 int Dv, float scale_log2, int mask_kind, int window,
                 int valid_len, int q_offset, int vec, cudaStream_t stream) {
  constexpr int kSmem = SplitSmem<PD, PV>::kBytes;
  cudaError_t e = cudaFuncSetAttribute(
      attn_fwd_split_tf32_kernel<PD, PV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  // the keys any query row may see: [lo, hi)
  const int kv_end = valid_len < Sk ? valid_len : Sk;
  int hi = kv_end;
  int lo = 0;
  if (mask_kind != kNone && Sq - 1 + q_offset + 1 < hi)
    hi = Sq - 1 + q_offset + 1;
  if (mask_kind == kWindow && q_offset - window + 1 > 0)
    lo = q_offset - window + 1;
  const int n_tiles = hi > lo ? (hi - lo + kSplitBK - 1) / kSplitBK : 0;
  const int pairs = B * KV;
  int splits = (kTargetBlocks + pairs - 1) / pairs;
  if (splits > kMaxSplits) splits = kMaxSplits;
  if (splits > n_tiles) splits = n_tiles;
  if (splits < 1) splits = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, KV, B);
  cfg.blockDim = dim3(128, 1, 1);
  cfg.dynamicSmemBytes = kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, attn_fwd_split_tf32_kernel<PD, PV>, q, k, v,
                         out, lse, Sq, Sk, H, KV, D, Dv, scale_log2,
                         mask_kind, window, valid_len, q_offset, vec, lo,
                         n_tiles);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <int PD>
__global__ void __launch_bounds__(128)
tf32_probe_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  float* __restrict__ c, int products) {
  constexpr int kT = 64 * PD * 4;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  uint8_t* sm = smem_raw + (base - smem_u32(smem_raw));
  const int tid = threadIdx.x;
  load_f32_tile<PD, 64, 128>(base, a, PD, 0, 64, PD, true, tid);
  load_f32_tile<PD, 64, 128>(base + kT, b, PD, 0, 64, PD, true, tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  split_tile<kT, 128>(sm + kT, sm + 2 * kT, sm + 3 * kT, tid);
  fence_proxy_async();
  __syncthreads();
  float d[32];
  const auto load = [&](int kk, uint32_t(&fh)[4], uint32_t(&fl)[4]) {
    frag_split(sm, 64, 0, 8 * kk, fh, fl);
  };
  if (products == 3)
    chain<64, PD / 8, 2, 3>(d, load, base + 2 * kT, base + 3 * kT);
  else
    chain<64, PD / 8, 2, 1>(d, load, base + 2 * kT, base + 3 * kT);
  const int r = 16 * (tid / 32) + (tid % 32) / 4;
  const int cq = 2 * (tid % 4);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      c[(r + 8 * (e >> 1)) * 64 + 8 * j + cq + (e & 1)] = d[4 * j + e];
}

}  // namespace

// Called by the entries of flash_attention.cu for float32 inputs, with
// their arguments checked there; D at most 192, Dv at most 128; lse (B, H,
// Sq) float32 or null.  One launch.
int flash_attention_tf32(const void* q, const void* k, const void* v,
                         void* out, float* lse, int B, int Sq, int Sk, int H,
                         int KV, int D, int Dv, int mask_kind, int window,
                         int valid_len, int q_offset, cudaStream_t stream) {
  if (D > 192 || Dv > 128) return static_cast<int>(cudaErrorInvalidValue);
  const int vec = D % 4 == 0 && Dv % 4 == 0 && aligned16(q) &&
                  aligned16(k) && aligned16(v);
  const float scale_log2 =
      static_cast<float>(1.4426950408889634 / sqrt(static_cast<double>(D)));
  const bool split = static_cast<long long>(Sq) * (H / KV) <= kRows;
  return dispatch(D, Dv, [&](auto pd, auto pv) {
    constexpr int PD = decltype(pd)::value, PV = decltype(pv)::value;
    const auto* qf = static_cast<const float*>(q);
    const auto* kf = static_cast<const float*>(k);
    const auto* vf = static_cast<const float*>(v);
    auto* of = static_cast<float*>(out);
    return split ? launch_split<PD, PV>(qf, kf, vf, of, lse, B, Sq, Sk, H, KV,
                                        D, Dv, scale_log2, mask_kind, window,
                                        valid_len, q_offset, vec, stream)
                 : launch_tile<PD, PV>(qf, kf, vf, of, lse, B, Sq, Sk, H, KV,
                                       D, Dv, scale_log2, mask_kind, window,
                                       valid_len, q_offset, vec, stream);
  });
}

// The accuracy probe of the tile kernels' products: c (64 x 64) = a (64 x
// D) b (64 x D)^T, one warpgroup, a's fragments split in registers and b's
// hi / lo tiles in shared memory, as S = Q K^T runs; products = 3 is
// 3xTF32, 1 one TF32 product of the hi parts.  D 64, 128 or 192; all
// row-major float32, 16-byte aligned.  Returns a cudaError_t code.
extern "C" int flash_attention_tf32_probe(const void* a, const void* b,
                                          void* c, int D, int products,
                                          void* stream) {
  if ((D != 64 && D != 128 && D != 192) || (products != 1 && products != 3))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto run = [&](auto pd) {
    constexpr int PD = decltype(pd)::value;
    constexpr int kSmem = 4 * 64 * PD * 4 + 1024;
    cudaError_t e = cudaFuncSetAttribute(
        tf32_probe_kernel<PD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    tf32_probe_kernel<PD><<<1, 128, kSmem, s>>>(
        static_cast<const float*>(a), static_cast<const float*>(b),
        static_cast<float*>(c), products);
    return static_cast<int>(cudaGetLastError());
  };
  if (D == 64) return run(std::integral_constant<int, 64>{});
  if (D == 128) return run(std::integral_constant<int, 128>{});
  return run(std::integral_constant<int, 192>{});
}
