// Flash-attention forward for bfloat16 on Hopper tensor cores (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/flash_attention.py
// (flash_attention_pallas / _attn_kernel) for bfloat16 inputs; float32 runs
// the 3xTF32 tensor-core kernels of flash_attention_tf32.cu (one TF32
// product would miss the 2e-5 float32 tolerance).  For q (B, Sq, H, D) and
// k/v (B, Sk, KV, D | Dv), row-major bf16, it writes out (B, Sq, H, Dv) in
// bf16: online-softmax attention with float32 running max, sum and
// accumulator; query head h reads KV head h / (H / KV) (GQA, K/V never
// repeated in memory); masks "causal" (k <= q), "window" (k <= q and
// q - k < window) or "none", plus k < kv_valid_len, with the queries at
// absolute positions q_offset + i.  D and Dv must be multiples of 8 (rows
// of 16-byte chunks); D at most 192 (MLA's 128 + 64 rope dims), Dv at most
// 128.
//
// What bounds it on the H100: 4 D operations per visible (q, k) pair per
// (b, h) at 989 TFLOP/s against q, k, v read once and out written once at
// 3.35 TB/s.  At the Hymba prefill shape (q (4, 1152, 25, 64), k/v (4, 1152,
// 5, 64), window 1024: 655,872 visible pairs per head) that is 1.68e10
// operations, 16.98 us, against 35 MB, 10.6 us: bound by operations.  The
// softmax adds one exponential per visible pair, 4 * 25 * 655,872 = 65.6 M,
// about 18 us through the SFUs at 16 per clock per SM, so the exponentials
// cost as much as the products and have to overlap with them.
//
// Design.  One block owns (b, h, 128 queries): two warpgroups of 64 query
// rows each, 256 threads.  Both products run on wgmma with float32
// accumulators.  The block's Q tile is staged once in shared memory; for
// every KV tile of 64 keys, S = Q K^T is wgmma m64n64k16 with Q and K both
// read from shared memory (K's rows, keys x D, are already the K-major B
// operand), and O += P V is wgmma m64n{64|128}k16 with P taken from S's
// accumulator registers, rounded to bf16, as the register A operand, and V
// (keys x Dv, row-major) the B operand read with the transpose bit.  Tiles
// sit in shared memory under the 128-byte swizzle that wgmma's descriptors
// name: 128-byte rows, 16-byte chunk c of row r stored at chunk c ^ (r % 8),
// 64-element column blocks one after another; head dims are zero-filled up
// to a class (PD, PV) in {(64, 64), (128, 128), (192, 128)}: PD pads D for
// Q and K, PV pads Dv for V and O, so D = 8 or 16 and D != Dv run on the
// same instantiations.  At PD = 192 (MLA: D = 192, Dv = 128) S is 12 k16
// steps over three swizzled 64-column blocks of Q and K, O stays m64n128,
// and shared memory holds Q (48 KB), four K stages (96 KB) and four V
// stages (64 KB), 209 KB with the alignment slack: one block an SM, as
// at (128, 128).  K/V tiles arrive through a ring of
// four stages filled with 16-byte cp.async copies: a tensor map cannot
// describe every (B, Sk, KV, D) stride and zero-fill rule used here, and
// cp.async writes the same swizzled layout, zero-filling keys past
// kv_valid_len (or Sk) and the padded columns, so a ragged edge or a cache
// full of garbage past kv_valid_len never reaches the products.  Tiles
// t + 1 and t + 2 are in flight while tile t is consumed; the copies are
// fenced into the async proxy (fence.proxy.async) before the one block
// barrier per tile that hands a tile to wgmma.
//
// Overlap.  Within a warpgroup, iteration t issues S of tile t and P V of
// tile t - 1 together, waits for S alone, and runs tile t's softmax while
// P V is still on the tensor cores (FlashAttention-3's intra-warpgroup
// pipelining); O is rescaled once P V has landed.  Every wgmma is issued
// by the whole warpgroup on every tile with no branch around it — under a
// per-warpgroup branch ptxas serializes them all (its warning C7520) — so
// a tile a warpgroup cannot see is computed and masked to nothing.  At
// (64, 64) two blocks fit an SM (<= 128 registers a thread, 81 KB of
// shared memory), so four warpgroups share its tensor cores and SFUs.
//
// Softmax.  Each thread holds two query rows' scores in the accumulator
// layout (rows 16 w + lane / 4 and + 8, two adjacent columns of each
// 8-wide block); a row's max and sum come from shuffles within its quad.
// The 1/sqrt(D) scale multiplies S in float32 after the product, folded
// with log2(e) into one FMA before ex2.approx: at D = 64 the scale 1/8 is
// exact, so only the log2(e) factor rounds; at other D the scaled scores
// differ from the reference's (q / sqrt(D)) . k by float32 rounding of the
// scale (relative ~6e-8), far below the bf16 rounding of P.  P is rounded
// to bf16 for the second product, while the row sum l adds the float32
// values; the bf16 P costs about one bf16 rounding of the output, inside
// the serving gate (atol 4e-3, rtol 8e-3; ref.flash_attention_tc_mirror
// repeats this arithmetic on the CPU).  The TPU kernel's guards for fully
// masked rows stay: safe_m = 0 while m is still -inf, alpha = 0,
// l >= 1e-20, so such a row writes 0.
//
// Masks only where they bite.  KV tiles wholly outside every query's
// visible range are never loaded (exact: a masked key adds nothing); a
// warpgroup compares positions only on tiles that cross its diagonal, its
// window's edge or kv_valid_len.  No atomics: the result does not depend
// on scheduling.
// With a non-null lse the epilogue also writes each row's log-sum-exp of
// its scaled scores, m c ln 2 + log(l) with m the raw row max (float32,
// (B, H, Sq); -FLT_MAX for a fully masked row), for the backward
// (flash_attention_bwd.cu); with lse null nothing else changes.
// The wgmma wrappers, descriptors, swizzle and copies are in
// wgmma_common.cuh, shared with the backward (flash_attention_bwd_wgmma.cu).
// The kernel launches on the caller's stream; the entry returns
// cudaGetLastError().

#include "wgmma_common.cuh"

namespace {

constexpr int kWarpgroups = 2;              // 64 query rows each
constexpr int kBQ = 64 * kWarpgroups;       // queries per block
constexpr int kThreads = 128 * kWarpgroups;
constexpr int kBK = 64;                     // keys per K/V tile
constexpr int kStages = 4;                  // K/V ring depth
constexpr float kNegInf = -3.4028234663852886e38f;   // finfo(float32).min

enum MaskKind { kCausal = 0, kWindow = 1, kNone = 2 };

// S = Q K^T for one warpgroup's 64 rows and one K tile, issued (async):
// PD / 16 steps of 16 along the head dim, four to a 64-column block.  Its
// wgmma.fence orders every register write before it (s here, O and P by
// the caller) before the products that read those registers.
template <int PD>
__device__ __forceinline__ void issue_qk(float (&s)[kBK / 2], uint32_t q_rows,
                                         uint32_t k_tile) {
#pragma unroll
  for (int i = 0; i < kBK / 2; ++i) s[i] = 0.0f;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < PD / 16; ++kk) {
    const uint32_t qa = q_rows + (kk / 4) * (kBQ * 128) + (kk % 4) * 32;
    const uint32_t ka = k_tile + (kk / 4) * (kBK * 128) + (kk % 4) * 32;
    wgmma_ss<kBK>(s, smem_desc(qa, 16, 1024), smem_desc(ka, 16, 1024),
                  kk > 0);
  }
  wgmma_commit();
}

// O += P V for one V tile, issued (async): kBK / 16 steps of 16 keys.
template <int PV>
__device__ __forceinline__ void issue_pv(float (&o)[PV / 2],
                                         const uint32_t (&a)[kBK / 16][4],
                                         uint32_t v_tile) {
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk)
    wgmma_rs<PV>(o, a[kk], smem_desc(v_tile + kk * 16 * 128, kBK * 128, 1024));
  wgmma_commit();
}

// One online-softmax step on a tile of scores in the accumulator layout
// (this thread: rows pos and pos + 8, columns 8 j + cq and + 1): masks the
// tile if `bite`, updates the rows' running max m and sum l, and turns s
// into P = exp2(S c - m c) in float32.  alpha is the factor for what was
// accumulated under the old max.
__device__ __forceinline__ void softmax_step(float (&s)[kBK / 2],
                                             float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], float c,
                                             bool bite, int k0, int pos,
                                             int cq, int kv_end,
                                             int mask_kind, int window) {
  if (bite) {
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) {
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
  for (int i = 0; i < kBK / 2; ++i)
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
  for (int i = 0; i < kBK / 2; ++i) {
    s[i] = ex2(fmaf(s[i], c, nb[(i >> 1) & 1]));
    ps[(i >> 1) & 1] += s[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = alpha[r] * l[r] + ps[r];
}

template <int PD, int PV>
__global__ void __launch_bounds__(kThreads, PD <= 64 && PV <= 64 ? 2 : 1)
attn_fwd_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ out,
                      float* __restrict__ lse, int Sq, int Sk, int H, int KV,
                      int D, int Dv, float scale_log2, int mask_kind,
                      int window, int valid_len, int q_offset) {
  constexpr int kQBytes = (PD / 64) * kBQ * 128;
  constexpr int kKBytes = (PD / 64) * kBK * 128;
  constexpr int kVBytes = (PV / 64) * kBK * 128;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t s_q =
      (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023) &
      ~1023u;                     // the swizzle repeats every 1024 bytes

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
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

  // this warpgroup's positions; this thread's first row and column
  const int wg_first = first_q + 64 * wg;
  const int wg_last = wg_first + 63;
  const int r0 = 16 * warp + lane / 4;
  const int cq = 2 * (lane % 4);
  const uint32_t q_rows = s_q + wg * (64 * 128);

  const bf16* qb = q + (static_cast<size_t>(b) * Sq * H + h) * D;
  const bf16* kb = k + (static_cast<size_t>(b) * Sk * KV + kvh) * D;
  const bf16* vb = v + (static_cast<size_t>(b) * Sk * KV + kvh) * Dv;
  const auto stage = [&](int t) {
    return s_q + kQBytes + (t % kStages) * (kKBytes + kVBytes);
  };
  // K/V tile t into its ring stage: one cp.async group per tile
  const auto load_kv = [&](int t) {
    const int k0 = lo + t * kBK;
    load_tile<PD, kBK, kThreads>(stage(t), kb, static_cast<size_t>(KV) * D,
                                 k0, kv_end - k0, D, tid);
    load_tile<PV, kBK, kThreads>(stage(t) + kKBytes, vb,
                                 static_cast<size_t>(KV) * Dv, k0,
                                 kv_end - k0, Dv, tid);
  };

  float o[PV / 2];
#pragma unroll
  for (int i = 0; i < PV / 2; ++i) o[i] = 0.0f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.0f, 0.0f};

  if (n_tiles > 0) {
    load_tile<PD, kBQ, kThreads>(s_q, qb, static_cast<size_t>(H) * D, q0,
                                 Sq - q0, D, tid);
    load_kv(0);
    cp_async_commit();
    for (int t = 1; t < kStages - 2; ++t) {
      if (t < n_tiles) load_kv(t);
      cp_async_commit();
    }
  }
  // Waits for tile t, hands it to every warpgroup and refills the stage of
  // tile t - 2: one barrier per tile, after which every warpgroup is done
  // with tile t - 2 (tile t - 1's V is still read by iteration t).
  const auto next_tile = [&](int t) {
    cp_async_wait<kStages - 3>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (t + kStages - 2 < n_tiles) load_kv(t + kStages - 2);
    cp_async_commit();
  };
  // Masks are applied only on tiles that cross this warpgroup's diagonal,
  // window edge or kv_valid_len; a tile the warpgroup cannot see at all
  // is one of them, so it adds nothing.
  const auto bites = [&](int t) {
    const int k0 = lo + t * kBK;
    return k0 + kBK > kv_end ||
           (mask_kind != kNone && k0 + kBK - 1 > wg_first) ||
           (mask_kind == kWindow && wg_last - k0 >= window);
  };

  // Every wgmma below is issued by the whole warpgroup on every tile, with
  // no branch around it: a wgmma under a per-warpgroup branch makes ptxas
  // serialize all of them.  Tile 0: S, softmax, P.
  float s[kBK / 2];
  uint32_t a[kBK / 16][4];       // P of the last tile, not yet in O
  float alpha[2];
  if (n_tiles > 0) {
    next_tile(0);
    issue_qk<PD>(s, q_rows, stage(0));
    wgmma_wait<0>();
    fence_regs<kBK / 2>(s);
    softmax_step(s, m, l, alpha, scale_log2, bites(0), lo, wg_first + r0,
                 cq, kv_end, mask_kind, window);
    pack_frags<kBK>(s, a);
  }
  // Tile t: S of tile t and P V of tile t - 1 on the tensor cores, then
  // tile t's softmax while P V still runs.
  for (int t = 1; t < n_tiles; ++t) {
    next_tile(t);
    issue_qk<PD>(s, q_rows, stage(t));
    issue_pv<PV>(o, a, stage(t - 1) + kKBytes);
    wgmma_wait<1>();
    fence_regs<kBK / 2>(s);
    softmax_step(s, m, l, alpha, scale_log2, bites(t), lo + t * kBK,
                 wg_first + r0, cq, kv_end, mask_kind, window);
    wgmma_wait<0>();
    fence_regs<PV / 2>(o);
    fence_frags<kBK / 16>(a);
#pragma unroll
    for (int i = 0; i < PV / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
    pack_frags<kBK>(s, a);
  }
  if (n_tiles > 0) {
    wgmma_fence();
    issue_pv<PV>(o, a, stage(n_tiles - 1) + kKBytes);
    wgmma_wait<0>();
    fence_regs<PV / 2>(o);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const float inv0 = 1.0f / fmaxf(l[0], 1e-20f);
  const float inv1 = 1.0f / fmaxf(l[1], 1e-20f);
  const int row0 = q0 + 64 * wg + r0;
  const int row1 = row0 + 8;
  if (lse != nullptr && (lane & 3) == 0) {
    // m and l are the same on the four lanes of a row's quad
    const float to_ln = scale_log2 * 0.6931471805599453f;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r == 0 ? row0 : row1;
      if (row < Sq)
        lse[(static_cast<size_t>(b) * H + h) * Sq + row] =
            m[r] <= kNegInf / 2 ? kNegInf
                                : m[r] * to_ln + logf(fmaxf(l[r], 1e-20f));
    }
  }
  bf16* ob = out + (static_cast<size_t>(b) * Sq * H + h) * Dv;
  const size_t stride = static_cast<size_t>(H) * Dv;
#pragma unroll
  for (int j = 0; j < PV / 8; ++j) {
    const int col = 8 * j + cq;
    if (col < Dv) {
      if (row0 < Sq)
        *reinterpret_cast<__nv_bfloat162*>(ob + row0 * stride + col) =
            __floats2bfloat162_rn(o[4 * j] * inv0, o[4 * j + 1] * inv0);
      if (row1 < Sq)
        *reinterpret_cast<__nv_bfloat162*>(ob + row1 * stride + col) =
            __floats2bfloat162_rn(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
    }
  }
}

template <int PD, int PV>
int launch(const void* q, const void* k, const void* v, void* out,
           float* lse, int B, int Sq, int Sk, int H, int KV, int D, int Dv,
           int mask_kind, int window, int valid_len, int q_offset,
           cudaStream_t stream) {
  // Q tile and the K/V stages, plus slack to align to 1024 bytes
  constexpr int kSmem =
      1024 + 128 * ((PD / 64) * kBQ + kStages * kBK * (PD / 64 + PV / 64));
  static_assert(kSmem <= 232448, "Q tile and K/V ring exceed shared memory");
  const cudaError_t e = cudaFuncSetAttribute(
      attn_fwd_wgmma_kernel<PD, PV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  const double log2e = 1.4426950408889634;
  attn_fwd_wgmma_kernel<PD, PV><<<grid, kThreads, kSmem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), lse, Sq, Sk, H,
      KV, D, Dv, static_cast<float>(log2e / sqrt(static_cast<double>(D))), mask_kind,
      window, valid_len, q_offset);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Called by the entries of flash_attention.cu for bf16 inputs, with their
// arguments checked there; D and Dv multiples of 8, D at most 192, Dv at
// most 128; lse (B, H, Sq) float32 or null.
int flash_attention_wgmma(const void* q, const void* k, const void* v,
                          void* out, float* lse, int B, int Sq, int Sk,
                          int H, int KV, int D, int Dv, int mask_kind,
                          int window, int valid_len, int q_offset,
                          cudaStream_t stream) {
  if (D % 8 != 0 || Dv % 8 != 0 || D > 192 || Dv > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  if (D <= 64 && Dv <= 64)
    return launch<64, 64>(q, k, v, out, lse, B, Sq, Sk, H, KV, D, Dv,
                          mask_kind, window, valid_len, q_offset, stream);
  if (D <= 128)
    return launch<128, 128>(q, k, v, out, lse, B, Sq, Sk, H, KV, D, Dv,
                            mask_kind, window, valid_len, q_offset, stream);
  return launch<192, 128>(q, k, v, out, lse, B, Sq, Sk, H, KV, D, Dv,
                          mask_kind, window, valid_len, q_offset, stream);
}
