// Flash-attention forward for bfloat16 on Hopper tensor cores (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/flash_attention.py
// (flash_attention_pallas / _attn_kernel) for bfloat16 inputs; float32 keeps
// the SIMT kernel of flash_attention.cu, since on tensor cores float32 would
// run as TF32 and miss the 2e-5 float32 tolerance.  For q (B, Sq, H, D) and
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
// The kernel launches on the caller's stream; the entry returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarpgroups = 2;              // 64 query rows each
constexpr int kBQ = 64 * kWarpgroups;       // queries per block
constexpr int kThreads = 128 * kWarpgroups;
constexpr int kBK = 64;                     // keys per K/V tile
constexpr int kStages = 4;                  // K/V ring depth
constexpr float kNegInf = -3.4028234663852886e38f;   // finfo(float32).min

enum MaskKind { kCausal = 0, kWindow = 1, kNone = 2 };

// d (64 x 64, f32) = [d if scale_d] + A (64 x 16, shared) * B (64 x 16,
// shared)^T, both K-major under the 128-byte swizzle.
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t desc_a,
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (64 x 128, f32) = [d if scale_d] + A (64 x 16, shared) * B (128 x 16,
// shared)^T, both K-major under the 128-byte swizzle.
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t desc_a,
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (64 x 64, f32) += A (64 x 16, bf16 in registers) * B (16 x 64,
// shared, N-major under the 128-byte swizzle: the transpose bit is set).
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d (64 x 128, f32) += A (64 x 16, bf16 in registers) * B (16 x 128,
// shared, N-major under the 128-byte swizzle: the transpose bit is set).
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a,
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads of accumulator registers above the
// wgmma wait: the asynchronous product writes them behind its back.
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t a, uint64_t b,
                                         int scale_d) {
  if constexpr (N == 64) wgmma_ss_n64(d, a, b, scale_d);
  else wgmma_ss_n128(d, a, b, scale_d);
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t b) {
  if constexpr (N == 64) wgmma_rs_n64(d, a, b);
  else wgmma_rs_n128(d, a, b);
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// Byte offset of 16-byte chunk c of row r in a swizzled tile of `rows` rows.
__device__ __forceinline__ uint32_t swizzled(int rows, int r, int c) {
  return (c >> 3) * rows * 128 + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// 16-byte global -> shared copy; zero-fills the chunk when !valid.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [first, first + ROWS) of a bf16 array with `stride` elements between
// rows, `width` elements each, into a swizzled tile; rows at or past
// `n_valid` and columns at or past `width` (up to P) are zero-filled.  P is
// the padded width of the array: PD for Q and K, PV for V.
template <int P, int ROWS>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* base,
                                          size_t stride, int first,
                                          int n_valid, int width, int tid) {
  constexpr int kChunks = P / 8;
  static_assert(ROWS * kChunks % kThreads == 0, "whole chunks per thread");
#pragma unroll
  for (int i = 0; i < ROWS * kChunks / kThreads; ++i) {
    const int e = tid + i * kThreads;
    const int r = e / kChunks;
    const int c = e % kChunks;
    const bool ok = r < n_valid && c * 8 < width;
    const bf16* src =
        ok ? base + static_cast<size_t>(first + r) * stride + c * 8 : base;
    cp_async16(dst + swizzled(ROWS, r, c), src, ok);
  }
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

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

// P as bf16 A fragments: keys 16 kk .. 16 kk + 15 are the 8-blocks 2 kk and
// 2 kk + 1 of the accumulator layout.
__device__ __forceinline__ void pack_p(const float (&s)[kBK / 2],
                                       uint32_t (&a)[kBK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      a[kk][j] = pack_bf16(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1]);
}

template <int N>
__device__ __forceinline__ void fence_frags(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
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
    load_tile<PD, kBK>(stage(t), kb, static_cast<size_t>(KV) * D, k0,
                       kv_end - k0, D, tid);
    load_tile<PV, kBK>(stage(t) + kKBytes, vb, static_cast<size_t>(KV) * Dv,
                       k0, kv_end - k0, Dv, tid);
  };

  float o[PV / 2];
#pragma unroll
  for (int i = 0; i < PV / 2; ++i) o[i] = 0.0f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.0f, 0.0f};

  if (n_tiles > 0) {
    load_tile<PD, kBQ>(s_q, qb, static_cast<size_t>(H) * D, q0, Sq - q0, D,
                      tid);
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
    pack_p(s, a);
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
    pack_p(s, a);
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
