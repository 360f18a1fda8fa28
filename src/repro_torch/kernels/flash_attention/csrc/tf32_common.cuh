// Building blocks of the float32 attention kernels on Hopper tensor cores
// (flash_attention_tf32.cu, the forward, and flash_attention_bwd_tf32.cu,
// the backward): wgmma with TF32 operands, the split of a float32 value
// into a TF32 high part and a TF32 low part, float32 tiles under the
// 128-byte swizzle, and the A fragments the products take from registers.
//
// 3xTF32.  A float32 x is written as hi + lo: hi is x rounded to the
// nearest TF32 (10 of float32's 23 mantissa bits, the 13 low bits zero;
// ties away from zero, as cvt.rna.tf32.f32), lo is x - hi (exact in
// float32) rounded the same way,
// so |x - hi - lo| <= 2^-22 |x|.  A product a b is then a_lo b_hi + a_hi
// b_lo + a_hi b_hi, three wgmma products summed in one float32
// accumulator, small terms first; the dropped a_lo b_lo is below 2^-22
// |a b|.  One TF32 product alone is off by up to 2^-11 |a b| a term, which
// misses the 2e-5 float32 tolerance of attention; three products meet it
// (ref.split_tf32 and ref.matmul_tf32x3 repeat the arithmetic on the CPU).
// The tensor cores' float32 sums lose a little on every step that adds to
// a large accumulator, and the loss does not average out over thousands of
// steps; so a long sum (over the keys of a row, or over the queries of a
// key) runs a tile at a time in a fresh accumulator, added to the running
// one with an ordinary float32 add.
//
// wgmma takes TF32 operands K-major only: the transpose bits that the
// bf16 kernels use (wgmma_common.cuh) exist for 16-bit types alone.  So B,
// read from shared memory, is always a tile whose rows are N and whose
// columns (the sum's index) are contiguous, and every product whose other
// factor is laid out the other way takes that factor as A, from registers:
// an A fragment is loaded element by element from a tile in either
// orientation (frag_split, frag_split_t, frag_t).
//
// Tiles: `rows` rows of P floats (P a multiple of 32), stored as P / 32
// column blocks one after another, each `rows` x 128 bytes, 16-byte chunk
// c of row r at chunk c ^ (r % 8): the 128-byte swizzle of
// wgmma_common.cuh, 32 floats a row.  A tile starts on a 1024-byte
// boundary.  Element (r, col) is at sw_off(rows, r, col).
//
// A fragment of m64k8 (TF32; this thread, warp w of the warpgroup, lane l,
// g = l / 4, c = l % 4): a[0] = (16 w + g, c), a[1] = (16 w + g + 8, c),
// a[2] = (16 w + g, c + 4), a[3] = (16 w + g + 8, c + 4).  The accumulator
// of m64nN is the bf16 kernels' (wgmma_common.cuh): d[4 j + e] at row
// 16 w + g + 8 (e / 2), column 8 j + 2 c + e % 2.

#pragma once

#include "wgmma_common.cuh"

namespace {

// d (64 x 8, f32) = [d if scale_d] + A (64 x 8, tf32 in registers) * B
// (8 x 8, tf32 in shared memory, K-major under the 128-byte swizzle)^T.
__device__ __forceinline__ void wgmma_tf32_n8(float* d, const uint32_t* a,
                                                uint64_t desc_b,
                                                int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3"
      "}, {%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

// d (64 x 32, f32) = [d if scale_d] + A (64 x 8, tf32 in registers) * B
// (32 x 8, tf32 in shared memory, K-major under the 128-byte swizzle)^T.
__device__ __forceinline__ void wgmma_tf32_n32(float* d, const uint32_t* a,
                                                uint64_t desc_b,
                                                int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

// d (64 x 64, f32) = [d if scale_d] + A (64 x 8, tf32 in registers) * B
// (64 x 8, tf32 in shared memory, K-major under the 128-byte swizzle)^T.
__device__ __forceinline__ void wgmma_tf32_n64(float* d, const uint32_t* a,
                                                uint64_t desc_b,
                                                int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}


template <int N>
__device__ __forceinline__ void wgmma_tf32(float* d, const uint32_t* a,
                                           uint64_t desc_b, int scale_d) {
  static_assert(N == 8 || N == 32 || N == 64, "wgmma_tf32: N 8, 32, 64");
  if constexpr (N == 8) wgmma_tf32_n8(d, a, desc_b, scale_d);
  else if constexpr (N == 32) wgmma_tf32_n32(d, a, desc_b, scale_d);
  else wgmma_tf32_n64(d, a, desc_b, scale_d);
}

// x rounded to the nearest TF32, ties away from zero: cvt.rna.tf32.f32 for
// finite x, in two integer operations (adding half a TF32 unit to the
// magnitude bits, then clearing the 13 low bits).
__device__ __forceinline__ uint32_t rna_tf32(uint32_t bits) {
  return (bits + 0x1000u) & 0xffffe000u;
}

// x = hi + lo as above, both as TF32 bit patterns; x finite.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = rna_tf32(__float_as_uint(x));
  lo = rna_tf32(__float_as_uint(x - __uint_as_float(hi)));
}

// Byte offset of float (r, col) in a swizzled tile of `rows` rows.
__device__ __forceinline__ uint32_t sw_off(int rows, int r, int col) {
  return swizzled(rows, r, col >> 2) + ((col & 3) << 2);
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Barrier of one warpgroup's 128 threads (named barrier 1 + wg).
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// 4-byte global -> shared copy; zero-fills when !valid.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// Rows [first, first + ROWS) of a float32 array with `stride` floats
// between rows, `width` floats each, into a swizzled tile of ROWS x P by NT
// threads (cp.async, one group's worth: the caller commits); rows at or
// past n_valid and columns at or past width are zero-filled.  16-byte
// copies when `vec` (width, stride and base a multiple of 4 floats, base
// 16-byte aligned), else 4-byte copies: any head dim and any alignment.
template <int P, int ROWS, int NT>
__device__ __forceinline__ void load_f32_tile(uint32_t dst, const float* base,
                                              size_t stride, int first,
                                              int n_valid, int width,
                                              bool vec, int tid) {
  if (vec) {
    constexpr int kChunks = P / 4;
#pragma unroll 4
    for (int e = tid; e < ROWS * kChunks; e += NT) {
      const int r = e / kChunks;
      const int c = e % kChunks;
      const bool ok = r < n_valid && c * 4 < width;
      const float* src =
          ok ? base + static_cast<size_t>(first + r) * stride + c * 4 : base;
      cp_async16(dst + swizzled(ROWS, r, c), src, ok);
    }
  } else {
#pragma unroll 4
    for (int e = tid; e < ROWS * P; e += NT) {
      const int r = e / P;
      const int col = e % P;
      const bool ok = r < n_valid && col < width;
      const float* src =
          ok ? base + static_cast<size_t>(first + r) * stride + col : base;
      cp_async4(dst + sw_off(ROWS, r, col), src, ok);
    }
  }
}

// A tile of BYTES bytes at src split into its hi tile and its lo tile (same
// layout, same offsets), 16 bytes a thread at a time, by NT threads.
template <int BYTES, int NT>
__device__ __forceinline__ void split_tile(const uint8_t* src, uint8_t* hi,
                                           uint8_t* lo, int tid) {
  static_assert(BYTES % (16 * NT) == 0, "whole chunks per thread");
#pragma unroll 4
  for (int off = tid * 16; off < BYTES; off += NT * 16) {
    const float4 x = *reinterpret_cast<const float4*>(src + off);
    uint4 h, l;
    split_tf32(x.x, h.x, l.x);
    split_tf32(x.y, h.y, l.y);
    split_tf32(x.z, h.z, l.z);
    split_tf32(x.w, h.w, l.w);
    *reinterpret_cast<uint4*>(hi + off) = h;
    *reinterpret_cast<uint4*>(lo + off) = l;
  }
}

__device__ __forceinline__ float tile_f(const uint8_t* tile, int rows, int r,
                                        int col) {
  return *reinterpret_cast<const float*>(tile + sw_off(rows, r, col));
}
__device__ __forceinline__ uint32_t tile_u(const uint8_t* tile, int rows,
                                           int r, int col) {
  return *reinterpret_cast<const uint32_t*>(tile + sw_off(rows, r, col));
}

// The A fragment (rows m0.., columns k0..) of A = T, T a float32 tile of
// `rows` rows, split into hi and lo.
__device__ __forceinline__ void frag_split(const uint8_t* tile, int rows,
                                           int m0, int k0, uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
  const int r = m0 + 16 * ((threadIdx.x % 128) / 32) + (threadIdx.x % 32) / 4;
  const int c = k0 + threadIdx.x % 4;
  split_tf32(tile_f(tile, rows, r, c), hi[0], lo[0]);
  split_tf32(tile_f(tile, rows, r + 8, c), hi[1], lo[1]);
  split_tf32(tile_f(tile, rows, r, c + 4), hi[2], lo[2]);
  split_tf32(tile_f(tile, rows, r + 8, c + 4), hi[3], lo[3]);
}

// The A fragment of A = T^T (A[m][k] = T[k][m]), T a float32 tile of `rows`
// rows, split into hi and lo.
__device__ __forceinline__ void frag_split_t(const uint8_t* tile, int rows,
                                             int m0, int k0,
                                             uint32_t (&hi)[4],
                                             uint32_t (&lo)[4]) {
  const int m = m0 + 16 * ((threadIdx.x % 128) / 32) + (threadIdx.x % 32) / 4;
  const int c = k0 + threadIdx.x % 4;
  split_tf32(tile_f(tile, rows, c, m), hi[0], lo[0]);
  split_tf32(tile_f(tile, rows, c, m + 8), hi[1], lo[1]);
  split_tf32(tile_f(tile, rows, c + 4, m), hi[2], lo[2]);
  split_tf32(tile_f(tile, rows, c + 4, m + 8), hi[3], lo[3]);
}

// The A fragment of A = T from T's hi and lo tiles (already split).
__device__ __forceinline__ void frag_hl(const uint8_t* thi, const uint8_t* tlo,
                                        int rows, int m0, int k0,
                                        uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const int r = m0 + 16 * ((threadIdx.x % 128) / 32) + (threadIdx.x % 32) / 4;
  const int c = k0 + threadIdx.x % 4;
  hi[0] = tile_u(thi, rows, r, c);
  lo[0] = tile_u(tlo, rows, r, c);
  hi[1] = tile_u(thi, rows, r + 8, c);
  lo[1] = tile_u(tlo, rows, r + 8, c);
  hi[2] = tile_u(thi, rows, r, c + 4);
  lo[2] = tile_u(tlo, rows, r, c + 4);
  hi[3] = tile_u(thi, rows, r + 8, c + 4);
  lo[3] = tile_u(tlo, rows, r + 8, c + 4);
}

// The A fragment of A = T^T from T's hi and lo tiles (already split).
__device__ __forceinline__ void frag_t(const uint8_t* thi, const uint8_t* tlo,
                                       int rows, int m0, int k0,
                                       uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const int m = m0 + 16 * ((threadIdx.x % 128) / 32) + (threadIdx.x % 32) / 4;
  const int c = k0 + threadIdx.x % 4;
  hi[0] = tile_u(thi, rows, c, m);
  lo[0] = tile_u(tlo, rows, c, m);
  hi[1] = tile_u(thi, rows, c, m + 8);
  lo[1] = tile_u(tlo, rows, c, m + 8);
  hi[2] = tile_u(thi, rows, c + 4, m);
  lo[2] = tile_u(tlo, rows, c + 4, m);
  hi[3] = tile_u(thi, rows, c + 4, m + 8);
  lo[3] = tile_u(tlo, rows, c + 4, m + 8);
}

// An accumulator of 64 rows x N columns, split, into the hi and lo tiles
// of a B operand whose rows are the accumulator's rows (64) and whose
// columns are its columns: this warpgroup's rows.
template <int N>
__device__ __forceinline__ void store_split(const float (&s)[N / 2],
                                            uint8_t* thi, uint8_t* tlo) {
  const int r = 16 * ((threadIdx.x % 128) / 32) + (threadIdx.x % 32) / 4;
  const int cq = 2 * (threadIdx.x % 4);
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      uint2 h, l;
      split_tf32(s[4 * j + 2 * half], h.x, l.x);
      split_tf32(s[4 * j + 2 * half + 1], h.y, l.y);
      const uint32_t off = sw_off(64, r + 8 * half, 8 * j + cq);
      *reinterpret_cast<uint2*>(thi + off) = h;
      *reinterpret_cast<uint2*>(tlo + off) = l;
    }
}

template <int G>
__device__ __forceinline__ void fence_frag(uint32_t (&a)[G][4]) {
#pragma unroll
  for (int i = 0; i < G; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// d (64 x N) = A B^T over KS steps of 8 along the sum: A's fragments
// from `load(kk, hi, lo)`, B the N-row hi / lo tiles at shared addresses
// b_hi / b_lo (K-major, swizzled; step kk at column 8 kk).  PRODUCTS = 3
// is 3xTF32, 1 a single TF32 product of the hi parts.  The fragments of G
// steps are loaded while the previous G steps run on the tensor cores (two
// register buffers); returns with every product landed in d.
template <int N, int KS, int G, int PRODUCTS, class Load>
__device__ __forceinline__ void chain(float* d, Load&& load, uint32_t b_hi,
                                      uint32_t b_lo) {
  static_assert(KS % G == 0, "whole groups of steps");
  uint32_t ah[2][G][4], al[2][G][4];
#pragma unroll
  for (int grp = 0; grp < KS / G; ++grp) {
    const int buf = grp & 1;
#pragma unroll
    for (int i = 0; i < G; ++i) load(grp * G + i, ah[buf][i], al[buf][i]);
    wgmma_fence();
#pragma unroll
    for (int i = 0; i < G; ++i) {
      const int kk = grp * G + i;
      const uint32_t off = (kk >> 2) * (N * 128) + (kk & 3) * 32;
      const uint64_t bh = smem_desc(b_hi + off, 16, 1024);
      const int acc = kk > 0 ? 1 : 0;
      if constexpr (PRODUCTS == 3) {
        const uint64_t bl = smem_desc(b_lo + off, 16, 1024);
        wgmma_tf32<N>(d, al[buf][i], bh, acc);
        wgmma_tf32<N>(d, ah[buf][i], bl, 1);
        wgmma_tf32<N>(d, ah[buf][i], bh, 1);
      } else {
        wgmma_tf32<N>(d, ah[buf][i], bh, acc);
      }
    }
    wgmma_commit();
    if (grp > 0) {
      wgmma_wait<1>();
      fence_frag<G>(ah[buf ^ 1]);
      fence_frag<G>(al[buf ^ 1]);
    }
  }
  wgmma_wait<0>();
  fence_frag<G>(ah[(KS / G - 1) & 1]);
  fence_frag<G>(al[(KS / G - 1) & 1]);
  fence_regs<N / 2>(d);
}

// Two products of one shape issued as one pipeline, d1 (KS1 steps) then
// d2 (KS2 steps), with no drain of the tensor cores between them.  As
// chain (PRODUCTS = 3) otherwise.
template <int N, int KS1, int KS2, int G, class Load1, class Load2>
__device__ __forceinline__ void chain2(float* d1, Load1&& load1,
                                       uint32_t b1_hi, uint32_t b1_lo,
                                       float* d2, Load2&& load2,
                                       uint32_t b2_hi, uint32_t b2_lo) {
  static_assert(KS1 % G == 0 && KS2 % G == 0, "whole groups of steps");
  constexpr int KS = KS1 + KS2;
  uint32_t ah[2][G][4], al[2][G][4];
#pragma unroll
  for (int grp = 0; grp < KS / G; ++grp) {
    const int buf = grp & 1;
#pragma unroll
    for (int i = 0; i < G; ++i) {
      const int kk = grp * G + i;
      if (kk < KS1) load1(kk, ah[buf][i], al[buf][i]);
      else load2(kk - KS1, ah[buf][i], al[buf][i]);
    }
    wgmma_fence();
#pragma unroll
    for (int i = 0; i < G; ++i) {
      const int kk = grp * G + i;
      const int k2 = kk < KS1 ? kk : kk - KS1;
      float* d = kk < KS1 ? d1 : d2;
      const uint32_t off = (k2 >> 2) * (N * 128) + (k2 & 3) * 32;
      const uint64_t bh =
          smem_desc((kk < KS1 ? b1_hi : b2_hi) + off, 16, 1024);
      const uint64_t bl =
          smem_desc((kk < KS1 ? b1_lo : b2_lo) + off, 16, 1024);
      wgmma_tf32<N>(d, al[buf][i], bh, k2 > 0 ? 1 : 0);
      wgmma_tf32<N>(d, ah[buf][i], bl, 1);
      wgmma_tf32<N>(d, ah[buf][i], bh, 1);
    }
    wgmma_commit();
    if (grp > 0) {
      wgmma_wait<1>();
      fence_frag<G>(ah[buf ^ 1]);
      fence_frag<G>(al[buf ^ 1]);
    }
  }
  wgmma_wait<0>();
  fence_frag<G>(ah[(KS / G - 1) & 1]);
  fence_frag<G>(al[(KS / G - 1) & 1]);
  fence_regs<N / 2>(d1);
  fence_regs<N / 2>(d2);
}

}  // namespace
