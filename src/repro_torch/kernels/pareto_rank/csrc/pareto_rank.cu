// Pareto dominance counts on NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/pareto_rank/pareto_rank.py
// (dominance_counts_pallas / _rank_kernel).  For an (n, k) float32 pool of
// objective rows (all minimized) and an (n,) byte validity mask, writes the
// (n,) int32 count of valid rows i that dominate each row j:
//     all(o_i <= o_j) and any(o_i < o_j).
//
// What bounds it on the H100: the work is n^2 * k pairs of FP32 compares
// while only n * (4k + 1) bytes are read and 4n written, so it is bound by
// compare throughput at large n and by the launch at the pools the search
// runs (128 and 768 rows).
//
// Design.  The TPU kernel reduces over dominator tiles along a sequential
// grid axis, carrying the count in VMEM between grid steps.  Blocks on the
// H100 run in no order, so nothing is carried between blocks: each block
// owns kBlockJ dominated rows j (one per thread, the row's k objectives in
// registers) and loops over ALL dominator tiles itself.  Each (kTileI, k)
// tile of objectives and its validity bytes is staged in shared memory with
// coalesced loads; every thread then reads the same dominator row at once
// (a shared-memory broadcast) and keeps one int32 count in a register.  No
// atomics, no second pass, exact integers.  Any n is taken (the ragged edge
// is masked here, no host padding) and any k from 1 to 4 (a template
// parameter, so the compare loop unrolls).  The kernel launches on the
// caller's stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockJ = 128;   // dominated rows per block, one per thread
constexpr int kTileI = 256;    // dominator rows staged per shared-memory tile

template <int K>
__global__ void __launch_bounds__(kBlockJ)
rank_kernel(const float* __restrict__ objs, const uint8_t* __restrict__ valid,
            int* __restrict__ counts, int n) {
  __shared__ float s_obj[kTileI * K];
  __shared__ uint8_t s_valid[kTileI];

  const int j = blockIdx.x * kBlockJ + threadIdx.x;
  float oj[K];
#pragma unroll
  for (int c = 0; c < K; ++c) {
    oj[c] = (j < n) ? objs[static_cast<size_t>(j) * K + c] : 0.0f;
  }

  int count = 0;
  for (int base = 0; base < n; base += kTileI) {
    const int tile = min(kTileI, n - base);
    __syncthreads();   // every thread is done with the previous tile
    for (int t = threadIdx.x; t < tile * K; t += kBlockJ) {
      s_obj[t] = objs[static_cast<size_t>(base) * K + t];
    }
    for (int t = threadIdx.x; t < tile; t += kBlockJ) {
      s_valid[t] = valid[base + t];
    }
    __syncthreads();
    for (int i = 0; i < tile; ++i) {
      bool le = true;
      bool lt = false;
#pragma unroll
      for (int c = 0; c < K; ++c) {
        const float oi = s_obj[i * K + c];
        le = le & (oi <= oj[c]);
        lt = lt | (oi < oj[c]);
      }
      count += static_cast<int>((s_valid[i] != 0) & le & lt);
    }
  }
  if (j < n) counts[j] = count;
}

}  // namespace

// C interface, loaded with ctypes.  objs: (n, k) float32 row-major;
// valid: (n,) bytes (0 = invalid); counts: (n,) int32 output; stream: the
// cudaStream_t to launch on.  Returns a cudaError_t code (0 = launched).
extern "C" int pareto_rank_dominance_counts(const float* objs,
                                            const uint8_t* valid, int* counts,
                                            int n, int k, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const dim3 grid((n + kBlockJ - 1) / kBlockJ);
  const dim3 block(kBlockJ);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 1: rank_kernel<1><<<grid, block, 0, s>>>(objs, valid, counts, n); break;
    case 2: rank_kernel<2><<<grid, block, 0, s>>>(objs, valid, counts, n); break;
    case 3: rank_kernel<3><<<grid, block, 0, s>>>(objs, valid, counts, n); break;
    case 4: rank_kernel<4><<<grid, block, 0, s>>>(objs, valid, counts, n); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
