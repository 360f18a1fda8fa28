// Pareto dominance counts on NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/pareto_rank/pareto_rank.py
// (dominance_counts_pallas / _rank_kernel).  For an (n, k) float32 pool of
// objective rows (all minimized) and an (n,) byte validity mask, writes the
// (n,) int32 count of valid rows i that dominate each row j:
//     all(o_i <= o_j) and any(o_i < o_j).
//
// What bounds it on the H100: the work is n^2 pairs of k compares each
// while only n * (4k + 1) bytes are read and 4n written, so it is bound by
// instruction issue at large n (at (8192, 4), 8 instructions a pair over
// 132 SMs x 128 lanes at 1.98 GHz take 16 us) and by the launch at the
// pools the search runs (64 to 768 rows).
//
// Design.  The TPU kernel reduces over dominator tiles along a sequential
// grid axis, carrying the count in VMEM between grid steps.  Here the grid
// is 2-D: blockIdx.x runs over tiles of kTileJ dominated rows j, blockIdx.y
// over C <= 8 chunks of the dominator rows i, and the C blocks of one j
// tile form a thread-block cluster.  Each block counts its j tile against
// its own chunk; then the cluster's leader (rank 0) sums the C partial
// counts through distributed shared memory and writes them.  One launch:
// no memset, no atomics, no second pass, and an exact, deterministic
// integer result.  At (8192, 4) that is 64 x 8 = 512 blocks of 8 warps on
// the card (one block of 4 warps a j tile, 64 in all, before).
//
// Each thread owns kRows dominated rows (their k objectives in registers),
// so one shared-memory broadcast of a dominator row serves kRows pairs,
// and kSplit threads share those rows, each taking every kSplit-th group
// of 4 staged dominator rows: more warps to hide latency without more
// blocks in a cluster.
// Dominator rows are staged as one 16-byte float4 each (columns past k are
// never read: k is a template parameter).  Validity is folded into the
// staged values: an invalid dominator row, and the rows that pad a staged
// tile to a multiple of four, are staged as +inf, which dominates no row
// (it is < nothing), so the inner loop reads no validity byte and has no
// bound check.  Every value is staged as x + 0, which turns -0 into +0 and
// changes no comparison.
//
// Two exact ways to decide a pair, chosen per staged tile (the choice is
// uniform over the block, so no warp diverges):
// * Finite tiles (every valid staged row, and every dominated row of the
//   block, finite): the differences d_c = o_j,c - o_i,c go through the FP32
//   pipes, and their bit patterns are ORed into u.  With no -0 in sight
//   and gradual underflow (no flush to zero), d_c is +0 exactly when the
//   values are equal and has its sign bit set exactly when o_j,c < o_i,c
//   (an overflow to +-inf keeps the sign; a +inf row gives -inf).  So u is
//   positive as a signed integer exactly when i dominates j: no negative
//   d_c, and not all of them +0.  Per pair that is k subtracts, k / 2
//   three-way ORs, u - 1 and an add of its sign bit (u = 0x80000000 cannot
//   occur): 8 instructions at k = 4, half of them on the FP32 pipe, where
//   compares would take 10 on the integer/compare pipe, which has half the
//   FP32 pipe's lanes.
// * Tiles that hold NaN or +-inf: IEEE compares (all <= and any <), each
//   into a predicate; a NaN makes every compare false, as in the plain
//   version.
// Lanes.  A fused NSGA run ranks L pools of one shape at once (one per
// problem; the reference reaches its kernel under vmap, which adds a batch
// grid axis).  blockIdx.z is the lane: each lane's blocks offset into its
// own (n, k) pool, (n,) mask and (n,) counts, and keep their own cluster of
// dominator chunks along y, exactly as a single pool does; the single-pool
// entry is the same launch with one lane.
// Any n is taken.  The kernel launches on the caller's stream; the C entry
// returns the launch's error code.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kLanes = 64;                  // threads along j
constexpr int kSplit = 4;                   // thread groups along i
constexpr int kThreads = kLanes * kSplit;   // threads per block
constexpr int kRows = 2;                    // dominated rows per thread
constexpr int kTileJ = kLanes * kRows;      // dominated rows per block
constexpr int kTileI = 512;                 // dominator rows staged a round
constexpr int kMaxCluster = 8;              // the portable cluster size
constexpr int kMinChunk = 64;               // fewest dominator rows a block

template <int K>
__global__ void __launch_bounds__(kThreads)
rank_kernel(const float* __restrict__ objs, const uint8_t* __restrict__ valid,
            int* __restrict__ counts, int n, int chunk) {
  __shared__ float4 s_obj[kTileI];
  __shared__ int s_part[kSplit][kTileJ];
  const size_t lane_rows = static_cast<size_t>(blockIdx.z) * n;
  objs += lane_rows * K;
  valid += lane_rows;
  counts += lane_rows;

  const int tid = threadIdx.x;
  const int lane = tid % kLanes;     // rows j: lane + r kLanes
  const int group = tid / kLanes;    // staged rows: every kSplit-th 4 rows
  const int j0 = blockIdx.x * kTileJ;
  float oj[kRows][K];
  bool finite = true;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int j = j0 + lane + r * kLanes;
#pragma unroll
    for (int c = 0; c < K; ++c) {
      oj[r][c] = j < n ? objs[static_cast<size_t>(j) * K + c] + 0.0f : 0.0f;
      finite = finite && isfinite(oj[r][c]);
    }
  }
  const bool finite_j = __syncthreads_and(finite);

  int count[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) count[r] = 0;
  const int i_begin = static_cast<int>(blockIdx.y) * chunk;
  const int i_end = min(n, i_begin + chunk);
  for (int base = i_begin; base < i_end; base += kTileI) {
    const int tile = min(kTileI, i_end - base);
    const int tile4 = (tile + 3) & ~3;
    __syncthreads();   // every thread is done with the previous tile
    finite = true;
    for (int t = tid; t < tile4; t += kThreads) {
      const int i = base + t;
      const float inf = __int_as_float(0x7f800000);
      float o[4] = {inf, inf, inf, inf};
      if (t < tile && valid[i]) {
#pragma unroll
        for (int c = 0; c < K; ++c) {
          o[c] = objs[static_cast<size_t>(i) * K + c] + 0.0f;
          finite = finite && isfinite(o[c]);
        }
      }
      s_obj[t] = make_float4(o[0], o[1], o[2], o[3]);
    }
    if (__syncthreads_and(finite) && finite_j) {
      uint32_t nd[kRows];      // pairs that do not dominate
#pragma unroll
      for (int r = 0; r < kRows; ++r) nd[r] = 0u;
      int mine = 0;            // staged rows this thread reads
      for (int t = 4 * group; t < tile4; t += 4 * kSplit) {
        mine += 4;
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const float4 o4 = s_obj[t + v];
          const float oi[4] = {o4.x, o4.y, o4.z, o4.w};
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            uint32_t u = 0u;
#pragma unroll
            for (int c = 0; c < K; ++c)
              u |= __float_as_uint(__fsub_rn(oj[r][c], oi[c]));
            nd[r] += (u - 1u) >> 31;
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        count[r] += mine - static_cast<int>(nd[r]);
    } else {
      for (int t = 4 * group; t < tile4; t += 4 * kSplit) {
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const float4 o4 = s_obj[t + v];
          const float oi[4] = {o4.x, o4.y, o4.z, o4.w};
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            bool lt = false;
#pragma unroll
            for (int c = 0; c < K; ++c) lt = lt || oi[c] < oj[r][c];
            bool dom = lt;
#pragma unroll
            for (int c = 0; c < K; ++c) dom = dom && oi[c] <= oj[r][c];
            count[r] += dom;
          }
        }
      }
    }
  }

  // the cluster's leader sums the partial counts of every chunk and group
  cg::cluster_group cluster = cg::this_cluster();
#pragma unroll
  for (int r = 0; r < kRows; ++r) s_part[group][lane + r * kLanes] = count[r];
  cluster.sync();
  if (cluster.block_rank() == 0) {
    const unsigned blocks = cluster.num_blocks();
    for (int e = tid; e < kTileJ; e += kThreads) {
      int sum = 0;
      for (unsigned b = 0; b < blocks; ++b) {
        const int* part = cluster.map_shared_rank(&s_part[0][0], b);
#pragma unroll
        for (int g = 0; g < kSplit; ++g) sum += part[g * kTileJ + e];
      }
      if (j0 + e < n) counts[j0 + e] = sum;
    }
  }
  cluster.sync();    // no block leaves while the leader reads its counts
}

template <int K>
cudaError_t launch(const float* objs, const uint8_t* valid, int* counts,
                   int lanes, int n, cudaStream_t stream) {
  int chunks = (n + kMinChunk - 1) / kMinChunk;
  chunks = chunks < 1 ? 1 : (chunks > kMaxCluster ? kMaxCluster : chunks);
  const int chunk = (n + chunks - 1) / chunks;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((n + kTileJ - 1) / kTileJ, chunks, lanes);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = chunks;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, rank_kernel<K>, objs, valid, counts, n,
                            chunk);
}

}  // namespace

// C interface, loaded with ctypes.  objs: (lanes, n, k) float32 row-major;
// valid: (lanes, n) bytes (0 = invalid); counts: (lanes, n) int32 output;
// stream: the cudaStream_t to launch on.  Returns a cudaError_t code
// (0 = launched).  One launch for every lane.
extern "C" int pareto_rank_dominance_counts_lanes(const float* objs,
                                                  const uint8_t* valid,
                                                  int* counts, int lanes,
                                                  int n, int k,
                                                  void* stream) {
  if (n <= 0 || lanes <= 0) return static_cast<int>(cudaSuccess);
  if (lanes > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (k) {
    case 1: e = launch<1>(objs, valid, counts, lanes, n, s); break;
    case 2: e = launch<2>(objs, valid, counts, lanes, n, s); break;
    case 3: e = launch<3>(objs, valid, counts, lanes, n, s); break;
    case 4: e = launch<4>(objs, valid, counts, lanes, n, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// The single pool: objs (n, k), valid (n,), counts (n,), one lane.
extern "C" int pareto_rank_dominance_counts(const float* objs,
                                            const uint8_t* valid, int* counts,
                                            int n, int k, void* stream) {
  return pareto_rank_dominance_counts_lanes(objs, valid, counts, 1, n, k,
                                            stream);
}
