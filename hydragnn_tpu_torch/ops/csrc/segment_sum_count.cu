// Segment (sum, count) over unsorted ids: the Hopper kernel behind every
// segment reduction of the port that has no CSR pointers (a GraphBatch
// whose row_ptr / graph_ptr are None: PNA's mean and centred-std passes,
// the readout mean pool).
//
// Replaces: hydragnn_tpu/ops/pallas_segment.py, _sum_count_kernel (K2) and
// _sum_count_split_kernel (K3), both launched by _sum_count_pallas. Those
// TPU kernels build a one-hot (rows == ids) tile per (128-node block,
// 512-edge block) and multiply it into the data on the MXU; the bf16 hi/lo
// split (K3, and K2's hi/lo packing into 128 lanes at F <= 64) exists only
// because the MXU rounds its operands to bf16. The card adds f32 natively,
// so one f32 kernel is the counterpart of both, and it does E*F adds where
// the one-hot product does N/128 x E/512 tiles of work.
//
// Computes, for ids [E] int32 and data [E, F] float32:
//   sum[n, :] = sum over e with ids[e] == n of data[e, :]
//   count[n]  = #{e : ids[e] == n}
// for n < num_segments. Entries with ids < 0 (masked rows) or ids >=
// num_segments are excluded from both; empty segments yield 0.
//
// Deterministic: each segment is summed in ascending edge order, so two
// launches give bit-identical sums (float atomics would not). Steps, all on
// one stream:
//  1. count_kernel: integer atomics count each segment's valid ids (exact).
//  2. scan_kernel: one block turns the counts into segment offsets
//     off[0..N] (exclusive scan; off[N] = valid entries).
//  3. place_kernel: integer atomics put each valid edge's index into its
//     segment's slots perm[off[n] .. off[n+1]), in no particular order.
//  4. ascending edge order is restored inside each segment: segments of at
//     most 32 entries by one warp (each lane's rank among the warp's
//     values), of at most kMediumMax entries by one block in shared memory
//     (rank by counting), longer ones by one block that scans all ids in
//     order and writes the segment's edges by a block-wide prefix count.
//  5. the run walk of csr_walk.cuh over (off, perm): warp per segment,
//     float4 columns, segments longer than 128 entries split into chunks
//     whose partials are added in a fixed order; the walk also writes the
//     counts, off[n+1] - off[n].
//
// Bound on an H100 SXM: memory. The function reads every id once, the kept
// data rows (id in [0, N)) once, and writes sum and count once:
// E*4 + kept*F*4 + N*F*4 + N*4 bytes at 3.35 TB/s; the kept*F adds are far
// below the f32 rate. What this simple design leaves
// on the table: seven launches where the function needs one pass; the
// integer scratch (counts, offsets, cursors, the permutation) makes several
// extra passes over E and N ints; the walk reads data rows in permuted
// order (a gather) and inherits K1's idle lanes at F < 128 and its latency
// chains; the scan is one block; a segment longer than kMediumMax costs a
// pass over all E ids of one block.

#include <algorithm>
#include <climits>

#include <cuda_runtime.h>

#include "csr_walk.cuh"

namespace {

constexpr int kThreads = 256;       // elementwise kernels and the medium sort
constexpr int kScanThreads = 1024;  // the one-block scan: 32 full warps
constexpr int kMediumMax = 1024;    // longest segment sorted in shared memory
constexpr int kWarpsPerBlock = kThreads / csr_walk::kWarp;
constexpr unsigned kFull = 0xffffffffu;

__global__ void count_kernel(const int* __restrict__ ids, int* __restrict__ cnt,
                             int num_edges, int num_segments) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= num_edges) return;
  const int s = __ldg(ids + e);
  if (s >= 0 && s < num_segments) atomicAdd(cnt + s, 1);
}

// Inclusive scan of v over the 32 lanes of a warp.
__device__ __forceinline__ int warp_inclusive_scan(int v, int lane) {
#pragma unroll
  for (int d = 1; d < csr_walk::kWarp; d <<= 1) {
    const int u = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v += u;
  }
  return v;
}

// One block: off[n] = sum of cnt[0..n), off[num_segments] = the total. Each
// thread owns a contiguous range of segments.
__global__ void __launch_bounds__(kScanThreads)
scan_kernel(const int* __restrict__ cnt, int* __restrict__ off,
            int num_segments) {
  __shared__ int warp_sums[kScanThreads / csr_walk::kWarp];
  const int t = threadIdx.x;
  const int lane = t % csr_walk::kWarp;
  const int w = t / csr_walk::kWarp;
  const int per = (num_segments + kScanThreads - 1) / kScanThreads;
  const int a = min(t * per, num_segments);
  const int b = min(a + per, num_segments);
  int local = 0;
  for (int s = a; s < b; ++s) local += cnt[s];
  const int incl = warp_inclusive_scan(local, lane);
  if (lane == csr_walk::kWarp - 1) warp_sums[w] = incl;
  __syncthreads();
  if (w == 0) warp_sums[lane] = warp_inclusive_scan(warp_sums[lane], lane);
  __syncthreads();
  int run = incl - local + (w > 0 ? warp_sums[w - 1] : 0);
  for (int s = a; s < b; ++s) {
    off[s] = run;
    run += cnt[s];
  }
  // The last thread's running total covers every segment.
  if (t == kScanThreads - 1) off[num_segments] = run;
}

__global__ void place_kernel(const int* __restrict__ ids,
                             const int* __restrict__ off,
                             int* __restrict__ cursor, int* __restrict__ perm,
                             int num_edges, int num_segments) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= num_edges) return;
  const int s = __ldg(ids + e);
  if (s < 0 || s >= num_segments) return;
  perm[__ldg(off + s) + atomicAdd(cursor + s, 1)] = e;
}

// One warp per segment of 2..32 entries: lane l's edge goes to slot
// (number of smaller edges in the segment). Edge indices are distinct.
__global__ void __launch_bounds__(kThreads)
sort_small_kernel(const int* __restrict__ off, int* __restrict__ perm,
                  int num_segments) {
  const int s = blockIdx.x * kWarpsPerBlock + threadIdx.x / csr_walk::kWarp;
  const int lane = threadIdx.x % csr_walk::kWarp;
  if (s >= num_segments) return;
  const int a = __ldg(off + s);
  const int c = __ldg(off + s + 1) - a;
  if (c <= 1 || c > csr_walk::kWarp) return;
  const int v = lane < c ? perm[a + lane] : INT_MAX;
  int rank = 0;
#pragma unroll
  for (int j = 0; j < csr_walk::kWarp; ++j) {
    rank += __shfl_sync(kFull, v, j) < v;
  }
  if (lane < c) perm[a + rank] = v;
}

// Blocks stride over the segments; one block sorts each segment of
// 33..kMediumMax entries in shared memory, by rank.
__global__ void __launch_bounds__(kThreads)
sort_medium_kernel(const int* __restrict__ off, int* __restrict__ perm,
                   int num_segments) {
  __shared__ int buf[kMediumMax];
  for (int s = blockIdx.x; s < num_segments; s += gridDim.x) {
    const int a = __ldg(off + s);
    const int c = __ldg(off + s + 1) - a;
    if (c <= csr_walk::kWarp || c > kMediumMax) continue;  // uniform
    for (int k = threadIdx.x; k < c; k += blockDim.x) buf[k] = perm[a + k];
    __syncthreads();
    for (int k = threadIdx.x; k < c; k += blockDim.x) {
      const int v = buf[k];
      int rank = 0;
      for (int j = 0; j < c; ++j) rank += buf[j] < v;
      perm[a + rank] = v;
    }
    __syncthreads();
  }
}

// Blocks stride over the segments; one block rewrites each segment of more
// than kMediumMax entries in ascending edge order by scanning every id:
// each round of kScanThreads ids writes its hits at the running position
// plus their prefix count within the round.
__global__ void __launch_bounds__(kScanThreads)
order_large_kernel(const int* __restrict__ ids, const int* __restrict__ off,
                   int* __restrict__ perm, int num_edges, int num_segments) {
  __shared__ int warp_hits[kScanThreads / csr_walk::kWarp];
  const int lane = threadIdx.x % csr_walk::kWarp;
  const int w = threadIdx.x / csr_walk::kWarp;
  for (int s = blockIdx.x; s < num_segments; s += gridDim.x) {
    const int a = __ldg(off + s);
    const int c = __ldg(off + s + 1) - a;
    if (c <= kMediumMax) continue;  // uniform
    int pos = a;
    for (int e0 = 0; e0 < num_edges && pos < a + c; e0 += kScanThreads) {
      const int e = e0 + threadIdx.x;
      const bool hit = e < num_edges && __ldg(ids + e) == s;
      const unsigned mask = __ballot_sync(kFull, hit);
      if (lane == 0) warp_hits[w] = __popc(mask);
      __syncthreads();
      int before = 0, round = 0;
      for (int k = 0; k < kScanThreads / csr_walk::kWarp; ++k) {
        before += k < w ? warp_hits[k] : 0;
        round += warp_hits[k];
      }
      if (hit) perm[pos + before + __popc(mask & ((1u << lane) - 1u))] = e;
      __syncthreads();
      pos += round;
    }
  }
}

}  // namespace

// Edges per chunk of the walk: the caller sizes `fscratch` as
// 2 * ceil(num_edges / chunk) * f floats.
extern "C" int segment_sum_count_chunk_edges(void) { return csr_walk::kChunk; }

// Plain C entry point, bound from Python with ctypes. `data` is [num_edges,
// f], `ids` [num_edges]; `iscratch` holds 3 * num_segments + 1 + num_edges
// ints (counts, offsets, cursors, the permutation), `fscratch` the walk's
// partials. Launches on `stream` and does not synchronise; returns
// cudaGetLastError() after the launches (0 is success).
extern "C" int segment_sum_count_f32(const float* data, const int* ids,
                                     float* sum, float* count, int* iscratch,
                                     float* fscratch, int num_segments,
                                     int num_edges, int f, int vec4,
                                     void* stream) {
  if (num_segments <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* cnt = iscratch;
  int* off = cnt + num_segments;
  int* cursor = off + num_segments + 1;
  int* perm = cursor + num_segments;
  cudaMemsetAsync(cnt, 0, sizeof(int) * num_segments, st);
  cudaMemsetAsync(cursor, 0, sizeof(int) * num_segments, st);
  const int edge_blocks = (num_edges + kThreads - 1) / kThreads;
  if (num_edges > 0) {
    count_kernel<<<edge_blocks, kThreads, 0, st>>>(ids, cnt, num_edges,
                                                   num_segments);
  }
  scan_kernel<<<1, kScanThreads, 0, st>>>(cnt, off, num_segments);
  if (num_edges > 0) {
    place_kernel<<<edge_blocks, kThreads, 0, st>>>(ids, off, cursor, perm,
                                                   num_edges, num_segments);
    sort_small_kernel<<<(num_segments + kWarpsPerBlock - 1) / kWarpsPerBlock,
                        kThreads, 0, st>>>(off, perm, num_segments);
    sort_medium_kernel<<<std::min(num_segments, 1024), kThreads, 0, st>>>(
        off, perm, num_segments);
    order_large_kernel<<<std::min(num_segments, 132), kScanThreads, 0, st>>>(
        ids, off, perm, num_edges, num_segments);
  }
  csr_walk::sum_count<true>(data, perm, off, sum, count, fscratch,
                            num_segments, num_edges, f, vec4 != 0, st);
  return static_cast<int>(cudaGetLastError());
}
