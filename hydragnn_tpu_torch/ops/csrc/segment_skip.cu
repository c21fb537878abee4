// Block-skip segment (sum, count) over unsorted ids: the Hopper kernel behind
// every segment reduction of the port that has no CSR pointers while
// HYDRAGNN_PALLAS_SKIP is set (ops/segment_sum_count.py routes there).
//
// Replaces: hydragnn_tpu/ops/pallas_segment.py, _skip_kernel (K4), launched
// by _sum_count_pallas under HYDRAGNN_PALLAS_SKIP=1. That TPU kernel is the
// one-hot (rows == ids) MXU product of K2/K3 over a grid of (128-node block,
// 512-edge block) pairs, with each edge block's receiver range [lo, hi]
// (over its kept ids) prefetched so that a pair _block_overlap rules out
// costs neither compute nor DMA. The card adds f32 natively and has no MXU,
// so the product becomes compare-and-add; the block ranges and the overlap
// predicate are kept as they are (kBE = _BE = 512, kBN = _BN = 128), so the
// pairs this kernel skips are the reference's.
//
// Computes, for ids [E] int32 and data [E, F] float32:
//   sum[n, :] = sum over e with ids[e] == n of data[e, :]
//   count[n]  = #{e : ids[e] == n}
// for n < num_segments. Entries with ids < 0 (masked rows) or ids >=
// num_segments are excluded from both; empty segments yield 0.
//
// Two launches on one stream:
//  1. block_ranges_kernel, one CTA per 512-edge block, one warp per 64-edge
//     sub-block: lo/hi over the block's kept ids (id >= 0, as the
//     reference's ranges), the kept count, and the sums of the sub-blocks
//     and blocks whose kept ids all name one row < num_segments ("one-row"
//     sub-blocks and blocks).
//  2. tile_walk_kernel, one CTA per (32-row quarter of a 128-row node
//     tile, column tile). It walks the edge blocks in ascending order and
//     skips every block that _block_overlap rules out for its tile (hi <
//     base or lo >= base + 128): on collation's ascending receivers a tile
//     meets one to three blocks, and a wholly masked block (lo > hi: the
//     padding slots) meets none. For a block it keeps, it stages the ids in
//     shared memory; warp w owns the CTA's rows r with r % 8 == w and lane l
//     the l-th column group of the tile (a float4 when F % 4 == 0 and the
//     pointers are 16-byte aligned, else one float); each warp adds the rows
//     whose id is one of its rows, in ascending edge order, 8 loads in
//     flight, into a shared-memory accumulator. (Quarter tiles: four times
//     the CTAs of one per tile, and a quarter of the hits on each warp's
//     chain of loads.)
// Long runs of one row. Messages that pass no mask (GAT's weighted sum,
// CGCNN's sum) keep the padding edges, all of which name the padding node:
// ~14k edges of one row at 256 flagship graphs. One warp adding them one by
// one would serialise the whole launch on that row. Such runs are split by
// edge block: pass 1 sums each one-row sub-block and block in parallel, and
// pass 2 adds those partials (a run of consecutive one-row blocks in one
// batch of loads) instead of the rows.
// Every output element is a sum in a fixed order (blocks ascending;
// sub-blocks ascending; edges ascending; a one-row partial's rows
// ascending), so two launches are bit-identical. No atomics.
//
// Bound on an H100 SXM: memory, the same as K2/K3's. The function reads
// every id once, the kept rows (id in [0, N)) once, and writes sum and count
// once: E*4 + kept*F*4 + N*F*4 + N*4 bytes at 3.35 TB/s; the kept*F adds are
// far below the f32 rate. What this simple design leaves on the table: a
// warp's hits are latency-bound chains (loads batched by 8); 256 CTAs at
// N = 8192 are two per SM; lanes idle at F < 128
// (half of them at F = 64, 31 of 32 at F = 1); a row with many hits in
// blocks that also hold other rows (a hub whose edges are scattered) is
// walked by one warp; and the two passes are two launches.

#include <climits>

#include <cuda_runtime.h>

#include "csr_walk.cuh"

namespace {

using csr_walk::Cols;
using csr_walk::kWarp;

constexpr int kBE = 512;                  // edges per block (the reference's _BE)
constexpr int kBN = 128;                  // rows per node tile (the reference's _BN)
constexpr int kWarps = 8;                 // warps per CTA, in both passes
constexpr int kThreads = kWarp * kWarps;
constexpr int kSub = kBE / kWarps;        // 64 edges per sub-block
constexpr int kRounds = kSub / kWarp;     // ballot rounds per sub-block
constexpr int kRows = 32;                 // rows per CTA of pass 2: a quarter tile
constexpr int kGroups = kWarp;            // column groups per column tile
constexpr int kStage = 512;               // block ranges staged per round
constexpr unsigned kFull = 0xffffffffu;

static_assert(kBN % kRows == 0 && kRows % kWarps == 0,
              "a tile's rows are dealt to CTAs, and theirs to warps round-robin");

// acc += the data rows ebase + b for the set bits b of m, in ascending b.
// Loads go out in batches of 8 before the adds.
template <bool kVec4>
__device__ __forceinline__ void add_rows(typename Cols<kVec4>::T& acc,
                                         const typename Cols<kVec4>::T* __restrict__ in,
                                         unsigned m, int ebase, int g, int c) {
  using T = typename Cols<kVec4>::T;
  while (m) {
    T v[8];
    int n = 0;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      if (m) {
        const int b = __ffs(m) - 1;
        m &= m - 1;
        v[q] = __ldg(in + static_cast<size_t>(ebase + b) * g + c);
        n = q + 1;
      }
    }
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      if (q < n) Cols<kVec4>::add(acc, v[q]);
    }
  }
}

__device__ __forceinline__ int warp_min(int v) {
#pragma unroll
  for (int d = kWarp / 2; d > 0; d >>= 1) v = min(v, __shfl_xor_sync(kFull, v, d));
  return v;
}

__device__ __forceinline__ int warp_max(int v) {
#pragma unroll
  for (int d = kWarp / 2; d > 0; d >>= 1) v = max(v, __shfl_xor_sync(kFull, v, d));
  return v;
}

// Pass 1. CTA j, warp w: sub-block j * kWarps + w = edges
// [j * kBE + w * kSub, + kSub). Writes lo[j], hi[j] (INT_MAX and -1 when no
// id of the block is kept, so that no tile overlaps it), block_row[j] and
// block_cnt[j], and per sub-block sub_row, sub_cnt and, for one-row ones,
// sub_sum; for a one-row block, block_sum.
template <bool kVec4>
__global__ void __launch_bounds__(kThreads)
block_ranges_kernel(const typename Cols<kVec4>::T* __restrict__ in,
                    const int* __restrict__ ids, int* __restrict__ lo,
                    int* __restrict__ hi, int* __restrict__ block_row,
                    int* __restrict__ block_cnt, int* __restrict__ sub_row,
                    int* __restrict__ sub_cnt,
                    typename Cols<kVec4>::T* sub_sum,  // written, then read
                    typename Cols<kVec4>::T* __restrict__ block_sum,
                    int num_edges, int num_segments, int g) {
  using T = typename Cols<kVec4>::T;
  __shared__ int s_lo[kWarps], s_hi[kWarps], s_cnt[kWarps];
  const int j = blockIdx.x;
  const int w = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int e0 = j * kBE + w * kSub;
  int mn = INT_MAX, mx = -1, kept = 0;
  unsigned m[kRounds];
#pragma unroll
  for (int q = 0; q < kRounds; ++q) {
    const int e = e0 + q * kWarp + lane;
    const int id = e < num_edges ? __ldg(ids + e) : -1;
    if (id >= 0) {
      mn = min(mn, id);
      mx = max(mx, id);
    }
    m[q] = __ballot_sync(kFull, id >= 0);
    kept += __popc(m[q]);
  }
  mn = warp_min(mn);
  mx = warp_max(mx);
  const int sb = j * kWarps + w;
  const bool one_row = kept > 0 && mn == mx && mn < num_segments;
  if (lane == 0) {
    s_lo[w] = mn;
    s_hi[w] = mx;
    s_cnt[w] = kept;
    sub_row[sb] = one_row ? mn : -1;
    sub_cnt[sb] = kept;
  }
  if (one_row) {
    for (int c = lane; c < g; c += kWarp) {
      T acc = Cols<kVec4>::zero();
#pragma unroll
      for (int q = 0; q < kRounds; ++q) {
        add_rows<kVec4>(acc, in, m[q], e0 + q * kWarp, g, c);
      }
      sub_sum[static_cast<size_t>(sb) * g + c] = acc;
    }
  }
  __syncthreads();  // the sub-block sums are visible to the whole CTA
  int blo = INT_MAX, bhi = -1, bcnt = 0;
#pragma unroll
  for (int k = 0; k < kWarps; ++k) {
    blo = min(blo, s_lo[k]);
    bhi = max(bhi, s_hi[k]);
    bcnt += s_cnt[k];
  }
  const bool one_row_block = bcnt > 0 && blo == bhi && blo < num_segments;
  if (threadIdx.x == 0) {
    lo[j] = blo;
    hi[j] = bhi;
    block_row[j] = one_row_block ? blo : -1;
    block_cnt[j] = bcnt;
  }
  if (one_row_block) {
    // Every sub-block with a kept id is one-row (the same row): add their
    // sums in sub-block order. Plain loads: this CTA wrote them.
    for (int c = threadIdx.x; c < g; c += kThreads) {
      T acc = Cols<kVec4>::zero();
      for (int k = 0; k < kWarps; ++k) {
        if (s_cnt[k] > 0) {
          Cols<kVec4>::add(acc, sub_sum[static_cast<size_t>(j * kWarps + k) * g + c]);
        }
      }
      block_sum[static_cast<size_t>(j) * g + c] = acc;
    }
  }
}

// Pass 2. CTA (kRows rows of a node tile, column tile). The overlap
// predicate is the tile's (base = the tile's first row), so every CTA of a
// tile skips the blocks the reference's grid step for that tile skips.
template <bool kVec4>
__global__ void __launch_bounds__(kThreads)
tile_walk_kernel(const typename Cols<kVec4>::T* __restrict__ in,
                 const int* __restrict__ ids, const int* __restrict__ lo,
                 const int* __restrict__ hi, const int* __restrict__ block_row,
                 const int* __restrict__ block_cnt,
                 const int* __restrict__ sub_row,
                 const int* __restrict__ sub_cnt,
                 const typename Cols<kVec4>::T* __restrict__ sub_sum,
                 const typename Cols<kVec4>::T* __restrict__ block_sum,
                 typename Cols<kVec4>::T* __restrict__ sum,
                 float* __restrict__ count, int num_edges, int num_segments,
                 int num_blocks, int g) {
  using T = typename Cols<kVec4>::T;
  __shared__ T acc[kRows * kGroups];
  __shared__ int s_ids[kBE];
  __shared__ int s_sub[kWarps];
  __shared__ int s_cnt[kRows];
  __shared__ int s_lo[kStage], s_hi[kStage], s_row[kStage];

  const int row0 = blockIdx.x * kRows;  // this CTA's rows: [row0, row0 + kRows)
  const int base = row0 - row0 % kBN;   // its tile's first row
  const int w = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int c = blockIdx.y * kGroups + lane;  // this lane's column group
  const bool has_col = c < g;

  for (int k = threadIdx.x; k < kRows * kGroups; k += kThreads) {
    acc[k] = Cols<kVec4>::zero();
  }
  for (int k = threadIdx.x; k < kRows; k += kThreads) s_cnt[k] = 0;

  for (int j0 = 0; j0 < num_blocks; j0 += kStage) {
    const int nj = min(kStage, num_blocks - j0);
    __syncthreads();  // the previous round's ranges are no longer read
    for (int k = threadIdx.x; k < nj; k += kThreads) {
      s_lo[k] = __ldg(lo + j0 + k);
      s_hi[k] = __ldg(hi + j0 + k);
      s_row[k] = __ldg(block_row + j0 + k);
    }
    __syncthreads();
    for (int jj = 0; jj < nj; ++jj) {
      // _block_overlap(i, j): can edge block j's receivers touch tile i?
      if (!(s_hi[jj] >= base && s_lo[jj] < base + kBN)) continue;  // uniform
      const int j = j0 + jj;
      const int brow = s_row[jj];
      if (brow >= 0) {
        // One-row block: its sum, and those of the one-row blocks of the
        // same row right after it (up to 32), come from pass 1 in one batch
        // of loads.
        const int k = jj + lane;
        const bool same = k < nj && s_row[k] == brow;
        const unsigned run_mask = __ballot_sync(kFull, same);
        const int run = run_mask == kFull ? kWarp : __ffs(~run_mask) - 1;
        const int r = brow - row0;
        if (r >= 0 && r < kRows && r % kWarps == w) {  // uniform in the warp
          int cnt = lane < run ? __ldg(block_cnt + j + lane) : 0;
#pragma unroll
          for (int d = kWarp / 2; d > 0; d >>= 1) cnt += __shfl_xor_sync(kFull, cnt, d);
          if (has_col) {
            T a = acc[r * kGroups + lane];
            for (int i0 = 0; i0 < run; i0 += 8) {
              T v[8];
#pragma unroll
              for (int q = 0; q < 8; ++q) {
                if (i0 + q < run) v[q] = __ldg(block_sum + static_cast<size_t>(j + i0 + q) * g + c);
              }
#pragma unroll
              for (int q = 0; q < 8; ++q) {
                if (i0 + q < run) Cols<kVec4>::add(a, v[q]);
              }
            }
            acc[r * kGroups + lane] = a;
          }
          if (lane == 0) s_cnt[r] += cnt;
        }
        jj += run - 1;
        continue;
      }
      // A block of several rows: stage its ids.
      __syncthreads();  // the previous block's ids are no longer read
      for (int k = threadIdx.x; k < kBE; k += kThreads) {
        const int e = j * kBE + k;
        s_ids[k] = e < num_edges ? __ldg(ids + e) : -1;
      }
      if (threadIdx.x < kWarps) s_sub[threadIdx.x] = __ldg(sub_row + j * kWarps + threadIdx.x);
      __syncthreads();
      for (int s = 0; s < kWarps; ++s) {  // sub-blocks in edge order
        const int srow = s_sub[s];
        const int ebase = j * kBE + s * kSub;
        if (srow >= 0) {  // one-row sub-block: its sum from pass 1
          const int r = srow - row0;
          if (r >= 0 && r < kRows && r % kWarps == w) {  // uniform in the warp
            const int sb = j * kWarps + s;
            if (has_col) {
              Cols<kVec4>::add(acc[r * kGroups + lane],
                               __ldg(sub_sum + static_cast<size_t>(sb) * g + c));
            }
            if (lane == 0) s_cnt[r] += __ldg(sub_cnt + sb);
          }
          continue;
        }
        // The sub-block's 64 ids, one per lane and round; bit b of `hits`
        // is edge ebase + b, when its row is one of this warp's.
        static_assert(kRounds == 2, "a sub-block's hits fit one 64-bit mask");
        int r_of[kRounds];
        unsigned long long hits = 0;
#pragma unroll
        for (int q = 0; q < kRounds; ++q) {
          const int id = s_ids[s * kSub + q * kWarp + lane];
          r_of[q] = id - row0;
          const bool hit = id >= 0 && id < num_segments && r_of[q] >= 0 &&
                           r_of[q] < kRows && r_of[q] % kWarps == w;
          hits |= static_cast<unsigned long long>(__ballot_sync(kFull, hit)) << (q * kWarp);
        }
        // Hits in ascending edge order, 8 loads in flight.
        while (hits) {  // uniform in the warp
          int b[8];
          T v[8];
#pragma unroll
          for (int t = 0; t < 8; ++t) {
            b[t] = -1;
            if (hits) {
              b[t] = __ffsll(hits) - 1;
              hits &= hits - 1;
              if (has_col) v[t] = __ldg(in + static_cast<size_t>(ebase + b[t]) * g + c);
            }
          }
#pragma unroll
          for (int t = 0; t < 8; ++t) {
            if (b[t] >= 0) {  // uniform in the warp
              const int rr = __shfl_sync(kFull, b[t] < kWarp ? r_of[0] : r_of[1], b[t] % kWarp);
              if (has_col) Cols<kVec4>::add(acc[rr * kGroups + lane], v[t]);
              if (lane == 0) ++s_cnt[rr];
            }
          }
        }
      }
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < kRows * kGroups; k += kThreads) {
    const int row = row0 + k / kGroups;
    const int col = blockIdx.y * kGroups + k % kGroups;
    if (row < num_segments && col < g) sum[static_cast<size_t>(row) * g + col] = acc[k];
  }
  if (blockIdx.y == 0) {
    for (int k = threadIdx.x; k < kRows; k += kThreads) {
      if (row0 + k < num_segments) count[row0 + k] = static_cast<float>(s_cnt[k]);
    }
  }
}

template <bool kVec4>
int launch(const float* data, const int* ids, float* sum, float* count,
           int* iscratch, float* fscratch, int num_segments, int num_edges,
           int g, cudaStream_t st) {
  using T = typename Cols<kVec4>::T;
  const int num_blocks = (num_edges + kBE - 1) / kBE;
  int* lo = iscratch;
  int* hi = lo + num_blocks;
  int* block_row = hi + num_blocks;
  int* block_cnt = block_row + num_blocks;
  int* sub_row = block_cnt + num_blocks;
  int* sub_cnt = sub_row + num_blocks * kWarps;
  T* sub_sum = reinterpret_cast<T*>(fscratch);
  T* block_sum = sub_sum + static_cast<size_t>(num_blocks) * kWarps * g;
  const T* in = reinterpret_cast<const T*>(data);
  if (num_blocks > 0) {
    block_ranges_kernel<kVec4><<<num_blocks, kThreads, 0, st>>>(
        in, ids, lo, hi, block_row, block_cnt, sub_row, sub_cnt, sub_sum,
        block_sum, num_edges, num_segments, g);
  }
  const dim3 grid((num_segments + kRows - 1) / kRows, g > 0 ? (g + kGroups - 1) / kGroups : 1);
  tile_walk_kernel<kVec4><<<grid, kThreads, 0, st>>>(
      in, ids, lo, hi, block_row, block_cnt, sub_row, sub_cnt, sub_sum,
      block_sum, reinterpret_cast<T*>(sum), count, num_edges, num_segments,
      num_blocks, g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Scratch sizes for num_edges rows of f floats: `iscratch` holds
// (4 + 2 * 8) * ceil(num_edges / 512) ints, `fscratch` 9 * ceil(num_edges /
// 512) * f floats (the sub-block and block sums).
extern "C" int segment_skip_block_edges(void) { return kBE; }
extern "C" int segment_skip_tile_rows(void) { return kBN; }
extern "C" int segment_skip_sub_blocks(void) { return kWarps; }

// Plain C entry point, bound from Python with ctypes. `data` is [num_edges,
// f], `ids` [num_edges]. Launches on `stream` and does not synchronise;
// returns cudaGetLastError() after the launches (0 is success).
extern "C" int segment_skip_sum_count_f32(const float* data, const int* ids,
                                          float* sum, float* count,
                                          int* iscratch, float* fscratch,
                                          int num_segments, int num_edges,
                                          int f, int vec4, void* stream) {
  if (num_segments <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec4) {
    return launch<true>(data, ids, sum, count, iscratch, fscratch,
                        num_segments, num_edges, f / 4, st);
  }
  return launch<false>(data, ids, sum, count, iscratch, fscratch,
                       num_segments, num_edges, f, st);
}
