// The CSR run walk shared by the port's segment kernels: per-row (sum, count)
// over the runs [row_ptr[n], row_ptr[n+1]) of a list of data rows.
//
// Row k of the list is data row k (csr_segment.cu: destination-sorted edges)
// or data row perm[k] (segment_sum_count.cu: a permutation that groups
// unsorted ids by segment), chosen at compile time by kGather.
//
// Computes, for n < num_segments:
//   sum[n, :] = sum over k in [row_ptr[n], row_ptr[n+1]) of data[row(k), :]
//   count[n]  = row_ptr[n+1] - row_ptr[n]           (exact, no reduction)
// Rows with no entries write zeros. No atomics: every output element is
// written once by one thread, in a fixed order, so results are
// bit-reproducible from run to run.
//
// Two launches on one stream:
//  1. long_run_partials_kernel, one warp per chunk of kChunk list entries
//     (chunks start at row_ptr[0]). Runs longer than kChunk are split at
//     chunk boundaries: a chunk sums the part of the long run that holds its
//     first entry when that run began before the chunk ("head"), and the part
//     of the long run that holds its last entry when that run began inside
//     the chunk ("tail"). A chunk has at most one of each, since a long run
//     cannot fit inside a chunk. Chunks without long runs exit after two
//     binary searches.
//  2. csr_sum_count_kernel, one warp per row, kRowsPerBlock rows per block.
//     A run of at most kChunk entries is walked by its warp; a long run that
//     starts in chunk ks and ends in chunk ke is tail[ks] + head[ks+1] + ...
//     + head[ke], added in that order.
// The split exists for runs of thousands of entries (collation's padding
// node owns every padding edge, ~14k at 256 flagship graphs): one warp alone
// would walk such a run serially on every launch.
//
// Lane l owns column groups l, l+32, ...; a group is a float4 (16-byte load)
// when F % 4 == 0 and every pointer is 16-byte aligned, else one float.

#pragma once

#include <cuda_runtime.h>

namespace csr_walk {

constexpr int kWarp = 32;
constexpr int kRowsPerBlock = 8;  // warps per block, in both kernels
constexpr int kChunk = 128;       // runs longer than this are split

template <bool kVec4>
struct Cols;

template <>
struct Cols<true> {
  using T = float4;
  static __device__ __forceinline__ T zero() {
    return make_float4(0.f, 0.f, 0.f, 0.f);
  }
  static __device__ __forceinline__ void add(T& a, const T& b) {
    a.x += b.x;
    a.y += b.y;
    a.z += b.z;
    a.w += b.w;
  }
};

template <>
struct Cols<false> {
  using T = float;
  static __device__ __forceinline__ T zero() { return 0.f; }
  static __device__ __forceinline__ void add(T& a, const T& b) { a += b; }
};

// The data row behind list entry k.
template <bool kGather>
__device__ __forceinline__ int row_at(const int* __restrict__ perm, int k) {
  if constexpr (kGather) {
    return __ldg(perm + k);
  } else {
    return k;
  }
}

// Sum of list entries [a, b) (g groups per row) at column group c, in list
// order.
template <bool kVec4, bool kGather>
__device__ __forceinline__ typename Cols<kVec4>::T walk(
    const typename Cols<kVec4>::T* __restrict__ in,
    const int* __restrict__ perm, int a, int b, int g, int c) {
  typename Cols<kVec4>::T acc = Cols<kVec4>::zero();
#pragma unroll 4
  for (int k = a; k < b; ++k) {
    const size_t row = static_cast<size_t>(row_at<kGather>(perm, k));
    Cols<kVec4>::add(acc, __ldg(in + row * g + c));
  }
  return acc;
}

// The row whose run holds entry v: the last r with row_ptr[r] <= v, for
// row_ptr[0] <= v < row_ptr[n].
__device__ __forceinline__ int row_of(const int* __restrict__ row_ptr, int n,
                                      int v) {
  int lo = 0, hi = n;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(row_ptr + mid) <= v) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  return lo;
}

template <bool kVec4, bool kGather>
__global__ void __launch_bounds__(kWarp * kRowsPerBlock)
long_run_partials_kernel(const typename Cols<kVec4>::T* __restrict__ in,
                         const int* __restrict__ perm,
                         const int* __restrict__ row_ptr,
                         typename Cols<kVec4>::T* __restrict__ head,
                         typename Cols<kVec4>::T* __restrict__ tail,
                         int num_segments, int num_chunks, int g) {
  const int k = blockIdx.x * kRowsPerBlock + (threadIdx.x / kWarp);
  const int lane = threadIdx.x % kWarp;
  if (k >= num_chunks) return;
  const int first = __ldg(row_ptr);
  const int last = __ldg(row_ptr + num_segments);
  const int c0 = first + k * kChunk;
  if (c0 >= last) return;
  const int c1 = min(c0 + kChunk, last);

  int r = row_of(row_ptr, num_segments, c0);
  int s = __ldg(row_ptr + r);
  int t = __ldg(row_ptr + r + 1);
  if (t - s > kChunk && s < c0) {
    const int b = min(t, c1);
    for (int c = lane; c < g; c += kWarp) {
      head[static_cast<size_t>(k) * g + c] =
          walk<kVec4, kGather>(in, perm, c0, b, g, c);
    }
  }
  if (t < c1) {  // else the run holding c0 also holds the chunk's last entry
    r = row_of(row_ptr, num_segments, c1 - 1);
    s = __ldg(row_ptr + r);
    t = __ldg(row_ptr + r + 1);
  }
  if (t - s > kChunk && s >= c0) {
    for (int c = lane; c < g; c += kWarp) {
      tail[static_cast<size_t>(k) * g + c] =
          walk<kVec4, kGather>(in, perm, s, c1, g, c);
    }
  }
}

template <bool kVec4, bool kGather>
__global__ void __launch_bounds__(kWarp * kRowsPerBlock)
csr_sum_count_kernel(const typename Cols<kVec4>::T* __restrict__ in,
                     const int* __restrict__ perm,
                     const int* __restrict__ row_ptr,
                     const typename Cols<kVec4>::T* __restrict__ head,
                     const typename Cols<kVec4>::T* __restrict__ tail,
                     typename Cols<kVec4>::T* __restrict__ sum,
                     float* __restrict__ count, int num_segments, int g) {
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x / kWarp);
  const int lane = threadIdx.x % kWarp;
  if (row >= num_segments) return;
  const int s = __ldg(row_ptr + row);
  const int t = __ldg(row_ptr + row + 1);
  if (lane == 0) count[row] = static_cast<float>(t - s);
  typename Cols<kVec4>::T* __restrict__ out = sum + static_cast<size_t>(row) * g;
  if (t - s <= kChunk) {
    for (int c = lane; c < g; c += kWarp) {
      out[c] = walk<kVec4, kGather>(in, perm, s, t, g, c);
    }
    return;
  }
  const int first = __ldg(row_ptr);
  const int ks = (s - first) / kChunk;
  const int ke = (t - 1 - first) / kChunk;
  for (int c = lane; c < g; c += kWarp) {
    typename Cols<kVec4>::T acc = __ldg(tail + static_cast<size_t>(ks) * g + c);
#pragma unroll 4
    for (int k = ks + 1; k <= ke; ++k) {
      Cols<kVec4>::add(acc, __ldg(head + static_cast<size_t>(k) * g + c));
    }
    out[c] = acc;
  }
}

template <bool kVec4, bool kGather>
void launch_walk(const float* data, const int* perm, const int* row_ptr,
                 float* sum, float* count, float* scratch, int num_segments,
                 int num_chunks, int g, cudaStream_t s) {
  using T = typename Cols<kVec4>::T;
  const T* in = reinterpret_cast<const T*>(data);
  T* head = reinterpret_cast<T*>(scratch);
  T* tail = head + static_cast<size_t>(num_chunks) * g;
  const dim3 block(kWarp * kRowsPerBlock);
  if (num_chunks > 0) {
    const dim3 grid((num_chunks + kRowsPerBlock - 1) / kRowsPerBlock);
    long_run_partials_kernel<kVec4, kGather><<<grid, block, 0, s>>>(
        in, perm, row_ptr, head, tail, num_segments, num_chunks, g);
  }
  const dim3 grid((num_segments + kRowsPerBlock - 1) / kRowsPerBlock);
  csr_sum_count_kernel<kVec4, kGather><<<grid, block, 0, s>>>(
      in, perm, row_ptr, head, tail, reinterpret_cast<T*>(sum), count,
      num_segments, g);
}

// (sum, count) over the runs of row_ptr, list entries of num_entries rows
// (scratch: 2 * ceil(num_entries / kChunk) * f floats for the partials).
template <bool kGather>
void sum_count(const float* data, const int* perm, const int* row_ptr,
               float* sum, float* count, float* scratch, int num_segments,
               int num_entries, int f, bool vec4, cudaStream_t s) {
  const int num_chunks = (num_entries + kChunk - 1) / kChunk;
  if (vec4) {
    launch_walk<true, kGather>(data, perm, row_ptr, sum, count, scratch,
                               num_segments, num_chunks, f / 4, s);
  } else {
    launch_walk<false, kGather>(data, perm, row_ptr, sum, count, scratch,
                                num_segments, num_chunks, f, s);
  }
}

}  // namespace csr_walk
