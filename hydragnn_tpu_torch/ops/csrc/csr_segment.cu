// CSR segment (sum, count): the Hopper kernel behind every row_ptr-carrying
// segment reduction of the port (PNA mean and centred-std passes, the
// readout mean pool over graph_ptr).
//
// Replaces: hydragnn_tpu/ops/pallas_segment.py, _csr_kernel (launched by
// _csr_sum_count_pallas). That TPU kernel builds a one-hot
// (row_start[n] <= e < row_end[n]) tile per (node block, edge block) and
// multiplies it into the edge data on the MXU, with a bf16 hi/lo split and
// f-packing so the bf16 MXU reaches f32 accuracy. None of that is carried
// over: f32 adds are native on the card, so the kernel simply walks runs.
//
// Computes, for n < num_segments:
//   sum[n, :] = sum over e in [row_ptr[n], row_ptr[n+1]) of data[e, :]
//   count[n]  = row_ptr[n+1] - row_ptr[n]           (exact, no reduction)
// Rows with no edges write zeros. No atomics: every output element is
// written once by one thread, in a fixed order, so results are
// bit-reproducible from run to run.
//
// Two launches on one stream:
//  1. long_run_partials_kernel, one warp per chunk of kChunk edges (chunks
//     start at row_ptr[0]). Runs longer than kChunk edges are split at chunk
//     boundaries: a chunk sums the part of the long run that holds its first
//     edge when that run began before the chunk ("head"), and the part of
//     the long run that holds its last edge when that run began inside the
//     chunk ("tail"). A chunk has at most one of each, since a long run
//     cannot fit inside a chunk. Chunks without long runs exit after two
//     binary searches.
//  2. csr_sum_count_kernel, one warp per row, kRowsPerBlock rows per block.
//     A run of at most kChunk edges is walked by its warp; a long run that
//     starts in chunk ks and ends in chunk ke is tail[ks] + head[ks+1] + ...
//     + head[ke], added in that order.
// The split exists for collation's padding node, which owns every padding
// edge (~14k at 256 flagship graphs): one warp alone would walk that run
// serially on every launch.
//
// Lane l owns column groups l, l+32, ...; a group is a float4 (16-byte load)
// when F % 4 == 0 and every pointer is 16-byte aligned, else one float.
//
// Bound on an H100 SXM: memory. It reads each edge row once and writes each
// output once: E*F*4 + N*F*4 + N*4 + (N+1)*4 bytes at 3.35 TB/s; the E*F
// adds are far below the f32 rate. What this simple design leaves on the
// table: for F < 128 part of each warp idles (half of it at F = 64, 31 of
// 32 lanes at F = 1) where lane groups could walk several edges at once;
// each warp's walk is a chain of dependent load rounds (unrolled by 4), so
// short runs are latency-bound; the binary searches of pass 1 and the
// serial sum of a long run's partials in pass 2 are further latency chains;
// and the two passes are two launches.

#include <cuda_runtime.h>

namespace {

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

// Sum of rows [a, b) of `in` (g groups per row) at column group c, in edge
// order.
template <bool kVec4>
__device__ __forceinline__ typename Cols<kVec4>::T walk(
    const typename Cols<kVec4>::T* __restrict__ in, int a, int b, int g, int c) {
  typename Cols<kVec4>::T acc = Cols<kVec4>::zero();
#pragma unroll 4
  for (int e = a; e < b; ++e) {
    Cols<kVec4>::add(acc, __ldg(in + static_cast<size_t>(e) * g + c));
  }
  return acc;
}

// The row whose run holds edge v: the last r with row_ptr[r] <= v, for
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

template <bool kVec4>
__global__ void __launch_bounds__(kWarp * kRowsPerBlock)
long_run_partials_kernel(const typename Cols<kVec4>::T* __restrict__ in,
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
      head[static_cast<size_t>(k) * g + c] = walk<kVec4>(in, c0, b, g, c);
    }
  }
  if (t < c1) {  // else the run holding c0 also holds the chunk's last edge
    r = row_of(row_ptr, num_segments, c1 - 1);
    s = __ldg(row_ptr + r);
    t = __ldg(row_ptr + r + 1);
  }
  if (t - s > kChunk && s >= c0) {
    for (int c = lane; c < g; c += kWarp) {
      tail[static_cast<size_t>(k) * g + c] = walk<kVec4>(in, s, c1, g, c);
    }
  }
}

template <bool kVec4>
__global__ void __launch_bounds__(kWarp * kRowsPerBlock)
csr_sum_count_kernel(const typename Cols<kVec4>::T* __restrict__ in,
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
    for (int c = lane; c < g; c += kWarp) out[c] = walk<kVec4>(in, s, t, g, c);
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

template <bool kVec4>
void launch(const float* data, const int* row_ptr, float* sum, float* count,
            float* scratch, int num_segments, int num_chunks, int g,
            cudaStream_t s) {
  using T = typename Cols<kVec4>::T;
  const T* in = reinterpret_cast<const T*>(data);
  T* head = reinterpret_cast<T*>(scratch);
  T* tail = head + static_cast<size_t>(num_chunks) * g;
  const dim3 block(kWarp * kRowsPerBlock);
  if (num_chunks > 0) {
    const dim3 grid((num_chunks + kRowsPerBlock - 1) / kRowsPerBlock);
    long_run_partials_kernel<kVec4><<<grid, block, 0, s>>>(
        in, row_ptr, head, tail, num_segments, num_chunks, g);
  }
  const dim3 grid((num_segments + kRowsPerBlock - 1) / kRowsPerBlock);
  csr_sum_count_kernel<kVec4><<<grid, block, 0, s>>>(
      in, row_ptr, head, tail, reinterpret_cast<T*>(sum), count, num_segments,
      g);
}

}  // namespace

// Edges per chunk: the caller sizes `scratch` as
// 2 * ceil(num_edges / chunk) * f floats.
extern "C" int csr_segment_chunk_edges(void) { return kChunk; }

// Plain C entry point, bound from Python with ctypes. `data` is [num_edges,
// f]; `scratch` holds the chunks' head and tail partials. Launches on
// `stream` and does not synchronise; returns cudaGetLastError() after the
// launches (0 is success), so a refused launch is reported to the caller.
extern "C" int csr_segment_sum_count_f32(const float* data, const int* row_ptr,
                                         float* sum, float* count,
                                         float* scratch, int num_segments,
                                         int num_edges, int f, int vec4,
                                         void* stream) {
  if (num_segments <= 0) return static_cast<int>(cudaSuccess);
  const int num_chunks = (num_edges + kChunk - 1) / kChunk;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec4) {
    launch<true>(data, row_ptr, sum, count, scratch, num_segments, num_chunks,
                 f / 4, s);
  } else {
    launch<false>(data, row_ptr, sum, count, scratch, num_segments,
                  num_chunks, f, s);
  }
  return static_cast<int>(cudaGetLastError());
}
