// K1, CSR segment (sum, count): the Hopper kernel behind every row_ptr-carrying
// segment sum of the port (the readout mean pool over graph_ptr, and the
// SAGE/GIN/MFC/GAT/CGCNN aggregations; PNA's passes go to K5, csr_stats.cu).
//
// Replaces: hydragnn_tpu/ops/pallas_segment.py, _csr_kernel (launched by
// _csr_sum_count_pallas). That TPU kernel builds a one-hot
// (row_start[n] <= e < row_end[n]) tile per (node block, edge block) and
// multiplies it into the edge data on the MXU, with a bf16 hi/lo split so
// the bf16 MXU reaches f32 accuracy. None of that is carried over: f32 adds
// are native on the card, so the kernel walks the runs (csr_lanes.cuh).
// Its gradient is a gather done by the caller.
//
// Bound on an H100 SXM: memory. It reads each walked row once and writes
// each output once: E*F*4 + N*F*4 + N*4 + (N+1)*4 bytes at 3.35 TB/s; the
// E*F adds are far below the f32 rate. At the port's shapes the bound is
// 0.07-25 us, so latency decides: the design (csr_lanes.cuh) keeps every
// lane of a warp loading (lane groups: at F = 1 a warp reads 32 entries in
// one load, at F = 64 two rows of 16 float4s), gives each warp one short run
// or one piece of 32 to 256 entries of a long run, and merges
// a long run's pieces in a fan-in-32 tree inside the same launch, so a call
// is one launch with no serial sum of a long run's partials.

#include <cuda_runtime.h>

#include "csr_lanes.cuh"

namespace {

using namespace csr_lanes;

template <bool kVec4>
__device__ __forceinline__ void walk_sum(const typename Cols<kVec4>::T* __restrict__ in,
                                         const Geo& geo, const Lane& l, const ColPair& c,
                                         int a, int b, typename Cols<kVec4>::T& x0,
                                         typename Cols<kVec4>::T& x1) {
  using C = Cols<kVec4>;
  x0 = C::fill(0.f);
  x1 = C::fill(0.f);
#pragma unroll 8
  for (int e = a + l.sub; e < b; e += geo.s) {
    const typename C::T* row = in + static_cast<size_t>(e) * geo.g;
    if (c.v0) x0 = C::map(x0, __ldg(row + c.c0), Add());
    if (c.v1) x1 = C::map(x1, __ldg(row + c.c1), Add());
  }
  x0 = across<kVec4>(x0, geo.w, Add());
  x1 = across<kVec4>(x1, geo.w, Add());
}

template <bool kVec4>
__device__ void sum_piece(const typename Cols<kVec4>::T* __restrict__ in,
                          typename Cols<kVec4>::T* __restrict__ sum,
                          typename Cols<kVec4>::T* __restrict__ part, int* tickets,
                          const Geo& geo, const Lane& l, int first, const Run& run, int j, int a,
                          int b) {
  using T = typename Cols<kVec4>::T;
  for (int cb = 0; cb < geo.g; cb += 2 * geo.w) {
    const ColPair c = cols_at(geo, l, cb);
    T x0, x1;
    walk_sum<kVec4>(in, geo, l, c, a, b, x0, x1);
    T* dst = part + static_cast<size_t>(slot_of(run, j)) * geo.g;
    if (l.sub == 0 && c.v0) __stcg(dst + c.c0, x0);
    if (l.sub == 0 && c.v1) __stcg(dst + c.c1, x1);
  }
  climb(geo, run, j, tickets, l.lane, [&](int span, int c0, int children, bool root) {
    for (int cb = 0; cb < geo.g; cb += 2 * geo.w) {
      const ColPair c = cols_at(geo, l, cb);
      T x0 = Cols<kVec4>::fill(0.f), x1 = Cols<kVec4>::fill(0.f);
      // Sub-group b adds children b, b + s, ...; then the fixed tree.
#pragma unroll 8
      for (int k = l.sub; k < children; k += geo.s) {
        const T* src = part + static_cast<size_t>(slot_of(run, (c0 + k) * span)) * geo.g;
        if (c.v0) x0 = Cols<kVec4>::map(x0, __ldcg(src + c.c0), Add());
        if (c.v1) x1 = Cols<kVec4>::map(x1, __ldcg(src + c.c1), Add());
      }
      x0 = across<kVec4>(x0, geo.w, Add());
      x1 = across<kVec4>(x1, geo.w, Add());
      T* dst = root ? sum + static_cast<size_t>(run.row) * geo.g
                    : part + static_cast<size_t>(slot_of(run, c0 * span)) * geo.g;
      if (l.sub == 0 && c.v0) __stcg(dst + c.c0, x0);
      if (l.sub == 0 && c.v1) __stcg(dst + c.c1, x1);
    }
  });
}

template <bool kVec4>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
csr_lanes_sum_kernel(const typename Cols<kVec4>::T* __restrict__ in,
                     const int* __restrict__ row_ptr, typename Cols<kVec4>::T* __restrict__ sum,
                     float* __restrict__ count, typename Cols<kVec4>::T* __restrict__ part,
                     int* __restrict__ tickets, int n, Geo geo) {
  using T = typename Cols<kVec4>::T;
  const int warp = blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  const Lane l = lane_of(geo);
  const int first = __ldg(row_ptr);
  if (warp < geo.chunks) {
    const int last = __ldg(row_ptr + n);
    const int a0 = first + warp * geo.piece;
    if (a0 >= last) return;
    const int a1 = min(a0 + geo.piece, last);
    int r = row_of(row_ptr, n, a0, l.lane);
    int s = __ldg(row_ptr + r), t = __ldg(row_ptr + r + 1);
    if (t - s > geo.piece && s < a0) {
      const Run run = long_run(geo, first, r, s, t);
      sum_piece<kVec4>(in, sum, part, tickets, geo, l, first, run, warp - run.ks, a0, min(t, a1));
    }
    if (t < a1) {
      r = row_of(row_ptr, n, a1 - 1, l.lane);
      s = __ldg(row_ptr + r);
      t = __ldg(row_ptr + r + 1);
    }
    if (t - s > geo.piece && s >= a0) {
      sum_piece<kVec4>(in, sum, part, tickets, geo, l, first, long_run(geo, first, r, s, t), 0,
                       s, a1);
    }
    return;
  }
  const int row = warp - geo.chunks;
  if (row >= n) return;
  const int s = __ldg(row_ptr + row), t = __ldg(row_ptr + row + 1);
  if (l.lane == 0) count[row] = static_cast<float>(t - s);
  if (t - s > geo.piece) return;  // its pieces write the sum
  T* out = sum + static_cast<size_t>(row) * geo.g;
  for (int cb = 0; cb < geo.g; cb += 2 * geo.w) {
    const ColPair c = cols_at(geo, l, cb);
    T x0, x1;
    walk_sum<kVec4>(in, geo, l, c, s, t, x0, x1);
    if (l.sub == 0 && c.v0) out[c.c0] = x0;
    if (l.sub == 0 && c.v1) out[c.c1] = x1;
  }
}

template <bool kVec4>
void launch(const float* data, const int* row_ptr, float* sum, float* count, float* scratch,
            int* tickets, int n, const Geo& geo, cudaStream_t stream) {
  using T = typename Cols<kVec4>::T;
  const long long warps = static_cast<long long>(geo.chunks) + n;
  const dim3 grid(static_cast<unsigned>((warps + kWarpsPerBlock - 1) / kWarpsPerBlock));
  csr_lanes_sum_kernel<kVec4><<<grid, kWarp * kWarpsPerBlock, 0, stream>>>(
      reinterpret_cast<const T*>(data), row_ptr, reinterpret_cast<T*>(sum), count,
      reinterpret_cast<T*>(scratch), tickets, n, geo);
}

}  // namespace

// Plain C entry point, bound from Python with ctypes. `data` is
// [num_entries, f]; `scratch` and `tickets` are sized by csr_lanes_scratch
// (parts = 1). One launch on `stream`, no synchronisation; returns
// cudaGetLastError() after it (0 is success), so a refused launch is
// reported to the caller.
extern "C" int csr_segment_sum_count_f32(const float* data, const int* row_ptr, float* sum,
                                         float* count, float* scratch, int* tickets,
                                         int num_segments, int num_entries, int f, int vec4,
                                         void* stream) {
  if (num_segments <= 0) return static_cast<int>(cudaSuccess);
  const csr_lanes::Geo geo = csr_lanes::geometry(num_entries, f, vec4 != 0);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec4) {
    launch<true>(data, row_ptr, sum, count, scratch, tickets, num_segments, geo, s);
  } else {
    launch<false>(data, row_ptr, sum, count, scratch, tickets, num_segments, geo, s);
  }
  return static_cast<int>(cudaGetLastError());
}
