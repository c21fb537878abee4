// K5, the CSR stats kernel: PNA's whole aggregation bundle in one launch.
// Per segment n of destination-sorted messages over the runs
// [row_ptr[n], row_ptr[n+1]) it gives
//   sum   = Σ x_e (masked rows zeroed),     count = row_ptr[n+1] - row_ptr[n],
//   mean  = sum / max(count, 1),
//   std   = sqrt(Σ (x_e - mean)² / max(count, 1) + eps)  (masked rows as 0),
//   min, max over the rows the mask keeps (0 where it keeps none).
//
// Replaces: hydragnn_tpu/ops/pallas_segment.py, _stats_forward_pallas on
// the CSR route (two launches of _csr_kernel, the (sum, count) pass and the
// centred pass over a materialised [E, F] square, with gathers of the mean
// between them) and segment_extrema (plain XLA segment_min/segment_max on
// the TPU; scatter_reduce in the port before this kernel). In the port
// that bundle was two K1 calls of two launches each, about a dozen
// elementwise and gather launches, and per extreme a fill, a masking
// where, a scatter_reduce and a fix-up where: about 35 launches per PNA
// layer.
//
// Bound on an H100 SXM: memory. It reads the mask, row_ptr and the kept
// rows of the messages once (a masked row enters only as its mask byte)
// and writes five [N, F] outputs and the count:
// K*F*4 + E + (N+1)*4 + 5*N*F*4 + N*4 bytes for K kept of E rows, at
// 3.35 TB/s (4.58 us at the flagship's E=32768, K=18588, N=8192, F=64);
// the ~6 flops per kept element are far below the f32 rate.
//
// Design: the lane-group walk of csr_lanes.cuh (one launch, fixed-order
// reductions, bit-reproducible). A warp reduces a run (or a piece of a long
// run) in two passes over the same rows: sum, min and max, then, with the
// mean in hand, Σ (x - mean)² over rows it read a moment ago (L1/L2). So no
// centred [E, F] tensor reaches device memory. Long runs: each piece gives
// (n, sum, M2 about its own mean, min, max), and the tree merges pieces with
// Chan's formula, M2 = M2a + M2b + (mean_b - mean_a)² na nb / (na + nb), in
// child order. That was chosen over a phase that completes each long run's
// mean before a second centred walk: the merge needs no extra pass and no
// grid-wide wait, keeps the centred form (no Σx² - n·mean² cancellation),
// and its rounding is that of a pairwise sum (it meets KERNEL_CERT_GATE
// against f64 on phase 2d's 20000-edge run and hub).

#include <cuda_runtime.h>

#include "csr_lanes.cuh"

namespace {

using namespace csr_lanes;

struct Mul {
  __device__ __forceinline__ float operator()(float a, float b) const { return a * b; }
};
struct Div {
  __device__ __forceinline__ float operator()(float a, float b) const { return a / b; }
};
struct Sub {
  __device__ __forceinline__ float operator()(float a, float b) const { return a - b; }
};

// Running stats of one column group: sum, M2 about the mean, min, max.
template <bool kVec4>
struct Acc {
  using T = typename Cols<kVec4>::T;
  T sum, m2, mn, mx;
};

template <bool kVec4>
__device__ __forceinline__ Acc<kVec4> empty_acc() {
  using C = Cols<kVec4>;
  return Acc<kVec4>{C::fill(0.f), C::fill(0.f), C::fill(kBig), C::fill(-kBig)};
}

// Chan's merge of M2: a holds na rows, b nb rows (either may be 0).
struct ChanM2 {
  float wa, wb, w;  // 1/na, 1/nb, na nb / (na + nb)
  __device__ __forceinline__ float operator()(float sa, float sb, float ma, float mb) const {
    const float d = sb * wb - sa * wa;
    return ma + mb + d * d * w;
  }
};

template <bool kVec4>
__device__ __forceinline__ Acc<kVec4> merge(const Acc<kVec4>& a, int na, const Acc<kVec4>& b,
                                            int nb) {
  if (nb == 0) return a;
  if (na == 0) return b;
  using C = Cols<kVec4>;
  const float fa = static_cast<float>(na), fb = static_cast<float>(nb);
  const ChanM2 chan{1.f / fa, 1.f / fb, fa * fb / (fa + fb)};
  Acc<kVec4> out;
  if constexpr (kVec4) {
    out.m2 = make_float4(chan(a.sum.x, b.sum.x, a.m2.x, b.m2.x), chan(a.sum.y, b.sum.y, a.m2.y, b.m2.y),
                         chan(a.sum.z, b.sum.z, a.m2.z, b.m2.z), chan(a.sum.w, b.sum.w, a.m2.w, b.m2.w));
  } else {
    out.m2 = chan(a.sum, b.sum, a.m2, b.m2);
  }
  out.sum = C::map(a.sum, b.sum, Add());
  out.mn = C::map(a.mn, b.mn, Min());
  out.mx = C::map(a.mx, b.mx, Max());
  return out;
}

// The xor tree over sub-groups for Chan merges; n is this lane's row count.
template <bool kVec4>
__device__ __forceinline__ Acc<kVec4> across_chan(Acc<kVec4> a, int& n, int w) {
  using C = Cols<kVec4>;
  for (int m = w; m < kWarp; m <<= 1) {
    Acc<kVec4> b{C::shfl(a.sum, m), C::shfl(a.m2, m), C::shfl(a.mn, m), C::shfl(a.mx, m)};
    const int nb = __shfl_xor_sync(kFull, n, m);
    a = merge<kVec4>(a, n, b, nb);
    n += nb;
  }
  return a;
}

// Stats of entries [a, b) at this lane's two column groups, every lane
// holding the warp's result: pass 1 sum, min, max; pass 2 Σ (x - mean)²
// with mean = sum / max(b - a, 1).
template <bool kVec4>
__device__ __forceinline__ void walk_stats(const typename Cols<kVec4>::T* __restrict__ in,
                                           const unsigned char* __restrict__ mask,
                                           const Geo& geo, const Lane& l, const ColPair& c,
                                           int a, int b, bool want_std, Acc<kVec4> (&st)[2]) {
  using C = Cols<kVec4>;
  using T = typename C::T;
  st[0] = empty_acc<kVec4>();
  st[1] = empty_acc<kVec4>();
#pragma unroll 8
  for (int e = a + l.sub; e < b; e += geo.s) {
    // Every load is issued whatever the mask says, so none waits on it.
    const bool keep = mask == nullptr || __ldg(mask + e);
    const T* row = in + static_cast<size_t>(e) * geo.g;
    if (c.v0) {
      const T v = __ldg(row + c.c0);
      st[0].sum = C::map(st[0].sum, keep ? v : C::fill(0.f), Add());
      st[0].mn = C::map(st[0].mn, keep ? v : C::fill(kBig), Min());
      st[0].mx = C::map(st[0].mx, keep ? v : C::fill(-kBig), Max());
    }
    if (c.v1) {
      const T v = __ldg(row + c.c1);
      st[1].sum = C::map(st[1].sum, keep ? v : C::fill(0.f), Add());
      st[1].mn = C::map(st[1].mn, keep ? v : C::fill(kBig), Min());
      st[1].mx = C::map(st[1].mx, keep ? v : C::fill(-kBig), Max());
    }
  }
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    st[q].sum = across<kVec4>(st[q].sum, geo.w, Add());
    st[q].mn = across<kVec4>(st[q].mn, geo.w, Min());
    st[q].mx = across<kVec4>(st[q].mx, geo.w, Max());
  }
  if (!want_std) return;
  const T denom = C::fill(static_cast<float>(max(b - a, 1)));
  const T mean0 = C::map(st[0].sum, denom, Div());
  const T mean1 = C::map(st[1].sum, denom, Div());
#pragma unroll 8
  for (int e = a + l.sub; e < b; e += geo.s) {
    const bool keep = mask == nullptr || __ldg(mask + e);
    const T* row = in + static_cast<size_t>(e) * geo.g;
    if (c.v0) {
      const T d = C::map(keep ? __ldg(row + c.c0) : C::fill(0.f), mean0, Sub());
      st[0].m2 = C::map(st[0].m2, C::map(d, d, Mul()), Add());
    }
    if (c.v1) {
      const T d = C::map(keep ? __ldg(row + c.c1) : C::fill(0.f), mean1, Sub());
      st[1].m2 = C::map(st[1].m2, C::map(d, d, Mul()), Add());
    }
  }
  st[0].m2 = across<kVec4>(st[0].m2, geo.w, Add());
  st[1].m2 = across<kVec4>(st[1].m2, geo.w, Add());
}

struct Out {
  float* sum;
  float* mean;
  float* std;
  float* mn;  // null: no extrema wanted
  float* mx;
  float eps;
  bool want_std;
};

struct Fill {
  float limit;  // an extreme still beyond half the start value: no row kept
  __device__ __forceinline__ float operator()(float v, float) const {
    return (limit > 0.f ? v >= limit : v <= limit) ? 0.f : v;
  }
};

struct StdOf {
  float eps;
  __device__ __forceinline__ float operator()(float m2, float denom) const {
    return sqrtf(m2 / denom + eps);
  }
};

// A row's outputs at column group col from its stats over n rows.
template <bool kVec4>
__device__ __forceinline__ void write_row(const Out& o, int g, int row, int col,
                                          const Acc<kVec4>& st, int n) {
  using C = Cols<kVec4>;
  using T = typename C::T;
  const size_t at = static_cast<size_t>(row) * g + col;
  const T denom = C::fill(static_cast<float>(max(n, 1)));
  reinterpret_cast<T*>(o.sum)[at] = st.sum;
  reinterpret_cast<T*>(o.mean)[at] = C::map(st.sum, denom, Div());
  reinterpret_cast<T*>(o.std)[at] = o.want_std ? C::map(st.m2, denom, StdOf{o.eps}) : C::fill(0.f);
  if (o.mn != nullptr) {
    reinterpret_cast<T*>(o.mn)[at] = C::map(st.mn, st.mn, Fill{kBig / 2});
    reinterpret_cast<T*>(o.mx)[at] = C::map(st.mx, st.mx, Fill{-kBig / 2});
  }
}

template <bool kVec4>
__device__ __forceinline__ typename Cols<kVec4>::T* part_at(typename Cols<kVec4>::T* part,
                                                            const Geo& geo, int slot, int k) {
  return part + (static_cast<size_t>(slot) * 4 + k) * geo.g;
}

template <bool kVec4>
__device__ __forceinline__ void store_part(typename Cols<kVec4>::T* part, const Geo& geo,
                                           int slot, int col, const Acc<kVec4>& st) {
  __stcg(part_at<kVec4>(part, geo, slot, 0) + col, st.sum);
  __stcg(part_at<kVec4>(part, geo, slot, 1) + col, st.m2);
  __stcg(part_at<kVec4>(part, geo, slot, 2) + col, st.mn);
  __stcg(part_at<kVec4>(part, geo, slot, 3) + col, st.mx);
}

template <bool kVec4>
__device__ __forceinline__ Acc<kVec4> load_part(typename Cols<kVec4>::T* part, const Geo& geo,
                                                int slot, int col) {
  return Acc<kVec4>{__ldcg(part_at<kVec4>(part, geo, slot, 0) + col),
                    __ldcg(part_at<kVec4>(part, geo, slot, 1) + col),
                    __ldcg(part_at<kVec4>(part, geo, slot, 2) + col),
                    __ldcg(part_at<kVec4>(part, geo, slot, 3) + col)};
}

template <bool kVec4>
__device__ void stats_piece(const typename Cols<kVec4>::T* __restrict__ in,
                            const unsigned char* __restrict__ mask, const Out& o,
                            typename Cols<kVec4>::T* __restrict__ part, int* tickets,
                            const Geo& geo, const Lane& l, int first, const Run& run, int j, int a,
                            int b) {
  const int slot = slot_of(run, j);
  for (int cb = 0; cb < geo.g; cb += 2 * geo.w) {
    const ColPair c = cols_at(geo, l, cb);
    Acc<kVec4> st[2];
    walk_stats<kVec4>(in, mask, geo, l, c, a, b, o.want_std, st);
    if (l.sub == 0 && c.v0) store_part<kVec4>(part, geo, slot, c.c0, st[0]);
    if (l.sub == 0 && c.v1) store_part<kVec4>(part, geo, slot, c.c1, st[1]);
  }
  climb(geo, run, j, tickets, l.lane, [&](int span, int c0, int children, bool root) {
    for (int cb = 0; cb < geo.g; cb += 2 * geo.w) {
      const ColPair c = cols_at(geo, l, cb);
      Acc<kVec4> st[2] = {empty_acc<kVec4>(), empty_acc<kVec4>()};
      int n = 0;
      // Sub-group b merges children b, b + s, ... in order; then the tree.
#pragma unroll 4
      for (int k = l.sub; k < children; k += geo.s) {
        const int q0 = (c0 + k) * span;
        const int2 rows = piece_span(geo, first, run, q0, min(q0 + span, run.m));
        const int nk = rows.y - rows.x;
        const int src = slot_of(run, q0);
        if (c.v0) st[0] = merge<kVec4>(st[0], n, load_part<kVec4>(part, geo, src, c.c0), nk);
        if (c.v1) st[1] = merge<kVec4>(st[1], n, load_part<kVec4>(part, geo, src, c.c1), nk);
        n += nk;
      }
      int n1 = n;
      st[0] = across_chan<kVec4>(st[0], n, geo.w);
      st[1] = across_chan<kVec4>(st[1], n1, geo.w);
      if (l.sub != 0) continue;
      if (root) {
        if (c.v0) write_row<kVec4>(o, geo.g, run.row, c.c0, st[0], n);
        if (c.v1) write_row<kVec4>(o, geo.g, run.row, c.c1, st[1], n);
      } else {
        const int dst = slot_of(run, c0 * span);
        if (c.v0) store_part<kVec4>(part, geo, dst, c.c0, st[0]);
        if (c.v1) store_part<kVec4>(part, geo, dst, c.c1, st[1]);
      }
    }
  });
}

template <bool kVec4>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
csr_stats_kernel(const typename Cols<kVec4>::T* __restrict__ in,
                 const unsigned char* __restrict__ mask, const int* __restrict__ row_ptr, Out o,
                 float* __restrict__ count, typename Cols<kVec4>::T* __restrict__ part,
                 int* __restrict__ tickets, int n, Geo geo) {
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
      stats_piece<kVec4>(in, mask, o, part, tickets, geo, l, first, run, warp - run.ks, a0,
                         min(t, a1));
    }
    if (t < a1) {
      r = row_of(row_ptr, n, a1 - 1, l.lane);
      s = __ldg(row_ptr + r);
      t = __ldg(row_ptr + r + 1);
    }
    if (t - s > geo.piece && s >= a0) {
      stats_piece<kVec4>(in, mask, o, part, tickets, geo, l, first, long_run(geo, first, r, s, t),
                         0, s, a1);
    }
    return;
  }
  const int row = warp - geo.chunks;
  if (row >= n) return;
  const int s = __ldg(row_ptr + row), t = __ldg(row_ptr + row + 1);
  if (l.lane == 0) count[row] = static_cast<float>(t - s);
  if (t - s > geo.piece) return;  // its pieces write the outputs
  for (int cb = 0; cb < geo.g; cb += 2 * geo.w) {
    const ColPair c = cols_at(geo, l, cb);
    Acc<kVec4> st[2];
    walk_stats<kVec4>(in, mask, geo, l, c, s, t, o.want_std, st);
    if (l.sub == 0 && c.v0) write_row<kVec4>(o, geo.g, row, c.c0, st[0], t - s);
    if (l.sub == 0 && c.v1) write_row<kVec4>(o, geo.g, row, c.c1, st[1], t - s);
  }
}

template <bool kVec4>
void launch(const float* data, const unsigned char* mask, const int* row_ptr, const Out& o,
            float* count, float* scratch, int* tickets, int n, const Geo& geo,
            cudaStream_t stream) {
  using T = typename Cols<kVec4>::T;
  const long long warps = static_cast<long long>(geo.chunks) + n;
  const dim3 grid(static_cast<unsigned>((warps + kWarpsPerBlock - 1) / kWarpsPerBlock));
  csr_stats_kernel<kVec4><<<grid, kWarp * kWarpsPerBlock, 0, stream>>>(
      reinterpret_cast<const T*>(data), mask, row_ptr, o, count, reinterpret_cast<T*>(scratch),
      tickets, n, geo);
}

}  // namespace

// Plain C entry point, bound from Python with ctypes. `data` is
// [num_entries, f] float32, `mask` [num_entries] bytes (0 drops the row;
// null keeps every row), outputs [num_segments, f] (`mn`/`mx` null when no
// extrema are wanted; `std` is written 0 when want_std is 0), `count`
// [num_segments]; `scratch` and `tickets` are sized by csr_lanes_scratch
// (parts = 4: sum, M2, min, max per slot). One launch on `stream`, no
// synchronisation; returns cudaGetLastError() after it.
extern "C" int csr_segment_stats_f32(const float* data, const unsigned char* mask,
                                     const int* row_ptr, float* sum, float* mean, float* std,
                                     float* count, float* mn, float* mx, float* scratch,
                                     int* tickets, int num_segments, int num_entries, int f,
                                     int vec4, float eps, int want_std, void* stream) {
  if (num_segments <= 0) return static_cast<int>(cudaSuccess);
  const csr_lanes::Geo geo = csr_lanes::geometry(num_entries, f, vec4 != 0);
  const Out o{sum, mean, std, mn, mx, eps, want_std != 0};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec4) {
    launch<true>(data, mask, row_ptr, o, count, scratch, tickets, num_segments, geo, s);
  } else {
    launch<false>(data, mask, row_ptr, o, count, scratch, tickets, num_segments, geo, s);
  }
  return static_cast<int>(cudaGetLastError());
}
