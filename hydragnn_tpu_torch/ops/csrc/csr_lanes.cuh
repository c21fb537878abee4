// The lane-group CSR walk shared by K1 (csr_segment.cu: per-row sum and
// count) and K5 (csr_stats.cu: the PNA stats bundle). Both reduce each run
// [row_ptr[n], row_ptr[n+1]) of destination-sorted data rows (row e of the
// data is list entry e) in one launch, deterministically and without
// atomics on the data.
//
// Lane groups. A row has g column groups: float4s (16-byte loads) when
// F % 4 == 0 and the data pointer is 16-byte aligned, else floats. The warp
// splits into s = 32 / w sub-groups of w lanes, w the smallest power of two
// >= min(g, 32). Sub-group b walks the run's entries b, b + s, b + 2s, ...;
// lane l of it loads column groups l and l + w of each entry (more than 2w
// groups take further column blocks). So at F = 1 one load instruction
// covers 32 consecutive entries, at F = 64 (16 float4s) two entries. The
// sub-groups' partials are combined with __shfl_xor_sync over offsets w,
// 2w, ..., 16: a fixed tree, so every lane holds the same bits and two
// launches agree bit for bit.
//
// Work. Warps [0, chunks) are chunk warps, warps [chunks, chunks + n) row
// warps (chunk warps first, so the long runs start early). The list is cut
// into chunks of `piece` = max(kMinPiece, s * kSteps) entries (chunk k
// covers entries first + k * piece ... , first = row_ptr[0]): 256 at F = 1,
// 32 from F = 16 up, so a sub-group walks 8 to 32 of them. A row warp walks
// its row when the run has at most `piece` entries (a real node's at most
// 20 neighbours always), and otherwise only writes the count. A run longer than `piece` ("long")
// is split into pieces, one per chunk it overlaps: chunk warp k finds the
// run that holds its first entry and the one that holds its last (a 32-ary
// search over row_ptr, 32 probes per round: 3 rounds at 8192 rows) and
// reduces the part of each long run inside the chunk. A chunk holds at most
// two such parts.
//
// Long runs, one launch. Piece j of a long run writes its partial to
// scratch, then lane 0 takes a ticket (atomicAdd on an int) for the node of
// a fan-in-32 tree above it. The warp that draws the last ticket of its
// siblings merges the 32 (or fewer) children in child order into the
// parent's slot (the first child's slot, in place), resets the ticket to 0
// for the next launch and climbs; the warp that completes the root writes
// the row's outputs. The merge order is fixed by the tree, not by arrival,
// so results stay bit-reproducible; the padding node's ~14k-entry run is
// spread over hundreds of warps and merged in 1-2 levels of 32. Partials
// are written with __stcg and read with __ldcg (L2), and every writer
// fences before the ticket.
//
// Scratch (per launch): 2 * chunks slots of `parts` rows of g column groups
// (slot 2k + 1: the piece of a long run that starts in chunk k; slot 2k:
// the piece of the long run that holds chunk k's first entry and began
// before it). Tickets: `levels` x 2 * chunks ints, zero before the launch
// and zero after it (the caller keeps them per stream).

#pragma once

#include <cuda_runtime.h>

namespace csr_lanes {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;
constexpr int kSteps = 8;      // entries a sub-group walks in a piece, at least
constexpr int kMinPiece = 32;  // entries of a piece, at least
constexpr int kFanIn = 32;  // children merged by one tree node
constexpr unsigned kFull = 0xffffffffu;
constexpr float kBig = 1e30f;  // extrema start values (ops/segment.py's _BIG)

struct Geo {
  int g;       // column groups per row
  int w;       // lanes per sub-group
  int s;       // sub-groups per warp
  int piece;   // entries per chunk; runs longer than this are split
  int chunks;  // chunks of the list
  int levels;  // tree levels the longest possible run needs
};

inline Geo geometry(int num_entries, int f, bool vec4) {
  Geo geo;
  geo.g = vec4 ? f / 4 : f;
  geo.w = 1;
  while (geo.w < geo.g && geo.w < kWarp) geo.w <<= 1;
  geo.s = kWarp / geo.w;
  geo.piece = geo.s * kSteps > kMinPiece ? geo.s * kSteps : kMinPiece;
  geo.chunks = (num_entries + geo.piece - 1) / geo.piece;
  geo.levels = 1;
  for (long long span = kFanIn; span < geo.chunks; span *= kFanIn) ++geo.levels;
  return geo;
}

template <bool kVec4>
struct Cols;

template <>
struct Cols<true> {
  using T = float4;
  static __device__ __forceinline__ T fill(float v) { return make_float4(v, v, v, v); }
  template <class Op>
  static __device__ __forceinline__ T map(T a, T b, Op op) {
    return make_float4(op(a.x, b.x), op(a.y, b.y), op(a.z, b.z), op(a.w, b.w));
  }
  static __device__ __forceinline__ T shfl(T a, int m) {
    return make_float4(__shfl_xor_sync(kFull, a.x, m), __shfl_xor_sync(kFull, a.y, m),
                       __shfl_xor_sync(kFull, a.z, m), __shfl_xor_sync(kFull, a.w, m));
  }
};

template <>
struct Cols<false> {
  using T = float;
  static __device__ __forceinline__ T fill(float v) { return v; }
  template <class Op>
  static __device__ __forceinline__ T map(T a, T b, Op op) { return op(a, b); }
  static __device__ __forceinline__ T shfl(T a, int m) { return __shfl_xor_sync(kFull, a, m); }
};

struct Add {
  __device__ __forceinline__ float operator()(float a, float b) const { return a + b; }
};
struct Min {
  __device__ __forceinline__ float operator()(float a, float b) const { return fminf(a, b); }
};
struct Max {
  __device__ __forceinline__ float operator()(float a, float b) const { return fmaxf(a, b); }
};

// Combine the s sub-groups' values: xor tree over offsets w, 2w, ..., 16.
template <bool kVec4, class Op>
__device__ __forceinline__ typename Cols<kVec4>::T across(typename Cols<kVec4>::T v, int w,
                                                          Op op) {
  for (int m = w; m < kWarp; m <<= 1) v = Cols<kVec4>::map(v, Cols<kVec4>::shfl(v, m), op);
  return v;
}

// This lane's place: sub-group `sub`, lane `wl` in it.
struct Lane {
  int lane, sub, wl;
};

__device__ __forceinline__ Lane lane_of(const Geo& geo) {
  Lane l;
  l.lane = threadIdx.x % kWarp;
  l.sub = l.lane / geo.w;
  l.wl = l.lane % geo.w;
  return l;
}

// The two column groups this lane owns in column block cb (cb steps by 2w).
struct ColPair {
  int c0, c1;
  bool v0, v1;
};

__device__ __forceinline__ ColPair cols_at(const Geo& geo, const Lane& l, int cb) {
  ColPair c;
  c.c0 = cb + l.wl;
  c.c1 = cb + geo.w + l.wl;
  c.v0 = c.c0 < geo.g;
  c.v1 = c.c1 < geo.g;
  return c;
}

// The row whose run holds entry v, for row_ptr[0] <= v < row_ptr[n]: the last
// r < n with row_ptr[r] <= v. Every lane of the warp calls it.
__device__ __forceinline__ int row_of(const int* __restrict__ row_ptr, int n, int v, int lane) {
  int lo = 0, hi = n;  // row_ptr[lo] <= v; the answer is in [lo, hi)
  while (hi - lo > 1) {
    const int step = (hi - lo + kWarp - 1) / kWarp;
    const int p = lo + lane * step;
    const bool le = p < hi && __ldg(row_ptr + p) <= v;
    const unsigned votes = __ballot_sync(kFull, le);  // lane 0 always votes
    lo += (31 - __clz(votes)) * step;
    hi = min(lo + step, hi);
  }
  return lo;
}

// A long run and its pieces: the chunks ks .. ks + m - 1 that it overlaps.
struct Run {
  int row, s, t, ks, m;
};

__device__ __forceinline__ Run long_run(const Geo& geo, int first, int row, int s, int t) {
  Run run;
  run.row = row;
  run.s = s;
  run.t = t;
  run.ks = (s - first) / geo.piece;
  run.m = (t - 1 - first) / geo.piece - run.ks + 1;
  return run;
}

// Scratch slot of the tree node whose first piece is q.
__device__ __forceinline__ int slot_of(const Run& run, int q) {
  return 2 * (run.ks + q) + (q == 0 ? 1 : 0);
}

// Entries of pieces [q0, q1) of the run.
__device__ __forceinline__ int2 piece_span(const Geo& geo, int first, const Run& run, int q0,
                                           int q1) {
  return make_int2(max(run.s, first + (run.ks + q0) * geo.piece),
                   min(run.t, first + (run.ks + q1) * geo.piece));
}

// After this warp stored the partial of piece j: climb the tree while this
// warp is the last of its siblings. merge(span, first_child, children, root)
// merges nodes first_child .. first_child + children - 1 of pieces `span`
// each (node i starts at piece i * span) into the slot of the first child,
// or into the row's outputs when root is true.
template <class Merge>
__device__ __forceinline__ void climb(const Geo& geo, const Run& run, int j, int* tickets,
                                      int lane, Merge&& merge) {
  int i = j, span = 1, nodes = run.m;
  for (int level = 0;; ++level) {
    const int c0 = (i / kFanIn) * kFanIn;
    const int children = min(kFanIn, nodes - c0);
    __threadfence();  // this lane's partial is visible before the ticket
    __syncwarp();
    int* ticket = tickets + static_cast<size_t>(level) * 2 * geo.chunks + slot_of(run, c0 * span);
    int drawn = 0;
    if (lane == 0) drawn = atomicAdd(ticket, 1);
    drawn = __shfl_sync(kFull, drawn, 0);
    if (drawn != children - 1) return;
    if (lane == 0) *ticket = 0;  // ready for the next launch
    __threadfence();
    const int up = (nodes + kFanIn - 1) / kFanIn;
    merge(span, c0, children, up == 1);
    if (up == 1) return;
    i /= kFanIn;
    span *= kFanIn;
    nodes = up;
  }
}

}  // namespace csr_lanes

// Scratch floats and ticket ints one call needs, for `parts` rows of
// partials per slot: [0] = 2 * chunks * parts * F floats, [1] = levels * 2 *
// chunks tickets (kept zero between launches by the kernel itself).
extern "C" void csr_lanes_scratch(int num_entries, int f, int vec4, int parts,
                                  long long* out) {
  const csr_lanes::Geo geo = csr_lanes::geometry(num_entries, f, vec4 != 0);
  out[0] = 2LL * geo.chunks * parts * f;
  out[1] = static_cast<long long>(geo.levels) * 2 * geo.chunks;
}
