// CSR segment (sum, count): the Hopper kernel behind every row_ptr-carrying
// segment reduction of the port (PNA mean and centred-std passes, the
// readout mean pool over graph_ptr).
//
// Replaces: hydragnn_tpu/ops/pallas_segment.py, _csr_kernel (launched by
// _csr_sum_count_pallas). That TPU kernel builds a one-hot
// (row_start[n] <= e < row_end[n]) tile per (node block, edge block) and
// multiplies it into the edge data on the MXU, with a bf16 hi/lo split and
// f-packing so the bf16 MXU reaches f32 accuracy. None of that is carried
// over: f32 adds are native on the card, so the kernel simply walks runs,
// with the run walk of csr_walk.cuh over the data rows themselves (edge e
// is list entry e). Its gradient is a gather done by the caller.
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

#include "csr_walk.cuh"

// Edges per chunk: the caller sizes `scratch` as
// 2 * ceil(num_edges / chunk) * f floats.
extern "C" int csr_segment_chunk_edges(void) { return csr_walk::kChunk; }

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
  csr_walk::sum_count<false>(data, nullptr, row_ptr, sum, count, scratch,
                             num_segments, num_edges, f, vec4 != 0,
                             static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}
