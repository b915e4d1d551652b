// Deterministic segment-sum of per-entry gradient rows by Gaussian id, for
// Hopper (sm_90a).
//
// Replaces the segment-sum of dgs_tpu/ops/sampling.py (jax.ops.segment_sum of
// the per-entry VJP rows by gid, :409), which both backwards of the port run
// after their kernel: the tiled sampling op (tiled_backward.cu's per-entry
// rows) and the kernel aggregation (agg_backward.cu's per-entry rows).  Same
// function: out[g, f] = sum of rows[f, e] over the entries e of Gaussian g.
//
// Design.  The caller hands the entries' gid-sorted order (a stable sort) and
// each Gaussian's run [starts[g], starts[g + 1]) in it; entries of gid P
// (sentinels) lie past starts[P] and are never read.  One warp owns one
// Gaussian and its lanes the F columns; a lane adds its column over the run in
// run order, so the sum has one fixed order: no atomics, and two runs agree
// bitwise (the plain version, kernels/segment.py segment_sum_plain, adds in
// the same order).  Nothing is allocated beyond the (P, F) output.
//
// What bounds it.  Bytes: each row value is read once, the order once per
// lane, the output written once.  The reads are gathers, one 32-byte sector
// a 4-byte value: from L2 where the rows fit in it (the 100k x 1M training
// step: 0.029 ms, index_add_ 0.031), from device memory where they do not
// (D = 3, 3.3 M entries x 13 rows: 1.18 ms, index_add_'s coalesced reads
// 0.35; H100 80GB HBM3 at 700 W, chip_smoke.py).  Entry-major rows from the
// backward kernels would read two sectors an entry instead of 13.  No
// arithmetic to speak of.
//
// Built into the port's kernel library (dgs_tpu_torch/kernels/_build.py, nvcc
// -gencode arch=compute_90a,code=sm_90a -O3, plain C ABI, ctypes).
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarps = 8;   // Gaussians per block, one per warp

__global__ void __launch_bounds__(kWarps * kWarp) segment_sum_kernel(
    const float* __restrict__ rows,       // (F, E)
    long long E, int F,
    const long long* __restrict__ order,  // (E,) entries in gid order
    const int* __restrict__ starts,       // (P + 1,) run of each Gaussian
    int P,
    float* __restrict__ out) {            // (P, F)
  const long long g = (long long)blockIdx.x * kWarps + threadIdx.x / kWarp;
  if (g >= P) return;
  const int lo = starts[g], hi = starts[g + 1];
  for (int f = threadIdx.x % kWarp; f < F; f += kWarp) {
    const float* row = rows + (long long)f * E;
    float acc = 0.0f;
    for (int j = lo; j < hi; ++j) acc += row[order[j]];
    out[g * F + f] = acc;
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns cudaGetLastError() after the
// launch (0 = launched).  Pointers are device pointers.
int dgs_segment_sum(const void* rows, int E, int F, const void* order,
                    const void* starts, int P, void* out, void* stream) {
  if (E < 0 || F < 1 || P < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((P + kWarps - 1) / kWarps));
  const dim3 block(kWarps * kWarp);
  const auto st = static_cast<cudaStream_t>(stream);
  segment_sum_kernel<<<grid, block, 0, st>>>(
      static_cast<const float*>(rows), E, F,
      static_cast<const long long*>(order), static_cast<const int*>(starts),
      P, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
