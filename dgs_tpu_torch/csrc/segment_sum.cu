// Deterministic segment-sum of per-entry gradient rows by Gaussian id, for
// Hopper (sm_90a).
//
// Replaces the segment-sum of dgs_tpu/ops/sampling.py (jax.ops.segment_sum of
// the per-entry VJP rows by gid, :409), which both backwards of the port run
// after their kernel: the tiled sampling op (tiled_backward.cu's per-entry
// rows) and the kernel aggregation (agg_backward.cu's per-entry rows).  Same
// function: out[g, f] = sum of rows[f, e] over the entries e of Gaussian g.
//
// Layout.  The rows are read through two strides, rows[f * sf + e * se], so
// one kernel serves both layouts the port hands it without a copy: the
// entry-major buffers that the two backward kernels write, (E, F) seen as
// its (F, E) transpose (sf = 1, se = F: an entry's F values are one
// contiguous record of 4 F bytes, two or three 32-byte sectors), and
// feature-major (F, E) rows (sf = E, se = 1: F sectors an entry).
//
// Design.  The caller hands the entries' gid-sorted order (a stable sort) and
// each Gaussian's run [starts[g], starts[g + 1]) in it; entries of gid P
// (sentinels) lie past starts[P] and are never read.  A group of min(F, 32)
// consecutive lanes owns one Gaussian, a lane a column (and every group
// width-th after it when F > 32), so a warp holds 32 / min(F, 32) Gaussians
// (three at F = 9, two at F = 13) and a group reads each entry's record as
// one contiguous piece in the entry-major layout.  A lane walks its run
// kUnroll entries at a time: the run's ids first, then the values they
// point at, all in flight together, then the adds in run order.  So each
// sum has one fixed order, the run order: no atomics, and two runs agree
// bitwise (the plain version, kernels/segment.py segment_sum_plain, adds in
// the same order).  The (P, F) output is written coalesced, a warp's groups
// being consecutive Gaussians.  Nothing is allocated beyond it.
//
// What bounds it.  Bytes: each entry's record, its id once per lane group
// (one 8-byte broadcast), the starts and the output.  The gathers hit
// sectors of device memory in the order the gid sort leaves them.  Measured
// times are in PERF.md; no arithmetic to speak of.
//
// Built into the port's kernel library (dgs_tpu_torch/kernels/_build.py, nvcc
// -gencode arch=compute_90a,code=sm_90a -O3, plain C ABI, ctypes).
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarps = 8;    // warps per block
constexpr int kUnroll = 8;   // entries of a run whose loads are in flight

__global__ void __launch_bounds__(kWarps * kWarp) segment_sum_kernel(
    const float* __restrict__ rows,       // rows[f * sf + e * se]
    long long sf, long long se, int F,
    const long long* __restrict__ order,  // (E,) entries in gid order
    const int* __restrict__ starts,       // (P + 1,) run of each Gaussian
    int P,
    float* __restrict__ out) {            // (P, F)
  const int width = F < kWarp ? F : kWarp;     // lanes a Gaussian
  const int groups = kWarp / width;            // Gaussians a warp
  const int lane = threadIdx.x % kWarp;
  const int group = lane / width;
  const long long warp = (long long)blockIdx.x * kWarps + threadIdx.x / kWarp;
  const long long g = warp * groups + group;
  if (group >= groups || g >= P) return;
  const int lo = starts[g], hi = starts[g + 1];
  for (int f = lane % width; f < F; f += width) {
    const float* col = rows + (long long)f * sf;
    float acc = 0.0f;
    for (int j = lo; j < hi; j += kUnroll) {
      long long e[kUnroll];
      float v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) e[u] = j + u < hi ? order[j + u] : 0;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        v[u] = j + u < hi ? col[e[u] * se] : 0.0f;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (j + u < hi) acc += v[u];
    }
    out[g * F + f] = acc;
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns cudaGetLastError() after the
// launch (0 = launched).  Pointers are device pointers; (sf, se) are the
// strides of the rows' feature and entry axes, in floats.
int dgs_segment_sum(const void* rows, long long sf, long long se, int F,
                    const void* order, const void* starts, int P, void* out,
                    void* stream) {
  if (F < 1 || P < 1 || sf < 0 || se < 0) return (int)cudaErrorInvalidValue;
  const int width = F < kWarp ? F : kWarp;
  const long long warps = (P + kWarp / width - 1) / (kWarp / width);
  const dim3 grid((unsigned)((warps + kWarps - 1) / kWarps));
  const dim3 block(kWarps * kWarp);
  const auto st = static_cast<cudaStream_t>(stream);
  segment_sum_kernel<<<grid, block, 0, st>>>(
      static_cast<const float*>(rows), sf, se, F,
      static_cast<const long long*>(order), static_cast<const int*>(starts),
      P, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
