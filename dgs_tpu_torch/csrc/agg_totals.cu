// Per-centre total neighbour density of the aggregation subsystem, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel dgs_tpu/kernels/aggregate.py::totals
// (_totals_kernel).  Same contract: for every tile-sorted centre i, the sum
// over the entries j on the centre's tile of G_ij, the neighbour's density
// on the offset X = mu_j' - mu_i, zero outside the collision mask (both
// radii alive, |X|^2 <= (r_i + r_j)^2) and where the quadratic form is
// positive.  Output (Cp, 1) fp32; pad and sentinel centres (radius 0, empty
// range) come back zero.
//
// Design.  Aggregation is the tiled sweep with centres in the place of
// samples: one thread owns one tile-sorted centre, a block owns kBlock
// consecutive centres.  Each centre carries the entry range [lo, hi) of its
// tile; because centres and entries are both sorted by tile, the union of a
// block's ranges is one contiguous range, which the block stages through
// shared memory in chunks of kChunk entries (mean', conic, radius).  Every
// thread sweeps the chunk and keeps the entries inside its own range.
// Shared-memory reads are warp-wide broadcasts and the output write is
// coalesced.  No work list: a block finds its own range.
//
// What bounds it.  Per candidate pair: D subtractions, the distance test;
// per colliding pair D*D FMAs and one accurate expf.  Some 10^7 candidate
// pairs at 100,000 Gaussians, so the kernel is short and bound by
// shared-memory load issue and the mask test, not by device memory.
//
// Built by dgs_tpu_torch/kernels/_build.py (nvcc, sm_90a, plain C ABI,
// ctypes).  Never with --use_fast_math (see agg_math.cuh).
#include <cuda_runtime.h>

#include "agg_math.cuh"

namespace {

constexpr int kBlock = 128;  // tile-sorted centres per block, one per thread
constexpr int kChunk = 256;  // entries staged per shared-memory chunk

template <int D>
__global__ void __launch_bounds__(kBlock) agg_totals_kernel(
    const float* __restrict__ ent_geo,  // (D + tri + 1, Ep): mu', conic, r
    long long Ep,
    const float* __restrict__ ctr_geo,  // (Cp, cols): mu, r, inv_norm, ...
    int cols, long long Cp,
    const int* __restrict__ ctr_ent,    // (2, Cp): entry range of each centre
    int do_wrap, float period,
    float* __restrict__ out) {          // (Cp,)
  constexpr int TRI = dgs::tri_size(D);
  __shared__ float s_geo[D + TRI + 1][kChunk];
  __shared__ int s_range[2];

  const long long i = (long long)blockIdx.x * kBlock + threadIdx.x;
  const bool live = i < Cp;
  float mu[D], r_i = 0.0f;
  int lo = 0, hi = 0;
  if (live) {
#pragma unroll
    for (int d = 0; d < D; ++d) mu[d] = ctr_geo[i * cols + d];
    r_i = ctr_geo[i * cols + D];
    lo = ctr_ent[i];
    hi = ctr_ent[Cp + i];
  } else {
#pragma unroll
    for (int d = 0; d < D; ++d) mu[d] = 0.0f;
  }
  int blo, bhi;
  dgs::block_range(lo, hi, s_range, blo, bhi);

  float tot = 0.0f;
  for (int e0 = blo; e0 < bhi; e0 += kChunk) {
    const int n = min(kChunk, bhi - e0);
    __syncthreads();  // the previous chunk is fully consumed
    for (int j = threadIdx.x; j < n; j += kBlock)
#pragma unroll
      for (int r = 0; r < D + TRI + 1; ++r)
        s_geo[r][j] = ent_geo[r * Ep + e0 + j];
    __syncthreads();
    const int j0 = max(lo - e0, 0), j1 = min(hi - e0, n);
    for (int j = j0; j < j1; ++j) {
      float mu_j[D], X[D], con[TRI], G;
#pragma unroll
      for (int d = 0; d < D; ++d) mu_j[d] = s_geo[d][j];
      dgs::agg_offset<D>(mu_j, mu, do_wrap, period, X);
#pragma unroll
      for (int t = 0; t < TRI; ++t) con[t] = s_geo[D + t][j];
      if (!dgs::agg_density<D>(X, con, r_i, s_geo[D + TRI][j], G)) continue;
      tot += G;
    }
  }
  if (live) out[i] = tot;
}

}  // namespace

extern "C" {

// Centres per block of the three centre-major aggregation kernels.
int dgs_agg_block() { return kBlock; }

// Launches the kernel on `stream` and returns cudaGetLastError() after the
// launch (0 = launched).  Pointers are device pointers; `cols` is the row
// length of ctr_geo.
int dgs_agg_totals(const void* ent_geo, int Ep, const void* ctr_geo, int cols,
                   int Cp, const void* ctr_ent, int D, int do_wrap,
                   float period, void* out, void* stream) {
  if (Cp < 1 || cols < D + 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((Cp + kBlock - 1) / kBlock), block(kBlock);
  const auto* g = static_cast<const float*>(ent_geo);
  const auto* c = static_cast<const float*>(ctr_geo);
  const auto* r = static_cast<const int*>(ctr_ent);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 1:
      agg_totals_kernel<1><<<grid, block, 0, st>>>(g, Ep, c, cols, Cp, r,
                                                   do_wrap, period, o);
      break;
    case 2:
      agg_totals_kernel<2><<<grid, block, 0, st>>>(g, Ep, c, cols, Cp, r,
                                                   do_wrap, period, o);
      break;
    case 3:
      agg_totals_kernel<3><<<grid, block, 0, st>>>(g, Ep, c, cols, Cp, r,
                                                   do_wrap, period, o);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
