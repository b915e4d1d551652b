// Tiled forward evaluation of a Gaussian mixture over the tile-binned
// acceleration structure, for Hopper (sm_90a).
//
// Replaces the TPU kernel dgs_tpu/kernels/tiled.py::tiled_forward
// (_wl_forward_kernel, classic branch).  Same contract: for every
// tile-sorted sample, the sum over the entries on the sample's tile of
// values * (unique component weights of each requested order), written to a
// packed (K*C, Np) fp32 array, component-major rows, in sorted-sample order.
//
// Design.  One thread owns one sorted sample and keeps its K*C accumulators
// in registers; a block owns kBlock consecutive sorted samples.  Because
// samples and entries are both sorted by tile, the entries that can pair
// with the block form one contiguous range [ent_lo, ent_lo + ent_n) (the
// forward geometry of binning/grid.py at block granularity).  The block
// stages that range through shared memory in chunks of kChunk entries
// (tile, mean', conic, kCB value channels), and every thread sweeps the
// chunk, keeping a pair iff the entry's tile equals its sample's tile.
// Shared-memory reads are warp-wide broadcasts (every lane reads the same
// entry), and the output write is coalesced (lane i writes column i).  No
// work list is needed: a block finds its own range, so nothing overflows.
//
// What bounds it.  Per kept pair: D subtractions (plus the torus wrap when
// the op passes a period), D*D FMAs for a = C X, one accurate expf, the
// component polynomials and K*C fp32 FMAs into registers; about 198M
// same-tile pairs at the 100k x 1M D=2 headline.  On top come the
// masked-off pairs inside each block's range (a block that straddles a tile
// boundary sweeps both tiles' entries) and the shared-memory broadcast
// loads of every swept entry.  So the kernel is bound by FMA/SFU issue and
// shared-memory load issue, not by device memory: it reads each entry once
// per block and writes each output once.  No tensor cores: fp32 FMAs only.
//
// Build (plain C ABI, loaded with ctypes by dgs_tpu_torch/kernels/_build.py):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libdgs_kernels.so tiled_forward.cu
// Never with --use_fast_math (see pair_math.cuh).
#include <cuda_runtime.h>

#include "pair_math.cuh"

namespace {

constexpr int kBlock = 128;  // sorted samples per block, one per thread
constexpr int kChunk = 256;  // entries staged per shared-memory chunk
constexpr int kCB = 4;       // value channels accumulated per pass

struct OrderRows {
  // First unique-component index of each order in the output (component
  // k of the output owns rows [k*C, (k+1)*C)); unused orders are ignored.
  int value, derivative, laplacian, third;
};

template <int D, int MASK>
__global__ void __launch_bounds__(kBlock) tiled_forward_kernel(
    const float* __restrict__ geom,  // (1 + D + tri + C, Ep): tile, mu', conic, values
    long long Ep, int C,
    const float* __restrict__ smp,   // (D + 1, Np): coords, tile
    long long Np,
    const int* __restrict__ ent_lo,  // (Np / kBlock,) first entry of each block's range
    const int* __restrict__ ent_n,   // (Np / kBlock,) length of the range
    int do_wrap, float period, OrderRows rows,
    float* __restrict__ out) {       // (K * C, Np)
  constexpr int TRI = dgs::tri_size(D);
  constexpr int K = dgs::total_unique(D, MASK);
  __shared__ float s_tile[kChunk];
  __shared__ float s_mu[D][kChunk];
  __shared__ float s_con[TRI][kChunk];
  __shared__ float s_val[kCB][kChunk];

  const long long i = (long long)blockIdx.x * kBlock + threadIdx.x;
  const bool live = i < Np;
  float x[D];
  float tile = -3.0f;  // no entry carries this tile
#pragma unroll
  for (int d = 0; d < D; ++d) x[d] = live ? smp[d * Np + i] : 0.0f;
  if (live) tile = smp[D * Np + i];
  const int lo = ent_lo[blockIdx.x];
  const int hi = lo + ent_n[blockIdx.x];

  for (int c0 = 0; c0 < C; c0 += kCB) {
    float acc[K][kCB];
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int c = 0; c < kCB; ++c) acc[k][c] = 0.0f;

    for (int e0 = lo; e0 < hi; e0 += kChunk) {
      const int n = min(kChunk, hi - e0);
      __syncthreads();  // the previous chunk is fully consumed
      for (int j = threadIdx.x; j < n; j += kBlock) {
        const long long e = (long long)e0 + j;
        s_tile[j] = geom[e];
#pragma unroll
        for (int d = 0; d < D; ++d) s_mu[d][j] = geom[(1 + d) * Ep + e];
#pragma unroll
        for (int t = 0; t < TRI; ++t) s_con[t][j] = geom[(1 + D + t) * Ep + e];
#pragma unroll
        for (int c = 0; c < kCB; ++c)
          s_val[c][j] = (c0 + c < C) ? geom[(1 + D + TRI + c0 + c) * Ep + e]
                                     : 0.0f;
      }
      __syncthreads();
      for (int j = 0; j < n; ++j) {
        if (s_tile[j] != tile) continue;
        float X[D];
#pragma unroll
        for (int d = 0; d < D; ++d) {
          X[d] = s_mu[d][j] - x[d];
          if (do_wrap) X[d] = dgs::wrap(X[d], period);
        }
        float con[TRI];
#pragma unroll
        for (int t = 0; t < TRI; ++t) con[t] = s_con[t][j];
        float w[K];
        if (!dgs::pair_weights<D, MASK>(X, con, w)) continue;
#pragma unroll
        for (int c = 0; c < kCB; ++c) {
          const float v = s_val[c][j];
#pragma unroll
          for (int k = 0; k < K; ++k) acc[k][c] = fmaf(w[k], v, acc[k][c]);
        }
      }
    }

    if (live) {
      // Unique component k of the canonical order set -> its output row.
      int row[K];
      int k = 0;
      if (MASK & dgs::kValue) row[k++] = rows.value;
      if (MASK & dgs::kDerivative) {
#pragma unroll
        for (int u = 0; u < dgs::n_unique(dgs::kDerivative, D); ++u)
          row[k++] = rows.derivative + u;
      }
      if (MASK & dgs::kLaplacian) {
#pragma unroll
        for (int u = 0; u < dgs::n_unique(dgs::kLaplacian, D); ++u)
          row[k++] = rows.laplacian + u;
      }
      if (MASK & dgs::kThird) {
#pragma unroll
        for (int u = 0; u < dgs::n_unique(dgs::kThird, D); ++u)
          row[k++] = rows.third + u;
      }
#pragma unroll
      for (int kk = 0; kk < K; ++kk)
#pragma unroll
        for (int c = 0; c < kCB; ++c)
          if (c0 + c < C)
            out[((long long)row[kk] * C + c0 + c) * Np + i] = acc[kk][c];
    }
  }
}

template <int D>
cudaError_t launch(int mask, const float* geom, long long Ep, int C,
                   const float* smp, long long Np, const int* ent_lo,
                   const int* ent_n, int n_blocks, int do_wrap, float period,
                   OrderRows rows, float* out, cudaStream_t stream) {
  const dim3 grid(n_blocks), block(kBlock);
  switch (mask) {
#define DGS_CASE(M)                                                       \
  case M:                                                                 \
    tiled_forward_kernel<D, M><<<grid, block, 0, stream>>>(               \
        geom, Ep, C, smp, Np, ent_lo, ent_n, do_wrap, period, rows, out); \
    break;
    DGS_CASE(1) DGS_CASE(2) DGS_CASE(3) DGS_CASE(4) DGS_CASE(5)
    DGS_CASE(6) DGS_CASE(7) DGS_CASE(8) DGS_CASE(9) DGS_CASE(10)
    DGS_CASE(11) DGS_CASE(12) DGS_CASE(13) DGS_CASE(14) DGS_CASE(15)
#undef DGS_CASE
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Samples per block; the caller's range arrays hold one entry per block.
int dgs_tiled_forward_block() { return kBlock; }

// Launches the kernel on `stream` and returns cudaGetLastError() after the
// launch (0 = launched).  Pointers are device pointers; `mask` is the order
// set (bits of pair_math.cuh), r_* the first output component of each order.
int dgs_tiled_forward(const void* geom, int Ep, int C, const void* smp,
                      int Np, const void* ent_lo, const void* ent_n,
                      int n_blocks, int D, int mask, int do_wrap, float period,
                      int r_value, int r_derivative, int r_laplacian,
                      int r_third, void* out, void* stream) {
  if ((long long)n_blocks * kBlock < Np) return (int)cudaErrorInvalidValue;
  const OrderRows rows{r_value, r_derivative, r_laplacian, r_third};
  const auto* g = static_cast<const float*>(geom);
  const auto* s = static_cast<const float*>(smp);
  const auto* lo = static_cast<const int*>(ent_lo);
  const auto* n = static_cast<const int*>(ent_n);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (D) {
    case 1:
      err = launch<1>(mask, g, Ep, C, s, Np, lo, n, n_blocks, do_wrap, period,
                      rows, o, st);
      break;
    case 2:
      err = launch<2>(mask, g, Ep, C, s, Np, lo, n, n_blocks, do_wrap, period,
                      rows, o, st);
      break;
    case 3:
      err = launch<3>(mask, g, Ep, C, s, Np, lo, n, n_blocks, do_wrap, period,
                      rows, o, st);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return (int)err;
}

}  // extern "C"
