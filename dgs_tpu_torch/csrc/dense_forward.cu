// All-pairs (dense) forward evaluation of a Gaussian mixture, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel dgs_tpu/kernels/dense.py::dense_forward
// (_forward_kernel / _forward_body).  Same function: for every sample, the
// sum over ALL Gaussians (no binning, no 3-sigma cut, no capacity) of
// values * (component weights of each requested order), with the torus wrap
// applied per pair when the caller passes a period.  The kernel works on the
// unique (canonical-index) components only, in the canonical order of
// pair_math.cuh; the wrapper (dgs_tpu_torch/kernels/dense.py) mirrors the
// symmetric tensors and puts the orders in the caller's sequence.
//
// Design.  One thread owns one sample and keeps its K * kCB accumulators in
// registers; a block owns kBlock consecutive samples and sweeps one slice of
// the Gaussians, staged through shared memory in chunks of kChunk (mean,
// conic, kCB value channels).  Shared-memory reads are warp-wide broadcasts
// and the output write is coalesced (lane i writes column i).  The TPU grid
// carried each output block across its Gaussian blocks in VMEM; CUDA blocks
// run in no order, so the loop over Gaussians lives inside the block.  With
// one thread per sample a small N leaves most of the 132 SMs idle (N / 128
// blocks), so the Gaussian axis is split over gridDim.y: split s sweeps
// Gaussians [s * per_split, (s + 1) * per_split) and writes its own
// (K * C, N) partial; the wrapper adds the partials in a fixed order.  The
// split count depends on the shapes only, so two runs agree bitwise.
//
// What bounds it.  Operations: per pair D subtractions and the wrap, D*D
// FMAs for a = C X, one accurate expf, the component polynomials and K * C
// fp32 FMAs into registers, for all N * P pairs; the bytes are the operands
// once and the (splits, K * C, N) output once, far below the arithmetic.  No
// tensor cores: fp32 FMAs only, so the products W_k . values stay exact fp32.
//
// Built into the port's kernel library (dgs_tpu_torch/kernels/_build.py, nvcc
// -gencode arch=compute_90a,code=sm_90a -O3, plain C ABI, ctypes).  Never
// with --use_fast_math (see pair_math.cuh).
#include <cuda_runtime.h>

#include "pair_math.cuh"

namespace {

constexpr int kBlock = 128;  // samples per block, one per thread
constexpr int kChunk = 256;  // Gaussians staged per shared-memory chunk
constexpr int kCB = 4;       // value channels accumulated per pass

template <int D, int MASK>
__global__ void __launch_bounds__(kBlock) dense_forward_kernel(
    const float* __restrict__ geom,  // (D + tri + C, P): mean, conic, values
    int P, int C,
    const float* __restrict__ smp,   // (D, N) sample coordinates
    long long N, int per_split, int do_wrap, float period,
    float* __restrict__ out) {       // (gridDim.y, K * C, N)
  constexpr int TRI = dgs::tri_size(D);
  constexpr int K = dgs::total_unique(D, MASK);
  __shared__ float s_mu[D][kChunk];
  __shared__ float s_con[TRI][kChunk];
  __shared__ float s_val[kCB][kChunk];

  const long long i = (long long)blockIdx.x * kBlock + threadIdx.x;
  const bool live = i < N;
  float x[D];
#pragma unroll
  for (int d = 0; d < D; ++d) x[d] = live ? smp[d * N + i] : 0.0f;
  const int lo = blockIdx.y * per_split;
  const int hi = min(P, lo + per_split);
  float* part = out + (long long)blockIdx.y * K * C * N;

  for (int c0 = 0; c0 < C; c0 += kCB) {
    float acc[K][kCB];
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int c = 0; c < kCB; ++c) acc[k][c] = 0.0f;

    for (int p0 = lo; p0 < hi; p0 += kChunk) {
      const int n = min(kChunk, hi - p0);
      __syncthreads();  // the previous chunk is fully consumed
      for (int j = threadIdx.x; j < n; j += kBlock) {
        const long long p = (long long)p0 + j;
#pragma unroll
        for (int d = 0; d < D; ++d) s_mu[d][j] = geom[(long long)d * P + p];
#pragma unroll
        for (int t = 0; t < TRI; ++t)
          s_con[t][j] = geom[(long long)(D + t) * P + p];
#pragma unroll
        for (int c = 0; c < kCB; ++c)
          s_val[c][j] =
              (c0 + c < C) ? geom[(long long)(D + TRI + c0 + c) * P + p] : 0.0f;
      }
      __syncthreads();
      for (int j = 0; j < n; ++j) {
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
#pragma unroll
      for (int k = 0; k < K; ++k)
#pragma unroll
        for (int c = 0; c < kCB; ++c)
          if (c0 + c < C) part[((long long)k * C + c0 + c) * N + i] = acc[k][c];
    }
  }
}

template <int D>
cudaError_t launch(int mask, const float* geom, int P, int C, const float* smp,
                   long long N, int splits, int per_split, int do_wrap,
                   float period, float* out, cudaStream_t stream) {
  const dim3 grid((unsigned)((N + kBlock - 1) / kBlock), (unsigned)splits);
  const dim3 block(kBlock);
  switch (mask) {
#define DGS_CASE(M)                                                    \
  case M:                                                              \
    dense_forward_kernel<D, M><<<grid, block, 0, stream>>>(            \
        geom, P, C, smp, N, per_split, do_wrap, period, out);          \
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

// Samples per block (the wrapper sizes its split count from it).
int dgs_dense_forward_block() { return kBlock; }

// Launches the kernel on `stream` and returns cudaGetLastError() after the
// launch (0 = launched).  Pointers are device pointers; `mask` is the order
// set (bits of pair_math.cuh); split s of `splits` sweeps Gaussians
// [s * per_split, min(P, (s + 1) * per_split)) into its own (K * C, N) slab
// of `out`.
int dgs_dense_forward(const void* geom, int P, int C, const void* smp, int N,
                      int D, int mask, int splits, int per_split, int do_wrap,
                      float period, void* out, void* stream) {
  if (N < 1 || P < 1 || C < 1 || splits < 1 || splits > 65535 ||
      (long long)splits * per_split < P)
    return (int)cudaErrorInvalidValue;
  const auto* g = static_cast<const float*>(geom);
  const auto* s = static_cast<const float*>(smp);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 1:
      return (int)launch<1>(mask, g, P, C, s, N, splits, per_split, do_wrap,
                            period, o, st);
    case 2:
      return (int)launch<2>(mask, g, P, C, s, N, splits, per_split, do_wrap,
                            period, o, st);
    case 3:
      return (int)launch<3>(mask, g, P, C, s, N, splits, per_split, do_wrap,
                            period, o, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
