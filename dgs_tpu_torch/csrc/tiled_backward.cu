// Tiled backward of the Gaussian-mixture evaluation over the tile-binned
// acceleration structure, for Hopper (sm_90a).
//
// Replaces the TPU kernel dgs_tpu/kernels/tiled.py::tiled_backward
// (_wl_backward_kernel, classic _compute_one branch).  Same contract: for
// every tile-sorted entry, the gradient of the loss w.r.t. the entry's
// period-shifted mean (D rows), packed conic (tri rows) and values (C rows),
// summed over the sorted samples on the entry's tile, written to a packed
// (D + tri + C, Ep) fp32 array in entry order.  The caller segment-sums the
// rows by Gaussian id (ops/sampling.py), so no atomics are needed here.
//
// Design.  The mirror of tiled_forward.cu: one thread owns one tile-sorted
// entry and keeps its D + tri + kCB gradient accumulators in registers; a
// block owns kBlock consecutive entries.  Because entries and samples are
// both sorted by tile, the samples that can pair with the block form one
// contiguous range [s_lo, s_lo + s_n) (the backward geometry of
// binning/grid.py at one-sample granularity).  The block stages that range
// through shared memory in chunks of kChunk samples (tile, coordinates and
// the K x kCB cotangent values of each sample, read coalesced from the
// lane-major (K*C, Np) cotangent), and every thread sweeps the chunk in the
// same fixed order, keeping a pair iff the sample's tile equals its entry's
// tile.  Per kept pair: X = mu' - x (wrapped when the op passes a period),
// a = C X and G (pair_power), the unique component weights w_k, the folded
// cotangents h_k = sum_c ct[k, c] v_c, dvalues_c += sum_k ct[k, c] w_k, and
// the closed-form per-pair VJP (pair_vjp) for the mean and conic rows.  Each
// thread writes its entry's rows once, so the result is deterministic.
// Sentinel entries (tile -1.0 or the culled tile T) and pad samples (tile
// -2.0) never pair, and their rows come back zero.
//
// Channels.  h needs every channel of a pair, but the dmu / dconic rows are
// linear in h, so the kernel runs over the channels in passes of kCB = 4:
// each pass stages the cotangent rows of its channels, accumulates that
// pass's dvalues, and adds the VJP of its partial h into the same mean and
// conic registers.  C <= 4 (PIGS's 1 and the headline's 4) is one pass;
// larger C pays the pair geometry once per pass.  Shared memory is sized
// for the widest case, D = 3 with all four orders (K = 20): 128 samples x
// (1 + 3 + 20 x 4) floats = 43,008 bytes, under the 48 KB static limit.
//
// What bounds it.  Per kept pair: the forward's work (D subtractions, D*D
// FMAs for a, one accurate expf, the component polynomials) plus K*kCB FMAs
// for h, K*kCB for dvalues and the VJP's accumulators (S0, W, hl, Y: a few
// FMAs per component) and D*D + 3*tri for the rows, about 2-3x the
// forward's arithmetic; about 198M same-tile pairs at the 100k x 1M D=2
// headline, plus the masked-off pairs of blocks that straddle a tile
// boundary.  So it is bound by FMA/SFU and shared-memory load issue (every
// swept sample's K*kCB cotangent values are broadcast loads), not by device
// memory.  No tensor cores: fp32 FMAs only.
//
// Built with the forward into one library (dgs_tpu_torch/kernels/_build.py,
// nvcc -gencode arch=compute_90a,code=sm_90a -O3, plain C ABI, ctypes).
// Never with --use_fast_math (see pair_math.cuh).
#include <cuda_runtime.h>

#include "pair_math.cuh"

namespace {

constexpr int kBlock = 128;  // tile-sorted entries per block, one per thread
constexpr int kChunk = 128;  // samples staged per shared-memory chunk
constexpr int kCB = 4;       // value channels per pass

struct OrderRows {
  // First unique-component index of each order in the cotangent (component
  // k owns rows [k*C, (k+1)*C)); unused orders are ignored.
  int value, derivative, laplacian, third;
};

// The cotangent component of unique component k in the canonical order of
// MASK.  With k a constant of an unrolled loop this folds to one field of
// `rows` plus a constant, so no index array stays live in registers.
template <int D, int MASK>
__device__ __forceinline__ int cotangent_component(int k,
                                                   const OrderRows& rows) {
  if (MASK & dgs::kValue) {
    if (k == 0) return rows.value;
    k -= 1;
  }
  if (MASK & dgs::kDerivative) {
    if (k < D) return rows.derivative + k;
    k -= D;
  }
  if (MASK & dgs::kLaplacian) {
    if (k < dgs::tri_size(D)) return rows.laplacian + k;
    k -= dgs::tri_size(D);
  }
  return rows.third + k;
}

template <int D, int MASK>
__global__ void __launch_bounds__(kBlock) tiled_backward_kernel(
    const float* __restrict__ geom,  // (1 + D + tri + C, Ep): tile, mu', conic, values
    long long Ep, int C,
    const float* __restrict__ smp,   // (D + 1, Np): coords, tile
    long long Np,
    const float* __restrict__ ct,    // (K * C, Np) cotangent, sorted-sample order
    const int* __restrict__ s_lo,    // (Ep / kBlock,) first sample of each block's range
    const int* __restrict__ s_n,     // (Ep / kBlock,) length of the range
    int do_wrap, float period, OrderRows rows,
    float* __restrict__ out) {       // (D + tri + C, Ep)
  constexpr int TRI = dgs::tri_size(D);
  constexpr int K = dgs::total_unique(D, MASK);
  __shared__ float s_tile[kChunk];
  __shared__ float s_x[D][kChunk];
  __shared__ float s_ct[K * kCB][kChunk];

  // Every thread owns a real column, since the launcher requires
  // Ep == gridDim.x * kBlock (pad entries carry tile -1.0 and never pair),
  // so no bounds flag is kept: held across the sweep it takes a predicate
  // register, which ptxas spills in the heaviest instantiations.
  const long long e = (long long)blockIdx.x * kBlock + threadIdx.x;
  float mu[D], con[TRI];
#pragma unroll
  for (int d = 0; d < D; ++d) mu[d] = geom[(1 + d) * Ep + e];
#pragma unroll
  for (int t = 0; t < TRI; ++t) con[t] = geom[(1 + D + t) * Ep + e];
  const float tile = geom[e];
  const int lo = s_lo[blockIdx.x];
  const int hi = lo + s_n[blockIdx.x];

  float dmu[D], dcon[TRI];
#pragma unroll
  for (int d = 0; d < D; ++d) dmu[d] = 0.0f;
#pragma unroll
  for (int t = 0; t < TRI; ++t) dcon[t] = 0.0f;

  for (int c0 = 0; c0 < C; c0 += kCB) {
    float v[kCB], dv[kCB];
#pragma unroll
    for (int c = 0; c < kCB; ++c) {
      v[c] = (c0 + c < C) ? geom[(1 + D + TRI + c0 + c) * Ep + e] : 0.0f;
      dv[c] = 0.0f;
    }

    for (int s0 = lo; s0 < hi; s0 += kChunk) {
      const int n = min(kChunk, hi - s0);
      __syncthreads();  // the previous chunk is fully consumed
      for (int j = threadIdx.x; j < n; j += kBlock) {
        const long long s = (long long)s0 + j;
        s_tile[j] = smp[D * Np + s];
#pragma unroll
        for (int d = 0; d < D; ++d) s_x[d][j] = smp[d * Np + s];
#pragma unroll
        for (int k = 0; k < K; ++k)
#pragma unroll
          for (int c = 0; c < kCB; ++c)
            s_ct[k * kCB + c][j] =
                (c0 + c < C)
                    ? ct[((long long)cotangent_component<D, MASK>(k, rows) *
                              C + c0 + c) * Np + s]
                    : 0.0f;
      }
      __syncthreads();
      for (int j = 0; j < n; ++j) {
        if (s_tile[j] != tile) continue;
        float X[D];
#pragma unroll
        for (int d = 0; d < D; ++d) {
          X[d] = mu[d] - s_x[d][j];
          if (do_wrap) X[d] = dgs::wrap(X[d], period);
        }
        float a[D], G;
        if (!dgs::pair_power<D>(X, con, a, G)) continue;
        float w[K], h[K];
        dgs::component_weights<D, MASK>(con, a, G, w);
#pragma unroll
        for (int k = 0; k < K; ++k) {
          h[k] = 0.0f;
#pragma unroll
          for (int c = 0; c < kCB; ++c) {
            const float g = s_ct[k * kCB + c][j];
            h[k] = fmaf(g, v[c], h[k]);
            dv[c] = fmaf(g, w[k], dv[c]);
          }
        }
        dgs::pair_vjp<D, MASK>(X, con, a, G, h, dmu, dcon);
      }
    }

#pragma unroll
    for (int c = 0; c < kCB; ++c)
      if (c0 + c < C) out[(D + TRI + c0 + c) * Ep + e] = dv[c];
  }

#pragma unroll
  for (int d = 0; d < D; ++d) out[d * Ep + e] = dmu[d];
#pragma unroll
  for (int t = 0; t < TRI; ++t) out[(D + t) * Ep + e] = dcon[t];
}

template <int D>
cudaError_t launch(int mask, const float* geom, long long Ep, int C,
                   const float* smp, long long Np, const float* ct,
                   const int* s_lo, const int* s_n, int n_blocks, int do_wrap,
                   float period, OrderRows rows, float* out,
                   cudaStream_t stream) {
  const dim3 grid(n_blocks), block(kBlock);
  switch (mask) {
#define DGS_CASE(M)                                                           \
  case M:                                                                     \
    tiled_backward_kernel<D, M><<<grid, block, 0, stream>>>(                  \
        geom, Ep, C, smp, Np, ct, s_lo, s_n, do_wrap, period, rows, out);     \
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

// Entries per block; the caller's range arrays hold one entry per block.
int dgs_tiled_backward_block() { return kBlock; }

// Launches the kernel on `stream` and returns cudaGetLastError() after the
// launch (0 = launched).  Pointers are device pointers; `mask` is the order
// set (bits of pair_math.cuh), r_* the first cotangent component of each
// order.
int dgs_tiled_backward(const void* geom, int Ep, int C, const void* smp,
                       int Np, const void* ct, const void* s_lo,
                       const void* s_n, int n_blocks, int D, int mask,
                       int do_wrap, float period, int r_value,
                       int r_derivative, int r_laplacian, int r_third,
                       void* out, void* stream) {
  if ((long long)n_blocks * kBlock != Ep) return (int)cudaErrorInvalidValue;
  const OrderRows rows{r_value, r_derivative, r_laplacian, r_third};
  const auto* g = static_cast<const float*>(geom);
  const auto* s = static_cast<const float*>(smp);
  const auto* c = static_cast<const float*>(ct);
  const auto* lo = static_cast<const int*>(s_lo);
  const auto* n = static_cast<const int*>(s_n);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (D) {
    case 1:
      err = launch<1>(mask, g, Ep, C, s, Np, c, lo, n, n_blocks, do_wrap,
                      period, rows, o, st);
      break;
    case 2:
      err = launch<2>(mask, g, Ep, C, s, Np, c, lo, n, n_blocks, do_wrap,
                      period, rows, o, st);
      break;
    case 3:
      err = launch<3>(mask, g, Ep, C, s, Np, c, lo, n, n_blocks, do_wrap,
                      period, rows, o, st);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return (int)err;
}

}  // extern "C"
