// All-pairs (dense) backward of the Gaussian-mixture evaluation, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel dgs_tpu/kernels/dense.py::dense_backward
// (_backward_kernel / _backward_body).  Same function: for every Gaussian,
// the gradient of the loss w.r.t. its mean (D rows), packed conic (tri rows)
// and values (C rows), summed over ALL samples, with the torus wrap applied
// per pair when the caller passes a period.  The cotangent arrives folded to
// the unique (canonical-index) components, in the canonical order of
// pair_math.cuh: the wrapper (dgs_tpu_torch/kernels/dense.py) adds the
// cotangents of mirrored tensor positions into their unique slot first, which
// is exact because every per-component VJP term is symmetric in the
// component's indices.
//
// Design.  The mirror of dense_forward.cu: one thread owns one Gaussian and
// keeps its D + tri + kCB gradient accumulators in registers; a block owns
// kBlock consecutive Gaussians and sweeps one slice of the samples, staged
// through shared memory in chunks of kChunk (coordinates and the K x kCB
// cotangent values of each sample, read coalesced from the lane-major
// (K * C, N) cotangent).  Every thread sweeps the chunk in the same fixed
// order: X = mu - x (wrapped on request), a = C X and G (pair_power), the
// unique component weights w_k, the folded cotangents
// h_k = sum_c ct[k, c] v_c, dvalues_c += sum_k ct[k, c] w_k, and the
// closed-form per-pair VJP (pair_vjp) for the mean and conic rows.  The TPU
// grid carried each Gaussian block's sums across its sample blocks in VMEM;
// here the loop over samples lives inside the block.  With one thread per
// Gaussian, P / 128 blocks leave most of the 132 SMs idle (8 blocks at
// P = 1,000), so the sample axis is split over gridDim.y: split s sweeps
// samples [s * per_split, (s + 1) * per_split) and writes its own
// (D + tri + C, Pp) partial, and the wrapper adds the partials in a fixed
// order.  No atomics anywhere, and the split count depends on the shapes
// only, so the gradients are bitwise reproducible.
//
// Channels.  h needs every channel of a pair, but the dmu / dconic rows are
// linear in h, so the kernel runs over the channels in passes of kCB = 4,
// each adding the VJP of its partial h into the same registers (as
// tiled_backward.cu).  Shared memory is static and sized by the widest
// instantiation, D = 3 with all four orders (K = 20): 128 samples x
// (3 + 20 x 4) floats = 42,496 bytes, under the 48 KB static limit; it fits
// only because the cotangent is folded to unique rows first.
//
// What bounds it.  Operations: per pair the forward's work plus K * kCB FMAs
// for h, K * kCB for dvalues and the VJP's accumulators, for all N * P pairs;
// every swept sample's K * kCB cotangent values are shared-memory broadcast
// loads.  The bytes are the operands and the cotangent once and the
// (splits, D + tri + C, Pp) output once, far below the arithmetic.  No tensor
// cores: fp32 FMAs only.
//
// Built into the port's kernel library (dgs_tpu_torch/kernels/_build.py, nvcc
// -gencode arch=compute_90a,code=sm_90a -O3, plain C ABI, ctypes).  Never
// with --use_fast_math (see pair_math.cuh).
#include <cuda_runtime.h>

#include "pair_math.cuh"

namespace {

constexpr int kBlock = 128;  // Gaussians per block, one per thread
constexpr int kChunk = 128;  // samples staged per shared-memory chunk
constexpr int kCB = 4;       // value channels per pass

template <int D, int MASK>
__global__ void __launch_bounds__(kBlock) dense_backward_kernel(
    const float* __restrict__ geom,  // (D + tri + C, Pp): mean, conic, values
    long long Pp, int C,
    const float* __restrict__ smp,   // (D, N) sample coordinates
    long long N,
    const float* __restrict__ ct,    // (K * C, N) unique-component cotangent
    int per_split, int do_wrap, float period,
    float* __restrict__ out) {       // (gridDim.y, D + tri + C, Pp)
  constexpr int TRI = dgs::tri_size(D);
  constexpr int K = dgs::total_unique(D, MASK);
  __shared__ float s_x[D][kChunk];
  __shared__ float s_ct[K * kCB][kChunk];
  static_assert(sizeof(float) * (D + K * kCB) * kChunk <= 48 * 1024,
                "a staged chunk must fit the static shared-memory limit");

  // Every thread owns a real column: the launcher requires
  // Pp == gridDim.x * kBlock (the wrapper zero-pads the Gaussians and drops
  // the pad rows), so no bounds flag is held across the sweep.
  const long long p = (long long)blockIdx.x * kBlock + threadIdx.x;
  float mu[D], con[TRI];
#pragma unroll
  for (int d = 0; d < D; ++d) mu[d] = geom[d * Pp + p];
#pragma unroll
  for (int t = 0; t < TRI; ++t) con[t] = geom[(D + t) * Pp + p];
  const long long lo = (long long)blockIdx.y * per_split;
  const long long hi = min(N, lo + per_split);
  float* part = out + (long long)blockIdx.y * (D + TRI + C) * Pp;

  float dmu[D], dcon[TRI];
#pragma unroll
  for (int d = 0; d < D; ++d) dmu[d] = 0.0f;
#pragma unroll
  for (int t = 0; t < TRI; ++t) dcon[t] = 0.0f;

  for (int c0 = 0; c0 < C; c0 += kCB) {
    float v[kCB], dv[kCB];
#pragma unroll
    for (int c = 0; c < kCB; ++c) {
      v[c] = (c0 + c < C) ? geom[(D + TRI + c0 + c) * Pp + p] : 0.0f;
      dv[c] = 0.0f;
    }

    for (long long s0 = lo; s0 < hi; s0 += kChunk) {
      const int n = (int)min((long long)kChunk, hi - s0);
      __syncthreads();  // the previous chunk is fully consumed
      for (int j = threadIdx.x; j < n; j += kBlock) {
        const long long s = s0 + j;
#pragma unroll
        for (int d = 0; d < D; ++d) s_x[d][j] = smp[d * N + s];
#pragma unroll
        for (int k = 0; k < K; ++k)
#pragma unroll
          for (int c = 0; c < kCB; ++c)
            s_ct[k * kCB + c][j] =
                (c0 + c < C) ? ct[((long long)k * C + c0 + c) * N + s] : 0.0f;
      }
      __syncthreads();
      for (int j = 0; j < n; ++j) {
        float X[D];
#pragma unroll
        for (int d = 0; d < D; ++d) {
          X[d] = mu[d] - s_x[d][j];
          if (do_wrap) X[d] = dgs::wrap(X[d], period);
        }
        float a[D], G;
        if (!dgs::pair_power<D>(X, con, a, G)) continue;
        float q[TRI], w[K], h[K];
        dgs::pair_polys<D, MASK>(con, a, q);
        dgs::component_weights<D, MASK>(con, a, q, G, w);
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
        dgs::pair_vjp<D, MASK>(X, con, a, q, G, w, h, dmu, dcon);
      }
    }

#pragma unroll
    for (int c = 0; c < kCB; ++c)
      if (c0 + c < C) part[(D + TRI + c0 + c) * Pp + p] = dv[c];
  }

#pragma unroll
  for (int d = 0; d < D; ++d) part[d * Pp + p] = dmu[d];
#pragma unroll
  for (int t = 0; t < TRI; ++t) part[(D + t) * Pp + p] = dcon[t];
}

template <int D>
cudaError_t launch(int mask, const float* geom, long long Pp, int C,
                   const float* smp, long long N, const float* ct, int splits,
                   int per_split, int do_wrap, float period, float* out,
                   cudaStream_t stream) {
  const dim3 grid((unsigned)(Pp / kBlock), (unsigned)splits), block(kBlock);
  switch (mask) {
#define DGS_CASE(M)                                                      \
  case M:                                                                \
    dense_backward_kernel<D, M><<<grid, block, 0, stream>>>(             \
        geom, Pp, C, smp, N, ct, per_split, do_wrap, period, out);       \
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

// Gaussians per block: the wrapper pads the Gaussian axis to a multiple.
int dgs_dense_backward_block() { return kBlock; }

// Launches the kernel on `stream` and returns cudaGetLastError() after the
// launch (0 = launched).  Pointers are device pointers; `mask` is the order
// set (bits of pair_math.cuh); split s of `splits` sweeps samples
// [s * per_split, min(N, (s + 1) * per_split)) into its own
// (D + tri + C, Pp) slab of `out`.
int dgs_dense_backward(const void* geom, int Pp, int C, const void* smp, int N,
                       const void* ct, int D, int mask, int splits,
                       int per_split, int do_wrap, float period, void* out,
                       void* stream) {
  if (N < 1 || Pp < kBlock || Pp % kBlock != 0 || C < 1 || splits < 1 ||
      splits > 65535 || (long long)splits * per_split < N)
    return (int)cudaErrorInvalidValue;
  const auto* g = static_cast<const float*>(geom);
  const auto* s = static_cast<const float*>(smp);
  const auto* c = static_cast<const float*>(ct);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 1:
      return (int)launch<1>(mask, g, Pp, C, s, N, c, splits, per_split,
                            do_wrap, period, o, st);
    case 2:
      return (int)launch<2>(mask, g, Pp, C, s, N, c, splits, per_split,
                            do_wrap, period, o, st);
    case 3:
      return (int)launch<3>(mask, g, Pp, C, s, N, c, splits, per_split,
                            do_wrap, period, o, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
