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
// Design.  The mirror of dense_forward.cu: a thread owns kRows Gaussians and
// keeps each one's D + tri + CB gradient accumulators in registers; a block
// owns kBlock * kRows consecutive Gaussians and sweeps one slice of the
// samples, staged through shared memory kChunk at a time as one
// sample-major record of 16-byte vectors each (the coordinates, then the
// sample's K x CB cotangent values: dense_layout.cuh), read with broadcast
// LDS.128 loads: 1 + K * CB / 4 a pair, 21 at D = 3 with all four orders
// and C = 4 (83 fields).  Every thread sweeps the chunk in
// the same fixed order: X = mu - x (the wrap mode a template value, a
// multiplication by 1 / period where the period is a power of two, bitwise
// equal to the division), a = C X and G (a select, 0 where the quadratic
// form is positive: no branch in the pair body), the unique component
// weights w_k, the folded cotangents h_k = sum_c ct[k, c] v_c,
// dvalues_c += sum_k ct[k, c] w_k, and the closed-form per-pair VJP
// (pair_vjp) for the mean and conic rows.  The TPU grid carried each
// Gaussian block's sums across its sample blocks in VMEM; here the loop over
// samples lives inside the block, and the sample axis is split over
// gridDim.y: split s sweeps samples [s * per_split, (s + 1) * per_split) and
// writes its own (D + tri + C, Pp) partial, and the wrapper adds the
// partials in a fixed order.  No atomics anywhere, and the split count
// depends on the shapes only, so the gradients are bitwise reproducible.
//
// Channels.  h needs every channel of a pair, but the dmu / dconic rows are
// linear in h, so the kernel runs over the channels in passes of CB, each
// adding the VJP of its partial h into the same registers (as
// tiled_backward.cu).  CB is 1, 2 or 4, from C (dense_pass; the narrow
// passes are built for D = 2, where the PIGS trainer runs C = 1).  Shared
// memory is static: kChunk samples x (1 + K * CB / 4) vectors, 43,008 bytes
// at D = 3 with all four orders (K = 20), under the 48 KB static limit.
//
// What bounds it.  Instruction throughput: per pair the forward's work plus
// K * CB FMAs for h, K * CB for dvalues and the VJP's accumulators, for all
// N * P pairs.  The bytes are the operands and the cotangent once and the
// (splits, D + tri + C, Pp) output once, far below the arithmetic.  No
// tensor cores: fp32 FMAs only.  At dense config 2 it takes 18.4-18.9 ms,
// 62-63% of that bound, at 167 registers and 3 blocks an SM (H100 80GB
// HBM3, 700 W, chip_smoke.py --dense).  kRows = 2 halves the staged loads
// a pair for twice the accumulators: 254 registers and 19.0-19.1 ms there,
// faster only at the PIGS trainer's smallest shape (0.111 against 0.128 ms).
//
// Built into the port's kernel library (dgs_tpu_torch/kernels/_build.py, nvcc
// -gencode arch=compute_90a,code=sm_90a -O3, plain C ABI, ctypes).  Never
// with --use_fast_math (see pair_math.cuh).
#include <cuda_runtime.h>

#include "dense_layout.cuh"

namespace {

constexpr int kBlock = 128;  // threads per block
constexpr int kRows = 1;     // Gaussians per thread
constexpr int kChunk = 128;  // samples staged per shared-memory chunk

template <int D, int MASK, int CB, bool WRAP>
__global__ void __launch_bounds__(kBlock) dense_backward_kernel(
    const float* __restrict__ geom,  // (D + tri + C, Pp): mean, conic, values
    long long Pp, int C,
    const float* __restrict__ smp,   // (D, N) sample coordinates
    long long N,
    const float* __restrict__ ct,    // (K * C, N) unique-component cotangent
    int per_split, float period, float inv_period,
    float* __restrict__ out) {       // (gridDim.y, D + tri + C, Pp)
  constexpr int TRI = dgs::tri_size(D);
  constexpr int K = dgs::total_unique(D, MASK);
  constexpr int NV = dgs::dense_bwd_vecs(K, CB);
  __shared__ float4 s_rec[NV * kChunk];
  static_assert(sizeof(s_rec) <= 48 * 1024,
                "a staged chunk must fit the static shared-memory limit");
  const unsigned s_base = (unsigned)__cvta_generic_to_shared(s_rec);

  // Every thread owns real columns: the launcher requires
  // Pp == gridDim.x * kBlock * kRows (the wrapper zero-pads the Gaussians
  // and drops the pad rows), so no bounds flag is held across the sweep.
  long long p[kRows];
  float mu[kRows][D], con[kRows][TRI], dmu[kRows][D], dcon[kRows][TRI];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    p[r] = ((long long)blockIdx.x * kRows + r) * kBlock + threadIdx.x;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      mu[r][d] = geom[d * Pp + p[r]];
      dmu[r][d] = 0.0f;
    }
#pragma unroll
    for (int t = 0; t < TRI; ++t) {
      con[r][t] = geom[(D + t) * Pp + p[r]];
      dcon[r][t] = 0.0f;
    }
  }
  const long long lo = (long long)blockIdx.y * per_split;
  const long long hi = min(N, lo + per_split);
  float* part = out + (long long)blockIdx.y * (D + TRI + C) * Pp;

  for (int c0 = 0; c0 < C; c0 += CB) {
    float v[kRows][CB], dv[kRows][CB];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int c = 0; c < CB; ++c) {
        v[r][c] = (c0 + c < C) ? geom[(D + TRI + c0 + c) * Pp + p[r]] : 0.0f;
        dv[r][c] = 0.0f;
      }

    for (long long s0 = lo; s0 < hi; s0 += kChunk) {
      const int n = (int)min((long long)kChunk, hi - s0);
      __syncthreads();  // the previous chunk is fully consumed
      for (int j = threadIdx.x; j < n; j += kBlock) {
        float f[4 * NV];
        dgs::stage_dense_sample<D, K, CB>(smp + s0 + j, ct + s0 + j, N, C, c0,
                                          f);
#pragma unroll
        for (int u = 0; u < NV; ++u)
          s_rec[dgs::dense_index<kChunk>(u, j)] = make_float4(
              f[4 * u], f[4 * u + 1], f[4 * u + 2], f[4 * u + 3]);
      }
      __syncthreads();
      for (int j = 0; j < n; ++j) {
        const float4 head = dgs::dense_vector<kChunk>(s_base, 0, j);
        const float x[3] = {head.x, head.y, head.z};
        float X[kRows][D], a[kRows][D], q[kRows][TRI], w[kRows][K],
            h[kRows][K], G[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
#pragma unroll
          for (int d = 0; d < D; ++d)
            X[r][d] = dgs::wrap_by<WRAP>(mu[r][d] - x[d], period, inv_period);
          G[r] = dgs::pair_gauss<D>(X[r], con[r], a[r]);
          dgs::pair_polys<D, MASK>(con[r], a[r], q[r]);
          dgs::component_weights<D, MASK>(con[r], a[r], q[r], G[r], w[r]);
#pragma unroll
          for (int k = 0; k < K; ++k) h[r][k] = 0.0f;
        }
        // Cotangent float f = k * CB + c of the record, one vector at a time.
#pragma unroll
        for (int u = 0; u < NV - 1; ++u) {
          const float4 gv = dgs::dense_vector<kChunk>(s_base, 1 + u, j);
          const float g4[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int f = 4 * u + e, k = f / CB, c = f % CB;
            if (f < K * CB) {
#pragma unroll
              for (int r = 0; r < kRows; ++r) {
                h[r][k] = fmaf(g4[e], v[r][c], h[r][k]);
                dv[r][c] = fmaf(g4[e], w[r][k], dv[r][c]);
              }
            }
          }
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          dgs::pair_vjp<D, MASK>(X[r], con[r], a[r], q[r], G[r], w[r], h[r],
                                 dmu[r], dcon[r]);
      }
    }

#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int c = 0; c < CB; ++c)
        if (c0 + c < C) part[(D + TRI + c0 + c) * Pp + p[r]] = dv[r][c];
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int d = 0; d < D; ++d) part[d * Pp + p[r]] = dmu[r][d];
#pragma unroll
    for (int t = 0; t < TRI; ++t) part[(D + t) * Pp + p[r]] = dcon[r][t];
  }
}

template <int D, int MASK, int CB>
cudaError_t launch_one(const float* geom, long long Pp, int C,
                       const float* smp, long long N, const float* ct,
                       int splits, int per_split, int do_wrap, float period,
                       float* out, cudaStream_t stream) {
  const dim3 grid((unsigned)(Pp / (kBlock * kRows)), (unsigned)splits);
  const float inv = dgs::exact_inv_period(period);
  if (do_wrap)
    dense_backward_kernel<D, MASK, CB, true><<<grid, kBlock, 0, stream>>>(
        geom, Pp, C, smp, N, ct, per_split, period, inv, out);
  else
    dense_backward_kernel<D, MASK, CB, false><<<grid, kBlock, 0, stream>>>(
        geom, Pp, C, smp, N, ct, per_split, period, inv, out);
  return cudaGetLastError();
}

template <int D, int CB>
cudaError_t launch(int mask, const float* geom, long long Pp, int C,
                   const float* smp, long long N, const float* ct, int splits,
                   int per_split, int do_wrap, float period, float* out,
                   cudaStream_t stream) {
  switch (mask) {
#define DGS_CASE(M)                                                         \
  case M:                                                                   \
    return launch_one<D, M, CB>(geom, Pp, C, smp, N, ct, splits, per_split, \
                                do_wrap, period, out, stream);
    DGS_CASE(1) DGS_CASE(2) DGS_CASE(3) DGS_CASE(4) DGS_CASE(5)
    DGS_CASE(6) DGS_CASE(7) DGS_CASE(8) DGS_CASE(9) DGS_CASE(10)
    DGS_CASE(11) DGS_CASE(12) DGS_CASE(13) DGS_CASE(14) DGS_CASE(15)
#undef DGS_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Gaussians per block: the wrapper pads the Gaussian axis to a multiple.
int dgs_dense_backward_block() { return kBlock * kRows; }

// Launches the kernel on `stream` and returns cudaGetLastError() after the
// launch (0 = launched).  Pointers are device pointers; `mask` is the order
// set (bits of pair_math.cuh); split s of `splits` sweeps samples
// [s * per_split, min(N, (s + 1) * per_split)) into its own
// (D + tri + C, Pp) slab of `out`.
int dgs_dense_backward(const void* geom, int Pp, int C, const void* smp, int N,
                       const void* ct, int D, int mask, int splits,
                       int per_split, int do_wrap, float period, void* out,
                       void* stream) {
  if (N < 1 || Pp < kBlock * kRows || Pp % (kBlock * kRows) != 0 || C < 1 ||
      splits < 1 || splits > 65535 || (long long)splits * per_split < N)
    return (int)cudaErrorInvalidValue;
  const auto* g = static_cast<const float*>(geom);
  const auto* s = static_cast<const float*>(smp);
  const auto* c = static_cast<const float*>(ct);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
#define DGS_LAUNCH(DD, CB)                                                 \
  launch<DD, CB>(mask, g, Pp, C, s, N, c, splits, per_split, do_wrap,      \
                 period, o, st)
  const int cb = dgs::dense_pass(D, C);
  cudaError_t err = cudaErrorInvalidValue;
  if (D == 1)
    err = DGS_LAUNCH(1, 4);
  else if (D == 2)
    err = cb == 1 ? DGS_LAUNCH(2, 1) : cb == 2 ? DGS_LAUNCH(2, 2)
                                               : DGS_LAUNCH(2, 4);
  else if (D == 3)
    err = DGS_LAUNCH(3, 4);
#undef DGS_LAUNCH
  return (int)err;
}

}  // extern "C"
