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
// Design.  One thread owns one sample and keeps its K * CB accumulators in
// registers; a block owns kBlock consecutive samples and sweeps one slice of
// the Gaussians, staged through shared memory kChunk at a time as 16-byte
// records (mean, conic and the pass's CB values: dense_layout.cuh), which
// every thread reads with broadcast LDS.128 loads (4 a pair at D = 3,
// C = 4, one per 4 fields).  The pair body has no branch: the wrap mode
// is a template value (a multiplication by 1 / period where the period is a
// power of two, bitwise equal to the division; else the division), and G is
// a select, 0 where the quadratic form is positive.  The channel pass CB is
// 1, 2 or 4, from C (dense_pass): C = 1 and 2 stage, read and multiply no
// zero channels (built for D = 2, where the PIGS trainer runs C = 1).  The
// output write is coalesced (thread i writes column i).  The TPU grid
// carried each output block across its Gaussian blocks in VMEM; CUDA blocks
// run in no order, so the loop over Gaussians lives inside the block, and
// the Gaussian axis is split over gridDim.y: split s sweeps Gaussians
// [s * per_split, (s + 1) * per_split) and writes its own (K * C, N)
// partial; the wrapper adds the partials in a fixed order.  The split count
// depends on the shapes only (kernels/dense.py split_plan), so two runs
// agree bitwise.
//
// What bounds it.  Instruction throughput: per pair D subtractions and the
// wrap, D * D multiply-adds for a = C X, the exponent, one accurate expf, the
// component polynomials and K * CB FMAs into registers, for all N * P pairs;
// the bytes are the operands once and the (splits, K * C, N) output once,
// far below the arithmetic.  No tensor cores: fp32 FMAs only, so the
// products W_k . values stay exact fp32.  At dense config 2 (10k x 100k,
// D = 3, C = 4, all four orders, period 2.0) it takes 7.49-7.54 ms, 64% of
// that bound, at 128 registers and 4 blocks an SM (H100 80GB HBM3, 700 W,
// chip_smoke.py --dense); the wrap by multiplication costs 0.5 ms of it.
//
// Shared memory per block: NV * kChunk * 16 bytes static, at most 16 KB
// (D = 3, CB = 4: four vectors).
//
// Built into the port's kernel library (dgs_tpu_torch/kernels/_build.py, nvcc
// -gencode arch=compute_90a,code=sm_90a -O3, plain C ABI, ctypes).  Never
// with --use_fast_math (see pair_math.cuh).
#include <cuda_runtime.h>

#include "dense_layout.cuh"

namespace {

constexpr int kBlock = 128;  // samples per block, one per thread
constexpr int kChunk = 256;  // Gaussians staged per shared-memory chunk

template <int D, int MASK, int CB, bool WRAP>
__global__ void __launch_bounds__(kBlock) dense_forward_kernel(
    const float* __restrict__ geom,  // (D + tri + C, P): mean, conic, values
    int P, int C,
    const float* __restrict__ smp,   // (D, N) sample coordinates
    long long N, int per_split, float period, float inv_period,
    float* __restrict__ out) {       // (gridDim.y, K * C, N)
  constexpr int TRI = dgs::tri_size(D);
  constexpr int K = dgs::total_unique(D, MASK);
  constexpr int NV = dgs::dense_fwd_vecs(D, CB);
  __shared__ float4 s_rec[NV * kChunk];
  static_assert(sizeof(s_rec) <= 48 * 1024,
                "a staged chunk must fit the static shared-memory limit");
  const unsigned s_base = (unsigned)__cvta_generic_to_shared(s_rec);

  const long long i = (long long)blockIdx.x * kBlock + threadIdx.x;
  const bool live = i < N;
  float x[D];
#pragma unroll
  for (int d = 0; d < D; ++d) x[d] = live ? smp[d * N + i] : 0.0f;
  const int lo = blockIdx.y * per_split;
  const int hi = min(P, lo + per_split);
  float* part = out + (long long)blockIdx.y * K * C * N;

  for (int c0 = 0; c0 < C; c0 += CB) {
    float acc[K][CB];
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int c = 0; c < CB; ++c) acc[k][c] = 0.0f;

    for (int p0 = lo; p0 < hi; p0 += kChunk) {
      const int n = min(kChunk, hi - p0);
      __syncthreads();  // the previous chunk is fully consumed
      for (int j = threadIdx.x; j < n; j += kBlock) {
        float f[4 * NV];
        dgs::stage_gaussian<D, CB>(geom + p0 + j, P, C, c0, f);
#pragma unroll
        for (int v = 0; v < NV; ++v)
          s_rec[dgs::dense_index<kChunk>(v, j)] = make_float4(
              f[4 * v], f[4 * v + 1], f[4 * v + 2], f[4 * v + 3]);
      }
      __syncthreads();
      for (int j = 0; j < n; ++j) {
        float rec[4 * NV];
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          const float4 q = dgs::dense_vector<kChunk>(s_base, v, j);
          rec[4 * v] = q.x;
          rec[4 * v + 1] = q.y;
          rec[4 * v + 2] = q.z;
          rec[4 * v + 3] = q.w;
        }
        float X[D], con[TRI], a[D], q[TRI], w[K];
#pragma unroll
        for (int d = 0; d < D; ++d)
          X[d] = dgs::wrap_by<WRAP>(rec[d] - x[d], period, inv_period);
#pragma unroll
        for (int t = 0; t < TRI; ++t) con[t] = rec[D + t];
        const float G = dgs::pair_gauss<D>(X, con, a);
        dgs::pair_polys<D, MASK>(con, a, q);
        dgs::component_weights<D, MASK>(con, a, q, G, w);
#pragma unroll
        for (int c = 0; c < CB; ++c) {
          const float v = rec[D + TRI + c];
#pragma unroll
          for (int k = 0; k < K; ++k) acc[k][c] = fmaf(w[k], v, acc[k][c]);
        }
      }
    }

    if (live) {
#pragma unroll
      for (int k = 0; k < K; ++k)
#pragma unroll
        for (int c = 0; c < CB; ++c)
          if (c0 + c < C) part[((long long)k * C + c0 + c) * N + i] = acc[k][c];
    }
  }
}

template <int D, int MASK, int CB>
cudaError_t launch_one(const float* geom, int P, int C, const float* smp,
                       long long N, int splits, int per_split, int do_wrap,
                       float period, float* out, cudaStream_t stream) {
  const dim3 grid((unsigned)((N + kBlock - 1) / kBlock), (unsigned)splits);
  const float inv = dgs::exact_inv_period(period);
  if (do_wrap)
    dense_forward_kernel<D, MASK, CB, true><<<grid, kBlock, 0, stream>>>(
        geom, P, C, smp, N, per_split, period, inv, out);
  else
    dense_forward_kernel<D, MASK, CB, false><<<grid, kBlock, 0, stream>>>(
        geom, P, C, smp, N, per_split, period, inv, out);
  return cudaGetLastError();
}

template <int D, int CB>
cudaError_t launch(int mask, const float* geom, int P, int C, const float* smp,
                   long long N, int splits, int per_split, int do_wrap,
                   float period, float* out, cudaStream_t stream) {
  switch (mask) {
#define DGS_CASE(M)                                                        \
  case M:                                                                  \
    return launch_one<D, M, CB>(geom, P, C, smp, N, splits, per_split,     \
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

// Samples per block (the wrapper sizes its split count from it).
int dgs_dense_forward_block() { return kBlock; }

// The channel-pass width both dense kernels use for (D, C).
int dgs_dense_pass(int D, int C) { return dgs::dense_pass(D, C); }

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
#define DGS_LAUNCH(DD, CB) \
  launch<DD, CB>(mask, g, P, C, s, N, splits, per_split, do_wrap, period, o, st)
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
