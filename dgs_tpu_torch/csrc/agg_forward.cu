// Forward neighbour aggregation (the raw pre-activation rows), for Hopper
// (sm_90a).
//
// Replaces the TPU kernel dgs_tpu/kernels/aggregate.py::forward
// (_forward_kernel).  Same contract: for every tile-sorted centre i,
//   pre_i[l] = sum_j G_ij <q_i, k_j> inv_tot_i (fac_ij feat_j[l] + emb_ij)
// over the entries j on the centre's tile, with G the neighbour's density
// under the collision mask and (emb, fac) the sinusoidal code of the
// normalised offset X inv_norm_i (agg_math.cuh).  Output (Cp, L) fp32, before
// the L x L transform, which stays one matrix product outside.  With TOTALS
// the same sweep also returns sum_j G_ij per centre, for a structure whose
// inv_tot column is 1: the caller normalises outside.
//
// Design.  As agg_totals.cu: one thread per tile-sorted centre, the block's
// contiguous entry range staged through shared memory in chunks (geometry,
// the K key rows and LB feature rows per entry), every thread sweeping the
// part of the chunk inside its own tile's range.  A thread keeps LB output
// accumulators and one for sum coeff emb in registers; its K queries ride a
// shared-memory column, since K is a runtime size.  L above LB takes further
// passes over the range (LB is 4 or 8, the wrapper's pick, so L <= 8 is one
// pass).  The distance transform and the frequencies sit in shared memory.
//
// What bounds it.  A colliding pair costs the K-term dot product, the code's
// sin / cos (2 D nfreq accurate sincosf, or 2 D with the ladder recurrence:
// 4 FMAs a rung), 4 FMAs per (dim, rung) for emb and fac, and L FMAs; a
// candidate pair that fails the mask costs the offset and the distance test.
// So it is bound by fp32 and special-function issue, not by device memory.
//
// Built by dgs_tpu_torch/kernels/_build.py (nvcc, sm_90a, plain C ABI,
// ctypes).  Never with --use_fast_math (see agg_math.cuh).
#include <cuda_runtime.h>

#include "agg_math.cuh"

namespace {

constexpr int kBlock = 128;  // tile-sorted centres per block, one per thread
constexpr int kChunk = 128;  // entries staged per shared-memory chunk

template <int D, bool LADDER, bool TOTALS, int LB>
__global__ void __launch_bounds__(kBlock) agg_forward_kernel(
    const float* __restrict__ ent_geo,  // (D + tri + 1, Ep): mu', conic, r
    const float* __restrict__ ent_fk,   // (L + K, Ep): features, keys
    long long Ep,
    const float* __restrict__ ctr_geo,  // (Cp, D + 3 + K): mu, r, inv_norm,
    int cols, long long Cp,             //   inv_tot, queries
    const int* __restrict__ ctr_ent,    // (2, Cp): entry range of each centre
    const float* __restrict__ dtf,      // (2E + nfreq,): dt, frequencies
    int L, int K, int nfreq, int E, int do_wrap, float period,
    float* __restrict__ out,            // (Cp, L)
    float* __restrict__ tot_out) {      // (Cp,) with TOTALS
  constexpr int TRI = dgs::tri_size(D);
  constexpr int GEO = D + TRI + 1;
  extern __shared__ float smem[];
  const int ndt = 2 * E + nfreq;
  float* s_dt = smem;                    // ndt
  float* s_q = s_dt + ndt;               // K x kBlock, column per thread
  float* s_geo = s_q + K * kBlock;       // GEO x kChunk
  float* s_key = s_geo + GEO * kChunk;   // K x kChunk
  float* s_feat = s_key + K * kChunk;    // LB x kChunk
  __shared__ int s_range[2];

  const int tid = threadIdx.x;
  const long long i = (long long)blockIdx.x * kBlock + tid;
  const bool live = i < Cp;
  float mu[D], r_i = 0.0f, inv_norm = 0.0f, inv_tot = 0.0f;
  int lo = 0, hi = 0;
#pragma unroll
  for (int d = 0; d < D; ++d) mu[d] = live ? ctr_geo[i * cols + d] : 0.0f;
  if (live) {
    r_i = ctr_geo[i * cols + D];
    inv_norm = ctr_geo[i * cols + D + 1];
    inv_tot = ctr_geo[i * cols + D + 2];
    lo = ctr_ent[i];
    hi = ctr_ent[Cp + i];
  }
  for (int k = 0; k < K; ++k)
    s_q[k * kBlock + tid] = live ? ctr_geo[i * cols + D + 3 + k] : 0.0f;
  for (int t = tid; t < ndt; t += kBlock) s_dt[t] = dtf[t];
  int blo, bhi;
  dgs::block_range(lo, hi, s_range, blo, bhi);  // also publishes s_dt

  for (int l0 = 0; l0 < L; l0 += LB) {
    float acc[LB], acc_emb = 0.0f, tot = 0.0f;
#pragma unroll
    for (int l = 0; l < LB; ++l) acc[l] = 0.0f;

    for (int e0 = blo; e0 < bhi; e0 += kChunk) {
      const int n = min(kChunk, bhi - e0);
      __syncthreads();  // the previous chunk is fully consumed
      for (int j = tid; j < n; j += kBlock) {
        const long long e = (long long)e0 + j;
#pragma unroll
        for (int r = 0; r < GEO; ++r) s_geo[r * kChunk + j] = ent_geo[r * Ep + e];
        for (int k = 0; k < K; ++k)
          s_key[k * kChunk + j] = ent_fk[(L + k) * Ep + e];
#pragma unroll
        for (int l = 0; l < LB; ++l)
          s_feat[l * kChunk + j] =
              (l0 + l < L) ? ent_fk[(l0 + l) * Ep + e] : 0.0f;
      }
      __syncthreads();
      const int j0 = max(lo - e0, 0), j1 = min(hi - e0, n);
      for (int j = j0; j < j1; ++j) {
        float mu_j[D], X[D], con[TRI], G;
#pragma unroll
        for (int d = 0; d < D; ++d) mu_j[d] = s_geo[d * kChunk + j];
        dgs::agg_offset<D>(mu_j, mu, do_wrap, period, X);
#pragma unroll
        for (int t = 0; t < TRI; ++t) con[t] = s_geo[(D + t) * kChunk + j];
        if (!dgs::agg_density<D>(X, con, r_i, s_geo[(D + TRI) * kChunk + j], G))
          continue;
        const float w =
            dgs::dot_strided(s_q + tid, kBlock, s_key + j, kChunk, K);
        float Xn[D], emb, fac;
#pragma unroll
        for (int d = 0; d < D; ++d) Xn[d] = X[d] * inv_norm;
        dgs::agg_code<D, LADDER>(Xn, s_dt, s_dt + 2 * E, nfreq, E, emb, fac);
        if (TOTALS) tot += G;
        const float coeff = G * w * inv_tot;
        const float cf = coeff * fac;
        acc_emb = fmaf(coeff, emb, acc_emb);
#pragma unroll
        for (int l = 0; l < LB; ++l)
          acc[l] = fmaf(cf, s_feat[l * kChunk + j], acc[l]);
      }
    }

    if (live) {
#pragma unroll
      for (int l = 0; l < LB; ++l)
        if (l0 + l < L) out[i * L + l0 + l] = acc[l] + acc_emb;
      if (TOTALS && l0 == 0) tot_out[i] = tot;
    }
  }
}

template <int D, bool LADDER, bool TOTALS, int LB>
cudaError_t launch(const float* ent_geo, const float* ent_fk, long long Ep,
                   const float* ctr_geo, int cols, long long Cp,
                   const int* ctr_ent, const float* dtf, int L, int K,
                   int nfreq, int E, int do_wrap, float period, float* out,
                   float* tot, cudaStream_t stream) {
  constexpr int GEO = D + dgs::tri_size(D) + 1;
  const size_t bytes =
      sizeof(float) * ((size_t)(2 * E + nfreq) + (size_t)K * kBlock +
                       (size_t)(GEO + K + LB) * kChunk);
  auto kernel = agg_forward_kernel<D, LADDER, TOTALS, LB>;
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((unsigned)((Cp + kBlock - 1) / kBlock)), block(kBlock);
  kernel<<<grid, block, bytes, stream>>>(ent_geo, ent_fk, Ep, ctr_geo, cols,
                                         Cp, ctr_ent, dtf, L, K, nfreq, E,
                                         do_wrap, period, out, tot);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns the CUDA error of the launch
// (0 = launched).  Pointers are device pointers; `tot` is read only with
// with_totals.  L <= 4 runs the 4-accumulator instantiation, larger L the
// 8-accumulator one (in passes of 8 above that).
int dgs_agg_forward(const void* ent_geo, const void* ent_fk, int Ep,
                    const void* ctr_geo, int cols, int Cp,
                    const void* ctr_ent, const void* dtf, int D, int L, int K,
                    int nfreq, int E, int do_wrap, float period, int ladder,
                    int with_totals, void* out, void* tot, void* stream) {
  if (Cp < 1 || L < 1 || K < 1 || nfreq < 0 || cols != D + 3 + K)
    return (int)cudaErrorInvalidValue;
  const auto* g = static_cast<const float*>(ent_geo);
  const auto* fk = static_cast<const float*>(ent_fk);
  const auto* c = static_cast<const float*>(ctr_geo);
  const auto* r = static_cast<const int*>(ctr_ent);
  const auto* dt = static_cast<const float*>(dtf);
  auto* o = static_cast<float*>(out);
  auto* t = static_cast<float*>(tot);
  auto st = static_cast<cudaStream_t>(stream);
  const int key = D * 8 + (ladder ? 4 : 0) + (with_totals ? 2 : 0) +
                  (L > 4 ? 1 : 0);
  switch (key) {
#define DGS_CASE(DD, LAD, TOT, WIDE)                                        \
  case DD * 8 + LAD * 4 + TOT * 2 + WIDE:                                   \
    return (int)launch<DD, (LAD != 0), (TOT != 0), (WIDE ? 8 : 4)>(         \
        g, fk, Ep, c, cols, Cp, r, dt, L, K, nfreq, E, do_wrap, period, o,  \
        t, st);
#define DGS_DIM(DD)                                                   \
  DGS_CASE(DD, 0, 0, 0) DGS_CASE(DD, 0, 0, 1) DGS_CASE(DD, 0, 1, 0)   \
  DGS_CASE(DD, 0, 1, 1) DGS_CASE(DD, 1, 0, 0) DGS_CASE(DD, 1, 0, 1)   \
  DGS_CASE(DD, 1, 1, 0) DGS_CASE(DD, 1, 1, 1)
    DGS_DIM(1) DGS_DIM(2) DGS_DIM(3)
#undef DGS_DIM
#undef DGS_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
