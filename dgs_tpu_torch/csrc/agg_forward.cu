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
// Design: the warp sweep of agg_sweep.cuh over the centres.  A warp takes
// `rows` consecutive tile-sorted centres (the wrapper's pick, 1 to 32) and
// its lanes test their entry ranges 32 candidates a step; only the pairs
// that pass the distance test reach the body, 32 at a time.  A pair's
// partials are fac feat_j[l] coeff + emb coeff for the LB features of the
// pass (coeff = G <q_i, k_j> inv_tot_i), and G with TOTALS.  L above LB
// takes further passes (LB is 4 or 8, the wrapper's pick, so L <= 8 is one
// pass).  Entry and centre operands are read through L1: every warp of a
// tile reads the same entry columns.
//
// What bounds it.  A colliding pair costs the K-term dot product, the code's
// sin / cos (2 D nfreq accurate sincosf, or 2 D with the ladder recurrence:
// 4 FMAs a rung), 4 FMAs per (dim, rung) for emb and fac, and LB FMAs; a
// candidate that fails the mask costs its loads, the offset and the distance
// test on a 32-lane step.  Bound by fp32 and special-function issue, not by
// device memory; where a tile holds hundreds of entries (the dynamics
// trainer's cloud) the candidate tests outnumber the colliding pairs 16 to
// 1 and the sweep waits on their loads and shuffles, so resident warps
// count (kMinBlocks).
//
// Built by dgs_tpu_torch/kernels/_build.py (nvcc, sm_90a, plain C ABI,
// ctypes).  Never with --use_fast_math (see agg_math.cuh).
#include <cuda_runtime.h>

#include "agg_sweep.cuh"

namespace {

constexpr int kWarps = 4;  // warps a block
// Blocks an SM that the kernel asks ptxas to fit (at most 56 registers):
// the sweep waits on loads and shuffles, so resident warps matter (on the
// H100, 9 blocks ran 4% faster than 8 and 20% faster than 1).  With the
// maximum of threads alone, ptxas spilled in some instantiations.
constexpr int kMinBlocks = 9;
constexpr int kBlock = kWarps * dgs::kSweepWarp;
constexpr int kMaxCode = 2048;  // 2E + nfreq floats of dynamic shared memory

template <int D, bool LADDER, bool TOTALS, int LB>
__global__ void __launch_bounds__(kBlock, kMinBlocks) agg_forward_kernel(
    const float* __restrict__ ent_geo,  // (D + tri + 1, Ep): mu', conic, r
    const float* __restrict__ ent_fk,   // (L + K, Ep): features, keys
    long long Ep,
    const float* __restrict__ ctr_geo,  // (Cp, D + 3 + K): mu, r, inv_norm,
    int cols, long long Cp,             //   inv_tot, queries
    const int* __restrict__ ctr_ent,    // (2, Cp): entry range of each centre
    const float* __restrict__ dtf,      // (2E + nfreq,): dt, frequencies
    int L, int K, int nfreq, int E, int do_wrap, float period, int rows,
    float* __restrict__ out,            // (Cp, L)
    float* __restrict__ tot_out) {      // (Cp,) with TOTALS
  constexpr int TRI = dgs::tri_size(D);
  constexpr int W = LB + (TOTALS ? 1 : 0);
  static_assert(kWarps * sizeof(dgs::SweepScratch<W>) +
                        kMaxCode * sizeof(float) <= 48 * 1024,
                "shared memory must stay under 48 KB");
  __shared__ dgs::SweepScratch<W> s_sweep[kWarps];
  extern __shared__ float s_dt[];       // 2E + nfreq: dt, frequencies
  const int ndt = 2 * E + nfreq;
  for (int t = threadIdx.x; t < ndt; t += kBlock) s_dt[t] = dtf[t];
  __syncthreads();

  const int warp = threadIdx.x / dgs::kSweepWarp;
  const int lane = threadIdx.x % dgs::kSweepWarp;
  const long long row0 = ((long long)blockIdx.x * kWarps + warp) * rows;
  if (row0 >= Cp) return;
  const int nrows = (int)min((long long)rows, Cp - row0);
  // Lane s < nrows holds centre s's range, mean and radius.
  float mu_r[D], r_r = 0.0f;
  int lo = 0, hi = 0;
  if (lane < nrows) {
    const long long i = row0 + lane;
#pragma unroll
    for (int d = 0; d < D; ++d) mu_r[d] = ctr_geo[i * cols + d];
    r_r = ctr_geo[i * cols + D];
    lo = ctr_ent[i];
    hi = ctr_ent[Cp + i];
  } else {
#pragma unroll
    for (int d = 0; d < D; ++d) mu_r[d] = 0.0f;
  }

  for (int l0 = 0; l0 < L; l0 += LB) {
    auto cand = [&](bool in, int slot, int j) {
      float mu_i[D], mu_j[D], X[D];
#pragma unroll
      for (int d = 0; d < D; ++d) mu_i[d] = __shfl_sync(~0u, mu_r[d], slot);
      const float r_i = __shfl_sync(~0u, r_r, slot);
      if (!in) return false;
#pragma unroll
      for (int d = 0; d < D; ++d) mu_j[d] = ent_geo[d * Ep + j];
      dgs::agg_offset<D>(mu_j, mu_i, do_wrap, period, X);
      return dgs::agg_candidate<D>(X, r_i, ent_geo[(D + TRI) * Ep + j]);
    };
    auto body = [&](int slot, int j, float* p) {
      const float* c = ctr_geo + (row0 + slot) * cols;
      float mu_i[D], mu_j[D], X[D], con[TRI], a[D], G = 0.0f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        mu_i[d] = c[d];
        mu_j[d] = ent_geo[d * Ep + j];
      }
#pragma unroll
      for (int t = 0; t < TRI; ++t) con[t] = ent_geo[(D + t) * Ep + j];
      dgs::agg_offset<D>(mu_j, mu_i, do_wrap, period, X);
      if (!dgs::pair_power<D>(X, con, a, G)) G = 0.0f;
      float w = 0.0f;
      for (int k = 0; k < K; ++k)
        w = fmaf(c[D + 3 + k], ent_fk[(L + k) * Ep + j], w);
      const float inv_norm = c[D + 1];
      float Xn[D], emb, fac;
#pragma unroll
      for (int d = 0; d < D; ++d) Xn[d] = X[d] * inv_norm;
      dgs::agg_code<D, LADDER>(Xn, s_dt, s_dt + 2 * E, nfreq, E, emb, fac);
      const float coeff = G * w * c[D + 2];
      const float cf = coeff * fac, ce = coeff * emb;
#pragma unroll
      for (int l = 0; l < LB; ++l)
        p[l * dgs::kPartStride] =
            l0 + l < L ? fmaf(cf, ent_fk[(l0 + l) * Ep + j], ce) : 0.0f;
      if (TOTALS) p[LB * dgs::kPartStride] = G;
    };
    auto store = [&](int slot, int ch, float v) {
      const long long i = row0 + slot;
      if (ch < LB) {
        if (l0 + ch < L) out[i * L + l0 + ch] = v;
      } else if (TOTALS && ch == LB && l0 == 0) {
        tot_out[i] = v;
      }
    };
    dgs::warp_sweep<W>(s_sweep[warp], nrows, lo, hi, cand, body, store);
  }
}

template <int D, bool LADDER, bool TOTALS, int LB>
cudaError_t launch(const float* ent_geo, const float* ent_fk, long long Ep,
                   const float* ctr_geo, int cols, long long Cp,
                   const int* ctr_ent, const float* dtf, int L, int K,
                   int nfreq, int E, int do_wrap, float period, int rows,
                   float* out, float* tot, cudaStream_t stream) {
  const size_t bytes = sizeof(float) * (size_t)(2 * E + nfreq);
  const long long per_block = (long long)kWarps * rows;
  const dim3 grid((unsigned)((Cp + per_block - 1) / per_block)),
      block(kBlock);
  agg_forward_kernel<D, LADDER, TOTALS, LB><<<grid, block, bytes, stream>>>(
      ent_geo, ent_fk, Ep, ctr_geo, cols, Cp, ctr_ent, dtf, L, K, nfreq, E,
      do_wrap, period, rows, out, tot);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns the CUDA error of the launch
// (0 = launched).  Pointers are device pointers; `tot` is read only with
// with_totals; `rows` (1 to 32) centres a warp.  L <= 4 runs the
// 4-feature instantiation, larger L the 8-feature one (in passes of 8 above
// that).
int dgs_agg_forward(const void* ent_geo, const void* ent_fk, int Ep,
                    const void* ctr_geo, int cols, int Cp,
                    const void* ctr_ent, const void* dtf, int D, int L, int K,
                    int nfreq, int E, int do_wrap, float period, int ladder,
                    int with_totals, int rows, void* out, void* tot,
                    void* stream) {
  if (Cp < 1 || L < 1 || K < 1 || nfreq < 0 || cols != D + 3 + K ||
      rows < 1 || rows > dgs::kSweepWarp || 2 * E + nfreq > kMaxCode)
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
        g, fk, Ep, c, cols, Cp, r, dt, L, K, nfreq, E, do_wrap, period,     \
        rows, o, t, st);
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
