// Per-pair math of the neighbour aggregation, shared by the port's three
// aggregation kernels (agg_totals.cu, agg_forward.cu, agg_backward.cu).
//
// The same closed forms as dgs_tpu_torch/kernels/aggregate.py's plain
// versions (and dgs_tpu/kernels/aggregate.py), for one (centre i, entry j)
// pair:
//
//   X    = mu_j' - mu_i (wrapped onto the torus where the caller asks)
//   kept = r_i >= 1e-6 and r_j >= 1e-6 and |X|^2 <= (r_i + r_j)^2
//          and the neighbour's quadratic form is not positive
//   G    = exp(-1/2 X^T C_j X)                    (the NEIGHBOUR's conic)
//   w    = <q_i, k_j>
//   Xn   = X * inv_norm_i
//   code: for dim d, rung e, phase = (f_e pi) Xn_d, i0 = d stride + 2 e,
//     emb = dt[E-1]  + sum sin(phase) dt[i0]     + cos(phase) dt[i0+1]
//     fac = dt[2E-1] + sum sin(phase) dt[E+i0]   + cos(phase) dt[E+i0+1]
//   forward:  pre_i[l] += G w inv_tot_i (fac feat_j[l] + emb)
//   backward (cotangent g_i pre-scaled by inv_tot_i, gsum = sum_l g_i[l],
//   gdotf = <g_i, feat_j>):
//     dfeat_j[l] += g_i[l] G w fac
//     dw = G (fac gdotf + emb gsum);  dkey_j += q_i dw;  dq_i += k_j dw
//     cemb = G w gsum, cfac = G w gdotf
//     ddt[i0] += cemb sin, ddt[i0+1] += cemb cos, ddt[E-1] += cemb,
//     ddt[E+i0] += cfac sin, ddt[E+i0+1] += cfac cos, ddt[2E-1] += cfac
//     dfreq[e] += (cemb (cos dt[i0] - sin dt[i0+1])
//                  + cfac (cos dt[E+i0] - sin dt[E+i0+1])) pi Xn_d
//
// With LADDER the caller certifies f_e = (e + 1) f_0: only the base phase
// takes sin/cos, the higher rungs follow from the angle-addition recurrence.
// All arithmetic is fp32 with the accurate expf / sincosf (the phase reaches
// tens of radians, where the fast intrinsics lose digits): build without
// --use_fast_math.  Every function also compiles for the host, so that a
// test can hold it against the torch formulas.
#pragma once

#include <math.h>

#include "pair_math.cuh"

namespace dgs {

constexpr float kAggAlive = 1e-6f;  // radii below this are culled
constexpr float kPi = 3.14159265358979323846f;

// A product and a sum that the compiler may not fuse into an FMA: the
// collision test compares two rounded quantities, and the plain version
// rounds each product and each sum.
DGS_HD float mul_rn(float a, float b) {
#if defined(__CUDA_ARCH__)
  return __fmul_rn(a, b);
#else
  return a * b;
#endif
}

DGS_HD float add_rn(float a, float b) {
#if defined(__CUDA_ARCH__)
  return __fadd_rn(a, b);
#else
  return a + b;
#endif
}

DGS_HD void sincos_accurate(float x, float& s, float& c) {
#if defined(__CUDA_ARCH__)
  sincosf(x, &s, &c);
#else
  s = sinf(x);
  c = cosf(x);
#endif
}

// X = mu_j - mu_i, wrapped when do_wrap.
template <int D>
DGS_HD void agg_offset(const float (&mu_j)[D], const float (&mu_i)[D],
                       int do_wrap, float period, float (&X)[D]) {
#pragma unroll
  for (int d = 0; d < D; ++d) {
    X[d] = mu_j[d] - mu_i[d];
    if (do_wrap) X[d] = wrap(X[d], period);
  }
}

// The collision mask without the quadratic form: both radii alive and
// |X|^2 <= (r_i + r_j)^2, each product and sum rounded as the plain version
// rounds it.  The cheap candidate test of the warp sweeps (agg_sweep.cuh).
template <int D>
DGS_HD bool agg_candidate(const float (&X)[D], float r_i, float r_j) {
  if (!(r_j >= kAggAlive) || !(r_i >= kAggAlive)) return false;
  float dist2 = 0.0f;
#pragma unroll
  for (int d = 0; d < D; ++d) dist2 = add_rn(dist2, mul_rn(X[d], X[d]));
  const float rr = add_rn(r_i, r_j);
  return dist2 <= mul_rn(rr, rr);
}

// The collision mask and the density.  Returns false, leaving G unwritten,
// for a pair that contributes nothing: a culled radius on either side, a
// distance beyond the sum of the radii, or a positive quadratic form.  The
// test is agg_candidate's, written out: the totals kernel, built on top of
// agg_candidate, ran 10-18% slower on the H100.
template <int D>
DGS_HD bool agg_density(const float (&X)[D], const float (&con)[tri_size(D)],
                        float r_i, float r_j, float& G) {
  if (!(r_j >= kAggAlive) || !(r_i >= kAggAlive)) return false;
  float dist2 = 0.0f;
#pragma unroll
  for (int d = 0; d < D; ++d) dist2 = add_rn(dist2, mul_rn(X[d], X[d]));
  const float rr = add_rn(r_i, r_j);
  if (!(dist2 <= mul_rn(rr, rr))) return false;
  float a[D];
  return pair_power<D>(X, con, a, G);
}

// sum_k a[k * sa] b[k * sb]: the attention weight and the cotangent-feature
// product, over operands that ride shared-memory columns.
DGS_HD float dot_strided(const float* a, int sa, const float* b, int sb,
                         int n) {
  float acc = 0.0f;
  for (int k = 0; k < n; ++k) acc = fmaf(a[k * sa], b[k * sb], acc);
  return acc;
}

// The sinusoidal code of one normalised offset: emb and fac.  dt holds the
// 2E distance-transform entries, freq the nfreq frequencies.
template <int D, bool LADDER>
DGS_HD void agg_code(const float (&Xn)[D], const float* dt, const float* freq,
                     int nfreq, int E, float& emb, float& fac) {
  const int stride = (E - 1) / D;
  emb = dt[E - 1];
  fac = dt[2 * E - 1];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    float s = 0.0f, c = 0.0f, s1 = 0.0f, c1 = 0.0f;
    for (int e = 0; e < nfreq; ++e) {
      if (LADDER && e > 0) {
        const float t = s * c1 + c * s1;
        c = c * c1 - s * s1;
        s = t;
      } else {
        sincos_accurate((freq[e] * kPi) * Xn[d], s, c);
        if (LADDER) {
          s1 = s;
          c1 = c;
        }
      }
      const int i0 = d * stride + 2 * e;
      emb += s * dt[i0] + c * dt[i0 + 1];
      fac += s * dt[E + i0] + c * dt[E + i0 + 1];
    }
  }
}

// The same code with its sin / cos terms kept (sn[d * NF + e], cs[...]),
// for the backward's distance-transform and frequency partials.
template <int D, int NF, bool LADDER>
DGS_HD void agg_code_terms(const float (&Xn)[D], const float* dt,
                           const float* freq, int E, float& emb, float& fac,
                           float (&sn)[D * NF], float (&cs)[D * NF]) {
  const int stride = (E - 1) / D;
  emb = dt[E - 1];
  fac = dt[2 * E - 1];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    float s = 0.0f, c = 0.0f, s1 = 0.0f, c1 = 0.0f;
#pragma unroll
    for (int e = 0; e < NF; ++e) {
      if (LADDER && e > 0) {
        const float t = s * c1 + c * s1;
        c = c * c1 - s * s1;
        s = t;
      } else {
        sincos_accurate((freq[e] * kPi) * Xn[d], s, c);
        if (LADDER) {
          s1 = s;
          c1 = c;
        }
      }
      const int i0 = d * stride + 2 * e;
      emb += s * dt[i0] + c * dt[i0 + 1];
      fac += s * dt[E + i0] + c * dt[E + i0 + 1];
      sn[d * NF + e] = s;
      cs[d * NF + e] = c;
    }
  }
}

// Accumulators of one centre's code partials, DN = D * NF:
//   [0, DN) cemb sin   [DN, 2DN) cemb cos   [2DN, 3DN) cfac sin
//   [3DN, 4DN) cfac cos   [4DN] cemb   [4DN + 1] cfac   [4DN + 2 + e] dfreq_e
// Adds one pair's code partials into acc (layout above).
template <int D, int NF>
DGS_HD void agg_code_partials(const float (&Xn)[D], const float* dt, int E,
                              float cemb, float cfac,
                              const float (&sn)[D * NF],
                              const float (&cs)[D * NF],
                              float (&acc)[4 * D * NF + 2 + NF]) {
  constexpr int DN = D * NF;
  const int stride = (E - 1) / D;
#pragma unroll
  for (int d = 0; d < D; ++d) {
#pragma unroll
    for (int e = 0; e < NF; ++e) {
      const int t = d * NF + e, i0 = d * stride + 2 * e;
      const float s = sn[t], c = cs[t];
      acc[t] += cemb * s;
      acc[DN + t] += cemb * c;
      acc[2 * DN + t] += cfac * s;
      acc[3 * DN + t] += cfac * c;
      const float dphase = cemb * (c * dt[i0] - s * dt[i0 + 1]) +
                           cfac * (c * dt[E + i0] - s * dt[E + i0 + 1]);
      acc[4 * DN + 2 + e] += dphase * (kPi * Xn[d]);
    }
  }
  acc[4 * DN] += cemb;
  acc[4 * DN + 1] += cfac;
}

// Scatters a centre's accumulators into its output row: ddt (2E entries,
// those no (d, e) term touches stay as the caller zeroed them) then dfreq.
template <int D, int NF>
DGS_HD void agg_code_store(const float (&acc)[4 * D * NF + 2 + NF], int E,
                           float* ddt, float* dfreq) {
  constexpr int DN = D * NF;
  const int stride = (E - 1) / D;
#pragma unroll
  for (int d = 0; d < D; ++d) {
#pragma unroll
    for (int e = 0; e < NF; ++e) {
      const int t = d * NF + e, i0 = d * stride + 2 * e;
      ddt[i0] = acc[t];
      ddt[i0 + 1] = acc[DN + t];
      ddt[E + i0] = acc[2 * DN + t];
      ddt[E + i0 + 1] = acc[3 * DN + t];
    }
  }
  ddt[E - 1] = acc[4 * DN];
  ddt[2 * E - 1] = acc[4 * DN + 1];
#pragma unroll
  for (int e = 0; e < NF; ++e) dfreq[e] = acc[4 * DN + 2 + e];
}

// Shared-memory staging of a block's own range (agg_totals.cu): the union
// of its threads' [lo, hi) ranges (threads with an empty range stay out).
// Device only.
#if defined(__CUDACC__)
__device__ __forceinline__ void block_range(int lo, int hi, int* s_range,
                                            int& blo, int& bhi) {
  if (threadIdx.x == 0) {
    s_range[0] = 0x7fffffff;
    s_range[1] = 0;
  }
  __syncthreads();
  if (lo < hi) {
    atomicMin(&s_range[0], lo);
    atomicMax(&s_range[1], hi);
  }
  __syncthreads();
  blo = s_range[0];
  bhi = s_range[1];
}
#endif

}  // namespace dgs
