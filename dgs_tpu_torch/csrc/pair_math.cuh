// Per-pair Gaussian evaluation math shared by the port's CUDA kernels.
//
// The same closed forms as dgs_tpu_torch/ops/formulas.py (and
// dgs_tpu/ops/formulas.py), for one (entry, sample) pair:
//
//   X = mu' - x (wrapped onto the torus where the caller asks), a = C X,
//   power = -1/2 a.X, G = exp(power), zero where power > 0,
//   value      G
//   derivative G a_i                                    i
//   laplacian  G (a_i a_j - C_ij)                       i <= j
//   third      G (C_ij a_k + C_ik a_j + C_jk a_i - a_i a_j a_k)  i <= j <= k
//
// Only the unique (canonical-index) components are produced, in the order
// of formulas.sym_indices; the public layer mirrors the symmetric tensors.
// pair_vjp is the per-pair backward (formulas.vjp_params_fused), built from
// what the forward half of the pair already produced (a, G, the polynomials
// q_ij and the weights w_k).
// All arithmetic is fp32 with the accurate expf: build without
// --use_fast_math, or G drifts at the 3-sigma edge.
#pragma once

#include <math.h>

#if defined(__CUDACC__)
#define DGS_HD __host__ __device__ __forceinline__
#else
#define DGS_HD inline
#endif

namespace dgs {

// Bits of an order set, in the canonical order of dgs_tpu.config.ORDERS.
constexpr int kValue = 1;
constexpr int kDerivative = 2;
constexpr int kLaplacian = 4;
constexpr int kThird = 8;

DGS_HD constexpr int tri_size(int D) { return D * (D + 1) / 2; }

// Packed row-major upper-triangle index of (i, j).
DGS_HD constexpr int tri_index(int D, int i, int j) {
  return (i <= j) ? i * D - i * (i - 1) / 2 + (j - i)
                  : j * D - j * (j - 1) / 2 + (i - j);
}

// Unique components of one order: 1, D, D(D+1)/2, D(D+1)(D+2)/6.
DGS_HD constexpr int n_unique(int order_bit, int D) {
  return order_bit == kValue        ? 1
         : order_bit == kDerivative ? D
         : order_bit == kLaplacian  ? D * (D + 1) / 2
                                    : D * (D + 1) * (D + 2) / 6;
}

DGS_HD constexpr int total_unique(int D, int mask) {
  return ((mask & kValue) ? n_unique(kValue, D) : 0) +
         ((mask & kDerivative) ? n_unique(kDerivative, D) : 0) +
         ((mask & kLaplacian) ? n_unique(kLaplacian, D) : 0) +
         ((mask & kThird) ? n_unique(kThird, D) : 0);
}

// Minimum-image displacement on a torus of the given period (rintf rounds
// half to even, as jnp.round and torch.round do).
DGS_HD float wrap(float x, float period) {
  return x - period * rintf(x / period);
}

// The same displacement with the division replaced by a multiplication by
// inv_period = 1 / period.  Bitwise equal to wrap() when the period is a
// power of two (both quotients are exact); callers use it only then.
DGS_HD float wrap_scaled(float x, float period, float inv_period) {
  return x - period * rintf(x * inv_period);
}

// 1 / period where wrap_scaled() is exact (a power of two), else 0: the
// kernels' inv_period argument.
inline float exact_inv_period(float period) {
  int e;
  return (period > 0.0f && frexpf(period, &e) == 0.5f) ? 1.0f / period : 0.0f;
}

// x wrapped as the kernel was told to: WRAP is false for the unwrapped
// kernels; inv_period is 1 / period where wrap_scaled is exact, else 0.
template <bool WRAP>
DGS_HD float wrap_by(float x, float period, float inv_period) {
  if (!WRAP) return x;
  return inv_period != 0.0f ? wrap_scaled(x, period, inv_period)
                            : wrap(x, period);
}

// a = C X and the pair's exponent -1/2 a.X.
template <int D>
DGS_HD float pair_form(const float (&X)[D], const float (&con)[tri_size(D)],
                       float (&a)[D]) {
#pragma unroll
  for (int l = 0; l < D; ++l) {
    a[l] = 0.0f;
#pragma unroll
    for (int m = 0; m < D; ++m) a[l] += con[tri_index(D, l, m)] * X[m];
  }
  float power = 0.0f;
#pragma unroll
  for (int l = 0; l < D; ++l) power += a[l] * X[l];
  return -0.5f * power;
}

// a = C X and G = exp(-1/2 a.X) for one pair.  Returns false, leaving G
// unwritten, when the pair's quadratic form is positive (the pair is
// skipped, as formulas.power_terms masks it).
template <int D>
DGS_HD bool pair_power(const float (&X)[D], const float (&con)[tri_size(D)],
                       float (&a)[D], float& G) {
  const float power = pair_form<D>(X, con, a);
  if (power > 0.0f) return false;
  G = expf(power);
  return true;
}

// The same G, 0 where the quadratic form is positive, without a branch: for
// sweeps that keep every lane in step and unroll over pairs.
template <int D>
DGS_HD float pair_gauss(const float (&X)[D], const float (&con)[tri_size(D)],
                        float (&a)[D]) {
  const float power = pair_form<D>(X, con, a);
  const float G = expf(power > 0.0f ? 0.0f : power);
  return power > 0.0f ? 0.0f : G;
}

// The second-order polynomials q_ij = a_i a_j - C_ij (i <= j, packed as the
// conic).  The laplacian weights are G q, the third-order weights and the
// VJP are built from the same q, so a pair computes them once.  Written only
// when MASK holds the laplacian or the third order.
template <int D, int MASK>
DGS_HD void pair_polys(const float (&con)[tri_size(D)], const float (&a)[D],
                       float (&q)[tri_size(D)]) {
  if (MASK & (kLaplacian | kThird)) {
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int j = i; j < D; ++j)
        q[tri_index(D, i, j)] = a[i] * a[j] - con[tri_index(D, i, j)];
  }
}

// The unique components of every order in MASK for one kept pair, written
// to w in canonical order (value, derivative, laplacian, third); q from
// pair_polys.  Third order: C_ij a_l + C_il a_j + C_jl a_i - a_i a_j a_l
// = C_ij a_l + C_il a_j - a_i q_jl.
template <int D, int MASK>
DGS_HD void component_weights(const float (&con)[tri_size(D)],
                              const float (&a)[D],
                              const float (&q)[tri_size(D)], float G,
                              float (&w)[total_unique(D, MASK)]) {
  int k = 0;
  if (MASK & kValue) w[k++] = G;
  if (MASK & kDerivative) {
#pragma unroll
    for (int i = 0; i < D; ++i) w[k++] = G * a[i];
  }
  if (MASK & kLaplacian) {
#pragma unroll
    for (int t = 0; t < tri_size(D); ++t) w[k++] = G * q[t];
  }
  if (MASK & kThird) {
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int j = i; j < D; ++j)
#pragma unroll
        for (int l = j; l < D; ++l)
          w[k++] = G * (con[tri_index(D, i, j)] * a[l] +
                        con[tri_index(D, i, l)] * a[j] -
                        a[i] * q[tri_index(D, j, l)]);
  }
}

// The unique components of every order in MASK for one pair, written to w
// in canonical order.  Returns false, leaving w unwritten, when the pair's
// quadratic form is positive.
template <int D, int MASK>
DGS_HD bool pair_weights(const float (&X)[D], const float (&con)[tri_size(D)],
                         float (&w)[total_unique(D, MASK)]) {
  float a[D], G, q[tri_size(D)];
  if (!pair_power<D>(X, con, a, G)) return false;
  pair_polys<D, MASK>(con, a, q);
  component_weights<D, MASK>(con, a, q, G, w);
  return true;
}

// The per-pair VJP of every order in MASK (formulas.vjp_params_fused), added
// into the entry's mean and packed-conic gradient rows.  h[k] is the
// channel-folded cotangent of unique component k in canonical order,
// h_k = sum_c values_c * dL/dout[k, c]; (a, G) come from pair_power, q from
// pair_polys and w from component_weights for the same (X, con): nothing
// the pair already has is computed again.  With
//   G S0 = sum_k h_k w_k  (w_k is G times the component's polynomial, the
//   third order's sign included),
//   W_l  = sum_k h_k d(poly_k)/da_l: h_i (derivative), h_ij a_j (+ h_ij a_i,
//   laplacian), -h_ijl q_jl and its two permutations (third),
//   hl the laplacian cotangents and Y_ij = sum h_ijl a_l the thirds'
//   explicit conic terms,
//   dmu_d      += G (C W)_d - a_d G S0
//   dcon_(u,v) += X_v z_u + X_u z_v + G (Y_uv - hl_uv),  z = G W - X G S0 / 2
// (u == v: X_u z_u + G (Y_uu - hl_uu)).  Every term is added into the rows
// as its own multiply-add, so the function issues about one instruction per
// term.  The whole function is linear in h, so a caller may split h over
// channel groups and add the results.
template <int D, int MASK>
DGS_HD void pair_vjp(const float (&X)[D], const float (&con)[tri_size(D)],
                     const float (&a)[D], const float (&q)[tri_size(D)],
                     float G, const float (&w)[total_unique(D, MASK)],
                     const float (&h)[total_unique(D, MASK)],
                     float (&dmu)[D], float (&dcon)[tri_size(D)]) {
  constexpr int TRI = tri_size(D);
  constexpr int K = total_unique(D, MASK);
  // First cotangent of each order in h.
  constexpr int kd = (MASK & kValue) ? 1 : 0;
  constexpr int kl = kd + ((MASK & kDerivative) ? D : 0);
  constexpr int kt = kl + ((MASK & kLaplacian) ? TRI : 0);

  float GS = h[0] * w[0];
#pragma unroll
  for (int k = 1; k < K; ++k) GS += h[k] * w[k];

  // W starts from the derivative cotangents (no 0 + h), Y from zero only
  // where the third order feeds it; the laplacian's -hl goes straight into
  // the conic rows.
  float W[D], Y[TRI];
#pragma unroll
  for (int l = 0; l < D; ++l) W[l] = (MASK & kDerivative) ? h[kd + l] : 0.0f;
  if (MASK & kLaplacian) {
    int k = kl;
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int j = i; j < D; ++j, ++k) {
        dcon[tri_index(D, i, j)] -= G * h[k];
        if (i == j) {
          W[i] += (h[k] + h[k]) * a[i];
        } else {
          W[i] += h[k] * a[j];
          W[j] += h[k] * a[i];
        }
      }
  }
  if (MASK & kThird) {
#pragma unroll
    for (int t = 0; t < TRI; ++t) Y[t] = 0.0f;
    int k = kt;
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int j = i; j < D; ++j)
#pragma unroll
        for (int l = j; l < D; ++l, ++k) {
          const int tij = tri_index(D, i, j), til = tri_index(D, i, l),
                    tjl = tri_index(D, j, l);
          W[i] -= h[k] * q[tjl];
          W[j] -= h[k] * q[til];
          W[l] -= h[k] * q[tij];
          Y[tij] += h[k] * a[l];
          Y[til] += h[k] * a[j];
          Y[tjl] += h[k] * a[i];
        }
#pragma unroll
    for (int t = 0; t < TRI; ++t) dcon[t] += G * Y[t];
  }

  const float half_GS = 0.5f * GS;
  float z[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    float cw = con[tri_index(D, d, 0)] * W[0];
#pragma unroll
    for (int l = 1; l < D; ++l) cw += con[tri_index(D, d, l)] * W[l];
    dmu[d] += G * cw;
    dmu[d] -= a[d] * GS;
    z[d] = G * W[d] - X[d] * half_GS;
  }
#pragma unroll
  for (int u = 0; u < D; ++u)
#pragma unroll
    for (int v = u; v < D; ++v) {
      const int t = tri_index(D, u, v);
      dcon[t] += X[v] * z[u];
      if (u != v) dcon[t] += X[u] * z[v];
    }
}

}  // namespace dgs
