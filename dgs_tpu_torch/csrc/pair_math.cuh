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
// pair_vjp is the per-pair backward (formulas.vjp_params_fused).
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

// a = C X and G = exp(-1/2 a.X) for one pair.  Returns false, leaving G
// unwritten, when the pair's quadratic form is positive (the pair is
// skipped, as formulas.power_terms masks it).
template <int D>
DGS_HD bool pair_power(const float (&X)[D], const float (&con)[tri_size(D)],
                       float (&a)[D], float& G) {
#pragma unroll
  for (int l = 0; l < D; ++l) {
    a[l] = 0.0f;
#pragma unroll
    for (int m = 0; m < D; ++m) a[l] += con[tri_index(D, l, m)] * X[m];
  }
  float power = 0.0f;
#pragma unroll
  for (int l = 0; l < D; ++l) power += a[l] * X[l];
  power *= -0.5f;
  if (power > 0.0f) return false;
  G = expf(power);
  return true;
}

// The unique components of every order in MASK for one kept pair, written
// to w in canonical order (value, derivative, laplacian, third).
template <int D, int MASK>
DGS_HD void component_weights(const float (&con)[tri_size(D)],
                              const float (&a)[D], float G,
                              float (&w)[total_unique(D, MASK)]) {
  int k = 0;
  if (MASK & kValue) w[k++] = G;
  if (MASK & kDerivative) {
#pragma unroll
    for (int i = 0; i < D; ++i) w[k++] = G * a[i];
  }
  if (MASK & kLaplacian) {
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int j = i; j < D; ++j)
        w[k++] = G * (a[i] * a[j] - con[tri_index(D, i, j)]);
  }
  if (MASK & kThird) {
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int j = i; j < D; ++j)
#pragma unroll
        for (int l = j; l < D; ++l)
          w[k++] = G * (con[tri_index(D, i, j)] * a[l] +
                        con[tri_index(D, i, l)] * a[j] +
                        con[tri_index(D, j, l)] * a[i] - a[i] * a[j] * a[l]);
  }
}

// The unique components of every order in MASK for one pair, written to w
// in canonical order.  Returns false, leaving w unwritten, when the pair's
// quadratic form is positive.
template <int D, int MASK>
DGS_HD bool pair_weights(const float (&X)[D], const float (&con)[tri_size(D)],
                         float (&w)[total_unique(D, MASK)]) {
  float a[D], G;
  if (!pair_power<D>(X, con, a, G)) return false;
  component_weights<D, MASK>(con, a, G, w);
  return true;
}

// The per-pair VJP of every order in MASK (formulas.vjp_params_fused), added
// into the entry's mean and packed-conic gradient rows.  h[k] is the
// channel-folded cotangent of unique component k in canonical order,
// h_k = sum_c values_c * dL/dout[k, c]; (a, G) come from pair_power for
// the same (X, con).  With
//   S0  = sum_u h~_u q_u,  W_l = sum_u h~_u dq_u/da_l   (h~ = -h for third,
//   whose component is -q_ijk),  hl the laplacian cotangents and Y the
//   thirds' explicit conic terms,
//   dmu_d      += G ((C W)_d - a_d S0)
//   dcon_(u,v) += G (X_v z_u + X_u z_v - hl_uv + Y_uv),  z = W - X S0 / 2
// (u == v: G (X_u z_u - hl_uu + Y_uu)).  The whole function is linear in h,
// so a caller may split h over channel groups and add the results.
template <int D, int MASK>
DGS_HD void pair_vjp(const float (&X)[D], const float (&con)[tri_size(D)],
                     const float (&a)[D], float G,
                     const float (&h)[total_unique(D, MASK)],
                     float (&dmu)[D], float (&dcon)[tri_size(D)]) {
  constexpr int TRI = tri_size(D);
  float S0 = 0.0f, W[D], HL[TRI], Y[TRI];
#pragma unroll
  for (int l = 0; l < D; ++l) W[l] = 0.0f;
#pragma unroll
  for (int t = 0; t < TRI; ++t) HL[t] = Y[t] = 0.0f;

  int k = 0;
  if (MASK & kValue) S0 += h[k++];
  if (MASK & kDerivative) {
#pragma unroll
    for (int i = 0; i < D; ++i, ++k) {
      S0 += h[k] * a[i];
      W[i] += h[k];
    }
  }
  if (MASK & kLaplacian) {
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int j = i; j < D; ++j, ++k) {
        const int t = tri_index(D, i, j);
        S0 += h[k] * (a[i] * a[j] - con[t]);
        HL[t] = h[k];
        if (i == j) {
          W[i] += 2.0f * h[k] * a[i];
        } else {
          W[i] += h[k] * a[j];
          W[j] += h[k] * a[i];
        }
      }
  }
  if (MASK & kThird) {
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int j = i; j < D; ++j)
#pragma unroll
        for (int l = j; l < D; ++l, ++k) {
          const int tij = tri_index(D, i, j), til = tri_index(D, i, l),
                    tjl = tri_index(D, j, l);
          S0 += h[k] * (con[tij] * a[l] + con[til] * a[j] + con[tjl] * a[i] -
                        a[i] * a[j] * a[l]);
          W[i] -= h[k] * (a[j] * a[l] - con[tjl]);
          W[j] -= h[k] * (a[i] * a[l] - con[til]);
          W[l] -= h[k] * (a[i] * a[j] - con[tij]);
          Y[tij] += h[k] * a[l];
          Y[til] += h[k] * a[j];
          Y[tjl] += h[k] * a[i];
        }
  }

#pragma unroll
  for (int d = 0; d < D; ++d) {
    float cw = 0.0f;
#pragma unroll
    for (int l = 0; l < D; ++l) cw += con[tri_index(D, d, l)] * W[l];
    dmu[d] += G * (cw - a[d] * S0);
  }
  float z[D];
#pragma unroll
  for (int l = 0; l < D; ++l) z[l] = W[l] - X[l] * (0.5f * S0);
#pragma unroll
  for (int u = 0; u < D; ++u)
#pragma unroll
    for (int v = u; v < D; ++v) {
      const int t = tri_index(D, u, v);
      const float term = (u == v) ? X[u] * z[u] : X[v] * z[u] + X[u] * z[v];
      dcon[t] += G * (term - HL[t] + Y[t]);
    }
}

}  // namespace dgs
