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

// The unique components of every order in MASK for one pair, written to w
// in canonical order (value, derivative, laplacian, third).  Returns false,
// leaving w unwritten, when the pair's quadratic form is positive.
template <int D, int MASK>
DGS_HD bool pair_weights(const float (&X)[D], const float (&con)[tri_size(D)],
                         float (&w)[total_unique(D, MASK)]) {
  float a[D];
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
  const float G = expf(power);

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
  return true;
}

}  // namespace dgs
