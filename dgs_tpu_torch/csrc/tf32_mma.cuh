// Warp-level TF32 tensor-core contraction with fp32 accumulation, for the
// kernel modes of the tiled kernels (tiled_forward_sep.cu,
// tiled_backward_moments.cu, tiled_forward_folded.cu,
// tiled_backward_folded.cu, tiled_backward_fvjp.cu, and h_matmul in the
// backwards that build h):
// mma.sync.aligned.m16n8k8 on sm_90a.
//
// Precision.  A TF32 operand keeps 10 explicit mantissa bits.  One pass
// multiplies the operands rounded to TF32 (hi * hi): about 3 decimal digits,
// the counterpart of dgs_tpu's Precision.DEFAULT (one bf16 MXU pass), used
// only under the fast-math knob.  Three passes split each fp32 operand into
// hi = tf32(x) and lo = tf32(x - hi) (x - hi is exact in fp32) and sum
// lo * hi + hi * lo + hi * hi, dropping only lo * lo (2^-22 relative) and
// the rounding of lo: fp32-class, the counterpart of Precision.HIGHEST.
// The rounding is round to nearest, ties away from zero (cvt.rna.tf32.f32),
// never truncation.
//
// Fragments of m16n8k8 (row.col), lane = 4 g + t (g = lane / 4, t = lane % 4):
//   A (16 x 8, row-major)  a = {A[g][t], A[g+8][t], A[g][t+4], A[g+8][t+4]}
//   B (8 x 8, column)      b = {B[t][g], B[t+4][g]}
//   C (16 x 8)             c = {C[g][2t], C[g][2t+1], C[g+8][2t], C[g+8][2t+1]}
//
// The split arithmetic is __host__ __device__, so that the CPU tests build it
// with g++ and hold it against numpy (tests/test_torch_tf32_split.py).  Built
// for the host under the emulated CUDA runtime of tests/cuda_emulation.py
// (which defines __CUDACC__ but neither __CUDA_ARCH__ nor __NVCC__),
// mma_tf32 computes the same fragment product from the lanes' registers,
// gathered in one exchange (emu::warp_gather), so that the CPU tests can run
// the kernels that use it.
#pragma once

#include <stdint.h>
#include <string.h>

#include "pair_math.cuh"

namespace dgs {

// x rounded to TF32: round to nearest, ties away from zero, on the 13
// mantissa bits TF32 drops (cvt.rna.tf32.f32); infinities and NaNs pass.
DGS_HD float tf32_round(float x) {
#if defined(__CUDA_ARCH__)
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
#else
  uint32_t u;
  memcpy(&u, &x, 4);
  if ((u & 0x7f800000u) != 0x7f800000u) {
    u += 0x1000u;          // half of the dropped bits, on the magnitude
    u &= 0xffffe000u;
  }
  memcpy(&x, &u, 4);
  return x;
#endif
}

// The 3-pass split: hi = tf32(x), lo = tf32(x - hi).
DGS_HD void tf32_split(float x, float& hi, float& lo) {
  hi = tf32_round(x);
  lo = tf32_round(x - hi);
}

// An operand ready for PASSES passes: hi (1 pass) or hi and lo (3 passes).
template <int PASSES>
struct Tf32 {
  float hi, lo;
};

template <int PASSES>
DGS_HD Tf32<PASSES> tf32_operand(float x) {
  Tf32<PASSES> r;
  if (PASSES == 3) {
    tf32_split(x, r.hi, r.lo);
  } else {
    r.hi = tf32_round(x);
    r.lo = 0.0f;
  }
  return r;
}

// The split with the passes chosen at run time (``three``: 3 passes, else
// 1 with lo = 0), for kernels that take the passes as an argument.
DGS_HD void tf32_split_rt(float x, bool three, float& hi, float& lo) {
  hi = tf32_round(x);
  lo = three ? tf32_round(x - hi) : 0.0f;
}

// The sum of products of one fp32 dot of depth n, computed as the
// tensor-core contraction does per product: lo * hi + hi * lo + hi * hi
// (3 passes) or hi * hi (1 pass), accumulated in fp32 in that order.  A
// model of the kernels' arithmetic for the CPU tests (the tensor core's own
// summation order within one mma differs).
template <int PASSES>
DGS_HD float tf32_dot(const float* a, const float* b, int n) {
  float acc = 0.0f;
  for (int i = 0; i < n; ++i) {
    const Tf32<PASSES> x = tf32_operand<PASSES>(a[i]);
    const Tf32<PASSES> y = tf32_operand<PASSES>(b[i]);
    if (PASSES == 3) {
      acc += x.lo * y.hi;
      acc += x.hi * y.lo;
    }
    acc += x.hi * y.hi;
  }
  return acc;
}

#if defined(__CUDACC__)
// c += A * B of one m16n8k8 tile, operands already rounded to TF32.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const float (&a)[4],
                                         const float (&b)[2]) {
#if defined(__CUDA_ARCH__)
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(__float_as_uint(a[0])), "r"(__float_as_uint(a[1])),
        "r"(__float_as_uint(a[2])), "r"(__float_as_uint(a[3])),
        "r"(__float_as_uint(b[0])), "r"(__float_as_uint(b[1])));
#elif !defined(__NVCC__)
  // The same product from the lanes' fragments (every lane takes part),
  // gathered in one exchange of the warp's registers.
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const float mine[6] = {a[0], a[1], a[2], a[3], b[0], b[1]};
  float all[32][6];
  emu::warp_gather(mine, all);
  for (int r = 0; r < 2; ++r)
    for (int h = 0; h < 2; ++h) {
      float s = c[2 * r + h];
      // A[g + 8r][k] is lane 4 g + k % 4's register r + 2 (k / 4); B[k][n]
      // is lane 4 n + k % 4's register 4 + k / 4.
      for (int k = 0; k < 8; ++k)
        s += all[4 * g + k % 4][r + 2 * (k / 4)] *
             all[4 * (2 * t + h) + k % 4][4 + k / 4];
      c[2 * r + h] = s;
    }
#endif
}

// c += A * B in PASSES passes from split operands: the small terms first,
// then hi * hi.
template <int PASSES>
__device__ __forceinline__ void mma_passes(float (&c)[4],
                                           const float (&a_hi)[4],
                                           const float (&a_lo)[4],
                                           const float (&b_hi)[2],
                                           const float (&b_lo)[2]) {
  if (PASSES == 3) {
    mma_tf32(c, a_lo, b_hi);
    mma_tf32(c, a_hi, b_lo);
  }
  mma_tf32(c, a_hi, b_hi);
}

// The same with the passes chosen at run time (uniform across the warp).
__device__ __forceinline__ void mma_passes_rt(float (&c)[4],
                                              const float (&a_hi)[4],
                                              const float (&a_lo)[4],
                                              const float (&b_hi)[2],
                                              const float (&b_lo)[2],
                                              bool three) {
  if (three) {
    mma_tf32(c, a_lo, b_hi);
    mma_tf32(c, a_hi, b_lo);
  }
  mma_tf32(c, a_hi, b_hi);
}

// h_matmul: the folded cotangents of a block of 8 staged samples and the
// warp's 32 entries (a lane each), h_k[e][j] = sum_c ct[k][c](j) v_c(e), as
// TF32 tensor-core contractions over the channels (depth CB <= 4 padded to
// k = 8 with zeros): entries the M side (two m16 tiles), samples the N side
// (one n8 tile), channels the K side.  ``rec`` is the warp's staged
// backward records as floats (tiled_layout.cuh: ct[k][c] of staged sample j
// is float k * CB + c of vectors 1.. of row j, vector v of row j at float4
// index v * 32 + j); va_* are the A fragments of the values, [m16 tile]
// {v_t(16 mt + g), v_t(16 mt + g + 8), 0, 0} split for the passes (zero
// from channel CB on).  Writes h_k of sample j0 + j, entry e to
// hb[(k * 8 + j) * kHStride + e].  Every lane of the warp takes part.
constexpr int kHStride = 36;   // conflict-free fragment stores

template <int K, int CB>
__device__ __forceinline__ void h_matmul_block(const float* rec, int j0,
                                               const float (&va_hi)[2][4],
                                               const float (&va_lo)[2][4],
                                               bool three, float* hb) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll 1
  for (int k = 0; k < K; ++k) {
    const int i = k * CB + t;
    const float x =
        t < CB ? rec[4 * ((1 + i / 4) * 32 + j0 + g) + i % 4] : 0.0f;
    float b_hi[2], b_lo[2];
    tf32_split_rt(x, three, b_hi[0], b_lo[0]);
    b_hi[1] = b_lo[1] = 0.0f;
    float* h = hb + k * 8 * kHStride;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      mma_passes_rt(c, va_hi[mt], va_lo[mt], b_hi, b_lo, three);
      h[2 * t * kHStride + 16 * mt + g] = c[0];
      h[(2 * t + 1) * kHStride + 16 * mt + g] = c[1];
      h[2 * t * kHStride + 16 * mt + g + 8] = c[2];
      h[(2 * t + 1) * kHStride + 16 * mt + g + 8] = c[3];
    }
  }
}

// The values' A fragments of h_matmul_block for the warp's entries
// e_base + 0..31 and the channel pass c0: v_c of the geom row vrow0 + c.
template <int CB>
__device__ __forceinline__ void h_matmul_values(const float* geom,
                                                long long Ep, long long vrow0,
                                                int C, int c0,
                                                long long e_base, bool three,
                                                float (&va_hi)[2][4],
                                                float (&va_lo)[2][4]) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float x = (r < 2 && t < CB && c0 + t < C)
                          ? geom[(vrow0 + c0 + t) * Ep + e_base + 16 * mt +
                                 g + 8 * r]
                          : 0.0f;
      tf32_split_rt(x, three, va_hi[mt][r], va_lo[mt][r]);
    }
}
#endif

}  // namespace dgs
