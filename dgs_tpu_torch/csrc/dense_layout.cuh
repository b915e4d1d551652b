// Layout of the two all-pairs (dense) kernels' staged records
// (dense_forward.cu, dense_backward.cu): how a block stages a chunk of the
// swept side in shared memory as 16-byte records.  Everything here but the
// shared-memory load is a __host__ __device__ inline, so the CPU tests build
// it with g++ and hold it against numpy (tests/test_torch_dense_layout.py).
//
// Records.  A block stages ROWS rows of the swept side at a time (Gaussians
// in the forward, samples in the backward): thread j reads row j's fields
// from the operand arrays (consecutive threads, consecutive addresses) and
// stores them as float4 vectors, vector v of row j at index v * ROWS + j
// (whole vectors from consecutive threads: no bank conflicts).  Every thread
// of the block then sweeps the rows in the same order and reads row j's
// vectors with 16-byte broadcast loads, one shared-memory cycle a vector
// instead of one a field.
//   forward  (a Gaussian): floats [mu_0..D-1, conic_0..tri-1,
//                          value_c0..c0+CB-1], zero-padded to whole vectors;
//   backward (a sample):   vector 0 = [x_0..D-1, 0...], then the cotangents
//                          ct[k][c] of the pass's CB channels packed k-major
//                          from vector 1 on (float k * CB + c): at CB = 4
//                          vector 1 + k holds component k.
#pragma once

#include "pair_math.cuh"

namespace dgs {

// Channels per pass for (D, C): 1 and 2 where the narrow passes are built
// (D = 2: the PIGS trainer's dense path runs C = 1), else 4.
DGS_HD constexpr int dense_pass(int D, int C) {
  return (D == 2 && C <= 2) ? C : 4;
}

DGS_HD constexpr int dense_vecs(int n_floats) { return (n_floats + 3) / 4; }

// Index (in float4 units) of vector v of staged row j, ROWS rows a chunk.
template <int ROWS>
DGS_HD constexpr int dense_index(int v, int j) { return v * ROWS + j; }

#if defined(__CUDACC__)
// Vector v of staged row j, read through the block's 32-bit shared-memory
// address: one LDS.128 with an immediate offset.  Volatile and a memory
// clobber, because the same address holds another row after the next fill.
template <int ROWS>
__device__ __forceinline__ float4 dense_vector(unsigned s_base, int v,
                                               int j) {
  float4 q;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(q.x), "=f"(q.y), "=f"(q.z), "=f"(q.w)
               : "r"(s_base + 16u * dense_index<ROWS>(v, j))
               : "memory");
  return q;
}
#endif

// ---- forward: one staged Gaussian ----------------------------------------

DGS_HD constexpr int dense_fwd_vecs(int D, int CB) {
  return dense_vecs(D + tri_size(D) + CB);
}

// The record of the Gaussian whose column of the (D + tri + C, P) geom array
// starts at geom_p (row stride P), for the channel pass starting at c0:
// f = [mu, conic, value_c0..c0+CB-1 (zero from channel C on), zeros].
template <int D, int CB>
DGS_HD void stage_gaussian(const float* geom_p, long long P, int C, int c0,
                           float (&f)[4 * dense_fwd_vecs(D, CB)]) {
  constexpr int HEAD = D + tri_size(D);
#pragma unroll
  for (int i = 0; i < HEAD; ++i) f[i] = geom_p[i * P];
#pragma unroll
  for (int c = 0; c < CB; ++c)
    f[HEAD + c] = (c0 + c < C) ? geom_p[(HEAD + c0 + c) * P] : 0.0f;
#pragma unroll
  for (int i = HEAD + CB; i < 4 * dense_fwd_vecs(D, CB); ++i) f[i] = 0.0f;
}

// ---- backward: one staged sample -----------------------------------------

DGS_HD constexpr int dense_bwd_vecs(int K, int CB) {
  return 1 + dense_vecs(K * CB);
}

// The record of the sample whose columns of the (D, N) sample array and the
// (K * C, N) unique-component cotangent start at smp_s and ct_s (row stride
// N), for the channel pass starting at c0: f = [x, zeros to 4 floats], then
// g[k * CB + c] = ct[k * C + c0 + c] (zero from channel C on), then zeros.
template <int D, int K, int CB>
DGS_HD void stage_dense_sample(const float* smp_s, const float* ct_s,
                               long long N, int C, int c0,
                               float (&f)[4 * dense_bwd_vecs(K, CB)]) {
#pragma unroll
  for (int d = 0; d < 4; ++d) f[d] = d < D ? smp_s[d * N] : 0.0f;
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int c = 0; c < CB; ++c)
      f[4 + k * CB + c] =
          (c0 + c < C) ? ct_s[((long long)k * C + c0 + c) * N] : 0.0f;
#pragma unroll
  for (int i = 4 + K * CB; i < 4 * dense_bwd_vecs(K, CB); ++i) f[i] = 0.0f;
}

}  // namespace dgs
