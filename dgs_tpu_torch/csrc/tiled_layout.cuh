// Layout shared by the tiled kernels (tiled_forward.cu, tiled_backward.cuh
// and the kernel modes): how a warp stages the other side's rows in shared
// memory as 16-byte records.  Everything here is a __host__ __device__
// inline, so the CPU tests build it with g++ and hold it against numpy
// (tests/test_torch_tiled_layout.py).
//
// Rows.  A warp owns kWarp consecutive tile-sorted rows (samples in the
// forward, entries in the backward), one per lane, and is handed the
// contiguous range of the other side that its rows' tiles cover.  Warps
// share nothing, so a block never waits at a barrier for its slowest warp.
//
// Records.  The warp stages its range kWarp rows at a time: lane l reads
// staged row l's fields from the operand arrays (consecutive lanes,
// consecutive addresses) and stores them as float4 vectors, vector v of
// staged row j at index v * kWarp + j (whole vectors from consecutive lanes:
// no bank conflicts).  The sweep then reads row j's vectors with 16-byte
// broadcast loads, every lane the same address: one shared-memory cycle a
// vector instead of one a field.
//   forward  (an entry):  floats [tile, mu'_0..D-1, conic_0..tri-1,
//                         value_c0..c0+CB-1], zero-padded to whole vectors;
//   backward (a sample):  vector 0 = [tile, x_0..D-1, 0...], then the
//                         cotangents ct[k][c] of the pass's CB channels
//                         packed k-major from vector 1 on (float k * CB + c).
#pragma once

#include "pair_math.cuh"

namespace dgs {

constexpr int kWarp = 32;

DGS_HD constexpr int record_vecs(int n_floats) { return (n_floats + 3) / 4; }

// Index (in float4 units) of vector v of staged row j.
DGS_HD constexpr int staged_index(int v, int j) { return v * kWarp + j; }

#if defined(__CUDA_ARCH__) || defined(__NVCC__)
// The warp's staged records as the sweep addresses them: their 32-bit
// shared-memory address.
using StagedBase = unsigned;

__device__ __forceinline__ StagedBase staged_base(const float4* s_rec) {
  return (unsigned)__cvta_generic_to_shared(s_rec);
}

// Vector v of staged row j, read through the warp's 32-bit shared-memory
// address: one LDS.128 with an immediate offset, so the sweep keeps no
// generic pointer alive and recomputes no address.  Volatile and a memory
// clobber, because the same address holds another row after the next fill.
__device__ __forceinline__ float4 staged_vector(StagedBase s_base, int v,
                                                int j) {
  float4 q;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(q.x), "=f"(q.y), "=f"(q.z), "=f"(q.w)
               : "r"(s_base + 16u * staged_index(v, j))
               : "memory");
  return q;
}
#elif defined(__CUDACC__)
// Built for the host against an emulated runtime (the CPU tests): a plain
// pointer and a plain load.
using StagedBase = const float4*;

inline StagedBase staged_base(const float4* s_rec) { return s_rec; }

inline float4 staged_vector(StagedBase s_base, int v, int j) {
  return s_base[staged_index(v, j)];
}
#endif

// Hides from the compiler that a 64-bit value is unchanged.  The fills
// advance their addresses by whole rows, one addition a field; without this
// the compiler folds them back into one 64-bit product per field (14
// instructions each) and hoists the row strides out of the sweep, where they
// hold two registers a row for the kernel's whole life.
#if defined(__CUDA_ARCH__)
#define DGS_OPAQUE(x) asm volatile("" : "+l"(x))
#else
#define DGS_OPAQUE(x) ((void)0)
#endif

struct OrderRows {
  // First unique-component index of each order in the packed output or
  // cotangent (component k owns rows [k*C, (k+1)*C)); unused orders are
  // ignored.
  int value, derivative, laplacian, third;
};

// The packed component of unique component k in the canonical order of
// MASK.  With k a constant of an unrolled loop this folds to one field of
// `rows` plus a constant.
template <int D, int MASK>
DGS_HD int packed_component(int k, const OrderRows& rows) {
  if (MASK & kValue) {
    if (k == 0) return rows.value;
    k -= 1;
  }
  if (MASK & kDerivative) {
    if (k < D) return rows.derivative + k;
    k -= D;
  }
  if (MASK & kLaplacian) {
    if (k < tri_size(D)) return rows.laplacian + k;
    k -= tri_size(D);
  }
  return rows.third + k;
}

// ---- forward: one staged entry -------------------------------------------

DGS_HD constexpr int fwd_record_vecs(int D, int CB) {
  return record_vecs(1 + D + tri_size(D) + CB);
}

// The record of the entry whose column of the (1 + D + tri + C, Ep) geom
// array starts at geom_e (row stride ep), for the channel pass starting at
// c0: f = [tile, mu', conic, value_c0..c0+CB-1 (zero from channel C on),
// zeros].
template <int D, int CB>
DGS_HD void stage_entry(const float* geom_e, long long ep, int C, int c0,
                        float (&f)[4 * fwd_record_vecs(D, CB)]) {
  constexpr int HEAD = 1 + D + tri_size(D);
  DGS_OPAQUE(ep);
#pragma unroll
  for (int i = 0; i < HEAD; ++i) {
    f[i] = *geom_e;
    geom_e += ep;
    DGS_OPAQUE(geom_e);
  }
  geom_e += c0 * ep;
#pragma unroll
  for (int c = 0; c < CB; ++c) {
    DGS_OPAQUE(geom_e);
    f[HEAD + c] = (c0 + c < C) ? *geom_e : 0.0f;
    geom_e += ep;
  }
#pragma unroll
  for (int i = HEAD + CB; i < 4 * fwd_record_vecs(D, CB); ++i) f[i] = 0.0f;
}

// ---- backward: one staged sample -----------------------------------------

DGS_HD constexpr int bwd_record_vecs(int K, int CB) {
  return 1 + record_vecs(K * CB);
}

// The record of the sample whose columns of the (D + 1, Np) sample array
// and the (K * C, Np) cotangent start at smp_s and ct_s (row stride np), for
// the channel pass starting at c0: head = [tile, x, zeros], g[k * CB + c] =
// ct[component k, channel c0 + c] (zero from channel C on), then zeros.
template <int D, int MASK, int CB>
DGS_HD void stage_sample(
    const float* smp_s, const float* ct_s, long long np, int C, int c0,
    const OrderRows& rows, float (&head)[4],
    float (&g)[4 * (bwd_record_vecs(total_unique(D, MASK), CB) - 1)]) {
  constexpr int K = total_unique(D, MASK);
  DGS_OPAQUE(np);
  head[0] = smp_s[D * np];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    head[1 + d] = d < D ? *smp_s : 0.0f;
    smp_s += np;
    DGS_OPAQUE(smp_s);
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    // one 64-bit product a component, one addition a channel
    const float* ct_k =
        ct_s + (packed_component<D, MASK>(k, rows) * C + c0) * np;
#pragma unroll
    for (int c = 0; c < CB; ++c) {
      DGS_OPAQUE(ct_k);
      g[k * CB + c] = (c0 + c < C) ? *ct_k : 0.0f;
      ct_k += np;
    }
  }
#pragma unroll
  for (int i = K * CB; i < 4 * (bwd_record_vecs(K, CB) - 1); ++i) g[i] = 0.0f;
}

}  // namespace dgs
