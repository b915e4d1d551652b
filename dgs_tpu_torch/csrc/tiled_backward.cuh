// Tiled backward of the Gaussian-mixture evaluation over the tile-binned
// acceleration structure, for Hopper (sm_90a): the kernel template.
//
// Replaces the TPU kernel dgs_tpu/kernels/tiled.py::tiled_backward
// (_wl_backward_kernel, classic _compute_one branch).  Same contract: for
// every tile-sorted entry, the gradient of the loss w.r.t. the entry's
// period-shifted mean (D rows), packed conic (tri rows) and values (C rows),
// summed over the sorted samples on the entry's tile, written entry-major:
// a packed (Ep, D + tri + C) fp32 array in entry order, one record of
// D + tri + C values an entry (the wrapper hands it on as its
// (D + tri + C, Ep) transpose).  The caller segment-sums the records by
// Gaussian id (ops/sampling.py, csrc/segment_sum.cu), so no atomics are
// needed here; a record is the segment-sum's contiguous read.
//
// Design.  The mirror of tiled_forward.cu.  One warp owns 32 consecutive
// tile-sorted entries, one per lane, with the entry's parameters and its
// D + tri + CB gradient accumulators in registers.  The samples that can
// pair with the warp form one contiguous range [s_lo, s_lo + s_n) (the
// backward geometry of binning/grid.py at 32 entries x one sample
// granularity); where the warp's entries share a tile the range is exactly
// the tile's samples.  The warp stages its range 32 samples at a time in its
// own slice of shared memory, each sample one record of float4 vectors:
// {tile, x}, then the K x CB cotangent values packed k-major (read coalesced
// from the lane-major (K*C, Np) cotangent and transposed by the fill, which
// stores whole vectors from consecutive lanes: tiled_layout.cuh).  The sweep
// reads the records in staged order with 16-byte broadcast loads
// (1 + K*CB/4 a pair instead of 1 + D + K*CB four-byte loads).  A lane keeps
// a pair iff the sample's tile equals its entry's, so any range that covers
// the warp's tiles gives the same result; in a one-tile warp the test is
// uniform and costs one compare a pair.  Warps share nothing and meet at no
// block barrier.  Per kept pair: X = mu' - x (wrapped when the op passes a
// period), a = C X, G, the polynomials q_ij and the weights w_k once, the
// folded cotangents h_k = sum_c ct[k, c] v_c, dvalues_c += sum_k ct[k, c]
// w_k, and the closed-form VJP from (a, q, G, w) with nothing recomputed
// (pair_vjp).  Each lane writes its entry's rows once, in a fixed summation
// order, so the result is bitwise repeatable.  Sentinel entries (tile -1.0
// or the culled tile T) pair with nothing and write zeros; pad samples lie
// outside every range.
//
// Channels.  h needs every channel of a pair, but the dmu / dconic rows are
// linear in h, so the kernel runs over the channels in passes of CB: each
// pass stages the cotangent rows of its channels, accumulates that pass's
// dvalues, and adds the VJP of its partial h into the same mean and conic
// registers.  CB is 1, 2 or 4, chosen from C by the launcher (C = 1 and
// C = 2 stage and fold no zero channels); D = 1 and D = 3 are built with CB = 4 only.
//
// What bounds it (measured on an H100 80GB HBM3 at 700 W with chip_smoke.py
// --tiled and throw-away variants of this source beside it, and read from
// the SASS of the headline instantiation <2, value + derivative + laplacian,
// 4, unwrapped>).  Instruction issue.  A kept pair issues about 125
// instructions: the forward's 28 up to the weights, 48 FMAs for h and
// dvalues, about 40 for the VJP and the rows, 7 shared-memory loads, the
// tile compare and 3 for the loop, against the 110 fp32 instructions the
// bound allows; the fill adds 160 per 32 pairs.  A warp that straddles two
// tiles (one in six at the headline, 198 entries a tile) sweeps both tiles'
// samples with part of its lanes idle: 229M swept lane slots for 198M kept
// pairs.  At 72 registers the headline takes 1.43 ms (the bound is 0.65 ms).
// What was measured and dropped: two entries a thread (140 registers: no
// faster), a block-wide staged range (no faster, and barriers with unequal
// work), asking ptxas for 7 or 8 blocks a multiprocessor (within 2%), a
// second sweep body without the tile compare for one-tile warps (no faster,
// and a longer build).  Device memory is not the limit.  No tensor cores.
//
// Shared memory per block: warps * (1 + ceil(K CB / 4)) * 32 * 16 bytes
// static; the widest case, D = 3 with all four orders (K = 20, CB = 4),
// takes 4 * 21 * 512 = 43,008 bytes, under the 48 KB static limit.
//
// The kernel lives in this header so that tiled_backward.cu instantiates it
// in its own translation unit (tiled_backward_folded.cu and
// tiled_backward_fvjp.cu include it for the headers it includes).  Never built with --use_fast_math (see pair_math.cuh).
#pragma once

#include <cuda_runtime.h>

#include "tf32_mma.cuh"
#include "tiled_layout.cuh"

namespace dgs {

constexpr int kBwdWarps = 4;   // warps per block, each with its own range

// One tile-sorted entry's parameters and gradient accumulators.
template <int D, int CB>
struct Entry {
  float mu[D], con[tri_size(D)], v[CB];
  float dmu[D], dcon[tri_size(D)], dv[CB];
};

// One (sample record, entry) pair added into the entry's accumulators.
template <int D, int MASK, int CB, bool WRAP>
__device__ __forceinline__ void backward_pair(StagedBase s_base, int j,
                                              const float4& head,
                                              float period, float inv_period,
                                              Entry<D, CB>& e) {
  constexpr int TRI = tri_size(D);
  constexpr int K = total_unique(D, MASK);
  const float xs[3] = {head.y, head.z, head.w};
  float X[D], a[D], q[TRI], w[K], h[K];
#pragma unroll
  for (int d = 0; d < D; ++d)
    X[d] = wrap_by<WRAP>(e.mu[d] - xs[d], period, inv_period);
  const float G = pair_gauss<D>(X, e.con, a);
  pair_polys<D, MASK>(e.con, a, q);
  component_weights<D, MASK>(e.con, a, q, G, w);
#pragma unroll
  for (int k = 0; k < K; ++k) h[k] = 0.0f;
#pragma unroll
  for (int g = 0; g < record_vecs(K * CB); ++g) {
    const float4 c4 = staged_vector(s_base, 1 + g, j);
    const float ct[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = 4 * g + u;
      if (i < K * CB) {
        h[i / CB] = fmaf(ct[u], e.v[i % CB], h[i / CB]);
        e.dv[i % CB] = fmaf(ct[u], w[i / CB], e.dv[i % CB]);
      }
    }
  }
  pair_vjp<D, MASK>(X, e.con, a, q, G, w, h, e.dmu, e.dcon);
}

// The warp's sweep of its sample range [lo, hi) for its 32 entries (a lane
// each, entry column ``col`` of the (1 + D + tri + C, Ep) geom): channel
// passes of CB, each staging the range 32 samples at a time into the warp's
// records ``s_rec`` and adding every kept pair into ``ent``; each pass's
// value gradients are written to ``out_rec`` (the entry's record, from
// column D + tri on); the caller writes the mean and conic rows.
template <int D, int MASK, int CB, bool WRAP>
__device__ __forceinline__ void entry_sweep(
    const float* __restrict__ geom, long long Ep, int C,
    const float* __restrict__ smp, long long Np,
    const float* __restrict__ ct, int lo, int hi, float period,
    float inv_period, const OrderRows& rows, long long col, float4* s_rec,
    Entry<D, CB>& ent, float* out_rec) {
  constexpr int TRI = tri_size(D);
  constexpr int K = total_unique(D, MASK);
  constexpr int NV = bwd_record_vecs(K, CB);
  const int lane = threadIdx.x % kWarp;
  const StagedBase s_base = staged_base(s_rec);
  const float tile = geom[col];

  for (int c0 = 0; c0 < C; c0 += CB) {
#pragma unroll
    for (int c = 0; c < CB; ++c) {
      ent.v[c] = (c0 + c < C) ? geom[(1 + D + TRI + c0 + c) * Ep + col]
                              : 0.0f;
      ent.dv[c] = 0.0f;
    }

    for (int s0 = lo; s0 < hi; s0 += kWarp) {
      const int n = min(kWarp, hi - s0);
      __syncwarp();  // the previous records are fully consumed
      if (lane < n) {
        const long long s = (long long)s0 + lane;
        float f[4], g[4 * (NV - 1)];
        stage_sample<D, MASK, CB>(smp + s, ct + s, Np, C, c0, rows, f, g);
        s_rec[staged_index(0, lane)] = make_float4(f[0], f[1], f[2], f[3]);
#pragma unroll
        for (int v = 1; v < NV; ++v)
          s_rec[staged_index(v, lane)] = make_float4(
              g[4 * v - 4], g[4 * v - 3], g[4 * v - 2], g[4 * v - 1]);
      }
      __syncwarp();

      // A lane keeps the samples of its own tile (all of them where the
      // warp's entries share a tile; sentinel lanes match nothing).
      for (int j = 0; j < n; ++j) {
        const float4 head = staged_vector(s_base, 0, j);
        if (head.x == tile)
          backward_pair<D, MASK, CB, WRAP>(s_base, j, head, period,
                                           inv_period, ent);
      }
    }

#pragma unroll
    for (int c = 0; c < CB; ++c)
      if (c0 + c < C) out_rec[D + TRI + c0 + c] = ent.dv[c];
  }
}

template <int D, int MASK, int CB, bool WRAP>
__global__ void __launch_bounds__(kBwdWarps * kWarp) tiled_backward_kernel(
    const float* __restrict__ geom,  // (1 + D + tri + C, Ep): tile, mu', conic, values
    long long Ep, int C,
    const float* __restrict__ smp,   // (D + 1, Np): coords, tile
    long long Np,
    const float* __restrict__ ct,    // (K * C, Np) cotangent, sorted-sample order
    const int* __restrict__ s_lo,    // (Ep / 32,) first sample of each warp's range
    const int* __restrict__ s_n,     // (Ep / 32,) length of the range
    float period, float inv_period, OrderRows rows,
    float* __restrict__ out) {       // (Ep, D + tri + C), entry-major
  constexpr int TRI = tri_size(D);
  constexpr int K = total_unique(D, MASK);
  constexpr int NV = bwd_record_vecs(K, CB);
  __shared__ float4 s_all[kBwdWarps][NV * kWarp];
  static_assert(sizeof(s_all) <= 48 * 1024,
                "the staged records must fit the static shared-memory limit");
  const int lane = threadIdx.x % kWarp;

  // Every lane owns a real column, since the launcher requires Ep == 32 *
  // the number of ranges (pad entries carry tile -1.0 and never pair).
  const long long w = (long long)blockIdx.x * kBwdWarps + threadIdx.x / kWarp;
  if (w * kWarp >= Ep) return;   // whole warps only: no barrier follows
  const long long col = w * kWarp + lane;
  float* rec = out + col * (D + TRI + C);   // the entry's output record
  Entry<D, CB> ent;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    ent.mu[d] = geom[(1 + d) * Ep + col];
    ent.dmu[d] = 0.0f;
  }
#pragma unroll
  for (int t = 0; t < TRI; ++t) {
    ent.con[t] = geom[(1 + D + t) * Ep + col];
    ent.dcon[t] = 0.0f;
  }
  entry_sweep<D, MASK, CB, WRAP>(geom, Ep, C, smp, Np, ct, s_lo[w],
                                 s_lo[w] + s_n[w], period, inv_period, rows,
                                 col, s_all[threadIdx.x / kWarp], ent, rec);
#pragma unroll
  for (int d = 0; d < D; ++d) rec[d] = ent.dmu[d];
#pragma unroll
  for (int t = 0; t < TRI; ++t) rec[D + t] = ent.dcon[t];
}

template <int D, int MASK, int CB>
cudaError_t launch_backward_one(const float* geom, long long Ep, int C,
                                const float* smp, long long Np,
                                const float* ct, const int* s_lo,
                                const int* s_n, int n_ranges, int do_wrap,
                                float period, OrderRows rows, float* out,
                                cudaStream_t stream) {
  const dim3 grid((n_ranges + kBwdWarps - 1) / kBwdWarps),
      block(kBwdWarps * kWarp);
  const float inv = exact_inv_period(period);
  if (do_wrap)
    tiled_backward_kernel<D, MASK, CB, true><<<grid, block, 0, stream>>>(
        geom, Ep, C, smp, Np, ct, s_lo, s_n, period, inv, rows, out);
  else
    tiled_backward_kernel<D, MASK, CB, false><<<grid, block, 0, stream>>>(
        geom, Ep, C, smp, Np, ct, s_lo, s_n, period, inv, rows, out);
  return cudaGetLastError();
}

template <int D, int CB>
cudaError_t launch_backward_mask(int mask, const float* geom, long long Ep,
                                 int C, const float* smp, long long Np,
                                 const float* ct, const int* s_lo,
                                 const int* s_n, int n_ranges, int do_wrap,
                                 float period, OrderRows rows, float* out,
                                 cudaStream_t stream) {
  switch (mask) {
#define DGS_CASE(M)                                                          \
  case M:                                                                    \
    return launch_backward_one<D, M, CB>(geom, Ep, C, smp, Np, ct, s_lo,     \
                                         s_n, n_ranges, do_wrap, period,     \
                                         rows, out, stream);
    DGS_CASE(1) DGS_CASE(2) DGS_CASE(3) DGS_CASE(4) DGS_CASE(5)
    DGS_CASE(6) DGS_CASE(7) DGS_CASE(8) DGS_CASE(9) DGS_CASE(10)
    DGS_CASE(11) DGS_CASE(12) DGS_CASE(13) DGS_CASE(14) DGS_CASE(15)
#undef DGS_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

// The channel-pass width the launcher picks for (D, C): no zero channels
// for C = 1 and C = 2 where the narrow passes are built (D = 2).
DGS_HD constexpr int backward_pass(int D, int C) {
  return (D == 2 && C <= 2) ? C : 4;
}

}  // namespace dgs
