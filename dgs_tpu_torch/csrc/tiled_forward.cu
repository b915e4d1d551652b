// Tiled forward evaluation of a Gaussian mixture over the tile-binned
// acceleration structure, for Hopper (sm_90a).
//
// Replaces the TPU kernel dgs_tpu/kernels/tiled.py::tiled_forward
// (_wl_forward_kernel, classic branch).  Same contract: for every
// tile-sorted sample, the sum over the entries on the sample's tile of
// values * (unique component weights of each requested order), written to a
// packed (K*C, Np) fp32 array, component-major rows, in sorted-sample order.
//
// Design.  One warp owns 32 consecutive sorted samples, one per lane, with
// the lane's K*CB accumulators in registers.  Because samples and entries
// are both sorted by tile, the entries that can pair with the warp form one
// contiguous range [ent_lo, ent_lo + ent_n) (the forward geometry of
// binning/grid.py at 32 samples x one entry granularity), and where the
// warp's samples share a tile, which is the rule, that range is exactly the
// tile's entries.  The warp stages its range 32 entries at a time in its own
// slice of shared memory, each entry one record of float4 vectors (tile,
// mean', conic, CB value channels: tiled_layout.cuh), and sweeps the records
// in staged order with 16-byte broadcast loads (NV a pair instead of one
// 4-byte load per field).  A lane keeps a pair iff the entry's tile equals
// its sample's, so any range that covers the warp's tiles gives the same
// result; in a one-tile warp the test is uniform and costs one compare a
// pair.  Warps share nothing and meet at no block barrier, so a
// warp with a short range never waits for its neighbours, and the other
// resident warps cover a warp's fill.  The summation order is the entry
// order (bitwise repeatable); pad samples (tile -2.0) pair with nothing and
// write zeros.  No work list is needed, so nothing overflows.
//
// Channels.  The pass width CB is 1, 2 or 4, chosen from C by the launcher
// (C = 1 and C = 2 stage, read and accumulate no zero channels; C = 3 and
// C >= 4 run passes of 4).  D = 1 and D = 3 are built with CB = 4 only.
//
// What bounds it (measured on an H100 80GB HBM3 at 700 W with chip_smoke.py
// --tiled and throw-away variants of this source beside it, and read from
// the SASS of the headline instantiation <2, value + derivative + laplacian,
// 4, unwrapped>).  Instruction issue.  A kept pair issues 58 instructions
// and the tile compare: 2 subtractions, 4 for a = C X, 3 for the exponent, 3
// for the polynomials q_ij, 11 for the accurate expf and the power > 0
// select, 5 weights, 24 FMAs into the accumulators, 3 shared-memory loads
// and 3 for the loop; the fp32 count the bound allows is 42 (it takes expf
// as one).  At 64 registers, 32 resident warps a multiprocessor, the 198M
// same-tile pairs of the 100k x 1M headline take 0.58 ms (the bound is
// 0.25 ms).  What was measured and dropped: two or four samples a thread
// (fewer resident warps: slower by 10 to 70%), a block-wide staged range with
// per-warp sub-ranges (barriers with unequal work: 2x slower at 41 samples a
// tile), unrolling the sweep (within 3%), 2 or 8 warps a block (within 2%), a
// second sweep body without the tile compare for one-tile warps (4% faster,
// for twice the code and a range that must then be exact).
// The fill and the output write alone take 0.055 ms.  Device memory is not
// the limit: a warp reads 4 (1 + D + tri + CB) bytes per 32 pairs, mostly
// from L1/L2, and each output is written once.  No tensor cores: fp32 only.
//
// Shared memory per block: kWarps * NV * 32 * 16 bytes static, at most 8 KB
// (D = 3, CB = 4: four vectors).
//
// Build (plain C ABI, loaded with ctypes by dgs_tpu_torch/kernels/_build.py):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libdgs_kernels.so tiled_forward.cu
// Never with --use_fast_math (see pair_math.cuh).
#include <cuda_runtime.h>

#include "tiled_layout.cuh"

namespace {

constexpr int kWarps = 4;    // warps per block, each with its own range

using dgs::kWarp;
using dgs::OrderRows;

// One (entry record, sample) pair added into the sample's accumulators.
template <int D, int MASK, int CB, bool WRAP, int NV>
__device__ __forceinline__ void forward_pair(
    const float (&rec)[4 * NV], const float (&x)[D], float period,
    float inv_period, float (&acc)[dgs::total_unique(D, MASK)][CB]) {
  constexpr int TRI = dgs::tri_size(D);
  constexpr int K = dgs::total_unique(D, MASK);
  float X[D], con[TRI], a[D], q[TRI], w[K];
#pragma unroll
  for (int d = 0; d < D; ++d)
    X[d] = dgs::wrap_by<WRAP>(rec[1 + d] - x[d], period, inv_period);
#pragma unroll
  for (int t = 0; t < TRI; ++t) con[t] = rec[1 + D + t];
  const float G = dgs::pair_gauss<D>(X, con, a);
  dgs::pair_polys<D, MASK>(con, a, q);
  dgs::component_weights<D, MASK>(con, a, q, G, w);
#pragma unroll
  for (int c = 0; c < CB; ++c) {
    const float v = rec[1 + D + TRI + c];
#pragma unroll
    for (int k = 0; k < K; ++k) acc[k][c] = fmaf(w[k], v, acc[k][c]);
  }
}

template <int NV>
__device__ __forceinline__ void load_record(unsigned s_base, int j,
                                            float (&rec)[4 * NV]) {
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const float4 q = dgs::staged_vector(s_base, v, j);
    rec[4 * v] = q.x;
    rec[4 * v + 1] = q.y;
    rec[4 * v + 2] = q.z;
    rec[4 * v + 3] = q.w;
  }
}

template <int D, int MASK, int CB, bool WRAP>
__global__ void __launch_bounds__(kWarps * kWarp) tiled_forward_kernel(
    const float* __restrict__ geom,  // (1 + D + tri + C, Ep): tile, mu', conic, values
    long long Ep, int C,
    const float* __restrict__ smp,   // (D + 1, Np): coords, tile
    long long Np,
    const int* __restrict__ ent_lo,  // (Np / 32,) first entry of each warp's range
    const int* __restrict__ ent_n,   // (Np / 32,) length of the range
    float period, float inv_period, OrderRows rows,
    float* __restrict__ out) {       // (K * C, Np)
  constexpr int K = dgs::total_unique(D, MASK);
  constexpr int NV = dgs::fwd_record_vecs(D, CB);
  __shared__ float4 s_all[kWarps][NV * kWarp];
  const int lane = threadIdx.x % kWarp;
  float4* s_rec = s_all[threadIdx.x / kWarp];
  const unsigned s_base = (unsigned)__cvta_generic_to_shared(s_rec);

  // Every lane owns a real column: the launcher requires Np == 32 * the
  // number of ranges (pad samples carry tile -2.0 and never pair).
  const long long w = (long long)blockIdx.x * kWarps + threadIdx.x / kWarp;
  if (w * kWarp >= Np) return;   // whole warps only: no barrier follows
  const long long i = w * kWarp + lane;
  float x[D];
#pragma unroll
  for (int d = 0; d < D; ++d) x[d] = smp[d * Np + i];
  const float tile = smp[D * Np + i];
  const int lo = ent_lo[w];
  const int hi = lo + ent_n[w];

  for (int c0 = 0; c0 < C; c0 += CB) {
    float acc[K][CB];
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int c = 0; c < CB; ++c) acc[k][c] = 0.0f;

    for (int e0 = lo; e0 < hi; e0 += kWarp) {
      const int n = min(kWarp, hi - e0);
      __syncwarp();  // the previous records are fully consumed
      if (lane < n) {
        const long long e = (long long)e0 + lane;
        float f[4 * NV];
        dgs::stage_entry<D, CB>(geom + e, Ep, C, c0, f);
#pragma unroll
        for (int v = 0; v < NV; ++v)
          s_rec[dgs::staged_index(v, lane)] = make_float4(
              f[4 * v], f[4 * v + 1], f[4 * v + 2], f[4 * v + 3]);
      }
      __syncwarp();

      // A lane keeps the entries of its own tile (all of them where the
      // warp's samples share a tile; pad lanes match nothing).
      for (int j = 0; j < n; ++j) {
        float rec[4 * NV];
        load_record<NV>(s_base, j, rec);
        if (rec[0] == tile)
          forward_pair<D, MASK, CB, WRAP, NV>(rec, x, period, inv_period,
                                              acc);
      }
    }

#pragma unroll
    for (int k = 0; k < K; ++k) {
      const long long row =
          (long long)dgs::packed_component<D, MASK>(k, rows) * C + c0;
#pragma unroll
      for (int c = 0; c < CB; ++c)
        if (c0 + c < C) out[(row + c) * Np + i] = acc[k][c];
    }
  }
}

template <int D, int MASK, int CB>
cudaError_t launch_one(const float* geom, long long Ep, int C,
                       const float* smp, long long Np, const int* ent_lo,
                       const int* ent_n, int n_ranges, int do_wrap,
                       float period, OrderRows rows, float* out,
                       cudaStream_t stream) {
  const dim3 grid((n_ranges + kWarps - 1) / kWarps), block(kWarps * kWarp);
  const float inv = dgs::exact_inv_period(period);
  if (do_wrap)
    tiled_forward_kernel<D, MASK, CB, true><<<grid, block, 0, stream>>>(
        geom, Ep, C, smp, Np, ent_lo, ent_n, period, inv, rows, out);
  else
    tiled_forward_kernel<D, MASK, CB, false><<<grid, block, 0, stream>>>(
        geom, Ep, C, smp, Np, ent_lo, ent_n, period, inv, rows, out);
  return cudaGetLastError();
}

template <int D, int CB>
cudaError_t launch(int mask, const float* geom, long long Ep, int C,
                   const float* smp, long long Np, const int* ent_lo,
                   const int* ent_n, int n_ranges, int do_wrap, float period,
                   OrderRows rows, float* out, cudaStream_t stream) {
  switch (mask) {
#define DGS_CASE(M)                                                        \
  case M:                                                                  \
    return launch_one<D, M, CB>(geom, Ep, C, smp, Np, ent_lo, ent_n,       \
                                n_ranges, do_wrap, period, rows, out,      \
                                stream);
    DGS_CASE(1) DGS_CASE(2) DGS_CASE(3) DGS_CASE(4) DGS_CASE(5)
    DGS_CASE(6) DGS_CASE(7) DGS_CASE(8) DGS_CASE(9) DGS_CASE(10)
    DGS_CASE(11) DGS_CASE(12) DGS_CASE(13) DGS_CASE(14) DGS_CASE(15)
#undef DGS_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Samples per range (a warp's); the caller's range arrays hold one entry
// per 32 sorted samples.
int dgs_tiled_forward_block() { return kWarp; }

// The channel-pass width the launcher picks for (D, C): no zero channels
// for C = 1 and C = 2 where the narrow passes are built (D = 2).
int dgs_tiled_forward_pass(int D, int C) { return (D == 2 && C <= 2) ? C : 4; }

// 1 if the kernels wrap this period by a multiplication (exact: a power of
// two), 0 if by a division.
int dgs_tiled_wrap_scaled(float period) {
  return dgs::exact_inv_period(period) != 0.0f;
}

// Launches the kernel on `stream` and returns cudaGetLastError() after the
// launch (0 = launched).  Pointers are device pointers; `mask` is the order
// set (bits of pair_math.cuh), r_* the first output component of each order.
int dgs_tiled_forward(const void* geom, int Ep, int C, const void* smp,
                      int Np, const void* ent_lo, const void* ent_n,
                      int n_ranges, int D, int mask, int do_wrap, float period,
                      int r_value, int r_derivative, int r_laplacian,
                      int r_third, void* out, void* stream) {
  if ((long long)n_ranges * kWarp != Np || C < 1)
    return (int)cudaErrorInvalidValue;
  const OrderRows rows{r_value, r_derivative, r_laplacian, r_third};
  const auto* g = static_cast<const float*>(geom);
  const auto* s = static_cast<const float*>(smp);
  const auto* lo = static_cast<const int*>(ent_lo);
  const auto* n = static_cast<const int*>(ent_n);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const int cb = dgs_tiled_forward_pass(D, C);
#define DGS_LAUNCH(DD, CB)                                                  \
  launch<DD, CB>(mask, g, Ep, C, s, Np, lo, n, n_ranges, do_wrap, period,  \
                 rows, o, st)
  cudaError_t err = cudaErrorInvalidValue;
  if (D == 1)
    err = DGS_LAUNCH(1, 4);
  else if (D == 2)
    err = cb == 1 ? DGS_LAUNCH(2, 1) : cb == 2 ? DGS_LAUNCH(2, 2)
                                               : DGS_LAUNCH(2, 4);
  else if (D == 3)
    err = DGS_LAUNCH(3, 4);
#undef DGS_LAUNCH
  return (int)err;
}

}  // extern "C"
