// Tiled forward in separable mode, for Hopper (sm_90a): the pair quadratic
// form and a = C X as TF32 tensor-core contractions.
//
// Replaces the TPU kernel dgs_tpu/kernels/tiled.py::tiled_forward
// (_wl_forward_kernel, separable branch, and _separable_G_a).  Same contract
// as tiled_forward.cu: for every tile-sorted sample, the sum over the
// entries on its tile of values * (unique component weights of each
// requested order), a packed (K*C, Np) fp32 array, component-major rows.
// The operands are tile-local and wrap-free (kernels/tiled.py
// prepare_entries / prepare_samples with ``separable``): per entry
// [u, b = C mu_l, c] and the a-coefficient rows [b_d, -c_d*], per sample the
// monomials [1, x_l, -w/2 x_i x_j], so that
//   power[e, n] = sum_m [u, b, c]_e[m] mono[m, n]     (depth 1 + D + tri)
//   a_d[e, n]   = sum_m [b_d, -c_d*]_e[m] mono[m, n]  (depth 1 + D)
// are matrix products, entries the M side, monomials the K side, samples
// the N side.  The pair is kept where power <= PSD_TOL and on the same
// tile; G = exp(min(power, 0)).  The contraction cancels at entry scale
// (x^T C x reaches 10-1000 where power is ~0), so where the contracted power
// exceeds PSD_TOL it is recomputed per pair in fp32 (-1/2 X^T C X, X =
// mu_l - x_l) and the rule applied to that: a pair is never culled for the
// contraction's roundoff (dgs_tpu's fast-math mis-culled such pairs).  The
// components and the value contraction are the classic kernel's
// (pair_math.cuh).
//
// Design.  The classic kernel's layout and range sweep: one warp owns 32
// consecutive sorted samples, a lane each, with the lane's K*CB accumulators
// in registers, and sweeps its entry range 32 entries at a time.  The warp
// stages its samples' monomials once, split for the passes (the B operand,
// [monomial][sample] in shared memory), and each staged chunk's entry
// records [tile, conic, CB values, mu_l].  Per 16 entries (one m16 tile) it
// loads the A fragments of [u, b, c] and of each a-coefficient group
// straight from the geom rows, runs mma.sync m16n8k8 over the 4 n8 tiles of
// its samples (tf32_mma.cuh: 3 passes, or 1 under fast-math) and stores
// power and a_d of the 16 x 32 pair block to shared memory, each quantity
// as soon as its contraction ends; then each lane reads its sample's column
// of that block and adds the kept pairs into its accumulators in entry
// order (bitwise repeatable).  An a-coefficient group is 1 + D <= 4 deep: its A fragment holds hi in
// columns 0-3 and lo in 4-7, so that three passes take two mma.sync
// against [mono_hi; mono_hi] and [mono_lo; 0] (three before).  Warps share
// nothing and meet at no block barrier.
//
// What bounds it, as measured (chip_variants.py beside the first version's
// source on tools.bench's operands; NVIDIA H100 80GB HBM3 at 700 W;
// PERF.md): latency in the per-pair fp32 work after the contraction (the
// exp, the polynomials, the K*CB accumulator FMAs: as tiled_forward.cu
// less a = C X and the power), at 12 warps an SM (shared memory: 34.8 KB a
// 2-warp block at D = 3, C = 4; 142 registers at three orders, 3 passes;
// with a minimum of one block an SM in the launch bounds ptxas sizes the
// registers by the code).  One TF32 pass takes 7% less time than three.
// Against the first version (D = 3 chunked, three orders, 3 / 1 passes):
// 7.44-7.57 / 6.91-7.01 ms against 7.65-7.72 / 6.93-7.08; D = 2 headline
// 1.23 against 1.24: the two-mma a_d is the one change that held.
//
// Tried and dropped (D = 3 ms at 3 / 1 passes, D = 2 at 3; the first
// version 7.65-7.72 / 6.89-7.08, 1.24 in the same calls):
//   - blocks of 4 warps sharing each chunk (rows by 16-byte cp.async two
//     chunks ahead; records, the constant column and the split A fragments
//     prepared once a block; one barrier a chunk) with the round trip as
//     one 16-byte vector a pair: 8.38-8.46 / 7.49-7.70, 1.21 (128
//     registers, 200-268 bytes spilled); without spills at 12 warps 8.37;
//     the mma.sync issued pass-major over split accumulators 8.09-8.16 /
//     7.82-7.90, 1.41-1.45; without the contraction it took 5.75, without
//     the pair loop 1.91: the shared staging and the barrier cost more
//     than the per-warp staging they replace;
//   - the same blocks with this design's scalar round trip: 8.02 / 7.59,
//     1.33 (B fragments in registers, 12 warps); 10.38 / 7.67, 1.14 (in
//     shared memory, 8 warps);
//   - the pair work in the accumulators' own layout (samples the M side,
//     entries the N side, no round trip; the value contraction on the
//     tensor cores at 3 passes, the weights the A operand in place, two
//     components per mma.sync): 9.17-9.23 / 8.31-8.41, 1.32 (128
//     registers); 8.64 / 8.00 with blocks of 8 warps; 9.59 / 8.94 at 12
//     warps: splitting each weight for 3 passes costs what the round trip
//     saved;
//   - the round trip as one 16-byte vector a pair in this design: 10.49 /
//     7.62, 1.69 (174 registers: every chain's result is held until the
//     store); with pass-major issue as well 8.09 / 7.66, 1.68; at 16 warps
//     (128 registers) 132 bytes spilled, 8.17;
//   - the record's tile compared before its other vectors are read, and
//     the mean left out of the record (read from geom where a pair's
//     power is recomputed): 7.97-8.02 / 7.36-7.46, 1.36 (148 registers).
//
// Build: with the other sources into libdgs_kernels.so
// (dgs_tpu_torch/kernels/_build.py, nvcc -gencode
// arch=compute_90a,code=sm_90a -O3, plain C ABI, ctypes).  Never with
// --use_fast_math (see pair_math.cuh).
#include <cuda_runtime.h>

#include "tf32_mma.cuh"
#include "tiled_layout.cuh"

namespace {

constexpr int kWarps = 2;       // warps per block, each with its own range
constexpr int kStride = 40;     // row stride (floats) of the staged blocks
constexpr float kPsdTol = 1e-5f;   // kernels/tiled.py PSD_TOL

using dgs::kWarp;
using dgs::OrderRows;

DGS_HD constexpr int mono_rows(int D) { return 1 + D + dgs::tri_size(D); }
// The power contraction's depth padded to whole k8 steps.
DGS_HD constexpr int kdepth(int D) { return (mono_rows(D) + 7) / 8 * 8; }
// An entry's record: [tile, conic, CB values, mu_l].
DGS_HD constexpr int rec_vecs(int D, int CB) {
  return dgs::record_vecs(1 + dgs::tri_size(D) + CB + D);
}

template <int D, int CB>
struct Staged {
  float4 rec[rec_vecs(D, CB) * kWarp];   // entry records, vector-major
  float b_hi[kdepth(D)][kStride];         // the warp's monomials [m][sample]
  float b_lo[kdepth(D)][kStride];
  float pa[(1 + D) * 16][kStride];        // power, a_0.. of 16 x 32 pairs
};

// Column `col` of an entry's power row [u, b_0.., c_0..] (0 past it).
template <int D>
__device__ __forceinline__ float power_coef(const float* geom, long long Ep,
                                            long long np0, int col,
                                            long long e) {
  constexpr int MP = 1 + D;
  if (col < MP) return geom[(np0 + col) * Ep + e];
  if (col < mono_rows(D)) return geom[(1 + D + col - MP) * Ep + e];
  return 0.0f;
}

template <int D, int MASK, int CB, int PASSES>
__global__ void __launch_bounds__(kWarps * kWarp, 1) tiled_forward_sep_kernel(
    const float* __restrict__ geom,  // (1 + D + tri + C + sep_rows, Ep)
    long long Ep, int C,
    const float* __restrict__ mono,  // (mono_rows + 1, Np): monomials, tile
    long long Np,
    const int* __restrict__ ent_lo,  // (Np / 32,) first entry of each range
    const int* __restrict__ ent_n,   // (Np / 32,) length of the range
    OrderRows rows, float* __restrict__ out) {   // (K * C, Np)
  constexpr int TRI = dgs::tri_size(D);
  constexpr int K = dgs::total_unique(D, MASK);
  constexpr int MP = 1 + D, MR = mono_rows(D), KS = kdepth(D) / 8;
  constexpr int NV = rec_vecs(D, CB);
  // The warps' staged blocks, in dynamic shared memory (launch_one passes
  // kWarps of them).
  extern __shared__ float s_dt[];
  static_assert(sizeof(Staged<D, CB>) % 16 == 0, "whole 16-byte vectors a warp");
  Staged<D, CB>& sh =
      reinterpret_cast<Staged<D, CB>*>(s_dt)[threadIdx.x / kWarp];
  const int lane = threadIdx.x % kWarp, g = lane / 4, t = lane % 4;

  // Every lane owns a real column (Np == 32 * ranges; pads have tile -2.0).
  const long long w = (long long)blockIdx.x * kWarps + threadIdx.x / kWarp;
  if (w * kWarp >= Np) return;   // whole warps only
  const long long i = w * kWarp + lane;
  for (int m = 0; m < kdepth(D); ++m) {
    const float x = m < MR ? mono[m * Np + i] : 0.0f;
    const dgs::Tf32<PASSES> s = dgs::tf32_operand<PASSES>(x);
    sh.b_hi[m][lane] = s.hi;
    sh.b_lo[m][lane] = s.lo;
  }
  const float tile = mono[MR * Np + i];
  float x[D];
#pragma unroll
  for (int d = 0; d < D; ++d) x[d] = mono[(1 + d) * Np + i];
  const int lo = ent_lo[w];
  const int hi = lo + ent_n[w];
  const long long np0 = 1 + D + TRI + C;   // geom row of u

  for (int c0 = 0; c0 < C; c0 += CB) {
    float acc[K][CB];
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int c = 0; c < CB; ++c) acc[k][c] = 0.0f;

    for (int e0 = lo; e0 < hi; e0 += kWarp) {
      const int n = min(kWarp, hi - e0);
      __syncwarp();  // the previous records and monomials are consumed
      if (lane < n) {
        const long long e = (long long)e0 + lane;
        float f[4 * NV];
        f[0] = geom[e];
#pragma unroll
        for (int q = 0; q < TRI; ++q) f[1 + q] = geom[(1 + D + q) * Ep + e];
#pragma unroll
        for (int c = 0; c < CB; ++c)
          f[1 + TRI + c] =
              c0 + c < C ? geom[(1 + D + TRI + c0 + c) * Ep + e] : 0.0f;
#pragma unroll
        for (int d = 0; d < D; ++d)
          f[1 + TRI + CB + d] = geom[(1 + d) * Ep + e];
#pragma unroll
        for (int q = 1 + TRI + CB + D; q < 4 * NV; ++q) f[q] = 0.0f;
#pragma unroll
        for (int v = 0; v < NV; ++v)
          sh.rec[v * kWarp + lane] = make_float4(f[4 * v], f[4 * v + 1],
                                                 f[4 * v + 2], f[4 * v + 3]);
      }
      __syncwarp();

      for (int mt = 0; 16 * mt < n; ++mt) {
        // A fragments of entries e0 + 16 mt + {g, g + 8}: the power rows
        // (KS k-steps) and each a-coefficient group (one k-step, columns
        // past 1 + D zero).
        // The constant column (u, b_d: the largest terms) is not rounded
        // to TF32: it starts the accumulators instead (init_p, init_a).
        float ap_hi[KS][4], ap_lo[KS][4], aq[D][4];
        float init_p[2], init_a[D][2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const long long e = (long long)e0 + 16 * mt + g + 8 * r;
          const bool ok = e < hi;
          init_p[r] = ok ? geom[np0 * Ep + e] : 0.0f;
#pragma unroll
          for (int d = 0; d < D; ++d)
            init_a[d][r] = ok ? geom[(np0 + 1 + d) * Ep + e] : 0.0f;
#pragma unroll
          for (int ks = 0; ks < KS; ++ks)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int col = 8 * ks + t + 4 * h;
              const float x =
                  ok && col > 0 ? power_coef<D>(geom, Ep, np0, col, e)
                                : 0.0f;
              const dgs::Tf32<PASSES> s = dgs::tf32_operand<PASSES>(x);
              ap_hi[ks][r + 2 * h] = s.hi;
              ap_lo[ks][r + 2 * h] = s.lo;
            }
#pragma unroll
          for (int d = 0; d < D; ++d) {
            const float x = ok && t > 0 && t < MP
                                ? geom[(np0 + MP * (1 + d) + t) * Ep + e]
                                : 0.0f;
            const dgs::Tf32<PASSES> s = dgs::tf32_operand<PASSES>(x);
            aq[d][r] = s.hi;
            aq[d][r + 2] = s.lo;
          }
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          float b_hi[KS][2], b_lo[KS][2];
#pragma unroll
          for (int ks = 0; ks < KS; ++ks)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              b_hi[ks][h] = sh.b_hi[8 * ks + t + 4 * h][8 * nt + g];
              b_lo[ks][h] = sh.b_lo[8 * ks + t + 4 * h][8 * nt + g];
            }
#pragma unroll
          for (int q = 0; q <= D; ++q) {
            const float (&init)[2] = q == 0 ? init_p : init_a[q - 1];
            float c[4] = {init[0], init[0], init[1], init[1]};
            if (q == 0) {
#pragma unroll
              for (int ks = 0; ks < KS; ++ks)
                dgs::mma_passes<PASSES>(c, ap_hi[ks], ap_lo[ks], b_hi[ks],
                                        b_lo[ks]);
            } else {
              // [hi | lo] against [mono_hi; mono_hi], then [mono_lo; 0]
              const float b1[2] = {b_hi[0][0],
                                   PASSES == 3 ? b_hi[0][0] : 0.0f};
              const float b2[2] = {b_lo[0][0], 0.0f};
              dgs::mma_tf32(c, aq[q - 1], b1);
              if (PASSES == 3) dgs::mma_tf32(c, aq[q - 1], b2);
            }
            float* row = sh.pa[16 * q + g];
            row[8 * nt + 2 * t] = c[0];
            row[8 * nt + 2 * t + 1] = c[1];
            row[8 * kStride + 8 * nt + 2 * t] = c[2];
            row[8 * kStride + 8 * nt + 2 * t + 1] = c[3];
          }
        }
        __syncwarp();

        // A lane keeps the block's entries of its own tile.
        const int jn = min(16, n - 16 * mt);
        for (int j = 0; j < jn; ++j) {
          float f[4 * NV];
#pragma unroll
          for (int v = 0; v < NV; ++v) {
            const float4 r = sh.rec[v * kWarp + 16 * mt + j];
            f[4 * v] = r.x;
            f[4 * v + 1] = r.y;
            f[4 * v + 2] = r.z;
            f[4 * v + 3] = r.w;
          }
          if (f[0] != tile) continue;
          float power = sh.pa[j][lane];
          float a[D], con[TRI], q[TRI], wk[K];
#pragma unroll
          for (int d = 0; d < D; ++d) a[d] = sh.pa[16 * (1 + d) + j][lane];
#pragma unroll
          for (int u = 0; u < TRI; ++u) con[u] = f[1 + u];
          if (power > kPsdTol) {
            // For a PSD conic the power is <= 0, and above PSD_TOL only by
            // the contraction's roundoff (3 passes: ~1e-7 of the terms, which
            // reach 1e2-1e3 at coarse tiles; 1 pass: ~5e-4 of them): decide
            // the mask on the per-pair power, as the backward does.
            float X[D], a_pair[D];
#pragma unroll
            for (int d = 0; d < D; ++d) X[d] = f[1 + TRI + CB + d] - x[d];
            power = dgs::pair_form<D>(X, con, a_pair);
          }
          const float G = power > kPsdTol ? 0.0f : expf(fminf(power, 0.0f));
          dgs::pair_polys<D, MASK>(con, a, q);
          dgs::component_weights<D, MASK>(con, a, q, G, wk);
#pragma unroll
          for (int c = 0; c < CB; ++c) {
            const float v = f[1 + TRI + c];
#pragma unroll
            for (int k = 0; k < K; ++k) acc[k][c] = fmaf(wk[k], v, acc[k][c]);
          }
        }
        __syncwarp();  // the block is consumed before the next one
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
                       const float* mono, long long Np, const int* ent_lo,
                       const int* ent_n, int n_ranges, int passes,
                       OrderRows rows, float* out, cudaStream_t stream) {
  const dim3 grid((n_ranges + kWarps - 1) / kWarps), block(kWarps * kWarp);
  constexpr size_t bytes = sizeof(Staged<D, CB>) * kWarps;
  static_assert(bytes <= 48 * 1024, "above the default shared-memory limit");
  if (passes == 3)
    tiled_forward_sep_kernel<D, MASK, CB, 3><<<grid, block, bytes, stream>>>(
        geom, Ep, C, mono, Np, ent_lo, ent_n, rows, out);
  else if (passes == 1)
    tiled_forward_sep_kernel<D, MASK, CB, 1><<<grid, block, bytes, stream>>>(
        geom, Ep, C, mono, Np, ent_lo, ent_n, rows, out);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

template <int D, int CB>
cudaError_t launch(int mask, const float* geom, long long Ep, int C,
                   const float* mono, long long Np, const int* ent_lo,
                   const int* ent_n, int n_ranges, int passes,
                   OrderRows rows, float* out, cudaStream_t stream) {
  switch (mask) {
#define DGS_CASE(M)                                                        \
  case M:                                                                  \
    return launch_one<D, M, CB>(geom, Ep, C, mono, Np, ent_lo, ent_n,      \
                                n_ranges, passes, rows, out, stream);
    DGS_CASE(1) DGS_CASE(2) DGS_CASE(3) DGS_CASE(4) DGS_CASE(5)
    DGS_CASE(6) DGS_CASE(7) DGS_CASE(8) DGS_CASE(9) DGS_CASE(10)
    DGS_CASE(11) DGS_CASE(12) DGS_CASE(13) DGS_CASE(14) DGS_CASE(15)
#undef DGS_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

// The channel-pass width for (D, C).
DGS_HD constexpr int sep_pass(int D, int C) {
  return (D == 2 && C <= 2) ? C : 4;
}

template <int D, int CB>
int shared_bytes() {
  return (int)(sizeof(Staged<D, CB>) * kWarps);
}

}  // namespace

extern "C" {

// Threads a block (a lane a sample), and the dynamic shared bytes of a
// launch at (D, C), for the smoke test's facts.
int dgs_tiled_forward_sep_block() { return kWarps * kWarp; }

int dgs_tiled_forward_sep_smem(int D, int C) {
  const int cb = sep_pass(D, C);
  if (D == 1) return shared_bytes<1, 4>();
  if (D == 3) return shared_bytes<3, 4>();
  if (D != 2) return 0;
  return cb == 1 ? shared_bytes<2, 1>()
         : cb == 2 ? shared_bytes<2, 2>()
                   : shared_bytes<2, 4>();
}

// Launches the kernel on `stream` and returns cudaGetLastError() after the
// launch (0 = launched).  Pointers are device pointers; `mask` is the order
// set (bits of pair_math.cuh), `passes` 3 or 1, r_* the first output
// component of each order.  Ranges are the classic forward's (32 samples).
int dgs_tiled_forward_sep(const void* geom, int Ep, int C, const void* mono,
                          int Np, const void* ent_lo, const void* ent_n,
                          int n_ranges, int D, int mask, int passes,
                          int r_value, int r_derivative, int r_laplacian,
                          int r_third, void* out, void* stream) {
  if ((long long)n_ranges * kWarp != Np || C < 1)
    return (int)cudaErrorInvalidValue;
  const OrderRows rows{r_value, r_derivative, r_laplacian, r_third};
  const auto* g = static_cast<const float*>(geom);
  const auto* m = static_cast<const float*>(mono);
  const auto* lo = static_cast<const int*>(ent_lo);
  const auto* n = static_cast<const int*>(ent_n);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const int cb = sep_pass(D, C);
#define DGS_LAUNCH(DD, CB) \
  launch<DD, CB>(mask, g, Ep, C, m, Np, lo, n, n_ranges, passes, rows, o, st)
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
