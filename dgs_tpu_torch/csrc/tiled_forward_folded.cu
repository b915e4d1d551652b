// Tiled forward in folded mode, for Hopper (sm_90a): the K value
// contractions of a pair block as one TF32 tensor-core contraction.
//
// Replaces the TPU kernel dgs_tpu/kernels/tiled.py::tiled_forward
// (_wl_forward_kernel, folded branch _compute_folded).  Same contract as
// tiled_forward.cu: for every tile-sorted sample the sum over the entries on
// its tile of values * (unique component weights of each requested order),
// a packed (K*C, Np) fp32 array.  The operands are tile-local and wrap-free
// (kernels/tiled.py prepare_entries / prepare_samples with ``folded``): per
// entry the rows [tile, mu_l, conic] of geom and the R folded rows of
// ``fold`` (fold[(k, m, c), e] = values_c * the coefficient of raw monomial
// m in component k's polynomial, formulas.component_coeff_polys); per sample
// the raw monomials (x_l at rows 1..D) and the tile row.  Then
//   Z[r, n]        = sum_e fold[r, e] G[e, n]          (the tensor cores)
//   out[(k, c), n] = sum_(m in meta_k) Z[(k, m, c), n] mono[m, n],
// with G = exp(-1/2 X^T C X) on the same tile, X = mu_l - x_l.
//
// Design.  One warp owns 32 consecutive sorted samples (a lane each, the
// N side of the contraction: four n8 tiles) and sweeps its entry range (the
// K side) 32 entries at a time.  Z has R rows (24 to 1,092 at C = 4), too
// many to hold as fragments, so the warp takes R in slices of 64 rows (four
// m16 tiles, 64 accumulator registers a lane) and sweeps its range once a
// slice.  Per chunk of 32 entries the warp stages the entries' [tile, mu_l,
// conic] records, each lane computes G of its sample with the 32 entries
// (the classic per-pair fp32 math, pair_math.cuh) into a 32 x 32 block in
// shared memory ([entry][sample], the B operand), and mma.sync m16n8k8 adds
// fold (the A operand, read from the fold rows in global memory) times that
// block into the slice's fragments: 3 TF32 passes, or 1 under fast-math
// (tf32_mma.cuh).  After a slice the fragments go through shared memory
// once, 16 rows at a time, and each lane adds its sample's column, times
// the row's monomial, into its output rows (a (K*C) x 32 block in shared
// memory, a column a lane, rows taken in order: bitwise repeatable).  The
// row of Z -> (output row, monomial) map is a table (``rowmap``, from the
// wrapper), so one instantiation a D serves every order set and C.
//
// Cost.  G is computed once a slice: 1, 2, 5 or 18 times at D = 3 with
// R = 24 ... 1,092; the contraction is R multiply-adds a pair a pass.  The
// fold rows are read once a range of 32 samples: an entry's column is R
// floats (1,168 B at D = 3, three orders, C = 4), read again by each range
// of its tile (about 31 times at 1,000 samples a tile), from L2 where the
// ranges of a tile run together.  A simple first version: no cp.async, no
// staged fold chunks shared by the warps of a block.
//
// Build: with the other sources into libdgs_kernels.so
// (dgs_tpu_torch/kernels/_build.py).  Never with --use_fast_math.
#include <cuda_runtime.h>

#include "tf32_mma.cuh"
#include "tiled_layout.cuh"

namespace {

constexpr int kWarps = 2;      // warps per block, each with its own range
constexpr int kTiles = 4;      // m16 tiles of Z a slice (64 rows)
constexpr int kStride = 40;    // row stride (floats) of the G and Z blocks
constexpr int kMaxMono = 20;   // raw monomials up to degree 3 at D = 3

using dgs::kWarp;

// An entry's record: [tile, mu_l, conic].
DGS_HD constexpr int rec_vecs(int D) {
  return dgs::record_vecs(1 + D + dgs::tri_size(D));
}

// A warp's slice of the dynamic shared memory: the staged entry records,
// the G block (also the Z rows of the epilogue), the sample's monomials and
// the output rows, [row][lane].
template <int D>
DGS_HD constexpr int warp_floats(int KC) {
  return 4 * rec_vecs(D) * kWarp + kWarp * kStride + kMaxMono * kWarp +
         KC * kWarp;
}

template <int D>
__global__ void __launch_bounds__(kWarps * kWarp, 1) tiled_forward_folded_kernel(
    const float* __restrict__ geom,  // (>= 1 + D + tri, Ep): tile, mu_l, conic
    long long Ep,
    const float* __restrict__ fold,  // (Rp, Ep) folded rows
    int Rp, int R,
    const float* __restrict__ mono,  // (n_mono + 1, Np): monomials, tile
    long long Np, int n_mono,
    const int* __restrict__ ent_lo,  // (Np / 32,) first entry of each range
    const int* __restrict__ ent_n,   // (Np / 32,) length of the range
    int KC, const int* __restrict__ rowmap,   // (R,) (k C + c) * 32 + m
    bool three, float* __restrict__ out) {    // (K * C, Np)
  constexpr int TRI = dgs::tri_size(D);
  constexpr int NV = rec_vecs(D);
  extern __shared__ float s_dt[];
  float* base = s_dt + (threadIdx.x / kWarp) * warp_floats<D>(KC);
  float4* rec = reinterpret_cast<float4*>(base);
  float* gb = base + 4 * NV * kWarp;            // [entry][sample]
  float* ms = gb + kWarp * kStride;             // [monomial][sample]
  float* osum = ms + kMaxMono * kWarp;          // [output row][sample]
  const int lane = threadIdx.x % kWarp, g = lane / 4, t = lane % 4;

  const long long w = (long long)blockIdx.x * kWarps + threadIdx.x / kWarp;
  if (w * kWarp >= Np) return;   // whole warps only
  const long long i = w * kWarp + lane;
  const float tile = mono[(long long)n_mono * Np + i];
  float x[D];
#pragma unroll
  for (int d = 0; d < D; ++d) x[d] = mono[(1 + d) * Np + i];
  for (int m = 0; m < n_mono; ++m) ms[m * kWarp + lane] = mono[m * Np + i];
  for (int r = 0; r < KC; ++r) osum[r * kWarp + lane] = 0.0f;
  const int lo = ent_lo[w];
  const int hi = lo + ent_n[w];

  for (int R0 = 0; R0 < R; R0 += 16 * kTiles) {
    float z[kTiles][4][4];
#pragma unroll
    for (int mt = 0; mt < kTiles; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) z[mt][nt][q] = 0.0f;

    for (int e0 = lo; e0 < hi; e0 += kWarp) {
      const int n = min(kWarp, hi - e0);
      __syncwarp();  // the previous records and G block are consumed
      if (lane < n) {
        const long long e = (long long)e0 + lane;
        float f[4 * NV];
#pragma unroll
        for (int q = 0; q < 1 + D + TRI; ++q) f[q] = geom[q * Ep + e];
#pragma unroll
        for (int q = 1 + D + TRI; q < 4 * NV; ++q) f[q] = 0.0f;
#pragma unroll
        for (int v = 0; v < NV; ++v)
          rec[dgs::staged_index(v, lane)] =
              make_float4(f[4 * v], f[4 * v + 1], f[4 * v + 2], f[4 * v + 3]);
      }
      __syncwarp();

      // G of the lane's sample with each staged entry (0 past the chunk,
      // off the sample's tile, or where the quadratic form is positive).
      for (int j = 0; j < kWarp; ++j) {
        float G = 0.0f;
        if (j < n) {
          float f[4 * NV];
#pragma unroll
          for (int v = 0; v < NV; ++v) {
            const float4 q = rec[dgs::staged_index(v, j)];
            f[4 * v] = q.x;
            f[4 * v + 1] = q.y;
            f[4 * v + 2] = q.z;
            f[4 * v + 3] = q.w;
          }
          if (f[0] == tile) {
            float X[D], a[D], con[TRI];
#pragma unroll
            for (int d = 0; d < D; ++d) X[d] = f[1 + d] - x[d];
#pragma unroll
            for (int u = 0; u < TRI; ++u) con[u] = f[1 + D + u];
            G = dgs::pair_gauss<D>(X, con, a);
          }
        }
        gb[j * kStride + lane] = G;
      }
      __syncwarp();

      // Z[r, n] += sum over the chunk's entries of fold[r, e] G[e, n].
      for (int ks = 0; 8 * ks < n; ++ks) {
        float b_hi[4][2], b_lo[4][2];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            dgs::tf32_split_rt(gb[(8 * ks + t + 4 * h) * kStride + 8 * nt + g],
                               three, b_hi[nt][h], b_lo[nt][h]);
#pragma unroll
        for (int mt = 0; mt < kTiles; ++mt) {
          const int r0 = R0 + 16 * mt;
          if (r0 >= Rp) break;
          float a_hi[4], a_lo[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int e = e0 + 8 * ks + t + 4 * (q / 2);
            const float v =
                e < hi ? fold[(long long)(r0 + g + 8 * (q % 2)) * Ep + e]
                       : 0.0f;
            dgs::tf32_split_rt(v, three, a_hi[q], a_lo[q]);
          }
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            dgs::mma_passes_rt(z[mt][nt], a_hi, a_lo, b_hi[nt], b_lo[nt],
                               three);
        }
      }
    }

    // The slice's rows through shared memory, 16 at a time; each lane adds
    // its sample's column times the row's monomial into its output rows.
#pragma unroll
    for (int mt = 0; mt < kTiles; ++mt) {
      const int r0 = R0 + 16 * mt;
      if (r0 >= R) break;
      __syncwarp();
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        float* zr = gb + g * kStride + 8 * nt + 2 * t;
        zr[0] = z[mt][nt][0];
        zr[1] = z[mt][nt][1];
        zr[8 * kStride] = z[mt][nt][2];
        zr[8 * kStride + 1] = z[mt][nt][3];
      }
      __syncwarp();
      for (int ii = 0; ii < 16 && r0 + ii < R; ++ii) {
        const int code = rowmap[r0 + ii];
        float* o = osum + (code >> 5) * kWarp + lane;
        *o = fmaf(gb[ii * kStride + lane], ms[(code & 31) * kWarp + lane], *o);
      }
    }
  }

  __syncwarp();
  for (int r = 0; r < KC; ++r) out[r * Np + i] = osum[r * kWarp + lane];
}

template <int D>
cudaError_t launch(const float* geom, long long Ep, const float* fold, int Rp,
                   int R, const float* mono, long long Np, int n_mono,
                   const int* ent_lo, const int* ent_n, int n_ranges, int KC,
                   const int* rowmap, bool three, float* out,
                   cudaStream_t stream) {
  const dim3 grid((n_ranges + kWarps - 1) / kWarps), block(kWarps * kWarp);
  const size_t bytes = sizeof(float) * kWarps * warp_floats<D>(KC);
  if (bytes > 227 * 1024) return cudaErrorInvalidValue;
  auto* kernel = tiled_forward_folded_kernel<D>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, block, bytes, stream>>>(geom, Ep, fold, Rp, R, mono, Np,
                                         n_mono, ent_lo, ent_n, KC, rowmap,
                                         three, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns cudaGetLastError() after the
// launch (0 = launched).  Pointers are device pointers; R is the folded row
// count, Rp its padding (a multiple of 16), n_mono the raw monomials (the
// tile row's index), KC = K * C the output rows; rowmap[r] =
// (k * C + c) * 32 + m for Z's row r = (k, m, c); `passes` 3 or 1.  Ranges
// are the classic forward's (32 samples).
int dgs_tiled_forward_folded(const void* geom, int Ep, const void* fold,
                             int Rp, int R, const void* mono, int Np,
                             int n_mono, const void* ent_lo,
                             const void* ent_n, int n_ranges, int D, int KC,
                             const void* rowmap, int passes, void* out,
                             void* stream) {
  if ((long long)n_ranges * kWarp != Np || Rp % 16 != 0 || R > Rp ||
      n_mono > kMaxMono || (passes != 1 && passes != 3))
    return (int)cudaErrorInvalidValue;
  const auto* g = static_cast<const float*>(geom);
  const auto* f = static_cast<const float*>(fold);
  const auto* m = static_cast<const float*>(mono);
  const auto* lo = static_cast<const int*>(ent_lo);
  const auto* n = static_cast<const int*>(ent_n);
  const auto* rm = static_cast<const int*>(rowmap);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const bool three = passes == 3;
  cudaError_t err = cudaErrorInvalidValue;
  if (D == 1)
    err = launch<1>(g, Ep, f, Rp, R, m, Np, n_mono, lo, n, n_ranges, KC, rm,
                    three, o, st);
  else if (D == 2)
    err = launch<2>(g, Ep, f, Rp, R, m, Np, n_mono, lo, n, n_ranges, KC, rm,
                    three, o, st);
  else if (D == 3)
    err = launch<3>(g, Ep, f, Rp, R, m, Np, n_mono, lo, n, n_ranges, KC, rm,
                    three, o, st);
  return (int)err;
}

}  // extern "C"
