// Tiled backward under the folded forward with folded_dvals, for Hopper
// (sm_90a): the folded dvalues, with their contraction on the tensor cores.
// The fully folded VJP is tiled_backward_fvjp.cu.
//
// Replaces the TPU kernel dgs_tpu/kernels/tiled.py::tiled_backward
// (_wl_backward_kernel) in its folded-dvalues branch (_compute_one under
// folded_dvals, dgs_tpu/kernels/tiled.py:1117-1145).  For
// every tile-sorted entry, with the beta-expanded cotangent cb (R rows
// (k, m, c): ct[k, c] * monomial m, kernels/tiled.py ct_beta_rows) and G of
// each same-tile pair (X = mu_l - x_l, wrap-free):
//
//   Zd[r, e]    = sum_n cb[r, n] G[n, e]                (the tensor cores)
//   dvalues_c   = sum_i alpha_i Zd[i * C + c]           (alpha: geom rows)
//
// The kernel (tiled_backward_fdv_kernel): the mean and conic rows are
// the classic per-pair VJP of tiled_backward.cuh (entry_sweep without the
// value gradients: h_k from the (K*C, Np) cotangent, with h_matmul as
// tensor-core contractions), then the Zd sweep gives the value rows.  One
// warp a range of 32 entries (a lane each), R in slices of 64 rows, the
// warp's sample range swept once a slice: G is computed once a slice, cb
// read from device memory as the fragments need it.  A simple first version;
// tiled_backward_fvjp.cu's staging (cp.async chunks shared by a block's
// warps, G once a pair) is the way to redesign it.
//
// Build: with the other sources into libdgs_kernels.so
// (dgs_tpu_torch/kernels/_build.py).  Never with --use_fast_math.
#include "tiled_backward.cuh"

namespace {

constexpr int kWarps = 2;      // warps per block, each with its own range
constexpr int kTiles = 4;      // m16 tiles of Zd a slice (64 rows)
constexpr int kStride = 40;    // row stride (floats) of the shared blocks

using dgs::kWarp;
using dgs::OrderRows;

// The folded sweep's part of a warp's shared memory: the staged sample
// heads, the G block (also the Zd rows of the epilogue), and the per-entry
// dvalues rows, [row][lane].
DGS_HD constexpr int sweep_floats(int C) {
  return 4 * kWarp + kWarp * kStride + C * kWarp;
}

// The Zd slices of one warp (the folded dvalues).  ``col`` is the lane's
// entry; its tile, mu_l and conic come from geom; the value rows are left
// in ``dvs`` ([row][lane]).
template <int D>
__device__ __forceinline__ void folded_sweep(
    const float* __restrict__ geom, long long Ep, int C,
    const float* __restrict__ smp, long long Np,
    const float* __restrict__ cb, int Rp, int R, int lo, int hi,
    long long col, bool three, float* sm, float* dvs) {
  constexpr int TRI = dgs::tri_size(D);
  const int lane = threadIdx.x % kWarp, g = lane / 4, t = lane % 4;
  float4* heads = reinterpret_cast<float4*>(sm);
  float* gb = sm + 4 * kWarp;                  // [sample][entry]
  const long long a0 = 1 + D + TRI + C;        // geom row of alpha_0
  const float tile = geom[col];
  float mu[D], con[TRI];
#pragma unroll
  for (int d = 0; d < D; ++d) mu[d] = geom[(1 + d) * Ep + col];
#pragma unroll
  for (int u = 0; u < TRI; ++u) con[u] = geom[(1 + D + u) * Ep + col];
  for (int c = 0; c < C; ++c) dvs[c * kWarp + lane] = 0.0f;

  for (int R0 = 0; R0 < R; R0 += 16 * kTiles) {
    float z[kTiles][4][4];
#pragma unroll
    for (int mt = 0; mt < kTiles; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) z[mt][nt][q] = 0.0f;

    for (int s0 = lo; s0 < hi; s0 += kWarp) {
      const int n = min(kWarp, hi - s0);
      __syncwarp();  // the previous heads and blocks are consumed
      if (lane < n) {
        const long long s = (long long)s0 + lane;
        heads[lane] = make_float4(smp[D * Np + s], smp[s],
                                  D > 1 ? smp[Np + s] : 0.0f,
                                  D > 2 ? smp[2 * Np + s] : 0.0f);
      }
      __syncwarp();
      for (int j = 0; j < kWarp; ++j) {
        float G = 0.0f;
        if (j < n) {
          const float4 h = heads[j];
          if (h.x == tile) {
            const float xs[3] = {h.y, h.z, h.w};
            float X[D], a[D];
#pragma unroll
            for (int d = 0; d < D; ++d) X[d] = mu[d] - xs[d];
            G = dgs::pair_gauss<D>(X, con, a);
          }
        }
        gb[j * kStride + lane] = G;
      }
      __syncwarp();

      // Zd[r, e] += sum over the chunk's samples of cb[r, n] G[n, e].
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
            const int sj = 8 * ks + t + 4 * (q / 2);
            const float v =
                sj < n ? cb[(long long)(r0 + g + 8 * (q % 2)) * Np + s0 + sj]
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

    // The slice's Zd rows through shared memory, 16 at a time; each lane
    // adds its entry's column into its value rows (times alpha).
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
        const int r = r0 + ii, i = r / C, c = r - i * C;
        const float zd = gb[ii * kStride + lane];
        float* dv = dvs + c * kWarp + lane;
        *dv = fmaf(geom[(a0 + i) * Ep + col], zd, *dv);
      }
    }
  }
  __syncwarp();
}

// Folded dvalues: the classic VJP's mean and conic rows (entry_sweep
// without the value gradients), then the Zd sweep's value rows.  Output
// (Ep, D + tri + C), entry-major.
template <int D, int MASK, int CB, bool HMM>
__global__ void __launch_bounds__(kWarps * kWarp, 1) tiled_backward_fdv_kernel(
    const float* __restrict__ geom,  // (1 + D + tri + C + A, Ep) folded geom
    long long Ep, int C,
    const float* __restrict__ smp,   // (D + 1, Np): x_l, tile
    long long Np,
    const float* __restrict__ ct,    // (K * C, Np) cotangent
    const float* __restrict__ cb,    // (Rp, Np) beta-expanded cotangent
    int Rp, int R,
    const int* __restrict__ s_lo, const int* __restrict__ s_n,
    OrderRows rows, bool three, float* __restrict__ out) {
  constexpr int TRI = dgs::tri_size(D);
  constexpr int K = dgs::total_unique(D, MASK);
  constexpr int NV = dgs::bwd_record_vecs(K, CB);
  constexpr int HB = HMM ? K * 8 * dgs::kHStride : 0;
  extern __shared__ float s_dt[];
  const int warp_floats = 4 * NV * kWarp + HB + sweep_floats(C);
  float* base = s_dt + (threadIdx.x / kWarp) * warp_floats;
  float4* s_rec = reinterpret_cast<float4*>(base);
  float* hb = base + 4 * NV * kWarp;
  float* sm = hb + HB;
  float* dvs = sm + sweep_floats(0);
  const int lane = threadIdx.x % kWarp;

  const long long w = (long long)blockIdx.x * kWarps + threadIdx.x / kWarp;
  if (w * kWarp >= Ep) return;   // whole warps only
  const long long col = w * kWarp + lane;
  const int lo = s_lo[w], hi = lo + s_n[w];
  dgs::Entry<D, CB> ent;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    ent.mu[d] = geom[(1 + d) * Ep + col];
    ent.dmu[d] = 0.0f;
  }
#pragma unroll
  for (int u = 0; u < TRI; ++u) {
    ent.con[u] = geom[(1 + D + u) * Ep + col];
    ent.dcon[u] = 0.0f;
  }
  dgs::entry_sweep<D, MASK, CB, false, false, HMM>(
      geom, Ep, C, smp, Np, ct, lo, hi, 0.0f, 0.0f, rows, col, s_rec, hb,
      three, ent, nullptr);
  folded_sweep<D>(geom, Ep, C, smp, Np, cb, Rp, R, lo, hi, col, three, sm,
                  dvs);
  float* rec = out + col * (D + TRI + C);
#pragma unroll
  for (int d = 0; d < D; ++d) rec[d] = ent.dmu[d];
#pragma unroll
  for (int u = 0; u < TRI; ++u) rec[D + u] = ent.dcon[u];
  for (int c = 0; c < C; ++c) rec[D + TRI + c] = dvs[c * kWarp + lane];
}

// A launch with `bytes` of dynamic shared memory (above 48 KB by opt-in).
template <class Kernel, class... Args>
cudaError_t launch_dyn(Kernel kernel, int n_ranges, size_t bytes,
                       cudaStream_t stream, Args... args) {
  if (bytes > 227 * 1024) return cudaErrorInvalidValue;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((n_ranges + kWarps - 1) / kWarps), block(kWarps * kWarp);
  kernel<<<grid, block, bytes, stream>>>(args...);
  return cudaGetLastError();
}

template <int D, int MASK, int CB, bool HMM>
cudaError_t launch_fdv_one(const float* geom, long long Ep, int C,
                           const float* smp, long long Np, const float* ct,
                           const float* cb, int Rp, int R, const int* s_lo,
                           const int* s_n, int n_ranges, OrderRows rows,
                           bool three, float* out, cudaStream_t stream) {
  constexpr int K = dgs::total_unique(D, MASK);
  const size_t bytes =
      sizeof(float) * kWarps *
      (4 * dgs::bwd_record_vecs(K, CB) * kWarp +
       (HMM ? K * 8 * dgs::kHStride : 0) + sweep_floats(C));
  return launch_dyn(tiled_backward_fdv_kernel<D, MASK, CB, HMM>, n_ranges,
                    bytes, stream, geom, Ep, C, smp, Np, ct, cb, Rp, R, s_lo,
                    s_n, rows, three, out);
}

template <int D, bool HMM>
cudaError_t launch_fdv(int mask, const float* geom, long long Ep, int C,
                       const float* smp, long long Np, const float* ct,
                       const float* cb, int Rp, int R, const int* s_lo,
                       const int* s_n, int n_ranges, OrderRows rows,
                       bool three, float* out, cudaStream_t stream) {
  switch (mask) {
#define DGS_CASE(M)                                                         \
  case M:                                                                   \
    return launch_fdv_one<D, M, 4, HMM>(geom, Ep, C, smp, Np, ct, cb, Rp,   \
                                        R, s_lo, s_n, n_ranges, rows, three, \
                                        out, stream);
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

// Launches the folded-dvalues kernel on `stream` and returns
// cudaGetLastError() after the launch (0 = launched).  Pointers are device
// pointers; `mask` is the order set, r_* the first cotangent component of
// each order; R / Rp the folded rows and their padding (a multiple of 16);
// `passes` 3 or 1; `hmm` 1 for h_matmul.  The classic VJP runs in channel
// passes of 4.  Ranges are the classic backward's (32 entries).
int dgs_tiled_backward_fdv(const void* geom, int Ep, int C, const void* smp,
                           int Np, const void* ct, const void* cb, int Rp,
                           int R, const void* s_lo, const void* s_n,
                           int n_ranges, int D, int mask, int r_value,
                           int r_derivative, int r_laplacian, int r_third,
                           int passes, int hmm, void* out, void* stream) {
  if ((long long)n_ranges * kWarp != Ep || C < 1 || Rp % 16 != 0 ||
      R > Rp || (passes != 1 && passes != 3))
    return (int)cudaErrorInvalidValue;
  const OrderRows rows{r_value, r_derivative, r_laplacian, r_third};
  const auto* g = static_cast<const float*>(geom);
  const auto* s = static_cast<const float*>(smp);
  const auto* c = static_cast<const float*>(ct);
  const auto* b = static_cast<const float*>(cb);
  const auto* lo = static_cast<const int*>(s_lo);
  const auto* n = static_cast<const int*>(s_n);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const bool three = passes == 3;
#define DGS_LAUNCH(DD, HH)                                                  \
  launch_fdv<DD, HH>(mask, g, Ep, C, s, Np, c, b, Rp, R, lo, n, n_ranges,   \
                     rows, three, o, st)
  cudaError_t err = cudaErrorInvalidValue;
  if (D == 1)
    err = hmm ? DGS_LAUNCH(1, true) : DGS_LAUNCH(1, false);
  else if (D == 2)
    err = hmm ? DGS_LAUNCH(2, true) : DGS_LAUNCH(2, false);
  else if (D == 3)
    err = hmm ? DGS_LAUNCH(3, true) : DGS_LAUNCH(3, false);
#undef DGS_LAUNCH
  return (int)err;
}

}  // extern "C"
