// Tiled backward in moment form, for Hopper (sm_90a): the per-entry VJP as
// TF32 tensor-core contractions against the sample monomial basis.
//
// Replaces the TPU kernel dgs_tpu/kernels/tiled.py::tiled_backward
// (_wl_backward_kernel, moment branch, and _moment_rows).  For every
// tile-sorted entry, over the samples on its tile: per pair G, a = C X
// (X = mu_l - x_l, tile-local, wrap-free), the folded cotangents
// h_k = sum_c ct[k, c] v_c, the value gradients dv_c += sum_k ct[k, c] w_k,
// and the fused VJP's accumulators (formulas.fused_pair_accumulators:
// S0 = sum_k h_k poly_k, W_l, the laplacian cotangents hl, the thirds' Y),
// all on the CUDA cores as in tiled_backward.cu; then
//   M_S0[e, m]   = sum_n G S0[e, n] mono[m, n]   (m < 1 + D + tri)
// as a matrix product on the tensor cores (entries the M side, samples the
// K side, monomials the N side), always 3 TF32 passes (dgs_tpu pins this
// contraction to HIGHEST under fast-math too), and on the CUDA cores in
// fp32 the rows whose monomials are only [1, x_l]:
//   M_W_l[e, m]  = sum_n G W_l[e, n] mono[m, n]  (m < 1 + D),
// M_hl_t = sum_n G hl_t and M_Y_t = sum_n G Y_t (the monomial row 0 is 1).
// The W rows stay off the tensor cores for registers: as fragments their
// accumulators took 24 registers at D = 3, and the widest instantiations
// spilled at 255.
// The rows are kernels/tiled.py moment_layout's, then the C value-gradient
// rows, written entry-major: an (Ep, n_rows + C) fp32 array, one record an
// entry, each written once by its own lane or fragment in a fixed order (no
// atomics: bitwise repeatable).  kernels/tiled.py moment_combine folds the
// rows with the entry's geometry, and the segment-sum by Gaussian id
// follows (ops/sampling.py).
//
// Design.  The classic backward's layout and range sweep: one warp owns 32
// consecutive tile-sorted entries, a lane each, and sweeps its sample range
// 32 samples at a time, staging each sample's record [tile, x_l] and its
// K x CB cotangents (tiled_layout.cuh's backward record) and the samples'
// monomials, split hi / lo, as the B operand ([monomial][sample]).  Per 8
// samples (one k8 step) each lane computes its entry's pairs, adds the W,
// hl and Y rows into its own registers and stores G S0 to shared memory
// ([sample][entry], the A operand); the warp then runs mma.sync m16n8k8
// for its two m16 tiles into accumulator fragments that stay in registers
// for the whole sweep.  The
// VJP is linear in h, so channel passes of CB (C > 4) add into the same
// accumulators.  Warps share nothing and meet at no block barrier.
//
// What bounds it: the per-pair fp32 work (G, the polynomials, the h and dv
// FMAs, the accumulators), as in tiled_backward.cu, which it keeps; the
// contraction replaces the per-pair VJP's closing terms (about 4 D + 3 tri
// fp32 operations a pair) by D (1 + D) FMAs for the W rows, 6 NT mma.sync
// per 8 x 32 pairs and a shared-memory round trip of one float a pair.  Shared memory limits
// residency: 33 KB a block of two warps at D = 3 with all four orders.
// With a minimum of one block an SM in the launch bounds, ptxas sizes the
// registers by the code (without it, it held them to the residency that
// shared memory allows and spilled); the pair loop is not unrolled, which
// keeps the widest instantiation (D = 3, all four orders) within 255
// registers.  A simple first version.
//
// h_matmul (the HMM instantiations): per k-step of 8 samples the warp
// computes h_k for its entries as TF32 tensor-core contractions over the
// pass's channels (tf32_mma.cuh h_matmul_block, 3 passes or 1) into a block
// of shared memory that the lanes read, in place of the K x CB FMAs; the
// dvalues FMAs stay.  The h block takes K x 8 x 36 floats a warp, so these
// instantiations ask for more than 48 KB of dynamic shared memory at K = 20.
//
// Build: with the other sources into libdgs_kernels.so
// (dgs_tpu_torch/kernels/_build.py).  Never with --use_fast_math.
#include <cuda_runtime.h>

#include "tf32_mma.cuh"
#include "tiled_layout.cuh"

namespace {

constexpr int kWarps = 2;       // warps per block, each with its own range
constexpr int kVStride = 40;    // [sample][entry] row stride of the A block
constexpr int kBStride = 36;    // [monomial][sample] row stride of B

using dgs::kWarp;
using dgs::OrderRows;

DGS_HD constexpr int mono_rows(int D) { return 1 + D + dgs::tri_size(D); }
// n8 tiles of the M_S0 rows.
DGS_HD constexpr int s0_tiles(int D) { return (mono_rows(D) + 7) / 8; }
DGS_HD constexpr bool has_w(int mask) {
  return (mask & (dgs::kDerivative | dgs::kLaplacian | dgs::kThird)) != 0;
}
// kernels/tiled.py moment_layout's n_rows.
DGS_HD constexpr int n_moment_rows(int D, int mask) {
  return mono_rows(D) + (has_w(mask) ? D * (1 + D) : 0) +
         ((mask & dgs::kLaplacian) ? dgs::tri_size(D) : 0) +
         ((mask & dgs::kThird) ? dgs::tri_size(D) : 0);
}

template <int D, int MASK, int CB, bool HMM>
struct Staged {
  float4 rec[dgs::bwd_record_vecs(dgs::total_unique(D, MASK), CB) * kWarp];
  float b_hi[8 * s0_tiles(D)][kBStride];   // monomials of the staged samples
  float b_lo[8 * s0_tiles(D)][kBStride];
  float v[8][kVStride];   // one k-step's A operand, G S0 [sample][entry]
  // h_matmul: h_k of one k-step's 8 samples (tf32_mma.cuh h_matmul_block),
  // and the lanes' M_W, M_hl and M_Y rows [row][lane]
  float h[HMM ? dgs::total_unique(D, MASK) * 8 * dgs::kHStride : 4];
  float acc[HMM ? D * (1 + D) + 2 * dgs::tri_size(D) : 1][kWarp];
};

// The pair's h_k: from the lane's registers, or under h_matmul from the
// shared h block at each use (volatile, so that no copy of the K values is
// held in registers: held, the widest instantiations spilled).
struct HRegs {
  const float* h;
  __device__ __forceinline__ float operator()(int k) const { return h[k]; }
};
struct HBlock {
  const volatile float* col;   // hb + (j - j0) * kHStride + lane
  __device__ __forceinline__ float operator()(int k) const {
    return col[k * 8 * dgs::kHStride];
  }
};

// The fused VJP's per-pair accumulators of one kept pair (the quantities of
// pair_math.cuh pair_vjp, without their closing terms): GS = sum_k h_k w_k
// = G S0, W_l and Y_t as there; hl is h's laplacian block.
template <int D, int MASK, class H>
__device__ __forceinline__ void pair_accumulators(
    const float (&a)[D], const float (&q)[dgs::tri_size(D)],
    const float (&w)[dgs::total_unique(D, MASK)], const H& h, float& GS,
    float (&W)[D], float (&Y)[dgs::tri_size(D)]) {
  constexpr int TRI = dgs::tri_size(D);
  constexpr int K = dgs::total_unique(D, MASK);
  constexpr int kd = (MASK & dgs::kValue) ? 1 : 0;
  constexpr int kl = kd + ((MASK & dgs::kDerivative) ? D : 0);
  constexpr int kt = kl + ((MASK & dgs::kLaplacian) ? TRI : 0);
  GS = h(0) * w[0];
#pragma unroll
  for (int k = 1; k < K; ++k) GS += h(k) * w[k];
#pragma unroll
  for (int l = 0; l < D; ++l)
    W[l] = (MASK & dgs::kDerivative) ? h(kd + l) : 0.0f;
  if (MASK & dgs::kLaplacian) {
    int k = kl;
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int j = i; j < D; ++j, ++k) {
        if (i == j) {
          W[i] += (h(k) + h(k)) * a[i];
        } else {
          W[i] += h(k) * a[j];
          W[j] += h(k) * a[i];
        }
      }
  }
#pragma unroll
  for (int u = 0; u < TRI; ++u) Y[u] = 0.0f;
  if (MASK & dgs::kThird) {
    int k = kt;
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int j = i; j < D; ++j)
#pragma unroll
        for (int l = j; l < D; ++l, ++k) {
          const int tij = dgs::tri_index(D, i, j),
                    til = dgs::tri_index(D, i, l),
                    tjl = dgs::tri_index(D, j, l);
          W[i] -= h(k) * q[tjl];
          W[j] -= h(k) * q[til];
          W[l] -= h(k) * q[tij];
          Y[tij] += h(k) * a[l];
          Y[til] += h(k) * a[j];
          Y[tjl] += h(k) * a[i];
        }
  }
}

template <int D, int MASK, int CB, bool HMM>
__global__ void __launch_bounds__(kWarps * kWarp, 1) tiled_backward_moments_kernel(
    const float* __restrict__ geom,  // (>= 1 + D + tri + C, Ep) tile-local
    long long Ep, int C,
    const float* __restrict__ mono,  // (mono_rows + 1, Np): monomials, tile
    long long Np,
    const float* __restrict__ ct,    // (K * C, Np) cotangent
    const int* __restrict__ s_lo,    // (Ep / 32,) first sample of each range
    const int* __restrict__ s_n,     // (Ep / 32,) length of the range
    OrderRows rows, bool three,      // h_matmul's passes: 3, else 1
    float* __restrict__ out) {       // (Ep, n_rows + C), entry-major
  constexpr int TRI = dgs::tri_size(D);
  constexpr int K = dgs::total_unique(D, MASK);
  constexpr int MR = mono_rows(D), MP = 1 + D, NT = s0_tiles(D);
  constexpr int NV = dgs::bwd_record_vecs(K, CB);
  constexpr int NROWS = n_moment_rows(D, MASK);
  constexpr int ROW_HL = MR + (has_w(MASK) ? D * MP : 0);
  constexpr int ROW_Y = ROW_HL + ((MASK & dgs::kLaplacian) ? TRI : 0);
  // The warps' staged blocks, in dynamic shared memory (launch_one passes
  // kWarps of them).
  extern __shared__ float s_dt[];
  static_assert(sizeof(Staged<D, MASK, CB, HMM>) % 16 == 0,
                "whole 16-byte vectors a warp");
  Staged<D, MASK, CB, HMM>& sh =
      reinterpret_cast<Staged<D, MASK, CB, HMM>*>(s_dt)[threadIdx.x / kWarp];
  const int lane = threadIdx.x % kWarp, g = lane / 4, t = lane % 4;

  // Every lane owns a real column (Ep == 32 * ranges; pads have tile -1.0).
  const long long w = (long long)blockIdx.x * kWarps + threadIdx.x / kWarp;
  if (w * kWarp >= Ep) return;   // whole warps only
  const long long col = w * kWarp + lane;
  const long long nout = NROWS + C;
  const float tile = geom[col];
  float mu[D], con[TRI];
#pragma unroll
  for (int d = 0; d < D; ++d) mu[d] = geom[(1 + d) * Ep + col];
#pragma unroll
  for (int u = 0; u < TRI; ++u) con[u] = geom[(1 + D + u) * Ep + col];
  const int lo = s_lo[w];
  const int hi = lo + s_n[w];

  // Accumulator fragments of M_S0 [m16 tile][n8 tile]; the lane's own
  // M_W_l [l][m], M_hl and M_Y rows.
  // Under HMM the lane's M_W, M_hl and M_Y rows live in its column of
  // sh.acc (the h block's registers made the widest instantiations spill).
  float cS[2][NT][4], mw_r[HMM ? 1 : D][MP], hl_r[HMM ? 1 : TRI],
      Ysum_r[HMM ? 1 : TRI];
  auto mw = [&](int l, int m) -> float& {
    return HMM ? sh.acc[l * MP + m][lane] : mw_r[HMM ? 0 : l][m];
  };
  auto hl = [&](int u) -> float& {
    return HMM ? sh.acc[D * MP + u][lane] : hl_r[HMM ? 0 : u];
  };
  auto Ysum = [&](int u) -> float& {
    return HMM ? sh.acc[D * MP + TRI + u][lane] : Ysum_r[HMM ? 0 : u];
  };
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) cS[mt][nt][r] = 0.0f;
#pragma unroll
  for (int l = 0; l < D; ++l)
#pragma unroll
    for (int m = 0; m < MP; ++m) mw(l, m) = 0.0f;
#pragma unroll
  for (int u = 0; u < TRI; ++u) hl(u) = Ysum(u) = 0.0f;

  for (int c0 = 0; c0 < C; c0 += CB) {
    float v[CB], dv[CB];
#pragma unroll
    for (int c = 0; c < CB; ++c) {
      v[c] = (c0 + c < C) ? geom[(1 + D + TRI + c0 + c) * Ep + col] : 0.0f;
      dv[c] = 0.0f;
    }

    for (int s0 = lo; s0 < hi; s0 += kWarp) {
      const int n = min(kWarp, hi - s0);
      __syncwarp();  // the previous records and monomials are consumed
      {
        const long long s = (long long)s0 + lane;
        const bool live = lane < n;
        if (live) {
          float g4[4 * (NV - 1)];
#pragma unroll
          for (int k = 0; k < K; ++k) {
            const float* ct_k =
                ct + (dgs::packed_component<D, MASK>(k, rows) * C + c0) * Np +
                s;
#pragma unroll
            for (int c = 0; c < CB; ++c)
              g4[k * CB + c] = (c0 + c < C) ? ct_k[c * Np] : 0.0f;
          }
#pragma unroll
          for (int q = K * CB; q < 4 * (NV - 1); ++q) g4[q] = 0.0f;
          sh.rec[lane] = make_float4(
              mono[MR * Np + s], D > 0 ? mono[Np + s] : 0.0f,
              D > 1 ? mono[2 * Np + s] : 0.0f,
              D > 2 ? mono[3 * Np + s] : 0.0f);
#pragma unroll
          for (int vv = 1; vv < NV; ++vv)
            sh.rec[vv * kWarp + lane] =
                make_float4(g4[4 * vv - 4], g4[4 * vv - 3], g4[4 * vv - 2],
                            g4[4 * vv - 1]);
        }
#pragma unroll
        for (int m = 0; m < 8 * NT; ++m) {
          const float x = live && m < MR ? mono[m * Np + s] : 0.0f;
          dgs::tf32_split(x, sh.b_hi[m][lane], sh.b_lo[m][lane]);
        }
      }
      __syncwarp();

      for (int ks = 0; 8 * ks < n; ++ks) {
        if (HMM) {
          // The values' fragments are reloaded for each block of 8 samples
          // (from L1): held across the sweep they made the widest
          // instantiations spill.
          float va_hi[2][4], va_lo[2][4];
          dgs::h_matmul_values<CB>(geom, Ep, 1 + D + TRI, C, c0, col - lane,
                                   three, va_hi, va_lo);
          dgs::h_matmul_block<K, CB>(reinterpret_cast<const float*>(sh.rec),
                                     8 * ks, va_hi, va_lo, three, sh.h);
          __syncwarp();
        }
#pragma unroll 1
        for (int jj = 0; jj < 8; ++jj) {
          const int j = 8 * ks + jj;
          float gs = 0.0f;
          const float4 head = sh.rec[j];
          if (j < n && head.x == tile) {
            const float xs[3] = {head.y, head.z, head.w};
            float X[D], a[D], q[TRI], wk[K], h[HMM ? 1 : K], W[D], Y[TRI],
                GS;
#pragma unroll
            for (int d = 0; d < D; ++d) X[d] = mu[d] - xs[d];
            const float G = dgs::pair_gauss<D>(X, con, a);
            dgs::pair_polys<D, MASK>(con, a, q);
            dgs::component_weights<D, MASK>(con, a, q, G, wk);
#pragma unroll
            for (int k = 0; k < (HMM ? 1 : K); ++k) h[k] = 0.0f;
#pragma unroll
            for (int gv = 0; gv < NV - 1; ++gv) {
              const float4 c4 = sh.rec[(1 + gv) * kWarp + j];
              const float ctv[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
              for (int u = 0; u < 4; ++u) {
                const int idx = 4 * gv + u;
                if (idx < K * CB) {
                  if (!HMM)
                    h[idx / CB] = fmaf(ctv[u], v[idx % CB], h[idx / CB]);
                  dv[idx % CB] = fmaf(ctv[u], wk[idx / CB], dv[idx % CB]);
                }
              }
            }
            const HBlock hb{sh.h + jj * dgs::kHStride + lane};
            const HRegs hr{h};
            if (HMM)
              pair_accumulators<D, MASK>(a, q, wk, hb, GS, W, Y);
            else
              pair_accumulators<D, MASK>(a, q, wk, hr, GS, W, Y);
            gs = GS;
            if (has_w(MASK)) {
#pragma unroll
              for (int l = 0; l < D; ++l) {
                const float gw = G * W[l];
                mw(l, 0) += gw;
#pragma unroll
                for (int d = 0; d < D; ++d)
                  mw(l, 1 + d) = fmaf(gw, xs[d], mw(l, 1 + d));
              }
            }
            if (MASK & dgs::kLaplacian) {
              constexpr int kl = ((MASK & dgs::kValue) ? 1 : 0) +
                                 ((MASK & dgs::kDerivative) ? D : 0);
#pragma unroll
              for (int u = 0; u < TRI; ++u)
                hl(u) = fmaf(G, HMM ? hb(kl + u) : hr(kl + u), hl(u));
            }
            if (MASK & dgs::kThird) {
#pragma unroll
              for (int u = 0; u < TRI; ++u) Ysum(u) = fmaf(G, Y[u], Ysum(u));
            }
          }
          sh.v[jj][lane] = gs;
        }
        __syncwarp();

        // M[e, m] += sum over the 8 samples of V[e, s] mono[m, s].
        float b_hi[NT][2], b_lo[NT][2];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            b_hi[nt][r] = sh.b_hi[8 * nt + g][8 * ks + t + 4 * r];
            b_lo[nt][r] = sh.b_lo[8 * nt + g][8 * ks + t + 4 * r];
          }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          float a_hi[4], a_lo[4];
#pragma unroll
          for (int r = 0; r < 4; ++r)
            dgs::tf32_split(sh.v[t + 4 * (r / 2)][16 * mt + g + 8 * (r % 2)],
                            a_hi[r], a_lo[r]);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
            dgs::mma_passes<3>(cS[mt][nt], a_hi, a_lo, b_hi[nt], b_lo[nt]);
        }
        __syncwarp();  // the A block is consumed before the next k-step
      }
    }

    float* rec = out + col * nout;
#pragma unroll
    for (int c = 0; c < CB; ++c)
      if (c0 + c < C) rec[NROWS + c0 + c] = dv[c];
  }

  // The lane's own rows, then the fragments' (entry e0 + 16 mt + g (+ 8),
  // monomial 8 nt + 2 t (+ 1)).
  float* rec = out + col * nout;
  if (has_w(MASK)) {
#pragma unroll
    for (int l = 0; l < D; ++l)
#pragma unroll
      for (int m = 0; m < MP; ++m) rec[MR + l * MP + m] = mw(l, m);
  }
  if (MASK & dgs::kLaplacian) {
#pragma unroll
    for (int u = 0; u < TRI; ++u) rec[ROW_HL + u] = hl(u);
  }
  if (MASK & dgs::kThird) {
#pragma unroll
    for (int u = 0; u < TRI; ++u) rec[ROW_Y + u] = Ysum(u);
  }
  const long long e_base = w * kWarp;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float* er = out + (e_base + 16 * mt + g + 8 * (r / 2)) * nout;
      const int m = 2 * t + r % 2;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        if (8 * nt + m < MR) er[8 * nt + m] = cS[mt][nt][r];
    }
}

template <int D, int MASK, int CB, bool HMM>
cudaError_t launch_one(const float* geom, long long Ep, int C,
                       const float* mono, long long Np, const float* ct,
                       const int* s_lo, const int* s_n, int n_ranges,
                       OrderRows rows, bool three, float* out,
                       cudaStream_t stream) {
  const dim3 grid((n_ranges + kWarps - 1) / kWarps), block(kWarps * kWarp);
  constexpr size_t bytes = sizeof(Staged<D, MASK, CB, HMM>) * kWarps;
  static_assert(HMM || bytes <= 48 * 1024,
                "above the default shared-memory limit");
  static_assert(bytes <= 227 * 1024, "above the shared memory of an SM");
  auto* kernel = tiled_backward_moments_kernel<D, MASK, CB, HMM>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, block, bytes, stream>>>(geom, Ep, C, mono, Np, ct, s_lo,
                                         s_n, rows, three, out);
  return cudaGetLastError();
}

template <int D, int CB, bool HMM>
cudaError_t launch(int mask, const float* geom, long long Ep, int C,
                   const float* mono, long long Np, const float* ct,
                   const int* s_lo, const int* s_n, int n_ranges,
                   OrderRows rows, bool three, float* out,
                   cudaStream_t stream) {
  switch (mask) {
#define DGS_CASE(M)                                                        \
  case M:                                                                  \
    return launch_one<D, M, CB, HMM>(geom, Ep, C, mono, Np, ct, s_lo, s_n, \
                                     n_ranges, rows, three, out, stream);
    DGS_CASE(1) DGS_CASE(2) DGS_CASE(3) DGS_CASE(4) DGS_CASE(5)
    DGS_CASE(6) DGS_CASE(7) DGS_CASE(8) DGS_CASE(9) DGS_CASE(10)
    DGS_CASE(11) DGS_CASE(12) DGS_CASE(13) DGS_CASE(14) DGS_CASE(15)
#undef DGS_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

// The launches of both C entries.
template <bool HMM>
int launch_moments(const void* geom, int Ep, int C, const void* mono, int Np,
                   const void* ct, const void* s_lo, const void* s_n,
                   int n_ranges, int D, int mask, OrderRows rows, bool three,
                   void* out, void* stream) {
  if ((long long)n_ranges * kWarp != Ep || C < 1)
    return (int)cudaErrorInvalidValue;
  const auto* g = static_cast<const float*>(geom);
  const auto* m = static_cast<const float*>(mono);
  const auto* c = static_cast<const float*>(ct);
  const auto* lo = static_cast<const int*>(s_lo);
  const auto* n = static_cast<const int*>(s_n);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const int cb = (D == 2 && C <= 2) ? C : 4;
#define DGS_LAUNCH(DD, CB)                                                 \
  launch<DD, CB, HMM>(mask, g, Ep, C, m, Np, c, lo, n, n_ranges, rows,     \
                      three, o, st)
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

}  // namespace

extern "C" {

// Rows of the kernel's output record before the C value-gradient rows
// (kernels/tiled.py moment_layout's n_rows), for the wrapper's check.
int dgs_tiled_backward_moments_rows(int D, int mask) {
  return D == 1 ? n_moment_rows(1, mask)
         : D == 2 ? n_moment_rows(2, mask)
                  : n_moment_rows(3, mask);
}

// Launches the kernel on `stream` and returns cudaGetLastError() after the
// launch (0 = launched).  Pointers are device pointers; `mask` is the order
// set (bits of pair_math.cuh), r_* the first cotangent component of each
// order.  Ranges are the classic backward's (32 entries).
int dgs_tiled_backward_moments(const void* geom, int Ep, int C,
                               const void* mono, int Np, const void* ct,
                               const void* s_lo, const void* s_n,
                               int n_ranges, int D, int mask, int r_value,
                               int r_derivative, int r_laplacian, int r_third,
                               void* out, void* stream) {
  return launch_moments<false>(
      geom, Ep, C, mono, Np, ct, s_lo, s_n, n_ranges, D, mask,
      OrderRows{r_value, r_derivative, r_laplacian, r_third}, true, out,
      stream);
}

// The same under h_matmul: h_k from `passes` (3 or 1) TF32 tensor-core
// passes over the channels (tf32_mma.cuh h_matmul_block).
int dgs_tiled_backward_moments_hmm(const void* geom, int Ep, int C,
                                   const void* mono, int Np, const void* ct,
                                   const void* s_lo, const void* s_n,
                                   int n_ranges, int D, int mask,
                                   int r_value, int r_derivative,
                                   int r_laplacian, int r_third, int passes,
                                   void* out, void* stream) {
  if (passes != 1 && passes != 3) return (int)cudaErrorInvalidValue;
  return launch_moments<true>(
      geom, Ep, C, mono, Np, ct, s_lo, s_n, n_ranges, D, mask,
      OrderRows{r_value, r_derivative, r_laplacian, r_third}, passes == 3,
      out, stream);
}

}  // extern "C"
