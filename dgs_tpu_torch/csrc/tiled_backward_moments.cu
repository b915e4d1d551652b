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
// What bounds it, as measured (chip_smoke.py's modes_slice, and
// chip_variants.py timing variants of this source beside it, on an H100
// 80GB HBM3 at 700 W; PERF.md): the per-pair fp32 work (G, the
// polynomials, the h and dv FMAs, the accumulators: about 146 operations a
// pair at D = 3, three orders), as in tiled_backward.cu, and the latency
// it leaves exposed at the warps an SM holds.  The contraction replaces the per-pair
// VJP's closing terms by D (1 + D) FMAs for the W rows, 6 NT mma.sync per
// 8 x 32 pairs and a shared-memory store of one float a pair.  The first
// version (one warp a range, its own synchronous staging and split, two
// warp barriers a k8 step, 194 registers at D = 3) held 10 warps an SM.
//
// Design.  A block of 4 warps (3 at D <= 2, where about six ranges share a
// tile and fewer in a block straddle two) owns as many consecutive
// 32-entry ranges, a warp each and a lane an entry, and sweeps the union
// of their sample ranges 32 samples at a time, one barrier a chunk:
//   - cp.async (16-byte copies) brings the chunk's rows two chunks ahead:
//     the monomials and the tile (mono's rows 0 .. MR) and the pass's
//     cotangents ct[k, c];
//   - one chunk ahead the block transposes them into the samples' records
//     ([tile, x_l], then the K x CB cotangents: tiled_layout.cuh's backward
//     record) and splits the monomials into the B fragments, once for all
//     warps;
//   - each warp whose range meets the chunk computes its pairs (records
//     read with 16-byte broadcast loads, staged_vector), adds the W, hl and
//     Y rows into its lanes' registers, stores G S0 into its A block
//     ([sample][entry]) and contracts it with the chunk's B fragments
//     (mma.sync m16n8k8, 3 TF32 passes, issued pass-major) into the M_S0
//     fragments it holds for the whole sweep.
// The launch bounds ask for 4 blocks an SM at D = 3 up to 10 unique
// components (128 registers: 16 warps) and 6 at D <= 2 with the value
// order (96 registers: 18 warps), without spills (min_blocks).  The VJP is
// linear in h, so channel passes of CB (C > 4) add into the same
// accumulators.
//
// Tried and dropped (D = 3 three orders / D = 2 headline ms, in the calls
// that timed them; the first version 13.3-13.6 / 1.87-1.93, kernel 2
// 8.9-9.2 / 1.37-1.39 in the same calls): records gathered by 4-byte
// cp.async, with one warp a block (its own range): 20.0 / 2.68, with 2, 4
// and 8 warps: 13.5 / 2.24, 12.5 / 2.20, 13.9 / 2.50; synchronous record
// loads: 12.9 / 2.36; the 16-byte rows and the transposition instead:
// 11.1 / 2.03; 5 blocks an SM at D = 3 spilled; at D <= 2, 4 warps at 5
// blocks (96 registers) 1.87 but spilling, 3 warps at 5 blocks (104
// registers) 2.05-2.09, 2 warps at 10 blocks 1.91, the D = 3 shape (4
// warps at 4 blocks, 117 registers) 2.02 against 1.88 and the first
// version's 1.91 in the same call; the staging and preparing loops all
// kept rolled: 11.6 / 1.95 (the staging loop unrolled spilled 8-116 bytes
// in 23 instantiations).
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

#include "cp_async.cuh"
#include "tf32_mma.cuh"
#include "tiled_layout.cuh"

namespace {

using dgs::kWarp;
using dgs::OrderRows;

// Warps a block, each with its own range: 4 at D = 3, 3 at D <= 2 (about
// six ranges a tile there: fewer ranges a block straddle two tiles).
DGS_HD constexpr int warps_of(int D) { return D == 3 ? 4 : 3; }
constexpr int kNS = 32;         // samples a chunk
constexpr int kVStride = 40;    // [sample][entry] row stride of the A block

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
struct Shared {
  static constexpr int K = dgs::total_unique(D, MASK);
  static constexpr int NV = dgs::bwd_record_vecs(K, CB);
  static constexpr int MR = mono_rows(D), NT = s0_tiles(D);
  // A chunk's rows as cp.async lands them ([row][sample]): the monomials
  // and the tile (mono rows 0 .. MR), then the pass's cotangents ct[k, c]
  // (row k CB + c); two chunks ahead of their use.
  static constexpr int RAW = (MR + 1 + K * CB + 3) / 4 * 4;
  float raw[2][RAW][kNS];
  // The chunk's records, transposed from raw ([tile, x_l], then the
  // cotangents, tiled_layout.cuh's backward record; [vector][sample]).
  float4 rec[2][NV * kNS];
  // The M_S0 B fragments of a chunk, split once: (k8 step, n8 tile, lane)
  // {hi, hi, lo, lo}, double-buffered.
  float4 bfrag[2][kNS / 8 * NT * kWarp];
  // A warp's A block, G S0 [sample][entry], and under h_matmul its h block
  // (tf32_mma.cuh h_matmul_block) and its lanes' M_W, M_hl and M_Y rows
  // [row][lane].
  struct Warp {
    float v[kNS][kVStride];
    float h[HMM ? K * 8 * dgs::kHStride : 4];
    float acc[HMM ? D * (1 + D) + 2 * dgs::tri_size(D) : 4][kWarp];
  };
  Warp warp[warps_of(D)];
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

// Blocks an SM should hold, for ptxas's register budget: at D <= 2, 6 (18
// warps, 96 registers a thread) for the order sets with the value order
// and 5 (at most 136) for the others, some of which need more than 96; at
// D = 3, 4 (16 warps, 128 registers) up to 10 unique components (three
// orders and every order set below) and 2 with more (the third order); 1
// under h_matmul, whose h block holds the shared memory.
DGS_HD constexpr int min_blocks(int D, int mask, bool hmm) {
  return hmm ? 1
         : D <= 2 ? ((mask & dgs::kValue) ? 6 : 5)
                  : (dgs::total_unique(D, mask) <= 10 ? 4 : 2);
}

template <int D, int MASK, int CB, bool HMM>
__global__ void __launch_bounds__(warps_of(D) * kWarp,
                                  min_blocks(D, MASK, HMM))
    tiled_backward_moments_kernel(
    const float* __restrict__ geom,  // (>= 1 + D + tri + C, Ep) tile-local
    long long Ep, int C,
    const float* __restrict__ mono,  // (mono_rows + 1, Np): monomials, tile
    long long Np,
    const float* __restrict__ ct,    // (K * C, Np) cotangent
    const int* __restrict__ s_lo,    // (Ep / 32,) first sample of each range
    const int* __restrict__ s_n,     // (Ep / 32,) length of the range
    OrderRows rows,
    bool three,                      // h_matmul's passes: 3, else 1
    float* __restrict__ out) {       // (Ep, n_rows + C), entry-major
  using Sh = Shared<D, MASK, CB, HMM>;
  constexpr int kWarps = warps_of(D), kThreads = kWarps * kWarp;
  constexpr int TRI = dgs::tri_size(D);
  constexpr int K = Sh::K, NV = Sh::NV;
  constexpr int MR = mono_rows(D), MP = 1 + D, NT = s0_tiles(D);
  constexpr int NROWS = n_moment_rows(D, MASK);
  constexpr int ROW_HL = MR + (has_w(MASK) ? D * MP : 0);
  constexpr int ROW_Y = ROW_HL + ((MASK & dgs::kLaplacian) ? TRI : 0);
  extern __shared__ float s_dt[];
  Sh& sh = *reinterpret_cast<Sh*>(s_dt);
  const int tid = threadIdx.x, warp = tid / kWarp, lane = tid % kWarp;
  const int g = lane / 4, t = lane % 4;
  typename Sh::Warp& sw = sh.warp[warp];

  // The warp's range (none past the last: such warps only stage and wait).
  const long long w = (long long)blockIdx.x * kWarps + warp;
  const bool real = w * kWarp < Ep;
  const long long col = real ? w * kWarp + lane : lane;
  const long long nout = NROWS + C;
  const int lo = real ? s_lo[w] : 0;
  const int hi = real ? lo + s_n[w] : 0;
  // The block sweeps the union of its warps' ranges.
  int blo = 0x7fffffff, bhi = 0;
  for (int v = 0; v < kWarps; ++v) {
    const long long wv = (long long)blockIdx.x * kWarps + v;
    if (wv * kWarp < Ep && s_n[wv] > 0) {
      blo = min(blo, s_lo[wv]);
      bhi = max(bhi, s_lo[wv] + s_n[wv]);
    }
  }
  const int s_first = blo < bhi ? blo & ~3 : 0;   // 16-byte aligned copies
  const int n_sc = blo < bhi ? (bhi - s_first + kNS - 1) / kNS : 0;
  if (n_sc == 0) {   // no samples in the block's ranges: zero records
    if (real)
      for (int f = 0; f < NROWS + C; ++f) out[col * nout + f] = 0.0f;
    return;
  }

  const float tile = real ? geom[col] : -1.0f;
  float mu[D], con[TRI];
#pragma unroll
  for (int d = 0; d < D; ++d) mu[d] = geom[(1 + d) * Ep + col];
#pragma unroll
  for (int u = 0; u < TRI; ++u) con[u] = geom[(1 + D + u) * Ep + col];

  // Accumulator fragments of M_S0 [m16 tile][n8 tile]; the lane's own
  // M_W_l [l][m], M_hl and M_Y rows.
  // Under HMM the lane's M_W, M_hl and M_Y rows live in its column of
  // sw.acc (the h block's registers made the widest instantiations spill).
  float cS[2][NT][4], mw_r[HMM ? 1 : D][MP], hl_r[HMM ? 1 : TRI],
      Ysum_r[HMM ? 1 : TRI];
  auto mw = [&](int l, int m) -> float& {
    return HMM ? sw.acc[l * MP + m][lane] : mw_r[HMM ? 0 : l][m];
  };
  auto hl = [&](int u) -> float& {
    return HMM ? sw.acc[D * MP + u][lane] : hl_r[HMM ? 0 : u];
  };
  auto Ysum = [&](int u) -> float& {
    return HMM ? sw.acc[D * MP + TRI + u][lane] : Ysum_r[HMM ? 0 : u];
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
  __syncthreads();

  // M_S0 of the warp's entries += its A block (G S0, split once as read)
  // x the chunk's monomials (B fragments of buffer `buf`), 3 passes.
  auto contract = [&](int buf) {
#pragma unroll 1
    for (int ks = 0; ks < kNS / 8; ++ks) {
      float b_hi[NT][2], b_lo[NT][2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float4 b = sh.bfrag[buf][(ks * NT + nt) * kWarp + lane];
        b_hi[nt][0] = b.x;
        b_hi[nt][1] = b.y;
        b_lo[nt][0] = b.z;
        b_lo[nt][1] = b.w;
      }
      float a_hi[2][4], a_lo[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          dgs::tf32_split(sw.v[8 * ks + t + 4 * (r / 2)][16 * mt + g +
                                                        8 * (r % 2)],
                          a_hi[mt][r], a_lo[mt][r]);
      // pass-major: consecutive mma.sync write different tiles
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          dgs::mma_tf32(cS[mt][nt], a_lo[mt], b_hi[nt]);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          dgs::mma_tf32(cS[mt][nt], a_hi[mt], b_lo[nt]);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          dgs::mma_tf32(cS[mt][nt], a_hi[mt], b_hi[nt]);
    }
  };

  for (int c0 = 0; c0 < C; c0 += CB) {
    float v[CB], dv[CB];
#pragma unroll
    for (int c = 0; c < CB; ++c) {
      v[c] = (c0 + c < C) ? geom[(1 + D + TRI + c0 + c) * Ep + col] : 0.0f;
      dv[c] = 0.0f;
    }

    // cp.async of chunk sc's rows into raw[buf]: mono rows 0 .. MR, then
    // ct's row of each (component, channel) of the pass, zeros past
    // channel C or past Np.
    auto stage = [&](int sc, int buf) {
      const long long s0 = s_first + (long long)sc * kNS;
      // Kept rolled: unrolled, its addresses made instantiations spill.
#pragma unroll 1
      for (int i = tid; i < (MR + 1 + K * CB) * (kNS / 4); i += kThreads) {
        const int r = i / (kNS / 4), c4 = i % (kNS / 4);
        const long long s = s0 + 4 * c4;
        const float* src = mono;
        bool ok = s < Np;
        if (r <= MR) {
          src = mono + r * Np + s;
        } else {
          const int kc = r - MR - 1, c = kc % CB;
          ok = ok && c0 + c < C;
          src = ct + (dgs::packed_component<D, MASK>(kc / CB, rows) * C +
                      c0 + c) * Np + s;
        }
        dgs::cp_async16(&sh.raw[buf][r][4 * c4], ok ? src : mono, ok);
      }
      dgs::cp_async_commit();
    };

    // Chunk sc's rows (landed in raw[buf]) into its records rec[buf] and
    // its monomials' B fragments bfrag[buf], split once for the block:
    // fragment (k8 step, n8 tile, lane) holds monomial 8 nt + g of samples
    // 8 ks + t and + 4.
    auto prepare = [&](int buf) {
      const float(*rw)[kNS] = sh.raw[buf];
      for (int i = tid; i < NV * kNS; i += kThreads) {
        const int v = i / kNS, j = i % kNS;
        float f[4];
        if (v == 0) {
          f[0] = rw[MR][j];
#pragma unroll
          for (int d = 0; d < 3; ++d) f[1 + d] = d < D ? rw[1 + d][j] : 0.0f;
        } else {
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int kc = 4 * (v - 1) + u;
            f[u] = kc < K * CB ? rw[MR + 1 + kc][j] : 0.0f;
          }
        }
        sh.rec[buf][i] = make_float4(f[0], f[1], f[2], f[3]);
      }
      for (int i = tid; i < kNS / 8 * NT * kWarp; i += kThreads) {
        const int L = i % kWarp, ntk = i / kWarp, nt = ntk % NT,
                  ks = ntk / NT;
        const int m = 8 * nt + L / 4, n = 8 * ks + L % 4;
        float x0 = 0.0f, x1 = 0.0f;
        if (m < MR) {
          x0 = rw[m][n];
          x1 = rw[m][n + 4];
        }
        float h0, l0, h1, l1;
        dgs::tf32_split(x0, h0, l0);
        dgs::tf32_split(x1, h1, l1);
        sh.bfrag[buf][i] = make_float4(h0, h1, l0, l1);
      }
    };

    // One barrier a chunk: the rows land two chunks ahead, the records
    // and fragments are prepared one chunk ahead by the whole block.
    if (n_sc > 0) stage(0, 0);
    if (n_sc > 1) stage(1, 1);
    dgs::cp_async_wait_all();
    __syncthreads();
    if (n_sc > 0) prepare(0);
    for (int sc = 0; sc < n_sc; ++sc) {
      dgs::cp_async_wait_all();
      __syncthreads();   // chunk sc + 1 landed; chunk sc is prepared
      if (sc + 2 < n_sc) stage(sc + 2, sc & 1);
      if (sc + 1 < n_sc) prepare((sc + 1) & 1);
      const long long s0 = s_first + (long long)sc * kNS;
      // The warp's samples in the chunk: j_lo .. j_hi - 1.
      const int j_lo = (int)max(0LL, lo - s0);
      const int j_hi = (int)min((long long)kNS, hi - s0);
      if (j_lo >= j_hi) continue;
      const float4* rec4 = sh.rec[sc & 1];
      // Records read through their 32-bit shared address, in program order
      // (tiled_layout.cuh staged_vector): nothing hoisted.
      const dgs::StagedBase rb = dgs::staged_base(rec4);
      const float* rec = reinterpret_cast<const float*>(rec4);

      for (int ks = 0; ks < kNS / 8; ++ks) {
        if (HMM) {
          // The values' fragments are reloaded for each block of 8 samples
          // (from L1): held across the sweep they made the widest
          // instantiations spill.
          float va_hi[2][4], va_lo[2][4];
          dgs::h_matmul_values<CB>(geom, Ep, 1 + D + TRI, C, c0, col - lane,
                                   three, va_hi, va_lo);
          dgs::h_matmul_block<K, CB>(rec, 8 * ks, va_hi, va_lo, three, sw.h);
          __syncwarp();
        }
#pragma unroll 1
        for (int jj = 0; jj < 8; ++jj) {
          const int j = 8 * ks + jj;
          float gs = 0.0f;
          const float4 head = dgs::staged_vector(rb, 0, j);
          if (j >= j_lo && j < j_hi && head.x == tile) {
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
              const float4 c4 = dgs::staged_vector(rb, 1 + gv, j);
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
            const HBlock hb{sw.h + jj * dgs::kHStride + lane};
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
          sw.v[j][lane] = gs;
        }
        if (HMM) __syncwarp();   // the h block is consumed
      }
      __syncwarp();   // the A block is written
      contract(sc & 1);
      __syncwarp();   // the A block is consumed
    }

    if (real) {
      float* rec = out + col * nout;
#pragma unroll
      for (int c = 0; c < CB; ++c)
        if (c0 + c < C) rec[NROWS + c0 + c] = dv[c];
    }
    __syncthreads();   // the rows, records and fragments are free again
  }

  if (!real) return;
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
  constexpr size_t bytes = sizeof(Shared<D, MASK, CB, HMM>);
  static_assert(bytes <= 227 * 1024, "above the shared memory of an SM");
  auto* kernel = tiled_backward_moments_kernel<D, MASK, CB, HMM>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
  }
  constexpr int W = warps_of(D);
  kernel<<<(n_ranges + W - 1) / W, W * kWarp, bytes, stream>>>(
      geom, Ep, C, mono, Np, ct, s_lo, s_n, rows, three, out);
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
  if ((long long)n_ranges * kWarp != Ep || C < 1 || Np % 4 != 0 ||
      (size_t)mono % 16 != 0 || (size_t)ct % 16 != 0)
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

// sizeof(Shared) of the instantiation (D, mask, CB, HMM): a launch's
// dynamic shared bytes.
template <int D, int CB, bool HMM>
int shared_bytes(int mask) {
  switch (mask) {
#define DGS_CASE(M) \
  case M:           \
    return (int)sizeof(Shared<D, M, CB, HMM>);
    DGS_CASE(1) DGS_CASE(2) DGS_CASE(3) DGS_CASE(4) DGS_CASE(5)
    DGS_CASE(6) DGS_CASE(7) DGS_CASE(8) DGS_CASE(9) DGS_CASE(10)
    DGS_CASE(11) DGS_CASE(12) DGS_CASE(13) DGS_CASE(14) DGS_CASE(15)
#undef DGS_CASE
    default:
      return 0;
  }
}

}  // namespace

extern "C" {

// Threads a block at D, and the dynamic shared bytes of a launch at (D,
// mask, C, h_matmul), for the smoke test's facts.
int dgs_tiled_backward_moments_block(int D) { return warps_of(D) * kWarp; }

int dgs_tiled_backward_moments_smem(int D, int mask, int C, int hmm) {
  const int cb = (D == 2 && C <= 2) ? C : 4;
  if (D == 1) return hmm ? shared_bytes<1, 4, true>(mask)
                         : shared_bytes<1, 4, false>(mask);
  if (D == 3) return hmm ? shared_bytes<3, 4, true>(mask)
                         : shared_bytes<3, 4, false>(mask);
  if (D != 2) return 0;
  if (cb == 1) return hmm ? shared_bytes<2, 1, true>(mask)
                          : shared_bytes<2, 1, false>(mask);
  if (cb == 2) return hmm ? shared_bytes<2, 2, true>(mask)
                          : shared_bytes<2, 2, false>(mask);
  return hmm ? shared_bytes<2, 4, true>(mask)
             : shared_bytes<2, 4, false>(mask);
}

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
// order.  Ranges are the classic backward's (32 entries).  mono and ct are
// 16-byte aligned with Np a multiple of 4 (the copies are 16 bytes).
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
