// The fully folded VJP under the folded forward, for Hopper (sm_90a): the
// fused VJP's contractions on the tensor cores, no h chain.
//
// Replaces the TPU kernel dgs_tpu/kernels/tiled.py::tiled_backward
// (_wl_backward_kernel) in its folded-VJP branch, _compute_one_fvjp
// (dgs_tpu/kernels/tiled.py:932-1046).  For every tile-sorted entry e,
// with the beta-expanded cotangent cb (R rows (k, m, c): ct[k, c] *
// monomial m, kernels/tiled.py ct_beta_rows), the folded rows fold and
// foldw_l of the entries, and G of each same-tile pair (X = mu_l - x_l,
// a = C X, wrap-free):
//
//   Zd[r, e]   = sum_n cb[r, n] G[n, e]
//   S0[n, e]   = sum_r cb[r, n] fold[r, e],   W_l[n, e] = sum_r cb[r, n] foldw_l[r, e]
//   dvalues_c  = sum_i alpha_i Zd[i * C + c]           (alpha: geom rows)
//   dmu_d     += G ((C W)_d - a_d S0),   z = W - X S0 / 2,
//   dconic_uv += G (X_v z_u + X_u z_v)   (u == v: G X_u z_u),
//
// each pair combined once.  The laplacian and third-order conic
// corrections are per-entry combinations of Zd rows: the kernel writes
// vz_i = sum_c values_c Zd[i * C + c] for the groups i that ``sel`` names,
// and kernels/tiled.py fvjp_combine adds them in torch, as moment_combine
// does.  Output (Ep, D + tri + C + nsel), entry-major: [dmu, dconic
// (without those corrections), dvalues, vz].
//
// What bounds it.  (2 + D) R TF32 multiply-adds a pair a pass
// (4,380 at D = 3, R = 292, 3 passes) against about 50 fp32 operations for
// G and the combine: the tensor cores, if their operands come from shared
// memory.  The operands are large: cb is R floats a sample, fold and foldw
// (1 + D) R floats an entry, so a block's pairs must reuse them.
//
// Design.  A block of 8 warps owns 32 consecutive sorted entries (one range
// of the classic backward, the N side of every contraction) and sweeps
// their sample range 128 samples at a time; for each chunk of samples it
// sweeps R 32 rows at a time.  Per (sample chunk, R-chunk) step:
//   - cp.async (16-byte copies, cp_async.cuh) stages the next step's cb
//     block (32 rows x 128 samples), its fold / foldw block (1 + D of 32
//     rows x 32 entries) and, at a new chunk, the samples' [x_l, tile],
//     double-buffered, swizzled so that the fragment reads are free of bank
//     conflicts: the copy runs under the current step's contractions;
//   - fold / foldw are split into TF32 hi / lo once, into the B fragments'
//     order (each element feeds all 8 warps); cb is split as its fragments
//     are read;
//   - S0 and W_l: warp w holds 32 samples 32 (w / 2) .. + 31 against 16
//     entries 16 (w % 2) .. + 15 for every q (two m16 x two n8 tiles: 64
//     accumulators at D = 3; a cb fragment feeds 2 (1 + D) tiles, an F
//     fragment two) and adds the step's 32 rows (mma.sync m16n8k8, 3 TF32
//     passes, or 1 under fast-math, issued pass-major so that consecutive
//     mma.sync write different accumulators); after the chunk's last
//     R-chunk S0 and W are complete, and each lane combines its 16 pairs
//     once from its registers (G from the chunk's G block, X and a
//     recomputed), then the 8 lanes of a t sum their samples by a fixed
//     butterfly (36 shuffles);
//   - Zd: warp w adds rows 16 (w / 4) .. + 15 of the step against the 32
//     entries over a quarter of the chunk's samples, 32 (w % 4) .. + 31
//     (one cb fragment feeds four n8 tiles); the four quarters' partial
//     tiles meet in shared memory and are added, in order, to the window
//     of R rows the block holds there.
// G of a chunk's 128 x 32 pairs is computed once (pair_math.cuh's fp32
// math; 0 off the entry's tile, outside the range, or where the quadratic
// form is positive), kept in fp32 for the combine and split once into the
// Zd B fragments.  The Zd window holds what shared memory leaves (about 400
// rows at D = 3): R = 292 (D = 3) and R = 100 (D = 2) take one pass, G
// once a pair; taller R sweeps the samples again for each further window
// of Zd rows (G once a pass, S0 / W only in the first).  After a pass each
// thread adds its entry's Zd column into its value rows (times alpha) and
// vz rows (times the values), rows in ascending order; at the end the four
// sample quarters' dmu / dconic rows of each entry are summed in order.
// Every sum runs in a fixed order (chunks, R rows, warps): no atomics,
// bitwise repeatable.  wgmma would need 64-row warpgroup tiles and a host
// model of its shared-memory descriptors for the CPU tests; mma.sync from
// shared memory keeps tf32_mma.cuh's fragments, which the tests emulate.
//
// Measured (chip_smoke.py's folded_slice on an H100 80GB HBM3 at 700 W):
// one TF32 pass takes about three quarters of the three-pass time, so the
// contraction is not what bounds the kernel: one block of 8 warps an SM
// (about 220 KB of shared memory, 215 registers), two barriers a step, and
// the fragments' shared-memory loads and splits are.
//
// Build: with the other sources into libdgs_kernels.so
// (dgs_tpu_torch/kernels/_build.py).  Never with --use_fast_math.
#include "cp_async.cuh"
#include "tiled_backward.cuh"

namespace {

using dgs::kWarp;

constexpr int kWarps = 8;                     // warps a block
constexpr int kThreads = kWarps * kWarp;
constexpr int kNE = kWarp;                    // entries a block: one range
constexpr int kNS = 128;                      // samples a chunk
constexpr int kRC = 32;                       // rows an R-chunk
constexpr int kGStride = kNE + 8;             // G rows [sample][entry]
constexpr int kGFrag = (kNS / 8) * 4 * kWarp * 4;   // Zd's B fragments
constexpr int kPStride = kNE + 8;             // partial Zd rows [row][entry]

// One stage: cb (kRC x kNS), fold / foldw ((1 + D) x kRC x kNE), the
// samples' [x_l, tile] ((D + 1) x kNS).
DGS_HD constexpr int stage_floats(int D) {
  return kRC * kNS + (1 + D) * kRC * kNE + (D + 1) * kNS;
}

// fold / foldw as B fragments: (1 + D) x (kRC / 8) k8 steps x 4 n8 tiles x
// 32 lanes x {hi, hi, lo, lo}.
DGS_HD constexpr int ffrag_floats(int D) {
  return (1 + D) * (kRC / 8) * 4 * kWarp * 4;
}

// Everything but the Zd window: two stages, the F and G fragments, G in
// fp32, the chunk's x_l, the entries' [mu_l, conic], the value and vz rows,
// the warps' partial Zd tiles, the vz slots' groups (ints, rounded to 4).
DGS_HD constexpr int fixed_floats(int D, int C, int nsel) {
  return 2 * stage_floats(D) + ffrag_floats(D) + kGFrag + kNS * kGStride +
         D * kNS + (D + dgs::tri_size(D)) * kNE + (C + nsel) * kNE +
         kWarps * 16 * kPStride + (nsel + 3) / 4 * 4;
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1) tiled_backward_fvjp_kernel(
    const float* __restrict__ geom,  // (1 + D + tri + C + A, Ep) folded geom
    long long Ep, int C,
    const float* __restrict__ fold,  // (Rp, Ep)
    const float* __restrict__ foldw, // (D * Rp, Ep)
    const float* __restrict__ cb,    // (Rp, Np)
    int Rp, int R,
    const float* __restrict__ smp,   // (D + 1, Np): x_l, tile
    long long Np,
    const int* __restrict__ s_lo, const int* __restrict__ s_n,
    const int* __restrict__ sel,     // (A,) vz slot of each group, or -1
    int nsel, int zrows, bool three, float* __restrict__ out) {
  constexpr int TRI = dgs::tri_size(D);
  constexpr int NQ = 1 + D;                   // S0, W_1..W_D
  constexpr int NV = D + TRI;                 // dmu, dconic rows
  extern __shared__ float s_dt[];
  const int sf = stage_floats(D);
  float* ffrag = s_dt + 2 * sf;
  float* gfrag = ffrag + ffrag_floats(D);
  float* g32 = gfrag + kGFrag;                // [sample][entry]
  float* xs = g32 + kNS * kGStride;           // [l][sample]
  float* erec = xs + D * kNS;                 // [mu_l, conic][entry]
  float* vout = erec + NV * kNE;              // [value, vz row][entry]
  float* zpart = vout + (C + nsel) * kNE;     // [warp][row][entry]
  int* grp = reinterpret_cast<int*>(zpart + kWarps * 16 * kPStride);
  float* zd = zpart + kWarps * 16 * kPStride + (nsel + 3) / 4 * 4;
  const float4* ffrag4 = reinterpret_cast<const float4*>(ffrag);
  const float4* gfrag4 = reinterpret_cast<const float4*>(gfrag);
  const int tid = threadIdx.x, warp = tid / kWarp, lane = tid % kWarp;
  const int g = lane / 4, t = lane % 4;
  const long long e_base = (long long)blockIdx.x * kNE;
  const int lo = s_lo[blockIdx.x], hi = lo + s_n[blockIdx.x];
  const long long a0 = 1 + D + TRI + C;       // geom row of alpha_0

  for (int i = tid; i < NV * kNE; i += kThreads)
    erec[i] = geom[(1 + i / kNE) * Ep + e_base + i % kNE];
  for (int i = tid; i < (C + nsel) * kNE; i += kThreads) vout[i] = 0.0f;
  for (int i = tid; i < R / C; i += kThreads)
    if (sel[i] >= 0) grp[sel[i]] = i;
  for (int i = tid; i < zrows * kNE; i += kThreads) zd[i] = 0.0f;
  // The lane's entry in the G block: 8 (w % 4) + g.
  const int eg = 8 * (warp % 4) + g;
  // The thread's copy destinations in a stage (see `stage`): cb row w,
  // samples 4 lane .. + 3 (cdst); fold / foldw row tid / 8, entries
  // 4 (tid % 8) .. + 3 (fdst, fcol).
  const int cdst = warp * kNS + dgs::swz(warp, 4 * lane);
  const int fdst = tid / (kNE / 4) * kNE +
                   dgs::swz(tid / (kNE / 4), 4 * (tid % (kNE / 4)));
  const long long fcol = e_base + 4 * (tid % (kNE / 4));
  // The lane's fragment offsets in a stage (dgs::swz; the k8 step's part is
  // a constant of the unrolled loops): the F split reads rows t and t + 4
  // at entry eg (fsa, fsa + 4 kNE + fsb); S reads cb transposed, rows
  // 8 ks + t (+ 4), samples 32 (w / 2) + 16 mt + g (+ 8) (sa); Zd reads
  // rows 16 (w / 4) + g (+ 8) (zrow), samples 8 ks + t (+ 4), whose
  // swizzled column is (8 ks) ^ zcol + t.
  const int fsa = t * kNE + dgs::swz(t, eg);
  const int fsb = dgs::swz(t + 4, eg) - dgs::swz(t, eg);
  int sa[2][4], zrow[2], zcol[2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int q4 = 0; q4 < 4; ++q4) {
      const int r = t + 4 * (q4 / 2);
      sa[mt][q4] = r * kNS + dgs::swz(r, 32 * (warp / 2) + 16 * mt + g +
                                             8 * (q4 % 2));
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 16 * (warp / 4) + g + 8 * h;
    zrow[h] = r * kNS + t;
    zcol[h] = dgs::swz(r, 4 * h) & ~3;
  }
  const float etile = geom[e_base + eg];
  const int s_first = lo & ~3;                // 16-byte aligned copies
  const int n_sc = lo < hi ? (hi - s_first + kNS - 1) / kNS : 0;
  const int nrc = (Rp + kRC - 1) / kRC;       // R-chunks
  const int zc = zrows / kRC;                 // R-chunks of a Zd window
  float acc[NV];                              // one entry's rows, this warp
#pragma unroll
  for (int f = 0; f < NV; ++f) acc[f] = 0.0f;

  for (int p = 0; p * zrows < Rp; ++p) {
    const bool first = p == 0;                // S0 / W and the combine
    const int jr0 = first ? 0 : p * zc;
    const int njr = (first ? nrc : min(nrc, (p + 1) * zc)) - jr0;
    const int steps = n_sc * njr;

    // cp.async of step `step` into stage `buf`: cb's rows of the R-chunk
    // and columns of the sample chunk (thread tid: rows w + 8 k), fold /
    // foldw's rows of the R-chunk (first pass; every q), and at a new chunk
    // the samples' [x_l, tile] (warp w <= D: row w); zeros out of range.
    auto stage = [&](int step, int buf) {
      const int sc = step / njr, r0 = (jr0 + step % njr) * kRC;
      float* cbs = s_dt + buf * sf;
      float* fs = cbs + kRC * kNS;
      float* ss = fs + NQ * kRC * kNE;
      const long long s0 = s_first + (long long)sc * kNS + 4 * lane;
#pragma unroll
      for (int k = 0; k < kRC * (kNS / 4) / kThreads; ++k) {
        const int r = r0 + warp + kWarps * k;
        const bool ok = r < Rp && s0 < Np;
        dgs::cp_async16(cbs + cdst + kWarps * k * kNS,
                        cb + (ok ? (long long)r * Np + s0 : 0), ok);
      }
      if (first) {
        const int r = r0 + tid / (kNE / 4);
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          const float* F = q == 0 ? fold : foldw + (long long)(q - 1) * Rp * Ep;
          dgs::cp_async16(fs + q * kRC * kNE + fdst,
                          F + (r < Rp ? (long long)r * Ep + fcol : 0), r < Rp);
        }
      }
      if (step % njr == 0 && warp <= D)
        dgs::cp_async16(ss + warp * kNS + 4 * lane,
                        smp + (s0 < Np ? warp * Np + s0 : 0), s0 < Np);
      dgs::cp_async_commit();
    };

    // S0, W_l: the warp's 32 samples (two m16 tiles) x 16 entries (two n8)
    float s[NQ][2][2][4];
#pragma unroll
    for (int q = 0; q < NQ; ++q)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int r = 0; r < 4; ++r) s[q][mt][nt][r] = 0.0f;

    // The partial Zd tiles of the last step, added to the window's rows
    // pend .. + 31 (summed over the four sample quarters in order).
    int pend = -1;
    auto add_partials = [&]() {
      if (pend < 0) return;
#pragma unroll
      for (int k = 0; k < 2 * 16 * kNE / kThreads; ++k) {
        const int i = tid + kThreads * k, row = i / kNE;   // of 32
        const float* P = zpart + ((row / 16) * 64 + row % 16) * kPStride +
                         i % kNE;
        constexpr int W = 16 * kPStride;   // one warp's partial tile
        zd[pend * kNE + i] += (P[0] + P[W]) + (P[2 * W] + P[3 * W]);
      }
    };

    if (steps > 0) stage(0, 0);
    for (int step = 0; step < steps; ++step) {
      const int jj = step % njr, jr = jr0 + jj;
      dgs::cp_async_wait_all();
      __syncthreads();   // the step landed; the previous one is consumed
      if (step + 1 < steps) stage(step + 1, (step + 1) & 1);
      const float* cbs = s_dt + (step & 1) * sf;
      const float* fs = cbs + kRC * kNS;
      const float* ss = fs + NQ * kRC * kNE;

      if (first) {
        // fold / foldw into B fragments, split once: fragment i = tid + 256 k
        // is (q = k / 2, k8 step (w / 4 + 2 k) % 4, n8 tile w % 4, lane),
        // rows 8 ks + t (+ 4), entry 8 (w % 4) + g.
#pragma unroll
        for (int k = 0; k < 2 * NQ; ++k) {
          const int ks = (warp / 4 + 2 * k) % (kRC / 8);
          const float* row = fs + ((k / 2) * kRC + 8 * ks) * kNE + fsa;
          float h0, l0, h1, l1;
          dgs::tf32_split_rt(row[0], three, h0, l0);
          dgs::tf32_split_rt(row[4 * kNE + fsb], three, h1, l1);
          reinterpret_cast<float4*>(ffrag)[tid + kThreads * k] =
              make_float4(h0, h1, l0, l1);
        }
      }

      if (jj == 0) {
        // G of the chunk's pairs, once: warp w, entry eg, samples 8 ks + t
        // and + 4 for the k8 steps 8 (w / 4) .. + 7 (the Zd B fragments).
        const long long s0 = s_first + (long long)(step / njr) * kNS;
        float mu[D], con[TRI];
#pragma unroll
        for (int d = 0; d < D; ++d) mu[d] = erec[d * kNE + eg];
#pragma unroll
        for (int u = 0; u < TRI; ++u) con[u] = erec[(D + u) * kNE + eg];
        for (int kk = 0; kk < 8; ++kk) {
          const int ks = 8 * (warp / 4) + kk;
          float hi_[2], lo_[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int n = 8 * ks + t + 4 * h;
            const long long sn = s0 + n;
            float G = 0.0f;
            if (sn >= lo && sn < hi && ss[D * kNS + n] == etile) {
              float X[D], a[D];
#pragma unroll
              for (int d = 0; d < D; ++d) X[d] = mu[d] - ss[d * kNS + n];
              G = dgs::pair_gauss<D>(X, con, a);
            }
            if (first) g32[n * kGStride + eg] = G;
            dgs::tf32_split_rt(G, three, hi_[h], lo_[h]);
          }
          reinterpret_cast<float4*>(gfrag)[(ks * 4 + warp % 4) * kWarp +
                                           lane] =
              make_float4(hi_[0], hi_[1], lo_[0], lo_[1]);
        }
        if (first)
          for (int i = tid; i < D * kNS; i += kThreads) xs[i] = ss[i];
      }
      add_partials();
      __syncthreads();

      if (first) {
        // S0 / W_l of the warp's 32 samples 32 (w / 2) .. + 31 (A: cb read
        // transposed, at the lane's offsets sa) and 16 entries
        // 16 (w % 2) .. + 15 (B: the F fragments), depth the step's 32 rows.
#pragma unroll
        for (int ks = 0; ks < kRC / 8; ++ks) {
          float a_hi[2][4], a_lo[2][4], b_hi[NQ][2][2], b_lo[NQ][2][2];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int q4 = 0; q4 < 4; ++q4)
              dgs::tf32_split_rt(cbs[sa[mt][q4] + 8 * ks * kNS], three,
                                 a_hi[mt][q4], a_lo[mt][q4]);
#pragma unroll
          for (int q = 0; q < NQ; ++q)
#pragma unroll
            for (int nt = 0; nt < 2; ++nt) {
              const float4 b = ffrag4[((q * (kRC / 8) + ks) * 4 +
                                       2 * (warp % 2) + nt) * kWarp + lane];
              b_hi[q][nt][0] = b.x;
              b_hi[q][nt][1] = b.y;
              b_lo[q][nt][0] = b.z;
              b_lo[q][nt][1] = b.w;
            }
          // Pass-major: lo * hi and hi * lo of every tile, then hi * hi, so
          // that consecutive mma.sync write different accumulators (a
          // tile's own sum keeps mma_passes' order).
          if (three) {
#pragma unroll
            for (int q = 0; q < NQ; ++q)
#pragma unroll
              for (int mt = 0; mt < 2; ++mt)
#pragma unroll
                for (int nt = 0; nt < 2; ++nt)
                  dgs::mma_tf32(s[q][mt][nt], a_lo[mt], b_hi[q][nt]);
#pragma unroll
            for (int q = 0; q < NQ; ++q)
#pragma unroll
              for (int mt = 0; mt < 2; ++mt)
#pragma unroll
                for (int nt = 0; nt < 2; ++nt)
                  dgs::mma_tf32(s[q][mt][nt], a_hi[mt], b_lo[q][nt]);
          }
#pragma unroll
          for (int q = 0; q < NQ; ++q)
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
#pragma unroll
              for (int nt = 0; nt < 2; ++nt)
                dgs::mma_tf32(s[q][mt][nt], a_hi[mt], b_hi[q][nt]);
        }
      }

      if (jr >= p * zc && jr < (p + 1) * zc) {
        // Zd rows 16 (w / 4) .. + 15 of the step against the 32 entries (A:
        // cb, B: the G fragments), depth the chunk's samples 32 (w % 4) ..
        // + 31; the four warps of a row tile leave their partial tiles in
        // zpart, which the next step (or the pass's end) adds to the window
        // in warp order.
        float c[4][4] = {};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int ks = 4 * (warp % 4) + u;
          float a_hi[4], a_lo[4], b_hi[4][2], b_lo[4][2];
#pragma unroll
          for (int q4 = 0; q4 < 4; ++q4)
            dgs::tf32_split_rt(cbs[zrow[q4 % 2] + ((8 * ks) ^ zcol[q4 / 2])],
                               three, a_hi[q4], a_lo[q4]);
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const float4 b = gfrag4[(ks * 4 + nt) * kWarp + lane];
            b_hi[nt][0] = b.x;
            b_hi[nt][1] = b.y;
            b_lo[nt][0] = b.z;
            b_lo[nt][1] = b.w;
          }
          if (three) {
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) dgs::mma_tf32(c[nt], a_lo, b_hi[nt]);
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) dgs::mma_tf32(c[nt], a_hi, b_lo[nt]);
          }
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) dgs::mma_tf32(c[nt], a_hi, b_hi[nt]);
        }
        float* z = zpart + (warp * 16 + g) * kPStride + 2 * t;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          *reinterpret_cast<float2*>(z + 8 * nt) = make_float2(c[nt][0],
                                                               c[nt][1]);
          *reinterpret_cast<float2*>(z + 8 * kPStride + 8 * nt) =
              make_float2(c[nt][2], c[nt][3]);
        }
        pend = (jr - p * zc) * kRC;
      } else {
        pend = -1;
      }

      if (first && jj == njr - 1) {
        // The chunk's S0 and W are complete: combine each of the lane's 16
        // pairs (samples 32 (w / 2) + 16 mt + g, + 8; entries
        // 16 (w % 2) + 8 nt + 2 t, + 1) once, summed over its samples.
        float v[4][NV];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int b = 0; b < 2; ++b) {
            const int e = 16 * (warp % 2) + 8 * nt + 2 * t + b;
            float mu[D], con[TRI];
#pragma unroll
            for (int d = 0; d < D; ++d) mu[d] = erec[d * kNE + e];
#pragma unroll
            for (int u = 0; u < TRI; ++u) con[u] = erec[(D + u) * kNE + e];
#pragma unroll
            for (int f = 0; f < NV; ++f) v[2 * nt + b][f] = 0.0f;
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
#pragma unroll
              for (int hh = 0; hh < 2; ++hh) {
                const int n = 32 * (warp / 2) + 16 * mt + g + 8 * hh;
                const float G = g32[n * kGStride + e];
                float X[D], a[D], W[D], zz[D];
#pragma unroll
                for (int d = 0; d < D; ++d) X[d] = mu[d] - xs[d * kNS + n];
                dgs::pair_form<D>(X, con, a);
                const float S0 = s[0][mt][nt][2 * hh + b];
#pragma unroll
                for (int l = 0; l < D; ++l)
                  W[l] = s[1 + l][mt][nt][2 * hh + b];
                const float half = 0.5f * S0;
#pragma unroll
                for (int d = 0; d < D; ++d) {
                  float cw = con[dgs::tri_index(D, d, 0)] * W[0];
#pragma unroll
                  for (int l = 1; l < D; ++l)
                    cw += con[dgs::tri_index(D, d, l)] * W[l];
                  v[2 * nt + b][d] += G * (cw - a[d] * S0);
                  zz[d] = W[d] - X[d] * half;
                }
#pragma unroll
                for (int u = 0; u < D; ++u)
#pragma unroll
                  for (int w = u; w < D; ++w)
                    v[2 * nt + b][D + dgs::tri_index(D, u, w)] +=
                        u == w ? G * (X[u] * zz[u])
                               : G * (X[w] * zz[u] + X[u] * zz[w]);
              }
          }
        // Sum over the 8 lanes of a t (the warp's other samples) by a fixed
        // butterfly: the lanes keep half the entries at g's bit 2, half
        // again at bit 1, then add at bit 0 (a + b == b + a: both agree);
        // lane (g, t) is left with entry group g / 2.
#pragma unroll
        for (int k = 2; k >= 1; --k) {
          const bool up = (g >> k) & 1;
#pragma unroll
          for (int i = 0; i < (1 << (k - 1)); ++i)
#pragma unroll
            for (int f = 0; f < NV; ++f) {
              const int j = i + (1 << (k - 1));
              const float send = up ? v[i][f] : v[j][f];
              const float keep = up ? v[j][f] : v[i][f];
              v[i][f] = keep + __shfl_xor_sync(0xffffffffu, send, 4 << k);
            }
        }
#pragma unroll
        for (int f = 0; f < NV; ++f)
          acc[f] += v[0][f] + __shfl_xor_sync(0xffffffffu, v[0][f], 4);
#pragma unroll
        for (int q = 0; q < NQ; ++q)
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int nt = 0; nt < 2; ++nt)
#pragma unroll
              for (int r = 0; r < 4; ++r) s[q][mt][nt][r] = 0.0f;
      }
    }

    __syncthreads();
    add_partials();
    // The window's Zd rows: thread (entry e, part) adds its entry's column
    // into the value rows (times alpha) and vz rows (times the values) of
    // its part, rows in ascending order.
    __syncthreads();
    {
      const int e = tid % kNE, part = tid / kNE;
      const int r_lo = p * zrows, r_hi = min(R, (p + 1) * zrows);
      for (int o = part; o < C + nsel; o += kWarps) {
        float sum = vout[o * kNE + e];
        if (o < C) {
          for (int i = (max(r_lo - o, 0) + C - 1) / C; i * C + o < r_hi; ++i)
            sum = fmaf(geom[(a0 + i) * Ep + e_base + e],
                       zd[(i * C + o - r_lo) * kNE + e], sum);
        } else {
          const int i = grp[o - C];
          for (int c = 0; c < C; ++c) {
            const int r = i * C + c;
            if (r >= r_lo && r < r_hi)
              sum = fmaf(geom[(1 + D + TRI + c) * Ep + e_base + e],
                         zd[(r - r_lo) * kNE + e], sum);
          }
        }
        vout[o * kNE + e] = sum;
      }
    }
    __syncthreads();
    if ((p + 1) * zrows < Rp) {
      for (int i = tid; i < zrows * kNE; i += kThreads) zd[i] = 0.0f;
      __syncthreads();
    }
  }

  // The four sample quarters' dmu / dconic rows of each entry, summed in
  // order.
  float* red = gfrag;                         // [quarter][entry][row]
  if (g % 2 == 0) {
    const int el = 16 * (warp % 2) + 8 * (g / 4) + 2 * t + (g / 2) % 2;
#pragma unroll
    for (int f = 0; f < NV; ++f)
      red[((warp / 2) * kNE + el) * NV + f] = acc[f];
  }
  __syncthreads();
  const int nout = NV + C + nsel;
  for (int i = tid; i < kNE * nout; i += kThreads) {
    const int e = i / nout, f = i % nout;
    float v = 0.0f;
    if (f < NV) {
      for (int q = 0; q < 4; ++q) v += red[(q * kNE + e) * NV + f];
    } else {
      v = vout[(f - NV) * kNE + e];
    }
    out[(e_base + e) * nout + f] = v;
  }
}

// The Zd window's rows for (D, C, nsel): every row of Rp if they fit in
// the 227 KB a block may use, else the most that fit (whole R-chunks); 0 if
// not even one R-chunk fits.
int zd_rows(int D, int Rp, int C, int nsel) {
  const int budget = 227 * 1024 / 4 - fixed_floats(D, C, nsel);
  const int most = budget < 0 ? 0 : budget / (kNE * kRC) * kRC;
  const int all = (Rp + kRC - 1) / kRC * kRC;
  return all < most ? all : most;
}

template <int D>
cudaError_t launch(const float* geom, long long Ep, int C, const float* fold,
                   const float* foldw, const float* cb, int Rp, int R,
                   const float* smp, long long Np, const int* s_lo,
                   const int* s_n, int n_ranges, const int* sel, int nsel,
                   bool three, float* out, cudaStream_t stream) {
  const int zrows = zd_rows(D, Rp, C, nsel);
  if (zrows < kRC) return cudaErrorInvalidValue;
  const size_t bytes =
      sizeof(float) * (fixed_floats(D, C, nsel) + zrows * kNE);
  auto* kernel = tiled_backward_fvjp_kernel<D>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
  }
  kernel<<<n_ranges, kThreads, bytes, stream>>>(
      geom, Ep, C, fold, foldw, cb, Rp, R, smp, Np, s_lo, s_n, sel, nsel,
      zrows, three, out);
  return cudaGetLastError();
}


}  // namespace

extern "C" {

// Launches the folded-VJP kernel: `sel` (R / C,) gives each group's vz
// output slot or -1, `nsel` the slots; the output record of an entry is
// [dmu, dconic, dvalues, vz].  fold, foldw, cb and smp are 16-byte aligned
// with Ep and Np multiples of 4 (the copies are 16 bytes).
int dgs_tiled_backward_fvjp(const void* geom, int Ep, int C, const void* fold,
                            const void* foldw, const void* cb, int Rp, int R,
                            const void* smp, int Np, const void* s_lo,
                            const void* s_n, int n_ranges, int D,
                            const void* sel, int nsel, int passes, void* out,
                            void* stream) {
  if ((long long)n_ranges * kWarp != Ep || C < 1 || Rp % 16 != 0 ||
      R > Rp || nsel < 0 || Ep % 4 != 0 || Np % 4 != 0 ||
      (size_t)fold % 16 != 0 || (size_t)foldw % 16 != 0 ||
      (size_t)cb % 16 != 0 || (size_t)smp % 16 != 0 ||
      (passes != 1 && passes != 3))
    return (int)cudaErrorInvalidValue;
  const auto* g = static_cast<const float*>(geom);
  const auto* f = static_cast<const float*>(fold);
  const auto* fw = static_cast<const float*>(foldw);
  const auto* b = static_cast<const float*>(cb);
  const auto* s = static_cast<const float*>(smp);
  const auto* lo = static_cast<const int*>(s_lo);
  const auto* n = static_cast<const int*>(s_n);
  const auto* sl = static_cast<const int*>(sel);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const bool three = passes == 3;
  cudaError_t err = cudaErrorInvalidValue;
  if (D == 1)
    err = launch<1>(g, Ep, C, f, fw, b, Rp, R, s, Np, lo, n, n_ranges,
                          sl, nsel, three, o, st);
  else if (D == 2)
    err = launch<2>(g, Ep, C, f, fw, b, Rp, R, s, Np, lo, n, n_ranges,
                          sl, nsel, three, o, st);
  else if (D == 3)
    err = launch<3>(g, Ep, C, f, fw, b, Rp, R, s, Np, lo, n, n_ranges,
                          sl, nsel, three, o, st);
  return (int)err;
}

// Rows of the Zd window a launch holds (the samples are swept once a
// window), and its dynamic shared bytes; 0 where no launch is possible.
int dgs_tiled_backward_fvjp_window(int D, int Rp, int C, int nsel) {
  return zd_rows(D, Rp, C, nsel);
}

int dgs_tiled_backward_fvjp_smem(int D, int Rp, int C, int nsel) {
  const int zrows = zd_rows(D, Rp, C, nsel);
  return zrows >= kRC
             ? (int)sizeof(float) * (fixed_floats(D, C, nsel) + zrows * kNE)
             : 0;
}

}  // extern "C"
