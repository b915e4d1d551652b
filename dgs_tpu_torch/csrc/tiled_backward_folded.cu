// Tiled backward under the folded forward with folded_dvals, for Hopper
// (sm_90a): the folded dvalues, with their contraction on the tensor cores.
// The fully folded VJP is tiled_backward_fvjp.cu.
//
// Replaces the TPU kernel dgs_tpu/kernels/tiled.py::tiled_backward
// (_wl_backward_kernel) in its folded-dvalues branch (_compute_one under
// folded_dvals, dgs_tpu/kernels/tiled.py:1117-1145).  For every
// tile-sorted entry, with the beta-expanded cotangent cb (R rows (k, m, c):
// ct[k, c] * monomial m, kernels/tiled.py ct_beta_rows) and G of each
// same-tile pair (X = mu_l - x_l, wrap-free):
//
//   dmu, dconic  the classic per-pair VJP (pair_math.cuh pair_vjp, h_k =
//                sum_c ct[k, c] v_c, or under h_matmul a tensor-core
//                contraction over the channels), without value gradients;
//   Zd[r, e]   = sum_n cb[r, n] G[n, e]                (the tensor cores)
//   dvalues_c  = sum_i alpha_i Zd[i * C + c]           (alpha: geom rows)
//
// Output (Ep, D + tri + C), entry-major.
//
// What bounds it, as measured (chip_smoke.py's folded_slice, and
// chip_variants.py timing variants of this source beside it, on an H100
// 80GB HBM3 at 700 W; PERF.md): latency, not a unit's throughput.  Per pair
// the VJP's fp32 work (about 150 operations at D = 3, three orders) and R
// TF32 multiply-adds a pass (R = 292 there, 3 passes or 1 under fast-math)
// bound it at 4.7 ms; one TF32 pass saves an eighth of the time, and
// without its Zd contraction a block of 8 warps took two thirds of its
// time, without its VJP 94%: the rest is warps waiting on each other and
// on their dependent chains, at the 8-10 warps an SM that the registers
// allow (200-255 a thread; at 128, two blocks of 8 warps an SM, every
// instantiation spilled, and chip_smoke.py refuses a spilling kernel).
//
// Design.  A block of W warps owns 32 consecutive sorted entries (one range
// of the classic backward) and sweeps their sample range 32 samples at a
// time: W = 4 (two blocks an SM), or 2 where Rp <= 128 and h_matmul is off
// (R = 100 at D = 2: five blocks an SM; 4.96 ms at the D = 2 headline
// against 5.27 with blocks of 4 warps).  Per chunk, two barriers:
//   - cp.async (16-byte copies, cp_async.cuh) brings the chunk's rows of
//     smp and ct two chunks ahead, and the block transposes them one chunk
//     ahead into the samples' records ([tile, x_l], then ct[k, c] four
//     channels a vector: tiled_layout.cuh's backward records, read with
//     16-byte broadcast loads); it brings the chunk's cb rows of the pass
//     (swizzled with swz: conflict-free A fragment reads) under the VJP;
//   - each warp takes 32 / W samples with its lanes as the entries: G once
//     a pair (pair_math.cuh's fp32 math; 0 off the entry's tile or outside
//     the range), in the first pass also the pair's VJP into the lane's
//     mean and conic rows (h from the records and the entries' values, or
//     under h_matmul from the warp's h block), and G's TF32 split written
//     once into the Zd B fragments (a lane stores whole fragments);
//   - warp w adds Zd's m16 row tiles w, w + W, ... (5 of 4 warps: 320 rows
//     a pass; 4 of 2: 128) over the chunk's samples (mma.sync m16n8k8, A
//     from the staged cb split once, issued pass-major), its tiles brought
//     from a window of Zd rows in shared memory into registers for the
//     chunk and back, so that the VJP holds no Zd registers.
// R = 292 (D = 3) and R = 100 (D = 2) take one pass over the pairs; taller
// R sweeps the samples again a pass (G only).  After a pass each (channel,
// entry) thread adds its value row from the window (times alpha), rows in
// ascending order; at the end the warps' mean and conic rows of each entry
// are summed in warp order.  Every sum runs in a fixed order: no atomics,
// bitwise repeatable.
//
// Tried and dropped (D = 3 three orders / D = 2 headline ms, in the calls
// that timed them; the first version 51.4-52.4 / 5.82-5.93 in the same
// calls): one block of 8 warps an SM, Zd in registers: 47.5-51.6 /
// 5.8-6.4 (records gathered by 4-byte copies 47.5 / 6.1, 64-sample chunks
// 47.7-48.7 / 5.8-6.0), with the window 52.3 / 6.8; a one-barrier
// pipeline, warps w and w + 4 in opposite phase over three cb stages:
// 52.8 / 6.9; records by synchronous loads: 59.3 / 7.9; two blocks of 8
// warps an SM (128 registers): 33.0-35.7 / 3.9-4.5, spilling 4-132 bytes
// in every instantiation.
//
// Build: with the other sources into libdgs_kernels.so
// (dgs_tpu_torch/kernels/_build.py).  Never with --use_fast_math.
#include "cp_async.cuh"
#include "tiled_backward.cuh"

namespace {

using dgs::kWarp;
using dgs::OrderRows;

constexpr int kNE = kWarp;               // entries a block: one range
constexpr int kNS = 32;                  // samples a chunk
// The Zd m16 tiles a warp holds (tiles w, w + W, ...): 320 rows a pass
// with 4 warps, 128 with 2.
DGS_HD constexpr int tiles_of(int W) { return W == 4 ? 5 : 4; }
// Zd's B fragments: (kNS / 8) k8 steps x 4 n8 tiles x 32 lanes float4s,
// with a float4 of padding after every 8 (conflict-free single stores).
constexpr int kGFrag = 4 * ((kNS / 8) * 4 * kWarp * 9 / 8);

// Float4 index of the B fragment of (k8 step, n8 tile, lane).
DGS_HD int frag_index(int ks, int nt, int lane) {
  const int p = (ks * 4 + nt) * kWarp + lane;
  return p + (p >> 3);
}

// The region that holds the cb stage (a pass's rows x the chunk's
// samples, [row][sample], swizzled), and at the end the warps' mean and
// conic rows.
DGS_HD int big_floats(int zrows, int nv, int W) {
  return zrows * kNS > W * nv * kNE ? zrows * kNS : W * nv * kNE;
}

// Float offset of Zd's (row, entry) in the window, [row][entry]: the entry
// XOR 8 (row % 4), so that a fragment's float2 reads and writes are free of
// bank conflicts.
DGS_HD int zoff(int row, int e) { return row * kNE + (e ^ ((row & 3) << 3)); }

// The raw rows of a chunk as they land: smp's D + 1 rows, then ct's K C
// rows ([row][sample]), rounded to whole vectors.
DGS_HD int raw_rows(int D, int K, int C) { return (D + 1 + K * C + 3) / 4 * 4; }

// Everything else: the Zd window (zrows x 32 entries), two chunks' records
// (transposed from the raw rows: nvec float4s a sample, [vector][sample])
// and raw rows, the G fragments, the entries' values and value rows (four
// channels a vector), the h blocks under h_matmul, the records' raw rows
// (ints).
DGS_HD int fixed_floats(int D, int K, int C, bool hmm, int zrows) {
  constexpr int kWarps = 4, kSPW = kNS / kWarps;   // h_matmul: 4 warps
  const int np = (C + 3) / 4, nvec = 1 + np * K;
  return zrows * kNE + 2 * 4 * nvec * kNS + 2 * raw_rows(D, K, C) * kNS +
         kGFrag + 2 * 4 * np * kNE +
         (hmm ? kWarps * K * kSPW * dgs::kHStride : 0) + 4 * nvec;
}

DGS_HD int smem_floats(int D, int K, int C, bool hmm, int zrows, int W) {
  return big_floats(zrows, D + dgs::tri_size(D), W) +
         fixed_floats(D, K, C, hmm, zrows);
}

// Warps a block of a launch at (Rp, hmm): 2 where the Zd rows fit 128, else
// 4; 4 under h_matmul (its h blocks take at most 8 samples a warp).
inline int warps_of(int Rp, bool hmm) { return !hmm && Rp <= 128 ? 2 : 4; }

// Rows of Zd a pass holds: every row of Rp up to 384 while the 227 KB of a
// block allow, else the most that fit (whole m16 tiles); 0 if none.
int pass_rows(int D, int K, int C, int Rp, bool hmm) {
  const int W = warps_of(Rp, hmm), most = 16 * tiles_of(W) * W;
  int rows = Rp < most ? Rp : most;
  while (rows > 0 && smem_floats(D, K, C, hmm, rows, W) * 4 > 227 * 1024)
    rows -= 16;
  return rows;
}

template <int D, int MASK, bool HMM, int W>
__global__ void __launch_bounds__(W * kWarp, 1) tiled_backward_fdv_kernel(
    const float* __restrict__ geom,  // (1 + D + tri + C + A, Ep) folded geom
    long long Ep, int C,
    const float* __restrict__ smp,   // (D + 1, Np): x_l, tile
    long long Np,
    const float* __restrict__ ct,    // (K * C, Np) cotangent
    const float* __restrict__ cb,    // (Rp, Np) beta-expanded cotangent
    int Rp, int R,
    const int* __restrict__ s_lo, const int* __restrict__ s_n,
    OrderRows rows, int zrows, bool three,
    float* __restrict__ out) {
  constexpr int TRI = dgs::tri_size(D);
  constexpr int K = dgs::total_unique(D, MASK);
  constexpr int NV = D + TRI;                 // mean and conic rows
  constexpr int kWarps = W, kThreads = W * kWarp, MT = tiles_of(W);
  constexpr int kSPW = kNS / kWarps;          // samples a warp in the VJP
  const int np = (C + 3) / 4;                 // record vectors a component
  const int nvec = 1 + np * K;
  const int nraw = raw_rows(D, K, C);
  extern __shared__ float s_dt[];
  float* big = s_dt;
  float* zwin = big + big_floats(zrows, NV, W);   // Zd [row][entry] (zoff)
  float* recs = zwin + zrows * kNE;            // [chunk & 1][vector][sample]
  float* raws = recs + 2 * 4 * nvec * kNS;     // [chunk & 1][row][sample]
  float* gfrag = raws + 2 * nraw * kNS;
  float4* vals = reinterpret_cast<float4*>(gfrag + kGFrag);  // [vec][entry]
  float* vout = gfrag + kGFrag + 4 * np * kNE;               // [c][entry]
  float* hbw = vout + 4 * np * kNE +
               (HMM ? (threadIdx.x / kWarp) * K * kSPW * dgs::kHStride : 0);
  int* rrow = reinterpret_cast<int*>(
      vout + 4 * np * kNE + (HMM ? kWarps * K * kSPW * dgs::kHStride : 0));
  const float4* gfrag4 = reinterpret_cast<const float4*>(gfrag);
  const int tid = threadIdx.x, warp = tid / kWarp, lane = tid % kWarp;
  const int g = lane / 4, t = lane % 4;
  const int hg = ((g & 3) << 1) | ((g >> 2) & 1);   // swz's row term
  // The warp's samples u = 0 .. kSPW - 1 in a chunk: the B fragments'
  // row pairs (t', t' + 4) p = kSPW / 2 w + u / 2 (k8 step p / 4, t' =
  // p % 4), u % 2 the half, so that each lane stores whole fragments of its
  // entry.
  auto wj = [&](int u) {
    const int p = kSPW / 2 * warp + u / 2;
    return 8 * (p / 4) + p % 4 + 4 * (u % 2);
  };
  const long long e_base = (long long)blockIdx.x * kNE;
  const int lo = s_lo[blockIdx.x], hi = lo + s_n[blockIdx.x];
  const long long a0 = 1 + D + TRI + C;       // geom row of alpha_0
  if (lo >= hi) {   // no samples (sentinel and pad ranges): zero rows
    for (int i = tid; i < kNE * (NV + C); i += kThreads)
      out[e_base * (NV + C) + i] = 0.0f;
    return;
  }

  // The records' raw rows: float c of vector 0 is [tile, x_l] (smp's
  // rows D, 0 .. D - 1), of vector 1 + p K + k ct's row of component k,
  // channel 4 p + c (raw row D + 1 + that row); -1 where the float is zero.
  for (int i = tid; i < 4 * nvec; i += kThreads) {
    const int v = i / 4, c = i % 4;
    int r = -1;
    if (v == 0) {
      r = c == 0 ? D : (c <= D ? c - 1 : -1);
    } else {
      const int p = (v - 1) / K, k = (v - 1) % K;
      if (4 * p + c < C)
        r = D + 1 + dgs::packed_component<D, MASK>(k, rows) * C + 4 * p + c;
    }
    rrow[i] = r;
  }
  for (int i = tid; i < 4 * np * kNE; i += kThreads) {
    const int c = i / kNE, e = i % kNE;       // channel c, entry e
    reinterpret_cast<float*>(vals)[(c / 4 * kNE + e) * 4 + c % 4] =
        c < C ? geom[(1 + D + TRI + c) * Ep + e_base + e] : 0.0f;
    vout[i] = 0.0f;
  }
  const float tile = geom[e_base + lane];
  float mu[D], con[TRI], dmu[D], dcon[TRI];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    mu[d] = geom[(1 + d) * Ep + e_base + lane];
    dmu[d] = 0.0f;
  }
#pragma unroll
  for (int u = 0; u < TRI; ++u) {
    con[u] = geom[(1 + D + u) * Ep + e_base + lane];
    dcon[u] = 0.0f;
  }
  __syncthreads();

  const int s_first = lo & ~3;                // 16-byte aligned copies
  const int n_sc = lo < hi ? (hi - s_first + kNS - 1) / kNS : 0;
  // The thread's copies of a cb stage: rows cr0 + kRPS i, 16-byte chunk
  // cc4 (destination cdst + kRPS kNS i).
  constexpr int kCPR = kNS / 4, kRPS = kThreads / kCPR;
  const int cr0 = tid / kCPR, cc4 = tid % kCPR;
  const int cdst = cr0 * kNS + dgs::swz(cr0, 4 * cc4);

  for (int r_lo = 0; r_lo < Rp; r_lo += zrows) {
    const bool first = r_lo == 0;             // the mean and conic rows
    const int zr = min(zrows, Rp - r_lo);     // this pass's rows

    // cp.async of chunk sc's cb rows of the pass.
    auto stage_cb = [&](int sc) {
      const long long s = s_first + (long long)sc * kNS + 4 * cc4;
      const float* src = cb + (long long)(r_lo + cr0) * Np + (s < Np ? s : 0);
      float* dst = big + cdst;
      for (int r = cr0; r < zr; r += kRPS) {
        dgs::cp_async16(dst, src, s < Np);
        src += kRPS * Np;
        dst += kRPS * kNS;
      }
    };
    // cp.async of chunk sc's raw rows into raw[buf]: smp's rows, and in the
    // first pass ct's.
    auto stage_raw = [&](int sc, int buf) {
      const long long s0 = s_first + (long long)sc * kNS;
      const int n = (first ? D + 1 + K * C : D + 1) * kCPR;
      for (int i = tid; i < n; i += kThreads) {
        const int r = i / kCPR, c4 = i % kCPR;
        const long long s = s0 + 4 * c4;
        const float* src =
            r <= D ? smp + r * Np + s : ct + (r - D - 1) * Np + s;
        dgs::cp_async16(raws + (buf * nraw + r) * kNS + 4 * c4,
                        s < Np ? src : smp, s < Np);
      }
    };
    // Chunk (buf)'s records from its raw rows: vector 0 only after the
    // first pass.
    auto transpose = [&](int buf) {
      const float* rw = raws + buf * nraw * kNS;
      float4* rec = reinterpret_cast<float4*>(recs) + buf * nvec * kNS;
      for (int i = tid; i < (first ? nvec : 1) * kNS; i += kThreads) {
        const int v = i / kNS, j = i % kNS;
        float f[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int r = rrow[4 * v + u];
          f[u] = r >= 0 ? rw[r * kNS + j] : 0.0f;
        }
        rec[i] = make_float4(f[0], f[1], f[2], f[3]);
      }
    };

    // The raw rows land two chunks ahead and are transposed one chunk
    // ahead by the whole block; cb lands under the chunk's VJP (one stage:
    // the Zd window takes the shared memory a second would).
    for (int i = tid; i < zr * kNE; i += kThreads) zwin[i] = 0.0f;
    if (n_sc > 0) stage_raw(0, 0);
    if (n_sc > 1) stage_raw(1, 1);
    dgs::cp_async_commit();
    dgs::cp_async_wait_all();
    __syncthreads();
    if (n_sc > 0) transpose(0);
    for (int sc = 0; sc < n_sc; ++sc) {
      dgs::cp_async_wait_all();
      __syncthreads();   // chunk sc is transposed, sc + 1 landed; sc - 1 done
      stage_cb(sc);
      dgs::cp_async_commit();
      if (sc + 2 < n_sc) stage_raw(sc + 2, sc & 1);
      dgs::cp_async_commit();
      if (sc + 1 < n_sc) transpose((sc + 1) & 1);
      const float4* rec =
          reinterpret_cast<const float4*>(recs) + (sc & 1) * nvec * kNS;
      // The records and values are read through their 32-bit shared
      // addresses in program order (tiled_layout.cuh staged_vector):
      // nothing hoisted, fewer registers, more blocks an SM.
      const dgs::StagedBase rb = dgs::staged_base(rec);
      const dgs::StagedBase vb = dgs::staged_base(vals);
      const long long s0 = s_first + (long long)sc * kNS;

      if (HMM && first) {
        // h_k of the warp's samples wj(0 .. 3) and the 32 entries on the
        // tensor cores, channels in k8 steps of four (tf32_mma.cuh
        // h_matmul_values' fragments): entries M, samples N (columns 4-7
        // zero), into hbw[(k * kSPW + u) * kHStride + entry].
        for (int p = 0; p < np; ++p) {
          float va_hi[2][4], va_lo[2][4];
          dgs::h_matmul_values<4>(geom, Ep, 1 + D + TRI, C, 4 * p, e_base,
                                  three, va_hi, va_lo);
#pragma unroll 1
          for (int k = 0; k < K; ++k) {
            const float x =
                g < kSPW
                    ? reinterpret_cast<const float*>(
                          rec)[((1 + p * K + k) * kNS + wj(g)) * 4 + t]
                    : 0.0f;
            float b_hi[2], b_lo[2];
            dgs::tf32_split_rt(x, three, b_hi[0], b_lo[0]);
            b_hi[1] = b_lo[1] = 0.0f;
            float* h = hbw + k * kSPW * dgs::kHStride;
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
              float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
              dgs::mma_passes_rt(c, va_hi[mt], va_lo[mt], b_hi, b_lo, three);
              if (2 * t < kSPW) {
                float* h0 = h + 2 * t * dgs::kHStride + 16 * mt + g;
                float* h1 = h0 + dgs::kHStride;
                h0[0] = p ? h0[0] + c[0] : c[0];
                h1[0] = p ? h1[0] + c[1] : c[1];
                h0[8] = p ? h0[8] + c[2] : c[2];
                h1[8] = p ? h1[8] + c[3] : c[3];
              }
            }
          }
        }
        __syncwarp();
      }

      // G of the warp's samples (and in the first pass their VJP), split
      // into the B fragments (see wj): a fragment row pair's two halves,
      // stored once the second is done.
      float g0_hi = 0.0f, g0_lo = 0.0f;
#pragma unroll 1
      for (int u = 0; u < kSPW; ++u) {
        const int j = wj(u);
        const float4 hd = dgs::staged_vector(rb, 0, j);
        const long long s = s0 + j;
        float G = 0.0f;
        if (s >= lo && s < hi && hd.x == tile) {
          const float xs[3] = {hd.y, hd.z, hd.w};
          float X[D], a[D];
#pragma unroll
          for (int d = 0; d < D; ++d) X[d] = mu[d] - xs[d];
          G = dgs::pair_gauss<D>(X, con, a);
          if (first) {
            float q[TRI], w[K], h[K];
            dgs::pair_polys<D, MASK>(con, a, q);
            dgs::component_weights<D, MASK>(con, a, q, G, w);
            if (HMM) {
#pragma unroll
              for (int k = 0; k < K; ++k)
                h[k] = hbw[(k * kSPW + u) * dgs::kHStride + lane];
            } else {
#pragma unroll
              for (int k = 0; k < K; ++k) h[k] = 0.0f;
              for (int p = 0; p < np; ++p) {
                const float4 v = dgs::staged_vector(vb, p, lane);
#pragma unroll
                for (int k = 0; k < K; ++k) {
                  const float4 c4 = dgs::staged_vector(rb, 1 + p * K + k, j);
                  h[k] = fmaf(c4.x, v.x, h[k]);
                  h[k] = fmaf(c4.y, v.y, h[k]);
                  h[k] = fmaf(c4.z, v.z, h[k]);
                  h[k] = fmaf(c4.w, v.w, h[k]);
                }
              }
            }
            dgs::pair_vjp<D, MASK>(X, con, a, q, G, w, h, dmu, dcon);
          }
        }
        float g_hi, g_lo;
        dgs::tf32_split_rt(G, three, g_hi, g_lo);
        if (u % 2 == 0) {
          g0_hi = g_hi;
          g0_lo = g_lo;
        } else {
          const int p = kSPW / 2 * warp + u / 2;
          reinterpret_cast<float4*>(gfrag)[frag_index(
              p / 4, lane / 8, 4 * (lane % 8) + p % 4)] =
              make_float4(g0_hi, g_hi, g0_lo, g_lo);
        }
      }
      dgs::cp_async_wait_one();   // cb landed (the raw rows may not)
      __syncthreads();

      // Zd rows of the warp's m16 tiles (w, w + W, ...) += cb (A, split
      // once as read) x G (B), depth the chunk's 32 samples: the tiles
      // come from the window into registers for the chunk and go back, so
      // that the VJP above holds no Zd registers.
      float z[MT][4][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int r0 = 16 * (warp + kWarps * i);
        if (r0 < zr) {
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float2 v = *reinterpret_cast<const float2*>(
                  zwin + zoff(r0 + g + 8 * h, 8 * nt + 2 * t));
              z[i][nt][2 * h] = v.x;
              z[i][nt][2 * h + 1] = v.y;
            }
        }
      }
#pragma unroll
      for (int ks = 0; ks < kNS / 8; ++ks) {
        float b_hi[4][2], b_lo[4][2];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const float4 b = gfrag4[frag_index(ks, nt, lane)];
          b_hi[nt][0] = b.x;
          b_hi[nt][1] = b.y;
          b_lo[nt][0] = b.z;
          b_lo[nt][1] = b.w;
        }
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const int r0 = 16 * (warp + kWarps * i);
          if (r0 < zr) {
            float a_hi[4], a_lo[4];
#pragma unroll
            for (int q = 0; q < 4; ++q)
              dgs::tf32_split_rt(
                  big[(r0 + g + 8 * (q % 2)) * kNS +
                      (((2 * ks + q / 2) ^ hg) << 2) + t],
                  three, a_hi[q], a_lo[q]);
            // pass-major: consecutive mma.sync write different tiles
            if (three) {
#pragma unroll
              for (int nt = 0; nt < 4; ++nt)
                dgs::mma_tf32(z[i][nt], a_lo, b_hi[nt]);
#pragma unroll
              for (int nt = 0; nt < 4; ++nt)
                dgs::mma_tf32(z[i][nt], a_hi, b_lo[nt]);
            }
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
              dgs::mma_tf32(z[i][nt], a_hi, b_hi[nt]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int r0 = 16 * (warp + kWarps * i);
        if (r0 < zr) {
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int h = 0; h < 2; ++h)
              *reinterpret_cast<float2*>(
                  zwin + zoff(r0 + g + 8 * h, 8 * nt + 2 * t)) =
                  make_float2(z[i][nt][2 * h], z[i][nt][2 * h + 1]);
        }
      }
    }

    // Thread (channel c, entry e) adds the window's rows i C + c of the
    // pass, ascending, times alpha_i, into its value row.
    __syncthreads();
    {
      const int r_hi = min(R, r_lo + zr);
      for (int o = tid; o < C * kNE; o += kThreads) {
        const int c = o / kNE, e = o % kNE;
        float sum = vout[o];
        for (int i = (max(r_lo - c, 0) + C - 1) / C; i * C + c < r_hi; ++i)
          sum = fmaf(geom[(a0 + i) * Ep + e_base + e],
                     zwin[zoff(i * C + c - r_lo, e)], sum);
        vout[o] = sum;
      }
    }
    __syncthreads();   // the window is consumed before the next pass
  }

  // The warps' mean and conic rows of each entry, summed in warp order.
#pragma unroll
  for (int d = 0; d < D; ++d) big[(warp * NV + d) * kNE + lane] = dmu[d];
#pragma unroll
  for (int u = 0; u < TRI; ++u)
    big[(warp * NV + D + u) * kNE + lane] = dcon[u];
  __syncthreads();
  const int nout = NV + C;
  for (int i = tid; i < kNE * nout; i += kThreads) {
    const int e = i / nout, f = i % nout;
    float v = 0.0f;
    if (f < NV) {
      for (int w = 0; w < kWarps; ++w) v += big[(w * NV + f) * kNE + e];
    } else {
      v = vout[(f - NV) * kNE + e];
    }
    out[(e_base + e) * nout + f] = v;
  }
}

template <int D, int MASK, bool HMM>
cudaError_t launch_one(const float* geom, long long Ep, int C,
                       const float* smp, long long Np, const float* ct,
                       const float* cb, int Rp, int R, const int* s_lo,
                       const int* s_n, int n_ranges, OrderRows rows,
                       bool three, float* out, cudaStream_t stream) {
  constexpr int K = dgs::total_unique(D, MASK);
  const int zrows = pass_rows(D, K, C, Rp, HMM);
  if (zrows < 16) return cudaErrorInvalidValue;
  const int W = warps_of(Rp, HMM);
  const size_t bytes = sizeof(float) * smem_floats(D, K, C, HMM, zrows, W);
  auto go = [&](auto* kernel, int threads) {
    if (bytes > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
      if (err != cudaSuccess) return err;
    }
    kernel<<<n_ranges, threads, bytes, stream>>>(
        geom, Ep, C, smp, Np, ct, cb, Rp, R, s_lo, s_n, rows, zrows, three,
        out);
    return cudaGetLastError();
  };
  if constexpr (!HMM) {
    if (W == 2) return go(tiled_backward_fdv_kernel<D, MASK, HMM, 2>, 64);
  }
  return go(tiled_backward_fdv_kernel<D, MASK, HMM, 4>, 128);
}

template <int D, bool HMM>
cudaError_t launch_fdv(int mask, const float* geom, long long Ep, int C,
                       const float* smp, long long Np, const float* ct,
                       const float* cb, int Rp, int R, const int* s_lo,
                       const int* s_n, int n_ranges, OrderRows rows,
                       bool three, float* out, cudaStream_t stream) {
  switch (mask) {
#define DGS_CASE(M)                                                       \
  case M:                                                                 \
    return launch_one<D, M, HMM>(geom, Ep, C, smp, Np, ct, cb, Rp, R,     \
                                 s_lo, s_n, n_ranges, rows, three, out,   \
                                 stream);
    DGS_CASE(1) DGS_CASE(2) DGS_CASE(3) DGS_CASE(4) DGS_CASE(5)
    DGS_CASE(6) DGS_CASE(7) DGS_CASE(8) DGS_CASE(9) DGS_CASE(10)
    DGS_CASE(11) DGS_CASE(12) DGS_CASE(13) DGS_CASE(14) DGS_CASE(15)
#undef DGS_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

int total_unique_rt(int D, int mask) {
  return D == 1 ? dgs::total_unique(1, mask)
         : D == 2 ? dgs::total_unique(2, mask)
                  : dgs::total_unique(3, mask);
}

}  // namespace


extern "C" {

// Launches the folded-dvalues kernel on `stream` and returns
// cudaGetLastError() after the launch (0 = launched).  Pointers are device
// pointers; `mask` is the order set, r_* the first cotangent component of
// each order; R / Rp the folded rows and their padding (a multiple of 16);
// `passes` 3 or 1; `hmm` 1 for h_matmul.  Ranges are the classic
// backward's (32 entries).  smp, ct and cb are 16-byte aligned with Np a
// multiple of 4 (the copies are 16 bytes).
int dgs_tiled_backward_fdv(const void* geom, int Ep, int C, const void* smp,
                           int Np, const void* ct, const void* cb, int Rp,
                           int R, const void* s_lo, const void* s_n,
                           int n_ranges, int D, int mask, int r_value,
                           int r_derivative, int r_laplacian, int r_third,
                           int passes, int hmm, void* out, void* stream) {
  if ((long long)n_ranges * kWarp != Ep || C < 1 || Rp % 16 != 0 ||
      R > Rp || Np % 4 != 0 || (size_t)smp % 16 != 0 ||
      (size_t)ct % 16 != 0 || (size_t)cb % 16 != 0 ||
      (passes != 1 && passes != 3))
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

// Zd rows a pass of a launch holds (the samples are swept once a pass),
// and its dynamic shared bytes; 0 where no launch is possible.
int dgs_tiled_backward_fdv_pass_rows(int D, int mask, int Rp, int C,
                                     int hmm) {
  if (D < 1 || D > 3 || mask < 1 || mask > 15 || C < 1) return 0;
  return pass_rows(D, total_unique_rt(D, mask), C, Rp, hmm != 0);
}

// Warps a block of a launch at (Rp, hmm).
int dgs_tiled_backward_fdv_warps(int Rp, int hmm) {
  return warps_of(Rp, hmm != 0);
}

int dgs_tiled_backward_fdv_smem(int D, int mask, int Rp, int C, int hmm) {
  const int rows = dgs_tiled_backward_fdv_pass_rows(D, mask, Rp, C, hmm);
  return rows >= 16 ? (int)sizeof(float) *
                          smem_floats(D, total_unique_rt(D, mask), C,
                                      hmm != 0, rows, warps_of(Rp, hmm != 0))
                    : 0;
}

}  // extern "C"
