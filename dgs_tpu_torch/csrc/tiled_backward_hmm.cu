// The tiled backward under h_matmul (dgs_tpu's kernel 2 with h = g . values
// as matrix-unit dots), for Hopper (sm_90a).
//
// Replaces the TPU kernel dgs_tpu/kernels/tiled.py::tiled_backward
// (_wl_backward_kernel under h_matmul, kernels/tiled.py:1098-1109).  Same
// contract as tiled_backward.cu: for every tile-sorted entry, the gradient
// of the loss w.r.t. its period-shifted mean (D rows), packed conic (tri
// rows) and values (C rows), summed over the sorted samples on its tile,
// written entry-major, a packed (Ep, D + tri + C) fp32 array, one record an
// entry; wrapped (a period) and wrap-free.  Per kept pair the classic
// per-pair work (X = mu' - x, wrapped where the op passes a period, a = C X,
// G, the polynomials q and the weights w once; dvalues_c += sum_k ct[k, c]
// w_k; the closed-form VJP pair_vjp), with the folded cotangents
//   h_k[e, n] = sum_c values_c[e] ct[k, c][n]
// as TF32 tensor-core contractions over the pass's channels (entries the
// M side, channels the K side, samples the N side).
//
// Design.  A block of 4 warps owns two consecutive 32-entry ranges, a warp
// 16 entries (one m16 tile) and a lane two of them (g and g + 8, lane =
// 4 g + t), and sweeps the union of the two ranges' sample ranges 32
// samples at a time, one block barrier a chunk:
//   - cp.async (16-byte copies, cp_async.cuh) brings the chunk's rows two
//     chunks ahead: the samples' [x, tile] and the pass's cotangents
//     ct[k, c];
//   - one chunk ahead the block transposes them into the samples' records
//     ([tile, x], then the K x CB cotangents: tiled_layout.cuh's backward
//     record) and splits each cotangent into TF32 hi / lo once, stored as
//     the B fragments of h (k, n8 tile, lane: ct[k, c = t] of sample
//     8 nt + g), so that a warp's fragment is one 8-byte load;
//   - the warp holds its entries' values for the channel pass as one A
//     fragment [v_hi | v_lo] (channels 0-3 hi, 4-7 lo: CB <= 4), so that
//     three passes take two mma.sync, against [ct_hi; ct_hi] and
//     [ct_lo; 0];
//   - per n8 tile of the chunk that meets its range the warp computes h_k
//     for its 16 entries x 8 samples (one mma.sync m16n8k8 a component and
//     pass pair) and keeps it in registers: lane (g, t) holds h of the
//     pairs (entries g, g + 8; samples 2 t, 2 t + 1), and runs the per-pair
//     work on those pairs with h straight from the accumulators: no h
//     block, no store, no barrier a block of samples.
// The lane's mean, conic and value rows are partial over its quarter of the
// samples; at the end of a pass (values) and of the sweep (mean, conic)
// they are summed across the quad (the lanes that share g) by two xor
// shuffles in a fixed order, and each entry's record is written once.  No
// atomics: two runs are bitwise equal.  The dvalues FMAs stay on the CUDA
// cores.  Channel passes of CB (C > 4) add their partial h into the same
// mean and conic registers (the VJP is linear in h).
//
// What bounds it, as measured (chip_variants.py, beside the first
// version's source, on tools.bench's operands; NVIDIA H100 80GB HBM3 at
// 700 W; PERF.md): the per-pair fp32 work (the forward's G, polynomials and
// weights, the K*CB dvalues FMAs and their K*CB/4 record loads, the VJP's
// multiply-adds), as in tiled_backward.cu less its K*CB h FMAs, at 12 warps
// an SM (168 registers at D = 3, three orders; 128 and 16 warps at D = 2);
// the contraction is 2K mma.sync (3 passes) or K (1 pass) a 16 x 8 pair
// block, and one pass saves only 3-5%.  D = 3 chunked, three orders:
// 11.4-11.6 ms against the first version's 13.4-13.6 (one warp a block,
// h through a shared-memory block a lane reads back); D = 2 headline
// 1.62-1.63 against 1.93-1.94; kernel 2 9.0 / 1.4 in the same calls.
//
// Tried and dropped (D = 3 / D = 2 ms in the calls that timed them):
// the pairs' sample loop rolled, h picked by a select: 11.7-11.9 / 1.73;
// 16 warps an SM (128 registers: 8-40 spilled bytes at D = 3) 11.8 / 1.75;
// the dvalues as a tensor-core contraction (w_k of the lane's 4 pairs as
// the A operand in place, samples renamed to its k slots, against the
// pass's cotangents split once a chunk; 3 passes): 17.9 / 2.23, since
// the lane then holds the 4 K weights of its pairs beside h.  Two
// components packed into one k8 step would give the same count of
// mma.sync (the N side then splits into two components of 4 samples) and
// put a pair's components in different lanes; the free half of the k8
// depth holds v_lo instead.
//
// Built with the other sources into libdgs_kernels.so
// (dgs_tpu_torch/kernels/_build.py).  Never with --use_fast_math.
#include <cuda_runtime.h>

#include "cp_async.cuh"
#include "tf32_mma.cuh"
#include "tiled_layout.cuh"

namespace {

using dgs::kWarp;
using dgs::OrderRows;

constexpr int kWarps = 4;    // warps a block: two ranges, 16 entries a warp
constexpr int kRanges = kWarps / 2;
constexpr int kNS = 32;      // samples a chunk

// Blocks an SM should hold, for ptxas's register budget: the lane holds
// 4 K values of h, so the budget follows K: 16 warps (128 registers) up to
// K = 6 at D <= 2 and K = 4 at D = 3 (where K = 6 spilled at 128), 12
// (168) up to K = 10, else 8.
DGS_HD constexpr int min_blocks(int D, int mask) {
  return ((D <= 2 && dgs::total_unique(D, mask) <= 6) ||
                  dgs::total_unique(D, mask) <= 4
              ? 16
          : dgs::total_unique(D, mask) <= 10 ? 12
                                             : 8) / kWarps;
}

template <int D, int MASK, int CB>
struct Shared {
  static constexpr int K = dgs::total_unique(D, MASK);
  static constexpr int NV = dgs::bwd_record_vecs(K, CB);
  // A chunk's rows as cp.async lands them ([row][sample]): x_0..D-1 and
  // the tile (the rows of smp), then ct[k, c] (row D + 1 + k CB + c); two
  // chunks ahead of their use.
  static constexpr int RAW = D + 1 + K * CB;
  float raw[2][RAW][kNS];
  // The chunk's records ([vector][sample]) and h's B fragments
  // {hi, lo} [k][n8 tile][lane], prepared one chunk ahead.
  float4 rec[2][NV * kNS];
  float2 hfrag[2][K][kNS / 8][kWarp];
};

// One kept pair (entry state ``mu``, ``con``; the sample's record j), with
// its h, added into the entry's rows.
template <int D, int MASK, int CB, bool WRAP>
__device__ __forceinline__ void hmm_pair(
    dgs::StagedBase rb, int j, const float4& head, float period,
    float inv_period, const float (&mu)[D],
    const float (&con)[dgs::tri_size(D)],
    const float (&h)[dgs::total_unique(D, MASK)], float (&dmu)[D],
    float (&dcon)[dgs::tri_size(D)], float (&dv)[CB]) {
  constexpr int TRI = dgs::tri_size(D);
  constexpr int K = dgs::total_unique(D, MASK);
  const float xs[3] = {head.y, head.z, head.w};
  float X[D], a[D], q[TRI], w[K];
#pragma unroll
  for (int d = 0; d < D; ++d)
    X[d] = dgs::wrap_by<WRAP>(mu[d] - xs[d], period, inv_period);
  const float G = dgs::pair_gauss<D>(X, con, a);
  dgs::pair_polys<D, MASK>(con, a, q);
  dgs::component_weights<D, MASK>(con, a, q, G, w);
#pragma unroll
  for (int gv = 0; gv < dgs::record_vecs(K * CB); ++gv) {
    const float4 c4 = dgs::staged_vector(rb, 1 + gv, j);
    const float ct[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int idx = 4 * gv + u;
      if (idx < K * CB) dv[idx % CB] = fmaf(ct[u], w[idx / CB], dv[idx % CB]);
    }
  }
  dgs::pair_vjp<D, MASK>(X, con, a, q, G, w, h, dmu, dcon);
}

// x summed over the quad of lanes that share lane / 4, the same bits in
// every lane of it.
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}

template <int D, int MASK, int CB, bool WRAP>
__global__ void __launch_bounds__(kWarps * kWarp, min_blocks(D, MASK))
    tiled_backward_hmm_kernel(
        const float* __restrict__ geom,  // (1 + D + tri + C, Ep): tile, mu', conic, values
        long long Ep, int C,
        const float* __restrict__ smp,   // (D + 1, Np): coords, tile
        long long Np,
        const float* __restrict__ ct,    // (K * C, Np) cotangent, sorted-sample order
        const int* __restrict__ s_lo,    // (Ep / 32,) first sample of each range
        const int* __restrict__ s_n,     // (Ep / 32,) length of the range
        int n_ranges, float period, float inv_period, OrderRows rows,
        bool three,                      // 3 TF32 passes for h, else 1
        float* __restrict__ out) {       // (Ep, D + tri + C), entry-major
  using Sh = Shared<D, MASK, CB>;
  constexpr int kThreads = kWarps * kWarp;
  constexpr int TRI = dgs::tri_size(D);
  constexpr int K = Sh::K, NV = Sh::NV, RAW = Sh::RAW;
  extern __shared__ float s_dt[];
  Sh& sh = *reinterpret_cast<Sh*>(s_dt);
  const int tid = threadIdx.x, warp = tid / kWarp, lane = tid % kWarp;
  const int g = lane / 4, t = lane % 4;
  const long long nout = D + TRI + C;

  // The warp's range and entries (g and g + 8 of its half); none past the
  // last range: such warps only stage and wait.
  const long long r = (long long)blockIdx.x * kRanges + warp / 2;
  const bool real = r < n_ranges;
  const long long ebase = (real ? r : 0) * kWarp + 16 * (warp % 2) + g;
  const int lo = real ? s_lo[r] : 0;
  const int hi = real ? lo + s_n[r] : 0;
  // The block sweeps the union of its ranges' sample ranges.
  int blo = 0x7fffffff, bhi = 0;
  for (int v = 0; v < kRanges; ++v) {
    const long long rv = (long long)blockIdx.x * kRanges + v;
    if (rv < n_ranges && s_n[rv] > 0) {
      blo = min(blo, s_lo[rv]);
      bhi = max(bhi, s_lo[rv] + s_n[rv]);
    }
  }
  const int s_first = blo < bhi ? blo & ~3 : 0;   // 16-byte aligned copies
  const int n_sc = blo < bhi ? (bhi - s_first + kNS - 1) / kNS : 0;
  if (n_sc == 0) {   // no samples in the block's ranges: zero records
    if (real)
      for (int i = 0; i < 2; ++i)
        for (int f = t; f < nout; f += 4) out[(ebase + 8 * i) * nout + f] = 0.0f;
    return;
  }

  float tile[2], mu[2][D], con[2][TRI], dmu[2][D], dcon[2][TRI];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const long long e = ebase + 8 * i;
    tile[i] = real ? geom[e] : -3.0f;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      mu[i][d] = geom[(1 + d) * Ep + e];
      dmu[i][d] = 0.0f;
    }
#pragma unroll
    for (int u = 0; u < TRI; ++u) {
      con[i][u] = geom[(1 + D + u) * Ep + e];
      dcon[i][u] = 0.0f;
    }
  }

  for (int c0 = 0; c0 < C; c0 += CB) {
    // The values' A fragment [v_hi | v_lo]: channel t of entries g, g + 8.
    float av[4], dv[2][CB];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float x = t < CB && c0 + t < C
                          ? geom[(1 + D + TRI + c0 + t) * Ep + ebase + 8 * i]
                          : 0.0f;
      dgs::tf32_split_rt(x, three, av[i], av[2 + i]);
#pragma unroll
      for (int c = 0; c < CB; ++c) dv[i][c] = 0.0f;
    }

    // cp.async of chunk sc's rows into raw[buf]: smp's rows, then ct's row
    // of each (component, channel) of the pass; zeros past channel C or
    // past Np.
    auto stage = [&](int sc, int buf) {
      const long long s0 = s_first + (long long)sc * kNS;
      // Kept rolled: unrolled, the address arithmetic costs registers.
#pragma unroll 1
      for (int idx = tid; idx < RAW * (kNS / 4); idx += kThreads) {
        const int row = idx / (kNS / 4), c4 = idx % (kNS / 4);
        const long long s = s0 + 4 * c4;
        const float* src = smp;
        bool ok = s < Np;
        if (row <= D) {
          src = smp + row * Np + s;
        } else {
          const int kc = row - D - 1, c = kc % CB;
          ok = ok && c0 + c < C;
          src = ct + (dgs::packed_component<D, MASK>(kc / CB, rows) * C +
                      c0 + c) * Np + s;
        }
        dgs::cp_async16(&sh.raw[buf][row][4 * c4], ok ? src : smp, ok);
      }
      dgs::cp_async_commit();
    };

    // Chunk rows (landed in raw[buf]) into its records and h's B fragments.
    auto prepare = [&](int buf) {
      const float(*rw)[kNS] = sh.raw[buf];
      for (int idx = tid; idx < NV * kNS; idx += kThreads) {
        const int v = idx / kNS, j = idx % kNS;
        float f[4];
        if (v == 0) {
          f[0] = rw[D][j];
#pragma unroll
          for (int d = 0; d < 3; ++d) f[1 + d] = d < D ? rw[d][j] : 0.0f;
        } else {
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int kc = 4 * (v - 1) + u;
            f[u] = kc < K * CB ? rw[D + 1 + kc][j] : 0.0f;
          }
        }
        sh.rec[buf][idx] = make_float4(f[0], f[1], f[2], f[3]);
      }
      for (int idx = tid; idx < K * (kNS / 8) * kWarp; idx += kThreads) {
        const int L = idx % kWarp, nt = (idx / kWarp) % (kNS / 8),
                  k = idx / (kWarp * (kNS / 8));
        const int c = L % 4;
        const float x = c < CB ? rw[D + 1 + k * CB + c][8 * nt + L / 4]
                               : 0.0f;
        float h, l;
        dgs::tf32_split_rt(x, three, h, l);
        sh.hfrag[buf][k][nt][L] = make_float2(h, l);
      }
    };

    // One barrier a chunk: the rows land two chunks ahead, the records and
    // fragments are prepared one chunk ahead by the whole block.
    stage(0, 0);
    if (n_sc > 1) stage(1, 1);
    dgs::cp_async_wait_all();
    __syncthreads();
    prepare(0);
    for (int sc = 0; sc < n_sc; ++sc) {
      dgs::cp_async_wait_all();
      __syncthreads();   // chunk sc + 1 landed; chunk sc is prepared
      if (sc + 2 < n_sc) stage(sc + 2, sc & 1);
      if (sc + 1 < n_sc) prepare((sc + 1) & 1);
      const int buf = sc & 1;
      const long long s0 = s_first + (long long)sc * kNS;
      // The warp's samples in the chunk: j_lo .. j_hi - 1.
      const int j_lo = (int)max(0LL, lo - s0);
      const int j_hi = (int)min((long long)kNS, hi - s0);
      // Records read through their 32-bit shared address, in program order
      // (tiled_layout.cuh staged_vector): nothing hoisted.
      const dgs::StagedBase rb = dgs::staged_base(sh.rec[buf]);

      for (int nt = 0; nt < kNS / 8; ++nt) {
        if (8 * nt >= j_hi || 8 * nt + 8 <= j_lo) continue;
        // h_k of pairs (entries g, g + 8) x (samples 8 nt + 2 t, + 1).
        float hk[K][4];
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const float2 b = sh.hfrag[buf][k][nt][lane];
          const float b1[2] = {b.x, b.x}, b2[2] = {b.y, 0.0f};
          hk[k][0] = hk[k][1] = hk[k][2] = hk[k][3] = 0.0f;
          dgs::mma_tf32(hk[k], av, b1);
          if (three) dgs::mma_tf32(hk[k], av, b2);
        }
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int j = 8 * nt + 2 * t + jj;
          if (j < j_lo || j >= j_hi) continue;
          const float4 head = dgs::staged_vector(rb, 0, j);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            if (head.x != tile[i]) continue;
            float h[K];
#pragma unroll
            for (int k = 0; k < K; ++k)
              h[k] = jj ? hk[k][2 * i + 1] : hk[k][2 * i];
            hmm_pair<D, MASK, CB, WRAP>(rb, j, head, period, inv_period,
                                        mu[i], con[i], h, dmu[i], dcon[i],
                                        dv[i]);
          }
        }
      }
    }

    // The pass's value rows, summed over the quad; lane t writes channels
    // t, t + 4, ...
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int c = 0; c < CB; ++c) {
        const float s = quad_sum(dv[i][c]);
        if (real && c % 4 == t && c0 + c < C)
          out[(ebase + 8 * i) * nout + D + TRI + c0 + c] = s;
      }
    __syncthreads();   // the rows, records and fragments are free again
  }

  // The mean and conic rows, summed over the quad; lane t writes rows t,
  // t + 4, ...
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float* rec = out + (ebase + 8 * i) * nout;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const float s = quad_sum(dmu[i][d]);
      if (real && d % 4 == t) rec[d] = s;
    }
#pragma unroll
    for (int u = 0; u < TRI; ++u) {
      const float s = quad_sum(dcon[i][u]);
      if (real && (D + u) % 4 == t) rec[D + u] = s;
    }
  }
}

template <int D, int MASK, int CB>
cudaError_t launch_one(const float* geom, long long Ep, int C,
                       const float* smp, long long Np, const float* ct,
                       const int* s_lo, const int* s_n, int n_ranges,
                       int do_wrap, float period, OrderRows rows, bool three,
                       float* out, cudaStream_t stream) {
  constexpr size_t bytes = sizeof(Shared<D, MASK, CB>);
  static_assert(bytes <= 227 * 1024, "above the shared memory of an SM");
  const float inv = dgs::exact_inv_period(period);
  const int blocks = (n_ranges + kRanges - 1) / kRanges;
  auto go = [&](auto* kernel) {
    if (bytes > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
      if (err != cudaSuccess) return err;
    }
    kernel<<<blocks, kWarps * kWarp, bytes, stream>>>(
        geom, Ep, C, smp, Np, ct, s_lo, s_n, n_ranges, period, inv, rows,
        three, out);
    return cudaGetLastError();
  };
  if (do_wrap) return go(tiled_backward_hmm_kernel<D, MASK, CB, true>);
  return go(tiled_backward_hmm_kernel<D, MASK, CB, false>);
}

template <int D, int CB>
cudaError_t launch(int mask, const float* geom, long long Ep, int C,
                   const float* smp, long long Np, const float* ct,
                   const int* s_lo, const int* s_n, int n_ranges, int do_wrap,
                   float period, OrderRows rows, bool three, float* out,
                   cudaStream_t stream) {
  switch (mask) {
#define DGS_CASE(M)                                                         \
  case M:                                                                   \
    return launch_one<D, M, CB>(geom, Ep, C, smp, Np, ct, s_lo, s_n,        \
                                n_ranges, do_wrap, period, rows, three, out, \
                                stream);
    DGS_CASE(1) DGS_CASE(2) DGS_CASE(3) DGS_CASE(4) DGS_CASE(5)
    DGS_CASE(6) DGS_CASE(7) DGS_CASE(8) DGS_CASE(9) DGS_CASE(10)
    DGS_CASE(11) DGS_CASE(12) DGS_CASE(13) DGS_CASE(14) DGS_CASE(15)
#undef DGS_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

// The channel-pass width for (D, C): no zero channels for C = 1 and C = 2
// where the narrow passes are built (D = 2).
DGS_HD constexpr int hmm_pass(int D, int C) {
  return (D == 2 && C <= 2) ? C : 4;
}

template <int D, int CB>
int shared_bytes(int mask) {
  switch (mask) {
#define DGS_CASE(M) \
  case M:           \
    return (int)sizeof(Shared<D, M, CB>);
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

// Threads a block, the entries a block sweeps together (two ranges), and
// the dynamic shared bytes of a launch at (D, mask, C), for the smoke
// test's facts.
int dgs_tiled_backward_hmm_block() { return kWarps * kWarp; }

int dgs_tiled_backward_hmm_rows() { return kRanges * kWarp; }

int dgs_tiled_backward_hmm_smem(int D, int mask, int C) {
  const int cb = hmm_pass(D, C);
  if (D == 1) return shared_bytes<1, 4>(mask);
  if (D == 3) return shared_bytes<3, 4>(mask);
  if (D != 2) return 0;
  return cb == 1 ? shared_bytes<2, 1>(mask)
         : cb == 2 ? shared_bytes<2, 2>(mask)
                   : shared_bytes<2, 4>(mask);
}

// dgs_tiled_backward's contract, with h_k from `passes` (3 or 1) TF32
// tensor-core passes.  smp and ct are 16-byte aligned with Np a multiple
// of 4 (the copies are 16 bytes).
int dgs_tiled_backward_hmm(const void* geom, int Ep, int C, const void* smp,
                           int Np, const void* ct, const void* s_lo,
                           const void* s_n, int n_ranges, int D, int mask,
                           int do_wrap, float period, int r_value,
                           int r_derivative, int r_laplacian, int r_third,
                           int passes, void* out, void* stream) {
  if ((passes != 1 && passes != 3) || (long long)n_ranges * kWarp != Ep ||
      C < 1 || Np % 4 != 0 || (size_t)smp % 16 != 0 || (size_t)ct % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const OrderRows rows{r_value, r_derivative, r_laplacian, r_third};
  const auto* g = static_cast<const float*>(geom);
  const auto* s = static_cast<const float*>(smp);
  const auto* c = static_cast<const float*>(ct);
  const auto* lo = static_cast<const int*>(s_lo);
  const auto* n = static_cast<const int*>(s_n);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const int cb = hmm_pass(D, C);
  const bool three = passes == 3;
#define DGS_LAUNCH(DD, CB)                                                 \
  launch<DD, CB>(mask, g, Ep, C, s, Np, c, lo, n, n_ranges, do_wrap,       \
                 period, rows, three, o, st)
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
