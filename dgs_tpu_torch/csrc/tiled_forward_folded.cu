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
// What bounds it.  R TF32 multiply-adds a pair a pass (R = 292 at D = 3,
// three orders, C = 4: 876 at 3 passes) against about 20 fp32 operations
// for G: the tensor cores, once the operands reach them from shared memory
// and G is not computed again.  The fold rows are R floats an entry, read
// once a block of samples.
//
// Design.  A block of 8 warps owns 64 consecutive sorted samples (two
// ranges of 32, the N side: eight n8 tiles) and sweeps the union of their
// entry ranges 32 entries at a time (the K side).  The R rows of Z are
// split across the warps by m16 tiles (tile T to warp T % 8), so Z stays in
// registers: one tile a warp where R fits in 128 rows (R = 100 at D = 2;
// two blocks an SM), else at most 3 (384 rows a pass, one block an SM).
// R = 292 (D = 3) takes one pass over the pairs; taller R takes the fewest
// passes of 384 rows, G computed once a pass.  Per chunk of 32 entries:
//   - cp.async (16-byte copies, cp_async.cuh) stages the chunk's fold rows
//     (swizzled, so that the fragment reads are free of bank conflicts) one
//     chunk ahead, double-buffered: the copy of chunk c + 1 runs under chunk
//     c's contraction; each warp copies for itself the [tile, mu_l, conic]
//     records of the 8 entries whose G it computes;
//   - G of the chunk's 32 x 64 pairs is computed once (the fp32 pair math
//     of pair_math.cuh; 0 off the sample's tile, outside the block's range
//     or where the quadratic form is positive), split into TF32 hi / lo
//     once and stored in the B fragments' order (one 16-byte load a
//     fragment), into the other of two G buffers: a warp computes its
//     share of chunk c + 1's G as soon as it has contracted chunk c, while
//     the other warps still contract, so the block meets one barrier a
//     chunk;
//   - each warp adds fold (the A operand, split as its fragments are read;
//     each element is read by one warp) times G into its Z tiles with
//     mma.sync m16n8k8: 3 TF32 passes, or 1 under fast-math (tf32_mma.cuh),
//     issued pass-major, so that consecutive mma.sync write different
//     accumulators instead of waiting on each other.
//     wgmma would need its 64-row warpgroup tiles and a host model of its
//     shared-memory descriptors for the CPU tests; mma.sync from shared
//     memory keeps the fragments of tf32_mma.cuh, which the tests emulate.
// After a pass the Z tiles go through shared memory 8 at a time (the rows
// of a round are consecutive), and each thread adds its sample's column,
// times the row's monomial, into the output rows it owns (a (K*C) x 64
// block in shared memory, rows taken in ascending order).  The row of Z ->
// (output row, monomial) map is a table (``rowmap``, from the wrapper), so
// one instantiation a D serves every order set and C.  No atomics: every
// sum runs in a fixed order, two runs are bitwise equal.
//
// Measured (chip_smoke.py's folded_slice on an H100 80GB HBM3 at 700 W):
// one TF32 pass takes about 70% of the three-pass time at R = 292, so the
// contraction is not all that bounds the kernel: one block of 8 warps an SM
// at three tiles a warp (200 registers), the G math and the fragments'
// shared-memory loads and splits issue beside it.
//
// Build: with the other sources into libdgs_kernels.so
// (dgs_tpu_torch/kernels/_build.py).  Never with --use_fast_math.
#include <cuda_runtime.h>

#include "cp_async.cuh"
#include "tf32_mma.cuh"
#include "tiled_layout.cuh"

namespace {

constexpr int kWarps = 8;                     // warps a block
constexpr int kThreads = kWarps * dgs::kWarp;
constexpr int kNS = 64;                       // samples a block (two ranges)
constexpr int kKE = 32;                       // entries a chunk

// m16 tiles of Z a warp holds: 1 where R fits in 8 tiles (two blocks an
// SM), else 3 (one block an SM, 384 rows a pass).
DGS_HD constexpr int tiles_a_warp(int Rp) { return Rp <= 16 * kWarps ? 1 : 3; }
DGS_HD constexpr int pass_rows(int Rp) {
  return 16 * kWarps * tiles_a_warp(Rp);
}
constexpr int kZStride = kNS + 4;             // epilogue rows of Z (floats)
constexpr int kMaxMono = 20;                  // raw monomials up to degree 3

using dgs::kWarp;

constexpr int kGFrag = 4 * 8 * kWarp * 4;     // G fragments of a chunk

// Floats of the two stages of fold rows (a pass's rows, kKE entries), or
// the epilogue's Z rows of a round (8 m16 tiles) where those are more.
DGS_HD constexpr int stages_floats(int rows) {
  return 2 * rows * kKE > 16 * kWarps * kZStride ? 2 * rows * kKE
                                                 : 16 * kWarps * kZStride;
}

// The whole dynamic shared memory (floats): the stages, two buffers of G
// fragments (4 k8 steps x 8 n8 tiles x 32 lanes x {hi, hi, lo, lo}), each
// warp's two buffers of its 8 entries' [tile, mu_l, conic] records, the
// samples' monomials and tiles, the output rows.
DGS_HD constexpr int smem_floats(int rows, int D, int n_mono, int KC) {
  return stages_floats(rows) + 2 * kGFrag +
         kWarps * 2 * (1 + D + dgs::tri_size(D)) * 8 + (n_mono + 1) * kNS +
         KC * kNS;
}

template <int D, int MT>
__global__ void __launch_bounds__(kThreads, MT == 1 ? 2 : 1)
    tiled_forward_folded_kernel(
    const float* __restrict__ geom,  // (>= 1 + D + tri, Ep): tile, mu_l, conic
    long long Ep,
    const float* __restrict__ fold,  // (Rp, Ep) folded rows
    int Rp, int R,
    const float* __restrict__ mono,  // (n_mono + 1, Np): monomials, tile
    long long Np, int n_mono,
    const int* __restrict__ ent_lo,  // (n_ranges,) first entry of each range
    const int* __restrict__ ent_n,   // (n_ranges,) length of the range
    int n_ranges, int KC,
    const int* __restrict__ rowmap,  // (R,) (k C + c) * 32 + m
    bool three, float* __restrict__ out) {   // (K * C, Np)
  constexpr int TRI = dgs::tri_size(D);
  constexpr int HEAD = 1 + D + TRI;
  extern __shared__ float s_dt[];
  constexpr int kPassRows = 16 * MT * kWarps;  // rows of Z a pass
  const int rows = min(Rp, kPassRows);         // staged fold rows a pass
  float* gfrag = s_dt + stages_floats(rows);   // [buffer][fragments]
  float* wrec = gfrag + 2 * kGFrag;            // [warp][buffer][field][8]
  float* ms = wrec + kWarps * 2 * HEAD * 8;    // [monomial][sample]
  float* st = ms + n_mono * kNS;               // [sample] tile
  float* osum = st + kNS;                      // [output row][sample]
  const int tid = threadIdx.x, warp = tid / kWarp, lane = tid % kWarp;
  const int g = lane / 4, t = lane % 4;
  const long long n0 = (long long)blockIdx.x * kNS;

  // The block's samples, and the union of its two entry ranges.
  for (int i = tid; i < (n_mono + 1) * kNS; i += kThreads) {
    const int m = i / kNS, n = i % kNS;
    ms[i] = n0 + n < Np ? mono[m * Np + n0 + n] : -3.0f;   // -3: no tile
  }
  for (int i = tid; i < KC * kNS; i += kThreads) osum[i] = 0.0f;
  int lo = 0x7fffffff, hi = 0;
  for (int q = 0; q < 2; ++q) {
    const long long r = 2LL * blockIdx.x + q;
    if (r < n_ranges && ent_n[r] > 0) {
      lo = min(lo, ent_lo[r]);
      hi = max(hi, ent_lo[r] + ent_n[r]);
    }
  }
  const int e_first = lo & ~3;                 // 16-byte aligned copies
  // The lane's part of its A fragments' offsets in a staged fold block
  // (rows 16 T + g, + 8; columns 8 ks + t, + 4: dgs::swz of those is
  // (8 ks) ^ acol + t).
  const int arow = g * kKE + t;
  const int acol[2] = {dgs::swz(g, 0) & ~3, dgs::swz(g, 4) & ~3};
  // The thread's fold copies: row tid / 8 (+ 32 k), entries 4 (tid % 8) ..
  // + 3, at fdst (+ 32 k kKE) in a stage.
  const int fcol = 4 * (tid % (kKE / 4));
  const int fdst = tid / (kKE / 4) * kKE + dgs::swz(tid / (kKE / 4), fcol);
  const int n_chunks = lo < hi ? (hi - e_first + kKE - 1) / kKE : 0;

  // cp.async of chunk c into buffer `buf`: the pass's fold rows
  // (swizzled), by the block, and the records of the 8 entries whose G the
  // warp computes, by the warp itself (zeros past Ep).
  auto stage_chunk = [&](int c, int buf, int R0) {
    float* f = s_dt + buf * rows * kKE + fdst;
    const int e0 = e_first + c * kKE, ef = e0 + fcol;
    // thread tid: rows tid / 8 + 32 k, entries ef .. + 3
    for (int row = tid / (kKE / 4); row < rows; row += kThreads / (kKE / 4)) {
      const bool in = ef < Ep && R0 + row < Rp;
      dgs::cp_async16(f + (row - tid / (kKE / 4)) * kKE,
                      fold + (in ? (long long)(R0 + row) * Ep + ef : 0), in);
    }
    if (lane < 2 * HEAD) {
      const int q = lane / 2, k = 8 * (warp / 2) + 4 * (lane % 2);
      const bool ok = e0 + k < Ep;
      dgs::cp_async16(wrec + ((warp * 2 + buf) * HEAD + q) * 8 + k % 8,
                      geom + (ok ? (long long)q * Ep + e0 + k : 0), ok);
    }
    dgs::cp_async_commit();
  };

  // G of chunk c's pairs from the warp's records in `buf`, split once, in
  // the B fragments' order (gfrag buffer `buf`): warp w computes k8 step
  // w / 2 (entries 8 ks + t, + 4) for the n8 tiles 4 (w % 2) .. + 3
  // (samples 8 nt + g).  Only the warp's own copies are read: __syncwarp
  // after the wait suffices.
  auto chunk_gauss = [&](int c, int buf) {
    const int ks = warp / 2, e0 = e_first + c * kKE;
    const float* rec = wrec + (warp * 2 + buf) * HEAD * 8;
    float ef[2][HEAD];
    bool live[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = t + 4 * h;
#pragma unroll
      for (int q = 0; q < HEAD; ++q) ef[h][q] = rec[q * 8 + j];
      live[h] = e0 + 8 * ks + j >= lo && e0 + 8 * ks + j < hi;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int nt = 4 * (warp % 2) + u, n = 8 * nt + g;
      const float tile = st[n];
      float hi_[2], lo_[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float G = 0.0f;
        if (live[h] && ef[h][0] == tile) {
          float X[D], a[D], con[TRI];
#pragma unroll
          for (int d = 0; d < D; ++d)
            X[d] = ef[h][1 + d] - ms[(1 + d) * kNS + n];
#pragma unroll
          for (int v = 0; v < TRI; ++v) con[v] = ef[h][1 + D + v];
          G = dgs::pair_gauss<D>(X, con, a);
        }
        dgs::tf32_split_rt(G, three, hi_[h], lo_[h]);
      }
      reinterpret_cast<float4*>(gfrag + buf * kGFrag)[(ks * 8 + nt) * kWarp +
                                                      lane] =
          make_float4(hi_[0], hi_[1], lo_[0], lo_[1]);
    }
  };

  __syncthreads();   // the samples are staged
  for (int R0 = 0; R0 < R; R0 += kPassRows) {
    const int tiles = (min(Rp - R0, kPassRows) + 15) / 16;   // m16 tiles
    float z[MT][8][4];
#pragma unroll
    for (int j = 0; j < MT; ++j)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) z[j][nt][q] = 0.0f;

    if (n_chunks > 0) {
      stage_chunk(0, 0, R0);
      dgs::cp_async_wait_all();
      __syncwarp();
      chunk_gauss(0, 0);
    }
    for (int c = 0; c < n_chunks; ++c) {
      dgs::cp_async_wait_all();
      __syncthreads();   // chunk c's fold rows and G are in; c - 1 consumed
      if (c + 1 < n_chunks) stage_chunk(c + 1, (c + 1) & 1, R0);
      const float* f = s_dt + (c & 1) * rows * kKE;
      const float4* gf = reinterpret_cast<const float4*>(gfrag +
                                                         (c & 1) * kGFrag);

      // Z[r, n] += sum over the chunk's entries of fold[r, e] G[e, n].
#pragma unroll
      for (int ks = 0; ks < kKE / 8; ++ks) {
        float a_hi[MT][4], a_lo[MT][4], b_hi[8][2], b_lo[8][2];
#pragma unroll
        for (int j = 0; j < MT; ++j) {
          const int r0 = 16 * (warp + kWarps * j);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            // row r0 + g (+ 8), column 8 ks + t (+ 4), swizzled: the
            // column's chunk XOR the lane's (dgs::swz)
            const float v =
                r0 < 16 * tiles
                    ? f[(r0 + 8 * (q % 2)) * kKE + arow + ((8 * ks) ^ acol[q / 2])]
                    : 0.0f;
            dgs::tf32_split_rt(v, three, a_hi[j][q], a_lo[j][q]);
          }
        }
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const float4 b = gf[(ks * 8 + nt) * kWarp + lane];
          b_hi[nt][0] = b.x;
          b_hi[nt][1] = b.y;
          b_lo[nt][0] = b.z;
          b_lo[nt][1] = b.w;
        }
        // Pass-major: lo * hi and hi * lo of every tile, then hi * hi, so
        // that consecutive mma.sync write different accumulators (a tile's
        // own sum keeps mma_passes' order).
        if (three) {
#pragma unroll
          for (int nt = 0; nt < 8; ++nt)
#pragma unroll
            for (int j = 0; j < MT; ++j)
              if (warp + kWarps * j < tiles)
                dgs::mma_tf32(z[j][nt], a_lo[j], b_hi[nt]);
#pragma unroll
          for (int nt = 0; nt < 8; ++nt)
#pragma unroll
            for (int j = 0; j < MT; ++j)
              if (warp + kWarps * j < tiles)
                dgs::mma_tf32(z[j][nt], a_hi[j], b_lo[nt]);
        }
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int j = 0; j < MT; ++j)
            if (warp + kWarps * j < tiles)
              dgs::mma_tf32(z[j][nt], a_hi[j], b_hi[nt]);
      }
      // The next chunk's G, while the block's other warps still contract.
      if (c + 1 < n_chunks) {
        dgs::cp_async_wait_all();
        __syncwarp();
        chunk_gauss(c + 1, (c + 1) & 1);
      }
    }

    // The pass's rows through shared memory, a round of 8 m16 tiles (128
    // consecutive rows) at a time; thread (sample n, part p) adds the rows
    // whose output row is p mod 4, in ascending order.
    __syncthreads();   // every warp is done with the stages
    float* zb = s_dt;
#pragma unroll
    for (int j = 0; j < MT; ++j) {
      if (kWarps * j < tiles) {
        if (warp + kWarps * j < tiles) {
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
            float* p = zb + (16 * warp + g) * kZStride + 8 * nt + 2 * t;
            p[0] = z[j][nt][0];
            p[1] = z[j][nt][1];
            p[8 * kZStride] = z[j][nt][2];
            p[8 * kZStride + 1] = z[j][nt][3];
          }
        }
        __syncthreads();
        const int n = tid % kNS, part = tid / kNS;
        const int rbase = R0 + 16 * kWarps * j;
        for (int ii = 0; ii < 16 * kWarps && rbase + ii < R; ++ii) {
          const int code = rowmap[rbase + ii];
          const int o = code >> 5;
          if (o % (kThreads / kNS) == part) {
            float* s = osum + o * kNS + n;
            *s = fmaf(zb[ii * kZStride + n], ms[(code & 31) * kNS + n], *s);
          }
        }
        __syncthreads();
      }
    }
  }

  for (int i = tid; i < KC * kNS; i += kThreads) {
    const int o = i / kNS, n = i % kNS;
    if (n0 + n < Np) out[o * Np + n0 + n] = osum[i];
  }
}

template <int D>
cudaError_t launch(const float* geom, long long Ep, const float* fold, int Rp,
                   int R, const float* mono, long long Np, int n_mono,
                   const int* ent_lo, const int* ent_n, int n_ranges, int KC,
                   const int* rowmap, bool three, float* out,
                   cudaStream_t stream) {
  const dim3 grid((n_ranges + 1) / 2), block(kThreads);
  const size_t bytes =
      sizeof(float) * smem_floats(min(Rp, pass_rows(Rp)), D, n_mono, KC);
  if (bytes > 227 * 1024) return cudaErrorInvalidValue;
  auto* kernel = tiles_a_warp(Rp) == 1 ? tiled_forward_folded_kernel<D, 1>
                                       : tiled_forward_folded_kernel<D, 3>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, block, bytes, stream>>>(geom, Ep, fold, Rp, R, mono, Np,
                                         n_mono, ent_lo, ent_n, n_ranges, KC,
                                         rowmap, three, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns cudaGetLastError() after the
// launch (0 = launched).  Pointers are device pointers (geom and fold
// 16-byte aligned, Ep a multiple of 4: the copies are 16 bytes); R is the
// folded row count, Rp its padding (a multiple of 16), n_mono the raw
// monomials (the tile row's index), KC = K * C the output rows; rowmap[r] =
// (k * C + c) * 32 + m for Z's row r = (k, m, c); `passes` 3 or 1.  Ranges
// are the classic forward's (32 samples).
int dgs_tiled_forward_folded(const void* geom, int Ep, const void* fold,
                             int Rp, int R, const void* mono, int Np,
                             int n_mono, const void* ent_lo,
                             const void* ent_n, int n_ranges, int D, int KC,
                             const void* rowmap, int passes, void* out,
                             void* stream) {
  if ((long long)n_ranges * kWarp != Np || Rp % 16 != 0 || R > Rp ||
      n_mono > kMaxMono || Ep % 4 != 0 || (size_t)geom % 16 != 0 ||
      (size_t)fold % 16 != 0 || (passes != 1 && passes != 3))
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

// Rows of Z a pass at Rp (the sweep over the pairs runs ceil(Rp / this)
// times).
int dgs_tiled_forward_folded_pass_rows(int Rp) { return pass_rows(Rp); }

// Dynamic shared bytes of a launch.
int dgs_tiled_forward_folded_smem(int D, int Rp, int n_mono, int KC) {
  return (int)sizeof(float) *
         smem_floats(min(Rp, pass_rows(Rp)), D, n_mono, KC);
}

}  // extern "C"
