// Backward of the neighbour aggregation, for Hopper (sm_90a).
//
// Replaces the TPU kernel dgs_tpu/kernels/aggregate.py::backward
// (_backward_kernel).  Same contract, from the cotangent g of the raw
// pre-activation, already scaled by inv_tot per centre, and its channel sum
// gsum (agg_math.cuh has the per-pair formulas):
//   per entry j:  dfeat_j[l] = sum_i g_i[l] G w fac,  dkey_j = sum_i q_i dw
//   per centre i: dq_i = sum_j k_j dw, and the centre's partial sums of
//                 d(distance_transform) (2E) and d(frequencies) (nfreq)
// with dw = G (fac <g_i, feat_j> + emb gsum_i), over same-tile pairs under
// the collision mask.
//
// Design.  The TPU kernel gets per-entry and per-centre sums out of one
// ordered sweep by writing a slab per work item.  CUDA blocks run in no
// order, so the deterministic design is two kernels in this source, both
// the warp sweep of agg_sweep.cuh (a warp over `rows` consecutive
// tile-sorted rows, its lanes across their ranges, the colliding pairs
// compacted into a queue so that the body runs on full warps):
//
//   * entry-major (agg_backward_entries_kernel): rows are the entries, over
//     the centre range of their tile.  A pair's partials are the entry's
//     L + K output rows, g_i[l] G w fac and q_i[k] dw, taken RB at a time
//     (RB is 8 or 16, the wrapper's pick, so L + K <= 16 is one pass).
//     Output entry-major, (Ep, L + K): an entry's rows are one record,
//     stored by consecutive lanes, which the segment-sum by Gaussian id
//     (csrc/segment_sum.cu) reads in one piece.
//   * centre-major (agg_backward_centres_kernel): rows are the centres, over
//     the entry range of their tile.  A pair's partials are KB query
//     gradients k_j[k] dw and, in the first pass, the 4 D nfreq + 2 + nfreq
//     code partials, which need D and nfreq at compile time (nfreq 1 to 4
//     are built).  Output (Cp, K + 2E + nfreq), one row per centre; the
//     caller un-sorts the query columns and sums the code columns over
//     centres.
//
// Every row is written once by its warp: no atomics, and two runs agree
// bitwise.  Both kernels recompute the pair's geometry, weight and code.
// Operands are read through L1: the warps of a tile read the same columns.
//
// What bounds it.  Per colliding pair each kernel pays the forward's work
// (the K-term dot product, the code's sin / cos) plus an L-term dot product
// and its partials: L + K entry-major, K + 6 D nfreq centre-major.  Bound
// by fp32 and special-function issue, not by device memory; as in
// agg_forward.cu, where tiles hold hundreds of rows the candidate tests
// dominate and resident warps count.
//
// Built by dgs_tpu_torch/kernels/_build.py (nvcc, sm_90a, plain C ABI,
// ctypes).  Never with --use_fast_math (see agg_math.cuh).
#include <cuda_runtime.h>

#include "agg_sweep.cuh"

namespace {

constexpr int kWarps = 4;  // warps a block (both kernels)
// Blocks an SM that each kernel asks ptxas to fit (so at most 65,536 /
// (128 x blocks) registers).  The sweep waits on loads and shuffles, so
// resident warps matter: 8 blocks (64 registers) for the entry-major
// kernel, the most that spills nowhere (9 spilled at D = 3); the
// centre-major one, with its wide partials, needs more.  With the maximum
// of threads alone, ptxas spilled in several instantiations.
constexpr int kEntryBlocks = 8;
constexpr int kCentreBlocks = 1;
constexpr int kBlock = kWarps * dgs::kSweepWarp;
constexpr int kMaxCode = 2048;  // 2E + nfreq floats of dynamic shared memory
constexpr int kPad = dgs::kPartStride;  // row stride of the partials

// The block's copy of the distance transform and the frequencies; the one
// barrier of both kernels.
__device__ __forceinline__ void load_code(const float* dtf, int ndt,
                                          float* s_dt) {
  for (int t = threadIdx.x; t < ndt; t += kBlock) s_dt[t] = dtf[t];
  __syncthreads();
}

template <int D, bool LADDER, int RB>
__global__ void __launch_bounds__(kBlock, kEntryBlocks)
    agg_backward_entries_kernel(
    const float* __restrict__ ent_geo,  // (D + tri + 1, Ep): mu', conic, r
    const float* __restrict__ ent_fk,   // (L + K, Ep): features, keys
    long long Ep,
    const float* __restrict__ ctr_geo,  // (Cp, D + 3 + K)
    int cols, long long Cp,
    const int* __restrict__ ent_ctr,    // (2, Ep): centre range of each entry
    const float* __restrict__ dtf,      // (2E + nfreq,)
    const float* __restrict__ gpre,     // (Cp, L) cotangent, inv_tot-scaled
    const float* __restrict__ gsum,     // (Cp,) its channel sum
    int L, int K, int nfreq, int E, int do_wrap, float period, int rows,
    float* __restrict__ dent) {         // (Ep, L + K), entry-major
  constexpr int TRI = dgs::tri_size(D);
  static_assert(kWarps * sizeof(dgs::SweepScratch<RB>) +
                        kMaxCode * sizeof(float) <= 48 * 1024,
                "shared memory must stay under 48 KB");
  __shared__ dgs::SweepScratch<RB> s_sweep[kWarps];
  extern __shared__ float s_dt[];
  load_code(dtf, 2 * E + nfreq, s_dt);

  const int warp = threadIdx.x / dgs::kSweepWarp;
  const int lane = threadIdx.x % dgs::kSweepWarp;
  const long long row0 = ((long long)blockIdx.x * kWarps + warp) * rows;
  if (row0 >= Ep) return;
  const int nrows = (int)min((long long)rows, Ep - row0);
  const int R = L + K;
  // Lane s < nrows holds entry s's range, mean and radius.
  float mu_r[D], r_r = 0.0f;
  int lo = 0, hi = 0;
  if (lane < nrows) {
    const long long j = row0 + lane;
#pragma unroll
    for (int d = 0; d < D; ++d) mu_r[d] = ent_geo[d * Ep + j];
    r_r = ent_geo[(D + TRI) * Ep + j];
    lo = ent_ctr[j];
    hi = ent_ctr[Ep + j];
  } else {
#pragma unroll
    for (int d = 0; d < D; ++d) mu_r[d] = 0.0f;
  }

  for (int r0 = 0; r0 < R; r0 += RB) {
    auto cand = [&](bool in, int slot, int i) {
      float mu_j[D], mu_i[D], X[D];
#pragma unroll
      for (int d = 0; d < D; ++d) mu_j[d] = __shfl_sync(~0u, mu_r[d], slot);
      const float r_j = __shfl_sync(~0u, r_r, slot);
      if (!in) return false;
      const float* c = ctr_geo + (long long)i * cols;
#pragma unroll
      for (int d = 0; d < D; ++d) mu_i[d] = c[d];
      dgs::agg_offset<D>(mu_j, mu_i, do_wrap, period, X);
      return dgs::agg_candidate<D>(X, c[D], r_j);
    };
    auto body = [&](int slot, int i, float* p) {
      const long long j = row0 + slot;
      const float* c = ctr_geo + (long long)i * cols;
      const float* g = gpre + (long long)i * L;
      float mu_i[D], mu_j[D], X[D], con[TRI], a[D], G = 0.0f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        mu_i[d] = c[d];
        mu_j[d] = ent_geo[d * Ep + j];
      }
#pragma unroll
      for (int t = 0; t < TRI; ++t) con[t] = ent_geo[(D + t) * Ep + j];
      dgs::agg_offset<D>(mu_j, mu_i, do_wrap, period, X);
      if (!dgs::pair_power<D>(X, con, a, G)) G = 0.0f;
      float w = 0.0f, gdotf = 0.0f;
      for (int k = 0; k < K; ++k)
        w = fmaf(c[D + 3 + k], ent_fk[(L + k) * Ep + j], w);
      for (int l = 0; l < L; ++l)
        gdotf = fmaf(g[l], ent_fk[l * Ep + j], gdotf);
      const float inv_norm = c[D + 1];
      float Xn[D], emb, fac;
#pragma unroll
      for (int d = 0; d < D; ++d) Xn[d] = X[d] * inv_norm;
      dgs::agg_code<D, LADDER>(Xn, s_dt, s_dt + 2 * E, nfreq, E, emb, fac);
      const float cf = G * w * fac;
      const float dw = G * (fac * gdotf + emb * gsum[i]);
#pragma unroll
      for (int u = 0; u < RB; ++u) {
        const int r = r0 + u;
        p[u * kPad] =
            r < L ? g[r] * cf : (r < R ? c[D + 3 + r - L] * dw : 0.0f);
      }
    };
    auto store = [&](int slot, int ch, float v) {
      if (ch < RB && r0 + ch < R) dent[(row0 + slot) * R + r0 + ch] = v;
    };
    dgs::warp_sweep<RB>(s_sweep[warp], nrows, lo, hi, cand, body, store);
  }
}

template <int D, int NF, bool LADDER, int KB>
__global__ void __launch_bounds__(kBlock, kCentreBlocks)
    agg_backward_centres_kernel(
    const float* __restrict__ ent_geo,  // (D + tri + 1, Ep)
    const float* __restrict__ ent_fk,   // (L + K, Ep)
    long long Ep,
    const float* __restrict__ ctr_geo,  // (Cp, D + 3 + K)
    int cols, long long Cp,
    const int* __restrict__ ctr_ent,    // (2, Cp): entry range of each centre
    const float* __restrict__ dtf,      // (2E + NF,)
    const float* __restrict__ gpre,     // (Cp, L)
    const float* __restrict__ gsum,     // (Cp,)
    int L, int K, int E, int do_wrap, float period, int rows,
    float* __restrict__ dctr) {         // (Cp, K + 2E + NF)
  constexpr int TRI = dgs::tri_size(D);
  constexpr int NACC = 4 * D * NF + 2 + NF;
  constexpr int W = KB + NACC;
  static_assert(kWarps * sizeof(dgs::SweepScratch<W>) +
                        kMaxCode * sizeof(float) <= 48 * 1024,
                "shared memory must stay under 48 KB");
  __shared__ dgs::SweepScratch<W> s_sweep[kWarps];
  extern __shared__ float s_dt[];
  load_code(dtf, 2 * E + NF, s_dt);

  const int warp = threadIdx.x / dgs::kSweepWarp;
  const int lane = threadIdx.x % dgs::kSweepWarp;
  const long long row0 = ((long long)blockIdx.x * kWarps + warp) * rows;
  if (row0 >= Cp) return;
  const int nrows = (int)min((long long)rows, Cp - row0);
  const int S = K + 2 * E + NF;
  float mu_r[D], r_r = 0.0f;
  int lo = 0, hi = 0;
  if (lane < nrows) {
    const long long i = row0 + lane;
#pragma unroll
    for (int d = 0; d < D; ++d) mu_r[d] = ctr_geo[i * cols + d];
    r_r = ctr_geo[i * cols + D];
    lo = ctr_ent[i];
    hi = ctr_ent[Cp + i];
  } else {
#pragma unroll
    for (int d = 0; d < D; ++d) mu_r[d] = 0.0f;
  }

  for (int k0 = 0; k0 < K; k0 += KB) {
    auto cand = [&](bool in, int slot, int j) {
      float mu_i[D], mu_j[D], X[D];
#pragma unroll
      for (int d = 0; d < D; ++d) mu_i[d] = __shfl_sync(~0u, mu_r[d], slot);
      const float r_i = __shfl_sync(~0u, r_r, slot);
      if (!in) return false;
#pragma unroll
      for (int d = 0; d < D; ++d) mu_j[d] = ent_geo[d * Ep + j];
      dgs::agg_offset<D>(mu_j, mu_i, do_wrap, period, X);
      return dgs::agg_candidate<D>(X, r_i, ent_geo[(D + TRI) * Ep + j]);
    };
    auto body = [&](int slot, int j, float* p) {
      const long long i = row0 + slot;
      const float* c = ctr_geo + i * cols;
      const float* g = gpre + i * L;
      float mu_i[D], mu_j[D], X[D], con[TRI], a[D], G = 0.0f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        mu_i[d] = c[d];
        mu_j[d] = ent_geo[d * Ep + j];
      }
#pragma unroll
      for (int t = 0; t < TRI; ++t) con[t] = ent_geo[(D + t) * Ep + j];
      dgs::agg_offset<D>(mu_j, mu_i, do_wrap, period, X);
      if (!dgs::pair_power<D>(X, con, a, G)) G = 0.0f;
      float w = 0.0f, gdotf = 0.0f;
      for (int k = 0; k < K; ++k)
        w = fmaf(c[D + 3 + k], ent_fk[(L + k) * Ep + j], w);
      for (int l = 0; l < L; ++l)
        gdotf = fmaf(g[l], ent_fk[l * Ep + j], gdotf);
      const float inv_norm = c[D + 1], gs = gsum[i];
      float Xn[D], emb, fac, sn[D * NF], cs[D * NF];
#pragma unroll
      for (int d = 0; d < D; ++d) Xn[d] = X[d] * inv_norm;
      dgs::agg_code_terms<D, NF, LADDER>(Xn, s_dt, s_dt + 2 * E, E, emb, fac,
                                         sn, cs);
      const float dw = G * (fac * gdotf + emb * gs);
#pragma unroll
      for (int k = 0; k < KB; ++k)
        p[k * kPad] = k0 + k < K ? ent_fk[(L + k0 + k) * Ep + j] * dw : 0.0f;
      if (k0 == 0) {
        const float cw = G * w;
        dgs::code_contrib<D, NF>(Xn, s_dt, E, cw * gs, cw * gdotf, sn, cs,
                                 p + KB * kPad, kPad);
      }
    };
    auto store = [&](int slot, int ch, float v) {
      float* row = dctr + (row0 + slot) * S;
      if (ch < KB) {
        if (k0 + ch < K) row[k0 + ch] = v;
      } else if (ch < W && k0 == 0) {
        row[K + dgs::code_column<D, NF>(ch - KB, E)] = v;
      }
    };
    dgs::warp_sweep<W>(s_sweep[warp], nrows, lo, hi, cand, body, store);
  }
}

long long grid_of(long long n_rows, int rows) {
  const long long per_block = (long long)kWarps * rows;
  return (n_rows + per_block - 1) / per_block;
}

template <int D, bool LADDER, int RB>
cudaError_t launch_entries(const float* ent_geo, const float* ent_fk,
                           long long Ep, const float* ctr_geo, int cols,
                           long long Cp, const int* ent_ctr, const float* dtf,
                           const float* gpre, const float* gsum, int L, int K,
                           int nfreq, int E, int do_wrap, float period,
                           int rows, float* dent, cudaStream_t stream) {
  const size_t bytes = sizeof(float) * (size_t)(2 * E + nfreq);
  agg_backward_entries_kernel<D, LADDER, RB>
      <<<(unsigned)grid_of(Ep, rows), kBlock, bytes, stream>>>(
          ent_geo, ent_fk, Ep, ctr_geo, cols, Cp, ent_ctr, dtf, gpre, gsum, L,
          K, nfreq, E, do_wrap, period, rows, dent);
  return cudaGetLastError();
}

template <int D, int NF, bool LADDER, int KB>
cudaError_t launch_centres(const float* ent_geo, const float* ent_fk,
                           long long Ep, const float* ctr_geo, int cols,
                           long long Cp, const int* ctr_ent, const float* dtf,
                           const float* gpre, const float* gsum, int L, int K,
                           int E, int do_wrap, float period, int rows,
                           float* dctr, cudaStream_t stream) {
  const size_t bytes = sizeof(float) * (size_t)(2 * E + NF);
  agg_backward_centres_kernel<D, NF, LADDER, KB>
      <<<(unsigned)grid_of(Cp, rows), kBlock, bytes, stream>>>(
          ent_geo, ent_fk, Ep, ctr_geo, cols, Cp, ctr_ent, dtf, gpre, gsum, L,
          K, E, do_wrap, period, rows, dctr);
  return cudaGetLastError();
}

bool bad_shape(int n, int L, int K, int cols, int D, int rows, int ndt) {
  return n < 1 || L < 1 || K < 1 || cols != D + 3 + K || rows < 1 ||
         rows > dgs::kSweepWarp || ndt > kMaxCode;
}

}  // namespace

extern "C" {

// Highest nfreq the centre-major kernel is instantiated for.
int dgs_agg_backward_max_nfreq() { return 4; }

// Entry-major sweep: launches on `stream` and returns the CUDA error of the
// launch (0 = launched); `rows` (1 to 32) entries a warp.  L + K <= 8 runs
// the 8-row instantiation, larger the 16-row one (in passes of 16 above
// that).
int dgs_agg_backward_entries(const void* ent_geo, const void* ent_fk, int Ep,
                             const void* ctr_geo, int cols, int Cp,
                             const void* ent_ctr, const void* dtf,
                             const void* gpre, const void* gsum, int D, int L,
                             int K, int nfreq, int E, int do_wrap,
                             float period, int ladder, int rows, void* dent,
                             void* stream) {
  if (nfreq < 0 || bad_shape(Ep, L, K, cols, D, rows, 2 * E + nfreq))
    return (int)cudaErrorInvalidValue;
  const auto* g = static_cast<const float*>(ent_geo);
  const auto* fk = static_cast<const float*>(ent_fk);
  const auto* c = static_cast<const float*>(ctr_geo);
  const auto* r = static_cast<const int*>(ent_ctr);
  const auto* dt = static_cast<const float*>(dtf);
  const auto* gp = static_cast<const float*>(gpre);
  const auto* gs = static_cast<const float*>(gsum);
  auto* o = static_cast<float*>(dent);
  auto st = static_cast<cudaStream_t>(stream);
  switch (D * 4 + (ladder ? 2 : 0) + (L + K > 8 ? 1 : 0)) {
#define DGS_CASE(DD, LAD, WIDE)                                              \
  case DD * 4 + LAD * 2 + WIDE:                                              \
    return (int)launch_entries<DD, (LAD != 0), (WIDE ? 16 : 8)>(             \
        g, fk, Ep, c, cols, Cp, r, dt, gp, gs, L, K, nfreq, E, do_wrap,      \
        period, rows, o, st);
#define DGS_DIM(DD) \
  DGS_CASE(DD, 0, 0) DGS_CASE(DD, 0, 1) DGS_CASE(DD, 1, 0) DGS_CASE(DD, 1, 1)
    DGS_DIM(1) DGS_DIM(2) DGS_DIM(3)
#undef DGS_DIM
#undef DGS_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Centre-major sweep: launches on `stream` and returns the CUDA error of
// the launch (0 = launched); `rows` (1 to 32) centres a warp.  Every
// column of `dctr` is written.  nfreq outside
// 1..dgs_agg_backward_max_nfreq() is refused.  K <= 4 runs the
// 4-query instantiation, larger K the 8-query one (in passes of 8 above
// that).
int dgs_agg_backward_centres(const void* ent_geo, const void* ent_fk, int Ep,
                             const void* ctr_geo, int cols, int Cp,
                             const void* ctr_ent, const void* dtf,
                             const void* gpre, const void* gsum, int D, int L,
                             int K, int nfreq, int E, int do_wrap,
                             float period, int ladder, int rows, void* dctr,
                             void* stream) {
  if (nfreq < 1 || nfreq > 4 ||
      bad_shape(Cp, L, K, cols, D, rows, 2 * E + nfreq))
    return (int)cudaErrorInvalidValue;
  const auto* g = static_cast<const float*>(ent_geo);
  const auto* fk = static_cast<const float*>(ent_fk);
  const auto* c = static_cast<const float*>(ctr_geo);
  const auto* r = static_cast<const int*>(ctr_ent);
  const auto* dt = static_cast<const float*>(dtf);
  const auto* gp = static_cast<const float*>(gpre);
  const auto* gs = static_cast<const float*>(gsum);
  auto* o = static_cast<float*>(dctr);
  auto st = static_cast<cudaStream_t>(stream);
  switch (D * 16 + (nfreq - 1) * 4 + (ladder ? 2 : 0) + (K > 4 ? 1 : 0)) {
#define DGS_CASE(DD, NF, LAD, WIDE)                                          \
  case DD * 16 + (NF - 1) * 4 + LAD * 2 + WIDE:                              \
    return (int)launch_centres<DD, NF, (LAD != 0), (WIDE ? 8 : 4)>(          \
        g, fk, Ep, c, cols, Cp, r, dt, gp, gs, L, K, E, do_wrap, period,     \
        rows, o, st);
#define DGS_FREQ(DD, NF)                                                 \
  DGS_CASE(DD, NF, 0, 0) DGS_CASE(DD, NF, 0, 1) DGS_CASE(DD, NF, 1, 0)   \
  DGS_CASE(DD, NF, 1, 1)
#define DGS_DIM(DD) \
  DGS_FREQ(DD, 1) DGS_FREQ(DD, 2) DGS_FREQ(DD, 3) DGS_FREQ(DD, 4)
    DGS_DIM(1) DGS_DIM(2) DGS_DIM(3)
#undef DGS_DIM
#undef DGS_FREQ
#undef DGS_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
