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
// order, so the simple deterministic design is two kernels in this source:
//
//   * entry-major (agg_backward_entries_kernel): one thread per tile-sorted
//     entry over the centre range of its tile, as tiled_backward.cu.  The
//     block's contiguous centre range is staged through shared memory
//     (geometry, cotangent rows, query rows); a thread's own L + K feature
//     and key values ride a shared-memory column (runtime sizes) and its
//     L + K output rows are taken RB at a time in registers (RB is 8 or 16,
//     the wrapper's pick, so L + K <= 16 is one pass).  Output (L + K, Ep),
//     written coalesced; the caller segment-sums the columns by Gaussian id.
//   * centre-major (agg_backward_centres_kernel): one thread per tile-sorted
//     centre over its tile's entry range, as agg_forward.cu.  A thread keeps
//     KB query accumulators and the 4 D nfreq + 2 + nfreq code accumulators
//     in registers, which needs D and nfreq at compile time (nfreq 1 to 4
//     are built); its own queries and cotangent ride a shared-memory column.
//     Output (Cp, K + 2E + nfreq), one row per centre; the caller un-sorts
//     the query columns and sums the code columns over centres.
//
// Every thread writes its own rows once: no atomics, and two runs agree
// bitwise.  Both kernels recompute the pair's geometry, weight and code;
// fusing them into one sweep is later work.
//
// What bounds it.  Per colliding pair each kernel pays the forward's work
// (the K-term dot product, the code's sin / cos) plus an L-term dot product
// and its accumulators: L + K FMAs entry-major, K + 6 D nfreq centre-major.
// Bound by fp32 and special-function issue, not by device memory.
//
// Built by dgs_tpu_torch/kernels/_build.py (nvcc, sm_90a, plain C ABI,
// ctypes).  Never with --use_fast_math (see agg_math.cuh).
#include <cuda_runtime.h>

#include "agg_math.cuh"

namespace {

constexpr int kBlock = 128;   // rows per block, one per thread (both kernels)
constexpr int kChunkC = 64;   // centres staged per chunk, entry-major
constexpr int kChunkE = 128;  // entries staged per chunk, centre-major

template <int D, bool LADDER, int RB>
__global__ void __launch_bounds__(kBlock) agg_backward_entries_kernel(
    const float* __restrict__ ent_geo,  // (D + tri + 1, Ep): mu', conic, r
    const float* __restrict__ ent_fk,   // (L + K, Ep): features, keys
    long long Ep,
    const float* __restrict__ ctr_geo,  // (Cp, D + 3 + K)
    int cols, long long Cp,
    const int* __restrict__ ent_ctr,    // (2, Ep): centre range of each entry
    const float* __restrict__ dtf,      // (2E + nfreq,)
    const float* __restrict__ gpre,     // (Cp, L) cotangent, inv_tot-scaled
    const float* __restrict__ gsum,     // (Cp,) its channel sum
    int L, int K, int nfreq, int E, int do_wrap, float period,
    float* __restrict__ dent) {         // (L + K, Ep)
  constexpr int TRI = dgs::tri_size(D);
  extern __shared__ float smem[];
  const int ndt = 2 * E + nfreq, R = L + K;
  float* s_dt = smem;                     // ndt
  float* s_own = s_dt + ndt;              // R x kBlock: own features, keys
  float* s_ctr = s_own + R * kBlock;      // (D + 3) x kChunkC: mu, r,
                                          //   inv_norm, gsum
  float* s_gq = s_ctr + (D + 3) * kChunkC;  // R x kChunkC: cotangent, queries
  __shared__ int s_range[2];

  const int tid = threadIdx.x;
  const long long j = (long long)blockIdx.x * kBlock + tid;
  const bool live = j < Ep;
  float mu_j[D], con[TRI], r_j = 0.0f;
  int lo = 0, hi = 0;
#pragma unroll
  for (int d = 0; d < D; ++d) mu_j[d] = live ? ent_geo[d * Ep + j] : 0.0f;
#pragma unroll
  for (int t = 0; t < TRI; ++t)
    con[t] = live ? ent_geo[(D + t) * Ep + j] : 0.0f;
  if (live) {
    r_j = ent_geo[(D + TRI) * Ep + j];
    lo = ent_ctr[j];
    hi = ent_ctr[Ep + j];
  }
  for (int r = 0; r < R; ++r)
    s_own[r * kBlock + tid] = live ? ent_fk[r * Ep + j] : 0.0f;
  for (int t = tid; t < ndt; t += kBlock) s_dt[t] = dtf[t];
  int blo, bhi;
  dgs::block_range(lo, hi, s_range, blo, bhi);  // also publishes s_dt

  for (int r0 = 0; r0 < R; r0 += RB) {
    float acc[RB];
#pragma unroll
    for (int u = 0; u < RB; ++u) acc[u] = 0.0f;

    for (int c0 = blo; c0 < bhi; c0 += kChunkC) {
      const int n = min(kChunkC, bhi - c0);
      __syncthreads();  // the previous chunk is fully consumed
      for (int t = tid; t < n * (D + 2); t += kBlock) {
        const int c = t / (D + 2), col = t % (D + 2);
        s_ctr[col * kChunkC + c] = ctr_geo[(long long)(c0 + c) * cols + col];
      }
      for (int t = tid; t < n; t += kBlock)
        s_ctr[(D + 2) * kChunkC + t] = gsum[c0 + t];
      for (int t = tid; t < n * L; t += kBlock) {
        const int c = t / L, l = t % L;
        s_gq[l * kChunkC + c] = gpre[(long long)(c0 + c) * L + l];
      }
      for (int t = tid; t < n * K; t += kBlock) {
        const int c = t / K, k = t % K;
        s_gq[(L + k) * kChunkC + c] =
            ctr_geo[(long long)(c0 + c) * cols + D + 3 + k];
      }
      __syncthreads();
      const int i0 = max(lo - c0, 0), i1 = min(hi - c0, n);
      for (int i = i0; i < i1; ++i) {
        float mu_i[D], X[D], G;
#pragma unroll
        for (int d = 0; d < D; ++d) mu_i[d] = s_ctr[d * kChunkC + i];
        dgs::agg_offset<D>(mu_j, mu_i, do_wrap, period, X);
        if (!dgs::agg_density<D>(X, con, s_ctr[D * kChunkC + i], r_j, G))
          continue;
        const float w = dgs::dot_strided(s_gq + L * kChunkC + i, kChunkC,
                                         s_own + L * kBlock + tid, kBlock, K);
        const float gdotf =
            dgs::dot_strided(s_gq + i, kChunkC, s_own + tid, kBlock, L);
        const float inv_norm = s_ctr[(D + 1) * kChunkC + i];
        float Xn[D], emb, fac;
#pragma unroll
        for (int d = 0; d < D; ++d) Xn[d] = X[d] * inv_norm;
        dgs::agg_code<D, LADDER>(Xn, s_dt, s_dt + 2 * E, nfreq, E, emb, fac);
        const float cf = G * w * fac;
        const float dw =
            G * (fac * gdotf + emb * s_ctr[(D + 2) * kChunkC + i]);
#pragma unroll
        for (int u = 0; u < RB; ++u) {
          const int r = r0 + u;
          if (r < R)
            acc[u] = fmaf(s_gq[r * kChunkC + i], r < L ? cf : dw, acc[u]);
        }
      }
    }

    if (live) {
#pragma unroll
      for (int u = 0; u < RB; ++u)
        if (r0 + u < R) dent[(long long)(r0 + u) * Ep + j] = acc[u];
    }
  }
}

template <int D, int NF, bool LADDER, int KB>
__global__ void __launch_bounds__(kBlock) agg_backward_centres_kernel(
    const float* __restrict__ ent_geo,  // (D + tri + 1, Ep)
    const float* __restrict__ ent_fk,   // (L + K, Ep)
    long long Ep,
    const float* __restrict__ ctr_geo,  // (Cp, D + 3 + K)
    int cols, long long Cp,
    const int* __restrict__ ctr_ent,    // (2, Cp): entry range of each centre
    const float* __restrict__ dtf,      // (2E + NF,)
    const float* __restrict__ gpre,     // (Cp, L)
    const float* __restrict__ gsum,     // (Cp,)
    int L, int K, int E, int do_wrap, float period,
    float* __restrict__ dctr) {         // (Cp, K + 2E + NF), zeroed
  constexpr int TRI = dgs::tri_size(D);
  constexpr int GEO = D + TRI + 1;
  constexpr int NACC = 4 * D * NF + 2 + NF;
  extern __shared__ float smem[];
  const int ndt = 2 * E + NF, R = L + K, S = K + 2 * E + NF;
  float* s_dt = smem;                    // ndt
  float* s_own = s_dt + ndt;             // R x kBlock: own cotangent, queries
  float* s_geo = s_own + R * kBlock;     // GEO x kChunkE
  float* s_fk = s_geo + GEO * kChunkE;   // R x kChunkE: features, keys
  __shared__ int s_range[2];

  const int tid = threadIdx.x;
  const long long i = (long long)blockIdx.x * kBlock + tid;
  const bool live = i < Cp;
  float mu[D], r_i = 0.0f, inv_norm = 0.0f, gs = 0.0f;
  int lo = 0, hi = 0;
#pragma unroll
  for (int d = 0; d < D; ++d) mu[d] = live ? ctr_geo[i * cols + d] : 0.0f;
  if (live) {
    r_i = ctr_geo[i * cols + D];
    inv_norm = ctr_geo[i * cols + D + 1];
    gs = gsum[i];
    lo = ctr_ent[i];
    hi = ctr_ent[Cp + i];
  }
  for (int l = 0; l < L; ++l)
    s_own[l * kBlock + tid] = live ? gpre[i * L + l] : 0.0f;
  for (int k = 0; k < K; ++k)
    s_own[(L + k) * kBlock + tid] =
        live ? ctr_geo[i * cols + D + 3 + k] : 0.0f;
  for (int t = tid; t < ndt; t += kBlock) s_dt[t] = dtf[t];
  int blo, bhi;
  dgs::block_range(lo, hi, s_range, blo, bhi);  // also publishes s_dt

  for (int k0 = 0; k0 < K; k0 += KB) {
    float accq[KB], acc[NACC];
#pragma unroll
    for (int k = 0; k < KB; ++k) accq[k] = 0.0f;
#pragma unroll
    for (int t = 0; t < NACC; ++t) acc[t] = 0.0f;

    for (int e0 = blo; e0 < bhi; e0 += kChunkE) {
      const int n = min(kChunkE, bhi - e0);
      __syncthreads();  // the previous chunk is fully consumed
      for (int j = tid; j < n; j += kBlock) {
        const long long e = (long long)e0 + j;
#pragma unroll
        for (int r = 0; r < GEO; ++r)
          s_geo[r * kChunkE + j] = ent_geo[r * Ep + e];
        for (int r = 0; r < R; ++r) s_fk[r * kChunkE + j] = ent_fk[r * Ep + e];
      }
      __syncthreads();
      const int j0 = max(lo - e0, 0), j1 = min(hi - e0, n);
      for (int j = j0; j < j1; ++j) {
        float mu_j[D], X[D], con[TRI], G;
#pragma unroll
        for (int d = 0; d < D; ++d) mu_j[d] = s_geo[d * kChunkE + j];
        dgs::agg_offset<D>(mu_j, mu, do_wrap, period, X);
#pragma unroll
        for (int t = 0; t < TRI; ++t) con[t] = s_geo[(D + t) * kChunkE + j];
        if (!dgs::agg_density<D>(X, con, r_i, s_geo[(D + TRI) * kChunkE + j],
                                 G))
          continue;
        const float w = dgs::dot_strided(s_own + L * kBlock + tid, kBlock,
                                         s_fk + L * kChunkE + j, kChunkE, K);
        const float gdotf =
            dgs::dot_strided(s_own + tid, kBlock, s_fk + j, kChunkE, L);
        float Xn[D], emb, fac, sn[D * NF], cs[D * NF];
#pragma unroll
        for (int d = 0; d < D; ++d) Xn[d] = X[d] * inv_norm;
        dgs::agg_code_terms<D, NF, LADDER>(Xn, s_dt, s_dt + 2 * E, E, emb, fac,
                                           sn, cs);
        const float dw = G * (fac * gdotf + emb * gs);
#pragma unroll
        for (int k = 0; k < KB; ++k)
          if (k0 + k < K)
            accq[k] = fmaf(s_fk[(L + k0 + k) * kChunkE + j], dw, accq[k]);
        if (k0 == 0) {
          const float cw = G * w;
          dgs::agg_code_partials<D, NF>(Xn, s_dt, E, cw * gs, cw * gdotf, sn,
                                        cs, acc);
        }
      }
    }

    if (live) {
      float* row = dctr + i * S;
#pragma unroll
      for (int k = 0; k < KB; ++k)
        if (k0 + k < K) row[k0 + k] = accq[k];
      if (k0 == 0) dgs::agg_code_store<D, NF>(acc, E, row + K, row + K + 2 * E);
    }
  }
}

template <int D, bool LADDER, int RB>
cudaError_t launch_entries(const float* ent_geo, const float* ent_fk,
                           long long Ep, const float* ctr_geo, int cols,
                           long long Cp, const int* ent_ctr, const float* dtf,
                           const float* gpre, const float* gsum, int L, int K,
                           int nfreq, int E, int do_wrap, float period,
                           float* dent, cudaStream_t stream) {
  const size_t bytes =
      sizeof(float) * ((size_t)(2 * E + nfreq) + (size_t)(L + K) * kBlock +
                       (size_t)(D + 3 + L + K) * kChunkC);
  auto kernel = agg_backward_entries_kernel<D, LADDER, RB>;
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((unsigned)((Ep + kBlock - 1) / kBlock)), block(kBlock);
  kernel<<<grid, block, bytes, stream>>>(ent_geo, ent_fk, Ep, ctr_geo, cols,
                                         Cp, ent_ctr, dtf, gpre, gsum, L, K,
                                         nfreq, E, do_wrap, period, dent);
  return cudaGetLastError();
}

template <int D, int NF, bool LADDER, int KB>
cudaError_t launch_centres(const float* ent_geo, const float* ent_fk,
                           long long Ep, const float* ctr_geo, int cols,
                           long long Cp, const int* ctr_ent, const float* dtf,
                           const float* gpre, const float* gsum, int L, int K,
                           int E, int do_wrap, float period, float* dctr,
                           cudaStream_t stream) {
  constexpr int GEO = D + dgs::tri_size(D) + 1;
  const size_t bytes =
      sizeof(float) * ((size_t)(2 * E + NF) + (size_t)(L + K) * kBlock +
                       (size_t)(GEO + L + K) * kChunkE);
  auto kernel = agg_backward_centres_kernel<D, NF, LADDER, KB>;
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((unsigned)((Cp + kBlock - 1) / kBlock)), block(kBlock);
  kernel<<<grid, block, bytes, stream>>>(ent_geo, ent_fk, Ep, ctr_geo, cols,
                                         Cp, ctr_ent, dtf, gpre, gsum, L, K,
                                         E, do_wrap, period, dctr);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Highest nfreq the centre-major kernel is instantiated for.
int dgs_agg_backward_max_nfreq() { return 4; }

// Entry-major sweep: launches on `stream` and returns the CUDA error of the
// launch (0 = launched).  L + K <= 8 runs the 8-row instantiation, larger
// the 16-row one (in passes of 16 above that).
int dgs_agg_backward_entries(const void* ent_geo, const void* ent_fk, int Ep,
                             const void* ctr_geo, int cols, int Cp,
                             const void* ent_ctr, const void* dtf,
                             const void* gpre, const void* gsum, int D, int L,
                             int K, int nfreq, int E, int do_wrap,
                             float period, int ladder, void* dent,
                             void* stream) {
  if (Ep < 1 || L < 1 || K < 1 || nfreq < 0 || cols != D + 3 + K)
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
        period, o, st);
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
// the launch (0 = launched).  `dctr` must arrive zeroed.  nfreq outside
// 1..dgs_agg_backward_max_nfreq() is refused.  K <= 4 runs the
// 4-accumulator instantiation, larger K the 8-accumulator one (in passes of
// 8 above that).
int dgs_agg_backward_centres(const void* ent_geo, const void* ent_fk, int Ep,
                             const void* ctr_geo, int cols, int Cp,
                             const void* ctr_ent, const void* dtf,
                             const void* gpre, const void* gsum, int D, int L,
                             int K, int nfreq, int E, int do_wrap,
                             float period, int ladder, void* dctr,
                             void* stream) {
  if (Cp < 1 || L < 1 || K < 1 || cols != D + 3 + K)
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
  if (nfreq < 1 || nfreq > 4) return (int)cudaErrorInvalidValue;
  switch (D * 16 + (nfreq - 1) * 4 + (ladder ? 2 : 0) + (K > 4 ? 1 : 0)) {
#define DGS_CASE(DD, NF, LAD, WIDE)                                          \
  case DD * 16 + (NF - 1) * 4 + LAD * 2 + WIDE:                              \
    return (int)launch_centres<DD, NF, (LAD != 0), (WIDE ? 8 : 4)>(          \
        g, fk, Ep, c, cols, Cp, r, dt, gp, gs, L, K, E, do_wrap, period, o,  \
        st);
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
