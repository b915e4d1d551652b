// Per-centre total neighbour density of the aggregation subsystem, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel dgs_tpu/kernels/aggregate.py::totals
// (_totals_kernel).  Same contract: for every tile-sorted centre i, the sum
// over the entries j on the centre's tile of G_ij, the neighbour's density
// on the offset X = mu_j' - mu_i, zero outside the collision mask (both
// radii alive, |X|^2 <= (r_i + r_j)^2) and where the quadratic form is
// positive.  Output (Cp, 1) fp32; pad and sentinel centres (radius 0, empty
// range) come back zero.
//
// Design.  One thread owns one tile-sorted centre, a block owns kBlock
// consecutive centres.  Each centre carries the entry range [lo, hi) of its
// tile; because centres and entries are both sorted by tile, the union of a
// block's ranges is one contiguous range, which the block stages through
// shared memory in chunks of kChunk entries: a 16-byte record (mean',
// radius) for the candidate test, the conic apart for the density.  A lane
// tests the entries of its own part of the chunk kLanes at a time (a
// warp-wide broadcast where the warp's centres share a tile) with the cheap
// test alone (agg_candidate's rounded distance test, without a branch).  The
// passing (entry, lane) pairs go into the warp's queue in shared memory
// (__ballot_sync / __popc, in step and lane order); whenever 32 wait, and at
// the end of a chunk, every lane takes one queued pair and runs the density
// (agg_density: the mask again, the quadratic form and the accurate expf),
// so the density runs on full warps instead of on the one or two lanes of a
// step that collide.  Each owner then adds its pairs' densities in queue
// order (__match_any_sync finds them), which for a centre is ascending
// entry order, the order of the one-thread-a-centre loop it replaces: the
// sums have one fixed order, no atomics, and two runs agree bitwise.
//
// What bounds it.  Per candidate pair: the record's broadcast load, D
// subtractions and the distance test; per colliding pair D*D FMAs and one
// accurate expf.  About 10^7 (aggregation point) to 10^8 (dynamics shapes)
// candidate pairs at 100,000 Gaussians: the candidate steps and the drains
// take the time (on an H100 80GB HBM3 at 700 W, the test loop alone is
// about 45% of it at the dynamics shapes), not device memory.  Measured and
// dropped: the warp sweep of agg_sweep.cuh with the density as its body
// (operands through L1: slower at both shapes), two candidates a lane a
// step, two queued pairs a lane a drain, and each owner's sum by 32
// shuffles.
//
// Built by dgs_tpu_torch/kernels/_build.py (nvcc, sm_90a, plain C ABI,
// ctypes).  Never with --use_fast_math (see agg_math.cuh).
#include <cuda_runtime.h>

#include "agg_math.cuh"

namespace {

constexpr int kWarp = 32;
constexpr int kBlock = 128;  // tile-sorted centres per block, one per thread
constexpr int kWarps = kBlock / kWarp;
// Blocks an SM that ptxas must fit (48-72 registers, no spills): 100,000
// centres are 782 blocks, one wave on 132 SMs at six.
constexpr int kMinBlocks = 6;
constexpr int kChunk = 512;  // entries staged per shared-memory chunk
constexpr int kLanes = 4;    // candidates a lane tests in one step
// A warp's queue: a ring over the 31 pairs that may wait after a drain and
// the kLanes * 32 that one step may push.
constexpr int kQueue = 256;
static_assert((kQueue & (kQueue - 1)) == 0 &&
                  kQueue >= kWarp - 1 + kLanes * kWarp,
              "the queue is a ring over the waiting and the pushed pairs");

// One block's staged chunk of entries and its warps' queues.
template <int D>
struct Staged {
  float4 rec[kChunk];                  // mean' (D values, zero-padded), r
  float con[dgs::tri_size(D)][kChunk]; // packed conic
  // (chunk index << 5) | owning lane; then one slot a lane past the ring
  // for the lanes without a pair to push.
  int queue[kWarps][kQueue + kWarp];
  float g[kWarps][kWarp];              // a drain's densities, by lane
  unsigned mask[kWarps][kWarp];        // a drain's lanes, by owner
};

// agg_candidate's test, each product and sum rounded as it rounds them,
// with its conditions joined without a branch.
template <int D>
__device__ __forceinline__ bool candidate(const float (&X)[D], float r_i,
                                          float r_j) {
  float dist2 = 0.0f;
#pragma unroll
  for (int d = 0; d < D; ++d)
    dist2 = dgs::add_rn(dist2, dgs::mul_rn(X[d], X[d]));
  const float rr = dgs::add_rn(r_i, r_j);
  return (r_j >= dgs::kAggAlive) & (r_i >= dgs::kAggAlive) &
         (dist2 <= dgs::mul_rn(rr, rr));
}

// The offset of a staged record's mean from mu, wrapped with WRAP.
template <int D, bool WRAP>
__device__ __forceinline__ void offset(const float4& rec,
                                       const float (&mu)[D], float period,
                                       float (&X)[D]) {
  const float xyz[3] = {rec.x, rec.y, rec.z};
  float m[D];
#pragma unroll
  for (int d = 0; d < D; ++d) m[d] = xyz[d];
  dgs::agg_offset<D>(m, mu, WRAP ? 1 : 0, period, X);
}

template <int D, bool WRAP>
__global__ void __launch_bounds__(kBlock, kMinBlocks) agg_totals_kernel(
    const float* __restrict__ ent_geo,  // (D + tri + 1, Ep): mu', conic, r
    long long Ep,
    const float* __restrict__ ctr_geo,  // (Cp, cols): mu, r, inv_norm, ...
    int cols, long long Cp,
    const int* __restrict__ ctr_ent,    // (2, Cp): entry range of each centre
    float period,
    float* __restrict__ out) {          // (Cp,)
  constexpr int TRI = dgs::tri_size(D);
  constexpr unsigned kAll = 0xffffffffu;
  static_assert(D >= 1 && D <= 3, "a record holds three mean coordinates");
  __shared__ Staged<D> s;
  __shared__ int s_range[2];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const unsigned below = (1u << lane) - 1;   // the lanes before this one
  int* queue = s.queue[warp];

  const long long i = (long long)blockIdx.x * kBlock + threadIdx.x;
  const bool live = i < Cp;
  float mu[D], r_i = 0.0f;
  int lo = 0, hi = 0;
  if (live) {
#pragma unroll
    for (int d = 0; d < D; ++d) mu[d] = ctr_geo[i * cols + d];
    r_i = ctr_geo[i * cols + D];
    lo = ctr_ent[i];
    hi = ctr_ent[Cp + i];
  } else {
#pragma unroll
    for (int d = 0; d < D; ++d) mu[d] = 0.0f;
  }
  int blo, bhi;
  dgs::block_range(lo, hi, s_range, blo, bhi);

  float tot = 0.0f;
  for (int e0 = blo; e0 < bhi; e0 += kChunk) {
    const int n_chunk = min(kChunk, bhi - e0);
    __syncthreads();  // the previous chunk is fully consumed
    // Two entries a thread in flight: fully unrolled, the D = 1 wrapped
    // instantiation spilled.
#pragma unroll 2
    for (int j = threadIdx.x; j < n_chunk; j += kBlock) {
      float p[4] = {0.0f, 0.0f, 0.0f, ent_geo[(D + TRI) * Ep + e0 + j]};
#pragma unroll
      for (int d = 0; d < D; ++d) p[d] = ent_geo[d * Ep + e0 + j];
      s.rec[j] = make_float4(p[0], p[1], p[2], p[3]);
#pragma unroll
      for (int t = 0; t < TRI; ++t)
        s.con[t][j] = ent_geo[(D + t) * Ep + e0 + j];
    }
    __syncthreads();
    const int j0 = max(lo - e0, 0), len = max(min(hi - e0, n_chunk) - j0, 0);
    int steps = len;  // the warp's longest part
#pragma unroll
    for (int o = kWarp / 2; o > 0; o >>= 1)
      steps = max(steps, __shfl_xor_sync(kAll, steps, o));
    int head = 0, count = 0;
    for (int k0 = 0;; k0 += kLanes) {
      const bool more = k0 < steps;
      if (more) {
        // The tests and pushes carry no branch: a lane past its part reads
        // a valid record and drops the result, and a lane without a pair
        // stores to its own slot past the ring.
        bool hit[kLanes];
#pragma unroll
        for (int u = 0; u < kLanes; ++u) {
          const float4 rec = s.rec[min(j0 + k0 + u, kChunk - 1)];
          float X[D];
          offset<D, WRAP>(rec, mu, period, X);
          hit[u] = candidate<D>(X, r_i, rec.w) & (k0 + u < len);
        }
        unsigned mask[kLanes];
#pragma unroll
        for (int u = 0; u < kLanes; ++u) mask[u] = __ballot_sync(kAll, hit[u]);
        int pos = head + count;
#pragma unroll
        for (int u = 0; u < kLanes; ++u) {
          queue[hit[u] ? (pos + __popc(mask[u] & below)) & (kQueue - 1)
                       : kQueue + lane] = ((j0 + k0 + u) << 5) | lane;
          pos += __popc(mask[u]);
        }
        count = pos - head;
      }
      // Drain 32 queued pairs at a time, and the rest once the chunk ends:
      // each lane takes one and runs its density, then every owner adds
      // its pairs' densities in queue order.
      while (count >= kWarp || (!more && count > 0)) {
        const int n = min(count, kWarp);
        __syncwarp();
        const int code = lane < n ? queue[(head + lane) & (kQueue - 1)] : -1;
        const int owner = code < 0 ? kWarp : code & (kWarp - 1);
        float mu_o[D];
#pragma unroll
        for (int d = 0; d < D; ++d)
          mu_o[d] = __shfl_sync(kAll, mu[d], owner & (kWarp - 1));
        const float r_o = __shfl_sync(kAll, r_i, owner & (kWarp - 1));
        float G = 0.0f;
        if (lane < n) {
          const int j = code >> 5;
          const float4 rec = s.rec[j];
          float X[D], con[TRI], g;
          offset<D, WRAP>(rec, mu_o, period, X);
#pragma unroll
          for (int t = 0; t < TRI; ++t) con[t] = s.con[t][j];
          if (dgs::agg_density<D>(X, con, r_o, rec.w, g)) G = g;
        }
        s.g[warp][lane] = G;
        s.mask[warp][lane] = 0u;
        const unsigned group = __match_any_sync(kAll, owner);
        __syncwarp();
        if (lane < n) s.mask[warp][owner] = group;  // one value an owner
        __syncwarp();
        for (unsigned m = s.mask[warp][lane]; m; m &= m - 1)
          tot += s.g[warp][__ffs(m) - 1];
        __syncwarp();  // the drained slots may be pushed again
        head = (head + n) & (kQueue - 1);
        count -= n;
      }
      if (!more) break;
    }
  }
  if (live) out[i] = tot;
}

}  // namespace

extern "C" {

// Centres per block of the totals kernel; the structure pads its rows to a
// multiple of it.
int dgs_agg_block() { return kBlock; }

// Launches the kernel on `stream` and returns cudaGetLastError() after the
// launch (0 = launched).  Pointers are device pointers; `cols` is the row
// length of ctr_geo.
int dgs_agg_totals(const void* ent_geo, int Ep, const void* ctr_geo, int cols,
                   int Cp, const void* ctr_ent, int D, int do_wrap,
                   float period, void* out, void* stream) {
  if (Cp < 1 || cols < D + 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((Cp + kBlock - 1) / kBlock), block(kBlock);
  const auto* g = static_cast<const float*>(ent_geo);
  const auto* c = static_cast<const float*>(ctr_geo);
  const auto* r = static_cast<const int*>(ctr_ent);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  switch (D * 2 + (do_wrap ? 1 : 0)) {
#define DGS_CASE(DD, W)                                                    \
  case DD * 2 + W:                                                         \
    agg_totals_kernel<DD, (W != 0)><<<grid, block, 0, st>>>(               \
        g, Ep, c, cols, Cp, r, period, o);                                 \
    break;
    DGS_CASE(1, 0) DGS_CASE(1, 1) DGS_CASE(2, 0) DGS_CASE(2, 1)
    DGS_CASE(3, 0) DGS_CASE(3, 1)
#undef DGS_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
