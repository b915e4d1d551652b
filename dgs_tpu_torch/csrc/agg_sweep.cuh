// The warp sweep of the aggregation kernels (agg_forward.cu and both
// kernels of agg_backward.cu): one warp over a few consecutive tile-sorted
// rows of one side, its lanes across the rows' ranges of the other side,
// the colliding pairs compacted into a queue so that the pair body runs on
// full warps.
//
// A warp owns rows [row0, row0 + nrows), nrows <= 32; lane s < nrows holds
// row s's range [lo, hi).  The ranges are concatenated into one index
// space of sum(hi - lo) candidates, 64 a step:
//
//   1. every lane runs the cheap candidate test (the offset, the live radii,
//      the rounded distance test: agg_candidate) on its candidates;
//   2. __ballot_sync / __popc push the passing (row slot, column) pairs into
//      the warp's queue in shared memory, in lane order;
//   3. when the queue holds 32 or more, or the rows end, every lane takes
//      one queued pair and runs the body, which writes the pair's W
//      contributions into a column of the warp's partials;
//   4. lane c then adds channel c of the drained pairs in queue order into
//      its running sum for the current row, and stores the row when the
//      queue moves past it (rows with an empty range store zeros).
//
// A lane tests kSweepLanes candidates a step (32 apart), so that their
// loads are in flight together.  The queue's order and the sums' order are
// fixed by the data, so two runs agree bitwise, with no atomics and no
// block barrier.  A drain of one row's pairs, the common case, adds each
// channel's partials with 16-byte reads; the partials' rows are padded to
// 36 floats, which keeps the body's column writes and those reads free of
// bank conflicts.
//
// The helpers above the device section also compile for the host, so that
// a test can hold them against numpy.
#pragma once

#include "agg_math.cuh"

namespace dgs {

constexpr int kSweepWarp = 32;
constexpr int kSweepLanes = 2;   // candidates a lane tests in one step
// The queue: a power of two above the 31 pairs that may wait after a drain
// plus the kSweepLanes * 32 that one step may push.
constexpr int kSweepQueue = 128;
constexpr int kPartStride = 36;  // floats a channel of the partials
static_assert((kSweepQueue & (kSweepQueue - 1)) == 0 &&
                  kSweepQueue >= kSweepWarp - 1 + kSweepLanes * kSweepWarp,
              "the queue is a ring over the waiting and the pushed pairs");
static_assert(kPartStride % 4 == 0 && kPartStride >= kSweepWarp,
              "a channel's partials are read 4 at a time");

// The ring position of the rank-th pair pushed after `count` waiting pairs
// from `head`.
DGS_HD int queue_pos(int head, int count, int rank) {
  return (head + count + rank) & (kSweepQueue - 1);
}

// The row slot of candidate v of the concatenated ranges: the largest s
// with pre[s] <= v, where pre holds the exclusive prefix sums of the row
// lengths (nrows entries).  The device sweep finds it incrementally with
// shuffles; this is its plain form.
DGS_HD int sweep_slot(const int* pre, int nrows, int v) {
  int s = 0;
  for (int k = 1; k < nrows; ++k)
    if (pre[k] <= v) s = k;
  return s;
}

// The column of dctr (after the K query columns) of code partial t in the
// accumulator layout of agg_code_partials.
template <int D, int NF>
DGS_HD int code_column(int t, int E) {
  constexpr int DN = D * NF;
  if (t < 4 * DN) {
    const int part = t / DN, dn = t % DN;
    const int i0 = (dn / NF) * ((E - 1) / D) + 2 * (dn % NF);
    return (part & 2 ? E : 0) + i0 + (part & 1);
  }
  if (t == 4 * DN) return E - 1;
  if (t == 4 * DN + 1) return 2 * E - 1;
  return 2 * E + (t - 4 * DN - 2);
}

// One pair's code partials (agg_code_partials' layout and arithmetic, from
// zero) written to out[t * stride].
template <int D, int NF>
DGS_HD void code_contrib(const float (&Xn)[D], const float* dt, int E,
                         float cemb, float cfac, const float (&sn)[D * NF],
                         const float (&cs)[D * NF], float* out, int stride) {
  constexpr int DN = D * NF;
  const int st = (E - 1) / D;
#pragma unroll
  for (int d = 0; d < D; ++d) {
#pragma unroll
    for (int e = 0; e < NF; ++e) {
      const int t = d * NF + e;
      const float s = sn[t], c = cs[t];
      out[t * stride] = cemb * s;
      out[(DN + t) * stride] = cemb * c;
      out[(2 * DN + t) * stride] = cfac * s;
      out[(3 * DN + t) * stride] = cfac * c;
    }
  }
  out[4 * DN * stride] = cemb;
  out[(4 * DN + 1) * stride] = cfac;
#pragma unroll
  for (int e = 0; e < NF; ++e) {
    float f = 0.0f;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const int t = d * NF + e, i0 = d * st + 2 * e;
      const float s = sn[t], c = cs[t];
      const float dphase = cemb * (c * dt[i0] - s * dt[i0 + 1]) +
                           cfac * (c * dt[E + i0] - s * dt[E + i0 + 1]);
      f += dphase * (kPi * Xn[d]);
    }
    out[(4 * DN + 2 + e) * stride] = f;
  }
}

#if defined(__CUDACC__)

// A warp's shared memory: the queue and the drained pairs' W partials, a
// row of kPartStride floats a channel (a multiple of 4, so that a lane
// reads four pairs' partials of its channel with one 16-byte load).
template <int W>
struct SweepScratch {
  int col[kSweepQueue];
  int slot[kSweepQueue];
  alignas(16) float part[W][kPartStride];
};

// The sweep of one warp over its rows (the file comment).  All 32 lanes
// call it; lane s < nrows passes row s's [lo, hi).
//   cand(in, slot, col)  -> bool: the candidate test.  Called by every lane
//                           (it may shuffle the row's values from lane
//                           slot); read the column only when `in`.
//   body(slot, col, p)   : the pair's W partials, p[c * kPartStride];
//                           called by the lanes that hold a queued pair.
//   store(slot, c, v)    : row slot's channel c (every lane, c = lane +
//                           32 k; c may be W or more).
template <int W, class Cand, class Body, class Store>
__device__ __forceinline__ void warp_sweep(SweepScratch<W>& sc, int nrows,
                                           int lo, int hi, Cand cand,
                                           Body body, Store store) {
  constexpr unsigned kAll = 0xffffffffu;
  constexpr int NP = (W + kSweepWarp - 1) / kSweepWarp;
  constexpr int kStep = kSweepLanes * kSweepWarp;  // candidates a step
  const int lane = threadIdx.x & (kSweepWarp - 1);
  // Exclusive prefix of the row lengths: lane s holds pre[s]; lanes from
  // nrows on hold the total.
  const int len = lane < nrows ? max(hi - lo, 0) : 0;
  int pre = len;
#pragma unroll
  for (int o = 1; o < kSweepWarp; o <<= 1) {
    const int t = __shfl_up_sync(kAll, pre, o);
    if (lane >= o) pre += t;
  }
  const int total = __shfl_sync(kAll, pre, kSweepWarp - 1);
  pre -= len;

  float run[NP];
#pragma unroll
  for (int p = 0; p < NP; ++p) run[p] = 0.0f;
  int cur = 0;  // the row the running sums belong to

  auto flush_to = [&](int slot) {
    for (; cur < slot; ++cur) {
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        store(cur, lane + p * kSweepWarp, run[p]);
        run[p] = 0.0f;
      }
    }
  };
  auto drain = [&](int head, int n) {
    __syncwarp();
    if (lane < n) {
      const int q = (head + lane) & (kSweepQueue - 1);
      body(sc.slot[q], sc.col[q], &sc.part[0][lane]);
    }
    __syncwarp();
    const int first = sc.slot[head];
    flush_to(first);
    if (n == kSweepWarp &&
        sc.slot[(head + kSweepWarp - 1) & (kSweepQueue - 1)] == first) {
      // One row: each lane adds its channels' 32 partials in queue order.
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        const int c = lane + p * kSweepWarp;
        if (c < W) {
          const float4* row = reinterpret_cast<const float4*>(sc.part[c]);
#pragma unroll
          for (int k = 0; k < kSweepWarp / 4; ++k) {
            const float4 v = row[k];
            run[p] += v.x;
            run[p] += v.y;
            run[p] += v.z;
            run[p] += v.w;
          }
        }
      }
    } else {
      for (int k = 0; k < n; ++k) {
        flush_to(sc.slot[(head + k) & (kSweepQueue - 1)]);
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          const int c = lane + p * kSweepWarp;
          if (c < W) run[p] += sc.part[c][k];
        }
      }
    }
    __syncwarp();
  };

  int head = 0, count = 0, base_slot = 0;
  for (int base = 0; base < total; base += kStep) {
    // Lane l takes candidates base + l, base + 32 + l, ... (kSweepLanes
    // of them), each with its row slot and column.
    int slot[kSweepLanes], col[kSweepLanes];
    bool hit[kSweepLanes];
#pragma unroll
    for (int u = 0; u < kSweepLanes; ++u) slot[u] = base_slot;
    for (int k = base_slot + 1; k < nrows; ++k) {
      const int pk = __shfl_sync(kAll, pre, k);
      if (pk > base + kStep - 1) break;
#pragma unroll
      for (int u = 0; u < kSweepLanes; ++u)
        if (base + u * kSweepWarp + lane >= pk) slot[u] = k;
    }
#pragma unroll
    for (int u = 0; u < kSweepLanes; ++u) {
      const int v = base + u * kSweepWarp + lane;
      col[u] = __shfl_sync(kAll, lo, slot[u]) + v -
               __shfl_sync(kAll, pre, slot[u]);
      hit[u] = v < total;
    }
#pragma unroll
    for (int u = 0; u < kSweepLanes; ++u)
      hit[u] = cand(hit[u], slot[u], col[u]) && hit[u];
#pragma unroll
    for (int u = 0; u < kSweepLanes; ++u) {
      const unsigned mask = __ballot_sync(kAll, hit[u]);
      if (hit[u]) {
        const int q =
            queue_pos(head, count, __popc(mask & ((1u << lane) - 1)));
        sc.col[q] = col[u];
        sc.slot[q] = slot[u];
      }
      count += __popc(mask);
    }
    base_slot = __shfl_sync(kAll, slot[kSweepLanes - 1], kSweepWarp - 1);
    while (base_slot + 1 < nrows &&
           __shfl_sync(kAll, pre, base_slot + 1) <= base + kStep)
      ++base_slot;
    while (count >= kSweepWarp) {
      drain(head, kSweepWarp);
      head = (head + kSweepWarp) & (kSweepQueue - 1);
      count -= kSweepWarp;
    }
  }
  if (count > 0) drain(head, count);
  flush_to(nrows);
}

#endif  // __CUDACC__

}  // namespace dgs
