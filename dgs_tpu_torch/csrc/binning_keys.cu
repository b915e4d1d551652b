// The binning's sort keys in one pass, for Hopper (sm_90a).
//
// Replaces no TPU kernel: dgs_tpu builds the keys with XLA's elementwise
// ops (dgs_tpu/binning/grid.py duplicate_entries, gaussian_rects and
// ellip_keep), and so does the port's plain version,
// dgs_tpu_torch/binning/grid.py candidate_keys_plain, which a CPU tensor
// runs.  On the card that plain chain is some 130 launches, each reading
// and writing (P, R^D) temporaries; this kernel reads the Gaussians once
// and writes the keys once.
//
// One thread a candidate tile: thread i = g * dup + c is candidate c of
// Gaussian g, so a warp writes 32 consecutive keys, and the 2 to 4 warps of
// one Gaussian (dup = R^D) read its mean, radii and conic together.  Each
// thread, in the plain version's order:
//   - the rect [lo, hi) of gaussian_rects: floor / ceil of the footprint
//     box in tiles, the open domain's clamp into [0, grid], the full-cover
//     collapse, the empty rect of a zero radius; thread c = 0 adds the
//     Gaussian to the rect overflow count (an integer atomic: exact in any
//     order);
//   - the candidate lo + offset(c) (the last axis fastest) and its test
//     against hi;
//   - where conics are given and D >= 2, ellip_keep: 4 clamped
//     coordinate-descent sweeps of y^T Q y over the candidate's box, the
//     level test, degenerate (zero-conic) and full-cover rows kept;
//   - the periodic wrap, or the open domain's in-grid test;
//   - the flat tile id (T for a dropped candidate) and, where the key fits
//     in 31 bits, the key (tile << gid_bits) | gid with gid P for T.
//
// Bitwise equal to the plain chain on the card.  Every product, sum and
// quotient is rounded on its own (dgs::mul_rn / add_rn, __fdiv_rn: no FMA
// contraction, IEEE division; built without --use_fast_math), in the plain
// version's order of operations.  torch divides a CUDA tensor by a Python
// float as a product with the float32 reciprocal, so the rect takes
// inv_tile = fl(1 / fl(tile)) from the host; torch.clamp propagates a NaN
// operand (value, then lower, then upper bound), and so does clamp_nan.
//
// What bounds it: operations.  Each candidate inside its rect runs the
// cull, whose sweeps take 12 IEEE divisions at D = 3 beside their products
// and clamps (chip_smoke.py cull_ops counts them); the bytes are the
// Gaussians once (48 B each at D = 3) and 4 B a key.  A warp runs the cull
// where any of its lanes needs it.  Measured times are in PERF.md.
//
// Built into the port's kernel library (dgs_tpu_torch/kernels/_build.py, nvcc
// -gencode arch=compute_90a,code=sm_90a -O3, plain C ABI, ctypes).
#include <cuda_runtime.h>
#include <math.h>

#include "agg_math.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSweeps = 4;          // grid.py ELLIP_CULL_SWEEPS
constexpr float kQddFloor = 1e-30f;

struct KeyParams {
  const float* means;   // (P, D)
  const float* radii;   // (P,) or (P, D)
  const float* conics;  // (P, D (D + 1) / 2), or null: no ellipsoid cull
  int* out;             // (P * dup,) keys, or tiles where not packed
  int* overflow;        // () Gaussians whose rect exceeds R on some axis
  long long n;          // P * dup
  int P, R, dup, T, gid_bits;
  int axis_radii, periodic, packed;
  int grid[3], strides[3];
  float lower[3];
  float tile, inv_tile, level;
};

DGS_HD float div_rn(float a, float b) {
#if defined(__CUDA_ARCH__)
  return __fdiv_rn(a, b);
#else
  return a / b;
#endif
}

// torch.clamp(v, min=lo, max=hi) with tensor bounds as torch evaluates it
// on the card.
DGS_HD float clamp_nan(float v, float lo, float hi) {
  if (isnan(v)) return v;
  if (isnan(lo)) return lo;
  if (isnan(hi)) return hi;
  return fminf(fmaxf(v, lo), hi);
}

// ellip_keep's test for one candidate box [blo, blo + tile) (centred on
// the mean): does 4 sweeps' minimum of y^T Q y reach the level?
template <int D>
__device__ __forceinline__ bool ellip_meets(const float (&q)[6],
                                            const float (&blo)[D],
                                            const float (&bhi)[D],
                                            float level) {
  float y[D];
#pragma unroll
  for (int d = 0; d < D; ++d) y[d] = clamp_nan(0.0f, blo[d], bhi[d]);
#pragma unroll
  for (int s = 0; s < kSweeps; ++s) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      float num = 0.0f;
      bool first = true;
#pragma unroll
      for (int e = 0; e < D; ++e) {
        if (e == d) continue;
        const float t = dgs::mul_rn(q[dgs::tri_index(D, d, e)], y[e]);
        num = first ? t : dgs::add_rn(num, t);
        first = false;
      }
      float qdd = q[dgs::tri_index(D, d, d)];
      qdd = isnan(qdd) ? qdd : fmaxf(qdd, kQddFloor);
      y[d] = clamp_nan(div_rn(-num, qdd), blo[d], bhi[d]);
    }
  }
  float f = 0.0f;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const float t = dgs::mul_rn(dgs::mul_rn(q[dgs::tri_index(D, d, d)], y[d]),
                                y[d]);
    f = d == 0 ? t : dgs::add_rn(f, t);
  }
#pragma unroll
  for (int d = 0; d < D; ++d)
#pragma unroll
    for (int e = d + 1; e < D; ++e)
      f = dgs::add_rn(f, dgs::mul_rn(dgs::mul_rn(dgs::mul_rn(
                                         2.0f, q[dgs::tri_index(D, d, e)]),
                                     y[d]), y[e]));
  return f <= level;
}

template <int D>
__global__ void __launch_bounds__(kThreads) binning_keys_kernel(KeyParams p) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= p.n) return;
  const int g = (int)(i / p.dup);
  const int c = (int)(i - (long long)g * p.dup);

  // gaussian_rects.
  float m[D];
  int lo[D], hi[D];
  bool empty = false;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    m[d] = p.means[(long long)g * D + d];
    const float r = p.axis_radii ? p.radii[(long long)g * D + d] : p.radii[g];
    empty = empty || r <= 0.0f;
    const float x = dgs::add_rn(m[d], -p.lower[d]);
    lo[d] = (int)floorf(dgs::mul_rn(dgs::add_rn(x, -r), p.inv_tile));
    hi[d] = (int)ceilf(dgs::mul_rn(dgs::add_rn(x, r), p.inv_tile));
    if (!p.periodic) {
      lo[d] = min(max(lo[d], 0), p.grid[d]);
      hi[d] = min(max(hi[d], 0), p.grid[d]);
    }
    if (hi[d] - lo[d] >= p.grid[d]) {
      lo[d] = 0;
      hi[d] = p.grid[d];
    }
  }
  bool skip = false;   // a full cover on some axis: no per-tile geometry
#pragma unroll
  for (int d = 0; d < D; ++d) {
    if (empty) hi[d] = lo[d];
    skip = skip || hi[d] - lo[d] >= p.grid[d];
  }
  if (c == 0) {
    long long capped = 1, whole = 1;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const int e = hi[d] - lo[d];
      capped *= min(e, p.R);
      whole *= e;
    }
    if (max(capped, 0LL) != max(whole, 0LL)) atomicAdd(p.overflow, 1);
  }

  // The candidate, unwrapped, and its tests.
  int cand[D];
  bool valid = true;
  int rest = c;
#pragma unroll
  for (int d = D - 1; d >= 0; --d) {
    cand[d] = lo[d] + rest % p.R;
    rest /= p.R;
  }
#pragma unroll
  for (int d = 0; d < D; ++d) valid = valid && cand[d] < hi[d];
  if (D >= 2 && p.conics != nullptr && valid && !skip) {
    constexpr int kTri = D * (D + 1) / 2;
    float q[6];
    bool degenerate = true;
#pragma unroll
    for (int t = 0; t < kTri; ++t) {
      q[t] = p.conics[(long long)g * kTri + t];
      degenerate = degenerate && q[t] == 0.0f;
    }
    if (!degenerate) {
      float blo[D], bhi[D];
#pragma unroll
      for (int d = 0; d < D; ++d) {
        blo[d] = dgs::add_rn(
            dgs::add_rn(p.lower[d], dgs::mul_rn((float)cand[d], p.tile)),
            -m[d]);
        bhi[d] = dgs::add_rn(blo[d], p.tile);
      }
      valid = ellip_meets<D>(q, blo, bhi, p.level);
    }
  }
  int tile = 0;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    int t = cand[d];
    if (p.periodic) {
      t %= p.grid[d];
      if (t < 0) t += p.grid[d];
    } else {
      valid = valid && t < p.grid[d] && t >= 0;
    }
    tile += t * p.strides[d];
  }
  if (!valid) tile = p.T;
  p.out[i] = p.packed ? (tile << p.gid_bits) | (tile == p.T ? p.P : g) : tile;
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns cudaGetLastError() after the
// launch (0 = launched).  means, radii, conics (or null), out and overflow
// are device pointers; grid, strides and lower are host arrays of D values,
// passed to the kernel by value (no copy to the device).  overflow must
// hold 0.
int dgs_binning_keys(const void* means, const void* radii, int axis_radii,
                     const void* conics, int D, int P, int R,
                     const int* grid, const int* strides, const float* lower,
                     float tile, float inv_tile, int periodic, float level,
                     int T, int gid_bits, int packed, void* out,
                     void* overflow, void* stream) {
  if (D < 1 || D > 3 || P < 1 || R < 1) return (int)cudaErrorInvalidValue;
  KeyParams p{};
  p.means = static_cast<const float*>(means);
  p.radii = static_cast<const float*>(radii);
  p.conics = static_cast<const float*>(conics);
  p.out = static_cast<int*>(out);
  p.overflow = static_cast<int*>(overflow);
  long long dup = 1;
  for (int d = 0; d < D; ++d) dup *= R;
  p.n = dup * P;
  p.P = P;
  p.R = R;
  p.dup = (int)dup;
  p.T = T;
  p.gid_bits = gid_bits;
  p.axis_radii = axis_radii;
  p.periodic = periodic;
  p.packed = packed;
  for (int d = 0; d < D; ++d) {
    p.grid[d] = grid[d];
    p.strides[d] = strides[d];
    p.lower[d] = lower[d];
  }
  p.tile = tile;
  p.inv_tile = inv_tile;
  p.level = level;
  const dim3 blocks((unsigned)((p.n + kThreads - 1) / kThreads));
  const dim3 block(kThreads);
  const auto st = static_cast<cudaStream_t>(stream);
  if (D == 1)
    binning_keys_kernel<1><<<blocks, block, 0, st>>>(p);
  else if (D == 2)
    binning_keys_kernel<2><<<blocks, block, 0, st>>>(p);
  else
    binning_keys_kernel<3><<<blocks, block, 0, st>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
