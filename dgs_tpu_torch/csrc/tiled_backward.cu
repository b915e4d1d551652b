// The classic tiled backward (dgs_tpu's kernel 2, classic branch), for
// Hopper (sm_90a): the instantiations of tiled_backward.cuh, and the C
// entries of the kernel library.  The design is in
// tiled_backward.cuh.
//
// Built with the other sources into one library
// (dgs_tpu_torch/kernels/_build.py, nvcc -gencode
// arch=compute_90a,code=sm_90a -O3, plain C ABI, ctypes).  Never with
// --use_fast_math (see pair_math.cuh).
#include "tiled_backward.cuh"

namespace {

using dgs::OrderRows;
using dgs::backward_pass;
using dgs::kWarp;
using dgs::launch_backward_mask;

// The C entry's body: checks, then the launch of the instantiation for
// (D, the pass width, mask).
int launch_backward(const void* geom, int Ep, int C, const void* smp, int Np,
                    const void* ct, const void* s_lo, const void* s_n,
                    int n_ranges, int D, int mask, int do_wrap, float period,
                    OrderRows rows, void* out, void* stream) {
  if ((long long)n_ranges * kWarp != Ep || C < 1)
    return (int)cudaErrorInvalidValue;
  const auto* g = static_cast<const float*>(geom);
  const auto* s = static_cast<const float*>(smp);
  const auto* c = static_cast<const float*>(ct);
  const auto* lo = static_cast<const int*>(s_lo);
  const auto* n = static_cast<const int*>(s_n);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const int cb = backward_pass(D, C);
#define DGS_LAUNCH(DD, CB)                                                \
  launch_backward_mask<DD, CB>(mask, g, Ep, C, s, Np, c, lo, n, n_ranges, \
                               do_wrap, period, rows, o, st)
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

}  // namespace

extern "C" {

// Entries per range (a warp's); the caller's range arrays hold one entry
// per 32 tile-sorted entries.
int dgs_tiled_backward_block() { return dgs::kWarp; }

// The channel-pass width the launcher picks for (D, C).
int dgs_tiled_backward_pass(int D, int C) { return dgs::backward_pass(D, C); }

// Launches the kernel on `stream` and returns cudaGetLastError() after the
// launch (0 = launched).  Pointers are device pointers; `mask` is the order
// set (bits of pair_math.cuh), r_* the first cotangent component of each
// order.
int dgs_tiled_backward(const void* geom, int Ep, int C, const void* smp,
                       int Np, const void* ct, const void* s_lo,
                       const void* s_n, int n_ranges, int D, int mask,
                       int do_wrap, float period, int r_value,
                       int r_derivative, int r_laplacian, int r_third,
                       void* out, void* stream) {
  return launch_backward(
      geom, Ep, C, smp, Np, ct, s_lo, s_n, n_ranges, D, mask, do_wrap, period,
      dgs::OrderRows{r_value, r_derivative, r_laplacian, r_third}, out,
      stream);
}

}  // extern "C"
