// The tiled backward under h_matmul (dgs_tpu's kernel 2 with h = g . values
// as matrix-unit dots, kernels/tiled.py:1098-1109), for Hopper (sm_90a):
// the h_matmul instantiations of tiled_backward.cuh, in their own
// translation unit so that nvcc builds them beside the classic ones.  The
// design is in tiled_backward.cuh and tf32_mma.cuh (h_matmul_block).
//
// Built with the other sources into libdgs_kernels.so
// (dgs_tpu_torch/kernels/_build.py).  Never with --use_fast_math.
#include "tiled_backward.cuh"

extern "C" {

// dgs_tiled_backward's contract, with h_k from `passes` (3 or 1) TF32
// tensor-core passes.
int dgs_tiled_backward_hmm(const void* geom, int Ep, int C, const void* smp,
                           int Np, const void* ct, const void* s_lo,
                           const void* s_n, int n_ranges, int D, int mask,
                           int do_wrap, float period, int r_value,
                           int r_derivative, int r_laplacian, int r_third,
                           int passes, void* out, void* stream) {
  if (passes != 1 && passes != 3) return (int)cudaErrorInvalidValue;
  return dgs::launch_backward<true>(
      geom, Ep, C, smp, Np, ct, s_lo, s_n, n_ranges, D, mask, do_wrap, period,
      dgs::OrderRows{r_value, r_derivative, r_laplacian, r_third},
      passes == 3, out, stream);
}

}  // extern "C"
