// Asynchronous 16-byte copies from device memory into shared memory
// (cp.async, sm_80 on), for the kernels that stage their operands a chunk
// ahead of the contraction that reads them (tiled_forward_folded.cu,
// tiled_backward_folded.cu, tiled_backward_fvjp.cu,
// tiled_backward_moments.cu).
//
// A thread issues its copies of the next chunk (cp_async16), closes them as
// one group (cp_async_commit) and goes on computing; cp_async_wait_all
// waits for its own copies, and a __syncthreads after it makes every
// thread's copies visible to the block.  A copy whose source is out of
// range writes 16 zero bytes instead (the src-size operand 0), so that the
// ragged edges of a chunk read as zeros.  .cg: the copy bypasses L1, the
// operands are read once a block.
//
// Built for the host under the emulated CUDA runtime of
// tests/cuda_emulation.py (__CUDACC__ defined, neither __CUDA_ARCH__ nor
// __NVCC__), a copy is a memcpy at once and the commit and the wait do
// nothing: the kernels' barriers still order every read after its copy.
#pragma once

#include <cuda_runtime.h>
#include <string.h>

#include "pair_math.cuh"

namespace dgs {

#if defined(__CUDACC__)
// 16 bytes from src (16-byte aligned) to dst in shared memory, or 16 zero
// bytes where !valid (src is then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
#if defined(__CUDA_ARCH__)
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
#else
  if (valid)
    memcpy(dst, src, 16);
  else
    memset(dst, 0, 16);
#endif
}

// Closes the thread's copies issued since the last commit into one group.
__device__ __forceinline__ void cp_async_commit() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}

// Waits until every copy group of the thread but the last committed one
// has landed.
__device__ __forceinline__ void cp_async_wait_one() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
#endif
}

// Waits until every copy group of the thread has landed.
__device__ __forceinline__ void cp_async_wait_all() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
#endif
}
#endif

// The float index, in a staged row of 4-float chunks, of column `col` of
// row `row`: chunk col / 4 XOR a 3-bit function of the row.  With it the
// m16n8k8 fragment reads of a staged block are free of bank conflicts both
// along the rows (8 rows g, one column t: the A operand of a row-major
// block) and across them (4 rows t, 8 columns g: the same block read
// transposed, or a B operand), while the 16-byte chunks that cp.async
// writes stay whole.
DGS_HD int swz(int row, int col) {
  const int h = ((row & 3) << 1) | ((row >> 2) & 1);
  return (((col >> 2) ^ h) << 2) | (col & 3);
}

}  // namespace dgs
