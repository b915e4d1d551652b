"""Build the port's CUDA sources for the host, against a small emulation of
the CUDA runtime, so that the CPU tests can run the kernels themselves.

Each lane is a host thread; shuffles, ballots and ``__syncwarp`` are
exchanges behind the warp's barrier, so lanes stay in step exactly where the
sources rely on it; ``__syncthreads`` is the block's barrier; a launch runs
its blocks one after another on one team of threads, and ``__shared__``
variables become statics shared by the threads of the one block that runs.
This checks the kernels' logic, not their speed or the card's arithmetic:
``chip_smoke.py`` holds the same functions on the H100.  Used by
``test_torch_agg_sweep.py`` (the aggregation sweeps),
``test_torch_segment_kernel.py`` (the segment-sum and the totals),
``test_torch_binning_keys.py`` (the binning's keys),
``test_torch_mode_kernels.py`` and ``test_torch_folded_kernels.py`` (the
kernel modes), with two helpers for their operands (``misaligned``,
``straddles``).
"""

import ctypes
import os
import re
import subprocess

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "dgs_tpu_torch", "csrc")

# The subset of the CUDA runtime the port's sources use, on the host.
EMULATION = r"""
#pragma once
#include <algorithm>
#include <atomic>
#include <barrier>
#include <cstring>
#include <thread>
#include <vector>

#define __CUDACC__ 1
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct uint3 { unsigned x, y, z; };
struct alignas(8) float2 { float x, y; };
inline float2 make_float2(float x, float y) { return float2{x, y}; }
struct alignas(16) float4 { float x, y, z, w; };
inline float4 make_float4(float x, float y, float z, float w) {
  return float4{x, y, z, w};
}
using cudaError_t = int;
using cudaStream_t = void*;
constexpr int cudaSuccess = 0;
constexpr int cudaErrorInvalidValue = 1;
inline cudaError_t cudaGetLastError() { return 0; }
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <class F>
cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return 0; }
using std::max;
using std::min;

namespace emu {
struct Warp {
  std::barrier<> bar{32};
  unsigned slot[32];
  float regs[2][32 * 8];
};
inline thread_local Warp* warp_;
inline thread_local int lane_;
inline thread_local std::barrier<>* block_;
inline thread_local float* dyn_;

template <class T>
T exchange(T v, int src) {
  static_assert(sizeof(T) == 4);
  std::memcpy(&warp_->slot[lane_], &v, 4);
  warp_->bar.arrive_and_wait();
  T r;
  std::memcpy(&r, &warp_->slot[src & 31], 4);
  warp_->bar.arrive_and_wait();
  return r;
}

// Every lane's N registers, gathered: all[l] = lane l's `mine`.  One
// exchange where N shuffles would take N (tf32_mma.cuh's mma_tf32), and
// one barrier: consecutive gathers alternate between two buffers, and a
// lane can write a buffer again only after every lane has passed the
// next gather's barrier, that is, has read it.
inline thread_local unsigned gathers_;
template <int N>
void warp_gather(const float (&mine)[N], float (&all)[32][N]) {
  static_assert(N <= 8);
  float* buf = warp_->regs[gathers_++ & 1];
  std::memcpy(&buf[lane_ * N], mine, sizeof(mine));
  warp_->bar.arrive_and_wait();
  std::memcpy(all, buf, sizeof(all));
}
}  // namespace emu

inline thread_local uint3 threadIdx, blockIdx;

template <class T>
T __shfl_sync(unsigned, T v, int src) { return emu::exchange(v, src); }
template <class T>
T __shfl_up_sync(unsigned, T v, unsigned d) {
  const int src = emu::lane_ - (int)d;
  return emu::exchange(v, src < 0 ? emu::lane_ : src);
}
template <class T>
T __shfl_xor_sync(unsigned, T v, int m) {
  return emu::exchange(v, emu::lane_ ^ m);
}
inline unsigned __ballot_sync(unsigned, int pred) {
  emu::warp_->slot[emu::lane_] = pred ? (1u << emu::lane_) : 0u;
  emu::warp_->bar.arrive_and_wait();
  unsigned all = 0;
  for (int l = 0; l < 32; ++l) all |= emu::warp_->slot[l];
  emu::warp_->bar.arrive_and_wait();
  return all;
}
inline unsigned __match_any_sync(unsigned, int v) {
  emu::warp_->slot[emu::lane_] = (unsigned)v;
  emu::warp_->bar.arrive_and_wait();
  unsigned same = 0;
  for (int l = 0; l < 32; ++l)
    if (emu::warp_->slot[l] == (unsigned)v) same |= 1u << l;
  emu::warp_->bar.arrive_and_wait();
  return same;
}
inline int __ffs(unsigned x) { return __builtin_ffs((int)x); }
inline void __syncwarp() { emu::warp_->bar.arrive_and_wait(); }
inline void __syncthreads() { emu::block_->arrive_and_wait(); }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
// Atomic as on the card: the lanes are threads that race for *p.
inline int atomicMin(int* p, int v) {
  std::atomic_ref<int> a(*p);
  int o = a.load();
  while (v < o && !a.compare_exchange_weak(o, v)) {}
  return o;
}
inline int atomicMax(int* p, int v) {
  std::atomic_ref<int> a(*p);
  int o = a.load();
  while (v > o && !a.compare_exchange_weak(o, v)) {}
  return o;
}
inline int atomicAdd(int* p, int v) {
  return std::atomic_ref<int>(*p).fetch_add(v);
}

namespace emu {
template <class K, class... A>
void launch(K kernel, dim3 grid, dim3 block, size_t bytes, void*, A... args) {
  std::vector<float> dyn(bytes / sizeof(float) + 1);
  std::vector<Warp> warps(block.x / 32);
  std::barrier<> bar(block.x);
  std::vector<std::thread> threads;
  for (unsigned t = 0; t < block.x; ++t)
    threads.emplace_back([&, t] {
      threadIdx = {t, 0, 0};
      warp_ = &warps[t / 32];
      lane_ = t % 32;
      block_ = &bar;
      dyn_ = dyn.data();
      for (unsigned b = 0; b < grid.x; ++b) {
        blockIdx = {b, 0, 0};
        kernel(args...);
        bar.arrive_and_wait();  // the block's statics are free again
      }
    });
  for (auto& th : threads) th.join();
}
}  // namespace emu
"""


def misaligned(x):
    """x's values (a float32 CPU tensor) at an address 4 bytes past a
    16-byte boundary, which the kernels that stage by 16-byte copies
    refuse."""
    import torch
    buf = torch.empty(x.numel() + 4)
    view = buf[1:1 + x.numel()].view(x.shape)
    view.copy_(x)
    assert view.data_ptr() % 16 == 4
    return view


def straddles(tiles, block):
    """Whether some block of ``block`` consecutive sorted rows holds two
    tiles (of the valid ones, >= 0)."""
    import torch
    t = tiles[:tiles.numel() // block * block].reshape(-1, block)
    lo = torch.where(t >= 0, t, float("inf")).amin(dim=1)
    return bool((t.amax(dim=1) > lo).any())


def gxx(args):
    """g++ (C++20, a shared library) started on ``args``; wait() it."""
    return subprocess.Popen(["g++", "-std=c++20", "-shared", "-fPIC"] + args,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def wait(procs):
    for p in procs:
        out, _ = p.communicate()
        assert p.returncode == 0, out


def _rewrite(src):
    """A source with the launch syntax made emu::launch and the dynamic
    shared array a per-launch buffer; the number of launches rewritten."""
    src = src.replace("extern __shared__ float s_dt[];",
                      "float* s_dt = emu::dyn_;")
    return re.subn(r"(\w+(?:<[^<>;]*>)?)\s*<<<(.*?)>>>\(",
                   r"emu::launch(\1, \2, ", src, flags=re.S)


def build(tmpdir, names):
    """The sources ``csrc/<name>.cu`` built for the host, in parallel,
    against the emulated runtime: the launch syntax becomes emu::launch and
    the dynamic shared array a per-launch buffer, in the sources and in the
    headers beside them (rewritten copies shadow the originals); nothing
    else changes.  Returns one ctypes library a name."""
    (tmpdir / "cuda_runtime.h").write_text(EMULATION)
    for hdr in os.listdir(CSRC):
        if hdr.endswith(".cuh"):
            text = open(os.path.join(CSRC, hdr)).read()
            (tmpdir / hdr).write_text(_rewrite(text)[0])
    objs, procs = [], []
    for name in names:
        src, n = _rewrite(open(os.path.join(CSRC, name + ".cu")).read())
        assert n >= 1 or ".cuh\"" in src, name
        (tmpdir / (name + ".cpp")).write_text(src)
        objs.append(str(tmpdir / (name + ".so")))
        procs.append(gxx(["-Og", "-pthread", "-I", str(tmpdir), "-I", CSRC,
                          "-o", objs[-1], str(tmpdir / (name + ".cpp"))]))
    wait(procs)
    return [ctypes.CDLL(o) for o in objs]
