"""The layout the two dense CUDA kernels share (csrc/dense_layout.cuh), on
the CPU: the header's record fills are built for the host with g++ and held
against a numpy replica of the records, and the channel-pass rule against
the widths the kernels are built for."""

import ctypes
import os
import subprocess

import numpy as np
import pytest

from dgs_tpu_torch.config import tri_size
from dgs_tpu_torch.kernels import tiled as ttiled

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ORDERS = ("value", "derivative", "laplacian", "third")

_HARNESS = r"""
#include "dense_layout.cuh"

template <int D, int CB>
static int gaussian(const float* geom_p, long long P, int C, int c0,
                    float* out) {
  constexpr int NF = 4 * dgs::dense_fwd_vecs(D, CB);
  float f[NF];
  dgs::stage_gaussian<D, CB>(geom_p, P, C, c0, f);
  for (int i = 0; i < NF; ++i) out[i] = f[i];
  return NF;
}

extern "C" int stage_gaussian(int D, int CB, const float* geom_p,
                              long long P, int C, int c0, float* out) {
  switch (D * 8 + CB) {
#define CASE(D, CB) case D * 8 + CB: return gaussian<D, CB>(geom_p, P, C, c0, out);
    CASE(1, 4) CASE(2, 1) CASE(2, 2) CASE(2, 4) CASE(3, 4)
#undef CASE
  }
  return -1;
}

template <int D, int K, int CB>
static int sample(const float* smp_s, const float* ct_s, long long N, int C,
                  int c0, float* out) {
  constexpr int NF = 4 * dgs::dense_bwd_vecs(K, CB);
  float f[NF];
  dgs::stage_dense_sample<D, K, CB>(smp_s, ct_s, N, C, c0, f);
  for (int i = 0; i < NF; ++i) out[i] = f[i];
  return NF;
}

extern "C" int stage_dense_sample(int D, int K, int CB, const float* smp_s,
                                  const float* ct_s, long long N, int C,
                                  int c0, float* out) {
  switch ((D * 32 + K) * 8 + CB) {
#define CASE(D, K, CB) \
  case (D * 32 + K) * 8 + CB: return sample<D, K, CB>(smp_s, ct_s, N, C, c0, out);
    CASE(1, 1, 4) CASE(1, 4, 4) CASE(2, 1, 1) CASE(2, 4, 1) CASE(2, 4, 2)
    CASE(2, 10, 4) CASE(3, 1, 4) CASE(3, 20, 4)
#undef CASE
  }
  return -1;
}

extern "C" int dense_index(int v, int j) { return dgs::dense_index<256>(v, j); }
extern "C" int dense_pass(int D, int C) { return dgs::dense_pass(D, C); }
"""


@pytest.fixture(scope="module")
def layout(tmp_path_factory):
    d = tmp_path_factory.mktemp("dense_layout")
    src = d / "harness.cpp"
    src.write_text(_HARNESS)
    lib = d / "harness.so"
    subprocess.run(
        ["g++", "-std=c++17", "-O2", "-shared", "-fPIC", "-I",
         os.path.join(REPO, "dgs_tpu_torch", "csrc"), "-o", str(lib),
         str(src)], check=True, capture_output=True)
    h = ctypes.CDLL(str(lib))
    fp, i, ll = ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_longlong
    h.stage_gaussian.argtypes = [i, i, fp, ll, i, i, fp]
    h.stage_dense_sample.argtypes = [i, i, i, fp, fp, ll, i, i, fp]
    return h


def _ptr(a, offset=0):
    return ctypes.cast(a.ctypes.data + 4 * offset,
                       ctypes.POINTER(ctypes.c_float))


@pytest.mark.parametrize("D,CB", [(1, 4), (2, 1), (2, 2), (2, 4), (3, 4)])
def test_stage_gaussian_matches_numpy(layout, rng, D, CB):
    """A forward record is [mu, conic, the pass's CB value channels (zero
    from channel C on)], zero-padded to whole float4 vectors, read from
    column p of the (D + tri + C, P) geom array: 16 floats at D = 3,
    C = 4."""
    head, P = D + tri_size(D), 29
    for C in (1, 2, 3, 4, 5):
        geom = rng.normal(size=(head + C, P)).astype(np.float32)
        for c0 in range(0, C, CB):
            for p in (0, 4, P - 1):
                out = np.full(32, np.nan, np.float32)
                n = layout.stage_gaussian(D, CB, _ptr(geom, p), P, C, c0,
                                          _ptr(out))
                assert n == 4 * (-(-(head + CB) // 4))
                want = np.zeros(n, np.float32)
                want[:head] = geom[:head, p]
                live = min(CB, C - c0)
                want[head:head + live] = geom[head + c0:head + c0 + live, p]
                np.testing.assert_array_equal(out[:n], want)
    if (D, CB) == (3, 4):
        assert n == 16


@pytest.mark.parametrize("D,K,CB", [(1, 1, 4), (1, 4, 4), (2, 1, 1),
                                    (2, 4, 1), (2, 4, 2), (2, 10, 4),
                                    (3, 1, 4), (3, 20, 4)])
def test_stage_dense_sample_matches_numpy(layout, rng, D, K, CB):
    """A backward record is {x, zeros} as vector 0, then the unique
    cotangents of the pass's channels packed k-major (float 4 + k * CB + c
    is row k * C + c0 + c of the (K * C, N) cotangent, zero from channel C
    on), zero-padded: 21 vectors at D = 3 with all four orders (K = 20) and
    C = 4."""
    N = 31
    for C in (1, 2, 3, 5):
        smp = rng.normal(size=(D, N)).astype(np.float32)
        ct = rng.normal(size=(K * C, N)).astype(np.float32)
        for c0 in range(0, C, CB):
            for s in (0, 9, N - 1):
                out = np.full(4 * 24, np.nan, np.float32)
                n = layout.stage_dense_sample(D, K, CB, _ptr(smp, s),
                                              _ptr(ct, s), N, C, c0,
                                              _ptr(out))
                assert n == 4 + 4 * (-(-(K * CB) // 4))
                want = np.zeros(n, np.float32)
                want[:D] = smp[:, s]
                for k in range(K):
                    for c in range(min(CB, C - c0)):
                        want[4 + k * CB + c] = ct[k * C + c0 + c, s]
                np.testing.assert_array_equal(out[:n], want,
                                              err_msg=f"C={C} c0={c0}")
    if (D, K, CB) == (3, 20, 4):
        assert n == 4 * 21
        assert K == ttiled.total_unique(ORDERS, 3)


def test_dense_index_and_pass(layout):
    """Vector v of staged row j sits at v * ROWS + j (consecutive threads
    store consecutive float4, a sweep reads one address); the pass is C for
    C <= 2 at D = 2 (the narrow passes are built there), else 4."""
    for v in range(4):
        for j in (0, 1, 255):
            assert layout.dense_index(v, j) == v * 256 + j
    for D in (1, 2, 3):
        for C in (1, 2, 3, 4, 6):
            want = C if D == 2 and C <= 2 else 4
            assert layout.dense_pass(D, C) == want
