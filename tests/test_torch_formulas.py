"""dgs_tpu_torch.ops.formulas against dgs_tpu.ops.formulas, and the CUDA
kernels' copy of the same math (csrc/pair_math.cuh) built for the host with
g++ against the torch formulas: the forward weights and the per-pair VJP."""

import ctypes
import itertools
import os
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgs_tpu.ops import formulas as jf
from dgs_tpu_torch.config import tri_size
from dgs_tpu_torch.ops import formulas as tf

from conftest import make_gaussians

torch.set_num_threads(2)

ORDERS = ("value", "derivative", "laplacian", "third")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def assert_close(got, ref, err_msg=""):
    ref = np.asarray(ref)
    np.testing.assert_allclose(
        np.asarray(got), ref, rtol=2e-4,
        atol=1e-5 * max(1.0, float(np.abs(ref).max(initial=0.0))),
        err_msg=err_msg)


def _pairs(rng, D, n=200):
    """Pair displacements spanning the torus and packed conics."""
    _, _, _, conics = make_gaussians(rng, n, D, 1)
    X = rng.uniform(-1.5, 1.5, (n, D)).astype(np.float32)
    return X, conics


@pytest.mark.parametrize("D", [1, 2, 3])
def test_pair_terms_match(rng, D):
    X, conics = _pairs(rng, D)
    tri = tri_size(D)
    for period in (None, 2.0):
        jX = [jf.wrap(jnp.asarray(X[:, d]), period) for d in range(D)]
        tX = [tf.wrap(torch.from_numpy(X[:, d]), period) for d in range(D)]
        for a, b in zip(jX, tX):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        jc = [jnp.asarray(conics[:, t]) for t in range(tri)]
        tc = [torch.from_numpy(conics[:, t]) for t in range(tri)]
        jG, ja = jf.power_terms(jX, jc)
        tG, ta = tf.power_terms(tX, tc)
        assert_close(tG, jG, "G")
        for a, b in zip(ja, ta):
            assert_close(b, a, "a")
        for order in ORDERS:
            pairs = [
                (tf.components(order, tX, tc, tG, ta),
                 jf.components(order, jX, jc, jG, ja)),
                (tf.components_unique(order, tX, tc, tG, ta),
                 jf.components_unique(order, jX, jc, jG, ja)),
                (tf.component_polys(order, tX, tc, ta),
                 jf.component_polys(order, jX, jc, ja)),
            ]
            for got, ref in pairs:
                assert len(got) == len(ref)
                for g, r in zip(got, ref):
                    assert_close(g, r, f"{order} period={period}")


@pytest.mark.parametrize("D", [1, 2, 3])
def test_symmetry_tables_match(D):
    for order in ORDERS:
        assert tf.sym_indices(order, D) == jf.sym_indices(order, D)
        assert tf.n_unique(order, D) == jf.n_unique(order, D)
        assert tf.full_to_unique(order, D) == jf.full_to_unique(order, D)
        assert tf.sym_multiplicity(order, D) == jf.sym_multiplicity(order, D)
    assert tf.unique_diag_indices(D) == jf.unique_diag_indices(D)


_HARNESS = r"""
#include "pair_math.cuh"

template <int D, int M>
static int run(const float* X, const float* con, float* w) {
  float x[D], c[dgs::tri_size(D)], ww[dgs::total_unique(D, M)];
  for (int d = 0; d < D; ++d) x[d] = X[d];
  for (int t = 0; t < dgs::tri_size(D); ++t) c[t] = con[t];
  if (!dgs::pair_weights<D, M>(x, c, ww)) return 0;
  for (int k = 0; k < dgs::total_unique(D, M); ++k) w[k] = ww[k];
  return 1;
}

#define CASE(D, M) case D * 16 + M: return run<D, M>(X, con, w);
#define ALL(D) CASE(D, 1) CASE(D, 2) CASE(D, 3) CASE(D, 4) CASE(D, 5)      \
  CASE(D, 6) CASE(D, 7) CASE(D, 8) CASE(D, 9) CASE(D, 10) CASE(D, 11)     \
  CASE(D, 12) CASE(D, 13) CASE(D, 14) CASE(D, 15)

extern "C" int pair_weights(int D, int mask, const float* X, const float* con,
                            float* w) {
  switch (D * 16 + mask) { ALL(1) ALL(2) ALL(3) }
  return -1;
}

extern "C" float wrap(float x, float period) { return dgs::wrap(x, period); }

template <int D, int M>
static int run_vjp(const float* X, const float* con, const float* h,
                   float* out) {
  constexpr int TRI = dgs::tri_size(D), K = dgs::total_unique(D, M);
  float x[D], c[TRI], a[D], G, q[TRI], w[K], hh[K], dmu[D] = {},
        dcon[TRI] = {};
  for (int d = 0; d < D; ++d) x[d] = X[d];
  for (int t = 0; t < TRI; ++t) c[t] = con[t];
  for (int k = 0; k < K; ++k) hh[k] = h[k];
  if (!dgs::pair_power<D>(x, c, a, G)) {
    // the branch-free form must agree: G = 0 for the skipped pair
    return dgs::pair_gauss<D>(x, c, a) == 0.0f ? 0 : -2;
  }
  if (dgs::pair_gauss<D>(x, c, a) != G) return -2;
  dgs::pair_polys<D, M>(c, a, q);
  dgs::component_weights<D, M>(c, a, q, G, w);
  dgs::pair_vjp<D, M>(x, c, a, q, G, w, hh, dmu, dcon);
  for (int d = 0; d < D; ++d) out[d] = dmu[d];
  for (int t = 0; t < TRI; ++t) out[D + t] = dcon[t];
  return 1;
}

#undef CASE
#define CASE(D, M) case D * 16 + M: return run_vjp<D, M>(X, con, h, out);

extern "C" int pair_vjp(int D, int mask, const float* X, const float* con,
                        const float* h, float* out) {
  switch (D * 16 + mask) { ALL(1) ALL(2) ALL(3) }
  return -1;
}
"""


@pytest.fixture(scope="module")
def pair_math(tmp_path_factory):
    d = tmp_path_factory.mktemp("pair_math")
    src = d / "harness.cpp"
    src.write_text(_HARNESS)
    lib = d / "harness.so"
    subprocess.run(
        ["g++", "-std=c++17", "-O2", "-shared", "-fPIC", "-I",
         os.path.join(REPO, "dgs_tpu_torch", "csrc"), "-o", str(lib),
         str(src)], check=True, capture_output=True)
    h = ctypes.CDLL(str(lib))
    fp = ctypes.POINTER(ctypes.c_float)
    h.pair_weights.argtypes = [ctypes.c_int, ctypes.c_int, fp, fp, fp]
    h.pair_weights.restype = ctypes.c_int
    h.wrap.argtypes = [ctypes.c_float, ctypes.c_float]
    h.wrap.restype = ctypes.c_float
    h.pair_vjp.argtypes = [ctypes.c_int, ctypes.c_int, fp, fp, fp, fp]
    h.pair_vjp.restype = ctypes.c_int
    return h


@pytest.mark.parametrize("D", [1, 2, 3])
def test_cuda_pair_math_matches_formulas(pair_math, rng, D):
    """The kernel header's per-pair weights, for every order set, equal the
    torch formulas' unique components (and its wrap equals formulas.wrap)."""
    X, conics = _pairs(rng, D, n=40)
    X = tf.wrap(torch.from_numpy(X), 2.0).numpy()
    fp = ctypes.POINTER(ctypes.c_float)
    for x in rng.uniform(-3.0, 3.0, 50).astype(np.float32):
        assert pair_math.wrap(float(x), 2.0) == np.float32(
            tf.wrap(torch.tensor(x), 2.0).item())
    tri = tri_size(D)
    for mask in range(1, 16):
        orders = [o for b, o in enumerate(ORDERS) if mask & (1 << b)]
        K = sum(tf.n_unique(o, D) for o in orders)
        for p in range(X.shape[0]):
            Xs = [torch.tensor([X[p, d]]) for d in range(D)]
            con = [torch.tensor([conics[p, t]]) for t in range(tri)]
            G, a = tf.power_terms(Xs, con)
            ref = [w.item() for o in orders
                   for w in tf.components_unique(o, Xs, con, G, a)]
            xa = np.ascontiguousarray(X[p], np.float32)
            ca = np.ascontiguousarray(conics[p], np.float32)
            w = np.zeros(K, np.float32)
            kept = pair_math.pair_weights(
                D, mask, xa.ctypes.data_as(fp), ca.ctypes.data_as(fp),
                w.ctypes.data_as(fp))
            assert kept in (0, 1)
            if not kept:
                w[:] = 0.0   # the kernel skips the pair
            assert_close(w, ref, f"D={D} mask={mask} pair={p}")


def _subsets():
    return [o for r in range(1, 5) for o in itertools.combinations(ORDERS, r)]


def _vjp_pairs(D, n):
    """Pairs with O(1) displacements and well-conditioned conics, so G and
    every VJP term are far from underflow (test_formulas_fused's inputs)."""
    rng = np.random.RandomState(D)
    X = (0.7 * rng.randn(D, n)).astype(np.float32)
    A = rng.randn(D, D).astype(np.float32)
    M = A @ A.T + np.eye(D, dtype=np.float32)
    con = np.stack([M[i, j] + 0.01 * rng.randn(n)
                    for i in range(D) for j in range(i, D)]).astype(np.float32)
    return rng, X, con


@pytest.mark.parametrize("D", [1, 2, 3])
def test_vjp_params_match(D):
    """torch vjp_params_fused (every order subset, with and without shared
    polynomials) and vjp_params (every order) against dgs_tpu's."""
    n = 64
    rng, X, con = _vjp_pairs(D, n)
    jX, tX = [jnp.asarray(x) for x in X], [torch.from_numpy(x) for x in X]
    jc, tc = [jnp.asarray(c) for c in con], [torch.from_numpy(c) for c in con]
    jG, ja = jf.power_terms(jX, jc)
    tG, ta = tf.power_terms(tX, tc)
    jlp = jf.component_polys("laplacian", jX, jc, ja)
    jtp = jf.component_polys("third", jX, jc, ja)
    tlp = tf.component_polys("laplacian", tX, tc, ta)
    ttp = tf.component_polys("third", tX, tc, ta)
    for orders in _subsets():
        K = sum(tf.n_unique(o, D) for o in orders)
        h = rng.randn(K, n).astype(np.float32)
        for jextra, textra in (((None, None), (None, None)),
                               ((jlp, jtp), (tlp, ttp))):
            ref = jf.vjp_params_fused(orders, jX, jc, jG, ja,
                                      [jnp.asarray(r) for r in h], *jextra)
            got = tf.vjp_params_fused(orders, tX, tc, tG, ta,
                                      [torch.from_numpy(r) for r in h],
                                      *textra)
            for g_list, r_list in zip(got, ref):
                assert len(g_list) == len(r_list)
                for g, r in zip(g_list, r_list):
                    assert_close(g, r, f"fused {orders} D={D}")
    for order in ORDERS:
        ncomp = D ** ORDERS.index(order)
        h = rng.randn(ncomp, n).astype(np.float32)
        ref = jf.vjp_params(order, jX, jc, jG, ja, [jnp.asarray(r) for r in h])
        got = tf.vjp_params(order, tX, tc, tG, ta,
                            [torch.from_numpy(r) for r in h])
        for g_list, r_list in zip(got, ref):
            for g, r in zip(g_list, r_list):
                assert_close(g, r, f"vjp_params {order} D={D}")


@pytest.mark.parametrize("D", [1, 2, 3])
def test_fused_matches_folded(D):
    """Twin of tests/test_formulas_fused.py: the collapsed multi-order
    vjp_params_fused reproduces the per-order folded VJP for every order
    subset (rtol and atol 3e-5, that test's), and vjp_params_folded equals
    dgs_tpu's."""
    n = 64
    rng, X, con = _vjp_pairs(D, n)
    X = (X / 0.7).astype(np.float32)        # that test's unit-normal X
    tri = tri_size(D)
    jX, tX = [jnp.asarray(x) for x in X], [torch.from_numpy(x) for x in X]
    jc, tc = [jnp.asarray(c) for c in con], [torch.from_numpy(c) for c in con]
    jG, ja = jf.power_terms(jX, jc)
    G, a = tf.power_terms(tX, tc)
    lp = tf.component_polys("laplacian", tX, tc, a)
    tp = tf.component_polys("third", tX, tc, a)
    for orders in _subsets():
        K = sum(tf.n_unique(o, D) for o in orders)
        h = rng.randn(K, n).astype(np.float32)
        hs = [torch.from_numpy(r) for r in h]
        dmu_r = [torch.zeros(n)] * D
        dcon_r = [torch.zeros(n)] * tri
        k0 = 0
        for o in orders:
            nu = tf.n_unique(o, D)
            dm, dc = tf.vjp_params_folded(o, tX, tc, G, a, hs[k0:k0 + nu])
            ref = jf.vjp_params_folded(o, jX, jc, jG, ja,
                                       [jnp.asarray(r) for r in h[k0:k0 + nu]])
            for g_list, r_list in zip((dm, dc), ref):
                for g, r in zip(g_list, r_list):
                    assert_close(g, r, f"folded {o} D={D}")
            dmu_r = [x + y for x, y in zip(dmu_r, dm)]
            dcon_r = [x + y for x, y in zip(dcon_r, dc)]
            k0 += nu
        for extra in ((None, None), (lp, tp)):
            dmu_f, dcon_f = tf.vjp_params_fused(orders, tX, tc, G, a, hs,
                                                *extra)
            for got, ref in zip(dmu_f + dcon_f, dmu_r + dcon_r):
                np.testing.assert_allclose(
                    got, ref, rtol=3e-5, atol=3e-5,
                    err_msg=f"orders={orders} D={D}")


@pytest.mark.parametrize("D", [1, 2, 3])
def test_cuda_pair_vjp_matches_formulas(pair_math, D):
    """The kernel header's pair_vjp, for every order set, equals the torch
    vjp_params_fused on the same pairs and folded cotangents; pairs with a
    positive quadratic form are skipped (zero rows)."""
    n = 40
    rng, X, con = _vjp_pairs(D, n)
    con[:, -1] = -con[:, -1]        # one indefinite pair: power may be > 0
    tri = tri_size(D)
    fp = ctypes.POINTER(ctypes.c_float)
    tX = [torch.from_numpy(x) for x in X]
    tc = [torch.from_numpy(c) for c in con]
    G, a = tf.power_terms(tX, tc)
    for mask in range(1, 16):
        orders = [o for b, o in enumerate(ORDERS) if mask & (1 << b)]
        K = sum(tf.n_unique(o, D) for o in orders)
        h = rng.randn(K, n).astype(np.float32)
        dmu, dcon = tf.vjp_params_fused(orders, tX, tc, G, a,
                                        [torch.from_numpy(r) for r in h])
        ref = torch.stack(dmu + dcon).T.numpy()          # (n, D + tri)
        got = np.zeros((n, D + tri), np.float32)
        for p in range(n):
            xa = np.ascontiguousarray(X[:, p])
            ca = np.ascontiguousarray(con[:, p])
            ha = np.ascontiguousarray(h[:, p])
            kept = pair_math.pair_vjp(
                D, mask, xa.ctypes.data_as(fp), ca.ctypes.data_as(fp),
                ha.ctypes.data_as(fp), got[p].ctypes.data_as(fp))
            assert kept in (0, 1)
        assert_close(got, ref, f"D={D} mask={mask}")
