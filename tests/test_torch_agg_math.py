"""The aggregation kernels' per-pair math (dgs_tpu_torch/csrc/agg_math.cuh)
built for the host with g++ and held against torch: the offset and its wrap,
the collision mask and density, the attention weight, the sinusoidal code
with and without the ladder recurrence, and the backward's code partials
against autograd of the pair's contribution."""

import ctypes
import math
import os
import subprocess

import numpy as np
import pytest
import torch

from dgs_tpu_torch.config import tri_size
from dgs_tpu_torch.ops import formulas as tf

from conftest import make_gaussians

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_HARNESS = r"""
#include "agg_math.cuh"

// out: kept, X[D], G, w, emb, fac
template <int D, bool LADDER>
static int forward(int do_wrap, float period, const float* mu_i,
                   const float* mu_j, const float* con, float r_i, float r_j,
                   float inv_norm, const float* q, const float* key, int K,
                   const float* dt, const float* freq, int nfreq, int E,
                   float* out) {
  float mi[D], mj[D], c[dgs::tri_size(D)], X[D], Xn[D], G = 0.0f;
  for (int d = 0; d < D; ++d) { mi[d] = mu_i[d]; mj[d] = mu_j[d]; }
  for (int t = 0; t < dgs::tri_size(D); ++t) c[t] = con[t];
  dgs::agg_offset<D>(mj, mi, do_wrap, period, X);
  const bool kept = dgs::agg_density<D>(X, c, r_i, r_j, G);
  for (int d = 0; d < D; ++d) { out[1 + d] = X[d]; Xn[d] = X[d] * inv_norm; }
  out[0] = kept ? 1.0f : 0.0f;
  out[1 + D] = kept ? G : 0.0f;
  out[2 + D] = dgs::dot_strided(q, 1, key, 1, K);
  dgs::agg_code<D, LADDER>(Xn, dt, freq, nfreq, E, out[3 + D], out[4 + D]);
  return kept;
}

// out: emb, fac, ddt[2E], dfreq[NF]
template <int D, int NF, bool LADDER>
static void backward(const float* Xn_in, const float* dt, const float* freq,
                     int E, float cemb, float cfac, float* out) {
  float Xn[D], sn[D * NF], cs[D * NF], acc[4 * D * NF + 2 + NF] = {};
  for (int d = 0; d < D; ++d) Xn[d] = Xn_in[d];
  dgs::agg_code_terms<D, NF, LADDER>(Xn, dt, freq, E, out[0], out[1], sn, cs);
  // Two pairs' worth, to hold the accumulation too.
  dgs::agg_code_partials<D, NF>(Xn, dt, E, cemb, cfac, sn, cs, acc);
  dgs::agg_code_partials<D, NF>(Xn, dt, E, cemb, cfac, sn, cs, acc);
  for (int t = 0; t < 2 * E + NF; ++t) out[2 + t] = 0.0f;
  dgs::agg_code_store<D, NF>(acc, E, out + 2, out + 2 + 2 * E);
}

#define ARGS_F do_wrap, period, mu_i, mu_j, con, r_i, r_j, inv_norm, q, key, \
               K, dt, freq, nfreq, E, out
extern "C" int agg_forward(int D, int ladder, int do_wrap, float period,
                           const float* mu_i, const float* mu_j,
                           const float* con, float r_i, float r_j,
                           float inv_norm, const float* q, const float* key,
                           int K, const float* dt, const float* freq,
                           int nfreq, int E, float* out) {
  switch (D * 2 + (ladder ? 1 : 0)) {
    case 2: return forward<1, false>(ARGS_F);
    case 3: return forward<1, true>(ARGS_F);
    case 4: return forward<2, false>(ARGS_F);
    case 5: return forward<2, true>(ARGS_F);
    case 6: return forward<3, false>(ARGS_F);
    case 7: return forward<3, true>(ARGS_F);
  }
  return -1;
}

#define CASE(D, NF)                                                         \
  case (D * 8 + NF) * 2: backward<D, NF, false>(Xn, dt, freq, E, cemb,      \
                                                cfac, out); return 0;      \
  case (D * 8 + NF) * 2 + 1: backward<D, NF, true>(Xn, dt, freq, E, cemb,   \
                                                   cfac, out); return 0;
#define DIM(D) CASE(D, 1) CASE(D, 2) CASE(D, 3) CASE(D, 4)
extern "C" int agg_backward(int D, int nfreq, int ladder, const float* Xn,
                            const float* dt, const float* freq, int E,
                            float cemb, float cfac, float* out) {
  switch ((D * 8 + nfreq) * 2 + (ladder ? 1 : 0)) { DIM(1) DIM(2) DIM(3) }
  return -1;
}
"""


@pytest.fixture(scope="module")
def agg_math(tmp_path_factory):
    d = tmp_path_factory.mktemp("agg_math")
    src = d / "harness.cpp"
    src.write_text(_HARNESS)
    lib = d / "harness.so"
    subprocess.run(
        ["g++", "-std=c++17", "-O2", "-shared", "-fPIC", "-I",
         os.path.join(REPO, "dgs_tpu_torch", "csrc"), "-o", str(lib),
         str(src)], check=True, capture_output=True)
    h = ctypes.CDLL(str(lib))
    fp, i, f = ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_float
    h.agg_forward.argtypes = [i, i, i, f, fp, fp, fp, f, f, f, fp, fp, i, fp,
                              fp, i, i, fp]
    h.agg_forward.restype = i
    h.agg_backward.argtypes = [i, i, i, fp, fp, fp, i, f, f, fp]
    h.agg_backward.restype = i
    return h


def ptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def code(D, nfreq, E, Xn, dt, freq):
    """(emb, fac) of the direct code in torch (ops.aggregation.aggregate's
    loop), differentiable in dt and freq."""
    stride = (E - 1) // D
    emb, fac = dt[E - 1], dt[2 * E - 1]
    for d in range(D):
        for e in range(nfreq):
            phase = (freq[e] * math.pi) * Xn[d]
            s, c = torch.sin(phase), torch.cos(phase)
            i0 = d * stride + 2 * e
            emb = emb + s * dt[i0] + c * dt[i0 + 1]
            fac = fac + s * dt[E + i0] + c * dt[E + i0 + 1]
    return emb, fac


def close(got, ref, rtol, what):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(
        np.asarray(got, np.float32), ref, rtol=rtol,
        atol=1e-5 * max(1.0, float(np.abs(ref).max(initial=0.0))),
        err_msg=what)


@pytest.mark.parametrize("ladder", [False, True])
@pytest.mark.parametrize("D", [1, 2, 3])
def test_pair_forward_matches_torch(agg_math, rng, D, ladder):
    """Offset, mask, density, weight and code of single pairs: the mask
    decision exactly, the values within rtol 2e-4 (the ladder within 1e-4
    of the direct code, the JAX suite's ladder tolerance)."""
    n, K, nfreq = 60, 5, 3
    E = 2 * D * nfreq + 1
    tri = tri_size(D)
    _, _, _, conics = make_gaussians(rng, n, D, 1, sigma_range=(0.1, 0.3))
    mu_i = rng.uniform(-1, 1, (n, D)).astype(np.float32)
    mu_j = (mu_i + rng.normal(0, 0.15, (n, D))).astype(np.float32)
    mu_j[::5] += 2.0                       # across the seam
    r = rng.uniform(0.05, 0.2, (n, 2)).astype(np.float32)
    r[3::11, 0] = 0.0                      # a culled centre
    r[7::13, 1] = 5e-7                     # a culled neighbour
    conics[9::17, 0] *= -30.0              # a positive quadratic form
    inv_norm = rng.uniform(2.0, 20.0, (n,)).astype(np.float32)
    q = rng.normal(size=(n, K)).astype(np.float32)
    key = rng.normal(size=(n, K)).astype(np.float32)
    dt = rng.normal(0, 0.5, (2 * E,)).astype(np.float32)
    freq = ((0.83 * np.arange(1, nfreq + 1)) if ladder
            else rng.uniform(0.5, 3.0, (nfreq,))).astype(np.float32)
    kept_any = dropped_any = False
    for period in (None, 2.0):
        for p in range(n):
            out = np.zeros(5 + D, np.float32)
            kept = agg_math.agg_forward(
                D, int(ladder), int(period is not None), period or 0.0,
                ptr(mu_i[p]), ptr(mu_j[p]), ptr(conics[p]), float(r[p, 0]),
                float(r[p, 1]), float(inv_norm[p]), ptr(q[p]), ptr(key[p]), K,
                ptr(dt), ptr(freq), nfreq, E, ptr(out))
            X = tf.wrap(torch.from_numpy(mu_j[p] - mu_i[p]), period)
            np.testing.assert_array_equal(out[1:1 + D], X.numpy())
            Xs = [X[d] for d in range(D)]
            G, _ = tf.power_terms(
                Xs, [torch.tensor(conics[p, t]) for t in range(tri)])
            rr = np.float32(r[p, 0] + r[p, 1])
            dist2 = sum(x * x for x in Xs)
            mask = (r[p, 1] >= 1e-6 and r[p, 0] >= 1e-6
                    and bool(dist2 <= rr * rr))
            assert kept == int(mask and float(G) > 0.0), (p, period)
            kept_any, dropped_any = kept_any or kept, dropped_any or not kept
            close(out[1 + D], float(G) if mask else 0.0, 2e-4, "G")
            close(out[2 + D], float(q[p] @ key[p]), 2e-4, "w")
            emb, fac = code(D, nfreq, E, X * float(inv_norm[p]),
                            torch.from_numpy(dt), torch.from_numpy(freq))
            close(out[3 + D:5 + D], [float(emb), float(fac)],
                  1e-4 if ladder else 2e-4, f"code pair {p}")
    assert kept_any and dropped_any


@pytest.mark.parametrize("ladder", [False, True])
@pytest.mark.parametrize("nfreq", [1, 2, 3, 4])
@pytest.mark.parametrize("D", [1, 2, 3])
def test_pair_backward_matches_autograd(agg_math, rng, D, nfreq, ladder):
    """The code partials of a pair (accumulated twice) against autograd of
    its contribution cemb emb + cfac fac in the distance transform and the
    per-rung frequencies, within rtol 2e-3 (the JAX suite's gradient
    tolerance); E one larger than 2 D nfreq + 1 leaves an entry no term
    reads, which stays zero."""
    for E in (2 * D * nfreq + 1, 2 * D * nfreq + 1 + D):
        if (E - 1) // D // 2 != nfreq:
            continue
        dt = rng.normal(0, 0.5, (2 * E,)).astype(np.float32)
        freq = ((0.83 * np.arange(1, nfreq + 1)) if ladder
                else rng.uniform(0.5, 3.0, (nfreq,))).astype(np.float32)
        for _ in range(12):
            Xn = rng.uniform(-1.5, 1.5, (D,)).astype(np.float32)
            cemb, cfac = (float(np.float32(v)) for v in rng.normal(size=2))
            out = np.full(2 + 2 * E + nfreq, np.nan, np.float32)
            assert agg_math.agg_backward(D, nfreq, int(ladder), ptr(Xn),
                                         ptr(dt), ptr(freq), E, cemb, cfac,
                                         ptr(out)) == 0
            tdt = torch.from_numpy(dt).requires_grad_()
            tfreq = torch.from_numpy(freq).requires_grad_()
            emb, fac = code(D, nfreq, E, torch.from_numpy(Xn), tdt, tfreq)
            close(out[:2], [emb.item(), fac.item()],
                  1e-4 if ladder else 2e-4, "code")
            ddt, dfreq = torch.autograd.grad(2.0 * (cemb * emb + cfac * fac),
                                             (tdt, tfreq))
            close(out[2:2 + 2 * E], ddt.numpy(), 2e-3, f"ddt E={E}")
            close(out[2 + 2 * E:], dfreq.numpy(), 2e-3, f"dfreq E={E}")
