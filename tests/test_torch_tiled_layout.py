"""The layout the two tiled CUDA kernels share (csrc/tiled_layout.cuh) and
the ranges their warps are handed (kernels.tiled.entry_ranges /
sample_ranges), on the CPU: the header's fills are built for the host with
g++ and held against a numpy replica of the records, the scaled torus wrap
against the dividing one, and the warp sweep (a row keeps the columns of its
own tile within its run's range) against the plain rule (every pair of equal
tiles) on binnings with straddling runs, empty tiles, sentinel entries and
pad rows."""

import ctypes
import os
import subprocess

import numpy as np
import pytest
import torch

from dgs_tpu_torch.binning import grid as tgrid
from dgs_tpu_torch.config import SamplerConfig, tri_size
from dgs_tpu_torch.kernels import tiled as ttiled
from dgs_tpu_torch.ops import formulas as tf

from conftest import make_gaussians, make_samples

torch.set_num_threads(2)

ORDERS = ("value", "derivative", "laplacian", "third")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WARP = 32

_HARNESS = r"""
#include "tiled_layout.cuh"

template <int D, int CB>
static int entry(const float* geom_e, long long ep, int C, int c0,
                 float* out) {
  constexpr int NF = 4 * dgs::fwd_record_vecs(D, CB);
  float f[NF];
  dgs::stage_entry<D, CB>(geom_e, ep, C, c0, f);
  for (int i = 0; i < NF; ++i) out[i] = f[i];
  return NF;
}

extern "C" int stage_entry(int D, int CB, const float* geom_e, long long ep,
                           int C, int c0, float* out) {
  switch (D * 8 + CB) {
#define CASE(D, CB) case D * 8 + CB: return entry<D, CB>(geom_e, ep, C, c0, out);
    CASE(1, 1) CASE(1, 2) CASE(1, 4) CASE(2, 1) CASE(2, 2) CASE(2, 4)
    CASE(3, 1) CASE(3, 2) CASE(3, 4)
#undef CASE
  }
  return -1;
}

template <int D, int M, int CB>
static int sample(const float* smp_s, const float* ct_s, long long np, int C,
                  int c0, const dgs::OrderRows& rows, float* out) {
  constexpr int NG = 4 * (dgs::bwd_record_vecs(dgs::total_unique(D, M), CB) - 1);
  float head[4], g[NG];
  dgs::stage_sample<D, M, CB>(smp_s, ct_s, np, C, c0, rows, head, g);
  for (int i = 0; i < 4; ++i) out[i] = head[i];
  for (int i = 0; i < NG; ++i) out[4 + i] = g[i];
  return 4 + NG;
}

extern "C" int stage_sample(int D, int mask, int CB, const float* smp_s,
                            const float* ct_s, long long np, int C, int c0,
                            int r_value, int r_derivative, int r_laplacian,
                            int r_third, float* out) {
  const dgs::OrderRows rows{r_value, r_derivative, r_laplacian, r_third};
  switch ((D * 16 + mask) * 8 + CB) {
#define CASE(D, M, CB) \
  case (D * 16 + M) * 8 + CB: \
    return sample<D, M, CB>(smp_s, ct_s, np, C, c0, rows, out);
#define MASKS(D, CB) CASE(D, 1, CB) CASE(D, 5, CB) CASE(D, 7, CB) \
  CASE(D, 13, CB) CASE(D, 15, CB)
    MASKS(1, 1) MASKS(1, 4) MASKS(2, 1) MASKS(2, 2) MASKS(2, 4) MASKS(3, 4)
#undef MASKS
#undef CASE
  }
  return -1;
}

extern "C" int staged_index(int v, int j) { return dgs::staged_index(v, j); }
extern "C" float exact_inv_period(float p) { return dgs::exact_inv_period(p); }
extern "C" float wrap(float x, float p) { return dgs::wrap(x, p); }
extern "C" float wrap_by(int wrapped, float x, float p) {
  const float inv = dgs::exact_inv_period(p);
  return wrapped ? dgs::wrap_by<true>(x, p, inv)
                 : dgs::wrap_by<false>(x, p, inv);
}
"""


@pytest.fixture(scope="module")
def layout(tmp_path_factory):
    d = tmp_path_factory.mktemp("tiled_layout")
    src = d / "harness.cpp"
    src.write_text(_HARNESS)
    lib = d / "harness.so"
    subprocess.run(
        ["g++", "-std=c++17", "-O2", "-shared", "-fPIC", "-I",
         os.path.join(REPO, "dgs_tpu_torch", "csrc"), "-o", str(lib),
         str(src)], check=True, capture_output=True)
    h = ctypes.CDLL(str(lib))
    fp, i, ll = ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_longlong
    h.stage_entry.argtypes = [i, i, fp, ll, i, i, fp]
    h.stage_sample.argtypes = [i, i, i, fp, fp, ll, i, i, i, i, i, i, fp]
    h.exact_inv_period.argtypes = [ctypes.c_float]
    h.exact_inv_period.restype = ctypes.c_float
    h.wrap.argtypes = [ctypes.c_float, ctypes.c_float]
    h.wrap.restype = ctypes.c_float
    h.wrap_by.argtypes = [i, ctypes.c_float, ctypes.c_float]
    h.wrap_by.restype = ctypes.c_float
    return h


def _ptr(a, offset=0):
    return ctypes.cast(a.ctypes.data + 4 * offset,
                       ctypes.POINTER(ctypes.c_float))


@pytest.mark.parametrize("D", [1, 2, 3])
@pytest.mark.parametrize("CB", [1, 2, 4])
def test_stage_entry_matches_numpy(layout, rng, D, CB):
    """A forward record is [tile, mu', conic, the pass's CB value channels
    (zero from channel C on)], zero-padded to whole float4 vectors, read
    from column e of the (1 + D + tri + C, Ep) geom array."""
    tri, Ep = tri_size(D), 37
    head = 1 + D + tri
    for C in (1, 2, 3, 4, 6):
        geom = rng.normal(size=(head + C, Ep)).astype(np.float32)
        for c0 in range(0, C, CB):
            for e in (0, 5, Ep - 1):
                out = np.full(64, np.nan, np.float32)
                n = layout.stage_entry(D, CB, _ptr(geom, e), Ep, C, c0,
                                       _ptr(out))
                assert n == 4 * (-(-(head + CB) // 4))
                want = np.zeros(n, np.float32)
                want[:head] = geom[:head, e]
                live = min(CB, C - c0)
                want[head:head + live] = geom[head + c0:head + c0 + live, e]
                np.testing.assert_array_equal(out[:n], want)


@pytest.mark.parametrize("D,CB", [(1, 1), (1, 4), (2, 1), (2, 2), (2, 4),
                                  (3, 4)])
def test_stage_sample_matches_numpy(layout, rng, D, CB):
    """A backward record is {tile, x, zeros}, then the cotangents of the
    pass's channels packed k-major (float k * CB + c is row component(k) * C
    + c0 + c of the (K * C, Np) cotangent, zero from channel C on), for the
    canonical order sets and one whose orders sit out of canonical order."""
    Np = 41
    order_sets = [("value",), ("value", "laplacian"),
                  ("value", "derivative", "laplacian"),
                  ("laplacian", "value", "third"), ORDERS]
    for orders in order_sets:
        mask, rows = ttiled._order_rows(orders, D)
        K = ttiled.total_unique(orders, D)
        # unique component k in canonical order -> its packed component
        comp = [rows[o] + u for o in ORDERS if o in orders
                for u in range(tf.n_unique(o, D))]
        for C in (1, 2, 3, 6):
            smp = rng.normal(size=(D + 1, Np)).astype(np.float32)
            ct = rng.normal(size=(K * C, Np)).astype(np.float32)
            for c0 in range(0, C, CB):
                for s in (0, 7, Np - 1):
                    out = np.full(4 + 4 * 24, np.nan, np.float32)
                    n = layout.stage_sample(
                        D, mask, CB, _ptr(smp, s), _ptr(ct, s), Np, C, c0,
                        rows["value"], rows["derivative"], rows["laplacian"],
                        rows["third"], _ptr(out))
                    assert n == 4 + 4 * (-(-(K * CB) // 4))
                    want = np.zeros(n, np.float32)
                    want[0] = smp[D, s]
                    want[1:1 + D] = smp[:D, s]
                    for k in range(K):
                        for c in range(min(CB, C - c0)):
                            want[4 + k * CB + c] = ct[comp[k] * C + c0 + c, s]
                    np.testing.assert_array_equal(
                        out[:n], want, err_msg=f"{orders} C={C} c0={c0}")


def test_staged_index_is_vector_major(layout):
    """Vector v of staged row j sits at v * 32 + j: consecutive lanes store
    consecutive float4 (no bank conflicts), a sweep reads one address."""
    for v in range(5):
        for j in (0, 1, 31):
            assert layout.staged_index(v, j) == v * WARP + j


def test_scaled_wrap_is_exact_for_power_of_two_periods(layout, rng):
    """wrap_by multiplies by 1 / period only where that is bitwise equal to
    the division (a power-of-two period), divides otherwise, and leaves x
    alone in the unwrapped kernels; all equal formulas.wrap."""
    for period in (2.0, 0.5, 1.0, 8.0):
        assert layout.exact_inv_period(period) == np.float32(1.0 / period)
    for period in (3.0, 1.7, 2.0000002, 0.0, -2.0):
        assert layout.exact_inv_period(period) == 0.0
    xs = np.concatenate([
        rng.uniform(-5.0, 5.0, 400), [1.0, -1.0, 3.0, -3.0, 0.0, 0.99999994],
        np.nextafter(np.float32(1.0), np.float32(2.0), dtype=np.float32)[None],
    ]).astype(np.float32)
    for period in (2.0, 0.5, 3.0, 1.7):
        ref = tf.wrap(torch.from_numpy(xs), period).numpy()
        for x, r in zip(xs, ref):
            assert layout.wrap_by(1, float(x), period) == r
            assert layout.wrap(float(x), period) == r
            assert layout.wrap_by(0, float(x), period) == x


def _binning(rng, D, P, N, tile, holes=False):
    """A small torch binning state on the CPU; ``holes`` leaves tiles with
    entries and no samples and tiles with samples and no entries."""
    m, v, cov, c = make_gaussians(
        rng, P, D, 2, sigma_range=(0.01, 0.03) if holes else (0.02, 0.2))
    s = make_samples(rng, N, D)
    if holes:
        s[:, 0] = -np.abs(s[:, 0])
        m[:, -1] = -0.2 - 0.8 * np.abs(m[:, -1])
    cfg = SamplerConfig(tile_size=tile, max_tiles_per_gaussian=8).with_dims(D)
    m, v, cov, c, s = map(torch.from_numpy, (m, v, cov, c, s))
    state = tgrid.build(cfg, m, cov, s)
    assert int(state.overflow) == 0 and int(state.entry_overflow) == 0
    return cfg, state, (m, v, c), s


def _sweep_pairs(row_tiles, col_tiles, lo, n):
    """The (row, column) pairs the kernels' warp sweep keeps: a run of 32
    rows walks columns [lo, lo + n), and a row keeps the columns of its own
    tile."""
    kept = set()
    for w in range(len(lo)):
        rows = np.arange(w * WARP, (w + 1) * WARP)
        tiles = row_tiles[rows]
        for j in range(lo[w], lo[w] + n[w]):
            for r, t in zip(rows, tiles):
                if col_tiles[j] == t:
                    kept.add((int(r), j))
    return kept


@pytest.mark.parametrize("D,tile,holes", [(1, 0.25, False), (2, 0.5, False),
                                          (2, 0.25, True), (3, 0.5, False)])
def test_warp_sweep_keeps_exactly_the_equal_tile_pairs(rng, D, tile, holes):
    """entry_ranges / sample_ranges at one warp's granularity: the pairs the
    sweep keeps are exactly the pairs of equal tiles, in both directions,
    with runs on one tile, runs that straddle several, tiles
    without samples or entries, sentinel entries and pad rows."""
    cfg, state, (m, v, c), s = _binning(rng, D, 60, 700, tile, holes)
    _, _, geom, Ep = ttiled.prepare_entries(state, m, v, c, ttiled.BLOCK_E,
                                            cfg=cfg)
    smp, _, Np = ttiled.prepare_samples(state, s, ttiled.BLOCK_N)
    assert ttiled.BLOCK_N == WARP and ttiled.BLOCK_E == WARP
    assert Np % WARP == 0 and Ep % WARP == 0
    e_tile, s_tile = geom[0].numpy(), smp[D].numpy()
    T = tgrid.num_tiles(cfg, D)
    want = {(i, j) for i in range(Np) for j in range(Ep)
            if s_tile[i] == e_tile[j]}
    assert want, "the case pairs nothing"
    # pad samples and sentinel entries are present
    assert (s_tile == -2.0).any()
    assert ((e_tile < 0) | (e_tile >= T)).any()
    n_ent = np.bincount(e_tile[(e_tile >= 0) & (e_tile < T)].astype(int),
                        minlength=T)
    n_smp = np.bincount(s_tile[s_tile >= 0].astype(int), minlength=T)
    if holes:
        assert ((n_ent > 0) & (n_smp == 0)).any()
        assert ((n_ent == 0) & (n_smp > 0)).any()

    lo, n = (t.numpy() for t in ttiled.entry_ranges(state, Np))
    assert lo.shape == (Np // WARP,)
    fwd = _sweep_pairs(s_tile, e_tile, lo, n)
    assert fwd == want
    runs = s_tile.reshape(-1, WARP)
    one = (runs == runs[:, :1]).all(axis=1)
    assert (~one).any()
    if D < 3 and not holes:     # enough samples a tile for a whole run
        assert one.any()
    # a one-tile run sweeps nothing but its tile's entries
    for w in np.nonzero(one & (runs[:, 0] >= 0))[0]:
        assert n[w] == n_ent[int(runs[w, 0])]

    s_lo, s_n = (t.numpy() for t in ttiled.sample_ranges(state, Ep))
    assert s_lo.shape == (Ep // WARP,)
    bwd = _sweep_pairs(e_tile, s_tile, s_lo, s_n)
    assert {(i, j) for j, i in bwd} == want
    # sentinel and pad entries pair with nothing; pad samples are in no range
    dead = np.nonzero((e_tile < 0) | (e_tile >= T))[0]
    assert not {j for j, _ in bwd} & set(dead.tolist())
    assert (s_lo + s_n).max() <= state.s_perm.shape[0]
