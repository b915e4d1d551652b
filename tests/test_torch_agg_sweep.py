"""The warp sweep of the aggregation kernels (dgs_tpu_torch/csrc/
agg_sweep.cuh, agg_forward.cu, agg_backward.cu) on the CPU.

* The CUDA sources themselves, built with g++ against a small emulation of
  the CUDA runtime (each lane a host thread, the warp primitives exchanges
  behind a barrier, blocks one after another), are held against the plain
  torch versions on small structures: the queue's drains, several rows a
  warp, passes above the widest partials, pads, sentinels and empty ranges.
  This checks the kernels' logic, not their speed or the card's arithmetic:
  chip_smoke.py holds the same cases on the H100.
* The header's host helpers (queue position, row slot, the code columns
  and partials) are built with g++ and held against numpy and agg_math.cuh.
* kernels.aggregate.warp_schedule, and a model of the first aggregation
  kernels' lane_per_row schedule kept here to compare with, are held
  against brute-force counts,
  and a numpy replica of the sweep (queue, drains, the per-row fixed-order
  reduction) against forward_plain / backward_plain.
"""

import ctypes
import math

import numpy as np
import pytest
import torch

from dgs_tpu_torch.binning import grid as tgrid
from dgs_tpu_torch.config import SamplerConfig
from dgs_tpu_torch.kernels import aggregate as kagg
from dgs_tpu_torch.ops import aggregation as tagg
from dgs_tpu_torch.oracle.dense import radii as tradii

import cuda_emulation
from conftest import make_gaussians

torch.set_num_threads(2)

CSRC = cuda_emulation.CSRC
WARP = kagg.WARP

_HELPERS = r"""
#include "agg_sweep.cuh"

extern "C" int queue_pos(int head, int count, int rank) {
  return dgs::queue_pos(head, count, rank);
}
extern "C" int sweep_slot(const int* pre, int nrows, int v) {
  return dgs::sweep_slot(pre, nrows, v);
}

// out[t] = code_column(t); scattered: agg_code_store of acc[t] = t + 1.
template <int D, int NF>
static void columns(int E, int* out, float* scattered) {
  constexpr int N = 4 * D * NF + 2 + NF;
  float acc[N];
  for (int t = 0; t < N; ++t) {
    out[t] = dgs::code_column<D, NF>(t, E);
    acc[t] = (float)(t + 1);
  }
  dgs::agg_code_store<D, NF>(acc, E, scattered, scattered + 2 * E);
}

// out: code_contrib with stride 3; ref: agg_code_partials from zero.
template <int D, int NF>
static void contrib(const float* Xn_in, const float* dt, const float* freq,
                    int E, float cemb, float cfac, float* out, float* ref) {
  constexpr int N = 4 * D * NF + 2 + NF;
  float Xn[D], sn[D * NF], cs[D * NF], emb, fac, acc[N] = {};
  for (int d = 0; d < D; ++d) Xn[d] = Xn_in[d];
  dgs::agg_code_terms<D, NF, false>(Xn, dt, freq, E, emb, fac, sn, cs);
  dgs::code_contrib<D, NF>(Xn, dt, E, cemb, cfac, sn, cs, out, 3);
  dgs::agg_code_partials<D, NF>(Xn, dt, E, cemb, cfac, sn, cs, acc);
  for (int t = 0; t < N; ++t) ref[t] = acc[t];
}

#define CASE(D, NF)                                                     \
  case D * 8 + NF:                                                      \
    columns<D, NF>(E, out, scattered);                                  \
    return 0;
#define DIM(D) CASE(D, 1) CASE(D, 2) CASE(D, 3) CASE(D, 4)
extern "C" int code_columns(int D, int nfreq, int E, int* out,
                            float* scattered) {
  switch (D * 8 + nfreq) { DIM(1) DIM(2) DIM(3) }
  return -1;
}
#undef CASE
#define CASE(D, NF)                                                     \
  case D * 8 + NF:                                                      \
    contrib<D, NF>(Xn, dt, freq, E, cemb, cfac, out, ref);              \
    return 0;
extern "C" int code_contrib(int D, int nfreq, const float* Xn,
                            const float* dt, const float* freq, int E,
                            float cemb, float cfac, float* out, float* ref) {
  switch (D * 8 + nfreq) { DIM(1) DIM(2) DIM(3) }
  return -1;
}
"""


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """agg_forward.cu, agg_backward.cu and agg_totals.cu built for the host
    against the emulated runtime (cuda_emulation.build)."""
    fwd, bwd, tot = cuda_emulation.build(
        tmp_path_factory.mktemp("agg_emulated"),
        ["agg_forward", "agg_backward", "agg_totals"])
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    tot.dgs_agg_totals.argtypes = [p, i, p, i, i, p, i, i, f, p, p]
    fwd.dgs_agg_forward.argtypes = [p, p, i, p, i, i, p, p, i, i, i, i, i, i,
                                    f, i, i, i, p, p, p]
    for fn in (bwd.dgs_agg_backward_entries, bwd.dgs_agg_backward_centres):
        fn.argtypes = [p, p, i, p, i, i, p, p, p, p, i, i, i, i, i, i, f, i,
                       i, p, p]
    return fwd, bwd, tot


@pytest.fixture(scope="module")
def helpers(tmp_path_factory):
    d = tmp_path_factory.mktemp("agg_sweep_helpers")
    (d / "harness.cpp").write_text(_HELPERS)
    lib = str(d / "harness.so")
    cuda_emulation.wait([cuda_emulation.gxx(
        ["-O2", "-I", CSRC, "-o", lib, str(d / "harness.cpp")])])
    h = ctypes.CDLL(lib)
    ip, fp = ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_float)
    i, f = ctypes.c_int, ctypes.c_float
    h.queue_pos.argtypes = [i, i, i]
    h.sweep_slot.argtypes = [ip, i, i]
    h.code_columns.argtypes = [i, i, i, ip, fp]
    h.code_contrib.argtypes = [i, i, fp, fp, fp, i, f, f, fp, fp]
    return h


def _ptr(a):
    return ctypes.c_void_p(a.data_ptr())


def structure(seed, D, P, L, K, nfreq, *, open_domain=False,
              sigma_range=(0.05, 0.25), cull=0, tile_range=None,
              ladder=False, E=None):
    """A seeded cloud's kernel structure and operands on the CPU: (agg,
    ent_fk, ctr_geo, dtf).  ``tile_range`` is a pair of fractions of the
    tile count; ``E`` the distance transform's half length (default
    2 D nfreq + 1)."""
    rng = np.random.default_rng(seed)
    means, _, covs, conics = make_gaussians(rng, P, D, 1,
                                            sigma_range=sigma_range)
    means, covs, conics = map(torch.from_numpy, (means, covs, conics))
    rad = tradii(covs, D, 3.0, 1e-12)
    if cull:
        rad[::cull] = 0.0
    cfg = (SamplerConfig(period=None, upper_bounds=(1.0,) * D)
           if open_domain else SamplerConfig()).with_dims(D)
    cfg, plan = tagg.plan_pallas(cfg, means, rad)
    if tile_range is not None:
        T = tgrid.num_tiles(cfg, D)
        tile_range = (int(tile_range[0] * T), int(tile_range[1] * T))
    agg = tagg.preprocess_pallas(cfg, means, conics, rad, plan,
                                 tile_range=tile_range)
    assert int(agg.overflow) == 0
    E = E or 2 * D * nfreq + 1
    freq = (0.83 * np.arange(1, nfreq + 1) if ladder
            else rng.uniform(0.5, 2.5, nfreq))
    params = [torch.from_numpy(a.astype(np.float32)) for a in (
        rng.normal(size=(P, L)), rng.normal(size=(P, K)),
        rng.normal(size=(P, K)), freq, rng.normal(0, 0.5, 2 * E))]
    return (agg, *tagg.kernel_operands(*params, agg))


def run_forward(lib, D, L, K, nfreq, period, agg, ent_fk, ctr_geo, dtf,
                ladder, with_totals, rows):
    Cp, Ep = ctr_geo.shape[0], agg.ent_geo.shape[1]
    E = (dtf.shape[1] - nfreq) // 2
    out = torch.full((Cp, L), float("nan"))
    tot = torch.full((Cp, 1) if with_totals else (1,), float("nan"))
    err = lib.dgs_agg_forward(
        _ptr(agg.ent_geo), _ptr(ent_fk), Ep, _ptr(ctr_geo), D + 3 + K, Cp,
        _ptr(agg.ctr_ent), _ptr(dtf), D, L, K, nfreq, E,
        int(period is not None), period or 0.0, int(ladder),
        int(with_totals), rows, _ptr(out), _ptr(tot), None)
    assert err == 0
    return (out, tot) if with_totals else out


def run_backward(lib, D, L, K, nfreq, period, agg, ent_fk, ctr_geo, dtf,
                 gpre, gsum, ladder, rows):
    Cp, Ep = ctr_geo.shape[0], agg.ent_geo.shape[1]
    E = (dtf.shape[1] - nfreq) // 2
    dent = torch.full((Ep, L + K), float("nan"))     # entry-major
    dctr = torch.full((Cp, K + 2 * E + nfreq), float("nan"))
    common = (_ptr(agg.ent_geo), _ptr(ent_fk), Ep, _ptr(ctr_geo), D + 3 + K,
              Cp)
    tail = (_ptr(dtf), _ptr(gpre), _ptr(gsum), D, L, K, nfreq, E,
            int(period is not None), period or 0.0, int(ladder))
    assert lib.dgs_agg_backward_entries(*common, _ptr(agg.ent_ctr), *tail,
                                        rows[0], _ptr(dent), None) == 0
    assert lib.dgs_agg_backward_centres(*common, _ptr(agg.ctr_ent), *tail,
                                        rows[1], _ptr(dctr), None) == 0
    return dent.T, dctr


def run_totals(lib, D, period, agg):
    """The totals kernel on the structure's operands."""
    Cp, cols = agg.ctr_static.shape
    Ep = agg.ent_geo.shape[1]
    out = torch.full((Cp, 1), float("nan"))
    assert lib.dgs_agg_totals(
        _ptr(agg.ent_geo), Ep, _ptr(agg.ctr_static), cols, Cp,
        _ptr(agg.ctr_ent), D, int(period is not None), period or 0.0,
        _ptr(out), None) == 0
    return out


def assert_close(got, ref, rtol, what):
    ref = ref.numpy()
    np.testing.assert_allclose(
        got.numpy(), ref, rtol=rtol,
        atol=1e-5 * max(1.0, float(np.abs(ref).max(initial=0.0))),
        err_msg=what)


def most_colliding(agg):
    """The largest number of masked pairs of one centre."""
    row, _, _ = kagg._masked_pairs(agg.ctr_static.shape[1] - 3, None,
                                   agg.ctr_ent, agg.ent_geo, agg.ctr_static)
    return int(torch.bincount(row).max()) if row.numel() else 0


# The widths of the paths and the sweep's edges: (D, L, K, nfreq, ladder,
# open domain, P, sigma range, culled every, tile range, rows a warp; None
# takes the wrappers' default).
CASES = {
    "d2_point": (2, 8, 8, 4, False, False, 150, (0.05, 0.25), 7, None, None),
    "d2_dynamics": (2, 1, 4, 2, True, False, 150, (0.05, 0.25), 0, None,
                    None),
    # more than 32 colliding pairs of one row: several drains a row
    "d1_dense": (1, 5, 3, 3, False, False, 120, (0.15, 0.35), 0, None, 1),
    "d1_dense_rows32": (1, 2, 6, 1, True, True, 120, (0.15, 0.35), 5, None,
                        32),
    "d3_nfreq4_open": (3, 3, 5, 4, True, True, 150, (0.1, 0.3), 0, None, 3),
    "d2_nfreq1_open": (2, 2, 3, 1, False, True, 150, (0.05, 0.25), 0, None,
                       1),
    # tiles with one centre each
    "d2_sparse": (2, 4, 3, 2, False, False, 60, (0.01, 0.015), 0, None, 4),
    "d2_above_one_pass": (2, 12, 20, 2, True, False, 150, (0.05, 0.25), 5,
                          None, None),
    "d2_tile_range": (2, 5, 3, 2, False, False, 150, (0.05, 0.25), 7,
                      (0.25, 0.6), 5),
}


@pytest.fixture(scope="module")
def cases():
    out = {}
    for n, (name, (D, L, K, nfreq, ladder, open_domain, P, sigma, cull,
                   tile_range, rows)) in enumerate(CASES.items()):
        ops = structure(20 + n, D, P, L, K, nfreq, open_domain=open_domain,
                        sigma_range=sigma, cull=cull, ladder=ladder,
                        tile_range=tile_range)
        out[name] = (D, L, K, nfreq, ladder, rows, *ops)
    return out


def test_cases_reach_the_edges(cases):
    """The structures hold what the cases are for: a row with more than 32
    colliding pairs, tiles with a single centre, rows with an empty range
    (pads, culled radii, centres outside a tile range)."""
    assert most_colliding(cases["d1_dense"][6]) > WARP
    ce = cases["d2_sparse"][6].ctr_ent
    live = ce[1] > ce[0]
    _, counts = torch.unique(ce[0][live], return_counts=True)
    assert int((counts == 1).sum()) > 10
    for name, case in cases.items():
        agg = case[6]
        assert bool((agg.ctr_ent[1] == agg.ctr_ent[0]).any()), name
        assert bool((agg.ent_ctr[1] == agg.ent_ctr[0]).any()), name
    tr = cases["d2_tile_range"][6]
    assert int((tr.cid == tr.pos.shape[0]).sum()) > tr.pos.shape[0] // 4


@pytest.mark.parametrize("name", list(CASES))
def test_emulated_kernels_match_plain(emulated, cases, name):
    """agg_forward.cu (with and without totals) and both kernels of
    agg_backward.cu against forward_plain / backward_plain at the rows a
    warp of the case, unwrapped and with the wrap (a no-op on the
    pre-shifted entries); sentinel rows exactly zero; a second run bitwise
    equal."""
    fwd, bwd, _ = emulated
    D, L, K, nfreq, ladder, rows, agg, ent_fk, ctr_geo, dtf = cases[name]
    rows_f = rows or kagg.ROWS_PER_WARP["forward"]
    rows_b = ((rows, rows) if rows else
              (kagg.ROWS_PER_WARP["backward_entries"],
               kagg.ROWS_PER_WARP["backward_centres"]))
    P = agg.pos.shape[0]
    dead_c, dead_e = agg.cid == P, agg.ent_gid == P
    g = torch.Generator().manual_seed(3)
    gpre = torch.randn((ctr_geo.shape[0], L), generator=g)
    gsum = gpre.sum(dim=1, keepdim=True)
    ranges = (agg.ctr_ent, agg.ent_ctr)
    for period in (None, 2.0):
        ref, ref_tot = kagg.forward_plain(
            D, L, K, nfreq, period, agg.ctr_ent, agg.ent_geo, ent_fk,
            ctr_geo, dtf, ladder=ladder, with_totals=True)
        out = run_forward(fwd, D, L, K, nfreq, period, agg, ent_fk, ctr_geo,
                          dtf, ladder, False, rows_f)
        assert_close(out, ref, 2e-4, f"{name} forward")
        assert not out[dead_c].any()
        if period is None:
            out, tot = run_forward(fwd, D, L, K, nfreq, period, agg, ent_fk,
                                   ctr_geo, dtf, ladder, True, rows_f)
            assert_close(out, ref, 2e-4, f"{name} forward with totals")
            assert_close(tot, ref_tot, 2e-4, f"{name} totals")
        got = run_backward(bwd, D, L, K, nfreq, period, agg, ent_fk, ctr_geo,
                           dtf, gpre, gsum, ladder, rows_b)
        ref_e, ref_c = kagg.backward_plain(
            D, L, K, nfreq, period, ranges, agg.ent_geo, ent_fk, ctr_geo,
            dtf, gpre, gsum, ladder=ladder)
        assert_close(got[0], ref_e, 2e-3, f"{name} entry-major")
        assert_close(got[1], ref_c, 2e-3, f"{name} centre-major")
        assert not got[0][:, dead_e].any() and not got[1][dead_c].any()
    again = run_backward(bwd, D, L, K, nfreq, 2.0, agg, ent_fk, ctr_geo, dtf,
                         gpre, gsum, ladder, rows_b)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("name", list(CASES) + ["d1_crowded"])
def test_emulated_totals_match_plain(emulated, cases, name):
    """agg_totals.cu against totals_plain (rtol 2e-4), unwrapped and with
    the wrap: D = 1-3, open and wrapped domains, pads, culled radii, empty
    ranges, single-centre tiles, a tile range; "d1_crowded" has centres
    with more colliding pairs than a warp's queue holds (224 > 128) and
    blocks whose entry range spans two staged chunks (637 > 512 entries).
    Sentinel centres come back zero; a second run is bitwise equal."""
    lib = emulated[2]
    if name == "d1_crowded":
        D = 1
        agg = structure(5, D, 400, 1, 1, 1, sigma_range=(0.3, 0.5))[0]
        assert most_colliding(agg) > 128
        lo, hi = agg.ctr_ent.long()
        live = hi > lo
        block = torch.arange(lo.shape[0]) // kagg.BLOCK
        assert any(int(hi[m].max() - lo[m].min()) > 512
                   for m in (live & (block == b)
                             for b in range(int(block[-1]) + 1))
                   if bool(m.any()))
    else:
        D, agg = cases[name][0], cases[name][6]
    dead = agg.cid == agg.pos.shape[0]
    for period in (None, 2.0):
        ref = kagg.totals_plain(D, period, agg.ctr_ent, agg.ent_geo,
                                agg.ctr_static)
        got = run_totals(lib, D, period, agg)
        assert_close(got, ref, 2e-4, f"{name} totals")
        assert not got[dead].any()
        assert torch.equal(run_totals(lib, D, period, agg), got)


def test_emulated_kernels_with_unused_code_columns(emulated):
    """A distance transform whose stride (E - 1) // D is 2 nfreq + 1 (D = 2,
    nfreq = 2, E = 11): the forward kernel and both backward kernels
    against the plain versions; the centre-major kernel leaves exactly the
    unused columns of dctr unwritten (the wrapper zeroes them)."""
    fwd, bwd, _ = emulated
    D, L, K, nfreq, E = 2, 3, 4, 2, 11
    agg, ent_fk, ctr_geo, dtf = structure(40, D, 150, L, K, nfreq, cull=7,
                                          E=E)
    rows_b = (kagg.ROWS_PER_WARP["backward_entries"],
              kagg.ROWS_PER_WARP["backward_centres"])
    out = run_forward(fwd, D, L, K, nfreq, None, agg, ent_fk, ctr_geo, dtf,
                      False, False, kagg.ROWS_PER_WARP["forward"])
    assert_close(out, kagg.forward_plain(D, L, K, nfreq, None, agg.ctr_ent,
                                         agg.ent_geo, ent_fk, ctr_geo, dtf),
                 2e-4, "forward")
    g = torch.Generator().manual_seed(4)
    gpre = torch.randn((ctr_geo.shape[0], L), generator=g)
    gsum = gpre.sum(dim=1, keepdim=True)
    dent, dctr = run_backward(bwd, D, L, K, nfreq, None, agg, ent_fk,
                              ctr_geo, dtf, gpre, gsum, False, rows_b)
    ref_e, ref_c = kagg.backward_plain(
        D, L, K, nfreq, None, (agg.ctr_ent, agg.ent_ctr), agg.ent_geo,
        ent_fk, ctr_geo, dtf, gpre, gsum)
    assert_close(dent, ref_e, 2e-3, "entry-major")
    unused = [K + part + d * (E - 1) // D + 2 * nfreq
              for part in (0, E) for d in range(D)]
    written = torch.ones(dctr.shape[1], dtype=torch.bool)
    written[unused] = False
    assert bool(dctr[:, ~written].isnan().all())
    assert not ref_c[:, ~written].any()
    assert_close(dctr[:, written], ref_c[:, written], 2e-3, "centre-major")


def test_queue_and_slot_helpers(helpers, rng):
    """queue_pos is the ring position of a push; sweep_slot the row of a
    candidate of the concatenated ranges (rows with an empty range are
    skipped)."""
    for _ in range(200):
        # A queue of 128: at most 31 wait, a step pushes at most 64.
        head, count, rank = rng.integers(0, 128), rng.integers(0, 32), \
            rng.integers(0, 64)
        assert helpers.queue_pos(int(head), int(count), int(rank)) == \
            (head + count + rank) % 128
    for nrows in (1, 2, 7, 32):
        lens = rng.integers(0, 5, nrows)
        lens[rng.integers(0, nrows)] += 1
        pre = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int32)
        ptr = pre.ctypes.data_as(ctypes.POINTER(ctypes.c_int))
        for v in range(int(lens.sum())):
            want = int(np.searchsorted(pre, v, side="right")) - 1
            assert lens[want] > 0 and pre[want] <= v < pre[want] + lens[want]
            assert helpers.sweep_slot(ptr, nrows, v) == want, (lens, v)


@pytest.mark.parametrize("nfreq", [1, 2, 3, 4])
@pytest.mark.parametrize("D", [1, 2, 3])
def test_code_columns_and_partials(helpers, rng, D, nfreq):
    """code_column places partial t where agg_code_store puts it, covering
    the 2E + nfreq code columns once each; code_contrib writes
    agg_code_partials' values (from zero) bitwise, at a stride."""
    E = 2 * D * nfreq + 1
    n = 4 * D * nfreq + 2 + nfreq
    cols = np.zeros(n, np.int32)
    scattered = np.zeros(2 * E + nfreq, np.float32)
    assert helpers.code_columns(
        D, nfreq, E, cols.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        scattered.ctypes.data_as(ctypes.POINTER(ctypes.c_float))) == 0
    assert sorted(cols.tolist()) == list(range(2 * E + nfreq))
    np.testing.assert_array_equal(scattered[cols], np.arange(1, n + 1))
    fp = ctypes.POINTER(ctypes.c_float)
    for _ in range(5):
        Xn = rng.normal(0, 3, D).astype(np.float32)
        dt = rng.normal(0, 0.5, 2 * E).astype(np.float32)
        freq = rng.uniform(0.5, 3, nfreq).astype(np.float32)
        out = np.full(3 * n, np.nan, np.float32)
        ref = np.zeros(n, np.float32)
        assert helpers.code_contrib(
            D, nfreq, Xn.ctypes.data_as(fp), dt.ctypes.data_as(fp),
            freq.ctypes.data_as(fp), E, float(rng.normal()),
            float(rng.normal()), out.ctypes.data_as(fp),
            ref.ctypes.data_as(fp)) == 0
        np.testing.assert_array_equal(out[::3], ref)


# ---------------------------------------------------------------------------
# warp_schedule and a replica of the sweep
# ---------------------------------------------------------------------------


def masked_set(agg):
    D = agg.ctr_static.shape[1] - 3
    row, col, coll = kagg._masked_pairs(D, None, agg.ctr_ent, agg.ent_geo,
                                        agg.ctr_static)
    return set(zip(row.tolist(), col.tolist())), int(coll.sum())


# The first aggregation kernels, one lane a tile-sorted row over a
# block-wide staged range, as a model: the count that the warp sweep is
# measured against.  Entries or centres per staged chunk of those kernels by sweep.
LANE_CHUNK = {"forward": 128, "backward_entries": 64, "backward_centres": 128}


def lane_per_row_steps(ranges, row, col, chunk):
    """(sweep steps, body steps) of a lane_per_row kernel: a block of BLOCK
    rows stages the union of its rows' ranges in chunks of ``chunk``; in
    each chunk a lane steps through the part inside its own range, so a
    warp takes as many steps as its busiest lane, and its k-th step runs
    the pair body when the k-th pair of any lane is under the mask."""
    BLOCK = kagg.BLOCK
    n = ranges.shape[1]
    lo, hi = ranges[0].long(), ranges[1].long()
    live = hi > lo
    if not bool(live.any()):
        return 0, 0
    block = torch.arange(n, device=lo.device) // BLOCK
    big = 1 << 62
    blo = torch.full((-(-n // BLOCK),), big, dtype=torch.long,
                     device=lo.device)
    blo = blo.scatter_reduce(0, block[live], lo[live], "amin")
    # Each live row's chunks: its range cut at the block's chunk grid.
    r = torch.nonzero(live).squeeze(1)
    b0 = blo[block[r]]
    c_first = (lo[r] - b0) // chunk
    c_last = (hi[r] - 1 - b0) // chunk
    reps = c_last - c_first + 1
    rr = torch.repeat_interleave(r, reps)
    cidx = (torch.repeat_interleave(c_first, reps)
            + torch.arange(int(reps.sum()), device=lo.device)
            - torch.repeat_interleave(torch.cumsum(reps, 0) - reps, reps))
    e0 = blo[block[rr]] + cidx * chunk
    count = (torch.minimum(hi[rr], e0 + chunk)
             - torch.maximum(lo[rr], e0))
    n_chunks = int(c_last.max()) + 2
    key = (rr // WARP) * n_chunks + cidx
    uk, inv = torch.unique(key, return_inverse=True)
    steps = torch.zeros(uk.shape, dtype=torch.long, device=lo.device)
    steps = steps.scatter_reduce(0, inv, count, "amax")
    # Body steps: the distinct (warp, chunk, step) of the masked pairs.
    bp = blo[block[row]]
    pc = (col - bp) // chunk
    k = col - torch.maximum(lo[row], bp + pc * chunk)
    body = torch.unique(((row // WARP) * n_chunks + pc) * chunk + k)
    return int(steps.sum()), int(body.numel())


def lane_per_row_brute(ranges, masked, chunk):
    """The lane_per_row kernels step by step: each block of 128 rows
    stages the union of its rows' ranges in chunks; in a chunk every lane
    walks its own part and its warp takes as many steps as its busiest
    lane."""
    lo, hi = ranges[0].tolist(), ranges[1].tolist()
    sweep = body = 0
    for b0 in range(0, len(lo), kagg.BLOCK):
        rows = [r for r in range(b0, min(b0 + kagg.BLOCK, len(lo)))
                if hi[r] > lo[r]]
        if not rows:
            continue
        blo, bhi = min(lo[r] for r in rows), max(hi[r] for r in rows)
        for e0 in range(blo, bhi, chunk):
            for w0 in range(b0, b0 + kagg.BLOCK, WARP):
                lanes = [r for r in rows if w0 <= r < w0 + WARP]
                parts = [(r, max(lo[r], e0), min(hi[r], e0 + chunk))
                         for r in lanes]
                n = max([max(b - a, 0) for _, a, b in parts], default=0)
                sweep += n
                body += sum(any(a + k < b and (r, a + k) in masked
                                for r, a, b in parts) for k in range(n))
    return sweep, body


def warp_sweep_replica(ranges, masked, rows, width, contrib):
    """The sweep of agg_sweep.cuh in numpy: a warp over ``rows``
    consecutive rows, 32 candidates of the concatenated ranges a step, the
    masked (row, column) pairs queued in order and drained 32 at a time or
    at the rows' end, each drain's partials added channel by channel in
    queue order into the current row's sums.  Returns (out (n, width) as
    the kernels store it, sweep steps, drains)."""
    lo, hi = ranges[0].tolist(), ranges[1].tolist()
    n = len(lo)
    out = np.full((n, width), np.nan, np.float32)
    steps = drains = 0
    for r0 in range(0, n, rows):
        group = list(range(r0, min(r0 + rows, n)))
        cand = [(r, c) for r in group for c in range(lo[r], max(hi[r], lo[r]))]
        queue, run, cur = [], np.zeros(width, np.float32), 0

        def drain(k):
            nonlocal queue, run, cur, drains
            drains += 1
            part = np.stack([contrib(r, c) for r, c in queue[:k]])
            for q, (r, _) in enumerate(queue[:k]):
                while cur < r - r0:
                    out[r0 + cur], run, cur = run, np.zeros_like(run), cur + 1
                run = run + part[q]
            queue = queue[k:]

        for s0 in range(0, len(cand), WARP):
            steps += 1
            queue += [rc for rc in cand[s0:s0 + WARP] if rc in masked]
            if len(queue) >= WARP:
                drain(WARP)
        if queue:
            drain(len(queue))
        while cur < len(group):
            out[r0 + cur], run, cur = run, np.zeros_like(run), cur + 1
    return out, steps, drains


SCHEDULE_CASES = {
    "straddling": (2, 150, (0.05, 0.25), 0, None),
    "sparse_tiles": (2, 60, (0.01, 0.015), 0, None),
    "culled": (1, 120, (0.15, 0.35), 3, None),
    "sentinels": (3, 150, (0.1, 0.3), 0, (0.3, 0.7)),
}


@pytest.mark.parametrize("name", list(SCHEDULE_CASES))
def test_warp_schedule_counts(name):
    """warp_schedule's counts of the warp sweep, and the lane_per_row
    model's, against brute force on structures with tiles that straddle
    warps, single-centre tiles, culled radii, pad rows and sentinels:
    candidate and colliding pairs as pair_counts, every masked pair in one
    body step, the steps and lane use of each sweep."""
    D, P, sigma, cull, tile_range = SCHEDULE_CASES[name]
    agg = structure(7, D, P, 1, 1, 1, sigma_range=sigma, cull=cull,
                    tile_range=tile_range)[0]
    cand, coll = kagg.pair_counts(D, None, agg.ctr_ent, agg.ent_geo,
                                  agg.ctr_static)
    masked, n_coll = masked_set(agg)
    assert n_coll == coll and coll > 0
    flipped = {(c, r) for r, c in masked}
    row_c, col_e, _ = kagg._masked_pairs(D, None, agg.ctr_ent, agg.ent_geo,
                                         agg.ctr_static)
    for sweep, (ranges, pairs, row, col) in {
            "forward": (agg.ctr_ent, masked, row_c, col_e),
            "backward_entries": (agg.ent_ctr, flipped, col_e, row_c),
            "backward_centres": (agg.ctr_ent, masked, row_c, col_e)}.items():
        lane = lane_per_row_steps(ranges, row, col, LANE_CHUNK[sweep])
        assert lane == lane_per_row_brute(ranges, pairs,
                                          LANE_CHUNK[sweep]), sweep
        assert -(-len(masked) // WARP) <= lane[1] <= len(masked)
        for rows in (1, 4, 32):
            warp = kagg.warp_schedule(D, None, agg.ctr_ent, agg.ent_ctr,
                                      agg.ent_geo, agg.ctr_static,
                                      rows)[sweep]
            _, steps, drains = warp_sweep_replica(
                ranges, pairs, rows, 1, lambda r, c: np.ones(1, np.float32))
            assert (warp["sweep_steps"], warp["body_steps"]) == (steps,
                                                                 drains)
            assert warp["lane_use"] == coll / (WARP * drains)
            assert warp["candidate_pairs"] == cand
            assert warp["colliding_pairs"] == coll
            assert warp["body_pairs"] == len(masked)
            assert -(-len(masked) // WARP) <= warp["body_steps"] <= len(
                masked)


def pair_tables(D, L, K, nfreq, agg, ent_fk, ctr_geo, dtf, gpre, gsum,
                ladder):
    """Every (centre, entry) pair's partials in plain torch, as the three
    sweeps' bodies produce them: (forward (Cp, Ep, L + 1) with the density
    last, entry-major (Cp, Ep, L + K), centre-major (Cp, Ep, K + 2E +
    nfreq) in dctr's columns)."""
    Cp, Ep = ctr_geo.shape[0], agg.ent_geo.shape[1]
    E = 2 * D * nfreq + 1
    Xs, G, _ = kagg._pair(D, None, agg.ctr_ent, agg.ent_geo, ctr_geo,
                          (0, Cp, 0, Ep))
    q = ctr_geo[:, D + 3:]
    w = q @ ent_fk[L:]
    Xn = [x * ctr_geo[:, D + 1:D + 2] for x in Xs]
    emb, fac, terms = kagg._sincode(D, nfreq, E, Xn, dtf, ladder)
    coeff = G * w * ctr_geo[:, D + 2:D + 3]
    fwd = torch.cat([(coeff * fac)[..., None] * ent_fk[:L].T[None]
                     + (coeff * emb)[..., None], G[..., None]], dim=2)
    gdotf = gpre @ ent_fk[:L]
    dw = G * (fac * gdotf + emb * gsum)
    ent = torch.cat([gpre[:, None, :] * (G * w * fac)[..., None],
                     q[:, None, :] * dw[..., None]], dim=2)
    cw = G * w
    cemb, cfac = cw * gsum, cw * gdotf
    ctr = torch.zeros((Cp, Ep, K + 2 * E + nfreq))
    ctr[..., :K] = ent_fk[L:].T[None] * dw[..., None]
    dt = dtf[0]
    for (d, e), (s, cs, i0) in terms.items():
        ctr[..., K + i0] = cemb * s
        ctr[..., K + i0 + 1] = cemb * cs
        ctr[..., K + E + i0] = cfac * s
        ctr[..., K + E + i0 + 1] = cfac * cs
        ctr[..., K + 2 * E + e] += (
            (cemb * (cs * dt[i0] - s * dt[i0 + 1])
             + cfac * (cs * dt[E + i0] - s * dt[E + i0 + 1]))
            * (math.pi * Xn[d]))
    ctr[..., K + E - 1] = cemb
    ctr[..., K + 2 * E - 1] = cfac
    return fwd, ent, ctr


@pytest.mark.parametrize("rows", [1, 5, 32])
@pytest.mark.parametrize("name", ["d2_point", "d1_dense", "d2_tile_range"])
def test_sweep_replica_matches_plain(cases, name, rows):
    """The numpy replica of the sweep, on each pair's partials, against
    forward_plain and backward_plain within fp32 rounding: every masked pair
    reaches its row once, rows without one come back zero."""
    D, L, K, nfreq, ladder, _, agg, ent_fk, ctr_geo, dtf = cases[name]
    g = torch.Generator().manual_seed(4)
    gpre = torch.randn((ctr_geo.shape[0], L), generator=g)
    gsum = gpre.sum(dim=1, keepdim=True)
    fwd, ent, ctr = (t.numpy() for t in pair_tables(
        D, L, K, nfreq, agg, ent_fk, ctr_geo, dtf, gpre, gsum, ladder))
    masked, _ = masked_set(agg)
    flipped = {(c, r) for r, c in masked}
    out, _, _ = warp_sweep_replica(agg.ctr_ent, masked, rows, L + 1,
                                   lambda i, j: fwd[i, j])
    ref, ref_tot = kagg.forward_plain(
        D, L, K, nfreq, None, agg.ctr_ent, agg.ent_geo, ent_fk, ctr_geo, dtf,
        ladder=ladder, with_totals=True)
    scale = lambda r: 1e-6 * max(1.0, float(r.abs().max()))  # noqa: E731
    np.testing.assert_allclose(out[:, :L], ref.numpy(), rtol=1e-4,
                               atol=scale(ref))
    np.testing.assert_allclose(out[:, L:], ref_tot.numpy(), rtol=1e-4,
                               atol=scale(ref_tot))
    ref_e, ref_c = kagg.backward_plain(
        D, L, K, nfreq, None, (agg.ctr_ent, agg.ent_ctr), agg.ent_geo,
        ent_fk, ctr_geo, dtf, gpre, gsum, ladder=ladder)
    out_e, _, _ = warp_sweep_replica(agg.ent_ctr, flipped, rows, L + K,
                                     lambda j, i: ent[i, j])
    np.testing.assert_allclose(out_e.T, ref_e.numpy(), rtol=1e-4,
                               atol=scale(ref_e))
    out_c, _, _ = warp_sweep_replica(agg.ctr_ent, masked, rows,
                                     ctr.shape[2], lambda i, j: ctr[i, j])
    np.testing.assert_allclose(out_c, ref_c.numpy(), rtol=1e-4,
                               atol=scale(ref_c))
