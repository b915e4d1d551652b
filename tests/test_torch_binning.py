"""dgs_tpu_torch.binning.grid and utils.native against their dgs_tpu
counterparts: every integer output bitwise equal (values and dtype)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgs_tpu.binning import grid as jgrid
from dgs_tpu.config import SamplerConfig as JConfig
from dgs_tpu.utils import native as jnative
from dgs_tpu_torch.binning import grid as tgrid
from dgs_tpu_torch.config import SamplerConfig as TConfig
from dgs_tpu_torch.utils import native as tnative

from conftest import make_gaussians, make_samples

torch.set_num_threads(2)

CASES = {
    "periodic": {},
    "axis_radii": {"axis_radii": True},
    "ellip_cull": {"ellip_cull": True},
    "axis_ellip": {"axis_radii": True, "ellip_cull": True},
    "open": {"period": None, "lower": (-1.0,) * 3,
             "upper_bounds": (1.0,) * 3},
    "open_axis_ellip": {"period": None, "lower": (-1.0,) * 3,
                        "upper_bounds": (1.0,) * 3, "axis_radii": True,
                        "ellip_cull": True},
}


def _configs(D, **kw):
    return (JConfig(**kw).with_dims(D), TConfig(**kw).with_dims(D))


def _assert_state_equal(js, ts):
    for f in js._fields:
        a, b = np.asarray(getattr(js, f)), getattr(ts, f).numpy()
        assert a.shape == b.shape, f
        if a.dtype.kind in "iu":
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(b, a, err_msg=f)
        else:
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=0, err_msg=f)


@pytest.mark.parametrize("D", [1, 2, 3])
@pytest.mark.parametrize("case", sorted(CASES))
def test_build_and_forward_geometry_bitwise(rng, D, case):
    jc, tc = _configs(D, max_tiles_per_gaussian=8, tile_size=0.2,
                      **CASES[case])
    m, v, cov, c = make_gaussians(rng, 61, D, 2)
    s = make_samples(rng, 250, D)
    js = jgrid.build(jc, *map(jnp.asarray, (m, cov, s)))
    ts = tgrid.build(tc, *map(torch.from_numpy, (m, cov, s)))
    _assert_state_equal(js, ts)
    assert int(ts.overflow) == 0
    for bn, be in ((128, 128), (64, 32), (128, 1)):
        for a, b in zip(jgrid.forward_geometry(js, bn, be),
                        tgrid.forward_geometry(ts, bn, be)):
            assert b.dtype == torch.int32
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    P = m.shape[0]
    np.testing.assert_array_equal(
        tgrid.pair_mask_dense(tc, ts, torch.from_numpy(s), P).numpy(),
        np.asarray(jgrid.pair_mask_dense(jc, js, jnp.asarray(s), P)))


@pytest.mark.parametrize("D", [1, 2, 3])
@pytest.mark.parametrize("case", ["periodic", "open_axis_ellip"])
def test_backward_geometry_bitwise(rng, D, case):
    """The per-entry-block sample ranges (at the TPU kernel's block sizes
    and at the CUDA backward's one-sample granularity) equal JAX's."""
    jc, tc = _configs(D, max_tiles_per_gaussian=8, tile_size=0.2,
                      **CASES[case])
    m, v, cov, c = make_gaussians(rng, 47, D, 1)
    s = make_samples(rng, 230, D)
    js = jgrid.build(jc, *map(jnp.asarray, (m, cov, s)))
    ts = tgrid.build(tc, *map(torch.from_numpy, (m, cov, s)))
    for be, bn in ((128, 64), (32, 1)):
        for a, b in zip(jgrid.backward_geometry(js, be, bn),
                        tgrid.backward_geometry(ts, be, bn)):
            assert b.dtype == torch.int32
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.mark.parametrize("D", [2, 3])
def test_overflow_counters_match(rng, D):
    """Footprints beyond R and entries beyond the capacity are counted."""
    jc, tc = _configs(D, max_tiles_per_gaussian=3,
                      entry_capacity_factor=0.5)
    m, v, cov, c = make_gaussians(rng, 300, D, 1, sigma_range=(0.3, 0.6))
    s = make_samples(rng, 40, D)
    js = jgrid.build(jc, *map(jnp.asarray, (m, cov, s)))
    ts = tgrid.build(tc, *map(torch.from_numpy, (m, cov, s)))
    _assert_state_equal(js, ts)
    assert int(ts.overflow) > 0
    if D == 3:
        assert int(ts.entry_overflow) > 0


def test_stable_pair_sort_branch_matches(rng):
    """gid_bits + tile_bits > 31 takes the stable (tile, gid) pair sort
    instead of the packed key; both packages agree."""
    D = 3
    jc, tc = _configs(D, tile_size=2.0 / 256, max_tiles_per_gaussian=3)
    P = 64
    assert P.bit_length() + tgrid.num_tiles(tc, D).bit_length() > 31
    means = rng.uniform(-1.0, 1.0, (P, D)).astype(np.float32)
    rad = rng.uniform(0.0, 0.006, (P,)).astype(np.float32)
    ja = jgrid.duplicate_entries(jc, jnp.asarray(means), jnp.asarray(rad),
                                 3, 3 ** D * P)
    ta = tgrid.duplicate_entries(tc, torch.from_numpy(means),
                                 torch.from_numpy(rad), 3, 3 ** D * P)
    for a, b in zip(ja, ta):
        assert b.dtype == torch.int32
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_binning_reuse_matches(rng):
    D = 2
    jc, tc = _configs(D, max_tiles_per_gaussian=8, tile_size=0.2)
    m, v, cov, c = make_gaussians(rng, 40, D, 2)
    s1, s2 = make_samples(rng, 100, D), make_samples(rng, 130, D)
    jsb = jgrid.bin_samples(jc, jnp.asarray(s1))
    tsb = tgrid.bin_samples(tc, torch.from_numpy(s1))
    js = jgrid.build(jc, jnp.asarray(m), jnp.asarray(cov), jnp.asarray(s1),
                     sample_binning=jsb)
    ts = tgrid.build(tc, torch.from_numpy(m), torch.from_numpy(cov),
                     torch.from_numpy(s1), sample_binning=tsb)
    _assert_state_equal(js, ts)
    js2 = jgrid.build(jc, jnp.asarray(m), jnp.asarray(cov), jnp.asarray(s2),
                      gaussian_binning=js)
    ts2 = tgrid.build(tc, torch.from_numpy(m), torch.from_numpy(cov),
                      torch.from_numpy(s2), gaussian_binning=ts)
    _assert_state_equal(js2, ts2)


@pytest.mark.parametrize("D", [1, 2, 3])
def test_shift_centres_and_capacity_match(rng, D):
    jc, tc = _configs(D, tile_size=0.3, max_tiles_per_gaussian=6)
    m, v, cov, c = make_gaussians(rng, 30, D, 1)
    jm, tm = jnp.asarray(m), torch.from_numpy(m)
    js = jgrid.build(jc, jm, jnp.asarray(cov), jnp.asarray(m))
    ts = tgrid.build(tc, tm, torch.from_numpy(cov), tm)
    jlo, _ = jgrid.gaussian_rects(jc, jm, js.radii)
    tlo, _ = tgrid.gaussian_rects(tc, tm, ts.radii)
    np.testing.assert_array_equal(tlo.numpy(), np.asarray(jlo))
    E = ts.num_entries
    gid = np.minimum(np.asarray(js.ent_gid), 29)
    jk = jgrid.image_shift(jc, js.ent_tile, jlo[gid].astype(jnp.float32))
    tk = tgrid.image_shift(tc, ts.ent_tile, tlo[torch.from_numpy(gid).long()]
                           .float())
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    tiles = np.arange(-3, tgrid.num_tiles(tc, D) + 3, dtype=np.int32)
    np.testing.assert_array_equal(
        tgrid.tile_centers(tc, torch.from_numpy(tiles), D).numpy(),
        np.asarray(jgrid.tile_centers(jc, jnp.asarray(tiles), D)))
    for factor in (0.5, 3.0, 40.0):
        for P in (10, 3000):
            jcf = dataclasses.replace(jc, entry_capacity_factor=factor)
            tcf = dataclasses.replace(tc, entry_capacity_factor=factor)
            assert (tgrid.entry_capacity(tcf, P, 6)
                    == jgrid.entry_capacity(jcf, P, 6))
    assert E == js.num_entries


@pytest.mark.parametrize("kw", [
    {},
    {"axis_radii": True, "eig_floor": 1e-12, "tile_size": 0.1275},
    {"ellip_cull": True, "tile_size": 0.25},
    {"period": None, "upper_bounds": (1.0, 1.0), "tile_size": 0.3},
])
def test_plan_capacities_and_config_match(rng, kw):
    m, v, cov, c = make_gaussians(rng, 200, 2, 2, sigma_range=(0.02, 0.3))
    s = make_samples(rng, 500, 2)
    jc, tc = JConfig(max_tiles_per_gaussian=8, **kw), \
        TConfig(max_tiles_per_gaussian=8, **kw)
    jp = jnative.plan_capacities(jc, m, cov, s)
    tp = tnative.plan_capacities(tc, torch.from_numpy(m),
                                 torch.from_numpy(cov), s)
    assert tp == jp
    jcf = jnative.config_from_plan(jc, jp, 200)
    tcf = tnative.config_from_plan(tc, tp, 200)
    for f in ("max_tiles_per_gaussian", "entry_capacity_factor",
              "unwrapped_kernels"):
        assert getattr(tcf, f) == getattr(jcf, f), f
    # the planned capacities make the port's binning exact
    ts = tgrid.build(tcf, torch.from_numpy(m), torch.from_numpy(cov),
                     torch.from_numpy(s))
    assert int(ts.overflow) == 0 and int(ts.entry_overflow) == 0
    T = tgrid.num_tiles(tcf, 2)
    assert int((ts.ent_tile < T).sum()) == tp["entries"]


@pytest.mark.parametrize("kw", [
    {"period": None, "lower": (-1.0, -1.0), "upper_bounds": (1.0, 1.0)},
    {"period": 2.0},
    {"axis_radii": True, "ellip_cull": True},
], ids=["open", "torus", "axis_ellip"])
def test_planner_cpp_matches_numpy_both_domains(rng, kw):
    """Twin of tests/test_native.py's: the port's fallback planner (its own
    binning on the CPU) gives the C++ planner's plan, every key, on the
    open domain and on the torus."""
    m, _, cov, _ = make_gaussians(rng, 500, 2, 2, sigma_range=(0.03, 0.08))
    s = make_samples(rng, 2000, 2)
    cfg = TConfig(tile_size=0.2, eig_floor=1e-12, max_tiles_per_gaussian=8,
                  **kw).with_dims(2)
    plan_c = tnative.plan_capacities(cfg, m, cov, s)
    plan_np = tnative._plan_capacities_numpy(
        cfg, m, cov, s, cfg.block_n, cfg.block_p, *cfg.bwd_blocks)
    assert {k: plan_c[k] for k in tnative.PLAN_KEYS} == plan_np


def test_planner_falls_back_where_gpp_is_missing(rng, monkeypatch, capsys,
                                                 tmp_path):
    """With g++ missing the planner library is not built: _load says so on
    one stderr line and returns None, plan_capacities returns the C++
    planner's plan through the numpy fallback and max_collisions its count
    through ops.aggregation.suggest_capacity."""
    from dgs_tpu_torch.oracle.dense import radii

    m, _, cov, _ = make_gaussians(rng, 300, 2, 2, sigma_range=(0.05, 0.3))
    s = make_samples(rng, 1000, 2)
    rad = radii(torch.from_numpy(cov), 2).numpy()
    cfg = TConfig(max_tiles_per_gaussian=8).with_dims(2)
    plan_c = tnative.plan_capacities(cfg, m, cov, s)
    coll_c = tnative.max_collisions(cfg, m, rad)

    def no_gpp(cmd, *args, **kwargs):
        raise FileNotFoundError(2, "No such file or directory", cmd[0])

    monkeypatch.setattr(tnative.subprocess, "run", no_gpp)
    monkeypatch.setattr(tnative, "_OUT", str(tmp_path / "host_binning.so"))
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_lib_failed", False)
    assert tnative._load() is None
    err = capsys.readouterr().err
    assert "build failed" in err and "g++" in err and err.count("\n") == 1
    assert tnative.plan_capacities(cfg, m, cov, s) == plan_c
    assert tnative.max_collisions(cfg, m, rad) == coll_c
    assert capsys.readouterr().err == ""     # said once
