"""dgs_tpu_torch's tiled sampling op (plain path, CPU tensors) against
dgs_tpu.ops.sampling's tiled path (Pallas kernels in interpret mode): the
kernel operands, every order at D in {1,2,3}, wrapped and unwrapped, the
three output modes and the diagnostics."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgs_tpu.binning import grid as jgrid
from dgs_tpu.config import SamplerConfig as JConfig
from dgs_tpu.kernels import tiled as jtiled
from dgs_tpu.ops import sampling as jsampling
from dgs_tpu_torch.binning import grid as tgrid
from dgs_tpu_torch.config import SamplerConfig as TConfig
from dgs_tpu_torch.kernels import tiled as ttiled
from dgs_tpu_torch.ops import sampling as tsampling

from conftest import make_gaussians, make_samples

torch.set_num_threads(2)

ORDERS = ("value", "derivative", "laplacian", "third")


def assert_close(got, ref, err_msg=""):
    ref = np.asarray(ref)
    np.testing.assert_allclose(
        np.asarray(got), ref, rtol=2e-4,
        atol=1e-5 * max(1.0, float(np.abs(ref).max(initial=0.0))),
        err_msg=err_msg)


def _setup(rng, P, N, D, C=3, cfg_kw=None, **kw):
    cfg_kw = dict(max_tiles_per_gaussian=8, **(cfg_kw or {}))
    m, v, cov, c = make_gaussians(rng, P, D, C, **kw)
    s = make_samples(rng, N, D)
    jc = JConfig(**cfg_kw).with_dims(D)
    tc = TConfig(**cfg_kw).with_dims(D)
    J = tuple(map(jnp.asarray, (m, v, cov, c, s)))
    T = tuple(map(torch.from_numpy, (m, v, cov, c, s)))
    return jc, tc, J, T


def _jax_tiled(orders, cfg, m, v, c, s, state, **kw):
    fg = jgrid.forward_geometry(state, 128, 128)
    bg = jgrid.backward_geometry(state, 128, 64)
    fw = int(jax.device_get(jnp.maximum(fg[1], 1).sum()))
    bw = int(jax.device_get(jnp.maximum(bg[1], 1).sum()))
    return jsampling.sample_tiled_multi(
        orders, cfg, m, v, c, s, state, fg, bg, fw, bw,
        block_n=128, block_e=128, bwd_block_n=64, bwd_block_e=128, **kw)


@pytest.mark.parametrize("D", [1, 2, 3])
@pytest.mark.parametrize("unwrapped", [False, True])
def test_sample_tiled_multi_matches(rng, D, unwrapped):
    jc, tc, (jm, jv, jcov, jcon, js), (tm, tv, tcov, tcon, ts) = _setup(
        rng, 43, 230, D)
    jstate = jgrid.build(jc, jm, jcov, js)
    tstate = tgrid.build(tc, tm, tcov, ts)
    ref = _jax_tiled(ORDERS, jc, jm, jv, jcon, js, jstate,
                     unwrapped=unwrapped)
    got = tsampling.sample_tiled_multi(ORDERS, tc, tm, tv, tcon, ts, tstate,
                                       unwrapped=unwrapped)
    for order, g, r in zip(ORDERS, got, ref):
        assert g.shape == r.shape, order
        assert_close(g, r, order)


@pytest.mark.parametrize("D", [2, 3])
def test_output_modes_match(rng, D):
    jc, tc, (jm, jv, jcov, jcon, js), (tm, tv, tcov, tcon, ts) = _setup(
        rng, 50, 200, D, cfg_kw={"tile_size": 0.25})
    jstate = jgrid.build(jc, jm, jcov, js)
    tstate = tgrid.build(tc, tm, tcov, ts)
    N = 200
    orders = ("laplacian", "value", "third")   # not the canonical order
    for mode in ({"sorted_outputs": True},
                 {"unique_outputs": True},
                 {"sorted_outputs": True, "unique_outputs": True},
                 {"sorted_outputs": True, "padded_outputs": True}):
        ref = _jax_tiled(orders, jc, jm, jv, jcon, js, jstate, **mode)
        got = tsampling.sample_tiled_multi(orders, tc, tm, tv, tcon, ts,
                                           tstate, **mode)
        for order, g, r in zip(orders, got, ref):
            if mode.get("padded_outputs"):
                # (n_unique, C, Np): the port pads to its own block; the
                # pad columns must be zero.
                assert g.shape[:2] == r.shape[:2], order
                assert_close(g[:, :, :N], np.asarray(r)[:, :, :N], order)
                assert not bool(g[:, :, N:].any()), order
            else:
                assert g.shape == r.shape, (order, mode)
                assert_close(g, r, f"{order} {mode}")
    with pytest.raises(ValueError, match="padded_outputs requires"):
        tsampling.sample_tiled_multi(orders, tc, tm, tv, tcon, ts, tstate,
                                     padded_outputs=True)


def test_kernel_operands_match(rng):
    D = 2
    jc, tc, (jm, jv, jcov, jcon, js), (tm, tv, tcov, tcon, ts) = _setup(
        rng, 40, 150, D)
    jstate = jgrid.build(jc, jm, jcov, js)
    tstate = tgrid.build(tc, tm, tcov, ts)
    jgid, jtile, jgeom, jEp, _ = jtiled.prepare_entries(
        jstate, jm, jv, jcon, 128, cfg=jc)
    tgid, ttile, tgeom, tEp = ttiled.prepare_entries(
        tstate, tm, tv, tcon, 128, cfg=tc)
    assert tEp == jEp
    np.testing.assert_array_equal(tgid.numpy(), np.asarray(jgid))
    np.testing.assert_array_equal(ttile.numpy(), np.asarray(jtile))
    assert_close(tgeom, jgeom, "geom")
    jsmp, jst, jNp, _ = jtiled.prepare_samples(jstate, js, 128, cfg=jc)
    tsmp, tst, tNp = ttiled.prepare_samples(tstate, ts, 128)
    assert tNp == jNp
    np.testing.assert_array_equal(tst.numpy(), np.asarray(jst))
    np.testing.assert_array_equal(tsmp.numpy(), np.asarray(jsmp))


@pytest.mark.parametrize("D", [1, 2, 3])
def test_plain_kernel_chunking_is_exact(rng, D):
    """The plain version's chunking over sample blocks (and its ranges)
    does not change the result: one block per chunk equals the whole."""
    jc, tc, _, (tm, tv, tcov, tcon, ts) = _setup(rng, 60, 700, D,
                                                  cfg_kw={"tile_size": 0.2})
    state = tgrid.build(tc, tm, tcov, ts)
    _, _, geom, _ = ttiled.prepare_entries(state, tm, tv, tcon, 128, cfg=tc)
    smp, _, Np = ttiled.prepare_samples(state, ts, ttiled.BLOCK_N)
    lo, n = ttiled.entry_ranges(state, Np)
    assert lo.shape == (Np // ttiled.BLOCK_N,) and lo.dtype == torch.int32
    whole = ttiled.tiled_forward_plain(ORDERS, 2.0, D, 3, geom, smp, lo, n,
                                       chunk_blocks=10 ** 6)
    per_block = ttiled.tiled_forward_plain(ORDERS, 2.0, D, 3, geom, smp, lo,
                                           n, chunk_blocks=1)
    assert_close(per_block, whole)
    assert not bool(whole[:, 700:].any())      # pad columns are zero


def test_wide_gaussians_match(rng):
    """Footprints that cover the whole grid (full-cover rects)."""
    jc, tc, (jm, jv, jcov, jcon, js), (tm, tv, tcov, tcon, ts) = _setup(
        rng, 9, 210, 2, sigma_range=(0.9, 1.2))
    jstate = jgrid.build(jc, jm, jcov, js)
    tstate = tgrid.build(tc, tm, tcov, ts)
    ref = _jax_tiled(("value", "derivative"), jc, jm, jv, jcon, js, jstate)
    got = tsampling.sample_tiled_multi(("value", "derivative"), tc, tm, tv,
                                       tcon, ts, tstate)
    for g, r in zip(got, ref):
        assert_close(g, r)


@pytest.mark.parametrize("period", [2.0, None])
def test_sample_binned_matches(rng, period):
    kw = {} if period else {"period": None, "upper_bounds": (1.0, 1.0)}
    jc, tc, (jm, jv, jcov, jcon, js), (tm, tv, tcov, tcon, ts) = _setup(
        rng, 40, 300, 2, cfg_kw=kw)
    orders = ("value", "derivative", "laplacian")
    jouts, jdiag = jsampling.sample_binned(jc, jm, jv, jcon, jcov, js, orders,
                                           sorted_outputs=True)
    touts, tdiag = tsampling.sample_binned(tc, tm, tv, tcon, tcov, ts, orders,
                                           sorted_outputs=True)
    assert set(tdiag) == set(jdiag)
    np.testing.assert_array_equal(tdiag["perm"].numpy(),
                                  np.asarray(jdiag["perm"]))
    for k in ("bin_overflow", "entry_overflow", "work_overflow_fwd",
              "work_overflow_bwd"):
        assert int(tdiag[k]) == int(jdiag[k]) == 0, k
    for order in orders:
        assert_close(touts[order], jouts[order], order)


def test_gradient_request_raises(rng):
    _, tc, _, (tm, tv, tcov, tcon, ts) = _setup(rng, 20, 50, 2)
    tv = tv.clone().requires_grad_()
    outs, _ = tsampling.sample_binned(tc, tm, tv, tcon, tcov, ts, ("value",))
    assert outs["value"].requires_grad
    with pytest.raises(NotImplementedError, match="tiled backward kernel"):
        outs["value"].sum().backward()


def test_ablation_hook_and_bad_orders_raise(rng, monkeypatch):
    _, tc, _, (tm, tv, tcov, tcon, ts) = _setup(rng, 20, 50, 2)
    with pytest.raises(ValueError, match="repeated order"):
        tsampling.sample_binned(tc, tm, tv, tcon, tcov, ts,
                                ("value", "value"))
    monkeypatch.setenv("DGS_ABLATE", "fdots")
    with pytest.raises(NotImplementedError, match="DGS_ABLATE"):
        tsampling.sample_binned(tc, tm, tv, tcon, tcov, ts, ("value",))
