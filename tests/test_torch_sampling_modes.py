"""The kernel modes of the tiled path (the separable forward, the
moment-form backward, ``fast_math_dots`` that turns both on) in
dgs_tpu_torch (plain versions, CPU tensors) against dgs_tpu's (Pallas
kernels in interpret mode) on the same seeded numpy inputs: the op's values
and gradients in each mode, the D = 3 chunked path under fast-math, the
operand functions, the mode resolution, which kernel each mode runs, and the
span knob, which is accepted and changes nothing."""

import contextlib
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgs_tpu.binning import grid as jgrid
from dgs_tpu.config import SamplerConfig as JConfig
from dgs_tpu.kernels import tiled as jtiled
from dgs_tpu.ops import sampling as jsampling
from dgs_tpu.ops import sampling_chunked as jchunked
from dgs_tpu.oracle.dense import radii_axis as jradii_axis
from dgs_tpu_torch.binning import grid as tgrid
from dgs_tpu_torch.config import SamplerConfig as TConfig, tri_size
from dgs_tpu_torch.kernels import tiled as ttiled
from dgs_tpu_torch.ops import sampling as tsampling
from dgs_tpu_torch.ops import sampling_chunked as tchunked
from dgs_tpu_torch.oracle.dense import radii_axis as tradii_axis

from conftest import make_gaussians, make_samples

torch.set_num_threads(2)

ORDERS = ("value", "derivative", "laplacian", "third")
PARAMS = ("means", "values", "conics")
# The JAX suite's configuration of its mode tests
# (test_binning_tiled.py:307-335, :386-410).
MODE_CFG = dict(max_tiles_per_gaussian=4, tile_size=0.51, eig_floor=1e-12)
MODES = [(True, False), (False, True), (True, True)]


def assert_close(got, ref, err_msg=""):
    """The JAX suite's kernel tolerance: rtol 2e-4, atol 1e-5 max(1, |ref|)."""
    ref = np.asarray(ref)
    np.testing.assert_allclose(
        np.asarray(got), ref, rtol=2e-4,
        atol=1e-5 * max(1.0, float(np.abs(ref).max(initial=0.0))),
        err_msg=err_msg)


def assert_grad_close(got, ref, atol_rel, err_msg=""):
    """The JAX mode tests' gradient tolerance: rtol 2e-3, atol ``atol_rel``
    max(1, |ref|) (1e-4 separable, 2e-4 moments)."""
    ref = np.asarray(ref)
    np.testing.assert_allclose(
        np.asarray(got), ref, rtol=2e-3,
        atol=atol_rel * max(1.0, float(np.abs(ref).max(initial=0.0))),
        err_msg=err_msg)


def _mode_inputs(D, seed):
    rng = np.random.default_rng(seed)
    m, v, cov, c = make_gaussians(rng, 37, D, 3, sigma_range=(0.02, 0.05))
    s = make_samples(rng, 53, D)
    return m, v, cov, c, s


def _loss_of(outs, lib):
    """The JAX mode tests' loss: per-order normalised sums of squares."""
    return sum(lib.sum(o * o) / (1.0 + lib.sum(o * o)) * 100.0
               for o in outs)


def _jax_geometry(state):
    fg = jgrid.forward_geometry(state, 128, 128)
    bg = jgrid.backward_geometry(state, 128, 64)
    fw = int(jax.device_get(jnp.maximum(fg[1], 1).sum()))
    bw = int(jax.device_get(jnp.maximum(bg[1], 1).sum()))
    return fg, bg, fw, bw


def _jax_modes(D, arrays, separable, moments, orders=ORDERS):
    m, v, cov, c, s = map(jnp.asarray, arrays)
    cfg = JConfig(**MODE_CFG).with_dims(D)
    state = jgrid.build(cfg, m, cov, s)
    fg, bg, fw, bw = _jax_geometry(state)

    def outs(m_, v_, c_):
        return jsampling.sample_tiled_multi(
            orders, cfg, m_, v_, c_, s, state, fg, bg, fw, bw,
            block_n=128, block_e=128, bwd_block_n=64, bwd_block_e=128,
            unwrapped=True, separable=separable, moments=moments)

    grads = jax.jit(jax.grad(lambda *a: _loss_of(outs(*a), jnp),
                             argnums=(0, 1, 2)))(m, v, c)
    return [np.asarray(o) for o in outs(m, v, c)], grads


def _port_modes(D, arrays, separable, moments, orders=ORDERS):
    m, v, cov, c, s = map(torch.from_numpy, arrays)
    cfg = TConfig(**MODE_CFG).with_dims(D)
    state = tgrid.build(cfg, m, cov, s)
    params = [t.clone().requires_grad_() for t in (m, v, c)]
    outs = tsampling.sample_tiled_multi(
        orders, cfg, *params, s, state, unwrapped=True, separable=separable,
        moments=moments)
    grads = torch.autograd.grad(_loss_of(outs, torch), params)
    return [o.detach() for o in outs], grads


@pytest.mark.parametrize("mode", MODES, ids=["sep", "moments", "both"])
@pytest.mark.parametrize("D", [1, 2, 3])
def test_modes_match_dgs_tpu(D, mode):
    """sample_tiled_multi with (separable, moments) forced: the four orders'
    values and the three gradients against dgs_tpu's in the same mode."""
    separable, moments = mode
    arrays = _mode_inputs(D, 10 + D)
    ref_outs, ref_grads = _jax_modes(D, arrays, separable, moments)
    outs, grads = _port_modes(D, arrays, separable, moments)
    for order, o, r in zip(ORDERS, outs, ref_outs):
        assert o.shape == r.shape, order
        assert_close(o, r, order)
    atol_rel = 2e-4 if moments else 1e-4
    for name, g, r in zip(PARAMS, grads, ref_grads):
        assert_grad_close(g, r, atol_rel, name)


@pytest.mark.parametrize("orders", [("value",), ("derivative", "value"),
                                    ("laplacian",), ("third", "value")],
                         ids=["value", "deriv_value", "lap", "third_value"])
def test_moment_rows_of_partial_order_sets(orders):
    """Order sets without W (the value-only evaluation) or without the
    laplacian or third rows: the moment path against dgs_tpu's at D = 2."""
    arrays = _mode_inputs(2, 20 + len(orders))
    ref_outs, ref_grads = _jax_modes(2, arrays, False, True, orders)
    outs, grads = _port_modes(2, arrays, False, True, orders)
    for o, r in zip(outs, ref_outs):
        assert_close(o, r)
    for name, g, r in zip(PARAMS, grads, ref_grads):
        assert_grad_close(g, r, 2e-4, name)


# ------------------------------------------------------------- chunked

# bench.py's D = 3 flags under the fast-math knob.
FAST_CHUNKED = dict(tile_size=0.2, axis_radii=True, ellip_cull=True,
                    block_n=128, block_p=128, eig_floor=1e-12,
                    fast_math_dots=True)


def test_chunked_fast_math_matches_dgs_tpu():
    """The D = 3 chunked path with fast_math_dots=True (both modes on by the
    automatic default) against dgs_tpu's chunked path with the same flag:
    outputs rtol 1e-4 and gradients rtol 2e-3 (the chunked twin's
    tolerances; both packages compute in exact fp32 on the CPU)."""
    P, N, C, D = 200, 500, 3, 3
    orders = ORDERS
    rng = np.random.default_rng(4)
    arrays = make_gaussians(rng, P, D, C, sigma_range=(0.03, 0.1))
    arrays = (*arrays, rng.uniform(-1.0, 1.0, (N, D)).astype(np.float32))
    jm, jv, jcov, jcon, js = map(jnp.asarray, arrays)
    jcfg, jplan = jchunked.plan_chunked(JConfig(**FAST_CHUNKED), jm, jcov,
                                        js)
    assert jchunked._kernel_modes(jcfg)[:2] == (True, True)
    jcs = jchunked.chunk_samples(jcfg, js, jplan, jcfg.block_n)
    jrad = jradii_axis(jcov, D, jcfg.radius_sigma, jcfg.eig_floor)

    def jrun(m_, v_, c_):
        return jchunked.sample_chunked_multi(
            orders, jcfg, m_, v_, c_, jrad, jcs, jplan, block_n=128,
            block_e=128)

    ref, jdiag = jrun(jm, jv, jcon)
    weights = [1.0 / float(np.prod(o.shape)) for o in ref]
    ref_grads = jax.jit(jax.grad(lambda *a: sum(
        jnp.sum(o * o) * w for o, w in zip(jrun(*a)[0], weights)),
        argnums=(0, 1, 2)))(jm, jv, jcon)

    tm, tv, tcov, tcon, ts = map(torch.from_numpy, arrays)
    cfg, plan = tchunked.plan_chunked(TConfig(**FAST_CHUNKED), tm, tcov, ts)
    assert cfg.unwrapped_kernels and tchunked._kernel_modes(cfg) == (
        True, True, False)
    cs = tchunked.chunk_samples(cfg, ts, plan, cfg.block_n)
    assert cs.mono is not None
    assert cs.mono.shape[0] == ttiled.mono_rows(D) + 1
    rad = tradii_axis(tcov, D, cfg.radius_sigma, cfg.eig_floor)
    params = [t.clone().requires_grad_() for t in (tm, tv, tcon)]
    outs, diag = tchunked.sample_chunked_multi(
        orders, cfg, *params, rad, cs, plan, block_n=128, block_e=128)
    assert not any(int(x) for k, x in diag.items() if k != "perm")
    assert not any(int(x) for k, x in jdiag.items() if k != "perm")
    grads = torch.autograd.grad(sum((o * o).sum() * w for o, w in zip(
        outs, weights)), params)
    for order, o, r in zip(orders, outs, ref):
        np.testing.assert_allclose(
            o.detach().numpy(), np.asarray(r), rtol=1e-4,
            atol=1e-5 * max(1.0, float(np.abs(r).max())), err_msg=order)
    for name, g, r in zip(PARAMS, grads, ref_grads):
        r = np.asarray(r)
        np.testing.assert_allclose(
            g.numpy(), r, rtol=2e-3,
            atol=1e-4 * max(1.0, float(np.abs(r).max())), err_msg=name)


# ------------------------------------------------------------ operands


@pytest.mark.parametrize("D", [1, 2, 3])
def test_operand_functions_match(D):
    """separable_extend, sample_monomials (sentinel and pad columns too),
    prepare_entries / prepare_samples in the separable layout,
    moment_layout and moment_combine against dgs_tpu's on random
    operands."""
    rng = np.random.default_rng(30 + D)
    jc = JConfig(**MODE_CFG).with_dims(D)
    tc = TConfig(**MODE_CFG).with_dims(D)
    T = jgrid.num_tiles(jc, D)
    tri, C, E = tri_size(D), 3, 70
    ent = rng.normal(0.0, 1.0, (E, D + tri + C)).astype(np.float32)
    tile = rng.integers(0, T, (1, E)).astype(np.int32)
    tile[0, -5:] = 2 ** 30          # pad slots decode through the modulus
    ref = jtiled.separable_extend(jc, jnp.asarray(ent), jnp.asarray(tile), D)
    got = ttiled.separable_extend(tc, torch.from_numpy(ent),
                                  torch.from_numpy(tile), D)
    assert got.shape == (E, D + tri + C + ttiled.sep_rows(D))
    assert_close(got, ref)

    coords = rng.uniform(-1.0, 1.0, (D, 90)).astype(np.float32)
    s_tile = rng.integers(0, T, (1, 90)).astype(np.int32)
    s_tile[0, :4] = T               # sentinel tile
    s_tile[0, -3:] = 2 ** 30 + 1    # pads
    ref = jtiled.sample_monomials(jc, jnp.asarray(coords),
                                  jnp.asarray(s_tile), D)
    got = ttiled.sample_monomials(tc, torch.from_numpy(coords),
                                  torch.from_numpy(s_tile), D)
    assert got.shape == (ttiled.mono_rows(D), 90)
    assert ttiled.mono_rows(D) == jtiled.mono_rows(D)
    assert ttiled.sep_rows(D) == jtiled.sep_rows(D)
    assert_close(got, ref)
    assert not bool(got[1:, :4].any()) and not bool(got[1:, -3:].any())

    for orders in (ORDERS, ("value",), ("laplacian", "value"), ("third",)):
        assert (ttiled.moment_layout(orders, D)
                == jtiled.moment_layout(orders, D))
        n_rows = ttiled.moment_layout(orders, D)[3]
        dent = rng.normal(0.0, 1.0, (n_rows + C, E)).astype(np.float32)
        geom = rng.normal(0.0, 1.0, (1 + D + tri + C + ttiled.sep_rows(D),
                                     E)).astype(np.float32)
        ref = jtiled.moment_combine(orders, D, C, jnp.asarray(dent),
                                    jnp.asarray(geom))
        got = ttiled.moment_combine(orders, D, C, torch.from_numpy(dent),
                                    torch.from_numpy(geom))
        assert got.shape == (D + tri + C, E)
        assert_close(got, ref, str(orders))


@pytest.mark.parametrize("D", [2, 3])
def test_separable_operands_match(D):
    """The separable layouts of the whole operands: geom (tile-local means
    and the appended rows) and the monomial sample operand, tile row
    last."""
    arrays = _mode_inputs(D, 40 + D)
    jm, jv, jcov, jc_, js = map(jnp.asarray, arrays)
    tm, tv, tcov, tc_, ts = map(torch.from_numpy, arrays)
    jc = JConfig(**MODE_CFG).with_dims(D)
    tc = TConfig(**MODE_CFG).with_dims(D)
    jstate = jgrid.build(jc, jm, jcov, js)
    tstate = tgrid.build(tc, tm, tcov, ts)
    jgeom = jtiled.prepare_entries(jstate, jm, jv, jc_, 128, cfg=jc,
                                   separable=True)[2]
    tgeom = ttiled.prepare_entries(tstate, tm, tv, tc_, 128, cfg=tc,
                                   separable=True)[2]
    assert_close(tgeom, jgeom)
    jmono = jtiled.prepare_samples(jstate, js, 128, cfg=jc,
                                   separable=True)[3]
    tmono = ttiled.prepare_samples(tstate, ts, 128, cfg=tc,
                                   separable=True)[0]
    assert_close(tmono, jmono)
    local = ttiled.local_samples(tmono, D)
    assert local.shape == (D + 1, tmono.shape[1])
    assert torch.equal(local[-1], tmono[-1])


# ----------------------------------------------------- mode resolution


class _Stop(Exception):
    pass


def _jax_resolution(monkeypatch, cfg, D, unwrapped, separable, moments):
    """(separable, moments) as dgs_tpu's sample_tiled_multi resolves them:
    read off the flags it hands its two kernels, which are replaced by
    recorders returning zeros, and any warning it gives."""
    seen = {}

    def fwd(orders, period, D_, C, wl, ent, smp, **kw):
        seen["separable"] = kw["separable"]
        seen["prep"] = kw["separable"] or kw["tile_local"]
        K = jtiled.total_unique(orders, D_)
        return jnp.zeros((K * C, smp[2]), jnp.float32)

    def bwd(orders, period, D_, C, wl, ent, smp, ct, ct_t, **kw):
        seen["moments"] = kw["moments"]
        n = (jtiled.moment_layout(orders, D_)[3] + C if kw["moments"]
             else jtiled.n_params(D_, C))
        return jnp.zeros((n, ent[3]), jnp.float32)

    monkeypatch.setattr(jtiled, "tiled_forward", fwd)
    monkeypatch.setattr(jtiled, "tiled_backward", bwd)
    rng = np.random.default_rng(D)
    m, v, cov, c = map(jnp.asarray, make_gaussians(
        rng, 6, D, 1, sigma_range=(0.02, 0.05)))
    s = jnp.asarray(make_samples(rng, 9, D))
    state = jgrid.build(cfg, m, cov, s)
    fg, bg, fw, bw = _jax_geometry(state)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        jax.grad(lambda v_: sum(jnp.sum(o) for o in jsampling
                                .sample_tiled_multi(
            ("value",), cfg, m, v_, c, s, state, fg, bg, fw, bw,
            block_n=128, block_e=128, bwd_block_n=64, bwd_block_e=128,
            unwrapped=unwrapped, separable=separable, moments=moments)))(v)
    return (seen["separable"], seen["moments"]), seen["prep"], len(w) > 0


@pytest.mark.parametrize("D", [1, 2, 3])
def test_kernel_modes_match_dgs_tpu(monkeypatch, D):
    """ops.sampling.kernel_modes and the chunked path's _kernel_modes
    against dgs_tpu's resolution over fast_math_dots, wrapped or wrap-free,
    the config's separable_kernels / moment_backward and the op's forced
    flags, the warning included."""
    for fast in (False, True):
        for unwrapped in (False, True):
            for cfg_sep in (None, False, True):
                for arg_sep, arg_mom in ((None, None), (True, None),
                                         (False, True), (None, True),
                                         (None, False)):
                    kw = dict(MODE_CFG, fast_math_dots=fast,
                              separable_kernels=cfg_sep,
                              moment_backward=arg_mom)
                    jcfg = JConfig(**kw).with_dims(D)
                    tcfg = TConfig(**kw).with_dims(D)
                    want, prep, warned = _jax_resolution(
                        monkeypatch, jcfg, D, unwrapped, arg_sep,
                        arg_mom)
                    with warnings.catch_warnings(record=True) as w:
                        warnings.simplefilter("always")
                        got = tsampling.kernel_modes(
                            tcfg, D, None if unwrapped else tcfg.period,
                            arg_sep, arg_mom)
                    case = (fast, unwrapped, cfg_sep, arg_sep, arg_mom)
                    assert got[:2] == want, case
                    assert prep == any(got[:2]), case
                    assert (len(w) > 0) == warned, case
                    for period in (tcfg.period, None):
                        ccfg = dataclasses.replace(
                            tcfg, unwrapped_kernels=unwrapped,
                            period=period)
                        jccfg = dataclasses.replace(
                            jcfg, unwrapped_kernels=unwrapped,
                            period=period, upper_bounds=(
                                None if period else (1.0,) * D))
                        ccfg = dataclasses.replace(
                            ccfg, upper_bounds=jccfg.upper_bounds)
                        assert (tchunked._kernel_modes(ccfg)
                                == jchunked._kernel_modes(jccfg)), case


def test_moments_on_a_wrapped_config_warn_and_fall_back(rng):
    """moment_backward forced on a wrapped config: dgs_tpu's warning, and
    the per-pair backward runs (the op's results equal the classic
    path's)."""
    m, v, cov, c = map(torch.from_numpy, make_gaussians(rng, 30, 2, 2))
    s = torch.from_numpy(make_samples(rng, 80, 2))
    cfg = TConfig(**MODE_CFG)
    state = tgrid.build(cfg, m, cov, s)
    with pytest.warns(UserWarning, match="moment_backward=True requires"):
        got = tsampling.sample_tiled_multi(ORDERS, cfg, m, v, c, s, state,
                                           moments=True)
    ref = tsampling.sample_tiled_multi(ORDERS, cfg, m, v, c, s, state)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


# ------------------------------------------------ kernels of each mode


@contextlib.contextmanager
def _kernel_log(monkeypatch):
    """Records each tiled kernel wrapper the op calls, with its period and
    its operands' row counts, and runs the wrapper."""
    log = []
    for name in ("tiled_forward", "tiled_backward", "tiled_forward_sep",
                 "tiled_backward_moments"):
        real = getattr(ttiled, name)

        def rec(*args, _real=real, _name=name, **kw):
            i = next(i for i, a in enumerate(args)
                     if isinstance(a, torch.Tensor))
            geom = args[i]
            period = (args[1] if _name in ("tiled_forward", "tiled_backward")
                      else None)
            log.append((_name, period, geom.shape[0], args[i + 1].shape[0]))
            return _real(*args, **kw)

        monkeypatch.setattr(ttiled, name, rec)
    yield log



@pytest.mark.parametrize("mode", MODES + [(False, False)],
                         ids=["sep", "moments", "both", "classic"])
def test_each_mode_runs_its_kernels(monkeypatch, mode):
    """Which kernel each mode runs: the separable forward or, without it,
    the classic forward on the tile-local operands (wrap-free, the base
    geom rows, the [x_l, tile] samples); the moment-form backward or,
    without it, the classic backward on the same tile-local operands; the
    classic kernels alone where neither mode is on."""
    separable, moments = mode
    D, C = 3, 2
    rng = np.random.default_rng(7)
    m, v, cov, c = map(torch.from_numpy, make_gaussians(
        rng, 30, D, C, sigma_range=(0.02, 0.05)))
    s = torch.from_numpy(make_samples(rng, 80, D))
    cfg = TConfig(**MODE_CFG).with_dims(D)
    state = tgrid.build(cfg, m, cov, s)
    v = v.clone().requires_grad_()
    tri = tri_size(D)
    base, local = 1 + D + tri + C, D + 1
    with _kernel_log(monkeypatch) as log:
        outs = tsampling.sample_tiled_multi(
            ORDERS, cfg, m, v, c, s, state, unwrapped=True,
            separable=separable, moments=moments)
        sum(o.sum() for o in outs).backward()
    sep_geom = base + ttiled.sep_rows(D)
    mono = ttiled.mono_rows(D) + 1
    fwd = (("tiled_forward_sep", None, sep_geom, mono) if separable
           else ("tiled_forward", None, base, local) if moments
           else ("tiled_forward", None, base, D + 1))
    bwd = (("tiled_backward_moments", None, sep_geom, mono) if moments
           else ("tiled_backward", None, base, local))
    assert log == [fwd, bwd]


# ---------------------------------------------------------------- span


def test_span_packed_work_items_match_span1():
    """work_span_fwd/bwd > 1 asks dgs_tpu to pack its TPU work list; the
    port accepts the knob and reads nothing of it: outputs and gradients
    are bitwise equal to span 1 (twin of test_binning_tiled.py::
    test_span_packed_work_items_match_span1)."""
    rng = np.random.default_rng(0)
    P, N, D, C = 120, 384, 2, 2
    means, values, covs, conics = make_gaussians(
        rng, P, D, C, sigma_range=(0.03, 0.1))
    samples = torch.from_numpy(rng.uniform(-1, 1, (N, D)).astype(np.float32))
    base = TConfig(tile_size=0.11, max_tiles_per_gaussian=8,
                   entry_capacity_factor=120.0, work_blocks_fwd=256,
                   work_blocks_bwd=256, block_n=128, block_p=128,
                   block_n_bwd=128, block_p_bwd=128, eig_floor=1e-12)

    def run(cfg):
        params = [torch.from_numpy(a).clone().requires_grad_()
                  for a in (means, values, conics)]
        outs, diag = tsampling.sample_binned(
            cfg, *params, torch.from_numpy(covs), samples,
            ("value", "laplacian"))
        for k, val in diag.items():
            if k != "perm":
                assert int(val) == 0, k
        loss = sum((o * o).sum() for o in outs.values())
        return ([o.detach() for o in outs.values()],
                torch.autograd.grad(loss, params))

    ref_outs, ref_grads = run(base)
    for span in ((2, 2), (3, 1), (1, 4)):
        outs, grads = run(dataclasses.replace(
            base, work_span_fwd=span[0], work_span_bwd=span[1]))
        for a, b in zip(outs + list(grads), ref_outs + list(ref_grads)):
            assert torch.equal(a, b), span
