"""The folded kernel modes of the tiled path (the folded forward, the folded
dvalues, the folded VJP) and h_matmul in dgs_tpu_torch (plain versions, CPU
tensors) against dgs_tpu's (Pallas kernels in interpret mode) on the same
seeded numpy inputs: the monomial-expansion helpers key for key, the operand
builders, the op's values and gradients in each mode at D = 1-3, the D = 3
chunked path under folded_values and folded_dvals, and the mode resolution
(kernel_modes) over the flags, a forced separable or moment mode, wrapped
configs and the beta-expanded cotangent's size gate.

Tolerances.  Gradients: the JAX suite's for a mode against the classic path
(tests/test_binning_tiled.py:441-446: rtol 2e-3, atol 2e-4 max(1, |ref|)).
Outputs: rtol 1e-4 with the same atol.  The folded forward expands each
component polynomial over the sample's monomials, whose terms cancel: two
fp32 evaluations of it in different summation orders differ by up to about
2e-4 of the largest output (dgs_tpu's own folded forward against its
classic one reads 2.2e-4 on the third order at D = 2 here), so the kernel
tolerance's atol of 1e-5 is below the algorithm's rounding."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgs_tpu.binning import grid as jgrid
from dgs_tpu.config import SamplerConfig as JConfig
from dgs_tpu.kernels import tiled as jtiled
from dgs_tpu.ops import formulas as jformulas
from dgs_tpu.ops import sampling as jsampling
from dgs_tpu.ops import sampling_chunked as jchunked
from dgs_tpu.oracle.dense import radii_axis as jradii_axis
from dgs_tpu_torch.binning import grid as tgrid
from dgs_tpu_torch.config import SamplerConfig as TConfig, tri_size
from dgs_tpu_torch.kernels import tiled as ttiled
from dgs_tpu_torch.ops import formulas as tformulas
from dgs_tpu_torch.ops import sampling as tsampling
from dgs_tpu_torch.ops import sampling_chunked as tchunked
from dgs_tpu_torch.oracle.dense import radii_axis as tradii_axis

from conftest import make_gaussians, make_samples

torch.set_num_threads(2)

ORDERS = ("value", "derivative", "laplacian", "third")
THREE = ("value", "derivative", "laplacian")
ORDER_SETS = [THREE, ORDERS, ("value", "laplacian"), ("third",)]
PARAMS = ("means", "values", "conics")
MODE_CFG = dict(max_tiles_per_gaussian=4, tile_size=0.51, eig_floor=1e-12)
ATOL_REL = 2e-4


def assert_close(got, ref, rtol, err_msg=""):
    ref = np.asarray(ref)
    np.testing.assert_allclose(
        np.asarray(got), ref, rtol=rtol,
        atol=ATOL_REL * max(1.0, float(np.abs(ref).max(initial=0.0))),
        err_msg=err_msg)


# ------------------------------------------------------ formula helpers


@pytest.mark.parametrize("D", [1, 2, 3])
def test_formula_helpers_match_dgs_tpu(D):
    """monomials_upto, comp_flat_index, folded_structure (key for key) and
    the per-entry coefficients of component_coeff_polys and w_coeff_polys
    on seeded (mu, conic) rows."""
    rng = np.random.default_rng(D)
    mu = [rng.standard_normal(7).astype(np.float32) for _ in range(D)]
    con = [rng.standard_normal(7).astype(np.float32)
           for _ in range(tri_size(D))]
    for deg in range(4):
        assert (tformulas.monomials_upto(D, deg)
                == jformulas.monomials_upto(D, deg))
    for orders in ORDER_SETS:
        assert (tformulas.folded_structure(orders, D)
                == jformulas.folded_structure(orders, D)), orders
        assert (tformulas.comp_flat_index(orders, D)
                == jformulas.comp_flat_index(orders, D))
        pairs = ((tformulas.component_coeff_polys,
                  jformulas.component_coeff_polys),
                 (lambda *a: [p for p in tformulas.w_coeff_polys(*a)],
                  lambda *a: [p for p in jformulas.w_coeff_polys(*a)]))
        for tfn, jfn in pairs:
            got = tfn(orders, D, [torch.from_numpy(m) for m in mu],
                      [torch.from_numpy(c) for c in con])
            ref = jfn(orders, D, [jnp.asarray(m) for m in mu],
                      [jnp.asarray(c) for c in con])
            assert len(got) == len(ref)
            for g, r in zip(got, ref):
                assert list(g) == list(r), orders
                for key in r:
                    np.testing.assert_allclose(
                        np.broadcast_to(np.asarray(g[key]), (7,)),
                        np.broadcast_to(np.asarray(r[key]), (7,)),
                        rtol=1e-6, atol=1e-6, err_msg=str((orders, key)))


@pytest.mark.parametrize("D", [1, 2, 3])
def test_operand_builders_match_dgs_tpu(D):
    """build_folded (alpha, fold and foldw on the first R rows of each
    block: the port pads R to 16, dgs_tpu to 8 or 128), ct_beta_rows and
    sample_monomials_raw, and the row tables."""
    rng = np.random.default_rng(10 + D)
    C, Ep, Np = 3, 40, 50
    for orders in ORDER_SETS:
        meta, _ = tformulas.folded_structure(orders, D)
        R, Rp = ttiled.fold_rows(meta, C)
        assert Rp % ttiled.FOLD_ROW_PAD == 0 and R == jtiled.fold_rows(
            meta, C)[0]
        assert ttiled.fold_row_table(meta, C) == jtiled.fold_row_table(meta,
                                                                       C)
        assert (ttiled.fold_row_selectors(meta, C)
                == jtiled.fold_row_selectors(meta, C))
        ent = rng.standard_normal((Ep, D + tri_size(D) + C)).astype(
            np.float32) * 0.3
        ta, tf, tw = ttiled.build_folded(orders, D, C, torch.from_numpy(ent),
                                         meta, vjp=True)
        ja, jf, jw = jtiled.build_folded(orders, D, C, jnp.asarray(ent), meta,
                                         vjp=True)
        np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-6,
                                   atol=1e-6)
        assert tf.shape == (Rp, Ep) and not tf[R:].any()
        np.testing.assert_allclose(tf[:R].numpy(), np.asarray(jf)[:R],
                                   rtol=1e-6, atol=1e-6)
        R8 = jf.shape[0]
        assert tw.shape == (D * Rp, Ep)
        for l in range(D):
            np.testing.assert_allclose(
                tw[l * Rp:l * Rp + R].numpy(),
                np.asarray(jw)[l * R8:l * R8 + R], rtol=1e-6, atol=1e-6)
        n_mono = len(tformulas.monomials_upto(D, 3))
        g = rng.standard_normal((ttiled.total_unique(orders, D) * C,
                                 Np)).astype(np.float32)
        mono = rng.standard_normal((n_mono, Np)).astype(np.float32)
        cb = ttiled.ct_beta_rows(meta, C, torch.from_numpy(g),
                                 torch.from_numpy(mono))
        ref = jtiled.ct_beta_rows(meta, C, jnp.asarray(g), jnp.asarray(mono))
        assert cb.shape == (Rp, Np) and not cb[R:].any()
        np.testing.assert_allclose(cb[:R].numpy(), np.asarray(ref)[:R],
                                   rtol=1e-6, atol=0)
    kw = dict(MODE_CFG, period=None, lower=(-1.0,) * D,
              upper_bounds=(1.0,) * D)
    tcfg, jcfg = TConfig(**kw), JConfig(**kw)
    coords = rng.uniform(-1, 1, (D, Np)).astype(np.float32)
    T = tgrid.num_tiles(tcfg, D)
    tile = rng.integers(0, T + 1, (1, Np)).astype(np.int32)   # T: sentinel
    for deg in range(4):
        got = ttiled.sample_monomials_raw(tcfg, torch.from_numpy(coords),
                                          torch.from_numpy(tile), D, deg)
        ref = jtiled.sample_monomials_raw(jcfg, jnp.asarray(coords),
                                          jnp.asarray(tile), D, deg)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                                   atol=1e-7)


# ------------------------------------------------------ each mode, D 1-3

# mode: (SamplerConfig flags, the kernels the port runs for it)
MODES = {
    "folded_hmm": dict(folded_values=True, h_matmul=True),
    "fdv": dict(folded_values=True, folded_dvals=True),
    "fvjp": dict(folded_values=True, folded_dvals=True, folded_vjp=True),
}


def _inputs(D, seed):
    rng = np.random.default_rng(seed)
    m, v, cov, c = make_gaussians(rng, 37, D, 3, sigma_range=(0.02, 0.05))
    return m, v, cov, c, make_samples(rng, 53, D)


def _loss_of(outs, lib):
    return sum(lib.sum(o * o) / (1.0 + lib.sum(o * o)) * 100.0
               for o in outs)


def _jax_mode(D, arrays, flags):
    m, v, cov, c, s = map(jnp.asarray, arrays)
    cfg = JConfig(**MODE_CFG, **flags).with_dims(D)
    state = jgrid.build(cfg, m, cov, s)
    fg = jgrid.forward_geometry(state, 128, 128)
    bg = jgrid.backward_geometry(state, 128, 64)
    fw = int(jax.device_get(jnp.maximum(fg[1], 1).sum()))
    bw = int(jax.device_get(jnp.maximum(bg[1], 1).sum()))

    def outs(m_, v_, c_):
        return jsampling.sample_tiled_multi(
            ORDERS, cfg, m_, v_, c_, s, state, fg, bg, fw, bw,
            block_n=128, block_e=128, bwd_block_n=64, bwd_block_e=128,
            unwrapped=True)

    grads = jax.jit(jax.grad(lambda *a: _loss_of(outs(*a), jnp),
                             argnums=(0, 1, 2)))(m, v, c)
    return [np.asarray(o) for o in outs(m, v, c)], grads


def _port_mode(D, arrays, flags, monkeypatch):
    """The port's op in the mode, with the kernel wrappers it called."""
    m, v, cov, c, s = map(torch.from_numpy, arrays)
    cfg = TConfig(**MODE_CFG, **flags).with_dims(D)
    state = tgrid.build(cfg, m, cov, s)
    called = []
    for name in ("tiled_forward", "tiled_backward", "tiled_forward_folded",
                 "tiled_backward_fdv", "tiled_backward_fvjp",
                 "tiled_backward_hmm"):
        real = getattr(ttiled, name)
        monkeypatch.setattr(ttiled, name, lambda *a, _r=real, _n=name, **k:
                            called.append((_n, k.get("h_matmul")))
                            or _r(*a, **k))
    params = [t.clone().requires_grad_() for t in (m, v, c)]
    outs = tsampling.sample_tiled_multi(ORDERS, cfg, *params, s, state,
                                        unwrapped=True)
    grads = torch.autograd.grad(_loss_of(outs, torch), params)
    return [o.detach() for o in outs], grads, called


KERNELS = {"folded_hmm": [("tiled_forward_folded", None),
                          ("tiled_backward_hmm", None)],
           "fdv": [("tiled_forward_folded", None),
                   ("tiled_backward_fdv", False)],
           "fvjp": [("tiled_forward_folded", None),
                    ("tiled_backward_fvjp", None)]}


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("D", [1, 2, 3])
def test_folded_modes_match_dgs_tpu(D, mode, monkeypatch):
    """sample_tiled_multi in each mode (the folded forward with the classic
    backward under h_matmul, on the tile-local operands; the folded
    dvalues; the folded VJP): the four orders' values and the three
    gradients against dgs_tpu's in the same mode, and the kernels the port
    ran (h_matmul of the folded dvalues and of the moment form: the
    emulated kernel tests and the next test)."""
    arrays = _inputs(D, 10 + D)
    ref_outs, ref_grads = _jax_mode(D, arrays, MODES[mode])
    outs, grads, called = _port_mode(D, arrays, MODES[mode], monkeypatch)
    assert called == KERNELS[mode]
    for order, o, r in zip(ORDERS, outs, ref_outs):
        assert o.shape == r.shape, order
        assert_close(o, r, 1e-4, order)
    for name, g, r in zip(PARAMS, grads, ref_grads):
        assert_close(g, r, 2e-3, name)


def test_moments_with_h_matmul_match_dgs_tpu(monkeypatch):
    """h_matmul under the moment-form backward at D = 3 (its kernel takes
    the flag): values and gradients against dgs_tpu's same mode."""
    flags = dict(moment_backward=True, h_matmul=True)
    arrays = _inputs(3, 40)
    ref_outs, ref_grads = _jax_mode(3, arrays, flags)
    outs, grads, _ = _port_mode(3, arrays, flags, monkeypatch)
    for o, r in zip(outs, ref_outs):
        assert_close(o, r, 1e-4)
    for name, g, r in zip(PARAMS, grads, ref_grads):
        assert_close(g, r, 2e-3, name)


# ------------------------------------------------------------- chunked

FOLDED_CHUNKED = dict(tile_size=0.2, axis_radii=True, ellip_cull=True,
                      block_n=128, block_p=128, eig_floor=1e-12,
                      folded_values=True, folded_dvals=True)


def test_chunked_folded_matches_dgs_tpu():
    """The D = 3 chunked path under folded_values and folded_dvals (bench.py's
    D = 3 flags) against dgs_tpu's chunked path with the same flags: the
    sample side carries the raw monomials to degree 3, the evaluation
    slices the prefix its orders need; outputs and gradients."""
    P, N, C, D = 200, 500, 3, 3
    rng = np.random.default_rng(6)
    arrays = make_gaussians(rng, P, D, C, sigma_range=(0.03, 0.1))
    arrays = (*arrays, rng.uniform(-1.0, 1.0, (N, D)).astype(np.float32))
    jm, jv, jcov, jcon, js = map(jnp.asarray, arrays)
    jcfg, jplan = jchunked.plan_chunked(JConfig(**FOLDED_CHUNKED), jm, jcov,
                                        js)
    assert jchunked._kernel_modes(jcfg) == (False, False, True)
    jcs = jchunked.chunk_samples(jcfg, js, jplan, jcfg.block_n)
    jrad = jradii_axis(jcov, D, jcfg.radius_sigma, jcfg.eig_floor)

    def jrun(m_, v_, c_):
        return jchunked.sample_chunked_multi(
            THREE, jcfg, m_, v_, c_, jrad, jcs, jplan, block_n=128,
            block_e=128)

    ref, _ = jrun(jm, jv, jcon)
    weights = [1.0 / float(np.prod(o.shape)) for o in ref]
    ref_grads = jax.jit(jax.grad(lambda *a: sum(
        jnp.sum(o * o) * w for o, w in zip(jrun(*a)[0], weights)),
        argnums=(0, 1, 2)))(jm, jv, jcon)

    tm, tv, tcov, tcon, ts = map(torch.from_numpy, arrays)
    cfg, plan = tchunked.plan_chunked(TConfig(**FOLDED_CHUNKED), tm, tcov, ts)
    assert tchunked._kernel_modes(cfg) == (False, False, True)
    cs = tchunked.chunk_samples(cfg, ts, plan, cfg.block_n)
    assert cs.mono.shape[0] == len(tformulas.monomials_upto(D, 3)) + 1
    rad = tradii_axis(tcov, D, cfg.radius_sigma, cfg.eig_floor)
    params = [t.clone().requires_grad_() for t in (tm, tv, tcon)]
    outs, diag = tchunked.sample_chunked_multi(
        THREE, cfg, *params, rad, cs, plan, block_n=128, block_e=128)
    assert not any(int(x) for k, x in diag.items() if k != "perm")
    grads = torch.autograd.grad(sum((o * o).sum() * w for o, w in zip(
        outs, weights)), params)
    for order, o, r in zip(THREE, outs, ref):
        assert_close(o.detach(), r, 1e-4, order)
    for name, g, r in zip(PARAMS, grads, ref_grads):
        assert_close(g, r, 2e-3, name)


# ----------------------------------------------------- mode resolution


def _jax_resolution(monkeypatch, cfg, D, unwrapped):
    """dgs_tpu's sample_tiled_multi's modes (given cfg.moment_backward, as
    its sample_binned passes it), read off the flags it hands its two
    kernels (replaced by recorders returning zeros): (separable, moments,
    folded, folded_dvals, folded_vjp, h_matmul)."""
    seen = {}

    def fwd(orders, period, D_, C, wl, ent, smp, **kw):
        seen.update(separable=kw["separable"],
                    folded=kw["folded"] is not None)
        return jnp.zeros((jtiled.total_unique(orders, D_) * C, smp[2]),
                         jnp.float32)

    def bwd(orders, period, D_, C, wl, ent, smp, ct, ct_t, **kw):
        seen.update({k: kw[k] for k in ("moments", "folded_dvals",
                                         "folded_vjp", "h_matmul")})
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
    fg = jgrid.forward_geometry(state, 128, 128)
    bg = jgrid.backward_geometry(state, 128, 64)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jax.grad(lambda v_: sum(jnp.sum(o) for o in jsampling
                                .sample_tiled_multi(
            ("value",), cfg, m, v_, c, s, state, fg, bg, 64, 64,
            block_n=128, block_e=128, bwd_block_n=64, bwd_block_e=128,
            unwrapped=unwrapped, moments=cfg.moment_backward)))(v)
    return (seen["separable"], seen["moments"], seen["folded"],
            bool(seen["folded_dvals"]), bool(seen["folded_vjp"]),
            bool(seen["h_matmul"]))


RESOLUTION_CASES = [
    {}, dict(folded_values=True), dict(folded_values=True,
                                       fast_math_dots=True),
    dict(folded_values=True, separable_kernels=True),
    dict(folded_values=True, moment_backward=True),
    dict(folded_values=True, folded_dvals=True),
    dict(folded_values=True, folded_dvals=False),
    dict(folded_values=True, folded_vjp=True),
    dict(folded_values=True, folded_dvals=True, folded_vjp=True),
    dict(folded_values=True, folded_dvals=True, folded_vjp=True,
         gate="closed"),
    dict(folded_values=True, folded_dvals=True, gate="closed"),
    dict(folded_values=True, folded_dvals=True, gate="at"),
    dict(h_matmul=True), dict(h_matmul=True, fast_math_dots=True),
    dict(folded_dvals=True, folded_vjp=True, h_matmul=True),
]


@pytest.mark.parametrize("D", [2, 3])
def test_kernel_modes_match_dgs_tpu_resolution(monkeypatch, D):
    """kernel_modes' six modes against dgs_tpu's resolution over the folded
    flags, a forced separable or moment mode and fast_math_dots (which at
    wrap-free D >= 3 runs separable + moments even with folded_values),
    folded_dvals None (off, as dgs_tpu's code reads it), folded_vjp without
    the folded dvalues (off), wrapped and wrap-free configs, and the
    beta-expanded cotangent's size gate (CT_BETA_MAX_BYTES set just below,
    at and far above the cotangent's bytes in both packages)."""
    beta = tsampling.ct_beta_bytes(("value",), D, 1, 128)   # dgs_tpu's Np
    cases = [(c, True) for c in RESOLUTION_CASES] + [
        (c, False) for c in RESOLUTION_CASES[:2] + RESOLUTION_CASES[8:9]
        + RESOLUTION_CASES[12:13] + RESOLUTION_CASES[4:5]]
    for case, unwrapped in cases:
        kw = dict(case)
        gate = {"closed": beta - 1, "at": beta}.get(kw.pop("gate", None),
                                                    10 ** 12)
        monkeypatch.setattr(jtiled, "CT_BETA_MAX_BYTES", gate)
        monkeypatch.setattr(ttiled, "CT_BETA_MAX_BYTES", gate)
        want = _jax_resolution(monkeypatch, JConfig(**MODE_CFG, **kw)
                               .with_dims(D), D, unwrapped)
        tcfg = TConfig(**MODE_CFG, **kw).with_dims(D)
        got = tsampling.kernel_modes(
            tcfg, D, None if unwrapped else tcfg.period,
            tcfg.separable_kernels, tcfg.moment_backward, warn=False,
            beta_bytes=beta)
        assert got == want, (case, unwrapped)
        if unwrapped:
            ccfg = tcfg.__class__(**{**MODE_CFG, **kw,
                                     "unwrapped_kernels": True}).with_dims(D)
            assert tchunked._kernel_modes(ccfg) == got[:3], case
