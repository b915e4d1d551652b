"""dgs_tpu_torch's tiled sampling op (plain path, CPU tensors) against
dgs_tpu.ops.sampling's tiled path (Pallas kernels in interpret mode): the
kernel operands, every order at D in {1,2,3}, wrapped and unwrapped, the
three output modes and the diagnostics; then the gradients, against JAX's
and against autograd through the port's dense masked oracle."""

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
from dgs_tpu_torch.config import SamplerConfig as TConfig, tri_size
from dgs_tpu_torch.kernels import tiled as ttiled
from dgs_tpu_torch.models.field import init_field
from dgs_tpu_torch.ops import formulas as tformulas
from dgs_tpu_torch.ops import sampling as tsampling
from dgs_tpu_torch.oracle import dense as toracle

from conftest import make_gaussians, make_samples

torch.set_num_threads(2)

ORDERS = ("value", "derivative", "laplacian", "third")


def assert_close(got, ref, err_msg=""):
    ref = np.asarray(ref)
    np.testing.assert_allclose(
        np.asarray(got), ref, rtol=2e-4,
        atol=1e-5 * max(1.0, float(np.abs(ref).max(initial=0.0))),
        err_msg=err_msg)


def assert_grad_close(got, ref, err_msg=""):
    """The JAX suite's gradient tolerance (test_binning_tiled.py:155)."""
    ref = np.asarray(ref)
    np.testing.assert_allclose(
        np.asarray(got), ref, rtol=2e-3,
        atol=1e-5 * max(1.0, float(np.abs(ref).max(initial=0.0))),
        err_msg=err_msg)


def _grads(loss, *args):
    """Autograd gradients of loss(*args) w.r.t. every argument."""
    args = [a.clone().requires_grad_() for a in args]
    return torch.autograd.grad(loss(*args), args)


def _setup(rng, P, N, D, C=3, cfg_kw=None, **kw):
    cfg_kw = dict(max_tiles_per_gaussian=8, **(cfg_kw or {}))
    m, v, cov, c = make_gaussians(rng, P, D, C, **kw)
    s = make_samples(rng, N, D)
    jc = JConfig(**cfg_kw).with_dims(D)
    tc = TConfig(**cfg_kw).with_dims(D)
    J = tuple(map(jnp.asarray, (m, v, cov, c, s)))
    T = tuple(map(torch.from_numpy, (m, v, cov, c, s)))
    return jc, tc, J, T


def _jax_geometry(state):
    fg = jgrid.forward_geometry(state, 128, 128)
    bg = jgrid.backward_geometry(state, 128, 64)
    fw = int(jax.device_get(jnp.maximum(fg[1], 1).sum()))
    bw = int(jax.device_get(jnp.maximum(bg[1], 1).sum()))
    return fg, bg, fw, bw


def _jax_tiled(orders, cfg, m, v, c, s, state, geometry=None, **kw):
    fg, bg, fw, bw = geometry or _jax_geometry(state)
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


def test_ablation_hook_and_bad_orders_raise(rng, monkeypatch):
    _, tc, _, (tm, tv, tcov, tcon, ts) = _setup(rng, 20, 50, 2)
    with pytest.raises(ValueError, match="repeated order"):
        tsampling.sample_binned(tc, tm, tv, tcon, tcov, ts,
                                ("value", "value"))
    monkeypatch.setenv("DGS_ABLATE", "fdots")
    with pytest.raises(NotImplementedError, match="DGS_ABLATE"):
        tsampling.sample_binned(tc, tm, tv, tcon, tcov, ts, ("value",))


@pytest.mark.parametrize("D", [1, 2, 3])
@pytest.mark.parametrize("unwrapped", [False, True])
def test_sample_tiled_multi_grads_match(rng, D, unwrapped):
    """d(sum_o <cot_o, out_o>)/d(means, values, conics) through the port
    (backward plain version + segment-sum) against jax.grad through
    dgs_tpu (Pallas backward in interpret mode), all four orders."""
    _check_tiled_grads(rng, D, unwrapped)


def entry_major(rows):
    """The (F, E) transpose view of an entry-major (E, F) copy of rows: the
    layout the CUDA backward kernels hand the segment-sum."""
    return rows.T.contiguous().T


def test_tiled_grads_match_with_entry_major_rows(rng, monkeypatch):
    """The gradient twin at D = 2 with the backward's per-entry rows handed
    to segment_sum_rows as the CUDA kernel hands them, the transpose view
    of an (E, F) buffer: the same gradients as jax.grad through dgs_tpu,
    and the segment-sum reads the view in place."""
    from dgs_tpu_torch.kernels import segment

    backward, plain = ttiled.tiled_backward, segment.segment_sum_plain
    strides = []

    def spy(rows, order, starts):
        strides.append(rows.stride())
        return plain(rows, order, starts)

    monkeypatch.setattr(ttiled, "tiled_backward",
                        lambda *a: entry_major(backward(*a)))
    monkeypatch.setattr(segment, "segment_sum_plain", spy)
    _check_tiled_grads(rng, 2, False)
    F = 2 + tri_size(2) + 3
    assert strides and all(st == (1, F) for st in strides)


def _check_tiled_grads(rng, D, unwrapped):
    jc, tc, (jm, jv, jcov, jcon, js), (tm, tv, tcov, tcon, ts) = _setup(
        rng, 31, 37, D)
    jstate = jgrid.build(jc, jm, jcov, js)
    tstate = tgrid.build(tc, tm, tcov, ts)
    cots = [rng.normal(0.0, 1.0, (37,) + tuple(o.shape[1:])).astype(
        np.float32) for o in tsampling.sample_tiled_multi(
            ORDERS, tc, tm, tv, tcon, ts, tstate)]

    geometry = _jax_geometry(jstate)

    def jloss(m, v, c):
        outs = _jax_tiled(ORDERS, jc, m, v, c, js, jstate, geometry,
                          unwrapped=unwrapped)
        return sum(jnp.sum(o * k) for o, k in zip(outs, cots))

    def tloss(m, v, c):
        outs = tsampling.sample_tiled_multi(ORDERS, tc, m, v, c, ts, tstate,
                                            unwrapped=unwrapped)
        return sum((o * torch.from_numpy(k)).sum() for o, k in zip(outs, cots))

    ref = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(jm, jv, jcon)
    got = _grads(tloss, tm, tv, tcon)
    for g, r, name in zip(got, ref, ("means", "values", "conics")):
        assert_grad_close(g, r, f"dL/d{name} D={D} unwrapped={unwrapped}")


@pytest.mark.parametrize("D", [1, 2, 3])
def test_tiled_grads_match_masked_oracle_autodiff(rng, D):
    """Twin of test_binning_tiled.py's backward test: the port's gradients
    against autograd through the port's dense oracle under the binning's
    pair mask."""
    _, tc, _, (m, v, cov, c, s) = _setup(rng, 31, 37, D)
    state = tgrid.build(tc, m, cov, s)
    mask = tgrid.pair_mask_dense(tc, state, s, 31)

    def loss_tiled(m_, v_, c_):
        outs = tsampling.sample_tiled_multi(ORDERS, tc, m_, v_, c_, s, state)
        return sum((o ** 2).sum() for o in outs)

    def loss_oracle(m_, v_, c_):
        return sum((toracle.evaluate(o, m_, v_, c_, s, pair_mask=mask) ** 2)
                   .sum() for o in ORDERS)

    for g, r, name in zip(_grads(loss_tiled, m, v, c),
                          _grads(loss_oracle, m, v, c),
                          ("means", "values", "conics")):
        assert_grad_close(g, r, f"dL/d{name} D={D}")


def _field_case(rng, seed, P=120, N=500, D=2, C=3):
    g = torch.Generator().manual_seed(seed)
    f = init_field(g, P, D, C, sigma=0.06)
    s = torch.from_numpy(make_samples(rng, N, D))
    cfg = TConfig(tile_size=0.25, max_tiles_per_gaussian=4, eig_floor=1e-12,
                  entry_capacity_factor=30.0)
    with torch.no_grad():
        return cfg, f.means, f.values, f.conics(), f.covariances(), s


def test_output_mode_grads_match(rng):
    """Twin of test_binning_tiled.py's padded/sorted/unique test: the same
    loss and gradients through the full mirrored outputs (sum of squares),
    the sorted unique outputs and the padded ones with a prebuilt sample
    binning (both weighted by the mirror multiplicities)."""
    cfg, m, v, c, cov, s = _field_case(rng, 3)
    orders = ("value", "laplacian")
    sb = tgrid.bin_samples(cfg, s)
    mult = {o: torch.tensor(tformulas.sym_multiplicity(o, 2),
                            dtype=torch.float32) for o in orders}

    def loss(mode):
        def inner(m_, v_, c_):
            kw = {"full": {},
                  "unique": {"sorted_outputs": True, "unique_outputs": True},
                  "padded": {"sorted_outputs": True, "unique_outputs": True,
                             "padded_outputs": True, "sample_binning": sb},
                  }[mode]
            outs, diag = tsampling.sample_binned(cfg, m_, v_, c_, cov, s,
                                                 orders, **kw)
            for k in ("bin_overflow", "entry_overflow", "work_overflow_fwd",
                      "work_overflow_bwd"):
                assert int(diag[k]) == 0, (k, int(diag[k]))
            if mode == "full":
                return sum((o * o).sum() for o in outs.values())
            if mode == "unique":
                return sum(torch.einsum("nuc,u->", o * o, mult[k])
                           for k, o in outs.items())
            return sum(torch.einsum("ucn,u->", o * o, mult[k])
                       for k, o in outs.items())
        args = [a.clone().requires_grad_() for a in (m, v, c)]
        val = inner(*args)
        return val.detach(), torch.autograd.grad(val, args)

    l0, g0 = loss("full")
    for mode in ("unique", "padded"):
        l1, g1 = loss(mode)
        np.testing.assert_allclose(l1.numpy(), l0.numpy(), rtol=1e-5)
        for a, b, name in zip(g1, g0, ("means", "values", "conics")):
            np.testing.assert_allclose(
                a.numpy(), b.numpy(), rtol=1e-5,
                atol=1e-6 * max(1.0, float(b.abs().max())),
                err_msg=f"{mode} dL/d{name}")


def test_backward_is_deterministic(rng):
    """Two identical runs give bitwise-equal gradients (the gid
    segment-sum has a fixed order and no atomics)."""
    cfg, m, v, c, cov, s = _field_case(rng, 9)

    def loss(m_, v_, c_):
        outs, _ = tsampling.sample_binned(
            cfg, m_, v_, c_, cov, s, ("value", "derivative", "laplacian"))
        return sum((o * o).sum() for o in outs.values())

    for a, b in zip(_grads(loss, m, v, c), _grads(loss, m, v, c)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_segment_sum_rows_sums_by_gid_and_checks_slots():
    """The segment-sum adds each Gaussian's columns, drops sentinels
    (gid == P), and raises when a Gaussian has more columns than slots
    instead of writing into the next Gaussian's slots."""
    gid = torch.tensor([2, 0, 3, 2, 0, 3, 2], dtype=torch.int32)   # P = 3
    rows = torch.arange(14, dtype=torch.float32).reshape(2, 7)
    got = tsampling.segment_sum_rows(rows, gid, 3, slots=3)
    want = torch.zeros((3, 2))
    want.index_add_(0, gid[gid < 3].long(), rows[:, gid < 3].T)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    with pytest.raises(ValueError, match="more than 2 entries"):
        tsampling.segment_sum_rows(rows, gid, 3, slots=2)


def test_third_d1_conic_gradient_follows_dgs_tpu():
    """Twin of test_backward_replica.py's D=1 third-order pin: the port's
    conic gradient is the derivative of its own forward (dgs_tpu's form),
    not the CUDA reference's backward.cu:322-325 form."""
    X, c = 0.37, 2.1
    cfg = TConfig(lower=(-1.0,), max_tiles_per_gaussian=8)
    x = torch.tensor([[0.1]])
    m = torch.tensor([[0.1 + X]], requires_grad=True)
    con = torch.tensor([[c]], requires_grad=True)
    val = torch.ones((1, 1), requires_grad=True)
    outs, diag = tsampling.sample_binned(cfg, m, val, con, 1.0 / con.detach(),
                                         x, ("third",))
    assert int(diag["bin_overflow"]) == 0
    outs["third"].sum().backward()
    x1 = c * X
    G = np.exp(-0.5 * c * X * X)
    p = 3.0 * c * x1 - x1 ** 3
    ours = (-0.5 * X * X * p + 6.0 * x1 - 3.0 * x1 * x1 * X) * G
    ref_form = (2.0 * X * X - 2.0 * x1 * x1 * X
                - 0.5 * (2.0 * X * x1 - X) * X * X
                + 0.5 * (x1 * x1 - c) * x1 * X * X) * G
    got = float(con.grad[0, 0])
    np.testing.assert_allclose(got, ours, rtol=1e-4)
    assert abs(got - ref_form) > 1.0
    np.testing.assert_allclose(float(outs["third"].detach()[0, 0, 0, 0, 0]),
                               G * p, rtol=1e-5)


@pytest.mark.parametrize("D", [1, 2, 3])
def test_plain_backward_chunking_and_sentinels(rng, D):
    """The backward plain version's chunking over entry blocks does not
    change its rows; sentinel (gid == P) and pad entries come back zero,
    and pad sample columns never pair (their cotangent is ignored)."""
    P, N, C = 60, 700, 3
    _, tc, _, (tm, tv, tcov, tcon, ts) = _setup(
        rng, P, N, D, C, cfg_kw={"tile_size": 0.2,
                                 "entry_capacity_factor": 100.0},
        sigma_range=(0.02, 0.1))
    state = tgrid.build(tc, tm, tcov, ts)
    assert int(state.overflow) == 0 and int(state.entry_overflow) == 0
    gid, _, geom, Ep = ttiled.prepare_entries(state, tm, tv, tcon, 128,
                                              cfg=tc)
    smp, _, Np = ttiled.prepare_samples(state, ts, ttiled.BLOCK_N)
    lo, n = ttiled.sample_ranges(state, Ep)
    assert lo.shape == (Ep // ttiled.BLOCK_E,) and lo.dtype == torch.int32
    K = ttiled.total_unique(ORDERS, D)
    ct = torch.from_numpy(rng.normal(0.0, 1.0, (K * C, Np)).astype(
        np.float32))
    whole = ttiled.tiled_backward_plain(ORDERS, 2.0, D, C, geom, smp, ct,
                                        lo, n, chunk_blocks=10 ** 6)
    per_block = ttiled.tiled_backward_plain(ORDERS, 2.0, D, C, geom, smp, ct,
                                            lo, n, chunk_blocks=1)
    assert whole.shape == (D + tri_size(D) + C, Ep)
    assert_close(per_block, whole)
    sentinel = gid == P
    assert bool(sentinel.any())
    assert not bool(whole[:, sentinel].any())
    assert bool(whole[:, ~sentinel].any())
    ct_nopad = ct.clone()
    ct_nopad[:, N:] = 0.0
    np.testing.assert_array_equal(
        ttiled.tiled_backward_plain(ORDERS, 2.0, D, C, geom, smp, ct_nopad,
                                    lo, n, chunk_blocks=10 ** 6).numpy(),
        whole.numpy())
    # On a CPU tensor the wrapper is the plain version.
    assert_close(ttiled.tiled_backward(ORDERS, 2.0, D, C, geom, smp, ct, lo,
                                       n), whole)
