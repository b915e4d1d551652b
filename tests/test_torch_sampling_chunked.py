"""dgs_tpu_torch's chunked sampling path (ops.sampling_chunked, plain
kernels on CPU tensors) against dgs_tpu's (Pallas kernels in interpret
mode) on the same seeded numpy inputs, and against the port's tiled path.
Twin of tests/test_sampling_chunked.py.  The JAX references are computed
once per module (``jax_ref``)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgs_tpu.config import SamplerConfig as JConfig
from dgs_tpu.ops import sampling_chunked as jchunked
from dgs_tpu.oracle.dense import radii as jradii, radii_axis as jradii_axis
from dgs_tpu_torch.binning import grid as tgrid
from dgs_tpu_torch.config import SamplerConfig as TConfig
from dgs_tpu_torch.ops import formulas as tformulas
from dgs_tpu_torch.ops import sampling as tsampling
from dgs_tpu_torch.ops import sampling_chunked as tchunked
from dgs_tpu_torch.oracle.dense import radii as tradii, radii_axis as \
    tradii_axis

from conftest import make_gaussians

torch.set_num_threads(2)

ORDERS = ("value", "derivative", "laplacian", "third")
PARAMS = ("means", "values", "conics")
# The JAX twin's configuration (test_sampling_chunked.py:48-52); the block
# and work-list sizes are dgs_tpu's and are not read by the port.
BASE = dict(tile_size=0.11, max_tiles_per_gaussian=8,
            entry_capacity_factor=120.0, work_blocks_fwd=256,
            work_blocks_bwd=256, block_n=128, block_p=128, block_n_bwd=128,
            block_p_bwd=128, eig_floor=1e-12)
# bench.py's D = 3 flags (tile 0.2, per-axis radii, ellipsoid cull) with
# the default max_tiles_per_gaussian (4).
BENCH = dict(tile_size=0.2, axis_radii=True, ellip_cull=True,
             block_n=128, block_p=128, eig_floor=1e-12)
CASES = {
    1: (BASE, ORDERS, (0.03, 0.1)),
    2: (BASE, ORDERS, (0.03, 0.1)),
    3: (BASE, ("value", "derivative", "laplacian"), (0.03, 0.1)),
    "bench": (BENCH, ORDERS, (0.03, 0.1)),
    # Footprints wider than 4 tiles an axis: plan.rect exceeds the
    # config's max_tiles_per_gaussian (the op's slot bound).
    "wide": (dict(BENCH, tile_size=0.1), ("value", "derivative"),
             (0.08, 0.15)),
}
P, N, C = 200, 500, 3
SEEDS = {1: 1, 2: 2, 3: 3, "bench": 4, "wide": 5}


def _inputs(case):
    cfg_kw, orders, sigma_range = CASES[case]
    D = 3 if case in ("bench", "wide") else case
    rng = np.random.default_rng(SEEDS[case])
    means, values, covs, conics = make_gaussians(rng, P, D, C,
                                                 sigma_range=sigma_range)
    samples = rng.uniform(-1.0, 1.0, (N, D)).astype(np.float32)
    return D, cfg_kw, orders, (means, values, covs, conics, samples)


def _loss_weights(outs):
    """The JAX twin's quadratic loss: sum_o sum(o * o) / max(1, o.size)."""
    return [1.0 / max(1.0, float(np.prod(o.shape))) for o in outs]


@functools.lru_cache(maxsize=None)
def jax_ref(case):
    """dgs_tpu's plan, chunked outputs (full and padded) and gradients of
    the JAX twin's loss, computed once per module."""
    D, cfg_kw, orders, arrays = _inputs(case)
    m, v, cov, con, s = map(jnp.asarray, arrays)
    cfg, plan = jchunked.plan_chunked(JConfig(**cfg_kw).with_dims(D), m, cov,
                                      s)
    cs = jchunked.chunk_samples(cfg, s, plan, cfg.block_n)
    rad = (jradii_axis if cfg.axis_radii else jradii)(
        cov, D, cfg.radius_sigma, cfg.eig_floor)

    def run(m_, v_, c_, padded=False):
        return jchunked.sample_chunked_multi(
            orders, cfg, m_, v_, c_, rad, cs, plan, block_n=cfg.block_n,
            block_e=cfg.block_p, padded_outputs=padded)

    outs, diag = run(m, v, con)
    padded, _ = run(m, v, con, padded=True)
    w = _loss_weights(outs)

    def loss(m_, v_, c_):
        return sum(jnp.sum(o * o) * wk
                   for o, wk in zip(run(m_, v_, c_)[0], w))

    grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(m, v, con)
    padded_ss = sum(
        float(jnp.einsum("ucn,u->", o * o, jnp.asarray(
            tformulas.sym_multiplicity(order, D), jnp.float32)))
        for order, o in zip(orders, padded))
    return dict(cfg=cfg, plan=plan,
                outs=[np.asarray(o) for o in outs],
                diag={k: int(x) for k, x in diag.items() if k != "perm"},
                grads=[np.asarray(g) for g in grads], padded_ss=padded_ss)


def _port(case):
    """The port's planned config, plan, sample side, radii and tensors."""
    D, kw, orders, arrays = _inputs(case)
    m, v, cov, con, s = map(torch.from_numpy, arrays)
    cfg, plan = tchunked.plan_chunked(TConfig(**kw).with_dims(D),
                                      m, cov, s)
    cs = tchunked.chunk_samples(cfg, s, plan, cfg.block_n)
    rad = (tradii_axis if cfg.axis_radii else tradii)(
        cov, D, cfg.radius_sigma, cfg.eig_floor)
    return D, orders, cfg, plan, cs, rad, (m, v, cov, con, s)


def _port_outputs_and_grads(case, weights=None):
    D, orders, cfg, plan, cs, rad, (m, v, cov, con, s) = _port(case)
    params = [t.clone().requires_grad_() for t in (m, v, con)]
    outs, diag = tchunked.sample_chunked_multi(
        orders, cfg, *params, rad, cs, plan, block_n=cfg.block_n,
        block_e=cfg.block_p)
    w = weights or _loss_weights(outs)
    loss = sum((o * o).sum() * wk for o, wk in zip(outs, w))
    grads = torch.autograd.grad(loss, params)
    return ([o.detach() for o in outs], diag, list(grads), cfg, plan)


def _tiled_outputs_and_grads(case, cfg, plan, weights):
    """The port's tiled path over its own binning of the same Gaussians,
    with the plan's candidate cap and room for every entry (a config whose
    conics for the cull come from the covariances, as the tiled build's
    do: the inputs' conics are exact inverses of them)."""
    D, orders, _, _, _, _, (m, v, cov, con, s) = _port(case)
    tcfg = dataclasses.replace(cfg, max_tiles_per_gaussian=plan.rect,
                               entry_capacity_factor=plan.entries / P + 1.0)
    state = tgrid.build(tcfg, m, cov, s)
    assert int(state.overflow) == 0 and int(state.entry_overflow) == 0
    params = [t.clone().requires_grad_() for t in (m, v, con)]
    outs = tsampling.sample_tiled_multi(orders, tcfg, *params, s, state,
                                        unwrapped=cfg.unwrapped_kernels)
    loss = sum((o * o).sum() * wk for o, wk in zip(outs, weights))
    return ([o.detach() for o in outs],
            list(torch.autograd.grad(loss, params)))


def assert_out_close(got, ref, err_msg=""):
    """The JAX twin's output tolerance (test_sampling_chunked.py:83-86)."""
    ref = np.asarray(ref)
    np.testing.assert_allclose(
        np.asarray(got), ref, rtol=1e-4,
        atol=1e-5 * max(1.0, float(np.abs(ref).max(initial=0.0))),
        err_msg=err_msg)


def assert_grad_close(got, ref, err_msg=""):
    """The JAX twin's gradient tolerance (test_sampling_chunked.py:90-94)."""
    ref = np.asarray(ref)
    np.testing.assert_allclose(
        np.asarray(got), ref, rtol=2e-3,
        atol=1e-4 * max(1.0, float(np.abs(ref).max(initial=0.0))),
        err_msg=err_msg)


@pytest.mark.parametrize("case", [1, 2, 3, "bench"],
                         ids=["D1", "D2", "D3", "D3_bench_flags"])
def test_chunked_matches_dgs_tpu_and_tiled(case):
    """Outputs and the three gradients of the JAX twin's loss against
    dgs_tpu's sample_chunked_multi and against the port's tiled path."""
    ref = jax_ref(case)
    assert not any(ref["diag"].values()), ref["diag"]
    outs, diag, grads, cfg, plan = _port_outputs_and_grads(case)
    assert {k: int(x) for k, x in diag.items() if k != "perm"} == ref["diag"]
    assert diag["perm"] is None
    orders = CASES[case][1]
    for order, g, r in zip(orders, outs, ref["outs"]):
        assert g.shape == r.shape, order
        assert_out_close(g, r, f"{order} ({case})")
    for name, g, r in zip(PARAMS, grads, ref["grads"]):
        assert_grad_close(g, r, f"d{name} ({case})")
    touts, tgrads = _tiled_outputs_and_grads(case, cfg, plan,
                                             _loss_weights(outs))
    for order, g, r in zip(orders, outs, touts):
        assert_out_close(g, r, f"{order} vs tiled ({case})")
    for name, g, r in zip(PARAMS, grads, tgrads):
        assert_grad_close(g, r, f"d{name} vs tiled ({case})")


def chunk_counts(starts, block):
    """(T,) chunks of ``block`` rows per tile for tile-sorted rows with the
    range table ``starts`` ((T+2,))."""
    T = starts.shape[0] - 2
    n = (starts[1:T + 1] - starts[:T]).numpy().astype(np.int64)
    return -(-n // block)


def tpu_plan(cfg, plan, m, cov, s, headroom, block_n, block_e):
    """The port's plan as a dgs_tpu ChunkPlan tuple: (rect, entries) and
    the TPU layout's chunk and work counts at ``block_n`` / ``block_e``
    (e_chunks, s_chunks, work_fwd, work_bwd), counted on the port's own
    geometry build as dgs_tpu's plan_chunked counts them."""
    D = m.shape[1]
    rad = (tradii_axis if cfg.axis_radii else tradii)(
        cov, D, cfg.radius_sigma, cfg.eig_floor)
    conics = (tgrid.conics_from_cov(cov, D)
              if cfg.ellip_cull and D >= 2 else None)
    start = tgrid.duplicate_entries(cfg, m, rad, plan.rect,
                                    P * plan.rect ** D, conics=conics)[2]
    em = chunk_counts(start, block_e)
    sm = chunk_counts(tgrid.bin_samples(cfg, s).s_start, block_n)
    return (plan.rect, plan.entries, max(int(em.sum() * headroom), 1),
            max(int(sm.sum() * headroom), 1),
            max(int((sm * np.maximum(em, 1)).sum() * headroom), 1),
            max(int((em * np.maximum(sm, 1)).sum() * headroom), 1))


@pytest.mark.parametrize("headroom", [1.0, 1.5])
@pytest.mark.parametrize("case", [2, "bench", "wide"])
def test_plan_matches_dgs_tpu(case, headroom):
    """plan_chunked: (rect, entries), the wrap-free certificate and the four
    TPU layout counts equal dgs_tpu's plan at the same headroom."""
    D, cfg_kw, _, arrays = _inputs(case)
    m, v, cov, con, s = arrays
    jcfg, jplan = jchunked.plan_chunked(
        JConfig(**cfg_kw).with_dims(D), *map(jnp.asarray, (m, cov, s)),
        headroom=headroom)
    tm, tcov, ts = map(torch.from_numpy, (m, cov, s))
    tcfg, tplan = tchunked.plan_chunked(
        TConfig(**cfg_kw).with_dims(D), tm, tcov, ts, headroom=headroom)
    assert tplan._fields == jplan._fields[:2]
    assert tcfg.unwrapped_kernels == jcfg.unwrapped_kernels
    assert tcfg == TConfig(**{**cfg_kw,
                              "unwrapped_kernels": tcfg.unwrapped_kernels}
                           ).with_dims(D)
    assert tpu_plan(tcfg, tplan, tm, tcov, ts, headroom, jcfg.block_n,
                    jcfg.block_p) == tuple(jplan)
    assert tplan.entries % 128 == 0


def test_padded_outputs_invariant():
    """padded_outputs: the port's tile-sorted (n_unique, C, Np) rows with
    zero pad columns; their multiplicity-weighted sum of squares equals the
    sum of squares of the full outputs and dgs_tpu's over its own
    chunk-padded layout."""
    ref = jax_ref(2)
    D, orders, cfg, plan, cs, rad, (m, v, cov, con, s) = _port(2)
    kw = dict(block_n=cfg.block_n, block_e=cfg.block_p)
    full, _ = tchunked.sample_chunked_multi(orders, cfg, m, v, con, rad, cs,
                                            plan, **kw)
    padded, _ = tchunked.sample_chunked_multi(orders, cfg, m, v, con, rad,
                                              cs, plan, padded_outputs=True,
                                              **kw)
    want = sum(float((o * o).sum()) for o in full)
    got = 0.0
    for order, o in zip(orders, padded):
        nu = tformulas.n_unique(order, D)
        assert o.shape[:2] == (nu, C) and o.shape[2] % 32 == 0
        assert not bool(o[:, :, N:].any()), order
        mult = torch.tensor(tformulas.sym_multiplicity(order, D),
                            dtype=torch.float32)
        got += float(torch.einsum("ucn,u->", o * o, mult))
    assert got == pytest.approx(want, rel=1e-4)
    assert got == pytest.approx(ref["padded_ss"], rel=1e-4)
    # Sorted columns: padded column r is sample s_perm[r].
    perm = cs.binning.s_perm.long()
    np.testing.assert_array_equal(
        padded[0][0, :, :N].T.numpy(), full[0][perm].numpy())


def test_slot_bound_follows_the_plan():
    """The plan's R exceeds the config's max_tiles_per_gaussian; the
    backward's slot bound is the plan's R^D, so the gradients run and match
    the tiled path binned with R = plan.rect."""
    outs, diag, grads, cfg, plan = _port_outputs_and_grads("wide")
    assert plan.rect > TConfig().max_tiles_per_gaussian
    assert cfg.max_tiles_per_gaussian == TConfig().max_tiles_per_gaussian
    assert not any(int(x) for k, x in diag.items() if k != "perm")
    touts, tgrads = _tiled_outputs_and_grads("wide", cfg, plan,
                                             _loss_weights(outs))
    for g, r in zip(outs, touts):
        assert_out_close(g, r)
    for name, g, r in zip(PARAMS, grads, tgrads):
        assert_grad_close(g, r, f"d{name}")


def test_gradients_are_bitwise_repeatable():
    """Two runs of the chunked backward give bitwise-equal gradients (the
    gid segment-sum has a fixed order and no atomics)."""
    _, _, first, _, _ = _port_outputs_and_grads("bench")
    _, _, again, _, _ = _port_outputs_and_grads("bench")
    for a, b in zip(first, again):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_drift_past_the_plan_is_reported():
    """Wider footprints than planned (covariances and conics of twice the
    width): entries past plan.entries and rects past plan.rect come back in
    the diagnostics (never masked), as sample_chunked derives the radii
    from the covariances on every call."""
    D, orders, cfg, plan, cs, _, (m, v, cov, con, s) = _port("bench")
    outs, diag = tchunked.sample_chunked(cfg, m, v, con / 4.0, 4.0 * cov, s,
                                         plan, cs, orders)
    assert int(diag["entry_overflow"]) > 0
    assert int(diag["bin_overflow"]) > 0
    assert int(diag["work_overflow_fwd"]) == int(diag["work_overflow_bwd"]) \
        == 0
    assert set(outs) == set(orders)
