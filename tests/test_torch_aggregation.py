"""dgs_tpu_torch.ops.aggregation's table path (preprocess, preprocess_grid,
aggregate, the capacity planners) and the facade / module-level aggregation
API against dgs_tpu's, on the same seeded numpy inputs.  Twin of
tests/test_aggregation.py; the kernel path is in
tests/test_torch_aggregation_pallas.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dgs_tpu
import dgs_tpu_torch
from dgs_tpu.config import SamplerConfig as JConfig
from dgs_tpu.oracle import dense as joracle
from dgs_tpu.ops import aggregation as jagg
from dgs_tpu.sampler import GaussianSampler as JSampler
from dgs_tpu.utils import native as jnative
from dgs_tpu_torch.config import SamplerConfig as TConfig
from dgs_tpu_torch.ops import aggregation as tagg
from dgs_tpu_torch.sampler import GaussianSampler as TSampler
from dgs_tpu_torch.utils import native as tnative

from conftest import make_gaussians

torch.set_num_threads(2)

GROUPS = ("features", "transform", "queries", "keys", "frequencies",
          "distance_transform")


def make_inputs(rng, P, D, L=4, K=3, nfreq=2, sigma_range=(0.1, 0.35)):
    """(means, covs, conics, radii, params): seeded numpy inputs, the radii
    from dgs_tpu's oracle (eig_floor 1e-6, the config default)."""
    means, _, covs, conics = make_gaussians(rng, P, D, 1,
                                            sigma_range=sigma_range)
    radii = np.array(joracle.radii(jnp.asarray(covs), D))
    E = 2 * D * nfreq + 1
    params = dict(
        features=rng.normal(size=(P, L)), transform=rng.normal(size=(L, L)),
        queries=rng.normal(size=(P, K)), keys=rng.normal(size=(P, K)),
        frequencies=rng.uniform(0.5, 3.0, (nfreq,)),
        distance_transform=rng.normal(size=(2 * E,)))
    return means, covs, conics, radii, {
        k: v.astype(np.float32) for k, v in params.items()}


def jnp_all(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def torch_all(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


def assert_tables_equal(got, ref, *, rtol=1e-5):
    """A port Neighbors against a dgs_tpu Neighbors: indices (and the grid
    variant's integer arrays) exactly, floats within rtol (the two
    frameworks' exp and sum order), atol for the zero slots."""
    np.testing.assert_array_equal(got.indices.numpy(),
                                  np.asarray(ref.indices))
    assert int(got.overflow) == int(ref.overflow)
    for name in ("dists", "densities", "inv_total_densities"):
        np.testing.assert_allclose(
            getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
            rtol=rtol, atol=1e-6, err_msg=name)
    for name in ("ent_gid", "ent_start", "tile_of_center"):
        if getattr(ref, name) is None:
            assert getattr(got, name) is None
        else:
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          np.asarray(getattr(ref, name)))


def outputs_and_grads(kind, fn, params):
    """(out, {group: gradient}) of sum(out cos(out)), the JAX suite's
    aggregation loss, through fn(*the six groups) in JAX or torch."""
    if kind == "jax":
        def loss(p):
            out = fn(*[p[k] for k in GROUPS])
            return jnp.sum(out * jnp.cos(out)), out

        (_, out), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            {k: jnp.asarray(v) for k, v in params.items()})
        return np.asarray(out), {k: np.asarray(grads[k]) for k in GROUPS}
    leaves = [torch.from_numpy(params[k].copy()).requires_grad_()
              for k in GROUPS]
    out = fn(*leaves)
    grads = torch.autograd.grad((out * torch.cos(out)).sum(), leaves)
    return out.detach().numpy(), {k: g.numpy() for k, g in zip(GROUPS, grads)}


def assert_out_close(got, ref, err_msg=""):
    """The JAX suite's output tolerance (test_aggregation_pallas.py:86)."""
    np.testing.assert_allclose(
        got, ref, rtol=2e-4, atol=1e-5 * max(1.0, float(np.abs(ref).max())),
        err_msg=err_msg)


def assert_grads_close(got, ref, err_msg=""):
    """Its gradient tolerance (test_aggregation_pallas.py:89-94)."""
    for k in GROUPS:
        np.testing.assert_allclose(
            got[k], ref[k], rtol=2e-3,
            atol=1e-4 * max(1.0, float(np.abs(ref[k]).max())),
            err_msg=f"dL/d{k} {err_msg}")


@pytest.mark.parametrize("D", [1, 2, 3])
def test_preprocess_matches(rng, monkeypatch, D):
    means, _, conics, radii, _ = make_inputs(rng, 37, D)
    radii[::9] = 0.0                               # culled Gaussians
    for NC in (48, 1):                             # untruncated, truncated
        ref = jagg.preprocess(JConfig().with_dims(D),
                              *jnp_all(means, conics, radii), NC)
        got = tagg.preprocess(TConfig().with_dims(D),
                              *torch_all(means, conics, radii), NC)
        assert_tables_equal(got, ref)
    assert int(ref.overflow) > 0
    # The scan in several row chunks gives the same table.
    monkeypatch.setattr(tagg, "_SCAN_ROWS", 5)
    again = tagg.preprocess(TConfig().with_dims(D),
                            *torch_all(means, conics, radii), 1)
    for a, b in zip(again[:5], got[:5]):
        assert torch.equal(a, b)


def test_preprocess_open_domain_matches(rng):
    means, _, conics, radii, _ = make_inputs(rng, 41, 2)
    kw = dict(period=None, lower=(-1.0, -1.0), upper_bounds=(1.0, 1.0))
    ref = jagg.preprocess(JConfig(**kw), *jnp_all(means, conics, radii), 41)
    got = tagg.preprocess(TConfig(**kw), *torch_all(means, conics, radii), 41)
    assert_tables_equal(got, ref)


@pytest.mark.parametrize("D", [1, 2, 3])
def test_capacity_planners_match(rng, D):
    """suggest_capacity, the native max_collisions and
    suggest_grid_capacities, with and without the auto-tile."""
    means, _, _, radii, _ = make_inputs(rng, 60, D, sigma_range=(0.05, 0.2))
    radii[::11] = 0.0
    jcfg, tcfg = JConfig().with_dims(D), TConfig().with_dims(D)
    want = jagg.suggest_capacity(jcfg, *jnp_all(means, radii))
    assert tagg.suggest_capacity(tcfg, *torch_all(means, radii)) == want
    assert tnative.max_collisions(tcfg, means, radii) == want
    assert tnative.max_collisions(tcfg, *torch_all(means, radii)) == \
        jnative.max_collisions(jcfg, means, radii)
    for auto_tile in (True, False):
        jc, jnc, jrect = jagg.suggest_grid_capacities(
            jcfg, *jnp_all(means, radii), auto_tile=auto_tile)
        tc, tnc, trect = tagg.suggest_grid_capacities(
            tcfg, *torch_all(means, radii), auto_tile=auto_tile)
        assert (tc.tile_size, tnc, trect) == (jc.tile_size, jnc, jrect)
        assert tc.grid_shape() == jc.grid_shape()


@pytest.mark.parametrize("D", [1, 2, 3])
def test_preprocess_grid_matches(rng, D):
    means, _, conics, radii, _ = make_inputs(rng, 37, D)
    radii[::9] = 0.0
    kw = dict(max_tiles_per_gaussian=8)
    ref = jagg.preprocess_grid(JConfig(**kw).with_dims(D),
                               *jnp_all(means, conics, radii), 64, 8)
    got = tagg.preprocess_grid(TConfig(**kw).with_dims(D),
                               *torch_all(means, conics, radii), 64, 8)
    assert int(ref.overflow) == 0
    assert_tables_equal(got, ref)
    # Planned capacities, and a table too narrow for its tiles.
    jc, nc, rect = jagg.suggest_grid_capacities(
        JConfig().with_dims(D), *jnp_all(means, radii))
    tc, _, _ = tagg.suggest_grid_capacities(
        TConfig().with_dims(D), *torch_all(means, radii))
    for cap in (nc, 2):
        ref = jagg.preprocess_grid(jc, *jnp_all(means, conics, radii), cap,
                                   rect)
        got = tagg.preprocess_grid(tc, *torch_all(means, conics, radii), cap,
                                   rect)
        assert_tables_equal(got, ref)
    assert int(ref.overflow) > 0


@pytest.mark.parametrize("table", ["dense", "grid"])
@pytest.mark.parametrize("D", [1, 2, 3])
def test_aggregate_matches(rng, D, table):
    """aggregate over each table form: outputs and the six gradients
    (autograd) against jax.grad."""
    P = 29
    means, _, conics, radii, params = make_inputs(rng, P, D)
    if table == "dense":
        jn = jagg.preprocess(JConfig().with_dims(D),
                             *jnp_all(means, conics, radii), P)
        tn = tagg.preprocess(TConfig().with_dims(D),
                             *torch_all(means, conics, radii), P)
    else:
        kw = dict(max_tiles_per_gaussian=8)
        jn = jagg.preprocess_grid(JConfig(**kw).with_dims(D),
                                  *jnp_all(means, conics, radii), 64, 8)
        tn = tagg.preprocess_grid(TConfig(**kw).with_dims(D),
                                  *torch_all(means, conics, radii), 64, 8)
    assert int(tn.overflow) == 0
    ref, g_ref = outputs_and_grads(
        "jax", lambda *a: jagg.aggregate(*a, jn), params)
    got, g_got = outputs_and_grads(
        "torch", lambda *a: tagg.aggregate(*a, tn), params)
    assert_out_close(got, ref, f"D={D} {table}")
    assert_grads_close(g_got, g_ref, f"D={D} {table}")
    # A dgs_tpu table carried across gives the same outputs.
    carried = tagg.Neighbors.from_numpy(
        *[None if a is None else np.asarray(a) for a in jn], device="cpu")
    assert_tables_equal(carried, jn, rtol=0)
    out = tagg.aggregate(*torch_all(*[params[k] for k in GROUPS]), carried)
    assert_out_close(out.numpy(), ref, f"carried D={D} {table}")


def test_aggregate_longer_frequencies_and_code(rng):
    """A frequencies vector longer than nfreq and a distance transform with
    entries no (dim, rung) term reads: the extra entries get zero
    gradients, as in dgs_tpu."""
    P, D = 23, 2
    means, _, conics, radii, params = make_inputs(rng, P, D)
    params["frequencies"] = rng.uniform(0.5, 3.0, (5,)).astype(np.float32)
    params["distance_transform"] = rng.normal(size=(2 * 10,)).astype(
        np.float32)                                # E = 10: (E-1)//D//2 = 2
    jn = jagg.preprocess(JConfig(), *jnp_all(means, conics, radii), P)
    tn = tagg.preprocess(TConfig(), *torch_all(means, conics, radii), P)
    ref, g_ref = outputs_and_grads(
        "jax", lambda *a: jagg.aggregate(*a, jn), params)
    got, g_got = outputs_and_grads(
        "torch", lambda *a: tagg.aggregate(*a, tn), params)
    assert_out_close(got, ref)
    assert_grads_close(g_got, g_ref)
    assert not g_got["frequencies"][2:].any()


@pytest.mark.parametrize("method", ["pallas", "grid", "dense"])
def test_facade_aggregation_matches_jax_facade(rng, method):
    """GaussianSampler.preprocess_aggregate / aggregate_neighbors for the
    three methods: the structure's overflow, outputs and gradients."""
    P, D = 60, 2
    means, covs, conics, _, params = make_inputs(rng, P, D,
                                           sigma_range=(0.05, 0.25))
    values = params["features"]
    x = rng.uniform(-1, 1, (16, D)).astype(np.float32)
    js = JSampler(debug=True, config=JConfig())
    js.preprocess(*jnp_all(means, values, covs, conics, x))
    ts = TSampler(debug=True, config=TConfig())
    ts.preprocess(*torch_all(means, values, covs, conics, x))
    jn = js.preprocess_aggregate(method=method)
    tn = ts.preprocess_aggregate(method=method)
    assert int(tn.overflow) == int(jn.overflow) == 0
    if method == "pallas":
        assert isinstance(tn, tagg.AggBinning)
    else:
        assert_tables_equal(tn, jn)
    ref, g_ref = outputs_and_grads("jax", js.aggregate_neighbors, params)
    got, g_got = outputs_and_grads("torch", ts.aggregate_neighbors, params)
    assert_out_close(got, ref, method)
    assert_grads_close(g_got, g_ref, method)


def test_facade_debug_overflow_raises(rng):
    means, covs, conics, _, params = make_inputs(rng, 40, 2)
    x = rng.uniform(-1, 1, (8, 2)).astype(np.float32)
    ts = TSampler(debug=True)
    ts.preprocess(*torch_all(means, params["features"], covs, conics, x))
    with pytest.raises(ValueError, match="neighbor table overflow"):
        ts.preprocess_aggregate(neighbor_capacity=2, method="dense")
    with pytest.raises(ValueError, match="neighbor table overflow"):
        ts.preprocess_aggregate(neighbor_capacity=2, rect_capacity=4)
    with pytest.raises(ValueError, match="unknown preprocess_aggregate"):
        ts.preprocess_aggregate(method="chunked")
    # Without debug the same call runs and the counter reports it.
    ts.debug = False
    assert int(ts.preprocess_aggregate(neighbor_capacity=2,
                                       method="dense").overflow) > 0


@pytest.mark.parametrize("method", ["pallas", "grid", "dense"])
def test_module_level_aggregation_matches(rng, method):
    P, D = 45, 2
    means, _, conics, radii, params = make_inputs(rng, P, D,
                                            sigma_range=(0.05, 0.25))
    kw = {} if method == "pallas" else {"neighbor_capacity": 64}
    jn = dgs_tpu.preprocess_aggregate(
        JConfig(max_tiles_per_gaussian=8), *jnp_all(means, conics, radii),
        method=method, **kw)
    tn = dgs_tpu_torch.preprocess_aggregate(
        TConfig(max_tiles_per_gaussian=8), *torch_all(means, conics, radii),
        method=method, **kw)
    assert int(tn.overflow) == int(jn.overflow) == 0
    ref = dgs_tpu.aggregate_neighbors(
        *jnp_all(*[params[k] for k in GROUPS]), jn)
    got = dgs_tpu_torch.aggregate_neighbors(
        *torch_all(*[params[k] for k in GROUPS]), tn)
    assert_out_close(got.numpy(), np.asarray(ref), method)
    with pytest.raises(ValueError, match="unknown preprocess_aggregate"):
        dgs_tpu_torch.preprocess_aggregate(
            TConfig(), *torch_all(means, conics, radii), method="chunked")
