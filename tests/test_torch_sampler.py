"""The port's GaussianSampler facade and PIGS evaluation end to end against
dgs_tpu's, and the facade's named errors."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgs_tpu.config import SamplerConfig as JConfig
from dgs_tpu.models import pigs as jpigs
from dgs_tpu.models.field import init_field as jinit
from dgs_tpu.sampler import GaussianSampler as JSampler
from dgs_tpu_torch.config import SamplerConfig as TConfig
from dgs_tpu_torch.kernels import tiled as ttiled
from dgs_tpu_torch.models import pigs as tpigs
from dgs_tpu_torch.models.field import GaussianField
from dgs_tpu_torch.sampler import GaussianSampler as TSampler

from conftest import make_gaussians, make_samples

torch.set_num_threads(2)

ORDERS = ("value", "derivative", "laplacian", "third")


def assert_close(got, ref, err_msg=""):
    ref = np.asarray(ref)
    np.testing.assert_allclose(
        np.asarray(got), ref, rtol=2e-4,
        atol=1e-5 * max(1.0, float(np.abs(ref).max(initial=0.0))),
        err_msg=err_msg)


def _data(rng, P=300, N=2000, D=2, C=4, **kw):
    m, v, cov, c = make_gaussians(rng, P, D, C, **kw)
    s = make_samples(rng, N, D)
    return (m, v, cov, c, s)


def test_facade_matches_jax_facade(rng):
    arrays = _data(rng, sigma_range=(0.02, 0.1))
    kw = dict(tile_size=0.1275, max_tiles_per_gaussian=8,
              entry_capacity_factor=40.0)
    js = JSampler(debug=True, config=JConfig(**kw))
    js.preprocess(*map(jnp.asarray, arrays))
    ts = TSampler(debug=True, config=TConfig(**kw))
    ts.preprocess(*map(torch.from_numpy, arrays))
    np.testing.assert_allclose(ts.radii.numpy(), np.asarray(js.radii),
                               rtol=1e-6)
    np.testing.assert_array_equal(ts.state.ent_gid.numpy(),
                                  np.asarray(js.state.ent_gid))
    singles = [
        (js.sample_gaussians, ts.sample_gaussians),
        (js.sample_gaussians_derivative, ts.sample_gaussians_derivative),
        (js.sample_gaussians_laplacian, ts.sample_gaussians_laplacian),
        (js.sample_gaussians_third_derivative,
         ts.sample_gaussians_third_derivative),
    ]
    for order, (jfn, tfn) in zip(ORDERS, singles):
        ref, got = jfn(), tfn()
        assert got.shape == ref.shape, order
        assert_close(got, ref, order)
    ref = js.sample_all(("value", "derivative", "laplacian"))
    got = ts.sample_all(("value", "derivative", "laplacian"))
    assert list(got) == list(ref)
    for order in ref:
        assert_close(got[order], ref[order], order)


def test_facade_unwrapped_config_matches(rng):
    arrays = _data(rng, P=200, N=600, sigma_range=(0.02, 0.06))
    kw = dict(tile_size=0.2, max_tiles_per_gaussian=6,
              entry_capacity_factor=10.0, unwrapped_kernels=True)
    js = JSampler(config=JConfig(**kw))
    js.preprocess(*map(jnp.asarray, arrays))
    ts = TSampler(config=TConfig(**kw))
    ts.preprocess(*map(torch.from_numpy, arrays))
    ref, got = js.sample_all(), ts.sample_all()
    for order in ORDERS:
        assert_close(got[order], ref[order], order)


@pytest.mark.parametrize("name,index,shape", [
    ("values", 1, (300,)),
    ("covariances", 2, (300, 2)),
    ("conics", 3, (299, 3)),
    ("samples", 4, (10, 3)),
])
def test_named_shape_errors(rng, name, index, shape):
    arrays = [torch.from_numpy(a) for a in _data(rng, N=50)]
    arrays[index] = torch.zeros(shape)
    with pytest.raises(ValueError, match=f"^{name} has shape"):
        TSampler().preprocess(*arrays)


def test_debug_errors(rng):
    arrays = [torch.from_numpy(a) for a in _data(rng, N=50)]
    bad = [a.clone() for a in arrays]
    bad[0][3, 1] = float("nan")
    with pytest.raises(FloatingPointError, match="means"):
        TSampler(debug=True).preprocess(*bad)
    # footprints beyond the per-axis duplicate cap
    wide = [torch.from_numpy(a) for a in _data(rng, N=50,
                                                sigma_range=(0.5, 0.8))]
    with pytest.raises(ValueError, match="binning overflow"):
        TSampler(debug=True, config=TConfig(max_tiles_per_gaussian=1)
                 ).preprocess(*wide)
    # entries beyond the entry capacity
    with pytest.raises(ValueError, match="binning entry overflow"):
        TSampler(debug=True, config=TConfig(max_tiles_per_gaussian=4,
                                            entry_capacity_factor=0.1)
                 ).preprocess(*wide)
    # without debug the same data runs (the counters report the overflow)
    s = TSampler(config=TConfig(max_tiles_per_gaussian=1))
    s.preprocess(*wide)
    assert int(s.state.overflow) > 0


def test_unported_paths_raise(rng, monkeypatch):
    """The chunked method is ported (the facade constructs it) and runs
    dgs_tpu's folded forward under folded_values (the kernel it names, with
    the values of the classic facade at the kernel tolerance); what the
    port does not run raises on it: dgs_tpu's kernel-ablation hook."""
    assert TSampler(method="chunked").method == "chunked"
    arrays = [torch.from_numpy(a) for a in _data(rng, P=30, N=60, D=3)]
    calls = []
    real = ttiled.tiled_forward_folded
    monkeypatch.setattr(ttiled, "tiled_forward_folded",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    outs = {}
    for folded in (False, True):
        s = TSampler(method="chunked",
                     config=TConfig(tile_size=0.25, folded_values=folded))
        s.preprocess(*arrays)
        outs[folded] = s.sample_gaussians()
    assert calls == [1]
    ref = outs[False].numpy()
    np.testing.assert_allclose(outs[True].numpy(), ref, rtol=2e-4,
                               atol=1e-5 * max(1.0, float(abs(ref).max())))
    monkeypatch.setenv("DGS_ABLATE", "fdots")
    with pytest.raises(NotImplementedError, match="DGS_ABLATE"):
        s.sample_gaussians()


def _chunked_pair(arrays, kw, debug=False, requires_grad=False):
    """dgs_tpu's and the port's GaussianSampler(method="chunked"), both
    preprocessed on the same arrays; the port's (means, values, conics)
    leaves."""
    m, v, cov, c, s = arrays
    js = JSampler(debug=debug, method="chunked", config=JConfig(**kw))
    js.preprocess(*map(jnp.asarray, arrays))
    leaves = [torch.from_numpy(a).requires_grad_(requires_grad)
              for a in (m, v, c)]
    ts = TSampler(debug=debug, method="chunked", config=TConfig(**kw))
    ts.preprocess(leaves[0], leaves[1], torch.from_numpy(cov), leaves[2],
                  torch.from_numpy(s))
    return js, ts, leaves


CHUNKED_KW = dict(tile_size=0.2, axis_radii=True, ellip_cull=True,
                  eig_floor=1e-12, block_n=128, block_p=128)


def test_chunked_facade_matches_jax_facade(rng):
    """GaussianSampler(method="chunked") at bench.py's D = 3 flags: the
    planned config, the four sample_gaussians* and sample_all against
    dgs_tpu's facade, outputs and gradients w.r.t. the means, values and
    conics handed to preprocess."""
    arrays = _data(rng, P=60, N=200, D=3, C=2, sigma_range=(0.03, 0.1))
    js, ts, leaves = _chunked_pair(arrays, CHUNKED_KW, debug=True,
                                   requires_grad=True)
    assert ts.config.unwrapped_kernels == js.config.unwrapped_kernels
    assert ts.state is None and js.state is None
    np.testing.assert_allclose(ts.radii.detach().numpy(),
                               np.asarray(js.radii), rtol=1e-6)
    calls = ("sample_gaussians", "sample_gaussians_derivative",
             "sample_gaussians_laplacian",
             "sample_gaussians_third_derivative", "sample_all")

    def run(sampler, call):
        out = getattr(sampler, call)()
        return list(out.values()) if isinstance(out, dict) else [out]

    concrete = tuple(map(jnp.asarray, (arrays[0], arrays[1], arrays[3])))

    def jloss(jm, jv, jc, call):
        js.means, js.values, js.conics = jm, jv, jc
        return sum(jnp.sum(o * o) for o in run(js, call))

    for call in calls:
        js.means, js.values, js.conics = concrete
        for g, r in zip(run(ts, call), run(js, call)):
            assert g.shape == r.shape, call
            assert_close(g.detach(), r, call)
        js.debug = False      # the JAX debug check reads concrete values
        ref = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)), static_argnums=3)(
            *concrete, call)
        js.debug = True
        got = torch.autograd.grad(sum((o * o).sum() for o in run(ts, call)),
                                  leaves)
        for g, r, name in zip(got, ref, ("means", "values", "conics")):
            assert_grad_close(g, r, f"chunked {call} dL/d{name}")


def test_chunked_facade_debug_raises_on_drift(rng):
    """Parameters that drift past the plan after preprocess (footprints
    twice as wide: covariances x4, conics / 4, assigned to the sampler)
    raise the named overflow ValueError in debug mode in both packages;
    without debug the port runs and reports nothing."""
    arrays = _data(rng, P=60, N=200, D=3, C=2, sigma_range=(0.03, 0.1))
    js, ts, _ = _chunked_pair(arrays, CHUNKED_KW, debug=True)
    ts.sample_all()
    js.covariances, js.conics = 4.0 * js.covariances, js.conics / 4.0
    ts.covariances, ts.conics = 4.0 * ts.covariances, ts.conics / 4.0
    for sampler in (js, ts):
        with pytest.raises(ValueError,
                           match="chunked sampling overflow.*re-run "
                                 "preprocess") as err:
            sampler.sample_gaussians()
        assert "entry_overflow" in str(err.value)
    ts.debug = False
    assert ts.sample_gaussians().shape == (200, 2)


def test_chunked_preprocess_again_rechecks_the_wrap(rng):
    """preprocess run again after the footprints outgrew period / 2 - tile
    plans from the config the sampler was given, not from the first plan's
    wrap-free one: the certificate drops, and the outputs equal those of a
    sampler preprocessed on the wide arrays alone and the wrapped tiled
    facade's."""
    m, v, cov, c, s = _data(rng, P=40, N=300, D=2, C=2,
                            sigma_range=(0.03, 0.05))
    cfg = TConfig(tile_size=0.2, eig_floor=1e-12)
    ts = TSampler(method="chunked", config=cfg)
    ts.preprocess(*map(torch.from_numpy, (m, v, cov, c, s)))
    assert ts.config.unwrapped_kernels
    wide = tuple(map(torch.from_numpy, (m, v, 64.0 * cov, c / 64.0, s)))
    ts.preprocess(*wide)
    assert not ts.config.unwrapped_kernels
    fresh = TSampler(method="chunked", config=cfg)
    fresh.preprocess(*wide)
    tiled = TSampler(config=dataclasses.replace(
        cfg, max_tiles_per_gaussian=ts._chunk_plan.rect,
        entry_capacity_factor=ts._chunk_plan.entries / 40 + 1.0))
    tiled.preprocess(*wide)
    got, again, ref = ts.sample_all(), fresh.sample_all(), tiled.sample_all()
    for o in ORDERS:
        assert torch.equal(got[o], again[o]), o
        assert_close(got[o], ref[o], o)


@pytest.mark.parametrize("method", ["brute", "dense"])
def test_unnamed_methods_run_the_all_pairs_path(rng, method):
    """A method string the facade does not name runs the plain all-pairs
    path in both packages (dgs_tpu/sampler.py dispatches every method but
    "tiled" and "chunked" there), with the same outputs."""
    arrays = _data(rng, P=40, N=300, sigma_range=(0.05, 0.2))
    js = JSampler(config=JConfig(), method=method)
    js.preprocess(*map(jnp.asarray, arrays))
    ts = TSampler(config=TConfig(), method=method)
    ts.preprocess(*map(torch.from_numpy, arrays))
    ref, got = js.sample_all(ORDERS), ts.sample_all(ORDERS)
    for order in ORDERS:
        assert_close(got[order], ref[order], order)
    assert_close(ts.sample_gaussians(), js.sample_gaussians(), "value")


def assert_grad_close(got, ref, err_msg=""):
    """The JAX suite's gradient tolerance (test_binning_tiled.py:155)."""
    ref = np.asarray(ref)
    np.testing.assert_allclose(
        np.asarray(got), ref, rtol=2e-3,
        atol=1e-5 * max(1.0, float(np.abs(ref).max(initial=0.0))),
        err_msg=err_msg)


def test_facade_grads_match_jax_facade(rng):
    """Gradients through the four sample_gaussians* and sample_all w.r.t.
    the means, values and conics handed to preprocess, against jax.grad
    through dgs_tpu's facade."""
    m, v, cov, c, s = _data(rng, P=40, N=150, C=2, sigma_range=(0.05, 0.2))
    kw = dict(tile_size=0.25, max_tiles_per_gaussian=8,
              entry_capacity_factor=40.0)
    tm, tv, tc = (torch.from_numpy(a).requires_grad_() for a in (m, v, c))
    calls = ("sample_gaussians", "sample_gaussians_derivative",
             "sample_gaussians_laplacian",
             "sample_gaussians_third_derivative", "sample_all")

    def run(sampler, call):
        out = getattr(sampler, call)()
        return list(out.values()) if isinstance(out, dict) else [out]

    js = JSampler(config=JConfig(**kw))
    js.preprocess(*map(jnp.asarray, (m, v, cov, c, s)))

    def jloss(jm, jv, jc, call):
        # The binning stays the eager preprocess's; only the sampling call
        # is differentiated, as the port's autograd sees it.
        js.means, js.values, js.conics = jm, jv, jc
        return sum(jnp.sum(o * o) for o in run(js, call))

    ts = TSampler(config=TConfig(**kw))
    ts.preprocess(tm, tv, torch.from_numpy(cov), tc, torch.from_numpy(s))
    for call in calls:
        ref = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)), static_argnums=3)(
            *map(jnp.asarray, (m, v, c)), call)
        got = torch.autograd.grad(sum((o * o).sum() for o in run(ts, call)),
                                  (tm, tv, tc))
        for g, r, name in zip(got, ref, ("means", "values", "conics")):
            assert_grad_close(g, r, f"{call} dL/d{name}")


def test_field_outputs_matches_jax(rng):
    """PIGS field evaluation, and its gradients to every field parameter
    (through the conic chain to log_scales and rotations)."""
    jf = jinit(jax.random.PRNGKey(3), 120, 2, 4, sigma=0.05)
    tf = GaussianField.from_numpy(*[np.asarray(a) for a in jf], device="cpu")
    x = make_samples(rng, 400, 2)
    kw = dict(tile_size=0.25, max_tiles_per_gaussian=6)
    ref, jdiag = jpigs.field_outputs(JConfig(**kw), jf, jnp.asarray(x))
    got, tdiag = tpigs.field_outputs(TConfig(**kw), tf, torch.from_numpy(x))
    assert set(tdiag) >= set(jdiag)
    for order in ref:
        assert_close(got[order].detach(), ref[order], order)

    def jloss(field):
        outs, _ = jpigs.field_outputs(JConfig(**kw), field, jnp.asarray(x))
        return sum(jnp.sum(o * o) for o in outs.values())

    jgrads = jax.jit(jax.grad(jloss))(jf)
    sum((o * o).sum() for o in got.values()).backward()
    for name in ("means", "log_scales", "rotations", "values"):
        assert_grad_close(getattr(tf, name).grad, getattr(jgrads, name),
                          f"dL/d{name}")
    # The all-pairs methods: reference shapes in sample order, no perm,
    # zero diagnostics.
    for method in ("pallas", "dense"):
        ref, jdiag = jpigs.field_outputs(JConfig(**kw), jf, jnp.asarray(x),
                                         method=method)
        got, tdiag = tpigs.field_outputs(TConfig(**kw), tf,
                                         torch.from_numpy(x), method=method)
        assert set(tdiag) >= set(jdiag) and tdiag["perm"] is None
        assert all(int(tdiag[k]) == 0 for k in tpigs.DIAGNOSTICS)
        for order in ref:
            assert_close(got[order].detach(), ref[order],
                         f"{method} {order}")


@pytest.mark.parametrize("method", ["pallas", "dense"])
def test_facade_dense_methods_match_jax_facade(rng, method):
    """GaussianSampler(method="pallas" / "dense"): no binning state, scalar
    radii, the four sample_gaussians* and sample_all against dgs_tpu's
    facade, outputs and gradients."""
    m, v, cov, c, s = _data(rng, P=40, N=150, C=2, sigma_range=(0.05, 0.2))
    js = JSampler(method=method, config=JConfig())
    js.preprocess(*map(jnp.asarray, (m, v, cov, c, s)))
    tm, tv, tc = (torch.from_numpy(a).requires_grad_() for a in (m, v, c))
    ts = TSampler(method=method, config=TConfig())
    ts.preprocess(tm, tv, torch.from_numpy(cov), tc, torch.from_numpy(s))
    assert ts.state is None and js.state is None
    np.testing.assert_allclose(ts.radii.numpy(), np.asarray(js.radii),
                               rtol=1e-6)
    calls = ("sample_gaussians", "sample_gaussians_derivative",
             "sample_gaussians_laplacian",
             "sample_gaussians_third_derivative", "sample_all")

    def run(sampler, call):
        out = getattr(sampler, call)()
        return list(out.values()) if isinstance(out, dict) else [out]

    concrete = tuple(map(jnp.asarray, (m, v, c)))

    def jloss(jm, jv, jc, call):
        js.means, js.values, js.conics = jm, jv, jc
        return sum(jnp.sum(o * o) for o in run(js, call))

    for call in calls:
        js.means, js.values, js.conics = concrete
        for g, r in zip(run(ts, call), run(js, call)):
            assert g.shape == r.shape, call
            assert_close(g.detach(), r, call)
        ref = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)), static_argnums=3)(
            *concrete, call)
        got = torch.autograd.grad(sum((o * o).sum() for o in run(ts, call)),
                                  (tm, tv, tc))
        for g, r, name in zip(got, ref, ("means", "values", "conics")):
            assert_grad_close(g, r, f"{method} {call} dL/d{name}")


def test_facade_dense_method_matches_tiled_masked(rng):
    """Twin of test_sampler_api.py's case: wide Gaussians cover every tile,
    so the tiled facade equals the all-pairs one."""
    m, v, cov, c = make_gaussians(rng, 15, 2, 2, sigma_range=(0.8, 1.1))
    s = make_samples(rng, 25, 2)
    arrays = [torch.from_numpy(a) for a in (m, v, cov, c, s)]
    tiled = TSampler(method="tiled")
    tiled.preprocess(*arrays)
    for method in ("dense", "pallas"):
        dense = TSampler(method=method)
        dense.preprocess(*arrays)
        np.testing.assert_allclose(tiled.sample_gaussians(),
                                   dense.sample_gaussians(), rtol=2e-4,
                                   atol=1e-5)
