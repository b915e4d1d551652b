"""dgs_tpu_torch.models.dynamics against dgs_tpu.models.dynamics: the
rollout step over both neighbour structures, the rollout loss and its
gradients from parameters carried across as numpy arrays, the value
evaluators, and a few steps of the trainer on the CPU.  Twin of the
non-slow part of tests/test_dynamics.py (dgs_tpu's Pallas kernels run in
interpret mode)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgs_tpu.config import SamplerConfig as JConfig
from dgs_tpu.models import dynamics as jdyn
from dgs_tpu.models.field import init_field as jinit
from dgs_tpu.oracle.dense import radii as jradii
from dgs_tpu.ops import aggregation as jagg
from dgs_tpu_torch.config import SamplerConfig as TConfig
from dgs_tpu_torch.models import dynamics as tdyn
from dgs_tpu_torch.models.field import GaussianField
from dgs_tpu_torch.oracle.dense import radii as tradii
from dgs_tpu_torch.ops import aggregation as tagg

torch.set_num_threads(2)

PARAMS = ("transform", "queries", "keys", "frequencies",
          "distance_transform")


def carried(P, D, ladder, sigma=0.15, seed=0):
    """A dgs_tpu field and dynamics parameters and their port twins, the
    parameters made a little larger than the initial ones so that every
    gradient is well above rounding."""
    key = jax.random.PRNGKey(seed)
    jfield = jinit(key, P, D, 1, sigma=sigma)
    jparams = jdyn.init_dynamics_params(key, P, 1, D, ladder=ladder)
    jparams = jparams._replace(
        transform=jparams.transform * 8.0, queries=jparams.queries * 8.0,
        keys=jparams.keys * 8.0,
        distance_transform=jparams.distance_transform * 5.0)
    tfield = GaussianField.from_numpy(*[np.asarray(a) for a in jfield],
                                      device="cpu")
    tparams = tdyn.DynamicsParams.from_numpy(
        *[np.asarray(a) for a in jparams], device="cpu")
    return jfield, jparams, tfield, tparams


def neighbour_structures(structure, jfield, tfield, D, cfg_kw):
    jcfg, tcfg = JConfig(**cfg_kw).with_dims(D), TConfig(**cfg_kw).with_dims(D)
    jrad = jradii(jfield.covariances(), D, jcfg.radius_sigma, jcfg.eig_floor)
    with torch.no_grad():
        tm, tc = tfield.means.detach(), tfield.conics()
        trad = tradii(tfield.covariances(), D, tcfg.radius_sigma,
                      tcfg.eig_floor)
    if structure == "pallas":
        jc, jplan = jagg.plan_pallas(jcfg, jfield.means, jrad)
        tc2, tplan = tagg.plan_pallas(tcfg, tm, trad)
        assert tuple(tplan) == (jplan.rect, jplan.entries)
        return (jagg.preprocess_pallas(jc, jfield.means, jfield.conics(),
                                       jrad, jplan),
                tagg.preprocess_pallas(tc2, tm, tc, trad, tplan))
    return (jagg.preprocess_grid(jcfg, jfield.means, jfield.conics(), jrad,
                                 48),
            tagg.preprocess_grid(tcfg, tm, tc, trad, 48))


def assert_close(got, ref, rtol, err_msg=""):
    ref = np.asarray(ref)
    np.testing.assert_allclose(
        np.asarray(got), ref, rtol=rtol,
        atol=1e-5 * max(1.0, float(np.abs(ref).max(initial=0.0))),
        err_msg=err_msg)


def assert_param_grads_close(tparams, jgrads, err_msg=""):
    """The JAX suite's aggregation gradient tolerance (rtol 2e-3, atol
    1e-4 max(1, max|ref|), test_aggregation_pallas.py:89-94)."""
    for name in PARAMS:
        ref = np.asarray(getattr(jgrads, name))
        got = getattr(tparams, name).grad
        assert got is not None and float(np.abs(ref).sum()) > 0, name
        np.testing.assert_allclose(
            got.numpy(), ref, rtol=2e-3,
            atol=1e-4 * max(1.0, float(np.abs(ref).max())),
            err_msg=f"dL/d{name} {err_msg}")


@pytest.mark.parametrize("ladder", [False, True])
@pytest.mark.parametrize("structure", ["grid", "pallas"])
def test_rollout_step_matches(structure, ladder):
    """rollout_step over both structures, ladder on and off: the updated
    values (rtol 2e-4) and, through three chained steps, the gradients of
    sum(v^2) in every parameter group."""
    P, D = 64, 2
    jfield, jparams, tfield, tparams = carried(P, D, ladder)
    jn, tn = neighbour_structures(structure, jfield, tfield, D,
                                  dict(tile_size=0.51))
    assert int(tn.overflow) == int(jn.overflow) == 0
    ref = jdyn.rollout_step(jparams, jfield.values, jn, ladder=ladder)
    got = tdyn.rollout_step(tparams, tfield.values.detach(), tn,
                            ladder=ladder)
    assert_close(got.detach(), ref, 2e-4, "one step")

    def jloss(params):
        v = jfield.values
        for _ in range(3):
            v = jdyn.rollout_step(params, v, jn, ladder=ladder)
        return jnp.sum(v ** 2)

    v = tfield.values.detach()
    for _ in range(3):
        v = tdyn.rollout_step(tparams, v, tn, ladder=ladder)
    (v ** 2).sum().backward()
    assert_param_grads_close(tparams, jax.jit(jax.grad(jloss))(jparams),
                             f"{structure} ladder={ladder}")


@pytest.mark.parametrize("D", [1, 2, 3])
def test_advection_diffusion_solution_matches(rng, D):
    x = rng.uniform(-1, 1, (50, D)).astype(np.float32)
    for t in (0.0, 0.05, 0.3):
        ref = jdyn.advection_diffusion_solution(D, kappa=0.07)(
            jnp.asarray(x), t)
        got = tdyn.advection_diffusion_solution(D, kappa=0.07)(
            torch.from_numpy(x), t)
        assert got.shape == (50, 1)
        assert_close(got, ref, 1e-5, f"t={t}")


@pytest.mark.parametrize("ladder", [False, True])
def test_init_dynamics_params(ladder):
    """The same shapes, dtypes and scales as dgs_tpu's (not the same
    numbers), trainable leaves on the generator's device."""
    P, L, D = 500, 3, 2
    ref = jdyn.init_dynamics_params(jax.random.PRNGKey(0), P, L, D,
                                    n_heads=5, n_freq=3, ladder=ladder)
    got = tdyn.init_dynamics_params(torch.Generator().manual_seed(0), P, L, D,
                                    n_heads=5, n_freq=3, ladder=ladder)
    assert got._fields == ref._fields
    for name in got._fields:
        t, j = getattr(got, name), np.asarray(getattr(ref, name))
        assert tuple(t.shape) == j.shape and t.dtype == torch.float32, name
        assert t.requires_grad and t.is_leaf, name
    np.testing.assert_array_equal(got.frequencies.detach().numpy(),
                                  np.asarray(ref.frequencies))
    for name in ("queries", "keys"):
        assert abs(float(getattr(got, name).detach().std()) - 0.1) < 0.01


@pytest.mark.parametrize("eval_method", ["dense", "tiled"])
def test_rollout_loss_and_grads_match(rng, eval_method):
    """One training loss of dynamics.train (its loss_fn, rebuilt here from
    dgs_tpu's rollout_step and make_value_eval) and its gradients, from
    carried-across parameters and the same evaluation points: the kernel
    aggregation with the ladder, the dense evaluator and the tiled one in
    its padded layout."""
    P, D, n_eval, rollout, dt = 100, 2, 256, 2, 0.05
    padded = eval_method == "tiled"
    cfg_kw = dict(tile_size=0.51, eig_floor=1e-12)
    jfield, jparams, tfield, tparams = carried(P, D, True, sigma=0.12)
    jn, tn = neighbour_structures("pallas", jfield, tfield, D, cfg_kw)
    x = rng.uniform(-1, 1, (n_eval, D)).astype(np.float32)
    ju, tu = (m.advection_diffusion_solution(D) for m in (jdyn, tdyn))
    jeval = jdyn.make_value_eval(JConfig(**cfg_kw), jfield, eval_method,
                                 n_eval=n_eval, with_overflow=True,
                                 padded=padded)
    teval = tdyn.make_value_eval(TConfig(**cfg_kw), tfield, eval_method,
                                 n_eval=n_eval, with_overflow=True,
                                 padded=padded)

    def jloss(params):                      # dynamics.py:299-325
        values, stacked = jfield.values, []
        for _ in range(rollout):
            values = jdyn.rollout_step(params, values, jn, ladder=True)
            stacked.append(values)
        V = jnp.concatenate(stacked, axis=1)
        xj = jnp.asarray(x)
        if padded:
            u_pad, perm, overflow = jeval(V, xj)
            tgt_t = jnp.concatenate(
                [ju(xj[perm], (r + 1.0) * dt).reshape(1, -1)
                 for r in range(rollout)], axis=0)
            diff = u_pad[0][:, :n_eval] - tgt_t
            return jnp.mean(diff * diff), overflow
        tgt = jnp.concatenate([ju(xj, (r + 1.0) * dt)
                               for r in range(rollout)], axis=1)
        u, overflow = jeval(V, xj)
        return jnp.mean((u - tgt) ** 2), overflow

    (ref, jof), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jparams)
    got, tof = tdyn.rollout_loss(
        tparams, tfield.values.detach(), tn, teval, torch.from_numpy(x), tu,
        rollout=rollout, dt=dt, ladder=True, padded=padded)
    assert int(tof) == int(jof) == 0
    # A mean of 512 squares in fp32, in another order: rtol 1e-4.
    assert_close(got.detach(), ref, 1e-4, "loss")
    got.backward()
    assert_param_grads_close(tparams, jgrads, eval_method)


def test_value_evaluators_agree(rng):
    """The tiled evaluator (plain, and padded with its permutation) against
    the dense one on the same points, within the 3-sigma cut (a pair beyond
    the footprint box has G < exp(-4.5) = 0.011 of its value: atol 3e-2 of
    the field's scale); zero overflow; a fit that lowers the error."""
    P, D, n_eval = 150, 2, 300
    cfg = TConfig(tile_size=0.51, eig_floor=1e-12)
    _, _, field, _ = carried(P, D, False, sigma=0.1)
    u_star = tdyn.advection_diffusion_solution(D)
    x = torch.from_numpy(rng.uniform(-1, 1, (n_eval, D)).astype(np.float32))
    V = torch.from_numpy(rng.normal(size=(P, 2)).astype(np.float32))
    dense = tdyn.make_value_eval(cfg, field, "dense", n_eval=n_eval)(V, x)
    tiled, of = tdyn.make_value_eval(cfg, field, "tiled", n_eval=n_eval,
                                     with_overflow=True)(V, x)
    assert int(of) == 0 and tiled.shape == dense.shape == (n_eval, 2)
    scale = float(dense.abs().max())
    np.testing.assert_allclose(tiled.numpy(), dense.numpy(), rtol=0,
                               atol=3e-2 * scale)
    u_pad, perm, of = tdyn.make_value_eval(
        cfg, field, "tiled", n_eval=n_eval, with_overflow=True,
        padded=True)(V, x)
    assert u_pad.shape[:2] == (1, 2) and u_pad.shape[2] >= n_eval
    assert torch.equal(u_pad[0][:, :n_eval].T, tiled[perm.long()])
    assert not u_pad[0][:, n_eval:].any()

    def error():
        with torch.no_grad():
            u = tdyn.make_value_eval(cfg, field, "dense")(field.values, x)
            return float(torch.mean((u - u_star(x, 0.0)) ** 2))

    before = error()
    assert tdyn.fit_values(cfg, field, lambda p: u_star(p, 0.0), steps=60,
                           n_fit=512) is field
    assert error() < 0.2 * before


@pytest.mark.parametrize("method,eval_method,ladder", [
    ("grid", "dense", False),
    ("pallas", "dense", False),
    ("pallas", "tiled", True),
])
def test_train_steps(monkeypatch, method, eval_method, ladder):
    """A few steps of the trainer on the CPU: dgs_tpu's record keys, one
    record per scan_chunk steps, zero overflow, finite losses, trainable
    parameters of the right shapes, and the same run from the same seed.
    The value fit is cut to 3 steps of 256 points (200 of 4,096 take
    minutes through the plain tiled kernels)."""
    import functools

    monkeypatch.setattr(tdyn, "fit_values", functools.partial(
        tdyn.fit_values, steps=3, n_fit=256))
    kw = dict(P=200, D=2, steps=5, rollout=2, sigma=0.12, n_eval=256,
              method=method, eval_method=eval_method,
              ladder_frequencies=ladder, scan_chunk=2, device="cpu")
    cfg = TConfig(eig_floor=1e-12)
    params, hist = tdyn.train(cfg, **kw)
    assert [h["step"] for h in hist] == [1, 3, 4]
    for h in hist:
        assert set(h) == {"step", "loss", "t_step_s", "eval_overflow",
                          "nbr_overflow"}
        assert np.isfinite(h["loss"]) and h["t_step_s"] > 0
        assert h["nbr_overflow"] == 0 and h["eval_overflow"] == 0
    assert params.frequencies.shape == ((1,) if ladder else (2,))
    assert params.queries.shape == (200, 4)
    assert params.distance_transform.shape == (2 * (2 * 2 * 2 + 1),)
    _, again = tdyn.train(cfg, **kw)
    assert [h["loss"] for h in again] == [h["loss"] for h in hist]


def test_train_reduces_loss():
    """The residual updates learn: 40 steps at P = 128 lower the loss (the
    slow JAX twin asserts 0.7x after 60)."""
    _, hist = tdyn.train(TConfig(tile_size=0.51), P=128, D=2, steps=40,
                         rollout=2, n_eval=512, neighbor_capacity=64,
                         log_every=10, device="cpu")
    losses = [h["loss"] for h in hist]
    assert hist[0]["nbr_overflow"] == 0 and all(np.isfinite(losses))
    assert losses[-1] < losses[0], losses


def test_entry_points_default_to_the_card():
    """dynamics.train and the new from_numpy functions with no device ask
    for the card; where there is none, torch's own error says so."""
    import inspect

    assert inspect.signature(tdyn.train).parameters["device"].default is None
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a CUDA device")
    z = np.zeros((2, 2), np.float32)
    calls = (
        lambda: tdyn.DynamicsParams.from_numpy(z, z, z, z[0], z[0]),
        lambda: tagg.Neighbors.from_numpy(z, z[:, :, None], z, z[0], 0),
        lambda: tagg.AggBinning.from_numpy(z[0], z, z, z[0], z[0], z, z, 0,
                                           4),
        lambda: tdyn.train(TConfig(), P=8, steps=1),
    )
    for call in calls:
        with pytest.raises((RuntimeError, AssertionError), match="(?i)cuda"):
            call()
