"""dgs_tpu_torch.models.pigs against dgs_tpu.models.pigs: the manufactured
solution, the PIGS loss and its gradients to every field parameter, the
Adam update, one whole training step on the JAX step's own inputs, and a
short training run."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dgs_tpu.config import SamplerConfig as JConfig
from dgs_tpu.models import pigs as jpigs
from dgs_tpu.models.field import init_field as jinit
from dgs_tpu_torch.config import SamplerConfig as TConfig
from dgs_tpu_torch.models import pigs as tpigs
from dgs_tpu_torch.models.field import GaussianField

from conftest import make_samples

torch.set_num_threads(2)

PARAMS = ("means", "log_scales", "rotations", "values")
# Static work-list capacities for the JAX side (the port has no work list).
CFG = dict(tile_size=0.25, max_tiles_per_gaussian=6, work_blocks_fwd=16,
           work_blocks_bwd=32)


def assert_close(got, ref, err_msg="", rtol=2e-4):
    ref = np.asarray(ref)
    np.testing.assert_allclose(
        np.asarray(got), ref, rtol=rtol,
        atol=1e-5 * max(1.0, float(np.abs(ref).max(initial=0.0))),
        err_msg=err_msg)


def _field(seed, P=48, D=2, C=1, sigma=0.08):
    jf = jinit(jax.random.PRNGKey(seed), P, D, C, sigma=sigma)
    return jf, GaussianField.from_numpy(*[np.asarray(a) for a in jf],
                                        device="cpu")


@pytest.mark.parametrize("D", [1, 2, 3])
def test_manufactured_solution_matches(rng, D):
    x = make_samples(rng, 100, D)
    ju, jf = jpigs.manufactured_solution(D)
    tu, tf = tpigs.manufactured_solution(D)
    assert_close(tu(torch.from_numpy(x)), ju(jnp.asarray(x)), "u*")
    assert_close(tf(torch.from_numpy(x)), jf(jnp.asarray(x)), "f")


def test_pigs_loss_and_grads_match(rng):
    """Loss value, metrics and gradients to means, log_scales, rotations
    and values against jax.value_and_grad of dgs_tpu's pigs_loss on the
    same field and points."""
    jf, tf = _field(1)
    col = make_samples(rng, 200, 2)
    dx = make_samples(rng, 50, 2)
    ju, jrhs = jpigs.manufactured_solution(2)
    tu, trhs = tpigs.manufactured_solution(2)
    du = np.asarray(ju(jnp.asarray(dx)))

    def jloss(field):
        return jpigs.pigs_loss(JConfig(**CFG), field, jnp.asarray(col),
                               jnp.asarray(dx), jnp.asarray(du), jrhs)

    (jl, jm), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jf)
    tl, tm = tpigs.pigs_loss(TConfig(**CFG), tf, torch.from_numpy(col),
                             torch.from_numpy(dx), torch.from_numpy(du.copy()),
                             trhs)
    tl.backward()
    assert_close(tl.detach(), jl, "loss")
    for k in ("pde", "data"):
        assert_close(tm[k], jm[k], k)
    for k in tpigs.DIAGNOSTICS:
        assert int(tm[k]) == int(jm[k]) == 0, k
    for name in PARAMS:
        g = getattr(tf, name).grad
        assert g is not None and bool(g.abs().max() > 0), name
        assert_close(g, getattr(jg, name), f"dL/d{name}", rtol=2e-3)


@pytest.mark.parametrize("method", ["tiled", "dense"])
def test_pigs_loss_outs_reduce_matches(rng, method):
    """pigs_loss with an outs_reduce hook that scales every output (the
    place where Gaussian-sharded execution sums partial mixtures): loss,
    terms and gradients against dgs_tpu's pigs_loss with the same hook, and
    the hook sees each evaluation's outputs once."""
    jf, tf = _field(5, P=32)
    col = make_samples(rng, 96, 2)
    dx = make_samples(rng, 32, 2)
    ju, jrhs = jpigs.manufactured_solution(2)
    tu, trhs = tpigs.manufactured_solution(2)
    du = np.asarray(ju(jnp.asarray(dx)))
    scale = 0.75
    seen = []

    def jreduce(outs):
        return {k: scale * v for k, v in outs.items()}

    def treduce(outs):
        seen.append(tuple(sorted(outs)))
        return {k: scale * v for k, v in outs.items()}

    def jloss(field):
        return jpigs.pigs_loss(JConfig(**CFG), field, jnp.asarray(col),
                               jnp.asarray(dx), jnp.asarray(du), jrhs,
                               method=method, outs_reduce=jreduce)

    (jl, jm), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jf)
    tl, tm = tpigs.pigs_loss(TConfig(**CFG), tf, torch.from_numpy(col),
                             torch.from_numpy(dx), torch.from_numpy(du.copy()),
                             trhs, method=method, outs_reduce=treduce)
    tl.backward()
    assert seen == [("laplacian", "value"), ("value",)]
    plain, _ = tpigs.pigs_loss(TConfig(**CFG), tf, torch.from_numpy(col),
                               torch.from_numpy(dx),
                               torch.from_numpy(du.copy()), trhs,
                               method=method)
    assert float(plain.detach()) != float(tl.detach())
    assert_close(tl.detach(), jl, "loss")
    for k in ("pde", "data"):
        assert_close(tm[k], jm[k], k)
    for name in PARAMS:
        g = getattr(tf, name).grad
        assert g is not None and bool(g.abs().max() > 0), name
        assert_close(g, getattr(jg, name), f"dL/d{name}", rtol=2e-3)


def test_adam_matches_optax(rng):
    """torch.optim.Adam(eps=1e-8) takes optax.adam's steps from the same
    gradients (two steps, so the bias corrections are checked)."""
    p0 = rng.normal(0.0, 1.0, (30, 2)).astype(np.float32)
    grads = [rng.normal(0.0, 1.0, (30, 2)).astype(np.float32)
             for _ in range(2)]
    opt = optax.adam(1e-2)
    jp = jnp.asarray(p0)
    state = opt.init(jp)
    tp = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    topt = torch.optim.Adam([tp], lr=1e-2, eps=1e-8)
    for g in grads:
        upd, state = opt.update(jnp.asarray(g), state, jp)
        jp = optax.apply_updates(jp, upd)
        tp.grad = torch.from_numpy(g)
        topt.step()
    # The two compute the bias-corrected step in a different order: equal
    # to 1e-4 of the learning rate.
    np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp),
                               rtol=1e-6, atol=1e-6)


def test_train_step_matches_jax_step():
    """One port train_step on the collocation and data points the JAX step
    body draws from its key: same metrics, same updated parameters."""
    cfg_j, cfg_t = JConfig(**CFG), TConfig(**CFG)
    jf, tf = _field(2, P=40)
    ju, jrhs = jpigs.manufactured_solution(2)
    tu, trhs = tpigs.manufactured_solution(2)
    lr, n_col = 1e-3, 128
    opt = optax.adam(lr)
    body = jpigs.make_train_body(cfg_j, opt, jrhs, ju, n_collocation=n_col)
    key = jax.random.PRNGKey(7)
    state, jmetrics = jax.jit(body)(
        jpigs.TrainState(jf, opt.init(jf), jnp.zeros((), jnp.int32)), key)
    # The step body's own draws (make_train_body).
    k1, k2 = jax.random.split(key)
    col = jax.random.uniform(k1, (n_col, 2), minval=-1.0, maxval=1.0)
    dx = jax.random.uniform(k2, (n_col // 4, 2), minval=-1.0, maxval=1.0)
    du = ju(dx)

    topt = torch.optim.Adam(tf.parameters(), lr=lr, eps=1e-8)
    tmetrics = tpigs.train_step(
        cfg_t, tf, topt, *(torch.from_numpy(np.array(a))
                           for a in (col, dx, du)), trhs)
    for k in ("loss", "pde", "data"):
        assert_close(tmetrics[k], jmetrics[k], k)
    for name in PARAMS:
        assert_close(getattr(tf, name).detach(), getattr(state.field, name),
                     name)


def test_train_reduces_loss():
    """Twin of test_pigs.py's tiled training test: the loss falls and the
    binning never overflows."""
    cfg = TConfig(work_blocks_fwd=16, work_blocks_bwd=32)
    state, history = tpigs.train(
        cfg, P=64, D=2, C=1, steps=60, n_collocation=256,
        learning_rate=1e-2, sigma=0.25, log_every=59, device="cpu")
    assert [h["step"] for h in history] == [31, 59]
    assert history[-1]["loss"] < 0.7 * history[0]["loss"]
    for h in history:
        for k in tpigs.DIAGNOSTICS:
            assert h[k] == 0, (k, h)
        assert h["t_step_s"] > 0
    assert state.step == 60
    assert bool(torch.isfinite(state.field.means).all())


@pytest.mark.parametrize("method", ["dense", "pallas"])
def test_pigs_loss_dense_methods_match(rng, method):
    """pigs_loss through the all-pairs methods (the full (N, D, D, C)
    Hessian and its trace, unsorted targets): loss, terms and gradients to
    all four field parameters against jax.value_and_grad."""
    jf, tf = _field(3, P=32, sigma=0.2)
    col = make_samples(rng, 64, 2)
    dx = make_samples(rng, 24, 2)
    ju, jrhs = jpigs.manufactured_solution(2)
    tu, trhs = tpigs.manufactured_solution(2)
    du = np.asarray(ju(jnp.asarray(dx)))

    def jloss(field):
        return jpigs.pigs_loss(JConfig(), field, jnp.asarray(col),
                               jnp.asarray(dx), jnp.asarray(du), jrhs,
                               method=method)

    (jl, jm), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jf)
    tl, tm = tpigs.pigs_loss(TConfig(), tf, torch.from_numpy(col),
                             torch.from_numpy(dx), torch.from_numpy(du.copy()),
                             trhs, method=method)
    tl.backward()
    assert_close(tl.detach(), jl, "loss")
    for k in ("pde", "data"):
        assert_close(tm[k], jm[k], k)
    for k in tpigs.DIAGNOSTICS:
        assert int(tm[k]) == 0, k
    for name in PARAMS:
        g = getattr(tf, name).grad
        assert g is not None and bool(g.abs().max() > 0), name
        assert_close(g, getattr(jg, name), f"dL/d{name}", rtol=2e-3)


@pytest.mark.parametrize("method", ["dense", "pallas"])
def test_train_dense_methods_reduce_loss(method):
    """Twin of test_pigs.py's dense training test, through both all-pairs
    methods; no binning, so no capacity is planned and nothing overflows."""
    state, history = tpigs.train(
        TConfig(), P=64, D=2, C=1, steps=60, n_collocation=256,
        learning_rate=1e-2, sigma=0.25, method=method, log_every=59,
        device="cpu")
    assert history[0]["loss"] > history[-1]["loss"]
    assert history[-1]["loss"] < 0.7 * history[0]["loss"]
    for h in history:
        for k in tpigs.DIAGNOSTICS:
            assert h[k] == 0, (k, h)
    assert state.step == 60
    assert bool(torch.isfinite(state.field.means).all())


def test_entry_points_default_to_the_card():
    """train() and GaussianField.from_numpy() with no device ask for the
    card; where there is none, torch's own error says so."""
    import inspect

    assert inspect.signature(tpigs.train).parameters["device"].default is None
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a CUDA device")
    arrays = [np.zeros((2, k), np.float32) for k in (2, 2, 1, 1)]
    with pytest.raises((RuntimeError, AssertionError), match="(?i)cuda"):
        GaussianField.from_numpy(*arrays)
    with pytest.raises((RuntimeError, AssertionError), match="(?i)cuda"):
        tpigs.train(TConfig(), P=4, steps=1, n_collocation=8)
