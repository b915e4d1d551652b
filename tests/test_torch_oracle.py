"""dgs_tpu_torch.oracle.dense against dgs_tpu.oracle.dense, and autograd
through the port's oracle against the closed-form backward of the port's
sample_dense (the twin of tests/test_oracle.py's custom-VJP test)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgs_tpu.oracle import dense as joracle
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


@pytest.mark.parametrize("D", [1, 2, 3])
@pytest.mark.parametrize("period", [2.0, None])
def test_evaluate_matches(rng, D, period):
    m, v, cov, c = make_gaussians(rng, 37, D, 3, sigma_range=(0.1, 0.6))
    s = make_samples(rng, 53, D)
    mask = rng.uniform(size=(53, 37)) < 0.7
    J = tuple(map(jnp.asarray, (m, v, c, s)))
    T = tuple(map(torch.from_numpy, (m, v, c, s)))
    for pair_mask in (None, mask):
        jm = None if pair_mask is None else jnp.asarray(pair_mask)
        tm = None if pair_mask is None else torch.from_numpy(pair_mask)
        ref = joracle.evaluate_all(*J, period=period, pair_mask=jm)
        got = toracle.evaluate_all(*T, period=period, pair_mask=tm)
        for order in ORDERS:
            assert got[order].shape == ref[order].shape
            assert_close(got[order], ref[order], f"{order} masked="
                         f"{pair_mask is not None}")


@pytest.mark.parametrize("D", [1, 2, 3])
def test_radii_match(rng, D):
    _, _, cov, _ = make_gaussians(rng, 64, D, 1)
    if D == 2:
        cov[3] = [0.01, 0.01, 0.01]        # det == 0: culled to zero radius
        cov[5] = [0.04, -0.02, 0.01]       # det == 0, negative off-diagonal
    for sigma, floor in ((3.0, 1e-6), (2.5, 1e-12)):
        jr = joracle.radii(jnp.asarray(cov), D, sigma, floor)
        tr = toracle.radii(torch.from_numpy(cov), D, sigma, floor)
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-6)
        np.testing.assert_array_equal(tr.numpy() > 0, np.asarray(jr) > 0)
        ja = joracle.radii_axis(jnp.asarray(cov), D, sigma, floor)
        ta = toracle.radii_axis(torch.from_numpy(cov), D, sigma, floor)
        np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-6)
    if D == 2:
        assert float(tr[3]) == 0.0 and float(tr[5]) == 0.0


@pytest.mark.parametrize("D", [1, 2, 3])
@pytest.mark.parametrize("order", ORDERS)
def test_closed_form_backward_matches_autograd(rng, D, order):
    """The hand-derived closed-form VJP of sample_dense equals autograd
    through the plain torch oracle, at the JAX suite's tolerance
    (tests/test_oracle.py: rtol 5e-4, atol 5e-5)."""
    m, v, _, c = make_gaussians(rng, 13, D, 2)
    s = torch.from_numpy(make_samples(rng, 19, D))
    T = tuple(map(torch.from_numpy, (m, v, c)))
    shape = toracle.evaluate(order, *T, s).shape
    g = torch.from_numpy(np.random.default_rng(1).normal(
        size=shape).astype(np.float32))

    def grads(fn):
        args = [a.clone().requires_grad_() for a in T]
        return torch.autograd.grad((fn(order, *args, s) * g).sum(), args)

    ref = grads(toracle.evaluate)
    got = grads(tsampling.sample_dense)
    for r, o, name in zip(ref, got, ("means", "values", "conics")):
        np.testing.assert_allclose(o, r, rtol=5e-4, atol=5e-5,
                                   err_msg=f"{order} dL_d{name}")
