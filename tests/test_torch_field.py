"""dgs_tpu_torch.models.field against dgs_tpu.models.field: a JAX field's
four parameter arrays carried across with GaussianField.from_numpy give the
same covariances and conics."""

import jax
import numpy as np
import pytest
import torch

from dgs_tpu.models.field import init_field as jinit
from dgs_tpu_torch.config import tri_size
from dgs_tpu_torch.models.field import GaussianField, init_field

torch.set_num_threads(2)


def assert_close(got, ref, err_msg=""):
    ref = np.asarray(ref)
    np.testing.assert_allclose(
        np.asarray(got), ref, rtol=2e-4,
        atol=1e-5 * max(1.0, float(np.abs(ref).max(initial=0.0))),
        err_msg=err_msg)


@pytest.mark.parametrize("D", [1, 2, 3])
def test_from_numpy_matches_jax_field(D):
    jf = jinit(jax.random.PRNGKey(D), 48, D, 3, sigma=0.07)
    arrays = [np.asarray(a) for a in jf]
    tf = GaussianField.from_numpy(*arrays, device="cpu")
    for name, a in zip(("means", "log_scales", "rotations", "values"),
                       arrays):
        t = getattr(tf, name)
        assert isinstance(t, torch.nn.Parameter) and t.dtype == torch.float32
        np.testing.assert_array_equal(t.detach().numpy(), a)
    assert (tf.P, tf.D) == (jf.P, jf.D)
    with torch.no_grad():
        assert_close(tf.rotation_matrices(), jf.rotation_matrices(), "R")
        assert_close(tf.covariances(), jf.covariances(), "covariances")
        assert_close(tf.conics(), jf.conics(), "conics")


@pytest.mark.parametrize("D", [1, 2, 3])
def test_init_field_shapes_and_seed(D):
    f1 = init_field(torch.Generator().manual_seed(0), 50, D, 4, sigma=0.05)
    f2 = init_field(torch.Generator().manual_seed(0), 50, D, 4, sigma=0.05)
    rot = {1: 0, 2: 1, 3: 4}[D]
    assert f1.means.shape == (50, D) and f1.log_scales.shape == (50, D)
    assert f1.rotations.shape == (50, rot) and f1.values.shape == (50, 4)
    for a, b in zip(f1.parameters(), f2.parameters()):
        assert a.dtype == torch.float32 and a.device.type == "cpu"
        assert torch.equal(a, b)
    m = f1.means.detach()
    assert float(m.min()) >= -1.0 and float(m.max()) < 1.0
    with torch.no_grad():
        cov = f1.covariances()
        assert cov.shape == (50, tri_size(D))
        # conic is the inverse covariance: cov @ conic = I per Gaussian
        from dgs_tpu_torch.config import tri_index

        def full(p):
            return torch.stack([torch.stack(
                [p[:, tri_index(D, i, j)] for j in range(D)], -1)
                for i in range(D)], -2)
        eye = full(cov) @ full(f1.conics())
        assert_close(eye, np.broadcast_to(np.eye(D), (50, D, D)))
