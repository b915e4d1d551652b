"""dgs_tpu_torch's all-pairs (dense) path against dgs_tpu's: the twin of
tests/test_kernels_dense.py.

The same numpy inputs go through dgs_tpu.ops.sampling.sample / sample_all
with method="pallas" (the Pallas kernels in interpret mode) and
method="dense", and through the port's functions of the same names, which
for CPU tensors run the plain torch versions of the CUDA kernels.
Tolerances are the JAX suite's (tests/test_kernels_dense.py): outputs rtol
2e-4, atol 1e-5; single-order gradients rtol 5e-4, atol 5e-5; fused
gradients rtol 2e-3, atol 1e-5 * max(1, max|ref|), because the reduction
orders differ.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgs_tpu.kernels import dense as jdense
from dgs_tpu.ops import sampling as jsampling
from dgs_tpu_torch.kernels import dense as tdense
from dgs_tpu_torch.ops import sampling as tsampling
import dgs_tpu
import dgs_tpu_torch

from conftest import make_gaussians, make_samples

torch.set_num_threads(2)

DIMS = [1, 2, 3]
ORDERS = ["value", "derivative", "laplacian", "third"]
METHODS = ["pallas", "dense"]
NAMES = ("means", "values", "conics")


def _setup(rng, P, N, D, C=3):
    means, values, covs, conics = make_gaussians(rng, P, D, C)
    samples = make_samples(rng, N, D)
    arrays = (means, values, conics, samples)
    return tuple(map(jnp.asarray, arrays)), tuple(map(torch.from_numpy,
                                                      arrays))


def _torch_grads(loss, m, v, c):
    args = [a.clone().requires_grad_() for a in (m, v, c)]
    return torch.autograd.grad(loss(*args), args)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("D", DIMS)
@pytest.mark.parametrize("order", ORDERS)
def test_forward_matches_jax(rng, D, order, method):
    J, T = _setup(rng, 37, 53, D)
    ref = jsampling.sample(order, *J, method=method)
    got = tsampling.sample(order, *T, method=method)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=1e-5)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("period", [2.0, None])
@pytest.mark.parametrize("D", DIMS)
def test_fused_forward_matches_jax(rng, D, period, method):
    J, T = _setup(rng, 19, 31, D)
    ref = jsampling.sample_all(*J, method=method, period=period)
    got = tsampling.sample_all(*T, method=method, period=period)
    assert list(got) == list(ref) == ORDERS
    for order in ORDERS:
        assert got[order].shape == ref[order].shape
        np.testing.assert_allclose(got[order], ref[order], rtol=2e-4,
                                   atol=1e-5, err_msg=order)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("D", DIMS)
@pytest.mark.parametrize("order", ORDERS)
def test_backward_matches_jax_grad(rng, D, order, method):
    (m, v, c, s), (tm, tv, tc, ts) = _setup(rng, 23, 29, D)
    shape = jsampling.sample(order, m, v, c, s, method=method).shape
    g = np.random.default_rng(2).normal(size=shape).astype(np.float32)

    def jloss(m_, v_, c_):
        return jnp.vdot(jsampling.sample(order, m_, v_, c_, s,
                                         method=method), jnp.asarray(g))

    def tloss(m_, v_, c_):
        out = tsampling.sample(order, m_, v_, c_, ts, method=method)
        return (out * torch.from_numpy(g)).sum()

    ref = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(m, v, c)
    got = _torch_grads(tloss, tm, tv, tc)
    for r, o, name in zip(ref, got, NAMES):
        np.testing.assert_allclose(o, r, rtol=5e-4, atol=5e-5,
                                   err_msg=f"{order} dL_d{name}")


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("D", DIMS)
def test_fused_backward_matches_jax_grad(rng, D, method):
    (m, v, c, s), (tm, tv, tc, ts) = _setup(rng, 17, 21, D)

    def jloss(m_, v_, c_):
        outs = jsampling.sample_all(m_, v_, c_, s, method=method)
        return sum(jnp.sum(o ** 2) for o in outs.values())

    def tloss(m_, v_, c_):
        outs = tsampling.sample_all(m_, v_, c_, ts, method=method)
        return sum((o ** 2).sum() for o in outs.values())

    ref = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(m, v, c)
    got = _torch_grads(tloss, tm, tv, tc)
    for r, o, name in zip(ref, got, NAMES):
        r = np.asarray(r)
        np.testing.assert_allclose(
            o, r, rtol=2e-3, atol=1e-5 * max(1.0, float(np.abs(r).max())),
            err_msg=f"dL_d{name}")


@pytest.mark.parametrize("D,C,period,orders", [
    (2, 1, 2.0, ["value", "laplacian"]), (2, 2, 1.5, ORDERS),
    (1, 5, 1.5, ORDERS), (3, 5, 1.5, ["value", "laplacian"])])
def test_channel_counts_and_periods_match_jax(rng, D, C, period, orders):
    """The channel counts the kernels' passes are chosen from (C = 1 and 2
    narrow at D = 2, the PIGS trainer's orders at C = 1; C = 5 over two
    passes of 4) and a period that is not a power of two (the kernels wrap
    it by a division, powers of two by a multiplication): the orders and
    their gradients against dgs_tpu's method="pallas"."""
    (m, v, c, s), (tm, tv, tc, ts) = _setup(rng, 15, 19, D, C=C)
    kw = dict(method="pallas", period=period, orders=tuple(orders))
    ref = jsampling.sample_all(m, v, c, s, **kw)
    got = tsampling.sample_all(tm, tv, tc, ts, **kw)
    for order in orders:
        np.testing.assert_allclose(got[order], ref[order], rtol=2e-4,
                                   atol=1e-5, err_msg=order)

    def jloss(m_, v_, c_):
        outs = jsampling.sample_all(m_, v_, c_, s, **kw)
        return sum(jnp.sum(o ** 2) for o in outs.values())

    def tloss(m_, v_, c_):
        outs = tsampling.sample_all(m_, v_, c_, ts, **kw)
        return sum((o ** 2).sum() for o in outs.values())

    jg = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(m, v, c)
    for r, o, name in zip(jg, _torch_grads(tloss, tm, tv, tc), NAMES):
        r = np.asarray(r)
        np.testing.assert_allclose(
            o, r, rtol=2e-3, atol=1e-5 * max(1.0, float(np.abs(r).max())),
            err_msg=f"dL_d{name}")


@pytest.mark.parametrize("P,N", [(1, 1), (5, 3), (130, 129), (257, 300)])
def test_block_boundary_sizes(rng, P, N):
    """Shapes that are no multiple of a block, forward and backward."""
    (m, v, c, s), (tm, tv, tc, ts) = _setup(rng, P, N, 2, C=2)
    ref = jsampling.sample("value", m, v, c, s, method="pallas")
    got = tsampling.sample("value", tm, tv, tc, ts, method="pallas")
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=1e-5)

    def jloss(m_, v_, c_):
        return jnp.sum(jsampling.sample("value", m_, v_, c_, s,
                                        method="pallas") ** 2)

    def tloss(m_, v_, c_):
        return (tsampling.sample("value", m_, v_, c_, ts,
                                 method="pallas") ** 2).sum()

    jg = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(m, v, c)
    tg = _torch_grads(tloss, tm, tv, tc)
    for r, o, name in zip(jg, tg, NAMES):
        r = np.asarray(r)
        np.testing.assert_allclose(
            o, r, rtol=2e-3, atol=1e-5 * max(1.0, float(np.abs(r).max())),
            err_msg=f"dL_d{name}")


@pytest.mark.parametrize("D", DIMS)
@pytest.mark.parametrize("period", [2.0, None])
def test_plain_kernels_match_jax_kernels(rng, D, period):
    """dense_forward_plain / dense_backward_plain against the JAX kernels'
    per-component lists directly, for a non-canonical order set, through
    more than one sample chunk."""
    orders = ("laplacian", "value", "third", "derivative")
    (m, v, c, s), (tm, tv, tc, ts) = _setup(rng, 21, 45, D)
    ref = jdense.dense_forward(orders, period, m, v, c, s)
    K = tdense.total_components(orders, D)
    assert K == jdense.total_components(orders, D) == len(ref)
    gs = np.random.default_rng(3).normal(size=(K, 45, 3)).astype(np.float32)
    ref_b = jdense.dense_backward(orders, period, m, v, c, s,
                                  [jnp.asarray(g) for g in gs])
    old = tdense.PLAIN_PAIRS
    tdense.PLAIN_PAIRS = 21 * 16          # 16 samples per chunk
    try:
        got = tdense.dense_forward(orders, period, tm, tv, tc, ts)
        got_b = tdense.dense_backward(orders, period, tm, tv, tc, ts,
                                      [torch.from_numpy(g) for g in gs])
    finally:
        tdense.PLAIN_PAIRS = old
    assert len(got) == K
    for k, (g, r) in enumerate(zip(got, ref)):
        assert g.shape == r.shape == (45, 3)
        np.testing.assert_allclose(g, r, rtol=2e-4, atol=1e-5,
                                   err_msg=f"component {k}")
    for g, r, name in zip(got_b, ref_b, NAMES):
        r = np.asarray(r)
        assert g.shape == r.shape
        np.testing.assert_allclose(
            g, r, rtol=2e-3, atol=1e-5 * max(1.0, float(np.abs(r).max())),
            err_msg=f"d{name}")


@pytest.mark.parametrize("D", DIMS)
def test_cotangent_fold_is_the_mirrors_transpose(rng, D):
    """The CUDA backward's operand: the (K_u * C, N) cotangent of the
    unique components, canonical order, is the transpose of the wrapper's
    mirror (the sum of the mirrored positions' cotangents), and the
    backward of the folded cotangent through vjp_params_folded equals the
    plain backward of the full one."""
    from dgs_tpu_torch.ops import formulas

    orders = ("third", "value", "laplacian")
    N, C = 7, 2
    K = tdense.total_components(orders, D)
    gs = [torch.from_numpy(g) for g in rng.normal(
        size=(K, N, C)).astype(np.float32)]
    ct = tdense.fold_cotangents(orders, D, gs)
    rows = tdense._unique_rows(orders, D)
    K_u = max(rows) + 1
    assert ct.shape == (K_u * C, N)
    # canonical order: value first, then laplacian, then third
    assert rows[D ** 3] == 0 and rows[0] == 1 + formulas.n_unique(
        "laplacian", D)
    want = torch.zeros((K_u, N, C))
    for g, u in zip(gs, rows):
        want[u] += g
    np.testing.assert_allclose(ct.reshape(K_u, C, N).permute(0, 2, 1), want,
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("method", METHODS)
def test_backward_is_deterministic_and_samples_get_no_gradient(rng, method):
    _, (tm, tv, tc, ts) = _setup(rng, 30, 40, 2)

    def grads():
        args = [a.clone().requires_grad_() for a in (tm, tv, tc, ts)]
        outs = tsampling.sample_all(*args, method=method)
        sum((o ** 2).sum() for o in outs.values()).backward()
        return [a.grad for a in args]

    a, b = grads(), grads()
    assert a[3] is None and b[3] is None      # no gradient for the samples
    for x, y, name in zip(a, b, NAMES):
        assert x is not None and bool(x.abs().max() > 0), name
        assert torch.equal(x, y), name


def test_bad_arguments_raise(rng):
    _, T = _setup(rng, 5, 6, 2)
    with pytest.raises(ValueError, match="unknown dense method"):
        tsampling.sample("value", *T, method="chunked")
    with pytest.raises(ValueError, match="unknown order"):
        tsampling.sample_all(*T, orders=("value", "fourth"))
    with pytest.raises(ValueError, match="repeated order"):
        tsampling.sample_all(*T, orders=("value", "value"))
    with pytest.raises(ValueError, match="cotangents for"):
        tdense.dense_backward(("value",), 2.0, *T, [])


def test_split_plan_covers_the_axis():
    """The reduction-axis split is a function of the shapes alone, covers
    the axis in whole chunks, and keeps small grids busy: dense config 2's
    forward (782 sample blocks over 10,000 Gaussians) and backward (79
    Gaussian blocks over 100,000 samples) launch about TARGET_BLOCKS, 8
    waves at 4 blocks an SM of the H100 (whole chunks round it down)."""
    for n_blocks, length, chunk in [(782, 10_000, 256), (79, 100_000, 128),
                                    (8, 10_000, 128), (1, 1, 128),
                                    (157, 2_000, 256), (3, 129, 128)]:
        splits, per = tdense.split_plan(n_blocks, length, chunk)
        assert per % chunk == 0 and splits >= 1
        assert splits * per >= length > (splits - 1) * per
        assert (splits, per) == tdense.split_plan(n_blocks, length, chunk)
    for n_blocks, length, chunk in [(782, 10_000, 256), (79, 100_000, 128)]:
        assert (tdense.split_plan(n_blocks, length, chunk)[0] * n_blocks
                >= 0.9 * tdense.TARGET_BLOCKS)
    assert tdense.split_plan(8, 10_000, 128)[0] * 8 >= 132


@pytest.mark.parametrize("method", METHODS)
def test_module_level_api_matches(rng, method):
    """dgs_tpu_torch.sample_gaussians* against dgs_tpu's, shapes and
    values, and a gradient through one of them."""
    J, T = _setup(rng, 20, 30, 2)
    calls = ("sample_gaussians", "sample_gaussians_derivative",
             "sample_gaussians_laplacian",
             "sample_gaussians_third_derivative")
    for call in calls:
        ref = getattr(dgs_tpu, call)(*J, method=method)
        got = getattr(dgs_tpu_torch, call)(*T, method=method)
        assert got.shape == ref.shape, call
        np.testing.assert_allclose(got, ref, rtol=2e-4, atol=1e-5,
                                   err_msg=call)
    for name in ("sample", "sample_all", "sample_dense_multi",
                 "sample_pallas_multi"):
        assert callable(getattr(dgs_tpu_torch, name))
    m = T[0].clone().requires_grad_()
    (dgs_tpu_torch.sample_gaussians(m, *T[1:], method=method) ** 2
     ).sum().backward()
    ref = jax.grad(lambda m_: jnp.sum(dgs_tpu.sample_gaussians(
        m_, *J[1:], method=method) ** 2))(J[0])
    np.testing.assert_allclose(m.grad, ref, rtol=5e-4, atol=5e-5)
