"""dgs_tpu_torch.parallel.mesh against dgs_tpu.parallel.mesh and the port's
unsharded paths.

The sharded paths run on gloo over CPU ranks spawned by
tests/torch_dist_worker.py: one spawn of four ranks (meshes (2, 2) and
(1, 4)) and one of two (mesh (1, 2)), each running every check of its
world size once.  This process asserts on their results, against
dgs_tpu's sharded evaluation on its virtual CPU devices (the same mesh
shapes), jax.grad of dgs_tpu's unsharded losses and the port's unsharded
ops and steps, all on the same seeded numpy inputs.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgs_tpu.config import SamplerConfig as JConfig
from dgs_tpu.models import pigs as jpigs
from dgs_tpu.models.field import init_field as jinit
from dgs_tpu.ops import aggregation as jagg
from dgs_tpu.ops import sampling as jsampling
from dgs_tpu.parallel import mesh as jmesh
from dgs_tpu_torch.config import SamplerConfig as TConfig
from dgs_tpu_torch.models import dynamics as tdyn
from dgs_tpu_torch.models import pigs as tpigs
from dgs_tpu_torch.models.field import GaussianField
from dgs_tpu_torch.ops import aggregation as tagg
from dgs_tpu_torch.ops import sampling as tsampling
from dgs_tpu_torch.oracle.dense import radii as tradii
from dgs_tpu_torch.parallel import mesh as tmesh
from dgs_tpu_torch.utils import native

import torch_dist_worker as worker
from conftest import make_gaussians, make_samples

torch.set_num_threads(2)

GRAD_RTOL = 2e-3


def assert_close(got, ref, err_msg="", rtol=2e-4, atol=1e-5):
    ref = np.asarray(ref)
    np.testing.assert_allclose(
        np.asarray(got), ref, rtol=rtol,
        atol=atol * max(1.0, float(np.abs(ref).max(initial=0.0))),
        err_msg=err_msg)


# ---------------------------------------------------------------------------
# Inputs, from numpy seeds
# ---------------------------------------------------------------------------


def _eval_case(method):
    if method == "dense":
        rng = np.random.default_rng(0)
        means, values, covs, conics = make_gaussians(rng, 32, 2, 3)
        cfg, orders = {}, ("value", "derivative", "laplacian")
    else:
        rng = np.random.default_rng(1)
        means, values, covs, conics = make_gaussians(
            rng, 32, 2, 2, sigma_range=(0.15, 0.3))
        cfg = dict(work_blocks_fwd=16, work_blocks_bwd=32)
        orders = ("value", "derivative")
    arrays = dict(means=means, values=values, covs=covs, conics=conics,
                  samples=make_samples(rng, 64, 2))
    return {"cfg": cfg, "orders": orders, "method": method,
            "arrays": arrays}


EVAL = {m: _eval_case(m) for m in ("dense", "tiled")}


def _skewed_case():
    """Narrow Gaussians in the first model shard, wide ones in the second:
    the second holds nearly all the entries, more than the whole cloud's
    mean entries a Gaussian give its shard room for."""
    rng = np.random.default_rng(30)
    narrow = make_gaussians(rng, 32, 2, 2, sigma_range=(0.01, 0.02))
    wide = make_gaussians(rng, 32, 2, 2, sigma_range=(0.2, 0.3))
    means, values, covs, conics = (np.concatenate(x)
                                   for x in zip(narrow, wide))
    arrays = dict(means=means, values=values, covs=covs, conics=conics,
                  samples=make_samples(rng, 64, 2))
    return {"cfg": dict(tile_size=0.1, work_blocks_fwd=16,
                        work_blocks_bwd=32),
            "orders": ("value", "derivative"), "method": "tiled",
            "arrays": arrays}


SKEWED = _skewed_case()


def _pigs_case():
    jf = jinit(jax.random.PRNGKey(5), 32, 2, 1, sigma=0.3)
    rng = np.random.default_rng(6)
    return {"cfg": {}, "lr": 0.1, "field": [np.asarray(a) for a in jf],
            "points": {"collocation": make_samples(rng, 64, 2),
                       "data_x": make_samples(rng, 16, 2)}}


PIGS = _pigs_case()


def _agg_arrays(seed, P, C, sigma_range):
    rng = np.random.default_rng(seed)
    means, values, covs, conics = make_gaussians(rng, P, 2, C,
                                                 sigma_range=sigma_range)
    cfg = TConfig(eig_floor=1e-12)
    rad = tradii(torch.from_numpy(covs), 2, cfg.radius_sigma,
                 cfg.eig_floor).numpy()
    return {"means": means, "conics": conics, "radii": rad}, values


def _agg_case():
    arrays, _ = _agg_arrays(11, 80, 4, (0.05, 0.2))
    P, L, K, nfreq = 80, 4, 3, 2
    E = nfreq * 2 * 2 + 1
    r = np.random.default_rng(5)
    f32 = np.float32
    params = {
        "features": r.normal(size=(P, L)).astype(f32),
        "transform": r.normal(size=(L, L)).astype(f32),
        "queries": r.normal(size=(P, K)).astype(f32),
        "keys": r.normal(size=(P, K)).astype(f32),
        "frequencies": np.arange(1.0, nfreq + 1).astype(f32),
        "distance_transform": r.normal(size=(2 * E,)).astype(f32)}
    return {"cfg": {"eig_floor": 1e-12}, "arrays": arrays, "params": params}


AGG = _agg_case()


def _dynamics_case():
    arrays, values = _agg_arrays(3, 60, 1, (0.08, 0.25))
    P, K, E = 60, 4, 2 * 2 * 2 + 1
    r = np.random.default_rng(4)
    f32 = np.float32
    params = [0.1 * r.normal(size=(1, 1)).astype(f32),
              0.1 * r.normal(size=(P, K)).astype(f32),
              0.1 * r.normal(size=(P, K)).astype(f32),
              np.ones((1,), f32),
              0.1 * r.normal(size=(2 * E,)).astype(f32)]
    arrays = {**arrays, "values0": values, "target": 0.9 * values}
    return {"cfg": {"eig_floor": 1e-12}, "arrays": arrays, "params": params,
            "lr": 1e-2, "rollout": 2, "steps": 2}


DYNAMICS = _dynamics_case()


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return worker.spawn("world4", 4, {"eval": EVAL, "skewed": SKEWED,
                                      "pigs": PIGS, "agg": AGG},
                        tmp_path_factory.mktemp("world4"))


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return worker.spawn("world2", 2, {"eval": EVAL, "skewed": SKEWED,
                                      "pigs": PIGS, "agg": AGG,
                                      "dynamics": DYNAMICS},
                        tmp_path_factory.mktemp("world2"))


@pytest.fixture
def ranks(request, world4, world2):
    """The ranks' results of the spawn whose mesh ``request.param`` names."""
    return {"2x2": world4, "1x4": world4, "1x2": world2}[request.param]


# ---------------------------------------------------------------------------
# References
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def jax_sharded_eval(mesh_name, method):
    """dgs_tpu's sharded_sample_all on the same mesh shape of its virtual
    CPU devices."""
    shape = tuple(int(x) for x in mesh_name.split("x"))
    mesh = jmesh.make_mesh(shape,
                           devices=jax.devices()[:shape[0] * shape[1]])
    c = EVAL[method]
    a = {k: jnp.asarray(v) for k, v in c["arrays"].items()}
    run = jax.jit(functools.partial(
        jmesh.sharded_sample_all, JConfig(**c["cfg"]), mesh,
        orders=c["orders"], method=method))
    outs = run(a["means"], a["values"], a["conics"], a["covs"], a["samples"])
    return {k: np.asarray(v) for k, v in outs.items()}


def whole_cloud_config(c):
    """The tiled config planned for case ``c``'s whole cloud."""
    cfg = TConfig(**c["cfg"])
    a = c["arrays"]
    return native.config_from_plan(
        cfg, native.plan_capacities(cfg, a["means"], a["covs"],
                                    a["samples"]), len(a["means"]))


def port_eval(c, cfg=None):
    """The port's unsharded op on the whole cloud and every sample of case
    ``c`` (tiled: under ``cfg``, by default the case's): (outputs dict,
    diagnostics dict or None)."""
    t = {k: torch.from_numpy(v) for k, v in c["arrays"].items()}
    gauss = [t[k] for k in ("means", "values", "conics")]
    if c["method"] == "tiled":
        return tsampling.sample_binned(cfg or TConfig(**c["cfg"]), *gauss,
                                       t["covs"], t["samples"], c["orders"])
    return tsampling.sample_all(*gauss, t["samples"], orders=c["orders"],
                                method="dense"), None


def jax_eval_loss_grads(method):
    """jax.value_and_grad of sum(o^2) over every output of dgs_tpu's
    unsharded op, to (means, values, conics)."""
    c = EVAL[method]
    a = {k: jnp.asarray(v) for k, v in c["arrays"].items()}
    cfg = JConfig(**c["cfg"])

    def loss(m, v, cn):
        if method == "tiled":
            outs, _ = jsampling.sample_binned(cfg, m, v, cn, a["covs"],
                                              a["samples"], c["orders"])
        else:
            outs = jsampling.sample_dense_all(m, v, cn, a["samples"],
                                              orders=c["orders"])
        return sum(jnp.sum(o * o) for o in outs.values())

    l, g = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2)))(
        a["means"], a["values"], a["conics"])
    return float(l), [np.asarray(x) for x in g]


def union_points(case):
    p = case["points"]
    return p["collocation"], p["data_x"]


def jax_pigs_loss_grads(case):
    """jax.value_and_grad of dgs_tpu's pigs_loss ("dense") on the union of
    the ranks' points."""
    col, dx = union_points(case)
    ju, jrhs = jpigs.manufactured_solution(2)
    jf = jinit(jax.random.PRNGKey(5), 32, 2, 1, sigma=0.3)
    du = ju(jnp.asarray(dx))

    def loss(field):
        return jpigs.pigs_loss(JConfig(**case["cfg"]), field,
                               jnp.asarray(col), jnp.asarray(dx), du, jrhs,
                               method="dense")

    (l, _), g = jax.value_and_grad(loss, has_aux=True)(jf)
    return float(l), {k: np.asarray(getattr(g, k)) for k in worker.FIELD}


def port_pigs_step(case):
    """The port's unsharded pigs.train_step under SGD on the union of the
    ranks' points: (metrics, gradients, updated parameters)."""
    col, dx = union_points(case)
    tu, trhs = tpigs.manufactured_solution(2)
    field = GaussianField.from_numpy(*case["field"], device="cpu")
    opt = torch.optim.SGD(field.parameters(), lr=case["lr"])
    dx_t = torch.from_numpy(dx)
    metrics = tpigs.train_step(TConfig(**case["cfg"]), field, opt,
                               torch.from_numpy(col), dx_t, tu(dx_t), trhs,
                               method="dense")
    grads = {k: getattr(field, k).grad.numpy() for k in worker.FIELD}
    params = {k: getattr(field, k).detach().numpy() for k in worker.FIELD}
    return metrics, grads, params


def port_aggregate(case):
    """The port's unsharded aggregate_pallas: (output, six gradients,
    overflow, tile size)."""
    t = {k: torch.from_numpy(v) for k, v in case["arrays"].items()}
    cfg, plan = tagg.plan_pallas(TConfig(**case["cfg"]), t["means"],
                                 t["radii"])
    agg = tagg.preprocess_pallas(cfg, t["means"], t["conics"], t["radii"],
                                 plan)
    leaves = [torch.from_numpy(case["params"][k]).requires_grad_()
              for k in worker.GROUPS]
    out = tagg.aggregate_pallas(*leaves, agg)
    (out * torch.cos(out)).sum().backward()
    return (out.detach().numpy(),
            {k: x.grad.numpy() for k, x in zip(worker.GROUPS, leaves)},
            int(agg.overflow), cfg.tile_size)


# ---------------------------------------------------------------------------
# 1-2. sharded_sample_all
# ---------------------------------------------------------------------------

EVAL_CASES = [("2x2", "dense"), ("2x2", "tiled"), ("1x2", "dense"),
              ("1x2", "tiled")]


@pytest.mark.parametrize("ranks,method", EVAL_CASES, indirect=["ranks"])
def test_sharded_sample_all_matches_dgs_tpu(ranks, method, request):
    """Every rank's gathered outputs against dgs_tpu's sharded_sample_all
    on the same mesh shape."""
    mesh_name = request.node.callspec.params["ranks"]
    ref = jax_sharded_eval(mesh_name, method)
    for r, res in enumerate(ranks):
        got = res["eval"][method]["outs"]
        assert set(got) == set(ref)
        for k in ref:
            assert_close(got[k], ref[k], f"rank {r} {k}")


@pytest.mark.parametrize("ranks,method", EVAL_CASES, indirect=["ranks"])
def test_sharded_sample_all_matches_unsharded(ranks, method):
    """Every rank's gathered outputs against the port's unsharded op; the
    tiled binning overflows on no rank."""
    ref, diag = port_eval(EVAL[method])
    if diag is not None:
        assert int(diag["bin_overflow"]) == 0
    for r, res in enumerate(ranks):
        ev = res["eval"][method]
        assert ev["bin_overflow"] == 0 and ev["entry_overflow"] == 0, r
        for k in ref:
            assert_close(ev["outs"][k], ref[k].numpy(), f"rank {r} {k}")


@pytest.mark.parametrize("method", ["dense", "tiled"])
def test_sharded_gradients_match_jax(world4, method):
    """The gradient of a global loss through sharded_sample_all on (2, 2)
    (each rank's gradients summed over the mesh) against jax.grad of the
    same loss through dgs_tpu's unsharded op."""
    l_ref, g_ref = jax_eval_loss_grads(method)
    for r, res in enumerate(world4):
        got = res["eval_grads"][method]
        assert got["loss"] == pytest.approx(l_ref, rel=1e-5), r
        for name, g, ref in zip(("means", "values", "conics"),
                                got["grads"], g_ref):
            assert_close(g, ref, f"rank {r} d{name}", rtol=GRAD_RTOL)


SKEWED_MESHES = ["2x2", "1x2"]


@pytest.mark.parametrize("ranks", SKEWED_MESHES, indirect=True)
def test_whole_cloud_plan_overflows_a_skewed_shard(ranks):
    """The skewed cloud's wide shard overflows its entries under a plan of
    the whole cloud (whose entry capacity is a factor of the shard's
    Gaussian count), which the unsharded op runs without overflow: the
    case plan_sharded_config exists for."""
    _, diag = port_eval(SKEWED, whole_cloud_config(SKEWED))
    assert int(diag["entry_overflow"]) == 0
    for r, res in enumerate(ranks):
        got = res["skewed"]
        assert (got["whole_entry_overflow"] > 0) == (got["model"] == 1), r


@pytest.mark.parametrize("ranks", SKEWED_MESHES, indirect=True)
def test_plan_sharded_config_covers_a_skewed_shard(ranks):
    """Every rank runs the same plan_sharded_config config, overflows on no
    rank, and its gathered outputs match the port's unsharded op."""
    ref, _ = port_eval(SKEWED, whole_cloud_config(SKEWED))
    cfgs = [res["skewed"]["cfg"] for res in ranks]
    assert all(c == cfgs[0] for c in cfgs)
    for r, res in enumerate(ranks):
        got = res["skewed"]
        assert got["bin_overflow"] == 0 and got["entry_overflow"] == 0, r
        for k in ref:
            assert_close(got["outs"][k], ref[k].numpy(), f"rank {r} {k}")


# ---------------------------------------------------------------------------
# 3. plan_pallas_sharded
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("D", [2, 3])
@pytest.mark.parametrize("n_shards", [2, 4])
def test_plan_pallas_sharded_matches(D, n_shards):
    """Tile ranges, tile size, rect and entries equal dgs_tpu's exactly."""
    rng = np.random.default_rng(20 + D)
    means, _, covs, conics = make_gaussians(rng, 120, D, 1,
                                            sigma_range=(0.05, 0.2))
    jcfg = JConfig(eig_floor=1e-12, lower=(-1.0,) * D)
    tcfg = TConfig(eig_floor=1e-12, lower=(-1.0,) * D)
    rad = tradii(torch.from_numpy(covs), D, tcfg.radius_sigma,
                 tcfg.eig_floor)
    jc, jplan, jranges = jagg.plan_pallas_sharded(
        jcfg, jnp.asarray(means), jnp.asarray(rad.numpy()), n_shards)
    tc, tplan, tranges = tagg.plan_pallas_sharded(
        tcfg, torch.from_numpy(means), rad, n_shards)
    assert tranges == tuple((int(a), int(b)) for a, b in jranges)
    assert len(tranges) == n_shards and tranges[0][0] == 0
    assert tc.tile_size == jc.tile_size
    assert (tplan.rect, tplan.entries) == (jplan.rect, jplan.entries)


# ---------------------------------------------------------------------------
# 4. sharded_aggregate
# ---------------------------------------------------------------------------

AGG_MESHES = ["1x2", "1x4"]


@pytest.mark.parametrize("ranks", AGG_MESHES, indirect=True)
def test_sharded_aggregate_outputs_match_unsharded(ranks):
    """Outputs over 2 and 4 tile-range shards against the port's unsharded
    aggregate_pallas; no shard overflows and every shard planned the same
    tile."""
    out_ref, _, overflow, tile = port_aggregate(AGG)
    assert overflow == 0
    for r, res in enumerate(ranks):
        agg = res["agg"]
        assert agg["overflow"] == 0 and agg["tile_size"] == tile, r
        assert_close(agg["runs"][0]["out"], out_ref, f"rank {r} out")


@pytest.mark.parametrize("group", worker.GROUPS)
@pytest.mark.parametrize("ranks", AGG_MESHES, indirect=True)
def test_sharded_aggregate_grads_match_unsharded(ranks, group):
    """Each of the six gradients, on every rank, against the unsharded
    path (the tolerance of tests/test_parallel.py's sharded aggregation)."""
    _, g_ref, _, _ = port_aggregate(AGG)
    for r, res in enumerate(ranks):
        assert_close(res["agg"]["runs"][0]["grads"][group], g_ref[group],
                     f"rank {r} d{group}", rtol=3e-4, atol=1e-4)


@pytest.mark.parametrize("ranks", AGG_MESHES, indirect=True)
def test_sharded_aggregate_bitwise_repeatable(ranks):
    """Two runs on the same ranks give the same bits: the slot placement's
    backward is a gather and the sums are fixed-order all-reduces."""
    for res in ranks:
        a, b = res["agg"]["runs"]
        np.testing.assert_array_equal(a["out"], b["out"])
        for k in worker.GROUPS:
            np.testing.assert_array_equal(a["grads"][k], b["grads"][k])


# ---------------------------------------------------------------------------
# 5-6. PIGS steps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("grad_chunks", [1, 2])
def test_replicated_pigs_step_grads_match_jax(world4, grad_chunks):
    """The (2, 2) data-parallel step's gradients, before the optimizer,
    against jax.grad of dgs_tpu's pigs_loss on the union of the ranks'
    points (method "dense"); its loss against that loss."""
    l_ref, g_ref = jax_pigs_loss_grads(PIGS)
    for r, res in enumerate(world4):
        got = res["pigs"][grad_chunks]
        assert got["metrics"]["loss"] == pytest.approx(l_ref, rel=1e-5), r
        for k in worker.FIELD:
            assert_close(got["grads"][k], g_ref[k], f"rank {r} d{k}",
                         rtol=GRAD_RTOL)


@pytest.mark.parametrize("grad_chunks", [1, 2])
def test_replicated_pigs_step_matches_unsharded_step(world4, grad_chunks):
    """After one SGD step the replicated parameters equal those of the
    port's unsharded pigs.train_step on the union of the points."""
    metrics, _, params = port_pigs_step(PIGS)
    for r, res in enumerate(world4):
        got = res["pigs"][grad_chunks]
        assert got["metrics"]["loss"] == pytest.approx(
            float(metrics["loss"]), rel=1e-5), r
        for k in tpigs.DIAGNOSTICS:
            assert got["metrics"][k] == 0, (r, k)
        for k in worker.FIELD:
            assert_close(got["params"][k], params[k], f"rank {r} {k}",
                         rtol=1e-4, atol=1e-6)


MODEL_MESHES = ["1x2", "2x2", "1x4"]


def _assembled(ranks, mesh_name, key):
    """The whole field's rows of ``key`` from the ranks' model blocks (the
    data rows agree; the first rank of each model coordinate is taken)."""
    blocks = {}
    for res in ranks:
        got = res["model_pigs"][mesh_name]
        blocks.setdefault(got["model"], got[key])
    return {k: np.concatenate([blocks[m][k] for m in sorted(blocks)])
            for k in worker.FIELD}


@pytest.mark.parametrize("ranks", MODEL_MESHES, indirect=True)
def test_model_sharded_pigs_gradient_is_unsharded(ranks, request):
    """The model-sharded step's gradients (before the SGD update; Adam
    would hide a constant factor) equal the port's unsharded gradient on
    the union of the points, not M times it, at M = 2 and 4.

    dgs_tpu's make_model_sharded_pigs_step returns M times the unsharded
    gradient (its loss_and_grad takes jax.value_and_grad inside a
    shard_map whose psum over "model" transposes to another psum); its own
    test compares after Adam, which is scale-invariant.  This test holds
    the port to the unsharded gradient."""
    mesh_name = request.node.callspec.params["ranks"]
    _, g_ref, _ = port_pigs_step(PIGS)
    got = _assembled(ranks, mesh_name, "grads")
    for k in worker.FIELD:
        assert_close(got[k], g_ref[k], f"d{k}", rtol=GRAD_RTOL)
        ratio = (np.abs(got[k]).sum() / np.abs(g_ref[k]).sum())
        assert ratio == pytest.approx(1.0, rel=1e-3), (k, ratio)


@pytest.mark.parametrize("ranks", MODEL_MESHES, indirect=True)
def test_model_sharded_pigs_step_matches_dgs_tpu_loss(ranks, request):
    """Loss and gradients against jax.grad of dgs_tpu's pigs_loss on the
    same points; the updated shards, assembled, equal the unsharded SGD
    step's parameters."""
    mesh_name = request.node.callspec.params["ranks"]
    l_ref, g_ref = jax_pigs_loss_grads(PIGS)
    for r, res in enumerate(ranks):
        assert res["model_pigs"][mesh_name]["metrics"]["loss"] == \
            pytest.approx(l_ref, rel=1e-5), r
    got = _assembled(ranks, mesh_name, "grads")
    for k in worker.FIELD:
        assert_close(got[k], g_ref[k], f"d{k}", rtol=GRAD_RTOL)
    _, _, params = port_pigs_step(PIGS)
    got = _assembled(ranks, mesh_name, "params")
    for k in worker.FIELD:
        assert_close(got[k], params[k], k, rtol=1e-4, atol=1e-6)


# ---------------------------------------------------------------------------
# 7. The sharded dynamics step
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def port_dynamics():
    """The port's unsharded counterpart: models.dynamics.rollout_step over
    the unsharded structure, the L2 loss, Adam; (losses, parameters)."""
    c = DYNAMICS
    t = {k: torch.from_numpy(v) for k, v in c["arrays"].items()}
    cfg, plan = tagg.plan_pallas(TConfig(**c["cfg"]), t["means"], t["radii"])
    agg = tagg.preprocess_pallas(cfg, t["means"], t["conics"], t["radii"],
                                 plan)
    params = tdyn.DynamicsParams.from_numpy(*c["params"], device="cpu")
    opt = torch.optim.Adam(list(params), lr=c["lr"], eps=1e-8)
    losses = []
    for _ in range(c["steps"]):
        opt.zero_grad(set_to_none=True)
        v = t["values0"]
        for _ in range(c["rollout"]):
            v = tdyn.rollout_step(params, v, agg, ladder=True)
        loss = torch.mean((v - t["target"]) ** 2)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    return losses, [p.detach().numpy() for p in params]


def test_sharded_dynamics_losses_match_unsharded(world2):
    losses, _ = port_dynamics()
    for r, res in enumerate(world2):
        assert res["dynamics"]["overflow"] == 0, r
        np.testing.assert_allclose(res["dynamics"]["losses"], losses,
                                   rtol=1e-5, err_msg=f"rank {r}")


@pytest.mark.parametrize("index", range(5))
def test_sharded_dynamics_params_match_unsharded(world2, index):
    """Each updated parameter group after two Adam steps, on both ranks."""
    _, params = port_dynamics()
    for r, res in enumerate(world2):
        assert_close(res["dynamics"]["params"][index], params[index],
                     f"rank {r} group {index}", rtol=1e-4, atol=1e-6)


# ---------------------------------------------------------------------------
# 8. Set-up
# ---------------------------------------------------------------------------


def test_initialize_distributed_is_a_noop_in_one_process(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    tmesh.initialize_distributed()
    monkeypatch.setenv("WORLD_SIZE", "1")
    tmesh.initialize_distributed()
    assert not torch.distributed.is_initialized()


def test_make_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="process group"):
        tmesh.make_mesh((1, 1), "cpu")


def test_make_mesh_refuses_a_shape_off_the_world_size(world4):
    assert all(res["refused"] for res in world4)


def test_mesh_coordinates_are_model_fastest(world4):
    """Rank r of a (2, 2) mesh sits at (r // 2, r % 2), as jax.make_mesh
    lays devices out."""
    assert [tuple(res["coords"]) for res in world4] == [(0, 0), (0, 1),
                                                        (1, 0), (1, 1)]


def test_shard_rows_refuses_uneven_blocks():
    x = torch.arange(10)
    assert tmesh.shard_rows(x, 5, 3).tolist() == [6, 7]
    with pytest.raises(ValueError, match="equal shards"):
        tmesh.shard_rows(x, 4, 0)
