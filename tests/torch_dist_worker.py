"""Rank-side code of the port's distributed tests.

Imports torch and dgs_tpu_torch only: a worker started with the ``spawn``
method imports this module afresh, and must not import JAX.  ``spawn``
runs one of TASKS on ``world_size`` CPU processes joined under gloo (one
thread each, a file store in the test's own directory) and returns each
rank's result; the test asserts on them in the parent, against dgs_tpu and
the port's unsharded paths.  Payloads are numpy arrays made by the parent
from its seeds.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

GROUPS = ("features", "transform", "queries", "keys", "frequencies",
          "distance_transform")
FIELD = ("means", "log_scales", "rotations", "values")


def _entry(rank, world_size, store, out_dir, task, payload):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world_size)
    try:
        result = TASKS[task](payload)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(task: str, world_size: int, payload, tmp_dir, timeout=300.0):
    """[rank 0's result, rank 1's, ...] of TASKS[task](payload) run on
    ``world_size`` spawned ranks.  A rank that raises fails the call with
    its traceback; ranks still running after ``timeout`` seconds are
    killed and the call raises TimeoutError."""
    out_dir = os.path.join(str(tmp_dir), f"{task}_{world_size}")
    os.makedirs(out_dir)
    ctx = mp.start_processes(
        _entry, args=(world_size, os.path.join(out_dir, "store"), out_dir,
                      task, payload),
        nprocs=world_size, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=5.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{task} on {world_size} ranks ran past "
                                   f"{timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                       weights_only=False) for r in range(world_size)]


def _coords(mesh):
    return mesh.get_local_rank("data"), mesh.get_local_rank("model")


def _tensors(d):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}


def _eval(mesh, case):
    """The gathered outputs of sharded_sample_all and the rank's
    diagnostics."""
    from dgs_tpu_torch.config import SamplerConfig
    from dgs_tpu_torch.parallel import mesh as pm

    t = _tensors(case["arrays"])
    outs, diag = pm.sharded_sample_all(
        SamplerConfig(**case["cfg"]), mesh, t["means"], t["values"],
        t["conics"], t["covs"], t["samples"], orders=case["orders"],
        method=case["method"])
    whole = pm.gather_samples(outs, mesh)
    return {"outs": {k: v.numpy() for k, v in whole.items()},
            "bin_overflow": int(diag["bin_overflow"]),
            "entry_overflow": int(diag["entry_overflow"])}


def _skewed(mesh, case):
    """A cloud whose model shards bin very differently: the tiled
    evaluation under the whole cloud's plan (the rank's entry overflow),
    then under plan_sharded_config's (its config, overflow and the
    gathered outputs)."""
    import dataclasses

    from dgs_tpu_torch.config import SamplerConfig
    from dgs_tpu_torch.parallel import mesh as pm
    from dgs_tpu_torch.utils import native

    t = _tensors(case["arrays"])
    base = SamplerConfig(**case["cfg"])
    whole = native.config_from_plan(
        base, native.plan_capacities(base, t["means"], t["covs"],
                                     t["samples"]), t["means"].shape[0])
    planned = pm.plan_sharded_config(base, mesh, t["means"], t["covs"],
                                     t["samples"])
    gauss = (t["means"], t["values"], t["conics"], t["covs"], t["samples"])
    _, diag = pm.sharded_sample_all(whole, mesh, *gauss, case["orders"])
    res = _eval(mesh, {**case, "cfg": dataclasses.asdict(planned)})
    return {**res, "model": _coords(mesh)[1],
            "whole_entry_overflow": int(diag["entry_overflow"]),
            "cfg": dataclasses.asdict(planned)}


def _eval_grads(mesh, case):
    """Loss sum(o^2) over every output of sharded_sample_all and its
    gradients to (means, values, conics), summed over the mesh: the
    gradient of the global loss."""
    from dgs_tpu_torch.config import SamplerConfig
    from dgs_tpu_torch.parallel import mesh as pm

    t = _tensors(case["arrays"])
    leaves = [t[k].requires_grad_() for k in ("means", "values", "conics")]
    outs, _ = pm.sharded_sample_all(
        SamplerConfig(**case["cfg"]), mesh, *leaves, t["covs"],
        t["samples"], orders=case["orders"], method=case["method"])
    loss = sum((o * o).sum() for o in outs.values())
    loss.backward()
    # The global loss is the sum of the data rows' losses: its gradient is
    # the ranks' mean gradient times their number (a power of 2: exact).
    pm.all_reduce_gradients(leaves, mesh)
    total = loss.detach().clone()
    dist.all_reduce(total, group=mesh.get_group("data"))
    return {"loss": float(total),
            "grads": [x.grad.numpy() * mesh.size() for x in leaves]}


def _field_state(field):
    return {"grads": {k: getattr(field, k).grad.numpy() for k in FIELD},
            "params": {k: getattr(field, k).detach().numpy() for k in FIELD}}


def _pigs_replicated(mesh, case, grad_chunks):
    """One make_sharded_pigs_step under SGD on the rank's block (over both
    axes) of the payload's points: gradients (before the update), updated
    parameters, metrics."""
    from dgs_tpu_torch.config import SamplerConfig
    from dgs_tpu_torch.models import pigs
    from dgs_tpu_torch.models.field import GaussianField
    from dgs_tpu_torch.parallel import mesh as pm

    u_star, f_rhs = pigs.manufactured_solution(2)
    field = GaussianField.from_numpy(*case["field"], device="cpu")
    pm.replicate(field, mesh)
    opt = torch.optim.SGD(field.parameters(), lr=case["lr"])
    step = pm.make_sharded_pigs_step(
        SamplerConfig(**case["cfg"]), mesh, f_rhs, u_star, method="dense",
        grad_chunks=grad_chunks)
    t = _tensors(case["points"])
    metrics = step(field, opt, pm.shard_samples(t["collocation"], mesh),
                   pm.shard_samples(t["data_x"], mesh))
    return {**_field_state(field),
            "metrics": {k: float(v) for k, v in metrics.items()}}


def _pigs_model_sharded(mesh, case):
    """One make_model_sharded_pigs_step under SGD: the rank's model block
    of the gradients (before the update) and of the updated parameters;
    the model ranks of a data row take that row's block of the points."""
    from dgs_tpu_torch.config import SamplerConfig
    from dgs_tpu_torch.models import pigs
    from dgs_tpu_torch.models.field import GaussianField
    from dgs_tpu_torch.parallel import mesh as pm

    u_star, f_rhs = pigs.manufactured_solution(2)
    step, shard_field = pm.make_model_sharded_pigs_step(
        SamplerConfig(**case["cfg"]), mesh, f_rhs, u_star, method="dense")
    shard = shard_field(GaussianField.from_numpy(*case["field"],
                                                 device="cpu"))
    opt = torch.optim.SGD(shard.parameters(), lr=case["lr"])
    d, m = _coords(mesh)
    n_data = mesh.size(0)
    t = _tensors(case["points"])
    metrics = step(shard, opt, pm.shard_rows(t["collocation"], n_data, d),
                   pm.shard_rows(t["data_x"], n_data, d))
    return {**_field_state(shard), "model": m,
            "metrics": {k: float(v) for k, v in metrics.items()}}


def _aggregate(mesh, case):
    """sharded_aggregate over the rank's tile-range structure (one a model
    rank): outputs and the six gradients of sum(out cos(out)), twice."""
    from dgs_tpu_torch.config import SamplerConfig
    from dgs_tpu_torch.parallel import mesh as pm

    t = _tensors(case["arrays"])
    n_model = mesh.size(1)
    cfg2, _, agg = pm.build_sharded_aggregation(
        SamplerConfig(**case["cfg"]), t["means"], t["conics"], t["radii"],
        n_model, _coords(mesh)[1])
    runs = []
    for _ in range(2):
        leaves = [_tensors(case["params"])[k].requires_grad_()
                  for k in GROUPS]
        out = pm.sharded_aggregate(mesh, *leaves, agg)
        (out * torch.cos(out)).sum().backward()
        runs.append({"out": out.detach().numpy(),
                     "grads": {k: x.grad.numpy()
                               for k, x in zip(GROUPS, leaves)}})
    return {"runs": runs, "overflow": int(agg.overflow),
            "tile_size": cfg2.tile_size}


def _dynamics(mesh, case):
    """Two make_sharded_dynamics_step steps under Adam: the losses and the
    updated parameter groups."""
    from dgs_tpu_torch.config import SamplerConfig
    from dgs_tpu_torch.models.dynamics import DynamicsParams
    from dgs_tpu_torch.parallel import mesh as pm

    t = _tensors(case["arrays"])
    _, _, agg = pm.build_sharded_aggregation(
        SamplerConfig(**case["cfg"]), t["means"], t["conics"], t["radii"],
        mesh.size(1), _coords(mesh)[1])
    params = DynamicsParams.from_numpy(*case["params"], device="cpu")
    opt = torch.optim.Adam(list(params), lr=case["lr"], eps=1e-8)
    step = pm.make_sharded_dynamics_step(
        mesh, agg, t["values0"], t["target"], rollout=case["rollout"],
        ladder_frequencies=True)
    losses = [float(step(params, opt)) for _ in range(case["steps"])]
    return {"losses": losses, "overflow": int(agg.overflow),
            "params": [p.detach().numpy() for p in params]}


def _world4(p):
    """Meshes (2, 2) and (1, 4) over four ranks."""
    from dgs_tpu_torch.parallel import mesh as pm

    mesh22 = pm.make_mesh((2, 2), "cpu")
    mesh14 = pm.make_mesh((1, 4), "cpu")
    try:
        pm.make_mesh((3, 1), "cpu")
        refused = False
    except ValueError:
        refused = True
    return {
        "refused": refused,
        "coords": _coords(mesh22),
        "eval": {name: _eval(mesh22, c) for name, c in p["eval"].items()},
        "skewed": _skewed(mesh22, p["skewed"]),
        "eval_grads": {name: _eval_grads(mesh22, c)
                       for name, c in p["eval"].items()},
        "pigs": {k: _pigs_replicated(mesh22, p["pigs"], k) for k in (1, 2)},
        "model_pigs": {"2x2": _pigs_model_sharded(mesh22, p["pigs"]),
                       "1x4": _pigs_model_sharded(mesh14, p["pigs"])},
        "agg": _aggregate(mesh14, p["agg"]),
    }


def _world2(p):
    """Mesh (1, 2) over two ranks."""
    from dgs_tpu_torch.parallel import mesh as pm

    mesh = pm.make_mesh((1, 2), "cpu")
    return {
        "eval": {name: _eval(mesh, c) for name, c in p["eval"].items()},
        "skewed": _skewed(mesh, p["skewed"]),
        "model_pigs": {"1x2": _pigs_model_sharded(mesh, p["pigs"])},
        "agg": _aggregate(mesh, p["agg"]),
        "dynamics": _dynamics(mesh, p["dynamics"]),
    }


TASKS = {"world4": _world4, "world2": _world2}


def _env_rank():
    """The two-process check of test_torch_multiprocess.py: the process
    group from torchrun's environment (initialize_distributed), one global
    mesh (1, 2), the dense evaluation's loss and gradient norm."""
    import json
    import sys

    from dgs_tpu_torch.config import SamplerConfig
    from dgs_tpu_torch.parallel import mesh as pm

    torch.set_num_threads(1)
    pm.initialize_distributed(backend="gloo")
    try:
        mesh = pm.make_mesh((1, 2), "cpu")
        arrays = np.load(sys.argv[2])
        case = {"cfg": {}, "orders": ("value", "derivative"),
                "method": "dense", "arrays": dict(arrays)}
        r = _eval_grads(mesh, case)
        gnorm = sum(float((g.astype(np.float64) ** 2).sum())
                    for g in r["grads"])
        print("RESULT " + json.dumps({"rank": dist.get_rank(),
                                      "loss": r["loss"], "gnorm": gnorm}))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    import sys

    {"env_rank": _env_rank}[sys.argv[1]]()
