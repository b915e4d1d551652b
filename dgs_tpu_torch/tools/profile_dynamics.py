"""The two halves of the config-4 dynamics training step, timed apart, and
the device time by kernel and by function of one of them.

The counterpart of tools/profile_dynamics.py: P = 100k Gaussians at
sigma * 3, one channel, the frequency ladder.

  rollout  DYN_ROLLOUT (2) residual updates through ``aggregate_pallas``
           (kernels 6 and 7, the segment-sum), the sum of squares of each
           depth's values, backward() to the parameter groups and the
           values, every one moved by -1e-12 times its gradient;
  eval     the DYN_EVAL (65,536) point tiled evaluation of the stacked
           depths (kernels 1 and 2, the segment-sum) at fresh uniform
           points a step, backward() to the values, moved likewise.

The two halves plan apart, as models.dynamics.train plans them: the
aggregation structure by ``plan_pallas`` (its tile matched to the collision
radii, or DYN_AGG_TILE as given), the evaluation by ``make_value_eval``
(the T100K_DTILE tile shrunk to the cloud, capacities from the host
planner, the Gaussian side binned once).  Each half is timed over 4 steps
after one warm-up on the synchronised host clock (median and range) with
device busy ms and launches a step.  Then DYN_PROFILE=eval (the default)
or rollout is profiled over 4 steps: one JSON line a device item and one
a scope (see tools.profile_step), the PROF_TOP (default 18, the JAX tool's
count) largest of each; DYN_PROFILE=none profiles neither.  The Chrome
trace goes to PROF_DIR when it is set, else to a temporary directory.

    python -m dgs_tpu_torch.tools.profile_dynamics

Env: DYN_P, DYN_EVAL, DYN_ROLLOUT, DYN_PROFILE, DYN_AGG_TILE,
T100K_DTILE, BENCH_AXIS, BENCH_ELLIP and DYN_DEVICE (default cuda).
tools/profile_dynamics.py passes the TPU's span 2 to its config; the port
has no span and leaves it out.
"""

from __future__ import annotations

import dataclasses
import os

import torch

from ..config import SamplerConfig
from ..models import dynamics
from ..models.field import init_field
from ..ops import aggregation
from ..oracle.dense import radii as compute_radii
from . import _common

STEPS = 4


def settings(env=None) -> dict:
    env = os.environ if env is None else env
    _common.refuse(env)
    P = int(env.get("DYN_P", 100_000))
    which = env.get("DYN_PROFILE", "eval")
    if which not in ("rollout", "eval", "none"):
        raise ValueError(f"DYN_PROFILE={which}: rollout, eval or none")
    agg_tile = env.get("DYN_AGG_TILE")
    return dict(P=P, D=2, n_eval=int(env.get("DYN_EVAL", 65_536)),
                rollout=int(env.get("DYN_ROLLOUT", 2)),
                sigma=3.0 * 2.0 / max(P, 1) ** 0.5, which=which,
                agg_tile=None if agg_tile is None else float(agg_tile),
                tile=float(env.get("T100K_DTILE", 0.51)), eig_floor=1e-12,
                axis_radii=env.get("BENCH_AXIS", "1") == "1",
                ellip_cull=env.get("BENCH_ELLIP", "1") == "1",
                top=int(env.get("PROF_TOP", 18)),
                prof_dir=env.get("PROF_DIR"),
                device=env.get("DYN_DEVICE", "cuda"))


def run(s: dict) -> list:
    dev = _common.torch_device(s["device"], "DYN_DEVICE")
    P, D = s["P"], s["D"]
    gen = torch.Generator(device=dev).manual_seed(0)
    field = init_field(gen, P, D, 1, sigma=s["sigma"])
    with torch.no_grad():
        means, con = field.means.detach(), field.conics()
        rad = compute_radii(field.covariances(), D, 3.0, s["eig_floor"])
    cfg = SamplerConfig(eig_floor=s["eig_floor"], tile_size=s["tile"],
                        axis_radii=s["axis_radii"],
                        ellip_cull=s["ellip_cull"]).with_dims(D)
    if s["agg_tile"] is not None:
        cfg_a, aplan = aggregation.plan_pallas(
            dataclasses.replace(cfg, tile_size=s["agg_tile"]), means, rad,
            auto_tile=False)
    else:
        cfg_a, aplan = aggregation.plan_pallas(cfg, means, rad)
    nbr = aggregation.preprocess_pallas(cfg_a, means, con, rad, aplan)
    params = list(dynamics.init_dynamics_params(gen, P, 1, D, ladder=True))
    eval_u = dynamics.make_value_eval(cfg, field, "tiled",
                                      n_eval=s["n_eval"], with_overflow=True,
                                      padded=True)
    values = field.values.detach().clone().requires_grad_()
    V = torch.cat([field.values.detach()] * s["rollout"],
                  dim=1).requires_grad_()

    def rollout_half():
        leaves = params + [values]
        for p in leaves:
            p.grad = None
        v, stacked = values, []
        for _ in range(s["rollout"]):
            v = dynamics.rollout_step(dynamics.DynamicsParams(*params), v,
                                      nbr, ladder=True)
            stacked.append(v)
        sum(torch.sum(x * x) for x in stacked).backward()
        with torch.no_grad():
            for p in leaves:
                p.sub_(1e-12 * p.grad)

    def eval_half():
        V.grad = None
        x = 2.0 * torch.rand((s["n_eval"], D), generator=gen,
                             device=dev) - 1.0
        u, _, of = eval_u(V, x)
        torch.sum(u * u).backward()
        with torch.no_grad():
            V.sub_(1e-12 * V.grad)
        return of

    _, t_r = _common.time_steps(rollout_half, STEPS, dev)
    act_r = _common.activity(rollout_half, STEPS, dev)
    of, t_e = _common.time_steps(eval_half, STEPS, dev)
    act_e = _common.activity(eval_half, STEPS, dev)
    over = {"nbr_overflow": int(nbr.overflow), "eval_overflow": int(of)}
    if any(over.values()):
        raise RuntimeError(f"dynamics overflow: {over}")
    card = _common.card(dev)
    records = [{
        "tool": "profile_dynamics", "agg_tile": cfg_a.tile_size,
        "agg_plan": list(aplan), "rollout_ms": t_r["ms_median"],
        "rollout_ms_min": t_r["ms_min"], "rollout_ms_max": t_r["ms_max"],
        "rollout_busy_ms": act_r["busy_ms"],
        "rollout_launches": act_r["launches"], "eval_ms": t_e["ms_median"],
        "eval_ms_min": t_e["ms_min"], "eval_ms_max": t_e["ms_max"],
        "eval_busy_ms": act_e["busy_ms"], "eval_launches": act_e["launches"],
        "P": P, "n_eval": s["n_eval"], "rollout": s["rollout"], **over,
        **card}]
    if s["which"] != "none":
        half = eval_half if s["which"] == "eval" else rollout_half
        ops, scopes, gaps = _common.profile_ops(half, STEPS, s["top"],
                                                s["prof_dir"], dev)
        records += [{"tool": "profile_dynamics", "profile": s["which"], **r,
                     **card} for r in ops + scopes + gaps]
    return records


def main():
    _common.print_records(run(settings()))


if __name__ == "__main__":
    main()
