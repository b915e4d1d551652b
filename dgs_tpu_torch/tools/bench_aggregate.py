"""Neighbour-aggregation benchmark: the structure build, and aggregation
forward + backward over all six parameter groups, in Gaussians a second.

The counterpart of tools/bench_aggregate.py, with its defaults: P = 100k,
D = 2, L = K = 8, nfreq 4, sigma 2 / sqrt(P), tile 0.051 (the plan
matches it to the collision radii), 10 steps.  AGG_METHOD=pallas (the
default) runs the CUDA aggregation kernels (``plan_pallas``,
``preprocess_pallas``, ``aggregate_pallas``); AGG_METHOD=xla runs the
port's plain path (``suggest_grid_capacities``, ``preprocess_grid``,
``aggregate``) and its records say ``"method": "plain"``.  AGG_LADDER=1
takes the integer-laddered frequencies and the kernels' angle-addition
recurrence.

The structure build is timed with each build's means moved by 1e-12
times a column of the one before (the dependency from one build to the
next), the training step with every group moved by -1e-12 times its
gradient; each on the synchronised host clock, median and range, with
device busy ms and launches a step beside it.

    python -m dgs_tpu_torch.tools.bench_aggregate

Env: AGG_P, AGG_L, AGG_K, AGG_NFREQ, AGG_STEPS, AGG_SIGMA, AGG_TILE,
AGG_METHOD, AGG_LADDER and AGG_DEVICE (default cuda).  AGG_BN / AGG_BE
size the TPU layout's blocks and raise _common.UnsupportedKnob, as do the
other TPU-only knobs.
"""

from __future__ import annotations

import os
from typing import Callable, NamedTuple

import torch

from ..config import SamplerConfig
from ..models.field import init_field
from ..ops import aggregation
from ..oracle.dense import radii as compute_radii
from . import _common

GROUPS = ("features", "transform", "queries", "keys", "frequencies",
          "distance_transform")


def settings(env=None) -> dict:
    env = os.environ if env is None else env
    _common.refuse(env)
    P = int(env.get("AGG_P", 100_000))
    method = env.get("AGG_METHOD", "pallas")
    if method not in ("pallas", "xla"):
        raise ValueError(f"AGG_METHOD={method}: pallas or xla")
    return dict(P=P, D=2, L=int(env.get("AGG_L", 8)),
                K=int(env.get("AGG_K", 8)),
                nfreq=int(env.get("AGG_NFREQ", 4)),
                steps=int(env.get("AGG_STEPS", 10)),
                sigma=float(env.get("AGG_SIGMA", 2.0 / max(P, 1) ** 0.5)),
                tile=float(env.get("AGG_TILE", 0.051)), eig_floor=1e-12,
                method=method, ladder=env.get("AGG_LADDER", "0") == "1",
                device=env.get("AGG_DEVICE", "cuda"))


class Structure(NamedTuple):
    """The method's structure build and aggregation call."""

    pre: Callable        # (means, conics) -> structure
    dep: Callable        # structure -> the column the next means move by
    agg_fn: Callable     # (six groups..., structure) -> (P, L)
    capacity: int        # the table's width; -1 for the kernels (no table)
    cfg: SamplerConfig   # the tile matched to the collision radii
    plan: tuple          # AggPlan, or (capacity, rect) of the table


def structure(s: dict, cfg, means, rad) -> Structure:
    """The structure of AGG_METHOD: the kernels' (plan_pallas) or the
    plain table's (suggest_grid_capacities)."""
    if s["method"] == "pallas":
        cfg, plan = aggregation.plan_pallas(cfg, means, rad)
        return Structure(
            lambda m, con: aggregation.preprocess_pallas(cfg, m, con, rad,
                                                         plan),
            lambda nbr: nbr.ctr_static[nbr.pos.long(), -1:],
            lambda *args: aggregation.aggregate_pallas(
                *args, period=None, ladder_frequencies=s["ladder"]),
            -1, cfg, plan)
    cfg, nc, rect = aggregation.suggest_grid_capacities(cfg, means, rad)
    return Structure(
        lambda m, con: aggregation.preprocess_grid(cfg, m, con, rad, nc,
                                                   rect),
        lambda nbr: nbr.inv_total_densities[:, None], aggregation.aggregate,
        nc, cfg, (nc, rect))


def steps(s: dict, dev):
    """(structure, nbr, build, train) of tools/bench_aggregate.py's seeded
    cloud (init_field with L channels) and six parameter groups: the
    method's structure, one built from the initial means, and the two
    timed steps.  build() builds a structure from means moved by 1e-12
    times a column of the structure before; train() is the forward and
    backward over all six groups of nbr, each group moved by -1e-12 times
    its gradient, and returns the loss."""
    P, D, L, K, nfreq = s["P"], s["D"], s["L"], s["K"], s["nfreq"]
    gen = torch.Generator(device=dev).manual_seed(0)
    field = init_field(gen, P, D, L, sigma=s["sigma"])
    E = nfreq * D * 2 + 1

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    params = dict(
        features=normal(P, L) * 0.1, transform=normal(L, L) * 0.1,
        queries=normal(P, K) * 0.1, keys=normal(P, K) * 0.1,
        frequencies=(torch.arange(1, nfreq + 1, dtype=torch.float32,
                                  device=dev) if s["ladder"]
                     else normal(nfreq).abs() + 0.5),
        distance_transform=normal(2 * E) * 0.1)
    params = [params[g].requires_grad_() for g in GROUPS]
    with torch.no_grad():
        means, cov, con = (field.means.detach(), field.covariances(),
                           field.conics())
    cfg = SamplerConfig(tile_size=s["tile"], eig_floor=s["eig_floor"])
    rad = compute_radii(cov, D, cfg.radius_sigma, cfg.eig_floor)
    st = structure(s, cfg, means, rad)
    nbr = st.pre(means, con)
    moved = [means]

    def build():
        got = st.pre(moved[0], con)
        moved[0] = moved[0] + 1e-12 * st.dep(got)
        return got

    def train():
        for p in params:
            p.grad = None
        out = st.agg_fn(*params, nbr)
        value = torch.sum(out * out)
        value.backward()
        with torch.no_grad():
            for p in params:
                p.sub_(1e-12 * p.grad)
        return value.detach()

    return st, nbr, build, train


def run(s: dict) -> list:
    dev = _common.torch_device(s["device"], "AGG_DEVICE")
    st, nbr, build, train = steps(s, dev)
    last, t_pre = _common.time_steps(build, s["steps"], dev)
    busy_pre = _common.activity(build, min(s["steps"], 5), dev)
    value, t_fb = _common.time_steps(train, s["steps"], dev)
    busy_fb = _common.activity(train, min(s["steps"], 5), dev)
    over = int(last.overflow)
    if over or int(nbr.overflow):
        raise RuntimeError(f"aggregation overflow: {over}, "
                           f"{int(nbr.overflow)}")
    P, card = s["P"], _common.card(dev)
    method = "pallas" if s["method"] == "pallas" else "plain"
    return [
        {"metric": "aggregation_preprocess_gaussians_per_sec",
         "value": P / (t_pre["ms_median"] / 1e3), "unit": "gaussians/s",
         "step_s": t_pre["ms_median"] / 1e3, "step_ms_min": t_pre["ms_min"],
         "step_ms_max": t_pre["ms_max"],
         "busy_ms_per_step": busy_pre["busy_ms"],
         "device_launches_per_step": busy_pre["launches"],
         "neighbor_capacity": st.capacity, "tile": st.cfg.tile_size,
         "overflow": over, "method": method, **card},
        {"metric": "aggregation_fwd_bwd_gaussians_per_sec",
         "value": P / (t_fb["ms_median"] / 1e3), "unit": "gaussians/s",
         "step_s": t_fb["ms_median"] / 1e3, "step_ms_min": t_fb["ms_min"],
         "step_ms_max": t_fb["ms_max"],
         "busy_ms_per_step": busy_fb["busy_ms"],
         "device_launches_per_step": busy_fb["launches"],
         "P": P, "L": s["L"], "K": s["K"], "nfreq": s["nfreq"],
         "method": method, "ladder": s["ladder"], "loss": float(value),
         **card},
    ]


def main():
    _common.print_records(run(settings()))


if __name__ == "__main__":
    main()
