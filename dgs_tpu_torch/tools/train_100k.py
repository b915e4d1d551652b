"""Config 4 at spec on the card: PIGS training at P = 100k (phase A), then
the dynamics net at P = 100k (phase B).

The counterpart of tools/train_100k.py.  Phase A is ``models.pigs.train``:
100k Gaussians, 300 steps, 262,144 collocation points (and a quarter as
many data points) redrawn every step, Adam at lr 2e-3, tile 0.051 with
per-axis radii and the ellipsoid cull, a history record every
min(steps // 6, 32) steps.  Phase B is ``models.dynamics.train`` with
the aggregation kernels (``method="pallas"``), the tiled evaluation,
rollout 2, sigma * 3, 65,536 evaluation points a step, the frequency
ladder and T100K_DCHUNK steps a history record.  The JAX tool's checks
stay and raise (``check``): every overflow diagnostic 0, the PIGS loss at
least halves, the dynamics loss falls.

The step time of a phase is the minimum over its warm history records
(the first pays the kernel build), as the JAX tool takes it, with their
median beside it; each is a record's synchronised wall time a step.  The
device busy time of these steps is measured by tools.profile_dynamics and
chip_smoke.py's profile phase, which hold the steps themselves.

tools/train_100k.py defaults BENCH_SPAN_F/B to 2, the TPU's span-packed
work list; both phases' configs carry the same spans, which the port's
kernels do not read.

    python -m dgs_tpu_torch.tools.train_100k

Env: T100K_P, T100K_STEPS, T100K_COLLOC, T100K_DSTEPS, T100K_EVAL,
T100K_TILE, T100K_DTILE (the evaluation's tile before make_value_eval
shrinks it to the cloud), T100K_DCHUNK, T100K_SKIP_A (skip phase A),
BENCH_AXIS, BENCH_ELLIP and T100K_DEVICE (default cuda).
"""

from __future__ import annotations

import os
import statistics
import time

from ..config import SamplerConfig
from ..models import dynamics, pigs
from . import _common


def settings(env=None) -> dict:
    env = os.environ if env is None else env
    _common.refuse(env)
    P = int(env.get("T100K_P", 100_000))
    return dict(
        P=P, steps=int(env.get("T100K_STEPS", 300)),
        n_collocation=int(env.get("T100K_COLLOC", 262_144)),
        d_steps=int(env.get("T100K_DSTEPS", 60)),
        n_eval=int(env.get("T100K_EVAL", 65_536)), D=2,
        sigma=2.0 / max(P, 1) ** 0.5, learning_rate=2e-3, rollout=2,
        tile=float(env.get("T100K_TILE", 0.051)),
        d_tile=float(env.get("T100K_DTILE", 0.51)),
        d_chunk=int(env.get("T100K_DCHUNK", 10)),
        skip_a=bool(env.get("T100K_SKIP_A")), eig_floor=1e-12,
        axis_radii=env.get("BENCH_AXIS", "1") == "1",
        ellip_cull=env.get("BENCH_ELLIP", "1") == "1",
        device=env.get("T100K_DEVICE", "cuda"),
        flags=_common.mode_flags(env, span=2))


def _warm(history, wall, steps):
    warm = [h["t_step_s"] for h in history[1:]] or [wall / steps]
    return min(warm), statistics.median(warm)


def run(s: dict) -> list:
    dev = _common.torch_device(s["device"], "T100K_DEVICE")
    card = _common.card(dev)
    records = []
    if not s["skip_a"]:
        cfg = SamplerConfig(tile_size=s["tile"], eig_floor=s["eig_floor"],
                            axis_radii=s["axis_radii"],
                            ellip_cull=s["ellip_cull"], **s["flags"])
        t0 = time.perf_counter()
        _, history = pigs.train(
            cfg, P=s["P"], D=s["D"], C=1, steps=s["steps"],
            n_collocation=s["n_collocation"],
            learning_rate=s["learning_rate"], sigma=s["sigma"],
            method="tiled", log_every=max(s["steps"] // 6, 1), device=dev)
        wall = time.perf_counter() - t0
        best, median = _warm(history, wall, s["steps"])
        records.append({
            "metric": "pigs_100k_train_step_seconds", "value": best,
            "median_warm_s": median,
            "wall_s_per_step_incl_compile": wall / s["steps"],
            "unit": "s/step", "P": s["P"], "steps": s["steps"],
            "n_collocation": s["n_collocation"],
            "loss_first": history[0]["loss"], "loss_last": history[-1]["loss"],
            "overflow": {k: max(h[k] for h in history)
                         for k in pigs.DIAGNOSTICS},
            "loss_curve": [h["loss"] for h in history], **card})

    cfg_d = SamplerConfig(eig_floor=s["eig_floor"], tile_size=s["d_tile"],
                          axis_radii=s["axis_radii"],
                          ellip_cull=s["ellip_cull"], **s["flags"])
    t0 = time.perf_counter()
    _, dhist = dynamics.train(
        cfg_d, P=s["P"], D=s["D"], steps=s["d_steps"], rollout=s["rollout"],
        sigma=s["sigma"] * 3.0, n_eval=s["n_eval"], method="pallas",
        eval_method="tiled", log_every=max(s["d_steps"] // 6, 1),
        ladder_frequencies=True, scan_chunk=s["d_chunk"], device=dev)
    wall = time.perf_counter() - t0
    best, median = _warm(dhist, wall, s["d_steps"])
    records.append({
        "metric": "dynamics_100k_train_step_seconds", "value": best,
        "median_warm_s": median,
        "wall_s_per_step_incl_compile": wall / s["d_steps"],
        "unit": "s/step", "P": s["P"], "steps": s["d_steps"],
        "rollout": s["rollout"], "n_eval": s["n_eval"],
        "loss_first": dhist[0]["loss"], "loss_last": dhist[-1]["loss"],
        "nbr_overflow": max(h["nbr_overflow"] for h in dhist),
        "eval_overflow": max(h["eval_overflow"] for h in dhist),
        "loss_curve": [h["loss"] for h in dhist], **card})
    return records


def check(records: list) -> None:
    """The JAX tool's checks on run's records, raising: overflow 0 in both
    phases, the PIGS loss at least halved, the dynamics loss fallen."""
    for r in records:
        if r["metric"] == "pigs_100k_train_step_seconds":
            if any(r["overflow"].values()):
                raise RuntimeError(f"PIGS overflow: {r['overflow']}")
            if not r["loss_last"] < 0.5 * r["loss_first"]:
                raise RuntimeError(
                    f"PIGS did not converge: loss {r['loss_first']} -> "
                    f"{r['loss_last']}")
        else:
            if r["nbr_overflow"] or r["eval_overflow"]:
                raise RuntimeError(
                    f"dynamics overflow: neighbours {r['nbr_overflow']}, "
                    f"evaluation {r['eval_overflow']}")
            if not r["loss_last"] < r["loss_first"]:
                raise RuntimeError(
                    f"dynamics loss did not fall: {r['loss_first']} -> "
                    f"{r['loss_last']}")


def main():
    records = run(settings())
    _common.print_records(records)
    check(records)


if __name__ == "__main__":
    main()
