"""Stage times of the headline step: the binning alone, the forward alone,
forward + backward.

The counterpart of tools/profile_bench.py, with its own defaults: D = 2,
C = 4, tile 0.0637, BENCH_R 3, the isotropic radius box, 7 timed calls a
stage.  Its stages:

  binning           binning/grid.build (the Gaussian side and the sample
                    sort), no kernel;
  forward           the loss value (re-binning, kernel 1, the loss) under
                    no_grad;
  forward_backward  the loss, backward() and every parameter moved by
                    -1e-12 times its gradient.

The loss is tools/profile_bench.py's: the multiplicity-weighted sum of
squares of the unique outputs in tile order, unpadded.

Each stage reports its host ms (median and range, synchronised), device
busy ms and device launches a call; the differences of the medians
localise the forward's and the backward's share, as the JAX tool prints
them.  The launches are the count of device items the profiler saw a call:
a stage's launch overhead on the host.

    python -m dgs_tpu_torch.tools.profile_bench

Env: BENCH_P, BENCH_N, BENCH_TILE, BENCH_R, BENCH_SIGMA, BENCH_EIG_FLOOR,
BENCH_DEVICE (default cuda).  Refuses the TPU-only knobs as tools.bench.
"""

from __future__ import annotations

import os

import torch

from ..binning import grid as binning
from ..models import pigs
from ..ops import formulas
from ..utils import native
from . import _common, bench

ORDERS = ("value", "derivative", "laplacian")
REPS = 7


def settings(env=None) -> dict:
    env = os.environ if env is None else env
    _common.refuse(env)
    P = int(env.get("BENCH_P", 100_000))
    return dict(P=P, N=int(env.get("BENCH_N", 1_000_000)), D=2, C=4,
                tile=float(env.get("BENCH_TILE", 0.0637)),
                R=int(env.get("BENCH_R", 3)),
                sigma=float(env.get("BENCH_SIGMA", 2.0 / max(P, 1) ** 0.5)),
                eig_floor=float(env.get("BENCH_EIG_FLOOR", 1e-12)),
                axis_radii=False, ellip_cull=False, method="tiled",
                orders=ORDERS, device=env.get("BENCH_DEVICE", "cuda"))


def stage_loss(cfg, field, samples):
    """tools/profile_bench.py's loss: the multiplicity-weighted sum of
    squares of the unique, tile-sorted outputs."""
    outs, diag = pigs.field_outputs(cfg, field, samples, orders=ORDERS,
                                    method="tiled", sorted_outputs=True,
                                    unique_outputs=True)
    value = sum(torch.einsum("nuc,u->", o * o, torch.tensor(
        formulas.sym_multiplicity(order, 2), dtype=o.dtype,
        device=o.device)) for order, o in outs.items())
    return value, diag


def run(s: dict) -> list:
    dev = _common.torch_device(s["device"], "BENCH_DEVICE")
    field, samples = bench.field_and_samples(s["P"], s["N"], s["D"], s["C"],
                                             s["sigma"], dev)
    cfg = bench.config(s)
    with torch.no_grad():
        plan = native.plan_capacities(cfg, field.means, field.covariances(),
                                      samples)
    cfg = native.config_from_plan(cfg, plan, s["P"])
    params = list(field.parameters())

    def bin_only():
        with torch.no_grad():
            return binning.build(cfg, field.means, field.covariances(),
                                 samples)

    def forward():
        with torch.no_grad():
            return stage_loss(cfg, field, samples)

    def full():
        for p in params:
            p.grad = None
        value, diag = stage_loss(cfg, field, samples)
        value.backward()
        with torch.no_grad():
            for p in params:
                p.sub_(1e-12 * p.grad)
        return value, diag

    card = _common.card(dev)
    records = [{"tool": "profile_bench",
                "plan": {k: int(v) for k, v in plan.items()},
                "tile": cfg.tile_size, **card}]
    medians = {}
    for name, fn in (("binning", bin_only), ("forward", forward),
                     ("forward_backward", full)):
        out, times = _common.time_steps(fn, REPS, dev)
        diag = ({"bin_overflow": out.overflow,
                 "entry_overflow": out.entry_overflow}
                if name == "binning" else out[1])
        over = _common.overflow(diag)
        medians[name] = times["ms_median"]
        records.append({"tool": "profile_bench", "stage": name, **times,
                        **_common.activity(fn, 5, dev), "overflow": over,
                        **card})
    records.append({
        "tool": "profile_bench",
        "forward_kernels_ms": medians["forward"] - medians["binning"],
        "backward_part_ms": medians["forward_backward"] - medians["forward"],
        **card})
    return records


def main():
    _common.print_records(run(settings()))


if __name__ == "__main__":
    main()
