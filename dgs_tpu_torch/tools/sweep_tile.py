"""Tile-size sweep of the tiled sampling path on the card.

The counterpart of tools/sweep_tile.py.  Pairs grow as (tile + 2r)^D and
the per-entry costs (the binning's sorts and gathers, the segment-sum) as
the entry count P (1 + 2r / tile)^D; the port's per-entry costs are not the
TPU's, so where the trade sits is measured here.  Its defaults: SWEEP_D 2,
P = 100k, N = 1M, C = 4, sigma 2 / P^(1/D), the isotropic radius box,
SWEEP_STEPS 5, the tiles 0.051, 0.04, 0.032, 0.025 at D = 2 (0.02, 0.01
at D = 1; 0.25, 0.2, 0.167 at D = 3).  Each tile is planned anew by the
host planner (``utils.native.plan_capacities``, R and the entry capacity)
and timed as tools.bench's training step.

One JSON line a tile: entries, kept pairs, R, ms a step (median and
range of the synchronised host clock), device busy ms, Msamples/s, peak
bytes and the diagnostics.  A tile that cannot be planned or run (the
planner refuses it, a ValueError of the op, the card's memory) is a row
that says SKIP with the reason; the sweep goes on.  The segment-sum's R^D
bound holds by construction: the plan's R is the largest footprint's.

    python -m dgs_tpu_torch.tools.sweep_tile

Env: SWEEP_D, SWEEP_P, SWEEP_N, SWEEP_STEPS, SWEEP_TILES (comma list),
SWEEP_ORDERS and SWEEP_DEVICE (default cuda).  SWEEP_BLOCKS sweeps the TPU
kernels' block sizes and raises _common.UnsupportedKnob: the port reads no
block size.
"""

from __future__ import annotations

import os

import torch

from . import _common, bench

DEFAULT_TILES = {1: "0.02,0.01", 2: "0.051,0.04,0.032,0.025",
                 3: "0.25,0.2,0.167"}


def settings(env=None) -> dict:
    env = os.environ if env is None else env
    _common.refuse(env)
    D = int(env.get("SWEEP_D", 2))
    P = int(env.get("SWEEP_P", 100_000))
    return dict(
        D=D, P=P, N=int(env.get("SWEEP_N", 1_000_000)), C=4,
        steps=int(env.get("SWEEP_STEPS", 5)),
        sigma=2.0 / max(P, 1) ** (1.0 / D),
        tiles=[float(t) for t in
               env.get("SWEEP_TILES", DEFAULT_TILES[D]).split(",")],
        R=4, eig_floor=1e-12, axis_radii=False, ellip_cull=False,
        orders=tuple(env.get("SWEEP_ORDERS",
                             bench.DEFAULT_ORDERS).split(",")),
        device=env.get("SWEEP_DEVICE", "cuda"))


def sweep(s: dict, tool: str, method: str, row_of) -> list:
    """One record a tile of s["tiles"]: the workload of ``s`` at that tile
    planned by ``method``, timed by tools.bench.measure and described by
    row_of(workload); a SKIP record where planning or measuring refuses
    the tile."""
    dev = _common.torch_device(s["device"], "SWEEP_DEVICE")
    field, samples = bench.field_and_samples(s["P"], s["N"], s["D"], s["C"],
                                             s["sigma"], dev)
    card = _common.card(dev)
    records = []
    for tile in s["tiles"]:
        head = {"tool": tool, "D": s["D"], "P": s["P"], "N": s["N"],
                "tile": tile}
        try:
            w = bench.plan(bench.config({**s, "tile": tile}), method, field,
                           samples, s["orders"])
            m = bench.measure(w, s["steps"], dev)
        except (ValueError, torch.OutOfMemoryError) as e:
            records.append({**head, "skip": f"{type(e).__name__}: {e}",
                            **card})
            continue
        records.append({
            **head, **row_of(w), "ms_per_step": m["ms_median"],
            "ms_min": m["ms_min"], "ms_max": m["ms_max"],
            "busy_ms_per_step": m["busy_ms"],
            "device_launches_per_step": m["launches"],
            "msamples_per_s": s["N"] / m["ms_median"] / 1e3,
            "peak_bytes": m["peak_bytes"], "overflow": m["overflow"],
            **card})
    return records


def run(s: dict) -> list:
    return sweep(s, "sweep_tile", "tiled", lambda w: dict(
        zip(("pairs", "entries"), bench.kept_pairs(w)),
        R=w.cfg.max_tiles_per_gaussian))


def main():
    _common.print_records(run(settings()))


if __name__ == "__main__":
    main()
