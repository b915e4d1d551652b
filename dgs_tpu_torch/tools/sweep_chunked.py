"""Tile-size sweep of the chunked sampling path on the card.

The counterpart of tools/sweep_chunked.py: each tile of SWEEP_TILES
(default 0.051, 0.04, 0.032, 0.025, 0.02 at D = 2; 0.25, 0.2, 0.16,
0.125, 0.1 at D = 3) planned by ``plan_chunked`` (R = 3 in the config, per-axis
radii under BENCH_AXIS, no cull) and timed as tools.bench's training step
over ``sample_chunked``, at SWEEP_D, SWEEP_P, SWEEP_N, C = 4, sigma
2 / P^(1/D), SWEEP_STEPS steps.  A row reports the plan's R and entry
capacity, the valid entries and kept pairs of a binning under the plan,
ms a step (median and range), device busy ms, Msamples/s, peak bytes and
the diagnostics; the JAX tool's work_fwd / work_bwd count the TPU work
list, which the port does not have.  A tile that cannot be planned or
run is a SKIP row with the reason, and the sweep goes on.  At D = 3 the
finest tiles hold several million entries (tile 0.1: about P 3.6^3):
read the peak bytes before trusting a row.

    python -m dgs_tpu_torch.tools.sweep_chunked

Env: SWEEP_D, SWEEP_P, SWEEP_N, SWEEP_STEPS, SWEEP_TILES, BENCH_AXIS and
SWEEP_DEVICE (default cuda); BENCH_SPAN_F/B (default 1) are accepted and
not read.  SWEEP_BLOCKS and the other TPU-only knobs raise
_common.UnsupportedKnob.
"""

from __future__ import annotations

import os

from . import _common, bench, sweep_tile

DEFAULT_TILES = {2: "0.051,0.04,0.032,0.025,0.02",
                 3: "0.25,0.2,0.16,0.125,0.1"}


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
        R=3, eig_floor=1e-12, axis_radii=env.get("BENCH_AXIS", "1") == "1",
        ellip_cull=False,
        orders=("value", "derivative", "laplacian"),
        device=env.get("SWEEP_DEVICE", "cuda"),
        flags=_common.mode_flags(env))


def run(s: dict) -> list:
    return sweep_tile.sweep(s, "sweep_chunked", "chunked", lambda w: dict(
        zip(("pairs", "entries"), bench.kept_pairs(w)), R=w.plan.rect,
        entry_capacity=w.plan.entries))


def main():
    _common.print_records(run(settings()))


if __name__ == "__main__":
    main()
