"""Device time by kernel of the headline step (the bench step), through
``utils.profiling.trace`` and ``device_op_times``.

The counterpart of tools/profile_step.py, with its defaults: BENCH_METHOD
tiled, tile 0.051 at D = 2 and 0.25 at D = 3, BENCH_R 3, per-axis radii
(BENCH_AXIS), PROF_STEPS 5 steps traced after one warm-up, the PROF_TOP 20
largest items.  The step is ``tools.bench``'s.  The port adds BENCH_ELLIP
(default 0: tools/profile_step.py never culls), so that the D = 3 bench
workload can be profiled as bench.py runs it::

    BENCH_D=3 BENCH_METHOD=chunked BENCH_TILE=0.2 BENCH_ELLIP=1 \\
        python -m dgs_tpu_torch.tools.profile_step

Prints one JSON line a device item ({name, ms_per_step, calls, source}:
``source`` is the host op that launched the item), one a scope ({scope,
ms_per_step, items}: the device time that each function of the port
launched, autograd's backward ops under "backward of" their forward op's
function, which attributes a step's many small torch ops), one a span of
the port ({span, ms_per_step, gaps}: the device's idle time a step by the
innermost ``dgs::`` span open when it fell idle, "(outside dgs spans)"
where none was; ``utils.profiling.idle_gaps_by_span``) and a summary line
last (the items' total, the step's host median and range, D, method,
tile).  BENCH_MOMENTS, BENCH_FASTMATH, BENCH_FOLDED and BENCH_SPAN_F/B
(default 1) become config flags as in tools/profile_step.py, which does not
read BENCH_SEP, BENCH_FDV, BENCH_FVJP or BENCH_HMM.  The Chrome trace goes to
PROF_DIR when it is set, else to a temporary directory that is removed.
On the CPU (BENCH_DEVICE=cpu) there are no device items: the list is
empty.  Refuses the TPU-only knobs as tools.bench does.
"""

from __future__ import annotations

import os

from . import _common, bench


def settings(env=None) -> dict:
    env = os.environ if env is None else env
    _common.refuse(env)
    D = int(env.get("BENCH_D", 2))
    P = int(env.get("BENCH_P", 100_000))
    return dict(
        P=P, N=int(env.get("BENCH_N", 1_000_000)), D=D,
        C=int(env.get("BENCH_C", 4)),
        method=env.get("BENCH_METHOD", "tiled"),
        steps=int(env.get("PROF_STEPS", 5)),
        top=int(env.get("PROF_TOP", 20)),
        tile=float(env.get("BENCH_TILE", {2: 0.051, 3: 0.25}.get(D, 0.1))),
        R=3,
        sigma=float(env.get("BENCH_SIGMA", 2.0 / max(P, 1) ** (1.0 / D))),
        eig_floor=float(env.get("BENCH_EIG_FLOOR", 1e-12)),
        axis_radii=env.get("BENCH_AXIS", "1") == "1",
        ellip_cull=env.get("BENCH_ELLIP", "0") == "1",
        orders=tuple(env.get("BENCH_ORDERS",
                             bench.DEFAULT_ORDERS).split(",")),
        device=env.get("BENCH_DEVICE", "cuda"),
        prof_dir=env.get("PROF_DIR"),
        flags=_common.mode_flags(env, moments=True, fast_math=True,
                                 folded=True))


def run(s: dict) -> list:
    dev = _common.torch_device(s["device"], "BENCH_DEVICE")
    field, samples = bench.field_and_samples(s["P"], s["N"], s["D"], s["C"],
                                             s["sigma"], dev)
    w = bench.plan(bench.config(s), s["method"], field, samples,
                   s["orders"])
    step = bench.train_step(w)
    (_, diag), times = _common.time_steps(step, s["steps"], dev)
    ops, scopes, gaps = _common.profile_ops(step, s["steps"], s["top"],
                                            s["prof_dir"], dev)
    over = _common.overflow(diag)
    card = _common.card(dev)
    records = [{"tool": "profile_step", **r, **card}
               for r in ops + scopes + gaps]
    records.append({
        "tool": "profile_step", "top_total_ms_per_step": (
            sum(op["ms_per_step"] for op in ops) if ops else None),
        "items": len(ops), "step_ms_median": times["ms_median"],
        "step_ms_min": times["ms_min"], "step_ms_max": times["ms_max"],
        "D": s["D"], "method": s["method"], "tile": w.cfg.tile_size,
        "orders": list(s["orders"]), "overflow": over, **card})
    return records


def main():
    _common.print_records(run(settings()))


if __name__ == "__main__":
    main()
