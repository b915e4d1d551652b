"""Readings for setting a cell's limits: the numbers ``correct`` compares,
for the program on many seeds and for the configuration's lower-precision
control on a few, at the cell's own size, in one process (one set-up of
imports and the card).  The benchmark's runs never run this.

    python3 bench_port/calibrate.py --workload d3_chunked.train3 \\
        --seeds 1-12 --control-seeds 101-103 --seconds 1

``--fault-seeds`` runs a fault of ``faults.py`` (``--fault``, default
half_batch) planted under the program.  One JSON line a run: the seed,
which run it was, its readings.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def seeds(text: str):
    out = []
    for part in filter(None, text.split(",")):
        a, _, b = part.partition("-")
        out += list(range(int(a), int(b or a) + 1))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--fault", default="half_batch")
    ap.add_argument("--seconds", type=float, default=1.0)
    a = ap.parse_args(argv)

    os.environ["OMP_NUM_THREADS"] = "1"
    import torch

    from bench_port import faults, harness

    torch.set_num_threads(1)

    dev = torch.device("cuda", 0)
    runs = ([(s, "program") for s in seeds(a.seeds)]
            + [(s, "control") for s in seeds(a.control_seeds)]
            + [(s, a.fault) for s in seeds(a.fault_seeds)])
    for seed, kind in runs:
        t = time.perf_counter()
        res = harness.run(a.workload, seed, a.seconds, False, dev, t,
                          control=kind == "control",
                          hooks=faults.FAULTS.get(kind))
        print(json.dumps({
            "seed": seed, "run": kind, "correct": res["correct"],
            "readings": {k: v["value"] for k, v in res["compared"].items()},
            "check_s": res["check_s"], "wall_s": time.perf_counter() - t,
            "metrics": {k: v["value"] for k, v in res["metrics"].items()}}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
