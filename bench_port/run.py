"""Run one cell of the benchmark of ``dgs_tpu_torch`` once.

    python3 bench_port/run.py --workload d3_chunked.train3 --seed 7 \\
        --seconds 10 --trace 0

Prints one JSON line last on standard output: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``compared`` (each number checked against the
reference, beside its limit), which also ends standard error.  Exits
non-zero with no result where no card is visible, where the cell asks for
more cards than there are, or where JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".bench_cache")
# Every build and kernel cache in the checkout, at fixed paths.  The
# program builds its kernel library in dgs_tpu_torch/.build/.
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["CUDA_CACHE_PATH"] = os.path.join(CACHE, "nv")
os.environ["TORCHINDUCTOR_CACHE_DIR"] = os.path.join(CACHE, "inductor")
os.environ["USE_FLAX"] = "0"
# One process, few threads: the host's CPU work is dispatch.
os.environ["OMP_NUM_THREADS"] = "1"
os.environ["MKL_NUM_THREADS"] = "1"
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def result_line(res: dict, card: dict, trace: bool) -> dict:
    """The result line of a run of ``harness.run``: the contract's keys,
    then how long the check took, then the numbers compared (last)."""
    device = {**card, "memory_peak_bytes": res.get("memory_peak_bytes")}
    if trace:
        device["busy_s"], device["window_s"] = res["busy_s"], res["window_s"]
    line = {"correct": res["correct"], "attempted": res["attempted"],
            "failed": res["failed"], "metrics": res["metrics"],
            "device": device}
    if trace:
        line["breakdown"] = res["breakdown"]
    line["check_s"] = res["check_s"]
    line["compared"] = res["compared"]
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)

    import torch

    from bench_port import harness

    torch.set_num_threads(1)

    chips = harness.cell_spec(harness.benchmark(),
                              a.workload)["work"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"bench_port: {a.workload} needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " visible", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    res = harness.run(a.workload, a.seed, a.seconds, bool(a.trace), dev,
                      T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"bench_port: forbidden modules loaded: {found}",
              file=sys.stderr)
        return 3
    line = result_line(res, harness.card(dev), bool(a.trace))
    for k, v in res["compared"].items():
        print(f"{k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
