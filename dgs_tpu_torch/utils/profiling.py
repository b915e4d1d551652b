"""Tracing and profiling on the card with ``torch.profiler``.

The counterpart of ``dgs_tpu/utils/profiling.py``: ``named_scope`` marks a
pipeline stage, ``trace`` captures a Chrome trace into a directory and
``device_op_times`` sums the device time of each kernel (copies and sets
too) in the newest one.  ``device_busy`` measures a step's device busy time
as the union of the device's activity intervals, so that overlapping or
nested items count once (``interval_union``).
"""

from __future__ import annotations

import contextlib
import glob
import gzip
import json
import os
import time
from collections import defaultdict
from typing import Dict, Iterable, Iterator, List, Tuple

import torch
from torch.profiler import ProfilerActivity, profile, record_function

named_scope = record_function  # annotate pipeline stages

# Chrome-trace categories of the device's own activity.
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[profile]:
    """Profile the body (host ops, and the card's activity where there is
    a card) and write its Chrome trace to
    ``log_dir/trace_<nanoseconds>.json.gz`` (view it in Perfetto or
    chrome://tracing, or sum it with ``device_op_times``).  The card is
    synchronised before the profiler stops."""
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace_{time.time_ns():020d}.json.gz"))


def _latest_trace(log_dir: str) -> str:
    paths = sorted(glob.glob(os.path.join(log_dir, "trace_*.json*")))
    if not paths:
        raise FileNotFoundError(f"no trace under {log_dir}")
    return paths[-1]


def device_op_times(log_dir: str, top: int = 25,
                    steps: int = 1) -> List[Dict]:
    """Device time by kernel (and copy or set) name in the newest trace of
    ``log_dir``: records {name, ms_per_step, calls, source} sorted by time,
    the times over ``steps`` traced steps.  ``source`` is the host op or
    scope that launched the item (the trace's "External id" link), "" where
    there is none."""
    path = _latest_trace(log_dir)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        events = json.load(f)["traceEvents"]
    host = {e["args"]["External id"]: e["name"] for e in events
            if e.get("ph") == "X"
            and e.get("cat") in ("cpu_op", "user_annotation")
            and "External id" in e.get("args", {})}
    dur: Dict[str, float] = defaultdict(float)
    cnt: Dict[str, int] = defaultdict(int)
    src: Dict[str, str] = {}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATEGORIES:
            continue
        dur[e["name"]] += e.get("dur", 0)
        cnt[e["name"]] += 1
        src.setdefault(e["name"],
                       host.get(e.get("args", {}).get("External id"), ""))
    return [{"name": k, "ms_per_step": v / (1000.0 * steps),
             "calls": cnt[k], "source": src[k]}
            for k, v in sorted(dur.items(), key=lambda kv: -kv[1])[:top]]


def interval_union(spans: Iterable[Tuple[float, float]]) -> float:
    """Total length of the union of the [start, end) intervals ``spans``:
    overlapping or nested intervals count once."""
    spans = sorted(spans)
    if not spans:
        return 0.0
    total, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            total, lo, hi = total + hi - lo, a, b
        else:
            hi = max(hi, b)
    return total + hi - lo


def device_busy(fn, iters: int):
    """(busy ms per call, top items) of fn() on the card under
    torch.profiler, after one warm-up call.  Busy time is the union of the
    intervals of every device activity (kernels, copies, sets; user
    annotations left out); ``top`` lists the 8 largest items as
    [name, summed device ms per call].  Raises where the profiler saw no
    device activity (no card: a measurement, never a CPU number)."""
    from torch.autograd import DeviceType

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    spans, by_name = [], {}
    for e in prof.events():
        if (e.device_type != DeviceType.CUDA
                or getattr(e, "is_user_annotation", False)):
            continue
        spans.append((e.time_range.start, e.time_range.end))
        by_name[e.name] = (by_name.get(e.name, 0.0)
                           + e.time_range.end - e.time_range.start)
    if not spans:
        raise AssertionError("the profiler recorded no device activity")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return (interval_union(spans) / 1e3 / iters,
            [[name[:80], t / 1e3 / iters] for name, t in top])
