"""Reading a ``torch.profiler`` Chrome trace of a traced pass.

Device items are the trace's kernels, copies and sets.  Busy time is the
union of their intervals (overlapping items count once).  Each item is
attributed to the host: its launch (the CUDA runtime or driver call with the
same correlation id) lies on one host thread, inside the Python functions
(``python_function``, traced with stacks) and the host ops (``cpu_op``,
``user_annotation``) open there at that moment.  A reader of a per-layer
metric selects items by those names: the files of the program that
launched them, the autograd node that ran them.
"""

from __future__ import annotations

import json
from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("python_function", "cpu_op", "user_annotation")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def load(path: str) -> List[dict]:
    with open(path) as f:
        return json.load(f)["traceEvents"]


def device_items(events) -> List[dict]:
    return [e for e in events
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]


def union(spans) -> float:
    """Length of the union of [start, end) intervals."""
    spans = sorted(spans)
    total, lo, hi = 0.0, None, None
    for a, b in spans:
        if hi is None or a > hi:
            if hi is not None:
                total += hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    return total + (hi - lo if hi is not None else 0.0)


class Item(NamedTuple):
    """A device item and the host context of its launch."""

    name: str
    us: float
    frames: List[str]     # Python functions, outermost first
    ops: List[str]        # host ops, outermost first


def attribute(events) -> List[Item]:
    """Every device item with the Python functions and host ops open on
    its launching thread when it was launched (one sweep a thread: the
    host intervals of a thread nest)."""
    launch = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in LAUNCH_CATS:
            c = e.get("args", {}).get("correlation")
            if c is not None:
                launch[c] = e
    items = device_items(events)
    queries = defaultdict(list)
    for n, e in enumerate(items):
        lz = launch.get(e.get("args", {}).get("correlation"))
        if lz is not None:
            queries[lz.get("tid")].append((lz["ts"], 1, 0.0, n))
    context: Dict[int, List[dict]] = {}
    for e in events:
        if (e.get("ph") == "X" and e.get("cat") in HOST_CATS
                and e.get("tid") in queries):
            queries[e["tid"]].append((e["ts"], 0, -e.get("dur", 0), e))
    for tid, q in queries.items():
        q.sort(key=lambda x: x[:3])
        stack: List[dict] = []
        for ts, kind, _, x in q:
            while stack and stack[-1]["ts"] + stack[-1].get("dur", 0) < ts:
                stack.pop()
            if kind == 0:
                stack.append(x)
            else:
                context[x] = list(stack)
    out = []
    for n, e in enumerate(items):
        ctx = context.get(n, [])
        out.append(Item(
            e["name"], float(e.get("dur", 0)),
            [h["name"] for h in ctx if h.get("cat") == "python_function"],
            [h["name"] for h in ctx if h.get("cat") != "python_function"]))
    return out


def idle_gaps(events, items: List[dict]) -> Dict[str, float]:
    """Seconds of device idleness between consecutive busy intervals, by
    what the host was doing at the gap's start: the innermost host op or
    Python function open then on any thread that launches device work."""
    spans = sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in items)
    merged = []
    for a, b in spans:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    gaps = [(merged[i][1], merged[i + 1][0]) for i in range(len(merged) - 1)]
    launchers = {e.get("tid") for e in events
                 if e.get("ph") == "X" and e.get("cat") in LAUNCH_CATS}
    host = sorted((e for e in events
                   if e.get("ph") == "X" and e.get("tid") in launchers
                   and e.get("cat") in HOST_CATS + LAUNCH_CATS),
                  key=lambda e: e["ts"])
    out: Dict[str, float] = defaultdict(float)
    j, open_ev = 0, []
    for a, b in gaps:
        while j < len(host) and host[j]["ts"] <= a:
            open_ev.append(host[j])
            j += 1
        open_ev = [e for e in open_ev if e["ts"] + e.get("dur", 0) >= a]
        name = (min(open_ev, key=lambda e: e.get("dur", 0))["name"]
                if open_ev else "(no host op)")
        out[name[:80]] += (b - a) / 1e6
    return out


class Context:
    """What a metric reader gets: the cell's kind, configuration and traffic,
    the benchmark's count of a step's work, and the two traced passes:
    ``events``, ``steps`` steps over ``window_s`` seconds with the device's
    activity alone recorded (the host runs at its own pace), and
    ``stack_events``, ``stack_steps`` steps with host ops and Python stacks
    (slower on the host; its device items attribute device time to the
    program's layers); and ``step_s``, the seconds a step of the untraced
    window, which the profiler does not slow."""

    def __init__(self, kind, config, traffic, work, steps, window_s,
                 events, stack_steps, stack_events, step_s):
        self.kind, self.config, self.traffic = kind, config, traffic
        self.work, self.steps, self.window_s = work, steps, window_s
        self.step_s = step_s
        self.stack_steps = stack_steps
        self.items = device_items(events)
        self.busy_s = union((e["ts"], e["ts"] + e.get("dur", 0))
                            for e in self.items) / 1e6
        self._gaps = idle_gaps(stack_events, device_items(stack_events))
        self.attributed = attribute(stack_events)

    def device_ms_per_step(self, select) -> Optional[float]:
        """Device ms a step of the stack pass's items that ``select(item)``
        keeps; None where it keeps none."""
        got = [it.us for it in self.attributed if select(it)]
        if not got:
            return None
        return sum(got) / 1e3 / self.stack_steps

    def breakdown(self) -> dict:
        by = defaultdict(float)
        for e in self.items:
            by[e["name"][:80]] += e.get("dur", 0) / 1e6
        top = sorted(by.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self._gaps.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k, v] for k, v in top],
                "idle_gaps": [[k, v] for k, v in gaps]}
