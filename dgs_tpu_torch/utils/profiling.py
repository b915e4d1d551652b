"""Tracing and profiling on the card with ``torch.profiler``.

The counterpart of ``dgs_tpu/utils/profiling.py``: ``named_scope`` marks a
pipeline stage (a span), ``count`` adds to a named counter, ``trace``
captures a Chrome trace into a directory and ``device_op_times`` sums the
device time of each kernel (copies and sets too) in the newest one,
``device_scope_times`` the device time that each function of the port
launched (the trace records the Python stack), and ``idle_gaps_by_span``
the device's idle time by the ``dgs::`` span open when it fell idle.
``device_busy`` measures a step's device busy time as the union of the
device's activity intervals, so that overlapping or nested items count once
(``interval_union``).

Spans and counters cost a flag check while no ``torch.profiler`` runs, and
record only while one does: the port marks its layer boundaries with spans
named ``dgs::<layer>`` and counts its host synchronisations and top-level
calls (``sync.<site>``, ``calls.<op>``) with them.
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

# Chrome-trace categories of the device's own activity.
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
# The prefix of the port's span names, and the record of idle time that
# falls outside every span.
SPAN_PREFIX = "dgs::"
OUTSIDE_SPANS = "(outside dgs spans)"

_profiler_enabled = torch.autograd._profiler_enabled
_NO_SPAN = contextlib.nullcontext()
_counts: Dict[str, int] = defaultdict(int)


def named_scope(name: str):
    """A span named ``name`` around the body of a ``with``: while a
    ``torch.profiler`` runs, ``record_function(name)``, a user annotation
    on the profiler's clock, on the calling thread, enclosing the device
    work launched inside it; while none runs, one shared no-op context
    (a flag check, no annotation)."""
    if not _profiler_enabled():
        return _NO_SPAN
    return record_function(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while a ``torch.profiler`` runs;
    nothing otherwise.  Host integers only: no device tensor is read."""
    if _profiler_enabled():
        _counts[name] += n


def counters() -> Dict[str, int]:
    """A copy of every counter ``count`` has added to since the last
    ``reset_counters``."""
    return dict(_counts)


def reset_counters() -> None:
    _counts.clear()


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[profile]:
    """Profile the body (host ops with their Python stack, and the card's
    activity where there is a card) and write its Chrome trace to
    ``log_dir/trace_<nanoseconds>.json.gz`` (view it in Perfetto or
    chrome://tracing, or sum it with ``device_op_times`` and
    ``device_scope_times``).  The card is synchronised before the profiler
    stops."""
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities, with_stack=True) as prof:
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


def _events(log_dir: str) -> List[Dict]:
    path = _latest_trace(log_dir)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f)["traceEvents"]


def _host_ops(events) -> Dict[int, Dict]:
    """The host ops and annotations of a trace by "External id", the link
    from a device item to the host op that launched it."""
    return {e["args"]["External id"]: e for e in events
            if e.get("ph") == "X"
            and e.get("cat") in ("cpu_op", "user_annotation")
            and "External id" in e.get("args", {})}


def device_op_times(log_dir: str, top: int = 25,
                    steps: int = 1) -> List[Dict]:
    """Device time by kernel (and copy or set) name in the newest trace of
    ``log_dir``: records {name, ms_per_step, calls, source} sorted by time,
    the times over ``steps`` traced steps.  ``source`` is the host op or
    scope that launched the item (the trace's "External id" link), "" where
    there is none."""
    events = _events(log_dir)
    host = {k: e["name"] for k, e in _host_ops(events).items()}
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


_BACKWARD = "autograd::engine::evaluate_function: "
PACKAGE = "dgs_tpu_torch/"   # the Python frames a scope is taken from


def _scopes(events) -> Dict[int, str]:
    """id() of each host op -> its scope: the innermost Python function of
    PACKAGE around it on its thread, or for an op that autograd's
    engine ran outside any such function, "backward of " and the scope of
    the forward op that created the node it evaluates (the same "Sequence
    number"; the node's name where that is unknown); "" where there is
    none.  Frames nest on a thread, so one sweep in time order with a
    stack of open frames finds them."""
    by_tid = defaultdict(list)
    for e in events:
        if e.get("ph") != "X":
            continue
        frame = ((e.get("cat") == "python_function" and PACKAGE in e["name"])
                 or (e.get("cat") == "cpu_op"
                     and e["name"].startswith(_BACKWARD)))
        op = e.get("cat") in ("cpu_op", "user_annotation")
        for kind in ((0,) if frame else ()) + ((1,) if op else ()):
            by_tid[e.get("tid")].append((e["ts"], kind, -e.get("dur", 0), e))
    inner = {}
    for items in by_tid.values():
        items.sort(key=lambda x: x[:3])
        stack = []
        for ts, kind, _, e in items:
            while stack and stack[-1]["ts"] + stack[-1].get("dur", 0) <= ts:
                stack.pop()
            if kind == 0:
                stack.append(e)
            else:
                inner[id(e)] = stack[-1] if stack else None
    # The forward op of each autograd node: of the ops that carry its
    # sequence number and that autograd's engine did not run, the one that
    # ends last.  An op records the thread's next sequence number, so the
    # ops before the node's creation carry it too; the op that creates the
    # node encloses its own inner ops and ends after all of them.
    forward = {}
    for e in events:
        seq = e.get("args", {}).get("Sequence number")
        frame = inner.get(id(e))
        if (e.get("cat") == "cpu_op" and seq is not None
                and not e["name"].startswith(_BACKWARD)
                and (frame is None or frame.get("cat") == "python_function")
                and (seq not in forward or e["ts"] + e.get("dur", 0)
                     > forward[seq]["ts"] + forward[seq].get("dur", 0))):
            forward[seq] = e

    def name(frame):
        if frame is None:
            return ""
        if frame.get("cat") == "python_function":
            return frame["name"][frame["name"].find(PACKAGE):]
        fwd = forward.get(frame.get("args", {}).get("Sequence number"))
        got = name(inner.get(id(fwd))) if fwd is not None else ""
        return ("backward of " + got if got
                else frame["name"][len(_BACKWARD):])

    return {k: name(f) for k, f in inner.items()}


def device_scope_times(log_dir: str, top: int = 25,
                       steps: int = 1) -> List[Dict]:
    """Device time by the scope that launched it, in the newest trace of
    ``log_dir`` (a trace of ``trace``, which records the Python stack):
    records {scope, ms_per_step, items} sorted by time, over ``steps``
    traced steps.  A scope is the innermost function of the port around
    the launching host op, "file.py(line): function"; autograd's own
    backward ops count as "backward of " their forward op's scope (see
    _scopes).  This attributes the many small torch ops of a step that
    device_op_times only sums by kernel."""
    events = _events(log_dir)
    host = _host_ops(events)
    scope_of = _scopes(events)
    dur: Dict[str, float] = defaultdict(float)
    cnt: Dict[str, int] = defaultdict(int)
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATEGORIES:
            continue
        op = host.get(e.get("args", {}).get("External id"))
        scope = scope_of.get(id(op), "") if op is not None else ""
        dur[scope] += e.get("dur", 0)
        cnt[scope] += 1
    return [{"scope": k, "ms_per_step": v / (1000.0 * steps),
             "items": cnt[k]}
            for k, v in sorted(dur.items(), key=lambda kv: -kv[1])[:top]]


def _merged(intervals) -> List[List[float]]:
    """The [start, end) intervals merged where they overlap, in order."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def idle_gaps_by_span(log_dir: str, steps: int = 1) -> List[Dict]:
    """The device's idle time by the port's span, in the newest trace of
    ``log_dir`` (a trace of ``trace``): for each interval between the
    device's busy intervals (kernels, copies, sets), the innermost
    ``dgs::`` span (the latest begun) open at the interval's start on a
    thread that launches device work, OUTSIDE_SPANS where none is open.
    Records {span, ms_per_step, gaps} sorted by time, over ``steps``
    traced steps; none where the trace holds no device activity."""
    events = [e for e in _events(log_dir) if e.get("ph") == "X"]
    busy = _merged((e["ts"], e["ts"] + e.get("dur", 0)) for e in events
                   if e.get("cat") in DEVICE_CATEGORIES)
    launchers = {e.get("tid") for e in events
                 if e.get("cat") in ("cuda_runtime", "cuda_driver")}
    spans = sorted((e for e in events
                    if e.get("cat") == "user_annotation"
                    and e["name"].startswith(SPAN_PREFIX)
                    and e.get("tid") in launchers), key=lambda e: e["ts"])
    dur: Dict[str, float] = defaultdict(float)
    cnt: Dict[str, int] = defaultdict(int)
    j, open_spans = 0, []
    for (_, a), (b, _) in zip(busy, busy[1:]):
        while j < len(spans) and spans[j]["ts"] <= a:
            open_spans.append(spans[j])
            j += 1
        open_spans = [e for e in open_spans
                      if e["ts"] + e.get("dur", 0) >= a]
        name = open_spans[-1]["name"] if open_spans else OUTSIDE_SPANS
        dur[name] += b - a
        cnt[name] += 1
    return [{"span": k, "ms_per_step": v / (1000.0 * steps), "gaps": cnt[k]}
            for k, v in sorted(dur.items(), key=lambda kv: -kv[1])]


def interval_union(spans: Iterable[Tuple[float, float]]) -> float:
    """Total length of the union of the [start, end) intervals ``spans``:
    overlapping or nested intervals count once."""
    return float(sum(b - a for a, b in _merged(spans)))


def device_busy(fn, iters: int):
    """(busy ms per call, top items, device items per call) of fn() on the
    card under torch.profiler, after one warm-up call.  Busy time is the
    union of the intervals of every device activity (kernels, copies, sets;
    user annotations left out); ``top`` lists the 8 largest items as
    [name, summed device ms per call]; the last value counts those
    activities, each one launch of device work.  Raises where the profiler
    saw no device activity (no card: a measurement, never a CPU number)."""
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
            [[name[:80], t / 1e3 / iters] for name, t in top],
            len(spans) / iters)
