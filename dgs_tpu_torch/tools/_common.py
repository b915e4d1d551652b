"""What the port's measuring tools share: the refusal of the JAX tools'
TPU-only knobs, the kernel-mode and span knobs resolved into SamplerConfig
flags as the JAX tools resolve them, the device knob, the step clock,
device busy time, the trace directory and the card's name and power limit.

Knobs.  BENCH_BN/BP/BBN/BBP, AGG_BN/BE and SWEEP_BLOCKS size the TPU
kernels' blocks: refused.  BENCH_MOMENTS, BENCH_SEP, BENCH_FASTMATH,
BENCH_FOLDED, BENCH_FDV, BENCH_FVJP and BENCH_HMM select the kernel modes
(the moment-form backward, the separable forward, fast-math, the folded
forward, the folded dvalues, the folded VJP, h_matmul), which the port
has: ``mode_flags`` resolves them into the same SamplerConfig flags as the
JAX tool that reads them.  BENCH_SPAN_F / BENCH_SPAN_B are scheduling knobs of
the TPU work list (work_span_fwd / work_span_bwd): resolved into the config
as the JAX tool does, accepted and not read by the port's kernels.

Timing.  The JAX tools time a 1-run chain against a 3-run chain of a
scanned program and sync by reading a scalar back, a workaround for their
TPU tunnel.  The port times each step on the host clock between
``torch.cuda.synchronize()`` calls, in a loop whose steps depend on one
another, and reports the median and the range; device busy time per step
(``utils.profiling.device_busy``) stands beside it, because the host clock
of a shared host spreads 2-3x across runs.  On the CPU (asked for with a
tool's device knob) there is no device: busy time and launches are None,
"not measured", and a profile lists no device items.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import tempfile
import time
from typing import Callable, Dict, Iterator, List, Mapping, Optional

import torch

from ..utils.profiling import (device_busy, device_op_times,
                               device_scope_times, idle_gaps_by_span, trace)


class UnsupportedKnob(ValueError):
    """A knob of the JAX tool that has no counterpart in the port."""


# Block sizes of the TPU kernels' grids and work lists: the port's kernels
# read none (config.SamplerConfig docstring).
BLOCK_KNOBS = ("BENCH_BN", "BENCH_BP", "BENCH_BBN", "BENCH_BBP", "AGG_BN",
               "AGG_BE", "SWEEP_BLOCKS")
def refuse(env: Mapping[str, str]) -> None:
    """Raise UnsupportedKnob, naming the knob, where ``env`` sets one of the
    JAX tools' TPU-only knobs: a block size.  Every tool refuses every one
    of them."""
    for knob in BLOCK_KNOBS:
        if knob in env:
            raise UnsupportedKnob(
                f"{knob} sizes a block of the TPU kernels; the port's "
                "kernels read no block size: unset it")


def mode_flags(env: Mapping[str, str], *, separable: bool = False,
               moments: bool = False, fast_math: bool = False,
               folded: bool = False, folded_backward: bool = False,
               span: int = 1) -> Dict:
    """SamplerConfig flags from the knobs a JAX tool reads, as it reads
    them: BENCH_MOMENTS / BENCH_SEP / BENCH_FOLDED / BENCH_FDV / BENCH_FVJP /
    BENCH_HMM 0 or 1 force moment_backward / separable_kernels /
    folded_values / folded_dvals / folded_vjp / h_matmul off or on, unset
    leaves them None; BENCH_FASTMATH=1 sets fast_math_dots; BENCH_SPAN_F /
    _B give work_span_fwd / _bwd (default ``span``).  Only the knobs the
    tool reads (``separable``, ``moments``, ``fast_math``, ``folded``: the
    folded forward, ``folded_backward``: the folded dvalues and VJP and
    h_matmul) become flags."""
    flags = {"work_span_fwd": int(env.get("BENCH_SPAN_F", span)),
             "work_span_bwd": int(env.get("BENCH_SPAN_B", span))}
    for on, knob, field in ((moments, "BENCH_MOMENTS", "moment_backward"),
                            (separable, "BENCH_SEP", "separable_kernels"),
                            (folded, "BENCH_FOLDED", "folded_values"),
                            (folded_backward, "BENCH_FDV", "folded_dvals"),
                            (folded_backward, "BENCH_FVJP", "folded_vjp"),
                            (folded_backward, "BENCH_HMM", "h_matmul")):
        if on:
            flags[field] = None if knob not in env else env[knob] == "1"
    if fast_math:
        flags["fast_math_dots"] = env.get("BENCH_FASTMATH", "0") == "1"
    return flags


def torch_device(name: str, knob: str) -> torch.device:
    """The device a tool runs on: the card unless ``knob`` named the CPU.
    No CUDA device is an error, never a fall-back to the CPU."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"{knob}={name}: no CUDA device is visible; "
                               f"set {knob}=cpu to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"{knob}={name}: a tool runs on cuda or cpu")
    return dev


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def card(dev: torch.device) -> Dict[str, Optional[str]]:
    """{"device", "power_limit"}: the card's name and its power limit as
    nvidia-smi reports it (a card set below 700 W runs slower under load),
    or "cpu" and None."""
    if dev.type != "cuda":
        return {"device": "cpu", "power_limit": None}
    try:
        line = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader", "-i", str(dev.index)],
            capture_output=True, text=True, check=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        line = None
    return {"device": torch.cuda.get_device_name(dev), "power_limit": line}


def time_steps(step: Callable, steps: int, dev: torch.device):
    """(the last step's output, {"ms_median", "ms_min", "ms_max"}): each of
    ``steps`` calls of ``step`` timed on the host clock between
    synchronisations, after one warm-up call (kernel build, allocator)."""
    out = step()
    sync(dev)
    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        out = step()
        sync(dev)
        times.append(1e3 * (time.perf_counter() - t0))
    return out, {"ms_median": statistics.median(times), "ms_min": min(times),
                 "ms_max": max(times)}


def activity(step: Callable, iters: int, dev: torch.device) -> Dict:
    """{"busy_ms", "launches"} per call of ``step``: device busy time (the
    union of the device's intervals under torch.profiler) and device items
    launched (kernels, copies, sets).  None on the CPU: not measured."""
    if dev.type != "cuda":
        return {"busy_ms": None, "launches": None}
    busy, _, launches = device_busy(step, iters)
    return {"busy_ms": busy, "launches": launches}


@contextlib.contextmanager
def trace_dir(prof_dir: Optional[str]) -> Iterator[str]:
    """``prof_dir`` (a tool's PROF_DIR) when it is set, kept; else a
    temporary directory, removed afterwards: never a directory of the
    repository."""
    if prof_dir:
        os.makedirs(prof_dir, exist_ok=True)
        yield prof_dir
        return
    with tempfile.TemporaryDirectory(prefix="dgs_trace_") as tmp:
        yield tmp


def profile_ops(step: Callable, steps: int, top: int,
                prof_dir: Optional[str], dev: torch.device):
    """(ops, scopes, gaps) of ``steps`` calls of ``step`` under the
    profiler, after one warm-up call: device time by kernel (copy, set) with
    the host op that launched it as ``source``
    (utils.profiling.device_op_times), device time by the port's function
    that launched it (device_scope_times), each the ``top`` largest, and
    the device's idle time by the port's span open when it fell idle
    (idle_gaps_by_span).  Empty lists on the CPU, which has no device
    items."""
    step()
    sync(dev)
    with trace_dir(prof_dir) as d:
        with trace(d):
            for _ in range(steps):
                step()
        return (device_op_times(d, top=top, steps=steps),
                device_scope_times(d, top=top, steps=steps),
                idle_gaps_by_span(d, steps=steps))


def overflow(diag: Mapping) -> Dict[str, int]:
    """The diagnostics as ints (``perm`` left out), read once the timing
    has finished; raises where any is not zero."""
    got = {k: int(v) for k, v in diag.items() if k != "perm"}
    bad = {k: v for k, v in got.items() if v}
    if bad:
        raise RuntimeError(f"overflow diagnostics not zero: {bad}")
    return got


def print_records(records: List[Dict]) -> None:
    for r in records:
        print(json.dumps(r), flush=True)
