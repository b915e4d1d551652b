"""The general driver of one cell: set-up, the measured or traced window,
the check against the reference, and the result line.

Everything a cell needs is found by name: the cell in ``BENCHMARK.json``;
its configuration in ``configs/<config>.json`` (sizes, the program's path
``paths/<path>.py``, the pair rule, and the prefix of its end-to-end
metrics' names, where its pace calls for bounds of their own); its traffic mix in
``traffic/<traffic>.json`` (train or eval, the orders and the loop's
parameters); the limits of its comparison in ``limits/<cell>.json``; and
each per-layer metric's reader in ``metrics/<metric>.py`` (or the reader of
the metric's name up to its first dot).

A train mix runs the training step back to back: set-up drives the step's
first ``check_steps`` steps (their losses, the first gradient as Adam holds
it and the parameters' change are checked), then the window dispatches
steps with no synchronisation until ``--seconds`` have passed and ends at
a synchronise.  An eval mix is a closed loop with one client: each request
takes the next value set of a pool made from the seed, and is timed from
its dispatch to its synchronised end.  With ``--trace 1`` the window runs
as well, untraced, for the time a step; then two traced passes
(``trace.py``): one without Python stacks for the device's busy time and
launches, one with them to attribute device time to the program's layers.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import math
import os
import random
import statistics
import sys
import tempfile
import time
from typing import Dict, List, Optional

import torch

from . import inputs as inputs_mod
from . import trace as trace_mod
from .reference import field as ref_field

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = ("jax", "jaxlib", "flax", "dgs_tpu")


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT, "BENCHMARK.json")


def cell_spec(spec: dict, name: str) -> dict:
    """The cell ``name`` with its configuration, traffic, limits and the
    metrics it reports."""
    found = [w for w in spec["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    work = found[0]
    e2e = [m for m in spec["end_to_end"]
           if name in m.get("workloads", [name])]
    e2e_names = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if (name in m["workloads"] if "workloads" in m
                 else m["moves"] in e2e_names)]
    return {"work": work,
            "config": load_json(BENCH, "configs", work["config"] + ".json"),
            "traffic": load_json(BENCH, "traffic", work["traffic"] + ".json"),
            "limits": load_json(BENCH, "limits", name + ".json"),
            "end_to_end": e2e, "per_layer": layer}


def reader(metric: str):
    """The reader of a per-layer metric: ``metrics/<name>.py``, else
    ``metrics/<name up to its first dot>.py``; its ``read(ctx)``."""
    for base in (metric, metric.split(".")[0]):
        path = os.path.join(BENCH, "metrics", base + ".py")
        if os.path.exists(path):
            modname = "bench_port.metrics." + base.replace(".", "_")
            mod = sys.modules.get(modname)
            if mod is None:
                sp = importlib.util.spec_from_file_location(modname, path)
                mod = importlib.util.module_from_spec(sp)
                sys.modules[modname] = mod
                sp.loader.exec_module(mod)
            return mod.read
    raise FileNotFoundError(f"no reader for metric {metric!r} under "
                            "bench_port/metrics/")


def path_module(name: str):
    return importlib.import_module(f"bench_port.paths.{name}")


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def norms(tensors) -> List[torch.Tensor]:
    return [torch.linalg.vector_norm(t.double()) for t in tensors]


class Adam:
    """Adam without weight decay, as ``torch.optim.Adam`` computes it with
    its multi-tensor ops (written out: ``torch.optim`` costs seconds of
    set-up to import)."""

    def __init__(self, params, lr: float, betas, eps: float):
        self.params, self.lr, self.betas, self.eps = params, lr, betas, eps
        self.exp_avg = [torch.zeros_like(p) for p in params]
        self.exp_avg_sq = [torch.zeros_like(p) for p in params]
        self.t = 0

    def zero_grad(self):
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self):
        b1, b2 = self.betas
        self.t += 1
        grads = [p.grad for p in self.params]
        torch._foreach_lerp_(self.exp_avg, grads, 1 - b1)
        torch._foreach_mul_(self.exp_avg_sq, b2)
        torch._foreach_addcmul_(self.exp_avg_sq, grads, grads, 1 - b2)
        bc1, bc2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        denom = torch._foreach_sqrt(self.exp_avg_sq)
        torch._foreach_div_(denom, math.sqrt(bc2))
        torch._foreach_add_(denom, self.eps)
        torch._foreach_addcdiv_(self.params, self.exp_avg, denom,
                                -self.lr / bc1)


class Train:
    """The training step of a train mix over the program's field: the
    program's loss, ``backward()``, Adam on every field parameter."""

    def __init__(self, system, traffic: dict, dev: torch.device):
        self.system, self.orders = system, tuple(traffic["orders"])
        opt = traffic["optimizer"]
        self.params = [getattr(system.field, k) for k in inputs_mod.LEAVES]
        self.opt = Adam(self.params, opt["lr"], tuple(opt["betas"]),
                        opt["eps"])
        self.over = torch.zeros((), dtype=torch.int64, device=dev)
        self.bad = torch.zeros((), dtype=torch.int64, device=dev)
        self.check_steps = traffic["check_steps"]

    def step(self, i: int = 0):
        self.opt.zero_grad()
        loss, over = self.system.train_loss(self.orders)
        loss.backward()
        self.opt.step()
        self.over += over
        self.bad += (over != 0)
        return loss.detach()

    def first_steps(self) -> dict:
        """The checked steps: every loss, each leaf's first gradient as
        Adam holds it (exp_avg / (1 - beta1) after one step) and each
        leaf's change after the last."""
        p0 = [p.detach().clone() for p in self.params]
        losses, grads = [], None
        for t in range(self.check_steps):
            losses.append(self.step())
            if t == 0:
                grads = norms(m / (1 - self.opt.betas[0])
                              for m in self.opt.exp_avg)
        keys = inputs_mod.LEAVES
        return {"losses": [float(v) for v in losses],
                "grads": {k: float(v) for k, v in zip(keys, grads)},
                "changes": {k: p.detach() - a
                            for k, p, a in zip(keys, self.params, p0)}}


class Eval:
    """The closed loop of an eval mix: request i evaluates the program's
    fixed geometry with value set i mod pool, under ``torch.no_grad()``."""

    def __init__(self, system, traffic: dict, pool: torch.Tensor,
                 dev: torch.device, keep: List[int]):
        self.system, self.orders, self.pool = (system,
                                               tuple(traffic["orders"]), pool)
        self.over = torch.zeros((), dtype=torch.int64, device=dev)
        self.bad = torch.zeros((), dtype=torch.int64, device=dev)
        self.keep, self.kept = set(keep), {}

    def step(self, i: int):
        with torch.no_grad():
            outs, over = self.system.evaluate(self.pool[i % len(self.pool)],
                                              self.orders)
            self.over += over
            self.bad += (over != 0)
        if i in self.keep:
            self.kept[i] = outs


def window_train(loop: Train, seconds: float, dev) -> dict:
    sync(dev)
    t0 = time.perf_counter()
    n = 0
    while True:
        loop.step(n)
        n += 1
        if time.perf_counter() - t0 >= seconds:
            break
    sync(dev)
    return {"steps": n, "window_s": time.perf_counter() - t0}


def window_eval(loop: Eval, seconds: float, dev, start: int) -> dict:
    lat = []
    i = start
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        t = time.perf_counter()
        loop.step(i)
        sync(dev)
        lat.append(time.perf_counter() - t)
        i += 1
    return {"steps": len(lat), "window_s": time.perf_counter() - t0,
            "latencies_s": lat}


def traced(loop, steps: int, start: int, stack: bool, dev, closed: bool):
    """(events, window seconds) of ``steps`` steps under torch.profiler,
    the trace written to and read back from the run's TMPDIR.  With
    ``stack`` the host's ops and Python stacks are recorded too; without,
    the device's activity alone, so that the host keeps its own pace."""
    from torch.profiler import ProfilerActivity, profile

    sync(dev)
    device = (ProfilerActivity.CUDA if dev.type == "cuda"
              else ProfilerActivity.CPU)
    acts = sorted({ProfilerActivity.CPU, device} if stack else {device},
                  key=str)
    with profile(activities=acts, with_stack=stack) as prof:
        t0 = time.perf_counter()
        for i in range(start, start + steps):
            loop.step(i)
            if closed:
                sync(dev)
        sync(dev)
        wall = time.perf_counter() - t0
    with tempfile.TemporaryDirectory(prefix="bench_port_trace_") as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        events = trace_mod.load(path)
    return events, wall


def gap_ratio(prog: float, ref: float, scale: float) -> float:
    return abs(prog - ref) / scale if scale > 0 else float(prog != ref)


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
             moved) -> float:
    """The worst leaf's gap between the program's norm and the reference's,
    over the larger of that leaf's reference norm and the median leaf's,
    over the leaves ``moved`` (those whose first reference gradient is at
    least a thousandth of the median leaf's)."""
    med = statistics.median(ref.values())
    return max(gap_ratio(prog[k], ref[k], max(ref[k], med)) for k in moved)


# An element whose first reference gradient is under this share of its
# leaf's root mean square is nought to rounding: Adam moves it by the sign
# of round-off (lr a step either way), so it is left out of the change.
ROUNDING_GRAD = 1e-5


def changes_moved(changes: Dict[str, torch.Tensor],
                  ref_grads: Dict[str, torch.Tensor]):
    """({leaf: norm of its change over the elements whose first reference
    gradient is not nought to rounding}, elements left out)."""
    out, left = {}, 0
    for k, g in ref_grads.items():
        keep = g.abs() >= ROUNDING_GRAD * g.pow(2).mean().sqrt()
        left += int((~keep).sum())
        out[k] = float(torch.linalg.vector_norm(
            changes[k].double() * keep))
    return out, left


def check_train(c: dict, inputs: dict, prog: dict, dev) -> Dict[str, float]:
    """The checked steps against the reference's: each step's loss, each
    leaf's first gradient and each leaf's change after the steps (see
    leaf_gap and changes_moved)."""
    traffic, opt = c["traffic"], c["traffic"]["optimizer"]
    init = {k: inputs[k] for k in inputs_mod.LEAVES}
    rec: dict = {}
    r = ref_field.train(c["config"], tuple(traffic["orders"]), init,
                        inputs["samples"], opt["lr"], tuple(opt["betas"]),
                        opt["eps"], traffic["check_steps"],
                        budget=c["config"]["reference_pairs"], record=rec)
    med = statistics.median(r.grads.values())
    moved = {k: v for k, v in r.grads.items() if v >= 1e-3 * med}
    ref_changes = {k: rec["params"][k] - init[k].double() for k in init}
    got, left = changes_moved(prog["changes"], rec["grads"])
    want, _ = changes_moved(ref_changes, rec["grads"])
    print(f"change: {left} element(s) with a first gradient nought to "
          "rounding left out", file=sys.stderr)
    for name, a, b in (("grad", prog["grads"], r.grads),
                       ("change", got, want)):
        m = statistics.median(b.values())
        print(f"{name} gap by leaf: " + ", ".join(
            f"{k} {gap_ratio(a[k], b[k], max(b[k], m)):.3e}" for k in b),
            file=sys.stderr)
    return {
        "loss_gap": max(gap_ratio(a, b, abs(b))
                        for a, b in zip(prog["losses"], r.losses)),
        "grad_gap": leaf_gap(prog["grads"], r.grads, moved),
        "change_gap": leaf_gap(got, want, moved),
    }


def check_eval(c: dict, inputs: dict, prog: Dict[int, dict],
               dev) -> Dict[str, float]:
    """The largest gap of an output at any sample, over that order's
    largest reference magnitude, over the checked requests."""
    geometry = tuple(inputs[k] for k in inputs_mod.LEAVES[:3])
    pool = inputs["pool"]
    worst = 0.0
    for i, outs in prog.items():
        ref = ref_field.outputs(c["config"], tuple(outs), geometry,
                                pool[i % pool.shape[0]], inputs["samples"],
                                None, None,
                                budget=c["config"]["reference_pairs"])
        for order, got in outs.items():
            want = ref[order]
            scale = float(want.abs().max())
            err = float((got.double() - want).abs().max())
            worst = max(worst, err / scale if scale > 0 else err)
            if not math.isfinite(err):
                worst = math.inf
    return {"out_err": worst}


def work(c: dict, inputs: dict, plan) -> dict:
    """The benchmark's own count of a step's work under the configuration's
    pair rule, from the inputs: pairs, entries, and whether the pairs need
    the torus wrap."""
    geometry = tuple(inputs[k] for k in inputs_mod.LEAVES[:3])
    return ref_field.rule(c["config"]).count(c["config"], plan, geometry,
                                             inputs["samples"])


def card(dev: torch.device) -> dict:
    import subprocess

    limit = None
    try:
        limit = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
             "-i", str(dev.index or 0)], capture_output=True, text=True,
            timeout=30).stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        pass
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": 1, "power_limit": limit}


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def run(name: str, seed: int, seconds: float, trace: bool,
        dev: torch.device, t_start: float, *, config: Optional[dict] = None,
        control: bool = False, hooks=None) -> dict:
    """One run of cell ``name``: the result line's fields, with the numbers
    compared under "compared".  ``config`` overrides configuration keys
    (the tests' small sizes); ``control`` runs the configuration's
    lower-precision control in the program's place; ``hooks(system,
    loop)`` may break the timed path underneath (the tests' faults)."""
    c = cell_spec(benchmark(), name)
    if config:
        c["config"] = {**c["config"], **config}
    cfg, traffic = c["config"], c["traffic"]
    kind = traffic["kind"]
    if traffic.get("clients", 1) != 1:
        raise ValueError("the eval loop is one client")
    stages = [("start", t_start), ("imports", time.perf_counter())]
    inputs = inputs_mod.make(cfg, traffic, seed, dev)
    sync(dev)
    stages.append(("inputs", time.perf_counter()))
    path = path_module(cfg["path"])
    reference_control = control and cfg["control"] == "reference_tf32"
    system = path.System(cfg, inputs, dev,
                         fast_math=control and cfg["control"] == "fast_math")
    rng = random.Random(int(seed))
    if kind == "train":
        loop = Train(system, traffic, dev)
    else:
        keep = sorted(traffic["warmup"] + k for k in rng.sample(
            range(traffic["pool"]), traffic["checked_requests"]))
        loop = Eval(system, traffic, inputs["pool"], dev, keep)
    sync(dev)
    stages.append(("system", time.perf_counter()))
    if hooks is not None:
        hooks(system, loop)
    if kind == "train":
        prog = loop.first_steps()
        start = traffic["check_steps"]
    else:
        for i in range(traffic["warmup"]):
            loop.step(i)
            sync(dev)
        start = traffic["warmup"]
    sync(dev)
    stages.append(("first steps" if kind == "train" else "warm-up",
                   time.perf_counter()))
    setup_s = stages[-1][1] - t_start
    print("set-up s: " + ", ".join(
        f"{name} {b - a:.3f}" for (_, a), (name, b) in zip(stages, stages[1:])),
        file=sys.stderr)
    out: Dict = {"metrics": {}}
    pre = cfg.get("metric_prefix", "")
    # The measured window, untraced, in both kinds of run: with --trace 1
    # its time a step is what the step's shares are taken over.
    if kind == "train":
        w = window_train(loop, seconds, dev)
    else:
        w = window_eval(loop, seconds, dev, start)
    geometry = tuple(inputs[k] for k in inputs_mod.LEAVES[:3])
    plan = ref_field.rule(cfg).plan(cfg, geometry)
    print(f"steps {w['steps']} in {w['window_s']:.3f} s; pair rule "
          f"{cfg['pair_rule']}, plan {plan}", file=sys.stderr)
    if not trace:
        if kind == "train":
            out["metrics"][pre + "train_samples_per_s"] = (
                cfg["N"] * w["steps"] / w["window_s"])
        else:
            lat = w["latencies_s"]
            out["metrics"][pre + "eval_samples_per_s"] = (
                cfg["N"] * w["steps"] / w["window_s"])
            out["metrics"][pre + "eval_p95_ms"] = 1e3 * (
                statistics.quantiles(lat, n=20)[18] if len(lat) > 1
                else lat[0])
        out["metrics"]["setup_s"] = setup_s
        out["attempted"] = w["steps"]
    else:
        closed = kind == "eval"
        na, nb = traffic["trace_steps"], traffic["trace_stack_steps"]
        start += w["steps"]
        # The stack pass first: it also pays the profiler's start-up.
        ev_b, _ = traced(loop, nb, start, True, dev, closed)
        ev_a, wall_a = traced(loop, na, start + nb, False, dev, closed)
        ctx = trace_mod.Context(
            kind=kind, config=cfg, traffic=traffic,
            work=work(c, inputs, plan), steps=na, window_s=wall_a,
            events=ev_a, stack_steps=nb, stack_events=ev_b,
            step_s=w["window_s"] / w["steps"])
        for m in c["per_layer"]:
            v = reader(m["name"])(ctx)
            if v is not None:
                out["metrics"][m["name"]] = v
        out["attempted"] = w["steps"] + na + nb
        out["busy_s"], out["window_s"] = ctx.busy_s, wall_a
        out["breakdown"] = ctx.breakdown()
        del ev_a, ev_b, ctx
    units = {m["name"]: m["unit"] for m in c["end_to_end"] + c["per_layer"]}
    out["metrics"] = {k: {"value": v, "unit": units[k]}
                      for k, v in out["metrics"].items()}
    over, bad = int(loop.over), int(loop.bad)
    out["failed"] = bad
    if dev.type == "cuda":
        out["memory_peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    # Only the checked readings outlive the program's state.
    if kind == "eval":
        # A checked request the window did not reach is served now.
        for i in sorted(loop.keep - set(loop.kept)):
            loop.step(i)
        sync(dev)
        prog = dict(loop.kept)
    del loop, system
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    if reference_control:
        prog = control_readings(c, inputs, prog, dev)
    if kind == "train":
        got = check_train(c, inputs, prog, dev)
    else:
        got = check_eval(c, inputs, prog, dev)
    sync(dev)
    out["check_s"] = time.perf_counter() - t_check
    got["overflow"] = over
    limits = c["limits"]
    out["compared"] = {k: {"value": v, "limit": limits[k]}
                       for k, v in got.items()}
    out["correct"] = all(math.isfinite(v) and v <= limits[k]
                         for k, v in got.items())
    return out


def control_readings(c: dict, inputs: dict, prog, dev):
    """The reference in float32 with TF32 products, in the program's place
    (the lower-precision control of a path that has no such mode)."""
    traffic = c["traffic"]
    if traffic["kind"] == "train":
        opt = traffic["optimizer"]
        init = {k: inputs[k] for k in inputs_mod.LEAVES}
        rec: dict = {}
        r = ref_field.train(c["config"], tuple(traffic["orders"]), init,
                            inputs["samples"], opt["lr"],
                            tuple(opt["betas"]), opt["eps"],
                            traffic["check_steps"], dtype=torch.float32,
                            budget=c["config"]["reference_pairs"], tf32=True,
                            record=rec)
        return {"losses": r.losses, "grads": r.grads,
                "changes": {k: rec["params"][k] - init[k] for k in init}}
    geometry = tuple(inputs[k] for k in inputs_mod.LEAVES[:3])
    pool = inputs["pool"]
    return {i: ref_field.outputs(c["config"], tuple(outs), geometry,
                                 pool[i % pool.shape[0]], inputs["samples"],
                                 None, None, dtype=torch.float32,
                                 budget=c["config"]["reference_pairs"],
                                 tf32=True)
            for i, outs in prog.items()}
