"""dgs_tpu_torch.tools, the port's measuring tools, on the CPU: each tool's
run at a tiny size, the refused TPU-only knobs, the settings each tool
derives from an environment against the ones the JAX tool (bench.py,
tools/) passes to dgs_tpu from the same environment, and the bench loss and
its gradients against dgs_tpu's at D = 2 tiled and D = 3 chunked.

The JAX tools' settings are captured by loading the tool and patching, in
its namespace, the dgs_tpu functions it calls (and ``jax`` / ``jnp``, with
a stand-in that absorbs every call), so that no JAX compute runs and no
file of tools/ changes."""

import functools
import importlib
import importlib.util
import os
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dgs_tpu.ops.sampling_chunked as jchunked
from dgs_tpu.binning import grid as jgrid
from dgs_tpu.config import SamplerConfig as JConfig
from dgs_tpu.models.field import init_field as jinit
from dgs_tpu.models.pigs import field_outputs as jfield_outputs
from dgs_tpu.ops import formulas as jformulas
from dgs_tpu.utils import native as jnative
from dgs_tpu_torch.models import dynamics as tdyn
from dgs_tpu_torch.config import SamplerConfig as TConfig
from dgs_tpu_torch.models.field import GaussianField
from dgs_tpu_torch.tools import _common, bench, train_100k

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
TOOLS = ("bench", "profile_step", "profile_bench", "train_100k",
         "bench_aggregate", "profile_aggregate", "profile_dynamics",
         "sweep_tile", "sweep_chunked")


def _tool(name):
    return importlib.import_module(f"dgs_tpu_torch.tools.{name}")


# ---------------------------------------------------------------- runs

# Tiny sizes on the CPU: footprints a tile or two wide, so that the plain
# kernels' sweeps stay short.
TINY = {
    "BENCH_DEVICE": "cpu", "BENCH_P": "64", "BENCH_N": "256",
    "BENCH_STEPS": "2", "BENCH_TILE": "0.25", "BENCH_SIGMA": "0.03",
    "PROF_STEPS": "2",
    "AGG_DEVICE": "cpu", "AGG_P": "128", "AGG_STEPS": "2",
    "AGG_SIGMA": "0.03",
    "DYN_DEVICE": "cpu", "DYN_P": "256", "DYN_EVAL": "256",
    "T100K_DEVICE": "cpu", "T100K_P": "256", "T100K_STEPS": "2",
    "T100K_COLLOC": "256", "T100K_DSTEPS": "2", "T100K_EVAL": "256",
    "T100K_TILE": "0.25", "T100K_DCHUNK": "1",
    "SWEEP_DEVICE": "cpu", "SWEEP_P": "256", "SWEEP_N": "256",
    "SWEEP_STEPS": "1", "SWEEP_TILES": "0.5,0.25",
}
# tool: (extra settings, a metric or key each record set must hold)
RUNS = {
    "bench": ({}, "gaussian_point_samples_per_sec_per_chip_fwd_bwd"),
    "bench_d3": ({"BENCH_D": "3", "BENCH_TILE": "0.5"},
                 "gaussian_point_samples_per_sec_per_chip_fwd_bwd"),
    "profile_step": ({}, "top_total_ms_per_step"),
    "profile_bench": ({}, "forward_kernels_ms"),
    "train_100k": ({}, "dynamics_100k_train_step_seconds"),
    "bench_aggregate": ({}, "aggregation_fwd_bwd_gaussians_per_sec"),
    "profile_aggregate": ({}, "plan"),
    "profile_dynamics": ({}, "rollout_ms"),
    "sweep_tile": ({}, "ms_per_step"),
    "sweep_chunked": ({}, "ms_per_step"),
}


def _overflows(record):
    got = []
    for k, v in record.get("detail", record).items():
        if "overflow" in k:
            got += list(v.values()) if isinstance(v, dict) else [v]
    return got


@pytest.mark.parametrize("case", sorted(RUNS))
def test_tool_runs_on_the_cpu(monkeypatch, case):
    """Each tool's run at a tiny size on the CPU: the JAX tool's metric
    names, every diagnostic 0, every record marked "cpu" with no device
    numbers (busy time, launches, profile items)."""
    extra, key = RUNS[case]
    name = case.split("_d3")[0]
    if name == "train_100k":
        # The value fit takes minutes through the plain tiled kernels.
        monkeypatch.setattr(tdyn, "fit_values", functools.partial(
            tdyn.fit_values, steps=3, n_fit=256))
    mod = _tool(name)
    records = mod.run(mod.settings({**TINY, **extra}))
    assert records
    assert any(key in r or r.get("metric") == key or key in r.get(
        "detail", {}) for r in records), records
    for r in records:
        assert r["device"] == "cpu" and r["power_limit"] is None, r
        assert not any(_overflows(r)), r
        assert "skip" not in r, r
        assert "ms_per_step" not in r or name.startswith("sweep"), r
        for k in ("busy_ms", "launches", "busy_ms_per_step",
                  "device_launches_per_step", "peak_bytes"):
            assert r.get(k) is None and r.get("detail", {}).get(k) is None
    if name == "train_100k":
        metrics = {r["metric"] for r in records}
        assert metrics == {"pigs_100k_train_step_seconds",
                           "dynamics_100k_train_step_seconds"}


def test_train_100k_check_raises():
    """train_100k's checks, kept from the JAX tool: the PIGS loss must at
    least halve, the dynamics loss fall, every overflow be 0."""
    a = {"metric": "pigs_100k_train_step_seconds", "loss_first": 4.0,
         "loss_last": 1.0, "overflow": {"bin_overflow": 0.0}}
    b = {"metric": "dynamics_100k_train_step_seconds", "loss_first": 2.0,
         "loss_last": 1.0, "nbr_overflow": 0, "eval_overflow": 0}
    train_100k.check([a, b])
    for bad, match in ((dict(a, loss_last=3.0), "converge"),
                       (dict(a, overflow={"bin_overflow": 1.0}), "overflow"),
                       (dict(b, loss_last=2.0), "fall"),
                       (dict(b, eval_overflow=2), "overflow")):
        with pytest.raises(RuntimeError, match=match):
            train_100k.check([bad])


def test_no_card_is_an_error_not_a_fallback(monkeypatch):
    """The device knob defaults to the card; with no card the tool raises
    and names the knob that asks for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in TOOLS:
        mod = _tool(name)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mod.run(mod.settings({}))


def test_chip_variants_types_entries_as_the_library():
    """chip_variants.py gives a variant library's C entry the argument and
    result types that the package's library gives it, and refuses a
    library that exports neither kernel's entry."""
    spec = importlib.util.spec_from_file_location(
        "chip_variants",
        Path(__file__).resolve().parents[1] / "chip_variants.py")
    cv = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cv)
    ref = types.SimpleNamespace(**{
        e: types.SimpleNamespace(argtypes=[e], restype=len(e))
        for e in cv.ENTRIES.values()})
    for kind, entry in cv.ENTRIES.items():
        lib = types.SimpleNamespace(**{entry: types.SimpleNamespace()})
        assert cv.bind(lib, ref, "v") == kind
        fn = getattr(lib, entry)
        assert (fn.argtypes, fn.restype) == ([entry], len(entry))
    with pytest.raises(RuntimeError, match="v: exports none"):
        cv.bind(types.SimpleNamespace(), ref, "v")


# ------------------------------------------------------ refused knobs

REFUSED = [("bench", "BENCH_BN", "512"), ("bench", "BENCH_BP", "256"),
           ("bench", "BENCH_BBN", "256"), ("bench", "BENCH_BBP", "256"),
           ("bench_aggregate", "AGG_BN", "32"),
           ("profile_aggregate", "AGG_BE", "128"),
           ("sweep_tile", "SWEEP_BLOCKS", "256x128x256x128")]


@pytest.mark.parametrize("tool,knob,value", REFUSED)
def test_tpu_only_knob_is_refused_by_name(tool, knob, value):
    with pytest.raises(_common.UnsupportedKnob, match=knob):
        _tool(tool).settings({knob: value})


def test_knobs_at_their_port_values_are_accepted():
    """A span of 1 and a kernel mode forced off ask for nothing the port
    lacks."""
    env = {"BENCH_SPAN_F": "1", "BENCH_SPAN_B": "1", "BENCH_MOMENTS": "0",
           "BENCH_FASTMATH": "0"}
    for name in TOOLS:
        _tool(name).settings(env)


# The kernel-mode and span knobs the port reads (formerly refused): the
# tool's config flags against the ones the JAX tool passes to
# SamplerConfig from the same environment.
ACCEPTED = [("train_100k", "BENCH_SPAN_F", "2"),
            ("sweep_chunked", "BENCH_SPAN_B", "2"),
            ("bench", "BENCH_MOMENTS", "1"), ("bench", "BENCH_SEP", "1"),
            ("profile_step", "BENCH_FASTMATH", "1"),
            ("bench", "BENCH_FOLDED", "1"), ("bench", "BENCH_FDV", "1"),
            ("bench", "BENCH_FVJP", "1"), ("bench", "BENCH_HMM", "1")]
FLAGS = ("moment_backward", "separable_kernels", "fast_math_dots",
         "work_span_fwd", "work_span_bwd", "folded_values", "folded_dvals",
         "folded_vjp", "h_matmul")


def _port_configs(tool, s):
    """The SamplerConfigs the port's tool builds from settings ``s`` before
    planning (bench.config, or each train_100k phase's flags)."""
    if tool == "sweep_chunked":
        return [bench.config({**s, "tile": tile}) for tile in s["tiles"]]
    if tool in ("bench", "profile_step"):
        return [bench.config(s)]
    return [TConfig(**s["flags"])]


@pytest.mark.parametrize("tool,knob,value", ACCEPTED)
def test_ported_knob_is_accepted(monkeypatch, tool, knob, value):
    """BENCH_MOMENTS, BENCH_SEP, BENCH_FASTMATH, BENCH_FOLDED, BENCH_FDV,
    BENCH_FVJP, BENCH_HMM and a span other than 1 are accepted and resolve
    into the same config flags as the JAX tool (bench.py:97-140,
    tools/profile_step.py:54-61, tools/train_100k.py,
    tools/sweep_chunked.py)."""
    for k in list(os.environ):
        if k.startswith(("BENCH_", "PROF_", "AGG_", "DYN_", "T100K_",
                         "SWEEP_")):
            monkeypatch.delenv(k)
    path, capture, envs = PARITY[tool]
    env = {**envs[0], knob: value}
    log = {}
    capture(path, monkeypatch, env, log)
    s = _tool(tool).settings(env)
    defaults = JConfig()
    want = [{f: kw.get(f, getattr(defaults, f)) for f in FLAGS}
            for kw in log["config"] if kw]
    got = [{f: getattr(c, f) for f in FLAGS} for c in _port_configs(tool, s)]
    assert want and all(w == got[0] for w in want), (want, got)
    field = {"BENCH_SPAN_F": "work_span_fwd", "BENCH_SPAN_B": "work_span_bwd",
             "BENCH_MOMENTS": "moment_backward",
             "BENCH_SEP": "separable_kernels",
             "BENCH_FASTMATH": "fast_math_dots",
             "BENCH_FOLDED": "folded_values", "BENCH_FDV": "folded_dvals",
             "BENCH_FVJP": "folded_vjp", "BENCH_HMM": "h_matmul"}[knob]
    assert got[0][field] in (True, int(value))


# ---------------------------------------------------- settings parity


class _Stop(Exception):
    pass


class _Any:
    """Stands in for jax / jnp in a JAX tool's namespace: absorbs every
    attribute, call, index, arithmetic and context, so that none of the
    tool's JAX compute runs."""

    def __getattr__(self, name):
        return self

    def __call__(self, *args, **kwargs):
        return self

    def __getitem__(self, key):
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def _same(self, *args):
        return self

    __add__ = __radd__ = __mul__ = __rmul__ = __sub__ = __truediv__ = _same


def _recorder(log, name, result=None, stop=False):
    def fn(*args, **kwargs):
        log.setdefault(name, []).append((args, kwargs))
        if stop:
            raise _Stop
        return result() if callable(result) else result
    return fn


def _stub_field():
    return types.SimpleNamespace(means=None, values=None,
                                 covariances=lambda: None,
                                 conics=lambda: None)


def _load_jax_tool(path, monkeypatch, env, log):
    """The JAX tool at ``path`` loaded afresh under ``env`` (its module
    constants read the environment), with jax, jnp, init_field and
    SamplerConfig replaced in its namespace by recorders."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    spec = importlib.util.spec_from_file_location(
        "jax_tool_" + Path(path).stem, ROOT / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    fake_jax, fake_jnp = _Any(), _Any()
    fake_jax.default_backend = lambda: "cpu"
    fake_jax.random = _Any()
    fake_jax.random.uniform = _recorder(log, "uniform", _Any)
    fake_jax.random.normal = _recorder(log, "normal", _Any)
    fake_jnp.arange = _recorder(log, "arange", _Any)
    fake_jnp.concatenate = _recorder(log, "concatenate", _Any)
    for attr, value in (("jax", fake_jax), ("jnp", fake_jnp),
                        ("init_field", _recorder(log, "init_field",
                                                 _stub_field))):
        if hasattr(mod, attr):
            monkeypatch.setattr(mod, attr, value)
    if hasattr(mod, "compute_radii"):
        monkeypatch.setattr(mod, "compute_radii", _recorder(log, "radii"))

    def config(**kw):
        log.setdefault("config", []).append(kw)
        return JConfig(**kw)

    monkeypatch.setattr(mod, "SamplerConfig", config)
    return mod


def _run_main(mod):
    try:
        mod.main()
    except _Stop:
        pass


def _field_args(log):
    (_, P, D, C), kw = log["init_field"][0]
    return dict(P=P, D=D, C=C, sigma=kw["sigma"])


def _capture_bench(path, monkeypatch, env, log):
    mod = _load_jax_tool(path, monkeypatch, env, log)
    monkeypatch.setattr(jnative, "plan_capacities",
                        _recorder(log, "plan_capacities", stop=True))
    monkeypatch.setattr(jchunked, "plan_chunked",
                        _recorder(log, "plan_chunked", stop=True))
    _run_main(mod)
    kw = log["config"][-1]
    got = dict(_field_args(log), N=log["uniform"][0][0][1][0],
               tile=kw["tile_size"], R=kw["max_tiles_per_gaussian"],
               eig_floor=kw["eig_floor"],
               axis_radii=kw.get("axis_radii", False),
               ellip_cull=kw.get("ellip_cull", False),
               method="chunked" if "plan_chunked" in log else "tiled")
    if hasattr(mod, "ORDERS"):
        got["orders"] = tuple(mod.ORDERS)
    return got


def _capture_train_100k(path, monkeypatch, env, log):
    mod = _load_jax_tool(path, monkeypatch, env, log)
    history = [{"loss": 2.0, "t_step_s": 1.0}, {"loss": 0.5, "t_step_s": 1.0}]
    monkeypatch.setattr(mod.pigs, "train",
                        _recorder(log, "pigs_train", lambda: (None, history)))
    monkeypatch.setattr(mod.dynamics, "train",
                        _recorder(log, "dynamics_train", stop=True))
    _run_main(mod)
    _, a = log["pigs_train"][0]
    _, b = log["dynamics_train"][0]
    cfg_a, cfg_b = log["config"]
    return dict(P=a["P"], D=a["D"], steps=a["steps"],
                n_collocation=a["n_collocation"],
                learning_rate=a["learning_rate"], sigma=a["sigma"],
                d_steps=b["steps"], rollout=b["rollout"],
                d_sigma=b["sigma"], n_eval=b["n_eval"],
                d_chunk=b["scan_chunk"], tile=cfg_a["tile_size"],
                d_tile=cfg_b["tile_size"], eig_floor=cfg_a["eig_floor"],
                axis_radii=cfg_a["axis_radii"],
                ellip_cull=cfg_a["ellip_cull"], d_axis=cfg_b["axis_radii"],
                d_ellip=cfg_b["ellip_cull"], ladder=b["ladder_frequencies"],
                eval_method=b["eval_method"])


def _capture_aggregate(path, monkeypatch, env, log):
    mod = _load_jax_tool(path, monkeypatch, env, log)
    monkeypatch.setattr(mod.aggregation, "plan_pallas",
                        _recorder(log, "plan_pallas", stop=True))
    monkeypatch.setattr(mod.aggregation, "suggest_grid_capacities",
                        _recorder(log, "plan_grid", stop=True))
    _run_main(mod)
    f = _field_args(log)
    shapes = [args[1] for args, _ in log["normal"]]
    D = f["D"]
    return dict(P=f["P"], D=D, L=f["C"], sigma=f["sigma"],
                K=shapes[2][1], nfreq=(shapes[-1][0] // 2 - 1) // (2 * D),
                tile=log["config"][-1]["tile_size"],
                ladder="arange" in log,
                method="pallas" if "plan_pallas" in log else "xla")


def _capture_profile_dynamics(path, monkeypatch, env, log):
    mod = _load_jax_tool(path, monkeypatch, env, log)

    def plan(cfg, means, rad, **kw):
        log["plan_pallas"] = (cfg, kw)
        return cfg, [1, 128]

    monkeypatch.setattr(mod.aggregation, "plan_pallas", plan)
    monkeypatch.setattr(mod.dynamics, "init_dynamics_params",
                        _recorder(log, "params", _Any))
    monkeypatch.setattr(mod.dynamics, "make_value_eval",
                        _recorder(log, "value_eval", _Any))
    _run_main(mod)
    f = _field_args(log)
    cfg_a, kw_a = log["plan_pallas"]
    (_, field, method), kw_e = log["value_eval"][0]
    kw = log["config"][-1]
    return dict(P=f["P"], D=f["D"], sigma=f["sigma"],
                n_eval=kw_e["n_eval"],
                rollout=len(log["concatenate"][0][0][0]),
                tile=kw["tile_size"], eig_floor=kw["eig_floor"],
                axis_radii=kw["axis_radii"], ellip_cull=kw["ellip_cull"],
                agg_tile=(cfg_a.tile_size if kw_a.get("auto_tile") is False
                          else None),
                ladder=log["params"][0][1]["ladder"])


def _capture_sweep(path, monkeypatch, env, log):
    mod = _load_jax_tool(path, monkeypatch, env, log)
    plan = {"entries": 1, "max_extent": 1}
    monkeypatch.setattr(mod, "measure", _recorder(
        log, "measure", lambda: (1.0, {})))
    if "chunked" in path:
        monkeypatch.setattr(jchunked, "plan_chunked", lambda cfg, *a: (
            cfg, types.SimpleNamespace(entries=1, work_fwd=1, work_bwd=1)))
    else:
        monkeypatch.setattr(jnative, "plan_capacities", lambda *a: plan)
        monkeypatch.setattr(jnative, "config_from_plan",
                            lambda cfg, *a: cfg)
    _run_main(mod)
    kws = [kw for kw in log["config"] if kw]
    steps = {args[-1] for args, _ in log["measure"]}
    return dict(_field_args(log), N=log["uniform"][0][0][1][0],
                steps=steps.pop(), tiles=[kw["tile_size"] for kw in kws],
                R=kws[0]["max_tiles_per_gaussian"],
                eig_floor=kws[0]["eig_floor"],
                axis_radii=kws[0].get("axis_radii", False),
                orders=tuple(mod.ORDERS))


def _port_fields(name, s, want):
    """The port's settings ``s`` under the keys of the JAX capture."""
    extra = {"d_sigma": s.get("sigma", 0.0) * 3.0, "d_axis": s.get(
        "axis_radii"), "d_ellip": s.get("ellip_cull"), "ladder": s.get(
        "ladder", True), "eval_method": "tiled"}
    return {k: s[k] if k in s else extra[k] for k in want}


# tool: (JAX tool, capture, environments)
PARITY = {
    "bench": ("bench.py", _capture_bench, [
        {"BENCH_P": "1000", "BENCH_N": "5000"},
        {"BENCH_P": "1000", "BENCH_N": "5000", "BENCH_D": "3"},
        {"BENCH_P": "500", "BENCH_N": "700", "BENCH_D": "3",
         "BENCH_METHOD": "tiled", "BENCH_TILE": "0.3", "BENCH_R": "5",
         "BENCH_AXIS": "0", "BENCH_ELLIP": "0", "BENCH_SIGMA": "0.02",
         "BENCH_C": "2", "BENCH_EIG_FLOOR": "1e-9",
         "BENCH_ORDERS": "value,third"}]),
    "profile_step": ("tools/profile_step.py", _capture_bench, [
        {"BENCH_P": "1000", "BENCH_N": "5000"},
        {"BENCH_P": "1000", "BENCH_N": "5000", "BENCH_D": "3",
         "BENCH_METHOD": "chunked"}]),
    "profile_bench": ("tools/profile_bench.py", _capture_bench, [
        {"BENCH_P": "1000", "BENCH_N": "5000"},
        {"BENCH_P": "900", "BENCH_N": "300", "BENCH_TILE": "0.1",
         "BENCH_R": "6", "BENCH_SIGMA": "0.01"}]),
    "train_100k": ("tools/train_100k.py", _capture_train_100k, [
        {}, {"T100K_P": "5000", "T100K_STEPS": "12", "T100K_COLLOC": "4096",
             "T100K_DSTEPS": "7", "T100K_EVAL": "1024", "T100K_TILE": "0.1",
             "T100K_DTILE": "0.3", "T100K_DCHUNK": "3", "BENCH_AXIS": "0",
             "BENCH_ELLIP": "0"}]),
    "bench_aggregate": ("tools/bench_aggregate.py", _capture_aggregate, [
        {}, {"AGG_P": "3000", "AGG_L": "3", "AGG_K": "5", "AGG_NFREQ": "2",
             "AGG_SIGMA": "0.01", "AGG_TILE": "0.1", "AGG_LADDER": "1",
             "AGG_METHOD": "xla"}]),
    "profile_aggregate": ("tools/profile_aggregate.py", _capture_aggregate,
                          [{}, {"AGG_P": "3000", "AGG_LADDER": "1",
                                "AGG_K": "4"}]),
    "profile_dynamics": ("tools/profile_dynamics.py",
                         _capture_profile_dynamics, [
                             {"DYN_PROFILE": "none"},
                             {"DYN_PROFILE": "none", "DYN_P": "4000",
                              "DYN_EVAL": "2048", "DYN_ROLLOUT": "3",
                              "DYN_AGG_TILE": "0.2", "T100K_DTILE": "0.4",
                              "BENCH_ELLIP": "0"}]),
    "sweep_tile": ("tools/sweep_tile.py", _capture_sweep, [
        {"SWEEP_P": "1000", "SWEEP_N": "100"},
        {"SWEEP_P": "1000", "SWEEP_N": "100", "SWEEP_D": "3",
         "SWEEP_STEPS": "2", "SWEEP_TILES": "0.5,0.3",
         "SWEEP_ORDERS": "value,derivative"}]),
    "sweep_chunked": ("tools/sweep_chunked.py", _capture_sweep, [
        {"SWEEP_P": "1000", "SWEEP_N": "100"},
        {"SWEEP_P": "1000", "SWEEP_N": "100", "SWEEP_D": "3",
         "SWEEP_STEPS": "3", "BENCH_AXIS": "0"}]),
}
PARITY_CASES = [(t, i) for t, (_, _, envs) in PARITY.items()
                for i in range(len(envs))]


@pytest.mark.parametrize("tool,case", PARITY_CASES)
def test_settings_match_the_jax_tool(monkeypatch, tool, case):
    """The fields the port reads (sizes, tile, R, eig floor, radii, cull,
    steps, orders, rollout, sigma, method) as the JAX tool passes them to
    dgs_tpu from the same environment."""
    path, capture, envs = PARITY[tool]
    for k in list(os.environ):
        if k.startswith(("BENCH_", "PROF_", "AGG_", "DYN_", "T100K_",
                         "SWEEP_")):
            monkeypatch.delenv(k)
    log = {}
    want = capture(path, monkeypatch, envs[case], log)
    s = _tool(tool).settings(dict(os.environ))
    got = _port_fields(tool, s, want)
    for k in want:
        if isinstance(want[k], float):
            assert got[k] == pytest.approx(want[k], rel=1e-12), k
        else:
            assert got[k] == want[k], k


# ------------------------------------------------------ numeric parity

NUMERIC = {
    # D: (P, N, C, sigma, settings of the port's bench)
    2: (96, 400, 2, 0.03, {"BENCH_TILE": "0.25"}),
    3: (96, 400, 2, 0.05, {"BENCH_D": "3", "BENCH_TILE": "0.25"}),
}


def _jax_bench_loss(s, jf, samples):
    """bench.py:176-214's loss on dgs_tpu, its config planned as bench.py
    plans it (the TPU block sizes at dgs_tpu's defaults, span 1)."""
    cfg = JConfig(tile_size=s["tile"], max_tiles_per_gaussian=s["R"],
                  eig_floor=s["eig_floor"], axis_radii=s["axis_radii"],
                  ellip_cull=s["ellip_cull"])
    N, D = samples.shape
    if s["method"] == "chunked":
        cfg, cplan = jchunked.plan_chunked(cfg, jf.means, jf.covariances(),
                                           samples)
        sb = jchunked.chunk_samples(cfg, samples, cplan, cfg.block_n)
    else:
        plan = jnative.plan_capacities(cfg, jf.means, jf.covariances(),
                                       samples)
        cfg = jnative.config_from_plan(cfg, plan, jf.means.shape[0])
        sb = jgrid.bin_samples(cfg, samples)

    def loss(field):
        if s["method"] == "chunked":
            outs, _ = jchunked.sample_chunked(
                cfg, field.means, field.values, field.conics(),
                field.covariances(), samples, cplan, sb, s["orders"],
                padded_outputs=True)
        else:
            outs, _ = jfield_outputs(
                cfg, field, samples, orders=s["orders"], method="tiled",
                sorted_outputs=True, unique_outputs=True,
                padded_outputs=True, sample_binning=sb)
        return sum(jnp.einsum("ucn,u->", o * o, jnp.asarray(
            jformulas.sym_multiplicity(order, D), jnp.float32))
            for order, o in outs.items()) / N

    return jax.jit(jax.value_and_grad(loss))(jf)


@pytest.mark.parametrize("D", sorted(NUMERIC))
def test_bench_loss_and_gradients_match_dgs_tpu(D):
    """The port's bench loss (tools.bench.loss over its planned workload)
    and its gradients to means, log-scales, rotations and values, against
    bench.py's loss on dgs_tpu (Pallas kernels in interpret mode) on the
    same field: D = 2 tiled, D = 3 chunked with bench.py's D = 3 flags
    (per-axis radii, ellipsoid cull).  Forward rtol 1e-4, gradients
    rtol 2e-3."""
    P, N, C, sigma, env = NUMERIC[D]
    s = bench.settings({**env, "BENCH_C": str(C), "BENCH_DEVICE": "cpu"})
    jf = jinit(jax.random.PRNGKey(D), P, D, C, sigma=sigma)
    samples = np.random.default_rng(D).uniform(
        -1.0, 1.0, (N, D)).astype(np.float32)
    ref, ref_grads = _jax_bench_loss(s, jf, jnp.asarray(samples))

    tf = GaussianField.from_numpy(*[np.asarray(a) for a in jf],
                                  device="cpu")
    w = bench.plan(bench.config(s), s["method"], tf,
                   torch.from_numpy(samples), s["orders"])
    value, diag = bench.loss(w)
    value.backward()
    assert not any(int(v) for v in diag.values())
    np.testing.assert_allclose(float(value.detach()), float(ref), rtol=1e-4)
    for name, got, want in zip(("means", "log_scales", "rotations",
                                "values"),
                               (tf.means, tf.log_scales, tf.rotations,
                                tf.values), ref_grads):
        want = np.asarray(want)
        np.testing.assert_allclose(
            got.grad.numpy(), want, rtol=2e-3,
            atol=1e-5 * max(1.0, float(np.abs(want).max(initial=0.0))),
            err_msg=f"d{name}")
