"""The port's spans and counters (dgs_tpu_torch.utils.profiling): a span is
a shared no-op while no profiler runs and a user annotation while one does;
counters count only then; the program's layer spans nest as its call tree;
a chunked call counts each host synchronisation site; and
idle_gaps_by_span puts each device-idle interval of a trace down to the
innermost span open when it began."""

import gzip
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dgs_tpu_torch.config import SamplerConfig
from dgs_tpu_torch.models.field import init_field
from dgs_tpu_torch.ops import sampling_chunked
from dgs_tpu_torch.sampler import GaussianSampler
from dgs_tpu_torch.utils import profiling

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def clean_counters():
    profiling.reset_counters()
    yield
    profiling.reset_counters()


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def exported(prof, tmp_path):
    """The complete events of a finished profile's Chrome trace."""
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events if e.get("ph") == "X"]


def test_span_is_a_shared_noop_without_a_profiler(monkeypatch):
    """No profiler: named_scope hands back one shared no-op, never enters
    record_function, and count records nothing."""
    def boom(name):
        raise AssertionError(f"record_function entered for {name!r}")

    monkeypatch.setattr(profiling, "record_function", boom)
    assert profiling.named_scope("dgs::a") is profiling.named_scope("dgs::b")
    with profiling.named_scope("dgs::a"):
        with profiling.named_scope("dgs::b"):
            torch.ones(4).sum()
    profiling.count("sync.x")
    profiling.count("calls.y", 3)
    assert profiling.counters() == {}


def test_nested_spans_are_nested_user_annotations(tmp_path):
    """Under the profiler the spans are user annotations, nested as the
    code nests them, around the ops run inside them."""
    with cpu_profile() as prof:
        with profiling.named_scope("dgs::outer"):
            torch.ones(8).mul(2.0)
            with profiling.named_scope("dgs::inner"):
                torch.ones(8).add(1.0)
    events = exported(prof, tmp_path)
    ann = {e["name"]: e for e in events if e.get("cat") == "user_annotation"}
    outer, inner = ann["dgs::outer"], ann["dgs::inner"]

    def within(a, b):
        return (b["ts"] <= a["ts"]
                and a["ts"] + a["dur"] <= b["ts"] + b["dur"])

    assert within(inner, outer) and inner["tid"] == outer["tid"]
    add = [e for e in events if e["name"] == "aten::add"]
    mul = [e for e in events if e["name"] == "aten::mul"]
    assert add and all(within(e, inner) for e in add)
    assert mul and all(within(e, outer) and not within(e, inner)
                       for e in mul)


def test_counters_count_only_under_a_profiler():
    profiling.count("sync.a")
    with cpu_profile():
        profiling.count("sync.a")
        profiling.count("sync.a", 2)
        profiling.count("calls.b")
    got = profiling.counters()
    assert got == {"sync.a": 3, "calls.b": 1}
    got["sync.a"] = 99   # a copy
    assert profiling.counters()["sync.a"] == 3
    profiling.reset_counters()
    assert profiling.counters() == {}


def chunked_inputs(P=64, N=256):
    g = torch.Generator().manual_seed(3)
    field = init_field(g, P, 3, 2, sigma=0.06)
    samples = 2.0 * torch.rand((N, 3), generator=g) - 1.0
    cfg = SamplerConfig(period=2.0, lower=(-1.0,) * 3, tile_size=0.5,
                        axis_radii=True, ellip_cull=True, eig_floor=1e-12)
    with torch.no_grad():
        cov = field.covariances()
    cfg, plan = sampling_chunked.plan_chunked(cfg, field.means.detach(), cov,
                                              samples, headroom=1.02)
    cs = sampling_chunked.chunk_samples(cfg, samples, plan, cfg.block_n)
    return field, samples, cfg, plan, cs


# One chunked call on the CPU, where duplicate_entries builds its keys in
# plain torch, counts gaussian_rects twice (the entries, then
# prepare_entries' periodic image) at two copies each, duplicate_entries'
# grid and strides, the cull's lower corner, and with outputs in sample
# order the Hessian's mirror map.  (On the card the key kernel takes the
# grid as arguments: the entries' rects, grid, strides and cull copy
# nothing.)
SITES = {"sync.gaussian_rects": 4, "sync.duplicate_entries": 2,
         "sync.ellip_keep": 1}


@pytest.mark.parametrize("padded,want", [
    (True, {**SITES, "calls.chunked": 1}),
    (False, {**SITES, "sync.tiled_outputs": 1, "calls.chunked": 1}),
])
def test_chunked_call_counts_each_sync_site(padded, want):
    field, samples, cfg, plan, cs = chunked_inputs()
    args = (cfg, field.means, field.values, field.conics(),
            field.covariances(), samples, plan, cs,
            ("value", "derivative", "laplacian"))
    sampling_chunked.sample_chunked(*args, padded_outputs=padded)
    assert profiling.counters() == {}
    with cpu_profile():
        outs, _ = sampling_chunked.sample_chunked(*args,
                                                  padded_outputs=padded)
        sum(o.sum() for o in outs.values()).backward()
    assert profiling.counters() == want


def test_chunked_spans_follow_the_call_tree(tmp_path):
    """The op's span holds the binning's, which holds its children; the
    backward's span, which autograd runs, lies outside the forward's."""
    field, samples, cfg, plan, cs = chunked_inputs()
    with cpu_profile() as prof:
        outs, _ = sampling_chunked.sample_chunked(
            cfg, field.means, field.values, field.conics(),
            field.covariances(), samples, plan, cs, ("value",),
            padded_outputs=True)
        outs["value"].sum().backward()
    spans = [e for e in exported(prof, tmp_path)
             if e.get("cat") == "user_annotation"
             and e["name"].startswith("dgs::")]
    names = {e["name"] for e in spans}
    assert names >= {"dgs::field", "dgs::op.chunked", "dgs::op.radii",
                     "dgs::binning", "dgs::binning.rects",
                     "dgs::binning.cull", "dgs::binning.sort",
                     "dgs::binning.shift", "dgs::binning.geometry",
                     "dgs::op.pack", "dgs::op.outputs", "dgs::op.tiled_bwd"}

    def parents(name):
        e = next(s for s in spans if s["name"] == name)
        return {s["name"] for s in spans
                if s is not e and s["tid"] == e["tid"]
                and s["ts"] <= e["ts"]
                and e["ts"] + e["dur"] <= s["ts"] + s["dur"]}

    assert {"dgs::op.chunked", "dgs::binning"} <= parents("dgs::binning.cull")
    assert "dgs::op.chunked" in parents("dgs::op.outputs")
    assert {"dgs::op.pack", "dgs::op.chunked"} <= parents(
        "dgs::binning.shift")
    assert parents("dgs::op.tiled_bwd") == set()


@pytest.mark.parametrize("train", [True, False])
def test_facade_counts_calls_and_no_sync(train):
    """The all-pairs facade: one calls.sample_all a call, no host
    synchronisation site on its path."""
    g = torch.Generator().manual_seed(5)
    field = init_field(g, 16, 3, 2, sigma=0.2)
    samples = 2.0 * torch.rand((64, 3), generator=g) - 1.0
    sampler = GaussianSampler(method="pallas", config=SamplerConfig(
        period=2.0, lower=(-1.0,) * 3, eig_floor=1e-12))
    with cpu_profile(), torch.set_grad_enabled(train):
        sampler.preprocess(field.means, field.values, field.covariances(),
                           field.conics(), samples)
        outs = sampler.sample_all(("value", "derivative"))
        if train:
            sum(o.sum() for o in outs.values()).backward()
    assert profiling.counters() == {"calls.sample_all": 1}


def test_chunked_facade_counts_one_call():
    """GaussianSampler(method="chunked").sample_all is one call: the
    chunked op's, not the facade's as well."""
    field, samples, cfg, _, _ = chunked_inputs()
    sampler = GaussianSampler(method="chunked", config=cfg)
    with torch.no_grad():
        sampler.preprocess(field.means, field.values, field.covariances(),
                           field.conics(), samples)
        with cpu_profile():
            sampler.sample_all(("value",))
    assert profiling.counters() == {**SITES, "calls.chunked": 1}


def ev(cat, name, ts, dur, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid, "args": {}}


def write_trace(tmp_path, events):
    path = tmp_path / "trace_00000000000000000001.json.gz"
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": events}, f)
    return str(tmp_path)


def test_idle_gaps_by_span_on_a_synthetic_trace(tmp_path):
    """Gaps between busy intervals go to the innermost dgs:: span open at
    their start on a launching thread; spans on threads that launch
    nothing and other annotations are not read; gaps outside every span
    go to OUTSIDE_SPANS."""
    events = [
        ev("user_annotation", "dgs::op.chunked", 0, 100),
        ev("user_annotation", "dgs::binning", 10, 25),
        ev("user_annotation", "not_ours", 15, 5),
        ev("cuda_runtime", "cudaLaunchKernel", 12, 1),
        ev("user_annotation", "dgs::op.tiled_bwd", 150, 50, tid=2),
        ev("cuda_runtime", "cudaLaunchKernel", 160, 1, tid=2),
        ev("user_annotation", "dgs::field", 0, 400, tid=3),   # no launches
        ev("kernel", "a", 0, 10, tid=9),
        ev("kernel", "b", 5, 15, tid=9),     # overlaps a: busy [0, 20)
        ev("kernel", "c", 30, 10, tid=9),    # gap [20, 30): dgs::binning
        ev("gpu_memcpy", "d", 60, 10, tid=9),  # [40, 60): dgs::op.chunked
        ev("kernel", "e", 120, 10, tid=9),   # [70, 120): dgs::op.chunked
        ev("kernel", "f", 160, 20, tid=9),   # [130, 160): outside
        ev("kernel", "g", 190, 10, tid=9),   # [180, 190): dgs::op.tiled_bwd
    ]
    got = profiling.idle_gaps_by_span(write_trace(tmp_path, events),
                                      steps=2)
    assert got == [
        {"span": "dgs::op.chunked", "ms_per_step": 0.035, "gaps": 2},
        {"span": profiling.OUTSIDE_SPANS, "ms_per_step": 0.015, "gaps": 1},
        {"span": "dgs::binning", "ms_per_step": 0.005, "gaps": 1},
        {"span": "dgs::op.tiled_bwd", "ms_per_step": 0.005, "gaps": 1},
    ]
    assert profiling.idle_gaps_by_span(
        write_trace(tmp_path, events[:7])) == []


def test_idle_gaps_by_span_of_a_cpu_trace_is_empty(tmp_path):
    """A CPU capture of profiling.trace has no device items and no gaps."""
    with profiling.trace(str(tmp_path)):
        with profiling.named_scope("dgs::x"):
            torch.arange(64.0).pow(2).sum()
    assert profiling.idle_gaps_by_span(str(tmp_path)) == []
