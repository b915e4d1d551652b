"""The readers of the program's spans and counters on a synthetic Chrome
trace, and on the card the program's counted synchronisations against
torch's own sync debug mode."""

import warnings

import pytest

from bench_port import harness, trace
from conftest import small


def ev(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid, "args": args}


def synthetic():
    """A forward on thread 1: a field op (2 us) under dgs::field; under
    dgs::op.chunked a binning sort (10 us) under dgs::binning.sort, a pack
    gather (4 us) under dgs::op.pack and the forward kernel (100 us) under
    dgs::kernel.tiled_fwd; and a harness op (6 us) under no span.  A
    backward on thread 2: the segment-sum (20 us) under
    dgs::kernel.segment_sum and its sort (8 us) under dgs::op.tiled_bwd."""
    return [
        ev("user_annotation", "dgs::field", 0, 5),
        ev("cpu_op", "aten::mul", 1, 3),
        ev("cuda_runtime", "cudaLaunchKernel", 2, 1, correlation=1),
        ev("user_annotation", "dgs::op.chunked", 10, 90),
        ev("user_annotation", "dgs::binning", 12, 20),
        ev("user_annotation", "dgs::binning.sort", 14, 10),
        ev("cpu_op", "aten::sort", 15, 5),
        ev("cuda_runtime", "cudaLaunchKernel", 16, 1, correlation=2),
        ev("user_annotation", "dgs::op.pack", 40, 50),
        ev("cuda_runtime", "cudaLaunchKernel", 42, 1, correlation=3),
        ev("user_annotation", "dgs::kernel.tiled_fwd", 50, 10),
        ev("cuda_runtime", "cudaLaunchKernel", 52, 1, correlation=4),
        ev("cpu_op", "aten::add", 120, 4),
        ev("cuda_runtime", "cudaLaunchKernel", 121, 1, correlation=5),
        ev("cpu_op", "autograd::engine::evaluate_function: _TiledForward",
           200, 100, tid=2),
        ev("user_annotation", "dgs::op.tiled_bwd", 205, 90, tid=2),
        ev("cuda_runtime", "cudaLaunchKernel", 210, 1, tid=2,
           correlation=6),
        ev("user_annotation", "dgs::kernel.segment_sum", 250, 10, tid=2),
        ev("cuda_runtime", "cudaLaunchKernel", 252, 1, tid=2,
           correlation=7),
        ev("kernel", "mul", 3, 2, tid=7, correlation=1),
        ev("kernel", "sort", 20, 10, tid=7, correlation=2),
        ev("kernel", "gather", 45, 4, tid=7, correlation=3),
        ev("kernel", "tiled_fwd", 60, 100, tid=7, correlation=4),
        ev("kernel", "add", 170, 6, tid=7, correlation=5),
        ev("kernel", "seg_sort", 215, 8, tid=7, correlation=6),
        ev("kernel", "segment_sum", 260, 20, tid=7, correlation=7),
    ]


def context(events, steps=2):
    cfg = {"D": 3, "C": 4, "N": 1000}
    return trace.Context("train", cfg,
                         {"orders": ["value", "derivative", "laplacian"]},
                         {"pairs": 10 ** 6, "entries": 100, "wrapped": False},
                         1, 1.0, events, steps, events, step_s=1.0)


@pytest.mark.parametrize("name,want", [
    ("binning_span_ms.train", 0.010 / 2), ("binning_launches.eval", 1 / 2),
    ("glue_device_ms.dense_train", (0.002 + 0.004 + 0.008) / 2),
    ("glue_launches.train", 3 / 2)])
def test_span_readers_select(name, want):
    """The innermost dgs:: span decides: the binning's children count as
    binning; the field, op and backward spans as glue; kernel spans and
    items under no span as neither."""
    assert harness.reader(name)(context(synthetic())) == pytest.approx(want)


@pytest.mark.parametrize("name", ["binning_span_ms.train",
                                  "binning_launches.train",
                                  "glue_device_ms.train",
                                  "glue_launches.train",
                                  "host_syncs.train"])
def test_readers_silent_without_spans(name, monkeypatch):
    """A program without spans (the items' only host ops are torch's)
    reads as nothing, the counters whatever they hold."""
    from dgs_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "counters",
                        lambda: {"calls.chunked": 2, "sync.a": 4})
    bare = [e for e in synthetic() if not e["name"].startswith("dgs::")]
    assert harness.reader(name)(context(bare)) is None


@pytest.mark.parametrize("counted,want", [
    ({"calls.chunked": 4, "sync.gaussian_rects": 16,
      "sync.duplicate_entries": 8, "sync.ellip_keep": 4}, 7.0),
    ({"calls.sample_all": 3}, 0.0),
    ({"sync.tiled_outputs": 2}, None),
    (None, None)])
def test_host_syncs_reader(counted, want, monkeypatch):
    """sync.* over calls.*; None with no call counted, and None where the
    program has no counters at all (the parent of the change that added
    them)."""
    from dgs_tpu_torch.utils import profiling

    if counted is None:
        monkeypatch.delattr(profiling, "counters")
    else:
        monkeypatch.setattr(profiling, "counters", lambda: dict(counted))
    got = harness.reader("host_syncs.train")(context(synthetic()))
    assert got == (None if want is None else pytest.approx(want))


CELLS = ("d3_chunked.train3", "d3_chunked.eval3", "dense10k.train4",
         "dense10k.eval4")


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_counted_syncs_are_every_sync(card, cell):
    """One step of the cell at a small size under torch's sync debug mode:
    the program counts as many host synchronisations as torch warns of,
    and at least one in the chunked cells."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from bench_port import inputs as inputs_mod
    from dgs_tpu_torch.utils import profiling

    c = harness.cell_spec(harness.benchmark(), cell)
    cfg = {**c["config"], **small(cell)}
    inputs = inputs_mod.make(cfg, c["traffic"], 11, card)
    system = harness.path_module(cfg["path"]).System(cfg, inputs, card)
    if c["traffic"]["kind"] == "train":
        loop = harness.Train(system, c["traffic"], card)
    else:
        loop = harness.Eval(system, c["traffic"], inputs["pool"], card, [])
    loop.step(0)
    torch.cuda.synchronize(card)
    profiling.reset_counters()
    with profile(activities=[ProfilerActivity.CUDA]):
        with warnings.catch_warnings(record=True) as got:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                loop.step(1)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize(card)
    counted = profiling.counters()
    profiling.reset_counters()
    syncs = [w for w in got
             if "called a synchronizing CUDA operation" in str(w.message)]
    n = sum(v for k, v in counted.items() if k.startswith("sync."))
    assert n == len(syncs), (counted, [str(w.message)[:120] for w in syncs])
    assert sum(v for k, v in counted.items() if k.startswith("calls.")) == 1
    assert (n > 0) == cell.startswith("d3_chunked")
