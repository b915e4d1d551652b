"""The trace reader on a synthetic Chrome trace: busy time as a union,
each device item attributed to the Python functions and host ops open at
its launch, and the roofline readers' forward / backward selection."""

import pytest

from bench_port import trace


def ev(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid, "args": args}


def synthetic():
    """A forward on thread 1 launching kernel F (from kernels/tiled.py) and
    a gather (from binning/), and a backward on thread 2 launching kernel
    B (from kernels/tiled.py) and a segment-sum (kernels/segment.py)."""
    return [
        ev("python_function", "dgs_tpu_torch/ops/sampling.py(295): forward",
           0, 100),
        ev("python_function",
           "dgs_tpu_torch/binning/grid.py(175): duplicate_entries", 5, 20),
        ev("cpu_op", "aten::sort", 8, 10),
        ev("cuda_runtime", "cudaLaunchKernel", 10, 2, correlation=1),
        ev("python_function",
           "dgs_tpu_torch/kernels/tiled.py(448): tiled_forward", 40, 30),
        ev("cuda_runtime", "cudaLaunchKernel", 50, 2, correlation=2),
        ev("cpu_op", "autograd::engine::evaluate_function: _TiledBackward",
           200, 100, tid=2),
        ev("python_function",
           "dgs_tpu_torch/kernels/tiled.py(568): tiled_backward", 210, 20,
           tid=2),
        ev("cuda_runtime", "cudaLaunchKernel", 215, 2, tid=2, correlation=3),
        ev("python_function",
           "dgs_tpu_torch/kernels/segment.py(20): segment_sum", 250, 20,
           tid=2),
        ev("cuda_runtime", "cudaLaunchKernel", 255, 2, tid=2, correlation=4),
        ev("kernel", "sort_kernel", 20, 10, tid=7, correlation=1),
        ev("kernel", "F", 60, 100, tid=7, correlation=2),
        ev("kernel", "B", 220, 30, tid=7, correlation=3),
        ev("kernel", "seg", 240, 20, tid=7, correlation=4),
    ]


def test_union():
    assert trace.union([(0, 10), (5, 20), (30, 40)]) == 30
    assert trace.union([]) == 0


def test_attribution():
    items = {it.name: it for it in trace.attribute(synthetic())}
    assert items["sort_kernel"].frames[-1].endswith("duplicate_entries")
    assert items["sort_kernel"].ops == ["aten::sort"]
    assert items["F"].frames[-1].endswith("tiled_forward")
    assert items["B"].ops[0].startswith("autograd::engine")
    assert items["seg"].frames[-1].endswith("segment_sum")


@pytest.mark.parametrize("name,want", [
    ("tiled_fwd_roofline.train", 0.100), ("tiled_bwd_roofline.train", 0.030),
    ("binning_device_ms.train", 0.010)])
def test_readers_select(name, want, monkeypatch):
    from bench_port import harness
    from bench_port.metrics import _roofline

    cfg = {"D": 3, "C": 4, "N": 1000}
    ctx = trace.Context("train", cfg,
                        {"orders": ["value", "derivative", "laplacian"]},
                        {"pairs": 10 ** 6, "entries": 100, "wrapped": False},
                        1, 1.0, synthetic(), 1, synthetic(), step_s=1.0)
    assert ctx.busy_s == pytest.approx(150e-6)
    monkeypatch.setattr(_roofline.yardstick, "kernel_bound_s",
                        lambda *a: 1e-3)
    value = harness.reader(name)(ctx)
    if name.startswith("binning"):
        assert value == pytest.approx(want)
    else:   # 1 ms of bound over the selected device ms
        assert value == pytest.approx(100.0 * 1.0 / want)
    gaps = ctx.breakdown()["idle_gaps"]
    assert gaps and all(v > 0 for _, v in gaps)
