"""A run's result line and its guards: the contract's keys, no card, a
bare checkout, and no JAX or JAX package in the process."""

import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

import conftest
from conftest import ROOT


def run_cpu(cell, seed=3, seconds=0.5, trace=False, **kw):
    from bench_port import harness

    return harness.run(cell, seed, seconds, trace, torch.device("cpu"),
                       time.perf_counter(), config=conftest.small(cell), **kw)


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_keys(trace):
    from bench_port import run

    res = run_cpu("dense10k.eval4", trace=trace)
    card = {"platform": "gpu", "kind": "test", "count": 1}
    line = run.result_line(res, card, trace)
    keys = list(line)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"]
    assert keys[-1] == "compared"
    assert ("breakdown" in keys) == trace
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    if trace:
        assert set(line["device"]) >= {"busy_s", "window_s"}
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(line["metrics"]) == {"dense_eval_samples_per_s",
                                        "dense_eval_p95_ms", "setup_s"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    for v in line["compared"].values():
        assert set(v) == {"value", "limit"}
    json.dumps(line)


def test_same_seed_same_inputs():
    from bench_port import harness, inputs

    c = harness.cell_spec(harness.benchmark(), "d3_chunked.eval3")
    cfg = {**c["config"], **conftest.small("d3_chunked.eval3")}
    a = inputs.make(cfg, c["traffic"], 2 ** 31 + 12345, torch.device("cpu"))
    b = inputs.make(cfg, c["traffic"], 2 ** 31 + 12345, torch.device("cpu"))
    for k in a:
        assert torch.equal(a[k], b[k])


def test_no_card_no_result():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run(
        [sys.executable, "bench_port/run.py", "--workload",
         "d3_chunked.train3", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=ROOT, capture_output=True, text=True, env=env,
        timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_bare_directory_no_result(tmp_path):
    shutil.copytree(os.path.join(ROOT, "bench_port"), tmp_path / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    out = subprocess.run(
        [sys.executable, "bench_port/run.py", "--workload",
         "d3_chunked.train3", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_forbidden_modules_by_whole_name(monkeypatch):
    from bench_port import harness

    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "dgs_tpu_torch_extra", object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "dgs_tpu.ops", object())
    assert harness.forbidden_modules() == ["dgs_tpu"]


def test_a_run_loads_no_jax():
    code = ("import sys, time, torch; sys.path.insert(0, %r)\n"
            "sys.path.insert(0, %r)\n"
            "import conftest\n"
            "from bench_port import harness\n"
            "for cell in conftest.CELLS:\n"
            "    harness.run(cell, 1, 0.2, False, torch.device('cpu'),\n"
            "                time.perf_counter(), config=conftest.small(cell))\n"
            "print(harness.forbidden_modules())\n"
            % (ROOT, os.path.dirname(os.path.abspath(__file__))))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
