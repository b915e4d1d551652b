"""BENCHMARK.json against the contract's rules, and every name it holds
against its file."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def spec():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def line_ok(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_contract_shape():
    s = spec()
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert set(s) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(s["paths"]) <= 16
    assert all(PATH.match(p) and ".." not in p and not p.startswith("/")
               for p in s["paths"])
    assert 1 <= len(s["command"]) <= 32 and all(line_ok(w)
                                                for w in s["command"])
    assert isinstance(s["run_seconds"], int) and 1 <= s["run_seconds"] <= 51
    cells = 24
    assert (2 + 14 * cells) * (s["run_seconds"] + 60) + cells * 180 \
        + 1200 <= 43200
    assert 1 <= len(s["configs"]) <= 24 and 1 <= len(s["workloads"]) <= 24
    for c in s["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line_ok(c["source"])
        assert line_ok(c["why"]) and len(c["reduced"]) <= 16
        assert c["file"].startswith(s["paths"][0] + "/")
        assert all(NAME.match(k) for k in c["reduced"])
    names = [c["name"] for c in s["configs"]]
    assert len(set(names)) == len(names)
    assert len({c["file"] for c in s["configs"]}) == len(names)
    pairs = set()
    for w in s["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert line_ok(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    assert {w["config"] for w in s["workloads"]} == set(names)
    assert sum(w["chips"] == 4 for w in s["workloads"]) <= max(
        1, len(s["workloads"]) // 4)


def test_metrics_rules():
    s = spec()
    cells = {w["name"] for w in s["workloads"]}
    e2e = {m["name"]: m for m in s["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    assert 1 <= len(s["end_to_end"]) <= 16
    assert 1 <= len(s["per_layer"]) <= 128
    metric_names = list(e2e) + [m["name"] for m in s["per_layer"]]
    assert len(set(metric_names)) == len(metric_names)
    for m in s["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in s["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e and line_ok(m["layer"])
        for w in m["workloads"]:
            assert w in cells
            assert w in e2e[m["moves"]].get("workloads", cells)
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
        layers.setdefault(m["name"].split(".")[0], m["layer"])
    for m in s["end_to_end"] + s["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for w in cells:
        mine = [m for m in s["end_to_end"]
                if w in m.get("workloads", cells)]
        assert "setup_s" in {m["name"] for m in mine} and len(mine) >= 2
        assert any(w in m.get("workloads", ()) for m in s["per_layer"])


def test_every_name_resolves():
    sys.path.insert(0, ROOT)
    from bench_port import harness

    s = spec()
    for c in s["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"]))
    for w in s["workloads"]:
        c = harness.cell_spec(s, w["name"])
        assert c["config"]["name"] == w["config"]
        assert harness.path_module(c["config"]["path"]).System
        assert c["traffic"]["kind"] in ("train", "eval")
        for m in c["per_layer"]:
            assert callable(harness.reader(m["name"]))
        assert set(c["limits"]) >= {"overflow"}


def test_added_metric_is_found(tmp_path):
    """A later change adds a per-layer metric by a reader file and an
    entry, and edits no file that is there."""
    shutil.copytree(os.path.join(ROOT, "bench_port"), tmp_path / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    s = spec()
    s["per_layer"].append({
        "name": "probe_ms.train", "unit": "ms", "better": "lower",
        "source": "device_trace", "layer": "step",
        "moves": "train_samples_per_s", "workloads": ["d3_chunked.train3"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(s))
    (tmp_path / "bench_port" / "metrics" / "probe_ms.py").write_text(
        "def read(ctx):\n    return 42.0\n")
    code = ("from bench_port import harness\n"
            "c = harness.cell_spec(harness.benchmark(), 'd3_chunked.train3')\n"
            "names = [m['name'] for m in c['per_layer']]\n"
            "assert 'probe_ms.train' in names, names\n"
            "print(harness.reader('probe_ms.train')(None))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "42.0"


@pytest.mark.parametrize("cell", ["d3_chunked.train3", "dense10k.eval4"])
def test_reader_fallback_and_silence(cell):
    """Readers of '<name>.train' come from '<name>.py'; a reader that finds
    no device items returns None (the harness leaves the metric out)."""
    from bench_port import harness, trace

    c = harness.cell_spec(spec(), cell)
    ctx = trace.Context(c["traffic"]["kind"], c["config"], c["traffic"],
                        {"pairs": 1, "entries": 1, "wrapped": False}, 1, 1.0,
                        [], 1, [], step_s=1.0)
    for m in c["per_layer"]:
        if m["name"].startswith("mfu"):
            continue
        assert harness.reader(m["name"])(ctx) is None, m["name"]


@pytest.mark.parametrize("traffic", ["train3", "eval3"])
def test_added_config_of_another_dimension_runs(tmp_path, traffic):
    """A later change adds a configuration in D = 2 by a configuration
    file, a limits file and entries, and edits no file that is there; a
    run of its cell is correct at a small size on the CPU."""
    shutil.copytree(os.path.join(ROOT, "bench_port"), tmp_path / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    s = spec()
    base = os.path.join(ROOT, "bench_port")
    with open(os.path.join(base, "configs", "d3_chunked.json")) as f:
        cfg = json.load(f)
    cfg.update(name="d2_probe", D=2, P=400, N=4000, sigma=0.03, tile=0.1,
               reference_pairs=1 << 18)
    (tmp_path / "bench_port" / "configs" / "d2_probe.json").write_text(
        json.dumps(cfg))
    cell = "d2_probe." + traffic
    src = "d3_chunked." + traffic
    shutil.copy(os.path.join(base, "limits", src + ".json"),
                tmp_path / "bench_port" / "limits" / (cell + ".json"))
    s["configs"].append({"name": "d2_probe", "source": "https://example.org",
                         "file": "bench_port/configs/d2_probe.json",
                         "reduced": [], "why": "probe"})
    s["workloads"].append({"name": cell, "config": "d2_probe",
                           "traffic": traffic, "chips": 1, "why": "probe"})
    for m in s["end_to_end"] + s["per_layer"]:
        if src in m.get("workloads", ()):
            m["workloads"].append(cell)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(s))
    code = ("import json, time, torch\n"
            "from bench_port import harness\n"
            "for trace in (False, True):\n"
            "    res = harness.run(%r, 5, 0.3, trace, torch.device('cpu'),\n"
            "                      time.perf_counter())\n"
            "    print(json.dumps([res['correct'], sorted(res['metrics'])]))\n"
            % cell)
    # The copy's bench_port first, the program from the repository.
    env = {**os.environ, "PYTHONPATH": ROOT}
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=600, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    untraced, traced = (json.loads(x)
                        for x in out.stdout.strip().splitlines()[-2:])
    assert untraced[0] and traced[0], out.stderr[-3000:]
    kind = "train" if traffic.startswith("train") else "eval"
    assert "mfu." + kind in traced[1]
