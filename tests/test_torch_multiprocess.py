"""Multi-process mechanics of the port: processes that join their group from
torchrun's environment (parallel.mesh.initialize_distributed), the PIGS
example and the scaling tool run to their end.

The twin of tests/test_multiprocess.py: two processes, bootstrapped from
RANK / WORLD_SIZE / MASTER_ADDR / MASTER_PORT, evaluate the dense path over
one global (1, 2) mesh on gloo; the loss and the gradient norm must match
dgs_tpu's single-process evaluation on the same inputs.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
from torch.distributed import TCPStore

from conftest import make_gaussians

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 300


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    env.update({k: str(v) for k, v in extra.items()})
    return env


def _run(args, env):
    p = subprocess.run([sys.executable, *args], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=TIMEOUT)
    assert p.returncode == 0, f"{args} failed:\n{p.stdout}\n{p.stderr}"
    return p.stdout


def test_two_processes_from_the_environment_match_one(rng, tmp_path):
    means, values, covs, conics = make_gaussians(rng, 64, 2, 3)
    samples = rng.uniform(-1.0, 1.0, (256, 2)).astype(np.float32)
    arrays = tmp_path / "arrays.npz"
    np.savez(arrays, means=means, values=values, covs=covs, conics=conics,
             samples=samples)
    # This process hosts the ranks' store on a port the system picks, as
    # torchrun's agent does (TORCHELASTIC_USE_AGENT_STORE): no rank binds a
    # port that another test could take first.
    store = TCPStore("localhost", 0, is_master=True, wait_for_workers=False)
    procs = [
        subprocess.Popen(
            [sys.executable, str(ROOT / "tests" / "torch_dist_worker.py"),
             "env_rank", str(arrays)],
            env=_env(RANK=r, LOCAL_RANK=r, WORLD_SIZE=2,
                     MASTER_ADDR="localhost", MASTER_PORT=store.port,
                     TORCHELASTIC_USE_AGENT_STORE=True,
                     TORCHELASTIC_RESTART_COUNT=0),
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
        for r in range(2)]
    results = {}
    try:
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT)
            assert p.returncode == 0, f"rank failed:\n{out}\n{err}"
            for line in out.splitlines():
                if line.startswith("RESULT "):
                    r = json.loads(line[len("RESULT "):])
                    results[r["rank"]] = r
    finally:
        for p in procs:
            p.kill()
    assert set(results) == {0, 1}

    import jax

    from dgs_tpu.ops import sampling

    def loss(m, v, c):
        outs = sampling.sample_dense_all(m, v, c, jnp.asarray(samples),
                                         orders=("value", "derivative"))
        return sum(jnp.sum(o * o) for o in outs.values())

    l_ref, g = jax.value_and_grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(means), jnp.asarray(values), jnp.asarray(conics))
    gn_ref = float(sum(jnp.sum(x * x) for x in g))
    for rank, r in results.items():
        assert r["loss"] == pytest.approx(float(l_ref), rel=1e-5), rank
        assert r["gnorm"] == pytest.approx(gn_ref, rel=1e-4), rank


def test_train_pigs_example_runs(tmp_path):
    metrics, ckpt = tmp_path / "m.jsonl", tmp_path / "state.pt"
    out = _run(["-m", "dgs_tpu_torch.examples.train_pigs", "--device", "cpu",
                "--gaussians", "64", "--steps", "3", "--collocation", "256",
                "--log-every", "1", "--metrics", str(metrics),
                "--checkpoint", str(ckpt)], _env())
    assert "final loss:" in out and ckpt.exists()
    records = [json.loads(x) for x in metrics.read_text().splitlines()]
    assert [r["step"] for r in records] == [0, 1, 2]
    assert all(np.isfinite(r["loss"]) and r["bin_overflow"] == 0
               for r in records)


SCALE = dict(SCALE_BACKEND="gloo", SCALE_DEVICE="cpu", SCALE_P=64,
             SCALE_N=256, SCALE_STEPS=2)


def _lines(out):
    return [json.loads(x) for x in out.splitlines() if x.startswith("{")]


@pytest.mark.parametrize("mode", ["replicated", "model"])
def test_scaling_bench_spawns_world_sizes_1_and_2(mode):
    out = _run(["-m", "dgs_tpu_torch.tools.scaling_bench"],
               _env(**SCALE, SCALE_MODE=mode, SCALE_DEVICES="1,2"))
    lines = _lines(out)
    assert [r["devices"] for r in lines] == [1, 2]
    assert lines[1]["mesh"] == ([1, 2] if mode == "model" else [2, 1])
    assert all(r["mode"] == mode and r["value"] > 0 and r["backend"] == "gloo"
               and np.isfinite(r["loss"]) for r in lines)
    assert lines[0]["scaling_efficiency_vs_first_count"] == 1.0


def test_scaling_bench_under_torchrun():
    """Two ranks launched by torchrun join through initialize_distributed;
    rank 0 prints the one line."""
    out = _run(["-m", "torch.distributed.run", "--standalone",
                "--nproc-per-node", "2", "-m",
                "dgs_tpu_torch.tools.scaling_bench"], _env(**SCALE))
    (line,) = _lines(out)
    assert line["devices"] == 2 and line["mesh"] == [2, 1]


def test_new_modules_leave_jax_out():
    """The sharded paths, the example, the measuring tools and the tests'
    rank-side module import no JAX and nothing of dgs_tpu (spawned ranks
    import them afresh)."""
    tools = sorted(p.stem for p in (ROOT / "dgs_tpu_torch" / "tools").glob(
        "*.py") if p.stem != "__init__")
    assert {"_common", "bench", "profile_step", "profile_bench",
            "train_100k", "bench_aggregate", "profile_aggregate",
            "profile_dynamics", "sweep_tile", "sweep_chunked",
            "scaling_bench"} <= set(tools)
    code = ("import sys; sys.path.insert(0, 'tests'); "
            "import dgs_tpu_torch.parallel.mesh, "
            "dgs_tpu_torch.examples.train_pigs, "
            + "".join(f"dgs_tpu_torch.tools.{t}, " for t in tools) +
            "torch_dist_worker; "
            "bad = [m for m in sys.modules "
            "if m == 'jax' or m.startswith(('jax.', 'dgs_tpu.'))"
            " or m == 'dgs_tpu']; "
            "assert not bad, bad")
    _run(["-c", code], _env())
