"""Scaling benchmark of the sharded PIGS step: collocation points a second
against the number of ranks (config 5's question).

The counterpart of tools/scaling_bench.py.  Each rank runs the tiled PIGS
step of dgs_tpu_torch.parallel.mesh (fused forward + backward, Adam):
replicated parameters with the points sharded over every rank
(SCALE_MODE=replicated), or the Gaussians sharded over a "model" axis of 2
(SCALE_MODE=model; partial mixtures summed over it, the optimizer
shard-local, the capacities planned for every shard by
parallel.mesh.plan_sharded_config).  Weak scaling by default: SCALE_P Gaussians (times the model
ranks) and SCALE_N points a rank.  SCALE_STRONG=1 holds SCALE_P and SCALE_N
as totals across world sizes (rounded up to a multiple of every count).
Prints one JSON line per world size, with the efficiency against the first
size measured.

    # one rank on the card (NCCL)
    python -m dgs_tpu_torch.tools.scaling_bench
    # every card of a host, one process each
    torchrun --nproc-per-node 4 -m dgs_tpu_torch.tools.scaling_bench
    # world sizes 1, 2 and 4 spawned here, gloo on the CPU
    SCALE_BACKEND=gloo SCALE_DEVICE=cpu SCALE_DEVICES=1,2,4 \\
        python -m dgs_tpu_torch.tools.scaling_bench

Run alone, it spawns one process group per count in SCALE_DEVICES (default
1), joined through a file store in a temporary directory, rank r on card r
modulo the host's cards; under torchrun it measures the launched world
size.  Env: SCALE_P, SCALE_N, SCALE_STEPS, SCALE_MODE, SCALE_DEVICES,
SCALE_STRONG, SCALE_BACKEND (default nccl; gloo for the CPU or for several
ranks on one card) and SCALE_DEVICE (default cuda).  A host with one card measures one
rank: it cannot show scaling, and ranks sharing a card share its time.
"""

import json
import math
import os
import sys
import tempfile
import time


def _settings():
    env = os.environ.get
    return dict(P=int(env("SCALE_P", 20_000)), N=int(env("SCALE_N", 100_000)),
                steps=int(env("SCALE_STEPS", 5)),
                mode=env("SCALE_MODE", "replicated"),
                strong=env("SCALE_STRONG", "") not in ("", "0"),
                backend=env("SCALE_BACKEND", "nccl"),
                device=env("SCALE_DEVICE", "cuda"))


def measure(s) -> dict:
    """(points a second, seconds a step) of the sharded step on this
    rank's process group, timed on the synchronised host clock over
    ``steps`` steps after one warm step (kernel build and planning)."""
    import torch
    import torch.distributed as dist

    from dgs_tpu_torch.config import SamplerConfig
    from dgs_tpu_torch.models import pigs
    from dgs_tpu_torch.models.field import init_field
    from dgs_tpu_torch.parallel import mesh as pm

    n = dist.get_world_size()
    device = torch.device(s["device"])
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    model = s["mode"] == "model"
    n_model = 2 if model and n % 2 == 0 else 1
    mesh = pm.make_mesh((n // n_model, n_model), device.type)
    P = s["P"] if s["strong"] else s["P"] * n_model
    N = s["N"] if s["strong"] else s["N"] * n
    u_star, f_rhs = pigs.manufactured_solution(2)
    gen = torch.Generator(device=device).manual_seed(0)
    field = init_field(gen, P, 2, 1, sigma=2.0 / math.sqrt(P))
    probe = 2.0 * torch.rand((min(N, 65_536), 2), generator=gen,
                             device=device) - 1.0
    if model:
        # Each rank bins only its shard: plan the capacities every shard
        # needs.
        cfg = pigs.drift_headroom(pm.plan_sharded_config(
            SamplerConfig(), mesh, field.means, field.covariances(), probe))
        step, shard_field = pm.make_model_sharded_pigs_step(
            cfg, mesh, f_rhs, u_star, method="tiled")
        field = shard_field(field)
    else:
        cfg = pigs.auto_config(SamplerConfig(), field, probe, P)
        step = pm.make_sharded_pigs_step(cfg, mesh, f_rhs, u_star,
                                         method="tiled")
        pm.replicate(field, mesh)
    opt = torch.optim.Adam(field.parameters(), lr=1e-3, eps=1e-8)

    def run(seed):
        col, dx = pm.pigs_points(mesh, seed, N, 2, model_sharded=model)
        return step(field, opt, col, dx)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    run(0)
    sync()
    t0 = time.perf_counter()
    for i in range(s["steps"]):
        metrics = run(i + 1)
    sync()
    dt = (time.perf_counter() - t0) / s["steps"]
    over = {k: int(metrics[k]) for k in pigs.DIAGNOSTICS if int(metrics[k])}
    if over:
        raise RuntimeError(f"binning overflow: {over}")
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    return {"devices": n, "mesh": [n // n_model, n_model], "P": P, "N": N,
            "value": N / dt, "step_s": dt, "loss": float(metrics["loss"]),
            "device_kind": kind}


def _spawned_rank(rank, n, store, s, queue):
    import torch
    import torch.distributed as dist

    if s["device"] == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(s["backend"], init_method=f"file://{store}",
                            rank=rank, world_size=n)
    try:
        r = measure(s)
        if rank == 0:
            queue.put(r)
    finally:
        dist.destroy_process_group()


def _spawn(n, s) -> dict:
    import torch.multiprocessing as mp

    queue = mp.get_context("spawn").SimpleQueue()
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_spawned_rank,
                           args=(n, os.path.join(tmp, "store"), s, queue),
                           nprocs=n, start_method="spawn")
    return queue.get()


def _line(r, s, base) -> str:
    eff = (r["value"] / base["value"]) * (base["devices"] / r["devices"])
    return json.dumps({
        "metric": ("strong" if s["strong"] else "weak")
                  + "_scaling_samples_per_sec",
        "mode": s["mode"], **r,
        "scaling_efficiency_vs_first_count": eff,
        "baseline_devices": base["devices"], "backend": s["backend"]})


def main():
    s = _settings()
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        import torch.distributed as dist

        from dgs_tpu_torch.parallel import mesh as pm

        pm.initialize_distributed(s["backend"], init_method="env://")
        try:
            r = measure(s)
            if dist.get_rank() == 0:
                print(_line(r, s, r), flush=True)
        finally:
            dist.destroy_process_group()
        return
    counts = [int(x) for x in os.environ.get("SCALE_DEVICES", "1").split(",")
              if x]
    if s["strong"]:
        lcm = math.lcm(*counts)
        N, P = -(-s["N"] // lcm) * lcm, -(-s["P"] // lcm) * lcm
        if (N, P) != (s["N"], s["P"]):
            print(f"note: rounding SCALE_N {s['N']}->{N}, SCALE_P "
                  f"{s['P']}->{P} to a multiple of the counts {counts}",
                  file=sys.stderr)
        s.update(N=N, P=P)
    base = None
    for n in counts:
        r = _spawn(n, s)
        base = base or r
        print(_line(r, s, base), flush=True)


if __name__ == "__main__":
    main()
