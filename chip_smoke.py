"""On-card smoke run of the PyTorch + CUDA port (dgs_tpu_torch).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, one JSON line each (any failure raises and exits non-zero):

  1. device  - torch and CUDA versions, the card's name and power limit.
  2. build   - builds the CUDA kernel library (nvcc, sm_90a) and the host
               capacity planner (g++) from the sources; seconds and the
               ptxas register / spill report.
  3. parity  - the tiled forward CUDA kernel against its plain torch version
               on the same operands: D in {1, 2, 3}, all four orders,
               wrapped and unwrapped, plus full-cover (wide) Gaussians, at
               P = 5,000 x N = 50,000; and the facade against the dense
               masked oracle on a small input.
  4. slice   - the evaluation path at full width: GaussianSampler
               (method "tiled") preprocess + sample_all(value, derivative,
               laplacian) at P = 100,000 Gaussians x N = 1,000,000 samples,
               D = 2, C = 4, with capacities from the host planner.  Checks
               the diagnostics, that the main path launched the kernel,
               finite outputs, and kernel-vs-plain parity on all samples;
               times the kernel, the plain version and the path end to end.

Then the kernels line and, last, the result line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
The script imports no JAX and nothing of the JAX package.
"""

import dataclasses
import json
import math
import re
import statistics
import subprocess
import time

import torch

from dgs_tpu_torch.binning import grid as binning
from dgs_tpu_torch.config import ORDERS, SamplerConfig
from dgs_tpu_torch.kernels import _build
from dgs_tpu_torch.kernels import tiled as ktiled
from dgs_tpu_torch.models.field import init_field
from dgs_tpu_torch.ops import formulas, sampling
from dgs_tpu_torch.oracle import dense as oracle
from dgs_tpu_torch.sampler import GaussianSampler
from dgs_tpu_torch.utils import native

RTOL = 2e-4          # the JAX suite's kernel-vs-oracle tolerance:
ATOL_REL = 1e-5      # atol = 1e-5 * max(1, max|ref|)
SLICE_ORDERS = ("value", "derivative", "laplacian")


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def compare(got, ref, orders, D, C):
    """Per-order (max abs err, max abs err / max|ref|), raising when an
    order is outside the tolerance."""
    errs, k0 = {}, 0
    for order in orders:
        rows = slice(k0 * C, (k0 + formulas.n_unique(order, D)) * C)
        g, r = got[rows], ref[rows]
        scale = max(1.0, float(r.abs().max()))
        diff = (g - r).abs()
        bad = diff > ATOL_REL * scale + RTOL * r.abs()
        if bool(bad.any()):
            raise AssertionError(
                f"kernel disagrees with the plain version on {order}: "
                f"{int(bad.sum())} values, max abs err {float(diff.max())}")
        errs[order] = (float(diff.max()),
                       float(diff.max()) / max(float(r.abs().max()), 1e-30))
        k0 += formulas.n_unique(order, D)
    return errs


def operands(state, field_tensors, samples, cfg):
    means, values, conics = field_tensors
    _, _, geom, _ = ktiled.prepare_entries(
        state, means, values, conics, ktiled.BLOCK_E, cfg=cfg)
    smp, _, Np = ktiled.prepare_samples(state, samples, ktiled.BLOCK_N)
    lo, n = ktiled.entry_ranges(state, Np)
    return geom, smp, lo, n


def cuda_ms(fn, reps=10):
    """Median of ``reps`` CUDA-event timings of fn(), after one warm-up."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def planned_config(cfg, means, covs, samples):
    plan = native.plan_capacities(cfg, means, covs, samples)
    return native.config_from_plan(cfg, plan, means.shape[0]), plan


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device visible "
                         "(torch.cuda.is_available() is False)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit("device", torch=torch.__version__, cuda=torch.version.cuda,
         name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=smi)


def phase_build():
    t0 = time.perf_counter()
    _build.load()
    t_kern = time.perf_counter() - t0
    t0 = time.perf_counter()
    native._load()
    t_plan = time.perf_counter() - t0
    log = _build.build_log()
    regs = [int(x) for x in re.findall(r"Used (\d+) registers", log)]
    spills = [int(x) for x in re.findall(r"(\d+) bytes spill stores", log)]
    stack = [int(x) for x in re.findall(r"(\d+) bytes stack frame", log)]
    emit("build", kernels_s=round(t_kern, 3), planner_s=round(t_plan, 3),
         n_kernels=len(regs), max_registers=max(regs, default=0),
         spill_store_bytes=sum(spills), max_stack_frame=max(stack, default=0))


def phase_parity(dev, P_small=5000, N_small=50000):
    cases = []
    for D in (1, 2, 3):
        for unwrapped in (False, True):
            cases.append((D, unwrapped, 0.03))
    cases.append((2, False, 0.6))   # full-cover footprints, wrapped
    for D, unwrapped, sigma in cases:
        P, N, C = (P_small if sigma < 0.5 else 200), N_small, 4
        g = torch.Generator(device=dev).manual_seed(10 + D)
        field = init_field(g, P, D, C, sigma=sigma)
        samples = 2.0 * torch.rand((N, D), generator=g, device=dev) - 1.0
        with torch.no_grad():
            means, values = field.means.detach(), field.values.detach()
            covs, conics = field.covariances(), field.conics()
        cfg, plan = planned_config(
            SamplerConfig(tile_size=0.1275, eig_floor=1e-12).with_dims(D),
            means, covs, samples)
        if unwrapped and not plan["safe_unwrapped"]:
            raise AssertionError(f"D={D}: planner does not certify the "
                                 "unwrapped kernels for this case")
        cfg = dataclasses.replace(cfg, unwrapped_kernels=unwrapped)
        state = binning.build(cfg, means, covs, samples)
        assert int(state.overflow) == 0 and int(state.entry_overflow) == 0
        geom, smp, lo, n = operands(state, (means, values, conics), samples,
                                    cfg)
        period = None if unwrapped else cfg.period
        got = ktiled.tiled_forward(ORDERS, period, D, C, geom, smp, lo, n)
        ref = ktiled.tiled_forward_plain(ORDERS, period, D, C, geom, smp,
                                         lo, n)
        torch.cuda.synchronize()
        errs = compare(got, ref, ORDERS, D, C)
        emit("parity", D=D, unwrapped=unwrapped, sigma=sigma, P=P, N=N,
             entries=int((state.ent_tile < binning.num_tiles(cfg, D)).sum()),
             err={o: {"max_abs": e[0], "rel": e[1]} for o, e in errs.items()})

    # The facade on the card against the dense masked oracle (an independent
    # reference: no binning ranges, no plain-kernel code).
    for D in (1, 2, 3):
        g = torch.Generator(device=dev).manual_seed(20 + D)
        field = init_field(g, 300, D, 3, sigma=0.05)
        samples = 2.0 * torch.rand((2000, D), generator=g, device=dev) - 1.0
        with torch.no_grad():
            m, v = field.means.detach(), field.values.detach()
            cov, con = field.covariances(), field.conics()
        cfg, _ = planned_config(SamplerConfig(tile_size=0.25).with_dims(D),
                                m, cov, samples)
        s = GaussianSampler(debug=True, config=cfg)
        s.preprocess(m, v, cov, con, samples)
        outs = s.sample_all(ORDERS)
        mask = binning.pair_mask_dense(cfg, s.state, samples, 300)
        err = {}
        for order in ORDERS:
            ref = oracle.evaluate(order, m, v, con, samples, period=cfg.period,
                                  pair_mask=mask)
            scale = max(1.0, float(ref.abs().max()))
            diff = (outs[order] - ref).abs()
            if bool((diff > ATOL_REL * scale + RTOL * ref.abs()).any()):
                raise AssertionError(f"facade vs oracle D={D} {order}: max "
                                     f"abs err {float(diff.max())}")
            err[order] = float(diff.max())
        emit("parity_oracle", D=D, P=300, N=2000, max_abs_err=err)


def phase_slice(dev, P=100_000, N=1_000_000):
    D, C = 2, 4
    g = torch.Generator(device=dev).manual_seed(0)
    field = init_field(g, P, D, C, sigma=2.0 / math.sqrt(P))
    samples = 2.0 * torch.rand((N, D), generator=g, device=dev) - 1.0
    with torch.no_grad():
        means, values = field.means.detach(), field.values.detach()
        covs, conics = field.covariances(), field.conics()
    t0 = time.perf_counter()
    cfg, plan = planned_config(
        SamplerConfig(tile_size=0.051, eig_floor=1e-12,
                      max_tiles_per_gaussian=3, axis_radii=True,
                      ellip_cull=False),
        means, covs, samples)
    plan_s = time.perf_counter() - t0
    sampler = GaussianSampler(config=cfg)

    def run():
        sampler.preprocess(means, values, covs, conics, samples)
        return sampler.sample_all(SLICE_ORDERS)

    run()                               # warm-up (allocator, planner caches)
    torch.cuda.synchronize()
    ktiled.tiled_forward.launches = 0
    e2e = []
    for _ in range(5):
        t0 = time.perf_counter()
        outs = run()
        torch.cuda.synchronize()
        e2e.append((time.perf_counter() - t0) * 1e3)
    launches = ktiled.tiled_forward.launches
    if launches != 5:
        raise AssertionError(f"main path launched tiled_forward {launches} "
                             "times in 5 runs")

    state = sampler.state
    _, diag = sampling.sample_binned(cfg, means, values, conics, covs,
                                     samples, SLICE_ORDERS)
    diag = {k: int(v) for k, v in diag.items() if k != "perm"}
    if any(diag.values()):
        raise AssertionError(f"overflow diagnostics not zero: {diag}")
    shapes = {o: list(outs[o].shape) for o in SLICE_ORDERS}
    want = {"value": [N, C], "derivative": [N, D, C],
            "laplacian": [N, D, D, C]}
    if shapes != want:
        raise AssertionError(f"output shapes {shapes}, expected {want}")
    for o in SLICE_ORDERS:
        if not bool(torch.isfinite(outs[o]).all()):
            raise AssertionError(f"non-finite {o} output")

    T = binning.num_tiles(cfg, D)
    ent_count = torch.diff(state.ent_start)[:T].long()
    smp_count = torch.diff(state.s_start)[:T].long()
    pairs = int((ent_count * smp_count).sum())
    entries = int(ent_count.sum())

    period = None if cfg.unwrapped_kernels else cfg.period
    geom, smp, lo, n = operands(state, (means, values, conics), samples, cfg)
    swept = int(n.long().sum()) * ktiled.BLOCK_N
    got = ktiled.tiled_forward(SLICE_ORDERS, period, D, C, geom, smp, lo, n)
    ref = ktiled.tiled_forward_plain(SLICE_ORDERS, period, D, C, geom, smp,
                                     lo, n)
    torch.cuda.synchronize()
    errs = compare(got, ref, SLICE_ORDERS, D, C)
    kernel_ms = cuda_ms(lambda: ktiled.tiled_forward(
        SLICE_ORDERS, period, D, C, geom, smp, lo, n))
    plain_ms = cuda_ms(lambda: ktiled.tiled_forward_plain(
        SLICE_ORDERS, period, D, C, geom, smp, lo, n))
    emit("slice", P=P, N=N, D=D, C=C, tile=cfg.tile_size,
         unwrapped_kernels=cfg.unwrapped_kernels,
         max_tiles_per_gaussian=cfg.max_tiles_per_gaussian,
         entries=entries, pairs=pairs, swept_pairs_bound=swept,
         diagnostics=diag, launches=launches, output_shapes=shapes,
         compared_samples=N,
         err={o: {"max_abs": e[0], "rel": e[1]} for o, e in errs.items()},
         kernel_ms=kernel_ms, plain_ms=plain_ms,
         e2e_ms_median=statistics.median(e2e), e2e_ms=e2e,
         planner_s=round(plan_s, 3))
    return {"launches": launches,
            "max_abs_err": max(e[0] for e in errs.values()),
            "ms": kernel_ms, "plain_ms": plain_ms}


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    phase_parity(dev)
    k = phase_slice(dev)
    print(json.dumps({"kernels": [{
        "name": "tiled_forward", "route": "cuda",
        "source": "dgs_tpu_torch/csrc/tiled_forward.cu",
        "replaces": "dgs_tpu/kernels/tiled.py:727",
        **k,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
