"""Headline benchmark of the port: Gaussian point-samples a second, fused
forward + backward, on the card.

The counterpart of bench.py.  One training step of its loss
(bench.py:176-214): the Gaussians re-binned, the fused value + derivative +
Hessian forward of ``models.pigs.field_outputs`` over a ``GaussianField``
(so the gradient reaches log-scales and rotations through the conics), the
multiplicity-weighted sum of squares over the tile-sorted unique padded
outputs divided by N, ``backward()``, and every parameter moved by
p - 1e-12 g, so that each step depends on the one before.  The defaults by
D are bench.py's: D = 2 runs ``tiled`` at tile 0.051; D = 3 runs
``chunked`` at tile 0.2 with per-axis radii and the ellipsoid cull, planned
once by ``plan_chunked``.  The sample side is binned once.

    python -m dgs_tpu_torch.tools.bench              # D = 2 on the card
    BENCH_D=3 python -m dgs_tpu_torch.tools.bench    # the D = 3 workload

Prints two JSON lines: the metric line (``metric``, ``value``, ``unit``,
``vs_speed_of_light`` against ``utils.roofline.step_roofline`` at the
H100's peaks) and a ``detail`` line (median step and its range on the
synchronised host clock, device busy ms and launches a step, entries,
kept pairs, peak bytes, the diagnostics).  bench.py's ``vs_baseline``
divides by a target set for the TPU and is left out.  Every diagnostic is
read after the timing; one that is not zero raises.

Env: BENCH_P, BENCH_N, BENCH_D, BENCH_C, BENCH_STEPS, BENCH_METHOD (tiled,
chunked, pallas, dense), BENCH_TILE, BENCH_R, BENCH_SIGMA,
BENCH_EIG_FLOOR, BENCH_AXIS, BENCH_ELLIP, BENCH_ORDERS (comma list) and
BENCH_DEVICE (default cuda; cpu runs the kernels' plain versions).
BENCH_MOMENTS, BENCH_SEP, BENCH_FASTMATH, BENCH_FOLDED, BENCH_FDV,
BENCH_FVJP and BENCH_HMM select the kernel modes as in bench.py (unset: the
automatic default, which turns the separable and moment modes on under
BENCH_FASTMATH=1 at wrap-free D = 3); BENCH_SPAN_F/B (default 2 at D = 2,
else 1) are accepted and not read.  The TPU-only knobs (BENCH_BN/BP/BBN/BBP)
raise ``_common.UnsupportedKnob``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import NamedTuple, Optional

import torch

from ..binning import grid as binning
from ..config import SamplerConfig
from ..models import pigs
from ..models.field import GaussianField, init_field
from ..ops import formulas, sampling_chunked
from ..utils import native
from ..utils.roofline import step_roofline
from . import _common

DEFAULT_ORDERS = "value,derivative,laplacian"


def settings(env=None) -> dict:
    """bench.py's settings from ``env`` (default os.environ)."""
    env = os.environ if env is None else env
    _common.refuse(env)
    D = int(env.get("BENCH_D", 2))
    P = int(env.get("BENCH_P", 100_000))
    return dict(
        P=P, N=int(env.get("BENCH_N", 1_000_000)), D=D,
        C=int(env.get("BENCH_C", 4)),
        steps=int(env.get("BENCH_STEPS", 10)),
        method=env.get("BENCH_METHOD", "chunked" if D == 3 else "tiled"),
        tile=float(env.get("BENCH_TILE", {2: 0.051, 3: 0.2}.get(D, 0.1))),
        R=int(env.get("BENCH_R", 3)),
        sigma=float(env.get("BENCH_SIGMA", 2.0 / max(P, 1) ** (1.0 / D))),
        eig_floor=float(env.get("BENCH_EIG_FLOOR", 1e-12)),
        axis_radii=env.get("BENCH_AXIS", "1") == "1",
        ellip_cull=env.get("BENCH_ELLIP", "1" if D >= 3 else "0") == "1",
        orders=tuple(env.get("BENCH_ORDERS", DEFAULT_ORDERS).split(",")),
        device=env.get("BENCH_DEVICE", "cuda"),
        flags=_common.mode_flags(env, separable=True, moments=True,
                                 fast_math=True, folded=True,
                                 folded_backward=True,
                                 span=2 if D == 2 else 1))


class Workload(NamedTuple):
    """A field, its samples and what the step needs to evaluate it."""

    field: GaussianField
    samples: torch.Tensor
    cfg: SamplerConfig
    method: str
    orders: tuple
    plan: Optional[sampling_chunked.ChunkPlan]  # the chunked path's
    sb: object   # SampleBinning (tiled), ChunkedSamples (chunked) or None


def config(s: dict) -> SamplerConfig:
    """The configuration of settings ``s`` before planning, with the kernel
    mode and span flags of ``s["flags"]`` (mode_flags) where it has them."""
    return SamplerConfig(tile_size=s["tile"], max_tiles_per_gaussian=s["R"],
                         eig_floor=s["eig_floor"], axis_radii=s["axis_radii"],
                         ellip_cull=s["ellip_cull"], **s.get("flags", {}))


def field_and_samples(P, N, D, C, sigma, dev, seed=0):
    """A seeded field (init_field) and N uniform samples on [-1, 1)^D."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    field = init_field(gen, P, D, C, sigma=sigma)
    samples = 2.0 * torch.rand((N, D), generator=gen, device=dev) - 1.0
    return field, samples


def plan(cfg: SamplerConfig, method: str, field: GaussianField, samples,
         orders) -> Workload:
    """The workload under its plan: ``plan_chunked`` and the chunked sample
    side for "chunked"; the host planner's exact capacities and the sample
    binning for "tiled"; nothing for the all-pairs methods."""
    with torch.no_grad():
        means, covs = field.means.detach(), field.covariances()
    cplan = sb = None
    if method == "chunked":
        cfg, cplan = sampling_chunked.plan_chunked(cfg, means, covs, samples)
        sb = sampling_chunked.chunk_samples(cfg, samples, cplan, cfg.block_n)
    elif method == "tiled":
        cfg = native.config_from_plan(
            cfg, native.plan_capacities(cfg, means, covs, samples),
            means.shape[0])
        sb = binning.bin_samples(cfg, samples)
    return Workload(field, samples, cfg, method, tuple(orders), cplan, sb)


def loss(w: Workload):
    """(loss, diagnostics without ``perm``): bench.py's loss_fn."""
    field, N, D = w.field, w.samples.shape[0], w.samples.shape[1]
    packed = w.method in ("tiled", "chunked")
    if w.method == "chunked":
        outs, diag = sampling_chunked.sample_chunked(
            w.cfg, field.means, field.values, field.conics(),
            field.covariances(), w.samples, w.plan, w.sb, w.orders,
            padded_outputs=True)
    else:
        outs, diag = pigs.field_outputs(
            w.cfg, field, w.samples, orders=w.orders, method=w.method,
            sorted_outputs=packed, unique_outputs=packed,
            padded_outputs=packed, sample_binning=w.sb)
    if packed:
        # Padded outputs are (n_unique, C, Np) with zero pad columns: the
        # sum of squares over the full symmetric tensors is the
        # multiplicity-weighted one over the unique components.
        value = sum(torch.einsum(
            "ucn,u->", o * o, torch.tensor(
                formulas.sym_multiplicity(order, D), dtype=o.dtype,
                device=o.device)) for order, o in outs.items())
    else:
        value = sum(torch.sum(o * o) for o in outs.values())
    return value / N, {k: v for k, v in diag.items() if k != "perm"}


def train_step(w: Workload):
    """step() -> (loss, diagnostics): loss, backward(), and every field
    parameter moved by -1e-12 times its gradient (the dependency from one
    step to the next)."""
    params = list(w.field.parameters())

    def step():
        for p in params:
            p.grad = None
        value, diag = loss(w)
        value.backward()
        with torch.no_grad():
            for p in params:
                p.sub_(1e-12 * p.grad)
        return value.detach(), diag

    return step


def kept_pairs(w: Workload):
    """(kept same-tile pairs, valid entries) of the workload's binning:
    the tiled binning, or for "chunked" a binning under the plan's R and
    entry capacity, culled with the covariances' conics as plan_chunked
    counts."""
    cfg = w.cfg
    if w.method == "chunked":
        P = w.field.P
        cfg = dataclasses.replace(
            cfg, max_tiles_per_gaussian=w.plan.rect,
            entry_capacity_factor=w.plan.entries / P)
    sb = w.sb.binning if w.method == "chunked" else w.sb
    with torch.no_grad():
        state = binning.build(cfg, w.field.means, w.field.covariances(),
                              w.samples, sample_binning=sb)
    T = state.ent_start.shape[0] - 2
    ents = torch.diff(state.ent_start)[:T].long()
    smps = torch.diff(state.s_start)[:T].long()
    return int((ents * smps).sum()), int(ents.sum())


def entry_operands(w: Workload):
    """What each step of a "chunked" workload hands duplicate_entries:
    (cfg, means, radii, conics or None, R, E_cap), under the plan's R and
    entry capacity."""
    cfg, D, P = w.cfg, w.field.D, w.field.P
    with torch.no_grad():
        means = w.field.means.detach()
        radii = sampling_chunked._radii(cfg, w.field.covariances(), D)
        conics = (w.field.conics() if cfg.ellip_cull and D >= 2 else None)
    R = w.plan.rect
    return cfg, means, radii, conics, R, min(P * R ** D, w.plan.entries)


def measure(w: Workload, steps: int, dev) -> dict:
    """Time ``steps`` training steps of the workload, then its device busy
    time and launches a step and its peak bytes; raises on a diagnostic
    that is not zero.  {"ms_median", "ms_min", "ms_max", "busy_ms",
    "launches", "peak_bytes", "overflow", "loss"}."""
    step = train_step(w)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    (value, diag), times = _common.time_steps(step, steps, dev)
    over = _common.overflow(diag)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else None
    return {**times, **_common.activity(step, min(steps, 5), dev),
            "peak_bytes": peak, "overflow": over, "loss": float(value)}


def run(s: dict) -> list:
    """The metric and detail records of bench.py for settings ``s``."""
    dev = _common.torch_device(s["device"], "BENCH_DEVICE")
    field, samples = field_and_samples(s["P"], s["N"], s["D"], s["C"],
                                       s["sigma"], dev)
    w = plan(config(s), s["method"], field, samples, s["orders"])
    pairs = entries = roof = None
    if s["method"] in ("tiled", "chunked"):
        pairs, entries = kept_pairs(w)
        roof = step_roofline(s["orders"], s["D"], s["C"], pairs, s["N"],
                             entries, folded=bool(w.cfg.folded_values))
    m = measure(w, s["steps"], dev)
    dt = m["ms_median"] / 1e3
    card = _common.card(dev)
    return [
        {"metric": "gaussian_point_samples_per_sec_per_chip_fwd_bwd",
         "value": s["N"] / dt, "unit": "samples/s/chip",
         "vs_speed_of_light": roof and roof["sol_step_s"] / dt, **card},
        {"detail": {
            "P": s["P"], "N": s["N"], "D": s["D"], "C": s["C"],
            "orders": list(s["orders"]), "method": s["method"],
            "median_step_s": dt, "step_ms_min": m["ms_min"],
            "step_ms_max": m["ms_max"], "steps": s["steps"],
            "busy_ms_per_step": m["busy_ms"],
            "device_launches_per_step": m["launches"],
            "sigma": s["sigma"], "tile": w.cfg.tile_size,
            "max_tiles_per_gaussian": (w.plan.rect if w.plan
                                       else w.cfg.max_tiles_per_gaussian),
            "unwrapped_kernels": w.cfg.unwrapped_kernels,
            "entries": entries, "pairs": pairs,
            "peak_bytes": m["peak_bytes"], "overflow": m["overflow"],
            "loss": m["loss"], "roofline": roof}, **card},
    ]


def main():
    _common.print_records(run(settings()))


if __name__ == "__main__":
    main()
