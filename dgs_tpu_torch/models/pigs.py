"""PIGS-style physics-informed training loop (config 4 of BASELINE.json).

The counterpart of ``dgs_tpu/models/pigs.py``: per step, bin once, evaluate
u and its Hessian at collocation points, form a PDE residual loss, and
backpropagate to every Gaussian parameter (means, values and, through the
conic chain of models/field.py, log-scales and rotations).

The demo problem is a periodic Poisson equation with a manufactured solution:
    u*(x) = sum_k a_k * prod_d sin(pi k x_d + phi)     on the period-2 torus
    -laplace(u) = f := -laplace(u*)
loss = w_pde * mean((-tr H[u] - f)^2) + w_data * mean((u - u*)^2).

``torch.optim.Adam`` stands in for ``optax.adam`` (the same update with
eps=1e-8), a ``torch.Generator`` draws the collocation points, and the
training loop is a Python loop where the JAX package scans.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Dict, NamedTuple, Optional

import torch

from ..config import SamplerConfig
from ..ops import formulas, sampling
from .field import GaussianField, init_field


def manufactured_solution(D: int, n_modes: int = 3):
    """Periodic target field and its (negative) Laplacian on [-1,1]^D."""
    ks = [float(k) for k in range(1, n_modes + 1)]
    amps = [1.0 / k for k in ks]

    def u_star(x):  # (N, D) -> (N, 1)
        out = 0.0
        for i in range(n_modes):
            out = out + amps[i] * torch.prod(
                torch.sin(math.pi * ks[i] * x + 0.3 * i), dim=-1)
        return out[:, None]

    def f_rhs(x):  # -laplace(u*) at x
        out = 0.0
        for i in range(n_modes):
            lam = D * (math.pi * ks[i]) ** 2
            out = out + lam * amps[i] * torch.prod(
                torch.sin(math.pi * ks[i] * x + 0.3 * i), dim=-1)
        return out[:, None]

    return u_star, f_rhs


def field_outputs(cfg: SamplerConfig, field: GaussianField, samples,
                  orders=("value", "derivative", "laplacian"),
                  method: str = "tiled", sorted_outputs: bool = False,
                  unique_outputs: bool = False,
                  padded_outputs: bool = False, sample_binning=None):
    """Evaluate the requested orders; returns (outputs dict, diagnostics
    dict) as ops.sampling.sample_binned.

    ``method="tiled"`` bins once.  With ``sorted_outputs`` the rows stay
    tile-sorted and diag["perm"] maps them back to samples (losses evaluate
    their targets at samples[perm]); ``unique_outputs`` skips the symmetric
    mirror.  The all-pairs methods ("pallas": the dense kernels, "dense":
    plain torch) take no output mode: reference shapes in sample order,
    ``perm`` None and zero diagnostics."""
    if method == "tiled":
        return sampling.sample_binned(
            cfg, field.means, field.values, field.conics(),
            field.covariances(), samples, tuple(orders),
            sorted_outputs=sorted_outputs, unique_outputs=unique_outputs,
            padded_outputs=padded_outputs, sample_binning=sample_binning,
        )
    outs = sampling.sample_all(
        field.means, field.values, field.conics(), samples,
        period=cfg.period, orders=tuple(orders), method=method)
    zero = torch.zeros((), dtype=torch.int32, device=samples.device)
    return outs, {"perm": None, **{k: zero for k in DIAGNOSTICS}}


DIAGNOSTICS = ("bin_overflow", "entry_overflow", "work_overflow_fwd",
               "work_overflow_bwd")


def pigs_loss(cfg: SamplerConfig, field: GaussianField, collocation,
              data_x, data_u, f_rhs: Callable, *, w_pde: float = 1.0,
              w_data: float = 1.0, method: str = "tiled",
              outs_reduce: Optional[Callable] = None):
    """PDE residual + data loss; returns (loss, metrics), metrics holding
    the loss terms and the binning diagnostics as 0-d tensors.  On the
    tiled path outputs stay tile-sorted and unmirrored (the Laplacian is
    the trace of the unique Hessian components), so the targets are
    evaluated at the sorted points; the all-pairs methods give the full
    (N, D, D, C) Hessian in sample order.

    ``outs_reduce`` (optional) maps the raw field-outputs dict right after
    each evaluation: the hook through which Gaussian-sharded execution sums
    partial mixtures across shards before the nonlinear loss."""
    D = field.D
    use_tiled = method == "tiled"
    outs, diag = field_outputs(
        cfg, field, collocation, orders=("value", "laplacian"),
        method=method, sorted_outputs=use_tiled, unique_outputs=use_tiled)
    if outs_reduce is not None:
        outs = outs_reduce(outs)
    if use_tiled:
        col_pts = collocation[diag["perm"].long()]
        hessu = outs["laplacian"]                   # (N, tri, C) unique
        lap = sum(hessu[:, i, :] for i in formulas.unique_diag_indices(D))
    else:
        col_pts = collocation
        hess = outs["laplacian"]                    # (N, D, D, C)
        lap = torch.diagonal(hess, dim1=1, dim2=2).sum(dim=-1)
    pde = torch.mean((-lap - f_rhs(col_pts)) ** 2)

    outs_d, diag_d = field_outputs(
        cfg, field, data_x, orders=("value",), method=method,
        sorted_outputs=use_tiled, unique_outputs=use_tiled)
    if outs_reduce is not None:
        outs_d = outs_reduce(outs_d)
    if use_tiled:
        u_d = outs_d["value"][:, 0, :]
        tgt = data_u[diag_d["perm"].long()]
    else:
        u_d, tgt = outs_d["value"], data_u
    data = torch.mean((u_d - tgt) ** 2)

    loss = w_pde * pde + w_data * data
    metrics = {"loss": loss.detach(), "pde": pde.detach(),
               "data": data.detach(), **{k: diag[k] for k in DIAGNOSTICS}}
    return loss, metrics


def wrap_means(means, period):
    if period is None:
        return means
    return means - period * torch.round(means / period)


def train_step(cfg: SamplerConfig, field: GaussianField, optimizer,
               collocation, data_x, data_u, f_rhs: Callable, *,
               w_pde: float = 1.0, w_data: float = 1.0,
               method: str = "tiled") -> Dict[str, torch.Tensor]:
    """One training step on explicit inputs: loss, backward, optimizer
    step, means wrapped back onto the torus (in place).  Returns the
    step's metrics (0-d tensors, not synchronised)."""
    optimizer.zero_grad(set_to_none=True)
    loss, metrics = pigs_loss(cfg, field, collocation, data_x, data_u,
                              f_rhs, w_pde=w_pde, w_data=w_data,
                              method=method)
    loss.backward()
    optimizer.step()
    with torch.no_grad():
        field.means.copy_(wrap_means(field.means, cfg.period))
    return metrics


def make_train_step(cfg: SamplerConfig, optimizer, f_rhs: Callable,
                    u_star: Callable, generator: torch.Generator, *,
                    n_collocation: int = 4096, method: str = "tiled",
                    w_pde: float = 1.0, w_data: float = 1.0):
    """A step function step(field) -> metrics that draws fresh collocation
    points (n_collocation) and data points (n_collocation // 4) uniform on
    [-1, 1)^D from ``generator`` and runs train_step on them."""

    def step(field: GaussianField):
        D = field.D
        kw = dict(generator=generator, device=generator.device)
        collocation = 2.0 * torch.rand((n_collocation, D), **kw) - 1.0
        data_x = 2.0 * torch.rand((n_collocation // 4, D), **kw) - 1.0
        return train_step(cfg, field, optimizer, collocation, data_x,
                          u_star(data_x), f_rhs, w_pde=w_pde, w_data=w_data,
                          method=method)

    return step


class TrainState(NamedTuple):
    field: GaussianField
    optimizer: torch.optim.Optimizer
    step: int


def auto_config(cfg: SamplerConfig, field: GaussianField, probe,
                P: int) -> SamplerConfig:
    """Capacities from the host planner on the initial parameters, with
    dgs_tpu's headroom for training drift (one more tile per axis, twice
    the entries plus one per Gaussian) and the wrapped kernels (drift can
    break the compact-support certificate)."""
    from ..utils import native

    with torch.no_grad():
        plan = native.plan_capacities(cfg, field.means, field.covariances(),
                                      probe)
    return drift_headroom(native.config_from_plan(cfg, plan, P))


def drift_headroom(cfg: SamplerConfig) -> SamplerConfig:
    """auto_config's headroom on a planned config, for training steps that
    move the Gaussians (parallel.mesh.plan_sharded_config's plan under the
    model-sharded step)."""
    return dataclasses.replace(
        cfg,
        max_tiles_per_gaussian=cfg.max_tiles_per_gaussian + 1,
        entry_capacity_factor=cfg.entry_capacity_factor * 2.0 + 1.0,
        unwrapped_kernels=False,
    )


def train(cfg: SamplerConfig, *, P: int = 1000, D: int = 2, C: int = 1,
          steps: int = 200, n_collocation: int = 4096,
          learning_rate: float = 3e-3, sigma: float = 0.1,
          method: str = "tiled", seed: int = 0, log_every: int = 50,
          logger=None, auto_capacities: bool = True, device=None):
    """Full training run on ``device`` (default: the card,
    ``torch.device("cuda")``); returns (state, history).

    ``history`` has one entry per chunk of min(log_every, 32) steps (the
    JAX package's scan chunk; the last chunk may be shorter): the chunk's
    last step's ``loss``, ``pde`` and ``data``, each binning diagnostic as
    its maximum over the chunk's steps, ``t_step_s`` (the chunk's
    synchronised wall time per step; the first chunk includes the kernel
    build and the allocator's warm-up) and ``step``.  ``auto_capacities``
    sizes the tiled method's binning from the initial parameters
    (auto_config); the all-pairs methods have no capacities."""
    device = torch.device("cuda" if device is None else device)
    u_star, f_rhs = manufactured_solution(D)
    gen = torch.Generator(device=device).manual_seed(seed)
    field = init_field(gen, P, D, C, sigma=sigma)
    optimizer = torch.optim.Adam(field.parameters(), lr=learning_rate,
                                 eps=1e-8)
    if method == "tiled" and auto_capacities:
        probe = 2.0 * torch.rand((n_collocation, D), generator=gen,
                                 device=device) - 1.0
        cfg = auto_config(cfg, field, probe, P)
    step = make_train_step(cfg, optimizer, f_rhs, u_star, gen,
                           n_collocation=n_collocation, method=method)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    history, i = [], 0
    while i < steps:
        n = min(max(min(log_every, 32), 1), steps - i)
        sync()
        t0 = time.perf_counter()
        worst = None
        for _ in range(n):
            metrics = step(field)
            diag = torch.stack([metrics[k] for k in DIAGNOSTICS])
            worst = diag if worst is None else torch.maximum(worst, diag)
        sync()
        dt = time.perf_counter() - t0
        i += n
        m = {k: float(metrics[k]) for k in ("loss", "pde", "data")}
        m.update(zip(DIAGNOSTICS, (float(x) for x in worst.tolist())))
        m["t_step_s"] = dt / n
        m["step"] = i - 1
        history.append(m)
        if logger is not None:
            logger.log(m)
    return TrainState(field, optimizer, steps), history
