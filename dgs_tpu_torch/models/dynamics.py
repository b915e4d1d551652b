"""Gaussian-cloud dynamics via neighbour aggregation (the PIGS dynamics net).

The counterpart of ``dgs_tpu/models/dynamics.py``: a field u(x, t) is carried
by a fixed Gaussian cloud whose per-Gaussian feature values evolve through
the attention-style neighbour aggregation layer, trained so rollouts match an
analytic advection-diffusion solution on the periodic torus:

    u_t + c . grad(u) = kappa * laplace(u)
    u*(x, t) = exp(-D kappa pi^2 t) * prod_d sin(pi (x_d - c_d t))

Per rollout step:  values <- values + aggregate(values, ...)  (a residual
update through the reference's learnable parameter groups: transform,
queries, keys, frequencies, distance_transform).

``torch.optim.Adam`` stands in for ``optax.adam`` (the same update with
eps=1e-8), a ``torch.Generator`` draws the evaluation points, and the
training loop is a Python loop where the JAX package scans.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..binning import grid as binning
from ..config import SamplerConfig
from ..ops import aggregation, sampling
from ..oracle.dense import radii as compute_radii
from .field import GaussianField, init_field


class DynamicsParams(NamedTuple):
    """The learnable parameter groups of the aggregation layer (the
    features are the evolving values)."""

    transform: torch.Tensor           # (L, L)
    queries: torch.Tensor             # (P, K)
    keys: torch.Tensor                # (P, K)
    frequencies: torch.Tensor         # (nfreq,), or (1,) with a ladder
    distance_transform: torch.Tensor  # (2E,)

    @classmethod
    def from_numpy(cls, transform, queries, keys, frequencies,
                   distance_transform, *, device=None) -> "DynamicsParams":
        """Trainable parameters from the five arrays of a ``dgs_tpu``
        DynamicsParams (or any numpy arrays of those shapes), as float32
        leaves on ``device`` (default: the card, ``torch.device("cuda")``)."""
        device = torch.device("cuda" if device is None else device)
        return cls(*(torch.tensor(np.asarray(a, np.float32), device=device,
                                  requires_grad=True)
                     for a in (transform, queries, keys, frequencies,
                               distance_transform)))


def init_dynamics_params(generator: torch.Generator, P: int, L: int, D: int,
                         *, n_heads: int = 4, n_freq: int = 2,
                         ladder: bool = False) -> DynamicsParams:
    """Random trainable parameters on ``generator.device``: the same
    distributions as dgs_tpu's init_dynamics_params, not the same numbers.

    ``ladder``: parameterise the frequency ladder by its learnable BASE
    scalar (frequencies = base * (1..n_freq), built in rollout_step) so the
    kernels can use the angle-addition recurrence; otherwise each rung is
    independently learnable as in the reference."""
    E = 2 * D * n_freq + 1
    dev = generator.device
    scale = 0.1

    def normal(*shape):
        return torch.randn(shape, generator=generator, device=dev)

    transform = normal(L, L) * scale / L ** 0.5
    queries = normal(P, n_heads) * scale
    keys = normal(P, n_heads) * scale
    frequencies = (torch.ones((1,), device=dev) if ladder else
                   torch.arange(1, n_freq + 1, dtype=torch.float32,
                                device=dev))
    distance_transform = normal(2 * E) * scale
    return DynamicsParams(*(t.requires_grad_() for t in (
        transform, queries, keys, frequencies, distance_transform)))


def advection_diffusion_solution(D: int, kappa: float = 0.05,
                                 velocity: float = 0.3):
    """u*(x, t) on the period-2 torus."""

    def u_star(x, t):  # (N, D), scalar t -> (N, 1)
        decay = math.exp(-D * kappa * math.pi ** 2 * t)
        return (decay * torch.prod(torch.sin(math.pi * (x - velocity * t)),
                                   dim=-1))[:, None]

    return u_star


def step_frequencies(params: DynamicsParams, D: int, ladder: bool):
    """The frequencies an aggregation call takes: params.frequencies, or
    with ``ladder`` the rungs base * (1..nfreq) of its (1,) learnable base
    (nfreq from the distance transform's length at dimension D)."""
    if not ladder:
        return params.frequencies
    nfreq = (params.distance_transform.shape[0] // 2 - 1) // D // 2
    return params.frequencies[0] * torch.arange(
        1, nfreq + 1, dtype=torch.float32, device=params.frequencies.device)


def rollout_step(params: DynamicsParams, values, nbr, *,
                 ladder: bool = False):
    """values <- values + aggregate(values)  (the residual dynamics update).
    Dispatches on the neighbour structure: the table path
    (aggregation.Neighbors) or the kernel path (aggregation.AggBinning).

    ``ladder``: params.frequencies is a (1,) learnable BASE and the full
    ladder base * (1..nfreq) is built here, so autograd chains the per-rung
    gradients onto the base and the kernels can replace most per-pair
    sin/cos with the angle-addition recurrence."""
    is_binning = isinstance(nbr, aggregation.AggBinning)
    D = nbr.ctr_static.shape[1] - 3 if is_binning else nbr.dists.shape[-1]
    args = (values, params.transform, params.queries, params.keys,
            step_frequencies(params, D, ladder), params.distance_transform,
            nbr)
    if is_binning:
        return values + aggregation.aggregate_pallas(
            *args, ladder_frequencies=ladder)
    return values + aggregation.aggregate(*args)


def make_value_eval(cfg: SamplerConfig, field: GaussianField,
                    eval_method: str = "dense", n_eval: int = 4096,
                    with_overflow: bool = False, padded: bool = False):
    """(values, x) -> u(x) evaluator for a fixed cloud geometry, for batches
    of ``n_eval`` points.

    "dense" evaluates all (N, P) pairs in plain torch, fine for small P;
    "tiled" routes through the binned sampler with capacities planned from
    the geometry and an ``n_eval``-sized probe (the only viable path at
    100k+ Gaussians).  Sample points may differ per call; a fresh random
    batch is probed once and must show zero overflow.  ``with_overflow``:
    the evaluator returns (u, overflow_total) so training loops can log
    capacity drift (always 0 on the dense path).  ``padded``: the kernel's
    raw lane-major (1, C, Np) layout plus the sort permutation."""
    with torch.no_grad():
        means, conics = field.means.detach(), field.conics()
    dev = means.device
    if eval_method == "dense":
        def eval_u(values, x):
            u = sampling.sample_dense("value", means, values, conics, x,
                                      period=cfg.period)
            if with_overflow:
                return u, torch.zeros((), dtype=torch.int32, device=dev)
            return u
        return eval_u

    from ..utils import native

    with torch.no_grad():
        covs = field.covariances()
    # The eval grid's tile shrinks to the cloud's footprints (as
    # plan_pallas's auto_tile does): about 2.7x the median footprint
    # radius; only ever shrink the configured tile.
    rad_med = float(torch.quantile(
        compute_radii(covs, field.D, cfg.radius_sigma, cfg.eig_floor), 0.5))
    extent = (cfg.period if cfg.period is not None
              else min(u - l for l, u in zip(cfg.lower, cfg.upper)))
    tile_auto = max(2.7 * rad_med, extent / 512.0)
    if 0.0 < tile_auto < cfg.tile_size:
        cfg = dataclasses.replace(cfg, tile_size=tile_auto)
    gen = torch.Generator(device=dev).manual_seed(17)
    probe = 2.0 * torch.rand((n_eval, field.D), generator=gen,
                             device=dev) - 1.0
    plan = native.plan_capacities(cfg, means, covs, probe)
    cfg_s = native.config_from_plan(cfg, plan, means.shape[0])

    # The cloud geometry is fixed in dynamics training (only the values
    # evolve): the Gaussian-side binning is built once here and reused in
    # every step, which then only sorts the fresh sample batch.
    gstate = binning.build(cfg_s, means, covs, probe)

    def eval_u(values, x):
        outs, diag = sampling.sample_binned(
            cfg_s, means, values, conics, covs, x, ("value",),
            gaussian_binning=gstate, sorted_outputs=padded,
            padded_outputs=padded)
        u = outs["value"]
        ret = (u, diag["perm"]) if padded else (u,)
        if with_overflow:
            of = sum(v for k, v in diag.items() if k != "perm")
            ret = ret + (of.to(torch.int32),)
        return ret if len(ret) > 1 else ret[0]

    # One probe on a fresh batch: the capacities must hold for resampled
    # points, not just the planning probe.
    check = 2.0 * torch.rand((n_eval, field.D), generator=gen,
                             device=dev) - 1.0
    with torch.no_grad():
        _, diag = sampling.sample_binned(
            cfg_s, means, field.values.detach(), conics, covs, check,
            ("value",))
    bad = {k: int(v) for k, v in diag.items()
           if k != "perm" and int(v) != 0}
    if bad:
        raise ValueError(f"tiled value eval overflows on a fresh batch: "
                         f"{bad}; enlarge the capacities")
    return eval_u


def fit_values(cfg: SamplerConfig, field: GaussianField, target: Callable,
               *, steps: int = 200, lr: float = 5e-2, n_fit: int = 4096,
               generator: torch.Generator = None,
               eval_method: str = "dense") -> GaussianField:
    """Least-squares fit of the per-Gaussian values to a target field at
    t = 0, in place (means and covariances stay fixed); returns ``field``.
    ``generator`` (default: seed 3 on the field's device) draws the fit
    points."""
    dev = field.means.device
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(3)
    x = 2.0 * torch.rand((n_fit, field.D), generator=generator,
                         device=dev) - 1.0
    y = target(x)
    eval_u = make_value_eval(cfg, field, eval_method, n_eval=n_fit)
    opt = torch.optim.Adam([field.values], lr=lr, eps=1e-8)
    for _ in range(steps):
        opt.zero_grad(set_to_none=True)
        loss = torch.mean((eval_u(field.values, x) - y) ** 2)
        loss.backward()
        opt.step()
    return field


def rollout_loss(params: DynamicsParams, values, nbr, eval_u, x, u_star, *,
                 rollout: int, dt: float, ladder: bool = False,
                 padded: bool = False):
    """(loss, eval overflow): the mean over rollout depths r and points of
    (u_model(x, r dt) - u*(x, r dt))^2.  ``eval_u`` comes from
    make_value_eval(with_overflow=True, padded=padded).

    The rollout's field evaluations are batched into one sampler call: the
    per-depth value vectors ride as channels (P, rollout * C), so the
    binning and the pair sweep run once per step; the field is linear in the
    values, so stacking channels is exact.  With ``padded`` the loss is
    taken on the kernel's raw lane-major layout against targets evaluated at
    the sorted points (pad columns are zero and excluded)."""
    stacked = []
    for _ in range(rollout):
        values = rollout_step(params, values, nbr, ladder=ladder)
        stacked.append(values)
    V = torch.cat(stacked, dim=1)                       # (P, rollout * C)
    n_eval = x.shape[0]
    if padded:
        u_pad, perm, overflow = eval_u(V, x)            # (1, R, Np), (N,)
        xs = x[perm.long()]
        tgt_t = torch.cat([u_star(xs, (r + 1.0) * dt).reshape(1, -1)
                           for r in range(rollout)], dim=0)     # (R, N)
        diff = u_pad[0][:, :n_eval] - tgt_t
        return torch.mean(diff * diff), overflow
    tgt = torch.cat([u_star(x, (r + 1.0) * dt) for r in range(rollout)],
                    dim=1)
    u, overflow = eval_u(V, x)                          # (n_eval, rollout)
    return torch.mean((u - tgt) ** 2), overflow


def make_train_step(params: DynamicsParams, optimizer, values, nbr, eval_u,
                    u_star, generator: torch.Generator, *, n_eval: int,
                    rollout: int, dt: float, ladder: bool = False,
                    padded: bool = False):
    """A step function step() -> (loss, eval overflow) (0-d tensors, not
    synchronised) that draws ``n_eval`` fresh points uniform on [-1, 1)^D
    from ``generator``, takes rollout_loss, backpropagates to ``params``
    and applies ``optimizer``."""
    D = nbr.ctr_static.shape[1] - 3 if isinstance(
        nbr, aggregation.AggBinning) else nbr.dists.shape[-1]

    def step():
        x = 2.0 * torch.rand((n_eval, D), generator=generator,
                             device=generator.device) - 1.0
        optimizer.zero_grad(set_to_none=True)
        loss, overflow = rollout_loss(
            params, values, nbr, eval_u, x, u_star, rollout=rollout, dt=dt,
            ladder=ladder, padded=padded)
        loss.backward()
        optimizer.step()
        return loss.detach(), overflow

    return step


def train(cfg: SamplerConfig, *, P: int = 512, D: int = 2, steps: int = 150,
          rollout: int = 3, dt: float = 0.05, sigma: float = 0.12,
          learning_rate: float = 3e-3, n_eval: int = 2048, seed: int = 0,
          neighbor_capacity: int = 64, kappa: float = 0.05,
          log_every: int = 50, logger=None, method: str = "grid",
          eval_method: str = "dense", ladder_frequencies: bool = False,
          scan_chunk: int = 0, device=None):
    """Train the dynamics net to roll the field forward in time, on
    ``device`` (default: the card, ``torch.device("cuda")``).

    Returns (params, history).  Per training step, one fresh batch of
    sample points x and loss = mean over rollout depths r of
    mean((u_model(x, r*dt) - u*(x, r*dt))^2) (rollout_loss).

    ``method``: "grid" (the neighbour-table path in plain torch) or
    "pallas" (the aggregation kernels: the production path at large P).
    ``eval_method``: "dense" or "tiled" (required at large P, see
    make_value_eval).  ``ladder_frequencies``: shared-base frequency ladder
    and the kernels' angle-addition recurrence (see rollout_step).
    ``scan_chunk`` > 0 is the number of steps per history record (the JAX
    package scans that many steps per device program); 0 picks
    min(log_every, 32).  Each record holds the chunk's last ``step`` and
    ``loss``, ``t_step_s`` (the chunk's synchronised wall time per step;
    the first chunk includes the kernel build and the allocator's warm-up),
    ``eval_overflow`` (the last step's) and ``nbr_overflow``."""
    device = torch.device("cuda" if device is None else device)
    u_star = advection_diffusion_solution(D, kappa=kappa)
    gen = torch.Generator(device=device).manual_seed(seed)

    field = init_field(gen, P, D, 1, sigma=sigma)
    field = fit_values(cfg, field, lambda x: u_star(x, 0.0),
                       eval_method=eval_method)
    with torch.no_grad():
        means, conics = field.means.detach(), field.conics()
        rad = compute_radii(field.covariances(), D, cfg.radius_sigma,
                            cfg.eig_floor)
    if method == "pallas":
        cfg_a, aplan = aggregation.plan_pallas(cfg.with_dims(D), means, rad)
        nbr = aggregation.preprocess_pallas(cfg_a, means, conics, rad, aplan)
    else:
        nbr = aggregation.preprocess_grid(cfg.with_dims(D), means, conics,
                                          rad, neighbor_capacity)
    params = init_dynamics_params(gen, P, 1, D, ladder=ladder_frequencies)
    opt = torch.optim.Adam(list(params), lr=learning_rate, eps=1e-8)
    padded = eval_method == "tiled"
    eval_u = make_value_eval(cfg, field, eval_method, n_eval=n_eval,
                             with_overflow=True, padded=padded)
    step = make_train_step(
        params, opt, field.values.detach(), nbr, eval_u, u_star, gen,
        n_eval=n_eval, rollout=rollout, dt=dt, ladder=ladder_frequencies,
        padded=padded)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    chunk = scan_chunk if scan_chunk > 0 else max(min(log_every, 32), 1)
    history, i = [], 0
    nbr_of = int(nbr.overflow)
    while i < steps:
        n = min(chunk, steps - i)
        sync()
        t0 = time.perf_counter()
        for _ in range(n):
            loss, overflow = step()
        sync()
        rec = {"step": i + n - 1, "loss": float(loss),
               "t_step_s": (time.perf_counter() - t0) / n,
               "eval_overflow": int(overflow), "nbr_overflow": nbr_of}
        i += n
        history.append(rec)
        if logger is not None:
            logger.log(rec)
    return params, history
