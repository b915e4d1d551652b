"""Sharded execution over a ("data", "model") mesh of ranks.

The counterpart of ``dgs_tpu/parallel/mesh.py`` on ``torch.distributed``:

  * the ``data`` axis shards SAMPLE points: each sample's output is an
    independent sum over Gaussians, so the forward needs no collective and
    the gradients of replicated parameters are all-reduced over ``data``;
  * the ``model`` axis shards GAUSSIANS: the mixture sum is associative, so
    each rank evaluates a partial mixture and the partials are summed over
    ``model`` before any nonlinear loss.

Where dgs_tpu runs one controller over a mesh of devices (``shard_map``
takes global arrays and ``psum`` is a collective inside its body), the port
runs one process per rank.  The mesh is a ``DeviceMesh`` (make_mesh) whose
coordinates are row-major with ``model`` fastest, as jax.make_mesh lays
devices out.  A Gaussian or sample array splits into contiguous, equal row
blocks (shard_rows): block i of n holds rows [i n_rows / n, (i + 1) n_rows
/ n), as shard_map splits, and a row count that does not divide raises.

Two autograd pairs carry the collectives:

  * reduce_partials: forward all-reduce (SUM) of partial outputs over
    ``model``, backward the identity.  Every model rank computes the same
    loss from the summed outputs and so already holds the whole cotangent
    of its partial.  (``torch.distributed.nn.functional.all_reduce`` sums
    the cotangents again in its backward, which would scale the gradients
    by the number of model ranks; dgs_tpu's model-sharded step has that
    fault, because it takes its gradient inside ``shard_map``.)
  * replicated inputs (sharded_aggregate): forward the identity, backward
    all-reduce (SUM) of the gradients over ``model``, the transpose of
    replicating a tensor across ranks that each use it for their own shard.

The optimizer is passed to each training step with the parameters it
updates, where dgs_tpu's steps take optax's state: a ``torch.optim``
optimizer is bound to its parameters, and the model-sharded step's exist
only after shard_field.  The steps take the rank's own points; pigs_points
draws them from a seed as dgs_tpu's steps draw them from a key.

Collectives run on whatever backend the process group has: NCCL on the
card, gloo on the CPU (and for several ranks on one card, whose CUDA
tensors gloo stages through host memory).  This module never picks one.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..config import SamplerConfig
from ..ops import sampling

AXES = ("data", "model")
Axes = Union[str, Sequence[str]]


def initialize_distributed(backend: Optional[str] = None, **kwargs) -> None:
    """Join the process group that ``torchrun`` describes (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``) or that ``kwargs``
    give ``torch.distributed.init_process_group``; a no-op in a single
    process (``WORLD_SIZE`` unset or 1 and no kwargs).

    ``backend`` defaults to "nccl", one card a rank (``LOCAL_RANK``'s, or
    the rank's modulo the cards of the host); name "gloo" for ranks on the
    CPU or for several ranks on one card."""
    if int(os.environ.get("WORLD_SIZE", "1")) == 1 and not kwargs:
        return
    backend = backend or "nccl"
    if backend == "nccl":
        rank = int(os.environ.get("LOCAL_RANK", kwargs.get("rank", 0)))
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, **kwargs)


def make_mesh(shape: Optional[Tuple[int, int]] = None,
              device_type: str = "cuda") -> DeviceMesh:
    """The ("data", "model") mesh over every rank of the process group
    (default shape: (world size, 1)); ``device_type`` "cuda" (the
    default) or "cpu".  Every rank calls it with the same arguments."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "initialize_distributed (under torchrun) or "
                           "torch.distributed.init_process_group first")
    n = dist.get_world_size()
    shape = (n, 1) if shape is None else tuple(shape)
    if len(shape) != 2 or shape[0] * shape[1] != n:
        raise ValueError(f"mesh {shape} does not cover the {n} ranks")
    return init_device_mesh(device_type, shape, mesh_dim_names=AXES)


def _axes(axes: Axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _group(mesh: DeviceMesh, axes: Axes):
    """The process group over ``axes``: one axis's group, or the world's
    for both (make_mesh's meshes cover the world)."""
    axes = _axes(axes)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    if sorted(axes) != sorted(AXES):
        raise ValueError(f"unknown mesh axes {axes}")
    return dist.group.WORLD


def _size(mesh: DeviceMesh, axes: Axes) -> int:
    return int(np.prod([mesh.size(AXES.index(a)) for a in _axes(axes)]))


def _coord(mesh: DeviceMesh, axis: str) -> int:
    return mesh.get_local_rank(axis)


def shard_rows(x: torch.Tensor, n_shards: int, index: int) -> torch.Tensor:
    """Rows [index n / n_shards, (index + 1) n / n_shards) of ``x`` (a
    view); raises unless the n rows split into ``n_shards`` equal blocks."""
    n = x.shape[0]
    if n % n_shards:
        raise ValueError(f"{n} rows do not split into {n_shards} equal "
                         "shards")
    k = n // n_shards
    return x[index * k:(index + 1) * k]


def shard_samples(samples: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """The rank's block of ``samples`` sharded over both axes, data-major
    (dgs_tpu's ``P(("data", "model"))``)."""
    index = _coord(mesh, "data") * _size(mesh, "model") + _coord(mesh, "model")
    return shard_rows(samples, mesh.size(), index)


def replicate(tree, mesh: DeviceMesh):
    """Broadcast the values of ``tree`` (a tensor, an ``nn.Module``'s
    parameters and buffers, or a sequence of tensors such as a
    models.dynamics.DynamicsParams) in place from the mesh's first rank to
    every rank; returns ``tree``."""
    if isinstance(tree, torch.nn.Module):
        tensors = [*tree.parameters(), *tree.buffers()]
    else:
        tensors = [tree] if isinstance(tree, torch.Tensor) else list(tree)
    src = int(mesh.mesh.reshape(-1)[0])
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t.detach(), src=src)
    return tree


class _SumPartials(torch.autograd.Function):
    """(group, *partials) -> their sums over the group's ranks, in one
    all-reduce of a flat buffer; the backward is the identity (see the
    module docstring)."""

    @staticmethod
    def forward(ctx, group, *xs):
        flat = xs[0].new_empty(sum(x.numel() for x in xs))
        outs = [t.view(x.shape) for t, x in
                zip(flat.split([x.numel() for x in xs]), xs)]
        for out, x in zip(outs, xs):
            out.copy_(x)       # one pass a partial, whatever its strides
        dist.all_reduce(flat, group=group)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gs):
        return (None,) + gs


def reduce_partials(outs: Dict[str, torch.Tensor], mesh: DeviceMesh,
                    axes: Axes = "model") -> Dict[str, torch.Tensor]:
    """A dict of partial outputs summed over ``axes``, differentiable with
    the identity as the backward (each rank's cotangent of the sum is
    already the whole one)."""
    keys = list(outs)
    summed = _SumPartials.apply(_group(mesh, axes), *(outs[k] for k in keys))
    return dict(zip(keys, summed))


class _Replicated(torch.autograd.Function):
    """(group, *tensors) -> the same tensors; the backward all-reduces
    (SUM) their gradients over the group's ranks in one flat buffer: the
    transpose of replication, for tensors that each rank uses only for its
    own shard of a sum."""

    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        ctx.shapes = [(x.shape, x.dtype, x.device) for x in xs]
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        gs = [torch.zeros(s, dtype=t, device=d) if g is None else g
              for g, (s, t, d) in zip(gs, ctx.shapes)]
        flat = torch.cat([g.reshape(-1) for g in gs])
        dist.all_reduce(flat, group=ctx.group)
        return (None,) + tuple(t.view_as(g) for t, g in
                               zip(flat.split([g.numel() for g in gs]), gs))


def _flat_grads(params) -> torch.Tensor:
    """The parameters' gradients in one flat buffer (zeros for None); the
    parameters' ``grad`` is cleared."""
    flat = torch.cat([(torch.zeros_like(p) if p.grad is None else p.grad)
                      .reshape(-1) for p in params])
    for p in params:
        p.grad = None
    return flat


def _set_grads(params, flat: torch.Tensor) -> None:
    for p, g in zip(params, flat.split([p.numel() for p in params])):
        p.grad = g.view_as(p)


def all_reduce_gradients(params, mesh: DeviceMesh,
                         axes: Axes = AXES) -> None:
    """Replace the gradients of ``params`` by their mean over the ranks of
    ``axes``, in one all-reduce of a flat buffer (the gradient of the mean
    of equal-sized shard losses)."""
    params = list(params)
    flat = _flat_grads(params)
    dist.all_reduce(flat, group=_group(mesh, axes))
    _set_grads(params, flat / _size(mesh, axes))


def sharded_sample_all(cfg: SamplerConfig, mesh: DeviceMesh,
                       means, values, conics, covariances, samples,
                       orders=sampling.ALL_ORDERS, method: str = "tiled"):
    """Fused multi-order evaluation sharded over (data = samples, model =
    Gaussians).

    Every rank passes the global arrays.  The rank evaluates its model
    block of the Gaussians at its data block of the samples ("tiled":
    ops.sampling.sample_binned, with ``cfg``'s capacities; any other
    method ops.sampling.sample_all), and the partial outputs are summed
    over ``model``.  Returns (outputs, diagnostics): the rank's data block
    of each output in sample order (gather_samples assembles them),
    differentiable in the rank's rows of means, values and conics, and the
    rank's binning diagnostics as sample_binned gives them (zeros for the
    all-pairs methods).  Tiled overflow is per rank: every rank's must be
    0.  A capacity planned for the whole cloud covers a shard's footprints
    but not always its share of the entries; plan_sharded_config plans
    one that covers every shard."""
    orders = tuple(orders)
    n_model, m = _size(mesh, "model"), _coord(mesh, "model")
    means, values, conics, covariances = (
        shard_rows(x, n_model, m)
        for x in (means, values, conics, covariances))
    samples = shard_rows(samples, _size(mesh, "data"), _coord(mesh, "data"))
    if method == "tiled":
        outs, diag = sampling.sample_binned(cfg, means, values, conics,
                                            covariances, samples, orders)
    else:
        outs = sampling.sample_all(means, values, conics, samples,
                                   period=cfg.period, orders=orders,
                                   method=method)
        zero = torch.zeros((), dtype=torch.int32, device=samples.device)
        diag = {"perm": None, "bin_overflow": zero, "entry_overflow": zero,
                "work_overflow_fwd": zero, "work_overflow_bwd": zero}
    return reduce_partials(outs, mesh), diag


def gather_samples(outs: Dict[str, torch.Tensor],
                   mesh: DeviceMesh) -> Dict[str, torch.Tensor]:
    """Every rank's data block of each output, concatenated in sample
    order (an all-gather over ``data``; not differentiable)."""
    group, n = _group(mesh, "data"), _size(mesh, "data")
    whole = {}
    for k, o in outs.items():
        o = o.detach().contiguous()
        parts = [torch.empty_like(o) for _ in range(n)]
        dist.all_gather(parts, o, group=group)
        whole[k] = torch.cat(parts)
    return whole


def plan_sharded_config(cfg: SamplerConfig, mesh: DeviceMesh, means,
                        covariances, samples) -> SamplerConfig:
    """The tiled capacities that every rank of the mesh can run: each rank
    plans its model block of the Gaussians (utils.native.plan_capacities
    against ``samples``, the points it evaluates or a probe of them), and
    the plans' maxima (tiles a Gaussian spans, entries, the unwrapped
    kernels' certificate) are taken over every rank, so all run one config
    and its entry capacity, a factor of the shard's Gaussian count, covers
    the fullest shard.  ``means`` and ``covariances`` are the global
    arrays, as sharded_sample_all takes them."""
    from ..utils import native

    n_model, m = _size(mesh, "model"), _coord(mesh, "model")
    with torch.no_grad():
        plan = native.plan_capacities(cfg, shard_rows(means, n_model, m),
                                      shard_rows(covariances, n_model, m),
                                      samples)
    maxima = torch.tensor([plan["max_extent"], plan["entries"],
                           0 if plan["safe_unwrapped"] else 1],
                          dtype=torch.int64, device=mesh.device_type)
    dist.all_reduce(maxima, op=dist.ReduceOp.MAX, group=_group(mesh, AXES))
    extent, entries, unsafe = maxima.tolist()
    return native.config_from_plan(
        cfg, {"max_extent": extent, "entries": entries,
              "safe_unwrapped": not unsafe}, means.shape[0] // n_model)


def _generator(seed: int, index: int, device) -> torch.Generator:
    """A generator on ``device`` for shard ``index`` of step ``seed``."""
    mixed = np.random.SeedSequence([seed, index]).generate_state(1)[0]
    return torch.Generator(device=device).manual_seed(int(mixed))


def pigs_points(mesh: DeviceMesh, seed: int, n_collocation: int, D: int, *,
                model_sharded: bool = False):
    """The rank's (collocation, data_x) for one sharded PIGS step, uniform
    on [-1, 1)^D, with dgs_tpu's counts: n_collocation / (ranks of the
    mesh) collocation points and a quarter as many data points (at least
    one).  Each rank draws its own, from a generator seeded by ``seed`` and
    its coordinates; with ``model_sharded`` the model ranks of one data row
    draw the same points (they evaluate partial mixtures at them)."""
    n_shards = mesh.size()
    if n_collocation % n_shards:
        raise ValueError(f"n_collocation {n_collocation} does not split "
                         f"over {n_shards} ranks")
    n_local = n_collocation // n_shards
    d = _coord(mesh, "data")
    index = d if model_sharded else d * _size(mesh, "model") + _coord(
        mesh, "model")
    gen = _generator(seed, index, mesh.device_type)
    kw = dict(generator=gen, device=mesh.device_type)
    collocation = 2.0 * torch.rand((n_local, D), **kw) - 1.0
    data_x = 2.0 * torch.rand((max(n_local // 4, 1), D), **kw) - 1.0
    return collocation, data_x


def _step_metrics(chunk_metrics, group, n: int) -> Dict[str, torch.Tensor]:
    """One all-reduce of the step's metrics: the loss terms' mean over the
    ``n`` chunk losses of all ranks, each diagnostic's total."""
    from ..models import pigs

    terms = ("loss", "pde", "data")
    vec = torch.stack([
        torch.stack([m[k].float() for k in terms + pigs.DIAGNOSTICS])
        for m in chunk_metrics]).sum(dim=0)
    dist.all_reduce(vec, group=group)
    out = {k: vec[i] / n for i, k in enumerate(terms)}
    out.update({k: vec[len(terms) + i].to(torch.int32)
                for i, k in enumerate(pigs.DIAGNOSTICS)})
    return out


def make_sharded_pigs_step(cfg: SamplerConfig, mesh: DeviceMesh, f_rhs,
                           u_star, *, method: str = "tiled",
                           w_pde: float = 1.0, w_data: float = 1.0,
                           grad_chunks: int = 1):
    """Data-parallel PIGS step: parameters and optimizer state replicated
    (every rank holds the whole field, replicate() makes it equal), points
    sharded over the whole mesh.

    Returns step(field, optimizer, collocation, data_x) -> metrics, on the
    rank's own points (pigs_points).  The loss is the mean of the ranks'
    equal-sized losses, so the gradient, all-reduced (mean) over every rank
    before ``optimizer.step()``, equals the unsharded step's on the union of
    the points; means are wrapped afterwards.  ``grad_chunks > 1`` splits
    the rank's collocation points into that many equal chunks, each taken
    with all of ``data_x``: each chunk's gradient all-reduce is issued
    (asynchronously) right after its backward, so it can overlap the next
    chunk's work, and all are awaited before the optimizer.  Metrics (0-d
    tensors, the same on every rank): ``loss``, ``pde``, ``data`` averaged
    over chunks and ranks, each binning diagnostic summed over them."""
    from ..models import pigs

    group = _group(mesh, AXES)
    n_shards = mesh.size()

    def step(field, optimizer, collocation, data_x):
        if collocation.shape[0] % grad_chunks:
            raise ValueError(f"{collocation.shape[0]} collocation points do "
                             f"not split into {grad_chunks} chunks")
        params = list(field.parameters())
        data_u = u_star(data_x)
        optimizer.zero_grad(set_to_none=True)
        pending, chunk_metrics = [], []
        for chunk in collocation.chunk(grad_chunks):
            loss, metrics = pigs.pigs_loss(
                cfg, field, chunk, data_x, data_u, f_rhs, w_pde=w_pde,
                w_data=w_data, method=method)
            loss.backward()
            flat = _flat_grads(params)
            pending.append((flat, dist.all_reduce(flat, group=group,
                                                  async_op=True)))
            chunk_metrics.append(metrics)
        for _, work in pending:
            work.wait()
        _set_grads(params, sum(flat for flat, _ in pending)
                   / (n_shards * grad_chunks))
        optimizer.step()
        with torch.no_grad():
            field.means.copy_(pigs.wrap_means(field.means, cfg.period))
        return _step_metrics(chunk_metrics, group, n_shards * grad_chunks)

    return step


def make_model_sharded_pigs_step(cfg: SamplerConfig, mesh: DeviceMesh,
                                 f_rhs, u_star, *, method: str = "tiled",
                                 w_pde: float = 1.0, w_data: float = 1.0):
    """PIGS step with the Gaussians (and so the optimizer state) sharded
    over ``model``: the memory-scaling form for very large P (config 5: 1M
    Gaussians).

    Returns (step, shard_field).  ``shard_field(field)`` is the rank's
    model block of a field's rows as a new GaussianField; build the
    optimizer over it.  ``step(shard, optimizer, collocation, data_x) ->
    metrics`` takes the rank's points, the same on every model rank of a
    data row (pigs_points(model_sharded=True)).  Each model rank evaluates
    its partial mixture at them, the partials are summed over ``model``
    before the nonlinear loss (pigs_loss's ``outs_reduce``, whose backward
    is the identity), so each rank's gradient is that of the unsharded loss
    with respect to its own rows; gradients are averaged over ``data``
    only, the optimizer steps shard-local and the rank's means are wrapped.
    The gradient equals the unsharded one (dgs_tpu's step returns it times
    the number of model ranks: see the module docstring).  Each rank bins
    only its shard, so the tiled method's ``cfg`` must cover every shard
    (plan_sharded_config, with pigs.drift_headroom for training).  Metrics
    as make_sharded_pigs_step's, over the data rows."""
    from ..models import pigs
    from ..models.field import GaussianField

    n_model, m = _size(mesh, "model"), _coord(mesh, "model")
    n_data = _size(mesh, "data")

    def shard_field(field) -> GaussianField:
        with torch.no_grad():
            return GaussianField(*(shard_rows(p, n_model, m).clone()
                                   for p in (field.means, field.log_scales,
                                             field.rotations, field.values)))

    def outs_reduce(outs):
        return reduce_partials(outs, mesh, "model")

    def step(shard, optimizer, collocation, data_x):
        optimizer.zero_grad(set_to_none=True)
        loss, metrics = pigs.pigs_loss(
            cfg, shard, collocation, data_x, u_star(data_x), f_rhs,
            w_pde=w_pde, w_data=w_data, method=method,
            outs_reduce=outs_reduce)
        loss.backward()
        all_reduce_gradients(shard.parameters(), mesh, "data")
        optimizer.step()
        with torch.no_grad():
            shard.means.copy_(pigs.wrap_means(shard.means, cfg.period))
        # Every model rank of a data row holds the same loss terms; the
        # diagnostics are the rank's own, so their total is over all ranks.
        return _step_metrics([metrics], dist.group.WORLD, n_model * n_data)

    return step, shard_field


def build_sharded_aggregation(cfg: SamplerConfig, means, conics, radii,
                              n_shards: int, shard: int, *,
                              block_n: int = 32, block_e: int = 128):
    """Model-parallel aggregation structures: the tile grid split into
    ``n_shards`` contiguous ranges balanced by entry chunks
    (ops.aggregation.plan_pallas_sharded), one
    ``preprocess_pallas(tile_range=...)`` structure a range.  Same-tile
    pairing makes every shard's pair sweep shard-local, so the only
    collectives of sharded_aggregate are the output sum and the replicated
    parameters' gradient sums.

    Returns (cfg', plan, structure), the structure of range ``shard`` (the
    rank's ``model`` coordinate) only: all that a model rank builds and
    holds."""
    from ..ops import aggregation

    cfg2, plan, ranges = aggregation.plan_pallas_sharded(
        cfg, means, radii, n_shards, block_n=block_n, block_e=block_e)
    return cfg2, plan, aggregation.preprocess_pallas(
        cfg2, means, conics, radii, plan, block_n, block_e,
        tile_range=ranges[shard])


class _PlaceSlots(torch.autograd.Function):
    """(rows (Cp, L) in slot order, cid (Cp,), P) -> (P, L) with row cid[c]
    = rows[c] and zeros for centres of other shards.  Each centre sits in
    one slot (sentinel slots, cid == P, hold zero rows and land past the
    end), so the forward is an index copy and the backward a gather: no
    accumulation, the same bits on every run."""

    @staticmethod
    def forward(ctx, rows, cid, n):
        cid = cid.long()
        ctx.save_for_backward(cid)
        out = rows.new_zeros((n + 1, rows.shape[1]))
        out.index_copy_(0, cid, rows)
        return out[:n]

    @staticmethod
    def backward(ctx, g):
        (cid,) = ctx.saved_tensors
        g = torch.cat([g, g.new_zeros((1, g.shape[1]))])
        return g[cid], None, None


def sharded_aggregate(mesh: DeviceMesh, features, transform, queries, keys,
                      frequencies, distance_transform, agg, *,
                      ladder_frequencies: bool = False, block_n: int = 32,
                      block_e: int = 128):
    """Attention aggregation over the Gaussian cloud, sharded over
    ``model`` by tile range: ``agg`` is the rank's structure
    (build_sharded_aggregation(shard=model coordinate)).  The six parameter
    groups are replicated: each rank aggregates over its shard's centres
    (aggregate_pallas with padded outputs), places its slot rows into
    (P, L) and the shards' outputs are summed over ``model``.
    Differentiable in all six groups: their gradients are summed over
    ``model`` in the backward (each rank's holds its entries', centres' and
    pairs' share)."""
    from ..ops import aggregation

    group = _group(mesh, "model")
    args = _Replicated.apply(group, features, transform, queries, keys,
                             frequencies, distance_transform)
    out_pad = aggregation.aggregate_pallas(
        *args, agg, period=None, block_n=block_n, block_e=block_e,
        ladder_frequencies=ladder_frequencies, padded_outputs=True)
    out = _PlaceSlots.apply(out_pad, agg.cid, features.shape[0])
    (out,) = _SumPartials.apply(group, out)
    return out


def make_sharded_dynamics_step(mesh: DeviceMesh, agg, values0,
                               target_values, *, rollout: int = 2,
                               ladder_frequencies: bool = False,
                               block_n: int = 32, block_e: int = 128):
    """Model-sharded dynamics training step: ``rollout`` residual updates
    v <- v + sharded_aggregate(v, ...) from ``values0``, the L2 loss
    against ``target_values``, then the optimizer.  Returns step(params,
    optimizer) -> loss (0-d, detached), with ``params`` a
    models.dynamics.DynamicsParams replicated on every rank and the
    optimizer over it.  With ``ladder_frequencies`` params.frequencies is
    the ladder's (1,) base and the rungs base * (1..nfreq) are built here,
    as models.dynamics.rollout_step does.  The aggregation subsystem's
    counterpart of make_sharded_pigs_step."""
    from ..models.dynamics import step_frequencies

    D = agg.ctr_static.shape[1] - 3

    def step(params, optimizer):
        optimizer.zero_grad(set_to_none=True)
        freqs = step_frequencies(params, D, ladder_frequencies)
        v = values0
        for _ in range(rollout):
            v = v + sharded_aggregate(
                mesh, v, params.transform, params.queries, params.keys,
                freqs, params.distance_transform, agg,
                ladder_frequencies=ladder_frequencies, block_n=block_n,
                block_e=block_e)
        loss = torch.mean((v - target_values) ** 2)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step
