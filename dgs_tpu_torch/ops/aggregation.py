"""Neighbour aggregation: attention-style message passing over the Gaussian
cloud (the PIGS dynamics network).

The counterpart of ``dgs_tpu/ops/aggregation.py``.  Two paths share one
contract:

  * the table path: ``preprocess`` (the reference-shaped O(P^2) scan) or
    ``preprocess_grid`` (world-grid cell lists) build a capacity-padded
    ``Neighbors`` table, and ``aggregate`` evaluates over it in plain torch
    with gradients by autograd.  It is the oracle of the kernel path.
  * the kernel path: ``plan_pallas`` / ``preprocess_pallas`` build the
    tile-sorted ``AggBinning`` structure and ``aggregate_pallas`` evaluates
    through the kernels of ``kernels/aggregate.py``, with a hand-wired
    backward.  Nothing per-pair is kept in device memory.  The names are
    the JAX package's, kept so that callers carry over letter for letter;
    in this package they select the hand-written CUDA kernels (their plain
    torch versions for CPU tensors).

Semantics (those of aggregate_neighbors.cu, as dgs_tpu keeps them):
bounding radii shrunk by 0.2 for the collision test, self-pairs included;
true minimum-image distances on the torus; neighbour offsets normalised by
1 / (0.333 radius + 1e-6); densities from the NEIGHBOUR's conic on the
unnormalised offset, pairs with a positive quadratic form dropped;
inv_total_density = 1 / (sum + 1e-6); the sinusoidal code's layout
dt[d (E-1)/D + 2e + {0, 1}] for the embedding, dt[E + ...] for the factor,
biases at dt[E-1] and dt[2E-1].
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from ..binning import grid as binning
from ..config import SamplerConfig, tri_size
from . import formulas
from .sampling import segment_sum_rows


def _tensor(a, dtype, device):
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


class Neighbors(NamedTuple):
    """Capacity-padded neighbour table (the reference's CSR arrays with
    padding instead of ragged ranges).  The grid variant also carries the
    tile-sorted entry list (ent_gid), the per-tile entry range starts
    (ent_start) and each centre's tile (tile_of_center): slot j of centre i
    is entry ``ent_start[tile_of_center[i]] + j``."""

    indices: torch.Tensor             # (P, NC) int32, -1 = invalid slot
    dists: torch.Tensor               # (P, NC, D) normalised wrapped offsets
    densities: torch.Tensor           # (P, NC)
    inv_total_densities: torch.Tensor  # (P,)
    overflow: torch.Tensor            # () int32: collisions beyond capacity
    ent_gid: Optional[torch.Tensor] = None         # (E,) int32, P = sentinel
    ent_start: Optional[torch.Tensor] = None       # (T+2,) int32
    tile_of_center: Optional[torch.Tensor] = None  # (P,) int32

    @classmethod
    def from_numpy(cls, indices, dists, densities, inv_total_densities,
                   overflow, ent_gid=None, ent_start=None,
                   tile_of_center=None, *, device=None) -> "Neighbors":
        """A table from the arrays of a ``dgs_tpu`` Neighbors (or any numpy
        arrays of those shapes) on ``device`` (default: the card,
        ``torch.device("cuda")``)."""
        device = torch.device("cuda" if device is None else device)
        i32 = [None if a is None else _tensor(a, torch.int32, device)
               for a in (ent_gid, ent_start, tile_of_center)]
        return cls(_tensor(indices, torch.int32, device),
                   _tensor(dists, torch.float32, device),
                   _tensor(densities, torch.float32, device),
                   _tensor(inv_total_densities, torch.float32, device),
                   _tensor(overflow, torch.int32, device), *i32)


def _collision_geometry(radii):
    """Shrunk per-Gaussian collision radii and the entry inflation rho
    (collide iff dist <= 0.2 (r_i + r_j), so an entry must reach every
    centre within r_eff_j + max_i r_eff_i)."""
    r = radii * 0.2
    alive = r >= 1e-6
    r_eff = torch.where(alive, r, 0.0)
    rho = torch.where(alive, r_eff + torch.max(r_eff), 0.0)
    return r_eff, rho


# Centres the brute-force scans take at a time (each against all P).
_SCAN_ROWS = 1024


def _collision_counts(cfg, means, radii):
    P, D = means.shape
    rows = _SCAN_ROWS
    r = radii * 0.2
    alive = r >= 1e-6
    counts = []
    for i0 in range(0, P, rows):
        dx = formulas.wrap(means[None, :, :] - means[i0:i0 + rows, None, :],
                           cfg.period)
        dist2 = torch.sum(dx ** 2, dim=-1)
        rad = r[i0:i0 + rows, None] + r[None, :]
        hit = alive[i0:i0 + rows, None] & alive[None, :] & (dist2 <= rad * rad)
        counts.append(hit.sum(dim=1))
    return torch.cat(counts)


def suggest_capacity(cfg: SamplerConfig, means, radii) -> int:
    """Max collision count of any Gaussian (for choosing the table's
    capacity)."""
    return int(_collision_counts(cfg, means, radii).max())


def _matched_tile(cfg: SamplerConfig, rho_max: float, extent: float,
                  auto_tile: bool) -> SamplerConfig:
    """The config with its tile shrunk to the collision radii: the sampler's
    3-sigma grid is usually far coarser than the 0.2-shrunk radii."""
    if auto_tile and rho_max > 0.0:
        tile = max(2.0 * rho_max, extent / 512.0)
        if tile < cfg.tile_size:
            cfg = dataclasses.replace(cfg, tile_size=tile)
    return cfg


def _host_rho(radii) -> Tuple[np.ndarray, float]:
    r = radii.detach().cpu().numpy() * 0.2
    alive = r >= 1e-6
    r_eff = np.where(alive, r, 0.0)
    rho = np.where(alive, r_eff + r_eff.max(initial=0.0), 0.0)
    return rho, float(rho.max(initial=0.0))


def _rect(cfg: SamplerConfig, rho_max: float) -> int:
    return min(int(np.ceil(2.0 * rho_max / cfg.tile_size)) + 2,
               max(cfg.grid_shape()))


def suggest_grid_capacities(cfg: SamplerConfig, means, radii,
                            auto_tile: bool = True):
    """Capacity plan for preprocess_grid: (cfg, neighbor_capacity,
    rect_capacity), a config whose tile size is matched to the collision
    radii, the max per-TILE candidate count under the inflated collision
    radii (the table's width), and the per-axis duplicate extent."""
    P, D = means.shape
    cfg = cfg.with_dims(D)
    rho, rho_max = _host_rho(radii)
    extent = (cfg.period if cfg.period is not None
              else cfg.upper[0] - cfg.lower[0])
    cfg = _matched_tile(cfg, rho_max, extent, auto_tile)
    rect = _rect(cfg, rho_max)
    ent = binning.duplicate_entries(
        cfg, means.detach(), _tensor(rho, means.dtype, means.device), rect,
        P * rect ** D)
    T = binning.num_tiles(cfg, D)
    ent_tile = ent[1]
    counts = torch.bincount(ent_tile[ent_tile < T].long(), minlength=T)
    nc = max(int(counts.max()), 1) if counts.numel() else 1
    return cfg, max(8, -(-nc // 8) * 8), rect


def _densities(D: int, X, con_j):
    """The density G of offsets X (..., D) under the neighbours' packed
    conics (..., tri); zero where the quadratic form is positive."""
    Xs = [X[..., d] for d in range(D)]
    cons = [con_j[..., t] for t in range(tri_size(D))]
    G, _ = formulas.power_terms(Xs, cons)
    return G


def preprocess_grid(
    cfg: SamplerConfig,
    means: torch.Tensor,   # (P, D)
    conics: torch.Tensor,  # (P, tri)
    radii: torch.Tensor,   # (P,)
    neighbor_capacity: Optional[int] = None,
    rect_capacity: Optional[int] = None,
) -> Neighbors:
    """Grid-accelerated neighbour table: O(P * candidates) instead of the
    brute-force O(P^2) scan.

    Gaussian j is duplicated into every tile within its inflated collision
    radius rho_j = 0.2 r_j + 0.2 max(r); any i with |mu_i - mu_j| <=
    0.2 (r_i + r_j) <= rho_j therefore finds j among the candidates of its
    own tile, and the true distance test filters the superset.
    ``neighbor_capacity`` caps the candidates per tile (overflow counted,
    never silent).  Neighbour slots come back in ascending Gaussian id."""
    means, conics, radii = means.detach(), conics.detach(), radii.detach()
    P, D = means.shape
    tri = tri_size(D)
    cfg = cfg.with_dims(D)
    NC = neighbor_capacity or min(P, 256)
    R = rect_capacity or cfg.max_tiles_per_gaussian

    r_eff, rho = _collision_geometry(radii)
    alive = radii * 0.2 >= 1e-6

    E_cap = binning.entry_capacity(cfg, P, R)
    (ent_gid, ent_tile, ent_start, rect_of,
     ent_of) = binning.duplicate_entries(cfg, means, rho, R, E_cap)
    T = binning.num_tiles(cfg, D)

    params = torch.cat([means, conics, r_eff[:, None]], dim=1)
    params = torch.cat([params, params.new_zeros((1, params.shape[1]))], 0)
    ent_params = params[ent_gid.long()]   # sentinel gid == P: the zero row

    # Per-tile candidate table (T, NC): contiguous slices of the sorted
    # entry list, so every centre of a tile shares one table row.
    counts = ent_start[1:T + 1] - ent_start[:T]
    cand_overflow = torch.clamp(counts - NC, min=0).sum().to(torch.int32)
    idx = ent_start[:T, None] + torch.arange(
        NC, dtype=torch.int32, device=means.device)[None, :]
    tvalid = idx < ent_start[1:T + 1, None]
    idx_c = torch.clamp(idx, max=ent_gid.shape[0] - 1).long()
    tbl = torch.where(tvalid[..., None], ent_params[idx_c], 0.0)
    tbl_gid = torch.where(tvalid, ent_gid[idx_c], P)

    tile_i = binning.sample_tiles(cfg, means)
    ctr = tbl[tile_i.long()]       # (P, NC, W)
    cand = tbl_gid[tile_i.long()]  # (P, NC)
    validc = cand < P

    mu_j = ctr[..., :D]
    con_j = ctr[..., D:D + tri]
    r_j = ctr[..., D + tri]
    X = formulas.wrap(mu_j - means[:, None, :], cfg.period)
    dist2 = torch.sum(X * X, dim=-1)
    rr = r_eff[:, None] + r_j
    hit = validc & alive[:, None] & (r_j >= 1e-6) & (dist2 <= rr * rr)

    G = _densities(D, X, con_j)
    dens = torch.where(hit, G, 0.0)
    pos_power = hit & (G == 0.0)   # power > 0 culled inside power_terms
    out_idx = torch.where(hit & ~pos_power, cand, -1).to(torch.int32)
    total = dens.sum(dim=1)
    inv_norm = 1.0 / (radii * 0.333 + 1e-6)

    overflow = (rect_of + ent_of + cand_overflow).to(torch.int32)
    return Neighbors(
        out_idx, X * inv_norm[:, None, None], dens, 1.0 / (total + 1e-6),
        overflow, ent_gid=ent_gid, ent_start=ent_start, tile_of_center=tile_i)


def preprocess(
    cfg: SamplerConfig,
    means: torch.Tensor,   # (P, D)
    conics: torch.Tensor,  # (P, tri)
    radii: torch.Tensor,   # (P,)
    neighbor_capacity: Optional[int] = None,
) -> Neighbors:
    """Build the neighbour table by the brute-force scan (the reference's
    findCollisions semantics), _SCAN_ROWS centres at a time; prefer
    ``preprocess_grid`` at scale: the same table up to slot order and
    capacity."""
    means, conics, radii = means.detach(), conics.detach(), radii.detach()
    P, D = means.shape
    NC = neighbor_capacity or min(P, 64)
    r = radii * 0.2
    alive = r >= 1e-6
    inv_norm = 1.0 / (radii * 0.333 + 1e-6)
    ids = torch.arange(P, dtype=torch.int32, device=means.device)

    parts, rows = [], _SCAN_ROWS
    for i0 in range(0, P, rows):
        mu_i = means[i0:i0 + rows]
        dx = formulas.wrap(means[None, :, :] - mu_i[:, None, :], cfg.period)
        dist2 = torch.sum(dx ** 2, dim=-1)
        rad = r[i0:i0 + rows, None] + r[None, :]
        hit = alive[i0:i0 + rows, None] & alive[None, :] & (dist2 <= rad * rad)
        # Ascending-index neighbours compacted into NC slots, then the
        # sentinel P.
        idx = torch.sort(torch.where(hit, ids[None, :], P), dim=1).values
        idx = idx[:, :NC]
        valid = idx < P
        idx_c = torch.clamp(idx, max=P - 1).long()
        X = formulas.wrap(means[idx_c] - mu_i[:, None, :], cfg.period)
        G = _densities(D, X, conics[idx_c])
        dens = torch.where(valid, G, 0.0)
        pos_power = valid & (G == 0.0)
        out_idx = torch.where(valid & ~pos_power, idx, -1).to(torch.int32)
        parts.append((out_idx, X * inv_norm[i0:i0 + rows, None, None], dens,
                      1.0 / (dens.sum(dim=1) + 1e-6), hit.sum(dim=1)))
    idxs, dists, dens, inv_tot, counts = (torch.cat(p) for p in zip(*parts))
    overflow = (counts > NC).sum().to(torch.int32)
    return Neighbors(idxs, dists, dens, inv_tot, overflow)


def aggregate(
    features: torch.Tensor,            # (P, L)
    transform: torch.Tensor,           # (L, L)
    queries: torch.Tensor,             # (P, K)
    keys: torch.Tensor,                # (P, K)
    frequencies: torch.Tensor,         # (nfreq,) or longer
    distance_transform: torch.Tensor,  # (2E,)
    nbr: Neighbors,
) -> torch.Tensor:
    """Forward aggregation over a neighbour table, in plain torch.
    Differentiable by autograd in (features, transform, queries, keys,
    frequencies, distance_transform): the same six gradients as the
    reference's hand-written backward kernel."""
    P, L = features.shape
    D = nbr.dists.shape[-1]
    E = distance_transform.shape[0] // 2
    nfreq = (E - 1) // D // 2
    stride = (E - 1) // D
    NC = nbr.indices.shape[1]
    valid = (nbr.indices >= 0).to(features.dtype)

    if nbr.ent_gid is not None:
        # Grid table: slot j of centre i is entry ent_start[tile_i] + j.
        T = nbr.ent_start.shape[0] - 2
        E_n = nbr.ent_gid.shape[0]
        fk = torch.cat([features, keys], dim=1)
        fk = torch.cat([fk, fk.new_zeros((1, fk.shape[1]))], 0)
        ent_fk = fk[torch.clamp(nbr.ent_gid, max=P).long()]
        win = nbr.ent_start[:T, None] + torch.arange(
            NC, dtype=torch.int32, device=features.device)
        tvalid = win < nbr.ent_start[1:T + 1, None]
        tbl = torch.where(tvalid[..., None],
                          ent_fk[torch.clamp(win, max=E_n - 1).long()], 0.0)
        ctr = tbl[nbr.tile_of_center.long()]
        nbr_features = ctr[..., :L]
        nbr_keys = ctr[..., L:]
    else:
        idx = torch.clamp(nbr.indices, min=0).long()
        nbr_features = features[idx]
        nbr_keys = keys[idx]

    w = torch.einsum("pk,pnk->pn", queries, nbr_keys)

    X = nbr.dists
    dt = distance_transform
    embedding = dt[E - 1].expand(X.shape[:2])
    factor = dt[2 * E - 1].expand(X.shape[:2])
    for d in range(D):
        for e in range(nfreq):
            phase = (frequencies[e] * math.pi) * X[..., d]
            s, c = torch.sin(phase), torch.cos(phase)
            i = d * stride + 2 * e
            embedding = embedding + s * dt[i] + c * dt[i + 1]
            factor = factor + s * dt[E + i] + c * dt[E + i + 1]

    coeff = nbr.inv_total_densities[:, None] * nbr.densities * w * valid
    pre = (torch.einsum("pn,pnl->pl", coeff * factor, nbr_features)
           + (coeff * embedding).sum(dim=1, keepdim=True))
    return pre @ transform


# ---------------------------------------------------------------------------
# Kernel path (kernels/aggregate.py): nothing per-pair through device memory
# ---------------------------------------------------------------------------


class AggPlan(NamedTuple):
    """Static capacities of the kernel aggregation path (hashable): the
    first two fields of dgs_tpu's AggPlan, with its values.  dgs_tpu's
    other four (e_chunks, c_chunks, work_fwd, work_bwd) size the TPU
    layout's chunks and work lists, which the port's kernels do not have."""

    rect: int      # per-axis candidate-tile cap R for duplicate_entries
    entries: int   # sorted-entry capacity (valid duplicates)


class AggBinning(NamedTuple):
    """Acceleration structure and static geometry of the kernel aggregation
    path.  Entries and centres are both sorted by tile and stay compact;
    each row carries the range of the other side on its tile
    (``kernels/aggregate.py``).  All per-pair quantities are recomputed by
    the kernels."""

    ent_gid: torch.Tensor     # (Ep,) int32, P = sentinel (pad slots)
    ent_geo: torch.Tensor     # (D+tri+1, Ep) shifted means, conics, r_eff
    ctr_static: torch.Tensor  # (Cp, D+3) means, r_eff, inv_norm, inv_tot
    cid: torch.Tensor         # (Cp,) int32 original centre id, P = sentinel
    pos: torch.Tensor         # (P,) int32 slot of each centre, Cp = absent
    ctr_ent: torch.Tensor     # (2, Cp) int32 [lo, hi) entry range per centre
    ent_ctr: torch.Tensor     # (2, Ep) int32 [lo, hi) centre range per entry
    overflow: torch.Tensor    # () int32: rect + entry overflow
    rect: int                 # the plan's R: at most R^D entries a Gaussian

    @classmethod
    def from_numpy(cls, ent_gid, ent_geo, ctr_static, cid, pos, ctr_ent,
                   ent_ctr, overflow, rect, *, device=None) -> "AggBinning":
        """A structure from numpy arrays of its fields on ``device``
        (default: the card, ``torch.device("cuda")``)."""
        device = torch.device("cuda" if device is None else device)
        f32, i32 = torch.float32, torch.int32
        return cls(_tensor(ent_gid, i32, device),
                   _tensor(ent_geo, f32, device),
                   _tensor(ctr_static, f32, device),
                   _tensor(cid, i32, device), _tensor(pos, i32, device),
                   _tensor(ctr_ent, i32, device),
                   _tensor(ent_ctr, i32, device),
                   _tensor(overflow, i32, device), int(rect))


def plan_pallas(cfg: SamplerConfig, means, radii, *, block_n: int = 32,
                block_e: int = 128, auto_tile: bool = True):
    """Capacity plan for preprocess_pallas: (cfg', AggPlan), a config whose
    tile size matches the 0.2-shrunk collision radii and exact capacities
    measured from one geometry build.  Two values reach the host: the
    largest inflated radius (the tile and R) and the valid-entry count.
    ``block_n`` / ``block_e`` are the TPU layout's chunk sizes and are not
    read (see AggPlan)."""
    means, radii = means.detach(), radii.detach()
    P, D = means.shape
    cfg = cfg.with_dims(D)
    _, rho = _collision_geometry(radii)
    rho_max = float(rho.max())
    extent = (cfg.period if cfg.period is not None
              else min(u - l for l, u in zip(cfg.lower, cfg.upper)))
    cfg = _matched_tile(cfg, rho_max, extent, auto_tile)
    R = _rect(cfg, rho_max)
    ent_tile = binning.duplicate_entries(cfg, means, rho, R, P * R ** D)[1]
    n_entries = int((ent_tile < binning.num_tiles(cfg, D)).sum())
    return cfg, AggPlan(rect=R, entries=max(-(-n_entries // 128) * 128, 128))


def plan_pallas_sharded(cfg: SamplerConfig, means, radii, n_shards: int,
                        *, block_n: int = 32, block_e: int = 128,
                        auto_tile: bool = True):
    """Plan for tile-range model-parallel aggregation shards: (cfg', plan,
    ranges), with ``ranges`` ``n_shards`` contiguous tile ranges (t0, t1)
    for preprocess_pallas(tile_range=...), balanced by the tiles' entries
    counted in chunks of ``block_e`` (the TPU layout's entry chunk, kept so
    that the ranges are dgs_tpu's exactly).  ``plan`` is plan_pallas's
    global plan: a shard's structure indexes the global compact entry list,
    so its entry capacity stays the global one.  ``block_n`` is not read
    (see plan_pallas)."""
    means, radii = means.detach(), radii.detach()
    P, D = means.shape
    cfg, plan = plan_pallas(cfg, means, radii, auto_tile=auto_tile)
    _, rho = _collision_geometry(radii)
    start = binning.duplicate_entries(
        cfg, means, rho, plan.rect, P * plan.rect ** D)[2].cpu().numpy()
    T = binning.num_tiles(cfg, D)
    chunks = -(-(start[1:T + 1] - start[:T]) // block_e)
    cum = np.cumsum(chunks)
    total = max(int(cum[-1]), 1)
    bounds = ([0] + [int(np.searchsorted(cum, total * s / n_shards))
                     for s in range(1, n_shards)] + [T])
    ranges = tuple((bounds[i], max(bounds[i + 1], bounds[i]))
                   for i in range(n_shards))
    return cfg, plan, ranges


def _pad_rows(x: torch.Tensor, n: int, value) -> torch.Tensor:
    if x.shape[0] == n:
        return x
    pad = x.new_full((n - x.shape[0],) + tuple(x.shape[1:]), value)
    return torch.cat([x, pad], dim=0)


def preprocess_pallas(
    cfg: SamplerConfig,
    means: torch.Tensor,   # (P, D)
    conics: torch.Tensor,  # (P, tri)
    radii: torch.Tensor,   # (P,)
    plan: AggPlan,
    block_n: int = 32,
    block_e: int = 128,
    tile_range: Optional[Tuple[int, int]] = None,
    compute_totals: bool = True,
) -> AggBinning:
    """Build the kernel aggregation structure from a plan of plan_pallas.

    Entries are the Gaussians duplicated into every tile within their
    inflated collision radius, sorted by tile and, on a periodic domain,
    shifted to the periodic image their tile sees (so the raw offset is the
    minimum-image displacement for every same-tile pair); centres are the
    Gaussians sorted by their own tile.  The per-centre total density comes
    from the totals kernel; ``compute_totals=False`` leaves inv_tot at 1 for
    aggregate_pallas(fused_totals=True), which derives the totals from its
    own forward sweep.

    ``tile_range=(t0, t1)`` restricts the structure to tiles [t0, t1), the
    model-parallel shard form: entries and centres outside become
    sentinels (gid / cid P, zero rows, empty ranges) and ``pos`` of an
    absent centre is Cp.  ``block_n`` / ``block_e`` are the TPU layout's
    chunk sizes and are not read."""
    from ..kernels import aggregate as kagg

    means, conics, radii = means.detach(), conics.detach(), radii.detach()
    P, D = means.shape
    tri = tri_size(D)
    cfg = cfg.with_dims(D)
    dev = means.device
    T = binning.num_tiles(cfg, D)
    t0, t1 = (0, T) if tile_range is None else tile_range

    r_eff, rho = _collision_geometry(radii)
    (gid, tile, start, rect_of, ent_of) = binning.duplicate_entries(
        cfg, means, rho, plan.rect, min(P * plan.rect ** D, plan.entries))
    sb = binning.bin_samples(cfg, means)
    s_start, c_tile = sb.s_start, sb.s_tile[0]

    # Entry side: sentinels for pads and for tiles outside the range.
    Ep = -(-gid.shape[0] // kagg.BLOCK) * kagg.BLOCK
    tile = _pad_rows(tile, Ep, T)
    evalid = (tile >= t0) & (tile < t1)
    gid_pad = torch.where(evalid, _pad_rows(gid, Ep, P), P)
    geo = torch.cat([means, conics, r_eff[:, None]], dim=1)
    if cfg.period is not None:
        lo, _ = binning.gaussian_rects(cfg, means, rho)
        geo = torch.cat([geo, lo.to(geo.dtype)], dim=1)
    geo = torch.cat([geo, geo.new_zeros((1, geo.shape[1]))], 0)
    ent = geo[gid_pad.long()]                 # (Ep, D+tri+1[+D])
    if cfg.period is not None:
        npar = D + tri + 1
        k = binning.image_shift(cfg, torch.where(evalid, tile, 2 ** 30),
                                ent[:, npar:])
        ent = torch.cat([ent[:, :D] - cfg.period * k.to(ent.dtype),
                         ent[:, D:npar]], dim=1)
    ent_geo = ent.T.contiguous()              # (D+tri+1, Ep)

    # Centre side: the Gaussians sorted by tile.
    Cp = -(-P // kagg.BLOCK) * kagg.BLOCK
    c_tile = _pad_rows(c_tile, Cp, T)
    cvalid = (c_tile >= t0) & (c_tile < t1)
    cid = torch.where(cvalid, _pad_rows(sb.s_perm, Cp, P), P)
    inv_norm = 1.0 / (radii * 0.333 + 1e-6)
    ctr_tab = torch.cat([means, r_eff[:, None], inv_norm[:, None]], dim=1)
    ctr_tab = torch.cat([ctr_tab, ctr_tab.new_zeros((1, D + 2))], 0)
    ctr_pre = torch.cat([ctr_tab[cid.long()],
                         ctr_tab.new_ones((Cp, 1))], dim=1)   # (Cp, D+3)

    # Each row's range of the other side: its own tile's rows.
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    ct = torch.clamp(c_tile, max=T).long()
    ctr_ent = torch.stack([torch.where(cvalid, start[ct], zero),
                           torch.where(cvalid, start[ct + 1], zero)])
    et = torch.clamp(tile, max=T).long()
    ent_ctr = torch.stack([torch.where(evalid, s_start[et], zero),
                           torch.where(evalid, s_start[et + 1], zero)])

    if compute_totals:
        tot = kagg.totals(D, None, ctr_ent, ent_geo, ctr_pre)
        inv_tot = 1.0 / (tot + 1e-6)
    else:
        inv_tot = ctr_pre.new_ones((Cp, 1))
    ctr_static = torch.cat([ctr_pre[:, :-1], inv_tot], dim=1)

    pos = torch.full((P + 1,), Cp, dtype=torch.int32, device=dev)
    pos[cid.long()] = torch.arange(Cp, dtype=torch.int32, device=dev)
    return AggBinning(
        ent_gid=gid_pad, ent_geo=ent_geo, ctr_static=ctr_static, cid=cid,
        pos=pos[:P].contiguous(), ctr_ent=ctr_ent.contiguous(),
        ent_ctr=ent_ctr.contiguous(),
        overflow=(rect_of + ent_of).to(torch.int32), rect=plan.rect)


def kernel_operands(features, queries, keys, frequencies,
                    distance_transform, agg: AggBinning):
    """(ent_fk (L+K, Ep), ctr_geo (Cp, D+3+K), dtf (1, 2E+nfreq)): the
    parameters gathered into the kernels' operand layouts (sentinel entries
    and centres read an appended zero row)."""
    L, K = features.shape[1], queries.shape[1]
    D = agg.ctr_static.shape[1] - 3
    nfreq = (distance_transform.shape[0] // 2 - 1) // D // 2
    fk = torch.cat([features, keys], dim=1)
    fk = torch.cat([fk, fk.new_zeros((1, L + K))], 0)
    ent_fk = fk[agg.ent_gid.long()].T.contiguous()
    q_tab = torch.cat([queries, queries.new_zeros((1, K))])
    ctr_geo = torch.cat([agg.ctr_static, q_tab[agg.cid.long()]],
                        dim=1).contiguous()
    dtf = torch.cat([distance_transform,
                     frequencies[:nfreq]])[None, :].contiguous()
    return ent_fk, ctr_geo, dtf


class _RawPre(torch.autograd.Function):
    """(features, queries, keys, frequencies, distance_transform) -> the
    (Cp, L) raw pre-activation in slot order (kernels.aggregate.forward);
    the backward runs kernels.aggregate.backward on the inv_tot-scaled
    cotangent, segment-sums the per-entry rows by Gaussian id, un-sorts the
    query rows and sums the code columns over centres."""

    @staticmethod
    def forward(ctx, features, queries, keys, frequencies,
                distance_transform, agg, period, ladder, fused_totals):
        from ..kernels import aggregate as kagg

        P, L = features.shape
        K = queries.shape[1]
        D = agg.ctr_static.shape[1] - 3
        E = distance_transform.shape[0] // 2
        nfreq = (E - 1) // D // 2
        ent_fk, ctr_geo, dtf = kernel_operands(
            features, queries, keys, frequencies, distance_transform, agg)
        if fused_totals:
            # The totals ride the same sweep; every centre's row is linear
            # in its inv_tot, which is applied here (the structure's column
            # is 1).
            pre_u, tot = kagg.forward(
                D, L, K, nfreq, period, agg.ctr_ent, agg.ent_geo, ent_fk,
                ctr_geo, dtf, ladder=ladder, with_totals=True)
            inv_tot = 1.0 / (tot + 1e-6)
            pre = pre_u * inv_tot
        else:
            pre = kagg.forward(
                D, L, K, nfreq, period, agg.ctr_ent, agg.ent_geo, ent_fk,
                ctr_geo, dtf, ladder=ladder)
            inv_tot = agg.ctr_static[:, D + 2:D + 3]
        ctx.save_for_backward(ent_fk, ctr_geo, dtf, inv_tot)
        ctx.agg, ctx.period, ctx.ladder = agg, period, ladder
        ctx.dims = (P, D, L, K, E, nfreq, frequencies.shape[0])
        return pre

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        from ..kernels import aggregate as kagg

        ent_fk, ctr_geo, dtf, inv_tot = ctx.saved_tensors
        agg = ctx.agg
        P, D, L, K, E, nfreq, n_frequencies = ctx.dims
        # Every centre's contribution is linear in its inv_tot: fold it into
        # the cotangent so the kernels never touch it.
        g = (g * inv_tot).contiguous()
        gsum = g.sum(dim=1, keepdim=True)
        dent, dctr = kagg.backward(
            D, L, K, nfreq, ctx.period, (agg.ctr_ent, agg.ent_ctr),
            agg.ent_geo, ent_fk, ctr_geo, dtf, g, gsum, ladder=ctx.ladder)
        d = segment_sum_rows(dent, agg.ent_gid, P, agg.rect ** D)
        # The zero row serves pos == Cp (centres outside a tile_range).
        dq = torch.cat([dctr[:, :K], dctr.new_zeros((1, K))])[agg.pos.long()]
        ddt = dctr[:, K:K + 2 * E].sum(dim=0)
        dfreq = dctr.new_zeros((n_frequencies,))
        dfreq[:nfreq] = dctr[:, K + 2 * E:].sum(dim=0)
        return (d[:, :L], dq, d[:, L:], dfreq, ddt, None, None, None, None)


def aggregate_pallas(
    features: torch.Tensor,            # (P, L)
    transform: torch.Tensor,           # (L, L)
    queries: torch.Tensor,             # (P, K)
    keys: torch.Tensor,                # (P, K)
    frequencies: torch.Tensor,         # (nfreq,) or longer
    distance_transform: torch.Tensor,  # (2E,)
    agg: AggBinning,
    *, period: Optional[float] = None,
    block_n: int = 32, block_e: int = 128,
    ladder_frequencies: bool = False,
    padded_outputs: bool = False,
    fused_totals: bool = False,
) -> torch.Tensor:
    """Forward aggregation through the kernels; differentiable in all six
    parameter groups, with a hand-wired backward for five of them and the
    linear L x L transform chained outside by autograd.

    Numerically equal to ``aggregate`` over an exact (untruncated) neighbour
    table: the kernels enumerate every colliding pair, so there is no
    neighbor_capacity to overflow (agg.overflow reports binning overflow).

    ``period=None`` (the default) is exact for periodic domains too:
    preprocess_pallas shifts every entry's mean to the periodic image its
    tile sees.  Pass the real period only for degenerate footprints that
    cover the whole grid (plan.rect == max grid extent), where the
    full-cover rect emits unshifted entries.

    ``ladder_frequencies`` certifies frequencies[e] == (e+1) frequencies[0]
    exactly: the kernels then take one sin/cos per dim and derive the higher
    rungs by the angle-addition recurrence.  Gradients stay per-rung
    partials.  Passing it with other frequencies silently computes the wrong
    code: it is a certification, not a request.

    ``padded_outputs`` returns the raw (Cp, L) rows in slot order (slot c is
    centre agg.cid[c]; sentinel slots are zero) for the model-parallel shard
    form; ``fused_totals`` (over a structure built with
    compute_totals=False) takes the total densities from the forward sweep
    itself.  ``block_n`` / ``block_e`` are the TPU layout's chunk sizes and
    are not read."""
    pre = _RawPre.apply(features, queries, keys, frequencies,
                        distance_transform, agg, period,
                        bool(ladder_frequencies), bool(fused_totals))
    out_pad = pre @ transform                 # (Cp, L)
    if padded_outputs:
        return out_pad
    # Zero row for pos == Cp (centres outside a tile_range).
    out_pad = torch.cat([out_pad, out_pad.new_zeros((1, out_pad.shape[1]))])
    return out_pad[agg.pos.long()]
