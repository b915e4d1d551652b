"""The pair rule of a tile-binned configuration, frozen.

A (sample, Gaussian) pair counts iff the Gaussian's sigma box (per axis,
or the largest radius on every axis), cut down by the ellipsoid cull where
the configuration asks for it, covers the sample's tile; in any D from 1
to 3.  The cull is a coordinate descent of ``CULL_SWEEPS`` clamped sweeps,
an upper bound on the box minimum of the quadratic form and not the exact
minimum, so a tile on the ellipsoid's border can fall either way by a last
bit.  The rule is
therefore computed here in float32, operation for operation as the system
under test specifies it (its binning is pinned bitwise), and the float64
arithmetic of ``gaussians.py`` runs only over the pairs this rule keeps.

Everything is plain torch over the parameters the benchmark made.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

CULL_SWEEPS = 4       # clamped coordinate-descent sweeps of the cull
CULL_TOL = 1e-3       # keep tiles within (1 + tol) of the sigma level


def tri_index(D: int, i: int, j: int) -> int:
    u, v = (i, j) if i <= j else (j, i)
    return u * D - u * (u - 1) // 2 + (v - u)


class Grid(NamedTuple):
    """The tile grid of a periodic domain [lower, lower + period)^D."""

    D: int
    period: float
    lower: float
    tile: float          # snapped to period / cells
    cells: int           # tiles per axis

    @property
    def strides(self):
        return tuple(self.cells ** (self.D - 1 - d) for d in range(self.D))

    @property
    def tiles(self) -> int:
        return self.cells ** self.D


def make_grid(D: int, period: float, lower: float, tile: float) -> Grid:
    cells = max(1, math.ceil(period / tile - 1e-9))
    return Grid(D, period, lower, period / cells, cells)


def rotation_matrices(rotations: torch.Tensor, D: int) -> torch.Tensor:
    """(P, D, D) rotations: none (D = 1), an angle (D = 2), a quaternion
    (w, x, y, z) normalised to unit length (D = 3)."""
    P = rotations.shape[0]
    if D == 1:
        return torch.ones((P, 1, 1), dtype=rotations.dtype,
                          device=rotations.device)
    if D == 2:
        c, s = torch.cos(rotations[:, 0]), torch.sin(rotations[:, 0])
        return torch.stack([torch.stack([c, -s], -1),
                            torch.stack([s, c], -1)], -2)
    if D != 3:
        raise ValueError(f"no rotation of dimension {D}")
    q = rotations / (torch.linalg.norm(rotations, dim=-1, keepdim=True)
                     + 1e-12)
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1),
    ], -2)


def packed_quadratic(rotations, eigs) -> torch.Tensor:
    """Packed upper triangle of R diag(eigs) R^T, (P, D (D + 1) / 2), with
    D the width of ``eigs``."""
    D = eigs.shape[1]
    R = rotation_matrices(rotations, D)
    return torch.stack([sum(R[:, i, k] * eigs[:, k] * R[:, j, k]
                            for k in range(D))
                        for i in range(D) for j in range(i, D)], dim=-1)


def covariances(log_scales, rotations):
    return packed_quadratic(rotations, torch.exp(2.0 * log_scales))


def conics(log_scales, rotations):
    return packed_quadratic(rotations, torch.exp(-2.0 * log_scales))


def dim_of(packed: torch.Tensor) -> int:
    """D of packed symmetric D x D matrices."""
    D = {1: 1, 3: 2, 6: 3}.get(packed.shape[1])
    if D is None:
        raise ValueError(f"no packed matrix of width {packed.shape[1]}")
    return D


def max_radius(cov: torch.Tensor, sigma: float,
               eig_floor: float) -> torch.Tensor:
    """sigma * sqrt(largest eigenvalue) of packed covariances (closed
    forms a dimension), zero where the covariance is degenerate: not
    positive (D = 1, 3), or a determinant within a relative 1e-6 of zero
    (D = 2, where ``eig_floor`` floors the discriminant)."""
    D = dim_of(cov)
    if D == 1:
        return sigma * torch.sqrt(torch.clamp(cov[:, 0], min=0.0))
    if D == 2:
        det = cov[:, 0] * cov[:, 2] - cov[:, 1] ** 2
        mid = 0.5 * (cov[:, 0] + cov[:, 2])
        lam = mid + torch.sqrt(torch.clamp(mid * mid - det, min=eig_floor))
        r = sigma * torch.sqrt(torch.clamp(lam, min=0.0))
        scale = torch.abs(cov[:, 0] * cov[:, 2]) + cov[:, 1] ** 2 + 1e-30
        return torch.where(torch.abs(det) <= 1e-6 * scale, 0.0, r)
    A00, A01, A02, A11, A12, A22 = (cov[:, t] for t in range(6))
    q = (A00 + A11 + A22) / 3.0
    B00, B11, B22 = A00 - q, A11 - q, A22 - q
    p2 = (B00 * B00 + B11 * B11 + B22 * B22
          + 2.0 * (A01 * A01 + A02 * A02 + A12 * A12)) / 6.0
    p = torch.sqrt(torch.clamp(p2, min=1e-30))
    detB = (B00 * (B11 * B22 - A12 * A12)
            - A01 * (A01 * B22 - A12 * A02)
            + A02 * (A01 * A12 - B11 * A02))
    r = torch.clamp(detB / (2.0 * p * p * p), -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    lam = q + 2.0 * p * torch.cos(phi)
    return sigma * torch.sqrt(torch.clamp(lam, min=0.0))


def box_radii(cov: torch.Tensor, sigma: float, eig_floor: float,
              per_axis: bool) -> torch.Tensor:
    """(P, D) half-widths of a Gaussian's box: per axis sigma *
    sqrt(cov_dd), the tight box around the sigma ellipsoid, or else the
    largest radius on every axis; zero rows where the covariance is
    degenerate."""
    D = dim_of(cov)
    big = max_radius(cov, sigma, eig_floor)
    if not per_axis:
        return big[:, None].expand(-1, D).contiguous()
    diag = torch.stack([cov[:, tri_index(D, d, d)] for d in range(D)], dim=1)
    r = sigma * torch.sqrt(torch.clamp(diag, min=0.0))
    return torch.where((big <= 0.0)[:, None], 0.0, r)


def sample_tiles(grid: Grid, samples: torch.Tensor) -> torch.Tensor:
    """Flat int32 tile of each sample, clamped into the grid."""
    dev = samples.device
    lower = torch.tensor((grid.lower,) * grid.D, dtype=samples.dtype,
                         device=dev)
    g = torch.tensor((grid.cells,) * grid.D, dtype=torch.int32, device=dev)
    t = torch.floor((samples - lower) / grid.tile).to(torch.int32)
    t = torch.clamp(t, min=torch.zeros_like(g), max=g - 1)
    strides = torch.tensor(grid.strides, dtype=torch.int32, device=dev)
    return (t * strides).sum(dim=1, dtype=torch.int32)


def boxes(grid: Grid, means, radii):
    """Per-axis covered tile ranges [lo, hi), unwrapped, int32 (P, D)."""
    dev = means.device
    lower = torch.tensor((grid.lower,) * grid.D, dtype=means.dtype,
                         device=dev)
    g = torch.tensor((grid.cells,) * grid.D, dtype=torch.int32, device=dev)
    lo = torch.floor((means - lower - radii) / grid.tile).to(torch.int32)
    hi = torch.ceil((means - lower + radii) / grid.tile).to(torch.int32)
    full = (hi - lo) >= g
    lo = torch.where(full, 0, lo)
    hi = torch.where(full, g.expand_as(hi), hi)
    empty = torch.any(radii <= 0.0, dim=-1, keepdim=True)
    hi = torch.where(empty, lo, hi)
    return lo, hi


def cull_keep(grid: Grid, sigma: float, means, con, cand, skip):
    """(P, R^D) keep mask of the ellipsoid cull over candidate tiles."""
    D = grid.D
    lower = torch.tensor((grid.lower,) * D, dtype=means.dtype,
                         device=means.device)
    blo = (lower[None, None, :] + cand.to(means.dtype) * grid.tile
           - means[:, None, :])
    bhi = blo + grid.tile
    Q = [[con[:, tri_index(D, i, j)][:, None] for j in range(D)]
         for i in range(D)]
    y = [torch.clamp(torch.zeros(blo.shape[:2], dtype=means.dtype,
                                 device=means.device),
                     blo[..., d], bhi[..., d]) for d in range(D)]
    for _ in range(CULL_SWEEPS):
        for d in range(D):
            num = sum(Q[d][e] * y[e] for e in range(D) if e != d)
            y[d] = torch.clamp(-num / torch.clamp(Q[d][d], min=1e-30),
                               blo[..., d], bhi[..., d])
    f = sum(Q[d][d] * y[d] * y[d] for d in range(D))
    for d in range(D):
        for e in range(d + 1, D):
            f = f + 2.0 * Q[d][e] * y[d] * y[e]
    level = sigma * sigma * (1.0 + CULL_TOL)
    degenerate = torch.all(con == 0.0, dim=1)[:, None]
    return (f <= level) | degenerate | skip


class TileRule(NamedTuple):
    """A tile-binned configuration's pair rule: its grid, the box's sigma
    level, the eigenvalue floor of the radius at D = 2, per-axis boxes or
    one radius, and the ellipsoid cull (which applies from D = 2)."""

    grid: Grid
    sigma: float
    eig_floor: float
    per_axis: bool
    cull: bool


def rule_of(config: dict) -> TileRule:
    return TileRule(make_grid(config["D"], config["period"], config["lower"],
                              config["tile"]),
                    config["radius_sigma"], config["eig_floor"],
                    config["axis_radii"], config["ellip_cull"])


def radii(rule: TileRule, log_scales, rotations) -> torch.Tensor:
    return box_radii(covariances(log_scales, rotations), rule.sigma,
                     rule.eig_floor, rule.per_axis)


def extent(rule: TileRule, means, log_scales, rotations) -> int:
    """The largest box extent in tiles over all axes and Gaussians."""
    lo, hi = boxes(rule.grid, means, radii(rule, log_scales, rotations))
    return max(int((hi - lo).max()), 1)


class Entries(NamedTuple):
    """The kept (Gaussian, tile) entries, sorted by tile, and where each
    tile's entries start ((tiles + 1,) int64)."""

    gid: torch.Tensor
    tile: torch.Tensor
    start: torch.Tensor


def entries(rule: TileRule, means, log_scales, rotations, R: int,
            rows: int = 16384) -> Entries:
    """The rule's entries of float32 Gaussians with at most ``R`` tiles an
    axis (the first R of a wider box, as the program truncates it and
    reports it in its overflow diagnostics), built ``rows`` Gaussians at a
    time."""
    grid = rule.grid
    D, dev = grid.D, means.device
    con = conics(log_scales, rotations)
    lo, hi = boxes(grid, means, radii(rule, log_scales, rotations))
    ext = hi - lo
    g = torch.tensor((grid.cells,) * D, dtype=torch.int32, device=dev)
    strides = torch.tensor(grid.strides, dtype=torch.int32, device=dev)
    axes = [torch.arange(R, dtype=torch.int32, device=dev)] * D
    offs = torch.stack(torch.meshgrid(*axes, indexing="ij"),
                       dim=-1).reshape(R ** D, D)
    gids, tiles = [], []
    P = means.shape[0]
    for a in range(0, P, rows):
        b = min(P, a + rows)
        cand = lo[a:b, None, :] + offs[None, :, :]
        valid = torch.all(cand < hi[a:b, None, :], dim=-1)
        if rule.cull and D >= 2:
            skip = torch.any(ext[a:b] >= g[None, :], dim=1)[:, None]
            valid = valid & cull_keep(grid, rule.sigma, means[a:b],
                                      con[a:b], cand, skip)
        cand = cand - torch.div(cand, g, rounding_mode="floor") * g
        tile = (cand * strides).sum(dim=-1, dtype=torch.int32)
        gid = torch.arange(a, b, device=dev)[:, None].expand_as(tile)
        gids.append(gid[valid])
        tiles.append(tile[valid].long())
    gid, tile = torch.cat(gids), torch.cat(tiles)
    order = torch.argsort(tile * P + gid)
    gid, tile = gid[order], tile[order]
    start = torch.searchsorted(tile, torch.arange(grid.tiles + 1,
                                                  device=dev))
    return Entries(gid, tile, start)


def pair_count(ents: Entries, sample_tile: torch.Tensor, tiles: int) -> int:
    """Kept pairs: sum over tiles of entries times samples."""
    s = torch.bincount(sample_tile.long(), minlength=tiles)
    e = torch.diff(ents.start)
    return int((s.long() * e.long()).sum())


