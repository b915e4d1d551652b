"""World-space tile binning: the acceleration structure of the tiled path.

The torch counterpart of ``dgs_tpu/binning/grid.py``.  Each Gaussian is
duplicated once per tile its footprint box covers ("entries"), the entries
are sorted by tile, the samples are sorted by tile, and per-tile range starts
are found by binary search.  For a block of consecutive sorted samples the
entries that can pair with it then form one contiguous range of the sorted
entry list, and a pair is valid iff its entry tile equals its sample tile.

Every integer output (entry gid / tile / starts, sample perm / tile / starts,
the overflow counters, the forward geometry) is bitwise equal to the JAX
package's, and is kept int32 for that reason; indexing casts to int64 where
torch needs it.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import SamplerConfig, tri_index
from ..oracle.dense import radii as compute_radii, radii_axis
from ..utils import profiling


class BinningState(NamedTuple):
    """Acceleration structure shared by the sampling orders."""

    ent_gid: torch.Tensor     # (E,) int32 gaussian id, P = sentinel pad
    ent_tile: torch.Tensor    # (1, E) int32 flat tile id, T = sentinel pad
    ent_start: torch.Tensor   # (T+2,) int32 entry range starts per tile
    s_perm: torch.Tensor      # (N,) int32 sample id by sorted position
    s_tile: torch.Tensor      # (1, N) int32 tile of sorted sample
    s_start: torch.Tensor     # (T+2,) int32 sample range starts per tile
    s_sorted: torch.Tensor    # (D, N) sample coords by sorted position
    radii: torch.Tensor       # (P,) or (P, D) float32 (zero = culled)
    overflow: torch.Tensor        # () int32 Gaussians beyond the R^D cap
    entry_overflow: torch.Tensor  # () int32 entries beyond the capacity

    @property
    def num_entries(self) -> int:
        return self.ent_gid.shape[0]


class SampleBinning(NamedTuple):
    """The sample-side half of the structure; depends only on (cfg,
    samples), so fixed query points are binned once and reused."""

    s_perm: torch.Tensor
    s_tile: torch.Tensor
    s_start: torch.Tensor
    s_sorted: torch.Tensor


def _grid_info(cfg: SamplerConfig, D: int):
    grid = cfg.with_dims(D).grid_shape()
    T = 1
    strides = []
    for g in reversed(grid):
        strides.append(T)
        T *= g
    strides = tuple(reversed(strides))
    return grid, strides, T


def _i32(values, device) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.int32, device=device)


def num_tiles(cfg: SamplerConfig, D: int) -> int:
    return _grid_info(cfg, D)[2]


def sample_tiles(cfg: SamplerConfig, samples: torch.Tensor) -> torch.Tensor:
    """Flat int32 tile id of each sample, clamped into the grid."""
    N, D = samples.shape
    grid, strides, T = _grid_info(cfg, D)
    dev = samples.device
    lower = torch.tensor(cfg.with_dims(D).lower, dtype=samples.dtype,
                         device=dev)
    t = torch.floor((samples - lower) / cfg.tile_size).to(torch.int32)
    t = torch.clamp(t, min=torch.zeros_like(_i32(grid, dev)),
                    max=_i32(grid, dev) - 1)
    return (t * _i32(strides, dev)).sum(dim=1, dtype=torch.int32)


def gaussian_rects(cfg: SamplerConfig, means: torch.Tensor,
                   radii: torch.Tensor):
    """Per-Gaussian covered tile ranges [lo, hi) per axis (int32 (P, D)).

    Periodic domains leave the indices unwrapped (they wrap at emission);
    open domains clamp them into [0, grid].  A footprint spanning the whole
    grid collapses to one full cover; a zero radius gives an empty rect.
    ``radii`` is (P,) (isotropic box) or (P, D) (per-axis box)."""
    with profiling.named_scope("dgs::binning.rects"):
        P, D = means.shape
        cfg = cfg.with_dims(D)
        grid, _, _ = _grid_info(cfg, D)
        dev = means.device
        # Two blocking host-to-device copies: the host waits for the card.
        profiling.count("sync.gaussian_rects", 2)
        lower = torch.tensor(cfg.lower, dtype=means.dtype, device=dev)
        g = _i32(grid, dev)
        r = radii if radii.ndim == 2 else radii[:, None]
        lo = torch.floor((means - lower - r) / cfg.tile_size).to(torch.int32)
        hi = torch.ceil((means - lower + r) / cfg.tile_size).to(torch.int32)
        if cfg.period is None:
            zero = torch.zeros_like(g)
            lo = torch.clamp(lo, min=zero, max=g)
            hi = torch.clamp(hi, min=zero, max=g)
        full = (hi - lo) >= g
        lo = torch.where(full, 0, lo)
        hi = torch.where(full, g.expand_as(hi), hi)
        empty = torch.any(r <= 0.0, dim=-1, keepdim=True)
        hi = torch.where(empty, lo, hi)
        return lo, hi


ELLIP_CULL_SWEEPS = 4     # coordinate-descent sweeps of ellip_keep
ELLIP_CULL_TOL = 1e-3     # keep tiles within (1 + tol) of the sigma level


def conics_from_cov(covariances: torch.Tensor, D: int) -> torch.Tensor:
    """Packed-tri inverse of packed-tri covariances (closed form, D <= 3);
    rows with non-positive determinant come back as zeros."""
    c = covariances
    if D == 1:
        det = c[:, 0]
        inv = torch.where(det > 0.0, 1.0 / torch.clamp(det, min=1e-30), 0.0)
        return inv[:, None]
    if D == 2:
        det = c[:, 0] * c[:, 2] - c[:, 1] ** 2
        inv = torch.where(det > 0.0, 1.0 / torch.clamp(det, min=1e-30), 0.0)
        return torch.stack([c[:, 2], -c[:, 1], c[:, 0]], dim=1) * inv[:, None]
    a00, a01, a02, a11, a12, a22 = (c[:, t] for t in range(6))
    q00 = a11 * a22 - a12 * a12
    q01 = a02 * a12 - a01 * a22
    q02 = a01 * a12 - a02 * a11
    q11 = a00 * a22 - a02 * a02
    q12 = a01 * a02 - a00 * a12
    q22 = a00 * a11 - a01 * a01
    det = a00 * q00 + a01 * q01 + a02 * q02
    inv = torch.where(det > 0.0, 1.0 / torch.clamp(det, min=1e-30), 0.0)
    return torch.stack([q00, q01, q02, q11, q12, q22], dim=1) * inv[:, None]


def ellip_keep(cfg: SamplerConfig, means: torch.Tensor, conics: torch.Tensor,
               cand: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
    """(P, dup) keep mask: does the radius_sigma ellipsoid meet each
    candidate tile box?  ``cand`` holds the UNWRAPPED per-axis tile indices;
    the minimum of y^T Q y over the centred box is approached by
    ELLIP_CULL_SWEEPS sweeps of clamped coordinate descent.  Degenerate
    (zero-conic) and ``skip`` rows are always kept."""
    with profiling.named_scope("dgs::binning.cull"):
        P, D = means.shape
        profiling.count("sync.ellip_keep")   # a blocking host-to-device copy
        lower = torch.tensor(cfg.lower, dtype=means.dtype, device=means.device)
        blo = (lower[None, None, :] + cand.to(means.dtype) * cfg.tile_size
               - means[:, None, :])                       # (P, dup, D)
        bhi = blo + cfg.tile_size
        Q = [[conics[:, tri_index(D, i, j)][:, None] for j in range(D)]
             for i in range(D)]
        y = [torch.clamp(torch.zeros(blo.shape[:2], dtype=means.dtype,
                                     device=means.device),
                         blo[..., d], bhi[..., d]) for d in range(D)]
        for _ in range(ELLIP_CULL_SWEEPS):
            for d in range(D):
                num = sum(Q[d][e] * y[e] for e in range(D) if e != d)
                y[d] = torch.clamp(-num / torch.clamp(Q[d][d], min=1e-30),
                                   blo[..., d], bhi[..., d])
        f = sum(Q[d][d] * y[d] * y[d] for d in range(D))
        for d in range(D):
            for e in range(d + 1, D):
                f = f + 2.0 * Q[d][e] * y[d] * y[e]
        level = cfg.radius_sigma * cfg.radius_sigma * (1.0 + ELLIP_CULL_TOL)
        degenerate = torch.all(conics == 0.0, dim=1)[:, None]
        return (f <= level) | degenerate | skip


def duplicate_entries(cfg: SamplerConfig, means: torch.Tensor,
                      radii: torch.Tensor, R: int, E_cap: int,
                      conics: Optional[torch.Tensor] = None):
    """Tile-sorted (gaussian, tile) duplicate entries.

    Enumerates the R^D candidate tiles of each Gaussian, wraps them onto a
    periodic grid, sorts by (tile, gid) and truncates to the static
    capacity.  Returns (ent_gid (E,), ent_tile (E,), ent_start (T+2,),
    rect_overflow, entry_overflow), all int32."""
    with profiling.named_scope("dgs::binning"):
        return _duplicate_entries(cfg, means, radii, R, E_cap, conics)


def _duplicate_entries(cfg, means, radii, R, E_cap, conics):
    """duplicate_entries' body, inside its span."""
    P, D = means.shape
    T = _grid_info(cfg, D)[2]
    dev = means.device
    dup = R ** D
    flat, overflow = candidate_keys(cfg, means, radii, R, conics)

    with profiling.named_scope("dgs::binning.sort"):
        # One packed (tile << gid_bits) | gid key sorts tile-major, gid-minor,
        # which is the stable-by-tile order (generation is gid-ascending).
        gid_bits = int(P).bit_length()
        if key_packed(P, T):
            key = torch.sort(flat).values
            ent_tile = key >> gid_bits
            ent_gid = key & ((1 << gid_bits) - 1)
        else:
            gid_flat = torch.arange(P, dtype=torch.int32,
                                    device=dev)[:, None].expand(P, dup)
            gid_flat = torch.where(flat.reshape(P, dup) == T, P, gid_flat)
            ent_tile, order = torch.sort(flat, stable=True)
            ent_gid = gid_flat.reshape(P * dup)[order]

        entry_overflow = torch.zeros((), dtype=torch.int32, device=dev)
        if E_cap < P * dup:
            n_valid = torch.sum(ent_tile < T)
            entry_overflow = torch.clamp(n_valid - E_cap,
                                         min=0).to(torch.int32)
            ent_tile = ent_tile[:E_cap]
            ent_gid = ent_gid[:E_cap]

        ent_start = torch.searchsorted(
            ent_tile.contiguous(),
            torch.arange(T + 2, dtype=torch.int32, device=dev),
            right=False, out_int32=True,
        )
        return ent_gid, ent_tile, ent_start, overflow, entry_overflow


def key_packed(P: int, T: int) -> bool:
    """Whether a (tile << gid_bits) | gid key of P Gaussians over T tiles
    (and the sentinels P and T) fits in 31 bits."""
    return int(P).bit_length() + int(T).bit_length() <= 31


def candidate_keys(cfg: SamplerConfig, means: torch.Tensor,
                   radii: torch.Tensor, R: int,
                   conics: Optional[torch.Tensor] = None):
    """The sort keys of the R^D candidate tiles of each Gaussian, before
    the sort: (flat (P * R^D,) int32, rect_overflow () int32).

    Candidate c of Gaussian g sits at g * R^D + c.  A candidate outside the
    Gaussian's rect, culled by the ellipsoid (``conics`` given and D >= 2),
    or off an open grid has tile T.  ``flat`` holds the packed keys
    (tile << gid_bits) | gid, gid P where the tile is T, where they fit in
    31 bits (``key_packed``), else the tiles.  ``means`` (P, D), ``radii``
    (P,) or (P, D) and ``conics`` (P, D (D + 1) / 2) are float32 on one
    device.  CUDA tensors launch the CUDA kernel (csrc/binning_keys.cu,
    counted in ``candidate_keys.launches``), which reads the grid as
    arguments and copies nothing to the device; CPU tensors run
    candidate_keys_plain."""
    dev = means.device
    if means.ndim != 2 or not 1 <= means.shape[1] <= 3:
        raise ValueError("candidate_keys: means must be (P, D) with D in "
                         f"1..3, got {tuple(means.shape)}")
    P, D = means.shape
    shapes = {"means": [(P, D)], "radii": [(P,), (P, D)]}
    if conics is not None:
        shapes["conics"] = [(P, D * (D + 1) // 2)]
    for arg, t in (("means", means), ("radii", radii), ("conics", conics)):
        if arg in shapes and (t.device != dev or t.dtype != torch.float32
                              or tuple(t.shape) not in shapes[arg]):
            raise ValueError(
                f"candidate_keys: {arg} must be a float32 tensor of shape "
                f"{' or '.join(map(str, shapes[arg]))} on {dev}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if R < 1:
        raise ValueError(f"candidate_keys: R must be at least 1, got {R}")
    if dev.type == "cpu":
        return candidate_keys_plain(cfg, means, radii, R, conics)
    if dev.type != "cuda":
        raise ValueError(f"candidate_keys: no kernel for device {dev}")
    from ..kernels import _build

    lib = _build.load()
    with torch.cuda.device(dev), \
            profiling.named_scope("dgs::binning.keys"):
        out = torch.empty(P * R ** D, dtype=torch.int32, device=dev)
        overflow = torch.zeros((), dtype=torch.int32, device=dev)
        if P == 0:
            return out, overflow
        err = launch_keys(
            lib, cfg, means.contiguous(), radii.contiguous(), R,
            None if conics is None else conics.contiguous(), out, overflow,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"candidate_keys: CUDA launch failed (cudaError {err})")
    candidate_keys.launches += 1
    return out, overflow


candidate_keys.launches = 0


def launch_keys(lib, cfg, means, radii, R, conics, out, overflow,
                stream) -> int:
    """Launch ``lib``'s dgs_binning_keys (csrc/binning_keys.cu) on checked,
    contiguous operands into ``out`` (P * R^D,) and the zeroed
    ``overflow`` (); its error code.  The grid, strides and lower corner go
    as arguments, with the float32 values torch's own ops use: the tile as
    a factor, its reciprocal as the divisor of the rect (torch divides a
    CUDA tensor by a Python float so), the level as torch compares it."""
    P, D = means.shape
    cfg = cfg.with_dims(D)
    grid, strides, T = _grid_info(cfg, D)
    cull = conics is not None and D >= 2
    tile = np.float32(cfg.tile_size)
    level = np.float32(cfg.radius_sigma * cfg.radius_sigma
                       * (1.0 + ELLIP_CULL_TOL))
    ints, floats = ctypes.c_int * D, ctypes.c_float * D
    return lib.dgs_binning_keys(
        means.data_ptr(), radii.data_ptr(), int(radii.ndim == 2),
        conics.data_ptr() if cull else None, D, P, R,
        ints(*grid), ints(*strides), floats(*cfg.lower), float(tile),
        float(np.float32(1.0) / tile), int(cfg.period is not None),
        float(level), T, int(P).bit_length(), int(key_packed(P, T)),
        out.data_ptr(), overflow.data_ptr(), stream)


def candidate_keys_plain(cfg, means, radii, R, conics):
    """candidate_keys in plain torch: the same function on any device."""
    P, D = means.shape
    grid, strides, T = _grid_info(cfg, D)
    dev = means.device
    dup = R ** D

    lo, hi = gaussian_rects(cfg, means, radii)
    extent = hi - lo  # (P, D)
    overflow = torch.sum(
        torch.clamp(torch.prod(torch.clamp(extent, max=R), dim=1), min=0)
        != torch.clamp(torch.prod(extent, dim=1), min=0)
    ).to(torch.int32)

    axes = [torch.arange(R, dtype=torch.int32, device=dev)] * D
    offs = torch.stack(torch.meshgrid(*axes, indexing="ij"),
                       dim=-1).reshape(dup, D)
    cand = lo[:, None, :] + offs[None, :, :]  # (P, dup, D)
    valid = torch.all(cand < hi[:, None, :], dim=-1)
    # Two blocking host-to-device copies (grid, strides): the host waits
    # for the card.
    profiling.count("sync.duplicate_entries", 2)
    g = _i32(grid, dev)
    if conics is not None and D >= 2:
        # Exact ellipsoid-vs-tile cull on the unwrapped candidates; full
        # covers skip it (their collapsed rect has no per-tile geometry).
        skip = torch.any((hi - lo) >= g[None, :], dim=1)[:, None]
        valid = valid & ellip_keep(cfg, means, conics, cand, skip)
    if cfg.period is not None:
        # The periodic image index is not carried: prepare_entries recomputes
        # it from (wrapped tile, rect lo).
        cand = cand - torch.div(cand, g, rounding_mode="floor") * g
    else:
        valid = (valid & torch.all(cand < g, dim=-1)
                 & torch.all(cand >= 0, dim=-1))
    tile = (cand * _i32(strides, dev)).sum(dim=-1, dtype=torch.int32)
    tile = torch.where(valid, tile, T)  # the sentinel tile sorts last
    if not key_packed(P, T):
        return tile.reshape(P * dup), overflow
    gid_bits = int(P).bit_length()
    gid_flat = torch.arange(P, dtype=torch.int32,
                            device=dev)[:, None].expand(P, dup)
    gid_flat = torch.where(tile == T, P, gid_flat)
    return ((tile << gid_bits) | gid_flat).reshape(P * dup), overflow


def image_shift(cfg: SamplerConfig, ent_tile, ent_lo):
    """(E, D) float periodic image index k of each entry: the unique k with
    lo_d <= t_d + k_d * g_d < hi_d.  Sentinel rows give garbage k; callers
    mask them."""
    with profiling.named_scope("dgs::binning.shift"):
        D = ent_lo.shape[1]
        grid, strides, _ = _grid_info(cfg, D)
        t = ent_tile.reshape(-1)
        ks = []
        for d in range(D):
            g = grid[d]
            td = torch.remainder(
                torch.div(t, strides[d], rounding_mode="floor"),
                g).to(torch.float32)
            ks.append(-torch.floor((td - ent_lo[:, d].to(torch.float32)) / g))
        return torch.stack(ks, dim=1)


def tile_centers(cfg: SamplerConfig, tile_flat, D: int):
    """World-space tile centres (..., D) of flat tile ids (pad ids decode
    through the modulus into in-grid values)."""
    grid, strides, _ = _grid_info(cfg, D)
    cs = []
    for d in range(D):
        td = torch.remainder(
            torch.div(tile_flat, strides[d], rounding_mode="floor"), grid[d])
        cs.append(cfg.lower[d]
                  + (td.to(torch.float32) + 0.5) * cfg.tile_size)
    return torch.stack(cs, dim=-1)


def entry_capacity(cfg: SamplerConfig, P: int, R: int) -> int:
    """Static compacted entry capacity (see duplicate_entries)."""
    return min(
        max(int(-(-cfg.entry_capacity_factor * P // 128)) * 128, 4096),
        P * R ** cfg.D,
    )


def bin_samples(cfg: SamplerConfig, samples: torch.Tensor) -> SampleBinning:
    """Sort the samples by tile (stable: equal tiles keep sample order)."""
    N, D = samples.shape
    cfg = cfg.with_dims(D)
    T = _grid_info(cfg, D)[2]
    s_tile_raw = sample_tiles(cfg, samples)
    s_tile, order = torch.sort(s_tile_raw, stable=True)
    s_sorted = samples[order].T.contiguous()  # (D, N)
    s_start = torch.searchsorted(
        s_tile, torch.arange(T + 2, dtype=torch.int32, device=samples.device),
        right=False, out_int32=True,
    )
    return SampleBinning(
        s_perm=order.to(torch.int32), s_tile=s_tile[None, :],
        s_start=s_start, s_sorted=s_sorted,
    )


def build(
    cfg: SamplerConfig,
    means: torch.Tensor,        # (P, D)
    covariances: torch.Tensor,  # (P, tri)
    samples: torch.Tensor,      # (N, D)
    sample_binning: Optional[SampleBinning] = None,
    gaussian_binning: Optional[BinningState] = None,
) -> BinningState:
    """Build the acceleration structure.

    A prebuilt ``sample_binning`` skips the sample sort when the query
    points are unchanged; a prebuilt ``gaussian_binning`` (from the same
    cfg/means/covariances) skips the Gaussian side when only the query
    points change.  The structure is not differentiable: it is built from
    detached inputs."""
    with profiling.named_scope("dgs::binning"):
        return _build(cfg, means, covariances, samples, sample_binning,
                      gaussian_binning)


def _build(cfg, means, covariances, samples, sample_binning,
           gaussian_binning) -> BinningState:
    """build's body, inside its span."""
    means, covariances = means.detach(), covariances.detach()
    samples = samples.detach()
    P, D = means.shape
    cfg = cfg.with_dims(D)
    R = cfg.max_tiles_per_gaussian

    if gaussian_binning is not None:
        sb = (sample_binning if sample_binning is not None
              else bin_samples(cfg, samples))
        return gaussian_binning._replace(
            s_perm=sb.s_perm, s_tile=sb.s_tile, s_start=sb.s_start,
            s_sorted=sb.s_sorted,
        )

    if cfg.axis_radii:
        rad = radii_axis(covariances, D, cfg.radius_sigma, cfg.eig_floor)
    else:
        rad = compute_radii(covariances, D, cfg.radius_sigma, cfg.eig_floor)
    cull_conics = (conics_from_cov(covariances, D)
                   if cfg.ellip_cull and D >= 2 else None)
    (ent_gid, ent_tile, ent_start, overflow,
     entry_overflow) = duplicate_entries(
        cfg, means, rad, R, entry_capacity(cfg, P, R), conics=cull_conics
    )

    sb = sample_binning if sample_binning is not None else bin_samples(
        cfg, samples
    )

    return BinningState(
        ent_gid=ent_gid,
        ent_tile=ent_tile[None, :],
        ent_start=ent_start,
        s_perm=sb.s_perm,
        s_tile=sb.s_tile,
        s_start=sb.s_start,
        s_sorted=sb.s_sorted,
        radii=rad,
        overflow=overflow,
        entry_overflow=entry_overflow,
    )


def pair_mask_dense(cfg: SamplerConfig, state: BinningState,
                    samples: torch.Tensor, P: int) -> torch.Tensor:
    """Dense (N, P) inclusion mask implied by the binning: a pair counts iff
    some entry of the Gaussian lies on the sample's tile (tests use it to
    hold the tiled path against the masked oracle)."""
    s_t = sample_tiles(cfg, samples)  # (N,)
    hits = state.ent_tile[0][None, :] == s_t[:, None]  # (N, E)
    onehot = torch.nn.functional.one_hot(
        state.ent_gid.long(), P + 1)[:, :P].to(torch.float32)  # (E, P)
    return (hits.to(torch.float32) @ onehot) > 0.0


def _range_geometry(row_tiles, row_block, col_starts, col_block, n_rows):
    """Block-granular [base, base + nblocks) sweep ranges (int32).

    For each block of ``row_block`` consecutive tile-sorted rows the
    relevant columns (also tile-sorted) form the contiguous range
    [col_starts[first_tile], col_starts[last_tile + 1]); sentinel rows
    (tile >= T) are left out of the block's tile min/max."""
    RB = -(-n_rows // row_block)
    T = col_starts.shape[0] - 2  # valid tiles are < T
    pad = RB * row_block - n_rows
    tiles = torch.nn.functional.pad(row_tiles, (0, pad), value=T).reshape(
        RB, row_block)
    valid = tiles < T
    first = torch.where(valid, tiles, T).amin(dim=1)
    last = torch.where(valid, tiles, -1).amax(dim=1)
    lo = col_starts[first.long()]  # first == T (empty block) -> starts[T]
    hi = torch.where(last >= 0,
                     col_starts[(torch.clamp(last, min=0) + 1).long()], lo)
    base = torch.div(lo, col_block, rounding_mode="floor")
    nblocks = torch.where(
        hi > lo, -torch.div(-(hi - base * col_block), col_block,
                            rounding_mode="floor"), 0)
    return base.to(torch.int32), nblocks.to(torch.int32)


def forward_geometry(state: BinningState, block_n: int, block_e: int):
    """(base, nblocks) over entry blocks for each sorted-sample block; with
    ``block_e == 1`` these are each block's exact entry range
    [base, base + nblocks)."""
    with profiling.named_scope("dgs::binning.geometry"):
        return _range_geometry(
            state.s_tile[0], block_n, state.ent_start, block_e,
            state.s_tile.shape[1],
        )


def backward_geometry(state: BinningState, block_e: int, block_n: int):
    """(base, nblocks) over sorted-sample blocks for each entry block; with
    ``block_n == 1`` these are each block's exact sample range
    [base, base + nblocks)."""
    with profiling.named_scope("dgs::binning.geometry"):
        return _range_geometry(
            state.ent_tile[0], block_e, state.s_start, block_n,
            state.ent_tile.shape[1],
        )
