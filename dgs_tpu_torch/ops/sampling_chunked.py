"""The chunked sampling path: the counterpart of
``dgs_tpu/ops/sampling_chunked.py``, the JAX package's production method at
D = 3 (its bench picks it whenever D == 3).

The contract is the JAX package's: a host-side plan (``plan_chunked``)
measures the per-axis candidate-tile cap R and the entry capacity from one
geometry build and certifies the wrap-free kernels; the sample side is
binned once per sample set (``chunk_samples``); every evaluation
(``sample_chunked_multi`` / ``sample_chunked``) bins the Gaussians into
(gaussian, tile) entries under those capacities and runs the tiled kernels.
A pair counts iff the Gaussian's rect (ellipsoid-culled under
``cfg.ellip_cull``) covers the sample's tile, as on the tiled path.

The layout is not the JAX package's.  There, both sides are padded per tile
to chunks and the Pallas kernels walk work lists of same-tile chunk pairs
(``dgs_tpu/binning/chunked.py``).  The port's tiled kernels take compact
tile-sorted sides and a range of the other side per 32 rows, so no side is
padded, no work list is built and nothing beyond the entry capacity can
overflow: the path is ``ops.sampling``'s tiled forward (kernel 1, then
kernel 2 and the gid segment-sum in the backward) over a binning built
here, in the kernel modes ``_kernel_modes`` resolves from the config as
dgs_tpu's does (under ``fast_math_dots`` at D = 3 the separable forward and
the moment-form backward; under ``folded_values`` the folded kernels).
Gradients flow to (means, values, conics) only.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from ..binning import grid as binning
from ..config import SamplerConfig
from ..oracle.dense import radii as compute_radii, radii_axis
from ..utils import profiling
from . import sampling


class ChunkPlan(NamedTuple):
    """Static capacities of the chunked path, measured by plan_chunked.

    dgs_tpu's plan also holds e_chunks, s_chunks, work_fwd and work_bwd,
    which size the TPU kernels' chunk padding and work lists; the port's
    kernels have neither, so only the two fields that size something here
    are kept."""

    rect: int      # per-axis candidate-tile cap R for duplicate_entries
    entries: int   # entry capacity (a multiple of 128)


class ChunkedSamples(NamedTuple):
    """The sample side, built once per sample set: the tile binning of the
    samples, each sample's column in the tile-sorted layout and, where the
    config's kernel modes need it, the monomial operand.

    dgs_tpu's ChunkedSamples also carries the chunk layout (s_coords, cm,
    cbase, ctile) and a chunk-capacity overflow counter; the port has no
    chunk layout, so they are left out."""

    binning: binning.SampleBinning
    pos: torch.Tensor   # (N,) int64 sorted column of each sample
    # (mono_rows(D) + 1, Np) [1, x_l, -w/2 x_i x_j, tile] (kernels.tiled
    # .prepare_samples with ``separable``), under the folded modes the raw
    # monomials to degree 3 and the tile row (``folded_deg``), or None
    # where no mode needs it.
    mono: Optional[torch.Tensor] = None


def _kernel_period(cfg: SamplerConfig) -> Optional[float]:
    """The period the chunked path's kernels wrap by: None where they run
    wrap-free (cfg.unwrapped_kernels or an open domain)."""
    return None if cfg.unwrapped_kernels else cfg.period


def _kernel_modes(cfg: SamplerConfig):
    """(separable, moments, folded) resolved from the config flags for the
    chunked path, as dgs_tpu's _kernel_modes: ops.sampling.kernel_modes
    over _kernel_period, with no warning here.  chunk_samples and
    sample_chunked_multi both read this one resolution; the folded
    backward's modes (fold_dv, fold_vjp, h_matmul) follow from it in
    ops.sampling.tiled_packed, which knows the sizes the gate reads."""
    return sampling.kernel_modes(cfg, cfg.D, _kernel_period(cfg),
                                 cfg.separable_kernels, cfg.moment_backward,
                                 warn=False)[:3]


def _radii(cfg: SamplerConfig, covariances, D: int):
    """Footprint radii as the chunked path bins with them: per axis under
    cfg.axis_radii, else one per Gaussian."""
    fn = radii_axis if cfg.axis_radii else compute_radii
    with profiling.named_scope("dgs::op.radii"):
        return fn(covariances, D, cfg.radius_sigma, cfg.eig_floor)


def plan_chunked(cfg: SamplerConfig, means, covariances, samples,
                 *, block_n: Optional[int] = None,
                 block_e: Optional[int] = None,
                 headroom: float = 1.0):
    """Host-side capacity plan from one geometry build of the Gaussians:
    (cfg', ChunkPlan), as dgs_tpu's plan_chunked.

    cfg' turns on ``unwrapped_kernels`` where every footprint satisfies
    max radius + tile < period / 2 (the compact-support certificate: the
    period-shifted entry means make the raw offset the minimum-image one).
    ``rect`` is the largest rect extent; ``entries`` the valid entries of
    one duplicate_entries (ellipsoid-culled with the conics of the
    covariances when cfg.ellip_cull and D >= 2) times ``headroom``, rounded
    up to a multiple of 128 and at least 128.  ``headroom > 1`` leaves room
    for training drift; the diagnostics of every evaluation still report
    entries past the plan.  ``samples`` and the block sizes ``block_n`` /
    ``block_e`` size dgs_tpu's chunk and work-list capacities only: they
    are accepted for its signature and not read.  Three values are read
    back to the host."""
    means, covariances = means.detach(), covariances.detach()
    P, D = means.shape
    cfg = cfg.with_dims(D)
    rad = _radii(cfg, covariances, D)
    if cfg.period is not None and not cfg.unwrapped_kernels:
        if float(rad.max()) + cfg.tile_size < cfg.period / 2.0:
            cfg = dataclasses.replace(cfg, unwrapped_kernels=True)
    lo, hi = binning.gaussian_rects(cfg, means, rad)
    R = max(int((hi - lo).max()), 1)
    plan_conics = (binning.conics_from_cov(covariances, D)
                   if cfg.ellip_cull and D >= 2 else None)
    ent_tile = binning.duplicate_entries(cfg, means, rad, R, P * R ** D,
                                         conics=plan_conics)[1]
    n_entries = int((ent_tile < binning.num_tiles(cfg, D)).sum())
    entries = max(-(-int(n_entries * headroom) // 128) * 128, 128)
    return cfg, ChunkPlan(rect=R, entries=entries)


def chunk_samples(cfg: SamplerConfig, samples, plan: ChunkPlan,
                  block_n: int, sample_binning=None) -> ChunkedSamples:
    """The sample side of the chunked path (once per sample set): the
    tile-sorted samples (``sample_binning`` if given), each sample's
    column, and the monomial operand of the kernel modes where the config
    resolves to one (_kernel_modes; dgs_tpu builds its monomial matrix here
    too).  ``plan`` and ``block_n`` size dgs_tpu's chunk layout and are not
    read."""
    from ..kernels import tiled as ktiled

    samples = samples.detach()
    cfg = cfg.with_dims(samples.shape[1])
    sb = (sample_binning if sample_binning is not None
          else binning.bin_samples(cfg, samples))
    separable, moments, folded = _kernel_modes(cfg)
    mono = None
    if folded:   # raw monomials to degree 3, which covers every order set
        mono = ktiled.prepare_samples(sb, samples, ktiled.BLOCK_N, cfg=cfg,
                                      folded_deg=3)[0]
    elif separable or moments:
        mono = ktiled.prepare_samples(sb, samples, ktiled.BLOCK_N, cfg=cfg,
                                      separable=True)[0]
    return ChunkedSamples(binning=sb, pos=sampling.sample_columns(sb.s_perm),
                          mono=mono)


def sample_chunked_multi(
    orders: Tuple[str, ...],
    cfg: SamplerConfig,
    means, values, conics, radii,
    cs: ChunkedSamples,
    plan: ChunkPlan,
    *,
    block_n: int, block_e: int,
    unique_outputs: bool = False,
    padded_outputs: bool = False,
):
    """Fused multi-order evaluation under the plan's capacities; returns
    (outputs tuple, diagnostics dict), as dgs_tpu's.

    The Gaussians are binned with ``radii`` (per axis or scalar, as the
    plan's) into at most ``plan.entries`` entries of at most ``plan.rect``
    tiles an axis, ellipsoid-culled with the model ``conics`` under
    cfg.ellip_cull (dgs_tpu culls with these at run time and plans with
    the conics of the covariances; a tile on the ellipsoid's boundary can
    fall either way, which the plan's rounding to 128 entries absorbs and
    the diagnostics report where it does not).  Then the tiled forward
    kernel runs, wrap-free under cfg.unwrapped_kernels; the backward is
    the tiled backward kernel and the segment-sum by Gaussian id.

    Outputs: by default the reference shapes in sample order;
    ``unique_outputs`` keeps (N, n_unique, C) canonical components;
    ``padded_outputs`` returns each order's tile-sorted (n_unique, C, Np)
    rows with zero pad columns (the port's layout: Np is N rounded up to
    the kernels' 32, where dgs_tpu's columns are chunk-padded per tile).
    The multiplicity-weighted sum of squares of the padded rows equals the
    sum of squares of the full outputs in both packages.

    Diagnostics: ``perm`` None; ``bin_overflow`` (Gaussians whose rect
    exceeds plan.rect tiles an axis); ``entry_overflow`` (entries past
    plan.entries); ``work_overflow_fwd`` / ``_bwd`` 0 by construction, as
    on the port's tiled path.  dgs_tpu also counts its chunk capacities
    there; the port has none, so it reports only what can overflow in it.
    All must be 0 for exact results.  ``block_n`` / ``block_e`` size
    dgs_tpu's chunks and are not read."""
    with profiling.named_scope("dgs::op.chunked"):
        return _chunked_multi(orders, cfg, means, values, conics, radii, cs,
                              plan, unique_outputs, padded_outputs)


def _chunked_multi(orders, cfg, means, values, conics, radii, cs, plan,
                   unique_outputs, padded_outputs):
    """sample_chunked_multi's body; its callers open the op's span."""
    profiling.count("calls.chunked")
    P, D = means.shape
    C = values.shape[1]
    cfg = cfg.with_dims(D)
    radii = radii.detach()
    cull = conics.detach() if cfg.ellip_cull and D >= 2 else None
    (gid, tile, start, rect_of, ent_of) = binning.duplicate_entries(
        cfg, means.detach(), radii, plan.rect,
        min(P * plan.rect ** D, plan.entries), conics=cull)
    sb = cs.binning
    state = binning.BinningState(
        ent_gid=gid, ent_tile=tile[None, :], ent_start=start,
        s_perm=sb.s_perm, s_tile=sb.s_tile, s_start=sb.s_start,
        s_sorted=sb.s_sorted, radii=radii, overflow=rect_of,
        entry_overflow=ent_of)
    # The op's slot bound is R^D with the plan's R, which may exceed the
    # config's max_tiles_per_gaussian.
    op_cfg = dataclasses.replace(cfg, max_tiles_per_gaussian=plan.rect)
    N = cs.pos.shape[0]
    # The modes chunk_samples built cs.mono for; tiled_packed keeps them as
    # given (kernel_modes leaves a resolved triple unchanged) and slices the
    # raw monomials to the orders' degree.
    separable, moments, folded = _kernel_modes(cfg)
    packed_t = sampling.tiled_packed(
        orders, op_cfg, means, values, conics, sb.s_sorted.T, state,
        _kernel_period(cfg), separable=separable, moments=moments,
        mono=cs.mono, folded=folded)
    outs = sampling.tiled_outputs(
        packed_t, tuple(orders), D, C, N,
        None if padded_outputs else cs.pos,
        unique_outputs=unique_outputs, padded_outputs=padded_outputs)
    zero = torch.zeros((), dtype=torch.int32, device=means.device)
    diag = {"perm": None, "bin_overflow": rect_of, "entry_overflow": ent_of,
            "work_overflow_fwd": zero, "work_overflow_bwd": zero}
    return outs, diag


def sample_chunked(cfg, means, values, conics, covariances, samples,
                   plan: ChunkPlan, cs: ChunkedSamples,
                   orders: Tuple[str, ...],
                   *, unique_outputs: bool = False,
                   padded_outputs: bool = False):
    """The chunked evaluation with sample_binned's contract: (outputs dict,
    diagnostics dict), the radii derived from ``covariances`` on every
    call (per axis under cfg.axis_radii).  ``samples`` is accepted for
    dgs_tpu's signature; the sample side is ``cs``."""
    D = means.shape[1]
    cfg = cfg.with_dims(D)
    with profiling.named_scope("dgs::op.chunked"):
        rad = _radii(cfg, covariances.detach(), D)
        outs, diag = _chunked_multi(tuple(orders), cfg, means, values,
                                    conics, rad, cs, plan, unique_outputs,
                                    padded_outputs)
    return dict(zip(orders, outs)), diag
