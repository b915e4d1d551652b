"""Differentiable sampling ops with hand-derived backward passes.

The counterpart of ``dgs_tpu/ops/sampling.py``.  Every op is a
``torch.autograd.Function`` whose backward is a closed form, not autograd
through the forward; gradients flow to (means, values, conics) only, the
reference's autograd contract (the sample positions get none).  Three paths
share the interface:

  * ``sample_dense_multi`` (``method="dense"``): all pairs in plain torch,
    the whole (N, k, P) weight tensor at once; for small sizes.
  * ``sample_pallas_multi`` (``method="pallas"``): all pairs through the
    dense kernels of ``kernels/dense.py``.  The name is the JAX package's,
    kept so that callers carry over letter for letter; in this package it
    selects the hand-written CUDA kernels (their plain torch versions for
    CPU tensors).
  * ``sample_tiled_multi`` / ``sample_binned``: the tile-binned path over a
    prebuilt BinningState, the tiled forward kernel, and a backward that is
    the tiled backward kernel followed by a deterministic segment-sum of
    the per-entry gradient rows by Gaussian id.  On wrap-free configs the
    kernel modes of dgs_tpu (``kernel_modes``) swap in the separable
    forward and the moment-form backward.
"""

from __future__ import annotations

import os
import warnings
from typing import Optional, Sequence, Tuple

import torch
from torch.autograd.function import once_differentiable

from ..config import ORDERS, n_components, out_shape, tri_size
from ..utils import profiling
from . import formulas

ALL_ORDERS = ORDERS


def _forward_impl(orders, period, means, values, conics, samples):
    N, D = samples.shape
    C = values.shape[1]
    Xs, con, G, a = formulas.pairwise_context(means, conics, samples,
                                               period)
    outs = []
    for order in orders:
        comps = formulas.components(order, Xs, con, G, a)
        W = torch.stack(comps, dim=1)  # (N, k, P)
        out = torch.einsum("nkp,pc->nkc", W, values)
        outs.append(out.reshape(out_shape(order, N, D, C)))
    return tuple(outs)


def _backward_impl(orders, period, means, values, conics, samples, gs):
    """Closed-form VJP shared by all orders."""
    N, D = samples.shape
    C = values.shape[1]
    Xs, con, G, a = formulas.pairwise_context(means, conics, samples,
                                               period)

    d_means = torch.zeros_like(means)
    d_values = torch.zeros_like(values)
    d_conics = torch.zeros_like(conics)

    for order, g in zip(orders, gs):
        k = n_components(order, D)
        g = g.reshape(N, k, C)
        comps = formulas.components(order, Xs, con, G, a)
        W = torch.stack(comps, dim=1)  # (N, k, P)
        # dL/dvalues[p,c] = sum_{n,comp} W[n,comp,p] * g[n,comp,c]
        d_values = d_values + torch.einsum("nkp,nkc->pc", W, g)
        # h_comp[n,p] = sum_c values[p,c] * g[n,comp,c]
        H = torch.einsum("pc,nkc->nkp", values, g)
        hs = [H[:, i, :] for i in range(k)]
        dmu, dcon = formulas.vjp_params(order, Xs, con, G, a, hs)
        d_means = d_means + torch.stack([m.sum(dim=0) for m in dmu], dim=-1)
        d_conics = d_conics + torch.stack([c.sum(dim=0) for c in dcon],
                                          dim=-1)

    return d_means, d_values, d_conics


class _AllPairs(torch.autograd.Function):
    """(means, values, conics, samples) -> one output per order.  ``impl``
    is a (forward, backward) pair of functions with the signatures of
    _forward_impl and _backward_impl; the backward is impl's closed form,
    never autograd through the forward."""

    @staticmethod
    def forward(ctx, means, values, conics, samples, orders, period, impl):
        ctx.save_for_backward(means, values, conics, samples)
        ctx.orders, ctx.period, ctx.impl = orders, period, impl
        with profiling.named_scope("dgs::op.dense"):
            return impl[0](orders, period, means, values, conics, samples)

    @staticmethod
    @once_differentiable
    def backward(ctx, *gs):
        with profiling.named_scope("dgs::op.dense_bwd"):
            d_means, d_values, d_conics = ctx.impl[1](
                ctx.orders, ctx.period, *ctx.saved_tensors, gs)
        return d_means, d_values, d_conics, None, None, None, None


def sample_dense_multi(orders: Tuple[str, ...], period: Optional[float],
                       means, values, conics, samples):
    """Fused multi-order dense evaluation; returns one output per order."""
    return _AllPairs.apply(means, values, conics, samples, tuple(orders),
                           period, (_forward_impl, _backward_impl))


def sample_dense(order: str, means, values, conics, samples,
                 *, period: Optional[float] = 2.0):
    """Single-order dense evaluation (value/derivative/laplacian/third)."""
    (out,) = sample_dense_multi((order,), period, means, values, conics,
                                samples)
    return out


def sample_dense_all(means, values, conics, samples, *, period=2.0,
                     orders: Sequence[str] = ALL_ORDERS):
    outs = sample_dense_multi(tuple(orders), period, means, values, conics,
                              samples)
    return dict(zip(orders, outs))


# ---------------------------------------------------------------------------
# Kernel path (same interface, the dense CUDA kernels underneath)
# ---------------------------------------------------------------------------


def _split_orders(orders, comp_list, N, D, C):
    """Assemble the kernels' per-component (N, C) tensors into per-order
    output tensors (value (N,C) ... third (N,D,D,D,C))."""
    outs = []
    k0 = 0
    for order in orders:
        k = n_components(order, D)
        stacked = torch.stack(comp_list[k0:k0 + k], dim=1)  # (N, k, C)
        outs.append(stacked.reshape(out_shape(order, N, D, C)))
        k0 += k
    return tuple(outs)


def _split_cotangents(orders, gs, N, D, C):
    """Per-order cotangent tensors -> flat list of per-component (N, C)."""
    parts = []
    for order, g in zip(orders, gs):
        k = n_components(order, D)
        g = g.reshape(N, k, C)
        parts.extend(g[:, i, :] for i in range(k))
    return parts


def _kernel_forward(orders, period, means, values, conics, samples):
    from ..kernels import dense as kdense

    N, D = samples.shape
    comps = kdense.dense_forward(orders, period, means, values, conics,
                                 samples)
    return _split_orders(orders, comps, N, D, values.shape[1])


def _kernel_backward(orders, period, means, values, conics, samples, gs):
    from ..kernels import dense as kdense

    N, D = samples.shape
    g_list = _split_cotangents(orders, gs, N, D, values.shape[1])
    return kdense.dense_backward(orders, period, means, values, conics,
                                 samples, g_list)


def sample_pallas_multi(orders: Tuple[str, ...], period: Optional[float],
                        means, values, conics, samples):
    """Fused multi-order evaluation through the dense kernels (on CUDA
    tensors the hand-written CUDA kernels; the name is dgs_tpu's)."""
    return _AllPairs.apply(means, values, conics, samples, tuple(orders),
                           period, (_kernel_forward, _kernel_backward))


# ---------------------------------------------------------------------------
# Tile-binned path (binning/ + kernels/tiled.py)
# ---------------------------------------------------------------------------


def segment_sum_rows(rows, gid, P: int, slots: int):
    """(P, F) sums of the columns of ``rows`` (F, E) by Gaussian id.

    Deterministic on every device, with no atomics: a stable sort groups
    the columns by gid and kernels.segment.segment_sum adds each Gaussian's
    run of sorted columns in run order (a kernel on CUDA).  Memory is
    O(E + P F): no slot per possible entry.  ``slots`` bounds the columns
    of one Gaussian: R^D for a binning with max_tiles_per_gaussian R, which
    caps every Gaussian's entries at R^D.  A Gaussian with more columns
    than ``slots`` (a state binned with a larger R than the op's config)
    fails loudly: a ValueError on the CPU, an asynchronous device-side
    assert (no host sync) on CUDA.  Columns with gid == P (sentinels) are
    dropped."""
    from ..kernels import segment

    g_sorted, order = torch.sort(gid, stable=True)
    starts = torch.searchsorted(
        g_sorted, torch.arange(P + 1, dtype=g_sorted.dtype,
                               device=gid.device), out_int32=True)
    fits = ~(torch.diff(starts) > slots).any()
    if gid.is_cuda:
        torch._assert_async(fits)
    elif not bool(fits):
        raise ValueError(
            f"segment_sum_rows: a Gaussian has more than {slots} entries; "
            "the binning state was built with a larger "
            "max_tiles_per_gaussian than the config passed to the op")
    return segment.segment_sum(rows, order, starts)


def kernel_modes(cfg, D: int, kernel_period: Optional[float],
                 separable: Optional[bool] = None,
                 moments: Optional[bool] = None, warn: bool = True,
                 folded: Optional[bool] = None, beta_bytes: int = 0):
    """(separable, moments, folded, fold_dv, fold_vjp, h_matmul): the kernel
    modes of the tiled path, resolved as dgs_tpu's sample_tiled_multi
    resolves them (its code, where its comments differ).  All but h_matmul
    need wrap-free (tile-local) pair math, so they are off unless
    ``kernel_period`` is None (unwrapped or open configs).

      separable  ``separable`` None reads cfg.separable_kernels; where that
                 is None too the automatic default is on exactly under
                 cfg.fast_math_dots at wrap-free D >= 3.
      moments    ``moments`` None: the same automatic default; forced on a
                 wrapped config it turns off with a warning (``warn``).
      folded     ``folded`` None reads cfg.folded_values; off under any
                 separable or moment mode (so fast_math_dots at wrap-free
                 D >= 3 runs those even where folded_values is set).
      fold_dv    the folded dvalues: folded, cfg.folded_dvals truthy (None
                 is off) and the beta-expanded cotangent's ``beta_bytes``
                 (ct_beta_bytes) within kernels.tiled.CT_BETA_MAX_BYTES.
      fold_vjp   the folded VJP: fold_dv and cfg.folded_vjp; without
                 fold_dv it turns off silently.
      h_matmul   cfg.h_matmul: h_k as tensor-core contractions in every
                 backward that builds h."""
    from ..kernels import tiled as ktiled

    wrap_free = kernel_period is None
    if separable is None:
        separable = cfg.separable_kernels
    if separable is None:
        separable = bool(cfg.fast_math_dots) and D >= 3 and wrap_free
    else:
        separable = bool(separable) and wrap_free
    if moments is None:
        moments = bool(cfg.fast_math_dots) and D >= 3 and wrap_free
    else:
        if moments and not wrap_free and warn:
            warnings.warn(
                "moment_backward=True requires wrap-free (tile-local) "
                "kernels but the config is periodic without the compact-"
                "support certificate (cfg.unwrapped_kernels); falling back "
                "to the per-pair backward", stacklevel=3)
        moments = bool(moments) and wrap_free
    if folded is None:
        folded = cfg.folded_values
    folded = bool(folded) and wrap_free and not (separable or moments)
    fold_dv = (folded and bool(cfg.folded_dvals)
               and beta_bytes <= ktiled.CT_BETA_MAX_BYTES)
    fold_vjp = fold_dv and bool(cfg.folded_vjp)
    return (separable, moments, folded, fold_dv, fold_vjp,
            bool(cfg.h_matmul))


def ct_beta_bytes(orders, D: int, C: int, Np: int) -> int:
    """Bytes of the folded dvalues' beta-expanded cotangent at Np sample
    columns (R * Np * 4, R the folded row count), which kernel_modes holds
    against CT_BETA_MAX_BYTES."""
    meta, _ = formulas.folded_structure(tuple(orders), D)
    return 4 * C * sum(len(m) for m in meta) * Np


class _TiledForward(torch.autograd.Function):
    """(means, values, conics) -> packed (K*C, Np) outputs in tile-sorted
    sample order; the backward runs on the (K*C, Np) cotangent as it
    arrives and segment-sums the per-entry rows by Gaussian id.

    ``modes`` is kernel_modes' tuple.  With no mode on: the classic kernels
    (kernels.tiled.tiled_forward / tiled_backward).  With separable or
    moments, ``smp`` is the monomial operand and the geom tile-local, and
    the forward is kernels.tiled.tiled_forward_sep (separable) or the
    classic forward on the tile-local operands, wrap-free; the backward is
    kernels.tiled.tiled_backward_moments and moment_combine (moments) or the
    classic backward on the tile-local operands, wrap-free.  With folded,
    ``smp`` is the raw monomial operand and the forward
    kernels.tiled.tiled_forward_folded; the backward is
    tiled_backward_fvjp and fvjp_combine (fold_vjp), tiled_backward_fdv
    (fold_dv), else the classic backward on the tile-local operands.  With
    h_matmul each backward that builds h takes its h_matmul form (the
    classic one is tiled_backward_hmm).  No mode runs a kernel other than
    the one it names."""

    @staticmethod
    def forward(ctx, means, values, conics, orders, cfg, kernel_period,
                state, smp, ent_lo, ent_n, modes):
        from ..kernels import tiled as ktiled

        D = means.shape[1]
        C = values.shape[1]
        separable, moments, folded, fold_dv, fold_vjp, hmm = modes
        local = separable or moments
        ctx.orders, ctx.kernel_period, ctx.state = orders, kernel_period, state
        ctx.P, ctx.D, ctx.C = means.shape[0], D, C
        ctx.slots = cfg.with_dims(D).max_tiles_per_gaussian ** D
        ctx.modes = modes
        ctx.passes = ktiled.dot_passes(cfg)
        if folded:
            meta = formulas.folded_structure(orders, D)[0]
            gid, _, geom, _, fold, foldw = ktiled.prepare_entries(
                state, means, values, conics, ktiled.BLOCK_E, cfg=cfg,
                folded=orders, fold_meta=meta, folded_vjp=fold_vjp)
            ctx.save_for_backward(geom, smp, gid, fold, foldw)
            return ktiled.tiled_forward_folded(orders, D, C, geom, fold, smp,
                                               ent_lo, ent_n,
                                               passes=ctx.passes)
        gid, _, geom, _ = ktiled.prepare_entries(
            state, means, values, conics, ktiled.BLOCK_E, cfg=cfg,
            separable=local)
        ctx.save_for_backward(geom, smp, gid)
        if separable:
            return ktiled.tiled_forward_sep(orders, D, C, geom, smp, ent_lo,
                                            ent_n, passes=ctx.passes)
        if local:
            return ktiled.tiled_forward(
                orders, None, D, C, ktiled.base_rows(geom, D, C),
                ktiled.local_samples(smp, D), ent_lo, ent_n)
        return ktiled.tiled_forward(orders, kernel_period, D, C, geom, smp,
                                    ent_lo, ent_n)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        with profiling.named_scope("dgs::op.tiled_bwd"):
            return _tiled_backward(ctx, grad)


def _tiled_backward(ctx, grad):
    """_TiledForward's backward, inside its span."""
    from ..kernels import tiled as ktiled

    geom, smp, gid = ctx.saved_tensors[:3]
    D, C, orders, passes = ctx.D, ctx.C, ctx.orders, ctx.passes
    separable, moments, folded, fold_dv, fold_vjp, hmm = ctx.modes
    tri = tri_size(D)
    s_lo, s_n = ktiled.sample_ranges(ctx.state, geom.shape[1])
    grad = grad.contiguous()
    if folded:
        local = ktiled.local_samples(smp, D)
        meta = formulas.folded_structure(orders, D)[0]
        cb = (ktiled.ct_beta_rows(meta, C, grad, smp) if fold_dv
              else None)
        if fold_vjp:
            fold, foldw = ctx.saved_tensors[3:]
            rows = ktiled.tiled_backward_fvjp(orders, D, C, geom, fold,
                                              foldw, local, cb, s_lo,
                                              s_n, passes=passes)
            dent = ktiled.fvjp_combine(orders, D, C, rows, geom)
        elif fold_dv:
            dent = ktiled.tiled_backward_fdv(orders, D, C, geom, local,
                                             grad, cb, s_lo, s_n,
                                             passes=passes, h_matmul=hmm)
        else:
            dent = _classic_backward(orders, None, D, C,
                                     ktiled.base_rows(geom, D, C),
                                     local, grad, s_lo, s_n, hmm,
                                     passes)
    elif moments:
        rows = ktiled.tiled_backward_moments(orders, D, C, geom, smp,
                                             grad, s_lo, s_n,
                                             passes=passes, h_matmul=hmm)
        dent = ktiled.moment_combine(orders, D, C, rows, geom)
    elif separable:
        dent = _classic_backward(orders, None, D, C,
                                 ktiled.base_rows(geom, D, C),
                                 ktiled.local_samples(smp, D), grad,
                                 s_lo, s_n, hmm, passes)
    else:
        dent = _classic_backward(orders, ctx.kernel_period, D, C, geom,
                                 smp, grad, s_lo, s_n, hmm, passes)
    # The mean rows are d/dmu' of the period-shifted means (or of the
    # tile-local means), and dmu'/dmu = 1 (the image shift and the tile
    # centre are piecewise constant).
    d = segment_sum_rows(dent, gid, ctx.P, ctx.slots)
    return (d[:, :D], d[:, D + tri:], d[:, D:D + tri],
            None, None, None, None, None, None, None, None)


def _classic_backward(orders, period, D, C, geom, smp, grad, s_lo, s_n,
                      hmm: bool, passes: int):
    """The classic backward kernel, or its h_matmul form."""
    from ..kernels import tiled as ktiled

    if hmm:
        return ktiled.tiled_backward_hmm(orders, period, D, C, geom, smp,
                                         grad, s_lo, s_n, passes=passes)
    return ktiled.tiled_backward(orders, period, D, C, geom, smp, grad, s_lo,
                                 s_n)


def sample_tiled_multi(orders: Tuple[str, ...], cfg,
                       means, values, conics, samples, state,
                       *, sorted_outputs: bool = False,
                       unique_outputs: bool = False,
                       padded_outputs: bool = False,
                       unwrapped: bool = False,
                       separable: Optional[bool] = None,
                       moments: Optional[bool] = None,
                       folded: Optional[bool] = None):
    """Fused multi-order evaluation over a prebuilt BinningState
    (binning.grid.build); returns one output per order.

    Output modes, as in dgs_tpu: by default each order comes back in the
    reference shapes (value (N,C) ... third (N,D,D,D,C)) in sample order;
    ``sorted_outputs`` keeps the tile-sorted order (row r is sample
    state.s_perm[r]); ``unique_outputs`` skips the symmetric mirror
    ((N, n_unique, C) canonical components); ``padded_outputs`` (requires
    sorted_outputs) returns the kernel's raw (n_unique, C, Np) layout with
    zero pad columns.  ``unwrapped`` drops the per-pair torus wrap (exact
    under the planner's compact-support certificate).  ``state`` must come
    from binning.build with this ``cfg`` (the periodic image shift and the
    backward's slot bound R^D read it).  ``separable`` / ``moments`` /
    ``folded`` force the kernel modes on or off (None: kernel_modes'
    default; dgs_tpu's sample_binned passes cfg.moment_backward, as this
    one's does).
    Gradients flow to (means, values, conics).  ops.sampling_chunked runs
    the same forward and output assembly over a binning of its own."""
    N, D = samples.shape
    C = values.shape[1]
    if padded_outputs and not sorted_outputs:
        raise ValueError("padded_outputs requires sorted_outputs")
    orders = tuple(orders)
    packed_t = tiled_packed(orders, cfg, means, values, conics, samples,
                            state, None if unwrapped else cfg.period,
                            separable=separable, moments=moments,
                            folded=folded)
    pos = None if sorted_outputs else sample_columns(state.s_perm)
    return tiled_outputs(packed_t, orders, D, C, N, pos,
                         unique_outputs=unique_outputs,
                         padded_outputs=padded_outputs)


def tiled_packed(orders: Tuple[str, ...], cfg, means, values, conics,
                 samples, state, kernel_period: Optional[float],
                 separable: Optional[bool] = None,
                 moments: Optional[bool] = None, mono=None,
                 folded: Optional[bool] = None):
    """The tiled forward kernel's packed (K*C, Np) outputs over ``state``
    (tile-sorted columns, zero pad columns), differentiable in (means,
    values, conics) through _TiledForward, in the kernel modes that
    kernel_modes resolves from ``separable`` / ``moments`` / ``folded``.
    ``samples`` gives only N and the device (the coordinates come from
    state.s_sorted); ``mono`` is the monomial operand where the caller has
    built it (prepare_samples with ``separable``, or with ``folded_deg`` at
    least kernels.tiled.folded_degree: its rows past that basis are
    dropped);
    the backward's slot bound is cfg.max_tiles_per_gaussian ** D."""
    from ..kernels import tiled as ktiled

    if os.environ.get("DGS_ABLATE"):
        raise NotImplementedError(
            "DGS_ABLATE is a TPU kernel-ablation hook of dgs_tpu; "
            "dgs_tpu_torch does not port it")
    with profiling.named_scope("dgs::op.pack"):
        orders = tuple(orders)
        N, D = samples.shape
        C = values.shape[1]
        Np = ktiled._round_up(N, ktiled.BLOCK_N)
        modes = kernel_modes(cfg, D, kernel_period, separable, moments,
                             folded=folded,
                             beta_bytes=ct_beta_bytes(orders, D, C, Np))
        separable, moments, folded = modes[:3]
        if mono is not None and (separable or moments or folded):
            smp = mono
            n_mono = ktiled.folded_layout(orders, D, C)[1] if folded else None
            if folded and mono.shape[0] != n_mono + 1:
                smp = torch.cat([mono[:n_mono], mono[-1:]], dim=0)
        else:
            smp = ktiled.prepare_samples(
                state, samples, ktiled.BLOCK_N, cfg=cfg,
                separable=separable or moments,
                folded_deg=ktiled.folded_degree(orders) if folded else None)[0]
        ent_lo, ent_n = ktiled.entry_ranges(state, Np)
        return _TiledForward.apply(means, values, conics, orders, cfg,
                                   kernel_period, state, smp, ent_lo, ent_n,
                                   modes)


def sample_columns(s_perm) -> torch.Tensor:
    """(N,) int64 column of each sample in the tile-sorted layout: the
    inverse of ``s_perm`` (sorted row r belongs to sample s_perm[r])."""
    N = s_perm.shape[0]
    pos = torch.empty(N, dtype=torch.long, device=s_perm.device)
    pos[s_perm.long()] = torch.arange(N, device=s_perm.device)
    return pos


def tiled_outputs(packed_t, orders: Tuple[str, ...], D: int, C: int,
                  N: int, pos, *, unique_outputs: bool = False,
                  padded_outputs: bool = False):
    """One output per order from the tiled forward's packed (K*C, Np)
    tile-sorted outputs.  ``padded_outputs``: each order's raw
    (n_unique, C, Np) rows.  Otherwise rows come back (N, ...) in sample
    order when ``pos`` (sample_columns) is given, in tile-sorted order when
    it is None; ``unique_outputs`` keeps (N, n_unique, C) canonical
    components, else the symmetric mirror gives the reference shapes."""
    with profiling.named_scope("dgs::op.outputs"):
        if not padded_outputs:
            out = packed_t[:, :N].T            # (N, K*C)
            if pos is not None:
                out = out[pos]

        outs, k0 = [], 0
        for order in orders:
            nu = formulas.n_unique(order, D)
            if padded_outputs:
                rows = packed_t[k0 * C:(k0 + nu) * C, :]
                outs.append(rows.reshape(nu, C, -1))
                k0 += nu
                continue
            block = out[:, k0 * C:(k0 + nu) * C].reshape(N, nu, C)
            if unique_outputs:
                outs.append(block)
            else:
                fmap = formulas.full_to_unique(order, D)
                if len(fmap) != nu:
                    # A blocking host-to-device copy: the host waits for
                    # the card's queue to drain.
                    profiling.count("sync.tiled_outputs")
                    fmap = torch.tensor(fmap, device=block.device)
                    block = block[:, fmap, :]
                outs.append(block.reshape(out_shape(order, N, D, C)))
            k0 += nu
        return tuple(outs)


def sample_binned(cfg, means, values, conics, covariances, samples,
                  orders: Tuple[str, ...] = ALL_ORDERS,
                  sorted_outputs: bool = False,
                  unique_outputs: bool = False,
                  padded_outputs: bool = False,
                  sample_binning=None,
                  gaussian_binning=None):
    """Bin, then evaluate: returns (outputs dict, diagnostics dict).

    diagnostics: ``perm`` (with sorted_outputs, output row r is sample
    perm[r]; else None), ``bin_overflow`` (Gaussians whose footprint
    exceeded max_tiles_per_gaussian), ``entry_overflow`` (entries dropped
    by the entry capacity), and ``work_overflow_fwd`` / ``_bwd``, which are
    0 by construction: the CUDA kernel has no static work list to overflow
    (each block walks its own entry range).  All must be 0 for exact
    results."""
    from ..binning import grid as binning

    state = binning.build(cfg, means, covariances, samples,
                          sample_binning=sample_binning,
                          gaussian_binning=gaussian_binning)
    outs = sample_tiled_multi(
        tuple(orders), cfg, means, values, conics, samples, state,
        sorted_outputs=sorted_outputs, unique_outputs=unique_outputs,
        padded_outputs=padded_outputs, unwrapped=cfg.unwrapped_kernels,
        moments=cfg.moment_backward,
    )
    zero = torch.zeros((), dtype=torch.int32, device=means.device)
    diag = {
        "perm": state.s_perm if sorted_outputs else None,
        "bin_overflow": state.overflow,
        "entry_overflow": state.entry_overflow,
        "work_overflow_fwd": zero,
        "work_overflow_bwd": zero,
    }
    return dict(zip(orders, outs)), diag


def _dense_op(method: str):
    if method == "pallas":
        return sample_pallas_multi
    if method == "dense":
        return sample_dense_multi
    raise ValueError(f"unknown dense method {method!r}: 'pallas' or 'dense'")


def sample(order: str, means, values, conics, samples, *,
           period: Optional[float] = 2.0, method: str = "pallas"):
    """Public single-order entry point.

    method: "pallas" (the dense kernels: CUDA on the card) or "dense" (the
    plain torch path).  Both produce the same values and gradients."""
    (out,) = _dense_op(method)((order,), period, means, values, conics,
                               samples)
    return out


def sample_all(means, values, conics, samples, *, period=2.0,
               orders: Sequence[str] = ALL_ORDERS, method: str = "pallas"):
    """Fused multi-order evaluation: one pairwise pass for all orders."""
    outs = _dense_op(method)(tuple(orders), period, means, values, conics,
                             samples)
    return dict(zip(orders, outs))
