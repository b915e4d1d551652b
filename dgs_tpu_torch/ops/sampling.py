"""The tile-binned sampling op.

The counterpart of the tiled half of ``dgs_tpu/ops/sampling.py``
(``sample_tiled_multi`` and ``sample_binned``): a fused multi-order
evaluation over a prebuilt BinningState.  The op is a
``torch.autograd.Function`` over the tiled forward kernel whose backward is
the tiled backward kernel followed by a deterministic segment-sum of the
per-entry gradient rows by Gaussian id.  Gradients flow to (means, values,
conics) only, the reference's autograd contract.
"""

from __future__ import annotations

import os
from typing import Tuple

import torch
from torch.autograd.function import once_differentiable

from ..config import ORDERS, out_shape, tri_size
from . import formulas

ALL_ORDERS = ORDERS


def segment_sum_rows(rows, gid, P: int, slots: int):
    """(P, F) sums of the columns of ``rows`` (F, E) by Gaussian id.

    Deterministic on every device, with no atomics: a stable sort groups
    the columns by gid, each column goes to its own slot of a (P, slots)
    layout (its rank among its Gaussian's columns), and the slots are
    summed by a plain reduction.  ``slots`` bounds the columns of one
    Gaussian: R^D for a binning with max_tiles_per_gaussian R, which caps
    every Gaussian's entries at R^D.  A Gaussian with more columns than
    ``slots`` (a state binned with a larger R) fails loudly rather than
    spilling into its neighbour's slots: a ValueError on the CPU, an
    asynchronous device-side assert (no host sync) on CUDA.  Columns with
    gid == P (sentinels) are dropped."""
    E = gid.shape[0]
    g_sorted, order = torch.sort(gid, stable=True)
    starts = torch.searchsorted(
        g_sorted, torch.arange(P + 1, dtype=g_sorted.dtype,
                               device=gid.device))
    g = g_sorted.long()
    pos = torch.arange(E, device=gid.device) - starts[g]
    fits = ~((g < P) & (pos >= slots)).any()
    if gid.is_cuda:
        torch._assert_async(fits)
    elif not bool(fits):
        raise ValueError(
            f"segment_sum_rows: a Gaussian has more than {slots} entries; "
            "the binning state was built with a larger "
            "max_tiles_per_gaussian than the config passed to the op")
    # Sentinel columns all land in one dump slot past the real ones.
    dest = torch.where(g < P, g * slots + pos, P * slots)
    out = rows.new_zeros((P * slots + 1, rows.shape[0]))
    out[dest] = rows.T[order]
    return out[:P * slots].view(P, slots, rows.shape[0]).sum(dim=1)


class _TiledForward(torch.autograd.Function):
    """(means, values, conics) -> packed (K*C, Np) outputs in tile-sorted
    sample order (kernels.tiled.tiled_forward); the backward runs
    kernels.tiled.tiled_backward on the (K*C, Np) cotangent as it arrives
    and segment-sums the per-entry rows by Gaussian id."""

    @staticmethod
    def forward(ctx, means, values, conics, orders, cfg, kernel_period,
                state, smp, ent_lo, ent_n):
        from ..kernels import tiled as ktiled

        D = means.shape[1]
        C = values.shape[1]
        gid, _, geom, _ = ktiled.prepare_entries(
            state, means, values, conics, ktiled.BLOCK_E, cfg=cfg)
        ctx.save_for_backward(geom, smp, gid)
        ctx.orders, ctx.kernel_period, ctx.state = orders, kernel_period, state
        ctx.P, ctx.D, ctx.C = means.shape[0], D, C
        ctx.slots = cfg.with_dims(D).max_tiles_per_gaussian ** D
        return ktiled.tiled_forward(orders, kernel_period, D, C, geom, smp,
                                    ent_lo, ent_n)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        from ..kernels import tiled as ktiled

        geom, smp, gid = ctx.saved_tensors
        D, C = ctx.D, ctx.C
        tri = tri_size(D)
        s_lo, s_n = ktiled.sample_ranges(ctx.state, geom.shape[1])
        dent = ktiled.tiled_backward(ctx.orders, ctx.kernel_period, D, C,
                                     geom, smp, grad.contiguous(), s_lo, s_n)
        # The mean rows are d/dmu' of the period-shifted means, and
        # dmu'/dmu = 1 (the image shift is piecewise constant).
        d = segment_sum_rows(dent, gid, ctx.P, ctx.slots)
        return (d[:, :D], d[:, D + tri:], d[:, D:D + tri],
                None, None, None, None, None, None, None)


def sample_tiled_multi(orders: Tuple[str, ...], cfg,
                       means, values, conics, samples, state,
                       *, sorted_outputs: bool = False,
                       unique_outputs: bool = False,
                       padded_outputs: bool = False,
                       unwrapped: bool = False):
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
    backward's slot bound R^D read it).  Gradients flow to (means, values,
    conics)."""
    from ..kernels import tiled as ktiled

    if os.environ.get("DGS_ABLATE"):
        raise NotImplementedError(
            "DGS_ABLATE is a TPU kernel-ablation hook of dgs_tpu; "
            "dgs_tpu_torch does not port it")
    N, D = samples.shape
    C = values.shape[1]
    if padded_outputs and not sorted_outputs:
        raise ValueError("padded_outputs requires sorted_outputs")
    orders = tuple(orders)
    kernel_period = None if unwrapped else cfg.period

    smp, _, Np = ktiled.prepare_samples(state, samples, ktiled.BLOCK_N)
    ent_lo, ent_n = ktiled.entry_ranges(state, Np)
    packed_t = _TiledForward.apply(means, values, conics, orders, cfg,
                                   kernel_period, state, smp, ent_lo, ent_n)

    if not padded_outputs:
        out = packed_t[:, :N].T            # (N, K*C)
        if not sorted_outputs:
            # Un-sort: sorted row r belongs to sample s_perm[r].
            inv = torch.empty(N, dtype=torch.long, device=samples.device)
            inv[state.s_perm.long()] = torch.arange(N, device=samples.device)
            out = out[inv]

    outs, k0 = [], 0
    for order in orders:
        nu = formulas.n_unique(order, D)
        if padded_outputs:
            outs.append(packed_t[k0 * C:(k0 + nu) * C, :].reshape(nu, C, -1))
            k0 += nu
            continue
        block = out[:, k0 * C:(k0 + nu) * C].reshape(N, nu, C)
        if unique_outputs:
            outs.append(block)
        else:
            fmap = formulas.full_to_unique(order, D)
            if len(fmap) != nu:
                block = block[:, torch.tensor(fmap, device=block.device), :]
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
