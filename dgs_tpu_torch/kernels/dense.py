"""The all-pairs (dense) forward and backward kernels.

The counterpart of ``dgs_tpu/kernels/dense.py``: every sample against every
Gaussian, with no binning, no 3-sigma cut and no capacity, the torus wrap
applied per pair (``period`` or None for an open domain).  This is the exact
evaluation every binned path is judged against.

``dense_forward`` and ``dense_backward`` are the wrappers and keep the JAX
signatures: K per-component (N, C) tensors out of the forward (K = sum of
D^order over the orders, symmetric positions duplicated), K per-component
cotangents into the backward.  A CUDA tensor launches the hand-written
Hopper kernel (``dgs_tpu_torch/csrc/dense_forward.cu`` /
``dense_backward.cu``); a CPU tensor runs ``dense_forward_plain`` /
``dense_backward_plain``, the same function in plain torch.  Below the
signature the CUDA kernels work on the unique (canonical-index) components
in canonical order: the wrapper mirrors the forward's rows into the K
tensors and adds mirrored cotangents into their unique row before the
backward (exact, since every per-component VJP term is symmetric in the
component's indices).  Both kernels split their reduction axis over a
second grid dimension so that small problems still fill the card; the
partials are added by a plain sum over the small leading axis, in a fixed
order, so the backward uses no atomics and two runs agree bitwise.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from ..config import ORDERS, n_components, tri_size
from ..ops import formulas
from ..utils import profiling
from ._util import _pad_axis, _round_up
from .tiled import ORDER_BITS

# Samples per forward CUDA block and Gaussians per backward CUDA block
# (kBlock of csrc/dense_forward.cu / dense_backward.cu, which the wrappers
# check against the built library), and the Gaussians / samples each stages
# per shared-memory chunk (their kChunk; a split is a whole number of
# chunks).
BLOCK_N, FWD_CHUNK = 128, 256
BLOCK_P, BWD_CHUNK = 128, 128
# Blocks to aim for before the reduction axis stops being split: 32 per
# streaming multiprocessor of the H100's 132.  The blocks of a launch run in
# waves of the blocks the card holds at once (2 to 4 an SM at the dense
# kernels' registers); a launch of w waves loses up to 1 / ceil(w) of its
# time to the last, partly filled wave, so the target is at least 8 waves
# (dense config 2: 782 x 1 forward and 79 x 7 backward blocks were 1.5 and
# 1.05 waves at 4 blocks an SM).  The partials it adds are small against
# the pair work.  A constant and not a query of the card, so that the split,
# and with it the order of every sum, depends on the shapes alone; on a part
# with another SM count it is a tuning that no longer fits, not an error.
TARGET_BLOCKS = 32 * 132
# Pairs one chunk of the plain versions holds at a time.
PLAIN_PAIRS = 1 << 24


def total_components(orders: Tuple[str, ...], D: int) -> int:
    return sum(n_components(o, D) for o in orders)


def _canonical(orders, D: int):
    """(order-set bit mask, K_u, {order: first unique row in the kernels'
    canonical component order})."""
    if len(set(orders)) != len(orders):
        raise ValueError(f"repeated order in {orders!r}")
    for o in orders:
        if o not in ORDER_BITS:
            raise ValueError(f"unknown order {o!r}")
    mask = sum(ORDER_BITS[o] for o in orders)
    base, k = {}, 0
    for o in ORDERS:
        if o in orders:
            base[o] = k
            k += formulas.n_unique(o, D)
    return mask, k, base


def _unique_rows(orders, D: int) -> List[int]:
    """For each of the K full components, in the caller's order sequence,
    its row among the kernels' canonical unique components."""
    _, _, base = _canonical(orders, D)
    return [base[o] + u for o in orders for u in formulas.full_to_unique(o, D)]


def split_plan(n_blocks: int, length: int, chunk: int) -> Tuple[int, int]:
    """(splits, per_split) for a reduction axis of ``length`` swept in
    chunks of ``chunk`` by ``n_blocks`` blocks: enough splits to reach
    TARGET_BLOCKS (sized for the H100's 132 SMs), each a whole number of
    chunks.  A function of the shapes only, never of the card."""
    chunks = -(-length // chunk)
    splits = max(1, min(-(-TARGET_BLOCKS // n_blocks), chunks))
    per_split = -(-chunks // splits) * chunk
    return -(-length // per_split), per_split


def _plain_chunk(P: int, N: int) -> int:
    return max(1, min(N, PLAIN_PAIRS // max(P, 1)))


def dense_forward_plain(orders, period: Optional[float], means, values,
                        conics, samples) -> List[torch.Tensor]:
    """The plain torch version of the forward kernel: same inputs, the same
    K (N, C) tensors, every full component computed from the closed forms
    (no mirror).  Works on chunks of samples, so it never holds more than
    PLAIN_PAIRS pairs at a time."""
    N, D = samples.shape
    P = means.shape[0]
    S = _plain_chunk(P, N)
    parts = []
    for s0 in range(0, N, S):
        Xs, con, G, a = formulas.pairwise_context(
            means, conics, samples[s0:s0 + S], period)
        parts.append([w @ values for order in orders
                      for w in formulas.components(order, Xs, con, G, a)])
    return [torch.cat(col, dim=0) for col in zip(*parts)]


def dense_forward(orders: Tuple[str, ...], period: Optional[float],
                  means, values, conics, samples) -> List[torch.Tensor]:
    """One (N, C) fp32 tensor per evaluation component (K in all), the
    components of ``orders`` in sequence, row-major over tensor indices.

    means (P, D), values (P, C), conics (P, tri), samples (N, D).  CUDA
    tensors launch the CUDA kernel (counted in ``dense_forward.launches``);
    CPU tensors run dense_forward_plain.

    Read-only results: on CUDA the K tensors are views into one
    (N, K_u, C) buffer and mirrored components share memory, so a write in
    place to one would change its mirror.  Clone before writing."""
    _canonical(orders, samples.shape[1])   # rejects unknown, repeated orders
    if means.device.type == "cpu":
        return dense_forward_plain(orders, period, means, values, conics,
                                   samples)
    if means.device.type != "cuda":
        raise ValueError(f"dense_forward: no kernel for device {means.device}")
    return _dense_forward_cuda(orders, period, means, values, conics, samples)


dense_forward.launches = 0


def _check_operands(name, means, values, conics, samples):
    """Shapes, dtype and device of the four operands; returns (N, P, D, C)."""
    N, D = samples.shape
    P, C = values.shape
    if not 1 <= D <= 3:
        raise ValueError(f"{name}: unsupported D={D}")
    if N < 1 or P < 1 or C < 1:
        raise ValueError(f"{name}: empty operand (N={N}, P={P}, C={C})")
    want = (("means", means, (P, D)), ("values", values, (P, C)),
            ("conics", conics, (P, tri_size(D))), ("samples", samples, (N, D)))
    for arg, t, shape in want:
        if (t.device != means.device or t.dtype != torch.float32
                or tuple(t.shape) != shape):
            raise ValueError(
                f"{name}: {arg} must be a float32 tensor of shape {shape} on "
                f"{means.device}, got {t.dtype} {tuple(t.shape)} on "
                f"{t.device}")
    return N, P, D, C


def _dense_forward_cuda(orders, period, means, values, conics, samples):
    from . import _build

    N, P, D, C = _check_operands("dense_forward", means, values, conics,
                                 samples)
    mask, K_u, _ = _canonical(orders, D)
    lib = _build.load()
    if lib.dgs_dense_forward_block() != BLOCK_N:
        raise RuntimeError("dense_forward: kernel library block size differs "
                           "from kernels.dense.BLOCK_N")
    geom = torch.cat([means, conics, values], dim=1).T.contiguous()
    smp = samples.T.contiguous()
    splits, per_split = split_plan(-(-N // BLOCK_N), P, FWD_CHUNK)
    out = torch.empty((splits, K_u * C, N), dtype=torch.float32,
                      device=means.device)
    with torch.cuda.device(means.device), \
            profiling.named_scope("dgs::kernel.dense_fwd"):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.dgs_dense_forward(
            geom.data_ptr(), P, C, smp.data_ptr(), N, D, mask, splits,
            per_split, 0 if period is None else 1,
            0.0 if period is None else float(period), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(
            f"dense_forward: CUDA launch failed (cudaError {err})")
    dense_forward.launches += 1
    packed = out[0] if splits == 1 else out.sum(dim=0)
    comps = packed.T.reshape(N, K_u, C)
    return [comps[:, u, :] for u in _unique_rows(orders, D)]


def dense_backward_plain(orders, period: Optional[float], means, values,
                         conics, samples, gs: Sequence[torch.Tensor]):
    """The plain torch version of the backward kernel: same inputs, the
    same (dmeans, dvalues, dconics), from the K full-component cotangents
    and the per-order closed-form VJP (formulas.vjp_params).  Works on
    chunks of samples, so it never holds more than PLAIN_PAIRS pairs at a
    time."""
    N, D = samples.shape
    P = means.shape[0]
    d_means = torch.zeros_like(means)
    d_values = torch.zeros_like(values)
    d_conics = torch.zeros_like(conics)
    S = _plain_chunk(P, N)
    for s0 in range(0, N, S):
        Xs, con, G, a = formulas.pairwise_context(
            means, conics, samples[s0:s0 + S], period)
        k0 = 0
        for order in orders:
            nk = n_components(order, D)
            comps = formulas.components(order, Xs, con, G, a)
            hs = []
            for k in range(nk):
                g_k = gs[k0 + k][s0:s0 + S]                # (S, C)
                d_values += comps[k].T @ g_k
                hs.append(g_k @ values.T)                  # h_k (S, P)
            dmu, dcon = formulas.vjp_params(order, Xs, con, G, a, hs)
            d_means += torch.stack([m.sum(dim=0) for m in dmu], dim=-1)
            d_conics += torch.stack([c.sum(dim=0) for c in dcon], dim=-1)
            k0 += nk
    return d_means, d_values, d_conics


def dense_backward(orders: Tuple[str, ...], period: Optional[float],
                   means, values, conics, samples,
                   gs: Sequence[torch.Tensor]):
    """(dmeans (P, D), dvalues (P, C), dconics (P, tri)) from the K
    per-component (N, C) cotangents of dense_forward's outputs.  A
    fixed-order reduction over the samples: deterministic, no atomics.
    CUDA tensors launch the CUDA kernel (counted in
    ``dense_backward.launches``); CPU tensors run dense_backward_plain."""
    D = samples.shape[1]
    _canonical(orders, D)   # rejects unknown and repeated orders
    if len(gs) != total_components(orders, D):
        raise ValueError(
            f"dense_backward: {len(gs)} cotangents for "
            f"{total_components(orders, D)} components of {orders!r}")
    if means.device.type == "cpu":
        return dense_backward_plain(orders, period, means, values, conics,
                                    samples, gs)
    if means.device.type != "cuda":
        raise ValueError(
            f"dense_backward: no kernel for device {means.device}")
    return _dense_backward_cuda(orders, period, means, values, conics,
                                samples, gs)


dense_backward.launches = 0


def fold_cotangents(orders, D: int, gs: Sequence[torch.Tensor]):
    """The lane-major (K_u * C, N) cotangent of the unique components in
    canonical order: each unique row is the sum, in component order, of the
    cotangents of the full components that mirror it."""
    _, K_u, _ = _canonical(orders, D)
    rows = [None] * K_u
    for g, u in zip(gs, _unique_rows(orders, D)):
        rows[u] = g if rows[u] is None else rows[u] + g
    N, C = gs[0].shape
    return torch.stack(rows, dim=0).permute(0, 2, 1).reshape(K_u * C, N)


def _dense_backward_cuda(orders, period, means, values, conics, samples, gs):
    from . import _build

    N, P, D, C = _check_operands("dense_backward", means, values, conics,
                                 samples)
    for k, g in enumerate(gs):
        if (g.device != means.device or g.dtype != torch.float32
                or tuple(g.shape) != (N, C)):
            raise ValueError(
                f"dense_backward: cotangent {k} must be a float32 tensor of "
                f"shape {(N, C)} on {means.device}, got {g.dtype} "
                f"{tuple(g.shape)} on {g.device}")
    mask, K_u, _ = _canonical(orders, D)
    tri = tri_size(D)
    lib = _build.load()
    if lib.dgs_dense_backward_block() != BLOCK_P:
        raise RuntimeError("dense_backward: kernel library block size "
                           "differs from kernels.dense.BLOCK_P")
    Pp = _round_up(P, BLOCK_P)
    # Pad Gaussians are all zeros: their rows are computed and dropped.
    geom = _pad_axis(torch.cat([means, conics, values], dim=1).T, 1,
                     Pp).contiguous()
    smp = samples.T.contiguous()
    ct = fold_cotangents(orders, D, gs).contiguous()
    splits, per_split = split_plan(Pp // BLOCK_P, N, BWD_CHUNK)
    out = torch.empty((splits, D + tri + C, Pp), dtype=torch.float32,
                      device=means.device)
    with torch.cuda.device(means.device), \
            profiling.named_scope("dgs::kernel.dense_bwd"):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.dgs_dense_backward(
            geom.data_ptr(), Pp, C, smp.data_ptr(), N, ct.data_ptr(), D,
            mask, splits, per_split, 0 if period is None else 1,
            0.0 if period is None else float(period), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(
            f"dense_backward: CUDA launch failed (cudaError {err})")
    dense_backward.launches += 1
    rows = (out[0] if splits == 1 else out.sum(dim=0))[:, :P].T
    return (rows[:, :D].contiguous(), rows[:, D + tri:].contiguous(),
            rows[:, D:D + tri].contiguous())
