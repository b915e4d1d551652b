"""The tiled forward and backward kernels and their operands.

The counterpart of ``dgs_tpu/kernels/tiled.py``.  The operands keep the JAX
package's packing: per-entry parameters ride one ``geom`` array
(1 + D + tri + C, Ep) whose row 0 is the entry's tile id as f32 (pad slots
-1.0), followed by the period-shifted mean rows, the conic rows and the
value rows; tile-sorted samples ride one (D + 1, Np) array, coordinates then
the f32 tile row (pad columns -2.0, so pads never pair).

``tiled_forward`` and ``tiled_backward`` are the wrappers: a CUDA tensor
launches the hand-written Hopper kernel (``dgs_tpu_torch/csrc/
tiled_forward.cu`` / ``tiled_backward.cu``), a CPU tensor runs
``tiled_forward_plain`` / ``tiled_backward_plain``, the same function in
plain torch.  The TPU kernels walked static work lists of (sample block x
entry block) items.  The CUDA kernels give every warp 32 consecutive
tile-sorted rows, a lane each, and the contiguous range of the other side
that those rows' tiles cover (``entry_ranges`` / ``sample_ranges``, one
range per ``BLOCK_N`` = 32 sorted samples or ``BLOCK_E`` = 32 entries): the
warp stages its range through its own slice of shared memory as 16-byte
records (``csrc/tiled_layout.cuh``) and sweeps it, a lane keeping the rows
of its own tile; where the warp's rows share a tile, which is the rule, the
range is exactly that tile's rows and nothing swept is dropped.  Any range
that covers the rows' tiles gives the same result, as in the plain versions.
No work list is built and no work capacity can overflow.
The kernels run over the value channels in passes of 1, 2 or 4 (chosen from
C), and wrap the torus by a multiplication where the period is a power of
two (bitwise equal to the division), else by the division.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..binning import grid as binning
from ..config import tri_size
from ..ops import formulas
from ._util import _pad_axis, _round_up

# Sorted samples per forward range: one warp of csrc/tiled_forward.cu owns
# them, a lane each, and is handed its own entry range (the wrapper checks
# the value against the built library).  Np is padded to a multiple.
BLOCK_N = 32
# Entries per backward range (one warp of csrc/tiled_backward.cu); the geom
# array's entry axis is padded to a multiple.
BLOCK_E = 32

ORDER_BITS = {"value": 1, "derivative": 2, "laplacian": 4, "third": 8}


def total_unique(orders, D: int) -> int:
    """Unique (canonical) components across the fused orders."""
    return sum(formulas.n_unique(o, D) for o in orders)


def entry_tile_row(tile) -> torch.Tensor:
    """(1, E) f32 entry tile row: tile ids pass through exactly (< 2^24),
    pad slots (tile >= 2^30) become -1.0."""
    t = tile.reshape(1, -1)
    return torch.where(t >= 2 ** 30, -1.0, t.to(torch.float32))


def sample_tile_row(tile) -> torch.Tensor:
    """(1, N) f32 sample tile row (pads -> -2.0)."""
    t = tile.reshape(1, -1)
    return torch.where(t >= 2 ** 30, -2.0, t.to(torch.float32))


def prepare_entries(state: binning.BinningState, means, values, conics,
                    block_e: int, cfg=None):
    """Entry-ordered packed parameters, padded to a multiple of ``block_e``.

    Returns (gid (Ep,), tile (1, Ep), geom (1 + D + tri + C, Ep), Ep).
    On a periodic domain each entry's mean is shifted to the periodic image
    its tile sees (mu' = mu - period * k, k from image_shift), so X = mu' - x
    is the minimum-image displacement for every pair the binning makes:
    that is what lets the unwrapped kernels drop the per-pair wrap.
    Sentinel entries (gid == P) read an appended zero row."""
    P, D = means.shape
    C = values.shape[1]
    tri = tri_size(D)
    E = state.num_entries
    Ep = _round_up(E, block_e)
    pad = torch.arange(Ep, device=means.device) >= E

    gid = torch.where(pad, P, _pad_axis(state.ent_gid, 0, Ep))
    tile = torch.where(pad[None, :], 2 ** 30, _pad_axis(state.ent_tile, 1, Ep))

    period = None if cfg is None else cfg.period
    params = torch.cat([means, conics, values], dim=1)  # (P, NPARAM)
    if period is not None:
        lo, _ = binning.gaussian_rects(cfg.with_dims(D), means.detach(),
                                       state.radii)
        params = torch.cat([params, lo.to(params.dtype)], dim=1)
    params = torch.cat([params, params.new_zeros((1, params.shape[1]))], 0)
    ent = params[gid.long()]      # (Ep, NPARAM[+D]): one row gather
    if period is not None:
        k = binning.image_shift(cfg.with_dims(D), tile, ent[:, D + tri + C:])
        ent = torch.cat([ent[:, :D] + (-period * k.to(ent.dtype)),
                         ent[:, D:D + tri + C]], dim=1)
    geom = torch.cat([entry_tile_row(tile), ent.T], dim=0).contiguous()
    return gid, tile, geom, Ep


def prepare_samples(state: binning.BinningState, samples, block_n: int):
    """Padded tile-sorted samples: returns (smp (D + 1, Np), s_tile (1, Np),
    Np), where the last row of smp is the f32 sample tile row."""
    N, D = samples.shape
    Np = _round_up(N, block_n)
    s_sorted = _pad_axis(state.s_sorted, 1, Np)
    pad = torch.arange(Np, device=samples.device)[None, :] >= N
    s_tile = torch.where(pad, 2 ** 30 + 1, _pad_axis(state.s_tile, 1, Np))
    smp = torch.cat([s_sorted, sample_tile_row(s_tile)], dim=0).contiguous()
    return smp, s_tile, Np


def entry_ranges(state: binning.BinningState, Np: int):
    """(ent_lo, ent_n) int32 of length Np // BLOCK_N: the entry range
    [ent_lo, ent_lo + ent_n) of each run of BLOCK_N sorted samples (the
    forward geometry at one-entry granularity; runs of pads get empty
    ranges).  Where a run's samples share a tile, the range is exactly that
    tile's entries."""
    lo, n = binning.forward_geometry(state, BLOCK_N, 1)
    NB = Np // BLOCK_N
    return _pad_axis(lo, 0, NB).contiguous(), _pad_axis(n, 0, NB).contiguous()


def sample_ranges(state: binning.BinningState, Ep: int):
    """(s_lo, s_n) int32 of length Ep // BLOCK_E: the sorted-sample range
    [s_lo, s_lo + s_n) of each run of BLOCK_E entries (the backward
    geometry at one-sample granularity; runs of sentinels and pads get
    empty ranges).  Where a run's entries share a tile, the range is exactly
    that tile's samples."""
    lo, n = binning.backward_geometry(state, BLOCK_E, 1)
    EB = Ep // BLOCK_E
    return _pad_axis(lo, 0, EB).contiguous(), _pad_axis(n, 0, EB).contiguous()


def _order_rows(orders, D: int):
    """(order-set bit mask, {order: first output component}, -1 for the
    orders not asked for)."""
    if len(set(orders)) != len(orders):
        raise ValueError(f"repeated order in {orders!r}")
    rows = {o: -1 for o in ORDER_BITS}
    mask, k = 0, 0
    for o in orders:
        if o not in ORDER_BITS:
            raise ValueError(f"unknown order {o!r}")
        mask |= ORDER_BITS[o]
        rows[o] = k
        k += formulas.n_unique(o, D)
    return mask, rows


def tiled_forward_plain(orders, period: Optional[float], D: int, C: int,
                        geom, smp, ent_lo, ent_n,
                        chunk_blocks: int = 128) -> torch.Tensor:
    """The plain torch version of the kernel: same inputs, same (K*C, Np)
    output.  Works on ``chunk_blocks`` sample blocks at a time over their
    joint entry range, so it never holds more than one chunk's pairs."""
    tri = tri_size(D)
    K = total_unique(orders, D)
    Np = smp.shape[1]
    out = torch.zeros((K * C, Np), dtype=torch.float32, device=smp.device)
    lo = ent_lo.tolist()
    hi = (ent_lo + ent_n).tolist()
    n = ent_n.tolist()
    for b0 in range(0, len(lo), chunk_blocks):
        blocks = [b for b in range(b0, min(b0 + chunk_blocks, len(lo)))
                  if n[b] > 0]
        if not blocks:
            continue
        e0 = min(lo[b] for b in blocks)
        e1 = max(hi[b] for b in blocks)
        s0, s1 = b0 * BLOCK_N, min((b0 + chunk_blocks) * BLOCK_N, Np)
        g = geom[:, e0:e1]
        x = smp[:, s0:s1]
        Xs = [formulas.wrap(g[1 + d][None, :] - x[d][:, None], period)
              for d in range(D)]                          # (S, Ec)
        con = [g[1 + D + t][None, :] for t in range(tri)]
        G, a = formulas.power_terms(Xs, con)
        G = G * (g[0][None, :] == x[D][:, None]).to(G.dtype)
        vals = g[1 + D + tri:1 + D + tri + C].T           # (Ec, C)
        rows = [w @ vals for order in orders
                for w in formulas.components_unique(order, Xs, con, G, a)]
        out[:, s0:s1] = torch.cat(rows, dim=1).T
    return out


def tiled_forward(orders: Tuple[str, ...], period: Optional[float],
                  D: int, C: int, geom, smp, ent_lo, ent_n) -> torch.Tensor:
    """Packed (K*C, Np) fp32 outputs in tile-sorted sample order.

    Rows [k*C, (k+1)*C) hold unique component k, the components of
    ``orders`` in sequence; pad columns are zero.  ``period`` is None for
    the unwrapped kernels (geom means already period-shifted) and on open
    domains.  CUDA tensors launch the CUDA kernel (and count the launch in
    ``tiled_forward.launches``); CPU tensors run tiled_forward_plain."""
    _order_rows(orders, D)   # rejects unknown and repeated orders
    if geom.device.type == "cpu":
        return tiled_forward_plain(orders, period, D, C, geom, smp,
                                   ent_lo, ent_n)
    if geom.device.type != "cuda":
        raise ValueError(f"tiled_forward: no kernel for device {geom.device}")
    return _tiled_forward_cuda(orders, period, D, C, geom, smp, ent_lo, ent_n)


tiled_forward.launches = 0


def _tiled_forward_cuda(orders, period, D, C, geom, smp, ent_lo, ent_n):
    from . import _build

    tri = tri_size(D)
    Np = smp.shape[1]
    NB = Np // BLOCK_N
    checks = (
        (geom, torch.float32, (1 + D + tri + C, geom.shape[1])),
        (smp, torch.float32, (D + 1, NB * BLOCK_N)),
        (ent_lo, torch.int32, (NB,)),
        (ent_n, torch.int32, (NB,)),
    )
    for name, (t, dtype, shape) in zip(("geom", "smp", "ent_lo", "ent_n"),
                                       checks):
        if (t.device != geom.device or t.dtype != dtype
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(
                f"tiled_forward: {name} must be a contiguous {dtype} tensor "
                f"of shape {shape} on {geom.device}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
    if not 1 <= D <= 3:
        raise ValueError(f"tiled_forward: unsupported D={D}")
    mask, rows = _order_rows(orders, D)
    K = total_unique(orders, D)
    lib = _build.load()
    if lib.dgs_tiled_forward_block() != BLOCK_N:
        raise RuntimeError("tiled_forward: kernel library range size differs "
                           "from kernels.tiled.BLOCK_N")
    out = torch.empty((K * C, Np), dtype=torch.float32, device=geom.device)
    with torch.cuda.device(geom.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.dgs_tiled_forward(
            geom.data_ptr(), geom.shape[1], C, smp.data_ptr(), Np,
            ent_lo.data_ptr(), ent_n.data_ptr(), NB, D, mask,
            0 if period is None else 1,
            0.0 if period is None else float(period),
            rows["value"], rows["derivative"], rows["laplacian"],
            rows["third"], out.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"tiled_forward: CUDA launch failed (cudaError {err})")
    tiled_forward.launches += 1
    return out


def tiled_backward_plain(orders, period: Optional[float], D: int, C: int,
                         geom, smp, ct, s_lo, s_n,
                         chunk_blocks: int = 32) -> torch.Tensor:
    """The plain torch version of the backward kernel: same inputs, same
    packed per-entry rows (D + tri + C, Ep): mean rows, conic rows, value
    rows, each summed over the entry's same-tile samples.  Works on
    ``chunk_blocks`` entry blocks at a time over their joint sample range,
    so it never holds more than one chunk's pairs."""
    tri = tri_size(D)
    Ep = geom.shape[1]
    out = torch.zeros((D + tri + C, Ep), dtype=torch.float32,
                      device=geom.device)
    lo = s_lo.tolist()
    hi = (s_lo + s_n).tolist()
    n = s_n.tolist()
    for b0 in range(0, len(lo), chunk_blocks):
        blocks = [b for b in range(b0, min(b0 + chunk_blocks, len(lo)))
                  if n[b] > 0]
        if not blocks:
            continue
        s0 = min(lo[b] for b in blocks)
        s1 = max(hi[b] for b in blocks)
        e0, e1 = b0 * BLOCK_E, min((b0 + chunk_blocks) * BLOCK_E, Ep)
        g = geom[:, e0:e1]
        x = smp[:, s0:s1]
        Xs = [formulas.wrap(g[1 + d][None, :] - x[d][:, None], period)
              for d in range(D)]                          # (S, Ec)
        con = [g[1 + D + t][None, :] for t in range(tri)]
        G, a = formulas.power_terms(Xs, con)
        G = G * (g[0][None, :] == x[D][:, None]).to(G.dtype)
        vals = g[1 + D + tri:1 + D + tri + C]             # (C, Ec)
        gct = ct[:, s0:s1]                                # (K*C, S)
        hs, dvals, k = [], 0.0, 0
        for order in orders:
            for p in formulas.component_polys(order, Xs, con, a):
                g_k = gct[k * C:(k + 1) * C]              # (C, S)
                hs.append(g_k.T @ vals)                   # h_k (S, Ec)
                dvals = dvals + g_k @ (G if isinstance(p, float) else G * p)
                k += 1
        dmu, dcon = formulas.vjp_params_fused(orders, Xs, con, G, a, hs)
        out[:D + tri, e0:e1] = torch.stack(
            [r.sum(dim=0) for r in dmu + dcon], dim=0)
        out[D + tri:, e0:e1] = dvals
    return out


def tiled_backward(orders: Tuple[str, ...], period: Optional[float],
                   D: int, C: int, geom, smp, ct, s_lo, s_n) -> torch.Tensor:
    """Packed per-entry gradients (D + tri + C, Ep) fp32: mean rows, conic
    rows, value rows, in the entry order of ``geom``; sentinel and pad
    entries come back zero.  The CUDA kernel writes them entry-major, so
    its result is the transpose view of an (Ep, D + tri + C) buffer (each
    entry's rows one contiguous record, what the segment-sum reads); the
    plain version's is contiguous.  ``ct`` is the lane-major (K*C, Np) cotangent
    of tiled_forward's output; ``period`` is None exactly when the forward
    ran unwrapped.  The caller segment-sums the rows by Gaussian id.  CUDA
    tensors launch the CUDA kernel (counted in
    ``tiled_backward.launches``); CPU tensors run tiled_backward_plain."""
    _order_rows(orders, D)   # rejects unknown and repeated orders
    if geom.device.type == "cpu":
        return tiled_backward_plain(orders, period, D, C, geom, smp, ct,
                                    s_lo, s_n)
    if geom.device.type != "cuda":
        raise ValueError(f"tiled_backward: no kernel for device {geom.device}")
    return _tiled_backward_cuda(orders, period, D, C, geom, smp, ct, s_lo,
                                s_n)


tiled_backward.launches = 0


def _tiled_backward_cuda(orders, period, D, C, geom, smp, ct, s_lo, s_n):
    from . import _build

    tri = tri_size(D)
    K = total_unique(orders, D)
    Ep, Np = geom.shape[1], smp.shape[1]
    EB = Ep // BLOCK_E
    checks = (
        ("geom", geom, torch.float32, (1 + D + tri + C, EB * BLOCK_E)),
        ("smp", smp, torch.float32, (D + 1, Np)),
        ("ct", ct, torch.float32, (K * C, Np)),
        ("s_lo", s_lo, torch.int32, (EB,)),
        ("s_n", s_n, torch.int32, (EB,)),
    )
    for name, t, dtype, shape in checks:
        if (t.device != geom.device or t.dtype != dtype
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(
                f"tiled_backward: {name} must be a contiguous {dtype} tensor "
                f"of shape {shape} on {geom.device}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
    if not 1 <= D <= 3:
        raise ValueError(f"tiled_backward: unsupported D={D}")
    mask, rows = _order_rows(orders, D)
    lib = _build.load()
    if lib.dgs_tiled_backward_block() != BLOCK_E:
        raise RuntimeError("tiled_backward: kernel library range size "
                           "differs from kernels.tiled.BLOCK_E")
    out = torch.empty((Ep, D + tri + C), dtype=torch.float32,
                      device=geom.device)
    with torch.cuda.device(geom.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.dgs_tiled_backward(
            geom.data_ptr(), Ep, C, smp.data_ptr(), Np, ct.data_ptr(),
            s_lo.data_ptr(), s_n.data_ptr(), EB, D, mask,
            0 if period is None else 1,
            0.0 if period is None else float(period),
            rows["value"], rows["derivative"], rows["laplacian"],
            rows["third"], out.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(
            f"tiled_backward: CUDA launch failed (cudaError {err})")
    tiled_backward.launches += 1
    return out.T
