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

The kernel modes of dgs_tpu's kernels 1-2 that need wrap-free, tile-local
operands (``prepare_entries`` / ``prepare_samples`` with ``separable``):
the entry means become tile-local, ``separable_extend`` appends the rows
[u, b = C mu_l, the D a-coefficient groups], and the sample operand becomes
the monomial matrix [1, x_l, -w/2 x_i x_j, tile] (``sample_monomials``,
tile row last).  ``tiled_forward_sep`` (``csrc/tiled_forward_sep.cu``)
evaluates power and a = C X as TF32 tensor-core contractions of those rows
(3 passes, or 1 under ``fast_math_dots``: ``dot_passes``);
``tiled_backward_moments`` (``csrc/tiled_backward_moments.cu``) contracts
the per-pair VJP accumulators against the monomials into the rows of
``moment_layout``, which ``moment_combine`` folds into the per-entry
gradient rows.  A mode's other half is the classic kernel on the tile-local
operands (``base_rows`` / ``local_samples``), wrap-free.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..binning import grid as binning
from ..config import tri_size
from ..ops import formulas
from ..utils import profiling
from ._util import _pad_axis, _round_up

# Sorted samples per forward range: one warp of csrc/tiled_forward.cu owns
# them, a lane each, and is handed its own entry range (the wrapper checks
# the value against the built library).  Np is padded to a multiple.
BLOCK_N = 32
# Entries per backward range (one warp of csrc/tiled_backward.cu); the geom
# array's entry axis is padded to a multiple.
BLOCK_E = 32

ORDER_BITS = {"value": 1, "derivative": 2, "laplacian": 4, "third": 8}

# PSD-mask tolerance of the separable forward's contracted power
# (dgs_tpu/kernels/tiled.py PSD_TOL): absorbs the contraction's roundoff, so
# that the forward keeps the pairs that the backward's per-pair form keeps.
# Where the contracted power still exceeds it, the forward recomputes that
# pair's power per pair before applying it (tiled_forward_sep_plain).
PSD_TOL = 1e-5


def sep_rows(D: int) -> int:
    """Rows that separable_extend appends to the geom operand: u (1),
    b = C mu_l (D), and D a-coefficient groups [b_d, -c_d0..-c_dD-1]."""
    return 1 + D + D * (1 + D)


def mono_rows(D: int) -> int:
    """Rows of the per-sample monomial matrix: [1, x_l (D),
    -w_t/2 x_i x_j (tri)] with off-diagonal weight 2 (the tile row rides
    after them)."""
    return 1 + D + tri_size(D)


def dot_passes(cfg) -> int:
    """TF32 tensor-core passes of the separable forward's contraction: 3
    (hi*hi + hi*lo + lo*hi, fp32-class, the counterpart of dgs_tpu's
    Precision.HIGHEST) unless the documented fast-math knob
    ``fast_math_dots`` asks for 1 (hi*hi, the counterpart of
    Precision.DEFAULT: outside the fp32 gate)."""
    return 1 if getattr(cfg, "fast_math_dots", False) else 3


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
                    block_e: int, cfg=None, separable: bool = False,
                    folded=None, fold_meta=None, folded_vjp: bool = False):
    """Entry-ordered packed parameters, padded to a multiple of ``block_e``.

    Returns (gid (Ep,), tile (1, Ep), geom (1 + D + tri + C, Ep), Ep); with
    ``separable`` (the kernel modes: wrap-free configs only) the means are
    tile-local and geom carries separable_extend's sep_rows(D) rows after
    the values.  With ``folded`` (the orders of the folded modes, wrap-free
    only; ``fold_meta`` from formulas.folded_structure) the means are
    tile-local, geom carries the alpha rows after the values, and the
    result gains the fold and foldw operands (folded_geom): (gid, tile,
    geom, Ep, fold, foldw).
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
    if folded is not None:
        geom, fold, foldw = folded_geom(cfg.with_dims(D), ent, tile, D, C,
                                        folded, fold_meta, vjp=folded_vjp)
        return gid, tile, geom, Ep, fold, foldw
    if separable:
        ent = separable_extend(cfg.with_dims(D), ent, tile, D)
    geom = torch.cat([entry_tile_row(tile), ent.T], dim=0).contiguous()
    return gid, tile, geom, Ep


def prepare_samples(state: binning.BinningState, samples, block_n: int,
                    cfg=None, separable: bool = False,
                    folded_deg: Optional[int] = None):
    """Padded tile-sorted samples: returns (smp, s_tile (1, Np), Np).  smp
    is (D + 1, Np), the coordinates then the f32 sample tile row, or with
    ``separable`` the monomial operand (mono_rows(D) + 1, Np):
    sample_monomials' rows, then the tile row, or with ``folded_deg`` the
    folded modes' raw monomial operand (n_mono + 1, Np):
    sample_monomials_raw's rows to that degree, then the tile row.
    ``state`` needs only s_sorted and s_tile (a SampleBinning will do)."""
    N, D = samples.shape
    Np = _round_up(N, block_n)
    s_sorted = _pad_axis(state.s_sorted, 1, Np)
    pad = torch.arange(Np, device=samples.device)[None, :] >= N
    s_tile = torch.where(pad, 2 ** 30 + 1, _pad_axis(state.s_tile, 1, Np))
    if folded_deg is not None:
        head = sample_monomials_raw(cfg.with_dims(D), s_sorted, s_tile, D,
                                    folded_deg)
    else:
        head = (sample_monomials(cfg.with_dims(D), s_sorted, s_tile, D)
                if separable else s_sorted)
    smp = torch.cat([head, sample_tile_row(s_tile)], dim=0).contiguous()
    return smp, s_tile, Np


def separable_extend(cfg, ent, tile, D: int):
    """Tile-local separable rows: the mean columns of ``ent`` (columns
    [means, conics, ...rest]) become mu_l = mu' - tile centre, and the
    columns [u, b, acoef] are appended, so that
      power = u + b.x_l - 1/2 x_l^T C x_l = [u, b, c] . [1, x_l, q(x_l)]
      a_d   = b_d - (C x_l)_d            = [b_d, -c_d*] . [1, x_l]
    against sample_monomials' rows.  Exact only where X needs no torus
    wrap (unwrapped or open configs: the callers gate on that)."""
    from ..config import tri_index

    tri = tri_size(D)
    centers = binning.tile_centers(cfg, tile.reshape(-1), D)   # (Ep, D)
    mu_l = ent[:, :D] - centers
    conr = [ent[:, D + t] for t in range(tri)]
    b = [sum(conr[tri_index(D, d, m)] * mu_l[:, m] for m in range(D))
         for d in range(D)]
    u = -0.5 * sum(b[d] * mu_l[:, d] for d in range(D))
    acoef = []
    for d in range(D):
        acoef.append(b[d])
        acoef.extend(-conr[tri_index(D, d, m)] for m in range(D))
    extra = torch.stack([u] + b + acoef, dim=1)
    return torch.cat([mu_l, ent[:, D:], extra], dim=1)


def sample_monomials(cfg, s_coords, s_tile, D: int):
    """The per-sample monomial matrix (mono_rows(D), Np):
    [1, x_l, -w_t/2 x_l,i x_l,j] in tile-local coordinates (w_t = 1 on the
    diagonal, 2 off it); the x rows of columns with an out-of-grid
    (sentinel or pad) tile are zero, so every product stays finite."""
    T = binning.num_tiles(cfg, D)
    Np = s_coords.shape[1]
    centers = binning.tile_centers(cfg, s_tile.reshape(-1), D)  # (Np, D)
    valid = (s_tile.reshape(-1) < T)[None, :]
    xl = torch.where(valid, s_coords - centers.T, 0.0)          # (D, Np)
    q = [(-0.5 if i == j else -1.0) * (xl[i] * xl[j])
         for i in range(D) for j in range(i, D)]
    return torch.cat([torch.ones((1, Np), dtype=torch.float32,
                                 device=s_coords.device), xl,
                      torch.stack(q, dim=0)], dim=0)


def base_rows(geom, D: int, C: int):
    """The [tile, mean, conic, value] rows of a separable-extended geom (a
    contiguous view): the classic kernels' entry operand."""
    return geom[:1 + D + tri_size(D) + C]


def local_samples(mono, D: int):
    """(D + 1, Np) [x_l, tile] from the monomial operand: the classic
    kernels' sample operand in tile-local coordinates."""
    return torch.cat([mono[1:1 + D], mono[-1:]], dim=0)


def sample_monomials_raw(cfg, s_coords, s_tile, D: int, deg: int):
    """The folded modes' raw monomial matrix (n_mono, Np): rows follow
    formulas.monomials_upto(D, deg) ([1, x_l, x_i x_j, x_i x_j x_k] in
    tile-local coordinates); the x of columns with an out-of-grid tile is
    zero, so every product stays finite.  The degree-1 rows sit at 1..D:
    the kernels read tile-local x from them."""
    T = binning.num_tiles(cfg, D)
    Np = s_coords.shape[1]
    centers = binning.tile_centers(cfg, s_tile.reshape(-1), D)  # (Np, D)
    valid = (s_tile.reshape(-1) < T)[None, :]
    xl = torch.where(valid, s_coords - centers.T, 0.0)          # (D, Np)
    rows = []
    for e in formulas.monomials_upto(D, deg):
        r = torch.ones((Np,), dtype=torch.float32, device=s_coords.device)
        first = True
        for d, p in enumerate(e):
            for _ in range(p):
                r = xl[d] if first else r * xl[d]
                first = False
        rows.append(r)
    return torch.stack(rows, dim=0)


# Rows of the folded operands (fold, foldw, the beta-expanded cotangent)
# are padded to this multiple: the m16 tiles of the kernels' contractions.
FOLD_ROW_PAD = 16


def fold_rows(fold_meta, C: int):
    """(dense row count R, padded row count Rp) of the folded layout."""
    R = C * sum(len(m) for m in fold_meta)
    return R, _round_up(R, FOLD_ROW_PAD)


def fold_row_table(fold_meta, C: int):
    """(component k, basis-monomial index m) -> first (c = 0) row of the
    folded (k, m, c) row layout (fold, the beta-expanded cotangent, Zd)."""
    table, off = {}, 0
    for k, mrows in enumerate(fold_meta):
        for m in mrows:
            table[(k, m)] = off
            off += C
    return table


def build_folded(orders, D: int, C: int, ent_local, fold_meta,
                 vjp: bool = False):
    """Per-entry rows of the folded scheme (formulas.component_coeff_polys)
    from the (Ep, D + tri + C) entry parameters with tile-local means:
    (alpha (A, Ep), fold (Rp, Ep), foldw (D * Rp, Ep) or None).  alpha's
    rows are the component polynomials' monomial coefficients in
    fold_meta's (component-major, basis-ordered) order; fold[(k, m) * C + c]
    = values_c * alpha[(k, m)] (the forward's contraction operand); with
    ``vjp``, foldw[l * Rp + row (k, m, c)] = values_c * the W_l coefficient
    of (k, m) (formulas.w_coeff_polys).  Pad rows are zero."""
    tri = tri_size(D)
    Ep = ent_local.shape[0]
    mu = [ent_local[:, d] for d in range(D)]
    con = [ent_local[:, D + t] for t in range(tri)]
    values_t = ent_local[:, D + tri:D + tri + C].T       # (C, Ep)
    polys = formulas.component_coeff_polys(orders, D, mu, con)
    basis = formulas.monomials_upto(
        D, max(formulas.ORDER_DEGREE[o] for o in orders))
    R, Rp = fold_rows(fold_meta, C)

    def row(c):
        return (c if torch.is_tensor(c) else
                torch.full((Ep,), c, dtype=torch.float32,
                           device=ent_local.device))

    def fold_of(rows):      # (A, Ep) coefficients -> (Rp, Ep) folded rows
        a = torch.stack(rows, dim=0)
        return _pad_axis((a[:, None, :] * values_t[None, :, :])
                         .reshape(-1, Ep), 0, Rp)

    arows = [row(p[basis[m]]) for p, mrows in zip(polys, fold_meta)
             for m in mrows]
    alpha = torch.stack(arows, dim=0)
    fold = fold_of(arows)
    foldw = None
    if vjp:
        zero = torch.zeros((Ep,), dtype=torch.float32,
                           device=ent_local.device)
        wrows = []
        for wl in formulas.w_coeff_polys(orders, D, mu, con):
            wrows.append(fold_of([
                row(wl[(k, basis[m])]) if (k, basis[m]) in wl else zero
                for k, mrows in enumerate(fold_meta) for m in mrows]))
        foldw = torch.cat(wrows, dim=0)
    return alpha, fold.contiguous(), foldw


def folded_geom(cfg, ent, tile, D: int, C: int, orders, fold_meta,
                vjp: bool = False):
    """The folded modes' entry operands: geom (1 + D + tri + C + A, Ep),
    rows [tile, mu_l, conic, values, alpha], with tile-local means, and the
    fold and foldw arrays of build_folded."""
    centers = binning.tile_centers(cfg, tile.reshape(-1), D)   # (Ep, D)
    ent_local = torch.cat([ent[:, :D] - centers, ent[:, D:]], dim=1)
    alpha, fold, foldw = build_folded(orders, D, C, ent_local, fold_meta,
                                      vjp=vjp)
    geom = torch.cat([entry_tile_row(tile), ent_local.T, alpha], dim=0)
    return geom.contiguous(), fold, foldw


# Above this size the beta-expanded cotangent (R, Np) is not built and the
# backward runs the classic value gradients (dgs_tpu's gate).
CT_BETA_MAX_BYTES = 2_500_000_000


def fold_row_selectors(fold_meta, C: int):
    """(cotangent row, monomial row) of each folded row (k, m, c): the
    gather indices of the beta-expanded cotangent."""
    gsel, msel = [], []
    for k, mrows in enumerate(fold_meta):
        for m in mrows:
            for c in range(C):
                gsel.append(k * C + c)
                msel.append(m)
    return gsel, msel


def ct_beta_rows(fold_meta, C: int, g, mono):
    """The beta-expanded cotangent (Rp, Np) of the folded backward: row
    (k, m, c) = g[k * C + c] * monomial row m of ``mono``; pad rows zero.
    One row gather and one multiply."""
    gsel, msel = fold_row_selectors(fold_meta, C)
    R, Rp = fold_rows(fold_meta, C)
    gi = torch.tensor(gsel, dtype=torch.long, device=g.device)
    mi = torch.tensor(msel, dtype=torch.long, device=g.device)
    return _pad_axis(g[gi] * mono[mi], 0, Rp).contiguous()


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
    with torch.cuda.device(geom.device), \
            profiling.named_scope("dgs::kernel.tiled_fwd"):
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
                         chunk_blocks: int = 32, cb=None) -> torch.Tensor:
    """The plain torch version of the backward kernel: same inputs, same
    packed per-entry rows (D + tri + C, Ep): mean rows, conic rows, value
    rows, each summed over the entry's same-tile samples.  Works on
    ``chunk_blocks`` entry blocks at a time over their joint sample range,
    so it never holds more than one chunk's pairs.  With ``cb`` (the
    beta-expanded cotangent, ct_beta_rows; geom then carries the folded
    alpha rows) the value rows are the folded dvalues: Zd = cb G
    (torch.matmul, TF32 off), dvalues_c = sum_i alpha_i Zd[i * C + c]."""
    tri = tri_size(D)
    A = geom.shape[0] - (1 + D + tri + C) if cb is not None else 0
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
                if cb is None:
                    dvals = dvals + g_k @ (G if isinstance(p, float)
                                           else G * p)
                k += 1
        if cb is not None:
            dvals = _folded_dvalues(cb[:A * C, s0:s1], G, g, D, C)
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
    out = _tiled_backward_cuda(orders, period, D, C, geom, smp, ct, s_lo,
                               s_n)
    tiled_backward.launches += 1
    return out


tiled_backward.launches = 0


def _tiled_backward_cuda(orders, period, D, C, geom, smp, ct, s_lo, s_n,
                         passes=None):
    """Launch csrc/tiled_backward.cu's kernel (``passes`` None) or its
    h_matmul instantiation at ``passes`` TF32 passes."""
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
    args = (geom.data_ptr(), Ep, C, smp.data_ptr(), Np, ct.data_ptr(),
            s_lo.data_ptr(), s_n.data_ptr(), EB, D, mask,
            0 if period is None else 1,
            0.0 if period is None else float(period),
            rows["value"], rows["derivative"], rows["laplacian"],
            rows["third"])
    if passes is None:
        _run("tiled_backward", geom.device, lib.dgs_tiled_backward, *args,
             out.data_ptr())
    else:
        _run("tiled_backward_hmm", geom.device, lib.dgs_tiled_backward_hmm,
             *args, passes, out.data_ptr())
    return out.T


# ---------------------------------------------------------------------------
# Kernel modes: the separable forward and the moment-form backward
# ---------------------------------------------------------------------------


def _matmul_fp32(a, b):
    """a @ b in full fp32 on every device (TF32 off for the call on CUDA)."""
    if not a.is_cuda:
        return a @ b
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return a @ b
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _check_operands(kernel, checks):
    for name, t, dtype, shape, device in checks:
        if (t.device != device or t.dtype != dtype
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(
                f"{kernel}: {name} must be a contiguous {dtype} tensor of "
                f"shape {shape} on {device}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")


def _sep_power_rows(g, D: int, C: int):
    """The separable forward's contraction operands of an entry block g
    (geom columns): (power rows (mono_rows, E) = [u, b, c], [a_d rows
    (1 + D, E) = [b_d, -c_d*] for each d])."""
    tri = tri_size(D)
    MP = 1 + D
    NP0 = 1 + D + tri + C
    power = torch.cat([g[NP0:NP0 + MP], g[1 + D:1 + D + tri]], dim=0)
    acoef = [g[NP0 + MP * (1 + d):NP0 + MP * (2 + d)] for d in range(D)]
    return power, acoef


def tiled_forward_sep_plain(orders, D: int, C: int, geom, mono, ent_lo, ent_n,
                            chunk_blocks: int = 128) -> torch.Tensor:
    """The plain torch version of the separable forward: power and a = C X
    of every (entry, sample) pair as fp32 matrix products (torch.matmul,
    TF32 off) of the entry rows against the monomial rows; where that power
    exceeds PSD_TOL it is recomputed per pair (-1/2 X^T C X with
    X = mu_l - x_l), as the kernel does; then power > PSD_TOL -> 0, the
    same-tile mask, and the classic components and value contraction: the
    same (K*C, Np) output as tiled_forward."""
    tri = tri_size(D)
    MR, MP = mono_rows(D), 1 + D
    K = total_unique(orders, D)
    Np = mono.shape[1]
    out = torch.zeros((K * C, Np), dtype=torch.float32, device=mono.device)
    lo, hi, n = ent_lo.tolist(), (ent_lo + ent_n).tolist(), ent_n.tolist()
    for b0 in range(0, len(lo), chunk_blocks):
        blocks = [b for b in range(b0, min(b0 + chunk_blocks, len(lo)))
                  if n[b] > 0]
        if not blocks:
            continue
        e0 = min(lo[b] for b in blocks)
        e1 = max(hi[b] for b in blocks)
        s0, s1 = b0 * BLOCK_N, min((b0 + chunk_blocks) * BLOCK_N, Np)
        g = geom[:, e0:e1]
        x = mono[:, s0:s1]
        prow, acoef = _sep_power_rows(g, D, C)
        power = _matmul_fp32(x[:MR].T, prow)                    # (S, Ec)
        a = [_matmul_fp32(x[:MP].T, acoef[d]) for d in range(D)]
        con = [g[1 + D + t][None, :] for t in range(tri)]
        # Above PSD_TOL the contracted power is replaced by the per-pair one.
        Xs = [g[1 + d][None, :] - x[1 + d][:, None] for d in range(D)]
        pair = -0.5 * sum(r * X for r, X in zip(
            formulas.conic_apply(Xs, con, D), Xs))
        power = torch.where(power > PSD_TOL, pair, power)
        G = torch.where(power > PSD_TOL, 0.0,
                        torch.exp(torch.clamp(power, max=0.0)))
        G = G * (g[0][None, :] == x[MR][:, None]).to(G.dtype)
        vals = g[1 + D + tri:1 + D + tri + C].T                 # (Ec, C)
        rows = [_matmul_fp32(w, vals) for order in orders
                for w in formulas.components_unique(order, [None] * D, con,
                                                    G, a)]
        out[:, s0:s1] = torch.cat(rows, dim=1).T
    return out


def tiled_forward_sep(orders: Tuple[str, ...], D: int, C: int, geom, mono,
                      ent_lo, ent_n, passes: int = 3) -> torch.Tensor:
    """The separable forward (dgs_tpu's kernel 1, separable branch): packed
    (K*C, Np) fp32 outputs in tile-sorted sample order, as tiled_forward,
    from the separable-extended geom (prepare_entries with ``separable``)
    and the monomial operand (prepare_samples with ``separable``).  Pairs
    are wrap-free by construction.  ``passes`` (dot_passes) is the TF32
    passes of the kernel's power / a contraction: 3 (fp32-class) or 1
    (fast-math).  CUDA tensors launch csrc/tiled_forward_sep.cu (counted in
    ``tiled_forward_sep.launches``); CPU tensors run
    tiled_forward_sep_plain, which is exact fp32 whatever ``passes``."""
    _order_rows(orders, D)
    if passes not in (1, 3):
        raise ValueError(f"tiled_forward_sep: passes must be 1 or 3, got "
                         f"{passes}")
    if geom.device.type == "cpu":
        return tiled_forward_sep_plain(orders, D, C, geom, mono, ent_lo,
                                       ent_n)
    if geom.device.type != "cuda":
        raise ValueError(
            f"tiled_forward_sep: no kernel for device {geom.device}")
    from . import _build

    tri = tri_size(D)
    Np = mono.shape[1]
    NB = Np // BLOCK_N
    _check_operands("tiled_forward_sep", (
        ("geom", geom, torch.float32,
         (1 + D + tri + C + sep_rows(D), geom.shape[1]), geom.device),
        ("mono", mono, torch.float32, (mono_rows(D) + 1, NB * BLOCK_N),
         geom.device),
        ("ent_lo", ent_lo, torch.int32, (NB,), geom.device),
        ("ent_n", ent_n, torch.int32, (NB,), geom.device)))
    if not 1 <= D <= 3:
        raise ValueError(f"tiled_forward_sep: unsupported D={D}")
    mask, rows = _order_rows(orders, D)
    K = total_unique(orders, D)
    lib = _build.load()
    out = torch.empty((K * C, Np), dtype=torch.float32, device=geom.device)
    with torch.cuda.device(geom.device), \
            profiling.named_scope("dgs::kernel.tiled_fwd_sep"):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.dgs_tiled_forward_sep(
            geom.data_ptr(), geom.shape[1], C, mono.data_ptr(), Np,
            ent_lo.data_ptr(), ent_n.data_ptr(), NB, D, mask, passes,
            rows["value"], rows["derivative"], rows["laplacian"],
            rows["third"], out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(
            f"tiled_forward_sep: CUDA launch failed (cudaError {err})")
    tiled_forward_sep.launches += 1
    return out


tiled_forward_sep.launches = 0


def moment_layout(orders, D: int):
    """Static layout of the moment-form backward's rows: (has_w, has_hl,
    has_y, n_rows).  The kernel emits
      [M_S0 (1 + D + tri rows)] +
      [M_W_l (1 + D rows) for each l]   (with any of derivative, laplacian,
                                         third) +
      [M_hl_t (1 row) for each t]       (with the laplacian) +
      [M_Y_t (1 row) for each t]        (with the third order),
    then the C value-gradient rows; moment_combine folds them with the
    per-entry geometry into the (D + tri) parameter-gradient rows."""
    tri = tri_size(D)
    has_w = any(o in ("derivative", "laplacian", "third") for o in orders)
    has_hl = "laplacian" in orders
    has_y = "third" in orders
    n = ((1 + D + tri) + (D * (1 + D) if has_w else 0)
         + (tri if has_hl else 0) + (tri if has_y else 0))
    return has_w, has_hl, has_y, n


def tiled_backward_moments_plain(orders, D: int, C: int, geom, mono, ct,
                                 s_lo, s_n,
                                 chunk_blocks: int = 32) -> torch.Tensor:
    """The plain torch version of the moment-form backward: per pair G, a
    and the fused VJP accumulators (formulas.fused_pair_accumulators) from
    X = mu_l - x_l, then their G-weighted sums contracted against the
    sample monomials (torch.matmul, TF32 off) into moment_layout's rows,
    plus the C value-gradient rows: (n_rows + C, Ep), contiguous."""
    tri = tri_size(D)
    MP = 1 + D
    MR = mono_rows(D)
    Ep = geom.shape[1]
    has_w, has_hl, has_y, n_rows = moment_layout(orders, D)
    out = torch.zeros((n_rows + C, Ep), dtype=torch.float32,
                      device=geom.device)
    lo, hi, n = s_lo.tolist(), (s_lo + s_n).tolist(), s_n.tolist()
    for b0 in range(0, len(lo), chunk_blocks):
        blocks = [b for b in range(b0, min(b0 + chunk_blocks, len(lo)))
                  if n[b] > 0]
        if not blocks:
            continue
        s0 = min(lo[b] for b in blocks)
        s1 = max(hi[b] for b in blocks)
        e0, e1 = b0 * BLOCK_E, min((b0 + chunk_blocks) * BLOCK_E, Ep)
        g = geom[:, e0:e1]
        x = mono[:, s0:s1]
        Xs = [g[1 + d][None, :] - x[1 + d][:, None] for d in range(D)]
        con = [g[1 + D + t][None, :] for t in range(tri)]
        G, a = formulas.power_terms(Xs, con)
        G = G * (g[0][None, :] == x[MR][:, None]).to(G.dtype)
        vals = g[1 + D + tri:1 + D + tri + C]             # (C, Ec)
        gct = ct[:, s0:s1]                                # (K*C, S)
        hs, dvals, k = [], 0.0, 0
        lap_polys = third_polys = None
        for order in orders:
            polys = formulas.component_polys(order, Xs, con, a)
            if order == "laplacian":
                lap_polys = polys
            elif order == "third":
                third_polys = polys
            for p in polys:
                g_k = gct[k * C:(k + 1) * C]              # (C, S)
                hs.append(_matmul_fp32(g_k.T, vals))      # h_k (S, Ec)
                dvals = dvals + _matmul_fp32(
                    g_k, G if isinstance(p, float) else G * p)
                k += 1
        S0, w, hl, Y = formulas.fused_pair_accumulators(
            orders, con, a, hs, lap_polys, third_polys)

        def mom(V, r):
            return _matmul_fp32(x[:r], G * V)

        rows = [mom(S0, MR)]
        if has_w:
            rows += [torch.zeros((MP, e1 - e0), device=geom.device)
                     if w[l] is None else mom(w[l], MP) for l in range(D)]
        if has_hl:
            rows += [torch.zeros((1, e1 - e0), device=geom.device)
                     if hl[t] is None else mom(hl[t], 1) for t in range(tri)]
        if has_y:
            rows += [torch.zeros((1, e1 - e0), device=geom.device)
                     if Y[t] is None else mom(Y[t], 1) for t in range(tri)]
        out[:, e0:e1] = torch.cat(rows + [dvals], dim=0)
    return out


def tiled_backward_moments(orders: Tuple[str, ...], D: int, C: int, geom,
                           mono, ct, s_lo, s_n, passes: int = 3,
                           h_matmul: bool = False) -> torch.Tensor:
    """The moment-form backward (dgs_tpu's kernel 2, moment branch): for
    every tile-sorted entry the moment_layout rows and the C value-gradient
    rows, (n_rows + C, Ep) fp32, summed over the entry's same-tile samples;
    sentinel and pad entries come back zero.  ``geom`` is tile-local (its
    [tile, mean, conic, value] rows are read), ``mono`` the monomial
    operand, ``ct`` the (K*C, Np) cotangent.  The caller folds the rows
    with moment_combine, then segment-sums them by Gaussian id.  The
    M_S0 rows' contraction against the monomials runs on the tensor cores
    at 3 TF32 passes always (dgs_tpu pins it to HIGHEST under fast-math
    too); the rows against [1, x_l] only (M_W, M_hl, M_Y) are fp32 sums on
    the CUDA cores.  CUDA tensors launch
    csrc/tiled_backward_moments.cu, which writes entry-major rows (the
    result is the transpose view of an (Ep, n_rows + C) buffer; counted in
    ``tiled_backward_moments.launches``); CPU tensors run
    tiled_backward_moments_plain.  With ``h_matmul`` the kernel's h_k are
    tensor-core contractions over the channels at ``passes`` TF32 passes
    (dot_passes), as in tiled_backward_hmm."""
    _order_rows(orders, D)
    if geom.device.type == "cpu":
        return tiled_backward_moments_plain(orders, D, C, geom, mono, ct,
                                            s_lo, s_n)
    if geom.device.type != "cuda":
        raise ValueError(
            f"tiled_backward_moments: no kernel for device {geom.device}")
    from . import _build

    tri = tri_size(D)
    K = total_unique(orders, D)
    Ep, Np = geom.shape[1], mono.shape[1]
    EB = Ep // BLOCK_E
    if geom.shape[0] < 1 + D + tri + C:
        raise ValueError("tiled_backward_moments: geom has too few rows")
    _check_operands("tiled_backward_moments", (
        ("geom", geom, torch.float32, (geom.shape[0], EB * BLOCK_E),
         geom.device),
        ("mono", mono, torch.float32, (mono_rows(D) + 1, Np), geom.device),
        ("ct", ct, torch.float32, (K * C, Np), geom.device),
        ("s_lo", s_lo, torch.int32, (EB,), geom.device),
        ("s_n", s_n, torch.int32, (EB,), geom.device)))
    if not 1 <= D <= 3:
        raise ValueError(f"tiled_backward_moments: unsupported D={D}")
    mask, rows = _order_rows(orders, D)
    n_rows = moment_layout(orders, D)[3]
    lib = _build.load()
    if lib.dgs_tiled_backward_moments_rows(D, mask) != n_rows:
        raise RuntimeError("tiled_backward_moments: kernel library row "
                           "count differs from moment_layout")
    out = torch.empty((Ep, n_rows + C), dtype=torch.float32,
                      device=geom.device)
    args = (geom.data_ptr(), Ep, C, mono.data_ptr(), Np, ct.data_ptr(),
            s_lo.data_ptr(), s_n.data_ptr(), EB, D, mask, rows["value"],
            rows["derivative"], rows["laplacian"], rows["third"])
    if h_matmul:
        _run("tiled_backward_moments", geom.device,
             lib.dgs_tiled_backward_moments_hmm, *args, passes,
             out.data_ptr())
    else:
        _run("tiled_backward_moments", geom.device,
             lib.dgs_tiled_backward_moments, *args, out.data_ptr())
    tiled_backward_moments.launches += 1
    return out.T


tiled_backward_moments.launches = 0


def moment_combine(orders, D: int, C: int, dent, geom) -> torch.Tensor:
    """Fold the moment rows (dent[:n_rows]) with the per-entry tile-local
    geometry into the packed (D + tri + C, Ep) parameter-gradient rows: one
    elementwise pass over Ep in plain torch, outside the kernel, as in
    dgs_tpu.  With X = mu_l - x_l, z = W - X S0 / 2 and S* the moments of
    G S0 (the monomial q rows un-weighted by -2 on the diagonal and -1 off
    it into raw second moments):
      dmu_d  = sum_l C(d,l) (Wsum_l + Sx_l) - b_d S1
      dcon_t = expanded moments of G (X_v z_u + X_u z_v) - M[G hl_t]
               + M[G Y_t]."""
    from ..config import tri_index

    tri = tri_size(D)
    has_w, has_hl, has_y, n_rows = moment_layout(orders, D)
    MP = 1 + D
    mu = [geom[1 + d] for d in range(D)]
    Cc = lambda i, j: geom[1 + D + tri_index(D, i, j)]
    r = 0
    M_S0 = dent[r:r + MP + tri]
    r += MP + tri
    S1 = M_S0[0]
    Sx = [M_S0[1 + d] for d in range(D)]
    Sq = [None] * tri
    for u in range(D):
        for v in range(u, D):
            t = tri_index(D, u, v)
            Sq[t] = (-2.0 if u == v else -1.0) * M_S0[MP + t]
    Wsum = [None] * D
    Wx = [[None] * D for _ in range(D)]
    if has_w:
        for l in range(D):
            Wsum[l] = dent[r]
            for d in range(D):
                Wx[l][d] = dent[r + 1 + d]
            r += MP
    Mhl = [None] * tri
    if has_hl:
        for t in range(tri):
            Mhl[t] = dent[r]
            r += 1
    MY = [None] * tri
    if has_y:
        for t in range(tri):
            MY[t] = dent[r]
            r += 1
    dvals = dent[n_rows:]

    dmu = []
    for d in range(D):
        md = 0.0
        b_d = 0.0
        for l in range(D):
            term = Sx[l] if Wsum[l] is None else Wsum[l] + Sx[l]
            md = md + Cc(d, l) * term
            b_d = b_d + Cc(d, l) * mu[l]
        dmu.append(md - b_d * S1)
    dcon = []
    for u in range(D):
        for v in range(u, D):
            t = tri_index(D, u, v)
            if u == v:
                term = -0.5 * (mu[u] * mu[u] * S1 + Sq[t]) + mu[u] * Sx[u]
                if Wsum[u] is not None:
                    term = term + mu[u] * Wsum[u] - Wx[u][u]
            else:
                term = (mu[v] * Sx[u] + mu[u] * Sx[v]
                        - mu[u] * mu[v] * S1 - Sq[t])
                if Wsum[u] is not None:
                    term = term + mu[v] * Wsum[u] - Wx[u][v]
                if Wsum[v] is not None:
                    term = term + mu[u] * Wsum[v] - Wx[v][u]
            if Mhl[t] is not None:
                term = term - Mhl[t]
            if MY[t] is not None:
                term = term + MY[t]
            dcon.append(term)
    return torch.cat([torch.stack(dmu + dcon, dim=0), dvals], dim=0)


# ---------------------------------------------------------------------------
# Folded modes: the folded forward, the folded dvalues, the folded VJP, and
# h_matmul (h_k = g_k . values as a tensor-core contraction)
# ---------------------------------------------------------------------------


# The span of each kernel that _run launches: "dgs::kernel." and the
# kernel's name with forward / backward shortened to fwd / bwd.
_SPANS = {k: "dgs::kernel." + k.replace("forward", "fwd").replace(
    "backward", "bwd") for k in (
        "tiled_backward", "tiled_backward_hmm", "tiled_backward_moments",
        "tiled_forward_folded", "tiled_backward_fdv", "tiled_backward_fvjp")}


def _run(kernel: str, device, fn, *args):
    """Call the C entry ``fn`` with ``args`` and the current stream of
    ``device`` inside the kernel's span; raise on a launch error."""
    with torch.cuda.device(device), profiling.named_scope(_SPANS[kernel]):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed (cudaError {err})")


def _folded_dvalues(cbs, G, g, D: int, C: int):
    """dvalues (C, Ec) = sum_i alpha_i Zd[i * C + c] with Zd = cbs G, for an
    entry block g of a folded geom (alpha rows after the values)."""
    A = cbs.shape[0] // C
    a0 = 1 + D + tri_size(D) + C
    Zd = _matmul_fp32(cbs, G).reshape(A, C, -1)
    return (Zd * g[a0:a0 + A][:, None, :]).sum(dim=0)


def folded_degree(orders) -> int:
    """Degree of the folded modes' raw monomial operand: the orders' degree,
    at least 1.  The kernels read x_l from its degree-1 rows, which
    dgs_tpu's operand lacks for value-only orders (its folded forward then
    reads the tile row as x)."""
    return max(1, max(formulas.ORDER_DEGREE[o] for o in orders))


def folded_layout(orders, D: int, C: int):
    """(fold_meta, n_mono, R, Rp) of ``orders`` at C channels; n_mono is
    the monomial rows of the sample operand (folded_degree's basis: its
    tile row's index)."""
    meta = formulas.folded_structure(tuple(orders), D)[0]
    n_mono = len(formulas.monomials_upto(D, folded_degree(orders)))
    return (meta, n_mono) + fold_rows(meta, C)


_tables = {}


def _device_table(key, values, device):
    """An int32 table on ``device``, built once for ``key``."""
    k = (key, str(device))
    if k not in _tables:
        _tables[k] = torch.tensor(values, dtype=torch.int32, device=device)
    return _tables[k]


def tiled_forward_folded_plain(orders, D: int, C: int, geom, fold, mono,
                               ent_lo, ent_n,
                               chunk_blocks: int = 128) -> torch.Tensor:
    """The plain torch version of the folded forward: per block of samples
    and its joint entry range, G of every pair (X = mu_l - x_l, the
    same-tile mask), Z = fold G (torch.matmul, TF32 off), then
    out[(k, c)] = sum over m in meta_k of Z[(k, m, c)] * mono[m], as
    dgs_tpu's _compute_folded: the (K*C, Np) output of tiled_forward."""
    meta, n_mono, R, _ = folded_layout(orders, D, C)
    tri = tri_size(D)
    K = total_unique(orders, D)
    Np = mono.shape[1]
    out = torch.zeros((K * C, Np), dtype=torch.float32, device=mono.device)
    lo, hi, n = ent_lo.tolist(), (ent_lo + ent_n).tolist(), ent_n.tolist()
    for b0 in range(0, len(lo), chunk_blocks):
        blocks = [b for b in range(b0, min(b0 + chunk_blocks, len(lo)))
                  if n[b] > 0]
        if not blocks:
            continue
        e0 = min(lo[b] for b in blocks)
        e1 = max(hi[b] for b in blocks)
        s0, s1 = b0 * BLOCK_N, min((b0 + chunk_blocks) * BLOCK_N, Np)
        g = geom[:, e0:e1]
        x = mono[:, s0:s1]
        Xs = [g[1 + d][None, :] - x[1 + d][:, None] for d in range(D)]
        con = [g[1 + D + t][None, :] for t in range(tri)]
        G, _ = formulas.power_terms(Xs, con)
        G = G * (g[0][None, :] == x[n_mono][:, None]).to(G.dtype)
        Z = _matmul_fp32(fold[:R, e0:e1], G.T)             # (R, S)
        rows, off = [], 0
        for mrows in meta:
            acc = None
            for m in mrows:
                t = Z[off:off + C] if m == 0 else Z[off:off + C] * x[m]
                acc = t if acc is None else acc + t
                off += C
            rows.append(acc)
        out[:, s0:s1] = torch.cat(rows, dim=0)
    return out


def tiled_forward_folded(orders: Tuple[str, ...], D: int, C: int, geom,
                         fold, mono, ent_lo, ent_n,
                         passes: int = 3) -> torch.Tensor:
    """The folded forward (dgs_tpu's kernel 1, folded branch): packed
    (K*C, Np) fp32 outputs in tile-sorted sample order, as tiled_forward,
    from the folded geom and fold operands (prepare_entries with
    ``folded``) and the raw monomial operand (prepare_samples with
    ``folded_deg``).  The one contraction Z = fold G runs on the tensor
    cores at ``passes`` TF32 passes (dot_passes: 3, or 1 under fast-math).
    CUDA tensors launch csrc/tiled_forward_folded.cu (counted in
    ``tiled_forward_folded.launches``); CPU tensors run
    tiled_forward_folded_plain, exact fp32 whatever ``passes``."""
    _order_rows(orders, D)
    if passes not in (1, 3):
        raise ValueError(f"tiled_forward_folded: passes must be 1 or 3, "
                         f"got {passes}")
    if geom.device.type == "cpu":
        return tiled_forward_folded_plain(orders, D, C, geom, fold, mono,
                                          ent_lo, ent_n)
    if geom.device.type != "cuda":
        raise ValueError(
            f"tiled_forward_folded: no kernel for device {geom.device}")
    from . import _build

    meta, n_mono, R, Rp = folded_layout(orders, D, C)
    K = total_unique(orders, D)
    Ep, Np = geom.shape[1], mono.shape[1]
    NB = Np // BLOCK_N
    dev = geom.device
    _check_operands("tiled_forward_folded", (
        ("geom", geom, torch.float32, (geom.shape[0], Ep), dev),
        ("fold", fold, torch.float32, (Rp, Ep), dev),
        ("mono", mono, torch.float32, (n_mono + 1, NB * BLOCK_N), dev),
        ("ent_lo", ent_lo, torch.int32, (NB,), dev),
        ("ent_n", ent_n, torch.int32, (NB,), dev)))
    if not 1 <= D <= 3 or geom.shape[0] < 1 + D + tri_size(D):
        raise ValueError(f"tiled_forward_folded: unsupported D={D} or geom")
    # Row r = (k, m, c) of Z adds into output row k * C + c with monomial m.
    rowmap = _device_table(("fwd", meta, C), [
        (k * C + c) * 32 + m for k, mrows in enumerate(meta)
        for m in mrows for c in range(C)], dev)
    out = torch.empty((K * C, Np), dtype=torch.float32, device=dev)
    lib = _build.load()
    _run("tiled_forward_folded", dev, lib.dgs_tiled_forward_folded,
         geom.data_ptr(), Ep, fold.data_ptr(), Rp, R, mono.data_ptr(), Np,
         n_mono, ent_lo.data_ptr(), ent_n.data_ptr(), NB, D, K * C,
         rowmap.data_ptr(), passes, out.data_ptr())
    tiled_forward_folded.launches += 1
    return out


tiled_forward_folded.launches = 0


def tiled_backward_fdv(orders: Tuple[str, ...], D: int, C: int, geom, smp,
                       ct, cb, s_lo, s_n, passes: int = 3,
                       h_matmul: bool = False) -> torch.Tensor:
    """The folded-dvalues backward (dgs_tpu's kernel 2 under a folded
    forward with folded_dvals): the (D + tri + C, Ep) rows of
    tiled_backward, wrap-free, with the value rows dvalues_c =
    sum_i alpha_i Zd[i * C + c], Zd = cb G over the entry's samples (the
    tensor cores, ``passes`` TF32 passes) in place of the per-component
    value gradients; the mean and conic rows are the classic per-pair VJP
    (h_k from the (K*C, Np) cotangent ``ct``; with ``h_matmul`` as a
    tensor-core contraction over the channels).  ``geom`` is the folded
    geom, ``smp`` the (D + 1, Np) [x_l, tile] operand (local_samples),
    ``cb`` ct_beta_rows of ``ct``.  CUDA tensors launch the folded-dvalues
    kernel of csrc/tiled_backward_folded.cu (entry-major: the transpose
    view of an (Ep, D + tri + C) buffer; counted in
    ``tiled_backward_fdv.launches``); CPU tensors run tiled_backward_plain
    with ``cb``."""
    _order_rows(orders, D)
    if passes not in (1, 3):
        raise ValueError(f"tiled_backward_fdv: passes must be 1 or 3, got "
                         f"{passes}")
    if geom.device.type == "cpu":
        return tiled_backward_plain(orders, None, D, C, geom, smp, ct, s_lo,
                                    s_n, cb=cb)
    if geom.device.type != "cuda":
        raise ValueError(
            f"tiled_backward_fdv: no kernel for device {geom.device}")
    from . import _build

    meta, _, R, Rp = folded_layout(orders, D, C)
    tri = tri_size(D)
    K = total_unique(orders, D)
    Ep, Np = geom.shape[1], smp.shape[1]
    EB = Ep // BLOCK_E
    dev = geom.device
    A = R // C
    _check_operands("tiled_backward_fdv", (
        ("geom", geom, torch.float32, (1 + D + tri + C + A, EB * BLOCK_E),
         dev),
        ("smp", smp, torch.float32, (D + 1, Np), dev),
        ("ct", ct, torch.float32, (K * C, Np), dev),
        ("cb", cb, torch.float32, (Rp, Np), dev),
        ("s_lo", s_lo, torch.int32, (EB,), dev),
        ("s_n", s_n, torch.int32, (EB,), dev)))
    if not 1 <= D <= 3:
        raise ValueError(f"tiled_backward_fdv: unsupported D={D}")
    mask, rows = _order_rows(orders, D)
    out = torch.empty((Ep, D + tri + C), dtype=torch.float32, device=dev)
    lib = _build.load()
    _run("tiled_backward_fdv", dev, lib.dgs_tiled_backward_fdv,
         geom.data_ptr(), Ep, C, smp.data_ptr(), Np, ct.data_ptr(),
         cb.data_ptr(), Rp, R, s_lo.data_ptr(), s_n.data_ptr(), EB, D, mask,
         rows["value"], rows["derivative"], rows["laplacian"], rows["third"],
         passes, int(bool(h_matmul)), out.data_ptr())
    tiled_backward_fdv.launches += 1
    return out.T


tiled_backward_fdv.launches = 0


def fvjp_vz_groups(orders, D: int):
    """The alpha rows (groups (k, m) of the folded layout) whose
    value-weighted Zd sums vz_i = sum_c values_c Zd[i * C + c] the folded
    VJP's conic corrections read, in the order of its output rows: each
    laplacian component's constant monomial, then each third component's
    constant and degree-1 monomials."""
    meta, _ = formulas.folded_structure(tuple(orders), D)
    aidx, i = {}, 0
    for k, mrows in enumerate(meta):
        for m in mrows:
            aidx[(k, m)] = i
            i += 1
    cflat = formulas.comp_flat_index(orders, D)
    groups = []
    if "laplacian" in orders:
        groups += [aidx[(cflat[("laplacian", idx)], 0)]
                   for idx in formulas.sym_indices("laplacian", D)]
    if "third" in orders:
        for idx in formulas.sym_indices("third", D):
            k3 = cflat[("third", idx)]
            groups += [aidx[(k3, m)] for m in range(1 + D)]
    return groups


def tiled_backward_fvjp_plain(orders, D: int, C: int, geom, fold, foldw,
                              smp, cb, s_lo, s_n,
                              chunk_blocks: int = 32) -> torch.Tensor:
    """The plain torch version of the folded VJP, dgs_tpu's
    _compute_one_fvjp: per entry block and its joint sample range, G, a and
    X of every pair; Zd = cb G, S0 = cb^T fold and W_l = cb^T foldw_l
    (torch.matmul, TF32 off); the rows [dmu (D), dcon (tri), dvalues (C),
    vz (fvjp_vz_groups)] with
      dmu_d = sum_n G ((C W)_d - a_d S0),  z = W - X S0 / 2,
      dcon_uv = sum_n G (X_v z_u + X_u z_v),
      dvalues_c = sum_i alpha_i Zd[i * C + c],  vz_i = sum_c V_c Zd[i*C + c]:
    (D + tri + C + len(vz), Ep), contiguous.  fvjp_combine adds the conic
    corrections and drops the vz rows."""
    from ..config import tri_index

    meta, _, R, Rp = folded_layout(orders, D, C)
    tri = tri_size(D)
    groups = fvjp_vz_groups(orders, D)
    Ep = geom.shape[1]
    out = torch.zeros((D + tri + C + len(groups), Ep), dtype=torch.float32,
                      device=geom.device)
    lo, hi, n = s_lo.tolist(), (s_lo + s_n).tolist(), s_n.tolist()
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
        Xs = [g[1 + d][None, :] - x[d][:, None] for d in range(D)]
        con = [g[1 + D + t][None, :] for t in range(tri)]
        G, a = formulas.power_terms(Xs, con)
        G = G * (g[0][None, :] == x[D][:, None]).to(G.dtype)
        cbs = cb[:R, s0:s1]                                  # (R, S)
        Zd = _matmul_fp32(cbs, G).reshape(R // C, C, -1)     # (A, C, Ec)
        S0 = _matmul_fp32(cbs.T, fold[:R, e0:e1])            # (S, Ec)
        Ws = [_matmul_fp32(cbs.T, foldw[l * Rp:l * Rp + R, e0:e1])
              for l in range(D)]
        a0 = 1 + D + tri + C
        dvals = (Zd * g[a0:a0 + R // C][:, None, :]).sum(dim=0)
        vals = g[1 + D + tri:1 + D + tri + C]                # (C, Ec)
        vz = [(Zd[i] * vals).sum(dim=0) for i in groups]
        Cc = lambda i, j: con[tri_index(D, i, j)]
        dmu = [G * (sum(Cc(d, l) * Ws[l] for l in range(D)) - a[d] * S0)
               for d in range(D)]
        z = [Ws[l] - Xs[l] * (0.5 * S0) for l in range(D)]
        dcon = [G * (Xs[u] * z[u]) if u == v
                else G * (Xs[v] * z[u] + Xs[u] * z[v])
                for u in range(D) for v in range(u, D)]
        out[:D + tri, e0:e1] = torch.stack(
            [r.sum(dim=0) for r in dmu + dcon], dim=0)
        out[D + tri:, e0:e1] = torch.cat([dvals] + [r[None] for r in vz])
    return out


def tiled_backward_fvjp(orders: Tuple[str, ...], D: int, C: int, geom,
                        fold, foldw, smp, cb, s_lo, s_n,
                        passes: int = 3) -> torch.Tensor:
    """The fully folded backward (dgs_tpu's kernel 2, _compute_one_fvjp):
    for every tile-sorted entry the rows of tiled_backward_fvjp_plain,
    (D + tri + C + len(fvjp_vz_groups), Ep), from the folded geom, fold and
    foldw (prepare_entries with ``folded`` and ``folded_vjp``), the
    (D + 1, Np) [x_l, tile] operand and the beta-expanded cotangent ``cb``.
    Zd, S0 and W_l are tensor-core contractions at ``passes`` TF32 passes;
    no h chain is built.  fvjp_combine makes the (D + tri + C, Ep) gradient
    rows.  CUDA tensors launch csrc/tiled_backward_fvjp.cu (entry-major:
    the transpose view of an (Ep, rows) buffer; counted in
    ``tiled_backward_fvjp.launches``); CPU tensors run
    tiled_backward_fvjp_plain."""
    _order_rows(orders, D)
    if passes not in (1, 3):
        raise ValueError(f"tiled_backward_fvjp: passes must be 1 or 3, got "
                         f"{passes}")
    if geom.device.type == "cpu":
        return tiled_backward_fvjp_plain(orders, D, C, geom, fold, foldw,
                                         smp, cb, s_lo, s_n)
    if geom.device.type != "cuda":
        raise ValueError(
            f"tiled_backward_fvjp: no kernel for device {geom.device}")
    from . import _build

    meta, _, R, Rp = folded_layout(orders, D, C)
    tri = tri_size(D)
    A = R // C
    groups = fvjp_vz_groups(orders, D)
    Ep, Np = geom.shape[1], smp.shape[1]
    EB = Ep // BLOCK_E
    dev = geom.device
    _check_operands("tiled_backward_fvjp", (
        ("geom", geom, torch.float32, (1 + D + tri + C + A, EB * BLOCK_E),
         dev),
        ("fold", fold, torch.float32, (Rp, Ep), dev),
        ("foldw", foldw, torch.float32, (D * Rp, Ep), dev),
        ("smp", smp, torch.float32, (D + 1, Np), dev),
        ("cb", cb, torch.float32, (Rp, Np), dev),
        ("s_lo", s_lo, torch.int32, (EB,), dev),
        ("s_n", s_n, torch.int32, (EB,), dev)))
    if not 1 <= D <= 3:
        raise ValueError(f"tiled_backward_fvjp: unsupported D={D}")
    slot = [-1] * A
    for j, i in enumerate(groups):
        slot[i] = j
    sel = _device_table(("fvjp", meta), slot, dev)
    nout = D + tri + C + len(groups)
    out = torch.empty((Ep, nout), dtype=torch.float32, device=dev)
    lib = _build.load()
    _run("tiled_backward_fvjp", dev, lib.dgs_tiled_backward_fvjp,
         geom.data_ptr(), Ep, C, fold.data_ptr(), foldw.data_ptr(),
         cb.data_ptr(), Rp, R, smp.data_ptr(), Np, s_lo.data_ptr(),
         s_n.data_ptr(), EB, D, sel.data_ptr(), len(groups), passes,
         out.data_ptr())
    tiled_backward_fvjp.launches += 1
    return out.T


tiled_backward_fvjp.launches = 0


def fvjp_combine(orders, D: int, C: int, rows, geom) -> torch.Tensor:
    """The folded VJP's per-entry conic corrections, as dgs_tpu's
    _compute_one_fvjp adds them: from the vz rows of tiled_backward_fvjp
    (fvjp_vz_groups' order) and the entry's tile-local geometry,
      laplacian (u, v):  dcon_t -= vz(lap_uv, 1)
      third (i, j, k), each of (u, v, w) in ((i,j,k), (i,k,j), (j,k,i)):
        dcon_(u,v) += b_w vz(third, 1) - sum_l C_wl vz(third, x_l),
    b = C mu_l; returns the packed (D + tri + C, Ep) gradient rows.  One
    elementwise pass over Ep in plain torch, outside the kernel (as
    moment_combine)."""
    from ..config import tri_index

    tri = tri_size(D)
    mu = [geom[1 + d] for d in range(D)]
    Cc = lambda i, j: geom[1 + D + tri_index(D, i, j)]
    dcon = [rows[D + t] for t in range(tri)]
    r = D + tri + C
    if "laplacian" in orders:
        for (u, v) in formulas.sym_indices("laplacian", D):
            t = tri_index(D, u, v)
            dcon[t] = dcon[t] - rows[r]
            r += 1
    if "third" in orders:
        b = [sum(Cc(w, l) * mu[l] for l in range(D)) for w in range(D)]
        for (i, j, k) in formulas.sym_indices("third", D):
            vz0, vzl = rows[r], rows[r + 1:r + 1 + D]
            for (u, v, w) in ((i, j, k), (i, k, j), (j, k, i)):
                t = tri_index(D, u, v)
                term = b[w] * vz0
                for l in range(D):
                    term = term - Cc(w, l) * vzl[l]
                dcon[t] = dcon[t] + term
            r += 1 + D
    return torch.cat([rows[:D], torch.stack(dcon, dim=0),
                      rows[D + tri:D + tri + C]], dim=0)


def tiled_backward_hmm(orders: Tuple[str, ...], period: Optional[float],
                       D: int, C: int, geom, smp, ct, s_lo, s_n,
                       passes: int = 3) -> torch.Tensor:
    """tiled_backward under ``h_matmul``: the same rows, with each pair
    block's h_k = g_k . values a TF32 tensor-core contraction over the
    channels (``passes`` 3, or 1 under fast-math) in place of the C
    broadcast FMAs.  CUDA tensors launch csrc/tiled_backward_hmm.cu (counted
    in ``tiled_backward_hmm.launches``); CPU tensors run
    tiled_backward_plain (h is the same function)."""
    _order_rows(orders, D)
    if passes not in (1, 3):
        raise ValueError(f"tiled_backward_hmm: passes must be 1 or 3, got "
                         f"{passes}")
    if geom.device.type == "cpu":
        return tiled_backward_plain(orders, period, D, C, geom, smp, ct,
                                    s_lo, s_n)
    if geom.device.type != "cuda":
        raise ValueError(
            f"tiled_backward_hmm: no kernel for device {geom.device}")
    out = _tiled_backward_cuda(orders, period, D, C, geom, smp, ct, s_lo,
                               s_n, passes=passes)
    tiled_backward_hmm.launches += 1
    return out


tiled_backward_hmm.launches = 0
