"""The neighbour-aggregation kernels: totals, forward and backward.

The counterpart of ``dgs_tpu/kernels/aggregate.py``.  The operands keep the
JAX package's packing: per-entry geometry rides one ``ent_geo`` array
(D + tri + 1, Ep): the mean, shifted to the periodic image the entry's tile
sees, the packed conic and the shrunk collision radius (0 for pad and
sentinel entries); per-entry features and keys one ``ent_fk`` (L + K, Ep);
per-centre rows one ``ctr_geo`` (Cp, D + 3 + K): mean, shrunk radius,
inv_norm, inv_tot, then the K queries (``totals`` reads the first D + 1
columns only); the distance transform and the frequencies one ``dtf``
(1, 2E + nfreq).

The TPU kernels walk static work lists of same-tile (centre chunk x entry
chunk) items over chunk-padded sides.  Here both sides stay compact and
tile-sorted, and each row carries the range of the other side that lies on
its tile: ``ctr_ent`` (2, Cp) int32, the [lo, hi) entry range of each
centre, and ``ent_ctr`` (2, Ep) int32, the [lo, hi) centre range of each
entry (an empty range for pads).  A warp of the forward and backward
kernels takes a few consecutive rows and its lanes sweep their ranges
(``csrc/agg_sweep.cuh``), so no work list is built and no work capacity can
overflow.

``totals``, ``forward`` and ``backward`` are the wrappers: a CUDA tensor
launches the hand-written Hopper kernel (``dgs_tpu_torch/csrc/
agg_totals.cu`` / ``agg_forward.cu`` / ``agg_backward.cu``, the per-pair
math in ``agg_math.cuh``, the warp sweep in ``agg_sweep.cuh``), a CPU
tensor runs ``totals_plain`` /
``forward_plain`` / ``backward_plain``, the same function in plain torch.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..config import tri_size
from ..ops import formulas

# The structure's rows are padded to a multiple of this (kBlock of
# agg_totals.cu, which the wrappers check against the built library).
BLOCK = 128
WARP = 32
# Rows a warp takes in each warp-sweep kernel (1 to 32), by sweep: the
# queue carries colliding pairs across a warp's rows, so a warp's drains run
# full where a row has few colliding pairs, and fewer rows a warp keep more
# warps in flight.
ROWS_PER_WARP = {"forward": 4, "backward_entries": 8, "backward_centres": 8}
# Pairs and centres one chunk of the plain versions holds at a time.
PLAIN_PAIRS = 1 << 22
PLAIN_ROWS = 4096
# Collision radii below this are culled (aggregate_neighbors.cu:28).
ALIVE = 1e-6

# Centre-geometry column layout after the D mean columns.
C_REFF, C_INVNORM, C_INVTOT = 0, 1, 2


def ctr_cols(D: int, K: int) -> int:
    return D + 3 + K


def ent_geo_rows(D: int) -> int:
    """Per-entry geometry rows: shifted mean (D), conic (tri), r_eff (1)."""
    return D + tri_size(D) + 1


# ---------------------------------------------------------------------------
# Plain torch versions
# ---------------------------------------------------------------------------


def _chunks(ranges):
    """[(r0, r1, o0, o1)]: chunks of consecutive rows and the union of their
    ranges on the other side (rows with an empty range stay out of the
    union; chunks whose rows are all empty are dropped).  Chunks hold at
    most PLAIN_ROWS rows and about PLAIN_PAIRS pairs."""
    n = ranges.shape[1]
    lo, hi = ranges[0].tolist(), ranges[1].tolist()
    out, r0 = [], 0
    while r0 < n:
        r1, o0, o1 = r0, None, None
        while r1 < n and r1 - r0 < PLAIN_ROWS:
            if hi[r1] > lo[r1]:
                n0 = lo[r1] if o0 is None else min(o0, lo[r1])
                n1 = hi[r1] if o1 is None else max(o1, hi[r1])
                if o0 is not None and (r1 + 1 - r0) * (n1 - n0) > PLAIN_PAIRS:
                    break
                o0, o1 = n0, n1
            r1 += 1
        if o0 is not None:
            out.append((r0, r1, o0, o1))
        r0 = max(r1, r0 + 1)
    return out


def _pair(D: int, period, ctr_ent, ent_geo, ctr_geo, chunk):
    """Per-pair quantities of one chunk, centres along rows and entries
    along columns: the wrapped offsets X = mu_entry - mu_centre, the
    density G, zero outside the collision mask and outside each centre's
    own entry range, and that mask (radii alive, the distance test, the
    range) itself."""
    c0, c1, e0, e1 = chunk
    tri = tri_size(D)
    g = ent_geo[:, e0:e1]
    c = ctr_geo[c0:c1]
    Xs = [formulas.wrap(g[d][None, :] - c[:, d][:, None], period)
          for d in range(D)]
    con = [g[D + t][None, :] for t in range(tri)]
    G, _ = formulas.power_terms(Xs, con)
    r_j = g[D + tri][None, :]
    r_i = c[:, D + C_REFF][:, None]
    dist2 = sum(x * x for x in Xs)
    rr = r_i + r_j
    idx = torch.arange(e0, e1, device=g.device)[None, :]
    mask = ((r_j >= ALIVE) & (r_i >= ALIVE) & (dist2 <= rr * rr)
            & (idx >= ctr_ent[0, c0:c1, None])
            & (idx < ctr_ent[1, c0:c1, None]))
    return Xs, torch.where(mask, G, 0.0), mask


def _sincode(D: int, nfreq: int, E: int, Xn, dtf, ladder: bool):
    """(emb, fac, terms) of the normalised offsets; terms[(d, e)] =
    (sin, cos, i0).  ``ladder`` derives the rungs above the base by the
    angle-addition recurrence."""
    stride = (E - 1) // D
    dt = dtf[0]
    emb = dt[E - 1].expand_as(Xn[0])
    fac = dt[2 * E - 1].expand_as(Xn[0])
    terms = {}
    for d in range(D):
        s = cs = s1 = c1 = None
        for e in range(nfreq):
            if ladder and e > 0:
                s, cs = s * c1 + cs * s1, cs * c1 - s * s1
            else:
                phase = (dt[2 * E + e] * math.pi) * Xn[d]
                s, cs = torch.sin(phase), torch.cos(phase)
                if ladder:
                    s1, c1 = s, cs
            i0 = d * stride + 2 * e
            emb = emb + s * dt[i0] + cs * dt[i0 + 1]
            fac = fac + s * dt[E + i0] + cs * dt[E + i0 + 1]
            terms[(d, e)] = (s, cs, i0)
    return emb, fac, terms


def pair_counts(D: int, period: Optional[float], ctr_ent, ent_geo, ctr_geo):
    """(candidate pairs, colliding pairs) of a structure: the same-tile
    pairs the kernels sweep, and those that pass the collision mask with a
    non-positive quadratic form (the pairs that do the work)."""
    candidates = int((ctr_ent[1] - ctr_ent[0]).long().sum())
    colliding = 0
    for chunk in _chunks(ctr_ent):
        _, G, _ = _pair(D, period, ctr_ent, ent_geo, ctr_geo, chunk)
        colliding += int((G > 0).sum())
    return candidates, colliding


# The kernels' sweeps: rows of one side against their range of the other.
SWEEPS = ("forward", "backward_entries", "backward_centres")


def _masked_pairs(D, period, ctr_ent, ent_geo, ctr_geo):
    """(centre, entry, colliding) of every pair under the collision mask:
    the pairs whose body the warp sweep runs; colliding (G > 0) as in
    pair_counts."""
    rows, cols, coll = [], [], []
    for chunk in _chunks(ctr_ent):
        _, G, mask = _pair(D, period, ctr_ent, ent_geo, ctr_geo, chunk)
        r, c = mask.nonzero(as_tuple=True)
        rows.append(r + chunk[0])
        cols.append(c + chunk[2])
        coll.append(G[r, c] > 0)
    dev = ctr_geo.device
    if not rows:
        empty = torch.zeros((0,), dtype=torch.long, device=dev)
        return empty, empty, torch.zeros((0,), dtype=torch.bool, device=dev)
    return torch.cat(rows), torch.cat(cols), torch.cat(coll)


def _warp_per_row_steps(ranges, row, rows_per_warp):
    """(sweep steps, body steps) of the warp sweep: a warp owns
    ``rows_per_warp`` consecutive rows and tests their ranges, one after
    another, 32 columns a step; the masked columns go to a queue in order,
    drained 32 at a time across the warp's rows and once at their end
    (csrc/agg_sweep.cuh)."""
    lo, hi = ranges[0].long(), ranges[1].long()
    group = torch.arange(ranges.shape[1], device=lo.device) // rows_per_warp
    n_groups = int(group[-1]) + 1
    cand = torch.zeros(n_groups, dtype=torch.long, device=lo.device)
    cand = cand.index_add(0, group, (hi - lo).clamp(min=0))
    per_group = torch.bincount(row // rows_per_warp, minlength=n_groups)
    return (int((-(-cand // WARP)).sum()),
            int((-(-per_group // WARP)).sum()))


def warp_schedule(D: int, period: Optional[float], ctr_ent, ent_ctr,
                  ent_geo, ctr_geo, rows_per_warp: int = 1):
    """How the warp sweep of the kernels (csrc/agg_sweep.cuh: one warp over
    ``rows_per_warp`` consecutive rows, its lanes across each row's range,
    the masked pairs compacted into a queue) spends its warps on a
    structure, per sweep (``SWEEPS``: the forward, and the backward's
    entry-major and centre-major sweeps), counted in plain torch from the
    structure alone:

    * ``candidate_pairs``, ``colliding_pairs``: as pair_counts;
    * ``body_pairs``: the pairs under the collision mask (radii alive, the
      distance test), whose body the kernel runs;
    * ``sweep_steps``: warp steps of the candidate test, 32 candidates
      each (the kernels take two of them in one loop pass);
    * ``body_steps``: warp steps that run the pair body;
    * ``lane_use``: colliding pairs / (32 body_steps)."""
    row_c, col_e, coll = _masked_pairs(D, period, ctr_ent, ent_geo, ctr_geo)
    candidates = int((ctr_ent[1] - ctr_ent[0]).long().sum())
    colliding = int(coll.sum())
    out = {}
    for sweep in SWEEPS:
        ranges, row = ((ent_ctr, col_e) if sweep == "backward_entries"
                       else (ctr_ent, row_c))
        sweep_steps, body_steps = _warp_per_row_steps(ranges, row,
                                                      rows_per_warp)
        out[sweep] = dict(
            candidate_pairs=candidates, colliding_pairs=colliding,
            body_pairs=int(row.numel()), sweep_steps=sweep_steps,
            body_steps=body_steps,
            lane_use=colliding / (WARP * body_steps) if body_steps else 0.0)
    return out


def totals_plain(D: int, period: Optional[float], ctr_ent, ent_geo,
                 ctr_geo) -> torch.Tensor:
    """The plain torch version of the totals kernel: same operands, the
    same (Cp, 1) per-centre total density."""
    Cp = ctr_geo.shape[0]
    out = torch.zeros((Cp, 1), dtype=torch.float32, device=ctr_geo.device)
    for chunk in _chunks(ctr_ent):
        _, G, _ = _pair(D, period, ctr_ent, ent_geo, ctr_geo, chunk)
        out[chunk[0]:chunk[1], 0] = G.sum(dim=1)
    return out


def forward_plain(D: int, L: int, K: int, nfreq: int,
                  period: Optional[float], ctr_ent, ent_geo, ent_fk, ctr_geo,
                  dtf, *, ladder: bool = False, with_totals: bool = False):
    """The plain torch version of the forward kernel: same operands, the
    same (Cp, L) pre-activation rows (and (Cp, 1) totals)."""
    Cp = ctr_geo.shape[0]
    E = (dtf.shape[1] - nfreq) // 2
    out = torch.zeros((Cp, L), dtype=torch.float32, device=ctr_geo.device)
    tot = torch.zeros((Cp, 1), dtype=torch.float32, device=ctr_geo.device)
    for chunk in _chunks(ctr_ent):
        c0, c1, e0, e1 = chunk
        Xs, G, _ = _pair(D, period, ctr_ent, ent_geo, ctr_geo, chunk)
        c = ctr_geo[c0:c1]
        fk = ent_fk[:, e0:e1]
        w = c[:, D + 3:D + 3 + K] @ fk[L:L + K]
        inv_norm = c[:, D + C_INVNORM][:, None]
        inv_tot = c[:, D + C_INVTOT][:, None]
        emb, fac, _ = _sincode(D, nfreq, E, [x * inv_norm for x in Xs], dtf,
                               ladder)
        coeff = G * w * inv_tot
        out[c0:c1] = ((coeff * fac) @ fk[:L].T
                      + (coeff * emb).sum(dim=1, keepdim=True))
        tot[c0:c1, 0] = G.sum(dim=1)
    return (out, tot) if with_totals else out


def backward_plain(D: int, L: int, K: int, nfreq: int,
                   period: Optional[float], ranges, ent_geo, ent_fk, ctr_geo,
                   dtf, gpre, gsum, *, ladder: bool = False):
    """The plain torch version of the backward kernels: same operands, the
    same (dent (L + K, Ep), dctr (Cp, K + 2E + nfreq))."""
    ctr_ent, _ = ranges
    Cp, Ep = ctr_geo.shape[0], ent_geo.shape[1]
    E = (dtf.shape[1] - nfreq) // 2
    S = K + 2 * E + nfreq
    dev = ctr_geo.device
    dent = torch.zeros((L + K, Ep), dtype=torch.float32, device=dev)
    dctr = torch.zeros((Cp, S), dtype=torch.float32, device=dev)
    dt = dtf[0]
    for chunk in _chunks(ctr_ent):
        c0, c1, e0, e1 = chunk
        Xs, G, _ = _pair(D, period, ctr_ent, ent_geo, ctr_geo, chunk)
        c = ctr_geo[c0:c1]
        fk = ent_fk[:, e0:e1]
        q = c[:, D + 3:D + 3 + K]
        w = q @ fk[L:L + K]
        inv_norm = c[:, D + C_INVNORM][:, None]
        Xn = [x * inv_norm for x in Xs]
        emb, fac, terms = _sincode(D, nfreq, E, Xn, dtf, ladder)
        g = gpre[c0:c1]
        gs = gsum[c0:c1]
        gdotf = g @ fk[:L]
        dw = G * (fac * gdotf + emb * gs)
        dent[:L, e0:e1] += g.T @ (G * w * fac)
        dent[L:, e0:e1] += q.T @ dw
        dctr[c0:c1, :K] = dw @ fk[L:L + K].T
        cw = G * w
        cemb, cfac = cw * gs, cw * gdotf
        dfreq = [0.0] * nfreq
        for (d, e), (s, cs, i0) in terms.items():
            dctr[c0:c1, K + i0] = (cemb * s).sum(dim=1)
            dctr[c0:c1, K + i0 + 1] = (cemb * cs).sum(dim=1)
            dctr[c0:c1, K + E + i0] = (cfac * s).sum(dim=1)
            dctr[c0:c1, K + E + i0 + 1] = (cfac * cs).sum(dim=1)
            dphase = (cemb * (cs * dt[i0] - s * dt[i0 + 1])
                      + cfac * (cs * dt[E + i0] - s * dt[E + i0 + 1]))
            dfreq[e] = dfreq[e] + (dphase * (math.pi * Xn[d])).sum(dim=1)
        dctr[c0:c1, K + E - 1] = cemb.sum(dim=1)
        dctr[c0:c1, K + 2 * E - 1] = cfac.sum(dim=1)
        for e in range(nfreq):
            dctr[c0:c1, K + 2 * E + e] = dfreq[e]
    return dent, dctr


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def _check(name: str, dev, specs):
    for arg, t, dtype, shape in specs:
        if (t.device != dev or t.dtype != dtype or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(
                f"{name}: {arg} must be a contiguous {dtype} tensor of shape "
                f"{shape} on {dev}, got {t.dtype} {tuple(t.shape)} on "
                f"{t.device}")


def _library(name: str, D: int):
    from . import _build

    if not 1 <= D <= 3:
        raise ValueError(f"{name}: unsupported D={D}")
    lib = _build.load()
    if lib.dgs_agg_block() != BLOCK:
        raise RuntimeError(f"{name}: kernel library block size differs from "
                           "kernels.aggregate.BLOCK")
    return lib


def _period_args(period):
    return (0, 0.0) if period is None else (1, float(period))


def _no_kernel(name: str, dev):
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")


def totals(D: int, period: Optional[float], ctr_ent, ent_geo,
           ctr_geo) -> torch.Tensor:
    """(Cp, 1) per-centre total density: the sum over the entries of the
    centre's tile of the neighbour's density under the collision mask
    (aggregate_neighbors.cu:120-125).  Only the mean and radius columns of
    ``ctr_geo`` are read.  ``period`` is None when the entry means are
    already shifted to their tile's periodic image, and on open domains.
    CUDA tensors launch the CUDA kernel (counted in ``totals.launches``);
    CPU tensors run totals_plain."""
    if ctr_geo.device.type == "cpu":
        return totals_plain(D, period, ctr_ent, ent_geo, ctr_geo)
    _no_kernel("totals", ctr_geo.device)
    lib = _library("totals", D)
    Cp, cols = ctr_geo.shape
    Ep = ent_geo.shape[1]
    _check("totals", ctr_geo.device, (
        ("ent_geo", ent_geo, torch.float32, (ent_geo_rows(D), Ep)),
        ("ctr_geo", ctr_geo, torch.float32, (Cp, cols)),
        ("ctr_ent", ctr_ent, torch.int32, (2, Cp))))
    if cols < D + 1 or Cp < 1:
        raise ValueError(f"totals: ctr_geo of shape {(Cp, cols)} for D={D}")
    out = torch.empty((Cp, 1), dtype=torch.float32, device=ctr_geo.device)
    with torch.cuda.device(ctr_geo.device):
        err = lib.dgs_agg_totals(
            ent_geo.data_ptr(), Ep, ctr_geo.data_ptr(), cols, Cp,
            ctr_ent.data_ptr(), D, *_period_args(period), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"totals: CUDA launch failed (cudaError {err})")
    totals.launches += 1
    return out


totals.launches = 0


def _operand_specs(D, L, K, nfreq, ent_geo, ent_fk, ctr_geo, dtf):
    Cp, Ep = ctr_geo.shape[0], ent_geo.shape[1]
    return (
        ("ent_geo", ent_geo, torch.float32, (ent_geo_rows(D), Ep)),
        ("ent_fk", ent_fk, torch.float32, (L + K, Ep)),
        ("ctr_geo", ctr_geo, torch.float32, (Cp, ctr_cols(D, K))),
        ("dtf", dtf, torch.float32, (1, dtf.shape[1])))


def _code_E(name: str, D: int, nfreq: int, dtf) -> int:
    E = (dtf.shape[1] - nfreq) // 2
    if 2 * E + nfreq != dtf.shape[1] or (E - 1) // D // 2 != nfreq:
        raise ValueError(
            f"{name}: dtf has {dtf.shape[1]} columns, not 2E + nfreq with "
            f"nfreq = (E - 1) // D // 2 = {nfreq} at D={D}")
    return E


def _rows(name: str, sweep: str) -> int:
    rows = ROWS_PER_WARP[sweep]
    if not 1 <= rows <= WARP:
        raise ValueError(f"{name}: ROWS_PER_WARP[{sweep!r}]={rows} outside "
                         f"1..{WARP}")
    return rows


def forward(D: int, L: int, K: int, nfreq: int, period: Optional[float],
            ctr_ent, ent_geo, ent_fk, ctr_geo, dtf, *,
            ladder: bool = False, with_totals: bool = False):
    """(Cp, L) raw pre-activation rows, before the L x L transform:
    sum_j G <q_i, k_j> inv_tot_i (fac feat_j + emb) over each centre's
    tile.  ``with_totals`` also returns the (Cp, 1) total density of the
    same sweep (the structure's inv_tot column is then 1 and the caller
    normalises outside).  ``ladder`` certifies frequencies[e] ==
    (e + 1) frequencies[0].  CUDA tensors launch the CUDA kernel (counted
    in ``forward.launches``), ROWS_PER_WARP["forward"] centres a warp;
    CPU tensors run forward_plain."""
    E = _code_E("forward", D, nfreq, dtf)
    if ctr_geo.device.type == "cpu":
        return forward_plain(D, L, K, nfreq, period, ctr_ent, ent_geo,
                             ent_fk, ctr_geo, dtf, ladder=ladder,
                             with_totals=with_totals)
    dev = ctr_geo.device
    _no_kernel("forward", dev)
    lib = _library("forward", D)
    rows = _rows("forward", "forward")
    Cp, Ep = ctr_geo.shape[0], ent_geo.shape[1]
    _check("forward", dev, _operand_specs(
        D, L, K, nfreq, ent_geo, ent_fk, ctr_geo, dtf)
        + (("ctr_ent", ctr_ent, torch.int32, (2, Cp)),))
    out = torch.empty((Cp, L), dtype=torch.float32, device=dev)
    tot = torch.empty((Cp, 1) if with_totals else (0,), dtype=torch.float32,
                      device=dev)
    with torch.cuda.device(dev):
        err = lib.dgs_agg_forward(
            ent_geo.data_ptr(), ent_fk.data_ptr(), Ep, ctr_geo.data_ptr(),
            ctr_cols(D, K), Cp, ctr_ent.data_ptr(), dtf.data_ptr(), D, L, K,
            nfreq, E, *_period_args(period), int(ladder), int(with_totals),
            rows, out.data_ptr(), tot.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"forward: CUDA launch failed (cudaError {err})")
    forward.launches += 1
    return (out, tot) if with_totals else out


forward.launches = 0


def backward(D: int, L: int, K: int, nfreq: int, period: Optional[float],
             ranges, ent_geo, ent_fk, ctr_geo, dtf, gpre, gsum, *,
             ladder: bool = False):
    """(dent, dctr) from the cotangent of forward's rows.

    ``gpre`` (Cp, L) is the cotangent ALREADY scaled by inv_tot per centre
    and ``gsum`` (Cp, 1) its channel sum; ``ranges`` is (ctr_ent, ent_ctr).
    dent (L + K, Ep) holds the per-entry rows of dfeatures and dkeys (the
    caller segment-sums the columns by Gaussian id; the CUDA kernel writes
    them entry-major, so its dent is the transpose view of an
    (Ep, L + K) buffer, the plain version's contiguous); dctr
    (Cp, K + 2E + nfreq) one row per centre: dqueries, then the centre's
    partial sums of d(distance_transform) and d(frequencies) (the caller
    sums them over centres).

    CUDA tensors launch the two kernels of csrc/agg_backward.cu, the
    entry-major and the centre-major sweep, each counted in
    ``backward.launches``, with ROWS_PER_WARP's entries and centres a
    warp; the centre-major one is built for nfreq 1 to 4.  CPU tensors run backward_plain.  Deterministic: no
    atomics."""
    E = _code_E("backward", D, nfreq, dtf)
    if ctr_geo.device.type == "cpu":
        return backward_plain(D, L, K, nfreq, period, ranges, ent_geo,
                              ent_fk, ctr_geo, dtf, gpre, gsum, ladder=ladder)
    dev = ctr_geo.device
    _no_kernel("backward", dev)
    lib = _library("backward", D)
    rows_e = _rows("backward", "backward_entries")
    rows_c = _rows("backward", "backward_centres")
    ctr_ent, ent_ctr = ranges
    Cp, Ep = ctr_geo.shape[0], ent_geo.shape[1]
    _check("backward", dev, _operand_specs(
        D, L, K, nfreq, ent_geo, ent_fk, ctr_geo, dtf) + (
        ("ctr_ent", ctr_ent, torch.int32, (2, Cp)),
        ("ent_ctr", ent_ctr, torch.int32, (2, Ep)),
        ("gpre", gpre, torch.float32, (Cp, L)),
        ("gsum", gsum, torch.float32, (Cp, 1))))
    max_nfreq = lib.dgs_agg_backward_max_nfreq()
    if not 1 <= nfreq <= max_nfreq:
        raise ValueError(
            f"backward: the centre-major kernel is built for nfreq 1 to "
            f"{max_nfreq}, got nfreq={nfreq}")
    S = K + 2 * E + nfreq
    dent = torch.empty((Ep, L + K), dtype=torch.float32, device=dev)
    dctr = torch.zeros((Cp, S), dtype=torch.float32, device=dev)
    do_wrap, per = _period_args(period)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        common = (ent_geo.data_ptr(), ent_fk.data_ptr(), Ep,
                  ctr_geo.data_ptr(), ctr_cols(D, K), Cp)
        tail = (dtf.data_ptr(), gpre.data_ptr(), gsum.data_ptr(), D, L, K,
                nfreq, E, do_wrap, per, int(ladder))
        err = lib.dgs_agg_backward_entries(
            *common, ent_ctr.data_ptr(), *tail, rows_e, dent.data_ptr(),
            stream)
        if err != 0:
            raise RuntimeError(
                f"backward: CUDA launch of the entry-major kernel failed "
                f"(cudaError {err})")
        backward.launches += 1
        err = lib.dgs_agg_backward_centres(
            *common, ctr_ent.data_ptr(), *tail, rows_c, dctr.data_ptr(),
            stream)
        if err != 0:
            raise RuntimeError(
                f"backward: CUDA launch of the centre-major kernel failed "
                f"(cudaError {err})")
        backward.launches += 1
    return dent.T, dctr


backward.launches = 0
