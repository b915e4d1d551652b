"""The least time the card could take for the port's kernels' work, and
the exact pair counts it rests on.

The counterpart of ``dgs_tpu/utils/roofline.py`` for an NVIDIA H100 SXM
(``NVIDIA H100 80GB HBM3``, 700 W power limit; a card set below 700 W runs
slower under load, so state the limit beside every share of a bound).
``pair_count`` is the exact same-tile (entry, sample) pair total of a
binning; ``pair_ops`` / ``kernel_bound`` bound the tiled and dense kernels,
``mode_pair_ops`` / ``mode_bound`` the tiled kernels' modes (separable,
moments, folded, folded_dvals, folded_vjp, h_matmul: their contractions at
the TF32 tensor-core peak), ``agg_pair_ops`` / ``agg_bound`` the
aggregation kernels, ``pair_flops`` dgs_tpu's per-pair model of a training
step (fp32 instructions and contraction multiply-adds, classic or folded),
and ``step_roofline`` a whole tiled training step.  A bound is the larger
of the operations over the card's peak rate for their type and the bytes
moved (each input read once, each output written once) over its memory
rate.  Counts are the function's work, whichever core a kernel runs it on.

dgs_tpu's chip constants (its v5e VPU, MXU and HBM rates) describe the TPU
and are not carried over.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ..kernels import tiled as ktiled
from ..ops import formulas

# The card's peaks.  Memory and fp32 rates are the H100 SXM data sheet's
# (3.35 TB/s; 67 TFLOP/s outside the tensor cores, two operations per FMA,
# so 33.5e12 fp32 instructions/s); the special-function rate is 16 results
# per clock per SM (NVIDIA's CUDA C++ documentation, arithmetic throughput,
# compute capability 9.0) on 132 SMs at the 1.98 GHz boost clock.
MEM_BYTES_S = 3.35e12
FP32_INSTR_S = 67e12 / 2
SFU_OPS_S = 16 * 132 * 1.98e9
# Dense TF32 tensor-core peak of the data sheet (495 TFLOP/s, two flops a
# multiply-add).
TF32_MAC_S = 495e12 / 2


def pair_ops(D, orders, C, wrapped, backward):
    """(fp32 instructions, special-function operations) one kept pair needs
    at the least for the function of csrc/pair_math.cuh and the kernels'
    accumulation loops (an FMA, a multiply or an add is one instruction;
    the pair's geometry is counted once however many channel passes a
    kernel makes).  This is the function's least work, not what the
    kernels issue: the polynomials q_ij = a_i a_j - C_ij are counted once
    and shared by the laplacian weights, the third-order weights and the
    VJP, and the VJP's S0 is one FMA per component from the weights the
    pair already has (sum_k h_k w_k = G S0); pair_vjp recomputes both."""
    tri, n3 = D * (D + 1) // 2, D * (D + 1) * (D + 2) // 6
    K = ktiled.total_unique(orders, D)
    ops = D + (3 * D if wrapped else 0)   # X = mu - x; x/period, round, fma
    ops += D * D + D + 1                  # a = C X; power = -1/2 a.X
    ops += 1                              # exp(power) = ex2(power * log2 e)
    if "laplacian" in orders or "third" in orders:
        ops += tri                        # q_ij, one FMA each
    # G itself; G a_i; G q_ij; G (C_ij a_l + C_il a_j - a_i q_jl)
    weights = {"value": 0, "derivative": D, "laplacian": tri,
               "third": 4 * n3}
    ops += sum(weights[o] for o in orders)
    if not backward:
        return ops + K * C, 1             # acc[k][c] += w_k v_c
    ops += 2 * K * C                      # h_k += g v_c; dv_c += g w_k
    # per component: one FMA for S0, and for W one (derivative), two
    # (laplacian) or three (third, with three more for Y)
    vjp = {"value": 1, "derivative": 2 * D, "laplacian": 3 * tri,
           "third": 7 * n3}
    ops += sum(vjp[o] for o in orders)
    return ops + D * (D + 3) + 2 * D + 1 + 5 * tri, 1   # dmu, z, dcon


def kernel_bound(pairs, n_floats, D, orders, C, wrapped, backward):
    """{"bound_ms", "bound_by"}: the least time the card could take for
    ``pairs`` kept pairs and ``n_floats`` fp32 values moved (each input
    read once, each output written once)."""
    ops, sfu = pair_ops(D, orders, C, wrapped, backward)
    t_ops = max(pairs * ops / FP32_INSTR_S, pairs * sfu / SFU_OPS_S)
    t_bytes = 4 * n_floats / MEM_BYTES_S
    return {"bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def agg_pair_ops(D, L, K, nfreq, ladder, kind):
    """(fp32 operations per colliding pair, special-function operations
    per colliding pair, fp32 operations per candidate pair) the function
    needs at the least (an FMA, a multiply or an add counts one).
    Every candidate pays the offset and the distance test; a colliding pair
    adds the density, and for ``forward`` and ``backward`` the K-term
    weight, the code (sin and cos shared between emb and fac: two
    special-function results per (dim, rung), or per dim with the ladder,
    whose higher rungs take 4 operations each; 4 FMAs per (dim, rung) for
    emb and fac) and the accumulation.  ``backward`` is the whole function
    of both entry points with the pair's geometry, weight and code taken
    once: the kernels take them twice."""
    cand = 3 * D + 3                       # X; dist2; r_i + r_j, squared, <=
    ops = D * D + D + 1 + 1                # a = C X; power; ex2's scale
    sfu = 1                                # ex2
    if kind == "totals":
        return ops + 1, sfu, cand
    ops += K + D                           # w; Xn = X inv_norm
    rungs = D * nfreq
    if ladder:
        ops += D + 4 * (rungs - D)         # base phases; the recurrence
        sfu += 2 * D
    else:
        ops += rungs
        sfu += 2 * rungs
    ops += 4 * rungs                       # emb, fac
    if kind == "forward":
        return ops + 4 + L, sfu, cand      # coeff (2), cf, emb acc; L FMAs
    ops += L                               # <g_i, feat_j>
    ops += 2 + 3 + L + K                   # cf; dw; dfeat, dkey rows
    ops += K + 3                           # dq; cw, cemb, cfac
    ops += 2 + 10 * rungs                  # ddt biases; ddt (4), dfreq (6)
    return ops, sfu, cand


def agg_bound(kind, cand, coll, n_floats, D, L, K, nfreq, ladder):
    """{"bound_ms", "bound_by"} of an aggregation kernel ``kind``
    ("totals", "forward", "backward"): ``cand`` candidate and ``coll``
    colliding pairs, ``n_floats`` fp32 values moved."""
    ops, sfu, cand_ops = agg_pair_ops(D, L, K, nfreq, ladder, kind)
    t_ops = max((coll * ops + cand * cand_ops) / FP32_INSTR_S,
                coll * sfu / SFU_OPS_S)
    t_bytes = 4 * n_floats / MEM_BYTES_S
    return {"bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def pair_count(ent_tile, num_tiles: int, s_tile) -> int:
    """Exact same-tile (entry, sample) pair total sum_t E_t * S_t of a
    binning (entry and sample tile ids; ids >= num_tiles are sentinels)."""
    ent_tile = np.asarray(ent_tile).reshape(-1)
    s_tile = np.asarray(s_tile).reshape(-1)
    e_t = np.bincount(ent_tile[ent_tile < num_tiles], minlength=num_tiles)
    s_t = np.bincount(s_tile[s_tile < num_tiles], minlength=num_tiles)
    return int((e_t.astype(np.int64) * s_t.astype(np.int64)).sum())


def _context_ops(D):
    """fp32 instructions of a pair's G and a, unwrapped: X, a = C X, the
    power and the exponential's scale."""
    return D + D * D + D + 1 + 1


def pair_flops(orders: Sequence[str], D: int, C: int,
               folded: bool = True):
    """(fp32 instructions, contraction multiply-adds) a pair of a training
    step, forward and backward, as dgs_tpu's pair_flops splits them (its
    mxu_macs are the second number): with ``folded`` the folded forward
    (G, then R multiply-adds, R = C sum_k |meta_k|) and the folded dvalues
    (R), the rest of the backward as pair_ops counts it; without, the
    classic kernels with their value contractions (K C forward, K C
    backward) counted as multiply-adds.  The port's classic kernels run
    those on the CUDA cores; this counts the function's work."""
    K = ktiled.total_unique(tuple(orders), D)
    R = ktiled.fold_rows(formulas.folded_structure(tuple(orders), D)[0],
                         C)[0]
    bwd = pair_ops(D, orders, C, False, True)[0] - K * C
    if folded:
        return float(_context_ops(D) + bwd), float(2 * R)
    fwd = pair_ops(D, orders, C, False, False)[0] - K * C
    return float(fwd + bwd), float(2 * K * C)


def step_roofline(orders: Sequence[str], D: int, C: int, pairs: int,
                  N: int, E: int, folded: bool = False) -> dict:
    """The least time of one tiled training step's kernels (forward,
    backward, segment-sum) on the card, counted unwrapped (the chunked and
    headline steps are certified wrap-free), with dgs_tpu's keys: ``pairs``;
    ``flops_per_step`` (here fp32 instructions, an FMA one: pair_ops'
    forward and backward counts times ``pairs``); ``sol_vpu_s`` (those
    instructions, or the special-function results where they take longer,
    on the CUDA cores); ``sol_mxu_s`` 0.0 (the classic kernels run fp32
    FMAs only); ``sol_hbm_s`` (bytes: the (K*C, N) output written and its
    cotangent read, the samples read by both kernels, the per-entry
    operands read by both and the per-entry gradient rows written and read
    once); ``sol_step_s`` the largest, and ``bound`` "vpu", "mxu" or "hbm".

    With ``folded`` (the folded forward and the folded dvalues, as
    dgs_tpu's step_roofline counts them): pair_flops' fp32 instructions,
    its multiply-adds at 3 TF32 passes on the tensor cores
    (``sol_mxu_s``), and the folded operands' floats: the fold rows
    (R x E) and the alpha rows (R / C x E) read, the beta-expanded
    cotangent (R x N) written and read, and the raw monomials
    (n_mono + 1 rows in place of D + 1) read by both kernels."""
    tri = D * (D + 1) // 2
    K = ktiled.total_unique(tuple(orders), D)
    ops_f, sfu_f = pair_ops(D, orders, C, False, False)
    ops_b, sfu_b = pair_ops(D, orders, C, False, True)
    ops, macs = float(ops_f + ops_b), 0.0
    n_floats = (2 * K * C * N + 2 * (D + 1) * N
                + E * (2 * (1 + D + tri + C) + 2 * (D + tri + C)))
    if folded:
        ops, macs = pair_flops(orders, D, C, folded=True)
        meta, n_mono = formulas.folded_structure(tuple(orders), D)
        R = ktiled.fold_rows(meta, C)[0]
        n_floats += R * E + R // C * E + 2 * R * N + 2 * (n_mono - D) * N
    vpu_t = max(pairs * ops / FP32_INSTR_S,
                pairs * (sfu_f + sfu_b) / SFU_OPS_S)
    mxu_t = pairs * 3 * macs / TF32_MAC_S
    hbm_t = 4 * n_floats / MEM_BYTES_S
    sol = max(vpu_t, mxu_t, hbm_t)
    return {"pairs": pairs, "flops_per_step": pairs * (ops + 2 * macs),
            "sol_step_s": sol, "sol_vpu_s": vpu_t, "sol_mxu_s": mxu_t,
            "sol_hbm_s": hbm_t,
            "bound": ("vpu" if sol == vpu_t else "mxu" if sol == mxu_t
                      else "hbm")}


def mode_pair_ops(D, orders, C, kind, passes):
    """(fp32 instructions, special-function operations, tensor-core
    multiply-adds) one kept pair needs at the least in a kernel mode:
      "separable"     the forward with power and a = C X contracted:
                      1 + D + tri and D (1 + D) multiply-adds a pass;
      "moments"       the backward with G S0 contracted against the
                      monomials, 1 + D + tri a pass, and G W_l against
                      [1, x_l], D (1 + D) a pass, as dgs_tpu's _moment_rows
                      contracts both on the MXU (the D multiplies G W_l and
                      the laplacian's and the thirds' rows, one FMA each,
                      on the CUDA cores);
      "folded"        the folded forward: G of the pair (X, a, the power,
                      the exponential), then R multiply-adds a pass
                      (R = C sum_k |meta_k|, Z = fold G);
      "folded_dvals"  the backward with the folded dvalues: the classic
                      backward without its K C value-gradient FMAs, and R
                      multiply-adds a pass (Zd = cb G);
      "folded_vjp"    the fully folded backward: G and a, then
                      (1 + D) R multiply-adds a pass for S0 and W_l and R
                      for Zd, and the combine (dmu: D^2 + 2 D, z: D,
                      dconic: 3 a packed entry);
      "h_matmul"      the classic backward with h_k = g_k . values
                      contracted: K C multiply-adds a pass in place of its
                      K C h FMAs.
    ``passes`` is the TF32 passes of the contraction (3, or 1 under
    fast-math; the moment form is always 3).  The rest is pair_ops' count
    without the work the contraction takes.  This counts the function's
    work, not how a kernel splits it between the two kinds of core; the
    folded forms' per-sample and per-entry recombinations are not per pair
    and are left out."""
    tri = D * (D + 1) // 2
    mr, mp = 1 + D + tri, 1 + D
    K = ktiled.total_unique(tuple(orders), D)
    has_w = any(o in ("derivative", "laplacian", "third") for o in orders)
    if kind == "separable":
        ops, sfu = pair_ops(D, orders, C, False, False)
        return ops - (D + D * D + D + 1), sfu, passes * (mr + D * mp)
    if kind in ("folded", "folded_dvals", "folded_vjp"):
        R = ktiled.fold_rows(formulas.folded_structure(tuple(orders), D)[0],
                             C)[0]
        if kind == "folded":
            return _context_ops(D), 1, passes * R
        if kind == "folded_dvals":
            ops, sfu = pair_ops(D, orders, C, False, True)
            return ops - K * C, sfu, passes * R
        return (_context_ops(D) + D * D + 3 * D + 3 * tri, 1,
                passes * (2 + D) * R)
    if kind == "h_matmul":
        ops, sfu = pair_ops(D, orders, C, False, True)
        return ops - K * C, sfu, passes * K * C
    if kind != "moments":
        raise ValueError(f"unknown kernel mode {kind!r}")
    ops, sfu = pair_ops(D, orders, C, False, True)
    ops -= D * (D + 3) + 2 * D + 1 + 5 * tri       # the closing terms
    ops += D if has_w else 0                        # G W_l
    ops += tri * (("laplacian" in orders) + ("third" in orders))
    return ops, sfu, passes * (mr + (D * mp if has_w else 0))


def mode_bound(pairs, n_floats, D, orders, C, kind, passes):
    """{"bound_ms", "bound_by"} of a kernel mode: the larger of the fp32
    instructions at FP32_INSTR_S, the special functions at SFU_OPS_S, the
    contraction's multiply-adds at the TF32 peak TF32_MAC_S (the tensor
    cores run beside the CUDA cores), and ``n_floats`` fp32 values moved at
    MEM_BYTES_S."""
    ops, sfu, macs = mode_pair_ops(D, orders, C, kind, passes)
    t_ops = max(pairs * ops / FP32_INSTR_S, pairs * sfu / SFU_OPS_S,
                pairs * macs / TF32_MAC_S)
    t_bytes = 4 * n_floats / MEM_BYTES_S
    return {"bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
