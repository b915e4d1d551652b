"""The least time the card could take for the port's kernels' work, and
the exact pair counts it rests on.

The counterpart of ``dgs_tpu/utils/roofline.py`` for an NVIDIA H100 SXM
(``NVIDIA H100 80GB HBM3``, 700 W power limit; a card set below 700 W runs
slower under load, so state the limit beside every share of a bound).
``pair_count`` is the exact same-tile (entry, sample) pair total of a
binning; ``pair_ops`` / ``kernel_bound`` bound the tiled and dense kernels,
``mode_pair_ops`` / ``mode_bound`` the tiled kernels' separable and moment
modes (their contractions at the TF32 tensor-core peak),
``agg_pair_ops`` / ``agg_bound`` the aggregation kernels, and
``step_roofline`` a whole tiled training step.  A bound is the larger of
the operations over the card's peak rate for their type and the bytes moved
(each input read once, each output written once) over its memory rate.

dgs_tpu's chip constants (its v5e VPU, MXU and HBM rates) and its folded
matrix-unit pair model (``pair_flops``) describe TPU kernel modes the port
does not have and are not carried over.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ..kernels import tiled as ktiled

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


def step_roofline(orders: Sequence[str], D: int, C: int, pairs: int,
                  N: int, E: int) -> dict:
    """The least time of one tiled training step's kernels (forward,
    backward, segment-sum) on the card, counted unwrapped (the chunked and
    headline steps are certified wrap-free), with dgs_tpu's keys: ``pairs``;
    ``flops_per_step`` (here fp32 instructions, an FMA one: pair_ops'
    forward and backward counts times ``pairs``); ``sol_vpu_s`` (those
    instructions, or the special-function results where they take longer,
    on the CUDA cores); ``sol_mxu_s`` 0.0 (no tensor cores: the port's
    kernels run fp32 FMAs only); ``sol_hbm_s`` (bytes: the (K*C, N) output
    written and its cotangent read, the samples read by both kernels, the
    per-entry operands read by both and the per-entry gradient rows
    written and read once); ``sol_step_s`` the largest, and ``bound``
    "vpu" or "hbm"."""
    tri = D * (D + 1) // 2
    K = ktiled.total_unique(tuple(orders), D)
    ops_f, sfu_f = pair_ops(D, orders, C, False, False)
    ops_b, sfu_b = pair_ops(D, orders, C, False, True)
    vpu_t = max(pairs * (ops_f + ops_b) / FP32_INSTR_S,
                pairs * (sfu_f + sfu_b) / SFU_OPS_S)
    n_bytes = 4 * (2 * K * C * N + 2 * (D + 1) * N
                   + E * (2 * (1 + D + tri + C) + 2 * (D + tri + C)))
    hbm_t = n_bytes / MEM_BYTES_S
    sol = max(vpu_t, hbm_t)
    return {"pairs": pairs, "flops_per_step": pairs * (ops_f + ops_b),
            "sol_step_s": sol, "sol_vpu_s": vpu_t, "sol_mxu_s": 0.0,
            "sol_hbm_s": hbm_t, "bound": "vpu" if vpu_t >= hbm_t else "hbm"}


def mode_pair_ops(D, orders, C, kind, passes):
    """(fp32 instructions, special-function operations, tensor-core
    multiply-adds) one kept pair needs at the least in a kernel mode:
    ``kind`` "separable" (the forward with power and a = C X contracted:
    1 + D + tri and D (1 + D) multiply-adds a pass) or "moments" (the
    backward with G S0 contracted against the monomials, 1 + D + tri a
    pass, and G W_l against [1, x_l], D (1 + D) a pass, as dgs_tpu's
    _moment_rows contracts both on the MXU; the D multiplies G W_l and the
    laplacian's and the thirds' rows, one FMA each, on the CUDA cores).
    ``passes`` is the TF32 passes of the contraction (3, or 1 under
    fast-math; the moment form is always 3).  The rest is pair_ops' count
    without the work the contraction takes.  This counts the function's
    work, not how a kernel splits it between the two kinds of core."""
    tri = D * (D + 1) // 2
    mr, mp = 1 + D + tri, 1 + D
    has_w = any(o in ("derivative", "laplacian", "third") for o in orders)
    if kind == "separable":
        ops, sfu = pair_ops(D, orders, C, False, False)
        return ops - (D + D * D + D + 1), sfu, passes * (mr + D * mp)
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
