"""The yardstick: the card's peaks and the least work of a pair, frozen.

The least time of a kernel is the larger of its operations over the card's
peak rate for their kind and its bytes over the memory rate; a share of a
roofline is that least time over the time measured.  The counts are the
function's work (what a pair needs at the least), never what a kernel
issues, so that a faster kernel raises its share and a kernel that counts
more work cannot.  The work of a step is the pairs the configuration's
rule keeps, counted by the benchmark from its own inputs at set-up
(``reference.pairs``), or P N where every pair counts.

Peaks: NVIDIA H100 SXM data sheet at its 700 W power limit (a card set
lower runs slower under load; the harness reports the limit beside every
share): 3.35 TB/s of HBM, 67 TFLOP/s fp32 outside the tensor cores (two
operations a fused multiply-add, so 33.5e12 fp32 instructions/s), and 16
special-function results per clock per SM on 132 SMs at 1.98 GHz.
"""

from __future__ import annotations

MEM_BYTES_S = 3.35e12
FP32_INSTR_S = 67e12 / 2
SFU_OPS_S = 16 * 132 * 1.98e9

_UNIQUE = {"value": lambda D: 1, "derivative": lambda D: D,
           "laplacian": lambda D: D * (D + 1) // 2,
           "third": lambda D: D * (D + 1) * (D + 2) // 6}


def distinct(orders, D: int) -> int:
    """Distinct components across the orders."""
    return sum(_UNIQUE[o](D) for o in orders)


def pair_ops(D: int, orders, C: int, wrapped: bool, backward: bool):
    """(fp32 instructions, special-function operations) one kept pair needs
    at the least (an FMA, a multiply or an add is one instruction; the
    pair's geometry once however many channel passes a kernel makes; the
    polynomials q_ij = a_i a_j - C_ij once, shared by the weights and the
    backward; the backward's S0 one FMA a component from the weights)."""
    tri, n3 = D * (D + 1) // 2, D * (D + 1) * (D + 2) // 6
    K = distinct(orders, D)
    ops = D + (3 * D if wrapped else 0)   # X = mu - x; x/period, round, fma
    ops += D * D + D + 1                  # a = C X; power = -1/2 a.X
    ops += 1                              # exp(power) = ex2(power * log2 e)
    if "laplacian" in orders or "third" in orders:
        ops += tri                        # q_ij
    weights = {"value": 0, "derivative": D, "laplacian": tri,
               "third": 4 * n3}
    ops += sum(weights[o] for o in orders)
    if not backward:
        return ops + K * C, 1             # acc[k][c] += w_k v_c
    ops += 2 * K * C                      # h_k += g v_c; dv_c += g w_k
    vjp = {"value": 1, "derivative": 2 * D, "laplacian": 3 * tri,
           "third": 7 * n3}
    ops += sum(vjp[o] for o in orders)
    return ops + D * (D + 3) + 2 * D + 1 + 5 * tri, 1   # dmu, z, dcon


def kernel_bound_s(pairs: int, n_floats: int, D: int, orders, C: int,
                   wrapped: bool, backward: bool) -> float:
    """The least seconds for ``pairs`` kept pairs and ``n_floats`` fp32
    values moved (each input read once, each output written once)."""
    ops, sfu = pair_ops(D, orders, C, wrapped, backward)
    return max(pairs * ops / FP32_INSTR_S, pairs * sfu / SFU_OPS_S,
               4 * n_floats / MEM_BYTES_S)


def moved_floats(D: int, orders, C: int, P_or_E: int, N: int,
                 backward: bool) -> int:
    """fp32 values a forward (backward) pass moves at the least: each
    Gaussian row (mean, conic, values) and sample read once, the outputs
    written once; the backward also reads the output's cotangent and
    writes a gradient row a Gaussian."""
    tri = D * (D + 1) // 2
    K = distinct(orders, D)
    n = P_or_E * (D + tri + C) + N * D + K * C * N
    if backward:
        n += K * C * N + P_or_E * (D + tri + C)
    return n


def step_ops(pairs: int, D: int, orders, C: int, wrapped: bool,
             backward: bool) -> float:
    """fp32 instructions of a step's pairs: the forward, and with
    ``backward`` the backward too."""
    ops = pairs * pair_ops(D, orders, C, wrapped, False)[0]
    if backward:
        ops += pairs * pair_ops(D, orders, C, wrapped, True)[0]
    return float(ops)
