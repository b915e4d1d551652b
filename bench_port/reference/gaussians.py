"""The field's mathematics in plain torch, written from its definition.

    u(x) = sum_i v_i G_i(x),   G = exp(-1/2 X^T Q X),  X = wrap(mu - x)

with Q = R diag(exp(-2 s)) R^T the conic of log-scales s and the rotation
R of an angle (D = 2) or a unit quaternion (D = 3) (``pairs.conics``, in
whatever precision it is given), and a = Q X.  The orders are the value G, the
derivative G a_i, the Hessian G (a_i a_j - Q_ij) and the third
derivative G (Q_ij a_k + Q_ik a_j + Q_jk a_i - a_i a_j a_k), each summed
against the values; a pair whose quadratic form is positive counts zero.
X is the minimum image on the torus of period ``period``.

Blocks are dense: ``evaluate`` takes B groups of S samples against E
Gaussians each (padded rows masked), so that a tile of a binned
configuration and a slab of an all-pairs one are the same call.  The
contraction against the values is a batched matrix product; the
lower-precision control takes it with TF32 operands (``tf32``).
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, List, Sequence, Tuple

import torch

from .pairs import tri_index


def sym_indices(order: str, D: int) -> List[tuple]:
    """The sorted index tuples of an order's distinct components."""
    if order == "value":
        return [()]
    if order == "derivative":
        return [(i,) for i in range(D)]
    if order == "laplacian":
        return [(i, j) for i in range(D) for j in range(i, D)]
    if order == "third":
        return [(i, j, k) for i in range(D) for j in range(i, D)
                for k in range(j, D)]
    raise ValueError(f"unknown order {order!r}")


def full_indices(order: str, D: int) -> List[tuple]:
    """Every index tuple of an order's tensor, row-major."""
    n = {"value": 0, "derivative": 1, "laplacian": 2, "third": 3}[order]
    out = [()]
    for _ in range(n):
        out = [t + (i,) for t in out for i in range(D)]
    return out


def multiplicity(order: str, D: int) -> List[int]:
    """How many tensor positions each distinct component stands for."""
    cnt = Counter(tuple(sorted(t)) for t in full_indices(order, D))
    return [cnt[t] for t in sym_indices(order, D)]


def out_shape(order: str, M: int, D: int, C: int) -> Tuple[int, ...]:
    return (M,) + (D,) * len(full_indices(order, D)[0]) + (C,)


def weights(orders: Sequence[str], X: List[torch.Tensor],
            Q: List[List[torch.Tensor]], mask) -> List[torch.Tensor]:
    """The distinct components of every order, in order, each a tensor of
    the pairs' shape."""
    D = len(X)
    a = [sum(Q[i][j] * X[j] for j in range(D)) for i in range(D)]
    power = -0.5 * sum(a[i] * X[i] for i in range(D))
    G = torch.where((power > 0) | ~mask, 0.0,
                    torch.exp(torch.clamp(power, max=0.0)))
    out = []
    for order in orders:
        for t in sym_indices(order, D):
            if order == "value":
                out.append(G)
            elif order == "derivative":
                out.append(G * a[t[0]])
            elif order == "laplacian":
                i, j = t
                out.append(G * (a[i] * a[j] - Q[i][j]))
            else:
                i, j, k = t
                out.append(G * (Q[i][j] * a[k] + Q[i][k] * a[j]
                                + Q[j][k] * a[i] - a[i] * a[j] * a[k]))
    return out


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 mantissa bits, to nearest, ties to
    even): what a TF32 tensor-core product reads of its operands."""
    i = x.contiguous().view(torch.int32)
    lsb = (i >> 13) & 1
    i = (i + 0xFFF + lsb) & ~0x1FFF
    return i.view(torch.float32)


class _TF32Bmm(torch.autograd.Function):
    """A batched product with TF32 operands and float32 accumulation, its
    gradients the same kind of products."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.bmm(tf32(a), tf32(b))

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = tf32(g)
        return (torch.bmm(g, tf32(b).transpose(1, 2)),
                torch.bmm(tf32(a).transpose(1, 2), g))


def evaluate(orders, x, xmask, mu, con, val, emask, period,
             tf32_products: bool = False):
    """Distinct components summed against the values over B dense blocks:
    samples ``x`` (B, S, D) and Gaussians ``mu`` (B, E, D), packed conics
    ``con`` (B, E, D (D + 1) / 2), values ``val`` (B, E, C); the masks (B, S) and
    (B, E) mark real rows.  Returns (B, S, K, C) with K the orders'
    distinct components in order."""
    D = x.shape[-1]
    diff = mu[:, None, :, :] - x[:, :, None, :]           # (B, S, E, D)
    if period is not None:
        diff = diff - period * torch.round(diff / period)
    X = [diff[..., d] for d in range(D)]
    Q = [[con[:, None, :, tri_index(D, i, j)] for j in range(D)]
         for i in range(D)]
    mask = xmask[:, :, None] & emask[:, None, :]
    W = torch.stack(weights(orders, X, Q, mask), dim=2)   # (B, S, K, E)
    B, S, K, E = W.shape
    bmm = _TF32Bmm.apply if tf32_products else torch.bmm
    return bmm(W.reshape(B, S * K, E), val).reshape(B, S, K, -1)


def unpack(orders, D: int, comps: torch.Tensor) -> Dict[str, torch.Tensor]:
    """(M, K, C) distinct components to each order's full tensor."""
    out, k0 = {}, 0
    M, C = comps.shape[0], comps.shape[-1]
    for order in orders:
        syms = sym_indices(order, D)
        where = {t: k0 + n for n, t in enumerate(syms)}
        idx = [where[tuple(sorted(t))] for t in full_indices(order, D)]
        out[order] = comps[:, idx, :].reshape(out_shape(order, M, D, C))
        k0 += len(syms)
    return out


def loss_weights(orders, D: int, dtype, device) -> torch.Tensor:
    """(K,) multiplicities: the sum of squares of the full tensors is the
    multiplicity-weighted one over the distinct components."""
    return torch.tensor([m for o in orders for m in multiplicity(o, D)],
                        dtype=dtype, device=device)
