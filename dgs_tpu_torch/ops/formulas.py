"""Closed-form per-pair Gaussian evaluation weights (forward half).

The torch counterpart of ``dgs_tpu/ops/formulas.py``:

  field           u(x)    = sum_i v_i * G_i(x),  G = exp(-1/2 X^T C X)
  value           w       = G
  derivative      w_d     = G * a_d
  laplacian       w_ij    = G * (a_i a_j - C_ij)         (full Hessian)
  third           w_ijk   = G * (C_ij a_k + C_ik a_j + C_jk a_i - a_i a_j a_k)

with X = wrap(mu - x) and a = C X; pairs whose quadratic form is positive
are masked to zero.  Every function takes *lists* of tensors with the spatial
dimension and the packed-triangular dimension unrolled in Python, exactly as
the JAX module does, so the two read line for line.  The CUDA kernel's copy
of this math is ``dgs_tpu_torch/csrc/pair_math.cuh``.
"""

from __future__ import annotations

from collections import Counter
from typing import List, Optional, Sequence

import torch

from ..config import tri_index


def wrap(X, period: Optional[float]):
    """Minimum-image displacement on a torus: X mapped into
    [-period/2, period/2] (round half to even, as jnp.round)."""
    if period is None:
        return X
    return X - period * torch.round(X / period)


def conic_apply(Xs: Sequence, con: Sequence, D: int) -> List:
    """a = C @ X for packed-triangular C; returns a list of D tensors."""
    return [
        sum(con[tri_index(D, l, m)] * Xs[m] for m in range(D)) for l in range(D)
    ]


def power_terms(Xs: Sequence, con: Sequence):
    """(G, a) for a batch of pairs; G = exp(-1/2 X^T C X), zero where the
    quadratic form is positive."""
    D = len(Xs)
    a = conic_apply(Xs, con, D)
    power = sum(a[l] * Xs[l] for l in range(D)) * (-0.5)
    G = torch.where(power > 0, 0.0, torch.exp(torch.clamp(power, max=0.0)))
    return G, a


def components(order: str, Xs: Sequence, con: Sequence, G, a) -> List:
    """Per-pair evaluation weights, row-major over tensor indices (the
    symmetric off-diagonals duplicated)."""
    D = len(Xs)
    C = lambda i, j: con[tri_index(D, i, j)]
    if order == "value":
        return [G]
    if order == "derivative":
        return [G * a[i] for i in range(D)]
    if order == "laplacian":
        return [G * (a[i] * a[j] - C(i, j)) for i in range(D) for j in range(D)]
    if order == "third":
        return [
            G
            * (
                C(i, j) * a[k]
                + C(i, k) * a[j]
                + C(j, k) * a[i]
                - a[i] * a[j] * a[k]
            )
            for i in range(D)
            for j in range(D)
            for k in range(D)
        ]
    raise ValueError(f"unknown order {order!r}")


def sym_indices(order: str, D: int) -> List[tuple]:
    """Canonical (sorted) index tuples of the order's unique components."""
    if order == "value":
        return [()]
    if order == "derivative":
        return [(i,) for i in range(D)]
    if order == "laplacian":
        return [(i, j) for i in range(D) for j in range(i, D)]
    if order == "third":
        return [
            (i, j, k)
            for i in range(D)
            for j in range(i, D)
            for k in range(j, D)
        ]
    raise ValueError(f"unknown order {order!r}")


def n_unique(order: str, D: int) -> int:
    return len(sym_indices(order, D))


def full_to_unique(order: str, D: int) -> List[int]:
    """Unique-component index for each full row-major component position."""
    uniq = {t: n for n, t in enumerate(sym_indices(order, D))}
    if order == "value":
        return [0]
    if order == "derivative":
        return [uniq[(i,)] for i in range(D)]
    if order == "laplacian":
        return [
            uniq[tuple(sorted((i, j)))] for i in range(D) for j in range(D)
        ]
    if order == "third":
        return [
            uniq[tuple(sorted((i, j, k)))]
            for i in range(D)
            for j in range(D)
            for k in range(D)
        ]
    raise ValueError(f"unknown order {order!r}")


def sym_multiplicity(order: str, D: int) -> List[int]:
    """How many full-tensor positions each unique component mirrors to."""
    cnt = Counter(full_to_unique(order, D))
    return [cnt[u] for u in range(n_unique(order, D))]


def unique_diag_indices(D: int) -> List[int]:
    """Unique-component indices of the Hessian diagonal (for traces)."""
    uniq = {t: n for n, t in enumerate(sym_indices("laplacian", D))}
    return [uniq[(d, d)] for d in range(D)]


def _component_weight(order, idx, C, a, G):
    """The per-pair weight of one component, by index tuple."""
    if order == "value":
        return G
    if order == "derivative":
        (i,) = idx
        return G * a[i]
    if order == "laplacian":
        i, j = idx
        return G * (a[i] * a[j] - C(i, j))
    i, j, k = idx
    return G * (
        C(i, j) * a[k] + C(i, k) * a[j] + C(j, k) * a[i]
        - a[i] * a[j] * a[k]
    )


def components_unique(order: str, Xs: Sequence, con: Sequence, G, a) -> List:
    """Per-pair weights of the unique (canonical-index) components only."""
    D = len(Xs)
    C = lambda i, j: con[tri_index(D, i, j)]
    return [_component_weight(order, t, C, a, G) for t in sym_indices(order, D)]


def component_polys(order: str, Xs: Sequence, con: Sequence, a) -> List:
    """The unique components' pre-exponential polynomials (T_u / G)."""
    D = len(Xs)
    C = lambda i, j: con[tri_index(D, i, j)]
    if order == "value":
        return [1.0]
    if order == "derivative":
        return [a[i] for i in range(D)]
    if order == "laplacian":
        return [a[i] * a[j] - C(i, j) for i, j in sym_indices(order, D)]
    if order == "third":
        return [
            C(i, j) * a[k] + C(i, k) * a[j] + C(j, k) * a[i]
            - a[i] * a[j] * a[k]
            for i, j, k in sym_indices(order, D)
        ]
    raise ValueError(f"unknown order {order!r}")
