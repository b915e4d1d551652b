"""Closed-form per-pair Gaussian evaluation weights and their VJPs.

The torch counterpart of ``dgs_tpu/ops/formulas.py``:

  field           u(x)    = sum_i v_i * G_i(x),  G = exp(-1/2 X^T C X)
  value           w       = G
  derivative      w_d     = G * a_d
  laplacian       w_ij    = G * (a_i a_j - C_ij)         (full Hessian)
  third           w_ijk   = G * (C_ij a_k + C_ik a_j + C_jk a_i - a_i a_j a_k)

with X = wrap(mu - x) and a = C X; pairs whose quadratic form is positive
are masked to zero.  Every function takes *lists* of tensors with the spatial
dimension and the packed-triangular dimension unrolled in Python, exactly as
the JAX module does, so the two read line for line.  The CUDA kernels' copy
of this math is ``dgs_tpu_torch/csrc/pair_math.cuh``.
"""

from __future__ import annotations

import functools
from collections import Counter
from typing import List, Optional, Sequence

import torch

from ..config import tri_index, tri_size


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


def pairwise_context(means, conics, samples, period: Optional[float]):
    """(Xs, con, G, a) for all (N, P) pairs of samples (N, D) and Gaussians
    (means (P, D), packed conics (P, tri)): the wrapped displacements, the
    broadcast conic entries, G and a = C X."""
    D = samples.shape[1]
    X = wrap(means[None, :, :] - samples[:, None, :], period)
    Xs = [X[..., d] for d in range(D)]
    con = [conics[None, :, t] for t in range(tri_size(D))]
    G, a = power_terms(Xs, con)
    return Xs, con, G, a


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


def _power_dcon(Xs: Sequence, D: int) -> List:
    """d(power)/d(c_t) for each packed index t: -1/2 X_u^2 on the diagonal,
    -X_u X_v off it (the off-diagonal appears twice in X^T C X)."""
    out = [None] * tri_size(D)
    for u in range(D):
        for v in range(u, D):
            t = tri_index(D, u, v)
            out[t] = (-0.5 * Xs[u] * Xs[u]) if u == v else -(Xs[u] * Xs[v])
    return out


def _a_dcon(Xs: Sequence, D: int):
    """da_l/dc_t as a [l][t] table of tensors-or-0.0: t=(u,u) gives
    delta_lu X_u, t=(u,v) gives delta_lu X_v + delta_lv X_u."""
    table = [[0.0] * tri_size(D) for _ in range(D)]
    for u in range(D):
        for v in range(u, D):
            t = tri_index(D, u, v)
            if u == v:
                table[u][t] = Xs[u]
            else:
                table[u][t] = Xs[v]
                table[v][t] = Xs[u]
    return table


def fused_pair_accumulators(orders: Sequence[str], con: Sequence, a,
                            hs: Sequence,
                            lap_polys: Optional[Sequence] = None,
                            third_polys: Optional[Sequence] = None):
    """The collapsed multi-order VJP's shared per-pair accumulators
    (S0, w, hl, Y) of vjp_params_fused, functions of (con, a, hs) only.

    ``hs`` is the flat list of folded unique-component cotangents across
    ``orders`` in sequence.  S0 is the h-weighted component-polynomial sum,
    w[l] the h-weighted dq/da_l sums, hl the laplacian cotangents by packed
    index (None where absent), Y the thirds' explicit conic-derivative
    terms."""
    D = len(a)
    tri = tri_size(D)
    C = lambda i, j: con[tri_index(D, i, j)]

    h0 = None
    hd = [None] * D
    hl = [None] * tri
    h3 = {}  # unique tuple (i<=j<=k) -> folded cotangent
    k0 = 0
    for order in orders:
        nu = n_unique(order, D)
        block = hs[k0:k0 + nu]
        if order == "value":
            h0 = block[0]
        elif order == "derivative":
            for i in range(D):
                hd[i] = block[i]
        elif order == "laplacian":
            for t, (i, j) in enumerate(sym_indices(order, D)):
                hl[tri_index(D, i, j)] = block[t]
        elif order == "third":
            for t, idx in enumerate(sym_indices(order, D)):
                h3[idx] = block[t]
        else:
            raise ValueError(f"unknown order {order!r}")
        k0 += nu

    def acc(x, y):
        return y if x is None else x + y

    lp = {}
    if lap_polys is not None:
        lp = dict(zip(sym_indices("laplacian", D), lap_polys))

    def q_pair(i, j):
        key = (i, j) if i <= j else (j, i)
        if key not in lp:
            lp[key] = a[i] * a[j] - C(i, j)
        return lp[key]

    tp = {}
    if third_polys is not None:
        tp = dict(zip(sym_indices("third", D), third_polys))

    def p_third(idx):
        # The forward's third polynomial, -q_ijk.
        if idx not in tp:
            i, j, k = idx
            tp[idx] = (C(i, j) * a[k] + C(i, k) * a[j] + C(j, k) * a[i]
                       - a[i] * a[j] * a[k])
        return tp[idx]

    # S0 = sum_u h~_u q_u  (third: h~ q = (-h)(-p) = h p).
    S0 = h0
    for i in range(D):
        if hd[i] is not None:
            S0 = acc(S0, hd[i] * a[i])
    if any(h is not None for h in hl):
        for u in range(D):
            for v in range(u, D):
                S0 = acc(S0, hl[tri_index(D, u, v)] * q_pair(u, v))
    for idx, h in h3.items():
        S0 = acc(S0, h * p_third(idx))

    # W_l = sum_u h~_u dq_u/da_l: derivative gives hd_l, laplacian (H a)_l
    # with doubled diagonal, third -h3_ijk (delta_il q_jk + delta_jl q_ik +
    # delta_kl q_ij).
    w = [None] * D
    for l in range(D):
        wl = hd[l]
        for m in range(D):
            t = tri_index(D, l, m)
            if hl[t] is not None:
                scale = 2.0 if l == m else 1.0
                wl = acc(wl, (scale * hl[t]) * a[m])
        w[l] = wl
    for (i, j, k), h in h3.items():
        nh = -h
        w[i] = acc(w[i], nh * q_pair(j, k))
        w[j] = acc(w[j], nh * q_pair(i, k))
        w[k] = acc(w[k], nh * q_pair(i, j))

    # Y_t: the thirds' explicit conic derivatives (+a at matching pairs).
    Y = [None] * tri
    for (i, j, k), h in h3.items():
        Y[tri_index(D, i, j)] = acc(Y[tri_index(D, i, j)], h * a[k])
        Y[tri_index(D, i, k)] = acc(Y[tri_index(D, i, k)], h * a[j])
        Y[tri_index(D, j, k)] = acc(Y[tri_index(D, j, k)], h * a[i])

    return S0, w, hl, Y


def vjp_params_fused(orders: Sequence[str], Xs: Sequence, con: Sequence,
                     G, a, hs: Sequence,
                     lap_polys: Optional[Sequence] = None,
                     third_polys: Optional[Sequence] = None):
    """Collapsed multi-order VJP across any subset of the four orders.

    ``hs`` is the flat list of folded unique-component cotangents across
    ``orders`` in sequence, h_k = sum_c values_c * dL/dout[k, c].  Every
    component is T_u = G q_u (q_0 = 1, q_i = a_i, q_ij = a_i a_j - C_ij,
    q_ijk = a_i a_j a_k - C_ij a_k - C_ik a_j - C_jk a_i; the "third"
    component is -q_ijk), so the weighted cotangent sum telescopes into
    the accumulators of fused_pair_accumulators:

        dmu_d      = G ((C W)_d - a_d S0)
        z_l        = W_l - 1/2 X_l S0
        dcon_(u,v) = G (X_v z_u + X_u z_v - hl_uv + Y_uv)

    Returns (dmu, dcon): lists of D and tri per-pair tensors.  At D=1 the
    third-order conic gradient is the derivative of this package's own
    forward (dgs_tpu's form; the CUDA reference's backward.cu:322-325 is
    not, see docs/PARITY.md)."""
    D = len(Xs)
    tri = tri_size(D)
    C = lambda i, j: con[tri_index(D, i, j)]

    def acc(x, y):
        return y if x is None else x + y

    S0, w, hl, Y = fused_pair_accumulators(
        orders, con, a, hs, lap_polys, third_polys)
    half_S0 = 0.5 * S0

    dmu = []
    for d in range(D):
        md = None
        for l in range(D):
            if w[l] is not None:
                md = acc(md, C(d, l) * w[l])
        md = acc(md, -(a[d] * S0))
        dmu.append(G * md)

    z = [
        (-(Xs[l] * half_S0)) if w[l] is None else (w[l] - Xs[l] * half_S0)
        for l in range(D)
    ]
    dcon = [None] * tri
    for u in range(D):
        for v in range(u, D):
            t = tri_index(D, u, v)
            if u == v:
                term = Xs[u] * z[u]
            else:
                term = Xs[v] * z[u] + Xs[u] * z[v]
            if hl[t] is not None:
                term = term - hl[t]
            if Y[t] is not None:
                term = term + Y[t]
            dcon[t] = G * term
    return dmu, dcon


def vjp_params(order: str, Xs: Sequence, con: Sequence, G, a, hs: Sequence):
    """Per-pair VJP contributions (dmu, dcon) of one order, per full
    row-major component (``hs`` as ``components``: h = sum_c values_c *
    dL/dout[comp, c]).  The cotangents of mirrored positions are added
    into their unique component, in component order, and handed to
    vjp_params_folded."""
    D = len(Xs)
    folded = [None] * n_unique(order, D)
    for h, u in zip(hs, full_to_unique(order, D)):
        folded[u] = h if folded[u] is None else folded[u] + h
    return vjp_params_folded(order, Xs, con, G, a, folded)


def vjp_params_folded(order: str, Xs: Sequence, con: Sequence, G, a,
                      hs: Sequence):
    """vjp_params over the unique components with FOLDED cotangents.

    ``hs[u]`` holds the sum of the full tensor's cotangents over every
    position that mirrors unique component u (the transpose of the
    symmetric expansion).  Valid because every per-component VJP term is
    symmetric in the component's indices.  The component-by-component form
    of vjp_params_fused, from dw/dmu_d = G (-a_d p + dp/dmu_d) and
    dw/dc_t = G (s_t p + dp/dc_t) with s_t = d(power)/dc_t."""
    D = len(Xs)
    tri = tri_size(D)
    C = lambda i, j: con[tri_index(D, i, j)]
    s = _power_dcon(Xs, D)
    da = _a_dcon(Xs, D)

    dmu = [0.0] * D
    dcon = [0.0] * tri

    for idx, h in zip(sym_indices(order, D), hs):
        hG = h * G
        if order == "value":
            for d in range(D):
                dmu[d] = dmu[d] - hG * a[d]
            for t in range(tri):
                dcon[t] = dcon[t] + hG * s[t]
        elif order == "derivative":
            (i,) = idx
            for d in range(D):
                dmu[d] = dmu[d] + hG * (C(i, d) - a[d] * a[i])
            for t in range(tri):
                dcon[t] = dcon[t] + hG * (s[t] * a[i] + da[i][t])
        elif order == "laplacian":
            i, j = idx
            p = a[i] * a[j] - C(i, j)
            for d in range(D):
                dmu[d] = dmu[d] + hG * (
                    C(i, d) * a[j] + C(j, d) * a[i] - a[d] * p)
            tij = tri_index(D, i, j)
            for t in range(tri):
                dp = da[i][t] * a[j] + da[j][t] * a[i]
                if t == tij:
                    dp = dp - 1.0
                dcon[t] = dcon[t] + hG * (s[t] * p + dp)
        else:  # third
            i, j, k = idx
            p = (C(i, j) * a[k] + C(i, k) * a[j] + C(j, k) * a[i]
                 - a[i] * a[j] * a[k])
            for d in range(D):
                dp_dmu = (
                    C(i, j) * C(k, d)
                    + C(i, k) * C(j, d)
                    + C(j, k) * C(i, d)
                    - C(i, d) * a[j] * a[k]
                    - a[i] * C(j, d) * a[k]
                    - a[i] * a[j] * C(k, d)
                )
                dmu[d] = dmu[d] + hG * (dp_dmu - a[d] * p)
            tij = tri_index(D, i, j)
            tik = tri_index(D, i, k)
            tjk = tri_index(D, j, k)
            for t in range(tri):
                dp = (
                    C(i, j) * da[k][t]
                    + C(i, k) * da[j][t]
                    + C(j, k) * da[i][t]
                    - da[i][t] * a[j] * a[k]
                    - a[i] * da[j][t] * a[k]
                    - a[i] * a[j] * da[k][t]
                )
                if t == tij:
                    dp = dp + a[k]
                if t == tik:
                    dp = dp + a[j]
                if t == tjk:
                    dp = dp + a[i]
                dcon[t] = dcon[t] + hG * (s[t] * p + dp)
    return dmu, dcon


# ---------------------------------------------------------------------------
# Monomial expansion of the component polynomials (the folded-values form)
#
# Every component weight is G q_u with q_u a polynomial in X = mu_l - x_l.
# In tile-local coordinates q_u expands exactly over the raw monomials of
# the sample coordinate x_l, with coefficients that depend on the entry
# (mu_l, conic) only.  Folding values_c * coefficient into per-entry rows
# turns the K value contractions of a pair block into one contraction
# whose other operand is G alone (kernels/tiled.py tiled_forward_folded).
# ---------------------------------------------------------------------------


ORDER_DEGREE = {"value": 0, "derivative": 1, "laplacian": 2, "third": 3}


def monomials_upto(D: int, deg: int):
    """Exponent tuples of the raw monomial basis in D variables up to
    degree ``deg``, by degree then canonical index order: [1] + [x_d] +
    [x_i x_j, i <= j] + [x_i x_j x_k, i <= j <= k].  The degree-1 rows sit
    at 1..D (the kernels read tile-local x from them)."""
    def unit(d):
        return tuple(1 if m == d else 0 for m in range(D))

    def add(*es):
        return tuple(sum(x) for x in zip(*es))

    out = [tuple(0 for _ in range(D))]
    if deg >= 1:
        out += [unit(d) for d in range(D)]
    if deg >= 2:
        out += [add(unit(i), unit(j)) for i in range(D) for j in range(i, D)]
    if deg >= 3:
        out += [add(unit(i), unit(j), unit(k)) for i in range(D)
                for j in range(i, D) for k in range(j, D)]
    return out


def _poly_add(p, q):
    out = dict(p)
    for e, c in q.items():
        out[e] = out[e] + c if e in out else c
    return out


def _poly_mul(p, q):
    out = {}
    for e1, c1 in p.items():
        for e2, c2 in q.items():
            e = tuple(a + b for a, b in zip(e1, e2))
            out[e] = out[e] + c1 * c2 if e in out else c1 * c2
    return out


def _a_polys(D: int, mu: Sequence, con: Sequence):
    """a_d = (C mu)_d - sum_l C_dl x_l as x-polynomials (dicts)."""
    C = lambda i, j: con[tri_index(D, i, j)]
    zero = tuple(0 for _ in range(D))
    A = []
    for d in range(D):
        p = {zero: sum(C(d, l) * mu[l] for l in range(D))}
        for l in range(D):
            p[tuple(1 if m == l else 0 for m in range(D))] = -C(d, l)
        A.append(p)
    return A


def component_coeff_polys(orders: Sequence[str], D: int, mu: Sequence,
                          con: Sequence):
    """Per unique component (across ``orders`` in sequence) a dict from
    monomial exponent tuple to per-entry coefficient, such that
    q_u(X) == sum_m coeff_m(mu, con) x^m with X_l = mu_l - x_l.  ``mu`` is
    the list of D tile-local mean rows, ``con`` the packed conic rows.  The
    key sets are structural (the algebra never drops a key), so
    folded_structure derives the static layout from a run on zeros."""
    C = lambda i, j: con[tri_index(D, i, j)]
    zero = tuple(0 for _ in range(D))
    A = _a_polys(D, mu, con)
    out = []
    for order in orders:
        for idx in sym_indices(order, D):
            if order == "value":
                out.append({zero: 1.0})
            elif order == "derivative":
                out.append(dict(A[idx[0]]))
            elif order == "laplacian":
                i, j = idx
                out.append(_poly_add(_poly_mul(A[i], A[j]),
                                     {zero: -C(i, j)}))
            else:  # third
                i, j, k = idx
                p = _poly_mul(_poly_mul(A[i], A[j]), A[k])
                p = {e: -c for e, c in p.items()}
                for (u, v, w) in ((i, j, k), (i, k, j), (j, k, i)):
                    p = _poly_add(p, {e: C(u, v) * c for e, c in A[w].items()})
                out.append(p)
    return out


def comp_flat_index(orders: Sequence[str], D: int):
    """(order, canonical index tuple) -> flat unique-component index across
    ``orders`` in sequence."""
    idx, k0 = {}, 0
    for order in orders:
        for t, sidx in enumerate(sym_indices(order, D)):
            idx[(order, sidx)] = k0 + t
        k0 += n_unique(order, D)
    return idx


def w_coeff_polys(orders: Sequence[str], D: int, mu: Sequence,
                  con: Sequence):
    """The fused VJP's W_l accumulators expanded over the (component,
    sample-monomial) basis: a list over l of dicts {(flat component k,
    exponent) -> per-entry coefficient} with
      W_l(p, n) = sum_(k, e) coeff(p) x^e(n) h_k(p, n),
    which is W_l = sum_u h_u dq_u/da_l (the doubled laplacian diagonal,
    the thirds' negated products).  Every exponent lies in component k's own
    monomial set, so the rows align with folded_structure's layout."""
    C = lambda i, j: con[tri_index(D, i, j)]
    zero = tuple(0 for _ in range(D))
    A = _a_polys(D, mu, con)
    idx = comp_flat_index(orders, D)
    out = [dict() for _ in range(D)]

    def add(l, comp_key, poly, scale=1.0):
        if comp_key not in idx:
            return
        k = idx[comp_key]
        for e, c in poly.items():
            term = c * scale if scale != 1.0 else c
            key = (k, e)
            out[l][key] = (out[l][key] + term) if key in out[l] else term

    for l in range(D):
        add(l, ("derivative", (l,)), {zero: 1.0})
        for m in range(D):
            add(l, ("laplacian", tuple(sorted((l, m)))), A[m],
                2.0 if l == m else 1.0)
    if "third" in orders:
        def q_pair(j, k):
            return _poly_add(_poly_mul(A[j], A[k]), {zero: -C(j, k)})

        for i in range(D):
            for j in range(i, D):
                for k in range(j, D):
                    comp = ("third", (i, j, k))
                    add(i, comp, q_pair(j, k), -1.0)
                    add(j, comp, q_pair(i, k), -1.0)
                    add(k, comp, q_pair(i, j), -1.0)
    return out


@functools.lru_cache(maxsize=None)
def folded_structure(orders: Sequence[str], D: int):
    """Static layout of the folded scheme: (meta, n_mono).  ``meta`` has
    one tuple a unique component (across ``orders``) of the raw-monomial
    row indices (into monomials_upto(D, deg)) its polynomial uses, in basis
    order; the folded row count is C * sum(len(m) for m in meta), rows
    (component, monomial, channel) with the channel fastest."""
    deg = max(ORDER_DEGREE[o] for o in orders)
    basis = monomials_upto(D, deg)
    index = {e: i for i, e in enumerate(basis)}
    polys = component_coeff_polys(orders, D, [0.0] * D,
                                  [0.0] * tri_size(D))
    meta = tuple(tuple(sorted(index[e] for e in p)) for p in polys)
    return meta, len(basis)
