"""Dense O(N*P) torch oracle for Gaussian mixture evaluation.

The counterpart of ``dgs_tpu/oracle/dense.py``: every (sample, gaussian)
pair contributes unless ``pair_mask`` restricts the pairs to a binning's.
Plain torch, so autograd differentiates it; the radii decide the binning's
footprints and must match the JAX package's to the bit on the integer side.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..config import ORDERS, out_shape, tri_index, tri_size
from ..ops import formulas


def evaluate(
    order: str,
    means: torch.Tensor,    # (P, D)
    values: torch.Tensor,   # (P, C)
    conics: torch.Tensor,   # (P, tri_size(D))
    samples: torch.Tensor,  # (N, D)
    *,
    period: Optional[float] = 2.0,
    pair_mask: Optional[torch.Tensor] = None,  # (N, P) bool
) -> torch.Tensor:
    """One derivative order at all sample points: value (N,C), derivative
    (N,D,C), laplacian (N,D,D,C), third (N,D,D,D,C)."""
    N, D = samples.shape
    P, C = values.shape
    X = formulas.wrap(means[None, :, :] - samples[:, None, :], period)
    Xs = [X[..., d] for d in range(D)]
    con = [conics[None, :, t] for t in range(tri_size(D))]
    G, a = formulas.power_terms(Xs, con)
    if pair_mask is not None:
        G = G * pair_mask.to(G.dtype)
    comps = formulas.components(order, Xs, con, G, a)
    W = torch.stack(comps, dim=1)  # (N, n_comp, P)
    out = torch.einsum("nkp,pc->nkc", W, values)
    return out.reshape(out_shape(order, N, D, C))


def evaluate_all(means, values, conics, samples, *, period=2.0,
                 pair_mask=None):
    """All four orders."""
    return {
        order: evaluate(order, means, values, conics, samples,
                        period=period, pair_mask=pair_mask)
        for order in ORDERS
    }


def radii(covariances: torch.Tensor, D: int, radius_sigma: float = 3.0,
          eig_floor: float = 1e-6) -> torch.Tensor:
    """Per-Gaussian footprint radius = radius_sigma * sqrt(lambda_max(cov)),
    zero for a (numerically) singular covariance (the det == 0 cull)."""
    cov = covariances
    if D == 1:
        return radius_sigma * torch.sqrt(torch.clamp(cov[:, 0], min=0.0))
    if D == 2:
        det = cov[:, 0] * cov[:, 2] - cov[:, 1] ** 2
        mid = 0.5 * (cov[:, 0] + cov[:, 2])
        lam = mid + torch.sqrt(torch.clamp(mid * mid - det, min=eig_floor))
        r = radius_sigma * torch.sqrt(torch.clamp(lam, min=0.0))
        # A relative epsilon: fused and unfused products round differently,
        # so an exactly singular matrix can come out at det = +/-eps.
        scale = torch.abs(cov[:, 0] * cov[:, 2]) + cov[:, 1] ** 2 + 1e-30
        return torch.where(torch.abs(det) <= 1e-6 * scale, 0.0, r)
    if D == 3:
        # Packed [c00,c01,c02,c11,c12,c22]; trigonometric closed form of the
        # largest eigenvalue of a symmetric 3x3 matrix.
        A00, A01, A02, A11, A12, A22 = (cov[:, t] for t in range(6))
        q = (A00 + A11 + A22) / 3.0
        B00, B11, B22 = A00 - q, A11 - q, A22 - q
        p2 = (
            B00 * B00 + B11 * B11 + B22 * B22
            + 2.0 * (A01 * A01 + A02 * A02 + A12 * A12)
        ) / 6.0
        p = torch.sqrt(torch.clamp(p2, min=1e-30))
        detB = (
            B00 * (B11 * B22 - A12 * A12)
            - A01 * (A01 * B22 - A12 * A02)
            + A02 * (A01 * A12 - B11 * A02)
        )
        r = torch.clamp(detB / (2.0 * p * p * p), -1.0, 1.0)
        phi = torch.arccos(r) / 3.0
        lam = q + 2.0 * p * torch.cos(phi)
        return radius_sigma * torch.sqrt(torch.clamp(lam, min=0.0))
    raise ValueError(f"unsupported D={D}")


def radii_axis(covariances: torch.Tensor, D: int, radius_sigma: float = 3.0,
               eig_floor: float = 1e-6) -> torch.Tensor:
    """(P, D) per-axis radii: the tight axis-aligned box of the
    radius_sigma ellipsoid (half-width radius_sigma * sqrt(cov_dd)); rows
    culled by ``radii`` are zero on every axis."""
    diag = torch.stack(
        [covariances[:, tri_index(D, d, d)] for d in range(D)], dim=1)
    r = radius_sigma * torch.sqrt(torch.clamp(diag, min=0.0))
    culled = radii(covariances, D, radius_sigma, eig_floor) <= 0.0
    return torch.where(culled[:, None], 0.0, r)
