"""GaussianField: the trainable Gaussian-mixture parameterization as an
``nn.Module``.

cov = R diag(exp(2*log_scales)) R^T and conic = cov^{-1} =
R diag(exp(-2*log_scales)) R^T, packed upper-triangular; rotations are none
(D=1), an angle (D=2) or a unit quaternion (D=3), as in
``dgs_tpu/models/field.py``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ..utils import profiling


class GaussianField(nn.Module):
    def __init__(self, means, log_scales, rotations, values):
        super().__init__()
        self.means = nn.Parameter(means)            # (P, D)
        self.log_scales = nn.Parameter(log_scales)  # (P, D)
        self.rotations = nn.Parameter(rotations)    # (P, 0) / (P, 1) / (P, 4)
        self.values = nn.Parameter(values)          # (P, C)

    @classmethod
    def from_numpy(cls, means, log_scales, rotations, values, *,
                   device=None) -> "GaussianField":
        """A field from the four parameter arrays of a ``dgs_tpu`` field
        (or any numpy arrays of those shapes), as float32 on ``device``
        (default: the card, ``torch.device("cuda")``)."""
        device = torch.device("cuda" if device is None else device)
        return cls(*(torch.tensor(np.asarray(a, np.float32), device=device)
                     for a in (means, log_scales, rotations, values)))

    @property
    def P(self) -> int:
        return self.means.shape[0]

    @property
    def D(self) -> int:
        return self.means.shape[1]

    def rotation_matrices(self) -> torch.Tensor:  # (P, D, D)
        D, P = self.D, self.P
        if D == 1:
            return torch.ones((P, 1, 1), dtype=self.means.dtype,
                              device=self.means.device)
        if D == 2:
            t = self.rotations[:, 0]
            c, s = torch.cos(t), torch.sin(t)
            return torch.stack(
                [torch.stack([c, -s], -1), torch.stack([s, c], -1)], -2
            )
        if D == 3:
            q = self.rotations / (
                torch.linalg.norm(self.rotations, dim=-1, keepdim=True) + 1e-12
            )
            w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
            return torch.stack(
                [
                    torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                                 2 * (x * z + w * y)], -1),
                    torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                                 2 * (y * z - w * x)], -1),
                    torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                                 1 - 2 * (x * x + y * y)], -1),
                ],
                -2,
            )
        raise ValueError(f"unsupported D={D}")

    def _packed_quadratic(self, eigs: torch.Tensor) -> torch.Tensor:
        """Packed upper-triangular R diag(eigs) R^T, unrolled over D <= 3."""
        R = self.rotation_matrices()
        D = self.D
        cols = [
            sum(R[:, i, k] * eigs[:, k] * R[:, j, k] for k in range(D))
            for i in range(D)
            for j in range(i, D)
        ]
        return torch.stack(cols, dim=-1)

    def covariances(self) -> torch.Tensor:  # (P, tri)
        with profiling.named_scope("dgs::field"):
            return self._packed_quadratic(torch.exp(2.0 * self.log_scales))

    def conics(self) -> torch.Tensor:  # (P, tri)
        with profiling.named_scope("dgs::field"):
            return self._packed_quadratic(torch.exp(-2.0 * self.log_scales))


def init_field(generator: torch.Generator, P: int, D: int, C: int, *,
               sigma: float = 0.05, value_scale: float = 0.1,
               lower: float = -1.0, upper: float = 1.0) -> GaussianField:
    """A random field on ``generator.device``: uniform means in
    [lower, upper)^D, log-normal scales around ``sigma``, uniform angles
    (D=2) or normal quaternions (D=3), normal values.  The same
    distributions as dgs_tpu's init_field, not the same numbers."""
    kw = dict(generator=generator, device=generator.device,
              dtype=torch.float32)
    means = lower + (upper - lower) * torch.rand((P, D), **kw)
    log_scales = math.log(sigma) + 0.2 * torch.randn((P, D), **kw)
    if D == 1:
        rotations = torch.zeros((P, 0), device=generator.device)
    elif D == 2:
        rotations = 2 * math.pi * torch.rand((P, 1), **kw)
    else:
        rotations = torch.randn((P, 4), **kw)
    values = value_scale * torch.randn((P, C), **kw)
    return GaussianField(means, log_scales, rotations, values)
