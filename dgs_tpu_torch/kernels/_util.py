"""Shape helpers shared by the kernel wrappers."""

from __future__ import annotations

import torch


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _pad_axis(x: torch.Tensor, axis: int, size: int) -> torch.Tensor:
    """Zero-pad ``x`` along ``axis`` up to ``size``."""
    if x.shape[axis] == size:
        return x
    shape = list(x.shape)
    shape[axis] = size - x.shape[axis]
    return torch.cat([x, x.new_zeros(shape)], dim=axis)
