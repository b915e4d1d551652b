"""``"pair_rule": "all"``: every sample pairs with every Gaussian."""

from __future__ import annotations

import torch

from . import Groups


def plan(config: dict, geometry) -> None:
    return None


def groups(config: dict, plan, geometry, samples, which,
           budget: int) -> Groups:
    """Slabs of samples of about ``budget`` pairs, each with every
    Gaussian."""
    dev = samples.device
    idx = (torch.arange(samples.shape[0], device=dev) if which is None
           else which)
    P = geometry[0].shape[0]
    slab = max(1, budget // P)
    ptr = list(range(0, idx.shape[0], slab)) + [idx.shape[0]]
    return Groups(idx, ptr, torch.arange(P, device=dev), [0, P], True)


def count(config: dict, plan, geometry, samples) -> dict:
    P, N = geometry[0].shape[0], samples.shape[0]
    return {"pairs": P * N, "entries": P, "wrapped": True}
