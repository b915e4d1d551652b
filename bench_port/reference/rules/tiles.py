"""``"pair_rule": "tiles"``: a pair counts where the Gaussian's box, cut by
the ellipsoid cull, covers the sample's tile (``pairs.py``, frozen); the
configuration's ``tile``, ``radius_sigma``, ``eig_floor``, ``axis_radii``
and ``ellip_cull`` say which box and which cull."""

from __future__ import annotations

import torch

from .. import pairs
from . import Groups


def plan(config: dict, geometry) -> int:
    return pairs.extent(pairs.rule_of(config), *geometry)


def groups(config: dict, R: int, geometry, samples, which,
           budget: int) -> Groups:
    """One group a tile: its samples, and the Gaussians whose entries the
    rule keeps there."""
    rule = pairs.rule_of(config)
    dev = samples.device
    idx = (torch.arange(samples.shape[0], device=dev) if which is None
           else which)
    ents = pairs.entries(rule, *geometry, R)
    st = pairs.sample_tiles(rule.grid, samples[idx]).long()
    order = torch.argsort(st, stable=True)
    idx, st = idx[order], st[order]
    s_start = torch.searchsorted(st, torch.arange(rule.grid.tiles + 1,
                                                  device=dev))
    return Groups(idx, s_start.tolist(), ents.gid, ents.start.tolist())


def count(config: dict, R: int, geometry, samples) -> dict:
    rule = pairs.rule_of(config)
    ents = pairs.entries(rule, *geometry, R)
    st = pairs.sample_tiles(rule.grid, samples)
    rad = float(pairs.radii(rule, *geometry[1:]).max())
    return {"pairs": pairs.pair_count(ents, st, rule.grid.tiles),
            "entries": int(ents.gid.shape[0]),
            "wrapped": not rad + rule.grid.tile < config["period"] / 2.0}
