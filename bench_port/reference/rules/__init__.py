"""The reference's pair rules, one module a rule, found by a
configuration's ``pair_rule``: ``rules/<pair_rule>.py``.  A rule module
has

- ``plan(config, geometry)``: what the rule fixes once a run from the
  float32 geometry (means, log_scales, rotations) the benchmark made, as
  the program plans once (the tiles an axis of the widest box, or None);
- ``groups(config, plan, geometry, samples, which, budget) -> Groups``:
  the samples ``which`` (all where None) with the Gaussians they pair with;
- ``count(config, plan, geometry, samples) -> dict``: the benchmark's own
  count of a step's work, ``pairs``, ``entries`` and whether the pairs
  need the torus wrap (``wrapped``).
"""

from __future__ import annotations

import importlib
from typing import List, NamedTuple

import torch


class Groups(NamedTuple):
    """Samples grouped with the Gaussians they pair with: group g pairs
    samples ``s_idx[s_ptr[g]:s_ptr[g+1]]`` with Gaussians
    ``e_idx[e_ptr[g]:e_ptr[g+1]]``."""

    s_idx: torch.Tensor
    s_ptr: List[int]
    e_idx: torch.Tensor
    e_ptr: List[int]
    shared: bool = False   # every group pairs with every Gaussian


def load(name: str):
    return importlib.import_module(f"{__name__}.{name}")
