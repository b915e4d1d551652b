"""The inputs of a run, made on the device from the seed.

A field of P Gaussians in D = 1, 2 or 3 drawn as the program's
``init_field`` draws one (uniform means on the periodic domain, log-normal
scales around the configuration's sigma, no rotation, a uniform angle or a
normal quaternion, normal values), N uniform samples, and for an
evaluation mix a pool of value sets, each in one call of a generator on
the card.  The same seed gives the same inputs; the reference and the
program are handed the same tensors.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

LEAVES = ("means", "log_scales", "rotations", "values")


def rotations(P: int, D: int, gen: torch.Generator, kw: dict):
    if D == 1:
        return torch.zeros((P, 0), **kw)
    if D == 2:
        return 2 * math.pi * torch.rand((P, 1), generator=gen, **kw)
    return torch.randn((P, 4), generator=gen, **kw)


def make(config: dict, traffic: dict, seed: int,
         dev: torch.device) -> Dict[str, torch.Tensor]:
    P, N, D, C = config["P"], config["N"], config["D"], config["C"]
    lo, period = config["lower"], config["period"]
    kw = dict(device=dev, dtype=torch.float32)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    out = {
        "means": lo + period * torch.rand((P, D), generator=gen, **kw),
        "log_scales": (math.log(config["sigma"])
                       + config["log_scale_spread"]
                       * torch.randn((P, D), generator=gen, **kw)),
        "rotations": rotations(P, D, gen, kw),
        "values": config["value_scale"] * torch.randn((P, C), generator=gen,
                                                      **kw),
        "samples": lo + period * torch.rand((N, D), generator=gen, **kw),
    }
    if traffic["kind"] == "eval":
        out["pool"] = config["value_scale"] * torch.randn(
            (traffic["pool"], P, C), generator=gen, **kw)
    return out
