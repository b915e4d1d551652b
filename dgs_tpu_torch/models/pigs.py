"""PIGS-style evaluation of a GaussianField (the evaluation half of
``dgs_tpu/models/pigs.py``; the training loop needs the tiled backward kernel
and comes with it)."""

from __future__ import annotations

from ..config import SamplerConfig
from ..ops import sampling
from .field import GaussianField


def field_outputs(cfg: SamplerConfig, field: GaussianField, samples,
                  orders=("value", "derivative", "laplacian"),
                  method: str = "tiled", sorted_outputs: bool = False,
                  unique_outputs: bool = False,
                  padded_outputs: bool = False, sample_binning=None):
    """Bin once, evaluate the requested orders; returns (outputs dict,
    diagnostics dict) as ops.sampling.sample_binned."""
    if method != "tiled":
        raise NotImplementedError(
            f"field_outputs(method={method!r}) is not ported to "
            "dgs_tpu_torch yet: ROADMAP.md item 10 (dense kernel path)")
    return sampling.sample_binned(
        cfg, field.means, field.values, field.conics(), field.covariances(),
        samples, tuple(orders), sorted_outputs=sorted_outputs,
        unique_outputs=unique_outputs, padded_outputs=padded_outputs,
        sample_binning=sample_binning,
    )
