"""The system under test for ``"path": "chunked"``: the chunked sampling
path of ``dgs_tpu_torch`` (``ops.sampling_chunked``) over a
``GaussianField``, planned once by ``plan_chunked``; the sample side binned
once; the Gaussians binned again on every call, as the program does."""

from __future__ import annotations

import torch

from ..inputs import LEAVES


class System:
    def __init__(self, config: dict, inputs: dict, dev: torch.device,
                 fast_math: bool = False):
        from dgs_tpu_torch.config import SamplerConfig
        from dgs_tpu_torch.models.field import GaussianField
        from dgs_tpu_torch.ops import formulas, sampling_chunked

        self.sc = sampling_chunked
        D = config["D"]
        self.samples = inputs["samples"]
        self.N = self.samples.shape[0]
        self.field = GaussianField(*(inputs[k].clone() for k in LEAVES))
        cfg = SamplerConfig(
            period=config["period"], lower=(config["lower"],) * D,
            tile_size=config["tile"], radius_sigma=config["radius_sigma"],
            eig_floor=config["eig_floor"],
            max_tiles_per_gaussian=config["max_tiles_per_gaussian"],
            axis_radii=config["axis_radii"], ellip_cull=config["ellip_cull"],
            fast_math_dots=fast_math)
        with torch.no_grad():
            means = self.field.means.detach()
            cov = self.field.covariances()
        self.cfg, self.plan = sampling_chunked.plan_chunked(
            cfg, means, cov, self.samples, headroom=config["headroom"])
        self.cs = sampling_chunked.chunk_samples(self.cfg, self.samples,
                                                 self.plan, self.cfg.block_n)
        self.mult = {o: torch.tensor(formulas.sym_multiplicity(o, D),
                                     dtype=torch.float32, device=dev)
                     for o in ("value", "derivative", "laplacian", "third")}
        self.geometry = None

    def train_loss(self, orders):
        """(loss, diagnostics sum): the multiplicity-weighted sum of
        squares of the padded tile-sorted outputs over N, which is the sum
        of squares of the full tensors over N."""
        f = self.field
        outs, diag = self.sc.sample_chunked(
            self.cfg, f.means, f.values, f.conics(), f.covariances(),
            self.samples, self.plan, self.cs, tuple(orders),
            padded_outputs=True)
        loss = sum(torch.einsum("ucn,u->", o * o, self.mult[k])
                   for k, o in outs.items()) / self.N
        return loss, sum(v for k, v in diag.items() if k != "perm")

    def evaluate(self, values, orders):
        """(outputs in sample order, diagnostics sum) of the field's fixed
        geometry with ``values``."""
        if self.geometry is None:
            with torch.no_grad():
                f = self.field
                self.geometry = (f.means.detach(), f.conics(),
                                 f.covariances())
        means, con, cov = self.geometry
        outs, diag = self.sc.sample_chunked(
            self.cfg, means, values, con, cov, self.samples, self.plan,
            self.cs, tuple(orders))
        return outs, sum(v for k, v in diag.items() if k != "perm")
