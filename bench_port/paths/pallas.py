"""The system under test for ``"path": "pallas"``: every sample against
every Gaussian through the facade ``GaussianSampler(method="pallas")``
(the dense CUDA kernels; the method's name is the JAX package's):
``preprocess`` with the field's tensors, then ``sample_all``."""

from __future__ import annotations

import torch

from ..inputs import LEAVES


class System:
    def __init__(self, config: dict, inputs: dict, dev: torch.device,
                 fast_math: bool = False):
        from dgs_tpu_torch.config import SamplerConfig
        from dgs_tpu_torch.models.field import GaussianField
        from dgs_tpu_torch.sampler import GaussianSampler

        if fast_math:
            raise ValueError("the all-pairs path has no lower-precision mode")
        D = config["D"]
        self.samples = inputs["samples"]
        self.N = self.samples.shape[0]
        self.field = GaussianField(*(inputs[k].clone() for k in LEAVES))
        self.sampler = GaussianSampler(
            method="pallas",
            config=SamplerConfig(period=config["period"],
                                 lower=(config["lower"],) * D,
                                 eig_floor=config["eig_floor"],
                                 radius_sigma=config["radius_sigma"]))
        self.zero = torch.zeros((), dtype=torch.int32, device=dev)
        self.geometry = None

    def train_loss(self, orders):
        f = self.field
        self.sampler.preprocess(f.means, f.values, f.covariances(),
                                f.conics(), self.samples)
        outs = self.sampler.sample_all(tuple(orders))
        return sum(torch.sum(o * o) for o in outs.values()) / self.N, self.zero

    def evaluate(self, values, orders):
        if self.geometry is None:
            with torch.no_grad():
                f = self.field
                self.geometry = (f.means.detach(), f.covariances(),
                                 f.conics())
        means, cov, con = self.geometry
        self.sampler.preprocess(means, values, cov, con, self.samples)
        return self.sampler.sample_all(tuple(orders)), self.zero
