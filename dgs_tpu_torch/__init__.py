"""PyTorch + CUDA port of the dgs_tpu Gaussian sampling engine.

The tile-binned path and the all-pairs (dense) path, evaluation and
training: ``GaussianSampler`` (methods "tiled", "pallas" and "dense"), the
functional ``sample_binned``, ``sample`` / ``sample_all`` and the
module-level forms below, and the PIGS trainer (``models.pigs``), with the
tiled and the dense forward and backward passes as hand-written Hopper CUDA
kernels.  Imports torch and numpy only; the JAX package ``dgs_tpu`` is the
reference this port is tested against.
"""

from .config import SamplerConfig, ORDERS, tri_size, tri_index  # noqa: F401
from .sampler import GaussianSampler  # noqa: F401
from .ops.sampling import (  # noqa: F401
    sample,
    sample_all,
    sample_binned,
    sample_dense_multi,
    sample_pallas_multi,
)
from .binning.grid import bin_samples, build as preprocess_gaussians  # noqa: F401


def sample_gaussians(means, values, conics, samples, **kw):
    """Field values (N, C)."""
    return sample("value", means, values, conics, samples, **kw)


def sample_gaussians_derivative(means, values, conics, samples, **kw):
    """First derivatives (N, D, C)."""
    return sample("derivative", means, values, conics, samples, **kw)


def sample_gaussians_laplacian(means, values, conics, samples, **kw):
    """Full Hessian (N, D, D, C), 'laplacian' in the reference's naming."""
    return sample("laplacian", means, values, conics, samples, **kw)


def sample_gaussians_third_derivative(means, values, conics, samples, **kw):
    """Third-derivative tensor (N, D, D, D, C)."""
    return sample("third", means, values, conics, samples, **kw)
