"""PyTorch + CUDA port of the dgs_tpu Gaussian sampling engine.

Slice 1, the evaluation path: ``GaussianSampler`` (method "tiled") and the
functional ``sample_binned`` over the tile binning, with the tiled forward
pass as a hand-written Hopper CUDA kernel.  Imports torch and numpy only;
the JAX package ``dgs_tpu`` is the reference this port is tested against.
"""

from .config import SamplerConfig, ORDERS, tri_size, tri_index  # noqa: F401
from .sampler import GaussianSampler  # noqa: F401
from .ops.sampling import sample_binned  # noqa: F401
from .binning.grid import bin_samples, build as preprocess_gaussians  # noqa: F401
