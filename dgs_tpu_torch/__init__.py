"""PyTorch + CUDA port of the dgs_tpu Gaussian sampling engine.

The tile-binned path, evaluation and training: ``GaussianSampler`` (method
"tiled"), the functional ``sample_binned`` and the PIGS trainer
(``models.pigs``), with the tiled forward and backward passes as
hand-written Hopper CUDA kernels.  Imports torch and numpy only; the JAX
package ``dgs_tpu`` is the reference this port is tested against.
"""

from .config import SamplerConfig, ORDERS, tri_size, tri_index  # noqa: F401
from .sampler import GaussianSampler  # noqa: F401
from .ops.sampling import sample_binned  # noqa: F401
from .binning.grid import bin_samples, build as preprocess_gaussians  # noqa: F401
