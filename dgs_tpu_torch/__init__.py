"""PyTorch + CUDA port of the dgs_tpu Gaussian sampling engine.

The tile-binned path (and its chunked form, the D = 3 production method),
the all-pairs (dense) path and the neighbour aggregation, evaluation and
training: ``GaussianSampler`` (methods "tiled", "chunked", "pallas" and
"dense", ``preprocess_aggregate`` / ``aggregate_neighbors``), the functional
``sample_binned``, ``ops.sampling_chunked``, ``sample`` / ``sample_all`` and
the module-level forms below, the PIGS trainer (``models.pigs``) and the
dynamics trainer (``models.dynamics``), with the tiled and the dense forward
and backward passes and the aggregation's totals, forward and backward as
hand-written Hopper CUDA kernels; ``utils`` holds the checkpoint, metrics
log, profiling, roofline and debug helpers.  Imports torch and numpy only;
the JAX package ``dgs_tpu`` is the reference this port is tested against.
"""

from .config import SamplerConfig, ORDERS, tri_size, tri_index  # noqa: F401
from .sampler import GaussianSampler  # noqa: F401
from .ops import aggregation
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


def preprocess_aggregate(cfg, means, conics, radii, method: str = "grid",
                         **kw):
    """Neighbour structure build, the facade's ``method`` dispatch at the
    functional surface:

      * ``"pallas"``: the tile-sorted structure (``aggregation.AggBinning``)
        of the aggregation kernels; capacities planned from the collision
        radii.
      * ``"grid"``: world-grid cell-list neighbour table (``Neighbors``).
      * ``"dense"``: the reference-shaped O(P^2) scan (``Neighbors``).

    Either return value feeds ``aggregate_neighbors`` below."""
    if method == "pallas":
        cfg, plan = aggregation.plan_pallas(cfg, means, radii)
        return aggregation.preprocess_pallas(
            cfg, means, conics, radii, plan, **kw)
    if method == "grid":
        return aggregation.preprocess_grid(cfg, means, conics, radii, **kw)
    if method == "dense":
        return aggregation.preprocess(cfg, means, conics, radii, **kw)
    raise ValueError(f"unknown preprocess_aggregate method: {method!r}")


def aggregate_neighbors(features, transform, queries, keys, frequencies,
                        distance_transform, neighbors):
    """Attention aggregation over the Gaussian cloud; differentiable in all
    six parameter groups.  Dispatches on the neighbour structure: an
    ``aggregation.AggBinning`` (from ``preprocess_pallas``) routes to the
    aggregation kernels, a ``Neighbors`` table to the plain torch path."""
    if isinstance(neighbors, aggregation.AggBinning):
        return aggregation.aggregate_pallas(
            features, transform, queries, keys, frequencies,
            distance_transform, neighbors)
    return aggregation.aggregate(features, transform, queries, keys,
                                 frequencies, distance_transform, neighbors)
