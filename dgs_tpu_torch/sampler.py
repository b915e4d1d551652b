"""Stateful GaussianSampler facade, the reference-shaped public API.

The counterpart of ``dgs_tpu/sampler.py``.  With ``method="tiled"``
``preprocess`` builds the binning once and the four ``sample_gaussians*``
methods and ``sample_all`` evaluate over it through the tiled kernels; with
``method="pallas"`` (the dense CUDA kernels; the name is dgs_tpu's) or
any other method string (the plain torch all-pairs path, as
``dgs_tpu/sampler.py`` runs every method it does not name) there is no
binning and every sample meets every Gaussian.  Outputs are
differentiable w.r.t. the ``means``, ``values`` and ``conics`` handed to
``preprocess`` (the reference's autograd contract;
covariances and samples only shape the binning).  With ``method="chunked"``
(the JAX package's production method at D = 3) ``preprocess`` plans the
capacities (``ops.sampling_chunked.plan_chunked``: the candidate-tile cap,
the entry capacity, the wrap-free certificate) from the config it was
given, also when it runs again, and bins the samples once, and every
evaluation bins the Gaussians anew under that plan; in debug
mode a parameter drift past the plan raises a named ``ValueError``.
``preprocess_aggregate`` and ``aggregate_neighbors`` are the
neighbour-aggregation subsystem over the same Gaussians.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from .binning import grid as binning
from .config import SamplerConfig, tri_size
from .ops import aggregation, sampling, sampling_chunked
from .oracle.dense import radii as compute_radii
from .utils import profiling
from .utils.debug import check_finite, snapshot_call


class GaussianSampler:
    """The methods "tiled", "chunked" and "pallas" have paths of their own;
    every other method string runs the plain all-pairs path (method
    "dense"), as in dgs_tpu."""

    def __init__(self, debug: bool = False,
                 config: SamplerConfig = SamplerConfig(),
                 method: str = "tiled"):
        self.debug = debug
        self.config = config
        self.method = method

    # -- sampling ----------------------------------------------------------

    def _validate(self, means, values, covariances, conics, samples):
        """Shape (and, in debug mode, finiteness) validation with named
        errors."""
        P, D = means.shape
        tri = tri_size(D)
        checks = [
            ("values", values, (P, None)),
            ("covariances", covariances, (P, tri)),
            ("conics", conics, (P, tri)),
            ("samples", samples, (None, D)),
        ]
        for name, arr, want in checks:
            if arr.ndim != 2 or any(
                w is not None and s != w for s, w in zip(arr.shape, want)
            ):
                want_s = tuple("*" if w is None else w for w in want)
                raise ValueError(
                    f"{name} has shape {tuple(arr.shape)}, expected {want_s} "
                    f"for P={P} Gaussians in D={D} dims"
                )
        if self.debug:
            check_finite("preprocess inputs", {
                "means": means, "values": values,
                "covariances": covariances, "conics": conics,
                "samples": samples,
            })

    def preprocess(self, means, values, covariances, conics, samples):
        """Build and store the acceleration structure."""
        with profiling.named_scope("dgs::facade.preprocess"):
            self._preprocess(means, values, covariances, conics, samples)

    def _preprocess(self, means, values, covariances, conics, samples):
        P, D = means.shape
        self._validate(means, values, covariances, conics, samples)
        base = self.config
        if self.method == "chunked" and base is getattr(self, "_planned",
                                                        None):
            # Plan again from what the last plan started from: planning
            # from its output would keep the wrap-free certificate for
            # footprints that have since outgrown it (dgs_tpu's facade
            # does).
            base = self._plan_base
        cfg = base.with_dims(D)
        self.config = cfg
        self.means, self.values, self.conics = means, values, conics
        self.covariances, self.samples = covariances, samples

        if self.method == "chunked":
            self._plan_base = cfg
            cfg, plan = sampling_chunked.plan_chunked(
                cfg, means, covariances, samples)
            self.config = self._planned = cfg
            self._chunk_plan = plan
            self._chunk_samples = snapshot_call(
                self.debug, "preprocess", sampling_chunked.chunk_samples,
                cfg, samples, plan, cfg.block_n)
        if self.method != "tiled":
            self.state = None
            with profiling.named_scope("dgs::op.radii"):
                self.radii = compute_radii(covariances.detach(), D,
                                           cfg.radius_sigma, cfg.eig_floor)
            return
        state = snapshot_call(self.debug, "preprocess", binning.build, cfg,
                              means, covariances, samples)
        self.state = state
        # Scalar collision radii, as the aggregation subsystem consumes them
        # (per-axis binning radii under cfg.axis_radii are not).
        self.radii = (state.radii if state.radii.ndim == 1 else
                      compute_radii(covariances.detach(), D,
                                    cfg.radius_sigma, cfg.eig_floor))
        if self.debug:
            rect_of = int(state.overflow)
            ent_of = int(state.entry_overflow)
            if rect_of:
                raise ValueError(
                    f"binning overflow: {rect_of} Gaussians exceed "
                    f"max_tiles_per_gaussian={cfg.max_tiles_per_gaussian}"
                    "; raise it in SamplerConfig (see "
                    "dgs_tpu_torch.utils.native.plan_capacities)"
                )
            if ent_of:
                raise ValueError(
                    f"binning entry overflow: {ent_of} (gaussian, tile) "
                    "entries dropped; raise "
                    f"entry_capacity_factor={cfg.entry_capacity_factor} "
                    "in SamplerConfig"
                )

    def _run(self, orders) -> Dict[str, torch.Tensor]:
        cfg = self.config
        if self.method == "chunked":
            outs, diag = snapshot_call(
                self.debug, "sample", sampling_chunked.sample_chunked,
                cfg, self.means, self.values, self.conics, self.covariances,
                self.samples, self._chunk_plan, self._chunk_samples,
                tuple(orders))
            if self.debug:
                bad = {k: int(v) for k, v in diag.items()
                       if k != "perm" and int(v)}
                if bad:
                    raise ValueError(
                        f"chunked sampling overflow {bad}; re-run preprocess "
                        "(parameters drifted past the planned capacities)")
            return outs
        if self.method != "tiled":
            return sampling.sample_all(
                self.means, self.values, self.conics, self.samples,
                period=cfg.period, orders=orders,
                method="pallas" if self.method == "pallas" else "dense")
        outs = snapshot_call(
            self.debug, "sample", sampling.sample_tiled_multi,
            tuple(orders), cfg, self.means, self.values, self.conics,
            self.samples, self.state, unwrapped=cfg.unwrapped_kernels,
        )
        return dict(zip(orders, outs))

    def sample_gaussians(self):
        return self._run(("value",))["value"]

    def sample_gaussians_derivative(self):
        return self._run(("derivative",))["derivative"]

    def sample_gaussians_laplacian(self):
        return self._run(("laplacian",))["laplacian"]

    def sample_gaussians_third_derivative(self):
        return self._run(("third",))["third"]

    def sample_all(self, orders=sampling.ALL_ORDERS):
        """Fused evaluation of several orders in one pairwise pass."""
        if self.method != "chunked":   # the chunked op counts its calls
            profiling.count("calls.sample_all")
        with profiling.named_scope("dgs::facade.sample_all"):
            return self._run(tuple(orders))

    # -- neighbor aggregation ---------------------------------------------

    def preprocess_aggregate(self, neighbor_capacity: Optional[int] = None,
                             method: str = "grid",
                             rect_capacity: Optional[int] = None):
        """Build the neighbour structure over the Gaussians handed to
        ``preprocess``.  method="pallas" (the production path) builds the
        tile-sorted structure of the aggregation kernels
        (kernels/aggregate.py), with no neighbour capacity to truncate;
        "grid" uses the world-grid cell-list search (O(P * candidates));
        "dense" the reference-shaped O(P^2) scan.  Unset capacities are
        planned from the collision radii (grid tile matched to them, exact
        per-tile table width)."""
        means, conics = self.means.detach(), self.conics.detach()
        if method == "pallas":
            cfg, plan = aggregation.plan_pallas(self.config, means,
                                                self.radii)
            agg = snapshot_call(
                self.debug, "preprocess_agg", aggregation.preprocess_pallas,
                cfg, means, conics, self.radii, plan)
        elif method == "grid":
            cfg = self.config
            if neighbor_capacity is None or rect_capacity is None:
                cfg, nc_auto, rect_auto = aggregation.suggest_grid_capacities(
                    cfg, means, self.radii)
                neighbor_capacity = neighbor_capacity or nc_auto
                rect_capacity = rect_capacity or rect_auto
            agg = snapshot_call(
                self.debug, "preprocess_agg", aggregation.preprocess_grid,
                cfg, means, conics, self.radii, neighbor_capacity,
                rect_capacity)
        elif method == "dense":
            agg = snapshot_call(
                self.debug, "preprocess_agg", aggregation.preprocess,
                self.config, means, conics, self.radii, neighbor_capacity)
        else:
            raise ValueError(
                f"unknown preprocess_aggregate method: {method!r}")
        if self.debug:
            of = int(agg.overflow)
            if of:
                raise ValueError(
                    f"neighbor table overflow: {of} candidates dropped; "
                    "raise neighbor_capacity / rect_capacity")
        self.neighbors = agg
        return agg

    def aggregate_neighbors(self, features, transform, queries, keys,
                            frequencies, distance_transform):
        """Attention aggregation over the stored neighbour structure,
        differentiable in all six arguments.  Dispatches on what
        preprocess_aggregate built: the kernel structure routes to the
        aggregation kernels, the table forms to the plain torch path."""
        fn = (aggregation.aggregate_pallas
              if isinstance(self.neighbors, aggregation.AggBinning)
              else aggregation.aggregate)
        return snapshot_call(
            self.debug, "aggregate", fn, features, transform, queries, keys,
            frequencies, distance_transform, self.neighbors)
