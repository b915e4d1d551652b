"""Runtime configuration of the PyTorch port.

Field for field the same frozen dataclass as ``dgs_tpu.config`` (same names,
same defaults, same periodic tile snap), so one configuration drives both
packages.  The kernel modes that the port has kernels for (the separable
forward, the moment-form backward and ``fast_math_dots``, which turns both on
at wrap-free D >= 3) are read as dgs_tpu reads them.  The folded modes and
``h_matmul`` are kept for the shared field list but must stay unset: the port
has no such kernels yet, and running the classic math under a flag that asks
for another kernel would be a silent substitution.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple


def tri_size(D: int) -> int:
    """Packed upper-triangular size of a symmetric DxD matrix."""
    return D * (D + 1) // 2


def tri_index(D: int, i: int, j: int) -> int:
    """Index into the packed row-major upper triangle: D=2 -> [(0,0), (0,1),
    (1,1)], i.e. con[0]=c_xx, con[1]=c_xy, con[2]=c_yy."""
    u, v = (i, j) if i <= j else (j, i)
    return u * D - u * (u - 1) // 2 + (v - u)


# Flags that select kernel modes of dgs_tpu that the port has not ported;
# the port raises on any of them rather than run the classic kernel in their
# place.
TPU_ONLY_FLAGS = ("folded_values", "folded_dvals", "folded_vjp", "h_matmul")


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    """Static configuration of the sampling engine (see dgs_tpu.config for
    the meaning of every field).

    The port reads: ``period``, ``lower``, ``upper_bounds``, ``tile_size``,
    ``radius_sigma``, ``eig_floor``, ``max_tiles_per_gaussian``,
    ``entry_capacity_factor``, ``unwrapped_kernels``, ``axis_radii``,
    ``ellip_cull``, ``separable_kernels``, ``moment_backward`` and
    ``fast_math_dots`` (ops.sampling.kernel_modes resolves the last three as
    dgs_tpu does; ``fast_math_dots`` also runs the separable forward's
    contraction at one TF32 pass instead of three).  On the H100 these
    modes are measured slower than the classic kernels: the D = 3 chunked
    bench step is busy 33.4-33.7 ms under ``fast_math_dots`` and 34.0-34.3
    ms under ``separable_kernels`` with ``moment_backward``, against
    22.4-22.7 ms classic (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md section
    5), and the one-pass forward moves the gradients by up to 0.43% of
    their largest value.
    ``fast_math_dots`` keeps dgs_tpu's automatic default all the same: at
    wrap-free D >= 3 it turns both modes on.

    Accepted, not read: the block sizes (``block_n``, ``block_p``,
    ``block_n_bwd``, ``block_p_bwd``), the work-list capacities
    (``work_items_*``, ``work_blocks_*``) and the spans (``work_span_fwd``,
    ``work_span_bwd``, any positive value).  They size and pack the TPU
    kernels' grids and work lists, which change only how the TPU schedules
    the same pairs; the port's kernels walk each block's range themselves
    and need none of them.  ``folded_values``, ``folded_dvals``,
    ``folded_vjp`` and ``h_matmul`` must stay unset (TPU_ONLY_FLAGS).
    """

    period: Optional[float] = 2.0
    lower: Tuple[float, ...] = (-1.0, -1.0)
    upper_bounds: Optional[Tuple[float, ...]] = None
    tile_size: float = 0.51
    radius_sigma: float = 3.0
    eig_floor: float = 1e-6
    max_tiles_per_gaussian: int = 4
    entry_capacity_factor: float = 4.0
    unwrapped_kernels: bool = False
    moment_backward: Optional[bool] = None
    separable_kernels: Optional[bool] = None
    folded_values: Optional[bool] = None
    folded_dvals: Optional[bool] = None
    folded_vjp: Optional[bool] = None
    h_matmul: Optional[bool] = None
    fast_math_dots: bool = False
    axis_radii: bool = False
    ellip_cull: bool = False
    block_n: int = 512
    block_p: int = 128
    block_n_bwd: Optional[int] = 256
    block_p_bwd: Optional[int] = 128
    work_items_fwd: Optional[int] = None
    work_items_bwd: Optional[int] = None
    work_blocks_fwd: int = 8
    work_blocks_bwd: int = 16
    work_span_fwd: int = 1
    work_span_bwd: int = 1

    def __post_init__(self):
        on = [f for f in TPU_ONLY_FLAGS if getattr(self, f)]
        if on:
            raise NotImplementedError(
                f"SamplerConfig sets {', '.join(on)}: kernel modes of "
                "dgs_tpu that dgs_tpu_torch does not port yet (ROADMAP.md); "
                "leave them unset")
        for f in ("work_span_fwd", "work_span_bwd"):
            if getattr(self, f) < 1:
                raise ValueError(f"SamplerConfig.{f} must be positive")
        # Periodic domains need the tile grid to cover the period exactly
        # (an overhang band silently drops pairs at the seam): snap the tile
        # to period / ceil(period / tile).
        if self.period is not None:
            grid = max(1, math.ceil(self.period / self.tile_size - 1e-9))
            object.__setattr__(self, "tile_size", self.period / grid)

    @property
    def bwd_blocks(self):
        """(block_n_bwd, block_p_bwd) with the half-size defaults."""
        bn = self.block_n_bwd or max(self.block_n // 2, 8)
        be = self.block_p_bwd or max(self.block_p // 2, 128)
        return bn, be

    @property
    def D(self) -> int:
        return len(self.lower)

    def grid_shape(self) -> Tuple[int, ...]:
        """Static tile-grid shape over the configured domain."""
        if self.period is not None:
            # tile_size is snapped to period/grid: round, don't ceil.
            return tuple(
                round(self.period / self.tile_size) for _ in range(self.D)
            )
        extent = [u - l for l, u in zip(self.lower, self.upper)]
        return tuple(int(-(-(e + 1e-6) // self.tile_size)) for e in extent)

    @property
    def upper(self) -> Tuple[float, ...]:
        if self.period is not None:
            return tuple(l + self.period for l in self.lower)
        if self.upper_bounds is not None:
            return self.upper_bounds
        raise ValueError(
            "open-domain config (period=None) requires upper_bounds"
        )

    def with_dims(self, D: int) -> "SamplerConfig":
        if self.D == D:
            return self
        up = (tuple(self.upper_bounds[0] for _ in range(D))
              if self.upper_bounds is not None else None)
        return dataclasses.replace(
            self, lower=tuple(self.lower[0] for _ in range(D)),
            upper_bounds=up,
        )


ORDERS = ("value", "derivative", "laplacian", "third")


def n_components(order: str, D: int) -> int:
    return {"value": 1, "derivative": D, "laplacian": D * D,
            "third": D * D * D}[order]


def out_shape(order: str, N: int, D: int, C: int) -> Tuple[int, ...]:
    """value (N,C) / derivative (N,D,C) / laplacian == Hessian (N,D,D,C) /
    third (N,D,D,D,C)."""
    return {
        "value": (N, C),
        "derivative": (N, D, C),
        "laplacian": (N, D, D, C),
        "third": (N, D, D, D, C),
    }[order]
