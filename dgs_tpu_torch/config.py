"""Runtime configuration of the PyTorch port.

Field for field the same frozen dataclass as ``dgs_tpu.config`` (same names,
same defaults, same periodic tile snap), so one configuration drives both
packages.  The fields that select TPU-only kernel modes (the MXU/VPU
trade-offs of the Pallas kernels and the span-packed work list) are kept for
that reason but must stay unset: the port has no such kernels, and running
the classic math under a flag that asks for another kernel would be a silent
substitution.
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


# Flags that select kernel modes written for the TPU's matrix unit or its
# scalar memory; the port raises on any of them rather than run the classic
# kernel in their place.
TPU_ONLY_FLAGS = ("separable_kernels", "moment_backward", "folded_values",
                  "folded_dvals", "folded_vjp", "h_matmul", "fast_math_dots")


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    """Static configuration of the sampling engine (see dgs_tpu.config for
    the meaning of every field).

    The port reads: ``period``, ``lower``, ``upper_bounds``, ``tile_size``,
    ``radius_sigma``, ``eig_floor``, ``max_tiles_per_gaussian``,
    ``entry_capacity_factor``, ``unwrapped_kernels``, ``axis_radii`` and
    ``ellip_cull``.  The block sizes and work-list capacities size the TPU
    kernels' grids and work lists; the port's kernel walks each sample
    block's entry range itself and needs neither.
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
        if self.work_span_fwd != 1 or self.work_span_bwd != 1:
            on.append("work_span_fwd/work_span_bwd")
        if on:
            raise NotImplementedError(
                f"SamplerConfig sets {', '.join(on)}: TPU-only kernel modes "
                "of dgs_tpu that dgs_tpu_torch does not port (ROADMAP.md "
                "'Not ported, by decision'); leave them unset")
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
