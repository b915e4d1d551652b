"""Runtime configuration of the PyTorch port.

Field for field the same frozen dataclass as ``dgs_tpu.config`` (same names,
same defaults, same periodic tile snap), so one configuration drives both
packages.  Every kernel mode of dgs_tpu's kernels 1-2 has a kernel in the
port (the separable forward, the moment-form backward, the folded forward,
the folded dvalues, the folded VJP, h_matmul, and ``fast_math_dots``),
and ops.sampling.kernel_modes resolves the flags as dgs_tpu's code does.
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


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    """Static configuration of the sampling engine (see dgs_tpu.config for
    the meaning of every field).

    The port reads: ``period``, ``lower``, ``upper_bounds``, ``tile_size``,
    ``radius_sigma``, ``eig_floor``, ``max_tiles_per_gaussian``,
    ``entry_capacity_factor``, ``unwrapped_kernels``, ``axis_radii``,
    ``ellip_cull`` and the kernel-mode flags, which
    ops.sampling.kernel_modes resolves as dgs_tpu's code does:

      ``separable_kernels`` / ``moment_backward``: the separable forward /
      the moment-form backward, wrap-free only; None is the automatic
      default, on exactly under ``fast_math_dots`` at wrap-free D >= 3.
      ``folded_values``: the folded forward (one tensor-core contraction
      Z = fold G a pair block), wrap-free only and off under either mode
      above; its backward is the classic one on tile-local operands unless
      ``folded_dvals`` is set (None is off, as in dgs_tpu's code): then the
      value gradients are the folded contraction Zd = cb G, where the
      beta-expanded cotangent (R * Np * 4 bytes) fits
      kernels.tiled.CT_BETA_MAX_BYTES.  ``folded_vjp`` (needs the folded
      dvalues, else turns off silently): the whole backward from Zd, S0 and
      W_l contractions, no h chains.  ``h_matmul``: h_k = g_k . values as a
      tensor-core contraction in every backward that builds h.
      ``fast_math_dots``: every such contraction at one TF32 pass instead
      of three (outside the fp32 gate).

    What the modes cost on the card (NVIDIA H100 80GB HBM3, 700.00 W;
    PERF.md section 5): every one is slower than the classic kernels.  The
    D = 3 chunked bench step is busy 22.5-22.6 ms classic, 31.4-31.6 ms
    under ``fast_math_dots``, 31.8-32.1 ms under ``separable_kernels``
    with ``moment_backward``, 46.1-46.2 ms under ``folded_values``,
    79.6-79.7 ms with ``folded_dvals``, 150.5-151.1 ms with ``folded_vjp``
    too, and 24.5-24.6 ms under ``h_matmul``; peak memory 0.8 GB classic,
    5.7, 7.4 and 15.5 GB under the three folded modes.  One TF32 pass
    (``fast_math_dots``) moves the folded forward by up to 6.0% of its
    largest output.

    Accepted, not read: the block sizes (``block_n``, ``block_p``,
    ``block_n_bwd``, ``block_p_bwd``), the work-list capacities
    (``work_items_*``, ``work_blocks_*``) and the spans (``work_span_fwd``,
    ``work_span_bwd``, any positive value).  They size and pack the TPU
    kernels' grids and work lists, which change only how the TPU schedules
    the same pairs; the port's kernels walk each block's range themselves
    and need none of them.
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
