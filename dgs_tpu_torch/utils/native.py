"""ctypes bindings for the native host capacity planner.

Binds the same ``csrc/host_binning.cpp`` as ``dgs_tpu.utils.native`` (a plain
C ABI over float arrays), built on first use with g++ into the port's own
build directory.  The planner returns exact entry counts and per-axis
footprint extents, so a SamplerConfig's capacities can be set tightly before
the first binning.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
import subprocess
import tempfile
import threading

import numpy as np
import torch

_lock = threading.Lock()
_lib = None

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(os.path.dirname(_ROOT), "csrc", "host_binning.cpp")
BUILD_DIR = os.path.join(_ROOT, ".build")
_OUT = os.path.join(BUILD_DIR, "host_binning.so")


def _load() -> ctypes.CDLL:
    """Build (if stale) and load the planner library.  Several test workers
    may build at once: each compiles to its own temporary name and
    os.replace publishes the result atomically."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if (not os.path.exists(_OUT)
                or os.path.getmtime(_OUT) < os.path.getmtime(_SRC)):
            os.makedirs(BUILD_DIR, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            try:
                subprocess.run(
                    ["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
                     "-o", tmp, _SRC],
                    check=True, capture_output=True,
                )
                os.replace(tmp, _OUT)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        lib = ctypes.CDLL(_OUT)
        fptr = ctypes.POINTER(ctypes.c_float)
        d = ctypes.c_double
        i32 = ctypes.c_int32
        lib.dgs_plan_capacities.argtypes = [
            fptr, fptr, fptr, ctypes.c_int64, ctypes.c_int64, i32,
            d, d, d, d, d, d, d, i32, d, d,
            i32, i32, i32, i32, i32, i32,
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.dgs_plan_capacities.restype = ctypes.c_int
        lib.dgs_max_collisions.argtypes = [
            fptr, fptr, ctypes.c_int64, i32, d, i32]
        lib.dgs_max_collisions.restype = ctypes.c_int64
        _lib = lib
        return _lib


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.ascontiguousarray(np.asarray(x), np.float32)


def plan_capacities(cfg, means, covariances, samples) -> dict:
    """Capacity plan for the tiled pipeline on this dataset.

    Returns a dict with: entries, max_extent (per-axis R), max_tile_entries,
    max_tile_samples, work_blocks_fwd, work_blocks_bwd, culled,
    occupied_tiles, work_items_fwd, work_items_bwd and safe_unwrapped (the
    compact-support certificate for the unwrapped kernels: every binned pair
    has |mu' - x| < period/2 per axis iff max_radius + tile < period/2).
    Inputs may be tensors on any device or numpy arrays.
    """
    from ..oracle.dense import radii as compute_radii

    means, covs, smps = _host(means), _host(covariances), _host(samples)
    P, D = means.shape
    N = smps.shape[0]
    cfg = cfg.with_dims(D)
    lower = list(cfg.lower) + [0.0] * (3 - D)
    bn, be = cfg.block_n, cfg.block_p
    bbn, bbe = cfg.bwd_blocks

    safe_unwrapped = False
    if cfg.period is not None:
        rmax = float(compute_radii(torch.from_numpy(covs), D,
                                   cfg.radius_sigma, cfg.eig_floor)
                     .max().item()) if P else 0.0
        safe_unwrapped = (max(rmax, 0.0) + cfg.tile_size) < cfg.period / 2.0

    lib = _load()
    out = (ctypes.c_int64 * 10)()
    extents = ([cfg.period] * 3 if cfg.period is not None
               else [u - l for l, u in zip(cfg.lower, cfg.upper)] +
               [0.0] * (3 - D))
    fptr = ctypes.POINTER(ctypes.c_float)
    rc = lib.dgs_plan_capacities(
        means.ctypes.data_as(fptr), covs.ctypes.data_as(fptr),
        smps.ctypes.data_as(fptr), P, N, D,
        lower[0], lower[1], lower[2], extents[0], extents[1], extents[2],
        cfg.tile_size, 1 if cfg.period is not None else 0,
        cfg.radius_sigma, cfg.eig_floor, bn, be, bbe, bbn,
        1 if cfg.axis_radii else 0, 1 if cfg.ellip_cull else 0, out,
    )
    if rc != 0:
        raise ValueError(f"dgs_plan_capacities rejected its inputs (rc={rc})")
    keys = ("entries", "max_extent", "max_tile_entries", "max_tile_samples",
            "work_blocks_fwd", "work_blocks_bwd", "culled", "occupied_tiles",
            "work_items_fwd", "work_items_bwd")
    plan = dict(zip(keys, list(out)))
    plan["safe_unwrapped"] = safe_unwrapped
    return plan


def config_from_plan(cfg, plan: dict, P: int):
    """Tight SamplerConfig from a capacity plan: the per-axis duplicate cap,
    the entry capacity (plus 5% of P for the f64-planner / f32-binning
    borderline) and the unwrapped-kernel certificate.  The TPU work-list
    capacities that dgs_tpu also sets are not read by the port."""
    return dataclasses.replace(
        cfg,
        max_tiles_per_gaussian=max(int(plan["max_extent"]), 1),
        entry_capacity_factor=plan["entries"] / max(P, 1) + 0.05,
        unwrapped_kernels=bool(plan.get("safe_unwrapped", False)),
    )


def max_collisions(cfg, means, radii) -> int:
    """Worst-case neighbour count of any Gaussian under the 0.2-shrunk
    collision radii (the table path's capacity planner; equals
    ops.aggregation.suggest_capacity).  Inputs may be tensors on any device
    or numpy arrays."""
    means, rad = _host(means), _host(radii)
    P, D = means.shape
    fptr = ctypes.POINTER(ctypes.c_float)
    return int(_load().dgs_max_collisions(
        means.ctypes.data_as(fptr), rad.ctypes.data_as(fptr), P, D,
        cfg.period if cfg.period else 0.0,
        1 if cfg.period is not None else 0))
