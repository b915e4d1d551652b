"""ctypes bindings for the native host capacity planner.

Binds the same ``csrc/host_binning.cpp`` as ``dgs_tpu.utils.native`` (a plain
C ABI over float arrays), built on first use with g++ into the port's own
build directory.  The planner returns exact entry counts and per-axis
footprint extents, so a SamplerConfig's capacities can be set tightly before
the first binning.  Where g++ cannot build the planner, plan_capacities
falls back to ``_plan_capacities_numpy`` (the same plan from the port's own
binning on the CPU, slower) and max_collisions to
``ops.aggregation.suggest_capacity``, as ``dgs_tpu.utils.native`` does.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
import subprocess
import sys
import tempfile
import threading
from typing import Optional

import numpy as np
import torch

_lock = threading.Lock()
_lib = None
_lib_failed = False

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(os.path.dirname(_ROOT), "csrc", "host_binning.cpp")
BUILD_DIR = os.path.join(_ROOT, ".build")
_OUT = os.path.join(BUILD_DIR, "host_binning.so")


def _build_and_open() -> ctypes.CDLL:
    """The planner library, compiled first with g++ if it is missing or
    older than its source."""
    if (not os.path.exists(_OUT)
            or os.path.getmtime(_OUT) < os.path.getmtime(_SRC)):
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            subprocess.run(
                ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-o", tmp,
                 _SRC], check=True, capture_output=True)
            os.replace(tmp, _OUT)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return ctypes.CDLL(_OUT)


def _load() -> Optional[ctypes.CDLL]:
    """Build (if stale) and load the planner library; None, after one line
    on stderr, when it cannot be built or loaded (the callers fall back).
    Several test workers may build at once: each compiles to its own
    temporary name and os.replace publishes the result atomically."""
    global _lib, _lib_failed
    with _lock:
        if _lib is not None or _lib_failed:
            return _lib
        try:
            lib = _build_and_open()
        except (OSError, subprocess.CalledProcessError) as e:
            print(f"dgs_tpu_torch.native: build failed ({e}); using the "
                  "numpy fallback", file=sys.stderr)
            _lib_failed = True
            return None
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

    safe_unwrapped = False
    if cfg.period is not None:
        rmax = float(compute_radii(torch.from_numpy(covs), D,
                                   cfg.radius_sigma, cfg.eig_floor)
                     .max().item()) if P else 0.0
        safe_unwrapped = (max(rmax, 0.0) + cfg.tile_size) < cfg.period / 2.0

    bn, be = cfg.block_n, cfg.block_p
    bbn, bbe = cfg.bwd_blocks
    lib = _load()
    if lib is None:
        plan = _plan_capacities_numpy(cfg, means, covs, smps, bn, be, bbn,
                                      bbe)
        plan["safe_unwrapped"] = safe_unwrapped
        return plan
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
    plan = dict(zip(PLAN_KEYS, list(out)))
    plan["safe_unwrapped"] = safe_unwrapped
    return plan


PLAN_KEYS = ("entries", "max_extent", "max_tile_entries", "max_tile_samples",
             "work_blocks_fwd", "work_blocks_bwd", "culled", "occupied_tiles",
             "work_items_fwd", "work_items_bwd")


def _plan_capacities_numpy(cfg, means, covs, smps, bn, be, bbn, bbe) -> dict:
    """The C++ planner's plan (PLAN_KEYS) from the port's own binning on the
    CPU (numpy float32 inputs): the fallback where g++ cannot build it,
    slower.  The port of dgs_tpu.utils.native._plan_capacities_numpy."""
    from ..binning import grid as binning

    # Count with an untruncated entry list: the plan reports true totals,
    # not totals clipped to the capacity it is planning.
    R = cfg.max_tiles_per_gaussian
    cfg = dataclasses.replace(cfg, entry_capacity_factor=float(R ** cfg.D))
    m, cv, s = (torch.from_numpy(a) for a in (means, covs, smps))
    state = binning.build(cfg, m, cv, s)
    ent_tile = state.ent_tile[0].numpy()
    valid = ent_tile < binning.num_tiles(cfg, cfg.D)
    # The sweep geometry of the planned (compact) entry list: the valid
    # entries rounded up to one backward block, as the runtime capacity.
    e_keep = max(-(-max(int(valid.sum()), 1) // bbe) * bbe, bbe)
    state = state._replace(ent_tile=state.ent_tile[:, :e_keep],
                           ent_gid=state.ent_gid[:e_keep],
                           ent_start=torch.clamp(state.ent_start, max=e_keep))
    fn = binning.forward_geometry(state, bn, be)[1].numpy()
    bnn = binning.backward_geometry(state, bbe, bbn)[1].numpy()
    tiles, counts = np.unique(ent_tile[valid], return_counts=True)
    _, s_counts = np.unique(binning.sample_tiles(cfg, s).numpy(),
                            return_counts=True)
    rad = state.radii.numpy()
    lo, hi = binning.gaussian_rects(cfg, m, state.radii)
    return {
        "entries": int(valid.sum()),
        "max_extent": int((hi - lo).numpy().max(initial=0)),
        "max_tile_entries": int(counts.max(initial=0)),
        "max_tile_samples": int(s_counts.max(initial=0)),
        "work_blocks_fwd": int(fn.max(initial=0)),
        "work_blocks_bwd": int(bnn.max(initial=0)),
        "culled": int((rad <= 0).all(axis=-1).sum() if rad.ndim == 2
                      else (rad <= 0).sum()),
        "occupied_tiles": int(len(tiles)),
        "work_items_fwd": int(np.maximum(fn, 1).sum()),
        "work_items_bwd": int(np.maximum(bnn, 1).sum()),
    }


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
    ops.aggregation.suggest_capacity, which it falls back to where g++
    cannot build the planner).  Inputs may be tensors on any device or
    numpy arrays."""
    means, rad = _host(means), _host(radii)
    P, D = means.shape
    lib = _load()
    if lib is None:
        from ..ops.aggregation import suggest_capacity

        return suggest_capacity(cfg, torch.from_numpy(means),
                                torch.from_numpy(rad))
    fptr = ctypes.POINTER(ctypes.c_float)
    return int(lib.dgs_max_collisions(
        means.ctypes.data_as(fptr), rad.ctypes.data_as(fptr), P, D,
        cfg.period if cfg.period else 0.0,
        1 if cfg.period is not None else 0))
