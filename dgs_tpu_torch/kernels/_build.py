"""Build and load the port's CUDA kernels.

``dgs_tpu_torch/csrc/*.cu`` compile with nvcc for Hopper (sm_90a), one nvcc
per source, all started together, and link into one shared library with a
plain C interface, loaded with ctypes.  The build runs at first use into the
package's build directory (listed in .gitignore) and is reused while it is
newer than every source; concurrent builders each compile to their own
temporary names and publish with os.replace.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import tempfile
import threading

from ..utils.native import BUILD_DIR

_CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")
_OUT = os.path.join(BUILD_DIR, "libdgs_kernels.so")
_LOG = os.path.join(BUILD_DIR, "libdgs_kernels.log")

_lock = threading.Lock()
_lib = None


def nvcc() -> str:
    """The CUDA compiler: on PATH, else under CUDA_HOME (default
    /usr/local/cuda)."""
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError(
        "nvcc not found: dgs_tpu_torch's CUDA kernels build with the CUDA "
        "toolkit (put nvcc on PATH or set CUDA_HOME)")


def _sources():
    return sorted(glob.glob(os.path.join(_CSRC, "*.cu")))


def _stale() -> bool:
    if not os.path.exists(_OUT):
        return True
    deps = _sources() + glob.glob(os.path.join(_CSRC, "*.cuh"))
    return os.path.getmtime(_OUT) < max(os.path.getmtime(p) for p in deps)


def load() -> ctypes.CDLL:
    """The kernel library, built first if it is missing or stale."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if _stale():
            os.makedirs(BUILD_DIR, exist_ok=True)
            _build()
        lib = ctypes.CDLL(_OUT)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.dgs_tiled_forward.argtypes = [
            p, i, i, p, i, p, p, i, i, i, i, ctypes.c_float,
            i, i, i, i, p, p,
        ]
        lib.dgs_tiled_forward.restype = i
        lib.dgs_tiled_backward.argtypes = [
            p, i, i, p, i, p, p, p, i, i, i, i, ctypes.c_float,
            i, i, i, i, p, p,
        ]
        lib.dgs_tiled_backward.restype = i
        lib.dgs_tiled_forward_sep.argtypes = [
            p, i, i, p, i, p, p, i, i, i, i, i, i, i, i, p, p,
        ]
        lib.dgs_tiled_forward_sep.restype = i
        lib.dgs_tiled_backward_moments.argtypes = [
            p, i, i, p, i, p, p, p, i, i, i, i, i, i, i, p, p,
        ]
        lib.dgs_tiled_backward_moments.restype = i
        lib.dgs_tiled_backward_moments_hmm.argtypes = [
            p, i, i, p, i, p, p, p, i, i, i, i, i, i, i, i, p, p,
        ]
        lib.dgs_tiled_backward_moments_hmm.restype = i
        lib.dgs_tiled_backward_hmm.argtypes = [
            p, i, i, p, i, p, p, p, i, i, i, i, ctypes.c_float,
            i, i, i, i, i, p, p,
        ]
        lib.dgs_tiled_backward_hmm.restype = i
        lib.dgs_tiled_forward_folded.argtypes = [
            p, i, p, i, i, p, i, i, p, p, i, i, i, p, i, p, p,
        ]
        lib.dgs_tiled_forward_folded.restype = i
        lib.dgs_tiled_backward_fdv.argtypes = [
            p, i, i, p, i, p, p, i, i, p, p, i, i, i, i, i, i, i, i, i, p, p,
        ]
        lib.dgs_tiled_backward_fdv.restype = i
        lib.dgs_tiled_backward_fvjp.argtypes = [
            p, i, i, p, p, p, i, i, p, i, p, p, i, i, p, i, i, p, p,
        ]
        lib.dgs_tiled_backward_fvjp.restype = i
        lib.dgs_tiled_forward_folded_pass_rows.argtypes = [i]
        lib.dgs_tiled_forward_folded_pass_rows.restype = i
        lib.dgs_tiled_forward_folded_smem.argtypes = [i, i, i, i]
        lib.dgs_tiled_forward_folded_smem.restype = i
        for fn in (lib.dgs_tiled_backward_fvjp_window,
                   lib.dgs_tiled_backward_fvjp_smem):
            fn.argtypes = [i, i, i, i]
            fn.restype = i
        for fn in (lib.dgs_tiled_backward_fdv_pass_rows,
                   lib.dgs_tiled_backward_fdv_smem):
            fn.argtypes = [i, i, i, i, i]
            fn.restype = i
        lib.dgs_tiled_backward_fdv_warps.argtypes = [i, i]
        lib.dgs_tiled_backward_fdv_warps.restype = i
        lib.dgs_tiled_backward_moments_rows.argtypes = [i, i]
        lib.dgs_tiled_backward_moments_rows.restype = i
        lib.dgs_tiled_backward_moments_block.argtypes = [i]
        lib.dgs_tiled_backward_moments_block.restype = i
        lib.dgs_tiled_backward_moments_smem.argtypes = [i, i, i, i]
        lib.dgs_tiled_backward_moments_smem.restype = i
        lib.dgs_tiled_forward_sep_smem.argtypes = [i, i]
        lib.dgs_tiled_forward_sep_smem.restype = i
        lib.dgs_tiled_backward_hmm_smem.argtypes = [i, i, i]
        lib.dgs_tiled_backward_hmm_smem.restype = i
        lib.dgs_dense_forward.argtypes = [
            p, i, i, p, i, i, i, i, i, i, ctypes.c_float, p, p,
        ]
        lib.dgs_dense_forward.restype = i
        lib.dgs_dense_backward.argtypes = [
            p, i, i, p, i, p, i, i, i, i, i, ctypes.c_float, p, p,
        ]
        lib.dgs_dense_backward.restype = i
        ll = ctypes.c_longlong
        lib.dgs_segment_sum.argtypes = [p, ll, ll, i, p, p, i, p, p]
        lib.dgs_segment_sum.restype = i
        f = ctypes.c_float
        ip, fp = ctypes.POINTER(i), ctypes.POINTER(f)
        lib.dgs_binning_keys.argtypes = [
            p, p, i, p, i, i, i, ip, ip, fp, f, f, i, f, i, i, i, p, p, p,
        ]
        lib.dgs_binning_keys.restype = i
        lib.dgs_agg_totals.argtypes = [p, i, p, i, i, p, i, i, f, p, p]
        lib.dgs_agg_totals.restype = i
        lib.dgs_agg_forward.argtypes = [
            p, p, i, p, i, i, p, p, i, i, i, i, i, i, f, i, i, i, p, p, p,
        ]
        lib.dgs_agg_forward.restype = i
        for fn in (lib.dgs_agg_backward_entries,
                   lib.dgs_agg_backward_centres):
            fn.argtypes = [
                p, p, i, p, i, i, p, p, p, p, i, i, i, i, i, i, f, i, i, p,
                p,
            ]
            fn.restype = i
        for fn in (lib.dgs_tiled_forward_pass, lib.dgs_tiled_backward_pass):
            fn.argtypes = [i, i]
            fn.restype = i
        lib.dgs_tiled_wrap_scaled.argtypes = [ctypes.c_float]
        lib.dgs_tiled_wrap_scaled.restype = i
        for fn in (lib.dgs_tiled_forward_block, lib.dgs_tiled_backward_block,
                   lib.dgs_tiled_forward_sep_block,
                   lib.dgs_tiled_backward_hmm_block,
                   lib.dgs_tiled_backward_hmm_rows,
                   lib.dgs_dense_forward_block, lib.dgs_dense_backward_block,
                   lib.dgs_agg_block, lib.dgs_agg_backward_max_nfreq):
            fn.argtypes = []
            fn.restype = i
        _lib = lib
        return _lib


def _run_all(cmds):
    """Run the commands concurrently; raise with nvcc's output if any
    fails, else return their combined logs."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs, failed = [], False
    for c, proc in zip(cmds, procs):
        out, _ = proc.communicate()
        logs.append(" ".join(c) + "\n" + out)
        failed = failed or proc.returncode != 0
    if failed:
        raise RuntimeError("nvcc failed building dgs_tpu_torch kernels:\n"
                           + "\n".join(logs))
    return logs


def _build():
    arch = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3"]
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        objs = [os.path.join(tmpdir, os.path.basename(src) + ".o")
                for src in _sources()]
        logs = _run_all([
            [nvcc()] + arch + ["-Xcompiler", "-fPIC", "-Xptxas", "-v",
                               "-c", "-o", obj, src]
            for src, obj in zip(_sources(), objs)])
        lib = os.path.join(tmpdir, "lib.so")
        logs += _run_all([[nvcc()] + arch + ["-shared", "-o", lib] + objs])
        with open(_LOG, "w") as f:
            f.write("\n".join(logs))
        os.replace(lib, _OUT)


def build_log() -> str:
    """nvcc's command line and its -Xptxas -v report (registers, shared
    memory, spills per kernel) from the last build."""
    with open(_LOG) as f:
        return f.read()
