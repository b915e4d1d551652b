"""Debug and crash-forensics utilities for the facade's ``debug=True``.

``snapshot_call`` copies a call's tensor inputs to the host before the call
and, if the call raises, saves them to ``snapshot_<name>.npz`` for the bug
report; ``check_finite`` raises a named error on NaN/Inf inputs.
``checked`` / ``throw`` localise the first non-finite value of a training
step, as dgs_tpu's checkify wrappers do (``dgs_tpu/utils/debug.py``), with
autograd's anomaly mode in place of checkify.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch


def _host(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return a


def snapshot_call(debug: bool, name: str, fn, *args: Any, **kwargs: Any):
    """Run ``fn``; in debug mode, on failure dump host copies of the
    inputs (copied before the call, so device-side corruption cannot reach
    the dump) and re-raise.  A CUDA call is synchronised so that an
    asynchronous device fault surfaces here."""
    if not debug:
        return fn(*args, **kwargs)
    host_args = [_host(a) for a in args]
    try:
        out = fn(*args, **kwargs)
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        return out
    except Exception:
        path = f"snapshot_{name}.npz"
        np.savez(path, **{f"arg{i}": a for i, a in enumerate(host_args)
                          if isinstance(a, np.ndarray)})
        print(f"\n{name} failed; inputs saved to {path} "
              "(attach it when reporting the crash).")
        raise


def check_finite(name: str, tensors: dict) -> None:
    """Raise FloatingPointError naming the first non-finite input."""
    for key, t in tensors.items():
        if (isinstance(t, torch.Tensor) and t.is_floating_point()
                and not bool(torch.isfinite(t).all())):
            raise FloatingPointError(f"non-finite values in {name}['{key}']")


class CheckError:
    """The outcome of a ``checked`` call: ``message`` names the first
    non-finite value, or is None; ``throw()`` raises it as a
    FloatingPointError."""

    def __init__(self, message: Optional[str] = None):
        self.message = message

    def get(self) -> Optional[str]:
        return self.message

    def throw(self) -> None:
        if self.message is not None:
            raise FloatingPointError(self.message)


def _tensors(tree, path=""):
    """(path, tensor) of every tensor in nested tuples, lists and dicts."""
    if isinstance(tree, torch.Tensor):
        yield path, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _tensors(v, f"{path}[{k!r}]")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _tensors(v, f"{path}[{i}]")


def checked(fn):
    """``fn`` wrapped to return ``(err, out)``: it runs under
    ``torch.autograd.detect_anomaly(check_nan=True)``, so a backward inside
    it that produces a NaN stops at the autograd function that made it
    (``out`` is then None), and its tensor outputs are scanned for NaN and
    Inf.  ``err.throw()`` (or ``throw(err)``) raises a FloatingPointError
    naming the first non-finite value, and does nothing when there is none.
    Anomaly mode costs a check per autograd function: a debug path, not the
    production step."""

    def run(*args, **kwargs):
        try:
            with torch.autograd.detect_anomaly(check_nan=True):
                out = fn(*args, **kwargs)
        except RuntimeError as e:
            if "nan values" not in str(e):
                raise
            return CheckError(f"non-finite values in the backward: {e}"), None
        for path, t in _tensors(out):
            if t.is_floating_point() and not bool(torch.isfinite(t).all()):
                return CheckError(f"non-finite values in output{path}"), out
        return CheckError(), out

    return run


def throw(err: CheckError) -> None:
    """Raise the error of a ``checked`` call, if any (one host sync)."""
    err.throw()
