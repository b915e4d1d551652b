"""Debug and crash-forensics utilities for the facade's ``debug=True``.

``snapshot_call`` copies a call's tensor inputs to the host before the call
and, if the call raises, saves them to ``snapshot_<name>.npz`` for the bug
report; ``check_finite`` raises a named error on NaN/Inf inputs.
"""

from __future__ import annotations

from typing import Any

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
