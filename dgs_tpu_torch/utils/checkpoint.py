"""Checkpoint and resume of training state.

The counterpart of ``dgs_tpu/utils/checkpoint.py``, with ``torch.save`` /
``torch.load(weights_only=True)`` in place of Orbax: a
``models.pigs.TrainState`` (the field's parameters, the optimizer's
``state_dict`` and the step counter) or a ``models.dynamics.DynamicsParams``
(its five parameter groups) round-trips through one file.  Checkpoints
written by dgs_tpu (Orbax directories) are not read.
"""

from __future__ import annotations

import os
from typing import Union

import torch

from ..models.dynamics import DynamicsParams
from ..models.pigs import TrainState

State = Union[TrainState, DynamicsParams]


def _payload(state: State) -> dict:
    if isinstance(state, TrainState):
        return {"kind": "TrainState", "field": state.field.state_dict(),
                "optimizer": state.optimizer.state_dict(),
                "step": int(state.step)}
    if isinstance(state, DynamicsParams):
        return {"kind": "DynamicsParams",
                "params": {k: t.detach() for k, t in state._asdict().items()}}
    raise TypeError(f"checkpoint: cannot save a {type(state).__name__}; "
                    "a TrainState or DynamicsParams is expected")


def save(path: str, state: State) -> None:
    """Write ``state`` to the file ``path`` (its directory is made if
    missing; the file is replaced whole, never left half written)."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save(_payload(state), tmp)
    os.replace(tmp, path)


def restore(path: str, template: State) -> State:
    """Load the checkpoint at ``path`` into ``template`` (a state of the
    same kind and shapes) in place, onto the template's device, and return
    it: a TrainState's field parameters and optimizer state are loaded
    (the optimizer stays bound to the field) and its step comes back from
    the file; a DynamicsParams' tensors are overwritten."""
    kind = _payload(template)["kind"]
    leaf = (template.field.means if isinstance(template, TrainState)
            else template.transform)
    saved = torch.load(os.path.abspath(path), map_location=leaf.device,
                       weights_only=True)
    if saved.get("kind") != kind:
        raise ValueError(f"checkpoint {path} holds a {saved.get('kind')}, "
                         f"the template is a {kind}")
    if kind == "TrainState":
        template.field.load_state_dict(saved["field"])
        template.optimizer.load_state_dict(saved["optimizer"])
        return template._replace(step=saved["step"])
    with torch.no_grad():
        for name, t in template._asdict().items():
            src = saved["params"][name]
            if src.shape != t.shape:
                raise ValueError(f"checkpoint {path}: {name} has shape "
                                 f"{tuple(src.shape)}, the template "
                                 f"{tuple(t.shape)}")
            t.copy_(src)
    return template
