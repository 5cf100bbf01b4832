"""Checkpoint and resume for the fine-tune states.

Port of the JAX ``train/checkpoint.py``: a state is saved as
``<path>/chkpnt<iteration>`` and the latest is found by that name, as
the reference's ``searchForMaxIteration`` does. The JAX package writes
orbax directories; here the file is a ``torch.save`` of the state (the
DiT state of ``train/dit.py`` or the LoRA state of ``train/lora.py``:
dicts of tensors and ints), read back with ``weights_only=True``. Orbax
checkpoints are not read.
"""
from __future__ import annotations

import os
from typing import Any, Optional, Tuple

import torch

PREFIX = "chkpnt"


def save_checkpoint(path: str, state: Any, iteration: int) -> None:
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, f".{PREFIX}{iteration}.tmp")
    torch.save(state, tmp)
    os.replace(tmp, os.path.join(path, f"{PREFIX}{iteration}"))


def latest_iteration(path: str) -> Optional[int]:
    """The largest iteration of the ``chkpnt<it>`` entries under path."""
    if not os.path.isdir(path):
        return None
    its = [int(d[len(PREFIX):]) for d in os.listdir(path)
           if d.startswith(PREFIX) and d[len(PREFIX):].isdigit()]
    return max(its) if its else None


def restore_checkpoint(path: str, template: Any = None,
                       iteration: Optional[int] = None) -> Tuple[Any, int]:
    """(state, iteration) of the given or latest checkpoint, its tensors
    on the devices they were saved from. With a ``template`` state, the
    restored one must have its keys."""
    it = iteration if iteration is not None else latest_iteration(path)
    if it is None:
        raise FileNotFoundError(f"no checkpoints under {path}")
    state = torch.load(os.path.join(path, f"{PREFIX}{it}"),
                       weights_only=True)
    if template is not None and isinstance(template, dict) and (
            state.keys() != template.keys()):
        raise KeyError(f"checkpoint keys {sorted(state)} differ from the "
                       f"template's {sorted(template)}")
    return state, it
