"""Checkpoint and resume for the field trainer and the fine-tune states.

Port of the JAX ``train/checkpoint.py``: a state is saved as
``<path>/chkpnt<iteration>`` and the latest is found by that name, as
the reference's ``searchForMaxIteration`` does. The JAX package writes
orbax directories; here the file is a ``torch.save`` of the state as
nested dicts of tensors, ints, floats and strings (the DiT state of
``train/dit.py``, the LoRA state of ``train/lora.py``, or the field
trainer's, see ``GaussianFieldTrainer.save_checkpoint``), read back with
``weights_only=True``. Orbax checkpoints are not read.

A checkpoint path may also name one ``chkpnt<it>`` file, as the
reference's ``start_checkpoint`` does.
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
    """(state, iteration) of ``path/chkpnt<iteration>``, of the latest
    under ``path``, or of the ``chkpnt<it>`` file ``path``; its tensors on
    the devices they were saved from. With a ``template`` state, the
    restored one must have its keys."""
    name = os.path.basename(path)
    if (iteration is None and os.path.isfile(path) and name.startswith(PREFIX)
            and name[len(PREFIX):].isdigit()):
        path, iteration = os.path.dirname(path), int(name[len(PREFIX):])
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
