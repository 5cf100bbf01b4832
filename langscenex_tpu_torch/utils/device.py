"""The device an entry point runs on when its caller names none.

Every entry point of the port takes ``device=None`` and resolves it here:
the first CUDA card, or a ``RuntimeError`` when there is none. There is
no silent CPU fallback; the CPU tests ask for ``device="cpu"``.
"""
from __future__ import annotations

import torch


def default_device() -> torch.device:
    """``cuda:0``; raises when no CUDA device exists."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the GPU by default; pass "
            "device='cpu' to run on the CPU")
    return torch.device("cuda", 0)


def resolve_device(device: torch.device | str | None) -> torch.device:
    """``device`` as a ``torch.device``, or :func:`default_device` for
    None."""
    return default_device() if device is None else torch.device(device)
