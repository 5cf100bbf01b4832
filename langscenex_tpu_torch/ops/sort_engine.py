"""Stable int32 (key, value) pair sort — kernel K4.

Port of the JAX ``ops/sort_engine.py`` (the TPU bitonic network
``_local_kernel`` + ``_cross_kernel`` behind ``bitonic_sort_pairs``). On
the GPU the network becomes a stable LSD radix sort (``csrc/sort.cu``):
stability gives the ``tie_sid=True`` order (equal keys by input position)
for free, and any length is accepted, so callers need no power-of-two
padding. Contract: identical to a stable ``lax.sort((key, val),
num_keys=1)`` for every int32 key.

:func:`sort_pairs` launches the kernel for CUDA tensors and runs the plain
version (:func:`sort_pairs_plain`) for CPU tensors.
"""
from __future__ import annotations

import torch

from .. import _build

SORT_TILE = 2048          # elements per radix block (csrc/sort.cu)
RADIX = 256


def _check_pair(key: torch.Tensor, val: torch.Tensor) -> None:
    if key.dim() != 1 or val.shape != key.shape:
        raise ValueError(f"sort_pairs wants two [N] tensors, got "
                         f"{tuple(key.shape)} and {tuple(val.shape)}")
    if key.dtype != torch.int32 or val.dtype != torch.int32:
        raise TypeError(f"sort_pairs wants int32, got {key.dtype}, "
                        f"{val.dtype}")
    if key.device != val.device:
        raise ValueError("key and val are on different devices")


def sort_pairs_plain(key: torch.Tensor, val: torch.Tensor):
    """Stable sort by key, carrying val: the reference for the kernel."""
    _check_pair(key, val)
    skey, order = torch.sort(key, stable=True)
    return skey, val[order]


def sort_pairs(key: torch.Tensor, val: torch.Tensor):
    """(sorted key, val in key order); stable on equal keys."""
    _check_pair(key, val)
    if key.device.type == "cpu":
        return sort_pairs_plain(key, val)
    if key.device.type != "cuda":
        raise ValueError(f"sort_pairs: unsupported device {key.device}")
    key = key.contiguous()
    val = val.contiguous()
    n = key.numel()
    n_blocks = (n + SORT_TILE - 1) // SORT_TILE
    out_k = torch.empty_like(key)
    out_v = torch.empty_like(val)
    tmp_k = torch.empty_like(key)
    tmp_v = torch.empty_like(val)
    hist = torch.empty(max(1, RADIX * n_blocks), dtype=torch.int32,
                       device=key.device)
    lib = _build.library()
    code = lib.lsx_sort_pairs(
        key.data_ptr(), val.data_ptr(), out_k.data_ptr(), out_v.data_ptr(),
        tmp_k.data_ptr(), tmp_v.data_ptr(), hist.data_ptr(), n, n_blocks,
        _build.stream_ptr(key.device))
    _build.launch_counts["sort_pairs"] += 1
    _build.check(code, "sort_pairs")
    return out_k, out_v
