"""Stable int32 (key, value) pair sort — kernel K4.

Port of the JAX ``ops/sort_engine.py`` (the TPU bitonic network
``_local_kernel`` + ``_cross_kernel`` behind ``bitonic_sort_pairs``). On
the GPU the network becomes a stable LSD radix sort (``csrc/sort.cu``):
stability gives the ``tie_sid=True`` order (equal keys by input position)
for free, and any length is accepted, so callers need no power-of-two
padding. Contract: identical to a stable ``lax.sort((key, val),
num_keys=1)`` for every int32 key. The kernel is a onesweep sort: one
upsweep over all four digits, then one launch per digit whose blocks find
their offsets by decoupled look-back; the wrapper allocates one scratch
tensor per call, sized by :func:`sort_scratch_words`.

:func:`sort_pairs` launches the kernel for CUDA tensors and runs the plain
version (:func:`sort_pairs_plain`) for CPU tensors.
"""
from __future__ import annotations

import torch

from .. import _build

SORT_TILE = 2048          # keys per onesweep tile (csrc/sort.cu)
RADIX = 256
NUM_PASSES = 4
MAX_PAIRS = 1 << 30       # a status word holds a count in 30 bits


def sort_scratch_words(n: int) -> int:
    """32-bit words of the kernel's scratch for n pairs, laid out as
    csrc/sort.cu reads it: the four digit histograms, one ticket per pass
    (padded to 16 words), a status word per (pass, tile, digit), then the
    ping-pong keys and values (n words each)."""
    n_tiles = -(-n // SORT_TILE)
    return NUM_PASSES * RADIX + 16 + NUM_PASSES * n_tiles * RADIX + 2 * n


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
    n = key.numel()
    if n >= MAX_PAIRS:
        raise ValueError(f"sort_pairs takes fewer than 2^30 pairs, got {n}")
    key = key.contiguous()
    val = val.contiguous()
    out_k = torch.empty_like(key)
    out_v = torch.empty_like(val)
    scratch = torch.empty(sort_scratch_words(n), dtype=torch.int32,
                          device=key.device)
    code = _build.library().lsx_sort_pairs(
        key.data_ptr(), val.data_ptr(), out_k.data_ptr(), out_v.data_ptr(),
        scratch.data_ptr(), n, _build.stream_ptr(key.device))
    _build.launch_counts["sort_pairs"] += 1
    _build.check(code, "sort_pairs")
    return out_k, out_v
