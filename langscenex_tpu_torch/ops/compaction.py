"""Stream compaction of int32 (key, sid) slots — kernel K3.

Port of the JAX ``ops/compaction.py`` (the TPU ``_compact_kernel`` behind
``compact_pairs``). Slots with ``key < sent_min`` move to the front and
the tail is ``(sent_fill_key, sent_fill_sid)``. The GPU kernel
(``csrc/compaction.cu``) is an order-preserving two-pass scan compaction,
so it equals the argsort reference (``compact_pairs_ref`` in the JAX
package) exactly; the TPU kernel's in-row order was arbitrary, so against
it the streams agree after a sort. The output has ``out_len`` slots;
callers guarantee the valid count fits (binning's budget mask does).

:func:`compact_pairs` launches the kernel for CUDA tensors and runs the
plain version (:func:`compact_pairs_plain`) for CPU tensors.
"""
from __future__ import annotations

import torch

from .. import _build

CMP_TILE = 2048           # slots per block (csrc/compaction.cu)


def _check(key: torch.Tensor, sid: torch.Tensor, out_len: int) -> None:
    if key.dim() != 1 or sid.shape != key.shape:
        raise ValueError(f"compact_pairs wants two [N] tensors, got "
                         f"{tuple(key.shape)} and {tuple(sid.shape)}")
    if key.dtype != torch.int32 or sid.dtype != torch.int32:
        raise TypeError(f"compact_pairs wants int32, got {key.dtype}, "
                        f"{sid.dtype}")
    if key.device != sid.device:
        raise ValueError("key and sid are on different devices")
    if out_len < 0:
        raise ValueError(f"out_len must be >= 0, got {out_len}")


def compact_pairs_plain(key: torch.Tensor, sid: torch.Tensor, sent_min: int,
                        out_len: int, sent_fill_key: int,
                        sent_fill_sid: int):
    """Argsort-form reference: a stable argsort of the invalid flag puts
    valid slots first in input order; the rest becomes the fill."""
    _check(key, sid, out_len)
    valid = key < sent_min
    order = torch.argsort((~valid).to(torch.int32), stable=True)
    vo = valid[order]
    k = torch.where(vo, key[order], sent_fill_key)
    s = torch.where(vo, sid[order], sent_fill_sid)
    n = key.numel()
    if out_len <= n:
        return k[:out_len], s[:out_len]
    pad = out_len - n
    return (torch.cat([k, k.new_full((pad,), sent_fill_key)]),
            torch.cat([s, s.new_full((pad,), sent_fill_sid)]))


def compact_pairs(key: torch.Tensor, sid: torch.Tensor, sent_min: int,
                  out_len: int, sent_fill_key: int, sent_fill_sid: int):
    """Front-pack the valid (key < sent_min) slots into [out_len] streams."""
    _check(key, sid, out_len)
    if key.device.type == "cpu":
        return compact_pairs_plain(key, sid, sent_min, out_len,
                                   sent_fill_key, sent_fill_sid)
    if key.device.type != "cuda":
        raise ValueError(f"compact_pairs: unsupported device {key.device}")
    key = key.contiguous()
    sid = sid.contiguous()
    n = key.numel()
    n_blocks = (n + CMP_TILE - 1) // CMP_TILE
    out_k = torch.empty(out_len, dtype=torch.int32, device=key.device)
    out_s = torch.empty(out_len, dtype=torch.int32, device=key.device)
    counts = torch.empty(n_blocks + 1, dtype=torch.int32, device=key.device)
    lib = _build.library()
    code = lib.lsx_compact_pairs(
        key.data_ptr(), sid.data_ptr(), out_k.data_ptr(), out_s.data_ptr(),
        counts.data_ptr(), n, out_len, n_blocks, int(sent_min),
        int(sent_fill_key), int(sent_fill_sid),
        _build.stream_ptr(key.device))
    _build.launch_counts["compact_pairs"] += 1
    _build.check(code, "compact_pairs")
    return out_k, out_s
