"""Stream compaction of int32 (key, sid) slots — kernel K3.

Port of the JAX ``ops/compaction.py`` (the TPU ``_compact_kernel`` behind
``compact_pairs``). Slots with ``key < sent_min`` move to the front and
the tail is ``(sent_fill_key, sent_fill_sid)``. The GPU kernel
(``csrc/compaction.cu``) is a single-pass, order-preserving compaction
(one launch: a decoupled look-back over 4,096-slot tiles), so it equals
the argsort reference (``compact_pairs_ref`` in the JAX package) exactly;
the TPU kernel's in-row order was arbitrary, so against it the streams
agree after a sort. The output has ``out_len`` slots: valid slots past it
are dropped (binning's budget mask keeps the valid count within it).

:func:`compact_pairs` launches the kernel or runs the plain version
(:func:`compact_pairs_plain`) by ``_build``'s rule.
"""
from __future__ import annotations

import torch

from .. import _build

CMP_TILE = 4096           # slots per block (csrc/compaction.cu)
MAX_SLOTS = 1 << 30       # the status words hold 30-bit counts
STATUS_STRIDE = 4         # int64 words per status word (one 32-byte sector)


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


def tile_layout(key_ptr: int, n: int) -> tuple[int, int]:
    """(pad, n_tiles) of the kernel's tiles over ``n`` keys at address
    ``key_ptr``: slot i sits at position i + pad, so that each thread's
    four slots are one 16-byte load; pad is the key's offset from the
    16-byte boundary below it, in slots. Raises on a key that is not
    4-byte aligned or a stream of 2^30 slots or more."""
    if key_ptr % 4:
        raise ValueError(f"compact_pairs: key at {key_ptr:#x} is not 4-byte "
                         "aligned")
    if n >= MAX_SLOTS:
        raise ValueError(f"compact_pairs takes fewer than {MAX_SLOTS} slots, "
                         f"got {n}")
    pad = (key_ptr // 4) % 4
    return pad, max(1, -(-(n + pad) // CMP_TILE))


class StatusWords:
    """The kernel's scratch, one buffer per (device, stream): a ticket and
    epoch word and one status word per tile, each in its own 32-byte
    sector of int64 words. Zeroed when it is allocated; it grows to the
    next power of two of the words a call needs and never shrinks, so a
    steady caller allocates and clears nothing. The kernel leaves it ready
    for the next call on its stream."""

    def __init__(self):
        self._bufs: dict = {}

    def get(self, device: torch.device, stream, n_tiles: int) -> torch.Tensor:
        need = STATUS_STRIDE * (1 + n_tiles)
        buf = self._bufs.get((device, stream))
        if buf is None or buf.numel() < need:
            buf = torch.zeros(1 << (need - 1).bit_length(), dtype=torch.int64,
                              device=device)
            self._bufs[(device, stream)] = buf
        return buf


_status = StatusWords()


def compact_pairs(key: torch.Tensor, sid: torch.Tensor, sent_min: int,
                  out_len: int, sent_fill_key: int, sent_fill_sid: int):
    """Front-pack the valid (key < sent_min) slots into [out_len] streams."""
    _check(key, sid, out_len)
    if not _build.use_kernel(key):
        return compact_pairs_plain(key, sid, sent_min, out_len,
                                   sent_fill_key, sent_fill_sid)
    key = key.contiguous()
    sid = sid.contiguous()
    n = key.numel()
    out_k = torch.empty(out_len, dtype=torch.int32, device=key.device)
    out_s = torch.empty(out_len, dtype=torch.int32, device=key.device)
    if out_len == 0:
        return out_k, out_s
    _, n_tiles = tile_layout(key.data_ptr(), n)
    status = _status.get(key.device, torch.cuda.current_stream(key.device),
                         n_tiles)
    _build.launch("compact_pairs", key.device, key.data_ptr(), sid.data_ptr(),
                  out_k.data_ptr(), out_s.data_ptr(), status.data_ptr(), n,
                  out_len, n_tiles, int(sent_min), int(sent_fill_key),
                  int(sent_fill_sid))
    return out_k, out_s
