"""Row gather — kernel K13c — from a table held on the device.

Port of the in-kernel gather of ``experiments/ab_gather2.py``
(``pallas_gather``, whose kernel ``kern`` takes ``jnp.take`` of the
VMEM-resident table at a chunk of 512 indices): :func:`gather_rows` takes
a table [R, W] of f32 or bf16 and int32 indices [A], A a multiple of
``CHUNK``, and returns the rows [A / 512, 512, W], as the Pallas call's
output is laid out.

Out-of-range indices follow ``jnp.take``'s default ``"fill"`` mode: an
index in [-R, 0) counts from the end, any other outside [0, R) gives a row
of NaN. In range the gather is ``tab.index_select(0, idx)`` exactly.

:func:`gather_rows_kernel` launches the kernel on CUDA tensors and raises
on what it does not take; :func:`gather_rows_plain` is its plain version.
:func:`gather_rows` takes one or the other by ``_build``'s rule and never
falls back to the plain version.
"""
from __future__ import annotations

import torch

from .. import _build

CHUNK = 512                # indices per grid step of the TPU kernel
DTYPES = (torch.float32, torch.bfloat16)


def _check(tab: torch.Tensor, idx: torch.Tensor) -> None:
    if tab.dim() != 2 or idx.dim() != 1 or tab.shape[0] == 0:
        raise ValueError(f"gather_rows wants a table [R, W] with R > 0 and "
                         f"indices [A], got {tuple(tab.shape)}, "
                         f"{tuple(idx.shape)}")
    if tab.dtype not in DTYPES or idx.dtype != torch.int32:
        raise TypeError(f"gather_rows takes an f32 or bf16 table and int32 "
                        f"indices, got {tab.dtype}, {idx.dtype}")
    if tab.device != idx.device:
        raise ValueError(f"gather_rows: table on {tab.device}, indices on "
                         f"{idx.device}")


def gather_rows_plain(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """K13c's plain version: rows [A, W] of ``tab`` [R, W] at ``idx`` [A],
    with ``jnp.take``'s fill mode for indices outside [-R, R)."""
    _check(tab, idx)
    R = tab.shape[0]
    j = torch.where(idx < 0, idx + R, idx)
    ok = (j >= 0) & (j < R)
    rows = tab.index_select(0, torch.where(ok, j, 0))
    return rows.masked_fill(~ok[:, None], float("nan"))


def gather_rows_kernel(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Launch K13c: ``tab`` [R, W] f32 or bf16 and ``idx`` [A] int32 on one
    CUDA device -> rows [A, W] in ``tab``'s dtype. Rows of a whole number of
    16-byte vectors are copied by vector, others element by element."""
    _check(tab, idx)
    if tab.device.type != "cuda":
        raise ValueError(f"gather kernel K13c takes CUDA tensors, got "
                         f"{tab.device}")
    if max(tab.shape[0], idx.shape[0]) >= 2 ** 31:
        raise ValueError("gather kernel K13c takes fewer than 2^31 rows and "
                         "indices")
    tab, idx = tab.contiguous(), idx.contiguous()
    A, (R, W) = idx.shape[0], tab.shape
    out = torch.empty((A, W), dtype=tab.dtype, device=tab.device)
    _build.launch("gather_rows", tab.device, tab.data_ptr(), idx.data_ptr(),
                  out.data_ptr(), R, W, A, tab.element_size())
    return out


def gather_rows(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``pallas_gather``'s function: rows [A / 512, 512, W] of ``tab``
    [R, W] at ``idx`` [A], A a multiple of 512: K13c or its plain version
    by ``_build``'s rule."""
    _check(tab, idx)
    A = idx.shape[0]
    if A % CHUNK:
        raise ValueError(f"gather_rows takes a multiple of {CHUNK} indices "
                         f"(the TPU kernel's chunk), got {A}")
    rows = (gather_rows_kernel if _build.use_kernel(tab)
            else gather_rows_plain)(tab, idx)
    return rows.reshape(A // CHUNK, CHUNK, tab.shape[1])
