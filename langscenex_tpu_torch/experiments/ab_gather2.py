"""Row-gather probes: the library row gather (``torch.index_select``, the
counterpart of the JAX script's XLA gather) against the number of rows A
and the row width W, and the hand-written gather K13c (``gather_rows``)
from a table of P = 100,000 rows held in device memory (9.6 MB in f32 at
W = 24, within the H100's 50 MB L2), in f32 and bf16.

    python -m langscenex_tpu_torch.experiments.ab_gather2 [--device cpu]
        [--iters 100]

The tables and indices are the JAX script's numpy draws (seed 0: the
table, then the indices in [0, P)). Each time is the mean over ``iters``
calls queued on the card behind a spin, so that it is the device's time
for a gather of a few microseconds and not the host's launch cost."""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..ops.gather import gather_rows
from ..utils.device import resolve_device
from . import time_ms

P = 100_000                                # table rows
SIZES = (160_000, 640_000, 1_280_000)      # A of the library sweep, W = 24
WIDTHS = (8, 128)                          # W of the library sweep
KERNEL_A = 640_000                         # A of the kernel and the W sweep


def timed(fn, args, device, n: int = 100) -> float:
    """Mean ms of ``fn(*args)`` over ``n`` queued calls after one warmup."""
    return time_ms(lambda: fn(*args), n, device, queued=True)


def draws(rows: int, W: int, A: int, dtype, device):
    """The JAX script's inputs: a table [rows, W] of unit normals (rounded
    through f32, as ``jnp.asarray`` rounds them) and A indices in [0, P),
    both from numpy seed 0."""
    rng = np.random.default_rng(0)
    tab = torch.from_numpy(rng.normal(size=(rows, W)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, P, A).astype(np.int32))
    return tab.to(device, dtype), idx.to(device)


def _library(tab, idx):
    return torch.index_select(tab, 0, idx)


def library_gather(A: int, W: int, device=None, iters: int = 100) -> float:
    """``xla_gather``'s counterpart: ``torch.index_select`` of A rows of a
    [P + 1, W] f32 table; prints M rows/s and useful GB/s, returns ms."""
    dev = resolve_device(device)
    ms = timed(_library, draws(P + 1, W, A, torch.float32, dev), dev, iters)
    print(f"index_select row gather A={A:8d} W={W:3d}: {ms:9.4f} ms  "
          f"{A / ms * 1e3 / 1e6:8.1f} M rows/s  "
          f"{A * W * 4 / ms * 1e3 / 1e9:7.1f} GB/s useful", flush=True)
    return ms


def kernel_gather(A: int, W: int = 24, table_bf16: bool = False,
                  device=None, iters: int = 100) -> float:
    """``pallas_gather``'s counterpart: ``gather_rows`` (K13c on the card)
    of A rows of a [P + 8, W] table in f32 or bf16 into [A / 512, 512, W];
    prints M rows/s and useful GB/s, returns ms."""
    dev = resolve_device(device)
    dt = torch.bfloat16 if table_bf16 else torch.float32
    ms = timed(gather_rows, draws(P + 8, W, A, dt, dev), dev, iters)
    print(f"gather_rows (K13c) A={A:8d} W={W:3d} {str(dt)[6:]:8s}: "
          f"{ms:9.4f} ms  {A / ms * 1e3 / 1e6:8.1f} M rows/s  "
          f"{A * W * (2 if table_bf16 else 4) / ms * 1e3 / 1e9:7.1f} GB/s "
          f"useful", flush=True)
    return ms


def main(iters: int = 100, device=None, sizes=SIZES, widths=WIDTHS,
         kernel_a: int = KERNEL_A) -> dict:
    """The JAX script's sweep: the library gather at each A of ``sizes``
    (W = 24) and each W of ``widths`` (A = ``kernel_a``), then the kernel
    at A = ``kernel_a``, W = 24, in f32 and bf16; returns {name: ms}."""
    dev = resolve_device(device)
    out = {}
    for A in sizes:
        out[f"index_select A={A} W=24"] = library_gather(A, 24, dev, iters)
    for W in widths:
        out[f"index_select A={kernel_a} W={W}"] = library_gather(
            kernel_a, W, dev, iters)
    for bf16 in (False, True):
        out[f"gather_rows A={kernel_a} W=24 {'bf16' if bf16 else 'f32'}"] = (
            kernel_gather(kernel_a, 24, bf16, dev, iters))
    return out


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None,
                   help="torch device (default: the first CUDA card)")
    p.add_argument("--iters", type=int, default=100)
    a = p.parse_args()
    main(a.iters, resolve_device(a.device))
