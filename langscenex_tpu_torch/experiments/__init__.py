"""Measurements of the port, ported from the JAX package's
``experiments/``: attention at the DiT's shape (``ab_attention.py``,
``ab_attention2.py``, ``ab_attention4.py``) and the row gather
(``ab_gather2.py``). Each module has a ``main`` (which ``chip_smoke.py``
calls) and a CLI:

    python -m langscenex_tpu_torch.experiments.ab_attention [--device cpu]
    python -m langscenex_tpu_torch.experiments.ab_attention2 [--device cpu]
    python -m langscenex_tpu_torch.experiments.ab_attention4 [--device cpu]
    python -m langscenex_tpu_torch.experiments.ab_gather2 [--device cpu]

All run on the card by default; ``--heads`` and ``--tokens`` cut the
attention shape (the full one is far too large for the CPU, where the
kernels' plain versions run and the times are the host's)."""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..utils.device import resolve_device

B, H, T, D = 1, 48, 17776, 64        # the DiT's attention: 48 heads, 17,776
#                                      joint text + video tokens, head dim 64
PEAK_BF16_FLOPS = 989e12             # H100 SXM, dense bf16 tensor cores
SPIN_CYCLES = 40_000_000             # about 20 ms at the H100's 1.98 GHz


def seed_inputs(device, heads: int = H, tokens: int = T):
    """q, k, v [1, heads, tokens, 64] bf16 from numpy seed 0, drawn in the
    JAX scripts' order."""
    rng = np.random.default_rng(0)
    return tuple(torch.from_numpy(rng.normal(size=(B, heads, tokens, D))
                                  .astype(np.float32)).to(device,
                                                          torch.bfloat16)
                 for _ in range(3))


def time_ms(fn, iters: int, device, warmup: int = 1,
            queued: bool = False) -> float:
    """Mean milliseconds of ``fn()`` over ``iters`` calls after ``warmup``:
    CUDA events on the card, the host clock on the CPU. With ``queued``
    the card first spins for about 20 ms (``torch.cuda._sleep``) while the
    host enqueues the calls, so that a kernel of a few microseconds is
    timed back to back on the device, without the host's launch cost."""
    for _ in range(warmup):
        fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters * 1e3
    torch.cuda.synchronize(device)
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(SPIN_CYCLES)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize(device)
    return t0.elapsed_time(t1) / iters


def report(name: str, ms: float, flops: float, device) -> str:
    """One result line: the time and, on the card, the share of its bf16
    peak that ``flops`` in that time is."""
    if device.type != "cuda":
        return f"{name:40s} {ms:10.2f} ms (host clock, {device})"
    return (f"{name:40s} {ms:10.4f} ms   {flops / ms * 1e3 / 1e12:7.1f} "
            f"TFLOP/s, {flops / (ms * 1e-3) / PEAK_BF16_FLOPS * 100:5.1f}% "
            f"of 989 TFLOP/s")


def parse_args(doc: str, argv=None, tokens=T,
               block=None) -> argparse.Namespace:
    """``--device``, ``--iters``, ``--heads``, ``--tokens`` (one length, or
    several when ``tokens`` is a tuple) and, given a default, ``--block``."""
    p = argparse.ArgumentParser(description=doc.splitlines()[0])
    p.add_argument("--device", default=None,
                   help="torch device (default: the first CUDA card)")
    p.add_argument("--iters", type=int, default=8)
    p.add_argument("--heads", type=int, default=H)
    if isinstance(tokens, tuple):
        p.add_argument("--tokens", type=int, nargs="+", default=list(tokens))
    else:
        p.add_argument("--tokens", type=int, default=tokens)
    if block is not None:
        p.add_argument("--block", type=int, default=block)
    args = p.parse_args(argv)
    args.device = resolve_device(args.device)
    return args
