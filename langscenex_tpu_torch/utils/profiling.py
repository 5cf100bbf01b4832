"""Tracing and step timing, port of the JAX package's
``utils/profiling.py``: an EMA wall-clock timer per phase, a
``torch.profiler`` trace context that writes a Chrome trace, and named
trace ranges.

    with device_trace("traces/"):
        with annotate("train_step"):
            step(...)

writes ``traces/trace_<pid>_<n>.json`` (open it in Perfetto or
chrome://tracing); the card's kernels are in it when CUDA is available.
"""
from __future__ import annotations

import contextlib
import itertools
import os
import time
from collections import defaultdict
from typing import Dict

import torch

_TRACES = itertools.count()


class StepTimer:
    """Per-phase EMA wall-clock timer. The reference's tqdm postfix uses
    0.4/0.6 EMA smoothing (gaussian_field.py:490-511); same decay here."""

    def __init__(self, decay: float = 0.6):
        self.decay = decay
        self.ema: Dict[str, float] = {}
        self.count: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            prev = self.ema.get(name)
            self.ema[name] = dt if prev is None else \
                (1 - self.decay) * dt + self.decay * prev
            self.count[name] += 1

    def summary(self) -> str:
        return " ".join(f"{k}={v * 1000:.1f}ms" for k, v in
                        sorted(self.ema.items()))


@contextlib.contextmanager
def device_trace(log_dir: str):
    """A ``torch.profiler`` trace of the block (the CPU, and the card when
    CUDA is available) written to ``log_dir`` as a Chrome trace; yields
    the profiler. The file's path is its ``trace_path`` after the
    block."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.trace_path = os.path.join(
        log_dir, f"trace_{os.getpid()}_{next(_TRACES)}.json")
    prof.export_chrome_trace(prof.trace_path)


def annotate(name: str):
    """A named range in the profiler's timeline."""
    return torch.profiler.record_function(name)
