"""What the per-layer metrics read from the program's own spans and
counters (``langscenex_tpu_torch/utils/profiling``): the span log and the
counters of the last profiler session, which is the traced window, and
the device's idle time split by the host span it fell in.

A program without the span log (one older than its spans) reads as
nothing: every function here then returns None.
"""
from __future__ import annotations

import numpy as np


def _profiling():
    try:
        from langscenex_tpu_torch.utils import profiling
    except ImportError:
        return None
    if not hasattr(profiling, "records"):
        return None
    return profiling


def log() -> list | None:
    """The spans of the last session, or None without a span log."""
    p = _profiling()
    return list(p.records()) if p is not None else None


def counted(name: str) -> int | None:
    """What counter ``name`` counted in the last session, or None where the
    program has no such counter."""
    p = _profiling()
    if p is None or name not in p.counters:
        return None
    return p.session_counts().get(name)


def device_ms_per_unit(ctx, name: str) -> float | None:
    """The device ms of every span ``name`` in the window over the units
    of work traced; None where no such span was recorded or one has no
    device time."""
    spans = [r for r in log() or () if r.name == name]
    ms = [r.device_ms for r in spans]
    if not spans or any(m is None for m in ms) or not ctx.trace.units:
        return None
    return sum(ms) / ctx.trace.units


def interior_gaps(kernels: list) -> np.ndarray:
    """[n, 2] (start, end) in us of the gaps between the union of the
    kernel intervals ``(name, start_us, end_us)``, the window's leading and
    trailing idle left out."""
    if not kernels:
        return np.zeros((0, 2))
    iv = np.asarray([(s, e) for _, s, e in kernels], dtype=np.float64)
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    reach = np.maximum.accumulate(iv[:, 1])
    starts = iv[1:, 0]
    gap = starts > reach[:-1]
    return np.stack([reach[:-1][gap], starts[gap]], 1)


def _ranges(spans: list, name: str) -> np.ndarray:
    """Host (start, end) in us of the spans called ``name``, by start."""
    r = np.asarray([(s.start_ns / 1e3, s.end_ns / 1e3) for s in spans
                    if s.name == name], dtype=np.float64).reshape(-1, 2)
    return r[np.argsort(r[:, 0], kind="stable")]


def _inside(t: np.ndarray, ranges: np.ndarray) -> np.ndarray:
    """For each time in ``t``, whether it falls in one of the disjoint
    sorted ``ranges``."""
    if not len(ranges):
        return np.zeros(t.shape, dtype=bool)
    i = np.searchsorted(ranges[:, 0], t, side="right") - 1
    ok = i >= 0
    return ok & (t <= ranges[np.maximum(i, 0), 1])


def idle_split(kernels: list, spans: list, inner: str,
               outer: str) -> dict:
    """The interior idle (ms) split by the host span its gap's midpoint
    falls in: ``inner`` (inside a span ``inner``), ``outer`` (inside a span
    ``outer`` and not ``inner``) and ``elsewhere``; the host spans and the
    kernels are on one clock."""
    gaps = interior_gaps(kernels)
    mid = gaps.mean(1) if len(gaps) else np.zeros(0)
    length = (gaps[:, 1] - gaps[:, 0]) / 1e3 if len(gaps) else np.zeros(0)
    in_inner = _inside(mid, _ranges(spans, inner))
    in_outer = _inside(mid, _ranges(spans, outer)) & ~in_inner
    return {inner: float(length[in_inner].sum()),
            outer: float(length[in_outer].sum()),
            "elsewhere": float(length[~in_inner & ~in_outer].sum())}


def idle_ms_per_unit(ctx, inner: str, outer: str, part: str) -> float | None:
    """``part`` of :func:`idle_split` over the units of work traced; None
    where the window logged no span ``inner``."""
    spans = log()
    if not spans or not any(s.name == inner for s in spans) \
            or not ctx.trace.units:
        return None
    return idle_split(ctx.trace.kernels, spans, inner, outer)[part] \
        / ctx.trace.units
