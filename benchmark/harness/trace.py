"""The traced window: one ``torch.profiler`` trace of the device and the
host, reduced to what the per-layer metrics read.

Spans are ``record_function`` ranges that the benchmark's drivers put
around calls into the program (``wrap`` below). On the device each span
shows as the range from the first to the last kernel launched inside it;
the device time of a span is the union of the kernel intervals inside
that range, so a kernel of another name that a later version launches in
the same call is timed too. The busy time is the union of all kernel
intervals inside the window, and the window is the host's span around
the traced work, which ends in a synchronise.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

WINDOW = "bench.window"
NAME_CHARS = 120


@dataclass
class Trace:
    window_s: float
    busy_s: float
    units: int                       # iterations or steps traced
    kernels: list                    # (name, start_us, end_us), in order
    span_device_ms: dict             # span name -> [device ms per instance]
    device_ops: list                 # [[name, seconds]] top by time
    idle_gaps: list                  # [[host activity, seconds]] top by time
    records: dict = field(default_factory=dict)   # what the driver kept


def wrap(obj, attr: str, name: str, on_call=None):
    """Replace ``obj.attr`` by a function that runs it inside a named range
    of the trace (and calls ``on_call(args, kwargs, out)`` after it).
    Returns the function that restores the original: a driver wraps only
    around a traced window."""
    inner = getattr(obj, attr)

    def wrapped(*args, **kwargs):
        with torch.profiler.record_function(name):
            out = inner(*args, **kwargs)
        if on_call is not None:
            on_call(args, kwargs, out)
        return out
    setattr(obj, attr, wrapped)
    return lambda: setattr(obj, attr, inner)


def _union(iv: np.ndarray) -> np.ndarray:
    """Disjoint sorted intervals covering [n, 2] intervals."""
    if len(iv) == 0:
        return iv.reshape(0, 2)
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    out = [list(iv[0])]
    for s, e in iv[1:]:
        if s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return np.asarray(out)


def _length(iv: np.ndarray) -> float:
    return float((iv[:, 1] - iv[:, 0]).sum()) if len(iv) else 0.0


def take(run_window, records: dict | None = None) -> Trace:
    """Trace ``run_window()`` (which returns the units of work it ran) and
    reduce the trace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    card = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if card else [])
    sync = torch.cuda.synchronize if card else (lambda: None)
    sync()
    with profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW):
            units = run_window()
            sync()
    # the raw events: torch's own parsing into FunctionEvents takes tens
    # of seconds for a field window and is not needed here (times in us)
    events = [(e.name(), e.device_type(), e.start_ns() / 1e3,
               e.end_ns() / 1e3, e.is_user_annotation())
              for e in prof.profiler.kineto_results.events()
              if not getattr(e, "is_hidden_event", lambda: False)()]
    win = [e for e in events if e[0] == WINDOW
           and e[1] == DeviceType.CPU]
    if not win:
        raise RuntimeError("the trace holds no window span")
    w0, w1 = win[0][2], win[0][3]
    kern, notes, host = [], [], []
    for name, dev, s, e, note in events:
        if dev == DeviceType.CUDA:
            if note:
                notes.append((name, s, e))
            elif w0 <= s and e <= w1:
                kern.append((name, s, e))
        elif dev == DeviceType.CPU and name != WINDOW \
                and not name.startswith("cuda"):
            host.append((name, s, e))
    kern.sort(key=lambda k: k[1])
    iv = np.asarray([(s, e) for _, s, e in kern], dtype=np.float64)
    busy = _union(iv.reshape(-1, 2))
    spans = {}
    starts = iv[:, 0] if len(iv) else np.zeros(0)
    for name, s, e in notes:
        if not name.startswith("bench."):
            continue
        inside = iv[(starts >= s) & (iv[:, 1] <= e)] if len(iv) else iv
        spans.setdefault(name, []).append(_length(_union(inside)) / 1e3)
    by_name = {}
    for name, s, e in kern:
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e6
    device_ops = sorted(([n[:NAME_CHARS], t] for n, t in by_name.items()),
                        key=lambda x: -x[1])[:10]
    return Trace(window_s=(w1 - w0) / 1e6, busy_s=_length(busy) / 1e6,
                 units=int(units), kernels=kern, span_device_ms=spans,
                 device_ops=device_ops,
                 idle_gaps=_idle_gaps(busy, w0, w1, host),
                 records=records if records is not None else {})


def _idle_gaps(busy: np.ndarray, w0: float, w1: float, host: list,
               longest: int = 2000) -> list:
    """The device's idle gaps inside the window, summed by what the host
    was doing when each began (the innermost host range around it), for
    the ``longest`` gaps; the ten largest sums."""
    edges = np.concatenate([[w0], busy.reshape(-1), [w1]]).reshape(-1, 2)
    gaps = edges[edges[:, 1] > edges[:, 0]]
    if not len(gaps):
        return []
    gaps = gaps[np.argsort(gaps[:, 0] - gaps[:, 1])][:longest]
    hs = np.asarray([h[1] for h in host]) if host else np.zeros(0)
    he = np.asarray([h[2] for h in host]) if host else np.zeros(0)
    sums = {}
    for s, e in gaps:
        t = s + 0.5 * min(e - s, 1.0)
        hit = np.nonzero((hs <= t) & (he >= t))[0]
        name = (host[hit[np.argmax(hs[hit])]][0][:NAME_CHARS] if len(hit)
                else "no host range")
        sums[name] = sums.get(name, 0.0) + (e - s) / 1e6
    return sorted(([n, v] for n, v in sums.items()), key=lambda x: -x[1])[:10]

