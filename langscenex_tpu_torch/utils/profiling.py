"""Spans, counters and a Chrome-trace exporter for the port.

A span names a stretch of the program's work:

    with span("field.render"):
        out = render_view(...)

It does nothing unless a ``torch.profiler`` session is recording: then it
opens a ``record_function`` of its name (so the Chrome trace shows it on
the host and, as kineto draws it, over the card's kernels it launched) and
appends a :class:`SpanRecord` to an in-memory log: its name, the span it
ran inside, its thread and its host start and end in ns on the profiler's
own clock (Unix-epoch ns, as kineto stamps its events), and, where CUDA is
in use, two timing events on the current stream whose elapsed time is the
span's device ms. With no profiler recording a span costs one flag check:
no ``record_function``, no allocation, no clock read.

A span's parent is the innermost span open on its thread. A span opened
on a thread with none open takes the open span that adopts such spans
(``span(name, adopts=True)``) as its parent, or none: autograd's engine
runs a backward through CUDA tensors on a thread of its own, so the span
that calls ``torch.autograd.grad`` adopts the spans opened inside it.

The first span that finds the profiler recording after one that found it
off (or after :func:`device_trace` began) starts a new session: the log
is emptied and the counters are snapshotted, so :func:`records` and
:func:`session_counts` hold that session alone.

Counters are plain ints in :data:`counters`, always on: :func:`count` adds
to them. The hand kernels' launch counts are entries of the same dict
(``_build.launch_counts`` reads and writes those entries alone).

An operator's use: wrap any call in :func:`device_trace`

    with device_trace("traces/"):
        trainer.train(iterations=...)

open ``traces/trace_<pid>_<n>.json`` in Perfetto (ui.perfetto.dev) or
chrome://tracing and read the spans there; after the call
:func:`records` holds the spans (with their device ms) and
:func:`session_counts` what the counters counted inside it.
"""
from __future__ import annotations

import itertools
import os
import threading
import time
from contextlib import contextmanager, nullcontext
from typing import Dict, List, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

counters: Dict[str, int] = {}

_TRACES = itertools.count()
_log: List["SpanRecord"] = []
_base: Dict[str, int] = {}
_adopter: Optional["SpanRecord"] = None   # the open span that adopts
_threads = threading.local()
_recording = False


class SpanRecord:
    """One span of the log. ``start_ns``/``end_ns`` are host times in
    Unix-epoch ns; :attr:`device_ms` is the time the current CUDA stream
    took between the span's start and end (None without CUDA)."""

    __slots__ = ("name", "parent", "thread", "start_ns", "end_ns",
                 "_events", "_device_ms")

    def __init__(self, name: str, thread: int):
        self.name = name
        self.parent: Optional[SpanRecord] = None
        self.thread = thread
        self.start_ns = self.end_ns = 0
        self._events = None
        self._device_ms = None

    @property
    def device_ms(self) -> Optional[float]:
        if self._device_ms is None and self._events is not None:
            start, end = self._events
            end.synchronize()
            self._device_ms = start.elapsed_time(end)
            self._events = None
        return self._device_ms


_OFF = nullcontext()      # the span that does nothing, one instance reused


class _Span:
    __slots__ = ("record", "_range", "_adopts", "_outer")

    def __init__(self, name: str, adopts: bool):
        if not _recording:
            _new_session()
        self.record = SpanRecord(name, threading.get_ident())
        self._adopts = adopts

    def __enter__(self):
        global _adopter
        rec = self.record
        stack = _thread_stack()
        rec.parent = stack[-1] if stack else _adopter
        stack.append(rec)
        if self._adopts:
            self._outer, _adopter = _adopter, rec
        # the host range holds the profiler's own event of the span
        rec.start_ns = time.time_ns()
        self._range = torch.profiler.record_function(rec.name)
        self._range.__enter__()
        if torch.cuda.is_initialized():
            rec._events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            rec._events[0].record()
        return rec

    def __exit__(self, *exc):
        global _adopter
        rec = self.record
        if rec._events is not None:
            rec._events[1].record()
        self._range.__exit__(*exc)
        rec.end_ns = time.time_ns()
        _thread_stack().pop()
        if self._adopts:
            _adopter = self._outer
        _log.append(rec)
        return False


def _thread_stack() -> list:
    stack = getattr(_threads, "stack", None)
    if stack is None:
        stack = _threads.stack = []
    return stack


def _new_session() -> None:
    global _log, _base, _recording
    _log = []
    _base = dict(counters)
    _recording = True


def span(name: str, adopts: bool = False):
    """A context manager naming the work inside it (see the module's
    docstring); a no-op unless a ``torch.profiler`` session records. With
    ``adopts``, while it is open it is the parent of every span opened on
    a thread that has none open."""
    global _recording
    if not _autograd_profiler._is_profiler_enabled:
        if _recording:
            _recording = False
        return _OFF
    return _Span(name, adopts)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    counters[name] = counters.get(name, 0) + n


def records() -> List[SpanRecord]:
    """The spans the current (or last) session logged, in the order they
    closed."""
    return _log


def session_counts() -> Dict[str, int]:
    """What each counter counted since the current (or last) session
    began."""
    return {k: v - _base.get(k, 0) for k, v in counters.items()}


@contextmanager
def device_trace(log_dir: str):
    """A ``torch.profiler`` trace of the block (the CPU, and the card when
    CUDA is available) written to ``log_dir`` as a Chrome trace, with the
    program's spans in it; yields the profiler. The file's path is its
    ``trace_path`` after the block. The block's spans open a new
    session."""
    global _recording
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    _recording = False
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.trace_path = os.path.join(
        log_dir, f"trace_{os.getpid()}_{next(_TRACES)}.json")
    prof.export_chrome_trace(prof.trace_path)
