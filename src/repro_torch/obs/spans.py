"""Span tracing: thread-aware begin/end intervals over the training and
serving pipelines, with an optional bridge into PyTorch's profiler.

A :class:`Span` is a context manager handed out by ``Telemetry.span``.
On exit it reports one completed record — name, wall-clock interval
(relative to the stream's t0, monotonic clock), thread id/name, optional
step and attributes — to the recorder (the Telemetry object), which fans
it out to the JSONL and Chrome-trace sinks.  Emitting only *completed*
spans keeps every line a balanced begin/end pair by construction; the
tracer still tracks per-thread open-span depth so shutdown can report
anything left dangling.

Span durations are host wall clock: CUDA launches are asynchronous, so a
span around a launch times its queueing, not the kernel.  The profiler
bridge opens ``torch.profiler.record_function(name)`` over the same
interval, so the span shows up in a ``torch.profiler`` trace beside the
device work it queued, and pushes an NVTX range of the same name where
CUDA is available (what an external CUDA profiler shows).  Both are
opened and closed on the thread that runs the ``with`` block, so each
thread's record_function and NVTX stacks stay balanced.  The bridge is
resolved lazily on the first annotated span: importing
``repro_torch.obs`` loads nothing new.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Optional

_BRIDGE = None  # (record_function class, nvtx module or None), once resolved
_BRIDGE_LOCK = threading.Lock()


def _profiler_bridge():
    """``(torch.profiler.record_function, torch.cuda.nvtx or None)``,
    resolved once, on first use."""
    global _BRIDGE
    if _BRIDGE is None:
        with _BRIDGE_LOCK:
            if _BRIDGE is None:
                import torch

                nvtx = torch.cuda.nvtx if torch.cuda.is_available() else None
                _BRIDGE = (torch.profiler.record_function, nvtx)
    return _BRIDGE


class Span:
    """One begin/end interval.  Re-entrant use of a single instance is not
    supported — ``Telemetry.span`` constructs a fresh one per ``with``."""

    __slots__ = ("name", "step", "attrs", "_recorder", "_annotate",
                 "_t0_ns", "_range", "_nvtx", "_tracker")

    def __init__(self, recorder: Callable, name: str,
                 step: Optional[int] = None, profiler_annotation: bool = False,
                 tracker: Optional["OpenSpanTracker"] = None, **attrs):
        self.name = name
        self.step = step
        self.attrs = attrs
        self._recorder = recorder
        self._annotate = profiler_annotation
        self._t0_ns = 0
        self._range = None
        self._nvtx = None
        self._tracker = tracker

    def __enter__(self) -> "Span":
        if self._tracker is not None:
            self._tracker.push()
        if self._annotate:
            record_function, nvtx = _profiler_bridge()
            self._range = record_function(self.name)
            self._range.__enter__()
            if nvtx is not None:
                nvtx.range_push(self.name)
                self._nvtx = nvtx
        self._t0_ns = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        end_ns = time.perf_counter_ns()
        if self._nvtx is not None:
            self._nvtx.range_pop()
            self._nvtx = None
        if self._range is not None:
            self._range.__exit__(exc_type, exc, tb)
            self._range = None
        if self._tracker is not None:
            self._tracker.pop()
        t = threading.current_thread()
        self._recorder(self.name, self._t0_ns, end_ns - self._t0_ns,
                       t.ident or 0, t.name, self.step, self.attrs)


class OpenSpanTracker:
    """Per-thread open-span depth — the balance check behind the
    'no dangling spans at shutdown' report and the nesting tests."""

    def __init__(self):
        self._local = threading.local()
        self._lock = threading.Lock()
        self._open_total = 0

    def push(self) -> None:
        depth = getattr(self._local, "depth", 0)
        self._local.depth = depth + 1
        with self._lock:
            self._open_total += 1

    def pop(self) -> None:
        self._local.depth = getattr(self._local, "depth", 1) - 1
        with self._lock:
            self._open_total -= 1

    @property
    def open_total(self) -> int:
        with self._lock:
            return self._open_total
