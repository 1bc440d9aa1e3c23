"""Telemetry hooks of the serving and batch paths.

Only the instrumentation-site half lives here: ``maybe_span`` with its
shared no-op context, and the module-wide activity tally that proves a
disabled run executes no telemetry code.  The span recorder, metrics
registry and sinks (the reference package's ``Telemetry``) are not part of
this package yet, so every caller passes ``tele=None``.
"""
from __future__ import annotations

import contextlib
import threading

__all__ = ["activity_count", "maybe_span"]

# one shared, reusable, re-entrant no-op context: instrumentation sites use
# ``with maybe_span(tele, ...)`` and a disabled run enters this singleton —
# no allocation, no telemetry code
_NULL_CONTEXT = contextlib.nullcontext()


def maybe_span(tele, name: str, **kw):
    """``tele.span(name, **kw)``, or the shared no-op context when
    telemetry is disabled (``tele is None``)."""
    return _NULL_CONTEXT if tele is None else tele.span(name, **kw)


# module-wide telemetry-operation tally: a nonzero delta around a
# ``telemetry=None`` run means some hot path entered telemetry code while
# disabled
_activity = 0
_activity_lock = threading.Lock()


def _bump_activity() -> None:
    global _activity
    with _activity_lock:
        _activity += 1


def activity_count() -> int:
    return _activity
