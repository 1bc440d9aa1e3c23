"""Unified telemetry: per-step span tracing, windowed cache/traffic
metrics, and Perfetto-compatible trace export.

One :class:`Telemetry` object per run, threaded through
``train_gnn(telemetry=...)`` or ``GNNServer(telemetry=...)``:

* **Spans** — ``with tele.span("device_step", step=i): ...`` records a
  thread-aware begin/end interval (train loop, prefetch worker pool,
  refresh hook, serve loop) to the JSONL stream and the Chrome trace,
  optionally bridged into ``torch.profiler.record_function`` (and an NVTX
  range on a card) so the same interval shows up beside the device work
  in a profiler trace.  Span times are host wall clock.
* **Metrics** — producers publish into ``tele.registry`` (hot-path
  counters/histograms) or register a ``publish(registry)`` source pulled
  at window boundaries (TrafficCounter, Prefetcher, OnlineCacheManager,
  CliqueCache, FeatureStore and GNNServer all expose
  ``publish_metrics``).  ``tele.snapshot(step)`` emits one windowed
  capture: totals + per-window deltas that telescope exactly to the
  run-final totals.
* **Sinks** — a schema-versioned JSONL stream (``repro_torch.obs.schema``,
  safe to tail) and a Chrome ``trace_event`` JSON for Perfetto.  The CLI
  reporter (``python -m repro_torch.obs.report run.jsonl``) prints the
  throughput/stall/hit-rate story from the stream.

Zero-overhead-when-disabled contract: every instrumentation site guards
on ``telemetry is None`` (or reuses a singleton null context), so a
disabled run executes not one telemetry instruction on any hot path.
``activity_count()`` is the structural probe: its delta is 0 across a
``telemetry=None`` run.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
import time
from typing import Callable, List, Optional, Tuple

from repro_torch.obs.metrics import (MetricsRegistry, TIME_EDGES_S,
                                     flat_name, quantile_from_counts,
                                     sum_counter_deltas)
from repro_torch.obs.schema import (SCHEMA_VERSION, validate_line,
                                    validate_stream)
from repro_torch.obs.sinks import ChromeTraceSink, JsonlSink
from repro_torch.obs.spans import OpenSpanTracker, Span

__all__ = ["Telemetry", "TelemetryConfig", "MetricsRegistry", "Span",
           "activity_count", "flat_name", "maybe_span",
           "quantile_from_counts", "sum_counter_deltas", "validate_line",
           "validate_stream", "SCHEMA_VERSION", "TIME_EDGES_S"]

# one shared, reusable, re-entrant no-op context: instrumentation sites use
# ``with maybe_span(tele, ...)`` and a disabled run enters this singleton —
# no allocation, no telemetry code
_NULL_CONTEXT = contextlib.nullcontext()


def maybe_span(tele: Optional["Telemetry"], name: str, **kw):
    """``tele.span(name, **kw)``, or the shared no-op context when
    telemetry is disabled (``tele is None``)."""
    return _NULL_CONTEXT if tele is None else tele.span(name, **kw)


# module-wide telemetry-operation tally (spans entered, snapshots emitted):
# a nonzero delta around a ``telemetry=None`` run means some hot path
# entered telemetry code while disabled
_activity = 0
_activity_lock = threading.Lock()


def _bump_activity() -> None:
    global _activity
    with _activity_lock:
        _activity += 1


def activity_count() -> int:
    return _activity


@dataclasses.dataclass
class TelemetryConfig:
    """Knobs of one telemetry stream.

    ``jsonl_path``/``trace_path`` select the sinks (either may be None);
    ``window`` is the metrics-snapshot cadence in steps;
    ``profiler_annotations`` bridges every span into
    ``torch.profiler.record_function`` (and an NVTX range where CUDA is
    available); ``max_span_events`` bounds the in-memory trace retention
    (the JSONL stream is never truncated)."""
    jsonl_path: Optional[str] = None
    trace_path: Optional[str] = None
    window: int = 10
    profiler_annotations: bool = True
    max_span_events: int = 200_000
    run: str = "train"

    def __post_init__(self):
        if self.window < 1:
            raise ValueError(f"telemetry window must be >= 1, got "
                             f"{self.window}")


class Telemetry:
    """One run's telemetry pipeline: span recorder + metrics registry +
    sinks.  Construct, pass to ``train_gnn(telemetry=...)`` (which closes
    it when the run ends), then read the JSONL/trace files — or drive it
    manually: ``span``/``snapshot``/``event``/``close``."""

    def __init__(self, config: Optional[TelemetryConfig] = None, **kw):
        self.config = config or TelemetryConfig(**kw)
        self.registry = MetricsRegistry()
        self._t0_ns = time.perf_counter_ns()
        self._sources: List[Tuple[str, Callable]] = []
        self._sources_lock = threading.Lock()
        self._tracker = OpenSpanTracker()
        self._jsonl = (JsonlSink(self.config.jsonl_path)
                       if self.config.jsonl_path else None)
        self._trace = (ChromeTraceSink(self.config.trace_path,
                                       self.config.max_span_events)
                       if self.config.trace_path else None)
        self._last_snapshot_step = 0
        self._span_count = 0
        self._snapshot_count = 0
        self._closed = False
        if self._jsonl is not None:
            self._jsonl.write({"v": SCHEMA_VERSION, "kind": "meta",
                               "run": self.config.run,
                               "window": self.config.window,
                               "t0_unix_s": time.time(),
                               "pid": os.getpid()})

    # ---- spans ----
    def _ts_us(self, t_ns: Optional[int] = None) -> float:
        t_ns = time.perf_counter_ns() if t_ns is None else t_ns
        return (t_ns - self._t0_ns) / 1e3

    def span(self, name: str, *, step: Optional[int] = None,
             **attrs) -> Span:
        """A fresh context manager for one begin/end interval; the record
        is emitted on exit (so every line is a balanced pair)."""
        _bump_activity()
        return Span(self._record_span, name, step=step,
                    profiler_annotation=self.config.profiler_annotations,
                    tracker=self._tracker, **attrs)

    def _record_span(self, name: str, t0_ns: int, dur_ns: int, tid: int,
                     thread: str, step: Optional[int], attrs: dict) -> None:
        ts_us = (t0_ns - self._t0_ns) / 1e3
        dur_us = dur_ns / 1e3
        self._span_count += 1
        if self._jsonl is not None:
            line = {"v": SCHEMA_VERSION, "kind": "span", "name": name,
                    "ts_us": ts_us, "dur_us": dur_us, "tid": tid,
                    "thread": thread}
            if step is not None:
                line["step"] = step
            if attrs:
                line["attrs"] = attrs
            self._jsonl.write(line)
        if self._trace is not None:
            self._trace.add_span(name, ts_us, dur_us, tid, thread, step,
                                 attrs)

    @property
    def open_spans(self) -> int:
        return self._tracker.open_total

    @property
    def span_count(self) -> int:
        return self._span_count

    # ---- metrics ----
    def add_source(self, name: str, publish: Callable) -> None:
        """Register a ``publish(registry)`` callable pulled at every
        snapshot — how TrafficCounter/Prefetcher/OnlineCacheManager/
        CliqueCache/FeatureStore mirror their externally-accumulated
        tallies into the registry with zero hot-path cost.
        Re-registering a name *replaces* the previous source (keeping its
        position), so a stale source never publishes beside its
        replacement."""
        with self._sources_lock:
            for i, (n, _) in enumerate(self._sources):
                if n == name:
                    self._sources[i] = (name, publish)
                    return
            self._sources.append((name, publish))

    def snapshot(self, step: int) -> dict:
        """Pull every source, then emit one windowed metrics capture
        (totals + deltas since the previous snapshot)."""
        _bump_activity()
        with self._sources_lock:
            sources = list(self._sources)
        for _name, publish in sources:
            publish(self.registry)
        counters, gauges, hists = self.registry.window_snapshot()
        ts_us = self._ts_us()
        line = {"v": SCHEMA_VERSION, "kind": "snapshot", "step": int(step),
                "from_step": int(self._last_snapshot_step), "ts_us": ts_us,
                "counters": counters, "gauges": gauges, "hists": hists}
        self._last_snapshot_step = int(step)
        self._snapshot_count += 1
        if self._jsonl is not None:
            self._jsonl.write(line)
            self._jsonl.flush()
        if self._trace is not None:
            for key, value in gauges.items():
                self._trace.add_counter(key, ts_us, value)
            # windowed hit rates + per-tier byte deltas as counter tracks
            for base in ("traffic.feature", "traffic.topo"):
                req = counters.get(f"{base}_requests")
                hit = counters.get(f"{base}_hits")
                if req and hit and req["delta"] > 0:
                    self._trace.add_counter(f"{base}_hit_rate_window", ts_us,
                                            hit["delta"] / req["delta"])
            for key, c in counters.items():
                if key.startswith("traffic.feat_bytes{") \
                        or key.startswith("traffic.topo_bytes{"):
                    self._trace.add_counter(key, ts_us, c["delta"])
        return line

    def event(self, name: str, **attrs) -> None:
        """Instant marker line (refresh applied, anomaly, ...)."""
        _bump_activity()
        if self._jsonl is not None:
            line = {"v": SCHEMA_VERSION, "kind": "event", "name": name,
                    "ts_us": self._ts_us()}
            if attrs:
                line["attrs"] = attrs
            self._jsonl.write(line)

    # ---- lifecycle ----
    def close(self, final_step: Optional[int] = None) -> None:
        """Final snapshot (so window deltas telescope to the exact final
        totals), then flush and close both sinks.  Idempotent; a span left
        open on any thread is reported as a ``dangling_spans`` event, not
        raised."""
        if self._closed:
            return
        self._closed = True
        if final_step is not None or self._sources or self._snapshot_count:
            self.snapshot(self._last_snapshot_step
                          if final_step is None else final_step)
        dangling = self._tracker.open_total
        if dangling:
            self.event("dangling_spans", count=dangling)
        if self._jsonl is not None:
            self._jsonl.close()
        if self._trace is not None:
            self._trace.close()
