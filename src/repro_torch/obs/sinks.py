"""Telemetry sinks: a schema-versioned JSONL event stream and a Chrome
``trace_event`` export loadable in Perfetto (https://ui.perfetto.dev).

``JsonlSink`` writes one compact JSON object per line (kinds per
``repro_torch.obs.schema``), line-buffered and lock-guarded so concurrent
span emitters from the prefetch worker pool interleave whole lines — the file
is safe to ``tail -f`` mid-run.

``ChromeTraceSink`` retains span records in memory (bounded by
``max_events``) and materializes the Chrome JSON at close: complete
(``ph: "X"``) events per span, thread-name metadata rows so Perfetto's
track labels show ``train-loop`` / ``prefetch-build-N``, and counter
(``ph: "C"``) tracks fed by the windowed snapshots (hit rates, per-tier
byte deltas) so cache behavior lines up under the span tracks.
"""
from __future__ import annotations

import json
import threading
from typing import Dict, List, Optional


class JsonlSink:
    """Append-only JSONL stream; one whole line per write, thread-safe."""

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        self._f = open(path, "w", buffering=1)
        self._closed = False

    def write(self, obj: dict) -> None:
        line = json.dumps(obj, separators=(",", ":"), sort_keys=True,
                          allow_nan=False)
        with self._lock:
            if not self._closed:
                self._f.write(line + "\n")

    def flush(self) -> None:
        with self._lock:
            if not self._closed:
                self._f.flush()

    def close(self) -> None:
        with self._lock:
            if not self._closed:
                self._closed = True
                self._f.close()


class ChromeTraceSink:
    """In-memory span/counter collector -> Chrome trace_event JSON file.

    Spans beyond ``max_events`` are dropped (counted, reported in the
    trace metadata) so a long run cannot grow memory without bound; the
    JSONL stream is unaffected by this cap."""

    def __init__(self, path: str, max_events: int = 200_000):
        self.path = path
        self.max_events = int(max_events)
        self._lock = threading.Lock()
        self._spans: List[tuple] = []
        self._counters: List[tuple] = []
        self._thread_names: Dict[int, str] = {}
        self.dropped = 0

    def add_span(self, name: str, ts_us: float, dur_us: float, tid: int,
                 thread: str, step: Optional[int], attrs: dict) -> None:
        with self._lock:
            if len(self._spans) >= self.max_events:
                self.dropped += 1
                return
            self._spans.append((name, ts_us, dur_us, tid, step, attrs))
            self._thread_names.setdefault(tid, thread)

    def add_counter(self, name: str, ts_us: float, value) -> None:
        """One sample of a Perfetto counter track (windowed snapshots)."""
        with self._lock:
            if len(self._counters) >= self.max_events:
                self.dropped += 1
                return
            self._counters.append((name, ts_us, value))

    def events(self, pid: int = 1,
               process_name: str = "repro_torch") -> list:
        with self._lock:
            spans = list(self._spans)
            counters = list(self._counters)
            thread_names = dict(self._thread_names)
            dropped = self.dropped
        out = [{"ph": "M", "pid": pid, "tid": 0, "name": "process_name",
                "args": {"name": process_name}}]
        for tid, tname in sorted(thread_names.items()):
            out.append({"ph": "M", "pid": pid, "tid": tid,
                        "name": "thread_name", "args": {"name": tname}})
        for name, ts_us, dur_us, tid, step, attrs in spans:
            args = dict(attrs)
            if step is not None:
                args["step"] = step
            out.append({"ph": "X", "pid": pid, "tid": tid, "name": name,
                        "cat": "repro_torch", "ts": ts_us,
                        "dur": dur_us, "args": args})
        for name, ts_us, value in counters:
            out.append({"ph": "C", "pid": pid, "tid": 0, "name": name,
                        "ts": ts_us, "args": {"value": value}})
        if dropped:
            out.append({"ph": "M", "pid": pid, "tid": 0,
                        "name": "process_labels",
                        "args": {"labels": f"dropped_events={dropped}"}})
        return out

    def close(self) -> None:
        payload = {"traceEvents": self.events(),
                   "displayTimeUnit": "ms"}
        with open(self.path, "w") as f:
            json.dump(payload, f, separators=(",", ":"))
            f.write("\n")
