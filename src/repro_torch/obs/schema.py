"""Telemetry JSONL schema (v1) — the checked-in contract for every line the
JSONL sink emits.

One JSON object per line, one of four ``kind``s:

  meta      first line of a stream: schema version, run label, time base,
            snapshot window.
  span      one completed begin/end pair: wall-clock interval on one
            thread (``ts_us``/``dur_us`` relative to the stream's t0),
            emitted at span end so a line is always a *balanced* pair.
  snapshot  one windowed metrics capture: every counter's running total
            AND its delta since the previous snapshot (deltas telescope —
            summing them over the stream reproduces the final totals
            exactly), gauges at their current value, histograms with
            cumulative and delta bucket counts.
  event     an instant marker (refresh applied, overflow notice, ...).

The validator is dependency-free (no jsonschema in the container): a
field-type table per kind, with a small amount of structural checking for
the nested snapshot payloads.  ``tests/test_torch_obs.py`` validates every
line of a real training run against this module; bump ``SCHEMA_VERSION`` and
extend ``SCHEMA`` together when the format grows.
"""
from __future__ import annotations

from typing import Any, Dict

SCHEMA_VERSION = 1

# kind -> field -> (types, required).  Extra fields are rejected so the
# schema stays the single source of truth for what a consumer may rely on.
_NUM = (int, float)
SCHEMA: Dict[str, Dict[str, tuple]] = {
    "meta": {
        "v": ((int,), True),
        "kind": ((str,), True),
        "run": ((str,), True),
        "window": ((int,), True),
        "t0_unix_s": (_NUM, True),
        "pid": ((int,), True),
        "attrs": ((dict,), False),
    },
    "span": {
        "v": ((int,), True),
        "kind": ((str,), True),
        "name": ((str,), True),
        "ts_us": (_NUM, True),
        "dur_us": (_NUM, True),
        "tid": ((int,), True),
        "thread": ((str,), True),
        "step": ((int, type(None)), False),
        "attrs": ((dict,), False),
    },
    "snapshot": {
        "v": ((int,), True),
        "kind": ((str,), True),
        "step": ((int,), True),
        "from_step": ((int,), True),
        "ts_us": (_NUM, True),
        "counters": ((dict,), True),
        "gauges": ((dict,), True),
        "hists": ((dict,), True),
    },
    "event": {
        "v": ((int,), True),
        "kind": ((str,), True),
        "name": ((str,), True),
        "ts_us": (_NUM, True),
        "attrs": ((dict,), False),
    },
}


class TelemetrySchemaError(ValueError):
    """A telemetry line does not conform to the checked-in schema."""


def _fail(msg: str) -> None:
    raise TelemetrySchemaError(msg)


def validate_line(obj: Any) -> str:
    """Validate one parsed JSONL object; returns its ``kind``.

    Raises :class:`TelemetrySchemaError` on any violation — unknown kind,
    wrong schema version, missing/extra fields, wrong field types, or a
    malformed snapshot payload."""
    if not isinstance(obj, dict):
        _fail(f"line is {type(obj).__name__}, expected object")
    kind = obj.get("kind")
    if kind not in SCHEMA:
        _fail(f"unknown kind {kind!r} (expected one of {sorted(SCHEMA)})")
    if obj.get("v") != SCHEMA_VERSION:
        _fail(f"schema version {obj.get('v')!r} != {SCHEMA_VERSION}")
    fields = SCHEMA[kind]
    for name, (types, required) in fields.items():
        if name not in obj:
            if required:
                _fail(f"{kind}: missing required field {name!r}")
            continue
        if not isinstance(obj[name], tuple(types)) or (
                isinstance(obj[name], bool) and bool not in types):
            _fail(f"{kind}.{name}: {type(obj[name]).__name__} is not one of "
                  f"{[t.__name__ for t in types]}")
    extra = set(obj) - set(fields)
    if extra:
        _fail(f"{kind}: unknown fields {sorted(extra)}")
    if kind == "snapshot":
        _validate_snapshot(obj)
    if kind == "span" and obj["dur_us"] < 0:
        _fail(f"span {obj['name']!r}: negative duration {obj['dur_us']}")
    return kind


def _validate_snapshot(obj: dict) -> None:
    for name, c in obj["counters"].items():
        if not isinstance(c, dict) or set(c) != {"total", "delta"}:
            _fail(f"snapshot counter {name!r}: expected "
                  f"{{'total', 'delta'}}, got {c!r}")
        for k, v in c.items():
            if not isinstance(v, _NUM) or isinstance(v, bool):
                _fail(f"snapshot counter {name!r}.{k}: non-numeric {v!r}")
    for name, v in obj["gauges"].items():
        if not isinstance(v, _NUM) or isinstance(v, bool):
            _fail(f"snapshot gauge {name!r}: non-numeric {v!r}")
    for name, h in obj["hists"].items():
        if not isinstance(h, dict) or set(h) != {
                "edges", "counts", "delta", "sum", "count"}:
            _fail(f"snapshot hist {name!r}: malformed payload {h!r}")
        edges, counts, delta = h["edges"], h["counts"], h["delta"]
        if not (isinstance(edges, list) and isinstance(counts, list)
                and isinstance(delta, list)):
            _fail(f"snapshot hist {name!r}: edges/counts/delta must be lists")
        if len(counts) != len(edges) + 1 or len(delta) != len(counts):
            _fail(f"snapshot hist {name!r}: {len(edges)} edges needs "
                  f"{len(edges) + 1} buckets, got {len(counts)}/{len(delta)}")


def validate_stream(lines) -> Dict[str, int]:
    """Validate an iterable of parsed lines; returns per-kind counts.
    The first line must be the ``meta`` header."""
    counts: Dict[str, int] = {}
    for i, obj in enumerate(lines):
        kind = validate_line(obj)
        if i == 0 and kind != "meta":
            _fail(f"first line is {kind!r}, expected 'meta'")
        counts[kind] = counts.get(kind, 0) + 1
    if not counts:
        _fail("empty telemetry stream")
    return counts
