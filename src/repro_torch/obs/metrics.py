"""Lock-cheap metrics registry: counters, gauges and fixed-edge histograms
with **windowed snapshots**.

Producers (TrafficCounter, the Prefetcher, OnlineCacheManager, CliqueCache)
publish into one :class:`MetricsRegistry` — either by bumping a metric on
the hot path (``Counter.inc`` / ``Histogram.observe``, one tiny per-metric
lock) or by mirroring an externally-accumulated tally at snapshot time
(``Counter.set_total``, no hot-path cost at all).  The registry then turns
the running totals into per-window deltas: ``window_snapshot()`` reports,
for every counter and histogram bucket, both the cumulative total and the
delta since the previous snapshot.  Deltas telescope by construction, so
summing a stream of snapshots reproduces the final totals *exactly* —
that's the property the telemetry acceptance gate checks against the
run-final ``TrafficCounter``.

Metric identity is ``name`` plus optional label key/values, flattened to
the Prometheus-style ``name{k=v,...}`` string that keys the snapshot dicts.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

# Default histogram edges for durations in seconds: 100 us .. 10 s, one
# bucket per half-decade (the +inf overflow bucket is implicit).
TIME_EDGES_S = (1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2, 1e-1, 3e-1, 1.0, 3.0,
                10.0)


def flat_name(name: str, labels: Dict[str, object]) -> str:
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


class Counter:
    """Monotonic tally.  ``inc`` is the hot-path form (own lock, adds
    commute); ``set_total`` mirrors a total that is accumulated elsewhere
    (e.g. TrafficCounter's tallies, already guarded by their own lock) and
    must never go backwards."""

    __slots__ = ("total", "_lock")

    def __init__(self):
        self.total = 0
        self._lock = threading.Lock()

    def inc(self, n=1) -> None:
        with self._lock:
            self.total += n

    def set_total(self, value) -> None:
        if value < self.total:
            raise ValueError(
                f"counter total went backwards: {value} < {self.total}")
        self.total = value


class Gauge:
    """Point-in-time value (cache rows, overlap score, queue depth)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, value) -> None:
        self.value = float(value)


def quantile_from_counts(edges: Sequence[float], counts: Sequence[int],
                         q: float) -> Optional[float]:
    """Quantile estimate from fixed-bucket cumulative-free counts (the
    ``counts[i] tallies <= edges[i]`` layout, last bucket = +inf overflow)
    by **linear interpolation within the containing bucket** — the
    Prometheus ``histogram_quantile`` rule.  The first bucket interpolates
    from 0 (durations are non-negative); the overflow bucket cannot be
    interpolated and clamps to the largest finite edge.  Returns None for
    an empty histogram.  Error is bounded by the containing bucket's
    width (the reporter's p50/p99 columns and ``serve.latency_s`` gates
    rely on exactly this bound)."""
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"quantile must be in [0, 1], got {q}")
    total = sum(counts)
    if total == 0:
        return None
    rank = q * total
    cum = 0
    for i, c in enumerate(counts):
        if c == 0:
            continue
        below, cum = cum, cum + c
        if cum >= rank:
            if i >= len(edges):          # +inf overflow: no upper edge
                return float(edges[-1])
            lo = 0.0 if i == 0 else float(edges[i - 1])
            hi = float(edges[i])
            # rank == below (q at a bucket boundary) takes the lower edge
            return lo + (hi - lo) * (max(rank, below) - below) / c
    return float(edges[-1])


class Histogram:
    """Fixed-bucket-edge histogram: ``counts[i]`` tallies observations
    ``<= edges[i]`` (last bucket is the +inf overflow).  ``observe`` takes
    one per-metric lock; edges are immutable after creation."""

    __slots__ = ("edges", "counts", "sum", "count", "_lock")

    def __init__(self, edges: Sequence[float]):
        edges = tuple(float(e) for e in edges)
        if not edges or any(b <= a for a, b in zip(edges, edges[1:])):
            raise ValueError(f"histogram edges must be strictly increasing "
                             f"and non-empty, got {edges}")
        self.edges = edges
        self.counts = [0] * (len(edges) + 1)
        self.sum = 0.0
        self.count = 0
        self._lock = threading.Lock()

    def _bucket(self, value: float) -> int:
        lo, hi = 0, len(self.edges)
        while lo < hi:
            mid = (lo + hi) // 2
            if value <= self.edges[mid]:
                hi = mid
            else:
                lo = mid + 1
        return lo

    def observe(self, value: float) -> None:
        b = self._bucket(value)
        with self._lock:
            self.counts[b] += 1
            self.sum += value
            self.count += 1

    def quantile(self, q: float) -> Optional[float]:
        """Linear-interpolated quantile over the fixed buckets (see
        ``quantile_from_counts``); None while empty."""
        with self._lock:
            counts = list(self.counts)
        return quantile_from_counts(self.edges, counts, q)


class MetricsRegistry:
    """Metric store + window-delta engine.  Creation is memoized by
    ``(name, labels)`` under one registry lock; updates go through the
    returned metric object and take only that metric's own lock."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._hists: Dict[str, Histogram] = {}
        # previous-snapshot state for the delta computation
        self._prev_counters: Dict[str, float] = {}
        self._prev_hist_counts: Dict[str, List[int]] = {}

    def counter(self, name: str, **labels) -> Counter:
        key = flat_name(name, labels)
        with self._lock:
            c = self._counters.get(key)
            if c is None:
                c = self._counters[key] = Counter()
            return c

    def gauge(self, name: str, **labels) -> Gauge:
        key = flat_name(name, labels)
        with self._lock:
            g = self._gauges.get(key)
            if g is None:
                g = self._gauges[key] = Gauge()
            return g

    def histogram(self, name: str,
                  edges: Sequence[float] = TIME_EDGES_S,
                  **labels) -> Histogram:
        key = flat_name(name, labels)
        with self._lock:
            h = self._hists.get(key)
            if h is None:
                h = self._hists[key] = Histogram(edges)
            elif tuple(float(e) for e in edges) != h.edges:
                raise ValueError(
                    f"histogram {key!r} already exists with different edges")
            return h

    def window_snapshot(self) -> Tuple[dict, dict, dict]:
        """Capture every metric: counters as ``{total, delta}`` (delta
        since the previous call — the first call's delta IS the total),
        gauges at their current value, histograms with cumulative and
        delta bucket counts.  Deltas telescope: summing them over every
        snapshot of a run equals the final totals exactly."""
        with self._lock:
            counters, gauges, hists = {}, {}, {}
            for key, c in self._counters.items():
                total = c.total
                prev = self._prev_counters.get(key, 0)
                counters[key] = {"total": total, "delta": total - prev}
                self._prev_counters[key] = total
            for key, g in self._gauges.items():
                gauges[key] = g.value
            for key, h in self._hists.items():
                with h._lock:
                    counts = list(h.counts)
                    total_sum, total_count = h.sum, h.count
                prev = self._prev_hist_counts.get(key, [0] * len(counts))
                hists[key] = {"edges": list(h.edges), "counts": counts,
                              "delta": [c - p for c, p in zip(counts, prev)],
                              "sum": total_sum, "count": total_count}
                self._prev_hist_counts[key] = counts
            return counters, gauges, hists


def sum_counter_deltas(snapshots: Sequence[dict],
                       name: Optional[str] = None) -> Dict[str, float]:
    """Fold a sequence of parsed snapshot lines into per-counter delta
    sums (optionally filtered to counters whose flat name starts with
    ``name``) — the reconstruction half of the exactness gate."""
    out: Dict[str, float] = {}
    for snap in snapshots:
        for key, c in snap["counters"].items():
            if name is not None and not key.startswith(name):
                continue
            out[key] = out.get(key, 0) + c["delta"]
    return out
