"""Tiered feature store: HBM -> host RAM -> SSD (Ginex-style lookahead).

Legion's premise is billion-scale graphs on one box, but a feature-cache
miss filled straight out of a dense in-memory array caps the graph at
host memory.  This module adds the two tiers below the device cache:

* **HBM** — the per-clique :class:`~repro_torch.core.unified_cache.
  CliqueCache` (untouched semantics): batch builders split hits against
  it first and only the misses ever reach this store.
* **host RAM** — a budgeted row cache (``host_rows`` capacity) in front
  of the backing source.  Eviction is **lookahead-informed**: the
  pipeline samples batches ahead of their feature fill (see
  ``train.pipeline.LookaheadWindow``) and announces each future batch's
  store-request set, so at eviction time the store knows the *next use*
  of every resident row within the window and evicts the
  farthest-next-use row first — Belady's algorithm restricted to the
  lookahead horizon, the Ginex observation that GNN sampling makes future
  miss sets known before they are needed.  Rows with no use inside the
  window fall back to LRU order (``policy="lru"`` disables lookahead
  entirely and is the baseline).
* **SSD** — any row source with ``get_features(ids) -> (len, D) f32``
  plus ``n``/``feat_dim`` attributes; in practice a
  :class:`~repro_torch.graph.csr.CSRGraph` whose ``feature_file`` points
  at an mmap'd ``.npy`` table (``features`` may be absent entirely).
  Reads for announced batches are started on a small I/O pool at announce
  time (``prefetch``), so by the time the fill runs the rows are staged
  and the file read overlapped the in-flight device phase.  A file that
  sits in the page cache is read at memory speed: the ``ssd`` tier's read
  times are then an mmap copy, not a disk figure.

Everything here is host numpy: the store hands the batch builder f32 rows,
which go into the builder's (pinned) staging buffer with one copy, and
from there to the device with the rest of the misses.

Every tier publishes hit/fill/eviction counters into the telemetry
registry (``publish_metrics``, Prometheus-style ``store.*{tier=...}``
names); totals are monotonic so windowed snapshot deltas telescope
exactly.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from bisect import insort
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.hotness import S_FLOAT32

# "infinite" next-use distance: no announced use inside the lookahead
# window (sorts after every real step; headroom so arithmetic never wraps)
NO_NEXT_USE = np.iinfo(np.int64).max // 2

POLICIES = ("lookahead", "lru")
TIERS = ("hbm", "host_ram", "ssd")


@dataclasses.dataclass(frozen=True)
class TieredStoreConfig:
    """Knobs of one tiered feature store.

    ``host_rows`` budgets the host-RAM tier in feature rows (0 = pure
    pass-through to the source: every request is an SSD fill).
    ``policy`` picks the eviction order: ``"lookahead"`` (farthest
    announced next use first, LRU among rows with none — the default)
    or ``"lru"`` (recency only, the baseline).  ``lookahead`` is the
    default number of batches the training loop samples ahead of the
    feature fill when the caller doesn't override it.  ``async_fills``
    stages source reads for announced batches on ``async_workers``
    background threads so they overlap the device phase.

    ``read_retries`` bounds retry-after-``OSError`` on source reads
    (every read goes through ``_timed_read``): a transient SSD hiccup is
    re-read after ``retry_backoff_s`` (doubling per attempt) instead of
    killing the pipeline — rows are bitwise identical whichever attempt
    served them.  The error past the last retry propagates unchanged."""
    host_rows: int
    policy: str = "lookahead"
    lookahead: int = 4
    async_fills: bool = True
    async_workers: int = 1
    read_retries: int = 2
    retry_backoff_s: float = 0.005

    def __post_init__(self):
        if self.host_rows < 0:
            raise ValueError(f"host_rows must be >= 0, got {self.host_rows}")
        if self.policy not in POLICIES:
            raise ValueError(f"unknown eviction policy {self.policy!r} "
                             f"(expected one of {POLICIES})")
        if self.lookahead < 0:
            raise ValueError(f"lookahead must be >= 0, got {self.lookahead}")
        if self.async_workers < 1:
            raise ValueError(
                f"async_workers must be >= 1, got {self.async_workers}")
        if self.read_retries < 0:
            raise ValueError(
                f"read_retries must be >= 0, got {self.read_retries}")
        if self.retry_backoff_s < 0:
            raise ValueError(
                f"retry_backoff_s must be >= 0, got {self.retry_backoff_s}")


class FeatureStore:
    """Host-RAM row cache over a backing feature source (see module doc).

    ``source`` is duck-typed: anything with ``get_features(ids)``,
    ``n`` and ``feat_dim`` — a :class:`~repro_torch.graph.csr.CSRGraph` (in-RAM,
    file-backed or virtual) is the usual choice.  All methods are
    thread-safe: spec builds run on the prefetch worker pool, async fills
    on the store's own I/O pool.

    One gather is exact accounting: ``requests == hits + fills`` per
    call (fills counted over the unique missing ids actually read)."""

    def __init__(self, source, config: TieredStoreConfig,
                 counter=None):
        self.source = source
        self.config = config
        self.counter = counter  # optional TrafficCounter (unused tallies ok)
        n, D = int(source.n), int(source.feat_dim)
        self.feat_dim = D
        cap = int(config.host_rows)
        self.capacity = cap
        self._lock = threading.Lock()
        # host-RAM tier state: slot-indexed arrays + vertex -> slot map
        self._pos = np.full(n, -1, dtype=np.int64)
        self._ids = np.full(cap, -1, dtype=np.int64)
        self._rows = np.zeros((cap, D), dtype=np.float32)
        self._next_use = np.full(cap, NO_NEXT_USE, dtype=np.int64)
        self._last_use = np.zeros(cap, dtype=np.int64)
        # announced future uses: vertex -> ascending step list (consumed
        # as gathers reach those steps)
        self._future: Dict[int, List[int]] = {}
        # staged async source reads: (step, dev) -> (ids, Future[rows])
        self._staged: Dict[Tuple[int, int], Tuple[np.ndarray, Future]] = {}
        self._io: Optional[ThreadPoolExecutor] = None
        self._clock = 0  # implicit step counter when gather(step=None)
        # ---- monotonic tallies (publish_metrics mirrors these) ----
        self.hbm_requests = 0
        self.hbm_hits = 0
        self.host_requests = 0
        self.host_hits = 0
        self.ssd_fill_rows = 0
        self.ssd_fill_bytes = 0
        self.ssd_fills_async = 0    # rows served from a staged async read
        self.ssd_read_s = 0.0       # total source-read wall time (any thread)
        self.stall_s = 0.0          # gather-side wait on source reads
        self.evictions = 0
        self.evictions_in_window = 0  # victims that HAD a known next use
        self.announced_batches = 0
        self.prefetched_batches = 0
        self.read_errors = 0        # source-read OSErrors (incl. retried)
        self.read_retries_used = 0  # reads recovered by a retry

    # ---- lookahead hints -------------------------------------------------
    def announce(self, step: int, ids: np.ndarray) -> None:
        """Record that batch ``step`` will request ``ids`` from this store
        (its HBM-miss set, known at sampling time — several batches before
        the fill).  Feeds the next-use index the lookahead eviction policy
        reads; a no-op burden-wise under ``policy="lru"`` is intentional:
        both policies see identical call sequences, so a comparison
        isolates the eviction decision itself."""
        ids = np.asarray(ids, dtype=np.int64)
        step = int(step)
        with self._lock:
            self.announced_batches += 1
            for v in map(int, ids):
                lst = self._future.setdefault(v, [])
                # per-device announces arrive in step order; concurrent
                # devices may interleave, so keep the list sorted
                if lst and step < lst[-1]:
                    insort(lst, step)
                else:
                    lst.append(step)
                slot = self._pos[v]
                if slot >= 0 and step < self._next_use[slot]:
                    self._next_use[slot] = step

    def prefetch(self, step: int, ids: np.ndarray, dev: int = 0) -> None:
        """Start the file read for batch ``step``'s not-yet-resident ids on
        the store's I/O pool.  The rows are parked (not inserted) until
        ``gather(step=step, dev=dev)`` consumes them, so the read runs
        concurrently with the in-flight device phase and never contends
        for the tier lock.  No-op when ``async_fills`` is disabled."""
        if not self.config.async_fills:
            return
        ids = np.asarray(ids, dtype=np.int64)
        with self._lock:
            resident = self._pos[ids] >= 0
            want = np.unique(ids[~resident])
            if len(want) == 0:
                return
            if self._io is None:
                self._io = ThreadPoolExecutor(
                    max_workers=self.config.async_workers,
                    thread_name_prefix="store-io")
            self.prefetched_batches += 1
            self._staged[(int(step), int(dev))] = (
                want, self._io.submit(self._timed_read, want))

    def _timed_read(self, ids: np.ndarray) -> np.ndarray:
        """Every source read funnels through here: wall time is tallied
        per attempt, and a transient ``OSError`` retries after a doubling
        backoff (``config.read_retries`` / ``retry_backoff_s``) — the
        rows are bitwise identical whichever attempt serves them, so a
        retried read never perturbs the batch stream.  The error past the
        last retry propagates unchanged."""
        attempt = 0
        while True:
            t0 = time.perf_counter()
            try:
                rows = np.asarray(self.source.get_features(ids),
                                  dtype=np.float32)
            except OSError:
                with self._lock:
                    self.ssd_read_s += time.perf_counter() - t0
                    self.read_errors += 1
                if attempt >= self.config.read_retries:
                    raise
                time.sleep(self.config.retry_backoff_s * (2 ** attempt))
                attempt += 1
                with self._lock:
                    self.read_retries_used += 1
                continue
            with self._lock:
                self.ssd_read_s += time.perf_counter() - t0
            return rows

    # ---- the gather hot path --------------------------------------------
    def record_hbm(self, requests: int, hits: int) -> None:
        """HBM-tier tally for one batch (the builder's split against the
        CliqueCache) so ``publish_metrics`` reports all three tiers with
        one naming scheme."""
        with self._lock:
            self.hbm_requests += int(requests)
            self.hbm_hits += int(hits)

    def gather(self, ids: np.ndarray, step: Optional[int] = None,
               dev: int = 0) -> np.ndarray:
        """Feature rows for ``ids`` (the HBM misses of one batch): host-RAM
        hits copy out of the resident tier, misses fill from the staged
        async read when one was prefetched for ``(step, dev)`` — else a
        synchronous source read, timed as stall — and the filled rows are
        admitted, evicting by the configured policy.  Rows are bitwise
        identical whatever tier serves them."""
        ids = np.asarray(ids, dtype=np.int64)
        out = np.empty((len(ids), self.feat_dim), dtype=np.float32)
        staged = None
        with self._lock:
            if step is None:
                step = self._clock
            step = int(step)
            self._clock = max(self._clock, step + 1)
            staged = self._staged.pop((step, int(dev)), None)
            self._consume_announced(ids, step)
            pos = self._pos[ids]
            hit = pos >= 0
            n_hit = int(hit.sum())
            self.host_requests += len(ids)
            self.host_hits += n_hit
            if n_hit:
                slots = pos[hit]
                out[hit] = self._rows[slots]
                self._last_use[slots] = step
                self._refresh_next_use(ids[hit], slots)
            miss_ids = ids[~hit]
        if len(miss_ids) == 0:
            return out
        uniq, inv = np.unique(miss_ids, return_inverse=True)
        rows_u = self._fill_rows(uniq, staged)
        out[~hit] = rows_u[inv]
        with self._lock:
            self._admit(uniq, rows_u, step)
        return out

    def _consume_announced(self, ids: np.ndarray, step: int) -> None:
        """Drop announced occurrences this gather satisfies: everything
        stale (< step) plus exactly one occurrence == step per id."""
        for v in map(int, np.unique(ids)):
            lst = self._future.get(v)
            if lst is None:
                continue
            i = 0
            while i < len(lst) and lst[i] < step:
                i += 1
            if i < len(lst) and lst[i] == step:
                i += 1
            if i:
                del lst[:i]
            if not lst:
                del self._future[v]

    def _refresh_next_use(self, ids: np.ndarray, slots: np.ndarray) -> None:
        for v, s in zip(map(int, ids), slots):
            lst = self._future.get(v)
            self._next_use[s] = lst[0] if lst else NO_NEXT_USE

    def _fill_rows(self, uniq: np.ndarray, staged) -> np.ndarray:
        """Unique missing ids -> rows: staged async results first, a timed
        synchronous source read for the remainder."""
        if staged is None:
            t0 = time.perf_counter()
            rows = self._timed_read(uniq)  # tallies ssd_read_s + retries
            dt = time.perf_counter() - t0
            with self._lock:
                self.stall_s += dt
                self.ssd_fill_rows += len(uniq)
                self.ssd_fill_bytes += len(uniq) * self.feat_dim * S_FLOAT32
            return rows
        staged_ids, fut = staged
        t0 = time.perf_counter()
        staged_rows = fut.result()  # ~instant when the read overlapped
        wait = time.perf_counter() - t0
        # staged_ids is unique+sorted (np.unique), so searchsorted maps
        # each wanted id to its staged row when present
        loc = np.searchsorted(staged_ids, uniq)
        loc = np.minimum(loc, max(len(staged_ids) - 1, 0))
        from_stage = (len(staged_ids) > 0) & (staged_ids[loc] == uniq)
        rows = np.empty((len(uniq), self.feat_dim), dtype=np.float32)
        if from_stage.any():
            rows[from_stage] = staged_rows[loc[from_stage]]
        rest = uniq[~from_stage]
        dt_sync = 0.0
        if len(rest):
            t1 = time.perf_counter()
            rows[~from_stage] = self._timed_read(rest)
            dt_sync = time.perf_counter() - t1
        with self._lock:
            self.stall_s += wait + dt_sync
            self.ssd_fills_async += int(from_stage.sum())
            self.ssd_fill_rows += len(uniq)
            self.ssd_fill_bytes += len(uniq) * self.feat_dim * S_FLOAT32
        return rows

    def _admit(self, ids: np.ndarray, rows: np.ndarray, step: int) -> None:
        """Insert unique freshly-read rows, evicting by policy when full.
        A request set larger than the whole tier keeps only its tail —
        capacity is a hard budget, never exceeded."""
        cap = self.capacity
        if cap == 0:
            return
        if len(ids) > cap:
            ids, rows = ids[-cap:], rows[-cap:]
        free = np.flatnonzero(self._ids < 0)
        n_evict = len(ids) - len(free)
        if n_evict > 0:
            resident = np.flatnonzero(self._ids >= 0)
            if self.config.policy == "lookahead":
                # farthest announced next use first; rows with none
                # (NO_NEXT_USE) sort before all known-soon rows and break
                # ties oldest-recency first — the documented LRU fallback
                order = np.lexsort((self._last_use[resident],
                                    -self._next_use[resident]))
            else:
                order = np.argsort(self._last_use[resident], kind="stable")
            victims = resident[order[:n_evict]]
            self.evictions += len(victims)
            self.evictions_in_window += int(
                (self._next_use[victims] < NO_NEXT_USE).sum())
            self._pos[self._ids[victims]] = -1
            self._ids[victims] = -1
            free = np.concatenate([free, victims])
        slots = free[:len(ids)]
        self._ids[slots] = ids
        self._rows[slots] = rows
        self._pos[ids] = slots
        self._last_use[slots] = step
        self._refresh_next_use(ids, slots)

    # ---- introspection ---------------------------------------------------
    @property
    def resident_rows(self) -> int:
        with self._lock:
            return int((self._ids >= 0).sum())

    @property
    def host_hit_rate(self) -> float:
        return self.host_hits / max(self.host_requests, 1)

    def summary(self) -> dict:
        """Flat tally digest (what ``GNNTrainResult.store`` reports)."""
        with self._lock:
            return {
                "policy": self.config.policy,
                "capacity_rows": self.capacity,
                "resident_rows": int((self._ids >= 0).sum()),
                "hbm_requests": self.hbm_requests,
                "hbm_hits": self.hbm_hits,
                "host_requests": self.host_requests,
                "host_hits": self.host_hits,
                "host_hit_rate": self.host_hits / max(self.host_requests, 1),
                "ssd_fill_rows": self.ssd_fill_rows,
                "ssd_fill_bytes": self.ssd_fill_bytes,
                "ssd_fills_async": self.ssd_fills_async,
                "ssd_read_s": self.ssd_read_s,
                "stall_s": self.stall_s,
                "evictions": self.evictions,
                "evictions_in_window": self.evictions_in_window,
                "announced_batches": self.announced_batches,
                "prefetched_batches": self.prefetched_batches,
                "read_errors": self.read_errors,
                "read_retries": self.read_retries_used,
            }

    def publish_metrics(self, reg) -> None:
        """Per-tier hit/fill/eviction counters for the telemetry registry
        (repro_torch.obs), pulled at snapshot boundaries: one consistent
        capture under the lock, then monotonic ``set_total`` per counter so
        window deltas telescope exactly to these totals."""
        with self._lock:
            s = {
                ("store.requests", "hbm"): self.hbm_requests,
                ("store.hits", "hbm"): self.hbm_hits,
                ("store.requests", "host_ram"): self.host_requests,
                ("store.hits", "host_ram"): self.host_hits,
                ("store.evictions", "host_ram"): self.evictions,
                ("store.evictions_in_window", "host_ram"):
                    self.evictions_in_window,
                ("store.fill_rows", "ssd"): self.ssd_fill_rows,
                ("store.fill_bytes", "ssd"): self.ssd_fill_bytes,
                ("store.fills_async", "ssd"): self.ssd_fills_async,
            }
            read_s, stall_s = self.ssd_read_s, self.stall_s
            announced = self.announced_batches
            prefetched = self.prefetched_batches
            resident = int((self._ids >= 0).sum())
            read_errors = self.read_errors
            read_retries = self.read_retries_used
        for (name, tier), v in s.items():
            reg.counter(name, tier=tier).set_total(int(v))
        # times publish as integer microseconds: float totals would break
        # the window-delta telescoping gate (float (a-b)+(b-c) != a-c)
        reg.counter("store.read_us", tier="ssd").set_total(
            int(read_s * 1e6))
        reg.counter("store.stall_us", tier="ssd").set_total(
            int(stall_s * 1e6))
        reg.counter("store.announced_batches").set_total(announced)
        reg.counter("store.prefetched_batches").set_total(prefetched)
        # transient read faults + the retries that recovered them
        reg.counter("fault.ssd_read_errors").set_total(read_errors)
        reg.counter("recovery.ssd_read_retries").set_total(read_retries)
        reg.gauge("store.resident_rows", tier="host_ram").set(resident)
        reg.gauge("store.capacity_rows", tier="host_ram").set(self.capacity)

    # ---- preemption-safe resume ------------------------------------------
    def state_dict(self) -> dict:
        """Host-tier residency + the lookahead bookkeeping, checkpointable:
        which vertices are resident, their next-use/recency indices, the
        announced-future table, the logical clock and the monotonic
        tallies.  The feature *rows* are deliberately not serialized —
        they are bitwise re-readable from the source on restore, so the
        payload stays tiny (ids + int64 indices, not the row data).
        In-flight staged reads are excluded (they are rebuilt by the
        resumed lookahead window)."""
        with self._lock:
            resident = np.flatnonzero(self._ids >= 0)
            return {
                "version": 1,
                "capacity": self.capacity,
                "policy": self.config.policy,
                "ids": self._ids[resident].copy(),
                "next_use": self._next_use[resident].copy(),
                "last_use": self._last_use[resident].copy(),
                "future": {int(v): list(lst)
                           for v, lst in self._future.items()},
                "clock": self._clock,
                "tallies": {
                    "hbm_requests": self.hbm_requests,
                    "hbm_hits": self.hbm_hits,
                    "host_requests": self.host_requests,
                    "host_hits": self.host_hits,
                    "ssd_fill_rows": self.ssd_fill_rows,
                    "ssd_fill_bytes": self.ssd_fill_bytes,
                    "ssd_fills_async": self.ssd_fills_async,
                    "evictions": self.evictions,
                    "evictions_in_window": self.evictions_in_window,
                    "announced_batches": self.announced_batches,
                    "prefetched_batches": self.prefetched_batches,
                    "read_errors": self.read_errors,
                    "read_retries_used": self.read_retries_used,
                },
            }

    def load_state_dict(self, state: dict, refill: bool = True) -> int:
        """Restore a ``state_dict`` capture: the recovered hot set is
        re-read from the source (one bulk ``_timed_read`` — bitwise the
        rows it held before, so a resumed run serves the same values from
        the same tier) and the next-use/recency/future bookkeeping picks
        up exactly where the eviction policy left off.  A smaller
        capacity keeps the most-recently-used prefix.  Returns the number
        of rows restored.  ``refill=False`` restores bookkeeping only
        (rows then refill organically as misses)."""
        ids = np.asarray(state["ids"], dtype=np.int64)
        next_use = np.asarray(state["next_use"], dtype=np.int64)
        last_use = np.asarray(state["last_use"], dtype=np.int64)
        if len(ids) > self.capacity:
            order = np.argsort(last_use, kind="stable")[::-1]
            keep = order[: self.capacity]
            ids, next_use, last_use = ids[keep], next_use[keep], last_use[keep]
        rows = self._timed_read(ids) if (refill and len(ids)) else None
        with self._lock:
            self._pos[:] = -1
            self._ids[:] = -1
            self._next_use[:] = NO_NEXT_USE
            self._last_use[:] = 0
            k = len(ids) if refill else 0
            if k:
                slots = np.arange(k)
                self._ids[slots] = ids
                self._rows[slots] = rows
                self._pos[ids] = slots
                self._next_use[slots] = next_use
                self._last_use[slots] = last_use
            self._future = {int(v): list(lst)
                            for v, lst in state["future"].items()}
            self._clock = int(state["clock"])
            t = state.get("tallies", {})
            for name, value in t.items():
                if hasattr(self, name):
                    setattr(self, name, max(getattr(self, name), value))
            return k

    def close(self) -> None:
        """Drain the I/O pool (idempotent).  Parked staged reads are
        discarded — their rows were never admitted, so state stays
        consistent."""
        with self._lock:
            io, self._io = self._io, None
            self._staged.clear()
        if io is not None:
            io.shutdown(wait=True)
