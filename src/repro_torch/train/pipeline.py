"""Training pipeline (paper §5): the prefetching sampling server and the
straggler monitor.

* ``Prefetcher``: background batch building (batch generation, neighbor
  sampling, the host phase of feature extraction) running ahead of the
  device, the inter-batch pipeline of Figure 7.  Two build modes:

    batch_fn(step) -> item      one callable builds the whole step
    part_fns=[fn, ...]          one callable per device; the parts of one
                                step build **concurrently** on a worker
                                pool and are delivered as a list in device
                                order

  The step sequence itself stays serial: ``pre_batch_hook(step)`` runs
  strictly *between* steps, after every build of step ``i`` finished (the
  gather of part futures is the barrier) and before any build of step
  ``i+1`` starts.  That is what lets the online cache manager mutate cache
  residency between (never during) spec builds without a lock.

  ``part_group_sizes`` nests the parts per clique and ``pack_fn`` packs
  them on the coordinator thread (the sharded executor's mesh layout).

  ``summary()`` reports per-batch host build and pack time and queue-dry
  time: how long ``get()`` waited on an empty queue, the time the device
  would have stalled for host work.
* ``LookaheadWindow``: the sample-ahead loop behind the tiered feature
  store's Ginex-style eviction — decouples a builder's sampling sub-phase
  from its feature fill so batch ``N``'s fill runs with batches
  ``N+1..N+W`` already sampled, their store-request sets announced (the
  next-use index eviction reads) and their file reads prefetching.
* ``StragglerMonitor``: EWMA step-time tracker flagging outlier steps.
"""
from __future__ import annotations

import os
import queue
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor, wait
from typing import Callable, List, Optional

# get() polls at this interval so a worker exception raised while the
# consumer is blocked surfaces within about one tick, not after the timeout
_POLL_S = 0.05


class Prefetcher:
    def __init__(self, batch_fn: Optional[Callable[[int], object]] = None,
                 depth: int = 2, limit: Optional[int] = None,
                 pre_batch_hook: Optional[Callable[[int], None]] = None,
                 pack_fn: Optional[Callable[[object], object]] = None, *,
                 part_fns: Optional[List[Callable[[int], object]]] = None,
                 part_group_sizes: Optional[List[int]] = None,
                 workers: Optional[int] = None,
                 extra_summary: Optional[Callable[[], dict]] = None,
                 telemetry=None, start_step: int = 0,
                 max_restarts: int = 0, fault_plan=None):
        """``limit`` bounds the number of batches produced (the train loop
        passes its step count): without it the worker keeps building ahead
        until ``close()``, and side effects of building (traffic
        accounting) would include a timing-dependent tail nobody consumes.

        ``pre_batch_hook(step)`` runs on the coordinator thread right
        before batch ``step`` is built, serialized with every build; its
        exceptions propagate like build exceptions.

        ``part_fns`` switches to pool mode: each step's batch is the list
        ``[fn(step) for fn in part_fns]``, built concurrently on
        ``workers`` threads (default: one per part, capped at
        ``os.cpu_count() - 1``; ``workers=1`` builds serially in order).
        The list is always in ``part_fns`` order.

        ``part_group_sizes`` nests that list: the flat results (still built
        concurrently across the whole pool) are regrouped into consecutive
        sublists of these sizes, one per clique for the hierarchical
        executor.

        ``pack_fn`` is an optional second host phase applied to each built
        batch on the coordinator thread, after the build barrier (timed
        separately in ``summary()``): the sharded executor packs the
        per-clique specs into its mesh layout here.

        ``extra_summary`` is a zero-argument callable merged into
        ``summary()``; a key that collides with a build stat raises.

        ``telemetry`` (a ``repro_torch.obs.Telemetry``) instruments the
        pipeline: spans around each step's refresh hook, build and pack (on
        the coordinator thread) and around every ``get()`` (consumer
        thread), plus the ``prefetch.build_s`` and ``prefetch.dry_s``
        histograms.  With the default ``None`` not one telemetry
        instruction runs.

        ``start_step`` is the first step built (a resumed run passes its
        checkpoint boundary); ``limit`` counts batches from there.

        ``max_restarts`` bounds worker respawns: when the coordinator
        thread dies of an ordinary ``Exception`` a fresh thread re-enters
        the loop at the *same* step (``self._step`` advances only on
        success, and the injected-fault site sits before the hook and the
        build consume any RNG, so a respawned build replays nothing).  Past
        the bound, or on a ``BaseException``, the exception surfaces
        through ``get()``/``close()``.  ``fault_plan`` (a
        ``repro_torch.train.resilience.FaultPlan``) injects
        ``prefetch_build`` faults at the step boundary."""
        if (batch_fn is None) == (part_fns is None):
            raise ValueError("pass exactly one of batch_fn / part_fns")
        self._batch_fn = batch_fn
        self._part_fns = list(part_fns) if part_fns is not None else None
        if self._part_fns is not None and not self._part_fns:
            raise ValueError("part_fns must not be empty")
        self._group_sizes = (list(part_group_sizes)
                             if part_group_sizes is not None else None)
        if self._group_sizes is not None:
            if self._part_fns is None:
                raise ValueError("part_group_sizes needs part_fns")
            if (any(s < 1 for s in self._group_sizes)
                    or sum(self._group_sizes) != len(self._part_fns)):
                raise ValueError(
                    f"part_group_sizes {self._group_sizes} must be positive "
                    f"and sum to len(part_fns) == {len(self._part_fns)}")
        n_parts = len(self._part_fns) if self._part_fns is not None else 1
        if workers is None:
            workers = max(1, (os.cpu_count() or 2) - 1)
        self._workers = max(1, min(int(workers), n_parts))
        self._pool = (ThreadPoolExecutor(max_workers=self._workers,
                                         thread_name_prefix="prefetch-build")
                      if self._part_fns is not None and self._workers > 1
                      else None)
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = int(start_step)
        self._start = int(start_step)
        self._limit = limit
        self._max_restarts = int(max_restarts)
        self._fault_plan = fault_plan
        self.worker_deaths = 0
        self.worker_restarts = 0
        self._hook = pre_batch_hook
        self._pack_fn = pack_fn
        self._extra_summary = extra_summary
        self._tele = telemetry
        if telemetry is not None:
            self._h_build = telemetry.registry.histogram("prefetch.build_s")
            self._h_dry = telemetry.registry.histogram("prefetch.dry_s")
        self._build_s = 0.0
        self._pack_s = 0.0
        self._built = 0
        self._dry_s = 0.0
        self._gets = 0
        self._exc: Optional[BaseException] = None
        self._exc_raised = False
        self._thread = threading.Thread(target=self._worker, daemon=True,
                                        name="prefetch-coordinator")
        self._thread.start()

    def _regroup(self, parts: List[object]) -> List[object]:
        """Flat part results -> consecutive sublists of part_group_sizes
        (identity without grouping)."""
        if self._group_sizes is None:
            return parts
        out, i = [], 0
        for sz in self._group_sizes:
            out.append(parts[i:i + sz])
            i += sz
        return out

    def _build(self, step: int):
        if self._part_fns is None:
            return self._batch_fn(step)
        if self._pool is None:
            return self._regroup([fn(step) for fn in self._part_fns])
        futs = [self._pool.submit(fn, step) for fn in self._part_fns]
        # barrier: every part of step i lands before this returns (and so
        # before the next pre_batch_hook), even if one of them failed
        wait(futs)
        # f.result() raises the first part failure
        return self._regroup([f.result() for f in futs])

    def _worker(self):
        """Thread target: run the build loop, respawning (bounded) on an
        ordinary Exception.  The loop re-enters at the step that failed:
        ``self._step`` advances only after a successful build and enqueue,
        and the injection site fires before the hook or the build run, so a
        respawned attempt replays no RNG draw and no accounting."""
        try:
            self._worker_loop()
        except Exception as e:
            self.worker_deaths += 1
            if (self.worker_restarts < self._max_restarts
                    and not self._stop.is_set()):
                self.worker_restarts += 1
                t = threading.Thread(target=self._worker, daemon=True,
                                     name="prefetch-coordinator")
                self._thread = t
                t.start()
            else:
                self._exc = e  # surfaced on the next get() or at close()
        except BaseException as e:  # never restarted
            self._exc = e

    def _worker_loop(self):
        tele = self._tele
        while not self._stop.is_set():
            if self._limit is not None \
                    and self._step - self._start >= self._limit:
                return
            if self._fault_plan is not None:
                self._fault_plan.raise_if("prefetch_build", step=self._step)
            if self._hook is not None:
                if tele is not None:
                    with tele.span("refresh_hook", step=self._step):
                        self._hook(self._step)
                else:
                    self._hook(self._step)
            t0 = time.perf_counter()
            if tele is not None:
                with tele.span("prefetch_build", step=self._step):
                    batch = self._build(self._step)
                self._h_build.observe(time.perf_counter() - t0)
            else:
                batch = self._build(self._step)
            self._build_s += time.perf_counter() - t0
            if self._pack_fn is not None:
                t0 = time.perf_counter()
                if tele is not None:
                    with tele.span("prefetch_pack", step=self._step):
                        batch = self._pack_fn(batch)
                else:
                    batch = self._pack_fn(batch)
                self._pack_s += time.perf_counter() - t0
            self._built += 1
            self._step += 1
            while not self._stop.is_set():
                try:
                    self._q.put(batch, timeout=0.1)
                    break
                except queue.Full:
                    continue

    def get(self, timeout: float = 60.0):
        """Next prefetched batch.  Polls in short intervals so a worker
        exception surfaces promptly even while this thread is blocked on an
        empty queue.  Time spent in here accumulates as queue-dry time
        (and, with telemetry, a consumer-thread span and the queue-dry
        histogram)."""
        if self._tele is None:
            return self._get(timeout)
        t0 = time.perf_counter()
        with self._tele.span("prefetch_get"):
            try:
                return self._get(timeout)
            finally:
                self._h_dry.observe(time.perf_counter() - t0)

    def _get(self, timeout: float):
        t0 = time.perf_counter()
        deadline = t0 + timeout
        try:
            while True:
                if self._exc is not None:
                    self._exc_raised = True
                    raise self._exc
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    raise queue.Empty
                try:
                    item = self._q.get(timeout=min(_POLL_S, remaining))
                except queue.Empty:
                    continue
                self._gets += 1
                return item
        finally:
            self._dry_s += time.perf_counter() - t0

    def summary(self) -> dict:
        """Host build stats plus what the consumer stalled on:
        ``queue_dry_s_*`` is time ``get()`` waited for the queue."""
        out = {"batches_built": self._built,
               "gets": self._gets,
               "host_build_s_total": self._build_s,
               "host_build_s_mean": self._build_s / max(self._built, 1),
               "host_pack_s_total": self._pack_s,
               "host_pack_s_mean": self._pack_s / max(self._built, 1),
               "queue_dry_s_total": self._dry_s,
               "queue_dry_s_mean": self._dry_s / max(self._gets, 1),
               "build_workers": self._workers,
               "worker_deaths": self.worker_deaths,
               "worker_restarts": self.worker_restarts}
        if self._extra_summary is not None:
            extra = self._extra_summary()
            clash = sorted(set(extra) & set(out))
            if clash:
                raise ValueError(
                    f"extra_summary keys collide with build stats: {clash}; "
                    "namespace them (e.g. 'sampling/...')")
            out.update(extra)
        return out

    def publish_metrics(self, reg, base: Optional[dict] = None) -> None:
        """Queue and build tallies for the telemetry registry
        (repro_torch.obs), pulled at snapshot boundaries: totals mirror
        ``summary()`` (the per-observation histograms are fed live from the
        hot path when telemetry is attached).  ``base`` adds the totals of
        closed predecessor prefetchers, keyed by ``summary()`` names, so
        the registry counters stay monotonic across a pipeline swap."""
        b = base or {}

        def tot(key, v):
            return v + b.get(key, 0)

        reg.counter("prefetch.batches_built").set_total(
            tot("batches_built", self._built))
        reg.counter("prefetch.gets").set_total(tot("gets", self._gets))
        reg.counter("prefetch.build_s").set_total(
            tot("host_build_s_total", self._build_s))
        reg.counter("prefetch.pack_s").set_total(
            tot("host_pack_s_total", self._pack_s))
        reg.counter("prefetch.queue_dry_s").set_total(
            tot("queue_dry_s_total", self._dry_s))
        reg.counter("fault.worker_deaths").set_total(
            tot("worker_deaths", self.worker_deaths))
        reg.counter("recovery.worker_restarts").set_total(
            tot("worker_restarts", self.worker_restarts))
        reg.gauge("prefetch.queue_depth").set(self._q.qsize())
        reg.gauge("prefetch.build_workers").set(self._workers)

    def close(self):
        """Stop the worker.  A worker exception never surfaced through
        ``get()`` re-raises here: a failure in the last prefetched batches
        (or in a refresh hook) must not vanish at shutdown."""
        self._stop.set()
        t = self._thread
        t.join(timeout=5)
        if self._thread is not t:
            # a respawn raced the stop flag: join the replacement too
            self._thread.join(timeout=5)
        if self._pool is not None:
            self._pool.shutdown(wait=False)
        if self._exc is not None and not self._exc_raised:
            self._exc_raised = True
            raise self._exc


class LookaheadWindow:
    """One device's sample-ahead window over a split batch builder.

    ``build(step)`` is a drop-in replacement for ``builder.build_spec(...)``
    inside a Prefetcher part function, except that before filling step
    ``N`` it tops the window up through step ``N+window``: each future step
    is *sampled* (``sample_fn(step)`` — the per-step seed draw plus
    ``builder.sample_spec``, i.e. ALL of that step's RNG consumption, still
    executed strictly in step order, so batches stay bitwise identical to
    the unwindowed pipeline), its store-request set is announced to the
    tiered store (feeding the next-use index the lookahead eviction policy
    reads) and its file read is prefetched onto the store's I/O pool.  Only
    then does the front spec get its RNG-free ``fill_spec`` — with
    ``window`` batches of future knowledge banked.

    ``limit`` caps sampling at the run's final step (exclusive, absolute)
    so the window never draws (or accounts, or launches a sampling chain
    for) steps nobody will consume.  ``start`` is the first step the window
    samples.  One window per device part function: the Prefetcher pool may
    run devices concurrently, but each window is only ever driven by its
    own device's strictly sequential steps."""

    def __init__(self, builder, store, sample_fn: Callable[[int], object],
                 window: int = 4, limit: Optional[int] = None, dev: int = 0,
                 start: int = 0):
        if window < 0:
            raise ValueError(f"window must be >= 0, got {window}")
        self.builder = builder
        self.store = store
        self.sample_fn = sample_fn
        self.window = int(window)
        self.limit = limit
        self.dev = dev
        self._pending: deque = deque()  # (step, sampled spec) in step order
        self._next = int(start)  # next step to sample

    def build(self, step: int):
        while (self._next <= step + self.window
               and (self.limit is None or self._next < self.limit)):
            s = self._next
            spec = self.sample_fn(s)
            ids = self.builder.store_request_ids(spec)
            self.store.announce(s, ids)
            self.store.prefetch(s, ids, dev=self.dev)
            self._pending.append((s, spec))
            self._next += 1
        got, spec = self._pending.popleft()
        if got != step:
            raise RuntimeError(
                f"LookaheadWindow fed out of order: asked for step {step}, "
                f"front of window is {got} (one window per device; steps "
                "must arrive sequentially)")
        return self.builder.fill_spec(spec, step=step)


class StragglerMonitor:
    def __init__(self, alpha: float = 0.1, threshold: float = 2.5):
        self.alpha = alpha
        self.threshold = threshold
        self.ewma: Optional[float] = None
        self.stragglers = 0
        self.steps = 0
        self.worst: float = 0.0

    def record(self, step_time: float) -> bool:
        """Returns True if this step is a straggler."""
        self.steps += 1
        self.worst = max(self.worst, step_time)
        if self.ewma is None:
            self.ewma = step_time
            return False
        is_straggler = step_time > self.threshold * self.ewma
        if is_straggler:
            self.stragglers += 1
        else:
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * step_time
        return is_straggler

    def summary(self) -> dict:
        return {"steps": self.steps, "ewma_s": self.ewma,
                "stragglers": self.stragglers, "worst_s": self.worst}

    def publish_metrics(self, reg) -> None:
        """Straggler verdicts for the telemetry registry (repro_torch.obs):
        flagged/observed step counters (monotonic, so windowed deltas
        telescope) plus the EWMA and worst step time as gauges.  The
        per-step time *histograms* are fed live by the train loop
        (``step.time_s`` / ``straggler.step_time_s``)."""
        reg.counter("straggler.flagged").set_total(self.stragglers)
        reg.counter("straggler.steps").set_total(self.steps)
        reg.gauge("straggler.ewma_s").set(self.ewma or 0.0)
        reg.gauge("straggler.worst_s").set(self.worst)
