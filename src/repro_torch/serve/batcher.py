"""Admission queue + deadline-aware micro-batcher for the serving path.

Incoming seed-vertex requests enqueue from any thread (``submit``); the
server's loop thread drains them in micro-batches (``next_batch``).  A
batch flushes on whichever comes first:

* **max-batch** — the queued requests' seed counts fill the configured
  batch (``max_batch`` seeds), or
* **max-wait** — the *oldest* queued request has waited ``max_wait_s``
  (the per-request latency deadline's batching share).

Packing is greedy FIFO and never splits a request across batches (one
request = one reply = one contiguous logit slice), so a request larger
than ``max_batch`` is rejected at submit time.  Every flush is tagged
with its trigger — the ``serve.flush_full`` / ``serve.flush_deadline``
counters tell an operator whether the batcher runs throughput-bound
(full flushes) or latency-bound (deadline flushes), which is the knob
story in docs/serving.md.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import Future
from typing import List, Optional, Tuple

import numpy as np

FLUSH_FULL = "full"
FLUSH_DEADLINE = "deadline"
FLUSH_CLOSE = "close"


@dataclasses.dataclass
class ServeRequest:
    """One admitted inference request: seed vertices + its reply future
    (resolved with a ``ServeResult``) and the enqueue timestamp the
    latency accounting starts from."""
    rid: int
    seeds: np.ndarray
    future: Future
    t_enqueue: float


class DeadlineBatcher:
    """Thread-safe admission queue with deadline-aware flushing."""

    def __init__(self, max_batch: int, max_wait_s: float):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_wait_s < 0:
            raise ValueError(f"max_wait_s must be >= 0, got {max_wait_s}")
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_s)
        self._queue: List[ServeRequest] = []
        self._queued_seeds = 0
        self._closed = False
        self._cond = threading.Condition()
        self._next_rid = 0

    # ---- producer side --------------------------------------------------
    def submit(self, seeds: np.ndarray) -> Future:
        """Admit one request; returns the future its ``ServeResult``
        resolves on.  Rejects empty and over-sized requests here, at the
        edge, so the batch path never sees an unpackable request."""
        seeds = np.asarray(seeds, dtype=np.int64).reshape(-1)
        if len(seeds) == 0:
            raise ValueError("empty request: need at least one seed vertex")
        if len(seeds) > self.max_batch:
            raise ValueError(
                f"request has {len(seeds)} seeds but max_batch is "
                f"{self.max_batch}; split it client-side")
        fut: Future = Future()
        with self._cond:
            if self._closed:
                raise RuntimeError("batcher is closed")
            req = ServeRequest(rid=self._next_rid, seeds=seeds, future=fut,
                               t_enqueue=time.perf_counter())
            self._next_rid += 1
            self._queue.append(req)
            self._queued_seeds += len(seeds)
            self._cond.notify_all()
        return fut

    # ---- consumer side --------------------------------------------------
    def _pop_locked(self) -> List[ServeRequest]:
        """Greedy FIFO pack up to max_batch seeds (never splits)."""
        out, total = [], 0
        while self._queue and total + len(self._queue[0].seeds) \
                <= self.max_batch:
            req = self._queue.pop(0)
            total += len(req.seeds)
            out.append(req)
        self._queued_seeds -= total
        return out

    def next_batch(self) -> Optional[Tuple[List[ServeRequest], str]]:
        """Block until a batch is due; returns ``(requests, trigger)`` or
        None once closed and drained.  The deadline clock runs from the
        oldest queued request's enqueue time."""
        with self._cond:
            while True:
                if self._queue:
                    # full flush: the head of the queue fills the batch
                    # (>= because one more request would not fit whole)
                    head = 0
                    for req in self._queue:
                        if head + len(req.seeds) > self.max_batch:
                            break
                        head += len(req.seeds)
                    if head >= self.max_batch \
                            or self._queued_seeds > head:
                        return self._pop_locked(), FLUSH_FULL
                    age = time.perf_counter() - self._queue[0].t_enqueue
                    if age >= self.max_wait_s:
                        return self._pop_locked(), FLUSH_DEADLINE
                    if self._closed:
                        return self._pop_locked(), FLUSH_CLOSE
                    self._cond.wait(self.max_wait_s - age)
                    continue
                if self._closed:
                    return None
                self._cond.wait()

    @property
    def depth(self) -> int:
        with self._cond:
            return len(self._queue)

    def close(self) -> None:
        """Stop admitting; queued requests still flush (trigger=close)."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
