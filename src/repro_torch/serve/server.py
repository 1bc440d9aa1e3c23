"""`GNNServer`: low-latency online GNN inference from the training caches.

The serving path is the training pipeline's device phase, request-driven:

  submit(seeds)  any thread: admission queue (DeadlineBatcher)
  serve loop     one thread, per micro-batch:
                   [refresh?]  OnlineCacheManager.maybe_refresh — hot-set
                               drift checks fed by *serving* traffic,
                               serialized with the fill under the epoch
                               lock
                   sample      DeviceBatchBuilder.sample_spec — device
                               topology-cache sampling, observer-tapped
                   gather      fill_spec (pins the cache epoch) +
                               finalize (one fused gather+overlay kernel
                               launch against the epoch-pinned table)
                   forward     GNN forward under torch.inference_mode()
                   reply       slice logits per request, resolve futures

**One shape after warm-up**: requests pad to exactly ``max_batch`` seeds
(a designated pad vertex fills the tail), so every level tensor has one
shape; and the builder's bucket quantum is set to the worst-case
unique-vertex count ``max_batch * (1 + f1 + f1*f2 + ...)``, so every spec
lands on ONE ``(id, miss)`` shape pair.  Every micro-batch launches the
fused kernel exactly once, warm-up included.

**Epoch-pinned reads**: ``fill_spec`` stamps the current cache epoch into
the spec and ``finalize`` gathers from the double-buffered table of *that*
epoch; fill, oracle and finalize run in one locked region, and the server's
own refreshes take the same lock between micro-batches.

On a GPU the serve loop thread runs under ``torch.cuda.device`` of the
server's device and launches on that thread's current stream.

Telemetry: ``serve.*`` metrics (latency/queue-wait histograms, request and
batch counters, per-tier hit bytes, flush triggers) publish into the
attached ``Telemetry`` registry with the pull-at-snapshot idiom, and the
whole path is span-instrumented (enqueue -> batch -> sample -> gather ->
forward -> reply; host wall clock).  ``feature_store=`` fills the misses
through the tiered store's host-RAM and file tiers.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.planner import LegionPlan
from repro_torch.core.unified_cache import TrafficCounter
from repro_torch.graph.csr import CSRGraph
from repro_torch.models.gnn import GNNConfig, forward as gnn_forward
from repro_torch.obs import maybe_span
from repro_torch.serve.batcher import (FLUSH_DEADLINE, FLUSH_FULL,
                                       DeadlineBatcher, ServeRequest)
from repro_torch.serve.oracle import host_oracle_batch
from repro_torch.train.batch import DeviceBatchBuilder
from repro_torch.utils import device_context, resolve_device, synchronize

# histogram edges for request latencies: 100us .. 3s
LATENCY_EDGES_S = (1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2, 1e-1, 3e-1, 1.0, 3.0)


@dataclasses.dataclass
class ServeConfig:
    """Batcher + serving knobs.

    ``max_batch``: seeds per micro-batch; every batch pads to exactly
    this.  ``max_wait_s``: deadline for flushing a partial batch.
    ``pad_vertex``: vertex id used to fill the seed tail
    (default: the serving device's first tablet vertex) — padded rows
    sample and gather like real traffic but are never replied.
    ``refresh_interval``: micro-batches between online-manager drift
    checks (None = no serving-driven refreshes; needs ``manager=``).
    ``snapshot_every``: micro-batches between telemetry snapshots when a
    Telemetry object is attached (0 = the caller drives snapshots).
    ``oracle_check``: after every gather, assemble the host-oracle batch,
    compare it with the device batch, run it through the same forward and
    compare the logits — all bitwise."""
    max_batch: int = 64
    max_wait_s: float = 0.005
    pad_vertex: Optional[int] = None
    refresh_interval: Optional[int] = None
    snapshot_every: int = 25
    oracle_check: bool = False

    def __post_init__(self):
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        if self.refresh_interval is not None and self.refresh_interval < 1:
            raise ValueError("refresh_interval must be >= 1 or None")


@dataclasses.dataclass
class ServeResult:
    """One request's reply: per-seed logits plus the latency breakdown."""
    request_id: int
    logits: np.ndarray        # (n_seeds, n_classes) float32
    n_seeds: int
    latency_s: float          # enqueue -> reply
    queue_wait_s: float       # enqueue -> batch formation
    batch_id: int
    batch_seeds: int          # real seeds in the micro-batch served with
    cache_epoch: int          # the pinned epoch the gather read


class GNNServer:
    """Request-driven inference server over one device's view of a
    ``LegionPlan``'s unified cache (see module doc).

    Lifecycle: construct, ``warmup()``, ``start()``, ``submit(seeds)`` from
    anywhere, ``stop()``.  ``device`` defaults to ``"cuda"`` (raises
    without a card); pass ``"cpu"`` to serve on the CPU.  ``manager`` (an
    ``OnlineCacheManager`` over the same plan) observes serving traffic
    and, with ``ServeConfig.refresh_interval``, refreshes the cache between
    micro-batches.  ``telemetry`` (a ``repro_torch.obs.Telemetry``) gets
    the serve spans, histograms and a ``serve`` metrics source; the server
    snapshots into it every ``ServeConfig.snapshot_every`` micro-batches
    and never closes it.  ``feature_store`` (a ``FeatureStore`` over the
    graph) serves the misses from its tiers.
    """

    def __init__(self, g: CSRGraph, plan: LegionPlan, cfg: GNNConfig,
                 params, *, dev: int = 0, device="cuda",
                 config: Optional[ServeConfig] = None,
                 counter: Optional[TrafficCounter] = None,
                 telemetry=None, manager=None, feature_store=None,
                 seed: int = 0):
        self.g = g
        self.plan = plan
        self.cfg = cfg
        self.params = params
        self.dev = dev
        self.device = resolve_device(device)
        self.config = config or ServeConfig()
        if self.config.refresh_interval is not None and manager is None:
            raise ValueError("refresh_interval needs an OnlineCacheManager "
                             "(pass manager=)")
        self.manager = manager
        self.telemetry = telemetry
        self.counter = (counter if counter is not None
                        else TrafficCounter.for_plan(plan))
        cache = plan.cache_for_device(dev)
        # worst-case unique-vertex count of a full batch: every slot of
        # every level distinct.  Using it as the builder's bucket quantum
        # collapses every spec onto ONE (id, miss) shape pair.
        slots = 1
        cap = 1
        for f in cfg.fanouts:
            slots *= f
            cap += slots
        self.shape_cap = self.config.max_batch * cap
        self._builder = DeviceBatchBuilder(
            g, cache, cfg.fanouts, self.counter, dev, device=self.device,
            bucket=self.shape_cap,
            observer=(manager.observer_for(dev) if manager is not None
                      else None))
        self._builder.telemetry = telemetry
        self._builder.store = feature_store
        if self.config.pad_vertex is not None:
            self._pad_vertex = int(self.config.pad_vertex)
        else:
            tablet = plan.partition.tablets.get(dev)
            self._pad_vertex = int(tablet[0]) if tablet is not None \
                and len(tablet) else 0
        self._rng = np.random.default_rng(seed)
        self.batcher = DeadlineBatcher(self.config.max_batch,
                                       self.config.max_wait_s)
        self._thread: Optional[threading.Thread] = None
        # serializes fill -> oracle -> finalize against cache refreshes
        # (the server's own, and any other thread driving the manager)
        self._epoch_lock = threading.RLock()
        # ---- serve tallies ---------------------------------------------
        self._m_lock = threading.Lock()
        self._requests = 0
        self._replies = 0
        self._batches = 0
        self._seeds = 0
        self._pad_seeds = 0
        self._flushes = {FLUSH_FULL: 0, FLUSH_DEADLINE: 0}
        self._oracle_checks = 0
        self._oracle_mismatches = 0
        self._forward_us = 0          # integer us so window deltas are exact
        if telemetry is not None:
            self._h_latency = telemetry.registry.histogram(
                "serve.latency_s", edges=LATENCY_EDGES_S)
            self._h_wait = telemetry.registry.histogram(
                "serve.queue_wait_s", edges=LATENCY_EDGES_S)
            telemetry.add_source("serve", self.publish_metrics)

    # ---- client API ----------------------------------------------------
    def submit(self, seeds: np.ndarray):
        """Admit one request (thread-safe); returns a Future[ServeResult].
        The enqueue span is the latency clock's start."""
        with maybe_span(self.telemetry, "serve_enqueue", dev=self.dev):
            fut = self.batcher.submit(seeds)
        with self._m_lock:
            self._requests += 1
        return fut

    def start(self) -> None:
        if self._thread is not None:
            raise RuntimeError("server already started")
        self._thread = threading.Thread(target=self._run, name="serve-loop",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        """Stop admitting, drain queued requests, join the loop thread."""
        self.batcher.close()
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def warmup(self, rounds: int = 2) -> None:
        """Serve ``rounds`` synthetic full batches through the real path
        (first launches, allocator warm-up).  Call before ``start``."""
        for _ in range(rounds):
            req = ServeRequest(
                rid=-1, seeds=np.full(self.config.max_batch,
                                      self._pad_vertex, dtype=np.int64),
                future=Future(), t_enqueue=time.perf_counter())
            with self._m_lock:
                self._requests += 1  # keep requests == replies invariant
            with device_context(self.device):
                self._serve_batch([req], FLUSH_FULL)
            req.future.result()

    # ---- the serve loop ------------------------------------------------
    def _run(self) -> None:
        with device_context(self.device):
            while True:
                nxt = self.batcher.next_batch()
                if nxt is None:
                    return
                reqs, trigger = nxt
                try:
                    self._serve_batch(reqs, trigger)
                except Exception as e:  # resolve futures; keep serving
                    for r in reqs:
                        if not r.future.done():
                            r.future.set_exception(e)

    def _maybe_refresh(self, batch_id: int) -> None:
        ri = self.config.refresh_interval
        if self.manager is None or ri is None or batch_id == 0:
            return
        if batch_id % ri == 0:
            with maybe_span(self.telemetry, "serve_refresh", batch=batch_id):
                with self._epoch_lock:
                    self.manager.maybe_refresh(batch_id)

    def _serve_batch(self, reqs: List[ServeRequest], trigger: str) -> None:
        tele = self.telemetry
        t_batch = time.perf_counter()
        with self._m_lock:
            batch_id = self._batches
            self._batches += 1
            if trigger in self._flushes:
                self._flushes[trigger] += 1
        self._maybe_refresh(batch_id)
        with maybe_span(tele, "serve_batch", batch=batch_id,
                        requests=len(reqs)), torch.inference_mode():
            real = np.concatenate([r.seeds for r in reqs])
            n_real = len(real)
            n_pad = self.config.max_batch - n_real
            seeds = np.full(self.config.max_batch, self._pad_vertex,
                            dtype=np.int64)
            seeds[:n_real] = real
            with maybe_span(tele, "serve_sample", batch=batch_id):
                spec = self._builder.sample_spec(seeds, self._rng)
            with maybe_span(tele, "serve_gather", batch=batch_id):
                # one locked region for fill -> oracle -> finalize: the
                # host mirror tracks the *live* epoch, so the oracle must
                # read it before any refresh moves past the spec's epoch
                with self._epoch_lock:
                    spec = self._builder.fill_spec(spec)
                    epoch = spec.cache_epoch
                    oracle = None
                    if self.config.oracle_check:
                        # must also run before finalize releases staging
                        oracle = host_oracle_batch(
                            spec, self._builder.cache, self.g.feat_dim)
                    batch = self._builder.finalize(spec)
            with maybe_span(tele, "serve_forward", batch=batch_id):
                t_fwd = time.perf_counter_ns()
                logits = gnn_forward(self.cfg, self.params, batch)
                synchronize(self.device)
                fwd_us = (time.perf_counter_ns() - t_fwd) // 1000
            if oracle is not None:
                self._check_oracle(oracle, batch, logits)
            with maybe_span(tele, "serve_reply", batch=batch_id):
                logits_np = logits.cpu().numpy()
                t_reply = time.perf_counter()
                off = 0
                for r in reqs:
                    n = len(r.seeds)
                    res = ServeResult(
                        request_id=r.rid,
                        logits=logits_np[off:off + n],
                        n_seeds=n,
                        latency_s=t_reply - r.t_enqueue,
                        queue_wait_s=t_batch - r.t_enqueue,
                        batch_id=batch_id, batch_seeds=n_real,
                        cache_epoch=epoch)
                    off += n
                    if tele is not None:
                        self._h_latency.observe(res.latency_s)
                        self._h_wait.observe(res.queue_wait_s)
                    r.future.set_result(res)
        with self._m_lock:
            self._replies += len(reqs)
            self._seeds += n_real
            self._pad_seeds += n_pad
            self._forward_us += fwd_us
        if tele is not None and self.config.snapshot_every \
                and (batch_id + 1) % self.config.snapshot_every == 0:
            tele.snapshot(batch_id + 1)

    def _check_oracle(self, oracle: Dict[str, np.ndarray],
                      batch: Dict[str, torch.Tensor],
                      logits: torch.Tensor) -> None:
        """Bitwise parity: the host-oracle batch must equal the device
        batch (the gather's own parity), and through the same forward it
        must reproduce the serving logits exactly."""
        ob = {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
              for k, v in oracle.items()}
        ok = ob.keys() == batch.keys() and all(
            torch.equal(ob[k], batch[k]) for k in ob)
        ologits = gnn_forward(self.cfg, self.params, ob)
        ok = ok and torch.equal(ologits, logits)
        with self._m_lock:
            self._oracle_checks += 1
            if not ok:
                self._oracle_mismatches += 1

    # ---- telemetry -----------------------------------------------------
    def publish_metrics(self, reg) -> None:
        """Mirror the serve tallies into a MetricsRegistry (pulled at
        snapshot boundaries, the TrafficCounter idiom).  All totals are
        integers, so window deltas telescope exactly; the per-tier hit
        bytes split the serve counter's byte matrix the same way
        ``TrafficCounter.publish_metrics`` does."""
        with self._m_lock:
            scalars = {
                "serve.requests": self._requests,
                "serve.replies": self._replies,
                "serve.batches": self._batches,
                "serve.seeds": self._seeds,
                "serve.pad_seeds": self._pad_seeds,
                "serve.flush_full": self._flushes[FLUSH_FULL],
                "serve.flush_deadline": self._flushes[FLUSH_DEADLINE],
                "serve.oracle_checks": self._oracle_checks,
                "serve.oracle_mismatches": self._oracle_mismatches,
                "serve.forward_us": self._forward_us,
            }
        for name, v in scalars.items():
            reg.counter(name).set_total(int(v))
        with self.counter.lock:
            bm = self.counter.bytes_matrix.copy()
            freq = self.counter.feature_requests
            fhit = self.counter.feature_hits
        dev_part = bm[:, :-1]
        reg.counter("serve.hit_bytes", tier="local").set_total(
            int(np.trace(dev_part)))
        reg.counter("serve.hit_bytes", tier="peer").set_total(
            int(dev_part.sum() - np.trace(dev_part)))
        reg.counter("serve.hit_bytes", tier="pcie").set_total(
            int(bm[:, -1].sum()))
        reg.counter("serve.feature_requests").set_total(int(freq))
        reg.counter("serve.feature_hits").set_total(int(fhit))
        reg.gauge("serve.queue_depth").set(self.batcher.depth)

    def summary(self) -> dict:
        """Live tallies."""
        with self._m_lock:
            return {
                "requests": self._requests, "replies": self._replies,
                "batches": self._batches, "seeds": self._seeds,
                "pad_seeds": self._pad_seeds,
                "flush_full": self._flushes[FLUSH_FULL],
                "flush_deadline": self._flushes[FLUSH_DEADLINE],
                "oracle_checks": self._oracle_checks,
                "oracle_mismatches": self._oracle_mismatches,
                "forward_us": self._forward_us,
                "shape_cap": self.shape_cap,
            }
