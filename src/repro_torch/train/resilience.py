"""Fault injection + elastic-recovery scaffolding (beyond-paper robustness).

Legion's target clusters (recommendation / risk control) lose GPUs
mid-run, SSD reads hiccup, and preempted jobs must come back without
re-warming the learned hot set.  This module is the harness and the
shared state machinery behind the three recovery legs wired through
``train_gnn``:

* **FaultPlan** — deterministic fault injection.  A plan is a list of
  :class:`FaultSpec` sites (``prefetch_build``, ``ssd_read``,
  ``ssd_stall``, ``checkpoint_write``, ``device_loss``) fired at chosen
  steps or call indices; every injection raises a typed
  :class:`InjectedFault` exception (or sleeps, for stalls), so tests and
  the chaos benchmark can prove each recovery path runs — and that the
  recovered run stays bitwise identical to a fault-free one.  Faults
  fire at side-effect-free points (before a build consumes RNG, before
  a source read returns rows), which is what makes retry-after-fault
  bitwise transparent.
* **RngJournal** — per-device ring of sampler RNG states at step
  boundaries.  The lookahead pipeline samples *ahead* of the consumed
  step, so the live generator state is always "from the future";
  checkpoints instead persist the journaled state at exactly the resume
  boundary, letting a restarted job replay the identical batch sequence.
* **ResilienceConfig / ResilienceStats** — the train-loop knobs
  (bounded prefetch-worker respawns, device-loss policy) and the
  ``recovery.*`` tallies every leg publishes into the telemetry
  registry (monotonic, so windowed deltas telescope exactly).
* **topology_from_partition** — rebuilds the block-diagonal adjacency a
  partition implies, feeding ``replan_on_topology_change`` when a
  device disappears (the plan does not retain its original matrix).

A copy of the reference package's ``train/resilience.py`` (it is numpy
only); the README's "Resilience" section describes the fault model and
what each recovery leg guarantees in the port.
"""
from __future__ import annotations

import copy
import dataclasses
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence

import numpy as np

FAULT_SITES = ("prefetch_build", "ssd_read", "ssd_stall",
               "checkpoint_write", "device_loss")


class InjectedFault:
    """Marker mixin: every exception raised by a FaultPlan carries it, so
    recovery code can tell injected faults from organic ones in tests."""


class InjectedWorkerDeath(InjectedFault, RuntimeError):
    """A prefetch build thread dying mid-run (site ``prefetch_build``)."""


class InjectedReadError(InjectedFault, OSError):
    """A transient SSD/source read failure (site ``ssd_read``)."""


class InjectedCheckpointError(InjectedFault, OSError):
    """A checkpoint write failing mid-save (site ``checkpoint_write``)."""


_SITE_EXC = {
    "prefetch_build": InjectedWorkerDeath,
    "ssd_read": InjectedReadError,
    "checkpoint_write": InjectedCheckpointError,
}


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One deterministic fault: fire at ``site`` when the site's ``step``
    matches, or from its ``at_call``-th invocation (0-based), for
    ``times`` consecutive matches.  ``dev`` names the lost device for
    ``device_loss``; ``stall_s`` is the injected sleep for ``ssd_stall``.
    With neither ``step`` nor ``at_call`` the spec fires on the site's
    first ``times`` calls."""
    site: str
    step: Optional[int] = None
    at_call: Optional[int] = None
    times: int = 1
    dev: Optional[int] = None
    stall_s: float = 0.0

    def __post_init__(self):
        if self.site not in FAULT_SITES:
            raise ValueError(f"unknown fault site {self.site!r} "
                             f"(expected one of {FAULT_SITES})")
        if self.times < 1:
            raise ValueError(f"times must be >= 1, got {self.times}")
        if self.site == "device_loss" and self.dev is None:
            raise ValueError("device_loss needs dev=")
        if self.site == "ssd_stall" and self.stall_s <= 0:
            raise ValueError("ssd_stall needs stall_s > 0")


class FaultPlan:
    """Deterministic fault injector shared across pipeline components.

    Components call ``raise_if(site, step=...)`` (or ``sleep_if`` for
    stalls) at their injection points; a matching spec with remaining
    ``times`` fires.  Thread-safe: prefetch workers, the store I/O pool
    and the checkpoint writer all consult one plan.  ``fired`` tallies
    per site are monotonic and published as ``fault.injected{site=...}``
    so the chaos bench can gate "the faults actually happened"."""

    def __init__(self, specs: Sequence[FaultSpec]):
        self._specs = list(specs)
        self._remaining = [s.times for s in self._specs]
        self._calls: Dict[str, int] = {s: 0 for s in FAULT_SITES}
        self.fired: Dict[str, int] = {s: 0 for s in FAULT_SITES}
        self._lock = threading.Lock()

    def _fire(self, site: str, step: Optional[int]) -> List[FaultSpec]:
        """Advance the site's call counter and return the specs that fire
        on this call (decrementing their remaining count)."""
        out = []
        with self._lock:
            call = self._calls[site]
            self._calls[site] = call + 1
            for i, spec in enumerate(self._specs):
                if spec.site != site or self._remaining[i] <= 0:
                    continue
                if spec.step is not None:
                    if step is None or step != spec.step:
                        continue
                elif spec.at_call is not None and call < spec.at_call:
                    continue
                self._remaining[i] -= 1
                self.fired[site] += 1
                out.append(spec)
        return out

    def raise_if(self, site: str, step: Optional[int] = None) -> None:
        """Raise the site's typed InjectedFault if a spec fires here."""
        for spec in self._fire(site, step):
            raise _SITE_EXC[site](
                f"injected {site} fault"
                + (f" at step {spec.step}" if spec.step is not None else ""))

    def sleep_if(self, site: str, step: Optional[int] = None) -> float:
        """Sleep out any matching stall specs; returns seconds slept."""
        slept = 0.0
        for spec in self._fire(site, step):
            time.sleep(spec.stall_s)
            slept += spec.stall_s
        return slept

    def device_losses(self, step: int) -> List[int]:
        """Devices whose loss fires at this step (polled once per train
        step by the loop's recovery hook).  Never raises."""
        return [spec.dev for spec in self._fire("device_loss", step)
                if spec.dev is not None]

    def wrap_source(self, source) -> "FaultyFeatureSource":
        return FaultyFeatureSource(source, self)

    def summary(self) -> dict:
        with self._lock:
            return {f"injected_{site}": n for site, n in self.fired.items()
                    if any(s.site == site for s in self._specs)}

    def publish_metrics(self, reg) -> None:
        """``fault.injected{site=...}`` counters (monotonic) for every site
        the plan targets, plus the all-site total."""
        with self._lock:
            fired = dict(self.fired)
            sites = {s.site for s in self._specs}
        for site in sorted(sites):
            reg.counter("fault.injected", site=site).set_total(fired[site])
        reg.counter("fault.injected_total").set_total(
            sum(fired[s] for s in sites))


class FaultyFeatureSource:
    """Feature-source proxy that consults a FaultPlan before every read:
    ``ssd_stall`` specs sleep (slow disk), ``ssd_read`` specs raise
    ``InjectedReadError`` *before* the real read — the store's retry path
    then re-reads, so served rows stay bitwise identical."""

    def __init__(self, source, plan: FaultPlan):
        self._source = source
        self.plan = plan

    @property
    def n(self) -> int:
        return self._source.n

    @property
    def feat_dim(self) -> int:
        return self._source.feat_dim

    def get_features(self, ids) -> np.ndarray:
        self.plan.sleep_if("ssd_stall")
        self.plan.raise_if("ssd_read")
        return self._source.get_features(ids)


@dataclasses.dataclass(frozen=True)
class ResilienceConfig:
    """Recovery knobs for one ``train_gnn`` run.

    ``fault_plan`` attaches an injector (None trains faithfully).
    ``worker_restarts`` bounds prefetch-worker respawns per run; the
    restart past the bound surfaces the original exception unchanged.
    ``checkpoint_retries`` bounds in-worker retries of a failed
    checkpoint write.  ``on_device_loss`` picks the policy when a device
    disappears: ``"remesh"`` replans onto the survivors and continues,
    ``"raise"`` aborts (the pre-resilience behavior)."""
    fault_plan: Optional[FaultPlan] = None
    worker_restarts: int = 2
    checkpoint_retries: int = 1
    on_device_loss: str = "remesh"

    def __post_init__(self):
        if self.worker_restarts < 0:
            raise ValueError("worker_restarts must be >= 0")
        if self.checkpoint_retries < 0:
            raise ValueError("checkpoint_retries must be >= 0")
        if self.on_device_loss not in ("remesh", "raise"):
            raise ValueError("on_device_loss must be 'remesh' or 'raise'")


@dataclasses.dataclass
class ResilienceStats:
    """What the recovery hooks did — surfaced as
    ``GNNTrainResult.resilience`` and mirrored into the registry as
    ``recovery.*`` counters (times as integer microseconds so windowed
    deltas telescope exactly).  ``restore_s`` (the port's addition) is a
    resume's restore wall time: the checkpoint's load, the manager's
    reapply and the store's refill."""
    remesh_events: int = 0
    devices_lost: int = 0
    remesh_s: float = 0.0
    restore_s: float = 0.0
    cache_rebuilds: int = 0
    resumed_from_step: Optional[int] = None
    runtime_restored: bool = False
    events: List[dict] = dataclasses.field(default_factory=list)

    def summary(self) -> dict:
        return {"remesh_events": self.remesh_events,
                "devices_lost": self.devices_lost,
                "remesh_s": self.remesh_s,
                "restore_s": self.restore_s,
                "cache_rebuilds": self.cache_rebuilds,
                "resumed_from_step": self.resumed_from_step,
                "runtime_restored": self.runtime_restored,
                "events": list(self.events)}

    def publish_metrics(self, reg) -> None:
        reg.counter("recovery.remesh_events").set_total(self.remesh_events)
        reg.counter("recovery.devices_lost").set_total(self.devices_lost)
        reg.counter("recovery.remesh_us").set_total(int(self.remesh_s * 1e6))
        reg.counter("recovery.restore_us").set_total(
            int(self.restore_s * 1e6))
        reg.counter("recovery.cache_rebuilds").set_total(self.cache_rebuilds)
        reg.counter("recovery.runtime_restores").set_total(
            int(self.runtime_restored))


class RngJournal:
    """Ring of sampler-RNG states keyed by step boundary.

    ``record(step, rng)`` snapshots the generator *before* step ``step``
    samples (entry ``k`` = "state with steps ``< k`` fully drawn").  The
    sampling side records entry ``k+1`` right after finishing step
    ``k``'s draws, so whenever the consumer has completed step ``k`` the
    boundary state ``k+1`` is guaranteed journaled — even though the
    live generator has already sampled the lookahead window beyond it.
    ``maxlen`` comfortably exceeds prefetch depth + lookahead, so the
    checkpoint boundary is always in the ring."""

    def __init__(self, maxlen: int = 128):
        if maxlen < 2:
            raise ValueError("maxlen must be >= 2")
        self.maxlen = maxlen
        self._states: "OrderedDict[int, dict]" = OrderedDict()
        self._lock = threading.Lock()

    def record(self, step: int, rng: np.random.Generator) -> None:
        state = rng.bit_generator.state  # fresh dict per access
        with self._lock:
            self._states[int(step)] = state
            self._states.move_to_end(int(step))
            while len(self._states) > self.maxlen:
                self._states.popitem(last=False)

    def state_for(self, step: int) -> Optional[dict]:
        with self._lock:
            st = self._states.get(int(step))
            return copy.deepcopy(st) if st is not None else None


def topology_from_partition(partition) -> np.ndarray:
    """Block-diagonal adjacency implied by a partition's cliques (the
    plan does not retain its original topology matrix), sized to the
    highest device id + 1 so dead devices keep their rows — what
    ``replan_on_topology_change`` expects alongside ``alive=``."""
    n = max(d for c in partition.cliques for d in c) + 1
    adj = np.zeros((n, n), dtype=bool)
    for c in partition.cliques:
        for a in c:
            for b in c:
                if a != b:
                    adj[a, b] = True
    return adj
