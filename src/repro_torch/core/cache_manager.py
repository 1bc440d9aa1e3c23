"""Online cache management: adaptive refresh of the unified cache from live
traffic.

  live batches ──► AccessAccumulator (per-clique, per-device H_T/H_F
                   counters, same semantics as pre-sampling)
        │
        ▼   every ``interval`` steps, on the prefetch coordinator thread
  EWMA blend (``hotness.ewma_blend``) of observed vs planned hotness
        │
        ▼
  drift detector — ``hotness.weighted_topk_overlap`` of the planned hot
  set vs the blended hot set; below ``drift_threshold`` ⇒ replan
        │
        ▼
  delta plan — ``planner.replan_cache_from_hotness`` re-runs CSLP + the
  cost model under the unchanged budget; the target sets are diffed
  against current residency
        │
        ▼
  scatter refresh — ``CliqueCache.begin_epoch`` rotates the device double
  buffer, ``apply_feature_delta`` writes admitted rows into freed slots
  through the ``scatter_rows`` kernel, ``replace_topology`` swaps the CSR
  subset.  In-flight batch specs keep gathering from the previous buffer
  (epoch pinning), so a refresh never blocks the pipeline.

Everything runs on the Prefetcher's coordinator thread (``on_step`` is the
``pre_batch_hook``), serialized with spec building by construction; the
consumer thread only ever touches epoch-pinned device arrays.  The device
work of a refresh runs on the cache device's current stream, the stream
the consumer's later gathers run on, so they are ordered after it.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.core.hotness import (CLS, S_FLOAT32, HotnessStats,
                                      accumulate_batch, ewma_blend,
                                      weighted_topk_overlap)
from repro_torch.core.planner import LegionPlan, replan_cache_from_hotness
from repro_torch.core.unified_cache import TrafficCounter
from repro_torch.graph.csr import CSRGraph


@dataclasses.dataclass
class RefreshConfig:
    """Knobs of the online refresh loop."""
    interval: Optional[int] = None   # steps between drift checks; None = off
    ewma_beta: float = 0.7           # weight of observed traffic in the blend
    drift_threshold: float = 0.95    # weighted top-k overlap below => replan
    planner: str = "alpha_sweep"     # cost-model planner for delta plans
    refresh_topology: bool = True    # also swap the topology CSR subset
    min_batches: int = 4             # min observed batches before a check

    def __post_init__(self):
        if self.interval is not None and self.interval < 1:
            raise ValueError("refresh interval must be >= 1 step")
        if not 0.0 <= self.drift_threshold <= 1.0:
            raise ValueError("drift_threshold must be in [0, 1]")


@dataclasses.dataclass
class RefreshStats:
    """What the refresh loop did, surfaced in the training summary."""
    checks: int = 0
    refreshes: int = 0
    admitted: int = 0
    evicted: int = 0
    topo_rebuilds: int = 0
    refresh_bytes_h2d: int = 0
    last_overlap: float = 1.0
    events: List[dict] = dataclasses.field(default_factory=list)

    def summary(self) -> dict:
        return {"checks": self.checks, "refreshes": self.refreshes,
                "admitted": self.admitted, "evicted": self.evicted,
                "topo_rebuilds": self.topo_rebuilds,
                "refresh_bytes_h2d": self.refresh_bytes_h2d,
                "last_overlap": self.last_overlap,
                "events": list(self.events)}


class AccessAccumulator:
    """Live per-vertex access counters for one clique: the online analogue
    of ``presample_clique`` (identical H_T/H_F/N_TSUM semantics, so the
    blended stats drop straight into CSLP and the cost model)."""

    def __init__(self, k_g: int, n: int):
        self.H_T = np.zeros((k_g, n), dtype=np.int64)
        self.H_F = np.zeros((k_g, n), dtype=np.int64)
        self.tsum = 0
        self.batches = 0
        # the devices of one clique share this accumulator and the
        # Prefetcher's build pool can record them concurrently: the rows
        # H_T[gi]/H_F[gi] are disjoint, the clique-wide tallies need the lock
        # (adds commute, so totals equal the serial build order's)
        self._lock = threading.Lock()

    def record(self, g: CSRGraph, gi: int, levels: Sequence[np.ndarray],
               fanouts: Sequence[int]) -> None:
        t = accumulate_batch(g, self.H_T[gi], self.H_F[gi], levels, fanouts)
        with self._lock:
            self.tsum += t
            self.batches += 1

    def reset(self) -> None:
        self.H_T[:] = 0
        self.H_F[:] = 0
        self.tsum = 0
        self.batches = 0


class _BatchObserver:
    """Per-device tap the batch builders call once per sampled batch; binds
    a device to its clique's accumulator.  Pure recording: it never
    perturbs randomness, accounting or batch contents."""

    def __init__(self, manager: "OnlineCacheManager", ci: int, gi: int):
        self._manager = manager
        self._ci = ci
        self._gi = gi

    def record(self, levels: Sequence[np.ndarray],
               fanouts: Sequence[int]) -> None:
        m = self._manager
        m._obs[self._ci].record(m.g, self._gi, levels, fanouts)


class OnlineCacheManager:
    """The adaptive-refresh control loop over a LegionPlan's unified caches.

    Lifecycle: construct over a built plan, hand ``observer_for(dev)`` to
    each device's batch builder, and call ``on_step(step)`` from the
    prefetch coordinator (``train_gnn`` wires it as the Prefetcher's
    ``pre_batch_hook``); ``maybe_refresh`` can also be driven directly (the
    server does).  Where the refresh writes the device table is decided by
    where the cache's tensors live: the ``scatter_rows`` kernel on a GPU,
    its plain version on the CPU.

    On refresh the manager updates ``plan.cslp``/``plan.cost_plans``/
    ``plan.stats`` in place for the refreshed clique.
    """

    def __init__(self, g: CSRGraph, plan: LegionPlan,
                 config: Optional[RefreshConfig] = None,
                 counter: Optional[TrafficCounter] = None):
        self.g = g
        self.plan = plan
        self.config = config or RefreshConfig()
        self.counter = counter
        self.stats = RefreshStats()
        self._obs: List[AccessAccumulator] = []
        self._planned_hot: List[np.ndarray] = []   # A_F the cache was built on
        self._blended: List[HotnessStats] = []     # running EWMA estimate
        for ci, devices in enumerate(plan.partition.cliques):
            self._obs.append(AccessAccumulator(len(devices), g.n))
            self._planned_hot.append(np.asarray(plan.stats[ci].A_F,
                                                dtype=np.float64))
            self._blended.append(plan.stats[ci])

    # ---- wiring ----
    def observer_for(self, dev: int) -> _BatchObserver:
        ci = self.plan.partition.clique_of_device(dev)
        gi = self.plan.partition.cliques[ci].index(dev)
        return _BatchObserver(self, ci, gi)

    def on_step(self, step: int) -> None:
        """Prefetch-coordinator hook: drift check + refresh every
        ``interval`` built batches (never on step 0: nothing observed)."""
        if self.config.interval is None or step == 0:
            return
        if step % self.config.interval == 0:
            self.maybe_refresh(step)

    # ---- the control loop ----
    def maybe_refresh(self, step: int = -1) -> int:
        """Run one drift check over every clique; returns how many cliques
        were actually refreshed."""
        return sum(self._refresh_clique(ci, step)
                   for ci in range(len(self.plan.partition.cliques)))

    def _refresh_clique(self, ci: int, step: int) -> bool:
        obs = self._obs[ci]
        if obs.batches < self.config.min_batches:
            return False
        blended = ewma_blend(self._blended[ci], obs.H_T, obs.H_F, obs.tsum,
                             beta=self.config.ewma_beta)
        obs.reset()  # windowed observation: each check sees fresh traffic
        self._blended[ci] = blended
        cache = self.plan.caches[ci]
        k = int((cache.feat_ids >= 0).sum())
        overlap = weighted_topk_overlap(self._planned_hot[ci], blended.A_F, k)
        self.stats.checks += 1
        self.stats.last_overlap = overlap
        if overlap >= self.config.drift_threshold or k == 0:
            return False

        info, topo_rebuilt = self._replan_and_apply(ci, blended)
        self.stats.refreshes += 1
        self.stats.admitted += info["admitted"]
        self.stats.evicted += info["evicted"]
        self.stats.topo_rebuilds += int(topo_rebuilt)
        self.stats.refresh_bytes_h2d += info["bytes_h2d"]
        self.stats.events.append(
            {"step": step, "clique": ci, "overlap": overlap,
             "admitted": info["admitted"], "evicted": info["evicted"],
             "topo_rebuilt": topo_rebuilt})
        return True

    def _replan_and_apply(self, ci: int, blended: HotnessStats):
        """Delta-replan one clique from ``blended`` hotness and apply the
        admissions/evictions in place (the shared tail of an online refresh
        and a restored hot-set recovery).  Updates the plan's
        cslp/cost/stats view; returns ``(info, topo_rebuilt)``."""
        res, cost_plan, feat_tgt, topo_tgt = replan_cache_from_hotness(
            self.g, self.plan, ci, blended, planner=self.config.planner)
        info = self._apply_feature_delta(ci, blended, feat_tgt)
        topo_rebuilt = False
        if self.config.refresh_topology:
            topo_rebuilt = self._apply_topology_delta(ci, topo_tgt)
        self.plan.cslp[ci] = res
        self.plan.cost_plans[ci] = cost_plan
        self.plan.stats[ci] = blended
        self._planned_hot[ci] = np.asarray(blended.A_F, dtype=np.float64)
        return info, topo_rebuilt

    # ---- delta application ----
    def _apply_feature_delta(self, ci: int, blended: HotnessStats,
                             feat_tgt: List[np.ndarray]) -> dict:
        cache = self.plan.caches[ci]
        cur = cache.feat_ids[cache.feat_ids >= 0]
        tgt_ids = (np.concatenate(feat_tgt) if feat_tgt
                   else np.zeros(0, np.int64)).astype(np.int64)
        owners = np.concatenate(
            [np.full(len(t), gi, np.int32) for gi, t in enumerate(feat_tgt)]
        ) if feat_tgt else np.zeros(0, np.int32)
        evict = cur[~np.isin(cur, tgt_ids)]
        fresh = ~np.isin(tgt_ids, cur)
        admit, admit_owner = tgt_ids[fresh], owners[fresh]
        # hottest-first admission so a truncated fill keeps the right rows
        order = np.argsort(-np.asarray(blended.A_F)[admit], kind="stable")
        admit, admit_owner = admit[order], admit_owner[order]
        cache.begin_epoch()
        info = cache.apply_feature_delta(evict, admit, admit_owner)
        # vertices that stay cached but whose local preference moved keep
        # their slot (no data movement) yet re-home their owner, or the
        # peer-traffic accounting charges their hits to the wrong device
        kept = ~fresh
        if kept.any():
            kept_pos = cache.feat_pos[tgt_ids[kept]]
            cache.feat_owner[kept_pos] = owners[kept]
        if self.counter is not None and info["admitted"]:
            # admissions cross PCIe once; charge them like miss fills, row
            # traffic attributed to the admitting slot's owning device
            row_bytes = self.g.feat_dim * S_FLOAT32
            tx_per_row = int(np.ceil(row_bytes / CLS))
            n_adm = info["admitted"]
            cnt = np.bincount(admit_owner[:n_adm],
                              minlength=len(cache.devices))
            with self.counter.lock:
                self.counter.pcie_transactions += tx_per_row * n_adm
                for gi, d in enumerate(cache.devices):
                    self.counter.bytes_matrix[d, -1] += \
                        row_bytes * int(cnt[gi])
        return info

    def _apply_topology_delta(self, ci: int,
                              topo_tgt: List[np.ndarray]) -> bool:
        cache = self.plan.caches[ci]
        tgt = np.sort(np.concatenate(topo_tgt).astype(np.int64)) \
            if topo_tgt else np.zeros(0, np.int64)
        cur = np.sort(cache.topo_ids)
        if len(tgt) == len(cur) and np.array_equal(tgt, cur):
            return False
        cache.replace_topology(topo_tgt)
        return True

    # ---- checkpointable state ----
    def state_dict(self) -> dict:
        """The learned view of the workload: per-clique EWMA-blended
        hotness, the planned hot set it is compared against, the mid-window
        access accumulators, and the refresh tallies."""
        return {
            "version": 1,
            "cliques": [list(map(int, c))
                        for c in self.plan.partition.cliques],
            "blended": [{"H_T": np.asarray(st.H_T).copy(),
                         "H_F": np.asarray(st.H_F).copy(),
                         "N_TSUM": int(st.N_TSUM)}
                        for st in self._blended],
            "planned_hot": [p.copy() for p in self._planned_hot],
            "obs": [{"H_T": o.H_T.copy(), "H_F": o.H_F.copy(),
                     "tsum": int(o.tsum), "batches": int(o.batches)}
                    for o in self._obs],
            "stats": self.stats.summary(),
        }

    def load_state_dict(self, state: dict, reapply: bool = True) -> int:
        """Restore a ``state_dict`` capture into this manager (same graph
        and clique layout).  With ``reapply=True`` each clique's cache is
        delta-replanned from the restored blended hotness at once, so the
        learned hot set comes back in one admission pass.  Returns the
        number of cliques whose residency actually changed."""
        want = [list(map(int, c)) for c in self.plan.partition.cliques]
        if state["cliques"] != want:
            raise ValueError(
                f"manager state was captured for cliques {state['cliques']}"
                f", this plan has {want}; replan before restoring")
        self._blended = [HotnessStats(H_T=np.asarray(b["H_T"]),
                                      H_F=np.asarray(b["H_F"]),
                                      N_TSUM=int(b["N_TSUM"]))
                         for b in state["blended"]]
        self._planned_hot = [np.asarray(p, dtype=np.float64)
                             for p in state["planned_hot"]]
        for o, rec in zip(self._obs, state["obs"]):
            o.H_T[:] = rec["H_T"]
            o.H_F[:] = rec["H_F"]
            o.tsum = int(rec["tsum"])
            o.batches = int(rec["batches"])
        st = state.get("stats", {})
        self.stats = RefreshStats(
            checks=st.get("checks", 0), refreshes=st.get("refreshes", 0),
            admitted=st.get("admitted", 0), evicted=st.get("evicted", 0),
            topo_rebuilds=st.get("topo_rebuilds", 0),
            refresh_bytes_h2d=st.get("refresh_bytes_h2d", 0),
            last_overlap=st.get("last_overlap", 1.0),
            events=list(st.get("events", [])))
        changed = 0
        if reapply:
            for ci in range(len(want)):
                info, topo_rebuilt = self._replan_and_apply(
                    ci, self._blended[ci])
                if info["admitted"] or info["evicted"] or topo_rebuilt:
                    changed += 1
        return changed

    def summary(self) -> dict:
        return self.stats.summary()

    def publish_metrics(self, reg, base: Optional[dict] = None) -> None:
        """Refresh-loop tallies for the telemetry registry
        (repro_torch.obs): monotonic counters for checks, refreshes and
        admissions plus the latest drift overlap as a gauge.  Pulled at
        snapshot boundaries only — the refresh loop itself is untouched.
        ``base`` adds the totals of a replaced manager, keyed by
        ``summary()`` names, so counters stay monotonic across a swap."""
        s = self.stats
        b = base or {}
        reg.counter("refresh.checks").set_total(s.checks + b.get("checks", 0))
        reg.counter("refresh.refreshes").set_total(
            s.refreshes + b.get("refreshes", 0))
        reg.counter("refresh.admitted").set_total(
            s.admitted + b.get("admitted", 0))
        reg.counter("refresh.evicted").set_total(
            s.evicted + b.get("evicted", 0))
        reg.counter("refresh.topo_rebuilds").set_total(
            s.topo_rebuilds + b.get("topo_rebuilds", 0))
        reg.counter("refresh.bytes_h2d").set_total(
            s.refresh_bytes_h2d + b.get("refresh_bytes_h2d", 0))
        reg.gauge("refresh.last_overlap").set(s.last_overlap)
