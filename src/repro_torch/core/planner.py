"""Automatic caching management: the end-to-end Legion planner (paper Fig. 5).

  topology matrix + graph
    -> S1 clique detection  -> S2 inter-clique partition -> S3/S4 tablets
    -> pre-sampling (H_T, H_F, N_TSUM) -> CSLP -> cost model (alpha | knapsack)
    -> per-device unified caches

Also provides ``replan_on_topology_change``: elastic re-planning that reuses
the (expensive) pre-sampled hotness when devices fail or the reservation
shrinks or grows; only clique detection, CSLP re-aggregation, the cost model
sweep and cache fills re-run.

Planning is host-only numpy; the caches upload their device halves lazily,
on the device their first consumer names.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.cliques import clique_cover
from repro_torch.core.cost_model import CliqueCostModel
from repro_torch.core.cslp import CSLPResult, cslp
from repro_torch.core.hotness import HotnessStats, presample_clique
from repro_torch.core.partition import PartitionPlan, hierarchical_partition
from repro_torch.core.unified_cache import (CliqueCache, build_clique_cache,
                                           plan_cache_contents)
from repro_torch.graph.csr import CSRGraph


@dataclasses.dataclass
class LegionPlan:
    partition: PartitionPlan
    stats: List[HotnessStats]  # per clique
    cslp: List[CSLPResult]
    cost_plans: List[dict]
    caches: List[CliqueCache]
    mem_per_device: float
    timings: Dict[str, float]
    # how each clique spends its per-device topology budget: "sharded"
    # (disjoint per-device shards, union ~K_g x bt) or "replicated"
    # (bt-byte union on every device — the equal-memory baseline)
    topology_mode: str = "sharded"

    def cache_for_device(self, dev: int) -> CliqueCache:
        return self.caches[self.partition.clique_of_device(dev)]


def build_plan(g: CSRGraph, topo_matrix: np.ndarray, mem_per_device: float,
               *, train_fraction: float = 0.10,
               train_vertices: Optional[np.ndarray] = None,
               fanouts: Sequence[int] = (25, 10), batch_size: int = 1024,
               partition_method: str = "ldg", planner: str = "alpha_sweep",
               presample_epochs: int = 1, seed: int = 0,
               materialize_caches: bool = True,
               topology_mode: str = "sharded") -> LegionPlan:
    timings = {}
    rng = np.random.default_rng(seed)
    if train_vertices is None:
        n_train = int(g.n * train_fraction)
        train_vertices = np.sort(rng.choice(g.n, size=n_train, replace=False))

    t0 = time.perf_counter()
    part = hierarchical_partition(g, train_vertices, topo_matrix,
                                  method=partition_method, seed=seed)
    timings["partition_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    stats, cslps, plans, caches = [], [], [], []
    for ci, devices in enumerate(part.cliques):
        tablets = [part.tablets[d] for d in devices]
        st = presample_clique(g, tablets, fanouts=fanouts,
                              batch_size=batch_size, epochs=presample_epochs,
                              seed=seed + ci)
        stats.append(st)
    timings["presample_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    for ci, devices in enumerate(part.cliques):
        res = cslp(stats[ci].H_T, stats[ci].H_F)
        cslps.append(res)
        cm = CliqueCostModel.build(g, res, stats[ci].N_TSUM)
        B = mem_per_device * len(devices)
        plan = cm.plan_knapsack(B) if planner == "knapsack" else cm.plan(B)
        plan["cost_model"] = cm
        plans.append(plan)
        caches.append(build_clique_cache(g, devices, res, plan, mem_per_device,
                                         materialize=materialize_caches,
                                         topology_mode=topology_mode))
    timings["plan_s"] = time.perf_counter() - t0
    return LegionPlan(partition=part, stats=stats, cslp=cslps,
                      cost_plans=plans, caches=caches,
                      mem_per_device=mem_per_device, timings=timings,
                      topology_mode=topology_mode)


def replan_cache_from_hotness(g: CSRGraph, plan: LegionPlan, clique_idx: int,
                              stats: HotnessStats,
                              planner: str = "alpha_sweep"):
    """Incremental delta-plan for one clique from *blended* (pre-sampled +
    observed) hotness: re-run CSLP and the cost model under the unchanged
    memory budget and return the target residency sets, without building a
    fresh CliqueCache, so the online cache manager can diff them against
    current residency and apply admissions/evictions in place.

    Returns (cslp_res, cost_plan, feat_ids_per_dev, topo_ids_per_dev).
    """
    devices = plan.partition.cliques[clique_idx]
    res = cslp(stats.H_T, stats.H_F)
    cm = CliqueCostModel.build(g, res, stats.N_TSUM)
    B = plan.mem_per_device * len(devices)
    cost_plan = cm.plan_knapsack(B) if planner == "knapsack" else cm.plan(B)
    cost_plan["cost_model"] = cm
    mode = plan.caches[clique_idx].topology_mode
    feat_ids, topo_ids = plan_cache_contents(g, len(devices), res, cost_plan,
                                             plan.mem_per_device,
                                             topology_mode=mode)
    return res, cost_plan, feat_ids, topo_ids


def replan_on_topology_change(g: CSRGraph, old: LegionPlan,
                              new_topo: np.ndarray,
                              alive: Optional[Sequence[int]] = None,
                              planner: str = "alpha_sweep",
                              mem_per_device: Optional[float] = None
                              ) -> LegionPlan:
    """Elastic replan after a device failure or a reservation change.

    Reuses per-device hotness rows from the old plan (hotness is a property
    of the sampled workload, not of the device layout); dead devices'
    tablets and hotness merge round-robin into the survivors.  An optional
    ``mem_per_device`` re-plans under a grown or shrunk budget (the cache
    fill orders are hotness-sorted, so the old contents are a prefix of the
    new).  The new caches upload their device halves lazily, as
    ``build_plan``'s do.
    """
    n_old = new_topo.shape[0]
    alive = list(alive) if alive is not None else list(range(n_old))
    # per-device hotness rows from the old plan
    rows_T: Dict[int, np.ndarray] = {}
    rows_F: Dict[int, np.ndarray] = {}
    for ci, devices in enumerate(old.partition.cliques):
        for gi, d in enumerate(devices):
            rows_T[d] = old.stats[ci].H_T[gi]
            rows_F[d] = old.stats[ci].H_F[gi]
    dead = [d for d in rows_T if d not in alive]

    sub = new_topo[np.ix_(alive, alive)]
    new_cliques = [[alive[i] for i in c] for c in clique_cover(sub)]

    # redistribute dead devices' tablets + hotness round-robin over survivors
    tablets = {d: old.partition.tablets[d] for d in alive
               if d in old.partition.tablets}
    for i, d in enumerate(dead):
        tgt = alive[i % len(alive)]
        t = old.partition.tablets.get(d)
        if t is not None:
            tablets[tgt] = np.concatenate(
                [tablets.get(tgt, np.zeros(0, np.int64)), t])
        rows_T[tgt] = rows_T[tgt] + rows_T[d]
        rows_F[tgt] = rows_F[tgt] + rows_F[d]

    mem = old.mem_per_device if mem_per_device is None else mem_per_device
    stats, cslps, plans, caches = [], [], [], []
    scale = old.stats[0].N_TSUM / max(
        sum(len(c) for c in old.partition.cliques), 1)
    for devices in new_cliques:
        H_T = np.stack([rows_T[d] for d in devices])
        H_F = np.stack([rows_F[d] for d in devices])
        st = HotnessStats(H_T=H_T, H_F=H_F, N_TSUM=int(scale * len(devices)))
        stats.append(st)
        res = cslp(H_T, H_F)
        cslps.append(res)
        cm = CliqueCostModel.build(g, res, st.N_TSUM)
        B = mem * len(devices)
        plan = cm.plan_knapsack(B) if planner == "knapsack" else cm.plan(B)
        plans.append(plan)
        caches.append(build_clique_cache(g, devices, res, plan, mem,
                                         topology_mode=old.topology_mode))

    part = PartitionPlan(cliques=new_cliques,
                         vertex_part=old.partition.vertex_part,
                         tablets=tablets,
                         train_vertices=old.partition.train_vertices)
    return LegionPlan(partition=part, stats=stats, cslp=cslps,
                      cost_plans=plans, caches=caches, mem_per_device=mem,
                      timings={"replan": True},
                      topology_mode=old.topology_mode)
