"""Pre-sampling hotness estimation (paper §4.2.2 S1, Figure 6).

Runs one (or more) epochs of neighbor sampling over each device's training
tablet and accumulates:

* H_T[g, v] — topology hotness: +1 per edge traversed whose source is v
              (i.e. fanout counts whenever v's adjacency list is read);
* H_F[g, v] — feature hotness: +1 whenever v appears in a batch's sampled
              result (any hop, incl. the seeds);
* N_TSUM    — simulated PCIe transaction count for sampling: reading v's
              adjacency costs ceil(nc(v)*s_uint32 / CLS) + 1 transactions
              (neighbor list + indptr probe).  The paper reads this from
              Intel PCM; our simulator defines it analytically with the same
              CLS granularity.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np

from repro_torch.graph.csr import CSRGraph
from repro_torch.graph.sampling import host_sample_batch

CLS = 64  # transferred cache-line size (paper: from PCM; 64B on our hosts)
S_UINT32 = 4
S_UINT64 = 8
S_FLOAT32 = 4


def sampling_transactions(g: CSRGraph, vertices: np.ndarray) -> np.ndarray:
    """PCIe transactions to read each vertex's adjacency from host memory."""
    deg = g.indptr[np.asarray(vertices) + 1] - g.indptr[np.asarray(vertices)]
    return np.ceil(deg * S_UINT32 / CLS).astype(np.int64) + 1


def accumulate_batch(g: CSRGraph, H_T_row: np.ndarray, H_F_row: np.ndarray,
                     levels: Sequence[np.ndarray],
                     fanouts: Sequence[int]) -> int:
    """Fold one sampled batch into per-device hotness rows; returns the
    batch's simulated sampling transactions.  THE definition of H_T/H_F
    semantics — pre-sampling and the online cache manager's live counters
    both call this, so blended stats are comparable by construction."""
    # feature hotness: every sampled vertex (all hops + seeds)
    flat = np.concatenate([np.asarray(l).reshape(-1) for l in levels])
    flat = flat[flat >= 0]
    np.add.at(H_F_row, flat, 1)
    # topology hotness: sources whose adjacency was read, x fanout
    tsum = 0
    for l, f in zip(levels[:-1], fanouts):
        srcs = np.asarray(l).reshape(-1)
        srcs = srcs[srcs >= 0]
        np.add.at(H_T_row, srcs, f)
        tsum += int(sampling_transactions(g, srcs).sum())
    return tsum


@dataclasses.dataclass
class HotnessStats:
    H_T: np.ndarray  # (K_g, n) per-device topology hotness (one clique)
    H_F: np.ndarray  # (K_g, n)
    N_TSUM: int  # clique-total sampling transactions during pre-sampling

    @property
    def A_T(self) -> np.ndarray:
        return self.H_T.sum(axis=0)

    @property
    def A_F(self) -> np.ndarray:
        return self.H_F.sum(axis=0)


def presample_clique(g: CSRGraph, tablets: Sequence[np.ndarray],
                     fanouts: Sequence[int] = (25, 10), batch_size: int = 1024,
                     epochs: int = 1, seed: int = 0) -> HotnessStats:
    """Pre-sample one NVLink clique (one tablet per member device)."""
    k_g = len(tablets)
    H_T = np.zeros((k_g, g.n), dtype=np.int64)
    H_F = np.zeros((k_g, g.n), dtype=np.int64)
    n_tsum = 0
    for gi, tablet in enumerate(tablets):
        rng = np.random.default_rng(seed + 1000 * gi)
        for _ in range(epochs):
            order = rng.permutation(tablet)  # local shuffle
            for s in range(0, len(order), batch_size):
                seeds = order[s: s + batch_size]
                levels = host_sample_batch(g, seeds, fanouts, rng)
                n_tsum += accumulate_batch(g, H_T[gi], H_F[gi], levels,
                                           fanouts)
    return HotnessStats(H_T=H_T, H_F=H_F, N_TSUM=n_tsum)


def ewma_blend(base: HotnessStats, obs_H_T: np.ndarray, obs_H_F: np.ndarray,
               obs_tsum: int, beta: float = 0.5) -> HotnessStats:
    """EWMA merge of *observed* per-device access counts into a hotness
    estimate (the online cache manager's live view of the workload).

    Observed counts come from a different number of batches than the
    pre-sampling epoch, so they are first rescaled to the base stats' total
    mass — ``beta`` is then a pure mixing weight: 0 keeps the pre-sampled
    plan, 1 trusts only live traffic.  Chaining calls (blend, observe,
    blend...) decays stale mass geometrically, which is what lets repeated
    refreshes converge on a shifted seed distribution.
    """
    if not 0.0 <= beta <= 1.0:
        raise ValueError(f"beta must be in [0, 1], got {beta}")

    def _scaled(obs, ref_total):
        tot = obs.sum()
        if tot <= 0:
            return np.zeros_like(obs, dtype=np.float64)
        return obs.astype(np.float64) * (ref_total / tot)

    tot_T = max(float(base.H_T.sum()), 1.0)
    tot_F = max(float(base.H_F.sum()), 1.0)
    H_T = (1 - beta) * base.H_T.astype(np.float64) + beta * _scaled(obs_H_T, tot_T)
    H_F = (1 - beta) * base.H_F.astype(np.float64) + beta * _scaled(obs_H_F, tot_F)
    # N_TSUM is the per-epoch sampling transaction magnitude; observed
    # transactions are rescaled the same way before mixing
    obs_t_total = float(np.asarray(obs_H_T, dtype=np.float64).sum())
    scale = (base.H_T.sum() / obs_t_total) if obs_t_total > 0 else 0.0
    n_tsum = (1 - beta) * base.N_TSUM + beta * (obs_tsum * scale)
    return HotnessStats(H_T=H_T, H_F=H_F, N_TSUM=int(round(n_tsum)))


def weighted_topk_overlap(plan_hot: np.ndarray, observed_hot: np.ndarray,
                          k: int) -> float:
    """Drift metric: how much of the *observed* top-k hot mass the plan's
    top-k set still captures.

    Returns sum(observed hotness over plan-top-k ∩ observed-top-k) /
    sum(observed hotness over observed-top-k) in [0, 1].  1.0 means the
    planned cache set is still the right one; a low value means the live
    traffic concentrates on vertices the plan never admitted.
    """
    k = int(min(k, len(plan_hot), len(observed_hot)))
    if k <= 0:
        return 1.0
    obs = np.asarray(observed_hot, dtype=np.float64)
    top_obs = np.argpartition(-obs, k - 1)[:k]
    denom = float(obs[top_obs].sum())
    if denom <= 0:
        return 1.0  # no observed traffic -> nothing has drifted
    plan = np.asarray(plan_hot, dtype=np.float64)
    top_plan = np.argpartition(-plan, min(k - 1, len(plan) - 1))[:k]
    in_plan = np.zeros(len(plan), dtype=bool)
    in_plan[top_plan] = True
    return float(obs[top_obs[in_plan[top_obs]]].sum()) / denom


def presample_all(g: CSRGraph, plan, fanouts=(25, 10), batch_size: int = 1024,
                  epochs: int = 1, seed: int = 0) -> List[HotnessStats]:
    """Pre-sample every clique of a PartitionPlan concurrently-equivalent."""
    out = []
    for devices in plan.cliques:
        tablets = [plan.tablets[d] for d in devices]
        out.append(presample_clique(g, tablets, fanouts=fanouts,
                                    batch_size=batch_size, epochs=epochs,
                                    seed=seed))
    return out
