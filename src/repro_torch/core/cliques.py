"""Interconnect clique detection (paper §4.1 S1).

Legion uses MaxCliqueDyn on the NVLink topology matrix to find NVLink
cliques.  We implement the same Tomita-style branch-and-bound with greedy
coloring bounds (the core of MaxCliqueDyn) and extract a clique *cover* by
repeatedly removing maximum cliques.  On TPU the adjacency matrix describes
ICI connectivity: a pod slice is a block clique, multiple pods give several
cliques joined by DCN — but the algorithm also handles degraded/irregular
topologies (failed links, mixed reservations), which is what lets the cache
planner adapt automatically.
"""
from __future__ import annotations

from typing import List

import numpy as np


def _color_sort(adj: np.ndarray, R: List[int]):
    """Greedy coloring; returns [(vertex, color)] in ascending color order."""
    classes: List[List[int]] = []
    for v in R:
        for cl in classes:
            if not any(adj[v, u] for u in cl):
                cl.append(v)
                break
        else:
            classes.append([v])
    out = []
    for ci, cl in enumerate(classes):
        for v in cl:
            out.append((v, ci + 1))
    return out


def max_clique(adj: np.ndarray) -> List[int]:
    """Maximum clique via branch-and-bound with coloring bounds (MaxCliqueDyn
    without the dynamic tightness heuristics — exact for the <=64-node
    topology matrices that describe real servers/pods)."""
    adj = np.asarray(adj, dtype=bool)
    np.fill_diagonal(adj, False)
    n = adj.shape[0]
    deg = adj.sum(1)
    order = sorted(range(n), key=lambda v: -int(deg[v]))
    best: List[int] = []

    def expand(R: List[int], C: List[int]):
        nonlocal best
        colored = _color_sort(adj, R)
        for v, c in reversed(colored):
            if len(C) + c <= len(best):
                return
            C.append(v)
            R2 = [u for u, _ in colored if u != v and adj[v, u]]
            if R2:
                expand(R2, C)
            elif len(C) > len(best):
                best = list(C)
            C.pop()
            R.remove(v)

    expand(order, [])
    return sorted(best)


def clique_cover(adj: np.ndarray) -> List[List[int]]:
    """Partition devices into cliques: repeatedly remove a maximum clique.
    Returns cliques sorted by (descending size, first member)."""
    adj = np.asarray(adj, dtype=bool).copy()
    np.fill_diagonal(adj, False)
    n = adj.shape[0]
    remaining = set(range(n))
    cliques = []
    while remaining:
        idx = sorted(remaining)
        sub = adj[np.ix_(idx, idx)]
        mc = max_clique(sub)
        clique = [idx[i] for i in mc] if mc else [idx[0]]
        if not clique:
            clique = [idx[0]]
        cliques.append(sorted(clique))
        remaining -= set(clique)
    cliques.sort(key=lambda c: (-len(c), c[0]))
    return cliques


def topology_matrix(kind: str, n_gpus: int = 8) -> np.ndarray:
    """Reference topologies from the paper's Table 1 + TPU analogues.

    dgx-v100: K_c=2, K_g=4; siton: K_c=4, K_g=2; dgx-a100: K_c=1, K_g=8;
    tpu-pod: all chips in one ICI domain; tpu-2pod: two ICI domains.
    """
    adj = np.zeros((n_gpus, n_gpus), dtype=bool)

    def block(members):
        for a in members:
            for b in members:
                if a != b:
                    adj[a, b] = True

    if kind in ("dgx-a100", "nv8", "tpu-pod"):
        block(range(n_gpus))
    elif kind in ("dgx-v100", "nv4"):
        half = n_gpus // 2
        block(range(half))
        block(range(half, n_gpus))
    elif kind in ("siton", "nv2"):
        for i in range(0, n_gpus, 2):
            block((i, i + 1))
    elif kind == "tpu-2pod":
        half = n_gpus // 2
        block(range(half))
        block(range(half, n_gpus))
    elif kind == "nonv":
        pass
    else:
        raise KeyError(kind)
    return adj
