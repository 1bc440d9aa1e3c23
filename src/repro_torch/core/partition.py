"""Hierarchical graph partitioning (paper §4.1, steps S1–S4).

S1: clique detection (core/cliques.py)
S2: inter-clique edge-cut-minimizing partition of the graph into K_c parts.
    The paper uses METIS/XtraPulp; offline we implement LDG (linear
    deterministic greedy) streaming partitioning with a balance penalty —
    the same objective (min edge-cut under balance) at linear cost, plus a
    refinement pass.  `method="hash"` gives the no-locality baseline.
S3: intra-clique split of each partition's training vertices into K_g
    tablets — a seeded-permutation round-robin, so tablet sizes are
    balanced to within one vertex regardless of how training ids are laid
    out (a raw ``v % K_g`` hash skews badly when train ids are strided or
    parity-correlated, e.g. every-other-vertex labeling on a K_g=2 box).
S4: tablet -> device assignment (batch seeds, shuffled locally).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.core.cliques import clique_cover
from repro_torch.graph.csr import CSRGraph


def partition_graph(g: CSRGraph, k: int, method: str = "ldg", seed: int = 0,
                    balance: float = 1.05, passes: int = 2) -> np.ndarray:
    """Vertex -> partition id (edge-cut minimizing for method='ldg')."""
    if k <= 1:
        return np.zeros(g.n, dtype=np.int32)
    if method == "hash":
        return (np.arange(g.n) % k).astype(np.int32)
    if method != "ldg":
        raise KeyError(method)

    rng = np.random.default_rng(seed)
    part = rng.integers(0, k, size=g.n).astype(np.int32)  # warm start
    capacity = balance * g.n / k
    counts = np.bincount(part, minlength=k).astype(np.float64)
    order = rng.permutation(g.n)
    for _ in range(passes):
        for v in order:
            nb = g.neighbors(v)
            old = part[v]
            if len(nb) == 0:
                continue
            score = np.bincount(part[nb], minlength=k).astype(np.float64)
            counts[old] -= 1
            score *= 1.0 - counts / capacity
            new = int(np.argmax(score))
            part[v] = new
            counts[new] += 1
    return part


def edge_cut_fraction(g: CSRGraph, part: np.ndarray) -> float:
    src = np.repeat(np.arange(g.n), g.degrees())
    cut = part[src] != part[g.indices]
    return float(cut.mean()) if len(cut) else 0.0


@dataclasses.dataclass
class PartitionPlan:
    cliques: List[List[int]]  # device ids per clique
    vertex_part: np.ndarray  # (n,) partition id == clique index
    tablets: Dict[int, np.ndarray]  # device id -> training-vertex tablet
    train_vertices: np.ndarray

    def __post_init__(self):
        # device -> clique lookup table: clique_of_device sits on the
        # per-spec-build host hot path of the hierarchical executor, so a
        # linear scan over the clique list is precomputed away here
        hi = max((d for c in self.cliques for d in c), default=-1)
        lut = np.full(hi + 1, -1, dtype=np.int32)
        for ci, c in enumerate(self.cliques):
            lut[np.asarray(list(c), dtype=np.int64)] = ci
        self._dev_to_clique = lut

    @property
    def k_c(self) -> int:
        return len(self.cliques)

    def clique_of_device(self, dev: int) -> int:
        d = int(dev)
        if 0 <= d < len(self._dev_to_clique):
            ci = int(self._dev_to_clique[d])
            if ci >= 0:
                return ci
        raise KeyError(dev)

    def execution_cliques(self, devices: Sequence[int]
                          ) -> Tuple[List[int], List[List[int]]]:
        """Resolve a device set into whole cliques for the hierarchical
        executor: returns ``(clique_indices, per-clique device lists)`` in
        clique-major order.  Raises ``ValueError`` if the set only
        partially covers some clique — each clique's unified cache is
        partitioned across *all* of its devices, so execution is
        all-or-nothing per clique."""
        cids = sorted({self.clique_of_device(d) for d in devices})
        clique_devs = [list(self.cliques[ci]) for ci in cids]
        flat = [d for c in clique_devs for d in c]
        if set(devices) != set(flat):
            raise ValueError(
                f"devices {sorted(devices)} partially cover cliques {cids}: "
                f"their cache partitions span all of {flat}; execution is "
                "all-or-nothing per clique")
        return cids, clique_devs


def hierarchical_partition(g: CSRGraph, train_vertices: np.ndarray,
                           topo: np.ndarray, method: str = "ldg",
                           seed: int = 0) -> PartitionPlan:
    """The full S1-S4 pipeline: topology matrix -> per-device batch seeds."""
    cliques = clique_cover(topo)  # S1
    k_c = len(cliques)
    vertex_part = partition_graph(g, k_c, method=method, seed=seed)  # S2
    tablets: Dict[int, np.ndarray] = {}
    rng = np.random.default_rng(seed)
    for ci, devices in enumerate(cliques):  # S3 + S4
        tv = train_vertices[vertex_part[train_vertices] == ci]
        k_g = len(devices)
        # seeded-permutation round-robin: tablet sizes differ by <= 1 for
        # ANY train-id layout (a ``tv % k_g`` hash collapses onto a subset
        # of devices whenever ids are strided/parity-correlated), and the
        # permutation doubles as the local shuffle of S4
        shuffled = tv[rng.permutation(len(tv))]
        for gi, dev in enumerate(devices):
            tablets[dev] = shuffled[gi::k_g]
    return PartitionPlan(cliques=cliques, vertex_part=vertex_part,
                         tablets=tablets, train_vertices=train_vertices)
