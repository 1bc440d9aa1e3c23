"""Algorithm 1: Complete Sharing with Local Preference (CSLP), vectorized.

Inputs: per-device hotness matrices H_T, H_F (K_g x |V|) for one clique.
Outputs (paper notation):
  A_T, A_F — clique-accumulated hotness vectors (column-wise sums)
  Q_T, Q_F — vertex ids in descending clique-level hotness order
  G_T, G_F — per-device priority queues: each vertex assigned to the device
             with the highest local hotness, order inherited from Q_*.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np


@dataclasses.dataclass
class CSLPResult:
    A_T: np.ndarray
    A_F: np.ndarray
    Q_T: np.ndarray
    Q_F: np.ndarray
    G_T: List[np.ndarray]
    G_F: List[np.ndarray]


def _assign(H: np.ndarray, Q: np.ndarray) -> List[np.ndarray]:
    owner = H.argmax(axis=0)  # device with highest local hotness per vertex
    owner_q = owner[Q]
    return [Q[owner_q == g] for g in range(H.shape[0])]


def cslp(H_T: np.ndarray, H_F: np.ndarray) -> CSLPResult:
    # Step 1: accumulate each vertex's hotness over the K_g devices
    A_T = H_T.sum(axis=0)
    A_F = H_F.sum(axis=0)
    # Step 2: clique-level descending order (stable: ties by vertex id)
    Q_T = np.argsort(-A_T, kind="stable")
    Q_F = np.argsort(-A_F, kind="stable")
    # Drop never-touched vertices from the queues (hotness 0 can't help)
    Q_T = Q_T[A_T[Q_T] > 0]
    Q_F = Q_F[A_F[Q_F] > 0]
    # Step 3: local preference assignment
    return CSLPResult(A_T=A_T, A_F=A_F, Q_T=Q_T, Q_F=Q_F,
                      G_T=_assign(H_T, Q_T), G_F=_assign(H_F, Q_F))
