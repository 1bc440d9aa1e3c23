"""The execution meshes: the hierarchical ``(pod, clique)`` mesh of the
sharded clique executor (paper §4.1), and the one-axis ``("data",)`` mesh
of plain data parallelism (``train_gnn(mesh=, compress_grads=)``).

Axes ``("pod", "clique")``: one row per NVLink clique of the
``PartitionPlan``, one column per device within its clique.  All cache and
batch traffic stays within a row (the routed gather's peer exchange never
crosses cliques); gradient synchronization additionally combines over
``"pod"``, the data-parallel inter-clique axis.  A single-clique plan is
the degenerate ``K_c=1`` case of the same mesh.

The executor runs the whole mesh in one process, as the reference runs it
under one ``shard_map``: every position is bound to a ``torch.device`` and
the trainer visits the positions in clique-major order.  This module knows
nothing of JAX; it only validates the clique list and binds devices.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Sequence, Tuple

import torch

from repro_torch.utils import resolve_device

CLIQUE_AXIS = "clique"
POD_AXIS = "pod"
DATA_AXIS = "data"


@dataclasses.dataclass(frozen=True)
class HierarchicalMesh:
    """A ``(K_c, K_g)`` grid of devices: ``devices[ci][gi]`` runs mesh
    position ``(ci, gi)``, the ``gi``-th device of clique ``ci``, which owns
    shard ``gi`` of that clique's unified cache."""
    devices: Tuple[Tuple[torch.device, ...], ...]
    axis_names: Tuple[str, str] = (POD_AXIS, CLIQUE_AXIS)

    @property
    def shape(self) -> Tuple[int, int]:
        return len(self.devices), len(self.devices[0])

    def device(self, ci: int, gi: int) -> torch.device:
        return self.devices[ci][gi]

    def positions(self) -> Iterator[Tuple[int, int]]:
        """Every ``(ci, gi)`` in clique-major order: the order of the
        shard stack, the packed batch and the gradient sum."""
        k_c, k_g = self.shape
        for ci in range(k_c):
            for gi in range(k_g):
                yield ci, gi


def make_hierarchical_mesh(cliques: Sequence[Sequence[int]],
                           devices: Optional[Sequence] = None
                           ) -> HierarchicalMesh:
    """2-D ``(pod, clique)`` execution mesh built from a partition plan's
    clique list (``PartitionPlan.cliques``).

    Row ``ci`` is clique ``ci``; within a row, column ``gi`` is the
    clique-local device that owns cache partition ``gi``.  ``devices``
    binds the positions in clique-major order (anything ``torch.device``
    takes); the default binds every position to ``cuda:0``.  The clique
    list must be uniform: a 2-D mesh cannot express ragged cliques.

    All positions must share one card: a grid spanning several cards needs
    the peer-access form of the routed kernels and a cross-card gradient
    sum, which is ROADMAP work (the multi-card sharded executor) and
    raises ``NotImplementedError`` here.
    """
    sizes = sorted({len(c) for c in cliques})
    if not cliques or sizes[0] == 0:
        raise ValueError("make_hierarchical_mesh: need at least one "
                         "non-empty clique")
    if len(sizes) != 1:
        raise ValueError(
            f"make_hierarchical_mesh: clique sizes {[len(c) for c in cliques]}"
            " are ragged; the (pod, clique) mesh needs one uniform K_g")
    k_c, k_g = len(cliques), sizes[0]
    n = k_c * k_g
    if devices is None:
        devices = [resolve_device("cuda:0")] * n
    if len(devices) != n:
        raise ValueError(
            f"make_hierarchical_mesh: {len(devices)} devices pinned for a "
            f"{k_c}x{k_g} mesh (need exactly {n})")
    devs = [resolve_device(d) for d in devices]
    if len(set(devs)) > 1:
        raise NotImplementedError(
            f"make_hierarchical_mesh: the positions span "
            f"{sorted(map(str, set(devs)))}; only a single-card mesh is "
            "ported (ROADMAP: the multi-card sharded executor)")
    grid = tuple(tuple(devs[ci * k_g:(ci + 1) * k_g]) for ci in range(k_c))
    return HierarchicalMesh(grid)


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """A one-axis ``("data",)`` mesh: ``devices[i]`` runs data position
    ``i``, which trains on the ``i``-th of ``size`` equal chunks of every
    batch (the reference's ``jax.make_mesh((n,), ("data",))``)."""
    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str] = (DATA_AXIS,)

    @property
    def shape(self) -> Tuple[int]:
        return (len(self.devices),)

    @property
    def size(self) -> int:
        return len(self.devices)

    def device(self, i: int) -> torch.device:
        return self.devices[i]


def make_data_mesh(n: int, devices: Optional[Sequence] = None) -> DataMesh:
    """A data mesh of ``n`` positions.  ``devices`` binds them in order
    (anything ``torch.device`` takes); the default binds every position to
    ``cuda:0``, and the positions then run one after another on that card.
    A mesh spanning several cards raises ``NotImplementedError``: that is
    ROADMAP queue 1, item 4 (the sharded executor across cards)."""
    if n < 1:
        raise ValueError(f"make_data_mesh: need at least one position, "
                         f"got {n}")
    if devices is None:
        devices = [resolve_device("cuda:0")] * n
    if len(devices) != n:
        raise ValueError(f"make_data_mesh: {len(devices)} devices pinned "
                         f"for {n} positions")
    devs = tuple(resolve_device(d) for d in devices)
    if len(set(devs)) > 1:
        raise NotImplementedError(
            f"make_data_mesh: the positions span "
            f"{sorted(map(str, set(devs)))}; only a single-card mesh is "
            "ported (ROADMAP queue 1, item 4: the sharded executor across "
            "cards)")
    return DataMesh(devs)
