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
under one ``shard_map``: every position is bound to a ``torch.device``
(its own card, or one card for all) and the trainer visits the positions
in clique-major order.  This module knows nothing of JAX; it validates the
clique list, checks every named card against the cards this host has, and
enables peer access between the distinct cards of each clique row (the
routed kernels read a peer's shard through a plain pointer).  Cliques never
read each other's memory, so no access is enabled across rows.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Sequence, Tuple

import torch

from repro_torch.kernels._build import enable_peer_access
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


def bind_devices(devices: Sequence, where: str) -> list:
    """``devices`` as ``torch.device``s with explicit indices, every CUDA
    card among this host's ``torch.cuda.device_count()`` and all of one
    type: a mesh never mixes the CPU with cards, and nothing falls back to
    the CPU or to one card unasked.  Raises otherwise."""
    devs = [resolve_device(d) for d in devices]
    kinds = {d.type for d in devs}
    if len(kinds) > 1:
        raise ValueError(f"{where}: positions bound to "
                         f"{sorted(map(str, set(devs)))} mix device types")
    if "cuda" in kinds:
        count = torch.cuda.device_count()
        missing = sorted({d.index for d in devs if d.index >= count})
        if missing:
            raise ValueError(f"{where}: cuda:{missing} named, but this host "
                             f"has {count} CUDA device(s)")
    return devs


def make_hierarchical_mesh(cliques: Sequence[Sequence[int]],
                           devices: Optional[Sequence] = None
                           ) -> HierarchicalMesh:
    """2-D ``(pod, clique)`` execution mesh built from a partition plan's
    clique list (``PartitionPlan.cliques``).

    Row ``ci`` is clique ``ci``; within a row, column ``gi`` is the
    clique-local device that owns cache partition ``gi``.  ``devices``
    binds the positions in clique-major order (anything ``torch.device``
    takes): each position on its own card, or several on one; the default
    binds every position to ``cuda:0``.  The clique list must be uniform: a
    2-D mesh cannot express ragged cliques.

    A card the host does not have raises, and so does a binding that mixes
    the CPU with cards.  For every pair of distinct cards within one row,
    ``torch.cuda.can_device_access_peer`` must hold both ways (else
    ``ValueError``), and peer access is enabled both ways, once per pair
    (``kernels._build.enable_peer_access``); rows get none between them.
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
    devs = bind_devices(devices, "make_hierarchical_mesh")
    grid = tuple(tuple(devs[ci * k_g:(ci + 1) * k_g]) for ci in range(k_c))
    for row in grid:
        cards = sorted({d.index for d in row if d.type == "cuda"})
        pairs = [(a, b) for a in cards for b in cards if a != b]
        for a, b in pairs:
            if not torch.cuda.can_device_access_peer(a, b):
                raise ValueError(
                    f"make_hierarchical_mesh: cuda:{a} cannot access "
                    f"cuda:{b}'s memory; the cards of one clique must be "
                    "peers (one NVLink clique)")
        for a, b in pairs:
            enable_peer_access(a, b)
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
    (anything ``torch.device`` takes): each on its own card, or several on
    one, where they run one after another; the default binds every
    position to ``cuda:0``.  A card the host does not have raises, and so
    does a binding that mixes the CPU with cards.  The positions exchange
    only explicit copies (their gradients, to position 0), so no peer
    access is needed."""
    if n < 1:
        raise ValueError(f"make_data_mesh: need at least one position, "
                         f"got {n}")
    if devices is None:
        devices = [resolve_device("cuda:0")] * n
    if len(devices) != n:
        raise ValueError(f"make_data_mesh: {len(devices)} devices pinned "
                         f"for {n} positions")
    return DataMesh(tuple(bind_devices(devices, "make_data_mesh")))
