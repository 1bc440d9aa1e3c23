"""The execution meshes: the hierarchical ``(pod, clique)`` mesh of the
sharded clique executor (paper §4.1), the one-axis ``("data",)`` mesh
of plain data parallelism (``train_gnn(mesh=, compress_grads=)``), and
the language models' ``("data", "model")`` / ``("pod", "data", "model")``
mesh (``LMMesh``: the reference's debug and production meshes,
``models/sharding.py`` runs the LM path over it).

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
import itertools
import math
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


@dataclasses.dataclass(frozen=True)
class LMMesh:
    """A grid of devices with named axes, row-major: ``devices[i]`` runs
    mesh position ``i``, whose coordinates are ``coords(i)`` (the last axis
    varies fastest, as in the reference's ``Mesh`` over a reshaped device
    array).  Every position is a ``torch.device``: its own card, one card
    for all, the CPU, or ``meta`` (the dry-run's accounting).

    ``active`` is the positions this process runs: all of them, or one
    position that stands for the others (``run_only``, on ``meta`` only:
    collectives then take each absent peer's shard to be a copy of the
    local one, which gives the right shapes and counts and no values)."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    devices: Tuple[torch.device, ...]
    active: Optional[Tuple[int, ...]] = None

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"axes {self.axis_names} and sizes {self.sizes} "
                             "differ in length")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"axis names {self.axis_names} repeat")
        if len(self.devices) != math.prod(self.sizes):
            raise ValueError(f"{len(self.devices)} devices for a mesh of "
                             f"{self.sizes}")
        if self.active is None:
            object.__setattr__(self, "active", tuple(range(self.size)))

    @property
    def shape(self) -> dict:
        """Axis name -> size, in axis order (the reference's
        ``mesh.shape``)."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    @property
    def device_grid(self) -> tuple:
        """The devices as nested tuples of the mesh's shape."""
        def nest(flat, sizes):
            if len(sizes) == 1:
                return tuple(flat)
            n = len(flat) // sizes[0]
            return tuple(nest(flat[i * n:(i + 1) * n], sizes[1:])
                         for i in range(sizes[0]))
        return nest(list(self.devices), list(self.sizes))

    def device(self, i: int) -> torch.device:
        return self.devices[i]

    def positions(self) -> Iterator[int]:
        """Every position index in row-major order."""
        return iter(range(self.size))

    def coords(self, i: int) -> dict:
        """Axis name -> coordinate of position ``i``."""
        out = {}
        for name, n in zip(reversed(self.axis_names), reversed(self.sizes)):
            out[name] = i % n
            i //= n
        return {a: out[a] for a in self.axis_names}

    def index(self, coords: dict) -> int:
        i = 0
        for name, n in zip(self.axis_names, self.sizes):
            i = i * n + coords[name]
        return i

    def rank(self, i: int, axes: Sequence[str]) -> int:
        """Position ``i``'s place along ``axes``, major to minor in the
        order given (a dim sharded over ``axes`` holds its ``rank``-th
        block there)."""
        c, r = self.coords(i), 0
        for a in axes:
            r = r * self.shape[a] + c[a]
        return r

    def group(self, i: int, axes: Sequence[str]) -> list:
        """The positions that share every coordinate of ``i`` outside
        ``axes``, ordered by their ``rank`` along ``axes``: the group a
        collective over ``axes`` spans."""
        c = self.coords(i)
        out = []
        for vals in itertools.product(*(range(self.shape[a]) for a in axes)):
            out.append(self.index({**c, **dict(zip(axes, vals))}))
        return out

    def run_only(self, i: int) -> "LMMesh":
        """This mesh, with position ``i`` standing for every position (on
        ``meta`` only: the others' values are never computed)."""
        if any(d.type != "meta" for d in self.devices):
            raise ValueError("one position stands for the others only on "
                             "the meta device")
        return dataclasses.replace(self, active=(i,))


def _lm_mesh(shape, axes, devices, where: str) -> LMMesh:
    shape, axes = tuple(shape), tuple(axes)
    n = math.prod(shape)
    if devices is None:
        devices = "cuda:0"
    if isinstance(devices, (str, torch.device)):
        devices = [devices] * n
    if len(devices) != n:
        raise ValueError(f"{where}: {len(devices)} devices pinned for a mesh "
                         f"of {shape} (need exactly {n})")
    return LMMesh(axes, shape, tuple(bind_devices(devices, where)))


def make_debug_mesh(shape=(2, 2), axes=("data", "model"),
                    devices=None) -> LMMesh:
    """Small mesh for tests and the smoke (the reference's ``:72-79``).
    ``devices`` binds the positions in row-major order (a sequence of
    anything ``torch.device`` takes, or one device for all); the default
    binds every position to ``cuda:0``.  A card the host does not have
    raises, and so does a binding that mixes device types."""
    return _lm_mesh(shape, axes, devices, "make_debug_mesh")


def make_production_mesh(*, multi_pod: bool = False,
                         device="meta") -> LMMesh:
    """The reference's production meshes: 16 x 16 ``("data", "model")``,
    or 2 x 16 x 16 ``("pod", "data", "model")`` with ``multi_pod``, every
    position bound to ``device``: ``meta`` for the dry-run's accounting
    (one card cannot hold 256 positions' state); a CUDA binding the host
    lacks raises."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _lm_mesh(shape, axes, device, "make_production_mesh")
