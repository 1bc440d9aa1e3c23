"""Hotness-aware unified cache (paper §4.2): topology + features in device
memory, sliced across the devices of one clique.

Structures (per clique):
* feature cache — 2-D array of hot-vertex feature rows, slot-major by owning
  device; ``feat_pos[v]`` maps vertex -> global slot (-1 = miss),
  ``feat_owner[slot]`` -> device (for the GPU-GPU traffic matrix).
* topology cache — CSR subset of hot adjacency lists (``topo_pos[v]`` -> row).

The host mirrors are numpy; ``device_arrays`` uploads them once as torch
tensors on one explicit device (the GPU's HBM, or the CPU when a caller
asks for it), and ``sharded_device_arrays`` once more in the partitioned
form of the sharded executor, each shard on the card of the mesh position
that owns it.  ``TrafficCounter`` accounts every miss in PCIe transactions
with the same CLS granularity as the cost model, and every intra-clique
remote hit as NVLink traffic.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.hotness import CLS, S_FLOAT32, S_UINT32
from repro_torch.graph.csr import CSRGraph
from repro_torch.kernels import gather, scatter
from repro_torch.utils import device_context, resolve_device

# the sharded topology layout's device arrays (routing tables + per-shard
# CSR stacks), present only in sharded mode
_SHARD_TOPO_KEYS = ("topo_owner", "topo_local", "topo_shard_indptr",
                    "topo_shard_indices")


def _per_card(host: np.ndarray, devs) -> tuple:
    """A host array uploaded once to every distinct device of ``devs``, as
    a tuple indexed like ``devs`` (positions sharing a card share a copy)."""
    copies = {}
    for d in devs:
        if d not in copies:
            copies[d] = torch.tensor(host, device=d)
    return tuple(copies[d] for d in devs)


@dataclasses.dataclass
class TrafficCounter:
    n_devices: int
    # traffic[dst, src]: src == n_devices means CPU (PCIe); else peer device
    bytes_matrix: np.ndarray = None
    # topology-exchange traffic, same [dst, src] layout: sampled neighbor
    # ids served by the owner shard (diagonal = own shard, off-diagonal =
    # the routed neighbor exchange's intra-clique hops).  Kept separate
    # from bytes_matrix so feature-gather accounting stays bit-identical
    # between the replicated and sharded topology layouts.
    topo_bytes_matrix: np.ndarray = None
    pcie_transactions: int = 0
    feature_requests: int = 0
    feature_hits: int = 0
    topo_requests: int = 0
    topo_hits: int = 0
    # sampling's host-CSR fallback: spec builds that had to touch the host
    # CSR at all, and the neighbor draws those resolves produced
    host_sample_syncs: int = 0
    host_sampled_edges: int = 0
    # guards the scalar tallies when several threads account concurrently
    # (integer adds commute, so totals stay bit-identical regardless of
    # interleaving; the lock only prevents lost updates)
    lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, repr=False, compare=False)

    def __post_init__(self):
        if self.bytes_matrix is None:
            self.bytes_matrix = np.zeros(
                (self.n_devices, self.n_devices + 1), dtype=np.int64)
        if self.topo_bytes_matrix is None:
            self.topo_bytes_matrix = np.zeros(
                (self.n_devices, self.n_devices + 1), dtype=np.int64)

    @classmethod
    def for_devices(cls, devices) -> "TrafficCounter":
        """Counter sized so every physical device id has its own column —
        device ids are used directly as matrix indices (no modulo aliasing)."""
        devices = list(devices)
        return cls(n_devices=(max(devices) + 1) if devices else 1)

    @classmethod
    def for_plan(cls, plan) -> "TrafficCounter":
        return cls.for_devices([d for c in plan.partition.cliques for d in c])

    @property
    def feature_hit_rate(self) -> float:
        return self.feature_hits / max(self.feature_requests, 1)

    @property
    def topo_hit_rate(self) -> float:
        return self.topo_hits / max(self.topo_requests, 1)

    @staticmethod
    def _cross_clique(matrix: np.ndarray,
                      cliques: Sequence[Sequence[int]]) -> int:
        total = 0
        for ci, devs in enumerate(cliques):
            others = [d for cj, c in enumerate(cliques) if cj != ci
                      for d in c]
            if others:
                total += int(matrix[np.ix_(list(devs), others)].sum())
        return total

    def cross_clique_bytes(self, cliques: Sequence[Sequence[int]]) -> int:
        """Device-to-device feature bytes between devices of *different*
        cliques.  The hierarchical executor's invariant is that this is
        exactly 0: feature rows only travel intra-clique (peer exchange) or
        over PCIe (host fill)."""
        return self._cross_clique(self.bytes_matrix, cliques)

    def cross_clique_topo_bytes(self, cliques: Sequence[Sequence[int]]) -> int:
        """Topology-exchange bytes between devices of different cliques:
        every frontier row is served by an owner shard *within* the
        requester's clique (or by the host over PCIe), so this is exactly
        0 as well."""
        return self._cross_clique(self.topo_bytes_matrix, cliques)

    def per_clique_split(self, cliques: Sequence[Sequence[int]]) -> list:
        """Feature-gather traffic aggregated per clique: local-hit bytes
        (each device's own partition, the matrix diagonal), peer bytes
        (intra-clique exchange, off-diagonal within the clique block) and
        host-fill bytes (the PCIe column)."""
        out = []
        for ci, devs in enumerate(cliques):
            devs = list(devs)
            sub = self.bytes_matrix[np.ix_(devs, devs)]
            out.append({"clique": ci,
                        "local_bytes": int(np.trace(sub)),
                        "peer_bytes": int(sub.sum() - np.trace(sub)),
                        "host_fill_bytes": int(
                            self.bytes_matrix[devs, -1].sum())})
        return out

    def publish_metrics(self, reg) -> None:
        """Mirror the live tallies into a telemetry ``MetricsRegistry``
        (repro_torch.obs) — pulled at snapshot boundaries, so accounting
        hot paths pay nothing.  One consistent capture under the lock, then
        monotonic ``set_total`` per counter: the registry's window deltas
        telescope to these exact totals.  Byte matrices publish both as
        per-tier aggregates (local diagonal / intra-clique peer / PCIe
        column) and as per-``(dst, src)`` pair counters for every pair
        that has ever moved a byte."""
        with self.lock:
            bm = self.bytes_matrix.copy()
            tm = self.topo_bytes_matrix.copy()
            scalars = {
                "traffic.feature_requests": self.feature_requests,
                "traffic.feature_hits": self.feature_hits,
                "traffic.topo_requests": self.topo_requests,
                "traffic.topo_hits": self.topo_hits,
                "traffic.pcie_transactions": self.pcie_transactions,
                "traffic.host_sample_syncs": self.host_sample_syncs,
                "traffic.host_sampled_edges": self.host_sampled_edges,
            }
        for name, v in scalars.items():
            reg.counter(name).set_total(int(v))
        for name, m in (("traffic.feat_bytes", bm),
                        ("traffic.topo_bytes", tm)):
            dev = m[:, :-1]
            reg.counter(name, tier="local").set_total(int(np.trace(dev)))
            reg.counter(name, tier="peer").set_total(
                int(dev.sum() - np.trace(dev)))
            reg.counter(name, tier="pcie").set_total(int(m[:, -1].sum()))
            for dst, src in zip(*np.nonzero(m)):
                src_lbl = "host" if src == self.n_devices else int(src)
                reg.counter(f"{name}_pair", dst=int(dst),
                            src=src_lbl).set_total(int(m[dst, src]))


class CliqueCache:
    """One clique's unified cache."""

    TOPOLOGY_MODES = ("sharded", "replicated")

    def __init__(self, g: CSRGraph, devices: Sequence[int],
                 feat_ids_per_dev: Sequence[np.ndarray],
                 topo_ids_per_dev: Sequence[np.ndarray],
                 materialize: bool = True,
                 topology_mode: str = "sharded"):
        if topology_mode not in self.TOPOLOGY_MODES:
            raise ValueError(f"unknown topology_mode {topology_mode!r} "
                             f"(expected one of {self.TOPOLOGY_MODES})")
        self.g = g
        self.devices = list(devices)
        # "sharded" (default): each device holds only the CSR rows the plan
        # assigned to it, and sampling routes each frontier row to its
        # owner shard.  "replicated": every device holds the whole union.
        self.topology_mode = topology_mode
        # ---- feature cache ----
        self.feat_pos = np.full(g.n, -1, dtype=np.int64)
        owners = []
        all_ids = []
        for gi, ids in enumerate(feat_ids_per_dev):
            all_ids.append(ids)
            owners.append(np.full(len(ids), gi, dtype=np.int32))
        ids = np.concatenate(all_ids) if all_ids else np.zeros(0, np.int64)
        self.feat_ids = ids.astype(np.int64)
        self.feat_owner = (np.concatenate(owners) if owners
                           else np.zeros(0, np.int32))
        self.feat_pos[self.feat_ids] = np.arange(len(self.feat_ids))
        self._materialized = materialize
        if materialize:
            self.feat_cache = (g.get_features(self.feat_ids)
                               if len(self.feat_ids)
                               else np.zeros((0, g.feat_dim), np.float32))
        else:
            self.feat_cache = None
        # ---- topology cache (CSR subset) ----
        self._build_topology(topo_ids_per_dev)
        # device residency is double-buffered across refresh epochs: the
        # previous epoch's arrays stay alive until the epoch after next so
        # in-flight batch specs keep gathering from the buffer they indexed
        self.epoch = 0
        self.device: Optional[torch.device] = None  # fixed at first upload
        # the sharded form's binding: shard gi on shard_devices[gi], fixed
        # at its first upload
        self.shard_devices: Optional[Tuple[torch.device, ...]] = None
        self._device_arrays = None
        self._prev_device_arrays = None
        self._sharded_arrays = None
        self._prev_sharded_arrays = None
        self._shard_routing = None
        self._prev_epoch = -1
        # guards the lazy uploads: several builders may race the first
        # spec build
        self._mat_lock = threading.RLock()

    @staticmethod
    def _subset_csr(g: CSRGraph, tids: np.ndarray):
        """CSR subset for ``tids``: (indptr, indices) with row ``r`` holding
        ``tids[r]``'s full adjacency in host order (the bit-parity anchor:
        any sampler drawing ``r % deg`` offsets against it reproduces
        ``host_sample_level`` exactly)."""
        deg = (g.indptr[tids + 1] - g.indptr[tids]) if len(tids) \
            else np.zeros(0, np.int64)
        indptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int64)
        if len(tids):
            # vectorized adjacency copy: slot k of the subset CSR maps to
            # g.indices[g.indptr[tids[row]] + (k - indptr[row])]
            starts = g.indptr[tids]
            total = int(indptr[-1])
            src = (np.arange(total, dtype=np.int64)
                   - np.repeat(indptr[:-1], deg)
                   + np.repeat(starts, deg))
            indices = g.indices[src].astype(np.int32)
        else:
            indices = np.zeros(0, np.int32)
        return indptr, indices

    def _build_topology(self, topo_ids_per_dev: Sequence[np.ndarray]) -> None:
        """Build the topology cache from per-device id lists.

        Always builds the *union* CSR subset (``topo_pos`` / ``cache_indptr``
        / ``cache_indices``) — the host mirror every fallback resolve and
        accounting pass reads, and the replicated layout's device residency.
        In sharded mode additionally builds the per-device shard form: the
        vertex->owner routing tables (``topo_owner`` / ``topo_local``) and
        the padded per-shard CSR stacks (``topo_shard_indptr`` (k_g, R+1),
        ``topo_shard_indices`` (k_g, E)).  Each shard stores its vertices'
        adjacency in host order, so shard sampling is bit-identical to the
        union CSR."""
        g = self.g
        per_dev = [np.asarray(t).astype(np.int64) for t in topo_ids_per_dev]
        tids = (np.concatenate(per_dev) if per_dev
                else np.zeros(0, np.int64))
        self.topo_ids = tids
        self.topo_ids_per_dev = per_dev
        self.topo_pos = np.full(g.n, -1, dtype=np.int64)
        self.topo_pos[tids] = np.arange(len(tids))
        deg = (g.indptr[tids + 1] - g.indptr[tids]) if len(tids) \
            else np.zeros(0, np.int64)
        self.cache_indptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int64)
        self.cache_indices = (self._subset_csr(g, tids)[1]
                              if self._materialized else None)
        self.topo_owner = None
        self.topo_local = None
        self.topo_shard_indptr = None
        self.topo_shard_indices = None
        if self.topology_mode != "sharded":
            return
        # vertex -> (owner shard, row within it); later lists win on
        # duplicate ids, matching the union's topo_pos assignment order
        self.topo_owner = np.full(g.n, -1, dtype=np.int32)
        self.topo_local = np.zeros(g.n, dtype=np.int64)
        for gi, ids in enumerate(per_dev):
            self.topo_owner[ids] = gi
            self.topo_local[ids] = np.arange(len(ids))
        if not self._materialized:
            return
        k_g = max(len(self.devices), 1)
        shard_csrs = [self._subset_csr(g, ids) for ids in per_dev]
        shard_csrs += [self._subset_csr(g, np.zeros(0, np.int64))
                       for _ in range(k_g - len(shard_csrs))]
        R = max(len(p) - 1 for p, _ in shard_csrs)
        E = max(max(len(ix) for _, ix in shard_csrs), 1)
        self.topo_shard_indptr = np.zeros((k_g, R + 1), dtype=np.int64)
        self.topo_shard_indices = np.zeros((k_g, E), dtype=np.int32)
        for gi, (p, ix) in enumerate(shard_csrs):
            self.topo_shard_indptr[gi, :len(p)] = p
            self.topo_shard_indptr[gi, len(p):] = p[-1]  # pad rows: deg 0
            self.topo_shard_indices[gi, :len(ix)] = ix

    # ---- device residency ----
    @staticmethod
    def _lane_padded(D: int) -> int:
        """Feature columns padded to the 128-column boundary (only when
        feat_dim exceeds one 128-column tile) — the reference package's
        table width, kept so both packages stage and gather identical
        shapes."""
        return D if not (D > 128 and D % 128) else D + 128 - D % 128

    def _epoch_view(self, current, prev, epoch: Optional[int], what: str):
        """Double-buffered epoch pinning: ``epoch`` selects the current or
        the single retained previous buffer; anything older raises."""
        if epoch is None or epoch == self.epoch:
            return current
        if epoch == self._prev_epoch and prev is not None:
            return prev
        raise RuntimeError(
            f"cache epoch {epoch} is no longer resident{what} (current "
            f"{self.epoch}, retained {self._prev_epoch}); refresh_interval "
            "must be larger than the prefetch depth")

    def device_arrays(self, epoch: Optional[int] = None, device=None):
        """The device-resident cache halves as torch tensors (uploaded once,
        lazily).

        ``device`` fixes where they live on the first call (default
        ``"cuda"``, which raises without a card; tests pass ``"cpu"``);
        later calls may omit it, and naming another device raises.
        ``feat_cache`` columns are padded once to the 128-column boundary
        (only when feat_dim exceeds 128), so the per-batch gather never
        re-pads the whole table; consumers slice back to ``g.feat_dim``.

        ``epoch`` pins a refresh generation: batch specs built before a
        cache refresh finalize against the buffer they indexed (the double
        buffer retains exactly one previous epoch)."""
        if self._device_arrays is None:
            with self._mat_lock:
                if self._device_arrays is None:
                    dev = resolve_device("cuda" if device is None else device)
                    fc = self.feat_cache
                    D = fc.shape[1]
                    Dp = self._lane_padded(D)
                    if Dp != D:
                        fc = np.pad(fc, ((0, 0), (0, Dp - D)))
                    # torch.tensor always copies: on the CPU
                    # torch.from_numpy would alias the host mirrors, which
                    # a refresh mutates in place
                    arrays = {
                        "feat_cache": torch.tensor(fc, device=dev),
                        "feat_pos": torch.tensor(self.feat_pos, device=dev),
                    }
                    arrays.update(self._topology_arrays(dev))
                    self.device = dev
                    self._device_arrays = arrays
        if device is not None and resolve_device(device) != self.device:
            raise ValueError(f"cache arrays live on {self.device}, not "
                             f"{device}")
        return self._epoch_view(self._device_arrays,
                                self._prev_device_arrays, epoch, "")

    def _topology_arrays(self, dev: torch.device) -> dict:
        """The topology half of the device residency, uploaded to ``dev``:
        the union CSR subset and, in sharded mode, the routing tables and
        per-shard CSR stacks.  ``replace_topology`` swaps these wholesale
        (never in place)."""
        arrays = {k: torch.tensor(getattr(self, k), device=dev)
                  for k in ("cache_indptr", "cache_indices", "topo_pos")}
        if self.topo_owner is not None and self.topo_shard_indptr is not None:
            for k in _SHARD_TOPO_KEYS:
                arrays[k] = torch.tensor(getattr(self, k), device=dev)
        return arrays

    # ---- per-device shard views (the sharded clique executor) ----
    def shard_routing(self):
        """Ownership routing tables for the sharded executor: two int32
        arrays over global feature-cache slots, ``owner[s]`` (clique-local
        index of the device whose shard holds slot ``s``) and
        ``local_slot[s]`` (the row of that slot within the owner's shard).
        With ``split_hits`` this routes a batch's cached ids: requester ==
        owner is a local hit, requester != owner an intra-clique peer
        exchange, pos < 0 a host fill.

        Slots freed by an online refresh keep their last routing entry;
        no vertex maps to them any more, so it is never consulted.
        Memoized (invariant between refreshes, read once per spec-build
        epoch); ``apply_feature_delta`` invalidates."""
        if self._shard_routing is None:
            with self._mat_lock:
                if self._shard_routing is None:
                    owner = self.feat_owner.astype(np.int32)
                    local = np.zeros(len(owner), dtype=np.int32)
                    for gi in range(len(self.devices)):
                        sel = np.flatnonzero(owner == gi)
                        local[sel] = np.arange(len(sel), dtype=np.int32)
                    self._shard_routing = (owner, local)
        return self._shard_routing

    def shard_row_count(self) -> int:
        """Rows of the largest per-device shard (all shards pad to this)."""
        if len(self.feat_owner) == 0:
            return 0
        return int(np.bincount(self.feat_owner,
                               minlength=len(self.devices)).max())

    def resolve_shard_devices(self, devices) -> Tuple[torch.device, ...]:
        """``devices`` (one device for every shard, or one per clique
        position; default ``"cuda"``) as K_g ``torch.device``s."""
        k_g = len(self.devices)
        if devices is None or isinstance(devices, (str, torch.device)):
            devices = ["cuda" if devices is None else devices] * k_g
        devs = tuple(resolve_device(d) for d in devices)
        if len(devs) != k_g:
            raise ValueError(f"{len(devs)} devices bound to the {k_g} shards "
                             "of one clique")
        return devs

    def sharded_device_arrays(self, epoch: Optional[int] = None,
                              devices=None):
        """The cache's *partitioned* device residency, one entry per clique
        position ``gi`` (clique-local device ``gi``), each its own
        allocation on the card bound to that position:

        * ``feat_shards``: K_g tensors ``(R, D_padded)``, shard ``gi`` on
          ``devices[gi]``; row ``local_slot[s]`` of shard ``owner[s]`` is
          global slot ``s`` (every shard pads to the clique's largest R);
        * ``slot_owner``, ``slot_local``: the routing tables, a copy on
          every card of the clique (entry ``gi`` on ``devices[gi]``);
        * in sharded topology mode, ``topo_owner``/``topo_local`` (a copy
          per card, as the routing) and the per-shard CSR
          ``topo_shard_indptr`` (K_g of (R+1,) int64) and
          ``topo_shard_indices`` (K_g of (E,) int32), shard ``gi`` on
          ``devices[gi]``.

        ``devices``: one device for every shard, or one per position;
        default ``"cuda"``, which raises without a card.  It fixes the
        binding on the first call (which also uploads the flat arrays of
        ``device_arrays`` on ``devices[0]``, the refresh's scatter target);
        later calls may omit it, and another binding raises.  Each position
        reads its own shard and its peers' through their base pointers
        (``kernels.gather.routed_gather``).  Same double-buffered epoch
        pinning as ``device_arrays``: specs built before a refresh
        finalize against the shards they indexed, which the retained epoch
        keeps alive."""
        if self._sharded_arrays is None:
            with self._mat_lock:
                if self._sharded_arrays is None:
                    if self.feat_cache is None:
                        raise RuntimeError(
                            "sharded_device_arrays needs a materialized "
                            "cache (build the plan with "
                            "materialize_caches=True)")
                    devs = (self.resolve_shard_devices(devices)
                            if self.shard_devices is None
                            else self.shard_devices)
                    self.device_arrays(device=devs[0])
                    owner, local = self.shard_routing()
                    R = self.shard_row_count()
                    fc = self.feat_cache
                    D = fc.shape[1]
                    Dp = self._lane_padded(D)
                    shards = np.zeros((len(devs), R, Dp), dtype=np.float32)
                    if len(owner):
                        shards[owner, local, :D] = fc
                    # copies (torch.tensor always copies): owner/local
                    # derive from feat_owner, which a refresh mutates in
                    # place
                    arrays = {"feat_shards": tuple(
                        torch.tensor(shards[gi], device=d)
                        for gi, d in enumerate(devs))}
                    arrays["slot_owner"] = _per_card(owner, devs)
                    arrays["slot_local"] = _per_card(local, devs)
                    arrays.update(self._sharded_topology(devs))
                    self.shard_devices = devs
                    self._sharded_arrays = arrays
        if devices is not None \
                and self.resolve_shard_devices(devices) != self.shard_devices:
            raise ValueError(f"cache shards live on "
                             f"{[str(d) for d in self.shard_devices]}, not "
                             f"{devices}")
        return self._epoch_view(self._sharded_arrays,
                                self._prev_sharded_arrays, epoch,
                                " in sharded form")

    def _sharded_topology(self, devs) -> dict:
        """The sharded topology layout bound to ``devs``: the routing tables
        copied to every card, CSR shard ``gi`` uploaded to ``devs[gi]`` (its
        own allocation); nothing outside sharded mode."""
        if self.topo_owner is None or self.topo_shard_indptr is None:
            return {}
        out = {k: _per_card(getattr(self, k), devs)
               for k in ("topo_owner", "topo_local")}
        for k in ("topo_shard_indptr", "topo_shard_indices"):
            stack = getattr(self, k)
            out[k] = tuple(torch.tensor(stack[gi], device=d)
                           for gi, d in enumerate(devs))
        return out

    def _position_topology(self, position: Optional[int]) -> tuple:
        """The topology a sampling chain reads: (device, indptr shards,
        indices shards, topo_owner, topo_local).  ``position=None`` is the
        flat residency on ``self.device`` (the device backend: the stacked
        CSR's rows); a clique position reads the sharded form, its routing
        copy on its own card and the CSR shards wherever they lie."""
        if position is None:
            da = self.device_arrays()
            return (self.device, da["topo_shard_indptr"].unbind(0),
                    da["topo_shard_indices"].unbind(0), da["topo_owner"],
                    da["topo_local"])
        sa = self._sharded_arrays
        if sa is None:
            sa = self.sharded_device_arrays()
        return (self.shard_devices[position], sa["topo_shard_indptr"],
                sa["topo_shard_indices"], sa["topo_owner"][position],
                sa["topo_local"][position])

    # ---- online refresh (cache manager API) ----
    def begin_epoch(self) -> int:
        """Rotate the device double buffers (flat and sharded): the current
        arrays become the retained previous epoch; subsequent mutations
        build the new one.  Returns the new epoch id.  Before the first
        upload there is nothing to retain, and the rotation only bumps the
        epoch id."""
        self._prev_device_arrays = self._device_arrays
        self._prev_sharded_arrays = self._sharded_arrays
        had_any = (self._device_arrays is not None
                   or self._sharded_arrays is not None)
        self._prev_epoch = self.epoch if had_any else -1
        self.epoch += 1
        return self.epoch

    def apply_feature_delta(self, evict_ids: np.ndarray,
                            admit_ids: np.ndarray,
                            admit_owner: np.ndarray,
                            admit_rows: Optional[np.ndarray] = None) -> dict:
        """Evict ``evict_ids`` from the feature cache and write the admitted
        rows into the freed slots (slot reuse: the capacity never changes).

        admit_owner: per admitted id, the owning device's *clique-local*
        index.  admit_rows defaults to a host fetch of the admitted ids.  If
        fewer slots are free than ids admitted, the admission list is
        truncated; surplus free slots stay empty (-1 in ``feat_ids``).

        Device side (once uploaded): ``kernels.scatter.scatter_rows`` writes
        the admitted rows into a *new* table, so the previous epoch's buffer
        stays untouched for in-flight batches, and ``feat_pos`` is uploaded
        anew as a copy.  With nothing admitted the new epoch shares the old
        table and nothing launches.  Call ``begin_epoch`` first.

        Returns {"evicted": n, "admitted": n, "bytes_h2d": host->device
        admission traffic}.
        """
        evict_ids = np.asarray(evict_ids, dtype=np.int64)
        admit_ids = np.asarray(admit_ids, dtype=np.int64)
        slots = self.feat_pos[evict_ids]
        if (slots < 0).any():
            raise ValueError("apply_feature_delta: evict_ids contain "
                             "vertices that are not cached")
        self.feat_pos[evict_ids] = -1
        self.feat_ids[slots] = -1
        # reuse every empty slot (just-freed + leftovers of past refreshes)
        free = np.flatnonzero(self.feat_ids < 0)
        n_admit = min(len(admit_ids), len(free))
        admit_ids = admit_ids[:n_admit]
        admit_owner = np.asarray(admit_owner, dtype=np.int32)[:n_admit]
        use = free[:n_admit]
        # host-side slot maps
        self.feat_pos[admit_ids] = use
        self.feat_ids[use] = admit_ids
        self.feat_owner[use] = admit_owner
        if admit_rows is None:
            admit_rows = (self.g.get_features(admit_ids) if n_admit
                          else np.zeros((0, self.g.feat_dim), np.float32))
        admit_rows = np.asarray(admit_rows, dtype=np.float32)[:n_admit]
        if self.feat_cache is not None and n_admit:
            self.feat_cache[use] = admit_rows
        # device side: double-buffered scatter into the freed slots, on the
        # cache device's current stream (ordered before any later gather)
        if self._device_arrays is not None:
            dev = self.device
            old = self._device_arrays
            table = old["feat_cache"]
            Dp = table.shape[1]
            rows = admit_rows
            if rows.shape[0] and Dp != rows.shape[1]:
                rows = np.pad(rows, ((0, 0), (0, Dp - rows.shape[1])))
            new = dict(old)
            with device_context(dev):
                new["feat_cache"] = scatter.scatter_rows(
                    table, torch.tensor(use, dtype=torch.int32, device=dev),
                    torch.tensor(rows, device=dev))
                # a copy: the host mirror mutates in place
                new["feat_pos"] = torch.tensor(self.feat_pos, device=dev)
            self._device_arrays = new
        # partitioned view: the routing changed, so drop the memo and, if
        # the shards were uploaded, rebuild them *here*, on the refresh
        # thread (serialized with spec builds), on the same cards, so
        # consumers only ever see epoch-pinned shards.  begin_epoch kept
        # the previous epoch's.
        self._shard_routing = None
        if self._sharded_arrays is not None:
            self._sharded_arrays = None
            self.sharded_device_arrays()
        return {"evicted": int(len(evict_ids)), "admitted": int(n_admit),
                "bytes_h2d": int(n_admit) * self.g.feat_dim * S_FLOAT32}

    def replace_topology(self, topo_ids_per_dev: Sequence[np.ndarray]) -> None:
        """Swap the topology half of the cache for a new planned id set.

        Topology is read only while specs are sampled (serialized with
        refreshes), never at finalize, so the rebuilt arrays need no epoch
        retention: they replace the topology entries of the *current*
        epoch's dict, and the retained epoch keeps its old ones."""
        self._build_topology(topo_ids_per_dev)
        if self._device_arrays is not None:
            new = dict(self._device_arrays)
            # drop stale shard entries first: a refresh may flip the
            # per-shard stack shapes, or empty a stack
            for k in _SHARD_TOPO_KEYS:
                new.pop(k, None)
            with device_context(self.device):
                new.update(self._topology_arrays(self.device))
            self._device_arrays = new
        if self._sharded_arrays is not None:
            new = {k: v for k, v in self._sharded_arrays.items()
                   if k not in _SHARD_TOPO_KEYS}
            new.update(self._sharded_topology(self.shard_devices))
            self._sharded_arrays = new

    def feat_ids_by_device(self) -> List[np.ndarray]:
        """Current per-device cached feature ids (clique-local order), the
        cache manager's view of residency for delta planning.  Empty slots
        (evicted, not yet re-admitted) are skipped."""
        live = self.feat_ids >= 0
        return [self.feat_ids[live & (self.feat_owner == gi)]
                for gi in range(len(self.devices))]

    def device_sample_cached(self, seeds, fanout: int, rand,
                             position: Optional[int] = None) -> tuple:
        """Fixed-fanout neighbor sampling *on the device* from the
        device-resident topology cache (Legion's GPU sampling).

        Seeds whose adjacency is cached sample from the cache CSR; misses
        (uncached or negative/padded seeds) return -1 rows for the host
        pipeline to fill (and account as PCIe).  ``rand`` is the host
        sampler's (B, fanout) draw, replayed exactly, so the device path
        produces bit-identical subgraphs.

        In sharded topology mode each row routes through its owner shard's
        padded CSR (the single-process form of the routed neighbor
        exchange); every shard stores its vertices' adjacency in host
        order, so the outputs are bit-identical to the replicated layout
        and to the host sampler.  That lookup is the routed neighbor
        exchange, ``kernels.gather.routed_neighbor_sample``: its CUDA kernel
        on a card, its plain version on the CPU.  ``seeds`` may be a numpy
        array or a device tensor (the chained sampler's previous hop).
        ``position`` (a clique position of the sharded executor) samples
        on that position's card from the sharded form
        (``sharded_device_arrays``); ``None`` on ``self.device`` from the
        flat residency.
        Every index of the replicated path is clamped into range before it
        is used: a CUDA gather asserts on an out-of-range index where XLA
        would clamp.
        Returns (neighbors (B, fanout) int32, hit_mask (B,) bool), both on
        the sampling device.
        """
        # upload before any early return: the first call happens at
        # spec-build time, serialized with refreshes.  Every topology array
        # below comes from this one snapshot (replace_topology swaps the
        # dict whole), never from the live attributes
        da = self.device_arrays()
        sharded = self.topology_mode == "sharded"
        if sharded:
            dev, ip, ix, topo_owner, topo_local = \
                self._position_topology(position)
        else:
            dev = self.device
        seeds = torch.as_tensor(seeds, device=dev).to(torch.int64)
        n_idx = int(da["cache_indices"].shape[0])
        if n_idx == 0:
            # empty topology cache: every row is a host fill
            return (torch.full(tuple(seeds.shape) + (fanout,), -1,
                               dtype=torch.int32, device=dev),
                    torch.zeros(seeds.shape, dtype=torch.bool, device=dev))
        valid = seeds >= 0
        safe_seed = torch.where(valid, seeds, 0)
        r = torch.as_tensor(np.asarray(rand, dtype=np.int64), device=dev)
        if sharded:
            # the owner is -1 for an invalid seed as for an uncached one
            owner = torch.where(valid, topo_owner[safe_seed], -1)
            local = topo_local[safe_seed].to(torch.int32)
            out = gather.routed_neighbor_sample(ip, ix, owner, local, r)
            return out, owner >= 0
        else:
            pos = da["topo_pos"][safe_seed]
            hit = (pos >= 0) & valid
            safe = pos.clamp_min(0)
            start = da["cache_indptr"][safe]
            deg = da["cache_indptr"][safe + 1] - start
            offs = r % deg.clamp_min(1)[:, None]
            idx = (start[:, None] + offs).clamp_max(max(n_idx - 1, 0))
            out = da["cache_indices"][idx]
        ok = hit & (deg > 0)
        return torch.where(ok[:, None], out.to(torch.int32), -1), hit

    def device_sample_chain(self, seeds, fanouts: Sequence[int],
                            rands: Sequence[np.ndarray],
                            position: Optional[int] = None):
        """Enqueue every hop's device half back-to-back — *no host sync*.

        Hop ``k`` samples directly from hop ``k-1``'s device output, so the
        whole multi-hop chain is queued before any result is read back (one
        sync per batch instead of one per hop).  A frontier row whose
        parent was a topology miss carries ``-1`` on the device, so the
        child row comes back as a miss too; the caller's single resolve
        pass (``graph.sampling.cache_sample_dispatch``) re-samples exactly
        those rows with the same ``rands`` draws, which keeps the composed
        levels bit-identical to the host sampler.

        ``rands[k]`` must be the hop-``k`` draw of shape
        ``(len(flattened frontier_k), fanouts[k])``.  Returns two lists of
        device tensors: per-hop neighbors (flat, fanout) and per-hop
        device-hit masks.

        In sharded topology mode the whole chain is one call of
        ``kernels.gather.routed_neighbor_sample_chain`` (one kernel launch
        on a card, routing included): the seeds and every hop's draws go
        up in one pinned, non-blocking copy, and the results are views of
        one packed buffer, which ``graph.sampling`` reads back with one
        copy.  ``position`` runs it on that clique position's card against
        the sharded form, as ``device_sample_cached``.  The replicated mode
        samples hop by hop.
        """
        if self.topology_mode == "sharded":
            return self._sharded_chain(seeds, fanouts, rands, position)
        outs, hits = [], []
        frontier = np.asarray(seeds)
        for f, r in zip(fanouts, rands):
            out, hit = self.device_sample_cached(frontier, f, rand=r,
                                                 position=position)
            outs.append(out)
            hits.append(hit)
            frontier = out.reshape(-1)
        return outs, hits

    def _sharded_chain(self, seeds, fanouts: Sequence[int],
                       rands: Sequence[np.ndarray],
                       position: Optional[int] = None):
        """``device_sample_chain`` of a sharded topology cache: one upload
        of the seeds and draws, one chain kernel, on ``position``'s card
        (``_position_topology``)."""
        dev, ip, ix, topo_owner, topo_local = \
            self._position_topology(position)
        seeds = np.asarray(seeds, dtype=np.int64).reshape(-1)
        n = len(seeds)
        parts = [seeds]
        for k, (f, r) in enumerate(zip(fanouts, rands)):
            r = np.asarray(r, dtype=np.int64)
            if r.shape != (n, f):
                raise ValueError(f"rands[{k}] must be ({n}, {f}), got "
                                 f"{r.shape}")
            parts.append(r.reshape(-1))
            n *= f
        host = torch.empty(sum(len(p) for p in parts), dtype=torch.int64,
                           pin_memory=dev.type == "cuda")
        bounds = np.cumsum([0] + [len(p) for p in parts])
        for p, a, b in zip(parts, bounds, bounds[1:]):
            host[a:b].copy_(torch.from_numpy(p))  # torch's threaded copy
        with device_context(dev):
            up = host.to(dev, non_blocking=True)
            views = [up[a:b] for a, b in zip(bounds, bounds[1:])]
            draws = [v.view(-1, f) for v, f in zip(views[1:], fanouts)]
            return gather.routed_neighbor_sample_chain(
                ip, ix, topo_owner, topo_local, views[0], draws)

    # ---- accounting + extraction ----
    def split_hits(self, ids: np.ndarray):
        """Hit/miss split of a unique-vertex request against the feature
        cache: returns (pos, hit) where ``pos[i]`` is the cache slot for
        ``ids[i]`` (-1 on miss) and ``hit = pos >= 0``.  This is the only
        sanctioned way for batch backends to read cache placement."""
        ids = np.asarray(ids, dtype=np.int64)
        pos = self.feat_pos[ids]
        return pos, pos >= 0

    def account_feature_gather(self, pos: np.ndarray, hit: np.ndarray,
                               requester_dev: int,
                               counter: TrafficCounter) -> None:
        """Traffic accounting for one feature gather, shared by the host and
        device batch backends (identical counts by construction).  Hits are
        charged to their owning device's column (physical device ids index
        the matrix directly), misses to the CPU/PCIe column."""
        n_miss = int((~hit).sum())
        row_bytes = self.g.feat_dim * S_FLOAT32
        tx_per_row = int(np.ceil(row_bytes / CLS))
        if hit.any() and max(self.devices) >= counter.n_devices:
            raise ValueError(
                f"TrafficCounter(n_devices={counter.n_devices}) cannot "
                f"index clique devices {self.devices}; size it from the "
                "plan (TrafficCounter.for_plan / for_devices)")
        with counter.lock:
            counter.feature_requests += len(pos)
            counter.feature_hits += int(hit.sum())
            counter.pcie_transactions += tx_per_row * n_miss
            counter.bytes_matrix[requester_dev, -1] += row_bytes * n_miss
            if hit.any():
                owners = self.feat_owner[pos[hit]]
                cnt = np.bincount(owners, minlength=len(self.devices))
                np.add.at(counter.bytes_matrix[requester_dev],
                          np.asarray(self.devices), row_bytes * cnt)

    def extract_features(self, ids: np.ndarray, requester_dev: int,
                         counter: Optional[TrafficCounter] = None,
                         store=None, step: Optional[int] = None) -> np.ndarray:
        """Gather rows for `ids` (unique sampled vertices of one batch) from
        the host mirror, accounting hits (local/peer) and misses (CPU over
        PCIe).

        ``store`` routes the misses through a tiered
        :class:`~repro_torch.core.feature_store.FeatureStore` (host-RAM
        cache over a file-resident table) instead of the direct
        ``g.get_features`` fill; ``step`` keys the store's lookahead and
        prefetch state.  Rows are bitwise identical either way."""
        ids = np.asarray(ids, dtype=np.int64)
        pos, hit = self.split_hits(ids)
        out = np.empty((len(ids), self.g.feat_dim), dtype=np.float32)
        if hit.any():
            out[hit] = self.feat_cache[pos[hit]]
        if (~hit).any():
            miss_ids = ids[~hit]
            out[~hit] = (store.gather(miss_ids, step=step, dev=requester_dev)
                         if store is not None
                         else self.g.get_features(miss_ids))
        if store is not None:
            store.record_hbm(len(ids), int(hit.sum()))
        if counter is not None:
            self.account_feature_gather(pos, hit, requester_dev, counter)
        return out

    def sample_accounting(self, srcs: np.ndarray, fanout: int,
                          counter: TrafficCounter, requester_dev: int):
        """Account one sampling level: adjacency reads of `srcs` hit the topo
        cache or cost PCIe transactions (Eq. 3/4 granularity).

        The legacy counters (requests/hits/pcie/bytes_matrix) are mode-
        independent by construction: the sharded and replicated layouts
        cache the *same* vertex set, so the hit split is identical.  The
        topology-specific exchange traffic lands in ``topo_bytes_matrix``:
        each hit delivers its ``fanout`` sampled neighbor ids from the
        owner shard (a peer column under sharded mode, the requester's own
        diagonal under replicated), and each miss adds ``fanout`` edges to
        ``host_sampled_edges``."""
        srcs = np.asarray(srcs, dtype=np.int64)
        srcs = srcs[srcs >= 0]
        pos = self.topo_pos[srcs]
        hit = pos >= 0
        miss = srcs[~hit]
        tx = n_bytes = 0
        if len(miss):
            deg = self.g.indptr[miss + 1] - self.g.indptr[miss]
            tx = int((np.ceil(deg * S_UINT32 / CLS).astype(np.int64) + 1).sum())
            n_bytes = int((deg * S_UINT32).sum())
        hb = fanout * S_UINT32
        with counter.lock:
            counter.topo_requests += len(srcs)
            counter.topo_hits += int(hit.sum())
            counter.pcie_transactions += tx
            counter.bytes_matrix[requester_dev, -1] += n_bytes
            counter.host_sampled_edges += fanout * len(miss)
            counter.topo_bytes_matrix[requester_dev, -1] += n_bytes
            if hit.any():
                if self.topology_mode == "sharded":
                    owners = self.topo_owner[srcs[hit]]
                    cnt = np.bincount(owners, minlength=len(self.devices))
                    np.add.at(counter.topo_bytes_matrix[requester_dev],
                              np.asarray(self.devices), hb * cnt)
                else:
                    counter.topo_bytes_matrix[
                        requester_dev, requester_dev] += hb * int(hit.sum())


    def publish_metrics(self, reg, clique: int = 0) -> None:
        """Residency gauges for the telemetry registry (repro_torch.obs):
        cached feature/topology rows and the refresh epoch, labeled per
        clique.  Pulled at snapshot boundaries only."""
        reg.gauge("cache.feat_rows", clique=clique).set(len(self.feat_ids))
        reg.gauge("cache.topo_rows", clique=clique).set(len(self.topo_ids))
        reg.gauge("cache.epoch", clique=clique).set(self.epoch)


def plan_cache_contents(g: CSRGraph, k_g: int, cslp_res, cost_plan: dict,
                        mem_per_device: float, topology_mode: str = "sharded"):
    """Fill per-device queues until the planned per-device budgets (§4.2 S3).
    Returns (feat_ids_per_dev, topo_ids_per_dev) — the *target* residency
    sets.

    ``topology_mode`` controls how the per-device topology byte budget
    ``bt`` is spent.  Under ``"sharded"`` each device fills its own CSLP
    queue ``G_T[gi]`` to ``bt`` (the per-device lists are disjoint, so the
    clique's *union* caches ~k_g x bt of topology).  Under ``"replicated"``
    every device must hold the same union, so the union itself is capped
    at ``bt``: the globally hottest vertices (``Q_T`` order) up to ``bt``
    bytes, split back into per-device lists by CSLP ownership purely for
    bookkeeping."""
    alpha = cost_plan["m_T"] / max(cost_plan["m_T"] + cost_plan["m_F"], 1)
    if topology_mode not in CliqueCache.TOPOLOGY_MODES:
        raise ValueError(f"unknown topology_mode {topology_mode!r}; "
                         f"expected one of {CliqueCache.TOPOLOGY_MODES}")
    bt = mem_per_device * alpha
    bf = mem_per_device * (1 - alpha)
    keep = None
    if topology_mode == "replicated":
        q = np.asarray(cslp_res.Q_T)
        b = np.cumsum(g.topology_bytes(q)) if len(q) else np.zeros(0)
        keep = np.zeros(g.n, dtype=bool)
        keep[q[: int(np.searchsorted(b, bt, side="right"))]] = True
    feat_ids, topo_ids = [], []
    for gi in range(k_g):
        # topology: fill G_T[gi] until bt bytes (sharded), or take this
        # device's slice of the bt-byte union (replicated)
        q = np.asarray(cslp_res.G_T[gi])
        if keep is not None:
            topo_ids.append(q[keep[q]] if len(q) else q)
        else:
            b = np.cumsum(g.topology_bytes(q)) if len(q) else np.zeros(0)
            topo_ids.append(q[: int(np.searchsorted(b, bt, side="right"))])
        # features: fixed row size
        q = cslp_res.G_F[gi]
        nrows = int(bf // g.feature_bytes_per_vertex())
        feat_ids.append(q[:nrows])
    return feat_ids, topo_ids


def build_clique_cache(g: CSRGraph, devices, cslp_res, cost_plan: dict,
                       mem_per_device: float, materialize: bool = True,
                       topology_mode: str = "sharded") -> CliqueCache:
    feat_ids, topo_ids = plan_cache_contents(g, len(devices), cslp_res,
                                             cost_plan, mem_per_device,
                                             topology_mode=topology_mode)
    return CliqueCache(g, devices, feat_ids, topo_ids, materialize=materialize,
                       topology_mode=topology_mode)
