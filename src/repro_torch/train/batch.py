"""Batch builders: the host/device split of Legion's per-step pipeline.

One batch is produced in two phases with a hard boundary between them:

  sample_spec() / fill_spec()   host: seed sampling, hit/miss split,
                                miss-row fetch (straight off the graph,
                                or through the tiered feature store),
                                traffic accounting.
                                Produces a backend-agnostic ``BatchSpec``
                                (numpy, plus a pinned staging tensor).
  finalize()                    turns a spec into the torch tensors the
                                model consumes, on the builder's device.

Two interchangeable backends (paper §4.2/§5 vs the classic CPU pipeline)::

    HostBatchBuilder                     DeviceBatchBuilder
    ----------------                     ------------------
    sample: host CSR (numpy)             sample: device topology cache (all
                                           hops queued back-to-back, one
                                           sync); host fills only the
                                           topo-miss rows
    gather: numpy rows, hits from        gather: one fused kernel launch
      the host copy of the cache           (kernels/fused_batch.py): cache
                                           gather + miss overlay, then
                                           per-level positioning/masking
                                           (``fused=False``: the gather
                                           kernel, then a separate overlay)
    finalize: one host->device copy      finalize: staged miss upload +
      per batch tensor                     fused gather on the device

Both backends draw identical randomness (the device sampler replays the
host generator's draws) and share one accounting implementation
(``CliqueCache.account_feature_gather`` / ``sample_accounting``), so for a
given seed they produce bit-identical batches and identical hit/miss
counts — and both equal the reference package's builders bit for bit.

Stable shapes: the device spec's per-id layout is **bucket-rounded** —
``ids``/``cache_pos``/``hit``/``miss_inv`` pad to the next multiple of
``bucket`` (default 256), and miss rows stage into a bucket-rounded pinned
staging buffer reused across batches (padded to the cache table's width).
Padded tail entries are inert (ids/cache_pos/miss_inv = -1, hit = False)
and are never referenced by any level position.

A third backend, ``ShardedBatchBuilder`` (``backend="sharded"``), keeps the
device backend's host phase (and so its specs and accounting) and adds
per-id ownership routing, so the hierarchical executor can finalize every
clique jointly: local hits gather from the requester's own cache shard,
peer hits from a peer's shard of the same clique, and only true misses are
host-filled.  ``pack_sharded_specs`` stacks the per-clique spec groups into
the ``(K_c, K_g, ...)`` arrays of the ``(pod, clique)`` mesh.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.unified_cache import CliqueCache, TrafficCounter
from repro_torch.graph.csr import CSRGraph
from repro_torch.graph.sampling import (cache_sample_batch,
                                        cache_sample_dispatch,
                                        host_sample_batch, unique_vertices)
from repro_torch.kernels import fused_batch, gather
from repro_torch.obs import maybe_span
from repro_torch.utils import device_context, resolve_device

BACKENDS = ("host", "device", "sharded")

DEFAULT_BUCKET = 256  # id/miss shape quantum of the device spec layout


def _round_bucket(n: int, bucket: int) -> int:
    """Smallest positive multiple of ``bucket`` holding ``n`` rows."""
    return max(-(-n // bucket), 1) * bucket


@dataclasses.dataclass
class BatchSpec:
    """Backend-agnostic description of one sampled mini-batch.

    Device specs use the bucket-rounded layout (see module doc):
    ``ids``/``cache_pos``/``hit``/``miss_inv`` have length
    ``_round_bucket(n_ids, bucket)`` with inert padding (-1 / False), and
    ``miss_feats`` is a bucket-rounded staging tensor on the host (pinned
    when the builder's device is a GPU) whose first ``n_miss`` rows are
    real (width may exceed the graph's feature dim — it is padded to the
    cache table's device width).  Host specs are unpadded
    (``n_ids == len(ids)``)."""
    labels: np.ndarray                  # (B,) int32
    levels: List[np.ndarray]            # padded level id tensors, -1 = pad
    ids: np.ndarray                     # unique vertex ids (pad rows = -1)
    level_pos: List[np.ndarray]         # per-level position into ``ids``
    # host backend: fully materialized feature rows for ``ids``
    host_feats: Optional[np.ndarray] = None
    # device backend: hit/miss split + host-staged miss rows
    cache_pos: Optional[np.ndarray] = None   # feat-cache slot per id (-1 miss)
    hit: Optional[np.ndarray] = None         # (n_pad,) bool (pad rows False)
    miss_feats: Optional[torch.Tensor] = None  # (m_pad, >=D) f32 staging
    # row i's source row in miss_feats (-1 = cached or padding)
    miss_inv: Optional[np.ndarray] = None
    n_ids: int = 0                      # true unique-id count (<= len(ids))
    n_miss: int = 0                     # true miss count (<= len(miss_feats))
    # cache refresh epoch this spec's slots index into: finalize gathers
    # from the matching (possibly previous) device buffer
    cache_epoch: int = 0
    # sharded backend: ownership routing per id — clique-local owning
    # device and row within the owner's shard (-1 on miss), read off
    # CliqueCache.shard_routing at spec-build time
    owner: Optional[np.ndarray] = None
    local_slot: Optional[np.ndarray] = None


class _StagingPool:
    """Reusable host-side miss staging buffers, keyed by (rows, width).

    Buffers are page-locked (pinned) when the target device is a GPU, so
    the upload can run as a true asynchronous copy.  The consumer releases
    a buffer only after its device copy *completed* (finalize waits on the
    copy's CUDA event first): a buffer recycled mid-transfer would feed the
    in-flight batch rows from the *next* batch.  Thread-safe: specs fill on
    one thread and finalize on another.

    Buffers are never freed: ``buffers``/``bytes`` count what the pool has
    allocated so far and ``alloc_s`` the host time those allocations took.
    """

    def __init__(self, pin: bool):
        self._pin = pin
        self._free: Dict[Tuple[int, int], deque] = {}
        self._lock = threading.Lock()
        self.buffers = 0
        self.bytes = 0
        self.alloc_s = 0.0

    def acquire(self, rows: int, width: int) -> torch.Tensor:
        with self._lock:
            q = self._free.setdefault((rows, width), deque())
            if q:
                return q.pop()
        t0 = time.perf_counter()
        buf = torch.zeros((rows, width), dtype=torch.float32,
                          pin_memory=self._pin)
        with self._lock:
            self.buffers += 1
            self.bytes += rows * width * 4
            self.alloc_s += time.perf_counter() - t0
        return buf

    def release(self, buf: Optional[torch.Tensor]) -> None:
        if buf is not None:
            with self._lock:
                self._free.setdefault(tuple(buf.shape), deque()).append(buf)


def _level_positions(ids: np.ndarray, levels: List[np.ndarray]) -> List[np.ndarray]:
    out = []
    for lvl in levels:
        pos = np.searchsorted(ids, np.maximum(lvl, 0))
        out.append(np.clip(pos, 0, max(len(ids) - 1, 0)))
    return out


def _position_and_mask(feats: torch.Tensor, levels: List[np.ndarray],
                       level_pos: List[np.ndarray], labels: np.ndarray,
                       device: torch.device) -> Dict[str, torch.Tensor]:
    """Per-level positioning and pad masking of the gathered unique-vertex
    block: ``feats_l = feats[pos_l] * (level_l >= 0)``, plus the masks and
    labels, all on ``device``."""
    D = feats.shape[1]
    out = {"labels": torch.from_numpy(labels).to(device)}
    for li, (lvl, pos) in enumerate(zip(levels, level_pos)):
        p = torch.from_numpy(pos.reshape(-1).astype(np.int64)).to(device)
        v = torch.from_numpy(lvl >= 0).to(device)
        f = feats.index_select(0, p).reshape(tuple(lvl.shape) + (D,))
        out[f"feats_{li}"] = f * v[..., None].to(f.dtype)
        if li > 0:
            out[f"mask_{li}"] = v
    return out


class BatchBuilder:
    """Samples and extracts one device's mini-batches (see module doc).

    ``device`` is where finalized batches live (default ``"cuda"``, which
    raises without a card; pass ``"cpu"`` to run on the CPU).  ``observer``
    (``OnlineCacheManager.observer_for``) is fed every sampled batch's
    level tensors; it only records, so attaching one changes neither
    batches nor accounting.  ``fill_s`` totals the host time of
    ``fill_spec``.

    Two taps are attached by the train loop or the server after
    construction: ``telemetry`` (a ``repro_torch.obs.Telemetry``: finalize
    and staging spans) and ``store`` (a
    ``repro_torch.core.feature_store.FeatureStore``: the miss rows come
    through its host-RAM and file tiers instead of ``g.get_features``).
    Neither changes a batch: the store's rows are bitwise the graph's."""

    backend: str = "?"

    def __init__(self, g: CSRGraph, cache: Optional[CliqueCache],
                 fanouts: Sequence[int],
                 counter: Optional[TrafficCounter] = None, dev: int = 0,
                 *, device="cuda", observer=None):
        self.g = g
        self.cache = cache
        self.fanouts = tuple(fanouts)
        self.counter = counter
        self.dev = dev
        self.device = resolve_device(device)
        self.observer = observer
        self.fill_s = 0.0
        # telemetry tap: a shared no-op context while None
        self.telemetry = None
        # tiered feature store tap: misses fill through it when set
        self.store = None

    # -- phase 1: host ---------------------------------------------------
    # sample_spec() draws this step's randomness and samples the batch (all
    # RNG consumption happens here, in step order); fill_spec() splits
    # against the device cache at the *current* epoch and fetches the miss
    # rows (RNG-free, so the store's lookahead window may run it several
    # sample_spec calls later).  ``step`` keys the store's lookahead and
    # prefetch state.
    def sample_spec(self, seeds: np.ndarray,
                    rng: np.random.Generator) -> BatchSpec:
        raise NotImplementedError

    def fill_spec(self, spec: BatchSpec,
                  step: Optional[int] = None) -> BatchSpec:
        raise NotImplementedError

    def store_request_ids(self, spec: BatchSpec) -> np.ndarray:
        """The ids ``fill_spec`` will request from the tiered store — the
        sampled uniques minus the *current* device-cached set.  Read-only
        (no accounting, no epoch pin): it feeds the store's lookahead
        announce/prefetch hints, which stay hints — an online refresh
        between announce and fill only degrades eviction quality, never
        correctness."""
        ids = spec.ids[:spec.n_ids]
        if self.cache is None or len(self.cache.feat_ids) == 0:
            return ids
        _, hit = self.cache.split_hits(ids)
        return ids[~hit]

    def build_spec(self, seeds: np.ndarray,
                   rng: np.random.Generator) -> BatchSpec:
        return self.fill_spec(self.sample_spec(seeds, rng))

    # -- phase 2: consumer -----------------------------------------------
    def finalize(self, spec: BatchSpec) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    def release_spec(self, spec: BatchSpec) -> None:
        """Return a spec's pooled resources without finalizing it."""

    def staging_stats(self) -> dict:
        """What the miss-staging pool has allocated: buffers, bytes, and
        the host seconds the allocations took (none on the host backend)."""
        return {"buffers": 0, "bytes": 0, "alloc_s": 0.0}

    def build(self, seeds: np.ndarray, rng: np.random.Generator) -> Dict:
        """Convenience: both phases back to back (benchmarks, tests)."""
        return self.finalize(self.build_spec(seeds, rng))

    def _account_sampling(self, levels: List[np.ndarray]) -> None:
        if self.observer is not None:
            self.observer.record(levels, self.fanouts)
        if self.counter is not None and self.cache is not None:
            for lvl, f in zip(levels[:-1], self.fanouts):
                self.cache.sample_accounting(lvl.reshape(-1), f,
                                             self.counter, self.dev)


class HostBatchBuilder(BatchBuilder):
    """The classic CPU pipeline: everything numpy, then one host->device
    copy per batch tensor."""

    backend = "host"

    def sample_spec(self, seeds, rng):
        levels = host_sample_batch(self.g, seeds, self.fanouts, rng)
        if self.counter is not None:
            # every host build samples from the host CSR by construction
            with self.counter.lock:
                self.counter.host_sample_syncs += 1
        self._account_sampling(levels)
        ids = unique_vertices(levels)
        return BatchSpec(labels=self.g.get_labels(seeds), levels=levels,
                         ids=ids, level_pos=_level_positions(ids, levels),
                         n_ids=len(ids))

    def fill_spec(self, spec, step=None):
        t0 = time.perf_counter()
        ids = spec.ids
        if self.cache is not None:
            spec.host_feats = self.cache.extract_features(
                ids, self.dev, self.counter, store=self.store, step=step)
        elif self.store is not None:
            spec.host_feats = self.store.gather(ids, step=step, dev=self.dev)
        else:
            spec.host_feats = self.g.get_features(ids)
        self.fill_s += time.perf_counter() - t0
        return spec

    @staticmethod
    def assemble(spec: BatchSpec) -> Dict[str, np.ndarray]:
        """Spec -> padded numpy batch (the pre-copy host representation)."""
        batch = {"labels": spec.labels}
        for li, (lvl, pos) in enumerate(zip(spec.levels, spec.level_pos)):
            f = spec.host_feats[pos]
            f[lvl < 0] = 0.0
            batch[f"feats_{li}"] = f
            if li > 0:
                batch[f"mask_{li}"] = lvl >= 0
        return batch

    def finalize(self, spec):
        with maybe_span(self.telemetry, "finalize", dev=self.dev):
            return {k: torch.from_numpy(np.ascontiguousarray(v)).to(
                        self.device)
                    for k, v in self.assemble(spec).items()}


class DeviceBatchBuilder(BatchBuilder):
    """Device-resident pipeline: sampling and feature gather run against the
    device-resident unified cache; the host only fills misses.

    The cached-row gather is ``fused_batch.fused_gather_overlay``, or with
    ``fused=False`` the reference's unfused chain (``gather.gather_rows``,
    then the miss rows overlaid by a separate copy, at exact per-batch
    shapes; kept as a second parity oracle).  On a GPU each launches its
    hand-written Hopper kernel, on the CPU the wrapper runs its plain
    version (the device of the tensors decides).

    ``bucket`` sets the shape quantum of the spec layout (see module doc).
    ``sampler="stepwise"`` samples hop by hop (one sampling launch and one
    sync per hop, ``cache_sample_batch(chain=False)``) instead of the whole
    chain in one launch: the per-hop parity oracle, bitwise the same specs.
    """

    backend = "device"

    def __init__(self, g, cache, fanouts, counter=None, dev=0, *,
                 device="cuda", observer=None, fused: bool = True,
                 bucket: int = DEFAULT_BUCKET, sampler: str = "chain"):
        if cache is None:
            raise ValueError("DeviceBatchBuilder needs a unified cache "
                             "(build a LegionPlan, or use HostBatchBuilder)")
        super().__init__(g, cache, fanouts, counter, dev, device=device,
                         observer=observer)
        if sampler not in ("chain", "stepwise"):
            raise ValueError(f"unknown sampler mode {sampler!r}")
        if bucket < 1:
            raise ValueError(f"bucket must be >= 1, got {bucket}")
        self.fused = fused
        self.bucket = int(bucket)
        self.sampler = sampler
        self._staging = _StagingPool(pin=self.device.type == "cuda")
        # the clique position whose card samples (the sharded builder's);
        # None samples from the flat residency on the cache's device
        self.position = None
        self._upload()

    def _upload(self) -> None:
        """Upload the cache's device half now, on the builder's device."""
        self.cache.device_arrays(device=self.device)

    def _staging_width(self) -> int:
        """Miss rows stage at the cache table's padded device width so the
        fused kernel sees one width for both sources (columns beyond
        feat_dim stay zero for the buffer's lifetime)."""
        return CliqueCache._lane_padded(self.g.feat_dim)

    def sample_spec(self, seeds, rng):
        # chain: queue the whole device chain, then fetch labels while it
        # is in flight; resolve() pays the single sync and repairs
        # stale-parent / host-miss rows (see cache_sample_dispatch).
        # stepwise: one hop and one sync at a time.  Specs are built on
        # prefetch threads: the current device and the grad mode are per
        # thread, so both are set here.
        with device_context(self.device), torch.no_grad():
            if self.sampler == "chain":
                resolve = cache_sample_dispatch(self.g, self.cache, seeds,
                                                self.fanouts, rng,
                                                position=self.position)
                labels = self.g.get_labels(seeds)
                levels, _topo_hits = resolve(counter=self.counter)
            else:
                levels, _topo_hits = cache_sample_batch(
                    self.g, self.cache, seeds, self.fanouts, rng,
                    chain=False, counter=self.counter,
                    position=self.position)
                labels = self.g.get_labels(seeds)
        self._account_sampling(levels)
        ids = unique_vertices(levels)
        return BatchSpec(labels=labels, levels=levels, ids=ids,
                         level_pos=_level_positions(ids, levels),
                         n_ids=len(ids))

    def fill_spec(self, spec, step=None):
        # the hit/miss split runs HERE, so the spec pins the *current*
        # cache epoch regardless of how far ahead it was sampled
        t0 = time.perf_counter()
        ids, n_ids = spec.ids, spec.n_ids
        cache_pos, hit = self.cache.split_hits(ids)
        if self.counter is not None:
            self.cache.account_feature_gather(cache_pos, hit, self.dev,
                                              self.counter)
        if self.store is not None:
            self.store.record_hbm(n_ids, int(hit.sum()))
        n_miss = int((~hit).sum())
        # bucket-rounded layout: pad rows are inert (-1 / False) and never
        # referenced by level_pos, so every downstream shape is stable
        n_pad = _round_bucket(n_ids, self.bucket)
        m_pad = _round_bucket(n_miss, self.bucket)
        ids_p = np.full(n_pad, -1, dtype=np.int64)
        ids_p[:n_ids] = ids
        pos_p = np.full(n_pad, -1, dtype=np.int64)
        pos_p[:n_ids] = cache_pos
        hit_p = np.zeros(n_pad, dtype=bool)
        hit_p[:n_ids] = hit
        miss_inv = np.full(n_pad, -1, dtype=np.int32)
        miss_inv[np.flatnonzero(~hit)] = np.arange(n_miss, dtype=np.int32)
        staging = self._staging.acquire(m_pad, self._staging_width())
        host = staging.numpy()  # shares the (pinned) buffer's memory
        D = self.g.feat_dim
        if n_miss:
            # one copy into the staging buffer, from the store's fresh f32
            # rows or straight off the graph
            miss_ids = ids[~hit]
            host[:n_miss, :D] = (
                self.store.gather(miss_ids, step=step, dev=self.dev)
                if self.store is not None else self.g.get_features(miss_ids))
        host[n_miss:, :D] = 0.0
        spec.ids = ids_p
        spec.cache_pos = pos_p
        spec.hit = hit_p
        spec.miss_feats = staging
        spec.miss_inv = miss_inv
        spec.n_miss = n_miss
        spec.cache_epoch = self.cache.epoch
        self.fill_s += time.perf_counter() - t0
        return spec

    def release_spec(self, spec):
        self._staging.release(spec.miss_feats)
        spec.miss_feats = None

    def staging_stats(self):
        p = self._staging
        return {"buffers": p.buffers, "bytes": p.bytes, "alloc_s": p.alloc_s}

    def _table(self, epoch: int) -> torch.Tensor:
        """The epoch-pinned device feature table; a (1, Dp) zero dummy when
        the plan cached nothing (every row then resolves as miss/pad)."""
        if len(self.cache.feat_ids) == 0:
            return torch.zeros((1, self._staging_width()),
                               dtype=torch.float32, device=self.device)
        return self.cache.device_arrays(epoch)["feat_cache"]

    def finalize(self, spec):
        if not self.fused:
            return self._finalize_unfused(spec)
        tele = self.telemetry
        dev = self.device
        with maybe_span(tele, "finalize", dev=self.dev):
            table = self._table(spec.cache_epoch)
            # the upload is ASYNC from pinned memory: it must complete
            # before the staging buffer goes back to the pool, or the next
            # fill overwrites it mid-read.  copy=True also keeps a CPU
            # "upload" from aliasing the pooled buffer.
            with maybe_span(tele, "h2d_staging", dev=self.dev,
                            rows=spec.n_miss):
                miss = spec.miss_feats.to(dev, non_blocking=True, copy=True)
                if dev.type == "cuda":
                    done = torch.cuda.Event()
                    done.record(torch.cuda.current_stream(dev))
                    done.synchronize()
            self.release_spec(spec)
            # -1 at miss AND pad rows
            idx = torch.from_numpy(spec.cache_pos.astype(np.int32)).to(dev)
            inv = torch.from_numpy(spec.miss_inv).to(dev)
            feats = fused_batch.fused_gather_overlay(table, idx, miss, inv)
            D = self.g.feat_dim
            if feats.shape[1] != D:
                feats = feats[:, :D]
            return _position_and_mask(feats, spec.levels, spec.level_pos,
                                      spec.labels, dev)

    # -- the unfused finalize chain: a second parity oracle ---------------
    def _gather_cached(self, idx: np.ndarray, epoch: int) -> torch.Tensor:
        """(n,) slot ids (-1 = miss) -> (n, D) rows, zeros at -1, from the
        table of cache epoch ``epoch``."""
        D = self.g.feat_dim
        if len(self.cache.feat_ids) == 0:
            return torch.zeros((len(idx), D), dtype=torch.float32,
                               device=self.device)
        table = self.cache.device_arrays(epoch)["feat_cache"]
        out = gather.gather_rows(
            table, torch.tensor(idx, dtype=torch.int32, device=self.device))
        return out[:, :D] if table.shape[1] != D else out

    def _finalize_unfused(self, spec):
        """The reference's unfused chain at exact (unpadded) shapes: the
        cached-row gather, the miss rows overlaid by an index copy, then
        per-level positioning and masking."""
        dev = self.device
        n, D = spec.n_ids, self.g.feat_dim
        with maybe_span(self.telemetry, "finalize", dev=self.dev):
            idx = np.where(spec.hit[:n], spec.cache_pos[:n], -1)
            feats = self._gather_cached(idx, spec.cache_epoch)
            miss_rows = np.flatnonzero(spec.miss_inv[:n] >= 0)
            if len(miss_rows):
                # a blocking copy: it has completed when it returns, so the
                # staging buffer may go back to the pool right after
                miss = spec.miss_feats[:spec.n_miss, :D].to(dev, copy=True)
                feats = feats.index_copy(
                    0, torch.from_numpy(miss_rows).to(dev), miss)
            self.release_spec(spec)
            return _position_and_mask(feats, spec.levels, spec.level_pos,
                                      spec.labels, dev)


class ShardedBatchBuilder(DeviceBatchBuilder):
    """Spec builder for the hierarchical (pod x clique) executor.

    The host phase is the device backend's (same sampler replay, same
    hit/miss split, same accounting: bit-identical specs), plus the
    ownership routing read off ``CliqueCache.shard_routing``: per cached
    id, which clique device's shard holds the row and at which local slot.
    It samples on its own position's card (``device``, the card the mesh
    binds to clique position ``cache.devices.index(dev)``), from the
    sharded residency: the routing copy on that card and the clique's CSR
    shards wherever they lie.  ``shard_devices`` binds the clique's
    positions (default: every one on ``device``, the one-card mesh).
    The routing and the shard upload are resolved **once per cache
    epoch**, not per spec: the first spec build of an epoch reads the
    routing and uploads the per-position shards on the build thread,
    serialized with refresh hooks, so the consumer only ever sees
    epoch-pinned buffers.  The *joint* finalize (routed gather across the
    clique, miss overlay, the gradient sum over the mesh) is the train
    loop's sharded step; ``pack_sharded_specs`` stacks the per-clique spec
    groups into the arrays it consumes.  ``finalize`` on this builder is
    the single-device gather from the flat residency (identical rows; it
    needs the builder on the cache's flat device, ``shard_devices[0]``)."""

    backend = "sharded"

    def __init__(self, *args, shard_devices=None, **kw):
        self._shard_devices = shard_devices
        super().__init__(*args, **kw)
        self._routing_epoch = -1
        self._routing = None

    def _upload(self) -> None:
        """Bind this builder to its clique position and upload the
        sharded residency on the clique's cards (the flat arrays go to the
        first position's card)."""
        cache = self.cache
        self.position = cache.devices.index(self.dev)
        self.shard_devices = cache.resolve_shard_devices(
            self.device if self._shard_devices is None
            else self._shard_devices)
        if self.shard_devices[self.position] != self.device:
            raise ValueError(
                f"device {self.dev} is clique position {self.position}, "
                f"bound to {self.shard_devices[self.position]}, but the "
                f"builder runs on {self.device}")
        cache.sharded_device_arrays(devices=self.shard_devices)

    def _routing_for_epoch(self):
        """Per-epoch memo of (owner, local_slot); re-derived only after an
        online refresh bumps ``cache.epoch``."""
        ep = self.cache.epoch
        if self._routing_epoch != ep:
            owner, local = self.cache.shard_routing()
            if len(owner):
                # upload the shards *here*, on the build thread
                # (serialized with refresh hooks), once per epoch
                with device_context(self.device):
                    self.cache.sharded_device_arrays(
                        devices=self.shard_devices)
            self._routing = (owner, local)
            self._routing_epoch = ep
        return self._routing

    def fill_spec(self, spec, step=None):
        spec = super().fill_spec(spec, step=step)
        owner, local = self._routing_for_epoch()
        if len(owner) == 0:  # empty feature cache: every id is a host fill
            spec.owner = np.full(len(spec.ids), -1, dtype=np.int32)
            spec.local_slot = np.zeros(len(spec.ids), dtype=np.int32)
            return spec
        safe = np.maximum(spec.cache_pos, 0)  # pads/misses route as -1
        spec.owner = np.where(spec.hit, owner[safe], -1).astype(np.int32)
        spec.local_slot = np.where(spec.hit, local[safe], -1).astype(np.int32)
        return spec


def pack_sharded_specs(spec_groups: Sequence[Sequence[BatchSpec]],
                       feat_dim: int,
                       bucket: int = DEFAULT_BUCKET) -> Dict[str, np.ndarray]:
    """Stack ``ShardedBatchBuilder`` specs — grouped per clique, one spec
    per clique device — into the arrays the hierarchical train step reads
    per ``(pod, clique)`` mesh position (leading axes = clique index,
    clique-local device).  A single-clique run is ``K_c == 1``.

    Unique-id counts differ per device, so ids pad to the bucket-rounded
    mesh-wide max.  Padded tail entries route as misses with zero fill
    rows and are never referenced by any level position.  Host numpy, the
    reference package's layout, bit for bit.  Returns::

        owner      (K_c, K_g, n_pad) int32   routing: owning clique-local
                                             device, -1 = miss/pad
        local      (K_c, K_g, n_pad) int32   row within the owner's shard
        miss_rows  (K_c, K_g, n_pad, D) f32  host-staged rows at miss slots
        labels     (K_c, K_g, B) int32
        pos_{l}    (K_c, K_g, prod(level_l shape)) int32  positions into ids
        valid_{l}  (K_c, K_g, *level_l shape) bool        lvl >= 0
        cache_epochs (K_c,) int64  per-clique refresh generation (uniform
                                   *within* each clique; cliques refresh
                                   independently, so rows may differ)
    """
    groups = [list(gr) for gr in spec_groups]
    if not groups or any(not gr for gr in groups):
        raise ValueError("pack_sharded_specs: need one non-empty spec "
                         "group per clique")
    k_gs = {len(gr) for gr in groups}
    if len(k_gs) != 1:
        raise ValueError(f"pack_sharded_specs: ragged spec groups "
                         f"{sorted(len(gr) for gr in groups)}; the "
                         "(pod, clique) mesh needs one uniform K_g")
    k_c, k_g = len(groups), k_gs.pop()
    epochs = np.zeros(k_c, dtype=np.int64)
    for ci, gr in enumerate(groups):
        eps = {s.cache_epoch for s in gr}
        if len(eps) != 1:
            raise ValueError(f"pack_sharded_specs: clique {ci} specs span "
                             f"cache epochs {sorted(eps)}; one synchronized "
                             "step must gather from one refresh generation "
                             "per clique")
        epochs[ci] = gr[0].cache_epoch
    flat = [s for gr in groups for s in gr]
    n_pad = max(max(len(s.ids) for s in flat), 1)
    n_pad = -(-n_pad // bucket) * bucket
    owner = np.full((k_c, k_g, n_pad), -1, dtype=np.int32)
    local = np.zeros((k_c, k_g, n_pad), dtype=np.int32)
    miss_rows = np.zeros((k_c, k_g, n_pad, feat_dim), dtype=np.float32)
    for ci, gr in enumerate(groups):
        for gi, s in enumerate(gr):
            n = len(s.owner)
            owner[ci, gi, :n] = s.owner
            local[ci, gi, :n] = np.maximum(s.local_slot, 0)
            mloc = np.flatnonzero(s.miss_inv >= 0) if s.miss_inv is not None \
                else np.zeros(0, np.int64)
            if len(mloc):
                miss_rows[ci, gi, mloc] = \
                    s.miss_feats.numpy()[:s.n_miss, :feat_dim]
    packed = {"owner": owner, "local": local, "miss_rows": miss_rows,
              "labels": np.stack([s.labels for s in flat]).reshape(
                  (k_c, k_g) + flat[0].labels.shape)}
    for li in range(len(flat[0].levels)):
        lvl_shape = flat[0].levels[li].shape
        packed[f"pos_{li}"] = np.stack(
            [s.level_pos[li].reshape(-1).astype(np.int32) for s in flat]
        ).reshape((k_c, k_g, -1))
        packed[f"valid_{li}"] = np.stack(
            [s.levels[li] >= 0 for s in flat]).reshape(
                (k_c, k_g) + lvl_shape)
    packed["cache_epochs"] = epochs
    return packed


def make_batch_builder(backend: str, g: CSRGraph,
                       cache: Optional[CliqueCache],
                       fanouts: Sequence[int],
                       counter: Optional[TrafficCounter] = None,
                       dev: int = 0, **kw) -> BatchBuilder:
    if backend == "host":
        return HostBatchBuilder(g, cache, fanouts, counter, dev, **kw)
    if backend == "device":
        return DeviceBatchBuilder(g, cache, fanouts, counter, dev, **kw)
    if backend == "sharded":
        return ShardedBatchBuilder(g, cache, fanouts, counter, dev, **kw)
    raise ValueError(f"unknown batch backend {backend!r} (expected one of "
                     f"{BACKENDS})")
