"""Fixed-fanout neighbor sampling (GraphSAGE-style, 2-hop 25x10 default).

* ``host_sample_batch`` — vectorized numpy over the host CSR; drives
  pre-sampling and the host side of the batch pipeline.
* ``cache_sample_batch`` — the cache-aware sampler: topology-cache hits
  sample on the GPU from the device-resident cache CSR
  (``CliqueCache.device_sample_cached``), and only the miss rows fall back
  to the host CSR.

Both sample uniformly *with replacement* (the paper's uniform random
neighbor sampling); zero-degree vertices yield -1 padding.  Every path
consumes the same host draws, so the composed levels are bit-identical to
``host_sample_batch`` for an identically-seeded generator.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.graph.csr import CSRGraph


def host_sample_level(g: CSRGraph, seeds: np.ndarray, fanout: int,
                      rng: np.random.Generator,
                      rand: np.ndarray = None) -> np.ndarray:
    """(B,) seeds -> (B, fanout) sampled neighbors (-1 where deg==0).
    seeds < 0 propagate -1.  ``rand`` (B, fanout) overrides the draws so a
    caller can replay the exact level (the cache-aware sampler reuses one
    draw for its device and host halves)."""
    seeds = np.asarray(seeds, dtype=np.int64)
    valid = seeds >= 0
    sv = np.where(valid, seeds, 0)
    start = g.indptr[sv]
    deg = g.indptr[sv + 1] - start
    r = rng.integers(0, 1 << 31, size=(len(seeds), fanout)) \
        if rand is None else rand
    has = (deg > 0) & valid
    offs = r % np.maximum(deg, 1)[:, None]
    idx = start[:, None] + offs
    out = g.indices[np.minimum(idx, g.nnz - 1)].astype(np.int64)
    out = np.where(has[:, None], out, -1)
    return out


def host_sample_batch(g: CSRGraph, seeds: np.ndarray, fanouts: Sequence[int],
                      rng: np.random.Generator) -> List[np.ndarray]:
    """Multi-hop sample: returns [seeds (B,), hop1 (B,f1), hop2 (B,f1,f2), ...]."""
    levels = [np.asarray(seeds, dtype=np.int64)]
    frontier = levels[0]
    shape = (len(frontier),)
    for f in fanouts:
        nxt = host_sample_level(g, frontier.reshape(-1), f, rng)
        shape = shape + (f,)
        levels.append(nxt.reshape(shape))
        frontier = levels[-1]
    return levels


def cache_sample_level(g: CSRGraph, cache, seeds: np.ndarray, fanout: int,
                       rng: np.random.Generator, position=None
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """One sampling level through the unified cache: topology-cache hits
    sample on the device from the cache CSR; only the miss rows fall back
    to the host CSR.  Both halves consume the same random draw, and the
    cache CSR stores adjacency in host order, so the composed level is
    bit-identical to ``host_sample_level``.  ``position`` (a clique
    position of the sharded executor) samples on that position's card.

    Returns (neighbors (B, fanout) int64, topo_hit_mask (B,) bool).
    """
    seeds = np.asarray(seeds, dtype=np.int64)
    r = rng.integers(0, 1 << 31, size=(len(seeds), fanout))
    dev_out, hit = cache.device_sample_cached(seeds, fanout, rand=r,
                                              position=position)
    out, hit = _to_host([dev_out], [hit])
    out, hit = out[0].astype(np.int64), hit[0]
    if (~hit).any():
        out[~hit] = host_sample_level(g, seeds[~hit], fanout, rng,
                                      rand=r[~hit])
    return out, hit


def _to_host(outs: Sequence[torch.Tensor], hits: Sequence[torch.Tensor]):
    """Read every hop's device result back with ONE device-to-host copy.

    The sharded chain's results are views of one packed buffer
    (``kernels.gather.routed_neighbor_sample_chain``): that buffer is
    copied as it is and viewed on the host.  Otherwise the hops are packed into a single int32
    tensor on the device, copied once, and split on the host."""
    tensors = list(outs) + list(hits)
    if tensors and len({t.untyped_storage().data_ptr()
                        for t in tensors}) == 1 \
            and all(t.is_contiguous() for t in tensors) \
            and all(o.dtype == torch.int32 for o in outs) \
            and all(h.dtype == torch.bool for h in hits):
        whole = torch.empty(0, dtype=torch.uint8, device=tensors[0].device)
        flat = whole.set_(tensors[0].untyped_storage()).cpu().numpy()
        res = []
        for t in tensors:
            off = t.storage_offset() * t.element_size()
            part = flat[off:off + t.numel() * t.element_size()]
            res.append(part.view(np.int32 if t.dtype == torch.int32
                                 else np.bool_).reshape(tuple(t.shape)))
        return res[:len(outs)], res[len(outs):]
    parts = [o.reshape(-1) for o in outs] + [h.reshape(-1).to(torch.int32)
                                             for h in hits]
    flat = torch.cat(parts).cpu().numpy() if parts else np.zeros(0, np.int32)
    res, off = [], 0
    for t in list(outs) + list(hits):
        n = t.numel()
        res.append(flat[off:off + n].reshape(tuple(t.shape)))
        off += n
    k = len(outs)
    return res[:k], [h.astype(bool) for h in res[k:]]


def _mirror_sample_level(cache, seeds: np.ndarray, fanout: int,
                         rand: np.ndarray) -> np.ndarray:
    """Replay one level's draws against the *host mirror* of the topology
    cache (the union CSR ``topo_pos``/``cache_indptr``/``cache_indices``).
    Every cached vertex's adjacency is stored in host order, so for cached
    non-negative ``seeds`` this is bit-identical to ``host_sample_level``
    — without touching the host CSR (it is the stale-parent repair path of
    the chained sampler, not a host fallback)."""
    seeds = np.asarray(seeds, dtype=np.int64)
    pos = cache.topo_pos[seeds]
    start = cache.cache_indptr[pos]
    deg = cache.cache_indptr[pos + 1] - start
    offs = rand % np.maximum(deg, 1)[:, None]
    idx = np.minimum(start[:, None] + offs,
                     max(len(cache.cache_indices) - 1, 0))
    out = cache.cache_indices[idx].astype(np.int64)
    return np.where((deg > 0)[:, None], out, -1)


def cache_sample_dispatch(g: CSRGraph, cache, seeds: np.ndarray,
                          fanouts: Sequence[int], rng: np.random.Generator,
                          position=None):
    """Phase 1 of the chained cache-aware sampler: draw every hop's
    randomness in host-sampler order and enqueue the whole device chain
    (``CliqueCache.device_sample_chain``) *without reading anything back*.

    Returns a ``resolve(counter=None)`` closure that pays the single host
    sync (one device-to-host copy for every hop) and finishes the batch;
    the builder can run unrelated host work (label fetch) between dispatch
    and resolve so the chain's device time overlaps it.  The resolve pass
    repairs rows the device could not serve, cheapest source first:

    * negative sources (deg-0 parents / padding) are ``-1`` rows by
      definition — no CSR of any kind is consulted;
    * cached sources whose *parent* was host-filled (the device saw ``-1``
      where the host later wrote a cached id) replay their draws against
      the cache's host mirror — a topology *hit*, repaired off-device only
      because the value arrived after the chain was enqueued;
    * only genuinely uncached sources fall back to the host CSR, batched
      into one vectorized ``host_sample_level`` call per hop.

    All three replay the exact draws the device half consumed, so the
    composed levels stay bit-identical to ``host_sample_batch``.
    ``counter`` (a ``TrafficCounter``) gets ``host_sample_syncs += 1`` iff
    the batch touched the host CSR at all.  ``position`` (a clique
    position of the sharded executor) runs the chain on that position's
    card.
    """
    seeds = np.asarray(seeds, dtype=np.int64)
    rands = []
    n_flat = len(seeds)
    for f in fanouts:
        rands.append(rng.integers(0, 1 << 31, size=(n_flat, f)))
        n_flat *= f
    dev_outs, dev_hits = cache.device_sample_chain(seeds, fanouts, rands,
                                                   position=position)

    def resolve(counter=None):
        levels = [seeds]
        hits: List[np.ndarray] = []
        frontier = seeds
        shape = (len(frontier),)
        outs, dhits = _to_host(dev_outs, dev_hits)  # one sync for the chain
        mirror_ok = cache.cache_indices is not None
        ok = np.ones(len(frontier), dtype=bool)
        touched_host = False
        for k, f in enumerate(fanouts):
            flat = frontier.reshape(-1)
            resolved = dhits[k] & ok
            out = outs[k].astype(np.int64)
            need = np.flatnonzero(~resolved)
            if len(need):
                src = flat[need]
                neg = src < 0
                out[need[neg]] = -1
                live = need[~neg]
                if len(live):
                    cached = (cache.topo_pos[flat[live]] >= 0) if mirror_ok \
                        else np.zeros(len(live), dtype=bool)
                    fix = live[cached]
                    if len(fix):
                        out[fix] = _mirror_sample_level(cache, flat[fix], f,
                                                        rands[k][fix])
                        resolved[fix] = True
                    host = live[~cached]
                    if len(host):
                        touched_host = True
                        out[host] = host_sample_level(g, flat[host], f, rng,
                                                      rand=rands[k][host])
            hits.append(resolved)
            shape = shape + (f,)
            levels.append(out.reshape(shape))
            frontier = levels[-1]
            ok = np.repeat(resolved, f)
        if counter is not None and touched_host:
            with counter.lock:
                counter.host_sample_syncs += 1
        return levels, hits

    return resolve


def cache_sample_batch(g: CSRGraph, cache, seeds: np.ndarray,
                       fanouts: Sequence[int], rng: np.random.Generator,
                       chain: bool = True, counter=None, position=None
                       ) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """Cache-aware multi-hop sample (device backend of the batch pipeline).

    Same contract as ``host_sample_batch`` plus per-level topology-hit
    masks (flattened frontier order).  With an identically-seeded ``rng``
    the returned levels are bit-identical to the host sampler's.

    ``chain=True`` (default) enqueues all hops' device halves back-to-back
    and pays a *single* host sync per batch (see ``cache_sample_dispatch``).
    ``chain=False`` is the per-hop path (one device sync per hop via
    ``cache_sample_level``), the reference the chained path is tested
    against.  ``counter`` tallies ``host_sample_syncs`` — one per batch
    whose resolution touched the host CSR, either path.  ``position`` as
    for ``cache_sample_dispatch``.
    """
    if chain:
        return cache_sample_dispatch(g, cache, seeds, fanouts, rng,
                                     position=position)(counter=counter)
    levels = [np.asarray(seeds, dtype=np.int64)]
    hits: List[np.ndarray] = []
    frontier = levels[0]
    shape = (len(frontier),)
    touched_host = False
    for f in fanouts:
        flat = frontier.reshape(-1)
        nxt, hit = cache_sample_level(g, cache, flat, f, rng,
                                      position=position)
        touched_host |= bool((~hit & (flat >= 0)).any())
        hits.append(hit)
        shape = shape + (f,)
        levels.append(nxt.reshape(shape))
        frontier = levels[-1]
    if counter is not None and touched_host:
        with counter.lock:
            counter.host_sample_syncs += 1
    return levels, hits


def unique_vertices(levels: List[np.ndarray]) -> np.ndarray:
    """All distinct non-negative vertex ids appearing in a sampled subgraph."""
    flat = np.concatenate([l.reshape(-1) for l in levels])
    flat = flat[flat >= 0]
    return np.unique(flat)
