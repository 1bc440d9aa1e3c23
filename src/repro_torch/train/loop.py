"""End-to-end Legion GNN training on one GPU.

Per step (paper Figure 7's pipeline, host side on the Prefetcher's
threads):

  batch generator (local shuffle of each device's tablet)
  -> neighbor sampler (host CSR, or the device topology cache)
  -> feature extractor (host rows, or the device cache gather with the
     host filling only misses)
  -> graph constructor (padded level tensors + masks)

while the consumer thread runs the forward, backward and AdamW step of the
previous batch.  Several simulated devices train on one GPU: each consumes
its own tablet stream, and their batches concatenate into one step, which
is synchronous data parallelism with the gradients averaged.

``backend="sharded"`` is the hierarchical clique-parallel executor over the
2-D ``(pod, clique)`` mesh (``launch/mesh.py``), run in one process as the
reference runs it under one ``shard_map``: every mesh position is bound to
a device, holds its clique's cache partition, gathers its batch through
the routed gather (its own shard and its clique peers', never another
clique's), and runs its own forward and backward; the positions' gradient
sums combine in a fixed order before one AdamW update.

Device work is queued on the GPU's current (default) stream from three
threads: the Prefetcher's (device sampling, and the online refresh's
scatter), the build pool's, and the consumer's (finalize and the step).
One stream orders them; the consumer reads its step's loss once per step,
after the next batch's finalize is queued.

``telemetry=`` instruments the run (``repro_torch.obs``): spans on the
consumer, coordinator and build threads, windowed metric snapshots, a JSONL
stream and a Perfetto trace.  ``feature_store=`` routes every device-cache
miss through the tiered store (``core/feature_store.py``) with a lookahead
window of sampled-ahead batches (``train.pipeline.LookaheadWindow``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.cache_manager import OnlineCacheManager, RefreshConfig
from repro_torch.core.feature_store import FeatureStore
from repro_torch.core.planner import LegionPlan
from repro_torch.core.unified_cache import (TrafficCounter,
                                           stack_hierarchical_shards)
from repro_torch.graph.csr import CSRGraph
from repro_torch.kernels import gather
from repro_torch.launch.mesh import HierarchicalMesh, make_hierarchical_mesh
from repro_torch.models.gnn import GNNConfig, defs as gnn_defs
from repro_torch.models.gnn import forward as gnn_forward
from repro_torch.models.gnn import loss_fn as gnn_loss
from repro_torch.models.params import init_from_defs
from repro_torch.obs import Telemetry, maybe_span
from repro_torch.train.batch import make_batch_builder, pack_sharded_specs
from repro_torch.train.optimizer import (adamw, apply_updates, tree_leaves,
                                         tree_map)
from repro_torch.train.pipeline import (LookaheadWindow, Prefetcher,
                                        StragglerMonitor)
from repro_torch.utils import device_context, resolve_device

# options of the reference's train_gnn that this package does not run yet,
# with the ROADMAP item that brings each
_NOT_PORTED = {
    "checkpoint_dir": "resilience (checkpoint and resume)",
    "resume": "resilience (checkpoint and resume)",
    "mesh": "gradient compression (an explicit data-parallel mesh)",
    "compress_grads": "gradient compression",
    "resilience": "resilience",
}


@dataclasses.dataclass
class GNNTrainResult:
    losses: List[float]
    accs: List[float]
    epoch_times: List[float]
    counter: TrafficCounter
    straggler: dict
    steps: int
    backend: str = "host"
    pipeline: dict = dataclasses.field(default_factory=dict)
    refresh: dict = dataclasses.field(default_factory=dict)
    # sampling-path digest (from the shared TrafficCounter): how much
    # neighbor sampling ran on the device vs fell back to the host CSR
    sampling: dict = dataclasses.field(default_factory=dict)
    # host wall time of every step (dispatch, the next batch's finalize and
    # the wait on this step's loss)
    step_times: List[float] = dataclasses.field(default_factory=list)
    # telemetry digest (repro_torch.obs): sink paths + span/snapshot counts
    # when train_gnn ran with telemetry, {} otherwise
    telemetry: dict = dataclasses.field(default_factory=dict)
    # tiered feature store digest (FeatureStore.summary()): per-tier
    # hit/fill/eviction tallies when train_gnn ran with one, {} otherwise
    store: dict = dataclasses.field(default_factory=dict)


def _make_train_step(cfg: GNNConfig, opt):
    """One step: forward and loss, gradients by autograd through plain
    torch ops (the reference's kernels have no backward either), then the
    AdamW update.  Functional: returns new parameter tensors."""

    def step(params, opt_state, batch):
        params = tree_map(lambda p: p.detach().requires_grad_(), params)
        loss, metrics = gnn_loss(cfg, params, batch)
        grads = torch.autograd.grad(loss, tree_leaves(params))
        it = iter(grads)
        grads = tree_map(lambda _: next(it), params)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = apply_updates(params, updates)
        return params, opt_state, loss.detach(), metrics["acc"]

    return step


def sharded_position_batch(shard: torch.Tensor, packed: dict, ci: int,
                           gi: int, feat_dim: int) -> dict:
    """The batch of mesh position ``(ci, gi)``: its clique's shard stack
    ``shard`` (K_g, R, Dp) gathered by the position's routing
    (``kernels.gather.routed_gather``: local hits from its own shard, peer
    hits from its clique peers'), the host-staged miss rows added, then
    per-level positioning and pad masking.  ``packed`` holds the
    ``pack_sharded_specs`` arrays as tensors on the position's device.
    The add stays outside the kernel, as in the reference; it also turns a
    -0.0 in a cached row into +0.0, as the reference's psum does."""
    D = feat_dim
    miss = packed["miss_rows"][ci, gi]
    if shard.shape[1] == 0:  # empty cache: every row is a host fill
        feats = miss
    else:
        feats = gather.routed_gather(shard, packed["owner"][ci, gi],
                                     packed["local"][ci, gi])
        feats = feats[:, :D] + miss
    batch = {"labels": packed["labels"][ci, gi]}
    li = 0
    while f"pos_{li}" in packed:
        valid = packed[f"valid_{li}"][ci, gi]
        f = feats.index_select(0, packed[f"pos_{li}"][ci, gi]).reshape(
            tuple(valid.shape) + (D,))
        batch[f"feats_{li}"] = f * valid[..., None].to(f.dtype)
        if li > 0:
            batch[f"mask_{li}"] = valid
        li += 1
    return batch


def _sum_loss(cfg: GNNConfig, params, batch):
    """Summed (not averaged) cross-entropy and correct count of one mesh
    position, normalized by the mesh-wide batch after the combine."""
    logits = gnn_forward(cfg, params, batch).to(torch.float32)
    labels = batch["labels"].to(torch.int64)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[:, None])[:, 0]
    acc = (logits.argmax(-1) == labels).to(torch.float32).sum()
    return (lse - ll).sum(), acc


def _make_sharded_step(cfg: GNNConfig, opt, mesh: HierarchicalMesh,
                       n_total: int, feat_dim: int):
    """The hierarchical (clique-parallel x data-parallel) train step over
    the ``(pod, clique)`` mesh, the reference's ``shard_map`` body written
    out as a loop.  For each position ``(ci, gi)`` in clique-major order,
    on its device: the routed gather from clique ``ci``'s shard stack (no
    feature row crosses a clique), the forward, and the gradients of the
    position's *summed* loss.  The gradients, losses and correct counts
    are summed over the positions in that fixed order and divided by the
    mesh-wide batch ``n_total``, so the math is the single-device mean over
    the concatenated batch, and a rerun is bitwise identical; then one
    AdamW update."""

    def step(params, opt_state, shards, packed):
        params = tree_map(lambda p: p.detach().requires_grad_(), params)
        leaves = tree_leaves(params)
        grad_sum, loss_sum, acc_sum = None, None, None
        for ci, gi in mesh.positions():
            with device_context(mesh.device(ci, gi)):
                batch = sharded_position_batch(shards[ci], packed, ci, gi,
                                               feat_dim)
                loss, acc = _sum_loss(cfg, params, batch)
                grads = torch.autograd.grad(loss, leaves)
            if grad_sum is None:
                grad_sum, loss_sum, acc_sum = list(grads), loss.detach(), acc
            else:
                grad_sum = [a + b for a, b in zip(grad_sum, grads)]
                loss_sum = loss_sum + loss.detach()
                acc_sum = acc_sum + acc
        it = iter([g / n_total for g in grad_sum])
        grads = tree_map(lambda _: next(it), params)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = apply_updates(params, updates)
        return params, opt_state, loss_sum / n_total, acc_sum / n_total

    return step


def train_gnn(g: CSRGraph, plan: Optional[LegionPlan], cfg: GNNConfig, *,
              steps: int = 100, devices: Optional[Sequence[int]] = None,
              seed: int = 0, counter: Optional[TrafficCounter] = None,
              device="cuda", params=None,
              prefetch_depth: int = 2,
              prefetch_workers: Optional[int] = None,
              shuffle: str = "local", backend: str = "host",
              fused: bool = True, bucket: int = 256, sampler: str = "chain",
              refresh_interval: Optional[int] = None,
              refresh_config: Optional[RefreshConfig] = None,
              telemetry=None, feature_store=None,
              lookahead: Optional[int] = None,
              **not_ported) -> GNNTrainResult:
    """Train SAGE/GCN with the Legion pipeline (see module doc).
    ``shuffle='global'`` ignores tablets and draws seeds from the full
    training set.

    ``backend``: ``"host"`` is the classic CPU pipeline; ``"device"``
    samples and gathers against the device-resident unified cache with the
    host filling only misses (``fused=False`` runs the unfused finalize
    chain, ``bucket`` is the spec layout's shape quantum).  Both draw the
    same randomness and produce bitwise-equal batches.  ``"sharded"`` is
    the hierarchical clique executor (see module doc): ``devices`` must
    cover whole cliques of equal size (the default, every plan device, runs
    the full hierarchy; one clique is the ``K_c=1`` mesh), each clique's
    cache is partitioned across its devices
    (``CliqueCache.sharded_device_arrays``, stacked per clique by
    ``stack_hierarchical_shards``), and every mesh position is bound to
    ``device``.  Its losses equal the device backend's up to the order of
    the float sums.  Without a plan the run falls back to the host
    pipeline.

    ``device`` is where the model trains and the cache lives (default
    ``"cuda"``, which raises without a card; pass ``"cpu"`` to run on the
    CPU).  ``params`` are the initial parameters (a nested dict of tensors,
    e.g. ``models.convert.params_from_jax`` of the reference's); the default
    is ``init_from_defs`` from a torch generator seeded with ``seed``.

    ``refresh_interval`` (steps) turns on the online cache manager: live
    traffic is accumulated, drift is checked every interval on the
    Prefetcher's coordinator thread, and a drifted clique's cache is
    delta-refreshed in place; ``refresh_config`` sets the other knobs.  The
    interval must exceed ``prefetch_depth``.

    ``telemetry`` (a ``repro_torch.obs.Telemetry`` or ``TelemetryConfig``)
    instruments the run: spans around the refresh hook, each step's build
    (``prefetch_build``; ``spec_build`` per device on the build threads),
    pack, ``prefetch_get``, finalize and H2D staging, each
    ``device_step``; windowed metric snapshots every ``config.window``
    steps pulled from the TrafficCounter, Prefetcher, OnlineCacheManager,
    CliqueCaches, the store and the straggler monitor; the ``step.time_s``
    and ``straggler.step_time_s`` histograms; a JSONL stream and a
    Perfetto trace.  Span times are host wall clock; with
    ``profiler_annotations`` every span is also a
    ``torch.profiler.record_function`` range, which is where a profiler
    trace shows the device work under it.  The telemetry object is closed
    (final snapshot, sinks flushed) when this returns.  ``telemetry=None``
    runs no telemetry code and gives bitwise the same losses.

    ``feature_store`` (a ``repro_torch.core.feature_store.FeatureStore``,
    or a ``TieredStoreConfig`` to build one over ``g``) routes every
    device-cache miss through the store's host-RAM and file tiers instead
    of a direct host-array read: the layout that trains a graph whose
    feature table is only on disk (``g.feature_file`` set, ``g.features``
    None).  ``lookahead`` sets how many batches each device samples ahead
    of its feature fill (default: the store config's ``lookahead``; it
    needs a store): the future batches' store-request sets feed the
    store's next-use eviction index and their reads prefetch on the
    store's I/O pool.  Sampling stays in strict step order, so batches and
    losses are bitwise those of the storeless run.  The online manager's
    observer sees a sampled-ahead batch when it is sampled, as in the
    reference, so with refreshes inside the window the refreshed residency
    (and so the hit tallies) may differ from the storeless run's.

    The reference's ``checkpoint_dir``, ``resume``, ``mesh``,
    ``compress_grads`` and ``resilience``, and ``sampler="stepwise"``, are
    not ported yet and raise ``NotImplementedError``;
    ``backend="sharded"`` with ``mesh=`` or ``compress_grads=`` raises
    ``ValueError``, as in the reference.
    """
    for name in not_ported:
        if name not in _NOT_PORTED:
            raise TypeError(f"train_gnn() got an unexpected keyword "
                            f"argument {name!r}")
    if backend == "sharded" and plan is not None and (
            not_ported.get("mesh") is not None
            or not_ported.get("compress_grads")):
        raise ValueError(
            "backend='sharded' builds its own hierarchical (pod, clique) "
            "mesh and combines gradients over both axes; it does not "
            "compose with mesh=/compress_grads= (use backend='device' for "
            "the DP-mesh path)")
    asked = [k for k, v in not_ported.items() if v not in (None, False)]
    if asked:
        raise NotImplementedError(
            f"{asked[0]}= is not ported yet (ROADMAP: "
            f"{_NOT_PORTED[asked[0]]})")
    if sampler != "chain":
        raise NotImplementedError(
            f"sampler={sampler!r} is not ported yet (ROADMAP: train_gnn "
            "options still to port)")
    dev = resolve_device(device)
    if devices is None:
        devices = sorted(plan.partition.tablets) if plan is not None else [0]
    devices = list(devices)
    backend = backend if plan is not None else "host"
    exec_clique_ids, exec_cliques = None, None
    if backend == "sharded":
        # devices must cover whole cliques (each clique's cache is
        # partitioned across all of its devices)
        exec_clique_ids, exec_cliques = \
            plan.partition.execution_cliques(devices)
        sizes = sorted({len(c) for c in exec_cliques})
        if len(sizes) != 1:
            raise ValueError(
                f"backend='sharded' needs uniform clique sizes for the "
                f"(pod, clique) mesh; cliques {exec_clique_ids} have sizes "
                f"{[len(c) for c in exec_cliques]} — run ragged cliques as "
                "separate jobs or replan")
        # clique-major order == shard stacking order == mesh position
        devices = [d for c in exec_cliques for d in c]
    n_dev = len(devices)
    counter = (counter if counter is not None
               else TrafficCounter.for_devices(devices))

    if params is None:
        params = init_from_defs(gnn_defs(cfg),
                                torch.Generator().manual_seed(seed), dev)
    else:
        params = tree_map(lambda p: p.detach().to(dev), params)
    opt = adamw(cfg.lr)
    opt_state = opt.init(params)
    train_step = _make_train_step(cfg, opt)

    rngs = {d: np.random.default_rng(seed + 17 * d) for d in devices}
    all_train = (plan.partition.train_vertices if plan is not None
                 else np.arange(g.n))

    manager = None
    if plan is not None and (refresh_interval is not None
                             or refresh_config is not None):
        rc = refresh_config or RefreshConfig()
        if refresh_interval is not None:
            rc = dataclasses.replace(rc, interval=refresh_interval)
        if rc.interval is not None and rc.interval <= prefetch_depth:
            raise ValueError(
                f"refresh_interval ({rc.interval}) must exceed "
                f"prefetch_depth ({prefetch_depth}): the cache double "
                "buffer retains one epoch, so queued specs older than one "
                "refresh would gather from a released buffer")
        manager = OnlineCacheManager(g, plan, rc, counter=counter)

    tele = telemetry
    if tele is not None and not hasattr(tele, "span"):
        # a TelemetryConfig: build the Telemetry here
        tele = Telemetry(tele)
    store = feature_store
    if store is not None and not hasattr(store, "gather"):
        # a TieredStoreConfig: build the FeatureStore over the graph here
        store = FeatureStore(g, store, counter=counter)
    if lookahead is not None and store is None:
        raise ValueError("lookahead= needs a feature_store to feed "
                         "(announce/prefetch hints go to the store)")
    window = (lookahead if lookahead is not None
              else (store.config.lookahead if store is not None else 0))

    per_dev = max(cfg.batch_size // max(n_dev, 1), 16)
    builders = {}
    for d in devices:
        cache = plan.cache_for_device(d) if plan is not None else None
        kw = ({"fused": fused, "bucket": bucket}
              if backend in ("device", "sharded") else {})
        if manager is not None:
            kw["observer"] = manager.observer_for(d)
        builders[d] = make_batch_builder(backend, g, cache, cfg.fanouts,
                                         counter, d, device=dev, **kw)
        builders[d].telemetry = tele
        builders[d].store = store

    def make_spec_fn(d: int):
        """Host phase of one device's part of a synchronized step; the
        Prefetcher's pool may build the devices' parts concurrently, each
        owning its RNG stream and builder.  With a store, a lookahead
        window samples up to ``window`` steps ahead (strict step order:
        the same RNG sequence), announces their store-request sets and
        prefetches their reads, then fills the front spec."""
        rng, builder = rngs[d], builders[d]
        tablet = (plan.partition.tablets[d]
                  if (plan is not None and shuffle == "local") else all_train)

        if store is not None:
            def sample_one(step: int):
                seeds = tablet[rng.integers(0, len(tablet), size=per_dev)]
                return builder.sample_spec(seeds, rng)

            build = LookaheadWindow(builder, store, sample_one,
                                    window=window, limit=steps, dev=d).build
        else:
            def build(step: int):
                seeds = tablet[rng.integers(0, len(tablet), size=per_dev)]
                return builder.build_spec(seeds, rng)

        if tele is None:
            return build

        def spec_fn(step: int):
            # runs on a build thread: the span makes the pool's
            # concurrency visible in the trace
            with tele.span("spec_build", step=step, dev=d):
                return build(step)
        return spec_fn

    sharded_step = pack_fn = None
    if backend == "sharded":
        mesh = make_hierarchical_mesh(exec_cliques, devices=[dev] * n_dev)
        sharded_step = _make_sharded_step(cfg, opt, mesh,
                                          n_total=per_dev * n_dev,
                                          feat_dim=g.feat_dim)
        clique_caches = [plan.caches[ci] for ci in exec_clique_ids]
        shard_stack_memo = {}

        def hierarchical_shards(epochs):
            """The (K_c, K_g, R, Dp) stack for one per-clique epoch vector,
            memoized: cliques refresh independently, so it is restacked
            only when some clique's epoch moves.  Two entries are kept, the
            caches' double-buffer horizon, so queued steps straddling a
            refresh keep their stack."""
            if epochs not in shard_stack_memo:
                while len(shard_stack_memo) >= 2:
                    shard_stack_memo.pop(next(iter(shard_stack_memo)))
                shard_stack_memo[epochs] = stack_hierarchical_shards(
                    clique_caches, epochs)
            return shard_stack_memo[epochs]

        def pack_fn(spec_groups):
            """Second host phase, on the Prefetcher's coordinator: the
            per-clique spec groups in the mesh layout, then each spec's
            staging buffer back to its builder's pool."""
            packed = pack_sharded_specs(spec_groups, g.feat_dim,
                                        bucket=bucket)
            for d, s in zip(devices, (s for gr in spec_groups for s in gr)):
                builders[d].release_spec(s)
            return packed

    def finalize_batch(item):
        """Device phase: finalize every part and concatenate (== DP).  The
        sharded backend dequeues an already-packed hierarchical batch:
        here it only uploads it and resolves the epoch-pinned shard stack
        its routing indexes into."""
        if backend == "sharded":
            packed = dict(item)
            epochs = tuple(int(e) for e in packed.pop("cache_epochs"))
            return hierarchical_shards(epochs), {
                k: torch.from_numpy(v).to(dev) for k, v in packed.items()}
        parts = [builders[d].finalize(s) for d, s in zip(devices, item)]
        if len(parts) == 1:
            return parts[0]
        return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}

    def pipeline_summary():
        """Sampling-path digest off the shared counter, plus the builders'
        fill time and miss-staging pool (pinned host buffers on a GPU)."""
        pools = [b.staging_stats() for b in builders.values()]
        out = {"host_sample_syncs": counter.host_sample_syncs,
               "host_sampled_edges": counter.host_sampled_edges,
               "topo_hit_rate": counter.topo_hit_rate,
               "fill_s_total": sum(b.fill_s for b in builders.values())}
        for k in ("buffers", "bytes", "alloc_s"):
            out[f"staging_{k}"] = sum(p[k] for p in pools)
        return out

    prefetcher = Prefetcher(
        part_fns=[make_spec_fn(d) for d in devices],
        part_group_sizes=([len(c) for c in exec_cliques]
                          if backend == "sharded" else None),
        workers=prefetch_workers, depth=prefetch_depth, limit=steps,
        pre_batch_hook=(manager.on_step if manager is not None else None),
        pack_fn=pack_fn, extra_summary=pipeline_summary, telemetry=tele)

    monitor = StragglerMonitor()
    if tele is not None:
        # metric sources pulled at every windowed snapshot: components
        # mirror their own tallies, nothing extra runs on hot paths
        tele.add_source("traffic", counter.publish_metrics)
        tele.add_source("prefetch", prefetcher.publish_metrics)
        if store is not None:
            tele.add_source("store", store.publish_metrics)
        if manager is not None:
            tele.add_source("refresh", manager.publish_metrics)
        if plan is not None:

            def publish_caches(reg):
                for ci, c in enumerate(plan.caches):
                    c.publish_metrics(reg, clique=ci)
            tele.add_source("caches", publish_caches)
        tele.add_source("straggler", monitor.publish_metrics)
        h_step = tele.registry.histogram("step.time_s")
        h_flag = tele.registry.histogram("straggler.step_time_s")
    losses, accs, epoch_times, step_times = [], [], [], []
    steps_per_epoch = max(len(all_train) // max(cfg.batch_size, 1), 1)
    t_epoch = time.perf_counter()
    try:
        with device_context(dev):
            # the priming fetch is pipeline warm-up (first build, cold
            # workers), so it gets its own span; train_loop is the
            # steady-state loop that the device_step spans tile
            with maybe_span(tele, "pipeline_prime"):
                next_batch = (finalize_batch(prefetcher.get())
                              if steps > 0 else None)
            with maybe_span(tele, "train_loop"):
                for step in range(steps):
                    t0 = time.perf_counter()
                    # the span (a record_function range of the same name
                    # under profiler_annotations) covers dispatch, the
                    # next batch's finalize and the wait on this loss
                    with (tele.span("device_step", step=step)
                          if tele is not None
                          else torch.profiler.record_function("device_step")):
                        if sharded_step is not None:
                            params, opt_state, loss, acc = sharded_step(
                                params, opt_state, *next_batch)
                        else:
                            params, opt_state, loss, acc = train_step(
                                params, opt_state, next_batch)
                        # queue batch i+1's finalize behind step i, then
                        # wait on step i's loss: the one host sync a step
                        next_batch = (finalize_batch(prefetcher.get())
                                      if step + 1 < steps else None)
                        loss_v, acc_v = torch.stack([loss, acc]).tolist()
                    dt = time.perf_counter() - t0
                    flagged = monitor.record(dt)
                    step_times.append(dt)
                    losses.append(loss_v)
                    accs.append(acc_v)
                    if tele is not None:
                        h_step.observe(dt)
                        if flagged:
                            h_flag.observe(dt)
                        if (step + 1) % tele.config.window == 0:
                            tele.snapshot(step + 1)
                    if (step + 1) % steps_per_epoch == 0:
                        epoch_times.append(time.perf_counter() - t_epoch)
                        t_epoch = time.perf_counter()
    finally:
        # close() may re-raise a worker exception; the final snapshot
        # (exact totals need every build and every store read counted)
        # happens either way
        try:
            prefetcher.close()
        finally:
            try:
                if store is not None:
                    # drain the store's I/O pool before the final snapshot
                    # so its read/stall totals are complete
                    store.close()
            finally:
                if tele is not None:
                    tele.close(final_step=steps)

    return GNNTrainResult(losses=losses, accs=accs, epoch_times=epoch_times,
                          counter=counter, straggler=monitor.summary(),
                          steps=steps, backend=backend,
                          pipeline=prefetcher.summary(),
                          refresh=(manager.summary() if manager is not None
                                   else {}),
                          sampling={
                              "host_sample_syncs": counter.host_sample_syncs,
                              "host_sampled_edges":
                                  counter.host_sampled_edges,
                              "topo_hit_rate": counter.topo_hit_rate},
                          step_times=step_times,
                          telemetry=({} if tele is None else {
                              "jsonl_path": tele.config.jsonl_path,
                              "trace_path": tele.config.trace_path,
                              "spans": tele.span_count,
                              "open_spans": tele.open_spans,
                              "window": tele.config.window}),
                          store=(store.summary() if store is not None
                                 else {}))
