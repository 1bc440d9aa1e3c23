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

Device work is queued on the GPU's current (default) stream from three
threads: the Prefetcher's (device sampling, and the online refresh's
scatter), the build pool's, and the consumer's (finalize and the step).
One stream orders them; the consumer reads its step's loss once per step,
after the next batch's finalize is queued.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.cache_manager import OnlineCacheManager, RefreshConfig
from repro_torch.core.planner import LegionPlan
from repro_torch.core.unified_cache import TrafficCounter
from repro_torch.graph.csr import CSRGraph
from repro_torch.models.gnn import GNNConfig, defs as gnn_defs
from repro_torch.models.gnn import loss_fn as gnn_loss
from repro_torch.models.params import init_from_defs
from repro_torch.train.batch import make_batch_builder
from repro_torch.train.optimizer import (adamw, apply_updates, tree_leaves,
                                         tree_map)
from repro_torch.train.pipeline import Prefetcher, StragglerMonitor
from repro_torch.utils import device_context, resolve_device

# options of the reference's train_gnn that this package does not run yet,
# with the ROADMAP item that brings each
_NOT_PORTED = {
    "checkpoint_dir": "resilience (checkpoint and resume)",
    "resume": "resilience (checkpoint and resume)",
    "mesh": "the sharded clique executor",
    "compress_grads": "gradient compression",
    "telemetry": "telemetry beyond maybe_span",
    "feature_store": "the tiered feature store",
    "lookahead": "the tiered feature store",
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
              **not_ported) -> GNNTrainResult:
    """Train SAGE/GCN with the Legion pipeline (see module doc).
    ``shuffle='global'`` ignores tablets and draws seeds from the full
    training set.

    ``backend``: ``"host"`` is the classic CPU pipeline; ``"device"``
    samples and gathers against the device-resident unified cache with the
    host filling only misses (``fused=False`` runs the unfused finalize
    chain, ``bucket`` is the spec layout's shape quantum).  Both draw the
    same randomness and produce bitwise-equal batches.  Without a plan the
    run falls back to the host pipeline.

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

    The reference's ``checkpoint_dir``, ``resume``, ``mesh``,
    ``compress_grads``, ``telemetry``, ``feature_store``, ``lookahead`` and
    ``resilience``, ``backend="sharded"`` and ``sampler="stepwise"`` are not
    ported yet and raise ``NotImplementedError``.
    """
    for name in not_ported:
        if name not in _NOT_PORTED:
            raise TypeError(f"train_gnn() got an unexpected keyword "
                            f"argument {name!r}")
    asked = [k for k, v in not_ported.items() if v not in (None, False)]
    if asked:
        raise NotImplementedError(
            f"{asked[0]}= is not ported yet (ROADMAP: "
            f"{_NOT_PORTED[asked[0]]})")
    if backend == "sharded":
        raise NotImplementedError("backend='sharded' is not ported yet "
                                  "(ROADMAP: the sharded clique executor)")
    if sampler != "chain":
        raise NotImplementedError(
            f"sampler={sampler!r} is not ported yet (ROADMAP: train_gnn "
            "options still to port)")
    dev = resolve_device(device)
    if devices is None:
        devices = sorted(plan.partition.tablets) if plan is not None else [0]
    devices = list(devices)
    backend = backend if plan is not None else "host"
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

    per_dev = max(cfg.batch_size // max(n_dev, 1), 16)
    builders = {}
    for d in devices:
        cache = plan.cache_for_device(d) if plan is not None else None
        kw = {"fused": fused, "bucket": bucket} if backend == "device" else {}
        if manager is not None:
            kw["observer"] = manager.observer_for(d)
        builders[d] = make_batch_builder(backend, g, cache, cfg.fanouts,
                                         counter, d, device=dev, **kw)

    def make_spec_fn(d: int):
        """Host phase of one device's part of a synchronized step; the
        Prefetcher's pool may build the devices' parts concurrently, each
        owning its RNG stream and builder."""
        rng, builder = rngs[d], builders[d]
        tablet = (plan.partition.tablets[d]
                  if (plan is not None and shuffle == "local") else all_train)

        def build(step: int):
            seeds = tablet[rng.integers(0, len(tablet), size=per_dev)]
            return builder.build_spec(seeds, rng)
        return build

    def finalize_batch(item):
        """Device phase: finalize every part and concatenate (== DP)."""
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
        workers=prefetch_workers, depth=prefetch_depth, limit=steps,
        pre_batch_hook=(manager.on_step if manager is not None else None),
        extra_summary=pipeline_summary)

    monitor = StragglerMonitor()
    losses, accs, epoch_times, step_times = [], [], [], []
    steps_per_epoch = max(len(all_train) // max(cfg.batch_size, 1), 1)
    t_epoch = time.perf_counter()
    try:
        with device_context(dev):
            next_batch = (finalize_batch(prefetcher.get())
                          if steps > 0 else None)
            for step in range(steps):
                t0 = time.perf_counter()
                with torch.profiler.record_function("device_step"):
                    params, opt_state, loss, acc = train_step(
                        params, opt_state, next_batch)
                    # queue batch i+1's finalize behind step i, then wait
                    # on step i's loss: the one host sync of the step
                    next_batch = (finalize_batch(prefetcher.get())
                                  if step + 1 < steps else None)
                    loss_v, acc_v = torch.stack([loss, acc]).tolist()
                dt = time.perf_counter() - t0
                monitor.record(dt)
                step_times.append(dt)
                losses.append(loss_v)
                accs.append(acc_v)
                if (step + 1) % steps_per_epoch == 0:
                    epoch_times.append(time.perf_counter() - t_epoch)
                    t_epoch = time.perf_counter()
    finally:
        prefetcher.close()

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
                          step_times=step_times)
