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
a device (its own card, or one card for all), holds its clique's cache
partition there, samples there, gathers its batch through the routed
gather (its own shard and its clique peers', read over NVLink where they
lie on other cards, never another clique's), and runs its own forward and
backward on a copy of the parameters; the positions' gradient sums are
copied to position (0, 0)'s card and combine there in a fixed order before
one AdamW update.

``mesh=`` (a one-axis ``("data",)`` mesh) with ``compress_grads=True``
splits each step's batch over the mesh's positions, each run on its own
device one after another, and averages their gradients through the int8
error-feedback all-reduce of ``train/compression.py``, as the reference's
``shard_map`` does.

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

The pipeline is **relaunchable**: everything derived from the (devices,
plan, backend) triple (builders, lookahead windows, the Prefetcher, the
sharded mesh step) is built by one ``launch(start_step)`` closure, so the
recovery path (``resilience=``) can tear the pipeline down on a simulated
device loss, replan onto the survivors with ``replan_on_topology_change``,
and launch a fresh pipeline at the current step; telemetry sources
re-register by name with folded base totals, so the registry counters stay
monotonic across the swap.  A simulated device is a mesh position (a tablet
stream and its builder) on the card the binding gives it (one card for all
unless ``device`` lists one per position).
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.cache_manager import OnlineCacheManager, RefreshConfig
from repro_torch.core.feature_store import FeatureStore
from repro_torch.core.planner import LegionPlan, replan_on_topology_change
from repro_torch.core.unified_cache import TrafficCounter
from repro_torch.graph.csr import CSRGraph
from repro_torch.kernels import gather
from repro_torch.launch.mesh import (DataMesh, HierarchicalMesh,
                                     bind_devices, make_hierarchical_mesh)
from repro_torch.models.gnn import GNNConfig, defs as gnn_defs
from repro_torch.models.gnn import forward as gnn_forward
from repro_torch.models.gnn import loss_fn as gnn_loss
from repro_torch.models.params import init_from_defs
from repro_torch.obs import Telemetry, maybe_span
from repro_torch.train.batch import make_batch_builder, pack_sharded_specs
from repro_torch.train.compression import (init_error_feedback,
                                          make_compressed_grad_fn)
from repro_torch.train.checkpoint import (AsyncCheckpointer,
                                          latest_resumable_checkpoint,
                                          restore_checkpoint)
from repro_torch.train.optimizer import (adamw, apply_updates, tree_leaves,
                                         tree_map)
from repro_torch.train.pipeline import (LookaheadWindow, Prefetcher,
                                        StragglerMonitor)
from repro_torch.train.resilience import (ResilienceConfig, ResilienceStats,
                                          RngJournal, topology_from_partition)
from repro_torch.utils import device_context, resolve_device

# pipeline/refresh summary keys folded into the monotonic base totals when
# a remesh replaces the Prefetcher (and its builders) or the
# OnlineCacheManager mid-run
_PIPE_FOLD_KEYS = ("batches_built", "gets", "host_build_s_total",
                   "host_pack_s_total", "queue_dry_s_total",
                   "worker_deaths", "worker_restarts", "fill_s_total",
                   "staging_buffers", "staging_bytes", "staging_alloc_s")
_REFRESH_FOLD_KEYS = ("checks", "refreshes", "admitted", "evicted",
                      "topo_rebuilds", "refresh_bytes_h2d")


def _fold(base: dict, summary: dict, keys: Sequence[str]) -> None:
    for k in keys:
        v = summary.get(k)
        if isinstance(v, (int, float)):
            base[k] = base.get(k, 0) + v


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
    # resilience digest (ResilienceStats.summary() + fault-plan and
    # checkpoint tallies): remesh/restore/injection activity when train_gnn
    # ran with a resilience config or resumed, {} otherwise
    resilience: dict = dataclasses.field(default_factory=dict)


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


def _make_compressed_step(cfg: GNNConfig, opt, mesh: DataMesh):
    """The data-parallel step over a ``("data",)`` mesh with the int8
    error-feedback gradient all-reduce (``train/compression.py``): the
    batch splits into equal chunks, one per position, and each position's
    gradients are compressed against its own residual before the mean and
    one AdamW update.  The accuracy is 0.0, as in the reference (the
    compressed gradient function returns no metrics)."""
    grad_fn = make_compressed_grad_fn(
        lambda p, b: gnn_loss(cfg, p, b)[0], mesh)

    def step(params, opt_state, efs, batch):
        loss, grads, efs = grad_fn(params, batch, efs)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = apply_updates(params, updates)
        return (params, opt_state, efs, loss,
                torch.zeros((), dtype=torch.float32, device=loss.device))

    return step


def position_parts(packed: dict, mesh: HierarchicalMesh) -> dict:
    """``pack_sharded_specs``' host arrays cut per mesh position: ``(ci,
    gi)`` -> its slice ``packed[k][ci, gi]`` of every array, uploaded to
    that position's device."""
    parts = {}
    for ci, gi in mesh.positions():
        dev = mesh.device(ci, gi)
        with device_context(dev):
            parts[ci, gi] = {k: torch.from_numpy(v[ci, gi]).to(dev)
                             for k, v in packed.items()}
    return parts


def sharded_position_batch(shards, part: dict, feat_dim: int) -> dict:
    """The batch of one mesh position: its clique's shards ``shards`` (K_g
    tensors (R, Dp), each on its position's device) gathered by the
    position's routing (``kernels.gather.routed_gather``: local hits from
    its own shard, peer hits from its clique peers'), the host-staged miss
    rows added, then per-level positioning and pad masking.  ``part`` holds
    the position's slice of the ``pack_sharded_specs`` arrays as tensors on
    its device (``position_parts``), where the batch lies.  The add stays
    outside the kernel, as in the reference; it also turns a -0.0 in a
    cached row into +0.0, as the reference's psum does."""
    D = feat_dim
    miss = part["miss_rows"]
    if shards[0].shape[0] == 0:  # empty cache: every row is a host fill
        feats = miss
    else:
        feats = gather.routed_gather(shards, part["owner"], part["local"])
        feats = feats[:, :D] + miss
    batch = {"labels": part["labels"]}
    li = 0
    while f"pos_{li}" in part:
        valid = part[f"valid_{li}"]
        f = feats.index_select(0, part[f"pos_{li}"]).reshape(
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
    out as a loop.  The master parameters and AdamW's state live on
    position (0, 0)'s device; each step copies the parameters to every
    other device of the mesh (nothing is copied where a position shares
    that device).  For each position ``(ci, gi)`` in clique-major order,
    on its device: the routed gather from clique ``ci``'s shards (no
    feature row crosses a clique), the forward, and the gradients of the
    position's *summed* loss.  The gradients, losses and correct counts
    are copied to (0, 0)'s device, summed over the positions in that fixed
    order and divided by the mesh-wide batch ``n_total``, so the math is
    the single-device mean over the concatenated batch, a rerun is bitwise
    identical, and a one-card mesh gives the bits of a run whose positions
    all share the card; then one AdamW update."""
    master = mesh.device(0, 0)

    def step(params, opt_state, shards, parts):
        params = tree_map(lambda p: p.detach().requires_grad_(), params)
        copies = {master: params}
        grad_sum, loss_sum, acc_sum = None, None, None
        for ci, gi in mesh.positions():
            dev = mesh.device(ci, gi)
            if dev not in copies:
                copies[dev] = tree_map(
                    lambda p: p.detach().to(dev).requires_grad_(), params)
            with device_context(dev):
                batch = sharded_position_batch(shards[ci], parts[ci, gi],
                                               feat_dim)
                loss, acc = _sum_loss(cfg, copies[dev], batch)
                grads = torch.autograd.grad(loss, tree_leaves(copies[dev]))
            grads = [g.to(master) for g in grads]
            loss, acc = loss.detach().to(master), acc.to(master)
            if grad_sum is None:
                grad_sum, loss_sum, acc_sum = list(grads), loss, acc
            else:
                grad_sum = [a + b for a, b in zip(grad_sum, grads)]
                loss_sum = loss_sum + loss
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
              checkpoint_dir: Optional[str] = None,
              checkpoint_every: int = 50, resume: bool = False,
              prefetch_depth: int = 2,
              prefetch_workers: Optional[int] = None,
              shuffle: str = "local", mesh: Optional[DataMesh] = None,
              compress_grads: bool = False, backend: str = "host",
              fused: bool = True, bucket: int = 256, sampler: str = "chain",
              refresh_interval: Optional[int] = None,
              refresh_config: Optional[RefreshConfig] = None,
              telemetry=None, feature_store=None,
              lookahead: Optional[int] = None,
              resilience: Optional[ResilienceConfig] = None
              ) -> GNNTrainResult:
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
    (``CliqueCache.sharded_device_arrays``: one shard per position, on
    its position's device), and every mesh position is bound to
    ``device``, or to its own entry of a ``device`` list.  Its losses equal
    the device backend's up to the order of the float sums.  Without a
    plan the run falls back to the host pipeline.

    ``device`` is where the model trains and the cache lives (default
    ``"cuda"``, which raises without a card; pass ``"cpu"`` to run on the
    CPU).  With ``backend="sharded"`` it may list one device per mesh
    position in clique-major order (``[d_00, d_01, d_10, d_11]`` for a
    2 x 2 mesh): each position then samples, gathers and trains on its own
    card, the master parameters and AdamW's state live on the first, and
    the gradients are summed there in position order, so a binding of
    distinct cards gives the losses of a one-card binding bit for bit.  A
    card the host does not have, a list of another length, or a list with
    another backend raises; nothing moves to the CPU or to one card
    unasked.  ``params`` are the initial parameters (a nested dict of tensors,
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
    CliqueCaches, the store, the checkpointer, the fault plan, the recovery
    tallies and the straggler monitor; the ``step.time_s`` and
    ``straggler.step_time_s`` histograms; a JSONL stream and a Perfetto
    trace.  Span times are host wall clock; with ``profiler_annotations``
    every span is also a ``torch.profiler.record_function`` range, which is
    where a profiler trace shows the device work under it.  The telemetry
    object is closed (final snapshot, sinks flushed) when this returns,
    after the final checkpoint, so its totals count every write.
    ``telemetry=None`` runs no telemetry code and gives bitwise the same
    losses.

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

    ``checkpoint_dir`` writes ``(params, opt_state)`` every
    ``checkpoint_every`` steps and at the step the run reached, on a
    background thread (``train.checkpoint.AsyncCheckpointer``, the
    reference's file format), with the *runtime* state: each device's
    sampler RNG state at that step boundary (from an ``RngJournal``: the
    live generators are ahead by the prefetch and lookahead windows), the
    online manager's learned hotness and the store's host-tier residency.
    ``resume=True`` restores the newest checkpoint that validates against
    the model tree, and all of its runtime state, so the resumed run
    continues the exact batch sequence; a checkpoint at or past ``steps``
    gives an empty run with ``result.steps = steps - step`` (negative past
    ``steps``), as the reference's does.

    ``resilience`` (a ``train.resilience.ResilienceConfig``) turns on the
    recovery hooks: bounded prefetch-worker respawns, retried checkpoint
    writes, and, on a simulated device loss, the remesh onto the survivors
    (``replan_on_topology_change`` and a fresh pipeline at the current
    step; the in-flight batch is discarded, the sharded backend falls back
    to the device backend, survivor RNGs re-seed from ``(seed, step,
    device)``).  The old pipeline has built ahead of the lost step when
    the loss is seen; the remesh discards those batches too, and the
    traffic tallies count their sampling and fills, so after a loss the
    tallies depend on timing, as the reference's do (the losses do not).
    Its ``fault_plan`` injects deterministic faults
    (``prefetch_build``, ``ssd_read``, ``ssd_stall`` under the store's
    retry loop, ``checkpoint_write``, ``device_loss``).

    ``sampler``: ``"chain"`` samples every hop of a device spec build in
    one launch of the sampling chain; ``"stepwise"`` is the per-hop path
    (one ``routed_neighbor_sample`` launch and one sync per hop,
    ``cache_sample_batch(chain=False)``), kept as a parity oracle: both
    give bitwise the same batches.  The host backend ignores it.

    ``mesh`` (a ``launch.mesh.DataMesh``) with ``compress_grads=True``
    runs the step as explicit data parallelism over the mesh's positions
    with the int8 error-feedback gradient all-reduce
    (``train/compression.py``): the concatenated batch splits into
    ``mesh.size`` equal chunks (``cfg.batch_size`` must be a multiple of
    the mesh size), every position keeps its own residual, and the
    reported accuracy is 0.0, as in the reference.  The residuals are not
    checkpointed, as in the reference: a resumed run starts them at zero.
    ``mesh`` alone, or ``compress_grads`` alone, runs the plain step.
    ``backend="sharded"`` with either raises ``ValueError``, and so does a
    ``device_loss`` fault with ``mesh``, as in the reference.
    """
    backend = backend if plan is not None else "host"
    if backend == "sharded" and (mesh is not None or compress_grads):
        raise ValueError(
            "backend='sharded' builds its own hierarchical (pod, clique) "
            "mesh and combines gradients over both axes; it does not "
            "compose with mesh=/compress_grads= (use backend='device' for "
            "the DP-mesh path)")
    if mesh is not None and compress_grads \
            and cfg.batch_size % mesh.size:
        raise ValueError(
            f"batch_size {cfg.batch_size} does not split over the "
            f"{mesh.size} positions of the data mesh")
    binding = None
    if isinstance(device, (list, tuple)):
        if backend != "sharded":
            raise ValueError(
                f"a device list binds the positions of backend='sharded' "
                f"(this run's backend is {backend!r}); pass one device")
        binding = bind_devices(device, "train_gnn")
        dev = binding[0]
    else:
        dev = resolve_device(device)
    if mesh is not None and compress_grads and (
            mesh.device(0) != dev
            or {d.type for d in mesh.devices} != {dev.type}):
        raise ValueError(f"the data mesh's positions live on "
                         f"{sorted(map(str, set(mesh.devices)))}; position "
                         f"0 must hold the model, on {dev}")
    if devices is None:
        devices = sorted(plan.partition.tablets) if plan is not None else [0]
    devices = list(devices)
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
                "separate jobs or replan with replan_on_topology_change")
        # clique-major order == shard order == mesh position
        devices = [d for c in exec_cliques for d in c]
    n_dev = len(devices)
    if binding is not None and len(binding) != n_dev:
        raise ValueError(f"train_gnn: {len(binding)} devices bound to the "
                         f"{n_dev} positions of the (pod, clique) mesh")
    # each plan device's card: its binding entry, else the model's device
    card_of = dict(zip(devices, binding if binding is not None
                       else [dev] * n_dev))
    counter = (counter if counter is not None
               else TrafficCounter.for_devices(devices))

    resil = resilience
    fplan = resil.fault_plan if resil is not None else None
    rstats = ResilienceStats()
    if fplan is not None and any(
            s.site == "device_loss" for s in fplan._specs):
        if plan is None or mesh is not None:
            raise ValueError(
                "device_loss recovery needs a LegionPlan to replan from "
                "and does not compose with an explicit mesh= (the remesh "
                "rebuilds the executor itself)")

    tele = telemetry
    if tele is not None and not hasattr(tele, "span"):
        # a TelemetryConfig: build the Telemetry here
        tele = Telemetry(tele)

    if params is None:
        params = init_from_defs(gnn_defs(cfg),
                                torch.Generator().manual_seed(seed), dev)
    else:
        params = tree_map(lambda p: p.detach().to(dev), params)
    opt = adamw(cfg.lr)
    opt_state = opt.init(params)
    train_step = _make_train_step(cfg, opt)
    step0 = 0
    efs = None
    if mesh is not None and compress_grads:
        compressed_step = _make_compressed_step(cfg, opt, mesh)

    ckpt = None
    runtime0 = None
    if checkpoint_dir:
        ckpt = AsyncCheckpointer(
            checkpoint_dir,
            retries=(resil.checkpoint_retries if resil is not None else 1),
            fault_plan=fplan)
        if resume:
            # the newest checkpoint that validates against the model tree:
            # torn or partial files from a crash are skipped, not picked
            path = latest_resumable_checkpoint(checkpoint_dir,
                                               like=(params, opt_state))
            if path:
                t0 = time.perf_counter()
                step0, (params, opt_state), runtime0 = restore_checkpoint(
                    path, (params, opt_state), with_runtime=True)
                rstats.restore_s += time.perf_counter() - t0
                rstats.resumed_from_step = step0
    if mesh is not None and compress_grads:
        # one zero residual tree per data position, on its device, never
        # checkpointed
        efs = init_error_feedback(params, mesh.size, devices=mesh.devices)

    rngs = {d: np.random.default_rng(seed + 17 * d) for d in devices}
    # RNG journal: boundary states at each step, so a checkpoint captures
    # "state with steps < k drawn" even while the lookahead window has the
    # live generator several steps ahead (see resilience.RngJournal)
    journal = {d: RngJournal() for d in devices} if ckpt is not None else None
    if runtime0 is not None:
        for d, st_rng in runtime0.get("rng", {}).items():
            if d in rngs:
                rngs[d].bit_generator.state = st_rng
        rstats.runtime_restored = "rng" in runtime0
    all_train = (plan.partition.train_vertices if plan is not None
                 else np.arange(g.n))

    rc = None
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
        if runtime0 is not None and runtime0.get("manager") is not None:
            # recover the learned hot set: restore the blended hotness and
            # delta-replan each clique's residency from it in one pass
            t0 = time.perf_counter()
            rstats.cache_rebuilds += manager.load_state_dict(
                runtime0["manager"], reapply=True)
            rstats.restore_s += time.perf_counter() - t0

    store = feature_store
    if store is not None and not hasattr(store, "gather"):
        # a TieredStoreConfig: build the FeatureStore over the graph here
        store = FeatureStore(g, store, counter=counter)
    if store is not None and fplan is not None:
        # the chaos harness under the store: ssd_read/ssd_stall faults
        # fire inside _timed_read's retry loop
        store.source = fplan.wrap_source(store.source)
    if store is not None and runtime0 is not None \
            and runtime0.get("store") is not None:
        t0 = time.perf_counter()
        store.load_state_dict(runtime0["store"])
        rstats.restore_s += time.perf_counter() - t0
    if lookahead is not None and store is None:
        raise ValueError("lookahead= needs a feature_store to feed "
                         "(announce/prefetch hints go to the store)")
    window = (lookahead if lookahead is not None
              else (store.config.lookahead if store is not None else 0))

    # ---- the relaunchable pipeline ------------------------------------
    # everything derived from (devices, plan, backend) lives in this
    # mutable cell so the device-loss recovery path can rebuild it;
    # *_base carry closed components' totals (monotonic across a swap)
    st = {"devices": devices, "plan": plan, "backend": backend,
          "manager": manager, "exec_cliques": exec_cliques,
          "per_dev": max(cfg.batch_size // max(n_dev, 1), 16),
          "builders": {}, "prefetcher": None, "finalize": None,
          "sharded_step": None}
    pipeline_base: dict = {}
    refresh_base: dict = {}
    refresh_events: List[dict] = []

    def pipeline_summary():
        """Sampling-path digest off the shared counter, plus the current
        builders' fill time and miss-staging pool (pinned host buffers on a
        GPU)."""
        builders = st["builders"].values()
        pools = [b.staging_stats() for b in builders]
        out = {"host_sample_syncs": counter.host_sample_syncs,
               "host_sampled_edges": counter.host_sampled_edges,
               "topo_hit_rate": counter.topo_hit_rate,
               "fill_s_total": sum(b.fill_s for b in builders)}
        for k in ("buffers", "bytes", "alloc_s"):
            out[f"staging_{k}"] = sum(p[k] for p in pools)
        return out

    def launch(start_step: int) -> None:
        """(Re)build the batch pipeline to produce steps
        ``start_step..steps-1`` from the current (devices, plan, backend)
        state: builders (with observers), the sharded mesh step when
        applicable, per-device spec closures (lookahead windows when a
        store is attached) and the Prefetcher itself."""
        devs, plan_l = st["devices"], st["plan"]
        backend_l, manager_l = st["backend"], st["manager"]
        per_dev = st["per_dev"]
        mesh = None
        if backend_l == "sharded":
            mesh = make_hierarchical_mesh(
                st["exec_cliques"], devices=[card_of[d] for d in devs])
        builders = {}
        for d in devs:
            cache = plan_l.cache_for_device(d) if plan_l is not None else None
            kw = ({"fused": fused, "bucket": bucket, "sampler": sampler}
                  if backend_l in ("device", "sharded") else {})
            if manager_l is not None:
                kw["observer"] = manager_l.observer_for(d)
            # a builder runs on its own card (sharded), or on the card of
            # its cache's first device, where the clique's flat residency
            # lives (the device backend after a remesh of a bound mesh)
            card = dev if cache is None else card_of.get(
                d if backend_l == "sharded" else cache.devices[0], dev)
            if backend_l == "sharded":
                kw["shard_devices"] = [card_of[x] for x in cache.devices]
            builders[d] = make_batch_builder(backend_l, g, cache, cfg.fanouts,
                                             counter, d, device=card, **kw)
            builders[d].telemetry = tele
            builders[d].store = store
        st["builders"] = builders

        def make_spec_fn(d: int):
            """Host phase of one device's part of a synchronized step; the
            Prefetcher's pool may build the devices' parts concurrently,
            each owning its RNG stream and builder.  With a store, a
            lookahead window samples up to ``window`` steps ahead (strict
            step order: the same RNG sequence), announces their
            store-request sets and prefetches their reads, then fills the
            front spec.  With a journal, each step's boundary RNG state is
            recorded right after its draws."""
            rng, builder = rngs[d], builders[d]
            tablet = (plan_l.partition.tablets[d]
                      if (plan_l is not None and shuffle == "local")
                      else all_train)
            jr = journal[d] if journal is not None else None

            if store is not None:
                def sample_one(step: int):
                    seeds = tablet[rng.integers(0, len(tablet),
                                                size=per_dev)]
                    spec = builder.sample_spec(seeds, rng)
                    if jr is not None:
                        # boundary state: steps <= this one fully drawn
                        jr.record(step + 1, rng)
                    return spec

                build = LookaheadWindow(builder, store, sample_one,
                                        window=window, limit=steps, dev=d,
                                        start=start_step).build
            else:
                def build(step: int):
                    seeds = tablet[rng.integers(0, len(tablet),
                                                size=per_dev)]
                    spec = builder.build_spec(seeds, rng)
                    if jr is not None:
                        jr.record(step + 1, rng)
                    return spec

            if tele is None:
                return build

            def spec_fn(step: int):
                # runs on a build thread: the span makes the pool's
                # concurrency visible in the trace
                with tele.span("spec_build", step=step, dev=d):
                    return build(step)
            return spec_fn

        pack_fn = None
        if backend_l == "sharded":
            st["sharded_step"] = _make_sharded_step(
                cfg, opt, mesh, n_total=per_dev * len(devs),
                feat_dim=g.feat_dim)
            clique_caches = [plan_l.caches[ci] for ci in exec_clique_ids]

            def pack_fn(spec_groups):
                """Second host phase, on the Prefetcher's coordinator: the
                per-clique spec groups in the mesh layout, then each spec's
                staging buffer back to its builder's pool."""
                packed = pack_sharded_specs(spec_groups, g.feat_dim,
                                            bucket=bucket)
                for d, s in zip(devs, (s for gr in spec_groups for s in gr)):
                    builders[d].release_spec(s)
                return packed
        else:
            st["sharded_step"] = None

        def finalize_batch(item):
            """Device phase: finalize every part and concatenate on the
            model's device (== DP).  The sharded backend dequeues an
            already-packed hierarchical batch: here it uploads each
            position's slice to that position's device and resolves each
            clique's epoch-pinned shards, which the cache's double buffer
            keeps alive (cliques refresh independently, so the epochs may
            differ between cliques, never within one)."""
            if backend_l == "sharded":
                packed = dict(item)
                epochs = [int(e) for e in packed.pop("cache_epochs")]
                shards = [c.sharded_device_arrays(e)["feat_shards"]
                          for c, e in zip(clique_caches, epochs)]
                return shards, position_parts(packed, mesh)
            parts = [builders[d].finalize(s) for d, s in zip(devs, item)]
            if len(parts) == 1:
                return {k: v.to(dev) for k, v in parts[0].items()}
            return {k: torch.cat([p[k].to(dev) for p in parts])
                    for k in parts[0]}

        if journal is not None:
            for d in devs:
                # the state that samples ``start_step`` onward: a checkpoint
                # taken before any build can still resume here
                journal.setdefault(d, RngJournal()).record(start_step,
                                                           rngs[d])
        st["finalize"] = finalize_batch
        st["prefetcher"] = Prefetcher(
            part_fns=[make_spec_fn(d) for d in devs],
            part_group_sizes=([len(c) for c in st["exec_cliques"]]
                              if backend_l == "sharded" else None),
            workers=prefetch_workers, depth=prefetch_depth,
            limit=max(steps - start_step, 0),
            pre_batch_hook=(manager_l.on_step
                            if manager_l is not None else None),
            pack_fn=pack_fn, extra_summary=pipeline_summary, telemetry=tele,
            start_step=start_step,
            max_restarts=(resil.worker_restarts if resil is not None else 0),
            fault_plan=fplan)

    def remesh(dead: List[int], at_step: int) -> None:
        """Device-loss recovery: tear the pipeline down, replan onto the
        survivors (dead devices' tablets and hotness merge into the
        survivors: ``replan_on_topology_change``), and launch a fresh
        pipeline at the current step.  The sharded mesh cannot shrink in
        place, so that backend falls back to the device backend (the
        concatenated batch is the same synchronous DP); its survivors keep
        the cards they were bound to, each clique's residency on its first
        survivor's card, the batches concatenated on the model's.  Survivor RNG
        streams re-seed from (seed, step, device), so a run with a fixed
        fault plan is reproducible end to end."""
        t0 = time.perf_counter()
        old = st["prefetcher"]
        old.close()  # a pending organic worker failure still surfaces
        _fold(pipeline_base, old.summary(), _PIPE_FOLD_KEYS)
        survivors = [d for d in st["devices"] if d not in set(dead)]
        if not survivors:
            raise RuntimeError(
                f"device(s) {sorted(dead)} lost at step {at_step} and no "
                "survivors remain — nothing to remesh onto")
        topo = topology_from_partition(st["plan"].partition)
        new_plan = replan_on_topology_change(g, st["plan"], topo,
                                             alive=survivors)
        st["plan"] = new_plan
        st["devices"] = [d for c in new_plan.partition.cliques for d in c]
        st["per_dev"] = max(cfg.batch_size // max(len(survivors), 1), 16)
        if st["backend"] == "sharded":
            st["backend"] = "device"
        for d in st["devices"]:
            rngs[d] = np.random.default_rng([seed, at_step, d])
        if st["manager"] is not None:
            _fold(refresh_base, st["manager"].summary(), _REFRESH_FOLD_KEYS)
            refresh_events.extend(st["manager"].stats.events)
            # a fresh manager over the survivor plan: the replan already
            # merged the dead devices' hotness into the new plan's stats
            st["manager"] = OnlineCacheManager(g, new_plan, rc,
                                               counter=counter)
        launch(at_step)
        dt = time.perf_counter() - t0
        rstats.remesh_events += 1
        rstats.devices_lost += len(dead)
        rstats.remesh_s += dt
        rstats.events.append({"step": at_step, "lost": sorted(map(int, dead)),
                              "survivors": len(survivors),
                              "backend": st["backend"], "remesh_s": dt})
        if tele is not None:
            tele.event("remesh", step=at_step, lost=sorted(map(int, dead)),
                       survivors=len(survivors))

    launch(step0)

    monitor = StragglerMonitor()
    if tele is not None:
        # metric sources pulled at every windowed snapshot: components
        # mirror their own tallies, nothing extra runs on hot paths.
        # Sources that a remesh replaces are closures over the pipeline
        # cell (add_source replaces by name) with folded base totals, so
        # counters stay monotonic across the swap.
        tele.add_source("traffic", counter.publish_metrics)
        tele.add_source(
            "prefetch",
            lambda reg: st["prefetcher"].publish_metrics(
                reg, base=pipeline_base))
        if store is not None:
            tele.add_source("store", store.publish_metrics)
        if st["manager"] is not None:

            def publish_refresh(reg):
                if st["manager"] is not None:
                    st["manager"].publish_metrics(reg, base=refresh_base)
            tele.add_source("refresh", publish_refresh)
        if plan is not None:

            def publish_caches(reg):
                for ci, c in enumerate(st["plan"].caches):
                    c.publish_metrics(reg, clique=ci)
            tele.add_source("caches", publish_caches)
        if ckpt is not None:
            tele.add_source("checkpoint", ckpt.publish_metrics)
        if resil is not None or rstats.resumed_from_step is not None:
            tele.add_source("resilience", rstats.publish_metrics)
        if fplan is not None:
            tele.add_source("faults", fplan.publish_metrics)
        tele.add_source("straggler", monitor.publish_metrics)
        h_step = tele.registry.histogram("step.time_s")
        h_flag = tele.registry.histogram("straggler.step_time_s")
    losses, accs, epoch_times, step_times = [], [], [], []
    steps_per_epoch = max(len(all_train) // max(cfg.batch_size, 1), 1)
    t_epoch = time.perf_counter()
    reached = step0
    try:
        with device_context(dev):
            # the priming fetch is pipeline warm-up (first build, cold
            # workers), so it gets its own span; train_loop is the
            # steady-state loop that the device_step spans tile
            with maybe_span(tele, "pipeline_prime"):
                next_batch = (st["finalize"](st["prefetcher"].get())
                              if steps > step0 else None)
            with maybe_span(tele, "train_loop"):
                for step in range(step0, steps):
                    if fplan is not None:
                        dead = fplan.device_losses(step)
                        if dead:
                            if resil.on_device_loss == "raise":
                                raise RuntimeError(
                                    f"device(s) {sorted(dead)} lost at step "
                                    f"{step} (on_device_loss='raise')")
                            # the in-flight batch was built by the lost
                            # topology: discard it, remesh, rebuild step
                            remesh(dead, step)
                            next_batch = st["finalize"](
                                st["prefetcher"].get())
                    t0 = time.perf_counter()
                    # the span (a record_function range of the same name
                    # under profiler_annotations) covers dispatch, the
                    # next batch's finalize and the wait on this loss
                    with (tele.span("device_step", step=step)
                          if tele is not None
                          else torch.profiler.record_function("device_step")):
                        new_efs = efs
                        if efs is not None:
                            new_params, new_opt, new_efs, loss, acc = \
                                compressed_step(params, opt_state, efs,
                                                next_batch)
                        elif st["backend"] == "sharded":
                            new_params, new_opt, loss, acc = \
                                st["sharded_step"](params, opt_state,
                                                   *next_batch)
                        else:
                            new_params, new_opt, loss, acc = train_step(
                                params, opt_state, next_batch)
                        # queue batch i+1's finalize behind step i, then
                        # wait on step i's loss: the one host sync a step
                        next_batch = (st["finalize"](st["prefetcher"].get())
                                      if step + 1 < steps else None)
                        loss_v, acc_v = torch.stack([loss, acc]).tolist()
                    # the step is done: its state and the step count move
                    # together, so after an exception before here (a
                    # Ctrl-C in the wait) the final checkpoint is labelled
                    # with this step and holds the parameters before it
                    params, opt_state, reached = new_params, new_opt, step + 1
                    efs = new_efs
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
                    if ckpt is not None and (step + 1) % checkpoint_every == 0:
                        ckpt.save(step + 1, (params, opt_state),
                                  runtime=_runtime_state(st, journal, store,
                                                         step + 1))
                    if (step + 1) % steps_per_epoch == 0:
                        epoch_times.append(time.perf_counter() - t_epoch)
                        t_epoch = time.perf_counter()
    finally:
        # close() may re-raise a worker exception; the final checkpoint and
        # the final snapshot (exact totals need every build, store read and
        # checkpoint write counted) happen either way
        try:
            st["prefetcher"].close()
        finally:
            try:
                if store is not None:
                    # drain the store's I/O pool before the final snapshot
                    # so its read/stall totals are complete; the store
                    # itself stays usable
                    store.close()
            finally:
                try:
                    if ckpt is not None:
                        # the step actually completed: an aborted run must
                        # not publish a checkpoint labeled with a step it
                        # never reached
                        ckpt.save(reached, (params, opt_state),
                                  runtime=_runtime_state(st, journal, store,
                                                         reached))
                        ckpt.close()
                finally:
                    if tele is not None:
                        tele.close(final_step=steps)

    pipe = st["prefetcher"].summary()
    for k, v in pipeline_base.items():
        if k in pipe:
            pipe[k] = pipe[k] + v
    refresh = {}
    if st["manager"] is not None:
        refresh = st["manager"].summary()
        for k, v in refresh_base.items():
            refresh[k] = refresh.get(k, 0) + v
        refresh["events"] = refresh_events + refresh.get("events", [])
    resilience_digest = {}
    if resil is not None or rstats.resumed_from_step is not None \
            or rstats.remesh_events:
        resilience_digest = rstats.summary()
        if fplan is not None:
            resilience_digest["faults"] = fplan.summary()
        if ckpt is not None:
            resilience_digest["checkpoint"] = ckpt.summary()
    return GNNTrainResult(losses=losses, accs=accs, epoch_times=epoch_times,
                          counter=counter, straggler=monitor.summary(),
                          steps=steps - step0, backend=st["backend"],
                          pipeline=pipe, refresh=refresh,
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
                                 else {}),
                          resilience=resilience_digest)


def _runtime_state(st: dict, journal, store, next_step: int) -> dict:
    """The runtime payload for a checkpoint at boundary ``next_step``:
    per-device sampler RNG states *at that boundary* (from the journal:
    the live generators are already ahead by the lookahead window), the
    online manager's learned hotness, and the store's host-tier residency
    (the reference's payload, key for key).  ``train_gnn(resume=True)``
    puts all of it back."""
    rt: dict = {"version": 1, "devices": [int(d) for d in st["devices"]]}
    if journal is not None:
        states = {}
        for d in st["devices"]:
            s = journal[d].state_for(next_step)
            if s is None:
                states = None
                break
            states[int(d)] = s
        if states is not None:
            rt["rng"] = states
    if st["manager"] is not None:
        rt["manager"] = st["manager"].state_dict()
    if store is not None:
        rt["store"] = store.state_dict()
    return rt
