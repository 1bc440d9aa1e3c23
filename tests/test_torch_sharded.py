"""The sharded clique executor of the port (``train_gnn(backend="sharded")``
on the ``(pod, clique)`` mesh) against the reference package, on the CPU.

Same numpy inputs on both sides, a 2 x 2 hierarchy (``dgx-v100`` with four
GPUs: two cliques of two).  Bit for bit: the shard routing, the sharded
residency (one tensor per shard, stacked here to meet the reference's), the
sharded specs' routing, the packed mesh batch, the two routed kernels' plain
versions against the reference's dense oracles, and every position's
gathered batch against the reference's device-backend batch of the same
spec.  Within stated
tolerances: ``train_gnn`` losses against the reference's device backend
(atol 1e-4, the reference's own sharded tolerance: the mesh sums the
positions' float32 gradients in another order) and against the reference's
own sharded executor, run in a subprocess on a forced four-device CPU mesh.
Traffic tallies, refresh events and the zero cross-clique bytes are exact.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.cache_manager import RefreshConfig as JRefresh
from repro.core.cliques import topology_matrix as j_topo
from repro.core.planner import build_plan as j_build_plan
from repro.graph.csr import powerlaw_graph as j_graph
from repro.graph.sampling import host_sample_level as j_host_sample_level
from repro.kernels import ref as jref
from repro.launch.mesh import make_hierarchical_mesh as j_mesh
from repro.models.gnn import GNNConfig as JConfig
from repro.models.gnn import defs as j_defs
from repro.models.params import init_from_defs as j_init
from repro.train.batch import DeviceBatchBuilder as JDevice
from repro.train.batch import ShardedBatchBuilder as JSharded
from repro.train.batch import pack_sharded_specs as j_pack
from repro.train.loop import train_gnn as j_train
from repro_torch.core.cache_manager import RefreshConfig
from repro_torch.core.cliques import topology_matrix as t_topo
from repro_torch.core.planner import build_plan as t_build_plan
from repro_torch.core.unified_cache import TrafficCounter
from repro_torch.graph.csr import powerlaw_graph as t_graph
from repro_torch.kernels import gather
from repro_torch.kernels import ref as tref
from repro_torch.launch.mesh import make_hierarchical_mesh as t_mesh
from repro_torch.models.convert import params_from_jax
from repro_torch.models.gnn import GNNConfig
from repro_torch.train.batch import ShardedBatchBuilder, make_batch_builder
from repro_torch.train.batch import pack_sharded_specs as t_pack
from repro_torch.train.loop import (position_parts, sharded_position_batch,
                                   train_gnn)

ROOT = Path(__file__).resolve().parents[1]
GRAPH = dict(n=3000, avg_degree=8, seed=9, feat_dim=16)
FANOUTS = (4, 2)
PLAN = dict(mem_per_device=30_000, batch_size=64, seed=0, fanouts=FANOUTS)
CFG = dict(feat_dim=16, hidden=32, batch_size=64, fanouts=FANOUTS, lr=3e-3)
REFRESH = dict(interval=4, drift_threshold=1.0)
STEPS = 8
# the sharded residency's per-card copies (the others are one per shard)
PER_CARD = ("slot_owner", "slot_local", "topo_owner", "topo_local")
TALLIES = ("pcie_transactions", "feature_requests", "feature_hits",
           "topo_requests", "topo_hits", "host_sample_syncs",
           "host_sampled_edges")


def _graphs():
    return j_graph(**GRAPH), t_graph(**GRAPH)


def _plans(gj, gt):
    return (j_build_plan(gj, j_topo("dgx-v100", 4), **PLAN),
            t_build_plan(gt, t_topo("dgx-v100", 4), **PLAN))


@pytest.fixture(scope="module")
def setup():
    gj, gt = _graphs()
    pj, pt = _plans(gj, gt)
    assert pt.partition.cliques == pj.partition.cliques == [[0, 1], [2, 3]]
    return gj, pj, gt, pt


def _np(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_bitwise(a, b, what=""):
    """Same shape, type and bits; an int64 array of the port may equal an
    int32 one of the reference (JAX keeps 32-bit integers unless x64 is
    on), value for value."""
    a, b = _np(a), _np(b)
    same_kind = a.dtype == b.dtype or (a.dtype.kind == b.dtype.kind == "i"
                                       and a.dtype == np.int64)
    assert a.shape == b.shape and same_kind, (what, a.shape, b.shape,
                                              a.dtype, b.dtype)
    if a.dtype.kind == "f":
        a, b = a.view(np.uint32), b.view(np.uint32)
    np.testing.assert_array_equal(a, b, err_msg=what)


# ---- residency -----------------------------------------------------------

@pytest.mark.parametrize("ci", [0, 1])
def test_shard_routing_and_sharded_residency_match_reference(setup, ci):
    _, pj, _, pt = setup
    cj, ct = pj.caches[ci], pt.caches[ci]
    for a, b in zip(cj.shard_routing(), ct.shard_routing()):
        _assert_bitwise(a, b, "routing")
    assert ct.shard_row_count() == cj.shard_row_count() > 0
    sj = cj.sharded_device_arrays()
    st = ct.sharded_device_arrays(devices="cpu")
    assert set(st) == set(sj)
    for k in sj:
        # one tensor per clique position: a shard each, or (the routing
        # tables) a copy on each position's card
        assert len(st[k]) == len(ct.devices)
        got = st[k][0] if k in PER_CARD else torch.stack(st[k])
        _assert_bitwise(got, sj[k], k)
    # the topology shards are uploaded anew, not views of the flat stacks
    da = ct.device_arrays()
    for k in ("topo_shard_indptr", "topo_shard_indices"):
        assert torch.equal(torch.stack(st[k]), da[k])
        assert not {t.untyped_storage().data_ptr() for t in st[k]} & {
            da[k].untyped_storage().data_ptr()}


# ---- the routed kernels' plain versions ---------------------------------

@pytest.mark.parametrize("k,R,D,n", [(2, 12, 32, 50), (4, 7, 100, 33),
                                     (1, 5, 128, 9)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_routed_gather_plain_matches_reference_dense(k, R, D, n, dtype):
    """Misses, owners and slots past the end, negative slots: the plain
    version clamps exactly as the reference's XLA oracle does."""
    rng = np.random.default_rng(k * 100 + D)
    shards = torch.from_numpy(rng.standard_normal((k, R, D),
                                                  dtype=np.float32)).to(dtype)
    owner = rng.integers(-2, k + 2, size=n).astype(np.int32)
    local = rng.integers(-3, R + 3, size=n).astype(np.int32)
    got = gather.routed_gather(list(shards), torch.from_numpy(owner),
                               torch.from_numpy(local))
    if dtype == torch.bfloat16:
        jshards = jnp.asarray(shards.view(torch.int16).numpy()
                              .view(jnp.bfloat16))
    else:
        jshards = jnp.asarray(shards.numpy())
    want = np.asarray(jref.routed_gather_dense(jshards, jnp.asarray(owner),
                                               jnp.asarray(local)))
    assert got.dtype == dtype and tuple(got.shape) == (n, D)
    bits = got.view(torch.int16) if dtype == torch.bfloat16 else got
    np.testing.assert_array_equal(bits.numpy(), want.view(bits.numpy().dtype))
    assert (got[torch.from_numpy(owner < 0)] == 0).all()
    # the dense form over (k, n) routing, as the reference's oracle takes it
    o2, l2 = owner.reshape(1, n), local.reshape(1, n)
    got2 = tref.routed_gather_dense(shards, torch.from_numpy(o2),
                                    torch.from_numpy(l2))
    assert torch.equal(got2[0], got)


@pytest.mark.parametrize("seed", [0, 1])
def test_routed_neighbor_sample_plain_matches_reference_dense(setup, seed):
    """On a real plan's sharded topology: the plain version equals the
    reference's oracle bit for bit (out-of-range routing and draws near
    2^31 included), and on owned rows the host sampler on the same draws."""
    gj, pj, gt, pt = setup
    cache = pt.caches[seed]
    rng = np.random.default_rng(seed)
    n, f = 200, 5
    seeds = rng.integers(0, gt.n, size=n)
    owner = cache.topo_owner[seeds].astype(np.int32)
    local = cache.topo_local[seeds].astype(np.int32)
    owner[:3] = [len(cache.devices) + 1, -1, 0]
    local[:3] = [2, 0, cache.topo_shard_indptr.shape[1] + 4]
    rand = rng.integers(0, 1 << 31, size=(n, f), dtype=np.int64)
    rand[5] = (1 << 31) - 1
    ip, ix = cache.topo_shard_indptr, cache.topo_shard_indices
    got = gather.routed_neighbor_sample(
        torch.from_numpy(ip).unbind(0), torch.from_numpy(ix).unbind(0),
        torch.from_numpy(owner), torch.from_numpy(local),
        torch.from_numpy(rand))
    want = np.asarray(jref.routed_neighbor_sample_dense(
        jnp.asarray(ip), jnp.asarray(ix), jnp.asarray(owner),
        jnp.asarray(local), jnp.asarray(rand)))
    assert got.dtype == torch.int32 and tuple(got.shape) == (n, f)
    np.testing.assert_array_equal(got.numpy(), want)
    own = np.flatnonzero(cache.topo_owner[seeds] >= 0)[3:]
    host = j_host_sample_level(gj, seeds[own], f, None, rand=rand[own])
    np.testing.assert_array_equal(got.numpy()[own], host)
    assert (got.numpy()[1] == -1).all()


def test_device_sampling_routes_through_the_exchange(setup):
    """A sharded topology cache samples every hop through
    ``routed_neighbor_sample`` (on the CPU its plain version, no launch),
    bitwise like the reference's device sampler."""
    gj, pj, gt, pt = setup
    cj, ct = pj.caches[1], pt.caches[1]
    rng = np.random.default_rng(3)
    seeds = np.concatenate([rng.integers(0, gt.n, 60), [-1, -1]])
    rand = rng.integers(0, 1 << 31, size=(len(seeds), 4))
    calls = []
    orig = gather.routed_neighbor_sample

    def spy(*args):
        calls.append(args[2].shape)
        return orig(*args)

    gather.routed_neighbor_sample = spy
    try:
        before = gather.SAMPLE_KERNEL.launches
        out_t, hit_t = ct.device_sample_cached(seeds, 4, rand=rand)
    finally:
        gather.routed_neighbor_sample = orig
    out_j, hit_j = cj.device_sample_cached(seeds, 4, rand=rand)
    assert calls == [torch.Size([len(seeds)])]
    assert gather.SAMPLE_KERNEL.launches == before
    np.testing.assert_array_equal(out_t.numpy(), np.asarray(out_j))
    np.testing.assert_array_equal(hit_t.numpy(), np.asarray(hit_j))
    assert not hit_t[-2:].any() and (out_t[-2:] == -1).all()


# ---- specs, pack and the per-position batch -----------------------------

def _sharded_specs(setup, step_seed: int):
    """One synchronized step's specs in both packages: per device, the
    same seeds and draws (a generator per device and package)."""
    gj, pj, gt, pt = setup
    js, ts = [], []
    for ci, clique in enumerate(pt.partition.cliques):
        gr_j, gr_t = [], []
        for d in clique:
            tab = pt.partition.tablets[d]
            seeds = tab[np.random.default_rng(d).integers(0, len(tab), 16)]
            bj = JSharded(gj, pj.cache_for_device(d), FANOUTS, None, d,
                          gather="xla")
            bt = ShardedBatchBuilder(gt, pt.cache_for_device(d), FANOUTS,
                                     None, d, device="cpu")
            gr_j.append(bj.build_spec(
                seeds, np.random.default_rng(step_seed + d)))
            gr_t.append(bt.build_spec(
                seeds, np.random.default_rng(step_seed + d)))
        js.append(gr_j)
        ts.append(gr_t)
    return js, ts


def test_sharded_specs_and_pack_match_reference(setup):
    js, ts = _sharded_specs(setup, 40)
    for gr_j, gr_t in zip(js, ts):
        for sj, st in zip(gr_j, gr_t):
            for k in ("ids", "cache_pos", "hit", "miss_inv", "owner",
                      "local_slot"):
                _assert_bitwise(getattr(st, k), getattr(sj, k), k)
            assert (st.n_ids, st.n_miss, st.cache_epoch) == \
                (sj.n_ids, sj.n_miss, sj.cache_epoch)
            n = st.n_ids
            assert ((st.owner[:n] >= 0) == st.hit[:n]).all()
    D = GRAPH["feat_dim"]
    pj_, pt_ = j_pack(js, D, bucket=64), t_pack(ts, D, bucket=64)
    assert set(pt_) == set(pj_)
    for k in pj_:
        _assert_bitwise(pt_[k], pj_[k], k)
    assert pt_["owner"].shape[:2] == (2, 2)
    # the routing really spans both shards of each clique
    for ci in range(2):
        for gi in range(2):
            assert {0, 1} <= set(np.unique(pt_["owner"][ci, gi]).tolist())


def test_pack_rejects_mixed_epochs_and_ragged_groups(setup):
    _, ts = _sharded_specs(setup, 50)
    with pytest.raises(ValueError, match="ragged"):
        t_pack([ts[0], ts[1][:1]], GRAPH["feat_dim"])
    ts[0][1].cache_epoch = 7
    with pytest.raises(ValueError, match="cache epochs"):
        t_pack(ts, GRAPH["feat_dim"])


def test_sharded_position_batches_match_reference_device_batches(setup):
    """Each mesh position's batch (routed gather + miss rows + positioning)
    equals the reference device backend's fused finalize of the same
    spec, bit for bit (its ``feats`` are what the reference's sharded step
    computes: see ``routed_gather.cu`` on -0.0)."""
    gj, pj, gt, pt = setup
    js, ts = _sharded_specs(setup, 60)
    D = GRAPH["feat_dim"]
    packed = t_pack(ts, D, bucket=64)
    epochs = [int(e) for e in packed.pop("cache_epochs")]
    shards = [c.sharded_device_arrays(e)["feat_shards"]
              for c, e in zip(pt.caches, epochs)]
    parts = position_parts(packed, t_mesh(pt.partition.cliques,
                                          devices=["cpu"] * 4))
    for ci, clique in enumerate(pt.partition.cliques):
        for gi, d in enumerate(clique):
            got = sharded_position_batch(shards[ci], parts[ci, gi], D)
            bj = JDevice(gj, pj.cache_for_device(d), FANOUTS, None, d,
                         gather="xla")
            tab = pt.partition.tablets[d]
            seeds = tab[np.random.default_rng(d).integers(0, len(tab), 16)]
            want = bj.build(seeds, np.random.default_rng(60 + d))
            assert set(got) == set(want)
            for k in want:
                _assert_bitwise(got[k], want[k], f"{k} at ({ci}, {gi})")


def test_routing_and_stack_resolved_once_per_epoch(setup):
    """The sharded builder reads the routing and uploads the shard stack
    once per cache epoch, on the build thread; a refresh re-derives them
    once."""
    _, _, gt, _ = setup
    plan = t_build_plan(gt, t_topo("nv2", 2), mem_per_device=200_000,
                        batch_size=64, seed=0, fanouts=FANOUTS)
    cache = plan.cache_for_device(0)
    calls = {"routing": 0, "stack": 0}
    orig_routing, orig_stack = cache.shard_routing, \
        cache.sharded_device_arrays

    def counting_routing():
        calls["routing"] += 1
        return orig_routing()

    def counting_stack(epoch=None, devices=None):
        calls["stack"] += 1
        return orig_stack(epoch, devices)

    cache.shard_routing = counting_routing
    cache.sharded_device_arrays = counting_stack
    b = make_batch_builder("sharded", gt, cache, FANOUTS, None, 0,
                           device="cpu")
    rng = np.random.default_rng(0)
    tablet = plan.partition.tablets[0]
    b.build_spec(tablet[rng.integers(0, len(tablet), 32)], rng)
    base = dict(calls)
    assert base["routing"] >= 1 and base["stack"] >= 1
    for _ in range(3):
        b.build_spec(tablet[rng.integers(0, len(tablet), 32)], rng)
    assert calls == base
    cache.begin_epoch()
    cache.apply_feature_delta(cache.feat_ids[:2].copy(),
                              np.asarray([], np.int64),
                              np.asarray([], np.int32))
    b.build_spec(tablet[rng.integers(0, len(tablet), 32)], rng)
    assert calls["routing"] > base["routing"]
    after = dict(calls)
    b.build_spec(tablet[rng.integers(0, len(tablet), 32)], rng)
    assert calls == after


def test_sharded_epoch_pinning(setup):
    """The partitioned shards keep the flat arrays' double-buffer contract:
    specs built before a refresh finalize against the shards they indexed,
    which stay alive; two refreshes back raises
    (``tests/_sharded_checks.py``)."""
    _, _, gt, _ = setup
    plan = t_build_plan(gt, t_topo("nv8", 4), mem_per_device=200_000,
                        batch_size=256, seed=0)
    cache = plan.caches[0]
    e0 = cache.epoch
    live = cache.sharded_device_arrays(devices="cpu")["feat_shards"]
    old = [t.clone() for t in live]
    cache.begin_epoch()
    cache.apply_feature_delta(cache.feat_ids[:2].copy(),
                              np.asarray([], np.int64),
                              np.asarray([], np.int32))
    pinned = cache.sharded_device_arrays(e0)["feat_shards"]
    assert pinned is live
    assert all(torch.equal(a, b) for a, b in zip(pinned, old))
    new = cache.sharded_device_arrays()["feat_shards"]
    assert len(new) == 4 and not {t.data_ptr() for t in new} & {
        t.data_ptr() for t in live}
    cache.replace_topology(cache.topo_ids_per_dev)
    sa, da = cache.sharded_device_arrays(), cache.device_arrays()
    assert torch.equal(torch.stack(sa["topo_shard_indices"]),
                       da["topo_shard_indices"])
    cache.begin_epoch()
    with pytest.raises(RuntimeError, match="in sharded form"):
        cache.sharded_device_arrays(e0)


# ---- the mesh and the executor's validation ----------------------------

@pytest.mark.parametrize("cliques,n_dev", [([], 0), ([[0], [1, 2]], 3),
                                           ([[]], 0), ([[0, 1], [2, 3]], 3)])
def test_mesh_errors_match_reference(cliques, n_dev):
    jdevs = [jax.devices()[0]] * n_dev if cliques == [[0, 1], [2, 3]] \
        else None
    with pytest.raises(ValueError) as want:
        j_mesh(cliques, devices=jdevs)
    with pytest.raises(ValueError) as got:
        t_mesh(cliques, devices=["cpu"] * n_dev)
    assert str(got.value) == str(want.value)


def test_mesh_binds_positions_in_clique_major_order():
    m = t_mesh([[2, 0], [3, 1]], devices=["cpu"] * 4)
    assert m.shape == (2, 2) and m.axis_names == ("pod", "clique")
    assert list(m.positions()) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert m.device(1, 1) == torch.device("cpu")


def _ragged_topo():
    """A degraded box: one 4-clique plus one 2-clique (6 devices)."""
    adj = np.zeros((6, 6), dtype=bool)
    adj[:4, :4] = ~np.eye(4, dtype=bool)
    adj[4, 5] = adj[5, 4] = True
    return adj


@pytest.mark.parametrize("case", ["ragged", "partial_one", "partial_three",
                                  "mesh", "compress_grads"])
def test_sharded_rejects_what_the_mesh_cannot_run(setup, case):
    _, _, gt, pt = setup
    cfg = GNNConfig(**CFG)
    kw, match = {}, None
    if case == "ragged":
        plan = t_build_plan(gt, _ragged_topo(), mem_per_device=30_000,
                            batch_size=64, seed=0, fanouts=FANOUTS)
        match = "uniform clique sizes"
    else:
        plan = pt
        if case == "partial_one":
            kw, match = {"devices": [0]}, "partially cover"
        elif case == "partial_three":
            kw, match = {"devices": [0, 1, 2]}, "partially cover"
        elif case == "mesh":
            kw, match = {"mesh": object()}, "does not compose"
        else:
            kw, match = {"compress_grads": True}, "does not compose"
    with pytest.raises(ValueError, match=match):
        train_gnn(gt, plan, cfg, steps=1, device="cpu", backend="sharded",
                  **kw)


def test_one_clique_and_planless_runs(setup):
    """One whole clique is the K_c = 1 mesh (any device order); a run
    without a plan falls back to the host pipeline, as in the reference."""
    _, _, gt, _ = setup
    _, pt = _plans(*_graphs())
    cfg = GNNConfig(**CFG)
    res = train_gnn(gt, pt, cfg, steps=2, seed=0, device="cpu",
                    backend="sharded", devices=[3, 2])
    assert res.backend == "sharded" and len(res.losses) == 2
    assert np.isfinite(res.losses).all()
    planless = train_gnn(gt, None, cfg, steps=1, device="cpu",
                         backend="sharded")
    assert planless.backend == "host" and len(planless.losses) == 1


# ---- train_gnn against the reference ----------------------------------

@pytest.fixture(scope="module")
def runs():
    """The reference's device backend and the port's device and sharded
    backends (twice), fresh plans each (a refresh mutates its plan), from
    the reference's initial parameters."""
    p0 = j_init(j_defs(JConfig(**CFG)), jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, p0), "cpu")
    out = {}
    gj, gt = _graphs()
    pj = j_build_plan(gj, j_topo("dgx-v100", 4), **PLAN)
    from repro.core.unified_cache import TrafficCounter as JCounter
    cj = JCounter.for_plan(pj)
    out["ref_device"] = (j_train(gj, pj, JConfig(**CFG), steps=STEPS,
                                 seed=0, backend="device", counter=cj,
                                 refresh_config=JRefresh(**REFRESH)), cj)
    for name, backend in (("device", "device"), ("sharded", "sharded"),
                          ("sharded2", "sharded")):
        _, pt = _plans(gj, gt)
        c = TrafficCounter.for_plan(pt)
        out[name] = (train_gnn(gt, pt, GNNConfig(**CFG), steps=STEPS, seed=0,
                               backend=backend, device="cpu", params=params,
                               counter=c,
                               refresh_config=RefreshConfig(**REFRESH)),
                     c, pt)
    out["params"] = params
    return out


def test_train_gnn_sharded_matches_reference_device(runs):
    want, wc = runs["ref_device"]
    got, gc, plan = runs["sharded"]
    assert got.backend == "sharded" and got.steps == STEPS
    np.testing.assert_allclose(got.losses, want.losses, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.accs, want.accs, rtol=0, atol=1e-6)
    for name in TALLIES:
        assert getattr(gc, name) == getattr(wc, name), name
    np.testing.assert_array_equal(gc.bytes_matrix, wc.bytes_matrix)
    np.testing.assert_array_equal(gc.topo_bytes_matrix, wc.topo_bytes_matrix)
    assert got.refresh == want.refresh  # events and overlaps, exactly
    cliques = plan.partition.cliques
    assert gc.cross_clique_bytes(cliques) == 0
    assert gc.cross_clique_topo_bytes(cliques) == 0
    assert all(s["peer_bytes"] > 0 for s in gc.per_clique_split(cliques))
    # per-clique refresh: both cliques refreshed, each on its own epoch
    admitted = {e["clique"] for e in got.refresh["events"] if e["admitted"]}
    assert admitted == {0, 1}
    assert [c.epoch for c in plan.caches] == [1, 1]
    assert got.pipeline["host_pack_s_total"] > 0
    assert got.pipeline["batches_built"] == STEPS


def test_sharded_is_bitwise_repeatable_and_near_the_port_device(runs):
    s1, s2, dev = runs["sharded"][0], runs["sharded2"][0], runs["device"][0]
    assert s1.losses == s2.losses and s1.accs == s2.accs
    np.testing.assert_allclose(s1.losses, dev.losses, rtol=0, atol=1e-4)
    assert s1.refresh == dev.refresh
    np.testing.assert_array_equal(runs["sharded"][1].bytes_matrix,
                                  runs["device"][1].bytes_matrix)


def test_cliques_refresh_independently_on_their_own_epochs(runs):
    """A drift threshold between the two cliques' overlaps at step 4 (0.757
    and 0.774): only clique 0 refreshes, so from step 4 on every step
    combines epoch 1 of clique 0 with epoch 0 of clique 1, and the losses
    still follow the reference's device backend."""
    refresh = dict(REFRESH, drift_threshold=0.765)
    gj, gt = _graphs()
    pj, pt = _plans(gj, gt)
    want = j_train(gj, pj, JConfig(**CFG), steps=STEPS, seed=0,
                   backend="device", refresh_config=JRefresh(**refresh))
    got = train_gnn(gt, pt, GNNConfig(**CFG), steps=STEPS, seed=0,
                    backend="sharded", device="cpu", params=runs["params"],
                    refresh_config=RefreshConfig(**refresh))
    assert got.refresh == want.refresh
    assert [e["clique"] for e in got.refresh["events"]] == [0]
    assert [c.epoch for c in pt.caches] == [1, 0]
    np.testing.assert_allclose(got.losses, want.losses, rtol=0, atol=1e-4)


_REFERENCE_SHARDED = """
import json, sys
import numpy as np
sys.path.insert(0, sys.argv[1])
from repro.core.cliques import topology_matrix
from repro.core.planner import build_plan
from repro.core.unified_cache import TrafficCounter
from repro.graph.csr import powerlaw_graph
from repro.models.gnn import GNNConfig
from repro.train.loop import train_gnn
cfg = json.loads(sys.argv[2])
g = powerlaw_graph(**cfg["graph"])
plan = build_plan(g, topology_matrix("dgx-v100", 4), **cfg["plan"])
c = TrafficCounter.for_plan(plan)
res = train_gnn(g, plan, GNNConfig(**cfg["model"]), steps=cfg["steps"],
                seed=0, backend="sharded", gather="xla", counter=c)
print(json.dumps({"losses": res.losses, "accs": res.accs,
                  "backend": res.backend,
                  "cross": c.cross_clique_bytes(plan.partition.cliques),
                  "bytes": c.bytes_matrix.tolist()}))
"""


def test_reference_sharded_executor_agrees_with_the_port():
    """The reference's own ``backend="sharded"`` (``shard_map`` over a
    forced four-device CPU mesh, in a subprocess) and the port's: losses
    within atol 1e-4, traffic matrices equal."""
    steps = 4
    cfg = {"graph": GRAPH,
           "plan": dict(PLAN, fanouts=list(FANOUTS)),
           "model": dict(CFG, fanouts=list(FANOUTS)), "steps": steps}
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count"
                                     "=4", JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _REFERENCE_SHARDED,
                          str(ROOT / "src"), json.dumps(cfg)], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    want = json.loads(out.stdout.strip().splitlines()[-1])
    assert want["backend"] == "sharded" and want["cross"] == 0
    p0 = j_init(j_defs(JConfig(**CFG)), jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, p0), "cpu")
    _, gt = _graphs()
    _, pt = _plans(*_graphs())
    c = TrafficCounter.for_plan(pt)
    got = train_gnn(gt, pt, GNNConfig(**CFG), steps=steps, seed=0,
                    backend="sharded", device="cpu", params=params,
                    counter=c)
    np.testing.assert_allclose(got.losses, want["losses"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.accs, want["accs"], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(c.bytes_matrix, np.asarray(want["bytes"]))
