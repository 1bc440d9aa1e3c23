"""Online cache refresh in the port against the reference package's: the
refresh writers (``apply_feature_delta``, ``replace_topology``) leave host
mirrors, the new epoch's device table, the retained epoch and the topology
arrays bitwise equal to the reference's; the delta replan gives the same
targets; a drift loop (training pool A, then traffic from pool B) refreshes
both packages' caches identically and their batches stay bitwise equal; and
the manager's state round-trips.  Everything runs with ``device="cpu"``,
where the refresh's scatter takes its plain version."""
import numpy as np
import pytest
import torch

from repro.core.cache_manager import OnlineCacheManager as JManager
from repro.core.cache_manager import RefreshConfig as JRefresh
from repro.core.cliques import topology_matrix as j_topo
from repro.core.planner import build_plan as j_build_plan
from repro.core.planner import replan_cache_from_hotness as j_replan
from repro.core.unified_cache import TrafficCounter as JCounter
from repro.graph.csr import CSRGraph as JGraph
from repro.graph.csr import powerlaw_graph as j_graph
from repro.train.batch import DeviceBatchBuilder as JDevice
from repro_torch.core.cache_manager import OnlineCacheManager, RefreshConfig
from repro_torch.core.cliques import topology_matrix as t_topo
from repro_torch.core.planner import build_plan as t_build_plan
from repro_torch.core.planner import replan_cache_from_hotness
from repro_torch.core.unified_cache import TrafficCounter
from repro_torch.graph.csr import CSRGraph as TGraph
from repro_torch.graph.csr import powerlaw_graph as t_graph
from repro_torch.kernels import scatter
from repro_torch.train.batch import DeviceBatchBuilder, HostBatchBuilder

FANOUTS = (4, 3)
TOPO_KEYS = ("cache_indptr", "cache_indices", "topo_pos", "topo_owner",
             "topo_local", "topo_shard_indptr", "topo_shard_indices")
COUNTER_TALLIES = ("pcie_transactions", "feature_requests", "feature_hits",
                   "topo_requests", "topo_hits", "host_sampled_edges")


def two_community_graph(graph_fn, csr_cls, n_half, avg_degree, seed=0,
                        feat_dim=32):
    """Two disjoint power-law communities (``tests/test_cache_manager.py``),
    built with one package's graph types."""
    a = graph_fn(n_half, avg_degree, seed=seed, feat_dim=feat_dim)
    b = graph_fn(n_half, avg_degree, seed=seed + 1, feat_dim=feat_dim)
    indptr = np.concatenate([a.indptr, a.indptr[-1] + b.indptr[1:]])
    indices = np.concatenate([a.indices,
                              (b.indices + n_half).astype(np.int32)])
    return csr_cls(indptr=indptr, indices=indices, n=2 * n_half,
                   feat_dim=feat_dim, seed=seed)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_arrays_equal(dj: dict, dt: dict, keys):
    for k in keys:
        if k in dj or k in dt:
            np.testing.assert_array_equal(_np(dj[k]), _np(dt[k]), err_msg=k)


@pytest.fixture
def plans():
    kw = dict(mem_per_device=500_000, batch_size=128, seed=0)
    gj = j_graph(3000, 8, seed=9, feat_dim=32)
    gt = t_graph(3000, 8, seed=9, feat_dim=32)
    return (gj, j_build_plan(gj, j_topo("nv2", 2), **kw),
            gt, t_build_plan(gt, t_topo("nv2", 2), **kw))


def test_apply_feature_delta_and_replace_topology_match_reference(plans):
    gj, pj, gt, pt = plans
    cj, ct = pj.caches[0], pt.caches[0]
    da_j, da_t = cj.device_arrays(), ct.device_arrays(device="cpu")
    old_table = da_t["feat_cache"].clone()
    n_swap = 16
    evict = ct.feat_ids[:n_swap].copy()
    admit = np.setdiff1d(np.arange(gt.n), ct.feat_ids)[:n_swap]
    owner = (np.arange(n_swap) % 2).astype(np.int32)
    assert cj.begin_epoch() == ct.begin_epoch() == 1
    info_j = cj.apply_feature_delta(evict, admit, owner)
    info_t = ct.apply_feature_delta(evict, admit, owner)
    assert info_j == info_t == {"evicted": n_swap, "admitted": n_swap,
                                "bytes_h2d": n_swap * gt.feat_dim * 4}
    for k in ("feat_ids", "feat_pos", "feat_owner", "feat_cache"):
        np.testing.assert_array_equal(getattr(cj, k), getattr(ct, k),
                                      err_msg=k)
    new_j, new_t = cj.device_arrays(1), ct.device_arrays(1)
    _assert_arrays_equal(new_j, new_t, ("feat_cache", "feat_pos"))
    pos = ct.feat_pos[admit]
    np.testing.assert_array_equal(new_t["feat_cache"][pos].numpy(),
                                  gt.get_features(admit))
    # the retained epoch is bit-unchanged, and is not the host mirror
    assert torch.equal(ct.device_arrays(0)["feat_cache"], old_table)
    _assert_arrays_equal(cj.device_arrays(0), ct.device_arrays(0),
                         ("feat_cache", "feat_pos"))
    assert not np.shares_memory(ct.device_arrays(1)["feat_pos"].numpy(),
                                ct.feat_pos)

    # topology: a new planned id set joins the *current* epoch only
    topo_new = [ids[len(ids) // 2:] for ids in ct.topo_ids_per_dev]
    topo_new[0] = np.concatenate([topo_new[0], np.setdiff1d(
        np.arange(200), np.concatenate(ct.topo_ids_per_dev))])
    old_topo = {k: v.clone() for k, v in ct.device_arrays(0).items()}
    cj.replace_topology(topo_new)
    ct.replace_topology(topo_new)
    for k in TOPO_KEYS:
        np.testing.assert_array_equal(getattr(cj, k), getattr(ct, k),
                                      err_msg=k)
    _assert_arrays_equal(cj.device_arrays(1), ct.device_arrays(1),
                         TOPO_KEYS)
    assert ct.device_arrays(1).keys() == old_topo.keys()
    for k, v in ct.device_arrays(0).items():
        assert torch.equal(v, old_topo[k]), k
    for a, b in zip(cj.feat_ids_by_device(), ct.feat_ids_by_device()):
        np.testing.assert_array_equal(a, b)

    # a second rotation releases the retained epoch
    cj.begin_epoch()
    ct.begin_epoch()
    cj.apply_feature_delta(admit[:1], evict[:1], np.zeros(1, np.int32))
    ct.apply_feature_delta(admit[:1], evict[:1], np.zeros(1, np.int32))
    _assert_arrays_equal(cj.device_arrays(2), ct.device_arrays(2),
                         ("feat_cache", "feat_pos"))
    with pytest.raises(RuntimeError, match="no longer resident"):
        ct.device_arrays(0)


def test_empty_admission_shares_the_table_and_launches_nothing(plans):
    _, _, _, pt = plans
    cache = pt.caches[0]
    table = cache.device_arrays(device="cpu")["feat_cache"]
    launches = scatter.KERNEL.launches
    cache.begin_epoch()
    info = cache.apply_feature_delta(np.zeros(0, np.int64),
                                     np.zeros(0, np.int64),
                                     np.zeros(0, np.int32))
    assert info["admitted"] == 0
    assert cache.device_arrays()["feat_cache"] is table
    assert scatter.KERNEL.launches == launches


def test_host_only_refresh_stays_lazy(plans):
    """Before any upload, a rotation only bumps the epoch id and the
    refresh writes the host mirrors only."""
    _, _, gt, pt = plans
    cache = pt.caches[0]
    assert cache.begin_epoch() == 1 and cache._device_arrays is None
    evict = cache.feat_ids[:4].copy()
    admit = np.setdiff1d(np.arange(gt.n), cache.feat_ids)[:4]
    cache.apply_feature_delta(evict, admit, np.zeros(4, np.int32))
    assert cache._device_arrays is None
    np.testing.assert_array_equal(cache.extract_features(admit, 0, None),
                                  gt.get_features(admit))


def test_replan_cache_from_hotness_matches_reference(plans):
    gj, pj, gt, pt = plans
    rj = j_replan(gj, pj, 0, pj.stats[0])
    rt = replan_cache_from_hotness(gt, pt, 0, pt.stats[0])
    for a, b in zip(rj[2] + rj[3], rt[2] + rt[3]):
        np.testing.assert_array_equal(a, b)
    assert rj[1]["alpha"] == rt[1]["alpha"]
    # unchanged hotness: the targets reproduce the cache's contents
    for a, b in zip(rt[2], pt.caches[0].feat_ids_by_device()):
        np.testing.assert_array_equal(np.sort(a), np.sort(b))


def _drift_setup():
    gj = two_community_graph(j_graph, JGraph, 1500, 8, seed=2)
    gt = two_community_graph(t_graph, TGraph, 1500, 8, seed=2)
    rng0 = np.random.default_rng(0)
    pool_a = np.sort(rng0.choice(gt.n // 2, 300, replace=False))
    pool_b = np.sort(gt.n // 2 + rng0.choice(gt.n // 2, 300, replace=False))
    kw = dict(mem_per_device=0.2 * gt.n * gt.feat_dim * 4,
              train_vertices=pool_a, batch_size=128, seed=0,
              fanouts=FANOUTS)
    return (gj, j_build_plan(gj, j_topo("nv2", 2), **kw),
            gt, t_build_plan(gt, t_topo("nv2", 2), **kw), pool_b)


def test_drift_loop_refreshes_like_the_reference_with_bitwise_batches():
    """Pool A -> pool B drift: both packages' managers refresh at the same
    steps with the same overlaps and deltas, the device batches stay
    bitwise equal (to each other and to the port's host builder), and the
    counters agree."""
    gj, pj, gt, pt, pool_b = _drift_setup()
    cfg = dict(interval=4, drift_threshold=0.97)
    cj, ct, ch = (JCounter.for_plan(pj), TrafficCounter.for_plan(pt),
                  TrafficCounter.for_plan(pt))
    mj = JManager(gj, pj, JRefresh(**cfg), counter=cj)
    mt = OnlineCacheManager(gt, pt, RefreshConfig(**cfg), counter=ct)
    bj = JDevice(gj, pj.cache_for_device(0), FANOUTS, cj, 0, gather="xla",
                 observer=mj.observer_for(0))
    bt = DeviceBatchBuilder(gt, pt.cache_for_device(0), FANOUTS, ct, 0,
                            device="cpu", observer=mt.observer_for(0))
    bh = HostBatchBuilder(gt, pt.cache_for_device(0), FANOUTS, ch, 0,
                          device="cpu")
    rngs = [np.random.default_rng(7) for _ in range(3)]
    for step in range(1, 13):
        mj.on_step(step)
        mt.on_step(step)
        seeds = pool_b[np.random.default_rng(100 + step).integers(
            0, len(pool_b), 64)]
        batch_j = bj.build(seeds, rngs[0])
        batch_t = bt.build(seeds, rngs[1])
        batch_h = bh.build(seeds, rngs[2])
        assert batch_j.keys() == batch_t.keys() == batch_h.keys()
        for k in batch_j:
            np.testing.assert_array_equal(np.asarray(batch_j[k]),
                                          batch_t[k].numpy(),
                                          err_msg=f"{step}/{k}")
            assert torch.equal(batch_t[k], batch_h[k]), f"{step}/{k}"
    sj, st = mj.summary(), mt.summary()
    assert st["refreshes"] >= 1 and st["admitted"] > 0  # it did refresh
    assert sj == st  # events included, overlaps compared exactly
    for name in COUNTER_TALLIES:
        assert getattr(cj, name) == getattr(ct, name), name
    np.testing.assert_array_equal(cj.bytes_matrix, ct.bytes_matrix)
    np.testing.assert_array_equal(cj.topo_bytes_matrix, ct.topo_bytes_matrix)
    cache_j, cache_t = pj.caches[0], pt.caches[0]
    assert cache_j.epoch == cache_t.epoch
    for k in ("feat_ids", "feat_pos", "feat_owner") + TOPO_KEYS:
        np.testing.assert_array_equal(getattr(cache_j, k),
                                      getattr(cache_t, k), err_msg=k)
    _assert_arrays_equal(cache_j.device_arrays(), cache_t.device_arrays(),
                         ("feat_cache", "feat_pos") + TOPO_KEYS)


def test_state_dict_round_trips_and_reapplies_like_the_reference():
    gj, pj, gt, pt, pool_b = _drift_setup()
    cfg = dict(interval=4, drift_threshold=0.0)  # observe, never refresh
    mj = JManager(gj, pj, JRefresh(**cfg))
    mt = OnlineCacheManager(gt, pt, RefreshConfig(**cfg))
    bj = JDevice(gj, pj.cache_for_device(0), FANOUTS, None, 0, gather="xla",
                 observer=mj.observer_for(0))
    bt = DeviceBatchBuilder(gt, pt.cache_for_device(0), FANOUTS, None, 0,
                            device="cpu", observer=mt.observer_for(0))
    rng_j, rng_t = np.random.default_rng(3), np.random.default_rng(3)
    for step in range(1, 10):
        mj.on_step(step)
        mt.on_step(step)
        seeds = pool_b[np.random.default_rng(step).integers(0, 300, 64)]
        bj.build_spec(seeds, rng_j)
        bt.build_spec(seeds, rng_t)
    state = mt.state_dict()
    assert mt.stats.checks == 1 and mt.stats.refreshes == 0
    assert state["obs"][0]["batches"] == 2  # mid-window accumulators
    # round trip into a fresh manager over the same plan, without reapply
    fresh = OnlineCacheManager(gt, pt, RefreshConfig(**cfg))
    assert fresh.load_state_dict(state, reapply=False) == 0
    again = fresh.state_dict()
    assert again["cliques"] == state["cliques"]
    assert again["stats"] == state["stats"]
    for a, b in zip(again["blended"] + again["obs"],
                    state["blended"] + state["obs"]):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    # reapply recovers the learned hot set, as the reference's does
    assert mt.load_state_dict(state, reapply=True) == \
        mj.load_state_dict(mj.state_dict(), reapply=True) == 1
    for k in ("feat_ids", "feat_pos", "feat_owner"):
        np.testing.assert_array_equal(getattr(pj.caches[0], k),
                                      getattr(pt.caches[0], k), err_msg=k)
    with pytest.raises(ValueError, match="cliques"):
        bad = dict(state, cliques=[[0]])
        fresh.load_state_dict(bad)
