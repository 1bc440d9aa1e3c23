"""``CliqueCache`` of the port against the reference package's: device
sampling (single hop and the chained multi-hop form) gives identical
neighbors and hit masks for the same draws in both topology modes, the
cache-aware sampler equals the host sampler, traffic tallies are identical,
and the device upload copies the host mirrors."""
import numpy as np
import pytest
import torch

from repro.core.unified_cache import CliqueCache as JCache
from repro.core.unified_cache import TrafficCounter as JCounter
from repro.graph import sampling as jsampling
from repro.graph.csr import powerlaw_graph as j_graph
from repro_torch.core.unified_cache import CliqueCache as TCache
from repro_torch.core.unified_cache import TrafficCounter as TCounter
from repro_torch.graph import sampling as tsampling
from repro_torch.graph.csr import powerlaw_graph as t_graph

K = 4
FANOUTS = (5, 3)
MODES = ("sharded", "replicated")


def _ids(g, coverage=0.5):
    """Hottest-by-degree ``coverage`` fraction of vertices, split
    contiguously over K devices (as ``tests/test_topology_cache.py``)."""
    order = np.argsort(-(g.indptr[1:] - g.indptr[:-1]), kind="stable")
    ids = np.sort(order[: int(g.n * coverage)]).astype(np.int64)
    parts = np.array_split(ids, K)
    return [p[:8] for p in parts], parts


@pytest.fixture(scope="module")
def graphs():
    return (j_graph(3000, 8, seed=9, feat_dim=16),
            t_graph(3000, 8, seed=9, feat_dim=16))


def _caches(graphs, mode, coverage=0.5):
    gj, gt = graphs
    feat, topo = _ids(gj, coverage)
    tc = TCache(gt, list(range(K)), feat, topo, topology_mode=mode)
    tc.device_arrays(device="cpu")
    return JCache(gj, list(range(K)), feat, topo, topology_mode=mode), tc


@pytest.mark.parametrize("mode", MODES)
def test_device_sample_cached_identical(graphs, mode):
    jc, tc = _caches(graphs, mode)
    rng = np.random.default_rng(3)
    seeds = rng.integers(0, graphs[0].n, 96)
    seeds[::7] = -1
    rand = rng.integers(0, 1 << 31, size=(96, 5))
    oj, hj = jc.device_sample_cached(seeds, 5, rand=rand)
    ot, ht = tc.device_sample_cached(seeds, 5, rand=rand)
    assert ot.dtype == torch.int32 and ht.dtype == torch.bool
    np.testing.assert_array_equal(np.asarray(oj), ot.numpy())
    np.testing.assert_array_equal(np.asarray(hj), ht.numpy())
    assert ht.any() and not ht.all()


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("fanouts", [FANOUTS, (4,), (3, 2, 2)])
def test_device_sample_chain_identical(graphs, mode, fanouts):
    """The chain (in sharded mode one call of the chain kernel's plain
    version) against the reference's per-hop chain, for 1 to 3 hops."""
    jc, tc = _caches(graphs, mode)
    rng = np.random.default_rng(4)
    seeds = rng.integers(0, graphs[0].n, 40)
    seeds[::9] = -1
    rands, n = [], len(seeds)
    for f in fanouts:
        rands.append(rng.integers(0, 1 << 31, size=(n, f)))
        n *= f
    oj, hj = jc.device_sample_chain(seeds, fanouts, rands)
    ot, ht = tc.device_sample_chain(seeds, fanouts, rands)
    assert len(ot) == len(ht) == len(fanouts)
    for a, b in zip(oj, ot):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    for a, b in zip(hj, ht):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("chain", [True, False])
def test_cache_sampler_levels_masks_and_tallies_identical(graphs, mode,
                                                          chain):
    """Composed levels equal the host sampler's in both packages, the hit
    masks agree, and every TrafficCounter tally is identical."""
    gj, gt = graphs
    jc, tc = _caches(graphs, mode)
    seeds = np.random.default_rng(7).integers(0, gj.n, 64)
    host = tsampling.host_sample_batch(gt, seeds, FANOUTS,
                                       np.random.default_rng(1))
    cj, ct = JCounter.for_devices(range(K)), TCounter.for_devices(range(K))
    lj, mj = jsampling.cache_sample_batch(gj, jc, seeds, FANOUTS,
                                          np.random.default_rng(1),
                                          chain=chain, counter=cj)
    lt, mt = tsampling.cache_sample_batch(gt, tc, seeds, FANOUTS,
                                          np.random.default_rng(1),
                                          chain=chain, counter=ct)
    for a, b, h in zip(lj, lt, host):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(b, h)
    for a, b in zip(mj, mt):
        np.testing.assert_array_equal(a, b)
    for c, cache, lv in ((cj, jc, lj), (ct, tc, lt)):
        for lvl, f in zip(lv[:-1], FANOUTS):
            cache.sample_accounting(lvl.reshape(-1), f, c, 1)
        ids = tsampling.unique_vertices(lv)
        pos, hit = cache.split_hits(ids)
        cache.account_feature_gather(pos, hit, 1, c)
    for name in ("pcie_transactions", "feature_requests", "feature_hits",
                 "topo_requests", "topo_hits", "host_sample_syncs",
                 "host_sampled_edges"):
        assert getattr(cj, name) == getattr(ct, name), name
    np.testing.assert_array_equal(cj.bytes_matrix, ct.bytes_matrix)
    np.testing.assert_array_equal(cj.topo_bytes_matrix, ct.topo_bytes_matrix)
    assert ct.topo_hits > 0 and ct.feature_hits > 0


def test_empty_topology_cache_returns_all_miss(graphs):
    _, gt = graphs
    tc = TCache(gt, [0], [np.arange(5)], [np.zeros(0, np.int64)],
                topology_mode="replicated")
    tc.device_arrays(device="cpu")
    out, hit = tc.device_sample_cached(np.arange(6), 3,
                                       rand=np.zeros((6, 3), np.int64))
    assert out.shape == (6, 3) and (out == -1).all() and not hit.any()


def test_device_arrays_copy_host_mirrors_and_pin_device(graphs):
    _, tc = _caches(graphs, "sharded")
    da = tc.device_arrays()
    before = da["feat_cache"].clone()
    tc.feat_cache[:] += 1.0  # a refresh mutates the host mirror in place
    tc.feat_pos[:] = -5
    assert torch.equal(da["feat_cache"], before)
    assert (da["feat_pos"] != -5).any()
    assert da["topo_shard_indptr"].dtype == torch.int64
    with pytest.raises(RuntimeError, match="no longer resident"):
        tc.device_arrays(epoch=3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tc.device_arrays(device="cuda")


def test_cuda_default_raises_without_a_card(graphs):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    _, gt = graphs
    feat, topo = _ids(gt)
    tc = TCache(gt, list(range(K)), feat, topo)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tc.device_arrays()


def test_epoch_rotation_retains_one_previous_buffer(graphs):
    _, tc = _caches(graphs, "replicated")
    e0 = tc.epoch
    cur = tc.device_arrays()
    assert tc.begin_epoch() == e0 + 1
    assert tc.device_arrays(e0) is cur
    tc.begin_epoch()
    with pytest.raises(RuntimeError):
        tc.device_arrays(e0)
