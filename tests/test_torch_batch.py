"""Batch builders of the port against the reference package's: the device
spec (levels, ids, cache slots, hit mask, miss map, staged miss rows) and
the finalized batch tensors are bitwise equal to the reference
``DeviceBatchBuilder``'s, the port's host builder equals its device
builder, and the staging buffers never alias a finalized batch."""
import numpy as np
import pytest
import torch

from repro.core.cliques import topology_matrix as j_topo
from repro.core.planner import build_plan as j_build_plan
from repro.core.unified_cache import TrafficCounter as JCounter
from repro.graph.csr import powerlaw_graph as j_graph
from repro.train.batch import DeviceBatchBuilder as JDevice
from repro.train.batch import HostBatchBuilder as JHost
from repro_torch.core.cliques import topology_matrix as t_topo
from repro_torch.core.planner import build_plan as t_build_plan
from repro_torch.core.unified_cache import TrafficCounter as TCounter
from repro_torch.graph.csr import powerlaw_graph as t_graph
from repro_torch.train.batch import DeviceBatchBuilder as TDevice
from repro_torch.train.batch import HostBatchBuilder as THost
from repro_torch.train.batch import make_batch_builder

FANOUTS = (5, 3)
SPEC_ARRAYS = ("ids", "cache_pos", "hit", "miss_inv", "labels")


@pytest.fixture(scope="module")
def setup():
    gj = j_graph(4000, 10, seed=4, feat_dim=32)
    gt = t_graph(4000, 10, seed=4, feat_dim=32)
    kw = dict(mem_per_device=300_000, batch_size=64, fanouts=FANOUTS, seed=0)
    return (gj, j_build_plan(gj, j_topo("nv2"), **kw),
            gt, t_build_plan(gt, t_topo("nv2"), **kw))


def _assert_batches_equal(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        x = np.asarray(a[k])
        y = b[k].cpu().numpy() if isinstance(b[k], torch.Tensor) else b[k]
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(x, y, err_msg=k)


@pytest.mark.parametrize("dev,bucket", [(0, 256), (3, 64), (0, 672)])
def test_device_spec_and_batch_bitwise_equal_reference(setup, dev, bucket):
    gj, pj, gt, pt = setup
    cj, ct = JCounter.for_plan(pj), TCounter.for_plan(pt)
    bj = JDevice(gj, pj.cache_for_device(dev), FANOUTS, cj, dev,
                 gather="xla", bucket=bucket)
    bt = TDevice(gt, pt.cache_for_device(dev), FANOUTS, ct, dev,
                 device="cpu", bucket=bucket)
    rj, rt = np.random.default_rng(3), np.random.default_rng(3)
    for step in range(3):
        seeds = pt.partition.tablets[dev][step * 32:(step + 1) * 32]
        sj = bj.fill_spec(bj.sample_spec(seeds, rj))
        st = bt.fill_spec(bt.sample_spec(seeds, rt))
        for name in SPEC_ARRAYS:
            np.testing.assert_array_equal(getattr(sj, name),
                                          getattr(st, name), err_msg=name)
        for a, b in zip(sj.levels + sj.level_pos, st.levels + st.level_pos):
            np.testing.assert_array_equal(a, b)
        assert (sj.n_ids, sj.n_miss, sj.cache_epoch) == \
            (st.n_ids, st.n_miss, st.cache_epoch)
        assert st.miss_feats.dtype == torch.float32
        np.testing.assert_array_equal(sj.miss_feats, st.miss_feats.numpy())
        _assert_batches_equal(bj.finalize(sj), bt.finalize(st))
    for name in ("pcie_transactions", "feature_requests", "feature_hits",
                 "topo_requests", "topo_hits", "host_sample_syncs",
                 "host_sampled_edges"):
        assert getattr(cj, name) == getattr(ct, name), name
    np.testing.assert_array_equal(cj.bytes_matrix, ct.bytes_matrix)


def test_host_builder_equals_reference_and_device_builder(setup):
    gj, pj, gt, pt = setup
    seeds = pt.partition.tablets[0][:48]
    hj = JHost(gj, pj.cache_for_device(0), FANOUTS, JCounter.for_plan(pj), 0)
    ht = THost(gt, pt.cache_for_device(0), FANOUTS, TCounter.for_plan(pt), 0,
               device="cpu")
    dt = TDevice(gt, pt.cache_for_device(0), FANOUTS, TCounter.for_plan(pt),
                 0, device="cpu")
    batch_hj = hj.build(seeds, np.random.default_rng(5))
    batch_ht = ht.build(seeds, np.random.default_rng(5))
    batch_dt = dt.build(seeds, np.random.default_rng(5))
    _assert_batches_equal(batch_hj, batch_ht)
    _assert_batches_equal({k: v.numpy() for k, v in batch_ht.items()},
                          batch_dt)
    assert batch_dt["feats_2"].shape == (48,) + FANOUTS + (gt.feat_dim,)


def test_staging_buffer_is_recycled_without_aliasing_the_batch(setup):
    _, _, gt, pt = setup
    b = TDevice(gt, pt.cache_for_device(0), FANOUTS, None, 0, device="cpu",
                bucket=512)
    rng = np.random.default_rng(8)
    spec = b.fill_spec(b.sample_spec(pt.partition.tablets[0][:32], rng))
    staging = spec.miss_feats
    batch = b.finalize(spec)
    assert spec.miss_feats is None  # returned to the pool
    snap = {k: v.clone() for k, v in batch.items()}
    staging.fill_(7.0)  # the next fill reuses this buffer
    for k in batch:
        assert torch.equal(batch[k], snap[k]), k
    spec2 = b.fill_spec(b.sample_spec(pt.partition.tablets[0][32:64], rng))
    assert spec2.miss_feats is staging  # same bucket shape -> same buffer
    assert (spec2.miss_feats[spec2.n_miss:] == 0).all()


def test_bucket_collapses_spec_shapes(setup):
    _, _, gt, pt = setup
    cap = 32 * (1 + 5 + 15)
    b = TDevice(gt, pt.cache_for_device(0), FANOUTS, None, 0, device="cpu",
                bucket=cap)
    rng = np.random.default_rng(2)
    shapes = set()
    for step in range(4):
        seeds = rng.integers(0, gt.n, 32)
        spec = b.fill_spec(b.sample_spec(seeds, rng))
        shapes.add((len(spec.ids), tuple(spec.miss_feats.shape)))
        b.release_spec(spec)
    assert shapes == {(cap, (cap, gt.feat_dim))}


def test_builder_options_that_cannot_run_here_raise(setup):
    _, _, gt, pt = setup
    cache = pt.cache_for_device(0)
    with pytest.raises(ValueError, match="unknown batch backend"):
        make_batch_builder("tpu", gt, cache, FANOUTS, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TDevice(gt, cache, FANOUTS)  # the default device is cuda


@pytest.mark.parametrize("dev", [0, 3])
def test_unfused_finalize_equals_fused_and_reference_unfused(setup, dev):
    """``fused=False`` (the ``gather_rows`` chain at exact shapes) gives the
    fused finalize's batch bit for bit, and the reference's unfused one."""
    gj, pj, gt, pt = setup
    bj = JDevice(gj, pj.cache_for_device(dev), FANOUTS, None, dev,
                 gather="xla", fused=False)
    bt = TDevice(gt, pt.cache_for_device(dev), FANOUTS, None, dev,
                 device="cpu", fused=False)
    bf = make_batch_builder("device", gt, pt.cache_for_device(dev), FANOUTS,
                            None, dev, device="cpu")
    for step in range(2):
        seeds = pt.partition.tablets[dev][step * 40:(step + 1) * 40]
        rngs = [np.random.default_rng(11 + step) for _ in range(3)]
        batch_j = bj.build(seeds, rngs[0])
        batch_t = bt.build(seeds, rngs[1])
        _assert_batches_equal(batch_j, batch_t)
        _assert_batches_equal({k: v.numpy() for k, v in batch_t.items()},
                              bf.build(seeds, rngs[2]))
