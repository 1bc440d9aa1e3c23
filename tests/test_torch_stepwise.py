"""The stepwise sampler (``sampler="stepwise"``: one sampling launch and
one sync per hop) against the chain sampler (every hop in one launch) and
against the reference's stepwise builder: specs, finalized batches and
traffic tallies bitwise equal, in ``tests/test_torch_batch.py``'s style,
then ``train_gnn`` on the device and sharded backends with bitwise-equal
losses and tallies, and the reference's stepwise run within the training
tolerance of ``tests/test_torch_train.py``."""
import jax
import numpy as np
import pytest
import torch

from repro.core.cliques import topology_matrix as j_topo
from repro.core.planner import build_plan as j_build_plan
from repro.core.unified_cache import TrafficCounter as JCounter
from repro.graph.csr import powerlaw_graph as j_graph
from repro.models.gnn import GNNConfig as JConfig
from repro.models.gnn import defs as j_defs
from repro.models.params import init_from_defs as j_init
from repro.train.batch import DeviceBatchBuilder as JDevice
from repro.train.loop import train_gnn as j_train
from repro_torch.core.cliques import topology_matrix as t_topo
from repro_torch.core.planner import build_plan as t_build_plan
from repro_torch.core.unified_cache import TrafficCounter as TCounter
from repro_torch.graph.csr import powerlaw_graph as t_graph
from repro_torch.models.convert import params_from_jax
from repro_torch.models.gnn import GNNConfig
from repro_torch.train.batch import DeviceBatchBuilder as TDevice
from repro_torch.train.batch import make_batch_builder
from repro_torch.train.loop import train_gnn

FANOUTS = (5, 3)
SPEC_ARRAYS = ("ids", "cache_pos", "hit", "miss_inv", "labels")
TALLIES = ("pcie_transactions", "feature_requests", "feature_hits",
           "topo_requests", "topo_hits", "host_sample_syncs",
           "host_sampled_edges")
CFG = dict(feat_dim=32, hidden=32, batch_size=64, fanouts=(4, 2), lr=3e-3)
STEPS = 8


@pytest.fixture(scope="module")
def setup():
    gj = j_graph(4000, 10, seed=4, feat_dim=32)
    gt = t_graph(4000, 10, seed=4, feat_dim=32)
    kw = dict(mem_per_device=300_000, batch_size=64, fanouts=FANOUTS, seed=0)
    return (gj, j_build_plan(gj, j_topo("nv2"), **kw),
            gt, t_build_plan(gt, t_topo("nv2"), **kw))


def _specs_equal(a, b):
    for name in SPEC_ARRAYS:
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name),
                                      err_msg=name)
    for x, y in zip(a.levels + a.level_pos, b.levels + b.level_pos):
        np.testing.assert_array_equal(x, y)
    assert (a.n_ids, a.n_miss, a.cache_epoch) == \
        (b.n_ids, b.n_miss, b.cache_epoch)
    np.testing.assert_array_equal(np.asarray(a.miss_feats),
                                  b.miss_feats.numpy())


def _counters_equal(a, b):
    for name in TALLIES:
        assert getattr(a, name) == getattr(b, name), name
    np.testing.assert_array_equal(a.bytes_matrix, b.bytes_matrix)


@pytest.mark.parametrize("dev,bucket", [(0, 256), (1, 64)])
def test_stepwise_specs_and_batches_are_the_chains(setup, dev, bucket):
    _, _, gt, pt = setup
    counters = {m: TCounter.for_plan(pt) for m in ("chain", "stepwise")}
    builders = {m: TDevice(gt, pt.cache_for_device(dev), FANOUTS,
                           counters[m], dev, device="cpu", bucket=bucket,
                           sampler=m) for m in counters}
    rngs = {m: np.random.default_rng(3) for m in counters}
    for step in range(3):
        seeds = pt.partition.tablets[dev][step * 32:(step + 1) * 32]
        specs = {m: builders[m].fill_spec(builders[m].sample_spec(seeds,
                                                                  rngs[m]))
                 for m in counters}
        _specs_equal(specs["chain"], specs["stepwise"])
        a, b = (builders[m].finalize(specs[m]) for m in counters)
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k
    _counters_equal(counters["chain"], counters["stepwise"])
    assert counters["chain"].topo_hits > 0


@pytest.mark.parametrize("dev", [0, 1])
def test_stepwise_specs_are_the_references(setup, dev):
    gj, pj, gt, pt = setup
    cj, ct = JCounter.for_plan(pj), TCounter.for_plan(pt)
    bj = JDevice(gj, pj.cache_for_device(dev), FANOUTS, cj, dev,
                 gather="xla", sampler="stepwise")
    bt = TDevice(gt, pt.cache_for_device(dev), FANOUTS, ct, dev,
                 device="cpu", sampler="stepwise")
    rj, rt = np.random.default_rng(7), np.random.default_rng(7)
    for step in range(3):
        seeds = pt.partition.tablets[dev][step * 32:(step + 1) * 32]
        _specs_equal(bj.fill_spec(bj.sample_spec(seeds, rj)),
                     bt.fill_spec(bt.sample_spec(seeds, rt)))
    _counters_equal(cj, ct)


@pytest.mark.parametrize("backend", ["device", "sharded"])
def test_unknown_sampler_raises_as_in_the_reference(setup, backend):
    gj, pj, gt, pt = setup
    with pytest.raises(ValueError, match="unknown sampler mode 'hops'"):
        JDevice(gj, pj.cache_for_device(0), FANOUTS, sampler="hops")
    with pytest.raises(ValueError, match="unknown sampler mode 'hops'"):
        make_batch_builder(backend, gt, pt.cache_for_device(0), FANOUTS,
                           device="cpu", sampler="hops")


def _plan(g, topo):
    return t_build_plan(g, t_topo(*topo), mem_per_device=100_000,
                        batch_size=64, seed=0, fanouts=(4, 2))


@pytest.fixture(scope="module")
def params():
    p0 = j_init(j_defs(JConfig(**CFG)), jax.random.PRNGKey(0))
    return params_from_jax(jax.tree_util.tree_map(np.asarray, p0), "cpu")


@pytest.mark.parametrize("backend,topo", [("device", ("nv2", 2)),
                                          ("sharded", ("dgx-v100", 4))])
def test_train_gnn_stepwise_equals_chain_bitwise(params, backend, topo):
    runs = {}
    for sampler in ("chain", "stepwise"):
        g = t_graph(4000, 8, seed=4, feat_dim=32)
        runs[sampler] = train_gnn(g, _plan(g, topo), GNNConfig(**CFG),
                                  steps=STEPS, seed=0, backend=backend,
                                  device="cpu", params=params,
                                  sampler=sampler)
    a, b = runs["chain"], runs["stepwise"]
    assert a.backend == b.backend == backend
    assert a.losses == b.losses and a.accs == b.accs
    _counters_equal(a.counter, b.counter)
    assert a.sampling == b.sampling
    assert b.pipeline["batches_built"] == STEPS


def test_train_gnn_stepwise_matches_the_references(params):
    gj = j_graph(4000, 8, seed=4, feat_dim=32)
    want = j_train(gj, j_build_plan(gj, j_topo("nv2", 2),
                                    mem_per_device=100_000, batch_size=64,
                                    seed=0, fanouts=(4, 2)),
                   JConfig(**CFG), steps=STEPS, seed=0, backend="device",
                   sampler="stepwise")
    g = t_graph(4000, 8, seed=4, feat_dim=32)
    got = train_gnn(g, _plan(g, ("nv2", 2)), GNNConfig(**CFG), steps=STEPS,
                    seed=0, backend="device", device="cpu", params=params,
                    sampler="stepwise")
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got.accs, want.accs, rtol=0, atol=1e-6)
    _counters_equal(want.counter, got.counter)
