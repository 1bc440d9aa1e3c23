"""The port's planner host stack (partition -> presample -> CSLP -> cost
model -> cache contents) against the reference package's, on one graph:
identical tablets, CSLP queues, cost-model alpha and per-device cache id
sets, for an 8-GPU NVLink-pair box and a single GPU."""
import numpy as np
import pytest

from repro.core.cliques import topology_matrix as j_topo
from repro.core.planner import build_plan as j_build_plan
from repro.graph.csr import powerlaw_graph as j_graph
from repro_torch.core.cliques import topology_matrix as t_topo
from repro_torch.core.planner import build_plan as t_build_plan
from repro_torch.graph.csr import powerlaw_graph as t_graph

FANOUTS = (5, 3)


@pytest.fixture(scope="module")
def graphs():
    return (j_graph(4000, 10, seed=4, feat_dim=32),
            t_graph(4000, 10, seed=4, feat_dim=32))


@pytest.mark.parametrize("kind,n_gpus,mode", [("nv2", 8, "sharded"),
                                              ("nonv", 1, "sharded"),
                                              ("nv2", 8, "replicated")])
def test_plan_contents_identical(graphs, kind, n_gpus, mode):
    gj, gt = graphs
    kw = dict(mem_per_device=300_000, batch_size=64, fanouts=FANOUTS, seed=0,
              topology_mode=mode)
    pj = j_build_plan(gj, j_topo(kind, n_gpus), **kw)
    pt = t_build_plan(gt, t_topo(kind, n_gpus), **kw)
    assert pj.partition.cliques == pt.partition.cliques
    np.testing.assert_array_equal(pj.partition.vertex_part,
                                  pt.partition.vertex_part)
    assert pj.partition.tablets.keys() == pt.partition.tablets.keys()
    for d in pj.partition.tablets:
        np.testing.assert_array_equal(pj.partition.tablets[d],
                                      pt.partition.tablets[d])
    for sj, st in zip(pj.stats, pt.stats):
        np.testing.assert_array_equal(sj.H_T, st.H_T)
        np.testing.assert_array_equal(sj.H_F, st.H_F)
        assert sj.N_TSUM == st.N_TSUM
    for cj, ct in zip(pj.cslp, pt.cslp):
        np.testing.assert_array_equal(cj.Q_T, ct.Q_T)
        np.testing.assert_array_equal(cj.Q_F, ct.Q_F)
    for aj, at in zip(pj.cost_plans, pt.cost_plans):
        assert aj["alpha"] == at["alpha"]
        assert aj["N_total"] == at["N_total"]
    assert len(pj.caches) == len(pt.caches)
    for cj, ct in zip(pj.caches, pt.caches):
        assert cj.devices == ct.devices and cj.topology_mode == ct.topology_mode
        np.testing.assert_array_equal(cj.feat_ids, ct.feat_ids)
        np.testing.assert_array_equal(cj.feat_owner, ct.feat_owner)
        np.testing.assert_array_equal(cj.feat_cache, ct.feat_cache)
        for a, b in zip(cj.topo_ids_per_dev, ct.topo_ids_per_dev):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(cj.cache_indptr, ct.cache_indptr)
        np.testing.assert_array_equal(cj.cache_indices, ct.cache_indices)
        if mode == "sharded":
            np.testing.assert_array_equal(cj.topo_shard_indptr,
                                          ct.topo_shard_indptr)
            np.testing.assert_array_equal(cj.topo_shard_indices,
                                          ct.topo_shard_indices)
    assert pt.cache_for_device(0) is pt.caches[0]


def test_knapsack_planner_identical(graphs):
    gj, gt = graphs
    kw = dict(mem_per_device=200_000, batch_size=64, fanouts=FANOUTS, seed=1,
              planner="knapsack")
    pj = j_build_plan(gj, j_topo("nv4", 4), **kw)
    pt = t_build_plan(gt, t_topo("nv4", 4), **kw)
    for aj, at in zip(pj.cost_plans, pt.cost_plans):
        assert (aj["m_T"], aj["m_F"]) == (at["m_T"], at["m_F"])
    for cj, ct in zip(pj.caches, pt.caches):
        np.testing.assert_array_equal(cj.feat_ids, ct.feat_ids)
        np.testing.assert_array_equal(cj.topo_ids, ct.topo_ids)
