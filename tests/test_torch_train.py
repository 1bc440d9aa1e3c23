"""The training slice of the port against the reference's ``train_gnn``:
same graph, plan inputs, seed and initial parameters (the reference's,
through ``params_from_jax``) on a two-device plan, 12 steps with an online
refresh every 4 steps.  Per-step losses agree within rtol = 1e-4,
atol = 1e-5 (float32 sums run in another order under XLA and PyTorch, and
the difference compounds over the steps), the refresh summaries (events and
overlaps included) and the traffic tallies are identical.  In the port
alone: host and device backends give bitwise-equal losses, so do the fused
and unfused finalize, the options not ported yet raise, and so does
``lookahead=`` without a feature store, as in the reference."""
import jax
import numpy as np
import pytest
import torch

from repro.core.cache_manager import RefreshConfig as JRefresh
from repro.core.cliques import topology_matrix as j_topo
from repro.core.planner import build_plan as j_build_plan
from repro.graph.csr import powerlaw_graph as j_graph
from repro.models.gnn import GNNConfig as JConfig
from repro.models.gnn import defs as j_defs
from repro.models.params import init_from_defs as j_init
from repro.train.loop import train_gnn as j_train
from repro_torch.core.cache_manager import RefreshConfig
from repro_torch.core.cliques import topology_matrix as t_topo
from repro_torch.core.planner import build_plan as t_build_plan
from repro_torch.graph.csr import powerlaw_graph as t_graph
from repro_torch.models.convert import params_from_jax
from repro_torch.models.gnn import GNNConfig
from repro_torch.train.loop import train_gnn

STEPS = 12
CFG = dict(feat_dim=32, hidden=32, batch_size=64, fanouts=(4, 2), lr=3e-3)
PLAN = dict(mem_per_device=100_000, batch_size=64, seed=0, fanouts=(4, 2))
REFRESH = dict(interval=4, drift_threshold=1.0)
TOL = dict(rtol=1e-4, atol=1e-5)
TALLIES = ("pcie_transactions", "feature_requests", "feature_hits",
           "topo_requests", "topo_hits", "host_sample_syncs",
           "host_sampled_edges")


def _port_run(params=None, backend="device", cfg=None, **kw):
    g = t_graph(4000, 8, seed=4, feat_dim=32)
    plan = t_build_plan(g, t_topo("nv2", 2), **PLAN)
    return train_gnn(g, plan, cfg or GNNConfig(**CFG), steps=STEPS, seed=0,
                     backend=backend, device="cpu", params=params,
                     refresh_config=RefreshConfig(**REFRESH), **kw)


@pytest.fixture(scope="module")
def reference():
    """The reference's two backends (fresh plans: a refresh mutates its
    plan) and its initial parameters as port tensors."""
    runs = {}
    for backend in ("host", "device"):
        g = j_graph(4000, 8, seed=4, feat_dim=32)
        plan = j_build_plan(g, j_topo("nv2", 2), **PLAN)
        runs[backend] = j_train(g, plan, JConfig(**CFG), steps=STEPS,
                                seed=0, backend=backend,
                                refresh_config=JRefresh(**REFRESH))
    p0 = j_init(j_defs(JConfig(**CFG)), jax.random.PRNGKey(0))
    return runs, params_from_jax(jax.tree_util.tree_map(np.asarray, p0),
                                 "cpu")


@pytest.fixture(scope="module")
def port(reference):
    _, params = reference
    return {b: _port_run(params, backend=b) for b in ("host", "device")}


@pytest.mark.parametrize("backend", ["host", "device"])
def test_train_gnn_matches_reference(reference, port, backend):
    want, got = reference[0][backend], port[backend]
    assert got.steps == STEPS and got.backend == backend
    assert len(got.losses) == len(got.step_times) == STEPS
    np.testing.assert_allclose(got.losses, want.losses, **TOL)
    np.testing.assert_allclose(got.accs, want.accs, rtol=0, atol=1e-6)
    assert got.refresh == want.refresh  # events and overlaps, exactly
    assert got.refresh["refreshes"] >= 1 and got.refresh["admitted"] > 0
    for name in TALLIES:
        assert getattr(got.counter, name) == getattr(want.counter, name), name
    np.testing.assert_array_equal(got.counter.bytes_matrix,
                                  want.counter.bytes_matrix)
    np.testing.assert_array_equal(got.counter.topo_bytes_matrix,
                                  want.counter.topo_bytes_matrix)
    assert got.sampling == want.sampling
    assert got.pipeline["batches_built"] == STEPS


def test_host_and_device_backends_are_bitwise_equal(port):
    assert port["host"].losses == port["device"].losses
    assert port["host"].accs == port["device"].accs
    assert port["host"].refresh == port["device"].refresh
    staging = port["device"].pipeline
    assert staging["staging_buffers"] >= 1 and staging["staging_bytes"] > 0
    assert port["host"].pipeline["staging_buffers"] == 0


def test_unfused_finalize_trains_bitwise_like_the_fused_one(reference, port):
    unfused = _port_run(reference[1], fused=False)
    assert unfused.losses == port["device"].losses
    assert unfused.refresh == port["device"].refresh


def test_refresh_summary_of_the_gpu_training_test_matches_reference():
    """The configuration of the gpu-marked training test in
    ``test_torch_kernels.py`` (8 steps, a drift check at step 4 that
    replans on any drift), on the CPU: the port's device backend makes the
    reference's refresh, event for event (one check, one refresh, 329 rows
    admitted and 345 evicted)."""
    cfg = dict(CFG)
    g = j_graph(4000, 8, seed=4, feat_dim=32)
    want = j_train(g, j_build_plan(g, j_topo("nv2", 2), **PLAN),
                   JConfig(**cfg), steps=8, seed=0, backend="device",
                   refresh_config=JRefresh(**REFRESH))
    gt = t_graph(4000, 8, seed=4, feat_dim=32)
    got = train_gnn(gt, t_build_plan(gt, t_topo("nv2", 2), **PLAN),
                    GNNConfig(**cfg), steps=8, seed=0, backend="device",
                    device="cpu", refresh_config=RefreshConfig(**REFRESH))
    assert got.refresh == want.refresh
    assert (got.refresh["checks"], got.refresh["refreshes"],
            got.refresh["admitted"], got.refresh["evicted"]) == (1, 1, 329,
                                                                 345)


def test_gcn_trains_finite_and_the_default_init_runs():
    res = _port_run(cfg=GNNConfig(**dict(CFG, model="gcn")))
    assert np.isfinite(res.losses).all() and len(res.losses) == STEPS
    assert res.losses[-1] < res.losses[0]


def test_refresh_interval_must_exceed_prefetch_depth():
    g = t_graph(2000, 6, seed=1, feat_dim=16)
    plan = t_build_plan(g, t_topo("nv2", 2), mem_per_device=200_000,
                        batch_size=32, seed=0)
    cfg = GNNConfig(feat_dim=16, hidden=16, batch_size=32, fanouts=(4, 3))
    with pytest.raises(ValueError, match="prefetch_depth"):
        train_gnn(g, plan, cfg, steps=4, device="cpu", refresh_interval=2,
                  prefetch_depth=4)


@pytest.mark.parametrize("kw", [
    {"mesh": object()}, {"compress_grads": True},
    {"backend": "sharded", "mesh": object()}, {"sampler": "stepwise"}])
def test_options_not_ported_yet_raise(kw):
    g = t_graph(500, 4, seed=1, feat_dim=8)
    cfg = GNNConfig(feat_dim=8, hidden=8, batch_size=16, fanouts=(2, 2))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        train_gnn(g, None, cfg, steps=1, device="cpu", **kw)


def test_lookahead_without_a_store_raises():
    g = t_graph(500, 4, seed=1, feat_dim=8)
    cfg = GNNConfig(feat_dim=8, hidden=8, batch_size=16, fanouts=(2, 2))
    with pytest.raises(ValueError, match="feature_store"):
        train_gnn(g, None, cfg, steps=1, device="cpu", lookahead=2)


def test_unknown_option_and_missing_card_raise():
    g = t_graph(500, 4, seed=1, feat_dim=8)
    cfg = GNNConfig(feat_dim=8, hidden=8, batch_size=16, fanouts=(2, 2))
    with pytest.raises(TypeError, match="no_such_option"):
        train_gnn(g, None, cfg, steps=1, device="cpu", no_such_option=1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            train_gnn(g, None, cfg, steps=1)  # the default device is cuda
