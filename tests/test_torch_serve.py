"""Serving in the port: the deadline batcher (copies of the reference
batcher tests), the device batch against the host oracle bitwise, and the
whole slice against the reference ``GNNServer`` — same graph, plan inputs,
weights, seed and request stream give the same micro-batch packing and
logits within rtol = atol = 1e-5 (float32 matmul sums run in another order
under XLA and PyTorch).  With an online cache manager attached, both
servers refresh at the same micro-batches with the same deltas, and the
bitwise host-oracle check holds across every refresh."""
import time

import jax
import numpy as np
import pytest
import torch

from repro.core.cache_manager import OnlineCacheManager as JManager
from repro.core.cache_manager import RefreshConfig as JRefresh
from repro.core.cliques import topology_matrix as j_topo
from repro.core.planner import build_plan as j_build_plan
from repro.graph.csr import powerlaw_graph as j_graph
from repro.models.gnn import GNNConfig as JConfig
from repro.models.gnn import defs as j_defs
from repro.models.params import init_from_defs as j_init
from repro.serve import GNNServer as JServer
from repro.serve import ServeConfig as JServeConfig
from repro_torch.core.cache_manager import OnlineCacheManager, RefreshConfig
from repro_torch.core.cliques import topology_matrix as t_topo
from repro_torch.core.planner import build_plan as t_build_plan
from repro_torch.graph.csr import powerlaw_graph as t_graph
from repro_torch.kernels import fused_batch
from repro_torch.models.convert import params_from_jax
from repro_torch.models.gnn import GNNConfig as TConfig
from repro_torch.models.gnn import forward as t_forward
from repro_torch.serve import (FLUSH_CLOSE, FLUSH_DEADLINE, FLUSH_FULL,
                               DeadlineBatcher, GNNServer, ServeConfig,
                               host_oracle_batch)
from repro_torch.train.batch import DeviceBatchBuilder

FANOUTS = (5, 3)
MAX_BATCH = 32
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def setup():
    kw = dict(mem_per_device=1_000_000, batch_size=MAX_BATCH,
              fanouts=FANOUTS, seed=0)
    gj = j_graph(4000, 10, seed=4, feat_dim=32)
    gt = t_graph(4000, 10, seed=4, feat_dim=32)
    cfg_kw = dict(feat_dim=32, hidden=16, batch_size=MAX_BATCH,
                  fanouts=FANOUTS)
    pj = j_init(j_defs(JConfig(**cfg_kw)), jax.random.PRNGKey(0))
    return {"gj": gj, "plan_j": j_build_plan(gj, j_topo("nv2"), **kw),
            "gt": gt, "plan_t": t_build_plan(gt, t_topo("nv2"), **kw),
            "cfg_j": JConfig(**cfg_kw), "cfg_t": TConfig(**cfg_kw),
            "params_j": pj,
            "params_t": params_from_jax(
                jax.tree_util.tree_map(np.asarray, pj), "cpu")}


# ---------------- batcher (copies of the reference's tests) ----------------

def test_batcher_full_flush_packs_fifo():
    b = DeadlineBatcher(max_batch=8, max_wait_s=10.0)
    for n in (3, 3, 2, 5):
        b.submit(np.arange(n))
    reqs, trigger = b.next_batch()  # immediate: queue fills a batch
    assert trigger == FLUSH_FULL
    assert [len(r.seeds) for r in reqs] == [3, 3, 2]
    assert b.depth == 1  # the 5-seed request did not fit and waits


def test_batcher_flushes_early_when_next_request_wont_fit():
    # 6+5 > 8: waiting for the deadline cannot help, flush the 6 now
    b = DeadlineBatcher(max_batch=8, max_wait_s=10.0)
    b.submit(np.arange(6))
    b.submit(np.arange(5))
    t0 = time.perf_counter()
    reqs, trigger = b.next_batch()
    assert time.perf_counter() - t0 < 1.0
    assert trigger == FLUSH_FULL and len(reqs) == 1
    assert len(reqs[0].seeds) == 6


def test_batcher_deadline_flush():
    b = DeadlineBatcher(max_batch=64, max_wait_s=0.02)
    b.submit(np.arange(3))
    t0 = time.perf_counter()
    reqs, trigger = b.next_batch()
    waited = time.perf_counter() - t0
    assert trigger == FLUSH_DEADLINE
    assert len(reqs) == 1 and waited >= 0.015


def test_batcher_close_drains_then_ends():
    b = DeadlineBatcher(max_batch=64, max_wait_s=10.0)
    b.submit(np.arange(2))
    b.close()
    reqs, trigger = b.next_batch()
    assert trigger == FLUSH_CLOSE and len(reqs) == 1
    assert b.next_batch() is None
    with pytest.raises(RuntimeError, match="closed"):
        b.submit(np.arange(1))


def test_batcher_rejects_unpackable_requests():
    b = DeadlineBatcher(max_batch=4, max_wait_s=1.0)
    with pytest.raises(ValueError, match="empty"):
        b.submit(np.asarray([], dtype=np.int64))
    with pytest.raises(ValueError, match="max_batch"):
        b.submit(np.arange(5))


# ---------------- parity: serving gather == host oracle ----------------

def test_device_batch_matches_host_oracle_bitwise(setup):
    gt, plan, cfg, params = (setup["gt"], setup["plan_t"], setup["cfg_t"],
                             setup["params_t"])
    cache = plan.cache_for_device(0)
    b = DeviceBatchBuilder(gt, cache, FANOUTS, None, 0, device="cpu")
    rng = np.random.default_rng(3)
    for _ in range(3):
        spec = b.fill_spec(b.sample_spec(rng.integers(0, gt.n, MAX_BATCH),
                                         rng))
        oracle = host_oracle_batch(spec, cache, gt.feat_dim)  # pre-finalize
        batch = b.finalize(spec)
        ob = {k: torch.from_numpy(v) for k, v in oracle.items()}
        assert ob.keys() == batch.keys()
        for k in ob:
            assert torch.equal(ob[k], batch[k]), k
        assert torch.equal(t_forward(cfg, params, batch),
                           t_forward(cfg, params, ob))


# ---------------- the slice: port server == reference server ----------------

def _serve_all(server, requests):
    """Submit every request BEFORE start(), so packing depends only on
    request sizes, then serve them all."""
    server.warmup()
    futs = [server.submit(r) for r in requests]
    server.start()
    try:
        return [f.result(timeout=120) for f in futs]
    finally:
        server.stop()


def test_port_server_matches_reference_server(setup):
    rng = np.random.default_rng(5)
    requests = [rng.integers(0, setup["gt"].n, int(n))
                for n in rng.integers(1, MAX_BATCH + 1, 24)]
    jsrv = JServer(setup["gj"], setup["plan_j"], setup["cfg_j"],
                   setup["params_j"], dev=0, seed=7,
                   config=JServeConfig(max_batch=MAX_BATCH, max_wait_s=0.002,
                                       gather="xla"))
    tsrv = GNNServer(setup["gt"], setup["plan_t"], setup["cfg_t"],
                     setup["params_t"], dev=0, seed=7, device="cpu",
                     config=ServeConfig(max_batch=MAX_BATCH,
                                        max_wait_s=0.002, oracle_check=True))
    launches = fused_batch.KERNEL.launches
    res_j = _serve_all(jsrv, requests)
    res_t = _serve_all(tsrv, requests)
    assert fused_batch.KERNEL.launches == launches  # CPU: plain path only
    assert len(res_t) == len(requests)
    for rj, rt, req in zip(res_j, res_t, requests):
        assert (rj.request_id, rj.batch_id, rj.batch_seeds, rj.n_seeds) == \
            (rt.request_id, rt.batch_id, rt.batch_seeds, rt.n_seeds)
        assert rt.logits.shape == (len(req), setup["cfg_t"].n_classes)
        np.testing.assert_allclose(rt.logits, rj.logits, **TOL)
    s = tsrv.summary()
    assert s["oracle_checks"] == s["batches"] == jsrv.summary()["batches"]
    assert s["oracle_mismatches"] == 0
    assert s["replies"] == s["requests"] == len(requests) + 2
    assert tsrv.counter.feature_requests == jsrv.counter.feature_requests
    assert tsrv.counter.feature_hits == jsrv.counter.feature_hits


def test_server_refuses_what_is_not_ported(setup):
    args = (setup["gt"], setup["plan_t"], setup["cfg_t"], setup["params_t"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            GNNServer(*args)  # the default device is cuda



def test_port_server_with_refresh_matches_reference_server(setup):
    """Serving traffic drives online refreshes (every 4 micro-batches,
    any drift replans) on fresh plans in both packages: the same refresh
    events, the same replies, and no oracle mismatch across the refreshes."""
    kw = dict(mem_per_device=100_000, batch_size=MAX_BATCH, fanouts=FANOUTS,
              seed=0)
    plan_j = j_build_plan(setup["gj"], j_topo("nv2"), **kw)
    plan_t = t_build_plan(setup["gt"], t_topo("nv2"), **kw)
    mj = JManager(setup["gj"], plan_j, JRefresh(drift_threshold=1.0))
    mt = OnlineCacheManager(setup["gt"], plan_t,
                            RefreshConfig(drift_threshold=1.0))
    rng = np.random.default_rng(6)
    requests = [rng.integers(0, setup["gt"].n, int(n))
                for n in rng.integers(1, MAX_BATCH + 1, 30)]
    jsrv = JServer(setup["gj"], plan_j, setup["cfg_j"], setup["params_j"],
                   dev=0, seed=7, manager=mj,
                   config=JServeConfig(max_batch=MAX_BATCH, max_wait_s=0.002,
                                       gather="xla", refresh_interval=4))
    tsrv = GNNServer(setup["gt"], plan_t, setup["cfg_t"], setup["params_t"],
                     dev=0, seed=7, device="cpu", manager=mt,
                     config=ServeConfig(max_batch=MAX_BATCH,
                                        max_wait_s=0.002, refresh_interval=4,
                                        oracle_check=True))
    res_j = _serve_all(jsrv, requests)
    res_t = _serve_all(tsrv, requests)
    for rj, rt in zip(res_j, res_t):
        assert (rj.batch_id, rj.cache_epoch) == (rt.batch_id, rt.cache_epoch)
        np.testing.assert_allclose(rt.logits, rj.logits, **TOL)
    assert mt.summary() == mj.summary()
    assert mt.stats.refreshes >= 1 and mt.stats.admitted > 0
    assert res_t[-1].cache_epoch >= 1
    s = tsrv.summary()
    assert s["oracle_mismatches"] == 0 and s["oracle_checks"] == s["batches"]
    assert tsrv.counter.feature_hits == jsrv.counter.feature_hits
    with pytest.raises(ValueError, match="manager"):
        GNNServer(setup["gt"], plan_t, setup["cfg_t"], setup["params_t"],
                  device="cpu", config=ServeConfig(refresh_interval=4))
