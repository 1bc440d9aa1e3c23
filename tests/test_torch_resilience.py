"""Fault injection and elastic recovery in the port
(``repro_torch.train.resilience``, ``train_gnn(checkpoint_dir=, resume=,
resilience=)``, ``core.planner.replan_on_topology_change``).

First every test of the reference's ``tests/test_resilience.py`` on the port
(the device-loss test without the reference's loss-decrease assertion, which
is red in the reference itself): faults fire deterministically and typed,
every recovered fault and a kill-and-resume are bitwise transparent,
a device loss remeshes onto the survivors or aborts by policy.  Then the
two packages on the same inputs (numpy graphs and plans made from the same
seeds, the reference's initial parameters): the replanned survivor plan is
bitwise the reference's, so is the runtime payload at a checkpoint
boundary; a kill-and-resume (also one that starts from a checkpoint
directory the reference wrote) and a device-loss remesh give losses within
rtol 1e-4 of the reference's and bitwise the same hit tallies and events.
Runs with a store build serially (``prefetch_workers=1``): with several
build threads the shared store sees gathers in either order."""
import pickle
import shutil

import jax
import numpy as np
import pytest

from repro.core.cliques import topology_matrix as j_topo
from repro.core.feature_store import TieredStoreConfig as JStoreConfig
from repro.core.planner import build_plan as j_build_plan
from repro.core.planner import replan_on_topology_change as j_replan
from repro.graph.csr import powerlaw_graph as j_graph
from repro.models.gnn import GNNConfig as JConfig
from repro.models.gnn import defs as j_defs
from repro.models.params import init_from_defs as j_init
from repro.train.loop import train_gnn as j_train
from repro.train.resilience import FaultPlan as JFaultPlan
from repro.train.resilience import FaultSpec as JFaultSpec
from repro.train.resilience import ResilienceConfig as JResilienceConfig
from repro.train.resilience import \
    topology_from_partition as j_topology_from_partition
from repro_torch.core.cache_manager import OnlineCacheManager, RefreshConfig
from repro_torch.core.cliques import topology_matrix
from repro_torch.core.feature_store import FeatureStore, TieredStoreConfig
from repro_torch.core.planner import build_plan, replan_on_topology_change
from repro_torch.graph.csr import powerlaw_graph
from repro_torch.models.convert import params_from_jax
from repro_torch.models.gnn import GNNConfig
from repro_torch.train.checkpoint import latest_checkpoint
from repro_torch.train.loop import train_gnn
from repro_torch.train.resilience import (FaultPlan, FaultSpec,
                                          InjectedReadError,
                                          InjectedWorkerDeath,
                                          ResilienceConfig,
                                          topology_from_partition)

FEAT = 16
CFG = dict(feat_dim=FEAT, hidden=16, batch_size=64, fanouts=(4, 2))
PLAN = dict(mem_per_device=300_000, batch_size=128, seed=0, fanouts=(4, 2))
TOL = dict(rtol=1e-4, atol=1e-5)
TALLIES = ("pcie_transactions", "feature_requests", "feature_hits",
           "topo_requests", "topo_hits", "host_sample_syncs",
           "host_sampled_edges")


@pytest.fixture(scope="module")
def setup():
    g = powerlaw_graph(3000, 8, seed=11, feat_dim=FEAT)
    plan = build_plan(g, topology_matrix("nv2", 2), **PLAN)
    return g, plan


def _cfg(**kw):
    base = dict(CFG)
    base.update(kw)
    return GNNConfig(**base)


def _train(g, plan, cfg, **kw):
    return train_gnn(g, plan, cfg, device="cpu", **kw)


# ---- FaultPlan semantics -----------------------------------------------


def test_fault_spec_validation():
    with pytest.raises(ValueError, match="unknown fault site"):
        FaultSpec("gamma_ray")
    with pytest.raises(ValueError, match="dev="):
        FaultSpec("device_loss", step=3)
    with pytest.raises(ValueError, match="stall_s"):
        FaultSpec("ssd_stall", at_call=0)
    with pytest.raises(ValueError, match="times"):
        FaultSpec("ssd_read", times=0)


def test_fault_plan_fires_by_step_call_and_times():
    plan = FaultPlan([FaultSpec("prefetch_build", step=3),
                      FaultSpec("ssd_read", at_call=2, times=2)])
    for s in (0, 1, 2):
        plan.raise_if("prefetch_build", step=s)
    with pytest.raises(InjectedWorkerDeath):
        plan.raise_if("prefetch_build", step=3)
    plan.raise_if("prefetch_build", step=3)  # times=1: exhausted
    plan.raise_if("ssd_read")
    plan.raise_if("ssd_read")
    for _ in range(2):
        with pytest.raises(InjectedReadError):
            plan.raise_if("ssd_read")
    plan.raise_if("ssd_read")
    assert plan.summary() == {"injected_prefetch_build": 1,
                              "injected_ssd_read": 2}


def test_fault_plan_stall_sleeps():
    plan = FaultPlan([FaultSpec("ssd_stall", at_call=0, stall_s=0.01)])
    assert plan.sleep_if("ssd_stall") == pytest.approx(0.01)
    assert plan.sleep_if("ssd_stall") == 0.0


def test_topology_from_partition_is_block_diagonal(setup):
    _, plan = setup
    adj = topology_from_partition(plan.partition)
    assert not adj.diagonal().any()
    for c in plan.partition.cliques:
        for a in c:
            for b in c:
                assert adj[a, b] == (a != b)
    cliques = plan.partition.cliques
    if len(cliques) > 1:
        assert not adj[cliques[0][0], cliques[1][0]]


# ---- bitwise transparency of recovered faults --------------------------


def test_faulty_run_bitwise_equals_clean(setup, tmp_path):
    """Worker death (respawned) + checkpoint-write failure (retried): the
    recovered run's losses match a fault-free run exactly, and the result
    reports every injection and every recovery."""
    g, plan = setup
    cfg = _cfg()
    clean = _train(g, plan, cfg, steps=8, seed=3)
    fp = FaultPlan([FaultSpec("prefetch_build", step=3),
                    FaultSpec("checkpoint_write", at_call=0)])
    r = _train(g, plan, cfg, steps=8, seed=3, checkpoint_dir=str(tmp_path),
               checkpoint_every=4,
               resilience=ResilienceConfig(fault_plan=fp, worker_restarts=2,
                                           checkpoint_retries=1))
    assert clean.losses == r.losses
    assert r.resilience["faults"] == {"injected_prefetch_build": 1,
                                      "injected_checkpoint_write": 1}
    assert r.pipeline["worker_deaths"] == 1
    assert r.pipeline["worker_restarts"] == 1
    assert r.resilience["checkpoint"]["write_errors"] == 1
    assert r.resilience["checkpoint"]["retries_used"] == 1
    assert r.resilience["checkpoint"]["saves"] >= 2  # retried, not dropped


def test_ssd_faults_bitwise_with_store(setup):
    """Transient read errors and a stall under the tiered store: the retry
    path re-reads, rows stay bitwise identical, losses match the fault-free
    store run."""
    g, plan = setup
    cfg = _cfg()
    sc = TieredStoreConfig(host_rows=400, async_fills=False, lookahead=2)
    clean = _train(g, plan, cfg, steps=6, seed=5, feature_store=sc,
                   prefetch_workers=1)
    fp = FaultPlan([FaultSpec("ssd_read", at_call=3, times=2),
                    FaultSpec("ssd_stall", at_call=8, stall_s=0.01)])
    r = _train(g, plan, cfg, steps=6, seed=5, feature_store=sc,
               prefetch_workers=1, resilience=ResilienceConfig(fault_plan=fp))
    assert clean.losses == r.losses
    assert r.store["read_errors"] == 2
    assert r.store["read_retries"] == 2
    assert r.store["stall_s"] >= 0.01
    assert r.resilience["faults"]["injected_ssd_read"] == 2
    assert r.resilience["faults"]["injected_ssd_stall"] == 1


def test_store_retry_exhaustion_propagates():
    g = powerlaw_graph(500, 6, seed=2, feat_dim=8)
    store = FeatureStore(g, TieredStoreConfig(host_rows=64, read_retries=1,
                                              async_fills=False))
    fp = FaultPlan([FaultSpec("ssd_read", at_call=0, times=5)])
    store.source = fp.wrap_source(store.source)
    with pytest.raises(InjectedReadError):
        store.gather(np.arange(10, dtype=np.int64))
    s = store.summary()
    assert s["read_errors"] == 2       # first attempt + the one retry
    assert s["read_retries"] == 1


# ---- preemption-safe resume --------------------------------------------


def test_kill_and_resume_bitwise(kill_resume):
    """Kill at step 6, resume: the stitched losses equal the uninterrupted
    run bit for bit (the journaled RNG boundary state, the manager's
    learned hotness and the store residency all came back)."""
    full, first, second = (kill_resume["port"][k]
                           for k in ("full", "first", "second"))
    assert full.losses[:6] == first.losses
    assert full.losses[6:] == second.losses
    assert second.steps == 6
    assert second.resilience["resumed_from_step"] == 6
    assert second.resilience["runtime_restored"] is True


def test_resume_without_runtime_still_restores_params(setup, tmp_path):
    """A checkpoint whose runtime payload is absent resumes params and step
    only, not an error."""
    g, plan = setup
    cfg = _cfg()
    d = str(tmp_path)
    r1 = _train(g, plan, cfg, steps=4, seed=1, checkpoint_dir=d)
    assert r1.steps == 4
    path = latest_checkpoint(d)
    with np.load(path) as data:
        arrays = {k: data[k] for k in data.files if k != "__runtime"}
    with open(path, "wb") as f:
        np.savez(f, **arrays)
    r2 = _train(g, plan, cfg, steps=6, seed=1, checkpoint_dir=d, resume=True)
    assert r2.steps == 2
    assert r2.resilience["resumed_from_step"] == 4
    assert r2.resilience["runtime_restored"] is False
    # a checkpoint at or past ``steps``: an empty run, steps - step0 < 0
    r3 = _train(g, plan, cfg, steps=3, seed=1, checkpoint_dir=d, resume=True)
    assert r3.losses == [] and r3.steps == -3


class _Interrupt(Exception):
    """Stands for a Ctrl-C that lands while the host waits on a step."""


def test_interrupt_mid_step_checkpoints_the_step_before(setup, tmp_path,
                                                         monkeypatch):
    """An exception while step 5 waits on the next batch, after its
    ``train_step`` has run: the final checkpoint is labelled 5 and holds
    the parameters after step 4, so a resume replays step 5 once and the
    stitched losses are bitwise the uninterrupted run's."""
    from repro_torch.train.pipeline import Prefetcher

    g, plan = setup
    cfg = _cfg()
    d = str(tmp_path)
    full = _train(g, plan, cfg, steps=8, seed=2)
    get = Prefetcher.get
    calls = []

    def interrupt_seventh(self, *a, **kw):
        # call 1 primes step 0; call k + 2 fetches step k + 1's batch
        calls.append(1)
        if len(calls) == 7:
            raise _Interrupt
        return get(self, *a, **kw)

    monkeypatch.setattr(Prefetcher, "get", interrupt_seventh)
    with pytest.raises(_Interrupt):
        _train(g, plan, cfg, steps=8, seed=2, checkpoint_dir=d,
               checkpoint_every=100)
    monkeypatch.setattr(Prefetcher, "get", get)
    assert latest_checkpoint(d).endswith("ckpt_00000005.npz")
    rest = _train(g, plan, cfg, steps=8, seed=2, checkpoint_dir=d,
                  resume=True)
    assert rest.resilience["resumed_from_step"] == 5
    assert rest.resilience["runtime_restored"] is True
    assert full.losses[:5] + rest.losses == full.losses


# ---- degraded-clique re-meshing ----------------------------------------


def test_device_loss_remeshes_and_continues(remesh):
    """The reference's test without its loss-decrease assertion (red in the
    reference); the steps before the loss are bitwise a fault-free run's."""
    r, clean = remesh["port"], remesh["port_clean"]
    assert len(r.losses) == 10 and np.isfinite(r.losses).all()
    assert r.resilience["remesh_events"] == 1
    assert r.resilience["devices_lost"] == 1
    assert r.resilience["events"][0]["step"] == 5
    assert r.resilience["events"][0]["survivors"] == 3
    assert r.resilience["faults"]["injected_device_loss"] == 1
    assert r.losses[:5] == clean.losses[:5]


def test_device_loss_raise_policy_aborts(setup):
    g, plan = setup
    fp = FaultPlan([FaultSpec("device_loss", step=2,
                              dev=plan.partition.cliques[-1][-1])])
    with pytest.raises(RuntimeError, match="lost at step 2"):
        _train(g, plan, _cfg(), steps=5, seed=0,
               resilience=ResilienceConfig(fault_plan=fp,
                                           on_device_loss="raise"))


def test_device_loss_without_plan_rejected():
    g = powerlaw_graph(500, 6, seed=2, feat_dim=FEAT)
    fp = FaultPlan([FaultSpec("device_loss", step=1, dev=0)])
    with pytest.raises(ValueError, match="LegionPlan"):
        _train(g, None, _cfg(), steps=3,
               resilience=ResilienceConfig(fault_plan=fp))


def test_worker_restarts_exhausted_surfaces(setup):
    """More consecutive worker deaths than the restart budget: the typed
    injected fault propagates out of train_gnn unchanged."""
    g, plan = setup
    fp = FaultPlan([FaultSpec("prefetch_build", step=1, times=3)])
    with pytest.raises(InjectedWorkerDeath):
        _train(g, plan, _cfg(), steps=5, seed=0,
               resilience=ResilienceConfig(fault_plan=fp, worker_restarts=1))


# ---- state_dict roundtrips ---------------------------------------------


def test_cache_manager_state_roundtrip(setup):
    g, plan = setup
    rc = RefreshConfig(interval=4)
    m1 = OnlineCacheManager(g, plan, rc)
    obs = m1.observer_for(plan.partition.cliques[0][0])
    rng = np.random.default_rng(0)
    for _ in range(5):
        obs.record([rng.integers(0, g.n, 16),
                    rng.integers(0, g.n, 64)], (4, 2))
    m1.on_step(4)
    state = m1.state_dict()
    m2 = OnlineCacheManager(g, plan, rc)
    m2.load_state_dict(state, reapply=False)
    for ci in range(len(state["blended"])):
        b1, b2 = m1._blended[ci], m2._blended[ci]
        np.testing.assert_array_equal(b1.H_T, b2.H_T)
        np.testing.assert_array_equal(b1.H_F, b2.H_F)
        assert b1.N_TSUM == b2.N_TSUM


def test_cache_manager_restore_rejects_layout_change(setup):
    g, plan = setup
    rc = RefreshConfig(interval=4)
    state = OnlineCacheManager(g, plan, rc).state_dict()
    plan2 = build_plan(g, topology_matrix("nv2", 4), **PLAN)
    with pytest.raises(ValueError, match="replan"):
        OnlineCacheManager(g, plan2, rc).load_state_dict(state)


def test_feature_store_state_roundtrip():
    g = powerlaw_graph(800, 6, seed=3, feat_dim=8)
    cfg = TieredStoreConfig(host_rows=128, async_fills=False)
    s1 = FeatureStore(g, cfg)
    rng = np.random.default_rng(1)
    for _ in range(6):
        s1.gather(rng.integers(0, g.n, 48).astype(np.int64))
    state = s1.state_dict()
    s2 = FeatureStore(g, cfg)
    restored = s2.load_state_dict(state)
    assert restored == len(state["ids"])
    ids = np.asarray(state["ids"][:16], dtype=np.int64)
    before = s2.summary()["host_hits"]
    np.testing.assert_array_equal(s2.gather(ids), g.get_features(ids))
    assert s2.summary()["host_hits"] - before == len(ids)


# ---- telemetry integration ---------------------------------------------


def test_fault_and_recovery_counters_reach_telemetry(tmp_path, setup):
    from repro_torch.obs import TelemetryConfig
    import io

    from repro_torch.obs.report import digest, load_stream, print_report

    g, plan = setup
    fp = FaultPlan([FaultSpec("prefetch_build", step=2)])
    jsonl = str(tmp_path / "run.jsonl")
    _train(g, plan, _cfg(), steps=6, seed=0,
           telemetry=TelemetryConfig(jsonl_path=jsonl, window=3,
                                     profiler_annotations=False),
           resilience=ResilienceConfig(fault_plan=fp))
    d = digest(load_stream(jsonl))
    assert d["resilience"]["fault.injected_total"] == 1
    assert d["resilience"]["fault.worker_deaths"] == 1
    assert d["resilience"]["recovery.worker_restarts"] == 1
    assert d["straggler"]["steps"] == 6
    out = io.StringIO()
    print_report(d, out=out)
    assert "faults/recovery: " in out.getvalue()


# ---- the port against the reference ------------------------------------


def _ref_params(seed):
    p0 = j_init(j_defs(JConfig(**CFG)), jax.random.PRNGKey(seed))
    return params_from_jax(jax.tree_util.tree_map(np.asarray, p0), "cpu")


def _equal(a, b, path="") -> None:
    """Recursive equality over dicts, lists and numpy arrays."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), path
        for k in a:
            _equal(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=path)
        assert np.asarray(a).dtype == np.asarray(b).dtype, path
    else:
        assert a == b, (path, a, b)


def _store():
    return dict(host_rows=400, async_fills=False, lookahead=2)


@pytest.fixture(scope="module")
def kill_resume(tmp_path_factory):
    """Kill at step 6 and resume to 12, refresh every 4, a store with
    lookahead 2, seed 9, in both packages; the port also resumes from a
    copy of the reference's checkpoint directory."""
    kw = dict(steps=12, seed=9, refresh_interval=4, prefetch_workers=1)
    jd = str(tmp_path_factory.mktemp("ref_ckpt"))
    td = str(tmp_path_factory.mktemp("port_ckpt"))
    jcopy = str(tmp_path_factory.mktemp("ref_copy") / "ck")

    def j_run(**over):
        g = j_graph(3000, 8, seed=11, feat_dim=FEAT)
        plan = j_build_plan(g, j_topo("nv2", 2), **PLAN)
        return j_train(g, plan, JConfig(**CFG),
                       feature_store=JStoreConfig(**_store()),
                       **dict(kw, **over))

    def t_run(**over):
        g = powerlaw_graph(3000, 8, seed=11, feat_dim=FEAT)
        plan = build_plan(g, topology_matrix("nv2", 2), **PLAN)
        return train_gnn(g, plan, GNNConfig(**CFG), device="cpu",
                         params=_ref_params(9),
                         feature_store=TieredStoreConfig(**_store()),
                         **dict(kw, **over))

    ref = {"full": j_run(),
           "first": j_run(steps=6, checkpoint_dir=jd, checkpoint_every=3)}
    shutil.copytree(jd, jcopy)
    ref["second"] = j_run(checkpoint_dir=jd, resume=True)
    port = {"full": t_run(),
            "first": t_run(steps=6, checkpoint_dir=td, checkpoint_every=3),
            "from_ref": t_run(checkpoint_dir=jcopy, resume=True)}
    port["second"] = t_run(checkpoint_dir=td, resume=True)
    return {"ref": ref, "port": port, "dirs": (jd, td)}


def test_runtime_state_at_a_boundary_equals_the_reference(kill_resume):
    """(ii) the checkpoint at step 6 of both packages: the same leaves
    count, and a runtime payload equal key for key (per-device RNG states,
    the manager's and the store's state dicts)."""
    jd, td = kill_resume["dirs"]
    paths = [f"{d}/ckpt_00000006.npz" for d in (jd, td)]
    with np.load(paths[0]) as a, np.load(paths[1]) as b:
        rj = pickle.loads(bytes(a["__runtime"]))
        rt = pickle.loads(bytes(b["__runtime"]))
    assert sorted(rt) == ["devices", "manager", "rng", "store", "version"]
    _equal(rt, rj)


@pytest.mark.parametrize("which", ["second", "from_ref"])
def test_kill_and_resume_matches_reference(kill_resume, which):
    """(iii) the port's kill-and-resume against the reference's, and (iv)
    the port resuming from the directory the reference wrote: losses within
    rtol 1e-4 of the reference's resumed run, hit tallies bitwise."""
    ref, port = kill_resume["ref"], kill_resume["port"]
    np.testing.assert_allclose(port["first"].losses, ref["first"].losses,
                               **TOL)
    got, want = port[which], ref["second"]
    np.testing.assert_allclose(got.losses, want.losses, **TOL)
    assert got.resilience["resumed_from_step"] == 6
    assert got.resilience["runtime_restored"] is True
    for t in TALLIES:
        assert getattr(got.counter, t) == getattr(want.counter, t), t
    assert got.refresh["events"] == want.refresh["events"]


def test_replan_on_topology_change_matches_reference():
    """(i) the same plan and survivors: cliques, tablets, hotness, cache
    residency and cost plans bitwise the reference's."""
    jg = j_graph(3000, 8, seed=11, feat_dim=FEAT)
    tg = powerlaw_graph(3000, 8, seed=11, feat_dim=FEAT)
    jp = j_build_plan(jg, j_topo("dgx-v100", 4), **PLAN)
    tp = build_plan(tg, topology_matrix("dgx-v100", 4), **PLAN)
    alive = [0, 1, 2]
    jn = j_replan(jg, jp, j_topology_from_partition(jp.partition),
                  alive=alive)
    tn = replan_on_topology_change(tg, tp,
                                   topology_from_partition(tp.partition),
                                   alive=alive)
    assert tn.partition.cliques == jn.partition.cliques
    _equal(tn.partition.tablets, jn.partition.tablets)
    for a, b in zip(tn.stats, jn.stats):
        _equal((a.H_T, a.H_F, a.N_TSUM), (b.H_T, b.H_F, b.N_TSUM))
    for a, b in zip(tn.caches, jn.caches):
        _equal(a.feat_ids_by_device(), b.feat_ids_by_device())
        _equal(a.topo_ids_per_dev, b.topo_ids_per_dev)
        assert a.devices == b.devices
    assert len(tn.cost_plans) == len(jn.cost_plans)
    for a, b in zip(tn.cost_plans, jn.cost_plans):
        _equal(a, b)
    assert tn.mem_per_device == jn.mem_per_device
    assert tn.topology_mode == jn.topology_mode


@pytest.fixture(scope="module")
def remesh():
    """The reference's device-loss run (4 devices of ``nv2``, device 3
    lost at step 5 of 10, device backend, seed 7) and the same loss at the
    last of 6 steps, in both packages, and the port's fault-free run.
    Builds are serial: in one loaded full run with the default build
    pool, the reference's 6-step run gave other losses from step 0 on than
    its 10-step run in the same process (cause not traced; its
    ``test_hierarchy_suite`` flake is a race of concurrent builds)."""
    def run(steps, fault=True, ref=False):
        if ref:
            g = j_graph(3000, 8, seed=11, feat_dim=FEAT)
            plan = j_build_plan(g, j_topo("nv2", 4), **PLAN)
            fp = JFaultPlan([JFaultSpec("device_loss", step=5, dev=3)])
            return j_train(g, plan, JConfig(**CFG), steps=steps, seed=7,
                           backend="device", prefetch_workers=1,
                           resilience=JResilienceConfig(fault_plan=fp))
        g = powerlaw_graph(3000, 8, seed=11, feat_dim=FEAT)
        plan = build_plan(g, topology_matrix("nv2", 4), **PLAN)
        assert len(plan.partition.tablets) == 4
        fp = FaultPlan([FaultSpec("device_loss", step=5, dev=3)])
        return train_gnn(g, plan, GNNConfig(**CFG), steps=steps, seed=7,
                         backend="device", device="cpu", prefetch_workers=1,
                         params=_ref_params(7),
                         resilience=(ResilienceConfig(fault_plan=fp)
                                     if fault else None))

    return {"ref": run(10, ref=True), "port": run(10),
            "ref_last": run(6, ref=True), "port_last": run(6),
            "port_clean": run(10, fault=False)}


def _events(r):
    return [{k: v for k, v in e.items() if k != "remesh_s"}
            for e in r.resilience["events"]]


@pytest.mark.parametrize("run", ["", "_last"])
def test_device_loss_remesh_matches_reference(remesh, run):
    """(v) losses within rtol 1e-4 of the reference's remesh run and the
    same events (but for the wall time of the remesh).  The traffic tallies
    are held bitwise where they are reproducible: with the loss at the
    last step the old pipeline has built every batch (its limit) when the
    remesh discards them, while after a loss at step 5 of 10 it has built
    a timing-dependent number of batches ahead, in either package."""
    got, want = remesh["port" + run], remesh["ref" + run]
    np.testing.assert_allclose(got.losses, want.losses, **TOL)
    assert _events(got) == _events(want)
    assert got.backend == want.backend == "device"
    for k in ("remesh_events", "devices_lost", "cache_rebuilds",
              "resumed_from_step", "runtime_restored"):
        assert got.resilience[k] == want.resilience[k], k
    if run == "_last":
        for t in TALLIES:
            assert getattr(got.counter, t) == getattr(want.counter, t), t
        np.testing.assert_array_equal(got.counter.bytes_matrix,
                                      want.counter.bytes_matrix)
        assert got.pipeline["batches_built"] \
            == want.pipeline["batches_built"] == 7


def test_sharded_backend_falls_back_to_device_after_a_remesh():
    """The sharded mesh cannot shrink in place: after a device loss the run
    continues on the device backend, its steps before the loss bitwise a
    fault-free sharded run's."""
    g = powerlaw_graph(3000, 8, seed=11, feat_dim=FEAT)

    def run(fp=None):
        plan = build_plan(g, topology_matrix("dgx-v100", 4), **PLAN)
        return _train(g, plan, _cfg(), steps=6, seed=4, backend="sharded",
                      resilience=(None if fp is None
                                  else ResilienceConfig(fault_plan=fp)))

    clean = run()
    r = run(FaultPlan([FaultSpec("device_loss", step=3, dev=3)]))
    assert r.losses[:3] == clean.losses[:3]
    assert len(r.losses) == 6 and np.isfinite(r.losses).all()
    assert clean.backend == "sharded" and r.backend == "device"
    assert r.resilience["events"][0]["backend"] == "device"
    assert r.resilience["events"][0]["survivors"] == 3
    assert r.pipeline["batches_built"] >= 6


@pytest.mark.parametrize("steps", [10, 6])
def test_remesh_is_reproducible_across_backends(remesh, steps):
    """The host backend and a second device run give bitwise the device
    run's losses and events (each naming its backend) after a loss at step
    5.  With 10 steps the old pipeline has run ahead of the loss by a
    timing-dependent number of builds, which the remesh discards; with 6
    the loss is at the last step, where it has built every batch, and the
    traffic tallies are bitwise too."""
    want = remesh["port" if steps == 10 else "port_last"]
    for backend in ("host", "device"):
        g = powerlaw_graph(3000, 8, seed=11, feat_dim=FEAT)
        plan = build_plan(g, topology_matrix("nv2", 4), **PLAN)
        fp = FaultPlan([FaultSpec("device_loss", step=5, dev=3)])
        got = _train(g, plan, _cfg(), steps=steps, seed=7, backend=backend,
                     params=_ref_params(7), prefetch_workers=1,
                     resilience=ResilienceConfig(fault_plan=fp))
        assert got.losses == want.losses, backend
        assert [dict(e, backend=backend) for e in _events(want)] \
            == _events(got)
        # every step's batch, the discarded one at step 5 included
        assert got.pipeline["batches_built"] >= steps + 1
        if steps == 6:
            for t in TALLIES:
                assert getattr(got.counter, t) == getattr(want.counter, t), t
            assert got.pipeline["batches_built"] == 7


def test_remesh_with_a_store_discards_the_announced_batches(remesh):
    """A loss that the lookahead window has already sampled and announced
    past: the remesh drops the old windows' batches, the store serves the
    survivors' batches, and the losses are bitwise the storeless remesh
    run's."""
    g = powerlaw_graph(3000, 8, seed=11, feat_dim=FEAT)
    plan = build_plan(g, topology_matrix("nv2", 4), **PLAN)
    fp = FaultPlan([FaultSpec("device_loss", step=5, dev=3)])
    got = _train(g, plan, _cfg(), steps=10, seed=7, backend="device",
                 params=_ref_params(7), prefetch_workers=1,
                 feature_store=TieredStoreConfig(**_store()),
                 resilience=ResilienceConfig(fault_plan=fp))
    assert got.losses == remesh["port"].losses
    assert _events(got) == _events(remesh["port"])
    assert got.store["announced_batches"] > 0
