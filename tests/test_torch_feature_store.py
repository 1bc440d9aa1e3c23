"""The tiered feature store in the port (``repro_torch.core.feature_store``)
against the reference's: the same ``announce``/``prefetch``/``gather`` calls
give bitwise-identical rows, resident ids, ``summary()`` tallies and
``state_dict()`` in both packages, under both eviction policies; reads
retry transient ``OSError``s the same way; a training run whose feature
table is only in a file trains bitwise as the all-in-RAM run on the host,
device and sharded backends; and sampling ahead while online refreshes
replace the topology cache raises nothing and changes no loss."""
import numpy as np
import pytest

from repro.core.feature_store import FeatureStore as JStore
from repro.core.feature_store import TieredStoreConfig as JConfig
from repro.graph.csr import powerlaw_graph as j_graph
from repro_torch.core.cache_manager import RefreshConfig
from repro_torch.core.cliques import topology_matrix
from repro_torch.core.feature_store import (NO_NEXT_USE, POLICIES,
                                            FeatureStore, TieredStoreConfig)
from repro_torch.core.planner import build_plan
from repro_torch.graph.csr import powerlaw_graph
from repro_torch.models.gnn import GNNConfig
from repro_torch.train.loop import train_gnn
from repro_torch.train.pipeline import LookaheadWindow

N, DEG, FEAT = 3000, 8, 16
# wall-clock tallies: host time, not part of the comparison
TIMES = ("ssd_read_s", "stall_s")


@pytest.fixture(scope="module")
def feature_file(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("feat") / "features.npy")
    powerlaw_graph(N, DEG, seed=7, feat_dim=FEAT).save_feature_file(path)
    return path


def _graphs(path):
    gt = powerlaw_graph(N, DEG, seed=7, feat_dim=FEAT)
    gj = j_graph(N, DEG, seed=7, feat_dim=FEAT)
    gt.feature_file = gj.feature_file = path
    return gt, gj


def _script(name: str, rng):
    """A sequence of store calls: ("announce"|"prefetch"|"gather", step,
    ids).  Every scenario is a stream of 24 batches over 600 hot ids."""
    batches = [rng.choice(600, size=int(rng.integers(50, 220)),
                          replace=False).astype(np.int64)
               for _ in range(24)]
    ops = []
    for s, ids in enumerate(batches):
        if name in ("window", "prefetched"):
            for f in range(s, min(s + 6, len(batches))):
                if f == s + 5 or s == 0:
                    ops.append(("announce", f, batches[f]))
                    if name == "prefetched":
                        ops.append(("prefetch", f, batches[f]))
        elif name == "oversized" and s % 5 == 0:
            ids = np.arange(400, dtype=np.int64)
        ops.append(("gather", s, ids))
    return ops


def _drive(store, ops):
    rows = []
    for op, step, ids in ops:
        if op == "announce":
            store.announce(step, ids)
        elif op == "prefetch":
            store.prefetch(step, ids, dev=0)
        else:
            rows.append(store.gather(ids, step=step, dev=0))
    store.close()
    return rows


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("scenario,host_rows", [
    ("plain", 256), ("window", 256), ("prefetched", 256),
    ("oversized", 128), ("plain", 0)])
def test_store_equals_the_reference(feature_file, scenario, host_rows,
                                    policy):
    gt, gj = _graphs(feature_file)
    ops = _script(scenario, np.random.default_rng(11))
    kw = dict(host_rows=host_rows, policy=policy, lookahead=6)
    t = FeatureStore(gt, TieredStoreConfig(**kw))
    j = JStore(gj, JConfig(**kw))
    rows_t, rows_j = _drive(t, ops), _drive(j, ops)
    for (op, _, ids), rt, rj in zip([o for o in ops if o[0] == "gather"],
                                    rows_t, rows_j):
        np.testing.assert_array_equal(rt, rj)
        np.testing.assert_array_equal(rt, gt.get_features(ids))
    assert sorted(t._ids[t._ids >= 0]) == sorted(j._ids[j._ids >= 0])
    st, sj = t.summary(), j.summary()
    for k in TIMES:
        assert isinstance(st.pop(k), float) and isinstance(sj.pop(k), float)
    assert st == sj and st["host_requests"] > 0
    dt, dj = t.state_dict(), j.state_dict()
    for k in ("ids", "next_use", "last_use"):
        np.testing.assert_array_equal(dt.pop(k), dj.pop(k))
    assert dt == dj


@pytest.mark.parametrize("refill", [True, False])
def test_state_dict_roundtrip_equals_the_reference(feature_file, refill):
    """A capture restored into a smaller store keeps the most recently used
    rows in both packages, and the restored store serves the same rows
    from the same tier."""
    gt, gj = _graphs(feature_file)
    ops = _script("window", np.random.default_rng(3))
    t0 = FeatureStore(gt, TieredStoreConfig(host_rows=256))
    _drive(t0, ops[:len(ops) // 2])
    state = t0.state_dict()
    t = FeatureStore(gt, TieredStoreConfig(host_rows=100))
    j = JStore(gj, JConfig(host_rows=100))
    assert t.load_state_dict(state, refill=refill) == \
        j.load_state_dict(state, refill=refill)
    assert t.host_hits == j.host_hits == state["tallies"]["host_hits"]
    ids = np.arange(600, dtype=np.int64)
    np.testing.assert_array_equal(t.gather(ids, step=50),
                                  j.gather(ids, step=50))
    assert t.host_hits == j.host_hits
    assert (t.host_hits > state["tallies"]["host_hits"]) == refill


class _Flaky:
    """A feature source whose first ``fail`` reads raise OSError."""

    def __init__(self, g, fail: int):
        self.g, self.fail = g, fail
        self.n, self.feat_dim = g.n, g.feat_dim

    def get_features(self, ids):
        if self.fail:
            self.fail -= 1
            raise OSError("transient read error")
        return self.g.get_features(ids)


@pytest.mark.parametrize("fail", [0, 1, 2, 3])
def test_read_retries_equal_the_reference(feature_file, fail):
    gt, gj = _graphs(feature_file)
    ids = np.arange(40, dtype=np.int64)
    out = []
    for cls, cfg, g in ((FeatureStore, TieredStoreConfig, gt),
                        (JStore, JConfig, gj)):
        store = cls(_Flaky(g, fail), cfg(host_rows=64, read_retries=2,
                                          retry_backoff_s=0.0))
        if fail > 2:
            with pytest.raises(OSError):
                store.gather(ids, step=0)
        else:
            np.testing.assert_array_equal(store.gather(ids, step=0),
                                          gt.get_features(ids))
        out.append((store.read_errors, store.read_retries_used))
    assert out[0] == out[1] == (fail, min(fail, 2))


@pytest.mark.parametrize("bad", [dict(host_rows=-1),
                                 dict(host_rows=4, policy="belady"),
                                 dict(host_rows=4, lookahead=-2),
                                 dict(host_rows=4, async_workers=0),
                                 dict(host_rows=4, read_retries=-1),
                                 dict(host_rows=4, retry_backoff_s=-1.0)])
def test_config_validation_equals_the_reference(bad):
    with pytest.raises(ValueError):
        JConfig(**bad)
    with pytest.raises(ValueError):
        TieredStoreConfig(**bad)


def test_announce_keeps_next_use_sorted(feature_file):
    gt, _ = _graphs(feature_file)
    store = FeatureStore(gt, TieredStoreConfig(host_rows=8))
    v = np.array([3], dtype=np.int64)
    for step in (5, 2, 9):
        store.announce(step, v)
    assert store._future[3] == [2, 5, 9] and NO_NEXT_USE > 9


class _Builder:
    """Records the window's calls (sample order, fills)."""

    def __init__(self):
        self.filled = []

    def store_request_ids(self, spec):
        return np.array([spec], dtype=np.int64)

    def fill_spec(self, spec, step=None):
        self.filled.append((spec, step))
        return spec


@pytest.mark.parametrize("window", [0, 1, 4])
def test_lookahead_window_samples_in_order_up_to_the_limit(feature_file,
                                                           window):
    gt, _ = _graphs(feature_file)
    store = FeatureStore(gt, TieredStoreConfig(host_rows=8))
    sampled = []
    b = _Builder()
    win = LookaheadWindow(b, store, lambda s: sampled.append(s) or s,
                          window=window, limit=6)
    assert [win.build(s) for s in range(6)] == list(range(6))
    assert sampled == list(range(6))  # never past the limit
    assert b.filled == [(s, s) for s in range(6)]
    assert store.announced_batches == 6
    with pytest.raises(RuntimeError, match="out of order"):
        LookaheadWindow(b, store, lambda s: s, window=window).build(3)


# ---------------- training from a file ----------------

CFG = dict(feat_dim=16, hidden=16, batch_size=64, fanouts=(4, 3), lr=1e-2)


def _train(path, backend, topo, *, store=None, steps=6, **kw):
    g = powerlaw_graph(2000, 8, seed=5, feat_dim=16)
    if path is not None:
        g.detach_features(path)
    plan = build_plan(g, topology_matrix(*topo), mem_per_device=50_000,
                      batch_size=64, seed=0, fanouts=(4, 3))
    return train_gnn(g, plan, GNNConfig(**CFG), steps=steps, seed=0,
                     backend=backend, device="cpu", feature_store=store,
                     **kw)


@pytest.mark.parametrize("backend,topo", [
    ("host", ("nv2", 2)), ("device", ("nv2", 2)),
    ("sharded", ("dgx-v100", 4))])
def test_train_from_file_bitwise_matches_ram(tmp_path, backend, topo):
    """Features only in an .npy file, a host tier far below the table:
    the losses equal the all-in-RAM run's bit for bit."""
    path = str(tmp_path / "f.npy")
    powerlaw_graph(2000, 8, seed=5, feat_dim=16).save_feature_file(path)
    ram = _train(None, backend, topo)
    ssd = _train(path, backend, topo,
                 store=TieredStoreConfig(host_rows=150, lookahead=3))
    assert ssd.losses == ram.losses
    s = ssd.store
    assert s["ssd_fill_rows"] > 0 and s["capacity_rows"] == 150
    assert s["host_requests"] == s["hbm_requests"] - s["hbm_hits"]
    assert s["hbm_requests"] == ssd.counter.feature_requests
    assert ssd.counter.feature_hits == ram.counter.feature_hits
    assert s["announced_batches"] == 6 * len(ssd.counter.bytes_matrix)


@pytest.mark.parametrize("attempt", range(3))
def test_lookahead_across_refreshes_raises_nothing(tmp_path, attempt):
    """Lookahead 4 with a refresh every 2 steps: pre-sampled specs straddle
    topology and feature refreshes on two concurrent build threads.  No
    error, and the losses equal the storeless run's."""
    path = str(tmp_path / "f.npy")
    powerlaw_graph(2000, 8, seed=5, feat_dim=16).save_feature_file(path)
    kw = dict(steps=10, prefetch_depth=1, prefetch_workers=2,
              refresh_config=RefreshConfig(interval=2, drift_threshold=1.0))
    plain = _train(None, "device", ("nv2", 2), **kw)
    ahead = _train(path, "device", ("nv2", 2), lookahead=4,
                   store=TieredStoreConfig(host_rows=150), **kw)
    assert ahead.losses == plain.losses
    assert ahead.refresh["refreshes"] >= 2
    assert ahead.refresh["topo_rebuilds"] >= 1
