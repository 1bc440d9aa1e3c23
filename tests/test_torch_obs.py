"""Telemetry in the port (``repro_torch.obs``) against the reference's
``repro.obs``: the same registry operations give identical snapshots, the
same quantiles, the schema accepts and rejects the same lines, the reporter
digests one stream identically; spans balance across threads and a
dangling span is reported at close; a ``train_gnn`` stream validates,
telescopes, and carries the reference run's integer ``traffic.*``,
``refresh.*``, ``store.*`` counters and ``cache.*`` gauges exactly; a
``GNNServer`` with telemetry and a store answers as its oracle and
publishes ``serve.*`` totals equal to ``summary()``."""
import json
import threading

import jax
import numpy as np
import pytest
import torch

from repro.core.cache_manager import RefreshConfig as JRefresh
from repro.core.cliques import topology_matrix as j_topo
from repro.core.feature_store import TieredStoreConfig as JStoreConfig
from repro.core.planner import build_plan as j_build_plan
from repro.graph.csr import powerlaw_graph as j_graph
from repro.models.gnn import GNNConfig as JConfig
from repro.models.gnn import defs as j_defs
from repro.models.params import init_from_defs as j_init
from repro.obs import Telemetry as JTelemetry
from repro.obs import TelemetryConfig as JTelemetryConfig
from repro.obs import metrics as j_metrics
from repro.obs import report as j_report
from repro.obs import schema as j_schema
from repro.train.loop import train_gnn as j_train
from repro_torch.core.cache_manager import RefreshConfig
from repro_torch.core.cliques import topology_matrix as t_topo
from repro_torch.core.feature_store import FeatureStore, TieredStoreConfig
from repro_torch.core.planner import build_plan as t_build_plan
from repro_torch.core.unified_cache import TrafficCounter
from repro_torch.graph.csr import powerlaw_graph as t_graph
from repro_torch.models.convert import params_from_jax
from repro_torch.models.gnn import GNNConfig, defs as t_defs
from repro_torch.models.params import init_from_defs as t_init
from repro_torch.obs import (SCHEMA_VERSION, Telemetry, TelemetryConfig,
                             activity_count, maybe_span, sum_counter_deltas)
from repro_torch.obs import metrics as t_metrics
from repro_torch.obs import report as t_report
from repro_torch.obs import schema as t_schema
from repro_torch.obs.sinks import ChromeTraceSink
from repro_torch.serve import GNNServer, ServeConfig
from repro_torch.train.loop import train_gnn

# integer counters (and gauges) whose final totals must equal the
# reference's; time-valued counters (store.read_us, store.stall_us,
# prefetch.*_s) are host wall clock and left out
COMPARED = ("traffic.", "refresh.", "cache.", "store.")
TIME_VALUED = ("store.read_us", "store.stall_us")


# ---------------- registry, quantiles, schema: both packages ----------------

def _drive(mod, seed: int):
    """One scripted, seeded sequence of counter/gauge/histogram operations
    with a window snapshot after each phase; returns every snapshot."""
    rng = np.random.default_rng(seed)
    reg = mod.MetricsRegistry()
    out = []
    for phase in range(4):
        for _ in range(int(rng.integers(1, 20))):
            reg.counter("c", tier=str(int(rng.integers(0, 3)))).inc(
                int(rng.integers(0, 100)))
        reg.counter("mirror").set_total(10 * phase + int(rng.integers(0, 5)))
        reg.gauge("g", clique=phase % 2).set(float(rng.random()))
        h = reg.histogram("h", edges=(1e-3, 1e-2, 1e-1, 1.0))
        for v in rng.exponential(0.05, int(rng.integers(0, 30))):
            h.observe(float(v))
        out.append(reg.window_snapshot())
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_registry_snapshots_equal_the_reference(seed):
    assert _drive(t_metrics, seed) == _drive(j_metrics, seed)


@pytest.mark.parametrize("q", [0.0, 0.01, 0.25, 0.5, 0.9, 0.99, 1.0])
def test_quantile_from_counts_equals_the_reference(q):
    rng = np.random.default_rng(3)
    edges = tuple(float(e) for e in np.linspace(0.1, 10.0, 12))
    for counts in ([0] * 13, [5] + [0] * 12, [0] * 12 + [4],
                   list(rng.integers(0, 20, 13))):
        counts = [int(c) for c in counts]
        assert t_metrics.quantile_from_counts(edges, counts, q) == \
            j_metrics.quantile_from_counts(edges, counts, q)


_SPAN = {"v": SCHEMA_VERSION, "kind": "span", "name": "s", "ts_us": 1.0,
         "dur_us": 2.0, "tid": 7, "thread": "main"}
_SNAP = {"v": SCHEMA_VERSION, "kind": "snapshot", "step": 5, "from_step": 0,
         "ts_us": 1.0, "counters": {"c": {"total": 3, "delta": 3}},
         "gauges": {"g": 1.5},
         "hists": {"h": {"edges": [1.0], "counts": [1, 0], "delta": [1, 0],
                         "sum": 0.5, "count": 1}}}
_MALFORMED = {
    "unknown kind": dict(_SPAN, kind="nope"),
    "extra field": dict(_SPAN, bogus=1),
    "wrong type": dict(_SPAN, ts_us="late"),
    "bool as number": dict(_SPAN, dur_us=True),
    "negative duration": dict(_SPAN, dur_us=-1.0),
    "future schema": dict(_SPAN, v=SCHEMA_VERSION + 1),
    "missing name": {k: v for k, v in _SPAN.items() if k != "name"},
    "counter without delta": dict(_SNAP, counters={"c": {"total": 3}}),
    "short histogram": dict(_SNAP, hists={"h": {
        "edges": [1.0], "counts": [1], "delta": [1], "sum": 0.5,
        "count": 1}}),
    "not an object": [1, 2],
}


@pytest.mark.parametrize("case", sorted(_MALFORMED))
def test_schema_rejects_what_the_reference_rejects(case):
    bad = _MALFORMED[case]
    with pytest.raises(j_schema.TelemetrySchemaError):
        j_schema.validate_line(bad)
    with pytest.raises(t_schema.TelemetrySchemaError):
        t_schema.validate_line(bad)


@pytest.mark.parametrize("line", [_SPAN, _SNAP], ids=["span", "snapshot"])
def test_schema_accepts_what_the_reference_accepts(line):
    assert t_schema.validate_line(line) == j_schema.validate_line(line)
    with pytest.raises(t_schema.TelemetrySchemaError, match="meta"):
        t_schema.validate_stream([line])


# ---------------- spans ----------------

def test_disabled_path_runs_no_telemetry_code():
    before = activity_count()
    ctx = maybe_span(None, "anything", step=3)
    with ctx:
        pass
    assert maybe_span(None, "x") is ctx  # shared singleton, no allocation
    assert activity_count() == before


@pytest.mark.parametrize("annotations", [False, True])
def test_span_balance_across_threads(tmp_path, annotations):
    """Spans from several threads, with and without the profiler bridge
    (record_function is opened and closed on each span's own thread)."""
    path = str(tmp_path / "spans.jsonl")
    tele = Telemetry(TelemetryConfig(jsonl_path=path,
                                     profiler_annotations=annotations))

    def worker(i):
        with tele.span("outer", step=i, dev=i):
            with tele.span("inner", step=i):
                pass

    threads = [threading.Thread(target=worker, args=(i,), name=f"w{i}")
               for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert tele.open_spans == 0 and tele.span_count == 8
    tele.close()
    spans = [ln for ln in t_report.load_stream(path) if ln["kind"] == "span"]
    assert {s["thread"] for s in spans} == {f"w{i}" for i in range(4)}
    for name in {s["thread"] for s in spans}:
        own = sorted((s for s in spans if s["thread"] == name),
                     key=lambda s: s["ts_us"])
        for a, b in zip(own, own[1:]):
            a_end = a["ts_us"] + a["dur_us"]
            contained = (b["ts_us"] >= a["ts_us"]
                         and b["ts_us"] + b["dur_us"] <= a_end + 1e-6)
            assert contained or b["ts_us"] >= a_end - 1e-6


def test_profiler_sees_the_span_ranges():
    tele = Telemetry(TelemetryConfig())
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tele.span("device_step", step=0):
            torch.ones(4).sum()
    tele.close()
    assert "device_step" in {e.name for e in prof.events()}


def test_dangling_span_reported_at_close(tmp_path):
    path = str(tmp_path / "dangle.jsonl")
    tele = Telemetry(TelemetryConfig(jsonl_path=path,
                                     profiler_annotations=False))
    tele.span("never_exits").__enter__()
    tele.close()  # reported, not raised
    events = [ln for ln in t_report.load_stream(path) if ln["kind"] == "event"]
    assert any(e["name"] == "dangling_spans" and e["attrs"]["count"] == 1
               for e in events)


def test_chrome_trace_sink_caps_span_events(tmp_path):
    path = str(tmp_path / "trace.json")
    sink = ChromeTraceSink(path, max_events=2)
    for i in range(5):
        sink.add_span("s", float(i), 1.0, 1, "main", i, {})
    sink.add_counter("c", 0.0, 1.0)
    sink.close()
    names = [e["name"] for e in json.load(open(path))["traceEvents"]]
    assert names.count("s") == 2 and names.count("c") == 1


def test_window_config_validated():
    with pytest.raises(ValueError, match="window"):
        TelemetryConfig(window=0)


# ---------------- train_gnn streams: the port against the reference ---------

STEPS = 10
CFG = dict(feat_dim=16, hidden=16, batch_size=64, fanouts=(4, 3), lr=1e-2)
PLAN = dict(mem_per_device=50_000, batch_size=64, seed=0, fanouts=(4, 3))
STORE = dict(host_rows=150, lookahead=3)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The same two-device run (device backend, refresh every 4 steps, a
    file-backed feature table behind a 150-row store, lookahead 3, serial
    builds so the shared store sees one order) in both packages, with
    telemetry; plus the port's run without telemetry or store."""
    d = tmp_path_factory.mktemp("obs")
    path = str(d / "features.npy")
    t_graph(2000, 8, seed=5, feat_dim=16).save_feature_file(path)
    kw = dict(steps=STEPS, seed=0, backend="device", prefetch_workers=1)

    gj = j_graph(2000, 8, seed=5, feat_dim=16)
    gj.feature_file = path
    jt = JTelemetry(JTelemetryConfig(jsonl_path=str(d / "j.jsonl"),
                                     window=4, jax_annotations=False))
    rj = j_train(gj, j_build_plan(gj, j_topo("nv2", 2), **PLAN),
                 JConfig(**CFG), telemetry=jt,
                 feature_store=JStoreConfig(**STORE),
                 refresh_config=JRefresh(interval=4, drift_threshold=1.0),
                 **kw)
    p0 = params_from_jax(jax.tree_util.tree_map(
        np.asarray, j_init(j_defs(JConfig(**CFG)), jax.random.PRNGKey(0))),
        "cpu")

    gt = t_graph(2000, 8, seed=5, feat_dim=16)
    gt.feature_file = path
    plan_t = t_build_plan(gt, t_topo("nv2", 2), **PLAN)
    counter = TrafficCounter.for_plan(plan_t)
    tt = Telemetry(TelemetryConfig(jsonl_path=str(d / "t.jsonl"),
                                   trace_path=str(d / "t.json"), window=4,
                                   run="test"))
    rt = train_gnn(gt, plan_t, GNNConfig(**CFG), device="cpu", params=p0,
                   counter=counter, telemetry=tt,
                   feature_store=TieredStoreConfig(**STORE),
                   refresh_config=RefreshConfig(interval=4,
                                                drift_threshold=1.0), **kw)
    g0 = t_graph(2000, 8, seed=5, feat_dim=16)
    before = activity_count()
    r0 = train_gnn(g0, t_build_plan(g0, t_topo("nv2", 2), **PLAN),
                   GNNConfig(**CFG), device="cpu", params=p0,
                   refresh_config=RefreshConfig(interval=4,
                                                drift_threshold=1.0), **kw)
    return {"j": rj, "t": rt, "off": r0, "counter": counter,
            "off_activity": activity_count() - before,
            "j_jsonl": str(d / "j.jsonl"), "t_jsonl": str(d / "t.jsonl"),
            "t_trace": str(d / "t.json")}


def _final(path: str):
    snaps = [ln for ln in t_report.load_stream(path)
             if ln["kind"] == "snapshot"]
    return snaps, snaps[-1]


def test_stream_validates_telescopes_and_reports(runs):
    lines = t_report.load_stream(runs["t_jsonl"])  # validates every line
    assert lines[0]["kind"] == "meta" and lines[0]["run"] == "test"
    res = runs["t"]
    assert res.telemetry["open_spans"] == 0 and res.telemetry["spans"] > 0
    assert res.telemetry["jsonl_path"] == runs["t_jsonl"]
    snaps, final = _final(runs["t_jsonl"])
    assert len(snaps) == 3  # steps 4 and 8, and the final one at 10
    sums = sum_counter_deltas(snaps)
    for key, c in final["counters"].items():
        if isinstance(c["total"], int):  # exact, integer for integer
            assert sums[key] == c["total"], key
        else:  # host seconds (prefetch.*_s): up to float rounding
            assert sums[key] == pytest.approx(c["total"], rel=1e-12), key
    assert isinstance(final["counters"]["store.read_us{tier=ssd}"]["total"],
                      int)
    counter = runs["counter"]
    assert final["counters"]["traffic.feature_requests"]["total"] \
        == counter.feature_requests
    pair = sum_counter_deltas(snaps, name="traffic.feat_bytes_pair{")
    assert sum(pair.values()) == int(counter.bytes_matrix.sum())
    s = res.store
    assert final["counters"]["store.fill_rows{tier=ssd}"]["total"] \
        == s["ssd_fill_rows"] > 0
    assert final["counters"]["store.announced_batches"]["total"] \
        == s["announced_batches"] == 2 * STEPS
    steps = [ln for ln in lines if ln["kind"] == "span"
             and ln["name"] == "device_step"]
    assert [ln["step"] for ln in steps] == list(range(STEPS))
    builds = [ln for ln in lines if ln["kind"] == "span"
              and ln["name"] == "spec_build"]
    assert len(builds) == 2 * STEPS


def test_stream_counters_equal_the_reference(runs):
    _, tf = _final(runs["t_jsonl"])
    _, jf = _final(runs["j_jsonl"])

    def pick(d):
        return {k: v for k, v in d.items()
                if k.startswith(COMPARED) and not k.startswith(TIME_VALUED)}

    tc = {k: v["total"] for k, v in pick(tf["counters"]).items()}
    jc = {k: v["total"] for k, v in pick(jf["counters"]).items()}
    assert tc == jc and len(tc) > 20
    assert all(isinstance(v, int) for v in tc.values())
    assert pick(tf["gauges"]) == pick(jf["gauges"])
    assert any(k.startswith("cache.") for k in pick(tf["gauges"]))
    assert tf["step"] == jf["step"] == STEPS
    np.testing.assert_allclose(runs["t"].losses, runs["j"].losses,
                               rtol=1e-4, atol=1e-5)


def test_telemetry_and_store_do_not_perturb_training(runs):
    assert runs["t"].losses == runs["off"].losses
    assert runs["off"].telemetry == {} and runs["off"].store == {}
    assert runs["off_activity"] == 0  # zero-overhead contract


def test_trace_loads_in_perfetto_shape(runs):
    ev = json.load(open(runs["t_trace"]))["traceEvents"]
    steps = [e for e in ev if e.get("ph") == "X"
             and e.get("name") == "device_step"]
    assert len(steps) == STEPS and all(e["dur"] >= 0 for e in steps)
    threads = {e["args"]["name"] for e in ev
               if e.get("ph") == "M" and e.get("name") == "thread_name"}
    assert {"MainThread", "prefetch-coordinator"} <= threads
    assert any(e.get("ph") == "C" for e in ev)


def test_digest_equals_the_reference_digest(runs):
    """The same stream through both packages' reporters."""
    for path in (runs["t_jsonl"], runs["j_jsonl"]):
        d = t_report.digest(t_report.load_stream(path))
        assert d == j_report.digest(j_report.load_stream(path))
    d = t_report.digest(t_report.load_stream(runs["t_jsonl"]))
    assert d["device_steps"] == STEPS
    assert d["histograms"]["step.time_s"]["count"] == STEPS


def test_reporter_cli(runs, capsys, tmp_path):
    assert t_report.main([runs["t_jsonl"]]) == 0
    out = capsys.readouterr().out
    assert "device steps" in out and "histograms (interpolated" in out
    assert t_report.main([runs["t_jsonl"], "--json"]) == 0
    d = json.loads(capsys.readouterr().out)
    assert d["final_counters"]["traffic.feature_requests"] \
        == runs["counter"].feature_requests
    bad = tmp_path / "bad.jsonl"
    bad.write_text('{"v": 1, "kind": "meta", "run": "x", "window": 1, '
                   '"t0_unix_s": 0.0, "pid": 1}\n{"not": "a line"}\n')
    assert t_report.main([str(bad)]) == 1
    assert "error:" in capsys.readouterr().err


# ---------------- serving ----------------

def test_server_with_telemetry_and_store(tmp_path):
    """Serving over a file-backed feature table through a store: every
    micro-batch's oracle check passes, and the final snapshot's serve.*
    and traffic.* totals equal the server's summary and counter."""
    fanouts, max_batch = (5, 3), 32
    path = str(tmp_path / "features.npy")
    g = t_graph(4000, 10, seed=4, feat_dim=32)
    g.save_feature_file(path)
    g.detach_features(path)
    plan = t_build_plan(g, t_topo("nv2"), mem_per_device=300_000,
                        batch_size=max_batch, fanouts=fanouts, seed=0)
    cfg = GNNConfig(feat_dim=32, hidden=16, batch_size=max_batch,
                    fanouts=fanouts)
    params = t_init(t_defs(cfg), torch.Generator().manual_seed(0), "cpu")
    jsonl = str(tmp_path / "serve.jsonl")
    tele = Telemetry(TelemetryConfig(jsonl_path=jsonl, run="serve"))
    store = FeatureStore(g, TieredStoreConfig(host_rows=500, lookahead=0))
    srv = GNNServer(g, plan, cfg, params, device="cpu", seed=0,
                    telemetry=tele, feature_store=store,
                    config=ServeConfig(max_batch=max_batch, max_wait_s=0.002,
                                       oracle_check=True, snapshot_every=4))
    tele.add_source("traffic", srv.counter.publish_metrics)
    tele.add_source("store", store.publish_metrics)
    rng = np.random.default_rng(5)
    requests = [rng.integers(0, g.n, int(n))
                for n in rng.integers(1, max_batch + 1, 20)]
    srv.warmup()
    futs = [srv.submit(r) for r in requests]
    srv.start()
    results = [f.result(timeout=120) for f in futs]
    srv.stop()
    tele.close()
    s = srv.summary()
    assert s["oracle_mismatches"] == 0 and s["oracle_checks"] == s["batches"]
    assert [r.logits.shape[0] for r in results] == [len(r) for r in requests]
    assert store.summary()["ssd_fill_rows"] > 0
    snaps, final = _final(jsonl)
    assert len(snaps) >= 2
    c = final["counters"]
    for key in ("requests", "replies", "batches", "seeds", "pad_seeds",
                "flush_full", "flush_deadline", "oracle_checks",
                "oracle_mismatches", "forward_us"):
        assert c[f"serve.{key}"]["total"] == s[key], key
    assert c["traffic.feature_hits"]["total"] == srv.counter.feature_hits
    assert c["serve.feature_requests"]["total"] \
        == c["traffic.feature_requests"]["total"] \
        == srv.counter.feature_requests
    assert c["store.requests{tier=hbm}"]["total"] \
        == srv.counter.feature_requests
    assert final["hists"]["serve.latency_s"]["count"] == s["replies"]
    names = {ln["name"] for ln in t_report.load_stream(jsonl)
             if ln["kind"] == "span"}
    assert {"serve_enqueue", "serve_batch", "serve_sample", "serve_gather",
            "serve_forward", "serve_reply", "finalize"} <= names
