#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (the script exits non-zero and prints no
result line):

1. Device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions.
2. Build: every hand-written kernel of the serving path, compiled from the
   sources in this checkout at its first ``fn()`` call.
3. Graph + plan: ``synthetic_instance("PA", 1M vertices)`` and a one-GPU
   Legion plan with a 300 MB cache, fanouts (25, 10).
4. Kernels: each kernel against its plain PyTorch version on the card,
   bitwise, at the serving shape taken from a real micro-batch, in bf16, at
   D = 100 and with one-row sources; then kernel and plain version timed
   with CUDA events, L2 flushed before every launch.
5. Serve: ``GNNServer`` with GraphSAGE at paper width (feat 128, hidden
   256, 32 classes, random weights from a seed) answers 200 requests of
   1-256 seeds with the bitwise host-oracle check on; every kernel's launch
   count is zeroed just before and read just after.

The last two lines are the ``{"kernels": [...]}`` record and
``{"ok": true, "device": {...}}``.  Without CUDA, or without the rest of
the repository beside it, the script fails.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device-memory rate (NVIDIA data sheet)
N_VERTICES = 1_000_000
MEM_PER_DEVICE = 300e6
MAX_BATCH = 256
N_REQUESTS = 200
TIMED_LAUNCHES = 100


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def kernel_cases(torch, table, idx, miss, inv, seed: int = 0):
    """The bitwise cases: the serving shape as given, the same in bf16, a
    random D = 100 instance with the same hit/miss/pad mix, and one-row
    sources (an empty cache's dummy table, a one-row miss buffer)."""
    gen = torch.Generator(device=table.device).manual_seed(seed)
    dev = table.device
    t100 = torch.randn((50_000, 100), generator=gen, device=dev)
    m100 = torch.randn((miss.shape[0], 100), generator=gen, device=dev)
    idx100 = torch.where(idx >= 0, idx % t100.shape[0], idx)
    one_t = torch.zeros((1, table.shape[1]), device=dev)
    one_m = torch.arange(table.shape[1], dtype=torch.float32,
                         device=dev)[None, :] + 1.0
    one_idx = torch.full_like(idx, -1)
    one_inv = torch.where(inv >= 0, torch.zeros_like(inv),
                          torch.full_like(inv, -1))
    return {
        "serve_f32": (table, idx, miss, inv),
        "serve_bf16": (table.to(torch.bfloat16), idx,
                       miss.to(torch.bfloat16), inv),
        "d100_f32": (t100, idx100, m100, inv),
        "one_row_sources": (one_t, one_idx, one_m, one_inv),
    }


def time_ms(torch, fn, args, n: int, flush) -> float:
    """Median per-launch device time, L2 flushed before each launch (a
    micro-batch finds its rows cold: the forward runs in between)."""
    fn(*args)
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
    for s, e in zip(starts, ends):
        flush.zero_()
        s.record()
        fn(*args)
        e.record()
    torch.cuda.synchronize()
    times = sorted(s.elapsed_time(e) for s, e in zip(starts, ends))
    return times[len(times) // 2]


def gather_bytes(idx, miss_inv, row_bytes: int) -> int:
    """Bytes the fused gather must move for these maps: every distinct
    source row read once, both maps read once, every output row written."""
    import torch

    fresh = miss_inv >= 0
    cached = (idx >= 0) & ~fresh
    rows = (torch.unique(miss_inv[fresh]).numel()
            + torch.unique(idx[cached]).numel())
    B = idx.numel()
    return rows * row_bytes + 2 * B * 4 + B * row_bytes


def breakdown(torch, np, builder, cfg, params, n: int,
              oracle: bool = True) -> dict:
    """Host milliseconds per layer of the serving path (median over ``n``
    micro-batches of ``MAX_BATCH`` random seeds), each layer closed by a
    device synchronize, driven through the same builder calls the server
    makes.  ``oracle`` adds the debug-only host-oracle assembly the server
    runs under ``oracle_check`` (its own row; 0 when off)."""
    from repro_torch.models.gnn import forward
    from repro_torch.serve.oracle import host_oracle_batch

    g = builder.g
    rng = np.random.default_rng(2)
    times = {k: [] for k in ("sample", "fill", "oracle", "finalize",
                             "forward", "reply")}
    with torch.inference_mode():
        for _ in range(n):
            t = [time.perf_counter()]
            spec = builder.sample_spec(rng.integers(0, g.n, MAX_BATCH), rng)
            t.append(time.perf_counter())
            spec = builder.fill_spec(spec)
            t.append(time.perf_counter())
            if oracle:
                host_oracle_batch(spec, builder.cache, g.feat_dim)
            t.append(time.perf_counter())
            batch = builder.finalize(spec)
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            logits = forward(cfg, params, batch)
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            logits.cpu().numpy()
            t.append(time.perf_counter())
            for k, a, b in zip(times, t, t[1:]):
                times[k].append((b - a) * 1e3)
    return {k: float(np.median(v)) for k, v in times.items()}


def device_share(torch, np, builder, cfg, params, n: int):
    """Device busy time over ``n`` micro-batches of the production serving
    path (no host oracle) from torch.profiler, and the top device
    operations; None when the profiler saw no device time.  The wall time
    includes the profiler's own overhead."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        breakdown(torch, np, builder, cfg, params, n, oracle=False)
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = []  # device-side events only (kernels, copies, memsets): the
    # CPU-side aten ops report the same device time again
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            rows.append((us, e.key, e.count))
    if not rows:
        return None
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    return busy / wall_us, rows[:8]


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a GPU",
              file=sys.stderr)
        return 2
    from repro_torch.configs.legion_gnn import GRAPHSAGE
    from repro_torch.core.cliques import topology_matrix
    from repro_torch.core.planner import build_plan
    from repro_torch.graph.csr import synthetic_instance
    from repro_torch.kernels import fused_batch, ref
    from repro_torch.models.gnn import defs as gnn_defs
    from repro_torch.models.params import init_from_defs
    from repro_torch.serve import GNNServer, ServeConfig
    from repro_torch.train.batch import DeviceBatchBuilder

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = smi()
    kind = torch.cuda.get_device_name(0)
    print(f"[device] {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {kind} x {torch.cuda.device_count()}")

    # ---- 2. build ----------------------------------------------------------
    kernels = [{"kernel": fused_batch.KERNEL, "wrapper":
                fused_batch.fused_gather_overlay, "plain":
                ref.fused_gather_overlay,
                "source": "src/repro_torch/kernels/csrc/fused_gather_overlay.cu",
                "replaces": "src/repro/kernels/fused_batch.py:48"}]
    for k in kernels:
        t0 = time.perf_counter()
        k["kernel"].fn()
        print(f"[build] {k['kernel'].name}: {time.perf_counter() - t0:.2f}s "
              f"(nvcc {k['kernel'].build_s:.2f}s) | {card}")
        for line in k["kernel"].build_log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {k['kernel'].name}: {line.strip()}")

    # ---- 3. graph + plan ---------------------------------------------------
    t0 = time.perf_counter()
    g = synthetic_instance("PA", max_vertices=N_VERTICES, seed=0)
    plan = build_plan(g, topology_matrix("nonv", 1),
                      mem_per_device=MEM_PER_DEVICE, fanouts=GRAPHSAGE.fanouts,
                      batch_size=1024, seed=0)
    cache = plan.cache_for_device(0)
    print(f"[plan] n={g.n} nnz={g.nnz} D={g.feat_dim} feat rows "
          f"{len(cache.feat_ids)} topo rows {len(cache.topo_ids)} "
          f"alpha={plan.cost_plans[0]['alpha']:.2f} "
          f"({time.perf_counter() - t0:.1f}s host)")

    # ---- 4. kernels vs plain versions -------------------------------------
    slots, cap = 1, 1
    for f in GRAPHSAGE.fanouts:
        slots *= f
        cap += slots
    builder = DeviceBatchBuilder(g, cache, GRAPHSAGE.fanouts, None, 0,
                                 device="cuda", bucket=MAX_BATCH * cap)
    rng = np.random.default_rng(0)
    spec = builder.fill_spec(builder.sample_spec(
        rng.integers(0, g.n, MAX_BATCH), rng))
    table = cache.device_arrays()["feat_cache"]
    idx = torch.from_numpy(spec.cache_pos.astype(np.int32)).cuda()
    inv = torch.from_numpy(spec.miss_inv).cuda()
    miss = spec.miss_feats.cuda()
    builder.release_spec(spec)
    print(f"[kernel] serve shape: B={idx.numel()} table={tuple(table.shape)} "
          f"miss={tuple(miss.shape)} unique={spec.n_ids} "
          f"hits={int(spec.hit.sum())} misses={spec.n_miss}")
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    for k in kernels:
        errs = {}
        for name, args in kernel_cases(torch, table, idx, miss, inv).items():
            got = k["wrapper"](*args)
            want = k["plain"](*args)
            torch.cuda.synchronize()
            if got.shape != want.shape or not torch.equal(got, want):
                raise AssertionError(f"{k['kernel'].name} != plain version "
                                     f"on case {name}")
            errs[name] = float((got.float() - want.float()).abs().max())
        args = (table, idx, miss, inv)
        runs = []
        for _ in range(2):  # kernel, plain, kernel, plain
            runs.append((time_ms(torch, k["wrapper"], args, TIMED_LAUNCHES,
                                 flush),
                         time_ms(torch, k["plain"], args, TIMED_LAUNCHES,
                                 flush)))
        k["ms"] = float(np.mean([r[0] for r in runs]))
        k["plain_ms"] = float(np.mean([r[1] for r in runs]))
        nbytes = gather_bytes(idx, inv, table.shape[1] * table.element_size())
        k["bound_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
        k["max_abs_err"] = max(errs.values())
        print(f"[kernel] {k['kernel'].name}: bitwise equal on {sorted(errs)}; "
              f"kernel {k['ms']:.4f} ms, plain {k['plain_ms']:.4f} ms, bound "
              f"{k['bound_ms']:.4f} ms ({nbytes / 1e6:.1f} MB) "
              f"runs {runs} | {card}")
    del flush

    # ---- 4b. where the time goes (serving layers, one batch at a time) ----
    params = init_from_defs(gnn_defs(GRAPHSAGE),
                            torch.Generator().manual_seed(0), "cuda")
    ms = breakdown(torch, np, builder, GRAPHSAGE, params, 20)
    print("[layers] median ms per micro-batch: " + ", ".join(
        f"{k} {v:.3f}" for k, v in ms.items())
        + f" (total {sum(ms.values()):.3f}) | {card}")
    share = device_share(torch, np, builder, GRAPHSAGE, params, 5)
    if share is None:
        print("[layers] device busy share: not measured (torch.profiler saw "
              "no device time)")
    else:
        print(f"[layers] device busy share {share[0]:.4f} over 5 micro-batches"
              f" without the oracle, profiler on (idle {1 - share[0]:.4f}) "
              f"| {card}")
        for us, key, count in share[1]:
            print(f"[layers]   {us / 1e3:9.3f} ms  x{count:<5d} {key[:70]}")

    # ---- 5. serve ----------------------------------------------------------
    srv = GNNServer(g, plan, GRAPHSAGE, params, device="cuda",
                    config=ServeConfig(max_batch=MAX_BATCH,
                                       oracle_check=True), seed=0)
    req_rng = np.random.default_rng(1)
    requests = [req_rng.integers(0, g.n, int(n))
                for n in req_rng.integers(1, MAX_BATCH + 1, N_REQUESTS)]
    for k in kernels:
        k["kernel"].launches = 0
    srv.warmup()
    srv.start()
    t0 = time.perf_counter()
    futs = [srv.submit(r) for r in requests]
    results = [f.result(timeout=900) for f in futs]
    wall = time.perf_counter() - t0
    srv.stop()
    for k in kernels:
        k["launches"] = k["kernel"].launches
    s = srv.summary()
    for k in kernels:
        if k["launches"] != s["batches"]:
            raise AssertionError(f"{k['kernel'].name} launched "
                                 f"{k['launches']} times for {s['batches']} "
                                 "micro-batches")
    if s["oracle_mismatches"] or s["oracle_checks"] != s["batches"]:
        raise AssertionError(f"oracle check failed: {s}")
    for req, res in zip(requests, results):
        if res.logits.shape != (len(req), GRAPHSAGE.n_classes) \
                or not np.isfinite(res.logits).all():
            raise AssertionError(f"bad reply for request {res.request_id}")
    lat = np.array([r.latency_s for r in results]) * 1e3
    c = srv.counter
    print(f"[serve] {N_REQUESTS} requests in {s['batches']} micro-batches "
          f"(2 warm-up) wall {wall:.3f}s: {N_REQUESTS / wall:.2f} req/s, "
          f"latency p50 {np.percentile(lat, 50):.2f} ms p99 "
          f"{np.percentile(lat, 99):.2f} ms (closed burst, oracle check on) "
          f"| {card}")
    print(f"[serve] feature hit rate {c.feature_hit_rate:.4f} topo hit rate "
          f"{c.topo_hit_rate:.4f} forward {s['forward_us'] / s['batches']:.0f}"
          f" us/batch, oracle mismatches 0 of {s['oracle_checks']} | {card}")

    record = {"kernels": [{
        "name": k["kernel"].name, "route": "cuda", "source": k["source"],
        "replaces": k["replaces"], "launches": k["launches"],
        "bitwise_equal": True, "max_abs_err": k["max_abs_err"],
        "ms": k["ms"], "kernel_ms": k["ms"], "plain_ms": k["plain_ms"],
        "bound_ms": k["bound_ms"], "bound_by": "bytes", "library_ms": None,
    } for k in kernels]}
    print(card)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
