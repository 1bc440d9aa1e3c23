#!/usr/bin/env python3
"""Serving and training times of the GNN paths without telemetry or a
feature store, for comparing two trees of the port in one run on one card.

    python3 tools/gnn_paths_ab.py [--src DIR] [--steps 10]

With the ``repro_torch`` package found under ``--src`` (default: this
checkout's ``src``; another tree's ``src`` compares that tree), on
``chip_smoke.py``'s one-GPU plan (PA, 1M vertices, 300 MB cache) and
GraphSAGE at paper width from seed 0: serves ``chip_smoke.py``'s 200
requests (phase 5: ``max_batch`` 256, oracle check on, a closed burst),
then trains ``--steps`` steps on the device backend at batch 8000 with a
refresh every 5 steps (phase 6), then ``SHARDED_STEPS`` steps of the
sharded executor on the 2 x 2 plan (phase 10), and prints one JSON line:
requests/s, latency p50/p99, the training step median/min/max, the mean
host build, the fill total, the sharded step median and both runs'
losses.  To compare trees, run it in turns (A, B, B, A) in one call.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (puts this checkout's src on the path)

SHARDED_STEPS = 8


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args(argv)
    src = str(Path(args.src).resolve())
    sys.path.insert(0, src)  # ahead of chip_smoke's
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("gnn_paths_ab: needs a CUDA card", file=sys.stderr)
        return 2
    from repro_torch.configs.legion_gnn import GRAPHSAGE
    from repro_torch.core.cache_manager import RefreshConfig
    from repro_torch.core.cliques import topology_matrix
    from repro_torch.core.planner import build_plan
    from repro_torch.graph.csr import synthetic_instance
    from repro_torch.kernels import KERNELS
    from repro_torch.models.gnn import defs as gnn_defs
    from repro_torch.models.params import init_from_defs
    from repro_torch.serve import GNNServer, ServeConfig
    from repro_torch.train.loop import train_gnn

    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.smi()
    with ThreadPoolExecutor(max_workers=len(KERNELS)) as pool:
        for f in [pool.submit(k.kernel.fn) for k in KERNELS]:
            f.result()
    g = synthetic_instance("PA", max_vertices=cs.N_VERTICES, seed=0)
    plan = build_plan(g, topology_matrix("nonv", 1),
                      mem_per_device=cs.MEM_PER_DEVICE,
                      fanouts=GRAPHSAGE.fanouts, batch_size=1024, seed=0)
    params = init_from_defs(gnn_defs(GRAPHSAGE),
                            torch.Generator().manual_seed(0), "cuda")

    srv = GNNServer(g, plan, GRAPHSAGE, params, device="cuda",
                    config=ServeConfig(max_batch=cs.MAX_BATCH,
                                       oracle_check=True), seed=0)
    req_rng = np.random.default_rng(1)
    requests = [req_rng.integers(0, g.n, int(n))
                for n in req_rng.integers(1, cs.MAX_BATCH + 1,
                                          cs.N_REQUESTS)]
    srv.warmup()
    srv.start()
    t0 = time.perf_counter()
    results = [f.result(timeout=900)
               for f in [srv.submit(r) for r in requests]]
    wall = time.perf_counter() - t0
    srv.stop()
    s = srv.summary()
    if s["oracle_mismatches"]:
        raise AssertionError(f"oracle mismatches: {s}")
    lat = np.array([r.latency_s for r in results]) * 1e3

    res = train_gnn(g, cs.fresh_copy(plan), GRAPHSAGE, steps=args.steps,
                    backend="device", device="cuda", seed=0,
                    refresh_config=RefreshConfig(interval=5,
                                                 drift_threshold=1.0))
    st = np.array(res.step_times) * 1e3
    del plan
    splan = build_plan(g, topology_matrix(*cs.SHARD_TOPOLOGY),
                       mem_per_device=cs.SHARD_MEM_PER_DEVICE,
                       fanouts=GRAPHSAGE.fanouts, batch_size=1024, seed=0)
    sres = train_gnn(g, splan, GRAPHSAGE, steps=SHARDED_STEPS,
                     backend="sharded", device="cuda", seed=0)
    sst = np.array(sres.step_times) * 1e3
    print(json.dumps({
        "src": src, "card": card,
        "serve_req_per_s": cs.N_REQUESTS / wall,
        "serve_p50_ms": float(np.percentile(lat, 50)),
        "serve_p99_ms": float(np.percentile(lat, 99)),
        "serve_batches": s["batches"],
        "train_steps": args.steps,
        "train_step_median_ms": float(np.median(st)),
        "train_step_min_ms": float(st.min()),
        "train_step_max_ms": float(st.max()),
        "train_host_build_mean_ms": res.pipeline["host_build_s_mean"] * 1e3,
        "train_fill_s_total": res.pipeline["fill_s_total"],
        "losses": res.losses,
        "sharded_steps": SHARDED_STEPS,
        "sharded_step_median_ms": float(np.median(sst)),
        "sharded_losses": sres.losses}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
