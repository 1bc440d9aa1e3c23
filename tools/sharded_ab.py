#!/usr/bin/env python3
"""The sharded executor's runs of ``chip_smoke.py`` phases 9 and 10 on one
card, for holding two trees of the port to each other in one call.

    python3 tools/sharded_ab.py [--src DIR] [--out FILE]

With the ``repro_torch`` package found under ``--src`` (default: this
checkout's ``src``; another tree's ``src`` runs that tree: this script
imports nothing else of a checkout), on ``chip_smoke.py``'s 2 x 2 plan
(``synthetic_instance("PA", 1M)``, ``topology_matrix("dgx-v100", 4)``,
150 MB a device) and GraphSAGE at paper width from seed-0 weights:

* phase 9's run: ``backend="sharded"`` at batch 8000 for 12 steps with a
  refresh every 5 steps (drift threshold 1.0), every position on
  ``cuda:0``; its losses, step times, refresh steps, and the device
  memory it allocated at its peak (``max_memory_allocated`` after a reset);
* phase 10's run: batch 1024, 8 steps, a refresh every 4 steps; losses.

Prints one JSON line (appended to ``--out`` too).  To compare trees, run it
in turns (A, B, B, A), each a process of its own; the losses of two trees
whose sharded math is the same are bitwise equal.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
N_VERTICES = 1_000_000          # chip_smoke.py's graph
SHARD_TOPOLOGY = ("dgx-v100", 4)
SHARD_MEM_PER_DEVICE = 150e6
PHASES = {"9": dict(batch=8000, steps=12, refresh=5),
          "10": dict(batch=1024, steps=8, refresh=4)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    src = str(Path(args.src).resolve())
    sys.path.insert(0, src)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("sharded_ab: needs a CUDA card", file=sys.stderr)
        return 2
    from repro_torch.configs.legion_gnn import GRAPHSAGE
    from repro_torch.core.cache_manager import RefreshConfig
    from repro_torch.core.cliques import topology_matrix
    from repro_torch.core.planner import build_plan
    from repro_torch.graph.csr import synthetic_instance
    from repro_torch.models.gnn import defs as gnn_defs
    from repro_torch.models.params import init_from_defs
    from repro_torch.train.loop import train_gnn

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    g = synthetic_instance("PA", max_vertices=N_VERTICES, seed=0)
    params = init_from_defs(gnn_defs(GRAPHSAGE),
                            torch.Generator().manual_seed(0), "cuda")
    out = {"src": src, "card": card}
    for phase, p in PHASES.items():
        plan = build_plan(g, topology_matrix(*SHARD_TOPOLOGY),
                          mem_per_device=SHARD_MEM_PER_DEVICE,
                          fanouts=GRAPHSAGE.fanouts, batch_size=1024, seed=0)
        cfg = dataclasses.replace(GRAPHSAGE, batch_size=p["batch"])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        res = train_gnn(g, plan, cfg, steps=p["steps"], backend="sharded",
                        device="cuda", seed=0, params=params,
                        refresh_config=RefreshConfig(
                            interval=p["refresh"], drift_threshold=1.0))
        torch.cuda.synchronize()
        st = np.array(res.step_times) * 1e3
        out[f"phase{phase}"] = {
            "losses": res.losses, "accs": res.accs,
            "step_ms": st.tolist(), "step_median_ms": float(np.median(st)),
            "refresh_steps": [e["step"] for e in res.refresh["events"]],
            "peak_allocated_bytes": torch.cuda.max_memory_allocated() - base,
        }
        del plan, res
        torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t0
    line = json.dumps(out)
    print(line)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
