#!/usr/bin/env python3
"""Training-step time of the full ``gemma3-1b`` on one card, for comparing
two trees of the port in one run on one card.

    python3 tools/lm_train_steps.py [--src DIR] [--steps 8]

Runs ``chip_smoke.py``'s training measurement (``lm_train``: seed-0
weights, 4 x 4096, remat, the CE in chunks of 512, AdamW; then
``profile_train_step``) with the ``repro_torch`` package found under
``--src`` (default: this checkout's ``src``; another tree's ``src``
compares that tree), and prints one JSON line: each step's host wall time
(synchronized; the first step is warm-up), their median, the median step
on CUDA events, and one profiled step's device busy time and its attention
backward (the kernels with ``flash_bwd`` in their names, before AdamW).
To compare trees, run it in turns (A, B, B, A) in one call.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (puts this checkout's src on the path)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--steps", type=int, default=8)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.src).resolve()))  # ahead of chip_smoke's
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("lm_train_steps: needs a CUDA card", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import transformer
    from repro_torch.models.params import init_from_defs

    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.smi()
    cfg = dataclasses.replace(get_config(cs.LM_ARCH), remat=True,
                              loss_chunk=cs.LM_TRAIN_CHUNK)
    params = init_from_defs(transformer.defs(cfg),
                            torch.Generator().manual_seed(0), "cuda")
    batch, seq = cs.LM_BATCH, cs.LM_PROMPT
    marks = []
    losses, walls, params = cs.lm_train(torch, np, fa, cfg, params, batch,
                                        seq, args.steps, "cuda", marks=marks)
    walls = [w * 1e3 for w in walls]
    events = [m["start"].elapsed_time(m["end"]) for m in marks]
    profiled = cs.profile_train_step(torch, np, fa, cfg, params, batch, seq)
    busy = bwd = None
    if profiled is not None:
        busy = cs.busy_and_top(profiled[1])[0] / 1e3
        bwd = profiled[2]["flash_attention_bwd"]
    print(json.dumps({
        "src": args.src, "card": card, "steps_ms": walls,
        "median_step_ms": statistics.median(walls[1:]),
        "median_step_events_ms": statistics.median(events[1:]),
        "tokens_per_s": batch * seq / statistics.median(walls[1:]) * 1e3,
        "profiled_device_busy_ms": busy,
        "profiled_attention_bwd_ms": bwd,
        "losses": losses}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
