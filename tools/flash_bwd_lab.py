#!/usr/bin/env python3
"""Design check of the attention backward (``flash_attention_bwd``): its two
routes side by side, without the rest of ``chip_smoke.py``.

    python3 tools/flash_bwd_lab.py      # on a CUDA card, about a minute

Builds ``csrc/flash_attention_bwd.cu`` and the forward and prints what
ptxas reports for each backward kernel function (flagging a spill, which
``chip_smoke.py`` fails on); holds both sources' route rules to the
wrappers' (``chip_smoke.route_rule_agrees``); runs ``chip_smoke.py``'s
backward edge cases (``bwd_cases``) and the two gemma3-1b training shapes
(q (4, 4096, 4, 256), one kv head, window 512 and none; random inputs
from a seed where ``chip_smoke.py`` captures a training step's) through
``chip_smoke.check_backward`` (each case on its route and, where that is
``wgmma``, on ``mma_sync`` too: against the f64 gradient, twice bitwise)
and times the training shapes with ``chip_smoke.time_backward`` (the two
routes in turns beside the bound, the plain version and SDPA's backward);
then profiles three ``wgmma`` calls at each training shape by kernel
(``torch.profiler``): the pre-pass against the main launch.
"""
from __future__ import annotations

import re
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

FLUSH_BYTES = 256 << 20  # zeroed before each timed launch, as chip_smoke.py
TRAIN = {"train_local": 512, "train_global": 1 << 30}  # gemma3-1b's layers


def main() -> int:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from repro_torch.kernels import KERNELS
    from repro_torch.kernels import flash_attention as fa

    if not torch.cuda.is_available():
        print("flash_bwd_lab: needs a CUDA card", file=sys.stderr)
        return 2
    card = cs.smi()
    print(f"[device] {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda}")
    fwd, bwd = (next(k for k in KERNELS if k.name == name)
                for name in ("flash_attention", "flash_attention_bwd"))
    with ThreadPoolExecutor(2) as pool:
        for f in [pool.submit(k.kernel.fn) for k in (fwd, bwd)]:
            f.result()
    for fn, lines in cs.ptxas_functions(bwd.kernel.build_log):
        spills = [ln for ln in lines if any(
            int(n) for n in re.findall(r"(\d+) bytes spill", ln))]
        print(f"[build] {fn}: {'; '.join(lines)}"
              + (" SPILLS (chip_smoke.py fails on it)" if spills else ""))
    cs.route_rule_agrees(torch, fwd)
    print("[route] the forward's and the backward's C rules agree with "
          "flash_route and flash_bwd_route")

    cases = cs.bwd_cases(torch, fa, {})
    gen = torch.Generator(device="cuda").manual_seed(19)
    for name, window in TRAIN.items():
        q, k, v, do = (torch.randn(s, generator=gen, device="cuda").bfloat16()
                       for s in ((4, 4096, 4, 256), (4, 4096, 1, 256),
                                 (4, 4096, 1, 256), (4, 4096, 4, 256)))
        o, lse = fa._forward_cuda(q, k, v, True, window, True)
        cases[name] = (q, k, v, o, lse, do, {"causal": True,
                                             "window": window})
    cs.check_backward(torch, fa, bwd, cases, card)
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    cs.time_backward(torch, np, fa, bwd, cases, flush, card)
    for name in TRAIN:
        q, k, v, o, lse, do, kw = cases[name]
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
            torch.cuda.synchronize()
        rows = [(e.key, e.device_time_total / e.count / 1e3, e.count)
                for e in prof.key_averages() if e.device_time_total > 0]
        if not rows:
            print(f"[time] {name} by kernel: not measured (the profiler saw "
                  f"no device time)")
        for key, ms, count in sorted(rows, key=lambda r: -r[1]):
            print(f"[time] {name} by kernel: {ms:.4f} ms  x{count} "
                  f"{key[:60]} | {card}")
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
