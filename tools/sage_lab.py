#!/usr/bin/env python3
"""Design experiment for the ``sage_aggregate`` kernel: its routes and the
variants it was chosen from, at the GraphSAGE training shape of
``chip_smoke.py`` (200,000 rows x 10 neighbours over a 416,768 x 128
table, 5% pads), in f32 and bf16.

    python3 tools/sage_lab.py      # on a CUDA card

Builds ``tools/sage_lab.cu`` (copies of the kernel's vec route with
other L2 hints and depths of loads in flight, plus a bulk-copy ring:
``cp.async.bulk`` of one row per copy into shared-memory stages from a
producer warp, consumer warps reducing from shared memory), holds every
variant bitwise to the plain version (after printing the shipped
kernels' global loads and stores as ``cuobjdump -sass`` shows them, with
the memory descriptor each uses), then times each with
``chip_smoke.time_ms`` (CUDA events, L2 flushed before each launch),
two rounds in opposite orders, averaged.  Then the same f32 gathers
with every row distinct (a 1 GB table: L2 can reuse nothing) and confined
to 40,000 rows (20 MB, which L2 holds), which bound what L2 reuse can give
at this shape.  Last, whether table rows read with an L2 evict-last policy
survive the flush: a full read of the table (``table.sum()``) timed after
the flush that follows the evict-last variant and after the one that
follows the variant without hints; if evict-last lines outlived the flush,
the first read would be the faster.
"""
from __future__ import annotations

import ctypes
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

LAUNCHES = 100
PROBES = 30
# (name, lab variant code or the shipped route); see tools/sage_lab.cu
VARIANTS = (("shipped vec", "vec"), ("shipped scalar", "scalar"),
            ("vec K4 EL+EF out", 0), ("vec K3 EL+EF out", 1),
            ("vec K4 EL", 2), ("vec K4 EL+EF out+EF idx", 3),
            ("vec K4 no hints", 4), ("vec K4 EL half/EF+EF out", 5),
            ("vec K4 EL quarter/EF+EF out", 6), ("vec K2 EL+EF out", 7),
            ("vec K5 EL+EF out", 8), ("vec K8 EL+EF out", 9),
            ("vec K16 EL+EF out", 10), ("bulk 4 stages 4 consumers", 11),
            ("bulk 2 stages 2 consumers", 12),
            ("bulk 8 stages 4 consumers", 13),
            ("bulk 8 stages 8 consumers", 14),
            ("bulk 4 stages 4 consumers EL", 15))
# the calibration inputs' kernels: shipped routes and the fastest ring
CALIBRATED = (("shipped vec", "vec"), ("shipped scalar", "scalar"),
              ("bulk 4 stages 4 consumers", 11))


def print_memory_ops(library, card: str) -> None:
    """What the compiler made of the shipped kernels' loads and stores
    (``cuobjdump -sass``): each global memory instruction of each kernel
    function with its count and the memory descriptor it goes through (a
    ``createpolicy`` L2 policy shows as a descriptor of its own, beside
    the default one that plain loads use)."""
    import collections
    import re
    import shutil
    import subprocess

    import chip_smoke

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(library)], check=True,
                          capture_output=True, text=True).stdout
    ops, fn = collections.defaultdict(collections.Counter), None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            continue
        m = re.search(r"\b((?:LDG|STG)\.[A-Z0-9_.]+) .*?(desc\[\w+\])", line)
        if m and fn:
            ops[fn][f"{m.group(1)} via {m.group(2)}"] += 1
    for fn, counts in ops.items():
        args = re.search(r"kernelI(f|13__nv_bfloat16)((?:Li\d+E)*)E", fn)
        name = chip_smoke.demangle(fn) + (
            f"<{'bf16' if args.group(1) != 'f' else 'float'}"
            + "".join(f", {n}" for n in re.findall(r"Li(\d+)E",
                                                   args.group(2))) + ">"
            if args else "")
        print(f"[sass] {name}: "
              + ", ".join(f"{k} x{n}" for k, n in sorted(counts.items()))
              + f" | {card}")


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("sage_lab: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch.kernels import ref, sage_agg
    from repro_torch.kernels._build import CudaKernel

    card = chip_smoke.smi()
    lab = CudaKernel("sage_lab", str(ROOT / "tools" / "sage_lab.cu"),
                     "sage_lab",
                     [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
                     + [ctypes.c_int64] * 4 + [ctypes.c_void_p])
    lab.fn()
    sage_agg.KERNEL.fn()
    for kern in (sage_agg.KERNEL, lab):
        for fn, lines in chip_smoke.ptxas_functions(kern.build_log):
            print(f"[build] {kern.name}: {fn}: {'; '.join(lines)}")
    print_memory_ops(sage_agg.KERNEL.library_path(), card)

    def run(variant, table, idx, w):
        if isinstance(variant, str):
            with chip_smoke.forced_route(sage_agg, "sage_route", variant):
                return sage_agg.sage_aggregate(table, idx, w)
        (N, D), (B, F) = table.shape, idx.shape
        out = torch.empty((B, D), dtype=table.dtype, device=table.device)
        err = lab.fn()(table.data_ptr(), idx.data_ptr(), w.data_ptr(),
                       out.data_ptr(), int(table.dtype == torch.bfloat16),
                       variant, N, D, B, F,
                       torch.cuda.current_stream().cuda_stream)
        lab.check(err)
        return out

    table = torch.empty((1, 1), device="cuda")
    cases, _ = chip_smoke.sage_aggregate_cases(torch, {"table": table})
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    for case in ("train_f32", "train_bf16"):
        table, idx, w = cases[case]
        want = ref.sage_aggregate(table, idx, w)
        for name, variant in VARIANTS:
            got = run(variant, table, idx, w)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"{name} != plain version on {case}")
        nbytes = chip_smoke.sage_aggregate_bytes(table, idx)
        no_reuse = chip_smoke.sage_no_reuse_bytes(table, idx)
        rounds = []
        for order in (VARIANTS, VARIANTS[::-1]):
            rounds.append({name: chip_smoke.time_ms(
                torch, lambda v=v: run(v, table, idx, w), (), LAUNCHES, flush)
                for name, v in order})
        print(f"[lab] {case}: all {len(VARIANTS)} variants bitwise equal to "
              f"the plain version; bound {nbytes / 3.35e9:.4f} ms "
              f"({nbytes / 1e6:.1f} MB), no-reuse {no_reuse / 3.35e9:.4f} ms "
              f"({no_reuse / 1e6:.1f} MB) at 3.35 TB/s | {card}")
        for name, _ in VARIANTS:
            ms = [r[name] for r in rounds]
            print(f"[lab] {case} {name}: {np.mean(ms):.4f} ms (rounds "
                  f"{ms[0]:.4f}, {ms[1]:.4f}) | {card}")

    # the training shape's gathers with every row distinct (a 1 GB table, no
    # reuse possible) and confined to 40,000 rows (20 MB, which L2 holds)
    table, idx, w = cases["train_f32"]
    B, F = idx.shape
    gen = torch.Generator(device="cuda").manual_seed(11)
    distinct = torch.randn((B * F, table.shape[1]), generator=gen,
                           device="cuda")
    perm = torch.randperm(B * F, generator=gen, device="cuda")
    calib = {"distinct rows": (distinct, torch.where(
                 idx >= 0, perm.view(B, F).int(), idx), w),
             "rows in L2": (table, torch.where(idx >= 0, idx % 40_000, idx),
                            w)}
    gathered = int((idx >= 0).sum()) * table.shape[1] * 4
    for case, (t, i, ww) in calib.items():
        want = ref.sage_aggregate(t, i, ww)
        for name, v in CALIBRATED:
            if not torch.equal(run(v, t, i, ww), want):
                raise AssertionError(f"{name} != plain version on {case}")
        rounds = [{name: chip_smoke.time_ms(
            torch, lambda v=v: run(v, t, i, ww), (), LAUNCHES, flush)
            for name, v in order} for order in (CALIBRATED,
                                                CALIBRATED[::-1])]
        for name, _ in CALIBRATED:
            ms = float(np.mean([r[name] for r in rounds]))
            print(f"[lab] train_f32 gathers, {case}: {name} {ms:.4f} ms; "
                  f"the non-pad gathers ({gathered / 1e6:.1f} MB) at "
                  f"{gathered / ms / 1e9:.3f} TB/s | {card}")
    del distinct, calib

    for name, variant in (("after evict-last", 2), ("after no hints", 4),
                          ("after evict-last", 2), ("after no hints", 4)):
        times = []
        for _ in range(PROBES):
            run(variant, table, idx, w)
            flush.zero_()
            torch.cuda._sleep(chip_smoke.SPIN_CYCLES)
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            table.sum()
            e.record()
            torch.cuda.synchronize()
            times.append(s.elapsed_time(e))
        print(f"[lab] table read {name} + flush: median "
              f"{float(np.median(times)):.4f} ms over {PROBES} | {card}")
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
