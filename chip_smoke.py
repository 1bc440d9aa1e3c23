#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (the script exits non-zero and prints no
result line):

1. Device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions.
2. Build: every hand-written kernel (``repro_torch.kernels.KERNELS``),
   compiled from the sources in this checkout, one nvcc per source, all
   started together; registers and spills of each kernel function as
   ptxas reports them (a spill in the wgmma flash kernel, the attention
   backward's kernels on both routes and its pre-pass, the fused gather,
   the sampling chain or ``sage_aggregate`` fails the run).
3. Graph + plans: ``synthetic_instance("PA", 1M vertices)``, a one-GPU
   Legion plan with a 300 MB cache, fanouts (25, 10), and the 2 x 2
   hierarchy of ``topology_matrix("dgx-v100", 4)`` (two cliques of two
   simulated GPUs, 150 MB per device, so each clique caches 300 MB).
4. Kernels: each kernel against its plain PyTorch version on the card,
   bitwise, at the shapes the serving, training and sharded paths give it
   (taken from a real 256-seed micro-batch, a real 8000-seed training
   batch and a real 8000-seed sharded step: one mesh position's routed
   gather, and the routed sampler's hop 0 (2000 x 25) and hop 1
   (50,000 x 10)) and at edge cases (bf16, D = 100, rows of 512 bytes in
   bf16 and of 4096 bytes, 4- and 1-byte aligned sources, a batch not a
   multiple of 32, all padding, one-row sources, an int32 D = 1 table,
   out-of-range and multi-dimensional indices, an empty update, all
   misses, one owning shard, degree-0 rows, draws near 2^31); the routed
   sampler's chain entry (every hop in one launch, routing included)
   bitwise against its plain version at the sharded position's 2000 seeds
   and a one-GPU training batch of 8000 seeds, with 1 and 3 hops, seeds
   of -1, uncached seeds, degree-0 rows, all misses, an empty topology
   cache, draws near 2^31 and out-of-range routing, then timed beside its
   byte bound, the two per-hop kernels on the same draws, and the per-hop
   (``device_sample_cached`` looped) and chain (``device_sample_chain``)
   compositions;
   ``sage_aggregate``, which no path runs, at a GraphSAGE first-layer shape
   of the training cell (200,000 rows x 10 neighbours over a 416,768 x 128
   f32 table), in bf16, at F = 25 and 40, with a row of pads only, F = 1,
   D = 100 in f32 and bf16, a table at storage offset 1 and row 0 = +inf
   under pads (NaN in the same places as the plain version), each case's
   route printed (``sage_route``: ``vec`` for rows of a multiple of 16
   bytes on a 16-byte aligned table, else ``scalar``; a spill in either
   route's kernel fails the build phase); its two routes timed in turns at
   the training shape (the scalar route forced through the route rule,
   ``forced_route``) beside the bound and a no-reuse diagnostic (every
   non-pad gather from device memory); then
   kernel, plain version and the nearest single PyTorch call timed with
   CUDA events, L2 flushed before every launch.
5. Serve: ``GNNServer`` with GraphSAGE at paper width (feat 128, hidden
   256, 32 classes, random weights from a seed) answers 200 requests of
   1-256 seeds with the bitwise host-oracle check on.
6. Train: ``train_gnn`` on the device backend at paper width (batch 8000)
   for 20 steps with an online cache refresh every 5 steps that replans on
   any drift; step times, hit rates before and after the first refresh,
   the refresh events, the staging pool, a per-layer breakdown of one step
   (sample, fill, finalize, forward+backward, optimizer) and of one
   refresh, and the device busy share of 5 steady steps of a separate
   profiled run.
7. Parity: host and device backends at batch 1024 for 12 steps with a
   refresh every 4 steps: bitwise-equal losses, identical refresh
   summaries and hit tallies.
8. Unfused: the device run again with ``fused=False`` for 4 steps: losses
   bitwise equal to the fused run's.
9. Shard: ``train_gnn(backend="sharded")`` on the 2 x 2 hierarchy at paper
   width (batch 8000 = 2000 seeds per mesh position) for 12 steps with a
   refresh every 5 steps that replans on any drift: step times, hit rates,
   each clique's refresh events, zero cross-clique feature and topology
   bytes, peer bytes within each clique; a per-layer breakdown of one
   sharded step (sample, fill, pack, upload, routed gather, forward and
   backward over the 4 positions, gradient sum and optimizer) and the
   device busy share of a profiled run.
10. Shard parity: at batch 1024 for 8 steps with a refresh at step 4, the
   sharded executor against the device backend on the same plan (losses
   within 1e-4, accuracies within 1e-6, identical traffic and refreshes),
   two sharded runs bitwise equal, and one step's per-position batches
   bitwise equal to the device backend's fused finalize of the same specs.
10b. Store and telemetry in training: the PA feature table written to an
   ``.npy`` file in a temporary directory (deleted after 10d; it stays in
   the page cache, so the store's "ssd" reads time an mmap copy), then 8
   device-backend steps at paper width, batch 8000, a refresh every 4
   steps replanning on any drift, on fresh copies of the one-GPU plan:
   features in RAM (loaded from the file); in RAM with ``Telemetry``
   (JSONL + Chrome trace, window 4); only in the file behind a
   ``FeatureStore`` of 200,000 host rows (20% of the table) with
   lookahead 4 and telemetry; the same store with lookahead 0; in RAM
   again.  Losses bitwise equal across all five; feature requests equal;
   every tally of the telemetry, lookahead-0 and repeated runs equal to
   the RAM run's (with lookahead 4 the refresh at step 4 has observed the
   window's batches too, as in the reference, so it may admit other rows);
   the store's HBM tallies equal the traffic counter's; both streams
   validate (``validate_stream``), telescope, close with no open span and
   8 ``device_step`` spans, and their traces hold span tracks of at least
   2 threads; ``repro_torch.obs.report.digest`` runs on them; the store
   run filled rows from the file, hit its host tier and announced 8
   batches; per run 8 ``fused_gather_overlay`` launches, one sampling
   chain per spec build and ``scatter_rows`` once per admitting refresh.
   Step times, host build totals, walls, store tallies, ``read_us`` and
   ``stall_us`` printed; then a 2-step telemetry run under
   ``torch.profiler`` (all threads) must show the ``device_step``,
   ``spec_build`` and ``finalize`` ranges.
10c. Store and telemetry in serving: ``GNNServer`` over the file-backed
   table with a ``FeatureStore`` (lookahead 0) and telemetry answers
   phase 5's 200 requests with the oracle check on: 0 mismatches, the
   final snapshot's ``serve.*`` and ``traffic.*`` totals equal
   ``summary()`` and the counter, one fused launch and one sampling chain
   per micro-batch.
10d. Resilience: (a) on fresh copies of the one-GPU plan, device backend,
   batch 8000, a refresh every 4 steps replanning on any drift, the
   features only in 10b's file behind a 200,000-row ``FeatureStore`` with
   lookahead 2 and serial builds: 8 steps uninterrupted, 4 steps with a
   checkpoint every 2, then ``resume=True`` to 8; the stitched losses
   bitwise the uninterrupted run's, resumed from step 4 with its runtime
   state; the restore's wall time as the resumed run measured it
   (``restore_s``: checkpoint load, the manager's reapply, the store's
   refill), the caller-side time of one ``save()`` of the restored state
   and the checkpoint's size.  (b) The same 8 steps with a ``FaultPlan``
   (``prefetch_build`` at step 3, ``checkpoint_write`` at call 0,
   ``ssd_read`` at call 3 twice, ``ssd_stall`` at call 8 for 10 ms) and
   telemetry: losses bitwise (a)'s, each injection and recovery tallied as
   planned, the final snapshot's ``fault.*``, ``recovery.*`` and
   ``checkpoint.*`` totals equal to the result's, the report's
   faults/recovery line printed.  (c) On fresh copies of the 2 x 2 plan,
   device 3 lost at step 4 of 8: at batch 1024 the host backend, the
   device backend and the device backend again bitwise equal (losses,
   events but for ``remesh_s`` and the backend), steps 0-3 bitwise a
   fault-free device run's; the old pipeline has run ahead of the loss by
   a timing-dependent number of batches, which the remesh discards and
   the traffic tallies count, so the tallies are held host against device
   with the loss at the last of 5 steps, where it has built every batch;
   at batch 8000 with ``backend="sharded"`` steps 0-3 bitwise a
   fault-free sharded run's, then the device backend on 3 survivors;
   ``remesh_s`` (closing the old pipeline, the replan at 1M vertices, a
   fresh pipeline) and the step medians before and after printed.  (d) On the
   card, ``launch.train.main`` for the gemma3 smoke config and for the GNN
   at 2000 vertices: ``--ckpt`` for 2 steps, then ``--resume`` to 4,
   losses bitwise a 4-step run's.  Each run's launches as its phase
   expects, the work a remesh discards included (the old pipeline's
   builds through the lost step and past it, from its ``batches_built``;
   the lost step's finalized batch is dropped).

11. LM kernel: ``gemma3-1b`` at full width and depth (26 layers, d_model
   1152, 4 query heads over 1 kv head of 256, vocab 262,144, windows of 512
   on 5 of every 6 layers; f32 weights from seed 0, about 1.0 B
   parameters).  ``flash_attention`` against its plain version on the card
   within rtol 1e-2 + atol 2e-3 (bf16) and rtol 1e-3 + atol 2e-4 (f32),
   each case's median |output| and route (``flash_route``: wgmma, mma_sync
   or simt, read from the per-route launch counts) printed beside its
   error: q, k, v captured from a real 4 x 4096 prefill at layer 0 (local)
   and layer 5 (global), both of which must take the wgmma route, the
   Pallas tests' (BH, S, Dh) shapes in f32, causal and not, and ragged
   S = 77, 1000 with window 1, 64 (a row's first visited tile all masked),
   512 and >= S, not causal, Sq != Sk, G = 1, 3, 4, 5 and 8, Dh 64, 80,
   128 and 256; then timed at the two prefill shapes beside its bound (bf16
   operations at 989 TFLOP/s or bytes, the larger) and SDPA; on the card
   an f32 call autograd would differentiate must raise (there is no f32
   backward), and a bf16 one must give gradients through the backward.
11b. LM backward: ``flash_attention_bwd`` on q, k, v, o, lse and do
   captured from one real training step (layer 0, local, and layer 5,
   global) and on edge cases (Dh 16, 64, 80, 128 and 256, windows 64 and
   512, G = 1, 2, 3, 4 and 5, ragged Sq, Sq != Sk), each on the route
   ``flash_bwd_route`` gives it (``wgmma`` for bf16 with Dh 64, 128 or
   256, ``mma_sync`` for other head dims; the captured calls must take
   ``wgmma``) and, where that is ``wgmma``, on ``mma_sync`` too (forced
   through the route rule, ``forced_route``): the forward kernel's o and
   lse first held to the plain forward's (lse within rtol = atol = 1e-4);
   per gradient, its max error over max |g| against the f64 exact
   gradient within twice that of the plain version (fed the plain
   forward's o and lse) plus 1e-3, two calls bitwise equal, each counted
   under its route; the forward recomputed on the captured calls gives the saved o
   and lse bits; then the two routes timed in turns at the two captured
   shapes beside the bound (5 products at the bf16 rate), the plain
   version and SDPA's backward, with the forward timed with and without
   lse.
12. LM serve: ``generate`` for 4 prompts of 4096 tokens (numpy, seed 1),
   then 32 greedy tokens: prefill ms, decode ms per step (CUDA events
   after each step; ``generate`` syncs only after the loop), tokens/s, peak
   device memory, flash-attention launches (26 = one per layer of the one
   prefill, all on the wgmma route), the profiled prefill's device time by
   kind, and the device busy share of 5 decode steps of a profiled run.
13. LM parity: at full width over S = 600 (across the window of 512),
   teacher-forced ``decode_step`` logits against the kernel path's
   ``forward`` (the log-softmax within the reference's rtol = atol = 5e-2,
   and its max difference within 0.15, twice what a forward through the
   plain attention differs by); the gemma3 smoke config
   generated on the CPU (plain version) and teacher-forced with its tokens
   on the card (kernel), logits within atol 5e-3.
14. LM train: ``launch.train.train_step`` on the same gemma3-1b weights at
   4 x 4096 (numpy batches, seed 0) with remat and the CE in chunks of
   512, AdamW, 8 steps (the first is warm-up): finite losses, step ms host
   wall and tokens/s, forward, backward and AdamW ms on CUDA events, peak
   device memory, exactly 26 forward, 26 recompute and 26 backward
   launches a step, all on ``wgmma``; then one profiled step's device time
   by kind (attention forward and backward, matmul, copies and casts, the
   rest, and AdamW after a synchronize).
15. LM train parity: the gemma3 smoke config trained 4 steps on the card
   (kernels, forward and backward on ``mma_sync``: head dim 16) and on the
   CPU (plain versions) from the same seed-0 weights and batches, losses
   within atol 2e-3.

Every kernel's launch count is zeroed just before each of the serve,
train, parity, unfused, shard, shard-parity, store-train (each of its 5
runs), store-serve, resil-* (each run of 10d), lm-serve, lm-parity,
lm-train and lm-train-parity phases and read just after, with the launches
by route; ``sage_aggregate``'s stay
0 (no path runs it), and ``routed_neighbor_sample`` launches once per
device-sampling spec build, on its ``chain`` route, never per hop.
The last three lines are the card's name and power limit, the
``{"kernels": [...]}`` record and ``{"ok": true, "device": {...}}``.
Without CUDA, or without the rest of the repository beside it, the script
fails.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device-memory rate (NVIDIA data sheet)
SPIN_CYCLES = 2_000_000    # time_ms's device spin: about 1 ms at 1.98 GHz
N_VERTICES = 1_000_000
MEM_PER_DEVICE = 300e6
MAX_BATCH = 256
N_REQUESTS = 200
TIMED_LAUNCHES = 100
TRAIN_STEPS = 20
SHARD_TOPOLOGY = ("dgx-v100", 4)  # 2 cliques x 2 GPUs
SHARD_MEM_PER_DEVICE = 150e6      # 300 MB per clique, the one-GPU budget
SHARD_STEPS = 12
SHARD_REFRESH = 5
SHARD_LAYER_STEPS = 3
SHARD_PARITY_STEPS = 8
PARITY_BATCH = 1024
PARITY_STEPS = 12
UNFUSED_STEPS = 4
STORE_STEPS = 8            # phase 10b: each run's steps
STORE_REFRESH = 4          # refresh interval there (replans on any drift)
STORE_HOST_ROWS = 200_000  # the store's host tier: 20% of the table
STORE_LOOKAHEAD = 4
# phase 10d: kill and resume, faults, the device-loss remesh
RESIL_STEPS = 8            # each run's steps (the killed run: half)
RESIL_LOOKAHEAD = 2        # the store's lookahead there
RESIL_LOSS = (4, 3)        # (step, device): device 3 of the 2 x 2 plan
RESIL_CLI_STEPS = (2, 4)   # the CLIs: killed after, resumed to
RESIL_CLI_VERTICES = 2000  # the GNN CLI's --max-vertices
PROFILE_STEPS = 8        # the profiled run; its steps 2..6 are the window
PROFILE_WINDOW = (2, 5)  # (first step, steps)
BF16_FLOPS_PER_S = 989e12  # H100 SXM dense bf16 tensor-core rate (data sheet)
SAGE_SHAPE = (416_768, 128, 200_000, 10)  # table rows, D, rows out, fanout
LM_ARCH = "gemma3-1b"
LM_BATCH, LM_PROMPT, LM_NEW = 4, 4096, 32
LM_CAPTURE = (0, 5)  # gemma3's first local and first global layer
LM_PROFILE_NEW = 8   # the profiled generation: decode steps 2..6 the window
LM_PARITY_LEN = 600  # crosses the local layers' window of 512
LM_SMOKE = (4, 24, 16)  # batch, prompt, new: the reference's serve_lm loop
# LM training: gemma3-1b at 4 x 4096 with remat and the CE in chunks of 512
# (the unchunked f32 logits would be 17.2 GB); the first step is warm-up
LM_TRAIN_STEPS = 8
LM_TRAIN_CHUNK = 512
LM_TRAIN_LR = 1e-3  # launch/train.py's default
LM_TRAIN_SMOKE = (4, 64, 4)  # batch, seq, steps: smoke config, card vs CPU
# the backward kernel against the f64 exact gradient: per gradient, max
# |kernel - exact| / max |exact| within twice the plain version's plus this
# floor (both round q * scale, p and each gradient to bf16; the kernel
# also rounds ds and sums in another order)
BWD_F64_FLOOR = 1e-3
# the forward kernel's lse (which the backward reads) against the plain
# forward's, as tests/test_torch_lm_kernels.py holds it
BWD_LSE_TOL = {"rtol": 1e-4, "atol": 1e-4}
BWD_TIMED_PLAIN = 10  # the plain backward's timed launches (tens of ms each)
# kernels held to their plain version within rtol + atol (the rest
# bitwise): flash attention sums in another order and rounds p to bf16
# against another running max; in bf16 the output's own rounding (one step
# is at most 2**-7 relative) sets rtol, and atol stays well below the median
# |output| of each case (printed beside it)
TOLERANCE = {"flash_attention": {"bfloat16": {"rtol": 1e-2, "atol": 2e-3},
                                 "float32": {"rtol": 1e-3, "atol": 2e-4}}}
# the backward kernel's rule (check_backward), for the kernels line
BWD_RULE = {"bfloat16": f"max|kernel - f64| / max|f64| <= 2 x the plain "
                        f"version's + {BWD_F64_FLOOR}"}
# teacher-forced decode against the kernel-path forward at full width: max
# |log-softmax difference| over the real vocabulary, on top of the
# reference's rtol = atol = 5e-2 (whose rtol allows about 0.6 at the
# |log-softmax| of 12.5 where most of a 262,144 vocabulary sits).  The same
# forward with the plain attention differs from the kernel path's by 0.068
# and decode by 0.078 (bf16 rounded at other points over 26 layers), so
# about twice that
LM_DECODE_GAP = 0.15
# smoke logits card vs CPU: measured 9.8e-4, one bf16 step at |logit| 0.125+
LM_SMOKE_ATOL = 5e-3
# smoke-config training, card vs CPU: each step's loss (from the same
# seed-0 weights and numpy batches; bf16 rounded at other points, then
# AdamW, whose normalised step turns small gradient differences into whole
# steps of lr for the weights that have them): measured 2.3e-4 over 4 steps
# on an H100 80GB HBM3 at 700 W
LM_TRAIN_SMOKE_ATOL = 2e-3
# kernel functions whose ptxas report must show no spill: the ones
# redesigned for Hopper (the wgmma flash kernels forward and backward with
# the backward's pre-pass, the fused gather, the sampling chain, both routes
# of sage_aggregate) and the mma.sync backward
SPILL_FREE = ("flash_fwd_wgmma", "fused_gather_overlay_kernel",
              "routed_neighbor_sample_chain_kernel", "sage_vec_kernel",
              "sage_scalar_kernel", "flash_bwd_dkdv", "flash_bwd_dq",
              "flash_bwd_wgmma", "flash_bwd_prep")
# kernels that no path of either package runs (their launches stay 0)
NO_PATH = {"sage_aggregate": "called only by its tests in the reference"}


def ptxas_functions(log: str) -> list:
    """Per kernel function of an ``nvcc -Xptxas -v`` log, in its order:
    (short name such as ``flash_fwd_wgmma<256>``, the ptxas lines on its
    registers and spills)."""
    out = []
    for line in log.splitlines():
        if "Function properties for " in line:
            out.append((demangle(line.split("Function properties for ")[1]
                                 .strip()), []))
        elif out and ("registers" in line or "spill" in line):
            out[-1][1].append(line.replace("ptxas info    :", "").strip())
    return out


def demangle(sym: str) -> str:
    """The last name of an Itanium-mangled symbol, with its integer template
    arguments: ``_ZN..15flash_fwd_wgmmaILi256EEEv..`` -> ``flash_fwd_wgmma<256>``."""
    pos = 3 if sym.startswith("_ZN") else 2
    name = sym
    while pos < len(sym) and sym[pos].isdigit():
        m = re.match(r"\d+", sym[pos:])
        n = int(m.group())
        pos += len(m.group())
        name = sym[pos:pos + n]
        pos += n
    args = re.match(r"I((?:Li\d+E)+)E", sym[pos:])
    if args:
        name += "<" + ", ".join(re.findall(r"Li(\d+)E", args.group(1))) + ">"
    return name


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def time_ms(torch, fn, args, n: int, flush) -> float:
    """Median per-launch device time, L2 flushed before each launch (a batch
    finds its rows cold: the forward and backward run in between).  After
    the flush the device spins for about a millisecond, so the call's host
    work (the wrapper's checks, the launch) is enqueued before the start
    event is reached and never counts as device time."""
    fn(*args)
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
    for s, e in zip(starts, ends):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        s.record()
        fn(*args)
        e.record()
    torch.cuda.synchronize()
    times = sorted(s.elapsed_time(e) for s, e in zip(starts, ends))
    return times[len(times) // 2]


# ---- the bytes each kernel must move (each input read once, each output
# ---- written once, counted for this run's data) -------------------------

def gather_bytes(idx, miss_inv, row_bytes: int) -> int:
    """fused_gather_overlay: every distinct source row read once, both maps
    read once, every output row written."""
    import torch

    fresh = miss_inv >= 0
    cached = (idx >= 0) & ~fresh
    rows = (torch.unique(miss_inv[fresh]).numel()
            + torch.unique(idx[cached]).numel())
    B = idx.numel()
    return rows * row_bytes + 2 * B * 4 + B * row_bytes


def gather_rows_bytes(idx, n_table: int, row_bytes: int) -> int:
    """gather_rows: every distinct row referenced read once, the index read
    once, every output row written."""
    import torch

    valid = idx[idx >= 0].clamp_max(n_table - 1)
    B = idx.numel()
    return torch.unique(valid).numel() * row_bytes + B * 4 + B * row_bytes


def scatter_rows_bytes(n_table: int, n_idx: int, row_bytes: int) -> int:
    """scatter_rows: every table row read once (from the old table or the
    admitted rows), the index read once, every output row written."""
    return 2 * n_table * row_bytes + n_idx * 4


# ---- the cases of each kernel: name -> wrapper arguments, plus the timed
# ---- shapes (name, args, bytes, library call or None) --------------------

def offset_copy(torch, t, nbytes: int):
    """A contiguous copy of ``t`` whose data starts ``nbytes`` past a
    16-byte boundary."""
    size = t.numel() * t.element_size()
    raw = torch.zeros(size + 16, dtype=torch.uint8, device=t.device)
    out = raw[nbytes:nbytes + size].view(t.dtype).view(t.shape)
    out.copy_(t)
    return out


def fused_gather_overlay_cases(torch, ctx, seed: int = 0):
    """The serving and training shapes as given, the serving shape in bf16,
    with the same hit/miss/pad mix: random rows of 400 bytes (D = 100 f32),
    512 bytes in bf16 (D = 256) and 4096 bytes (D = 1024 f32), 4-byte and
    1-byte aligned sources, a batch that is not a multiple of 32, all
    padding and all misses; and one-row sources (an empty cache's dummy
    table, a one-row miss buffer)."""
    table, s, t = ctx["table"], ctx["serve"], ctx["train"]
    idx, miss, inv = s["idx"], s["miss"], s["inv"]
    gen = torch.Generator(device=table.device).manual_seed(seed)
    dev = table.device
    t100 = torch.randn((50_000, 100), generator=gen, device=dev)
    m100 = torch.randn((miss.shape[0], 100), generator=gen, device=dev)
    idx100 = torch.where(idx >= 0, idx % t100.shape[0], idx)
    t256 = torch.randn((50_000, 256), generator=gen, device=dev) \
        .to(torch.bfloat16)
    m256 = torch.randn((miss.shape[0], 256), generator=gen, device=dev) \
        .to(torch.bfloat16)
    t1024 = torch.randn((20_000, 1024), generator=gen, device=dev)
    m1024 = torch.randn((miss.shape[0], 1024), generator=gen, device=dev)
    idx20k = torch.where(idx >= 0, idx % t1024.shape[0], idx)
    u8t = torch.randint(0, 256, (50_000, 100), generator=gen, device=dev,
                        dtype=torch.uint8)
    u8m = torch.randint(0, 256, (miss.shape[0], 100), generator=gen,
                        device=dev, dtype=torch.uint8)
    B = idx.shape[0]
    odd = B - 13
    pad = torch.full_like(idx, -1)
    one_t = torch.zeros((1, table.shape[1]), device=dev)
    one_m = torch.arange(table.shape[1], dtype=torch.float32,
                         device=dev)[None, :] + 1.0
    one_idx = torch.full_like(idx, -1)
    one_inv = torch.where(inv >= 0, torch.zeros_like(inv),
                          torch.full_like(inv, -1))
    cases = {
        "train_f32": (table, t["idx"], t["miss"], t["inv"]),
        "serve_f32": (table, idx, miss, inv),
        "serve_bf16": (table.to(torch.bfloat16), idx,
                       miss.to(torch.bfloat16), inv),
        "d100_f32": (t100, idx100, m100, inv),
        "d256_bf16_512B": (t256, idx100, m256, inv),
        "d1024_f32_4096B": (t1024, idx20k, m1024, inv),
        "aligned_4B": (offset_copy(torch, table, 4), idx,
                       offset_copy(torch, miss, 4), inv),
        "aligned_1B_uint8": (offset_copy(torch, u8t, 1), idx100,
                             offset_copy(torch, u8m, 3), inv),
        "b_not_multiple_of_32": (table, idx[:odd].contiguous(), miss,
                                 inv[:odd].contiguous()),
        "all_padding": (table, pad, miss, pad),
        "all_misses": (table, idx, miss,
                       (torch.arange(B, device=dev, dtype=torch.int32)
                        % miss.shape[0])),
        "one_row_sources": (one_t, one_idx, one_m, one_inv),
    }
    row = table.shape[1] * table.element_size()
    timed = [("train", cases["train_f32"],
              gather_bytes(t["idx"], t["inv"], row), None),
             ("serve", cases["serve_f32"], gather_bytes(idx, inv, row),
              None)]
    return cases, timed


def gather_rows_cases(torch, ctx, seed: int = 1):
    """The unfused finalize's cached-row gather of the real training batch
    (misses at -1), in bf16, at D = 100, an int32 D = 1 table (the cached
    CSR column), indices past the end, and a (B, F) index."""
    table, idx = ctx["table"], ctx["train"]["unfused_idx"]
    dev, N = table.device, table.shape[0]
    gen = torch.Generator(device=dev).manual_seed(seed)
    t100 = torch.randn((50_000, 100), generator=gen, device=dev)
    col = ctx["csr_col"]
    col_idx = torch.randint(-1_000, col.shape[0] + 1_000, (300_000,),
                            generator=gen, device=dev, dtype=torch.int32)
    oor = idx.clone()
    oor[::97] = N + torch.arange(oor[::97].numel(), dtype=torch.int32,
                                 device=dev)
    F = 25
    nb = idx.numel() // F
    cases = {
        "train_f32": (table, idx),
        "train_bf16": (table.to(torch.bfloat16), idx),
        "d100_f32": (t100, torch.where(idx >= 0, idx % t100.shape[0], idx)),
        "int32_d1": (col, col_idx),
        "out_of_range": (table, oor),
        "index_bxf": (table, idx[:nb * F].reshape(nb, F)),
    }
    row = table.shape[1] * table.element_size()
    lib_idx = idx.clamp_min(0)
    timed = [("train", cases["train_f32"], gather_rows_bytes(idx, N, row),
              ("torch.index_select(table, 0, idx.clamp_min(0))",
               lambda: torch.index_select(table, 0, lib_idx)))]
    return cases, timed


def scatter_rows_cases(torch, ctx, seed: int = 2):
    """The real feature table with 10% unique random slots admitted (1% of
    the entries negative and 1% past the end, both dropped), in bf16, at
    D = 100, and an empty update."""
    table = ctx["table"]
    dev, (N, D) = table.device, table.shape
    gen = torch.Generator(device=dev).manual_seed(seed)
    B = N // 10
    idx = torch.randperm(N, generator=gen, device=dev)[:B].to(torch.int32)
    k = B // 100
    idx[:k] = -1 - torch.arange(k, dtype=torch.int32, device=dev)
    idx[k:2 * k] = N + torch.arange(k, dtype=torch.int32, device=dev)
    rows = torch.randn((B, D), generator=gen, device=dev)
    t100 = torch.randn((50_000, 100), generator=gen, device=dev)
    idx100 = torch.randperm(50_000, generator=gen, device=dev)[:5_000] \
        .to(torch.int32)
    rows100 = torch.randn((5_000, 100), generator=gen, device=dev)
    cases = {
        "refresh_f32": (table, idx, rows),
        "refresh_bf16": (table.to(torch.bfloat16), idx,
                         rows.to(torch.bfloat16)),
        "d100_f32": (t100, idx100, rows100),
        "empty": (table, idx[:0], rows[:0]),
    }
    valid = (idx >= 0) & (idx < N)
    lib_idx, lib_rows = idx[valid].to(torch.int64), rows[valid]
    row = D * table.element_size()
    timed = [("refresh", cases["refresh_f32"],
              scatter_rows_bytes(N, B, row),
              ("torch.index_copy(table, 0, valid_idx, valid_rows)",
               lambda: torch.index_copy(table, 0, lib_idx, lib_rows)))]
    return cases, timed


def routed_gather_bytes(shards, owner, local) -> int:
    """routed_gather: every distinct owned row read once, both routing maps
    read once, every output row written."""
    import torch

    k, R, D = shards.shape
    row = D * shards.element_size()
    hit = owner >= 0
    flat = (owner[hit].clamp_max(k - 1).to(torch.int64) * R
            + local[hit].clamp(0, R - 1).to(torch.int64))
    n = owner.numel()
    return torch.unique(flat).numel() * row + n * 8 + n * row


def routed_sample_bytes(indptr, indices, owner, local, rand) -> int:
    """routed_neighbor_sample: the routing read once, every distinct indptr
    entry an owned row needs read once, the draws read once, every distinct
    neighbor id sampled read once, the output written."""
    import torch

    k, R1 = indptr.shape
    E = indices.shape[1]
    n, f = rand.shape
    own = owner >= 0
    o = owner[own].clamp_max(k - 1).to(torch.int64)
    lo = local[own].to(torch.int64).clamp(0, R1 - 1)
    l1 = (lo + 1).clamp_max(R1 - 1)
    entries = torch.unique(torch.cat([o * R1 + lo, o * R1 + l1])).numel()
    start = indptr[o, lo]
    deg = indptr[o, l1] - start
    offs = rand[own] % deg.clamp_min(1)[:, None]
    idx = (start[:, None] + offs).clamp(0, E - 1)
    reads = torch.unique((o[:, None] * E + idx)[deg > 0]).numel()
    return n * 8 + entries * 8 + n * f * 8 + reads * 4 + n * f * 4


def routed_gather_cases(torch, ctx, seed: int = 3):
    """One mesh position's routed gather of the real sharded step (clique
    0's shard stack, position (0, 0)'s routing), in bf16, at D = 100, all
    misses, every hit owned by one shard, and owners and slots past the
    end."""
    sh = ctx["shard"]
    shards, owner, local = sh["shards"], sh["owner"], sh["local"]
    k, R, D = shards.shape
    dev = shards.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    s100 = torch.randn((k, 50_000, 100), generator=gen, device=dev)
    one = torch.where(owner >= 0, torch.full_like(owner, k - 1), owner)
    bad_o, bad_l = owner.clone(), local.clone()
    bad_o[1::97] = k + 1
    bad_l[::89] = R + 5
    bad_l[2::89] = -3
    cases = {
        "position_f32": (shards, owner, local),
        "position_bf16": (shards.to(torch.bfloat16), owner, local),
        "d100_f32": (s100, owner, local % 50_000),
        "all_misses": (shards, torch.full_like(owner, -1), local),
        "one_owner": (shards, one, local),
        "out_of_range": (shards, bad_o, bad_l),
    }
    flat = shards.reshape(k * R, D)
    lib_idx = (owner.clamp(0, k - 1).to(torch.int64) * R
               + local.clamp(0, R - 1).to(torch.int64))
    timed = [("position", cases["position_f32"],
              routed_gather_bytes(shards, owner, local),
              ("torch.index_select(shards.reshape(-1, D), 0, flat_idx)",
               lambda: torch.index_select(flat, 0, lib_idx)))]
    return cases, timed


def routed_neighbor_sample_cases(torch, ctx, seed: int = 4):
    """The routed sampler at the real sharded step's hop 0 and hop 1 (clique
    0's CSR shards, position (0, 0)'s frontier), degree-0 rows (the pad
    row), draws near 2^31, owners and slots past the end, all misses."""
    sh = ctx["shard"]
    ip, ix = sh["indptr"], sh["indices"]
    (o1, l1, r1), hop0 = sh["hop1"], sh["hop0"]
    k, R1 = ip.shape
    near = r1.clone()
    near[::3] = (1 << 31) - 1 - torch.arange(
        near[::3].shape[0], device=near.device)[:, None]
    bad_o, bad_l = o1.clone(), l1.clone()
    bad_o[::101] = k + 2
    bad_l[1::71] = R1 + 3
    cases = {
        "hop0": (ip, ix, *hop0),
        "hop1": (ip, ix, o1, l1, r1),
        "deg0_rows": (ip, ix, o1, torch.full_like(l1, R1 - 1), r1),
        "draws_near_2^31": (ip, ix, o1, l1, near),
        "out_of_range": (ip, ix, bad_o, bad_l, r1),
        "all_misses": (ip, ix, torch.full_like(o1, -1), l1, r1),
    }
    timed = [("hop1", cases["hop1"], routed_sample_bytes(*cases["hop1"]),
              None),
             ("hop0", cases["hop0"], routed_sample_bytes(*cases["hop0"]),
              None)]
    return cases, timed


def routed_chain_bytes(indptr, indices, topo_owner, topo_local, seeds,
                       rands) -> int:
    """routed_neighbor_sample_chain: the seeds and every hop's draws read
    once, the routing (owner and slot) of every distinct frontier vertex
    read once, every distinct indptr entry an owned row needs read once,
    every distinct neighbor id sampled read once; every hop's neighbors and
    hit flags written once."""
    import torch

    from repro_torch.kernels import ref

    k, R1 = indptr.shape
    E = indices.shape[1]
    N = topo_owner.shape[0]
    verts, entries, reads = [], [], []
    frontier = seeds
    total = seeds.numel() * 8
    for rand in rands:
        valid = frontier >= 0
        v = frontier[valid].clamp_max(N - 1)
        verts.append(v)
        o_raw = topo_owner[v].to(torch.int64)
        own = o_raw >= 0
        o = o_raw[own].clamp_max(k - 1)
        lo = topo_local[v][own].clamp(0, R1 - 1)
        l1 = (lo + 1).clamp_max(R1 - 1)
        entries += [o * R1 + lo, o * R1 + l1]
        start = indptr[o, lo]
        deg = indptr[o, l1] - start
        rows = torch.nonzero(valid).reshape(-1)[own]
        offs = rand[rows] % deg.clamp_min(1)[:, None]
        idx = (start[:, None] + offs).clamp(0, E - 1)
        reads.append((o[:, None] * E + idx)[deg > 0].reshape(-1))
        total += rand.numel() * 8 + rand.numel() * 4 + rand.shape[0]
        outs, _ = ref.routed_neighbor_sample_chain(
            indptr, indices, topo_owner, topo_local, frontier, [rand])
        frontier = outs[0].reshape(-1).to(torch.int64)
    uniq = [torch.unique(torch.cat(x)).numel() if x else 0
            for x in (verts, entries, reads)]
    return total + uniq[0] * (4 + 8) + uniq[1] * 8 + uniq[2] * 4


def chain_edge_cases(torch, np, sample, seed: int = 7) -> dict:
    """The chain at the sharded position's shape with 1 and 3 hops, seeds
    of -1, uncached seeds, degree-0 rows (every slot routed to the pad
    row), all misses, an empty topology cache, draws near 2^31, and owners
    and slots out of range."""
    ip, ix, owner, local, seeds, (r0, r1) = sample["chain"]
    dev = seeds.device
    k, R1 = ip.shape
    gen = torch.Generator(device=dev).manual_seed(seed)

    def draws(n, fanouts):
        out = []
        for f in fanouts:
            out.append(torch.randint(0, 1 << 31, (n, f), generator=gen,
                                     device=dev, dtype=torch.int64))
            n *= f
        return out

    minus = seeds.clone()
    minus[::5] = -1
    uncached = torch.nonzero(owner < 0).reshape(-1)
    uncached = uncached[torch.randint(0, uncached.numel(), seeds.shape,
                                      generator=gen, device=dev)]
    mixed = torch.where(torch.arange(seeds.numel(), device=dev) % 2 == 0,
                        seeds, uncached)
    near0, near1 = r0.clone(), r1.clone()
    near0[::3] = (1 << 31) - 1 - torch.arange(near0.shape[1], device=dev)
    near1[1::3] = (1 << 31) - 1 - torch.arange(near1.shape[1], device=dev)
    bad_o, bad_l = owner.clone(), local.clone()
    bad_o[::101] = k + 2
    bad_o[1::103] = -5
    bad_l[::71] = R1 + 3
    bad_l[1::73] = -2
    s3 = seeds[:200].contiguous()
    return {
        "position_1_hop": (ip, ix, owner, local, seeds, [r0]),
        "position_2_hops": sample["chain"],
        "position_3_hops": (ip, ix, owner, local, s3,
                            draws(s3.numel(), (25, 10, 4))),
        "seeds_of_-1": (ip, ix, owner, local, minus, [r0, r1]),
        "uncached_seeds": (ip, ix, owner, local, mixed, [r0, r1]),
        "degree_0_rows": (ip, ix, owner, torch.full_like(local, R1 - 1),
                          seeds, [r0, r1]),
        "all_misses": (ip, ix, torch.full_like(owner, -1), local, seeds,
                       [r0, r1]),
        "empty_topology_cache": (
            torch.zeros((k, 1), dtype=torch.int64, device=dev),
            torch.zeros((k, 1), dtype=torch.int32, device=dev),
            torch.full_like(owner, -1), local, seeds, [r0, r1]),
        "draws_near_2^31": (ip, ix, owner, local, seeds, [near0, near1]),
        "out_of_range": (ip, ix, bad_o, bad_l, seeds, [r0, r1]),
    }


def per_hop_composition(cache, seeds, fanouts, rands):
    """The chain as it ran before the chain kernel: ``device_sample_cached``
    hop after hop (routing glue, pageable upload of the draws, the per-hop
    kernel), each hop fed the previous hop's device output."""
    frontier = seeds
    for f, r in zip(fanouts, rands):
        out, _ = cache.device_sample_cached(frontier, f, rand=r)
        frontier = out.reshape(-1)


def composition_cost(torch, fn, args, flush, n: int = 10) -> dict:
    """One composition of host and device work (``device_sample_cached``
    looped, or ``device_sample_chain``) per call, L2 flushed before each:
    its device operations and their summed device time (torch.profiler),
    and the host wall time of the call up to a synchronize."""
    from torch.profiler import ProfilerActivity, profile

    fn(*args)
    torch.cuda.synchronize()
    walls = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        for _ in range(n):
            flush.zero_()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.profiler.record_function("composition"):
                fn(*args)
                torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
    events = prof.events()
    rows = []
    for e in events:
        if e.name == "composition" \
                and e.device_type == torch.autograd.DeviceType.CPU:
            rows += device_rows(torch, events, e.time_range.start,
                                e.time_range.end)
    wall = sorted(walls)[len(walls) // 2]
    if not rows:
        return {"device_ops": None, "device_ms": None, "wall_ms": wall}
    return {"device_ops": len(rows) / n,
            "device_ms": sum(t - s for s, t, _ in rows) / n / 1e3,
            "wall_ms": wall}


def check_and_time_chain(torch, np, k, measured, contexts, flush,
                         card) -> None:
    """The chain entry of ``routed_neighbor_sample``: bitwise against its
    plain version on the edge cases and at the timed shapes (outputs and
    hit masks, inputs unchanged), then at each timed shape the kernel, the
    plain version and the two per-hop kernels on the same draws (summed),
    beside the byte bound, the same method's floor (an empty kernel,
    ``torch.cuda._sleep(0)``) and the chain cut to its first hop; and the
    per-hop composition (``device_sample_cached`` looped) against the
    chain composition (``device_sample_chain``: one upload, one kernel):
    device operations, their device time and the host wall time per call.
    Adds its timed shapes first in ``measured["timed"]``."""
    from repro_torch.kernels import gather, ref

    cases = chain_edge_cases(torch, np, contexts["position"])
    for shape, c in contexts.items():
        cases[f"chain_{shape}"] = c["chain"]
    for name, args in cases.items():
        snap = [t.clone() for t in args[:5]] + [r.clone() for r in args[5]]
        got_o, got_h = gather.routed_neighbor_sample_chain(*args)
        want_o, want_h = ref.routed_neighbor_sample_chain(*args)
        torch.cuda.synchronize()
        if len(got_o) != len(args[5]) or not all(
                a.dtype == b.dtype and torch.equal(a, b)
                for a, b in zip(got_o + got_h, want_o + want_h)):
            raise AssertionError(f"routed_neighbor_sample_chain != plain "
                                 f"version on case {name}")
        if not all(torch.equal(a, b)
                   for a, b in zip(list(args[:5]) + list(args[5]), snap)):
            raise AssertionError("routed_neighbor_sample_chain wrote one of "
                                 f"its inputs (case {name})")
        measured["errs"][f"chain:{name}"] = 0.0
    print(f"[kernel] routed_neighbor_sample chain: bitwise equal (neighbors "
          f"and hit masks) on {sorted(cases)}; inputs unchanged | {card}")
    timed = {}
    floor = time_ms(torch, torch.cuda._sleep, (0,), TIMED_LAUNCHES, flush)
    for shape, c in contexts.items():
        args = c["chain"]
        first = (*args[:5], args[5][:1])
        n_args = (c["cache"], c["seeds"], c["fanouts"], c["rands"])
        runs = []
        for _ in range(2):  # kernel, plain, per-hop kernels, first hop
            r = [time_ms(torch, gather.routed_neighbor_sample_chain, args,
                         TIMED_LAUNCHES, flush),
                 time_ms(torch, ref.routed_neighbor_sample_chain, args,
                         TIMED_LAUNCHES, flush),
                 sum(time_ms(torch, gather.routed_neighbor_sample, h,
                             TIMED_LAUNCHES, flush) for h in c["hops"]),
                 time_ms(torch, gather.routed_neighbor_sample_chain, first,
                         TIMED_LAUNCHES, flush)]
            runs.append(r)
        mean = [float(np.mean([r[i] for r in runs])) for i in range(4)]
        per_hop = composition_cost(torch, per_hop_composition, n_args, flush)
        chain = composition_cost(torch, c["cache"].device_sample_chain,
                                 n_args[1:], flush)
        nbytes = routed_chain_bytes(*args)
        res = {"ms": mean[0], "plain_ms": mean[1], "library_ms": None,
               "library_call": None,
               "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
               "bound_by": "bytes", "bytes": int(nbytes), "flops": None,
               "per_hop_kernels_ms": mean[2], "first_hop_ms": mean[3],
               "launch_floor_ms": floor,
               "per_hop_composition": per_hop, "chain_composition": chain,
               "seeds": len(c["seeds"]), "fanouts": list(c["fanouts"])}
        timed[f"chain_{shape}"] = res
        print(f"[kernel] routed_neighbor_sample chain @ {shape} "
              f"({len(c['seeds'])} seeds, fanouts {c['fanouts']}): kernel "
              f"{res['ms']:.4f} ms, plain {res['plain_ms']:.4f} ms, bound "
              f"{res['bound_ms']:.4f} ms by bytes ({nbytes / 1e6:.2f} MB); "
              f"the per-hop kernels on the same draws {mean[2]:.4f} ms "
              f"summed (chain / per-hop {mean[0] / mean[2]:.3f}); the chain "
              f"cut to its first hop {mean[3]:.4f} ms; an empty kernel "
              f"timed the same way {floor:.4f} ms; runs {runs} | {card}")
        print(f"[kernel] routed_neighbor_sample compositions @ {shape}, per "
              f"call: per hop (device_sample_cached x {len(c['fanouts'])}) "
              f"{per_hop['device_ops']} device operations, "
              f"{per_hop['device_ms']} ms of device time, wall "
              f"{per_hop['wall_ms']:.4f} ms; chain (device_sample_chain) "
              f"{chain['device_ops']} device operations, "
              f"{chain['device_ms']} ms of device time, wall "
              f"{chain['wall_ms']:.4f} ms (torch.profiler on) | {card}")
    measured["timed"] = timed | measured["timed"]


def sage_aggregate_bytes(table, idx) -> int:
    """sage_aggregate: every distinct row read once (pads read row 0), idx
    and w read once, every output row written."""
    import torch

    N, D = table.shape
    rows = torch.unique(idx.clamp(0, N - 1)).numel()
    return (rows * D * table.element_size() + idx.numel() * 8
            + idx.shape[0] * D * table.element_size())


def sage_no_reuse_bytes(table, idx) -> int:
    """A diagnostic, not a bound: the bytes sage_aggregate moves when L2
    keeps no row between its gathers (every non-pad gather read from device
    memory), plus idx, w and out."""
    D = table.shape[1]
    return (int((idx >= 0).sum()) * D * table.element_size()
            + idx.numel() * 8 + idx.shape[0] * D * table.element_size())


@contextlib.contextmanager
def forced_route(module, rule: str, route: str):
    """Every call of ``module``'s wrapper takes ``route``: its route rule
    (the function ``module.<rule>``, e.g. ``sage_agg.sage_route`` or
    ``flash_attention.flash_bwd_route``) is swapped for one that returns
    ``route``."""
    saved = getattr(module, rule)
    setattr(module, rule, lambda *_: route)
    try:
        yield
    finally:
        setattr(module, rule, saved)


def sage_aggregate_cases(torch, ctx, seed: int = 5):
    """A GraphSAGE first-layer aggregation at the training cell's shape
    (200,000 hop-1 rows of 10 neighbours over the 416,768 x 128 f32 block
    of unique rows, 5% pads), in bf16; the hop-0 fanout (8000 x 25); F = 40
    (past one 32-lane chunk of indices); a row of pads only, F = 1; D = 100
    in f32 (400-byte rows: ``vec``) and bf16 (200-byte rows: ``scalar``); a
    contiguous f32 table at storage offset 1 (``scalar``); row 0 = +inf
    under pads (NaN wherever a row has a pad, in both versions)."""
    dev = ctx["table"].device
    gen = torch.Generator(device=dev).manual_seed(seed)
    N, D, B, F = SAGE_SHAPE
    table = torch.randn((N, D), generator=gen, device=dev)
    idx = torch.randint(0, N, (B, F), generator=gen, device=dev,
                        dtype=torch.int32)
    pad = torch.rand((B, F), generator=gen, device=dev) < 0.05
    idx = torch.where(pad, -1, idx).contiguous()
    idx[0] = -1
    w = torch.rand((B, F), generator=gen, device=dev)

    def wide(b, f):
        i = torch.randint(-1, N, (b, f), generator=gen, device=dev,
                          dtype=torch.int32)
        return i, torch.rand((b, f), generator=gen, device=dev)

    small = 50_000
    t100 = torch.randn((small, 100), generator=gen, device=dev)
    raw = torch.randn(small * D + 1, generator=gen, device=dev)
    inf0 = raw[1:].view(small, D).clone()
    inf0[0] = float("inf")
    i_small = torch.where(idx >= 0, idx % small, idx)[:20_000].contiguous()
    cases = {
        "train_f32": (table, idx, w),
        "train_bf16": (table.to(torch.bfloat16), idx, w),
        "f25": (table, *wide(8000, 25)),
        "f40": (table, *wide(20_000, 40)),
        "f1": (table, idx[:, :1].contiguous(), w[:, :1].contiguous()),
        "d100_f32": (t100, torch.where(idx >= 0, idx % small, idx), w),
        "d100_bf16": (t100.to(torch.bfloat16), i_small, w[:20_000]),
        "misaligned": (raw[1:].view(small, D), i_small, w[:20_000]),
        "row0_inf": (inf0, i_small, w[:20_000]),
    }
    lib_idx = idx.clamp_min(0)
    lib = ("F.embedding_bag(idx.clamp_min(0), table, per_sample_weights="
           "w * (idx >= 0), mode='sum')")
    timed = []
    for name, case in (("train", "train_f32"), ("train_bf16", "train_bf16")):
        t = cases[case][0]
        lib_w = (w * (idx >= 0)).to(t.dtype)
        timed.append((name, cases[case], sage_aggregate_bytes(t, idx),
                      (lib, lambda t=t, lib_w=lib_w:
                       torch.nn.functional.embedding_bag(
                           lib_idx, t, per_sample_weights=lib_w,
                           mode="sum"))))
    return cases, timed


def sage_routes_side_by_side(torch, np, k, measured, flush, card) -> None:
    """``sage_aggregate``'s two routes at the training shape in f32, in
    turns (vec, scalar, scalar, vec; the scalar route forced through the
    route rule), beside the bound and the no-reuse diagnostic; and the
    row0_inf case's NaNs, which must fall where a row has a pad."""
    from repro_torch.kernels import sage_agg

    cases, _ = sage_aggregate_cases(torch, {"table": flush})
    table, idx, w = cases["row0_inf"]
    nan = k.wrapper(table, idx, w).isnan()
    if not torch.equal(nan.any(1), (idx < 0).any(1)) or not bool(nan.any()):
        raise AssertionError("sage_aggregate row0_inf: NaN rows are not the "
                             "rows with a pad")
    table, idx, w = cases["train_f32"]
    times = {"vec": [], "scalar": []}
    for route in ("vec", "scalar", "scalar", "vec"):
        with forced_route(sage_agg, "sage_route", route):
            times[route].append(time_ms(torch, k.wrapper, (table, idx, w),
                                        TIMED_LAUNCHES, flush))
    vec = measured["timed"]["train"]
    no_reuse = sage_no_reuse_bytes(table, idx)
    measured["timed"]["train_scalar"] = vec | {
        "ms": float(np.mean(times["scalar"])), "route": "scalar",
        "library_ms": None, "library_call": None}
    measured["timed"]["train"]["route"] = "vec"
    print(f"[kernel] sage_aggregate @ train (f32), in turns: vec "
          f"{np.mean(times['vec']):.4f} ms {times['vec']}, scalar "
          f"{np.mean(times['scalar']):.4f} ms {times['scalar']}; bound "
          f"{vec['bound_ms']:.4f} ms ({vec['bytes'] / 1e6:.1f} MB); "
          f"diagnostic, not a bound: no-reuse bytes {no_reuse / 1e6:.1f} MB"
          f", {no_reuse / HBM_BYTES_PER_S * 1e3:.4f} ms at 3.35 TB/s | "
          f"{card}")
    bf = cases["train_bf16"]
    bf_no_reuse = sage_no_reuse_bytes(bf[0], bf[1])
    print(f"[kernel] sage_aggregate @ train_bf16: diagnostic, not a bound: "
          f"no-reuse bytes {bf_no_reuse / 1e6:.1f} MB, "
          f"{bf_no_reuse / HBM_BYTES_PER_S * 1e3:.4f} ms at 3.35 TB/s | "
          f"{card}")


def causal_pairs(S: int, window: int) -> int:
    """Visible (query, key) pairs of one head of causal attention over S
    positions with a window (<= 0: unbounded)."""
    w = window if 0 < window < S else S
    return sum(min(i + 1, w) for i in range(S))


def flash_work(q, k, window: int) -> tuple:
    """(bytes, flops) of one causal attention call: q, k, v and out once
    each; 4 * Dh flops per visible pair and query head."""
    B, S, Hq, Dh = q.shape
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    return nbytes, 4 * Dh * B * Hq * causal_pairs(S, window)


def flash_attention_cases(torch, ctx, seed: int = 6):
    """bf16 q/k/v captured from the full-width gemma3-1b prefill (4 x 4096
    tokens): layer 0 (local, window 512) and layer 5 (global); the Pallas
    tests' (BH, S, Dh) shapes in f32, causal and not; ragged S = 77 and
    1000 with windows 1, 64 (the tile at position 96 visits keys 0-63, all
    masked for its row 127), 512 and >= S, not causal, Sq != Sk, G = 1, 3,
    4, 5 and 8, Dh 64, 80, 128 and 256."""
    import torch.nn.functional as F

    dev = ctx["lm"][0][0].device
    gen = torch.Generator(device=dev).manual_seed(seed)

    def qkv(B, S, Hq, Hkv, Dh, dtype, scale=1.0, Sk=None):
        Sk = S if Sk is None else Sk
        return tuple((torch.randn(shape, generator=gen, device=dev) * sc)
                     .to(dtype) for shape, sc in
                     (((B, S, Hq, Dh), scale), ((B, Sk, Hkv, Dh), scale),
                      ((B, Sk, Hkv, Dh), 1.0)))

    cases, timed = {}, []
    for layer, (q, k, v, kw) in sorted(ctx["lm"].items()):
        kind = "global" if kw["window"] >= q.shape[1] else "local"
        name = f"prefill_l{layer}_{kind}"
        cases[name] = (q, k, v, kw)
        nbytes, flops = flash_work(q, k, kw["window"])
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        S = q.shape[1]
        mask = None
        if kind == "local":
            i = torch.arange(S, device=dev)
            mask = (i[:, None] >= i[None, :]) & (i[:, None] - i[None, :]
                                                 < kw["window"])

        def sdpa(qt=qt, kt=kt, vt=vt, mask=mask):
            return F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, is_causal=mask is None,
                enable_gqa=True)
        timed.append((name, cases[name], nbytes,
                      ("F.scaled_dot_product_attention(enable_gqa=True"
                       + (", explicit window mask)" if mask is not None
                          else ", is_causal=True)"), sdpa), flops))
    for BH, S, Dh in ((4, 256, 64), (2, 128, 128), (1, 384, 128)):
        q, k, v = qkv(BH, S, 1, 1, Dh, torch.float32, 0.5)
        for causal in (True, False):
            cases[f"pallas_f32_{BH}x{S}x{Dh}_{'causal' if causal else 'full'}"
                  ] = (q, k, v, {"causal": causal, "window": 0})
    for name, shape, kw in (
            ("s1000_window1_g4_dh256", (1, 1000, 4, 1, 256), {"window": 1}),
            ("s1000_window_ge_s_g1_dh128", (1, 1000, 4, 4, 128),
             {"window": 1000}),
            ("s1000_g4_dh80", (2, 1000, 8, 2, 80), {"window": 0}),
            ("s1000_full_window64_dh256", (1, 1000, 4, 1, 256),
             {"window": 64, "causal": False}),
            ("s1000_window64_first_tile_masked_g4_dh256",
             (1, 1000, 4, 1, 256), {"window": 64}),
            ("s77_window64_g4_dh256", (2, 77, 8, 2, 256), {"window": 64}),
            ("s1000_window512_g3_dh128", (1, 1000, 24, 8, 128),
             {"window": 512}),
            ("s1000_g5_dh128", (1, 1000, 40, 8, 128), {"window": 0}),
            ("s1000_window64_g3_dh256", (1, 1000, 12, 4, 256), {"window": 64}),
            ("s500_full_g8_dh64", (2, 500, 8, 1, 64),
             {"window": 0, "causal": False}),
            ("s1000_window_ge_s_g1_dh256", (1, 1000, 2, 2, 256),
             {"window": 1 << 30})):
        cases[name] = (*qkv(*shape, torch.bfloat16), kw)
    for name, shape, Sk, kw in (
            ("sq100_sk300_g4_dh256", (1, 100, 4, 1, 256), 300, {}),
            ("sq300_sk100_full_g4_dh128", (1, 300, 8, 2, 128), 100,
             {"causal": False})):
        cases[name] = (*qkv(*shape, torch.bfloat16, Sk=Sk),
                       {"window": 0} | kw)
    return cases, timed


KERNEL_CASES = {"fused_gather_overlay": fused_gather_overlay_cases,
                "gather_rows": gather_rows_cases,
                "scatter_rows": scatter_rows_cases,
                "routed_gather": routed_gather_cases,
                "routed_neighbor_sample": routed_neighbor_sample_cases,
                "sage_aggregate": sage_aggregate_cases,
                "flash_attention": flash_attention_cases}


def _split(args) -> tuple:
    """A case's positional tensors and its keyword arguments (a trailing
    dict)."""
    if args and isinstance(args[-1], dict):
        return args[:-1], args[-1]
    return args, {}


def check_and_time(torch, np, k, ctx, flush, card) -> dict:
    """Checks of one kernel against its plain version on every case —
    bitwise, or within ``TOLERANCE[name][dtype]`` (rtol + atol) for the
    kernels that sum in another order — then kernel / plain / library
    timings at each timed shape (two alternating rounds averaged), with the
    bound: bytes over the memory rate, or bf16 operations over the tensor
    cores' rate where a timed shape counts them, whichever is larger.
    Inputs must be unchanged afterwards."""
    import functools

    cases, timed = KERNEL_CASES[k.name](torch, ctx)
    tol = TOLERANCE.get(k.name)
    snapshots = {id(t): t.clone() for args in cases.values()
                 for t in _split(args)[0]}
    errs, routes = {}, {}
    for name, args in cases.items():
        a, kw = _split(args)
        before = dict(k.kernel.route_launches)
        got = k.wrapper(*a, **kw)
        routes[name] = [r for r, n in k.kernel.route_launches.items()
                        if n != before[r]]
        want = k.plain(*a, **kw)
        torch.cuda.synchronize()
        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"{k.name}: shape/type differ on {name}")
        if tol is None:
            nan = got.isnan()  # NaN where the plain version has NaN
            if not (torch.equal(nan, want.isnan()) and torch.equal(
                    got.masked_fill(nan, 0), want.masked_fill(nan, 0))):
                raise AssertionError(f"{k.name} != plain version on case "
                                     f"{name}")
        else:
            t = tol[str(got.dtype).split(".")[-1]]
            torch.testing.assert_close(got.float(), want.float(), **t,
                                       msg=lambda m: f"{k.name} "
                                       f"case {name}: {m}")
        diff = (got.float() - want.float()).abs()
        errs[name] = (float(diff.nan_to_num(0.0).max())
                      if got.numel() else 0.0)
        if tol is not None:
            print(f"[kernel] {k.name} case {name}: max |err| "
                  f"{errs[name]:.4e}, median |plain| "
                  f"{float(want.float().abs().median()):.4e}, {t}"
                  + (f", route {routes[name]}" if k.kernel.route_launches
                     else "") + f" | {card}")
    out = {"max_abs_err": max(errs.values()), "timed": {},
           "errs": errs, "routes": routes}
    for shape, args, nbytes, lib, *flops in timed:
        a, kw = _split(args)
        runs = []
        for _ in range(2):  # kernel, plain, library; twice
            r = [time_ms(torch, functools.partial(k.wrapper, **kw), a,
                         TIMED_LAUNCHES, flush),
                 time_ms(torch, functools.partial(k.plain, **kw), a,
                         TIMED_LAUNCHES, flush)]
            if lib is not None:
                r.append(time_ms(torch, lib[1], (), TIMED_LAUNCHES, flush))
            runs.append(r)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = flops[0] / BF16_FLOPS_PER_S * 1e3 if flops else 0.0
        res = {"ms": float(np.mean([r[0] for r in runs])),
               "plain_ms": float(np.mean([r[1] for r in runs])),
               "library_ms": (float(np.mean([r[2] for r in runs]))
                              if lib is not None else None),
               "library_call": lib[0] if lib is not None else None,
               "bound_ms": max(bytes_ms, ops_ms),
               "bound_by": "operations" if ops_ms > bytes_ms else "bytes",
               "bytes": int(nbytes),
               "flops": int(flops[0]) if flops else None}
        out["timed"][shape] = res
        print(f"[kernel] {k.name} @ {shape}: kernel {res['ms']:.4f} ms, "
              f"plain {res['plain_ms']:.4f} ms, library "
              f"{res['library_ms']} ms ({res['library_call']}), bound "
              f"{res['bound_ms']:.4f} ms by {res['bound_by']} "
              f"({nbytes / 1e6:.1f} MB"
              + (f", {flops[0] / 1e9:.2f} GFLOP" if flops else "")
              + f") runs {runs} | {card}")
    for args in cases.values():
        for t in _split(args)[0]:
            if not torch.equal(t, snapshots[id(t)]):
                raise AssertionError(f"{k.name} wrote one of its inputs")
    if tol is None and k.kernel.route_launches:
        print(f"[kernel] {k.name} route by case: "
              + ", ".join(f"{c} {r}" for c, r in routes.items())
              + f" | {card}")
    how = "bitwise equal" if tol is None else (
        "within " + ", ".join(f"rtol {t['rtol']} + atol {t['atol']} ({d})"
                              for d, t in tol.items()))
    print(f"[kernel] {k.name}: {how} on {sorted(errs)}; max |err| "
          f"{out['max_abs_err']:.3e}; inputs unchanged | {card}")
    return out


# ---- serving layers (phase 4b) --------------------------------------------

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


def device_rows(torch, events, w0=None, w1=None):
    """(start, end, name) of the device-side events (kernels, copies,
    memsets), clipped to [w0, w1] when given; the CPU-side ops and the
    device copies of record_function ranges are left out."""
    out = []
    for e in events:
        if e.device_type != torch.autograd.DeviceType.CUDA \
                or e.name in ("device_step", "composition", "lm_optimizer"):
            continue
        s, t = e.time_range.start, e.time_range.end
        if w0 is not None:
            s, t = max(s, w0), min(t, w1)
        if t > s:
            out.append((s, t, e.name))
    return out


def busy_and_top(rows, k: int = 8):
    """Union of the device intervals, and the top ``k`` names by time."""
    busy, cur = 0.0, None
    for s, t, _ in sorted(rows):
        if cur is None or s > cur[1]:
            if cur is not None:
                busy += cur[1] - cur[0]
            cur = [s, t]
        else:
            cur[1] = max(cur[1], t)
    if cur is not None:
        busy += cur[1] - cur[0]
    by_name = {}
    for s, t, name in rows:
        tot, cnt = by_name.get(name, (0.0, 0))
        by_name[name] = (tot + t - s, cnt + 1)
    top = sorted(((us, name, cnt) for name, (us, cnt) in by_name.items()),
                 reverse=True)[:k]
    return busy, top


def device_share(torch, np, builder, cfg, params, n: int):
    """Device busy share over ``n`` micro-batches of the production serving
    path (no host oracle) from torch.profiler, and the top device
    operations; None when the profiler saw no device time.  The wall time
    includes the profiler's own overhead."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        breakdown(torch, np, builder, cfg, params, n, oracle=False)
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = device_rows(torch, prof.events())
    if not rows:
        return None
    busy, top = busy_and_top(rows)
    return busy / wall_us, top


# ---- training (phases 6-8) -------------------------------------------------

def fresh_copy(plan, g=None):
    """A plan whose caches start from ``plan``'s residency as built (a
    refresh mutates its plan in place; every training run gets its own),
    over graph ``g`` (default: the plan's own; another feature source of
    the same graph gives the same rows)."""
    from repro_torch.core.unified_cache import CliqueCache

    caches = [CliqueCache(c.g if g is None else g, c.devices,
                          c.feat_ids_by_device(), c.topo_ids_per_dev,
                          topology_mode=c.topology_mode)
              for c in plan.caches]
    return dataclasses.replace(plan, stats=list(plan.stats),
                               cslp=list(plan.cslp),
                               cost_plans=list(plan.cost_plans),
                               caches=caches)


def zero_launches(kernels) -> None:
    for k in kernels:
        k.kernel.reset_launches()


def read_launches(kernels) -> dict:
    return {k.name: k.kernel.launches for k in kernels}


def read_routes(kernels) -> dict:
    """The launches by route of each kernel that has routes."""
    return {k.name: dict(k.kernel.route_launches) for k in kernels
            if k.kernel.route_launches}


def expect(counts: dict) -> dict:
    """A phase's expected launches: ``counts``, and 0 for every other
    kernel."""
    from repro_torch.kernels import KERNELS

    return {k.name: counts.get(k.name, 0) for k in KERNELS}


def expect_chains(phase: str, routes: dict, builds: int) -> None:
    """Every device-sampling spec build of a GNN phase runs its whole chain
    in one ``routed_neighbor_sample`` launch on the ``chain`` route; the
    per-hop route is never taken."""
    got = routes["routed_neighbor_sample"]
    if got != {"hop": 0, "chain": builds}:
        raise AssertionError(f"{phase}: routed_neighbor_sample launches by "
                             f"route {got}, expected {builds} on the chain "
                             f"route, one per spec build")


def train_breakdown(torch, np, g, plan, cfg, params, n: int):
    """Host milliseconds per layer of one device-backend training step at
    ``cfg.batch_size`` (median over ``n`` steps), driven one step at a time
    through the builder, model and optimizer calls ``train_gnn`` makes, each
    layer closed by a device synchronize (so no prefetch overlap); then one
    online refresh over the traffic those steps produced, timed the same
    way.  Returns (layer ms, refresh ms, refresh stats)."""
    from repro_torch.core.cache_manager import (OnlineCacheManager,
                                                RefreshConfig)
    from repro_torch.models.gnn import loss_fn
    from repro_torch.train.batch import DeviceBatchBuilder
    from repro_torch.train.optimizer import (adamw, apply_updates,
                                             tree_leaves, tree_map)

    bplan = fresh_copy(plan)
    mgr = OnlineCacheManager(g, bplan, RefreshConfig(drift_threshold=1.0))
    b = DeviceBatchBuilder(g, bplan.caches[0], cfg.fanouts, None, 0,
                           device="cuda", observer=mgr.observer_for(0))
    opt = adamw(cfg.lr)
    state = opt.init(params)
    rng = np.random.default_rng(0)
    tablet = bplan.partition.tablets[0]
    times = {k: [] for k in ("sample", "fill", "finalize",
                             "forward+backward", "optimizer")}
    for _ in range(n):
        t = [time.perf_counter()]
        spec = b.sample_spec(tablet[rng.integers(0, len(tablet),
                                                 cfg.batch_size)], rng)
        t.append(time.perf_counter())
        spec = b.fill_spec(spec)
        t.append(time.perf_counter())
        batch = b.finalize(spec)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        p = tree_map(lambda x: x.detach().requires_grad_(), params)
        loss, _ = loss_fn(cfg, p, batch)
        grads = iter(torch.autograd.grad(loss, tree_leaves(p)))
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        upd, state = opt.update(tree_map(lambda _: next(grads), p), state,
                                p)
        params = apply_updates(p, upd)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        for k, a, c in zip(times, t, t[1:]):
            times[k].append((c - a) * 1e3)
    t0 = time.perf_counter()
    mgr.maybe_refresh(n)
    torch.cuda.synchronize()
    refresh_ms = (time.perf_counter() - t0) * 1e3
    return ({k: float(np.median(v)) for k, v in times.items()}, refresh_ms,
            mgr.summary())


def step_window_share(torch, prof, first: int, count: int):
    """Device busy share over steps ``first .. first+count-1`` of a
    profiled ``train_gnn`` run (the loop's ``device_step`` ranges bound the
    window), and the top device operations inside it."""
    events = prof.events()
    steps = sorted((e for e in events if e.name == "device_step"
                    and e.device_type == torch.autograd.DeviceType.CPU),
                   key=lambda e: e.time_range.start)
    if len(steps) < first + count:
        return None
    w0 = steps[first].time_range.start
    w1 = steps[first + count - 1].time_range.end
    rows = device_rows(torch, events, w0, w1)
    if not rows:
        return None
    busy, top = busy_and_top(rows)
    return busy / (w1 - w0), (w1 - w0) / 1e3, top, by_category(rows)


# ---- the tiered store and telemetry (phases 10b and 10c) -------------------

def check_stream(jsonl: str, trace: str = None, steps: int = None) -> tuple:
    """A telemetry stream as ``repro_torch.obs`` promises it: every line
    valid (``load_stream``, then ``validate_stream`` on the whole), every
    integer counter's window deltas summing to its final total (the float
    ones within rounding), no dangling span,
    ``steps`` device_step spans when given, and the Chrome trace loadable
    with span tracks from at least two threads.  Returns (final snapshot,
    digest)."""
    from repro_torch.obs import sum_counter_deltas, validate_stream
    from repro_torch.obs.report import digest, load_stream

    lines = load_stream(jsonl)
    kinds = validate_stream(lines)
    snaps = [ln for ln in lines if ln["kind"] == "snapshot"]
    sums = sum_counter_deltas(snaps)
    # integer counters telescope exactly; the float ones (prefetch.*_s,
    # host seconds) up to float rounding of the differences
    bad = {k: (sums[k], c["total"]) for k, c in snaps[-1]["counters"].items()
           if (sums[k] != c["total"] if isinstance(c["total"], int)
               else abs(sums[k] - c["total"]) > 1e-9 * abs(c["total"]))}
    if bad:
        raise AssertionError(f"{jsonl}: deltas do not telescope: {bad}")
    if any(ln["kind"] == "event" and ln["name"] == "dangling_spans"
           for ln in lines):
        raise AssertionError(f"{jsonl}: dangling spans")
    n_steps = sum(1 for ln in lines if ln["kind"] == "span"
                  and ln["name"] == "device_step")
    if steps is not None and n_steps != steps:
        raise AssertionError(f"{jsonl}: {n_steps} device_step spans, "
                             f"expected {steps}")
    if trace is not None:
        with open(trace) as f:
            ev = json.load(f)["traceEvents"]
        tids = {e["tid"] for e in ev if e.get("ph") == "X"}
        if len(tids) < 2:
            raise AssertionError(f"{trace}: span tracks from {len(tids)} "
                                 "thread(s)")
    return snaps[-1], digest(lines), kinds


def store_tallies(s: dict) -> str:
    return (f"hbm {s['hbm_hits']}/{s['hbm_requests']} hits, host_ram "
            f"{s['host_hits']}/{s['host_requests']} hits, ssd fill rows "
            f"{s['ssd_fill_rows']} ({s['ssd_fills_async']} from prefetched "
            f"reads), evictions {s['evictions']} ({s['evictions_in_window']} "
            f"with a next use in the window), announced "
            f"{s['announced_batches']}, prefetched {s['prefetched_batches']}")


def profiled_span_names(torch, fn) -> set:
    """The CPU-side range names a ``torch.profiler`` run of ``fn`` records
    on every thread (the spans' record_function bridge opens them on the
    coordinator and build threads too)."""
    from torch.profiler import ProfilerActivity, profile

    cfg = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 experimental_config=cfg) as prof:
        fn()
    return {e.name for e in prof.events()}


def store_phases(torch, np, g, plan, params, card: str,
                 phase_launches: dict, phase_routes: dict, tmp: str,
                 device: str = "cuda") -> str:
    """Phases 10b (training) and 10c (serving): the tiered feature store
    and telemetry on the one-GPU plan, each phase's launches recorded in
    ``phase_launches``/``phase_routes``.  The feature table's file is
    written into the directory ``tmp`` (the caller deletes it, after phase
    10d has trained from it too); returns its path."""
    from repro_torch.configs.legion_gnn import GRAPHSAGE
    from repro_torch.core.cache_manager import RefreshConfig
    from repro_torch.core.feature_store import FeatureStore, TieredStoreConfig
    from repro_torch.core.unified_cache import TrafficCounter
    from repro_torch.kernels import KERNELS
    from repro_torch.obs import Telemetry, TelemetryConfig
    from repro_torch.serve import GNNServer, ServeConfig
    from repro_torch.train.loop import train_gnn

    # ---- 10b. the tiered store and telemetry in training --------------------
    # the feature table in a file of a temporary directory, deleted after
    # 10d; the file stays in the page cache, so the store's "ssd" reads
    # time an mmap copy here, not a disk
    fpath = os.path.join(tmp, "features.npy")
    t0 = time.perf_counter()
    g.save_feature_file(fpath)
    t_write = time.perf_counter() - t0
    g_ram = dataclasses.replace(g, features=np.load(fpath))
    g_file = dataclasses.replace(g, feature_file=fpath)
    print(f"[store] feature table {g.n} x {g.feat_dim} f32 "
          f"({os.path.getsize(fpath) / 1e6:.1f} MB) written in "
          f"{t_write:.1f}s and loaded into RAM in "
          f"{time.perf_counter() - t0 - t_write:.1f}s | {card}")
    store_kw = dict(backend="device", device=device, seed=0,
                    params=params, steps=STORE_STEPS,
                    refresh_config=RefreshConfig(interval=STORE_REFRESH,
                                                 drift_threshold=1.0))
    # (name, graph, store lookahead or None, telemetry); the ram run
    # again at the end gives the spread of the host times
    arms = (("ram", g_ram, None, False),
            ("ram+telemetry", g_ram, None, True),
            ("file+store", g_file, STORE_LOOKAHEAD, True),
            ("file+store lookahead 0", g_file, 0, False),
            ("ram again", g_ram, None, False))
    runs, walls = {}, {}
    for name, graph, la, on in arms:
        tele = None
        if on:
            stem = os.path.join(tmp, name.replace("+", "_"))
            tele = Telemetry(TelemetryConfig(
                jsonl_path=stem + ".jsonl", trace_path=stem + ".json",
                window=4, run=name))
        store = (None if la is None else FeatureStore(
            graph, TieredStoreConfig(host_rows=STORE_HOST_ROWS,
                                     lookahead=la)))
        c = TrafficCounter.for_plan(plan)
        tplan = fresh_copy(plan, graph)
        zero_launches(KERNELS)
        t0 = time.perf_counter()
        res = train_gnn(graph, tplan, GRAPHSAGE, counter=c,
                        telemetry=tele, feature_store=store, **store_kw)
        walls[name] = time.perf_counter() - t0
        phase = f"store-train {name}"
        phase_launches[phase] = read_launches(KERNELS)
        phase_routes[phase] = read_routes(KERNELS)
        admitting = sum(1 for e in res.refresh["events"]
                        if e["admitted"] > 0)
        want = expect({"fused_gather_overlay": STORE_STEPS,
                       "scatter_rows": admitting,
                       "routed_neighbor_sample": STORE_STEPS})
        if phase_launches[phase] != want or res.refresh["refreshes"] < 1:
            raise AssertionError(f"{phase}: launches "
                                 f"{phase_launches[phase]}, expected "
                                 f"{want}; refresh {res.refresh}")
        expect_chains(phase, phase_routes[phase], STORE_STEPS)
        runs[name] = (res, c, tele, store)
        del tplan
    a = runs["ram"][0]
    for name, (res, c, tele, store) in runs.items():
        if res.losses != a.losses or res.accs != a.accs:
            raise AssertionError(f"{name} losses {res.losses} != ram "
                                 f"{a.losses}")
        if c.feature_requests != runs["ram"][1].feature_requests:
            raise AssertionError(f"{name}: feature requests differ")
    # without sampling ahead every tally is the storeless run's; with
    # it the refresh at step 4 has observed the window's batches too
    # (as in the reference), so it may admit other rows
    for name in ("ram+telemetry", "file+store lookahead 0", "ram again"):
        for t in ("feature_requests", "feature_hits", "topo_requests",
                  "topo_hits", "pcie_transactions"):
            if getattr(runs[name][1], t) != getattr(runs["ram"][1], t):
                raise AssertionError(f"{name}: counter {t} differs from "
                                     "the ram run's")
    for name, (res, c, tele, store) in runs.items():
        st = np.array(res.step_times) * 1e3
        p = res.pipeline
        line = (f"[store] {name}: {STORE_STEPS} steps in "
                f"{walls[name]:.3f}s wall; step median "
                f"{np.median(st):.2f} ms (min {st.min():.2f}, max "
                f"{st.max():.2f}); host build total "
                f"{p['host_build_s_total']:.3f}s (sampled-ahead builds "
                f"included), fill total {p['fill_s_total']:.3f}s; "
                f"feature hits {c.feature_hits}/{c.feature_requests}, "
                f"topo hits {c.topo_hits}/{c.topo_requests}")
        print(line + f" | {card}")
        if store is not None:
            s = res.store
            if s["hbm_requests"] != c.feature_requests \
                    or s["hbm_hits"] != c.feature_hits \
                    or s["host_requests"] != (s["hbm_requests"]
                                              - s["hbm_hits"]):
                raise AssertionError(f"{name}: store tallies {s} vs "
                                     f"counter {c}")
            print(f"[store] {name}: {store_tallies(s)}; read_us "
                  f"{int(s['ssd_read_s'] * 1e6)} stall_us "
                  f"{int(s['stall_s'] * 1e6)} (page-cache reads) "
                  f"| {card}")
        if tele is None:
            continue
        if res.telemetry["open_spans"] != 0:
            raise AssertionError(f"{name}: open spans {res.telemetry}")
        final, dig, kinds = check_stream(tele.config.jsonl_path,
                                         tele.config.trace_path,
                                         STORE_STEPS)
        fc = final["counters"]
        if fc["traffic.feature_hits"]["total"] != c.feature_hits:
            raise AssertionError(f"{name}: stream feature hits differ")
        if store is not None:
            if not (fc["store.fill_rows{tier=ssd}"]["total"] > 0
                    and fc["store.hits{tier=host_ram}"]["total"] > 0
                    and fc["store.announced_batches"]["total"]
                    == STORE_STEPS):
                raise AssertionError(f"{name}: store counters {fc}")
        spans = dig["spans"]
        print(f"[store] {name} stream: {kinds}; spans "
              + ", ".join(f"{k} x{v['count']} {v['mean_s'] * 1e3:.2f} ms"
                          for k, v in sorted(spans.items()))
              + f"; queue dry {dig['queue_dry_s']:.3f}s | {card}")
    # with a window of 4 over 8 steps the last 4 builds sample nothing
    # (the window sampled them during the first builds), so the step
    # median flatters the lookahead run: the host build total and the
    # wall count all of its work
    for metric, v in (
            ("step median", {k: float(np.median(r[0].step_times))
                             for k, r in runs.items()}),
            ("host build total", {k: r[0].pipeline["host_build_s_total"]
                                  for k, r in runs.items()}),
            ("wall", walls)):
        print(f"[store] {metric} against ram: ram again "
              f"{v['ram again'] / v['ram']:.4f}x, telemetry "
              f"{v['ram+telemetry'] / v['ram']:.4f}x, file+store "
              f"lookahead {STORE_LOOKAHEAD} "
              f"{v['file+store'] / v['ram']:.4f}x, lookahead 0 "
              f"{v['file+store lookahead 0'] / v['ram']:.4f}x | {card}")
    names = profiled_span_names(torch, lambda: train_gnn(
        g_ram, fresh_copy(plan, g_ram), GRAPHSAGE,
        telemetry=TelemetryConfig(), **dict(store_kw, steps=2)))
    missing = {"device_step", "spec_build", "finalize"} - names
    if missing:
        raise AssertionError(f"profiled telemetry run lacks the ranges "
                             f"{missing}")
    print(f"[store] a profiled 2-step run with telemetry shows the "
          f"record_function ranges device_step, spec_build, finalize "
          f"| {card}")
    del runs, a, g_ram

    # ---- 10c. the tiered store and telemetry in serving ----------------
    jsonl = os.path.join(tmp, "serve.jsonl")
    tele = Telemetry(TelemetryConfig(jsonl_path=jsonl, run="serve"))
    store = FeatureStore(g_file, TieredStoreConfig(
        host_rows=STORE_HOST_ROWS, lookahead=0))
    srv = GNNServer(g_file, fresh_copy(plan, g_file), GRAPHSAGE, params,
                    device=device, telemetry=tele, feature_store=store,
                    config=ServeConfig(max_batch=MAX_BATCH,
                                       oracle_check=True), seed=0)
    tele.add_source("traffic", srv.counter.publish_metrics)
    tele.add_source("store", store.publish_metrics)
    req_rng = np.random.default_rng(1)
    requests = [req_rng.integers(0, g.n, int(n))
                for n in req_rng.integers(1, MAX_BATCH + 1, N_REQUESTS)]
    zero_launches(KERNELS)
    srv.warmup()
    srv.start()
    t0 = time.perf_counter()
    futs = [srv.submit(r) for r in requests]
    results = [f.result(timeout=900) for f in futs]
    wall = time.perf_counter() - t0
    srv.stop()
    store.close()
    tele.close()
    phase_launches["store-serve"] = read_launches(KERNELS)
    phase_routes["store-serve"] = read_routes(KERNELS)
    s = srv.summary()
    if phase_launches["store-serve"] != expect(
            {"fused_gather_overlay": s["batches"],
             "routed_neighbor_sample": s["batches"]}):
        raise AssertionError(f"store-serve launches "
                             f"{phase_launches['store-serve']} for "
                             f"{s['batches']} micro-batches")
    expect_chains("store-serve", phase_routes["store-serve"],
                  s["batches"])
    if s["oracle_mismatches"] or s["oracle_checks"] != s["batches"]:
        raise AssertionError(f"store-serve oracle check failed: {s}")
    for req, res in zip(requests, results):
        if res.logits.shape != (len(req), GRAPHSAGE.n_classes) \
                or not np.isfinite(res.logits).all():
            raise AssertionError(f"bad reply for request "
                                 f"{res.request_id}")
    final, dig, kinds = check_stream(jsonl)
    fc, c = final["counters"], srv.counter
    for key in ("requests", "replies", "batches", "seeds", "pad_seeds",
                "flush_full", "flush_deadline", "oracle_checks",
                "oracle_mismatches", "forward_us"):
        if fc[f"serve.{key}"]["total"] != s[key]:
            raise AssertionError(f"serve.{key} {fc[f'serve.{key}']} != "
                                 f"summary {s[key]}")
    for t in ("feature_requests", "feature_hits", "topo_requests",
              "topo_hits", "pcie_transactions"):
        if fc[f"traffic.{t}"]["total"] != getattr(c, t):
            raise AssertionError(f"traffic.{t} != the counter's")
    lat = np.array([r.latency_s for r in results]) * 1e3
    ss = store.summary()
    print(f"[store-serve] {N_REQUESTS} requests in {s['batches']} "
          f"micro-batches over the file-backed table: "
          f"{N_REQUESTS / wall:.2f} req/s, latency p50 "
          f"{np.percentile(lat, 50):.2f} ms p99 "
          f"{np.percentile(lat, 99):.2f} ms (closed burst, oracle check "
          f"on, telemetry on); oracle mismatches 0 of "
          f"{s['oracle_checks']}; stream {kinds} | {card}")
    print(f"[store-serve] {store_tallies(ss)}; read_us "
          f"{int(ss['ssd_read_s'] * 1e6)} stall_us "
          f"{int(ss['stall_s'] * 1e6)}; serve.latency_s p50 "
          f"{dig['histograms']['serve.latency_s']['p50'] * 1e3:.2f} ms "
          f"(interpolated) | {card}")
    del srv, store, g_file
    return fpath


# ---- resilience (phase 10d) -------------------------------------------------

def resilience_tallies(res) -> dict:
    """What a run's result says its faults and recoveries were, under the
    telemetry counters' names."""
    p, s, r = res.pipeline, res.store, res.resilience
    out = {"fault.worker_deaths": p["worker_deaths"],
           "recovery.worker_restarts": p["worker_restarts"],
           "recovery.remesh_events": r["remesh_events"],
           "recovery.devices_lost": r["devices_lost"],
           "recovery.remesh_us": int(r["remesh_s"] * 1e6),
           "recovery.restore_us": int(r["restore_s"] * 1e6),
           "recovery.cache_rebuilds": r["cache_rebuilds"],
           "recovery.runtime_restores": int(r["runtime_restored"])}
    if s:
        out["fault.ssd_read_errors"] = s["read_errors"]
        out["recovery.ssd_read_retries"] = s["read_retries"]
    if "checkpoint" in r:
        c = r["checkpoint"]
        out["checkpoint.saves"] = c["saves"]
        out["fault.checkpoint_write_errors"] = c["write_errors"]
        out["recovery.checkpoint_retries"] = c["retries_used"]
    if "faults" in r:
        injected = {k[len("injected_"):]: v for k, v in r["faults"].items()}
        for site, n in injected.items():
            out[f"fault.injected{{site={site}}}"] = n
        out["fault.injected_total"] = sum(injected.values())
    return out


def resilience_phases(torch, np, g, plan, splan, params, fpath: str,
                      card: str, phase_launches: dict, phase_routes: dict,
                      tmp: str, device: str = "cuda") -> None:
    """Phase 10d: kill and resume, injected faults and the device-loss
    remesh in ``train_gnn``, then ``--ckpt``/``--resume`` of both CLIs,
    each run's launches recorded in ``phase_launches``/``phase_routes``."""
    import io

    from repro_torch.configs.legion_gnn import GRAPHSAGE
    from repro_torch.core.cache_manager import RefreshConfig
    from repro_torch.core.feature_store import TieredStoreConfig
    from repro_torch.core.unified_cache import TrafficCounter
    from repro_torch.kernels import KERNELS
    from repro_torch.launch import train as tlaunch
    from repro_torch.obs import Telemetry, TelemetryConfig
    from repro_torch.obs.report import print_report
    from repro_torch.train.checkpoint import (AsyncCheckpointer,
                                              latest_checkpoint,
                                              restore_checkpoint)
    from repro_torch.train.loop import train_gnn
    from repro_torch.train.optimizer import adamw
    from repro_torch.train.resilience import (FaultPlan, FaultSpec,
                                              ResilienceConfig)

    def record(phase):
        phase_launches[phase] = read_launches(KERNELS)
        phase_routes[phase] = read_routes(KERNELS)

    def admitting(res, since: int = 0) -> int:
        return sum(1 for e in res.refresh["events"]
                   if e["admitted"] > 0 and e["step"] >= since)

    def check_launches(phase, want, chains):
        if phase_launches[phase] != expect(want):
            raise AssertionError(f"{phase}: launches {phase_launches[phase]}"
                                 f", expected {expect(want)}")
        expect_chains(phase, phase_routes[phase], chains)

    # ---- (a) kill and resume at paper width, the table only in the file --
    N, half = RESIL_STEPS, RESIL_STEPS // 2
    g_file = dataclasses.replace(g, feature_file=fpath)
    rc = RefreshConfig(interval=STORE_REFRESH, drift_threshold=1.0)
    store_cfg = TieredStoreConfig(host_rows=STORE_HOST_ROWS,
                                  lookahead=RESIL_LOOKAHEAD)
    kw = dict(backend="device", device=device, seed=0, params=params,
              refresh_config=rc, feature_store=store_cfg, prefetch_workers=1)
    ck = os.path.join(tmp, "ckpt")
    runs = {}
    for name, over in (("uninterrupted", dict(steps=N)),
                       ("killed", dict(steps=half, checkpoint_dir=ck,
                                       checkpoint_every=2)),
                       ("resumed", dict(steps=N, checkpoint_dir=ck,
                                        resume=True))):
        tplan = fresh_copy(plan, g_file)
        zero_launches(KERNELS)
        t0 = time.perf_counter()
        runs[name] = train_gnn(g_file, tplan, GRAPHSAGE, **kw, **over)
        wall = time.perf_counter() - t0
        record(f"resil-{name}")
        res = runs[name]
        print(f"[resil] {name}: {len(res.losses)} steps in {wall:.3f}s "
              f"wall, step median "
              f"{np.median(res.step_times) * 1e3:.2f} ms; refreshes "
              f"{[(e['step'], e['admitted']) for e in res.refresh['events']]}"
              f" | {card}")
        del tplan
    full, killed, resumed = (runs[k] for k in ("uninterrupted", "killed",
                                                "resumed"))
    if killed.losses + resumed.losses != full.losses:
        raise AssertionError(f"kill and resume: {killed.losses} + "
                             f"{resumed.losses} != {full.losses}")
    r = resumed.resilience
    if r["resumed_from_step"] != half or r["runtime_restored"] is not True \
            or resumed.steps != N - half:
        raise AssertionError(f"resume: {r}, steps {resumed.steps}")
    # one fused gather and one sampling chain a consumed step (one device),
    # a scatter per admitting refresh (the killed run stops before its
    # first); the restore's reapply runs before the builders upload the
    # fresh plan copy's cache, so it changes the host mirror only
    for name, steps, scatter_n in (
            ("uninterrupted", N, admitting(full)), ("killed", half, 0),
            ("resumed", N - half, admitting(resumed, since=half))):
        check_launches(f"resil-{name}",
                       {"fused_gather_overlay": steps,
                        "routed_neighbor_sample": steps,
                        "scatter_rows": scatter_n}, steps)
    # the restore as the resumed run timed it (the file's load, the
    # manager's reapply, the store's refill); then one save() of the
    # restored state, timed on the caller (a separate save, of the same
    # tree and runtime payload as the run's)
    path = latest_checkpoint(ck)
    like = (params, adamw(GRAPHSAGE.lr).init(params))  # a template only
    step, tree, rt = restore_checkpoint(path, like, with_runtime=True)
    ck2 = AsyncCheckpointer(os.path.join(tmp, "ckpt_save"))
    t0 = time.perf_counter()
    ck2.save(step, tree, runtime=rt)
    t_save = time.perf_counter() - t0
    ck2.close()
    t_write = time.perf_counter() - t0 - t_save
    with np.load(path) as data:
        rt_bytes = data["__runtime"].nbytes
    print(f"[resil] kill at step {half} and resume: losses bitwise the "
          f"uninterrupted run's over {N} steps at batch "
          f"{GRAPHSAGE.batch_size}; restore in the resumed run "
          f"{r['restore_s']:.3f}s (the file's load, the manager's reapply, "
          f"the store's refill); a save() of the restored state "
          f"{t_save * 1e3:.3f} ms on the caller (the write {t_write:.3f}s "
          f"in the background); checkpoint "
          f"{os.path.getsize(path) / 1e6:.3f} MB ({rt_bytes / 1e6:.3f} MB "
          f"of it runtime state) | {card}")
    del tree, rt, like

    # ---- (b) faults are transparent --------------------------------------
    fp = FaultPlan([FaultSpec("prefetch_build", step=3),
                    FaultSpec("checkpoint_write", at_call=0),
                    FaultSpec("ssd_read", at_call=3, times=2),
                    FaultSpec("ssd_stall", at_call=8, stall_s=0.01)])
    jsonl = os.path.join(tmp, "faults.jsonl")
    tele = Telemetry(TelemetryConfig(jsonl_path=jsonl, window=4,
                                     run="faults"))
    zero_launches(KERNELS)
    t0 = time.perf_counter()
    res = train_gnn(g_file, fresh_copy(plan, g_file), GRAPHSAGE, **kw,
                    steps=N, checkpoint_dir=os.path.join(tmp, "ckpt_faults"),
                    checkpoint_every=half, telemetry=tele,
                    resilience=ResilienceConfig(fault_plan=fp))
    wall = time.perf_counter() - t0
    record("resil-faults")
    if res.losses != full.losses:
        raise AssertionError(f"faults: losses {res.losses} != "
                             f"{full.losses}")
    r, p, s = res.resilience, res.pipeline, res.store
    want = {"injected_prefetch_build": 1, "injected_checkpoint_write": 1,
            "injected_ssd_read": 2, "injected_ssd_stall": 1}
    got = {"worker_deaths": p["worker_deaths"],
           "worker_restarts": p["worker_restarts"],
           "read_errors": s["read_errors"], "read_retries": s["read_retries"],
           "write_errors": r["checkpoint"]["write_errors"],
           "retries_used": r["checkpoint"]["retries_used"]}
    if r["faults"] != want or got != dict.fromkeys(got, 1) | {
            "read_errors": 2, "read_retries": 2}:
        raise AssertionError(f"faults: injected {r['faults']}, recovered "
                             f"{got}")
    check_launches("resil-faults",
                   {"fused_gather_overlay": N, "routed_neighbor_sample": N,
                    "scatter_rows": admitting(res)}, N)
    final, dig, _ = check_stream(jsonl, steps=N)
    tele_totals = {k: c["total"] for k, c in final["counters"].items()
                   if k.startswith(("fault.", "recovery.", "checkpoint."))}
    if tele_totals != resilience_tallies(res):
        raise AssertionError(f"telemetry {tele_totals} != the result's "
                             f"{resilience_tallies(res)}")
    out = io.StringIO()
    print_report(dig, out=out)
    line = [ln for ln in out.getvalue().splitlines()
            if ln.startswith("faults/recovery: ")]
    if len(line) != 1:
        raise AssertionError("the report prints no faults/recovery line")
    print(f"[resil] faults: {N} steps in {wall:.3f}s, losses bitwise the "
          f"uninterrupted run's; injected {r['faults']}; recovered {got}; "
          f"saves {r['checkpoint']['saves']}; store stall_us "
          f"{int(s['stall_s'] * 1e6)} | {card}")
    print(f"[resil] report: {line[0]} | {card}")

    # ---- (c) the device-loss remesh on the 2 x 2 plan ---------------------
    at, dead = RESIL_LOSS
    n_pos = sum(len(c) for c in splan.partition.cliques)
    cfg_p = dataclasses.replace(GRAPHSAGE, batch_size=PARITY_BATCH)
    tallies = ("feature_requests", "feature_hits", "topo_requests",
               "topo_hits", "pcie_transactions", "host_sample_syncs",
               "host_sampled_edges")

    def lose(backend, cfg, fault=True, steps=N):
        c = TrafficCounter.for_plan(splan)
        fp = FaultPlan([FaultSpec("device_loss", step=at, dev=dead)])
        res = train_gnn(g, fresh_copy(splan), cfg, steps=steps, counter=c,
                        backend=backend, device=device, seed=0,
                        params=params,
                        resilience=(ResilienceConfig(fault_plan=fp)
                                    if fault else None))
        return res, c

    def events(res):
        return [{k: v for k, v in e.items() if k not in ("remesh_s",
                                                          "backend")}
                for e in res.resilience["events"]]

    def old_builds(res, steps=N):
        """Batches the pipeline before the loss built: every step's batch
        through the lost one, and the ones it had run ahead by when the
        loss was seen (the new pipeline builds steps at..steps-1)."""
        return res.pipeline["batches_built"] - (steps - at)

    clean, _ = lose("device", cfg_p, fault=False)
    host, _ = lose("host", cfg_p)
    zero_launches(KERNELS)
    dev1, _ = lose("device", cfg_p)
    dev2, _ = lose("device", cfg_p)
    record("resil-remesh-parity")
    if host.losses != dev1.losses or dev1.losses != dev2.losses \
            or events(host) != events(dev1) or events(dev1) != events(dev2):
        raise AssertionError(f"remesh parity: host {host.losses} "
                             f"{events(host)}, device {dev1.losses} "
                             f"{events(dev1)}, again {dev2.losses}")
    if dev1.losses[:at] != clean.losses[:at]:
        raise AssertionError(f"steps before the loss {dev1.losses[:at]} != "
                             f"the fault-free run's {clean.losses[:at]}")
    ev = dev1.resilience["events"]
    if ev[0]["survivors"] != n_pos - 1 or dev1.backend != "device":
        raise AssertionError(f"remesh events {ev}")
    ahead = [old_builds(r) - (at + 1) for r in (host, dev1, dev2)]
    if min(ahead) < 0:
        raise AssertionError(f"remesh: old pipelines built {ahead} batches "
                             f"past the lost step")
    # per run: one fused gather a device and consumed step (4 devices before
    # the loss, 3 after) plus the discarded step's 4; one chain a spec
    # build: 4 a batch the old pipeline built (through the lost step, and
    # those it ran ahead by), 3 a batch of the new one
    fused = n_pos * at + n_pos + (n_pos - 1) * (N - at)
    chains = sum(n_pos * old_builds(r) + (n_pos - 1) * (N - at)
                 for r in (dev1, dev2))
    check_launches("resil-remesh-parity",
                   {"fused_gather_overlay": 2 * fused,
                    "routed_neighbor_sample": chains}, chains)
    # the traffic tallies count the run-ahead builds' sampling and fills,
    # so they are held where the old pipeline has built every batch: a
    # loss at the last step
    last = at + 1
    host_l, hc = lose("host", cfg_p, steps=last)
    zero_launches(KERNELS)
    dev_l, dc = lose("device", cfg_p, steps=last)
    record("resil-remesh-last")
    if host_l.losses != dev_l.losses or events(host_l) != events(dev_l) \
            or dev_l.pipeline["batches_built"] != last + 1:
        raise AssertionError(f"remesh at the last step: host "
                             f"{host_l.losses}, device {dev_l.losses}, "
                             f"built {dev_l.pipeline['batches_built']}")
    for t in tallies:
        if getattr(hc, t) != getattr(dc, t):
            raise AssertionError(f"remesh at the last step: counter {t} "
                                 f"differs")
    check_launches("resil-remesh-last",
                   {"fused_gather_overlay": n_pos * last + (n_pos - 1),
                    "routed_neighbor_sample": n_pos * last + (n_pos - 1)},
                   n_pos * last + (n_pos - 1))
    print(f"[resil] remesh at batch {PARITY_BATCH}: device {dead} lost at "
          f"step {at} of {N}; host == device == device again bitwise "
          f"(losses, events); steps 0-{at - 1} bitwise the fault-free "
          f"run's; the old pipelines had built {ahead} batches past the "
          f"lost step (host, device, device), discarded with it; lost at "
          f"the last of {last} steps, host == device bitwise in the traffic "
          f"tallies too; remesh_s host "
          f"{host.resilience['remesh_s']:.3f}, device "
          f"{dev1.resilience['remesh_s']:.3f} and "
          f"{dev2.resilience['remesh_s']:.3f} | {card}")
    del host, dev1, dev2, clean, host_l, dev_l

    clean, _ = lose("sharded", GRAPHSAGE, fault=False)
    zero_launches(KERNELS)
    t0 = time.perf_counter()
    res, _ = lose("sharded", GRAPHSAGE)
    wall = time.perf_counter() - t0
    record("resil-remesh-sharded")
    r = res.resilience
    if res.losses[:at] != clean.losses[:at] or res.backend != "device" \
            or r["remesh_events"] != 1 or r["events"][0]["survivors"] != 3 \
            or len(res.losses) != N or not np.isfinite(res.losses).all() \
            or old_builds(res) < at + 1:
        raise AssertionError(f"sharded remesh: {res.losses} vs "
                             f"{clean.losses}, backend {res.backend}, {r}, "
                             f"built {res.pipeline['batches_built']}")
    # the sharded steps before the loss: a routed gather a position and
    # step; the discarded batches (packed uploads) launch nothing; after
    # the loss the device backend on the 3 survivors
    builds = n_pos * old_builds(res) + (n_pos - 1) * (N - at)
    check_launches("resil-remesh-sharded",
                   {"routed_gather": n_pos * at,
                    "fused_gather_overlay": (n_pos - 1) * (N - at),
                    "routed_neighbor_sample": builds}, builds)
    st = np.array(res.step_times) * 1e3
    print(f"[resil] remesh at batch {GRAPHSAGE.batch_size}, sharded 2 x 2: "
          f"device {dead} lost at step {at}; steps 0-{at - 1} bitwise the "
          f"fault-free sharded run's; then the device backend on "
          f"{r['events'][0]['survivors']} survivors; the old pipeline had "
          f"built {old_builds(res) - at - 1} batches past the lost step; "
          f"remesh_s {r['remesh_s']:.3f} (closing the old pipeline, the "
          f"replan at {g.n} vertices, a fresh pipeline); step median "
          f"before {np.median(st[:at]):.2f} ms, after "
          f"{np.median(st[at:]):.2f} ms; {N} steps in {wall:.3f}s "
          f"wall | {card}")
    del res, clean

    # ---- (d) the CLIs: --ckpt, then --resume, on the card ----------------
    first, total = RESIL_CLI_STEPS
    for name, argv in (
            ("lm", ["--arch", LM_ARCH, "--smoke"]),
            ("gnn", ["--gnn", "sage", "--max-vertices",
                     str(RESIL_CLI_VERTICES)])):
        d = os.path.join(tmp, f"cli_{name}")
        argv = argv + ["--device", device]
        zero_launches(KERNELS)
        out = [tlaunch.main(argv + ["--steps", str(total)]),
               tlaunch.main(argv + ["--steps", str(first), "--ckpt", d]),
               tlaunch.main(argv + ["--steps", str(total), "--ckpt", d,
                                    "--resume"])]
        record(f"resil-cli-{name}")
        full_l, a, b = (o if isinstance(o, list) else o.losses for o in out)
        if a + b != full_l or len(full_l) != total:
            raise AssertionError(f"{name} CLI: {a} + {b} != {full_l}")
        if name == "lm":
            from repro_torch.configs import get_config

            L = get_config(LM_ARCH, smoke=True).n_layers
            want = {"flash_attention": 2 * total * L,
                    "flash_attention_bwd": 2 * total * L}
        else:
            want = {}  # the CLI trains on the host backend: no kernel
        if phase_launches[f"resil-cli-{name}"] != expect(want):
            raise AssertionError(f"{name} CLI launches "
                                 f"{phase_launches[f'resil-cli-{name}']}, "
                                 f"expected {expect(want)}")
        print(f"[resil] {name} CLI on {device}: --ckpt for {first} steps, "
              f"--resume to {total}: losses {a} + {b} bitwise the "
              f"{total}-step run's | {card}")


# ---- the sharded executor (phases 4, 9 and 10) ------------------------------

def sharded_specs(np, g, plan, cfg, seed: int):
    """One synchronized step's specs on ``plan``'s cliques, built through
    ``ShardedBatchBuilder`` as ``train_gnn`` builds them (per device
    ``cfg.batch_size / n_devices`` seeds of its tablet), and the builders."""
    from repro_torch.train.batch import ShardedBatchBuilder

    n_dev = sum(len(c) for c in plan.partition.cliques)
    per_dev = cfg.batch_size // n_dev
    rng = np.random.default_rng(seed)
    groups, builders = [], {}
    for clique in plan.partition.cliques:
        gr = []
        for d in clique:
            b = ShardedBatchBuilder(g, plan.cache_for_device(d),
                                    cfg.fanouts, None, d, device="cuda")
            tab = plan.partition.tablets[d]
            gr.append(b.build_spec(tab[rng.integers(0, len(tab), per_dev)],
                                   rng))
            builders[d] = b
        groups.append(gr)
    return groups, builders


def upload_packed(torch, np, plan, groups, feat_dim: int):
    """pack_sharded_specs -> (the hierarchical shard stack, the packed
    arrays on the card, host bytes of miss_rows)."""
    from repro_torch.core.unified_cache import stack_hierarchical_shards
    from repro_torch.train.batch import pack_sharded_specs

    packed = pack_sharded_specs(groups, feat_dim)
    epochs = [int(e) for e in packed.pop("cache_epochs")]
    stack = stack_hierarchical_shards(plan.caches, epochs)
    miss_bytes = packed["miss_rows"].nbytes
    return stack, {k: torch.from_numpy(v).cuda()
                   for k, v in packed.items()}, miss_bytes


def chain_context(torch, np, cache, seeds, fanouts, seed: int) -> dict:
    """Inputs of one sampling chain on ``cache`` (sharded topology mode):
    the seeds and the sampler's draws (numpy, as ``cache_sample_dispatch``
    draws them: int64 in [0, 2^31)), the chain kernel's arguments on the
    card, and each hop's arguments of the per-hop kernel on the same draws
    (the routing glue of ``device_sample_cached``, hop 1's frontier sampled
    with the plain version)."""
    from repro_torch.kernels import ref

    da = cache.device_arrays()
    rng = np.random.default_rng(seed)
    seeds = np.asarray(seeds, dtype=np.int64)
    rands, n = [], len(seeds)
    for f in fanouts:
        rands.append(rng.integers(0, 1 << 31, size=(n, f)))
        n *= f
    ip, ix = da["topo_shard_indptr"], da["topo_shard_indices"]
    routing = (ip, ix, da["topo_owner"], da["topo_local"])
    chain = (*routing, torch.from_numpy(seeds).cuda(),
             [torch.from_numpy(r).cuda() for r in rands])
    hops, frontier = [], chain[4]
    for r in chain[5]:
        safe = frontier.clamp_min(0)
        owner = torch.where(frontier >= 0, da["topo_owner"][safe], -1)
        local = da["topo_local"][safe].to(torch.int32)
        hops.append((ip, ix, owner.contiguous(), local.contiguous(), r))
        frontier = ref.routed_neighbor_sample_dense(*hops[-1]).reshape(-1) \
            .to(torch.int64)
    return {"cache": cache, "seeds": seeds, "rands": rands,
            "fanouts": tuple(fanouts), "chain": chain, "hops": hops}


def shard_context(torch, np, g, plan, cfg, card) -> dict:
    """Kernel inputs taken from a real sharded step at paper width: clique
    0's shard stack and position (0, 0)'s routing for ``routed_gather``;
    clique 0's CSR shards, position (0, 0)'s 2000 seeds and the sampler's
    draws (2000 x 25, then 50,000 x 10) for ``routed_neighbor_sample``: the
    chain, and its hop 0 and hop 1 on the per-hop kernel."""
    groups, _ = sharded_specs(np, g, plan, cfg, seed=5)
    stack, packed, _ = upload_packed(torch, np, plan, groups, g.feat_dim)
    sample = chain_context(torch, np, plan.caches[0],
                           groups[0][0].levels[0], cfg.fanouts, seed=6)
    hop0, hop1 = (h[2:] for h in sample["hops"])
    ctx = {"shards": stack[0], "owner": packed["owner"][0, 0],
           "local": packed["local"][0, 0], "indptr": sample["chain"][0],
           "indices": sample["chain"][1], "hop0": hop0, "hop1": hop1,
           "sample": sample}
    s = groups[0][0]
    n = s.n_ids
    peer = int((s.owner[:n] >= 0).sum() - (s.owner[:n] == 0).sum())
    print(f"[kernel] sharded step, position (0, 0): n_pad="
          f"{ctx['owner'].numel()} stack={tuple(stack.shape)} unique={n} "
          f"local hits={int((s.owner[:n] == 0).sum())} peer hits={peer} "
          f"misses={s.n_miss}; hop 0 {tuple(hop0[2].shape)}, hop 1 "
          f"{tuple(hop1[2].shape)} | {card}")
    return ctx


def sum_loss(torch, cfg, params, batch):
    """One mesh position's summed cross-entropy, as the sharded step
    computes it."""
    from repro_torch.models.gnn import forward

    logits = forward(cfg, params, batch).to(torch.float32)
    labels = batch["labels"].to(torch.int64)
    ll = torch.gather(logits, -1, labels[:, None])[:, 0]
    return (torch.logsumexp(logits, dim=-1) - ll).sum()


def shard_breakdown(torch, np, g, plan, cfg, params, n: int):
    """Host milliseconds per layer of one sharded step at ``cfg.batch_size``
    (median over ``n`` steps), through the calls ``train_gnn`` makes, one
    step and one mesh position after the other (the pipeline runs the four
    positions' sample and fill on four threads), each layer closed by a
    device synchronize.  Returns (layer ms, host bytes of miss_rows)."""
    from repro_torch.core.unified_cache import stack_hierarchical_shards
    from repro_torch.launch.mesh import make_hierarchical_mesh
    from repro_torch.train.batch import (ShardedBatchBuilder,
                                         pack_sharded_specs)
    from repro_torch.train.loop import sharded_position_batch
    from repro_torch.train.optimizer import (adamw, apply_updates,
                                             tree_leaves, tree_map)

    bplan = fresh_copy(plan)
    cliques = bplan.partition.cliques
    devs = [d for c in cliques for d in c]
    builders = {d: ShardedBatchBuilder(g, bplan.cache_for_device(d),
                                       cfg.fanouts, None, d, device="cuda")
                for d in devs}
    rngs = {d: np.random.default_rng(d) for d in devs}
    per_dev = cfg.batch_size // len(devs)
    mesh = make_hierarchical_mesh(cliques)
    opt = adamw(cfg.lr)
    state = opt.init(params)
    names = ("sample", "fill", "pack", "upload", "routed gather+overlay+"
             "positioning", "forward+backward", "grad sum+optimizer")
    times = {k: [] for k in names}
    miss_bytes = 0
    for _ in range(n):
        t = [time.perf_counter()]
        specs = {}
        for d in devs:
            tab = bplan.partition.tablets[d]
            specs[d] = builders[d].sample_spec(
                tab[rngs[d].integers(0, len(tab), per_dev)], rngs[d])
        t.append(time.perf_counter())
        for d in devs:
            specs[d] = builders[d].fill_spec(specs[d])
        t.append(time.perf_counter())
        packed = pack_sharded_specs([[specs[d] for d in c] for c in cliques],
                                    g.feat_dim)
        for d in devs:
            builders[d].release_spec(specs[d])
        miss_bytes = packed["miss_rows"].nbytes
        t.append(time.perf_counter())
        stack = stack_hierarchical_shards(
            bplan.caches, [int(e) for e in packed.pop("cache_epochs")])
        pt = {k: torch.from_numpy(v).cuda() for k, v in packed.items()}
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        batches = [sharded_position_batch(stack[ci], pt, ci, gi, g.feat_dim)
                   for ci, gi in mesh.positions()]
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        p = tree_map(lambda x: x.detach().requires_grad_(), params)
        leaves = tree_leaves(p)
        grads = [torch.autograd.grad(sum_loss(torch, cfg, p, b), leaves)
                 for b in batches]
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        total = [sum(gs) / (per_dev * len(devs)) for gs in zip(*grads)]
        it = iter(total)
        upd, state = opt.update(tree_map(lambda _: next(it), p), state, p)
        params = apply_updates(p, upd)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        for k, a, c in zip(times, t, t[1:]):
            times[k].append((c - a) * 1e3)
    return {k: float(np.median(v)) for k, v in times.items()}, miss_bytes


# ---- the LM serving path (phases 11-13) -------------------------------------

def capture_attention(torch, transformer, cfg, params, prompts, layers):
    """q, k, v and the call's keywords of ``layers``' flash-attention calls
    in one real prefill (``transformer.flash_attention`` wrapped for the
    call)."""
    captured, calls = {}, []
    inner = transformer.flash_attention

    def capture(q, k, v, **kw):
        if len(calls) in layers:
            captured[len(calls)] = (q.clone(), k.clone(), v.clone(), kw)
        calls.append(kw)
        return inner(q, k, v, **kw)

    transformer.flash_attention = capture
    try:
        with torch.inference_mode():
            transformer.prefill(cfg, params, torch.from_numpy(prompts).cuda())
    finally:
        transformer.flash_attention = inner
    if len(calls) != cfg.n_layers or sorted(captured) != list(layers):
        raise AssertionError(f"prefill made {len(calls)} attention calls")
    return captured


def log_softmax_gap(torch, a, b, vocab: int, chunk: int = 100):
    """Per position, max |log_softmax(a) - log_softmax(b)| over the real
    vocabulary in f32 (batch 1), and whether every entry is within
    rtol = atol = 5e-2 of b's (the reference's decode-consistency check)."""
    gaps, ok = [], True
    for s in range(0, a.shape[1], chunk):
        pa = torch.log_softmax(a[:, s:s + chunk, :vocab].float(), -1)
        pb = torch.log_softmax(b[:, s:s + chunk, :vocab].float(), -1)
        d = (pa - pb).abs()
        ok = ok and bool((d <= 5e-2 + 5e-2 * pb.abs()).all())
        gaps.append(d.amax(dim=-1)[0])
    return torch.cat(gaps).cpu().numpy(), ok


def teacher_forced(torch, transformer, cfg, params, prompts, tokens):
    """The logits ``generate`` gives when its decode steps are fed
    ``tokens`` (B, new) instead of its own argmaxes."""
    P, V = prompts.shape[1], cfg.vocab_size
    with torch.inference_mode():
        logits, cache = transformer.prefill(cfg, params, prompts,
                                            max_len=P + tokens.shape[1])
        outs = [logits[:, -1:, :V]]
        for i in range(tokens.shape[1] - 1):
            logits, cache = transformer.decode_step(
                cfg, params, cache, tokens[:, i:i + 1], P + i)
            outs.append(logits[:, :, :V])
    return torch.cat(outs, dim=1)


def timed_decode_steps(torch, transformer, run):
    """``run()`` with a CUDA event recorded after each ``decode_step`` it
    makes; returns its result and the ms between consecutive steps' ends on
    the card's clock (the decode loop's period, argmax included)."""
    inner, events = transformer.decode_step, []

    def step(*a, **kw):
        out = inner(*a, **kw)
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()
        return out

    transformer.decode_step = step
    try:
        res = run()
    finally:
        transformer.decode_step = inner
    torch.cuda.synchronize()
    return res, [a.elapsed_time(b) for a, b in zip(events, events[1:])]


def by_category(rows) -> dict:
    """Device ms by kind of operation: the flash kernels (forward, and the
    backward's three launches), matrix products (cuBLAS), copies and casts,
    and the rest (elementwise, reductions)."""
    out = {"flash_attention": 0.0, "flash_attention_bwd": 0.0, "matmul": 0.0,
           "copy/cast": 0.0, "other": 0.0}
    for s, t, name in rows:
        n = name.lower()
        if "flash_fwd" in n:
            key = "flash_attention"
        elif "flash_bwd" in n:
            key = "flash_attention_bwd"
        elif any(w in n for w in ("gemm", "gemv", "nvjet", "xmma", "cutlass")):
            key = "matmul"
        elif "copy" in n or "memcpy" in n or "memset" in n:
            key = "copy/cast"
        else:
            key = "other"
        out[key] += (t - s) / 1e3
    return out


def route_rule_agrees(torch, fa) -> None:
    """The CUDA sources' route rules (``flash_attention_route`` and
    ``flash_attention_bwd_route``, which pick the kernel a call launches)
    against ``flash_route`` and ``flash_bwd_route`` (which the wrappers
    count the launch under and, for the backward, pass to the kernel), for
    both types and every head dim the wrappers take."""
    import ctypes

    from repro_torch.kernels.flash_attention import (BWD_KERNEL, MAX_HEAD_DIM,
                                                     flash_bwd_route,
                                                     flash_route)

    c_route = ctypes.CDLL(str(fa.kernel.library_path())).flash_attention_route
    c_route.argtypes = [ctypes.c_int, ctypes.c_int]
    c_route.restype = ctypes.c_int
    c_bwd = BWD_KERNEL.fn("flash_attention_bwd_route")
    names = {0: "simt", 1: "mma_sync", 2: "wgmma"}
    bwd_names = {-1: None, 0: "wgmma", 1: "mma_sync"}
    for dtype, code in ((torch.float32, 0), (torch.bfloat16, 1)):
        for dh in range(16, MAX_HEAD_DIM + 1, 16):
            if names[c_route(code, dh)] != flash_route(dtype, dh):
                raise AssertionError(f"route of ({dtype}, {dh}): CUDA "
                                     f"{names[c_route(code, dh)]}, Python "
                                     f"{flash_route(dtype, dh)}")
            if bwd_names[c_bwd(code, dh)] != flash_bwd_route(dtype, dh):
                raise AssertionError(f"backward route of ({dtype}, {dh}): "
                                     f"CUDA {bwd_names[c_bwd(code, dh)]}, "
                                     f"Python {flash_bwd_route(dtype, dh)}")


def flash_refuses_autograd(torch, fa, card) -> None:
    """There is no f32 backward on the card: an f32 call autograd would
    differentiate (grad mode on, q, k or v requiring grad) must raise
    without a launch, and the same inputs under ``torch.no_grad()`` run; a
    bf16 call under autograd runs and gives each input its gradient through
    the backward kernel (one forward and one backward launch)."""
    from repro_torch.kernels.flash_attention import BWD_KERNEL, flash_attention

    gen = torch.Generator(device="cuda").manual_seed(11)
    q, k, v = (torch.randn((1, 64, 4, 256), generator=gen, device="cuda")
               for _ in range(3))
    k, v = k[:, :, :1].contiguous(), v[:, :, :1].contiguous()
    before = fa.kernel.launches
    for name in ("q", "k", "v"):
        args = {"q": q, "k": k, "v": v}
        args[name] = args[name].clone().requires_grad_()
        try:
            flash_attention(**args)
        except RuntimeError as e:
            msg = str(e)
        else:
            raise AssertionError(f"flash_attention on CUDA gave an f32 output"
                                 f" with {name} requiring grad")
        with torch.no_grad():
            flash_attention(**args)
    torch.cuda.synchronize()
    if fa.kernel.launches != before + 3:
        raise AssertionError("flash_attention launched under autograd in f32")
    bf = [t.bfloat16().requires_grad_() for t in (q, k, v)]
    launches = (fa.kernel.launches, BWD_KERNEL.launches)
    flash_attention(*bf).float().square().sum().backward()
    torch.cuda.synchronize()
    if (fa.kernel.launches, BWD_KERNEL.launches) != (launches[0] + 1,
                                                     launches[1] + 1) \
            or any(t.grad is None or not bool(torch.isfinite(t.grad).all())
                   for t in bf):
        raise AssertionError("bf16 flash_attention under autograd did not "
                             "give finite gradients through the kernels")
    print(f"[lm] flash_attention on CUDA refuses autograd in f32 for q, k and"
          f" v (RuntimeError: {msg[:60]}...), runs under no_grad; bf16 under"
          f" autograd gives q, k and v gradients through the backward kernel"
          f" | {card}")


# ---- the attention backward and LM training (phases 11b, 14, 15) -----------

def capture_backward(torch, fa, transformer, cfg, params, batch, layers):
    """q, k, v, o, lse, do and the call's keywords of ``layers``' backward
    calls in one real training step (``flash_attention_bwd`` wrapped for
    the step; the backward visits the layers last to first)."""
    from repro_torch.train.optimizer import tree_map

    captured, calls = {}, []
    inner = fa.flash_attention_bwd

    def capture(*args, **kw):
        layer = cfg.n_layers - 1 - len(calls)
        if layer in layers:
            captured[layer] = (*(t.clone() for t in args), kw)
        calls.append(kw)
        return inner(*args, **kw)

    fa.flash_attention_bwd = capture
    try:
        leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
        loss, _ = transformer.loss_fn(cfg, leaves, batch)
        loss.backward()
        del leaves, loss
    finally:
        fa.flash_attention_bwd = inner
    if len(calls) != cfg.n_layers or sorted(captured) != list(layers):
        raise AssertionError(f"a training step made {len(calls)} attention "
                             f"backward calls")
    return captured


def exact_grads(torch, q, k, v, do, causal: bool, window: int):
    """The f64 gradient of attention over q * the bf16-rounded scale (the
    product not rounded), k and v at output gradient ``do``, one batch row
    at a time (the f64 scores of a 4096-token row are 537 MB a head
    group)."""
    Dh, G = q.shape[-1], q.shape[2] // k.shape[2]
    scale = float(torch.tensor(Dh ** -0.5, dtype=q.dtype))
    i = torch.arange(q.shape[1], device=q.device)[:, None]
    j = torch.arange(k.shape[1], device=q.device)[None, :]
    seen = torch.ones((q.shape[1], k.shape[1]), dtype=torch.bool,
                      device=q.device)
    if causal:
        seen &= j <= i
    if window > 0:
        seen &= i - j < window
    out = [[], [], []]
    for b in range(q.shape[0]):
        qd, kd, vd = (t[b:b + 1].double().requires_grad_() for t in (q, k, v))
        s = torch.einsum("bqhd,bkhd->bhqk", qd * scale,
                         kd.repeat_interleave(G, 2))
        o = torch.einsum("bhqk,bkhd->bqhd",
                         s.masked_fill(~seen, float("-inf")).softmax(-1),
                         vd.repeat_interleave(G, 2))
        for acc, g in zip(out, torch.autograd.grad(o, (qd, kd, vd),
                                                   do[b:b + 1].double())):
            acc.append(g)
        del s, o
    return [torch.cat(g) for g in out]


def bwd_cases(torch, fa, captured, seed: int = 12):
    """The backward's cases: the training step's layer 0 (local) and layer
    5 (global) calls as captured, and edge cases with o and lse from the
    forward kernel: Dh 16, 64, 80, 128 and 256, windows 64, 512 and none,
    G = 1, 2, 3, 4 and 5 (3 and 5 leave rows of the wgmma route's 64-row
    tiles, and of the forward's 128-row tiles, empty), causal and not,
    ragged Sq (77, 130, 333, 1000), Sq != Sk."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    cases = {}
    for layer, (q, k, v, o, lse, do, kw) in sorted(captured.items()):
        kind = "global" if kw["window"] >= q.shape[1] else "local"
        cases[f"train_l{layer}_{kind}"] = (q, k, v, o, lse, do, kw)
    for name, (B, Sq, Hq, Hkv, Dh), Sk, kw in (
            ("s77_full_window64_g4_dh16", (1, 77, 4, 1, 16), None,
             {"window": 64, "causal": False}),
            ("s200_g4_dh64", (1, 200, 8, 2, 64), None, {"window": 0}),
            ("s130_g2_dh80", (2, 130, 4, 2, 80), None, {"window": 0}),
            ("s300_window64_g1_dh128", (1, 300, 2, 2, 128), None,
             {"window": 64}),
            ("s1000_window64_g4_dh256", (1, 1000, 4, 1, 256), None,
             {"window": 64}),
            ("sq100_sk300_g4_dh256", (1, 100, 4, 1, 256), 300,
             {"window": 0}),
            ("sq300_sk100_full_g4_dh128", (1, 300, 8, 2, 128), 100,
             {"window": 0, "causal": False}),
            ("s1000_window512_g3_dh128", (1, 1000, 6, 2, 128), None,
             {"window": 512}),
            ("s333_window64_g5_dh256", (1, 333, 5, 1, 256), None,
             {"window": 64}),
            ("s333_full_g5_dh64", (1, 333, 10, 2, 64), None,
             {"window": 0, "causal": False})):
        Sk = Sq if Sk is None else Sk
        q, k, v, do = (torch.randn(shape, generator=gen, device="cuda")
                       .bfloat16() for shape in
                       ((B, Sq, Hq, Dh), (B, Sk, Hkv, Dh), (B, Sk, Hkv, Dh),
                        (B, Sq, Hq, Dh)))
        kw = {"causal": True} | kw
        o, lse = fa._forward_cuda(q, k, v, kw["causal"], kw["window"], True)
        cases[name] = (q, k, v, o, lse, do, kw)
    return cases


def check_backward(torch, fa, k, cases, card) -> dict:
    """The backward kernel on every case, on the route ``flash_bwd_route``
    gives it and, where that is ``wgmma``, on ``mma_sync`` too (forced
    through the route rule): against the f64 exact gradient beside the
    plain version (``BWD_F64_FLOOR``), twice (bitwise equal), one launch
    counted per call under the route taken.  The kernel is fed the forward
    kernel's o and lse, as in training; those are first held to the plain
    forward's (``TOLERANCE``, ``BWD_LSE_TOL``), and the plain backward
    that sets the limit reads the plain forward's, so a wrong lse fails
    rather than raise the limit."""
    from repro_torch.kernels import ref

    errs, rel, routes = {}, {}, {}
    for name, (q, kk, v, o, lse, do, kw) in cases.items():
        ro, rlse = ref.flash_attention(q, kk, v, return_lse=True, **kw)
        for what, got, want, tol in (
                ("o", o, ro, TOLERANCE["flash_attention"]["bfloat16"]),
                ("lse", lse, rlse, BWD_LSE_TOL)):
            torch.testing.assert_close(
                got.float(), want.float(), **tol,
                msg=lambda m: f"flash_attention_bwd case {name}: the forward "
                f"kernel's {what} against the plain forward's: {m}")
        lse_err = float((lse - rlse).abs().max())
        plain = ref.flash_attention_bwd(q, kk, v, ro, rlse, do, **kw)
        del ro, rlse
        exact = exact_grads(torch, q, kk, v, do, kw.get("causal", True),
                            kw["window"])
        native = fa.flash_bwd_route(q.dtype, q.shape[3])
        routes[name] = [native] + (["mma_sync"] if native == "wgmma" else [])
        errs[name] = 0.0
        for route in routes[name]:
            before = dict(k.kernel.route_launches)
            with forced_route(fa, "flash_bwd_route", route):
                got = fa.flash_attention_bwd(q, kk, v, o, lse, do, **kw)
                again = fa.flash_attention_bwd(q, kk, v, o, lse, do, **kw)
            torch.cuda.synchronize()
            counted = {r: n - before[r]
                       for r, n in k.kernel.route_launches.items()}
            if counted != {r: 2 * (r == route) for r in counted}:
                raise AssertionError(f"flash_attention_bwd counted {counted} "
                                     f"for 2 calls on {route}")
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"flash_attention_bwd is not "
                                     f"deterministic on case {name}, {route}")
            parts = []
            for n, g, p, e in zip(("dq", "dk", "dv"), got, plain, exact):
                den = float(e.abs().max())
                ek = float((g.double() - e).abs().max()) / den
                ep = float((p.double() - e).abs().max()) / den
                if not (g.dtype == torch.bfloat16 and g.shape == p.shape
                        and ek <= 2 * ep + BWD_F64_FLOOR):
                    raise AssertionError(
                        f"flash_attention_bwd case {name} {route} {n}: "
                        f"kernel {ek:.3e}, plain {ep:.3e} of max |g| "
                        f"{den:.3e} from the f64 gradient")
                rel[f"{name}/{route}/{n}"] = (ek, ep)
                parts.append(f"{n} {ek:.3e} (plain {ep:.3e}, max |g| "
                             f"{den:.3e})")
            errs[name] = max([errs[name]] + [
                float((g.float() - p.float()).abs().max())
                for g, p in zip(got, plain)])
            print(f"[lm-bwd] case {name} on {route}: q {tuple(q.shape)} k "
                  f"{tuple(kk.shape)} {kw}: max |err| / max |g| against f64:"
                  f" " + ", ".join(parts) + f"; two calls bitwise equal; the "
                  f"forward kernel's lse within {lse_err:.3e} of the plain "
                  f"forward's | {card}")
            del got, again
        del plain, exact
    return {"max_abs_err": max(errs.values()), "errs": errs, "rel": rel,
            "routes": routes, "timed": {}}


def time_backward(torch, np, fa, k, cases, flush, card) -> dict:
    """At the two captured training shapes: the backward kernel on its
    ``wgmma`` route and on ``mma_sync`` (forced through the route rule) in
    turns (wgmma, mma_sync, then mma_sync, wgmma), its plain version and
    SDPA's backward (k and v expanded to the query heads, is_causal or the
    explicit window mask; (forward + backward) - forward), beside the bound
    (5 products of 2 Dh flops per visible pair and query head at the bf16
    rate, or the bytes of q, k, v, o, do, lse in and dq, dk, dv out, the
    larger, whatever either route computes); and the forward kernel with
    and without lse, in turns.  The mma_sync times go in as
    ``<shape>_mma_sync``."""
    import functools

    import torch.nn.functional as F
    from repro_torch.kernels import ref

    out = {}
    for name, (q, kk, v, o, lse, do, kw) in cases.items():
        if not name.startswith("train_"):
            continue
        B, S, Hq, Dh = q.shape
        G = Hq // kk.shape[2]
        flops = 10 * Dh * B * Hq * causal_pairs(S, kw["window"])
        # q, o, do in and dq out; k, v in and dk, dv out; lse in
        nbytes = 4 * (q.numel() + kk.numel()) * q.element_size() \
            + lse.numel() * 4
        mask = None
        if kw["window"] < S:
            i = torch.arange(S, device="cuda")
            mask = (i[:, None] >= i[None, :]) & (i[:, None] - i[None, :]
                                                 < kw["window"])
        qt = q.transpose(1, 2).contiguous().requires_grad_()
        kt, vt = (t.repeat_interleave(G, 2).transpose(1, 2).contiguous()
                  .requires_grad_() for t in (kk, v))
        dot = do.transpose(1, 2).contiguous()

        def sdpa():
            return F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, is_causal=mask is None)

        def sdpa_fwd_bwd():
            torch.autograd.grad(sdpa(), (qt, kt, vt), dot)

        a = (q, kk, v, o, lse, do)

        def on(route):
            def run(*args):
                with forced_route(fa, "flash_bwd_route", route):
                    return fa.flash_attention_bwd(*args, **kw)
            return time_ms(torch, run, a, TIMED_LAUNCHES, flush)

        runs = []
        for turn in (("wgmma", "mma_sync"), ("mma_sync", "wgmma")):
            t = dict((r, on(r)) for r in turn)
            runs.append([
                t["wgmma"], t["mma_sync"],
                time_ms(torch, functools.partial(ref.flash_attention_bwd,
                                                 **kw), a, BWD_TIMED_PLAIN,
                        flush),
                time_ms(torch, sdpa_fwd_bwd, (), TIMED_LAUNCHES, flush)
                - time_ms(torch, sdpa, (), TIMED_LAUNCHES, flush),
                time_ms(torch, fa._forward_cuda, (q, kk, v, True,
                                                  kw["window"], True),
                        TIMED_LAUNCHES, flush),
                time_ms(torch, fa._forward_cuda, (q, kk, v, True,
                                                  kw["window"], False),
                        TIMED_LAUNCHES, flush)])
        m = np.mean(runs, axis=0)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = flops / BF16_FLOPS_PER_S * 1e3
        call = ("F.scaled_dot_product_attention backward, k/v expanded to "
                + ("the query heads, explicit window mask" if mask is not None
                   else "the query heads, is_causal")
                + ", (forward + backward) - forward")
        res = {"ms": float(m[0]), "route": "wgmma",
               "plain_ms": float(m[2]),
               "library_ms": float(m[3]), "library_call": call,
               "bound_ms": max(bytes_ms, ops_ms),
               "bound_by": "operations" if ops_ms > bytes_ms else "bytes",
               "bytes": int(nbytes), "flops": int(flops),
               "forward_lse_ms": float(m[4]),
               "forward_no_lse_ms": float(m[5])}
        out[name] = res
        out[f"{name}_mma_sync"] = res | {"ms": float(m[1]),
                                         "route": "mma_sync"}
        print(f"[lm-bwd] {name} @ q {tuple(q.shape)}: backward kernel, in "
              f"turns, wgmma {res['ms']:.4f} ms, mma_sync {m[1]:.4f} ms; "
              f"plain {res['plain_ms']:.4f} ms, SDPA backward "
              f"{res['library_ms']:.4f} ms ({call}), bound "
              f"{res['bound_ms']:.4f} ms by {res['bound_by']} "
              f"({flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB); forward "
              f"kernel with lse {res['forward_lse_ms']:.4f} ms, without "
              f"{res['forward_no_lse_ms']:.4f} ms; runs (wgmma, mma_sync, "
              f"plain, SDPA, fwd lse, fwd) {runs} | {card}")
        del qt, kt, vt, dot, mask
    return out


def lse_under_recompute(torch, fa, cases, card) -> None:
    """The forward kernel, run again on a captured call's q, k, v (as remat
    runs it again in the backward), gives the same o and lse bits as the
    call the training step saved."""
    for name, (q, k, v, o, lse, do, kw) in cases.items():
        if not name.startswith("train_"):
            continue
        for _ in range(2):
            o2, lse2 = fa._forward_cuda(q, k, v, kw.get("causal", True),
                                        kw["window"], True)
            if not (torch.equal(o2, o) and torch.equal(lse2, lse)):
                raise AssertionError(f"forward recompute differs from the "
                                     f"saved o / lse on {name}")
    print(f"[lm-bwd] forward recomputed twice on the captured calls: o and "
          f"lse bitwise equal to the saved ones | {card}")


def lm_train(torch, np, fa, transformer, cfg, params, batch: int, seq: int,
             steps: int, device, lr: float = LM_TRAIN_LR, marks=None,
             split_optimizer: bool = False):
    """``steps`` of ``launch.train.train_step`` from ``params`` on numpy
    batches (seed 0): per step the loss, the host wall time (synchronized)
    and, with ``marks``, CUDA events at the step's start, after the loss
    (the forward), where AdamW starts (after the backward) and at its end,
    and the flash kernels' launches by route after the forward and at the
    end.  ``split_optimizer`` synchronizes before AdamW and opens the
    profiler range ``lm_optimizer`` there, so that every device operation
    after its start is the optimizer's.  Returns (losses, wall seconds,
    final params)."""
    from repro_torch.launch.train import make_batch, train_step
    from repro_torch.train.optimizer import AdamW, adamw

    opt = adamw(lr)
    state = opt.init(params)
    inner_loss, step_marks = transformer.loss_fn, {}

    def routes():
        return (dict(fa.KERNEL.route_launches),
                dict(fa.BWD_KERNEL.route_launches))

    def event():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def loss_fn(*a, **kw):
        out = inner_loss(*a, **kw)
        if marks is not None:
            step_marks["fwd"], step_marks["fwd_routes"] = event(), routes()
        return out

    def update(*a, **kw):
        if marks is not None:
            step_marks["opt"] = event()
        if split_optimizer:
            torch.cuda.synchronize()
            with torch.profiler.record_function("lm_optimizer"):
                return opt.update(*a, **kw)
        return opt.update(*a, **kw)

    timed = AdamW(opt.init, update)
    transformer.loss_fn = loss_fn
    losses, walls = [], []
    try:
        for step in range(steps):
            b = make_batch(cfg, batch, seq, 0, step, device)
            if marks is not None:
                step_marks = {"start": event(), "start_routes": routes()}
            t0 = time.perf_counter()
            params, state, loss = train_step(cfg, params, timed, state, b)
            if marks is not None:
                step_marks["end"], step_marks["end_routes"] = event(), routes()
                marks.append(step_marks)
            losses.append(float(loss))  # synchronizes
            walls.append(time.perf_counter() - t0)
    finally:
        transformer.loss_fn = inner_loss
    return losses, walls, params


def profile_train_step(torch, np, fa, transformer, cfg, params, batch: int,
                       seq: int):
    """One step of ``lm_train`` under ``torch.profiler`` with a synchronize
    before AdamW: (host wall us, device rows, device ms by kind with the
    optimizer's apart), or None where the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        lm_train(torch, np, fa, transformer, cfg, params, batch, seq, 1,
                 "cuda", split_optimizer=True)
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.events()
    rows = device_rows(torch, events)
    opt_at = [e.time_range.start for e in events if e.name == "lm_optimizer"
              and e.device_type == torch.autograd.DeviceType.CPU]
    if not rows or len(opt_at) != 1:
        return None
    cats = by_category([r for r in rows if r[0] < opt_at[0]])
    cats["optimizer"] = sum(t - s for s, t, _ in rows if s >= opt_at[0]) / 1e3
    return wall_us, rows, cats


def gap_summary(gap, window: int) -> str:
    return (f"max {gap.max():.4e} (positions < {window}: "
            f"{gap[:window].max():.4e}, >= {window}: {gap[window:].max():.4e})"
            f", mean {gap.mean():.4e}")


def main() -> int:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a GPU",
              file=sys.stderr)
        return 2
    from repro_torch.configs.legion_gnn import GRAPHSAGE
    from repro_torch.core.cache_manager import RefreshConfig
    from repro_torch.core.cliques import topology_matrix
    from repro_torch.core.planner import build_plan
    from repro_torch.graph.csr import synthetic_instance
    from repro_torch.core.unified_cache import TrafficCounter
    from repro_torch.kernels import KERNELS, scatter
    from repro_torch.models.gnn import defs as gnn_defs
    from repro_torch.models.params import init_from_defs
    from repro_torch.serve import GNNServer, ServeConfig
    from repro_torch.train.batch import DeviceBatchBuilder
    from repro_torch.train.loop import sharded_position_batch, train_gnn
    from repro_torch.configs import get_config
    from repro_torch.launch.serve_lm import generate
    from repro_torch.kernels import flash_attention as fam
    from repro_torch.kernels import ref as kref
    from repro_torch.launch.train import make_batch
    from repro_torch.models import layers as lm_layers
    from repro_torch.models import transformer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = smi()
    kind = torch.cuda.get_device_name(0)
    print(f"[device] {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {kind} x {torch.cuda.device_count()}")

    # ---- 2. build: one nvcc per source, all started together --------------
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(KERNELS)) as pool:
        for f in [pool.submit(k.kernel.fn) for k in KERNELS]:
            f.result()
    print(f"[build] {len(KERNELS)} kernels in {time.perf_counter() - t0:.2f}s"
          f" | {card}")
    for k in KERNELS:
        print(f"[build] {k.name}: nvcc {k.kernel.build_s:.2f}s | {card}")
        for fn, lines in ptxas_functions(k.kernel.build_log):
            print(f"[build] {k.name}: {fn}: {'; '.join(lines)}")
            spills = [ln for ln in lines if any(
                int(n) for n in re.findall(r"(\d+) bytes spill", ln))]
            if fn.startswith(SPILL_FREE) and spills:
                raise AssertionError(f"{fn} spills registers: {spills}")
        for line in k.kernel.build_log.splitlines():
            if "warning" in line.lower():
                print(f"[build] {k.name}: {line.strip()}")

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
    t0 = time.perf_counter()
    splan = build_plan(g, topology_matrix(*SHARD_TOPOLOGY),
                       mem_per_device=SHARD_MEM_PER_DEVICE,
                       fanouts=GRAPHSAGE.fanouts, batch_size=1024, seed=0)
    cliques = splan.partition.cliques
    print(f"[plan] {SHARD_TOPOLOGY[0]} x {SHARD_TOPOLOGY[1]}: cliques "
          f"{cliques}, per clique feat rows "
          f"{[len(c.feat_ids) for c in splan.caches]} topo rows "
          f"{[len(c.topo_ids) for c in splan.caches]} alpha "
          f"{[round(cp['alpha'], 2) for cp in splan.cost_plans]} "
          f"({time.perf_counter() - t0:.1f}s host)")
    if [len(c) for c in cliques] != [2, 2]:
        raise AssertionError(f"expected a 2 x 2 hierarchy, got {cliques}")

    # ---- 4. kernels vs plain versions, at the paths' real shapes -----------
    slots, cap = 1, 1
    for f in GRAPHSAGE.fanouts:
        slots *= f
        cap += slots
    builder = DeviceBatchBuilder(g, cache, GRAPHSAGE.fanouts, None, 0,
                                 device="cuda", bucket=MAX_BATCH * cap)
    table = cache.device_arrays()["feat_cache"]

    def spec_maps(b, seeds, rng):
        spec = b.fill_spec(b.sample_spec(seeds, rng))
        n = spec.n_ids
        maps = {"idx": torch.from_numpy(spec.cache_pos.astype(np.int32))
                .cuda(),
                "inv": torch.from_numpy(spec.miss_inv).cuda(),
                "miss": spec.miss_feats.cuda(),
                "unfused_idx": torch.from_numpy(np.where(
                    spec.hit[:n], spec.cache_pos[:n], -1).astype(np.int32))
                .cuda()}
        b.release_spec(spec)
        print(f"[kernel] {len(seeds)}-seed batch: B={maps['idx'].numel()} "
              f"table={tuple(table.shape)} miss={tuple(maps['miss'].shape)} "
              f"unique={spec.n_ids} hits={int(spec.hit.sum())} "
              f"misses={spec.n_miss}")
        return maps

    rng = np.random.default_rng(0)
    tablet = plan.partition.tablets[0]
    ctx = {"table": table,
           "serve": spec_maps(builder, rng.integers(0, g.n, MAX_BATCH), rng),
           "train": spec_maps(
               DeviceBatchBuilder(g, cache, GRAPHSAGE.fanouts, None, 0,
                                  device="cuda"),
               tablet[rng.integers(0, len(tablet), GRAPHSAGE.batch_size)],
               rng),
           "csr_col": cache.device_arrays()["cache_indices"][:, None]
           .contiguous(),
           "shard": shard_context(torch, np, g, splan, GRAPHSAGE, card)}
    train_seeds = tablet[rng.integers(0, len(tablet), GRAPHSAGE.batch_size)]
    chains = {"position": ctx["shard"]["sample"],
              "train": chain_context(torch, np, cache, train_seeds,
                                     GRAPHSAGE.fanouts, seed=9)}
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    measured = {k.name: check_and_time(torch, np, k, ctx, flush, card)
                for k in KERNELS
                if k.name not in ("flash_attention", "flash_attention_bwd")}
    sk = next(k for k in KERNELS if k.name == "routed_neighbor_sample")
    check_and_time_chain(torch, np, sk, measured[sk.name], chains, flush,
                         card)
    sage = next(k for k in KERNELS if k.name == "sage_aggregate")
    sage_routes_side_by_side(torch, np, sage, measured[sage.name], flush,
                             card)
    del ctx, chains

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
        for us, name, count in share[1]:
            print(f"[layers]   {us / 1e3:9.3f} ms  x{count:<5d} {name[:70]} "
                  f"| {card}")

    # ---- 5. serve ----------------------------------------------------------
    phase_launches = {}
    phase_routes = {}  # each phase's launches by route (read_routes)
    srv = GNNServer(g, plan, GRAPHSAGE, params, device="cuda",
                    config=ServeConfig(max_batch=MAX_BATCH,
                                       oracle_check=True), seed=0)
    req_rng = np.random.default_rng(1)
    requests = [req_rng.integers(0, g.n, int(n))
                for n in req_rng.integers(1, MAX_BATCH + 1, N_REQUESTS)]
    zero_launches(KERNELS)
    srv.warmup()
    srv.start()
    t0 = time.perf_counter()
    futs = [srv.submit(r) for r in requests]
    results = [f.result(timeout=900) for f in futs]
    wall = time.perf_counter() - t0
    srv.stop()
    phase_launches["serve"] = read_launches(KERNELS)
    phase_routes["serve"] = read_routes(KERNELS)
    s = srv.summary()
    if phase_launches["serve"] != expect({"fused_gather_overlay": s["batches"],
                                   "gather_rows": 0, "scatter_rows": 0,
                                   "routed_gather": 0,
                                   "routed_neighbor_sample": s["batches"]}):
        raise AssertionError(f"serve launches {phase_launches['serve']} for "
                             f"{s['batches']} micro-batches")
    expect_chains("serve", phase_routes["serve"], s["batches"])
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
    del srv, builder

    # ---- 6. train at paper width with online refresh ------------------------
    train_kw = dict(backend="device", device="cuda", seed=0,
                    refresh_config=RefreshConfig(interval=5,
                                                 drift_threshold=1.0))
    before = train_gnn(g, fresh_copy(plan), GRAPHSAGE, steps=5, **train_kw)
    if before.refresh["refreshes"]:
        raise AssertionError("a 5-step run must not reach the first refresh")
    tplan = fresh_copy(plan)
    zero_launches(KERNELS)
    t0 = time.perf_counter()
    res = train_gnn(g, tplan, GRAPHSAGE, steps=TRAIN_STEPS, **train_kw)
    wall = time.perf_counter() - t0
    phase_launches["train"] = read_launches(KERNELS)
    phase_routes["train"] = read_routes(KERNELS)
    if len(res.losses) != TRAIN_STEPS or not np.isfinite(res.losses).all():
        raise AssertionError(f"training losses: {res.losses}")
    ref = res.refresh
    admitting = sum(1 for e in ref["events"] if e["admitted"] > 0)
    if ref["refreshes"] < 1 or ref["admitted"] <= 0:
        raise AssertionError(f"no refresh admitted rows: {ref}")
    want = expect({"fused_gather_overlay": TRAIN_STEPS, "gather_rows": 0,
            "scatter_rows": admitting, "routed_gather": 0,
            "routed_neighbor_sample": TRAIN_STEPS})
    if phase_launches["train"] != want:
        raise AssertionError(f"train launches {phase_launches['train']}, "
                             f"expected {want}")
    expect_chains("train", phase_routes["train"], TRAIN_STEPS)
    st = np.array(res.step_times)
    print(f"[train] GraphSAGE-256 batch {GRAPHSAGE.batch_size} fanouts "
          f"{GRAPHSAGE.fanouts}: {TRAIN_STEPS} steps in {wall:.3f}s; step "
          f"median {np.median(st) * 1e3:.2f} ms (min {st.min() * 1e3:.2f}, "
          f"max {st.max() * 1e3:.2f}), {TRAIN_STEPS / st.sum():.3f} steps/s "
          f"over the loop | {card}")
    print(f"[train] losses {[round(x, 5) for x in res.losses]} | {card}")
    cb, ca = before.counter, res.counter

    def after(kind):
        """Hit rate of steps 5..19: the 20-step run's tallies minus those
        of the 5-step run, whose batches are the same first five."""
        hits = getattr(ca, f"{kind}_hits") - getattr(cb, f"{kind}_hits")
        reqs = (getattr(ca, f"{kind}_requests")
                - getattr(cb, f"{kind}_requests"))
        return hits / max(reqs, 1)

    print(f"[train] hit rates before the first refresh (steps 0-4): "
          f"feature {cb.feature_hit_rate:.4f} topo {cb.topo_hit_rate:.4f}; "
          f"after it (steps 5-{TRAIN_STEPS - 1}): feature "
          f"{after('feature'):.4f} topo {after('topo'):.4f} | {card}")
    for e in ref["events"]:
        print(f"[train] refresh at step {e['step']}: overlap "
              f"{e['overlap']:.6f} admitted {e['admitted']} evicted "
              f"{e['evicted']} topo_rebuilt {e['topo_rebuilt']} | {card}")
    p = res.pipeline
    print(f"[train] host build mean {p['host_build_s_mean'] * 1e3:.2f} ms, "
          f"fill total {p['fill_s_total']:.3f}s over {TRAIN_STEPS} steps, "
          f"queue dry {p['queue_dry_s_total']:.3f}s; staging pool "
          f"{p['staging_buffers']} pinned buffers, "
          f"{p['staging_bytes'] / 1e6:.1f} MB, allocated in "
          f"{p['staging_alloc_s']:.3f}s | {card}")
    first = next(e for e in ref["events"] if e["admitted"] > 0)
    t_table = tplan.caches[0].device_arrays()["feat_cache"]
    gen = torch.Generator(device="cuda").manual_seed(3)
    a_idx = torch.randperm(t_table.shape[0], generator=gen, device="cuda")[
        :first["admitted"]].to(torch.int32)
    a_rows = torch.randn((first["admitted"], t_table.shape[1]),
                         generator=gen, device="cuda")
    scatter_ms = time_ms(torch, scatter.scatter_rows,
                         (t_table, a_idx, a_rows), TIMED_LAUNCHES, flush)
    print(f"[train] scatter per refresh ({first['admitted']} admitted rows "
          f"into {tuple(t_table.shape)}): {scatter_ms:.4f} ms | {card}")
    del tplan, t_table, a_rows
    layers, refresh_ms, rstats = train_breakdown(torch, np, g, plan,
                                                 GRAPHSAGE, params, 5)
    print("[train-layers] median ms per step, one step at a time: "
          + ", ".join(f"{k} {v:.3f}" for k, v in layers.items())
          + f" (total {sum(layers.values()):.3f}); refresh {refresh_ms:.3f}"
          f" ms (admitted {rstats['admitted']}, evicted "
          f"{rstats['evicted']}, topo rebuilds {rstats['topo_rebuilds']})"
          f" | {card}")

    pplan = fresh_copy(plan)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        train_gnn(g, pplan, GRAPHSAGE, steps=PROFILE_STEPS, **train_kw)
    share = step_window_share(torch, prof, *PROFILE_WINDOW)
    if share is None:
        print("[train] device busy share: not measured (torch.profiler saw "
              "no device time in the window)")
    else:
        print(f"[train] device busy share {share[0]:.4f} over steps "
              f"{PROFILE_WINDOW[0]}-{sum(PROFILE_WINDOW) - 1} "
              f"({share[1]:.1f} ms, profiler on; idle {1 - share[0]:.4f}) "
              f"| {card}")
        for us, name, count in share[2]:
            print(f"[train]   {us / 1e3:9.3f} ms  x{count:<5d} {name[:70]} "
                  f"| {card}")
    del prof, pplan

    # ---- 7. parity: host and device backends across refreshes --------------
    cfg_p = dataclasses.replace(GRAPHSAGE, batch_size=PARITY_BATCH)
    par_kw = dict(device="cuda", seed=0, params=params,
                  refresh_config=RefreshConfig(interval=4,
                                               drift_threshold=1.0))
    host = train_gnn(g, fresh_copy(plan), cfg_p, steps=PARITY_STEPS,
                     backend="host", **par_kw)
    zero_launches(KERNELS)
    dev_run = train_gnn(g, fresh_copy(plan), cfg_p, steps=PARITY_STEPS,
                        backend="device", **par_kw)
    phase_launches["parity"] = read_launches(KERNELS)
    phase_routes["parity"] = read_routes(KERNELS)
    if host.losses != dev_run.losses or host.accs != dev_run.accs:
        raise AssertionError(f"host/device losses differ: {host.losses} vs "
                             f"{dev_run.losses}")
    if host.refresh != dev_run.refresh or dev_run.refresh["refreshes"] < 1:
        raise AssertionError(f"refresh summaries differ or no refresh: "
                             f"{host.refresh} vs {dev_run.refresh}")
    for name in ("feature_requests", "feature_hits", "topo_requests",
                 "topo_hits", "pcie_transactions"):
        if getattr(host.counter, name) != getattr(dev_run.counter, name):
            raise AssertionError(f"counter {name} differs")
    admitting = sum(1 for e in dev_run.refresh["events"]
                    if e["admitted"] > 0)
    want = expect({"fused_gather_overlay": PARITY_STEPS, "gather_rows": 0,
            "scatter_rows": admitting, "routed_gather": 0,
            "routed_neighbor_sample": PARITY_STEPS})
    if phase_launches["parity"] != want:
        raise AssertionError(f"parity launches {phase_launches['parity']}, "
                             f"expected {want}")
    expect_chains("parity", phase_routes["parity"], PARITY_STEPS)
    print(f"[parity] host == device bitwise over {PARITY_STEPS} steps at "
          f"batch {PARITY_BATCH}: losses {dev_run.losses}; "
          f"{dev_run.refresh['refreshes']} refreshes, admitted "
          f"{dev_run.refresh['admitted']}, hit tallies equal | {card}")

    # ---- 8. the unfused finalize -------------------------------------------
    zero_launches(KERNELS)
    unfused = train_gnn(g, fresh_copy(plan), cfg_p, steps=UNFUSED_STEPS,
                        backend="device", fused=False, **par_kw)
    phase_launches["unfused"] = read_launches(KERNELS)
    phase_routes["unfused"] = read_routes(KERNELS)
    if unfused.losses != dev_run.losses[:UNFUSED_STEPS]:
        raise AssertionError(f"unfused losses {unfused.losses} != fused "
                             f"{dev_run.losses[:UNFUSED_STEPS]}")
    want = expect({"fused_gather_overlay": 0, "gather_rows": UNFUSED_STEPS,
            "scatter_rows": 0, "routed_gather": 0,
            "routed_neighbor_sample": UNFUSED_STEPS})
    if phase_launches["unfused"] != want:
        raise AssertionError(f"unfused launches {phase_launches['unfused']}")
    expect_chains("unfused", phase_routes["unfused"], UNFUSED_STEPS)
    print(f"[unfused] fused=False == fused over {UNFUSED_STEPS} steps, "
          f"gather_rows launched {UNFUSED_STEPS} times | {card}")

    # ---- 9. the sharded clique executor on the 2 x 2 hierarchy ---------------
    n_pos = sum(len(c) for c in cliques)
    shard_kw = dict(backend="sharded", device="cuda", seed=0, params=params,
                    refresh_config=RefreshConfig(interval=SHARD_REFRESH,
                                                 drift_threshold=1.0))
    rplan = fresh_copy(splan)
    sc = TrafficCounter.for_plan(rplan)
    zero_launches(KERNELS)
    t0 = time.perf_counter()
    res = train_gnn(g, rplan, GRAPHSAGE, steps=SHARD_STEPS, counter=sc,
                    **shard_kw)
    wall = time.perf_counter() - t0
    phase_launches["shard"] = read_launches(KERNELS)
    phase_routes["shard"] = read_routes(KERNELS)
    if len(res.losses) != SHARD_STEPS or not np.isfinite(res.losses).all():
        raise AssertionError(f"sharded losses: {res.losses}")
    ref = res.refresh
    admitting = sum(1 for e in ref["events"] if e["admitted"] > 0)
    if {e["clique"] for e in ref["events"]} != {0, 1} or ref["admitted"] <= 0:
        raise AssertionError(f"both cliques must refresh: {ref}")
    want = expect({"fused_gather_overlay": 0, "gather_rows": 0,
            "scatter_rows": admitting, "routed_gather": n_pos * SHARD_STEPS,
            "routed_neighbor_sample": n_pos * SHARD_STEPS})
    if phase_launches["shard"] != want:
        raise AssertionError(f"shard launches {phase_launches['shard']}, "
                             f"expected {want}")
    expect_chains("shard", phase_routes["shard"], n_pos * SHARD_STEPS)
    cross = (sc.cross_clique_bytes(cliques), sc.cross_clique_topo_bytes(cliques))
    split = sc.per_clique_split(cliques)
    if cross != (0, 0) or not all(x["peer_bytes"] > 0 for x in split):
        raise AssertionError(f"cross-clique bytes {cross}, split {split}")
    st = np.array(res.step_times)
    print(f"[shard] GraphSAGE-256 batch {GRAPHSAGE.batch_size} on "
          f"{len(cliques)} x {len(cliques[0])} (pod, clique) positions, "
          f"{GRAPHSAGE.batch_size // n_pos} seeds each: {SHARD_STEPS} steps "
          f"in {wall:.3f}s; step median {np.median(st) * 1e3:.2f} ms (min "
          f"{st.min() * 1e3:.2f}, max {st.max() * 1e3:.2f}), "
          f"{SHARD_STEPS / st.sum():.3f} steps/s over the loop | {card}")
    print(f"[shard] losses {[round(x, 5) for x in res.losses]} | {card}")
    print(f"[shard] feature hit rate {sc.feature_hit_rate:.4f} topo hit rate "
          f"{sc.topo_hit_rate:.4f}; host sample syncs "
          f"{sc.host_sample_syncs}, host-sampled edges "
          f"{sc.host_sampled_edges} | {card}")
    for e in ref["events"]:
        print(f"[shard] refresh at step {e['step']} clique {e['clique']}: "
              f"overlap {e['overlap']:.6f} admitted {e['admitted']} evicted "
              f"{e['evicted']} topo_rebuilt {e['topo_rebuilt']} | {card}")
    print(f"[shard] cache epochs {[c.epoch for c in rplan.caches]}; launches "
          f"{phase_launches['shard']} | {card}")
    print(f"[shard] cross-clique bytes: features {cross[0]}, topology "
          f"{cross[1]}; per clique (local, peer, host-fill) bytes "
          f"{[(x['local_bytes'], x['peer_bytes'], x['host_fill_bytes']) for x in split]}"
          f" | {card}")
    p = res.pipeline
    print(f"[shard] host build mean {p['host_build_s_mean'] * 1e3:.2f} ms, "
          f"pack mean {p['host_pack_s_mean'] * 1e3:.2f} ms, fill total "
          f"{p['fill_s_total']:.3f}s (4 positions), queue dry "
          f"{p['queue_dry_s_total']:.3f}s | {card}")
    del rplan
    layers, miss_bytes = shard_breakdown(torch, np, g, splan, GRAPHSAGE,
                                         params, SHARD_LAYER_STEPS)
    print("[shard-layers] median ms per step, one position after the other: "
          + ", ".join(f"{k} {v:.3f}" for k, v in layers.items())
          + f" (total {sum(layers.values()):.3f}); miss_rows "
          f"{miss_bytes / 1e6:.1f} MB host -> device per step | {card}")
    pplan = fresh_copy(splan)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        train_gnn(g, pplan, GRAPHSAGE, steps=PROFILE_STEPS, **shard_kw)
    share = step_window_share(torch, prof, *PROFILE_WINDOW)
    if share is None:
        print("[shard-layers] device busy share: not measured (torch.profiler"
              " saw no device time in the window)")
    else:
        print(f"[shard-layers] device busy share {share[0]:.4f} over steps "
              f"{PROFILE_WINDOW[0]}-{sum(PROFILE_WINDOW) - 1} "
              f"({share[1]:.1f} ms, profiler on; idle {1 - share[0]:.4f}) "
              f"| {card}")
        for us, name, count in share[2]:
            print(f"[shard-layers]   {us / 1e3:9.3f} ms  x{count:<5d} "
                  f"{name[:70]} | {card}")
    del prof, pplan

    # ---- 10. sharded parity against the device backend ----------------------
    groups, builders = sharded_specs(np, g, splan, cfg_p, seed=8)
    stack, packed, _ = upload_packed(torch, np, splan, groups, g.feat_dim)
    for ci, clique in enumerate(cliques):
        for gi, d in enumerate(clique):
            got = sharded_position_batch(stack[ci], packed, ci, gi,
                                         g.feat_dim)
            want = builders[d].finalize(groups[ci][gi])
            if set(got) != set(want) or not all(
                    torch.equal(got[k], want[k]) for k in want):
                raise AssertionError(f"position ({ci}, {gi}) batch != the "
                                     "device backend's finalize")
    del stack, packed, builders, groups
    sp_kw = dict(device="cuda", seed=0, params=params,
                 refresh_config=RefreshConfig(interval=4,
                                              drift_threshold=1.0))
    dc = TrafficCounter.for_plan(splan)
    dev_run = train_gnn(g, fresh_copy(splan), cfg_p, steps=SHARD_PARITY_STEPS,
                        backend="device", counter=dc, **sp_kw)
    zero_launches(KERNELS)
    runs = []
    for _ in range(2):
        c = TrafficCounter.for_plan(splan)
        runs.append((train_gnn(g, fresh_copy(splan), cfg_p,
                               steps=SHARD_PARITY_STEPS, backend="sharded",
                               counter=c, **sp_kw), c))
    phase_launches["shard-parity"] = read_launches(KERNELS)
    phase_routes["shard-parity"] = read_routes(KERNELS)
    (s1, c1), (s2, _) = runs
    if s1.losses != s2.losses or s1.accs != s2.accs:
        raise AssertionError(f"sharded reruns differ: {s1.losses} vs "
                             f"{s2.losses}")
    dl = float(np.abs(np.subtract(s1.losses, dev_run.losses)).max())
    da = float(np.abs(np.subtract(s1.accs, dev_run.accs)).max())
    if dl > 1e-4 or da > 1e-6:
        raise AssertionError(f"sharded vs device: loss diff {dl}, acc diff "
                             f"{da}")
    for name in ("feature_requests", "feature_hits", "topo_requests",
                 "topo_hits", "pcie_transactions", "host_sample_syncs",
                 "host_sampled_edges"):
        if getattr(c1, name) != getattr(dc, name):
            raise AssertionError(f"counter {name} differs")
    if not (np.array_equal(c1.bytes_matrix, dc.bytes_matrix)
            and np.array_equal(c1.topo_bytes_matrix, dc.topo_bytes_matrix)):
        raise AssertionError("traffic matrices differ")
    if s1.refresh != dev_run.refresh or s1.refresh["refreshes"] < 1:
        raise AssertionError(f"refreshes differ or none: {s1.refresh} vs "
                             f"{dev_run.refresh}")
    admitting = sum(1 for e in s1.refresh["events"] if e["admitted"] > 0)
    want = expect({"fused_gather_overlay": 0, "gather_rows": 0,
            "scatter_rows": 2 * admitting,
            "routed_gather": 2 * n_pos * SHARD_PARITY_STEPS,
            "routed_neighbor_sample": 2 * n_pos * SHARD_PARITY_STEPS})
    if phase_launches["shard-parity"] != want:
        raise AssertionError(f"shard-parity launches "
                             f"{phase_launches['shard-parity']}, expected "
                             f"{want}")
    expect_chains("shard-parity", phase_routes["shard-parity"],
                  2 * n_pos * SHARD_PARITY_STEPS)
    print(f"[shard-parity] batch {PARITY_BATCH}, {SHARD_PARITY_STEPS} steps: "
          f"sharded vs device max |loss diff| {dl:.3e} (atol 1e-4), max "
          f"|acc diff| {da:.3e} (atol 1e-6); two sharded runs bitwise equal; "
          f"traffic tallies and byte matrices identical; "
          f"{s1.refresh['refreshes']} refreshes, admitted "
          f"{s1.refresh['admitted']}; per-position batches bitwise equal to "
          f"the fused finalize | {card}")
    print(f"[shard-parity] sharded losses {s1.losses} | {card}")

    # ---- 10b, 10c and 10d. the tiered store, telemetry, resilience --------
    tmp = tempfile.mkdtemp(prefix="chip_smoke_store_")
    try:
        fpath = store_phases(torch, np, g, plan, params, card, phase_launches,
                             phase_routes, tmp)
        resilience_phases(torch, np, g, plan, splan, params, fpath, card,
                          phase_launches, phase_routes, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del plan, splan, g

    # ---- 11. LM: gemma3-1b at full width, its attention kernel -------------
    lm = get_config(LM_ARCH)
    V = lm.vocab_size
    t0 = time.perf_counter()
    lm_params = init_from_defs(transformer.defs(lm),
                               torch.Generator().manual_seed(0), "cuda")
    leaves = [lm_params["embed"], lm_params["final_norm"],
              *lm_params["layers"].values()]
    print(f"[lm] {lm.name}: {lm.n_layers} layers, d_model {lm.d_model}, "
          f"{lm.n_heads} q heads over {lm.n_kv_heads} kv head, head dim "
          f"{lm.resolved_head_dim}, vocab {V}, windows "
          f"{sorted(set(transformer.layer_flags(lm)[0]))}; "
          f"{sum(t.numel() for t in leaves) / 1e9:.4f} B f32 parameters "
          f"from seed 0 in {time.perf_counter() - t0:.1f}s | {card}")
    prompts = np.random.default_rng(1).integers(0, V, (LM_BATCH, LM_PROMPT))
    fa = next(k for k in KERNELS if k.name == "flash_attention")
    captured = capture_attention(torch, transformer, lm, lm_params, prompts,
                                 LM_CAPTURE)
    measured[fa.name] = check_and_time(torch, np, fa, {"lm": captured}, flush,
                                       card)
    route_rule_agrees(torch, fa)
    flash_refuses_autograd(torch, fa, card)
    prefill_routes = {c: r for c, r in measured[fa.name]["routes"].items()
                      if c.startswith("prefill_")}
    if len(prefill_routes) != 2 or any(r != ["wgmma"]
                                       for r in prefill_routes.values()):
        raise AssertionError(f"prefill cases' routes {prefill_routes}, "
                             f"expected wgmma")
    del captured

    # ---- 11b. LM kernel: the attention backward at a training step's shapes
    bwd = next(k for k in KERNELS if k.name == "flash_attention_bwd")
    tcfg = dataclasses.replace(lm, remat=True, loss_chunk=LM_TRAIN_CHUNK)
    t0 = time.perf_counter()
    grads_in = capture_backward(
        torch, fam, transformer, tcfg, lm_params,
        make_batch(tcfg, LM_BATCH, LM_PROMPT, 0, 0, "cuda"), LM_CAPTURE)
    print(f"[lm-bwd] captured layers {sorted(grads_in)}' backward calls of "
          f"one training step ({LM_BATCH} x {LM_PROMPT}, remat, loss chunk "
          f"{LM_TRAIN_CHUNK}) in {time.perf_counter() - t0:.1f}s | {card}")
    bcases = bwd_cases(torch, fam, grads_in)
    del grads_in
    lse_under_recompute(torch, fam, bcases, card)
    measured[bwd.name] = check_backward(torch, fam, bwd, bcases, card)
    train_routes = {c: r[0] for c, r in measured[bwd.name]["routes"].items()
                    if c.startswith("train_")}
    if len(train_routes) != 2 or set(train_routes.values()) != {"wgmma"}:
        raise AssertionError(f"captured backward calls' routes "
                             f"{train_routes}, expected wgmma")
    measured[bwd.name]["timed"] = time_backward(torch, np, fam, bwd, bcases,
                                                flush, card)
    del bcases, flush

    # ---- 12. LM serve: prefill 4 x 4096, 32 greedy tokens ------------------
    zero_launches(KERNELS)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen, step = timed_decode_steps(
        torch, transformer,
        lambda: generate(lm, lm_params, prompts, LM_NEW, device="cuda"))
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    phase_launches["lm-serve"] = read_launches(KERNELS)
    phase_routes["lm-serve"] = read_routes(KERNELS)
    fa_routes = phase_routes["lm-serve"][fa.name]
    want = expect({"flash_attention": lm.n_layers})
    if phase_launches["lm-serve"] != want or fa_routes != {
            "wgmma": lm.n_layers, "mma_sync": 0, "simt": 0}:
        raise AssertionError(f"lm-serve launches {phase_launches['lm-serve']}"
                             f" by route {fa_routes}, expected "
                             f"{want}, all on the wgmma route")
    toks = gen.tokens.cpu().numpy()
    if toks.shape != (LM_BATCH, LM_NEW) or toks.min() < 0 or toks.max() >= V \
            or gen.logits.shape != (LM_BATCH, LM_NEW, V) \
            or not bool(torch.isfinite(gen.logits).all()):
        raise AssertionError(f"bad generation: tokens {toks.shape}, logits "
                             f"{tuple(gen.logits.shape)}")
    step = np.array(step)
    print(f"[lm-serve] {lm.name} batch {LM_BATCH} x prompt {LM_PROMPT}, "
          f"{LM_NEW} greedy tokens: prefill {gen.prefill_s * 1e3:.3f} ms "
          f"({LM_BATCH * LM_PROMPT / gen.prefill_s:.0f} prompt tokens/s), "
          f"decode median {np.median(step):.3f} ms/step between steps' ends "
          f"on CUDA events (min {step.min():.3f}, max {step.max():.3f}, "
          f"{len(step)} intervals), decode loop {gen.decode_s * 1e3:.3f} ms "
          f"host wall, {LM_BATCH * (LM_NEW - 1) / gen.decode_s:.1f} tokens/s "
          f"decoding, {LM_BATCH * LM_NEW / wall:.1f} tokens/s end to end "
          f"(wall {wall:.3f}s); peak device memory {peak / 2**30:.3f} GiB; "
          f"flash_attention launches {phase_launches['lm-serve'][fa.name]} "
          f"= {lm.n_layers} layers x 1 prefill, by route "
          f"{fa_routes} | {card}")
    print(f"[lm-serve] tokens of sequence 0: {toks[0].tolist()} | {card}")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        pre = generate(lm, lm_params, prompts, 1, device="cuda")
    rows = device_rows(torch, prof.events())
    if not rows:
        print("[lm-serve] prefill device time: not measured (torch.profiler "
              "saw no device time)")
    else:
        busy, top = busy_and_top(rows, k=10)
        cats = ", ".join(f"{k} {v:.3f}" for k, v in by_category(rows).items())
        print(f"[lm-serve] profiled prefill: device busy {busy / 1e3:.3f} ms "
              f"of {pre.prefill_s * 1e3:.3f} ms host wall (profiler on); "
              f"device ms by kind: {cats}; by operation: | {card}")
        for us, name, count in top:
            print(f"[lm-serve]   {us / 1e3:9.3f} ms  x{count:<5d} {name[:70]} "
                  f"| {card}")
    del prof, pre
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        generate(lm, lm_params, prompts, LM_PROFILE_NEW + 1, device="cuda")
    share = step_window_share(torch, prof, *PROFILE_WINDOW)
    if share is None:
        print("[lm-serve] device busy share: not measured (torch.profiler saw"
              " no device time in the window)")
    else:
        print(f"[lm-serve] device busy share {share[0]:.4f} over decode steps"
              f" {PROFILE_WINDOW[0]}-{sum(PROFILE_WINDOW) - 1} "
              f"({share[1]:.1f} ms, profiler on; idle {1 - share[0]:.4f}); "
              f"device ms by kind: " + ", ".join(
                  f"{k} {v:.3f}" for k, v in share[3].items()) + f" | {card}")
        for us, name, count in share[2]:
            print(f"[lm-serve]   {us / 1e3:9.3f} ms  x{count:<5d} {name[:70]} "
                  f"| {card}")
    del prof, gen

    # ---- 13. LM parity ------------------------------------------------------
    zero_launches(KERNELS)
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, V, (1, LM_PARITY_LEN))).cuda()
    with torch.inference_mode():
        full, _ = transformer.forward(lm, lm_params, tokens)
        cache = transformer.init_cache(lm, 1, LM_PARITY_LEN, device="cuda")
        dec = torch.empty_like(full)
        t0 = time.perf_counter()
        for t in range(LM_PARITY_LEN):
            dec[:, t:t + 1], cache = transformer.decode_step(
                lm, lm_params, cache, tokens[:, t:t + 1], t)
        torch.cuda.synchronize()
        dec_s = time.perf_counter() - t0
    gap, ok = log_softmax_gap(torch, dec, full, V)
    if not ok or not gap.max() <= LM_DECODE_GAP:
        raise AssertionError(f"decode vs forward: {gap_summary(gap, 512)}, "
                             f"limit {LM_DECODE_GAP}; the reference's "
                             f"check passed: {ok}")
    # the same forward with the plain attention swapped in, which shows how
    # much of the gap the kernel makes (a comparison only: the port itself
    # never runs the plain version on the card)
    kernel_fa = lm_layers.flash_attention
    lm_layers.flash_attention = kref.flash_attention
    try:
        with torch.inference_mode():
            plain_full, _ = transformer.forward(lm, lm_params, tokens)
    finally:
        lm_layers.flash_attention = kernel_fa
    kp_gap, _ = log_softmax_gap(torch, full, plain_full, V)
    dp_gap, _ = log_softmax_gap(torch, dec, plain_full, V)
    del full, dec, cache, plain_full
    w = lm.sliding_window
    print(f"[lm-parity] {lm.name} full width, S = {LM_PARITY_LEN}: "
          f"teacher-forced decode_step vs the kernel-path forward within "
          f"rtol = atol = 5e-2 of the log-softmax and a max |log-softmax "
          f"diff| per position within {LM_DECODE_GAP}: "
          f"{gap_summary(gap, w)}; {LM_PARITY_LEN} decode steps in "
          f"{dec_s:.3f}s | {card}")
    print(f"[lm-parity] against a forward through the plain attention: "
          f"kernel-path forward {gap_summary(kp_gap, w)}; decode "
          f"{gap_summary(dp_gap, w)} | {card}")
    small = get_config(LM_ARCH, smoke=True)
    sp = init_from_defs(transformer.defs(small),
                        torch.Generator().manual_seed(0), "cpu")
    B, P, N = LM_SMOKE
    sprompts = np.random.default_rng(1).integers(0, small.vocab_size, (B, P))
    on_cpu = generate(small, sp, sprompts, N, device="cpu")
    on_card = teacher_forced(
        torch, transformer, small,
        {k: (v.cuda() if isinstance(v, torch.Tensor)
             else {n: t.cuda() for n, t in v.items()}) for k, v in sp.items()},
        torch.from_numpy(sprompts).cuda(), on_cpu.tokens.cuda()).float().cpu()
    torch.testing.assert_close(on_card, on_cpu.logits.float(), rtol=0,
                               atol=LM_SMOKE_ATOL)
    sdiff = float((on_card - on_cpu.logits.float()).abs().max())
    same = float((on_card.argmax(-1) == on_cpu.tokens).float().mean())
    phase_launches["lm-parity"] = read_launches(KERNELS)
    phase_routes["lm-parity"] = read_routes(KERNELS)
    fa_routes = phase_routes["lm-parity"][fa.name]
    want = expect({"flash_attention": lm.n_layers + small.n_layers})
    want_routes = {"wgmma": lm.n_layers, "mma_sync": small.n_layers,
                   "simt": 0}  # the smoke config's head dim is 16
    if phase_launches["lm-parity"] != want or fa_routes != want_routes:
        raise AssertionError(f"lm-parity launches "
                             f"{phase_launches['lm-parity']} by route "
                             f"{fa_routes}, expected {want} "
                             f"by route {want_routes}")
    print(f"[lm-parity] {small.name} batch {B} x prompt {P}, {N} tokens: "
          f"card (kernel, teacher-forced with the CPU's tokens) vs CPU "
          f"(plain version): max |logit diff| {sdiff:.4e} (atol "
          f"{LM_SMOKE_ATOL}; median |logit| "
          f"{float(on_cpu.logits.float().abs().median()):.4e}), greedy "
          f"tokens equal at {same:.4f} of the positions | {card}")

    # ---- 14. LM train: gemma3-1b, 4 x 4096, remat, CE in chunks of 512 ----
    zero_launches(KERNELS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    marks = []
    losses, walls, _ = lm_train(torch, np, fam, transformer, tcfg, lm_params,
                                LM_BATCH, LM_PROMPT, LM_TRAIN_STEPS, "cuda",
                                marks=marks)
    peak = torch.cuda.max_memory_allocated()
    phase_launches["lm-train"] = read_launches(KERNELS)
    phase_routes["lm-train"] = read_routes(KERNELS)
    L = lm.n_layers
    on_wgmma = {"wgmma": L, "mma_sync": 0, "simt": 0}
    for i, m in enumerate(marks):
        (f0, b0), (f1, b1), (f2, b2) = (m["start_routes"], m["fwd_routes"],
                                        m["end_routes"])
        fwd = {r: f1[r] - f0[r] for r in f0}
        again = {r: f2[r] - f1[r] for r in f0}
        back = {r: b2[r] - b1[r] for r in b0}
        if fwd != on_wgmma or again != on_wgmma \
                or back != {"wgmma": L, "mma_sync": 0} or b1 != b0:
            raise AssertionError(f"lm-train step {i}: forward launches {fwd}"
                                 f", recompute {again}, backward {back}; "
                                 f"expected {L} each, all on wgmma")
    want = expect({"flash_attention": 2 * L * LM_TRAIN_STEPS,
                   "flash_attention_bwd": L * LM_TRAIN_STEPS})
    if phase_launches["lm-train"] != want:
        raise AssertionError(f"lm-train launches {phase_launches['lm-train']}"
                             f", expected {want}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"lm-train losses {losses}")
    walls = np.array(walls[1:]) * 1e3  # the first step is warm-up
    dev = {k: np.median([m[a].elapsed_time(m[b]) for m in marks[1:]])
           for k, a, b in (("forward", "start", "fwd"),
                           ("backward", "fwd", "opt"),
                           ("optimizer", "opt", "end"),
                           ("step", "start", "end"))}
    tokens = LM_BATCH * LM_PROMPT
    print(f"[lm-train] {lm.name} batch {LM_BATCH} x seq {LM_PROMPT}, remat, "
          f"loss chunk {LM_TRAIN_CHUNK}, AdamW lr {LM_TRAIN_LR}, "
          f"{LM_TRAIN_STEPS} steps (the first warm-up): median step "
          f"{np.median(walls):.3f} ms host wall (min {walls.min():.3f}, max "
          f"{walls.max():.3f}), {tokens / np.median(walls) * 1e3:.0f} "
          f"tokens/s; on CUDA events (median) forward {dev['forward']:.3f} "
          f"ms, backward {dev['backward']:.3f} ms, AdamW "
          f"{dev['optimizer']:.3f} ms, step {dev['step']:.3f} ms; peak device"
          f" memory {peak / 2**30:.3f} GiB; per step flash_attention "
          f"{L} forward + {L} recompute on wgmma, flash_attention_bwd {L} on "
          f"wgmma | {card}")
    print(f"[lm-train] losses {losses} | {card}")
    profiled = profile_train_step(torch, np, fam, transformer, tcfg,
                                  lm_params, LM_BATCH, LM_PROMPT)
    if profiled is None:
        print("[lm-train] profiled step: not measured (torch.profiler saw no "
              "device time)")
    else:
        wall_us, rows, cats = profiled
        busy, top = busy_and_top(rows, k=12)
        print(f"[lm-train] profiled step: device busy {busy / 1e3:.3f} ms of "
              f"{wall_us / 1e3:.3f} ms host wall (profiler on, a synchronize "
              f"before AdamW; busy share {busy / wall_us:.4f}); device ms by "
              f"kind: " + ", ".join(f"{k} {v:.3f}" for k, v in cats.items())
              + f"; by operation: | {card}")
        for us, name, count in top:
            print(f"[lm-train]   {us / 1e3:9.3f} ms  x{count:<5d} {name[:70]} "
                  f"| {card}")
    del profiled, lm_params
    torch.cuda.empty_cache()

    # ---- 15. LM train parity: the smoke config on the card and the CPU ----
    zero_launches(KERNELS)
    B, S, N = LM_TRAIN_SMOKE
    sp = init_from_defs(transformer.defs(small),
                        torch.Generator().manual_seed(0), "cpu")
    cpu_losses, _, _ = lm_train(torch, np, fam, transformer, small, sp, B, S,
                                N, "cpu")
    card_losses, _, _ = lm_train(
        torch, np, fam, transformer, small,
        {k: (v.cuda() if isinstance(v, torch.Tensor)
             else {n: t.cuda() for n, t in v.items()}) for k, v in sp.items()},
        B, S, N, "cuda")
    tdiff = float(np.abs(np.subtract(card_losses, cpu_losses)).max())
    if not tdiff <= LM_TRAIN_SMOKE_ATOL:
        raise AssertionError(f"smoke training card vs CPU: losses "
                             f"{card_losses} vs {cpu_losses}")
    phase_launches["lm-train-parity"] = read_launches(KERNELS)
    phase_routes["lm-train-parity"] = read_routes(KERNELS)
    want = expect({"flash_attention": small.n_layers * N,
                   "flash_attention_bwd": small.n_layers * N})
    routes = phase_routes["lm-train-parity"]
    if phase_launches["lm-train-parity"] != want \
            or routes["flash_attention"]["mma_sync"] != small.n_layers * N \
            or routes["flash_attention_bwd"]["mma_sync"] != small.n_layers * N:
        raise AssertionError(f"lm-train-parity launches "
                             f"{phase_launches['lm-train-parity']} by route "
                             f"{routes}, expected {want}, forward and "
                             f"backward on mma_sync (head dim 16)")
    print(f"[lm-train-parity] {small.name} batch {B} x seq {S}, {N} AdamW "
          f"steps from the same seed-0 weights and numpy batches: card "
          f"(kernels) {card_losses} vs CPU (plain versions) {cpu_losses}, max"
          f" |loss diff| {tdiff:.4e} (atol {LM_TRAIN_SMOKE_ATOL}) | {card}")

    record = {"kernels": []}
    for k in KERNELS:
        m = measured[k.name]
        shape, first_timed = next(iter(m["timed"].items()))
        by_phase = {ph: n[k.name] for ph, n in phase_launches.items()}
        if (sum(by_phase.values()) == 0) != (k.name in NO_PATH):
            raise AssertionError(f"{k.name}: launches {by_phase} on the main"
                                 f" paths (no path runs it: "
                                 f"{k.name in NO_PATH})")
        record["kernels"].append({
            "name": k.name, "route": "cuda", "source": k.source,
            "replaces": k.replaces, "launches": sum(by_phase.values()),
            "launches_by_phase": by_phase,
            "launches_by_route": ({r: sum(ph[k.name][r] for ph in
                                          phase_routes.values())
                                   for r in k.kernel.route_launches}
                                  if k.kernel.route_launches else None),
            "case_routes": m.get("routes") if k.kernel.route_launches
            else None,
            "bitwise_equal": k.name not in TOLERANCE and k is not bwd,
            "tolerance": BWD_RULE if k is bwd else TOLERANCE.get(k.name),
            "no_path": NO_PATH.get(k.name),
            "max_abs_err": m["max_abs_err"], "ms": first_timed["ms"],
            "plain_ms": first_timed["plain_ms"],
            "bound_ms": first_timed["bound_ms"],
            "bound_by": first_timed["bound_by"],
            "library_ms": first_timed["library_ms"],
            "library_call": first_timed["library_call"], "shape": shape,
            "timed": m["timed"]})
    print(card)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
