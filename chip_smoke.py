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
   cache, draws near 2^31 and out-of-range routing, then timed (at those
   two shapes and at a 256-seed serving micro-batch) beside its byte
   bound, the two per-hop kernels on the same draws, and the per-hop
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
   for 10 steps with an online cache refresh every 5 steps that replans on
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
   the page cache, so the store's "ssd" reads time an mmap copy), then 5
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
   5 ``device_step`` spans, and their traces hold span tracks of at least
   2 threads; ``repro_torch.obs.report.digest`` runs on them; the store
   run filled rows from the file, hit its host tier and announced 5
   batches; per run 5 ``fused_gather_overlay`` launches, one sampling
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
   128 and 256, and the model layers' shapes at a 4 x 4096 prefill
   (``LAYER_SHAPES``: phi3.5-moe, 32 q heads over 8 kv heads of 128, G 4;
   dbrx, 48 over 8, G 6; zamba2's shared block, 32 heads of 64, causal;
   seamless's encoder, 16 heads of 64, not causal, its decoder's causal
   self attention over 512 queries, and its cross attention, 512 queries
   over 4096 keys, not causal; chameleon, 64 q
   heads over 8 kv heads of 128, G 8, causal), where the forward kernel's
   lse is also held to the plain forward's (rtol = atol = 1e-4); then
   timed at the two gemma3 prefill shapes and the layer shapes beside its
   bound (bf16 operations at 989 TFLOP/s or bytes, the larger) and SDPA;
   on the card
   an f32 call autograd would differentiate must raise (there is no f32
   backward), and a bf16 one must give gradients through the backward.
11b. LM backward: ``flash_attention_bwd`` on q, k, v, o, lse and do
   captured from one real training step (layer 0, local, and layer 5,
   global) and on edge cases (Dh 16, 64, 80, 128 and 256, windows 64 and
   512, G = 1, 2, 3, 4 and 5, ragged Sq, Sq != Sk), each on the route
   ``flash_bwd_route`` gives it (``wgmma`` for bf16 with Dh 64, 80, 128 or
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
   lse.  The same checks (the f64 gradient one (batch row, kv head) at a
   time) at the nine training shapes of phases 22-23 and 26 at the full
   batch (``BWD_FAMILY_SHAPES``: zamba2's shared block, seamless's
   encoder, decoder self and cross attention, phi3.5-moe's G 4,
   chameleon's G 8, stablelm-3b's Dh 80, minitron-4b's G 3 and
   qwen2.5-14b's G 5, all on ``wgmma``), each timed on its route beside
   the bound, the plain version and SDPA's backward, and, where this tree
   moved a shape's route (``OLD_ROUTE``: stablelm's Dh 80 from
   ``mma_sync``), the old route forced and timed in turns with it, in
   both directions.
12. LM serve: ``generate`` for 4 prompts of 4096 tokens (numpy, seed 1),
   then 32 greedy tokens: prefill ms, decode ms per step (CUDA events
   after each step; ``generate`` syncs only after the loop), tokens/s, peak
   device memory, flash-attention launches (26 = one per layer of the one
   prefill, all on the wgmma route), the profiled prefill's device time by
   kind, and the device busy share of 5 decode steps of a profiled run.
13. LM parity: at full width over S = 520 (across the window of 512),
   teacher-forced ``decode_step`` logits against the kernel path's
   ``forward`` (the log-softmax within the reference's rtol = atol = 5e-2,
   and its max difference within 0.15, twice what a forward through the
   plain attention differs by); the gemma3 smoke config
   generated on the CPU (plain version) and teacher-forced with its tokens
   on the card (kernel), logits within atol 5e-3.
14. LM train: ``launch.train.train_step`` on the same gemma3-1b weights at
   4 x 4096 (numpy batches, seed 0) with remat and the CE in chunks of
   512, AdamW, 4 steps (the first is warm-up): finite losses, step ms host
   wall and tokens/s, forward, backward and AdamW ms on CUDA events, peak
   device memory, exactly 26 forward, 26 recompute and 26 backward
   launches a step, all on ``wgmma``; then one profiled step's device time
   by kind (attention forward and backward, matmul, copies and casts, the
   rest, and AdamW after a synchronize).
15. LM train parity: the gemma3 smoke config trained 4 steps on the card
   (kernels, forward and backward on ``mma_sync``: head dim 16) and on the
   CPU (plain versions) from the same seed-0 weights and batches, losses
   within atol 2e-3.
16. Compressed data parallelism (run after 10d, while the graph is
   built): ``train_gnn`` on the device backend at paper width (batch
   8000, fanouts (25, 10), the one-GPU plan) over a 4-position data mesh
   on the card (``make_data_mesh``) with ``compress_grads=True`` (int8
   error feedback, one residual per position), 6 steps, beside the plain
   run from the same seed and parameters: finite losses, the last below
   the first + 0.1, the accuracy 0.0 (as the reference reports it), step
   0's loss within 1e-5 of the plain run's, every traffic tally bitwise
   the plain run's, one ``fused_gather_overlay`` launch and one sampling
   chain per step in each run; median step times and the analytic wire
   bytes printed.
17. Stepwise sampling (after 16): 2 spec samples of 8000 seeds with each
   sampler from one seed, levels bitwise equal, the sample phase timed in
   turns; then 4 device-backend steps with ``sampler="stepwise"`` and 4
   with ``"chain"``: losses, accuracies and every tally bitwise equal; the
   ``hop`` route launches exactly builds x 2 hops times and the chain
   route 0 times in the stepwise run (the chain run the other way round).
18. MoE serving: ``phi3.5-moe-42b-a6.6b`` at full width (d_model 4096, 32
   heads over 8 kv heads of 128, d_ff 6400, 16 experts top-2, vocab
   32,064), 8 of its 32 layers (the depth cut so that one card holds the
   f32 weights: 10.67 B parameters, 42.7 GB, drawn from seed 0 on the
   card's generator; the time of one expert leaf drawn on a CPU generator
   printed beside it), after a warm-up generation, ``generate`` of 32
   greedy tokens after 4 prompts of 4096: prefill ms, decode ms per step
   (CUDA events), peak memory, one ``flash_attention`` launch per layer of
   the prefill, all ``wgmma``; the (token, expert) pairs the prefill's
   capacity path dropped by layer and the kept load of each expert; a
   profiled prefill's device time by kind and the busy share of 5 profiled
   decode steps.  Then the phi3.5-moe and dbrx smoke
   configs generated on the CPU and teacher-forced on the card with every
   layer's routing recorded on both: routing flips counted, the logits of
   the positions routed the same way (a prefill row needs every token's
   kept experts equal: one flip moves later tokens' capacity ranks) and
   the aux loss of a forward within the CPU tests' LM logits tolerance
   (atol 6e-2 + rtol 3e-2).

19. SSM and hybrid serving: ``mamba2-780m`` (48 layers, d_model 1536, 48
   SSD heads of 64, state 128; 0.858 B f32 parameters) and
   ``zamba2-1.2b`` (38 Mamba2 layers, d_model 2048, state 64, and a shared
   attention block of 32 heads of 64 after every 6 of them; 1.170 B) at
   full width and depth, seed-0 weights drawn on the card; after a
   warm-up, ``generate`` of 16 greedy tokens after 4 prompts of 4096:
   prefill ms, decode ms a step (CUDA events), peak memory,
   ``flash_attention`` launches (0 for mamba2, 6 a prefill for zamba2, all
   ``wgmma``); a profiled prefill's device time by kind; layer 0's mixer
   piece by piece on CUDA events (projections, convolutions,
   ``ssd_chunked`` and what it allocates, the whole mixer), the SSD's
   share of the prefill and a profile of ``ssd_chunked`` by kind (its
   einsums, exp/cumsum, copies, the rest); the busy share of 5 profiled
   decode steps.
20. Encoder-decoder serving: ``seamless-m4t-large-v2`` (24 encoder + 24
   decoder layers, d_model 1024, 16 heads of 64, d_ff 8192, vocab
   256,206; 2.036 B) at full width, frames (4, 4096, 1024) from numpy seed
   0 and 512-token prompts (``target_len``), 16 greedy tokens: the same
   figures, 72 ``flash_attention`` launches a prefill (24 encoder, 24
   decoder self, 24 cross), all ``wgmma``.
21. ``chameleon-34b`` at full width (d_model 8192, 64 q heads over 8 kv
   heads of 128, d_ff 22016, qk-norm), 8 of its 48 layers (the depth cut
   so that one card holds the f32 weights: 6.6 B parameters, 26.4 GB; all
   48 are 137 GB): the same figures, 8 launches a prefill on ``wgmma``
   (Dh 128, G 8).  Then the four configs' smoke configs generated on the
   CPU and teacher-forced with those tokens on the card and the CPU:
   logits within the tolerance the CPU tests hold each to the reference
   with (atol 6e-2 + rtol 3e-2; twice the atol for zamba2-smoke and
   seamless-smoke), the final SSM state ``h`` within 1e-5 of its largest
   entry for mamba2-smoke and 3e-2 for zamba2-smoke.
22. Family training at full size: ``launch.train.train_step`` for
   ``mamba2-780m``, ``zamba2-1.2b`` and ``seamless-m4t-large-v2`` (4 x 4096
   frames and a 512-token target) at batch 4 x 4096, remat on, AdamW lr
   1e-3 with the optimizer state handed over (``donate=True``), 2 steps
   from the serving phases' seed-0 weights (the same draw): finite losses,
   step 2's time and tokens/s, forward, backward and AdamW
   ms on CUDA events, peak memory, the attention launches of every step
   by route (mamba2 none; zamba2 6 forward, 6 recomputed, 6 backward;
   seamless 72, 72 and 72; all ``wgmma``), one profiled step's device ms
   by kind (matmul, attention forward and backward, exp and cumsum, copies
   and casts, the rest, AdamW), and for the SSM families layer 0's
   ``ssd_chunked`` forward and backward at the training batch on CUDA
   events with the SSD's share of the step.
23. MoE and VLM training at full width on 2 layers: ``phi3.5-moe-42b-a6.6b``
   (2 of 32 layers, 2.865 B parameters) and ``chameleon-34b`` (2 of 48,
   2.458 B), the CE in chunks of 512: the same figures, 2 + 2 forward and
   2 backward launches a step on ``wgmma``; for phi3.5-moe first two
   identical forward + backward passes with the same loss and gradient
   bits, every layer's routing in the remat recompute equal to the
   forward's (experts, ranks, kept pairs, slots) and the share of dropped
   (token, expert) pairs, and after training layer 0's MoE block backward
   by autograd node (``index_add_``, the combine's gather, the experts'
   ``bmm``).
24. Training parity: the phi3.5-moe, mamba2, zamba2, seamless and
   chameleon smoke configs trained 4 steps on the card (kernels on
   ``mma_sync``: head dim 16) and the CPU (plain versions) from the same
   seed-0 weights and numpy batches, losses within atol 2e-3, and the
   first step's gradients per leaf within 5e-2 (Frobenius, relative), with
   exactly the expected forward and backward launches; then ``python -m
   repro_torch.launch.train --arch <arch> --smoke --steps 2`` for
   seamless and phi3.5-moe as subprocesses: exit 0, finite losses.
25. Dry-run (``repro_torch.launch.dryrun``) held to the card: the cells
   below accounted at full size on the meta device (flops, bytes, peak,
   fits, the roofline's dominant term); then gemma3-1b's four shape cells
   at their full sequence lengths and reduced batches (train_4k 4 x 4096
   with the chunked_loss variant, prefill_32k 1 x 32768, decode_32k 4 x
   32,768 slots, long_500k 1 x 524,288 slots) and dbrx-132b at full width
   on 2 of its 40 layers (prefill_32k 1 x 32768, or 1 x 16384 where the
   accounting puts it above 90% of the card; decode_32k 4 x 32,768), each
   through ``run_cell(..., device="cuda")``: the flops counted on the card
   equal to the meta count, the measured peak within the larger of 10% and
   0.5 GiB of the accounted one, the attention launches exactly as
   expected (train: forward, recompute and backward per layer; prefill:
   forward; decode: none), finite losses and logits, the roofline time
   over the measured step printed; the backward's scratch rule's Python
   copy equal to the library's at every backward shape the run launched;
   ``flash_attention`` at the prefill_32k global and local layers' shapes
   and dbrx's 1 x 32768 layer against its plain version, timed beside
   SDPA and its bound.  The three dense configs of phase 26 run their
   ``prefill_32k`` at batch 1 at full depth the same way.
26. Dense configs at full width (``DENSE_ARCHS``: stablelm-3b, Dh 80 and
   32 kv heads; minitron-4b, G 3; qwen2.5-14b, G 5 with qkv bias), seed-0
   weights drawn on the card: each sized first on the meta device
   (``dryrun.account``: serving's prefill and decode, training's step),
   cut (batch for serving, depth for training) only where the accounted
   peak is above 90% of the card, each cut printed; ``generate`` of 16
   greedy tokens after 4 x 4096 prompts (one ``flash_attention`` launch a
   layer, all ``wgmma``; prefill ms, decode ms a step, peak memory, a
   profiled prefill by kind); layer 0's q, k, v captured from a real
   prefill and held to the plain forward (o and lse); 3 ``train_step``s
   at 4 x 4096 (remat, CE in chunks of 512, AdamW with the state handed
   over; L forward, L recompute and L backward launches a step, all
   ``wgmma``; step ms, tokens/s, forward, backward and AdamW ms, peak
   memory, a profiled step by kind); layer 0's backward call captured
   from a real training step and held as in phase 11b on both routes.
27. A narrow stablelm (``NARROW_STABLELM``: the smoke config at the real
   head dim of 80, 4 heads, d_model 320): its logits on the card
   (teacher-forced) against the CPU's ``generate`` within 5e-3, and 4
   AdamW steps card against CPU within 2e-3, every launch on ``wgmma``.
28. LM serving over a mesh (``mesh_phase``), every position on ``cuda:0``:
   gemma3-1b at full size on a 2 x 2 (data, model) mesh (``MESH_GEMMA``:
   4 x 4096 prompts, 16 greedy tokens; a 1 x 1 mesh first, bitwise the
   meshless run) and phi3.5-moe at full width on 8 layers on a 1 x 4 mesh
   (``MESH_MOE``, 4 tokens, its experts over "model", each position's drops
   counted), each ``generate`` held to its meshless run (``greedy_held``:
   the prefill's logits within ``MESH_TOL``, decode by phase 13's
   criterion, token flips only at near ties; the MoE at capacity factor E
   / top_k, where nothing drops, routing flips only at near ties), one
   ``flash_attention`` launch per layer and position, all ``wgmma``, the
   collectives by kind; the kernel at nonzero query offsets
   (``MESH_OFFSET_CASES``) held to its plain version on its three routes
   and timed beside offset 0, the plain version, SDPA and the bound;
   dbrx-132b's ``decode_32k`` accounted per position on a 1 x 4 meta mesh
   and on the 2 x 16 x 16 production mesh.  28x: the gemma3 mesh with each
   position on its own card, bitwise the one-card mesh, where the host has
   four cards (otherwise it prints that it did not run, and why).
29. LM training over a mesh, every position on ``cuda:0``.  29c first
   (``offset_backward_phase``): ``flash_attention_bwd`` at query offsets
   (``MESH_OFFSET_CASES``' shapes, the ``sp`` layout's last sequence
   blocks, and ``MESH_BWD_EDGE_CASES``: an offset inside a tile, a window
   ending inside one, Dh 80 with G 3, Dh 16), o and lse from the forward
   kernel at the offset, by ``check_backward``'s rule on both routes, then
   timed at the mesh's shapes beside offset 0, the plain version, SDPA's
   backward under the offset's mask and the bound.  29a
   (``mesh_train_phase``): gemma3-1b at full size on a 2 x 2 (data, model)
   mesh at 4 x 4096 (remat, CE in chunks of 512, AdamW with the state
   handed over), sized on meta (every position's bytes summed; a
   subprocess started before phase 11, ``--mesh-train-accounting``, which
   also accounts 29b's and 29d's cells beside the card's phases); the
   meshless ``train_step``s, the first bitwise a 1 x 1 mesh's (loss, new
   parameters, m, v); then ``MESH_TRAIN_LAYOUTS``: ``baseline`` (the
   ``batch_full`` attention) 3 steps and ``sp_attn+zero1`` 2 steps, each
   layout's step-1 layer-0 gradients against the meshless within
   ``MESH_GRAD_REL``, each loss within ``MESH_TRAIN_LOSS_TOL`` of the
   meshless one,
   L forward + L recompute and L backward attention launches per position
   a step, all ``wgmma`` (under ``sp`` half the backward calls at a
   nonzero offset); step ms, tokens/s, peak memory, the collectives of a
   step by kind, a profiled step by kind.  29x: the baseline steps with
   each position on its own card, bitwise the one-card mesh, where the
   host has four cards (otherwise it prints why not).  29b: phi3.5-moe at
   full width on 2 layers on 1 x 4 (experts over "model", capacity factor
   E / top_k, 4 x 4096) against its meshless run, step 1's routing flips
   only at near ties.  29d: dbrx-132b's ``train_4k`` accounted per
   position on the 2 x 16 x 16 meta mesh under ``MESH_TRAIN_DBRX``,
   whether it fits a position printed.
30. The SSM, hybrid and encoder-decoder families over a mesh, every
   position on ``cuda:0``.  30c first (``family_offset_phase``): the
   attention at those meshes' per-position shapes (``MESH_FAMILY_CASES``:
   zamba2's shared block causal at its block's offset, seamless's encoder
   and cross attention not causal, the offset passed and ignored, the
   cross attention's query block a slice of the 128-token target over 1024
   encoder keys; the smoke configs' Dh 16 on ``mma_sync``), forward held
   to its plain version on its routes, backward by ``check_backward``'s
   rule on its own route, both timed beside offset 0, the plain versions,
   SDPA and the bound.  30a (``family_mesh_phase``, ``MESH_FAMILY_SERVE``):
   mamba2-780m under ``head_tp`` and ``seq_sp`` and zamba2-1.2b on a 2 x 2
   (data, model) mesh, seamless-m4t-large-v2 on 1 x 4, full size, 4 x 1024
   prompts (frames), 8 greedy tokens, each ``generate`` held to its
   meshless run by ``greedy_held`` (prefill within ``MESH_TOL``, decode by
   the log-softmax gap ``LM_DECODE_GAP``), one ``flash_attention`` launch
   per attention call of a prefill and position, all ``wgmma``; prefill
   ms, decode ms a step, peak memory, collectives.  30x: mamba2's mesh
   with each position on its own card, bitwise the one-card mesh, where
   the host has four cards (otherwise it prints why not).  30b
   (``MESH_FAMILY_TRAIN``): at full width on a cut depth, 2 steps at 4 x
   1024 on 2 x 2 (remat, AdamW with the state handed over): mamba2-780m
   under ``seq_sp_mixer`` (12 of 48 layers), zamba2-1.2b (12 of 38 layers,
   2 places of its shared block), seamless-m4t-large-v2 under
   ``sp_attn+zero3+chunked_loss`` (6 + 6 of 24 + 24 layers); step 1's
   layer-0 gradients against the meshless within ``MESH_GRAD_REL``, each
   loss within ``MESH_TRAIN_LOSS_TOL``; step ms, tokens/s, peak memory,
   the collectives of a step.

Every kernel's launch count is zeroed just before each of the serve,
train, parity, unfused, shard, shard-parity, store-train (each of its 5
runs), store-serve, resil-* (each run of 10d), dp-plain, dp-compress,
sampler-chain, sampler-stepwise, lm-serve, lm-parity, lm-train,
lm-train-parity, moe-serve, moe-parity, ssm-serve, hybrid-serve,
audio-serve, vlm-serve, family-parity, ssm-train, hybrid-train,
audio-train, moe-train, vlm-train, train-parity, dryrun-* (each cell of
phase 25), <arch>-serve and <arch>-train (phase 26), narrow-stablelm,
mesh-<arch> (phases 28 and 30; mesh-<arch>-x in 28x and 30x,
mesh-mamba2-780m-seq_sp_mixer for the second mixer layout) and
mesh-train-<arch> (phases 29 and 30; mesh-train-gemma3-1b-sp_attn+zero1
for the second layout) phases and read just after, with
the launches by route; ``sage_aggregate``'s stay 0 (no path runs it), and
``routed_neighbor_sample`` launches once per device-sampling spec build,
on its ``chain`` route, except in the stepwise run, where it launches once
per hop on its ``hop`` route.
Run-time cuts that made room for phase 29 (each lowers a step, token or
repeat count; no kernel check and no path is dropped): timed launches per
kernel and shape 100 -> 50 (``TIMED_LAUNCHES``); phase 6 trains 7 steps (was
10), phase 7 8 (12), phase 9 8 (12), phase 16 4 (6); phases 22, 23 and 26
train 2 steps (3); phase 25 times 1 train and 1 prefill call and 2 decode
steps after the counted call (2, 2, 4); phase 28 decodes 16 and 4 tokens
(32, 8).  ``mesh_train_accounting`` runs in a subprocess beside phases 11-28.
Phase 30 came in without a cut elsewhere: its own depth cuts are 30b's
(``MESH_FAMILY_TRAIN``), and 30a runs 4 x 1024 prompts and 8 tokens.
A ``[time]`` line gives each phase's start on the host clock.  The last
three lines are the card's name and power limit, the
``{"kernels": [...]}`` record and ``{"ok": true, "device": {...}}``.
Without CUDA, or without the rest of the repository beside it, the script
fails.
"""
from __future__ import annotations

import atexit
import contextlib
import dataclasses
import functools
import gc
import json
import math
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

# the card's rates (H100 SXM data sheet) and the attention's work formula,
# from their one definition in the package
from repro_torch.kernels.flash_attention import flash_work  # noqa: E402
from repro_torch.launch.dryrun import (BF16_FLOPS_PER_S,  # noqa: E402
                                       HBM_BYTES_PER_S)

SPIN_CYCLES = 2_000_000    # time_ms's device spin: about 1 ms at 1.98 GHz
N_VERTICES = 1_000_000
MEM_PER_DEVICE = 300e6
MAX_BATCH = 256
N_REQUESTS = 200
# timed launches per kernel and shape (100 until phase 29 came in)
TIMED_LAUNCHES = 50
# phase 6's steps (20 until the dense configs of phase 26 came in, 10 until
# phase 29 did)
TRAIN_STEPS = 7
SHARD_TOPOLOGY = ("dgx-v100", 4)  # 2 cliques x 2 GPUs
SHARD_MEM_PER_DEVICE = 150e6      # 300 MB per clique, the one-GPU budget
SHARD_STEPS = 8  # 12 until phase 29 came in
SHARD_REFRESH = 5
SHARD_LAYER_STEPS = 3
SHARD_PARITY_STEPS = 8
PARITY_BATCH = 1024
PARITY_STEPS = 8  # 12 until phase 29 came in
UNFUSED_STEPS = 4
# phase 10b: each run's steps (8 until the dense configs of phase 26 came
# in; the refresh at step 4 needs 4 observed batches) and the refresh
# interval there (replans on any drift)
STORE_STEPS = 5
STORE_REFRESH = 4
STORE_HOST_ROWS = 200_000  # the store's host tier: 20% of the table
STORE_LOOKAHEAD = 4
# phase 10d: kill and resume, faults, the device-loss remesh
RESIL_STEPS = 8            # each run's steps (the killed run: half)
RESIL_REFRESH = 4          # the refresh interval there
RESIL_LOOKAHEAD = 2        # the store's lookahead there
RESIL_LOSS = (4, 3)        # (step, device): device 3 of the 2 x 2 plan
RESIL_CLI_STEPS = (2, 4)   # the CLIs: killed after, resumed to
RESIL_CLI_VERTICES = 2000  # the GNN CLI's --max-vertices
PROFILE_STEPS = 8        # the profiled run; its steps 2..6 are the window
PROFILE_WINDOW = (2, 5)  # (first step, steps)
SAGE_SHAPE = (416_768, 128, 200_000, 10)  # table rows, D, rows out, fanout
LM_ARCH = "gemma3-1b"
LM_BATCH, LM_PROMPT, LM_NEW = 4, 4096, 32
LM_CAPTURE = (0, 5)  # gemma3's first local and first global layer
LM_PROFILE_NEW = 8   # the profiled generation: decode steps 2..6 the window
# crosses the local layers' window of 512 (600 until phase 26 came in)
LM_PARITY_LEN = 520
LM_SMOKE = (4, 24, 16)  # batch, prompt, new: the reference's serve_lm loop
# LM training: gemma3-1b at 4 x 4096 with remat and the CE in chunks of 512
# (the unchunked f32 logits would be 17.2 GB); the first step is warm-up
# 4 steps, the first warm-up (8 until the family training phases pushed the
# whole run past 1000 s)
LM_TRAIN_STEPS = 4
LM_TRAIN_CHUNK = 512
LM_TRAIN_LR = 1e-3  # launch/train.py's default
LM_TRAIN_SMOKE = (4, 64, 4)  # batch, seq, steps: smoke config, card vs CPU
# phase 16: compressed data parallelism on a data mesh of 4 positions on the
# one card, at paper width; its step 0 against the plain run's: the same
# parameters, and the mean of equal-size chunk means is the batch mean, so
# only the order of the float sums differs
DP_STEPS = 4  # 12 until phase 26 came in, 6 until phase 29 did
DP_POSITIONS = 4
DP_STEP0_ATOL = 1e-5
# phase 17: the stepwise sampler against the chain
# 8 steps and 4 spec samples of each sampler (timed in turns) until the
# dense configs of phase 26 came in
STEPWISE_STEPS = 4
STEPWISE_SAMPLES = 2
# phase 18: MoE serving at full width; 8 of phi3.5-moe's 32 layers are
# 10.67 B f32 parameters (42.7 GB), which one 80 GB card holds with the
# prefill's activations; all 32 would be 167 GB
MOE_ARCH = "phi3.5-moe-42b-a6.6b"
MOE_LAYERS = 8
MOE_PARITY = ("phi3.5-moe-42b-a6.6b", "dbrx-132b")  # smoke configs
# the MoE smoke configs' logits card vs CPU: the LM logits tolerance of the
# CPU tests (XLA against torch, tests/test_torch_lm.py); the expert
# products and the bf16 combine round at other points on the card, and the
# smoke configs' untied head gives logits of order 1 (phi3.5 smoke:
# 0.0234 at most on an H100 80GB HBM3 at 700 W)
MOE_SMOKE_TOL = {"atol": 6e-2, "rtol": 3e-2}
# phase 27's logits card vs CPU: the LM tolerance's atol, with no rtol.
# stablelm's untied head gives the narrow config logits of order 1 (median
# |logit| 0.68, max 3.9), and rounding alone spreads them by about 0.05
# whatever the logit's size: the reference against the port on the CPU,
# from the same weights, 0.047 at most, and 18,779 of the 32,768 logits
# beyond LM_SMOKE_ATOL (set for gemma3-smoke's tied head, whose logits stay
# below 0.71); a Dh 80 attention whose last 16 columns are zero moves them
# by 2.76 (tests/test_torch_lm.py::test_narrow_stablelm_logit_spread); the
# card against the CPU: 0.0273 at most, 10,580 beyond LM_SMOKE_ATOL, on an
# H100 80GB HBM3 at 700 W
NARROW_STABLELM_TOL = {"atol": MOE_SMOKE_TOL["atol"], "rtol": 0.0}
# phases 19-21: the SSM, hybrid and encoder-decoder families and chameleon
# at full width from seed-0 weights; chameleon cut to 8 of its 48 layers
# (6.6 B f32 parameters, 26.4 GB; all 48 are 137 GB)
SSM_ARCHS = ("mamba2-780m", "zamba2-1.2b")
# their decode tokens (32 until the family training phases pushed the whole
# run past 1000 s)
FAMILY_NEW = 16
ENCDEC_ARCH = "seamless-m4t-large-v2"
VLM_ARCH = "chameleon-34b"
VLM_LAYERS = 8
FAMILY_PARITY = SSM_ARCHS + (ENCDEC_ARCH, VLM_ARCH)  # smoke configs
# their smoke configs card vs CPU: the logits tolerance the CPU tests hold
# each to the reference with (tests/test_torch_{ssm,encdec,lm}.py): the LM
# tolerance, twice its atol for zamba2-smoke (its shared block's bf16
# chains round a step apart at 40-50% of the entries and the Mamba layers
# after it carry that on: 0.078 card vs CPU at one of 32,768 logits on an
# H100 80GB HBM3 at 700 W) and for seamless-smoke's decode steps.  The SSM
# state h (f32 sums over the prompt of bf16 activations) within 1e-5 of its
# largest entry for mamba2-smoke (3.9e-8 card vs CPU on that H100; an SSD
# run in bf16 is 4e-3 to 1e-2 off) and 3e-2 for zamba2-smoke, whose shared
# block rounds apart (0.0134), as tests/test_torch_ssm.py holds them
FAMILY_SMOKE_TOL = {"mamba2-780m": {"atol": 6e-2, "rtol": 3e-2},
                    "zamba2-1.2b": {"atol": 1.2e-1, "rtol": 3e-2},
                    "seamless-m4t-large-v2": {"atol": 1.2e-1, "rtol": 3e-2},
                    "chameleon-34b": {"atol": 6e-2, "rtol": 3e-2}}
H_TOL_OF_MAX = {"mamba2-780m": 1e-5, "zamba2-1.2b": 3e-2}
SSD_PROFILED = 3  # ssd_chunked calls profiled after a warm-up call
# phases 22-23: the families trained through launch.train.train_step at 4 x
# 4096 (seamless: 4096 frames and a 512-token target), remat on (the
# configs' default), AdamW at LM_TRAIN_LR with the optimizer state handed
# over (train_step's donate=True: one copy of the state), 2 steps, the first
# warm-up.  mamba2, zamba2 and seamless at full size; phi3.5-moe and
# chameleon at full width on 2 of their layers (params, gradients, m and v
# in f32 are 16 bytes a parameter: 2 layers are 2.865 B and 2.458 B
# parameters, 45.8 GB and 39.3 GB, which one card holds with the new params
# and the activations; 3 layers of phi3.5-moe, 66.6 GB, would not), with
# the CE in chunks of LM_TRAIN_CHUNK as phase 14 trains gemma3-1b
FAMILY_TRAIN_STEPS = 2  # 3 until phase 29 came in
FAMILY_TRAIN_FULL = SSM_ARCHS + (ENCDEC_ARCH,)
FAMILY_TRAIN_CUT = ((MOE_ARCH, 2), (VLM_ARCH, 2))  # (arch, layers kept)
# phase 24: the smoke configs trained on the card and the CPU (LM_TRAIN_SMOKE
# steps from the same weights and batches, losses within
# LM_TRAIN_SMOKE_ATOL) and their first step's gradients, per leaf |g_card -
# g_cpu| / |g_cpu| (Frobenius norms) within TRAIN_GRAD_REL, the limit
# tests/test_torch_lm_train.py holds the port's gradients to the
# reference's with
TRAIN_PARITY = (MOE_ARCH,) + FAMILY_TRAIN_FULL + (VLM_ARCH,)
# where those defaults do not hold under rounding alone, the configs get
# what tests/test_torch_train_spread.py measures and prints: zamba2-smoke's
# and seamless-smoke's losses spread by up to 7.13e-3 and 5.52e-3 between
# the reference's own jit and op-by-op runs of these 4 steps (as their
# logits do: ROADMAP section 3, finding 12), so 8e-3; chameleon-smoke's
# losses by 2.45e-3 and zamba2-smoke's first-step A_log gradient by 6.68e-2
# between two CPU runs of the port whose attention sums in another order
# (AdamW's first updates are about lr times each gradient entry's sign), so
# 4e-3 and 1e-1
TRAIN_GRAD_REL = {None: 5e-2, "zamba2-1.2b": 1e-1}
TRAIN_SMOKE_ATOL = {"zamba2-1.2b": 8e-3, "seamless-m4t-large-v2": 8e-3,
                    "chameleon-34b": 4e-3}
# the training CLI on the card, as a user runs it (a subprocess each)
TRAIN_CLI = (ENCDEC_ARCH, MOE_ARCH)
TRAIN_CLI_STEPS = 2
# phase 25: the dry-run (launch/dryrun.py) held to the card.  gemma3-1b's
# four shape cells at their full sequence lengths and reduced batches (batch
# 256, 32, 128 and 1 in SHAPES), train_4k as phase 14 trains it (the
# chunked_loss variant: the unchunked f32 logits alone would be 17.2 GB);
# dbrx-132b at full width on 2 of its 40 layers, its prefill at 1 x 16384
# where the accounting puts 1 x 32768 above DRYRUN_MEM_SHARE of the card
DRYRUN_GEMMA = (("train_4k", 4, "chunked_loss"), ("prefill_32k", 1, "baseline"),
                ("decode_32k", 4, "baseline"), ("long_500k", 1, "baseline"))
DRYRUN_DBRX = (("prefill_32k", 1), ("decode_32k", 4))
DRYRUN_DBRX_LAYERS = 2
DRYRUN_DBRX_CUT_SEQ = 16384
DRYRUN_MEM_SHARE = 0.9
# phase 26's sizing also leaves room for what the allocator reserves beyond
# what it hands out at a training step's peak: 10.37 and 11.41 GiB over
# the peaks of minitron-4b's and qwen2.5-14b's steps (on 15 and 6 layers;
# 12.46 over stablelm-3b's, which leaves 13.4 GiB of the card unused), on
# an H100 80GB HBM3 at 700 W; minitron on 17 layers, its accounting under
# DRYRUN_MEM_SHARE, ran out of memory with 5.88 GiB reserved and unused
# (each phase 26 training prints its peak reserve beside its peak)
ALLOC_MARGIN = 12 * 2 ** 30
# timed calls after the counted one (decode: that many more positions)
# (2, 2 and 4 until phase 29 came in)
DRYRUN_STEPS = {"train": 1, "prefill": 1, "decode": 2}
# the measured peak against the accounted one: within the larger of 10% and
# 0.5 GiB
DRYRUN_PEAK_REL, DRYRUN_PEAK_ABS = 0.10, 0.5 * 2 ** 30
# the kernel shapes of phase 25's prefills that no other phase runs, timed
# as phase 4 times the others (the plain version: LAYERS_32K_PLAIN): gemma3-1b
# prefill_32k's global layers (1 x 32768, 4 q heads over 1 kv head of 256,
# causal, no window) and local layers (window 512), dbrx-132b's layer (48
# q heads over 8 of 128, G 6); (name, (B, S, Hq, Hkv, Dh), window)
LAYERS_32K = (("gemma3_prefill_32k_global", (1, 32768, 4, 1, 256), 1 << 30),
              ("gemma3_prefill_32k_local", (1, 32768, 4, 1, 256), 512),
              ("dbrx_prefill_32k", (1, 32768, 48, 8, 128), 1 << 30))
LAYERS_32K_PLAIN = 1  # the plain version's launches (3 until phase 26)
# phase 26: the dense configs the port had not run on the card, at full
# width from seed-0 weights drawn on the card: serving LM_BATCH x LM_PROMPT
# prompts and FAMILY_NEW greedy tokens, training FAMILY_TRAIN_STEPS steps
# at LM_BATCH x LM_PROMPT (remat, CE in chunks of LM_TRAIN_CHUNK, AdamW
# with the state handed over) and prefill_32k at batch 1 through the
# dry-run; each cut (batch for serving, depth for training) only where the
# accounted peak is above DRYRUN_MEM_SHARE of the card
DENSE_ARCHS = ("stablelm-3b", "minitron-4b", "qwen2.5-14b")
# phase 27: stablelm's smoke config at its real head dim (the CPU tests'
# smoke config has Dh 16, which takes mma_sync), card against CPU
NARROW_STABLELM = {"n_layers": 2, "n_heads": 4, "n_kv_heads": 4,
                   "head_dim": 80, "d_model": 320}
# the backward kernel against the f64 exact gradient: per gradient, max
# |kernel - exact| / max |exact| within twice the plain version's plus this
# floor (both round q * scale, p and each gradient to bf16; the kernel
# also takes ds as two bf16 parts (wgmma) or rounds it (mma_sync) and sums
# in another order)
BWD_F64_FLOOR = 1e-3
# the forward kernel's lse (which the backward reads) against the plain
# forward's, as tests/test_torch_lm_kernels.py holds it
BWD_LSE_TOL = {"rtol": 1e-4, "atol": 1e-4}
BWD_TIMED_PLAIN = 10  # the plain backward's timed launches (tens of ms each)
# the plain forward's timed launches at LAYER_SHAPES (0.6-130 ms each; 10
# until the dense configs of phase 26 came in)
LAYER_TIMED_PLAIN = 3
# at the families' shapes (phase 11b): fewer launches, of 0.06-9 ms each
# (the plain backward's 1-235 ms)
BWD_FAMILY_TIMED, BWD_FAMILY_PLAIN = 30, 3
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
# the forward on calls captured from a real prefill (phase 26) is held
# element by element against the f64 output: there a value of v of order 5
# meets a row that sees a few keys, so one bf16 step of p (rounded at
# another point in each version) moves o by more than TOLERANCE's atol, and
# the plain version itself is outside TOLERANCE of the f64 output at a few
# elements of each such call (2-8 of 50 million on an H100 80GB HBM3 at
# 700 W), where the kernel and it fall on either side of it; so an element
# outside TOLERANCE of the f64 output passes only as close to it as the
# plain version's element, plus one bf16 step of the f64 value
FWD_CAPTURED_RULE = ("each element of o within TOLERANCE of the f64 output, "
                     "or within the plain version's own error + one bf16 "
                     "step; lse within BWD_LSE_TOL")
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
# phase 28, LM serving over a mesh (every position on cuda:0): gemma3-1b at
# full width and depth on a 2 x 2 (data, model) mesh, and MOE_ARCH at full
# width on MOE_LAYERS layers on a 1 x 4 mesh (the experts over "model"):
# (mesh shape, batch, prompt, new tokens)
# (32 and 8 new tokens until phase 29 came in)
MESH_GEMMA = ((2, 2), LM_BATCH, LM_PROMPT, 16)
MESH_MOE = ((1, 4), LM_BATCH, LM_PROMPT, 4)
# each held to the same config's meshless run on the card: the prefill's
# logits within the LM tolerance (ROADMAP finding 3); each decode step's by
# the full-width decode criterion of phase 13 (log-softmax within the
# reference's rtol = atol = 5e-2, max gap LM_DECODE_GAP): the mesh's decode
# attention combines per-shard partials (the reference's algorithm), so p
# is rounded to bf16 at another point in each of 26 layers, and at full
# width that moves single logits by up to 0.0625 on the CPU (gemma3-1b,
# 4 x 64 prompts: 0.0508 in prefill), the LM tolerance's own size; a
# greedy token may differ only where the meshless top-2 margin is within
# twice the LM tolerance
MESH_TOL = {"atol": 6e-2, "rtol": 3e-2}
# the flash kernel at a mesh prefill's per-position shapes (a query block
# of the sequence at its offset, over the whole keys): (name, q shape,
# Sk, Hkv, window, q_offset); gemma3's last sequence block (local and
# global layers) on the 2 x 2 mesh, MOE_ARCH's on the 1 x 4 mesh
MESH_OFFSET_CASES = (
    ("mesh_gemma3_local_q2048_at2048", (2, 2048, 4, 256), 4096, 1, 512, 2048),
    ("mesh_gemma3_global_q2048_at2048", (2, 2048, 4, 256), 4096, 1, 0, 2048),
    ("mesh_phi35_q1024_at3072", (4, 1024, 32, 128), 4096, 8, 0, 3072))
MESH_OFFSET_TIMED = 20  # the kernel's timed launches per case and offset
# phase 29c, the attention backward at a query offset, beside
# MESH_OFFSET_CASES's shapes: (name, (B, Sq, Hq, Hkv, Dh), Sk, window,
# q_offset): an offset inside a tile; a window that ends inside a tile; Dh
# 80 with G 3; Dh 16 (native on mma_sync)
MESH_BWD_EDGE_CASES = (
    ("bwd_off37_sq100_sk200_g4_dh64", (1, 100, 4, 1, 64), 200, 0, 37),
    ("bwd_off70_window50_g2_dh128", (2, 130, 4, 2, 128), 260, 50, 70),
    ("bwd_off170_g3_dh80", (1, 130, 6, 2, 80), 300, 0, 170),
    ("bwd_off96_window100_g4_dh16", (1, 77, 4, 1, 16), 200, 100, 96))
# phase 29, LM training over a mesh (every position on cuda:0): gemma3-1b
# at full size on a 2 x 2 (data, model) mesh at LM_BATCH x LM_PROMPT (remat,
# the CE in chunks of LM_TRAIN_CHUNK, AdamW at LM_TRAIN_LR with the state
# handed over), each layout for its number of steps; MOE_ARCH at full width
# on MESH_TRAIN_MOE_LAYERS layers on a 1 x 4 mesh (the experts over
# "model") at capacity factor E / top_k, where no pair can drop, at
# LM_BATCH x LM_PROMPT: there the capacity buffers and the experts'
# activations are 6.4 times those at the config's 1.25; the mesh step
# peaked at 76.776 GiB of an H100 80GB HBM3 at 700 W (accounted 66.004)
MESH_TRAIN_GEMMA = ((2, 2), LM_BATCH, LM_PROMPT)
MESH_TRAIN_LAYOUTS = (("baseline", 3), ("sp_attn+zero1", 2))
MESH_TRAIN_MOE = ((1, 4), LM_BATCH, LM_PROMPT, 2)  # mesh, batch, seq, steps
MESH_TRAIN_MOE_LAYERS = 2
# each step's loss held to the meshless run's: the LM tolerance (6e-2 +
# 3e-2 |loss|: the same rounding spread as MESH_TOL, and AdamW's sign-like
# first steps carry it on: ROADMAP finding 14); step 1's layer-0 gradient
# leaves, each |mesh - meshless| / |meshless| (Frobenius) within
# MESH_GRAD_REL: the CPU tests measure 1.2e-2 at most between the port's
# mesh and meshless steps of the smoke configs
# (tests/test_torch_lm_mesh_train.py, GRAD_REL 5e-2); a gradient counted
# twice or half is 1.0 or 0.5 off
MESH_TRAIN_LOSS_TOL = {"atol": 6e-2, "rtol": 3e-2}
MESH_GRAD_REL = 5e-2
# phase 29d: dbrx-132b's train_4k accounted on the 2 x 16 x 16 meta mesh
# under these variants (a subprocess started before phase 11, beside the
# card's phases: about 40 s each on one CPU core)
MESH_TRAIN_DBRX = ("baseline", "sp_attn+zero3+chunked_loss")
# phase 30, the SSM, hybrid and encoder-decoder families over a mesh (every
# position on cuda:0), serving at full width and depth: (arch, variant,
# mesh shape, batch, prompt (frames for the encoder-decoder), new tokens);
# each sequence block a whole number of SSD chunks under seq_sp (512 = 2
# chunks of 256 on "model" = 2)
MESH_FAMILY_SERVE = (
    ("mamba2-780m", "baseline", (2, 2), 4, 1024, 8),
    ("mamba2-780m", "seq_sp_mixer", (2, 2), 4, 1024, 8),
    ("zamba2-1.2b", "baseline", (2, 2), 4, 1024, 8),
    ("seamless-m4t-large-v2", "baseline", (1, 4), 4, 1024, 8))
# training at full width on a cut depth (layers kept; the encoder-decoder's
# encoder and decoder each), 2 steps: (arch, variant, mesh shape, batch,
# seq, layers); zamba2's 12 layers hold 2 places of its shared block
MESH_FAMILY_TRAIN = (
    ("mamba2-780m", "seq_sp_mixer", (2, 2), 4, 1024, 12),
    ("zamba2-1.2b", "baseline", (2, 2), 4, 1024, 12),
    ("seamless-m4t-large-v2", "sp_attn+zero3+chunked_loss", (2, 2), 4, 1024,
     6))
MESH_FAMILY_STEPS = 2
# 30a's criterion: the meshless run itself, on each half of the batch alone
# (only its products' row counts change), moves these full-width models'
# logits beyond MESH_TOL and LM_DECODE_GAP (decode log-softmax gaps up to
# 0.7274 for mamba2-780m, 0.1777 for zamba2-1.2b, 0.1404 for
# seamless-m4t-large-v2, whose prefill moves by 0.0742; tools/
# mesh_decode_spread.py on an H100 80GB HBM3 at 700 W); so the mesh's
# teacher-forced prefill is held to MESH_TOL, and each decode step's gap to
# LM_DECODE_GAP, each plus this many times that meshless spread at the
# step, measured in the same run
MESH_FAMILY_SPREAD_K = 2
# phase 30c: the attention at the per-position shapes of those meshes, the
# last sequence block of each: zamba2's shared block (2 x 2, 4 x 1024),
# seamless's encoder (1 x 4, 1024 frames: non-causal, the offset passed and
# ignored) and its cross attention (the decoder's 128 tokens over 1024
# encoder slots); then the smoke configs' Dh 16 (mma_sync) at the CPU
# tests' 2 x 2 shapes: (name, q shape, Sk, Hkv, window, q_offset, causal)
MESH_FAMILY_CASES = (
    ("fam_zamba2_q512_at512", (2, 512, 32, 64), 1024, 32, 0, 512, True),
    ("fam_seamless_enc_q256_at768", (4, 256, 16, 64), 1024, 16, 0, 768,
     False),
    ("fam_seamless_cross_q32_at96", (4, 32, 16, 64), 1024, 16, 0, 96, False),
    ("fam_smoke_enc_q32_at32_dh16", (2, 32, 4, 16), 64, 4, 0, 32, False),
    ("fam_smoke_cross_q8_at8_dh16", (2, 8, 4, 16), 64, 4, 0, 8, False))
# the MoE's routing is discontinuous: where the meshless router's k-th and
# (k+1)-th probabilities are this close (a near tie; the two runs' hidden
# states differ by bf16 rounding), the mesh may pick the other expert, and
# that sequence is compared no further; a flip at a wider margin fails
ROUTE_FLIP_MARGIN = 1e-2


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

    k, (R, D) = len(shards), shards[0].shape
    row = D * shards[0].element_size()
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

    indptr = torch.stack(list(indptr))  # the shards' rows, for counting
    k, R1 = indptr.shape
    E = indices[0].shape[0]
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


def separate_copies(torch, shards, step: int):
    """Each shard copied into an allocation of its own, shard ``i`` at
    ``i * step`` bytes (mod 16) past a 16-byte boundary (``offset_copy``)."""
    return [offset_copy(torch, t, i * step % 16)
            for i, t in enumerate(shards)]


def routed_gather_cases(torch, ctx, seed: int = 3):
    """One mesh position's routed gather of the real sharded step (clique
    0's shards, one allocation each, position (0, 0)'s routing), in bf16,
    at D = 100, all misses, every hit owned by one shard, owners and slots
    past the end, the shards copied to separate allocations at other
    16-byte boundaries and at 4-byte offsets (the kernel's 4-byte copies),
    and the shard table in a shuffled order."""
    sh = ctx["shard"]
    shards, owner, local = sh["shards"], sh["owner"], sh["local"]
    k, (R, D) = len(shards), shards[0].shape
    dev = owner.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    s100 = [torch.randn((50_000, 100), generator=gen, device=dev)
            for _ in range(k)]
    one = torch.where(owner >= 0, torch.full_like(owner, k - 1), owner)
    bad_o, bad_l = owner.clone(), local.clone()
    bad_o[1::97] = k + 1
    bad_l[::89] = R + 5
    bad_l[2::89] = -3
    cases = {
        "position_f32": (shards, owner, local),
        "position_bf16": ([s.to(torch.bfloat16) for s in shards], owner,
                          local),
        "d100_f32": (s100, owner, local % 50_000),
        "all_misses": (shards, torch.full_like(owner, -1), local),
        "one_owner": (shards, one, local),
        "out_of_range": (shards, bad_o, bad_l),
        "separate_allocations": (separate_copies(torch, shards, 0), owner,
                                 local),
        "separate_4B_offsets": (separate_copies(torch, shards, 4), owner,
                                local),
        "shuffled_table": (shards[::-1], owner, local),
    }
    # the stacked form, for the library call: one index_select
    flat = torch.cat(shards)
    lib_idx = (owner.clamp(0, k - 1).to(torch.int64) * R
               + local.clamp(0, R - 1).to(torch.int64))
    timed = [("position", cases["position_f32"],
              routed_gather_bytes(shards, owner, local),
              ("torch.index_select(stacked_shards, 0, flat_idx)",
               lambda: torch.index_select(flat, 0, lib_idx)))]
    return cases, timed


def routed_neighbor_sample_cases(torch, ctx, seed: int = 4):
    """The routed sampler at the real sharded step's hop 0 and hop 1 (clique
    0's CSR shards, position (0, 0)'s frontier), degree-0 rows (the pad
    row), draws near 2^31, owners and slots past the end, all misses."""
    sh = ctx["shard"]
    ip, ix = sh["indptr"], sh["indices"]
    (o1, l1, r1), hop0 = sh["hop1"], sh["hop0"]
    k, R1 = len(ip), ip[0].shape[0]
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
        "separate_offsets": (separate_copies(torch, ip, 8),
                             separate_copies(torch, ix, 4), o1, l1, r1),
        "shuffled_table": (ip[::-1], ix[::-1], o1, l1, r1),
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

    indptr, indices = torch.stack(list(indptr)), torch.stack(list(indices))
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
    row), all misses, an empty topology cache, draws near 2^31, owners
    and slots out of range, the CSR shards copied to separate allocations
    at other offsets, and the shard table in a shuffled order."""
    ip, ix, owner, local, seeds, (r0, r1) = sample["chain"]
    dev = seeds.device
    k, R1 = len(ip), ip[0].shape[0]
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
            [torch.zeros(1, dtype=torch.int64, device=dev)] * k,
            [torch.zeros(1, dtype=torch.int32, device=dev)] * k,
            torch.full_like(owner, -1), local, seeds, [r0, r1]),
        "draws_near_2^31": (ip, ix, owner, local, seeds, [near0, near1]),
        "out_of_range": (ip, ix, bad_o, bad_l, seeds, [r0, r1]),
        "separate_offsets": (separate_copies(torch, ip, 8),
                             separate_copies(torch, ix, 4), owner, local,
                             seeds, [r0, r1]),
        "shuffled_table": (ip[::-1], ix[::-1], owner, local, seeds,
                           [r0, r1]),
    }


def per_hop_composition(cache, seeds, fanouts, rands, position=None):
    """The chain as it ran before the chain kernel: ``device_sample_cached``
    hop after hop (routing glue, pageable upload of the draws, the per-hop
    kernel), each hop fed the previous hop's device output."""
    frontier = seeds
    for f, r in zip(fanouts, rands):
        out, _ = cache.device_sample_cached(frontier, f, rand=r,
                                            position=position)
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
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            flush.zero_()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.profiler.record_function("composition"):
                fn(*args)
                torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
    every, at = kineto_rows(torch, prof, ("composition",))
    rows = [r for w in at["composition"] for r in window_rows(every, *w)]
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
        snap = [t.clone() for t in _tensors(args)]
        got_o, got_h = gather.routed_neighbor_sample_chain(*args)
        want_o, want_h = ref.routed_neighbor_sample_chain_peer(*args)
        torch.cuda.synchronize()
        if len(got_o) != len(args[5]) or not all(
                a.dtype == b.dtype and torch.equal(a, b)
                for a, b in zip(got_o + got_h, want_o + want_h)):
            raise AssertionError(f"routed_neighbor_sample_chain != plain "
                                 f"version on case {name}")
        if not all(torch.equal(a, b) for a, b in zip(_tensors(args), snap)):
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
                 time_ms(torch, ref.routed_neighbor_sample_chain_peer, args,
                         TIMED_LAUNCHES, flush),
                 sum(time_ms(torch, gather.routed_neighbor_sample, h,
                             TIMED_LAUNCHES, flush) for h in c["hops"]),
                 time_ms(torch, gather.routed_neighbor_sample_chain, first,
                         TIMED_LAUNCHES, flush)]
            runs.append(r)
        mean = [float(np.mean([r[i] for r in runs])) for i in range(4)]
        per_hop = composition_cost(
            torch, functools.partial(per_hop_composition,
                                     position=c["position"]), n_args, flush)
        chain = composition_cost(
            torch, functools.partial(c["cache"].device_sample_chain,
                                     position=c["position"]), n_args[1:],
            flush)
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


# the model layers' attention shapes at a 4 x 4096 prefill, no window:
# (name, (B, Sq, Hq, Hkv, Dh), Sk (None: Sq), causal).  The MoE configs
# (phi3.5-moe G 4, dbrx G 6, Dh 128); zamba2's shared block (32 heads of
# 64, G 1); seamless's encoder self attention (16 heads of 64, not causal),
# its decoder's causal self attention over the 512-token prompt and its
# cross attention (that prompt over the 4096 encoder frames, not causal);
# chameleon's layer (64 q heads over 8 kv heads of 128, G 8); the dense
# configs of phase 26: stablelm-3b (32 heads of 80, G 1), minitron-4b (24
# q heads over 8 of 128, G 3), qwen2.5-14b (40 over 8, G 5)
LAYER_SHAPES = (
    ("phi35_moe_g4_dh128", (4, 4096, 32, 8, 128), None, True),
    ("dbrx_g6_dh128", (4, 4096, 48, 8, 128), None, True),
    ("zamba2_shared_g1_dh64", (4, 4096, 32, 32, 64), None, True),
    ("seamless_encoder_full_g1_dh64", (4, 4096, 16, 16, 64), None, False),
    ("seamless_decoder_self_sq512_g1_dh64", (4, 512, 16, 16, 64), None,
     True),
    ("seamless_cross_sq512_sk4096_dh64", (4, 512, 16, 16, 64), 4096, False),
    ("chameleon_g8_dh128", (4, 4096, 64, 8, 128), None, True),
    ("stablelm_mha_dh80", (4, 4096, 32, 32, 80), None, True),
    ("minitron_g3_dh128", (4, 4096, 24, 8, 128), None, True),
    ("qwen25_g5_dh128", (4, 4096, 40, 8, 128), None, True))
# the attention backward's cases at the families' training shapes (phase
# 11b): the layer shapes of every trained config (all but dbrx's), held
# and timed at the full batch
BWD_FAMILY_SHAPES = tuple(s for s in LAYER_SHAPES
                          if not s[0].startswith("dbrx"))
# layer shapes whose route this tree moved, with the route they took
# before: that route is forced (``forced_route``) and timed in turns with
# the new one, forward and backward (the kernel table's bracketed time)
OLD_ROUTE = {"stablelm_mha_dh80": "mma_sync"}


def flash_attention_cases(torch, ctx, seed: int = 6):
    """bf16 q/k/v captured from the full-width gemma3-1b prefill (4 x 4096
    tokens): layer 0 (local, window 512) and layer 5 (global); the Pallas
    tests' (BH, S, Dh) shapes in f32, causal and not; ragged S = 77 and
    1000 with windows 1, 64 (the tile at position 96 visits keys 0-63, all
    masked for its row 127), 512 and >= S, not causal, Sq != Sk, G = 1, 3,
    4, 5 and 8, Dh 64, 80, 128 and 256; and the model layers' shapes of a
    4 x 4096 prefill (``LAYER_SHAPES``: the MoE configs', zamba2's shared
    block, seamless's encoder, decoder and cross attention, chameleon's),
    timed (the plain version 10 launches)."""
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
    # the model layers' shapes at the 4 x 4096 prefill (LAYER_SHAPES)
    for name, shape, Sk, causal in LAYER_SHAPES:
        q, k, v = qkv(*shape, torch.bfloat16, Sk=Sk)
        cases[name] = (q, k, v, {"window": 0, "causal": causal})
        nbytes, flops = flash_work(q, k, 0, causal)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))

        def sdpa(qt=qt, kt=kt, vt=vt, causal=causal):
            return F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True)
        timed.append((name, cases[name], nbytes,
                      ("F.scaled_dot_product_attention(enable_gqa=True, "
                       f"is_causal={causal})", sdpa), flops, LAYER_TIMED_PLAIN))
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


def _tensors(args) -> list:
    """Every tensor among a case's positional arguments, those in a list
    (a clique's shards, a chain's draws) included."""
    out = []
    for a in args:
        if isinstance(a, (list, tuple)):
            out += _tensors(a)
        elif hasattr(a, "clone"):
            out.append(a)
    return out


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
                 for t in _tensors(_split(args)[0])}
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
    for shape, args, nbytes, lib, *rest in timed:
        flops = rest[:1]  # the case's operations, where it counts them
        n_plain = rest[1] if len(rest) > 1 else TIMED_LAUNCHES
        a, kw = _split(args)
        runs = []
        for _ in range(2):  # kernel, plain, library; twice
            r = [time_ms(torch, functools.partial(k.wrapper, **kw), a,
                         TIMED_LAUNCHES, flush),
                 time_ms(torch, functools.partial(k.plain, **kw), a,
                         n_plain, flush)]
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
        for t in _tensors(_split(args)[0]):
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


def window_rows(rows, w0, w1):
    """``kineto_rows``' rows clipped to [w0, w1] (us), the empty ones
    dropped."""
    out = []
    for s, t, name in rows:
        s, t = max(s, w0), min(t, w1)
        if t > s:
            out.append((s, t, name))
    return out


def kineto_rows(torch, prof, marks=("lm_optimizer",)):
    """(start, end, name) (us) of the device-side events (kernels, copies,
    memsets; the device copies of record_function ranges left out), and
    the (start, end) of every CPU range named in ``marks``, read from the
    profiler's raw events: for a profile run with ``acc_events=False``
    whose ``prof.events()`` is never called, this skips building an event
    object per operation (seconds per hundred thousand events, as many as a
    training step of a 48-layer SSM makes)."""
    res = prof.profiler.kineto_results
    t0 = res.trace_start_ns()
    rows, at = [], {m: [] for m in marks}
    for e in res.events():
        name = e.name()
        s = (e.start_ns() - t0) / 1e3
        t = s + e.duration_ns() / 1e3
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if name not in ("device_step", "composition", "lm_optimizer",
                            "ssd_call") and t > s:
                rows.append((s, t, name))
        elif name in at:
            at[name].append((s, t))
    return rows, at


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

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        breakdown(torch, np, builder, cfg, params, n, oracle=False)
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = kineto_rows(torch, prof, ())[0]
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
    rows, at = kineto_rows(torch, prof, ("device_step",))
    steps = sorted(at["device_step"])
    if len(steps) < first + count:
        return None
    w0, w1 = steps[first][0], steps[first + count - 1][1]
    rows = window_rows(rows, w0, w1)
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
    return {e.name() for e in prof.profiler.kineto_results.events()}


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
    # with a window of 4 over 5 steps the last builds sample nothing (the
    # window sampled them during the first builds), so the step median
    # flatters the lookahead run: the host build total and the wall count
    # all of its work
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
    rc = RefreshConfig(interval=RESIL_REFRESH, drift_threshold=1.0)
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


# ---- compressed data parallelism and the stepwise sampler (16, 17) ---------

TALLIES = ("pcie_transactions", "feature_requests", "feature_hits",
           "topo_requests", "topo_hits", "host_sample_syncs",
           "host_sampled_edges")


def tallies_equal(a, b) -> bool:
    """Two traffic counters' tallies and byte matrices, bit for bit."""
    return (all(getattr(a, n) == getattr(b, n) for n in TALLIES)
            and bool((a.bytes_matrix == b.bytes_matrix).all())
            and bool((a.topo_bytes_matrix == b.topo_bytes_matrix).all()))


def compressed_phase(torch, np, g, plan, params, card: str,
                     phase_launches: dict, phase_routes: dict,
                     device: str = "cuda", steps: int = DP_STEPS,
                     n_data: int = DP_POSITIONS, cfg=None) -> None:
    """Phase 16: ``train_gnn`` on the device backend over a data mesh of
    ``n_data`` positions on the one card with the int8 error-feedback
    gradient all-reduce, beside the plain run from the same seed and
    parameters; each run's launches recorded."""
    from repro_torch.configs.legion_gnn import GRAPHSAGE
    from repro_torch.kernels import KERNELS
    from repro_torch.launch.mesh import make_data_mesh
    from repro_torch.train.compression import wire_bytes_saved
    from repro_torch.train.loop import train_gnn

    cfg = cfg or GRAPHSAGE
    kw = dict(backend="device", device=device, seed=0, params=params,
              steps=steps)
    mesh = make_data_mesh(n_data, devices=[device] * n_data)
    runs = {}
    for name, extra in (("dp-plain", {}),
                        ("dp-compress", {"mesh": mesh,
                                         "compress_grads": True})):
        zero_launches(KERNELS)
        runs[name] = train_gnn(g, fresh_copy(plan), cfg, **kw, **extra)
        phase_launches[name] = read_launches(KERNELS)
        phase_routes[name] = read_routes(KERNELS)
        builds = runs[name].pipeline["batches_built"]
        want = expect({"fused_gather_overlay": steps,
                       "routed_neighbor_sample": builds})
        if phase_launches[name] != want or builds != steps:
            raise AssertionError(f"{name}: launches {phase_launches[name]} "
                                 f"for {builds} builds, expected {want}")
        expect_chains(name, phase_routes[name], builds)
    plain, comp = runs["dp-plain"], runs["dp-compress"]
    losses = np.array(comp.losses)
    if len(losses) != steps or not np.isfinite(losses).all() \
            or not losses[-1] < losses[0] + 0.1:
        raise AssertionError(f"compressed losses {comp.losses}")
    if comp.accs != [0.0] * steps:
        raise AssertionError(f"compressed accuracies {comp.accs}: the "
                             "reference reports 0.0")
    d0 = abs(comp.losses[0] - plain.losses[0])
    if not d0 <= DP_STEP0_ATOL:
        raise AssertionError(f"step-0 loss {comp.losses[0]} against the "
                             f"plain run's {plain.losses[0]}")
    if not tallies_equal(comp.counter, plain.counter):
        raise AssertionError("compressed run's traffic tallies differ from "
                             "the plain run's")
    med = {n: float(np.median(r.step_times)) * 1e3 for n, r in runs.items()}
    w = wire_bytes_saved(params)
    print(f"[dp-compress] {cfg.name} batch {cfg.batch_size} fanouts "
          f"{tuple(cfg.fanouts)}, {n_data} data positions on one card, int8"
          f" error feedback, {steps} steps: losses finite, last "
          f"{losses[-1]:.6f} < first {losses[0]:.6f} + 0.1; step 0 "
          f"{comp.losses[0]!r} vs the plain run's {plain.losses[0]!r} "
          f"(|diff| {d0:.3e} <= {DP_STEP0_ATOL}); every tally equal to the "
          f"plain run's | {card}")
    print(f"[dp-compress] median step {med['dp-compress']:.3f} ms "
          f"(compressed, {n_data} positions in turn) vs {med['dp-plain']:.3f}"
          f" ms (plain); wire bytes per sync {w['f32_bytes']} f32 vs "
          f"{w['int8_bytes']} int8 (ratio {w['ratio']}, analytic); "
          f"fused_gather_overlay {steps}, routed_neighbor_sample {steps} "
          f"chain launches each run | {card}")
    print(f"[dp-compress] losses {comp.losses} | {card}")


def stepwise_phase(torch, np, g, plan, params, card: str,
                   phase_launches: dict, phase_routes: dict,
                   device: str = "cuda", steps: int = STEPWISE_STEPS,
                   cfg=None) -> None:
    """Phase 17: the stepwise sampler (one ``hop`` launch and one sync per
    hop) against the chain (one launch per spec build): the same specs'
    levels from one builder each, then ``train_gnn`` with each sampler from
    one seed; each run's launches recorded."""
    from repro_torch.configs.legion_gnn import GRAPHSAGE
    from repro_torch.kernels import KERNELS
    from repro_torch.train.batch import DeviceBatchBuilder
    from repro_torch.train.loop import train_gnn

    cfg = cfg or GRAPHSAGE
    modes = ("chain", "stepwise")
    cache = plan.cache_for_device(0)
    builders = {m: DeviceBatchBuilder(g, cache, cfg.fanouts, None, 0,
                                      device=device, sampler=m)
                for m in modes}
    rngs = {m: np.random.default_rng(11) for m in modes}
    tablet = plan.partition.tablets[0]
    seeds = np.random.default_rng(12).integers(
        0, len(tablet), (STEPWISE_SAMPLES, cfg.batch_size))
    sample_ms = {m: [] for m in modes}
    for i in range(STEPWISE_SAMPLES):
        levels = {}
        for m in (modes if i % 2 == 0 else modes[::-1]):
            if device != "cpu":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            levels[m] = builders[m].sample_spec(tablet[seeds[i]],
                                                rngs[m]).levels
            sample_ms[m].append((time.perf_counter() - t0) * 1e3)
        if any(not np.array_equal(a, b) for a, b in zip(levels["chain"],
                                                        levels["stepwise"])):
            raise AssertionError(f"stepwise levels differ from the chain's "
                                 f"at sample {i}")
    del builders
    kw = dict(backend="device", device=device, seed=0, params=params,
              steps=steps)
    runs = {}
    for m in modes:
        name = f"sampler-{m}"
        zero_launches(KERNELS)
        runs[m] = train_gnn(g, fresh_copy(plan), cfg, sampler=m, **kw)
        phase_launches[name] = read_launches(KERNELS)
        phase_routes[name] = read_routes(KERNELS)
        builds = runs[m].pipeline["batches_built"]
        per = len(cfg.fanouts) if m == "stepwise" else 1
        want = expect({"fused_gather_overlay": steps,
                       "routed_neighbor_sample": builds * per})
        want_routes = ({"hop": builds * per, "chain": 0} if m == "stepwise"
                       else {"hop": 0, "chain": builds})
        if phase_launches[name] != want or builds != steps or \
                phase_routes[name]["routed_neighbor_sample"] != want_routes:
            raise AssertionError(
                f"{name}: launches {phase_launches[name]} by route "
                f"{phase_routes[name]} for {builds} builds, expected {want}"
                f", routes {want_routes}")
    a, b = runs["chain"], runs["stepwise"]
    if a.losses != b.losses or a.accs != b.accs \
            or not tallies_equal(a.counter, b.counter):
        raise AssertionError(f"stepwise run differs from the chain's: "
                             f"losses {b.losses} vs {a.losses}")
    print(f"[stepwise] {STEPWISE_SAMPLES} spec samples of {cfg.batch_size} "
          f"seeds, fanouts {tuple(cfg.fanouts)}: levels bitwise equal; "
          f"median sample phase stepwise "
          f"{np.median(sample_ms['stepwise']):.3f} ms vs chain "
          f"{np.median(sample_ms['chain']):.3f} ms (host wall, in turns) "
          f"| {card}")
    sampling = {m: phase_routes[f"sampler-{m}"]["routed_neighbor_sample"]
                for m in modes}
    print(f"[stepwise] train_gnn {steps} steps, device backend: losses, "
          f"accuracies and every tally bitwise equal to the chain run's; "
          f"routed_neighbor_sample by route {sampling['stepwise']} (= "
          f"{steps} builds x {len(cfg.fanouts)} hops) vs chain "
          f"{sampling['chain']}; "
          f"median step {np.median(b.step_times) * 1e3:.3f} ms vs "
          f"{np.median(a.step_times) * 1e3:.3f} ms | {card}")


# ---- MoE serving (phase 18) -------------------------------------------------

@contextlib.contextmanager
def recorded_routes(moe, record: list):
    """Every ``moe._route`` call's top-k ids appended to ``record`` (the
    tensors as computed, no sync), in call order: the prefill's layers,
    then each decode step's."""
    inner = moe._route

    def route(cfg, p, x):
        out = inner(cfg, p, x)
        record.append(out[0])
        return out

    moe._route = route
    try:
        yield record
    finally:
        moe._route = inner


def expert_sets(torch, idx, E: int, keep=None):
    """(..., E) membership: which experts each token of ``idx`` (..., K;
    a token's K ids are distinct) went to, or with ``keep`` (..., K) which
    kept it; a token's K ids in any order are one routing."""
    flat = idx.reshape(-1, idx.shape[-1])
    src = (torch.ones_like(flat, dtype=torch.bool) if keep is None
           else keep.reshape(flat.shape))
    out = torch.zeros((flat.shape[0], E), dtype=torch.bool,
                      device=idx.device).scatter_(1, flat, src)
    return out.reshape(idx.shape[:-1] + (E,))


def moe_serve_phase(torch, np, card: str, phase_launches: dict,
                    phase_routes: dict, cfg=None, batch: int = LM_BATCH,
                    prompt: int = LM_PROMPT, new: int = LM_NEW,
                    device: str = "cuda") -> None:
    """Phase 18a: ``MOE_ARCH`` at full width, ``MOE_LAYERS`` of its layers
    (the depth cut so that one card holds the f32 weights), seed-0 weights
    drawn on the card; ``generate`` of ``new`` greedy tokens after
    ``batch`` x ``prompt`` prompts, every layer's routing recorded."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import KERNELS
    from repro_torch.launch.serve_lm import generate
    from repro_torch.models import moe, transformer
    from repro_torch.models.params import init_from_defs
    from repro_torch.train.optimizer import tree_leaves

    full = get_config(MOE_ARCH)
    cfg = cfg or dataclasses.replace(full, n_layers=MOE_LAYERS)
    on_card = device != "cpu"
    t0 = time.perf_counter()
    params = init_from_defs(transformer.defs(cfg),
                            torch.Generator(device=device).manual_seed(0),
                            device)
    if on_card:
        torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree_leaves(params))
    leaf = params["layers"]["w_gate"][0]
    t0 = time.perf_counter()
    torch.randn(leaf.shape, generator=torch.Generator().manual_seed(0))
    cpu_leaf_s = time.perf_counter() - t0
    print(f"[moe-serve] {cfg.name}: {cfg.n_layers} of {full.n_layers} layers"
          f" (depth cut so one card holds the f32 weights), d_model "
          f"{cfg.d_model}, {cfg.n_heads} q heads over {cfg.n_kv_heads} kv "
          f"heads of {cfg.resolved_head_dim}, d_ff {cfg.d_ff}, "
          f"{cfg.n_experts} experts top-{cfg.top_k}, capacity factor "
          f"{cfg.capacity_factor}, vocab {cfg.vocab_size}; "
          f"{n_params / 1e9:.4f} B f32 parameters ({n_params * 4 / 1e9:.2f} "
          f"GB) drawn from seed 0 on the {device} generator in {init_s:.2f}s"
          f" (one {tuple(leaf.shape)} expert leaf drawn on a CPU generator: "
          f"{cpu_leaf_s:.2f}s, so about "
          f"{cpu_leaf_s * n_params / leaf.numel():.0f}s for the whole "
          f"model) | {card}")
    del leaf
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                                (batch, prompt))
    fa = next(k for k in KERNELS if k.name == "flash_attention")
    # warm-up: the first prefill at these shapes pays for the allocator's
    # growth and the matrix products' first launches
    generate(cfg, params, prompts, 2, device=device)
    zero_launches(KERNELS)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with recorded_routes(moe, []) as routes:
        if on_card:
            gen, step = timed_decode_steps(
                torch, transformer,
                lambda: generate(cfg, params, prompts, new, device=device))
        else:
            gen, step = generate(cfg, params, prompts, new,
                                 device=device), [0.0]
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    phase_launches["moe-serve"] = read_launches(KERNELS)
    phase_routes["moe-serve"] = read_routes(KERNELS)
    L = cfg.n_layers
    fa_routes = phase_routes["moe-serve"][fa.name]
    want = expect({"flash_attention": L})
    if on_card and (phase_launches["moe-serve"] != want or fa_routes != {
            "wgmma": L, "mma_sync": 0, "simt": 0}):
        raise AssertionError(f"moe-serve launches {phase_launches['moe-serve']}"
                             f" by route {fa_routes}, expected {want}, all "
                             f"on the wgmma route")
    V = cfg.vocab_size
    toks = gen.tokens.cpu().numpy()
    if toks.shape != (batch, new) or toks.min() < 0 or toks.max() >= V \
            or gen.logits.shape != (batch, new, V) \
            or not bool(torch.isfinite(gen.logits).all()):
        raise AssertionError(f"bad generation: tokens {toks.shape}, logits "
                             f"{tuple(gen.logits.shape)}")
    if len(routes) != L * new:
        raise AssertionError(f"{len(routes)} routing calls, expected "
                             f"{L} x {new}")
    T, E = batch * prompt, cfg.n_experts
    cap = moe.capacity(cfg, T)
    dropped, load = [], torch.zeros(E, dtype=torch.int64, device=device)
    for idx in routes[:L]:
        flat = idx.reshape(T, -1)
        keep = moe._dispatch(flat, E, cap)[1]
        dropped.append(int((~keep).sum()))
        load += torch.bincount(flat[keep], minlength=E)
    load = load.cpu().tolist()
    dec_load = torch.bincount(torch.cat([r.reshape(-1) for r in routes[L:]]),
                              minlength=E).cpu().tolist()
    step = np.array(step)
    print(f"[moe-serve] batch {batch} x prompt {prompt}, {new} greedy tokens:"
          f" prefill {gen.prefill_s * 1e3:.3f} ms ({T / gen.prefill_s:.0f} "
          f"prompt tokens/s), decode median {np.median(step):.3f} ms/step "
          f"between steps' ends on CUDA events (min {step.min():.3f}, max "
          f"{step.max():.3f}), decode loop {gen.decode_s * 1e3:.3f} ms host "
          f"wall, {batch * (new - 1) / gen.decode_s:.1f} tokens/s decoding "
          f"(wall {wall:.3f}s); peak device memory {peak / 2**30:.3f} GiB; "
          f"flash_attention launches {phase_launches['moe-serve'][fa.name]} "
          f"= {L} layers x 1 prefill, by route {fa_routes} (Dh "
          f"{cfg.resolved_head_dim}, G {cfg.n_heads // cfg.n_kv_heads}) "
          f"| {card}")
    print(f"[moe-serve] capacity path (prefill): capacity {cap} rows per "
          f"expert for {T} tokens x top-{cfg.top_k}; dropped (token, expert)"
          f" pairs by layer {dropped} (total {sum(dropped)} of "
          f"{T * cfg.top_k * L}); kept load per expert over the layers "
          f"{load}; decode (dense dispatch, nothing dropped) routes per "
          f"expert {dec_load} | {card}")
    print(f"[moe-serve] tokens of sequence 0: {toks[0].tolist()} | {card}")
    del gen
    if on_card:
        moe_profiles(torch, cfg, params, prompts, card)
    del params


def moe_profiles(torch, cfg, params, prompts, card: str) -> None:
    """Phase 18a's prefill under ``torch.profiler`` (device ms by kind and
    by operation), then the busy share of 5 decode steps."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.serve_lm import generate

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        pre = generate(cfg, params, prompts, 1, device="cuda")
    rows = kineto_rows(torch, prof, ())[0]
    if not rows:
        print("[moe-serve] prefill device time: not measured (torch.profiler"
              " saw no device time)")
    else:
        busy, top = busy_and_top(rows, k=10)
        cats = ", ".join(f"{k} {v:.3f}" for k, v in by_category(rows).items())
        print(f"[moe-serve] profiled prefill: device busy {busy / 1e3:.3f} ms"
              f" of {pre.prefill_s * 1e3:.3f} ms host wall (profiler on); "
              f"device ms by kind: {cats}; by operation: | {card}")
        for us, name, count in top:
            print(f"[moe-serve]   {us / 1e3:9.3f} ms  x{count:<5d} "
                  f"{name[:70]} | {card}")
    del prof, pre
    with profile(activities=acts) as prof:
        generate(cfg, params, prompts, LM_PROFILE_NEW + 1, device="cuda")
    share = step_window_share(torch, prof, *PROFILE_WINDOW)
    if share is None:
        print("[moe-serve] device busy share: not measured (torch.profiler "
              "saw no device time in the window)")
    else:
        print(f"[moe-serve] device busy share {share[0]:.4f} over decode "
              f"steps {PROFILE_WINDOW[0]}-{sum(PROFILE_WINDOW) - 1} "
              f"({share[1]:.1f} ms, profiler on; idle {1 - share[0]:.4f}); "
              f"device ms by kind: " + ", ".join(
                  f"{k} {v:.3f}" for k, v in share[3].items()) + f" | {card}")
        for us, name, count in share[2]:
            print(f"[moe-serve]   {us / 1e3:9.3f} ms  x{count:<5d} "
                  f"{name[:70]} | {card}")


def moe_parity_phase(torch, np, card: str, phase_launches: dict,
                     phase_routes: dict) -> None:
    """Phase 18b: each MoE smoke config generated on the CPU (plain
    attention) and teacher-forced with its tokens on the card (kernels),
    every layer's routing recorded on both; the routing flips counted, and
    the logits of the rows routed the same way and the aux loss of a
    forward held within ``MOE_SMOKE_TOL``."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import KERNELS
    from repro_torch.launch.serve_lm import generate
    from repro_torch.models import moe, transformer
    from repro_torch.models.params import init_from_defs

    B, P, N = LM_SMOKE
    zero_launches(KERNELS)
    flash = 0
    for arch in MOE_PARITY:
        small = get_config(arch, smoke=True)
        L, E = small.n_layers, small.n_experts
        sp = init_from_defs(transformer.defs(small),
                            torch.Generator().manual_seed(0), "cpu")
        cp = {k: (v.cuda() if isinstance(v, torch.Tensor)
                  else {n: t.cuda() for n, t in v.items()})
              for k, v in sp.items()}
        prompts = np.random.default_rng(1).integers(0, small.vocab_size,
                                                    (B, P))
        with recorded_routes(moe, []) as cpu_routes:
            on_cpu = generate(small, sp, prompts, N, device="cpu")
        with recorded_routes(moe, []) as card_routes:
            on_card = teacher_forced(
                torch, transformer, small, cp,
                torch.from_numpy(prompts).cuda(),
                on_cpu.tokens.cuda())[0].float().cpu()
        cap = moe.capacity(small, B * P)
        rows = torch.ones(B, dtype=torch.bool)
        flips = 0
        for a, b in zip(cpu_routes[:L], card_routes[:L]):
            b = b.cpu()
            same = (expert_sets(torch, a, E) == expert_sets(torch, b, E)
                    ).all(-1)
            flips += int((~same).sum())
            # a flip anywhere moves the capacity ranks of later tokens, so
            # a row also needs every token's kept experts to agree
            ka = moe._dispatch(a.reshape(B * P, -1), E, cap)[1]
            kb = moe._dispatch(b.reshape(B * P, -1), E, cap)[1]
            kept = (expert_sets(torch, a, E, ka)
                    == expert_sets(torch, b, E, kb)).all(-1)
            rows &= same.all(-1) & kept.all(-1)
        ok = [rows.clone()]
        cur = rows.clone()
        for i in range(N - 1):
            for a, b in zip(cpu_routes[L * (1 + i):L * (2 + i)],
                            card_routes[L * (1 + i):L * (2 + i)]):
                same = (expert_sets(torch, a, E)
                        == expert_sets(torch, b.cpu(), E)).all(-1)[:, 0]
                flips += int((~same).sum())
                cur &= same
            ok.append(cur.clone())
        ok = torch.stack(ok, 1)  # (B, N): position routed the same way
        want = on_cpu.logits.float()
        if not bool(ok.any()):
            raise AssertionError(f"{arch} smoke: no position routed the same "
                                 f"way on the card and the CPU")
        torch.testing.assert_close(
            on_card[ok], want[ok], **MOE_SMOKE_TOL,
            msg=lambda m: f"{arch} smoke card vs CPU, positions routed the "
            f"same way: {m}")
        diff = (on_card - want).abs().amax(-1)
        toks = torch.from_numpy(prompts)
        with torch.inference_mode():
            _, aux_cpu = transformer.forward(small, sp, toks)
            _, aux_card = transformer.forward(small, cp, toks.cuda())
        aux_diff = abs(float(aux_card) - float(aux_cpu))
        if not aux_diff <= MOE_SMOKE_TOL["atol"] + MOE_SMOKE_TOL["rtol"] * \
                abs(float(aux_cpu)):
            raise AssertionError(f"{arch} smoke aux loss card {float(aux_card)}"
                                 f" vs CPU {float(aux_cpu)}")
        flash += 2 * L  # the teacher-forced prefill and the forward
        print(f"[moe-parity] {small.name} ({E} experts, top-{small.top_k}) "
              f"batch {B} x prompt {P}, {N} tokens: card (kernels, "
              f"teacher-forced with the CPU's tokens) vs CPU (plain "
              f"versions): routing flips {flips} of "
              f"{L * (B * P + B * (N - 1))} (layer, token) routings; "
              f"positions routed the same way {int(ok.sum())} of {ok.numel()}"
              f", their max |logit diff| {float(diff[ok].max()):.4e} "
              f"({MOE_SMOKE_TOL}; median |logit| "
              f"{float(want.abs().median()):.4e}); aux loss "
              f"{float(aux_card):.6f} vs {float(aux_cpu):.6f} (|diff| "
              f"{aux_diff:.3e}) | {card}")
    phase_launches["moe-parity"] = read_launches(KERNELS)
    phase_routes["moe-parity"] = read_routes(KERNELS)
    want = expect({"flash_attention": flash})
    if phase_launches["moe-parity"] != want or phase_routes["moe-parity"][
            "flash_attention"]["mma_sync"] != flash:
        raise AssertionError(f"moe-parity launches "
                             f"{phase_launches['moe-parity']} by route "
                             f"{phase_routes['moe-parity']}, expected {want} "
                             f"on mma_sync (head dim 16)")


# ---- the SSM, hybrid and encoder-decoder families, chameleon (19-21) -------

def flash_per_prefill(cfg) -> int:
    """``flash_attention`` launches of one prefill of ``cfg``: one per
    layer (decoder-only), one per place of the shared block (hybrid), none
    (SSM), encoder self + decoder self + cross per layer (encoder-decoder).
    Decode runs none."""
    from repro_torch.models import ssm_lm

    if cfg.family in ("ssm", "hybrid"):
        return ssm_lm._n_groups(cfg)[0]
    if cfg.family in ("encdec", "audio"):
        return cfg.n_enc_layers + 2 * cfg.n_dec_layers
    return cfg.n_layers


def serving_inputs(torch, np, cfg, batch: int, prompt: int, device):
    """The prompts (numpy, seed 1) and, for the encoder-decoder families,
    frames (batch, prompt, d_model) from ``default_rng(0)`` with prompts
    of ``target_len(cfg, prompt)`` tokens (the serving CLI's draws)."""
    from repro_torch.launch.serve_lm import ENCDEC_FAMILIES, target_len

    frames, P = None, prompt
    if cfg.family in ENCDEC_FAMILIES:
        frames = torch.from_numpy(np.random.default_rng(0).normal(
            size=(batch, prompt, cfg.d_model)).astype(np.float32)).to(device)
        P = target_len(cfg, prompt)
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                                (batch, P))
    return prompts, frames


def event_ms(torch, fn, n: int = 5) -> float:
    """Median device ms of ``fn()`` over ``n`` calls after one warm-up,
    CUDA events around each call."""
    fn()
    times = []
    for _ in range(n):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[n // 2]


def defs_count(defs) -> int:
    """Parameters of a ``Def`` tree, without materializing it."""
    if isinstance(defs, dict):
        return sum(defs_count(v) for v in defs.values())
    n = 1
    for d in defs.shape:
        n *= d
    return n


def ssd_kinds(rows) -> dict:
    """Device ms of a profiled ``ssd_chunked`` by kind: its einsums
    (cuBLAS batched products), exp and cumsum, copies and casts, the rest
    (masks, products and sums of the (B, c, H, Q, Q) tensors)."""
    out = {"einsum": 0.0, "exp/cumsum": 0.0, "copy/cast": 0.0, "other": 0.0}
    for s, t, name in rows:
        n = name.lower()
        if any(w in n for w in ("gemm", "gemv", "nvjet", "xmma", "cutlass")):
            key = "einsum"
        elif "exp" in n or "scan" in n or "cumsum" in n:
            key = "exp/cumsum"
        elif "copy" in n or "memcpy" in n or "memset" in n:
            key = "copy/cast"
        else:
            key = "other"
        out[key] += (t - s) / 1e3
    return out


def mixer_breakdown(torch, np, cfg, params, prompts, prefill_ms: float,
                    tag: str, card: str) -> None:
    """One Mamba2 layer of the prefill (layer 0's mixer input: the first
    entry of the schedule, after the embedding and its pre-norm) piece by
    piece on CUDA events: the five projections, the three causal
    convolutions, ``ssd_chunked`` (and what it allocates beyond its
    inputs), the whole mixer; the SSD's share of the prefill over all
    layers; then ``ssd_chunked`` alone under torch.profiler by kind."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import mamba2, ssm_lm
    from repro_torch.models.layers import rms_norm

    p = {n: a[0] for n, a in params["layers"].items()}
    B, S = prompts.shape
    H, P_, N, G = cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state, \
        cfg.ssm_ngroups
    with torch.inference_mode():
        x = rms_norm(ssm_lm._embed(params, torch.from_numpy(prompts).cuda()),
                     p["pre_norm"], cfg.norm_eps)
        z, xr, Br, Cr, dt = mamba2._project(cfg, p, x)
        convs = [(t, p[f"conv_{n}_w"], p[f"conv_{n}_b"])
                 for t, n in ((xr, "x"), (Br, "B"), (Cr, "C"))]
        xc, Bc, Cc = (mamba2.causal_conv(*a) for a in convs)
        A = -torch.exp(p["A_log"].float())
        args = (xc.reshape(B, S, H, P_), dt, A, Bc.reshape(B, S, G, N),
                Cc.reshape(B, S, G, N), p["D"], cfg.ssd_chunk)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        mamba2.ssd_chunked(*args)
        torch.cuda.synchronize()
        ssd_bytes = torch.cuda.max_memory_allocated() - before
        ms = {"projections": event_ms(torch, lambda: mamba2._project(cfg, p,
                                                                     x)),
              "convs": event_ms(torch, lambda: [mamba2.causal_conv(*a)
                                                for a in convs]),
              "ssd_chunked": event_ms(torch,
                                      lambda: mamba2.ssd_chunked(*args)),
              "mamba_block": event_ms(torch,
                                      lambda: mamba2.mamba_block(cfg, p, x))}
        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        with profile(activities=acts) as prof:
            for _ in range(SSD_PROFILED + 1):  # the first: warm-up
                with torch.profiler.record_function("ssd_call"):
                    mamba2.ssd_chunked(*args)
                    torch.cuda.synchronize()
    rows, at = kineto_rows(torch, prof, ("ssd_call",))
    calls = sorted(at["ssd_call"])
    rows = (window_rows(rows, calls[1][0], calls[-1][1])
            if len(calls) == SSD_PROFILED + 1 else [])
    L = cfg.n_layers
    c = -(-S // cfg.ssd_chunk)
    print(f"{tag} one Mamba2 layer of the prefill ({B} x {S}, {H} heads of "
          f"{P_}, state {N}, chunk {cfg.ssd_chunk}: {c} chunks) on CUDA "
          f"events, ms: " + ", ".join(f"{k} {v:.3f}" for k, v in ms.items())
          + f"; ssd_chunked allocates {ssd_bytes / 2**30:.3f} GiB beyond its "
          f"inputs (one (B, c, H, Q, Q) f32 tensor is "
          f"{B * c * H * cfg.ssd_chunk ** 2 * 4 / 2**30:.3f} GiB); over {L} "
          f"layers the SSD is {L * ms['ssd_chunked']:.3f} ms, "
          f"{L * ms['ssd_chunked'] / prefill_ms:.4f} of the {prefill_ms:.3f}"
          f" ms prefill, the mixers {L * ms['mamba_block']:.3f} ms | {card}")
    busy, top = busy_and_top(rows, k=8)
    seen = busy / 1e3 / SSD_PROFILED / ms["ssd_chunked"]
    if seen < 0.9:  # the trace lost kernels: no breakdown from it
        print(f"{tag} profiled ssd_chunked (layer 0) by kind: not measured "
              f"(the trace holds {seen:.3f} of the CUDA-event time) | {card}")
        return
    print(f"{tag} profiled ssd_chunked (layer 0), ms a call over "
          f"{SSD_PROFILED} calls: device busy {busy / 1e3 / SSD_PROFILED:.3f}"
          f" ({seen:.3f} of the CUDA-event time); by kind: " + ", ".join(
              f"{k} {v / SSD_PROFILED:.3f}"
              for k, v in ssd_kinds(rows).items())
          + f"; by operation (summed over the calls): | {card}")
    for us, name, count in top:
        print(f"{tag}   {us / 1e3:9.3f} ms  x{count:<5d} {name[:70]} "
              f"| {card}")


def family_profiles(torch, np, cfg, params, prompts, frames, prefill_ms,
                    tag: str, card: str, decode: bool = True) -> None:
    """A profiled prefill's device time by kind and by operation (and, for
    the Mamba2 families, ``mixer_breakdown``), then (``decode``) the busy
    share of 5 profiled decode steps."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.serve_lm import generate

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        pre = generate(cfg, params, prompts, 1, frames=frames, device="cuda")
    rows = kineto_rows(torch, prof, ())[0]
    if not rows:
        print(f"{tag} prefill device time: not measured (torch.profiler saw "
              f"no device time)")
    else:
        busy, top = busy_and_top(rows, k=10)
        cats = ", ".join(f"{k} {v:.3f}" for k, v in by_category(rows).items())
        print(f"{tag} profiled prefill: device busy {busy / 1e3:.3f} ms of "
              f"{pre.prefill_s * 1e3:.3f} ms host wall (profiler on); device"
              f" ms by kind: {cats}; by operation: | {card}")
        for us, name, count in top:
            print(f"{tag}   {us / 1e3:9.3f} ms  x{count:<5d} {name[:70]} "
                  f"| {card}")
    del prof, pre
    if cfg.family in ("ssm", "hybrid"):
        mixer_breakdown(torch, np, cfg, params, prompts, prefill_ms, tag,
                        card)
    if not decode:
        return
    with profile(activities=acts) as prof:
        generate(cfg, params, prompts, LM_PROFILE_NEW + 1, frames=frames,
                 device="cuda")
    share = step_window_share(torch, prof, *PROFILE_WINDOW)
    if share is None:
        print(f"{tag} device busy share: not measured (torch.profiler saw no"
              f" device time in the window)")
    else:
        print(f"{tag} device busy share {share[0]:.4f} over decode steps "
              f"{PROFILE_WINDOW[0]}-{sum(PROFILE_WINDOW) - 1} ({share[1]:.1f}"
              f" ms, profiler on; idle {1 - share[0]:.4f}); device ms by "
              f"kind: " + ", ".join(f"{k} {v:.3f}" for k, v in
                                    share[3].items()) + f" | {card}")
        for us, name, count in share[2]:
            print(f"{tag}   {us / 1e3:9.3f} ms  x{count:<5d} {name[:70]} "
                  f"| {card}")


def family_serve_phase(torch, np, card: str, phase_launches: dict,
                       phase_routes: dict, arch: str, n_layers: int = 0,
                       cfg=None, batch: int = LM_BATCH,
                       prompt: int = LM_PROMPT, new: int = FAMILY_NEW,
                       device: str = "cuda", phase: str = "",
                       decode_profile: bool = True) -> None:
    """Phases 19-21 and 26: ``arch`` at full width (``n_layers`` of its
    layers when given: a depth cut, named in the output), seed-0 weights
    drawn on the card; after a warm-up, ``generate`` of ``new`` greedy
    tokens after ``batch`` x ``prompt`` prompts (the encoder-decoder:
    ``prompt`` frames and ``target_len`` prompt tokens): prefill ms, decode
    ms a step, peak memory, ``flash_attention`` launches
    (``flash_per_prefill``, all on ``wgmma``) and, on the card,
    ``family_profiles`` (the decode profile only with ``decode_profile``).
    ``phase`` names the launch counts (default ``<family>-serve``).  ``cfg``
    (a smoke config) and ``device="cpu"`` make a CPU dry run."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import KERNELS
    from repro_torch.launch.serve_lm import generate
    from repro_torch.models import get_module
    from repro_torch.models.params import init_from_defs
    from repro_torch.train.optimizer import tree_leaves

    full = get_config(arch)
    cfg = cfg or (dataclasses.replace(full, n_layers=n_layers) if n_layers
                  else full)
    mod = get_module(cfg)
    on_card = device != "cpu"
    phase = phase or f"{cfg.family}-serve"
    tag = f"[{phase}]"
    t0 = time.perf_counter()
    params = init_from_defs(mod.defs(cfg),
                            torch.Generator(device=device).manual_seed(0),
                            device)
    if on_card:
        torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree_leaves(params))
    if cfg.n_layers != full.n_layers and cfg.name == full.name:
        depth = (f"{cfg.n_layers} of {full.n_layers} layers (the depth cut "
                 f"so that one card holds the f32 weights: all "
                 f"{full.n_layers} are {defs_count(mod.defs(full)) * 4 / 1e9:.1f}"
                 f" GB)")
    else:
        depth = f"{cfg.n_layers} layers"
    if cfg.family in ("encdec", "audio"):
        depth += f": {cfg.n_enc_layers} encoder + {cfg.n_dec_layers} decoder"
    print(f"{tag} {cfg.name}: {depth}, d_model {cfg.d_model}, "
          + (f"{cfg.ssm_nheads} SSD heads of {cfg.ssm_headdim}, state "
             f"{cfg.ssm_state}, chunk {cfg.ssd_chunk}, "
             if cfg.family in ("ssm", "hybrid") else "")
          + (f"{cfg.n_heads} q heads over {cfg.n_kv_heads} kv heads of "
             f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, "
             if cfg.n_heads else "")
          + f"vocab {cfg.vocab_size}; {n_params / 1e9:.4f} B f32 parameters"
          f" ({n_params * 4 / 1e9:.2f} GB) drawn from seed 0 on the {device}"
          f" generator in {init_s:.2f}s | {card}")
    prompts, frames = serving_inputs(torch, np, cfg, batch, prompt, device)
    want_flash = flash_per_prefill(cfg)
    generate(cfg, params, prompts, 2, frames=frames, device=device)
    zero_launches(KERNELS)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    if on_card:
        gen, step = timed_decode_steps(
            torch, mod, lambda: generate(cfg, params, prompts, new,
                                         frames=frames, device=device))
    else:
        gen, step = generate(cfg, params, prompts, new, frames=frames,
                             device=device), [0.0]
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    phase_launches[phase] = read_launches(KERNELS)
    phase_routes[phase] = read_routes(KERNELS)
    fa_routes = phase_routes[phase]["flash_attention"]
    want = expect({"flash_attention": want_flash})
    if on_card and (phase_launches[phase] != want or fa_routes != {
            "wgmma": want_flash, "mma_sync": 0, "simt": 0}):
        raise AssertionError(f"{phase} launches {phase_launches[phase]} by "
                             f"route {fa_routes}, expected {want}, all on "
                             f"the wgmma route")
    V = cfg.vocab_size
    toks = gen.tokens.cpu().numpy()
    if toks.shape != (batch, new) or toks.min() < 0 or toks.max() >= V \
            or gen.logits.shape != (batch, new, V) \
            or not bool(torch.isfinite(gen.logits).all()):
        raise AssertionError(f"bad generation: tokens {toks.shape}, logits "
                             f"{tuple(gen.logits.shape)}")
    step = np.array(step)
    P = prompts.shape[1]
    what = (f"{prompt} frames and {P}-token prompts" if frames is not None
            else f"prompt {P}")
    print(f"{tag} batch {batch} x {what}, {new} greedy tokens: prefill "
          f"{gen.prefill_s * 1e3:.3f} ms ({batch * prompt / gen.prefill_s:.0f}"
          f" {'frames' if frames is not None else 'prompt tokens'}/s), decode"
          f" median {np.median(step):.3f} ms/step between steps' ends on CUDA"
          f" events (min {step.min():.3f}, max {step.max():.3f}), decode "
          f"loop {gen.decode_s * 1e3:.3f} ms host wall, "
          f"{batch * (new - 1) / gen.decode_s:.1f} tokens/s decoding (wall "
          f"{wall:.3f}s); peak device memory {peak / 2**30:.3f} GiB; "
          f"flash_attention launches {phase_launches[phase]['flash_attention']}"
          f" = {want_flash} a prefill, by route {fa_routes} | {card}")
    print(f"{tag} tokens of sequence 0: {toks[0].tolist()} | {card}")
    prefill_ms = gen.prefill_s * 1e3
    del gen
    if on_card:
        family_profiles(torch, np, cfg, params, prompts, frames, prefill_ms,
                        tag, card, decode=decode_profile)
    del params


def to_device(tree, device):
    """A nested dict of tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


def family_parity_phase(torch, np, card: str, phase_launches: dict,
                        phase_routes: dict) -> None:
    """The smoke configs of ``FAMILY_PARITY`` generated on the CPU (plain
    attention) and teacher-forced with those tokens on the card (kernels)
    and on the CPU: logits within ``FAMILY_SMOKE_TOL[arch]`` and, for the SSM
    families, the final state ``h`` within ``H_TOL_OF_MAX[arch]`` of its
    largest entry; one prefill's ``flash_attention`` launches per config,
    on ``mma_sync`` (head dim 16)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import KERNELS
    from repro_torch.launch.serve_lm import generate
    from repro_torch.models import get_module
    from repro_torch.models.params import init_from_defs

    B, P, N = LM_SMOKE
    zero_launches(KERNELS)
    flash = 0
    for arch in FAMILY_PARITY:
        small = get_config(arch, smoke=True)
        mod = get_module(small)
        sp = init_from_defs(mod.defs(small), torch.Generator().manual_seed(0),
                            "cpu")
        prompts, frames = serving_inputs(torch, np, small, B, P, "cpu")
        on_cpu = generate(small, sp, prompts, N, frames=frames, device="cpu")
        inputs = torch.from_numpy(prompts)
        if frames is not None:
            inputs = {"frames": frames, "tokens": inputs}
        cpu_logits, cpu_state = teacher_forced(torch, mod, small, sp, inputs,
                                               on_cpu.tokens)
        card_logits, card_state = teacher_forced(
            torch, mod, small, to_device(sp, "cuda"),
            to_device(inputs, "cuda"), on_cpu.tokens.cuda())
        flash += flash_per_prefill(small)
        card_logits = card_logits.float().cpu()
        tol = FAMILY_SMOKE_TOL[arch]
        torch.testing.assert_close(
            card_logits, cpu_logits.float(), **tol,
            msg=lambda m: f"{arch} smoke card vs CPU: {m}")
        diff = float((card_logits - cpu_logits.float()).abs().max())
        same = float((card_logits.argmax(-1) == on_cpu.tokens).float().mean())
        h_err = ""
        if "h" in cpu_state:
            hc, hg = cpu_state["h"], card_state["h"].cpu()
            err = float((hg - hc).abs().max()) / float(hc.abs().max())
            if not err <= H_TOL_OF_MAX[arch]:
                raise AssertionError(f"{arch} smoke card vs CPU: state h "
                                     f"max |diff| / max |h| {err:.4e}")
            h_err = (f"; final state h max |diff| / max |h| {err:.4e} "
                     f"({H_TOL_OF_MAX[arch]})")
        print(f"[family-parity] {small.name} batch {B} x prompt "
              f"{prompts.shape[1]}{' (after ' + str(P) + ' frames)' if frames is not None else ''}"
              f", {N} tokens: card (kernels, teacher-forced with the CPU's "
              f"tokens) vs CPU (plain versions): max |logit diff| "
              f"{diff:.4e} ({tol}; median |logit| "
              f"{float(cpu_logits.float().abs().median()):.4e}), greedy "
              f"tokens equal at {same:.4f} of the positions{h_err} | {card}")
    phase_launches["family-parity"] = read_launches(KERNELS)
    phase_routes["family-parity"] = read_routes(KERNELS)
    want = expect({"flash_attention": flash})
    if phase_launches["family-parity"] != want or phase_routes[
            "family-parity"]["flash_attention"]["mma_sync"] != flash:
        raise AssertionError(f"family-parity launches "
                             f"{phase_launches['family-parity']} by route "
                             f"{phase_routes['family-parity']}, expected "
                             f"{want} on mma_sync (head dim 16)")


# ---- family training (phases 22-24) -----------------------------------------

def flat_named(tree, prefix: str = "") -> list:
    """(path, tensor) of a nested dict of tensors in sorted-key order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in flat_named(tree[k], f"{prefix}{k}/")]
    return [(prefix.rstrip("/"), tree)]


def loss_and_grads(torch, mod, cfg, params, batch):
    """The family's ``loss_fn`` and its gradients at ``params`` (left as
    they were): (loss, {path: gradient}), a zero gradient for a leaf the
    loss does not reach."""
    from repro_torch.train.optimizer import tree_map

    leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss, _ = mod.loss_fn(cfg, leaves, batch)
    loss.backward()
    return loss.detach(), {k: (p.grad if p.grad is not None
                               else torch.zeros_like(p))
                           for k, p in flat_named(leaves)}


def moe_checks(torch, cfg, params, batch, card: str, tag: str) -> str:
    """The MoE cell's checks before it trains: two forward + backward
    passes from the same weights and batch, bit for bit the same loss and
    gradients (the overflow row's gradient is a sum over colliding slots in
    an order the card does not fix, but the row is discarded); in the
    first, every layer's routing recorded in the forward and again in the
    remat recompute: the same top-k ids, capacity ranks, kept pairs and
    slots.  Returns the share of (token, expert) pairs the forward
    dropped, for the cell's line."""
    from repro_torch.models import moe, transformer

    routes = []
    with recorded_routes(moe, routes):
        loss_a, grads_a = loss_and_grads(torch, transformer, cfg, params,
                                         batch)
    loss_b, grads_b = loss_and_grads(torch, transformer, cfg, params, batch)
    L, E, K = cfg.n_layers, cfg.n_experts, cfg.top_k
    if len(routes) != 2 * L:
        raise AssertionError(f"{tag} {len(routes)} routing calls in one "
                             f"training pass, expected {L} + {L} recomputed")
    T = routes[0].numel() // K
    cap = moe.capacity(cfg, T)
    dropped = 0
    for layer, (fwd, again) in enumerate(zip(routes[:L], routes[L:][::-1])):
        a = moe._dispatch(fwd.reshape(T, K), E, cap)
        b = moe._dispatch(again.reshape(T, K), E, cap)
        if not (torch.equal(fwd, again)
                and all(torch.equal(x, y) for x, y in zip(a, b))):
            raise AssertionError(f"{tag} layer {layer}: the remat recompute "
                                 f"routed other experts or slots than the "
                                 f"forward")
        dropped += int((~a[1]).sum())
    differ = [k for k in grads_a if not torch.equal(grads_a[k], grads_b[k])]
    if not torch.equal(loss_a, loss_b) or differ:
        raise AssertionError(f"{tag} two identical passes differ: loss "
                             f"{float(loss_a)} vs {float(loss_b)}, gradients "
                             f"{differ}")
    share = dropped / (T * K * L)
    print(f"{tag} MoE routing: the remat recompute of each of the {L} layers"
          f" routed every one of {T} tokens to the same top-{K} experts, "
          f"ranks, kept pairs and slots as the forward; two identical "
          f"forward + backward passes gave the same loss bits "
          f"({float(loss_a):.6f}) and the same bits in all {len(grads_a)} "
          f"gradients; dropped (token, expert) pairs {dropped} of "
          f"{T * K * L} ({share:.4f}; capacity {cap} rows per expert) "
          f"| {card}")
    return f"{share:.4f} of the (token, expert) pairs dropped"


def moe_backward_by_op(torch, cfg, params, tokens, card: str,
                       tag: str, n: int = 3) -> None:
    """Layer 0's MoE block (its input captured from a forward of the
    batch) forward and backward ``n`` times after a warm-up, on CUDA events
    and under torch.profiler: the backward's device ms by autograd node
    (the ``index_add_`` into the expert buffers, the combine's gather, the
    experts' ``bmm``s, the rest)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import moe, transformer

    seen, inner = [], moe.moe_block

    def capture(cfg_, p, x, **kw):
        if not seen:
            seen.append(x.detach().clone())
        return inner(cfg_, p, x, **kw)

    moe.moe_block = capture
    try:
        with torch.no_grad():
            transformer.forward_hidden(cfg, params, tokens)
    finally:
        moe.moe_block = inner
    x = seen[0].requires_grad_()
    p = {k: params["layers"][k][0].detach().requires_grad_()
         for k in ("router", "w_gate", "w_up", "w_down")}
    dout = torch.randn(x.shape, generator=torch.Generator(
        device="cuda").manual_seed(14), device="cuda").to(x.dtype)

    def run():
        out, aux = moe.moe_block(cfg, p, x, mode="train")
        torch.autograd.backward((out, aux), (dout, torch.ones_like(aux)))

    def fwd():
        with torch.no_grad():
            moe.moe_block(cfg, p, x, mode="train")

    whole, forward = event_ms(torch, run), event_ms(torch, fwd)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        for _ in range(n):
            run()
        torch.cuda.synchronize()
    nodes = {}
    for e in prof.key_averages():
        if e.key.startswith("autograd::engine::evaluate_function: "):
            us = getattr(e, "device_time_total", None)
            if us is None:
                us = e.cuda_time_total
            node = e.key.split(": ", 1)[1]
            nodes[node] = nodes.get(node, 0.0) + us / 1e3 / n
    named = {"IndexAddBackward0": "index_add_ (a gather of the buffers' "
             "gradient)", "IndexBackward0": "the combine's gather (an "
             "index_put_ with accumulation)",
             "BmmBackward0": "the experts' 3 bmm"}
    total = sum(nodes.values())
    if total <= 0:
        print(f"{tag} layer 0's MoE block backward by op: not measured "
              f"(torch.profiler attributed no device time to the autograd "
              f"nodes); forward + backward {whole:.3f} ms, forward "
              f"{forward:.3f} ms on CUDA events | {card}")
        return
    parts = [f"{what} {nodes.get(k, 0.0):.3f}" for k, what in named.items()]
    rest = total - sum(nodes.get(k, 0.0) for k in named)
    top = sorted(((v, k) for k, v in nodes.items() if k not in named),
                 reverse=True)[:4]
    print(f"{tag} layer 0's MoE block ({tuple(x.shape)} in, capacity "
          f"{moe.capacity(cfg, x.shape[0] * x.shape[1])}) on CUDA events: "
          f"forward + backward {whole:.3f} ms, forward {forward:.3f} ms, so "
          f"backward about {whole - forward:.3f} ms; the backward's device "
          f"ms by autograd node (profiled, {n} runs): " + ", ".join(parts)
          + f", the rest {rest:.3f} (" + ", ".join(
              f"{k} {v:.3f}" for v, k in top) + f"); nodes in all "
          f"{total:.3f} | {card}")


def ssd_train_share(torch, cfg, params, tokens, step_ms: float, tag: str,
                    card: str) -> None:
    """Layer 0's ``ssd_chunked`` at the training batch (its inputs from the
    embedding, pre-norm, projections and convolutions of ``tokens``) on
    CUDA events: the forward alone, and forward + backward at a random
    output gradient.  A remat step runs the SSD forward twice (the
    checkpointed forward, the recompute) and its backward once a layer, so
    over the layers the backward is L x (both - forward) and the SSD in all
    L x (forward + both), each printed as a share of ``step_ms`` (the
    step's median on CUDA events)."""
    from repro_torch.models import mamba2, ssm_lm
    from repro_torch.models.layers import rms_norm

    p = {n: a[0] for n, a in params["layers"].items()}
    B, S = tokens.shape
    H, P_, N, G = cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state, \
        cfg.ssm_ngroups
    with torch.no_grad():
        x = rms_norm(ssm_lm._embed(params, tokens), p["pre_norm"],
                     cfg.norm_eps)
        _, xr, Br, Cr, dt = mamba2._project(cfg, p, x)
        xc, Bc, Cc = (mamba2.causal_conv(t, p[f"conv_{n}_w"], p[f"conv_{n}_b"])
                      for t, n in ((xr, "x"), (Br, "B"), (Cr, "C")))
        A = -torch.exp(p["A_log"].float())
    ins = [t.detach().requires_grad_() for t in (
        xc.reshape(B, S, H, P_), dt, A, Bc.reshape(B, S, G, N),
        Cc.reshape(B, S, G, N), p["D"])]
    del x, xr, Br, Cr, dt, xc, Bc, Cc
    dy = torch.randn((B, S, H, P_), generator=torch.Generator(
        device="cuda").manual_seed(15), device="cuda")

    def forward():
        with torch.no_grad():
            mamba2.ssd_chunked(*ins, cfg.ssd_chunk)

    def both():
        y, _ = mamba2.ssd_chunked(*ins, cfg.ssd_chunk)
        torch.autograd.grad(y, ins, dy)

    fwd, fb = event_ms(torch, forward), event_ms(torch, both)
    y, _ = mamba2.ssd_chunked(*ins, cfg.ssd_chunk)
    grads = torch.autograd.grad(y, ins, dy)
    if not all(bool(torch.isfinite(g).all()) for g in grads):
        raise AssertionError(f"{tag} ssd_chunked's gradients at chunk "
                             f"{cfg.ssd_chunk} are not finite")
    del y, grads
    L = cfg.n_layers
    print(f"{tag} layer 0's ssd_chunked at the training batch ({B} x {S}, "
          f"chunk {cfg.ssd_chunk}; its gradients for x, dt, A, B, C and D "
          f"all finite) on"
          f" CUDA events: forward {fwd:.3f} ms, forward + backward {fb:.3f} "
          f"ms; over {L} layers the SSD's backward {L * (fb - fwd):.3f} ms, "
          f"{L * (fb - fwd) / step_ms:.4f} of the {step_ms:.3f} ms step, and"
          f" the SSD with its forward and recompute {L * (fwd + fb):.3f} ms, "
          f"{L * (fwd + fb) / step_ms:.4f} | {card}")


def family_train_phase(torch, np, card: str, phase_launches: dict,
                       phase_routes: dict, arch: str, n_layers: int = 0,
                       loss_chunk: int = 0, cfg=None, batch: int = LM_BATCH,
                       seq: int = LM_PROMPT,
                       steps: int = FAMILY_TRAIN_STEPS,
                       device: str = "cuda", phase: str = "") -> None:
    """Phases 22-23 and 26: ``arch`` at full width (``n_layers`` of its layers
    when given, a depth cut named in the output; ``loss_chunk`` > 0 sums the
    CE in chunks) from seed-0 weights drawn on the card's generator, as the
    serving phases draw them; ``steps`` of ``train_step`` at ``batch`` x
    ``seq`` (the encoder-decoder: ``seq`` frames and ``target_len`` target
    tokens), remat on, AdamW with the state handed over: finite losses,
    the median step of steps 2.. (host wall), tokens/s, forward, backward
    and AdamW ms on CUDA events, peak memory, the attention kernels'
    launches each step by route (``flash_per_prefill`` forward, again in the
    recompute, once backward, all ``wgmma``), then one profiled step by kind.
    The MoE config first runs ``moe_checks``, and after training
    ``moe_backward_by_op``.  ``phase`` names the launch counts (default
    ``<family>-train``).  ``cfg`` (a smoke config) and ``device="cpu"``
    make a CPU dry run."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import KERNELS
    from repro_torch.kernels import flash_attention as fam
    from repro_torch.launch.serve_lm import ENCDEC_FAMILIES, target_len
    from repro_torch.launch.train import make_batch
    from repro_torch.models import get_module
    from repro_torch.models.params import init_from_defs

    full = get_config(arch)
    cfg = cfg or dataclasses.replace(full, n_layers=n_layers or full.n_layers,
                                     loss_chunk=loss_chunk)
    mod = get_module(cfg)
    on_card = device != "cpu"
    phase = phase or f"{cfg.family}-train"
    tag = f"[{phase}]"
    n_params = defs_count(mod.defs(cfg))
    if cfg.n_layers != full.n_layers and cfg.name == full.name:
        depth = (f"{cfg.n_layers} of {full.n_layers} layers (the depth cut so"
                 f" that one card holds the f32 params, gradients, AdamW's m"
                 f" and v and the new params: all {full.n_layers} layers are"
                 f" {defs_count(mod.defs(full)) * 16 / 1e9:.1f} GB at 16 bytes"
                 f" a parameter)")
    else:
        depth = f"{cfg.n_layers} layers"
    if cfg.family in ENCDEC_FAMILIES:
        depth += f": {cfg.n_enc_layers} encoder + {cfg.n_dec_layers} decoder"
        what = (f"{seq} frames and a {target_len(cfg, seq)}-token target")
        tokens = batch * target_len(cfg, seq)
    else:
        what, tokens = f"seq {seq}", batch * seq
    t0 = time.perf_counter()
    params = init_from_defs(mod.defs(cfg),
                            torch.Generator(device=device).manual_seed(0),
                            device)
    if on_card:
        torch.cuda.synchronize()
    print(f"{tag} {cfg.name}: {depth}, d_model {cfg.d_model}; "
          f"{n_params / 1e9:.4f} B f32 parameters ({n_params * 16 / 1e9:.2f} "
          f"GB with gradients, m and v) from seed 0 on the {device} generator"
          f" (the serving phases' draw) in {time.perf_counter() - t0:.2f}s; "
          f"batch {batch} x {what}, remat {cfg.remat}, loss chunk "
          f"{cfg.loss_chunk or 'none'}, AdamW lr {LM_TRAIN_LR} with the "
          f"state handed over, {steps} steps (the first warm-up) | {card}")
    moe_note = ""
    if cfg.n_experts:
        moe_note = "; " + moe_checks(
            torch, cfg, params, make_batch(cfg, batch, seq, 0, 0, device),
            card, tag)
    n_flash = flash_per_prefill(cfg)
    zero_launches(KERNELS)
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    marks = [] if on_card else None
    held = [params]
    del params  # the steps hold the only reference: one copy at a time
    losses, walls, params = lm_train(torch, np, fam, cfg, held.pop(), batch,
                                     seq, steps, device, marks=marks,
                                     donate=True)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    reserved = torch.cuda.max_memory_reserved() if on_card else 0
    phase_launches[phase] = read_launches(KERNELS)
    phase_routes[phase] = read_routes(KERNELS)
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{tag} losses {losses}")
    on_wgmma = {"wgmma": n_flash, "mma_sync": 0, "simt": 0}
    again = n_flash if cfg.remat else 0
    if on_card:
        for i, m in enumerate(marks):
            (f0, b0), (f1, b1), (f2, b2) = (m["start_routes"],
                                            m["fwd_routes"], m["end_routes"])
            got = ({r: f1[r] - f0[r] for r in f0},
                   {r: f2[r] - f1[r] for r in f0},
                   {r: b2[r] - b1[r] for r in b0}, b1 == b0)
            want = (on_wgmma, {"wgmma": again, "mma_sync": 0, "simt": 0},
                    {"wgmma": n_flash, "mma_sync": 0}, True)
            if got != want:
                raise AssertionError(f"{tag} step {i}: forward, recompute, "
                                     f"backward launches {got[:3]}, "
                                     f"expected {want[:3]}")
        want = expect({"flash_attention": (n_flash + again) * steps,
                       "flash_attention_bwd": n_flash * steps})
        if phase_launches[phase] != want:
            raise AssertionError(f"{tag} launches {phase_launches[phase]}, "
                                 f"expected {want}")
    walls = np.array(walls[1:] or walls) * 1e3  # the first is warm-up
    dev = ({k: np.median([m[a].elapsed_time(m[b]) for m in marks[1:]])
            for k, a, b in (("forward", "start", "fwd"),
                            ("backward", "fwd", "opt"),
                            ("optimizer", "opt", "end"),
                            ("step", "start", "end"))}
           if on_card else dict.fromkeys(("forward", "backward", "optimizer",
                                          "step"), 0.0))
    unit = "target tokens" if cfg.family in ENCDEC_FAMILIES else "tokens"
    extra = (f", {batch * seq / np.median(walls) * 1e3:.0f} frames/s"
             if cfg.family in ENCDEC_FAMILIES else "")
    print(f"{tag} {cfg.name}: median step {np.median(walls):.3f} ms host wall"
          f" over steps 2-{steps} (min {walls.min():.3f}, max "
          f"{walls.max():.3f}), {tokens / np.median(walls) * 1e3:.0f} {unit}/s"
          f"{extra}; on CUDA events (median) forward {dev['forward']:.3f} ms,"
          f" backward {dev['backward']:.3f} ms, AdamW {dev['optimizer']:.3f} "
          f"ms, step {dev['step']:.3f} ms; peak device memory "
          f"{peak / 2**30:.3f} GiB (the allocator's peak reserve "
          f"{reserved / 2**30:.3f} GiB); per step flash_attention {n_flash} "
          f"forward + {again} recompute, flash_attention_bwd {n_flash}, all on"
          f" wgmma (the {steps} steps by route: flash_attention "
          f"{phase_routes[phase]['flash_attention']}, flash_attention_bwd "
          f"{phase_routes[phase]['flash_attention_bwd']}){moe_note} | {card}")
    print(f"{tag} losses {losses} | {card}")
    if on_card:
        # the cached blocks of the timed steps go back first: the profiled
        # step then fragments the allocator no more than the first one did
        torch.cuda.empty_cache()
        profiled = profile_train_step(torch, np, fam, cfg, params, batch, seq,
                                      donate=True, exp_scan=True)
        if profiled is None:
            print(f"{tag} profiled step: not measured (torch.profiler saw no "
                  f"device time)")
        else:
            wall_us, rows, cats = profiled
            busy, top = busy_and_top(rows, k=10)
            print(f"{tag} profiled step: device busy {busy / 1e3:.3f} ms of "
                  f"{wall_us / 1e3:.3f} ms host wall (profiler on, a "
                  f"synchronize before AdamW; busy share "
                  f"{busy / wall_us:.4f}); device ms by kind: " + ", ".join(
                      f"{k} {v:.3f}" for k, v in cats.items())
                  + f"; by operation: | {card}")
            for us, name, count in top:
                print(f"{tag}   {us / 1e3:9.3f} ms  x{count:<5d} "
                      f"{name[:70]} | {card}")
        del profiled
        if cfg.family in ("ssm", "hybrid"):
            ssd_train_share(torch, cfg, params, make_batch(
                cfg, batch, seq, 0, 0, device)["tokens"], dev["step"], tag,
                card)
        if cfg.n_experts:
            moe_backward_by_op(torch, cfg, params, make_batch(
                cfg, batch, seq, 0, 0, device)["tokens"], card, tag)
    del params


def family_train_parity_phase(torch, np, card: str, phase_launches: dict,
                              phase_routes: dict) -> None:
    """Phase 24: each ``TRAIN_PARITY`` smoke config trained
    ``LM_TRAIN_SMOKE`` steps on the CPU (plain versions) and on the card
    (kernels, on ``mma_sync``: head dim 16) from the same seed-0 weights
    and numpy batches, losses within ``TRAIN_SMOKE_ATOL`` (for the MoE
    config, from its first step with a routing flip on, ``MOE_SMOKE_TOL``);
    and the first step's gradients on both, per leaf within
    ``TRAIN_GRAD_REL``.  Every config is printed before any is failed.
    Exactly ``flash_per_prefill`` forward and backward launches a step on
    the card (the smoke configs do not remat)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import KERNELS
    from repro_torch.kernels import flash_attention as fam
    from repro_torch.launch.train import make_batch
    from repro_torch.models import get_module
    from repro_torch.models.params import init_from_defs

    B, S, N = LM_TRAIN_SMOKE
    zero_launches(KERNELS)
    flash, failed = 0, []
    for arch in TRAIN_PARITY:
        small = get_config(arch, smoke=True)
        mod = get_module(small)
        sp = init_from_defs(mod.defs(small), torch.Generator().manual_seed(0),
                            "cpu")
        moe_cfg = small.n_experts > 0
        cpu_routes, card_routes = ([], []) if moe_cfg else (None, None)
        cpu_losses, _, _ = lm_train(torch, np, fam, small, sp, B, S, N, "cpu",
                                    routes=cpu_routes)
        card_losses, _, _ = lm_train(torch, np, fam, small,
                                     to_device(sp, "cuda"), B, S, N, "cuda",
                                     routes=card_routes)
        diffs = np.abs(np.subtract(card_losses, cpu_losses))
        # a (layer, token) routed to other experts on the card than on the
        # CPU (a near-tie of the bf16 router logits, rounded in another
        # order) moves the capacity ranks of the tokens after it and that
        # token's whole FFN output: from the first step with such a flip on
        # the losses are held to the MoE card-vs-CPU tolerance of phase 18b
        flips = [sum(int((~(expert_sets(torch, a, small.n_experts)
                           == expert_sets(torch, b.cpu(), small.n_experts)
                           ).all(-1)).sum()) for a, b in zip(ca, ga))
                 for ca, ga in zip(cpu_routes, card_routes)] if moe_cfg \
            else [0] * N
        first = next((i for i, f in enumerate(flips) if f), N)
        atol = TRAIN_SMOKE_ATOL.get(arch, LM_TRAIN_SMOKE_ATOL)
        limit = [atol if i < first else
                 MOE_SMOKE_TOL["atol"] + MOE_SMOKE_TOL["rtol"] * abs(c)
                 for i, c in enumerate(cpu_losses)]
        flip_note = (f"; routing flips card vs CPU by step {flips} of "
                     f"{small.n_layers * B * S} (layer, token) routings each"
                     + (f", so steps {first}-{N - 1} are held to "
                        f"{MOE_SMOKE_TOL} (phase 18b's), the max |loss diff| "
                        f"before step {first} "
                        f"{float(diffs[:first].max(initial=0.0)):.4e}"
                        if first < N else "")) if moe_cfg else ""
        batch = make_batch(small, B, S, 0, 0, "cpu")
        _, g_cpu = loss_and_grads(torch, mod, small, sp, batch)
        _, g_card = loss_and_grads(torch, mod, small, to_device(sp, "cuda"),
                                   to_device(batch, "cuda"))
        rel = {}
        for k, want in g_cpu.items():
            got = g_card[k].cpu()
            den = float(want.norm())
            rel[k] = (float((got - want).norm()) / den if den
                      else float(got.norm()))
        worst = max(rel, key=rel.get)
        grad_rel = TRAIN_GRAD_REL.get(arch, TRAIN_GRAD_REL[None])
        flash += flash_per_prefill(small) * (N + 1)
        print(f"[train-parity] {small.name} batch {B} x seq {S}, {N} AdamW "
              f"steps from the same seed-0 weights and numpy batches: card "
              f"(kernels) {card_losses} vs CPU (plain versions) {cpu_losses},"
              f" |loss diff| by step {[float(f'{d:.4e}') for d in diffs]} "
              f"(atol {atol}){flip_note}; first-step gradients, per leaf "
              f"|g_card - g_cpu| / |g_cpu|: max {rel[worst]:.4e} at {worst}, "
              f"median {float(np.median(list(rel.values()))):.4e} over "
              f"{len(rel)} leaves ({grad_rel}) | {card}")
        if not all(d <= lim for d, lim in zip(diffs, limit)):
            failed.append(f"{small.name} losses card vs CPU beyond {limit}")
        if not rel[worst] <= grad_rel:
            failed.append(f"{small.name} first-step gradient {worst} "
                          f"{rel[worst]:.4e}")
    if failed:
        raise AssertionError(f"training card vs CPU: {'; '.join(failed)}")
    phase = "train-parity"
    phase_launches[phase] = read_launches(KERNELS)
    phase_routes[phase] = read_routes(KERNELS)
    want = expect({"flash_attention": flash, "flash_attention_bwd": flash})
    routes = phase_routes[phase]
    if phase_launches[phase] != want \
            or routes["flash_attention"]["mma_sync"] != flash \
            or routes["flash_attention_bwd"]["mma_sync"] != flash:
        raise AssertionError(f"{phase} launches {phase_launches[phase]} by "
                             f"route {routes}, expected {want}, forward and "
                             f"backward on mma_sync (head dim 16)")


def train_cli_phase(card: str) -> None:
    """The training CLI as a user runs it, one subprocess per
    ``TRAIN_CLI`` arch: ``python -m repro_torch.launch.train --arch <arch>
    --smoke --steps TRAIN_CLI_STEPS`` on the card (its default), exit 0 and
    a finite loss printed for every step.  (Its kernels launch in the
    subprocess, whose counts this process does not see.)"""
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    for arch in TRAIN_CLI:
        cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
               arch, "--smoke", "--steps", str(TRAIN_CLI_STEPS)]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, cwd=root, env=env, capture_output=True,
                             text=True, timeout=600)
        wall = time.perf_counter() - t0
        losses = [float(x) for x in
                  re.findall(r"^step\s+\d+ loss (\S+)$", res.stdout, re.M)]
        if res.returncode != 0 or len(losses) != TRAIN_CLI_STEPS \
                or not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"{' '.join(cmd[1:])}: exit "
                                 f"{res.returncode}, losses {losses}; "
                                 f"{res.stdout[-800:]} {res.stderr[-1500:]}")
        print(f"[train-cli] {' '.join(cmd[1:])}: exit 0 in {wall:.1f}s, "
              f"losses {losses} | {card}")


# ---- the dry-run on the card (phase 25) ------------------------------------

def dryrun_runs() -> list:
    """Phase 25a: the accounting at full size of the cells phase 25 runs
    (the whole sweep takes over a minute on a host, so PERF.md quotes it
    from ``python -m repro_torch.launch.dryrun --all``), printed per cell;
    returns the runs: (arch, shape name, run ShapeConfig, variant, config
    overrides).  The dense configs of phase 26 run prefill_32k at batch 1
    at full depth, which must fit DRYRUN_MEM_SHARE of the card by the
    accounting."""
    from repro_torch.configs.base import SHAPES, ShapeConfig
    from repro_torch.launch import dryrun

    def show(rec, what):
        m, r = rec["memory"], rec["roofline"]
        print(f"[dryrun] accounted on the meta device for one H100: "
              f"{rec['arch']} {rec['shape']} {what}: flops "
              f"{rec['flops_per_device']:.4e} bytes "
              f"{rec['bytes_per_device']:.4e} peak "
              f"{m['peak_bytes'] / 2 ** 30:.3f} GiB (arguments "
              f"{m['argument_bytes'] / 2 ** 30:.3f}) fits {rec['fits']} "
              f"dominant {r['dominant']} (compute {r['compute_s']:.6f} s, "
              f"memory {r['memory_s']:.6f} s) useful "
              f"{r['useful_flops_ratio']:.4f} ({rec['compile_s']:.2f} s)")

    t0 = time.perf_counter()
    for arch, names in (("gemma3-1b", [g[0] for g in DRYRUN_GEMMA]),
                        ("dbrx-132b", [d[0] for d in DRYRUN_DBRX]),
                        *((a, ["prefill_32k"]) for a in DENSE_ARCHS)):
        for name in names:
            show(dryrun.run_cell(arch, name), "full size")
    print(f"[dryrun] full-size accounting of the run cells: "
          f"{time.perf_counter() - t0:.1f} s on the host")
    runs = [("gemma3-1b", n, ShapeConfig(n, SHAPES[n].seq_len, b,
                                         SHAPES[n].kind), v, None)
            for n, b, v in DRYRUN_GEMMA]
    over = {"n_layers": DRYRUN_DBRX_LAYERS}
    for n, b in DRYRUN_DBRX:
        full = SHAPES[n]
        shape = ShapeConfig(n, full.seq_len, b, full.kind)
        if full.kind == "prefill":
            rec = dryrun.run_cell("dbrx-132b", n, shape=shape, overrides=over)
            show(rec, f"({', '.join(rec['reduced'])})")
            share = rec["memory"]["peak_bytes"] / rec["device_bytes"]
            if share > DRYRUN_MEM_SHARE:
                shape = ShapeConfig(n, DRYRUN_DBRX_CUT_SEQ, b, full.kind)
                print(f"[dryrun] dbrx-132b {n}: accounted peak {share:.3f} of"
                      f" the card's memory at 1 x {full.seq_len}, above "
                      f"{DRYRUN_MEM_SHARE}: run at 1 x {DRYRUN_DBRX_CUT_SEQ}")
        runs.append(("dbrx-132b", n, shape, "baseline", over))
    full = SHAPES["prefill_32k"]
    shape = ShapeConfig("prefill_32k", full.seq_len, 1, full.kind)
    for arch in DENSE_ARCHS:
        rec = dryrun.run_cell(arch, "prefill_32k", shape=shape)
        show(rec, f"({', '.join(rec['reduced'])})")
        share = rec["memory"]["peak_bytes"] / rec["device_bytes"]
        if share > DRYRUN_MEM_SHARE:
            raise AssertionError(f"{arch} prefill_32k: accounted peak "
                                 f"{share:.3f} of the card at 1 x "
                                 f"{full.seq_len}, above {DRYRUN_MEM_SHARE}")
        runs.append((arch, "prefill_32k", shape, "baseline", None))
    return runs


def dryrun_phase(torch, card: str, phase_launches: dict,
                 phase_routes: dict) -> dict:
    """Phase 25: each run of ``dryrun_runs`` through ``dryrun.run_cell(...,
    device="cuda")``: accounted on ``meta`` at its run shape, then one
    counted call on the card and ``DRYRUN_STEPS`` timed ones.  Held: the
    flops counted on the card equal the meta count; the measured peak
    (``max_memory_allocated`` over a timed call, less what was allocated
    before it, plus its arguments) within the larger of DRYRUN_PEAK_REL and
    DRYRUN_PEAK_ABS of the accounted ``peak_bytes``; the attention launches
    exactly as expected (train: a forward, a recompute and a backward per
    layer and call; prefill: a forward; decode: none, ``decode_attention``
    is plain), all ``wgmma``; finite losses and logits.  The roofline time
    over the measured step is printed, not held.  Then the backward's
    scratch rule: ``scratch_rule`` equals the library's answer at every
    backward shape this run launched (``SCRATCH_ASKED``).  Returns
    ``time_32k``'s entries."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import KERNELS
    from repro_torch.kernels import flash_attention as fam
    from repro_torch.launch import dryrun
    from repro_torch.launch.variants import apply_variant

    for arch, name, shape, variant, over in dryrun_runs():
        torch.cuda.empty_cache()
        kind = shape.kind
        steps = DRYRUN_STEPS[kind]
        zero_launches(KERNELS)
        rec = dryrun.run_cell(arch, name, variant=variant, shape=shape,
                              overrides=over, device="cuda", steps=steps)
        phase = f"dryrun-{arch}-{name}"
        phase_launches[phase] = read_launches(KERNELS)
        phase_routes[phase] = read_routes(KERNELS)
        cfg = dataclasses.replace(apply_variant(get_config(arch), variant),
                                  **(over or {}))
        calls, L = 1 + steps, cfg.n_layers
        want = {"train": {"flash_attention": 2 * L * calls,
                          "flash_attention_bwd": L * calls},
                "prefill": {"flash_attention": L * calls},
                "decode": {}}[kind]
        routes = phase_routes[phase]
        if phase_launches[phase] != expect(want) or any(
                sum(r.values()) != r.get("wgmma", 0)
                for n, r in routes.items() if n.startswith("flash")):
            raise AssertionError(f"{phase}: launches {phase_launches[phase]} "
                                 f"by route {routes}, expected {want} on "
                                 f"wgmma")
        run, acc = rec["run"], rec["memory"]["peak_bytes"]
        measured = run["measured_peak_bytes"]
        band = max(DRYRUN_PEAK_REL * acc, DRYRUN_PEAK_ABS)
        if run["counts"]["flops"] != rec["counts"]["flops"] \
                or abs(measured - acc) > band or not run["finite"]:
            raise AssertionError(
                f"{phase}: flops on the card {run['counts']['flops']} vs "
                f"meta {rec['counts']['flops']}; peak measured {measured} vs "
                f"accounted {acc} (band {band:.0f}); finite {run['finite']}")
        r = rec["roofline"]
        bound = max(r["compute_s"], r["memory_s"])
        gib = 2 ** 30
        on_card, share = run["memory"]["peak_bytes"] / gib, \
            bound / run["step_s"]
        print(f"[dryrun] {arch} {name} at {shape.global_batch} x "
              f"{shape.seq_len}, variant {variant} "
              f"({'; '.join(rec['reduced'])}): flops on the card "
              f"{run['counts']['flops']:.6e} = meta (bytes "
              f"{run['counts']['bytes']:.6e}, meta "
              f"{rec['counts']['bytes']:.6e}); peak measured "
              f"{measured / gib:.3f} GiB vs accounted {acc / gib:.3f} GiB "
              f"(the counter on the card {on_card:.3f}; band "
              f"{band / gib:.3f}); step {run['step_s'] * 1e3:.3f} ms (median "
              f"of {steps}), roofline {bound * 1e3:.3f} ms ({r['dominant']}):"
              f" {share:.4f} of the step; attention launches "
              f"{phase_launches[phase]['flash_attention']} + backward "
              f"{phase_launches[phase]['flash_attention_bwd']} over {calls} "
              f"calls | {card}")
        if arch == "dbrx-132b" and kind == "prefill":
            print(f"[dryrun] dbrx-132b attention (Dh "
                  f"{cfg.resolved_head_dim}, G {cfg.n_heads // cfg.n_kv_heads}"
                  f"): {phase_launches[phase]['flash_attention']} launches, "
                  f"{routes['flash_attention']} | {card}")
    timed = time_32k(torch, card)
    asked = dict(fam.SCRATCH_ASKED)
    bad = {k: (v, fam.scratch_rule(*k)) for k, v in asked.items()
           if fam.scratch_rule(*k) != v}
    if not asked or bad:
        raise AssertionError(f"scratch rule: {len(asked)} backward shapes "
                             f"asked, Python copy differs at {bad}")
    print(f"[dryrun] scratch rule: the Python copy equals the library's at "
          f"all {len(asked)} backward shapes this run launched "
          f"({sorted(set(k[0] for k in asked))}) | {card}")
    return timed


def time_32k(torch, card: str) -> dict:
    """``flash_attention`` at each of ``LAYERS_32K`` (bf16, from a seed):
    held to its plain version within ``TOLERANCE``, then the kernel, the
    plain version and SDPA (``enable_gqa``; ``is_causal``, or the window
    as an explicit mask) timed twice in turns with CUDA events, L2 flushed
    before each launch, beside the bound.  Returns the kernels line's
    ``timed`` entries by name."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fam
    from repro_torch.kernels import ref

    gen = torch.Generator(device="cuda").manual_seed(25)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    out = {}
    for name, (B, S, Hq, Hkv, Dh), window in LAYERS_32K:
        q, k, v = (torch.randn((B, S, h, Dh), generator=gen, device="cuda")
                   .to(torch.bfloat16) for h in (Hq, Hkv, Hkv))
        got = fam.flash_attention(q, k, v, window=window)
        want = ref.flash_attention(q, k, v, window=window)
        torch.testing.assert_close(got.float(), want.float(),
                                   **TOLERANCE["flash_attention"]["bfloat16"])
        err = float((got.float() - want.float()).abs().max())
        del got, want
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        mask = None
        if window < S:
            i = torch.arange(S, device="cuda")
            mask = (i[:, None] >= i[None, :]) & (i[:, None] - i[None, :]
                                                 < window)

        def sdpa(qt=qt, kt=kt, vt=vt, mask=mask):
            return F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, is_causal=mask is None,
                enable_gqa=True)

        def kernel(q=q, k=k, v=v, window=window):
            return fam.flash_attention(q, k, v, window=window)

        def plain(q=q, k=k, v=v, window=window):
            return ref.flash_attention(q, k, v, window=window)

        runs = [[time_ms(torch, kernel, (), TIMED_LAUNCHES, flush),
                 time_ms(torch, plain, (), LAYERS_32K_PLAIN, flush),
                 time_ms(torch, sdpa, (), TIMED_LAUNCHES, flush)]
                for _ in range(2)]
        nbytes, flops = flash_work(q, k, window)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = flops / BF16_FLOPS_PER_S * 1e3
        call = ("F.scaled_dot_product_attention(enable_gqa=True, "
                + ("is_causal=True)" if mask is None
                   else "explicit window mask)"))
        res = {"ms": sum(r[0] for r in runs) / 2,
               "plain_ms": sum(r[1] for r in runs) / 2,
               "library_ms": sum(r[2] for r in runs) / 2,
               "library_call": call,
               "bound_ms": max(bytes_ms, ops_ms),
               "bound_by": "operations" if ops_ms > bytes_ms else "bytes",
               "bytes": int(nbytes), "flops": int(flops),
               "route": fam.flash_route(q.dtype, Dh), "max_abs_err": err}
        out[name] = res
        print(f"[dryrun] flash_attention @ {name} {(B, S, Hq, Hkv, Dh)}, "
              f"window {window if window < S else 'none'}: kernel "
              f"{res['ms']:.4f} ms on {res['route']}, plain "
              f"{res['plain_ms']:.4f} ms, SDPA {res['library_ms']:.4f} ms "
              f"({call}), bound {res['bound_ms']:.4f} ms by "
              f"{res['bound_by']} ({nbytes / 1e6:.1f} MB, "
              f"{flops / 1e9:.2f} GFLOP): {res['bound_ms'] / res['ms']:.3f} "
              f"of the bound, {res['ms'] / res['library_ms']:.3f}x SDPA; max"
              f" |err| vs plain {err:.4e}; runs {runs} | {card}")
        del q, k, v, qt, kt, vt, mask
    return out


# ---- the dense configs at full width (phases 26, 27) -----------------------

def accounted_peak(cfg, kind: str, batch: int, seq: int) -> int:
    """The peak bytes of ``cfg``'s ``kind`` cell (prefill, decode over
    ``seq`` slots, or a training step) at ``batch`` x ``seq``, accounted
    on the meta device (``dryrun.account``)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.specs import build_cell

    cell = build_cell(cfg, ShapeConfig(kind, seq, batch, kind))
    return dryrun.account(cell)[1]["peak_bytes"]


def dense_sizing(cfg, card: str, batch: int = LM_BATCH,
                 seq: int = LM_PROMPT, new: int = FAMILY_NEW) -> tuple:
    """Phase 26a: the serving batch and the training depth of ``cfg``.
    The limit is DRYRUN_MEM_SHARE of the card, and at most the card less
    ALLOC_MARGIN, less what the process already holds (reserved) on the
    card.  Serving (a ``batch`` x ``seq`` prefill, then decode steps over
    ``seq + new`` slots) keeps ``batch`` unless the larger accounted peak
    is above the limit, then the largest halving that is not; training
    (``train_step`` at ``batch`` x ``seq``, remat, CE in chunks of
    LM_TRAIN_CHUNK) keeps every layer unless its peak is above the limit,
    then the most layers whose peak is not (the peak grows by one step a
    layer: a line through 1 and 2 layers, then checked).  Each choice
    printed with its peaks."""
    import dataclasses

    import torch

    from repro_torch.launch import dryrun

    gib = 2 ** 30
    held = 0
    if torch.cuda.is_available():
        gc.collect()
        torch.cuda.empty_cache()
        held = torch.cuda.memory_reserved()
    card_bytes = dryrun.device_bytes()
    limit = min(DRYRUN_MEM_SHARE * card_bytes,
                card_bytes - ALLOC_MARGIN) - held

    def serving(b):
        return max(accounted_peak(cfg, "prefill", b, seq),
                   accounted_peak(cfg, "decode", b, seq + new))

    b, peak = batch, serving(batch)
    while peak > limit and b > 1:
        b //= 2
        peak = serving(b)
    share = (peak + held) / card_bytes
    print(f"[dense-size] {cfg.name} serving {b} x {seq} + {new}: accounted "
          f"peak {peak / gib:.3f} GiB, with the {held / gib:.3f} GiB the "
          f"process holds {share:.3f} of the card (limit "
          f"{(limit + held) / gib:.3f} GiB: {DRYRUN_MEM_SHARE} of the card, "
          f"at most the card less {ALLOC_MARGIN / gib:.0f} GiB)"
          + ("" if b == batch else f"; batch cut from {batch}") + f" | {card}")
    tcfg = dataclasses.replace(cfg, loss_chunk=LM_TRAIN_CHUNK)

    def training(n):
        return accounted_peak(dataclasses.replace(tcfg, n_layers=n), "train",
                              batch, seq)

    L, peak = cfg.n_layers, training(cfg.n_layers)
    if peak > limit:
        p1, p2 = training(1), training(2)
        L = max(1, min(cfg.n_layers - 1, int((limit - p1) // (p2 - p1)) + 1))
        peak = training(L)
        while peak > limit and L > 1:
            L -= 1
            peak = training(L)
        print(f"[dense-size] {cfg.name} training: accounted peak at all "
              f"{cfg.n_layers} layers above the limit; "
              f"{p1 / gib:.3f} GiB at 1 layer, {(p2 - p1) / gib:.3f} GiB a "
              f"layer more | {card}")
    print(f"[dense-size] {cfg.name} training {batch} x {seq} (remat, loss "
          f"chunk {LM_TRAIN_CHUNK}): {L} of {cfg.n_layers} layers, accounted"
          f" peak {peak / gib:.3f} GiB, with what the process holds "
          f"{(peak + held) / card_bytes:.3f} of the card | {card}")
    if peak > limit:
        raise AssertionError(f"{cfg.name}: one layer's training step is "
                             f"above the limit")
    return b, L


def exact_attention(torch, q, k, v, causal: bool, window: int):
    """The f64 output of attention over bf16(q * scale) (the product both
    the kernel and the plain version round), k and v, one (batch row, kv
    head) at a time, as ``exact_grads`` goes."""
    B, Dh, Hkv = q.shape[0], q.shape[-1], k.shape[2]
    G = q.shape[2] // Hkv
    scale = torch.tensor(Dh ** -0.5, dtype=q.dtype)
    seen = visible_pairs(torch, q.shape[1], k.shape[1], causal, window,
                         q.device)
    out = torch.empty(q.shape, dtype=torch.float64, device=q.device)
    for b in range(B):
        for h in range(Hkv):
            heads = slice(h * G, (h + 1) * G)
            s = torch.einsum("qgd,kd->gqk", (q[b, :, heads] * scale).double(),
                             k[b, :, h].double())
            out[b, :, heads] = torch.einsum(
                "gqk,kd->qgd", s.masked_fill(~seen, float("-inf")).softmax(-1),
                v[b, :, h].double())
            del s
    return out


def check_forward_case(torch, fam, name, q, k, v, kw, card) -> None:
    """One forward call captured from a real prefill (its o and lse, on the
    route ``flash_route`` gives, which must be ``wgmma``), held by
    ``FWD_CAPTURED_RULE``: each element of o within ``TOLERANCE`` of the
    f64 exact output, or no further from it than the plain version's
    element plus one bf16 step of the f64 value; lse within
    ``BWD_LSE_TOL`` of the plain forward's.  How many elements fall
    outside ``TOLERANCE`` against the plain version, and against the f64
    output for both, and the max-norm errors are printed beside it."""
    from repro_torch.kernels import ref

    route = fam.flash_route(q.dtype, q.shape[3])
    before = dict(fam.KERNEL.route_launches)
    causal = kw.get("causal", True)
    o, lse = fam._forward_cuda(q, k, v, causal, kw["window"], True)
    torch.cuda.synchronize()
    counted = {r: n - before[r] for r, n in fam.KERNEL.route_launches.items()}
    if route != "wgmma" or counted != {r: int(r == route) for r in counted}:
        raise AssertionError(f"flash_attention {name}: route {route}, "
                             f"counted {counted}")
    ro, rlse = ref.flash_attention(q, k, v, return_lse=True, **kw)
    torch.testing.assert_close(
        lse, rlse, **BWD_LSE_TOL,
        msg=lambda m: f"flash_attention {name}: lse: {m}")
    exact = exact_attention(torch, q, k, v, causal, kw["window"])
    tol = TOLERANCE["flash_attention"]["bfloat16"]

    def outside(got, want):
        return int(((got - want).abs() > tol["atol"] + tol["rtol"]
                    * want.abs()).sum())

    err, perr = (o.double() - exact).abs(), (ro.double() - exact).abs()
    # one bf16 step (8 significant bits) at each f64 value
    step = torch.ldexp(torch.ones_like(exact), torch.frexp(
        exact.abs().clamp_min(1e-30)).exponent - 8)
    bad = ~((err <= tol["atol"] + tol["rtol"] * exact.abs())
            | (err <= perr + step))
    if bad.any():
        i = int(bad.flatten().nonzero()[0])
        raise AssertionError(
            f"flash_attention {name}: {int(bad.sum())} of {o.numel()} "
            f"elements of o outside {FWD_CAPTURED_RULE}; the first: kernel "
            f"{float(o.flatten()[i]):.6e}, plain {float(ro.flatten()[i]):.6e}"
            f", f64 {float(exact.flatten()[i]):.6e}")
    den = float(exact.abs().max())
    ek, ep = float(err.max()) / den, float(perr.max()) / den
    del err, perr, step, bad
    print(f"[kernel] flash_attention case {name} q {tuple(q.shape)} k "
          f"{tuple(k.shape)}: max |o - f64| / max |o| {ek:.3e} (plain "
          f"{ep:.3e}, max |o| {den:.3e}); {FWD_CAPTURED_RULE}; elements "
          f"outside {tol}: against the plain version "
          f"{outside(o.double(), ro.double())}, against f64 kernel "
          f"{outside(o.double(), exact)} and plain "
          f"{outside(ro.double(), exact)} of {o.numel()}; max |lse err| "
          f"{float((lse - rlse).abs().max()):.4e} ({BWD_LSE_TOL}); route "
          f"{route} | {card}")


def dense_phase(torch, np, card: str, phase_launches: dict,
                phase_routes: dict, arch: str, measured: dict) -> None:
    """Phase 26 for one of ``DENSE_ARCHS``: sized (``dense_sizing``),
    served (``family_serve_phase``, phase ``<arch>-serve``, no decode
    profile), layer 0's q, k, v captured from a real prefill and held to
    the plain forward (``check_forward_case``), trained
    (``family_train_phase``, phase ``<arch>-train``), and layer 0's
    backward call captured from a real training step and held on both
    routes (``check_backward``, its errors kept in ``measured`` under
    ``<arch>_train_l0``).  Weights are drawn anew (seed 0, on the card)
    for each capture."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import KERNELS
    from repro_torch.kernels import flash_attention as fam
    from repro_torch.launch.train import make_batch
    from repro_torch.models import transformer
    from repro_torch.models.params import init_from_defs

    cfg = get_config(arch)
    batch, layers = dense_sizing(cfg, card)
    family_serve_phase(torch, np, card, phase_launches, phase_routes, arch,
                       batch=batch, phase=f"{arch}-serve",
                       decode_profile=False)
    torch.cuda.empty_cache()

    def weights(c):
        return init_from_defs(transformer.defs(c),
                              torch.Generator(device="cuda").manual_seed(0),
                              "cuda")

    prompts, _ = serving_inputs(torch, np, cfg, batch, LM_PROMPT, "cuda")
    params = weights(cfg)
    q, k, v, kw = capture_attention(torch, transformer, cfg, params, prompts,
                                    (0,))[0]
    del params
    torch.cuda.empty_cache()
    check_forward_case(torch, fam, f"{arch}_prefill_l0", q, k, v, kw, card)
    del q, k, v
    gc.collect()
    torch.cuda.empty_cache()
    family_train_phase(torch, np, card, phase_launches, phase_routes, arch,
                       n_layers=layers, loss_chunk=LM_TRAIN_CHUNK,
                       phase=f"{arch}-train")
    torch.cuda.empty_cache()
    tcfg = dataclasses.replace(cfg, n_layers=layers,
                               loss_chunk=LM_TRAIN_CHUNK)
    params = weights(tcfg)
    captured = capture_backward(
        torch, fam, transformer, tcfg, params,
        make_batch(tcfg, LM_BATCH, LM_PROMPT, 0, 0, "cuda"), (0,))
    del params
    torch.cuda.empty_cache()
    bwd = next(k for k in KERNELS if k.name == "flash_attention_bwd")
    got = check_backward(torch, fam, bwd,
                         {f"{arch}_train_l0": captured[0]}, card)
    if got["routes"][f"{arch}_train_l0"][0] != "wgmma":
        raise AssertionError(f"{arch}: the captured backward call's route "
                             f"{got['routes']}, expected wgmma")
    for key in ("errs", "rel", "routes"):
        measured[key] |= got[key]
    measured["max_abs_err"] = max(measured["max_abs_err"],
                                  got["max_abs_err"])
    del captured


def narrow_stablelm_phase(torch, np, card: str, phase_launches: dict,
                          phase_routes: dict) -> None:
    """Phase 27: stablelm's smoke config with ``NARROW_STABLELM`` (its real
    head dim, 80) from seed-0 weights: the card's logits (teacher-forced
    with the CPU's tokens) against the CPU's ``generate`` (plain versions)
    within NARROW_STABLELM_TOL (how many fall outside LM_SMOKE_ATOL is
    printed), then LM_TRAIN_SMOKE AdamW steps card against CPU within
    LM_TRAIN_SMOKE_ATOL; the card's attention launches (a prefill, then a
    forward and a backward a step) all on ``wgmma``."""
    import dataclasses

    from repro_torch.configs import stablelm
    from repro_torch.kernels import KERNELS
    from repro_torch.kernels import flash_attention as fam
    from repro_torch.launch.serve_lm import generate
    from repro_torch.models import transformer
    from repro_torch.models.params import init_from_defs

    cfg = dataclasses.replace(stablelm.SMOKE, name="stablelm-narrow",
                              **NARROW_STABLELM)
    sp = init_from_defs(transformer.defs(cfg),
                        torch.Generator().manual_seed(0), "cpu")
    zero_launches(KERNELS)
    B, P, N = LM_SMOKE
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, P))
    on_cpu = generate(cfg, sp, prompts, N, device="cpu")
    on_card = teacher_forced(
        torch, transformer, cfg, to_device(sp, "cuda"),
        torch.from_numpy(prompts).cuda(), on_cpu.tokens.cuda())[0]
    on_card = on_card.float().cpu()
    diff = (on_card - on_cpu.logits.float()).abs()
    sdiff, wide = float(diff.max()), int((diff > LM_SMOKE_ATOL).sum())
    torch.testing.assert_close(on_card, on_cpu.logits.float(),
                               **NARROW_STABLELM_TOL)
    Bt, S, Nt = LM_TRAIN_SMOKE
    cpu_losses, _, _ = lm_train(torch, np, fam, cfg, sp, Bt, S, Nt, "cpu")
    card_losses, _, _ = lm_train(torch, np, fam, cfg, to_device(sp, "cuda"),
                                 Bt, S, Nt, "cuda")
    tdiff = float(np.abs(np.subtract(card_losses, cpu_losses)).max())
    if not tdiff <= LM_TRAIN_SMOKE_ATOL:
        raise AssertionError(f"narrow stablelm training card vs CPU: losses "
                             f"{card_losses} vs {cpu_losses}")
    phase = "narrow-stablelm"
    phase_launches[phase] = read_launches(KERNELS)
    phase_routes[phase] = read_routes(KERNELS)
    L = cfg.n_layers
    want = expect({"flash_attention": L + L * Nt,
                   "flash_attention_bwd": L * Nt})
    routes = phase_routes[phase]
    if phase_launches[phase] != want \
            or routes["flash_attention"]["wgmma"] != L + L * Nt \
            or routes["flash_attention_bwd"]["wgmma"] != L * Nt:
        raise AssertionError(f"{phase} launches {phase_launches[phase]} by "
                             f"route {routes}, expected {want}, all on wgmma")
    print(f"[{phase}] {cfg.name} ({L} layers, {cfg.n_heads} heads of "
          f"{cfg.resolved_head_dim}, d_model {cfg.d_model}): batch {B} x "
          f"prompt {P}, {N} tokens, card (kernels, teacher-forced with the "
          f"CPU's tokens) vs CPU (plain versions): max |logit diff| "
          f"{sdiff:.4e} ({NARROW_STABLELM_TOL}; {wide} of {diff.numel()} "
          f"beyond {LM_SMOKE_ATOL}; median |logit| "
          f"{float(on_cpu.logits.float().abs().median()):.4e}, max "
          f"{float(on_cpu.logits.float().abs().max()):.4e}); {Nt} AdamW "
          f"steps at {Bt} x {S}: card {card_losses} vs CPU {cpu_losses}, max"
          f" |loss diff| {tdiff:.4e} (atol {LM_TRAIN_SMOKE_ATOL}); launches "
          f"by route {routes} | {card}")


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
    """pack_sharded_specs -> (each clique's epoch-pinned shards, each mesh
    position's slice of the packed arrays on its card (the one-card mesh),
    host bytes of miss_rows), as ``train_gnn``'s finalize resolves them."""
    from repro_torch.launch.mesh import make_hierarchical_mesh
    from repro_torch.train.batch import pack_sharded_specs
    from repro_torch.train.loop import position_parts

    packed = pack_sharded_specs(groups, feat_dim)
    epochs = [int(e) for e in packed.pop("cache_epochs")]
    shards = [c.sharded_device_arrays(e)["feat_shards"]
              for c, e in zip(plan.caches, epochs)]
    miss_bytes = packed["miss_rows"].nbytes
    mesh = make_hierarchical_mesh(plan.partition.cliques)
    return shards, position_parts(packed, mesh), miss_bytes


def chain_context(torch, np, cache, seeds, fanouts, seed: int,
                  position=None) -> dict:
    """Inputs of one sampling chain on ``cache`` (sharded topology mode):
    the seeds and the sampler's draws (numpy, as ``cache_sample_dispatch``
    draws them: int64 in [0, 2^31)), the chain kernel's arguments on the
    card, and each hop's arguments of the per-hop kernel on the same draws
    (the routing glue of ``device_sample_cached``, hop 1's frontier sampled
    with the plain version).  ``position``: a clique position of the
    sharded residency (its CSR shards, one allocation each, and its
    routing copy), else the flat residency's stacked CSR rows."""
    from repro_torch.kernels import ref

    rng = np.random.default_rng(seed)
    seeds = np.asarray(seeds, dtype=np.int64)
    rands, n = [], len(seeds)
    for f in fanouts:
        rands.append(rng.integers(0, 1 << 31, size=(n, f)))
        n *= f
    _, ip, ix, topo_owner, topo_local = cache._position_topology(position)
    ip, ix = list(ip), list(ix)
    da = {"topo_owner": topo_owner, "topo_local": topo_local}
    routing = (ip, ix, topo_owner, topo_local)
    chain = (*routing, torch.from_numpy(seeds).cuda(),
             [torch.from_numpy(r).cuda() for r in rands])
    hops, frontier = [], chain[4]
    for r in chain[5]:
        safe = frontier.clamp_min(0)
        owner = torch.where(frontier >= 0, da["topo_owner"][safe], -1)
        local = da["topo_local"][safe].to(torch.int32)
        hops.append((ip, ix, owner.contiguous(), local.contiguous(), r))
        frontier = ref.routed_neighbor_sample_peer(*hops[-1]).reshape(-1) \
            .to(torch.int64)
    return {"cache": cache, "seeds": seeds, "rands": rands,
            "fanouts": tuple(fanouts), "chain": chain, "hops": hops,
            "position": position}


def shard_context(torch, np, g, plan, cfg, card) -> dict:
    """Kernel inputs taken from a real sharded step at paper width: clique
    0's shards (one allocation each) and position (0, 0)'s routing for
    ``routed_gather``; clique 0's CSR shards, position (0, 0)'s 2000 seeds
    and the sampler's draws (2000 x 25, then 50,000 x 10) for
    ``routed_neighbor_sample``: the chain, and its hop 0 and hop 1 on the
    per-hop kernel."""
    groups, _ = sharded_specs(np, g, plan, cfg, seed=5)
    shards, parts, _ = upload_packed(torch, np, plan, groups, g.feat_dim)
    sample = chain_context(torch, np, plan.caches[0],
                           groups[0][0].levels[0], cfg.fanouts, seed=6,
                           position=0)
    hop0, hop1 = (h[2:] for h in sample["hops"])
    ctx = {"shards": list(shards[0]), "owner": parts[0, 0]["owner"],
           "local": parts[0, 0]["local"], "indptr": sample["chain"][0],
           "indices": sample["chain"][1], "hop0": hop0, "hop1": hop1,
           "sample": sample}
    s = groups[0][0]
    n = s.n_ids
    peer = int((s.owner[:n] >= 0).sum() - (s.owner[:n] == 0).sum())
    print(f"[kernel] sharded step, position (0, 0): n_pad="
          f"{ctx['owner'].numel()} shards="
          f"{[tuple(t.shape) for t in shards[0]]} unique={n} "
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
    from repro_torch.launch.mesh import make_hierarchical_mesh
    from repro_torch.train.batch import (ShardedBatchBuilder,
                                         pack_sharded_specs)
    from repro_torch.train.loop import position_parts, sharded_position_batch
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
        shards = [c.sharded_device_arrays(int(e))["feat_shards"]
                  for c, e in zip(bplan.caches, packed.pop("cache_epochs"))]
        parts = position_parts(packed, mesh)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        batches = [sharded_position_batch(shards[ci], parts[ci, gi],
                                          g.feat_dim)
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


def shard_binding(caches) -> str:
    """The cards a sharded run's caches span and, per card, the shard
    allocations there (feature and CSR shards: count and MB)."""
    per = {}
    for ci, c in enumerate(caches):
        sa = c.sharded_device_arrays()
        for k in ("feat_shards", "topo_shard_indptr", "topo_shard_indices"):
            for t in sa.get(k, ()):
                n, b = per.get(str(t.device), (0, 0))
                per[str(t.device)] = (n + 1,
                                      b + t.numel() * t.element_size())
    cards = sorted(per)
    bound = [[str(d) for d in c.shard_devices] for c in caches]
    return (f"clique positions on {bound} ({len(cards)} card(s)); shard "
            f"allocations per card "
            + ", ".join(f"{d}: {n} ({b / 1e6:.1f} MB)"
                        for d, (n, b) in per.items()))


def epoch_change_steps(np, res) -> str:
    """The step times of a run around its refreshes, against the run's
    median: a refresh labelled step s runs as batch s is built, so step
    s - 1 waits for it and finalizes the first batch of the new epoch;
    then steps s, s + 1."""
    st = np.array(res.step_times) * 1e3
    near = sorted({i for e in res.refresh.get("events", [])
                   for i in range(e["step"] - 1, e["step"] + 2)
                   if 0 <= i < len(st)})
    return (f"step median {np.median(st):.2f} ms; steps around the "
            f"refreshes " + ", ".join(f"{i}: {st[i]:.2f} ms" for i in near))


def cross_card_phase(torch, np, g, splan, cfg, kw, one_card, card,
                     phase_launches, phase_routes) -> None:
    """Phase 10's sharded run again with each clique's positions on
    distinct cards (all four on their own where the host has four), its
    losses and accuracies held bitwise to the one-card run ``one_card``;
    with one card, says that it was not run and why."""
    from repro_torch.kernels import KERNELS
    from repro_torch.train.loop import train_gnn

    n = torch.cuda.device_count()
    if n < 2:
        print(f"[cross-card] not run: this host has {n} CUDA card; the "
              f"2 x 2 mesh across cards needs two or more (the one-card "
              f"run above bound every position to cuda:0) | {card}")
        return
    binding = ([f"cuda:{i}" for i in range(4)] if n >= 4
               else ["cuda:0", "cuda:1", "cuda:0", "cuda:1"])
    cplan = fresh_copy(splan)
    zero_launches(KERNELS)
    res = train_gnn(g, cplan, cfg, steps=SHARD_PARITY_STEPS,
                    backend="sharded", **dict(kw, device=binding))
    phase_launches["cross-card"] = read_launches(KERNELS)
    phase_routes["cross-card"] = read_routes(KERNELS)
    if res.losses != one_card.losses or res.accs != one_card.accs:
        raise AssertionError(f"across cards {res.losses} != one card "
                             f"{one_card.losses}")
    n_pos = sum(len(c) for c in splan.partition.cliques)
    expect_chains("cross-card", phase_routes["cross-card"],
                  n_pos * SHARD_PARITY_STEPS)
    print(f"[cross-card] phase 10 with positions on {binding}: losses and "
          f"accuracies bitwise the one-card run's; "
          f"{shard_binding(cplan.caches)}; {epoch_change_steps(np, res)} "
          f"| {card}")


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


def teacher_forced(torch, mod, cfg, params, inputs, tokens, dist=None):
    """The logits ``generate`` gives when its decode steps are fed
    ``tokens`` (B, new) instead of its own argmaxes, and the cache (or
    state) after the last step; ``inputs`` is what ``mod.prefill`` takes
    (the prompts, or the encoder-decoder's ``{"frames", "tokens"}``).  On
    ``dist``'s mesh the logits are assembled whole."""
    P = (inputs["tokens"] if isinstance(inputs, dict) else inputs).shape[1]
    V = cfg.vocab_size
    whole = dist.full if dist is not None else (lambda t: t)
    with torch.inference_mode():
        logits, cache = mod.prefill(cfg, params, inputs,
                                    max_len=P + tokens.shape[1], dist=dist)
        outs = [whole(logits)[:, -1:, :V]]
        for i in range(tokens.shape[1] - 1):
            logits, cache = mod.decode_step(
                cfg, params, cache, tokens[:, i:i + 1], P + i, dist=dist)
            outs.append(whole(logits)[:, :, :V])
    return torch.cat(outs, dim=1), cache


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


def by_category(rows, exp_scan: bool = False) -> dict:
    """Device ms by kind of operation: the flash kernels (forward, and the
    backward's three launches), matrix products (cuBLAS), copies and casts,
    and the rest (elementwise, reductions); with ``exp_scan`` the exp and
    cumsum kernels (the SSD's decays, by ``ssd_kinds``' rule) apart from
    the rest."""
    out = {"flash_attention": 0.0, "flash_attention_bwd": 0.0, "matmul": 0.0,
           "copy/cast": 0.0} | ({"exp/cumsum": 0.0} if exp_scan else {}) \
        | {"other": 0.0}
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
        elif exp_scan and ("exp" in n or "scan" in n or "cumsum" in n):
            key = "exp/cumsum"
        else:
            key = "other"
        out[key] += (t - s) / 1e3
    return out


def time_old_routes(torch, np, fam, measured, flush, card,
                    seed: int = 14) -> None:
    """The forward at each ``OLD_ROUTE`` layer shape (bf16 from a seed,
    causal) on its route and on the old one (forced through the route
    rule), in turns (new, old, then old, new), ``TIMED_LAUNCHES`` each;
    the old route's mean goes into ``measured["timed"]`` as
    ``<shape>_<old route>``, beside the new route's entry, which keeps
    ``check_and_time``'s numbers."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    for name, (B, S, Hq, Hkv, Dh), Sk, causal in LAYER_SHAPES:
        old = OLD_ROUTE.get(name)
        if old is None:
            continue
        q, k, v = (torch.randn(shape, generator=gen, device="cuda").bfloat16()
                   for shape in ((B, S, Hq, Dh), (B, Sk or S, Hkv, Dh),
                                 (B, Sk or S, Hkv, Dh)))
        new = fam.flash_route(q.dtype, Dh)

        def on(route):
            def run():
                with forced_route(fam, "flash_route", route):
                    return fam.flash_attention(q, k, v, causal=causal)
            return time_ms(torch, run, (), TIMED_LAUNCHES, flush)

        times = {new: [], old: []}
        for turn in ((new, old), (old, new)):
            for route in turn:
                times[route].append(on(route))
        entry = measured["timed"][name]
        measured["timed"][f"{name}_{old}"] = entry | {
            "ms": float(np.mean(times[old])), "route": old}
        entry["route"] = new
        print(f"[kernel] flash_attention @ {name}, in turns: {new} "
              f"{np.mean(times[new]):.4f} ms {times[new]}, {old} (the route "
              f"before, forced) {np.mean(times[old]):.4f} ms {times[old]}; "
              f"check_and_time's {new} {entry['ms']:.4f} ms, bound "
              f"{entry['bound_ms']:.4f} ms | {card}")
        del q, k, v


def layer_attention_lse(torch, fam, card, seed: int = 13) -> None:
    """The forward kernel's o and lse at the model layers' shapes
    (``LAYER_SHAPES``) against the plain forward's: o within
    ``TOLERANCE``, lse within ``BWD_LSE_TOL``."""
    from repro_torch.kernels import ref

    gen = torch.Generator(device="cuda").manual_seed(seed)
    for name, (B, S, Hq, Hkv, Dh), Sk, causal in LAYER_SHAPES:
        q = torch.randn((B, S, Hq, Dh), generator=gen, device="cuda"
                        ).to(torch.bfloat16)
        k, v = (torch.randn((B, Sk or S, Hkv, Dh), generator=gen,
                            device="cuda").to(torch.bfloat16)
                for _ in range(2))
        o, lse = fam._forward_cuda(q, k, v, causal, 0, True)
        ro, rlse = ref.flash_attention(q, k, v, causal=causal, window=0,
                                       return_lse=True)
        for what, got, want, tol in (
                ("o", o, ro, TOLERANCE["flash_attention"]["bfloat16"]),
                ("lse", lse, rlse, BWD_LSE_TOL)):
            torch.testing.assert_close(
                got.float(), want.float(), **tol,
                msg=lambda m: f"flash_attention {name}: {what}: {m}")
        print(f"[kernel] flash_attention case {name} with lse: max |o err| "
              f"{float((o.float() - ro.float()).abs().max()):.4e}, max |lse "
              f"err| {float((lse - rlse).abs().max()):.4e} ({BWD_LSE_TOL}), "
              f"route {fam.flash_route(q.dtype, Dh)} | {card}")


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


def visible_pairs(torch, Sq: int, Sk: int, causal: bool, window: int,
                  device, shift: int = 0):
    """(Sq, Sk) bool: key j is visible to query i at key position i +
    ``shift`` (causal: j <= i + shift; window > 0: i + shift - j <
    window)."""
    i = shift + torch.arange(Sq, device=device)[:, None]
    j = torch.arange(Sk, device=device)[None, :]
    seen = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        seen &= j <= i
    if window > 0:
        seen &= i - j < window
    return seen


def exact_grads(torch, q, k, v, do, causal: bool, window: int,
                shift: int = 0):
    """The f64 gradient of attention over q * the bf16-rounded scale (the
    product not rounded), k and v at output gradient ``do`` (query i at key
    position i + ``shift``), one (batch
    row, kv head) at a time: its G query heads against its one kv head
    (the f64 scores of a 4096-token row are 134 MB a query head, so a
    chameleon row of 64 heads would need 8.6 GB a tensor at once)."""
    B, Dh, Hkv = q.shape[0], q.shape[-1], k.shape[2]
    G = q.shape[2] // Hkv
    scale = float(torch.tensor(Dh ** -0.5, dtype=q.dtype))
    seen = visible_pairs(torch, q.shape[1], k.shape[1], causal, window,
                         q.device, shift)
    out = [torch.empty(t.shape, dtype=torch.float64, device=t.device)
           for t in (q, k, v)]
    for b in range(B):
        for h in range(Hkv):
            heads = slice(h * G, (h + 1) * G)
            qd = q[b:b + 1, :, heads].double().requires_grad_()
            kd, vd = (t[b:b + 1, :, h:h + 1].double().requires_grad_()
                      for t in (k, v))
            s = torch.einsum("bqhd,bkhd->bhqk", qd * scale,
                             kd.expand(-1, -1, G, -1))
            o = torch.einsum(
                "bhqk,bkhd->bqhd",
                s.masked_fill(~seen, float("-inf")).softmax(-1),
                vd.expand(-1, -1, G, -1))
            gq, gk, gv = torch.autograd.grad(o, (qd, kd, vd),
                                             do[b:b + 1, :, heads].double())
            out[0][b:b + 1, :, heads] = gq
            out[1][b:b + 1, :, h:h + 1] = gk
            out[2][b:b + 1, :, h:h + 1] = gv
            del s, o, gq, gk, gv
    return out


def bwd_cases(torch, fa, captured, seed: int = 12):
    """The backward's cases: the training step's layer 0 (local) and layer
    5 (global) calls as captured, and edge cases with o and lse from the
    forward kernel: Dh 16, 64, 80, 128 and 256, windows 64, 512 and none,
    G = 1, 2, 3, 4 and 5 (3 and 5 leave rows of the wgmma route's 64-row
    tiles, and of the forward's 128-row tiles, empty), causal and not,
    ragged Sq (77, 130, 333, 1000), Sq != Sk; and, named ``fam_<shape>``,
    the families' training shapes at the full batch (``BWD_FAMILY_SHAPES``:
    G up to 8, not causal at 4096 keys, Sq 512 over Sk 4096)."""
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
             {"window": 0, "causal": False}),
            *((f"fam_{name}", shape, Sk, {"window": 0, "causal": causal})
              for name, shape, Sk, causal in BWD_FAMILY_SHAPES)):
        Sk = Sq if Sk is None else Sk
        q, k, v, do = (torch.randn(shape, generator=gen, device="cuda")
                       .bfloat16() for shape in
                       ((B, Sq, Hq, Dh), (B, Sk, Hkv, Dh), (B, Sk, Hkv, Dh),
                        (B, Sq, Hq, Dh)))
        kw = {"causal": True} | kw
        o, lse = fa._forward_cuda(q, k, v, kw["causal"], kw["window"], True)
        cases[name] = (q, k, v, o, lse, do, kw)
    return cases


def check_backward(torch, fa, k, cases, card, forced=("mma_sync",)) -> dict:
    """The backward kernel on every case, on the route ``flash_bwd_route``
    gives it and, where that is ``wgmma``, on the ``forced`` routes too
    (through the route rule): against the f64 exact gradient beside the
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
                            kw["window"], kw.get("q_offset", 0))
        native = fa.flash_bwd_route(q.dtype, q.shape[3])
        routes[name] = [native] + (list(forced) if native == "wgmma"
                                   else [])
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
        nbytes, flops = flash_work(q, kk, kw["window"], backward=True)
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


def time_family_backward(torch, np, fa, cases, flush, card) -> dict:
    """At the families' training shapes (the ``fam_`` cases, full batch):
    the backward kernel on its route (``wgmma``), its plain version and
    SDPA's backward (k and v expanded to the query heads, ``is_causal`` or
    no mask; (forward + backward) - forward), in two rounds, beside the
    bound (5 products of 2 Dh flops per visible pair and query head at the
    bf16 rate, or the bytes of q, k, v, o, do, lse in and dq, dk, dv out,
    the larger)."""
    import functools

    import torch.nn.functional as F
    from repro_torch.kernels import ref

    out = {}
    for name, (q, kk, v, o, lse, do, kw) in cases.items():
        if not name.startswith("fam_"):
            continue
        B, Sq, Hq, Dh = q.shape
        Sk, G = kk.shape[1], Hq // kk.shape[2]
        causal = kw["causal"]
        nbytes, flops = flash_work(q, kk, 0, causal, backward=True)
        qt = q.transpose(1, 2).contiguous().requires_grad_()
        kt, vt = (t.repeat_interleave(G, 2).transpose(1, 2).contiguous()
                  .requires_grad_() for t in (kk, v))
        dot = do.transpose(1, 2).contiguous()

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt,
                                                  is_causal=causal)

        def sdpa_fwd_bwd():
            torch.autograd.grad(sdpa(), (qt, kt, vt), dot)

        a = (q, kk, v, o, lse, do)
        route = fa.flash_bwd_route(q.dtype, Dh)
        old = OLD_ROUTE.get(name[len("fam_"):])

        def on(r):
            def run(*args):
                with forced_route(fa, "flash_bwd_route", r):
                    return fa.flash_attention_bwd(*args, **kw)
            return time_ms(torch, run, a, BWD_FAMILY_TIMED, flush)

        runs, old_ms = [], []
        for turn in range(2):
            if old and turn:  # in turns: new, old, then old, new
                old_ms.append(on(old))
            runs.append([
                time_ms(torch, functools.partial(fa.flash_attention_bwd, **kw),
                        a, BWD_FAMILY_TIMED, flush),
                time_ms(torch, functools.partial(ref.flash_attention_bwd,
                                                 **kw), a, BWD_FAMILY_PLAIN,
                        flush),
                time_ms(torch, sdpa_fwd_bwd, (), BWD_FAMILY_TIMED, flush)
                - time_ms(torch, sdpa, (), BWD_FAMILY_TIMED, flush)])
            if old and not turn:
                old_ms.append(on(old))
        m = np.mean(runs, axis=0)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = flops / BF16_FLOPS_PER_S * 1e3
        call = (f"F.scaled_dot_product_attention backward, k/v expanded to "
                f"the query heads, {'is_causal' if causal else 'no mask'}, "
                f"(forward + backward) - forward")
        out[name] = {"ms": float(m[0]), "route": route,
                     "plain_ms": float(m[1]), "library_ms": float(m[2]),
                     "library_call": call,
                     "bound_ms": max(bytes_ms, ops_ms),
                     "bound_by": "operations" if ops_ms > bytes_ms
                     else "bytes", "bytes": int(nbytes), "flops": int(flops)}
        r = out[name]
        if old:
            out[f"{name}_{old}"] = r | {"ms": float(np.mean(old_ms)),
                                        "route": old}
            print(f"[lm-bwd] {name}: the route before, {old}, forced in "
                  f"turns with {route}: {np.mean(old_ms):.4f} ms {old_ms} "
                  f"| {card}")
        print(f"[lm-bwd] {name} @ q {tuple(q.shape)} k {tuple(kk.shape)} "
              f"{kw}: backward kernel on {route} {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, SDPA backward {r['library_ms']:.4f} "
              f"ms ({call}), bound {r['bound_ms']:.4f} ms by {r['bound_by']}"
              f" ({flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB): "
              f"{r['bound_ms'] / r['ms']:.3f} of the bound, "
              f"{r['ms'] / r['library_ms']:.3f}x SDPA's backward; runs "
              f"(kernel, plain, SDPA) {runs} | {card}")
        del qt, kt, vt, dot
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


def lm_train(torch, np, fa, cfg, params, batch: int, seq: int, steps: int,
             device, lr: float = LM_TRAIN_LR, marks=None,
             split_optimizer: bool = False, donate: bool = False,
             routes=None):
    """``steps`` of ``launch.train.train_step`` from ``params`` on numpy
    batches (seed 0), through the family's ``loss_fn`` (``get_module(cfg)``,
    patched for the run): per step the loss, the host wall time
    (synchronized) and, with ``marks``, CUDA events at the step's start,
    after the loss (the forward), where AdamW starts (after the backward)
    and at its end, and the flash kernels' launches by route after the
    forward and at the end.  ``split_optimizer`` synchronizes before AdamW
    and opens the profiler range ``lm_optimizer`` there, so that every
    device operation after its start is the optimizer's.  ``donate`` hands
    the optimizer state to each step (``train_step(donate=True)``).  With
    ``routes`` (a list), a list of each step's ``moe._route`` top-k ids is
    appended to it (the forward's layers, then any remat recompute's).
    Returns (losses, wall seconds, final params)."""
    from repro_torch.launch.train import make_batch, train_step
    from repro_torch.models import get_module, moe
    from repro_torch.train.optimizer import AdamW, adamw

    opt = adamw(lr)
    state = opt.init(params)
    mod = get_module(cfg)
    inner_loss, step_marks = mod.loss_fn, {}

    def launches():
        return (dict(fa.KERNEL.route_launches),
                dict(fa.BWD_KERNEL.route_launches))

    def event():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def loss_fn(*a, **kw):
        out = inner_loss(*a, **kw)
        if marks is not None:
            step_marks["fwd"], step_marks["fwd_routes"] = event(), launches()
        return out

    def optimizer(fn):
        def run(*a, **kw):
            if marks is not None:
                step_marks["opt"] = event()
            if split_optimizer:
                torch.cuda.synchronize()
                with torch.profiler.record_function("lm_optimizer"):
                    return fn(*a, **kw)
            return fn(*a, **kw)
        return run

    # without donate, the optimizer and train_step as an older tree has
    # them (tools/lm_train_steps.py --src times other trees through here)
    timed = (AdamW(opt.init, optimizer(opt.update), optimizer(opt.step))
             if donate else AdamW(opt.init, optimizer(opt.update)))
    kw = {"donate": True} if donate else {}
    mod.loss_fn = loss_fn
    losses, walls = [], []
    try:
        for step in range(steps):
            b = make_batch(cfg, batch, seq, 0, step, device)
            if marks is not None:
                step_marks = {"start": event(), "start_routes": launches()}
            t0 = time.perf_counter()
            if routes is not None:
                routes.append([])
            with (recorded_routes(moe, routes[-1]) if routes is not None
                  else contextlib.nullcontext()):
                params, state, loss = train_step(cfg, params, timed, state, b,
                                                 **kw)
            if marks is not None:
                step_marks["end"], step_marks["end_routes"] = (event(),
                                                               launches())
                marks.append(step_marks)
            losses.append(float(loss))  # synchronizes
            walls.append(time.perf_counter() - t0)
    finally:
        mod.loss_fn = inner_loss
    return losses, walls, params


def profile_train_step(torch, np, fa, cfg, params, batch: int, seq: int,
                       donate: bool = False, exp_scan: bool = False):
    """One step of ``lm_train`` under ``torch.profiler`` with a synchronize
    before AdamW: (host wall us, device rows, device ms by kind with the
    optimizer's apart; ``exp_scan`` splits exp and cumsum off the rest), or
    None where the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=False) as prof:
        t0 = time.perf_counter()
        lm_train(torch, np, fa, cfg, params, batch, seq, 1, "cuda",
                 split_optimizer=True, donate=donate)
        wall_us = (time.perf_counter() - t0) * 1e6
    rows, at = kineto_rows(torch, prof)
    opt_at = at["lm_optimizer"]
    if not rows or len(opt_at) != 1:
        return None
    opt_start = opt_at[0][0]
    cats = by_category([r for r in rows if r[0] < opt_start], exp_scan)
    cats["optimizer"] = sum(t - s for s, t, _ in rows if s >= opt_start) / 1e3
    return wall_us, rows, cats


def gap_summary(gap, window: int) -> str:
    return (f"max {gap.max():.4e} (positions < {window}: "
            f"{gap[:window].max():.4e}, >= {window}: {gap[window:].max():.4e})"
            f", mean {gap.mean():.4e}")


# ---- phase 28: LM serving over a (data, model) mesh -------------------------

@contextlib.contextmanager
def recorded_router(moe, record: list):
    """Every ``moe._route`` call's (top-k ids, the margin between the
    router's k-th and (k+1)-th probabilities) appended to ``record``."""
    import torch

    inner = moe._route

    def route(cfg, p, x):
        out = inner(cfg, p, x)
        with torch.no_grad():  # a record, not part of a training graph
            probs = torch.softmax((x @ p["router"].to(x.dtype)).float(),
                                  dim=-1)
            top = probs.topk(cfg.top_k + 1, dim=-1).values
        record.append((out[0], top[..., -2] - top[..., -1]))
        return out

    moe._route = route
    try:
        yield record
    finally:
        moe._route = inner


def routing_flips(torch, want: list, got: list, L: int, n: int,
                  new: int, tokens) -> dict:
    """Where the mesh's routing (``recorded_router`` of a 1 x n mesh: the
    batch whole, the prefill's sequence split over the n positions, decode
    replicated) differs from the meshless run's: {sequence: first step (0:
    the prefill)}, while the sequence's greedy tokens (``tokens``: the two
    runs', (B, new) each) agree: a sequence's first flip (in layer order)
    changes its later layers' inputs, so it is compared no further.
    Raises where a first flip's meshless k / k+1 margin exceeds
    ``ROUTE_FLIP_MARGIN``."""
    first = {}
    same = (tokens[0].cpu() == tokens[1].cpu()).cumprod(dim=1)

    def compare(w, g, t):
        (wi, wm), gi = w, g
        diff = (torch.sort(wi, -1).values != torch.sort(gi, -1).values).any(-1)
        for b in diff.any(-1).nonzero().flatten().tolist():
            if b in first or (t > 0 and not bool(same[b, t - 1])):
                continue  # flipped before, or fed another token
            m = float(wm[b][diff[b]].max())
            if m > ROUTE_FLIP_MARGIN:
                raise AssertionError(
                    f"sequence {b} step {t}: routing differs at a router "
                    f"margin of {m:.4e}, beyond {ROUTE_FLIP_MARGIN}")
            first.setdefault(b, t)

    for l in range(L):
        blocks = [got[l * n + i][0] for i in range(n)]
        compare(want[l], torch.cat(blocks, dim=1), 0)
    for t in range(1, new):
        for l in range(L):
            compare(want[L + (t - 1) * L + l],
                    got[L * n + ((t - 1) * L + l) * n][0], t)
    return first


def greedy_held(torch, want, got, vocab: int, tol: dict,
                gap: float = LM_DECODE_GAP, stop: dict = None) -> dict:
    """A mesh generation held to the meshless one, step by step, while a
    sequence's tokens agree: the prefill's logits (step 0) within ``tol``
    (atol + rtol * |meshless|), each decode step's log-softmax within rtol
    = atol = 5e-2 of the meshless one with a max gap of ``gap``
    (``MESH_TOL``'s note); its token the meshless token, unless the
    meshless top-2 margin is within twice ``tol`` at that logit (a flip,
    counted; the sequence is compared no further).  Raises otherwise.
    Returns the largest logit error and log-softmax gap compared, the decode
    logits beyond ``tol`` (reported, not held), and the compared and the
    flipped (sequence, step)s.  ``stop``: {sequence: step} from which a
    sequence is not compared (``routing_flips``)."""
    B, T = want.tokens.shape
    live = torch.ones(B, dtype=torch.bool)
    out = {"max_err": 0.0, "prefill_err": 0.0, "max_gap": 0.0,
           "beyond_tol": 0, "compared": 0, "flips": [], "margin_min": None}
    stop = stop or {}
    for t in range(T):
        for b, at in stop.items():
            live[b] = live[b] and t < at
        w = want.logits[:, t, :vocab].float()
        g = got.logits[:, t, :vocab].float().to(w.device)
        err = (g - w).abs()
        bound = tol["atol"] + tol["rtol"] * w.abs()
        lw, lg = torch.log_softmax(w, -1), torch.log_softmax(g, -1)
        lerr = (lg - lw).abs()
        top2 = w.topk(2, dim=-1)
        margin = top2.values[:, 0] - top2.values[:, 1]
        allowed = margin <= 2 * (tol["atol"] + tol["rtol"]
                                 * top2.values[:, 0].abs())
        for b in range(B):
            if not live[b]:
                continue
            out["compared"] += 1
            out["max_err"] = max(out["max_err"], float(err[b].max()))
            out["max_gap"] = max(out["max_gap"], float(lerr[b].max()))
            if t == 0:
                out["prefill_err"] = max(out["prefill_err"],
                                         float(err[b].max()))
                if not bool((err[b] <= bound[b]).all()):
                    raise AssertionError(
                        f"sequence {b}: prefill logits differ by "
                        f"{float(err[b].max()):.4e}, beyond {tol}")
            else:
                out["beyond_tol"] += int((err[b] > bound[b]).sum())
                if float(lerr[b].max()) > gap or not bool(
                        (lerr[b] <= 5e-2 + 5e-2 * lw[b].abs()).all()):
                    raise AssertionError(
                        f"sequence {b} step {t}: log-softmax gap "
                        f"{float(lerr[b].max()):.4e} (logits "
                        f"{float(err[b].max()):.4e}), beyond {gap} or "
                        f"rtol = atol = 5e-2")
            m = float(margin[b])
            out["margin_min"] = m if out["margin_min"] is None else min(
                out["margin_min"], m)
            if int(got.tokens[b, t]) != int(want.tokens[b, t]):
                if not bool(allowed[b]):
                    raise AssertionError(
                        f"sequence {b} step {t}: token "
                        f"{int(got.tokens[b, t])} != "
                        f"{int(want.tokens[b, t])} at a top-2 margin of "
                        f"{m:.4e}, beyond twice {tol}")
                out["flips"].append((b, t))
                live[b] = False
    return out


def mesh_generate(torch, phase_launches: dict, phase_routes: dict,
                  phase: str, cfg, params, prompts, new: int, dist,
                  device: str, frames=None):
    """One generation over ``dist``'s mesh as a main path: launch counts set
    to 0 just before and read just after, the flash kernel's launches held
    to ``flash_per_prefill`` per position (``wgmma`` on the card), and the
    decode steps timed by CUDA events.  Returns (generation, step ms, the
    collective log's summary)."""
    from repro_torch.kernels import KERNELS
    from repro_torch.launch import op_cost
    from repro_torch.launch.serve_lm import generate
    from repro_torch.models import get_module

    on_card = device != "cpu"
    n = dist.mesh.size
    zero_launches(KERNELS)
    dist.log.clear()

    def run():
        return generate(cfg, params, prompts, new, frames=frames, dist=dist)

    if on_card:
        gen, step = timed_decode_steps(torch, get_module(cfg), run)
    else:
        gen, step = run(), [0.0]
    phase_launches[phase] = read_launches(KERNELS)
    phase_routes[phase] = read_routes(KERNELS)
    L = flash_per_prefill(cfg)
    fa = phase_routes[phase]["flash_attention"]
    if on_card and (phase_launches[phase] != expect(
            {"flash_attention": L * n}) or fa["wgmma"] != L * n):
        raise AssertionError(f"{phase}: launches {phase_launches[phase]} by "
                             f"route {fa}, expected {L} a prefill x {n} "
                             f"positions of flash_attention, on wgmma")
    return gen, step, op_cost.parse_collectives(dist.log)


def position_bytes(dist, tree) -> int:
    """The first active position's bytes of a nested dict of ``Sharded``
    leaves (every position's blocks have one shape)."""
    if isinstance(tree, dict):
        return sum(position_bytes(dist, v) for v in tree.values())
    t = tree.local(dist.mesh.active[0])
    return t.numel() * t.element_size()


def mesh_offset_cases(torch, np, card: str, measured: dict, flush,
                      cases=MESH_OFFSET_CASES, seed: int = 28,
                      tag: str = "mesh") -> None:
    """The flash kernel at nonzero query offsets, at the mesh prefill's
    per-position shapes (``cases``: (name, q shape, Sk, Hkv, window,
    q_offset[, causal]), causal unless given): held to its plain version
    within TOLERANCE on the ``wgmma`` route (where the head dim has it), on
    ``mma_sync`` (forced) and on ``simt`` (f32 copies); on its own route
    timed (CUDA events, L2 flushed) beside the same call at offset 0, the
    plain version and SDPA with the offset's mask, with the bound from this
    call's visible pairs.  These launches compare the kernel with its plain
    version, outside every main-path count.  The timed shapes join
    ``measured``'s."""
    import functools

    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fam
    from repro_torch.kernels import ref as kref

    gen = torch.Generator(device="cuda").manual_seed(seed)
    for name, (B, Sq, Hq, Dh), Sk, Hkv, window, off, *c in cases:
        causal = c[0] if c else True
        q = torch.randn((B, Sq, Hq, Dh), generator=gen, device="cuda")
        k = torch.randn((B, Sk, Hkv, Dh), generator=gen, device="cuda")
        v = torch.randn((B, Sk, Hkv, Dh), generator=gen, device="cuda")
        kw = {"causal": causal, "window": window, "q_offset": off}
        errs = {}
        native = fam.flash_route(torch.bfloat16, Dh)
        for route in ("wgmma", "mma_sync", "simt")[
                0 if native == "wgmma" else 1:]:
            dt = torch.float32 if route == "simt" else torch.bfloat16
            a = tuple(t.to(dt) for t in (q, k, v))
            with forced_route(fam, "flash_route", route):
                before = fam.KERNEL.route_launches[route]
                got = fam.flash_attention(*a, **kw)
                if fam.KERNEL.route_launches[route] != before + 1:
                    raise AssertionError(f"{name}: not on {route}")
            want = kref.flash_attention(*a, **kw)
            torch.testing.assert_close(
                got.float(), want.float(),
                **TOLERANCE["flash_attention"][str(dt).split(".")[-1]],
                msg=lambda m: f"{name} on {route}: {m}")
            errs[route] = float((got.float() - want.float()).abs().max())
        a = tuple(t.to(torch.bfloat16) for t in (q, k, v))
        mask = (visible_pairs(torch, Sq, Sk, causal, window, "cuda", off)
                if causal or window > 0 else None)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in a)

        def sdpa(qt=qt, kt=kt, vt=vt, mask=mask):
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                  enable_gqa=True)
        nbytes, flops = flash_work(a[0], a[1], window, causal, shift=off)
        runs = []
        for _ in range(2):
            runs.append([time_ms(torch, functools.partial(
                fam.flash_attention, **kw), a, MESH_OFFSET_TIMED, flush),
                time_ms(torch, functools.partial(
                    fam.flash_attention, causal=causal, window=window), a,
                    MESH_OFFSET_TIMED, flush),
                time_ms(torch, functools.partial(kref.flash_attention, **kw),
                        a, LAYER_TIMED_PLAIN, flush),
                time_ms(torch, sdpa, (), MESH_OFFSET_TIMED, flush)])
        r = np.mean(runs, axis=0)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = flops / BF16_FLOPS_PER_S * 1e3
        z_bytes, z_flops = flash_work(a[0], a[1], window, causal)
        res = {"ms": float(r[0]), "plain_ms": float(r[2]),
               "library_ms": float(r[3]),
               "library_call": "F.scaled_dot_product_attention(enable_gqa="
                               "True, the offset's mask)",
               "bound_ms": max(bytes_ms, ops_ms),
               "bound_by": "operations" if ops_ms > bytes_ms else "bytes",
               "bytes": int(nbytes), "flops": int(flops),
               "q_offset": off, "offset0_ms": float(r[1]),
               "offset0_bound_ms": max(
                   z_bytes / HBM_BYTES_PER_S * 1e3,
                   z_flops / BF16_FLOPS_PER_S * 1e3)}
        measured["flash_attention"]["timed"][name] = res
        print(f"[{tag}] flash_attention @ {name} (q {tuple(q.shape)} over "
              f"{Sk} keys, causal {causal}, window {window}, q_offset {off} "
              f"on {native}): max |err| vs "
              f"the plain version {errs} within {TOLERANCE['flash_attention']}"
              f"; kernel {res['ms']:.4f} ms (at offset 0: "
              f"{res['offset0_ms']:.4f} ms, bound "
              f"{res['offset0_bound_ms']:.4f}), plain {res['plain_ms']:.4f}"
              f" ms, SDPA {res['library_ms']:.4f} ms, bound "
              f"{res['bound_ms']:.4f} ms by {res['bound_by']} "
              f"({flops / 1e9:.2f} GFLOP) runs {runs} | {card}")


def offset_bwd_cases(torch, fa, seed: int = 29, shapes=MESH_OFFSET_CASES,
                     edge=MESH_BWD_EDGE_CASES) -> dict:
    """Phase 29c's cases of the attention backward at a query offset (the
    ``sp`` layout's sequence blocks): ``shapes`` (``mesh_offset_cases``'
    form; by default the last block of gemma3-1b's 2 x 2 mesh, local and
    global, and phi3.5-moe's on 1 x 4) and ``edge`` cases; o and lse from
    the forward kernel at the same offset, as in training."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    todo = [(f"bwd_{name}", (B, Sq, Hq, Hkv, Dh), Sk, window, off,
             c[0] if c else True)
            for name, (B, Sq, Hq, Dh), Sk, Hkv, window, off, *c in shapes] \
        + [e + (True,) for e in edge]
    cases = {}
    for name, (B, Sq, Hq, Hkv, Dh), Sk, window, off, causal in todo:
        q, k, v, do = (torch.randn(shape, generator=gen, device="cuda")
                       .bfloat16() for shape in
                       ((B, Sq, Hq, Dh), (B, Sk, Hkv, Dh), (B, Sk, Hkv, Dh),
                        (B, Sq, Hq, Dh)))
        o, lse = fa._forward_cuda(q, k, v, causal, window, True, off)
        cases[name] = (q, k, v, o, lse, do, {"causal": causal,
                                             "window": window,
                                             "q_offset": off})
    return cases


def time_offset_backward(torch, np, fa, cases, flush, card,
                         prefix: str = "bwd_mesh_") -> dict:
    """The backward kernel at the mesh's offset shapes (the cases named
    from ``prefix``), on its route, in two rounds: at its offset, the same
    call at
    offset 0 (the first block's), its plain version and SDPA's backward
    under the offset's mask (k and v expanded to the query heads;
    (forward + backward) - forward), beside the bound from this call's
    visible pairs (5 products at the bf16 rate, or the bytes, the
    larger)."""
    import functools

    import torch.nn.functional as F
    from repro_torch.kernels import ref

    out = {}
    for name, (q, kk, v, o, lse, do, kw) in cases.items():
        if not name.startswith(prefix):
            continue
        Sq, Sk, G = q.shape[1], kk.shape[1], q.shape[2] // kk.shape[2]
        off, window, causal = kw["q_offset"], kw["window"], kw["causal"]
        mask = visible_pairs(torch, Sq, Sk, causal, window, "cuda", off)
        qt = q.transpose(1, 2).contiguous().requires_grad_()
        kt, vt = (t.repeat_interleave(G, 2).transpose(1, 2).contiguous()
                  .requires_grad_() for t in (kk, v))
        dot = do.transpose(1, 2).contiguous()

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)

        def sdpa_fwd_bwd():
            torch.autograd.grad(sdpa(), (qt, kt, vt), dot)

        a = (q, kk, v, o, lse, do)
        at0 = {"causal": causal, "window": window}
        runs = []
        for _ in range(2):
            runs.append([
                time_ms(torch, functools.partial(fa.flash_attention_bwd,
                                                 **kw), a, MESH_OFFSET_TIMED,
                        flush),
                time_ms(torch, functools.partial(fa.flash_attention_bwd,
                                                 **at0), a,
                        MESH_OFFSET_TIMED, flush),
                time_ms(torch, functools.partial(ref.flash_attention_bwd,
                                                 **kw), a, BWD_TIMED_PLAIN,
                        flush),
                time_ms(torch, sdpa_fwd_bwd, (), MESH_OFFSET_TIMED, flush)
                - time_ms(torch, sdpa, (), MESH_OFFSET_TIMED, flush)])
        m = np.mean(runs, axis=0)
        nbytes, flops = flash_work(q, kk, window, causal, backward=True,
                                   shift=off)
        z_bytes, z_flops = flash_work(q, kk, window, causal, backward=True)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = flops / BF16_FLOPS_PER_S * 1e3
        res = {"ms": float(m[0]), "route": fa.flash_bwd_route(q.dtype,
                                                              q.shape[3]),
               "plain_ms": float(m[2]), "library_ms": float(m[3]),
               "library_call": "F.scaled_dot_product_attention backward, "
                               "k/v expanded to the query heads, the "
                               "offset's mask, (forward + backward) - "
                               "forward",
               "bound_ms": max(bytes_ms, ops_ms),
               "bound_by": "operations" if ops_ms > bytes_ms else "bytes",
               "bytes": int(nbytes), "flops": int(flops), "q_offset": off,
               "offset0_ms": float(m[1]),
               "offset0_bound_ms": max(z_bytes / HBM_BYTES_PER_S * 1e3,
                                       z_flops / BF16_FLOPS_PER_S * 1e3)}
        out[name] = res
        print(f"[mesh-train] flash_attention_bwd @ {name} (q "
              f"{tuple(q.shape)} over {Sk} keys, causal {causal}, window "
              f"{window}, q_offset {off}) on {res['route']}: kernel "
              f"{res['ms']:.4f} ms (at "
              f"offset 0: {res['offset0_ms']:.4f} ms, bound "
              f"{res['offset0_bound_ms']:.4f}), plain {res['plain_ms']:.4f}"
              f" ms, SDPA backward {res['library_ms']:.4f} ms, bound "
              f"{res['bound_ms']:.4f} ms by {res['bound_by']} "
              f"({flops / 1e9:.2f} GFLOP) runs {runs} | {card}")
        del qt, kt, vt, dot, mask
    return out


def offset_backward_phase(torch, np, card: str, measured: dict) -> None:
    """Phase 29c: ``flash_attention_bwd`` at query offsets held by
    ``check_backward``'s rule on both routes (``wgmma`` and ``mma_sync``
    forced; the Dh 16 case on its native ``mma_sync``), then timed at the
    mesh's shapes.  These launches compare the kernel with its plain
    version, outside every main-path count; the times join ``measured``'s
    ``flash_attention_bwd`` entry."""
    from repro_torch.kernels import KERNELS
    from repro_torch.kernels import flash_attention as fam

    bwd = next(k for k in KERNELS if k.name == "flash_attention_bwd")
    cases = offset_bwd_cases(torch, fam)
    checked = check_backward(torch, fam, bwd, cases, card)
    mine = measured.setdefault(bwd.name, {"max_abs_err": 0.0, "timed": {}})
    mine["max_abs_err"] = max(mine["max_abs_err"], checked["max_abs_err"])
    mine.setdefault("routes", {}).update(checked["routes"])
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    mine["timed"].update(time_offset_backward(torch, np, fam, cases, flush,
                                              card))
    del flush, cases


def mesh_phase(torch, np, card: str, phase_launches: dict,
               phase_routes: dict, measured: dict = None, gemma=None,
               moe_cfg=None, mesh_gemma=MESH_GEMMA, mesh_moe=MESH_MOE,
               device: str = "cuda") -> None:
    """Phase 28 (28x where the host has 4 cards): LM serving over a mesh,
    every position bound to ``device``.  ``gemma`` (default gemma3-1b at
    full width and depth, seed-0 weights drawn on the card) on the
    ``mesh_gemma`` mesh: the meshless generation, the 1 x 1 mesh's (bitwise
    the meshless), the mesh's held to the meshless by ``greedy_held``, and
    with 4 cards the same mesh with each position on its own card, bitwise
    the one-card mesh (28x).  Then ``moe_cfg`` (default MOE_ARCH at full
    width on MOE_LAYERS layers) on the ``mesh_moe`` mesh at its capacity
    factor (each position's queues drop their own pairs, printed), and
    held to the meshless run with the capacity factor at E / top_k, where
    no pair can drop on either path.  Then the offset kernel's checks and
    times (card only) and dbrx-132b's decode_32k accounted per position on
    a 1 x 4 meta mesh and on the 2 x 16 x 16 production mesh.  A CPU dry
    run: pass smoke configs, small ``mesh_*`` and ``device="cpu"``."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import SHAPES
    from repro_torch.launch import dryrun, specs
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.serve_lm import generate
    from repro_torch.models import moe, transformer
    from repro_torch.models.params import init_from_defs, shard_params
    from repro_torch.models.sharding import Distribution

    on_card = device != "cpu"

    def sync():
        if on_card:
            for d in range(torch.cuda.device_count()):
                torch.cuda.synchronize(d)

    def draw(cfg):
        gen = torch.Generator(device=device).manual_seed(0)
        return init_from_defs(transformer.defs(cfg), gen, device)

    # ---- gemma3: 1 x 1 bitwise, 2 x 2 held, 28x ----------------------------
    shape, batch, prompt, new = mesh_gemma
    cfg = gemma or get_config(LM_ARCH)
    defs = transformer.defs(cfg)
    params = draw(cfg)
    prompts = np.random.default_rng(28).integers(0, cfg.vocab_size,
                                                 (batch, prompt))
    generate(cfg, params, prompts, 2, device=device)  # warm-up
    t0 = time.perf_counter()
    want = generate(cfg, params, prompts, new, device=device)
    sync()
    meshless_s = time.perf_counter() - t0
    one = Distribution(make_debug_mesh((1, 1), devices=[device]))
    got1 = generate(cfg, shard_params(params, defs, one), prompts, new,
                    dist=one)
    if not (torch.equal(got1.tokens, want.tokens)
            and torch.equal(got1.logits, want.logits)) or one.log.calls:
        raise AssertionError("the 1 x 1 mesh is not the meshless path's bits")
    print(f"[mesh] {cfg.name} on a 1 x 1 mesh: tokens and logits of "
          f"{batch} x {prompt} + {new} greedy tokens bitwise the meshless "
          f"run's, no collective | {card}")
    dist = Distribution(make_debug_mesh(shape, devices=[device] * math.prod(
        shape)))
    sp = shard_params(params, defs, dist)
    generate(cfg, sp, prompts, 2, dist=dist)  # warm-up
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    phase = f"mesh-{cfg.name}"
    got, step, colls = mesh_generate(torch, phase_launches,
                                     phase_routes, phase, cfg, sp, prompts,
                                     new, dist, device)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    held = greedy_held(torch, want, got, cfg.vocab_size, MESH_TOL)
    step = np.array(step)
    print(f"[mesh] {cfg.name} on a {shape[0]} x {shape[1]} (data, model) "
          f"mesh, every position on {device}: prefill {batch} x {prompt} "
          f"{got.prefill_s * 1e3:.3f} ms (meshless {want.prefill_s * 1e3:.3f}"
          f"), decode median {float(np.median(step)):.3f} ms/step (CUDA "
          f"events; meshless loop {want.decode_s * 1e3 / max(new - 1, 1):.3f}"
          f" ms/step host wall), loop {got.decode_s * 1e3:.3f} ms wall, "
          f"meshless generation {meshless_s:.3f} s wall; flash_attention "
          f"launches {phase_launches[phase]['flash_attention']} by route "
          f"{phase_routes[phase]['flash_attention']}; peak device memory "
          f"{peak / 2**30:.3f} GiB | {card}")
    print(f"[mesh] {cfg.name} held to the meshless run over "
          f"{held['compared']} compared (sequence, step)s: prefill logits "
          f"max |diff| {held['prefill_err']:.4e} within {MESH_TOL}; decode "
          f"log-softmax max gap {held['max_gap']:.4e} (held to "
          f"{LM_DECODE_GAP}), logits max |diff| {held['max_err']:.4e}, "
          f"{held['beyond_tol']} decode logits beyond {MESH_TOL} (of "
          f"{held['compared'] * cfg.vocab_size}); greedy flips "
          f"{held['flips']} ({len(held['flips'])}, each where the meshless "
          f"top-2 margin is within twice the tolerance); smallest margin "
          f"compared {held['margin_min']:.4e} | {card}")
    print(f"[mesh] {cfg.name} collectives of the generation (per position, "
          f"the port's schedule: weights gathered at each use): "
          f"{json.dumps(colls)} | {card}")
    print(f"[mesh] {cfg.name} per position: parameters "
          f"{position_bytes(dist, sp) / 2**20:.3f} MiB at rest (views of "
          f"the one tree on this card) | {card}")
    if on_card and torch.cuda.device_count() >= math.prod(shape):
        n = math.prod(shape)
        dx = Distribution(make_debug_mesh(shape, devices=[
            f"cuda:{i}" for i in range(n)]))
        spx = shard_params(params, defs, dx)
        generate(cfg, spx, prompts, 2, dist=dx)  # warm-up
        gx, stepx, _ = mesh_generate(torch, phase_launches,
                                     phase_routes, f"{phase}-x", cfg, spx,
                                     prompts, new, dx, device)
        if not (torch.equal(gx.tokens, got.tokens)
                and torch.equal(gx.logits, got.logits)):
            raise AssertionError("phase 28x: positions on their own cards "
                                 "are not the one-card mesh's bits")
        print(f"[mesh-x] phase 28x: {cfg.name} with each position on its "
              f"own card (cuda:0-{n - 1}): tokens and logits bitwise the "
              f"one-card mesh; prefill {gx.prefill_s * 1e3:.3f} ms, decode "
              f"median {float(np.median(stepx)):.3f} ms/step | {card}")
        del spx, gx
    else:
        have = torch.cuda.device_count() if on_card else 0
        print(f"[mesh-x] phase 28x did not run: this host has {have} CUDA "
              f"device(s), and the {shape[0]} x {shape[1]} mesh with each "
              f"position on its own card needs {math.prod(shape)} | {card}")
    del params, sp, want, got, got1
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    # ---- the MoE: the expert-parallel all_to_all ---------------------------
    shape, batch, prompt, new = mesh_moe
    cfg = moe_cfg or dataclasses.replace(get_config(MOE_ARCH),
                                         n_layers=MOE_LAYERS)
    defs = transformer.defs(cfg)
    params = draw(cfg)
    prompts = np.random.default_rng(29).integers(0, cfg.vocab_size,
                                                 (batch, prompt))
    dist = Distribution(make_debug_mesh(shape, devices=[device] * math.prod(
        shape)))
    sp = shard_params(params, defs, dist)
    generate(cfg, sp, prompts, 2, dist=dist)  # warm-up
    phase = f"mesh-{cfg.name}"
    with recorded_router(moe, []) as routes:
        got, step, colls = mesh_generate(torch, phase_launches,
                                         phase_routes, phase, cfg, sp,
                                         prompts, new, dist, device)
    n = math.prod(shape)
    T_loc = batch * prompt // n
    cap = -(-(moe.capacity(cfg, T_loc)) // 8) * 8
    dropped = sum(int((~moe._dispatch(idx.reshape(T_loc, -1), cfg.n_experts,
                                      cap)[1]).sum())
                  for idx, _ in routes[:cfg.n_layers * n])
    print(f"[mesh] {cfg.name} ({cfg.n_layers} layers, full width) on a "
          f"{shape[0]} x {shape[1]} mesh, experts over \"model\" "
          f"({cfg.n_experts // shape[1]} a position, never gathered), "
          f"capacity factor {cfg.capacity_factor}: {batch} x {prompt} "
          f"prefill {got.prefill_s * 1e3:.3f} ms, {new} greedy tokens, "
          f"decode median {float(np.median(step)):.3f} ms/step; each "
          f"position's {T_loc} tokens into {cap} rows per expert: "
          f"{dropped} of {T_loc * n * cfg.top_k * cfg.n_layers} (token, "
          f"expert) pairs dropped by the positions' own queues; "
          f"flash_attention launches "
          f"{phase_launches[phase]['flash_attention']}; collectives "
          f"{json.dumps(colls)} | {card}")
    roomy = dataclasses.replace(cfg, capacity_factor=cfg.n_experts
                                / cfg.top_k)
    with recorded_router(moe, []) as want_routes:
        want = generate(roomy, params, prompts, new, device=device)
    with recorded_router(moe, []) as got_routes:
        got = generate(roomy, sp, prompts, new, dist=dist)
    flips = routing_flips(torch, want_routes, got_routes, cfg.n_layers, n,
                          new, (want.tokens, got.tokens))
    held = greedy_held(torch, want, got, cfg.vocab_size, MESH_TOL,
                       stop=flips)
    print(f"[mesh] {cfg.name} at capacity factor {roomy.capacity_factor} "
          f"(E / top_k: no pair can drop on either path) held to the "
          f"meshless run over {held['compared']} compared (sequence, "
          f"step)s: prefill logits max |diff| {held['prefill_err']:.4e} "
          f"within {MESH_TOL}; decode log-softmax max gap "
          f"{held['max_gap']:.4e} (held to {LM_DECODE_GAP}), logits max "
          f"|diff| {held['max_err']:.4e}, {held['beyond_tol']} beyond "
          f"{MESH_TOL}; routing flips (sequence: first step, each at a "
          f"meshless router margin within {ROUTE_FLIP_MARGIN}) {flips}; "
          f"greedy flips {held['flips']} | {card}")
    del params, sp, want, got
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    # ---- the offset kernel, then dbrx-132b's accounting --------------------
    if on_card and measured is not None:
        flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
        mesh_offset_cases(torch, np, card, measured, flush)
        del flush
    dbrx = get_config("dbrx-132b")
    shape = SHAPES["decode_32k"]
    mesh = make_debug_mesh((1, 4), devices="meta")
    cell = specs.build_cell(dbrx, shape, mesh.run_only(0))
    _, mem, _ = dryrun.account(cell)
    params_b = position_bytes(cell.meta["dist"], cell.args[0])
    cache_b = position_bytes(cell.meta["dist"], cell.args[1])
    rec = dryrun.run_cell("dbrx-132b", "decode_32k", "multi")
    print(f"[mesh] dbrx-132b decode_32k accounted on meta, per position: "
          f"1 x 4 mesh: parameters {params_b / 2**30:.3f} GiB, cache "
          f"{cache_b / 2**30:.3f} GiB, peak {mem['peak_bytes'] / 2**30:.3f} "
          f"GiB; 2 x 16 x 16 mesh ({rec['n_chips']} positions): arguments "
          f"{rec['memory']['argument_bytes'] / 2**30:.3f} GiB, peak "
          f"{rec['memory']['peak_bytes'] / 2**30:.3f} GiB (fits an 80 GiB "
          f"card: {rec['fits']}), collectives "
          f"{rec['collectives']['wire_bytes'] / 2**30:.3f} GiB on the wire, "
          f"roofline {rec['roofline']['dominant']} | {card}")


def mesh_train_accounting(out_path: str) -> int:
    """Phase 29's accounting on the meta device (run as ``python3
    chip_smoke.py --mesh-train-accounting OUT``, a subprocess the smoke
    starts before phase 11, so that it runs beside the card's phases):
    gemma3-1b's 2 x 2 train cell under each of ``MESH_TRAIN_LAYOUTS`` and
    MOE_ARCH's 1 x 4 cell with every position active (the positions share
    one card: their bytes summed), and dbrx-132b's ``train_4k`` on the
    2 x 16 x 16 production mesh (one position standing for all) under each
    of ``MESH_TRAIN_DBRX``; written to ``out_path`` as JSON."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun

    cfg = dataclasses.replace(get_config(LM_ARCH), remat=True,
                              loss_chunk=LM_TRAIN_CHUNK)
    moe_cfg = dataclasses.replace(get_config(MOE_ARCH),
                                  n_layers=MESH_TRAIN_MOE_LAYERS, remat=True,
                                  loss_chunk=LM_TRAIN_CHUNK)
    moe_cfg = dataclasses.replace(moe_cfg, capacity_factor=moe_cfg.n_experts
                                  / moe_cfg.top_k)
    out = {"gemma": {}, "dbrx": {}}
    for layout, _ in MESH_TRAIN_LAYOUTS:
        out["gemma"][layout] = mesh_train_peak(cfg, layout, *MESH_TRAIN_GEMMA)
    out["moe"] = mesh_train_peak(moe_cfg, "baseline", *MESH_TRAIN_MOE[:3])
    for variant in MESH_TRAIN_DBRX:
        t0 = time.perf_counter()
        rec = dryrun.run_cell("dbrx-132b", "train_4k", "multi",
                              variant=variant)
        out["dbrx"][variant] = {k: rec[k] for k in (
            "memory", "fits", "collectives", "roofline", "n_chips",
            "device_bytes")} | {"wall_s": time.perf_counter() - t0}
    Path(out_path).write_text(json.dumps(out))
    return 0


def mesh_train_peak(cfg, layout: str, shape, batch: int, seq: int) -> dict:
    """The accounted peak bytes of ``cfg``'s train cell at ``batch`` x
    ``seq`` under ``layout`` (a variant) on a ``shape`` meta mesh with
    every position active (their bytes summed, as one card holding them
    all would; each position's parameter blocks counted as its own, which
    the card shares where a block is a view)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun, specs
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.variants import apply_variant

    t0 = time.perf_counter()
    cell = specs.build_cell(apply_variant(cfg, layout),
                            ShapeConfig("train", seq, batch, "train"),
                            make_debug_mesh(shape, devices="meta"))
    _, mem, _ = dryrun.account(cell)
    return {"peak_bytes": mem["peak_bytes"],
            "argument_bytes": mem["argument_bytes"], "layers": cfg.n_layers,
            "wall_s": time.perf_counter() - t0}


def start_mesh_train_accounting(out_dir: str):
    """``mesh_train_accounting`` in a subprocess: (the process, its JSON's
    path, its log's path)."""
    out = os.path.join(out_dir, "mesh_train_accounting.json")
    log = os.path.join(out_dir, "mesh_train_accounting.log")
    with open(log, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()),
             "--mesh-train-accounting", out], stdout=f,
            stderr=subprocess.STDOUT)
    return proc, out, log


def finish_mesh_train_accounting(started, timeout: float = 900.0) -> dict:
    """Waits for ``start_mesh_train_accounting``'s subprocess and reads its
    JSON; raises (the process stopped) where it failed."""
    proc, out, log = started
    try:
        rc = proc.wait(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if rc != 0:
        raise AssertionError(f"the mesh training accounting failed (exit "
                             f"{rc}): {Path(log).read_text()[-3000:]}")
    return json.loads(Path(out).read_text())


def bit_sums(torch, tree) -> list:
    """Each leaf's bits summed (its 32-bit words as int64): equal sums for
    equal bits, cheap to keep between two runs."""
    from repro_torch.train.optimizer import tree_leaves

    return [int(t.detach().contiguous().view(torch.int32).to(torch.int64)
                .sum()) for t in tree_leaves(tree)]


def mesh_bit_sums(torch, dist, tree) -> list:
    """``bit_sums`` of every position's block of every leaf."""
    from repro_torch.train.optimizer import tree_leaves

    return [bit_sums(torch, leaf.local(i)) for leaf in tree_leaves(tree)
            for i in dist.mesh.active]


@contextlib.contextmanager
def recorded_offsets(fam, record: list):
    """Every ``flash_attention_bwd`` call's ``q_offset - kv_offset``
    appended to ``record`` (the autograd backward calls it by its module
    name)."""
    inner = fam.flash_attention_bwd

    def bwd(*a, **kw):
        record.append(kw.get("q_offset", 0) - kw.get("kv_offset", 0))
        return inner(*a, **kw)

    fam.flash_attention_bwd = bwd
    try:
        yield record
    finally:
        fam.flash_attention_bwd = inner


def train_routing_flips(torch, want: list, got: list, L: int, n: int
                        ) -> dict:
    """Where a 1 x n mesh's routing of one training forward (``got``: L x n
    ``recorded_router`` entries, layer by layer, each position's sequence
    block) differs from the meshless forward's (``want``: L entries):
    {sequence: first layer}; a sequence's first flip changes its later
    layers' inputs, so it is compared no further.  Raises where a first
    flip's meshless k / k+1 margin exceeds ``ROUTE_FLIP_MARGIN``."""
    first = {}
    for l in range(L):
        wi, wm = want[l]
        gi = torch.cat([got[l * n + p][0] for p in range(n)], dim=1)
        diff = (torch.sort(wi, -1).values != torch.sort(gi, -1).values
                ).any(-1)
        for b in diff.any(-1).nonzero().flatten().tolist():
            if b in first:
                continue
            m = float(wm[b][diff[b]].max())
            if m > ROUTE_FLIP_MARGIN:
                raise AssertionError(f"sequence {b} layer {l}: routing "
                                     f"differs at a router margin {m:.3e}")
            first[b] = l
    return first


def mesh_train_steps(torch, np, phase_launches, phase_routes, phase: str,
                     cfg, params, opt, state, batches, dist, device,
                     offsets: list = None):
    """``len(batches)`` train steps over ``dist``'s mesh as a main path
    (launch counts set to 0 just before and read just after), each timed on
    the host clock after a synchronizing loss read: every step's attention
    launches held to L forward + L recompute and L backward per position
    (L = ``flash_per_prefill``), all on ``wgmma`` on the card.  Returns
    (losses, step seconds, params, state, the last step's collectives
    summary)."""
    from repro_torch.kernels import KERNELS
    from repro_torch.kernels import flash_attention as fam
    from repro_torch.launch import op_cost
    from repro_torch.launch.train import train_step

    on_card = device != "cpu"
    L, n = flash_per_prefill(cfg), len(dist.mesh.active)
    zero_launches(KERNELS)
    losses, walls, colls = [], [], None
    with (recorded_offsets(fam, offsets) if offsets is not None
          else contextlib.nullcontext()):
        for b in batches:
            f0, b0 = (dict(fam.KERNEL.route_launches),
                      dict(fam.BWD_KERNEL.route_launches))
            dist.log.clear()
            t0 = time.perf_counter()
            params, state, loss = train_step(cfg, params, opt, state, b,
                                             donate=True, dist=dist)
            losses.append(float(loss))  # synchronizes
            walls.append(time.perf_counter() - t0)
            colls = op_cost.parse_collectives(dist.log)
            fwd = {r: fam.KERNEL.route_launches[r] - f0[r] for r in f0}
            back = {r: fam.BWD_KERNEL.route_launches[r] - b0[r] for r in b0}
            if on_card and (fwd != {"wgmma": 2 * L * n, "mma_sync": 0,
                                    "simt": 0}
                            or back != {"wgmma": L * n, "mma_sync": 0}):
                raise AssertionError(
                    f"{phase}: a step's forward launches {fwd}, backward "
                    f"{back}; expected {L} calls x {n} positions forward, "
                    f"recompute and backward, all on wgmma")
    phase_launches[phase] = read_launches(KERNELS)
    phase_routes[phase] = read_routes(KERNELS)
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{phase}: losses {losses}")
    return losses, walls, params, state, colls


def held_losses(phase: str, got: list, want: list) -> float:
    """The mesh's losses against the meshless run's, step by step, within
    ``MESH_TRAIN_LOSS_TOL``; returns the largest difference."""
    tol = MESH_TRAIN_LOSS_TOL
    worst = 0.0
    for s, (a, b) in enumerate(zip(got, want)):
        worst = max(worst, abs(a - b))
        if abs(a - b) > tol["atol"] + tol["rtol"] * abs(b):
            raise AssertionError(f"{phase}: step {s} loss {a} against the "
                                 f"meshless {b}, beyond {tol}")
    return worst


def profiled_mesh_step(torch, cfg, params, opt, state, batch, dist):
    """One more mesh step under ``torch.profiler``: (host wall us, device
    rows, device ms by kind), or None where the profiler saw no device
    time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.train import train_step

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=False) as prof:
        t0 = time.perf_counter()
        out = train_step(cfg, params, opt, state, batch, donate=True,
                         dist=dist)
        float(out[2])
        wall_us = (time.perf_counter() - t0) * 1e6
    del out
    rows, _ = kineto_rows(torch, prof, marks=())
    if not rows:
        return None
    return wall_us, rows, by_category(rows)


def mesh_train_phase(torch, np, card: str, phase_launches: dict,
                     phase_routes: dict, acct: dict, gemma=None,
                     moe_cfg=None, mesh_gemma=MESH_TRAIN_GEMMA,
                     mesh_moe=MESH_TRAIN_MOE, layouts=MESH_TRAIN_LAYOUTS,
                     device: str = "cuda") -> None:
    """Phase 29 (29a, 29b, 29d, 29x; 29c is ``offset_backward_phase``): LM
    training over a mesh, every position bound to ``device``.  ``gemma``
    (default gemma3-1b at full size, remat, the CE in chunks of
    LM_TRAIN_CHUNK; seed-0 weights drawn on the card), sized from ``acct``
    (``mesh_train_accounting``'s): the meshless ``train_step``s, the first
    against a 1 x 1 mesh's (bitwise: loss, new parameters, m and v); step
    1's layer-0 gradients on the ``mesh_gemma`` mesh under each of
    ``layouts`` against the meshless (under ``sp`` the backward runs at
    query offsets and the all-gathers' transposes sum each block's dk and
    dv), then that layout's steps, held to the meshless losses; with 4
    cards one step with each position on its own card, bitwise the
    one-card mesh's (29x).  Then ``moe_cfg`` (default MOE_ARCH
    at full width on MESH_TRAIN_MOE_LAYERS layers, capacity factor E /
    top_k) on the ``mesh_moe`` mesh against its meshless run, its routing
    flips counted.  Then dbrx-132b's accounting from ``acct`` (29d).  A
    CPU dry run: smoke configs, small meshes' batch and sequence, the
    accounting of ``mesh_train_accounting`` at those, ``device="cpu"``."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.train import (make_batch, mesh_loss_and_grads,
                                          train_step)
    from repro_torch.launch.variants import apply_variant
    from repro_torch.models import moe, transformer
    from repro_torch.models.params import (init_from_defs, layout_pspecs,
                                           shard_params)
    from repro_torch.models.sharding import Distribution
    from repro_torch.train.optimizer import adamw, tree_leaves, tree_map

    on_card = device != "cpu"

    def free():
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()

    def draw(cfg):
        gen = torch.Generator(device=device).manual_seed(0)
        return init_from_defs(transformer.defs(cfg), gen, device)

    def rel(a, b) -> float:
        a, b = a.double(), b.double()
        return float((a - b).norm() / b.norm().clamp_min(1e-30))

    # ---- 29a. gemma3-1b on 2 x 2: sizing, 1 x 1 bitwise, the layouts ------
    shape, batch, seq = mesh_gemma
    n = math.prod(shape)
    cfg = gemma or dataclasses.replace(get_config(LM_ARCH), remat=True,
                                       loss_chunk=LM_TRAIN_CHUNK)
    cap = dryrun.device_bytes()
    for layout, sized in acct["gemma"].items():
        fits = sized["peak_bytes"] <= DRYRUN_MEM_SHARE * cap
        print(f"[mesh-train] {cfg.name} {batch} x {seq} train step on a "
              f"{shape[0]} x {shape[1]} mesh under {layout}, accounted on "
              f"meta (the {n} positions' bytes summed, each position's "
              f"parameter blocks its own): peak "
              f"{sized['peak_bytes'] / 2**30:.3f} GiB (arguments "
              f"{sized['argument_bytes'] / 2**30:.3f} GiB) of the card's "
              f"{cap / 2**30:.3f} GiB: "
              + ("no cut" if fits else "above DRYRUN_MEM_SHARE")
              + f" ({sized['wall_s']:.1f} s) | {card}")
        if not fits:
            raise AssertionError(f"{cfg.name} on the mesh does not fit the "
                                 f"card at full depth")
    defs = transformer.defs(cfg)
    params = draw(cfg)
    opt = adamw(LM_TRAIN_LR)
    steps = max(k for _, k in layouts)
    batches = [make_batch(cfg, batch, seq, 0, s, device)
               for s in range(steps)]
    t0 = time.perf_counter()
    p, st, loss = train_step(cfg, params, opt, opt.init(params), batches[0],
                             donate=True)
    one = Distribution(make_debug_mesh((1, 1), devices=[device]))
    sp1 = shard_params(params, defs, one)
    q, s1, loss1 = train_step(cfg, sp1, opt, opt.init(sp1, one), batches[0],
                              donate=True, dist=one)
    same = torch.equal(loss, loss1) and all(
        torch.equal(a, b.local(0)) for t, u in ((p, q), (st["m"], s1["m"]),
                                                (st["v"], s1["v"]))
        for a, b in zip(tree_leaves(t), tree_leaves(u)))
    if not same or one.log.calls:
        raise AssertionError("the 1 x 1 mesh's train step is not the "
                             "meshless step's bits")
    print(f"[mesh-train] {cfg.name} on a 1 x 1 mesh: one train step's loss, "
          f"new parameters, m and v bitwise the meshless train_step's, no "
          f"collective | {card}")
    del q, s1, sp1
    want = [float(loss)]
    for s in range(1, steps):
        p, st, loss = train_step(cfg, p, opt, st, batches[s], donate=True)
        want.append(float(loss))
    meshless_s = time.perf_counter() - t0
    del p, st
    free()
    leaves = tree_map(lambda t: t.detach().requires_grad_(), params)
    transformer.loss_fn(cfg, leaves, batches[0])[0].backward()
    g0 = {k: v.grad[0].clone() for k, v in leaves["layers"].items()}
    del leaves
    free()
    one_card = {}
    for li, (layout, k) in enumerate(layouts):
        c = apply_variant(cfg, layout)
        dist = Distribution(make_debug_mesh(shape, devices=[device] * n))
        sp = shard_params(params, defs, dist,
                          layout_pspecs(defs, dist, zero=c.zero3))
        _, grads = mesh_loss_and_grads(c, sp, batches[0], dist=dist)
        errs = {name: rel(dist.full(g)[0], g0[name])
                for name, g in grads["layers"].items()}
        del grads
        free()
        if max(errs.values()) > MESH_GRAD_REL:
            raise AssertionError(f"{layout}: step 1's layer-0 gradients "
                                 f"{errs} beyond {MESH_GRAD_REL}")
        print(f"[mesh-train] {cfg.name} {layout}: step 1's layer-0 "
              f"gradients against the meshless, |mesh - meshless| / "
              f"|meshless| per leaf (within {MESH_GRAD_REL}): "
              + ", ".join(f"{name} {e:.3e}" for name, e in
                          sorted(errs.items())) + f" | {card}")
        state = opt.init(sp, dist, layout_pspecs(defs, dist, zero=True)
                         if c.zero1 else None)
        phase = f"mesh-train-{cfg.name}" + (f"-{layout}" if li else "")
        offsets = []
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        losses, walls, sp, state, colls = mesh_train_steps(
            torch, np, phase_launches, phase_routes, phase, c, sp, opt,
            state, batches[:k], dist, device, offsets)
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        worst = held_losses(phase, losses, want)
        shifted = sum(1 for o in offsets if o)
        if (c.attn_layout == "sp") != (shifted > 0):
            raise AssertionError(f"{phase}: {shifted} backward calls at a "
                                 f"nonzero offset")
        ms = np.array(walls[1:] or walls) * 1e3
        print(f"[mesh-train] {cfg.name} {layout} on a {shape[0]} x "
              f"{shape[1]} (data, model) mesh, every position on {device}: "
              f"{k} steps of {batch} x {seq} (remat, loss chunk "
              f"{c.loss_chunk}, AdamW lr {LM_TRAIN_LR}, the state handed "
              f"over): step {float(np.median(ms)):.3f} ms host wall median "
              f"of steps 2+ ({[round(w * 1e3, 3) for w in walls]}), "
              f"{batch * seq / float(np.median(ms)) * 1e3:.0f} tokens/s "
              f"(meshless: {k} of {steps} steps in {meshless_s:.3f} s with "
              f"the 1 x 1 step); peak device memory {peak / 2**30:.3f} GiB; "
              f"losses {losses} against the meshless {want[:k]} (max |diff| "
              f"{worst:.4e} within {MESH_TRAIN_LOSS_TOL}); attention per "
              f"step {cfg.n_layers} x {n} forward + recompute "
              f"{phase_routes[phase]['flash_attention']} and backward "
              f"{phase_routes[phase]['flash_attention_bwd']} in all, "
              f"{shifted} of {len(offsets)} backward calls at a nonzero "
              f"query offset | {card}")
        print(f"[mesh-train] {cfg.name} {layout} collectives of one step "
              f"(per position, result bytes; the gradient sums, ZeRO-1's "
              f"parameter gather): {json.dumps(colls)} | {card}")
        if on_card and li == 0:
            prof = profiled_mesh_step(torch, c, sp, opt, state, batches[0],
                                      dist)
            if prof is None:
                print("[mesh-train] profiled step: not measured "
                      "(torch.profiler saw no device time)")
            else:
                wall_us, rows, cats = prof
                busy, top = busy_and_top(rows, k=8)
                print(f"[mesh-train] {cfg.name} {layout} profiled step: "
                      f"device busy {busy / 1e3:.3f} ms of "
                      f"{wall_us / 1e3:.3f} ms host wall (busy share "
                      f"{busy / wall_us:.4f}); device ms by kind: "
                      + ", ".join(f"{k2} {v:.3f}" for k2, v in cats.items())
                      + f" | {card}")
                for us, name, count in top:
                    print(f"[mesh-train]   {us / 1e3:9.3f} ms  x{count:<5d} "
                          f"{name[:70]} | {card}")
            del prof
        if li == 0:
            one_card = {"losses": losses, "steps": k,
                        "bits": mesh_bit_sums(torch, dist, sp)}
        del sp, state
        free()
    # ---- 29x. each position on its own card --------------------------------
    if on_card and torch.cuda.device_count() >= n:
        c = apply_variant(cfg, layouts[0][0])
        dx = Distribution(make_debug_mesh(shape, devices=[
            f"cuda:{i}" for i in range(n)]))
        spx = shard_params(params, defs, dx)
        stx, lx = opt.init(spx, dx), []
        for b in batches[:one_card["steps"]]:
            spx, stx, loss = train_step(c, spx, opt, stx, b, donate=True,
                                        dist=dx)
            lx.append(float(loss))
        if lx != one_card["losses"] or \
                mesh_bit_sums(torch, dx, spx) != one_card["bits"]:
            raise AssertionError("phase 29x: positions on their own cards "
                                 "are not the one-card mesh's bits")
        print(f"[mesh-train-x] phase 29x: {cfg.name} with each position on "
              f"its own card (cuda:0-{n - 1}): {len(lx)} train steps' losses "
              f"and new parameters bitwise the one-card mesh's | {card}")
        del spx, stx
    else:
        have = torch.cuda.device_count() if on_card else 0
        print(f"[mesh-train-x] phase 29x did not run: this host has {have} "
              f"CUDA device(s), and the {shape[0]} x {shape[1]} mesh with "
              f"each position on its own card needs {n} | {card}")
    del params, batches, g0
    free()

    # ---- 29b. the MoE on 1 x 4: the expert-parallel all_to_all trained -----
    shape, batch, seq, k = mesh_moe
    n = math.prod(shape)
    cfg = moe_cfg or dataclasses.replace(
        get_config(MOE_ARCH), n_layers=MESH_TRAIN_MOE_LAYERS, remat=True,
        loss_chunk=LM_TRAIN_CHUNK)
    cfg = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)
    sized = acct["moe"]
    held = torch.cuda.memory_allocated() if on_card else 0
    print(f"[mesh-train] {cfg.name} ({cfg.n_layers} layers, full width) "
          f"{batch} x {seq} train step on a {shape[0]} x {shape[1]} mesh "
          f"accounted on meta (positions summed): peak "
          f"{sized['peak_bytes'] / 2**30:.3f} GiB; the process holds "
          f"{held / 2**30:.3f} GiB before it | {card}")
    defs = transformer.defs(cfg)
    params = draw(cfg)
    opt = adamw(LM_TRAIN_LR)
    batches = [make_batch(cfg, batch, seq, 0, s, device) for s in range(k)]
    # one copy of the parameters at a time beside the step's state (the
    # step's new ones replace them): two do not fit
    want, p, st = [], params, opt.init(params)
    del params
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    with recorded_router(moe, []) as want_routes:
        for b in batches:
            p, st, loss = train_step(cfg, p, opt, st, b, donate=True)
            want.append(float(loss))
    want_routes = want_routes[:cfg.n_layers]  # step 1's forward
    want_peak = torch.cuda.max_memory_allocated() if on_card else 0
    del p, st
    free()
    dist = Distribution(make_debug_mesh(shape, devices=[device] * n))
    sp = shard_params(draw(cfg), defs, dist)  # the same weights, again
    state = opt.init(sp, dist)
    phase = f"mesh-train-{cfg.name}"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    with recorded_router(moe, []) as got_routes:
        losses, walls, sp, state, colls = mesh_train_steps(
            torch, np, phase_launches, phase_routes, phase, cfg, sp, opt,
            state, batches, dist, device)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    flips = train_routing_flips(torch, want_routes,
                                got_routes[:cfg.n_layers * n],
                                cfg.n_layers, n)
    worst = held_losses(phase, losses, want)
    print(f"[mesh-train] {cfg.name} ({cfg.n_layers} layers, full width) on a "
          f"{shape[0]} x {shape[1]} mesh, experts over \"model\" "
          f"({cfg.n_experts // shape[1]} a position), capacity factor "
          f"{cfg.capacity_factor} (E / top_k: nothing drops): {k} steps of "
          f"{batch} x {seq}: step ms host wall "
          f"{[round(w * 1e3, 3) for w in walls]}; peak device memory "
          f"{peak / 2**30:.3f} GiB (the meshless steps' "
          f"{want_peak / 2**30:.3f}); losses {losses} against the meshless "
          f"{want} (max |diff| {worst:.4e} within {MESH_TRAIN_LOSS_TOL}); "
          f"step 1's routing flips (sequence: first layer, each at a "
          f"meshless router margin within {ROUTE_FLIP_MARGIN}) {flips}; "
          f"attention {phase_routes[phase]['flash_attention']} forward + "
          f"recompute, {phase_routes[phase]['flash_attention_bwd']} "
          f"backward | {card}")
    print(f"[mesh-train] {cfg.name} collectives of one step: "
          f"{json.dumps(colls)} | {card}")
    del sp, state, batches
    free()

    if on_card:  # the scratch rule holds at every shape, offsets included
        from repro_torch.kernels import flash_attention as fam

        asked = dict(fam.SCRATCH_ASKED)
        bad = {k: (v, fam.scratch_rule(*k)) for k, v in asked.items()
               if fam.scratch_rule(*k) != v}
        if not asked or bad:
            raise AssertionError(f"scratch rule: {len(asked)} backward "
                                 f"shapes asked, Python copy differs at {bad}")
        print(f"[mesh-train] scratch rule: the Python copy equals the "
              f"library's at all {len(asked)} backward shapes this run "
              f"launched, the offset ones included | {card}")

    # ---- 29d. dbrx-132b's train_4k per position on 2 x 16 x 16 -------------
    for variant, rec in acct["dbrx"].items():
        mem = rec["memory"]
        print(f"[mesh-train] dbrx-132b train_4k on the 2 x 16 x 16 meta mesh "
              f"({rec['n_chips']} positions, one standing for all) under "
              f"{variant}: per position arguments "
              f"{mem['argument_bytes'] / 2**30:.3f} GiB, peak "
              f"{mem['peak_bytes'] / 2**30:.3f} GiB: fits one "
              f"{rec['device_bytes'] / 2**30:.3f} GiB position: "
              f"{rec['fits']}; collectives "
              f"{rec['collectives']['wire_bytes'] / 2**30:.3f} GiB on the "
              f"wire; roofline {rec['roofline']['dominant']} "
              f"({rec['wall_s']:.1f} s of accounting) | {card}")


def forced_held(torch, np, mod, cfg, params, sp, prompts, frames, tokens,
                dist) -> dict:
    """The mesh's prefill and decode, teacher-forced on ``tokens`` (the
    meshless greedy run's), against the meshless run's: the prefill's
    logits within ``MESH_TOL``, each decode step's largest log-softmax gap
    within ``LM_DECODE_GAP``, each plus ``MESH_FAMILY_SPREAD_K`` times the
    meshless run's own at that step when each half of the batch runs alone
    (its spread: only its products' row counts change).  Raises otherwise;
    returns the prefill's error and spread, and the gaps and spreads by
    decode step."""
    def inputs(rows):
        p = torch.as_tensor(prompts[rows], device=tokens.device)
        return p if frames is None else {"frames": frames[rows], "tokens": p}

    every = slice(None)
    ref, _ = teacher_forced(torch, mod, cfg, params, inputs(every), tokens)
    B = tokens.shape[0]
    halves = torch.cat([teacher_forced(torch, mod, cfg, params, inputs(h),
                                       tokens[h])[0]
                        for h in (slice(0, B // 2), slice(B // 2, B))])
    got, _ = teacher_forced(torch, mod, cfg, sp, inputs(every), tokens,
                            dist=dist)
    got = got.to(ref.device)

    def gaps(a):
        d = (torch.log_softmax(a.float(), -1)
             - torch.log_softmax(ref.float(), -1)).abs()
        return [round(float(x), 4) for x in d.amax(dim=(0, 2))]

    err = (got[:, 0].float() - ref[:, 0].float()).abs()
    spread = float((halves[:, 0].float() - ref[:, 0].float()).abs().max())
    bound = MESH_TOL["atol"] + MESH_TOL["rtol"] * ref[:, 0].float().abs() \
        + MESH_FAMILY_SPREAD_K * spread
    out = {"prefill_err": float(err.max()), "prefill_spread": spread,
           "gaps": gaps(got)[1:], "spread": gaps(halves)[1:]}
    if not bool((err <= bound).all()):
        raise AssertionError(f"{cfg.name}: prefill logits differ by "
                             f"{out['prefill_err']:.4e}, beyond {MESH_TOL} "
                             f"+ {MESH_FAMILY_SPREAD_K} x {spread:.4e}")
    for t, (g, sp_) in enumerate(zip(out["gaps"], out["spread"]), 1):
        if g > LM_DECODE_GAP + MESH_FAMILY_SPREAD_K * sp_:
            raise AssertionError(f"{cfg.name} decode step {t}: log-softmax "
                                 f"gap {g} beyond {LM_DECODE_GAP} + "
                                 f"{MESH_FAMILY_SPREAD_K} x {sp_}")
    return out


def family_offset_phase(torch, np, card: str, measured: dict) -> None:
    """Phase 30c: the attention at the family meshes' per-position shapes
    (``MESH_FAMILY_CASES``: zamba2's shared block causal at its block's
    offset; seamless's encoder and cross attention, not causal, each
    block's offset passed and ignored, the cross attention's query block a
    slice of the shorter target sequence; the smoke configs' Dh 16).  The
    forward held to its plain version on its routes and timed beside offset
    0, the plain version and SDPA (``mesh_offset_cases``); the backward,
    o and lse from the forward kernel at the offset, held by
    ``check_backward``'s rule on its own route (at these rows of 1024 keys
    the ``mma_sync`` route, which rounds ds once, is not forced: ROADMAP
    section 3, 18) and timed beside offset 0, its plain version and SDPA's
    backward.  These launches compare the kernels with their plain
    versions, outside every main-path count."""
    from repro_torch.kernels import KERNELS
    from repro_torch.kernels import flash_attention as fam

    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    mesh_offset_cases(torch, np, card, measured, flush,
                      cases=MESH_FAMILY_CASES, seed=30, tag="mesh-family")
    bwd = next(k for k in KERNELS if k.name == "flash_attention_bwd")
    cases = offset_bwd_cases(torch, fam, seed=30, shapes=MESH_FAMILY_CASES,
                             edge=())
    checked = check_backward(torch, fam, bwd, cases, card, forced=())
    mine = measured[bwd.name]
    mine["max_abs_err"] = max(mine["max_abs_err"], checked["max_abs_err"])
    mine.setdefault("routes", {}).update(checked["routes"])
    mine["timed"].update(time_offset_backward(torch, np, fam, cases, flush,
                                              card, prefix="bwd_fam_"))
    del flush, cases


def family_mesh_phase(torch, np, card: str, phase_launches: dict,
                      phase_routes: dict, serve=MESH_FAMILY_SERVE,
                      train=MESH_FAMILY_TRAIN, steps=MESH_FAMILY_STEPS,
                      smoke: bool = False, device: str = "cuda") -> None:
    """Phase 30 (30a, 30b, 30x; 30c is ``family_offset_phase``): the SSM,
    hybrid and encoder-decoder families over a mesh, every position bound
    to ``device``, seed-0 weights drawn there.  30a (``serve``): each
    config's ``generate`` on its mesh (``mesh_generate``: one
    ``flash_attention`` launch per attention call of a prefill and
    position, all ``wgmma``), then teacher-forced on the meshless run's
    tokens and held to it by ``forced_held`` (the prefill's logits within
    ``MESH_TOL``, each decode step's log-softmax gap within
    ``LM_DECODE_GAP``, each plus ``MESH_FAMILY_SPREAD_K`` times the
    meshless run's own spread); prefill ms, decode ms a step, peak memory,
    the collectives, and how many steps the greedy tokens agree.  30x: the
    first config with each position on its own card, bitwise the one-card
    mesh, where the host has the cards (otherwise it prints why not).  30b
    (``train``): each config at full width on its cut depth, the meshless
    ``train_step``s (remat, AdamW with the state handed over), step 1's
    layer-0 gradients on the mesh against the meshless within
    ``MESH_GRAD_REL``, then ``steps`` mesh steps (``mesh_train_steps``: L
    forward + L recompute and L backward attention launches per position),
    each loss within ``MESH_TRAIN_LOSS_TOL`` of the meshless one; step ms,
    tokens/s, peak memory, the collectives of a step.  A CPU dry run:
    ``smoke=True`` (the smoke configs at the same meshes) with small
    ``serve`` and ``train`` tuples and ``device="cpu"``."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.serve_lm import generate, target_len
    from repro_torch.launch.train import (make_batch, mesh_loss_and_grads,
                                          train_step)
    from repro_torch.launch.variants import apply_variant
    from repro_torch.models import get_module
    from repro_torch.models.params import (init_from_defs, layout_pspecs,
                                           shard_params)
    from repro_torch.models.sharding import Distribution
    from repro_torch.train.optimizer import adamw, tree_map

    on_card = device != "cpu"

    def free():
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()

    def draw(cfg):
        gen = torch.Generator(device=device).manual_seed(0)
        return init_from_defs(get_module(cfg).defs(cfg), gen, device)

    def rel(a, b) -> float:
        a, b = a.double(), b.double()
        return float((a - b).norm() / b.norm().clamp_min(1e-30))

    def mesh(shape, devices=None):
        n = math.prod(shape)
        return Distribution(make_debug_mesh(shape, devices=devices
                                            or [device] * n))

    # ---- 30a. serving -------------------------------------------------------
    first = None
    for arch, variant, shape, batch, prompt, new in serve:
        cfg = apply_variant(get_config(arch, smoke=smoke), variant)
        defs = get_module(cfg).defs(cfg)
        params = draw(cfg)
        prompts, frames = serving_inputs(torch, np, cfg, batch, prompt,
                                         device)
        generate(cfg, params, prompts, 2, frames=frames, device=device)
        t0 = time.perf_counter()
        want = generate(cfg, params, prompts, new, frames=frames,
                        device=device)
        meshless_s = time.perf_counter() - t0
        dist = mesh(shape)
        sp = shard_params(params, defs, dist)
        generate(cfg, sp, prompts, 2, frames=frames, dist=dist)  # warm-up
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        phase = f"mesh-{cfg.name}" + ("" if variant == "baseline"
                                      else f"-{variant}")
        got, step, colls = mesh_generate(torch, phase_launches,
                                         phase_routes, phase, cfg, sp,
                                         prompts, new, dist, device, frames)
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        held = forced_held(torch, np, get_module(cfg), cfg, params, sp,
                           prompts, frames, want.tokens, dist)
        agree = int((got.tokens == want.tokens).all(dim=0).int().cumprod(
            0).sum())
        mixer = cfg.mamba_layout if cfg.ssm_state else "no mixer"
        print(f"[mesh-family] {cfg.name} ({mixer}) on a {shape[0]} x "
              f"{shape[1]} (data, "
              f"model) mesh, every position on {device}: {batch} x {prompt}"
              + (f" frames ({prompts.shape[1]}-token prompts)"
                 if frames is not None else " prompts")
              + f", {new} greedy tokens: prefill {got.prefill_s * 1e3:.3f} "
              f"ms (meshless {want.prefill_s * 1e3:.3f}), decode median "
              f"{float(np.median(step)):.3f} ms/step (CUDA events; meshless "
              f"loop {want.decode_s * 1e3 / max(new - 1, 1):.3f} ms/step "
              f"host wall), meshless generation {meshless_s:.3f} s wall; "
              f"flash_attention launches "
              f"{phase_launches[phase]['flash_attention']} by route "
              f"{phase_routes[phase]['flash_attention']}; peak device "
              f"memory {peak / 2**30:.3f} GiB | {card}")
        print(f"[mesh-family] {cfg.name} teacher-forced on the meshless "
              f"run's tokens, against the meshless run: prefill logits max "
              f"|diff| {held['prefill_err']:.4e} (the meshless run on each "
              f"half of the batch: {held['prefill_spread']:.4e}; held to "
              f"{MESH_TOL} + {MESH_FAMILY_SPREAD_K} x that); decode "
              f"log-softmax max gap by step {held['gaps']}, the meshless "
              f"run on each half of the batch {held['spread']} (held to "
              f"{LM_DECODE_GAP} + {MESH_FAMILY_SPREAD_K} x that); the mesh's"
              f" greedy tokens the meshless run's for the first {agree} of "
              f"{new} steps | {card}")
        print(f"[mesh-family] {cfg.name} collectives of the generation (per "
              f"position): {json.dumps(colls)} | {card}")
        if first is None:
            first = (cfg, params, prompts, frames, shape, new, got)
        else:
            del params
        del sp, want, got
        free()
    # ---- 30x. each position on its own card --------------------------------
    cfg, params, prompts, frames, shape, new, got = first
    n = math.prod(shape)
    if on_card and torch.cuda.device_count() >= n:
        dx = mesh(shape, [f"cuda:{i}" for i in range(n)])
        spx = shard_params(params, get_module(cfg).defs(cfg), dx)
        generate(cfg, spx, prompts, 2, frames=frames, dist=dx)  # warm-up
        gx, stepx, _ = mesh_generate(torch, phase_launches, phase_routes,
                                     f"mesh-{cfg.name}-x", cfg, spx, prompts,
                                     new, dx, device, frames)
        if not (torch.equal(gx.tokens, got.tokens)
                and torch.equal(gx.logits, got.logits)):
            raise AssertionError("phase 30x: positions on their own cards "
                                 "are not the one-card mesh's bits")
        print(f"[mesh-family-x] phase 30x: {cfg.name} with each position on "
              f"its own card (cuda:0-{n - 1}): tokens and logits bitwise the "
              f"one-card mesh; prefill {gx.prefill_s * 1e3:.3f} ms, decode "
              f"median {float(np.median(stepx)):.3f} ms/step | {card}")
        del spx, gx
    else:
        have = torch.cuda.device_count() if on_card else 0
        print(f"[mesh-family-x] phase 30x did not run: this host has {have} "
              f"CUDA device(s), and the {shape[0]} x {shape[1]} mesh with "
              f"each position on its own card needs {n} | {card}")
    del first, params, got
    free()

    # ---- 30b. training ------------------------------------------------------
    for arch, variant, shape, batch, seq, layers in train:
        base = get_config(arch, smoke=smoke)
        cut = ({"n_enc_layers": layers, "n_dec_layers": layers,
                "n_layers": 2 * layers} if base.n_enc_layers
               else {"n_layers": layers})
        cfg = apply_variant(dataclasses.replace(base, remat=True, **cut),
                            variant)
        mod = get_module(cfg)
        defs = mod.defs(cfg)
        n = math.prod(shape)
        params = draw(cfg)
        opt = adamw(LM_TRAIN_LR)
        batches = [make_batch(cfg, batch, seq, 0, s, device)
                   for s in range(steps)]
        want, p, st = [], params, opt.init(params)
        for b in batches:
            p, st, loss = train_step(cfg, p, opt, st, b, donate=True)
            want.append(float(loss))
        del p, st
        free()
        leaves = tree_map(lambda t: t.detach().requires_grad_(), params)
        mod.loss_fn(cfg, leaves, batches[0])[0].backward()
        stack = "enc_layers" if cfg.n_enc_layers else "layers"
        g0 = {k: v.grad[0].clone() for k, v in leaves[stack].items()}
        del leaves
        free()
        dist = mesh(shape)
        sp = shard_params(params, defs, dist,
                          layout_pspecs(defs, dist, zero=cfg.zero3))
        del params
        _, grads = mesh_loss_and_grads(cfg, sp, batches[0], dist=dist)
        errs = {k: rel(dist.full(g)[0], g0[k])
                for k, g in grads[stack].items()}
        del grads, g0
        free()
        if max(errs.values()) > MESH_GRAD_REL:
            raise AssertionError(f"{cfg.name} {variant}: step 1's layer-0 "
                                 f"gradients {errs} beyond {MESH_GRAD_REL}")
        state = opt.init(sp, dist, layout_pspecs(defs, dist, zero=True)
                         if cfg.zero1 else None)
        phase = f"mesh-train-{cfg.name}"
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        losses, walls, sp, state, colls = mesh_train_steps(
            torch, np, phase_launches, phase_routes, phase, cfg, sp, opt,
            state, batches, dist, device)
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        worst = held_losses(phase, losses, want)
        ms = np.array(walls[1:] or walls) * 1e3
        tokens = batch * (seq + (target_len(cfg, seq) if cfg.n_enc_layers
                                 else 0))
        print(f"[mesh-family-train] {cfg.name} ({variant}, "
              + (f"{layers} + {layers} of {base.n_enc_layers} + "
                 f"{base.n_dec_layers} layers" if base.n_enc_layers
                 else f"{layers} of {base.n_layers} layers")
              + f", full width) on a {shape[0]} x {shape[1]} mesh, every "
              f"position on {device}: {steps} steps of {batch} x {seq} "
              f"(remat, AdamW lr {LM_TRAIN_LR}, the state handed over): step "
              f"{float(np.median(ms)):.3f} ms host wall (steps "
              f"{[round(w * 1e3, 3) for w in walls]}), "
              f"{tokens / float(np.median(ms)) * 1e3:.0f} tokens/s; peak "
              f"device memory {peak / 2**30:.3f} GiB; losses {losses} "
              f"against the meshless {want} (max |diff| {worst:.4e} within "
              f"{MESH_TRAIN_LOSS_TOL}); step 1's {stack}[0] gradients, "
              f"|mesh - meshless| / |meshless| per leaf (within "
              f"{MESH_GRAD_REL}): max {max(errs.values()):.3e} at "
              f"{max(errs, key=errs.get)}; attention "
              f"{phase_routes[phase]['flash_attention']} forward + "
              f"recompute, {phase_routes[phase]['flash_attention_bwd']} "
              f"backward | {card}")
        print(f"[mesh-family-train] {cfg.name} collectives of one step: "
              f"{json.dumps(colls)} | {card}")
        del sp, state, batches
        free()


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
    t_start = time.perf_counter()

    def clock(phase: str) -> None:
        """Where the run's time goes: each phase's start on the host clock
        (the phases' order, not their numbers, is the run's order), and the
        device memory the process holds then."""
        print(f"[time] phase {phase} starts {time.perf_counter() - t_start:.1f}"
              f" s into the run; {torch.cuda.memory_allocated() / 2**30:.3f} "
              f"GiB allocated")

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

    clock("3")
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

    clock("4")
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
    # the serving micro-batch's chain: MAX_BATCH seeds (the 200 requests'
    # micro-batches hold 1-256)
    serve_seeds = np.random.default_rng(10).integers(0, g.n, MAX_BATCH)
    chains = {"position": ctx["shard"]["sample"],
              "train": chain_context(torch, np, cache, train_seeds,
                                     GRAPHSAGE.fanouts, seed=9),
              "serve": chain_context(torch, np, cache, serve_seeds,
                                     GRAPHSAGE.fanouts, seed=11)}
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

    clock("4b")
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

    clock("5")
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

    clock("6")
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
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
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

    clock("7")
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

    clock("8")
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

    clock("9")
    # ---- 9. the sharded clique executor on the 2 x 2 hierarchy ---------------
    n_pos = sum(len(c) for c in cliques)
    shard_kw = dict(backend="sharded", device="cuda", seed=0, params=params,
                    refresh_config=RefreshConfig(interval=SHARD_REFRESH,
                                                 drift_threshold=1.0))
    rplan = fresh_copy(splan)
    sc = TrafficCounter.for_plan(rplan)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    zero_launches(KERNELS)
    t0 = time.perf_counter()
    res = train_gnn(g, rplan, GRAPHSAGE, steps=SHARD_STEPS, counter=sc,
                    **shard_kw)
    wall = time.perf_counter() - t0
    phase_launches["shard"] = read_launches(KERNELS)
    phase_routes["shard"] = read_routes(KERNELS)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - held
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
    print(f"[shard] binding: {shard_binding(rplan.caches)} | {card}")
    print(f"[shard] device memory at the run's peak {peak / 2**30:.3f} GiB "
          f"above the {held / 2**30:.3f} GiB held before it; "
          f"{epoch_change_steps(np, res)} | {card}")
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
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
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

    clock("10")
    # ---- 10. sharded parity against the device backend ----------------------
    groups, builders = sharded_specs(np, g, splan, cfg_p, seed=8)
    shards, parts, _ = upload_packed(torch, np, splan, groups, g.feat_dim)
    for ci, clique in enumerate(cliques):
        for gi, d in enumerate(clique):
            got = sharded_position_batch(shards[ci], parts[ci, gi],
                                         g.feat_dim)
            want = builders[d].finalize(groups[ci][gi])
            if set(got) != set(want) or not all(
                    torch.equal(got[k], want[k]) for k in want):
                raise AssertionError(f"position ({ci}, {gi}) batch != the "
                                     "device backend's finalize")
    del shards, parts, builders, groups
    sp_kw = dict(device="cuda", seed=0, params=params,
                 refresh_config=RefreshConfig(interval=4,
                                              drift_threshold=1.0))
    dc = TrafficCounter.for_plan(splan)
    dev_run = train_gnn(g, fresh_copy(splan), cfg_p, steps=SHARD_PARITY_STEPS,
                        backend="device", counter=dc, **sp_kw)
    zero_launches(KERNELS)
    runs, runs_plans = [], []
    for _ in range(2):
        c = TrafficCounter.for_plan(splan)
        runs_plans.append(fresh_copy(splan))
        runs.append((train_gnn(g, runs_plans[-1], cfg_p,
                               steps=SHARD_PARITY_STEPS, backend="sharded",
                               counter=c, **sp_kw), c))
    phase_launches["shard-parity"] = read_launches(KERNELS)
    phase_routes["shard-parity"] = read_routes(KERNELS)
    (s1, c1), (s2, _) = runs
    print(f"[shard-parity] binding: {shard_binding(runs_plans[-1].caches)}; "
          f"{epoch_change_steps(np, s1)} | {card}")
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
    del runs_plans

    clock("10x")
    # ---- 10x. phase 10's sharded run with positions on distinct cards -----
    cross_card_phase(torch, np, g, splan, cfg_p, sp_kw, s1, card,
                     phase_launches, phase_routes)

    clock("10b, 10c, 10d")
    # ---- 10b, 10c and 10d. the tiered store, telemetry, resilience --------
    tmp = tempfile.mkdtemp(prefix="chip_smoke_store_")
    try:
        fpath = store_phases(torch, np, g, plan, params, card, phase_launches,
                             phase_routes, tmp)
        resilience_phases(torch, np, g, plan, splan, params, fpath, card,
                          phase_launches, phase_routes, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    clock("16, 17")
    # ---- 16 and 17. compressed data parallelism, the stepwise sampler -----
    # (numbered after the LM phases, run here while the graph is built)
    compressed_phase(torch, np, g, plan, params, card, phase_launches,
                     phase_routes)
    stepwise_phase(torch, np, g, plan, params, card, phase_launches,
                   phase_routes)
    # the one-GPU plan's cache (its device arrays) goes with the plans
    del plan, splan, g, cache, table
    gc.collect()
    torch.cuda.empty_cache()

    # phase 29's accounting on the meta device, in a subprocess beside the
    # LM phases (stopped at exit if the run fails first)
    acct_dir = tempfile.mkdtemp(prefix="chip_smoke_mesh_train_")
    mesh_acct = start_mesh_train_accounting(acct_dir)

    def stop_accounting():
        if mesh_acct[0].poll() is None:
            mesh_acct[0].kill()
            mesh_acct[0].wait()
        shutil.rmtree(acct_dir, ignore_errors=True)

    atexit.register(stop_accounting)

    clock("11")
    # ---- 11. LM: gemma3-1b at full width, its attention kernel -------------
    lm = get_config(LM_ARCH)
    V = lm.vocab_size
    t0 = time.perf_counter()
    lm_params = init_from_defs(transformer.defs(lm),
                               torch.Generator(device="cuda").manual_seed(0),
                               "cuda")
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
    time_old_routes(torch, np, fam, measured[fa.name], flush, card)
    layer_attention_lse(torch, fam, card)
    route_rule_agrees(torch, fa)
    flash_refuses_autograd(torch, fa, card)
    prefill_routes = {c: r for c, r in measured[fa.name]["routes"].items()
                      if c.startswith("prefill_")}
    if len(prefill_routes) != 2 or any(r != ["wgmma"]
                                       for r in prefill_routes.values()):
        raise AssertionError(f"prefill cases' routes {prefill_routes}, "
                             f"expected wgmma")
    del captured

    clock("11b")
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
    fam_routes = {c: r[0] for c, r in measured[bwd.name]["routes"].items()
                  if c.startswith("fam_")}
    if len(fam_routes) != len(BWD_FAMILY_SHAPES) \
            or set(fam_routes.values()) != {"wgmma"}:
        raise AssertionError(f"the families' training shapes' backward "
                             f"routes {fam_routes}, expected wgmma")
    measured[bwd.name]["timed"] = time_backward(torch, np, fam, bwd, bcases,
                                                flush, card)
    measured[bwd.name]["timed"] |= time_family_backward(torch, np, fam,
                                                        bcases, flush, card)
    del bcases, flush

    clock("12")
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
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        pre = generate(lm, lm_params, prompts, 1, device="cuda")
    rows = kineto_rows(torch, prof, ())[0]
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
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
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

    clock("13")
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
        torch.from_numpy(sprompts).cuda(), on_cpu.tokens.cuda())[0].float().cpu()
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

    clock("14")
    # ---- 14. LM train: gemma3-1b, 4 x 4096, remat, CE in chunks of 512 ----
    zero_launches(KERNELS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    marks = []
    losses, walls, _ = lm_train(torch, np, fam, tcfg, lm_params, LM_BATCH,
                                LM_PROMPT, LM_TRAIN_STEPS, "cuda",
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
    profiled = profile_train_step(torch, np, fam, tcfg, lm_params, LM_BATCH,
                                  LM_PROMPT)
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
    # gemma3-1b's weights go: no later phase reads them
    del profiled, lm_params, leaves
    gc.collect()
    torch.cuda.empty_cache()

    clock("15")
    # ---- 15. LM train parity: the smoke config on the card and the CPU ----
    zero_launches(KERNELS)
    B, S, N = LM_TRAIN_SMOKE
    sp = init_from_defs(transformer.defs(small),
                        torch.Generator().manual_seed(0), "cpu")
    cpu_losses, _, _ = lm_train(torch, np, fam, small, sp, B, S, N, "cpu")
    card_losses, _, _ = lm_train(
        torch, np, fam, small,
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

    clock("18")
    # ---- 18. MoE serving: phi3.5-moe at full width, 8 of 32 layers ---------
    torch.cuda.empty_cache()
    moe_serve_phase(torch, np, card, phase_launches, phase_routes)
    torch.cuda.empty_cache()
    moe_parity_phase(torch, np, card, phase_launches, phase_routes)

    clock("19")
    # ---- 19. SSM and hybrid serving: mamba2-780m, zamba2-1.2b -------------
    for arch in SSM_ARCHS:
        torch.cuda.empty_cache()
        family_serve_phase(torch, np, card, phase_launches, phase_routes,
                           arch)
    clock("20")
    # ---- 20. encoder-decoder serving: seamless-m4t-large-v2 ---------------
    torch.cuda.empty_cache()
    family_serve_phase(torch, np, card, phase_launches, phase_routes,
                       ENCDEC_ARCH)
    clock("21")
    # ---- 21. chameleon-34b, 8 of 48 layers ---------------------------------
    torch.cuda.empty_cache()
    family_serve_phase(torch, np, card, phase_launches, phase_routes,
                       VLM_ARCH, n_layers=VLM_LAYERS)
    clock("19-21 parity")
    torch.cuda.empty_cache()
    family_parity_phase(torch, np, card, phase_launches, phase_routes)

    clock("22")
    # ---- 22. family training at full size: mamba2, zamba2, seamless -------
    for arch in FAMILY_TRAIN_FULL:
        torch.cuda.empty_cache()
        family_train_phase(torch, np, card, phase_launches, phase_routes, arch)
    clock("23")
    # ---- 23. MoE and VLM training at full width on 2 layers ----------------
    for arch, layers in FAMILY_TRAIN_CUT:
        torch.cuda.empty_cache()
        family_train_phase(torch, np, card, phase_launches, phase_routes,
                           arch, n_layers=layers, loss_chunk=LM_TRAIN_CHUNK)
    clock("24")
    # ---- 24. training parity: the smoke configs on the card and the CPU ---
    torch.cuda.empty_cache()
    family_train_parity_phase(torch, np, card, phase_launches, phase_routes)
    train_cli_phase(card)
    clock("25")
    # ---- 25. the dry-run held to the card: gemma3-1b, dbrx-132b -----------
    measured["flash_attention"]["timed"] |= dryrun_phase(
        torch, card, phase_launches, phase_routes)
    # ---- 26. dense configs at full width: stablelm, minitron, qwen2.5 -----
    for arch in DENSE_ARCHS:
        clock(f"26 {arch}")
        torch.cuda.empty_cache()
        dense_phase(torch, np, card, phase_launches, phase_routes, arch,
                    measured[bwd.name])
    clock("27")
    # ---- 27. the narrow stablelm (Dh 80): card against CPU ---------------
    torch.cuda.empty_cache()
    narrow_stablelm_phase(torch, np, card, phase_launches, phase_routes)
    clock("28")
    # ---- 28. LM serving over a mesh (28x across cards, where present) -----
    gc.collect()
    torch.cuda.empty_cache()
    mesh_phase(torch, np, card, phase_launches, phase_routes, measured)
    clock("29")
    # ---- 29. LM training over a mesh; 29c the offset backward -------------
    gc.collect()
    torch.cuda.empty_cache()
    offset_backward_phase(torch, np, card, measured)
    mesh_train_phase(torch, np, card, phase_launches, phase_routes,
                     finish_mesh_train_accounting(mesh_acct))
    stop_accounting()
    clock("30")
    # ---- 30. the SSM, hybrid and encoder-decoder families over a mesh ----
    gc.collect()
    torch.cuda.empty_cache()
    family_offset_phase(torch, np, card, measured)
    family_mesh_phase(torch, np, card, phase_launches, phase_routes)

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
    clock("record")
    print(card)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-train-accounting"]:
        sys.exit(mesh_train_accounting(sys.argv[2]))
    sys.exit(main())
