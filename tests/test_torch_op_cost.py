"""The op-level cost and memory counter (``repro_torch.launch.op_cost``) and
the dry-run's one-card pieces that need no reference.

CPU: the reference's ``tests/test_hlo_cost.py`` cases counted exactly (its
scan, ``2 * 4 * N * N * L``; its gradient, 3 times that); the peak
accounting on chains of known live sets; ``meta`` and CPU counts equal for
every smoke cell; counts that grow by exactly one layer's count per layer
(the port's layer loops are Python loops, so no ``runtime_flags`` switch is
needed for exact counts); the variants' counts; the attention's work and
scratch formulas; the CLI; full-size accounting on ``meta``.

GPU (``gpu``-marked, skipped without a card): meta, CPU and card counts
equal at one shape, and the backward's scratch rule equal to the library's.
This file imports no JAX.
"""
import dataclasses
import json
import math
import os
import resource
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import dryrun, op_cost, specs, variants
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import transformer

ROOT = Path(__file__).resolve().parents[1]
N, L = 256, 6  # tests/test_hlo_cost.py's case
SMALL = 32, 2  # seq, batch of the smoke cells
KINDS = ("train", "prefill", "decode")


def _scan(x, w):
    for i in range(w.shape[0]):
        x = x @ w[i]
    return x


@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_scan_case_counts_exactly(device):
    """The reference's scan over L layers of (4, N) @ (N, N): exactly
    2 * 4 * N * N * L matrix-product flops (the reference's HLO count is
    held within 5%), nothing elementwise."""
    w = torch.zeros((L, N, N), device=device)
    x = torch.zeros((4, N), device=device)
    with op_cost.OpCounter(device) as c:
        _scan(x, w)
    assert c.matmul == {"f32": 2 * 4 * N * N * L}
    assert c.elementwise == 0
    assert c.ops == {"mm": L}


@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_gradient_case_counts_exactly_three_times(device):
    """The gradient of ``sum(scan(x, w) ** 2)``: exactly 3 times the
    forward's matrix-product flops when x and w both take gradients (the
    reference's scan transposes every layer, its HLO count within 10%).
    With w alone, autograd skips the first layer's input gradient: exactly
    3 L - 1 products."""
    fwd = 2 * 4 * N * N * L
    for wrt_x, want in ((True, 3 * fwd), (False, (3 * L - 1) * fwd // L)):
        w = torch.zeros((L, N, N), device=device, requires_grad=True)
        x = torch.zeros((4, N), device=device, requires_grad=wrt_x)
        with op_cost.OpCounter(device) as c:
            loss = (_scan(x, w) ** 2).sum()
            torch.autograd.grad(loss, (x, w) if wrt_x else (w,))
        assert c.matmul == {"f32": want}


def test_peak_follows_a_chain_of_known_live_sets():
    """Live bytes rise by each new storage and fall when it dies; views,
    in-place ops and ``out=`` write no new storage; the arguments count
    from the start."""
    n = 1000  # f32: 4000 bytes a tensor
    a = torch.empty(n, device="meta")
    with op_cost.OpCounter("meta") as c:
        assert c.track(a) == 4 * n and c.peak == 4 * n
        b = a * 2
        assert c.live == 8 * n
        v = b.view(10, 100).t()  # a view: no storage
        b.add_(1)                # in place
        torch.mul(a, 3, out=b)   # out=
        assert c.live == 8 * n
        d = v.exp()              # 12 n: the peak
        del b, v
        assert c.live == 8 * n
        e = d.sum()              # 4 bytes
        del d
    assert (c.live, c.peak) == (4 * n + 4, 12 * n)
    assert e.shape == ()


def test_account_splits_peak_into_the_references_terms():
    """``account``: argument, output and alias bytes (an output that is an
    argument updated in place) and temp = peak - argument - output +
    alias.  The peak: both arguments, ``x * x`` and the sum before the
    product dies."""
    n = 1000

    def step(state, x):
        state.add_(x)
        return state, (x * x).sum()

    cell = specs.Cell("chain", step, (torch.empty(n, device="meta"),
                                      torch.empty(n, device="meta")),
                      None, {"kind": "decode"})
    _, mem, _ = dryrun.account(cell)
    assert mem == {"argument_bytes": 8 * n, "output_bytes": 4 * n + 4,
                   "temp_bytes": 4 * n, "alias_bytes": 4 * n,
                   "peak_bytes": 12 * n + 4}


def _cell_counts(arch, kind, device, **over):
    cfg = dataclasses.replace(get_config(arch, smoke=True), **over)
    seq, batch = SMALL
    cell = specs.build_cell(cfg, ShapeConfig(kind, seq, batch, kind),
                            device=device)
    summary, mem, _ = dryrun.account(cell, device)
    return summary, mem


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_meta_and_cpu_counts_are_equal(arch):
    """Every smoke cell counts the same flops (by dtype), bytes, ops and
    hand-kernel work on ``meta`` as on the CPU, where the plain versions
    run (the kernel's formula stands for them).  The CPU peak is not held:
    it holds the plain versions' temporaries."""
    for kind in KINDS:
        m, _ = _cell_counts(arch, kind, "meta")
        c, _ = _cell_counts(arch, kind, "cpu")
        m.pop("peak_bytes"), c.pop("peak_bytes")
        assert m == c, kind


@pytest.mark.parametrize("arch,kind", [("gemma3-1b", "prefill"),
                                       ("gemma3-1b", "decode"),
                                       ("dbrx-132b", "prefill"),
                                       ("mamba2-780m", "prefill"),
                                       ("mamba2-780m", "decode")])
def test_counts_grow_by_one_layers_count_per_layer(arch, kind):
    """No layer loop is a ``lax.scan`` in the port, so every layer is
    counted: from 1 to 4 layers the bytes, the reference's HLO flops (every
    key block, whatever the window) and the flops besides the attention
    kernel's grow by the same step each layer, and the kernel's flops by
    its layer's visible (query, key) pairs: gemma3's third layer is global
    and sees more of them than its local ones."""
    cfg = get_config(arch, smoke=True)
    counts = [_cell_counts(arch, kind, "meta", n_layers=n)[0]
              for n in (1, 2, 3, 4)]

    def attention(c):
        return c["kernels"].get("flash_attention", {"flops": 0})["flops"]

    for key, of in (("bytes", lambda c: c["bytes"]),
                    ("hlo", lambda c: sum(c["hlo_matmul_flops"].values())),
                    ("rest", lambda c: c["flops"] - attention(c))):
        steps = {of(b) - of(a) for a, b in zip(counts, counts[1:])}
        assert len(steps) == 1 and steps.pop() > 0, key
    seq, batch = SMALL
    windows = (transformer.layer_flags(dataclasses.replace(cfg, n_layers=4))
               [0] if cfg.family != "ssm" else [])
    want = [4 * cfg.resolved_head_dim * batch * cfg.n_heads
            * fa.causal_pairs(seq, w) if kind == "prefill" else 0
            for w in windows[1:]]
    got = [attention(b) - attention(a) for a, b in zip(counts, counts[1:])]
    assert got == (want or [0, 0, 0])
    if arch == "gemma3-1b" and kind == "prefill":
        assert got[1] > got[0] == got[2]


@pytest.mark.parametrize("arch", ["gemma3-1b", "mamba2-780m"])
def test_training_counts_grow_by_a_layer_and_the_stacked_gradients(arch):
    """A training step's flops grow by one layer's count per layer plus
    what autograd spends on the stacked parameters: each layer's gradient
    of a stacked (L, ...) leaf is a zero-filled (L, ...) tensor, and the L
    of them are summed, (L - 1) * L * P adds over the P parameters of one
    layer.  So the flops' second difference in L, the attention kernels'
    aside (a global layer sees more pairs than a local one), is exactly
    2 P."""
    P = sum(math.prod(t.shape[1:]) for t in torch.utils._pytree.tree_leaves(
        specs.build_cell(get_config(arch, smoke=True), ShapeConfig(
            "train", 8, 1, "train")).args[0]["params"]["layers"]))
    counts = [_cell_counts(arch, "train", "meta", n_layers=n)[0]
              for n in (1, 2, 3, 4)]
    flops = [c["flops"] - sum(k["flops"] for k in c["kernels"].values())
             for c in counts]
    steps = [b - a for a, b in zip(flops, flops[1:])]
    assert {b - a for a, b in zip(steps, steps[1:])} == {2 * P}


MESH_ONLY = ("sp_attn", "sharded_embed", "sp_attn+sharded_embed",
             "seq_sp_mixer", "zero1", "sp_attn+zero1")


@pytest.mark.parametrize("arch", ["gemma3-1b", "mamba2-780m"])
def test_mesh_only_variants_count_as_the_baseline(arch):
    """Without a mesh the layout variants change fields nothing reads: the
    same counts as the baseline."""
    base = _cell_counts(arch, "train", "meta")
    for name in MESH_ONLY:
        assert _cell_counts(arch, "train", "meta",
                            **variants.VARIANTS[name]) == base, name


def test_chunked_loss_and_no_remat_change_what_they_should():
    """``chunked_loss``: each 512-token chunk's CE is checkpointed, so the
    backward computes the unembedding once more (2 * B * S * D * V flops)
    and the (B, S, V) f32 logits never exist at once (a lower peak).
    ``no_remat`` on a remat config: the layers' forward is not recomputed,
    so the matrix-product flops drop by exactly the layers' forward's but
    each layer's down projection, which the recompute never reaches
    (``torch.utils.checkpoint`` stops once the last tensor the backward
    needs is rebuilt), and the elementwise ones by the rest."""
    cfg = get_config("gemma3-1b", smoke=True)
    B, S = 1, 2048
    shape = ShapeConfig("train", S, B, "train")

    def counts(c):
        return dryrun.account(specs.build_cell(c, shape))[:2]

    (base, bmem), (chunk, cmem) = counts(cfg), counts(
        variants.apply_variant(cfg, "chunked_loss"))
    assert sum(chunk["matmul_flops"].values()) - sum(
        base["matmul_flops"].values()) == 2 * B * S * cfg.d_model \
        * cfg.padded_vocab
    assert cmem["peak_bytes"] < bmem["peak_bytes"]

    remat = dataclasses.replace(cfg, remat=True)
    (r, _), (nr, _) = counts(remat), counts(
        variants.apply_variant(remat, "no_remat"))
    params = specs.build_cell(cfg, shape).args[0]["params"]
    with op_cost.OpCounter("meta") as c, torch.no_grad():
        transformer.forward_hidden(cfg, params, torch.empty(
            (B, S), dtype=torch.int64, device="meta"))
    down = 2 * B * S * cfg.d_ff * cfg.d_model * cfg.n_layers
    assert sum(r["matmul_flops"].values()) - sum(
        nr["matmul_flops"].values()) == sum(c.matmul.values()) - down
    assert r["elementwise_flops"] > nr["elementwise_flops"]


def test_one_hot_counts_alike_on_every_device():
    """``one_hot`` decomposes differently on the CPU (host checks), on
    ``meta`` and on CUDA: the counter counts it once, as one op."""
    got = []
    for device in ("meta", "cpu"):
        idx = torch.zeros((5, 3), dtype=torch.int64, device=device)
        with op_cost.OpCounter(device) as c:
            torch.nn.functional.one_hot(idx, 7)
        got.append((dict(c.ops), c.bytes, c.elementwise))
    assert got[0] == got[1] == ({"one_hot": 1}, 15 * 8 + 105 * 8, 105)


def test_roofline_reads_the_kernels_work_not_the_scans_count():
    """A causal prefill's attention flops are its visible pairs (half the
    square, and a window's band in a local layer), fewer than the
    reference's HLO count of every key block; the roofline's compute term
    and useful-flops ratio read the former."""
    cfg = get_config("gemma3-1b", smoke=True)
    seq, batch = SMALL
    c, _ = _cell_counts("gemma3-1b", "prefill", "meta")
    k = c["kernels"]["flash_attention"]
    windows = transformer.layer_flags(cfg)[0]
    assert k["calls"] == cfg.n_layers
    assert k["flops"] == sum(4 * cfg.resolved_head_dim * batch * cfg.n_heads
                             * fa.causal_pairs(seq, w) for w in windows)
    assert k["hlo_flops"] == cfg.n_layers * 4 * cfg.resolved_head_dim \
        * batch * cfg.n_heads * seq * seq > k["flops"]
    assert sum(c["hlo_matmul_flops"].values()) \
        - sum(c["matmul_flops"].values()) == k["hlo_flops"] - k["flops"]
    mf = dryrun.model_flops_estimate(cfg, ShapeConfig("p", seq, batch,
                                                      "prefill"))
    r = dryrun.roofline(c, mf)
    assert math.isclose(r["compute_s"], sum(
        f / dryrun.PEAK_FLOPS.get(dt, dryrun.F32_FLOPS_PER_S)
        for dt, f in c["matmul_flops"].items())
        + c["elementwise_flops"] / dryrun.F32_FLOPS_PER_S)
    assert r["useful_flops_ratio"] == mf["model_flops"] / c["flops"]


def test_no_counter_builds_no_cost(monkeypatch):
    """With no counter in force the attention wrappers never build a cost;
    a counter of another device does not count them either."""
    def refuse(*a, **k):
        raise AssertionError("cost built with no counter in force")

    monkeypatch.setattr(fa, "flash_cost", refuse)
    q = torch.zeros((1, 8, 2, 16))
    o = fa.flash_attention(q, q[:, :, :1], q[:, :, :1])
    with op_cost.OpCounter("meta") as c:
        fa.flash_attention(q, q[:, :, :1], q[:, :, :1])
    assert o.shape == q.shape and not c.kernels


@pytest.mark.parametrize("S,window", [(1, 0), (10, 3), (77, 512), (4096, 512),
                                      (600, 1 << 30), (9, 9), (9, 8)])
def test_causal_pairs_closed_form(S, window):
    w = window if 0 < window < S else S
    assert fa.causal_pairs(S, window) == sum(min(i + 1, w) for i in range(S))


def test_attention_work_formulas():
    """``flash_work``: the bound's bytes and visible-pair flops;
    ``scan_flops``: the reference's scan over every padded key block."""
    q = torch.empty((2, 100, 8, 64), dtype=torch.bfloat16, device="meta")
    k = torch.empty((2, 100, 2, 64), dtype=torch.bfloat16, device="meta")
    pairs = fa.causal_pairs(100, 10)
    assert fa.flash_work(q, k, 10) == ((2 * q.numel() + 2 * k.numel()) * 2,
                                       4 * 64 * 2 * 8 * pairs)
    assert fa.flash_work(q, k, 10, lse=True)[0] == \
        (2 * q.numel() + 2 * k.numel()) * 2 + 4 * 2 * 8 * 100
    assert fa.flash_work(q, k, 0, False, backward=True) == (
        4 * (q.numel() + k.numel()) * 2 + 4 * 2 * 8 * 100,
        10 * 64 * 2 * 8 * 100 * 100)
    assert fa.scan_flops(q, k) == 4 * 2 * 8 * 100 * 100 * 64
    assert fa.scan_flops(q, k, block_kv=64) == 4 * 2 * 8 * 100 * 128 * 64


@pytest.mark.parametrize("route,shape,scale,want", [
    # the worked cases of tests/test_torch_lm_kernels.py's card test of the
    # library's rule: D for every (b, h, i) on mma_sync; on wgmma lse2 and D
    # for each packed row, and bf16(q * scale) where the scale is not a
    # power of two
    ("mma_sync", (2, 77, 4, 1, 80), 80 ** -0.5, 4 * 2 * 4 * 77),
    ("wgmma", (2, 77, 4, 1, 256), 0.0625, 8 * 2 * 5 * 64),
    ("wgmma", (1, 77, 6, 2, 128), 0.08837890625,
     8 * 2 * 4 * 64 + 2 * 77 * 6 * 128),
    ("wgmma", (1, 3, 80, 1, 64), 0.125, 8 * 2 * 3 * 64),
    ("wgmma", (2, 77, 4, 2, 80), 0.11181640625,
     8 * 2 * 2 * 3 * 64 + 2 * 2 * 77 * 4 * 80),
])
def test_scratch_rule_gives_the_c_rules_worked_cases(route, shape, scale,
                                                     want):
    B, Sq, Hq, Hkv, Dh = shape
    assert fa.scratch_rule(route, B, Sq, Hq, Hkv, Dh, scale) == want


def test_meta_backward_allocates_the_cards_scratch():
    """On ``meta`` the backward returns the card's (empty) gradients and
    allocates the scratch the card's launch would."""
    q = torch.empty((1, 77, 6, 128), dtype=torch.bfloat16, device="meta")
    k = torch.empty((1, 77, 2, 128), dtype=torch.bfloat16, device="meta")
    lse = torch.empty((1, 6, 77), device="meta")
    with op_cost.OpCounter("meta") as c:
        c.track((q, k, lse))
        base = c.live
        dq, dk, dv = fa.flash_attention_bwd(q, k, k, q, lse, q)
    scratch = fa.scratch_rule("wgmma", 1, 77, 6, 2, 128, 0.08837890625)
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, k.shape)
    assert c.peak - base == 2 * (q.numel() + 2 * k.numel()) + scratch
    assert c.kernels["flash_attention_bwd"]["calls"] == 1
    with pytest.raises(RuntimeError):
        fa.flash_attention_bwd(*(t.float() if t is not lse else t
                                 for t in (q, k, k, q, lse, q)))


def test_full_size_accounting_allocates_no_parameters():
    """gemma3-1b ``train_4k`` and dbrx-132b ``prefill_32k`` at full size on
    ``meta``: every argument a meta tensor, the records' argument bytes the
    parameters' (and state's) full size, and the process's resident memory
    grows by far less than one layer of either."""
    rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    for arch, shape, min_arg in (("gemma3-1b", "train_4k", 12e9),
                                 ("dbrx-132b", "prefill_32k", 5e11)):
        cfg = get_config(arch)
        cell = specs.build_cell(cfg, SHAPES[shape])
        assert all(t.device.type == "meta"
                   for t in torch.utils._pytree.tree_leaves(cell.args)
                   if isinstance(t, torch.Tensor))
        rec = dryrun.run_cell(arch, shape)
        assert rec["status"] == "ok" and not rec["fits"]
        assert rec["memory"]["argument_bytes"] > min_arg
    grown_kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss - rss0
    assert grown_kb < 2 * 2 ** 20  # under 2 GiB; one dbrx layer is 13 GB


REFERENCE_KEYS = {"arch", "shape", "mesh", "variant", "status", "n_chips",
                  "lower_s", "compile_s", "flops_per_device",
                  "bytes_per_device", "xla_cost_analysis", "memory",
                  "collectives", "roofline", "model_flops_detail"}


def test_cli_writes_a_record_with_the_references_keys(tmp_path):
    """``python -m repro_torch.launch.dryrun --arch --shape --out``: the
    reference's record keys (``src/repro/launch/dryrun.py:190-204``) and
    their memory and roofline keys, plus ``device_bytes`` and ``fits``."""
    out = tmp_path / "rec.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                        "--arch", "mamba2-780m", "--shape", "decode_32k",
                        "--out", str(out)], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert json.loads(r.stdout.strip().splitlines()[-1])["status"] == "ok"
    rec = json.loads(out.read_text())
    assert REFERENCE_KEYS | {"device_bytes", "fits"} <= set(rec)
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes",
                                  "temp_bytes", "alias_bytes", "peak_bytes"}
    assert set(rec["roofline"]) == {"compute_s", "memory_s", "collective_s",
                                    "dominant", "model_flops",
                                    "useful_flops_ratio"}
    assert rec["collectives"]["wire_bytes"] == 0.0
    assert rec["device_bytes"] == dryrun.H100_BYTES and rec["fits"]
    assert math.isclose(rec["roofline"]["memory_s"],
                        rec["bytes_per_device"] / dryrun.HBM_BYTES_PER_S)


def test_variant_records_have_their_own_file(tmp_path, monkeypatch):
    """A variant's record is named after it, so a variant run never
    overwrites the baseline's, on either mesh (``--mesh both`` writes the
    single and the multi record of a cell)."""
    assert dryrun.record_path("a", "s", "single", "baseline").name == \
        "a__s__single.json"
    assert dryrun.record_path("a", "s", "single", "no_remat").name == \
        "a__s__single__no_remat.json"
    monkeypatch.setattr(dryrun, "RESULTS_DIR", tmp_path)
    for variant in ("baseline", "chunked_loss"):
        dryrun.main(["--arch", "mamba2-780m", "--shape", "decode_32k",
                     "--variant", variant])
    recs = {p.name: json.loads(p.read_text()) for p in tmp_path.iterdir()}
    assert {n: r["variant"] for n, r in recs.items()} == {
        "mamba2-780m__decode_32k__single.json": "baseline",
        "mamba2-780m__decode_32k__single__chunked_loss.json": "chunked_loss"}
    for p in tmp_path.iterdir():
        p.unlink()
    dryrun.main(["--arch", "mamba2-780m", "--shape", "decode_32k",
                 "--variant", "chunked_loss", "--mesh", "both"])
    recs = {p.name: json.loads(p.read_text()) for p in tmp_path.iterdir()}
    assert {n: (r["variant"], r["status"]) for n, r in recs.items()} == {
        "mamba2-780m__decode_32k__single__chunked_loss.json":
            ("chunked_loss", "ok"),
        "mamba2-780m__decode_32k__multi__chunked_loss.json":
            ("chunked_loss", "ok")}


def test_cli_refuses_a_mesh(tmp_path):
    """What the CLI and ``build_cell`` refuse about a mesh: a mesh kind
    other than single, multi or both (the CLI exits non-zero), a device
    for a mesh cell (accounted on meta only), and any mesh that is not an
    ``LMMesh``.  A cell of the SSM family on ``--mesh multi`` now runs: the
    CLI exits 0 with an ``ok`` record (every family runs on a mesh:
    ``tests/test_torch_lm_mesh_families.py``)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
           "mamba2-780m", "--shape", "decode_32k", "--out",
           str(tmp_path / "r.json")]
    r = subprocess.run(cmd + ["--mesh", "pods"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and "invalid choice" in r.stderr
    r = subprocess.run(cmd + ["--mesh", "multi"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert json.loads((tmp_path / "r.json").read_text())["status"] == "ok"
    with pytest.raises(ValueError, match="meta only"):
        dryrun.run_cell("mamba2-780m", "decode_32k", "multi", device="cpu")
    mesh = make_debug_mesh(devices="meta")
    cell = specs.build_cell(get_config("mamba2-780m", smoke=True),
                            ShapeConfig("t", 32, 2, "train"), mesh=mesh)
    assert cell.meta["kind"] == "train"
    with pytest.raises(TypeError, match="LMMesh"):
        specs.build_cell(get_config("gemma3-1b", smoke=True),
                         ShapeConfig("p", 8, 1, "prefill"), mesh=object())


# ------------------------------------------------------------------ GPU ----

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU host)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["gemma3-1b", "phi3.5-moe-42b-a6.6b",
                                  "mamba2-780m", "seamless-m4t-large-v2"])
def test_meta_cpu_and_card_counts_are_equal(cuda_device, arch):
    """The same smoke cell counts alike on ``meta``, the CPU and the card
    (the hand kernels launched there, their formula counted)."""
    for kind in KINDS:
        got = [_cell_counts(arch, kind, d)[0] for d in
               ("meta", "cpu", cuda_device)]
        for g in got:
            g.pop("peak_bytes")
        assert got[0] == got[1] == got[2], kind


@pytest.mark.gpu
def test_scratch_rule_equals_the_librarys(cuda_device):
    for route in fa.BWD_ROUTES:
        for B, Sq, Hq, Hkv, Dh in ((2, 77, 4, 1, 256), (1, 77, 6, 2, 128),
                                   (4, 4096, 48, 8, 128), (1, 3, 80, 1, 64),
                                   (4, 4096, 4, 1, 256), (2, 77, 4, 2, 80),
                                   (4, 4096, 32, 32, 80)):
            scale = float(torch.tensor(Dh ** -0.5, dtype=torch.bfloat16))
            assert fa.scratch_rule(route, B, Sq, Hq, Hkv, Dh, scale) == \
                fa.bwd_scratch_bytes(route, B, Sq, Hq, Hkv, Dh, scale)
