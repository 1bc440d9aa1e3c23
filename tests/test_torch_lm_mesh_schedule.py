"""The collective schedule of the LM zoo on a (data, model) mesh, as the
reference's layout gives it: decode on the weights' own shards
(column-parallel into "heads", "ff" and the Mamba inner dim, row-parallel
out of "heads" and "ff"; the Mamba mixer's w_out gathered whole),
prefill's weight gathers in the dtype the weights are read in, training's
in f32, and ``seq_sp``'s halo and carry as position-order shifts.  On
meshes bound to ``["cpu"] * 4``.

The reference runs once, in one subprocess
(``XLA_FLAGS=--xla_force_host_platform_device_count=8``, a 1 x 4
``jax.make_mesh``, jitted under ``jax.set_mesh``): ``prefill`` and 2
teacher-forced ``decode_step``s of the gemma3 and mamba2 smoke configs
from its own weights, which the tests that need it share through a
module-scoped fixture.
"""
import dataclasses
import math
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.launch import op_cost
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.launch.train import mesh_loss_and_grads
from repro_torch.launch.variants import apply_variant
from repro_torch.models import get_module, mamba2
from repro_torch.models.convert import params_on_mesh
from repro_torch.models.params import init_from_defs, shard_params
from repro_torch.models.sharding import (READ_IN_F32, CollectiveLog,
                                         Distribution, default_rules)
from repro_torch.train.optimizer import tree_map

ROOT = Path(__file__).resolve().parents[1]
B, P, NEW, FRAMES = 4, 64, 2, 64  # P: one SSD chunk of 16 a block on 1 x 4
# the LM tolerance (ROADMAP finding 3); zamba2's and seamless's bf16
# rounding reaches beyond it in the reference itself, so they get twice
# its atol (finding 12), as tests/test_torch_lm_mesh_families.py holds them
ATOL, RTOL = 6e-2, 3e-2
SERVE_ATOL = {"zamba2-1.2b": 2 * ATOL, "seamless-m4t-large-v2": 2 * ATOL}
BEYOND = 1e-2  # a decode step's share of logits allowed beyond it
# (arch, the Mamba mixer's layout variant)
DECODE_CASES = (("gemma3-1b", "baseline"), ("chameleon-34b", "baseline"),
                ("phi3.5-moe-42b-a6.6b", "baseline"),
                ("zamba2-1.2b", "baseline"),
                ("seamless-m4t-large-v2", "baseline"),
                ("mamba2-780m", "baseline"), ("mamba2-780m", "seq_sp_mixer"))
REFERENCE_ARCHS = ("gemma3-1b", "mamba2-780m")

_REFERENCE = textwrap.dedent("""
    import sys
    sys.path.insert(0, sys.argv[1])
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import AxisType, NamedSharding
    from repro.configs import get_config
    from repro.models import get_module
    from repro.models.params import init_from_defs, pspecs_from_defs
    from repro.models.sharding import Distribution

    inp = dict(np.load(sys.argv[2]))
    out = {}
    mesh = jax.make_mesh((1, 4), ("data", "model"), devices=jax.devices()[:4],
                         axis_types=(AxisType.Auto,) * 2)
    dist = Distribution(mesh=mesh)
    prompts = jnp.asarray(inp["prompts"], jnp.int32)
    forced = jnp.asarray(inp["forced"], jnp.int32)
    P0, n = prompts.shape[1], forced.shape[1]
    for arch in sys.argv[4:]:
        cfg = get_config(arch, smoke=True)
        mod = get_module(cfg)
        params = init_from_defs(mod.defs(cfg), jax.random.PRNGKey(0))
        for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
            out[arch + ":param:" + "/".join(k.key for k in path)] = \\
                np.asarray(leaf)
        specs = pspecs_from_defs(mod.defs(cfg), dist.rules, mesh)
        with jax.set_mesh(mesh):
            sp = jax.tree.map(lambda a, s: jax.device_put(
                a, NamedSharding(mesh, s)), params, specs)
            lg, cache = jax.jit(lambda p, t: mod.prefill(
                cfg, p, t, dist=dist, max_len=P0 + n))(sp, prompts)
            out[arch + ":0"] = np.asarray(lg.astype(jnp.float32))
            step = jax.jit(lambda p, c, t, pos: mod.decode_step(
                cfg, p, c, t, pos, dist=dist))
            for i in range(n):
                lg, cache = step(sp, cache, forced[:, i:i + 1],
                                 jnp.int32(P0 + i))
                out[arch + ":" + str(i + 1)] = np.asarray(
                    lg.astype(jnp.float32))
    np.savez(sys.argv[3], **out)
""")


def _inputs() -> dict:
    rng = np.random.default_rng(31)
    return {"prompts": rng.integers(0, 512, (B, P)),
            "forced": rng.integers(0, 512, (B, NEW)),
            "frames": rng.standard_normal((B, FRAMES, 64)).astype(np.float32)}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The inputs and the reference's 1 x 4 mesh runs (one subprocess)."""
    inp = _inputs()
    tmp = tmp_path_factory.mktemp("lm_mesh_schedule")
    np.savez(tmp / "in.npz", **inp)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    r = subprocess.run([sys.executable, "-c", _REFERENCE, str(ROOT / "src"),
                        str(tmp / "in.npz"), str(tmp / "out.npz"),
                        *REFERENCE_ARCHS], env=env, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    return inp, dict(np.load(tmp / "out.npz"))


def _dist(shape=(2, 2)) -> Distribution:
    mesh = make_debug_mesh(shape, devices="cpu")
    return Distribution(mesh, default_rules(mesh))


def _tree(out: dict, prefix: str) -> dict:
    tree = {}
    for key, val in out.items():
        if key.startswith(prefix):
            node = tree
            *path, leaf = key[len(prefix):].split("/")
            for k in path:
                node = node.setdefault(k, {})
            node[leaf] = val
    return tree


def _serve_inputs(cfg, inp: dict):
    prompts = torch.from_numpy(inp["prompts"])
    if cfg.family != "audio":
        return prompts
    St = max(FRAMES // 8, 16)
    return {"frames": torch.from_numpy(inp["frames"]).bfloat16(),
            "tokens": prompts[:, :St]}


def _serve(cfg, params, inputs, forced, dist=None) -> tuple:
    """The prefill's last logits and ``forced``'s decode steps' (each
    whole), and the log's calls of each decode step."""
    mod = get_module(cfg)
    P0 = (inputs["tokens"] if isinstance(inputs, dict) else inputs).shape[1]
    whole = (lambda t: dist.full(t)) if dist is not None else (lambda t: t)
    steps = []
    with torch.no_grad():
        lg, cache = mod.prefill(cfg, params, inputs,
                                max_len=P0 + forced.shape[1], dist=dist)
        out = [whole(lg)]
        for i in range(forced.shape[1]):
            if dist is not None:
                dist.log.clear()
            lg, cache = mod.decode_step(cfg, params, cache,
                                        forced[:, i:i + 1], P0 + i,
                                        dist=dist)
            out.append(whole(lg))
            if dist is not None:
                steps.append((list(dist.log.calls),
                              list(dist.log.param_calls)))
    return out, steps


def _seed(cfg) -> dict:
    return init_from_defs(get_module(cfg).defs(cfg),
                          torch.Generator().manual_seed(0), "cpu")


# ------------------------------------------------------ shift and chain --

@pytest.mark.parametrize("axes", [("model",), ("data", "model")])
@pytest.mark.parametrize("fill", [False, True])
def test_shift_and_its_transpose_are_an_all_gather_and_slice(axes, fill):
    """``shift``: rank r gets rank r - 1's block (the first rank zeros, or
    its own block of ``fill``), bit for bit the all-gather-and-slice form;
    its gradient, the reverse shift, is that form's gradient (the gather's
    reduce-scatter of one nonzero block) bit for bit too.  One
    collective-permute each way, which ``parse_collectives`` counts once
    on the wire."""
    dist = _dist()
    g = torch.Generator().manual_seed(7)
    x0 = torch.randn(4, 8, 3, generator=g)
    f0 = torch.randn(4, 8, 3, generator=g)
    cot = torch.randn(4, 8, 3, generator=g)
    spec = ((), axes, ())
    n = dist.group_size(axes)

    def run(form):
        x = dist.map(lambda t: t.detach().requires_grad_(),
                     dist.shard(x0, spec), spec=spec)
        f = dist.map(lambda t: t.detach().requires_grad_(),
                     dist.shard(f0, spec), spec=spec) if fill else None
        dist.log.clear()
        if form == "shift":
            y = dist.shift(x, axes, fill=f)
        else:
            whole = dist.all_gather(x, 1)

            def cut(i, t, *fi):
                r, m = dist.mesh.rank(i, axes), 8 // n
                if r == 0:
                    return fi[0] if fi else torch.zeros_like(t[:, :m])
                return t[:, (r - 1) * m:r * m]

            y = dist.map(cut, whole, *((f,) if fill else ()), pos=True,
                         spec=spec)
        w = dist.shard(cot, spec)
        pairs = [(y.local(i), w.local(i)) for i in dist.mesh.active
                 if y.local(i).requires_grad]
        torch.autograd.backward(*zip(*pairs))
        grads = [t.grad if t.grad is not None else torch.zeros_like(t)
                 for t in list(x.shards.values())
                 + (list(f.shards.values()) if fill else [])]
        return dist.full(y), grads, list(dist.log.calls)

    got, got_g, calls = run("shift")
    want, want_g, _ = run("gather")
    assert torch.equal(got, want)
    assert all(torch.equal(a, b) for a, b in zip(got_g, want_g))
    nbytes = 4 * 8 // n * 3 * 4
    assert calls == [("collective-permute", axes, nbytes)] * 2
    summary = op_cost.parse_collectives(CollectiveLog(calls))
    assert summary["collective-permute"] == {"count": 2,
                                             "bytes": 2 * nbytes}
    assert summary["wire_bytes"] == summary["total_bytes"] == 2 * nbytes


def test_chain_is_the_meshless_scan_in_position_order():
    """``chain`` over ``mamba2.ssd_carry``: each position runs the
    recurrence over its chunks from the state its predecessor passed on,
    so the states entering every chunk and the last state are the meshless
    loop's bits, and so are the gradients of the chunks' decays and
    states (the reverse chain).  One collective-permute of a state each
    way (each position receives one)."""
    dist = _dist((1, 4))
    g = torch.Generator().manual_seed(9)
    a0 = torch.rand(2, 8, 3, generator=g)
    s0 = torch.randn(2, 8, 3, 4, 5, generator=g)
    cot = torch.randn(2, 8, 3, 4, 5, generator=g)
    cot_last = torch.randn(2, 3, 4, 5, generator=g)
    a, s = (t.clone().requires_grad_() for t in (a0, s0))
    h_prev, h_last = mamba2.ssd_carry(a, s)
    torch.autograd.backward([h_prev, h_last], [cot, cot_last])
    spec = ((), ("model",), ())
    sa = dist.map(lambda t: t.detach().requires_grad_(), dist.shard(a0, spec),
                  spec=spec)
    ss = dist.map(lambda t: t.detach().requires_grad_(),
                  dist.shard(s0, spec + ((), ())), spec=spec + ((), ()))
    dist.log.clear()
    outs, carries = dist.chain(lambda i, h, ai, si: mamba2.ssd_carry(
        ai, si, h)[::-1], ("model",), sa, ss, spec=spec + ((), ()))
    assert torch.equal(dist.full(outs), h_prev)
    assert torch.equal(carries.local(3), h_last)
    w = dist.shard(cot, spec + ((), ()))
    torch.autograd.backward(
        [outs.local(i) for i in range(4)] + [carries.local(3)],
        [w.local(i) for i in range(4)] + [cot_last])
    assert torch.equal(torch.cat([t.grad for t in sa.shards.values()], 1),
                       a.grad)
    assert torch.equal(torch.cat([t.grad for t in ss.shards.values()], 1),
                       s.grad)
    assert dist.log.calls == [("collective-permute", ("model",),
                               2 * 3 * 4 * 5 * 4)] * 2


# ----------------------------------------------------------------- decode --

def _mamba_out_moves(cfg, dist) -> list:
    """The parameter moves a decode step makes: per Mamba layer its gated
    norm's gain (f32) and w_out (bf16) gathered whole
    (``mamba2._decode_out``; none for the other families)."""
    if cfg.family not in ("ssm", "hybrid"):
        return []
    axes = dist.layout("ssm_inner", shape=(cfg.d_inner,))[0]
    one = [("all-gather", axes, cfg.d_inner * 4),
           ("all-gather", axes, cfg.d_inner * cfg.d_model * 2)]
    return one * cfg.n_layers if axes else []


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)])
@pytest.mark.parametrize("arch,layout", DECODE_CASES)
def test_decode_moves_no_parameter_but_the_mamba_out_projection(
        arch, layout, shape):
    """A prefill and two teacher-forced decode steps of each family's smoke
    config on the mesh: no decode step moves a parameter (the log marks
    every parameter move; the decode's other all-gathers are activations:
    q, k and v along their packed dims, the Mamba mixer's bf16(y *
    silu(z)) rows), but the Mamba layers' gated norm gain and w_out,
    gathered whole (w_out in bf16) so that the product is the meshless
    GEMM's; and the logits are the meshless run's within the family's
    serving tolerance (twice the LM atol for zamba2 and seamless), the
    prefill's at every entry and a decode step's at all but ``BEYOND`` of
    them, as tests/test_torch_lm_mesh_families.py holds the families to
    the reference (measured: 1 of 2048 entries of zamba2's first step on
    2 x 2, 0.1211 from the meshless run's, against 0.12 + 3e-2 |x|)."""
    cfg = apply_variant(get_config(arch, smoke=True), layout)
    if cfg.n_experts:  # room for every token: no drop on either path
        cfg = dataclasses.replace(cfg, capacity_factor=8.0)
    params = _seed(cfg)
    inp = _inputs()
    inputs = _serve_inputs(cfg, inp)
    forced = torch.from_numpy(inp["forced"])
    want, _ = _serve(cfg, params, inputs, forced)
    dist = _dist(shape)
    got, steps = _serve(cfg, shard_params(params, get_module(cfg).defs(cfg),
                                          dist), inputs, forced, dist)
    for calls, params_moved in steps:
        assert calls and params_moved == _mamba_out_moves(cfg, dist), \
            params_moved
        assert any(c[0] == "all-reduce" for c in calls)
    for i, (a, b) in enumerate(zip(got, want)):
        a, b = a.float().numpy(), b.float().numpy()
        bad = np.abs(a - b) > SERVE_ATOL.get(arch, ATOL) + RTOL * np.abs(b)
        assert bad.mean() <= (0.0 if i == 0 else BEYOND), (
            i, int(bad.sum()), float(np.abs(a - b).max()))


@pytest.mark.parametrize("arch", REFERENCE_ARCHS)
def test_decode_matches_the_reference_on_a_1x4_mesh(reference, arch):
    """The reference's prefill and 2 decode steps under ``jax.set_mesh``
    on a 1 x 4 mesh (GSPMD runs its decode column- and row-parallel on the
    weights' shards), from its own weights: the port's on its 1 x 4 mesh
    within the LM tolerance at every step, with no parameter moved in
    decode but the Mamba mixer's w_out and its norm's gain."""
    inp, out = reference
    cfg = get_config(arch, smoke=True)
    dist = _dist((1, 4))
    sp = params_on_mesh(_tree(out, f"{arch}:param:"),
                        get_module(cfg).defs(cfg), dist, "cpu")
    got, steps = _serve(cfg, sp, _serve_inputs(cfg, inp),
                        torch.from_numpy(inp["forced"]), dist)
    assert all(moved == _mamba_out_moves(cfg, dist) for _, moved in steps)
    for i, lg in enumerate(got):
        np.testing.assert_allclose(lg.float().numpy(), out[f"{arch}:{i}"],
                                   atol=ATOL, rtol=RTOL, err_msg=f"step {i}")


# ------------------------------------------------- prefill and training --

def _leaf_gathers(monkeypatch) -> list:
    """Records (leaf name, the dtype it moved in, its whole bytes) of every
    leaf ``Distribution.at_use`` gathers."""
    seen = []
    at_use = Distribution.at_use

    def spy(self, tree, layer=None, mode="train", name=None):
        out = at_use(self, tree, layer, mode, name)
        if not isinstance(tree, dict) and mode != "decode" and any(
                tree.spec[layer is not None:]):
            seen.append((name, out.dtype,
                         math.prod(out.local_shape) * out.dtype.itemsize))
        return out

    monkeypatch.setattr(Distribution, "at_use", spy)
    return seen


@pytest.mark.parametrize("arch", ["gemma3-1b", "mamba2-780m", "zamba2-1.2b",
                                  "seamless-m4t-large-v2"])
def test_prefill_gathers_in_the_read_dtype_and_training_in_f32(arch,
                                                              monkeypatch):
    """Prefill (autograd records nothing): every weight that is gathered
    moves in bf16, the type it is read in, but the ``READ_IN_F32`` leaves
    (norm gains, conv taps, the SSM's per-head scalars), which move in
    f32; the log's parameter moves are those gathers, byte for byte.  A
    training forward (autograd recording) moves every leaf in f32, so that
    the gathers' transposes, the gradients' reduce-scatters, sum in f32."""
    cfg = get_config(arch, smoke=True)
    mod = get_module(cfg)
    params = _seed(cfg)
    dist = _dist()
    sp = shard_params(params, mod.defs(cfg), dist)
    inp = _inputs()
    seen = _leaf_gathers(monkeypatch)
    with torch.no_grad():
        mod.prefill(cfg, sp, _serve_inputs(cfg, inp), dist=dist)
    assert seen
    for name, dtype, _ in seen:
        assert dtype == (torch.float32 if name in READ_IN_F32
                         else torch.bfloat16), name
    assert {n for n, d, _ in seen if d == torch.bfloat16}
    assert sum(c[2] for c in dist.log.param_calls) == sum(
        n for _, _, n in seen)
    seen.clear()
    dist.log.clear()
    tokens = torch.from_numpy(inp["prompts"][:, :32])
    batch = {"tokens": tokens, "labels": tokens}
    if cfg.family == "audio":
        batch["frames"] = torch.from_numpy(inp["frames"]).bfloat16()
        batch["tokens"] = batch["labels"] = tokens[:, :16]
    leaves = tree_map(lambda p: dist.map(
        lambda t: t.detach().requires_grad_(), p, spec=p.spec), sp)
    mod.loss_fn(cfg, leaves, batch, dist=dist)  # the forward records
    assert seen and all(d == torch.float32 for _, d, _ in seen)
    assert sum(c[2] for c in dist.log.param_calls) == sum(
        n for _, _, n in seen)


# -------------------------------------------------------------- seq_sp --

@pytest.mark.parametrize("arch", ["mamba2-780m", "zamba2-1.2b"])
def test_seq_sp_prefill_and_training_are_the_meshless_bits(arch):
    """``seq_sp`` on the 2 x 2 mesh, its halo and carry shifted in
    position order: the prefill's logits and final SSM states and the
    training forward's logits bit for bit the meshless path's, and a
    training step's loss (remat on: each layer one region, recomputed)
    bit for bit ``head_tp``'s on the same mesh (the vocab-sharded CE is
    the mesh's own sum); the Mamba layers' sequence
    collectives are collective-permutes (a halo and a carry each way per
    layer in training), and no chunk state is all-gathered."""
    cfg = apply_variant(get_config(arch, smoke=True), "seq_sp_mixer")
    mod = get_module(cfg)
    params = _seed(cfg)
    prompts = torch.from_numpy(_inputs()["prompts"][:, :32])
    with torch.no_grad():
        want_lg, want_st = mod.prefill(cfg, params, prompts)
    dist = _dist()
    sp = shard_params(params, mod.defs(cfg), dist)
    with torch.no_grad():
        lg, st = mod.prefill(cfg, sp, prompts, dist=dist)
    assert torch.equal(dist.full(lg), want_lg)
    assert torch.equal(dist.full(st["h"]), want_st["h"])
    with torch.no_grad():
        want = mod.forward(cfg, params, prompts, mode="train")[0]
        got = mod.forward(cfg, sp, prompts, mode="train", dist=dist)[0]
    assert torch.equal(dist.full(got), want)
    batch = {"tokens": prompts, "labels": prompts.roll(-1, 1)}
    cfg = dataclasses.replace(cfg, remat=True)
    with torch.no_grad():
        head_tp = mod.loss_fn(get_config(arch, smoke=True), sp, batch,
                              dist=dist)[0].local(0)
    dist.log.clear()
    loss, _ = mesh_loss_and_grads(cfg, sp, batch, dist=dist)
    assert torch.equal(loss, head_tp)
    kinds = [c[0] for c in dist.log.calls]
    # per Mamba layer: the forward, remat's recompute and the backward's
    # reverse shifts, each a halo and a carry
    assert kinds.count("collective-permute") == 2 * cfg.n_layers * 3
    # the chunks' states and decays (B, c, H, N, P), (B, c, H) all-gathered
    # was the carry before the scan
    c = prompts.shape[1] // cfg.ssd_chunk
    H, N, Pd = cfg.ssm_nheads, cfg.ssm_state, cfg.ssm_headdim
    gathered = {c[2] for j, c in enumerate(dist.log.calls)
                if c[0] == "all-gather" and j not in dist.log.params}
    assert not gathered & {4 * B // 2 * c * H * N * Pd, 4 * B // 2 * c * H}
