"""The SSM, hybrid and encoder-decoder families over a (data, model) mesh:
the port on a 2 x 2 mesh bound to ``["cpu"] * 4`` against the reference's
mesh runs, and against its own meshless path.

The reference runs in one subprocess per case and part, eight at a time
(``XLA_FLAGS=--xla_force_host_platform_device_count=8``, a 2 x 2
``jax.make_mesh``, jitted under ``jax.set_mesh``), from its own weights:
``prefill`` plus 4 teacher-forced ``decode_step``s (for the
encoder-decoder its serving prefill: ``encode``, ``make_cache``,
``decode_train``) and, from its ``build_cell`` train cell's layouts,
``jax.value_and_grad`` of ``loss_fn(dist=)`` and one AdamW step, for
``mamba2-smoke`` under the ``head_tp`` and ``seq_sp`` mixer layouts,
``zamba2-smoke`` and ``seamless-smoke`` under the variants ``TRAIN``
names.  Also: a 1 x 1 mesh gives the meshless bits, one device per
position the one-device bits, ``seq_sp`` against ``head_tp``,
``generate`` on the mesh, and the collective log of one Mamba layer
against a hand count.
"""
import concurrent.futures
import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import specs
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.launch.serve_lm import generate
from repro_torch.launch.train import mesh_loss_and_grads
from repro_torch.launch.variants import apply_variant
from repro_torch.models import get_module, mamba2, ssm_lm
from repro_torch.models.convert import params_on_mesh
from repro_torch.models.params import init_from_defs, shard_params
from repro_torch.models.sharding import Distribution, default_rules
from repro_torch.train.optimizer import tree_leaves, tree_map
from torch.utils._pytree import tree_leaves as all_leaves

ROOT = Path(__file__).resolve().parents[1]
# tag -> (arch, the layout's variant)
CASES = {"mamba2": ("mamba2-780m", "baseline"),
         "mamba2_sp": ("mamba2-780m", "seq_sp_mixer"),
         "zamba2": ("zamba2-1.2b", "baseline"),
         "seamless": ("seamless-m4t-large-v2", "baseline")}
# the train steps held to the reference's, by tag: ZeRO-1 on the Mamba
# stack, seq_sp's own layout, zamba2's baseline, and ZeRO-3 (with zero1, as
# the reference's variants set it) with the sp attention on the
# encoder-decoder (its non-causal encoder and cross attention along the
# sequence)
TRAIN = {"mamba2": ("zero1",),
         "mamba2_sp": ("seq_sp_mixer",),
         "zamba2": ("baseline",),
         "seamless": ("sp_attn+zero3+chunked_loss",)}
# the cases whose reference also runs without a mesh, for its own spread
# between the two (mamba2's and seamless's are inside the tolerances; the
# tests take a spread of 0 where it is not run)
SPREAD = ("zamba2",)
B, P, NEW, S, FRAMES = 4, 32, 4, 32, 64  # St = max(FRAMES // 8, 16) = 16
LR = 3e-4  # build_cell's default, both packages'
# the LM tolerance (ROADMAP finding 3); zamba2's and seamless's bf16
# rounding reaches beyond it in the reference itself, so they get twice
# its atol (ROADMAP finding 12)
ATOL, RTOL = 6e-2, 3e-2
SERVE_ATOL = {"mamba2": ATOL, "mamba2_sp": ATOL, "zamba2": 2 * ATOL,
              "seamless": 2 * ATOL}
# the share of a decode step's logits allowed beyond the tolerance against
# the reference's mesh run (test_mesh_serving_matches_the_reference)
BEYOND = 1e-2
# each gradient leaf as |port - reference| / |reference| (Frobenius), as
# tests/test_torch_lm_mesh_train.py holds the transformer's, plus the
# reference's own spread at that leaf, |its mesh gradient - its meshless
# gradient| / |its mesh gradient| (zamba2's: 0.0174 to 0.1471 on these
# inputs, its shared block's bf16 chains fused at other points by the two
# layouts; the port's meshless gradient is 0.0251 to 0.1799 from the
# reference's mesh gradient there)
GRAD_REL = 5e-2
# after one AdamW step from zero moments (tests/test_torch_lm_mesh_train.py)
M_REL, V_REL = 5e-2, 1e-1
NEW_ATOL = 2 * LR + 1e-6
# a leaf whose dim 0 the ZeRO rule splits over "data" (zamba2's 5 stacked
# layers do not divide by the 2 data positions, its shared block's do)
ZERO_LEAF = {"mamba2": ("layers", "w_out"), "mamba2_sp": ("layers", "w_out"),
             "zamba2": ("shared_attn", "w_gate"),
             "seamless": ("dec_layers", "wo")}

_REFERENCE = textwrap.dedent("""
    import dataclasses, sys
    sys.path.insert(0, sys.argv[1])
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import AxisType, NamedSharding
    from repro.configs import get_config
    from repro.configs.base import ShapeConfig
    from repro.launch import specs
    from repro.launch.variants import VARIANTS
    from repro.models import encdec, get_module
    from repro.models.params import init_from_defs, pspecs_from_defs
    from repro.models.sharding import Distribution
    from repro.train.optimizer import adamw, apply_updates

    inp = dict(np.load(sys.argv[2]))
    part, arch, layout = sys.argv[4:7]
    out = {}
    mesh = jax.make_mesh((2, 2), ("data", "model"), devices=jax.devices()[:4],
                         axis_types=(AxisType.Auto,) * 2)
    dist = Distribution(mesh=mesh)

    def over(cfg, name):
        return dataclasses.replace(cfg, **VARIANTS[name])

    def flat(prefix, tree):
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            out[prefix + "/".join(k.key for k in path)] = np.asarray(
                leaf.astype(jnp.float32))

    cfg = over(get_config(arch, smoke=True), layout)
    mod = get_module(cfg)
    params = init_from_defs(mod.defs(cfg), jax.random.PRNGKey(0))
    flat("param:", params)
    enc = cfg.family == "audio"
    frames = jnp.asarray(inp["frames"], jnp.bfloat16) if enc else None
    prompts = jnp.asarray(inp["prompts"], jnp.int32)
    forced = jnp.asarray(inp["forced"], jnp.int32)
    P0, n = prompts.shape[1], forced.shape[1]
    pspecs = pspecs_from_defs(mod.defs(cfg), dist.rules, mesh)

    def serve(d, p, prefix):
        if enc:
            def pre(p, f, t):
                e = encdec.encode(cfg, p, f, dist=d, mode="prefill")
                c = encdec.make_cache(cfg, p, e, P0 + n, dist=d)
                lg = encdec.decode_train(cfg, p, e, t, dist=d,
                                         mode="prefill")
                return lg[:, -1:], c
            lg, cache = jax.jit(pre)(p, frames, prompts)
        else:
            lg, cache = jax.jit(lambda p, t: mod.prefill(
                cfg, p, t, dist=d, max_len=P0 + n))(p, prompts)
        out[prefix + "0"] = np.asarray(lg.astype(jnp.float32))
        step = jax.jit(lambda p, c, t, pos: mod.decode_step(
            cfg, p, c, t, pos, dist=d))
        for i in range(n):
            lg, cache = step(p, cache, forced[:, i:i + 1], jnp.int32(P0 + i))
            out[prefix + str(i + 1)] = np.asarray(lg.astype(jnp.float32))

    if part == "serve":
        with jax.set_mesh(mesh):
            serve(dist, jax.tree.map(lambda a, s: jax.device_put(
                a, NamedSharding(mesh, s)), params, pspecs), "logits:")
    if part == "serve_plain":
        serve(Distribution.single_device(), params, "plain:")
    if part.startswith("serve"):
        np.savez(sys.argv[3], **out)
        sys.exit(0)

    tokens = jnp.asarray(inp["tokens"], jnp.int32)
    labels = jnp.asarray(inp["labels"], jnp.int32)
    S = frames.shape[1] if enc else tokens.shape[1]
    shape = ShapeConfig("t", S, tokens.shape[0], "train")
    if part == "plain":
        plain = {"tokens": tokens, "labels": labels}
        if enc:
            plain["frames"] = frames
        (loss, _), grads = jax.jit(jax.value_and_grad(
            lambda q: mod.loss_fn(cfg, q, plain,
                                  dist=Distribution.single_device()),
            has_aux=True))(params)
        out["plain:loss"] = np.asarray(loss)
        flat("plain:grad:", grads)
    else:
        variant = part
        vcfg = over(cfg, variant)
        cell = specs.build_cell(vcfg, shape, mesh)
        state, bspecs = cell.args
        put = lambda a, s: jax.device_put(a, s.sharding)
        zeros = lambda s: jax.device_put(jnp.zeros(s.shape, s.dtype),
                                         s.sharding)
        p = jax.tree.map(put, params, state["params"])
        m = jax.tree.map(zeros, state["opt"]["m"])
        v = jax.tree.map(zeros, state["opt"]["v"])
        batch = {"tokens": put(tokens, bspecs["tokens"]),
                 "labels": put(labels, bspecs["labels"])}
        if enc:
            batch["frames"] = put(frames, bspecs["frames"])
        d = Distribution(mesh=mesh, rules=specs.shape_rules(vcfg, shape,
                                                            mesh))
        opt = adamw(float(inp["lr"]))

        def train(p, m, v, batch):
            (loss, _), grads = jax.value_and_grad(
                lambda q: mod.loss_fn(vcfg, q, batch, dist=d),
                has_aux=True)(p)
            upd, st = opt.update(grads, {"m": m, "v": v, "count":
                                         jnp.zeros((), jnp.int32)}, p)
            return loss, grads, apply_updates(p, upd), st["m"], st["v"]

        with jax.set_mesh(mesh):
            loss, grads, new, nm, nv = jax.jit(train)(p, m, v, batch)
        out[variant + ":loss"] = np.asarray(loss)
        for name, tree in (("grad", grads), ("new", new), ("m", nm),
                           ("v", nv)):
            flat(variant + ":" + name + ":", tree)
    np.savez(sys.argv[3], **out)
""")


def _inputs(tag: str) -> dict:
    rng = np.random.default_rng(30 + list(CASES).index(tag))
    enc = tag == "seamless"
    St = max(FRAMES // 8, 16) if enc else None
    toks = rng.integers(0, 512, (B, (St or S) + 1))
    inp = {"prompts": rng.integers(0, 512, (B, St or P)),
           "forced": rng.integers(0, 512, (B, NEW)),
           "tokens": toks[:, :-1], "labels": toks[:, 1:], "lr": np.array(LR)}
    if enc:
        inp["frames"] = rng.standard_normal((B, FRAMES, 64)).astype(
            np.float32)
    return inp


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """Each case's inputs and the reference's outputs: one subprocess per
    case and part (its mesh serving run, its meshless serving run, its
    meshless gradient, each train variant), eight at a time, each with
    XLA on one thread (the jit compiles dominate)."""
    tmp = tmp_path_factory.mktemp("lm_mesh_families")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8 "
                         "--xla_cpu_multi_thread_eigen=false")
    for tag in CASES:
        np.savez(tmp / f"{tag}_in.npz", **_inputs(tag))

    def run(job):
        tag, part = job
        arch, layout = CASES[tag]
        r = subprocess.run([sys.executable, "-c", _REFERENCE,
                            str(ROOT / "src"), str(tmp / f"{tag}_in.npz"),
                            str(tmp / f"{tag}_{part}.npz"), part, arch,
                            layout], env=env, capture_output=True, text=True,
                           timeout=600)
        assert r.returncode == 0, r.stdout + r.stderr
        return tag, dict(np.load(tmp / f"{tag}_{part}.npz"))

    jobs = [(tag, part) for tag in CASES
            for part in (("serve",) + TRAIN[tag]
                         + (("serve_plain", "plain") if tag in SPREAD
                            else ()))]
    out = {tag: {} for tag in CASES}
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        for tag, o in pool.map(run, jobs):
            out[tag].update(o)
    return {tag: (_inputs(tag), out[tag]) for tag in CASES}


def _cfg(tag: str, variant: str = "baseline"):
    arch, layout = CASES[tag]
    return apply_variant(apply_variant(get_config(arch, smoke=True), layout),
                         variant)


def _dist(shape=(2, 2), devices="cpu") -> Distribution:
    mesh = make_debug_mesh(shape, devices=devices)
    return Distribution(mesh, default_rules(mesh))


def _tree(out: dict, prefix: str) -> dict:
    tree = {}
    for key, val in out.items():
        if key.startswith(prefix):
            node = tree
            *path, leaf = key[len(prefix):].split("/")
            for k in path:
                node = node.setdefault(k, {})
            node[leaf] = torch.from_numpy(val)
    return tree


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _seed_params(cfg) -> dict:
    return init_from_defs(get_module(cfg).defs(cfg),
                          torch.Generator().manual_seed(0), "cpu")


def _serve_inputs(tag: str, inp: dict):
    prompts = torch.from_numpy(inp["prompts"])
    if tag != "seamless":
        return prompts
    return {"frames": torch.from_numpy(inp["frames"]).bfloat16(),
            "tokens": prompts}


def _teacher_forced(cfg, params, inputs, forced, dist=None) -> list:
    """The prefill's logits and ``forced``'s decode steps' (B, 1, V) each,
    assembled whole."""
    mod = get_module(cfg)
    P0 = (inputs["tokens"] if isinstance(inputs, dict) else inputs).shape[1]
    whole = (lambda t: dist.full(t)) if dist is not None else (lambda t: t)
    with torch.no_grad():
        lg, cache = mod.prefill(cfg, params, inputs,
                                max_len=P0 + forced.shape[1], dist=dist)
        out = [whole(lg)]
        for i in range(forced.shape[1]):
            lg, cache = mod.decode_step(cfg, params, cache,
                                        forced[:, i:i + 1], P0 + i,
                                        dist=dist)
            out.append(whole(lg))
    return out, cache


def _batch(tag: str, inp: dict) -> dict:
    batch = {"tokens": torch.from_numpy(inp["tokens"]),
             "labels": torch.from_numpy(inp["labels"])}
    if tag == "seamless":
        batch["frames"] = torch.from_numpy(inp["frames"]).bfloat16()
    return batch


# ------------------------------------------------- against the reference --

@pytest.mark.parametrize("tag", list(CASES))
def test_mesh_serving_matches_the_reference(reference, tag):
    """``prefill`` and 4 teacher-forced ``decode_step``s on the 2 x 2 CPU
    mesh from the reference's weights (``params_on_mesh``): every step's
    logits within the LM tolerance (twice its atol for zamba2 and
    seamless) of the port's meshless run, and of the reference's 2 x 2
    mesh run, where each entry is also allowed the reference's own spread
    there, |its mesh run - its meshless run| (on these inputs up to 0.1685
    for zamba2 and 0.1289 for seamless, 0.0332 for mamba2: XLA rounds the
    fused bf16 chains of its two layouts at other points).  The prefill
    meets that at every entry; a decode step at all but ``BEYOND`` of its
    entries (measured: 8 of 2048 in one row of zamba2's last step, where
    the port's meshless run is already 4 entries beyond twice the atol of
    the reference's meshless run)."""
    inp, out = reference[tag]
    cfg = _cfg(tag)
    mod = get_module(cfg)
    dist = _dist()
    params = _tree(out, "param:")
    sp = params_on_mesh(params, mod.defs(cfg), dist, "cpu")
    inputs = _serve_inputs(tag, inp)
    forced = torch.from_numpy(inp["forced"])
    got, _ = _teacher_forced(cfg, sp, inputs, forced, dist)
    plain, _ = _teacher_forced(cfg, params, inputs, forced)
    V = cfg.padded_vocab
    for i, (g, p) in enumerate(zip(got, plain)):
        assert g.shape == (B, 1, V)
        g = g.float().numpy()
        np.testing.assert_allclose(g, p.float().numpy(), rtol=RTOL,
                                   atol=SERVE_ATOL[tag],
                                   err_msg=f"step {i}, meshless")
        want = out[f"logits:{i}"]
        spread = np.abs(want - out.get(f"plain:{i}", want))
        bad = np.abs(g - want) > SERVE_ATOL[tag] + RTOL * np.abs(want) \
            + spread
        assert bad.mean() <= (0.0 if i == 0 else BEYOND), (
            i, int(bad.sum()), float(np.abs(g - want).max()))


@pytest.mark.parametrize("tag,variant", [(t, v) for t in CASES
                                         for v in TRAIN[t]])
def test_mesh_train_step_matches_the_reference(reference, tag, variant):
    """``build_cell(train, mesh=)`` on the 2 x 2 CPU mesh, from the
    reference's weights and batch: the loss within the LM tolerance; every
    gradient leaf within GRAD_REL of ``jax.value_and_grad`` on the same
    mesh, plus the reference's own spread at that leaf (its mesh gradient
    against its meshless one); after one step the new parameters within
    NEW_ATOL, m and v within M_REL and V_REL per leaf, plus that spread
    (twice it for v); ZeRO-1's moments and ZeRO-3's parameters split over
    "data" where the reference's rule splits them."""
    inp, out = reference[tag]
    cfg = _cfg(tag, variant)
    mod = get_module(cfg)
    shape = ShapeConfig("t", FRAMES if tag == "seamless" else S, B, "train")
    cell = specs.build_cell(cfg, shape, make_debug_mesh(devices="cpu"),
                            device="cpu")
    dist = cell.meta["dist"]
    state, _ = cell.args
    state["params"] = shard_params(_tree(out, "param:"), mod.defs(cfg), dist,
                                   cell.meta["param_specs"])
    batch = _batch(tag, inp)
    loss, grads = mesh_loss_and_grads(cfg, state["params"], batch, dist=dist,
                                      moments=state["opt"]["m"])
    want = float(out[f"{variant}:loss"])
    assert abs(float(loss) - want) <= ATOL + RTOL * abs(want)
    want = _tree(out, f"{variant}:grad:")
    spread = tree_map(_rel, _tree(out, "plain:grad:"), want) \
        if tag in SPREAD else tree_map(lambda w: 0.0, want)
    over = tree_map(lambda g, w, e: _rel(dist.full(g), w) - e, grads, want,
                    spread)
    assert max(tree_leaves(over)) <= GRAD_REL, over
    new, metrics = cell.fn(state, batch)
    assert torch.equal(metrics["loss"], loss)
    for name, tol, k in (("m", M_REL, 1), ("v", V_REL, 2)):
        over = tree_map(lambda t, w, e: _rel(dist.full(t), w) - k * e,
                        new["opt"][name], _tree(out, f"{variant}:{name}:"),
                        spread)
        assert max(tree_leaves(over)) <= tol, (name, over)
    errs = tree_map(lambda t, w: float((dist.full(t) - w).abs().max()),
                    new["params"], _tree(out, f"{variant}:new:"))
    assert max(tree_leaves(errs)) <= NEW_ATOL, errs
    group, name = ZERO_LEAF[tag]
    assert ("data" in new["params"][group][name].spec[0]) == cfg.zero3
    assert ("data" in new["opt"]["m"][group][name].spec[0]) == (
        cfg.zero1 or cfg.zero3)


# ------------------------------------------------------- the port itself --

def _run_all(cfg, params, dist, tag):
    """The port's prefill and one decode step (logits and the decode
    state or cache, whole), and the loss and gradients of a train
    batch."""
    mod = get_module(cfg)
    inp = _inputs(tag)
    forced = torch.from_numpy(inp["forced"][:, :1])
    inputs = _serve_inputs(tag, inp)
    sp = params if dist is None else shard_params(params, mod.defs(cfg),
                                                  dist)
    logits, cache = _teacher_forced(cfg, sp, inputs, forced, dist)
    whole = (lambda t: dist.full(t)) if dist is not None else (lambda t: t)
    cache = {k: whole(v) for k, v in cache.items()}
    batch = _batch(tag, inp)
    if dist is None:
        leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
        loss, _ = mod.loss_fn(cfg, leaves, batch)
        loss.backward()
        grads = tree_map(lambda p: p.grad, leaves)
    else:
        loss, grads = mesh_loss_and_grads(cfg, sp, batch, dist=dist)
        loss, grads = loss, tree_map(whole, grads)
    return logits, cache, loss.detach(), grads


@pytest.mark.parametrize("tag", list(CASES))
def test_one_by_one_mesh_and_one_device_per_position(tag):
    """A 1 x 1 mesh runs the meshless path's ops: the prefill's and a
    decode step's logits, the decode state (or cache), the loss and every
    gradient leaf bit for bit; and a 2 x 2 mesh with one device named per
    position (``["cpu"] * 4``) gives the bits of the mesh bound to one
    device."""
    cfg = _cfg(tag)
    params = _seed_params(cfg)
    want = _run_all(cfg, params, None, tag)
    got = _run_all(cfg, params, _dist((1, 1)), tag)
    for a, b in zip(all_leaves(got), all_leaves(want), strict=True):
        assert torch.equal(a, b)
    one = _run_all(cfg, params, _dist(), tag)
    each = _run_all(cfg, params, _dist(devices=["cpu"] * 4), tag)
    for a, b in zip(all_leaves(each), all_leaves(one), strict=True):
        assert torch.equal(a, b)


def test_seq_sp_matches_head_tp():
    """mamba2-smoke's two mixer layouts on the 2 x 2 mesh: the prefill's
    logits and states, a decode step and the loss bit for bit (each layout
    sums every reduction in the meshless order: the gated norm over whole
    rows, the carry over every chunk in turn), and every gradient leaf
    within GRAD_REL of the other layout's and of the meshless gradient
    (relative Frobenius; measured at most 1.5e-2: the vocab shards' bf16
    partial products of the unembed's transpose are summed over "model",
    as in tests/test_torch_lm_mesh_train.py)."""
    params = _seed_params(_cfg("mamba2"))
    plain = _run_all(_cfg("mamba2"), params, None, "mamba2")
    head = _run_all(_cfg("mamba2"), params, _dist(), "mamba2")
    seq = _run_all(_cfg("mamba2_sp"), params, _dist(), "mamba2")
    for a, b in zip(all_leaves(head[:3]), all_leaves(seq[:3]), strict=True):
        assert torch.equal(a, b)
    for got, want in ((seq, head), (seq, plain), (head, plain)):
        errs = tree_map(_rel, got[3], want[3])
        assert max(tree_leaves(errs)) <= GRAD_REL, errs


@pytest.mark.parametrize("tag", ["mamba2_sp", "zamba2", "seamless"])
def test_generate_on_a_mesh(tag):
    """``generate(dist=)`` on the 2 x 2 mesh (the encoder-decoder's frames
    too): the meshless run's greedy tokens, and its logits within the
    family's serving tolerance."""
    cfg = _cfg(tag)
    mod = get_module(cfg)
    params = _seed_params(cfg)
    inp = _inputs(tag)
    frames = (torch.from_numpy(inp["frames"]) if tag == "seamless"
              else None)
    prompts = torch.from_numpy(inp["prompts"])
    want = generate(cfg, params, prompts, NEW, frames=frames, device="cpu")
    dist = _dist()
    got = generate(cfg, shard_params(params, mod.defs(cfg), dist), prompts,
                   NEW, frames=frames, dist=dist)
    assert torch.equal(got.tokens, want.tokens)
    np.testing.assert_allclose(got.logits.float().numpy(),
                               want.logits.float().numpy(), rtol=RTOL,
                               atol=SERVE_ATOL[tag])


@pytest.mark.parametrize("tag", ["mamba2", "mamba2_sp"])
def test_collective_log_of_a_mamba_layer_matches_a_hand_count(tag):
    """One Mamba layer of the prefill on the 2 x 2 mesh logs, by kind and
    per-position bytes: the all-gathers of its weights that "ssm_inner"
    or "ssm_heads" shard, whole (w_z, w_x, w_dt, w_out cast to bf16 on
    their shards first, as they are read; the conv_x weight and bias,
    A_log, D, dt_bias and norm, read in f32, in f32), each marked as a
    parameter move; under ``head_tp`` x's sequence gathered (B, S, D) bf16
    and bf16(y * silu(z)) moved from the inner dim to the sequence (an
    all_to_all, (B, S / 2, d_inner) bf16); under ``seq_sp`` the conv
    halo, each block's last W - 1 raw rows (B, W - 1, d_inner + 2 G N)
    bf16 shifted to the next block, the carry's exclusive scan (one
    (B, H, N, P) f32 state into each position) and the last block's final
    state summed onto both positions of the sequence (f32)."""
    cfg = _cfg(tag)
    dist = _dist()
    params = _seed_params(cfg)
    sp = shard_params(params, ssm_lm.defs(cfg), dist)
    x = dist.constrain(torch.randn(B, S, cfg.d_model).bfloat16(), "batch",
                       "seq", "embed")
    dist.log.clear()
    with torch.no_grad():
        ssm_lm._mamba_layer_mesh(cfg, sp, 0, x, dist)
    D, din, H = cfg.d_model, cfg.d_inner, cfg.ssm_nheads
    N, Pd, W, G = cfg.ssm_state, cfg.ssm_headdim, cfg.conv_width, \
        cfg.ssm_ngroups
    bf16 = [D * din, D * din, D * H, din * D]  # w_z, w_x, w_dt, w_out
    f32 = [W * din, din, H, H, H, din]  # conv_x w, b, A_log, D, dt_bias, norm
    weights = [("all-gather", ("model",), 2 * n) for n in bf16] + [
        ("all-gather", ("model",), 4 * n) for n in f32]
    want = list(weights)
    Bl = B // 2  # the batch over "data"
    if tag == "mamba2":
        want += [("all-gather", ("model",), 2 * Bl * S * D),
                 ("all-to-all", ("model",), 2 * Bl * (S // 2) * din)]
    else:
        want += [("collective-permute", ("model",),
                  2 * Bl * (W - 1) * (din + 2 * G * N)),
                 ("collective-permute", ("model",), 4 * Bl * H * N * Pd),
                 ("all-reduce", ("model",), 4 * Bl * H * N * Pd)]
    assert sorted(dist.log.calls) == sorted(want)
    assert sorted(dist.log.param_calls) == sorted(weights)


def test_mamba_head_blocks_split_groups_whole():
    """A position's block of heads holds whole B/C groups, or lies inside
    one; a block that splits a group raises."""
    cfg = dataclasses.replace(get_config("mamba2-780m", smoke=True),
                              ssm_ngroups=2)
    assert mamba2._groups(cfg, 0, 4) == (0, 1)
    assert mamba2._groups(cfg, 4, 4) == (1, 2)
    assert mamba2._groups(cfg, 2, 2) == (0, 1)
    assert mamba2._groups(cfg, 0, 8) == (0, 2)
    with pytest.raises(ValueError, match="splits groups"):
        mamba2._groups(cfg, 0, 6)
