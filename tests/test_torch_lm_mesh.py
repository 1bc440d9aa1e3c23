"""LM serving over a (data, model) mesh: the port against the reference's
mesh semantics, on a 2 x 2 mesh bound to ``["cpu"] * 4``.

The reference runs its ``shard_map`` and GSPMD paths in one subprocess
(``XLA_FLAGS=--xla_force_host_platform_device_count=8``, a 2 x 2
``jax.make_mesh``): ``dist_decode_attention`` (the cache over "model", a
window, and the long-context layout over ("data", "model")), the
expert-parallel ``moe_block`` (a roomy and a tight capacity), the
vocab-sharded embedding lookup, and ``prefill`` plus 4 teacher-forced
``decode_step``s of the gemma3 and phi3.5-moe smoke configs under
``jax.set_mesh``, from the reference's own weights.  The port runs the same
inputs through ``models.sharding`` and is held to those outputs, and to its
own meshless path, within the tolerances each test states.  Also: a 1 x 1
mesh gives the meshless bits, the offset attention's plain version, the
collective log against a hand count, ``build_cell(mesh=)`` and ``dryrun
--mesh multi``, and what still raises.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jlayers
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref as tref
from repro_torch.launch import dryrun, op_cost, specs
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.launch.serve_lm import generate
from repro_torch.models import layers, moe, ssm_lm, transformer
from repro_torch.models.convert import params_on_mesh
from repro_torch.models.params import init_from_defs, shard_params
from repro_torch.models.sharding import Distribution, default_rules

ROOT = Path(__file__).resolve().parents[1]
SERVE_ARCHS = ("gemma3-1b", "phi3.5-moe-42b-a6.6b")
B, PROMPT, NEW = 4, 24, 4
# the LM tolerance (ROADMAP finding 3): XLA fuses bf16 chains in f32 and
# rounds once, torch rounds after each op
LOGIT_ATOL, LOGIT_RTOL = 6e-2, 3e-2
DD_TOL = dict(rtol=2e-4, atol=2e-4)  # the reference's own, in f32
# the MoE FFN in f32: the same routing and buffers; the experts' products
# and the combine sum in another order (measured at most 1.1e-7 on the CPU)
MOE_TOL = dict(rtol=1e-5, atol=1e-5)
MOE_CFG = dict(name="t", family="moe", n_layers=1, d_model=32, n_heads=4,
               n_kv_heads=2, d_ff=64, vocab_size=128, n_experts=4, top_k=2)
DD_CASES = {"dd": (4, 32, 0, 20, "model"), "dd_window": (4, 32, 8, 27,
                                                         "model"),
            "dd_wide": (1, 32, 0, 30, "wide")}

_REFERENCE = textwrap.dedent("""
    import sys
    sys.path.insert(0, sys.argv[1])
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import AxisType, NamedSharding
    from repro.configs import get_config
    from repro.configs.base import ModelConfig
    from repro.models import layers, moe, transformer as T
    from repro.models.params import init_from_defs, pspecs_from_defs
    from repro.models.sharding import Distribution, default_rules

    inp = dict(np.load(sys.argv[2]))
    out = {}
    mesh = jax.make_mesh((2, 2), ("data", "model"), devices=jax.devices()[:4],
                         axis_types=(AxisType.Auto,) * 2)
    dist = Distribution(mesh=mesh)
    wide = Distribution(mesh=mesh, rules={**default_rules(mesh),
                                          "kv_seq": ("data", "model")})
    for name in ("dd", "dd_window", "dd_wide"):
        q, k, v, qp, kp = (jnp.asarray(inp[name + ":" + x])
                           for x in ("q", "k", "v", "q_pos", "k_pos"))
        d = wide if name == "dd_wide" else dist
        with jax.set_mesh(mesh):
            out[name] = np.asarray(layers.dist_decode_attention(
                q, k, v, qp, kp, dist=d, window=int(inp[name + ":window"])))
    cfg_kw = dict(name="t", family="moe", n_layers=1, d_model=32, n_heads=4,
                  n_kv_heads=2, d_ff=64, vocab_size=128, n_experts=4,
                  top_k=2)
    p = {k: jnp.asarray(inp["moe:" + k])
         for k in ("router", "w_gate", "w_up", "w_down")}
    x = jnp.asarray(inp["moe:x"])
    for cf in ("8.0", "0.5"):
        cfg = ModelConfig(**cfg_kw, capacity_factor=float(cf))
        with jax.set_mesh(mesh):
            o, aux = moe.moe_block(cfg, p, x, dist=dist, mode="prefill")
            idx, _, _ = moe._route(cfg, p, x)
        out["moe" + cf + ":out"] = np.asarray(o)
        out["moe" + cf + ":aux"] = np.asarray(aux)
        out["moe" + cf + ":idx"] = np.asarray(idx)
    cfg5 = get_config("gemma3-1b", smoke=True)
    cfg5 = cfg5.__class__(**{**cfg5.__dict__, "embed_gather": "shard_map"})
    from jax.sharding import PartitionSpec as P
    with jax.set_mesh(mesh):
        tab = jax.device_put(jnp.asarray(inp["embed:table"]),
                             NamedSharding(mesh, P("model", None)))
        e = T.embed_tokens(cfg5, {"embed": tab},
                           jnp.asarray(inp["embed:tokens"]), dist)
    out["embed"] = np.asarray(e.astype(jnp.float32))
    for arch in sys.argv[4:]:
        cfg = get_config(arch, smoke=True)
        params = init_from_defs(T.defs(cfg), jax.random.PRNGKey(0))
        for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
            out[arch + ":param:" + "/".join(k.key for k in path)] = \\
                np.asarray(leaf)
        specs = pspecs_from_defs(T.defs(cfg), dist.rules, mesh)
        prompts = jnp.asarray(inp["prompts"], jnp.int32)
        forced = jnp.asarray(inp["forced"], jnp.int32)
        P0 = prompts.shape[1]
        with jax.set_mesh(mesh):
            sp = jax.tree.map(
                lambda a, s: jax.device_put(a, NamedSharding(mesh, s)),
                params, specs)
            lg, cache = jax.jit(lambda p, t: T.prefill(
                cfg, p, t, dist=dist, max_len=P0 + forced.shape[1]))(
                sp, prompts)
            out[arch + ":logits:0"] = np.asarray(lg.astype(jnp.float32))
            step = jax.jit(lambda p, c, t, pos: T.decode_step(
                cfg, p, c, t, pos, dist=dist))
            for i in range(forced.shape[1]):
                lg, cache = step(sp, cache, forced[:, i:i + 1],
                                 jnp.int32(P0 + i))
                out[arch + ":logits:" + str(i + 1)] = np.asarray(
                    lg.astype(jnp.float32))
            out[arch + ":cache_k"] = np.asarray(
                cache["k"].astype(jnp.float32))
    np.savez(sys.argv[3], **out)
""")


def _inputs() -> dict:
    rng = np.random.default_rng(28)
    inp = {}
    for name, (b, smax, window, at, _) in DD_CASES.items():
        inp[f"{name}:q"] = rng.standard_normal((b, 1, 8, 16), np.float32)
        inp[f"{name}:k"] = rng.standard_normal((b, smax, 2, 16), np.float32)
        inp[f"{name}:v"] = rng.standard_normal((b, smax, 2, 16), np.float32)
        idx = np.arange(smax)
        inp[f"{name}:k_pos"] = np.where(idx <= at, idx, -1).astype(np.int32)
        inp[f"{name}:q_pos"] = np.array([at], np.int32)
        inp[f"{name}:window"] = np.array(window)
    inp["moe:router"] = rng.standard_normal((32, 4), np.float32) * 0.1
    inp["moe:w_gate"] = rng.standard_normal((4, 32, 64), np.float32) * 0.1
    inp["moe:w_up"] = rng.standard_normal((4, 32, 64), np.float32) * 0.1
    inp["moe:w_down"] = rng.standard_normal((4, 64, 32), np.float32) * 0.1
    inp["moe:x"] = rng.standard_normal((4, 16, 32), np.float32)
    cfg = get_config("gemma3-1b", smoke=True)
    inp["embed:table"] = rng.standard_normal((cfg.padded_vocab, cfg.d_model),
                                             np.float32)
    inp["embed:tokens"] = rng.integers(0, cfg.vocab_size, (4, 8),
                                       dtype=np.int32)
    inp["prompts"] = rng.integers(0, 512, (B, PROMPT), dtype=np.int32)
    inp["forced"] = rng.integers(0, 512, (B, NEW), dtype=np.int32)
    return inp


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The inputs and the reference's mesh outputs (one subprocess)."""
    inp = _inputs()
    tmp = tmp_path_factory.mktemp("lm_mesh")
    np.savez(tmp / "in.npz", **inp)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    r = subprocess.run([sys.executable, "-c", _REFERENCE, str(ROOT / "src"),
                        str(tmp / "in.npz"), str(tmp / "out.npz"),
                        *SERVE_ARCHS], env=env, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    return inp, dict(np.load(tmp / "out.npz"))


def _dist(shape=(2, 2), **rules) -> Distribution:
    mesh = make_debug_mesh(shape, devices="cpu")
    return Distribution(mesh, {**default_rules(mesh), **rules})


def _params(out: dict, arch: str) -> dict:
    tree = {}
    prefix = f"{arch}:param:"
    for key, val in out.items():
        if key.startswith(prefix):
            node = tree
            *path, leaf = key[len(prefix):].split("/")
            for k in path:
                node = node.setdefault(k, {})
            node[leaf] = val
    return tree


def _close(got, want, atol, rtol) -> float:
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)
    return float(np.abs(got - want).max())


# --------------------------------------------------- dist_decode_attention --

@pytest.mark.parametrize("name", sorted(DD_CASES))
def test_dist_decode_attention_matches_the_reference(reference, name):
    """Each position's partial (m, l, u) over its cache slice, combined by
    ``pmax`` and ``psum``: within the reference's own rtol and atol 2e-4
    (f32) of its ``shard_map`` and of the port's ``decode_attention``; the
    cache is never gathered (one ``pmax`` and two ``psum``s, no
    all-gather), and over ("data", "model") the long-context layout splits
    it four ways."""
    inp, out = reference
    b, smax, window, at, layout = DD_CASES[name]
    dist = _dist(**({"kv_seq": ("data", "model")} if layout == "wide"
                    else {}))
    t = {x: torch.from_numpy(inp[f"{name}:{x}"])
         for x in ("q", "k", "v", "q_pos", "k_pos")}
    q = dist.constrain(t["q"], "batch", None, None, None)
    k = dist.constrain(t["k"], "batch", "kv_seq", None, None)
    v = dist.constrain(t["v"], "batch", "kv_seq", None, None)
    assert k.local_shape[1] == smax // (4 if layout == "wide" else 2)
    dist.log.clear()
    o = layers.dist_decode_attention(q, k, v, t["q_pos"].long(),
                                     t["k_pos"].long(), dist=dist,
                                     window=window)
    kinds = [c[0] for c in dist.log.calls]
    assert kinds == ["all-reduce"] * 3
    got = dist.full(o)
    _close(got, out[name], **DD_TOL)
    plain = layers.decode_attention(t["q"], t["k"], t["v"], t["q_pos"].long(),
                                    t["k_pos"].long(), window=window)
    _close(got, plain.numpy(), **DD_TOL)


def test_dist_decode_attention_without_a_split_axis_runs_locally():
    """A cache length no mesh axis divides (the reference drops such axes)
    or a 1 x 1 mesh: every position runs ``decode_attention`` on its
    cache, bit for bit, with no collective."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((2, 1, 4, 16), np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 9, 1, 16), np.float32))
    v = torch.from_numpy(rng.standard_normal((2, 9, 1, 16), np.float32))
    kp, qp = torch.arange(9), torch.tensor([8])
    want = layers.decode_attention(q, k, v, qp, kp)
    for shape in ((2, 2), (1, 1)):
        dist = _dist(shape)
        sq = dist.constrain(q, "batch", None, None, None)
        sk = dist.constrain(k, "batch", "kv_seq", None, None)
        sv = dist.constrain(v, "batch", "kv_seq", None, None)
        o = layers.dist_decode_attention(sq, sk, sv, qp, kp, dist=dist)
        assert torch.equal(dist.full(o), want)
        assert not dist.log.calls
    assert torch.equal(layers.dist_decode_attention(q, k, v, qp, kp,
                                                    dist=None), want)


# ------------------------------------------------------------------- MoE --

def _moe_port(inp, cf, dist):
    cfg = ModelConfig(**MOE_CFG, capacity_factor=cf)
    p = {k: torch.from_numpy(inp[f"moe:{k}"])
         for k in ("router", "w_gate", "w_up", "w_down")}
    sp = shard_params(p, moe.moe_defs(cfg), dist)
    x = dist.constrain(torch.from_numpy(inp["moe:x"]), "batch", "seq", None)
    return cfg, p, sp, x


def _reference_keep(idx: np.ndarray, cap: int, E: int) -> np.ndarray:
    """The reference's shard_map body's kept (token, k) pairs over one
    position's block of routed ids (token-major exclusive ranks)."""
    T = idx.shape[0] * idx.shape[1]
    flat = np.eye(E, dtype=np.int64)[idx.reshape(T, -1)].reshape(-1, E)
    pos = (np.cumsum(flat, axis=0) - flat) * flat
    return pos.sum(-1).reshape(T, -1) < cap


@pytest.mark.parametrize("cf", [8.0, 0.5])
def test_expert_parallel_moe_matches_the_reference(reference, cf):
    """The ``all_to_all`` dispatch over the expert axis: the same routing,
    each position's kept (token, k) pairs equal to the reference body's
    (capacity ceil8(int(cf * T_loc * k / E) + 1) over its 16 tokens: no
    drop at 8.0, drops at 0.5), outputs within ``MOE_TOL`` (f32) and the
    aux loss of all the tokens within 1e-6; two ``all_to_all``s and no
    expert weight gathered.  With room for every token (8.0) the output is
    the single-device path's within the same tolerance."""
    inp, out = reference
    dist = _dist()
    cfg, p, sp, x = _moe_port(inp, cf, dist)
    dist.log.clear()
    o, aux = moe.moe_block(cfg, sp, x, dist=dist, mode="prefill")
    assert [c[0] for c in dist.log.calls if c[0] != "all-reduce"] == \
        ["all-to-all"] * 2
    got = dist.full(o)
    err = _close(got, out[f"moe{cf}:out"], **MOE_TOL)
    for i in dist.mesh.positions():
        assert float(aux.local(i)) == pytest.approx(
            float(out[f"moe{cf}:aux"]), abs=1e-6)
    # routing and the kept pairs, position by position
    idx = dist.map(lambda pi, xi: moe._route(cfg, pi, xi)[0], sp, x)
    T_loc = x.local_shape[0] * x.local_shape[1]
    cap = -(-(int(cf * T_loc * 2 / 4) + 1) // 8) * 8
    dropped = 0
    for i in dist.mesh.positions():
        rows = dist.block_start(x, 0, i), dist.block_start(x, 1, i)
        ref_idx = out[f"moe{cf}:idx"][rows[0]:rows[0] + x.local_shape[0],
                                      rows[1]:rows[1] + x.local_shape[1]]
        assert np.array_equal(idx.local(i).numpy(), ref_idx)
        _, keep, _ = moe._dispatch(idx.local(i).reshape(T_loc, -1), 4, cap)
        want = _reference_keep(ref_idx, cap, 4)
        assert np.array_equal(keep.numpy(), want)
        dropped += int((~want).sum())
    assert (dropped == 0) == (cf == 8.0)
    if cf == 8.0:
        local, _ = moe.moe_block(cfg, p, torch.from_numpy(inp["moe:x"]),
                                 mode="prefill")
        _close(got, local.numpy(), **MOE_TOL)
    assert err < MOE_TOL["atol"]


def test_moe_decode_combines_local_experts_with_a_psum():
    """Decode keeps dense dispatch: each position's experts, their
    weighted outputs summed over the expert axis; within ``MOE_TOL`` of the
    single-device dense dispatch."""
    rng = np.random.default_rng(5)
    dist = _dist((1, 4))
    cfg = ModelConfig(**MOE_CFG, capacity_factor=1.25)
    p = {"router": rng.standard_normal((32, 4), np.float32) * 0.3,
         "w_gate": rng.standard_normal((4, 32, 64), np.float32) * 0.1,
         "w_up": rng.standard_normal((4, 32, 64), np.float32) * 0.1,
         "w_down": rng.standard_normal((4, 64, 32), np.float32) * 0.1}
    p = {k: torch.from_numpy(v) for k, v in p.items()}
    x = torch.from_numpy(rng.standard_normal((3, 1, 32), np.float32))
    want, aux = moe.moe_block(cfg, p, x, mode="decode")
    sx = dist.constrain(x, "batch", None, None)
    got, saux = moe.moe_block(cfg, shard_params(p, moe.moe_defs(cfg), dist),
                              sx, dist=dist, mode="decode")
    _close(dist.full(got), want.numpy(), **MOE_TOL)
    assert float(saux.local(0)) == pytest.approx(float(aux), abs=1e-6)
    assert [c[0] for c in dist.log.calls] == ["all-reduce"]


# ----------------------------------------------------------------- embed --

def test_sharded_embed_lookup_is_bitwise(reference):
    """Each position looks up the vocab rows it holds (zeros elsewhere) and
    a ``psum`` over "model" adds them: bit for bit the reference's
    ``shard_map`` lookup and the port's plain lookup."""
    inp, out = reference
    dist = _dist()
    cfg = get_config("gemma3-1b", smoke=True)
    table = torch.from_numpy(inp["embed:table"])
    toks = torch.from_numpy(inp["embed:tokens"])
    sp = shard_params({"embed": table}, {"embed": transformer.defs(cfg)[
        "embed"]}, dist)
    dist.log.clear()
    x = transformer.embed_tokens(cfg, sp, toks, dist=dist)
    assert [c[:2] for c in dist.log.calls] == [("all-reduce", ("model",))]
    got = dist.full(x)
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.float().numpy(), out["embed"])
    assert torch.equal(got, transformer.embed_tokens(cfg, {"embed": table},
                                                     toks))


# --------------------------------------------------- prefill and decode --

def _serve(cfg, params, prompts, forced, dist=None):
    """Prefill logits, then the teacher-forced decode steps' (global)."""
    full = (lambda t: dist.full(t)) if dist is not None else (lambda t: t)
    with torch.no_grad():
        lg, cache = transformer.prefill(cfg, params, prompts,
                                        max_len=PROMPT + NEW, dist=dist)
        steps = [full(lg)]
        for i in range(NEW):
            lg, cache = transformer.decode_step(
                cfg, params, cache, forced[:, i:i + 1], PROMPT + i,
                dist=dist)
            steps.append(full(lg))
    return steps, cache


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_mesh_serving_matches_the_reference(reference, arch):
    """gemma3 (dense, windowed, tied) and phi3.5-moe smoke configs on the
    2 x 2 mesh: prefill's last logits and 4 teacher-forced decode steps
    within the LM tolerance of the reference's under ``jax.set_mesh`` (the
    MoE's expert-parallel drops included: the same routing and capacity
    per position), the logits vocab-sharded and the caches (L, B/2,
    max_len/2, Hkv, Dh) per position, zero past the prompt."""
    inp, out = reference
    cfg = get_config(arch, smoke=True)
    dist = _dist()
    params = params_on_mesh(_params(out, arch), transformer.defs(cfg), dist,
                            "cpu")
    prompts = torch.from_numpy(inp["prompts"]).long()
    forced = torch.from_numpy(inp["forced"]).long()
    steps, cache = _serve(cfg, params, prompts, forced, dist)
    for i, lg in enumerate(steps):
        _close(lg, out[f"{arch}:logits:{i}"], LOGIT_ATOL, LOGIT_RTOL)
    k = cache["k"]
    assert k.spec == ((), ("data",), ("model",), (), ())
    assert k.local_shape == (cfg.n_layers, B // 2, (PROMPT + NEW) // 2,
                             cfg.n_kv_heads, cfg.resolved_head_dim)
    _close(dist.full(k), out[f"{arch}:cache_k"], LOGIT_ATOL, LOGIT_RTOL)


@pytest.mark.parametrize("arch", ["gemma3-1b", "chameleon-34b",
                                  "phi3.5-moe-42b-a6.6b"])
def test_mesh_serving_matches_the_meshless_path(arch):
    """The same weights on the 2 x 2 mesh and without one: logits within
    the LM tolerance at every step (the MoE at capacity factor 8, where
    neither path drops a token: at the smoke's 1.25 each position's own
    queues drop other tokens than the single device's)."""
    cfg = get_config(arch, smoke=True)
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=8.0)
    defs = transformer.defs(cfg)
    params = init_from_defs(defs, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(1)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, PROMPT)))
    forced = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, NEW)))
    want, cache = _serve(cfg, params, prompts, forced)
    dist = _dist()
    got, mcache = _serve(cfg, shard_params(params, defs, dist), prompts,
                         forced, dist)
    for a, b in zip(got, want):
        _close(a, b.float().numpy(), LOGIT_ATOL, LOGIT_RTOL)
    _close(dist.full(mcache["v"]), cache["v"].float().numpy(), LOGIT_ATOL,
           LOGIT_RTOL)


@pytest.mark.parametrize("arch", ["gemma3-1b", "phi3.5-moe-42b-a6.6b"])
def test_one_by_one_mesh_is_bitwise_the_meshless_path(arch):
    """On a 1 x 1 mesh every value is local and no collective runs:
    prefill, decode and ``generate`` give the meshless bits."""
    cfg = get_config(arch, smoke=True)
    defs = transformer.defs(cfg)
    params = init_from_defs(defs, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(2)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, PROMPT)))
    forced = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, NEW)))
    want, cache = _serve(cfg, params, prompts, forced)
    dist = _dist((1, 1))
    got, mcache = _serve(cfg, shard_params(params, defs, dist), prompts,
                         forced, dist)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert torch.equal(dist.full(mcache["k"]), cache["k"])
    assert not dist.log.calls
    g0 = generate(cfg, params, prompts, 3, device="cpu")
    g1 = generate(cfg, shard_params(params, defs, dist), prompts, 3,
                  dist=dist)
    assert torch.equal(g0.tokens, g1.tokens)
    assert torch.equal(g0.logits, g1.logits)


def test_generate_on_a_mesh_gathers_the_logits_before_the_argmax():
    """Greedy decode over the mesh: the vocab-sharded logits are gathered
    whole (one all-gather over "model" each step, apart from the
    parameters' gathers, which the log marks) before the argmax; the
    tokens are the argmax of the returned logits."""
    cfg = get_config("gemma3-1b", smoke=True)
    defs = transformer.defs(cfg)
    params = init_from_defs(defs, torch.Generator().manual_seed(0), "cpu")
    prompts = np.random.default_rng(4).integers(0, cfg.vocab_size, (B, 8))
    dist = _dist()
    g = generate(cfg, shard_params(params, defs, dist), prompts, 3,
                 dist=dist)
    assert g.tokens.shape == (B, 3) and g.logits.shape == (B, 3,
                                                           cfg.vocab_size)
    assert torch.equal(g.tokens, g.logits.argmax(-1))
    gathers = [c for n, c in enumerate(dist.log.calls)
               if c[0] == "all-gather" and n not in dist.log.params
               and c[2] == (B // 2) * cfg.padded_vocab * 2]
    assert len(gathers) == 3


# ------------------------------------------------------ offset attention --

@pytest.mark.parametrize("q_offset,kv_offset,window", [
    (12, 0, 0), (12, 0, 8), (37, 5, 16), (0, 6, 0), (24, 24, 8)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_offset_flash_plain_matches_the_reference(q_offset, kv_offset,
                                                  window, dtype):
    """Query i at q_offset + i, key j at kv_offset + j: the plain version
    (and the wrapper on CPU tensors) against the reference's
    ``layers.flash_attention(q_offset=, kv_offset=)``, within the LM-path
    tolerance of ``tests/test_torch_lm_kernels.py`` (f32 1e-5, bf16 one
    step); rows that see no key are undefined in both and left out."""
    rng = np.random.default_rng(q_offset + kv_offset + window)
    q = torch.from_numpy(rng.standard_normal((2, 12, 4, 16), np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 40, 2, 16), np.float32))
    v = torch.from_numpy(rng.standard_normal((2, 40, 2, 16), np.float32))
    q, k, v = (t.to(dtype) for t in (q, k, v))
    kw = dict(causal=True, window=window, q_offset=q_offset,
              kv_offset=kv_offset)
    got = tref.flash_attention(q, k, v, block_kv=16, **kw)
    assert torch.equal(fa.flash_attention(q, k, v, block_kv=16, **kw), got)

    def j(t):
        if t.dtype == torch.bfloat16:
            return jnp.asarray(t.view(torch.int16).numpy().view(jnp.bfloat16))
        return jnp.asarray(t.numpy())
    want = np.asarray(jlayers.flash_attention(
        j(q), j(k), j(v), block_kv=16, **kw).astype(jnp.float32))
    pos = q_offset - kv_offset + np.arange(12)
    sees = pos >= 0
    tol = (dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32
           else dict(rtol=1e-2, atol=1e-2))
    _close(got[:, sees], want[:, sees], **tol)
    zero = tref.flash_attention(q, k, v, block_kv=16, causal=True,
                                window=window)
    assert torch.equal(tref.flash_attention(q, k, v, block_kv=16,
                                            causal=True, window=window,
                                            q_offset=0, kv_offset=0), zero)


def test_offset_counts_the_visible_pairs():
    """The counter's work at an offset: ``visible_pairs`` against a brute
    count, and 0 offsets keep the closed form's count."""
    for Sq, Sk, shift, causal, window in ((12, 40, 12, True, 0),
                                          (12, 40, 12, True, 8),
                                          (5, 9, -3, True, 0),
                                          (7, 7, 0, True, 3),
                                          (6, 10, 2, False, 4)):
        i = np.arange(Sq)[:, None] + shift
        jj = np.arange(Sk)[None, :]
        m = np.ones((Sq, Sk), bool)
        if causal:
            m &= jj <= i
        if window > 0:
            m &= i - jj < window
        assert fa.visible_pairs(Sq, Sk, shift, causal, window) == m.sum()
    q = torch.empty(1, 64, 4, 16, device="meta")
    assert fa.flash_work(q, q, 8) == fa.flash_work(q, q, 8, shift=0)


def test_offset_under_autograd_raises_with_the_roadmap_item():
    """The offset under autograd no longer raises (it was ROADMAP queue 1,
    item 13): the gradient of a query block at its offset is the
    full-sequence gradient with the cotangent on the block's rows only
    (dq those rows; dk and dv the block's share), within f32 rounding."""
    g = torch.Generator().manual_seed(13)
    q = torch.randn(1, 16, 2, 16, generator=g, dtype=torch.float64).float()
    k = torch.randn(1, 16, 2, 16, generator=g)
    v = torch.randn(1, 16, 2, 16, generator=g)
    do = torch.randn(1, 8, 2, 16, generator=g)
    for window in (0, 5):
        leaves = [t.clone().requires_grad_() for t in (q[:, 8:], k, v)]
        out = fa.flash_attention(*leaves, q_offset=8, window=window)
        got = torch.autograd.grad(out, leaves, do)
        full = [t.clone().requires_grad_() for t in (q, k, v)]
        ref_out = fa.flash_attention(*full, window=window)
        cot = torch.zeros_like(ref_out)
        cot[:, 8:] = do
        want = torch.autograd.grad(ref_out, full, cot)
        torch.testing.assert_close(out, ref_out[:, 8:], rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(got[0], want[0][:, 8:], rtol=1e-5,
                                   atol=1e-5)
        for a, b in zip(got[1:], want[1:]):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    fa.flash_attention(*leaves, q_offset=4, kv_offset=4).sum().backward()


# --------------------------------------------------------- collective log --

def test_collective_log_matches_a_hand_count():
    """A 2-layer gemma3 smoke prefill and one decode step on the 2 x 2
    mesh, every call against a hand count.  Prefill: per layer the seven
    sharded weights gathered whole (wq, wk, wv, wo, w_gate, w_up, w_down),
    each cast to bf16 on its shard first (no autograd records: half the
    f32 bytes), k and v gathered along seq (bf16); the embedding's ``psum``
    and the last rows' gather.  Decode gathers no parameter: per layer q,
    k and v projected on each position's column blocks and all-gathered
    along their packed dim (bf16; the kv dim's one head of 16 splits
    mid-head), the decode attention's ``pmax`` and two ``psum``s, the
    output projection's and the down projection's partial sums over their
    rows (their inputs sharded on "heads" and "ff", summed in f32); the
    embedding's ``psum``.  The cache (S + 2 slots) splits over "model".
    ``parse_collectives`` sums them, an all-reduce twice on the wire; the
    log marks the prefill's weight gathers, and nothing in decode, as
    parameter moves."""
    cfg = dataclasses.replace(get_config("gemma3-1b", smoke=True),
                              n_layers=2)
    defs = transformer.defs(cfg)
    params = init_from_defs(defs, torch.Generator().manual_seed(0), "cpu")
    dist = _dist()
    sp = shard_params(params, defs, dist)
    Bl, S, D, F = B // 2, PROMPT, cfg.d_model, cfg.d_ff
    PQ = cfg.n_heads * cfg.resolved_head_dim
    PKV = cfg.n_kv_heads * cfg.resolved_head_dim
    # in the layer's key order: w_down, w_gate, w_up, wk, wo, wq, wv
    weights = [F * D * 2, D * F * 2, D * F * 2, D * PKV * 2, PQ * D * 2,
               D * PQ * 2, D * PKV * 2]
    prompts = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (B, S)))
    with torch.no_grad():
        _, cache = transformer.prefill(cfg, sp, prompts, max_len=S + 2,
                                       dist=dist)
    want = [("all-reduce", Bl * S * D * 2)]
    for _ in range(cfg.n_layers):
        want += [("all-gather", n) for n in weights]
        want += [("all-gather", Bl * S * PKV * 2)] * 2
    want += [("all-gather", Bl * 2 * D * 2)]
    assert [(c[0], c[2]) for c in dist.log.calls] == want
    assert [(c[0], c[2]) for c in dist.log.param_calls] == [
        ("all-gather", n) for n in weights] * cfg.n_layers
    summary = op_cost.parse_collectives(dist.log)
    assert summary["all-gather"]["count"] == 9 * cfg.n_layers + 1
    dist.log.clear()
    with torch.no_grad():
        transformer.decode_step(cfg, sp, cache, prompts[:, :1], S, dist=dist)
    want = [("all-reduce", Bl * D * 2)]
    G = cfg.n_heads // cfg.n_kv_heads
    for _ in range(cfg.n_layers):
        want += [("all-gather", Bl * n * 2) for n in (PQ, PKV, PKV)]
        want += [("all-reduce", Bl * cfg.n_kv_heads * G * 4),   # m
                 ("all-reduce", Bl * PQ * 4),                   # u
                 ("all-reduce", Bl * cfg.n_kv_heads * G * 4)]   # l
        want += [("all-reduce", Bl * D * 4)] * 2  # wo, w_down f32 partials
    assert [(c[0], c[2]) for c in dist.log.calls] == want
    assert not dist.log.param_calls
    summary = op_cost.parse_collectives(dist.log)
    ar = summary["all-reduce"]["bytes"]
    assert summary["all-reduce"]["count"] == 1 + 5 * cfg.n_layers
    assert summary["all-gather"]["count"] == 3 * cfg.n_layers
    assert summary["wire_bytes"] == summary["total_bytes"] + ar
    assert summary["total_bytes"] == sum(n for _, n in want)


# ---------------------------------------------------- cells and dry-run --

def test_build_cell_on_a_mesh_runs_and_matches_one_card():
    """``build_cell(mesh=)``: the prefill and decode cells of the gemma3
    smoke config on the 2 x 2 CPU mesh give the one-card cell's logits
    within the LM tolerance; the decode cell's arguments are laid out per
    position and its ``out_shardings`` are the reference's specs."""
    cfg = get_config("gemma3-1b", smoke=True)
    mesh = make_debug_mesh(devices="cpu")
    for kind in ("prefill", "decode"):
        shape = ShapeConfig("s", 16, 4, kind)
        one = specs.build_cell(cfg, shape, device="cpu")
        cell = specs.build_cell(cfg, shape, mesh, device="cpu")
        with torch.no_grad():
            want = one.fn(*one.args)[0]
            got = cell.fn(*cell.args)[0]
        dist = cell.meta["dist"]
        _close(dist.full(got), want.float().numpy(), LOGIT_ATOL,
               LOGIT_RTOL)
        assert got.pspec() == ("data", None, "model")
        if kind == "decode":
            assert cell.out_shardings[0] == ("data", None, "model")
            assert cell.out_shardings[1]["k"] == (None, "data", "model",
                                                  None, None)
            assert cell.args[1]["k"].local_shape == (cfg.n_layers, 2, 8, 1,
                                                     16)


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_one_position_stands_for_every_position(kind):
    """The dry-run accounts one position of a mesh, the busiest: on a
    2 x 2 meta mesh, each position run alone has the same bytes, peak and
    collectives, but for the decode slot's write (k and v of one token per
    layer, copied in by the one position that owns the slot: position 0 at
    slot 0), and the same flops, but for the prefill attention's visible
    pairs, which grow with the position's sequence block (the last
    position's are the most; positions of one "model" coordinate are
    equal).  ``dryrun.accounted_position`` names that busiest one."""
    cfg = dataclasses.replace(get_config("dbrx-132b", smoke=True),
                              n_layers=2)
    mesh = make_debug_mesh(devices="meta")
    shape = ShapeConfig("s", 32, 4, kind)
    counts = []
    for i in mesh.positions():
        cell = specs.build_cell(cfg, shape, mesh.run_only(i))
        summary, mem, _ = dryrun.account(cell)
        colls = op_cost.parse_collectives(cell.meta["dist"].log)
        counts.append((summary["flops"], summary["bytes"], mem, colls))
    write = 2 * cfg.n_layers * 2 * (2 * cfg.n_kv_heads
                                    * cfg.resolved_head_dim * 2)
    busiest = dryrun.accounted_position(mesh, kind)
    assert busiest == (3 if kind == "prefill" else 0)
    for i, c in enumerate(counts):
        assert c[2:] == counts[0][2:]
        owns = kind == "prefill" or mesh.coords(i)["model"] == 0
        assert counts[0][1] - c[1] == (0 if owns else write)
        same = [j for j in mesh.positions()
                if mesh.coords(j)["model"] == mesh.coords(i)["model"]]
        assert all(counts[j][0] == c[0] for j in same)
        assert c[0] <= counts[busiest][0] and c[1] <= counts[busiest][1]
        if kind == "decode":
            assert c[0] == counts[0][0]
    assert kind == "decode" or counts[3][0] > counts[0][0]


def test_dryrun_mesh_multi_records_a_tiny_cell(tmp_path, monkeypatch):
    """``--mesh multi``: a 2-layer gemma3-1b decode cell at full width on
    the 2 x 16 x 16 production mesh (every position on meta, one standing
    for all): the reference's keys, each position's memory, collectives
    with their wire bytes and ``collective_s``; the SSM and hybrid
    families' cells run there too (2 layers at full width), and the CLI
    writes an ``ok`` record for one (train cells run:
    ``tests/test_torch_lm_mesh_train.py``)."""
    rec = dryrun.run_cell("gemma3-1b", "decode_32k", "multi",
                          shape=ShapeConfig("decode_32k", 512, 32, "decode"),
                          overrides={"n_layers": 2})
    assert rec["status"] == "ok" and rec["n_chips"] == 512
    assert rec["mesh_shape"] == {"pod": 2, "data": 16, "model": 16}
    assert rec["positions_accounted"]["position"] == 0
    assert "busiest" in rec["positions_accounted"]["why"]
    colls = rec["collectives"]
    assert colls["all-gather"]["count"] == 3 * 2  # q, k, v: no weight
    assert colls["all-reduce"]["count"] == 1 + 5 * 2
    assert colls["wire_bytes"] == colls["total_bytes"] + \
        colls["all-reduce"]["bytes"]
    assert rec["roofline"]["collective_s"] == pytest.approx(
        colls["wire_bytes"] / dryrun.LINK_BYTES_PER_S)
    mem = rec["memory"]
    assert mem["peak_bytes"] == mem["argument_bytes"] + mem["output_bytes"] \
        + mem["temp_bytes"] - mem["alias_bytes"]
    # the position's cache: (2, 32/32, 512/16, 1, 256) bf16 for k and v
    cache = 2 * 2 * 1 * (512 // 16) * 1 * 256 * 2
    assert mem["argument_bytes"] >= cache
    for arch, shape in (("mamba2-780m", ShapeConfig("train_4k", 512, 32,
                                                    "train")),
                        ("mamba2-780m", ShapeConfig("decode_32k", 512, 32,
                                                    "decode"))):
        rec = dryrun.run_cell(arch, shape.name, "multi", shape=shape,
                              overrides={"n_layers": 2})
        assert rec["status"] == "ok" and rec["n_chips"] == 512
        assert rec["collectives"]["all-gather"]["count"] > 0
    monkeypatch.setattr(dryrun, "RESULTS_DIR", tmp_path)
    dryrun.main(["--arch", "zamba2-1.2b", "--shape", "long_500k",
                 "--mesh", "multi"])
    rec = json.loads(next(tmp_path.iterdir()).read_text())
    assert rec["status"] == "ok" and rec["arch"] == "zamba2-1.2b"


def test_training_and_other_families_raise_on_a_mesh():
    """The SSM, hybrid and encoder-decoder families now build and run
    their serving cells on a mesh (``build_cell(mesh=)``: the prefill and
    a decode step of mamba2-smoke on the 2 x 2 CPU mesh, vocab-sharded
    logits, the state laid out by ``state_defs``: ``h`` over "ssm_heads"
    in f32); what still raises is a mesh that is not an ``LMMesh``
    (training the families on a mesh: ``tests/test_torch_lm_mesh_train.py``
    and ``tests/test_torch_lm_mesh_families.py``)."""
    dist = _dist()
    cfg = get_config("gemma3-1b", smoke=True)
    scfg = get_config("mamba2-780m", smoke=True)
    tokens = torch.zeros(2, 8, dtype=torch.long)
    params = init_from_defs(ssm_lm.defs(scfg), torch.Generator().manual_seed(
        0), "cpu")
    sp = shard_params(params, ssm_lm.defs(scfg), dist)
    logits, state = ssm_lm.prefill(scfg, sp, tokens, dist=dist)
    assert logits.shape == (2, 1, scfg.padded_vocab)
    assert logits.spec == (("data",), (), ("model",))
    assert state["h"].dtype == torch.float32
    assert state["h"].spec == ((), ("data",), ("model",), (), ())
    cell = specs.build_cell(scfg, ShapeConfig("p", 16, 2, "decode"),
                            dist.mesh, device="cpu")
    logits, state = cell.fn(*cell.args)
    assert bool(torch.isfinite(dist.full(logits)).all())
    assert cell.out_shardings[1]["h"] == (None, "data", "model", None, None)
    with pytest.raises(TypeError, match="LMMesh"):
        specs.build_cell(cfg, ShapeConfig("p", 8, 2, "prefill"), object())
    assert transformer.prefill(cfg, init_from_defs(
        transformer.defs(cfg), torch.Generator().manual_seed(0), "cpu"),
        tokens, dist=Distribution.single_device())[0].shape == (
        2, 1, cfg.padded_vocab)
