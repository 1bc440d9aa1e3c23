"""The port's mixture-of-experts LM (``models/moe.py`` inside
``models/transformer.py``) against the reference package's, on the two MoE
smoke configs (phi3.5-moe: 4 experts, top-2; dbrx: 4 experts, top-4).

In f32 the routing (top-k ids, ties to the lower expert) is bitwise the
reference's and the dispatch ranks, ``keep`` and slots are those of a plain
token-major count; the weights and the aux loss agree within 1e-6 and the
block outputs within 1e-5, also with a capacity the batch overflows (tokens
dropped).  In bf16 (the serving dtype) the block, ``loss_fn`` with its
``0.01 * aux`` term, ``prefill`` and 4 teacher-forced decode steps agree
with the reference within the dense LM tolerance of
``tests/test_torch_lm.py`` (XLA computes fused bf16 chains in f32, torch
rounds each op).  Against the reference run op by op every layer routes
every token as the port does; compiled, its fused router logits send a
near-tie token elsewhere, so there the flips are counted and the rows
routed the same way are compared.  The dense configs compute what they
computed before the MoE layers were added, bit for bit.
"""
import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import get_module as jget_module
from repro.models import moe as jmoe
from repro.models.params import init_from_defs as jinit_from_defs
from repro.models.sharding import Distribution
from repro_torch import configs as tconfigs
from repro_torch.launch import serve_lm
from repro_torch.launch.train import make_batch
from repro_torch.models import attention as attn
from repro_torch.models import get_module, moe, transformer
from repro_torch.models.convert import params_from_jax
from repro_torch.models.layers import rms_norm, swiglu_mlp

MOE = ("phi3.5-moe-42b-a6.6b", "dbrx-132b")
DENSE = ("stablelm-3b", "minitron-4b", "gemma3-1b", "qwen2.5-14b")
DIST = Distribution.single_device()
B, PROMPT, NEW, FORCED = 4, 24, 5, 4
LOGIT_ATOL, LOGIT_RTOL = 6e-2, 3e-2  # tests/test_torch_lm.py's


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _to_jax(t: torch.Tensor):
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.view(torch.int16).numpy().view(jnp.bfloat16))
    return jnp.asarray(t.numpy())


def _cfg(arch, **kw):
    return (dataclasses.replace(tconfigs.get_config(arch, smoke=True), **kw),
            dataclasses.replace(jconfigs.get_config(arch, smoke=True), **kw))


def _layer_params(arch, seed: int = 0):
    """One layer's router and experts (f32), drawn with numpy; the router
    scaled up so the routing is decided by clear margins."""
    cfg, _ = _cfg(arch)
    rng = np.random.default_rng(seed)
    E, D, Fd = cfg.n_experts, cfg.d_model, cfg.d_ff
    p = {"router": rng.standard_normal((D, E)) * 0.3,
         "w_gate": rng.standard_normal((E, D, Fd)) / np.sqrt(D),
         "w_up": rng.standard_normal((E, D, Fd)) / np.sqrt(D),
         "w_down": rng.standard_normal((E, Fd, D)) / np.sqrt(Fd)}
    return {k: v.astype(np.float32) for k, v in p.items()}


def _x(arch, shape=(3, 16), seed: int = 1, dtype=torch.float32):
    cfg, _ = _cfg(arch)
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(
        shape + (cfg.d_model,)).astype(np.float32)).to(dtype)


def _dispatch_oracle(idx: np.ndarray, E: int, capacity: int):
    """Token-major ranks by a plain count: each (token, k) in order takes
    the next place of its expert's queue."""
    T, K = idx.shape
    seen = np.zeros(E, np.int64)
    pos = np.zeros((T, K), np.int64)
    for t in range(T):
        for k in range(K):
            pos[t, k] = seen[idx[t, k]]
            seen[idx[t, k]] += 1
    keep = pos < capacity
    slot = np.where(keep, idx * capacity + pos, E * capacity)
    return pos, keep, slot


# ---------------------------------------------------------------- routing --

@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("arch", MOE)
def test_route_is_the_references_in_f32(arch, seed):
    cfg, jcfg = _cfg(arch)
    p = _layer_params(arch)
    x = _x(arch, seed=seed)
    idx, w, aux = moe._route(cfg, {k: torch.from_numpy(v)
                                   for k, v in p.items()}, x)
    jidx, jw, jaux = jmoe._route(jcfg, {k: jnp.asarray(v)
                                        for k, v in p.items()}, _to_jax(x))
    assert idx.shape == (3, 16, cfg.top_k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=1e-6)
    np.testing.assert_allclose(w.sum(-1).numpy(), 1.0, rtol=1e-6)


def test_route_breaks_ties_toward_the_lower_expert():
    """Equal router logits: ``jax.lax.top_k`` takes the lower index first,
    and so does the port."""
    cfg, jcfg = _cfg("phi3.5-moe-42b-a6.6b")
    D, E = cfg.d_model, cfg.n_experts
    router = np.zeros((D, E), np.float32)
    router[0] = [1.0, 2.0, 2.0, 2.0]  # experts 1, 2, 3 tie above 0
    x = torch.zeros((1, 2, D))
    x[:, :, 0] = 1.0
    idx, w, _ = moe._route(cfg, {"router": torch.from_numpy(router)}, x)
    jidx, _, _ = jmoe._route(jcfg, {"router": jnp.asarray(router)},
                             _to_jax(x))
    assert idx.tolist() == [[[1, 2], [1, 2]]]
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(w.numpy(), 0.5)


@pytest.mark.parametrize("capacity", [3, 9, 100])
@pytest.mark.parametrize("arch", MOE)
def test_dispatch_ranks_keep_and_slots(arch, capacity):
    cfg, _ = _cfg(arch)
    p = {k: torch.from_numpy(v) for k, v in _layer_params(arch).items()}
    idx, _, _ = moe._route(cfg, p, _x(arch))
    idx = idx.reshape(-1, cfg.top_k)
    pos, keep, slot = moe._dispatch(idx, cfg.n_experts, capacity)
    want = _dispatch_oracle(idx.numpy(), cfg.n_experts, capacity)
    for got, w in zip((pos, keep, slot), want):
        np.testing.assert_array_equal(got.numpy(), w)
    if capacity == 3:
        assert (~keep).any()  # the batch overflows: tokens are dropped


# ------------------------------------------------------------------ block --

@pytest.mark.parametrize("mode", ["prefill", "decode", "overflow"])
@pytest.mark.parametrize("arch", MOE)
def test_moe_block_matches_reference_in_f32(arch, mode):
    """prefill: the capacity path at the config's factor; overflow: a
    capacity factor of 0.3, so tokens are dropped; decode: the dense
    dispatch over one token per sequence."""
    kw = {"capacity_factor": 0.3} if mode == "overflow" else {}
    cfg, jcfg = _cfg(arch, **kw)
    p = _layer_params(arch)
    x = _x(arch, shape=(4, 1) if mode == "decode" else (3, 16))
    m = "decode" if mode == "decode" else "prefill"
    out, aux = moe.moe_block(cfg, {k: torch.from_numpy(v)
                                   for k, v in p.items()}, x, mode=m)
    jout, jaux = jmoe.moe_block(jcfg, {k: jnp.asarray(v)
                                       for k, v in p.items()}, _to_jax(x),
                                dist=DIST, mode=m)
    assert out.dtype == torch.float32 and out.shape == x.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=1e-6)
    if mode == "overflow":
        T = x.shape[0] * x.shape[1]
        cap = moe.capacity(cfg, T)
        assert cap == int(0.3 * T * cfg.top_k / cfg.n_experts) + 1
        idx, _, _ = moe._route(cfg, {"router": torch.from_numpy(
            p["router"])}, x)
        assert not moe._dispatch(idx.reshape(T, -1), cfg.n_experts,
                                 cap)[1].all()


@pytest.mark.parametrize("mode", ["prefill", "decode"])
@pytest.mark.parametrize("arch", MOE)
def test_moe_block_matches_reference_in_bf16(arch, mode):
    cfg, jcfg = _cfg(arch)
    p = _layer_params(arch)
    x = _x(arch, shape=(4, 1) if mode == "decode" else (3, 16),
           dtype=torch.bfloat16)
    out, aux = moe.moe_block(cfg, {k: torch.from_numpy(v)
                                   for k, v in p.items()}, x, mode=mode)
    jout, jaux = jmoe.moe_block(jcfg, {k: jnp.asarray(v)
                                       for k, v in p.items()}, _to_jax(x),
                                dist=DIST, mode=mode)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(out), _f32(jout), rtol=3e-2, atol=3e-2)
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=1e-6)


# ---------------------------------------------------------- the whole LM --

@contextlib.contextmanager
def _routes_recorded(module, record: list, jitted: bool = False):
    """Record the top-k ids of every ``_route`` call of ``module`` (the
    reference's ``moe`` or the port's) into ``record``, in call order
    (layer by layer, prefill then each decode step).  Under ``jax.jit``
    the ids reach the host through an ordered debug callback."""
    orig = module._route

    def recording(cfg, p, x):
        out = orig(cfg, p, x)
        if jitted:
            jax.debug.callback(lambda i: record.append(np.asarray(i)),
                               out[0], ordered=True)
        elif isinstance(out[0], torch.Tensor):
            record.append(out[0].numpy())
        else:
            record.append(np.asarray(out[0]))
        return out

    module._route = recording
    try:
        yield record
    finally:
        module._route = orig


def _reference_generate(cfg, mod, params, prompts, jitted: bool):
    """The reference's serving loop (prefill, then greedy decode steps)."""
    def prefill(p, t):
        return mod.prefill(cfg, p, t, dist=DIST, max_len=PROMPT + NEW)

    def step(p, c, t, pos):
        return mod.decode_step(cfg, p, c, t, pos, dist=DIST)

    if jitted:
        prefill, step = jax.jit(prefill), jax.jit(step)
    V = cfg.vocab_size
    logits, cache = prefill(params, jnp.asarray(prompts))
    tok = jnp.argmax(logits[:, -1:, :V], -1).astype(jnp.int32)
    toks, outs, c = [tok], [logits[:, -1:, :V]], cache
    for i in range(NEW - 1):
        lg, c = step(params, c, tok, jnp.int32(PROMPT + i))
        tok = jnp.argmax(lg[:, :, :V], -1).astype(jnp.int32)
        toks.append(tok)
        outs.append(lg[:, :, :V])
    jax.effects_barrier()
    return logits, cache, toks, outs


@functools.lru_cache(maxsize=None)
def _reference_run(arch: str, jitted: bool = True):
    """The reference's smoke config: initial params, a prefill of B x
    PROMPT, greedy decode of NEW tokens with every step's logits and every
    layer's routing, and the loss of ``launch.train.make_batch``'s first
    batch.  ``jitted=False`` runs it op by op (``jax.disable_jit``)."""
    cfg = jconfigs.get_config(arch, smoke=True)
    mod = jget_module(cfg)
    params = jinit_from_defs(mod.defs(cfg), jax.random.PRNGKey(0))
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                                (B, PROMPT)).astype(np.int32)
    with _routes_recorded(jmoe, [], jitted) as routes, \
            (contextlib.nullcontext() if jitted else jax.disable_jit()):
        logits, cache, toks, outs = _reference_generate(cfg, mod, params,
                                                        prompts, jitted)
    batch = make_batch(tconfigs.get_config(arch, smoke=True), 2, 32, 0, 0,
                       device="cpu")
    loss, metrics = jax.jit(lambda p, b: mod.loss_fn(cfg, p, b, dist=DIST))(
        params, {k: jnp.asarray(v.numpy()) for k, v in batch.items()})
    return {"params": jax.tree_util.tree_map(np.asarray, params),
            "prompts": prompts, "prefill_logits": _f32(logits),
            "cache": {k: _f32(v) for k, v in cache.items()},
            "tokens": np.asarray(jnp.concatenate(toks, 1)),
            "logits": _f32(jnp.concatenate(outs, 1)), "routes": routes,
            "batch": batch, "loss": float(loss), "ce": float(metrics["ce"]),
            "aux": float(metrics["aux"])}


def _experts(idx: np.ndarray, E: int, capacity: int = None) -> np.ndarray:
    """(tokens, E) membership: which experts each token of ``idx`` (..., K)
    went to, or with ``capacity``, which kept it (the order of a token's K
    ids does not matter: each weight travels with its expert)."""
    flat = idx.reshape(-1, idx.shape[-1])
    out = np.zeros((len(flat), E), bool)
    keep = (np.ones(flat.shape, bool) if capacity is None
            else _dispatch_oracle(flat, E, capacity)[1])
    rows = np.repeat(np.arange(len(flat)), flat.shape[1])
    out[rows[keep.reshape(-1)], flat.reshape(-1)[keep.reshape(-1)]] = True
    return out.reshape(idx.shape[:-1] + (E,))


def _same_routing(cfg, mine: list, theirs: list) -> tuple:
    """Which rows were routed the same way in both runs: (rows (B,) after
    the prefill, rows (FORCED, B) after each decode step, the number of
    (layer, token) pairs sent to other experts).  A prefill row counts
    only if its tokens' experts and capacity ``keep`` agree at every layer
    (``keep`` follows every earlier token of the batch: one flip can drop
    another row's token); a decode row also needs every earlier step's
    experts at every layer."""
    L, E = cfg.n_layers, cfg.n_experts
    assert len(mine) == len(theirs) == L * (1 + FORCED)
    flips = 0
    rows = np.ones(B, bool)
    cap = moe.capacity(cfg, B * PROMPT)
    for a, b in zip(mine[:L], theirs[:L]):
        same = (_experts(a, E) == _experts(b, E)).all(-1)
        flips += int((~same).sum())
        kept = _experts(a, E, cap) == _experts(b, E, cap)
        rows &= same.all(-1) & kept.all((-1, -2))
    steps = []
    cur = rows.copy()
    for i in range(FORCED):
        steps.append(cur.copy())
        for a, b in zip(mine[L * (1 + i):L * (2 + i)],
                        theirs[L * (1 + i):L * (2 + i)]):
            same = (_experts(a, E) == _experts(b, E)).all(-1)[:, 0]
            flips += int((~same).sum())
            cur &= same
    return rows, np.array(steps), flips


def _port_prefill_and_decode(cfg, params, ref):
    """The port's prefill and FORCED decode steps fed the reference's
    tokens, with every layer's routing."""
    with _routes_recorded(moe, []) as routes:
        logits, cache = transformer.prefill(
            cfg, params, torch.from_numpy(ref["prompts"]),
            max_len=PROMPT + NEW)
        toks = torch.from_numpy(ref["tokens"].astype(np.int64))
        steps = []
        c = {k: v.clone() for k, v in cache.items()}  # decode writes in place
        for i in range(FORCED):
            lg, c = transformer.decode_step(cfg, params, c, toks[:, i:i + 1],
                                            PROMPT + i)
            steps.append(_f32(lg[:, 0, :cfg.vocab_size]))
    return logits, cache, np.stack(steps, 1), routes


@pytest.mark.parametrize("arch", MOE)
def test_defs_and_converted_params_carry_the_moe_leaves(arch):
    ref = _reference_run(arch)
    cfg = tconfigs.get_config(arch, smoke=True)
    assert get_module(cfg) is transformer
    params = params_from_jax(ref["params"], "cpu")
    layer = transformer.defs(cfg)["layers"]
    L, E, D, Fd = cfg.n_layers, cfg.n_experts, cfg.d_model, cfg.d_ff
    assert {k: layer[k].shape for k in ("router", "w_gate", "w_up",
                                        "w_down")} == {
        "router": (L, D, E), "w_gate": (L, E, D, Fd), "w_up": (L, E, D, Fd),
        "w_down": (L, E, Fd, D)}
    for k, d in layer.items():
        assert tuple(params["layers"][k].shape) == d.shape, k
        np.testing.assert_array_equal(params["layers"][k].numpy(),
                                      ref["params"]["layers"][k])


@pytest.mark.parametrize("arch", MOE)
def test_loss_fn_with_the_aux_term_matches_reference(arch):
    ref = _reference_run(arch)
    cfg = tconfigs.get_config(arch, smoke=True)
    loss, metrics = transformer.loss_fn(
        cfg, params_from_jax(ref["params"], "cpu"), ref["batch"])
    assert isinstance(metrics["aux"], torch.Tensor)
    assert metrics["aux"].item() > 0
    np.testing.assert_allclose(metrics["aux"].item(), ref["aux"], rtol=1e-2)
    np.testing.assert_allclose(metrics["ce"].item(), ref["ce"],
                               rtol=LOGIT_RTOL, atol=LOGIT_ATOL)
    np.testing.assert_allclose(loss.item(), ref["loss"], rtol=LOGIT_RTOL,
                               atol=LOGIT_ATOL)
    torch.testing.assert_close(loss, metrics["ce"] + 0.01 * metrics["aux"],
                               rtol=0, atol=0)


@pytest.mark.parametrize("arch", MOE)
def test_prefill_and_decode_match_the_op_by_op_reference(arch):
    """Against the reference run op by op (``jax.disable_jit``): every
    layer's routing is bitwise the port's, in the prefill and in 4 decode
    steps fed the reference's greedy tokens, and every logit and the KV
    cache agree within the dense LM tolerance."""
    ref = _reference_run(arch, jitted=False)
    cfg = tconfigs.get_config(arch, smoke=True)
    params = params_from_jax(ref["params"], "cpu")
    logits, cache, steps, routes = _port_prefill_and_decode(cfg, params, ref)
    rows, dec_rows, flips = _same_routing(cfg, routes, ref["routes"])
    assert flips == 0 and rows.all() and dec_rows.all()
    assert logits.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(logits), ref["prefill_logits"],
                               rtol=LOGIT_RTOL, atol=LOGIT_ATOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(_f32(cache[name]), ref["cache"][name],
                                   rtol=3e-2, atol=6e-2)
    np.testing.assert_allclose(steps, ref["logits"][:, 1:FORCED + 1],
                               rtol=LOGIT_RTOL, atol=LOGIT_ATOL)


@pytest.mark.parametrize("arch", MOE)
def test_prefill_and_decode_match_the_compiled_reference(arch):
    """Against the reference compiled with ``jax.jit``, whose fused bf16
    chains may route a near-tie token to another expert (one token of 96
    at layer 0 in the phi3.5 smoke prefill), and through the capacity
    drops change other rows: the flips are counted (at most 2 of the
    routed (layer, token) pairs), and the logits of every row routed the
    same way, most of them, agree within the dense LM tolerance."""
    ref = _reference_run(arch)
    cfg = tconfigs.get_config(arch, smoke=True)
    params = params_from_jax(ref["params"], "cpu")
    logits, _, steps, routes = _port_prefill_and_decode(cfg, params, ref)
    rows, dec_rows, flips = _same_routing(cfg, routes, ref["routes"])
    assert flips <= 2, flips
    assert rows.sum() >= B // 2 and dec_rows.sum() >= FORCED * B // 2
    np.testing.assert_allclose(_f32(logits)[rows], ref["prefill_logits"][rows],
                               rtol=LOGIT_RTOL, atol=LOGIT_ATOL)
    want = ref["logits"][:, 1:FORCED + 1]
    for i in range(FORCED):
        np.testing.assert_allclose(steps[dec_rows[i], i],
                                   want[dec_rows[i], i], rtol=LOGIT_RTOL,
                                   atol=LOGIT_ATOL)


@pytest.mark.parametrize("arch", MOE)
def test_serve_lm_runs_the_moe_smoke_config_on_the_cpu(arch, capsys):
    assert serve_lm.main(["--arch", arch, "--smoke", "--device", "cpu",
                          "--batch", "2", "--prompt", "8", "--new", "3"]) == 0
    assert "tokens/s decode" in capsys.readouterr().out


# ---------------------------------------------- the dense path, unchanged --

def _dense_forward_before_moe(cfg, params, tokens):
    """The dense forward as the port wrote it before the MoE layers: each
    layer ``x + attention`` then ``x + swiglu_mlp``, behind pre-norms."""
    x = transformer.embed_tokens(cfg, params, tokens)
    window, theta = transformer.layer_flags(cfg)
    for l in range(cfg.n_layers):
        p = {k: v[l] for k, v in params["layers"].items()}
        h = rms_norm(x, p["attn_norm"], cfg.norm_eps)
        x = x + attn.self_attention(cfg, p, h, window=window[l],
                                    theta=theta[l])
        x = x + swiglu_mlp(p, rms_norm(x, p["mlp_norm"], cfg.norm_eps))
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return transformer.unembed(cfg, params, x)


@pytest.mark.parametrize("arch", DENSE)
def test_dense_configs_compute_what_they_did_bit_for_bit(arch):
    cfg = tconfigs.get_config(arch, smoke=True)
    jcfg = jconfigs.get_config(arch, smoke=True)
    params = params_from_jax(jax.tree_util.tree_map(
        np.asarray, jinit_from_defs(jget_module(jcfg).defs(jcfg),
                                    jax.random.PRNGKey(0))), "cpu")
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 12)))
    logits, aux = transformer.forward(cfg, params, tokens)
    assert aux == 0.0 and not isinstance(aux, torch.Tensor)
    assert torch.equal(logits, _dense_forward_before_moe(cfg, params, tokens))
    batch = make_batch(cfg, 2, 12, 0, 0, device="cpu")
    loss, metrics = transformer.loss_fn(cfg, params, batch)
    assert torch.equal(loss, metrics["ce"])
    pre, _ = transformer.prefill(cfg, params, tokens)
    assert torch.equal(pre, logits[:, -1:])
    assert "router" not in transformer.defs(cfg)["layers"]
