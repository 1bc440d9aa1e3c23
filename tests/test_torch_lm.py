"""The port's dense LM serving path against the reference package's.

Configs field for field, parameter trees, the layers (``rms_norm``,
``rope``, ``swiglu_mlp``, ``decode_attention``), and for every dense smoke
config ``prefill`` (logits and KV cache), teacher-forced ``decode_step`` and
``generate`` against the reference's ``examples/serve_lm.py`` loop.  The same
numpy inputs and the reference's own initial weights (carried over with
``params_from_jax``) go into both packages; every float comparison states
its tolerance.  The flash-attention and sage kernels' plain versions are
held to the reference in ``tests/test_torch_lm_kernels.py``.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import get_module as jget_module
from repro.models import layers as jlayers
from repro.models import transformer as jtransformer
from repro.models.params import init_from_defs as jinit_from_defs
from repro.models.sharding import Distribution
from repro_torch import configs as tconfigs
from repro_torch.launch import serve_lm
from repro_torch.models import attention, get_module, layers, transformer
from repro_torch.models.convert import params_from_jax
from repro_torch.models.params import Def, init_from_defs

DENSE = ("stablelm-3b", "minitron-4b", "gemma3-1b", "qwen2.5-14b",
         "chameleon-34b")  # chameleon: the vlm family, the same network
MOE = ("phi3.5-moe-42b-a6.6b", "dbrx-132b")  # tests/test_torch_moe.py
# tests/test_torch_ssm.py and tests/test_torch_encdec.py
SSM_ENCDEC = ("mamba2-780m", "zamba2-1.2b", "seamless-m4t-large-v2")
PORTED = MOE + DENSE + SSM_ENCDEC
DIST = Distribution.single_device()
B, PROMPT, NEW, FORCED = 4, 24, 16, 8
# bf16 activations over 2-3 layers: XLA computes fused bf16 elementwise
# chains in f32 and rounds once, torch rounds after each op, so hidden
# states differ by a bf16 step or two and logits (|logit| < 4, one bf16 step
# 0.0156) by up to 0.059 over 16 decode steps (measured).
LOGIT_ATOL, LOGIT_RTOL = 6e-2, 3e-2


def _to_jax(t: torch.Tensor):
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.view(torch.int16).numpy().view(jnp.bfloat16))
    return jnp.asarray(t.numpy())


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _flatten(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], prefix + (k,))
    else:
        yield prefix, tree


# ---------------------------------------------------------------- configs --

@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", PORTED)
def test_configs_equal_field_for_field(arch, smoke):
    mine = tconfigs.get_config(arch, smoke=smoke)
    theirs = jconfigs.get_config(arch, smoke=smoke)
    assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    for prop in ("resolved_head_dim", "padded_vocab", "d_inner",
                 "is_attention_free", "supports_long_context"):
        assert getattr(mine, prop) == getattr(theirs, prop), prop
    assert (tconfigs.applicable_shapes(mine)
            == jconfigs.applicable_shapes(theirs))


def test_registry_ports_the_dense_archs_and_names_the_rest():
    """Every architecture of the reference, in its order; the shapes."""
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    assert set(PORTED) == set(jconfigs.ARCH_IDS)
    assert {k: dataclasses.asdict(v) for k, v in tconfigs.SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()}
    with pytest.raises(KeyError):
        tconfigs.get_config("no-such-arch")


@pytest.mark.parametrize("family", ["dense", "moe", "vlm", "ssm", "hybrid",
                                    "encdec", "audio"])
def test_get_module_maps_each_family_as_the_reference(family):
    cfg = dataclasses.replace(tconfigs.get_config("gemma3-1b", smoke=True),
                              family=family)
    jcfg = dataclasses.replace(jconfigs.get_config("gemma3-1b", smoke=True),
                               family=family)
    assert get_module(cfg).__name__.rsplit(".", 1)[1] \
        == jget_module(jcfg).__name__.rsplit(".", 1)[1]


def test_get_module_refuses_the_gnn_and_unknown_families():
    cfg = tconfigs.get_config("gemma3-1b", smoke=True)
    with pytest.raises(ValueError, match="dedicated API"):
        get_module(dataclasses.replace(cfg, family="gnn"))
    with pytest.raises(KeyError):
        get_module(dataclasses.replace(cfg, family="no-such-family"))


def test_vlm_family_runs_through_the_transformer():
    cfg = dataclasses.replace(tconfigs.get_config("gemma3-1b", smoke=True),
                              family="vlm")
    assert get_module(cfg) is transformer


@pytest.mark.parametrize("arch", MOE + DENSE)
def test_self_attention_defaults_to_the_causal_path_bit_for_bit(arch):
    """The encoder-decoder's ``causal`` switch leaves the decoder-only
    configs' attention as it was: the default is the causal call, bit for
    bit, and the bidirectional one differs."""
    cfg = tconfigs.get_config(arch, smoke=True)
    p = {k: v[0] for k, v in init_from_defs(
        transformer.defs(cfg), torch.Generator().manual_seed(0),
        "cpu")["layers"].items()}
    x = torch.randn((2, 12, cfg.d_model),
                    generator=torch.Generator().manual_seed(1)).bfloat16()
    window, theta = transformer.layer_flags(cfg)
    kw = {"window": window[0], "theta": theta[0]}
    default = attention.self_attention(cfg, p, x, **kw)
    assert torch.equal(default,
                       attention.self_attention(cfg, p, x, causal=True, **kw))
    q, k, v = attention._project(cfg, p, x)
    pos = torch.arange(12)
    o = layers.flash_attention(layers.rope(q, pos, theta[0]),
                               layers.rope(k, pos, theta[0]), v, causal=True,
                               window=window[0])
    assert torch.equal(default, attention._out(cfg, p, o))
    assert not torch.equal(
        default, attention.self_attention(cfg, p, x, causal=False, **kw))


@pytest.mark.parametrize("arch", MOE + DENSE)
def test_defs_and_layer_flags_match_reference(arch):
    for smoke in (False, True):
        cfg = tconfigs.get_config(arch, smoke=smoke)
        jcfg = jconfigs.get_config(arch, smoke=smoke)
        mine = dict(_flatten(transformer.defs(cfg)))
        theirs = dict(_flatten(jtransformer.defs(jcfg)))
        assert mine.keys() == theirs.keys()
        for k, d in mine.items():
            t = theirs[k]
            assert isinstance(d, Def)
            assert (d.shape, d.axes, d.init, d.scale, d.fan_in_dims) == (
                t.shape, t.axes, t.init, t.scale, t.fan_in_dims), k
        cache = dict(_flatten(transformer.cache_defs(cfg, 3, 40)))
        jcache = dict(_flatten(jtransformer.cache_defs(jcfg, 3, 40)))
        assert {k: (d.shape, d.axes) for k, d in cache.items()} == \
            {k: (d.shape, d.axes) for k, d in jcache.items()}
        window, theta = transformer.layer_flags(cfg)
        jwindow, jtheta = jtransformer.layer_flags(jcfg)
        assert window == np.asarray(jwindow).tolist()
        assert theta == np.asarray(jtheta).tolist()
    if arch == "gemma3-1b":  # the global layers: 5, 11, 17, 23 of 26
        cfg = tconfigs.get_config(arch)
        window, theta = transformer.layer_flags(cfg)
        glob = [l for l, w in enumerate(window) if w == transformer.BIG_WINDOW]
        assert glob == [5, 11, 17, 23]
        assert {theta[l] for l in glob} == {1e6}
        assert {theta[l] for l in range(26) if l not in glob} == {1e4}
        assert {window[l] for l in range(26) if l not in glob} == {512}


# ----------------------------------------------------------------- layers --

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rms_norm_and_swiglu_match_reference(dtype):
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2, 5, 64)).astype(np.float32)
                         ).to(dtype)
    scale = torch.from_numpy(rng.standard_normal(64).astype(np.float32) * .1)
    got = layers.rms_norm(x, scale, 1e-5)
    want = jlayers.rms_norm(_to_jax(x), _to_jax(scale), 1e-5)
    assert got.dtype == dtype
    # f32: rsqrt vs XLA's rsqrt (a few ulp); bf16: the same f32 values
    # rounded once, at most one bf16 step apart
    tol = 1e-6 if dtype == torch.float32 else 8e-3
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)

    p = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32) * .1)
         for k, s in (("w_gate", (64, 96)), ("w_up", (64, 96)),
                      ("w_down", (96, 64)))}
    got = layers.swiglu_mlp(p, x)
    want = jlayers.swiglu_mlp({k: _to_jax(v) for k, v in p.items()},
                              _to_jax(x), DIST)
    assert got.dtype == dtype
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("theta", [1e4, 1e6])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rope_matches_reference(theta, dtype):
    """Positions up to 4095, as the prefill's; f32 within 2e-5 (sin and cos
    of angles up to 4095 rad differ by an ulp of the angle's f32 between the
    two libraries); bf16 within one bf16 step."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((2, 9, 3, 32)).astype(np.float32)
                         ).to(dtype)
    pos = torch.tensor([0, 1, 2, 511, 512, 1000, 2047, 4000, 4095])
    got = layers.rope(x, pos, theta)
    want = jlayers.rope(_to_jax(x), jnp.asarray(pos.numpy()), theta)
    assert got.dtype == dtype
    tol = 2e-5 if dtype == torch.float32 else 1.6e-2
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("Hkv,window", [(1, 0), (2, 4), (4, 1 << 30)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_matches_reference(Hkv, window, dtype):
    """One query over a cache of 11 slots of which 8 are filled (slots past
    ``pos`` invalid).  f32 within 1e-6; bf16 within one bf16 step."""
    rng = np.random.default_rng(Hkv)

    def t(shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                                ).to(dtype)

    q, k, v = t((2, 1, 4, 16)), t((2, 11, Hkv, 16)), t((2, 11, Hkv, 16))
    pos = 7
    idx = torch.arange(11)
    k_pos = torch.where(idx <= pos, idx, -1)
    q_pos = torch.tensor([pos])
    got = layers.decode_attention(q, k, v, q_pos, k_pos, window=window)
    want = jlayers.decode_attention(
        _to_jax(q), _to_jax(k), _to_jax(v), jnp.asarray(q_pos.numpy()),
        jnp.asarray(k_pos.numpy()), window=window)
    tol = 1e-6 if dtype == torch.float32 else 8e-3
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


# --------------------------------------------------- the serving path ------

@functools.lru_cache(maxsize=None)
def _reference_run(arch: str, overrides: tuple = ()):
    """The reference's ``examples/serve_lm.py`` loop on ``arch``'s smoke
    config (B 4, prompt 24, 16 new tokens; ``overrides``: (field, value)
    pairs replaced in the config), with its prefill cache and every step's
    logits kept."""
    cfg = dataclasses.replace(jconfigs.get_config(arch, smoke=True),
                              **dict(overrides))
    mod = jget_module(cfg)
    params = jinit_from_defs(mod.defs(cfg), jax.random.PRNGKey(0))
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                                (B, PROMPT)).astype(np.int32)
    logits, cache = jax.jit(
        lambda p, t: mod.prefill(cfg, p, t, dist=DIST, max_len=PROMPT + NEW)
    )(params, jnp.asarray(prompts))
    step = jax.jit(lambda p, c, t, pos: mod.decode_step(cfg, p, c, t, pos,
                                                        dist=DIST))
    V = cfg.vocab_size
    tok = jnp.argmax(logits[:, -1:, :V], -1).astype(jnp.int32)
    toks, outs, c = [tok], [logits[:, -1:, :V]], cache
    for i in range(NEW - 1):
        lg, c = step(params, c, tok, jnp.int32(PROMPT + i))
        tok = jnp.argmax(lg[:, :, :V], -1).astype(jnp.int32)
        toks.append(tok)
        outs.append(lg[:, :, :V])
    return {"params": jax.tree_util.tree_map(np.asarray, params),
            "prompts": prompts,
            "prefill_logits": _f32(logits), "cache": cache,
            "tokens": np.asarray(jnp.concatenate(toks, 1)),
            "logits": _f32(jnp.concatenate(outs, 1))}


def _port_params(ref):
    return params_from_jax(ref["params"], "cpu")


@pytest.mark.parametrize("arch", DENSE)
def test_params_from_jax_preserves_the_tree(arch):
    ref = _reference_run(arch)
    mine = dict(_flatten(_port_params(ref)))
    theirs = dict(_flatten(ref["params"]))
    assert mine.keys() == theirs.keys()
    for k, t in mine.items():
        assert isinstance(t, torch.Tensor) and t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), theirs[k])
    cfg = tconfigs.get_config(arch, smoke=True)
    shapes = {k: d.shape for k, d in _flatten(transformer.defs(cfg))}
    assert {k: tuple(t.shape) for k, t in mine.items()} == shapes


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_logits_and_cache_match_reference(arch):
    ref = _reference_run(arch)
    cfg = tconfigs.get_config(arch, smoke=True)
    logits, cache = transformer.prefill(
        cfg, _port_params(ref), torch.from_numpy(ref["prompts"]),
        max_len=PROMPT + NEW)
    assert logits.dtype == torch.bfloat16
    assert logits.shape == (B, 1, cfg.padded_vocab)
    np.testing.assert_allclose(_f32(logits), ref["prefill_logits"],
                               rtol=LOGIT_RTOL, atol=LOGIT_ATOL)
    for name in ("k", "v"):
        assert cache[name].dtype == torch.bfloat16
        assert tuple(cache[name].shape) == ref["cache"][name].shape
        # rope'd keys and values of unit scale.  Layer 0's are bitwise
        # equal; later layers' differ by a few bf16 steps (measured 0.047 at
        # most), because XLA computes fused bf16 chains (silu * u, the
        # residual adds) in f32 and rounds once, and the port rounds each op
        np.testing.assert_allclose(_f32(cache[name]), _f32(ref["cache"][name]),
                                   rtol=3e-2, atol=6e-2)
        assert not cache[name][:, :, PROMPT:].any()


@pytest.mark.parametrize("arch", DENSE)
def test_teacher_forced_decode_matches_reference(arch):
    """8 decode steps from the prefill cache, fed the reference's tokens."""
    ref = _reference_run(arch)
    cfg = tconfigs.get_config(arch, smoke=True)
    params = _port_params(ref)
    _, cache = transformer.prefill(cfg, params,
                                   torch.from_numpy(ref["prompts"]),
                                   max_len=PROMPT + NEW)
    toks = torch.from_numpy(ref["tokens"].copy())
    for i in range(FORCED):
        logits, cache = transformer.decode_step(cfg, params, cache,
                                                toks[:, i:i + 1], PROMPT + i)
        np.testing.assert_allclose(
            _f32(logits[:, :, :cfg.vocab_size]), ref["logits"][:, i + 1:i + 2],
            rtol=LOGIT_RTOL, atol=LOGIT_ATOL)
    assert cache["k"][:, :, PROMPT + FORCED - 1].any()
    assert not cache["k"][:, :, PROMPT + FORCED:].any()


def _teacher_forced(cfg, params, prompts, tokens):
    """The logits ``generate`` would give if its decode steps were fed
    ``tokens`` (B, new) instead of its own argmaxes: the prefill's last
    position, then ``decode_step`` on ``tokens[:, i]``."""
    prompts, tokens = torch.as_tensor(prompts), torch.as_tensor(tokens)
    P, V = prompts.shape[1], cfg.vocab_size
    logits, cache = transformer.prefill(cfg, params, prompts,
                                        max_len=P + tokens.shape[1])
    outs = [logits[:, -1:, :V]]
    for i in range(tokens.shape[1] - 1):
        logits, cache = transformer.decode_step(cfg, params, cache,
                                                tokens[:, i:i + 1], P + i)
        outs.append(logits[:, :, :V])
    return torch.cat(outs, dim=1)


@pytest.mark.parametrize("arch", DENSE)
def test_generate_matches_the_reference_serving_loop(arch):
    """Fed the reference's greedy tokens, the port's logits of all 16 steps
    agree with the reference's, and their argmax equals the reference's
    token wherever the reference's top-2 margin exceeds twice the largest
    logit difference at that position (elsewhere bf16 logits tie or nearly
    tie and either token is right); the positions so checked are counted
    and must be most of them (45 to 54 of 64 measured).  ``generate`` then
    gives the reference's tokens, and logits, up to the first step that was
    not clear."""
    ref = _reference_run(arch)
    cfg = tconfigs.get_config(arch, smoke=True)
    params = _port_params(ref)
    forced = _f32(_teacher_forced(cfg, params, ref["prompts"],
                                  ref["tokens"].astype(np.int64)))
    np.testing.assert_allclose(forced, ref["logits"], rtol=LOGIT_RTOL,
                               atol=LOGIT_ATOL)
    err = np.abs(forced - ref["logits"]).max(axis=-1)
    top2 = np.sort(ref["logits"], axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 2 * err
    assert clear.sum() >= clear.size // 2, (clear.sum(), clear.size)
    np.testing.assert_array_equal(forced.argmax(-1)[clear],
                                  ref["tokens"][clear])
    gen = serve_lm.generate(cfg, params, ref["prompts"], NEW, device="cpu")
    assert gen.tokens.shape == (B, NEW) and gen.logits.shape == forced.shape
    first = int(np.argmin(clear.all(axis=0))) if not clear.all() else NEW
    np.testing.assert_array_equal(gen.tokens.numpy()[:, :first],
                                  ref["tokens"][:, :first])
    np.testing.assert_allclose(_f32(gen.logits)[:, :first + 1],
                               ref["logits"][:, :first + 1],
                               rtol=LOGIT_RTOL, atol=LOGIT_ATOL)


def test_generate_takes_the_argmax_over_the_real_vocabulary():
    """With a vocabulary that is not a multiple of 256 the embedding has pad
    rows; made large, they would win an argmax over the padded logits.
    ``generate`` returns tokens and logits of the real vocabulary only."""
    cfg = dataclasses.replace(tconfigs.get_config("gemma3-1b", smoke=True),
                              vocab_size=500)
    assert cfg.padded_vocab == 512
    params = params_from_jax(_reference_run("gemma3-1b")["params"], "cpu")
    params["embed"][500:] = 50.0 * torch.randn(
        (12, cfg.d_model), generator=torch.Generator().manual_seed(4))
    prompts = np.random.default_rng(5).integers(0, 500, (2, 10))
    padded, _ = transformer.prefill(cfg, params, torch.from_numpy(prompts))
    assert (padded[:, -1].argmax(-1) >= 500).any()  # the pads would win
    gen = serve_lm.generate(cfg, params, prompts, 6, device="cpu")
    assert gen.logits.shape == (2, 6, 500)
    assert int(gen.tokens.max()) < 500
    np.testing.assert_array_equal(gen.tokens.numpy(),
                                  gen.logits.float().argmax(-1).numpy())


def test_init_cache_defaults_to_the_card():
    """Like the reference's (on JAX's default device), the cache goes to
    the card unless the caller asks for the CPU; without a card that
    raises instead of falling back."""
    cfg = tconfigs.get_config("gemma3-1b", smoke=True)
    on_cpu = transformer.init_cache(cfg, 2, 8, device="cpu")
    assert on_cpu["k"].device.type == "cpu"
    assert on_cpu["k"].shape == (cfg.n_layers, 2, 8, cfg.n_kv_heads,
                                 cfg.resolved_head_dim)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            transformer.init_cache(cfg, 2, 8)
    else:
        assert transformer.init_cache(cfg, 2, 8)["v"].device.type == "cuda"


@pytest.mark.parametrize("arch", ["gemma3-1b", "qwen2.5-14b"])
def test_decode_matches_the_port_forward(arch):
    """The reference's decode consistency check on the port: teacher-forced
    decoding from an empty cache reproduces the full forward's logits
    (log-softmax, rtol = atol = 5e-2 as ``tests/test_decode_consistency.py``),
    across gemma3's window of 8."""
    cfg = tconfigs.get_config(arch, smoke=True)
    params = params_from_jax(_reference_run(arch)["params"], "cpu")
    S = 12
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (1, S)))
    full, _ = transformer.forward(cfg, params, tokens)
    cache = transformer.init_cache(cfg, 1, S, device="cpu")
    outs = []
    for t in range(S):
        lg, cache = transformer.decode_step(cfg, params, cache,
                                            tokens[:, t:t + 1], t)
        outs.append(lg)
    V = cfg.vocab_size
    pd = torch.log_softmax(torch.cat(outs, 1).float()[..., :V], -1)
    pf = torch.log_softmax(full.float()[..., :V], -1)
    np.testing.assert_allclose(pd.numpy(), pf.numpy(), rtol=5e-2, atol=5e-2)


# stablelm's smoke config at its real head dim, as chip_smoke.py phase 27
# runs it (NARROW_STABLELM there): its attention takes the Dh 80 tile
NARROW_STABLELM = (("n_layers", 2), ("n_heads", 4), ("n_kv_heads", 4),
                   ("head_dim", 80), ("d_model", 320))
# chip_smoke.py's NARROW_STABLELM_TOL and LM_SMOKE_ATOL
NARROW_STABLELM_ATOL, LM_SMOKE_ATOL = 6e-2, 5e-3


def test_narrow_stablelm_logit_spread():
    """The limit ``chip_smoke.py`` phase 27 holds the narrow stablelm's
    card logits to (against the CPU's): rounding alone, here the reference
    against the port from the same weights, spreads the logits beyond
    LM_SMOKE_ATOL and within NARROW_STABLELM_ATOL (measured 0.047 at most,
    18,779 of 32,768 beyond 5e-3), while a Dh 80 attention whose last 16
    columns (the tile's tail box) come out zero puts most logits outside
    it (28,198 of them, 2.76 at most)."""
    ref = _reference_run("stablelm-3b", NARROW_STABLELM)
    cfg = dataclasses.replace(tconfigs.get_config("stablelm-3b", smoke=True),
                              **dict(NARROW_STABLELM))
    assert cfg.resolved_head_dim == 80
    params = _port_params(ref)

    def spread(attend):
        inner = transformer.flash_attention
        transformer.flash_attention = attend
        try:
            got = _teacher_forced(cfg, params, ref["prompts"], ref["tokens"])
        finally:
            transformer.flash_attention = inner
        return np.abs(_f32(got) - ref["logits"])

    def tail_zero(*a, **kw):
        o = layers.flash_attention(*a, **kw).clone()
        o[..., 64:] = 0
        return o

    d, broken = spread(layers.flash_attention), spread(tail_zero)
    print(f"narrow stablelm, reference vs port: max |logit diff| "
          f"{d.max():.4e}, {(d > LM_SMOKE_ATOL).sum()} of {d.size} beyond "
          f"{LM_SMOKE_ATOL}; with the Dh 80 tail zeroed {broken.max():.4e}, "
          f"{(broken > NARROW_STABLELM_ATOL).sum()} beyond "
          f"{NARROW_STABLELM_ATOL}")
    assert d.max() <= NARROW_STABLELM_ATOL
    assert (d > LM_SMOKE_ATOL).sum() > d.size // 4
    assert (broken > NARROW_STABLELM_ATOL).sum() > d.size // 2


def test_generate_defaults_to_the_card_and_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("a card is present; this checks the CPU-only host")
    cfg = tconfigs.get_config("gemma3-1b", smoke=True)
    params = params_from_jax(_reference_run("gemma3-1b")["params"], "cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_lm.generate(cfg, params, np.zeros((1, 4), np.int64), 2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_lm.main(["--smoke"])


def test_serve_lm_main_runs_on_the_cpu(capsys):
    assert serve_lm.main(["--smoke", "--device", "cpu", "--batch", "2",
                          "--prompt", "8", "--new", "4"]) == 0
    out = capsys.readouterr().out
    assert "generated token ids" in out and "gemma3-smoke on cpu" in out
