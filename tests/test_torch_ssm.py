"""The port's SSM and hybrid families (``models/mamba2.py``,
``models/ssm_lm.py``) against the reference package's.

The mixer's pieces on numpy-seeded inputs: ``causal_conv`` and its decode
step, ``ssd_chunked`` (at an S that the chunk does not divide, with and
without an initial state, in f32 and with the bf16 switch) against the
reference's ``ssd_chunked`` and ``ssd_sequential``, ``mamba_block`` and
``mamba_decode_step``.  Then for ``mamba2-smoke`` and ``zamba2-smoke``
(five layers with ``attn_every`` 2: two places of the shared block and a
tail of one layer), from the reference's own initial weights through
``params_from_jax``: ``forward``, ``loss_fn`` and its gradients,
``prefill`` and four decode steps after it.  Decode after prefill is held
to the reference's decode after prefill (both leave the conv tails at
zero), never to the port's own ``forward``.  Every float comparison states
its tolerance.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import mamba2 as jmamba2
from repro.models import ssm_lm as jssm_lm
from repro.models.params import init_from_defs as jinit_from_defs
from repro.models.sharding import Distribution
from repro_torch import configs as tconfigs
from repro_torch.launch import serve_lm
from repro_torch.launch import train as tlaunch
from repro_torch.models import get_module, mamba2, ssm_lm
from repro_torch.models.convert import params_from_jax
from repro_torch.models.params import Def
from repro_torch.train import optimizer as toptimizer

ARCHS = ("mamba2-780m", "zamba2-1.2b")
DIST = Distribution.single_device()
B, PROMPT, NEW = 4, 24, 5  # the prefill's logits, then 4 decode steps
# f32 SSD: the chunked sums run in another order than XLA's and the
# inter-chunk recurrence is a loop where the reference's is a tree
# (associative_scan), so entries agree within rtol 1e-5 plus 2e-6 of the
# largest |entry| (16 f32 ulps of it; measured at most 3.3e-7 of it for y
# and 2.1e-7 for h, the reference's own chunked and sequential forms 2.2e-7
# and 2.1e-7 apart)
SSD_RTOL, SSD_ATOL_OF_MAX = 1e-5, 2e-6
# with ``ssd_bf16`` the (Q, Q) tensors and products are bf16, rounded at
# other points than XLA's fused chains: one bf16 step (2**-7) of the
# largest |y| (measured 0.0026 of it); h within the f32 tolerance above
SSD_BF16_ATOL_OF_MAX = 2 ** -7
# logits, the mixer's output and the bf16 states (conv tails, KV), as
# (atol, rtol).  mamba2-smoke's bf16 chains round at the same points in
# both packages: they agree within 3.8e-6 (measured; the mixer's output
# bit for bit), while a mixer that ran its SSD in bf16 (``ssd_bf16``) is
# 0.02-0.10 off (measured; test_mamba2_tolerances_catch_a_bf16_ssd), so
# mamba2-smoke is held to atol 1e-2 and no rtol.  zamba2-smoke gets the LM
# tolerance of the serving tests (tests/test_torch_lm.py) with twice its
# atol: its shared block's bf16 chains round one step apart from XLA's
# fused ones at 40-50% of the entries (the residual stream reaches |x| 11,
# where a bf16 step is 0.0625), and the Mamba layers after it carry that
# on; the reference's own jit and op-by-op runs differ by up to 0.0703
# there, two entries beyond the LM tolerance, and the port by up to 0.0908
# (forward on 2 x 33 tokens, measured)
LOGIT_ATOL, LOGIT_RTOL = 6e-2, 3e-2
TOL = {"mamba2-780m": (1e-2, 0.0),
       "zamba2-1.2b": (2 * LOGIT_ATOL, LOGIT_RTOL)}
# the prefill's and decode's f32 states h: sums over the prompt of bf16
# activations, within a share of the largest |h|: mamba2-smoke's 1e-5
# (measured 3.0e-7; the bf16-SSD mixer 0.004-0.01), zamba2-smoke's 3e-2
# (measured 0.0143: XLA rounds the shared block's chains once per fused
# chain and torch after each op)
H_ATOL_OF_MAX = {"mamba2-780m": 1e-5, "zamba2-1.2b": 3e-2}
# gradients, per leaf |g_port - g_ref| / |g_ref| (Frobenius), as
# tests/test_torch_lm_train.py holds the dense ones; zamba2-smoke's carry
# the shared block's rounding as its logits do (measured 0.0535 at most,
# at conv_B_w), so they get 8e-2
GRAD_REL = {"mamba2-780m": 5e-2, "zamba2-1.2b": 8e-2}


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _to_jax(t: torch.Tensor):
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.view(torch.int16).numpy().view(jnp.bfloat16))
    return jnp.asarray(t.numpy())


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close_of_max(got, want, of_max: float, rtol: float = 0.0):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=of_max * float(np.abs(want).max()))


def _flatten(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], prefix + (k,))
    else:
        yield prefix, tree


# ------------------------------------------------------- the mixer's parts --

def _ssd_inputs(S: int, with_h0: bool, seed: int = 0):
    """x (2, S, 4, 8), dt in (0, 0.2) (Mamba2 initialises dt in [1e-3,
    1e-1]: h0 still reaches the last positions), A < 0, two B/C groups of
    16 (two heads a group), D; an initial state h0 (2, 4, 16, 8) or
    None."""
    rng = np.random.default_rng(seed + S)
    Bb, H, P_, G, N = 2, 4, 8, 2, 16
    f = np.float32
    ins = {"x": rng.standard_normal((Bb, S, H, P_)).astype(f),
           "dt": 0.1 * np.log1p(np.exp(rng.standard_normal((Bb, S, H)))
                                ).astype(f),
           "A": -np.exp(0.5 * rng.standard_normal(H)).astype(f),
           "B_": rng.standard_normal((Bb, S, G, N)).astype(f),
           "C_": rng.standard_normal((Bb, S, G, N)).astype(f),
           "D_": rng.standard_normal(H).astype(f)}
    h0 = rng.standard_normal((Bb, H, N, P_)).astype(f) if with_h0 else None
    return ins, h0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_causal_conv_matches_reference(dtype):
    rng = np.random.default_rng(1)
    x = _t(rng.standard_normal((2, 13, 24)).astype(np.float32)).to(dtype)
    w = _t(0.5 * rng.standard_normal((4, 24)).astype(np.float32))
    b = _t(0.1 * rng.standard_normal(24).astype(np.float32))
    got = mamba2.causal_conv(x, w, b)
    want = jmamba2.causal_conv(_to_jax(x), _to_jax(w), _to_jax(b))
    assert got.dtype == dtype
    # the taps summed in f32 in the same order; silu's exp differs by an
    # ulp between the libraries (f32), then one rounding to bf16
    tol = 1e-6 if dtype == torch.float32 else 8e-3
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_causal_conv_step_matches_reference(dtype):
    rng = np.random.default_rng(2)
    x = _t(rng.standard_normal((3, 1, 24)).astype(np.float32)).to(dtype)
    state = _t(rng.standard_normal((3, 3, 24)).astype(np.float32)).to(dtype)
    w = _t(0.5 * rng.standard_normal((4, 24)).astype(np.float32))
    b = _t(0.1 * rng.standard_normal(24).astype(np.float32))
    got, tail = mamba2.causal_conv_step(x, state, w, b)
    want, jtail = jmamba2.causal_conv_step(_to_jax(x), _to_jax(state),
                                           _to_jax(w), _to_jax(b))
    tol = 1e-6 if dtype == torch.float32 else 8e-3
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)
    np.testing.assert_array_equal(_f32(tail), _f32(jtail))  # a copy


def test_causal_conv_steps_continue_the_full_convolution():
    """Stepping the conv one token at a time from a zero tail gives the
    full causal convolution (both packages' decode assumes it)."""
    rng = np.random.default_rng(3)
    x = _t(rng.standard_normal((2, 9, 8)).astype(np.float32))
    w = _t(rng.standard_normal((4, 8)).astype(np.float32))
    b = _t(rng.standard_normal(8).astype(np.float32))
    full = mamba2.causal_conv(x, w, b)
    tail = torch.zeros((2, 3, 8))
    for s in range(9):
        out, tail = mamba2.causal_conv_step(x[:, s:s + 1], tail, w, b)
        np.testing.assert_allclose(out[:, 0].numpy(), full[:, s].numpy(),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("S", [32, 37])  # 37: not a multiple of the chunk
def test_ssd_chunked_matches_both_reference_forms(S, with_h0):
    ins, h0 = _ssd_inputs(S, with_h0)
    chunk = 16
    y, h = mamba2.ssd_chunked(**{k: _t(v) for k, v in ins.items()},
                              chunk=chunk,
                              h0=None if h0 is None else _t(h0))
    assert y.dtype == h.dtype == torch.float32
    jins = {k: jnp.asarray(v) for k, v in ins.items()}
    jh0 = None if h0 is None else jnp.asarray(h0)
    for name, (jy, jh) in (
            ("ssd_chunked", jmamba2.ssd_chunked(**jins, chunk=chunk, h0=jh0)),
            ("ssd_sequential", jmamba2.ssd_sequential(**jins, h0=jh0))):
        _close_of_max(y, jy, SSD_ATOL_OF_MAX, SSD_RTOL)
        _close_of_max(h, jh, SSD_ATOL_OF_MAX, SSD_RTOL)
    if h0 is not None:  # the initial state reaches the last chunk
        y0, _ = mamba2.ssd_chunked(**{k: _t(v) for k, v in ins.items()},
                                   chunk=chunk)
        assert (y - y0)[:, -1].abs().max() > 1e-2
    # the port's own oracle against the reference's
    sy, sh = mamba2.ssd_sequential(**{k: _t(v) for k, v in ins.items()},
                                   h0=None if h0 is None else _t(h0))
    jy, jh = jmamba2.ssd_sequential(**jins, h0=jh0)
    _close_of_max(sy, jy, SSD_ATOL_OF_MAX, SSD_RTOL)
    _close_of_max(sh, jh, SSD_ATOL_OF_MAX, SSD_RTOL)


def test_ssd_chunked_continues_from_its_final_state():
    """Two calls, the second from the first's h_final, give one call's y
    and h_final over the whole sequence (the split off a chunk boundary)."""
    ins, _ = _ssd_inputs(37, False, seed=7)
    full_y, full_h = mamba2.ssd_chunked(**{k: _t(v) for k, v in ins.items()},
                                        chunk=16)
    seq = ("x", "dt", "B_", "C_")
    first = {k: _t(v[:, :21] if k in seq else v) for k, v in ins.items()}
    rest = {k: _t(v[:, 21:] if k in seq else v) for k, v in ins.items()}
    y1, h1 = mamba2.ssd_chunked(**first, chunk=16)
    y2, h2 = mamba2.ssd_chunked(**rest, chunk=16, h0=h1)
    _close_of_max(torch.cat([y1, y2], 1), full_y, SSD_ATOL_OF_MAX, SSD_RTOL)
    _close_of_max(h2, full_h, SSD_ATOL_OF_MAX, SSD_RTOL)


@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_chunked_bf16_switch_matches_reference(with_h0):
    ins, h0 = _ssd_inputs(37, with_h0, seed=5)
    y, h = mamba2.ssd_chunked(**{k: _t(v) for k, v in ins.items()}, chunk=16,
                              h0=None if h0 is None else _t(h0),
                              compute_dtype=torch.bfloat16)
    jy, jh = jmamba2.ssd_chunked(
        **{k: jnp.asarray(v) for k, v in ins.items()}, chunk=16,
        h0=None if h0 is None else jnp.asarray(h0),
        compute_dtype=jnp.bfloat16)
    assert y.dtype == torch.float32
    _close_of_max(y, jy, SSD_BF16_ATOL_OF_MAX)
    _close_of_max(h, jh, SSD_ATOL_OF_MAX, SSD_RTOL)


def test_ssd_chunked_gradient_is_finite_over_long_chunks():
    """Within a chunk of 256 the decays above the diagonal reach exp(+500),
    which overflows; the port masks before the exp, so the gradient stays
    finite (and equals the sequential oracle's)."""
    ins, _ = _ssd_inputs(256, False, seed=9)
    ins["dt"] = ins["dt"] + 1.0
    a = {k: _t(v).requires_grad_(k in ("x", "dt")) for k, v in ins.items()}
    y, h = mamba2.ssd_chunked(**a, chunk=256)
    (y.square().mean() + h.square().mean()).backward()
    gx, gdt = a["x"].grad.clone(), a["dt"].grad.clone()
    assert torch.isfinite(gx).all() and torch.isfinite(gdt).all()
    b = {k: _t(v).requires_grad_(k in ("x", "dt")) for k, v in ins.items()}
    ys, hs = mamba2.ssd_sequential(**b)
    (ys.square().mean() + hs.square().mean()).backward()
    torch.testing.assert_close(gx, b["x"].grad, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(gdt, b["dt"].grad, rtol=1e-4, atol=1e-5)


@functools.lru_cache(maxsize=None)
def _reference_params(arch: str):
    cfg = jconfigs.get_config(arch, smoke=True)
    params = jinit_from_defs(jssm_lm.defs(cfg), jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, params)


def _layer0(arch: str):
    return {k: v[0] for k, v in _reference_params(arch)["layers"].items()}


def _mamba_block_runs(cfg):
    """mamba2-smoke's layer 0 on a bf16 input of 37 positions (chunk 16,
    ragged) through the port's ``mamba_block`` under ``cfg`` and the
    reference's (its f32 SSD): ((out, jout), (h, jh)), the input and the
    generator that drew it."""
    jcfg = jconfigs.get_config("mamba2-780m", smoke=True)
    jp = _layer0("mamba2-780m")
    rng = np.random.default_rng(4)
    x = _t(rng.standard_normal((2, 37, cfg.d_model)).astype(np.float32)
           ).bfloat16()
    out, h = mamba2.mamba_block(cfg, params_from_jax(jp, "cpu"), x)
    jout, jh = jmamba2.mamba_block(jcfg, jp, _to_jax(x), dist=DIST)
    return ((out, jout), (h, jh)), x, rng


def _close_logits(arch: str, got, want, **kw):
    atol, rtol = TOL[arch]
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=rtol, atol=atol,
                               **kw)


def test_mamba_block_and_decode_step_match_reference():
    """mamba2-smoke's layer 0 on 37 positions, then one decode step from a
    random state."""
    arch = "mamba2-780m"
    cfg = tconfigs.get_config(arch, smoke=True)
    jcfg = jconfigs.get_config(arch, smoke=True)
    ((out, jout), (h, jh)), x, rng = _mamba_block_runs(cfg)
    assert out.dtype == torch.bfloat16 and h.dtype == torch.float32
    _close_logits(arch, out, jout)
    _close_of_max(h, jh, H_ATOL_OF_MAX[arch])

    state = mamba2.init_mamba_state(cfg, 2, device="cpu")
    assert {k: (tuple(v.shape), v.dtype) for k, v in state.items()} == {
        k: (v.shape, torch.float32 if k == "h" else torch.bfloat16)
        for k, v in jmamba2.init_mamba_state(jcfg, 2).items()}
    state = {k: _t(rng.standard_normal(tuple(v.shape)).astype(np.float32)
                   ).to(v.dtype) for k, v in state.items()}
    jp = _layer0(arch)
    x1 = x[:, :1]
    out, new = mamba2.mamba_decode_step(cfg, params_from_jax(jp, "cpu"), x1,
                                        state)
    jout, jnew = jmamba2.mamba_decode_step(
        jcfg, jp, _to_jax(x1), {k: _to_jax(v) for k, v in state.items()},
        dist=DIST)
    _close_logits(arch, out, jout)
    _close_of_max(new["h"], jnew["h"], H_ATOL_OF_MAX[arch])
    for k in ("conv_x", "conv_B", "conv_C"):  # the window's raw inputs
        np.testing.assert_array_equal(_f32(new[k]), _f32(jnew[k]))


def test_init_mamba_state_defaults_to_the_card():
    cfg = tconfigs.get_config("mamba2-780m", smoke=True)
    assert mamba2.init_mamba_state(cfg, 2, device="cpu")["h"].device.type \
        == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            mamba2.init_mamba_state(cfg, 2)


# -------------------------------------------------------------- the models --

@pytest.mark.parametrize("arch", ARCHS)
def test_defs_state_defs_and_groups_match_reference(arch):
    for smoke in (False, True):
        cfg = tconfigs.get_config(arch, smoke=smoke)
        jcfg = jconfigs.get_config(arch, smoke=smoke)
        assert ssm_lm._n_groups(cfg) == jssm_lm._n_groups(jcfg)
        for mine, theirs in ((ssm_lm.defs(cfg), jssm_lm.defs(jcfg)),
                             (ssm_lm.state_defs(cfg, 3, 40),
                              jssm_lm.state_defs(jcfg, 3, 40))):
            mine, theirs = dict(_flatten(mine)), dict(_flatten(theirs))
            assert mine.keys() == theirs.keys()
            for k, d in mine.items():
                t = theirs[k]
                assert isinstance(d, Def)
                assert (d.shape, d.axes, d.init, d.scale, d.fan_in_dims) == (
                    t.shape, t.axes, t.init, t.scale, t.fan_in_dims), k
    cfg = tconfigs.get_config(arch, smoke=True)
    jcfg = jconfigs.get_config(arch, smoke=True)
    layers = params_from_jax(_reference_params(arch)["layers"], "cpu")
    grouped, tail = ssm_lm._group_params(cfg, layers)
    jgrouped, jtail = jssm_lm._group_params(jcfg,
                                            _reference_params(arch)["layers"])
    for mine, theirs in ((grouped, jgrouped), (tail, jtail)):
        assert (mine is None) == (theirs is None)
        for k in (mine or {}):
            np.testing.assert_array_equal(mine[k].numpy(), theirs[k])
    kinds = [(k, i) for k, i, _ in ssm_lm._schedule(
        cfg, params_from_jax(_reference_params(arch), "cpu"))]
    if arch == "zamba2-1.2b":  # 2 groups of 2 and a tail of 1
        assert kinds == [("mamba", 0), ("mamba", 1), ("shared", 0),
                         ("mamba", 2), ("mamba", 3), ("shared", 1),
                         ("mamba", 4)]
    else:
        assert kinds == [("mamba", l) for l in range(cfg.n_layers)]


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax_preserves_the_tree(arch):
    ref = _reference_params(arch)
    mine = dict(_flatten(params_from_jax(ref, "cpu")))
    theirs = dict(_flatten(ref))
    assert mine.keys() == theirs.keys()
    for k, t in mine.items():
        assert t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), theirs[k])
    cfg = tconfigs.get_config(arch, smoke=True)
    assert {k: tuple(t.shape) for k, t in mine.items()} == {
        k: d.shape for k, d in _flatten(ssm_lm.defs(cfg))}
    assert ("shared_attn", "wq") in mine if arch == "zamba2-1.2b" \
        else not any(k[0] == "shared_attn" for k in mine)


@functools.lru_cache(maxsize=None)
def _reference_run(arch: str):
    """The reference's forward on 2 x 33 tokens, then its serving loop on
    the smoke config (B 4, prompt 24): prefill, 4 greedy decode steps, the
    state after the prefill and after each step."""
    cfg = jconfigs.get_config(arch, smoke=True)
    params = jax.tree_util.tree_map(jnp.asarray, _reference_params(arch))
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 33))
    fwd, _ = jax.jit(lambda p, t: jssm_lm.forward(cfg, p, t, dist=DIST))(
        params, jnp.asarray(toks, jnp.int32))
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                                (B, PROMPT)).astype(np.int32)
    logits, state = jax.jit(lambda p, t: jssm_lm.prefill(
        cfg, p, t, dist=DIST, max_len=PROMPT + NEW))(params,
                                                     jnp.asarray(prompts))
    step = jax.jit(lambda p, s, t, pos: jssm_lm.decode_step(
        cfg, p, s, t, pos, dist=DIST))
    V = cfg.vocab_size
    tok = jnp.argmax(logits[:, -1:, :V], -1).astype(jnp.int32)
    toks_out, outs = [tok], [_f32(logits[:, -1:, :V])]
    states = [jax.tree_util.tree_map(_f32, state)]
    for i in range(NEW - 1):
        lg, state = step(params, state, tok, jnp.int32(PROMPT + i))
        tok = jnp.argmax(lg[:, :, :V], -1).astype(jnp.int32)
        toks_out.append(tok)
        outs.append(_f32(lg[:, :, :V]))
        states.append(jax.tree_util.tree_map(_f32, state))
    return {"fwd_tokens": toks, "forward": _f32(fwd), "prompts": prompts,
            "tokens": np.asarray(jnp.concatenate(toks_out, 1)),
            "logits": np.concatenate(outs, 1), "states": states}


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    ref = _reference_run(arch)
    cfg = tconfigs.get_config(arch, smoke=True)
    params = params_from_jax(_reference_params(arch), "cpu")
    with torch.no_grad():
        logits, aux = ssm_lm.forward(cfg, params,
                                     torch.from_numpy(ref["fwd_tokens"]))
    assert aux == 0.0 and logits.dtype == torch.bfloat16
    _close_logits(arch, logits, ref["forward"])


def _state_close(arch: str, state, want: dict, step: str):
    assert state.keys() == want.keys(), step
    for k, v in state.items():
        assert tuple(v.shape) == want[k].shape, (step, k)
        assert v.dtype == (torch.float32 if k == "h" else torch.bfloat16)
        if k == "h":
            _close_of_max(v, want[k], H_ATOL_OF_MAX[arch])
        else:  # conv tails: bf16 projections; KV: rope'd k and v
            _close_logits(arch, v, want[k], err_msg=f"{step} {k}")


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    """Prefill's logits and state (``h``, zero conv tails, the hybrid's KV
    caches), then 4 decode steps fed the reference's greedy tokens: the
    logits and the whole state after each step."""
    ref = _reference_run(arch)
    cfg = tconfigs.get_config(arch, smoke=True)
    params = params_from_jax(_reference_params(arch), "cpu")
    with torch.inference_mode():
        logits, state = ssm_lm.prefill(cfg, params,
                                       torch.from_numpy(ref["prompts"]),
                                       max_len=PROMPT + NEW)
    assert logits.shape == (B, 1, cfg.padded_vocab)
    _close_logits(arch, logits[:, :, :cfg.vocab_size], ref["logits"][:, :1])
    _state_close(arch, state, ref["states"][0], "prefill")
    for k in ("conv_x", "conv_B", "conv_C"):
        assert not state[k].any()  # the reference's zero tails
    if "attn_k" in state:
        assert not state["attn_k"][:, :, PROMPT:].any()
    toks = torch.from_numpy(ref["tokens"].astype(np.int64))
    with torch.inference_mode():
        for i in range(NEW - 1):
            logits, state = ssm_lm.decode_step(cfg, params, state,
                                               toks[:, i:i + 1], PROMPT + i)
            _close_logits(arch, logits[:, :, :cfg.vocab_size],
                          ref["logits"][:, i + 1:i + 2])
            _state_close(arch, state, ref["states"][i + 1], f"decode {i}")


@pytest.mark.parametrize("where", ["mamba_block", "prefill"])
def test_mamba2_tolerances_catch_a_bf16_ssd(where):
    """A mixer that ran its SSD in bf16 (``ssd_bf16=True``, where the
    config asks for f32) fails mamba2-smoke's checks above: its output
    and ``h`` in the mixer's test, the logits and ``h`` of the prefill."""
    arch = "mamba2-780m"
    cfg = dataclasses.replace(tconfigs.get_config(arch, smoke=True),
                              ssd_bf16=True)
    if where == "mamba_block":
        ((out, want), (h, want_h)), _, _ = _mamba_block_runs(cfg)
    else:
        ref = _reference_run(arch)
        with torch.inference_mode():
            logits, state = ssm_lm.prefill(
                cfg, params_from_jax(_reference_params(arch), "cpu"),
                torch.from_numpy(ref["prompts"]), max_len=PROMPT + NEW)
        out, want = logits[:, :, :cfg.vocab_size], ref["logits"][:, :1]
        h, want_h = state["h"], ref["states"][0]["h"]
    with pytest.raises(AssertionError):
        _close_logits(arch, out, want)
    with pytest.raises(AssertionError):
        _close_of_max(h, want_h, H_ATOL_OF_MAX[arch])


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_runs_prefill_and_decode(arch):
    """``generate`` through the family's module: its logits are the
    teacher-forced ones for its own tokens, and agree with the
    reference's loop wherever the tokens agree."""
    ref = _reference_run(arch)
    cfg = tconfigs.get_config(arch, smoke=True)
    params = params_from_jax(_reference_params(arch), "cpu")
    assert get_module(cfg) is ssm_lm
    gen = serve_lm.generate(cfg, params, ref["prompts"], NEW, device="cpu")
    assert gen.tokens.shape == (B, NEW)
    assert gen.logits.shape == (B, NEW, cfg.vocab_size)
    np.testing.assert_array_equal(gen.tokens.numpy(),
                                  gen.logits.float().argmax(-1).numpy())
    _close_logits(arch, _f32(gen.logits)[:, 0], ref["logits"][:, 0])
    with pytest.raises(ValueError, match="frames"):
        serve_lm.generate(cfg, params, ref["prompts"], 2, device="cpu",
                          frames=np.zeros((B, 8, cfg.d_model), np.float32))


def _jbatch(batch):
    return {k: jnp.asarray(v.numpy()) for k, v in batch.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    cfg = tconfigs.get_config(arch, smoke=True)
    jcfg = jconfigs.get_config(arch, smoke=True)
    batch = tlaunch.make_batch(cfg, 2, 32, 0, 0, device="cpu")
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jssm_lm.loss_fn(jcfg, p, _jbatch(batch), dist=DIST),
        has_aux=True))(jax.tree_util.tree_map(jnp.asarray,
                                              _reference_params(arch)))
    leaves = toptimizer.tree_map(lambda p: p.detach().requires_grad_(),
                                 params_from_jax(_reference_params(arch),
                                                 "cpu"))
    loss, metrics = ssm_lm.loss_fn(cfg, leaves, batch)
    loss.backward()
    loss = loss.detach()
    atol, rtol = TOL[arch]
    assert abs(float(loss) - float(jloss)) <= atol + rtol * abs(float(jloss))
    assert float(metrics["ce"].detach()) == float(loss)
    jg = dict(_flatten(jax.tree_util.tree_map(np.asarray, jgrads)))
    for k, p in _flatten(leaves):
        g = p.grad.numpy()
        err = np.linalg.norm(g - jg[k]) / max(np.linalg.norm(jg[k]), 1e-30)
        assert err <= GRAD_REL[arch], (k, err)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gives_the_same_loss_and_gradients(arch):
    """``cfg.remat`` checkpoints each Mamba layer and each place of the
    shared block: the same loss and gradients, bit for bit."""
    cfg = tconfigs.get_config(arch, smoke=True)
    batch = tlaunch.make_batch(cfg, 2, 32, 0, 1, device="cpu")
    out = []
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        leaves = toptimizer.tree_map(
            lambda p: p.detach().requires_grad_(),
            params_from_jax(_reference_params(arch), "cpu"))
        loss, _ = ssm_lm.loss_fn(c, leaves, batch)
        loss.backward()
        out.append((float(loss.detach()),
                    [p.grad for _, p in _flatten(leaves)]))
    assert out[0][0] == out[1][0]
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)


def test_init_state_defaults_to_the_card():
    cfg = tconfigs.get_config("zamba2-1.2b", smoke=True)
    on_cpu = ssm_lm.init_state(cfg, 2, 8, device="cpu")
    assert on_cpu["attn_k"].shape == (2, 2, 8, cfg.n_kv_heads,
                                      cfg.resolved_head_dim)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ssm_lm.init_state(cfg, 2, 8)
