"""The port's encoder-decoder family (``models/encdec.py``, the cross
attention of ``models/attention.py``) against the reference package's, on
``seamless-smoke`` from the reference's own initial weights
(``params_from_jax``) and numpy-seeded frames.

``encode``, the teacher-forced ``decode_train``, ``loss_fn`` and its
gradients, and the serving path: ``prefill`` against the reference's
serving prefill (``launch/specs.py``: ``encode``, ``make_cache`` with the
same number of self slots, ``decode_train``), whose self cache stays all
zero, then four decode steps fed the reference's greedy tokens.  Every
float comparison states its tolerance.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import attention as jattention
from repro.models import encdec as jencdec
from repro.models.params import init_from_defs as jinit_from_defs
from repro.models.sharding import Distribution
from repro_torch import configs as tconfigs
from repro_torch.launch import serve_lm
from repro_torch.launch import train as tlaunch
from repro_torch.models import attention, encdec, get_module
from repro_torch.models.convert import params_from_jax
from repro_torch.models.params import Def
from repro_torch.train import optimizer as toptimizer

ARCH = "seamless-m4t-large-v2"
DIST = Distribution.single_device()
# serving: 4 x 64 frames, prompts of St = max(64 // 8, 16) = 16 tokens,
# the prefill's logits and 4 decode steps
B, FRAMES, NEW = 4, 64, 5
# logits and bf16 states: the LM tolerance of the serving tests
# (tests/test_torch_lm.py; XLA rounds fused bf16 chains once, torch after
# each op)
ATOL, RTOL = 6e-2, 3e-2
# the decode steps' logits get twice the atol: the reference's own jit and
# op-by-op runs of these 4 steps differ by up to 0.1289 (30 entries beyond
# the LM tolerance), the port and the jit reference by up to 0.0977
# (measured); the prefill's logits stay within the LM tolerance
DECODE_ATOL = 2 * ATOL
# gradients, per leaf |g_port - g_ref| / |g_ref| (Frobenius), as
# tests/test_torch_lm_train.py holds the dense ones
GRAD_REL = 5e-2


def _to_jax(t: torch.Tensor):
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.view(torch.int16).numpy().view(jnp.bfloat16))
    return jnp.asarray(t.numpy())


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, atol=ATOL, **kw):
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=RTOL, atol=atol,
                               **kw)


def _flatten(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _cfgs():
    return tconfigs.get_config(ARCH, smoke=True), \
        jconfigs.get_config(ARCH, smoke=True)


@functools.lru_cache(maxsize=None)
def _reference_params():
    _, jcfg = _cfgs()
    params = jinit_from_defs(jencdec.defs(jcfg), jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, params)


def _params():
    return params_from_jax(_reference_params(), "cpu")


def _jparams():
    return jax.tree_util.tree_map(jnp.asarray, _reference_params())


def _batch(step: int = 0, batch: int = 2, seq: int = 64):
    return tlaunch.make_batch(_cfgs()[0], batch, seq, 0, step, device="cpu")


def _jbatch(batch):
    return {k: jnp.asarray(v.numpy()) for k, v in batch.items()}


def test_defs_and_cache_defs_match_reference():
    for smoke in (False, True):
        cfg = tconfigs.get_config(ARCH, smoke=smoke)
        jcfg = jconfigs.get_config(ARCH, smoke=smoke)
        for mine, theirs in ((encdec.defs(cfg), jencdec.defs(jcfg)),
                             (encdec.cache_defs(cfg, 3, 50, 20),
                              jencdec.cache_defs(jcfg, 3, 50, 20))):
            mine, theirs = dict(_flatten(mine)), dict(_flatten(theirs))
            assert mine.keys() == theirs.keys()
            for k, d in mine.items():
                t = theirs[k]
                assert isinstance(d, Def)
                assert (d.shape, d.axes, d.init, d.scale, d.fan_in_dims) == (
                    t.shape, t.axes, t.init, t.scale, t.fan_in_dims), k


def test_params_from_jax_carries_the_nested_tree():
    """``frontend_proj``, the stacked encoder and decoder layers and the
    decoder's nested ``cross`` projections, bit for bit."""
    mine = dict(_flatten(_params()))
    theirs = dict(_flatten(_reference_params()))
    assert mine.keys() == theirs.keys()
    assert ("dec_layers", "cross", "wq") in mine
    assert ("frontend_proj",) in mine
    for k, t in mine.items():
        assert t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), theirs[k])
    assert get_module(_cfgs()[0]) is encdec


def test_make_batch_draws_frames_and_cuts_the_target():
    """The reference's draw: tokens (B, S + 1) from default_rng(seed +
    step), then frames (B, S, D) from the same generator, tokens and
    labels cut to St = max(S // target_ratio, 16)."""
    cfg, _ = _cfgs()
    for seq, St in ((64, 16), (256, 32)):
        rng = np.random.default_rng(0 + 3)
        toks = rng.integers(0, cfg.vocab_size, size=(2, seq + 1))
        frames = rng.normal(size=(2, seq, cfg.d_model)).astype(np.float32)
        got = tlaunch.make_batch(cfg, 2, seq, 0, 3, device="cpu")
        np.testing.assert_array_equal(got["tokens"].numpy(), toks[:, :St])
        np.testing.assert_array_equal(got["labels"].numpy(), toks[:, 1:St + 1])
        np.testing.assert_array_equal(got["frames"].numpy(), frames)
        assert serve_lm.target_len(cfg, seq) == St


def test_encode_and_decode_train_match_reference():
    cfg, jcfg = _cfgs()
    batch = _batch()
    with torch.no_grad():
        enc = encdec.encode(cfg, _params(), batch["frames"], mode="prefill")
        logits = encdec.decode_train(cfg, _params(), enc, batch["tokens"],
                                     mode="prefill")
    jenc = jencdec.encode(jcfg, _jparams(), jnp.asarray(batch["frames"]),
                          dist=DIST, mode="prefill")
    assert enc.dtype == torch.bfloat16 and enc.shape == jenc.shape
    _close(enc, jenc)
    # the decoder from the same (port's) encoder states
    jlogits = jencdec.decode_train(jcfg, _jparams(), _to_jax(enc),
                                   jnp.asarray(batch["tokens"].numpy()),
                                   dist=DIST, mode="prefill")
    assert logits.shape == jlogits.shape == (2, 16, cfg.padded_vocab)
    _close(logits, jlogits)


@pytest.mark.parametrize("Sq,Sk", [(5, 37), (16, 16)])
def test_cross_attention_matches_reference(Sq, Sk):
    """Both modes on one layer's cross weights: the flash path (not causal,
    Sq != Sk, no rope) and decode (every encoder slot visible)."""
    cfg, jcfg = _cfgs()
    p = {k: v[0] for k, v in _params()["dec_layers"]["cross"].items()}
    jp = {k: jnp.asarray(v.numpy()) for k, v in p.items()}
    rng = np.random.default_rng(Sq)
    x = torch.from_numpy(rng.standard_normal((2, Sq, cfg.d_model)).astype(
        np.float32)).bfloat16()
    enc = torch.from_numpy(rng.standard_normal((2, Sk, cfg.d_model)).astype(
        np.float32)).bfloat16()
    kv = attention.make_cross_kv(cfg, p, enc)
    jkv = jattention.make_cross_kv(jcfg, jp, _to_jax(enc), DIST)
    for a, b in zip(kv, jkv):
        _close(a, b)
    for mode, xs in (("prefill", x), ("decode", x[:, :1])):
        got = attention.cross_attention(cfg, p, xs, kv, mode=mode)
        want = jattention.cross_attention(jcfg, jp, _to_jax(xs),
                                          tuple(_to_jax(t) for t in kv),
                                          dist=DIST, mode=mode)
        _close(got, want, err_msg=mode)
    # decode sees every slot: the same as the flash path on that query
    dec = attention.cross_attention(cfg, p, x[:, :1], kv, mode="decode")
    full = attention.cross_attention(cfg, p, x[:, :1], kv, mode="prefill")
    _close(dec, full)


def test_encoder_self_attention_is_bidirectional():
    """``causal=False`` lets the first position see the last: changing the
    last frame moves the encoder's first output, and with ``causal=True``
    it would not."""
    cfg, _ = _cfgs()
    p = {k: v[0] for k, v in _params()["enc_layers"].items()}
    x = torch.randn((1, 9, cfg.d_model),
                    generator=torch.Generator().manual_seed(3)).bfloat16()
    y = x.clone()
    y[:, -1] += 1.0
    for causal, moves in ((False, True), (True, False)):
        a = attention.self_attention(cfg, p, x, causal=causal)
        b = attention.self_attention(cfg, p, y, causal=causal)
        assert bool((a[:, 0] != b[:, 0]).any()) == moves


def test_loss_and_grads_match_reference():
    cfg, jcfg = _cfgs()
    batch = _batch(1)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jencdec.loss_fn(jcfg, p, _jbatch(batch), dist=DIST),
        has_aux=True))(_jparams())
    leaves = toptimizer.tree_map(lambda p: p.detach().requires_grad_(),
                                 _params())
    loss, metrics = encdec.loss_fn(cfg, leaves, batch)
    loss.backward()
    loss = loss.detach()
    assert abs(float(loss) - float(jloss)) <= ATOL + RTOL * abs(float(jloss))
    assert float(metrics["ce"].detach()) == float(loss)
    jg = dict(_flatten(jax.tree_util.tree_map(np.asarray, jgrads)))
    for k, p in _flatten(leaves):
        g = p.grad.numpy()
        err = np.linalg.norm(g - jg[k]) / max(np.linalg.norm(jg[k]), 1e-30)
        assert err <= GRAD_REL, (k, err)


def test_remat_gives_the_same_loss_and_gradients():
    cfg, _ = _cfgs()
    batch = _batch(2)
    out = []
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        leaves = toptimizer.tree_map(lambda p: p.detach().requires_grad_(),
                                     _params())
        loss, _ = encdec.loss_fn(c, leaves, batch)
        loss.backward()
        out.append((float(loss.detach()),
                    [p.grad for _, p in _flatten(leaves)]))
    assert out[0][0] == out[1][0]
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)


@functools.lru_cache(maxsize=None)
def _reference_serving():
    """The reference's serving prefill (``launch/specs.py``'s three calls,
    here with ``max_tgt`` = prompt + new self slots) and 4 greedy decode
    steps, with the cache after the prefill and after each step."""
    _, jcfg = _cfgs()
    St = max(FRAMES // jcfg.target_ratio, 16)
    frames = np.random.default_rng(0).normal(
        size=(B, FRAMES, jcfg.d_model)).astype(np.float32)
    prompts = np.random.default_rng(1).integers(0, jcfg.vocab_size,
                                                (B, St)).astype(np.int32)

    @jax.jit
    def prefill(p, f, t):
        enc = jencdec.encode(jcfg, p, f, dist=DIST, mode="prefill")
        cache = jencdec.make_cache(jcfg, p, enc, St + NEW, dist=DIST)
        logits = jencdec.decode_train(jcfg, p, enc, t, dist=DIST,
                                      mode="prefill")
        return logits[:, -1:], cache

    step = jax.jit(lambda p, c, t, pos: jencdec.decode_step(
        jcfg, p, c, t, pos, dist=DIST))
    params = _jparams()
    logits, cache = prefill(params, jnp.asarray(frames), jnp.asarray(prompts))
    V = jcfg.vocab_size
    tok = jnp.argmax(logits[:, -1:, :V], -1).astype(jnp.int32)
    toks, outs = [tok], [_f32(logits[:, :, :V])]
    caches = [jax.tree_util.tree_map(_f32, cache)]
    for i in range(NEW - 1):
        lg, cache = step(params, cache, tok, jnp.int32(St + i))
        tok = jnp.argmax(lg[:, :, :V], -1).astype(jnp.int32)
        toks.append(tok)
        outs.append(_f32(lg[:, :, :V]))
        caches.append(jax.tree_util.tree_map(_f32, cache))
    return {"frames": frames, "prompts": prompts,
            "tokens": np.asarray(jnp.concatenate(toks, 1)),
            "logits": np.concatenate(outs, 1), "caches": caches}


def test_prefill_and_decode_match_reference():
    """The prefill's logits and caches (cross k and v; the self cache all
    zero, as the reference's), then 4 decode steps fed the reference's
    greedy tokens: logits and caches after each step."""
    ref = _reference_serving()
    cfg, _ = _cfgs()
    St = ref["prompts"].shape[1]
    params = _params()
    with torch.inference_mode():
        logits, cache = encdec.prefill(
            cfg, params, {"frames": torch.from_numpy(ref["frames"]),
                          "tokens": torch.from_numpy(ref["prompts"])},
            max_len=St + NEW)
    V = cfg.vocab_size
    assert logits.shape == (B, 1, cfg.padded_vocab)
    _close(logits[:, :, :V], ref["logits"][:, :1])
    for k, v in cache.items():
        assert v.dtype == torch.bfloat16
        assert tuple(v.shape) == ref["caches"][0][k].shape, k
        _close(v, ref["caches"][0][k], err_msg=k)
    assert not cache["self_k"].any() and not cache["self_v"].any()
    toks = torch.from_numpy(ref["tokens"].astype(np.int64))
    with torch.inference_mode():
        for i in range(NEW - 1):
            logits, cache = encdec.decode_step(cfg, params, cache,
                                               toks[:, i:i + 1], St + i)
            _close(logits[:, :, :V], ref["logits"][:, i + 1:i + 2],
                   atol=DECODE_ATOL, err_msg=f"step {i}")
            for k in ("self_k", "self_v"):
                _close(cache[k], ref["caches"][i + 1][k],
                       err_msg=f"step {i} {k}")
    # slots before the prompt's end stay zero; the decoded ones are filled
    assert not cache["self_k"][:, :, :St].any()
    assert cache["self_k"][:, :, St + NEW - 2].any()
    assert not cache["self_k"][:, :, St + NEW - 1].any()


def test_prefill_self_cache_defaults_to_the_prompt_length():
    """Without ``max_len`` the self cache has the prompt's St slots, as the
    reference's serving prefill sizes it."""
    ref = _reference_serving()
    cfg, _ = _cfgs()
    with torch.inference_mode():
        _, cache = encdec.prefill(
            cfg, _params(), {"frames": torch.from_numpy(ref["frames"][:1]),
                             "tokens": torch.from_numpy(ref["prompts"][:1])})
    assert cache["self_k"].shape[2] == ref["prompts"].shape[1]
    assert cache["cross_k"].shape[2] == FRAMES


def test_prefill_reads_the_cross_cache_bit_for_bit():
    """The prefill's decoder reads each layer's cross k and v from the
    cache it built: its logits are the last position of ``decode_train``
    (which computes them), bit for bit, and the cache holds those k and
    v."""
    ref = _reference_serving()
    cfg, _ = _cfgs()
    params = _params()
    frames = torch.from_numpy(ref["frames"][:2])
    tokens = torch.from_numpy(ref["prompts"][:2])
    with torch.inference_mode():
        logits, cache = encdec.prefill(cfg, params, {"frames": frames,
                                                     "tokens": tokens})
        enc = encdec.encode(cfg, params, frames, mode="prefill")
        full = encdec.decode_train(cfg, params, enc, tokens, mode="prefill")
        for l in (0, cfg.n_dec_layers - 1):
            k, v = attention.make_cross_kv(
                cfg, encdec._layer(params["dec_layers"], l)["cross"], enc)
            assert torch.equal(cache["cross_k"][l], k)
            assert torch.equal(cache["cross_v"][l], v)
    assert torch.equal(logits, full[:, -1:])


def test_generate_serves_the_encoder_decoder():
    """``generate`` with frames: the prefill's first token and logits as
    the reference's, its logits the argmax's source; without frames it
    refuses."""
    ref = _reference_serving()
    cfg, _ = _cfgs()
    gen = serve_lm.generate(cfg, _params(), ref["prompts"], NEW,
                            frames=ref["frames"], device="cpu")
    assert gen.tokens.shape == (B, NEW)
    assert gen.logits.shape == (B, NEW, cfg.vocab_size)
    np.testing.assert_array_equal(gen.tokens.numpy(),
                                  gen.logits.float().argmax(-1).numpy())
    _close(gen.logits[:, :1], ref["logits"][:, :1])
    with pytest.raises(ValueError, match="frames"):
        serve_lm.generate(cfg, _params(), ref["prompts"], 2, device="cpu")


def test_serve_cli_runs_the_encoder_decoder_on_the_cpu(capsys):
    assert serve_lm.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                          "--batch", "2", "--prompt", "40", "--new",
                          "3"]) == 0
    out = capsys.readouterr().out
    assert "seamless-smoke on cpu" in out and "16-token prompts" in out


def test_train_cli_runs_the_encoder_decoder_on_the_cpu(capsys):
    losses = tlaunch.main(["--arch", ARCH, "--smoke", "--steps", "2",
                           "--batch", "2", "--seq", "64", "--device", "cpu"])
    assert len(losses) == 2 and np.isfinite(losses).all()
