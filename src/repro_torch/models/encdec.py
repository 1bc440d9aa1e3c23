"""Encoder-decoder transformer backbone (seamless-m4t-large-v2).

The modality frontend is a stub, as in the reference: the batch carries
precomputed frame embeddings ``frames`` (B, S, d_model).  Encoder: a stack
of bidirectional self-attention layers; decoder: causal self attention,
cross attention over the encoder's output, the MLP.  Decode keeps two
caches per decoder layer: the self-attention k and v (written one slot a
step, in place, as ``transformer.decode_step`` does) and the cross k and v
(computed once from the encoder's output, read every step).

``prefill`` is the reference's serving prefill (``launch/specs.py``):
``encode``, then ``make_cache`` (the cross caches, an all-zero self
cache), then the teacher-forced decoder over the prompt, which writes no
k or v.  So the self cache holds zeros at the prompt's slots, and decode
attends to those zero keys as if they were filled, as the reference's does.

On a mesh (``dist`` a ``models.sharding.Distribution`` with one;
parameters laid out by ``params.shard_params``, ZeRO-3's layout too) every
entry point runs over ``Sharded`` values, the transformer's way: frames and
activations (batch, seq) between the layers, the encoder's attention not
causal, the cross k and v (batch, kv_seq) (``attention.make_cross_kv`` and
``cross_attention`` with ``dist``), the vocab-sharded embedding and
logits, the caches laid out by ``cache_defs``.  Weights are gathered whole
at their use inside each layer, so that with ``cfg.remat`` each layer is
one ``models.sharding.remat`` region whose recompute gathers them again.
The CE is ``transformer.mean_ce_mesh``, unchunked as the reference's
``loss_fn``.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import transformer
from repro_torch.models.layers import masked_ce, rms_norm, swiglu_mlp
from repro_torch.models.params import Def
from repro_torch.models.sharding import on_mesh, remat


def defs(cfg: ModelConfig) -> dict:
    Le, Ld = cfg.n_enc_layers, cfg.n_dec_layers
    D, V = cfg.d_model, cfg.padded_vocab
    enc_layer = {
        "attn_norm": Def((Le, D), ("layers", "embed"), init="zeros"),
        "mlp_norm": Def((Le, D), ("layers", "embed"), init="zeros"),
        **attn.attn_defs(cfg, stack=Le),
        "w_gate": Def((Le, D, cfg.d_ff), ("layers", "embed", "ff")),
        "w_up": Def((Le, D, cfg.d_ff), ("layers", "embed", "ff")),
        "w_down": Def((Le, cfg.d_ff, D), ("layers", "ff", "embed")),
    }
    dec_layer = {
        "attn_norm": Def((Ld, D), ("layers", "embed"), init="zeros"),
        "cross_norm": Def((Ld, D), ("layers", "embed"), init="zeros"),
        "mlp_norm": Def((Ld, D), ("layers", "embed"), init="zeros"),
        **attn.attn_defs(cfg, stack=Ld),
        "cross": attn.attn_defs(cfg, stack=Ld),
        "w_gate": Def((Ld, D, cfg.d_ff), ("layers", "embed", "ff")),
        "w_up": Def((Ld, D, cfg.d_ff), ("layers", "embed", "ff")),
        "w_down": Def((Ld, cfg.d_ff, D), ("layers", "ff", "embed")),
    }
    return {
        "frontend_proj": Def((D, D), ("embed", None)),
        "enc_layers": enc_layer,
        "enc_norm": Def((D,), ("embed",), init="zeros"),
        "dec_embed": Def((V, D), ("vocab", "embed"), scale=0.02),
        "dec_layers": dec_layer,
        "final_norm": Def((D,), ("embed",), init="zeros"),
        "lm_head": Def((D, V), ("embed", "vocab")),
    }


def _layer(stack: dict, l: int) -> dict:
    """Layer ``l``'s slice of a stacked parameter tree (views), nested
    dicts (the decoder's ``cross``) included."""
    return {n: (_layer(a, l) if isinstance(a, dict) else a[l])
            for n, a in stack.items()}


def _enc_layer(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    h = rms_norm(x, p["attn_norm"], cfg.norm_eps)
    x = x + attn.self_attention(cfg, p, h, causal=False)
    h = rms_norm(x, p["mlp_norm"], cfg.norm_eps)
    return x + swiglu_mlp(p, h)


def _dec_layer(cfg: ModelConfig, p: dict, x: torch.Tensor,
               enc_out: torch.Tensor, mode: str,
               enc_kv: Optional[tuple] = None) -> torch.Tensor:
    """One decoder layer; the cross k and v from ``enc_out`` unless given
    (``enc_kv``, a cache's)."""
    h = rms_norm(x, p["attn_norm"], cfg.norm_eps)
    x = x + attn.self_attention(cfg, p, h, causal=True)
    h = rms_norm(x, p["cross_norm"], cfg.norm_eps)
    if enc_kv is None:
        enc_kv = attn.make_cross_kv(cfg, p["cross"], enc_out)
    x = x + attn.cross_attention(cfg, p["cross"], h, enc_kv, mode=mode)
    h = rms_norm(x, p["mlp_norm"], cfg.norm_eps)
    return x + swiglu_mlp(p, h)


def encode(cfg: ModelConfig, params: dict, frames, *, mode: str = "train",
           dist=None):
    """frames (B, S, D) -> the encoder's states (B, S, D) bf16.  With
    ``cfg.remat`` and ``mode == "train"`` each layer is checkpointed when
    autograd records.  On a mesh the states are (batch, seq)-sharded."""
    if on_mesh(dist):
        return _encode_mesh(cfg, params, frames, mode, dist)
    x = frames.to(torch.bfloat16) @ params["frontend_proj"].to(torch.bfloat16)
    remat_on = cfg.remat and mode == "train" and torch.is_grad_enabled()
    for l in range(cfg.n_enc_layers):
        p = _layer(params["enc_layers"], l)
        x = (checkpoint(_enc_layer, cfg, p, x, use_reentrant=False)
             if remat_on else _enc_layer(cfg, p, x))
    return rms_norm(x, params["enc_norm"], cfg.norm_eps)


def decode_hidden(cfg: ModelConfig, params: dict, enc_out, tokens, *,
                  mode: str = "train", cache: Optional[dict] = None,
                  dist=None):
    """The teacher-forced decoder over tokens (B, St) up to its final norm:
    (B, St, D).  With a ``cache`` (``make_cache``'s) each layer reads its
    cross k and v there instead of computing them.  On a mesh the result
    is (batch, seq)-sharded."""
    if on_mesh(dist):
        return _decode_hidden_mesh(cfg, params, enc_out, tokens, mode, cache,
                                   dist)
    x = params["dec_embed"][tokens.long()].to(torch.bfloat16)
    remat_on = cfg.remat and mode == "train" and torch.is_grad_enabled()
    for l in range(cfg.n_dec_layers):
        p = _layer(params["dec_layers"], l)
        kv = None if cache is None else (cache["cross_k"][l],
                                         cache["cross_v"][l])
        x = (checkpoint(_dec_layer, cfg, p, x, enc_out, mode, kv,
                        use_reentrant=False) if remat_on
             else _dec_layer(cfg, p, x, enc_out, mode, kv))
    return rms_norm(x, params["final_norm"], cfg.norm_eps)


def _unembed(params: dict, x: torch.Tensor) -> torch.Tensor:
    return x @ params["lm_head"].to(x.dtype)


def decode_train(cfg: ModelConfig, params: dict, enc_out, tokens, *,
                 mode: str = "train", dist=None):
    """Teacher-forced decoder; tokens (B, St) -> logits (B, St, V) (on a
    mesh (batch, None, vocab))."""
    x = decode_hidden(cfg, params, enc_out, tokens, mode=mode, dist=dist)
    if on_mesh(dist):
        return transformer.unembed(cfg, params, x, dist=dist)
    return _unembed(params, x)


def forward(cfg: ModelConfig, params: dict, batch: dict, *,
            mode: str = "train", dist=None):
    """(logits (B, St, V), 0.0) for a batch of ``frames`` and ``tokens``."""
    enc_out = encode(cfg, params, batch["frames"], mode=mode, dist=dist)
    return decode_train(cfg, params, enc_out, batch["tokens"], mode=mode,
                        dist=dist), 0.0


def loss_fn(cfg: ModelConfig, params: dict, batch: dict, *, dist=None):
    """Next-token CE of the decoder over the unmasked labels.  Returns (ce,
    {"ce": ce}); on a mesh both replicated on every position."""
    if on_mesh(dist):
        enc_out = encode(cfg, params, batch["frames"], dist=dist)
        x = decode_hidden(cfg, params, enc_out, batch["tokens"], dist=dist)
        ce = transformer.mean_ce_mesh(cfg, params, x, batch["labels"], dist)
        return ce, {"ce": ce}
    logits, _ = forward(cfg, params, batch, mode="train")
    ce = masked_ce(logits, batch["labels"])
    return ce, {"ce": ce}


# ---------------------------------------------------------------- decode ----

def cache_defs(cfg: ModelConfig, batch: int, enc_len: int,
               max_tgt: int) -> dict:
    Ld, Hkv, Dh = cfg.n_dec_layers, cfg.n_kv_heads, cfg.resolved_head_dim
    return {
        "self_k": Def((Ld, batch, max_tgt, Hkv, Dh),
                      ("layers", "batch", "kv_seq", None, None), init="zeros"),
        "self_v": Def((Ld, batch, max_tgt, Hkv, Dh),
                      ("layers", "batch", "kv_seq", None, None), init="zeros"),
        "cross_k": Def((Ld, batch, enc_len, Hkv, Dh),
                       ("layers", "batch", "kv_seq", None, None), init="zeros"),
        "cross_v": Def((Ld, batch, enc_len, Hkv, Dh),
                       ("layers", "batch", "kv_seq", None, None), init="zeros"),
    }


def make_cache(cfg: ModelConfig, params: dict, enc_out, max_tgt: int, *,
               dtype: torch.dtype = torch.bfloat16, dist=None) -> dict:
    """The buffers of ``cache_defs`` on the encoder output's device: every
    decoder layer's cross k and v from the encoder's output, and an
    all-zero self cache of ``max_tgt`` slots.  On a mesh laid out by
    ``cache_defs`` (``Sharded``)."""
    B, S_enc = enc_out.shape[:2]
    defs = cache_defs(cfg, B, S_enc, max_tgt)
    if on_mesh(dist):
        cache = dist.zeros(defs, dtype)
        for l in range(cfg.n_dec_layers):
            p = dist.at_use(params["dec_layers"]["cross"], l)
            k, v = attn.make_cross_kv(cfg, p, enc_out, dist=dist)
            for name, t in (("cross_k", k), ("cross_v", v)):
                t = dist.reshard(t, cache[name].spec[1:])
                for i in dist.mesh.active:
                    cache[name].local(i)[l] = t.local(i)
        return cache
    cache = {n: torch.zeros(d.shape, dtype=dtype, device=enc_out.device)
             for n, d in defs.items()}
    for l in range(cfg.n_dec_layers):
        k, v = attn.make_cross_kv(cfg, _layer(params["dec_layers"], l)["cross"],
                                  enc_out)
        cache["cross_k"][l] = k
        cache["cross_v"][l] = v
    return cache


def prefill(cfg: ModelConfig, params: dict, batch: dict, *,
            max_len: Optional[int] = None, dist=None):
    """The serving prefill: ``encode`` the frames, ``make_cache`` with
    ``max_len`` self slots (default: the prompt's length), the
    teacher-forced decoder over the prompt ``batch["tokens"]`` (B, St),
    reading the cross k and v from the cache.  The self cache stays all
    zero (see the module's doc).  Returns (logits of the last position
    (B, 1, V), cache); on a mesh the logits vocab-sharded, the cache
    ``Sharded``."""
    tokens = batch["tokens"]
    enc_out = encode(cfg, params, batch["frames"], mode="prefill", dist=dist)
    cache = make_cache(cfg, params, enc_out, max_len or tokens.shape[1],
                       dist=dist)
    x = decode_hidden(cfg, params, enc_out, tokens, mode="prefill",
                      cache=cache, dist=dist)
    if on_mesh(dist):
        return transformer.unembed(cfg, params,
                                   transformer._last_position(x, dist),
                                   dist=dist), cache
    return _unembed(params, x[:, -1:]), cache


def decode_step(cfg: ModelConfig, params: dict, cache: dict,
                tokens: torch.Tensor, pos: int, *, dist=None):
    """One decoder token for every sequence against the self and cross
    caches.  tokens (B, 1); ``pos`` (a host int) the self-cache slot
    written, in place.  Returns (logits (B, 1, V), cache); on a mesh the
    logits vocab-sharded."""
    if on_mesh(dist):
        return _decode_step_mesh(cfg, params, cache, tokens, pos, dist)
    x = params["dec_embed"][tokens.long()].to(torch.bfloat16)
    for l in range(cfg.n_dec_layers):
        p = _layer(params["dec_layers"], l)
        h = rms_norm(x, p["attn_norm"], cfg.norm_eps)
        a, _ = attn.decode_self_attention(
            cfg, p, h, {"k": cache["self_k"][l], "v": cache["self_v"][l]}, pos)
        x = x + a
        h = rms_norm(x, p["cross_norm"], cfg.norm_eps)
        x = x + attn.cross_attention(
            cfg, p["cross"], h, (cache["cross_k"][l], cache["cross_v"][l]),
            mode="decode")
        h = rms_norm(x, p["mlp_norm"], cfg.norm_eps)
        x = x + swiglu_mlp(p, h)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _unembed(params, x), cache


# ------------------------------------------------------------------ mesh ----

_norm = transformer._norm


def _add(x, y, dist):
    return dist.map(torch.add, x, y, spec=x.spec)


def _enc_layer_mesh(cfg: ModelConfig, params: dict, l: int, x, mode: str,
                    dist):
    p = dist.at_use(params["enc_layers"], l)
    a = attn.self_attention_mesh(cfg, p, _norm(cfg, x, p["attn_norm"], dist),
                                 dist=dist, mode=mode, causal=False)[0]
    return transformer._mlp_block_mesh(cfg, p, _add(x, a, dist), mode, dist,
                                       "seq")[0]


def _encode_mesh(cfg: ModelConfig, params: dict, frames, mode: str, dist):
    frames = dist.constrain(frames, "batch", "seq", None)
    w = dist.gather_all(params["frontend_proj"])
    x = dist.map(lambda f, wi: f.to(torch.bfloat16) @ wi.to(torch.bfloat16),
                 frames, w, spec=frames.spec)
    x = dist.constrain(x, "batch", "seq", "embed")
    recompute = cfg.remat and mode == "train" and torch.is_grad_enabled()
    for l in range(cfg.n_enc_layers):
        args = (cfg, params, l, x, mode, dist)
        x = remat(_enc_layer_mesh, *args) if recompute \
            else _enc_layer_mesh(*args)
    return _norm(cfg, x, dist.gather_all(params["enc_norm"]), dist)


def _dec_layer_mesh(cfg: ModelConfig, params: dict, l: int, x, enc_out,
                    mode: str, kv, dist):
    """Decoder layer ``l`` on the mesh; the cross k and v from ``enc_out``
    unless given (``kv``, a cache's layer)."""
    p = dist.at_use(params["dec_layers"], l)
    a = attn.self_attention_mesh(cfg, p, _norm(cfg, x, p["attn_norm"], dist),
                                 dist=dist, mode=mode)[0]
    x = _add(x, a, dist)
    if kv is None:
        kv = attn.make_cross_kv(cfg, p["cross"], enc_out, dist=dist)
    a = attn.cross_attention(cfg, p["cross"],
                             _norm(cfg, x, p["cross_norm"], dist), kv,
                             mode=mode, dist=dist)
    return transformer._mlp_block_mesh(cfg, p, _add(x, a, dist), mode, dist,
                                       "seq")[0]


def _decode_hidden_mesh(cfg: ModelConfig, params: dict, enc_out, tokens,
                        mode: str, cache, dist):
    x = transformer.embed_tokens(cfg, {"embed": params["dec_embed"]},
                                 tokens, dist=dist)
    recompute = cfg.remat and mode == "train" and torch.is_grad_enabled()
    for l in range(cfg.n_dec_layers):
        kv = None if cache is None else tuple(
            dist.select(cache[n], l) for n in ("cross_k", "cross_v"))
        args = (cfg, params, l, x, enc_out, mode, kv, dist)
        x = remat(_dec_layer_mesh, *args) if recompute \
            else _dec_layer_mesh(*args)
    return _norm(cfg, x, dist.gather_all(params["final_norm"]), dist)


def _decode_step_mesh(cfg: ModelConfig, params: dict, cache: dict, tokens,
                      pos: int, dist):
    x = transformer.embed_tokens(cfg, {"embed": params["dec_embed"]},
                                 tokens, dist=dist)
    x = dist.constrain(x, "batch", None, "embed")
    for l in range(cfg.n_dec_layers):
        p = dist.at_use(params["dec_layers"], l)
        self_kv = {"k": dist.select(cache["self_k"], l),
                   "v": dist.select(cache["self_v"], l)}
        a, _ = attn.decode_self_attention(
            cfg, p, _norm(cfg, x, p["attn_norm"], dist), self_kv, pos,
            dist=dist)
        x = _add(x, a, dist)
        kv = tuple(dist.select(cache[n], l) for n in ("cross_k", "cross_v"))
        a = attn.cross_attention(cfg, p["cross"],
                                 _norm(cfg, x, p["cross_norm"], dist), kv,
                                 mode="decode", dist=dist)
        x, _ = transformer._mlp_block_mesh(cfg, p, _add(x, a, dist),
                                           "decode", dist, None)
    x = _norm(cfg, x, dist.gather_all(params["final_norm"]), dist)
    return transformer.unembed(cfg, params, x, dist=dist), cache
