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
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import masked_ce, rms_norm, swiglu_mlp
from repro_torch.models.params import Def
from repro_torch.models.sharding import no_mesh


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


def encode(cfg: ModelConfig, params: dict, frames: torch.Tensor, *,
           mode: str = "train") -> torch.Tensor:
    """frames (B, S, D) -> the encoder's states (B, S, D) bf16.  With
    ``cfg.remat`` and ``mode == "train"`` each layer is checkpointed when
    autograd records."""
    x = frames.to(torch.bfloat16) @ params["frontend_proj"].to(torch.bfloat16)
    remat = cfg.remat and mode == "train" and torch.is_grad_enabled()
    for l in range(cfg.n_enc_layers):
        p = _layer(params["enc_layers"], l)
        x = (checkpoint(_enc_layer, cfg, p, x, use_reentrant=False) if remat
             else _enc_layer(cfg, p, x))
    return rms_norm(x, params["enc_norm"], cfg.norm_eps)


def decode_hidden(cfg: ModelConfig, params: dict, enc_out: torch.Tensor,
                  tokens: torch.Tensor, *, mode: str = "train",
                  cache: Optional[dict] = None):
    """The teacher-forced decoder over tokens (B, St) up to its final norm:
    (B, St, D).  With a ``cache`` (``make_cache``'s) each layer reads its
    cross k and v there instead of computing them."""
    x = params["dec_embed"][tokens.long()].to(torch.bfloat16)
    remat = cfg.remat and mode == "train" and torch.is_grad_enabled()
    for l in range(cfg.n_dec_layers):
        p = _layer(params["dec_layers"], l)
        kv = None if cache is None else (cache["cross_k"][l],
                                         cache["cross_v"][l])
        x = (checkpoint(_dec_layer, cfg, p, x, enc_out, mode, kv,
                        use_reentrant=False) if remat
             else _dec_layer(cfg, p, x, enc_out, mode, kv))
    return rms_norm(x, params["final_norm"], cfg.norm_eps)


def _unembed(params: dict, x: torch.Tensor) -> torch.Tensor:
    return x @ params["lm_head"].to(x.dtype)


def decode_train(cfg: ModelConfig, params: dict, enc_out: torch.Tensor,
                 tokens: torch.Tensor, *, mode: str = "train"):
    """Teacher-forced decoder; tokens (B, St) -> logits (B, St, V)."""
    return _unembed(params, decode_hidden(cfg, params, enc_out, tokens,
                                          mode=mode))


def forward(cfg: ModelConfig, params: dict, batch: dict, *,
            mode: str = "train", dist=None):
    """(logits (B, St, V), 0.0) for a batch of ``frames`` and ``tokens``."""
    no_mesh(dist)
    enc_out = encode(cfg, params, batch["frames"], mode=mode)
    return decode_train(cfg, params, enc_out, batch["tokens"], mode=mode), 0.0


def loss_fn(cfg: ModelConfig, params: dict, batch: dict, *, dist=None):
    """Next-token CE of the decoder over the unmasked labels.  Returns (ce,
    {"ce": ce})."""
    no_mesh(dist)
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


def make_cache(cfg: ModelConfig, params: dict, enc_out: torch.Tensor,
               max_tgt: int, *, dtype: torch.dtype = torch.bfloat16) -> dict:
    """The buffers of ``cache_defs`` on the encoder output's device: every
    decoder layer's cross k and v from the encoder's output, and an
    all-zero self cache of ``max_tgt`` slots."""
    B, S_enc = enc_out.shape[:2]
    cache = {n: torch.zeros(d.shape, dtype=dtype, device=enc_out.device)
             for n, d in cache_defs(cfg, B, S_enc, max_tgt).items()}
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
    (B, 1, V), cache)."""
    no_mesh(dist)
    tokens = batch["tokens"]
    enc_out = encode(cfg, params, batch["frames"], mode="prefill")
    cache = make_cache(cfg, params, enc_out, max_len or tokens.shape[1])
    x = decode_hidden(cfg, params, enc_out, tokens, mode="prefill",
                      cache=cache)
    return _unembed(params, x[:, -1:]), cache


def decode_step(cfg: ModelConfig, params: dict, cache: dict,
                tokens: torch.Tensor, pos: int, *, dist=None):
    """One decoder token for every sequence against the self and cross
    caches.  tokens (B, 1); ``pos`` (a host int) the self-cache slot
    written, in place.  Returns (logits (B, 1, V), cache)."""
    no_mesh(dist)
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
