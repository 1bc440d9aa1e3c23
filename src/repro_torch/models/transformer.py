"""Decoder-only LM of the dense and MoE families (and the vlm family's
early-fusion text path, which is the same network).  A config with
``n_experts > 0`` puts a mixture-of-experts FFN (``models/moe.py``) where
the dense layers have their SwiGLU MLP.

Parameters keep the reference's stacked layout: every per-layer weight has
a leading (L, ...) dim, and a Python loop over the layers takes the place
of the reference's ``lax.scan``.  Per-layer heterogeneity (gemma3's 5 local
: 1 global attention pattern and its per-layer rope theta) comes from
``layer_flags`` as host values.  Decode writes one token per step into
stacked KV caches (L, B, Smax, Hkv, Dh), in place.  Activations are bf16
over f32 master weights, cast at each use, as in the reference.

Training: ``loss_fn`` is the reference's next-token cross entropy.  With
``cfg.remat`` each layer of a ``mode="train"`` forward runs under
``torch.utils.checkpoint`` (the reference's ``jax.checkpoint(layer)``), and
with ``cfg.loss_chunk`` each chunk's CE runs under it too, so that neither
the layers' activations nor a chunk's (B, chunk, V) f32 logits are kept for
the backward: they are recomputed there.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import flash_attention, rms_norm, rope, swiglu_mlp
from repro_torch.models.params import Def
from repro_torch.utils import resolve_device

BIG_WINDOW = 1 << 30  # "no window": the global layers' window


def defs(cfg: ModelConfig) -> dict:
    L, D, V = cfg.n_layers, cfg.d_model, cfg.padded_vocab
    layer = {
        "attn_norm": Def((L, D), ("layers", "embed"), init="zeros"),
        "mlp_norm": Def((L, D), ("layers", "embed"), init="zeros"),
        **attn.attn_defs(cfg, stack=L),
    }
    if cfg.n_experts > 0:
        layer.update(moe_mod.moe_defs(cfg, stack=L))
    else:
        layer.update({
            "w_gate": Def((L, D, cfg.d_ff), ("layers", "embed", "ff")),
            "w_up": Def((L, D, cfg.d_ff), ("layers", "embed", "ff")),
            "w_down": Def((L, cfg.d_ff, D), ("layers", "ff", "embed")),
        })
    out = {
        "embed": Def((V, D), ("vocab", "embed"), scale=0.02),
        "layers": layer,
        "final_norm": Def((D,), ("embed",), init="zeros"),
    }
    if not cfg.tie_embeddings:
        out["lm_head"] = Def((D, V), ("embed", "vocab"))
    return out


def layer_flags(cfg: ModelConfig) -> tuple:
    """Per-layer (windows, rope thetas) as host lists.  With a local:global
    ratio N, every (N+1)-th layer (l % (N+1) == N) is global: no window
    (``BIG_WINDOW``) and ``global_rope_theta``."""
    L = cfg.n_layers
    if cfg.local_global_ratio > 0:
        per = cfg.local_global_ratio + 1
        is_global = [l % per == cfg.local_global_ratio for l in range(L)]
        window = [BIG_WINDOW if g else cfg.sliding_window for g in is_global]
        theta = [(cfg.global_rope_theta or cfg.rope_theta) if g
                 else cfg.rope_theta for g in is_global]
    else:
        w = cfg.sliding_window if cfg.sliding_window > 0 else BIG_WINDOW
        window = [w] * L
        theta = [cfg.rope_theta] * L
    return window, [float(t) for t in theta]


def _layer(params: dict, l: int) -> dict:
    """Layer ``l``'s slice of the stacked parameters (views, no copies)."""
    return {k: v[l] for k, v in params["layers"].items()}


def embed_tokens(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
                 dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    return params["embed"][tokens.long()].to(dtype)


def unembed(cfg: ModelConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    w = params.get("lm_head")
    if w is None:  # tied: the embedding's transpose
        return x @ params["embed"].to(x.dtype).T
    return x @ w.to(x.dtype)


def _mlp_block(cfg: ModelConfig, p: dict, x: torch.Tensor, mode: str):
    """The FFN behind its pre-norm and residual add: (x + ffn, aux).  The
    MoE FFN runs its ``mode``'s dispatch and gives its router loss; the
    dense MLP gives aux 0.0."""
    h = rms_norm(x, p["mlp_norm"], cfg.norm_eps)
    if cfg.n_experts > 0:
        y, aux = moe_mod.moe_block(cfg, p, h, mode=mode)
        return x + y, aux
    return x + swiglu_mlp(p, h), 0.0


def forward(cfg: ModelConfig, params: dict, tokens: torch.Tensor):
    """Full-sequence forward.  Returns (logits (B, S, V), aux loss: the
    layers' mean router loss, 0.0 for a dense config)."""
    x, aux = forward_hidden(cfg, params, tokens)
    return unembed(cfg, params, x), aux


def _block(cfg: ModelConfig, p: dict, x: torch.Tensor, window: int,
           theta: float, mode: str):
    """One decoder layer: attention and FFN, each behind a pre-norm and a
    residual add.  Returns (x, the layer's aux loss)."""
    h = rms_norm(x, p["attn_norm"], cfg.norm_eps)
    x = x + attn.self_attention(cfg, p, h, window=window, theta=theta)
    return _mlp_block(cfg, p, x, mode)


def forward_hidden(cfg: ModelConfig, params: dict, tokens: torch.Tensor, *,
                   mode: str = "train"):
    """Forward up to the final norm (pre-unembed); (hidden, aux), aux the
    layers' summed router loss over the number of layers, as the
    reference's (0.0 for a dense config).  ``mode`` picks the MoE
    dispatch (``"train"``/``"prefill"``: capacity buffers; ``"decode"``:
    dense).  With ``cfg.remat`` and ``mode == "train"`` each layer is
    checkpointed when autograd records (nothing to recompute otherwise)."""
    x = embed_tokens(cfg, params, tokens)
    window, theta = layer_flags(cfg)
    remat = cfg.remat and mode == "train" and torch.is_grad_enabled()
    aux = 0.0
    for l in range(cfg.n_layers):
        p = _layer(params, l)
        if remat:
            x, a = checkpoint(_block, cfg, p, x, window[l], theta[l], mode,
                              use_reentrant=False)
        else:
            x, a = _block(cfg, p, x, window[l], theta[l], mode)
        aux = aux + a
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, aux / cfg.n_layers


def _ce(cfg: ModelConfig, params: dict, x: torch.Tensor,
        labels: torch.Tensor):
    """(sum of the token CEs, number of tokens) over the unmasked labels
    (labels < 0 are masked), from f32 logits."""
    logits = unembed(cfg, params, x).float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.clamp_min(0).long()[..., None])[..., 0]
    mask = (labels >= 0).float()
    return ((lse - ll) * mask).sum(), mask.sum()


def loss_fn(cfg: ModelConfig, params: dict, batch: dict):
    """Next-token CE (labels = tokens shifted by the caller; labels < 0
    masked) plus 0.01 times the router loss.  Returns (loss, {"ce",
    "aux"}); aux is 0.0 for a dense config.

    With ``cfg.loss_chunk`` > 0 dividing S (and S > the chunk), the CE is
    summed chunk by chunk along the sequence, in order, as the reference's
    scan sums it; under autograd each chunk is checkpointed, so that only
    one chunk's logits exist at a time in the backward too."""
    hidden, aux = forward_hidden(cfg, params, batch["tokens"], mode="train")
    labels = batch["labels"]
    S = hidden.shape[1]
    chunk = cfg.loss_chunk
    if chunk and S % chunk == 0 and S > chunk:
        se = cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
        for c in range(0, S, chunk):
            h, lab = hidden[:, c:c + chunk], labels[:, c:c + chunk]
            if torch.is_grad_enabled():
                s_c, n_c = checkpoint(_ce, cfg, params, h, lab,
                                      use_reentrant=False)
            else:
                s_c, n_c = _ce(cfg, params, h, lab)
            se, cnt = se + s_c, cnt + n_c
    else:
        se, cnt = _ce(cfg, params, hidden, labels)
    ce = se / cnt.clamp_min(1.0)
    loss = ce + 0.01 * aux
    return loss, {"ce": ce, "aux": aux}


# ---------------------------------------------------------------- decode ----

def cache_defs(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    L, Hkv, Dh = cfg.n_layers, cfg.n_kv_heads, cfg.resolved_head_dim
    return {
        "k": Def((L, batch, max_len, Hkv, Dh),
                 ("layers", "batch", "kv_seq", None, None), init="zeros"),
        "v": Def((L, batch, max_len, Hkv, Dh),
                 ("layers", "batch", "kv_seq", None, None), init="zeros"),
    }


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16, device="cuda") -> dict:
    """Zeroed k and v caches (L, batch, max_len, Hkv, Dh) on ``device``
    (the card unless the caller asks for the CPU; raises without one)."""
    L, Hkv, Dh = cfg.n_layers, cfg.n_kv_heads, cfg.resolved_head_dim
    shape = (L, batch, max_len, Hkv, Dh)
    device = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def decode_step(cfg: ModelConfig, params: dict, cache: dict,
                tokens: torch.Tensor, pos: int):
    """One token for every sequence.  tokens (B, 1); ``pos`` (a host int)
    the position being written.  Writes each layer's k and v into
    ``cache`` in place; returns (logits (B, 1, V), cache)."""
    x = embed_tokens(cfg, params, tokens)
    window, theta = layer_flags(cfg)
    for l in range(cfg.n_layers):
        p = _layer(params, l)
        h = rms_norm(x, p["attn_norm"], cfg.norm_eps)
        a, _ = attn.decode_self_attention(
            cfg, p, h, {"k": cache["k"][l], "v": cache["v"][l]}, pos,
            window=window[l], theta=theta[l])
        x, _ = _mlp_block(cfg, p, x + a, "decode")
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return unembed(cfg, params, x), cache


def prefill(cfg: ModelConfig, params: dict, tokens: torch.Tensor, *,
            max_len: Optional[int] = None):
    """Forward that also emits the KV cache (zero-padded to ``max_len``).
    Returns (logits of the last position (B, 1, V), cache)."""
    x = embed_tokens(cfg, params, tokens)
    B, S = x.shape[:2]
    max_len = max_len or S
    window, theta = layer_flags(cfg)
    positions = torch.arange(S, device=x.device)
    cache = init_cache(cfg, B, max_len, dtype=x.dtype, device=x.device)
    for l in range(cfg.n_layers):
        p = _layer(params, l)
        h = rms_norm(x, p["attn_norm"], cfg.norm_eps)
        q, k, v = attn._project(cfg, p, h)
        q = rope(q, positions, theta[l])
        k = rope(k, positions, theta[l])
        o = flash_attention(q, k, v, causal=True, window=window[l])
        x, _ = _mlp_block(cfg, p, x + attn._out(cfg, p, o), "prefill")
        cache["k"][l, :, :S] = k
        cache["v"][l, :, :S] = v
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return unembed(cfg, params, x[:, -1:]), cache
