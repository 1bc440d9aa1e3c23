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

Serving on a mesh (``prefill`` and ``decode_step`` with ``dist`` a
``models.sharding.Distribution`` that has one; parameters laid out by
``params.shard_params``): the reference's layouts over ``Sharded`` values.
The embedding lookup is vocab-sharded (each position looks up the rows it
holds, zeros elsewhere, and a ``psum`` over the vocab axis adds them: one
nonzero row per token, so exact; the reference's ``embed_gather=
"shard_map"`` path, taken for ``"auto"`` too); every other weight is
gathered whole at its use and the experts stay sharded; activations are
sharded (batch, seq) in prefill and (batch) in decode; the logits are
vocab-sharded; the caches are (batch, kv_seq)-sharded per position and
written in place.  ``dist=None`` (or a ``Distribution`` without a mesh)
is the meshless path below, unchanged.  Training on a mesh raises
(``MESH_TRAIN``).

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
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import flash_attention, rms_norm, rope, swiglu_mlp
from repro_torch.models.params import Def
from repro_torch.models.sharding import MESH_TRAIN, no_mesh, on_mesh
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


def embed_tokens(cfg: ModelConfig, params: dict, tokens,
                 dtype: torch.dtype = torch.bfloat16, *, dist=None):
    """The tokens' embedding rows in ``dtype``; on a mesh, the
    vocab-sharded lookup (module doc), constrained (batch, seq, embed)."""
    if not on_mesh(dist):
        return params["embed"][tokens.long()].to(dtype)
    tokens = dist.constrain(tokens, "batch", None)
    table = params["embed"]  # (vocab, embed): "embed" is never sharded
    vax = table.spec[0]
    if not vax:
        x = dist.map(lambda tab, toks: tab[toks.long()].to(dtype), table,
                     tokens, spec=tokens.spec + ((),))
    else:
        rows = table.local_shape[0]

        def local(i, tab, toks):
            loc = toks.long() - dist.mesh.rank(i, vax) * rows
            ok = (loc >= 0) & (loc < rows)
            x = tab[loc.clamp(0, rows - 1)]
            zero = torch.zeros((), dtype=x.dtype, device=x.device)
            return torch.where(ok[..., None], x, zero).to(dtype)

        x = dist.psum(dist.map(local, table, tokens, pos=True,
                               spec=tokens.spec + ((),)), vax)
    return dist.constrain(x, "batch", "seq", "embed")


def unembed(cfg: ModelConfig, params: dict, x, *, dist=None):
    """Logits in x's type; on a mesh vocab-sharded (each position
    multiplies by the vocab rows it holds), constrained (batch, None,
    vocab)."""
    w = params.get("lm_head")
    if not on_mesh(dist):
        if w is None:  # tied: the embedding's transpose
            return x @ params["embed"].to(x.dtype).T
        return x @ w.to(x.dtype)
    if w is None:  # (vocab, embed): "embed" is never sharded
        tab = params["embed"]
        logits = dist.map(lambda xi, ti: xi @ ti.to(xi.dtype).T, x, tab,
                          spec=x.spec[:-1] + (tab.spec[0],))
    else:
        logits = dist.map(lambda xi, wi: xi @ wi.to(xi.dtype), x, w,
                          spec=x.spec[:-1] + (w.spec[1],))
    return dist.constrain(logits, "batch", None, "vocab")


def _mlp_block(cfg: ModelConfig, p: dict, x: torch.Tensor, mode: str):
    """The FFN behind its pre-norm and residual add: (x + ffn, aux).  The
    MoE FFN runs its ``mode``'s dispatch and gives its router loss; the
    dense MLP gives aux 0.0."""
    h = rms_norm(x, p["mlp_norm"], cfg.norm_eps)
    if cfg.n_experts > 0:
        y, aux = moe_mod.moe_block(cfg, p, h, mode=mode)
        return x + y, aux
    return x + swiglu_mlp(p, h), 0.0


def forward(cfg: ModelConfig, params: dict, tokens: torch.Tensor, *,
            dist=None):
    """Full-sequence forward.  Returns (logits (B, S, V), aux loss: the
    layers' mean router loss, 0.0 for a dense config).  Not on a mesh
    (``MESH_TRAIN``)."""
    no_mesh(dist, MESH_TRAIN)
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
                   mode: str = "train", dist=None):
    """Forward up to the final norm (pre-unembed); (hidden, aux), aux the
    layers' summed router loss over the number of layers, as the
    reference's (0.0 for a dense config).  ``mode`` picks the MoE
    dispatch (``"train"``/``"prefill"``: capacity buffers; ``"decode"``:
    dense).  With ``cfg.remat`` and ``mode == "train"`` each layer is
    checkpointed when autograd records (nothing to recompute otherwise).
    Not on a mesh (``MESH_TRAIN``)."""
    no_mesh(dist, MESH_TRAIN)
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


def loss_fn(cfg: ModelConfig, params: dict, batch: dict, *, dist=None):
    """Next-token CE (labels = tokens shifted by the caller; labels < 0
    masked) plus 0.01 times the router loss.  Returns (loss, {"ce",
    "aux"}); aux is 0.0 for a dense config.

    With ``cfg.loss_chunk`` > 0 dividing S (and S > the chunk), the CE is
    summed chunk by chunk along the sequence, in order, as the reference's
    scan sums it; under autograd each chunk is checkpointed, so that only
    one chunk's logits exist at a time in the backward too.  Not on a
    mesh (``MESH_TRAIN``)."""
    no_mesh(dist, MESH_TRAIN)
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
                tokens: torch.Tensor, pos: int, *, dist=None):
    """One token for every sequence.  tokens (B, 1); ``pos`` (a host int)
    the position being written.  Writes each layer's k and v into
    ``cache`` in place; returns (logits (B, 1, V), cache).  On a mesh:
    ``decode_step_mesh``."""
    if on_mesh(dist):
        return decode_step_mesh(cfg, params, cache, tokens, pos, dist=dist)
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
            max_len: Optional[int] = None, dist=None):
    """Forward that also emits the KV cache (zero-padded to ``max_len``).
    Returns (logits of the last position (B, 1, V), cache).  On a mesh:
    ``prefill_mesh``."""
    if on_mesh(dist):
        return prefill_mesh(cfg, params, tokens, max_len=max_len, dist=dist)
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


# ------------------------------------------------------------------ mesh ----

def _layer_at_use(cfg: ModelConfig, params: dict, l: int, dist) -> dict:
    """Layer ``l``'s weights at use: each gathered whole on every position,
    but the experts, which keep their shards."""
    experts = ("w_gate", "w_up", "w_down") if cfg.n_experts > 0 else ()
    return {k: (dist.select(v, l) if k in experts
                else dist.gather_all(dist.select(v, l)))
            for k, v in params["layers"].items()}


def _norm(cfg: ModelConfig, x, scale, dist):
    return dist.map(lambda xi, si: rms_norm(xi, si, cfg.norm_eps), x, scale,
                    spec=x.spec)


def _mlp_block_mesh(cfg: ModelConfig, p: dict, x, mode: str, dist,
                    seq_axis):
    """``_mlp_block`` on a mesh: the FFN behind its pre-norm and residual
    add, the sum constrained (batch, seq_axis, embed).  The dense MLP's
    hidden dim is constrained to "ff" as in the reference (in decode it
    shards there, and the down projection sums its partial products)."""
    h = _norm(cfg, x, p["mlp_norm"], dist)
    if cfg.n_experts > 0:
        y, _ = moe_mod.moe_block_mesh(cfg, p, h, dist=dist, mode=mode)
    else:
        u = dist.map(lambda pi, hi: F.silu(hi @ pi["w_gate"].to(hi.dtype))
                     * (hi @ pi["w_up"].to(hi.dtype)), p, h, spec=h.spec)
        u = dist.constrain(u, "batch", seq_axis, "ff")
        y = dist.matmul(u, p["w_down"])
    x = dist.map(torch.add, x, y, spec=x.spec)
    return dist.constrain(x, "batch", seq_axis, "embed")


def _last_position(x, dist):
    """x[:, -1:] of a value sharded along its sequence: every position's
    last row all-gathered over the sequence axes, the last block's kept."""
    last = dist.map(lambda t: t[:, -1:], x, spec=x.spec)
    if x.spec[1]:
        last = dist.all_gather(last, 1)
        last = dist.map(lambda t: t[:, -1:], last, spec=last.spec)
    return last


def prefill_mesh(cfg: ModelConfig, params: dict, tokens, *,
                 max_len: Optional[int] = None, dist):
    """``prefill`` on ``dist``'s mesh (the reference's ``prefill`` under a
    mesh): tokens (B, S), a plain tensor or ``Sharded``; ``params`` laid
    out by ``params.shard_params``.  Returns (logits of the last position
    (B, 1, V) vocab-sharded, cache): the caches (L, B, max_len, Hkv, Dh)
    constrained (batch, kv_seq) per position (``Sharded``, zero past S)."""
    x = embed_tokens(cfg, params, tokens, dist=dist)
    B, S = x.shape[:2]
    max_len = max_len or S
    window, theta = layer_flags(cfg)
    cache = None
    for l in range(cfg.n_layers):
        p = _layer_at_use(cfg, params, l, dist)
        h = _norm(cfg, x, p["attn_norm"], dist)
        a, k, v = attn.self_attention_mesh(cfg, p, h, dist=dist,
                                           window=window[l], theta=theta[l])
        x = dist.map(torch.add, x, a, spec=x.spec)
        x = _mlp_block_mesh(cfg, p, x, "prefill", dist, "seq")
        full = (B, max_len) + k.shape[2:]
        spec = dist.layout("batch", "kv_seq", None, None, shape=full)
        if spec[0] != k.spec[0] or k.spec[1]:
            raise ValueError(f"k laid out {k.spec}, the cache {spec}")
        if cache is None:
            cache = {n: dist.map(lambda t: torch.zeros(
                (cfg.n_layers,) + t.shape[:1]
                + (max_len // dist.group_size(spec[1]),) + t.shape[2:],
                dtype=t.dtype, device=t.device), kv, spec=((),) + spec)
                for n, kv in (("k", k), ("v", v))}
        for n, kv in (("k", k), ("v", v)):
            for i in dist.mesh.active:
                c = cache[n].local(i)
                lo = dist.mesh.rank(i, spec[1]) * c.shape[2]
                hi = min(S, lo + c.shape[2])
                if hi > lo:
                    c[l, :, :hi - lo] = kv.local(i)[:, lo:hi]
    x = _norm(cfg, x, params["final_norm"], dist)
    return unembed(cfg, params, _last_position(x, dist), dist=dist), cache


def decode_step_mesh(cfg: ModelConfig, params: dict, cache: dict, tokens,
                     pos: int, *, dist):
    """``decode_step`` on ``dist``'s mesh: tokens (B, 1), a plain tensor or
    ``Sharded``; the caches as ``prefill_mesh`` gives them, written in
    place.  Returns (logits (B, 1, V) vocab-sharded, cache)."""
    x = embed_tokens(cfg, params, tokens, dist=dist)
    x = dist.constrain(x, "batch", None, "embed")
    window, theta = layer_flags(cfg)
    for l in range(cfg.n_layers):
        p = _layer_at_use(cfg, params, l, dist)
        h = _norm(cfg, x, p["attn_norm"], dist)
        layer_cache = {n: dist.select(cache[n], l) for n in ("k", "v")}
        a, _ = attn.decode_self_attention(
            cfg, p, h, layer_cache, pos, dist=dist, window=window[l],
            theta=theta[l])
        x = dist.map(torch.add, x, a, spec=x.spec)
        x = _mlp_block_mesh(cfg, p, x, "decode", dist, None)
    x = _norm(cfg, x, params["final_norm"], dist)
    return unembed(cfg, params, x, dist=dist), cache
