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
is the meshless path below, unchanged.

Training on a mesh (``forward``, ``forward_hidden`` and ``loss_fn`` with
``dist``): the activations are sharded (batch, seq) between the layers; the
attention runs in ``cfg.attn_layout`` (``models/attention.py``); with
``cfg.remat`` each layer is checkpointed with its weights gathered inside
it, so that the backward's recompute gathers them again (and logs those
collectives) rather than keep them.  ZeRO-3 leaves (dim 0 sharded over
"data", the stacked layers' too) are fetched one layer at a time
(``Distribution.select``).  The CE reads whole sequences: the hidden state
is gathered along its sequence, each position multiplies by its vocab
shard, the logsumexp is a ``pmax`` (a constant shift) and a ``psum`` of
the exp-sums over the vocab axes, the label's logit comes from the shard
that owns it, and the CE's sum and count are summed over the batch axes;
the loss is replicated on every position, and a caller seeds its gradient
once (``launch.train.train_step``).

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
from repro_torch.models.sharding import on_mesh, remat
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
    vocab-sharded lookup (module doc), constrained (batch, seq, embed).
    Its gradient is each position's scatter-add into the rows it holds
    (the ``psum``'s transpose sums the copies' gradients first): the
    table's gradient stays vocab-sharded, both for ``embed_gather="auto"``
    and ``"shard_map"``, which take this one path."""
    if not on_mesh(dist):
        return params["embed"][tokens.long()].to(dtype)
    tokens = dist.constrain(tokens, "batch", None)
    table = dist.gather_all(params["embed"], keep=0)  # (vocab, embed)
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
    x = dist.constrain(x, "batch", None, "embed")
    if w is None:  # (vocab, embed)
        tab = dist.gather_all(params["embed"], keep=0)
        logits = dist.map(lambda xi, ti: xi @ ti.to(xi.dtype).T, x, tab,
                          spec=x.spec[:-1] + (tab.spec[0],))
    else:
        w = dist.gather_all(w, keep=1)
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
    layers' mean router loss, 0.0 for a dense config); on a mesh the logits
    (batch, None, vocab)-sharded and aux replicated."""
    x, aux = forward_hidden(cfg, params, tokens, dist=dist)
    return unembed(cfg, params, x, dist=dist), aux


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
    On a mesh: ``forward_hidden_mesh``."""
    if on_mesh(dist):
        return forward_hidden_mesh(cfg, params, tokens, mode=mode, dist=dist)
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
    return _ce_terms(unembed(cfg, params, x), labels)


def _ce_terms(logits: torch.Tensor, labels: torch.Tensor):
    logits = logits.float()
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
    one chunk's logits exist at a time in the backward too.  On a mesh:
    ``loss_fn_mesh``."""
    if on_mesh(dist):
        return loss_fn_mesh(cfg, params, batch, dist=dist)
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
    but the experts, which keep their shards (ZeRO-3's layer dim: only
    layer ``l``, from the position that holds it)."""
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
    add, the sum constrained (batch, seq_axis, embed); (x, aux), aux the
    MoE's router loss (replicated) or 0.0.  The dense MLP's hidden dim is
    constrained to "ff" as in the reference (in decode it shards there,
    and the down projection sums its partial products)."""
    h = _norm(cfg, x, p["mlp_norm"], dist)
    aux = 0.0
    if cfg.n_experts > 0:
        y, aux = moe_mod.moe_block_mesh(cfg, p, h, dist=dist, mode=mode)
    else:
        u = dist.map(lambda pi, hi: F.silu(hi @ pi["w_gate"].to(hi.dtype))
                     * (hi @ pi["w_up"].to(hi.dtype)), p, h, spec=h.spec)
        u = dist.constrain(u, "batch", seq_axis, "ff")
        y = dist.matmul(u, p["w_down"])
    x = dist.map(torch.add, x, y, spec=x.spec)
    return dist.constrain(x, "batch", seq_axis, "embed"), aux


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
        x, _ = _mlp_block_mesh(cfg, p, x, "prefill", dist, "seq")
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
    x = _norm(cfg, x, dist.gather_all(params["final_norm"]), dist)
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
        x, _ = _mlp_block_mesh(cfg, p, x, "decode", dist, None)
    x = _norm(cfg, x, dist.gather_all(params["final_norm"]), dist)
    return unembed(cfg, params, x, dist=dist), cache


# ------------------------------------------------------ mesh training ----

def _block_mesh(cfg: ModelConfig, params: dict, l: int, x, window: int,
                theta: float, mode: str, dist):
    """Layer ``l`` on a mesh, its weights gathered at use inside it (a
    checkpointed layer's recompute gathers them again): (x, aux)."""
    p = _layer_at_use(cfg, params, l, dist)
    h = _norm(cfg, x, p["attn_norm"], dist)
    a = attn.self_attention_mesh(cfg, p, h, dist=dist, window=window,
                                 theta=theta, mode=mode)[0]
    x = dist.map(torch.add, x, a, spec=x.spec)
    return _mlp_block_mesh(cfg, p, x, mode, dist, "seq")


def forward_hidden_mesh(cfg: ModelConfig, params: dict, tokens, *,
                        mode: str = "train", dist):
    """``forward_hidden`` on ``dist``'s mesh: (hidden (B, S, D) sharded
    (batch, seq), aux replicated or 0.0).  With ``cfg.remat`` and ``mode ==
    "train"`` each layer runs under ``models.sharding.remat`` (one autograd
    node that reruns the layer on its ``Sharded`` arguments in the
    backward) when autograd records."""
    x = embed_tokens(cfg, params, tokens, dist=dist)
    window, theta = layer_flags(cfg)
    recompute = cfg.remat and mode == "train" and torch.is_grad_enabled()
    aux = 0.0
    for l in range(cfg.n_layers):
        if recompute:
            x, a = remat(_block_mesh, cfg, params, l, x, window[l],
                         theta[l], mode, dist)
        else:
            x, a = _block_mesh(cfg, params, l, x, window[l], theta[l], mode,
                               dist)
        if cfg.n_experts > 0:
            aux = dist.map(lambda s, t: s + t, aux, a, spec=())
    x = _norm(cfg, x, dist.gather_all(params["final_norm"]), dist)
    if cfg.n_experts > 0:
        aux = dist.map(lambda t: t / cfg.n_layers, aux, spec=())
    else:
        aux = aux / cfg.n_layers
    return x, aux


def _ce_mesh(cfg: ModelConfig, params: dict, x, labels, dist):
    """(CE sum, token count) of each position's rows, replicated over the
    vocab axes: ``_ce`` where the vocab is whole, else the logsumexp from a
    ``pmax`` shift and a ``psum`` of the exp-sums over the vocab axes and
    the label's logit ``psum``-med from the shard that holds it."""
    logits = unembed(cfg, params, x, dist=dist)
    vax = logits.spec[2]
    if not vax:
        return dist.map(_ce_terms, logits, labels, spec=((), ()))
    lf = dist.map(lambda t: t.float(), logits, spec=logits.spec)
    row = labels.spec
    with torch.no_grad():
        m = dist.pmax(dist.map(lambda t: t.amax(-1), lf, spec=row), vax)
    es = dist.psum(dist.map(lambda t, mi: torch.exp(t - mi[..., None]).sum(
        -1), lf, m, spec=row), vax)
    V_loc = logits.local_shape[2]

    def label_logit(i, t, lab):
        loc = lab.clamp_min(0).long() - dist.mesh.rank(i, vax) * V_loc
        ok = (loc >= 0) & (loc < V_loc)
        g = torch.gather(t, -1, loc.clamp(0, V_loc - 1)[..., None])[..., 0]
        return torch.where(ok, g, torch.zeros((), dtype=g.dtype,
                                              device=g.device))

    ll = dist.psum(dist.map(label_logit, lf, labels, pos=True, spec=row),
                   vax)

    def terms(e, mi, li, lab):
        mask = (lab >= 0).float()
        return ((mi + torch.log(e) - li) * mask).sum(), mask.sum()

    return dist.map(terms, es, m, ll, labels, spec=((), ()))


def _ce_chunk(cfg: ModelConfig, head: dict, se, cnt, h, labels, dist):
    """The running CE sum and count with one more chunk's added."""
    s_c, n_c = _ce_mesh(cfg, head, h, labels, dist)
    return (dist.map(torch.add, se, s_c, spec=()),
            dist.map(torch.add, cnt, n_c, spec=()))


def loss_fn_mesh(cfg: ModelConfig, params: dict, batch: dict, *, dist):
    """``loss_fn`` on ``dist``'s mesh: tokens and labels (B, S) plain or
    ``Sharded``; ``params`` laid out by ``params.shard_params`` (ZeRO-3's
    layout too).  The CE is ``mean_ce_mesh``'s, in ``cfg.loss_chunk``
    chunks.  Returns (loss, {"ce", "aux"}), each replicated on every
    position (``Sharded`` scalars; aux 0.0 for a dense config)."""
    hidden, aux = forward_hidden_mesh(cfg, params, batch["tokens"],
                                      mode="train", dist=dist)
    ce = mean_ce_mesh(cfg, params, hidden, batch["labels"], dist,
                      cfg.loss_chunk)
    loss = dist.map(lambda c_, a_: c_ + 0.01 * a_, ce, aux, spec=())
    return loss, {"ce": ce, "aux": aux}


def mean_ce_mesh(cfg: ModelConfig, params: dict, hidden, labels, dist,
                 chunk: int = 0):
    """The mean next-token CE of the final hidden state (B, S, D) on
    ``dist``'s mesh (the head: ``params["lm_head"]``, else the tied
    ``params["embed"]``), replicated on every position.  The CE's rows are
    whole sequences (the logits' (batch, None, vocab) layout), cut into
    ``chunk``-position chunks where ``chunk`` divides S (and S is larger)
    as the meshless path cuts them, each checkpointed; the sum and count
    are ``psum``-med over the batch axes."""
    hidden = dist.constrain(hidden, "batch", None, "embed")
    labels = dist.constrain(labels, "batch", None)
    if labels.spec[0] != hidden.spec[0]:
        raise ValueError(f"labels laid out {labels.spec}, the hidden state "
                         f"{hidden.spec}")
    S = hidden.shape[1]
    if chunk and S % chunk == 0 and S > chunk:
        se = cnt = dist.map(lambda t: torch.zeros(
            (), dtype=torch.float32, device=t.device), hidden, spec=())
        head = {k: params[k] for k in ("embed", "lm_head") if k in params}
        for c in range(0, S, chunk):
            h = dist.map(lambda t: t[:, c:c + chunk], hidden,
                         spec=hidden.spec)
            lab = dist.map(lambda t: t[:, c:c + chunk], labels,
                           spec=labels.spec)
            # the running sums go through each chunk's region, so that the
            # backward runs the chunks one after the other, last first,
            # whatever the binding: the head's gradients meet in its
            # leaves in that order (as one thread meets them)
            if torch.is_grad_enabled():
                se, cnt = remat(_ce_chunk, cfg, head, se, cnt, h, lab, dist)
            else:
                se, cnt = _ce_chunk(cfg, head, se, cnt, h, lab, dist)
    else:
        se, cnt = _ce_mesh(cfg, params, hidden, labels, dist)
    se = dist.psum(se, hidden.spec[0])
    cnt = dist.psum(cnt, hidden.spec[0])
    return dist.map(lambda s_, n_: s_ / n_.clamp_min(1.0), se, cnt, spec=())
