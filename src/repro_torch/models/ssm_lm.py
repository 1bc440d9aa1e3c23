"""SSM and hybrid-SSM language models (mamba2-780m, zamba2-1.2b).

Pure SSM: embed -> [norm + Mamba2 mixer] per layer -> norm -> lm_head.

Hybrid (``attn_every`` = k > 0, zamba2): after every k Mamba layers one
*shared* transformer block (attention + MLP, one set of weights applied at
every place: zamba2's parameter sharing) runs; the layers left over after
the last group (the tail) follow without one.  Parameters keep the
reference's stacked layout, and a Python loop over layers and groups takes
the place of its scans.

Decode state: the stacked SSM states ``h`` (L, B, H, N, P) f32 and conv
tails (L, B, W-1, width) bf16; the hybrid adds one KV cache per place of
the shared block, (G, B, Smax, Hkv, Dh).  ``decode_step`` writes every
layer's new state and the new k and v into ``state`` in place (the
reference returns new stacks), as ``transformer.decode_step`` does.

``prefill`` hands decode the states ``h`` and, for the hybrid, the KV
caches; like the reference's, it leaves the conv tails at zero, so decode
after prefill is not the continuation a longer ``forward`` would compute.

On a mesh (``dist`` a ``models.sharding.Distribution`` with one;
parameters laid out by ``params.shard_params``, ZeRO-3's layout too) every
entry point runs over ``Sharded`` values: the vocab-sharded embedding and
logits of ``transformer``; each Mamba layer through
``mamba2.mamba_block_mesh`` (``cfg.mamba_layout``: ``head_tp`` or
``seq_sp``) and ``mamba2.mamba_decode_step_mesh``; the shared block through
``attention.self_attention_mesh`` / ``decode_self_attention_mesh`` and
``transformer._mlp_block_mesh``, its KV caches over ``kv_seq``; the state
laid out by ``state_defs`` (``h`` over "ssm_heads", ``conv_x`` over
"ssm_inner").  Weights are gathered whole at their use, inside each
layer, so that with ``cfg.remat`` each Mamba layer and each place of the
shared block is one ``models.sharding.remat`` region whose recompute
gathers them again.  The CE is ``transformer.mean_ce_mesh``, unchunked as
the reference's ``loss_fn``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import mamba2, transformer
from repro_torch.models.layers import (flash_attention, masked_ce, rms_norm,
                                      rope, swiglu_mlp)
from repro_torch.models.params import Def
from repro_torch.models.sharding import on_mesh, remat

SSM_KEYS = ("h", "conv_x", "conv_B", "conv_C")


def _n_groups(cfg: ModelConfig) -> tuple:
    """(places of the shared block, Mamba layers in the tail)."""
    if cfg.attn_every <= 0:
        return 0, cfg.n_layers
    g = cfg.n_layers // cfg.attn_every
    return g, cfg.n_layers - g * cfg.attn_every


def defs(cfg: ModelConfig) -> dict:
    L, D, V = cfg.n_layers, cfg.d_model, cfg.padded_vocab
    layer = {
        "pre_norm": Def((L, D), ("layers", "embed"), init="zeros"),
        **mamba2.mamba_defs(cfg, stack=L),
    }
    out = {
        "embed": Def((V, D), ("vocab", "embed"), scale=0.02),
        "layers": layer,
        "final_norm": Def((D,), ("embed",), init="zeros"),
        "lm_head": Def((D, V), ("embed", "vocab")),
    }
    G, _ = _n_groups(cfg)
    if G > 0:
        out["shared_attn"] = {
            "attn_norm": Def((D,), ("embed",), init="zeros"),
            "mlp_norm": Def((D,), ("embed",), init="zeros"),
            **attn.attn_defs(cfg),
            "w_gate": Def((D, cfg.d_ff), ("embed", "ff")),
            "w_up": Def((D, cfg.d_ff), ("embed", "ff")),
            "w_down": Def((cfg.d_ff, D), ("ff", "embed")),
        }
    return out


def _group_params(cfg: ModelConfig, layers: dict) -> tuple:
    """The stacked layer parameters as (G, k, ...) groups and the tail's
    (T, ...) stack (views); (None, layers) without a shared block."""
    G, tail = _n_groups(cfg)
    k = cfg.attn_every
    if G == 0:
        return None, layers
    grouped = {n: a[:G * k].reshape(G, k, *a.shape[1:])
               for n, a in layers.items()}
    tail_p = {n: a[G * k:] for n, a in layers.items()} if tail else None
    return grouped, tail_p


def _schedule(cfg: ModelConfig, params: dict):
    """The network in order: ("mamba", layer, its parameters) and
    ("shared", place, the shared block's parameters), the tail's layers
    last."""
    G, tail = _n_groups(cfg)
    k = cfg.attn_every
    grouped, tail_p = _group_params(cfg, params["layers"])
    for g in range(G):
        for i in range(k):
            yield "mamba", g * k + i, {n: a[g, i] for n, a in grouped.items()}
        yield "shared", g, params["shared_attn"]
    for i in range(tail):
        yield "mamba", G * k + i, {n: a[i] for n, a in tail_p.items()}


def _embed(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"][tokens.long()].to(torch.bfloat16)


def _unembed(cfg: ModelConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x @ params["lm_head"].to(x.dtype)


def _mamba_layer(cfg: ModelConfig, p_l: dict, x: torch.Tensor) -> tuple:
    h = rms_norm(x, p_l["pre_norm"], cfg.norm_eps)
    y, h_final = mamba2.mamba_block(cfg, p_l, h)
    return x + y, h_final


def _mamba_residual(cfg: ModelConfig, p_l: dict, x: torch.Tensor):
    return _mamba_layer(cfg, p_l, x)[0]


def _shared_block(cfg: ModelConfig, p: dict, x: torch.Tensor,
                  keep_kv: bool = False):
    """The shared transformer block (causal attention, then the MLP, each
    behind a pre-norm and a residual add).  With ``keep_kv`` returns (x,
    (k, v)), the rope'd keys and values the decode cache starts from."""
    h = rms_norm(x, p["attn_norm"], cfg.norm_eps)
    q, k, v = attn._project(cfg, p, h)
    positions = torch.arange(x.shape[1], device=x.device)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    o = flash_attention(q, k, v, causal=True)
    x = x + attn._out(cfg, p, o)
    h = rms_norm(x, p["mlp_norm"], cfg.norm_eps)
    x = x + swiglu_mlp(p, h)
    return (x, (k, v)) if keep_kv else x


def forward_hidden(cfg: ModelConfig, params: dict, tokens: torch.Tensor, *,
                   mode: str = "train", dist=None) -> torch.Tensor:
    """Embedding through every layer, before the final norm.  With
    ``cfg.remat`` and ``mode == "train"`` each Mamba layer and each place
    of the shared block is checkpointed when autograd records.  On a mesh:
    ``_forward_hidden_mesh``, after the final norm."""
    if on_mesh(dist):
        return _forward_hidden_mesh(cfg, params, tokens, mode, dist)
    x = _embed(params, tokens)
    remat_on = cfg.remat and mode == "train" and torch.is_grad_enabled()
    for kind, _, p in _schedule(cfg, params):
        fn = _mamba_residual if kind == "mamba" else _shared_block
        x = (checkpoint(fn, cfg, p, x, use_reentrant=False) if remat_on
             else fn(cfg, p, x))
    return x


def forward(cfg: ModelConfig, params: dict, tokens: torch.Tensor, *,
            mode: str = "train", dist=None):
    """Full-sequence forward: (logits (B, S, V), 0.0) as the reference's
    (no auxiliary loss); on a mesh the logits (batch, None, vocab)."""
    if on_mesh(dist):
        x = _forward_hidden_mesh(cfg, params, tokens, mode, dist)
        return transformer.unembed(cfg, params, x, dist=dist), 0.0
    return _unembed(cfg, params, forward_hidden(cfg, params, tokens,
                                                mode=mode)), 0.0


def loss_fn(cfg: ModelConfig, params: dict, batch: dict, *, dist=None):
    """Next-token CE over the unmasked labels (labels < 0 masked), from f32
    logits.  Returns (ce, {"ce": ce}); on a mesh both replicated on every
    position."""
    if on_mesh(dist):
        x = _forward_hidden_mesh(cfg, params, batch["tokens"], "train", dist)
        ce = transformer.mean_ce_mesh(cfg, params, x, batch["labels"], dist)
        return ce, {"ce": ce}
    logits, _ = forward(cfg, params, batch["tokens"], mode="train")
    ce = masked_ce(logits, batch["labels"])
    return ce, {"ce": ce}


def prefill(cfg: ModelConfig, params: dict, tokens: torch.Tensor, *,
            max_len: Optional[int] = None, dist=None):
    """Forward over the prompts that also emits the decode state: every
    layer's final SSM state ``h`` and, for the hybrid, each place's k and v
    (zero-padded to ``max_len``).  The conv tails stay zero, as in the
    reference (a 3-token window).  Returns (logits of the last position
    (B, 1, V), state).  On a mesh: ``_prefill_mesh``."""
    if on_mesh(dist):
        return _prefill_mesh(cfg, params, tokens, max_len, dist)
    x = _embed(params, tokens)
    B, S = x.shape[:2]
    max_len = max_len or S
    state = init_state(cfg, B, max_len, device=x.device)
    for kind, i, p in _schedule(cfg, params):
        if kind == "mamba":
            x, state["h"][i] = _mamba_layer(cfg, p, x)
        else:
            x, (k, v) = _shared_block(cfg, p, x, keep_kv=True)
            state["attn_k"][i, :, :S] = k
            state["attn_v"][i, :, :S] = v
    return _unembed(cfg, params, x[:, -1:]), state


# ---------------------------------------------------------------- decode ----

def state_defs(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    L = cfg.n_layers
    H, P_, N, W = cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state, cfg.conv_width
    din, gn = cfg.d_inner, cfg.ssm_ngroups * cfg.ssm_state
    d = {
        "h": Def((L, batch, H, N, P_),
                 ("layers", "batch", "ssm_heads", None, None), init="zeros"),
        "conv_x": Def((L, batch, W - 1, din),
                      ("layers", "batch", None, "ssm_inner"), init="zeros"),
        "conv_B": Def((L, batch, W - 1, gn), ("layers", "batch", None, None),
                      init="zeros"),
        "conv_C": Def((L, batch, W - 1, gn), ("layers", "batch", None, None),
                      init="zeros"),
    }
    G, _ = _n_groups(cfg)
    if G > 0:
        Hkv, Dh = cfg.n_kv_heads, cfg.resolved_head_dim
        d["attn_k"] = Def((G, batch, max_len, Hkv, Dh),
                          ("layers", "batch", "kv_seq", None, None),
                          init="zeros")
        d["attn_v"] = Def((G, batch, max_len, Hkv, Dh),
                          ("layers", "batch", "kv_seq", None, None),
                          init="zeros")
    return d


def init_state(cfg: ModelConfig, batch: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16, device="cuda") -> dict:
    """The zero decode state of ``state_defs`` on ``device`` (the card
    unless the caller asks for the CPU; raises without one): every layer's
    ``mamba2.init_mamba_state`` stacked (``h`` f32, the conv tails in
    ``dtype``), and the hybrid's KV caches in ``dtype``."""
    L = cfg.n_layers
    state = {n: t.view(L, batch, *t.shape[1:]) for n, t in
             mamba2.init_mamba_state(cfg, L * batch, dtype, device).items()}
    for n, d in state_defs(cfg, batch, max_len).items():
        if n not in state:
            state[n] = torch.zeros(d.shape, dtype=dtype,
                                   device=state["h"].device)
    return state


def decode_step(cfg: ModelConfig, params: dict, state: dict,
                tokens: torch.Tensor, pos: int, *, dist=None):
    """One token for every sequence.  tokens (B, 1); ``pos`` (a host int)
    the position being written (the shared block's KV slot).  Writes each
    layer's new state, and each place's k and v, into ``state`` in place;
    returns (logits (B, 1, V), state).  On a mesh: ``_decode_step_mesh``."""
    if on_mesh(dist):
        return _decode_step_mesh(cfg, params, state, tokens, pos, dist)
    x = _embed(params, tokens)
    for kind, i, p in _schedule(cfg, params):
        if kind == "mamba":
            h = rms_norm(x, p["pre_norm"], cfg.norm_eps)
            y, new = mamba2.mamba_decode_step(
                cfg, p, h, {s: state[s][i] for s in SSM_KEYS})
            x = x + y
            for s in SSM_KEYS:
                state[s][i] = new[s]
        else:
            h = rms_norm(x, p["attn_norm"], cfg.norm_eps)
            a, _ = attn.decode_self_attention(
                cfg, p, h, {"k": state["attn_k"][i], "v": state["attn_v"][i]},
                pos)
            x = x + a
            h = rms_norm(x, p["mlp_norm"], cfg.norm_eps)
            x = x + swiglu_mlp(p, h)
    return _unembed(cfg, params, x), state


# ------------------------------------------------------------------ mesh ----

def _mesh_schedule(cfg: ModelConfig):
    """``_schedule``'s order as (kind, index): ("mamba", layer) and
    ("shared", place)."""
    G, tail = _n_groups(cfg)
    k = cfg.attn_every
    for g in range(G):
        for i in range(k):
            yield "mamba", g * k + i
        yield "shared", g
    for i in range(tail):
        yield "mamba", G * k + i


def _mamba_layer_mesh(cfg: ModelConfig, params: dict, i: int, x, dist):
    """Mamba layer ``i`` on the mesh, its weights gathered at use inside
    it: (x, h_final)."""
    p = dist.at_use(params["layers"], i)
    y, h_final = mamba2.mamba_block_mesh(
        cfg, p, transformer._norm(cfg, x, p["pre_norm"], dist), dist=dist)
    return dist.map(torch.add, x, y, spec=x.spec), h_final


def _shared_block_mesh(cfg: ModelConfig, params: dict, x, mode: str, dist):
    """The shared block on the mesh, its weights gathered at use inside it:
    (x, k, v), k and v as its attention read them (whole per data shard,
    for the cache)."""
    p = dist.at_use(params["shared_attn"])
    a, k, v = attn.self_attention_mesh(
        cfg, p, transformer._norm(cfg, x, p["attn_norm"], dist), dist=dist,
        mode=mode)
    x = dist.map(torch.add, x, a, spec=x.spec)
    return transformer._mlp_block_mesh(cfg, p, x, mode, dist, "seq")[0], k, v


def _forward_hidden_mesh(cfg: ModelConfig, params: dict, tokens, mode: str,
                         dist):
    """Embedding through every layer and the final norm on the mesh:
    (B, S, D) sharded (batch, seq).  With ``cfg.remat`` and ``mode ==
    "train"`` each Mamba layer and each place of the shared block is one
    ``remat`` region when autograd records."""
    x = transformer.embed_tokens(cfg, params, tokens, dist=dist)
    recompute = cfg.remat and mode == "train" and torch.is_grad_enabled()
    for kind, i in _mesh_schedule(cfg):
        if kind == "mamba":
            args = (_mamba_layer_mesh, cfg, params, i, x, dist)
        else:
            args = (_shared_block_mesh, cfg, params, x, mode, dist)
        x = (remat(*args) if recompute else args[0](*args[1:]))[0]
    return transformer._norm(cfg, x, dist.gather_all(params["final_norm"]),
                             dist)


def _state_mesh(cfg: ModelConfig, batch: int, max_len: int, dist) -> dict:
    """The zero decode state of ``state_defs`` on the mesh (``h`` f32, the
    conv tails and KV caches bf16)."""
    defs = state_defs(cfg, batch, max_len)
    defs["h"] = dataclasses.replace(defs["h"], dtype=torch.float32)
    return dist.zeros(defs, torch.bfloat16)


def _write(dist, dst, index: int, src) -> None:
    """``dst[index] = src`` on every position, in place (``src`` resharded
    to the layout of ``dst``'s other dims)."""
    src = dist.reshard(src, dst.spec[1:])
    for i in dist.mesh.active:
        dst.local(i)[index] = src.local(i)


def _prefill_mesh(cfg: ModelConfig, params: dict, tokens, max_len, dist):
    """``prefill`` on the mesh: tokens (B, S) plain or ``Sharded``.
    Returns (logits of the last position (B, 1, V) vocab-sharded, the
    state laid out by ``state_defs``; the KV caches (batch, kv_seq), zero
    past S)."""
    x = transformer.embed_tokens(cfg, params, tokens, dist=dist)
    B, S = x.shape[:2]
    max_len = max_len or S
    state = _state_mesh(cfg, B, max_len, dist)
    for kind, i in _mesh_schedule(cfg):
        if kind == "mamba":
            x, h_final = _mamba_layer_mesh(cfg, params, i, x, dist)
            _write(dist, state["h"], i, h_final)
            continue
        x, k, v = _shared_block_mesh(cfg, params, x, "prefill", dist)
        for name, kv in (("attn_k", k), ("attn_v", v)):
            cache = state[name]
            for p in dist.mesh.active:
                c = cache.local(p)
                lo = dist.block_start(cache, 2, p)
                hi = min(S, lo + c.shape[2])
                if hi > lo:
                    c[i, :, :hi - lo] = kv.local(p)[:, lo:hi]
    x = transformer._norm(cfg, x, dist.gather_all(params["final_norm"]),
                          dist)
    logits = transformer.unembed(cfg, params,
                                 transformer._last_position(x, dist),
                                 dist=dist)
    return logits, state


def _decode_step_mesh(cfg: ModelConfig, params: dict, state: dict, tokens,
                      pos: int, dist):
    """``decode_step`` on the mesh: tokens (B, 1) plain or ``Sharded``;
    ``state`` as ``_prefill_mesh`` gives it, written in place.  Returns
    (logits (B, 1, V) vocab-sharded, state)."""
    x = transformer.embed_tokens(cfg, params, tokens, dist=dist)
    x = dist.constrain(x, "batch", None, "embed")
    for kind, i in _mesh_schedule(cfg):
        if kind == "mamba":
            p = dist.at_use(params["layers"], i)
            st = {s: dist.select(state[s], i) for s in SSM_KEYS}
            y, new = mamba2.mamba_decode_step_mesh(
                cfg, p, transformer._norm(cfg, x, p["pre_norm"], dist), st,
                dist=dist)
            x = dist.map(torch.add, x, y, spec=x.spec)
            for s in SSM_KEYS:
                _write(dist, state[s], i, new[s])
            continue
        p = dist.at_use(params["shared_attn"])
        cache = {n: dist.select(state["attn_" + n], i) for n in ("k", "v")}
        a, _ = attn.decode_self_attention(
            cfg, p, transformer._norm(cfg, x, p["attn_norm"], dist), cache,
            pos, dist=dist)
        x, _ = transformer._mlp_block_mesh(
            cfg, p, dist.map(torch.add, x, a, spec=x.spec), "decode", dist,
            None)
    x = transformer._norm(cfg, x, dist.gather_all(params["final_norm"]),
                          dist)
    return transformer.unembed(cfg, params, x, dist=dist), state
