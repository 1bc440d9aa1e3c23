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
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import mamba2
from repro_torch.models.layers import (flash_attention, masked_ce, rms_norm,
                                      rope, swiglu_mlp)
from repro_torch.models.params import Def
from repro_torch.models.sharding import no_mesh

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
                   mode: str = "train") -> torch.Tensor:
    """Embedding through every layer, before the final norm.  With
    ``cfg.remat`` and ``mode == "train"`` each Mamba layer and each place
    of the shared block is checkpointed when autograd records."""
    x = _embed(params, tokens)
    remat = cfg.remat and mode == "train" and torch.is_grad_enabled()
    for kind, _, p in _schedule(cfg, params):
        fn = _mamba_residual if kind == "mamba" else _shared_block
        x = (checkpoint(fn, cfg, p, x, use_reentrant=False) if remat
             else fn(cfg, p, x))
    return x


def forward(cfg: ModelConfig, params: dict, tokens: torch.Tensor, *,
            mode: str = "train", dist=None):
    """Full-sequence forward: (logits (B, S, V), 0.0) as the reference's
    (no auxiliary loss)."""
    no_mesh(dist)
    return _unembed(cfg, params, forward_hidden(cfg, params, tokens,
                                                mode=mode)), 0.0


def loss_fn(cfg: ModelConfig, params: dict, batch: dict, *, dist=None):
    """Next-token CE over the unmasked labels (labels < 0 masked), from f32
    logits.  Returns (ce, {"ce": ce})."""
    no_mesh(dist)
    logits, _ = forward(cfg, params, batch["tokens"], mode="train")
    ce = masked_ce(logits, batch["labels"])
    return ce, {"ce": ce}


def prefill(cfg: ModelConfig, params: dict, tokens: torch.Tensor, *,
            max_len: Optional[int] = None, dist=None):
    """Forward over the prompts that also emits the decode state: every
    layer's final SSM state ``h`` and, for the hybrid, each place's k and v
    (zero-padded to ``max_len``).  The conv tails stay zero, as in the
    reference (a 3-token window).  Returns (logits of the last position
    (B, 1, V), state)."""
    no_mesh(dist)
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
    returns (logits (B, 1, V), state)."""
    no_mesh(dist)
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

