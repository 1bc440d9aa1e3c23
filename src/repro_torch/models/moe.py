"""Mixture-of-Experts FFN on one device.

Train/prefill path (``mode != "decode"``): every token is routed to its
top-k experts, placed into per-expert capacity buffers in token-major
priority (a token whose rank in its expert's queue reaches the capacity
goes to an overflow bucket and is dropped), the experts run as batched
SwiGLU products over their buffers, and each token's outputs are combined
by its routing weights.

Decode path: with one token per sequence the dispatch buffers degenerate,
so every expert computes the tiny token batch (dense dispatch) and the
outputs combine by routing weight; no token is dropped.

The reference also runs the train/prefill path expert-parallel (a
``shard_map`` with an ``all_to_all`` over the expert axis,
``src/repro/models/moe.py:131-161``); that is multi-card work, ROADMAP
queue 1, item 9, and not here.  Its single-device path is this module's.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.params import Def


def moe_defs(cfg: ModelConfig, stack: int = 0) -> dict:
    E, D, Fd = cfg.n_experts, cfg.d_model, cfg.d_ff
    L = (stack,) if stack else ()
    La = ("layers",) if stack else ()
    return {
        "router": Def(L + (D, E), La + ("embed", None), scale=0.02),
        "w_gate": Def(L + (E, D, Fd), La + ("experts", "embed", "ff")),
        "w_up": Def(L + (E, D, Fd), La + ("experts", "embed", "ff")),
        "w_down": Def(L + (E, Fd, D), La + ("experts", "ff", "embed"),
                      fan_in_dims=(-2,)),
    }


def _route(cfg: ModelConfig, p: dict, x: torch.Tensor):
    """Router: top-k expert ids (B, S, K), their weights renormalised to sum
    to 1 (with a 1e-9 floor), and the Switch load-balancing loss
    ``E * sum_e f_e * p_e`` (f_e the top-1 fraction, p_e the mean router
    probability).  The logits are computed in x's type, the softmax in
    f32.  Ties keep the lower expert first, as ``jax.lax.top_k`` does (a
    stable descending sort; ``torch.topk`` promises no order on ties)."""
    logits = (x @ p["router"].to(x.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    weights, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, idx = weights[..., :cfg.top_k], idx[..., :cfg.top_k]
    weights = weights / weights.sum(-1, keepdim=True).clamp_min(1e-9)
    E = cfg.n_experts
    me = probs.mean(dim=(0, 1))
    fe = F.one_hot(idx[..., 0], E).float().mean(dim=(0, 1))
    aux = E * torch.sum(fe * me)
    return idx, weights, aux


def _dispatch(idx: torch.Tensor, n_experts: int, capacity: int):
    """Each (token, k)'s rank in its expert's queue (token-major, an
    exclusive running count), whether it fits (``keep = pos < capacity``),
    and its buffer slot ``expert * capacity + pos``, or the overflow
    bucket ``E * capacity`` when it does not fit.  idx (T, K)."""
    T, K = idx.shape
    # (E, T*K): the running count runs along the last dim, where a scan
    # parallelises (along dim 0 of (T*K, E) it is one thread per expert)
    flat = F.one_hot(idx, n_experts).reshape(T * K, n_experts).t().contiguous()
    pos = torch.cumsum(flat, dim=1) - flat
    pos = (pos * flat).sum(0).reshape(T, K)
    keep = pos < capacity
    slot = torch.where(keep, idx * capacity + pos,
                       torch.full_like(pos, n_experts * capacity))
    return pos, keep, slot


def _local_dispatch_compute_combine(x, idx, weights, wg, wu, wd, *,
                                    n_experts: int, top_k: int,
                                    capacity: int) -> torch.Tensor:
    """Route x (B, S, D) into the (E, capacity, D) expert buffers, run the
    SwiGLU experts as batched products, and combine each token's kept
    outputs by its routing weights; dropped (token, k) pairs add zero."""
    B, S, D = x.shape
    T, K, E = B * S, top_k, n_experts
    xt = x.reshape(T, D)
    _, keep, slot = _dispatch(idx.reshape(T, K), E, capacity)
    wts = weights.reshape(T, K)

    buf = torch.zeros((E * capacity + 1, D), dtype=x.dtype, device=x.device)
    contrib = xt[:, None, :].expand(T, K, D).reshape(T * K, D)
    buf.index_add_(0, slot.reshape(-1),
                   contrib * keep.reshape(-1, 1).to(x.dtype))
    buf = buf[:-1].reshape(E, capacity, D)
    h = torch.bmm(buf, wg.to(buf.dtype))
    u = torch.bmm(buf, wu.to(buf.dtype))
    y = torch.bmm(F.silu(h) * u, wd.to(buf.dtype))
    y = torch.cat([y.reshape(E * capacity, D),
                   torch.zeros((1, D), dtype=y.dtype, device=y.device)])
    out = (y[slot] * (wts * keep).to(y.dtype)[..., None]).sum(dim=1)
    return out.reshape(B, S, D).to(x.dtype)


def capacity(cfg: ModelConfig, tokens: int) -> int:
    """The per-expert buffer rows of the train/prefill path for ``tokens``
    tokens: ``int(capacity_factor * T * top_k / E) + 1``."""
    return int(cfg.capacity_factor * tokens * cfg.top_k / cfg.n_experts) + 1


def moe_block(cfg: ModelConfig, p: dict, x: torch.Tensor, *,
              mode: str = "train"):
    """x (B, S, D) -> (out (B, S, D), aux loss scalar)."""
    idx, weights, aux = _route(cfg, p, x)
    E = cfg.n_experts
    if mode == "decode":
        # dense dispatch: every expert computes the (tiny) token batch
        h = torch.einsum("bsd,edf->ebsf", x, p["w_gate"].to(x.dtype))
        u = torch.einsum("bsd,edf->ebsf", x, p["w_up"].to(x.dtype))
        y = torch.einsum("ebsf,efd->ebsd", F.silu(h) * u,
                         p["w_down"].to(x.dtype))
        wdense = (F.one_hot(idx, E).float() * weights[..., None]).sum(2)
        out = torch.einsum("ebsd,bse->bsd", y, wdense.to(y.dtype))
        return out.to(x.dtype), aux
    B, S, _ = x.shape
    out = _local_dispatch_compute_combine(
        x, idx, weights, p["w_gate"], p["w_up"], p["w_down"], n_experts=E,
        top_k=cfg.top_k, capacity=capacity(cfg, B * S))
    return out, aux
