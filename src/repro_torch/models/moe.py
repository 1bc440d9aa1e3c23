"""Mixture-of-Experts FFN, on one device or expert-parallel over a mesh.

Train/prefill path (``mode != "decode"``): every token is routed to its
top-k experts, placed into per-expert capacity buffers in token-major
priority (a token whose rank in its expert's queue reaches the capacity
goes to an overflow bucket and is dropped), the experts run as batched
SwiGLU products over their buffers, and each token's outputs are combined
by its routing weights.

Decode path: with one token per sequence the dispatch buffers degenerate,
so every expert computes the tiny token batch (dense dispatch) and the
outputs combine by routing weight; no token is dropped.

Expert-parallel path (``moe_block_mesh``, the reference's ``shard_map``
of ``src/repro/models/moe.py:119-161``): the experts stay sharded over the
"experts" mesh axis and are never gathered.  In prefill each position
routes its own (batch, seq) block of tokens into (E, C, D) buffers with
C = ceil8(int(capacity_factor * T_loc * top_k / E) + 1), sends every
expert's rows to the position that holds it (``all_to_all`` over the
expert axis: (E, C, D) -> (E_loc, C * n, D)), runs its local experts, and
sends the outputs back for the combine; drops follow from each position's
own queues, as in the reference.  Decode keeps dense dispatch: each
position computes its local experts and the combine's partial sums are
summed over the expert axis (``psum``).  Training (``mode="train"``) takes
the prefill's dispatch: the two ``all_to_all``s' gradients are the reverse
exchanges, and the router loss over every token is each position's
fractions and mean probabilities ``psum``-med over the token shards.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.params import Def
from repro_torch.models.sharding import on_mesh


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


def _buffers(x, idx, n_experts: int, top_k: int, capacity: int) -> tuple:
    """x (B, S, D) routed into the (E, capacity, D) expert buffers; with
    each (token, k)'s ``keep`` and ``slot`` (``_dispatch``)."""
    B, S, D = x.shape
    T, K, E = B * S, top_k, n_experts
    xt = x.reshape(T, D)
    _, keep, slot = _dispatch(idx.reshape(T, K), E, capacity)
    buf = torch.zeros((E * capacity + 1, D), dtype=x.dtype, device=x.device)
    contrib = xt[:, None, :].expand(T, K, D).reshape(T * K, D)
    buf.index_add_(0, slot.reshape(-1),
                   contrib * keep.reshape(-1, 1).to(x.dtype))
    return buf[:-1].reshape(E, capacity, D), keep, slot


def _experts(buf, wg, wu, wd) -> torch.Tensor:
    """The SwiGLU experts as batched products over their buffers."""
    h = torch.bmm(buf, wg.to(buf.dtype))
    u = torch.bmm(buf, wu.to(buf.dtype))
    return torch.bmm(F.silu(h) * u, wd.to(buf.dtype))


def _combine(x, y, weights, keep, slot) -> torch.Tensor:
    """Each token's kept outputs of y (E, capacity, D) summed by its
    routing weights; dropped (token, k) pairs add zero."""
    B, S, D = x.shape
    y = torch.cat([y.reshape(-1, D),
                   torch.zeros((1, D), dtype=y.dtype, device=y.device)])
    wts = weights.reshape(slot.shape)
    out = (y[slot] * (wts * keep).to(y.dtype)[..., None]).sum(dim=1)
    return out.reshape(B, S, D).to(x.dtype)


def _local_dispatch_compute_combine(x, idx, weights, wg, wu, wd, *,
                                    n_experts: int, top_k: int,
                                    capacity: int) -> torch.Tensor:
    """Route x (B, S, D) into the (E, capacity, D) expert buffers, run the
    SwiGLU experts as batched products, and combine each token's kept
    outputs by its routing weights; dropped (token, k) pairs add zero."""
    buf, keep, slot = _buffers(x, idx, n_experts, top_k, capacity)
    return _combine(x, _experts(buf, wg, wu, wd), weights, keep, slot)


def capacity(cfg: ModelConfig, tokens: int) -> int:
    """The per-expert buffer rows of the train/prefill path for ``tokens``
    tokens: ``int(capacity_factor * T * top_k / E) + 1``."""
    return int(cfg.capacity_factor * tokens * cfg.top_k / cfg.n_experts) + 1


def _dense(x, idx, weights, wg, wu, wd, n_experts: int, e0: int = None):
    """Dense dispatch: every expert of ``wg`` computes the token batch,
    combined by its routing weight (0 where unrouted).  With ``e0`` the
    experts are ``e0`` on of ``n_experts``, and the combine is their
    partial sum in f32 (of the rounded operands, as the product
    accumulates it), to be summed over the expert shards."""
    h = torch.einsum("bsd,edf->ebsf", x, wg.to(x.dtype))
    u = torch.einsum("bsd,edf->ebsf", x, wu.to(x.dtype))
    y = torch.einsum("ebsf,efd->ebsd", F.silu(h) * u, wd.to(x.dtype))
    wdense = (F.one_hot(idx, n_experts).float() * weights[..., None]).sum(2)
    if e0 is None:
        return torch.einsum("ebsd,bse->bsd", y, wdense.to(y.dtype))
    wdense = wdense[..., e0:e0 + wg.shape[0]].to(y.dtype)
    return torch.einsum("ebsd,bse->bsd", y.float(), wdense.float())


def moe_block(cfg: ModelConfig, p: dict, x: torch.Tensor, *,
              mode: str = "train", dist=None):
    """x (B, S, D) -> (out (B, S, D), aux loss scalar).  On a mesh
    (``dist`` with one, x ``Sharded``): ``moe_block_mesh``."""
    if on_mesh(dist):
        return moe_block_mesh(cfg, p, x, dist=dist, mode=mode)
    idx, weights, aux = _route(cfg, p, x)
    E = cfg.n_experts
    if mode == "decode":
        # dense dispatch: every expert computes the (tiny) token batch
        out = _dense(x, idx, weights, p["w_gate"], p["w_up"], p["w_down"], E)
        return out.to(x.dtype), aux
    B, S, _ = x.shape
    out = _local_dispatch_compute_combine(
        x, idx, weights, p["w_gate"], p["w_up"], p["w_down"], n_experts=E,
        top_k=cfg.top_k, capacity=capacity(cfg, B * S))
    return out, aux


def moe_block_mesh(cfg: ModelConfig, p: dict, x, *, dist,
                   mode: str = "prefill"):
    """The MoE FFN on a mesh: x (B, S, D) ``Sharded`` over (batch, seq)
    (decode: over batch), ``p`` the layer's parameters as laid out at rest
    except the router, whole on every position; the expert weights keep
    their expert shards (any other sharded dim of theirs is gathered).
    Returns (out, aux): out in x's layout; aux the Switch loss of all the
    tokens (each position's expert fractions and mean probabilities
    averaged over the token shards).

    Where neither the tokens nor the experts are split (a 1 x 1 mesh),
    each position runs ``moe_block``'s single-device path.  Otherwise
    prefill runs the expert-parallel dispatch (module doc) and decode the
    dense dispatch over the local experts with a ``psum``."""
    E, K = cfg.n_experts, cfg.top_k
    w = {name: dist.gather_all(p[name], keep=0)
         for name in ("w_gate", "w_up", "w_down")}
    e_axes = w["w_gate"].spec[0]
    tok_axes = x.spec[0] + x.spec[1]
    idx, weights, aux = dist.map(lambda pi, xi: _route(cfg, pi, xi), p, x)
    n_tok = dist.group_size(tok_axes)
    if n_tok > 1:
        def stats(pi, xi, ii):
            probs = torch.softmax((xi @ pi["router"].to(xi.dtype)).float(),
                                  dim=-1)
            return (F.one_hot(ii[..., 0], E).float().mean(dim=(0, 1)),
                    probs.mean(dim=(0, 1)))
        fe, me = dist.map(stats, p, x, idx)
        fe, me = dist.psum(fe, tok_axes), dist.psum(me, tok_axes)
        aux = dist.map(lambda f, m: E * torch.sum((f / n_tok) * (m / n_tok)),
                       fe, me)
    if not e_axes and n_tok == 1:
        def single(xi, ii, wi, gi, ui, di):
            if mode == "decode":
                return _dense(xi, ii, wi, gi, ui, di, E).to(xi.dtype)
            return _local_dispatch_compute_combine(
                xi, ii, wi, gi, ui, di, n_experts=E, top_k=K,
                capacity=capacity(cfg, xi.shape[0] * xi.shape[1]))
        out = dist.map(single, x, idx, weights, w["w_gate"], w["w_up"],
                       w["w_down"], spec=x.spec)
        return out, aux
    if mode == "decode":  # partial sums in f32, rounded once
        E_loc = E // dist.group_size(e_axes)
        part = dist.map(lambda i, xi, ii, wi, gi, ui, di: _dense(
            xi, ii, wi, gi, ui, di, E, dist.mesh.rank(i, e_axes) * E_loc),
            x, idx, weights, w["w_gate"], w["w_up"], w["w_down"], pos=True,
            spec=x.spec)
        out = dist.psum(part, e_axes)
        return dist.map(lambda o, xi: o.to(xi.dtype), out, x,
                        spec=x.spec), aux
    B_loc, S_loc = x.local_shape[:2]
    cap = int(cfg.capacity_factor * B_loc * S_loc * K / E) + 1
    cap = -(-cap // 8) * 8  # round to 8 for tiling, as the reference
    buf, keep, slot = dist.map(
        lambda xi, ii: _buffers(xi, ii, E, K, cap), x, idx)
    buf = dist.all_to_all(buf, e_axes, split_dim=0, concat_dim=1)
    y = dist.map(_experts, buf, w["w_gate"], w["w_up"], w["w_down"])
    y = dist.all_to_all(y, e_axes, split_dim=1, concat_dim=0)
    out = dist.map(_combine, x, y, weights, keep, slot, spec=x.spec)
    return out, aux
