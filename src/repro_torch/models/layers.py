"""Shared neural-net layers of the language models.

Plain functions over explicit parameter dicts, in the reference package's
layouts (activations (B, S, H, Dh), weights (d_in, d_out)).  Attention comes
in two flavours:

* ``flash_attention``   chunked online-softmax attention with GQA, a
                        per-call window and query / key offsets: the
                        hand-written Hopper kernel on CUDA tensors
                        (``kernels/flash_attention.py``), its plain version
                        on CPU tensors.
* ``decode_attention``  single-step attention over a whole KV cache, plain
                        PyTorch (the reference writes it in jnp too).
* ``dist_decode_attention`` flash-decode over a mesh: the KV cache stays
                        sharded along its sequence; each position computes
                        a partial (max, sum, weighted V) over its slice and
                        the partials combine with a global log-sum-exp
                        (``pmax``, then ``psum`` in position order).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ref import NEG_INF, attn_mask
from repro_torch.models.sharding import on_mesh

__all__ = ["NEG_INF", "rms_norm", "rope", "attn_mask", "flash_attention",
           "decode_attention", "dist_decode_attention", "swiglu_mlp",
           "masked_ce"]


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """RMS norm with the ``1 + scale`` gain (zero-initialised scale), in f32,
    returned in ``x``'s type."""
    dt = x.dtype
    x = x.float()
    var = (x * x).mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * (1.0 + scale.float())).to(dt)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embedding (halves rotated).  x (..., S, H, Dh); positions
    broadcastable to (..., S)."""
    half = x.shape[-1] // 2
    freqs = torch.exp(-math.log(theta)
                      * torch.arange(half, dtype=torch.float32,
                                     device=x.device) / half)
    ang = positions.float()[..., None] * freqs  # (..., S, half)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     q_pos: torch.Tensor, k_pos: torch.Tensor, *,
                     window: int = 0) -> torch.Tensor:
    """Single-/few-token attention over a (possibly stale-padded) KV cache.

    q (B, Sq, Hq, Dh); k, v (B, Skv, Hkv, Dh); k_pos (Skv,) absolute
    positions, entries < 0 are invalid slots.  Scores and softmax in f32,
    probabilities rounded to v's type before ``p @ v``, as the reference.
    """
    B, Sq, Hq, Dh = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    # filled on the device: a tensor copied from the host would make every
    # layer of every decode step wait for the queued device work
    scale = torch.full((), Dh ** -0.5, dtype=q.dtype, device=q.device)
    qg = q.reshape(B, Sq, Hkv, G, Dh) * scale
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float())
    mask = attn_mask(q_pos, k_pos, causal=True, window=window,
                     k_valid=k_pos >= 0)
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bhgqd", p.to(v.dtype).float(), v.float())
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, Dh).to(q.dtype)


def dist_decode_attention(q, k, v, q_pos: torch.Tensor, k_pos: torch.Tensor,
                          *, dist, window: int = 0,
                          kv_logical: str = "kv_seq"):
    """Flash-decode with the KV cache sharded along its sequence.

    q (B, Sq, Hq, Dh), k and v (B, Skv, Hkv, Dh) are ``Sharded`` values of
    ``dist`` (plain tensors without a mesh); q_pos (Sq,) and k_pos (Skv,)
    are plain tensors of absolute positions (k_pos < 0: an empty slot).
    The mesh axes of ``kv_logical`` that divide Skv (and split it: size >
    1) shard the cache; with none, every position runs ``decode_attention``
    on its whole cache.  Otherwise q is resharded to (batch, None, None,
    None) and k, v to (batch, those axes, None, None), as the reference's
    ``shard_map`` specs ask, and each position computes over its slice
    m = max s, l = sum exp(s - m), u = exp(s - m) . v (p rounded to v's
    type), then o = psum(u e^{m - M}) / psum(l e^{m - M}) with M =
    pmax(m): the cache is never gathered."""
    if not on_mesh(dist):
        return decode_attention(q, k, v, q_pos, k_pos, window=window)
    mesh = dist.mesh
    Skv = k.shape[1]
    keep, size = [], 1
    for a in dist.axes_of(kv_logical):
        n = mesh.shape[a]
        if n > 1 and Skv % (size * n) == 0:
            keep.append(a)
            size *= n
    seq_axes = tuple(keep)
    batch = dist.layout("batch", shape=(q.shape[0],))[0]
    q = dist.reshard(q, (batch, (), (), ()))
    k = dist.reshard(k, (batch, seq_axes, (), ()))
    v = dist.reshard(v, (batch, seq_axes, (), ()))
    if not seq_axes:
        return dist.map(lambda qi, ki, vi: decode_attention(
            qi, ki, vi, q_pos.to(qi.device), k_pos.to(qi.device),
            window=window), q, k, v, spec=q.spec)
    S_loc = k.local_shape[1]

    def partial(i, qi, ki, vi):
        B, Sq, Hq, Dh = qi.shape
        Hkv = ki.shape[2]
        G = Hq // Hkv
        lo = mesh.rank(i, seq_axes) * S_loc
        kpi = k_pos[lo:lo + S_loc].to(qi.device)
        scale = torch.full((), Dh ** -0.5, dtype=qi.dtype, device=qi.device)
        qg = qi.reshape(B, Sq, Hkv, G, Dh) * scale
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), ki.float())
        mask = attn_mask(q_pos.to(qi.device), kpi, causal=True,
                         window=window, k_valid=kpi >= 0)
        s = torch.where(mask, s, NEG_INF)
        m = s.amax(dim=-1)
        p = torch.exp(s - m[..., None])
        u = torch.einsum("bhgqk,bkhd->bhgqd", p.to(vi.dtype).float(),
                         vi.float())
        return m, p.sum(dim=-1), u

    m, l, u = dist.map(partial, q, k, v, pos=True)
    M = dist.pmax(m, seq_axes)
    a = dist.map(lambda mi, Mi: torch.exp(mi - Mi), m, M)
    num = dist.psum(dist.map(lambda ui, ai: ui * ai[..., None], u, a),
                    seq_axes)
    den = dist.psum(dist.map(torch.mul, l, a), seq_axes)

    def finish(qi, ni, di):
        B, Sq, Hq, Dh = qi.shape
        o = ni / di.clamp_min(1e-30)[..., None]
        return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, Dh).to(qi.dtype)

    return dist.map(finish, q, num, den, spec=q.spec)



def swiglu_mlp(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Gated MLP: ``(silu(x W_gate) * x W_up) W_down`` in x's type."""
    h = x @ p["w_gate"].to(x.dtype)
    u = x @ p["w_up"].to(x.dtype)
    return (F.silu(h) * u) @ p["w_down"].to(x.dtype)


def masked_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross entropy from f32 logits over the unmasked
    labels (labels < 0 are masked), the reference's ``loss_fn`` CE."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.clamp_min(0).long()[..., None])[..., 0]
    mask = (labels >= 0).float()
    return ((lse - ll) * mask).sum() / mask.sum().clamp_min(1.0)
