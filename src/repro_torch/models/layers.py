"""Shared neural-net layers of the language models.

Plain functions over explicit parameter dicts, in the reference package's
layouts (activations (B, S, H, Dh), weights (d_in, d_out)).  Attention comes
in two flavours:

* ``flash_attention``   chunked online-softmax attention with GQA and a
                        per-call window: the hand-written Hopper kernel on
                        CUDA tensors (``kernels/flash_attention.py``), its
                        plain version on CPU tensors.
* ``decode_attention``  single-step attention over a whole KV cache, plain
                        PyTorch (the reference writes it in jnp too).

The reference's ``dist_decode_attention`` (the KV cache sharded along its
sequence over a mesh) is ``decode_attention`` on one device, which is all
the port runs.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ref import NEG_INF, attn_mask

__all__ = ["NEG_INF", "rms_norm", "rope", "attn_mask", "flash_attention",
           "decode_attention", "swiglu_mlp", "masked_ce"]


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
