"""GQA attention blocks of the language models: self attention (causal in
the decoders, bidirectional in the encoder-decoder's encoder) and the
encoder-decoder's cross attention.

The reference shards q, k and v differently per mode (train / prefill /
decode) over its mesh.  Without a mesh those constraints are no-ops, and
the functions below run one layout.  On a mesh (``dist`` a
``models.sharding.Distribution`` with one) the serving functions run the
reference's layouts over ``Sharded`` values, with every weight whole on
each position at its use (``Distribution.gather_all``):

* prefill and the ``sp`` train layout (``self_attention_mesh``): q
  sharded along its sequence ("seq"), k and v gathered whole per data
  shard, and each position's flash attention called with its block's
  ``q_offset`` (under autograd its backward runs at that offset, and the
  gather's transpose sums each block's share of dk and dv back);
* the ``batch_full`` train layout (``cfg.attn_layout``, the default): q, k
  and v resharded to the batch over every mesh axis ("batch_full", as far
  as it divides the batch), so that each position owns whole sequences
  and runs the attention locally at offset 0; the output goes back to
  (batch, seq);
* decode (``decode_self_attention_mesh``): the new token's k and v
  written into the one position that owns its cache slot, then
  ``layers.dist_decode_attention`` over the cache's ``kv_seq`` shards;
* the encoder-decoder's cross attention (``make_cross_kv`` and
  ``cross_attention`` with ``dist``): k and v (batch, kv_seq); in training
  and prefill q sharded along its sequence against the encoder's keys
  gathered whole, not causal (each block's ``q_offset`` passed, and
  ignored: no key is hidden); in decode ``dist_decode_attention`` over the
  encoder's keys, the query after the last of them.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers
from repro_torch.models.params import Def
from repro_torch.models.sharding import on_mesh


def attn_defs(cfg: ModelConfig, stack: int = 0, d_model: int = 0) -> dict:
    """Param defs; ``stack`` > 0 prepends a stacked-layers dim."""
    D = d_model or cfg.d_model
    Dh = cfg.resolved_head_dim
    PQ, PKV = cfg.n_heads * Dh, cfg.n_kv_heads * Dh
    L = (stack,) if stack else ()
    La = ("layers",) if stack else ()
    d = {
        "wq": Def(L + (D, PQ), La + ("embed", "heads")),
        "wk": Def(L + (D, PKV), La + ("embed", "kv_heads")),
        "wv": Def(L + (D, PKV), La + ("embed", "kv_heads")),
        "wo": Def(L + (PQ, D), La + ("heads", "embed")),
    }
    if cfg.qkv_bias:
        d["bq"] = Def(L + (PQ,), La + ("heads",), init="zeros")
        d["bk"] = Def(L + (PKV,), La + ("kv_heads",), init="zeros")
        d["bv"] = Def(L + (PKV,), La + ("kv_heads",), init="zeros")
    if cfg.qk_norm:
        d["q_norm"] = Def(L + (Dh,), La + (None,), init="zeros")
        d["k_norm"] = Def(L + (Dh,), La + (None,), init="zeros")
    return d


def _project(cfg: ModelConfig, p: dict, x: torch.Tensor):
    """q (B, S, Hq, Dh), k and v (B, S, Hkv, Dh) in x's type: projections,
    the optional qkv bias, the optional qk-norm over Dh."""
    B, S, _ = x.shape
    Dh = cfg.resolved_head_dim
    q = x @ p["wq"].to(x.dtype)
    k = x @ p["wk"].to(x.dtype)
    v = x @ p["wv"].to(x.dtype)
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    q = q.reshape(B, S, cfg.n_heads, Dh)
    k = k.reshape(B, S, cfg.n_kv_heads, Dh)
    v = v.reshape(B, S, cfg.n_kv_heads, Dh)
    if cfg.qk_norm:
        q = layers.rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = layers.rms_norm(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


def _out(cfg: ModelConfig, p: dict, o: torch.Tensor) -> torch.Tensor:
    B, S = o.shape[:2]
    o = o.reshape(B, S, cfg.n_heads * cfg.resolved_head_dim)
    return o @ p["wo"].to(o.dtype)


def self_attention(cfg: ModelConfig, p: dict, x: torch.Tensor, *,
                   window: int = 0, theta: Optional[float] = None,
                   causal: bool = True, dist=None) -> torch.Tensor:
    """Full-sequence self attention (train / prefill), rope'd q and k;
    ``causal=False`` for the encoder.  On a mesh: the output of
    ``self_attention_mesh``."""
    if on_mesh(dist):
        return self_attention_mesh(cfg, p, x, dist=dist, window=window,
                                   theta=theta, causal=causal)[0]
    positions = torch.arange(x.shape[1], device=x.device)
    q, k, v = _project(cfg, p, x)
    if theta is None:
        theta = cfg.rope_theta
    q = layers.rope(q, positions, theta)
    k = layers.rope(k, positions, theta)
    o = layers.flash_attention(q, k, v, causal=causal, window=window)
    return _out(cfg, p, o)


def _cross_kv(cfg: ModelConfig, p: dict, enc_out: torch.Tensor) -> tuple:
    B, S, _ = enc_out.shape
    Dh = cfg.resolved_head_dim
    k = (enc_out @ p["wk"].to(enc_out.dtype)).reshape(B, S, cfg.n_kv_heads, Dh)
    v = (enc_out @ p["wv"].to(enc_out.dtype)).reshape(B, S, cfg.n_kv_heads, Dh)
    return k, v


def make_cross_kv(cfg: ModelConfig, p: dict, enc_out, *,
                  dist=None) -> tuple:
    """The cross attention's k and v (B, S_enc, Hkv, Dh) from the encoder's
    output, in its type (no bias, no norm, no rope); on a mesh (``p``
    whole on every position, ``enc_out`` (batch, seq)) each position's
    rows, constrained (batch, kv_seq)."""
    if not on_mesh(dist):
        return _cross_kv(cfg, p, enc_out)
    spec = enc_out.spec + ((),)
    k, v = dist.map(lambda pi, ei: _cross_kv(cfg, pi, ei), p, enc_out,
                    spec=(spec, spec))
    return tuple(dist.constrain(t, "batch", "kv_seq", None, None)
                 for t in (k, v))


def _cross_q(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    B, S, _ = x.shape
    return (x @ p["wq"].to(x.dtype)).reshape(B, S, cfg.n_heads,
                                             cfg.resolved_head_dim)


def _cross_decode(q, k, v, dist=None):
    """Each query placed after the last encoder slot, as the
    reference's."""
    S_enc, dev = k.shape[1], (q.first if on_mesh(dist) else q).device
    k_pos = torch.arange(S_enc, device=dev)
    q_pos = torch.full((q.shape[1],), S_enc, dtype=torch.int64, device=dev)
    return layers.dist_decode_attention(q, k, v, q_pos, k_pos, dist=dist)


def cross_attention(cfg: ModelConfig, p: dict, x, enc_kv: tuple, *,
                    mode: str, dist=None):
    """Encoder-decoder cross attention: no rope, every encoder slot
    visible.  ``mode`` "train" / "prefill" runs the flash-attention kernel
    (not causal, Sq != Sk); "decode" runs ``decode_attention`` with each
    query placed after the last encoder slot, as the reference's.  On a
    mesh (``p`` whole on every position; x (batch, seq) or, in decode,
    (batch); ``enc_kv`` (batch, kv_seq)): q along x's sequence against
    the keys gathered whole per data shard, each position's block at its
    ``q_offset``, or ``dist_decode_attention`` over the keys' shards."""
    if not on_mesh(dist):
        q, (k, v) = _cross_q(cfg, p, x), enc_kv
        o = (_cross_decode(q, k, v) if mode == "decode"
             else layers.flash_attention(q, k, v, causal=False))
        return _out(cfg, p, o)
    q = dist.map(lambda pi, xi: _cross_q(cfg, pi, xi), p, x,
                 spec=x.spec + ((),))
    k, v = enc_kv
    if mode == "decode":
        o = _cross_decode(q, k, v, dist)
        return _out_mesh(cfg, p, o, dist, None)
    q = dist.constrain(q, "batch", "seq", None, None)
    k, v = (dist.constrain(t, "batch", None, None, None) for t in (k, v))
    o = dist.map(lambda i, qi, ki, vi: layers.flash_attention(
        qi, ki, vi, causal=False, q_offset=dist.block_start(q, 1, i)),
        q, k, v, pos=True, spec=q.spec)
    return _out_mesh(cfg, p, o, dist, "seq")


def decode_self_attention(cfg: ModelConfig, p: dict, x: torch.Tensor,
                          cache: dict, pos: int, *, window: int = 0,
                          theta: Optional[float] = None, dist=None) -> tuple:
    """One-token self attention against a KV cache.

    cache: {"k": (B, Smax, Hkv, Dh), "v": same}; ``pos`` (a host int) is the
    number of tokens already in the cache, the new token's position.  The
    new k and v are written into the cache tensors in place (the reference
    returns updated copies); returns (out, cache).  On a mesh:
    ``decode_self_attention_mesh``."""
    if on_mesh(dist):
        return decode_self_attention_mesh(cfg, p, x, cache, pos, dist=dist,
                                          window=window, theta=theta)
    S = x.shape[1]  # 1
    q, k_new, v_new = _project(cfg, p, x)
    if theta is None:
        theta = cfg.rope_theta
    positions = pos + torch.arange(S, device=x.device)
    q = layers.rope(q, positions, theta)
    k_new = layers.rope(k_new, positions, theta)
    k, v = cache["k"], cache["v"]
    k[:, pos:pos + S] = k_new.to(k.dtype)
    v[:, pos:pos + S] = v_new.to(v.dtype)
    idx = torch.arange(k.shape[1], device=x.device)
    k_pos = torch.where(idx <= pos, idx, -1)  # only filled slots are valid
    o = layers.decode_attention(q, k, v, positions, k_pos, window=window)
    return _out(cfg, p, o), cache


# ------------------------------------------------------------------ mesh ----

def _out_mesh(cfg: ModelConfig, p: dict, o, dist, seq_axis):
    """The output projection on a mesh: o (B, S, Hq, Dh) -> (B, S, D),
    constrained as the reference's ``_out``; where "heads" shards o's
    packed dim, the product is the partial sums' ``psum``."""
    spec = o.spec[:2] + ((),)
    o = dist.map(lambda t: t.reshape(*t.shape[:2], -1), o, spec=spec)
    o = dist.constrain(o, "batch", seq_axis, "heads")
    out = dist.matmul(o, p["wo"])
    return dist.constrain(out, "batch", seq_axis, "embed")


def self_attention_mesh(cfg: ModelConfig, p: dict, x, *, dist,
                        window: int = 0, theta: Optional[float] = None,
                        mode: str = "prefill", causal: bool = True):
    """Self attention of the prefill or of training on a mesh (causal, or
    the encoder's bidirectional one: each block's offset is passed and
    ignored there).
    ``p`` holds the layer's weights whole on every position; x (B, S, D)
    is sharded (batch, seq).  Each position ropes its rows at their
    absolute positions.  In prefill and under ``cfg.attn_layout == "sp"``,
    q stays sharded along seq, k and v are gathered whole per data shard,
    and the flash attention of each position sees its rows at ``q_offset``
    = its block's start; in training under ``"batch_full"``, q, k and v are
    resharded to ("batch_full", None) and each position attends over whole
    sequences.  Returns (out, k, v): k and v (B, S, Hkv, Dh) as the
    attention read them (in prefill whole per data shard, for the
    cache)."""
    if theta is None:
        theta = cfg.rope_theta
    spec = x.spec + ((),)
    q, k, v = dist.map(lambda pi, xi: _project(cfg, pi, xi), p, x,
                       spec=(spec,) * 3)

    def rot(i, qi, ki):
        positions = dist.block_start(x, 1, i) + torch.arange(
            qi.shape[1], device=qi.device)
        return (layers.rope(qi, positions, theta),
                layers.rope(ki, positions, theta))

    q, k = dist.map(rot, q, k, pos=True, spec=(spec,) * 2)
    if mode == "train" and cfg.attn_layout == "batch_full":
        q, k, v = (dist.constrain(t, "batch_full", None, None, None)
                   for t in (q, k, v))
    else:
        q = dist.constrain(q, "batch", "seq", None, None)
        k = dist.constrain(k, "batch", None, None, None)
        v = dist.constrain(v, "batch", None, None, None)
    o = dist.map(lambda i, qi, ki, vi: layers.flash_attention(
        qi, ki, vi, causal=causal, window=window,
        q_offset=dist.block_start(q, 1, i),
        kv_offset=dist.block_start(k, 1, i)), q, k, v, pos=True, spec=q.spec)
    return _out_mesh(cfg, p, o, dist, "seq"), k, v


def decode_self_attention_mesh(cfg: ModelConfig, p: dict, x, cache: dict,
                               pos: int, *, dist, window: int = 0,
                               theta: Optional[float] = None):
    """One-token self attention on a mesh against a cache sharded along
    its sequence (cache["k"], ["v"]: (B, Smax, Hkv, Dh) ``Sharded``).  The
    new token's k and v are written, in place, only into the position whose
    block holds slot ``pos``; then ``dist_decode_attention`` over the
    cache's shards.  Returns (out, cache)."""
    if theta is None:
        theta = cfg.rope_theta
    spec = x.spec + ((),)
    q, k_new, v_new = dist.map(lambda pi, xi: _project(cfg, pi, xi), p, x,
                               spec=(spec,) * 3)
    dev = x.first.device
    positions = pos + torch.arange(x.shape[1], device=dev)

    def rot(qi, ki):
        at = positions.to(qi.device)
        return layers.rope(qi, at, theta), layers.rope(ki, at, theta)

    q, k_new = dist.map(rot, q, k_new, spec=(spec,) * 2)
    k, v = cache["k"], cache["v"]
    if k.spec[0] != k_new.spec[0]:
        raise ValueError(f"the cache's batch layout {k.spec[0]} is not the "
                         f"tokens' {k_new.spec[0]}")
    S_loc = k.local_shape[1]
    for i in dist.mesh.active:
        lo = dist.block_start(k, 1, i)
        if lo <= pos < lo + S_loc:
            for c, new in ((k, k_new), (v, v_new)):
                t = c.local(i)
                t[:, pos - lo:pos - lo + 1] = new.local(i).to(t.dtype)
    idx = torch.arange(k.shape[1], device=dev)
    k_pos = torch.where(idx <= pos, idx, -1)  # only filled slots are valid
    o = layers.dist_decode_attention(q, k, v, positions, k_pos, dist=dist,
                                     window=window)
    return _out_mesh(cfg, p, o, dist, None), cache
