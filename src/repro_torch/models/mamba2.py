"""Mamba2 (SSD, state-space duality) mixer.

Prefill and training use the chunked SSD algorithm (arXiv:2405.21060):
within a chunk of ``cfg.ssd_chunk`` positions, "attention-like" products
over a (Q, Q) decay matrix; across chunks, the recurrence h_c = a_c h_{c-1}
+ S_c over the chunks' summary states.  Decode is the O(1) recurrence
h = exp(dt A) h + dt B ⊗ x.  ``ssd_sequential`` is the step-by-step oracle
of the tests.

The reference combines the chunk states with ``jax.lax.associative_scan``
(a tree); the port runs the recurrence as a loop over the chunks, which
rounds differently in the last bits.  The reference's ``seq_sp`` and
``head_tp`` mixer layouts are sharding constraints for a mesh; on one
device they do nothing, so the port has one layout.  Heads of one B/C
group share their group's B and C by broadcasting (the reference repeats
them per head): the same products, without the (B, c, Q, H, N) copies.
Everything here is plain PyTorch, as in the reference (no Pallas kernel).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import rms_norm
from repro_torch.models.params import Def
from repro_torch.utils import resolve_device


def mamba_defs(cfg: ModelConfig, stack: int = 0) -> dict:
    D, din = cfg.d_model, cfg.d_inner
    N, G, H, W = cfg.ssm_state, cfg.ssm_ngroups, cfg.ssm_nheads, cfg.conv_width
    L = (stack,) if stack else ()
    La = ("layers",) if stack else ()
    return {
        "w_z": Def(L + (D, din), La + ("embed", "ssm_inner")),
        "w_x": Def(L + (D, din), La + ("embed", "ssm_inner")),
        "w_B": Def(L + (D, G * N), La + ("embed", None)),
        "w_C": Def(L + (D, G * N), La + ("embed", None)),
        "w_dt": Def(L + (D, H), La + ("embed", "ssm_heads")),
        "conv_x_w": Def(L + (W, din), La + (None, "ssm_inner"), scale=0.5),
        "conv_x_b": Def(L + (din,), La + ("ssm_inner",), init="zeros"),
        "conv_B_w": Def(L + (W, G * N), La + (None, None), scale=0.5),
        "conv_B_b": Def(L + (G * N,), La + (None,), init="zeros"),
        "conv_C_w": Def(L + (W, G * N), La + (None, None), scale=0.5),
        "conv_C_b": Def(L + (G * N,), La + (None,), init="zeros"),
        "A_log": Def(L + (H,), La + ("ssm_heads",), init="ones"),
        "D": Def(L + (H,), La + ("ssm_heads",), init="ones"),
        "dt_bias": Def(L + (H,), La + ("ssm_heads",), init="zeros"),
        "norm": Def(L + (din,), La + ("ssm_inner",), init="zeros"),
        "w_out": Def(L + (din, D), La + ("ssm_inner", "embed")),
    }


def causal_conv(x: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal convolution, x (B, S, C), w (W, C): the taps summed
    in f32 in order, then silu, returned in x's type."""
    W, S = w.shape[0], x.shape[1]
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for k in range(W):
        shift = W - 1 - k
        xs = F.pad(x, (0, 0, shift, 0))[:, :S]
        out = out + xs.float() * w[k].float()
    return F.silu(out + b.float()).to(x.dtype)


def causal_conv_step(x_new: torch.Tensor, conv_state: torch.Tensor,
                     w: torch.Tensor, b: torch.Tensor) -> tuple:
    """One decode step; ``conv_state`` (B, W-1, C) holds the raw input's
    tail.  Returns (out (B, 1, C) in x's type, the new tail)."""
    window = torch.cat([conv_state, x_new], dim=1)  # (B, W, C)
    out = torch.einsum("bwc,wc->bc", window.float(), w.float())
    out = F.silu(out + b.float())[:, None]
    return out.to(x_new.dtype), window[:, 1:]


def _project(cfg: ModelConfig, p: dict, x: torch.Tensor):
    """x (B, S, D) -> z, x, B, C (B, S, width) in x's type and dt (B, S, H)
    f32 (softplus of the projection plus its bias, in f32)."""
    z = x @ p["w_z"].to(x.dtype)
    xr = x @ p["w_x"].to(x.dtype)
    Br = x @ p["w_B"].to(x.dtype)
    Cr = x @ p["w_C"].to(x.dtype)
    dt = x @ p["w_dt"].to(x.dtype)
    dt = F.softplus(dt.float() + p["dt_bias"].float())
    return z, xr, Br, Cr, dt


def ssd_chunked(x, dt, A, B_, C_, D_, chunk: int, h0=None,
                compute_dtype=torch.float32):
    """Chunked SSD.  x (B, S, H, P) values; dt (B, S, H) f32; A (H,)
    negative; B_, C_ (B, S, G, N); D_ (H,).  Returns (y (B, S, H, P) f32,
    h_final (B, H, N, P) f32).  S need not be a multiple of ``chunk``: the
    tail is zero-padded (dt 0 there, so the padding leaves h unchanged).

    ``compute_dtype=torch.bfloat16`` keeps the decay cumsums in f32 but
    stores the (Q, Q) intra-chunk tensors and runs the large products in
    bf16, as the reference's switch does."""
    Bb, S, H, P_ = x.shape
    G, N = B_.shape[2], B_.shape[3]
    HG = H // G
    cd = compute_dtype
    pad = (-S) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B_ = F.pad(B_, (0, 0, 0, 0, 0, pad))
        C_ = F.pad(C_, (0, 0, 0, 0, 0, pad))
    Sp = S + pad
    c, Q = Sp // chunk, chunk

    xc = x.reshape(Bb, c, Q, G, HG, P_)
    dtc = dt.reshape(Bb, c, Q, H)
    Bc = B_.reshape(Bb, c, Q, G, N)
    Cc = C_.reshape(Bb, c, Q, G, N)

    cum = torch.cumsum(dtc * A, dim=2)  # (B, c, Q, H), inclusive, negative

    # intra-chunk: M[q, k] = (C_q . B_k) exp(cum_q - cum_k) dt_k for k <= q
    CB = torch.einsum("bcqgn,bckgn->bcgqk", Cc.float(), Bc.float())
    cumT = cum.permute(0, 1, 3, 2)  # (B, c, H, Q)
    Ldec = cumT[..., :, None] - cumT[..., None, :]  # (B, c, H, Q, K)
    causal = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    # exp of -inf where masked: 0, as the reference's where(mask, exp, 0),
    # without the inf above the diagonal that would poison a gradient
    Lmat = torch.exp(Ldec.masked_fill(~causal, float("-inf"))).to(cd)
    M = (CB.to(cd)[:, :, :, None] * Lmat.reshape(Bb, c, G, HG, Q, Q)
         * dtc.to(cd).permute(0, 1, 3, 2).reshape(Bb, c, G, HG, 1, Q))
    y_intra = torch.einsum("bcgjqk,bckgjp->bcqgjp", M, xc.to(cd)).float()
    del Ldec, Lmat, M

    # chunk summary states: S_c = sum_k exp(cum_end - cum_k) dt_k B_k x_k
    dec_end = torch.exp(cum[:, :, -1:, :] - cum)  # (B, c, Q, H)
    w = (dec_end * dtc).to(cd).reshape(Bb, c, Q, G, HG, 1)
    Sc = torch.einsum("bckgn,bckgjp->bcgjnp", Bc.to(cd),
                      w * xc.to(cd)).float().reshape(Bb, c, H, N, P_)

    # inter-chunk recurrence h_c = a_c h_{c-1} + S_c, a loop over chunks
    a_c = torch.exp(cum[:, :, -1, :])  # (B, c, H)
    h = (torch.zeros((Bb, H, N, P_), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    h_prev = []
    for i in range(c):
        h_prev.append(h)
        h = a_c[:, i, :, None, None] * h + Sc[:, i]
    h_final = h
    h_prev = torch.stack(h_prev, dim=1)  # (B, c, H, N, P): entering chunk

    # inter-chunk contribution: y_q += exp(cum_q) C_q . h_prev
    dec_in = torch.exp(cum)  # (B, c, Q, H)
    y_inter = torch.einsum(
        "bcqgn,bcgjnp->bcqgjp", Cc.to(cd),
        h_prev.to(cd).reshape(Bb, c, G, HG, N, P_)).float()
    y_inter = y_inter * dec_in.to(cd).float().reshape(Bb, c, Q, G, HG, 1)

    y = (y_intra + y_inter).reshape(Bb, c, Q, H, P_) \
        + D_.float()[:, None] * xc.float().reshape(Bb, c, Q, H, P_)
    y = y.reshape(Bb, Sp, H, P_)[:, :S]
    return y, h_final


def ssd_sequential(x, dt, A, B_, C_, D_, h0=None):
    """Step-by-step oracle: h_t = exp(dt_t A) h_{t-1} + dt_t B_t ⊗ x_t,
    y_t = C_t . h_t + D x_t, all in f32."""
    Bb, S, H, P_ = x.shape
    G, N = B_.shape[2], B_.shape[3]
    HG = H // G
    h = (torch.zeros((Bb, H, N, P_), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    ys = []
    for t in range(S):
        da = torch.exp(dt[:, t] * A)  # (B, H)
        Bh = B_[:, t].float().repeat_interleave(HG, dim=1)  # (B, H, N)
        Ch = C_[:, t].float().repeat_interleave(HG, dim=1)
        h = da[..., None, None] * h + (dt[:, t, :, None, None] * Bh[..., None]
                                       * x[:, t, :, None, :].float())
        ys.append(torch.einsum("bhn,bhnp->bhp", Ch, h))
    y = torch.stack(ys, dim=1) + D_.float()[:, None] * x.float()
    return y, h


def mamba_block(cfg: ModelConfig, p: dict, x: torch.Tensor, *,
                h0=None) -> tuple:
    """The mixer on a (B, S, D) input.  Returns (out (B, S, D) in x's
    type, h_final (B, H, N, P) f32)."""
    B, S, _ = x.shape
    H, P_, N, G = cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state, cfg.ssm_ngroups
    z, xr, Br, Cr, dt = _project(cfg, p, x)
    xr = causal_conv(xr, p["conv_x_w"], p["conv_x_b"])
    Br = causal_conv(Br, p["conv_B_w"], p["conv_B_b"])
    Cr = causal_conv(Cr, p["conv_C_w"], p["conv_C_b"])
    A = -torch.exp(p["A_log"].float())
    y, h_final = ssd_chunked(
        xr.reshape(B, S, H, P_), dt, A, Br.reshape(B, S, G, N),
        Cr.reshape(B, S, G, N), p["D"], cfg.ssd_chunk, h0=h0,
        compute_dtype=torch.bfloat16 if cfg.ssd_bf16 else torch.float32)
    y = y.reshape(B, S, cfg.d_inner)
    y = rms_norm((y * F.silu(z.float())).to(x.dtype), p["norm"], cfg.norm_eps)
    return y @ p["w_out"].to(x.dtype), h_final


def mamba_decode_step(cfg: ModelConfig, p: dict, x: torch.Tensor,
                      state: dict) -> tuple:
    """One token, x (B, 1, D).  ``state``: {"h": (B, H, N, P) f32,
    "conv_x", "conv_B", "conv_C": (B, W-1, width)}.  Returns (out (B, 1,
    D), the new state as a new dict; ``state`` is left as it was)."""
    B = x.shape[0]
    H, P_, N, G = cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state, cfg.ssm_ngroups
    HG = H // G
    z, xr, Br, Cr, dt = _project(cfg, p, x)
    xr, cs_x = causal_conv_step(xr, state["conv_x"], p["conv_x_w"],
                                p["conv_x_b"])
    Br, cs_B = causal_conv_step(Br, state["conv_B"], p["conv_B_w"],
                                p["conv_B_b"])
    Cr, cs_C = causal_conv_step(Cr, state["conv_C"], p["conv_C_w"],
                                p["conv_C_b"])
    xh = xr.reshape(B, H, P_).float()
    Bm = Br.reshape(B, G, N).repeat_interleave(HG, dim=1).float()
    Cm = Cr.reshape(B, G, N).repeat_interleave(HG, dim=1).float()
    dt1 = dt[:, 0]  # (B, H)
    A = -torch.exp(p["A_log"].float())
    da = torch.exp(dt1 * A)
    h = (da[..., None, None] * state["h"]
         + dt1[..., None, None] * Bm[..., None] * xh[..., None, :])
    y = torch.einsum("bhn,bhnp->bhp", Cm, h) + p["D"].float()[:, None] * xh
    y = y.reshape(B, 1, cfg.d_inner)
    y = rms_norm((y * F.silu(z.float())).to(x.dtype), p["norm"], cfg.norm_eps)
    out = y @ p["w_out"].to(x.dtype)
    return out, {"h": h, "conv_x": cs_x, "conv_B": cs_B, "conv_C": cs_C}


def init_mamba_state(cfg: ModelConfig, batch: int,
                     dtype: torch.dtype = torch.bfloat16,
                     device="cuda") -> dict:
    """One layer's zero decode state on ``device`` (the card unless the
    caller asks for the CPU; raises without one): ``h`` f32, the conv
    tails in ``dtype``."""
    device = resolve_device(device)
    H, P_, N, W = cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state, cfg.conv_width
    gn = cfg.ssm_ngroups * N
    return {
        "h": torch.zeros((batch, H, N, P_), dtype=torch.float32,
                         device=device),
        "conv_x": torch.zeros((batch, W - 1, cfg.d_inner), dtype=dtype,
                              device=device),
        "conv_B": torch.zeros((batch, W - 1, gn), dtype=dtype, device=device),
        "conv_C": torch.zeros((batch, W - 1, gn), dtype=dtype, device=device),
    }
