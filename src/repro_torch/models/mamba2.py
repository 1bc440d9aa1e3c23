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
device they do nothing.  On a mesh (``mamba_block_mesh``,
``mamba_decode_step_mesh``) the port runs them over ``Sharded`` values:
``head_tp`` splits the heads, ``seq_sp`` the sequence (the convolution's
halo a shift of each block's last rows to the next, the inter-chunk carry
an exclusive scan in position order: the meshless recurrence's order of
operations).  The gated norm reads whole rows on both, so it sums in the
meshless order.  Decode projects on the weights' own column blocks and
gathers w_out whole (``_decode_out``).  Heads of one B/C
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


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                halo=None) -> torch.Tensor:
    """Depthwise causal convolution, x (B, S, C), w (W, C): the taps summed
    in f32 in order, then silu, returned in x's type.  ``halo`` (B, W - 1,
    C) holds the rows before x's first (a sequence block's predecessor's
    last rows on a mesh); None: zeros."""
    W, S = w.shape[0], x.shape[1]
    if halo is not None:
        ext = torch.cat([halo, x], dim=1)
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for k in range(W):
        shift = W - 1 - k
        xs = (F.pad(x, (0, 0, shift, 0))[:, :S] if halo is None
              else ext[:, W - 1 - shift:W - 1 - shift + S])
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


def _project(cfg: ModelConfig, p: dict, x: torch.Tensor, h0: int = 0,
             n: int = 0):
    """x (B, S, D) -> z, x (B, S, n P), B, C (B, S, G N) in x's type and
    dt (B, S, n) f32 (softplus of the projection plus its bias, in f32),
    for the ``n`` heads from ``h0`` (every head where ``n`` is 0)."""
    n = n or cfg.ssm_nheads
    cols = slice(h0 * cfg.ssm_headdim, (h0 + n) * cfg.ssm_headdim)
    # (contiguous: a weight already in x's type stays a strided view)
    z = x @ p["w_z"][:, cols].to(x.dtype).contiguous()
    xr = x @ p["w_x"][:, cols].to(x.dtype).contiguous()
    Br = x @ p["w_B"].to(x.dtype)
    Cr = x @ p["w_C"].to(x.dtype)
    dt = x @ p["w_dt"][:, h0:h0 + n].to(x.dtype).contiguous()
    dt = F.softplus(dt.float() + p["dt_bias"][h0:h0 + n].float())
    return z, xr, Br, Cr, dt


def ssd_chunked(x, dt, A, B_, C_, D_, chunk: int, h0=None,
                compute_dtype=torch.float32):
    """Chunked SSD.  x (B, S, H, P) values; dt (B, S, H) f32; A (H,)
    negative; B_, C_ (B, S, G, N); D_ (H,).  Returns (y (B, S, H, P) f32,
    h_final (B, H, N, P) f32).  S need not be a multiple of ``chunk``: the
    tail is zero-padded (dt 0 there, so the padding leaves h unchanged).

    ``compute_dtype=torch.bfloat16`` keeps the decay cumsums in f32 but
    stores the (Q, Q) intra-chunk tensors and runs the large products in
    bf16, as the reference's switch does.  Its three steps (``ssd_local``,
    ``ssd_carry``, ``ssd_out``) are the mesh's too: a sequence-sharded
    mixer runs the first and last on its chunks and the carry over every
    position's chunk states."""
    S = x.shape[1]
    t = ssd_local(x, dt, A, B_, C_, chunk, compute_dtype)
    h_prev, h_final = ssd_carry(t["a_c"], t["Sc"], h0)
    return ssd_out(t, h_prev, D_)[:, :S], h_final


def ssd_local(x, dt, A, B_, C_, chunk: int, compute_dtype=torch.float32
              ) -> dict:
    """What each chunk computes from its own positions: the intra-chunk
    output ``y_intra``, the chunk summary states ``Sc`` (B, c, H, N, P) f32
    and the chunks' decays ``a_c`` (B, c, H), with what ``ssd_out`` reads
    (the padded x and C, the decay cumsums)."""
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
    return {"y_intra": y_intra, "Sc": Sc, "a_c": torch.exp(cum[:, :, -1, :]),
            "cum": cum, "xc": xc, "Cc": Cc, "cd": cd}


def ssd_carry(a_c, Sc, h0=None) -> tuple:
    """The inter-chunk recurrence h_c = a_c h_{c-1} + S_c, a loop over the
    chunks in order: (the state entering each chunk (B, c, H, N, P), the
    state after the last) in f32."""
    Bb, c, H, N, P_ = Sc.shape
    h = (torch.zeros((Bb, H, N, P_), dtype=torch.float32, device=Sc.device)
         if h0 is None else h0.float())
    h_prev = []
    for i in range(c):
        h_prev.append(h)
        h = a_c[:, i, :, None, None] * h + Sc[:, i]
    return torch.stack(h_prev, dim=1), h


def ssd_out(t: dict, h_prev, D_):
    """y (B, c * Q, H, P) f32 of the chunks of ``ssd_local``'s ``t`` from
    the states entering them: the intra-chunk part, exp(cum_q) C_q .
    h_prev, and the skip D x."""
    xc, Cc, cum, cd = t["xc"], t["Cc"], t["cum"], t["cd"]
    Bb, c, Q, G, HG, P_ = xc.shape
    N = Cc.shape[-1]
    dec_in = torch.exp(cum)  # (B, c, Q, H)
    y_inter = torch.einsum(
        "bcqgn,bcgjnp->bcqgjp", Cc.to(cd),
        h_prev.to(cd).reshape(Bb, c, G, HG, N, P_)).float()
    y_inter = y_inter * dec_in.to(cd).float().reshape(Bb, c, Q, G, HG, 1)
    y = (t["y_intra"] + y_inter).reshape(Bb, c, Q, G * HG, P_) \
        + D_.float()[:, None] * xc.float().reshape(Bb, c, Q, G * HG, P_)
    return y.reshape(Bb, c * Q, G * HG, P_)


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


def _mixer(cfg: ModelConfig, p: dict, x: torch.Tensor, h0: int = 0,
           n: int = 0, h_in=None) -> tuple:
    """The mixer up to its gated norm, for the ``n`` heads from ``h0``
    (every head where ``n`` is 0): (bf16(y * silu(z)) (B, S, n P) in x's
    type, h_final (B, n, N, P) f32)."""
    B, S, _ = x.shape
    n = n or cfg.ssm_nheads
    P_, N = cfg.ssm_headdim, cfg.ssm_state
    cols = slice(h0 * P_, (h0 + n) * P_)
    g0, g1 = _groups(cfg, h0, n)
    z, xr, Br, Cr, dt = _project(cfg, p, x, h0, n)
    xr = causal_conv(xr, p["conv_x_w"][:, cols], p["conv_x_b"][cols])
    Br = causal_conv(Br, p["conv_B_w"], p["conv_B_b"])
    Cr = causal_conv(Cr, p["conv_C_w"], p["conv_C_b"])
    A = -torch.exp(p["A_log"][h0:h0 + n].float())
    G = cfg.ssm_ngroups
    y, h_final = ssd_chunked(
        xr.reshape(B, S, n, P_), dt, A, Br.reshape(B, S, G, N)[:, :, g0:g1],
        Cr.reshape(B, S, G, N)[:, :, g0:g1], p["D"][h0:h0 + n], cfg.ssd_chunk,
        h0=h_in, compute_dtype=_compute_dtype(cfg))
    y = y.reshape(B, S, n * P_)
    return (y * F.silu(z.float())).to(x.dtype), h_final


def _compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.ssd_bf16 else torch.float32


def _groups(cfg: ModelConfig, h0: int, n: int) -> tuple:
    """The B/C groups [g0, g1) that heads [h0, h0 + n) read (a block of
    heads holds whole groups, or lies inside one)."""
    HG = cfg.ssm_nheads // cfg.ssm_ngroups
    if n % HG and HG % n:
        raise ValueError(f"a block of {n} heads splits groups of {HG}")
    return h0 // HG, (h0 + n - 1) // HG + 1


def _gated_out(cfg: ModelConfig, p: dict, u: torch.Tensor) -> torch.Tensor:
    """The gated norm over the whole inner dim, then w_out."""
    return rms_norm(u, p["norm"], cfg.norm_eps) @ p["w_out"].to(u.dtype)


def mamba_block(cfg: ModelConfig, p: dict, x: torch.Tensor, *,
                h0=None) -> tuple:
    """The mixer on a (B, S, D) input.  Returns (out (B, S, D) in x's
    type, h_final (B, H, N, P) f32)."""
    u, h_final = _mixer(cfg, p, x, h_in=h0)
    return _gated_out(cfg, p, u), h_final


def _decode_heads(cfg: ModelConfig, p: dict, x: torch.Tensor, state: dict,
                  h0: int = 0, n: int = 0, own: bool = False) -> tuple:
    """One token through the mixer up to its gated norm, for the ``n``
    heads from ``h0`` (every head where ``n`` is 0): (bf16(y * silu(z))
    (B, 1, n P), the new state of those heads: ``h`` (B, n, N, P) and
    ``conv_x`` (B, W-1, n P), and the new ``conv_B``, ``conv_C``).  With
    ``own`` the per-head leaves of ``p`` hold those heads only (a
    position's blocks on a mesh)."""
    B = x.shape[0]
    n = n or cfg.ssm_nheads
    P_, N, G = cfg.ssm_headdim, cfg.ssm_state, cfg.ssm_ngroups
    HG = cfg.ssm_nheads // G
    w0 = 0 if own else h0  # where p's per-head leaves start
    cols = slice(w0 * P_, (w0 + n) * P_)
    z, xr, Br, Cr, dt = _project(cfg, p, x, w0, n)
    xr, cs_x = causal_conv_step(xr, state["conv_x"], p["conv_x_w"][:, cols],
                                p["conv_x_b"][cols])
    Br, cs_B = causal_conv_step(Br, state["conv_B"], p["conv_B_w"],
                                p["conv_B_b"])
    Cr, cs_C = causal_conv_step(Cr, state["conv_C"], p["conv_C_w"],
                                p["conv_C_b"])
    xh = xr.reshape(B, n, P_).float()
    Bm = Br.reshape(B, G, N).repeat_interleave(HG, dim=1)[:, h0:h0 + n]
    Cm = Cr.reshape(B, G, N).repeat_interleave(HG, dim=1)[:, h0:h0 + n]
    Bm, Cm = Bm.float(), Cm.float()
    dt1 = dt[:, 0]  # (B, n)
    A = -torch.exp(p["A_log"][w0:w0 + n].float())
    da = torch.exp(dt1 * A)
    h = (da[..., None, None] * state["h"]
         + dt1[..., None, None] * Bm[..., None] * xh[..., None, :])
    y = torch.einsum("bhn,bhnp->bhp", Cm, h) \
        + p["D"][w0:w0 + n].float()[:, None] * xh
    y = y.reshape(B, 1, n * P_)
    u = (y * F.silu(z.float())).to(x.dtype)
    return u, {"h": h, "conv_x": cs_x, "conv_B": cs_B, "conv_C": cs_C}


def mamba_decode_step(cfg: ModelConfig, p: dict, x: torch.Tensor,
                      state: dict) -> tuple:
    """One token, x (B, 1, D).  ``state``: {"h": (B, H, N, P) f32,
    "conv_x", "conv_B", "conv_C": (B, W-1, width)}.  Returns (out (B, 1,
    D), the new state as a new dict; ``state`` is left as it was)."""
    u, new = _decode_heads(cfg, p, x, state)
    return _gated_out(cfg, p, u), new


# ------------------------------------------------------------------ mesh ----

STATE_KEYS = ("h", "conv_x", "conv_B", "conv_C")


def _head_axes(cfg: ModelConfig, dist) -> tuple:
    """The mesh axes the heads split over ("ssm_heads" where it divides
    the head count; the inner channels, H P wide, split with them)."""
    return dist.layout("ssm_heads", shape=(cfg.ssm_nheads,))[0]


def _head_block(cfg: ModelConfig, dist, i: int, hax: tuple) -> tuple:
    """Position ``i``'s heads: (first, count)."""
    n = cfg.ssm_nheads // dist.group_size(hax)
    return dist.mesh.rank(i, hax) * n, n


def _mixer_out_mesh(cfg: ModelConfig, p, u, spec: tuple, dist):
    """``_gated_out`` on the mesh: u (B, S, d_inner) resharded to whole
    rows in ``spec`` (the block input's (batch, seq) layout; an all_to_all
    where the inner dim's split moves to the sequence), so that the norm
    sums every channel of a row in the meshless order."""
    u = dist.reshard(u, spec)
    return dist.map(lambda pi, ui: _gated_out(cfg, pi, ui), p, u, spec=spec)


def mamba_block_mesh(cfg: ModelConfig, p: dict, x, *, dist,
                     final_state: bool = True) -> tuple:
    """``mamba_block`` on ``dist``'s mesh: x (B, S, D) ``Sharded``
    (batch, seq); ``p`` the layer's weights whole on every position.
    Returns (out (B, S, D) in x's layout, h_final (B, H, N, P) f32:
    (batch, heads) under ``head_tp``, replicated over the sequence axes
    under ``seq_sp``, None there without ``final_state``).

    ``head_tp`` (the default): x is gathered along its sequence, each
    position projects, convolves and runs the SSD for its block of heads
    (its "ssm_heads" rank; B and C, one per group, whole on every
    position), and ``bf16(y * silu(z))`` goes back to whole rows of its
    sequence block (``_mixer_out_mesh``) for the norm and ``w_out``.

    ``seq_sp``: the sequence stays sharded, each block a whole number of
    SSD chunks.  Each position projects its rows; the convolutions read
    the previous block's last W - 1 raw rows (the halo: one ``shift`` of
    every block's tail along the sequence axes); each position computes
    its chunks' states and decays (``ssd_local``); the carry is an
    exclusive scan in position order (``Distribution.chain``): each
    position runs ``ssd_carry`` over its own chunks from the state the
    position before it passed on, and passes its final state on, which is
    the meshless recurrence's order of operations.  With ``final_state``
    the last block's final state is summed (with zeros) onto every
    position.  Without a sequence split both layouts run the meshless
    mixer on every position."""
    if cfg.mamba_layout == "seq_sp":
        return _seq_sp_block(cfg, p, x, dist, final_state)
    hax = _head_axes(cfg, dist)
    xf = dist.constrain(x, "batch", None, "embed")
    b = xf.spec[0]

    def local(i, pi, xi):
        return _mixer(cfg, pi, xi, *_head_block(cfg, dist, i, hax))

    u, h_final = dist.map(local, p, xf, pos=True,
                          spec=((b, (), hax), (b, hax, (), ())))
    return _mixer_out_mesh(cfg, p, u, x.spec, dist), h_final


def _seq_sp_block(cfg: ModelConfig, p: dict, x, dist, final_state: bool
                  ) -> tuple:
    b, sax = x.spec[0], x.spec[1]
    hspec = (b, (), (), ())
    if not sax:
        return dist.map(lambda pi, xi: mamba_block(cfg, pi, xi), p, x,
                        spec=(x.spec, hspec))
    B, S_loc = x.local_shape[:2]
    Q = cfg.ssd_chunk
    if S_loc % Q:
        raise ValueError(f"seq_sp: a sequence block of {S_loc} positions "
                         f"is not a whole number of SSD chunks of {Q}")
    H, P_, N, G = cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state, \
        cfg.ssm_ngroups
    W = cfg.conv_width
    z, xr, Br, Cr, dt = dist.map(lambda pi, xi: _project(cfg, pi, xi), p,
                                 x, spec=(x.spec,) * 5)
    tails = dist.map(lambda a, bb, c: torch.cat([a, bb, c], -1)[:, S_loc
                                                                - (W - 1):],
                     xr, Br, Cr, spec=x.spec)
    halo = dist.shift(tails, sax)  # the first block's: zeros
    local = {}

    def chunks(i, pi, xi, bi, ci, di, hi):
        din = xi.shape[-1]
        hx, hb, hc = hi.split([din, G * N, G * N], dim=-1)
        xi = causal_conv(xi, pi["conv_x_w"], pi["conv_x_b"], hx)
        bi = causal_conv(bi, pi["conv_B_w"], pi["conv_B_b"], hb)
        ci = causal_conv(ci, pi["conv_C_w"], pi["conv_C_b"], hc)
        A = -torch.exp(pi["A_log"].float())
        t = ssd_local(xi.reshape(B, S_loc, H, P_), di, A,
                      bi.reshape(B, S_loc, G, N), ci.reshape(B, S_loc, G, N),
                      Q, _compute_dtype(cfg))
        local[i] = t
        return t["a_c"], t["Sc"]

    a_c, Sc = dist.map(chunks, p, xr, Br, Cr, dt, halo, pos=True,
                       spec=((b, sax, ()), (b, sax, (), (), ())))

    def carry(i, h, ai, si):
        h_prev, h_out = ssd_carry(ai, si, h)
        return h_out, h_prev

    h_prev, h_out = dist.chain(carry, sax, a_c, Sc,
                               spec=(b, sax, (), (), ()))

    def finish(i, pi, zi, hi):
        y = ssd_out(local[i], hi, pi["D"]).reshape(B, S_loc, H * P_)
        u = (y * F.silu(zi.float())).to(zi.dtype)
        return _gated_out(cfg, pi, u)

    out = dist.map(finish, p, z, h_prev, pos=True, spec=x.spec)
    if not final_state:
        return out, None
    n = dist.group_size(sax)
    last = dist.map(lambda i, h: h if dist.mesh.rank(i, sax) == n - 1
                    else torch.zeros_like(h), h_out, pos=True, spec=hspec)
    return out, dist.psum(last, sax)


def _decode_out(cfg: ModelConfig, p: dict, u, spec: tuple, dist):
    """The decode's gated norm and w_out on a mesh: ``u`` bf16(y *
    silu(z)) (B, 1, d_inner) moved to whole rows (``_mixer_out_mesh``), the
    norm's gain and w_out gathered whole (w_out cast to bf16 on its shard
    first), so that each position makes the meshless product at its rows.
    The weights' own row blocks with a ``psum`` of the partial products
    (the reference's layout) round apart from that one GEMM, and the
    recurrent layers amplify it beyond phase 30a's limit on the card (in
    f32 or f64 partials, or column blocks: ``tools/row_partials.py``)."""
    whole = {k: dist.at_use(p[k], mode="prefill", name=k)
             for k in ("norm", "w_out")}
    return _mixer_out_mesh(cfg, whole, u, spec, dist)


def mamba_decode_step_mesh(cfg: ModelConfig, p: dict, x, state: dict, *,
                           dist) -> tuple:
    """``mamba_decode_step`` on ``dist``'s mesh, under either layout (one
    token): x (B, 1, D) ``Sharded`` (batch); ``p`` the layer's weights in
    their sharded layout; ``state`` one layer's ``Sharded`` values (``h``
    (batch, heads), ``conv_x`` (batch, None, inner), ``conv_B`` and
    ``conv_C`` (batch)).  Each position steps its block of heads
    (``head_tp``'s) on its own column blocks of w_z, w_x and w_dt and the
    matching blocks of the conv_x weights, A_log, D and dt_bias (w_B, w_C
    and their convolutions are replicated); the gated norm reads whole
    rows, and w_out is the one weight gathered (``_decode_out``).  Returns
    (out (B, 1, D) in x's layout, the new state in ``state``'s
    layouts)."""
    hax = _head_axes(cfg, dist)
    b = x.spec[0]
    # a leaf split otherwise than the heads (an inner dim that "model"
    # divides where the head count does not) is gathered whole
    p = {k: dist.gather_all(v, keep=next(
        (d for d, ax in enumerate(v.spec) if hax and ax == hax), None))
        for k, v in p.items()}
    lay = {"h": (b, hax, (), ()), "conv_x": (b, (), hax),
           "conv_B": (b, (), ()), "conv_C": (b, (), ())}
    st = {k: dist.reshard(state[k], lay[k]) for k in STATE_KEYS}

    def local(i, pi, xi, *s):
        u, new = _decode_heads(cfg, pi, xi, dict(zip(STATE_KEYS, s)),
                               *_head_block(cfg, dist, i, hax), own=True)
        return (u,) + tuple(new[k] for k in STATE_KEYS)

    u, *new = dist.map(local, p, x, *(st[k] for k in STATE_KEYS), pos=True,
                       spec=((b, (), hax),) + tuple(lay[k]
                                                    for k in STATE_KEYS))
    out = _decode_out(cfg, p, u, x.spec, dist)
    return out, {k: dist.reshard(v, state[k].spec)
                 for k, v in zip(STATE_KEYS, new)}


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
