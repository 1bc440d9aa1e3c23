"""The LM path's kernels against the reference package's and against their
plain versions.

CPU: the plain versions (``kernels/ref.py``) against the reference —
``flash_attention`` over the Pallas test's grid (``tests/test_kernels.py``
``test_flash_matches_ref``: its jnp oracle and its Pallas kernel in
interpret mode) and against the LM path's chunked attention
(``repro.models.layers.flash_attention``) with GQA, windows and a ragged
length; its lse against a jnp logsumexp; ``flash_attention_bwd`` against
autograd through the plain forward and ``jax.vjp`` of the reference's
chunked attention; ``sage_aggregate`` over the Pallas test's grid.

CPU, the flash kernel's design: ``flash_route`` (the rule the CUDA source
applies too) and a plain-PyTorch emulation of the ``wgmma`` route's
arithmetic (GQA heads packed into 128-row tiles, 64-key tiles, the exp2
domain, -1e30 masks) held to the plain version.

GPU (``gpu``-marked, skipped without a card): each CUDA kernel against its
plain version on the card, and the route each call took; the backward
kernel against the f64 exact gradient beside its plain version, twice
(bitwise), in bf16 and in f32 (the simt route), and autograd through the
wrapper in both types.  The reference package is imported inside the
CPU tests only, so the ``gpu`` tests run on a GPU host that has no JAX:
``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_lm_kernels.py``.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref as tref
from repro_torch.kernels import sage_agg

BIG_WINDOW = 1 << 30
# the CUDA flash kernel against its plain version (see
# test_cuda_flash_matches_plain_version)
CUDA_TOL = {torch.bfloat16: dict(rtol=1e-2, atol=2e-3),
            torch.float32: dict(rtol=1e-3, atol=2e-4)}


def _reference():
    """(jax.numpy, the reference's Pallas ops, its jnp oracles, its LM
    layers)."""
    import jax.numpy as jnp

    from repro.kernels import ops, ref
    from repro.models import layers

    return jnp, ops, ref, layers


def _to_jax(t: torch.Tensor):
    """The same bits on the JAX side (bf16 through its 16-bit pattern)."""
    jnp = _reference()[0]
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.view(torch.int16).numpy().view(jnp.bfloat16))
    return jnp.asarray(t.numpy())


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().cpu().numpy()
    return np.asarray(x, np.float32)


def _randn(rng, shape, dtype, scale=1.0, device="cpu"):
    x = rng.standard_normal(shape).astype(np.float32) * scale
    return torch.from_numpy(x).to(dtype).to(device)


def _qkv(seed, B, S, Hq, Hkv, Dh, dtype, device="cpu", Sk=None):
    rng = np.random.default_rng(seed)
    Sk = S if Sk is None else Sk
    return (_randn(rng, (B, S, Hq, Dh), dtype, device=device),
            _randn(rng, (B, Sk, Hkv, Dh), dtype, device=device),
            _randn(rng, (B, Sk, Hkv, Dh), dtype, device=device))


# ------------------------------------------------------------------ CPU ----

@pytest.mark.parametrize("BH,S,Dh", [(4, 256, 64), (2, 128, 128),
                                     (1, 384, 128)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_flash_matches_pallas_and_oracle(BH, S, Dh, causal, dtype):
    """The TPU kernel's contract (BH, S, Dh), the Pallas test's grid and
    inputs (q, k scaled by 0.5) and tolerances: 2e-3 in f32 (summation
    order), 2e-2 in bf16 (the plain version rounds q * scale and p to bf16
    as the LM path does; the Pallas kernel and the oracle keep them f32)."""
    jnp, jops, jref, _ = _reference()
    rng = np.random.default_rng(2)
    q = _randn(rng, (BH, S, Dh), dtype, 0.5)
    k = _randn(rng, (BH, S, Dh), dtype, 0.5)
    v = _randn(rng, (BH, S, Dh), dtype)
    got = fa.flash_attention_bhsd(q, k, v, causal=causal)
    assert got.shape == q.shape and got.dtype == dtype
    tol = 2e-3 if dtype == torch.float32 else 2e-2
    args = tuple(_to_jax(t) for t in (q, k, v))
    for want in (jops.flash_attention(*args, causal=causal),
                 jref.flash_attention(*args, causal=causal)):
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("Hkv,causal,Dh", [(1, True, 16), (2, False, 80),
                                            (4, True, 128)])
@pytest.mark.parametrize("window", [0, 8, BIG_WINDOW])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_flash_matches_lm_path_attention(Hkv, causal, Dh, window,
                                               dtype):
    """GQA (4 query heads over 1, 2 or 4 kv heads), no window / window 8 /
    the global layers' BIG_WINDOW, a ragged S = 37 over key blocks of 16
    (so the last block is padded), head dims 16, 80 (a scale that bf16
    rounds) and 128.  f32 within 1e-5 (einsum order); bf16 within one bf16
    step of |o| < 2 (1e-2): both round q * scale and p at the same points,
    only the f32 sums' order differs."""
    _, _, _, jlayers = _reference()
    q, k, v = _qkv(7 + Hkv, 2, 37, 4, Hkv, Dh, dtype)
    got = fa.flash_attention(q, k, v, causal=causal, window=window,
                             block_kv=16)
    want = jlayers.flash_attention(
        *(_to_jax(t) for t in (q, k, v)), causal=causal, window=window,
        block_kv=16)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype,Dh,route", [
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 256, "wgmma"), (torch.bfloat16, 80, "wgmma"),
    (torch.bfloat16, 16, "mma_sync"), (torch.bfloat16, 96, "mma_sync"),
    (torch.float32, 16, "simt"), (torch.float32, 64, "simt"),
    (torch.float32, 128, "simt"), (torch.float32, 256, "simt"),
])
def test_flash_route_depends_on_dtype_and_head_dim_only(dtype, Dh, route):
    """gemma3 (256), qwen2.5 and minitron (128), stablelm (80: a 64-column
    box and a 16-column one) and Dh 64 take the wgmma kernel in bf16; the
    smoke configs' 16 and other head dims the mma.sync kernel; f32 the SIMT
    kernel."""
    assert fa.flash_route(dtype, Dh) == route
    assert route in fa.ROUTES and set(fa.KERNEL.route_launches) == set(
        fa.ROUTES)


def _dh_dot(a, b):
    """a (m, Dh) b^T (n, Dh) in f32 as the wgmma tiles sum it: over the
    64-column boxes, then (Dh 80) plus the 16-column tail box's k-step."""
    main = a.shape[1] - a.shape[1] % 64
    s = a[:, :main] @ b[:, :main].T
    return s + a[:, main:] @ b[:, main:].T if main < a.shape[1] else s


def _dh_acc(acc, a, b):
    """acc (m, Dh) + a (m, n) b (n, Dh) as the wgmma tiles add it: the
    64-column boxes' accumulator and (Dh 80) the tail's, each its own."""
    main = b.shape[1] - b.shape[1] % 64
    parts = [acc[:, :main] + a @ b[:, :main]]
    if main < b.shape[1]:
        parts.append(acc[:, main:] + a @ b[:, main:])
    return torch.cat(parts, 1)


def _emulate_wgmma(q, k, v, *, causal, window, stats=None):
    """The wgmma route's arithmetic in plain PyTorch.  Per kv head, the G
    query heads of a position are neighbouring rows (row = position * G +
    head), 128 rows to a tile (128 // G positions); a tile visits the
    64-key tiles from the first any of its rows can see to the last.  Q is
    multiplied by the bf16 scale and rounded to bf16 when the scale is not
    a power of two, else the scale is folded into c = log2(e) * scale;
    scores q . k * c, masked to -1e30 in that exp2 domain; m the running
    max, alpha = 2^(m_old - m_new), p = 2^(s - m_new) rounded to bf16 for
    p . v while l sums the f32 p; out = o / max(l, 1e-30).  Dh 80 is a
    64-column box and a 16-column one: one more k-step of q . k, and o
    in two accumulators (``_dh_dot``, ``_dh_acc``).  ``stats`` counts the
    rows whose first visited tile is fully masked."""
    B, Sq, Hq, Dh = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    assert G <= 128
    P, T = 128 // G, 64
    scale = torch.tensor(Dh ** -0.5, dtype=q.dtype)
    folded = math.frexp(float(scale))[0] == 0.5
    c = torch.tensor(math.log2(math.e), dtype=torch.float32)
    if folded:
        c = c * float(scale)
    else:
        q = q * scale  # rounded to bf16, as the reference rounds it
    pad = (-Sk) % T + T
    kp = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad)).float()
    vp = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    out = torch.zeros((B, Sq, Hq, Dh), dtype=torch.float32)
    for b in range(B):
        for hk in range(Hkv):
            for p0 in range(0, Sq, P):
                p_last = min(p0 + P, Sq) - 1
                rows = q[b, p0:p_last + 1, hk * G:(hk + 1) * G]
                qt = rows.reshape(-1, Dh).float()
                pos = torch.arange(p0, p_last + 1).repeat_interleave(G)
                hi = min(Sk - 1, p_last) if causal else Sk - 1
                lo = max(0, p0 - window + 1) if window > 0 else 0
                m = torch.full((len(pos),), -1e30)
                l = torch.zeros(len(pos))
                o = torch.zeros((len(pos), Dh))
                seen = torch.zeros(len(pos), dtype=torch.bool)
                for t in range(lo // T, hi // T + 1 if hi >= lo else 0):
                    j = torch.arange(t * T, t * T + T)
                    s = _dh_dot(qt, kp[b, t * T:t * T + T, hk]) * c
                    vis = (j < Sk)[None, :].expand(len(pos), T)
                    if causal:
                        vis = vis & (j[None, :] <= pos[:, None])
                    if window > 0:
                        vis = vis & (pos[:, None] - j[None, :] < window)
                    if stats is not None:
                        stats["masked_first"] = stats.get("masked_first", 0) \
                            + int((~seen & ~vis.any(1)).sum()) * (t == lo // T)
                    seen |= vis.any(1)
                    s = torch.where(vis, s, torch.tensor(-1e30))
                    m_new = torch.maximum(m, s.amax(1))
                    alpha = torch.exp2(m - m_new)
                    pr = torch.exp2(s - m_new[:, None])
                    l = l * alpha + pr.sum(1)
                    o = _dh_acc(o * alpha[:, None], pr.to(v.dtype).float(),
                                vp[b, t * T:t * T + T, hk].float())
                    m = m_new
                o = o / l.clamp_min(1e-30)[:, None]
                out[b, p0:p_last + 1, hk * G:(hk + 1) * G] = o.reshape(
                    p_last + 1 - p0, G, Dh)
    return out.to(q.dtype)


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,Dh,window,causal", [
    (1, 100, 100, 4, 1, 64, 1, True),     # G = 4, window 1: out = v
    (1, 100, 100, 4, 1, 64, 8, True),     # window 8: a first tile all masked
    (2, 70, 70, 4, 1, 128, 8, True),      # Dh 128: q * scale rounded first
    (1, 77, 77, 6, 2, 64, 0, True),       # G = 3: 42 positions, 126 rows
    (1, 50, 90, 4, 1, 64, 0, False),      # Sq != Sk, not causal
    (1, 90, 50, 4, 4, 128, 48, True),     # G = 1, Sq > Sk (every row sees a
                                          # key: the contract leaves one
                                          # that sees none undefined)
    # Dh 80 (stablelm): a 64-column box and a 16-column tail, q * scale
    # rounded first
    (1, 77, 77, 4, 4, 80, 0, True),       # G = 1, ragged S
    (2, 130, 130, 4, 2, 80, 64, True),    # G = 2, window 64
    (1, 100, 100, 4, 1, 80, 8, True),     # G = 4, a first tile all masked
    (1, 50, 90, 8, 2, 80, 0, False),      # G = 4, Sq != Sk, not causal
    (1, 90, 70, 2, 1, 80, 64, True),      # G = 2, Sq > Sk, window 64
])
def test_wgmma_route_arithmetic_matches_the_plain_version(B, Sq, Sk, Hq, Hkv,
                                                          Dh, window, causal):
    """The emulation within the card's bf16 tolerance of the plain version
    (rtol 1e-2 + atol 2e-3): tiles of 64 keys against the plain version's
    one block, exp2 against exp, and p rounded to bf16 against another
    running max move the output by about one bf16 step."""
    q, k, v = _qkv(Sq + Hq, B, Sq, Hq, Hkv, Dh, torch.bfloat16, Sk=Sk)
    stats = {}
    got = _emulate_wgmma(q, k, v, causal=causal, window=window, stats=stats)
    want = tref.flash_attention(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(got.float(), want.float(),
                               **CUDA_TOL[torch.bfloat16])
    if window == 8 and Sq >= 96:  # row 95 of the tile at 64 sees keys
        # 88-95: its first visited tile (keys 0-63) is all masked
        assert stats["masked_first"] > 0


def test_cpu_tensors_count_no_route_launches():
    q, k, v = _qkv(0, 1, 8, 4, 1, 64, torch.bfloat16)
    before = dict(fa.KERNEL.route_launches)
    fa.flash_attention(q, k, v, window=4)
    assert fa.KERNEL.route_launches == before


@pytest.mark.parametrize("dtype,window,causal", [
    (torch.float32, 0, True), (torch.float32, 8, True),
    (torch.bfloat16, 0, False)])
def test_cpu_flash_attention_is_differentiable(dtype, window, causal):
    """On the CPU the wrapper is differentiable through its plain versions:
    the forward's output is ``ref.flash_attention``'s bit for bit, and its
    gradients are ``ref.flash_attention_bwd``'s of the saved output and
    lse, bit for bit, and within the backward's tolerance (BWD_TOL) of
    autograd through ``ref.flash_attention``."""
    q, k, v = _qkv(3, 2, 40, 4, 2, 32, dtype)
    w = torch.from_numpy(np.random.default_rng(4).standard_normal(
        tuple(q.shape)).astype(np.float32))
    grads, outs = [], []
    for f in (fa.flash_attention, tref.flash_attention):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = f(*leaves, causal=causal, window=window, block_kv=16)
        assert out.requires_grad and out.grad_fn is not None
        (out.float() * w).sum().backward()
        grads.append([t.grad for t in leaves])
        outs.append(out.detach())
    assert torch.equal(*outs)
    o, lse = tref.flash_attention(q, k, v, causal=causal, window=window,
                                  block_kv=16, return_lse=True)
    plain = tref.flash_attention_bwd(q, k, v, o, lse, w.to(dtype),
                                     causal=causal, window=window,
                                     block_kv=16)
    for a, b, c in zip(*grads, plain):
        assert a is not None and a.dtype == dtype and torch.equal(a, c)
        assert bool(torch.isfinite(a.float()).all()) and a.abs().sum() > 0
        assert _rel(a, b) <= BWD_TOL[dtype]


def _rel(a, b) -> float:
    """|a - b| / |b| in Frobenius norms, in f64."""
    a, b = (torch.as_tensor(np.asarray(_f32(x), np.float64)) for x in (a, b))
    return float((a - b).norm() / b.norm())


# the plain backward against autograd through the plain forward (and the
# reference's jax.grad of its lax.scan), per gradient, as |a - b| / |b|:
# f32 differs by summation order only (measured 1e-7 to 6.2e-7); bf16 by
# where each side rounds (autograd also rounds dp to bf16 at the backward
# of p's cast, and each side rounds each gradient once; measured 2.4e-3 to
# 4.2e-3), about one bf16 step (2**-8 = 3.9e-3)
BWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


@pytest.mark.parametrize("Hkv,Dh,window", [
    (4, 16, 8), (2, 80, 0), (1, 256, 64), (1, 16, 0), (2, 256, 8),
    (4, 80, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_flash_bwd_matches_autograd_and_the_reference(Hkv, Dh, window,
                                                            dtype):
    """``ref.flash_attention_bwd`` against autograd through
    ``ref.flash_attention`` and against ``jax.vjp`` of the reference's
    LM-path attention (``repro.models.layers.flash_attention``, a
    ``lax.scan`` over key blocks) on the same inputs: G = 1, 2, 4 query
    heads per kv head, Dh 16, 80 (a scale that bf16 rounds) and 256,
    causal with windows 0, 8 and 64, S = 77 over key blocks of 16 (the
    last one padded).  Within BWD_TOL."""
    jnp, _, _, jlayers = _reference()
    import jax

    S = 77
    q, k, v = _qkv(Dh + Hkv, 2, S, 4, Hkv, Dh, dtype)
    do = _randn(np.random.default_rng(5), tuple(q.shape), dtype)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = tref.flash_attention(*leaves, window=window, block_kv=16)
    out.backward(do)
    o, lse = tref.flash_attention(q, k, v, window=window, block_kv=16,
                                  return_lse=True)
    got = tref.flash_attention_bwd(q, k, v, o, lse, do, window=window,
                                   block_kv=16)
    _, vjp = jax.vjp(lambda a, b, c: jlayers.flash_attention(
        a, b, c, causal=True, window=window, block_kv=16),
        *(_to_jax(t) for t in (q, k, v)))
    want = vjp(_to_jax(do))
    for g, auto, ref_g in zip(got, leaves, want):
        assert g.shape == auto.shape and g.dtype == dtype
        assert _rel(g, auto.grad) <= BWD_TOL[dtype]
        assert _rel(g, ref_g) <= BWD_TOL[dtype]


@pytest.mark.parametrize("window,causal,Hkv", [(0, True, 1), (8, True, 2),
                                               (0, False, 4), (5, False, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_return_lse_is_the_logsumexp_of_the_masked_scores(window, causal,
                                                          Hkv, dtype):
    """lse (B, Hq, Sq) against a jnp logsumexp over each row's visible
    scores bf16(q * scale) . k (masked ones -inf), S = 37 over key blocks
    of 16; within 1e-5 (f32 sums in another order).  The output is the
    same bits with and without it; the (BH, S, Dh) contract gives (BH, S)."""
    jnp = _reference()[0]
    import jax

    q, k, v = _qkv(11, 2, 37, 4, Hkv, 32, dtype)
    o, lse = tref.flash_attention(q, k, v, causal=causal, window=window,
                                  block_kv=16, return_lse=True)
    assert torch.equal(o, tref.flash_attention(q, k, v, causal=causal,
                                               window=window, block_kv=16))
    assert lse.shape == (2, 4, 37) and lse.dtype == torch.float32
    assert lse.is_contiguous()
    scale = jnp.asarray(32 ** -0.5, _to_jax(q).dtype)
    qs = (_to_jax(q) * scale).astype(jnp.float32)
    kk = jnp.repeat(_to_jax(k).astype(jnp.float32), 4 // Hkv, axis=2)
    s = jnp.einsum("bqhd,bkhd->bhqk", qs, kk)
    i = jnp.arange(37)[:, None]
    j = jnp.arange(37)[None, :]
    seen = jnp.ones((37, 37), bool)
    if causal:
        seen &= j <= i
    if window:
        seen &= i - j < window
    want = jax.nn.logsumexp(jnp.where(seen, s, -jnp.inf), axis=-1)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    o3, lse3 = tref.flash_attention(q[:, :, 0], k[:, :, 0], v[:, :, 0],
                                    causal=causal, window=window,
                                    return_lse=True)
    assert o3.shape == q[:, :, 0].shape and lse3.shape == (2, 37)


@pytest.mark.parametrize("dtype,Dh,route", [
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 256, "wgmma"), (torch.bfloat16, 16, "mma_sync"),
    (torch.bfloat16, 80, "wgmma"), (torch.bfloat16, 96, "mma_sync"),
    *((torch.float32, dh, "simt") for dh in range(16, 257, 16)),
])
def test_flash_bwd_route_depends_on_dtype_and_head_dim_only(dtype, Dh, route):
    """gemma3 (256), qwen2.5 and minitron (128), stablelm (80) and Dh 64
    take the wgmma backward in bf16; the smoke configs' 16 and other head
    dims the mma.sync one; f32 the simt one at every head dim."""
    assert fa.flash_bwd_route(dtype, Dh) == route
    assert set(fa.BWD_KERNEL.route_launches) == set(fa.BWD_ROUTES)
    assert route in fa.BWD_ROUTES


# the backward's scratch by route, (B, Sq, Hq, Hkv, Dh), scale: what the
# CUDA source's rule (flash_attention_bwd_scratch_bytes) and its copy
# (scratch_rule, the meta device's answer) give
BWD_SCRATCH = [
    # D for every (b, h, i)
    ("mma_sync", (2, 77, 4, 1, 80), 80 ** -0.5, 4 * 2 * 4 * 77),
    # G = 4: 16 positions a tile, 5 tiles of 64 rows; the scale is folded
    ("wgmma", (2, 77, 4, 1, 256), 0.0625, 8 * 2 * 5 * 64),
    # G = 3: 21 positions (63 rows) a tile, 4 tiles per kv head; Dh 128's
    # scale is not a power of two, so bf16(q * scale) is kept too
    ("wgmma", (1, 77, 6, 2, 128), 0.08837890625,
     8 * 2 * 4 * 64 + 2 * 77 * 6 * 128),
    # G = 80: two head blocks of 64 heads, one position a tile
    ("wgmma", (1, 3, 80, 1, 64), 0.125, 8 * 2 * 3 * 64),
    # Dh 80, G = 2: 32 positions a tile, 3 tiles per kv head; the scale is
    # not a power of two, so bf16(q * scale) is kept
    ("wgmma", (2, 77, 4, 2, 80), 0.11181640625,
     8 * 2 * 2 * 3 * 64 + 2 * 2 * 77 * 4 * 80),
    # f32: D for every (b, h, i), whatever the scale and head dim
    ("simt", (2, 77, 4, 1, 80), 80 ** -0.5, 4 * 2 * 4 * 77),
    ("simt", (3, 1000, 6, 2, 256), 0.0625, 4 * 3 * 6 * 1000),
]


@pytest.mark.parametrize("route,shape,scale,want", BWD_SCRATCH)
def test_scratch_rule_matches_the_table(route, shape, scale, want):
    """``scratch_rule`` (the meta device's copy of the CUDA source's rule)
    on the table the ``gpu`` test holds the library to."""
    B, Sq, Hq, Hkv, Dh = shape
    assert fa.scratch_rule(route, B, Sq, Hq, Hkv, Dh, scale) == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("needs_grad", ["q", "k", "v"])
def test_meta_autograd_gives_the_cards_shapes_and_cost(dtype, needs_grad):
    """On ``meta`` tensors a call under autograd in either type runs both
    directions as the card would, with empty outputs: the gradient of the
    input that requires one has its shape and type, and a cost counter
    records one forward (with its lse) and one backward of
    ``flash_cost``'s work, the f32 backward counted as the bf16 one is
    (its bytes at 4 a value)."""
    from repro_torch.launch import op_cost

    B, Sq, Hq, Hkv, Dh, window = 2, 96, 6, 2, 80, 40
    qkv = {n: torch.empty(s, dtype=dtype, device="meta") for n, s in (
        ("q", (B, Sq, Hq, Dh)), ("k", (B, Sq, Hkv, Dh)),
        ("v", (B, Sq, Hkv, Dh)))}
    qkv[needs_grad].requires_grad_()
    with op_cost.OpCounter("meta") as c:
        out = fa.flash_attention(**qkv, window=window)
        assert out.shape == (B, Sq, Hq, Dh) and out.dtype == dtype
        out.float().sum().backward()
    g = qkv[needs_grad].grad
    assert g is not None and g.device.type == "meta"
    assert g.shape == qkv[needs_grad].shape and g.dtype == dtype
    pairs = fa.causal_pairs(Sq, window)
    es = torch.empty((), dtype=dtype).element_size()
    k = c.kernels["flash_attention_bwd"]
    assert k["calls"] == 1 and k["flops"] == 10 * Dh * B * Hq * pairs
    assert k["bytes"] == 4 * (B * Sq * Hq * Dh + B * Sq * Hkv * Dh) * es \
        + 4 * B * Hq * Sq
    f = c.kernels["flash_attention"]
    assert f["calls"] == 1 and f["flops"] == 4 * Dh * B * Hq * pairs


@pytest.mark.gpu
@pytest.mark.parametrize("route,shape,scale,want", BWD_SCRATCH)
def test_bwd_scratch_bytes(cuda_device, route, shape, scale, want):
    """The CUDA source's scratch rule (``flash_attention_bwd_scratch_bytes``,
    which ``bwd_scratch_bytes`` asks and the launch checks) on a table."""
    B, Sq, Hq, Hkv, Dh = shape
    assert fa.bwd_scratch_bytes(route, B, Sq, Hq, Hkv, Dh, scale) == want


def _emulate_wgmma_bwd(q, k, v, o, lse, do, *, causal, window, stats=None):
    """The wgmma backward route's tile arithmetic in plain PyTorch.  Query
    rows are GQA-packed (row = position * G + head within a head block of
    min(G, 64) heads), 64 rows a tile (64 // G positions, the rest of the
    tile empty), keys 64 a tile.  q is multiplied by the bf16 scale and
    rounded to bf16 when the scale is not a power of two; else the scale is
    folded into c = log2(e) * scale and into dk's and dq's epilogues.  From
    lse2 = lse * log2(e) (f32) and D = rowsum(do * o): p = 2^(s c - lse2),
    0 where the key is not visible and on rows that are no real row (lse2 =
    +inf, D = 0); p rounded to bf16 for dv += p^T do; ds = p (dp - D)
    as two bf16 parts, hi = bf16(ds) and lo = bf16(ds - hi), for dk +=
    hi^T q, then lo^T q, and dq += hi k, then lo k.  dk and dv: one
    (key tile) walk over every head block's query tiles that can see it,
    in order; dq: query tiles in pairs (2 u, 2 u + 1) as a dq CTA owns
    them, each tile summing, in one sum in key-tile order, every key tile
    that some row of the pair can see.  ``stats`` counts the dq rows whose
    first visited key tile is all masked.  Dh 80 is a 64-column box and a
    16-column one: products over Dh take one more k-step (``_dh_dot``),
    products into dq, dk, dv a tail accumulator of their own
    (``_dh_acc``)."""
    B, Sq, Hq, Dh = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    Gt = min(G, 64)
    HB, P, T = -(-G // Gt), 64 // Gt, 64
    scale = torch.tensor(Dh ** -0.5, dtype=q.dtype)
    folded = math.frexp(float(scale))[0] == 0.5
    log2e = torch.tensor(math.log2(math.e), dtype=torch.float32)
    c = log2e * float(scale) if folded else log2e
    dk_mul, dq_mul = (float(scale) if folded else 1.0), float(scale)
    qt = (q if folded else q * scale).float()
    lse2 = lse.float() * log2e                                  # (B, Hq, Sq)
    delta = (do.float() * o.float()).sum(-1).permute(0, 2, 1)   # (B, Hq, Sq)
    pad = (-Sk) % T
    kp, vp = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad)).float()
              for t in (k, v))
    dof = do.float()

    def rows(b, hk, hb, t):
        """A query tile's 64 packed rows: Q, dO, lse2, D, positions."""
        r = torch.arange(64)
        pos, gh = t * P + r // Gt, hb * Gt + r % Gt
        ok = (r < P * Gt) & (pos < Sq) & (gh < G)
        pos_c, h = pos.clamp_max(Sq - 1), hk * G + gh.clamp_max(G - 1)
        Q = torch.where(ok[:, None], qt[b, pos_c, h], 0.0)
        dO = torch.where(ok[:, None], dof[b, pos_c, h], 0.0)
        l2 = torch.where(ok, lse2[b, h, pos_c], torch.inf)
        D = torch.where(ok, delta[b, h, pos_c], 0.0)
        return Q, dO, l2, D, pos, ok

    def visible(pos, j):
        vis = (j < Sk)[None, :].expand(len(pos), len(j))
        if causal:
            vis = vis & (j[None, :] <= pos[:, None])
        if window > 0:
            vis = vis & (pos[:, None] - j[None, :] < window)
        return vis

    def bf(x):
        return x.to(torch.bfloat16).float()

    dq = torch.zeros((B, Sq, Hq, Dh))
    dk = torch.zeros((B, Sk + pad, Hkv, Dh))
    dv = torch.zeros((B, Sk + pad, Hkv, Dh))
    for b in range(B):
        for hk in range(Hkv):
            for j0 in range(0, Sk, T):
                K, V = kp[b, j0:j0 + T, hk], vp[b, j0:j0 + T, hk]
                j = torch.arange(j0, j0 + T)
                lo = j0 if causal else 0
                hi = Sq - 1
                if window > 0:
                    hi = min(hi, min(j0 + T, Sk) - 1 + window - 1)
                acc_k, acc_v = torch.zeros((T, Dh)), torch.zeros((T, Dh))
                for hb in range(HB):
                    for t in range(lo // P, hi // P + 1 if hi >= lo else 0):
                        Q, dO, l2, D, pos, _ = rows(b, hk, hb, t)
                        p = torch.exp2(_dh_dot(K, Q) * c - l2[None, :])
                        p = torch.where(visible(pos, j).T, p, 0.0)
                        acc_v = _dh_acc(acc_v, bf(p), dO)
                        ds = p * (_dh_dot(V, dO) - D[None, :])
                        acc_k = _dh_acc(_dh_acc(acc_k, bf(ds), Q),
                                        bf(ds - bf(ds)), Q)
                dk[b, j0:j0 + T, hk] = acc_k * dk_mul
                dv[b, j0:j0 + T, hk] = acc_v
            for hb in range(HB):
                for t in range(-(-Sq // P)):
                    Q, dO, l2, D, pos, ok = rows(b, hk, hb, t)
                    p0 = (t - t % 2) * P  # the pair's first position
                    p_last = min(p0 + 2 * P, Sq) - 1
                    hi = min(Sk - 1, p_last) if causal else Sk - 1
                    lo = max(0, p0 - window + 1) if window > 0 else 0
                    acc = torch.zeros((64, Dh))
                    tiles = range(lo // T, hi // T + 1 if hi >= lo else 0)
                    for i, kt in enumerate(tiles):
                        K = kp[b, kt * T:kt * T + T, hk]
                        V = vp[b, kt * T:kt * T + T, hk]
                        vis = visible(pos, torch.arange(kt * T, kt * T + T))
                        if stats is not None and i == 0:
                            stats["masked_first"] = stats.get(
                                "masked_first", 0) + int((ok & ~vis.any(1))
                                                         .sum())
                        p = torch.where(vis, torch.exp2(
                            _dh_dot(Q, K) * c - l2[:, None]), 0.0)
                        ds = p * (_dh_dot(dO, V) - D[:, None])
                        acc = _dh_acc(_dh_acc(acc, bf(ds), K),
                                      bf(ds - bf(ds)), K)
                    out = acc * dq_mul
                    for r in torch.nonzero(ok).flatten().tolist():
                        dq[b, t * P + r // Gt, hk * G + hb * Gt + r % Gt] = \
                            out[r]
    return (dq.to(q.dtype), dk[:, :Sk].to(k.dtype), dv[:, :Sk].to(v.dtype))


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,Dh,window,causal", [
    (1, 150, 150, 6, 2, 64, 0, True),      # G = 3: 21 positions, 63 rows
    (1, 130, 130, 2, 2, 128, 64, True),    # G = 1, Dh 128 (q * scale kept)
    (1, 200, 200, 4, 1, 256, 64, True),    # window 64: a row's first key
                                           # tile all masked
    (1, 100, 200, 4, 1, 256, 0, True),     # Sq < Sk
    (1, 200, 90, 8, 2, 128, 0, False),     # Sq > Sk, not causal
    (2, 77, 77, 4, 1, 64, 0, False),       # not causal, ragged
    (1, 90, 90, 12, 4, 256, 40, False),    # G = 3, window, not causal
    # Dh 80 (stablelm): a 64-column box and a 16-column tail
    (1, 150, 150, 4, 4, 80, 0, True),      # G = 1, ragged S
    (1, 130, 130, 4, 2, 80, 64, True),     # G = 2, window 64
    (1, 200, 200, 4, 1, 80, 64, True),     # G = 4, window 64: a first key
                                           # tile all masked
    (1, 100, 77, 8, 2, 80, 0, False),      # G = 4, Sq != Sk, not causal
])
def test_wgmma_bwd_arithmetic_matches_the_exact_gradient(B, Sq, Sk, Hq, Hkv,
                                                         Dh, window, causal):
    """The emulation against the f64 exact gradient by the card's rule:
    per gradient, max error over max |g| within twice the plain version's
    plus 1e-3 (both round q * scale, p and the outputs to bf16; the route
    also takes ds as two bf16 parts, takes exp2 of lse * log2(e) and sums
    its tiles in another order)."""
    q, k, v = _qkv(Sq + Dh + Hq, B, Sq, Hq, Hkv, Dh, torch.bfloat16, Sk=Sk)
    do = _randn(np.random.default_rng(Sk), tuple(q.shape), torch.bfloat16)
    o, lse = tref.flash_attention(q, k, v, causal=causal, window=window,
                                  return_lse=True)
    stats = {}
    got = _emulate_wgmma_bwd(q, k, v, o, lse, do, causal=causal,
                             window=window, stats=stats)
    plain = tref.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                     window=window)
    exact = _exact_grads(q, k, v, do, causal, window)
    for g, p, e in zip(got, plain, exact):
        assert g.dtype == torch.bfloat16 and g.shape == p.shape
        assert bool(torch.isfinite(g.float()).all())
        assert _max_err(g, e) <= 2 * _max_err(p, e) + 1e-3
    if window == 64 and causal:  # the tile at position 112 visits keys
        # 49-127 from key tile 0: row 127 sees 64-127 only
        assert stats["masked_first"] > 0


def _emulate_simt_bwd(q, k, v, o, lse, do, *, causal, window, shift):
    """The simt (f32) backward route's tile order in plain PyTorch: D =
    rowsum(do * o); dk and dv per 32-key tile, summed over the G query
    heads of its kv head in order and, for each, over the 32-query tiles
    that can see the tile (from the kernel's range: the first query tile
    whose last row reaches the tile's first key under the causal rule, to
    the last whose first row still sees its last key inside the window),
    in order; dq per 32-query tile of one head, summed over the key tiles
    its rows can see, in order, times the scale once at the end.  p =
    exp(s - lse) with s = (q * scale) . k, 0 where the key is not visible
    (query i at key position i + ``shift``) or past Sq; ds = p (dp - D).
    Nothing is rounded but each f32 operation."""
    B, Sq, Hq, Dh = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G, T = Hq // Hkv, 32
    scale = float(torch.tensor(Dh ** -0.5, dtype=torch.float32))
    qs = q * torch.tensor(scale)
    delta = (do * o).sum(-1).permute(0, 2, 1)  # (B, Hq, Sq)

    def seen(i0, j0):
        i = shift + torch.arange(i0, i0 + T)[:, None]
        j = torch.arange(j0, j0 + T)[None, :]
        vis = (j < Sk) & (i - shift < Sq)
        if causal:
            vis = vis & (j <= i)
        if window > 0:
            vis = vis & (i - j < window)
        return vis

    def tile(x, b, r0, h, S):
        out = torch.zeros((T, Dh))
        n = max(0, min(T, S - r0))
        out[:n] = x[b, r0:r0 + n, h]
        return out

    def stats(x, b, h, i0):
        out = torch.zeros(T)
        n = max(0, min(T, Sq - i0))
        out[:n] = x[b, h, i0:i0 + n]
        return out

    def ds_p(Q, dO, K, V, L, D, i0, j0):
        p = torch.where(seen(i0, j0), torch.exp(Q @ K.T - L[:, None]), 0.0)
        return p, p * (dO @ V.T - D[:, None])

    dq, dk, dv = (torch.zeros_like(t) for t in (q, k, v))
    for b in range(B):
        for hk in range(Hkv):
            for j0 in range(0, Sk, T):
                K, V = tile(k, b, j0, hk, Sk), tile(v, b, j0, hk, Sk)
                j_last = min(j0 + T, Sk) - 1
                lo = max(0, j0 - shift) if causal else 0
                hi = Sq - 1
                if window > 0:
                    hi = min(hi, j_last + window - 1 - shift)
                acc_k, acc_v = torch.zeros((T, Dh)), torch.zeros((T, Dh))
                for gh in range(G):
                    h = hk * G + gh
                    for t in range(lo // T, hi // T + 1 if hi >= lo else 0):
                        i0 = t * T
                        Q, dO = tile(qs, b, i0, h, Sq), tile(do, b, i0, h, Sq)
                        p, ds = ds_p(Q, dO, K, V, stats(lse, b, h, i0),
                                     stats(delta, b, h, i0), i0, j0)
                        acc_v = acc_v + p.T @ dO
                        acc_k = acc_k + ds.T @ Q
                n = j_last + 1 - j0
                dk[b, j0:j0 + n, hk], dv[b, j0:j0 + n, hk] = (acc_k[:n],
                                                              acc_v[:n])
        for h in range(Hq):
            hk = h // G
            for i0 in range(0, Sq, T):
                Q, dO = tile(qs, b, i0, h, Sq), tile(do, b, i0, h, Sq)
                L, D = stats(lse, b, h, i0), stats(delta, b, h, i0)
                hi = min(Sk - 1, i0 + T - 1 + shift) if causal else Sk - 1
                lo = max(0, i0 + shift - window + 1) if window > 0 else 0
                acc = torch.zeros((T, Dh))
                for t in range(lo // T, hi // T + 1 if hi >= lo else 0):
                    K, V = tile(k, b, t * T, hk, Sk), tile(v, b, t * T, hk, Sk)
                    acc = acc + ds_p(Q, dO, K, V, L, D, i0, t * T)[1] @ K
                n = min(T, Sq - i0)
                dq[b, i0:i0 + n, h] = (acc * scale)[:n]
    return dq, dk, dv


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,Dh,window,causal,off", [
    (1, 45, 90, 6, 2, 16, 0, True, 37),     # G 3, an offset inside a tile
    (1, 45, 90, 6, 2, 80, 20, True, 37),    # Dh 80, a window, the offset
    (2, 40, 70, 3, 1, 16, 0, False, 0),     # not causal, Sq != Sk
    (1, 70, 70, 6, 2, 80, 24, False, 5),    # not causal, a window, G 3
])
def test_simt_route_arithmetic_matches_the_plain_version_and_the_reference(
        B, Sq, Sk, Hq, Hkv, Dh, window, causal, off):
    """The simt backward's tile order (``_emulate_simt_bwd``) in f32
    against ``ref.flash_attention_bwd`` and ``jax.vjp`` of the reference's
    LM-path attention (``repro.models.layers.flash_attention``, the
    ``lax.scan`` the kernel stands for) on the same inputs at the query
    offset: per gradient within 1e-5 relative (Frobenius), the f32 sums
    taken in other orders; the route's tile ranges therefore visit every
    visible (query, key) pair."""
    jnp, _, _, jlayers = _reference()
    import jax

    q, k, v = _qkv(Sq + Dh + off, B, Sq, Hq, Hkv, Dh, torch.float32, Sk=Sk)
    do = _randn(np.random.default_rng(Sk + off), tuple(q.shape),
                torch.float32)
    kw = dict(causal=causal, window=window, q_offset=off)
    o, lse = tref.flash_attention(q, k, v, return_lse=True, **kw)
    got = _emulate_simt_bwd(q, k, v, o, lse, do, causal=causal,
                            window=window, shift=off)
    plain = tref.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    _, vjp = jax.vjp(lambda a, b, c: jlayers.flash_attention(
        a, b, c, causal=causal, window=window, q_offset=off),
        *(_to_jax(t) for t in (q, k, v)))
    want = vjp(_to_jax(do))
    for g, p, w in zip(got, plain, want):
        assert g.shape == p.shape and g.dtype == torch.float32
        assert _rel(g, p) <= BWD_TOL[torch.float32]
        assert _rel(g, w) <= BWD_TOL[torch.float32]


def test_flash_bwd_wrapper_checks_its_arguments():
    q, k, v = _qkv(0, 1, 8, 4, 1, 16, torch.float32)
    o, lse = tref.flash_attention(q, k, v, return_lse=True)
    got = fa.flash_attention_bwd(q, k, v, o, lse, o)
    want = tref.flash_attention_bwd(q, k, v, o, lse, o)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    before = (fa.BWD_KERNEL.launches, dict(fa.BWD_KERNEL.route_launches))
    with pytest.raises(ValueError):
        fa.flash_attention_bwd(q, k, v, o, lse[:, :2], o)
    with pytest.raises(ValueError):
        fa.flash_attention_bwd(q, k, v, o, lse.double(), o)
    with pytest.raises(ValueError):
        fa.flash_attention_bwd(q, k, v, o.bfloat16(), lse, o)
    with pytest.raises(ValueError):
        fa.flash_attention_bwd(q, k, v, o, lse, o[:, :4])
    assert (fa.BWD_KERNEL.launches,
            dict(fa.BWD_KERNEL.route_launches)) == before
    assert fa.BWD_ROUTES == ("wgmma", "mma_sync", "simt")


@pytest.mark.parametrize("N,D,B,F", [(64, 128, 8, 5), (128, 256, 16, 10),
                                     (32, 128, 4, 25), (64, 128, 4, 40)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_sage_matches_pallas_and_oracle(N, D, B, F, dtype):
    """The Pallas test's grid.  f32 within 1e-5 (the reference may contract
    multiply and add into one FMA, the oracle sums with an einsum); bf16
    within one bf16 step (1e-2 relative) of the same f32 sums."""
    jnp, jops, jref, _ = _reference()
    rng = np.random.default_rng(1)
    table = _randn(rng, (N, D), dtype)
    idx = rng.integers(-1, N, size=(B, F)).astype(np.int32)
    w = rng.random((B, F)).astype(np.float32)
    got = sage_agg.sage_aggregate(table, torch.from_numpy(idx),
                                  torch.from_numpy(w))
    assert got.shape == (B, D) and got.dtype == dtype
    args = (_to_jax(table), jnp.asarray(idx), jnp.asarray(w))
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    for want in (jops.sage_aggregate(*args), jref.sage_aggregate(*args)):
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


def test_plain_sage_edge_cases():
    """A row of pads only is zero, F = 1 is a weighted gather, an index
    past the end reads the last row."""
    table = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    idx = torch.tensor([[-1, -1], [2, -1], [9, 0]], dtype=torch.int32)
    w = torch.tensor([[1.0, 2.0], [0.5, 3.0], [1.0, 2.0]])
    out = sage_agg.sage_aggregate(table, idx, w)
    assert torch.equal(out[0], torch.zeros(3))
    assert torch.equal(out[1], 0.5 * table[2])
    assert torch.equal(out[2], table[3] + 2.0 * table[0])
    one = sage_agg.sage_aggregate(table, idx[:, :1], w[:, :1])
    assert torch.equal(one[1], 0.5 * table[2])


def test_plain_sage_gives_nan_where_a_pad_meets_a_non_finite_row_0():
    """A pad is weighted 0 but still multiplies row 0, so with row 0 = +inf
    every row with a pad is NaN, as in the reference's oracle (its einsum
    multiplies the gathered row 0 by the zero weight too); other rows are
    finite, or +inf where they gather row 0 with a positive weight."""
    _, _, jref, _ = _reference()
    rng = np.random.default_rng(7)
    table = _randn(rng, (16, 32), torch.float32)
    table[0] = float("inf")
    idx = rng.integers(1, 16, size=(6, 5)).astype(np.int32)
    idx[1, 2] = idx[4, 0] = idx[4, 3] = -1  # pads
    idx[2, 1] = 0                           # row 0, weighted
    w = (rng.random((6, 5)) + 0.5).astype(np.float32)
    got = sage_agg.sage_aggregate(table, torch.from_numpy(idx),
                                  torch.from_numpy(w))
    want = _f32(jref.sage_aggregate(_to_jax(table), idx, w))
    assert np.array_equal(np.isnan(_f32(got)), np.isnan(want))
    assert np.isnan(want[[1, 4]]).all() and not np.isnan(want[[0, 2, 3, 5]]
                                                         ).any()
    assert np.isposinf(want[2]).all()
    np.testing.assert_allclose(_f32(got), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("D", [1, 100, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sage_route_depends_on_row_bytes_and_alignment(dtype, D, aligned):
    """``vec`` needs rows of a multiple of 16 bytes (f32: D = 100, 128,
    256; bf16: D = 128, 256) on a 16-byte aligned table; anything else,
    a table at storage offset 1 included, takes ``scalar``."""
    vec_widths = {torch.float32: (100, 128, 256), torch.bfloat16: (128, 256)}
    table = torch.zeros(8 * D + 1, dtype=dtype)
    table = (table[:8 * D] if aligned else table[1:]).view(8, D)
    ptr = 4096 + table.storage_offset() * table.element_size()
    want = "vec" if aligned and D in vec_widths[dtype] else "scalar"
    assert sage_agg.sage_route(D, dtype, ptr) == want


def test_cpu_tensors_take_the_plain_path_without_counting_launches():
    q, k, v = _qkv(0, 1, 8, 2, 1, 16, torch.float32)
    before = (fa.KERNEL.launches, sage_agg.KERNEL.launches)
    fa.flash_attention(q, k, v)
    sage_agg.sage_aggregate(q[0, :, 0], torch.zeros((2, 3), dtype=torch.int32),
                            torch.ones((2, 3)))
    assert (fa.KERNEL.launches, sage_agg.KERNEL.launches) == before


@pytest.mark.parametrize("bad,err", [
    (dict(Dh=24), ValueError),      # not a multiple of 16
    (dict(Dh=272), ValueError),     # past 256
    (dict(Hkv=3), ValueError),      # 4 query heads over 3 kv heads
    (dict(dtype=torch.float16), TypeError),
])
def test_flash_wrapper_rejects_what_the_kernel_does_not_take(bad, err):
    kw = dict(Dh=16, Hkv=1, dtype=torch.float32) | bad
    q, k, v = _qkv(0, 1, 8, 4, kw["Hkv"], kw["Dh"], kw["dtype"])
    with pytest.raises(err):
        fa.flash_attention(q, k, v)


def test_wrappers_reject_mixed_types_and_shapes():
    q, k, v = _qkv(0, 1, 8, 2, 1, 16, torch.float32)
    with pytest.raises(TypeError):
        fa.flash_attention(q, k.to(torch.bfloat16), v)
    with pytest.raises(ValueError):
        fa.flash_attention(q, k[:, :, :, :8].contiguous(), v)
    with pytest.raises(ValueError):
        fa.flash_attention_bhsd(q, k, v)
    table = torch.zeros((4, 3))
    with pytest.raises(TypeError):
        sage_agg.sage_aggregate(table, torch.zeros((2, 2), dtype=torch.int64),
                                torch.ones((2, 2)))
    with pytest.raises(ValueError):
        sage_agg.sage_aggregate(table, torch.zeros((2, 2), dtype=torch.int32),
                                torch.ones((2, 3)))


# ------------------------------------------------------------------ GPU ----

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU host)")
    return torch.device("cuda")


# the simt (f32) backward against the f64 gradient: per gradient, max
# |kernel - f64| / max |f64| within twice the plain version's plus this
# floor (both keep every value in f32; they sum in other orders, and the
# kernel reads the forward kernel's lse, the plain version the plain
# forward's)
F32_BWD_FLOOR = 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("B,Sq,Hq,Hkv,Dh,Sk,window,causal,off", [
    (1, 77, 4, 1, 16, 77, 64, False, 0),     # Dh 16, G 4, not causal, ragged
    (1, 200, 8, 2, 64, 200, 0, True, 0),     # Dh 64, G 4
    (2, 130, 6, 2, 80, 260, 0, True, 37),    # Dh 80, G 3, an offset in a tile
    (1, 300, 2, 2, 128, 300, 64, True, 0),   # Dh 128, G 1, window 64
    (1, 333, 4, 1, 256, 333, 64, True, 0),   # Dh 256, G 4, window 64
    (1, 100, 4, 1, 256, 300, 0, True, 0),    # Sq < Sk
    (1, 130, 3, 1, 128, 70, 0, False, 0),    # G 3, Sq > Sk, not causal
    (1, 90, 6, 2, 16, 200, 64, True, 101),   # G 3, window 64 at offset 101
])
def test_cuda_f32_backward_matches_plain_and_exact_gradient(
        cuda_device, B, Sq, Hq, Hkv, Dh, Sk, window, causal, off):
    """The simt backward kernel in f32 against the f64 exact gradient: per
    gradient its max error over max |g| within twice the plain version's
    plus F32_BWD_FLOOR.  o and lse come from the forward kernel (simt), as
    in training, within the forward's f32 tolerance of the plain forward's;
    the plain backward reads the plain forward's.  Two calls give the same
    bits; one call counts one launch, under ``simt``."""
    q, k, v = _qkv(Sq + Dh + off, B, Sq, Hq, Hkv, Dh, torch.float32,
                   device=cuda_device, Sk=Sk)
    do = _randn(np.random.default_rng(Sq + off), tuple(q.shape),
                torch.float32, device=cuda_device)
    kw = dict(causal=causal, window=window, q_offset=off)
    o, lse = fa._forward_cuda(q, k, v, causal, window, True, off)
    assert fa.flash_bwd_route(torch.float32, Dh) == "simt"
    before = dict(fa.BWD_KERNEL.route_launches)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    again = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    assert fa.BWD_KERNEL.route_launches == {
        r: n + 2 * (r == "simt") for r, n in before.items()}
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    ro, rlse = tref.flash_attention(q, k, v, return_lse=True, **kw)
    torch.testing.assert_close(o, ro, **CUDA_TOL[torch.float32])
    torch.testing.assert_close(lse, rlse, rtol=1e-4, atol=1e-4)
    plain = tref.flash_attention_bwd(q, k, v, ro, rlse, do, **kw)
    exact = _exact_offset_grads(q, k, v, do, causal, window, off)
    for g, p, e in zip(got, plain, exact):
        assert g.dtype == torch.float32 and g.shape == p.shape
        assert _max_err(g, e) <= 2 * _max_err(p, e) + F32_BWD_FLOOR


def _exact_offset_grads(q, k, v, do, causal, window, off):
    """The f64 gradient of attention over q * the scale rounded to q's type
    (the product not rounded), k and v, query i at key position i + off."""
    Dh, G = q.shape[-1], q.shape[2] // k.shape[2]
    scale = float(torch.tensor(Dh ** -0.5, dtype=q.dtype))
    qd, kd, vd = (t.double().requires_grad_() for t in (q, k, v))
    i = off + torch.arange(q.shape[1], device=q.device)[:, None]
    j = torch.arange(k.shape[1], device=q.device)[None, :]
    seen = torch.ones((q.shape[1], k.shape[1]), dtype=torch.bool,
                      device=q.device)
    if causal:
        seen &= j <= i
    if window > 0:
        seen &= i - j < window
    s = torch.einsum("bqhd,bkhd->bhqk", qd * scale,
                     kd.repeat_interleave(G, 2))
    o = torch.einsum("bhqk,bkhd->bqhd",
                     s.masked_fill(~seen, float("-inf")).softmax(-1),
                     vd.repeat_interleave(G, 2))
    return torch.autograd.grad(o, (qd, kd, vd), do.double())


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,Hq,Hkv,Dh,window,causal,Sk", [
    (2, 256, 4, 1, 256, 512, True, None),          # gemma3: a local layer
    (2, 300, 4, 1, 256, BIG_WINDOW, True, None),   # gemma3: a global layer
    (1, 1000, 4, 1, 256, 1, True, None),           # ragged, window 1
    (1, 1000, 4, 4, 128, 0, True, None),           # ragged, G = 1
    (2, 130, 8, 2, 80, 64, True, None),            # stablelm's Dh
    (1, 77, 4, 1, 16, 8, False, None),             # the smoke configs' Dh
    (1, 200, 4, 1, 64, 0, False, None),
    # the wgmma route's edges: G = 1, 3, 4, 5, 8 at Dh 128 and 256 (3 and 5
    # leave 2 and 3 of a tile's 128 rows empty), Dh 64, ragged S (77, 1000)
    # against 32-position tiles and 64-key tiles, windows 1, 64, 512 and
    # >= S, not causal, Sq != Sk
    (1, 1000, 3, 3, 256, 0, True, None),           # G = 1, Dh 256
    (1, 1000, 6, 2, 128, 512, True, None),         # G = 3
    (1, 1000, 12, 4, 256, 64, True, None),         # G = 3
    (2, 77, 8, 2, 128, 0, True, None),             # G = 4, S 77
    (1, 1000, 10, 2, 128, 64, True, None),         # G = 5
    (1, 333, 5, 1, 256, BIG_WINDOW, True, None),   # G = 5
    (1, 1000, 8, 1, 128, 1, True, None),           # G = 8
    (2, 500, 8, 1, 256, 512, False, None),         # G = 8, not causal
    (2, 1000, 8, 2, 64, 1000, True, None),         # Dh 64, window = S
    (1, 77, 4, 1, 64, 64, True, None),             # Dh 64, S 77
    (1, 1000, 4, 1, 256, 0, False, None),          # not causal
    (1, 100, 4, 1, 256, 0, True, 300),             # Sq < Sk
    (1, 300, 8, 2, 128, 0, False, 100),            # Sq > Sk, not causal
    # the tile at position 96 visits keys 33-127 for window 64: row 127
    # sees 64-127, so its first visited tile (keys 0-63) is all masked
    (1, 1000, 4, 1, 256, 64, True, None),
    (1, 1000, 4, 1, 128, 64, True, None),
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_flash_matches_plain_version(cuda_device, B, S, Hq, Hkv, Dh,
                                          window, causal, Sk, dtype):
    """bf16 within rtol 1e-2 + atol 2e-3 (p is rounded to bf16 against
    another running max and summed in another order, and the output is
    rounded to bf16: one step is at most 2**-7 relative; the absolute part
    covers outputs near 0, and is well below the 0.03 of a typical output
    of a row over 2048 keys);
    f32 within rtol 1e-3 + atol 2e-4 (summation order only).  The call
    counts one launch, on the route ``flash_route`` names."""
    q, k, v = _qkv(S, B, S, Hq, Hkv, Dh, dtype, device=cuda_device, Sk=Sk)
    before = fa.KERNEL.launches
    routes = dict(fa.KERNEL.route_launches)
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.KERNEL.launches == before + 1
    route = fa.flash_route(dtype, Dh)
    routes[route] += 1
    assert fa.KERNEL.route_launches == routes
    assert route == ("simt" if dtype == torch.float32 else
                     "wgmma" if Dh in (64, 80, 128, 256) else "mma_sync")
    want = tref.flash_attention(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(got.float(), want.float(), **CUDA_TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("Sq,Sk,Hq,Hkv,Dh,window,causal,q_offset,kv_offset", [
    # a mesh prefill's shard: queries [1024, 2048) over keys [0, 4096)
    (1024, 4096, 4, 1, 256, 512, True, 1024, 0),
    (1024, 4096, 4, 1, 256, BIG_WINDOW, True, 1024, 0),
    (1000, 3000, 8, 2, 128, 0, True, 2000, 0),     # the last shard, ragged
    (512, 2048, 8, 2, 80, 64, True, 777, 0),       # Dh 80, odd offset
    (300, 1000, 4, 1, 64, 0, True, 5000, 4800),    # both offsets
    (200, 300, 4, 1, 16, 8, True, 100, 0),         # mma_sync's head dim
    (256, 256, 4, 1, 256, 0, True, 0, 128),        # keys after queries
])
@pytest.mark.parametrize("route", ["wgmma", "mma_sync", "simt"])
def test_cuda_flash_with_offsets_matches_plain_version(
        cuda_device, monkeypatch, Sq, Sk, Hq, Hkv, Dh, window, causal,
        q_offset, kv_offset, route):
    """The query offset on each route: the kernels take q_offset -
    kv_offset as one int and mask and skip tiles by it; held to the plain
    version at the same offsets within ``CUDA_TOL`` (``simt`` in f32,
    ``mma_sync`` forced where the rule gives ``wgmma``); rows that see no
    key are undefined and left out.  Offsets 0 give the bits the kernel
    gives without them."""
    if route == "wgmma" and Dh not in fa.WGMMA_HEAD_DIMS:
        pytest.skip(f"no wgmma tile for Dh {Dh}")
    dtype = torch.float32 if route == "simt" else torch.bfloat16
    q, k, v = _qkv(Sq, 1, Sq, Hq, Hkv, Dh, dtype, device=cuda_device, Sk=Sk)
    monkeypatch.setattr(fa, "flash_route", lambda *_: route)
    kw = dict(causal=causal, window=window)
    before = fa.KERNEL.route_launches[route]
    got = fa.flash_attention(q, k, v, q_offset=q_offset, kv_offset=kv_offset,
                             **kw)
    want = tref.flash_attention(q, k, v, q_offset=q_offset,
                                kv_offset=kv_offset, **kw)
    torch.cuda.synchronize()
    assert fa.KERNEL.route_launches[route] == before + 1
    pos = q_offset - kv_offset + torch.arange(Sq, device=cuda_device)
    sees = (pos >= 0) & ((pos - (Sk - 1) < window) if window > 0
                         else torch.ones_like(pos, dtype=torch.bool))
    torch.testing.assert_close(got[:, sees].float(), want[:, sees].float(),
                               **CUDA_TOL[dtype])
    plain = fa.flash_attention(q, k, v, **kw)
    zero = fa.flash_attention(q, k, v, q_offset=0, kv_offset=0, **kw)
    assert torch.equal(plain, zero)


def test_route_codes_name_every_forward_route():
    """The C entry takes the route by code: every route has one, and the
    codes are the C rule's (0 SIMT, 1 mma.sync, 2 wgmma)."""
    assert set(fa.ROUTE_CODES) == set(fa.ROUTES)
    assert fa.ROUTE_CODES == {"simt": 0, "mma_sync": 1, "wgmma": 2}


@pytest.mark.gpu
@pytest.mark.parametrize("Dh", [80, 128])
def test_cuda_flash_forced_mma_sync_runs_where_the_rule_gives_wgmma(
        cuda_device, monkeypatch, Dh):
    """A call forced onto mma_sync through the route rule (as the smoke
    times the old route) runs and is counted there, within the bf16
    tolerance of the plain version; the C entry refuses wgmma at a head
    dim it has no tile for."""
    q, k, v = _qkv(Dh, 2, 130, 8, 2, Dh, torch.bfloat16, device=cuda_device)
    monkeypatch.setattr(fa, "flash_route", lambda *_: "mma_sync")
    before = dict(fa.KERNEL.route_launches)
    got = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert fa.KERNEL.route_launches == {
        r: n + (r == "mma_sync") for r, n in before.items()}
    want = tref.flash_attention(q, k, v)
    torch.testing.assert_close(got.float(), want.float(),
                               **CUDA_TOL[torch.bfloat16])
    q, k, v = _qkv(0, 1, 64, 4, 1, 96, torch.bfloat16, device=cuda_device)
    monkeypatch.setattr(fa, "flash_route", lambda *_: "wgmma")
    with pytest.raises(RuntimeError):
        fa.flash_attention(q, k, v)


@pytest.mark.gpu
def test_cuda_flash_wgmma_route_refuses_unaligned_inputs(cuda_device):
    """TMA reads 16-byte aligned memory: a contiguous view that starts 2
    bytes into its storage is refused, not read wrongly."""
    q, k, v = _qkv(0, 1, 64, 4, 1, 128, torch.bfloat16, device=cuda_device)
    flat = torch.empty(q.numel() + 1, dtype=q.dtype, device=cuda_device)
    shifted = flat[1:].view(q.shape)
    shifted.copy_(q)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    with pytest.raises(ValueError):
        fa.flash_attention(shifted, k, v)


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_bhsd_matches_plain_version(cuda_device, causal, dtype):
    rng = np.random.default_rng(2)
    q, k, v = (_randn(rng, (4, 256, 64), dtype, s, cuda_device)
               for s in (0.5, 0.5, 1.0))
    got = fa.flash_attention_bhsd(q, k, v, causal=causal)
    want = tref.flash_attention(q, k, v, causal=causal)
    torch.testing.assert_close(got.float(), want.float(), **CUDA_TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("needs_grad", ["q", "k", "v"])
def test_cuda_flash_autograd_runs_bf16_and_refuses_f32(cuda_device,
                                                       needs_grad):
    """The card refuses f32 no longer, despite this test's name: f32
    differentiates through the ``simt`` backward as bf16 does through
    ``wgmma``.  Under autograd a call in either type launches the forward
    (with its lse) and, in ``backward``, the backward kernel once, on the
    routes its type takes (bf16 at Dh 256: ``wgmma`` both ways; f32:
    ``simt`` both ways), and returns a finite gradient for each input that
    requires one; with grad mode off, or in inference mode, no backward
    exists and the output is the same bits."""
    for dtype, route, bwd_route in ((torch.bfloat16, "wgmma", "wgmma"),
                                    (torch.float32, "simt", "simt")):
        q, k, v = _qkv(5, 1, 64, 4, 1, 256, dtype, device=cuda_device)
        qkv = {"q": q, "k": k, "v": v}
        qkv[needs_grad] = qkv[needs_grad].clone().requires_grad_()
        before = (dict(fa.KERNEL.route_launches),
                  dict(fa.BWD_KERNEL.route_launches))
        out = fa.flash_attention(**qkv, window=8)
        assert out.grad_fn is not None
        out.float().square().sum().backward()
        torch.cuda.synchronize()
        assert fa.KERNEL.route_launches == {
            r: n + (r == route) for r, n in before[0].items()}
        assert fa.BWD_KERNEL.route_launches == {
            r: n + (r == bwd_route) for r, n in before[1].items()}
        grad = qkv[needs_grad].grad
        assert grad is not None and grad.shape == qkv[needs_grad].shape
        assert grad.dtype == dtype
        assert bool(torch.isfinite(grad.float()).all())
        assert grad.abs().sum() > 0
        with torch.no_grad():
            got = fa.flash_attention(**qkv, window=8)
        with torch.inference_mode():
            again = fa.flash_attention(**qkv, window=8)
        assert not got.requires_grad and torch.equal(got, again)
        assert torch.equal(got, out.detach())


def _exact_grads(q, k, v, do, causal, window):
    """The f64 gradient of attention over q * the bf16-rounded scale (the
    product not rounded), k and v, with the output gradient do."""
    Dh, G = q.shape[-1], q.shape[2] // k.shape[2]
    scale = float(torch.tensor(Dh ** -0.5, dtype=q.dtype))
    qd, kd, vd = (t.double().requires_grad_() for t in (q, k, v))
    i = torch.arange(q.shape[1], device=q.device)[:, None]
    j = torch.arange(k.shape[1], device=q.device)[None, :]
    seen = torch.ones((q.shape[1], k.shape[1]), dtype=torch.bool,
                      device=q.device)
    if causal:
        seen &= j <= i
    if window > 0:
        seen &= i - j < window
    s = torch.einsum("bqhd,bkhd->bhqk", qd * scale,
                     kd.repeat_interleave(G, 2))
    o = torch.einsum("bhqk,bkhd->bqhd",
                     s.masked_fill(~seen, float("-inf")).softmax(-1),
                     vd.repeat_interleave(G, 2))
    o.backward(do.double())
    return qd.grad, kd.grad, vd.grad


def _max_err(a, exact) -> float:
    """max |a - exact| over max |exact|."""
    return float((a.double() - exact).abs().max() / exact.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,Hq,Hkv,Dh,window,causal,Sk", [
    (2, 600, 4, 1, 256, 512, True, None),    # gemma3: a local layer
    (1, 700, 4, 1, 256, 0, True, None),      # gemma3: a global layer
    (1, 300, 2, 2, 128, 64, True, None),     # G = 1
    (2, 130, 4, 2, 80, 0, True, None),       # stablelm's Dh, G = 2
    (1, 77, 4, 1, 16, 64, False, None),      # the smoke configs' Dh, ragged
    (1, 200, 8, 2, 64, 0, True, None),
    (1, 100, 4, 1, 256, 0, True, 300),       # Sq < Sk
    (1, 300, 8, 2, 128, 0, False, 100),      # Sq > Sk, not causal
    (1, 500, 12, 4, 256, 0, True, None),     # G = 3: a 64-row tile holds 63
    (1, 333, 10, 2, 64, 64, True, None),     # G = 5: 60 rows a tile
])
def test_cuda_flash_bwd_matches_plain_version_and_exact_gradient(
        cuda_device, B, S, Hq, Hkv, Dh, window, causal, Sk):
    """The backward kernel against the f64 exact gradient: per gradient its
    max error over max |g| within twice the plain version's plus 1e-3 (both
    round q * scale, p and the outputs to bf16; the kernel also takes ds as
    two bf16 parts (wgmma) or rounds it (mma_sync) and sums in another
    order).  o and lse come from the forward
    kernel, as in training, within the forward's tolerances of the plain
    forward's; the plain backward reads the plain forward's, so a wrong lse
    fails the limit rather than raise it.  Two calls give the same bits;
    one call counts
    one launch, under the route ``flash_bwd_route`` gives (wgmma at Dh 64,
    80, 128 and 256, mma_sync at 16)."""
    q, k, v = _qkv(S + Dh, B, S, Hq, Hkv, Dh, torch.bfloat16,
                   device=cuda_device, Sk=Sk)
    do = _randn(np.random.default_rng(S), tuple(q.shape), torch.bfloat16,
                device=cuda_device)
    o, lse = fa._forward_cuda(q, k, v, causal, window, True)
    route = fa.flash_bwd_route(torch.bfloat16, Dh)
    assert route == ("wgmma" if Dh in (64, 80, 128, 256) else "mma_sync")
    before = (fa.BWD_KERNEL.launches, dict(fa.BWD_KERNEL.route_launches))
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                 window=window)
    again = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                   window=window)
    torch.cuda.synchronize()
    assert fa.BWD_KERNEL.launches == before[0] + 2
    assert fa.BWD_KERNEL.route_launches == {
        r: n + 2 * (r == route) for r, n in before[1].items()}
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    ro, rlse = tref.flash_attention(q, k, v, causal=causal, window=window,
                                    return_lse=True)
    torch.testing.assert_close(o.float(), ro.float(),
                               **CUDA_TOL[torch.bfloat16])
    torch.testing.assert_close(lse, rlse, rtol=1e-4, atol=1e-4)
    plain = tref.flash_attention_bwd(q, k, v, ro, rlse, do, causal=causal,
                                     window=window)
    exact = _exact_grads(q, k, v, do, causal, window)
    for g, p, e in zip(got, plain, exact):
        assert g.dtype == torch.bfloat16 and g.shape == p.shape
        assert _max_err(g, e) <= 2 * _max_err(p, e) + 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("Dh,Hq", [(64, 8), (80, 8), (256, 8), (128, 6),
                                   (64, 10)])
def test_cuda_flash_forward_lse_is_deterministic_and_matches_plain(
        cuda_device, Dh, Hq):
    """The forward's lse (wgmma at Dh 64, 80, 128 and 256;
    G = 4, and G = 3 and 5, where 128 packed rows leave 2 and 3 of a tile
    empty) within 1e-4 of the plain version's, and the same bits in a
    second call (the backward's recompute under remat relies on it); the
    output is the same bits with and without lse."""
    q, k, v = _qkv(Dh, 2, 333, Hq, 2, Dh, torch.bfloat16, device=cuda_device)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    outs = []
    for _ in range(2):
        out = fa.flash_attention(q, k, v, window=64)
        outs.append((out.detach(), out.grad_fn.saved_tensors[4]))
    (o1, l1), (o2, l2) = outs
    assert torch.equal(o1, o2) and torch.equal(l1, l2)
    with torch.no_grad():
        assert torch.equal(o1, fa.flash_attention(q, k, v, window=64))
    _, want = tref.flash_attention(q.detach(), k.detach(), v.detach(),
                                   window=64, return_lse=True)
    torch.testing.assert_close(l1, want, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(0, 64, 4, 256), (2, 0, 4, 256),
                                   (2, 64, 0, 256)])
def test_cuda_flash_of_no_queries_launches_nothing(cuda_device, shape):
    """An empty q gives an empty output without a launch: the launch count
    is the count of kernels that ran."""
    B, S, Hq, Dh = shape
    q = torch.zeros(shape, dtype=torch.bfloat16, device=cuda_device)
    k = v = torch.zeros((B, 64, 1, Dh), dtype=torch.bfloat16,
                        device=cuda_device)
    before = fa.KERNEL.launches
    got = fa.flash_attention(q, k, v, window=8)
    torch.cuda.synchronize()
    assert fa.KERNEL.launches == before
    assert got.shape == shape and got.dtype == torch.bfloat16


@pytest.mark.gpu
@pytest.mark.parametrize("N,D,B,F,variant", [
    (64, 128, 8, 5, None), (1000, 100, 333, 1, None),
    (416_768, 128, 20_000, 10, None), (5000, 128, 800, 25, None),
    (5000, 128, 300, 40, None), (5000, 128, 500, 10, "misaligned"),
    (5000, 128, 500, 10, "row0_inf")])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_sage_matches_plain_version_bitwise(cuda_device, N, D, B, F,
                                                 variant, dtype):
    """Bitwise against the plain version (NaN in the same places), on the
    route ``sage_route`` gives: a table at storage offset 1 takes
    ``scalar``; with row 0 = +inf every row with a pad is NaN."""
    rng = np.random.default_rng(N + F)
    table = _randn(rng, (N * D + 1,), dtype, device=cuda_device)
    table = (table[1:] if variant == "misaligned" else table[:-1]).view(N, D)
    if variant == "row0_inf":
        table[0] = float("inf")
    idx = rng.integers(-1, N, size=(B, F)).astype(np.int32)
    idx[0] = -1  # a row of pads only
    idx = torch.from_numpy(idx).to(cuda_device)
    w = torch.from_numpy(rng.random((B, F)).astype(np.float32)).to(cuda_device)
    route = sage_agg.sage_route(D, dtype, table.data_ptr())
    assert (route == "scalar") == (variant == "misaligned"
                                   or D * table.element_size() % 16 != 0)
    before = dict(sage_agg.KERNEL.route_launches)
    got = sage_agg.sage_aggregate(table, idx, w)
    torch.cuda.synchronize()
    assert sage_agg.KERNEL.route_launches == before | {
        route: before[route] + 1}
    want = tref.sage_aggregate(table, idx, w)
    nan = got.isnan()
    assert torch.equal(nan, want.isnan())
    assert torch.equal(got.masked_fill(nan, 0), want.masked_fill(nan, 0))
    if variant == "row0_inf":
        assert torch.equal(nan.any(1), (idx < 0).any(1).to(cuda_device))
    else:
        assert not got[0].any()


@pytest.mark.gpu
def test_cuda_generate_matches_the_plain_path_on_the_cpu(cuda_device):
    """The gemma3 smoke config served on the card (the flash kernel, cuBLAS)
    and on the CPU (the plain version): the same weights, the card's decode
    steps fed the CPU's greedy tokens; logits within atol 5e-3 (bf16
    activations rounded at other points over 3 layers: measured one bf16
    step, 9.8e-4, at logits of about 0.16)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve_lm import generate
    from repro_torch.models import transformer
    from repro_torch.models.params import init_from_defs

    cfg = get_config("gemma3-1b", smoke=True)
    params = init_from_defs(transformer.defs(cfg),
                            torch.Generator().manual_seed(0), "cpu")
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, (4, 24))
    cpu = generate(cfg, params, prompts, 16, device="cpu")
    gpu_params = {k: (v.to(cuda_device) if isinstance(v, torch.Tensor)
                      else {n: t.to(cuda_device) for n, t in v.items()})
                  for k, v in params.items()}
    tokens = cpu.tokens.to(cuda_device)
    before = fa.KERNEL.launches
    with torch.inference_mode():
        logits, cache = transformer.prefill(
            cfg, gpu_params, torch.as_tensor(prompts, device=cuda_device),
            max_len=24 + 16)
        outs = [logits[:, -1:, :cfg.vocab_size]]
        for i in range(15):
            logits, cache = transformer.decode_step(
                cfg, gpu_params, cache, tokens[:, i:i + 1], 24 + i)
            outs.append(logits[:, :, :cfg.vocab_size])
    assert fa.KERNEL.launches == before + cfg.n_layers
    torch.testing.assert_close(torch.cat(outs, 1).float().cpu(),
                               cpu.logits.float(), rtol=0, atol=5e-3)
