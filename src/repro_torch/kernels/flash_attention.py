"""Online-softmax attention and its gradient: the LM path's hot spot.

``flash_attention`` takes the LM path's layout — q (B, Sq, Hq, Dh), k and v
(B, Sk, Hkv, Dh) with grouped-query heads, a per-call sliding window and
the reference's query and key offsets (a mesh prefill's query block sits at
its sequence offset; the kernels take ``q_offset - kv_offset`` as one int)
— and ``flash_attention_bhsd`` the TPU kernel's (BH, S, Dh).  On CUDA tensors
they launch one of the hand-written Hopper kernels of
``csrc/flash_attention.cu``, chosen by ``flash_route(dtype, Dh)`` alone:
``wgmma`` (bf16 with Dh 64, 80, 128 or 256: TMA, wgmma, warp-specialised,
GQA heads packed into one tile; Dh 80 as a 64-column box and a 16-column
one), ``mma_sync`` (bf16, other head dims) or ``simt`` (f32).  The wrapper
passes the route to the kernel, which refuses one that does not apply
(``mma_sync`` takes any bf16 head dim).  On CPU tensors they run the plain
version in ``kernels/ref.py``.  There is no other fallback.

Under autograd (grad mode on and q, k or v requiring grad) the call is a
``torch.autograd.Function``: its forward also writes each row's
log-sum-exp and saves q, k, v, the output and the lse; its backward is
``flash_attention_bwd``, the hand-written kernels of
``csrc/flash_attention_bwd.cu`` (counted on ``BWD_KERNEL``; the
forward's offsets carried over, so that a mesh position's sequence block
trains at its offset), on the
route ``flash_bwd_route(dtype, Dh)`` gives: in bf16 ``wgmma`` (Dh 64, 80,
128 or 256: TMA, wgmma, warp-specialised, GQA heads packed into 64-row
tiles) or ``mma_sync`` (other head dims), in f32 ``simt`` (any head dim:
f32 products on the CUDA cores, nothing rounded but each f32 operation).
So the card differentiates every call its forward takes, f32 through one
``simt`` forward and one ``simt`` backward launch (``chip_smoke.py``'s
``flash_f32_autograd`` and ``f32_backward_phase``, the ``gpu`` tests of
``tests/test_torch_lm_kernels.py``).  On CPU
tensors both directions run the plain versions (``ref.flash_attention``
with ``return_lse``, ``ref.flash_attention_bwd``).  Without autograd
(serving, under ``inference_mode``) no lse is written.

On ``meta`` tensors (the dry-run's accounting, ``launch/dryrun.py``) both
directions check their inputs as on the card and return empty outputs of
the card's shapes and types, the backward's scratch allocated beside them.
Where a cost counter of the inputs' device is in force
(``accounting.counter``), each call of either direction records the work
``flash_cost`` gives, whatever the device; with none, no cost is built.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from repro_torch.kernels import accounting, ref
from repro_torch.kernels._build import CudaKernel

ROUTES = ("wgmma", "mma_sync", "simt")
ROUTE_CODES = {"simt": 0, "mma_sync": 1, "wgmma": 2}  # the C entry's codes
KERNEL = CudaKernel(
    "flash_attention", "csrc/flash_attention.cu", "flash_attention",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 11 + [ctypes.c_float,
                                                   ctypes.c_void_p],
    routes=ROUTES)
BWD_ROUTES = ("wgmma", "mma_sync", "simt")  # the C entry's codes, in order
BWD_KERNEL = CudaKernel(
    "flash_attention_bwd", "csrc/flash_attention_bwd.cu",
    "flash_attention_bwd",
    [ctypes.c_void_p] * 7 + [ctypes.c_int64] + [ctypes.c_void_p] * 3
    + [ctypes.c_int] * 10 + [ctypes.c_float, ctypes.c_void_p],
    routes=BWD_ROUTES,
    symbols={"flash_attention_bwd_route": [ctypes.c_int, ctypes.c_int],
             "flash_attention_bwd_scratch_bytes":
                 [ctypes.c_int] * 6 + [ctypes.c_float,
                                       ctypes.POINTER(ctypes.c_int64)]})
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256
WGMMA_HEAD_DIMS = (64, 80, 128, 256)
BWD_ROWS = 64  # kRows of csrc/flash_attention_bwd.cu: packed rows per tile
# every answer of the library's scratch rule, by (route, B, Sq, Hq, Hkv, Dh,
# scale): what ``bwd_scratch_bytes`` asked on the card
SCRATCH_ASKED: dict = {}


def causal_pairs(S: int, window: int) -> int:
    """Visible (query, key) pairs of one head of causal attention over S
    positions with a window (<= 0: unbounded)."""
    w = window if 0 < window < S else S
    return w * (w + 1) // 2 + (S - w) * w


def visible_pairs(Sq: int, Sk: int, shift: int, causal: bool,
                  window: int) -> int:
    """Visible (query, key) pairs of one head when query ``i`` sits
    ``shift`` positions after key ``i`` (``shift = q_offset - kv_offset``):
    key ``j < Sk`` is visible to query ``i`` when (``causal``) ``j <= i +
    shift`` and (``window > 0``) ``i + shift - j < window``."""
    i = np.arange(Sq, dtype=np.int64) + shift
    hi = np.minimum(i, Sk - 1) if causal else np.full(Sq, Sk - 1)
    lo = np.maximum(i - window + 1, 0) if window > 0 else np.zeros(Sq,
                                                                   np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def flash_work(q, k, window: int, causal: bool = True, *,
               backward: bool = False, lse: bool = False,
               shift: int = 0) -> tuple:
    """(bytes, flops) one call needs at least, its bound's terms.  Forward:
    q, k, v and out once each (and the lse written, with ``lse``); 4 * Dh
    flops per visible (query, key) pair and query head (every pair when not
    causal).  Backward: q, o, do in and dq out, k, v in and dk, dv out, lse
    in; 10 * Dh flops per pair (5 products).  With a ``shift`` (``q_offset
    - kv_offset``) the pairs are ``visible_pairs``'."""
    B, Sq, Hq, Dh = q.shape
    if shift:
        pairs = visible_pairs(Sq, k.shape[1], shift, causal, window)
    else:
        pairs = causal_pairs(Sq, window) if causal else Sq * k.shape[1]
    es = q.element_size()
    if backward:
        return (4 * (q.numel() + k.numel()) * es + 4 * B * Hq * Sq,
                10 * Dh * B * Hq * pairs)
    return ((2 * q.numel() + 2 * k.numel()) * es
            + (4 * B * Hq * Sq if lse else 0), 4 * Dh * B * Hq * pairs)


def scan_flops(q, k, block_kv: int = 1024) -> int:
    """Matrix-product flops of the reference's forward
    (``src/repro/models/layers.py:75``) as its HLO counts them: two products
    of 2 * Dh flops per (query, key) pair and query head, over every key
    block of its ``lax.scan`` (the keys padded to a multiple of
    ``min(block_kv, Sk)``), whatever the mask."""
    B, Sq, Hq, Dh = q.shape
    Sk = k.shape[1]
    block = min(block_kv, Sk)
    padded = -(-Sk // block) * block if block else 0
    return 4 * B * Hq * Sq * padded * Dh


def flash_cost(q, k, causal: bool, window: int, block_kv: int, *,
               backward: bool = False, lse: bool = False,
               shift: int = 0) -> dict:
    """One call's work for ``op_cost.OpCounter.kernel``: the bytes and the
    visible-pair flops of ``flash_work``, and the reference's HLO count
    (twice the forward's for the backward, as differentiating its scan
    gives)."""
    nbytes, flops = flash_work(q, k, window, causal, backward=backward,
                               lse=lse, shift=shift)
    return {"flops": flops, "nbytes": nbytes, "dtype": q.dtype,
            "hlo_flops": scan_flops(q, k, block_kv) * (2 if backward else 1)}


def flash_route(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel a CUDA call launches, by (dtype, Dh) alone — the rule
    ``flash_attention_route`` in ``csrc/flash_attention.cu`` applies too."""
    if dtype != torch.bfloat16:
        return "simt"
    return "wgmma" if head_dim in WGMMA_HEAD_DIMS else "mma_sync"


def flash_bwd_route(dtype: torch.dtype, head_dim: int) -> str:
    """The backward kernel a CUDA call launches, by (dtype, Dh) alone — the
    rule ``flash_attention_bwd_route`` in ``csrc/flash_attention_bwd.cu``
    applies too: ``wgmma`` for bf16 with Dh 64, 80, 128 or 256, ``mma_sync``
    for other bf16 head dims, ``simt`` for f32."""
    if dtype != torch.bfloat16:
        return "simt"
    return "wgmma" if head_dim in WGMMA_HEAD_DIMS else "mma_sync"


def bwd_scratch_bytes(route: str, B: int, Sq: int, Hq: int, Hkv: int,
                      Dh: int, scale: float) -> int:
    """Device scratch a backward launch on ``route`` needs, by the rule of
    ``flash_attention_bwd_scratch_bytes`` in ``csrc/flash_attention_bwd.cu``
    (the one the launch checks): D on ``mma_sync`` and ``simt``; on
    ``wgmma`` lse * log2 e and D for each GQA-packed row and, when the
    scale is not a power of two (Dh 80, 128), bf16(q * scale).  Builds the library on first use; each
    answer is kept in ``SCRATCH_ASKED``."""
    key = (route, B, Sq, Hq, Hkv, Dh, scale)
    if key not in SCRATCH_ASKED:
        nbytes = ctypes.c_int64()
        BWD_KERNEL.check(BWD_KERNEL.fn("flash_attention_bwd_scratch_bytes")(
            BWD_ROUTES.index(route), B, Sq, Hq, Hkv, Dh, scale,
            ctypes.byref(nbytes)))
        SCRATCH_ASKED[key] = nbytes.value
    return SCRATCH_ASKED[key]


def scratch_rule(route: str, B: int, Sq: int, Hq: int, Hkv: int, Dh: int,
                 scale: float) -> int:
    """``bwd_scratch_bytes`` without the library: a copy of
    ``scratch_need`` in ``csrc/flash_attention_bwd.cu`` (the meta device's
    answer; ``chip_smoke.py`` holds it to the library's)."""
    if route != "wgmma":
        return 4 * B * Sq * Hq
    G = Hq // Hkv
    gt = min(G, BWD_ROWS)
    rows = B * Hkv * -(-G // gt) * -(-Sq // (BWD_ROWS // gt)) * BWD_ROWS
    pow2 = math.frexp(scale)[0] == 0.5  # exact to fold into the exponent
    return 8 * rows + (0 if pow2 else 2 * B * Sq * Hq * Dh)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q, k, v must be 4-D (B, S, H, Dh), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, Hq, Dh = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != Dh:
        raise ValueError(f"k and v must be (B, Sk, Hkv, Dh) = "
                         f"({B}, Sk, Hkv, {Dh}), got {tuple(k.shape)} and "
                         f"{tuple(v.shape)}")
    Hkv = k.shape[2]
    if Hkv < 1 or Hq % Hkv:
        raise ValueError(f"query heads {Hq} must be a multiple of kv heads "
                         f"{Hkv}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must all be bf16 or all f32, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if Dh % 16 or not 16 <= Dh <= MAX_HEAD_DIM:
        raise ValueError(f"head dim must be a multiple of 16 up to "
                         f"{MAX_HEAD_DIM}, got {Dh}")
    devices = {t.device for t in (q, k, v)}
    if len(devices) != 1:
        raise ValueError(f"q, k, v must share one device, got {devices}")
    if q.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"unsupported device {q.device}")


def _cuda_args(q, k, window: int, shift: int = 0) -> float:
    """Checks a CUDA launch needs beyond ``_check``; returns the scale,
    rounded to the input type (jnp's weakly typed scalar takes the input's
    type: exact for Dh = 16, 64, 256)."""
    for name, value in (("window", window), ("Sq", q.shape[1]),
                        ("Sk", k.shape[1]),
                        ("q_offset - kv_offset + Sq", shift + q.shape[1]),
                        ("q_offset - kv_offset - window",
                         shift - max(window, 0))):
        if not -(1 << 31) <= value < (1 << 31):
            raise ValueError(f"{name} {value} does not fit the kernel's int32")
    return float(torch.tensor(q.shape[3] ** -0.5, dtype=q.dtype))


def _forward_cuda(q, k, v, causal: bool, window: int, with_lse: bool,
                  shift: int = 0):
    """One launch of the forward kernel: (out, lse or None)."""
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError("flash_attention needs contiguous inputs")
    scale = _cuda_args(q, k, window, shift)
    B, Sq, Hq, Dh = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    route = flash_route(q.dtype, Dh)
    if route == "wgmma" and any(t.data_ptr() % 16 for t in (q, k, v)
                                if t.numel()):
        raise ValueError("the wgmma route reads q, k, v by TMA and needs "
                         "them 16-byte aligned")
    out = torch.empty_like(q)
    lse = (torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if out.numel() == 0:
        return out, lse
    fn = KERNEL.fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr() if with_lse else None, _DTYPES[q.dtype],
                 ROUTE_CODES[route], B, Sq, Sk, Hq, Hkv, Dh, int(causal),
                 int(window), int(shift), scale, stream)
    KERNEL.check(err)
    KERNEL.count_launch(route)
    return out, lse


def _forward(q, k, v, causal: bool, window: int, block_kv: int,
             with_lse: bool, q_offset: int = 0, kv_offset: int = 0):
    """One forward on q's device, its work recorded by the counter in
    force: (out, lse or None)."""
    offsets = (q_offset, kv_offset)
    c = accounting.counter(q.device)
    if c is None:
        return _forward_on(q, k, v, causal, window, block_kv, with_lse,
                           *offsets)
    with c.kernel("flash_attention", **flash_cost(
            q, k, causal, window, block_kv, lse=with_lse,
            shift=q_offset - kv_offset)):
        return _forward_on(q, k, v, causal, window, block_kv, with_lse,
                           *offsets)


def _forward_on(q, k, v, causal: bool, window: int, block_kv: int,
                with_lse: bool, q_offset: int, kv_offset: int):
    """The kernel on CUDA, the plain version on the CPU (its outputs made
    contiguous, as the kernel's are, so that the ops after it are the
    card's), empty outputs on ``meta``."""
    if q.device.type == "cpu":
        out = ref.flash_attention(q, k, v, causal=causal, window=window,
                                  block_kv=block_kv, return_lse=with_lse,
                                  q_offset=q_offset, kv_offset=kv_offset)
        if with_lse:
            return out[0].contiguous(), out[1].contiguous()
        return out.contiguous(), None
    if q.device.type == "meta":
        if not all(t.is_contiguous() for t in (q, k, v)):
            raise ValueError("flash_attention needs contiguous inputs")
        B, Sq, Hq, _ = q.shape
        return torch.empty_like(q), (
            torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
            if with_lse else None)
    return _forward_cuda(q, k, v, causal, window, with_lse,
                         q_offset - kv_offset)


class _Attention(torch.autograd.Function):
    """The kernel (or, on the CPU, the plain version) forward with its lse
    saved, and the backward kernel (or its plain version) as the
    gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, block_kv, q_offset, kv_offset):
        out, lse = _forward(q, k, v, causal, window, block_kv, True,
                            q_offset, kv_offset)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = {"causal": causal, "window": window, "block_kv": block_kv,
                  "q_offset": q_offset, "kv_offset": kv_offset}
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse,
                                         dout.contiguous(), **ctx.kw)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    block_kv: int = 1024, q_offset: int = 0,
                    kv_offset: int = 0) -> torch.Tensor:
    """Attention of q (B, Sq, Hq, Dh) over k, v (B, Sk, Hkv, Dh).

    Query head ``h`` reads kv head ``h // (Hq // Hkv)``; query ``i`` and key
    ``j`` sit at positions ``q_offset + i`` and ``kv_offset + j`` (host
    ints; the kernels take their difference); a key is visible when
    (``causal``) it is not after the query and (``window > 0``) it is less
    than ``window`` positions before it.  bf16 or f32, all three
    of one type; Dh a multiple of 16 up to 256.  Returns (B, Sq, Hq, Dh) in
    the input type.  ``block_kv`` is the plain version's key block; the
    kernels tile keys by 64 (bf16) or 32 (f32) and visit only the tiles
    their queries can see.  A query that sees no key at all is undefined.
    Differentiable (see the module's doc) at any offsets, in either type.
    """
    _check(q, k, v)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _Attention.apply(q, k, v, causal, window, block_kv, q_offset,
                                kv_offset)
    return _forward(q, k, v, causal, window, block_kv, False, q_offset,
                    kv_offset)[0]


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        block_kv: int = 1024, q_offset: int = 0,
                        kv_offset: int = 0) -> tuple:
    """The gradient (dq, dk, dv) of ``flash_attention(q, k, v, q_offset=,
    kv_offset=)`` at output gradient ``do``, from its output ``o`` and
    log-sum-exp ``lse`` (B, Hq, Sq) f32, natural log.  On CUDA tensors one call of the
    hand-written kernels on the route ``flash_bwd_route`` gives (a
    pre-pass with D = rowsum(do * o), then dk and dv, and dq: three
    launches on ``mma_sync`` and ``simt``, two on ``wgmma``, whose dk/dv
    and dq CTAs share one; no atomics, so repeated calls give the same
    bits; counted once, under its route); on CPU tensors
    ``ref.flash_attention_bwd`` (``block_kv`` its key block); on ``meta``
    tensors the card's empty outputs."""
    _check(q, k, v)
    B, Sq, Hq, _ = q.shape
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype \
            or do.dtype != q.dtype:
        raise ValueError(f"o and do must be {tuple(q.shape)} {q.dtype}, got "
                         f"{tuple(o.shape)} {o.dtype} and {tuple(do.shape)} "
                         f"{do.dtype}")
    if lse.shape != (B, Hq, Sq) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be ({B}, {Hq}, {Sq}) f32, got "
                         f"{tuple(lse.shape)} {lse.dtype}")
    if {t.device for t in (o, lse, do)} != {q.device}:
        raise ValueError("q, k, v, o, lse and do must share one device")
    offsets = (q_offset, kv_offset)
    c = accounting.counter(q.device)
    if c is None:
        return _backward_on(q, k, v, o, lse, do, causal, window, block_kv,
                            *offsets)
    with c.kernel("flash_attention_bwd", **flash_cost(
            q, k, causal, window, block_kv, backward=True,
            shift=q_offset - kv_offset)):
        return _backward_on(q, k, v, o, lse, do, causal, window, block_kv,
                            *offsets)


def _backward_on(q, k, v, o, lse, do, causal: bool, window: int,
                 block_kv: int, q_offset: int, kv_offset: int):
    if q.device.type == "cpu":
        return ref.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                       window=window, block_kv=block_kv,
                                       q_offset=q_offset, kv_offset=kv_offset)
    return _backward_device(q, k, v, o, lse, do, causal, window,
                            q_offset - kv_offset)


def _backward_device(q, k, v, o, lse, do, causal: bool, window: int,
                     shift: int = 0):
    """The backward on the card (a launch) or on ``meta`` (the card's
    outputs and scratch, empty)."""
    B, Sq, Hq, Dh = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    ts = (q, k, v, o, do, lse)
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("flash_attention_bwd needs contiguous inputs")
    meta = q.device.type == "meta"
    if not meta and any(t.data_ptr() % 16 for t in ts if t.numel()):
        raise ValueError("flash_attention_bwd reads 16-byte chunks and needs "
                         "its inputs 16-byte aligned")
    scale = _cuda_args(q, k, window, shift)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if q.numel() == 0 or k.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    route = flash_bwd_route(q.dtype, Dh)
    nbytes = (scratch_rule if meta else bwd_scratch_bytes)(
        route, B, Sq, Hq, Hkv, Dh, scale)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=q.device)
    if meta:
        return dq, dk, dv
    fn = BWD_KERNEL.fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 do.data_ptr(), lse.data_ptr(), scratch.data_ptr(), nbytes,
                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                 BWD_ROUTES.index(route), B, Sq, Sk, Hq, Hkv, Dh,
                 int(causal), int(window), int(shift), scale, stream)
    BWD_KERNEL.check(err)
    BWD_KERNEL.count_launch(route)
    return dq, dk, dv


def flash_attention_bhsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True) -> torch.Tensor:
    """The TPU kernel's contract: q, k, v (BH, S, Dh) with heads flattened
    into the batch, causal or full attention, no window."""
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError(f"q, k, v must be 3-D (BH, S, Dh), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    return flash_attention(q[:, :, None], k[:, :, None], v[:, :, None],
                           causal=causal)[:, :, 0]
