"""Online-softmax attention forward: the LM prefill's hot spot.

``flash_attention`` takes the LM path's layout — q (B, Sq, Hq, Dh), k and v
(B, Sk, Hkv, Dh) with grouped-query heads and a per-call sliding window —
and ``flash_attention_bhsd`` the TPU kernel's (BH, S, Dh).  On CUDA tensors
they launch one of the hand-written Hopper kernels of
``csrc/flash_attention.cu``, chosen by ``flash_route(dtype, Dh)`` alone:
``wgmma`` (bf16 with Dh 64, 128 or 256: TMA, wgmma, warp-specialised, GQA
heads packed into one tile), ``mma_sync`` (bf16, other head dims) or
``simt`` (f32).  On CPU tensors they run the plain version in
``kernels/ref.py``.  There is no other fallback.

The kernels are forward only: on a card, a call that autograd would
differentiate (grad mode on and q, k or v requiring grad) raises rather
than return an output with no gradient.  The backward kernel comes with LM
training (ROADMAP, queue 1).  On the CPU the plain version is
differentiable as it is.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import CudaKernel

ROUTES = ("wgmma", "mma_sync", "simt")
KERNEL = CudaKernel(
    "flash_attention", "csrc/flash_attention.cu", "flash_attention",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_float,
                                                  ctypes.c_void_p],
    routes=ROUTES)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256
WGMMA_HEAD_DIMS = (64, 128, 256)


def flash_route(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel a CUDA call launches, by (dtype, Dh) alone — the rule
    ``flash_attention_route`` in ``csrc/flash_attention.cu`` applies too."""
    if dtype != torch.bfloat16:
        return "simt"
    return "wgmma" if head_dim in WGMMA_HEAD_DIMS else "mma_sync"


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    block_kv: int = 1024) -> torch.Tensor:
    """Attention of q (B, Sq, Hq, Dh) over k, v (B, Sk, Hkv, Dh).

    Query head ``h`` reads kv head ``h // (Hq // Hkv)``; query ``i`` and key
    ``j`` sit at positions ``i`` and ``j``; a key is visible when
    (``causal``) it is not after the query and (``window > 0``) it is less
    than ``window`` positions before it.  bf16 or f32, all three
    of one type; Dh a multiple of 16 up to 256.  Returns (B, Sq, Hq, Dh) in
    the input type.  ``block_kv`` is the plain version's key block; the
    kernels tile keys by 64 (bf16) or 32 (f32) and visit only the tiles
    their queries can see.  A query that sees no key at all is undefined.
    """
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q, k, v must be 4-D (B, S, H, Dh), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, Hq, Dh = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != Dh:
        raise ValueError(f"k and v must be (B, Sk, Hkv, Dh) = "
                         f"({B}, Sk, Hkv, {Dh}), got {tuple(k.shape)} and "
                         f"{tuple(v.shape)}")
    Sk, Hkv = k.shape[1], k.shape[2]
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
    dev = q.device
    if dev.type == "cpu":
        return ref.flash_attention(q, k, v, causal=causal, window=window,
                                   block_kv=block_kv)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention on CUDA has no backward kernel yet, so it "
            "cannot give q, k or v a gradient: call it under "
            "torch.no_grad() or torch.inference_mode(); the backward comes "
            "with LM training (ROADMAP, queue 1)")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError("flash_attention needs contiguous inputs")
    for name, value in (("window", window), ("Sq", Sq), ("Sk", Sk)):
        if not -(1 << 31) <= value < (1 << 31):
            raise ValueError(f"{name} {value} does not fit the kernel's int32")
    # jnp's weakly typed scalar takes the input's type: the scale is
    # rounded to bf16 before it multiplies q (exact for Dh = 16, 64, 256).
    scale = float(torch.tensor(Dh ** -0.5, dtype=q.dtype))
    route = flash_route(q.dtype, Dh)
    if route == "wgmma" and any(t.data_ptr() % 16 for t in (q, k, v)
                                if t.numel()):
        raise ValueError("the wgmma route reads q, k, v by TMA and needs "
                         "them 16-byte aligned")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    fn = KERNEL.fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 _DTYPES[q.dtype], B, Sq, Sk, Hq, Hkv, Dh, int(causal),
                 int(window), scale, stream)
    KERNEL.check(err)
    KERNEL.count_launch(route)
    return out


def flash_attention_bhsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True) -> torch.Tensor:
    """The TPU kernel's contract: q, k, v (BH, S, Dh) with heads flattened
    into the batch, causal or full attention, no window."""
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError(f"q, k, v must be 3-D (BH, S, Dh), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    return flash_attention(q[:, :, None], k[:, :, None], v[:, :, None],
                           causal=causal)[:, :, 0]
