"""Fused gather + weighted sum (GraphSAGE AGGREGATE):
``out[b] = Σ_f w[b, f] · table[idx[b, f]]``.

Fusing the neighbour gather with the weighted sum never writes the
(B, F, D) rows.  On CUDA tensors the wrapper launches the hand-written
Hopper kernel (``csrc/sage_aggregate.cu``) on one of its two routes,
``vec`` (16-byte row gathers, every neighbour of a run in flight) or
``scalar`` (one element per load, any width and alignment), chosen by
``sage_route`` from the shape and the table's address; on CPU tensors it
runs the plain version in ``kernels/ref.py``.  There is no other fallback.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import CudaKernel

ROUTES = ("vec", "scalar")  # the C entry's route codes, in order
KERNEL = CudaKernel(
    "sage_aggregate", "csrc/sage_aggregate.cu", "sage_aggregate",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_int64] * 4
    + [ctypes.c_void_p], routes=ROUTES)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def sage_route(D: int, dtype: torch.dtype, data_ptr: int) -> str:
    """The route a table of row width ``D`` and type ``dtype`` at address
    ``data_ptr`` takes: ``vec`` when its rows are a multiple of 16 bytes
    and it starts on a 16-byte boundary (every row then does), else
    ``scalar``."""
    row_bytes = D * dtype.itemsize
    if row_bytes > 0 and row_bytes % 16 == 0 and data_ptr % 16 == 0:
        return "vec"
    return "scalar"


def sage_aggregate(table: torch.Tensor, idx: torch.Tensor,
                   weights: torch.Tensor) -> torch.Tensor:
    """table (N, D) f32 or bf16 with N >= 1; idx (B, F) int32, negatives
    are pads (weight 0), indices past the end read the last row; weights
    (B, F) f32.  Returns (B, D) in the table's type, accumulated in f32 in
    the order f = 0, 1, … with one rounded multiply and one rounded add per
    term, so the kernel equals the plain version bit for bit."""
    if table.dim() != 2 or table.shape[0] < 1:
        raise ValueError(f"table must be 2-D with at least one row, got "
                         f"{tuple(table.shape)}")
    if table.dtype not in _DTYPES:
        raise TypeError(f"table must be f32 or bf16, got {table.dtype}")
    if idx.dtype != torch.int32 or weights.dtype != torch.float32:
        raise TypeError(f"idx must be int32 and weights f32, got {idx.dtype}"
                        f" and {weights.dtype}")
    if idx.dim() != 2 or weights.shape != idx.shape:
        raise ValueError(f"idx and weights must both be (B, F), got "
                         f"{tuple(idx.shape)} and {tuple(weights.shape)}")
    devices = {t.device for t in (table, idx, weights)}
    if len(devices) != 1:
        raise ValueError(f"all inputs must share one device, got {devices}")
    if table.device.type == "cpu":
        return ref.sage_aggregate(table, idx, weights)
    if table.device.type != "cuda":
        raise ValueError(f"unsupported device {table.device}")
    if not all(t.is_contiguous() for t in (table, idx, weights)):
        raise ValueError("sage_aggregate needs contiguous inputs")
    (N, D), (B, F) = table.shape, idx.shape
    out = torch.empty((B, D), dtype=table.dtype, device=table.device)
    if B == 0 or D == 0:
        return out
    route = sage_route(D, table.dtype, table.data_ptr())
    fn = KERNEL.fn()
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        err = fn(table.data_ptr(), idx.data_ptr(), weights.data_ptr(),
                 out.data_ptr(), _DTYPES[table.dtype], ROUTES.index(route),
                 N, D, B, F, stream)
    KERNEL.check(err)
    KERNEL.count_launch(route)
    return out
