"""Unified-cache row scatter: the online-refresh write path.

``out = table`` with ``out[idx[i]] = rows[i]`` for every valid
(non-negative, in-range) index.  The result is a *new* table: the refresh
double-buffers the device feature cache, so in-flight batches keep
gathering from the previous buffer while admitted rows land in the next
one.  On CUDA tensors the wrapper launches the hand-written Hopper kernel
(``csrc/scatter_rows.cu``, table-side over an inverse map it builds
itself); on CPU tensors it runs the plain version in ``kernels/ref.py``.
There is no other fallback.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import CudaKernel

KERNEL = CudaKernel(
    "scatter_rows", "csrc/scatter_rows.cu", "scatter_rows",
    [ctypes.c_void_p] * 5 + [ctypes.c_int64] * 3 + [ctypes.c_void_p])


def scatter_rows(table: torch.Tensor, idx: torch.Tensor,
                 rows: torch.Tensor) -> torch.Tensor:
    """Functional row scatter: ``out = table; out[idx[i]] = rows[i]``.

    table: (N, D); idx: (B,) int32 (negatives and indices >= N are
    dropped); rows: (B, D), cast to the table's type.  Valid indices must be
    unique (a refresh writes each freed slot once); duplicates give an
    unspecified winner.  Returns a new (N, D) tensor and never writes the
    input — except for an empty update (B == 0 or N == 0), which returns
    ``table`` itself and launches nothing.
    """
    if table.dim() != 2:
        raise ValueError(f"table must be 2-D, got {tuple(table.shape)}")
    if idx.dtype != torch.int32:
        raise TypeError(f"idx must be int32, got {idx.dtype}")
    if idx.dim() != 1 or rows.dim() != 2 or rows.shape[0] != idx.shape[0] \
            or rows.shape[1] != table.shape[1]:
        raise ValueError(f"idx (B,) and rows (B, D) must match the table's "
                         f"width, got idx {tuple(idx.shape)}, rows "
                         f"{tuple(rows.shape)}, table {tuple(table.shape)}")
    devices = {t.device for t in (table, idx, rows)}
    if len(devices) != 1:
        raise ValueError(f"all inputs must share one device, got {devices}")
    N, D = table.shape
    B = idx.shape[0]
    if B == 0 or N == 0:
        return table
    if table.device.type == "cpu":
        return ref.scatter_rows(table, idx, rows)
    if table.device.type != "cuda":
        raise ValueError(f"unsupported device {table.device}")
    rows = rows.to(table.dtype)
    if not all(t.is_contiguous() for t in (table, idx, rows)):
        raise ValueError("scatter_rows needs contiguous inputs")
    out = torch.empty_like(table)
    inv = torch.empty((N,), dtype=torch.int32, device=table.device)
    fn = KERNEL.fn()
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        err = fn(table.data_ptr(), idx.data_ptr(), rows.data_ptr(),
                 inv.data_ptr(), out.data_ptr(), N, B,
                 D * table.element_size(), stream)
    KERNEL.check(err)
    KERNEL.count_launch()
    return out
