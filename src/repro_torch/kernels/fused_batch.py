"""Fused device phase of one mini-batch: cached-row gather + miss overlay.

One kernel produces the batch's full unique-vertex feature block from two
sources in a single launch:

  * the device-resident unified feature cache (``table``) for hit rows, and
  * the host-staged miss buffer (``miss_rows``) for rows the cache does not
    hold — the slice the pipeline uploads per batch.

Row selection is driven by two maps:

  ``idx[i]``      cache slot feeding output row ``i`` (< 0: not cached)
  ``miss_inv[i]`` staging row feeding output row ``i`` (< 0: not a miss)

Rows where both maps are negative (shape-bucket padding) come back zero.
On CUDA tensors the wrapper launches the hand-written Hopper kernel
(``csrc/fused_gather_overlay.cu``); on CPU tensors it runs the plain
version in ``kernels/ref.py``.  There is no other fallback.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import CudaKernel

KERNEL = CudaKernel(
    "fused_gather_overlay", "csrc/fused_gather_overlay.cu",
    "fused_gather_overlay",
    [ctypes.c_void_p] * 5 + [ctypes.c_int64] * 4 + [ctypes.c_void_p])


def fused_gather_overlay(table: torch.Tensor, idx: torch.Tensor,
                         miss_rows: torch.Tensor,
                         miss_inv: torch.Tensor) -> torch.Tensor:
    """``out[i] = miss_rows[miss_inv[i]] if miss_inv[i] >= 0 else
    (table[idx[i]] if idx[i] >= 0 else 0)``.

    table: (N, D) with N >= 1; miss_rows: (M, D) with M >= 1 and the same
    dtype (callers pad an empty miss set to one zero row); idx, miss_inv:
    (B,) int32.  All four on one device and contiguous.  A row must not be
    claimed by both maps (hit and miss are disjoint by construction); the
    miss source wins if it ever were.  Returns (B, D).
    """
    if table.dim() != 2 or miss_rows.dim() != 2:
        raise ValueError(f"table and miss_rows must be 2-D, got "
                         f"{tuple(table.shape)} and {tuple(miss_rows.shape)}")
    N, D = table.shape
    if miss_rows.shape[1] != D:
        raise ValueError(f"miss_rows feature dim {miss_rows.shape[1]} != "
                         f"table feature dim {D} (stage at the table's "
                         "padded width)")
    if N < 1 or miss_rows.shape[0] < 1:
        raise ValueError("table and miss_rows need at least one row each "
                         "(pad an empty source with one zero row)")
    if miss_rows.dtype != table.dtype:
        raise TypeError(f"miss_rows dtype {miss_rows.dtype} != table dtype "
                        f"{table.dtype}")
    if idx.dtype != torch.int32 or miss_inv.dtype != torch.int32:
        raise TypeError(f"idx and miss_inv must be int32, got {idx.dtype} "
                        f"and {miss_inv.dtype}")
    if idx.dim() != 1 or idx.shape != miss_inv.shape:
        raise ValueError(f"idx and miss_inv must be matching 1-D maps, got "
                         f"{tuple(idx.shape)} and {tuple(miss_inv.shape)}")
    devices = {t.device for t in (table, idx, miss_rows, miss_inv)}
    if len(devices) != 1:
        raise ValueError(f"all inputs must share one device, got {devices}")
    if table.device.type == "cpu":
        return ref.fused_gather_overlay(table, idx, miss_rows, miss_inv)
    if table.device.type != "cuda":
        raise ValueError(f"unsupported device {table.device}")
    if not all(t.is_contiguous() for t in (table, idx, miss_rows, miss_inv)):
        raise ValueError("fused_gather_overlay needs contiguous inputs")
    B = idx.shape[0]
    out = torch.empty((B, D), dtype=table.dtype, device=table.device)
    fn = KERNEL.fn()
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        err = fn(table.data_ptr(), miss_rows.data_ptr(), idx.data_ptr(),
                 miss_inv.data_ptr(), out.data_ptr(), B, N,
                 miss_rows.shape[0], D * table.element_size(), stream)
    KERNEL.check(err)
    KERNEL.count_launch()
    return out
