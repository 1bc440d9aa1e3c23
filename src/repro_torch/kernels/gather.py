"""Unified-cache row gather: ``out[...] = table[idx[...]]``, zeros where the
index is negative (cache misses).

The unfused finalize chain gathers a batch's cached rows with it
(``DeviceBatchBuilder(fused=False)``), and the sharded executor's per-shard
gather will.  On CUDA tensors the wrapper launches the hand-written Hopper
kernel (``csrc/gather_rows.cu``); on CPU tensors it runs the plain version
in ``kernels/ref.py``.  There is no other fallback.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import CudaKernel

KERNEL = CudaKernel(
    "gather_rows", "csrc/gather_rows.cu", "gather_rows",
    [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 3 + [ctypes.c_void_p])


def gather_rows(table: torch.Tensor, idx: torch.Tensor, *,
                return_mask: bool = False):
    """``out[...] = table[idx[...]]`` (zeros where ``idx < 0``; indices at
    or past the end read the last row, as XLA clamps them).

    table: (N, D) with N >= 1, any element type (f32, bf16, int32 ...);
    idx: int32 of any shape B..., on the table's device.  Returns
    ``B... + (D,)``; with ``return_mask=True`` also ``idx >= 0`` (the hit
    mask the batch pipeline overlays host-fetched miss rows with).
    """
    if table.dim() != 2 or table.shape[0] < 1:
        raise ValueError(f"table must be 2-D with at least one row, got "
                         f"{tuple(table.shape)}")
    if idx.dtype != torch.int32:
        raise TypeError(f"idx must be int32, got {idx.dtype}")
    if idx.device != table.device:
        raise ValueError(f"table and idx must share one device, got "
                         f"{table.device} and {idx.device}")
    if table.device.type == "cpu":
        out = ref.gather_rows(table, idx)
    elif table.device.type != "cuda":
        raise ValueError(f"unsupported device {table.device}")
    else:
        if not (table.is_contiguous() and idx.is_contiguous()):
            raise ValueError("gather_rows needs contiguous inputs")
        N, D = table.shape
        out = torch.empty(tuple(idx.shape) + (D,), dtype=table.dtype,
                          device=table.device)
        fn = KERNEL.fn()
        with torch.cuda.device(table.device):
            stream = torch.cuda.current_stream(table.device).cuda_stream
            err = fn(table.data_ptr(), idx.data_ptr(), out.data_ptr(),
                     idx.numel(), N, D * table.element_size(), stream)
        KERNEL.check(err)
        KERNEL.launches += 1
    if return_mask:
        return out, idx >= 0
    return out
