"""Small shared utilities: logging, deterministic hashing, device checks."""
from __future__ import annotations

import contextlib
import logging

import numpy as np
import torch

logger = logging.getLogger("repro_torch")
if not logger.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter("[%(asctime)s %(levelname)s] %(message)s", "%H:%M:%S"))
    logger.addHandler(_h)
    logger.setLevel(logging.INFO)


def human_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024.0:
            return f"{n:.2f}{unit}"
        n /= 1024.0
    return f"{n:.2f}PiB"


def stable_hash_u32(x: np.ndarray, salt: int = 0) -> np.ndarray:
    """Deterministic per-element uint32 hash (splitmix-style); used for
    synthetic feature/label generation without materializing huge tables."""
    with np.errstate(over="ignore"):
        z = (x.astype(np.uint64)
             + np.uint64((0x9E3779B97F4A7C15 * (salt + 1)) & 0xFFFFFFFFFFFFFFFF))
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        z = z ^ (z >> np.uint64(31))
    return (z & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device`` with an explicit index.  A CUDA
    device without a usable card raises: the port never falls back to the
    CPU on its own; callers ask for ``"cpu"`` explicitly.  ``"meta"``
    (shapes and types, no storage) is the dry-run's accounting device."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but CUDA is not "
                               "available; pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type not in ("cpu", "meta"):
        raise ValueError(f"unsupported device {device!r} (expected cuda, cpu "
                         "or meta)")
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for the work queued on ``device`` (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_context(device: torch.device):
    """The CUDA current-device context for ``device`` on the calling thread
    (the current device is per host thread), or a no-op on the CPU."""
    return (torch.cuda.device(device) if device.type == "cuda"
            else contextlib.nullcontext())
