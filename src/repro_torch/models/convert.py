"""Weights from the reference package: its parameter dict (nested dicts of
arrays — numpy, or anything ``np.asarray`` reads) becomes the same nested
dict of torch tensors.  Both packages keep the ``(d_in, d_out)`` layout, so
nothing is transposed."""
from __future__ import annotations

from typing import Any

import numpy as np
import torch


def params_from_jax(tree: Any, device) -> Any:
    """Copy every leaf of ``tree`` into a tensor on ``device``, keeping its
    dtype and the nesting of the dicts."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree), device=device)
