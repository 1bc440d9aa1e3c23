"""Weights from the reference package: its parameter dict (nested dicts of
arrays — numpy, or anything ``np.asarray`` reads) becomes the same nested
dict of torch tensors.  Both packages keep the ``(d_in, d_out)`` layout, so
nothing is transposed.  ``params_on_mesh`` carries them onto a mesh:
converted, then laid out by ``params.shard_params``."""
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


def params_on_mesh(tree: Any, defs: Any, dist, device) -> Any:
    """``params_from_jax`` onto ``device``, then each leaf laid out on
    ``dist``'s mesh by its ``Def`` (``params.shard_params``)."""
    from repro_torch.models.params import shard_params

    return shard_params(params_from_jax(tree, device), defs, dist)
