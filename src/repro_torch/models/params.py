"""Parameter definitions: models declare their parameters once as a nested
dict of :class:`Def` leaves (shape + logical axes + init rule).
``init_from_defs`` materializes them as tensors; ``specs_from_defs`` gives
their shapes and types as ``meta`` tensors (the dry-run's arguments)."""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch


@dataclasses.dataclass(frozen=True)
class Def:
    """A single parameter definition."""

    shape: tuple
    axes: tuple  # logical axis name (or None) per dim; len == len(shape)
    init: str = "normal"  # normal | zeros | ones
    scale: Optional[float] = None  # stddev override; default 1/sqrt(fan_in)
    fan_in_dims: tuple = (-2,)  # dims whose product is fan-in for default scale
    dtype: Optional[torch.dtype] = None  # overrides the tree-level default

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} "
                             "differ in length")


def _std(d: Def) -> float:
    if d.scale is not None:
        return d.scale
    fan_in = 1
    for dim in d.fan_in_dims:
        fan_in *= d.shape[dim]
    return 1.0 / math.sqrt(max(fan_in, 1))


def init_from_defs(defs: Any, generator: torch.Generator, device,
                   param_dtype: torch.dtype = torch.float32) -> Any:
    """Materialize real parameter tensors on ``device``.

    Leaves are drawn in sorted-key order from ``generator``, on the
    generator's own device.  A CPU generator gives values that do not
    depend on ``device``; a CUDA generator draws on the card (tens of GB of
    weights in seconds), and the values then are that generator's, not a
    CPU generator's of the same seed.  The draws are torch's, not
    ``jax.random``'s: to start from the reference package's weights,
    convert them with ``models.convert.params_from_jax``."""
    if isinstance(defs, Def):
        dt = defs.dtype or param_dtype
        if defs.init == "zeros":
            return torch.zeros(defs.shape, dtype=dt, device=device)
        if defs.init == "ones":
            return torch.ones(defs.shape, dtype=dt, device=device)
        w = torch.randn(defs.shape, generator=generator, dtype=torch.float32,
                        device=generator.device)
        return w.mul_(_std(defs)).to(dtype=dt, device=device)
    return {k: init_from_defs(defs[k], generator, device, param_dtype)
            for k in sorted(defs)}


def specs_from_defs(defs: Any, dtype: torch.dtype = torch.float32) -> Any:
    """The same tree of ``meta``-device tensors: each ``Def``'s shape, in its
    own dtype or ``dtype``.  Allocates nothing and draws nothing (the
    reference's ``specs_from_defs`` without a mesh)."""
    if isinstance(defs, Def):
        return torch.empty(defs.shape, dtype=defs.dtype or dtype,
                           device="meta")
    return {k: specs_from_defs(defs[k], dtype) for k in sorted(defs)}
