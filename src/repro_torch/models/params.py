"""Parameter definitions: models declare their parameters once as a nested
dict of :class:`Def` leaves (shape + logical axes + init rule).
``init_from_defs`` materializes them as tensors; ``specs_from_defs`` gives
their shapes and types as ``meta`` tensors (the dry-run's arguments);
``resolve_spec`` / ``pspecs_from_defs`` translate the logical axes into
mesh axes through a rules dict (the reference's ``PartitionSpec`` entries,
non-divisible dims falling back to replication), ``zero_pspec`` adds the
reference's ZeRO rule (dim 0 also over "data"), and ``shard_params``
lays full parameters out on a mesh by them (``unshard`` undoes it)."""
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


def resolve_spec(d: Def, rules: dict, mesh) -> tuple:
    """Logical axes -> the reference's ``PartitionSpec`` entries (None, an
    axis name, or a tuple of names per dim), dropping mesh axes that do
    not divide the dim or that an earlier dim already uses.  ``mesh`` is a
    ``launch.mesh.LMMesh`` (anything with a ``shape`` dict of axis sizes)
    or None."""
    parts = []
    used = set()
    for dim, ax in zip(d.shape, d.axes):
        mesh_axes = rules.get(ax) if ax is not None else None
        if mesh_axes is None:
            parts.append(None)
            continue
        if isinstance(mesh_axes, str):
            mesh_axes = (mesh_axes,)
        keep = []
        size = 1
        for m in mesh_axes:
            if m in used or (mesh is not None and m not in mesh.shape):
                continue
            msize = mesh.shape[m] if mesh is not None else 1
            if dim % (size * msize) == 0:
                keep.append(m)
                size *= msize
        used.update(keep)
        if not keep:
            parts.append(None)
        elif len(keep) == 1:
            parts.append(keep[0])
        else:
            parts.append(tuple(keep))
    return tuple(parts)


def pspecs_from_defs(defs: Any, rules: dict, mesh) -> Any:
    """The tree of ``resolve_spec`` entries."""
    if isinstance(defs, Def):
        return resolve_spec(defs, rules, mesh)
    return {k: pspecs_from_defs(defs[k], rules, mesh) for k in sorted(defs)}


def zero_pspec(spec: tuple, shape: tuple, mesh) -> tuple:
    """The reference's ZeRO rule (``_fsdp`` for ZeRO-3's parameters,
    ``_moment`` for ZeRO-1's moments, ``src/repro/launch/specs.py``): dim 0
    also sharded over "data" where it is unsharded, "data" shards no other
    dim, and dim 0 divides by the "data" axis' size."""
    spec = list(spec) + [None] * (len(shape) - len(spec))
    used = {a for e in spec if e
            for a in ((e,) if isinstance(e, str) else e)}
    dsize = mesh.shape.get("data", 1)
    if (spec and spec[0] is None and "data" not in used and shape
            and shape[0] % dsize == 0):
        spec[0] = "data"
    return tuple(spec)


def layout_pspecs(defs: Any, dist, zero: bool = False) -> Any:
    """The tree of a model's parameter specs on ``dist``'s mesh
    (``pspecs_from_defs``), with ``zero_pspec`` applied where ``zero``
    (ZeRO-3's parameters; ZeRO-1's moments from the parameters')."""
    if isinstance(defs, Def):
        spec = resolve_spec(defs, dist.rules, dist.mesh)
        return zero_pspec(spec, defs.shape, dist.mesh) if zero else spec
    return {k: layout_pspecs(defs[k], dist, zero) for k in sorted(defs)}


def shard_params(params: Any, defs: Any, dist, specs: Any = None) -> Any:
    """Full parameters laid out on ``dist``'s mesh as ``resolve_spec``
    gives, or as the tree ``specs`` gives (``models.sharding.Sharded``
    leaves): each position holds its block, on its device, so its bytes
    are the reference's per-device shard.  A block on the device its
    parameter lives on is a view of it (one card holds the tree once,
    whatever the number of positions); on another device it is a copy; on
    ``meta`` an empty tensor of its own."""
    if isinstance(defs, Def):
        if specs is None:
            specs = resolve_spec(defs, dist.rules, dist.mesh)
        return dist.shard(params, specs)
    return {k: shard_params(params[k], defs[k], dist,
                            None if specs is None else specs[k])
            for k in sorted(defs)}


def unshard(params: Any, dist, device=None) -> Any:
    """The full parameters a sharded tree stands for (for the tests)."""
    if isinstance(params, dict):
        return {k: unshard(v, dist, device) for k, v in params.items()}
    return dist.full(params, device)
