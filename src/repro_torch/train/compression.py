"""Gradient compression: int8 quantized all-reduce with error feedback.

Cuts the data-parallel gradient wire volume 4x (f32 -> int8 payload); the
quantization residual is carried in an error-feedback buffer so SGD/Adam
convergence is preserved (Seide et al. / EF-SGD).  The reference package
writes it as a ``shard_map`` over the ``"data"`` axis; here the positions of
a ``launch.mesh.DataMesh`` run in one process, one after another, each on
its own device, and the collectives become explicit copies to position 0's
device and sums there over the positions' tensors, taken in position order
0..n-1 (on one card the copies are no-ops, and the bits are those of a mesh
whose positions share it).

Every position keeps its **own** error-feedback residual (a list of trees,
one per position, each on its position's device): the reference returns
the new residual under a replicated out-spec without checking it, so each
of its devices keeps the residual it computed, and that is the state its
next step reads.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch

from repro_torch.train.optimizer import tree_leaves, tree_map
from repro_torch.utils import device_context


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x`` as int8 codes and one f32 scale: ``max|x| / 127 + 1e-12``,
    codes ``clip(round(x / scale), -127, 127)`` (round half to even)."""
    scale = x.abs().max() / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def compressed_psum_mean(xs: Sequence[torch.Tensor],
                         efs: Sequence[torch.Tensor]
                         ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Error-feedback int8 all-reduce mean over the positions' tensors.

    ``xs[i]`` and ``efs[i]`` are position ``i``'s value and residual, on
    its device.  Each position adds its residual (``v_i = x_i + ef_i`` in
    f32), one scale is shared by all (``max_i max|v_i| / 127 + 1e-12``,
    taken on position 0's device and copied to every position's, so the
    int8 grids agree), each quantizes ``v_i`` on it and keeps what the
    codes lost as its new residual, on its device.  Returns (the mean of
    the dequantized values, copied to position 0's device and summed there
    in position order, the new residuals)."""
    vs = [x.to(torch.float32) + e for x, e in zip(xs, efs)]
    first = vs[0].device
    scale = torch.stack([v.abs().max().to(first) for v in vs]).max() \
        / 127.0 + 1e-12
    deqs = [torch.clamp(torch.round(v / scale.to(v.device)), -127, 127)
            * scale.to(v.device) for v in vs]
    new_efs = [v - d for v, d in zip(vs, deqs)]
    total = deqs[0]
    for d in deqs[1:]:
        total = total + d.to(first)
    return total / float(len(deqs)), new_efs


def make_compressed_grad_fn(loss_fn: Callable, mesh) -> Callable:
    """A data-parallel gradient function with the int8 error-feedback
    all-reduce.

    ``loss_fn(params, batch)`` is the scalar loss of one position's share
    of the batch.  The returned ``fn(params, batch, efs)`` splits every
    leaf of ``batch`` into ``mesh.size`` equal chunks along dim 0 (the
    reference's ``P("data")``; a dim 0 the mesh does not divide raises
    ``ValueError``), takes each position's loss and gradients on its
    device (chunk and parameters copied there; nothing is copied where
    the device is the parameters') in position order, compresses every
    gradient leaf across the positions, and returns (the mean of the
    positions' losses and the tree of mean gradients, both on position
    0's device, and the positions' new residual trees, each on its
    position's).  ``efs`` holds one residual tree per position
    (``init_error_feedback``)."""
    n = mesh.size

    def fn(params, batch: dict, efs: Sequence[Any]):
        if len(efs) != n:
            raise ValueError(f"{len(efs)} error-feedback trees for a mesh "
                             f"of {n} positions")
        for k, v in batch.items():
            if v.shape[0] % n:
                raise ValueError(f"batch leaf {k!r} of {v.shape[0]} rows "
                                 f"does not split over {n} data positions")
        params = tree_map(lambda p: p.detach().requires_grad_(), params)
        leaves = tree_leaves(params)
        copies = {leaves[0].device: params} if leaves else {}
        first = mesh.device(0)
        losses, grads = [], []
        for i in range(n):
            dev = mesh.device(i)
            if dev not in copies:
                copies[dev] = tree_map(
                    lambda p: p.detach().to(dev).requires_grad_(), params)
            with device_context(dev):
                part = {k: v[i * (v.shape[0] // n):
                             (i + 1) * (v.shape[0] // n)].to(dev)
                        for k, v in batch.items()}
                loss = loss_fn(copies[dev], part)
                grads.append(torch.autograd.grad(loss,
                                                 tree_leaves(copies[dev])))
            losses.append(loss.detach().to(first))
        ef_leaves = [tree_leaves(e) for e in efs]
        means, new_efs = [], [[] for _ in range(n)]
        for j in range(len(leaves)):
            m, ne = compressed_psum_mean([g[j] for g in grads],
                                         [e[j] for e in ef_leaves])
            means.append(m)
            for i in range(n):
                new_efs[i].append(ne[i])
        loss = losses[0]
        for x in losses[1:]:
            loss = loss + x
        return (loss / float(n), _unflatten(params, means),
                [_unflatten(params, e) for e in new_efs])

    return fn


def _unflatten(like, leaves: List[torch.Tensor]):
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def init_error_feedback(params, n_data: int,
                        devices: Optional[Sequence] = None) -> List[Any]:
    """One zero f32 residual tree per data position, on ``devices[i]``
    (default: the parameters' devices)."""
    return [tree_map(lambda p: torch.zeros(
        p.shape, dtype=torch.float32,
        device=p.device if devices is None else devices[i]), params)
            for i in range(n_data)]


def wire_bytes_saved(params) -> dict:
    """Analytic payload of one gradient sync: f32 against int8."""
    total = sum(p.numel() for p in tree_leaves(params))
    return {"f32_bytes": 4 * total, "int8_bytes": total, "ratio": 4.0}
