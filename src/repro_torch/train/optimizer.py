"""AdamW over a nested dict of parameter tensors, written out as the
reference package's ``train/optimizer.py`` writes it.

The order of operations follows the reference so that the two agree to
float32 rounding: a global-norm gradient clip with ``1e-12`` inside the
square root, the norm summed over leaves in sorted-key order (JAX's tree
order); bias corrections ``1 - b**count``; and the decoupled update
``-lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)`` added to the float32
parameters.  ``torch.optim.AdamW`` and ``clip_grad_norm_`` place eps and the
clip epsilon elsewhere, so they are not used.  ``update`` is functional:
it returns new tensors and mutates nothing it was given.  ``step`` is the
same update and ``apply_updates`` for a caller that hands over its
gradients and state (as a jitted step donates its buffers): bit for bit
the functional result, with one copy of the state alive instead of two
and no tree of scaled gradients or updates.

Over an LM mesh (``dist`` a ``models.sharding.Distribution`` with one) the
leaves are ``Sharded``: the gradients summed over each parameter's
replicated axes and laid out as the moments, which are the parameters'
layout or, with ZeRO-1, that layout with dim 0 also sharded over "data"
(``models.params.zero_pspec``).  Each position runs the same arithmetic on
its blocks; the clip's norm sums each position's squares over the axes a
leaf is sharded on (one ``psum`` per set of axes), then over the leaves in
sorted order, so every position holds the same scale.  Under ZeRO-1 each
data position updates its slice of m and v and makes its slice of the new
parameters from the summed gradient, and the slices are all-gathered over
"data" into the parameters' layout.  On a 1 x 1 mesh this is the meshless
arithmetic, bit for bit.
"""
from __future__ import annotations

from typing import Callable, List, NamedTuple

import numpy as np
import torch


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensors of a nested dict, in sorted-key order (JAX's order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` applied leaf by leaf over nested dicts of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


class AdamW(NamedTuple):
    init: Callable
    update: Callable
    step: Callable = None


def _on_mesh(dist) -> bool:
    return dist is not None and dist.mesh is not None


def _sharded_axes(x) -> tuple:
    """The mesh axes a ``Sharded`` leaf is split over, in the mesh's
    order."""
    used = {a for ax in x.spec for a in ax}
    return tuple(a for a in x.mesh.axis_names if a in used)


def extra_axes(p, m) -> tuple:
    """(dim 0's axes that the moment ``m`` splits beyond the parameter
    ``p``: ZeRO-1's "data", or none)."""
    if not m.spec:
        return ()
    return tuple(a for a in m.spec[0] if a not in p.spec[0])


def param_slice(p, m, dist, i: int):
    """Position ``i``'s block of the parameter ``p`` cut to the moment's
    layout (ZeRO-1: its rows of dim 0 along "data")."""
    t = p.local(i)
    extra = extra_axes(p, m)
    if not extra:
        return t
    n = m.local_shape[0]
    return t.narrow(0, dist.mesh.rank(i, extra) * n, n)


def _gather_new(new, p, m, dist):
    """New parameter blocks made in the moment's layout, all-gathered over
    ZeRO-1's axes into the parameter's layout."""
    extra = extra_axes(p, m)
    if extra:
        new = dist.all_gather(new, 0)
    return new


def _slots(tree) -> list:
    """(dict, key) of every leaf of a nested dict, in sorted-key order."""
    out = []
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            out += _slots(tree[k])
        else:
            out.append((tree, k))
    return out


def adamw(lr: float = 3e-4, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 0.01,
          grad_clip: float = 1.0) -> AdamW:
    def init(params, dist=None, specs=None):
        """Zero m and v like ``params``; on a mesh, per position in the
        layout of ``specs`` (a tree of the reference's spec entries: the
        moments' layout), or the parameters' where it is None."""
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

        if not _on_mesh(dist):
            return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
                    "count": 0}

        def mesh_zeros(p, spec=None):
            spec = p.spec if spec is None else dist.norm(spec)
            spec = spec + ((),) * (len(p.spec) - len(spec))
            shape = list(p.local_shape)
            for d, (have, want) in enumerate(zip(p.spec, spec)):
                shape[d] //= dist.group_size(tuple(a for a in want
                                                   if a not in have))
            return dist.map(lambda t: torch.zeros(shape, dtype=torch.float32,
                                                  device=t.device),
                            p, spec=spec)

        def moments():
            if specs is None:
                return tree_map(mesh_zeros, params)
            return tree_map(mesh_zeros, params, specs)

        return {"m": moments(), "v": moments(), "count": 0}

    def clip_scale(sums):
        """The clip's scale from each leaf's sum of squares, in sorted-key
        order (the norm summed over leaves as the reference sums it)."""
        total = 0
        for sq in sums:
            total = total + sq
        gnorm = torch.sqrt(total + 1e-12)
        return torch.clamp(grad_clip / gnorm, max=1.0)

    def corrections(count):
        # the bias corrections in float32, as the reference computes them;
        # host numbers, so the step needs no device sync
        c1 = float(np.float32(1.0) - np.float32(b1) ** np.float32(count))
        c2 = float(np.float32(1.0) - np.float32(b2) ** np.float32(count))
        return c1, c2

    def mesh_scales(grads, dist) -> dict:
        """{position: the clip's scale}: each leaf's local squares summed
        over the axes it is sharded on (one ``psum`` per set of axes, the
        leaves' sums stacked), then over the leaves in sorted order."""
        from repro_torch.models.sharding import Sharded

        leaves = tree_leaves(grads)
        by_axes = {}
        for n, g in enumerate(leaves):
            by_axes.setdefault(_sharded_axes(g), []).append(n)
        sums = [None] * len(leaves)
        for axes, idx in by_axes.items():
            vec = dist.map(lambda *ts: torch.stack(
                [torch.sum(t * t) for t in ts]), *(leaves[n] for n in idx),
                spec=((),))
            vec = dist.psum(vec, axes)
            for k, n in enumerate(idx):
                sums[n] = Sharded({i: vec.local(i)[k]
                                   for i in dist.mesh.active}, (), dist.mesh)
        return {i: clip_scale([sq.local(i) for sq in sums])
                for i in dist.mesh.active}

    @torch.no_grad()
    def update(grads, state, params, dist=None):
        if _on_mesh(dist):
            return mesh_update(grads, state, params, dist)
        grads = tree_map(lambda g: g.to(torch.float32), grads)
        if grad_clip > 0:
            scale = clip_scale([torch.sum(g * g)
                                for g in tree_leaves(grads)])
            grads = tree_map(lambda g: g * scale, grads)
        return local_update(grads, state, params, state["count"] + 1)

    def local_update(grads, state, params, count):
        c1, c2 = corrections(count)
        m = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state["m"], grads)
        v = tree_map(lambda v, g: b2 * v + (1 - b2) * g * g, state["v"],
                     grads)

        def upd(m, v, p):
            step = (m / c1) / (torch.sqrt(v / c2) + eps)
            return -lr * (step + weight_decay * p.to(torch.float32))

        updates = tree_map(upd, m, v, params)
        return updates, {"m": m, "v": v, "count": count}

    def mesh_update(grads, state, params, dist):
        """``update`` over ``Sharded`` leaves: the updates in the moments'
        layout (``apply_updates(..., dist=)`` applies them)."""
        from repro_torch.models.sharding import Sharded

        grads = tree_map(lambda g: dist.map(lambda t: t.to(torch.float32), g,
                                            spec=g.spec), grads)
        scales = mesh_scales(grads, dist) if grad_clip > 0 else None
        count = state["count"] + 1
        outs = {}
        for i in dist.mesh.active:
            g_i = tree_map(lambda g: g.local(i), grads)
            if grad_clip > 0:
                g_i = tree_map(lambda g: g * scales[i], g_i)
            p_i = tree_map(lambda p, m: param_slice(p, m, dist, i), params,
                           state["m"])
            outs[i] = local_update(
                g_i, {"m": tree_map(lambda m: m.local(i), state["m"]),
                      "v": tree_map(lambda v: v.local(i), state["v"])},
                p_i, count)

        def collect(pick):
            return tree_map(lambda m, *ts: Sharded(
                dict(zip(dist.mesh.active, ts)), m.spec, dist.mesh),
                state["m"], *(pick(outs[i]) for i in dist.mesh.active))

        new = collect(lambda o: o[1]["m"]), collect(lambda o: o[1]["v"])
        return collect(lambda o: o[0]), {"m": new[0], "v": new[1],
                                          "count": count}

    def step_leaf(src: dict, key, m, v, p, scale, c1, c2,
                  own_g: bool = True):
        """One leaf of ``step``: its gradient popped from ``src[key]`` (so
        that it is freed once used), m and v in place, the new parameter
        returned.  ``own_g``: the gradient may be scaled in place (a mesh's
        summed gradient can be one tensor for several positions, so there
        the scaled copy is a new tensor: the same values)."""
        g = src.pop(key)
        if grad_clip > 0:
            g = g.mul_(scale) if own_g else g * scale
        s1, s2 = torch.empty_like(m), torch.empty_like(m)
        m.mul_(b1).add_(torch.mul(g, 1 - b1, out=s1))
        v.mul_(b2).add_(torch.mul(g, 1 - b2, out=s1).mul_(g))
        del g
        torch.div(m, c1, out=s1)
        torch.div(v, c2, out=s2).sqrt_().add_(eps)
        s1.div_(s2)
        s1.add_(torch.mul(p.to(torch.float32), weight_decay, out=s2))
        s1.mul_(-lr)
        return torch.add(p.to(torch.float32), s1).to(p.dtype)

    @torch.no_grad()
    def step(grads, state, params, dist=None):
        """``apply_updates(params, update(grads, state, params)[0])`` and
        the new state, bit for bit (the same operations in the same order,
        in place), leaf by leaf: each gradient is scaled in place and
        dropped from ``grads`` once its leaf is done, and m and v are
        updated in place, so ``grads`` and ``state`` are consumed (their
        tensors must not be used again).  Beside the state, the gradients
        and the two parameter trees, two leaves of scratch are alive.
        ``params`` are left as they were.  Over a mesh the same leaf by
        leaf and position by position (module doc)."""
        slots = _slots(grads)
        if _on_mesh(dist):
            for tree, k in slots:
                g = tree[k]
                tree[k] = dist.map(lambda t: t.to(torch.float32), g,
                                   spec=g.spec)
            scales = mesh_scales(grads, dist) if grad_clip > 0 else {}
        else:
            for tree, k in slots:
                tree[k] = tree[k].to(torch.float32)
            if grad_clip > 0:
                scale = clip_scale([torch.sum(tree[k] * tree[k])
                                    for tree, k in slots])
        count = state["count"] + 1
        c1, c2 = corrections(count)
        new = tree_map(lambda p: None, params)
        for (gt, k), (mt, _), (vt, _), (pt, _), (nt, _) in zip(
                slots, _slots(state["m"]), _slots(state["v"]),
                _slots(params), _slots(new)):
            m, v, p = mt[k], vt[k], pt[k]
            if not _on_mesh(dist):
                nt[k] = step_leaf(gt, k, m, v, p, scale if grad_clip > 0
                                  else None, c1, c2)
                continue
            g = gt.pop(k)
            blocks = {i: step_leaf(g.shards, i, m.local(i), v.local(i),
                                   param_slice(p, m, dist, i),
                                   scales.get(i), c1, c2, own_g=False)
                      for i in dist.mesh.active}
            del g
            nt[k] = _gather_new(dist.map(lambda i: blocks.pop(i), pos=True,
                                         spec=m.spec), p, m, dist)
        return new, {"m": state["m"], "v": state["v"], "count": count}

    return AdamW(init, update, step)


@torch.no_grad()
def apply_updates(params, updates, dist=None):
    """The parameters plus the updates, in the parameters' type; over a
    mesh each position adds its block's updates (in the moments' layout)
    and ZeRO-1's slices are all-gathered into the parameters' layout."""
    if not _on_mesh(dist):
        return tree_map(lambda p, u: (p.to(torch.float32) + u).to(p.dtype),
                        params, updates)

    def leaf(p, u):
        new = dist.map(lambda i, ui: (param_slice(p, u, dist, i).to(
            torch.float32) + ui).to(p.dtype), u, pos=True, spec=u.spec)
        return _gather_new(new, p, u, dist)

    return tree_map(leaf, params, updates)
