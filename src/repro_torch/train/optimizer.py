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
    def init(params):
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
                "count": 0}

    @torch.no_grad()
    def update(grads, state, params):
        grads = tree_map(lambda g: g.to(torch.float32), grads)
        if grad_clip > 0:
            total = 0
            for g in tree_leaves(grads):
                total = total + torch.sum(g * g)
            gnorm = torch.sqrt(total + 1e-12)
            scale = torch.clamp(grad_clip / gnorm, max=1.0)
            grads = tree_map(lambda g: g * scale, grads)
        count = state["count"] + 1
        # the bias corrections in float32, as the reference computes them;
        # host numbers, so the step needs no device sync
        c1 = float(np.float32(1.0) - np.float32(b1) ** np.float32(count))
        c2 = float(np.float32(1.0) - np.float32(b2) ** np.float32(count))
        m = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state["m"], grads)
        v = tree_map(lambda v, g: b2 * v + (1 - b2) * g * g, state["v"],
                     grads)

        def upd(m, v, p):
            step = (m / c1) / (torch.sqrt(v / c2) + eps)
            return -lr * (step + weight_decay * p.to(torch.float32))

        updates = tree_map(upd, m, v, params)
        return updates, {"m": m, "v": v, "count": count}

    @torch.no_grad()
    def step(grads, state, params):
        """``apply_updates(params, update(grads, state, params)[0])`` and
        the new state, bit for bit (the same operations in the same order,
        in place), leaf by leaf: each gradient is scaled in place and
        dropped from ``grads`` once its leaf is done, and m and v are
        updated in place, so ``grads`` and ``state`` are consumed (their
        tensors must not be used again).  Beside the state, the gradients
        and the two parameter trees, two leaves of scratch are alive.
        ``params`` are left as they were."""
        slots = _slots(grads)
        for tree, k in slots:
            tree[k] = tree[k].to(torch.float32)
        if grad_clip > 0:
            total = 0
            for tree, k in slots:
                total = total + torch.sum(tree[k] * tree[k])
            gnorm = torch.sqrt(total + 1e-12)
            scale = torch.clamp(grad_clip / gnorm, max=1.0)
        count = state["count"] + 1
        c1 = float(np.float32(1.0) - np.float32(b1) ** np.float32(count))
        c2 = float(np.float32(1.0) - np.float32(b2) ** np.float32(count))
        new = tree_map(lambda p: None, params)
        for (gt, k), (mt, _), (vt, _), (pt, _), (nt, _) in zip(
                slots, _slots(state["m"]), _slots(state["v"]),
                _slots(params), _slots(new)):
            g, m, v, p = gt.pop(k), mt[k], vt[k], pt[k]
            if grad_clip > 0:
                g.mul_(scale)
            s1, s2 = torch.empty_like(m), torch.empty_like(m)
            m.mul_(b1).add_(torch.mul(g, 1 - b1, out=s1))
            v.mul_(b2).add_(torch.mul(g, 1 - b2, out=s1).mul_(g))
            del g
            torch.div(m, c1, out=s1)
            torch.div(v, c2, out=s2).sqrt_().add_(eps)
            s1.div_(s2)
            s1.add_(torch.mul(p.to(torch.float32), weight_decay, out=s2))
            s1.mul_(-lr)
            nt[k] = torch.add(p.to(torch.float32), s1).to(p.dtype)
            del s1, s2
        return new, {"m": state["m"], "v": state["v"], "count": count}

    return AdamW(init, update, step)


@torch.no_grad()
def apply_updates(params, updates):
    return tree_map(lambda p, u: (p.to(torch.float32) + u).to(p.dtype),
                    params, updates)
