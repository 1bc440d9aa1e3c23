"""The port's AdamW against the reference's: from the same numpy parameters
and gradients, one and five steps agree within rtol = 1e-6, atol = 1e-7
(float32 sums taken in another order, and XLA may fuse a multiply-add),
with the global-norm clip on and off; plus the reference optimizer's own
checks (first-step formula, convergence on a quadratic, huge gradients)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train.optimizer import adamw as j_adamw
from repro.train.optimizer import apply_updates as j_apply
from repro_torch.train.optimizer import adamw, apply_updates, tree_leaves

TOL = dict(rtol=1e-6, atol=1e-7)


def _tree(seed: int, scale: float = 1.0) -> dict:
    rng = np.random.default_rng(seed)

    def a(*shape):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return {"head": a(16, 4),
            "layer0": {"b": a(16), "w_neigh": a(8, 16), "w_self": a(8, 16)},
            "layer1": {"b": a(16), "w_neigh": a(16, 16), "w_self": a(16, 16)}}


def _torch(tree):
    return {k: _torch(v) if isinstance(v, dict) else torch.from_numpy(v)
            for k, v in tree.items()}


def _flat_np(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


@pytest.mark.parametrize("steps", [1, 5])
@pytest.mark.parametrize("grad_clip,grad_scale", [(1.0, 1.0), (1.0, 1e-3),
                                                  (0.0, 1.0)])
def test_adamw_matches_reference(steps, grad_clip, grad_scale):
    """grad_scale 1 drives the clip (global norm >> 1); 1e-3 leaves it
    inactive; grad_clip 0 turns it off."""
    kw = dict(lr=1e-2, weight_decay=0.01, grad_clip=grad_clip)
    jopt, topt = j_adamw(**kw), adamw(**kw)
    jp = jax.tree_util.tree_map(jnp.asarray, _tree(0))
    tp = _torch(_tree(0))
    js, ts = jopt.init(jp), topt.init(tp)
    for step in range(steps):
        grads = _tree(100 + step, scale=grad_scale)
        ju, js = jopt.update(jax.tree_util.tree_map(jnp.asarray, grads), js,
                             jp)
        jp = j_apply(jp, ju)
        tu, ts = topt.update(_torch(grads), ts, tp)
        tp = apply_updates(tp, tu)
        for want, got in zip(_flat_np(ju), tree_leaves(tu)):
            np.testing.assert_allclose(got.numpy(), want, **TOL)
    for want, got in zip(_flat_np(jp), tree_leaves(tp)):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    for key in ("m", "v"):
        for want, got in zip(_flat_np(js[key]), tree_leaves(ts[key])):
            np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert ts["count"] == int(js["count"]) == steps


def test_adamw_is_functional():
    opt = adamw(lr=0.1)
    p = {"w": torch.tensor([1.0, -2.0])}
    g = {"w": torch.tensor([0.5, 0.5])}
    st = opt.init(p)
    upd, st2 = opt.update(g, st, p)
    new = apply_updates(p, upd)
    assert torch.equal(p["w"], torch.tensor([1.0, -2.0]))
    assert torch.equal(st["m"]["w"], torch.zeros(2)) and st["count"] == 0
    assert not torch.equal(new["w"], p["w"]) and st2["count"] == 1


def test_adamw_first_step_matches_formula():
    opt = adamw(lr=0.1, weight_decay=0.0, grad_clip=0.0)
    p = {"w": torch.tensor([1.0, -2.0])}
    upd, _ = opt.update({"w": torch.tensor([0.5, 0.5])}, opt.init(p), p)
    # bias-corrected first step = -lr * g/|g| elementwise => -lr * sign(g)
    np.testing.assert_allclose(upd["w"].numpy(),
                               [-0.1 * 0.5 / (0.5 + 1e-8)] * 2, rtol=1e-5)


def test_adamw_converges_quadratic():
    opt = adamw(lr=0.05)
    p = {"w": torch.tensor([5.0, -3.0])}
    st = opt.init(p)
    for _ in range(200):
        upd, st = opt.update({"w": 2 * p["w"]}, st, p)
        p = apply_updates(p, upd)
    assert float((p["w"] ** 2).sum()) < 1e-2


def test_grad_clip_keeps_huge_gradients_finite():
    opt = adamw(lr=0.1, grad_clip=1.0)
    p = {"w": torch.tensor([0.0])}
    upd, _ = opt.update({"w": torch.tensor([1e6])}, opt.init(p), p)
    assert torch.isfinite(upd["w"]).all()


@pytest.mark.parametrize("grad_clip,grad_scale", [(1.0, 1.0), (1.0, 1e-3),
                                                  (0.0, 1.0)])
def test_adamw_step_is_the_functional_update_bit_for_bit(grad_clip,
                                                         grad_scale):
    """``step`` (gradients and state handed over, moments updated in
    place) gives the functional ``update`` + ``apply_updates`` result and
    state bit for bit over 5 steps, leaves the params it was given as they
    were, and consumes the gradients it was given."""
    kw = dict(lr=1e-2, weight_decay=0.01, grad_clip=grad_clip)
    opt = adamw(**kw)
    p_fun = p_don = _torch(_tree(0))
    s_fun, s_don = opt.init(p_fun), opt.init(p_don)
    for step in range(5):
        grads = _tree(100 + step, scale=grad_scale)
        upd, s_fun = opt.update(_torch(grads), s_fun, p_fun)
        p_fun = apply_updates(p_fun, upd)
        before = [t.clone() for t in tree_leaves(p_don)]
        given = _torch(grads)
        new, s_don = opt.step(given, s_don, p_don)
        assert all(torch.equal(a, b)
                   for a, b in zip(before, tree_leaves(p_don)))
        assert tree_leaves(given) == []  # every gradient dropped
        p_don = new
        for a, b in zip(tree_leaves(p_fun), tree_leaves(p_don)):
            assert a.dtype == b.dtype == torch.float32 and torch.equal(a, b)
        for key in ("m", "v"):
            for a, b in zip(tree_leaves(s_fun[key]), tree_leaves(s_don[key])):
                assert torch.equal(a, b), key
        assert s_fun["count"] == s_don["count"] == step + 1
