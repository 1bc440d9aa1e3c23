"""GraphSAGE / GCN of the port against the reference package's, from the
reference's own initial weights (``params_from_jax``): forward logits and
loss agree within rtol = atol = 1e-5 — float32 sums run in another order in
the XLA and PyTorch CPU matrix products, so bitwise equality is not
expected — and the parameter definitions match leaf for leaf."""
import jax
import numpy as np
import pytest
import torch

from repro.models import gnn as jgnn
from repro.models.params import init_from_defs as j_init
from repro_torch.configs import legion_gnn as tconfigs
from repro_torch.models import gnn as tgnn
from repro_torch.models.convert import params_from_jax
from repro_torch.models.params import Def, init_from_defs as t_init

TOL = dict(rtol=1e-5, atol=1e-5)


def _cfgs(model):
    kw = dict(model=model, feat_dim=32, hidden=16, fanouts=(5, 3))
    return jgnn.GNNConfig(**kw), tgnn.GNNConfig(**kw)


def _batch(B=24, D=32, fanouts=(5, 3), seed=0):
    rng = np.random.default_rng(seed)
    b = {"labels": rng.integers(0, 32, B).astype(np.int32)}
    shape = (B,)
    for li in range(len(fanouts) + 1):
        if li:
            shape = shape + (fanouts[li - 1],)
            b[f"mask_{li}"] = rng.random(shape) > 0.25
        b[f"feats_{li}"] = rng.standard_normal(shape + (D,), dtype=np.float32)
    return b


@pytest.mark.parametrize("model", ["sage", "gcn"])
def test_forward_and_loss_match_reference(model):
    cj, ct = _cfgs(model)
    pj = j_init(jgnn.defs(cj), jax.random.PRNGKey(0))
    pt = params_from_jax(jax.tree_util.tree_map(np.asarray, pj), "cpu")
    batch = _batch()
    bj = {k: jax.numpy.asarray(v) for k, v in batch.items()}
    bt = {k: torch.from_numpy(v) for k, v in batch.items()}
    lj = np.asarray(jgnn.forward(cj, pj, bj))
    lt = tgnn.forward(ct, pt, bt)
    assert lt.shape == (24, 32) and lt.dtype == torch.float32
    np.testing.assert_allclose(lt.numpy(), lj, **TOL)
    (loss_j, mj), (loss_t, mt) = jgnn.loss_fn(cj, pj, bj), tgnn.loss_fn(
        ct, pt, bt)
    np.testing.assert_allclose(float(loss_t), float(loss_j), **TOL)
    assert float(mt["acc"]) == float(mj["acc"])


def test_masked_mean_matches_reference():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((6, 4, 8), dtype=np.float32)
    m = rng.random((6, 4)) > 0.5
    m[0] = False  # an all-padding row divides by max(count, 1)
    got = tgnn.masked_mean(torch.from_numpy(x), torch.from_numpy(m))
    want = jgnn.masked_mean(jax.numpy.asarray(x), jax.numpy.asarray(m))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert (got[0] == 0).all()


@pytest.mark.parametrize("model", ["sage", "gcn"])
def test_defs_and_init_match_reference_shapes(model):
    cj, ct = _cfgs(model)
    dj, dt = jgnn.defs(cj), tgnn.defs(ct)
    flat_j = jax.tree_util.tree_leaves_with_path(
        dj, is_leaf=lambda x: hasattr(x, "shape") and hasattr(x, "axes"))
    pt = t_init(dt, torch.Generator().manual_seed(0), "cpu")
    for path, d in flat_j:
        keys = [p.key for p in path]
        t_def, t_val = dt, pt
        for k in keys:
            t_def, t_val = t_def[k], t_val[k]
        assert (t_def.shape, t_def.axes, t_def.init) == (d.shape, d.axes,
                                                         d.init)
        assert tuple(t_val.shape) == d.shape and t_val.dtype == torch.float32
        if d.init == "zeros":
            assert (t_val == 0).all()
    again = t_init(dt, torch.Generator().manual_seed(0), "cpu")
    w, w2 = pt["layer0"], again["layer0"]
    assert all(torch.equal(w[k], w2[k]) for k in w)  # seeded, deterministic
    std = float(pt["layer0"][next(k for k in w if k != "b")].std())
    assert abs(std - 32 ** -0.5) < 0.05  # 1/sqrt(fan_in) scale


def test_def_rejects_mismatched_axes():
    with pytest.raises(ValueError):
        Def((2, 3), ("embed",))


def test_paper_configs_match_reference():
    from repro.configs import legion_gnn as jconfigs

    for name in ("GRAPHSAGE", "GCN", "GRAPHSAGE_SMALL"):
        assert vars(getattr(tconfigs, name)) == vars(getattr(jconfigs, name))
