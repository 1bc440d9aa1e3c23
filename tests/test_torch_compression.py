"""int8 error-feedback gradient compression of the port against the
reference's ``train/compression.py``, and ``train_gnn(mesh=,
compress_grads=)`` against the reference's compressed data parallelism.

``quantize_int8`` and ``compressed_psum_mean`` take identical numpy inputs
in both packages: the codes, the scale and every position's new residual
are bitwise equal, the mean within rtol 1e-6 (the reference's ``psum`` may
sum in another order).  The reference runs its ``make_compressed_grad_fn``
and a 12-step compressed ``train_gnn`` under ``shard_map`` on a forced
four-device CPU mesh, in a subprocess; the port runs the same four
positions one after another.  With a loss whose gradients are exact in
both packages, every position's residual is bitwise the reference's device
shard over 3 steps, which holds the port to one residual per position.
Training from the reference's initial parameters: losses within rtol 1e-4
(float sums in another order, compounded over 12 steps), the accuracy 0.0,
as the reference reports it, and the traffic tallies equal.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.gnn import GNNConfig as JConfig
from repro.models.gnn import defs as j_defs
from repro.models.params import init_from_defs as j_init
from repro.train import compression as jc
from repro_torch.core.cliques import topology_matrix as t_topo
from repro_torch.core.planner import build_plan as t_build_plan
from repro_torch.graph.csr import powerlaw_graph as t_graph
from repro_torch.launch.mesh import DataMesh, make_data_mesh
from repro_torch.models.convert import params_from_jax
from repro_torch.models.gnn import GNNConfig
from repro_torch.train import compression as tc
from repro_torch.train.loop import train_gnn
from repro_torch.train.resilience import (FaultPlan, FaultSpec,
                                          ResilienceConfig)

ROOT = Path(__file__).resolve().parents[1]
N_DATA = 4
STEPS = 12
GRAPH = dict(n=4000, avg_degree=8, seed=4, feat_dim=32)
CFG = dict(feat_dim=32, hidden=32, batch_size=64, fanouts=[4, 2], lr=3e-3)
PLAN = dict(mem_per_device=100_000, batch_size=64, seed=0, fanouts=[4, 2])
TOL = dict(rtol=1e-4, atol=1e-5)
TALLIES = ("pcie_transactions", "feature_requests", "feature_hits",
           "topo_requests", "topo_hits", "host_sample_syncs",
           "host_sampled_edges")
EF_STEPS = 3
EF_SHAPES = {"w": (300,), "b": (3, 7)}


def _cpu_mesh(n: int = N_DATA) -> DataMesh:
    return make_data_mesh(n, devices=["cpu"] * n)


def _ef_batches():
    """The exact-gradient loss's batches: one row per position, scaled up
    by 10 each step, so the shared scale and the residuals move."""
    rng = np.random.default_rng(5)
    return [{k: (rng.standard_normal((N_DATA,) + s).astype(np.float32)
                 * 10.0 ** step) for k, s in EF_SHAPES.items()}
            for step in range(EF_STEPS)]


def _ef_params():
    rng = np.random.default_rng(6)
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in EF_SHAPES.items()}


_REFERENCE = """
import json, sys
import numpy as np
sys.path.insert(0, sys.argv[1])
import jax, jax.numpy as jnp
from repro.core.cliques import topology_matrix
from repro.core.planner import build_plan
from repro.graph.csr import powerlaw_graph
from repro.models.gnn import GNNConfig
from repro.train.compression import (init_error_feedback,
                                     make_compressed_grad_fn)
from repro.train.loop import train_gnn
cfg = json.loads(sys.argv[2])
out = {}
from jax.sharding import AxisType
mesh = jax.make_mesh((cfg["n_data"],), ("data",),
                     axis_types=(AxisType.Auto,))

# the exact-gradient loss: each position's gradient is its own batch row
def loss(p, b):
    return sum((p[k] * b[k][0]).sum() for k in sorted(p))
fn = make_compressed_grad_fn(loss, mesh)
params = {k: jnp.asarray(v, jnp.float32) for k, v in cfg["ef_params"].items()}
ef = init_error_feedback(params)
steps = []
for batch in cfg["ef_batches"]:
    l, g, ef = fn(params, {k: jnp.asarray(v, jnp.float32)
                           for k, v in batch.items()}, ef)
    steps.append({
        "loss": float(l), "mean": {k: np.asarray(v).tolist()
                                   for k, v in g.items()},
        "ef": {k: [np.asarray(s.data).tolist() for s in sorted(
            v.addressable_shards, key=lambda s: s.device.id)]
               for k, v in ef.items()}})
out["ef_steps"] = steps

for backend in ("host", "device"):
    g = powerlaw_graph(**cfg["graph"])
    plan = build_plan(g, topology_matrix("nv2", 2), **cfg["plan"])
    res = train_gnn(g, plan, GNNConfig(**cfg["model"]), steps=cfg["steps"],
                    seed=0, backend=backend, mesh=mesh, compress_grads=True)
    c = res.counter
    out[backend] = {"losses": res.losses, "accs": [float(a) for a in
                                                   res.accs],
                    "tallies": {k: int(getattr(c, k)) for k in
                                cfg["tallies"]},
                    "bytes": c.bytes_matrix.tolist()}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference():
    """The reference's compressed runs on a forced four-device CPU mesh (a
    subprocess), and its GNN initial parameters as port tensors."""
    cfg = {"n_data": N_DATA, "graph": GRAPH, "plan": PLAN, "model": CFG,
           "steps": STEPS, "tallies": TALLIES,
           "ef_params": {k: v.tolist() for k, v in _ef_params().items()},
           "ef_batches": [{k: v.tolist() for k, v in b.items()}
                          for b in _ef_batches()]}
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={N_DATA}")
    out = subprocess.run([sys.executable, "-c", _REFERENCE,
                          str(ROOT / "src"), json.dumps(cfg)], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout + out.stderr
    runs = json.loads(out.stdout.strip().splitlines()[-1])
    p0 = j_init(j_defs(JConfig(**CFG)), jax.random.PRNGKey(0))
    return runs, params_from_jax(jax.tree_util.tree_map(np.asarray, p0),
                                 "cpu")


def _port_train(params, backend, **kw):
    g = t_graph(**GRAPH)
    plan = t_build_plan(g, t_topo("nv2", 2), **PLAN)
    return train_gnn(g, plan, GNNConfig(**CFG), steps=STEPS, seed=0,
                     backend=backend, device="cpu", params=params, **kw)


@pytest.fixture(scope="module")
def port(reference):
    return {b: _port_train(reference[1], b, mesh=_cpu_mesh(),
                           compress_grads=True)
            for b in ("host", "device")}


# ---- the arithmetic, on identical inputs -------------------------------

@pytest.mark.parametrize("shape", [(256,), (37, 5), (4, 64, 33), (1,)])
def test_quantize_int8_is_bitwise_the_references(shape):
    rng = np.random.default_rng(len(shape))
    x = rng.standard_normal(shape).astype(np.float32) * 3.7
    q, scale = tc.quantize_int8(torch.from_numpy(x))
    jq, jscale = jc.quantize_int8(jnp.asarray(x))
    assert q.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert scale.item() == float(jscale)
    err = np.abs(q.numpy().astype(np.float32) * scale.item() - x)
    assert err.max() <= scale.item() * 0.5 + 1e-6


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("shape", [(256,), (37, 5), (4, 64, 33)])
def test_compressed_psum_mean_is_the_references(shape, n):
    """The reference's collective body under ``vmap`` with a named axis
    (its ``pmax``/``psum`` over the positions), run op by op as its
    ``shard_map`` runs eagerly: the per-position residuals bitwise, the
    codes (recovered from the dequantized values) bitwise, the mean within
    rtol 1e-6."""
    rng = np.random.default_rng(n)
    xs = (rng.standard_normal((n,) + shape) * rng.uniform(0.01, 10)
          ).astype(np.float32)
    efs = (rng.standard_normal((n,) + shape) * 0.01).astype(np.float32)
    mean, new_efs = tc.compressed_psum_mean(
        [torch.from_numpy(x) for x in xs], [torch.from_numpy(e) for e in efs])
    jmean, jefs = jax.vmap(lambda x, e: jc.compressed_psum_mean(x, e, "d"),
                           axis_name="d")(jnp.asarray(xs), jnp.asarray(efs))
    np.testing.assert_array_equal(np.stack([e.numpy() for e in new_efs]),
                                  np.asarray(jefs))
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean)[0], rtol=1e-6,
                               atol=0)
    v = xs + efs
    scale = np.float32(np.abs(v).max()) / np.float32(127.0) \
        + np.float32(1e-12)
    codes = np.clip(np.round(v / scale), -127, 127)
    np.testing.assert_array_equal(v - codes * scale,
                                  np.stack([e.numpy() for e in new_efs]))


def test_error_feedback_is_kept_per_position_over_three_steps(reference):
    """The reference's ``make_compressed_grad_fn`` on four devices and the
    port's on four positions of one device, fed a loss whose gradient is
    exact in both: each position's residual is bitwise the reference's
    device shard at every step, and so is the mean.  Position 0's residual
    differs from the others' (a shared residual would be wrong)."""
    runs, _ = reference
    params = {k: torch.from_numpy(v) for k, v in _ef_params().items()}
    fn = tc.make_compressed_grad_fn(
        lambda p, b: sum((p[k] * b[k][0]).sum() for k in sorted(p)),
        _cpu_mesh())
    efs = tc.init_error_feedback(params, N_DATA)
    for batch, want in zip(_ef_batches(), runs["ef_steps"]):
        loss, grads, efs = fn(params, {k: torch.from_numpy(v)
                                       for k, v in batch.items()}, efs)
        assert len(efs) == N_DATA
        for k in EF_SHAPES:
            np.testing.assert_array_equal(
                np.stack([e[k].numpy() for e in efs]),
                np.asarray(want["ef"][k], np.float32), err_msg=k)
            np.testing.assert_array_equal(
                grads[k].numpy(), np.asarray(want["mean"][k], np.float32))
        np.testing.assert_allclose(loss.item(), want["loss"], rtol=1e-5)
    assert not torch.equal(efs[0]["w"], efs[1]["w"])


def test_batch_that_does_not_split_over_the_mesh_raises():
    fn = tc.make_compressed_grad_fn(lambda p, b: (p["w"] * b["x"]).sum(),
                                    _cpu_mesh(3))
    params = {"w": torch.ones(4)}
    with pytest.raises(ValueError, match="10 rows"):
        fn(params, {"x": torch.ones(10, 4)}, tc.init_error_feedback(params, 3))
    with pytest.raises(ValueError, match="2 error-feedback trees"):
        fn(params, {"x": torch.ones(9, 4)}, tc.init_error_feedback(params, 2))


def test_wire_bytes_saved_is_the_references():
    p0 = j_init(j_defs(JConfig(**CFG)), jax.random.PRNGKey(0))
    mine = tc.wire_bytes_saved(params_from_jax(
        jax.tree_util.tree_map(np.asarray, p0), "cpu"))
    assert mine == jc.wire_bytes_saved(p0)
    assert tc.wire_bytes_saved({"w": torch.zeros(100, 10)}) == {
        "f32_bytes": 4000, "int8_bytes": 1000, "ratio": 4.0}


def test_init_error_feedback_is_one_zero_tree_per_position():
    params = {"a": torch.ones(3, 2), "b": {"c": torch.ones(5)}}
    efs = tc.init_error_feedback(params, 3)
    assert len(efs) == 3 and efs[0] is not efs[1]
    for e in efs:
        assert e["a"].dtype == torch.float32 and not e["a"].any()
        assert e["b"]["c"].shape == (5,)


# ---- train_gnn(mesh=, compress_grads=) -----------------------------------

@pytest.mark.parametrize("backend", ["host", "device"])
def test_compressed_training_matches_reference(reference, port, backend):
    want, got = reference[0][backend], port[backend]
    assert got.steps == STEPS and got.backend == backend
    np.testing.assert_allclose(got.losses, want["losses"], **TOL)
    assert got.accs == want["accs"] == [0.0] * STEPS
    for name in TALLIES:
        assert getattr(got.counter, name) == want["tallies"][name], name
    np.testing.assert_array_equal(got.counter.bytes_matrix,
                                  np.asarray(want["bytes"]))
    assert np.isfinite(got.losses).all()
    assert got.losses[-1] < got.losses[0] + 0.1


def test_compressed_host_and_device_backends_are_bitwise_equal(port):
    assert port["host"].losses == port["device"].losses


def test_compressed_step0_loss_is_the_plain_runs(reference, port):
    """Same parameters at step 0, and the mean of equal-size chunk means is
    the batch mean: step 0's loss agrees with the plain run's; later steps
    differ (compressed gradients)."""
    plain = _port_train(reference[1], "device")
    np.testing.assert_allclose(port["device"].losses[0], plain.losses[0],
                               rtol=0, atol=1e-5)
    assert port["device"].losses != plain.losses
    assert plain.counter.feature_hits == port["device"].counter.feature_hits


@pytest.mark.parametrize("kw", [{"mesh": "mesh"}, {"compress_grads": True}])
def test_mesh_or_compression_alone_runs_the_plain_step(reference, kw):
    kw = {k: (_cpu_mesh() if v == "mesh" else v) for k, v in kw.items()}
    plain = _port_train(reference[1], "device")
    alone = _port_train(reference[1], "device", **kw)
    assert alone.losses == plain.losses and alone.accs == plain.accs
    assert any(a > 0 for a in alone.accs)


def _small():
    g = t_graph(2000, 6, seed=1, feat_dim=16)
    plan = t_build_plan(g, t_topo("nv2", 2), mem_per_device=200_000,
                        batch_size=32, seed=0)
    return g, plan, GNNConfig(feat_dim=16, hidden=16, batch_size=32,
                              fanouts=(4, 3))


@pytest.mark.parametrize("kw, match", [
    ({"backend": "sharded", "mesh": "mesh"}, "does not compose"),
    ({"backend": "sharded", "compress_grads": True}, "does not compose"),
    ({"mesh": "mesh", "resilience": "loss"}, "explicit mesh="),
    ({"mesh": "mesh3", "compress_grads": True}, "batch_size 32 .* 3 "),
    ({"mesh": "meta", "compress_grads": True}, "positions live on"),
])
def test_invalid_mesh_options_raise_value_error(kw, match):
    g, plan, cfg = _small()
    vals = {"mesh": _cpu_mesh(), "mesh3": _cpu_mesh(3),
            "meta": DataMesh((torch.device("meta"),) * 4),
            "loss": ResilienceConfig(fault_plan=FaultPlan(
                [FaultSpec("device_loss", step=1, dev=1)]))}
    kw = {k: vals.get(v, v) if isinstance(v, str) and k != "backend" else v
          for k, v in kw.items()}
    with pytest.raises(ValueError, match=match):
        train_gnn(g, plan, cfg, steps=2, device="cpu", **kw)


def test_data_mesh_binds_every_position_to_one_device():
    mesh = _cpu_mesh(4)
    assert mesh.shape == (4,) and mesh.size == 4
    assert mesh.axis_names == ("data",)
    assert {mesh.device(i) for i in range(4)} == {torch.device("cpu")}
    with pytest.raises(ValueError, match="3 devices pinned for 4"):
        make_data_mesh(4, devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="at least one"):
        make_data_mesh(0, devices=[])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_data_mesh(2)  # the default binds the card
