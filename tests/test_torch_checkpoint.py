"""The port's checkpoint layer (``repro_torch.train.checkpoint``): each test
of the reference's ``tests/test_checkpoint.py`` run on torch trees, then the
two packages against each other on the same GNN ``(params, opt_state)``: a
file either one writes validates and restores in the other bit for bit,
their manifests are equal leaf for leaf (AdamW's ``count`` an ``int32`` of
shape ``[]`` in both), and a runtime payload the reference wrote unpickles
in a process that has imported neither ``repro`` nor ``jax``."""
import os
import subprocess
import sys
import tempfile
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.cliques import topology_matrix as j_topo
from repro.core.feature_store import TieredStoreConfig as JStoreConfig
from repro.core.planner import build_plan as j_build_plan
from repro.graph.csr import powerlaw_graph as j_graph
from repro.models.gnn import GNNConfig as JConfig
from repro.models.gnn import defs as j_defs
from repro.models.params import init_from_defs as j_init
from repro.train import checkpoint as jck
from repro.train.loop import train_gnn as j_train
from repro.train.optimizer import adamw as j_adamw
from repro_torch.models.convert import params_from_jax
from repro_torch.train.checkpoint import (AsyncCheckpointer, CheckpointError,
                                          _flatten, latest_checkpoint,
                                          latest_resumable_checkpoint,
                                          load_manifest, restore_checkpoint,
                                          save_checkpoint,
                                          validate_checkpoint)
from repro_torch.train.optimizer import adamw
from repro_torch.train.resilience import (FaultPlan, FaultSpec,
                                          InjectedCheckpointError)

CFG = dict(feat_dim=16, hidden=16, batch_size=64, fanouts=(4, 2))


def _tree():
    return {"a": torch.arange(12.0).reshape(3, 4),
            "b": {"c": torch.ones(5, dtype=torch.int32)}}


def test_roundtrip():
    t = _tree()
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, 7, t)
        path = latest_checkpoint(d)
        step, out = restore_checkpoint(path, t)
        assert step == 7
        assert torch.equal(out["a"], t["a"])
        assert torch.equal(out["b"]["c"], t["b"]["c"])
        assert out["b"]["c"].dtype == torch.int32


def test_latest_picks_max_step():
    t = _tree()
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, 1, t)
        save_checkpoint(d, 12, t)
        assert latest_checkpoint(d).endswith("ckpt_00000012.npz")


def test_async_checkpointer():
    t = _tree()
    with tempfile.TemporaryDirectory() as d:
        ck = AsyncCheckpointer(d, keep=2)
        for s in (1, 2, 3):
            ck.save(s, t)
            time.sleep(0.05)
        ck.close()
        assert latest_checkpoint(d) is not None


# ---- manifest + validation ---------------------------------------------


def test_manifest_records_leaves_in_index_order():
    t = _tree()
    with tempfile.TemporaryDirectory() as d:
        path = save_checkpoint(d, 3, t)
        m = load_manifest(path)
        assert m["n_leaves"] == 2 and m["step"] == 3
        assert m["leaves"][0] == {"dtype": "float32", "shape": [3, 4]}
        assert m["leaves"][1] == {"dtype": "int32", "shape": [5]}
        assert validate_checkpoint(path, like=t) == m


def test_validate_rejects_torn_file():
    t = _tree()
    with tempfile.TemporaryDirectory() as d:
        path = save_checkpoint(d, 5, t)
        size = os.path.getsize(path)
        with open(path, "r+b") as f:
            f.truncate(size // 2)  # a crash mid-copy / torn write
        with pytest.raises(CheckpointError, match="unreadable"):
            validate_checkpoint(path)


def test_validate_rejects_mismatched_template():
    t = _tree()
    with tempfile.TemporaryDirectory() as d:
        path = save_checkpoint(d, 5, t)
        wrong_shape = {"a": torch.zeros((2, 2)), "b": {"c": t["b"]["c"]}}
        with pytest.raises(CheckpointError, match="leaf 0"):
            validate_checkpoint(path, like=wrong_shape)
        wrong_count = {"a": t["a"]}
        with pytest.raises(CheckpointError, match="leaves"):
            validate_checkpoint(path, like=wrong_count)
        with pytest.raises(CheckpointError, match="leaf 0"):
            restore_checkpoint(path, wrong_shape)
        # a dtype drift is caught by the numpy name, not torch's str()
        wrong_dtype = {"a": t["a"].double(), "b": {"c": t["b"]["c"]}}
        with pytest.raises(CheckpointError, match="float32.*float64"):
            validate_checkpoint(path, like=wrong_dtype)


def test_latest_resumable_skips_torn_newest():
    """Resume must pick the newest checkpoint that actually loads — not
    the newest filename (which may be a torn write from the crash that
    triggered the resume)."""
    t = _tree()
    with tempfile.TemporaryDirectory() as d:
        good = save_checkpoint(d, 10, t)
        bad = save_checkpoint(d, 20, t)
        with open(bad, "r+b") as f:
            f.truncate(os.path.getsize(bad) // 3)
        assert latest_checkpoint(d) == bad        # filename order lies
        assert latest_resumable_checkpoint(d, like=t) == good
        # garbage that is not even a zip is skipped the same way
        with open(os.path.join(d, "ckpt_00000030.npz"), "wb") as f:
            f.write(b"not a checkpoint")
        assert latest_resumable_checkpoint(d, like=t) == good


def test_save_failure_leaves_no_partial_file():
    """A crash between the tmp write and the publish must leave neither a
    torn ckpt_* nor a stale tmp behind."""
    t = _tree()

    def boom(tmp_path):
        assert os.path.exists(tmp_path)
        raise OSError("disk gone")

    with tempfile.TemporaryDirectory() as d:
        with pytest.raises(OSError, match="disk gone"):
            save_checkpoint(d, 4, t, fault_hook=boom)
        assert os.listdir(d) == []


def test_runtime_payload_roundtrip():
    t = _tree()
    runtime = {"rng": {0: {"state": 123}}, "devices": [0, 1],
               "arr": np.arange(5)}
    with tempfile.TemporaryDirectory() as d:
        path = save_checkpoint(d, 9, t, runtime=runtime)
        step, out, rt = restore_checkpoint(path, t, with_runtime=True)
        assert step == 9 and rt["devices"] == [0, 1]
        assert rt["rng"][0]["state"] == 123
        np.testing.assert_array_equal(rt["arr"], runtime["arr"])
        # without a runtime payload the 3-tuple form returns None
        p2 = save_checkpoint(d, 10, t)
        assert restore_checkpoint(p2, t, with_runtime=True)[2] is None


# ---- async writer failure paths ----------------------------------------


def test_async_retries_transient_write_failure():
    t = _tree()
    fp = FaultPlan([FaultSpec("checkpoint_write", at_call=0)])
    with tempfile.TemporaryDirectory() as d:
        ck = AsyncCheckpointer(d, retries=1, fault_plan=fp)
        ck.save(1, t)
        ck.close()  # must NOT raise: the retry succeeded
        assert latest_checkpoint(d).endswith("ckpt_00000001.npz")
        s = ck.summary()
        assert s["saves"] == 1 and s["write_errors"] == 1
        assert s["retries_used"] == 1


def test_async_exhausted_failure_reraises_on_close():
    t = _tree()
    fp = FaultPlan([FaultSpec("checkpoint_write", at_call=0, times=5)])
    with tempfile.TemporaryDirectory() as d:
        ck = AsyncCheckpointer(d, retries=1, fault_plan=fp)
        ck.save(1, t)
        with pytest.raises(InjectedCheckpointError):
            ck.close()
        assert latest_checkpoint(d) is None  # nothing half-written
        assert ck.summary()["write_errors"] == 2  # attempt + retry


# ---- what only the port has: torch leaves ------------------------------


def test_bf16_leaf_raises_naming_it_and_save_copies():
    """numpy holds no bfloat16: such a leaf raises, named, and is never
    cast.  ``AsyncCheckpointer.save`` copies the tree on the caller's
    thread, so a later in-place change does not reach the file."""
    t = {"w": torch.ones(3, dtype=torch.bfloat16), "x": torch.zeros(2)}
    with tempfile.TemporaryDirectory() as d:
        with pytest.raises(CheckpointError, match=r"\['w'\].*bfloat16"):
            save_checkpoint(d, 1, t)
        with pytest.raises(CheckpointError, match=r"\['w'\].*bfloat16"):
            AsyncCheckpointer(d).save(1, t)
        path = save_checkpoint(d, 2, {"x": t["x"]})
        with pytest.raises(CheckpointError, match="bfloat16"):
            validate_checkpoint(path, like={"x": t["x"].bfloat16()})
        x = torch.zeros(4)
        ck = AsyncCheckpointer(d)
        ck.save(3, {"x": x})
        x.add_(1)
        ck.close()
        assert torch.equal(restore_checkpoint(latest_checkpoint(d),
                                              {"x": x})[1]["x"],
                           torch.zeros(4))


# ---- the two packages on the same GNN (params, opt_state) --------------


@pytest.fixture(scope="module")
def trees():
    """The reference's GNN parameters and AdamW state after one update
    (count 1, moments non-zero) and the port's copy of both."""
    cfg = JConfig(**CFG)
    p0 = j_init(j_defs(cfg), jax.random.PRNGKey(0))
    opt = j_adamw(cfg.lr)
    state = opt.init(p0)
    grads = jax.tree_util.tree_map(lambda x: jnp.full_like(x, 0.5), p0)
    _, state = opt.update(grads, state, p0)
    ref = (p0, state)
    host = jax.tree_util.tree_map(np.asarray, ref)
    port_params = params_from_jax(host[0], "cpu")
    port_state = {"m": params_from_jax(host[1]["m"], "cpu"),
                  "v": params_from_jax(host[1]["v"], "cpu"),
                  "count": int(host[1]["count"])}
    template = (port_params, adamw(cfg.lr).init(port_params))
    return ref, (port_params, port_state), template


def _port_leaves(tree):
    return [x for _, x in _flatten(tree)]


def test_reference_file_restores_in_the_port(trees, tmp_path):
    """(i) the reference's file validates against the port's template and
    restores bit for bit; AdamW's count comes back as an int."""
    ref, _, template = trees
    path = jck.save_checkpoint(str(tmp_path), 5, ref)
    assert validate_checkpoint(path, like=template)["n_leaves"] \
        == len(jax.tree_util.tree_leaves(ref))
    step, (params, state) = restore_checkpoint(path, template)
    assert step == 5 and state["count"] == 1
    assert isinstance(state["count"], int)
    want = jax.tree_util.tree_leaves(ref)
    got = _port_leaves((params, state))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        if isinstance(a, torch.Tensor):
            assert a.numpy().dtype == np.asarray(b).dtype


def test_port_file_restores_in_the_reference(trees, tmp_path):
    """(ii) a file the port writes restores in the reference's
    ``restore_checkpoint`` bit for bit."""
    ref, port, _ = trees
    path = save_checkpoint(str(tmp_path), 6, port)
    step, out = jck.restore_checkpoint(path, ref)
    assert step == 6
    for a, b in zip(jax.tree_util.tree_leaves(out),
                    jax.tree_util.tree_leaves(ref)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_manifests_are_equal_leaf_for_leaf(trees, tmp_path):
    """(iii) the same tree written by both packages: equal manifests, dtype
    names and shapes included; the count is int32 of shape []."""
    ref, port, _ = trees
    mj = jck.load_manifest(jck.save_checkpoint(str(tmp_path / "j"), 2, ref))
    mt = load_manifest(save_checkpoint(str(tmp_path / "t"), 2, port))
    assert mt == mj
    i = [p for p, _ in _flatten(port)].index("[1]['count']")
    assert i == len(jax.tree_util.tree_leaves(ref[0]))  # opt_state's first
    assert mt["leaves"][i] == {"dtype": "int32", "shape": []}


_UNPICKLE = """
import pickle, sys
import numpy as np
class Block:
    def find_spec(self, name, path=None, target=None):
        if name in ("jax", "repro") or name.startswith(("jax.", "repro.")):
            raise ImportError(f"blocked: {name}")
sys.meta_path.insert(0, Block())
with np.load(sys.argv[1]) as data:
    rt = pickle.loads(bytes(data["__runtime"]))
bad = sorted(n for n in sys.modules if n in ("jax", "repro")
             or n.startswith(("jax.", "repro.")))
assert not bad, bad
print(sorted(rt), sorted(rt["rng"]), sorted(rt["manager"]),
      sorted(rt["store"]))
"""


def test_reference_runtime_payload_unpickles_without_reference(tmp_path):
    """(iv) the runtime payload of a real reference run (RNG states, the
    manager's and the store's state dicts) is plain dicts and numpy: it
    unpickles where neither ``repro`` nor ``jax`` can be imported."""
    g = j_graph(3000, 8, seed=11, feat_dim=16)
    plan = j_build_plan(g, j_topo("nv2", 2), mem_per_device=300_000,
                        batch_size=128, seed=0, fanouts=(4, 2))
    j_train(g, plan, JConfig(**CFG), steps=3, seed=2, refresh_interval=4,
            feature_store=JStoreConfig(host_rows=400, async_fills=False,
                                       lookahead=2),
            prefetch_workers=1, checkpoint_dir=str(tmp_path))
    path = jck.latest_checkpoint(str(tmp_path))
    out = subprocess.run([sys.executable, "-c", _UNPICKLE, path],
                         cwd=tmp_path, capture_output=True, text=True,
                         timeout=300, env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("] [")[0] == \
        "['devices', 'manager', 'rng', 'store', 'version'"
