"""The sharded executor bound across devices: the routed kernels' peer form
(a clique's shards as separate tensors), the per-position residency, and
``train_gnn(backend="sharded", device=[...])``.

On the CPU, the same numpy inputs go to the port's plain peer versions and
to the reference's dense oracles and ``shard_map`` exchanges (run in a
subprocess on a forced four-device CPU mesh): bit for bit against the dense
oracles everywhere, and against the ``shard_map`` form wherever it defines
the same answer (the two reference forms differ on owners past K_g - 1,
where the exchange serves no row, which the test checks too, and on
negative slots).  The mesh's card checks and its peer-access pairs run
against a simulated four-card host.

``gpu``-marked tests hold the peer kernels to their plain versions with
shards at separate offsets and in a shuffled order; ``multigpu`` tests
(two or more cards) read shards on other cards and train the 2 x 2 mesh on
distinct cards, bitwise the one-card mesh.  The reference is imported inside
the CPU tests only, so the card tests also run on a host without JAX:
``PYTHONPATH=src python -m pytest -q -m "gpu or multigpu"
tests/test_torch_multicard.py``.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.cache_manager import RefreshConfig
from repro_torch.core.cliques import topology_matrix as t_topo
from repro_torch.core.planner import build_plan as t_build_plan
from repro_torch.graph.csr import powerlaw_graph as t_graph
from repro_torch.kernels import gather
from repro_torch.kernels import ref as tref
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models.gnn import GNNConfig
from repro_torch.train.loop import train_gnn

ROOT = Path(__file__).resolve().parents[1]
GRAPH = dict(n=3000, avg_degree=8, seed=9, feat_dim=16)
FANOUTS = (4, 2)
PLAN = dict(mem_per_device=30_000, batch_size=64, seed=0, fanouts=FANOUTS)
CFG = dict(feat_dim=16, hidden=32, batch_size=64, fanouts=FANOUTS, lr=3e-3)
STEPS = 8


def _plan(g):
    return t_build_plan(g, t_topo("dgx-v100", 4), **PLAN)


# ---- the peer plain versions against the reference ----------------------

def _gather_case(name, rng):
    """One clique's shards (k, R, D) and every position's routing (k, n)."""
    k = 4 if name == "gather_bf16" else 2
    R, D, n = 12, 32, 50
    shards = rng.standard_normal((k, R, D), dtype=np.float32)
    owner = rng.integers(-1, k, size=(k, n)).astype(np.int32)
    local = rng.integers(0, R, size=(k, n)).astype(np.int32)
    if name == "gather_misses":
        owner[:] = -1
    elif name == "gather_one_owner":
        owner = np.where(owner >= 0, k - 1, -1).astype(np.int32)
    elif name == "gather_out_of_range":
        owner[:, ::7] = k + 1
        local[:, 1::5] = -3
        local[:, 2::5] = R + 4
    return {"shards": shards, "owner": owner, "local": local,
            "bf16": np.asarray(name == "gather_bf16")}


def _sample_case(name, rng):
    """One clique's CSR shards (degree-0 rows, pad rows) and every
    position's routing and draws (int32: the reference runs without x64)."""
    k = 4 if name == "sample_k4" else 2
    R, n, f = 40, 60, 5
    degs = rng.integers(0, 9, size=(k, R))
    degs[:, ::6] = 0
    E = int(degs.sum(1).max())
    indptr = np.zeros((k, R + 1), np.int64)
    indices = np.zeros((k, E), np.int32)
    for gi in range(k):
        ptr = np.concatenate([[0], np.cumsum(degs[gi])])
        indptr[gi] = ptr
        indptr[gi, len(ptr):] = ptr[-1]
        indices[gi, :ptr[-1]] = rng.integers(0, 3000, size=ptr[-1])
    owner = rng.integers(-1, k, size=(k, n)).astype(np.int32)
    local = rng.integers(0, R, size=(k, n)).astype(np.int32)
    rand = rng.integers(0, 1 << 31, size=(k, n, f)).astype(np.int32)
    rand[:, ::9] = (1 << 31) - 1
    if name == "sample_misses":
        owner[:] = -1
    elif name == "sample_one_owner":
        owner = np.where(owner >= 0, k - 1, -1).astype(np.int32)
    elif name == "sample_out_of_range":
        owner[:, ::7] = k + 2
        local[:, 1::5] = -2
        local[:, 2::5] = R + 3
    return {"indptr": indptr, "indices": indices, "owner": owner,
            "local": local, "rand": rand}


CASES = ("gather_f32", "gather_bf16", "gather_misses", "gather_one_owner",
         "gather_out_of_range", "sample_k2", "sample_k4", "sample_misses",
         "sample_one_owner", "sample_out_of_range")

_REFERENCE = """
import sys
import numpy as np
sys.path.insert(0, sys.argv[1])
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.kernels import ref
from repro.kernels.gather import routed_gather, routed_neighbor_sample
from repro.launch.mesh import make_clique_mesh, shard_map_compat
data = dict(np.load(sys.argv[2]))
out = {}
for name in sorted({k.split(":")[0] for k in data}):
    c = {k.split(":")[1]: v for k, v in data.items()
         if k.startswith(name + ":")}
    spec = (P("clique"),) * (3 if name.startswith("gather") else 5)
    if name.startswith("gather"):
        s = c["shards"]
        if c["bf16"]:
            s = s.astype(jnp.bfloat16)
        args = (jnp.asarray(s), jnp.asarray(c["owner"]),
                jnp.asarray(c["local"]))
        body = lambda s, o, l: routed_gather(s[0], o[0], l[0], "clique",
                                             impl="xla")[None]
        dense = ref.routed_gather_dense(*args)
    else:
        args = tuple(jnp.asarray(c[k]) for k in ("indptr", "indices",
                                                 "owner", "local", "rand"))
        body = lambda p, i, o, l, r: routed_neighbor_sample(
            p[0], i[0], o[0], l[0], r[0], "clique", impl="xla")[None]
        dense = ref.routed_neighbor_sample_dense(*args)
    mesh = make_clique_mesh(args[0].shape[0])
    fn = shard_map_compat(body, mesh, in_specs=spec, out_specs=P("clique"))
    for key, val in (("dense", dense), ("exchange", jax.jit(fn)(*args))):
        val = np.asarray(val)
        out[name + ":" + key] = (val.view(np.uint16)
                                 if val.dtype.itemsize == 2 else val)
np.savez(sys.argv[3], **out)
"""


@pytest.fixture(scope="module")
def reference_outputs(tmp_path_factory):
    """Every case's inputs and the reference's dense oracle and
    ``shard_map`` exchange on them (one subprocess for all cases)."""
    rng = np.random.default_rng(27)
    cases = {name: (_gather_case(name, rng) if name.startswith("gather")
                    else _sample_case(name, rng)) for name in CASES}
    tmp = tmp_path_factory.mktemp("peer")
    np.savez(tmp / "in.npz", **{f"{n}:{k}": v for n, c in cases.items()
                                for k, v in c.items()})
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    out = subprocess.run([sys.executable, "-c", _REFERENCE,
                          str(ROOT / "src"), str(tmp / "in.npz"),
                          str(tmp / "out.npz")], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    return cases, dict(np.load(tmp / "out.npz"))


def _bits(t: torch.Tensor) -> np.ndarray:
    return (t.view(torch.int16).numpy().view(np.uint16)
            if t.dtype == torch.bfloat16 else t.numpy())


@pytest.mark.parametrize("name", CASES)
def test_peer_plain_versions_match_the_reference(reference_outputs, name):
    """Per mesh position: the plain peer version (and the wrapper, which
    runs it on CPU tensors) over separate shard tensors equals the
    reference's dense oracle bit for bit, and its ``shard_map`` exchange
    wherever that serves the row: owners in range with slots >= 0, and
    misses.  Past K_g - 1 the exchange serves no row (zeros, or -1 from
    its +1-shifted psum), and at a negative slot its gather serves none
    and its sampler reads the row counted from the end, where the oracle
    clamps both."""
    cases, want = reference_outputs
    c = cases[name]
    k = c["owner"].shape[0]
    owner, local = c["owner"], c["local"]
    served = (owner < k) & ((owner < 0) | (local >= 0))
    for gi in range(k):
        o, sl = torch.from_numpy(owner[gi]), torch.from_numpy(local[gi])
        if name.startswith("gather"):
            dtype = torch.bfloat16 if c["bf16"] else torch.float32
            shards = [torch.from_numpy(s).to(dtype) for s in c["shards"]]
            got = tref.routed_gather_peer(shards, o, sl)
            wrapped = gather.routed_gather(shards, o, sl)
            empty = 0
        else:
            ip = [torch.from_numpy(p) for p in c["indptr"]]
            ix = [torch.from_numpy(i) for i in c["indices"]]
            r = torch.from_numpy(c["rand"][gi].astype(np.int64))
            got = tref.routed_neighbor_sample_peer(ip, ix, o, sl, r)
            wrapped = gather.routed_neighbor_sample(ip, ix, o, sl, r)
            empty = -1
        assert torch.equal(got, wrapped)
        dense = want[f"{name}:dense"][gi]
        np.testing.assert_array_equal(_bits(got), dense)
        exchange = want[f"{name}:exchange"][gi]
        np.testing.assert_array_equal(_bits(got)[served[gi]],
                                      exchange[served[gi]])
        if name.startswith("gather") and c["bf16"]:
            exchange = exchange.view(np.int16)
        # no row is served past the owners; the gather's negative slots
        # mask the row, the sampler's wrap (JAX indexes from the end)
        unserved = (owner[gi] >= k) | ((~served[gi]) & (empty == 0))
        assert (exchange[unserved] == empty).all()
    if name.endswith("out_of_range"):
        assert (~served).any()


def test_peer_chain_equals_the_dense_chain():
    """The chain's peer form over separate CSR shards equals the dense
    chain over their stack (routing tables with uncached vertices, seeds
    of -1 and past the end, out-of-range owners and slots)."""
    rng = np.random.default_rng(5)
    c = _sample_case("sample_out_of_range", rng)
    k, N = c["indptr"].shape[0], 500
    topo_owner = rng.integers(-1, k + 2, size=N).astype(np.int32)
    topo_local = rng.integers(-3, c["indptr"].shape[1] + 3,
                              size=N).astype(np.int64)
    seeds = rng.integers(-1, N + 10, size=40).astype(np.int64)
    rands, n = [], 40
    for f in (5, 3):
        rands.append(torch.from_numpy(rng.integers(0, 1 << 31, (n, f))))
        n *= f
    ip, ix = torch.from_numpy(c["indptr"]), torch.from_numpy(c["indices"])
    args = (torch.from_numpy(topo_owner), torch.from_numpy(topo_local),
            torch.from_numpy(seeds), rands)
    want_o, want_h = tref.routed_neighbor_sample_chain(ip, ix, *args)
    got_o, got_h = tref.routed_neighbor_sample_chain_peer(
        list(ip.unbind(0)), list(ix.unbind(0)), *args)
    wrap_o, wrap_h = gather.routed_neighbor_sample_chain(
        [t.clone() for t in ip], [t.clone() for t in ix], *args)
    for a, b, w in zip(got_o + got_h, wrap_o + wrap_h, want_o + want_h):
        assert torch.equal(a, w) and torch.equal(b, w)


# ---- the per-position residency ------------------------------------------

def test_sharded_residency_is_one_allocation_per_shard():
    """Every shard of ``sharded_device_arrays`` (features and CSR) has its
    own storage; the routing tables are one copy per distinct device."""
    g = t_graph(**GRAPH)
    cache = _plan(g).caches[0]
    sa = cache.sharded_device_arrays(devices=["cpu", "cpu"])
    assert cache.shard_devices == (torch.device("cpu"),) * 2
    for k in ("feat_shards", "topo_shard_indptr", "topo_shard_indices"):
        ptrs = {t.untyped_storage().data_ptr() for t in sa[k]}
        assert len(sa[k]) == 2 and len(ptrs) == 2, k
    flat = cache.device_arrays()
    for k in ("topo_shard_indptr", "topo_shard_indices"):
        assert flat[k].untyped_storage().data_ptr() not in {
            t.untyped_storage().data_ptr() for t in sa[k]}
    for k in ("slot_owner", "slot_local", "topo_owner", "topo_local"):
        assert sa[k][0] is sa[k][1], k  # one card, one copy
    owner, local = cache.shard_routing()
    for gi, shard in enumerate(sa["feat_shards"]):
        rows = local[owner == gi]
        np.testing.assert_array_equal(
            shard[torch.from_numpy(rows.astype(np.int64))].numpy(),
            cache.feat_cache[owner == gi])
    with pytest.raises(ValueError, match="cache shards live on"):
        cache.sharded_device_arrays(devices=["cpu", "meta"])
    with pytest.raises(ValueError, match="bound to the 2 shards"):
        cache.resolve_shard_devices(["cpu"] * 3)


def test_spec_built_before_a_refresh_finalizes_against_its_epoch():
    """A sharded spec built at epoch 0, finalized after a refresh moved rows
    between the shards, gathers the retained epoch-0 shards: its batch is
    bitwise the reference's device-backend batch of the same draws on an
    unrefreshed plan."""
    from repro.core.cliques import topology_matrix as j_topo
    from repro.core.planner import build_plan as j_build_plan
    from repro.graph.csr import powerlaw_graph as j_graph
    from repro.train.batch import DeviceBatchBuilder as JDevice
    from repro_torch.launch.mesh import make_hierarchical_mesh
    from repro_torch.train.batch import (ShardedBatchBuilder,
                                         pack_sharded_specs)
    from repro_torch.train.loop import position_parts, sharded_position_batch

    gj, gt = j_graph(**GRAPH), t_graph(**GRAPH)
    pj = j_build_plan(gj, j_topo("dgx-v100", 4), **PLAN)
    pt = _plan(gt)
    cliques = pt.partition.cliques
    specs, seeds = [], {}
    for clique in cliques:
        group = []
        for d in clique:
            tab = pt.partition.tablets[d]
            seeds[d] = tab[np.random.default_rng(d).integers(0, len(tab),
                                                             16)]
            b = ShardedBatchBuilder(gt, pt.cache_for_device(d), FANOUTS,
                                    None, d, device="cpu")
            group.append(b.build_spec(seeds[d],
                                      np.random.default_rng(70 + d)))
        specs.append(group)
    packed = pack_sharded_specs(specs, GRAPH["feat_dim"], bucket=64)
    epochs = [int(e) for e in packed.pop("cache_epochs")]
    assert epochs == [0, 0]
    for c in pt.caches:  # the refresh: four rows move from shard 0 to 1
        evict = c.feat_ids[c.feat_owner == 0][:4].copy()
        admit = np.flatnonzero(c.feat_pos < 0)[:4]
        c.begin_epoch()
        c.apply_feature_delta(evict, admit, np.ones(4, np.int32))
    assert [c.epoch for c in pt.caches] == [1, 1]
    shards = [c.sharded_device_arrays(e)["feat_shards"]
              for c, e in zip(pt.caches, epochs)]
    assert all(s is not c.sharded_device_arrays()["feat_shards"]
               for s, c in zip(shards, pt.caches))
    parts = position_parts(packed, make_hierarchical_mesh(
        cliques, devices=["cpu"] * 4))
    for ci, clique in enumerate(cliques):
        for gi, d in enumerate(clique):
            got = sharded_position_batch(shards[ci], parts[ci, gi],
                                         GRAPH["feat_dim"])
            want = JDevice(gj, pj.cache_for_device(d), FANOUTS, None, d,
                           gather="xla").build(
                seeds[d], np.random.default_rng(70 + d))
            assert set(got) == set(want)
            for k in want:
                a, b = got[k].numpy(), np.asarray(want[k])
                if a.dtype.kind == "f":
                    a, b = a.view(np.uint32), b.view(np.uint32)
                np.testing.assert_array_equal(a, b, err_msg=k)


# ---- train_gnn bound per position ---------------------------------------

def test_train_gnn_bound_per_position_is_bitwise_the_one_device_run():
    """``device=`` one entry per position (here all the CPU) gives the
    one-device run's losses, accuracies and traffic bit for bit, refreshes
    included."""
    g = t_graph(**GRAPH)
    cfg = GNNConfig(**CFG)
    kw = dict(steps=STEPS, seed=0, backend="sharded",
              refresh_config=RefreshConfig(interval=4, drift_threshold=1.0))
    one = train_gnn(g, _plan(g), cfg, device="cpu", **kw)
    bound = train_gnn(g, _plan(g), cfg, device=["cpu"] * 4, **kw)
    assert bound.backend == "sharded" and bound.refresh["refreshes"] >= 1
    assert bound.losses == one.losses and bound.accs == one.accs
    np.testing.assert_array_equal(bound.counter.bytes_matrix,
                                  one.counter.bytes_matrix)


@pytest.mark.parametrize("case", ["missing_card", "ragged", "device_backend",
                                  "mixed_types"])
def test_train_gnn_refuses_bindings_it_cannot_run(case):
    g = t_graph(**GRAPH)
    kw = {"backend": "sharded", "device": ["cpu"] * 4}
    if case == "missing_card":
        kw["device"] = ["cpu"] * 3 + [f"cuda:{torch.cuda.device_count()}"]
    elif case == "ragged":
        kw["device"] = ["cpu"] * 3
    elif case == "device_backend":
        kw["backend"] = "device"
    else:
        kw["device"] = ["cpu"] * 3 + ["meta"]
    with pytest.raises((ValueError, RuntimeError)):
        train_gnn(g, _plan(g), GNNConfig(**CFG), steps=1, **kw)


@pytest.fixture
def four_cards(monkeypatch):
    """A simulated host of four CUDA cards: the mesh's checks see them, and
    its peer-access calls are recorded instead of made."""
    access = {"ok": True}
    pairs = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "can_device_access_peer",
                        lambda a, b: access["ok"])
    monkeypatch.setattr(mesh_mod, "enable_peer_access",
                        lambda a, b: pairs.append((a, b)))
    return access, pairs


def test_mesh_enables_peer_access_within_cliques_only(four_cards):
    _, pairs = four_cards
    cards = [f"cuda:{i}" for i in range(4)]
    m = mesh_mod.make_hierarchical_mesh([[0, 1], [2, 3]], devices=cards)
    assert [m.device(ci, gi).index for ci, gi in m.positions()] == [0, 1, 2,
                                                                   3]
    assert sorted(pairs) == [(0, 1), (1, 0), (2, 3), (3, 2)]
    pairs.clear()
    mesh_mod.make_hierarchical_mesh([[0, 1], [2, 3]],
                                    devices=["cuda:0", "cuda:0", "cuda:2",
                                             "cuda:2"])
    assert pairs == []  # positions sharing a card need no access
    data = mesh_mod.make_data_mesh(4, devices=cards)
    assert [d.index for d in data.devices] == [0, 1, 2, 3] and pairs == []


@pytest.mark.parametrize("case", ["no_peer_access", "missing_card"])
def test_mesh_refuses_what_the_host_cannot_run(four_cards, case):
    access, pairs = four_cards
    devices = ["cuda:0", "cuda:1", "cuda:2", "cuda:3"]
    if case == "no_peer_access":
        access["ok"] = False
        match = "cannot access"
    else:
        devices[3] = "cuda:4"
        match = "has 4 CUDA device"
    with pytest.raises(ValueError, match=match):
        mesh_mod.make_hierarchical_mesh([[0, 1], [2, 3]], devices=devices)
    assert pairs == []
    if case == "missing_card":
        with pytest.raises(ValueError, match=match):
            mesh_mod.make_data_mesh(4, devices=devices)


# ---------------- on the card ------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU host)")
    return torch.device("cuda", 0)


@pytest.fixture
def two_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards or more")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _offset_copies(ts, offsets):
    """Each tensor copied into a buffer of its own at ``offsets[i]`` bytes
    (below 16) past a 16-byte boundary, the buffers allocated in reverse
    order."""
    out = [None] * len(ts)
    for i in reversed(range(len(ts))):
        t = ts[i]
        size = t.numel() * t.element_size()
        raw = torch.zeros(size + 16, dtype=torch.uint8, device=t.device)
        out[i] = raw[offsets[i]:offsets[i] + size].view(t.dtype).view(
            t.shape)
        out[i].copy_(t)
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("offsets", [(0, 0, 0, 0), (0, 4, 12, 8)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_peer_kernels_read_separate_shuffled_shards(cuda_device,
                                                         offsets, dtype):
    """Shards in buffers of their own, at 16-byte boundaries (the 16-byte
    row copies) or at separate offsets (rows that only 4-byte copies fit),
    passed in a shuffled order: the routed gather, the per-hop sampler and
    the chain equal their plain versions on the same list, bit for bit."""
    rng = np.random.default_rng(3)
    k, R, D, n = 4, 5000, 128, 20_000
    dev = cuda_device
    order = [2, 0, 3, 1]
    stack = torch.from_numpy(rng.standard_normal((k, R, D),
                                                 dtype=np.float32)).to(dtype)
    shards = _offset_copies([stack[i].to(dev) for i in order], offsets)
    owner = torch.from_numpy(rng.integers(-1, k + 1, n).astype(np.int32)).to(
        dev)
    local = torch.from_numpy(rng.integers(-2, R + 2, n).astype(np.int32)).to(
        dev)
    got = gather.routed_gather(shards, owner, local)
    torch.cuda.synchronize()
    assert torch.equal(got, tref.routed_gather_peer(shards, owner, local))
    degs = rng.integers(0, 20, size=(k, R))
    ip = [torch.from_numpy(np.concatenate([[0], np.cumsum(d)])).to(dev)
          for d in degs]
    E = int(degs.sum(1).max())
    ix = [torch.from_numpy(rng.integers(0, 10 * R, E).astype(np.int32)).to(
        dev) for _ in range(k)]
    ip = _offset_copies([ip[i] for i in order],
                        [o * 2 % 16 for o in offsets])
    ix = _offset_copies([ix[i] for i in order], offsets)
    rand = torch.from_numpy(rng.integers(0, 1 << 31, (n, 10))).to(dev)
    got = gather.routed_neighbor_sample(ip, ix, owner, local, rand)
    torch.cuda.synchronize()
    assert torch.equal(got, tref.routed_neighbor_sample_peer(ip, ix, owner,
                                                             local, rand))
    N = 10 * R
    topo_owner = torch.from_numpy(rng.integers(-1, k, N).astype(np.int32)).to(
        dev)
    topo_local = torch.from_numpy(rng.integers(0, R, N)).to(dev)
    seeds = torch.from_numpy(rng.integers(-1, N, 2000)).to(dev)
    rands = [torch.from_numpy(rng.integers(0, 1 << 31, (2000, 25))).to(dev),
             torch.from_numpy(rng.integers(0, 1 << 31, (50_000, 10))).to(dev)]
    args = (ip, ix, topo_owner, topo_local, seeds, rands)
    outs, hits = gather.routed_neighbor_sample_chain(*args)
    want_o, want_h = tref.routed_neighbor_sample_chain_peer(*args)
    torch.cuda.synchronize()
    for a, b in zip(outs + hits, want_o + want_h):
        assert torch.equal(a, b)


@pytest.mark.multigpu
def test_multigpu_peer_kernels_read_shards_on_other_cards(two_cards):
    """The routing on card 0, the shards spread over every card: the kernels
    read the peers' shards over NVLink and equal the plain versions."""
    rng = np.random.default_rng(4)
    cards = two_cards
    k, R, D, n = len(cards), 20_000, 128, 50_000
    shards = [torch.from_numpy(rng.standard_normal((R, D), dtype=np.float32))
              .to(c) for c in cards]
    mesh_mod.make_hierarchical_mesh([list(range(k))], devices=cards)
    owner = torch.from_numpy(rng.integers(-1, k, n).astype(np.int32)).to(
        cards[0])
    local = torch.from_numpy(rng.integers(0, R, n).astype(np.int32)).to(
        cards[0])
    got = gather.routed_gather(shards, owner, local)
    torch.cuda.synchronize()
    assert got.device == cards[0]
    assert torch.equal(got, tref.routed_gather_peer(shards, owner, local))
    degs = rng.integers(0, 20, size=(k, R))
    ip = [torch.from_numpy(np.concatenate([[0], np.cumsum(d)])).to(c)
          for d, c in zip(degs, cards)]
    E = int(degs.sum(1).max())
    ix = [torch.from_numpy(rng.integers(0, 1 << 20, E).astype(np.int32)).to(
        c) for c in cards]
    rand = torch.from_numpy(rng.integers(0, 1 << 31, (n, 10))).to(cards[0])
    got = gather.routed_neighbor_sample(ip, ix, owner, local, rand)
    torch.cuda.synchronize()
    assert torch.equal(got, tref.routed_neighbor_sample_peer(ip, ix, owner,
                                                             local, rand))


@pytest.mark.multigpu
def test_multigpu_mesh_on_distinct_cards_is_bitwise_the_one_card_mesh(
        two_cards):
    """The 2 x 2 mesh with each clique's positions on distinct cards trains
    to the one-card mesh's losses, accuracies and traffic bit for bit."""
    g = t_graph(**GRAPH)
    cfg = GNNConfig(**CFG)
    kw = dict(steps=STEPS, seed=0, backend="sharded",
              refresh_config=RefreshConfig(interval=4, drift_threshold=1.0))
    cards = two_cards
    binding = ([cards[i] for i in range(4)] if len(cards) >= 4
               else [cards[0], cards[1], cards[0], cards[1]])
    one = train_gnn(g, _plan(g), cfg, device=cards[0], **kw)
    spread = train_gnn(g, _plan(g), cfg, device=binding, **kw)
    assert spread.losses == one.losses and spread.accs == one.accs
    np.testing.assert_array_equal(spread.counter.bytes_matrix,
                                  one.counter.bytes_matrix)
