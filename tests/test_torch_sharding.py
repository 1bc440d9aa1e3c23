"""The port's LM sharding rules against the reference's
(``src/repro/models/sharding.py``, ``params.resolve_spec``,
``launch/specs.shape_rules``).

Both packages read a mesh through its axis names and sizes only, so the
reference runs here on ``jax.sharding.AbstractMesh`` (no devices) and the
port on ``launch.mesh`` meshes bound to ``meta``: the 2 x 2 debug mesh and
the 16 x 16 and 2 x 16 x 16 production meshes.  For every parameter
``Def`` of the seven ``transformer`` archs the specs are equal, and each
position's parameter bytes (``params.shard_params`` on ``meta``) are the
reference's per-device shard bytes (``NamedSharding.shard_shape``).
"""
import math

import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding

from repro.configs import get_config as jget_config
from repro.configs.base import SHAPES as JSHAPES
from repro.launch import specs as jspecs
from repro.models import get_module as jget_module
from repro.models import params as jparams
from repro.models import sharding as jsharding
from repro_torch.configs import get_config
from repro_torch.configs.base import SHAPES
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import specs
from repro_torch.models import get_module, params, sharding

TRANSFORMER_ARCHS = ("phi3.5-moe-42b-a6.6b", "dbrx-132b", "stablelm-3b",
                     "minitron-4b", "gemma3-1b", "qwen2.5-14b",
                     "chameleon-34b")
MESHES = {
    "debug": ((2, 2), ("data", "model")),
    "pod": ((16, 16), ("data", "model")),
    "multi_pod": ((2, 16, 16), ("pod", "data", "model")),
}
LOGICAL = ("batch", "batch_full", "seq", "kv_seq", "kv_seq_wide", "embed",
           "heads", "kv_heads", "ff", "vocab", "experts", "ssm_inner",
           "ssm_heads", "ssm_state", "layers", "nope")


def _meshes(name):
    shape, axes = MESHES[name]
    if name == "debug":
        port = tmesh.make_debug_mesh(shape, axes, devices="meta")
    else:
        port = tmesh.make_production_mesh(multi_pod=name == "multi_pod")
    return AbstractMesh(shape, axes), port


def _entries(spec) -> tuple:
    """A ``PartitionSpec``'s entries, trailing Nones dropped (the
    reference's specs are as long as the axes they were given)."""
    out = list(spec)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], prefix + (k,))
    else:
        yield prefix, tree


@pytest.mark.parametrize("name", sorted(MESHES))
def test_rules_and_queries_match_the_reference(name):
    """``default_rules``, ``axis_size``, ``mesh_axes``, ``nshards`` and
    ``spec`` (with and without a shape) for every logical axis; a port
    mesh's shape and groups follow the reference mesh's row-major order."""
    jm, tm = _meshes(name)
    assert sharding.default_rules(tm) == jsharding.default_rules(jm)
    assert sharding.default_rules(None) == jsharding.default_rules(None)
    tdist, jdist = sharding.Distribution(tm), jsharding.Distribution(jm)
    assert tm.shape == dict(jm.shape)
    for ax in LOGICAL:
        assert tdist.axis_size(ax) == jdist.axis_size(ax), ax
        assert tdist.mesh_axes(ax) == jdist.mesh_axes(ax), ax
        for dim in (1, 2, 6, 16, 32, 48, 256, 512, 262144):
            assert tdist.nshards(ax, dim) == jdist.nshards(ax, dim), (ax, dim)
    combos = [("batch", "seq", "embed"), ("batch", None, "vocab"),
              ("batch", "kv_seq", None, None), ("batch_full", None, None),
              ("batch", "seq", "heads"), ("layers", "batch", "kv_seq_wide"),
              ("experts", "embed", "ff"), ("heads", "kv_heads")]
    for axes in combos:
        assert tdist.spec(*axes) == tuple(jdist.spec(*axes)), axes
        for shape in ((32, 4096, 1152), (1, 1, 100352), (128, 32768, 8),
                      (2, 6, 16), (4, 24, 64)):
            shape = shape + (16,) * (len(axes) - len(shape))
            shape = shape[:len(axes)]
            want = jdist.spec(*axes, shape=shape)
            assert _entries(tdist.spec(*axes, shape=shape)) == \
                _entries(want), (axes, shape)
    assert tm.coords(1)[tm.axis_names[-1]] == 1  # the last axis is fastest
    assert all(tm.index(tm.coords(i)) == i for i in tm.positions())
    assert tm.group(0, tm.axis_names) == list(range(tm.size))


@pytest.mark.parametrize("name", sorted(MESHES))
@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("arch", ["gemma3-1b", "dbrx-132b"])
def test_shape_rules_match_the_reference(arch, shape, name):
    """The long-context rule: a decode over more than 100,000 positions
    spreads ``kv_seq`` over every data and model axis."""
    jm, tm = _meshes(name)
    assert specs.shape_rules(get_config(arch), SHAPES[shape], tm) == \
        jspecs.shape_rules(jget_config(arch), JSHAPES[shape], jm)
    assert specs.shape_rules(get_config(arch), SHAPES[shape], None) == {}


@pytest.mark.parametrize("name", sorted(MESHES))
@pytest.mark.parametrize("arch", TRANSFORMER_ARCHS)
def test_param_specs_and_position_bytes_match_the_reference(arch, name):
    """``resolve_spec`` of every parameter ``Def`` (and the decode_32k and
    long_500k caches'), and each position's bytes of every leaf after
    ``shard_params``, against the reference's per-device shard bytes."""
    jm, tm = _meshes(name)
    cfg, jcfg = get_config(arch), jget_config(arch)
    tdefs = dict(_flat(get_module(cfg).defs(cfg)))
    jdefs = dict(_flat(jget_module(jcfg).defs(jcfg)))
    assert tdefs.keys() == jdefs.keys()
    rules = sharding.default_rules(tm)
    jrules = jsharding.default_rules(jm)
    tspecs = dict(_flat(params.pspecs_from_defs(get_module(cfg).defs(cfg),
                                                rules, tm)))
    for key, d in jdefs.items():
        want = jparams.resolve_spec(d, jrules, jm)
        assert params.resolve_spec(tdefs[key], rules, tm) == tuple(want), key
        assert tspecs[key] == tuple(want), key
    # each position's bytes, as the port lays them out (one position on
    # meta stands for the others: every block has one shape)
    dist = sharding.Distribution(tm.run_only(0))
    meta = params.specs_from_defs(get_module(cfg).defs(cfg))
    sharded = dict(_flat(params.shard_params(meta, get_module(cfg).defs(cfg),
                                             dist)))
    total = 0
    for key, d in jdefs.items():
        want = NamedSharding(jm, jparams.resolve_spec(d, jrules, jm)
                             ).shard_shape(d.shape)
        got = sharded[key].local(0)
        assert tuple(got.shape) == tuple(want), key
        total += math.prod(want) * 4
    assert sum(t.local(0).numel() * 4 for t in sharded.values()) == total
    # the serving caches: bf16 (L, B, S, Hkv, Dh) over (batch, kv_seq)
    for shape in ("decode_32k", "long_500k"):
        s = SHAPES[shape]
        td = get_module(cfg).cache_defs(cfg, s.global_batch, s.seq_len)
        jd = jget_module(jcfg).cache_defs(jcfg, s.global_batch, s.seq_len)
        r = specs.shape_rules(cfg, s, tm)
        jr = jspecs.shape_rules(jcfg, JSHAPES[shape], jm)
        for k in ("k", "v"):
            want = jparams.resolve_spec(jd[k], jr, jm)
            assert params.resolve_spec(td[k], r, tm) == tuple(want)


def test_meshes_bind_and_refuse_as_documented():
    """The debug mesh binds ``cuda:0`` unless told otherwise (so it raises
    on a host without a card), takes one device for all or one per
    position, and refuses a wrong count, mixed device types and a position
    standing for the others off ``meta``; the production meshes have the
    reference's shapes."""
    m = tmesh.make_debug_mesh(devices=["cpu"] * 4)
    assert m.devices == (torch.device("cpu"),) * 4
    assert tmesh.make_debug_mesh(devices="cpu") == m
    assert m.device_grid == ((torch.device("cpu"),) * 2,) * 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tmesh.make_debug_mesh()
    with pytest.raises(ValueError, match="need exactly 4"):
        tmesh.make_debug_mesh(devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="mix device types"):
        tmesh.make_debug_mesh(devices=["cpu", "meta", "cpu", "cpu"])
    with pytest.raises(ValueError, match="meta device"):
        m.run_only(0)
    pod = tmesh.make_production_mesh()
    assert pod.shape == {"data": 16, "model": 16} and pod.size == 256
    multi = tmesh.make_production_mesh(multi_pod=True)
    assert multi.shape == {"pod": 2, "data": 16, "model": 16}
    assert multi.run_only(3).active == (3,)
    assert multi.group(0, ("pod",)) == [0, 256]
    assert multi.rank(256 + 17, ("pod", "data", "model")) == 256 + 17
    assert np.array_equal(
        [multi.rank(i, ("model",)) for i in range(20)],
        [i % 16 for i in range(20)])


@pytest.mark.parametrize("start,target,kinds", [
    ((("data",), ("model",)), (("data",), ()), ["all-gather"]),
    ((("data",), ()), (("data",), ("model",)), []),
    ((("data",), ("model",)), (("data", "model"), ()), ["all-to-all"]),
    ((("data",), ("model",)), ((), ()), ["all-gather", "all-gather"]),
    ((("data",), ()), ((), ("data",)), ["all-to-all"]),
    (((), ("data", "model")), (("model",), ("data",)), ["all-to-all"]),
    ((("data", "model"), ()), (("data",), ("model",)), ["all-to-all"]),
    ((("model",), ("data",)), ((), ("data", "model")), ["all-to-all"]),
    ((("data", "model"), ()), (("model",), ("data",)), ["all-gather"]),
])
def test_reshard_keeps_the_value_and_logs_its_collectives(start, target,
                                                          kinds):
    """``Distribution.reshard`` (what ``constrain`` runs): a dim made whole
    is all-gathered (one call over all its axes), a dim newly split is cut
    locally, the minor axis of one dim moving to another (as its minor
    axis there) is one all_to_all (the ``batch_full`` attention's way back
    to (batch, seq)); the global value never changes, and only those
    collectives are logged."""
    dist = sharding.Distribution(tmesh.make_debug_mesh(devices="cpu"))
    full = torch.arange(8 * 12, dtype=torch.float32).reshape(8, 12)
    x = dist.shard(full, start)
    assert torch.equal(dist.full(x), full)
    y = dist.reshard(x, target)
    assert y.spec == target
    assert torch.equal(dist.full(y), full)
    assert [c[0] for c in dist.log.calls] == kinds
