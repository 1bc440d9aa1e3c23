"""The routed sampling chain (``kernels.gather.routed_neighbor_sample_chain``):
its plain version equals the per-hop composition through
``CliqueCache.device_sample_cached`` bit for bit on every edge case, the
CPU wrapper and ``CliqueCache.device_sample_chain`` return views of one
packed buffer that ``graph.sampling`` reads back in one copy, the wrapper
rejects what the kernel does not take, and on the card (``gpu``-marked,
skips without one) the kernel equals its plain version in one launch.

No test here imports the reference package, so the ``gpu`` tests also run
on a GPU host without JAX:
``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_sample_chain.py``."""
import numpy as np
import pytest
import torch

from repro_torch.core.unified_cache import CliqueCache
from repro_torch.graph import sampling
from repro_torch.graph.csr import CSRGraph, powerlaw_graph
from repro_torch.kernels import gather
from repro_torch.kernels import ref as tref

K = 4


def _graph():
    """A power-law graph in which every 11th vertex has lost its adjacency
    (degree-0 rows in the topology cache)."""
    g = powerlaw_graph(2000, 8, seed=3, feat_dim=16)
    deg = g.degrees()
    deg[::11] = 0
    keep = np.repeat(deg > 0, g.degrees())
    indptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int64)
    return CSRGraph(indptr, g.indices[keep], g.n, g.feat_dim, seed=3)


@pytest.fixture(scope="module")
def graph():
    return _graph()


def _cache(g, empty=False, device="cpu"):
    """A sharded topology cache over K devices holding the hottest half of
    the vertices by degree (the degree-0 every-11th vertices among the
    cached ones added back), or nothing."""
    order = np.argsort(-g.degrees(), kind="stable")
    ids = np.union1d(order[: g.n // 2], np.arange(0, g.n, 11)[:40])
    topo = ([np.zeros(0, np.int64)] * K if empty
            else np.array_split(ids.astype(np.int64), K))
    feat = [np.arange(d * 4, d * 4 + 4) for d in range(K)]
    c = CliqueCache(g, list(range(K)), feat, topo, topology_mode="sharded")
    c.device_arrays(device=device)
    return c


def _draws(rng, n, fanouts, near=False):
    rands = []
    for f in fanouts:
        r = rng.integers(0, 1 << 31, size=(n, f))
        if near:
            r[::2] = (1 << 31) - 1 - np.arange(f)
        rands.append(r)
        n *= f
    return rands


# name -> (fanouts, which seeds, draws near 2^31, empty topology cache)
CASES = {
    "1_hop": ((5,), "mixed", False, False),
    "2_hops": ((5, 3), "mixed", False, False),
    "3_hops": ((3, 2, 2), "mixed", False, False),
    "seeds_of_-1": ((4, 3), "minus_one", False, False),
    "uncached_seeds": ((4, 3), "uncached", False, False),
    "degree_0_rows": ((4, 3), "degree_0", False, False),
    "all_misses": ((4, 3), "all_misses", False, False),
    "empty_topology_cache": ((4, 3), "mixed", False, True),
    "draws_near_2^31": ((5, 3), "mixed", True, False),
}


def _seeds(g, cache, kind, rng, n=60):
    cached = np.flatnonzero(cache.topo_pos >= 0)
    uncached = np.flatnonzero(cache.topo_pos < 0)
    if kind == "uncached":
        return np.concatenate([rng.choice(uncached, n // 2),
                               rng.choice(cached, n // 2)])
    if kind == "all_misses":
        return rng.choice(uncached, n)
    if kind == "degree_0":
        zero = cached[g.degrees()[cached] == 0]
        assert len(zero), "the cache must hold degree-0 vertices"
        return np.concatenate([rng.choice(zero, n // 2),
                               rng.choice(cached, n // 2)])
    seeds = rng.integers(0, g.n, n)
    if kind == "minus_one":
        seeds[::3] = -1
    return seeds


def _per_hop(cache, seeds, fanouts, rands):
    """The per-hop composition the chain replaces: ``device_sample_cached``
    hop after hop, each fed the previous hop's flattened output."""
    outs, hits, frontier = [], [], seeds
    for f, r in zip(fanouts, rands):
        out, hit = cache.device_sample_cached(frontier, f, rand=r)
        outs.append(out)
        hits.append(hit)
        frontier = out.reshape(-1)
    return outs, hits


def _routing(cache):
    """The flat residency's routing and stacked CSR shards (the dense
    oracle's arguments)."""
    da = cache.device_arrays()
    return (da["topo_shard_indptr"], da["topo_shard_indices"],
            da["topo_owner"], da["topo_local"])


def _peer(args):
    """Dense-oracle chain arguments in the wrapper's form: each stacked
    CSR's rows as separate tensors (one allocation per shard)."""
    return ([t.clone() for t in args[0].unbind(0)],
            [t.clone() for t in args[1].unbind(0)], *args[2:])


@pytest.mark.parametrize("case", list(CASES))
def test_plain_chain_equals_the_per_hop_composition(graph, case):
    fanouts, kind, near, empty = CASES[case]
    cache = _cache(graph, empty=empty)
    rng = np.random.default_rng(sorted(CASES).index(case))
    seeds = _seeds(graph, cache, kind, rng)
    rands = _draws(rng, len(seeds), fanouts, near)
    want_o, want_h = _per_hop(cache, seeds, fanouts, rands)
    args = (*_routing(cache), torch.from_numpy(seeds),
            [torch.from_numpy(r) for r in rands])
    got_o, got_h = tref.routed_neighbor_sample_chain(*args)
    peer_o, peer_h = tref.routed_neighbor_sample_chain_peer(*_peer(args))
    wrap_o, wrap_h = gather.routed_neighbor_sample_chain(*_peer(args))
    chain_o, chain_h = cache.device_sample_chain(seeds, fanouts, rands)
    for outs, hits in ((got_o, got_h), (peer_o, peer_h), (wrap_o, wrap_h),
                       (chain_o, chain_h)):
        assert len(outs) == len(hits) == len(fanouts)
        for a, b in zip(outs, want_o):
            assert a.dtype == torch.int32 and torch.equal(a, b)
        for a, b in zip(hits, want_h):
            assert a.dtype == torch.bool and torch.equal(a, b)
    n_hits = int(sum(h.sum() for h in want_h))
    if kind == "all_misses" or empty:
        assert n_hits == 0 and all((o == -1).all() for o in want_o)
    else:
        assert n_hits > 0 and any((o == -1).any() for o in want_o)
    if kind == "degree_0":
        deg0 = graph.degrees()[seeds] == 0
        assert (want_o[0][torch.from_numpy(deg0)] == -1).all()
        assert want_h[0][torch.from_numpy(deg0)].all()


def test_chain_results_are_one_buffer_read_back_in_one_copy(graph):
    cache = _cache(graph)
    rng = np.random.default_rng(11)
    seeds = rng.integers(0, graph.n, 33)
    rands = _draws(rng, len(seeds), (4, 3, 2))
    outs, hits = cache.device_sample_chain(seeds, (4, 3, 2), rands)
    assert len({t.untyped_storage().data_ptr() for t in outs + hits}) == 1
    host_o, host_h = sampling._to_host(outs, hits)
    for a, b in zip(host_o, outs):
        assert a.dtype == np.int32 and np.array_equal(a, b.numpy())
    for a, b in zip(host_h, hits):
        assert a.dtype == np.bool_ and np.array_equal(a, b.numpy())


def test_chain_rejects_draws_of_the_wrong_shape(graph):
    cache = _cache(graph)
    rng = np.random.default_rng(12)
    seeds = rng.integers(0, graph.n, 10)
    rands = _draws(rng, len(seeds), (4, 3))
    with pytest.raises(ValueError, match="rands"):
        cache.device_sample_chain(seeds, (4, 2), rands)


def _chain_case(k=2, R=6, N=20, n=5, fanouts=(3, 2)):
    indptr = [torch.zeros(R + 1, dtype=torch.int64) for _ in range(k)]
    indices = [torch.zeros(8, dtype=torch.int32) for _ in range(k)]
    owner = torch.zeros(N, dtype=torch.int32)
    local = torch.zeros(N, dtype=torch.int64)
    seeds = torch.zeros(n, dtype=torch.int64)
    rands = []
    for f in fanouts:
        rands.append(torch.zeros((n, f), dtype=torch.int64))
        n *= f
    return indptr, indices, owner, local, seeds, rands


@pytest.mark.parametrize("bad", [
    "no_hops", "five_hops", "indptr_dtype", "owner_dtype", "local_dtype",
    "seeds_dtype", "rand_dtype", "rand_rows", "next_hop_rows", "seeds_rank",
    "k_mismatch", "empty_indices", "empty_routing", "routing_lengths",
    "too_many_rows", "mixed_devices", "stacked_shards", "ragged_shards",
    "too_many_shards"])
def test_chain_wrapper_rejects_what_the_kernel_does_not_take(bad):
    indptr, indices, owner, local, seeds, rands = _chain_case()
    if bad == "no_hops":
        rands = []
    elif bad == "five_hops":
        indptr, indices, owner, local, seeds, rands = _chain_case(
            fanouts=(1,) * 5)
    elif bad == "indptr_dtype":
        indptr = [t.to(torch.int32) for t in indptr]
    elif bad == "owner_dtype":
        owner = owner.to(torch.int64)
    elif bad == "local_dtype":
        local = local.to(torch.int32)
    elif bad == "seeds_dtype":
        seeds = seeds.to(torch.int32)
    elif bad == "rand_dtype":
        rands[1] = rands[1].to(torch.int32)
    elif bad == "rand_rows":
        rands[0] = rands[0][:2]
    elif bad == "next_hop_rows":
        rands[1] = rands[1][:-1]
    elif bad == "seeds_rank":
        seeds = seeds[:, None]
    elif bad == "k_mismatch":
        indices = indices[:1]
    elif bad == "empty_indices":
        indices = [t[:0] for t in indices]
    elif bad == "stacked_shards":  # the stacked entry is gone
        indptr, indices = torch.stack(indptr), torch.stack(indices)
    elif bad == "ragged_shards":
        indices = [indices[0], indices[1][:5]]
    elif bad == "too_many_shards":
        indptr = indptr * (gather.MAX_SHARDS // 2 + 1)
        indices = indices * (gather.MAX_SHARDS // 2 + 1)
    elif bad == "empty_routing":
        owner, local = owner[:0], local[:0]
    elif bad == "routing_lengths":
        local = local[:-1]
    elif bad == "too_many_rows":  # shapes only: expanded, nothing held
        seeds = seeds[:1]
        one = torch.zeros((1, 1), dtype=torch.int64)
        rands = [one.expand(1, 1 << 16), one.expand(1 << 16, 1 << 16),
                 one.expand(1 << 32, 1)]
    else:
        rands[1] = rands[1].to("meta")
    with pytest.raises((TypeError, ValueError)):
        gather.routed_neighbor_sample_chain(indptr, indices, owner, local,
                                            seeds, rands)


def test_chain_on_cpu_counts_no_launches(graph):
    cache = _cache(graph)
    rng = np.random.default_rng(13)
    seeds = rng.integers(0, graph.n, 8)
    before = (gather.SAMPLE_KERNEL.launches,
              dict(gather.SAMPLE_KERNEL.route_launches))
    cache.device_sample_chain(seeds, (2, 2), _draws(rng, 8, (2, 2)))
    assert (gather.SAMPLE_KERNEL.launches,
            gather.SAMPLE_KERNEL.route_launches) == before


# ---------------- on the card ------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU host)")
    return torch.device("cuda")


def _random_chain(k, R, N, n, fanouts, seed=0, edge=None):
    """Random CSR shard stacks (degree-0 rows, pad rows), routing tables
    with uncached vertices (-1), owners past K_g - 1 and slots outside
    [0, R], seeds with -1 and past N - 1, and draws; ``edge`` turns one
    edge case up to the whole input."""
    rng = np.random.default_rng(seed)
    degs = rng.integers(0, 30, size=(k, R))
    degs[:, ::13] = 0
    E = max(int(degs.sum(1).max()), 1)
    indptr = np.zeros((k, R + 1), np.int64)
    indices = np.zeros((k, E), np.int32)
    for gi in range(k):
        ptr = np.concatenate([[0], np.cumsum(degs[gi])])
        indptr[gi] = ptr
        indices[gi, :ptr[-1]] = rng.integers(-1, N + 5, size=ptr[-1])
    owner = rng.integers(-1, k, size=N).astype(np.int32)
    owner[::97] = k + 3
    owner[1::89] = -7
    local = rng.integers(0, R, size=N).astype(np.int64)
    local[::71] = R + 9
    local[1::67] = -4
    seeds = rng.integers(0, N, size=n).astype(np.int64)
    seeds[::7] = -1
    seeds[1::31] = N + 100
    rands, m = [], n
    for f in fanouts:
        r = rng.integers(0, 1 << 31, size=(m, f), dtype=np.int64)
        r[::5] = (1 << 31) - 1 - np.arange(f)
        rands.append(r)
        m *= f
    if edge == "all_misses":
        owner[:] = -1
    elif edge == "degree_0":
        indptr[:] = indptr[:, :1]
    elif edge == "seeds_of_-1":
        seeds[:] = -1
    elif edge == "empty_topology_cache":
        indptr = np.zeros((k, 1), np.int64)
        indices = np.zeros((k, 1), np.int32)
        owner[:] = -1
    return (torch.from_numpy(indptr), torch.from_numpy(indices),
            torch.from_numpy(owner), torch.from_numpy(local),
            torch.from_numpy(seeds), [torch.from_numpy(r) for r in rands])


@pytest.mark.gpu
@pytest.mark.parametrize("k,R,N,n,fanouts,edge", [
    (2, 40, 300, 17, (5,), None),
    (2, 40, 300, 33, (5, 3), None),
    (3, 500, 4000, 200, (3, 2, 2), None),
    (4, 300, 3000, 65, (4, 3, 2, 2), None),
    (2, 200_000, 1_000_000, 2000, (25, 10), None),
    (1, 300_000, 1_000_000, 8000, (25, 10), None),
    (2, 40, 300, 40, (5, 3), "all_misses"),
    (2, 40, 300, 40, (5, 3), "degree_0"),
    (2, 40, 300, 40, (5, 3), "seeds_of_-1"),
    (2, 40, 300, 40, (5, 3), "empty_topology_cache"),
    (2, 40, 300, 5, (700, 3), None),
    (2, 40, 300, 41, (3, 17), None),
    (2, 40, 300, 41, (9,), None),
    (2, 40, 300, 17, (5, 0), None),
    (2, 40, 300, 17, (0, 3), None),
    (2, 40, 300, 0, (5, 3), None),
])
def test_cuda_chain_matches_plain_version_in_one_launch(cuda_device, k, R, N,
                                                        n, fanouts, edge):
    indptr, indices, owner, local, seeds, rands = (
        _random_chain(k, R, N, n, fanouts, edge=edge))
    args = [t.to(cuda_device) for t in (indptr, indices, owner, local,
                                        seeds)]
    args.append([r.to(cuda_device) for r in rands])
    snap = [t.clone() for t in args[:5]] + [r.clone() for r in args[5]]
    before = dict(gather.SAMPLE_KERNEL.route_launches)
    outs, hits = gather.routed_neighbor_sample_chain(*_peer(args))
    torch.cuda.synchronize()
    assert gather.SAMPLE_KERNEL.route_launches == {
        "hop": before["hop"], "chain": before["chain"] + (n > 0)}
    want_o, want_h = tref.routed_neighbor_sample_chain(*args)
    for a, b in zip(outs, want_o):
        assert torch.equal(a, b)
    for a, b in zip(hits, want_h):
        assert torch.equal(a, b)
    assert all(torch.equal(a, b)
               for a, b in zip(args[:5] + args[5], snap))


@pytest.mark.gpu
def test_cuda_device_sample_chain_is_one_launch_and_one_readback(
        cuda_device, graph):
    """On the card ``device_sample_chain`` launches the chain once (no
    per-hop launch), and the dispatch/resolve pass gives the host
    sampler's levels."""
    cache = _cache(graph, device=cuda_device)
    rng = np.random.default_rng(21)
    seeds = rng.integers(0, graph.n, 64)
    before = dict(gather.SAMPLE_KERNEL.route_launches)
    levels, _ = sampling.cache_sample_batch(graph, cache, seeds, (5, 3),
                                            np.random.default_rng(1))
    torch.cuda.synchronize()
    assert gather.SAMPLE_KERNEL.route_launches == {
        "hop": before["hop"], "chain": before["chain"] + 1}
    host = sampling.host_sample_batch(graph, seeds, (5, 3),
                                      np.random.default_rng(1))
    for a, b in zip(levels, host):
        np.testing.assert_array_equal(a, b)
