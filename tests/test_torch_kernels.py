"""The port's ``fused_gather_overlay`` against the reference package's:
its plain path (CPU tensors) equals the Pallas kernel in interpret mode and
the jnp oracle bit for bit, in f32 and bf16; the CUDA kernel equals the
plain version on the card (``gpu``-marked, skips without one).

The reference package is imported inside the CPU tests only, so that the
``gpu`` tests also run on a GPU host that has no JAX:
``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels.py``."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import fused_batch
from repro_torch.kernels import ref as tref


def _reference():
    """(jax.numpy, the reference's Pallas ops, its jnp oracles)."""
    import jax.numpy as jnp

    from repro.kernels import ops, ref

    return jnp, ops, ref


def _case(N, D, B, M, seed=0):
    """Random fused-finalize instance (numpy): disjoint hit / miss / pad
    rows, as ``tests/test_kernels.py`` builds them."""
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((N, D), dtype=np.float32)
    miss = rng.standard_normal((M, D), dtype=np.float32)
    kind = rng.integers(0, 3, size=B)  # 0 = hit, 1 = miss, 2 = pad
    idx = np.where(kind == 0, rng.integers(0, N, size=B), -1).astype(np.int32)
    n_miss = int((kind == 1).sum())
    inv = np.full(B, -1, np.int32)
    inv[kind == 1] = rng.permutation(M)[:n_miss] if n_miss <= M else 0
    return table, idx, miss, inv


def _to_torch(x: np.ndarray, dtype):
    return torch.from_numpy(x).to(dtype)


def _to_jax(t: torch.Tensor):
    """The same bits on the JAX side (bf16 through its 16-bit pattern)."""
    jnp = _reference()[0]
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.view(torch.int16).numpy().view(jnp.bfloat16))
    return jnp.asarray(t.numpy())


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy().view(np.uint32)
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype.itemsize == 2 else x.view(np.uint32)


@pytest.mark.parametrize("N,D,B,M", [(64, 128, 33, 16), (100, 256, 17, 8),
                                     (7, 100, 12, 5), (50, 384, 64, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_path_matches_pallas_and_oracle_bitwise(N, D, B, M, dtype):
    jnp, jops, jref = _reference()
    table, idx, miss, inv = _case(N, D, B, min(M, B))
    t_table, t_miss = _to_torch(table, dtype), _to_torch(miss, dtype)
    t_idx, t_inv = torch.from_numpy(idx), torch.from_numpy(inv)
    got = fused_batch.fused_gather_overlay(t_table, t_idx, t_miss, t_inv)
    args = (_to_jax(t_table), jnp.asarray(idx), _to_jax(t_miss),
            jnp.asarray(inv))
    pallas = jops.fused_gather_overlay(*args)
    oracle = jref.fused_gather_overlay(*args)
    assert got.dtype == dtype and tuple(got.shape) == (B, D)
    np.testing.assert_array_equal(_bits(got), _bits(pallas))
    np.testing.assert_array_equal(_bits(got), _bits(oracle))


def test_out_of_range_indices_clamp_like_xla():
    """Explicit clamps reproduce XLA's implicit ones on indices past the
    end of either source."""
    jnp, _, jref = _reference()
    table, _, miss, _ = _case(9, 32, 4, 3, seed=2)
    idx = np.asarray([20, 8, -1, -1], np.int32)
    inv = np.asarray([-1, -1, 7, -1], np.int32)
    got = tref.fused_gather_overlay(torch.from_numpy(table),
                                    torch.from_numpy(idx),
                                    torch.from_numpy(miss),
                                    torch.from_numpy(inv))
    want = jref.fused_gather_overlay(jnp.asarray(table), jnp.asarray(idx),
                                     jnp.asarray(miss), jnp.asarray(inv))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_single_row_sources_and_feature_dim_mismatch():
    """Degenerate shapes the bucket discipline produces: a 1-row dummy
    table (empty cache) and a 1-row miss buffer; rows claimed by neither
    map come back zero."""
    jnp, jops, _ = _reference()
    D = 64
    table = torch.zeros((1, D))
    miss = torch.arange(D, dtype=torch.float32)[None, :] + 1.0
    idx = torch.tensor([-1, -1, -1], dtype=torch.int32)
    inv = torch.tensor([0, -1, -1], dtype=torch.int32)
    out = fused_batch.fused_gather_overlay(table, idx, miss, inv)
    want = jops.fused_gather_overlay(jnp.zeros((1, D)), jnp.asarray(idx),
                                     jnp.asarray(miss.numpy()),
                                     jnp.asarray(inv))
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))
    np.testing.assert_array_equal(out[0].numpy(), miss[0].numpy())
    assert (out[1:] == 0).all()
    with pytest.raises(ValueError, match="feature dim"):
        fused_batch.fused_gather_overlay(table, idx, torch.zeros((1, D + 2)),
                                         inv)


@pytest.mark.parametrize("bad", ["dtype", "index_dtype", "shape", "empty"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    table = torch.zeros((4, 8))
    miss = torch.zeros((2, 8))
    idx = torch.zeros(3, dtype=torch.int32)
    inv = torch.full((3,), -1, dtype=torch.int32)
    if bad == "dtype":
        miss = miss.to(torch.bfloat16)
    elif bad == "index_dtype":
        idx = idx.to(torch.int64)
    elif bad == "shape":
        inv = inv[:2]
    else:
        table = torch.zeros((0, 8))
    with pytest.raises((TypeError, ValueError)):
        fused_batch.fused_gather_overlay(table, idx, miss, inv)


def test_cpu_tensors_take_the_plain_path_without_counting_launches():
    table, idx, miss, inv = _case(20, 16, 10, 4, seed=5)
    before = fused_batch.KERNEL.launches
    fused_batch.fused_gather_overlay(*(torch.from_numpy(a) for a in
                                       (table, idx, miss, inv)))
    assert fused_batch.KERNEL.launches == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU host)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("N,D,B,M", [(64, 128, 33, 16), (7, 100, 12, 5),
                                     (50_000, 128, 70_656, 20_000)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernel_matches_plain_version(cuda_device, N, D, B, M, dtype):
    table, idx, miss, inv = _case(N, D, B, min(M, B))
    args = (_to_torch(table, dtype).to(cuda_device),
            torch.from_numpy(idx).to(cuda_device),
            _to_torch(miss, dtype).to(cuda_device),
            torch.from_numpy(inv).to(cuda_device))
    before = fused_batch.KERNEL.launches
    got = fused_batch.fused_gather_overlay(*args)
    torch.cuda.synchronize()
    assert fused_batch.KERNEL.launches == before + 1
    assert torch.equal(got, tref.fused_gather_overlay(*args))


@pytest.mark.gpu
def test_cuda_server_launches_kernel_once_per_micro_batch(cuda_device):
    """On the card every micro-batch (warm-up included) launches the fused
    kernel exactly once, and the bitwise host-oracle check holds."""
    from repro_torch.core.cliques import topology_matrix
    from repro_torch.core.planner import build_plan
    from repro_torch.graph.csr import powerlaw_graph
    from repro_torch.models.gnn import GNNConfig, defs
    from repro_torch.models.params import init_from_defs
    from repro_torch.serve import GNNServer, ServeConfig

    g = powerlaw_graph(4000, 10, seed=4, feat_dim=32)
    cfg = GNNConfig(feat_dim=32, hidden=16, batch_size=32, fanouts=(5, 3))
    plan = build_plan(g, topology_matrix("nv2"), mem_per_device=1_000_000,
                      batch_size=32, fanouts=cfg.fanouts, seed=0)
    params = init_from_defs(defs(cfg), torch.Generator().manual_seed(0),
                            cuda_device)
    srv = GNNServer(g, plan, cfg, params, device=cuda_device,
                    config=ServeConfig(max_batch=32, oracle_check=True))
    before = fused_batch.KERNEL.launches
    srv.warmup()
    rng = np.random.default_rng(9)
    futs = [srv.submit(rng.integers(0, g.n, int(n)))
            for n in rng.integers(1, 33, 12)]
    srv.start()
    try:
        res = [f.result(timeout=120) for f in futs]
    finally:
        srv.stop()
    s = srv.summary()
    assert fused_batch.KERNEL.launches - before == s["batches"]
    assert s["oracle_mismatches"] == 0 and s["oracle_checks"] == s["batches"]
    assert all(np.isfinite(r.logits).all() for r in res)
