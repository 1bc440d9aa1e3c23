"""The port's kernels against the reference package's: each plain path
(CPU tensors) equals the reference's Pallas kernel in interpret mode and its
jnp oracle bit for bit (``fused_gather_overlay``, ``gather_rows``,
``scatter_rows``; the sweeps of ``tests/test_kernels.py``; the routed
kernels' plain versions are held to the reference in
``tests/test_torch_sharded.py``); each CUDA kernel equals its plain version
on the card (``gpu``-marked, skips without one).

The reference package is imported inside the CPU tests only, so that the
``gpu`` tests also run on a GPU host that has no JAX:
``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels.py``."""
import sys
import threading

import numpy as np
import pytest
import torch

from repro_torch.kernels import KERNELS, fused_batch, gather, scatter
from repro_torch.kernels._build import CudaKernel, local_sources
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


def _offset_copy(t: torch.Tensor, nbytes: int) -> torch.Tensor:
    """A contiguous copy of ``t`` whose data starts ``nbytes`` past a
    16-byte boundary, so the kernel must copy in narrower vectors."""
    size = t.numel() * t.element_size()
    raw = torch.zeros(size + 16, dtype=torch.uint8, device=t.device)
    out = raw[nbytes:nbytes + size].view(t.dtype).view(t.shape)
    out.copy_(t)
    return out


def _overlay_case(name, device):
    """``fused_gather_overlay`` inputs on ``device`` for one of the row
    widths, alignments and map mixes the redesigned kernel must serve."""
    N, D, B, M, dtype = 5_000, 128, 3_000, 1_000, torch.float32
    if name == "d100_f32_400B":
        D = 100
    elif name == "bf16_512B":
        D, dtype = 256, torch.bfloat16
    elif name == "f32_4096B":
        D = 1024
    elif name == "b_not_multiple_of_32":
        B = 3_001
    table, idx, miss, inv = _case(N, D, B, M, seed=7)
    if name == "aligned_1B_uint8":
        rng = np.random.default_rng(8)
        table = rng.integers(0, 256, (N, 100), dtype=np.uint8)
        miss = rng.integers(0, 256, (M, 100), dtype=np.uint8)
        dtype = torch.uint8
    elif name == "all_padding":
        idx[:] = -1
        inv[:] = -1
    elif name == "all_misses":
        idx[:] = np.arange(B) % N
        inv[:] = np.arange(B) % M
    elif name == "out_of_range":
        idx[::7] = N + 3
        inv[::11] = M + 5
    args = [torch.from_numpy(table).to(dtype).to(device),
            torch.from_numpy(idx).to(device),
            torch.from_numpy(miss).to(dtype).to(device),
            torch.from_numpy(inv).to(device)]
    if name == "aligned_4B_f32":
        args[0], args[2] = _offset_copy(args[0], 4), _offset_copy(args[2], 4)
    elif name == "aligned_1B_uint8":
        args[0], args[2] = _offset_copy(args[0], 1), _offset_copy(args[2], 3)
    return args


@pytest.mark.gpu
@pytest.mark.parametrize("name", [
    "d100_f32_400B", "bf16_512B", "f32_4096B", "aligned_4B_f32",
    "aligned_1B_uint8", "b_not_multiple_of_32", "all_padding", "all_misses",
    "out_of_range"])
def test_cuda_kernel_serves_every_width_alignment_and_map_mix(cuda_device,
                                                              name):
    """The redesigned kernel (runs of 32 rows a warp, loads before stores)
    at row widths of 400, 512 and 4096 bytes, sources 4- and 1-byte
    aligned, a batch that is not a multiple of 32, all padding, all
    misses, and indices past the end: bitwise equal to the plain version,
    one launch, inputs unchanged."""
    args = _overlay_case(name, cuda_device)
    snap = [a.clone() for a in args]
    before = fused_batch.KERNEL.launches
    got = fused_batch.fused_gather_overlay(*args)
    torch.cuda.synchronize()
    assert fused_batch.KERNEL.launches == before + 1
    assert torch.equal(got, tref.fused_gather_overlay(*args))
    assert all(torch.equal(a, b) for a, b in zip(args, snap))
    if name == "all_padding":
        assert not got.any()


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


# ---------------- gather_rows and scatter_rows (plain path) ----------------

def _table(N, D, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return _to_torch(rng.standard_normal((N, D), dtype=np.float32), dtype)


def _assert_same_bits(got, *wants):
    for want in wants:
        np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("N,D,B", [(64, 128, 16), (100, 256, 33), (7, 128, 5)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gather_plain_path_matches_pallas_and_oracle(N, D, B, dtype):
    jnp, jops, jref = _reference()
    table = _table(N, D, dtype)
    idx = np.random.default_rng(0).integers(-2, N, size=B).astype(np.int32)
    got = gather.gather_rows(table, torch.from_numpy(idx))
    args = (_to_jax(table), jnp.asarray(idx))
    assert got.dtype == dtype and tuple(got.shape) == (B, D)
    _assert_same_bits(got, jops.gather_rows(*args), jref.gather_rows(*args))


@pytest.mark.parametrize("N,D,B", [(50, 100, 17), (64, 130, 9), (20, 1, 3),
                                   (64, 384, 16)])
def test_gather_plain_path_at_non_lane_widths(N, D, B):
    jnp, jops, jref = _reference()
    table = _table(N, D, torch.float32, seed=5)
    idx = np.random.default_rng(2).integers(-3, N, size=B).astype(np.int32)
    got = gather.gather_rows(table, torch.from_numpy(idx))
    args = (_to_jax(table), jnp.asarray(idx))
    _assert_same_bits(got, jops.gather_rows(*args), jref.gather_rows(*args))


def test_gather_negative_indices_zero_and_mask():
    jnp, jops, _ = _reference()
    table = torch.arange(12.0).reshape(4, 3) + 1.0  # no zero rows
    idx = torch.tensor([2, -1, 0, -7, 3], dtype=torch.int32)
    out, mask = gather.gather_rows(table, idx, return_mask=True)
    jout, jmask = jops.gather_rows(_to_jax(table), jnp.asarray(idx.numpy()),
                                   return_mask=True)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    np.testing.assert_array_equal(mask.numpy(),
                                  [True, False, True, False, True])
    _assert_same_bits(out, jout)
    assert (out[~mask] == 0).all()
    assert torch.equal(out[mask], table[[2, 0, 3]])


def test_gather_batched_index_shape():
    """idx may be multi-dimensional (B, F): the output is (B, F, D), equal
    to the Pallas kernel's and to the flat gather reshaped."""
    jnp, jops, jref = _reference()
    table = _table(32, 128, torch.float32, seed=6)
    idx = np.random.default_rng(3).integers(-1, 32, size=(7, 5)) \
        .astype(np.int32)
    out = gather.gather_rows(table, torch.from_numpy(idx))
    assert tuple(out.shape) == (7, 5, 128)
    _assert_same_bits(out, jops.gather_rows(_to_jax(table), jnp.asarray(idx)))
    flat = jref.gather_rows(_to_jax(table), jnp.asarray(idx.reshape(-1)))
    _assert_same_bits(out, np.asarray(flat).reshape(7, 5, 128))


def test_gather_int32_column_table():
    """The integer D = 1 table the routed neighbor sampler gathers from."""
    jnp, jops, jref = _reference()
    rng = np.random.default_rng(4)
    col = rng.integers(0, 1 << 30, size=(40, 1)).astype(np.int32)
    idx = rng.integers(-2, 40, size=(6, 9)).astype(np.int32)
    got = gather.gather_rows(torch.from_numpy(col), torch.from_numpy(idx))
    assert got.dtype == torch.int32 and tuple(got.shape) == (6, 9, 1)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jops.gather_rows(jnp.asarray(col),
                                                 jnp.asarray(idx))))
    np.testing.assert_array_equal(
        got.numpy().reshape(-1, 1),
        np.asarray(jref.gather_rows(jnp.asarray(col),
                                    jnp.asarray(idx.reshape(-1)))))


def test_gather_out_of_range_indices_clamp_like_xla():
    jnp, jops, jref = _reference()
    table = _table(9, 32, torch.float32, seed=2)
    idx = np.asarray([20, 8, -1, 9, 0], np.int32)
    got = gather.gather_rows(table, torch.from_numpy(idx))
    args = (_to_jax(table), jnp.asarray(idx))
    _assert_same_bits(got, jops.gather_rows(*args), jref.gather_rows(*args))
    assert torch.equal(got[0], table[8]) and torch.equal(got[3], table[8])


def _scatter_case(N, D, B, dtype, seed=0):
    """Unique valid targets plus dropped (negative / out-of-range) entries,
    as ``tests/test_kernels.py`` builds them."""
    rng = np.random.default_rng(seed)
    idx = rng.permutation(N)[:B].astype(np.int32)
    bad = np.resize(np.array([-1, N, -7, N + 3], np.int32), max(B // 3, 1))
    idx[: len(bad)] = bad
    table = _table(N, D, dtype, seed=seed + 1)
    rows = _table(B, D, dtype, seed=seed + 2)
    return table, torch.from_numpy(idx), rows


@pytest.mark.parametrize("N,D,B", [(64, 128, 16), (100, 256, 33),
                                   (20, 100, 7), (16, 130, 5)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scatter_plain_path_matches_pallas_and_oracle(N, D, B, dtype):
    jnp, jops, jref = _reference()
    table, idx, rows = _scatter_case(N, D, B, dtype)
    before = table.clone()
    got = scatter.scatter_rows(table, idx, rows)
    args = (_to_jax(table), jnp.asarray(idx.numpy()), _to_jax(rows))
    assert got.dtype == dtype and tuple(got.shape) == (N, D)
    _assert_same_bits(got, jops.scatter_rows(*args),
                      jref.scatter_rows(*args))
    assert torch.equal(table, before)  # functional: the input is untouched


def test_scatter_is_functional_and_targets_only_valid_rows():
    jnp, jops, _ = _reference()
    table = torch.arange(12.0).reshape(4, 3)
    idx = torch.tensor([2, -1], dtype=torch.int32)
    rows = torch.full((2, 3), -5.0)
    out = scatter.scatter_rows(table, idx, rows)
    _assert_same_bits(out, jops.scatter_rows(_to_jax(table),
                                             jnp.asarray(idx.numpy()),
                                             _to_jax(rows)))
    assert (out[2] == -5.0).all()
    for r in (0, 1, 3):  # untouched rows preserved
        assert torch.equal(out[r], table[r])
    assert torch.equal(table, torch.arange(12.0).reshape(4, 3))


def test_scatter_empty_update_returns_the_table():
    """B = 0 returns the input table itself (nothing is written, nothing
    launches), as the reference wrapper does; the plain version copies."""
    jnp, jops, _ = _reference()
    table = torch.arange(20.0).reshape(5, 4)
    idx, rows = torch.zeros((0,), dtype=torch.int32), torch.zeros((0, 4))
    assert scatter.scatter_rows(table, idx, rows) is table
    want = jops.scatter_rows(_to_jax(table), jnp.zeros((0,), jnp.int32),
                             jnp.zeros((0, 4)))
    _assert_same_bits(tref.scatter_rows(table, idx, rows), want)


def test_scatter_then_gather_roundtrip():
    """The refresh write path feeds the gather read path: admitted rows
    come back bit-exact through the same slot ids."""
    table = _table(32, 128, torch.float32, seed=8)
    rows = _table(6, 128, torch.float32, seed=9)
    slots = torch.tensor([3, 30, 7, 0, 21, 16], dtype=torch.int32)
    new = scatter.scatter_rows(table, slots, rows)
    assert torch.equal(gather.gather_rows(new, slots), rows)


@pytest.mark.parametrize("bad", ["index_dtype", "table_rank", "empty_table",
                                 "device"])
def test_gather_wrapper_rejects_what_the_kernel_does_not_take(bad):
    table = torch.zeros((4, 8))
    idx = torch.zeros(3, dtype=torch.int32)
    if bad == "index_dtype":
        idx = idx.to(torch.int64)
    elif bad == "table_rank":
        table = torch.zeros(4)
    elif bad == "empty_table":
        table = torch.zeros((0, 8))
    else:
        table = table.to("meta")
    with pytest.raises((TypeError, ValueError)):
        gather.gather_rows(table, idx)


@pytest.mark.parametrize("bad", ["index_dtype", "index_rank", "rows_width",
                                 "rows_count"])
def test_scatter_wrapper_rejects_what_the_kernel_does_not_take(bad):
    table = torch.zeros((4, 8))
    idx = torch.zeros(3, dtype=torch.int32)
    rows = torch.zeros((3, 8))
    if bad == "index_dtype":
        idx = idx.to(torch.int64)
    elif bad == "index_rank":
        idx = idx[:, None]
    elif bad == "rows_width":
        rows = torch.zeros((3, 9))
    else:
        rows = torch.zeros((2, 8))
    with pytest.raises((TypeError, ValueError)):
        scatter.scatter_rows(table, idx, rows)


def test_gather_and_scatter_on_cpu_count_no_launches():
    table = _table(20, 16, torch.float32, seed=5)
    idx = torch.tensor([1, -1, 19], dtype=torch.int32)
    before = (gather.KERNEL.launches, scatter.KERNEL.launches)
    gather.gather_rows(table, idx)
    scatter.scatter_rows(table, idx, torch.zeros((3, 16)))
    assert (gather.KERNEL.launches, scatter.KERNEL.launches) == before


def test_kernel_registry_describes_every_ported_kernel():
    """Each entry replaces a TPU kernel of ``src/repro/kernels/``, except
    the attention backward, which stands for the gradient of the LM path's
    ``lax.scan`` (the reference has no backward Pallas kernel)."""
    names = [k.name for k in KERNELS]
    assert names == ["fused_gather_overlay", "gather_rows", "scatter_rows",
                     "routed_gather", "routed_neighbor_sample",
                     "flash_attention", "flash_attention_bwd",
                     "sage_aggregate"]
    for k in KERNELS:
        assert k.source == f"src/repro_torch/kernels/csrc/{k.name}.cu"
        assert k.kernel.source.exists()
        path, line = k.replaces.split(":")
        if k.name == "flash_attention_bwd":
            assert k.replaces == "src/repro/models/layers.py:75"
            continue
        assert path.startswith("src/repro/kernels/") and int(line) > 0


def test_library_path_hashes_the_local_headers_a_source_includes(tmp_path):
    """An edited header rebuilds: the library's name hashes the source and
    every ``#include "..."`` it reaches (nested, each once), not the
    toolkit's ``<...>`` headers."""
    (tmp_path / "sub").mkdir()
    (tmp_path / "k.cu").write_text(
        '#include <cuda_runtime.h>\n#include "a.cuh"\n#include "sub/b.cuh"\n'
        'extern "C" int k() { return 0; }\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n  # include "sub/b.cuh"\n')
    (tmp_path / "sub" / "b.cuh").write_text("#pragma once\n")
    kern = CudaKernel("k", str(tmp_path / "k.cu"), "k", [])
    assert [p.name for p in local_sources(kern.source)] == ["k.cu", "a.cuh",
                                                            "b.cuh"]
    paths = [kern.library_path()]
    for name, text in (("sub/b.cuh", "#pragma once\n// edited\n"),
                       ("a.cuh", '#pragma once\n#include "sub/b.cuh"\n'),
                       ("k.cu", '#include "a.cuh"\n')):
        (tmp_path / name).write_text(text)
        paths.append(kern.library_path())
    assert len(set(paths)) == len(paths)
    assert kern.library_path() == paths[-1]  # unchanged files, same name


def test_flash_attention_library_covers_its_hopper_header():
    from repro_torch.kernels import flash_attention as fa

    names = [p.name for p in local_sources(fa.KERNEL.source)]
    assert names == ["flash_attention.cu", "hopper.cuh"]


@pytest.mark.gpu
@pytest.mark.parametrize("N,D,shape", [(64, 128, (33,)), (7, 100, (12,)),
                                       (500, 128, (40, 25)),
                                       (498_046, 128, (412_746,))])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_gather_matches_plain_version(cuda_device, N, D, shape, dtype):
    rng = np.random.default_rng(1)
    table = _table(N, D, dtype).to(cuda_device)
    idx = torch.from_numpy(rng.integers(-N // 3, N + 3, size=shape)
                           .astype(np.int32)).to(cuda_device)
    before = gather.KERNEL.launches
    got, mask = gather.gather_rows(table, idx, return_mask=True)
    torch.cuda.synchronize()
    assert gather.KERNEL.launches == before + 1
    assert torch.equal(got, tref.gather_rows(table, idx))
    assert torch.equal(mask, idx >= 0)


@pytest.mark.gpu
def test_cuda_gather_int32_column(cuda_device):
    rng = np.random.default_rng(2)
    col = torch.from_numpy(rng.integers(0, 1 << 30, size=(10_000, 1))
                           .astype(np.int32)).to(cuda_device)
    idx = torch.from_numpy(rng.integers(-5, 10_005, size=(300, 10))
                           .astype(np.int32)).to(cuda_device)
    assert torch.equal(gather.gather_rows(col, idx),
                       tref.gather_rows(col, idx))


@pytest.mark.gpu
@pytest.mark.parametrize("N,D,B", [(64, 128, 16), (20, 100, 7),
                                   (498_046, 128, 49_804)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_scatter_matches_plain_version(cuda_device, N, D, B, dtype):
    table, idx, rows = (t.to(cuda_device)
                        for t in _scatter_case(N, D, B, dtype, seed=3))
    before_table = table.clone()
    launches = scatter.KERNEL.launches
    got = scatter.scatter_rows(table, idx, rows)
    torch.cuda.synchronize()
    assert scatter.KERNEL.launches == launches + 1
    assert torch.equal(got, tref.scatter_rows(table, idx, rows))
    assert torch.equal(table, before_table)  # the input is never written
    empty = scatter.scatter_rows(table, idx[:0], rows[:0])
    assert empty is table and scatter.KERNEL.launches == launches + 1


@pytest.mark.gpu
def test_cuda_training_runs_the_kernels_and_matches_the_host_backend(
        cuda_device):
    """On the card: host and device backends train to bitwise-equal losses
    across refreshes; each step launches the fused kernel once per
    simulated device (two here, concatenated), each admitting refresh the
    scatter once, and the unfused finalize the gather once per device and
    step, with the same losses."""
    from repro_torch.core.cache_manager import RefreshConfig
    from repro_torch.core.cliques import topology_matrix
    from repro_torch.core.planner import build_plan
    from repro_torch.graph.csr import powerlaw_graph
    from repro_torch.models.gnn import GNNConfig
    from repro_torch.train.loop import train_gnn

    g = powerlaw_graph(4000, 8, seed=4, feat_dim=32)
    cfg = GNNConfig(feat_dim=32, hidden=32, batch_size=64, fanouts=(4, 2),
                    lr=3e-3)

    def run(**kw):
        plan = build_plan(g, topology_matrix("nv2", 2),
                          mem_per_device=100_000, batch_size=64, seed=0,
                          fanouts=cfg.fanouts)
        return train_gnn(g, plan, cfg, steps=8, seed=0, device=cuda_device,
                         refresh_config=RefreshConfig(interval=4,
                                                      drift_threshold=1.0),
                         **kw)

    host = run(backend="host")
    before = {k: k_.launches for k, k_ in
              (("f", fused_batch.KERNEL), ("g", gather.KERNEL),
               ("s", scatter.KERNEL))}
    dev = run(backend="device")
    admitting = sum(1 for e in dev.refresh["events"] if e["admitted"] > 0)
    assert dev.refresh["admitted"] > 0
    assert fused_batch.KERNEL.launches - before["f"] == 8 * 2
    assert scatter.KERNEL.launches - before["s"] == admitting
    assert host.losses == dev.losses and host.refresh == dev.refresh
    unfused = run(backend="device", fused=False)
    assert gather.KERNEL.launches - before["g"] == 8 * 2
    assert unfused.losses == dev.losses


# ---------------- routed_gather and routed_neighbor_sample ----------------

def _routed_gather_case(k, R, D, n, dtype, seed=0, device="cpu"):
    """A shard stack (its rows are the shards; the wrapper takes them as a
    list) and routing with misses (-1), owners past K_g - 1 and slots
    outside [0, R): the clamps the kernel shares with its plain version."""
    rng = np.random.default_rng(seed)
    shards = _to_torch(rng.standard_normal((k, R, D), dtype=np.float32),
                       dtype)
    owner = rng.integers(-1, k, size=n).astype(np.int32)
    owner[::97] = k + 1
    local = rng.integers(0, R, size=n).astype(np.int32)
    local[::89] = R + 5
    local[1::89] = -2
    return (shards.to(device), torch.from_numpy(owner).to(device),
            torch.from_numpy(local).to(device))


def _csr_stack(k, R, max_deg, seed=0):
    """A padded per-shard CSR stack (indptr (k, R+1) int64, indices (k, E)
    int32) with degree-0 rows and pad rows repeating the last offset."""
    rng = np.random.default_rng(seed)
    degs = rng.integers(0, max_deg + 1, size=(k, R))
    degs[:, ::13] = 0
    E = max(int(degs.sum(1).max()), 1)
    indptr = np.zeros((k, R + 1), np.int64)
    indices = np.zeros((k, E), np.int32)
    for gi in range(k):
        ptr = np.concatenate([[0], np.cumsum(degs[gi])])
        indptr[gi] = ptr
        indices[gi, :ptr[-1]] = rng.integers(0, 1 << 30, size=ptr[-1])
    return torch.from_numpy(indptr), torch.from_numpy(indices)


def _sample_case(k, R, n, f, seed=0, device="cpu"):
    """Stacked CSR shards and routing: ``_as_shards`` gives the wrapper's
    form, the stacks are the dense oracle's."""
    indptr, indices = _csr_stack(k, R, 40, seed)
    rng = np.random.default_rng(seed + 1)
    owner = rng.integers(-1, k, size=n).astype(np.int32)
    owner[::101] = k + 2
    local = rng.integers(0, R, size=n).astype(np.int32)
    local[::71] = R + 3
    rand = rng.integers(0, 1 << 31, size=(n, f), dtype=np.int64)
    rand[::53] = (1 << 31) - 1
    return tuple(t.to(device) for t in (
        indptr, indices, torch.from_numpy(owner), torch.from_numpy(local),
        torch.from_numpy(rand)))


def _as_shards(*stacks):
    """Each stack's rows as separate contiguous tensors (the routed
    wrappers' form: one allocation per shard)."""
    out = tuple([t.clone() for t in stack.unbind(0)] for stack in stacks)
    return out if len(out) > 1 else out[0]


@pytest.mark.parametrize("bad", ["owner_dtype", "local_shape", "rank",
                                 "empty_shard", "device", "stacked",
                                 "ragged", "mixed_dtype", "too_many"])
def test_routed_gather_wrapper_rejects_what_the_kernel_does_not_take(bad):
    stack, owner, local = _routed_gather_case(2, 4, 8, 5, torch.float32)
    shards = _as_shards(stack)
    if bad == "owner_dtype":
        owner = owner.to(torch.int64)
    elif bad == "local_shape":
        local = local[:3]
    elif bad == "rank":
        shards = [s[0] for s in shards]
    elif bad == "empty_shard":
        shards = [s[:0] for s in shards]
    elif bad == "device":
        shards = [s.to("meta") for s in shards]
    elif bad == "stacked":  # the stacked entry is gone
        shards = stack
    elif bad == "ragged":
        shards = [shards[0], shards[1][:3]]
    elif bad == "mixed_dtype":
        shards = [shards[0], shards[1].to(torch.bfloat16)]
    else:
        shards = shards * (gather.MAX_SHARDS // 2 + 1)
    with pytest.raises((TypeError, ValueError)):
        gather.routed_gather(shards, owner, local)


@pytest.mark.parametrize("bad", ["indptr_dtype", "rand_dtype", "rand_rows",
                                 "k_mismatch", "empty_indices"])
def test_routed_sample_wrapper_rejects_what_the_kernel_does_not_take(bad):
    indptr, indices, owner, local, rand = _sample_case(2, 6, 4, 3)
    indptr, indices = _as_shards(indptr, indices)
    if bad == "indptr_dtype":
        indptr = [t.to(torch.int32) for t in indptr]
    elif bad == "rand_dtype":
        rand = rand.to(torch.int32)
    elif bad == "rand_rows":
        rand = rand[:2]
    elif bad == "k_mismatch":
        indices = indices[:1]
    else:
        indices = [t[:0] for t in indices]
    with pytest.raises((TypeError, ValueError)):
        gather.routed_neighbor_sample(indptr, indices, owner, local, rand)


def test_launch_count_is_exact_under_concurrent_launches():
    """Prefetch threads launch the routed sampler concurrently: with a
    thread switch forced every microsecond, no increment is lost."""
    k = CudaKernel("probe", "csrc/gather_rows.cu", "gather_rows", [])
    n_threads, per_thread = 16, 2_000

    def launch_many():
        for _ in range(per_thread):
            k.count_launch()

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=launch_many)
                   for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert k.launches == n_threads * per_thread


def test_routed_kernels_on_cpu_count_no_launches_and_empty_is_empty():
    before = (gather.ROUTED_KERNEL.launches, gather.SAMPLE_KERNEL.launches)
    stack, owner, local = _routed_gather_case(2, 4, 8, 5, torch.float32)
    shards = _as_shards(stack)
    got = gather.routed_gather(shards, owner, local)
    assert torch.equal(got, tref.routed_gather_dense(stack, owner, local))
    case = _sample_case(2, 6, 4, 3)
    got = gather.routed_neighbor_sample(*_as_shards(*case[:2]), *case[2:])
    assert torch.equal(got, tref.routed_neighbor_sample_dense(*case))
    assert tuple(gather.routed_gather(shards, owner[:0], local[:0]).shape) \
        == (0, 8)
    assert (gather.ROUTED_KERNEL.launches,
            gather.SAMPLE_KERNEL.launches) == before


@pytest.mark.gpu
@pytest.mark.parametrize("k,R,D,n", [(2, 12, 32, 50), (4, 7, 100, 33),
                                     (2, 250_000, 128, 140_032)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_routed_gather_matches_plain_version(cuda_device, k, R, D, n,
                                                  dtype):
    args = _routed_gather_case(k, R, D, n, dtype, device=cuda_device)
    snap = [a.clone() for a in args]
    shards = _as_shards(args[0])
    before = gather.ROUTED_KERNEL.launches
    got = gather.routed_gather(shards, *args[1:])
    torch.cuda.synchronize()
    assert gather.ROUTED_KERNEL.launches == before + 1
    assert torch.equal(got, tref.routed_gather_dense(*args))
    assert torch.equal(got, tref.routed_gather_peer(shards, *args[1:]))
    assert all(torch.equal(a, b) for a, b in zip(shards, snap[0]))
    assert all(torch.equal(a, b) for a, b in zip(args[1:], snap[1:]))


@pytest.mark.gpu
@pytest.mark.parametrize("k,R,n,f", [(2, 6, 4, 3), (4, 300, 77, 5),
                                     (2, 200_000, 2_000, 25),
                                     (2, 200_000, 50_000, 10)])
def test_cuda_routed_sample_matches_plain_version(cuda_device, k, R, n, f):
    args = _sample_case(k, R, n, f, device=cuda_device)
    shards = _as_shards(*args[:2])
    before = gather.SAMPLE_KERNEL.launches
    hops = gather.SAMPLE_KERNEL.route_launches["hop"]
    got = gather.routed_neighbor_sample(*shards, *args[2:])
    torch.cuda.synchronize()
    assert gather.SAMPLE_KERNEL.launches == before + 1
    assert gather.SAMPLE_KERNEL.route_launches["hop"] == hops + 1
    assert torch.equal(got, tref.routed_neighbor_sample_dense(*args))
    assert torch.equal(got, tref.routed_neighbor_sample_peer(*shards,
                                                             *args[2:]))


@pytest.mark.gpu
def test_cuda_mesh_binds_existing_cards_and_refuses_missing_ones(
        cuda_device):
    from repro_torch.launch.mesh import make_data_mesh, make_hierarchical_mesh

    mesh = make_hierarchical_mesh([[0, 1], [2, 3]])
    assert {mesh.device(ci, gi) for ci, gi in mesh.positions()} == \
        {torch.device("cuda", 0)}
    missing = f"cuda:{torch.cuda.device_count()}"
    with pytest.raises(ValueError, match="CUDA device"):
        make_hierarchical_mesh([[0, 1]], devices=["cuda:0", missing])
    with pytest.raises(ValueError, match="CUDA device"):
        make_data_mesh(2, devices=["cuda:0", missing])
    with pytest.raises(ValueError, match="mix device types"):
        make_data_mesh(2, devices=["cuda:0", "cpu"])


@pytest.mark.gpu
def test_cuda_sharded_training_is_repeatable_and_near_the_device_backend(
        cuda_device):
    """On the card, a 2 x 2 hierarchy: two sharded runs are bitwise equal,
    their losses are within 1e-4 of the device backend's with identical
    traffic and refreshes, and every step launches the routed gather once
    per mesh position and every spec build the routed sampler once, on its
    ``chain`` route (the fused finalize never runs)."""
    from repro_torch.core.cache_manager import RefreshConfig
    from repro_torch.core.cliques import topology_matrix
    from repro_torch.core.planner import build_plan
    from repro_torch.core.unified_cache import TrafficCounter
    from repro_torch.graph.csr import powerlaw_graph
    from repro_torch.models.gnn import GNNConfig
    from repro_torch.train.loop import train_gnn

    g = powerlaw_graph(3000, 8, seed=9, feat_dim=16)
    cfg = GNNConfig(feat_dim=16, hidden=32, batch_size=64, fanouts=(4, 2),
                    lr=3e-3)
    steps = 8

    def run(backend):
        plan = build_plan(g, topology_matrix("dgx-v100", 4),
                          mem_per_device=30_000, batch_size=64, seed=0,
                          fanouts=cfg.fanouts)
        counter = TrafficCounter.for_plan(plan)
        before = {k.name: k.kernel.launches for k in KERNELS}
        routes = dict(gather.SAMPLE_KERNEL.route_launches)
        res = train_gnn(g, plan, cfg, steps=steps, seed=0,
                        device=cuda_device, backend=backend, counter=counter,
                        refresh_config=RefreshConfig(interval=4,
                                                     drift_threshold=1.0))
        torch.cuda.synchronize()
        launched = {k.name: k.kernel.launches - before[k.name]
                    for k in KERNELS}
        launched["sample_routes"] = {
            r: n - routes[r]
            for r, n in gather.SAMPLE_KERNEL.route_launches.items()}
        return res, counter, launched, plan

    dev, dc, dl, _ = run("device")
    s1, sc, sl, plan = run("sharded")
    s2, _, _, _ = run("sharded")
    assert s1.losses == s2.losses and s1.accs == s2.accs
    np.testing.assert_allclose(s1.losses, dev.losses, rtol=0, atol=1e-4)
    np.testing.assert_allclose(s1.accs, dev.accs, rtol=0, atol=1e-6)
    assert s1.refresh == dev.refresh and s1.refresh["admitted"] > 0
    np.testing.assert_array_equal(sc.bytes_matrix, dc.bytes_matrix)
    np.testing.assert_array_equal(sc.topo_bytes_matrix, dc.topo_bytes_matrix)
    assert sc.cross_clique_bytes(plan.partition.cliques) == 0
    assert sl["routed_gather"] == 4 * steps
    # one chain launch per spec build (4 positions a step), all hops in it
    assert sl["routed_neighbor_sample"] == 4 * steps
    assert sl["sample_routes"] == {"hop": 0, "chain": 4 * steps}
    assert sl["fused_gather_overlay"] == 0
    assert dl["fused_gather_overlay"] == 4 * steps
    assert dl["routed_neighbor_sample"] == sl["routed_neighbor_sample"]
    assert dl["sample_routes"] == sl["sample_routes"]
