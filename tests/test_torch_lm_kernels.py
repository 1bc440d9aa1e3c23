"""The LM path's kernels against the reference package's and against their
plain versions.

CPU: the plain versions (``kernels/ref.py``) against the reference —
``flash_attention`` over the Pallas test's grid (``tests/test_kernels.py``
``test_flash_matches_ref``: its jnp oracle and its Pallas kernel in
interpret mode) and against the LM path's chunked attention
(``repro.models.layers.flash_attention``) with GQA, windows and a ragged
length; ``sage_aggregate`` over the Pallas test's grid.

GPU (``gpu``-marked, skipped without a card): each CUDA kernel against its
plain version on the card.  The reference package is imported inside the
CPU tests only, so the ``gpu`` tests run on a GPU host that has no JAX:
``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_lm_kernels.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref as tref
from repro_torch.kernels import sage_agg

BIG_WINDOW = 1 << 30
# the CUDA flash kernel against its plain version (see
# test_cuda_flash_matches_plain_version)
CUDA_TOL = {torch.bfloat16: dict(rtol=1e-2, atol=2e-3),
            torch.float32: dict(rtol=1e-3, atol=2e-4)}


def _reference():
    """(jax.numpy, the reference's Pallas ops, its jnp oracles, its LM
    layers)."""
    import jax.numpy as jnp

    from repro.kernels import ops, ref
    from repro.models import layers

    return jnp, ops, ref, layers


def _to_jax(t: torch.Tensor):
    """The same bits on the JAX side (bf16 through its 16-bit pattern)."""
    jnp = _reference()[0]
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.view(torch.int16).numpy().view(jnp.bfloat16))
    return jnp.asarray(t.numpy())


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().cpu().numpy()
    return np.asarray(x, np.float32)


def _randn(rng, shape, dtype, scale=1.0, device="cpu"):
    x = rng.standard_normal(shape).astype(np.float32) * scale
    return torch.from_numpy(x).to(dtype).to(device)


def _qkv(seed, B, S, Hq, Hkv, Dh, dtype, device="cpu", Sk=None):
    rng = np.random.default_rng(seed)
    Sk = S if Sk is None else Sk
    return (_randn(rng, (B, S, Hq, Dh), dtype, device=device),
            _randn(rng, (B, Sk, Hkv, Dh), dtype, device=device),
            _randn(rng, (B, Sk, Hkv, Dh), dtype, device=device))


# ------------------------------------------------------------------ CPU ----

@pytest.mark.parametrize("BH,S,Dh", [(4, 256, 64), (2, 128, 128),
                                     (1, 384, 128)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_flash_matches_pallas_and_oracle(BH, S, Dh, causal, dtype):
    """The TPU kernel's contract (BH, S, Dh), the Pallas test's grid and
    inputs (q, k scaled by 0.5) and tolerances: 2e-3 in f32 (summation
    order), 2e-2 in bf16 (the plain version rounds q * scale and p to bf16
    as the LM path does; the Pallas kernel and the oracle keep them f32)."""
    jnp, jops, jref, _ = _reference()
    rng = np.random.default_rng(2)
    q = _randn(rng, (BH, S, Dh), dtype, 0.5)
    k = _randn(rng, (BH, S, Dh), dtype, 0.5)
    v = _randn(rng, (BH, S, Dh), dtype)
    got = fa.flash_attention_bhsd(q, k, v, causal=causal)
    assert got.shape == q.shape and got.dtype == dtype
    tol = 2e-3 if dtype == torch.float32 else 2e-2
    args = tuple(_to_jax(t) for t in (q, k, v))
    for want in (jops.flash_attention(*args, causal=causal),
                 jref.flash_attention(*args, causal=causal)):
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("Hkv,causal,Dh", [(1, True, 16), (2, False, 80),
                                            (4, True, 128)])
@pytest.mark.parametrize("window", [0, 8, BIG_WINDOW])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_flash_matches_lm_path_attention(Hkv, causal, Dh, window,
                                               dtype):
    """GQA (4 query heads over 1, 2 or 4 kv heads), no window / window 8 /
    the global layers' BIG_WINDOW, a ragged S = 37 over key blocks of 16
    (so the last block is padded), head dims 16, 80 (a scale that bf16
    rounds) and 128.  f32 within 1e-5 (einsum order); bf16 within one bf16
    step of |o| < 2 (1e-2): both round q * scale and p at the same points,
    only the f32 sums' order differs."""
    _, _, _, jlayers = _reference()
    q, k, v = _qkv(7 + Hkv, 2, 37, 4, Hkv, Dh, dtype)
    got = fa.flash_attention(q, k, v, causal=causal, window=window,
                             block_kv=16)
    want = jlayers.flash_attention(
        *(_to_jax(t) for t in (q, k, v)), causal=causal, window=window,
        block_kv=16)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("N,D,B,F", [(64, 128, 8, 5), (128, 256, 16, 10),
                                     (32, 128, 4, 25)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_sage_matches_pallas_and_oracle(N, D, B, F, dtype):
    """The Pallas test's grid.  f32 within 1e-5 (the reference may contract
    multiply and add into one FMA, the oracle sums with an einsum); bf16
    within one bf16 step (1e-2 relative) of the same f32 sums."""
    jnp, jops, jref, _ = _reference()
    rng = np.random.default_rng(1)
    table = _randn(rng, (N, D), dtype)
    idx = rng.integers(-1, N, size=(B, F)).astype(np.int32)
    w = rng.random((B, F)).astype(np.float32)
    got = sage_agg.sage_aggregate(table, torch.from_numpy(idx),
                                  torch.from_numpy(w))
    assert got.shape == (B, D) and got.dtype == dtype
    args = (_to_jax(table), jnp.asarray(idx), jnp.asarray(w))
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    for want in (jops.sage_aggregate(*args), jref.sage_aggregate(*args)):
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


def test_plain_sage_edge_cases():
    """A row of pads only is zero, F = 1 is a weighted gather, an index
    past the end reads the last row."""
    table = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    idx = torch.tensor([[-1, -1], [2, -1], [9, 0]], dtype=torch.int32)
    w = torch.tensor([[1.0, 2.0], [0.5, 3.0], [1.0, 2.0]])
    out = sage_agg.sage_aggregate(table, idx, w)
    assert torch.equal(out[0], torch.zeros(3))
    assert torch.equal(out[1], 0.5 * table[2])
    assert torch.equal(out[2], table[3] + 2.0 * table[0])
    one = sage_agg.sage_aggregate(table, idx[:, :1], w[:, :1])
    assert torch.equal(one[1], 0.5 * table[2])


def test_cpu_tensors_take_the_plain_path_without_counting_launches():
    q, k, v = _qkv(0, 1, 8, 2, 1, 16, torch.float32)
    before = (fa.KERNEL.launches, sage_agg.KERNEL.launches)
    fa.flash_attention(q, k, v)
    sage_agg.sage_aggregate(q[0, :, 0], torch.zeros((2, 3), dtype=torch.int32),
                            torch.ones((2, 3)))
    assert (fa.KERNEL.launches, sage_agg.KERNEL.launches) == before


@pytest.mark.parametrize("bad,err", [
    (dict(Dh=24), ValueError),      # not a multiple of 16
    (dict(Dh=272), ValueError),     # past 256
    (dict(Hkv=3), ValueError),      # 4 query heads over 3 kv heads
    (dict(dtype=torch.float16), TypeError),
])
def test_flash_wrapper_rejects_what_the_kernel_does_not_take(bad, err):
    kw = dict(Dh=16, Hkv=1, dtype=torch.float32) | bad
    q, k, v = _qkv(0, 1, 8, 4, kw["Hkv"], kw["Dh"], kw["dtype"])
    with pytest.raises(err):
        fa.flash_attention(q, k, v)


def test_wrappers_reject_mixed_types_and_shapes():
    q, k, v = _qkv(0, 1, 8, 2, 1, 16, torch.float32)
    with pytest.raises(TypeError):
        fa.flash_attention(q, k.to(torch.bfloat16), v)
    with pytest.raises(ValueError):
        fa.flash_attention(q, k[:, :, :, :8].contiguous(), v)
    with pytest.raises(ValueError):
        fa.flash_attention_bhsd(q, k, v)
    table = torch.zeros((4, 3))
    with pytest.raises(TypeError):
        sage_agg.sage_aggregate(table, torch.zeros((2, 2), dtype=torch.int64),
                                torch.ones((2, 2)))
    with pytest.raises(ValueError):
        sage_agg.sage_aggregate(table, torch.zeros((2, 2), dtype=torch.int32),
                                torch.ones((2, 3)))


# ------------------------------------------------------------------ GPU ----

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU host)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,Hq,Hkv,Dh,window,causal", [
    (2, 256, 4, 1, 256, 512, True),          # gemma3: a local layer
    (2, 300, 4, 1, 256, BIG_WINDOW, True),   # gemma3: a global layer
    (1, 1000, 4, 1, 256, 1, True),           # ragged, window 1
    (1, 1000, 4, 4, 128, 0, True),           # ragged, G = 1
    (2, 130, 8, 2, 80, 64, True),            # stablelm's Dh
    (1, 77, 4, 1, 16, 8, False),             # the smoke configs' Dh
    (1, 200, 4, 1, 64, 0, False),
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_flash_matches_plain_version(cuda_device, B, S, Hq, Hkv, Dh,
                                          window, causal, dtype):
    """bf16 within rtol 1e-2 + atol 2e-3 (p is rounded to bf16 against
    another running max and summed in another order, and the output is
    rounded to bf16: one step is at most 2**-7 relative; the absolute part
    covers outputs near 0, and is well below the 0.03 of a typical output
    of a row over 2048 keys);
    f32 within rtol 1e-3 + atol 2e-4 (summation order only)."""
    q, k, v = _qkv(S, B, S, Hq, Hkv, Dh, dtype, device=cuda_device)
    before = fa.KERNEL.launches
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.KERNEL.launches == before + 1
    want = tref.flash_attention(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(got.float(), want.float(), **CUDA_TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_bhsd_matches_plain_version(cuda_device, causal, dtype):
    rng = np.random.default_rng(2)
    q, k, v = (_randn(rng, (4, 256, 64), dtype, s, cuda_device)
               for s in (0.5, 0.5, 1.0))
    got = fa.flash_attention_bhsd(q, k, v, causal=causal)
    want = tref.flash_attention(q, k, v, causal=causal)
    torch.testing.assert_close(got.float(), want.float(), **CUDA_TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(0, 64, 4, 256), (2, 0, 4, 256),
                                   (2, 64, 0, 256)])
def test_cuda_flash_of_no_queries_launches_nothing(cuda_device, shape):
    """An empty q gives an empty output without a launch: the launch count
    is the count of kernels that ran."""
    B, S, Hq, Dh = shape
    q = torch.zeros(shape, dtype=torch.bfloat16, device=cuda_device)
    k = v = torch.zeros((B, 64, 1, Dh), dtype=torch.bfloat16,
                        device=cuda_device)
    before = fa.KERNEL.launches
    got = fa.flash_attention(q, k, v, window=8)
    torch.cuda.synchronize()
    assert fa.KERNEL.launches == before
    assert got.shape == shape and got.dtype == torch.bfloat16


@pytest.mark.gpu
@pytest.mark.parametrize("N,D,B,F", [(64, 128, 8, 5), (1000, 100, 333, 1),
                                     (416_768, 128, 20_000, 10)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_sage_matches_plain_version_bitwise(cuda_device, N, D, B, F,
                                                 dtype):
    rng = np.random.default_rng(N)
    table = _randn(rng, (N, D), dtype, device=cuda_device)
    idx = rng.integers(-1, N, size=(B, F)).astype(np.int32)
    idx[0] = -1  # a row of pads only
    idx = torch.from_numpy(idx).to(cuda_device)
    w = torch.from_numpy(rng.random((B, F)).astype(np.float32)).to(cuda_device)
    before = sage_agg.KERNEL.launches
    got = sage_agg.sage_aggregate(table, idx, w)
    torch.cuda.synchronize()
    assert sage_agg.KERNEL.launches == before + 1
    assert torch.equal(got, tref.sage_aggregate(table, idx, w))
    assert not got[0].any()


@pytest.mark.gpu
def test_cuda_generate_matches_the_plain_path_on_the_cpu(cuda_device):
    """The gemma3 smoke config served on the card (the flash kernel, cuBLAS)
    and on the CPU (the plain version): the same weights, the card's decode
    steps fed the CPU's greedy tokens; logits within atol 5e-3 (bf16
    activations rounded at other points over 3 layers: measured one bf16
    step, 9.8e-4, at logits of about 0.16)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve_lm import generate
    from repro_torch.models import transformer
    from repro_torch.models.params import init_from_defs

    cfg = get_config("gemma3-1b", smoke=True)
    params = init_from_defs(transformer.defs(cfg),
                            torch.Generator().manual_seed(0), "cpu")
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, (4, 24))
    cpu = generate(cfg, params, prompts, 16, device="cpu")
    gpu_params = {k: (v.to(cuda_device) if isinstance(v, torch.Tensor)
                      else {n: t.to(cuda_device) for n, t in v.items()})
                  for k, v in params.items()}
    tokens = cpu.tokens.to(cuda_device)
    before = fa.KERNEL.launches
    with torch.inference_mode():
        logits, cache = transformer.prefill(
            cfg, gpu_params, torch.as_tensor(prompts, device=cuda_device),
            max_len=24 + 16)
        outs = [logits[:, -1:, :cfg.vocab_size]]
        for i in range(15):
            logits, cache = transformer.decode_step(
                cfg, gpu_params, cache, tokens[:, i:i + 1], 24 + i)
            outs.append(logits[:, :, :cfg.vocab_size])
    assert fa.KERNEL.launches == before + cfg.n_layers
    torch.testing.assert_close(torch.cat(outs, 1).float().cpu(),
                               cpu.logits.float(), rtol=0, atol=5e-3)
