"""The port's dry-run tooling (``repro_torch.launch.{specs,variants,dryrun}``
and the counter's totals) against the reference's ``launch/`` on the CPU.

* Cells: ``build_cell``'s name, kind and argument tree (keys, shapes,
  dtypes) equal the reference's ``ShapeDtypeStruct``s for every smoke
  config at every kind, but for the stated differences: the port's tokens
  are int64 (the reference's int32), and AdamW's count, the step and the
  decode position are host ints (the reference's int32 scalars).
* Results: for the gemma3, phi3.5-moe, mamba2 and seamless smoke configs,
  the port's cell function on the reference's seed-0 parameters gives the
  reference's ``jax.jit(cell.fn)`` results: the train step's loss and new
  parameters, the prefill's logits and cache, the decode's logits.
* Counts: each smoke cell's matrix-product flops at the reference's HLO
  count (the attention kernels' every key block) within 2% of the
  reference's dot flops from ``HloCost`` under ``runtime_flags.unrolled``
  (equal but where named), and ``argument_bytes`` equal to its compiled
  ``memory_analysis()`` but for the stated token and scalar bytes and the
  arguments XLA drops because the step never reads them.
* ``model_flops_estimate`` bitwise the reference's for all ten full
  configs at all four shapes; ``VARIANTS`` and the skipped record equal.
"""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import SHAPES as JSHAPES
from repro.configs.base import ShapeConfig as JShape
from repro.launch import hlo_cost
from repro.launch import specs as jspecs
from repro.launch import variants as jvariants
from repro.models import get_module as jget_module
from repro.models import runtime_flags
from repro.models.params import init_from_defs as jinit_from_defs
from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun, specs, variants
from repro_torch.models.convert import params_from_jax
from repro_torch.train.optimizer import adamw

S, B, SEED = 32, 2, 0
KINDS = ("train", "prefill", "decode")
LR = 3e-4  # build_cell's, as the reference's
# the LM tolerances of tests/test_torch_lm.py and tests/test_torch_lm_train.py
LOSS_TOL = {"rtol": 3e-2, "atol": 6e-2}
LOGIT_TOL = {"rtol": 3e-2, "atol": 6e-2}
# seamless-smoke's decode logits: twice the LM atol, as tests/test_torch_
# encdec.py holds them (the reference's own jit and op-by-op runs differ by
# more than the LM tolerance there: ROADMAP section 3, finding 12)
DECODE_TOL = {"seamless-m4t-large-v2": {"rtol": 3e-2, "atol": 1.2e-1}}
# the SSM state h within 1e-5 of its largest entry (tests/test_torch_ssm.py)
H_TOL_OF_MAX = 1e-5
RESULT_ARCHS = ("gemma3-1b", "phi3.5-moe-42b-a6.6b", "mamba2-780m",
                "seamless-m4t-large-v2")


def _shape(kind):
    return ShapeConfig(kind, S, B, kind), JShape(kind, S, B, kind)


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    elif isinstance(tree, (tuple, list)):
        for i, t in enumerate(tree):
            yield from _leaves(t, prefix + (i,))
    else:
        yield prefix, tree


@functools.lru_cache(maxsize=None)
def _reference(arch: str, kind: str):
    """The reference's cell of the smoke config, compiled as its dry-run
    compiles it (state or cache donated) with every scan unrolled."""
    jcfg = jconfigs.get_config(arch, smoke=True)
    cell = jspecs.build_cell(jcfg, _shape(kind)[1], None)
    donate = {"train": (0,), "prefill": (), "decode": (1,)}[kind]
    with runtime_flags.unrolled(True):
        compiled = jax.jit(cell.fn, donate_argnums=donate).lower(
            *cell.args).compile()
    return cell, compiled


@functools.lru_cache(maxsize=None)
def _port(arch: str, kind: str):
    cell = specs.build_cell(get_config(arch, smoke=True), _shape(kind)[0])
    summary, mem, _ = dryrun.account(cell)
    return cell, summary, mem


# ------------------------------------------------------------- cells -----

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cells_match_the_references(arch):
    """Name, kind and every argument's tree path, shape and dtype; tokens
    int64 where the reference's are int32; AdamW's count, the step and the
    decode position host ints where the reference's are int32 scalars."""
    # the tokens' int64 stands for the reference's int32
    dtypes = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
              torch.int64: jnp.int32}
    for kind in KINDS:
        jcell = jspecs.build_cell(jconfigs.get_config(arch, smoke=True),
                                  _shape(kind)[1], None)
        cell = specs.build_cell(get_config(arch, smoke=True), _shape(kind)[0])
        assert (cell.name, cell.meta) == (jcell.name, jcell.meta)
        assert cell.out_shardings is None
        assert len(cell.args) == len(jcell.args)
        mine = dict(_leaves(cell.args))
        theirs = dict(_leaves(jcell.args))
        assert mine.keys() == theirs.keys(), kind
        for path, t in mine.items():
            ref = theirs[path]
            if isinstance(t, int):  # count, step, pos
                assert (ref.shape, ref.dtype) == ((), jnp.int32), path
                continue
            assert t.device.type == "meta", path
            assert tuple(t.shape) == tuple(ref.shape), path
            assert jnp.dtype(dtypes[t.dtype]) == jnp.dtype(ref.dtype), \
                (path, t.dtype, ref.dtype)


# ----------------------------------------------------------- results -----

def _ref_params(arch):
    cfg = jconfigs.get_config(arch, smoke=True)
    p = jinit_from_defs(jget_module(cfg).defs(cfg), jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, p)


def _batch(cfg, kind, rng):
    """numpy inputs of the cell: tokens (and labels), the encoder-decoder's
    frames (bf16-representable f32) and target tokens."""
    out = {}
    seq = S
    if cfg.family in ("audio", "encdec"):
        out["frames"] = np.asarray(jnp.asarray(
            rng.normal(size=(B, S, cfg.d_model)), jnp.bfloat16)
            .astype(jnp.float32))
        seq = max(S // cfg.target_ratio, 16)
    out["tokens"] = rng.integers(0, cfg.vocab_size, (B, seq))
    if kind == "train":
        out["labels"] = rng.integers(0, cfg.vocab_size, (B, seq))
    return out


def _torch_batch(batch):
    return {k: (torch.from_numpy(v).to(torch.bfloat16) if k == "frames"
                else torch.from_numpy(v)) for k, v in batch.items()}


def _jax_batch(batch):
    return {k: (jnp.asarray(v, jnp.bfloat16) if k == "frames"
                else jnp.asarray(v, jnp.int32)) for k, v in batch.items()}


def _f32(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(jnp.asarray(t, jnp.float32))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", RESULT_ARCHS)
def test_cell_results_match_the_references(arch, kind):
    """The port's cell function on the reference's seed-0 parameters
    against the reference's compiled cell on the same numpy inputs.  Train:
    the loss within the LM tolerance, and the new parameters within 2.1 lr
    of the reference's (AdamW's first step moves each entry by about lr
    times the sign of its gradient, so an entry near zero that rounds to
    the other sign lands 2 lr away).  Prefill: the last logits within the
    LM tolerance, the KV caches within the serving tests' 3e-2 / 6e-2, the
    SSM state within 1e-5 of its largest entry.  Decode (one step at
    position 0 over a zero cache): the logits."""
    cfg = get_config(arch, smoke=True)
    jcell, compiled = _reference(arch, kind)
    cell = specs.build_cell(cfg, _shape(kind)[0])
    rng = np.random.default_rng(SEED)
    np_params = _ref_params(arch)
    params = params_from_jax(np_params, "cpu")
    jp = jax.tree_util.tree_map(jnp.asarray, np_params)
    if kind == "train":
        batch = _batch(cfg, kind, rng)
        opt = adamw(LR)
        state = {"params": params, "opt": opt.init(params), "step": 0}
        new, aux = cell.fn(state, _torch_batch(batch))
        jopt = jspecs.adamw(LR)
        jnew, jaux = compiled({"params": jp, "opt": jopt.init(jp),
                               "step": jnp.int32(0)}, _jax_batch(batch))
        np.testing.assert_allclose(float(aux["loss"]), float(jaux["loss"]),
                                   **LOSS_TOL)
        assert new["step"] == 1 and new["opt"]["count"] == 1
        for (path, t), (_, r) in zip(_leaves(new["params"]),
                                     _leaves(jnew["params"])):
            np.testing.assert_allclose(_f32(t), _f32(r), rtol=0,
                                       atol=2.1 * LR, err_msg=str(path))
        return
    if kind == "prefill":
        batch = _batch(cfg, kind, rng)
        with torch.no_grad():
            logits, cache = cell.fn(params, _torch_batch(batch))
        jlogits, jcache = compiled(jp, _jax_batch(batch))
        np.testing.assert_allclose(_f32(logits), _f32(jlogits), **LOGIT_TOL)
        assert cache.keys() == jcache.keys()
        for name, t in cache.items():
            ref = _f32(jcache[name])
            assert tuple(t.shape) == ref.shape, name
            if name == "h":
                err = np.abs(_f32(t) - ref).max() / np.abs(ref).max()
                assert err <= H_TOL_OF_MAX, err
            else:
                np.testing.assert_allclose(_f32(t), ref, rtol=3e-2,
                                           atol=6e-2, err_msg=name)
        return
    cache = {k: torch.zeros(t.shape, dtype=t.dtype) for k, t in
             cell.args[1].items()}
    tokens = rng.integers(0, cfg.vocab_size, (B, 1))
    with torch.no_grad():
        logits, _ = cell.fn(params, cache, torch.from_numpy(tokens), 0)
    jcache = jax.tree_util.tree_map(
        lambda s: jnp.zeros(s.shape, s.dtype), jcell.args[1])
    jlogits, _ = compiled(jp, jcache, jnp.asarray(tokens, jnp.int32),
                          jnp.int32(0))
    np.testing.assert_allclose(_f32(logits), _f32(jlogits),
                               **DECODE_TOL.get(arch, LOGIT_TOL))


# ------------------------------------------------------------ counts -----

def _dot_flops(compiled) -> float:
    """The reference's ``HloCost`` flops with the elementwise set empty:
    its dot flops alone, every while body times its trip count."""
    old = hlo_cost._ELEMENTWISE_FLOP_OPS
    hlo_cost._ELEMENTWISE_FLOP_OPS = set()
    try:
        return hlo_cost.analyze(compiled.as_text())["flops"]
    finally:
        hlo_cost._ELEMENTWISE_FLOP_OPS = old


def _unembed_flops(cfg, rows: int) -> int:
    return 2 * rows * cfg.d_model * cfg.padded_vocab


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_matmul_flops_match_the_references_dot_flops(arch):
    """Each smoke cell's matrix-product flops at the reference's HLO count
    (``hlo_matmul_flops``: the attention kernels' by every key block of the
    reference's scan, whatever the mask) against the reference's dot flops: equal, but (1) the encoder-decoder's
    prefill, where the reference's serving cell unembeds every target
    position (``decode_train``) and keeps the last, and ``encdec.prefill``
    unembeds the last alone: exactly B * (St - 1) positions' unembedding
    less (XLA merges the cross k and v that cell projects twice); (2) the
    SSM and hybrid train steps, within 2%: the SSD's backward.  The
    reference writes the SSD's products as three-operand einsums
    (``bcqhn,bchnp,bcqh->bcqhp``), whose gradients XLA contracts in another
    order than autograd does through the port's two-operand products
    (measured: 65,536 of 38.4 M flops, -0.17%, for mamba2-smoke; -0.15% for
    zamba2-smoke)."""
    cfg = get_config(arch, smoke=True)
    for kind in KINDS:
        ref = _dot_flops(_reference(arch, kind)[1])
        mine = sum(_port(arch, kind)[1]["hlo_matmul_flops"].values())
        if cfg.family in ("audio", "encdec") and kind == "prefill":
            St = max(S // cfg.target_ratio, 16)
            assert mine == ref - _unembed_flops(cfg, B * (St - 1))
        elif cfg.family in ("ssm", "hybrid") and kind == "train":
            assert abs(mine - ref) <= 0.02 * ref
            assert mine != ref
        else:
            assert mine == ref, kind


def _unread_bytes(arch, kind, cell) -> int:
    """Argument bytes the reference's compiled step drops because it never
    reads them: the decode position of the pure SSM (no attention), and in
    the encoder-decoder's decode step the encoder's parameters and every
    decoder layer's cross k and v projections (their products sit in the
    cache)."""
    if kind != "decode":
        return 0
    cfg = get_config(arch, smoke=True)
    if cfg.family == "ssm":
        return 4
    if cfg.family in ("audio", "encdec"):
        p = cell.args[0]
        unread = [p["enc_layers"], p["frontend_proj"], p["enc_norm"],
                  p["dec_layers"]["cross"]["wk"],
                  p["dec_layers"]["cross"]["wv"]]
        return sum(t.numel() * t.element_size() for _, t in _leaves(unread))
    return 0


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_argument_bytes_match_the_references_memory_analysis(arch):
    """``argument_bytes`` against the reference's compiled
    ``memory_analysis().argument_size_in_bytes``: the port's tokens take 4
    more bytes each (int64), its AdamW count and step (train) and decode
    position are host ints (the reference's 4-byte scalars), and the
    reference's count leaves out what ``_unread_bytes`` names."""
    for kind in KINDS:
        cell, _, mem = _port(arch, kind)
        ref = _reference(arch, kind)[1].memory_analysis() \
            .argument_size_in_bytes
        tokens = sum(t.numel() for p, t in _leaves(cell.args)
                     if isinstance(t, torch.Tensor) and t.dtype == torch.int64)
        scalars = {"train": 8, "prefill": 0, "decode": 4}[kind]
        unread = _unread_bytes(arch, kind, cell)
        if get_config(arch, smoke=True).family == "ssm" and kind == "decode":
            scalars, unread = 0, 0  # the position is the unread argument
        assert mem["argument_bytes"] == ref + 4 * tokens - scalars + unread, \
            kind


# ------------------------------------------------- the dry-run's pieces --

@pytest.fixture(scope="module")
def reference_dryrun():
    """The reference's ``launch/dryrun.py`` sets ``XLA_FLAGS`` to 512 host
    devices when imported; import it after JAX's backend is up (so the flag
    changes nothing here) and put the environment back."""
    jax.devices()
    old = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as jdryrun
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    return jdryrun


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_estimate_is_bitwise_the_references(arch,
                                                        reference_dryrun):
    for name in SHAPES:
        mine = dryrun.model_flops_estimate(get_config(arch), SHAPES[name])
        theirs = reference_dryrun.model_flops_estimate(
            jconfigs.get_config(arch), JSHAPES[name])
        assert mine == theirs, name
        assert all(type(mine[k]) is type(theirs[k]) for k in mine)


def test_variants_are_the_references():
    assert variants.VARIANTS == jvariants.VARIANTS
    cfg = get_config("gemma3-1b")
    for name in variants.VARIANTS:
        a = variants.apply_variant(cfg, name)
        b = jvariants.apply_variant(jconfigs.get_config("gemma3-1b"), name)
        assert {f: getattr(a, f) for f in jvariants.VARIANTS[name]} == \
            {f: getattr(b, f) for f in jvariants.VARIANTS[name]}


def test_skipped_record_is_the_references(reference_dryrun):
    """A full-attention arch at ``long_500k``: the reference's record, from
    its own ``run_cell`` (which writes nothing without ``out_path`` and
    returns before building a mesh)."""
    for arch in ("dbrx-132b", "qwen2.5-14b"):
        assert dryrun.run_cell(arch, "long_500k") == \
            reference_dryrun.run_cell(arch, "long_500k", "single")
