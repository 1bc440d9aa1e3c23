"""The port's LM training path against the reference package's.

For every dense smoke config: ``transformer.loss_fn`` and its gradients
against ``jax.value_and_grad`` of the reference's ``loss_fn`` on the same
numpy batch and the reference's own initial weights (``params_from_jax``);
remat on and off bitwise; ``loss_chunk`` against the unchunked loss; four
``train_step``s against the same steps rebuilt from the reference's
``loss_fn``, ``adamw`` and ``apply_updates``; and the training CLI
(``python -m repro_torch.launch.train``) on the CPU, LM and GNN.  On the
CPU the attention runs its plain versions (forward and backward).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import get_module as jget_module
from repro.models.params import init_from_defs as jinit_from_defs
from repro.models.sharding import Distribution
from repro.train import optimizer as joptimizer
from repro_torch import configs as tconfigs
from repro_torch.launch import train as tlaunch
from repro_torch.models import transformer
from repro_torch.models.convert import params_from_jax
from repro_torch.train import optimizer as toptimizer

DENSE = ("stablelm-3b", "minitron-4b", "gemma3-1b", "qwen2.5-14b")
DIST = Distribution.single_device()
B, S, SEED = 2, 32, 0
# the loss: the LM tolerance of the serving tests (bf16 activations, which
# XLA rounds once per fused chain and torch after each op)
LOSS_ATOL, LOSS_RTOL = 6e-2, 3e-2
# gradients: per leaf, |g_port - g_ref| / |g_ref| (Frobenius norms) within
# GRAD_REL.  Measured on the CPU: gemma3 3.5e-2 at its q_norm gain (16 values, each
# a sum of bf16-rounded terms over every position), the other configs
# 1.5e-2 to 2.1e-2 (the bf16 activations' rounding, carried back through 2-3
# layers); a wrong gradient is off by O(1).  The attention's own backward
# (its plain version against autograd through the plain forward) differs
# by about 3e-3 relative in bf16 (tests/test_torch_lm_kernels.py).
GRAD_REL = 5e-2


def _flatten(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], prefix + (k,))
    else:
        yield prefix, tree


@functools.lru_cache(maxsize=None)
def _reference_params(arch: str):
    cfg = jconfigs.get_config(arch, smoke=True)
    params = jinit_from_defs(jget_module(cfg).defs(cfg), jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, params)


def _batch(cfg, step: int = 0):
    return tlaunch.make_batch(cfg, B, S, SEED, step, device="cpu")


def _jbatch(batch):
    return {k: jnp.asarray(v.numpy()) for k, v in batch.items()}


def _port_loss_and_grads(cfg, params, batch):
    leaves = toptimizer.tree_map(lambda p: p.detach().requires_grad_(),
                                 params)
    loss, metrics = transformer.loss_fn(cfg, leaves, batch)
    loss.backward()
    return loss.detach(), metrics, toptimizer.tree_map(lambda p: p.grad,
                                                       leaves)


@functools.lru_cache(maxsize=None)
def _reference_loss_and_grads(arch: str, loss_chunk: int = 0):
    cfg = dataclasses.replace(jconfigs.get_config(arch, smoke=True),
                              loss_chunk=loss_chunk)
    mod = jget_module(cfg)
    batch = _jbatch(_batch(tconfigs.get_config(arch, smoke=True)))
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p: mod.loss_fn(cfg, p, batch, dist=DIST), has_aux=True))(
            jax.tree_util.tree_map(jnp.asarray, _reference_params(arch)))
    return float(loss), float(metrics["ce"]), jax.tree_util.tree_map(
        np.asarray, grads)


def test_make_batch_is_the_references_draw():
    """tokens (B, S + 1) from default_rng(seed + step), shifted by one."""
    cfg = tconfigs.get_config("gemma3-1b", smoke=True)
    for step in (0, 3):
        toks = np.random.default_rng(SEED + step).integers(
            0, cfg.vocab_size, size=(B, S + 1))
        got = tlaunch.make_batch(cfg, B, S, SEED, step, device="cpu")
        np.testing.assert_array_equal(got["tokens"].numpy(), toks[:, :-1])
        np.testing.assert_array_equal(got["labels"].numpy(), toks[:, 1:])
        assert got["tokens"].dtype == torch.int64


def test_make_batch_defaults_to_the_card():
    """Like every entry point of the port, the batch goes to the card
    unless the caller asks for the CPU; without a card that raises
    instead of falling back."""
    cfg = tconfigs.get_config("gemma3-1b", smoke=True)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tlaunch.make_batch(cfg, B, S, SEED, 0)
    else:
        assert tlaunch.make_batch(cfg, B, S, SEED, 0)["tokens"].is_cuda


@pytest.mark.parametrize("arch", DENSE)
def test_loss_and_grads_match_reference(arch):
    cfg = tconfigs.get_config(arch, smoke=True)
    params = params_from_jax(_reference_params(arch), "cpu")
    loss, metrics, grads = _port_loss_and_grads(cfg, params, _batch(cfg))
    ref_loss, ref_ce, ref_grads = _reference_loss_and_grads(arch)
    np.testing.assert_allclose(float(loss), ref_loss, rtol=LOSS_RTOL,
                               atol=LOSS_ATOL)
    np.testing.assert_allclose(float(metrics["ce"].detach()), ref_ce,
                               rtol=LOSS_RTOL, atol=LOSS_ATOL)
    assert metrics["aux"] == 0.0
    mine, theirs = dict(_flatten(grads)), dict(_flatten(ref_grads))
    assert mine.keys() == theirs.keys()
    for key, g in mine.items():
        want = theirs[key]
        assert g.shape == want.shape and g.dtype == torch.float32, key
        assert bool(torch.isfinite(g).all()), key
        err = np.linalg.norm(g.numpy() - want) / np.linalg.norm(want)
        assert err <= GRAD_REL, (key, err)


@pytest.mark.parametrize("arch", ["gemma3-1b", "stablelm-3b"])
def test_remat_is_bitwise_on_the_cpu(arch):
    """Every layer under torch.utils.checkpoint recomputes the same ops on
    the same inputs: loss and every gradient bit for bit."""
    base = tconfigs.get_config(arch, smoke=True)
    params = params_from_jax(_reference_params(arch), "cpu")
    batch = _batch(base)
    runs = [_port_loss_and_grads(dataclasses.replace(base, remat=remat),
                                 params, batch) for remat in (False, True)]
    (l0, _, g0), (l1, _, g1) = runs
    assert torch.equal(l0, l1)
    for (key, a), (_, b) in zip(_flatten(g0), _flatten(g1)):
        assert torch.equal(a, b), key


@pytest.mark.parametrize("arch", ["gemma3-1b", "qwen2.5-14b"])
def test_loss_chunk_matches_unchunked(arch):
    """loss_chunk = 8 over S = 32 (each chunk's CE checkpointed) against
    the unchunked loss, rtol 1e-5 as the reference's own test
    (``tests/test_models.py``); each gradient within one bf16 step (2**-8)
    relative: the unembed's weight gradient is a bf16 product, rounded
    once per chunk and the chunks summed in f32, against rounded once
    (measured on the CPU: 8.9e-4 for gemma3's tied embedding); and the
    chunked loss within the LM tolerance of the reference's chunked
    loss."""
    base = tconfigs.get_config(arch, smoke=True)
    params = params_from_jax(_reference_params(arch), "cpu")
    batch = _batch(base)
    l0, _, g0 = _port_loss_and_grads(base, params, batch)
    l1, _, g1 = _port_loss_and_grads(
        dataclasses.replace(base, loss_chunk=8), params, batch)
    np.testing.assert_allclose(float(l1), float(l0), rtol=1e-5)
    for (key, a), (_, b) in zip(_flatten(g0), _flatten(g1)):
        err = float((a - b).norm() / a.norm().clamp_min(1e-30))
        assert err <= 2 ** -8, (key, err)
    ref_loss = _reference_loss_and_grads(arch, loss_chunk=8)[0]
    np.testing.assert_allclose(float(l1), ref_loss, rtol=LOSS_RTOL,
                               atol=LOSS_ATOL)


def test_loss_masks_negative_labels():
    cfg = tconfigs.get_config("gemma3-1b", smoke=True)
    params = params_from_jax(_reference_params("gemma3-1b"), "cpu")
    batch = _batch(cfg)
    masked = dict(batch, labels=batch["labels"].clone())
    masked["labels"][:, S // 2:] = -1
    with torch.no_grad():
        full, _ = transformer.loss_fn(cfg, params, batch)
        half, m = transformer.loss_fn(cfg, params, masked)
        logits, _ = transformer.forward(cfg, params, batch["tokens"])
    ce = torch.nn.functional.cross_entropy(
        logits.float()[:, :S // 2].reshape(-1, logits.shape[-1]),
        batch["labels"][:, :S // 2].reshape(-1))
    np.testing.assert_allclose(float(half), float(ce), rtol=1e-5)
    assert float(full) != float(half) and float(m["ce"]) == float(half)


@pytest.mark.parametrize("arch", ["gemma3-1b", "minitron-4b"])
def test_train_steps_match_reference(arch):
    """Four AdamW steps (lr 1e-2, so the weights move) of ``train_step``
    against the reference's loss_fn / adamw / apply_updates on the same
    batches: each step's loss within the LM tolerance; ``train_step``
    leaves the params it was given unchanged and updates every leaf."""
    steps, lr = 4, 1e-2
    jcfg = jconfigs.get_config(arch, smoke=True)
    cfg = tconfigs.get_config(arch, smoke=True)
    jmod = jget_module(jcfg)
    jopt = joptimizer.adamw(lr)

    @jax.jit
    def jstep(p, state, batch):
        (loss, _), grads = jax.value_and_grad(
            lambda q: jmod.loss_fn(jcfg, q, batch, dist=DIST),
            has_aux=True)(p)
        upd, state = jopt.update(grads, state, p)
        return joptimizer.apply_updates(p, upd), state, loss

    jp = jax.tree_util.tree_map(jnp.asarray, _reference_params(arch))
    jstate = jopt.init(jp)
    params = params_from_jax(_reference_params(arch), "cpu")
    opt = toptimizer.adamw(lr)
    state = opt.init(params)
    mine, theirs = [], []
    for step in range(steps):
        batch = _batch(cfg, step)
        before = {k: t.clone() for k, t in _flatten(params)}
        new, state, loss = tlaunch.train_step(cfg, params, opt, state, batch)
        for k, t in _flatten(params):  # functional: the old params stay
            assert torch.equal(t, before[k]), k
        params = new
        jp, jstate, jloss = jstep(jp, jstate, _jbatch(batch))
        mine.append(float(loss))
        theirs.append(float(jloss))
    assert state["count"] == steps
    np.testing.assert_allclose(mine, theirs, rtol=LOSS_RTOL, atol=LOSS_ATOL)
    first = params_from_jax(_reference_params(arch), "cpu")
    for (key, a), (_, b) in zip(_flatten(params), _flatten(first)):
        assert not torch.equal(a, b), key  # every leaf was updated


def test_train_cli_runs_lm_on_the_cpu(capsys):
    tlaunch.main(["--arch", "gemma3-1b", "--smoke", "--steps", "3",
                  "--device", "cpu"])
    out = capsys.readouterr().out
    assert "step     0 loss" in out and "straggler summary" in out


def test_train_cli_runs_gnn_on_the_cpu(capsys):
    tlaunch.main(["--gnn", "sage", "--max-vertices", "2000", "--steps", "2",
                  "--device", "cpu"])
    out = capsys.readouterr().out
    assert "dataset PR" in out and "feature hit rate" in out


LM_ARGV = ["--arch", "gemma3-1b", "--smoke", "--device", "cpu"]
GNN_ARGV = ["--gnn", "sage", "--max-vertices", "2000", "--device", "cpu"]


def _cli_losses(out):
    return out if isinstance(out, list) else out.losses


@pytest.mark.parametrize("argv, first, total", [
    (LM_ARGV, 2, 4), (LM_ARGV, 4, 4), (GNN_ARGV, 2, 4), (GNN_ARGV, 3, 3)])
def test_train_cli_checkpoint_then_resume(tmp_path, capsys, argv, first,
                                          total):
    """--ckpt for ``first`` steps, then --resume to ``total``: the stitched
    losses are bitwise the uninterrupted run's (the LM's per-step batches
    continue from the step; the GNN's sampler RNGs come back from the
    checkpoint's runtime state).  A checkpoint at ``total`` resumes to an
    empty run."""
    full = _cli_losses(tlaunch.main(argv + ["--steps", str(total)]))
    ck = str(tmp_path / "ck")
    a = _cli_losses(tlaunch.main(argv + ["--steps", str(first), "--ckpt",
                                         ck, "--ckpt-every", "1"]))
    capsys.readouterr()
    b = _cli_losses(tlaunch.main(argv + ["--steps", str(total), "--ckpt",
                                         ck, "--resume"]))
    assert f"resumed from step {first}" in capsys.readouterr().out
    assert len(a) == first and len(b) == total - first
    assert a + b == full


class _Interrupt(Exception):
    """Stands for a Ctrl-C that lands while the host waits on a step."""


def test_train_cli_interrupted_mid_step_resumes_to_the_same_losses(
        tmp_path, monkeypatch):
    """An exception in the wait on step 2 (after ``train_step`` has made
    that step's parameters): the final checkpoint is at step 2 with the
    parameters after step 1, so --resume replays step 2 once and the
    stitched losses are bitwise the uninterrupted run's."""
    from repro_torch import utils

    full = tlaunch.main(LM_ARGV + ["--steps", "4"])
    ck = str(tmp_path / "ck")
    calls = []
    sync = utils.synchronize

    def interrupt_third(dev):
        calls.append(dev)
        if len(calls) == 3:
            raise _Interrupt
        sync(dev)

    monkeypatch.setattr(utils, "synchronize", interrupt_third)
    with pytest.raises(_Interrupt):
        tlaunch.main(LM_ARGV + ["--steps", "4", "--ckpt", ck,
                                "--ckpt-every", "100"])
    monkeypatch.setattr(utils, "synchronize", sync)
    from repro_torch.train.checkpoint import latest_checkpoint

    assert latest_checkpoint(ck).endswith("ckpt_00000002.npz")
    rest = tlaunch.main(LM_ARGV + ["--steps", "4", "--ckpt", ck,
                                   "--resume"])
    assert full[:2] + rest == full


def test_train_cli_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present; this checks the CPU-only host")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tlaunch.main(["--arch", "gemma3-1b", "--smoke", "--steps", "1"])
