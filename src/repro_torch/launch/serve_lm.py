"""Serve a language model with batched requests: prefill the prompts once,
then decode greedily with the growing KV cache or recurrent state (the
port of the reference's ``examples/serve_lm.py``), for every family of
the zoo: decoder-only (dense, MoE, vlm), SSM and hybrid, encoder-decoder.

    PYTHONPATH=src python -m repro_torch.launch.serve_lm --arch gemma3-1b \\
        [--smoke] [--batch 4] [--prompt 24] [--new 16] [--seed 0] \\
        [--device cuda]

Weights are random, drawn from ``--seed`` with a CPU ``torch.Generator``
(the reference's checkpoints can be carried over with
``models.convert.params_from_jax``); prompts are drawn with numpy from
``--seed + 1``.  For the encoder-decoder (audio) families ``--prompt`` is
the number of frames S: the frames (B, S, d_model) are a normal draw from
``default_rng(--seed)`` (the audio frontend is a stub, as in the
reference), and the decoder's prompts have ``St = max(S //
target_ratio, 16)`` tokens.  It runs on the card unless ``--device cpu``
is given.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.models import get_module
from repro_torch.models.params import init_from_defs
from repro_torch.models.sharding import on_mesh
from repro_torch.train.optimizer import tree_leaves
from repro_torch.utils import resolve_device, synchronize


@dataclasses.dataclass
class Generation:
    tokens: torch.Tensor   # (B, new) int64: the greedy tokens
    logits: torch.Tensor   # (B, new, vocab_size): the logits each came from
    prefill_s: float       # host wall time of the prefill, synchronized
    decode_s: float        # host wall time of the decode loop, synchronized


ENCDEC_FAMILIES = ("encdec", "audio")


def target_len(cfg: ModelConfig, frames: int) -> int:
    """The decoder's prompt length for ``frames`` encoder frames, as the
    reference's launch specs cut it: ``max(frames // target_ratio, 16)``."""
    return max(frames // cfg.target_ratio, 16)


def generate(cfg: ModelConfig, params: dict, prompts, new_tokens: int, *,
             frames=None, device="cuda", dist=None) -> Generation:
    """Greedy generation of ``new_tokens`` tokens after ``prompts`` (B, P).

    Prefill with a cache (or state) of ``P + new_tokens`` slots, take the
    argmax of the last position's logits over the real vocabulary
    (``cfg.vocab_size``, not the padded one), then ``decode_step``
    ``new_tokens - 1`` times, each fed the previous argmax.  The
    encoder-decoder families need ``frames`` (B, S, d_model), which the
    prefill encodes; the others take none.  ``params`` must live on
    ``device``.  The device is synchronized once after the prefill and once
    after the decode loop; each decode step is a ``device_step`` profiler
    range (free when no profiler runs).

    On a mesh (``dist`` with one; ``params`` laid out by
    ``params.shard_params``, ``device`` ignored): the mesh prefill and
    decode steps, the vocab-sharded logits gathered whole before each
    argmax, the tokens fed back batch-sharded; the result is assembled on
    the first position's device and every device of the mesh is
    synchronized."""
    if new_tokens < 1:
        raise ValueError(f"new_tokens must be >= 1, got {new_tokens}")
    if (frames is not None) != (cfg.family in ENCDEC_FAMILIES):
        raise ValueError(f"family {cfg.family!r}: frames are "
                         + ("required" if frames is None else "not taken"))
    if on_mesh(dist):
        return _generate_mesh(cfg, params, prompts, new_tokens, frames, dist)
    dev = resolve_device(device)
    where = tree_leaves(params)[0].device
    if where != dev:
        raise ValueError(f"params live on {where}, generation asked for "
                         f"{dev}")
    mod = get_module(cfg)
    prompts = torch.as_tensor(prompts, device=dev)
    B, P = prompts.shape
    inputs = prompts if frames is None else {
        "frames": torch.as_tensor(frames, device=dev), "tokens": prompts}
    V = cfg.vocab_size
    with torch.inference_mode():
        t0 = time.perf_counter()
        logits, cache = mod.prefill(cfg, params, inputs,
                                    max_len=P + new_tokens)
        tok = logits[:, -1:, :V].argmax(dim=-1)
        synchronize(dev)
        prefill_s = time.perf_counter() - t0
        toks, outs = [tok], [logits[:, -1:, :V]]
        t0 = time.perf_counter()
        for i in range(new_tokens - 1):
            with torch.profiler.record_function("device_step"):
                logits, cache = mod.decode_step(cfg, params, cache, tok,
                                                P + i)
                tok = logits[:, :, :V].argmax(dim=-1)
            toks.append(tok)
            outs.append(logits[:, :, :V])
        synchronize(dev)
        decode_s = time.perf_counter() - t0
    return Generation(torch.cat(toks, dim=1), torch.cat(outs, dim=1),
                      prefill_s, decode_s)


def _generate_mesh(cfg: ModelConfig, params: dict, prompts,
                   new_tokens: int, frames, dist) -> Generation:
    mesh = dist.mesh
    devices = sorted(set(mesh.devices), key=str)
    mod = get_module(cfg)
    prompts = torch.as_tensor(prompts, device=mesh.device(0))
    B, P = prompts.shape
    inputs = prompts if frames is None else {
        "frames": torch.as_tensor(frames, device=mesh.device(0)),
        "tokens": prompts}
    V = cfg.vocab_size

    def greedy(logits):
        logits = dist.all_gather(logits, 2)
        tok = dist.map(lambda t: t[:, -1:, :V].argmax(dim=-1), logits,
                       spec=logits.spec[:2])
        return tok, logits

    def sync():
        for d in devices:
            synchronize(d)

    with torch.inference_mode():
        t0 = time.perf_counter()
        logits, cache = mod.prefill(cfg, params, inputs,
                                    max_len=P + new_tokens, dist=dist)
        tok, logits = greedy(logits)
        sync()
        prefill_s = time.perf_counter() - t0
        toks, outs = [tok], [logits]
        t0 = time.perf_counter()
        for i in range(new_tokens - 1):
            with torch.profiler.record_function("device_step"):
                logits, cache = mod.decode_step(cfg, params, cache, tok,
                                                P + i, dist=dist)
                tok, logits = greedy(logits)
            toks.append(tok)
            outs.append(logits)
        sync()
        decode_s = time.perf_counter() - t0
        tokens = torch.cat([dist.full(t) for t in toks], dim=1)
        logits = torch.cat([dist.full(t)[:, -1:, :V] for t in outs], dim=1)
    return Generation(tokens, logits, prefill_s, decode_s)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="gemma3-1b", choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced config of the arch")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=24)
    ap.add_argument("--new", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    dev = resolve_device(args.device)
    params = init_from_defs(get_module(cfg).defs(cfg),
                            torch.Generator().manual_seed(args.seed), dev)
    frames, P = None, args.prompt
    if cfg.family in ENCDEC_FAMILIES:
        frames = torch.from_numpy(np.random.default_rng(args.seed).normal(
            size=(args.batch, args.prompt, cfg.d_model)).astype(np.float32))
        P = target_len(cfg, args.prompt)
    prompts = np.random.default_rng(args.seed + 1).integers(
        0, cfg.vocab_size, (args.batch, P))
    gen = generate(cfg, params, prompts, args.new, frames=frames, device=dev)
    print("generated token ids:\n", gen.tokens.cpu().numpy())
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "cpu")
    print(f"{cfg.name} on {where}: prefill {gen.prefill_s * 1e3:.1f} ms "
          f"(batch {args.batch} x {args.prompt}"
          + (f" frames, {P}-token prompts" if frames is not None else "")
          + "), "
          + (f"{(args.new - 1) * args.batch / gen.decode_s:.1f} tokens/s "
             "decode" if args.new > 1 else "no decode steps"))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
