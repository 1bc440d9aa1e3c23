"""How far a mesh moves a full-width model's prefill and greedy decode
from its meshless run on the card, split by what moves it (card only).

    python3 tools/mesh_decode_spread.py [ARCH [LAYOUT]]

For ARCH (default mamba2-780m; an SSM, hybrid or encoder-decoder config)
at full size, seed-0 weights drawn on the card, ``chip_smoke.py``'s phase
30a inputs (4 x 1024 prompts or frames, 8 tokens) under LAYOUT (default
head_tp): the meshless ``generate``, then teacher-forced on its tokens (so
that every run sees the same inputs) the meshless run on each half of the
batch alone, and the mesh runs on 2 x 1 (the batch split: each position's
products have half the rows), 1 x 2 and 1 x 4 (the heads or the sequence
split over "model") and 2 x 2.  Prints, per run and step, the largest
|logit - meshless logit| and log-softmax gap over the real vocabulary,
and the card's name and power limit.
"""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.mesh import make_debug_mesh  # noqa: E402
from repro_torch.launch.serve_lm import generate  # noqa: E402
from repro_torch.models import get_module  # noqa: E402
from repro_torch.models.params import init_from_defs, shard_params  # noqa
from repro_torch.models.sharding import Distribution  # noqa: E402

B, PROMPT, NEW = 4, 1024, 8


def forced(cfg, params, prompts, frames, tokens, rows=slice(None),
           dist=None) -> torch.Tensor:
    """The prefill's and each decode step's logits (B, NEW, vocab) of the
    batch's ``rows`` fed ``tokens`` (the meshless run's greedy ones)."""
    logits, _ = cs.teacher_forced(
        torch, get_module(cfg), cfg, params,
        prompts[rows] if frames is None
        else {"frames": frames[rows], "tokens": prompts[rows]},
        tokens[rows], dist=dist)
    return logits.float()


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("mesh_decode_spread: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    arch = argv[0] if argv else "mamba2-780m"
    cfg = dataclasses.replace(get_config(arch), mamba_layout=(
        argv[1] if len(argv) > 1 else "head_tp"))
    card = cs.smi()
    defs = get_module(cfg).defs(cfg)
    params = init_from_defs(defs, torch.Generator(device="cuda").manual_seed(
        0), "cuda")
    prompts, frames = cs.serving_inputs(torch, np, cfg, B, PROMPT, "cuda")
    prompts = torch.from_numpy(prompts).cuda()
    want = generate(cfg, params, prompts, NEW, frames=frames, device="cuda")
    ref = forced(cfg, params, prompts, frames, want.tokens)
    runs = {"meshless, batch halves": torch.cat([
        forced(cfg, params, prompts, frames, want.tokens,
               slice(h, h + B // 2)) for h in (0, B // 2)])}
    for shape in ((2, 1), (1, 2), (1, 4), (2, 2)):
        dist = Distribution(make_debug_mesh(shape, devices="cuda:0"))
        runs[f"{shape[0]} x {shape[1]} mesh"] = forced(
            cfg, shard_params(params, defs, dist), prompts, frames,
            want.tokens, dist=dist)
    for name, got in runs.items():
        err = (got - ref).abs().amax(dim=(0, 2))
        gap = (torch.log_softmax(got, -1) - torch.log_softmax(ref, -1)
               ).abs().amax(dim=(0, 2))
        print(f"[decode-spread] {cfg.name} ({cfg.mamba_layout}) {name} "
              f"against the meshless run, by step (0: the prefill): max "
              f"|logit diff| {[round(float(e), 4) for e in err]}, max "
              f"log-softmax gap {[round(float(g), 4) for g in gap]} | "
              f"{card}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
