"""How a mesh decode's row-parallel products move phase 30a's
teacher-forced decode gaps (card only).

    python3 tools/row_partials.py [ARCH ...]

On a mesh the decode multiplies each position's block of an activation by
its own rows of wo and w_down and sums the partial products over "model"
(``Distribution.matmul``); the Mamba mixer's w_out is gathered whole
(``mamba2._decode_out``).  The meshless run makes each product in one bf16
GEMM.  For each of ``chip_smoke.py``'s phase 30a cells
(``MESH_FAMILY_SERVE``; or those of the ARCHs named), at full size from
seed-0 weights drawn on the card: the meshless ``generate``, then
teacher-forced on its tokens the meshless run on each half of the batch
alone (phase 30a's spread) and the cell's mesh with the partial sums in f32
(as shipped) and in f64 (``sharding.ROW_PARTIALS``), and, for a Mamba
model, with w_out row-parallel too (the weights' own rows, f32 or f64
partials: the reference's layout) and column-parallel (its column blocks
moved by an all_to_all, one bf16 GEMM of the whole row by each position's
columns).  Prints, per run and decode step, the largest log-softmax gap to
the meshless run, phase 30a's limit at each step (``LM_DECODE_GAP`` +
``MESH_FAMILY_SPREAD_K`` times the halves' gap) and whether the run stays
inside it, and the card's name and power limit.
"""
import math
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
from repro_torch.launch.variants import apply_variant  # noqa: E402
from repro_torch.models import get_module, mamba2, sharding  # noqa: E402
from repro_torch.models.params import init_from_defs, shard_params  # noqa
from repro_torch.models.sharding import Distribution  # noqa: E402

SHIPPED = (sharding.ROW_PARTIALS, mamba2._decode_out)


def _normed_blocks(cfg, p, u, dist, hax):
    """Each position's block of the gated norm of whole rows (u gathered),
    by its block of the norm's gain: the meshless norm's bits there."""
    rows = dist.all_gather(u, 2)
    width = u.local_shape[2]

    def block(i, gain, ui):
        f = ui.float()
        var = (f * f).mean(dim=-1, keepdim=True)
        lo = dist.mesh.rank(i, hax) * width
        return (f[..., lo:lo + width] * torch.rsqrt(var + cfg.norm_eps)
                * (1.0 + gain.float())).to(ui.dtype)

    return dist.map(block, p["norm"], rows, pos=True, spec=u.spec)


def rows(cfg, p, u, spec, dist):
    """w_out row-parallel: each position's normalised block by its rows of
    w_out, the partial products ``psum``-med (``ROW_PARTIALS``)."""
    hax = mamba2._head_axes(cfg, dist)
    if not hax:
        return SHIPPED[1](cfg, p, u, spec, dist)
    return dist.matmul(_normed_blocks(cfg, p, u, dist, hax), p["w_out"])


def columns(cfg, p, u, spec, dist):
    """w_out column-parallel: the normalised rows gathered whole, w_out's
    column blocks moved to their positions by an all_to_all of its row
    blocks (cast to bf16 first), one bf16 GEMM of the whole row by each
    position's columns, and the columns gathered."""
    hax = mamba2._head_axes(cfg, dist)
    if not hax:
        return SHIPPED[1](cfg, p, u, spec, dist)
    y = dist.all_gather(_normed_blocks(cfg, p, u, dist, hax), 2)
    w = dist.map(lambda t: t.to(u.dtype), p["w_out"], spec=p["w_out"].spec)
    w = dist.all_to_all(w, hax, split_dim=1, concat_dim=0)
    return dist.all_gather(dist.matmul(y, w), 2)


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("row_partials: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.smi()
    for arch, variant, shape, batch, prompt, new in cs.MESH_FAMILY_SERVE:
        if argv and arch not in argv:
            continue
        cfg = apply_variant(get_config(arch), variant)
        mod = get_module(cfg)
        params = init_from_defs(mod.defs(cfg), torch.Generator(
            device="cuda").manual_seed(0), "cuda")
        prompts, frames = cs.serving_inputs(torch, np, cfg, batch, prompt,
                                            "cuda")
        prompts = torch.as_tensor(prompts, device="cuda")
        want = generate(cfg, params, prompts, new, frames=frames,
                        device="cuda")

        def forced(p, rows=slice(None), dist=None):
            inputs = prompts[rows] if frames is None else {
                "frames": frames[rows], "tokens": prompts[rows]}
            return cs.teacher_forced(torch, mod, cfg, p, inputs,
                                     want.tokens[rows], dist=dist)[0].float()

        ref = forced(params)

        def gaps(got):
            return (torch.log_softmax(got, -1) - torch.log_softmax(ref, -1)
                    ).abs().amax(dim=(0, 2))[1:]

        halves = gaps(torch.cat([forced(params, slice(h, h + batch // 2))
                                 for h in (0, batch // 2)]))
        limit = cs.LM_DECODE_GAP + cs.MESH_FAMILY_SPREAD_K * halves
        name = f"{cfg.name} ({variant}) {shape[0]} x {shape[1]}"
        print(f"[row-partials] {name}: meshless batch halves' gap by decode "
              f"step {[round(float(g), 4) for g in halves]}; phase 30a's "
              f"limit {[round(float(g), 4) for g in limit]} | {card}")
        dist = Distribution(make_debug_mesh(shape, devices=["cuda"]
                                            * math.prod(shape)))
        sp = shard_params(params, mod.defs(cfg), dist)
        forms = [("as shipped, f32 partials", torch.float32, SHIPPED[1]),
                 ("f64 partials", torch.float64, SHIPPED[1])]
        if cfg.family in ("ssm", "hybrid"):
            forms += [("w_out row-parallel, f32 partials", torch.float32,
                       rows),
                      ("w_out row-parallel, f64 partials", torch.float64,
                       rows),
                      ("w_out column blocks", torch.float32, columns)]
        for label, dtype, out in forms:
            sharding.ROW_PARTIALS, mamba2._decode_out = dtype, out
            try:
                g = gaps(forced(sp, dist=dist))
            finally:
                sharding.ROW_PARTIALS, mamba2._decode_out = SHIPPED
            print(f"[row-partials] {name}, {label}: gap by step "
                  f"{[round(float(x), 4) for x in g]}, inside the limit at "
                  f"every step: {bool((g <= limit).all())} | {card}")
        del params, sp
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
