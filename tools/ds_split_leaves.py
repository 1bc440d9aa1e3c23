"""The attention backward's ds on the ``mma_sync`` route, rounded to bf16
once (the kernel's form) or taken as two bf16 parts (the ``wgmma``
route's form), held to the CPU leaf by leaf on phase 24's smoke training
(card only).

    python3 tools/ds_split_leaves.py [ARCH ...]

For each named config (default zamba2-1.2b; its smoke config runs its
shared block at Dh 16, on ``mma_sync``), as ``chip_smoke.py``'s phase 24
trains it (``LM_TRAIN_SMOKE``: 4 AdamW steps at 4 x 64 from the seed-0
weights): the CPU run through the plain versions, and two card runs, one
through the backward kernel as built, one through a copy of its source
built with ``kMmaSyncDsParts = 2`` (ds's hi and lo parts, two products
each for dk and dq).  Prints the losses of each and their gaps to the
CPU's, and for every leaf of the first step's gradients two errors against
the CPU's:
``fro`` = |g - g_cpu| / |g_cpu| (Frobenius, phase 24's measure) and
``max`` = max |g - g_cpu| / max |g_cpu|, under each form.  Prints the
card's name and power limit.
"""
import re
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels._build import BUILD_DIR, CudaKernel  # noqa: E402
from repro_torch.launch.train import make_batch  # noqa: E402
from repro_torch.models import get_module  # noqa: E402
from repro_torch.models.params import init_from_defs  # noqa: E402

PARTS = re.compile(r"^constexpr int kMmaSyncDsParts = 1;$", re.M)


def ds_split_kernel() -> CudaKernel:
    """``fa.BWD_KERNEL`` built from a copy of its source with
    ``kMmaSyncDsParts = 2``."""
    src = fa.BWD_KERNEL.source
    text, n = PARTS.subn("constexpr int kMmaSyncDsParts = 2;",
                         src.read_text())
    if n != 1:
        raise RuntimeError(f"{src.name} does not set kMmaSyncDsParts = 1")
    out = BUILD_DIR / "ds_split"
    out.mkdir(parents=True, exist_ok=True)
    for header in src.parent.glob("*.cuh"):
        (out / header.name).write_text(header.read_text())
    (out / src.name).write_text(text)
    k = fa.BWD_KERNEL
    return CudaKernel(k.name, str(out / src.name), k.symbol, k.argtypes,
                      routes=tuple(k.route_launches),
                      symbols={s: a for s, a in k.symbols.items()
                               if s != k.symbol})


def errors(got: dict, want: dict) -> dict:
    out = {}
    for name, w in want.items():
        g = got[name].cpu().double()
        w = w.double()
        out[name] = (float((g - w).norm() / w.norm().clamp_min(1e-30)),
                     float((g - w).abs().max()
                           / w.abs().max().clamp_min(1e-30)))
    return out


def run(arch: str, card: str, split: CudaKernel) -> None:
    B, S, N = cs.LM_TRAIN_SMOKE
    cfg = get_config(arch, smoke=True)
    mod = get_module(cfg)
    params = init_from_defs(mod.defs(cfg), torch.Generator().manual_seed(0),
                            "cpu")
    batch = make_batch(cfg, B, S, 0, 0, "cpu")
    losses = {"cpu": cs.lm_train(torch, np, fa, cfg, params, B, S, N,
                                 "cpu")[0]}
    _, g_cpu = cs.loss_and_grads(torch, mod, cfg, params, batch)
    errs = {}
    built = fa.BWD_KERNEL
    for form, kernel in (("split", split), ("once", built)):
        fa.BWD_KERNEL = kernel
        try:
            dev = cs.to_device(params, "cuda")
            losses[form] = cs.lm_train(torch, np, fa, cfg, dev, B, S, N,
                                       "cuda")[0]
            _, g = cs.loss_and_grads(torch, mod, cfg, dev,
                                     cs.to_device(batch, "cuda"))
        finally:
            fa.BWD_KERNEL = built
        errs[form] = errors(g, g_cpu)
    for form in ("split", "once"):
        gap = np.abs(np.subtract(losses[form], losses["cpu"]))
        print(f"[ds-leaves] {cfg.name} {form}: losses {losses[form]} vs CPU "
              f"{losses['cpu']}, |gap| {[float(f'{d:.4e}') for d in gap]} | "
              f"{card}")
    print(f"[ds-leaves] {cfg.name} first-step gradients against the CPU's, "
          f"per leaf: fro split / once, max split / once")
    for name in sorted(g_cpu):
        (fs, ms), (fo, mo) = errs["split"][name], errs["once"][name]
        print(f"[ds-leaves]   {name:28s} fro {fs:.4e} / {fo:.4e}   "
              f"max {ms:.4e} / {mo:.4e}")
    for form in ("split", "once"):
        worst = max(errs[form], key=lambda n: errs[form][n][0])
        print(f"[ds-leaves] {cfg.name} {form}: worst fro {worst} "
              f"{errs[form][worst][0]:.4e}, median fro "
              f"{float(np.median([e[0] for e in errs[form].values()])):.4e}"
              f", worst max {max(e[1] for e in errs[form].values()):.4e}")


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("ds_split_leaves: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.smi()
    split = ds_split_kernel()
    for arch in argv or ["zamba2-1.2b"]:
        run(arch, card, split)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
