"""The attention backward on the card, the kernel (ds in two bf16 parts on
``mma_sync``) and the plain backward itself, each held to the CPU on phase
24's smoke training (card only).

    python3 tools/ds_split_leaves.py [--json PATH] [--seed N] [ARCH ...]

For each named config (default zamba2-1.2b, whose smoke config runs its
shared block at Dh 16 on ``mma_sync`` in ``chip_smoke.py``'s phase 24, and
gemma3-1b, whose smoke config phase 15 (lm-train-parity) trains), as those
phases train it (``LM_TRAIN_SMOKE``: 4 AdamW steps at 4 x 64 from the
weights drawn with seed N, 0 by default as in the smoke, and the same
numpy batches): the CPU run through the plain versions, and two card runs
that share the forward kernel and differ in the attention backward only:

- ``kernel``: ``fa.BWD_KERNEL`` as the port launches it;
- ``plain``: ``ref.flash_attention_bwd`` on the CUDA tensors (ds in f32, the
  CPU's arithmetic on the card).

Prints the losses of each and their gaps to the CPU's, and for every leaf
of the first step's gradients two errors against the CPU's: ``fro`` = |g -
g_cpu| / |g_cpu| (Frobenius, phase 24's measure) and ``max`` = max |g -
g_cpu| / max |g_cpu|, under each form.  Then, call by call, the first
step's attention backward calls as the ``plain`` run makes them: the
kernel against the plain version and the f64 gradient by
``check_backward``'s rule (max |g - f64| / max |f64| <= 2 x the plain
version's + 1e-3).  With ``--json PATH`` every figure is also written to
PATH.  Prints the card's name and power limit.
"""
import contextlib
import json
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
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.launch.train import make_batch  # noqa: E402
from repro_torch.models import get_module  # noqa: E402
from repro_torch.models.params import init_from_defs  # noqa: E402

FORMS = ("kernel", "plain")


def plain_on_card(q, k, v, o, lse, do, causal, window, shift=0):
    """``fa._backward_device``'s place taken by the plain backward on the
    card's tensors."""
    return ref.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                   window=window, q_offset=shift)


@contextlib.contextmanager
def backward_form(form: str):
    """The attention backward on the card as ``form`` for the block."""
    device = fa._backward_device
    if form == "plain":
        fa._backward_device = plain_on_card
    try:
        yield
    finally:
        fa._backward_device = device


def errors(got: dict, want: dict) -> dict:
    out = {}
    for name, w in want.items():
        g = got[name].cpu().double()
        w = w.double()
        out[name] = (float((g - w).norm() / w.norm().clamp_min(1e-30)),
                     float((g - w).abs().max()
                           / w.abs().max().clamp_min(1e-30)))
    return out


def captured_calls(mod, cfg, params, batch) -> list:
    """Every attention backward call of one loss-and-gradient pass on the
    card: (q, k, v, o, lse, do, keywords), cloned."""
    calls, inner = [], fa.flash_attention_bwd

    def capture(*args, **kw):
        calls.append((*(t.clone() for t in args), dict(kw)))
        return inner(*args, **kw)

    fa.flash_attention_bwd = capture
    try:
        cs.loss_and_grads(torch, mod, cfg, params, batch)
    finally:
        fa.flash_attention_bwd = inner
    return calls


def call_by_call(calls: list, card: str, name: str) -> list:
    """Each captured call through the kernel, against the plain backward and
    the f64 gradient by ``check_backward``'s rule."""
    rows = []
    for n, (q, k, v, o, lse, do, kw) in enumerate(calls):
        shift = kw.get("q_offset", 0) - kw.get("kv_offset", 0)
        plain = ref.flash_attention_bwd(q, k, v, o, lse, do, **kw)
        exact = cs.exact_grads(torch, q, k, v, do, kw.get("causal", True),
                               kw.get("window", 0), shift)
        row = {"call": n, "q": list(q.shape), "k": list(k.shape),
               "kw": {a: b for a, b in kw.items() if a != "block_kv"},
               "route": fa.flash_bwd_route(q.dtype, q.shape[3])}
        got = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
        torch.cuda.synchronize()
        for g_name, g, p, e in zip(("dq", "dk", "dv"), got, plain, exact):
            den = float(e.abs().max()) or 1.0
            ek = float((g.double() - e).abs().max()) / den
            ep = float((p.double() - e).abs().max()) / den
            pden = float(p.float().abs().max()) or 1.0
            row[g_name] = {
                "err": ek, "plain_err": ep,
                "vs_plain": float((g.float() - p.float()).abs().max()) / pden,
                "rule_ok": ek <= 2 * ep + cs.BWD_F64_FLOOR}
        rows.append(row)
        worst = max(row[g]["err"] / (2 * row[g]["plain_err"]
                                     + cs.BWD_F64_FLOOR)
                    for g in ("dq", "dk", "dv"))
        print(f"[ds-calls] {name} call {n} q {tuple(q.shape)} k "
              f"{tuple(k.shape)} {row['kw']} on {row['route']}: "
              + ", ".join(f"{g} {row[g]['err']:.3e} (plain "
                          f"{row[g]['plain_err']:.3e}, vs plain "
                          f"{row[g]['vs_plain']:.3e})"
                          for g in ("dq", "dk", "dv"))
              + f", worst share of the rule {worst:.3f} | {card}")
    return rows


def run(arch: str, card: str, seed: int) -> dict:
    B, S, N = cs.LM_TRAIN_SMOKE
    cfg = get_config(arch, smoke=True)
    mod = get_module(cfg)
    params = init_from_defs(mod.defs(cfg),
                            torch.Generator().manual_seed(seed), "cpu")
    batch = make_batch(cfg, B, S, 0, 0, "cpu")
    losses = {"cpu": cs.lm_train(torch, np, fa, cfg, params, B, S, N,
                                 "cpu")[0]}
    _, g_cpu = cs.loss_and_grads(torch, mod, cfg, params, batch)
    dev = cs.to_device(params, "cuda")
    dev_batch = cs.to_device(batch, "cuda")
    errs = {}
    for form in FORMS:
        with backward_form(form):
            losses[form] = cs.lm_train(torch, np, fa, cfg, dev, B, S, N,
                                       "cuda")[0]
            _, g = cs.loss_and_grads(torch, mod, cfg, dev, dev_batch)
        errs[form] = errors(g, g_cpu)
    gaps = {}
    for form in FORMS:
        gap = np.abs(np.subtract(losses[form], losses["cpu"]))
        gaps[form] = [float(d) for d in gap]
        print(f"[ds-leaves] {cfg.name} seed {seed} {form}: losses {losses[form]} vs CPU "
              f"{losses['cpu']}, |gap| {[float(f'{d:.4e}') for d in gap]}, "
              f"max {float(gap.max()):.4e} | {card}")
    print(f"[ds-leaves] {cfg.name} first-step gradients against the CPU's, "
          f"per leaf: fro " + " / ".join(FORMS) + ", max "
          + " / ".join(FORMS))
    for name in sorted(g_cpu):
        fro = " / ".join(f"{errs[f][name][0]:.4e}" for f in FORMS)
        mx = " / ".join(f"{errs[f][name][1]:.4e}" for f in FORMS)
        print(f"[ds-leaves]   {name:28s} fro {fro}   max {mx}")
    for form in FORMS:
        worst = max(errs[form], key=lambda n: errs[form][n][0])
        print(f"[ds-leaves] {cfg.name} {form}: worst fro {worst} "
              f"{errs[form][worst][0]:.4e}, median fro "
              f"{float(np.median([e[0] for e in errs[form].values()])):.4e}"
              f", worst max {max(e[1] for e in errs[form].values()):.4e}")
    with backward_form("plain"):
        calls = captured_calls(mod, cfg, dev, dev_batch)
    rows = call_by_call(calls, card, cfg.name)
    return {"seed": seed, "losses": losses, "gaps": gaps,
            "leaf_errors": {f: {n: list(e) for n, e in errs[f].items()}
                            for f in FORMS},
            "calls": rows}


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("ds_split_leaves: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    path, seed = None, 0
    while argv[:1] in (["--json"], ["--seed"]):
        if argv[0] == "--json":
            path = Path(argv[1])
        else:
            seed = int(argv[1])
        argv = argv[2:]
    card = cs.smi()
    out = {"card": card}
    for arch in argv or ["zamba2-1.2b", "gemma3-1b"]:
        out[arch] = run(arch, card, seed)
    if path is not None:
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(out, indent=1))
        print(f"[ds-leaves] figures in {path} | {card}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
