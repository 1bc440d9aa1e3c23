"""How the attention backward's rounding of ds moves its error, on the CPU:
the plain backward's arithmetic (``kernels/ref.py``'s
``flash_attention_bwd``: q * scale, p and the gradients rounded to bf16)
with ds = p (dp - D) kept f32, rounded once to bf16, or taken as two bf16
parts hi = bf16(ds), lo = bf16(ds - hi) (the backward kernel's operand),
each against the f64 gradient.

    PYTHONPATH=src python3 tools/bwd_ds_rounding.py
    PYTHONPATH=src python3 tools/bwd_ds_rounding.py --smoke-train ARCH...

Prints, per draw, max |g - exact| / max |exact| for dq, dk, dv under each
form and each form's ratio to the f32 one.  The case is phi3.5-moe's heads
(32 query heads over 8 kv heads, Dh 128) in a causal block of 128 queries
at offset 384 over 512 keys, so each row sees 385-512 keys.  The card's
rule (``chip_smoke.py``'s ``check_backward``) allows the kernel twice the
plain version's error + 1e-3.

With ``--smoke-train``: each named config's smoke training of
``chip_smoke.py``'s phase 24 (``LM_TRAIN_SMOKE``: 4 AdamW steps at 4 x 64
from the seed-0 weights, on the CPU through the plain versions) with the
plain backward's ds in each form; prints the losses and how far each form
moves them from the f32 one.
"""
import inspect
import sys
import textwrap
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.kernels import ref  # noqa: E402

CASE = (1, 128, 32, 8, 128, 512, 384)  # B, Sq, Hq, Hkv, Dh, Sk, q_offset
DRAWS = 4
PLAIN = ref.flash_attention_bwd


def bf(x: torch.Tensor) -> torch.Tensor:
    return x.bfloat16().float()


def backward(q, k, v, o, lse, do, off: int, form: str):
    """The plain causal backward in one key block, ds in ``form``: "f32",
    "bf16" or "two parts"."""
    B, Sq, Hq, Dh = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = torch.tensor(Dh ** -0.5, dtype=q.dtype)
    qs = (q.reshape(B, Sq, Hkv, G, Dh) * scale).float()
    dof = do.reshape(B, Sq, Hkv, G, Dh).float()
    delta = (dof * o.reshape(B, Sq, Hkv, G, Dh).float()).sum(-1)
    delta = delta.permute(0, 2, 3, 1)
    lse = lse.reshape(B, Hkv, G, Sq).float()
    i = off + torch.arange(Sq)[:, None]
    j = torch.arange(Sk)[None, :]
    s = torch.einsum("bqhgd,bkhd->bhgqk", qs, k.float())
    p = torch.where(j <= i, torch.exp(s - lse[..., None]), 0.0)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", bf(p), dof).bfloat16()
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dof, v.float())
    ds = p * (dp - delta[..., None])
    if form == "bf16":
        ds = bf(ds)
    elif form == "two parts":
        ds = bf(ds) + bf(ds - bf(ds))
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qs).bfloat16()
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, k.float()) * scale.float()
    return dq.bfloat16().reshape(B, Sq, Hq, Dh), dk, dv


def exact(q, k, v, do, off: int):
    """The f64 gradient over q * the bf16-rounded scale."""
    Sq, Hq, Dh = q.shape[1:]
    Sk, G = k.shape[1], Hq // k.shape[2]
    i = off + torch.arange(Sq)[:, None]
    j = torch.arange(Sk)[None, :]
    qd, kd, vd = (t.double().requires_grad_() for t in (q, k, v))
    scale = float(torch.tensor(Dh ** -0.5, dtype=torch.bfloat16))
    s = torch.einsum("bqhd,bkhd->bhqk", qd * scale,
                     kd.repeat_interleave(G, 2))
    o = torch.einsum("bhqk,bkhd->bqhd",
                     s.masked_fill(~(j <= i), float("-inf")).softmax(-1),
                     vd.repeat_interleave(G, 2))
    return torch.autograd.grad(o, (qd, kd, vd), do.double())


def plain_backward_with(form: str):
    """``ref.flash_attention_bwd`` with ds in ``form`` before its
    products."""
    if form == "f32":
        return PLAIN
    src = textwrap.dedent(inspect.getsource(PLAIN))
    line = "        ds = p * (dp - delta[..., None])\n"
    cast = {"bf16": "ds = ds.bfloat16().float()",
            "two parts": "ds = ds.bfloat16().float() + "
                         "(ds - ds.bfloat16().float()).bfloat16().float()"}
    assert src.count(line) == 1
    ns = dict(vars(ref))
    exec(src.replace(line, line + "        " + cast[form] + "\n"), ns)
    return ns["flash_attention_bwd"]


def smoke_train(archs) -> int:
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import get_module
    from repro_torch.models.params import init_from_defs

    B, S, N = cs.LM_TRAIN_SMOKE
    for arch in archs:
        cfg = get_config(arch, smoke=True)
        mod = get_module(cfg)
        losses = {}
        try:
            for form in ("f32", "bf16", "two parts"):
                ref.flash_attention_bwd = plain_backward_with(form)
                params = init_from_defs(mod.defs(cfg),
                                        torch.Generator().manual_seed(0),
                                        "cpu")
                losses[form], _, _ = cs.lm_train(
                    torch, np, fa, cfg, params, B, S, N, "cpu",
                    routes=[] if cfg.n_experts else None)
        finally:
            ref.flash_attention_bwd = PLAIN
        moved = {f: float(np.abs(np.subtract(v, losses["f32"])).max())
                 for f, v in losses.items() if f != "f32"}
        print(f"{cfg.name}: losses {losses}; max |moved| from f32 {moved}")
    return 0


def main() -> int:
    if sys.argv[1:2] == ["--smoke-train"]:
        return smoke_train(sys.argv[2:])
    B, Sq, Hq, Hkv, Dh, Sk, off = CASE
    for seed in range(DRAWS):
        rng = np.random.default_rng(1000 + seed)
        q, k, v, do = (torch.from_numpy(rng.standard_normal(s).astype(
            np.float32)).bfloat16() for s in (
                (B, Sq, Hq, Dh), (B, Sk, Hkv, Dh), (B, Sk, Hkv, Dh),
                (B, Sq, Hq, Dh)))
        o, lse = ref.flash_attention(q, k, v, return_lse=True, q_offset=off)
        want = exact(q, k, v, do, off)
        errs = {}
        for form in ("f32", "bf16", "two parts"):
            got = backward(q, k, v, o, lse, do, off, form)
            errs[form] = [float((g.double() - e).abs().max() / e.abs().max())
                          for g, e in zip(got, want)]
        line = []
        for form, e in errs.items():
            ratio = [a / b for a, b in zip(e, errs["f32"])]
            line.append(f"{form} dq/dk/dv " + " ".join(f"{x:.3e}" for x in e)
                        + " (" + " ".join(f"{r:.2f}x" for r in ratio) + ")")
        print(f"draw {seed}: " + "; ".join(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
