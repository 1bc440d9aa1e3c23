"""The attention backward's error at a query offset against the f64 gradient,
on the card: the kernel and its plain version, each fed the forward kernel's
o and lse and the plain forward's (so that a difference in those shows).

    python3 tools/offset_bwd_error.py

For each case (B, Sq, Hq, Hkv, Dh, Sk, window, q_offset, seed): per gradient,
max |g - exact| / max |exact| of the kernel, of the plain version, of the
kernel fed the plain forward's o and lse, and of the plain version fed the
kernel's; and how far the forward kernel's o and lse are from the plain
forward's.  ``chip_smoke.py``'s ``check_backward`` holds the kernel within
twice the plain version's error + 1e-3.  Needs a CUDA card.
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

# phi3.5-moe's heads over 512 keys: a block at offset 384 (its rows see
# 385-512 keys) in three draws, the same at offset 0, over 128 keys, and a
# larger block
CASES = ((1, 128, 32, 8, 128, 512, 0, 384, 0),
         (1, 128, 32, 8, 128, 512, 0, 384, 1),
         (1, 128, 32, 8, 128, 512, 0, 384, 2),
         (1, 128, 32, 8, 128, 512, 0, 0, 0),
         (1, 128, 32, 8, 128, 128, 0, 0, 0),
         (2, 256, 32, 8, 128, 512, 0, 256, 0))


def exact(q, k, v, do, window: int, off: int):
    """The f64 gradient over q * the bf16-rounded scale, query i at key
    position i + off."""
    Sq, Hq, Dh = q.shape[1:]
    Sk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    i = off + torch.arange(Sq, device=q.device)[:, None]
    j = torch.arange(Sk, device=q.device)[None, :]
    seen = (j <= i) & ((i - j < window) if window > 0 else True)
    qd, kd, vd = (t.double().requires_grad_() for t in (q, k, v))
    scale = float(torch.tensor(Dh ** -0.5, dtype=torch.bfloat16))
    s = torch.einsum("bqhd,bkhd->bhqk", qd * scale,
                     kd.repeat_interleave(G, 2))
    o = torch.einsum("bhqk,bkhd->bqhd",
                     s.masked_fill(~seen, float("-inf")).softmax(-1),
                     vd.repeat_interleave(G, 2))
    return torch.autograd.grad(o, (qd, kd, vd), do.double())


def main() -> int:
    if not torch.cuda.is_available():
        print("offset_bwd_error: needs a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "?"
    for B, Sq, Hq, Hkv, Dh, Sk, window, off, seed in CASES:
        rng = np.random.default_rng(1000 + seed)
        q, k, v, do = (torch.from_numpy(rng.standard_normal(s).astype(
            np.float32)).cuda().bfloat16() for s in (
            (B, Sq, Hq, Dh), (B, Sk, Hkv, Dh), (B, Sk, Hkv, Dh),
            (B, Sq, Hq, Dh)))
        kw = {"window": window, "q_offset": off}
        o, lse = fa._forward_cuda(q, k, v, True, window, True, off)
        ro, rlse = ref.flash_attention(q, k, v, return_lse=True, **kw)
        want = exact(q, k, v, do, window, off)
        runs = {"kernel": fa.flash_attention_bwd(q, k, v, o, lse, do, **kw),
                "plain": ref.flash_attention_bwd(q, k, v, ro, rlse, do,
                                                 **kw),
                "kernel(plain o, lse)": fa.flash_attention_bwd(
                    q, k, v, ro.contiguous(), rlse.contiguous(), do, **kw),
                "plain(kernel o, lse)": ref.flash_attention_bwd(
                    q, k, v, o, lse, do, **kw)}
        print(f"{(B, Sq, Hq, Hkv, Dh, Sk, window, off, seed)}: o "
              f"{float((o.float() - ro.float()).abs().max()):.3e} and lse "
              f"{float((lse - rlse).abs().max()):.3e} from the plain "
              f"forward's | {card}")
        for idx, (n, e) in enumerate(zip(("dq", "dk", "dv"), want)):
            den = float(e.abs().max())
            errs = ", ".join(
                f"{name} {float((g[idx].double() - e).abs().max()) / den:.3e}"
                for name, g in runs.items())
            print(f"    {n}: {errs} | {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
