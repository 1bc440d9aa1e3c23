#!/usr/bin/env python3
"""How far the flash-attention kernel and its plain version each sit from
exact attention when a row sees few keys.

    python3 tools/flash_window_noise.py      # on a CUDA card

Both round p to bf16 before p . v, against different running maxima (the
kernel's 64-key tiles, the plain version's one block of up to 1024 keys).
Over many keys those rounding errors average out; over a window of a few
keys they do not, and an output that cancels to near 0 can then differ by
more than the card tests' absolute tolerance.  For each window this prints
the largest |difference| of the plain version and of the kernel from exact
attention (f64 softmax of the same bf16(q * scale) . k, f64 p . v), of the
kernel from the plain version, and how many outputs fall outside
rtol 1e-2 + atol 2e-3 of the plain version.  Seeded random q, k, v of one
gemma3-like head group: 1000 positions, 4 query heads over 1 kv head.
"""
from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("flash_window_noise: needs a CUDA card", file=sys.stderr)
        return 2
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    gen = torch.Generator(device="cuda").manual_seed(6)
    B, S, Hq, Hkv = 1, 1000, 4, 1
    print(f"[noise] {torch.cuda.get_device_name(0)}; B {B}, S {S}, "
          f"{Hq} query heads over {Hkv}, causal, bf16")
    for window in (1, 8, 40, 64, 512):
        for Dh in (256, 128):
            q, k, v = (torch.randn((B, S, h, Dh), generator=gen,
                                   device="cuda").bfloat16()
                       for h in (Hq, Hkv, Hkv))
            got = fa.flash_attention(q, k, v, window=window).double()
            want = ref.flash_attention(q, k, v, window=window).double()
            scale = torch.tensor(Dh ** -0.5, dtype=q.dtype, device="cuda")
            s = torch.einsum("bqhd,bkd->bhqk", (q * scale).double(),
                             k[:, :, 0].double())
            i = torch.arange(S, device="cuda")
            seen = (i[:, None] >= i[None, :]) & (i[:, None] - i[None, :]
                                                 < window)
            exact = torch.einsum(
                "bhqk,bkd->bqhd", s.masked_fill(~seen, float("-inf"))
                .softmax(-1), v[:, :, 0].double())
            outside = (got - want).abs() > 2e-3 + 1e-2 * want.abs()
            print(f"[noise] window {window:4d} Dh {Dh}: max |plain - exact| "
                  f"{float((want - exact).abs().max()):.3e}, |kernel - "
                  f"exact| {float((got - exact).abs().max()):.3e}, |kernel "
                  f"- plain| {float((got - want).abs().max()):.3e}; outside "
                  f"the tolerance {int(outside.sum())} of {outside.numel()}",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
