"""GraphSAGE and GCN over fixed-fanout sampled subgraphs (paper §2, §6.1).

The sampled mini-batch is the padded tensor form of the paper's 2-hop
25x10 GraphSAGE workflow (Figure 1):

  feats_0 (B, D)          seed features
  feats_1 (B, f1, D)      hop-1 neighbor features
  feats_2 (B, f1, f2, D)  hop-2 neighbor features
  mask_l  same shape minus D  (False = padded / zero-degree slot)

AGGREGATE = masked mean; UPDATE = W_self h + W_neigh a  (SAGE) or
W (mean(h ∪ N(h)))  (GCN); hidden dim 256, 2 layers as in the paper.
Weights keep the reference package's ``(d_in, d_out)`` layout (``h @ w``).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.params import Def


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    name: str = "graphsage"
    model: str = "sage"  # sage | gcn
    feat_dim: int = 128
    hidden: int = 256
    n_classes: int = 32
    fanouts: tuple = (25, 10)
    batch_size: int = 8000
    lr: float = 1e-3


def defs(cfg: GNNConfig) -> dict:
    L = len(cfg.fanouts)
    out = {}
    d_in = cfg.feat_dim
    for l in range(L):
        d_out = cfg.hidden
        if cfg.model == "sage":
            out[f"layer{l}"] = {
                "w_self": Def((d_in, d_out), ("embed", "ff")),
                "w_neigh": Def((d_in, d_out), ("embed", "ff")),
                "b": Def((d_out,), ("ff",), init="zeros"),
            }
        else:  # gcn
            out[f"layer{l}"] = {
                "w": Def((d_in, d_out), ("embed", "ff")),
                "b": Def((d_out,), ("ff",), init="zeros"),
            }
        d_in = d_out
    out["head"] = Def((d_in, cfg.n_classes), ("ff", None))
    return out


def masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean over the second-to-last axis with a validity mask."""
    m = mask.to(x.dtype)[..., None]
    s = (x * m).sum(dim=-2)
    c = m.sum(dim=-2).clamp_min(1.0)
    return s / c


def _apply_layer(cfg: GNNConfig, p: dict, h_self: torch.Tensor,
                 h_agg: torch.Tensor) -> torch.Tensor:
    if cfg.model == "sage":
        out = h_self @ p["w_self"] + h_agg @ p["w_neigh"] + p["b"]
    else:
        out = 0.5 * (h_self + h_agg) @ p["w"] + p["b"]
    return torch.relu(out)


def forward(cfg: GNNConfig, params: dict, batch: dict) -> torch.Tensor:
    """batch: feats_0..feats_L, mask_1..mask_L -> logits (B, n_classes)."""
    L = len(cfg.fanouts)
    h = [batch[f"feats_{l}"] for l in range(L + 1)]
    for l in range(L):
        p = params[f"layer{l}"]
        new_h = []
        for lev in range(L - l):
            agg = masked_mean(h[lev + 1], batch[f"mask_{lev + 1}"])
            new_h.append(_apply_layer(cfg, p, h[lev], agg))
        h = new_h
    return h[0] @ params["head"]


def loss_fn(cfg: GNNConfig, params: dict, batch: dict):
    logits = forward(cfg, params, batch).to(torch.float32)
    labels = batch["labels"].to(torch.int64)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[:, None])[:, 0]
    loss = (lse - ll).mean()
    acc = (logits.argmax(-1) == labels).to(torch.float32).mean()
    return loss, {"acc": acc}
