"""Model zoo dispatch: family -> the module implementing the uniform API

  defs(cfg) -> param Def tree
  forward(cfg, params, tokens)       full sequence
  prefill(cfg, params, tokens, max_len=...) -> (logits, cache)
  decode_step(cfg, params, cache, tokens, pos) -> (logits, cache)

The GNNs have their own API (``repro_torch.models.gnn``).
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer

# families not ported yet -> the ROADMAP item that ports them
_NOT_PORTED = {
    "ssm": "ROADMAP queue 1: the SSM and hybrid families",
    "hybrid": "ROADMAP queue 1: the SSM and hybrid families",
    "encdec": "ROADMAP queue 1: the encdec/audio family",
    "audio": "ROADMAP queue 1: the encdec/audio family",
}


def get_module(cfg: ModelConfig):
    if cfg.family in ("dense", "moe", "vlm"):
        return transformer
    if cfg.family in _NOT_PORTED:
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet "
                                  f"({_NOT_PORTED[cfg.family]})")
    if cfg.family == "gnn":
        raise ValueError(f"family {cfg.family} has a dedicated API (see "
                         "repro_torch.models.gnn)")
    raise KeyError(f"unknown family {cfg.family!r}")
