"""Model zoo dispatch: family -> the module implementing the uniform API

  defs(cfg) -> param Def tree
  loss_fn(cfg, params, batch) -> (loss, metrics)
  forward(...)                        full sequence
  prefill(cfg, params, inputs, max_len=...) -> (logits, cache or state)
  decode_step(cfg, params, cache, tokens, pos) -> (logits, cache)

``inputs`` is the prompt tokens (B, P), or for the encoder-decoder
families the batch ``{"frames", "tokens"}``.  The GNNs have their own API
(``repro_torch.models.gnn``).
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec, ssm_lm, transformer

_FAMILY_MODULE = {
    "dense": transformer,
    "moe": transformer,
    "vlm": transformer,
    "ssm": ssm_lm,
    "hybrid": ssm_lm,
    "encdec": encdec,
    "audio": encdec,
    "gnn": None,  # handled by repro_torch.models.gnn
}


def get_module(cfg: ModelConfig):
    if cfg.family not in _FAMILY_MODULE:
        raise KeyError(f"unknown family {cfg.family!r}")
    m = _FAMILY_MODULE[cfg.family]
    if m is None:
        raise ValueError(f"family {cfg.family} has a dedicated API (see "
                         "repro_torch.models.gnn)")
    return m
