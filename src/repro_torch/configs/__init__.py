"""Architecture registry: ``--arch <id>`` resolves here.

The reference package's ten language-model architectures, field for field:
the dense, MoE and vlm configs run through ``models/transformer.py``, the
SSM and hybrid ones through ``models/ssm_lm.py``, the encoder-decoder
(audio) one through ``models/encdec.py``.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (SHAPES, ModelConfig, ShapeConfig,
                                      applicable_shapes)

__all__ = ["SHAPES", "ModelConfig", "ShapeConfig", "applicable_shapes",
           "ARCH_IDS", "get_config"]

_ARCH_MODULES = {
    "phi3.5-moe-42b-a6.6b": "phi35_moe",
    "dbrx-132b": "dbrx",
    "seamless-m4t-large-v2": "seamless",
    "stablelm-3b": "stablelm",
    "minitron-4b": "minitron",
    "gemma3-1b": "gemma3",
    "qwen2.5-14b": "qwen25",
    "zamba2-1.2b": "zamba2",
    "mamba2-780m": "mamba2_780m",
    "chameleon-34b": "chameleon",
}

ARCH_IDS = tuple(_ARCH_MODULES)


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch]}")
    return mod.SMOKE if smoke else mod.CONFIG
