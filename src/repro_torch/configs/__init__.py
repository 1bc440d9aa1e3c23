"""Architecture registry: ``--arch <id>`` resolves here.

The port carries the dense and MoE language-model configurations (the LM
serving path runs them through ``models/transformer.py``); the reference
package's other architectures wait for their model families and raise
``NotImplementedError`` naming the ROADMAP item that ports them.
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
    "stablelm-3b": "stablelm",
    "minitron-4b": "minitron",
    "gemma3-1b": "gemma3",
    "qwen2.5-14b": "qwen25",
}

# the reference's other architectures -> the ROADMAP item that ports them
_NOT_PORTED = {
    "seamless-m4t-large-v2": "ROADMAP queue 1: the encdec/audio family",
    "zamba2-1.2b": "ROADMAP queue 1: the SSM and hybrid families",
    "mamba2-780m": "ROADMAP queue 1: the SSM and hybrid families",
    "chameleon-34b": "ROADMAP queue 1: the remaining dense/vlm configs",
}

ARCH_IDS = tuple(_ARCH_MODULES)


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch in _NOT_PORTED:
        raise NotImplementedError(
            f"arch {arch!r} is not ported yet ({_NOT_PORTED[arch]}); "
            f"ported: {ARCH_IDS}")
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch]}")
    return mod.SMOKE if smoke else mod.CONFIG
