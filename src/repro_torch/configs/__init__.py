"""Architecture registry: ``get_config(arch_id)``.

Ported so far: the dense ``qwen2.5-3b``, the MoE ``qwen3-moe-30b-a3b`` and
the SSM ``mamba2-370m``; the other architectures of the reference wait on
their model families (see ROADMAP.md).
"""
from __future__ import annotations

import importlib

from .base import ModelConfig, reduced

_ARCH_MODULES = {
    "qwen2.5-3b": "qwen2_5_3b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "mamba2-370m": "mamba2_370m",
}

ARCHS = tuple(_ARCH_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; available: {sorted(_ARCH_MODULES)}")
    mod = importlib.import_module(f".{_ARCH_MODULES[arch]}", __package__)
    return mod.CONFIG


__all__ = ["ARCHS", "ModelConfig", "get_config", "reduced"]
