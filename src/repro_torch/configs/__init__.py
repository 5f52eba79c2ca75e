"""Architecture registry: ``get_config(arch_id)``.

Only the dense ``qwen2.5-3b`` is ported so far; the other architectures of
the reference wait on their model families (see ROADMAP.md).
"""
from __future__ import annotations

import importlib

from .base import ModelConfig, reduced

_ARCH_MODULES = {
    "qwen2.5-3b": "qwen2_5_3b",
}

ARCHS = tuple(_ARCH_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; available: {sorted(_ARCH_MODULES)}")
    mod = importlib.import_module(f".{_ARCH_MODULES[arch]}", __package__)
    return mod.CONFIG


__all__ = ["ARCHS", "ModelConfig", "get_config", "reduced"]
