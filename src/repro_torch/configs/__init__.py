"""Architecture registry: ``get_config(arch_id)``.

Ported so far: the dense ``qwen2.5-3b``, the MoE ``qwen3-moe-30b-a3b`` and
the SSM ``mamba2-370m``; the other architectures of the reference wait on
their model families (see ROADMAP.md). :func:`register` adds a config
under a name of its own (an example's model), which :func:`get_config` and
:func:`archs` then know.
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

_REGISTERED: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> None:
    """Make ``cfg`` available as ``get_config(cfg.name)``."""
    if cfg.name in _ARCH_MODULES:
        raise ValueError(f"{cfg.name!r} names a ported architecture")
    _REGISTERED[cfg.name] = cfg


def archs() -> tuple[str, ...]:
    """The ported architectures, then the registered configs."""
    return ARCHS + tuple(_REGISTERED)


def get_config(arch: str) -> ModelConfig:
    if arch in _REGISTERED:
        return _REGISTERED[arch]
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; available: {sorted(archs())}")
    mod = importlib.import_module(f".{_ARCH_MODULES[arch]}", __package__)
    return mod.CONFIG


__all__ = ["ARCHS", "ModelConfig", "archs", "get_config", "reduced", "register"]
