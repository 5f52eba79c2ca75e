"""Architecture registry: ``get_config(arch_id)``.

The reference's ten architectures: dense (``qwen2.5-3b``, ``glm4-9b``,
``minicpm-2b``, ``minitron-8b``), VLM (``chameleon-34b``, dense with
qk-norm), MoE (``qwen3-moe-30b-a3b``, ``llama4-scout-17b-a16e``), SSM
(``mamba2-370m``), hybrid attention ∥ SSM (``hymba-1.5b``) and
encoder-decoder (``whisper-small``). :func:`register` adds a config
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
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "glm4-9b": "glm4_9b",
    "minitron-8b": "minitron_8b",
    "minicpm-2b": "minicpm_2b",
    "whisper-small": "whisper_small",
    "hymba-1.5b": "hymba_1_5b",
    "chameleon-34b": "chameleon_34b",
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
