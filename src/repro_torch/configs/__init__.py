"""Architecture registry: ``get_config(arch_id)``.

The reference's ten architectures: dense (``qwen2.5-3b``, ``glm4-9b``,
``minicpm-2b``, ``minitron-8b``), VLM (``chameleon-34b``, dense with
qk-norm), MoE (``qwen3-moe-30b-a3b``, ``llama4-scout-17b-a16e``), SSM
(``mamba2-370m``), hybrid attention ∥ SSM (``hymba-1.5b``) and
encoder-decoder (``whisper-small``). The port serves one architecture
the reference lacks, ``granite-4.0-h-small`` (Mamba-2 and attention layers
by kind, each with a share of 72 experts): :data:`PORT_ARCHS`, which
:func:`get_config` and :func:`archs` know and :data:`ARCHS` and
:func:`all_configs` (the reference's ten) do not. :func:`register` adds a config
under a name of its own (an example's model), which :func:`get_config` and
:func:`archs` then know.
"""
from __future__ import annotations

import importlib

from .base import SHAPES, ModelConfig, ShapeConfig, reduced, shape_applicable

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

#: Architectures the port alone serves (no JAX counterpart), by module.
_PORT_MODULES = {"granite-4.0-h-small": "granite_4_0_h_small"}
PORT_ARCHS = tuple(_PORT_MODULES)

_REGISTERED: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> None:
    """Make ``cfg`` available as ``get_config(cfg.name)``."""
    if cfg.name in _ARCH_MODULES or cfg.name in _PORT_MODULES:
        raise ValueError(f"{cfg.name!r} names a ported architecture")
    _REGISTERED[cfg.name] = cfg


def archs() -> tuple[str, ...]:
    """The ported architectures, the port's own, then the registered configs."""
    return ARCHS + PORT_ARCHS + tuple(_REGISTERED)


def get_config(arch: str) -> ModelConfig:
    if arch in _REGISTERED:
        return _REGISTERED[arch]
    module = _ARCH_MODULES.get(arch) or _PORT_MODULES.get(arch)
    if module is None:
        raise KeyError(f"unknown arch {arch!r}; available: {sorted(archs())}")
    mod = importlib.import_module(f".{module}", __package__)
    return mod.CONFIG


def all_configs() -> dict[str, ModelConfig]:
    """The ten ported architectures' configs, by name."""
    return {a: get_config(a) for a in ARCHS}


__all__ = ["ARCHS", "PORT_ARCHS", "SHAPES", "ModelConfig", "ShapeConfig", "all_configs",
           "archs", "get_config", "reduced", "register", "shape_applicable"]
