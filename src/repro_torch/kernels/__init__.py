"""Kernel substrate: registry, plain versions and the CUDA kernels' wrappers.

The wrapper modules are ``kernels.rmsnorm`` and ``kernels.flash_attention``;
each keeps its kernel's launch counter (``launches``).
"""
from . import flash_attention, ops, ref, registry, rmsnorm

__all__ = ["flash_attention", "ops", "ref", "registry", "rmsnorm"]
