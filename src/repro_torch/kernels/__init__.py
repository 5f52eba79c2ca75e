"""Kernel substrate: registry, plain versions and the CUDA kernels' wrappers.

The wrapper modules are ``kernels.rmsnorm``, ``kernels.flash_attention``,
``kernels.moe_gmm`` and ``kernels.ssd_scan``; each keeps its kernel's
launch counter (``launches``).
"""
from . import (flash_attention, moe_gmm, ops, ref, registry, rmsnorm, ssd_scan,
               xla_attention)

__all__ = ["flash_attention", "moe_gmm", "ops", "ref", "registry", "rmsnorm",
           "ssd_scan", "xla_attention"]
