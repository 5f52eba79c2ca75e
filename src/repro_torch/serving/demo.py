"""Demo payloads and regions for the serving tier's tests and examples.

Port of ``repro.serving.demo``. The reference keeps its payloads in a
``TaskFnRegistry`` so cluster workers can re-link them by name; the port has
neither serialization (ROADMAP.md, queue A item 11) nor the cluster tier
(item 14), so the payloads are plain module-level functions.
"""
from __future__ import annotations

import torch

from ..core.tdg import TDG


def demo_mix(x, w):
    """The serving benchmark's body: a tanh-matmul residual mix."""
    return torch.tanh(x @ w) * 0.5 + x


def demo_affine(x, w):
    """A second, structurally distinguishable payload."""
    return x @ w + 1.0


def demo_region(name: str, waves: int = 2, width: int = 2, body=demo_mix) -> TDG:
    """A ``waves x width`` dependent grid over slots ``x0..x{width-1}`` + ``w``.

    Every task reads the shared weight slot ``w`` and read-modify-writes its
    private column, so consecutive waves chain RAW edges per column.
    """
    tdg = TDG(name)
    for wv in range(waves):
        for s in range(width):
            tdg.add_task(body, ins=[f"x{s}", "w"], outs=[f"x{s}"], name=f"t{wv}.{s}")
    return tdg
