"""Importable demo payloads for the serving and cluster tiers' tests.

Port of ``repro.serving.demo``. Worker processes re-link task payloads *by
registered name* (the TDG JSON carries symbols, not code — the paper's
compiler-emitted-TDG contract), so any payload driven through
:class:`~repro_torch.serving.cluster.ClusterFrontend` must live in a module
both the frontend and the spawned workers can import. Pass
``registry="repro_torch.serving.demo:DEMO_REGISTRY"``.
"""
from __future__ import annotations

import torch

from ..core.serialize import TaskFnRegistry
from ..core.tdg import TDG

DEMO_REGISTRY = TaskFnRegistry()


@DEMO_REGISTRY.register("demo_mix")
def demo_mix(x, w):
    """The serving benchmark's body: a tanh-matmul residual mix."""
    return torch.tanh(x @ w) * 0.5 + x


@DEMO_REGISTRY.register("demo_affine")
def demo_affine(x, w):
    """A second, structurally distinguishable payload (different symbol)."""
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
