"""Pipeline parallelism lowered from the pipeline TDG (port of
``repro.core.pipeline``).

``schedule.pipeline_tdg`` / ``one_f_one_b_order`` define the *logical*
schedule (the static taskgraph). This module executes its forward on a
mesh axis, GPipe style: stage s holds its slice of the stacked stage
params and microbatches flow s -> s+1. The loop runs the waves of
``topo_waves(pipeline_tdg(S, M, include_backward=False))`` themselves: in
wave t every active stage s applies ``stage_fn`` to microbatch t - s on its
position's device, and its output moves to the next stage's device with
``.to(...)``, the counterpart of the reference's ``ppermute`` (one
collective-permute per TDG activation edge). The last stage's outputs come
back to the caller's device.

One controller drives every stage, one task after the other within a wave
(the reference's ``shard_map`` runs the stages of a wave in one SPMD
program). Each task is the unsharded ``stage_fn`` call at that stage's
slice and microbatch, so the outputs are bitwise those of applying the
stack microbatch by microbatch. The backward pass is autograd through the
rotation, as the reference differentiates through ``ppermute``.
"""
from __future__ import annotations

from typing import Any, Callable

import torch
from torch.utils import _pytree as pytree

from ..launch.mesh import ReplayMesh
from ..sharding import replay as _shreplay
from .schedule import pipeline_tdg, topo_waves


def pipeline_apply(
    stage_fn: Callable,            # (stage_params, x) -> y  (one stage)
    stage_params: Any,             # pytree, leaves stacked on a leading S dim
    x_microbatches: torch.Tensor,  # (M, mb, ...) microbatched input
    mesh: ReplayMesh,
    axis: str = "stage",
) -> torch.Tensor:
    """Forward pipeline: the (M, mb, ...) outputs of the LAST stage, on
    ``x_microbatches``' device.

    Steady-state utilization M/(M+S-1), the classic GPipe bubble (see
    :func:`bubble_fraction`); the 1F1B variant reorders the backward into
    the bubble (``schedule.one_f_one_b_order``) with the same wave count.
    """
    S = mesh.shape[axis]
    M = x_microbatches.shape[0]
    home = x_microbatches.device
    tdg = pipeline_tdg(S, M, include_backward=False)
    devices = [mesh.device_at({axis: s}) for s in range(S)]
    params = [pytree.tree_map(lambda a, _s=s: a[_s].to(devices[_s]), stage_params)
              for s in range(S)]
    acts: dict[tuple[int, int], torch.Tensor] = {}   # (microbatch, stage) -> output
    outs: list[torch.Tensor | None] = [None] * M
    for wave in topo_waves(tdg):
        for tid in wave:
            meta = tdg.tasks[tid].metadata
            m, s = meta["microbatch"], meta["stage"]
            with _shreplay.at_position(mesh, {axis: s}, "collective-permute",
                                       "collective-permute"):
                x = x_microbatches[m] if s == 0 else acts.pop((m, s - 1))
                y = stage_fn(params[s], x.to(devices[s]))
            if s == S - 1:
                outs[m] = y.to(home)
            else:
                acts[(m, s)] = y
    return torch.stack(outs)


def pipeline_waves(n_stages: int, n_microbatches: int) -> int:
    """Forward wave count = TDG depth (checked against topo_waves in tests)."""
    return n_microbatches + n_stages - 1


def bubble_fraction(n_stages: int, n_microbatches: int) -> float:
    return (n_stages - 1) / (n_microbatches + n_stages - 1)
