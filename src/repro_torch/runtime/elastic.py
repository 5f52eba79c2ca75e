"""Elastic scaling: restart on a different device count (port of
``repro.runtime.elastic``).

Checkpoints are host trees (device-agnostic); re-meshing is therefore:
load, then place each leaf on the NEW mesh by its partition spec
(:func:`reshard_checkpoint`, the counterpart of the reference's
``device_put`` with the new shardings). A leaf whose dims the new mesh does
not divide falls back to replication on those dims, the sanitize rule of
launch-time sharding. One controller drives every position, and its train
step (``training.step.make_train_step(mesh=...)``) takes each leaf whole on
the params' device: :func:`gather_checkpoint` assembles a resharded tree
there, which is the all-gather the single controller's plan needs.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from ..launch.mesh import ReplayMesh
from ..sharding import partition as P_


def elastic_restart_plan(old_chips: int, new_chips: int,
                         global_batch: int) -> dict:
    """Batch/mesh bookkeeping when the pod shrinks or grows."""
    if new_chips <= 0:
        raise ValueError("new_chips must be positive")
    plan = {"old_chips": old_chips, "new_chips": new_chips}
    # keep global batch fixed (training semantics unchanged); adjust
    # per-device microbatch, dropping to grad-accumulation if needed
    if global_batch % new_chips == 0:
        plan["per_device_batch"] = global_batch // new_chips
        plan["grad_accum"] = 1
    else:
        accum = 1
        while global_batch % (new_chips * accum) and accum < 64:
            accum += 1
        plan["per_device_batch"] = max(1, global_batch // (new_chips * accum))
        plan["grad_accum"] = accum
    return plan


class Resharded(NamedTuple):
    """A leaf placed on a mesh: each position's slice (row-major, on the
    position's device), the sanitized spec and the whole leaf's shape (what
    a ``jax.Array`` with a ``NamedSharding`` holds)."""
    parts: tuple
    spec: P_.PartitionSpec
    shape: tuple


def reshard_checkpoint(tree: Any, mesh: ReplayMesh, rules=None) -> Any:
    """Place a host-resident checkpoint tree (nested dicts of tensors or
    numpy arrays) onto a (new) mesh: every leaf becomes :class:`Resharded`,
    each position's slice by ``partition.param_shardings`` (a leaf is
    specced by its dotted path, so ``opt_state.mu.layers.0.attn.wq.w``
    shards as the param it moments)."""
    flat = {n: torch.as_tensor(v) if isinstance(v, np.ndarray) else v
            for n, v in P_.flatten_tree(tree).items()}
    specs = P_.param_pspecs(flat, mesh, rules)
    parts = P_.param_shardings(flat, mesh, rules)
    return P_.unflatten_like(tree, {
        n: Resharded(parts[n], P_.sanitize_spec(tuple(x.shape), specs[n], mesh),
                     tuple(x.shape))
        for n, x in flat.items()})


def gather_checkpoint(tree: Any, mesh: ReplayMesh, device: torch.device | str) -> Any:
    """A :func:`reshard_checkpoint` tree's leaves whole on ``device``."""
    return P_.unflatten_like(tree, {n: P_.unplace(r.parts, r.spec, r.shape, mesh, device)
                                    for n, r in P_.flatten_tree(tree).items()})
