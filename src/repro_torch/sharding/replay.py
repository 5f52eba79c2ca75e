"""Mesh-sharded replay: spread a stacked lane axis over the mesh's devices
(port of ``repro.sharding.replay``).

Fused replay (``core/fuse.py``, ``serving/server.py``) turns a wave of
isomorphic tasks, or a batch of coalesced tenant requests, into ONE
``torch.func.vmap`` call over a stacked leading axis. Every lane of that
axis is independent, so the axis is the unit of data parallelism: split it
into contiguous chunks, one a batch shard, run each chunk's call on its
shard's device and gather the results on the caller's device. The lanes'
op sequence is unchanged. This module holds the policy:

* :func:`resolve_mesh` turns a ``mesh=`` argument (``"auto"`` | ``None`` |
  a :class:`~repro_torch.launch.mesh.ReplayMesh`) into the mesh used,
  honouring :func:`~repro_torch.sharding.partition.use_mesh` scopes and the
  ``REPRO_MESH`` knob (``N`` devices, ``all``, or ``0`` / ``off``). A mesh
  whose batch axis has size 1 resolves to ``None``: "sharded" is never a
  one-way split in disguise.
* :func:`mesh_fingerprint` is the JSON-stable identity (``"data=8"``) that
  keys intern caches, ``WarmPool`` entries and
  ``serialize.topology_fingerprint``, so single-device and N-device
  programs never collide and a foreign artifact is refused.
* :func:`pad_group` pads a class to a batch-axis multiple (repeating its
  last member); :func:`shard_leading` splits stacked leaves into the
  per-shard chunks; :func:`gather_leading` joins chunks on the home device.

A single process drives every shard, one after the other on the host; on
one card (virtual shards) the shards' work queues on that card's stream.
"""
from __future__ import annotations

import contextlib
import copy
import os
import threading
import weakref
from typing import Any

import torch
from torch import nn
from torch.utils import _pytree as pytree

from . import partition as _partition
from ..launch.mesh import ReplayMesh

#: Env knob: ``REPRO_MESH=N`` shards fused replay over N devices (the first
#: N cards, or N shards of the host without one), ``all`` over every card;
#: unset / ``0`` / ``off`` disables.
MESH_ENV = "REPRO_MESH"

_OFF = ("", "0", "off", "false", "no", "none")

# env spec -> mesh, keyed by (raw value, visible device count) so a test
# that monkeypatches the env (or a process that gains devices) never sees
# a stale mesh.
_env_cache: dict[tuple[str, int], ReplayMesh] = {}


def _visible_cards() -> int:
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def mesh_from_env() -> ReplayMesh | None:
    """The ``REPRO_MESH``-configured replay mesh (``None`` = disabled): on
    the cards when there are any, else shards of the host."""
    raw = os.environ.get(MESH_ENV, "").strip().lower()
    if raw in _OFF:
        return None
    cards = _visible_cards()
    key = (raw, cards)
    mesh = _env_cache.get(key)
    if mesh is None:
        from ..launch import mesh as _launch_mesh

        device = "cuda" if cards else "cpu"
        if raw == "all":
            mesh = _launch_mesh.make_replay_mesh(device=device)
        else:
            try:
                n = int(raw)
            except ValueError:
                raise ValueError(f"{MESH_ENV}={raw!r} is not a device count, 'all', "
                                 "or 0/off") from None
            mesh = _launch_mesh.make_replay_mesh(n, device=device)
        _env_cache[key] = mesh
    return mesh


def batch_axes(mesh: ReplayMesh | None) -> tuple[str, ...]:
    """The mesh axes the ``"batch"`` rule resolves to, in order."""
    if mesh is None:
        return ()
    axis = _partition.resolve_axis("batch", mesh, _partition.DEFAULT_RULES)
    if axis is None:
        return ()
    return axis if isinstance(axis, tuple) else (axis,)


def batch_axis_size(mesh: ReplayMesh | None) -> int:
    """How many ways ``mesh`` splits the replay batch axis (1 = no split)."""
    n = 1
    for a in batch_axes(mesh):
        n *= mesh.shape[a]
    return n


def resolve_mesh(mesh: Any = "auto") -> ReplayMesh | None:
    """Resolve a ``mesh=`` argument to the mesh replay will use.

    An explicit :class:`ReplayMesh` wins; ``"auto"`` takes the ambient
    :func:`partition.use_mesh` scope, then ``REPRO_MESH``; ``None`` forces
    single-device. A result that cannot split the batch axis at least 2
    ways resolves to ``None``.
    """
    if mesh is None:
        return None
    if isinstance(mesh, ReplayMesh):
        resolved = mesh
    elif isinstance(mesh, str) and mesh == "auto":
        resolved = _partition.active_mesh()
        if resolved is None:
            resolved = mesh_from_env()
    else:
        raise ValueError(f"mesh must be a ReplayMesh, None or 'auto', got {mesh!r}")
    if resolved is None or batch_axis_size(resolved) <= 1:
        return None
    return resolved


def mesh_fingerprint(mesh: ReplayMesh | None) -> str | None:
    """JSON-stable identity of a replay mesh (``"data=8"``; ``None`` = off).

    This string, not the mesh, keys intern caches and ``WarmPool`` entries
    and rides inside ``serialize.topology_fingerprint`` across the cluster
    tier's JSON wire, so it stays a plain string.
    """
    if mesh is None:
        return None
    return ",".join(f"{name}={size}" for name, size in mesh.shape.items())


def pad_group(members: list, mesh: ReplayMesh | None) -> int:
    """Extend ``members`` (in place) to a batch-axis multiple; return #pads.

    Padding repeats the last member, so padded lanes run the same program
    as real ones and are never read back.
    """
    if mesh is None or not members:
        return 0
    pad = (-len(members)) % batch_axis_size(mesh)
    members.extend(members[-1:] * pad)
    return pad


def shard_coords(mesh: ReplayMesh) -> list[dict[str, int]]:
    """Each batch shard's coordinates on the batch axes, in shard order."""
    axes = batch_axes(mesh)
    out = []
    for i in range(batch_axis_size(mesh)):
        coords = {}
        for a in reversed(axes):
            i, coords[a] = divmod(i, mesh.shape[a])
        out.append(coords)
    return out


def shard_devices(mesh: ReplayMesh) -> list[torch.device]:
    """The device each batch shard runs on, in shard order: the position
    whose batch coordinates are the shard's and whose other coordinates are
    0 (a single controller runs each batch shard once)."""
    return [mesh.device_at(c) for c in shard_coords(mesh)]


def lane_chunks(n_lanes: int, mesh: ReplayMesh) -> list[tuple[torch.device, int, int]]:
    """``(device, start, stop)`` of each batch shard's contiguous lanes;
    ``n_lanes`` must be a batch-axis multiple (see :func:`pad_group`)."""
    devices = shard_devices(mesh)
    if n_lanes % len(devices):
        raise ValueError(f"{n_lanes} lanes do not split {len(devices)} ways; pad first")
    m = n_lanes // len(devices)
    return [(d, k * m, (k + 1) * m) for k, d in enumerate(devices)]


# Replicas of a module on another device, made once and kept while the
# module lives.
_module_replicas: "weakref.WeakKeyDictionary[nn.Module, dict]" = weakref.WeakKeyDictionary()


def _module_device(mod: nn.Module) -> torch.device | None:
    for t in list(mod.parameters()) + list(mod.buffers()):
        return t.device
    return None


def replicate(tree: Any, device: torch.device) -> Any:
    """``tree`` on ``device``: tensors already there as they are (never
    copied), others copied; a module on another device replaced by its
    replica there, made once."""
    def leaf(v):
        if isinstance(v, torch.Tensor):
            return v.to(device)
        if isinstance(v, nn.Module):
            home = _module_device(v)
            if home is None or home == device:
                return v
            per = _module_replicas.setdefault(v, {})
            if device not in per:
                per[device] = copy.deepcopy(v).to(device)
            return per[device]
        return v
    return pytree.tree_map(leaf, tree, is_leaf=lambda v: isinstance(v, nn.Module))


def shard_leading(tree: Any, mesh: ReplayMesh | None) -> list:
    """Split every tensor leaf's leading (stacked lane) dim into the batch
    shards' contiguous chunks, each on its shard's device: one tree a
    shard. A leaf whose leading dim the batch axis does not divide (or a
    0-dim one) is replicated to every shard instead, as the reference's
    ``sanitize_spec`` leaves it. Without a mesh: ``[tree]``."""
    if mesh is None:
        return [tree]
    devices = shard_devices(mesh)
    n = len(devices)

    def part(k: int, device: torch.device):
        def leaf(x):
            if not isinstance(x, torch.Tensor) or x.dim() == 0 or x.shape[0] % n:
                return replicate(x, device)
            m = x.shape[0] // n
            return x.narrow(0, k * m, m).to(device)
        return pytree.tree_map(leaf, tree, is_leaf=lambda v: isinstance(v, nn.Module))

    return [part(k, d) for k, d in enumerate(devices)]


def gather_leading(parts: list, home: torch.device) -> Any:
    """Concatenate per-shard trees leaf by leaf along the leading dim, on
    ``home`` (the caller's device)."""
    return pytree.tree_map(lambda *xs: torch.cat([x.to(home) for x in xs]), *parts)


def on_device(device: torch.device):
    """Make ``device`` current for a shard's call (a CUDA device), so its
    kernels launch there."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


class _Position(threading.local):
    parts: tuple = ()


_POSITION = _Position()


@contextlib.contextmanager
def at_position(mesh: ReplayMesh, coords: dict[str, int], inbound: str, outbound: str):
    """Run one mesh position's part of a single-controller call: the
    position's device is made current and the part is named, so an
    observer (``launch.dryrun``'s per-position counts) can attribute the
    work and the data that moves. ``inbound`` / ``outbound`` name the
    reference's collective that carries data into and out of the part
    (``"all-gather"`` and ``"all-reduce"`` for a batch shard of a train
    step, ``"all-to-all"`` for an expert shard, ``"collective-permute"``
    for a pipeline stage). Parts nest (an expert shard inside a batch
    shard); outside every part the caller's code runs at position 0."""
    part = (mesh.index_at(coords), inbound, outbound)
    _POSITION.parts = _POSITION.parts + (part,)
    try:
        with on_device(mesh.device_at(coords)):
            yield
    finally:
        _POSITION.parts = _POSITION.parts[:-1]


def current_part() -> tuple[int, int, str | None, str | None]:
    """``(position, depth, inbound, outbound)`` of the innermost running
    :func:`at_position` part; ``(0, 0, None, None)`` outside every part."""
    if not _POSITION.parts:
        return 0, 0, None, None
    index, inbound, outbound = _POSITION.parts[-1]
    return index, len(_POSITION.parts), inbound, outbound
