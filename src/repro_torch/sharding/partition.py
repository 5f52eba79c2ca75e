"""Logical-axis partitioning (port of ``repro.sharding.partition``).

One rule table maps model-space axis names ("batch", "embed", "heads",
"ff", "experts", "vocab", "seq") to mesh axes (pod / data / model); model
code names only logical axes, and the mesh and the parallelism strategy
are decided here, once, outside the tasks.

The rule tables, the leaf table and the spec functions are the
reference's. :class:`PartitionSpec` is the port's own small tuple type;
leaf paths are the port's dotted parameter names
(``layers.1.moe.experts.up.w``). :func:`param_shardings` places each leaf
on a :class:`~repro_torch.launch.mesh.ReplayMesh`: every mesh position gets
its slice of the leaf by the leaf's sanitized spec. :func:`constrain` lays
out no data in the reference either (it only annotates): here it returns
its input.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Mapping, Sequence

import torch
from torch import nn

from ..launch.mesh import ReplayMesh

# logical axis -> candidate mesh axes (first all present are used, in order)
DEFAULT_RULES: dict[str, tuple[str, ...]] = {
    "batch": ("pod", "data"),     # data parallel
    "embed": ("data",),           # FSDP / ZeRO-3 weight sharding
    "vocab": ("model",),          # tensor parallel over vocab
    "heads": ("model",),          # tensor parallel over attention heads
    "kv_heads": ("model",),
    "ff": ("model",),             # tensor parallel over MLP hidden
    "experts": ("model",),        # expert parallel
    "ssm_inner": ("model",),
    "ssm_embed": ("data",),       # FSDP for SSM projections
    "seq": (),                    # sequence parallel (off by default)
    "kv_seq": (),                 # shard KV-cache length (long-context decode)
}

# Replicate SSM projection weights over "data".
NO_SSM_FSDP_RULES = {**DEFAULT_RULES, "ssm_embed": ()}

# Small SSM models: pure data parallel (batch over data AND model), FSDP
# over data, no vocab TP.
SSM_DP_ONLY_RULES = {**DEFAULT_RULES,
                     "batch": ("pod", "data", "model"),
                     "ssm_inner": (), "ssm_embed": ("data",),
                     "vocab": ()}


class PartitionSpec(tuple):
    """Per dim of a tensor: a mesh axis name, a tuple of them, or ``None``
    (replicated); ``jax.sharding.PartitionSpec`` as a plain tuple."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


class _Active(threading.local):
    mesh: ReplayMesh | None = None
    rules: dict[str, tuple[str, ...]] | None = None


_ACTIVE = _Active()


@contextlib.contextmanager
def use_mesh(mesh: ReplayMesh | None,
             rules: Mapping[str, tuple[str, ...]] | None = None):
    """Activate a mesh + rule table (this thread) for spec resolution,
    ``replay.resolve_mesh("auto")`` and the MoE layer's expert parallelism."""
    prev = (_ACTIVE.mesh, _ACTIVE.rules)
    _ACTIVE.mesh = mesh
    _ACTIVE.rules = dict(rules or DEFAULT_RULES)
    try:
        yield
    finally:
        _ACTIVE.mesh, _ACTIVE.rules = prev


def active_mesh() -> ReplayMesh | None:
    return _ACTIVE.mesh


def resolve_axis(logical: str | None, mesh: ReplayMesh | None = None,
                 rules: Mapping[str, tuple[str, ...]] | None = None):
    if logical is None:
        return None
    mesh = mesh or _ACTIVE.mesh
    rules = rules or _ACTIVE.rules or DEFAULT_RULES
    if mesh is None:
        return None
    axes = [a for a in rules.get(logical, ()) if a in mesh.axis_names]
    if not axes:
        return None
    return tuple(axes) if len(axes) > 1 else axes[0]


def to_pspec(logical_axes: Sequence[str | None], mesh: ReplayMesh | None = None,
             rules: Mapping[str, tuple[str, ...]] | None = None) -> PartitionSpec:
    return PartitionSpec(*(resolve_axis(a, mesh, rules) for a in logical_axes))


def constrain(x: torch.Tensor, logical_axes: Sequence[str | None]) -> torch.Tensor:
    """The reference's ``with_sharding_constraint`` against the active mesh:
    a layout annotation, which leaves values alone. Returns ``x``."""
    return x


# ---------------------------------------------------------------------------
# Parameter / state partition specs (by leaf path)
# ---------------------------------------------------------------------------

_LEAF_LOGICAL: list[tuple[tuple[str, ...], tuple[str | None, ...]]] = [
    (("table",), ("vocab", "embed")),
    (("wq", "w"), ("embed", "heads")),
    (("wk", "w"), ("embed", "heads")),
    (("wv", "w"), ("embed", "heads")),
    (("wo", "w"), ("heads", "embed")),
    (("wq", "b"), ("heads",)),
    (("wk", "b"), ("heads",)),
    (("wv", "b"), ("heads",)),
    (("up", "w"), ("embed", "ff")),
    (("gate", "w"), ("embed", "ff")),
    (("down", "w"), ("ff", "embed")),
    (("router", "w"), ("embed", None)),
    (("in_proj", "w"), ("ssm_embed", "ssm_inner")),
    (("out_proj", "w"), ("ssm_inner", "ssm_embed")),
    (("conv", "w"), (None, "ssm_inner")),
    (("conv", "b"), ("ssm_inner",)),
    # split-proj SSM layout: z/x TP-sharded, B/C/dt replicated
    (("z_proj", "w"), ("ssm_embed", "ssm_inner")),
    (("x_proj", "w"), ("ssm_embed", "ssm_inner")),
    (("b_proj", "w"), ("ssm_embed", None)),
    (("c_proj", "w"), ("ssm_embed", None)),
    (("dt_proj", "w"), ("ssm_embed", None)),
    (("xconv", "w"), (None, "ssm_inner")),
    (("xconv", "b"), ("ssm_inner",)),
    (("bconv", "w"), (None, None)),
    (("cconv", "w"), (None, None)),
    (("A_log",), ("ssm_inner",)),
    (("D",), ("ssm_inner",)),
    (("dt_bias",), ("ssm_inner",)),
]


def _path_names(path: str | Sequence[str]) -> tuple[str, ...]:
    """A dotted parameter name (or its parts) as a tuple of names."""
    return tuple(path.split(".")) if isinstance(path, str) else tuple(map(str, path))


def logical_axes_for_path(names: tuple[str, ...], ndim: int) -> tuple[str | None, ...]:
    # per-expert weights: EP owns the mesh "model" axis, expert-internal
    # dims stay unsharded (each expert lives wholly on its EP shard)
    if "experts" in names and names[-1] == "w":
        if names[-2] in ("up", "gate"):
            logical: tuple[str | None, ...] = ("experts", "embed", None)
        elif names[-2] == "down":
            logical = ("experts", None, "embed")
        else:
            logical = ("experts",) + (None,) * max(ndim - 1, 0)
        while len(logical) < ndim:
            logical = (None,) + logical
        return logical[-ndim:] if len(logical) > ndim else logical

    logical = None
    for suffix, axes in _LEAF_LOGICAL:
        if names[-len(suffix):] == suffix:
            logical = axes
            break
    if logical is None:
        logical = (None,) * ndim           # norms, scalars: replicated
    while len(logical) < ndim:             # leading stacked dims etc.
        logical = (None,) + logical
    return logical[-ndim:] if len(logical) > ndim else logical


def _named_leaves(params: Any) -> dict[str, Any]:
    """{dotted name: tensor or shape} of a module or a name -> leaf mapping."""
    if isinstance(params, nn.Module):
        out = {n: p for n, p in params.named_parameters()}
        out.update(params.named_buffers())
        return out
    return dict(params)


def _shape(x) -> tuple:
    return tuple(x.shape) if hasattr(x, "shape") else tuple(x)


def param_pspecs(params: Any, mesh: ReplayMesh | None = None,
                 rules: Mapping[str, tuple[str, ...]] | None = None) -> dict:
    """{name: PartitionSpec} for a module or a name -> tensor (or shape) map."""
    return {name: to_pspec(logical_axes_for_path(_path_names(name), len(_shape(x))),
                           mesh, rules)
            for name, x in _named_leaves(params).items()}


def _axis_size(mesh: ReplayMesh, entry) -> int:
    if entry is None:
        return 1
    if isinstance(entry, str):
        return mesh.shape[entry]
    n = 1
    for a in entry:
        n *= mesh.shape[a]
    return n


def sanitize_spec(shape: tuple, spec: PartitionSpec, mesh: ReplayMesh) -> PartitionSpec:
    """Drop mesh axes on dims they don't divide (pjit argument rule)."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, entry in zip(shape, entries):
        out.append(entry if dim % _axis_size(mesh, entry) == 0 else None)
    return PartitionSpec(*out)


def _coords(mesh: ReplayMesh, index: int) -> dict[str, int]:
    coords = {}
    for name, size in reversed(list(zip(mesh.axis_names, mesh.axis_sizes))):
        index, coords[name] = divmod(index, size)
    return coords


def shard_index(mesh: ReplayMesh, entry, coords: Mapping[str, int]) -> int:
    """Which slice of a dim sharded over ``entry`` the position at
    ``coords`` holds (row-major over the entry's axes)."""
    if entry is None:
        return 0
    index = 0
    for a in ((entry,) if isinstance(entry, str) else entry):
        index = index * mesh.shape[a] + coords[a]
    return index


def place(x: torch.Tensor, spec: PartitionSpec, mesh: ReplayMesh) -> tuple:
    """Each mesh position's slice of ``x`` under ``spec`` (sanitized to
    ``x``'s shape), on the position's device, row-major. A slice is a view
    of ``x`` where the device is ``x``'s own; a replicated leaf is ``x``
    itself on every position of its device, copied once a device else."""
    spec = sanitize_spec(tuple(x.shape), spec, mesh)
    copies: dict[torch.device, torch.Tensor] = {}
    out = []
    for i, device in enumerate(mesh.devices):
        coords = _coords(mesh, i)
        part = x
        for dim, entry in enumerate(spec):
            n = _axis_size(mesh, entry)
            if n > 1:
                size = x.shape[dim] // n
                part = part.narrow(dim, shard_index(mesh, entry, coords) * size, size)
        if part is x:
            if device not in copies:
                copies[device] = x.to(device)
            part = copies[device]
        else:
            part = part.to(device)
        out.append(part)
    return tuple(out)


def param_shardings(params: Any, mesh: ReplayMesh,
                    rules: Mapping[str, tuple[str, ...]] | None = None) -> dict:
    """{name: per-position slices} of a module's or a name -> tensor map's
    leaves on ``mesh`` (:func:`place` under each leaf's spec)."""
    specs = param_pspecs(params, mesh, rules)
    return {name: place(x, specs[name], mesh)
            for name, x in _named_leaves(params).items()}


def batch_pspec(mesh: ReplayMesh | None = None, extra: int = 1,
                rules: Mapping[str, tuple[str, ...]] | None = None) -> PartitionSpec:
    """(batch, ...) inputs: shard the leading batch dim."""
    return to_pspec(("batch",) + (None,) * extra, mesh, rules)
