"""Abstract inputs with partition specs for every model input (port of
``repro.launch.specs``).

Nothing here allocates: params, optimizer state, caches and batches are
tensors on the ``meta`` device (the counterpart of ``jax.eval_shape``'s
``ShapeDtypeStruct``), each carrying its sanitized
:class:`~repro_torch.sharding.partition.PartitionSpec` on the mesh as a
``pspec`` attribute (the counterpart of ``ShapeDtypeStruct(sharding=...)``).
Functions that return shardings give them as a tree of specs beside the
tensors, as the reference gives its ``NamedSharding`` trees. The port's
parameter trees are name -> tensor dicts (``models.model.params_of``), so
a stacked leaf of the reference (``layers.attn.wq.w``, leading ``L``) is
one leaf a layer here (``layers.3.attn.wq.w``) with the same spec less its
leading (replicated) entry.
"""
from __future__ import annotations

from typing import Any

import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..models import model as M
from ..optim.adamw import Optimizer
from ..sharding import partition as P_
from ..sharding.partition import PartitionSpec
from .mesh import ReplayMesh


def _dp_axes(mesh: ReplayMesh) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def _dp_size(mesh: ReplayMesh) -> int:
    s = 1
    for a in _dp_axes(mesh):
        s *= mesh.shape[a]
    return s


def _model_size(mesh: ReplayMesh) -> int:
    return mesh.shape.get("model", 1)


def abstract(shape: tuple, dtype: torch.dtype, pspec: PartitionSpec) -> torch.Tensor:
    """A meta tensor of ``shape`` and ``dtype`` carrying ``pspec``."""
    t = torch.empty(shape, dtype=dtype, device="meta")
    t.pspec = pspec
    return t


def batch_sharding(mesh: ReplayMesh, batch: int, extra_dims: int) -> PartitionSpec:
    dp = _dp_axes(mesh)
    if not dp or batch % _dp_size(mesh) != 0:
        entry = None
    else:       # one axis by its name, as jax's PartitionSpec normalizes it
        entry = dp if len(dp) > 1 else dp[0]
    return PartitionSpec(entry, *([None] * extra_dims))


def with_sharding(tree: Any, shardings: Any) -> Any:
    """``tree``'s tensors as meta tensors carrying the matching spec of
    ``shardings`` (a tree of the same structure)."""
    if isinstance(tree, dict):
        return {k: with_sharding(v, shardings[k]) for k, v in tree.items()}
    return abstract(tuple(tree.shape), tree.dtype, shardings)


def _shardings(tree: Any, mesh: ReplayMesh) -> Any:
    """The sanitized spec tree of a nested dict of tensors, each leaf
    specced by its dotted path as a parameter is (``param_pspecs``)."""
    flat = P_.flatten_tree(tree)
    return P_.unflatten_like(tree, {
        n: P_.sanitize_spec(tuple(flat[n].shape), s, mesh)
        for n, s in P_.param_pspecs(flat, mesh).items()})


def param_specs(cfg: ModelConfig, mesh: ReplayMesh) -> tuple[dict, dict]:
    """(abstract params, their specs) without allocating."""
    params = {n: p.detach() for n, p in M.Model(cfg, "meta").named_parameters()}
    sh = _shardings(params, mesh)
    return with_sharding(params, sh), sh


def opt_specs(cfg: ModelConfig, mesh: ReplayMesh, optimizer: Optimizer,
              params: dict) -> tuple[Any, Any]:
    """(abstract optimizer state, its specs): ``optimizer.init`` on the
    abstract params; the moments shard as their params, ``step`` is
    replicated."""
    state = optimizer.init(params)
    sh = _shardings(state, mesh)
    return with_sharding(state, sh), sh


def train_batch_specs(cfg: ModelConfig, shape: ShapeConfig, mesh: ReplayMesh) -> dict:
    B, S = shape.global_batch, shape.seq_len
    batch = {"tokens": abstract((B, S), torch.int32, batch_sharding(mesh, B, 1))}
    if cfg.family == "encdec":
        batch["frames"] = abstract((B, cfg.encoder_seq, cfg.d_model), cfg.compute_dtype,
                                   batch_sharding(mesh, B, 2))
    return batch


def _cache_sharding(mesh: ReplayMesh, shape: tuple, batch: int,
                    shard_dims: dict[int, str]) -> PartitionSpec:
    """Shard dim0 (batch) over dp when divisible; named dims over model
    when divisible (first divisible one wins — one use per mesh axis)."""
    axes: list = [None] * len(shape)
    dp = _dp_axes(mesh)
    if dp and batch % _dp_size(mesh) == 0:
        axes[0] = dp if len(dp) > 1 else dp[0]
    msize = _model_size(mesh)
    for dim, _name in shard_dims.items():
        if ("model" in mesh.axis_names and shape[dim] % msize == 0
                and "model" not in axes):
            axes[dim] = "model"
    return PartitionSpec(*axes)


def cache_specs(cfg: ModelConfig, shape: ShapeConfig, mesh: ReplayMesh) -> list:
    """Abstract per-layer caches with specs (decode shapes).

    Default: shard kv-heads over "model" when divisible. With
    ``cfg.shard_kv_seq`` the cache LENGTH dim is sharded over "model"
    instead, for MHA-style archs whose head count does not divide the
    model axis. SSD states shard over heads, conv states over channels.
    """
    B, S = shape.global_batch, shape.seq_len
    msize = _model_size(mesh)

    def shard_leaf(name: str, leaf: torch.Tensor) -> torch.Tensor:
        dims: dict[int, str] = {}
        if name in ("k", "v"):
            dims = {2: "kv_heads"}
            if cfg.shard_kv_seq and leaf.shape[2] % msize != 0:
                dims = {1: "kv_seq"}
        elif name == "pos":
            if cfg.shard_kv_seq and cfg.num_kv_heads % msize != 0:
                dims = {1: "kv_seq"}
        elif name == "ssd":
            dims = {1: "heads"}
        elif name == "conv":
            dims = {2: "ch"}
        return abstract(tuple(leaf.shape), leaf.dtype,
                        _cache_sharding(mesh, tuple(leaf.shape), B, dims))

    def walk(node, name=""):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return shard_leaf(name, node)

    return walk(M.init_caches(cfg, B, S, "meta"))


def decode_input_specs(cfg: ModelConfig, shape: ShapeConfig, mesh: ReplayMesh):
    B = shape.global_batch
    toks = abstract((B, 1), torch.int32, batch_sharding(mesh, B, 1))
    pos = abstract((B,), torch.int32, batch_sharding(mesh, B, 0))
    return toks, pos, cache_specs(cfg, shape, mesh)


def input_specs(cfg: ModelConfig, shape: ShapeConfig, mesh: ReplayMesh,
                optimizer: Optimizer | None = None) -> dict[str, Any]:
    """Everything ``dryrun`` needs for one (arch, shape, mesh) cell."""
    params, params_sh = param_specs(cfg, mesh)
    out = {"params": params, "params_sharding": params_sh}
    if shape.kind == "train":
        if optimizer is None:
            raise ValueError("a train cell's specs need the optimizer")
        opt, opt_sh = opt_specs(cfg, mesh, optimizer, params)
        out.update(opt_state=opt, opt_sharding=opt_sh,
                   batch=train_batch_specs(cfg, shape, mesh))
    elif shape.kind == "prefill":
        out.update(batch=train_batch_specs(cfg, shape, mesh))
    else:  # decode
        toks, pos, caches = decode_input_specs(cfg, shape, mesh)
        out.update(tokens=toks, pos=pos, caches=caches)
        if cfg.family == "encdec":
            out["batch"] = train_batch_specs(cfg, shape, mesh)
    return out
