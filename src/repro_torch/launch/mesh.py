"""Replay meshes (port of ``repro.launch.mesh``).

A :class:`ReplayMesh` names the axes that replay shards over (``"data"``
for the stacked lanes of a fused wave class or a coalesced serving batch,
``"model"`` for expert-parallel MoE) and the device of every mesh position,
row-major. One process drives every position (a single controller): a
sharded call runs each shard's part on that shard's device and gathers
the results back on the caller's device.

On ``"cuda"`` a mesh of ``n`` positions takes the first ``n`` distinct
cards and raises with fewer. On ``"cpu"`` the ``n`` positions share the
host, the counterpart of the reference's
``--xla_force_host_platform_device_count``. Virtual shards on one card
(several positions on ``cuda:0``) are built only by passing the device
list to :class:`ReplayMesh` yourself, as ``jax.make_mesh(...,
devices=...)`` takes one.

The functions build meshes; importing the module touches no device.
``make_production_mesh`` (the 16x16 / 2x16x16 pods of the dry-run) is not
ported yet.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch


def _device(d) -> torch.device:
    dev = torch.device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    return dev


class ReplayMesh:
    """Axis names, their sizes in order, and one device per position
    (row-major over the axes). ``shape`` maps each axis name to its size,
    in axis order, as ``jax.sharding.Mesh.shape`` does."""

    def __init__(self, axis_sizes: Sequence[int], axis_names: Sequence[str],
                 devices: Sequence):
        self.axis_sizes = tuple(int(s) for s in axis_sizes)
        self.axis_names = tuple(str(a) for a in axis_names)
        self.devices = tuple(_device(d) for d in devices)
        if len(self.axis_sizes) != len(self.axis_names):
            raise ValueError(f"{len(self.axis_sizes)} axis sizes for "
                             f"{len(self.axis_names)} axis names")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"repeated axis name in {self.axis_names}")
        if any(s < 1 for s in self.axis_sizes):
            raise ValueError(f"axis sizes must be positive, got {self.axis_sizes}")
        if math.prod(self.axis_sizes) != len(self.devices):
            raise ValueError(f"mesh {self.axis_sizes} needs {math.prod(self.axis_sizes)} "
                             f"devices, got {len(self.devices)}")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    def device_at(self, coords: dict[str, int]) -> torch.device:
        """The device at mesh coordinates (axes left out are 0)."""
        index = 0
        for name, size in zip(self.axis_names, self.axis_sizes):
            index = index * size + int(coords.get(name, 0))
        return self.devices[index]

    def _key(self) -> tuple:
        return (self.axis_names, self.axis_sizes, self.devices)

    def __eq__(self, other) -> bool:
        return isinstance(other, ReplayMesh) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(self._key())

    def __repr__(self) -> str:
        axes = ", ".join(f"{n}={s}" for n, s in zip(self.axis_names, self.axis_sizes))
        return f"ReplayMesh({axes}; {', '.join(map(str, self.devices))})"


def _positions(n: int, device) -> list[torch.device]:
    """``n`` mesh positions on ``device``'s type: the first ``n`` distinct
    cards, or the host ``n`` times."""
    kind = torch.device(device).type
    if kind == "cpu":
        return [torch.device("cpu")] * n
    if kind != "cuda":
        raise ValueError(f"a replay mesh runs on 'cuda' or 'cpu', got {device!r}")
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n > have:
        raise RuntimeError(
            f"need {n} distinct CUDA devices for the replay mesh, have {have}; "
            "virtual shards on one card take an explicit device list "
            "(ReplayMesh((n,), ('data',), ['cuda:0'] * n))")
    return [torch.device("cuda", i) for i in range(n)]


def make_replay_mesh(n: int | None = None, axis: str = "data",
                     device: str | torch.device = "cuda") -> ReplayMesh:
    """1-D mesh over the replay batch axis.

    ``axis`` defaults to ``"data"``, which the ``"batch"`` rule of
    ``sharding.partition.DEFAULT_RULES`` resolves to. ``n=None`` takes
    every visible device: every card, or the host once on ``"cpu"`` (the
    ``REPRO_MESH=all`` configuration).
    """
    if n is None:
        kind = torch.device(device).type
        n = (torch.cuda.device_count() if torch.cuda.is_available() else 0) \
            if kind == "cuda" else 1
    n = int(n)
    if n < 1:
        raise ValueError(f"need a positive device count, got {n}")
    return ReplayMesh((n,), (axis,), _positions(n, device))


def make_small_mesh(n_data: int = 2, n_model: int = 2,
                    device: str | torch.device = "cuda") -> ReplayMesh:
    """A (data, model) test mesh of ``n_data * n_model`` positions."""
    return ReplayMesh((n_data, n_model), ("data", "model"),
                      _positions(n_data * n_model, device))


# NVIDIA H100 SXM5 per-card peak rates, dense (roofline denominators). The
# reference's constants are the TPU v5e's; these are the port's card's.
PEAK_FLOPS_BF16 = 989e12        # FLOP/s, bf16 tensor cores, dense
HBM_BW = 3.35e12                # B/s
NVLINK_BW = 900e9               # B/s, NVLink 4 total per card
