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

:func:`make_production_mesh` builds the dry-run's pods: 16x16 positions
over ``("data", "model")``, or 2x16x16 over ``("pod", "data", "model")``.
On ``"meta"`` its positions hold no data, the counterpart of the
reference's 512 host devices (``--xla_force_host_platform_device_count``).

The functions build meshes; importing the module touches no device.
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
                 devices: Sequence, indices: Sequence[int] | None = None):
        self.axis_sizes = tuple(int(s) for s in axis_sizes)
        self.axis_names = tuple(str(a) for a in axis_names)
        self.devices = tuple(_device(d) for d in devices)
        # each position's index in the mesh this one was selected from
        self.indices = (tuple(range(len(self.devices))) if indices is None
                        else tuple(int(i) for i in indices))
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

    def coords_of(self, local: int) -> dict[str, int]:
        """The mesh coordinates of the position at row-major ``local``."""
        coords = {}
        for name, size in reversed(list(zip(self.axis_names, self.axis_sizes))):
            local, coords[name] = divmod(local, size)
        return coords

    def _local(self, coords: dict[str, int]) -> int:
        index = 0
        for name, size in zip(self.axis_names, self.axis_sizes):
            index = index * size + int(coords.get(name, 0))
        return index

    def index_at(self, coords: dict[str, int]) -> int:
        """The position's index at mesh coordinates (axes left out are 0):
        row-major, in the mesh this one was :meth:`select`-ed from."""
        return self.indices[self._local(coords)]

    def device_at(self, coords: dict[str, int]) -> torch.device:
        """The device at mesh coordinates (axes left out are 0)."""
        return self.devices[self._local(coords)]

    def select(self, coords: dict[str, int]) -> "ReplayMesh":
        """The sub-mesh of the positions at ``coords`` on the named axes
        (kept at size 1; the other axes whole), remembering each position's
        index here: the ``"model"`` row of one batch shard."""
        keep = [i for i in range(len(self.devices))
                if all(self.coords_of(i)[a] == c for a, c in coords.items())]
        sizes = [1 if a in coords else n for a, n in zip(self.axis_names, self.axis_sizes)]
        return ReplayMesh(sizes, self.axis_names, [self.devices[i] for i in keep],
                          [self.indices[i] for i in keep])

    def _key(self) -> tuple:
        return (self.axis_names, self.axis_sizes, self.devices, self.indices)

    def __eq__(self, other) -> bool:
        return isinstance(other, ReplayMesh) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(self._key())

    def __repr__(self) -> str:
        axes = ", ".join(f"{n}={s}" for n, s in zip(self.axis_names, self.axis_sizes))
        return f"ReplayMesh({axes}; {', '.join(map(str, self.devices))})"


def _positions(n: int, device) -> list[torch.device]:
    """``n`` mesh positions on ``device``'s type: the first ``n`` distinct
    cards, or the host (or ``meta``) ``n`` times."""
    kind = torch.device(device).type
    if kind in ("cpu", "meta"):
        return [torch.device(kind)] * n
    if kind != "cuda":
        raise ValueError(f"a mesh runs on 'cuda', 'cpu' or 'meta', got {device!r}")
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n > have:
        raise RuntimeError(
            f"need {n} distinct CUDA devices for the replay mesh, have {have}; "
            "virtual shards on one card take an explicit device list "
            "(ReplayMesh((n,), ('data',), ['cuda:0'] * n))")
    return [torch.device("cuda", i) for i in range(n)]


def make_production_mesh(*, multi_pod: bool = False,
                         device: str | torch.device = "cuda") -> ReplayMesh:
    """The dry-run's pod: (16, 16) over ``("data", "model")``, or (2, 16,
    16) over ``("pod", "data", "model")`` with ``multi_pod``. On
    ``"cuda"`` it takes 256 (512) distinct cards and raises with fewer;
    ``"meta"`` gives positions that hold no data (the dry-run's)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return ReplayMesh(shape, axes, _positions(math.prod(shape), device))


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


# NVIDIA H100 SXM5 per-card peak rates, dense (the dry-run's roofline
# denominators). The reference's constants are the TPU v5e's; these are
# the port's card's, NVLINK_BW in the place of the reference's ICI_BW.
PEAK_FLOPS_BF16 = 989e12        # FLOP/s, bf16 tensor cores, dense
HBM_BW = 3.35e12                # B/s
NVLINK_BW = 900e9               # B/s, NVLink 4 total per card
