"""TDG serialization and the warm artifact (port of ``repro.core.serialize``).

The compile-time path EMITS a TDG that the runtime later loads and executes
(the paper's Fig. 3). The artifact is a JSON description of the graph —
tasks by *registered payload name*, depend clauses, edges, slots, metadata —
saved at record time and loaded in another process, payloads re-bound
through a :class:`TaskFnRegistry` (the registry plays the linker). The JSON
schema is the reference's, version 1, so a file written by either package
loads in the other. Round-tripping preserves the graph exactly: the same
edges, the same schedule, and a rebuilt dependency table, so ``add_task``
after a load keeps resolving.

The opt-in **warm artifact** persists the lowered replay program. JAX ships
a compiled XLA binary; a CUDA graph cannot leave its process, so the port's
artifact is a ``torch.export`` program of the lowered replay function
(``lower.aot_compile_tdg``): ``torch.export.save`` bytes, the input specs,
``fused``, ``donate_slots``, the device topology, the cost analysis and the
trace / compile seconds, pickled into one blob. :func:`warmup_and_save`
writes it as a ``<path>.aot`` sidecar beside the TDG JSON. A hydrated
program skips the record, the trace, the fusion plan and the cost-model
probe; on the card its first call still captures a CUDA graph (in the
hydrating process), and later calls replay it.
"""
from __future__ import annotations

import io
import json
import os
import pickle
from typing import Any, Callable

import torch

from .tdg import TDG, Edge, EdgeKind, Task


class TaskFnRegistry:
    """Name -> payload function registry (the 'symbol table')."""

    def __init__(self) -> None:
        self._fns: dict[str, Callable] = {}

    def register(self, name: str | None = None):
        def deco(fn: Callable) -> Callable:
            key = name or fn.__name__
            if key in self._fns and self._fns[key] is not fn:
                raise ValueError(f"payload {key!r} already registered")
            self._fns[key] = fn
            fn.__taskfn_name__ = key
            return fn
        return deco

    def get(self, name: str) -> Callable:
        if name not in self._fns:
            raise KeyError(f"unknown task payload {name!r}; "
                           f"registered: {sorted(self._fns)}")
        return self._fns[name]

    def name_of(self, fn: Callable) -> str:
        key = getattr(fn, "__taskfn_name__", None)
        if key is None:
            raise ValueError(
                f"payload {fn!r} is not registered (decorate with "
                "@registry.register()) — cannot serialize this TDG")
        return key


def tdg_to_dict(tdg: TDG, registry: TaskFnRegistry) -> dict:
    return {
        "version": 1,
        "region": tdg.region,
        "tasks": [
            {"tid": t.tid, "fn": registry.name_of(t.fn),
             "ins": list(t.ins), "outs": list(t.outs), "name": t.name,
             "cost_hint": t.cost_hint, "metadata": t.metadata}
            for t in tdg.tasks
        ],
        "edges": [
            {"src": e.src, "dst": e.dst, "kind": e.kind.value, "slot": e.slot}
            for e in tdg.edges
        ],
        "input_slots": list(tdg.input_slots),
        "output_slots": list(tdg.output_slots),
    }


def tdg_from_dict(data: dict, registry: TaskFnRegistry) -> TDG:
    if data.get("version") != 1:
        raise ValueError(f"unsupported TDG version {data.get('version')}")
    tdg = TDG(region=data["region"])
    # tasks are rebuilt WITHOUT re-resolving deps: the edges are authoritative
    for td in data["tasks"]:
        t = Task(td["tid"], registry.get(td["fn"]), tuple(td["ins"]),
                 tuple(td["outs"]), name=td["name"],
                 cost_hint=td["cost_hint"], metadata=dict(td["metadata"]))
        tdg.tasks.append(t)
        tdg.preds[t.tid] = set()
        tdg.succs[t.tid] = set()
    for ed in data["edges"]:
        e = Edge(ed["src"], ed["dst"], EdgeKind(ed["kind"]), ed["slot"])
        tdg.edges.append(e)
        tdg.preds[e.dst].add(e.src)
        tdg.succs[e.src].add(e.dst)
    tdg.input_slots = list(data["input_slots"])
    tdg.output_slots = list(data["output_slots"])
    tdg._written = set(tdg.output_slots)
    # Rebuild the last-writer/readers table by replaying the depend clauses
    # (resolution is deterministic, so this is the record-time table); without
    # it add_task on a loaded TDG would resolve against an empty table.
    for t in tdg.tasks:
        tdg._dep_table.resolve(t.tid, t.ins, t.outs)
    tdg._dep_table.lookups = 0  # instrumentation counts post-load use only
    tdg.validate()
    return tdg


def save_tdg(tdg: TDG, path, registry: TaskFnRegistry) -> None:
    with open(path, "w") as f:
        json.dump(tdg_to_dict(tdg, registry), f, indent=1)


def load_tdg(path, registry: TaskFnRegistry) -> TDG:
    with open(path) as f:
        return tdg_from_dict(json.load(f), registry)


# ---------------------------------------------------------------------------
# The warm artifact: an exported replay program
# ---------------------------------------------------------------------------

class TopologyMismatch(RuntimeError):
    """The artifact was exported for a different device topology.

    Raised by :func:`executable_from_bytes` BEFORE ``torch.export.load`` is
    touched, so a cross-platform artifact (a card's program shipped to a CPU
    worker, another torch or CUDA version) fails with a clear, catchable
    error; callers (the cluster tier's register path, ``load_warm``) count it
    and re-lower.
    """


def local_device(device: Any = None) -> torch.device:
    """Where a program is hydrated and checked: ``device``, or (``None``)
    the card when there is one, else the CPU. The in-process default of
    :func:`topology_fingerprint`, :func:`executable_from_bytes` and
    ``RegionServer``; the entry points never rely on it (they resolve their
    device with ``launch.serve.resolve_device``, which raises without a
    card)."""
    if device is None:
        return torch.device("cuda" if torch.cuda.is_available() else "cpu")
    return torch.device(device)


def topology_fingerprint(device: Any = None, mesh: Any = "auto") -> dict:
    """The device-topology identity an exported program is bound to.

    ``device`` is where the program runs (``None``: the card when there is
    one, else the CPU). The fingerprint holds the platform (``"gpu"`` or
    ``"cpu"``), the device kind (``torch.cuda.get_device_name``), the visible
    device count, the compute capability (``sm``), the torch and CUDA
    versions, and the replay mesh's fingerprint: a program exported with its
    lanes split over a mesh must not hydrate where replay runs on another.
    ``mesh`` follows ``sharding.replay.resolve_mesh`` (``"auto"``: THIS
    process's scope or ``REPRO_MESH``); a fingerprint string (what a program
    was exported under, ``AotExecutable.mesh_fp``) or ``None`` is used as it
    is. Every value is JSON-stable: the fingerprint crosses the cluster
    tier's JSON wire.
    """
    from ..sharding import replay as _shreplay

    if mesh is None or isinstance(mesh, str) and mesh != "auto":
        mesh_fp = mesh
    else:
        mesh_fp = _shreplay.mesh_fingerprint(_shreplay.resolve_mesh(mesh))
    device = local_device(device)
    if device.type == "cuda":
        major, minor = torch.cuda.get_device_capability(device)
        platform, kind, count = ("gpu", torch.cuda.get_device_name(device),
                                 torch.cuda.device_count())
        sm = f"{major}.{minor}"
    else:
        platform, kind, count, sm = "cpu", "cpu", 1, None
    return {"platform": platform, "device_kind": kind, "device_count": count,
            "sm": sm, "torch": torch.__version__, "cuda": torch.version.cuda,
            "mesh": mesh_fp}


def executable_serialization_available() -> bool:
    """True iff this torch build can save and load exported programs."""
    return hasattr(torch, "export") and hasattr(torch.export, "save")


def executable_to_bytes(aot) -> bytes:
    """Frame a ``lower.AotExecutable`` as self-contained artifact bytes: the
    in-band shipping format of the cluster tier and the ``.aot`` sidecar's
    payload. The program is bound to its device topology: hydrate it on a
    matching one."""
    buf = io.BytesIO()
    torch.export.save(aot.program, buf)
    blob = {
        "version": 1,
        # the mesh the program was exported under, not this process's
        "topology": topology_fingerprint(aot.device, mesh=aot.mesh_fp),
        "payload": buf.getvalue(),
        "input_specs": aot.input_specs,
        "fused": aot.fused,
        "donate_slots": list(aot.donate_slots),
        "cost_analysis": aot.cost_analysis,
        "trace_seconds": aot.trace_seconds,
        "compile_seconds": aot.compile_seconds,
    }
    return pickle.dumps(blob)


def save_executable(aot, path) -> None:
    """Persist an ``lower.AotExecutable`` to ``path`` (:func:`executable_to_bytes`)."""
    data = executable_to_bytes(aot)
    with open(path, "wb") as f:
        f.write(data)


def executable_from_bytes(data: bytes, device: Any = None, mesh: Any = "auto"):
    """Hydrate an ``lower.AotExecutable`` from :func:`executable_to_bytes` output.

    ``device`` is where THIS consumer runs the program (``None``: the card
    when there is one, else the CPU) and ``mesh`` the replay mesh it runs
    it under (``"auto"``: scope or env; a ``RegionServer`` passes its own
    ``mesh_fp``). Raises on corruption or a version mismatch, and
    :class:`TopologyMismatch` when the embedded topology disagrees with
    ``device`` and ``mesh`` here (checked before ``torch.export.load``).
    The kernels' custom ops are registered first (the program names them).
    Soft-fallback policy belongs to the callers, which count the failure.
    """
    from .. import kernels  # noqa: F401  (registers the repro_torch:: ops)
    from . import lower as _lower

    blob = pickle.loads(data)
    if not isinstance(blob, dict) or blob.get("version") != 1:
        raise ValueError(f"unsupported executable version "
                         f"{blob.get('version') if isinstance(blob, dict) else blob!r}")
    shipped = blob.get("topology")
    if shipped is None:
        raise ValueError("artifact carries no topology fingerprint")
    device = local_device(device)
    here = topology_fingerprint(device, mesh=mesh)
    if shipped != here:
        raise TopologyMismatch(
            f"artifact was exported for {shipped} but this process runs "
            f"{here}; re-lower instead of hydrating")
    program = torch.export.load(io.BytesIO(blob["payload"]))
    return _lower.AotExecutable(program=program, input_specs=blob["input_specs"],
                                fused=blob["fused"],
                                donate_slots=tuple(blob["donate_slots"]),
                                cost_analysis=blob["cost_analysis"],
                                trace_seconds=blob.get("trace_seconds", 0.0),
                                compile_seconds=blob.get("compile_seconds", 0.0),
                                device=device, mesh_fp=shipped.get("mesh"))


def load_executable(path, device: Any = None, mesh: Any = "auto"):
    """Load a replay program saved by :func:`save_executable`."""
    with open(path, "rb") as f:
        data = f.read()
    return executable_from_bytes(data, device=device, mesh=mesh)


def warmup_and_save(tdg: TDG, buffers, path, registry: TaskFnRegistry,
                    fuse: bool | str = "auto", mesh: Any = "auto") -> dict:
    """Save the TDG JSON *and* export + persist its replay program.

    The graph goes to ``path`` (portable, payloads by symbol) and the program
    to ``path + ".aot"`` (bound to ``buffers``' device). Returns an info dict
    with both paths, the cost analysis and the trace / compile seconds. The
    consumer side is :func:`load_warm`.
    """
    from . import lower as _lower

    if not executable_serialization_available():
        # fail BEFORE writing anything or paying the trace, not after
        raise RuntimeError("this torch build lacks torch.export.save; "
                           "use save_tdg() for the graph-only artifact")
    save_tdg(tdg, path, registry)
    aot = _lower.aot_compile_tdg(tdg, buffers, fuse=fuse, mesh=mesh)
    aot_path = str(path) + ".aot"
    save_executable(aot, aot_path)
    return {
        "tdg_path": str(path),
        "aot_path": aot_path,
        "fused": aot.fused,
        "cost_analysis": aot.cost_analysis,
        "trace_seconds": aot.trace_seconds,
        "compile_seconds": aot.compile_seconds,
    }


def load_warm(path, registry: TaskFnRegistry, device: Any = None, mesh: Any = "auto"):
    """Load ``(tdg, aot_executable | None)`` saved by :func:`warmup_and_save`.

    The program comes back ``None`` when the sidecar is missing or cannot be
    hydrated here (another topology or replay mesh, a corrupt file): callers
    fall back to the ordinary lowered replay and count the failure. ``mesh``
    is the consumer's replay mesh, as in :func:`executable_from_bytes`.
    """
    tdg = load_tdg(path, registry)
    aot_path = str(path) + ".aot"
    aot = None
    if os.path.exists(aot_path) and executable_serialization_available():
        try:
            aot = load_executable(aot_path, device=device, mesh=mesh)
        except Exception:  # another topology, a corrupt file: soft-fail
            aot = None
    return tdg, aot
