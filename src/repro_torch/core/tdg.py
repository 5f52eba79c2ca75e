"""Task Dependency Graph (TDG) — the paper's core data structure.

Port of ``repro.core.tdg``. A TDG is a DAG whose nodes are task instances
(callables bound to named buffer slots) and whose edges are data
dependencies, materialized once from OpenMP-style ``depend(in/out/inout)``
clauses via a last-writer/readers table. Edges are RAW, WAR and WAW, as in
OpenMP 5.x depend-clause semantics. Pure Python, apart from
:func:`buffers_signature`, which abstracts torch tensors and modules.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Any, Callable, Iterable, Mapping, Sequence

import torch
from torch import nn
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode


class DepKind(enum.Enum):
    IN = "in"
    OUT = "out"
    INOUT = "inout"


class EdgeKind(enum.Enum):
    RAW = "raw"  # true (flow) dependence
    WAR = "war"  # anti dependence
    WAW = "waw"  # output dependence


@dataclasses.dataclass(frozen=True)
class Edge:
    src: int
    dst: int
    kind: EdgeKind
    slot: str


@dataclasses.dataclass
class Task:
    """One task instance.

    ``fn`` takes the values of ``ins`` (in order) and returns the values of
    ``outs`` (a single value if ``len(outs) == 1``, else a tuple in order).
    """

    tid: int
    fn: Callable[..., Any]
    ins: tuple[str, ...]
    outs: tuple[str, ...]
    name: str = ""
    cost_hint: float = 1.0
    metadata: dict = dataclasses.field(default_factory=dict)

    def label(self) -> str:
        return self.name or getattr(self.fn, "__name__", f"task{self.tid}")


class DependencyTable:
    """Last-writer/readers table — the record-time 'dependency hash table'.

    Consulted once per clause while recording, never again (paper §4.3.2:
    entries are never freed so edges to finished tasks can still be made).
    """

    def __init__(self) -> None:
        self._last_writer: dict[str, int] = {}
        self._readers: dict[str, list[int]] = {}
        self.lookups = 0  # instrumentation: how many clause resolutions

    def resolve(self, tid: int, ins: Sequence[str], outs: Sequence[str]) -> list[Edge]:
        edges: list[Edge] = []
        seen: set[tuple[int, int]] = set()

        def _add(src: int, kind: EdgeKind, slot: str) -> None:
            if src == tid or (src, tid) in seen:
                return
            seen.add((src, tid))
            edges.append(Edge(src, tid, kind, slot))

        for slot in ins:
            self.lookups += 1
            w = self._last_writer.get(slot)
            if w is not None:
                _add(w, EdgeKind.RAW, slot)
            self._readers.setdefault(slot, []).append(tid)
        for slot in outs:
            self.lookups += 1
            w = self._last_writer.get(slot)
            if w is not None:
                _add(w, EdgeKind.WAW, slot)
            for r in self._readers.get(slot, ()):  # anti deps
                _add(r, EdgeKind.WAR, slot)
            self._last_writer[slot] = tid
            self._readers[slot] = []
        return edges


class TDG:
    """The task dependency graph for one region instance."""

    def __init__(self, region: str = "<anonymous>") -> None:
        self.region = region
        self.tasks: list[Task] = []
        self.edges: list[Edge] = []
        self.preds: dict[int, set[int]] = {}
        self.succs: dict[int, set[int]] = {}
        self._dep_table = DependencyTable()
        # slots read before ever written inside the region = region inputs;
        # slots written = region outputs (its externally visible effect).
        self._written: set[str] = set()
        self.input_slots: list[str] = []
        self.output_slots: list[str] = []

    def add_task(self, fn: Callable[..., Any], ins: Sequence[str] = (),
                 outs: Sequence[str] = (), inouts: Sequence[str] = (),
                 name: str = "", cost_hint: float = 1.0, **metadata: Any) -> Task:
        ins = tuple(ins) + tuple(inouts)
        outs = tuple(outs) + tuple(inouts)
        tid = len(self.tasks)
        task = Task(tid, fn, ins, outs, name=name, cost_hint=cost_hint,
                    metadata=dict(metadata))
        self.tasks.append(task)
        self.preds[tid] = set()
        self.succs[tid] = set()
        for slot in ins:
            if slot not in self._written and slot not in self.input_slots:
                self.input_slots.append(slot)
        for slot in outs:
            self._written.add(slot)
            if slot not in self.output_slots:
                self.output_slots.append(slot)
        for e in self._dep_table.resolve(tid, task.ins, task.outs):
            self.edges.append(e)
            self.preds[tid].add(e.src)
            self.succs[e.src].add(tid)
        return task

    @property
    def num_tasks(self) -> int:
        return len(self.tasks)

    @property
    def num_edges(self) -> int:
        return len(self.edges)

    def roots(self) -> list[int]:
        """Tasks without input dependencies (paper §4.3.1)."""
        return [t.tid for t in self.tasks if not self.preds[t.tid]]

    def is_acyclic(self) -> bool:
        # Every edge goes from a lower tid to a higher one (record order).
        return all(e.src < e.dst for e in self.edges)

    def validate(self) -> None:
        if not self.is_acyclic():
            raise ValueError(f"TDG {self.region!r} has a cycle")
        for e in self.edges:
            if not (0 <= e.src < self.num_tasks and 0 <= e.dst < self.num_tasks):
                raise ValueError(f"dangling edge {e}")

    def dep_lookups(self) -> int:
        return self._dep_table.lookups

    def summary(self) -> str:
        kinds: dict[EdgeKind, int] = {}
        for e in self.edges:
            kinds[e.kind] = kinds.get(e.kind, 0) + 1
        kind_s = ", ".join(f"{k.value}={v}" for k, v in
                           sorted(kinds.items(), key=lambda kv: kv[0].value))
        return (f"TDG({self.region!r}: {self.num_tasks} tasks, {self.num_edges} edges"
                f"{' [' + kind_s + ']' if kind_s else ''}, {len(self.roots())} roots)")

    def __repr__(self) -> str:  # pragma: no cover
        return self.summary()


def chain_series(tdg: TDG, fns: Iterable[Callable], slot: str = "x") -> None:
    """Helper: a linear chain of tasks over one slot (paper Listing 1 column)."""
    for i, fn in enumerate(fns):
        tdg.add_task(fn, inouts=[slot], name=f"{slot}.{i}")


def abstract_leaf(v: Any):
    """One value leaf -> a meta tensor of its shape and dtype (no data touched).

    The counterpart of ``jax.ShapeDtypeStruct``, shared by ``record``
    (``build_static``), ``fuse`` (``plan``) and the cost model. A meta tensor
    passes through; a module stays itself (its parameters are not a value
    the graph changes); anything else becomes a tensor first.
    """
    if isinstance(v, torch.Tensor):
        return v if v.is_meta else torch.empty_like(v, device="meta")
    if isinstance(v, nn.Module):
        return v
    return torch.empty_like(torch.as_tensor(v), device="meta")


class _OnMeta(TorchDispatchMode):
    """Moves every tensor an op gets to the meta device first, so a payload
    that closes over a real tensor (a constant) evaluates on meta inputs."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        args, kwargs = pytree.tree_map_only(
            torch.Tensor, lambda t: t if t.is_meta else t.to("meta"),
            (args, kwargs or {}))
        return func(*args, **kwargs)


def abstract_eval(fn: Callable[..., Any], *args: Any) -> Any:
    """Evaluate ``fn`` on abstract (meta) arguments: the port's
    ``jax.eval_shape``. Shapes and dtypes come out; no data is touched and no
    kernel launches (a CUDA kernel's wrapper takes its plain version for
    tensors off the card, and its custom op has a fake implementation)."""
    args = pytree.tree_map(abstract_leaf, args)
    with torch.no_grad(), _OnMeta():
        return fn(*args)


def structure_signature(tdg: TDG, outputs: Sequence[str] | None = None
                        ) -> tuple[tuple, dict[str, str], tuple]:
    """Canonical structural signature of a TDG, for executable interning.

    Slots are renamed ``s0, s1, ...`` by first appearance (tasks in tid
    order, ins before outs) and payloads numbered by first appearance, so
    two instances of one region canonicalize to one key. Returns
    ``(sig, slot_map, payloads)``; ``sig`` carries payload *indices* only,
    so an interning cache must also key on the identities in ``payloads``
    (and keep them alive).
    """
    slot_map: dict[str, str] = {}
    payload_index: dict[int, int] = {}
    payloads: list[Callable] = []

    def canon(slot: str) -> str:
        if slot not in slot_map:
            slot_map[slot] = f"s{len(slot_map)}"
        return slot_map[slot]

    task_rows = []
    for t in tdg.tasks:
        fid = id(t.fn)
        if fid not in payload_index:
            payload_index[fid] = len(payloads)
            payloads.append(t.fn)
        task_rows.append((payload_index[fid],
                          tuple(canon(s) for s in t.ins),
                          tuple(canon(s) for s in t.outs)))
    edge_rows = tuple(sorted(
        (e.src, e.dst, e.kind.value, slot_map[e.slot]) for e in tdg.edges))
    out_slots = list(outputs) if outputs is not None else list(tdg.output_slots)
    sig = ("tdg-structure-v1", len(tdg.tasks), tuple(task_rows), edge_rows,
           tuple(canon(s) for s in out_slots))
    return sig, slot_map, tuple(payloads)


def leaf_signature(v: Any) -> tuple:
    """Abstract one buffer leaf: a tensor by shape, dtype and device type; a
    module by its parameters' names, shapes and dtypes; anything else by
    its type."""
    if isinstance(v, torch.Tensor):
        return (tuple(v.shape), str(v.dtype), v.device.type)
    if isinstance(v, nn.Module):
        return ("module", type(v).__name__,
                tuple((n, tuple(p.shape), str(p.dtype)) for n, p in v.named_parameters()))
    return ((), str(type(v)))


def buffers_signature(buffers: Mapping[str, Any]) -> tuple:
    """Abstract signature of a buffer dict (for coalescing and cache keys)."""
    sig = []
    for k in sorted(buffers):
        leaves, spec = pytree.tree_flatten(buffers[k])
        sig.append((k, str(spec), tuple(leaf_signature(l) for l in leaves)))
    return tuple(sig)
