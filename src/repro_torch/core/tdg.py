"""Task Dependency Graph (TDG) — the paper's core data structure.

Port of ``repro.core.tdg``. A TDG is a DAG whose nodes are task instances
(callables bound to named buffer slots) and whose edges are data
dependencies, materialized once from OpenMP-style ``depend(in/out/inout)``
clauses via a last-writer/readers table. Edges are RAW, WAR and WAW, as in
OpenMP 5.x depend-clause semantics. Pure Python, apart from
:func:`buffers_signature`, which abstracts torch tensors and modules and
memoises what it finds (see "Memoised, interned signatures" below).
"""
from __future__ import annotations

import dataclasses
import enum
import functools
import operator
import threading
import weakref
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


def plain_buffers_signature(buffers: Mapping[str, Any]) -> tuple:
    """Abstract signature of a buffer dict, computed from scratch: the
    reference that :func:`buffers_signature` returns the value of, and its
    miss path."""
    sig = []
    for k in sorted(buffers):
        leaves, spec = pytree.tree_flatten(buffers[k])
        sig.append((k, str(spec), tuple(leaf_signature(l) for l in leaves)))
    return tuple(sig)


# ------------------------------------------- memoised, interned signatures
#
# A served step keys the same structure on every step: one params module of
# hundreds of parameters and a cache tree of hundreds of fresh tensors.
# Walking the module and printing the tree's spec each time costs
# milliseconds of host time a step, so the answers are memoised: a buffer
# dict is looked up by a probe that reads only each tensor's shape, dtype
# and device, and every signature and graph key is interned, so equal keys
# are one object whose hash is computed once.

#: Entries each memo keeps, oldest dropped first. Dropping costs speed
#: only: a key interned again is a new object, equal to the old one.
KEY_MEMO_CAP = 4096


class Canonical(tuple):
    """The one object of its value in the intern table (:func:`intern_key`).
    Its hash is computed once, so a dict lookup or a comparison that meets
    the same object costs O(1) whatever its size. Pickles as a plain tuple:
    a cached hash holds only in the process that computed it."""

    def __new__(cls, value: tuple) -> "Canonical":
        self = super().__new__(cls, value)
        self._hash = tuple.__hash__(self)
        return self

    def __hash__(self) -> int:
        return self._hash

    def __reduce__(self):
        return tuple, (tuple(self),)


class BoundedMemo:
    """A dict of at most :data:`KEY_MEMO_CAP` entries, oldest out first.
    Reads take no lock (a dict read is atomic under the interpreter lock);
    writes take one."""

    def __init__(self) -> None:
        self._d: dict = {}
        self._lock = threading.Lock()

    def get(self, key):
        return self._d.get(key)

    def put(self, key, value):
        """Store ``value`` under ``key`` unless a value is there; return the
        stored one."""
        with self._lock:
            value = self._d.setdefault(key, value)
            while len(self._d) > KEY_MEMO_CAP:
                del self._d[next(iter(self._d))]
        return value

    def __len__(self) -> int:
        return len(self._d)


class KeyCounts:
    """Hits and misses of one caller's key lookups (a server's, a replay's)."""

    __slots__ = ("hits", "misses", "_lock")

    def __init__(self) -> None:
        self.hits = 0
        self.misses = 0
        self._lock = threading.Lock()

    def count(self, hit: bool) -> None:
        with self._lock:
            if hit:
                self.hits += 1
            else:
                self.misses += 1


_interned = BoundedMemo()   # value -> its Canonical
_probes = BoundedMemo()     # a buffer dict's probe -> its Canonical signature


def intern_key(value: tuple) -> tuple[Canonical, bool]:
    """The canonical object equal to ``value``, and whether one was held."""
    canon = _interned.get(value)
    if canon is not None:
        return canon, True
    canon = Canonical(value)
    return _interned.put(canon, canon), False


def interned_count() -> int:
    """Canonical keys the process holds."""
    return len(_interned)


class _NotPlain(Exception):
    """A node :func:`plain_flatten` leaves to ``pytree``."""


_leaf_types: dict[type, bool] = {}   # type -> does pytree take it as a leaf
_leaf_types_nodes = -1               # len(pytree.SUPPORTED_NODES) they hold for


def _walk(x, leaves: list, code: list) -> None:
    t = type(x)
    if t is dict:
        for k in x:
            if type(k) is not str:
                raise _NotPlain
        code.append(tuple(x))
        children = x.values()
    elif t is list or t is tuple:
        code.append(len(x) if t is list else ~len(x))
        children = x
    else:
        leaf = _leaf_types.get(t)
        if leaf is None:
            flat = pytree.tree_leaves(x)
            leaf = _leaf_types[t] = len(flat) == 1 and flat[0] is x
        if not leaf:
            raise _NotPlain
        leaves.append(x)
        code.append(None)
        return
    for v in children:                    # a known leaf type without a call
        if _leaf_types.get(type(v)) is True:
            leaves.append(v)
            code.append(None)
        else:
            _walk(v, leaves, code)


def plain_flatten(tree: Any) -> tuple[list, tuple] | None:
    """``tree``'s leaves, in ``pytree.tree_flatten``'s order, and a flat
    code of its structure; None for a tree with a node other than a dict of
    str keys, a list or a tuple (a namedtuple, an OrderedDict, a registered
    class), which is left to ``pytree``. Equal codes are equal specs. A walk
    in Python over plain containers, several times faster than building a
    ``TreeSpec``; callers check its leaves against ``pytree``'s on a miss."""
    global _leaf_types_nodes
    nodes = len(pytree.SUPPORTED_NODES)
    if nodes != _leaf_types_nodes:        # a node type was (un)registered
        _leaf_types.clear()
        _leaf_types_nodes = nodes
    leaves: list = []
    code: list = []
    try:
        _walk(tree, leaves, code)
    except _NotPlain:
        return None
    return leaves, tuple(code)


def same_leaves(a: list, b: list) -> bool:
    """The same objects in the same order."""
    return len(a) == len(b) and all(map(operator.is_, a, b))


# Module signatures: memoised under a weak reference to the module, and
# re-derived after any parameter, buffer or submodule is registered
# anywhere in the process (PyTorch's global registration hooks count them).
_generation = 0
_hook_lock = threading.Lock()
_hooked = False
_modules: dict[int, "_ModuleEntry"] = {}
_SHAPE = operator.attrgetter("shape")
_DTYPE = operator.attrgetter("dtype")


def _registered(module, name, value) -> None:
    global _generation
    _generation += 1


class _ModuleEntry:
    __slots__ = ("ref", "generation", "type", "dicts", "names", "shapes", "dtypes", "sig")


def _forget(key: int, ref, modules: dict = _modules) -> None:
    # ``modules`` is bound here: a module may die while the interpreter
    # tears this one down and its globals are gone.
    entry = modules.get(key)
    if entry is not None and entry.ref is ref:
        modules.pop(key, None)


def _learn_module(module: nn.Module) -> Canonical:
    global _hooked
    with _hook_lock:
        if not _hooked:
            from torch.nn.modules import module as _mm
            _mm.register_module_parameter_registration_hook(_registered)
            _mm.register_module_buffer_registration_hook(_registered)
            _mm.register_module_module_registration_hook(_registered)
            _hooked = True
    e = _ModuleEntry()
    e.generation = _generation            # read before the walk: a change
    e.type = type(module)                 # during it misses next time
    e.dicts, e.names, params, seen = [], [], [], set()
    for mod in module.modules():          # named_parameters' members, deduplicated
        for name, p in mod._parameters.items():
            if p is not None and id(p) not in seen:
                seen.add(id(p))
                e.dicts.append(mod._parameters)
                e.names.append(name)
                params.append(p)
    e.shapes = list(map(_SHAPE, params))
    e.dtypes = list(map(_DTYPE, params))
    e.sig = intern_key(leaf_signature(module))[0]
    key = id(module)
    e.ref = weakref.ref(module, functools.partial(_forget, key))
    _modules[key] = e
    return e.sig


def module_signature(module: nn.Module) -> tuple[Canonical, bool]:
    """:func:`leaf_signature` of a module, memoised, and whether it was a
    hit. A hit needs the module the entry was made for alive (a dead
    module's id never hits), no registration anywhere since, the module's
    type unchanged, and every parameter, read now through the module that
    owns it, of the shape and dtype it had: that catches ``.data`` swaps,
    ``module.to(dtype)`` and deleted parameters, which no hook sees."""
    e = _modules.get(id(module))
    if (e is not None and e.ref() is module and e.generation == _generation
            and type(module) is e.type):
        params = list(map(dict.get, e.dicts, e.names))
        try:
            if list(map(_SHAPE, params)) == e.shapes and list(map(_DTYPE, params)) == e.dtypes:
                return e.sig, True
        except AttributeError:            # a parameter deleted or set to None
            pass
    return _learn_module(module), False


def keyed_signature(buffers: Mapping[str, Any]) -> tuple[Canonical, bool]:
    """:func:`buffers_signature` and whether it was a hit.

    The probe holds each slot's name and :func:`plain_flatten` code, each
    tensor leaf's shape, dtype and device, each module's memoised signature
    and each other leaf's type: equal probes give equal signatures. A hit
    needs the probe memoised and every module's signature a hit; a miss
    computes :func:`plain_buffers_signature` and memoises it under the
    probe once the walk's leaves agree with ``pytree``'s."""
    probe: list = []
    walked: list = []
    hit = True
    for k in sorted(buffers):
        flat = plain_flatten(buffers[k])
        if flat is None:
            return intern_key(plain_buffers_signature(buffers))[0], False
        leaves, code = flat
        walked.append(leaves)
        probe.append(k)
        probe.append(code)
        for leaf in leaves:
            if isinstance(leaf, torch.Tensor):
                probe.append((leaf.shape, leaf.dtype, leaf.device))
            elif isinstance(leaf, nn.Module):
                sig, known = module_signature(leaf)
                hit = hit and known
                probe.append(sig)
            else:
                probe.append(type(leaf))
    probe = tuple(probe)
    sig = _probes.get(probe)
    if sig is not None:
        return sig, hit
    sig = intern_key(plain_buffers_signature(buffers))[0]
    if all(same_leaves(leaves, pytree.tree_leaves(buffers[k]))
           for k, leaves in zip(sorted(buffers), walked)):
        _probes.put(probe, sig)
    return sig, False


def buffers_signature(buffers: Mapping[str, Any]) -> tuple:
    """Abstract signature of a buffer dict (for coalescing and cache keys):
    equal to :func:`plain_buffers_signature`'s, and the one canonical
    object of that value, memoised by :func:`keyed_signature`."""
    return keyed_signature(buffers)[0]
