"""Lower a TDG to one replay callable (port of ``repro.core.lower``).

The vanilla runtime walks the graph dynamically: per task it pays creation,
dependency resolution, queue operations and dispatch. Replay instead emits
the whole region as ONE function of a buffer dict and runs it with no
per-task orchestration. Three layers, as in the reference:

* **Wave fusion** (``fuse.fused_tdg_as_function``, default on): each topo
  wave's isomorphic tasks run as one ``torch.func.vmap`` call, so a replay
  issues O(wave-classes) calls, not O(tasks). ``fuse=False`` (or
  ``REPRO_TORCH_FUSE=0``) restores the unrolled form; an explicit ``order``
  implies it.
* **Structural interning**: lowered callables are shared globally by the
  TDG's canonical structure, its payload identities, its donated slots, the
  fusion options, the batcher plan, the kernel mode and the replay mesh's
  fingerprint, so structurally identical regions (N tenants of one decode
  step) share one entry. ``intern_stats()`` exposes the counters.
* **Replay mesh** (``mesh=``, ``sharding.replay``): every fused class's
  stacked lanes split over the mesh's batch axis, one ``vmap`` call a
  shard on its device (``fuse._run_fused_class``).
* **CUDA-graph replay** (``jit=True``, the counterpart of ``jax.jit``): on
  CUDA buffers the lowered callable is captured once per buffer signature
  as a ``torch.cuda.CUDAGraph`` over static input buffers, and each call
  copies its inputs in, replays the graph and returns fresh outputs.
  Donated slots are the graph's own buffers: nothing is copied in or out
  for them (the reference's ``_jit_with_donation``). CPU buffers have no
  graph: the callable runs as it is. See :class:`GraphReplay`.

The AOT path (:func:`aot_compile_tdg`) exports the lowered replay function
with ``torch.export`` for fixed buffer specs: an :class:`AotExecutable`
that ``serialize`` persists and ships to other processes, where it is
replayed through a :class:`GraphReplay` of its own.
"""
from __future__ import annotations

import collections
import dataclasses
import math
import os
import threading
import time
from typing import Any, Callable, Mapping, Sequence

import torch
from torch import nn
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils import _pytree as pytree

from ..kernels import registry as _kreg
from ..sharding import replay as _shreplay
from . import costmodel as _costmodel
from . import fuse as _fuse
# Defined in costmodel (as the reference defines it there) and re-exported
# here, where every AotExecutable captures it.
from .costmodel import capture_cost_analysis as _capture_cost_analysis
from .spans import span
from . import schedule as _schedule
from .tdg import (TDG, BoundedMemo, KeyCounts, intern_key, plain_flatten, same_leaves,
                  structure_signature)

_FUSE_ENV = "REPRO_TORCH_FUSE"


def tdg_as_function(tdg: TDG, order: Sequence[int] | None = None,
                    outputs: Sequence[str] | None = None) -> Callable[[dict], dict]:
    """Return ``f(buffers) -> {slot: value}`` executing the TDG in ``order``.

    The fully unrolled form, one call per task. The function has no side
    effects of its own, so it can be vmapped, differentiated or embedded as
    a task of an outer TDG.
    """
    order = list(order) if order is not None else _schedule.topo_order(tdg)
    outputs = list(outputs) if outputs is not None else list(tdg.output_slots)
    if not _schedule.validate_execution_order(tdg, order):
        raise ValueError(f"order does not respect TDG edges for {tdg.region!r}")

    def run(buffers: Mapping[str, Any]) -> dict:
        env = dict(buffers)
        _fuse._run_unrolled(tdg, order, env)
        return {s: env[s] for s in outputs}

    run.__name__ = f"tdg_{tdg.region}"
    return run


def fuse_enabled(fuse: bool | str = "auto") -> bool:
    """Resolve a ``fuse`` argument (True | False | "auto"); "auto" honours
    ``REPRO_TORCH_FUSE`` (0/false/off/no disables) and otherwise fuses."""
    if fuse is True or fuse is False:
        return fuse
    if fuse != "auto":
        raise ValueError(f"fuse must be True, False or 'auto', got {fuse!r}")
    env = os.environ.get(_FUSE_ENV)
    if env is not None:
        return env.strip().lower() not in ("0", "false", "off", "no")
    return True


def _base_function(tdg: TDG, outputs, fuse: bool, min_class_size: int,
                   batcher: str, mesh=None) -> Callable[[dict], dict]:
    if fuse:
        return _fuse.fused_tdg_as_function(tdg, outputs=outputs,
                                           min_class_size=min_class_size,
                                           batcher=batcher, mesh=mesh)
    return tdg_as_function(tdg, outputs=outputs)


# ------------------------------------------------------ CUDA-graph replay

class GraphCaptureError(RuntimeError):
    """A region could not be captured as a CUDA graph (it syncs the host,
    say). Raised, never answered by running the region uncaptured."""


#: A CPU tensor in a captured region's buffers is read once, at capture (a
#: 0-dim one becomes a kernel argument), so it keys the graph by value, and
#: only while it is this small.
CPU_VALUE_NUMEL = 16

#: Graphs one :class:`GraphReplay` keeps, least recently used evicted first:
#: each holds its static buffers and its share of the replay's memory pool.
_GRAPH_CAP = 32


def _graph_key(leaves: list, donated: list | None = None) -> tuple:
    """What a captured graph bakes in: each CUDA tensor's shape, dtype and
    device (its data is copied into the static buffer, whose layout is the
    first caller's, at every call, whatever the caller's strides), and a
    donated one's address and strides (the graph reads and writes its
    storage); a small CPU tensor's values; each module by identity (the
    graph reads its parameters' storage); every other leaf by value."""
    key = []
    for i, leaf in enumerate(leaves):
        if isinstance(leaf, torch.Tensor):
            if leaf.is_cuda:            # a torch.Size equals the tuple of its sizes
                key.append((leaf.shape, leaf.dtype, leaf.device)
                           + ((leaf.data_ptr(), leaf.stride()) if donated and donated[i]
                              else ()))
            elif leaf.numel() <= CPU_VALUE_NUMEL:
                key.append(("cpu", tuple(leaf.shape), leaf.dtype,
                            tuple(leaf.flatten().tolist())))
            else:
                raise GraphCaptureError(
                    f"cannot capture a region over a CPU tensor of {leaf.numel()} "
                    f"elements: a graph would read its values once, at capture")
        elif isinstance(leaf, nn.Module):
            key.append(("module", id(leaf)))
        else:
            try:
                hash(leaf)
            except TypeError:
                raise GraphCaptureError(
                    f"cannot capture a buffer leaf of type {type(leaf).__name__}: "
                    f"a graph bakes in non-tensor values, keyed by value") from None
            key.append(("value", type(leaf), leaf))
    return tuple(key)


_side_streams: dict[torch.device, "torch.cuda.Stream"] = {}
_side_lock = threading.Lock()


def _side_stream(device: torch.device):
    """The one stream of ``device`` that every warm-up and capture runs on.

    A stream of its own for each capture would leave the math libraries'
    per-stream workspaces behind, one set a stream, and each may land inside
    a large cached block and pin it for the life of the process. This one
    stream is primed with small products first, so its workspaces sit in
    small blocks of their own before any large block is cached on it.
    """
    with _side_lock:
        stream = _side_streams.get(device)
        if stream is None:
            stream = _side_streams[device] = torch.cuda.Stream(device)
            stream.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(stream):
                a = torch.ones(8, 8, device=device)
                torch.addmm(a, a, a)
                b = a.bfloat16()
                torch.addmm(b, b, b)
            torch.cuda.current_stream(device).wait_stream(stream)
        return stream


@dataclasses.dataclass
class _Captured:
    graph: torch.cuda.CUDAGraph
    device: torch.device
    static_in: list                # tensors the inputs are copied into
    in_index: list[int]            # their positions among the input leaves
    out_spec: Any                  # tree structure of the output dict
    flat: dict                     # dtype -> packed outputs (graph memory)
    layout: list                   # per output leaf: see _Captured.outputs
    pinned: list                   # modules keyed by id, donated tensors: kept alive

    def outputs(self, fresh: dict) -> Any:
        """The output tree: packed leaves as views of ``fresh`` (a copy of
        ``flat``), donated leaves as the donated tensors, the rest as
        captured."""
        out = []
        for kind, a, b, c in self.layout:
            if kind == "packed":
                out.append(fresh[a][b:b + math.prod(c)].view(c))
            else:               # "donated": the tensor; "value": as captured
                out.append(a)
        return pytree.tree_unflatten(out, self.out_spec)


class GraphReplay:
    """``fn`` replayed from a CUDA graph captured once per buffer signature.

    The first call with a new signature copies the inputs into static
    buffers, runs ``fn`` once on the device's side stream (a warm-up that
    builds the kernels and sets their attributes outside the capture; an
    error there is the region's own and propagates as it is), then
    captures ``fn`` on that stream over the static buffers; inside the
    graph the outputs are packed, per dtype, into one flat buffer. Each call
    copies its inputs into the static buffers, replays the graph and returns
    outputs that are views of a fresh copy of the packed buffer, so the next
    replay never overwrites what an earlier call returned. Buffers without a
    CUDA tensor take ``fn`` as it is. A capture that fails raises
    :class:`GraphCaptureError` naming the task that was running; nothing
    falls back to the uncaptured form. The capture's error mode is
    ``"thread_local"``: other threads may keep issuing work on the card
    while one captures.

    **Donation** (``donate``: top-level buffer slots the caller gives up).
    A donated slot's CUDA tensors are not copied: they are the graph's
    static buffers for that slot, and their addresses key the graph. An
    output the region writes to a donated slot (same tree, shapes and
    dtypes) is written into that storage at the end of the graph and
    returned as that tensor, not as a copy. So a caller that passes back
    what the last call returned replays with nothing copied in or out for
    that slot; a donated tensor the replay has not seen is captured once
    more. As in JAX, the caller gives the donated input up: after the call
    it holds the output.

    The graphs share one memory pool (replays are serialized under a lock
    and their outputs copied out before it is released) and are bounded by
    ``_GRAPH_CAP``, least recently used evicted first. :meth:`release`
    drops them all. ``captures`` counts the graphs captured and
    ``capture_seconds`` the host time their warm-ups and captures took.

    **Keying.** A call's key is ``(str(spec), _graph_key(leaves, donated))``
    of its buffers' tree. The spec, its print and the donated mask are
    memoised under the tree's :func:`~repro_torch.core.tdg.plain_flatten`
    code, so a call with a known structure walks its tree once and builds
    no ``TreeSpec``; the key is interned, so the graph lookup hashes it
    once. ``keys`` counts the hits (structure known and key interned) and
    misses.

    **Replay mesh.** A graph holds the work of the device it is captured on:
    a region whose fused classes are sharded over that device alone
    (virtual shards on one card) is captured as one graph, and one whose
    shards reach another device raises :class:`GraphCaptureError` at
    capture (``fuse._bind_sharded``). A coalesced serving batch under a mesh
    replays once a shard instead (``serving/server.py``): its graphs are
    keyed by the shard's device, one a device.
    """

    def __init__(self, fn: Callable[[dict], dict], name: str, donate: Sequence[str] = ()):
        self.fn = fn
        self.name = name
        self.donate = frozenset(donate)
        self._graphs: collections.OrderedDict[tuple, _Captured] = collections.OrderedDict()
        self._lock = threading.Lock()
        self._pool = None
        self._last_stream = None
        self.captures = 0
        self.capture_seconds = 0.0
        self.evictions = 0
        self.keys = KeyCounts()
        self._structures = BoundedMemo()   # plain_flatten code -> (spec, str, donated)

    def __len__(self) -> int:
        return len(self._graphs)

    def release(self) -> None:
        """Drop the captured graphs, their static buffers and their memory
        pool (the next call with a signature captures it again)."""
        with self._lock:
            if self._graphs:
                torch.cuda.synchronize()     # no replay still runs in the pool
            self._graphs.clear()
            self._pool = None
            self._last_stream = None

    def _donated_leaves(self, buffers: dict) -> list | None:
        """Per input leaf (dict order, as ``tree_flatten`` walks it): does
        it belong to a donated slot?"""
        if not self.donate.intersection(buffers):
            return None
        return [k in self.donate for k, v in buffers.items()
                for _ in range(len(pytree.tree_leaves(v)))]

    def _key(self, buffers: dict) -> tuple:
        """``(leaves, spec, donated, key, hit)`` of a call: ``key`` is None
        when no leaf is a CUDA tensor; ``hit`` says the structure was
        memoised and, on the card, the key interned."""
        flat = plain_flatten(buffers)
        structure = None if flat is None else self._structures.get(flat[1])
        hit = structure is not None
        if hit:
            leaves = flat[0]
        else:
            leaves, spec = pytree.tree_flatten(buffers)
            structure = (spec, str(spec), self._donated_leaves(buffers))
            if flat is not None and same_leaves(flat[0], leaves):
                self._structures.put(flat[1], structure)
        spec, printed, donated = structure
        key = None
        if any(isinstance(l, torch.Tensor) and l.is_cuda for l in leaves):
            key, interned = intern_key((printed, _graph_key(leaves, donated)))
            hit = hit and interned
        return leaves, spec, donated, key, hit

    def __call__(self, buffers: Mapping[str, Any]) -> dict:
        buffers = dict(buffers)
        with span("replay.key") as keying:
            leaves, spec, donated, key, hit = self._key(buffers)
            self.keys.count(hit)
            keying.set(leaves=len(leaves), hit=int(hit))
        if key is None:
            return self.fn(buffers)
        with self._lock:
            entry = self._graphs.get(key)
            if entry is None:
                with span("replay.capture", region=self.name[:128], leaves=len(leaves)):
                    entry = self._graphs[key] = self._capture(leaves, spec, donated)
                while len(self._graphs) > _GRAPH_CAP:
                    torch.cuda.synchronize()
                    self._graphs.popitem(last=False)
                    self.evictions += 1
            else:
                self._graphs.move_to_end(key)
            stream = torch.cuda.current_stream(entry.device)
            if self._last_stream is not None and self._last_stream != stream:
                stream.wait_stream(self._last_stream)   # the pool's last user first
            self._last_stream = stream
            if entry.in_index:
                with span("replay.copy_in"):
                    torch._foreach_copy_(entry.static_in, [leaves[i] for i in entry.in_index])
            with span("replay.launch"):
                entry.graph.replay()
            with span("replay.copy_out"):
                return entry.outputs({dt: buf.clone() for dt, buf in entry.flat.items()})

    def _capture(self, leaves: list, spec, donated: list | None) -> _Captured:
        t0 = time.perf_counter()
        cuda = [i for i, l in enumerate(leaves) if isinstance(l, torch.Tensor) and l.is_cuda]
        in_index = [i for i in cuda if not (donated and donated[i])]
        static_leaves = list(leaves)
        for i in in_index:
            static_leaves[i] = leaves[i].clone()
        static_buffers = pytree.tree_unflatten(static_leaves, spec)
        device = leaves[cuda[0]].device
        side = _side_stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        _fuse._current.label = None
        with torch.cuda.stream(side):
            self.fn(static_buffers)               # warm-up, outside the capture
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, pool=self._pool, stream=side,
                                  capture_error_mode="thread_local"):
                out = self.fn(static_buffers)
                out_leaves, out_spec = pytree.tree_flatten(out)
                into = self._donated_outputs(out, out_leaves, static_buffers)
                flat, layout = _pack(out_leaves, into)
                _write_donated(out_leaves, into)
            torch.cuda.current_stream(device).wait_stream(side)
        except Exception as e:
            raise GraphCaptureError(
                f"CUDA graph capture of region {self.name!r} failed in task "
                f"{_fuse.current_task()!r}: {type(e).__name__}: {e}") from e
        torch.cuda.synchronize(device)
        self.captures += 1
        self.capture_seconds += time.perf_counter() - t0
        return _Captured(graph, device, [static_leaves[i] for i in in_index], in_index, out_spec,
                         flat, layout,
                         [l for i, l in enumerate(leaves) if isinstance(l, nn.Module)
                          or (donated and donated[i])])

    def _donated_outputs(self, out, out_leaves: list, static_buffers: dict) -> dict:
        """Output leaf index -> the donated static tensor it is written to:
        a donated slot's output whose tree, shapes and dtypes match the
        slot's input."""
        into: dict[int, torch.Tensor] = {}
        if not self.donate or not isinstance(out, dict):
            return into
        base = 0
        for k, v in out.items():
            n = len(pytree.tree_leaves(v))
            if k in self.donate and k in static_buffers:
                src, src_spec = pytree.tree_flatten(static_buffers[k])
                dst, dst_spec = pytree.tree_flatten(v)
                if src_spec == dst_spec:
                    for j, (s, o) in enumerate(zip(src, dst)):
                        if (isinstance(s, torch.Tensor) and isinstance(o, torch.Tensor)
                                and s.is_cuda and s.shape == o.shape and s.dtype == o.dtype
                                and s.device == o.device):
                            into[base + j] = s
            base += n
        return into


def _pack(leaves: list, into: dict) -> tuple[dict, list]:
    """Pack tensor leaves not written to a donated buffer (``into``), per
    dtype, into one flat buffer each; the layout of every output leaf."""
    groups: dict[torch.dtype, list] = {}
    layout = []
    for i, leaf in enumerate(leaves):
        if i in into:
            layout.append(("donated", into[i], None, None))
        elif isinstance(leaf, torch.Tensor):
            parts = groups.setdefault(leaf.dtype, [])
            layout.append(("packed", leaf.dtype, sum(p.numel() for p in parts),
                           tuple(leaf.shape)))
            parts.append(leaf.reshape(-1))
        else:
            layout.append(("value", leaf, None, None))
    flat = {dt: torch.cat(parts) for dt, parts in groups.items()}
    return flat, layout


def _write_donated(leaves: list, into: dict) -> None:
    """Write each donated output into its donated buffer. An output that
    shares storage with any donated buffer (the input passed through, a
    transpose of it) is copied first, so no write reads what another wrote."""
    storages = {t.untyped_storage().data_ptr() for t in into.values()}
    pending = []
    for i, dst in into.items():
        out = leaves[i]
        if out is dst:
            continue
        if out.untyped_storage().data_ptr() in storages:
            out = out.clone()
        pending.append((dst, out))
    for dst, out in pending:
        dst.copy_(out)


# ------------------------------------------------------------- interning

@dataclasses.dataclass
class _InternEntry:
    payloads: tuple            # strong refs: pins the id()s the key relies on
    fn: Callable[[dict], dict]  # on canonical slot names


_intern_lock = threading.Lock()
# LRU-bounded: entries pin their payload closures (that is what makes id()
# keys sound) and their captured graphs, so an unbounded cache would leak
# in processes that keep building TDGs with fresh closures.
_INTERN_CAP = 256
_intern_cache: collections.OrderedDict[tuple, _InternEntry] = collections.OrderedDict()
_intern_counters = {"hits": 0, "misses": 0, "evictions": 0}


def intern_stats() -> dict:
    """Hit/miss counters + size of the global structural cache."""
    with _intern_lock:
        return {**_intern_counters, "entries": len(_intern_cache)}


def _release(entry: _InternEntry) -> None:
    if isinstance(entry.fn, GraphReplay):
        entry.fn.release()


def clear_intern_cache() -> None:
    """Empty the cache, releasing the CUDA graphs its entries captured."""
    with _intern_lock:
        for entry in _intern_cache.values():
            _release(entry)
        _intern_cache.clear()
        for k in _intern_counters:
            _intern_counters[k] = 0


def _interned_lower(tdg: TDG, outputs, donate_slots: tuple[str, ...],
                    fuse: bool, min_class_size: int, batcher: str,
                    jit: bool, mesh=None) -> Callable[[dict], dict]:
    sig, slot_map, payloads = structure_signature(tdg, outputs)
    canon_donate = tuple(sorted(slot_map[s] for s in donate_slots if s in slot_map))
    # The kernel mode keys the cache, and is re-entered around every call,
    # so two callers pinned to different substrates never share an entry;
    # the batcher's plan key does the same for fusion plans, and the mesh
    # fingerprint for sharded and single-device lowerings of one structure.
    mode = _kreg.kernel_mode()
    key = (sig, tuple(id(p) for p in payloads), canon_donate, fuse,
           min_class_size, _costmodel.plan_key(batcher), mode, jit,
           _shreplay.mesh_fingerprint(mesh))

    with _intern_lock:
        entry = _intern_cache.get(key)
        if entry is not None:
            _intern_counters["hits"] += 1
            _intern_cache.move_to_end(key)
        else:
            _intern_counters["misses"] += 1
    if entry is None:
        actual = list(outputs) if outputs is not None else list(tdg.output_slots)
        base = _base_function(tdg, actual, fuse, min_class_size, batcher, mesh)
        from_canon = {c: a for a, c in slot_map.items()}

        def canon_run(cbuffers: dict) -> dict:
            out = base({from_canon[c]: v for c, v in cbuffers.items()})
            return {slot_map[s]: v for s, v in out.items()}

        canon_run.__name__ = f"tdg_interned_{tdg.region}"
        new = _InternEntry(payloads, GraphReplay(canon_run, tdg.region, canon_donate)
                           if jit else canon_run)
        with _intern_lock:
            entry = _intern_cache.setdefault(key, new)
            _intern_cache.move_to_end(key)
            while len(_intern_cache) > _INTERN_CAP:
                _release(_intern_cache.popitem(last=False)[1])
                _intern_counters["evictions"] += 1

    to_canon = dict(slot_map)
    from_canon = {c: a for a, c in slot_map.items()}
    shared = entry.fn

    def run(buffers: Mapping[str, Any]) -> dict:
        # Slots unknown to the structure are dropped: they cannot matter.
        with _kreg.kernel_mode_scope(mode):
            out = shared({to_canon[k]: v for k, v in buffers.items() if k in to_canon})
        return {from_canon[c]: v for c, v in out.items()}

    run.__name__ = f"tdg_{tdg.region}"
    if jit:
        run.graph_replay = shared   # its captures, for tests and reports
    return run


# -------------------------------------------------------------- entry point

def lower_tdg(tdg: TDG, order: Sequence[int] | None = None,
              outputs: Sequence[str] | None = None,
              donate_slots: Sequence[str] = (),
              jit: bool = True,
              fuse: bool | str = "auto",
              intern: bool | str = "auto",
              min_class_size: int = 2,
              batcher: str = "auto",
              mesh: Any = "auto") -> Callable[[dict], dict]:
    """Lower the TDG to one replay callable.

    ``fuse`` selects wave-fused lowering; an explicit ``order`` forces the
    unrolled form. ``jit=True`` replays CUDA buffers from a captured CUDA
    graph (:class:`GraphReplay`); ``jit=False`` returns the lowered
    callable itself. ``intern="auto"`` shares the callable through the
    global structural cache whenever ``jit=True`` and no custom ``order`` is
    given. An explicit ``intern=True`` with an ``order`` raises; with
    ``jit=False`` it shares an uncaptured callable (the request-level
    server's; the reference requires ``jit`` there), keyed apart from the
    captured one. ``batcher`` is
    ``"vmap"`` / ``"map"`` (pinned for every class) or ``"auto"`` (the cost
    model per class; ``REPRO_TORCH_ADAPTIVE=0`` makes it ``"vmap"``).
    ``donate_slots`` names buffers the caller gives up (the reference's
    ``_jit_with_donation``), and keys the intern cache. On CUDA buffers with
    ``jit=True`` each donated tensor is the captured graph's static buffer
    for its slot: an output written to that slot is written into its storage
    and returned as that tensor, and a later call that passes the same
    tensor back copies nothing in for it (:class:`GraphReplay`). As in JAX,
    the caller gives the donated input up: after the call it holds the
    output. On the CPU, and with ``jit=False``, the region runs as it is and
    the donated input is left alone.

    ``mesh`` shards every fused class's stacked lanes over a replay mesh: a
    ``ReplayMesh``, ``None`` (single-device) or ``"auto"`` (an ambient
    ``sharding.partition.use_mesh`` scope, then ``REPRO_MESH``; see
    ``sharding.replay.resolve_mesh``). Unfused lowering takes none. The
    resolved mesh's fingerprint keys the intern cache. A donated slot stays
    the caller's tensor under a mesh: the shards read their chunks of the
    stacked lanes, and what the region writes to the slot is gathered back
    into the graph's buffer for it at the end, as without a mesh.
    """
    donate_slots = tuple(donate_slots)
    do_fuse = fuse_enabled(fuse) and order is None
    mesh = _shreplay.resolve_mesh(mesh) if do_fuse else None
    if intern == "auto":
        intern = jit and order is None
    elif intern and order is not None:
        raise ValueError("intern=True requires order=None "
                         "(interned callables run in wave order)")
    if intern:
        return _interned_lower(tdg, list(outputs) if outputs is not None else None,
                               donate_slots, do_fuse, min_class_size, batcher, jit, mesh)
    fn = (_base_function(tdg, outputs, do_fuse, min_class_size, batcher, mesh)
          if order is None else tdg_as_function(tdg, order=order, outputs=outputs))
    return GraphReplay(fn, tdg.region, donate_slots) if jit else fn


# ------------------------------------------------------------------ AOT path

def module_tensors(mod: nn.Module) -> dict[str, torch.Tensor]:
    """A module's parameters and buffers as {dotted name: tensor}, detached
    (sharing storage): what an exported program takes in a module's place."""
    out = {name: p.detach() for name, p in mod.named_parameters()}
    out.update((name, b.detach()) for name, b in mod.named_buffers())
    return out


def tensor_tree(buffers: Mapping[str, Any]) -> dict:
    """``buffers`` with every module leaf replaced by :func:`module_tensors`:
    an exported program's inputs are trees of tensors."""
    return {k: pytree.tree_map(lambda v: module_tensors(v) if isinstance(v, nn.Module) else v,
                               v, is_leaf=lambda v: isinstance(v, nn.Module))
            for k, v in buffers.items()}


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def spec_of(buffers: Mapping[str, Any]) -> dict:
    """Per slot, the tree of ``(shape, dtype name)`` of its tensors (modules
    as :func:`tensor_tree` flattens them): the input specs of an
    :class:`AotExecutable`."""
    def leaf(t):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"an exported program takes tensor buffers, got "
                            f"{type(t).__name__}")
        return (tuple(t.shape), _dtype_name(t.dtype))
    return {k: pytree.tree_map(leaf, v) for k, v in tensor_tree(buffers).items()}


def spec_signature(specs: Mapping[str, Any]) -> tuple:
    """Comparable signature of :func:`spec_of` specs (slot order ignored)."""
    rows = []
    for k in sorted(specs):
        leaves, spec = pytree.tree_flatten(
            specs[k], is_leaf=lambda x: isinstance(x, tuple) and len(x) == 2
            and isinstance(x[1], str))
        rows.append((k, str(spec), tuple((tuple(s), d) for s, d in leaves)))
    return tuple(rows)


class _Program(nn.Module):
    """The lowered replay function as the module ``torch.export`` takes."""

    def __init__(self, fn: Callable[[dict], dict]):
        super().__init__()
        self.fn = fn

    def forward(self, buffers: dict) -> dict:
        return self.fn(buffers)


@dataclasses.dataclass
class AotExecutable:
    """A replay program exported ahead of time for fixed buffer specs.

    ``program`` is the ``torch.export.ExportedProgram`` of the lowered replay
    function over :func:`tensor_tree` of the buffers; ``input_specs`` its
    per-slot ``(shape, dtype)`` trees; ``device`` where it runs. Calling the
    object runs the program on a buffer dict (extra keys are dropped; module
    leaves are read as their tensors) through a :class:`GraphReplay`: on the
    card its first call captures a CUDA graph, later calls replay it, and
    ``donate_slots`` are honoured as in ``lower_tdg``. ``cost_analysis``
    holds ``flops`` (``FlopCounterMode``) and ``bytes accessed`` (inputs and
    outputs); ``trace_seconds`` is the export, ``compile_seconds`` building
    the program's module. ``mesh_fp`` is the fingerprint of the replay mesh
    the program was exported under (``None``: single-device); it rides the
    artifact's topology fingerprint, so a consumer on another mesh refuses
    it.
    """

    program: Any
    input_specs: dict
    fused: bool
    donate_slots: tuple[str, ...] = ()
    cost_analysis: dict | None = None
    trace_seconds: float = 0.0
    compile_seconds: float = 0.0
    device: torch.device = dataclasses.field(default_factory=lambda: torch.device("cpu"))
    mesh_fp: str | None = None

    def __post_init__(self) -> None:
        self.signature = spec_signature(self.input_specs)
        module = self.program.module()

        def run(buffers: dict) -> dict:
            return module(tensor_tree(buffers))

        run.__name__ = "aot_program"
        self.replay = GraphReplay(run, "aot_program", self.donate_slots)

    @property
    def flops(self) -> float | None:
        return (self.cost_analysis or {}).get("flops")

    @property
    def bytes_accessed(self) -> float | None:
        return (self.cost_analysis or {}).get("bytes accessed")

    def matches(self, buffers: Mapping[str, Any]) -> bool:
        """Do ``buffers`` (extra keys ignored) have this program's specs, on
        its device?"""
        args = {k: buffers[k] for k in self.input_specs if k in buffers}
        if len(args) != len(self.input_specs):
            return False
        leaves = pytree.tree_leaves(tensor_tree(args))
        if any(isinstance(l, torch.Tensor) and l.device.type != self.device.type
               for l in leaves):
            return False
        try:
            return spec_signature(spec_of(args)) == self.signature
        except TypeError:
            return False

    def __call__(self, buffers: Mapping[str, Any]) -> dict:
        return self.replay({k: buffers[k] for k in self.input_specs})

    def release(self) -> None:
        """Drop the CUDA graphs its calls captured."""
        self.replay.release()


def aot_compile_tdg(tdg: TDG, buffers: Mapping[str, Any],
                    outputs: Sequence[str] | None = None,
                    donate_slots: Sequence[str] = (),
                    fuse: bool | str = "auto",
                    min_class_size: int = 2,
                    batcher: str = "auto",
                    mesh: Any = "auto") -> AotExecutable:
    """Export the replay program for ``buffers``' specs, here and now.

    ``buffers`` hold real tensors on the device the program is for (module
    leaves are exported as their tensors); no kernel launches, since export
    traces on fake tensors: on CUDA tensors the program holds the kernels'
    custom ops (``torch.ops.repro_torch.*``), on CPU tensors their plain
    versions, as the wrappers choose by device. Runs under the caller's
    kernel mode, which the program bakes in. ``donate_slots`` are honoured
    when the program is called, as in ``lower_tdg``; ``mesh`` is resolved
    and baked in as there, and recorded as ``mesh_fp``.
    """
    do_fuse = fuse_enabled(fuse)
    mesh = _shreplay.resolve_mesh(mesh) if do_fuse else None
    fn = _base_function(tdg, list(outputs) if outputs is not None else None,
                        do_fuse, min_class_size, batcher, mesh)
    tensors = tensor_tree(dict(buffers))
    specs = spec_of(tensors)
    devices = {t.device for t in pytree.tree_leaves(tensors)}
    if len(devices) != 1 or next(iter(devices)).type == "meta":
        raise ValueError(f"aot_compile_tdg needs tensors on one real device, got "
                         f"{sorted(map(str, devices))}")
    device = devices.pop()
    t0 = time.perf_counter()
    # One call on fake tensors first: the fusion plan's cost-model probes run
    # (and are cached) here, on the real devices' signatures, so the export
    # finds every batcher decision made and traces no probe into the program.
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    fakes = pytree.tree_map(mode.from_tensor, tensors)
    with torch.no_grad(), mode:
        fn(fakes)
    cost = _capture_cost_analysis(fn, fakes, mode)
    with torch.no_grad():
        program = torch.export.export(_Program(fn), (tensors,), strict=False)
    # The program would keep (and save) its example inputs: the buffers
    # themselves, a model's params included. An artifact holds no data.
    try:
        program.example_inputs = None
    except AttributeError:      # a torch without the property's setter
        program._example_inputs = None
    t1 = time.perf_counter()
    aot = AotExecutable(program=program, input_specs=specs, fused=do_fuse,
                        donate_slots=tuple(k for k in donate_slots if k in specs),
                        cost_analysis=cost, device=device,
                        mesh_fp=_shreplay.mesh_fingerprint(mesh))
    aot.trace_seconds, aot.compile_seconds = t1 - t0, time.perf_counter() - t1
    return aot
