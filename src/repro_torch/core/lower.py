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
  fusion options, the batcher plan and the kernel mode, so structurally
  identical regions (N tenants of one decode step) share one entry.
  ``intern_stats()`` exposes the counters.
* **CUDA-graph replay** (``jit=True``, the counterpart of ``jax.jit``): on
  CUDA buffers the lowered callable is captured once per buffer signature
  as a ``torch.cuda.CUDAGraph`` over static input buffers, and each call
  copies its inputs in, replays the graph and returns fresh outputs. CPU
  buffers have no graph: the callable runs as it is. See
  :class:`GraphReplay`.
"""
from __future__ import annotations

import collections
import dataclasses
import math
import os
import threading
from typing import Any, Callable, Mapping, Sequence

import torch
from torch import nn
from torch.utils import _pytree as pytree

from ..kernels import registry as _kreg
from . import costmodel as _costmodel
from . import fuse as _fuse
from . import schedule as _schedule
from .tdg import TDG, structure_signature

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
                   batcher: str) -> Callable[[dict], dict]:
    if fuse:
        return _fuse.fused_tdg_as_function(tdg, outputs=outputs,
                                           min_class_size=min_class_size,
                                           batcher=batcher)
    return tdg_as_function(tdg, outputs=outputs)


# ------------------------------------------------------ CUDA-graph replay

class GraphCaptureError(RuntimeError):
    """A region could not be captured as a CUDA graph (it syncs the host,
    say). Raised, never answered by running the region uncaptured."""


#: A CPU tensor in a captured region's buffers is read once, at capture (a
#: 0-dim one becomes a kernel argument), so it keys the graph by value, and
#: only while it is this small.
CPU_VALUE_NUMEL = 16


def _graph_key(leaves: list) -> tuple:
    """What a captured graph bakes in: each CUDA tensor's shape, dtype,
    device and strides (its data is copied in at every call); a small CPU
    tensor's values; each module by identity (the graph reads its
    parameters' storage); every other leaf by value."""
    key = []
    for leaf in leaves:
        if isinstance(leaf, torch.Tensor):
            if leaf.is_cuda:
                key.append((tuple(leaf.shape), leaf.dtype, leaf.device, leaf.stride()))
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
    static_in: list                # tensors the inputs are copied into
    in_index: list[int]            # their positions among the input leaves
    out_spec: Any                  # tree structure of the output dict
    out_leaves: list               # non-tensor output leaves, as captured
    flat: dict                     # dtype -> packed outputs (graph memory)
    layout: list                   # per output leaf: (dtype, offset, shape) or None
    pinned: list                   # modules keyed by id: kept alive


class GraphReplay:
    """``fn`` replayed from a CUDA graph captured once per buffer signature.

    The first call with a new signature copies the inputs into static
    buffers, runs ``fn`` once on the device's side stream (a warm-up that
    builds the kernels and sets their attributes outside the capture), then
    captures ``fn`` on that stream over the static buffers; inside the
    graph the outputs are packed,
    per dtype, into one flat buffer. Each call copies its inputs into the
    static buffers, replays the graph and returns outputs that are views of
    a fresh copy of the packed buffer, so the next replay never overwrites
    what an earlier call returned. Buffers without a CUDA tensor take ``fn``
    as it is. A capture that fails raises :class:`GraphCaptureError` naming
    the task that was running; nothing falls back to the uncaptured form.
    ``captures`` counts the graphs captured.
    """

    def __init__(self, fn: Callable[[dict], dict], name: str):
        self.fn = fn
        self.name = name
        self._graphs: dict[tuple, _Captured] = {}
        self._lock = threading.Lock()
        self.captures = 0

    def release(self) -> None:
        """Drop the captured graphs, their static buffers and memory pools
        (the next call with a signature captures it again)."""
        with self._lock:
            self._graphs.clear()

    def __call__(self, buffers: Mapping[str, Any]) -> dict:
        leaves, spec = pytree.tree_flatten(dict(buffers))
        if not any(isinstance(l, torch.Tensor) and l.is_cuda for l in leaves):
            return self.fn(buffers)
        key = (str(spec), _graph_key(leaves))
        with self._lock:
            entry = self._graphs.get(key)
            if entry is None:
                entry = self._graphs[key] = self._capture(leaves, spec)
            torch._foreach_copy_(entry.static_in, [leaves[i] for i in entry.in_index])
            entry.graph.replay()
            fresh = {dt: buf.clone() for dt, buf in entry.flat.items()}
        out, it = [], iter(entry.out_leaves)
        for lay in entry.layout:
            if lay is None:
                out.append(next(it))
            else:
                dt, off, shape = lay
                out.append(fresh[dt][off:off + math.prod(shape)].view(shape))
        return pytree.tree_unflatten(out, entry.out_spec)

    def _capture(self, leaves: list, spec) -> _Captured:
        in_index = [i for i, l in enumerate(leaves)
                    if isinstance(l, torch.Tensor) and l.is_cuda]
        static_in = [leaves[i].clone() for i in in_index]
        static_leaves = list(leaves)
        for i, t in zip(in_index, static_in):
            static_leaves[i] = t
        static_buffers = pytree.tree_unflatten(static_leaves, spec)
        device = static_in[0].device
        side = _side_stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        _fuse._current.label = None
        try:
            with torch.cuda.stream(side):
                self.fn(static_buffers)           # warm-up, outside the capture
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=side):
                out = self.fn(static_buffers)
                out_leaves, out_spec = pytree.tree_flatten(out)
                flat, layout, rest = _pack(out_leaves)
            torch.cuda.current_stream(device).wait_stream(side)
        except Exception as e:
            raise GraphCaptureError(
                f"CUDA graph capture of region {self.name!r} failed in task "
                f"{_fuse.current_task()!r}: {type(e).__name__}: {e}") from e
        self.captures += 1
        return _Captured(graph, static_in, in_index, out_spec, rest, flat, layout,
                         [l for l in leaves if isinstance(l, nn.Module)])


def _pack(leaves: list) -> tuple[dict, list, list]:
    """Pack tensor leaves, per dtype, into one flat buffer each."""
    groups: dict[torch.dtype, list] = {}
    layout, rest = [], []
    for leaf in leaves:
        if isinstance(leaf, torch.Tensor):
            parts = groups.setdefault(leaf.dtype, [])
            layout.append((leaf.dtype, sum(p.numel() for p in parts), tuple(leaf.shape)))
            parts.append(leaf.reshape(-1))
        else:
            layout.append(None)
            rest.append(leaf)
    flat = {dt: torch.cat(parts) for dt, parts in groups.items()}
    return flat, layout, rest


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
                    jit: bool) -> Callable[[dict], dict]:
    sig, slot_map, payloads = structure_signature(tdg, outputs)
    canon_donate = tuple(sorted(slot_map[s] for s in donate_slots if s in slot_map))
    # The kernel mode keys the cache, and is re-entered around every call,
    # so two callers pinned to different substrates never share an entry;
    # the batcher's plan key does the same for fusion plans.
    mode = _kreg.kernel_mode()
    key = (sig, tuple(id(p) for p in payloads), canon_donate, fuse,
           min_class_size, _costmodel.plan_key(batcher), mode, jit)

    with _intern_lock:
        entry = _intern_cache.get(key)
        if entry is not None:
            _intern_counters["hits"] += 1
            _intern_cache.move_to_end(key)
        else:
            _intern_counters["misses"] += 1
    if entry is None:
        actual = list(outputs) if outputs is not None else list(tdg.output_slots)
        base = _base_function(tdg, actual, fuse, min_class_size, batcher)
        from_canon = {c: a for a, c in slot_map.items()}

        def canon_run(cbuffers: dict) -> dict:
            out = base({from_canon[c]: v for c, v in cbuffers.items()})
            return {slot_map[s]: v for s, v in out.items()}

        canon_run.__name__ = f"tdg_interned_{tdg.region}"
        new = _InternEntry(payloads, GraphReplay(canon_run, tdg.region)
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
              batcher: str = "auto") -> Callable[[dict], dict]:
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
    ``donate_slots`` names buffers the caller gives up: a key component, as
    in the reference; no buffer is reused from them yet.
    """
    donate_slots = tuple(donate_slots)
    do_fuse = fuse_enabled(fuse) and order is None
    if intern == "auto":
        intern = jit and order is None
    elif intern and order is not None:
        raise ValueError("intern=True requires order=None "
                         "(interned callables run in wave order)")
    if intern:
        return _interned_lower(tdg, list(outputs) if outputs is not None else None,
                               donate_slots, do_fuse, min_class_size, batcher, jit)
    fn = (_base_function(tdg, outputs, do_fuse, min_class_size, batcher)
          if order is None else tdg_as_function(tdg, order=order, outputs=outputs))
    return GraphReplay(fn, tdg.region) if jit else fn
