"""Lower a TDG to one replay callable (port of ``repro.core.lower``).

Replay emits the whole region as one function of a buffer dict and runs it
with no per-task orchestration: no dependency lookups, no ready queues.
This slice ports the unrolled form (one call per task, in topological
order) and the structural intern cache: lowered callables are shared
globally by the TDG's canonical structure, its payload identities, its
donated slots and the kernel mode, so structurally identical regions (N
tenants of one decode step) share one entry. ``intern_stats()`` exposes the
hit/miss counters.

PyTorch runs eagerly, so there is no ``jit``: the lowered callable runs the
tasks as they are. Wave fusion and CUDA-graph capture as replay are later
work (ROADMAP.md, queue A item 4).
"""
from __future__ import annotations

import collections
import dataclasses
import threading
from typing import Any, Callable, Mapping, Sequence

from ..kernels import registry as _kreg
from . import schedule as _schedule
from .tdg import TDG, structure_signature


def _bind_outs(task, out, env: dict) -> None:
    """Write one task's return value into the env."""
    if len(task.outs) == 1:
        env[task.outs[0]] = out
    elif len(task.outs) > 1:
        if not isinstance(out, (tuple, list)) or len(out) != len(task.outs):
            raise ValueError(
                f"task {task.label()} declared {len(task.outs)} outputs, "
                f"returned {type(out).__name__}")
        for s, v in zip(task.outs, out):
            env[s] = v


def _run_unrolled(tdg: TDG, tids: Sequence[int], env: dict) -> None:
    for tid in tids:
        t = tdg.tasks[tid]
        try:
            args = [env[s] for s in t.ins]
        except KeyError as e:
            raise KeyError(f"task {t.label()} reads unbound slot {e} "
                           f"(region inputs: {tdg.input_slots})") from None
        _bind_outs(t, t.fn(*args), env)


def tdg_as_function(tdg: TDG, order: Sequence[int] | None = None,
                    outputs: Sequence[str] | None = None) -> Callable[[dict], dict]:
    """Return ``f(buffers) -> {slot: value}`` executing the TDG in ``order``.

    The function has no side effects of its own, so it can be vmapped or
    embedded as a task of an outer TDG.
    """
    order = list(order) if order is not None else _schedule.topo_order(tdg)
    outputs = list(outputs) if outputs is not None else list(tdg.output_slots)
    if not _schedule.validate_execution_order(tdg, order):
        raise ValueError(f"order does not respect TDG edges for {tdg.region!r}")

    def run(buffers: Mapping[str, Any]) -> dict:
        env = dict(buffers)
        _run_unrolled(tdg, order, env)
        return {s: env[s] for s in outputs}

    run.__name__ = f"tdg_{tdg.region}"
    return run


# ------------------------------------------------------------- interning

@dataclasses.dataclass
class _InternEntry:
    payloads: tuple            # strong refs: pins the id()s the key relies on
    fn: Callable[[dict], dict]  # on canonical slot names


_intern_lock = threading.Lock()
# LRU-bounded: entries pin their payload closures (that is what makes id()
# keys sound), so an unbounded cache would leak in processes that keep
# building TDGs with fresh closures.
_INTERN_CAP = 256
_intern_cache: collections.OrderedDict[tuple, _InternEntry] = collections.OrderedDict()
_intern_counters = {"hits": 0, "misses": 0, "evictions": 0}


def intern_stats() -> dict:
    """Hit/miss counters + size of the global structural cache."""
    with _intern_lock:
        return {**_intern_counters, "entries": len(_intern_cache)}


def clear_intern_cache() -> None:
    with _intern_lock:
        _intern_cache.clear()
        for k in _intern_counters:
            _intern_counters[k] = 0


def _interned_lower(tdg: TDG, outputs, donate_slots: tuple[str, ...]
                    ) -> Callable[[dict], dict]:
    sig, slot_map, payloads = structure_signature(tdg, outputs)
    canon_donate = tuple(sorted(slot_map[s] for s in donate_slots if s in slot_map))
    # The kernel mode keys the cache, and is re-entered around every call,
    # so two callers pinned to different substrates never share an entry.
    mode = _kreg.kernel_mode()
    key = (sig, tuple(id(p) for p in payloads), canon_donate, mode)

    with _intern_lock:
        entry = _intern_cache.get(key)
        if entry is not None:
            _intern_counters["hits"] += 1
            _intern_cache.move_to_end(key)
        else:
            _intern_counters["misses"] += 1
    if entry is None:
        base = tdg_as_function(tdg, outputs=outputs)
        from_canon = {c: a for a, c in slot_map.items()}

        def canon_run(cbuffers: dict) -> dict:
            out = base({from_canon[c]: v for c, v in cbuffers.items()})
            return {slot_map[s]: v for s, v in out.items()}

        canon_run.__name__ = f"tdg_interned_{tdg.region}"
        with _intern_lock:
            entry = _intern_cache.setdefault(key, _InternEntry(payloads, canon_run))
            _intern_cache.move_to_end(key)
            while len(_intern_cache) > _INTERN_CAP:
                _intern_cache.popitem(last=False)
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
    return run


def lower_tdg(tdg: TDG, order: Sequence[int] | None = None,
              outputs: Sequence[str] | None = None,
              donate_slots: Sequence[str] = (),
              intern: bool | str = "auto") -> Callable[[dict], dict]:
    """Lower the TDG to one replay callable.

    ``intern="auto"`` shares the callable through the global structural
    cache whenever no custom ``order`` is given; ``intern=True`` with an
    ``order`` raises. ``donate_slots`` names buffers the caller gives up
    (a cache key component, as in the reference; eager PyTorch reuses
    nothing from them).
    """
    if intern == "auto":
        intern = order is None
    elif intern and order is not None:
        raise ValueError("intern=True requires order=None "
                         "(interned callables run in topological order)")
    if intern:
        return _interned_lower(tdg, list(outputs) if outputs is not None else None,
                               tuple(donate_slots))
    return tdg_as_function(tdg, order=order, outputs=outputs)
