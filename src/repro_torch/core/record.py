"""Record-and-replay + static TDG construction (port of ``repro.core.record``).

``@taskgraph`` marks a fully taskified region: a builder ``fn(g, **buffers)``
whose only effects are ``g.task(...)`` spawns over named buffer slots, plus
deterministic, task-free control flow (the paper's conformance rules,
§4.1). As in Algorithm 4.1 of the paper:

* **static TDG** (``build_static``): the TDG is built ahead of time by
  evaluating the builder on meta tensors (the port's ``jax.eval_shape``;
  no data touched, no kernel launched);
* **record** (first call): the region runs eagerly while being recorded:
  each spawn resolves its depend clauses against the last-writer/readers
  table once, and runs;
* **replay** (later calls): the cached TDG is lowered by
  ``lower.lower_tdg`` (wave-fused, structurally interned, and on CUDA
  buffers replayed from a captured CUDA graph) and re-executed with no
  per-task orchestration.

Regions are registered by source location (file, line, name), as the paper
keys TDGs (§4.3.3). Unless ``nowait=True``, a call returns after the
buffers' device has finished (the counterpart of ``block_until_ready``).
The replay cache is keyed by (buffers signature, kernel mode, replay-mesh
fingerprint, batcher plan key), so flipping ``REPRO_TORCH_KERNELS``,
``REPRO_MESH`` or ``REPRO_TORCH_ADAPTIVE`` between replays re-lowers
instead of serving a stale callable.
"""
from __future__ import annotations

import threading
from typing import Any, Callable

import torch
from torch.utils import _pytree as pytree

from ..kernels import registry as _kreg
from ..sharding import replay as _shreplay
from . import costmodel as _costmodel
from . import fuse as _fuse
from . import lower as _lower
from . import schedule as _schedule
from .tdg import TDG, Task, abstract_eval, abstract_leaf, buffers_signature

_REGISTRY: dict[tuple, "TaskGraphRegion"] = {}
_registry_lock = threading.Lock()


def registry() -> dict[tuple, "TaskGraphRegion"]:
    return dict(_REGISTRY)


def reset_registry() -> None:
    with _registry_lock:
        _REGISTRY.clear()


def synchronize(tree: Any) -> None:
    """Wait for the device of the first CUDA tensor in ``tree``, if any."""
    for leaf in pytree.tree_leaves(tree):
        if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
            torch.cuda.synchronize(leaf.device)
            return


class GraphBuilder:
    """The ``g`` handle passed to region builder functions."""

    def __init__(self, tdg: TDG, env: dict | None, abstract: bool):
        self._tdg = tdg
        self._env = env
        self._abstract = abstract

    @property
    def tdg(self) -> TDG:
        return self._tdg

    def task(self, fn: Callable, ins=(), outs=(), inouts=(), name: str = "",
             cost_hint: float = 1.0, **metadata) -> Task:
        """Spawn a task (``#pragma omp task depend(...)``)."""
        task = self._tdg.add_task(fn, ins=ins, outs=outs, inouts=inouts,
                                  name=name, cost_hint=cost_hint, **metadata)
        if self._env is not None:
            args = [self._env[s] for s in task.ins]
            out = abstract_eval(fn, *args) if self._abstract else fn(*args)
            _fuse._bind_outs(task, out, self._env)
        return task

    def slots(self) -> list[str]:
        return list(self._env) if self._env is not None else []


class TaskGraphRegion:
    """A taskgraph region: static-or-recorded TDG + replay cache."""

    def __init__(self, build_fn: Callable, name: str | None = None,
                 nowait: bool = False, donate_slots: tuple[str, ...] = (),
                 recurrent: bool = True, outputs: tuple[str, ...] | None = None,
                 fuse: bool | str = "auto", batcher: str = "auto",
                 mesh: Any = "auto"):
        code = build_fn.__code__
        self.build_fn = build_fn
        self.outputs = tuple(outputs) if outputs is not None else None
        self.fuse = fuse
        # Kept unresolved: "auto" re-reads REPRO_TORCH_ADAPTIVE per replay
        # through costmodel.plan_key, which keys the replay cache.
        self.batcher = batcher
        # Kept unresolved too: a decorator runs at import, and "auto" is
        # resolved (REPRO_MESH, a use_mesh scope) at each replay and keys
        # the replay cache by its fingerprint.
        self.mesh = mesh
        self.name = name or build_fn.__name__
        # paper §4.3.3: TDGs are identified by source location
        self.source_location = (code.co_filename, code.co_firstlineno, self.name)
        self.nowait = nowait
        self.donate_slots = tuple(donate_slots)
        self.recurrent = recurrent
        self.tdg: TDG | None = None
        self.static = False
        self._replay_cache: dict[tuple, Callable] = {}
        self.records = 0
        self.replays = 0
        with _registry_lock:
            if self.source_location in _REGISTRY:
                raise ValueError(
                    f"taskgraph region already registered at {self.source_location} "
                    "(the directive cannot be declared recursively, paper §4.1)")
            _REGISTRY[self.source_location] = self

    def _finish(self, out: dict) -> dict:
        if not self.nowait:
            synchronize(out)
        return out

    # -- TDG construction --------------------------------------------------
    def build_static(self, **buffer_specs) -> TDG:
        """Compile-time TDG from abstract buffers (paper Fig. 4b/4d):
        ``buffer_specs`` may be meta tensors or real ones (only their shapes
        and dtypes are read)."""
        tdg = TDG(region=self.name)
        env = {k: pytree.tree_map(abstract_leaf, v) for k, v in buffer_specs.items()}
        self.build_fn(GraphBuilder(tdg, env, abstract=True), **buffer_specs)
        tdg.validate()
        self.tdg = tdg
        self.static = True
        return tdg

    def record(self, **buffers) -> dict:
        """First execution: run eagerly while recording (paper §4.3.2)."""
        tdg = TDG(region=self.name)
        env = dict(buffers)
        self.build_fn(GraphBuilder(tdg, env, abstract=False), **buffers)
        tdg.validate()
        self.tdg = tdg
        self.static = False
        self.records += 1
        return self._finish({s: env[s] for s in (self.outputs or tdg.output_slots)})

    # -- execution ---------------------------------------------------------
    def replay(self, **buffers) -> dict:
        if self.tdg is None:
            raise RuntimeError(f"region {self.name!r} has no TDG yet")
        mode = _kreg.resolved_mode()
        mesh = _shreplay.resolve_mesh(self.mesh)
        sig = (buffers_signature(buffers), mode, _shreplay.mesh_fingerprint(mesh),
               _costmodel.plan_key(self.batcher))
        fn = self._replay_cache.get(sig)
        with _kreg.kernel_mode_scope(mode):
            if fn is None:
                fn = _lower.lower_tdg(self.tdg, donate_slots=self.donate_slots,
                                      outputs=self.outputs, fuse=self.fuse,
                                      batcher=self.batcher, mesh=mesh)
                self._replay_cache[sig] = fn
            out = fn(buffers)
        self.replays += 1
        return self._finish(out)

    def warmup(self, **buffers) -> _lower.AotExecutable:
        """Export the replay program for these buffers' specs, ahead of time.

        ``buffers`` are real tensors on the device the program is for (pair
        with ``build_static`` for a warmup before any record). The program is
        installed in the replay cache, so the next matching call replays it
        with no lowering or tracing, and the returned ``AotExecutable`` can be
        persisted for other processes with ``serialize.save_executable``.
        """
        if self.tdg is None:
            raise RuntimeError(
                f"region {self.name!r} has no TDG yet — call build_static() "
                "or record once before warming up")
        mode = _kreg.resolved_mode()
        mesh = _shreplay.resolve_mesh(self.mesh)
        with _kreg.kernel_mode_scope(mode):
            aot = _lower.aot_compile_tdg(self.tdg, buffers, outputs=self.outputs,
                                         donate_slots=self.donate_slots,
                                         fuse=self.fuse, batcher=self.batcher, mesh=mesh)
        self._replay_cache[(buffers_signature(buffers), mode, _shreplay.mesh_fingerprint(mesh),
                            _costmodel.plan_key(self.batcher))] = aot
        return aot

    def __call__(self, **buffers) -> dict:
        if self.tdg is None:
            if self.recurrent:
                return self.record(**buffers)
            # non-recurrent region: no TDG is worth building (Algorithm 4.1
            # line 23: plain task instantiation) — run eagerly.
            tdg = TDG(region=self.name)
            env = dict(buffers)
            self.build_fn(GraphBuilder(tdg, env, abstract=False), **buffers)
            return self._finish({s: env[s] for s in (self.outputs or tdg.output_slots)})
        return self.replay(**buffers)

    # -- introspection -----------------------------------------------------
    def as_function(self) -> Callable[[dict], dict]:
        """The replayable function (for grad, vmap or outer-TDG embedding)."""
        if self.tdg is None:
            raise RuntimeError(f"region {self.name!r} has no TDG yet")
        return _lower.tdg_as_function(self.tdg, outputs=self.outputs)

    def schedule_summary(self, n_workers: int = 8) -> dict:
        assert self.tdg is not None
        waves = _schedule.topo_waves(self.tdg)
        return {
            "fusion": _fuse.plan(self.tdg).summary(),
            "tasks": self.tdg.num_tasks,
            "edges": self.tdg.num_edges,
            "roots": len(self.tdg.roots()),
            "waves": len(waves),
            "max_wave_width": max((len(w) for w in waves), default=0),
            "parallelism": _schedule.parallelism(self.tdg),
            "dep_lookups_at_record": self.tdg.dep_lookups(),
        }


def taskgraph(fn: Callable | None = None, *, name: str | None = None,
              nowait: bool = False, donate_slots: tuple[str, ...] = (),
              recurrent: bool = True, outputs: tuple[str, ...] | None = None,
              fuse: bool | str = "auto", batcher: str = "auto",
              mesh: Any = "auto"):
    """Decorator form: ``@taskgraph`` / ``@taskgraph(nowait=True)``."""

    def wrap(f: Callable) -> TaskGraphRegion:
        return TaskGraphRegion(f, name=name, nowait=nowait,
                               donate_slots=donate_slots, recurrent=recurrent,
                               outputs=outputs, fuse=fuse, batcher=batcher,
                               mesh=mesh)

    if fn is not None:
        return wrap(fn)
    return wrap
