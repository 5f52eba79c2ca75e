"""Wave-fused lowering: worksharing-style batching of isomorphic tasks.

Port of ``repro.core.fuse``. The unrolled replay path issues every task
body one call at a time, so the work of replaying a region grows with its
task count even when the graph is a few waves of isomorphic tasks.
Following Worksharing Tasks (Maroñas et al., 2020), this module batches
fine-grained tasks back into coarse dispatches:

* :func:`classify_wave` groups one topo-wave's tasks into **isomorphism
  classes**: same payload (by identity), same input arity, shapes, dtypes
  and devices, same output arity. Tasks of one wave are independent, so a
  class can run as one batched call.
* :func:`fused_tdg_as_function` runs each class of at least
  ``min_class_size`` members as ONE ``torch.func.vmap`` call over its
  arguments stacked on axis 0 (``batcher="vmap"``), or as a loop over the
  stacked lanes (``batcher="map"``), or lets the cost model choose per
  class (``batcher="auto"``, see ``costmodel``). Argument positions whose
  slot every member shares are broadcast (``in_axes`` None), not stacked.

Fusion is best-effort: heterogeneous waves degrade to per-task calls, and a
class whose batched call raises (a payload with no batching rule, say)
falls back to the unrolled form for that class only, recorded in the
function's ``last_plan``. Classification runs on every call, from the
values' shapes, so one lowered function serves every shape.

With a replay ``mesh`` (``sharding.replay``), each ``vmap`` class is padded
to a multiple of the mesh's batch axis and its stacked lanes are split into
one contiguous chunk a shard: each shard's ``vmap`` call runs on its
device and each member's output comes back to the caller's device.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable, Mapping, Sequence

import torch
from torch.utils import _pytree as pytree

from ..sharding import replay as _shreplay
from . import costmodel as _costmodel
from . import schedule as _schedule
from .tdg import TDG, abstract_eval, abstract_leaf, leaf_signature

STACK_AXIS = 0

# The task a lowered function is running on this thread, for error messages
# (a CUDA graph capture that fails names it).
_current = threading.local()


def current_task() -> str | None:
    """Label of the task (or fused class) running on this thread, if any."""
    return getattr(_current, "label", None)


# ------------------------------------------------------------------ analysis

def value_signature(v: Any) -> tuple:
    """Abstract (tree structure, per-leaf shape/dtype/device) of one value."""
    leaves, spec = pytree.tree_flatten(v)
    return (str(spec), tuple(leaf_signature(l) for l in leaves))


@dataclasses.dataclass(frozen=True)
class WaveClass:
    """One isomorphism class inside one wave.

    ``batcher``/``reason``/``flops``/``bytes_accessed`` record how the class
    was (or would be) dispatched and the numbers behind the choice; a
    "static" reason means a caller-pinned batcher. ``padded`` counts the
    pad lanes a replay mesh added to the class (0 without one).
    """

    wave: int
    tids: tuple[int, ...]
    fused: bool                      # run as one batched call?
    shared: tuple[bool, ...]         # arg position uses one slot for all tids
    batcher: str = "vmap"            # "vmap" | "map" | "unrolled"
    reason: str = "static"
    flops: float | None = None       # measured per-member flops (if probed)
    bytes_accessed: float | None = None
    padded: int = 0

    @property
    def size(self) -> int:
        return len(self.tids)

    def decision(self) -> dict:
        """JSON-safe audit record (plan summaries)."""
        inten = (self.flops / self.bytes_accessed
                 if self.flops is not None and self.bytes_accessed else None)
        return {
            "wave": self.wave,
            "size": self.size,
            "fused": self.fused,
            "batcher": self.batcher,
            "flops": self.flops,
            "bytes": self.bytes_accessed,
            "intensity": None if inten is None else round(inten, 4),
            "padded": self.padded,
            "reason": self.reason,
        }


@dataclasses.dataclass
class FusionPlan:
    """Result of the wave analysis pass over a whole TDG."""

    region: str
    num_tasks: int
    classes: list[WaveClass]
    min_class_size: int

    @property
    def num_waves(self) -> int:
        return 1 + max((c.wave for c in self.classes), default=-1)

    @property
    def num_classes(self) -> int:
        return len(self.classes)

    @property
    def fused_classes(self) -> int:
        return sum(1 for c in self.classes if c.fused)

    @property
    def fused_tasks(self) -> int:
        return sum(c.size for c in self.classes if c.fused)

    @property
    def fused_fraction(self) -> float:
        return self.fused_tasks / max(self.num_tasks, 1)

    @property
    def padded_lanes(self) -> int:
        return sum(c.padded for c in self.classes)

    @property
    def pad_fraction(self) -> float:
        lanes = sum(c.size + c.padded for c in self.classes if c.fused)
        return self.padded_lanes / lanes if lanes else 0.0

    def summary(self) -> dict:
        batchers: dict[str, int] = {}
        for c in self.classes:
            if c.fused:
                batchers[c.batcher] = batchers.get(c.batcher, 0) + 1
        return {
            "region": self.region,
            "tasks": self.num_tasks,
            "waves": self.num_waves,
            "classes": self.num_classes,
            "fused_classes": self.fused_classes,
            "fused_tasks": self.fused_tasks,
            "fused_fraction": round(self.fused_fraction, 4),
            "batchers": batchers,
            "padded_lanes": self.padded_lanes,
            "pad_fraction": round(self.pad_fraction, 4),
            "decisions": [c.decision() for c in self.classes],
        }


def classify_wave(tdg: TDG, wave_index: int, wave: Sequence[int],
                  sig_of: Callable[[str], Any] | None,
                  min_class_size: int = 2) -> list[WaveClass]:
    """Group one wave's tasks into isomorphism classes.

    ``sig_of`` maps a slot to an abstract value signature, or is ``None``
    for structural grouping (payload identity + arity). Classes come in
    order of first member, members in tid order.
    """
    groups: dict[tuple, list[int]] = {}
    for tid in sorted(wave):
        t = tdg.tasks[tid]
        key: tuple = (id(t.fn), len(t.ins), len(t.outs))
        if sig_of is not None:
            key += tuple(sig_of(s) for s in t.ins)
        groups.setdefault(key, []).append(tid)
    classes = []
    for tids in groups.values():
        arity = len(tdg.tasks[tids[0]].ins)
        shared = tuple(
            all(tdg.tasks[t].ins[i] == tdg.tasks[tids[0]].ins[i] for t in tids)
            for i in range(arity))
        classes.append(WaveClass(wave=wave_index, tids=tuple(tids),
                                 fused=len(tids) >= min_class_size,
                                 shared=shared))
    return classes


def _decide_class(tdg: TDG, cls: WaveClass, batcher: str,
                  value_of: Callable[[str], Any] | None) -> WaveClass:
    """Attach a batcher decision (and the numbers behind it) to one class.

    ``batcher="auto"`` consults the process cost model for ONE member's
    arguments (``value_of`` gives them, real or meta); a static batcher
    passes through with reason "static".
    """
    if not cls.fused:
        return dataclasses.replace(
            cls, batcher="unrolled",
            reason=f"class size {cls.size} below min_class_size")
    if batcher != "auto":
        return dataclasses.replace(cls, batcher=batcher, reason="static")
    model = _costmodel.default_model()
    t = tdg.tasks[cls.tids[0]]
    if value_of is None:
        d = model.decide(_costmodel.UNMEASURED, cls.size)
    else:
        d = model.decide_for(t.fn, [value_of(s) for s in t.ins], cls.size)
    return dataclasses.replace(
        cls, batcher=d.batcher, fused=d.batcher != "unrolled",
        reason=d.reason, flops=d.cost.flops,
        bytes_accessed=d.cost.bytes_accessed)


def plan(tdg: TDG, buffers: Mapping[str, Any] | None = None,
         min_class_size: int = 2, batcher: str = "vmap") -> FusionPlan:
    """Offline wave analysis (stats, tests, reports).

    With ``buffers`` (tensors, real or meta), slot shapes propagate through
    the graph by abstract evaluation on meta tensors, so the classes match
    what the fused function will form; without them, grouping is structural
    (an upper bound). ``batcher="auto"`` also runs the cost model per class.
    """
    batcher = _costmodel.resolve_batcher(batcher)
    sig_of = value_of = None
    if buffers is not None:
        env: dict[str, Any] = {k: pytree.tree_map(abstract_leaf, v)
                               for k, v in buffers.items()}
        for tid in _schedule.topo_order(tdg):
            t = tdg.tasks[tid]
            _bind_outs(t, abstract_eval(t.fn, *[env[s] for s in t.ins]), env)
        sig_of = lambda s: value_signature(env[s])  # noqa: E731
        value_of = env.__getitem__
    classes: list[WaveClass] = []
    for wi, wave in enumerate(_schedule.topo_waves(tdg)):
        classes.extend(
            _decide_class(tdg, c, batcher, value_of)
            for c in classify_wave(tdg, wi, wave, sig_of, min_class_size))
    return FusionPlan(region=tdg.region, num_tasks=tdg.num_tasks,
                      classes=classes, min_class_size=min_class_size)


# ----------------------------------------------------------------- execution

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
        _current.label = t.label()
        _bind_outs(t, t.fn(*args), env)


def _stack(members: list) -> Any:
    return pytree.tree_map(lambda *xs: torch.stack(xs, STACK_AXIS), *members)


def _run_fused_class(tdg: TDG, cls: WaveClass, env: dict, batcher: str,
                     mesh=None) -> int:
    """Execute one isomorphism class as a single batched call; return #pads.

    With a ``mesh``, the ``vmap`` form pads the class to a multiple of the
    mesh's batch-axis size (repeating the last member: pad lanes are
    computed and never read), splits the stacked varying arguments into one
    contiguous chunk a shard (``shard_leading``), broadcasts the shared
    ones to each shard's device, and runs each shard's ``vmap`` call on its
    device; each member's output is its lane of its shard's result, on the
    caller's device. ``batcher="map"`` runs one lane at a time and ignores
    the mesh. The split happens outside ``vmap``, so a payload's ops need
    no rule of their own for it.
    """
    tasks = [tdg.tasks[t] for t in cls.tids]
    fn = tasks[0].fn
    arity = len(tasks[0].ins)
    varying = [i for i in range(arity) if not cls.shared[i]]
    _current.label = (f"{tasks[0].label()} (class of {cls.size} in wave "
                      f"{cls.wave}, {batcher})")

    if not varying:
        # Every member reads identical slots: one evaluation serves all
        # (distinct out slots: a WAW pair cannot share a wave).
        out = fn(*[env[tasks[0].ins[i]] for i in range(arity)])
        for t in tasks:
            _bind_outs(t, out, env)
        return 0

    if batcher != "vmap":
        mesh = None
    shared_args = {i: env[tasks[0].ins[i]] for i in range(arity) if cls.shared[i]}
    members = {i: [env[t.ins[i]] for t in tasks] for i in varying}
    padded = 0
    for i in varying:
        padded = _shreplay.pad_group(members[i], mesh)
    stacked = {i: _stack(members[i]) for i in varying}

    if batcher == "vmap":
        in_axes = tuple(None if cls.shared[i] else STACK_AXIS for i in range(arity))
        if mesh is None:
            args = [shared_args[i] if cls.shared[i] else stacked[i] for i in range(arity)]
            out = torch.func.vmap(fn, in_dims=in_axes)(*args)
        else:
            _bind_sharded(tasks, fn, in_axes, shared_args, stacked,
                          len(tasks) + padded, mesh, env)
            return padded
    elif batcher == "map":
        lanes = []
        for j in range(len(tasks)):
            lane = {i: pytree.tree_map(lambda x, _j=j: x[_j], stacked[i]) for i in varying}
            lanes.append(fn(*[shared_args[i] if cls.shared[i] else lane[i]
                              for i in range(arity)]))
        out = _stack(lanes)
    else:
        raise ValueError(f"unknown batcher {batcher!r} (vmap | map)")

    n_outs = len(tasks[0].outs)
    for j, t in enumerate(tasks):
        take = lambda x, _j=j: x.select(STACK_AXIS, _j)  # noqa: E731
        if n_outs == 1:
            env[t.outs[0]] = pytree.tree_map(take, out)
        else:
            if not isinstance(out, (tuple, list)) or len(out) != n_outs:
                raise ValueError(
                    f"task {t.label()} declared {n_outs} outputs, "
                    f"returned {type(out).__name__}")
            for oi, s in enumerate(t.outs):
                env[s] = pytree.tree_map(take, out[oi])
    return padded


class CrossDeviceCapture(RuntimeError):
    """A sharded class reached a device other than the one a CUDA graph is
    being captured on. Raised, never answered by the unrolled form."""


def _home_device(tree: Any) -> torch.device:
    for leaf in pytree.tree_leaves(tree):
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    return torch.device("cpu")


def _bind_sharded(tasks: list, fn: Callable, in_axes: tuple, shared_args: dict,
                  stacked: dict, n_lanes: int, mesh, env: dict) -> None:
    """One ``vmap`` call a batch shard over its chunk of ``stacked`` (a
    one-lane shard too: a vmap lane, like the whole-batch call's lanes).
    Each member's outputs are its lane of its shard's result, moved to the
    home device (the device of the class's first stacked argument)."""
    home = _home_device(stacked)
    if (home.type == "cuda" and torch.cuda.is_current_stream_capturing()
            and any(d != home for d in _shreplay.shard_devices(mesh))):
        raise CrossDeviceCapture(
            f"class of {len(tasks)} sharded over {list(map(str, _shreplay.shard_devices(mesh)))}: "
            f"a CUDA graph captured on {home} holds that device's work alone; "
            f"lower the region with jit=False")
    chunks = {i: _shreplay.shard_leading(v, mesh) for i, v in stacked.items()}
    n_outs = len(tasks[0].outs)
    for k, (device, start, stop) in enumerate(_shreplay.lane_chunks(n_lanes, mesh)):
        args = [_shreplay.replicate(shared_args[i], device) if in_axes[i] is None
                else chunks[i][k] for i in range(len(in_axes))]
        with _shreplay.on_device(device):
            out = torch.func.vmap(fn, in_dims=in_axes)(*args)
        if n_outs > 1 and (not isinstance(out, (tuple, list)) or len(out) != n_outs):
            raise ValueError(f"task {tasks[0].label()} declared {n_outs} outputs, "
                             f"returned {type(out).__name__}")
        for j in range(start, min(stop, len(tasks))):
            take = lambda x, _j=j - start: x.select(STACK_AXIS, _j).to(home)  # noqa: E731
            t = tasks[j]
            if n_outs == 1:
                env[t.outs[0]] = pytree.tree_map(take, out)
            else:
                for oi, s in enumerate(t.outs):
                    env[s] = pytree.tree_map(take, out[oi])


def fused_tdg_as_function(tdg: TDG, outputs: Sequence[str] | None = None,
                          min_class_size: int = 2,
                          batcher: str = "vmap", mesh=None) -> Callable[[dict], dict]:
    """Return ``f(buffers) -> {slot: value}`` with wave-fused task dispatch.

    Drop-in for ``lower.tdg_as_function`` (no side effects of its own,
    differentiable); tasks run in wave order, which refines the same
    partial order as any topological order. After each call,
    ``f.last_plan`` holds the :class:`FusionPlan` applied, fallbacks
    included. ``batcher`` is ``"vmap"`` / ``"map"`` (pinned) or ``"auto"``
    (the cost model per class); the ``REPRO_TORCH_ADAPTIVE`` kill switch is
    read per call.

    ``mesh`` (a ``ReplayMesh`` or ``None``; ``lower.lower_tdg`` resolves
    ``"auto"``) shards every ``vmap`` class's stacked lanes over the mesh's
    batch axis (:func:`_run_fused_class`). Classes that fall back to the
    unrolled form stay on the caller's device.
    """
    waves = _schedule.topo_waves(tdg)
    outputs = list(outputs) if outputs is not None else list(tdg.output_slots)

    def run(buffers: Mapping[str, Any]) -> dict:
        env = dict(buffers)
        resolved = _costmodel.resolve_batcher(batcher)
        applied: list[WaveClass] = []

        def sig_of(s):
            try:
                return value_signature(env[s])
            except KeyError:
                raise KeyError(f"unbound slot {s!r} (region inputs: "
                               f"{tdg.input_slots})") from None

        for wi, wave in enumerate(waves):
            for cls in classify_wave(tdg, wi, wave, sig_of, min_class_size):
                cls = _decide_class(tdg, cls, resolved, env.__getitem__)
                if not cls.fused:
                    _run_unrolled(tdg, cls.tids, env)
                    applied.append(cls)
                    continue
                try:
                    padded = _run_fused_class(tdg, cls, env, cls.batcher, mesh=mesh)
                    applied.append(dataclasses.replace(cls, padded=padded))
                except CrossDeviceCapture:
                    raise
                except Exception:
                    # Payload not batchable (no vmap rule, data-dependent
                    # control flow, ...): this class only degrades to the
                    # unrolled form. A payload broken per se re-raises
                    # from here with its real error.
                    _run_unrolled(tdg, cls.tids, env)
                    applied.append(dataclasses.replace(
                        cls, fused=False, batcher="unrolled",
                        reason="trace fallback: payload not batchable"))
        run.last_plan = FusionPlan(region=tdg.region, num_tasks=tdg.num_tasks,
                                   classes=applied, min_class_size=min_class_size)
        return {s: env[s] for s in outputs}

    run.last_plan = None
    run.__name__ = f"tdg_fused_{tdg.region}"
    return run
