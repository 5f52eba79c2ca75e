"""Executors for a TDG (port of ``repro.core.executor``).

``EagerExecutor`` is the vanilla-runtime analogue: a dynamic task scheduler
with per-worker deques, round-robin root placement, optional work stealing
and join counters, dispatching one payload call per task. Every per-task
cost it pays — Python bookkeeping, ready-queue operations, dispatch — is
the measured stand-in for the task creation and contention overheads of
vanilla GCC/LLVM OpenMP runtimes. ``central_queue=True`` reproduces the
GOMP-like single shared queue. Its ``ExecStats`` counters equal the
reference's on the same TDG. One difference: the reference jits each task
(one XLA executable per task instance); the port calls each payload as it
is, since PyTorch runs eagerly, so each task is one or more kernel launches.

``ReplayExecutor`` runs the region lowered by ``lower.lower_tdg`` (the
paper's execute_TDG): wave-fused, interned, and on CUDA buffers replayed
from a captured CUDA graph. The kernel mode and the batcher plan are
resolved once at construction and pinned for every lowering and call.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Callable, Mapping

from ..kernels import registry as _kreg
from ..sharding import replay as _shreplay
from . import costmodel as _costmodel
from . import lower as _lower
from . import schedule as _schedule
from .record import synchronize
from .tdg import TDG, buffers_signature


@dataclasses.dataclass
class ExecStats:
    tasks_executed: int = 0
    queue_ops: int = 0          # pushes+pops on ready queues (contention proxy)
    steals: int = 0
    dep_resolutions: int = 0    # join-counter decrements (runtime dep tracking)
    dispatch_seconds: float = 0.0
    wall_seconds: float = 0.0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class EagerExecutor:
    """Dynamic scheduler over per-worker deques (the 'vanilla' baseline)."""

    def __init__(self, tdg: TDG, n_workers: int = 4, central_queue: bool = False,
                 steal: bool = True, round_robin_roots: bool = True):
        tdg.validate()
        self.tdg = tdg
        self.n_workers = max(1, n_workers)
        self.central_queue = central_queue
        self.steal = steal
        self.round_robin_roots = round_robin_roots
        self.stats = ExecStats()

    def run(self, buffers: Mapping[str, Any],
            outputs: list[str] | None = None) -> dict:
        tdg = self.tdg
        stats = self.stats
        t0 = time.perf_counter()
        env = dict(buffers)
        join = {t.tid: len(tdg.preds[t.tid]) for t in tdg.tasks}

        nq = 1 if self.central_queue else self.n_workers
        queues: list[collections.deque[int]] = [collections.deque() for _ in range(nq)]

        roots = tdg.roots()
        if self.round_robin_roots and not self.central_queue:
            for w, tids in enumerate(_schedule.round_robin_assign(roots, nq)):
                for tid in tids:
                    queues[w].append(tid)
                    stats.queue_ops += 1
        else:
            for tid in roots:  # vanilla: the spawning thread owns all roots
                queues[0].append(tid)
                stats.queue_ops += 1

        executed = 0
        w = 0
        while executed < tdg.num_tasks:
            # pick a task: own queue first, then steal (FIFO from victim)
            tid = None
            if queues[w % nq]:
                tid = queues[w % nq].popleft()
                stats.queue_ops += 1
            elif self.steal:
                for off in range(1, nq):
                    victim = (w + off) % nq
                    if queues[victim]:
                        tid = queues[victim].popleft()
                        stats.queue_ops += 1
                        stats.steals += 1
                        break
            if tid is None:
                w += 1
                continue

            task = tdg.tasks[tid]
            args = [env[s] for s in task.ins]
            d0 = time.perf_counter()
            out = task.fn(*args)
            stats.dispatch_seconds += time.perf_counter() - d0
            if len(task.outs) == 1:
                env[task.outs[0]] = out
            elif len(task.outs) > 1:
                for s, v in zip(task.outs, out):
                    env[s] = v
            executed += 1
            stats.tasks_executed += 1
            # dependency resolution at run time (what replay eliminates)
            for sid in sorted(tdg.succs[tid]):
                stats.dep_resolutions += 1
                join[sid] -= 1
                if join[sid] == 0:
                    queues[w % nq].append(sid)  # locality: completer enqueues
                    stats.queue_ops += 1
            w += 1

        outputs = outputs if outputs is not None else list(tdg.output_slots)
        result = {s: env[s] for s in outputs}
        synchronize(result)
        stats.wall_seconds += time.perf_counter() - t0
        return result


class ReplayExecutor:
    """Cached fused execution of a TDG (the paper's execute_TDG).

    ``kernel_mode`` selects the kernel substrate for every task body
    (``None`` = the mode in effect at construction). It and the batcher
    plan (``"auto"`` -> the cost model, or ``"vmap"`` under
    ``REPRO_TORCH_ADAPTIVE=0``) are resolved once, here, and key the
    per-signature cache, and so is the replay ``mesh`` (``"auto"``: a
    ``use_mesh`` scope, then ``REPRO_MESH``), by its fingerprint
    ``mesh_fp``. Lowering is wave-fused, interned, and captured as a CUDA
    graph on CUDA buffers (``lower_tdg(jit=True)``).
    """

    def __init__(self, tdg: TDG, donate_slots: tuple[str, ...] = (),
                 order: list[int] | None = None,
                 kernel_mode: str | None = None,
                 fuse: bool | str = "auto",
                 batcher: str = "auto",
                 mesh: Any = "auto"):
        tdg.validate()
        self.tdg = tdg
        self.donate_slots = tuple(donate_slots)
        self.order = order
        self.fuse = fuse
        self.batcher = batcher
        self.plan_key = _costmodel.plan_key(batcher)
        self.kernel_mode = _kreg.resolved_mode(kernel_mode)
        self.mesh = _shreplay.resolve_mesh(mesh)
        self.mesh_fp = _shreplay.mesh_fingerprint(self.mesh)
        self._cache: dict[tuple, Callable] = {}
        self.replays = 0

    def _compiled_for(self, buffers: Mapping[str, Any]) -> Callable:
        sig = (buffers_signature(buffers), self.kernel_mode, self.mesh_fp, self.plan_key)
        fn = self._cache.get(sig)
        if fn is None:
            with _kreg.kernel_mode_scope(self.kernel_mode):
                fn = _lower.lower_tdg(self.tdg, order=self.order,
                                      donate_slots=self.donate_slots,
                                      fuse=self.fuse, batcher=self.batcher,
                                      mesh=self.mesh)
            self._cache[sig] = fn
        return fn

    def aot_compile(self, buffers: Mapping[str, Any]) -> "_lower.AotExecutable":
        """Export the replay program for these buffers' specs, now.

        The program is installed in the per-signature cache under this
        executor's pinned substrate, so later ``run`` calls with matching
        buffers replay it with no lowering or tracing; the returned
        ``AotExecutable`` carries the cost analysis and is serializable with
        ``serialize.save_executable``. Requires ``order=None`` (the exported
        program is wave-ordered).
        """
        if self.order is not None:
            raise ValueError("aot_compile does not support a custom order")
        with _kreg.kernel_mode_scope(self.kernel_mode):
            aot = _lower.aot_compile_tdg(self.tdg, buffers,
                                         donate_slots=self.donate_slots,
                                         fuse=self.fuse, batcher=self.batcher,
                                         mesh=self.mesh)
        self._cache[(buffers_signature(buffers), self.kernel_mode, self.mesh_fp,
                     self.plan_key)] = aot
        return aot

    def run(self, buffers: Mapping[str, Any], block: bool = True) -> dict:
        fn = self._compiled_for(buffers)
        with _kreg.kernel_mode_scope(self.kernel_mode):
            out = fn(dict(buffers))
        self.replays += 1
        if block:
            synchronize(out)
        return out
