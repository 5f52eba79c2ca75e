"""Schedules over a TDG (port of ``repro.core.schedule``).

Pure Python, copied from the reference, so its results equal the
reference's on the same TDG: a deterministic topological order, the wave
decomposition (topological levels) that the replay lowering walks, the
paper's round-robin placement of each wave on workers (§4.3.1/§4.3.2), a
list scheduler (HEFT-lite) for placement under cost hints, the
critical-path metrics, and the GPipe / 1F1B pipeline schedules (a pipeline
schedule *is* a static TDG over (microbatch, stage) tasks).
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Callable, Sequence

from .tdg import TDG, Task


def topo_order(tdg: TDG) -> list[int]:
    """Deterministic topological order (Kahn, tid tie-break = record order)."""
    indeg = {t.tid: len(tdg.preds[t.tid]) for t in tdg.tasks}
    ready = [tid for tid, d in indeg.items() if d == 0]
    heapq.heapify(ready)
    order: list[int] = []
    while ready:
        tid = heapq.heappop(ready)
        order.append(tid)
        for s in sorted(tdg.succs[tid]):
            indeg[s] -= 1
            if indeg[s] == 0:
                heapq.heappush(ready, s)
    if len(order) != tdg.num_tasks:
        raise ValueError(f"cycle detected in {tdg.region!r}")
    return order


def topo_waves(tdg: TDG) -> list[list[int]]:
    """Wave k = tasks whose longest pred-path has length k."""
    depth: dict[int, int] = {}
    for tid in topo_order(tdg):
        depth[tid] = 1 + max((depth[p] for p in tdg.preds[tid]), default=-1)
    waves: list[list[int]] = []
    for tid, d in depth.items():
        while len(waves) <= d:
            waves.append([])
        waves[d].append(tid)
    for w in waves:
        w.sort()
    return waves


def round_robin_assign(tids: Sequence[int], n_workers: int, start: int = 0) -> list[list[int]]:
    """Paper §4.3.2: hand out tasks round-robin to per-worker queues."""
    queues: list[list[int]] = [[] for _ in range(n_workers)]
    for i, tid in enumerate(tids):
        queues[(start + i) % n_workers].append(tid)
    return queues


def wave_placement(tdg: TDG, n_workers: int) -> list[list[list[int]]]:
    """Static placement: ``placement[wave][worker] -> [tid, ...]``, each wave
    round-robin across workers, the starting worker rotating between waves
    so worker 0 does not always take the remainder."""
    placement = []
    start = 0
    for wave in topo_waves(tdg):
        placement.append(round_robin_assign(wave, n_workers, start=start))
        start = (start + len(wave)) % max(n_workers, 1)
    return placement


def critical_path(tdg: TDG, cost: Callable[[Task], float] | None = None) -> float:
    """Length of the longest weighted path (lower bound on makespan)."""
    cost = cost or (lambda t: t.cost_hint)
    dist: dict[int, float] = {}
    best = 0.0
    for tid in topo_order(tdg):
        t = tdg.tasks[tid]
        dist[tid] = cost(t) + max((dist[p] for p in tdg.preds[tid]), default=0.0)
        best = max(best, dist[tid])
    return best


def work(tdg: TDG, cost: Callable[[Task], float] | None = None) -> float:
    cost = cost or (lambda t: t.cost_hint)
    return sum(cost(t) for t in tdg.tasks)


def parallelism(tdg: TDG) -> float:
    """Average parallelism = total work / critical path (unit costs)."""
    cp = critical_path(tdg, lambda t: 1.0)
    return tdg.num_tasks / max(cp, 1.0)


@dataclasses.dataclass
class ListSchedule:
    """Output of the list scheduler: per-worker ordered task lists plus the
    simulated makespan under the cost model."""

    worker_tasks: list[list[int]]
    start_time: dict[int, float]
    finish_time: dict[int, float]
    makespan: float

    def order(self) -> list[int]:
        merged = sorted(self.start_time.items(), key=lambda kv: (kv[1], kv[0]))
        return [tid for tid, _ in merged]


def list_schedule(tdg: TDG, n_workers: int,
                  cost: Callable[[Task], float] | None = None) -> ListSchedule:
    """HEFT-lite: tasks become ready when preds finish; each ready task goes
    to the earliest-available worker; ties broken by critical-path priority.
    Communication costs are zero (shared memory / single executable)."""
    cost = cost or (lambda t: t.cost_hint)
    rank: dict[int, float] = {}          # upward rank: critical path to exit
    for tid in reversed(topo_order(tdg)):
        t = tdg.tasks[tid]
        rank[tid] = cost(t) + max((rank[s] for s in tdg.succs[tid]), default=0.0)

    indeg = {t.tid: len(tdg.preds[t.tid]) for t in tdg.tasks}
    ready_at = {t.tid: 0.0 for t in tdg.tasks}
    # ready heap: (-rank, tid) so higher rank first
    ready: list[tuple[float, int]] = [(-rank[tid], tid) for tid, d in indeg.items() if d == 0]
    heapq.heapify(ready)
    worker_free = [0.0] * n_workers
    worker_tasks: list[list[int]] = [[] for _ in range(n_workers)]
    start: dict[int, float] = {}
    finish: dict[int, float] = {}

    scheduled = 0
    while scheduled < tdg.num_tasks:
        if not ready:
            # Cannot happen for a valid DAG; a forged cycle ends here.
            raise RuntimeError(
                f"list_schedule stalled with {tdg.num_tasks - scheduled} "
                f"unscheduled tasks in {tdg.region!r} (cyclic TDG?)")
        _, tid = heapq.heappop(ready)
        t = tdg.tasks[tid]
        w = min(range(n_workers), key=lambda i: (worker_free[i], i))
        s = max(worker_free[w], ready_at[tid])
        f = s + cost(t)
        worker_free[w] = f
        worker_tasks[w].append(tid)
        start[tid], finish[tid] = s, f
        scheduled += 1
        for sid in sorted(tdg.succs[tid]):
            indeg[sid] -= 1
            ready_at[sid] = max(ready_at[sid], f)
            if indeg[sid] == 0:
                heapq.heappush(ready, (-rank[sid], sid))
    return ListSchedule(worker_tasks, start, finish, max(finish.values(), default=0.0))


# ------------------------------------ pipeline schedules as TDGs

def pipeline_tdg(n_stages: int, n_microbatches: int,
                 include_backward: bool = True) -> TDG:
    """The TDG of a synchronous pipeline-parallel step.

    Forward task F(m, s) depends on F(m, s-1) (activation flow) and the
    previous microbatch on the same stage (in-order stage occupancy).
    Backward task B(m, s) depends on B(m, s+1) and F(m, s).
    """
    tdg = TDG(region=f"pipeline[{n_stages}x{n_microbatches}]")

    def _noop(*xs):  # placeholder payload; lowering substitutes stage fns
        return xs[0] if len(xs) == 1 else xs

    for m in range(n_microbatches):
        for s in range(n_stages):
            ins = []
            if s > 0:
                ins.append(f"act[{m},{s - 1}]")
            if m > 0:
                ins.append(f"stage{s}.tok")  # serialization token per stage
            tdg.add_task(_noop, ins=ins, outs=[f"act[{m},{s}]", f"stage{s}.tok"],
                         name=f"F[{m},{s}]", microbatch=m, stage=s, phase="fwd")
    if include_backward:
        for m in range(n_microbatches):
            for s in reversed(range(n_stages)):
                ins = [f"act[{m},{s}]"]
                if s < n_stages - 1:
                    ins.append(f"grad[{m},{s + 1}]")
                tdg.add_task(_noop, ins=ins,
                             outs=[f"grad[{m},{s}]", f"stage{s}.tok"],
                             name=f"B[{m},{s}]", microbatch=m, stage=s, phase="bwd")
    tdg.validate()
    return tdg


def one_f_one_b_order(n_stages: int, n_microbatches: int) -> list[list[tuple[str, int]]]:
    """Per-stage static instruction streams for the 1F1B schedule:
    ``streams[stage] = [("F", m) | ("B", m), ...]``, a warm-up of
    (n_stages - stage) forwards, then one forward / one backward, then drain."""
    streams: list[list[tuple[str, int]]] = []
    for s in range(n_stages):
        warmup = min(n_stages - s, n_microbatches)
        stream: list[tuple[str, int]] = [("F", m) for m in range(warmup)]
        nf, nb = warmup, 0
        while nb < n_microbatches:
            stream.append(("B", nb))
            nb += 1
            if nf < n_microbatches:
                stream.append(("F", nf))
                nf += 1
        streams.append(stream)
    return streams


def validate_execution_order(tdg: TDG, order: Sequence[int]) -> bool:
    """True iff ``order`` respects every edge (used by property tests)."""
    pos = {tid: i for i, tid in enumerate(order)}
    if len(pos) != tdg.num_tasks:
        return False
    return all(pos[e.src] < pos[e.dst] for e in tdg.edges)
