"""Schedules over a TDG (the subset of ``repro.core.schedule`` replay needs).

Pure Python, copied from the reference: a deterministic topological order
and the wave decomposition (topological levels) that the replay lowering
walks, plus the order check the tests use.
"""
from __future__ import annotations

import heapq
from typing import Sequence

from .tdg import TDG


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


def validate_execution_order(tdg: TDG, order: Sequence[int]) -> bool:
    """True iff ``order`` respects every edge (used by property tests)."""
    pos = {tid: i for i, tid in enumerate(order)}
    if len(pos) != tdg.num_tasks:
        return False
    return all(pos[e.src] < pos[e.dst] for e in tdg.edges)
