"""Warm-executable pool: the shared, LRU-bounded resource of the server.

Port of ``repro.serving.pool``. The pool holds

* the cross-request **batched** callables (one ``torch.func.vmap``-batched
  replay serving a whole admission batch, captured as CUDA graphs on the
  card), keyed by the TDG's canonical structure + payload identities +
  kernel mode — never by tenant name — so N tenants with structurally
  identical regions share one entry;
* **AOT** programs (``lower.AotExecutable``) hydrated from ``.aot``
  sidecars or shipped bytes, or exported by an explicit warmup. These are
  keyed per tenant: a program's input specs carry that tenant's slot names
  and buffer shapes.

Single-request replay callables live in ``core.lower``'s global structural
intern cache instead.

Entries pin their payload closures (strong refs): ``id()``-based keys are
only sound while the objects they name stay alive. An entry that leaves the
pool — evicted, invalidated or cleared — releases the CUDA graphs its
callable captured. Hit/miss/eviction counters are the serving layer's pool
hit rate.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
from typing import Any, Callable


@dataclasses.dataclass
class PoolEntry:
    """One warm callable: ``kind`` is ``"batched"`` or ``"aot"`` (an
    ``lower.AotExecutable``). ``payloads`` pins the task payload functions
    whose ``id()``s appear in the pool key."""

    kind: str
    fn: Callable[..., Any]
    payloads: tuple = ()
    hits: int = 0
    meta: dict = dataclasses.field(default_factory=dict)


def _release(entry: PoolEntry) -> None:
    """Free the graphs an entry's callable captured (``GraphReplay``)."""
    release = getattr(entry.fn, "release", None)
    if release is not None:
        release()


class WarmPool:
    """LRU-bounded map: executable key -> :class:`PoolEntry`."""

    def __init__(self, capacity: int = 64):
        self.capacity = max(1, capacity)
        self._lock = threading.Lock()
        self._entries: collections.OrderedDict[tuple, PoolEntry] = \
            collections.OrderedDict()
        self._counters = {"hits": 0, "misses": 0, "evictions": 0,
                          "hydrations": 0, "invalidations": 0}

    def get(self, key: tuple) -> PoolEntry | None:
        """Look up ``key``, counting a hit (and refreshing LRU) or a miss."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                self._counters["misses"] += 1
                return None
            self._counters["hits"] += 1
            entry.hits += 1
            self._entries.move_to_end(key)
            return entry

    def put(self, key: tuple, entry: PoolEntry, hydrated: bool = False) -> PoolEntry:
        """Install ``entry`` under ``key`` (first writer wins on a race) and
        return the stored entry; evicts least-recently-used entries beyond
        ``capacity``. ``hydrated=True`` counts an installed entry in
        ``hydrations`` (a program hydrated from a warm artifact)."""
        with self._lock:
            stored = self._entries.setdefault(key, entry)
            self._entries.move_to_end(key)
            if hydrated and stored is entry:
                self._counters["hydrations"] += 1
            evicted = []
            while len(self._entries) > self.capacity:
                evicted.append(self._entries.popitem(last=False)[1])
                self._counters["evictions"] += 1
        for old in evicted:
            _release(old)
        return stored

    def peek(self, key: tuple) -> PoolEntry | None:
        """Like :meth:`get` but without touching counters or LRU order."""
        with self._lock:
            return self._entries.get(key)

    def invalidate(self, predicate: Callable[[tuple, PoolEntry], bool]) -> int:
        """Drop (and release) every entry for which ``predicate(key, entry)``
        is true; returns the number removed, also counted in
        ``invalidations`` (distinct from capacity ``evictions``). The bucket
        tuner retires stale batched entries this way after a refit."""
        with self._lock:
            dead = [k for k, e in self._entries.items() if predicate(k, e)]
            gone = [self._entries.pop(k) for k in dead]
            self._counters["invalidations"] += len(dead)
        for entry in gone:
            _release(entry)
        return len(dead)

    def stats(self) -> dict:
        """Hit/miss/eviction/hydration/invalidation counters, the entry count, and
        ``hot``: kind + hits per live entry, hottest first (churn that
        re-slices the same pooled callable shows as a few hot entries, a
        churn-driven rebuild as many one-hit ones)."""
        with self._lock:
            hot = sorted(({"kind": e.kind, "hits": e.hits}
                          for e in self._entries.values()),
                         key=lambda r: -r["hits"])
            return {**self._counters, "entries": len(self._entries), "hot": hot}

    def entries(self) -> list[PoolEntry]:
        """The live entries, least recently used first."""
        with self._lock:
            return list(self._entries.values())

    def clear(self) -> None:
        """Drop (and release) every entry and zero the counters."""
        with self._lock:
            gone = list(self._entries.values())
            self._entries.clear()
            for k in self._counters:
                self._counters[k] = 0
        for entry in gone:
            _release(entry)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)
