"""Warm-executable pool: the shared, LRU-bounded resource of the server.

Port of ``repro.serving.pool``. The pool holds the cross-request batched
callables (one ``torch.func.vmap``-batched replay serving a whole admission
batch), keyed by the TDG's canonical structure + payload identities +
kernel mode — never by tenant name — so N tenants with structurally
identical regions share one entry. Single-request replay callables live in
``core.lower``'s global structural intern cache instead.

Entries pin their payload closures (strong refs): ``id()``-based keys are
only sound while the objects they name stay alive. Hit/miss/eviction
counters are the serving layer's pool hit rate.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
from typing import Any, Callable


@dataclasses.dataclass
class PoolEntry:
    """One warm callable. ``payloads`` pins the task payload functions whose
    ``id()``s appear in the pool key."""

    kind: str
    fn: Callable[..., Any]
    payloads: tuple = ()
    hits: int = 0


class WarmPool:
    """LRU-bounded map: executable key -> :class:`PoolEntry`."""

    def __init__(self, capacity: int = 64):
        self.capacity = max(1, capacity)
        self._lock = threading.Lock()
        self._entries: collections.OrderedDict[tuple, PoolEntry] = \
            collections.OrderedDict()
        self._counters = {"hits": 0, "misses": 0, "evictions": 0}

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

    def put(self, key: tuple, entry: PoolEntry) -> PoolEntry:
        """Install ``entry`` under ``key`` (first writer wins on a race) and
        return the stored entry; evicts least-recently-used entries beyond
        ``capacity``."""
        with self._lock:
            stored = self._entries.setdefault(key, entry)
            self._entries.move_to_end(key)
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
                self._counters["evictions"] += 1
            return stored

    def stats(self) -> dict:
        """Hit/miss/eviction counters + current entry count."""
        with self._lock:
            return {**self._counters, "entries": len(self._entries)}
