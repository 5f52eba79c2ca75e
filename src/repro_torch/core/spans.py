"""Spans: named intervals of the program's host work, on ``time.monotonic()``.

A span is one interval of one thread's work at a layer boundary (the
server's submission, scheduler and step; a graph replay's keying, copies
and launch; prefill). The program opens one with ``with span(name,
**args):``; ``args`` is a small dict of ints, short strings and lists of
ints (a request's ``rid``, a step's ``class_id``). Each record holds
``id``, ``parent`` (the innermost span open on the same thread when this
one opened: the span that caused it), ``name``, ``thread``, ``t0`` and
``t1`` (``time.monotonic()`` seconds, the clock of the serving trace ring)
and ``args`` (:data:`SPAN_SCHEMA`). Spans of one request share its
``rid``: ``submit.key`` carries it, and so does the ``step`` that served
it (``rids``).

**Off by default.** While off, :func:`span` returns the one shared
:data:`NOOP` context manager after testing a module flag and whether a
``torch.profiler`` session runs: it reads no clock and builds nothing.
Recording is on after :func:`enable` and, like ``record_function``, while
a ``torch.profiler`` session runs, so a profiled run carries the spans in
``snapshot()`` with no call; the records a session alone made stay
readable after it ends, until :func:`enable` or :func:`disable`. While
recording, a span also opens a ``record_function`` range of its own name
whenever a profiler runs, so it shows on its thread's row of the Chrome
trace beside the kernels it launched. After :func:`enable` (not under a
profiler alone), a ``gc.callbacks`` hook records each Python collection as
a ``python.gc`` span (``generation``, ``collected``). :func:`disable` stops
recording, drops the records and removes the hook.

The records sit in a bounded deque (oldest dropped first). Its appends
are atomic under the interpreter lock, so threads record without a lock
of their own, and the gc hook, which may run inside any allocation,
never waits on one.

Host spans around asynchronous CUDA work time the host's enqueue, not
the card: ``prefill`` and the ``replay.*`` spans end once their kernels
are queued. ``step.wait`` is where a served step blocks on the card. No
span is opened inside a captured region: a graph replays no host code.
"""
from __future__ import annotations

import collections
import gc
import itertools
import threading
import time

import torch.autograd.profiler as _profiler

#: Span record schema: field name -> accepted types.
SPAN_SCHEMA: dict = {
    "id": int,
    "parent": (int, type(None)),
    "name": str,
    "thread": str,
    "t0": float,
    "t1": float,
    "args": dict,
}

#: Records kept when :func:`enable` names no capacity, and under a profiler.
DEFAULT_CAPACITY = 1 << 15

_on = False                   # enable() was called
_ring: collections.deque | None = None
_ids = itertools.count(1)
_local = threading.local()    # .stack: ids of the spans open on this thread
_gc_open: tuple | None = None  # (t0, generation) of a collection under way
_gc_hooked = False
_make_lock = threading.Lock()  # makes the ring a profiler alone starts


class _Noop:
    """The span while recording is off: enters, exits and records nothing."""

    __slots__ = ()

    def __enter__(self) -> "_Noop":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def __bool__(self) -> bool:
        return False

    def set(self, **args) -> None:
        pass


NOOP = _Noop()


def _profiling() -> bool:
    return getattr(_profiler, "_is_profiler_enabled", False)


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _records() -> collections.deque | None:
    """The ring; made at the first record under a profiler alone, None once
    :func:`disable` ran with no profiler."""
    global _ring
    ring = _ring
    if ring is None and _profiling():
        with _make_lock:
            if _ring is None:
                _ring = collections.deque(maxlen=DEFAULT_CAPACITY)
            ring = _ring
    return ring


class Span:
    """One open span (made by :func:`span` while recording). Truthy, so a
    site can build costly ``args`` only when it will be recorded; ``set``
    adds to them, also after the span closed and before the record is read."""

    __slots__ = ("name", "args", "id", "parent", "t0", "_range")

    def __init__(self, name: str, args: dict):
        self.name = name
        self.args = args

    def set(self, **args) -> None:
        self.args.update(args)

    def __enter__(self) -> "Span":
        # The range opens first and closes last, outside the span: a
        # collection its allocations start belongs to the enclosing span.
        self._range = None
        if _profiling():
            self._range = _profiler.record_function(self.name)
            self._range.__enter__()
        stack = _stack()
        self.parent = stack[-1] if stack else None
        self.id = next(_ids)
        stack.append(self.id)
        self.t0 = time.monotonic()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.monotonic()
        _stack().pop()
        if self._range is not None:
            self._range.__exit__(None, None, None)
        ring = _records()
        if ring is not None:
            ring.append((self.id, self.parent, self.name, threading.current_thread().name,
                         self.t0, t1, self.args))
        return False


def span(name: str, **args):
    """A context manager timing ``name`` on this thread: a :class:`Span`
    while recording, else :data:`NOOP`."""
    if not _on and not _profiling():
        return NOOP
    return Span(name, args)


def _on_gc(phase: str, info: dict) -> None:
    global _gc_open
    ring = _ring
    if ring is None or not _on:
        _gc_open = None
        return
    if phase == "start":
        _gc_open = (time.monotonic(), info["generation"])
    elif _gc_open is not None:
        t0, generation = _gc_open
        _gc_open = None
        stack = _stack()
        ring.append((next(_ids), stack[-1] if stack else None, "python.gc",
                     threading.current_thread().name, t0, time.monotonic(),
                     {"generation": generation, "collected": info["collected"]}))


def enable(capacity: int = DEFAULT_CAPACITY) -> None:
    """Record spans and Python's collections, keeping the newest ``capacity``;
    earlier records are dropped."""
    global _on, _ring, _gc_hooked
    _ring = collections.deque(maxlen=max(1, int(capacity)))
    if not _gc_hooked:
        gc.callbacks.append(_on_gc)
        _gc_hooked = True
    _on = True


def disable() -> None:
    """Stop recording (unless a profiler runs), drop the records and remove
    the gc hook."""
    global _on, _ring, _gc_hooked, _gc_open
    _on = False
    _ring = None
    _gc_open = None
    if _gc_hooked:
        gc.callbacks.remove(_on_gc)
        _gc_hooked = False


def snapshot() -> list[dict]:
    """The kept records, oldest first, as :data:`SPAN_SCHEMA` dicts."""
    ring = _ring
    if ring is None:
        return []
    keys = tuple(SPAN_SCHEMA)
    return [dict(zip(keys, rec[:6] + (dict(rec[6]),))) for rec in ring.copy()]


def _arg_ok(v) -> bool:
    if isinstance(v, bool):
        return False
    if isinstance(v, (list, tuple)):
        return all(isinstance(x, int) and not isinstance(x, bool) for x in v)
    return isinstance(v, int) or (isinstance(v, str) and len(v) <= 128)


def validate_spans(records: list) -> None:
    """Raise ``ValueError`` unless every record matches :data:`SPAN_SCHEMA`
    exactly (no missing or extra field), ends no earlier than it starts and
    carries only ints, short strings and lists of ints in ``args``."""
    want = set(SPAN_SCHEMA)
    for i, rec in enumerate(records):
        if not isinstance(rec, dict):
            raise ValueError(f"spans[{i}]: not a dict: {type(rec).__name__}")
        if set(rec) != want:
            raise ValueError(f"spans[{i}]: fields {sorted(rec)} != schema {sorted(want)}")
        for field, types in SPAN_SCHEMA.items():
            if not isinstance(rec[field], types) or (
                    types is int and isinstance(rec[field], bool)):
                raise ValueError(f"spans[{i}].{field}: {type(rec[field]).__name__} "
                                 f"is not {types}")
        if rec["t1"] < rec["t0"]:
            raise ValueError(f"spans[{i}]: t1 {rec['t1']} before t0 {rec['t0']}")
        bad = {k: v for k, v in rec["args"].items() if not isinstance(k, str) or not _arg_ok(v)}
        if bad:
            raise ValueError(f"spans[{i}].args: not ints, short strings or int lists: {bad}")
