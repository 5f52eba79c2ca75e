"""Multi-tenant taskgraph region server, request level.

Port of the request-level (run-to-completion) dispatcher of
``repro.serving.server`` — the reference's ``RegionServer(continuous=False)``.
Clients submit requests against registered *tenants* (a named TDG plus its
pinned kernel mode) into an admission queue; one dispatcher thread owns
execution:

* **Coalescing.** Queued requests whose TDGs canonicalize to the same
  ``structure_signature`` (same payload identities, buffer signature and
  kernel mode) are batched into ONE replay: per-request buffers are
  stacked on a new leading axis and the canonical region function is
  ``torch.func.vmap``-ed across requests. Buffers that are the *same
  object* in every member (the shared params module) are broadcast, not
  stacked. A batch whose payloads refuse to vmap falls back to serial
  per-request replay for that batch only, counted in ``batch_fallbacks``.
* **Buckets.** A batch of K requests runs at the next power of two, padded
  with repeats of its last member (pad lanes are computed and dropped):
  the reference's static ladder, ``REPRO_ADAPTIVE=0`` there.
* **Interning.** Batched callables live in a :class:`WarmPool` keyed by
  structure, never by tenant name; single-request replay goes through
  ``core.lower``'s structural intern cache, so tenants 2..N reuse tenant
  1's entry (``intern_stats()`` counts the hits).
* **Isolation.** Each tenant's kernel mode is read once at registration
  and re-entered around every call, so a later global mode change cannot
  change what a registered tenant runs. ``"auto"`` stays ``"auto"``: the
  tensors' device picks the substrate, which is fixed for a given device.

Continuous (iteration-level) batching, QoS, deadlines, bounded queues and
AOT warm paths are not ported yet (ROADMAP.md, queue A item 7).
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, Mapping

import torch
from torch.utils import _pytree as pytree

from ..core import lower as _lower
from ..core.tdg import TDG, buffers_signature, structure_signature
from ..kernels import registry as _kreg
from .metrics import ServerMetrics
from .pool import PoolEntry, WarmPool


@dataclasses.dataclass
class Tenant:
    """One registered tenant: a region (TDG) plus its pinned kernel mode.

    ``sig``/``slot_map``/``payloads`` are the canonical structure computed
    once at registration.
    """

    name: str
    tdg: TDG
    outputs: tuple[str, ...] | None
    kernel_mode: str
    sig: tuple
    slot_map: dict[str, str]
    payloads: tuple
    requests: int = 0

    def __post_init__(self) -> None:
        self.payload_ids = tuple(id(p) for p in self.payloads)
        self.from_canon = {c: a for a, c in self.slot_map.items()}
        self.input_slots = tuple(s for s in self.tdg.input_slots if s in self.slot_map)
        self._fn: Callable[[dict], dict] | None = None
        self._fn_lock = threading.Lock()

    def replay_fn(self) -> Callable[[dict], dict]:
        """The single-request replay callable (built once), from the global
        structural intern cache shared with structurally identical tenants."""
        with self._fn_lock:
            if self._fn is None:
                # Interned, uncaptured and unfused: a served decode region is
                # one task, whose fused form is the unrolled one, and
                # capturing it as a CUDA graph (donated KV caches as static
                # buffers) waits for serving under graphs (ROADMAP item 8).
                with _kreg.kernel_mode_scope(self.kernel_mode):
                    self._fn = _lower.lower_tdg(
                        self.tdg, jit=False, intern=True, fuse=False,
                        outputs=list(self.outputs)
                        if self.outputs is not None else None)
            return self._fn


class _Request:
    __slots__ = ("tenant", "buffers", "canon_buffers", "key", "future", "t_submit")

    def __init__(self, tenant: Tenant, buffers: dict, canon_buffers: dict, key: tuple):
        self.tenant = tenant
        self.buffers = buffers
        self.canon_buffers = canon_buffers
        self.key = key
        self.future: Future = Future()
        self.t_submit = time.monotonic()


def bucket_for(occupancy: int) -> int:
    """The static pow-2 ladder: 1 for a lone request, else the next power of 2."""
    return 1 if occupancy <= 1 else 1 << (occupancy - 1).bit_length()


def _block_until_ready(results) -> None:
    """Wait for the devices that hold any CUDA tensor in ``results``."""
    devices = {leaf.device for leaf in pytree.tree_leaves(results)
               if isinstance(leaf, torch.Tensor) and leaf.is_cuda}
    for d in devices:
        torch.cuda.synchronize(d)


class RegionServer:
    """Admission-queued, batch-coalescing server over interned replay.

    ``max_batch`` caps how many structurally identical requests one replay
    carries (``1`` = serial replay); ``max_wait_ms`` is how long the
    dispatcher holds a batch open for companions after its first request.
    ``autostart=False`` lets a test enqueue a known set of requests before
    :meth:`start`. ``continuous=True`` is the reference's iteration-level
    scheduler, which this port does not have yet.
    """

    def __init__(self, max_batch: int = 8, max_wait_ms: float = 2.0,
                 pool_capacity: int = 64, name: str = "region-server",
                 autostart: bool = True, continuous: bool = False):
        if continuous:
            raise NotImplementedError(
                "continuous (iteration-level) batching is not ported yet: "
                "ROADMAP.md queue A, item 7 (single-process serving); use the "
                "request-level server (continuous=False)")
        self.name = name
        self.max_batch = max(1, int(max_batch))
        self.max_wait_s = max(0.0, float(max_wait_ms)) / 1e3
        self.pool = WarmPool(capacity=pool_capacity)
        self.metrics = ServerMetrics()
        self._tenants: dict[str, Tenant] = {}
        self._queue: collections.deque[_Request] = collections.deque()
        self._cv = threading.Condition()
        self._closed = False
        self._started = False
        self._thread = threading.Thread(target=self._dispatch_loop,
                                        name=f"{name}-dispatch", daemon=True)
        if autostart:
            self.start()

    # ------------------------------------------------------------ lifecycle
    def start(self) -> None:
        """Start the dispatcher thread (idempotent)."""
        if not self._started:
            self._started = True
            self._thread.start()

    def close(self) -> None:
        """Drain the admission queue, then stop the dispatcher (a never
        started server with queued work is started just to drain it)."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()
            pending = bool(self._queue)
        if not self._started and pending:
            self.start()
        if self._started:
            self._thread.join()

    def __enter__(self) -> "RegionServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------- tenants
    def register_tenant(self, name: str, tdg: TDG, *,
                        outputs: tuple[str, ...] | None = None,
                        kernel_mode: str | None = None) -> Tenant:
        """Register ``tdg`` as tenant ``name``, pinning the kernel mode."""
        tdg.validate()
        mode = (_kreg.kernel_mode() if kernel_mode is None
                else _kreg.validate_mode(kernel_mode))
        sig, slot_map, payloads = structure_signature(
            tdg, list(outputs) if outputs is not None else None)
        tenant = Tenant(name=name, tdg=tdg,
                        outputs=tuple(outputs) if outputs is not None else None,
                        kernel_mode=mode, sig=sig, slot_map=slot_map,
                        payloads=payloads)
        with self._cv:
            if name in self._tenants:
                raise ValueError(f"tenant {name!r} already registered")
            self._tenants[name] = tenant
        # Lowering is cheap here (nothing compiles), so it happens at
        # registration: tenant 1 misses the intern cache and every
        # structurally identical tenant after it hits, even when all their
        # requests later coalesce and never take the single-request path.
        tenant.replay_fn()
        return tenant

    def tenant(self, name: str) -> Tenant:
        with self._cv:
            if name not in self._tenants:
                raise KeyError(f"unknown tenant {name!r}; registered: "
                               f"{sorted(self._tenants)}")
            return self._tenants[name]

    # ------------------------------------------------------------ admission
    def submit(self, tenant_name: str, buffers: Mapping[str, Any]) -> Future:
        """Enqueue one request; the future resolves to the region's outputs."""
        tenant = self.tenant(tenant_name)
        missing = [s for s in tenant.input_slots if s not in buffers]
        if missing:
            raise KeyError(f"request for tenant {tenant_name!r} is missing "
                           f"input slots {missing}")
        buffers = dict(buffers)
        canon = {tenant.slot_map[k]: v for k, v in buffers.items()
                 if k in tenant.slot_map}
        key = (tenant.sig, tenant.payload_ids, buffers_signature(canon),
               tenant.kernel_mode)
        req = _Request(tenant, buffers, canon, key)
        with self._cv:
            if self._closed:
                raise RuntimeError(f"server {self.name!r} is closed")
            self._queue.append(req)
            tenant.requests += 1
            depth = len(self._queue)
            self._cv.notify_all()
        self.metrics.on_admit(depth)
        return req.future

    def serve(self, tenant_name: str, buffers: Mapping[str, Any],
              timeout: float | None = 60.0) -> dict:
        """Synchronous :meth:`submit`: blocks for this request's result."""
        return self.submit(tenant_name, buffers).result(timeout=timeout)

    def stats(self) -> dict:
        """Serving metrics + pool counters + the global intern counters."""
        with self._cv:
            tenants = {t.name: t.requests for t in self._tenants.values()}
        return {
            "server": self.name,
            "max_batch": self.max_batch,
            "tenants": tenants,
            "metrics": self.metrics.snapshot(),
            "pool": self.pool.stats(),
            "intern": _lower.intern_stats(),
        }

    # ------------------------------------------------------------- dispatch
    def _take_matching(self, group: list[_Request], key: tuple) -> None:
        """Move queued requests with ``key`` into ``group`` (up to max_batch)."""
        kept: collections.deque[_Request] = collections.deque()
        while self._queue:
            r = self._queue.popleft()
            if r.key == key and len(group) < self.max_batch:
                group.append(r)
            else:
                kept.append(r)
        self._queue.extend(kept)

    def _dispatch_loop(self) -> None:
        while True:
            with self._cv:
                while not self._queue and not self._closed:
                    self._cv.wait()
                if not self._queue:     # closed and drained
                    return
                head = self._queue.popleft()
                group = [head]
                if self.max_batch > 1:
                    deadline = time.monotonic() + self.max_wait_s
                    while len(group) < self.max_batch:
                        self._take_matching(group, head.key)
                        if len(group) >= self.max_batch or self._closed:
                            break
                        if self._queue:
                            # Everything still queued has another key: do not
                            # hold those back waiting for companions.
                            break
                        remaining = deadline - time.monotonic()
                        if remaining <= 0:
                            break
                        self._cv.wait(remaining)
                    self._take_matching(group, head.key)
            self._execute_group(group)

    # ------------------------------------------------------------- execution
    def _execute_group(self, group: list[_Request]) -> None:
        coalesced = False
        try:
            if len(group) == 1:
                # A lone request takes the interned single-request path.
                results = [self._run_single(group[0])]
            else:
                results, coalesced = self._run_batched(group)
            _block_until_ready([r for r in results if not isinstance(r, Exception)])
        except Exception as exc:
            now = time.monotonic()
            for r in group:
                self.metrics.on_done(now - r.t_submit, failed=True)
                r.future.set_exception(exc)
            return
        self.metrics.on_batch(len(group), coalesced=coalesced)
        now = time.monotonic()
        for r, out in zip(group, results):
            if isinstance(out, Exception):      # per-request fallback failure
                self.metrics.on_done(now - r.t_submit, failed=True)
                r.future.set_exception(out)
            else:
                self.metrics.on_done(now - r.t_submit)
                r.future.set_result(out)

    def _run_single(self, req: _Request) -> dict:
        fn = req.tenant.replay_fn()
        with torch.no_grad(), _kreg.kernel_mode_scope(req.tenant.kernel_mode):
            return fn(dict(req.buffers))

    def _run_batched(self, group: list[_Request]) -> tuple[list, bool]:
        """Serve a coalesced group; returns ``(results, coalesced)``, with
        ``coalesced`` True only when ONE batched call served the group."""
        try:
            return self._run_batched_fused(group), True
        except Exception:
            # A payload without a batching rule degrades THIS batch to serial
            # per-request replay; one member's failure stays its own.
            self.metrics.on_batch_fallback()
            results: list[dict | Exception] = []
            for r in group:
                try:
                    results.append(self._run_single(r))
                except Exception as exc:
                    results.append(exc)
            return results, False

    def _run_batched_fused(self, group: list[_Request]) -> list[dict]:
        tenant0 = group[0].tenant
        canon = [r.canon_buffers for r in group]
        slots = sorted(canon[0])
        shared = frozenset(s for s in slots
                           if all(cb[s] is canon[0][s] for cb in canon[1:]))
        varying = tuple(s for s in slots if s not in shared)
        shared_bufs = {s: canon[0][s] for s in shared}
        if not varying:
            # Every buffer is literally shared: one replay serves everyone.
            out0 = self._run_single(group[0])
            canon_out = {tenant0.slot_map[s]: v for s, v in out0.items()}
            return [{r.tenant.from_canon[c]: v for c, v in canon_out.items()}
                    for r in group]
        key = ("batched", tenant0.sig, tenant0.payload_ids, shared,
               tenant0.kernel_mode)
        entry = self.pool.get(key)
        if entry is None:
            entry = self.pool.put(key, PoolEntry(
                "batched", self._build_batched(tenant0), tenant0.payloads))
        per_req = [{s: cb[s] for s in varying} for cb in canon]
        pad = bucket_for(len(per_req)) - len(per_req)
        per_req.extend(per_req[-1:] * pad)
        self.metrics.on_pad(pad)
        with torch.no_grad(), _kreg.kernel_mode_scope(tenant0.kernel_mode):
            outs = entry.fn(tuple(per_req), shared_bufs)
        return [{r.tenant.from_canon[c]: v for c, v in out_j.items()}
                for r, out_j in zip(group, outs)]

    def _build_batched(self, tenant: Tenant) -> Callable[..., tuple]:
        """One cross-request batch callable on canonical slot names.

        ``fn(per_request, shared) -> tuple[dict, ...]``: stacks the request
        axis, ``torch.func.vmap``s the canonical region function over it
        with the shared buffers closed over (broadcast), and slices the
        outputs per member.
        """
        base = _lower.lower_tdg(tenant.tdg, jit=False, intern=False, fuse=False,
                                outputs=list(tenant.outputs)
                                if tenant.outputs is not None else None)
        from_canon, slot_map = tenant.from_canon, tenant.slot_map

        def canon_base(cbufs: dict) -> dict:
            out = base({from_canon[c]: v for c, v in cbufs.items()})
            return {slot_map[s]: v for s, v in out.items()}

        def batched(per_req: tuple, shared_bufs: dict) -> tuple:
            stacked = pytree.tree_map(lambda *xs: torch.stack(xs), *per_req)
            out = torch.func.vmap(lambda st: canon_base({**st, **shared_bufs}))(stacked)
            return tuple(pytree.tree_map(lambda v, _j=j: v[_j], out)
                         for j in range(len(per_req)))

        batched.__name__ = f"tdg_batched_{tenant.tdg.region}"
        return batched
