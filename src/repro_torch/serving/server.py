"""Multi-tenant taskgraph region server (port of ``repro.serving.server``).

Clients submit requests against registered *tenants* (a named TDG plus its
pinned kernel mode) into an admission queue; one scheduler thread owns
execution, as in the reference:

* **Continuous (iteration-level) batching**, the default. Each structure
  class owns a *resident batch* that tenants join and leave **between**
  batched replay steps: new requests are admitted at step boundaries into
  the occupancy buckets, finished members retire without draining their
  batch-mates, and membership churn re-slices the same pooled and interned
  callables. :meth:`RegionServer.submit_stream` keeps a member resident
  for several steps, each step's outputs overwriting its same-named input
  slots (the decode-carry idiom). ``continuous=False`` (or
  ``REPRO_CONTINUOUS=0``) is the request-level (run-to-completion)
  dispatcher.
* **Coalescing.** Requests whose TDGs canonicalize to the same
  ``structure_signature`` (same payload identities, buffer signature and
  kernel mode) are batched into ONE replay: per-request buffers are
  stacked on a new leading axis and the canonical region function is
  ``torch.func.vmap``-ed across requests. Buffers that are the *same
  object* in every member (the shared params module) are broadcast, not
  stacked. A batch whose payloads refuse to vmap falls back to serial
  per-request replay for that batch only, counted in ``batch_fallbacks``.
* **Served steps under CUDA graphs** (the counterpart of the reference's
  ``jit``): a single request replays its tenant's interned
  ``lower_tdg(jit=True)`` callable, and a coalesced batch replays the
  structure's batched callable wrapped in a ``GraphReplay``, so on the card
  every step is one graph replay, captured once per (structure, shared
  buffers, bucket). A failed capture fails the step's futures
  (``GraphCaptureError``): it is not a missing batching rule, so it is
  never answered by serial or uncaptured replay. ``capture=False`` lowers
  both uncaptured (the baseline that captured steps are held to).
* **Buckets.** A batch of K requests runs at the :class:`~repro_torch.core.
  costmodel.BucketTuner`'s bucket for K, padded with repeats of its last
  member; the tuner starts on the pow-2 ladder and refits it from the live
  occupancy histogram (``adaptive``; ``REPRO_TORCH_ADAPTIVE=0`` pins the
  ladder, as ``REPRO_ADAPTIVE=0`` does in the reference). A refit
  invalidates the pool's batched entries, whose graphs are released.
* **QoS admission.** Per-tenant token buckets (``rate=`` /
  ``REPRO_TENANT_RATE``) refuse over-rate submissions with
  :class:`RateLimited`; priority tiers (``tier=`` / ``REPRO_TENANT_TIER``)
  drive smooth weighted round-robin admission at step boundaries (weight
  ``2**tier``); a bounded queue (``queue_bound`` / ``REPRO_QUEUE_BOUND``)
  refuses with :class:`QueueFull`, and at the bound a higher-tier arrival
  evicts the newest lowest-tier waiter instead. Deadlines shed requests
  still unexecuted when they pass (:class:`DeadlineExceeded`).
* **Interning and isolation.** Batched callables live in a
  :class:`WarmPool` keyed by structure, never by tenant name; single
  requests go through ``core.lower``'s structural intern cache. Each
  tenant's kernel mode is read once at registration and re-entered around
  every call.
* **Warm artifacts.** A tenant registered with ``warm_path`` re-links its
  TDG JSON through a ``TaskFnRegistry`` and hydrates the exported replay
  program of its ``.aot`` sidecar (``serialize.load_warm``) into the pool;
  :meth:`RegionServer.warmup` exports one, :meth:`RegionServer.install_aot`
  plants one hydrated elsewhere (the cluster tier's shipped bytes). A single
  request whose buffers match the program's specs is served by it
  (``aot_served``); a sidecar that cannot be hydrated is counted
  (``aot_hydrate_failures``) and the tenant is lowered instead.
* **Replay mesh** (``mesh=``, resolved once at construction: a
  ``ReplayMesh``, ``None``, or ``"auto"`` = a ``use_mesh`` scope, then
  ``REPRO_MESH``). A coalesced batch's bucket rounds up to a multiple of
  the mesh's batch axis, and its request axis splits into one contiguous
  chunk a shard: each shard runs the unsharded batched step over its
  requests on its device (one graph a shard device), and the outputs come
  back to the caller's device. Single requests lower their region under
  the mesh (``lower_tdg(mesh=...)``). The mesh's fingerprint keys the
  pool's batched and AOT entries and is checked against a warm artifact's
  (``stats()["mesh"]``).
* **Keys.** A request's coalescing key (its tenant's structure, payload
  identities and kernel mode, and its buffers' signature) is memoised and
  interned (``core.tdg.keyed_signature``, ``intern_key``): a decode step
  keys its params module and cache tree without walking them, and equal
  keys are one object, so the scheduler's comparisons and class lookups
  resolve by identity. ``stats()["keys"]`` counts hits and misses.
* **Metrics**: queue depth, occupancy, pool hit rate, p50/p99 latency
  overall and per tier, and a per-step trace ring (:meth:`dump_trace`).
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
import os
import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, Mapping

import torch
from torch.utils import _pytree as pytree

from ..core import costmodel as _costmodel
from ..core import lower as _lower
from ..core import serialize as _serialize
from ..core import spans as _spans
from ..core.spans import span
from ..core.tdg import (TDG, KeyCounts, intern_key, interned_count, keyed_signature,
                        structure_signature)
from ..kernels import registry as _kreg
from ..sharding import replay as _shreplay
from .metrics import ServerMetrics
from .pool import PoolEntry, WarmPool
from .qos import (SmoothWRR, TokenBucket, tenant_rate_default, tenant_tier_default,
                  tier_weight)

#: Admission-queue bound (requests); unset or ``0`` = unbounded.
QUEUE_BOUND_ENV = "REPRO_QUEUE_BOUND"

#: Scheduler selector: unset/``1`` = continuous batching;
#: ``0``/``false``/``off``/``no`` = the request-level dispatcher.
CONTINUOUS_ENV = "REPRO_CONTINUOUS"


class QueueFull(RuntimeError):
    """Admission refused: the server's bounded queue is at capacity (the
    load-shedding signal; the submitter should back off)."""


class DeadlineExceeded(RuntimeError):
    """The request's deadline passed before it was executed; it was shed
    unexecuted (``deadline_sheds``)."""


class RateLimited(RuntimeError):
    """Admission refused: this tenant's token bucket is dry
    (``register_tenant(rate=...)`` / ``REPRO_TENANT_RATE``); its neighbours
    are unaffected."""


def queue_bound_default() -> int:
    """The env-configured admission bound (0 = unbounded)."""
    raw = os.environ.get(QUEUE_BOUND_ENV, "").strip()
    return max(0, int(raw)) if raw else 0


def continuous_default() -> bool:
    """Env-configured scheduler choice (default: continuous batching on)."""
    raw = os.environ.get(CONTINUOUS_ENV, "").strip().lower()
    return raw not in ("0", "false", "off", "no")


@dataclasses.dataclass
class Tenant:
    """One registered tenant: a region (TDG) plus its pinned kernel mode.

    ``sig``/``slot_map``/``payloads`` are the canonical structure computed
    once at registration. ``tier`` is the QoS priority (higher = more
    admission weight at step boundaries, sheds last under pressure);
    ``rate`` > 0 arms a per-tenant token bucket.
    """

    name: str
    tdg: TDG
    outputs: tuple[str, ...] | None
    kernel_mode: str
    sig: tuple
    slot_map: dict[str, str]
    payloads: tuple
    warm_path: str | None = None
    fuse: bool | str = "auto"
    capture: bool = True
    #: The server's resolved replay mesh (or None), pinned at registration.
    mesh: Any = None
    aot_key: tuple | None = None
    requests: int = 0
    tier: int = 0
    rate: float = 0.0

    def __post_init__(self) -> None:
        self.payload_ids = tuple(id(p) for p in self.payloads)
        self.from_canon = {c: a for a, c in self.slot_map.items()}
        self.input_slots = tuple(s for s in self.tdg.input_slots if s in self.slot_map)
        self.bucket = TokenBucket(self.rate) if self.rate > 0 else None
        self._fn: Callable[[dict], dict] | None = None
        self._fn_lock = threading.Lock()

    def replay_fn(self) -> Callable[[dict], dict]:
        """The single-request replay callable (built once), from the global
        structural intern cache shared with structurally identical tenants:
        captured as a CUDA graph on the card (``jit=True``, as the
        reference's jitted replay) unless the server says ``capture=False``."""
        with self._fn_lock:
            if self._fn is None:
                with _kreg.kernel_mode_scope(self.kernel_mode):
                    self._fn = _lower.lower_tdg(
                        self.tdg, jit=self.capture, intern=True, fuse=self.fuse,
                        mesh=self.mesh,
                        outputs=list(self.outputs) if self.outputs is not None else None)
            return self._fn


class _Request:
    """One admitted unit of work — and, continuously, one batch *member*
    (a request with ``steps > 1`` is a resident stream whose future resolves
    with the FINAL step's outputs)."""

    __slots__ = ("rid", "tenant", "buffers", "canon_buffers", "key", "future",
                 "t_submit", "served_aot", "deadline", "steps", "steps_done")

    def __init__(self, rid: int, tenant: Tenant, buffers: dict, canon_buffers: dict,
                 key: tuple, deadline: float | None = None, steps: int = 1):
        self.rid = rid                 # the server's request id, in its spans' args
        self.tenant = tenant
        self.buffers = buffers
        self.canon_buffers = canon_buffers
        self.key = key
        self.future: Future = Future()
        self.t_submit = time.monotonic()
        self.served_aot = False
        self.deadline = deadline       # absolute time.monotonic(), or None
        self.steps = steps
        self.steps_done = 0


class _ClassState:
    """Continuous-scheduler state for one coalescing key (structure class):
    ``resident`` is the live batch stepped as one replay, ``pending`` holds
    admitted members waiting for a step boundary."""

    __slots__ = ("key", "cid", "resident", "pending", "step", "wrr")

    def __init__(self, key: tuple, cid: int):
        self.key = key
        self.cid = cid
        self.resident: list[_Request] = []
        self.pending: list[_Request] = []
        self.step = 0
        self.wrr = SmoothWRR()         # tier selector for admission slots

    def busy(self) -> bool:
        return bool(self.resident or self.pending)


def _block_until_ready(results) -> None:
    """Wait for the devices that hold any CUDA tensor in ``results``."""
    devices = {leaf.device for leaf in pytree.tree_leaves(results)
               if isinstance(leaf, torch.Tensor) and leaf.is_cuda}
    for d in devices:
        torch.cuda.synchronize(d)


class RegionServer:
    """Admission-queued, batch-coalescing server over interned, captured replay.

    ``max_batch`` caps how many structurally identical requests one replay
    carries (``1`` = serial replay); ``max_wait_ms`` is how long the
    scheduler holds a batch open for companions after its first request
    (continuously: only for a class's first step with the server idle).
    ``queue_bound`` (``None`` honours ``REPRO_QUEUE_BOUND``; 0 = unbounded)
    bounds waiting requests. ``fuse`` is handed to every lowering.
    ``autostart=False`` lets a test enqueue a known set of requests before
    :meth:`start`. ``continuous`` (``None`` honours ``REPRO_CONTINUOUS``,
    default on) selects iteration-level batching; ``adaptive`` the bucket
    tuner's refits (``"auto"`` honours ``REPRO_TORCH_ADAPTIVE``).
    ``capture=False`` lowers served steps uncaptured (the port's own
    option: the baseline captured steps are compared with). ``device`` is
    where warm artifacts are hydrated and checked against (``None``: the
    card when there is one, else the CPU, as ``serialize.local_device`` says:
    an in-process convenience; a ``WorkerNode`` always passes the device it
    resolved, which raises without a card). Served steps run where their
    tensors are.
    """

    def __init__(self, max_batch: int = 8, max_wait_ms: float = 2.0,
                 pool_capacity: int = 64, fuse: bool | str = "auto",
                 name: str = "region-server", autostart: bool = True,
                 queue_bound: int | None = None,
                 continuous: bool | None = None,
                 adaptive: bool | str = "auto",
                 capture: bool = True,
                 device: str | torch.device | None = None,
                 mesh: Any = "auto"):
        self.name = name
        self.device = _serialize.local_device(device)
        self.max_batch = max(1, int(max_batch))
        self.max_wait_s = max(0.0, float(max_wait_ms)) / 1e3
        self.queue_bound = (queue_bound_default() if queue_bound is None
                            else max(0, int(queue_bound)))
        self.continuous = continuous_default() if continuous is None else bool(continuous)
        self.fuse = fuse
        self.capture = bool(capture)
        self.adaptive = _costmodel.adaptive_enabled(adaptive)
        self.buckets = _costmodel.BucketTuner(self.max_batch, adaptive=self.adaptive)
        # Resolved once: every lowering this server makes (single request,
        # batched, warmup export) runs under it, and its fingerprint keys
        # the pool so single-device and N-device entries never collide.
        self.mesh = _shreplay.resolve_mesh(mesh)
        self.mesh_fp = _shreplay.mesh_fingerprint(self.mesh)
        self.pool = WarmPool(capacity=pool_capacity)
        self.metrics = ServerMetrics()
        self._tenants: dict[str, Tenant] = {}
        self._queue: collections.deque[_Request] = collections.deque()
        self._rids = itertools.count(1)
        self._cv = threading.Condition()
        self._closed = False
        self._started = False
        self._batched_replays: list = []  # every batched GraphReplay built
        self._keys = KeyCounts()          # submissions' and settles' key lookups
        # Continuous-scheduler state (unused by the request-level dispatcher).
        self._classes: dict[tuple, _ClassState] = {}
        self._next_cid = 0
        self._pending_count = 0        # members parked in class pendings
        self._class_wrr = SmoothWRR()  # which class steps next
        self._thread = threading.Thread(
            target=self._scheduler_loop if self.continuous else self._dispatch_loop,
            name=f"{name}-dispatch", daemon=True)
        if autostart:
            self.start()

    # ------------------------------------------------------------ lifecycle
    def start(self) -> None:
        """Start the scheduler thread (idempotent)."""
        if not self._started:
            self._started = True
            self._thread.start()

    def close(self) -> None:
        """Drain the admission queue, stop the scheduler, then release every
        CUDA graph the server's steps captured (a never started server with
        queued work is started just to drain it). Entries and counters stay
        for :meth:`stats`; a released callable captures again if called."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()
            pending = bool(self._queue) or self._pending_count > 0
        if not self._started and pending:
            self.start()
        if self._started:
            self._thread.join()
        for replay in self._graph_replays():
            replay.release()

    def __enter__(self) -> "RegionServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------- tenants
    def register_tenant(self, name: str, tdg: TDG | None = None, *,
                        outputs: tuple[str, ...] | None = None,
                        kernel_mode: str | None = None,
                        warm_path: str | None = None,
                        fn_registry: "_serialize.TaskFnRegistry | None" = None,
                        tier: int | None = None,
                        rate: float | None = None,
                        aot: "_lower.AotExecutable | None" = None) -> Tenant:
        """Register a tenant by TDG, or hydrate one from a warm artifact.

        Exactly one of ``tdg`` / ``warm_path`` selects the region source:
        ``warm_path`` names a TDG JSON written by ``serialize.warmup_and_save``
        (payloads re-linked through ``fn_registry``); if its ``.aot`` sidecar
        hydrates here, the program is installed in the warm pool, so this
        tenant's first single request replays it with no lowering. A sidecar
        that is present but cannot be hydrated is counted in
        ``aot_hydrate_failures`` and the tenant is lowered as usual: hydration
        is an optimization, never a correctness dependency. ``aot`` installs
        a program hydrated by the caller (the cluster worker's shipped bytes)
        the same way. A tenant without a program is lowered here (cheap:
        nothing is captured until a call), so tenant 1 misses the intern cache
        and every structurally identical tenant after it hits.

        ``tier`` (QoS priority) and ``rate`` (sustained req/s through a
        token bucket; 0 = unlimited) default to the ``REPRO_TENANT_TIER`` /
        ``REPRO_TENANT_RATE`` specs.
        """
        if (tdg is None) == (warm_path is None):
            raise ValueError("pass exactly one of tdg= or warm_path=")
        sidecar_present = False
        if warm_path is not None:
            if fn_registry is None:
                raise ValueError("warm_path= requires fn_registry= to re-link task payloads")
            sidecar_present = os.path.exists(str(warm_path) + ".aot")
            tdg, loaded = _serialize.load_warm(warm_path, fn_registry, device=self.device,
                                               mesh=self.mesh_fp)
            aot = aot or loaded
        tdg.validate()
        mode = (_kreg.kernel_mode() if kernel_mode is None
                else _kreg.validate_mode(kernel_mode))
        sig, slot_map, payloads = structure_signature(
            tdg, list(outputs) if outputs is not None else None)
        tenant = Tenant(name=name, tdg=tdg,
                        outputs=tuple(outputs) if outputs is not None else None,
                        kernel_mode=mode, sig=intern_key(sig)[0], slot_map=slot_map,
                        payloads=payloads, warm_path=warm_path, fuse=self.fuse,
                        capture=self.capture, mesh=self.mesh,
                        tier=tenant_tier_default(name) if tier is None else max(0, int(tier)),
                        rate=(tenant_rate_default(name) if rate is None
                              else max(0.0, float(rate))))
        with self._cv:
            if name in self._tenants:
                raise ValueError(f"tenant {name!r} already registered")
            self._tenants[name] = tenant
        if aot is not None:
            self._install_aot(tenant, aot, hydrated=True)
            return tenant
        if sidecar_present:
            self.metrics.on_aot_hydrate_failure()
        tenant.replay_fn()
        return tenant

    def tenant(self, name: str) -> Tenant:
        with self._cv:
            if name not in self._tenants:
                raise KeyError(f"unknown tenant {name!r}; registered: "
                               f"{sorted(self._tenants)}")
            return self._tenants[name]

    def warmup(self, name: str, buffers: Mapping[str, Any]) -> dict:
        """Export a tenant's replay program for ``buffers``' specs into the pool.

        ``buffers`` are real tensors on the device the program is for.
        Returns the report (cost analysis, trace / compile seconds).
        """
        tenant = self.tenant(name)
        with _kreg.kernel_mode_scope(tenant.kernel_mode):
            aot = _lower.aot_compile_tdg(
                tenant.tdg, buffers, fuse=tenant.fuse, mesh=tenant.mesh,
                outputs=list(tenant.outputs) if tenant.outputs is not None else None)
        self._install_aot(tenant, aot)
        return {"tenant": name, "fused": aot.fused, "cost_analysis": aot.cost_analysis,
                "trace_seconds": aot.trace_seconds, "compile_seconds": aot.compile_seconds}

    def install_aot(self, name: str, aot: "_lower.AotExecutable",
                    hydrated: bool = False) -> None:
        """Install a program produced elsewhere for tenant ``name`` (the
        cluster worker's hydrated shipped bytes); ``hydrated=True`` counts it
        in the pool's ``hydrations``."""
        self._install_aot(self.tenant(name), aot, hydrated=hydrated)

    def _install_aot(self, tenant: Tenant, aot: "_lower.AotExecutable",
                     hydrated: bool = False) -> None:
        key = ("aot", tenant.name, aot.signature, tenant.kernel_mode, self.mesh_fp)
        self.pool.put(key, PoolEntry("aot", aot, tenant.payloads), hydrated=hydrated)
        tenant.aot_key = key

    def _aot_for(self, req: _Request) -> "_lower.AotExecutable | None":
        """The tenant's program, iff this request's buffers match its specs.

        A program the pool evicted is hydrated again from the tenant's
        ``warm_path`` sidecar when there is one (counted in
        ``aot_hydrate_failures`` when that fails, and then not retried)."""
        tenant = req.tenant
        if tenant.aot_key is None:
            return None
        entry = self.pool.get(tenant.aot_key)
        if entry is not None:
            return entry.fn if entry.fn.matches(req.buffers) else None
        if tenant.warm_path is not None:
            try:
                aot = _serialize.load_executable(str(tenant.warm_path) + ".aot",
                                                 device=self.device, mesh=self.mesh_fp)
            except Exception:
                tenant.aot_key = None       # unrecoverable: stop retrying
                self.metrics.on_aot_hydrate_failure()
                return None
            self._install_aot(tenant, aot, hydrated=True)
            return aot if aot.matches(req.buffers) else None
        tenant.aot_key = None
        return None

    # ------------------------------------------------------------ admission
    def _make_request(self, tenant_name: str, buffers: Mapping[str, Any],
                      deadline: float | None = None, steps: int = 1) -> _Request:
        """Validate + canonicalize one submission into a queue entry."""
        tenant = self.tenant(tenant_name)
        missing = [s for s in tenant.input_slots if s not in buffers]
        if missing:
            raise KeyError(f"request for tenant {tenant_name!r} is missing "
                           f"input slots {missing}")
        rid = next(self._rids)
        with span("submit.key", rid=rid) as keying:
            buffers = dict(buffers)
            canon = {tenant.slot_map[k]: v for k, v in buffers.items()
                     if k in tenant.slot_map}
            key, hit = self._key(tenant, canon)
            keying.set(hit=int(hit))
        return _Request(rid, tenant, buffers, canon, key, deadline=deadline, steps=steps)

    def _key(self, tenant: Tenant, canon: dict) -> tuple[tuple, bool]:
        """The interned coalescing key of a member's canonical buffers, and
        whether its signature and key were memoised (counted in ``keys``)."""
        sig, hit = keyed_signature(canon)
        key, known = intern_key((tenant.sig, tenant.payload_ids, sig, tenant.kernel_mode))
        hit = hit and known
        self._keys.count(hit)
        return key, hit

    def _waiting_locked(self) -> int:
        """Admitted-but-not-resident requests: the raw queue plus the class
        pendings (the bounded-queue population)."""
        return len(self._queue) + self._pending_count

    def _evict_lower_tier_locked(self, tier: int) -> _Request | None:
        """Pop the newest waiting request of the lowest tier below ``tier``
        (newest first within the victim tier, so the longest-waiting one
        keeps its claim on the next slot)."""
        victim_tier = tier
        place: tuple | None = None
        for i in range(len(self._queue) - 1, -1, -1):
            if self._queue[i].tenant.tier < victim_tier:
                victim_tier = self._queue[i].tenant.tier
                place = (None, i)
        for cls in self._classes.values():
            for i in range(len(cls.pending) - 1, -1, -1):
                if cls.pending[i].tenant.tier < victim_tier:
                    victim_tier = cls.pending[i].tenant.tier
                    place = (cls, i)
        if place is None:
            return None
        cls, i = place
        if cls is None:
            victim = self._queue[i]
            del self._queue[i]
        else:
            victim = cls.pending.pop(i)
            self._pending_count -= 1
        return victim

    def _admit(self, req: _Request) -> int:
        """Admission control for one request (closed / rate / bound checks);
        returns the queue depth. Raises :class:`RateLimited` /
        :class:`QueueFull`; an evicted victim's future fails outside the lock."""
        tenant = req.tenant
        with self._cv:
            if self._closed:
                raise RuntimeError(f"server {self.name!r} is closed")
            if tenant.bucket is not None and not tenant.bucket.take():
                self.metrics.on_rate_limited()
                raise RateLimited(f"tenant {tenant.name!r} exceeded its rate limit "
                                  f"({tenant.rate:g} req/s); request refused")
            victim = None
            if self.queue_bound and self._waiting_locked() >= self.queue_bound:
                victim = self._evict_lower_tier_locked(tenant.tier)
                if victim is None:
                    self.metrics.on_shed()
                    raise QueueFull(f"server {self.name!r} admission queue is at its "
                                    f"bound ({self.queue_bound}); request shed")
            self._queue.append(req)
            tenant.requests += 1
            depth = self._waiting_locked()
            self._cv.notify_all()
        if victim is not None:
            self.metrics.on_shed()
            victim.future.set_exception(QueueFull(
                f"server {self.name!r} admission queue is at its bound "
                f"({self.queue_bound}); shed for a tier-{tenant.tier} arrival"))
        return depth

    def submit(self, tenant_name: str, buffers: Mapping[str, Any],
               deadline: float | None = None) -> Future:
        """Enqueue one request; the future resolves to the region's outputs.

        ``deadline`` is an absolute ``time.monotonic()`` instant (or
        ``None``): a request still unexecuted when it passes is shed with
        :class:`DeadlineExceeded`. Raises :class:`QueueFull` at the queue
        bound (unless a lower-tier waiter can be shed instead) and
        :class:`RateLimited` when the tenant's token bucket is dry.
        """
        req = self._make_request(tenant_name, buffers, deadline=deadline)
        self.metrics.on_admit(self._admit(req))
        return req.future

    def submit_stream(self, tenant_name: str, buffers: Mapping[str, Any],
                      steps: int, deadline: float | None = None) -> Future:
        """Enqueue a ``steps``-step resident stream (continuous mode only).

        The member joins its class's resident batch at a step boundary and
        stays for ``steps`` replay steps; between steps, outputs overwrite
        same-named input slots, server-side. The future resolves with the
        FINAL step's outputs.
        """
        if not self.continuous:
            raise RuntimeError("submit_stream requires continuous batching "
                               "(RegionServer(continuous=True) / REPRO_CONTINUOUS=1)")
        if int(steps) < 1:
            raise ValueError(f"steps must be >= 1, got {steps}")
        req = self._make_request(tenant_name, buffers, deadline=deadline, steps=int(steps))
        self.metrics.on_admit(self._admit(req))
        return req.future

    def submit_many(self, items: list[tuple]) -> list[Future]:
        """Admit a whole batch frame under ONE queue-lock acquisition.

        ``items`` entries are ``(tenant_name, buffers)`` or ``(tenant_name,
        buffers, deadline)``; the returned futures align with them. A bad
        entry (unknown tenant, missing slots), one over the queue bound or
        the tenant's rate, or one whose deadline has already passed comes
        back as a pre-failed future without rejecting its neighbours.
        """
        results: list[Future] = []
        admitted: list[_Request] = []
        now = time.monotonic()
        n_expired = 0
        for item in items:
            tenant_name, buffers = item[0], item[1]
            deadline = item[2] if len(item) > 2 else None
            if deadline is not None and deadline <= now:
                fut: Future = Future()
                fut.set_exception(DeadlineExceeded(
                    f"deadline passed before admission for tenant {tenant_name!r}"))
                results.append(fut)
                n_expired += 1
                continue
            try:
                req = self._make_request(tenant_name, buffers, deadline=deadline)
            except Exception as exc:
                fut = Future()
                fut.set_exception(exc)
                results.append(fut)
                continue
            admitted.append(req)
            results.append(req.future)
        if n_expired:
            self.metrics.on_deadline_shed(n_expired)
        if not admitted:
            return results
        overflow: list[_Request] = []
        limited: list[_Request] = []
        victims: list[_Request] = []
        n_in = 0
        with self._cv:
            if self._closed:
                err = RuntimeError(f"server {self.name!r} is closed")
                for req in admitted:
                    req.future.set_exception(err)
                return results
            for req in admitted:
                tenant = req.tenant
                if tenant.bucket is not None and not tenant.bucket.take():
                    limited.append(req)
                    continue
                if self.queue_bound and self._waiting_locked() >= self.queue_bound:
                    victim = self._evict_lower_tier_locked(tenant.tier)
                    if victim is None:
                        overflow.append(req)
                        continue
                    victims.append(victim)
                self._queue.append(req)
                tenant.requests += 1
                n_in += 1
            depth = self._waiting_locked()
            self._cv.notify_all()
        for req in limited:
            req.future.set_exception(RateLimited(
                f"tenant {req.tenant.name!r} exceeded its rate limit "
                f"({req.tenant.rate:g} req/s); request refused"))
        if limited:
            self.metrics.on_rate_limited(len(limited))
        for req in overflow + victims:
            req.future.set_exception(QueueFull(
                f"server {self.name!r} admission queue is at its bound "
                f"({self.queue_bound}); request shed"))
        if overflow or victims:
            self.metrics.on_shed(len(overflow) + len(victims))
        if n_in:
            self.metrics.on_admit_many(n_in, depth)
        return results

    def serve(self, tenant_name: str, buffers: Mapping[str, Any],
              timeout: float | None = 60.0) -> dict:
        """Synchronous :meth:`submit`: blocks for this request's result."""
        return self.submit(tenant_name, buffers).result(timeout=timeout)

    def _graph_replays(self) -> list:
        """The ``GraphReplay`` objects this server's steps run through: its
        tenants' interned single-request ones, every batched one built and
        those of the pool's AOT programs."""
        with self._cv:
            tenants = list(self._tenants.values())
        found = {id(r): r for r in self._batched_replays}
        for entry in self.pool.entries():
            if entry.kind == "aot":
                found[id(entry.fn.replay)] = entry.fn.replay
        for t in tenants:
            replay = getattr(t._fn, "graph_replay", None)
            if replay is not None:
                found[id(replay)] = replay
        return list(found.values())

    def stats(self) -> dict:
        """Serving metrics, pool counters, the bucket tuner, the global intern
        counters, the CUDA graphs behind the served steps (captures, the
        host time of their warm-ups and captures, graphs held now), and the
        keys: hits and misses of this server's key lookups (submissions,
        settles, its graph replays) and the canonical keys the process holds."""
        with self._cv:
            tenants = {t.name: t.requests for t in self._tenants.values()}
        replays = self._graph_replays()
        keyed = [self._keys] + [r.keys for r in replays]
        return {
            "server": self.name,
            "max_batch": self.max_batch,
            "queue_bound": self.queue_bound,
            "continuous": self.continuous,
            "adaptive": self.adaptive,
            "mesh": self.mesh_fp,
            "tenants": tenants,
            "metrics": self.metrics.snapshot(),
            "pool": self.pool.stats(),
            "buckets": self.buckets.summary(),
            "intern": _lower.intern_stats(),
            "graphs": {"captures": sum(r.captures for r in replays),
                       "capture_ms": 1e3 * sum(r.capture_seconds for r in replays),
                       "held": sum(len(r) for r in replays),
                       "evictions": sum(r.evictions for r in replays)},
            "keys": {"hits": sum(k.hits for k in keyed),
                     "misses": sum(k.misses for k in keyed),
                     "entries": interned_count()},
        }

    def dump_trace(self, path: str) -> dict:
        """Write the execution-pattern trace ring to ``path`` as JSON, with
        the process's span records beside it (``spans``, checked against
        ``span_schema``; empty while spans are off). A ``step`` span joins
        its ring record by (``class_id``, ``step``)."""
        records = _spans.snapshot()
        _spans.validate_spans(records)
        return self.metrics.trace.dump(path, meta={
            "server": self.name, "span_schema": sorted(_spans.SPAN_SCHEMA), "spans": records})

    # ------------------------------------------------- request-level dispatch
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

    def _execute_group(self, group: list[_Request]) -> None:
        # Members whose deadline already passed are shed before a replay is
        # spent on them.
        now = time.monotonic()
        expired = [r for r in group if r.deadline is not None and r.deadline <= now]
        if expired:
            group = [r for r in group if r not in expired]
            self.metrics.on_deadline_shed(len(expired))
            for r in expired:
                self.metrics.on_done(now - r.t_submit, failed=True)
                r.future.set_exception(DeadlineExceeded(
                    f"deadline passed while queued for tenant {r.tenant.name!r}"))
            if not group:
                return
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
                self.metrics.on_done(now - r.t_submit, aot=r.served_aot)
                r.future.set_result(out)

    # ------------------------------------------- continuous (iteration-level)
    def _drain_queue_locked(self) -> None:
        """Park every queued request in its structure class's pending list."""
        while self._queue:
            req = self._queue.popleft()
            cls = self._classes.get(req.key)
            if cls is None:
                cls = self._classes[req.key] = _ClassState(req.key, self._next_cid)
                self._next_cid += 1
            cls.pending.append(req)
            self._pending_count += 1

    def _pick_class_locked(self) -> _ClassState | None:
        """Smooth WRR over busy classes, weighted by their best member tier
        (a class hosting a tier-1 member gets ~2x the step slots)."""
        weights: dict[tuple, int] = {}
        for key, cls in self._classes.items():
            if not cls.busy():
                continue
            w = 1
            for r in cls.resident:
                w = max(w, tier_weight(r.tenant.tier))
            for r in cls.pending:
                w = max(w, tier_weight(r.tenant.tier))
            weights[key] = w
        key = self._class_wrr.pick(weights)
        return None if key is None else self._classes[key]

    def _want_window_locked(self, cls: _ClassState) -> bool:
        """Hold a coalescing window open for this class's first step? Only
        when the batch would otherwise start below max_batch with the whole
        server idle: a resident batch never waits, and a busy server never
        holds one class for companions of another."""
        if self.max_batch <= 1 or self.max_wait_s <= 0 or self._closed:
            return False
        if cls.resident or len(cls.pending) >= self.max_batch:
            return False
        if self._queue:
            return False
        return not any(other is not cls and other.busy()
                       for other in self._classes.values())

    def _shed_expired_locked(self, cls: _ClassState) -> list:
        """Pop members (resident or pending) whose deadline has passed."""
        now = time.monotonic()
        expired = []
        for lst in (cls.resident, cls.pending):
            for r in lst[:]:
                if r.deadline is not None and r.deadline <= now:
                    lst.remove(r)
                    if lst is cls.pending:
                        self._pending_count -= 1
                    expired.append(r)
        return expired

    def _admit_members_locked(self, cls: _ClassState) -> int:
        """Fill free resident slots from pending at a step boundary: the
        class's smooth WRR picks which tier supplies each slot (weight
        ``2**tier``), FIFO within a tier. With ``autostart=False`` the first
        step's membership is a pure function of what was submitted."""
        joins = 0
        while cls.pending and len(cls.resident) < self.max_batch:
            tiers: dict[int, int] = {}
            for r in cls.pending:
                tiers[r.tenant.tier] = tiers.get(r.tenant.tier, 0) + 1
            pick = cls.wrr.pick({t: tier_weight(t) for t in tiers})
            for i, r in enumerate(cls.pending):
                if r.tenant.tier == pick:
                    cls.resident.append(cls.pending.pop(i))
                    self._pending_count -= 1
                    joins += 1
                    break
        return joins

    def _scheduler_loop(self) -> None:
        """Continuous-batching scheduler: one replay step per wakeup.

        Each iteration drains the admission queue into per-class pending
        lists, picks the next class to step, admits joiners and sheds
        expired members at the step boundary, and runs ONE step for that
        class's resident batch outside the lock.
        """
        while True:
            with self._cv:
                with span("sched.pick") as pick:
                    self._drain_queue_locked()
                    cls = self._pick_class_locked()
                    if cls is not None:
                        pick.set(class_id=cls.cid)
                        if self._want_window_locked(cls):
                            with span("sched.window", pending=len(cls.pending)):
                                self._window_locked(cls)
                        expired = self._shed_expired_locked(cls)
                        joins = self._admit_members_locked(cls)
                        group = list(cls.resident)
                        cls.step += 1
                        step_idx = cls.step
                if cls is None:
                    if self._closed:
                        return
                    with span("sched.idle"):
                        self._cv.wait()
                    continue
            if expired:
                now = time.monotonic()
                self.metrics.on_deadline_shed(len(expired))
                for r in expired:
                    self.metrics.on_done(now - r.t_submit, failed=True)
                    r.future.set_exception(DeadlineExceeded(
                        f"deadline passed while queued for tenant {r.tenant.name!r}"))
            if group:
                self._execute_step(cls, group, step_idx, joins=joins, sheds=len(expired))

    def _window_locked(self, cls: _ClassState) -> None:
        """Hold the coalescing window open for ``cls``'s companions."""
        deadline = time.monotonic() + self.max_wait_s
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return
            self._cv.wait(remaining)
            self._drain_queue_locked()
            if not self._want_window_locked(cls):
                return

    def _execute_step(self, cls: _ClassState, group: list, step_idx: int,
                      joins: int, sheds: int) -> None:
        """Run ONE replay step for a resident batch, then settle membership:
        failures and finished members retire; survivors carry outputs into
        same-named input slots, and a member whose buffer signature drifted
        migrates to the class that now matches."""
        t0 = time.monotonic()
        coalesced = False
        with span("step", class_id=cls.cid, step=step_idx, occupancy=len(group)) as step:
            if step:
                step.set(rids=[m.rid for m in group])
            try:
                if len(group) == 1:
                    results: list = [self._run_single(group[0])]
                else:
                    results, coalesced = self._run_batched(group)
                with span("step.wait"):
                    _block_until_ready([r for r in results if not isinstance(r, Exception)])
            except Exception as exc:
                results = [exc] * len(group)
            wall_ms = (time.monotonic() - t0) * 1e3
        with span("step.settle"):
            done: list = []
            failed: list = []
            leaves = 0
            with self._cv:
                for member, out in zip(group, results):
                    if isinstance(out, Exception):
                        cls.resident.remove(member)
                        failed.append((member, out))
                        leaves += 1
                        continue
                    member.steps_done += 1
                    if member.steps_done >= member.steps:
                        cls.resident.remove(member)
                        done.append((member, out))
                        leaves += 1
                        continue
                    tenant = member.tenant
                    member.buffers = {**member.buffers,
                                      **{k: v for k, v in out.items() if k in member.buffers}}
                    canon = {tenant.slot_map[k]: v for k, v in member.buffers.items()
                             if k in tenant.slot_map}
                    member.canon_buffers = canon
                    new_key = self._key(tenant, canon)[0]
                    if new_key != cls.key:
                        cls.resident.remove(member)
                        member.key = new_key
                        target = self._classes.get(new_key)
                        if target is None:
                            target = self._classes[new_key] = _ClassState(new_key,
                                                                          self._next_cid)
                            self._next_cid += 1
                        target.pending.append(member)
                        self._pending_count += 1
                        leaves += 1
                self._cv.notify_all()
            now = time.monotonic()
            with span("step.callbacks", n=len(failed) + len(done)):
                for member, exc in failed:
                    self.metrics.on_done(now - member.t_submit, failed=True)
                    member.future.set_exception(exc)
                for member, out in done:
                    self.metrics.on_done(now - member.t_submit, aot=member.served_aot,
                                         tier=member.tenant.tier)
                    member.future.set_result(out)
            self.metrics.on_batch(len(group), coalesced=coalesced)
            tiers: dict[str, int] = {}
            for member in group:
                label = str(member.tenant.tier)
                tiers[label] = tiers.get(label, 0) + 1
            # The tuner's ladder (already refit by this step's own observation)
            # names the bucket the batched path ran; pad lanes exist only when
            # ONE batched call served the step.
            bucket, padded = (1, 0) if len(group) < 2 else self._bucket_and_pad(len(group))
            step.set(bucket=bucket)
            self.metrics.on_step({
                "step": step_idx,
                "class_id": cls.cid,
                "occupancy": len(group),
                "bucket": bucket,
                "joins": joins,
                "leaves": leaves,
                "sheds": sheds,
                "wall_ms": wall_ms,
                "coalesced": coalesced,
                "padded": padded if coalesced else 0,
                "tiers": tiers,
            })

    # ------------------------------------------------------------- execution
    def _run_single(self, req: _Request) -> dict:
        aot = self._aot_for(req)
        if aot is not None:
            req.served_aot = True
            with torch.no_grad(), _kreg.kernel_mode_scope(req.tenant.kernel_mode):
                return aot(req.buffers)
        fn = req.tenant.replay_fn()
        with torch.no_grad(), _kreg.kernel_mode_scope(req.tenant.kernel_mode):
            return fn(dict(req.buffers))

    def _run_batched(self, group: list[_Request]) -> tuple[list, bool]:
        """Serve a coalesced group; returns ``(results, coalesced)``, with
        ``coalesced`` True only when ONE batched call served the group."""
        try:
            return self._run_batched_fused(group), True
        except _lower.GraphCaptureError:
            raise       # not a missing batching rule: the step fails with it
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
        with span("step.batch") as batch:
            canon = [r.canon_buffers for r in group]
            slots = sorted(canon[0])
            shared = frozenset(s for s in slots
                               if all(cb[s] is canon[0][s] for cb in canon[1:]))
            varying = tuple(s for s in slots if s not in shared)
            shared_bufs = {s: canon[0][s] for s in shared}
            if varying:
                entry, per_req = self._batched_entry(tenant0, shared, varying, canon)
                batch.set(varying=len(varying), pad=len(per_req) - len(group))
        if not varying:
            # Every buffer is literally shared: one replay serves everyone.
            out0 = self._run_single(group[0])
            canon_out = {tenant0.slot_map[s]: v for s, v in out0.items()}
            return [{r.tenant.from_canon[c]: v for c, v in canon_out.items()}
                    for r in group]
        with torch.no_grad(), _kreg.kernel_mode_scope(tenant0.kernel_mode):
            outs = entry.fn({"per_req": tuple(per_req), "shared": shared_bufs})
        return [{r.tenant.from_canon[c]: v for c, v in out_j.items()}
                for r, out_j in zip(group, outs)]

    def _batched_entry(self, tenant0: Tenant, shared: frozenset, varying: tuple,
                       canon: list) -> tuple[PoolEntry, list]:
        """The pool's batched callable for this structure and shared buffers,
        and the members' varying buffers padded to the tuner's bucket."""
        key = ("batched", tenant0.sig, tenant0.payload_ids, shared, tenant0.kernel_mode,
               self.mesh_fp)
        entry = self.pool.get(key)
        if entry is None:
            entry = self.pool.put(key, PoolEntry(
                "batched", self._build_batched(tenant0), tenant0.payloads))
        # Occupancy runs at the tuner's bucket, padded with repeats of the
        # last member (dropped after the call): without buckets every
        # occupancy would capture a graph of its own. A refit retires the
        # pool's batched entries (and their graphs): their bucket sizes can
        # never be asked for again. Under a mesh the bucket is also a
        # batch-axis multiple, so the request axis splits evenly.
        per_req = [{s: cb[s] for s in varying} for cb in canon]
        if self.buckets.observe(len(per_req)):
            with span("tuner.refit") as refit:
                invalidated = self.pool.invalidate(lambda k, e: e.kind == "batched")
                self.metrics.on_bucket_retune(self.buckets.boundaries)
                refit.set(boundaries=list(self.buckets.boundaries), invalidated=invalidated)
        _, pad = self._bucket_and_pad(len(per_req))
        per_req.extend(per_req[-1:] * pad)
        self.metrics.on_pad(pad)
        return entry, per_req

    def _bucket_and_pad(self, occupancy: int) -> tuple[int, int]:
        """(bucket, pad lanes) for ``occupancy`` under the current ladder,
        rounded up to a multiple of the replay mesh's batch axis."""
        bucket = self.buckets.bucket_for(occupancy)
        bucket += (-bucket) % _shreplay.batch_axis_size(self.mesh)
        return bucket, bucket - occupancy

    def _build_batched(self, tenant: Tenant) -> Callable[[dict], tuple]:
        """One cross-request batch callable on canonical slot names.

        ``fn({"per_req": per_request, "shared": shared}) -> tuple[dict, ...]``:
        stacks the request axis, ``torch.func.vmap``s the canonical region
        function over it with the shared buffers closed over (broadcast),
        and slices the outputs per member, all inside one ``GraphReplay``
        (the reference's ``jax.jit(batched)``): one graph per bucket and
        shared-buffer identity, the params module read in place.

        Under a replay mesh the request axis is split into one contiguous
        chunk a batch shard before it is stacked: each shard runs that same
        batched step over its chunk on its device (the shared buffers
        placed there; never copied on their own device), so a shard's graph
        is the unsharded graph of its occupancy, keyed by its device, and
        the members' outputs come back to the caller's device. The inner
        region stays single-device (``mesh=None``), as in the reference:
        its lanes are the request axis already split here.
        """
        base = _lower.lower_tdg(tenant.tdg, jit=False, intern=False, fuse=self.fuse,
                                mesh=None, outputs=list(tenant.outputs)
                                if tenant.outputs is not None else None)
        from_canon, slot_map = tenant.from_canon, tenant.slot_map

        def canon_base(cbufs: dict) -> dict:
            out = base({from_canon[c]: v for c, v in cbufs.items()})
            return {slot_map[s]: v for s, v in out.items()}

        def batched(args: dict) -> tuple:
            per_req, shared_bufs = args["per_req"], args["shared"]
            stacked = pytree.tree_map(lambda *xs: torch.stack(xs), *per_req)
            out = torch.func.vmap(lambda st: canon_base({**st, **shared_bufs}))(stacked)
            return tuple(pytree.tree_map(lambda v, _j=j: v[_j], out)
                         for j in range(len(per_req)))

        batched.__name__ = f"tdg_batched_{tenant.tdg.region}"
        step = batched
        if self.capture:
            step = _lower.GraphReplay(batched, batched.__name__)
            with self._cv:
                self._batched_replays.append(step)
        mesh = self.mesh
        if mesh is None:
            return step

        def sharded(args: dict) -> tuple:
            per_req, shared_bufs = args["per_req"], args["shared"]
            home = next(l.device for l in pytree.tree_leaves(per_req)
                        if isinstance(l, torch.Tensor))
            outs: list = []
            for device, start, stop in _shreplay.lane_chunks(len(per_req), mesh):
                chunk = {"per_req": _shreplay.replicate(per_req[start:stop], device),
                         "shared": _shreplay.replicate(shared_bufs, device)}
                with _shreplay.on_device(device):
                    outs.extend(_shreplay.replicate(step(chunk), home))
            return tuple(outs)

        sharded.__name__ = f"{batched.__name__}_sharded"
        return sharded
