"""Distributed replay serving: an RPC front on ``RegionServer.submit``.

Port of ``repro.serving.cluster``. What the port adds is its idiom: an
explicit ``device`` on :class:`WorkerNode` and :class:`ClusterFrontend`
(``"cuda"`` unless the caller says ``"cpu"``; with no card a CUDA device
raises). Buffers cross the wire as CPU tensors (:mod:`repro_torch.serving.
rpc`); a worker moves each request's tensors to its device before
admission, and pinned buffers once, at registration, where a pinned
name -> tensor dict becomes a :class:`PinnedTree`, so a captured step reads
it in place instead of copying it in. Replies come back as CPU tensors. The
shipped warm artifact is an exported replay program
(``serialize.executable_to_bytes``); a worker hydrates it before it
registers the tenant, which then is not lowered at all, and on the card its
first call captures a CUDA graph in the worker. Tenants shipped the same
bytes share one hydrated program (loading a program is the costly part).

The single-process :class:`~repro_torch.serving.server.RegionServer` already makes
multi-tenant replay cheap (coalescing, interning, AOT hydration); this
module is the step from "serve many tenants fast in one process" to "serve
them from a pool of worker processes" — the distributed-manager shape of
Bosch et al. (arXiv:2009.03066): **central admission, decentralized
execution**. Three pieces:

* :class:`WorkerNode` — one process, one ``RegionServer``, one RPC listener
  (:mod:`repro_torch.serving.rpc`). It registers tenants from shipped TDG JSON
  (payloads re-linked by symbol through an importable
  ``serialize.TaskFnRegistry``), **hydrates compiled executables from
  artifact bytes shipped in-band** (``serialize.executable_from_bytes``)
  instead of re-lowering, and serves ``submit`` asynchronously so requests
  arriving over one connection still coalesce in its admission queue.

* :class:`ClusterFrontend` — the client-facing tier. Its fleet comes from
  the spawners in :mod:`repro_torch.serving.spawner`: ``workers=N`` spawns N
  local processes via ``multiprocessing`` (spawn by default: a fresh CUDA
  context per worker), while ``workers=["host:port", "local", ...]`` mixes
  pre-started **remote** workers (bootstrapped on their hosts with
  ``python -m repro_torch.serving.worker``) with locally spawned ones — both
  kinds sit behind the same router, artifact shipping and death-requeue.
  Every tenant routes to a worker **sticky by structure**: the routing key
  is the TDG's ``structure_signature`` + payload symbols, so structurally
  identical tenants land on the same worker and that worker's
  ``WarmPool``/intern cache stays hot (N tenants, ONE executable, and
  cross-tenant request coalescing keeps working across the RPC boundary).

* :class:`StickyRouter` — the routing table itself: least-loaded assignment
  on first sight of a structure, sticky thereafter, re-routable around dead
  workers.

**Warm-artifact shipping.** A tenant registered with ``warm_path=`` (or
warmed via :meth:`ClusterFrontend.warmup`) has its compiled executable held
as bytes on the frontend; registration ships those bytes with the TDG so a
cold worker *hydrates* instead of re-lowering — the cross-process replay
story of ``serialize.warmup_and_save`` carried over the wire
Shipping is **platform-aware**: every artifact embeds a
device-topology fingerprint (``serialize.topology_fingerprint``) and a
worker checks it at register time, rejecting a cross-platform/cross-version
artifact loudly (``aot_topology_rejects``) and re-lowering instead of
loading it. A worker that receives artifact bytes
it cannot hydrate for any other reason serves the tenant lazily but reports
``aot_hydrate_failures`` in its metrics — a poisoned artifact is loud,
never silently cold.

**Failure handling.** A worker death surfaces as a broken connection; the
frontend fails that worker's in-flight futures, re-routes its tenants to
siblings (re-shipping TDGs + held artifacts), and retries the dead
requests there (``requeues``/``worker_deaths`` counters). Payloads are
pure functions over explicit buffers, so a replayed request is safe to
re-execute. :meth:`ClusterFrontend.stats` aggregates every worker's
server metrics (including ``aot_hydrate_failures``) next to the frontend's
own routing/failover counters, so the cross-process view stays as
observable as the in-process one.

**The wire path.** Submissions do not travel one frame per request. Each
worker handle runs a dispatcher thread draining a per-worker submit queue:
every tick it packs up to ``_WIRE_BATCH`` queued submissions into ONE
``submit_batch`` frame (compact binary codec, tensor blobs optionally via
the shared-memory data plane — :mod:`repro_torch.serving.shm`), and keeps up to
``REPRO_RPC_WINDOW`` such frames in flight per connection, so wire latency
overlaps worker compute instead of serializing with it. The worker admits
the whole frame under one queue-lock acquisition
(``RegionServer.submit_many``) — its coalescer sees the frame's worth of
requests at once, not a trickle — and a per-connection reply writer drains
*completed* requests into ``result_batch`` frames as they finish (no
head-of-line blocking on a straggler). Replies fan back out to per-request
futures by id. Control traffic (register/warmup/stats) stays on plain
JSON frames.

Env knobs: ``REPRO_CLUSTER_WORKERS`` (default worker count, used by
``ClusterFrontend(workers=None)`` and ``launch/serve.py --cluster 0``),
``REPRO_SHIP_ARTIFACTS=0`` (kill switch: never ship compiled bytes; cold
workers re-lower), ``REPRO_RPC_TOKEN`` (default handshake auth token for
frontend and workers), ``REPRO_RPC_MAX_FRAME`` (wire frame cap),
``REPRO_RPC_TRANSPORT`` / ``REPRO_RPC_WINDOW`` / ``REPRO_RPC_SHM_BYTES``
/ ``REPRO_RPC_SHM_MIN_BYTES`` (transport selection, pipelining window and
shm ring sizing — see :mod:`repro_torch.serving.rpc`).

**Self-healing.** A supervisor thread leases every worker via heartbeat
probes (``REPRO_HEARTBEAT_SECS`` × ``REPRO_LEASE_MISSES`` of silence
declares a worker dead — proactively, not just on socket error, and
without mistaking slow for dead: probes are answered inline on the
worker's connection thread, never queued behind replay). Dead *local*
workers are respawned in place with capped exponential backoff (at most
``REPRO_RESPAWN_MAX`` attempts per slot), re-registered with their routed
tenants and re-shipped the frontend-held warm artifacts, so a replacement
serves AOT-warm from its first request. Every submission carries an
absolute deadline (``REPRO_REQUEST_DEADLINE`` seconds, propagated in the
wire frame as a relative ttl); expired work is shed at every hop, and
``WorkerDied`` failures retry on a sibling/respawned worker with jittered
backoff under a per-request budget (``REPRO_RETRY_BUDGET``). The worker's
admission queue is bounded (``REPRO_QUEUE_BOUND``) with explicit
``QueueFull`` shedding. Deterministic fault injection for all of the
above lives in :mod:`repro_torch.serving.faults` (``REPRO_FAULT_PLAN``).
"""
from __future__ import annotations

import hashlib
import importlib
import itertools
import json
import os
import random
import secrets
import socket
import threading
import time
from collections import deque
from concurrent.futures import Future
from concurrent.futures import TimeoutError as _FuturesTimeout
from typing import Any, Callable, Mapping, Sequence

import torch
from torch import nn
from torch.utils import _pytree as pytree

from ..core import serialize as _serialize
from ..core.tdg import TDG, structure_signature
from ..kernels import registry as _kreg
from ..launch.serve import resolve_device
from . import faults as _faults
from . import rpc
from .server import (DeadlineExceeded, QueueFull, RateLimited,
                     RegionServer)
from .spawner import (LocalSpawner, RemoteSpawner, SpawnedWorker,
                      parse_worker_spec)

# Typed serving errors that must survive the wire round trip: the worker
# str-formats them as "TypeName: detail", the frontend maps the prefix
# back through this registry (see _WorkerHandle._remote_error). All three
# are terminal — never retried as if the worker had died.
for _cls in (DeadlineExceeded, QueueFull, RateLimited):
    rpc.register_wire_error(_cls)
del _cls

_WORKERS_ENV = "REPRO_CLUSTER_WORKERS"
_SHIP_ENV = "REPRO_SHIP_ARTIFACTS"
_TOKEN_ENV = "REPRO_RPC_TOKEN"
_RESPAWN_ENV = "REPRO_RESPAWN_MAX"
_DEADLINE_ENV = "REPRO_REQUEST_DEADLINE"
_RETRY_ENV = "REPRO_RETRY_BUDGET"

#: Respawn backoff: first retry after ~_BACKOFF_BASE seconds, doubling per
#: consecutive failure, capped — a worker slot that keeps dying retries at
#: a bounded, jittered cadence instead of hammering the host.
_BACKOFF_BASE = 0.25
_BACKOFF_CAP = 5.0


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    try:
        return float(raw)
    except ValueError:
        raise ValueError(f"{name}={raw!r} is not a number") from None


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    try:
        return int(raw)
    except ValueError:
        raise ValueError(f"{name}={raw!r} is not an integer") from None


class ClusterError(RuntimeError):
    """Frontend-level failure (no live workers, registration conflict...)."""


class ClusterRemoteError(ClusterError):
    """A worker executed the request and reported an error (bad request,
    payload failure): the *request* failed, the worker is fine."""


class WorkerDied(ClusterError):
    """The connection to a worker broke: the worker is gone, the request
    may be retried on a sibling."""


def resolve_registry(spec, kwargs: Mapping[str, Any] | None = None
                     ) -> "_serialize.TaskFnRegistry":
    """Resolve a registry spec to a ``TaskFnRegistry`` (frontend & workers).

    ``spec`` is either a ``TaskFnRegistry`` already (frontend-side
    convenience; NOT shippable to a spawned worker) or an importable
    ``"module:attr"`` string where ``attr`` is a registry or a callable
    returning one (called with ``kwargs``). The string form is what makes
    payload re-linking work across processes: both sides import the same
    symbols instead of pickling closures.
    """
    if isinstance(spec, _serialize.TaskFnRegistry):
        return spec
    if not isinstance(spec, str) or ":" not in spec:
        raise ValueError(
            "registry must be a TaskFnRegistry or an importable "
            f"'module:attr' string, got {spec!r}")
    mod_name, attr = spec.split(":", 1)
    obj = getattr(importlib.import_module(mod_name), attr)
    if isinstance(obj, _serialize.TaskFnRegistry):
        if kwargs:
            raise ValueError(f"{spec!r} is a registry instance; "
                             "registry_kwargs only apply to a factory")
        return obj
    registry = obj(**dict(kwargs or {}))
    if not isinstance(registry, _serialize.TaskFnRegistry):
        raise TypeError(f"{spec!r} returned {type(registry).__name__}, "
                        "expected TaskFnRegistry")
    return registry


class PinnedTree(nn.Module):
    """A pinned name -> tensor dict as a module whose buffers are the dict's
    tensors, under their dotted names. A captured step keys a module by
    identity and reads its tensors in place, where it would copy each of a
    dict's tensors into a static buffer at every call; it reads like the
    dict (``tree[name]``), and ``lower.tensor_tree`` gives an exported
    program the dict again."""

    def __init__(self, tree: Mapping[str, torch.Tensor]):
        super().__init__()
        for name, t in tree.items():
            self._buffers[name] = t

    def __getitem__(self, name: str) -> torch.Tensor:
        return self._buffers[name]

    def __len__(self) -> int:
        return len(self._buffers)

    def keys(self):
        return self._buffers.keys()


def _is_tensor_dict(v: Any) -> bool:
    return (isinstance(v, dict) and bool(v)
            and all(isinstance(k, str) and isinstance(t, torch.Tensor) for k, t in v.items()))


def _to_device(tree: Any, device: torch.device) -> Any:
    return pytree.tree_map_only(torch.Tensor, lambda t: t.to(device), tree)


# ---------------------------------------------------------------------------
# Worker side
# ---------------------------------------------------------------------------

class _ReplyWriter:
    """Per-connection reply coalescer (worker side).

    Completed submit futures land here (from executor callback threads) and
    a single writer thread drains whatever has accumulated into ONE
    ``result_batch`` frame per pass — opportunistic coalescing: a burst of
    completions shares a frame, a lone straggler ships alone immediately.
    Having exactly one thread send binary frames on the connection is also
    what keeps the shm ring single-producer (see :mod:`repro_torch.serving.shm`).
    """

    def __init__(self, conn: "rpc.RpcConnection"):
        self._conn = conn
        self._cv = threading.Condition()
        self._done: list[tuple[Any, Future]] = []
        self._closed = False
        self._thread = threading.Thread(target=self._loop,
                                        name="worker-reply-writer",
                                        daemon=True)
        self._thread.start()

    def complete(self, mid, fut: Future) -> None:
        with self._cv:
            if self._closed:
                return
            self._done.append((mid, fut))
            self._cv.notify_all()

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    def _loop(self) -> None:
        while True:
            with self._cv:
                while not self._done and not self._closed:
                    self._cv.wait()
                if not self._done:      # closed and drained
                    return
                batch, self._done = self._done, []
            entries = []
            for mid, fut in batch:
                exc = fut.exception()
                if exc is not None:
                    entries.append({"id": mid,
                                    "error": f"{type(exc).__name__}: {exc}"})
                else:
                    entries.append({"id": mid, "out": fut.result()})
            try:
                self._conn.send({"op": "result_batch", "entries": entries},
                                codec="binary")
            except (OSError, rpc.ProtocolError):
                return              # connection is dying; nothing to flush to


class WorkerNode:
    """One worker process: an RPC listener wrapped around a ``RegionServer``.

    ``submit`` is handled *asynchronously* — the connection reader enqueues
    into the server's admission queue and replies from a completion
    callback — so many in-flight requests from one frontend connection
    coalesce exactly as in-process callers would. Everything else
    (register/warmup/stats/ping/shutdown) is handled inline: rare, fast, or
    deliberately serializing (warmup).

    Every accepted connection must open with the RPC handshake
    (:func:`rpc.server_handshake`): protocol version pinned, ``token``
    checked when set, and the ack advertises this worker's pid/port and
    device-topology fingerprint. A connection that fails the handshake is
    dropped before it can touch the server. Shipped artifacts whose
    embedded fingerprint disagrees with this host are rejected at register
    time (counted in ``aot_topology_rejects``; the tenant re-lowers).
    ``device`` is where the worker serves (see :func:`resolve_device`).
    """

    def __init__(self, registry: "_serialize.TaskFnRegistry",
                 host: str = "127.0.0.1", port: int = 0,
                 token: str | None = None, handshake_timeout: float = 30.0,
                 transport: str | None = None,
                 server: RegionServer | None = None,
                 device: str | torch.device | None = None, **server_kwargs):
        self.registry = registry
        self.device = resolve_device(device)
        self.token = token
        self.handshake_timeout = handshake_timeout
        # Arm any env-shipped chaos plan, with this process's role: a
        # spawned worker inherits REPRO_FAULT_PLAN from the frontend's
        # environment, so one export arms the whole fleet.
        _faults.init_from_env("worker")
        # The worker's OWN transport policy (its env / CLI, not the
        # frontend's): "tcp" refuses shm-setup offers, "shm"/"auto" attach
        # when the segments are reachable. Independence is deliberate — a
        # worker that knows it cannot share memory (containerized, remote)
        # pins itself to tcp and the frontend falls back per connection.
        self.transport = rpc.transport_mode(transport)
        self.server = server or RegionServer(
            name=f"worker-{os.getpid()}", device=self.device, **server_kwargs)
        self.listener = rpc.listener(host, port)
        self.port = self.listener.getsockname()[1]
        # Pinned buffers arrive once per *group* and are shared by every
        # tenant that references the group key, so all those tenants merge
        # the SAME decoded array objects into their requests — which is
        # exactly what lets RegionServer's coalescer recognize them as
        # shared (object identity) and broadcast instead of stack.
        self._pin_groups: dict[str, dict] = {}
        self._tenant_pin: dict[str, str] = {}
        self._stop = threading.Event()
        self._conn_threads: list[threading.Thread] = []
        # Hydrated programs by the digest of their shipped bytes: tenants
        # shipped one artifact (the structurally identical tenants of one
        # warm file) share one program, loaded once, and its captured graph.
        self._programs: dict[bytes, Any] = {}
        # Worker-local counters beyond the server's own metrics.
        self.hydrated_inband = 0

    # ------------------------------------------------------------------ loop
    def serve_forever(self) -> None:
        """Accept frontend connections until a ``shutdown`` op arrives.

        The listener polls with a short timeout rather than blocking
        forever: ``close()``-ing a socket does not reliably wake a thread
        blocked in ``accept()``, so a purely blocking loop would strand
        the process after a shutdown op handled on a connection thread.
        """
        self.listener.settimeout(0.2)
        try:
            while not self._stop.is_set():
                try:
                    sock, _addr = self.listener.accept()
                except socket.timeout:
                    continue
                except OSError:        # listener closed by shutdown
                    break
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                conn = rpc.RpcConnection(sock)
                t = threading.Thread(target=self._conn_loop, args=(conn,),
                                     name="worker-conn", daemon=True)
                t.start()
                # Prune finished threads so a network-exposed worker doesn't
                # accumulate one entry per client for its whole lifetime.
                self._conn_threads = [ct for ct in self._conn_threads
                                      if ct.is_alive()]
                self._conn_threads.append(t)
        finally:
            self.server.close()

    def _conn_loop(self, conn: rpc.RpcConnection) -> None:
        try:
            # A client gets handshake_timeout (absolute, trickle-proof) to
            # say hello, and the hello frame is capped small: without
            # both, a port scanner or hostile slow client could pin this
            # thread + an attacker-sized allocation forever before the
            # token is ever checked.
            rpc.server_handshake(
                conn, token=self.token, timeout=self.handshake_timeout,
                info={"pid": os.getpid(), "port": self.port,
                      "topology": _serialize.topology_fingerprint(self.device)})
            conn.sock.settimeout(None)      # deadline left a timeout armed
        except (rpc.ProtocolError, rpc.ConnectionClosed, OSError):
            # Wrong token / protocol skew / handshake timeout / port
            # scanner: the reject frame (when sendable) already told the
            # peer why; drop the socket.
            conn.close()
            return
        writer = _ReplyWriter(conn)
        try:
            while not self._stop.is_set():
                try:
                    msg = conn.recv()
                except (rpc.ProtocolError, rpc.ConnectionClosed, OSError):
                    # ProtocolError included: once framing desyncs
                    # (oversized prefix, malformed node) nothing later on
                    # this socket can be trusted — drop the connection,
                    # keep the worker.
                    return
                try:
                    self._dispatch(conn, msg, writer)
                except Exception as exc:  # never let one bad frame kill the loop
                    self._send_error(conn, msg.get("id"), exc)
                if msg.get("op") == "shutdown":
                    return
        finally:
            # Every exit path — shutdown op included — releases the
            # connection (and any attached shm rings) and stops its reply
            # writer; the shutdown path used to leak the socket.
            writer.close()
            conn.close()

    def _send_error(self, conn: rpc.RpcConnection, mid, exc: Exception,
                    ) -> None:
        try:
            conn.send({"op": "error", "id": mid,
                       "error": f"{type(exc).__name__}: {exc}"})
        except OSError:
            pass

    def _merged_buffers(self, tenant: str, buffers: Mapping[str, Any]
                        ) -> dict:
        """The request's buffers on this worker's device, with its pinned
        group (already there) merged in."""
        pin_key = self._tenant_pin.get(tenant)
        merged = dict(self._pin_groups.get(pin_key, {}))
        merged.update(_to_device(dict(buffers), self.device))
        return merged

    def _dispatch(self, conn: rpc.RpcConnection, msg: dict,
                  writer: _ReplyWriter) -> None:
        op, mid = msg["op"], msg.get("id")
        if op == rpc.HEARTBEAT_OP:
            # Lease probe: answered INLINE on this connection thread, never
            # queued behind replay work — which is exactly what lets the
            # supervisor tell slow (acks heartbeats, results late) from
            # dead (acks nothing). The lightest round-trip the wire has.
            conn.send({"op": rpc.HEARTBEAT_ACK_OP, "id": mid})
        elif op == "submit_batch":
            # The hot path: one frame, N submissions, ONE admission-queue
            # lock acquisition (submit_many) so the server's coalescer
            # sees the whole frame at once. Per-entry failures come back
            # as pre-failed futures — routed to the right caller by id,
            # never rejecting the frame's other entries. Each entry may
            # carry a relative "ttl" (seconds of deadline remaining at
            # send time — relative because monotonic clocks do not compare
            # across hosts); it converts to a worker-local absolute
            # deadline here, and already-expired entries are shed by the
            # server before they cost a replay.
            entries = msg["entries"]
            now = time.monotonic()
            items = []
            for e in entries:
                ttl = e.get("ttl")
                deadline = now + ttl if isinstance(ttl, (int, float)) \
                    and not isinstance(ttl, bool) else None
                items.append((e["tenant"],
                              self._merged_buffers(e["tenant"], e["buffers"]),
                              deadline))
            futs = self.server.submit_many(items)
            for e, fut in zip(entries, futs):
                fut.add_done_callback(
                    lambda f, _mid=e["id"]: writer.complete(_mid, f))
        elif op == "submit":
            # Single-request form (kept for probe/test paths): same reply
            # plumbing as the batch path, so ordering and coalescing of
            # replies is uniform.
            fut = self.server.submit(
                msg["tenant"],
                self._merged_buffers(msg["tenant"], msg["buffers"]))
            fut.add_done_callback(
                lambda f, _mid=mid: writer.complete(_mid, f))
        elif op == "shm-setup":
            self._handle_shm_setup(conn, msg)
        elif op == "register":
            conn.send({"op": "result", "id": mid,
                       **self._handle_register(msg)})
        elif op == "warmup":
            # Off-thread: a warmup is a full export (tens of seconds at a
            # full-width model). Handling it inline would silence this
            # connection's heartbeat acks for the duration and get a
            # perfectly healthy worker declared dead mid-export. The
            # connection's write lock makes the cross-thread reply send safe.
            def _do_warmup(msg=msg, mid=mid):
                try:
                    reply = {"op": "result", "id": mid,
                             **self._handle_warmup(msg)}
                except Exception as exc:
                    self._send_error(conn, mid, exc)
                    return
                try:
                    conn.send(reply)
                except (OSError, rpc.ProtocolError):
                    pass        # connection died while we compiled
            threading.Thread(target=_do_warmup, name="worker-warmup",
                             daemon=True).start()
        elif op == "stats":
            conn.send({"op": "result", "id": mid, "stats": self.stats()})
        elif op == "trace":
            conn.send({"op": "result", "id": mid,
                       "trace": self.server.metrics.trace.snapshot(),
                       "summary": self.server.metrics.trace.summary()})
        elif op == "ping":
            conn.send({"op": "result", "id": mid, "pid": os.getpid(),
                       "port": self.port})
        elif op == "shutdown":
            self._stop.set()
            conn.send({"op": "result", "id": mid, "stopping": True})
            try:
                self.listener.close()
            except OSError:
                pass
        else:
            raise ValueError(f"unknown op {op!r}")

    # ------------------------------------------------------------------- ops
    def _handle_shm_setup(self, conn: rpc.RpcConnection, msg: dict) -> None:
        """Attach (or refuse) the frontend's offered shared-memory rings.

        Any failure — worker pinned to tcp, segments unreachable (different
        host, different mount namespace), bogus names/sizes — is a clean
        ``attached: False`` reply with a reason: the frontend falls back to
        TCP and counts it; the connection survives either way.
        """
        mid = msg.get("id")
        if self.transport == "tcp":
            conn.send({"op": "result", "id": mid, "attached": False,
                       "reason": "worker transport pinned to tcp"})
            return
        tx = rx = None
        try:
            from . import shm as _shm
            size = int(msg["size"])
            # The frontend's tx ring is what IT sends on → our receive
            # side; its rx ring is our send side.
            rx = _shm.ShmRing.attach(msg["tx"], size)
            tx = _shm.ShmRing.attach(msg["rx"], size)
        except Exception as exc:
            for ring in (tx, rx):
                if ring is not None:
                    ring.close()
            conn.send({"op": "result", "id": mid, "attached": False,
                       "reason": f"{type(exc).__name__}: {exc}"})
            return
        conn.attach_rings(send_ring=tx, recv_ring=rx)
        conn.send({"op": "result", "id": mid, "attached": True})

    def _handle_register(self, msg: dict) -> dict:
        name = msg["tenant"]
        tdg = _serialize.tdg_from_dict(msg["tdg"], self.registry)
        outputs = tuple(msg["outputs"]) if msg.get("outputs") else None
        # The shipped artifact is hydrated first, so a tenant that gets its
        # program is never lowered here (its structure costs no intern miss).
        aot, hydrate_error = None, None
        artifact = msg.get("artifact")
        if artifact is not None:
            digest = hashlib.sha256(artifact).digest()
            try:
                aot = self._programs.get(digest)
                if aot is None:
                    aot = self._programs[digest] = _serialize.executable_from_bytes(
                        artifact, device=self.device)
            except _serialize.TopologyMismatch as exc:
                # Exported for other hardware or another torch/CUDA version:
                # caught by the fingerprint BEFORE torch.export.load runs.
                # Reject loudly, serve by re-lowering.
                self.server.metrics.on_aot_topology_reject()
                hydrate_error = f"{type(exc).__name__}: {exc}"
            except Exception as exc:
                # Poisoned/unusable artifact: serve lowered, but LOUDLY —
                # the metric keeps "fell back to re-lowering" from passing
                # for warm in aggregated stats.
                self.server.metrics.on_aot_hydrate_failure()
                hydrate_error = f"{type(exc).__name__}: {exc}"
        already = False
        try:
            self.server.register_tenant(name, tdg, outputs=outputs,
                                        kernel_mode=msg.get("kernel_mode"),
                                        tier=msg.get("tier"),
                                        rate=msg.get("rate"), aot=aot)
        except ValueError as exc:
            if "already registered" not in str(exc):
                raise
            # Failover re-registration (the frontend routed this tenant
            # here before, or is re-shipping after a sibling died): the
            # tenant and its warm state are still valid — idempotent.
            already = True
            if aot is not None:
                self.server.install_aot(name, aot, hydrated=True)
        if aot is not None:
            self.hydrated_inband += 1
        pin_key = msg.get("pin_key")
        if pin_key is not None:
            if msg.get("pinned") is not None:
                # setdefault: the first shipment's objects win, so later
                # tenants referencing this group alias the same tensors. They
                # move to the device once, here; a name -> tensor dict becomes
                # a PinnedTree, read in place by a captured step.
                if pin_key not in self._pin_groups:
                    pinned = _to_device(dict(msg["pinned"]), self.device)
                    self._pin_groups[pin_key] = {
                        k: PinnedTree(v) if _is_tensor_dict(v) else v
                        for k, v in pinned.items()}
            elif pin_key not in self._pin_groups:
                raise ValueError(
                    f"tenant {name!r} references pin group {pin_key!r} "
                    "that was never shipped to this worker")
            self._tenant_pin[name] = pin_key
        return {"registered": True, "already": already,
                "hydrated": aot is not None, "hydrate_error": hydrate_error}

    def _handle_warmup(self, msg: dict) -> dict:
        name = msg["tenant"]
        report = self.server.warmup(name, self._merged_buffers(name, msg["buffers"]))
        artifact = None
        if _serialize.executable_serialization_available():
            tenant = self.server.tenant(name)
            entry = self.server.pool.peek(tenant.aot_key)
            if entry is not None:
                artifact = _serialize.executable_to_bytes(entry.fn)
        return {"report": report, "artifact": artifact}

    def stats(self) -> dict:
        s = self.server.stats()
        s["worker"] = {"pid": os.getpid(), "port": self.port,
                       "hydrated_inband": self.hydrated_inband,
                       "device": str(self.device),
                       "topology": _serialize.topology_fingerprint(self.device),
                       "transport": self.transport,
                       "pin_groups": len(self._pin_groups),
                       "pinned_tenants": sorted(self._tenant_pin)}
        return s


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------

class StickyRouter:
    """Structure-sticky, least-loaded tenant→worker routing table.

    The key insight (and the whole point of stickiness): a worker's
    ``WarmPool`` and intern cache are keyed by *structure*, so the cheapest
    worker for a request is whichever one already compiled that structure.
    First sight of a routing key picks the live worker with the fewest
    structures assigned; every later tenant with the same key follows it.
    ``reroute`` moves a key off a dead worker (and remembers the move).
    """

    def __init__(self, n_workers: int):
        self.n_workers = n_workers
        self._table: dict[Any, int] = {}
        self._loads = [0] * n_workers
        self._lock = threading.Lock()

    def route(self, key: Any, alive: frozenset[int] | set[int]) -> int:
        if not alive:
            raise ClusterError("no live workers to route to")
        with self._lock:
            w = self._table.get(key)
            if w is not None and w in alive:
                return w
            w = min(alive, key=lambda i: (self._loads[i], i))
            if self._table.get(key) is not None:
                self._loads[self._table[key]] -= 1
            self._table[key] = w
            self._loads[w] += 1
            return w

    def reroute(self, key: Any, alive: set[int], exclude: set[int]) -> int:
        candidates = set(alive) - set(exclude)
        if not candidates:
            raise ClusterError(
                f"no live workers left to requeue onto (alive={sorted(alive)},"
                f" excluded={sorted(exclude)})")
        with self._lock:
            old = self._table.get(key)
            w = min(candidates, key=lambda i: (self._loads[i], i))
            if old is not None:
                self._loads[old] -= 1
            self._table[key] = w
            self._loads[w] += 1
            return w

    def assignment(self) -> dict:
        with self._lock:
            return dict(self._table)


# ---------------------------------------------------------------------------
# Frontend side
# ---------------------------------------------------------------------------

class _TenantRecord:
    __slots__ = ("name", "tdg_dict", "outputs", "kernel_mode", "route_key",
                 "worker", "artifact", "pin_key", "requests", "tier", "rate")

    def __init__(self, name, tdg_dict, outputs, kernel_mode, route_key,
                 tier=None, rate=None):
        self.name = name
        self.tdg_dict = tdg_dict
        self.outputs = outputs
        self.kernel_mode = kernel_mode
        self.route_key = route_key
        self.worker: int | None = None
        self.artifact: bytes | None = None
        self.pin_key: str | None = None
        self.requests = 0
        # QoS config crosses the wire with every (re-)registration, so a
        # respawned or failover worker applies the same tier/rate policy.
        self.tier: int | None = tier
        self.rate: float | None = rate


#: Max submissions packed into one ``submit_batch`` frame. Large enough
#: that a worker's whole admission-queue wave usually arrives as one frame;
#: small enough that a frame never approaches the frame cap with typical
#: tensor payloads.
_WIRE_BATCH = 64


class _WorkerHandle:
    """Frontend-side view of one worker: dispatcher, window, reply demux.

    Submissions go through a per-worker queue drained by a dispatcher
    thread that packs up to :data:`_WIRE_BATCH` of them into one
    ``submit_batch`` frame, keeping at most ``window`` frames in flight on
    the connection (pipelining: the wire round-trip overlaps worker
    compute, and backpressure from a slow worker is a bounded window, not
    an unbounded queue of unacked frames). The batching is *self-clocking*:
    while the window is full the queue grows, so the next frame packs more
    — load adapts frame occupancy with zero tuning.

    Control requests (register/warmup/stats/ping/shutdown) bypass the
    queue: they are rare, ordered, and JSON-coded. ``process`` is the local
    ``multiprocessing.Process`` or ``None`` for a remote worker attached by
    address — the shutdown path branches on it (reap vs. best-effort RPC +
    connection close).
    """

    def __init__(self, idx: int, spawned: SpawnedWorker,
                 ids: "itertools.count", on_death: Callable[[int], None],
                 window: int | None = None):
        self.idx = idx
        self.spawned = spawned          # kept whole for respawn()
        self.kind = spawned.kind
        self.address = spawned.address
        self.info = spawned.info
        self.process = spawned.process
        self.conn = spawned.conn
        self.transport = spawned.transport
        self.shm_fallback = spawned.shm_fallback
        self.alive = True
        self._ids = ids
        self._on_death = on_death
        self._window = rpc.window_size(window)
        self._lock = threading.Lock()
        self._pending: dict[int, Future] = {}
        # mid -> absolute monotonic deadline, for the supervisor's sweep
        # (fails pending futures whose reply never arrived in time — the
        # backstop that turns a dropped result frame into a typed error
        # instead of a hang).
        self._deadlines: dict[int, float] = {}
        # mid -> shared [outstanding_count] cell of its frame: the window
        # slot frees when every entry of the frame has been answered.
        self._frame_of: dict[int, list] = {}
        self._submit_q: deque[tuple[int, str, dict, float | None]] = deque()
        self._q_cv = threading.Condition()
        self._inflight_frames = 0
        self.frames_sent = 0
        self.entries_sent = 0
        self.timeouts = 0
        # Lease state (supervisor-owned: one thread calls heartbeat_tick).
        self.heartbeat_misses = 0           # consecutive
        self.heartbeat_misses_total = 0
        self._hb_fut: Future | None = None
        self._reader = threading.Thread(target=self._read_loop,
                                        name=f"cluster-reader-{idx}",
                                        daemon=True)
        self._reader.start()
        self._writer = threading.Thread(target=self._write_loop,
                                        name=f"cluster-dispatch-{idx}",
                                        daemon=True)
        self._writer.start()

    # --------------------------------------------------------------- submits
    def submit_async(self, tenant: str, buffers: dict,
                     deadline: float | None = None) -> Future:
        """Queue one submission for the dispatcher; resolves to the reply
        entry (``{"id": ..., "out": ...}``). O(1), lock scope is a dict
        put + a queue append — the frontend's submit hot path never waits
        on the wire. ``deadline`` is an absolute ``time.monotonic()``
        instant; it rides to the worker as a relative ttl and backs the
        supervisor's no-reply sweep here."""
        fut: Future = Future()
        mid = next(self._ids)
        with self._lock:
            if not self.alive:
                raise WorkerDied(f"worker {self.idx} is dead")
            self._pending[mid] = fut
            if deadline is not None:
                self._deadlines[mid] = deadline
        with self._q_cv:
            self._submit_q.append((mid, tenant, buffers, deadline))
            self._q_cv.notify_all()
        return fut

    def _write_loop(self) -> None:
        """Dispatcher: pack queued submissions into batch frames, bounded
        by the pipelining window."""
        while True:
            with self._q_cv:
                while self.alive and (
                        not self._submit_q
                        or self._inflight_frames >= self._window):
                    self._q_cv.wait()
                if not self.alive:
                    return
                entries = []
                while self._submit_q and len(entries) < _WIRE_BATCH:
                    entries.append(self._submit_q.popleft())
            # Drop entries whose future already finished (timed out,
            # cancelled, failed by _mark_dead) or whose deadline has
            # already passed: sending them would waste worker compute on
            # an answer nobody can receive.
            live = []
            expired: list[Future] = []
            now = time.monotonic()
            with self._lock:
                for mid, tenant, buffers, deadline in entries:
                    fut = self._pending.get(mid)
                    if fut is None or fut.done():
                        self._pending.pop(mid, None)
                        self._deadlines.pop(mid, None)
                        continue
                    if deadline is not None and deadline <= now:
                        self._pending.pop(mid, None)
                        self._deadlines.pop(mid, None)
                        expired.append(fut)
                        continue
                    live.append((mid, tenant, buffers, deadline))
                if live:
                    cell = [len(live)]
                    for mid, _, _, _ in live:
                        self._frame_of[mid] = cell
            for fut in expired:
                fut.set_exception(DeadlineExceeded(
                    f"worker {self.idx}: deadline passed while queued at "
                    "the frontend"))
            if not live:
                continue
            with self._q_cv:
                self._inflight_frames += 1
            # The ttl is recomputed at PACK time (not submit time), so
            # frontend queue wait is charged against the budget; relative
            # seconds because monotonic clocks do not compare across hosts.
            frame = {"op": "submit_batch",
                     "entries": [
                         {"id": mid, "tenant": t, "buffers": b,
                          **({"ttl": d - now} if d is not None else {})}
                         for mid, t, b, d in live]}
            try:
                self.conn.send(frame, codec="binary")
            except (OSError, rpc.ProtocolError):
                self._mark_dead()
                return
            with self._lock:
                self.frames_sent += 1
                self.entries_sent += len(live)

    # -------------------------------------------------------------- control
    def request_async(self, msg: dict) -> Future:
        fut: Future = Future()
        mid = next(self._ids)
        fut._rpc_mid = mid          # lets request() disown it on timeout
        with self._lock:
            if not self.alive:
                raise WorkerDied(f"worker {self.idx} is dead")
            self._pending[mid] = fut
        try:
            self.conn.send({**msg, "id": mid})
        except OSError as exc:
            with self._lock:
                self._pending.pop(mid, None)
            self._mark_dead()
            raise WorkerDied(f"worker {self.idx}: send failed "
                             f"({exc})") from exc
        return fut

    def request(self, msg: dict, timeout: float | None = 120.0) -> dict:
        fut = self.request_async(msg)
        try:
            return fut.result(timeout=timeout)
        except _FuturesTimeout:
            # The bug this fixes: timing out used to leave the pending
            # entry (and its Future) in the demux table forever — a stuck
            # worker silently accumulated state. Disown the id so a late
            # reply is dropped by the reader, fail the future, and COUNT
            # it: a timeout is a worker-health signal, not ambient noise.
            with self._lock:
                still = self._pending.pop(fut._rpc_mid, None)
            if still is None:
                # The reply raced the timeout and the reader already
                # resolved the future — take the result, it's here.
                return fut.result(timeout=0)
            with self._lock:
                self.timeouts += 1
            err = ClusterError(
                f"worker {self.idx}: no reply to {msg.get('op')!r} "
                f"within {timeout}s")
            still.set_exception(err)
            raise err from None

    # ---------------------------------------------------------------- reader
    def _read_loop(self) -> None:
        while True:
            try:
                msg = self.conn.recv()
            except (rpc.ProtocolError, rpc.ConnectionClosed, OSError):
                # ProtocolError too: a desynced/oversized frame means this
                # connection is unusable — fall through to _mark_dead() so
                # pending futures fail fast and the router stops using it,
                # instead of the reader dying with futures hung.
                break
            if not isinstance(msg, dict):
                continue
            if msg.get("op") == "result_batch":
                for entry in msg.get("entries", ()):
                    self._complete(entry.get("id"), entry)
            else:
                self._complete(msg.get("id"), msg)
        self._mark_dead()

    def _complete(self, mid, msg: dict) -> None:
        """Resolve one reply entry; release its frame's window slot when
        the frame is fully answered."""
        with self._lock:
            fut = self._pending.pop(mid, None)
            self._deadlines.pop(mid, None)
            # Each mid is popped from _frame_of exactly once, under this
            # lock — so the cell decrement is single-shot per mid even
            # though the reader AND the supervisor's deadline sweep can
            # both retire entries.
            cell = self._frame_of.pop(mid, None)
            freed = False
            if cell is not None:
                cell[0] -= 1
                freed = cell[0] == 0
        if freed:
            with self._q_cv:
                self._inflight_frames -= 1
                self._q_cv.notify_all()
        if fut is None:
            return                  # reply to an already-abandoned request
        if msg.get("op") == "error" or (msg.get("op") is None
                                        and "error" in msg):
            fut.set_exception(self._remote_error(msg.get("error")))
        else:
            fut.set_result(msg)

    def _remote_error(self, detail) -> Exception:
        """Map a worker error string back to a typed exception.

        Worker-side errors cross the wire as ``"TypeName: detail"``;
        deadline and shedding failures must come back as their own types
        (``DeadlineExceeded`` is terminal, ``QueueFull`` means back off,
        ``RateLimited`` means slow this tenant down — none should be
        retried as if the worker had died). The name→class mapping lives
        in :func:`rpc.register_wire_error`'s registry."""
        if isinstance(detail, str):
            cls = rpc.wire_error_class(detail)
            if cls is not None:
                return cls(f"worker {self.idx}: {detail}")
        return ClusterRemoteError(f"worker {self.idx}: {detail}")

    # ------------------------------------------------------------ liveness
    def expire_deadlines(self, now: float) -> int:
        """Fail pending futures whose deadline passed with no reply.

        The supervisor calls this every tick. It is what turns a reply
        that will never arrive (dropped result frame, wedged worker) into
        a clean ``DeadlineExceeded`` instead of a caller hang — and it
        releases the affected frames' window slots so the dispatcher is
        not left jammed behind entries nobody is waiting for."""
        expired: list[Future] = []
        freed = 0
        with self._lock:
            if not self.alive:
                return 0
            for mid in [m for m, d in self._deadlines.items() if d <= now]:
                fut = self._pending.pop(mid, None)
                del self._deadlines[mid]
                cell = self._frame_of.pop(mid, None)
                if cell is not None:
                    cell[0] -= 1
                    if cell[0] == 0:
                        freed += 1
                if fut is not None and not fut.done():
                    expired.append(fut)
        if freed:
            with self._q_cv:
                self._inflight_frames -= freed
                self._q_cv.notify_all()
        for fut in expired:
            fut.set_exception(DeadlineExceeded(
                f"worker {self.idx}: no reply before the request deadline"))
        return len(expired)

    def heartbeat_tick(self, miss_budget: int) -> bool:
        """One lease tick: account the previous probe, launch the next.

        Returns ``True`` when the lease is exhausted — ``miss_budget``
        consecutive probes unanswered — and the caller should declare this
        worker dead. Unanswered probes are *disowned* (popped from the
        demux table) so a wedged worker cannot accumulate pending state;
        a probe answered within the tick resets the miss streak, which is
        what keeps a merely slow worker leased."""
        prev = self._hb_fut
        if prev is not None:
            if prev.done() and prev.exception() is None:
                self.heartbeat_misses = 0
            else:
                self.heartbeat_misses += 1
                self.heartbeat_misses_total += 1
                mid = getattr(prev, "_rpc_mid", None)
                if not prev.done() and mid is not None:
                    with self._lock:
                        self._pending.pop(mid, None)
                if self.heartbeat_misses >= miss_budget:
                    self._hb_fut = None
                    return True
        try:
            self._hb_fut = self.request_async(rpc.heartbeat_frame(0))
        except (WorkerDied, OSError):
            return True         # the socket already told us
        return False

    # -------------------------------------------------------------- teardown
    def _mark_dead(self) -> None:
        with self._lock:
            if not self.alive:
                return
            self.alive = False
            pending = list(self._pending.values())
            self._pending.clear()
            self._deadlines.clear()
            self._frame_of.clear()
        with self._q_cv:
            self._submit_q.clear()
            self._inflight_frames = 0
            self._q_cv.notify_all()     # dispatcher wakes, sees dead, exits
        # Close the connection NOW, not lazily at frontend teardown: this
        # is what unlinks the shm ring segments (a worker killed mid-frame
        # can never ack, so the segments would otherwise leak until the
        # frontend exits) and what wakes a dispatcher thread blocked in
        # ring alloc() waiting on credit the dead worker will never send —
        # the stranded-on-ring-credit half of the death bug.
        self.conn.close()
        for fut in pending:
            if not fut.done():
                fut.set_exception(WorkerDied(
                    f"worker {self.idx} died with the request in flight"))
        self._on_death(self.idx)

    def dispatch_stats(self) -> dict:
        """Dispatcher-side wire stats: framing occupancy and window state."""
        with self._q_cv:
            queued = len(self._submit_q)
            inflight = self._inflight_frames
        with self._lock:
            frames, entries = self.frames_sent, self.entries_sent
            timeouts = self.timeouts
        return {"frames_sent": frames, "entries_sent": entries,
                "entries_per_frame": (round(entries / frames, 3)
                                      if frames else 0.0),
                "inflight_frames": inflight, "queued_entries": queued,
                "window": self._window, "timeouts": timeouts}

    def close(self) -> None:
        """Orderly teardown that can never hang on (or silently drop) an
        inflight pipelined window.

        The race this closes: the dispatcher thread may be mid-``send``
        (possibly blocked on shm ring credit) while ``close()`` tears the
        socket down — and any future still queued or pending would
        otherwise just never resolve. Sequence: go not-alive and *disown*
        every queued/pending entry under the locks, wake the dispatcher,
        then close the connection (which unblocks a ring-credit wait), and
        only then fail the captured futures with a typed error.
        """
        with self._lock:
            self.alive = False
            pending = list(self._pending.values())
            self._pending.clear()
            self._deadlines.clear()
            self._frame_of.clear()
        with self._q_cv:
            self._submit_q.clear()      # dispatcher has nothing left to pack
            self._inflight_frames = 0
            self._q_cv.notify_all()     # release the dispatcher thread
        # Give a dispatcher that is between "popped entries" and "send" a
        # beat to hit the dead connection on its own...
        self._writer.join(timeout=0.5)
        # ...then close the connection: wakes a send blocked on ring
        # credit (ShmRing.close notifies allocators) and stops the reader.
        self.conn.close()
        self._writer.join(timeout=5.0)
        self._reader.join(timeout=5.0)
        for fut in pending:
            if not fut.done():
                fut.set_exception(ClusterError(
                    f"worker {self.idx}: frontend closed with the request "
                    "in flight"))


class ClusterFrontend:
    """Central admission over a fleet of ``WorkerNode`` processes/hosts.

    Exposes the same surface as :class:`RegionServer` — ``register_tenant``
    / ``submit`` / ``serve`` / ``warmup`` / ``stats`` — but routes over RPC
    with structure-sticky placement, warm-artifact shipping and
    death-requeue. Single-process semantics are untouched: each worker IS a
    ``RegionServer``; the frontend only decides *which one* sees a request.

    Parameters
    ----------
    workers:
        The fleet. An ``int`` spawns that many local worker processes
        (default count: ``REPRO_CLUSTER_WORKERS`` or 2). A sequence of
        specs mixes kinds: ``"host:port"`` attaches to a pre-started
        remote worker (``python -m repro_torch.serving.worker`` on that host),
        the literal ``"local"`` spawns one here — e.g.
        ``workers=["10.0.0.5:7077", "local"]``.
    registry:
        The payload symbol table (see :func:`resolve_registry`). Must be an
        importable ``"module:attr"`` string whenever the fleet includes a
        locally *spawned* worker (the spec is what crosses the process
        boundary); an all-remote fleet may pass a live ``TaskFnRegistry``,
        since remote workers were bootstrapped with their own
        ``--registry``.
    registry_kwargs:
        Kwargs for a factory-style registry spec.
    token:
        Handshake auth token, shared by the whole fleet (default:
        ``$REPRO_RPC_TOKEN``). Remote workers must have been started with
        the same token. When unset, locally *spawned* workers still get a
        random per-frontend token (the frontend controls both ends, so
        local listeners are never left open to other users on this host);
        remote attaches then handshake with no token.
    transport:
        ``"tcp"`` | ``"shm"`` | ``"auto"`` (default:
        ``$REPRO_RPC_TRANSPORT`` or auto). ``auto`` negotiates a
        shared-memory tensor data plane with locally *spawned* workers
        only; ``shm`` attempts it for every worker; a failed negotiation
        always falls back to TCP (counted in ``stats()["frontend"]
        ["shm_fallbacks"]``). The worker's own policy (its env/CLI) can
        refuse independently.
    window:
        Max batch frames in flight per worker connection (default:
        ``$REPRO_RPC_WINDOW`` or 8).
    shm_bytes:
        Per-direction shm ring size in bytes (default:
        ``$REPRO_RPC_SHM_BYTES`` or 64 MiB).
    ship_artifacts:
        Ship held compiled artifacts to workers at (re-)registration.
        Default: on, unless ``REPRO_SHIP_ARTIFACTS=0``.
    start_method:
        ``multiprocessing`` start method for local workers; ``"spawn"``
        (default) gives every worker a fresh process with its own CUDA
        context (a fork after CUDA is initialized breaks the child's).
    shutdown_grace:
        Seconds :meth:`close` waits at each escalation step
        (join → terminate → kill) before moving to the next.
    device:
        Where locally spawned workers serve (``"cuda"`` unless ``"cpu"``;
        with no card a CUDA device raises here). Remote workers chose theirs
        at bootstrap. Replies come back as CPU tensors.
    max_batch / max_wait_ms / pool_capacity / fuse / continuous:
        Forwarded to every locally spawned worker's ``RegionServer``
        (remote workers configure theirs at bootstrap); ``continuous``
        selects iteration-level vs request-level batching worker-side
        (``None`` honours each worker's ``REPRO_CONTINUOUS``).
    """

    def __init__(self, workers: int | Sequence[str] | None = None, *,
                 registry: Any, registry_kwargs: Mapping[str, Any] | None = None,
                 max_batch: int = 8, max_wait_ms: float = 2.0,
                 pool_capacity: int = 64, fuse: bool | str = "auto",
                 continuous: bool | None = None,
                 ship_artifacts: bool | None = None,
                 token: str | None = None,
                 transport: str | None = None,
                 window: int | None = None,
                 shm_bytes: int | None = None,
                 start_method: str = "spawn",
                 spawn_timeout: float = 120.0,
                 shutdown_grace: float = 10.0,
                 heartbeat_secs: float | None = None,
                 lease_misses: int | None = None,
                 respawn_max: int | None = None,
                 request_deadline: float | None = None,
                 retry_budget: int | None = None,
                 device: str | torch.device | None = None,
                 name: str = "cluster-frontend"):
        # Arm any env-shipped chaos plan with the frontend role before the
        # fleet spawns (spawned workers inherit the same env and arm as
        # "worker" — one export faults both tiers deterministically).
        _faults.init_from_env("frontend")
        self.device = resolve_device(device)
        if workers is None:
            workers = int(os.environ.get(_WORKERS_ENV, "2"))
        if isinstance(workers, int):
            if workers < 1:
                raise ValueError(f"need at least one worker, got {workers}")
            specs: list[tuple[str, int] | None] = [None] * workers
        else:
            specs = [parse_worker_spec(s) for s in workers]
            if not specs:
                raise ValueError("need at least one worker spec")
        n_local = sum(1 for s in specs if s is None)
        if ship_artifacts is None:
            ship_artifacts = os.environ.get(_SHIP_ENV, "1").strip().lower() \
                not in ("0", "false", "off", "no")
        if n_local and not isinstance(registry, str):
            raise ValueError(
                "registry must be an importable 'module:attr' string when "
                "the fleet spawns local workers — a live TaskFnRegistry "
                "cannot cross the process boundary")
        if token is None:
            token = os.environ.get(_TOKEN_ENV) or None
        # Locally SPAWNED workers are always authenticated: the frontend
        # starts them, so when no token is configured it mints a private
        # one rather than leaving a listener on this host open to any
        # local user. Remote attaches use the configured token as-is
        # (possibly None — the remote worker decides its own auth).
        local_token = token if token is not None else secrets.token_hex(16)
        self.name = name
        self.n_workers = len(specs)
        self.n_remote = len(specs) - n_local
        self.ship_artifacts = ship_artifacts
        self.transport = rpc.transport_mode(transport)
        self.window = rpc.window_size(window)
        self._shm_bytes = (rpc.shm_ring_bytes(shm_bytes)
                           if self.transport in ("shm", "auto") else None)
        self.registry_spec = registry if isinstance(registry, str) else None
        self.registry_kwargs = dict(registry_kwargs or {})
        self.local_registry = resolve_registry(registry, registry_kwargs)
        self.router = StickyRouter(self.n_workers)
        self.shutdown_grace = shutdown_grace
        self._token = token
        self._local_token = local_token
        self._server_kwargs = {"max_batch": max_batch,
                               "max_wait_ms": max_wait_ms,
                               "pool_capacity": pool_capacity, "fuse": fuse,
                               "continuous": continuous,
                               "device": str(self.device)}
        self._ids = itertools.count(1)
        self._lock = threading.Lock()
        self._register_lock = threading.Lock()
        self._tenants: dict[str, _TenantRecord] = {}
        # Pin groups: identity-keyed frontend registry of pinned buffer
        # sets, shipped to each worker at most once so tenants sharing a
        # group alias ONE decoded copy worker-side (broadcast, not stack).
        self._pin_ids: dict[tuple, str] = {}
        self._pin_data: dict[str, dict] = {}
        self._shipped_pins: set[tuple[int, str]] = set()
        self._closed = False
        self.worker_deaths = 0
        self.requeues = 0
        self.artifacts_shipped = 0
        self.artifact_bytes_shipped = 0
        self.pin_groups_shipped = 0
        # Self-healing knobs (ctor beats env beats default). heartbeat=0
        # disables the supervisor entirely; respawn_max bounds restart
        # attempts per worker slot; request_deadline<=0 means unbounded.
        self._hb_secs = rpc.heartbeat_secs(heartbeat_secs)
        self._lease_misses = rpc.lease_misses(lease_misses)
        self._respawn_max = (respawn_max if respawn_max is not None
                             else _env_int(_RESPAWN_ENV, 3))
        deadline_default = _env_float(_DEADLINE_ENV, 120.0)
        self._request_deadline = (request_deadline
                                  if request_deadline is not None
                                  else deadline_default)
        self._retry_budget = (retry_budget if retry_budget is not None
                              else _env_int(_RETRY_ENV, 2))
        self.retries = 0
        self.respawns = 0
        self.respawn_failures = 0
        self.heartbeat_misses = 0
        self.deadline_failures = 0
        self._respawn_state: dict[int, dict] = {}
        self._spawn_timeout = spawn_timeout
        local_spawner = (LocalSpawner(self.registry_spec,
                                      self.registry_kwargs,
                                      self._server_kwargs, local_token,
                                      start_method=start_method,
                                      transport=self.transport,
                                      shm_bytes=self._shm_bytes)
                         if n_local else None)
        self._local_spawner = local_spawner     # retained for respawns
        remote_spawner = (RemoteSpawner(token, transport=self.transport,
                                        shm_bytes=self._shm_bytes)
                          if self.n_remote else None)
        # Launch every local process before waiting on any port: worker
        # cold start (fresh interpreter + torch import + CUDA init) is seconds each, and
        # overlapping the spawns makes frontend startup cost ~one cold
        # start, not N. Remote workers are already up — attaching is just
        # connect + handshake.
        pendings: list[tuple | None] = []
        for idx, spec in enumerate(specs):
            pendings.append(local_spawner.launch(idx, f"{name}-worker-{idx}")
                            if spec is None else None)
        self._handles: list[_WorkerHandle] = []
        try:
            for idx, (spec, pending) in enumerate(zip(specs, pendings)):
                if spec is None:
                    spawned = local_spawner.connect(pending, spawn_timeout)
                else:
                    spawned = remote_spawner.attach(idx, spec[0], spec[1],
                                                    spawn_timeout)
                self._handles.append(_WorkerHandle(idx, spawned, self._ids,
                                                   self._note_death,
                                                   window=self.window))
        except Exception:
            for h in self._handles:
                h.close()
            for pending in pendings:
                if pending is None:
                    continue
                proc = pending[1]
                if proc.is_alive():
                    proc.terminate()
                    proc.join(timeout=shutdown_grace)
                if proc.is_alive():
                    proc.kill()
                    proc.join(timeout=shutdown_grace)  # reap, don't zombie
            raise
        # The supervisor: a single daemon thread that ticks every
        # heartbeat_secs — probing leases, sweeping expired deadlines, and
        # respawning declared-dead local workers. One thread for the whole
        # fleet (not per-worker): probes are answered inline on the
        # worker's connection thread, so a tick is N cheap sends.
        self._supervisor_stop = threading.Event()
        self._supervisor: threading.Thread | None = None
        if self._hb_secs > 0:
            self._supervisor = threading.Thread(
                target=self._supervise, name="cluster-supervisor",
                daemon=True)
            self._supervisor.start()

    # ------------------------------------------------------------ supervisor
    def _supervise(self) -> None:
        """Lease probes + deadline sweep + respawn, every heartbeat tick.

        The lease is what distinguishes *dead* from *slow*: a worker busy
        with replay still answers heartbeats inline on its connection
        thread, so only ``lease_misses`` consecutive silent ticks —
        ``heartbeat_secs × lease_misses`` of total silence — expire the
        lease and declare the worker dead proactively, instead of waiting
        for a socket error that a wedged-but-connected process never
        produces.
        """
        while not self._supervisor_stop.wait(self._hb_secs):
            if self._closed:
                return
            now = time.monotonic()
            for h in list(self._handles):
                if h.alive:
                    self.deadline_failures += h.expire_deadlines(now)
                    before = h.heartbeat_misses_total
                    expired = h.heartbeat_tick(self._lease_misses)
                    self.heartbeat_misses += h.heartbeat_misses_total - before
                    if expired:
                        h._mark_dead()
                if not h.alive and h.kind == "local" and not self._closed:
                    self._maybe_respawn(h)

    def _maybe_respawn(self, handle: "_WorkerHandle") -> None:
        """Restart a dead local worker's slot, warm, with capped backoff.

        The replacement comes back *warm*: every tenant routed to this slot
        is re-registered with the frontend-held TDG + artifact bytes, so
        its first request hydrates instead of re-lowering. The new handle
        is only published after re-registration — a submit racing the
        respawn either sees the dead handle (and fails over / retries) or
        a fully re-registered live one, never a half-registered worker.
        """
        idx = handle.idx
        state = self._respawn_state.setdefault(
            idx, {"attempts": 0, "next": 0.0})
        now = time.monotonic()
        if (self._local_spawner is None or handle.spawned.spawner is None
                or state["attempts"] >= self._respawn_max
                or now < state["next"]):
            return
        state["attempts"] += 1
        delay = min(_BACKOFF_CAP,
                    _BACKOFF_BASE * (2 ** (state["attempts"] - 1)))
        state["next"] = now + delay * (1.0 + random.random())
        try:
            spawned = handle.spawned.respawn(timeout=self._spawn_timeout)
        except Exception:
            self.respawn_failures += 1
            return
        if self._closed:        # close() won the race; don't leak the child
            try:
                spawned.conn.close()
            finally:
                if spawned.process is not None:
                    spawned.process.terminate()
                    spawned.process.join(timeout=self.shutdown_grace)
                    if spawned.process.is_alive():
                        spawned.process.kill()
            return
        new_handle = _WorkerHandle(idx, spawned, self._ids,
                                   self._note_death, window=self.window)
        with self._lock:
            # The replacement is a blank process: every pin group must
            # re-ship on next reference.
            self._shipped_pins = {(w, k) for (w, k) in self._shipped_pins
                                  if w != idx}
            routed = [r for r in self._tenants.values() if r.worker == idx]
        try:
            for record in routed:
                self._register_on(idx, record, handle=new_handle)
        except Exception:
            # Re-registration failed (replacement died immediately?):
            # count it, tear the new handle down, leave the slot dead for
            # the next tick's backoff.
            self.respawn_failures += 1
            new_handle.close()
            return
        self._handles[idx] = new_handle
        state["attempts"] = 0       # healthy again: reset the backoff
        self.respawns += 1
    def __enter__(self) -> "ClusterFrontend":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        """Shut down the fleet; local processes are *guaranteed* reaped.

        Every worker gets a best-effort shutdown RPC and a connection
        close. For a locally spawned worker that is where best-effort
        ends: a process that ignores the RPC and survives
        ``join(shutdown_grace)`` is escalated to ``terminate()`` (SIGTERM)
        and then ``kill()`` (SIGKILL, unmaskable), and a survivor even of
        that raises :class:`ClusterError` — a leaked worker holds
        device memory and a port, so "probably exited" is not an
        acceptable postcondition. Remote workers are not ours to reap: the
        shutdown RPC + close is all the frontend can (and should) do;
        their lifecycle belongs to whoever bootstrapped them.
        """
        with self._lock:
            if self._closed:
                return
            self._closed = True
        # Stop the supervisor BEFORE touching handles: a respawn racing
        # the teardown would re-create workers we are about to reap.
        self._supervisor_stop.set()
        if self._supervisor is not None:
            self._supervisor.join(timeout=max(self.shutdown_grace,
                                              2 * self._hb_secs + 5.0))
        for h in self._handles:
            if h.alive:
                try:
                    h.request({"op": "shutdown"}, timeout=30.0)
                except Exception:       # dying worker: we're tearing down
                    pass
            h.close()
        leaked = []
        for h in self._handles:
            if h.process is None:       # remote: RPC + close was the job
                continue
            h.process.join(timeout=self.shutdown_grace)
            if h.process.is_alive():
                h.process.terminate()
                h.process.join(timeout=self.shutdown_grace)
            if h.process.is_alive():
                h.process.kill()
                h.process.join(timeout=self.shutdown_grace)
            if h.process.is_alive():
                leaked.append(h)
        if leaked:
            raise ClusterError(
                "leaked worker process(es) survived terminate+kill: "
                + ", ".join(f"worker {h.idx} (pid {h.process.pid})"
                            for h in leaked))

    def _note_death(self, idx: int) -> None:
        with self._lock:
            if not self._closed:     # orderly shutdown is not a death
                self.worker_deaths += 1

    def _alive(self) -> set[int]:
        return {h.idx for h in self._handles if h.alive}

    # --------------------------------------------------------------- tenants
    def register_tenant(self, name: str, tdg: TDG | None = None, *,
                        outputs: tuple[str, ...] | None = None,
                        kernel_mode: str | None = None,
                        warm_path: str | None = None,
                        pinned: Mapping[str, Any] | None = None,
                        tier: int | None = None,
                        rate: float | None = None
                        ) -> _TenantRecord:
        """Route + register a tenant on its structure-sticky worker.

        ``tier`` / ``rate`` are the tenant's QoS config (priority tier and
        token-bucket req/s); they ship with the registration so the worker
        enforces them at ITS admission queue, and re-ship on every
        failover/respawn re-registration. ``None`` defers to the worker's
        ``REPRO_TENANT_TIER`` / ``REPRO_TENANT_RATE`` environment.

        Exactly one of ``tdg`` / ``warm_path`` selects the region source,
        mirroring ``RegionServer.register_tenant``. With ``warm_path``, the
        frontend reads the TDG JSON *and* the ``.aot`` sidecar bytes; the
        sidecar ships in-band so the worker hydrates instead of
        re-lowering. ``pinned`` buffers (e.g. model params) are grouped by
        object identity and shipped at most once per worker; tenants
        passing the same objects alias one decoded copy worker-side (so
        the coalescer broadcasts them instead of stacking), and ``submit``
        only carries the varying slots.
        """
        if (tdg is None) == (warm_path is None):
            raise ValueError("pass exactly one of tdg= or warm_path=")
        artifact = None
        if warm_path is not None:
            with open(warm_path) as f:
                tdg_dict = json.load(f)
            tdg = _serialize.tdg_from_dict(tdg_dict, self.local_registry)
            aot_path = str(warm_path) + ".aot"
            if os.path.exists(aot_path):
                with open(aot_path, "rb") as f:
                    artifact = f.read()
        else:
            tdg.validate()
            tdg_dict = _serialize.tdg_to_dict(tdg, self.local_registry)
        mode = _kreg.resolved_mode(kernel_mode)
        sig, _slot_map, payloads = structure_signature(
            tdg, list(outputs) if outputs is not None else None)
        route_key = (sig, tuple(self.local_registry.name_of(p)
                                for p in payloads), mode)
        record = _TenantRecord(name, tdg_dict,
                               tuple(outputs) if outputs else None,
                               mode, route_key,
                               tier=(None if tier is None
                                     else max(0, int(tier))),
                               rate=(None if rate is None
                                     else max(0.0, float(rate))))
        record.artifact = artifact
        if pinned is not None:
            record.pin_key = self._pin_group_for(dict(pinned))
        with self._lock:
            if name in self._tenants:
                raise ValueError(f"tenant {name!r} already registered")
            self._tenants[name] = record
        try:
            widx = self.router.route(route_key, self._alive())
            self._register_on(widx, record)
        except Exception:
            # Leave no phantom behind: a failed registration must be
            # retryable under the same name after the caller fixes it.
            with self._lock:
                self._tenants.pop(name, None)
            raise
        return record

    def _pin_group_for(self, pinned: dict) -> str:
        """The identity-keyed pin group for this buffer set (created once).

        Two tenants registering with the *same objects* (e.g. one params
        pytree) resolve to the same group, so the data crosses the wire
        once per worker and every tenant aliases one decoded copy there.
        The group dict pins strong refs, which keeps the ``id()`` key sound.
        """
        ident = tuple(sorted((k, id(v)) for k, v in pinned.items()))
        with self._lock:
            key = self._pin_ids.get(ident)
            if key is None:
                key = f"pin{len(self._pin_ids)}"
                self._pin_ids[ident] = key
                self._pin_data[key] = pinned
            return key

    def _register_on(self, widx: int, record: _TenantRecord,
                     handle: "_WorkerHandle | None" = None) -> dict:
        # ``handle`` overrides the published table during a respawn: the
        # replacement must be fully registered BEFORE it appears in
        # self._handles (submits racing the respawn must never see a
        # half-registered worker). Registrations are serialized, so the
        # failovers of several tenants racing onto one sibling ship their
        # pin group (a model's params) once, not once per tenant.
        with self._register_lock:
            return self._register_locked(widx, record, handle)

    def _register_locked(self, widx: int, record: _TenantRecord,
                         handle: "_WorkerHandle | None") -> dict:
        msg = {"op": "register", "tenant": record.name,
               "tdg": record.tdg_dict,
               "outputs": list(record.outputs) if record.outputs else None,
               "kernel_mode": record.kernel_mode,
               "pin_key": record.pin_key,
               "tier": record.tier, "rate": record.rate}
        ship_pin = False
        if record.pin_key is not None:
            with self._lock:
                ship_pin = (widx, record.pin_key) not in self._shipped_pins
            if ship_pin:
                msg["pinned"] = self._pin_data[record.pin_key]
        if self.ship_artifacts and record.artifact is not None:
            artifact = record.artifact
            if _faults.ENABLED:
                # Chaos hook: a "corrupt" rule poisons the shipped bytes —
                # the worker must reject them loudly (aot_hydrate_failures)
                # and re-lower, never crash.
                artifact = _faults.corrupt_artifact(artifact)
            msg["artifact"] = artifact
        reply = (handle if handle is not None
                 else self._handles[widx]).request(msg)
        record.worker = widx
        with self._lock:
            if ship_pin:
                self._shipped_pins.add((widx, record.pin_key))
                self.pin_groups_shipped += 1
            if msg.get("artifact") is not None:
                self.artifacts_shipped += 1
                self.artifact_bytes_shipped += len(record.artifact)
        return reply

    def tenant(self, name: str) -> _TenantRecord:
        with self._lock:
            if name not in self._tenants:
                raise KeyError(f"unknown tenant {name!r}; registered: "
                               f"{sorted(self._tenants)}")
            return self._tenants[name]

    def warmup(self, name: str, buffers: Mapping[str, Any],
               timeout: float | None = 600.0) -> dict:
        """Export ``name``'s replay program on its worker; hold the artifact
        for shipping.

        ``buffers`` are the request's (the worker merges the tenant's pinned
        buffers in, as for a submit). The worker returns the program as
        bytes; the frontend keeps them on the tenant record so a *future*
        worker (failover sibling, or a scale-out registration) hydrates
        instead of exporting again. Returns the worker's export report.
        """
        record = self.tenant(name)
        widx = self._worker_for(record)
        reply = self._handles[widx].request(
            {"op": "warmup", "tenant": name, "buffers": dict(buffers)},
            timeout=timeout)
        if reply.get("artifact") is not None:
            record.artifact = reply["artifact"]
        return reply["report"]

    # ------------------------------------------------------------ admission
    def _worker_for(self, record: _TenantRecord) -> int:
        """The tenant's current worker, failing over if it died."""
        widx = record.worker
        if widx is not None and self._handles[widx].alive:
            return widx
        return self._failover(record, exclude={widx} if widx is not None
                              else set())

    def _failover(self, record: _TenantRecord, exclude: set[int]) -> int:
        """Re-route ``record`` to a live sibling and re-register it there.

        Counted as a ``requeue`` whether the death was noticed before the
        send (stale ``record.worker``) or mid-flight (a failed future):
        either way this tenant's work just moved to a sibling.
        """
        widx = self.router.reroute(record.route_key, self._alive(), exclude)
        with self._lock:
            self.requeues += 1
        self._register_on(widx, record)
        return widx

    def submit(self, tenant_name: str, buffers: Mapping[str, Any],
               deadline_s: float | None = None) -> Future:
        """RPC front on ``RegionServer.submit``: returns a Future of the
        output buffer dict. A worker death mid-flight requeues the request
        to a sibling (or the slot's respawned replacement) with jittered
        backoff, up to the per-request retry budget; the request's
        deadline bounds the whole affair (``deadline_s`` seconds from now,
        default ``request_deadline`` / ``REPRO_REQUEST_DEADLINE``; pass 0
        to disable). Payloads are pure functions over explicit buffers, so
        a retried request is safe to re-execute.

        This is the frontend's hot path and it takes NO frontend-wide
        lock: the tenant lookup is a GIL-atomic dict read, the closed
        check a plain bool, and the request counter a racy-benign
        increment — many submitting threads proceed in parallel straight
        into their worker's submit queue (the per-worker handoff is the
        only synchronization, and it is a queue append).
        """
        record = self._tenants.get(tenant_name)
        if record is None:
            raise KeyError(f"unknown tenant {tenant_name!r}; registered: "
                           f"{sorted(self._tenants)}")
        if self._closed:
            raise RuntimeError(f"frontend {self.name!r} is closed")
        record.requests += 1
        budget = deadline_s if deadline_s is not None \
            else self._request_deadline
        deadline = (time.monotonic() + budget
                    if budget is not None and budget > 0 else None)
        outer: Future = Future()
        self._submit_attempt(record, dict(buffers), outer,
                             retries=self._retry_budget, deadline=deadline)
        return outer

    def _submit_attempt(self, record: _TenantRecord, buffers: dict,
                        outer: Future, retries: int,
                        deadline: float | None) -> None:
        try:
            widx = self._worker_for(record)
            inner = self._handles[widx].submit_async(record.name, buffers,
                                                     deadline=deadline)
        except WorkerDied as exc:
            self._retry_or_fail(record, buffers, outer, retries, exc,
                                {record.worker} if record.worker is not None
                                else set(), deadline)
            return
        except Exception as exc:
            outer.set_exception(exc)
            return

        def _done(f: Future) -> None:
            exc = f.exception()
            if isinstance(exc, WorkerDied):
                self._retry_or_fail(record, buffers, outer, retries, exc,
                                    {widx}, deadline)
            elif exc is not None:
                # DeadlineExceeded and QueueFull land here too: terminal by
                # design (the deadline has passed / the fleet is telling us
                # to back off — re-dispatching would amplify the overload).
                outer.set_exception(exc)
            else:
                outer.set_result(f.result()["out"])
        inner.add_done_callback(_done)

    def _retry_or_fail(self, record: _TenantRecord, buffers: dict,
                       outer: Future, retries: int, exc: Exception,
                       exclude: set[int], deadline: float | None) -> None:
        """Retry a ``WorkerDied`` request elsewhere, after jittered backoff.

        Runs on reader/callback threads, so it never sleeps: the delay is
        a ``threading.Timer``. The backoff matters on two axes — a mass
        death doesn't thundering-herd the surviving siblings, and it gives
        the supervisor a beat to respawn the slot (the exclusion set is
        re-intersected with the *live* fleet at fire time, so a respawned
        same-slot worker is eligible again — without that, a one-worker
        fleet could never recover).
        """
        if retries <= 0 or (deadline is not None
                            and time.monotonic() >= deadline):
            outer.set_exception(
                exc if deadline is None or time.monotonic() < deadline
                else DeadlineExceeded(
                    f"tenant {record.name!r}: deadline passed during "
                    f"failover ({exc})"))
            return
        with self._lock:
            self.retries += 1
        attempt = self._retry_budget - retries + 1
        delay = min(_BACKOFF_CAP, _BACKOFF_BASE * (2 ** (attempt - 1)))
        delay *= 0.5 + random.random()      # jitter: 0.5x..1.5x

        def _fire() -> None:
            if self._closed:
                outer.set_exception(ClusterError(
                    f"frontend {self.name!r} closed during failover"))
                return
            try:
                excl = set(exclude) & self._alive()
                self._failover(record, exclude=excl)
            except ClusterError:
                # No candidate yet (lone worker still respawning): burn a
                # retry and try again after another backoff.
                self._retry_or_fail(record, buffers, outer, retries - 1,
                                    exc, exclude, deadline)
                return
            except Exception as fail_exc:
                outer.set_exception(fail_exc)
                return
            self._submit_attempt(record, buffers, outer, retries - 1,
                                 deadline)
        t = threading.Timer(delay, _fire)
        t.daemon = True
        t.start()

    def serve(self, tenant_name: str, buffers: Mapping[str, Any],
              timeout: float | None = 120.0) -> dict:
        """Synchronous :meth:`submit`; ``timeout`` doubles as the request
        deadline, so a worker that can never answer yields a typed
        ``DeadlineExceeded`` rather than a bare futures timeout. The wait
        itself gets one supervisor tick of slack past the deadline — the
        sweep is what converts "no reply" into the typed error, and it
        must win the race against the raw futures timeout.
        """
        fut = self.submit(tenant_name, buffers, deadline_s=timeout)
        wait = (timeout + max(2 * self._hb_secs, 1.0)
                if timeout is not None else None)
        return fut.result(timeout=wait)

    # -------------------------------------------------------------- metrics
    def health(self) -> list[dict]:
        """Ping every worker; one row per worker (alive, kind, pid, address).

        ``process_alive`` is ``None`` for remote workers — the frontend has
        no process handle there; liveness is the connection + ping.
        ``topology`` is the fingerprint the worker advertised at handshake.
        """
        rows = []
        for h in self._handles:
            row = {"worker": h.idx, "alive": h.alive, "kind": h.kind,
                   "address": f"{h.address[0]}:{h.address[1]}",
                   "process_alive": (h.process.is_alive()
                                     if h.process is not None else None),
                   "topology": h.info.get("topology")}
            if h.alive:
                try:
                    reply = h.request({"op": "ping"}, timeout=30.0)
                    row.update(pid=reply["pid"], port=reply["port"])
                except Exception:
                    row["alive"] = False
            rows.append(row)
        return rows

    def stats(self) -> dict:
        """Frontend counters + per-worker server stats + cross-worker sums.

        The ``aggregate`` block sums every worker's serving metrics — the
        fields ``docs/serving.md`` glossaries, including
        ``aot_hydrate_failures``, so a worker that silently fell back to
        lazy lowering is visible at the fleet level.
        """
        per_worker: dict[int, dict | None] = {}
        for h in self._handles:
            if not h.alive:
                per_worker[h.idx] = None
                continue
            try:
                per_worker[h.idx] = h.request({"op": "stats"},
                                              timeout=60.0)["stats"]
            except Exception:
                per_worker[h.idx] = None
        metric_keys = ("admitted", "completed", "failed", "batches",
                       "coalesced_requests", "batch_fallbacks", "aot_served",
                       "aot_hydrate_failures", "aot_topology_rejects",
                       "shed", "deadline_sheds", "rate_limited",
                       "joins", "leaves")
        agg = {k: 0 for k in metric_keys}
        pool = {"hits": 0, "misses": 0, "evictions": 0, "hydrations": 0,
                "entries": 0}
        intern = {"hits": 0, "misses": 0, "evictions": 0, "entries": 0}
        hydrated_inband = 0
        for s in per_worker.values():
            if s is None:
                continue
            for k in metric_keys:
                agg[k] += s["metrics"].get(k, 0)
            for k in pool:
                pool[k] += s["pool"].get(k, 0)
            for k in intern:
                intern[k] += s["intern"].get(k, 0)
            hydrated_inband += s["worker"].get("hydrated_inband", 0)
        # Per-worker wire totals as observed from the frontend side of each
        # connection: REAL byte counts in both directions (rpc.RpcConnection
        # accounts frame sizes, not message counts), codec time
        # (encode/decode seconds), shm data-plane bytes, and the
        # dispatcher's framing stats (frames sent, entries per frame,
        # in-flight window occupancy, timeouts) — so a millisecond of
        # per-request overhead is attributable to codec, framing or
        # transport per worker, not a wall-clock mystery.
        wire: dict[int, dict] = {}
        wire_total = {"bytes_sent": 0, "bytes_received": 0,
                      "messages_sent": 0, "messages_received": 0,
                      "encode_seconds": 0.0, "decode_seconds": 0.0,
                      "shm_bytes_sent": 0, "shm_bytes_received": 0,
                      "frames_sent": 0, "entries_sent": 0, "timeouts": 0}
        shm_fallbacks = 0
        for h in self._handles:
            w = {**h.conn.wire_stats(), **h.dispatch_stats()}
            wire[h.idx] = {**w, "kind": h.kind, "shm_fallback": h.shm_fallback,
                           "address": f"{h.address[0]}:{h.address[1]}"}
            for k in wire_total:
                wire_total[k] += w[k]
            shm_fallbacks += 1 if h.shm_fallback else 0
        with self._lock:
            tenants = {r.name: {"worker": r.worker, "requests": r.requests,
                                "has_artifact": r.artifact is not None}
                       for r in self._tenants.values()}
            frontend = {
                "name": self.name,
                "workers": self.n_workers,
                "remote_workers": self.n_remote,
                "alive": len(self._alive()),
                "worker_deaths": self.worker_deaths,
                "requeues": self.requeues,
                "retries": self.retries,
                "respawns": self.respawns,
                "respawn_failures": self.respawn_failures,
                "heartbeat_misses": self.heartbeat_misses,
                "deadline_failures": self.deadline_failures,
                "supervisor": {
                    "enabled": self._hb_secs > 0,
                    "heartbeat_secs": self._hb_secs,
                    "lease_misses": self._lease_misses,
                    "respawn_max": self._respawn_max,
                    "request_deadline": self._request_deadline,
                    "retry_budget": self._retry_budget,
                },
                "artifacts_shipped": self.artifacts_shipped,
                "artifact_bytes_shipped": self.artifact_bytes_shipped,
                "pin_groups_shipped": self.pin_groups_shipped,
                "ship_artifacts": self.ship_artifacts,
                "transport": self.transport,
                "window": self.window,
                "shm_fallbacks": shm_fallbacks,
                "wire": wire_total,
            }
        return {"frontend": frontend, "tenants": tenants,
                "aggregate": {**agg, "pool": pool, "intern": intern,
                              "hydrated_inband": hydrated_inband},
                "workers": per_worker, "wire": wire}

    def trace(self) -> dict:
        """Per-worker execution-pattern trace rings (see metrics.TRACE_SCHEMA).

        Each live worker's ring comes back oldest-first under its index;
        a dead/unreachable worker maps to ``None``. Use this to see step
        occupancy, join/leave churn and stragglers fleet-wide — the
        aggregate counters in :meth:`stats` cannot show a detrimental
        execution *pattern*, only its average."""
        out: dict[int, dict | None] = {}
        for h in self._handles:
            if not h.alive:
                out[h.idx] = None
                continue
            try:
                reply = h.request({"op": "trace"}, timeout=60.0)
                out[h.idx] = {"records": reply["trace"],
                              "summary": reply["summary"]}
            except Exception:
                out[h.idx] = None
        return out
