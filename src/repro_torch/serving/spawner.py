"""Worker spawners: how a ``ClusterFrontend`` obtains its worker fleet.

Port of ``repro.serving.spawner``. Two spawners with one contract, so local
and remote workers are interchangeable behind the same ``StickyRouter`` /
artifact-shipping / death-requeue machinery:

* :class:`LocalSpawner` — start a fresh process on this host running
  ``WorkerNode`` (the ``spawn`` start method: a fork after CUDA is
  initialized breaks the child's CUDA context), learn its ephemeral RPC port
  over a pipe, connect.
* :class:`RemoteSpawner` — the multi-host path: *attach* to a pre-started
  worker (``python -m repro_torch.serving.worker --bind HOST:PORT ...``) by TCP
  address. The frontend never owns the process — bootstrap is whatever the
  host fleet uses (ssh, k8s, systemd); the wire protocol is the whole
  contract.

Both return a :class:`SpawnedWorker` whose connection has already completed
the :func:`repro_torch.serving.rpc.client_handshake` (protocol version pinned,
token checked, worker identity + device-topology fingerprint captured), so
the frontend talks to every worker identically after this point.

Worker *specs* (the ``ClusterFrontend(workers=...)`` list form) are
strings: ``"host:port"`` attaches remotely, the literal ``"local"`` spawns
on this host — mixing both in one list is the expected shape for a
frontend that keeps some capacity local while farming the rest out.
"""
from __future__ import annotations

import dataclasses
import multiprocessing
import re
from typing import Any, Mapping

from . import faults as _faults
from . import rpc

#: ``host:port`` — hostname/IPv4 label followed by a port. (IPv6 literals
#: would need brackets; the serving tier targets DNS names and IPv4.)
_ADDR_RE = re.compile(r"^(?P<host>[A-Za-z0-9._-]+):(?P<port>\d{1,5})$")

#: The spec string that means "spawn a worker process on this host".
LOCAL_SPEC = "local"


def parse_worker_spec(spec: Any) -> tuple[str, int] | None:
    """Normalize one worker spec: ``None`` for local, ``(host, port)`` remote.

    Accepts the literal ``"local"`` (case-insensitive) or ``"host:port"``.
    Anything else — including a bare hostname with no port — is a
    ``ValueError`` naming the offending spec, so a typo'd fleet list fails
    at construction, not mid-registration.
    """
    if not isinstance(spec, str):
        raise ValueError(f"worker spec must be a string, got {spec!r}")
    if spec.strip().lower() == LOCAL_SPEC:
        return None
    m = _ADDR_RE.match(spec.strip())
    if m is None:
        raise ValueError(
            f"worker spec {spec!r} is neither 'local' nor 'host:port'")
    port = int(m.group("port"))
    if not 0 < port < 65536:
        raise ValueError(f"worker spec {spec!r} has an invalid port")
    return m.group("host"), port


@dataclasses.dataclass
class SpawnedWorker:
    """One ready worker: a handshaken connection plus provenance.

    ``process`` is the ``multiprocessing.Process`` for local workers and
    ``None`` for remote ones — the frontend's shutdown path keys off this
    (a local worker is joined/terminated/killed and asserted reaped; a
    remote worker gets a best-effort shutdown RPC and a connection close,
    because its lifecycle belongs to whoever bootstrapped it).
    """

    idx: int
    kind: str                      # "local" | "remote"
    address: tuple[str, int]
    conn: rpc.RpcConnection
    process: Any = None
    info: dict = dataclasses.field(default_factory=dict)   # handshake ack
    transport: str = "tcp"         # negotiated data plane: "tcp" | "shm"
    shm_fallback: bool = False     # shm was attempted and refused/failed
    spawner: Any = None            # producer, for respawn(); None = remote

    def respawn(self, timeout: float = 120.0) -> "SpawnedWorker":
        """Start a replacement worker in this one's slot.

        The self-healing contract the cluster supervisor builds on: reap
        whatever is left of this worker's process, spawn a fresh one, and
        hand back a new ready :class:`SpawnedWorker` with the same ``idx``.
        The replacement's first connection is **TCP-only** even when the
        spawner would normally negotiate shm — the death that got us here
        may have been mid-ring-write, and a clean control plane first is
        worth one counted ``shm_fallback`` (a later reconnect can upgrade).
        Remote workers are never respawned from here: their lifecycle
        belongs to whoever bootstrapped them (:class:`SpawnError`).
        """
        if self.spawner is None or self.kind != "local":
            raise SpawnError(
                f"worker {self.idx} ({self.kind}) cannot be respawned from "
                "this frontend — its process lifecycle is owned elsewhere")
        return self.spawner.respawn(self, timeout=timeout)


def _negotiate_transport(conn: rpc.RpcConnection, attempt: bool,
                         shm_bytes: int | None) -> tuple[str, bool]:
    """Try the shm data plane right after the handshake (single-threaded
    window: no reader thread exists yet, so the setup round-trip owns the
    connection). Returns ``(transport, fallback)`` — a refusal or attach
    failure is a TCP fallback, never an error; a *connection* failure
    mid-negotiation propagates (dead worker, not a transport downgrade)."""
    if not attempt:
        return "tcp", False
    from . import shm

    if shm.negotiate_rings(conn, size=shm_bytes):
        return "shm", False
    return "tcp", True


class SpawnError(RuntimeError):
    """A worker could not be spawned/attached (port never reported, TCP
    connect refused, handshake rejected)."""


def _worker_main(port_conn, registry_spec, registry_kwargs, server_kwargs,
                 token) -> None:
    """Spawned-process entry point: build the node, report the port, serve."""
    # Deferred import: this body runs in the child process; importing
    # cluster at module scope here would cycle (cluster imports spawner).
    from .cluster import WorkerNode, resolve_registry

    registry = resolve_registry(registry_spec, registry_kwargs)
    node = WorkerNode(registry, token=token, **(server_kwargs or {}))
    try:
        port_conn.send(node.port)
    finally:
        port_conn.close()
    node.serve_forever()


class LocalSpawner:
    """Spawn ``WorkerNode`` processes on this host via ``multiprocessing``.

    Two-phase on purpose: :meth:`launch` starts the process and returns
    immediately so a frontend can overlap N cold starts (a fresh
    interpreter + torch import + CUDA init is seconds each); :meth:`connect` then waits
    for the reported port, TCP-connects and handshakes.
    """

    def __init__(self, registry_spec: str,
                 registry_kwargs: Mapping[str, Any] | None,
                 server_kwargs: Mapping[str, Any] | None,
                 token: str | None, start_method: str = "spawn",
                 transport: str = "auto", shm_bytes: int | None = None):
        self.registry_spec = registry_spec
        self.registry_kwargs = dict(registry_kwargs or {})
        self.server_kwargs = dict(server_kwargs or {})
        self.token = token
        # "shm" and "auto" both attempt the shared-memory data plane for
        # spawned workers — same host is guaranteed here. The worker's own
        # policy (inherited env, since a spawned child shares os.environ
        # semantics of its start method, or an explicit --transport) can
        # still refuse, which lands as a counted TCP fallback.
        self.transport = rpc.transport_mode(transport)
        self.shm_bytes = shm_bytes
        self._ctx = multiprocessing.get_context(start_method)

    def launch(self, idx: int, name: str) -> tuple:
        if _faults.ENABLED:
            # Chaos hook: a "fail" rule here simulates a host that cannot
            # start workers (fork bomb protection, OOM) — the supervisor's
            # respawn backoff is what this exercises.
            _faults.on_point("spawn")
        parent_conn, child_conn = self._ctx.Pipe()
        proc = self._ctx.Process(
            target=_worker_main,
            args=(child_conn, self.registry_spec, self.registry_kwargs,
                  self.server_kwargs, self.token),
            name=name, daemon=True)
        proc.start()
        child_conn.close()
        return idx, proc, parent_conn

    def connect(self, pending: tuple, timeout: float,
                force_tcp: bool = False) -> SpawnedWorker:
        idx, proc, parent_conn = pending
        if not parent_conn.poll(timeout):
            raise SpawnError(f"worker {idx} did not report its RPC port "
                             f"within {timeout}s")
        port = parent_conn.recv()
        parent_conn.close()
        conn = rpc.connect("127.0.0.1", port, timeout=timeout)
        would_shm = self.transport in ("shm", "auto")
        try:
            info = rpc.client_handshake(conn, token=self.token)
            transport, fallback = _negotiate_transport(
                conn, would_shm and not force_tcp, self.shm_bytes)
        except Exception:
            conn.close()
            raise
        if force_tcp and would_shm:
            fallback = True     # shm deliberately suppressed; still counted
        return SpawnedWorker(idx=idx, kind="local",
                             address=("127.0.0.1", port), conn=conn,
                             process=proc, info=info,
                             transport=transport, shm_fallback=fallback,
                             spawner=self)

    def respawn(self, old: SpawnedWorker, timeout: float = 120.0
                ) -> SpawnedWorker:
        """Reap ``old``'s process and spawn a ready replacement in its slot.

        The replacement's first connection is TCP-only (see
        :meth:`SpawnedWorker.respawn`). The old connection is NOT touched
        here — the supervisor already closed it when it declared the worker
        dead (that close is what unlinks the shm rings and wakes any
        blocked dispatcher).
        """
        proc = old.process
        if proc is not None and proc.is_alive():
            # A declared-dead-but-breathing process (hung, stopped, or just
            # slow past its lease) must not linger beside its replacement.
            proc.terminate()
            proc.join(timeout=5.0)
            if proc.is_alive():
                proc.kill()
                proc.join(timeout=5.0)
        elif proc is not None:
            proc.join(timeout=5.0)      # reap the zombie
        name = getattr(proc, "name", None) or f"repro-worker-{old.idx}"
        pending = self.launch(old.idx, name)
        try:
            return self.connect(pending, timeout, force_tcp=True)
        except Exception:
            # The replacement never became ready; don't leak its process.
            _, proc2, _ = pending
            if proc2.is_alive():
                proc2.terminate()
                proc2.join(timeout=5.0)
                if proc2.is_alive():
                    proc2.kill()
            raise


class RemoteSpawner:
    """Attach to pre-started workers (``python -m repro_torch.serving.worker``).

    No process handle, no bootstrap: the worker is already listening
    wherever its host started it. Attachment is TCP connect + handshake;
    the ack's ``topology`` field is the remote device fingerprint the
    frontend surfaces in :meth:`ClusterFrontend.health`.
    """

    def __init__(self, token: str | None, transport: str = "auto",
                 shm_bytes: int | None = None):
        self.token = token
        # Remote default is tcp: "auto" only means shm for workers we
        # spawned ourselves (same host guaranteed). An explicit "shm"
        # still *attempts* it remotely — a "remote" address can point at
        # this host, and a wrong guess is just a counted fallback.
        self.transport = rpc.transport_mode(transport)
        self.shm_bytes = shm_bytes

    def attach(self, idx: int, host: str, port: int,
               timeout: float) -> SpawnedWorker:
        try:
            conn = rpc.connect(host, port, timeout=timeout)
        except OSError as exc:
            raise SpawnError(
                f"worker {idx}: cannot connect to {host}:{port} ({exc}) — "
                "is `python -m repro_torch.serving.worker` running there?"
            ) from exc
        try:
            info = rpc.client_handshake(conn, token=self.token)
            transport, fallback = _negotiate_transport(
                conn, self.transport == "shm", self.shm_bytes)
        except Exception:
            conn.close()
            raise
        return SpawnedWorker(idx=idx, kind="remote", address=(host, port),
                             conn=conn, info=info,
                             transport=transport, shm_fallback=fallback)
