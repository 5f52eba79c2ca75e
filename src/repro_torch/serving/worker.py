"""Standalone worker bootstrap: run a ``WorkerNode`` on any host.

Port of ``repro.serving.worker``; ``--device`` (default ``cuda``; with no
card it raises unless ``--device cpu``) is where the worker serves.

This is the multi-host entrypoint the cluster tier attaches to via
``ClusterFrontend(workers=["host:port", ...])`` — same wire protocol, same
``RegionServer`` semantics as a locally spawned worker, but the process is
started by whatever the fleet uses (ssh, k8s, systemd, a shell):

    PYTHONPATH=src python -m repro_torch.serving.worker \\
        --bind 0.0.0.0:7077 \\
        --registry repro_torch.serving.demo:DEMO_REGISTRY \\
        --token s3cret --device cuda

The worker prints one machine-parseable line once it is listening::

    REPRO_WORKER_READY host=0.0.0.0 port=7077 pid=12345

(``--bind host:0`` lets the OS pick the port — the READY line / the
``--port-file`` is then the only way to learn it, which is how the tests
bootstrap subprocess workers race-free.)

The ``--registry`` spec is the payload symbol table: TDGs arrive over the
wire as JSON referencing task payloads *by name* (the paper's
compiler-emitted-TDG contract), and this worker re-links them by importing
``module:attr`` — a ``TaskFnRegistry`` or a factory returning one
(``--registry-kwargs`` JSON is passed to a factory). Frontends must resolve
a registry with the same symbols.

``--token`` (default: ``$REPRO_RPC_TOKEN``) gates every connection via the
RPC handshake; without it the worker accepts any client that speaks the
protocol — fine on localhost, not on a shared network. Artifact bytes
shipped by a frontend are checked against this host's device-topology
fingerprint at register time and rejected loudly (counted in
``aot_topology_rejects``; the tenant re-lowers) when they were exported for
different hardware or another torch / CUDA version.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import threading

from .cluster import WorkerNode, resolve_registry

#: The READY-line contract, owned here next to its producer (``main``).
#: Tests parse it via :func:`spawn_worker_subprocess` instead of keeping
#: private copies.
READY_RE = re.compile(r"REPRO_WORKER_READY host=(\S+) port=(\d+)")


def spawn_worker_subprocess(registry_spec: str, token: str | None = None,
                            timeout: float = 120.0, extra_args=(),
                            ) -> tuple["subprocess.Popen", str]:
    """Bootstrap one worker subprocess on localhost; returns ``(proc, addr)``.

    The same-host analogue of an ssh/k8s bootstrap, used by the tests: a plain ``subprocess`` (never
    ``multiprocessing`` — the frontend must hold no process handle
    semantics beyond POSIX), ``--bind 127.0.0.1:0``, address learned from
    the READY line. stderr is merged into stdout (two separate pipes can
    deadlock once either fills) and a reader thread keeps draining the
    pipe for the worker's lifetime, so chatty warnings can never block it. ``timeout`` is enforced even if the child prints nothing:
    the reader is awaited via an event, and a child that missed the
    deadline or exited early is killed and reported.
    """
    import repro_torch

    src_dir = os.path.dirname(os.path.dirname(os.path.abspath(repro_torch.__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = src_dir + (os.pathsep + env["PYTHONPATH"]
                                   if env.get("PYTHONPATH") else "")
    cmd = [sys.executable, "-m", "repro_torch.serving.worker",
           "--bind", "127.0.0.1:0", "--registry", registry_spec]
    if token is not None:
        cmd += ["--token", token]
    cmd += list(extra_args)
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=env)
    ready = threading.Event()
    found: list[str] = []

    def _drain() -> None:
        for line in proc.stdout:
            if not ready.is_set():
                m = READY_RE.search(line)
                if m:
                    found.append(f"{m.group(1)}:{m.group(2)}")
                    ready.set()
        ready.set()                      # EOF: unblock the waiter either way

    t = threading.Thread(target=_drain, name="worker-bootstrap-drain",
                         daemon=True)
    t.start()
    if not ready.wait(timeout) or not found:
        proc.kill()
        proc.wait(timeout=10)
        raise RuntimeError(
            f"worker subprocess did not print REPRO_WORKER_READY within "
            f"{timeout}s (exit code {proc.poll()})")
    return proc, found[0]


def parse_bind(spec: str) -> tuple[str, int]:
    """``HOST:PORT`` -> ``(host, port)``; bare ``:PORT`` binds 127.0.0.1.

    Unlike ``spawner.parse_worker_spec`` (which addresses a peer), port 0
    is legal here — it means "let the OS pick". Out-of-range ports fail
    HERE with a clear message, not as an OverflowError out of ``bind()``.
    """
    host, sep, port = spec.rpartition(":")
    if not sep or not port.isdigit():
        raise ValueError(f"--bind {spec!r} is not HOST:PORT")
    port_num = int(port)
    if not 0 <= port_num < 65536:
        raise ValueError(f"--bind {spec!r}: port must be 0-65535")
    return host or "127.0.0.1", port_num


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.serving.worker",
        description="Bootstrap one cluster-tier worker: a RegionServer "
                    "behind the repro_torch.serving.rpc listener, ready for a "
                    "ClusterFrontend to attach by host:port.")
    ap.add_argument("--bind", default="127.0.0.1:0",
                    help="HOST:PORT to listen on (port 0 = OS-assigned; "
                         "read the REPRO_WORKER_READY line or --port-file)")
    ap.add_argument("--registry", required=True,
                    help="importable 'module:attr' TaskFnRegistry (or "
                         "factory) that re-links task payload symbols")
    ap.add_argument("--registry-kwargs", default=None, metavar="JSON",
                    help="JSON kwargs for a factory-style --registry spec")
    ap.add_argument("--token", default=os.environ.get("REPRO_RPC_TOKEN"),
                    help="handshake auth token (default: $REPRO_RPC_TOKEN; "
                         "unset = accept any client)")
    ap.add_argument("--port-file", default=None, metavar="PATH",
                    help="also write 'host port pid' to PATH (atomically) "
                         "once listening — for script bootstraps")
    ap.add_argument("--max-batch", type=int, default=8,
                    help="RegionServer coalescing ceiling")
    ap.add_argument("--max-wait-ms", type=float, default=2.0,
                    help="RegionServer admission window")
    ap.add_argument("--pool-capacity", type=int, default=64,
                    help="warm executable pool LRU bound")
    ap.add_argument("--queue-bound", type=int, default=None,
                    help="admission-queue depth bound; submissions beyond "
                         "it are shed with QueueFull (default: "
                         "$REPRO_QUEUE_BOUND or unbounded)")
    ap.add_argument("--transport", default=None,
                    choices=("tcp", "shm", "auto"),
                    help="data-plane policy for THIS worker (default: "
                         "$REPRO_RPC_TRANSPORT or auto): tcp refuses "
                         "frontend shm-setup offers, shm/auto attach when "
                         "the segments are reachable")
    ap.add_argument("--request-level", action="store_true",
                    help="use the legacy run-to-completion batch dispatcher "
                         "instead of continuous (iteration-level) batching "
                         "(default: continuous, or $REPRO_CONTINUOUS)")
    ap.add_argument("--device", default="cuda",
                    help="torch device the worker serves on (default cuda; "
                         "'cpu' runs on the CPU)")
    args = ap.parse_args(argv)

    host, port = parse_bind(args.bind)
    registry_kwargs = (json.loads(args.registry_kwargs)
                       if args.registry_kwargs else None)
    registry = resolve_registry(args.registry, registry_kwargs)
    node = WorkerNode(registry, host=host, port=port, token=args.token,
                      transport=args.transport, device=args.device,
                      max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
                      pool_capacity=args.pool_capacity,
                      queue_bound=args.queue_bound,
                      continuous=False if args.request_level else None)
    if args.port_file:
        tmp = args.port_file + ".tmp"
        with open(tmp, "w") as f:
            f.write(f"{host} {node.port} {os.getpid()}\n")
        os.replace(tmp, args.port_file)   # atomic: readers never see partial
    print(f"REPRO_WORKER_READY host={host} port={node.port} "
          f"pid={os.getpid()}", flush=True)
    node.serve_forever()
    print(f"repro_torch worker pid={os.getpid()} shut down", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
