"""Same-host shared-memory data plane for the cluster wire path.

Port of ``repro.serving.shm`` (it imports no JAX; the port keeps its own
copy).

TCP is a fine control plane, but for a locally spawned worker every tensor
blob sent through it is copied twice through kernel socket buffers. This
module gives :class:`~repro_torch.serving.rpc.RpcConnection` an optional data
plane: one ``multiprocessing.shared_memory`` ring per direction, carrying
only the *blob bytes* of a frame, while the (small) frame itself still
travels over the socket and merely references ring positions. The socket
stays the source of ordering and liveness — there is no cross-process
atomic anywhere in this file.

Design constraints, and how the ring meets them:

* **Single producer, single consumer.** Each ring is written by exactly one
  thread (the frontend's per-worker dispatcher, or the worker's reply
  writer — both send ``codec="binary"`` frames) and drained by exactly one
  reader thread. That discipline is what makes the *cumulative* ack below
  sound: blobs are consumed in the order they were allocated because one
  thread allocates and one thread (the peer's frame reader) consumes, in
  frame order.
* **Flow control over TCP, not shared counters.** The sender tracks an
  absolute ``head`` (bytes ever allocated) and ``tail`` (bytes the peer has
  confirmed consuming). After the receiver copies a frame's blobs out of
  the ring it sends a tiny ``shm-ack`` frame carrying the highest absolute
  end position it consumed; :meth:`ack` advances ``tail``. A full ring
  blocks :meth:`alloc` until an ack arrives — bounded memory, no busy-wait,
  no cross-process mutex.
* **Contiguous blobs.** ``alloc`` pads to the segment end rather than
  wrapping a blob, so :meth:`read` is always one slice. Blobs are capped at
  ``size // 2`` (``max_blob``): with that bound the pad-plus-blob need can
  never exceed the segment, so an empty ring always makes progress.
  Oversized blobs fall back to inline TCP placement in the frame codec.
* **Bounded hostile input.** :meth:`read` validates the (attacker-
  controlled, frame-supplied) position/length against the segment bounds
  and raises :class:`~repro_torch.serving.rpc.ProtocolError` — a bogus reference
  can yield garbage bytes (caught by the codec's dtype-times-shape check)
  but never an out-of-bounds access or a crash.

Lifecycle: the frontend *creates* both rings and offers their names to the
worker in a ``shm-setup`` control frame; the worker *attaches* (Python
3.10's ``SharedMemory`` has no ``track=False``, so the attach path
unregisters from the resource tracker to keep a worker exit from unlinking
segments the frontend still owns). The creator unlinks at close.
"""
from __future__ import annotations

import os
import secrets
import threading
import time
from multiprocessing import shared_memory

from . import faults as _faults
from .rpc import ProtocolError

#: Default per-direction ring size (bytes); override with
#: ``REPRO_RPC_SHM_BYTES``. Backed by tmpfs pages allocated lazily on
#: write, so an idle ring costs address space, not memory.
DEFAULT_RING_BYTES = 1 << 26


_attach_lock = threading.Lock()


def _attach_untracked(name: str) -> shared_memory.SharedMemory:
    """Attach to ``name`` without resource-tracker registration.

    ``SharedMemory(name=...)`` registers the segment with the attaching
    process's resource tracker, which would unlink it when that tracker
    winds down — destroying a segment the *creator* still owns (subprocess
    workers have their own tracker) or, when the tracker is shared
    (``multiprocessing``-spawned workers), cancelling the creator's own
    registration and spewing KeyErrors at unlink. Python 3.13 grew
    ``track=False``; on 3.10 the clean equivalent is suppressing the
    register call for the duration of the attach — unlike the
    unregister-after idiom, no tracker message is ever sent, so the
    creator's registration stays intact.
    """
    from multiprocessing import resource_tracker
    with _attach_lock:
        orig = resource_tracker.register
        resource_tracker.register = lambda *a, **k: None
        try:
            return shared_memory.SharedMemory(name=name)
        finally:
            resource_tracker.register = orig


class ShmRing:
    """One direction of the shared-memory data plane (SPSC byte ring)."""

    def __init__(self, seg: shared_memory.SharedMemory, size: int,
                 created: bool):
        if seg.size < size:
            seg.close()
            raise ProtocolError(
                f"shm segment {seg.name!r} is {seg.size} bytes, peer "
                f"announced {size}")
        self._seg = seg
        self.name = seg.name
        self.size = int(size)        # logical size: both sides mod by THIS,
        self.created = created       # never seg.size (page-rounded on attach)
        self.max_blob = self.size // 2
        self._head = 0               # absolute bytes allocated (sender side)
        self._tail = 0               # absolute bytes acked by the peer
        self._closed = False
        self._cv = threading.Condition()

    # ------------------------------------------------------------ lifecycle
    @classmethod
    def create(cls, size: int) -> "ShmRing":
        if size < 2:
            raise ValueError(f"ring size {size} is too small")
        name = f"repro-ring-{os.getpid()}-{secrets.token_hex(6)}"
        seg = shared_memory.SharedMemory(name=name, create=True, size=size)
        return cls(seg, size, created=True)

    @classmethod
    def attach(cls, name: str, size: int) -> "ShmRing":
        return cls(_attach_untracked(name), size, created=False)

    def close(self, unlink: bool | None = None) -> None:
        """Wake blocked allocators, release the mapping; creator unlinks."""
        with self._cv:
            if self._closed:
                return
            self._closed = True
            self._cv.notify_all()
        try:
            self._seg.close()
        except BufferError:
            # A racing read/write still exports a memoryview over the
            # mapping; the process-exit cleanup will drop it.
            pass
        if unlink if unlink is not None else self.created:
            try:
                self._seg.unlink()
            except FileNotFoundError:
                pass

    # --------------------------------------------------------------- sender
    def alloc(self, n: int, timeout: float = 120.0) -> int:
        """Reserve ``n`` contiguous bytes; returns the absolute position.

        Blocks (bounded by ``timeout``) while the peer owes acks for the
        space. ``ValueError`` for blobs that can never fit (callers fall
        back to inline placement); :class:`ProtocolError` on timeout or a
        closed ring (callers treat it as a dead connection).
        """
        if n > self.max_blob:
            raise ValueError(
                f"blob of {n} bytes exceeds the ring's {self.max_blob}-byte "
                "contiguity bound")
        deadline = time.monotonic() + timeout
        with self._cv:
            while True:
                if self._closed:
                    raise ProtocolError("shm ring closed while allocating")
                offset = self._head % self.size
                pad = self.size - offset if offset + n > self.size else 0
                if pad + n <= self.size - (self._head - self._tail):
                    self._head += pad            # skip the unusable tail-end
                    pos = self._head
                    self._head += n
                    return pos
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise ProtocolError(
                        f"shm ring full for {timeout}s (peer not acking); "
                        "treating the connection as dead")
                self._cv.wait(min(remaining, 1.0))

    def write(self, pos: int, data: bytes) -> None:
        offset = pos % self.size
        self._seg.buf[offset:offset + len(data)] = data

    def ack(self, pos: int) -> None:
        """Apply a peer ack: everything up to absolute ``pos`` is consumed."""
        if _faults.ENABLED:
            # Chaos hook: dropping an ack stalls the ring — the credit it
            # carried never lands, so a sender that fills the segment blocks
            # in alloc() until a LATER cumulative ack arrives (acks are
            # absolute positions, so one lost ack self-heals under further
            # traffic; a stalled *idle* ring is what the connection-close
            # wakeup and the supervisor's lease exist to break).
            action = _faults.on_point("ring_ack")
            if action == "drop":
                return
        with self._cv:
            if pos > self._tail:
                self._tail = pos
            self._cv.notify_all()

    # ------------------------------------------------------------- receiver
    def read(self, pos: int, n: int) -> bytes:
        """Copy one blob out. Bounds-checked: ``pos``/``n`` come off the
        wire and must never index outside the segment."""
        if not isinstance(pos, int) or not isinstance(n, int) \
                or pos < 0 or n < 0 or n > self.size:
            raise ProtocolError(
                f"shm blob reference (pos={pos!r}, len={n!r}) is not a "
                "sane segment span")
        offset = pos % self.size
        if offset + n > self.size:
            raise ProtocolError(
                f"shm blob reference overruns the ring segment "
                f"(offset {offset} + {n} > {self.size})")
        return bytes(self._seg.buf[offset:offset + n])

    # -------------------------------------------------------------- reports
    def stats(self) -> dict:
        with self._cv:
            return {"size": self.size, "allocated": self._head,
                    "acked": self._tail,
                    "outstanding": self._head - self._tail}


def negotiate_rings(conn, size: int | None = None) -> bool:
    """Client side of shm transport setup (run before any reader thread).

    Creates both rings, offers their names in a ``shm-setup`` frame, and
    attaches them to ``conn`` iff the peer reports a successful attach.
    Returns ``False`` — with both segments destroyed — when the peer
    refuses (worker pinned to tcp, cross-host attach failure) or segments
    cannot be created here; connection-level failures propagate, because a
    peer that breaks the socket mid-setup is a dead worker, not a
    transport downgrade.
    """
    size = DEFAULT_RING_BYTES if size is None else int(size)
    try:
        tx = ShmRing.create(size)
    except OSError:
        return False
    try:
        rx = ShmRing.create(size)
    except OSError:
        tx.close(unlink=True)
        return False
    try:
        conn.send({"op": "shm-setup", "id": 0, "tx": tx.name, "rx": rx.name,
                   "size": size})
        reply = conn.recv()
    except Exception:
        tx.close(unlink=True)
        rx.close(unlink=True)
        raise
    if not (isinstance(reply, dict) and reply.get("attached")):
        tx.close(unlink=True)
        rx.close(unlink=True)
        return False
    conn.attach_rings(send_ring=tx, recv_ring=rx)
    return True
