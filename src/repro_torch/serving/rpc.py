"""Length-prefixed socket RPC: the cluster tier's wire layer.

Port of ``repro.serving.rpc`` with the same frames, byte for byte: codec
tags, blob placement, binary node tags and dtype names are the reference's,
so a frame written by either package decodes in the other, and the same
inputs encode to the same bytes.

The distributed frontend (:mod:`repro_torch.serving.cluster`) needs exactly four
things from a wire protocol, and nothing a heavyweight RPC stack would add:

* **Framing** — one message per frame, length-prefixed (``struct``
  big-endian), so a reader never has to guess where a message ends. A
  frame body is::

      [1B codec tag 'J'|'B'] [4B header len] [header]
      [4B blob count] { [1B placement] [payload] } * count

  where placement ``0`` inlines the blob (``[8B len] [bytes]``) and
  placement ``1`` references the connection's shared-memory ring
  (``[8B absolute pos] [8B len]`` — see :mod:`repro_torch.serving.shm`). The
  codec tag selects the header encoding: ``'J'`` is the JSON pytree
  skeleton (control frames: handshake, register, stats), ``'B'`` is the
  compact struct-packed binary codec below (the submit/result hot path,
  where JSON encode dominated per-request cost).

* **A pytree/tensor codec** — requests and replies carry buffer dicts whose
  leaves are torch tensors (``bfloat16`` and 0-d included; numpy arrays are
  taken too), nested arbitrarily in dicts/lists/tuples. :func:`encode` walks
  the tree into a header skeleton plus a list of raw binary blobs (a
  tensor's bytes, read after ``.detach().cpu()`` through a byte view, with
  numpy's dtype name; ``bytes`` values pass through untouched — that is how
  ``.aot`` artifact payloads ship in-band), and :func:`decode` rebuilds it
  exactly: tuples stay tuples, dict keys keep their types, arrays come back
  as CPU tensors with the recorded dtype/shape. Every blob an array node
  references is validated against ``dtype × shape`` before a tensor is made
  of it — a disagreeing length is a :class:`ProtocolError`, never a
  traceback from half-parsed attacker-controlled bytes. The
  binary header codec holds the same line: truncated nodes, bad tags,
  overrunning strings and bogus blob indices all surface as
  :class:`ProtocolError`, never a raw ``struct.error``.

* **Concurrent request/reply** — every message carries a caller-chosen
  ``id``; :class:`RpcConnection` serializes *writes* with a lock held only
  around ``sendall`` (frames are encoded outside it, so a slow encode
  never convoys other senders) and lets a single reader thread dispatch
  replies by id, so many in-flight requests share one socket.

* **A handshake** — the first exchange on a fresh connection
  (:func:`client_handshake` / :func:`server_handshake`) pins the protocol
  version and, when the listener was started with a token, authenticates
  the peer. Auth failures surface as :class:`AuthError` on both sides.

Array payloads are decoded to **CPU tensors**: one aligned, writable copy
of the blob's bytes, viewed as the recorded dtype (``bfloat16`` needs no
numpy extension dtype); the consumer moves them to its device. Frames are
received into one buffer and sent part by part, so a multi-GB frame (model
params pinned at registration) is not copied again to join or to prefix it.

The frame cap defaults to :data:`MAX_FRAME_BYTES` (8 GiB) and is
configurable via ``REPRO_RPC_MAX_FRAME`` (bytes) so deployments can bound
what a corrupt or hostile length prefix may allocate. Transport knobs —
``REPRO_RPC_TRANSPORT`` (``tcp|shm|auto``), ``REPRO_RPC_WINDOW``
(pipelining window), ``REPRO_RPC_SHM_BYTES`` / ``REPRO_RPC_SHM_MIN_BYTES``
(ring size / per-blob shm threshold) — are parsed here next to the wire
format they configure, as are the *liveness* knobs the cluster supervisor
consumes: ``REPRO_HEARTBEAT_SECS`` (lease probe period, ``<= 0`` disables)
and ``REPRO_LEASE_MISSES`` (consecutive unanswered probes before a worker
is declared dead). Heartbeat frames themselves (:data:`HEARTBEAT_OP`,
:func:`heartbeat_frame`) are the lightest message the protocol carries —
a two-key header, no blobs — and are answered on the worker's *connection*
thread, never queued behind replay work, which is exactly what lets the
supervisor tell a slow worker (acks heartbeats, results late) from a dead
one (acks nothing).

Both :meth:`RpcConnection.send` and :meth:`RpcConnection.recv` carry a
fault-injection hook (:mod:`repro_torch.serving.faults`) behind a single
module-bool guard — zero work on the hot path unless a chaos plan is
armed.

The connection accounts real wire traffic in both directions plus codec
time (``encode_seconds`` / ``decode_seconds``) and shm data-plane bytes,
so a millisecond of per-request overhead is attributable to framing,
codec, or transport instead of vanishing into a wall-clock delta.
"""
from __future__ import annotations

import json
import os
import socket
import struct
import threading
import time
from typing import Any

import numpy as np
import torch

from . import faults as _faults

_U32 = struct.Struct(">I")
_U64 = struct.Struct(">Q")
_I64 = struct.Struct(">q")
_F64 = struct.Struct(">d")
_SHM_REF = struct.Struct(">QQ")

#: Default frame cap: a frame larger than this is a protocol error, not a
#: request — refuse it instead of trying to allocate whatever a corrupt
#: length prefix asks for. The outer frame length is a u64 on the wire, so
#: the cap (not the prefix format) is what bounds allocation. Override per
#: deployment with ``REPRO_RPC_MAX_FRAME`` (see :func:`max_frame_bytes`).
MAX_FRAME_BYTES = 1 << 33

_MAX_FRAME_ENV = "REPRO_RPC_MAX_FRAME"
_TRANSPORT_ENV = "REPRO_RPC_TRANSPORT"
_WINDOW_ENV = "REPRO_RPC_WINDOW"
_SHM_BYTES_ENV = "REPRO_RPC_SHM_BYTES"
_SHM_MIN_ENV = "REPRO_RPC_SHM_MIN_BYTES"
_HEARTBEAT_ENV = "REPRO_HEARTBEAT_SECS"
_LEASE_ENV = "REPRO_LEASE_MISSES"

#: The heartbeat frame op. A probe is ``{"op": "hb", "id": N}``; the ack
#: echoes the id with ``{"op": "hb-ack", "id": N}``.
HEARTBEAT_OP = "hb"
HEARTBEAT_ACK_OP = "hb-ack"


def heartbeat_frame(mid: int) -> dict:
    """One lease probe (the smallest frame the protocol carries)."""
    return {"op": HEARTBEAT_OP, "id": mid}

#: Version pinned by the connection handshake. Bump when frames stop being
#: mutually intelligible; the handshake turns a skew into a loud
#: :class:`ProtocolError` instead of a hang or a garbage decode.
#: v2: codec-tagged frames, counted blob section with shm placements,
#: binary header codec, batch submit/result ops.
PROTOCOL_VERSION = 2

#: Frame cap applied to the *hello* frame specifically: an unauthenticated
#: peer gets 64 KiB to state its business, not the multi-GiB general cap —
#: pre-auth allocation must not be attacker-sized.
HELLO_MAX_BYTES = 1 << 16

#: Frame codec tags (the frame's first body byte — the "magic").
CODEC_JSON = 0x4A      # 'J'
CODEC_BINARY = 0x42    # 'B'

#: Blob placements inside the frame's blob section.
_PLACE_INLINE = 0
_PLACE_SHM = 1


def max_frame_bytes() -> int:
    """The effective frame cap: ``REPRO_RPC_MAX_FRAME`` or the default.

    Read per call (cheap: one env lookup) so long-lived workers honour an
    operator override without a restart dance in tests. An unparseable or
    non-positive value is a configuration error and raises
    :class:`ProtocolError` — silently falling back to 8 GiB would defeat
    the point of bounding allocation, and ProtocolError (rather than a
    bare ValueError) keeps the wire-path contract: reader loops treat it
    as a fatal connection error and fail pending work fast instead of
    dying silently.
    """
    raw = os.environ.get(_MAX_FRAME_ENV)
    if raw is None or not raw.strip():
        return MAX_FRAME_BYTES
    try:
        cap = int(raw)
    except ValueError:
        raise ProtocolError(
            f"{_MAX_FRAME_ENV}={raw!r} is not an integer byte count") from None
    if cap <= 0:
        raise ProtocolError(f"{_MAX_FRAME_ENV}={raw!r} must be positive")
    return cap


def transport_mode(explicit: str | None = None) -> str:
    """Resolve the transport selection: explicit arg, else env, else auto.

    ``tcp`` never sets up a shared-memory data plane; ``shm`` attempts it
    for every worker (falling back to tcp, counted, when a segment cannot
    attach); ``auto`` attempts it only for locally *spawned* workers —
    the one case where same-host is guaranteed rather than asserted.
    """
    raw = explicit if explicit is not None \
        else os.environ.get(_TRANSPORT_ENV, "auto")
    mode = str(raw).strip().lower()
    if mode not in ("tcp", "shm", "auto"):
        raise ValueError(
            f"transport must be tcp|shm|auto, got {raw!r} "
            f"(from {_TRANSPORT_ENV} when not passed explicitly)")
    return mode


def window_size(explicit: int | None = None) -> int:
    """Pipelining window: max batch frames in flight per connection."""
    raw = explicit if explicit is not None \
        else os.environ.get(_WINDOW_ENV, "8")
    try:
        window = int(raw)
    except (TypeError, ValueError):
        raise ValueError(
            f"{_WINDOW_ENV}={raw!r} is not an integer window") from None
    if window < 1:
        raise ValueError(f"pipelining window must be >= 1, got {window}")
    return window


def shm_ring_bytes(explicit: int | None = None) -> int:
    """Per-direction shm ring size (``REPRO_RPC_SHM_BYTES``, default 64 MiB)."""
    from .shm import DEFAULT_RING_BYTES

    raw = explicit if explicit is not None \
        else os.environ.get(_SHM_BYTES_ENV, str(DEFAULT_RING_BYTES))
    try:
        size = int(raw)
    except (TypeError, ValueError):
        raise ValueError(
            f"{_SHM_BYTES_ENV}={raw!r} is not an integer byte count") from None
    if size < 1 << 12:
        raise ValueError(f"shm ring of {size} bytes is too small to be useful")
    return size


def heartbeat_secs(explicit: float | None = None) -> float:
    """Lease probe period in seconds (``REPRO_HEARTBEAT_SECS``, default 2).

    ``<= 0`` disables the supervisor's heartbeat machinery entirely (death
    is then only noticed on socket error — the pre-supervisor behaviour).
    """
    raw = explicit if explicit is not None \
        else os.environ.get(_HEARTBEAT_ENV, "2.0")
    try:
        return float(raw)
    except (TypeError, ValueError):
        raise ValueError(
            f"{_HEARTBEAT_ENV}={raw!r} is not a number of seconds") from None


def lease_misses(explicit: int | None = None) -> int:
    """Consecutive unanswered probes before a worker is declared dead
    (``REPRO_LEASE_MISSES``, default 3). The lease a worker holds is
    ``heartbeat_secs * lease_misses`` of silence."""
    raw = explicit if explicit is not None \
        else os.environ.get(_LEASE_ENV, "3")
    try:
        misses = int(raw)
    except (TypeError, ValueError):
        raise ValueError(
            f"{_LEASE_ENV}={raw!r} is not an integer miss budget") from None
    if misses < 1:
        raise ValueError(f"lease miss budget must be >= 1, got {misses}")
    return misses


def _shm_min_bytes() -> int:
    """Per-blob threshold below which shm placement is not worth the ack."""
    try:
        return max(0, int(os.environ.get(_SHM_MIN_ENV, "1024")))
    except ValueError:
        return 1024


class ConnectionClosed(ConnectionError):
    """The peer closed the socket (EOF mid-frame or before one)."""


class ProtocolError(RuntimeError):
    """The bytes on the wire do not parse as a frame we wrote."""


class AuthError(ProtocolError):
    """The handshake failed authentication (missing or wrong token)."""


# ------------------------------------------------------- typed wire errors
#
# Remote failures cross the wire as strings ("TypeName: detail", the
# worker's str-formatting of the exception). Exception classes that must
# survive the round trip *typed* — so frontend callers can catch
# QueueFull/DeadlineExceeded/RateLimited instead of bare RuntimeError —
# register here by name; the frontend maps a detail string back through
# :func:`wire_error_class`. A registry (vs. a hard-coded tuple in
# cluster.py) keeps the set extensible without touching the mapping code.

_WIRE_ERRORS: dict[str, type] = {}


def register_wire_error(cls: type) -> type:
    """Register an exception class to be re-raised typed from wire errors."""
    _WIRE_ERRORS[cls.__name__] = cls
    return cls


def wire_error_class(detail: str) -> type | None:
    """The registered class a ``"TypeName: detail"`` string names, if any."""
    name, sep, _ = detail.partition(":")
    if sep and name in _WIRE_ERRORS:
        return _WIRE_ERRORS[name]
    return None


# ---------------------------------------------------------------- JSON codec

def _enc(obj: Any, blobs: list[bytes]) -> Any:
    if obj is None or isinstance(obj, (bool, str)):
        return {"t": "p", "v": obj}
    if isinstance(obj, (int, float)) and not isinstance(obj, np.generic):
        return {"t": "p", "v": obj}
    if isinstance(obj, (bytes, bytearray, memoryview)):
        blobs.append(bytes(obj))
        return {"t": "b", "i": len(blobs) - 1}
    if isinstance(obj, tuple):
        return {"t": "t", "v": [_enc(x, blobs) for x in obj]}
    if isinstance(obj, list):
        return {"t": "l", "v": [_enc(x, blobs) for x in obj]}
    if isinstance(obj, dict):
        return {"t": "d",
                "v": [[_enc(k, blobs), _enc(v, blobs)]
                      for k, v in obj.items()]}
    if hasattr(obj, "shape") and hasattr(obj, "dtype"):
        dtype_name, shape, blob = _array_blob(obj)
        blobs.append(blob)
        return {"t": "a", "i": len(blobs) - 1, "d": dtype_name, "s": shape}
    raise TypeError(f"rpc codec cannot encode {type(obj).__name__}: {obj!r}")


#: numpy's dtype names, the wire's, for every torch dtype that has one
_DTYPES = {name: getattr(torch, name) for name in (
    "float64", "float32", "float16", "bfloat16", "int64", "int32", "int16",
    "int8", "uint8", "uint16", "uint32", "uint64", "bool", "complex64",
    "complex128", "float8_e4m3fn", "float8_e5m2") if hasattr(torch, name)}
_DTYPE_NAMES = {dt: name for name, dt in _DTYPES.items()}


def _array_blob(obj: Any) -> tuple[str, list[int], memoryview]:
    """(dtype name, shape, bytes) of an array leaf: a torch tensor through
    ``.detach().cpu()`` and a byte view (no copy for a contiguous CPU
    tensor), anything else through numpy."""
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu().contiguous()
        name = _DTYPE_NAMES.get(t.dtype)
        if name is None:
            raise TypeError(f"rpc codec cannot encode a {t.dtype} tensor")
        return name, list(t.shape), memoryview(t.reshape(-1).view(torch.uint8).numpy())
    arr = np.ascontiguousarray(np.asarray(obj))
    return (str(arr.dtype), list(arr.shape),
            memoryview(arr.reshape(-1).view(np.uint8)))


def _blob(blobs: list, idx: Any):
    if not isinstance(idx, int) or not 0 <= idx < len(blobs):
        raise ProtocolError(
            f"blob index {idx!r} out of range (frame carries {len(blobs)})")
    return blobs[idx]


def _make_array(dtype_name: Any, shape: Any, blob) -> torch.Tensor:
    """Validated tensor materialization shared by both header codecs: one
    aligned, writable copy of the blob viewed as the dtype."""
    dtype = _DTYPES.get(dtype_name) if isinstance(dtype_name, str) else None
    if dtype is None:   # the callers wrap it, as numpy's own TypeError
        raise TypeError(f"data type {dtype_name!r} not understood")
    if not isinstance(shape, list) or not all(
            isinstance(d, int) and not isinstance(d, bool) and d >= 0
            for d in shape):
        raise ProtocolError(f"array node has invalid shape {shape!r}")
    want = torch.empty((), dtype=dtype).element_size()
    for d in shape:
        want *= d
    if len(blob) != want:
        raise ProtocolError(
            f"array blob of {len(blob)} bytes disagrees with "
            f"dtype {dtype_name} x shape {tuple(shape)} ({want} bytes)")
    raw = torch.empty(want, dtype=torch.uint8)
    if want:
        raw.numpy()[:] = np.frombuffer(blob, dtype=np.uint8)
    return raw.view(dtype).reshape(tuple(shape))


def _dec(node: Any, blobs: list[bytes]) -> Any:
    t = node["t"]
    if t == "p":
        return node["v"]
    if t == "b":
        return bytes(_blob(blobs, node["i"]))
    if t == "t":
        return tuple(_dec(x, blobs) for x in node["v"])
    if t == "l":
        return [_dec(x, blobs) for x in node["v"]]
    if t == "d":
        return {_dec(k, blobs): _dec(v, blobs) for k, v in node["v"]}
    if t == "a":
        return _make_array(node["d"], node["s"], _blob(blobs, node["i"]))
    raise ProtocolError(f"unknown codec node type {t!r}")


# -------------------------------------------------------------- binary codec
#
# The hot-path header encoding: one tag byte per node, fixed-width scalars,
# u32-counted containers. A submit/result frame's header is a few hundred
# bytes of struct packing instead of a json.dumps over a nested node tree —
# measured at roughly an order of magnitude less encode time for typical
# batch frames, which matters because encode used to run under the write
# lock and now merely runs per frame instead of per request.

_B_NONE = 0x00
_B_FALSE = 0x01
_B_TRUE = 0x02
_B_INT = 0x03       # 8B signed big-endian
_B_FLOAT = 0x04     # 8B IEEE double
_B_STR = 0x05       # u32 len + utf-8
_B_BYTES = 0x06     # u32 blob index
_B_TUPLE = 0x07     # u32 count + nodes
_B_LIST = 0x08      # u32 count + nodes
_B_DICT = 0x09      # u32 count + (key node, value node) pairs
_B_ARRAY = 0x0A     # u32 blob idx, u8 dtype len + ascii, u8 ndim, u32*dims


def _benc(obj: Any, out: list[bytes], blobs: list[bytes]) -> None:
    if obj is None:
        out.append(b"\x00")
    elif obj is False:
        out.append(b"\x01")
    elif obj is True:
        out.append(b"\x02")
    elif isinstance(obj, int) and not isinstance(obj, np.generic):
        try:
            out.append(bytes((_B_INT,)) + _I64.pack(obj))
        except struct.error:
            raise TypeError(
                f"rpc binary codec cannot encode int {obj!r} "
                "(exceeds 64-bit range; use the json codec)") from None
    elif isinstance(obj, float) and not isinstance(obj, np.generic):
        out.append(bytes((_B_FLOAT,)) + _F64.pack(obj))
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        out.append(struct.pack(">BI", _B_STR, len(raw)))
        out.append(raw)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        blobs.append(bytes(obj))
        out.append(struct.pack(">BI", _B_BYTES, len(blobs) - 1))
    elif isinstance(obj, tuple):
        out.append(struct.pack(">BI", _B_TUPLE, len(obj)))
        for x in obj:
            _benc(x, out, blobs)
    elif isinstance(obj, list):
        out.append(struct.pack(">BI", _B_LIST, len(obj)))
        for x in obj:
            _benc(x, out, blobs)
    elif isinstance(obj, dict):
        out.append(struct.pack(">BI", _B_DICT, len(obj)))
        for k, v in obj.items():
            _benc(k, out, blobs)
            _benc(v, out, blobs)
    elif hasattr(obj, "shape") and hasattr(obj, "dtype"):
        dtype_name, shape, blob = _array_blob(obj)
        blobs.append(blob)
        dt = dtype_name.encode("ascii")
        out.append(struct.pack(">BI", _B_ARRAY, len(blobs) - 1))
        out.append(struct.pack(">B", len(dt)))
        out.append(dt)
        out.append(struct.pack(">B", len(shape)))
        if shape:
            out.append(struct.pack(f">{len(shape)}I", *shape))
    else:
        raise TypeError(
            f"rpc codec cannot encode {type(obj).__name__}: {obj!r}")


def _bdec(data: bytes, pos: int, blobs: list[bytes]) -> tuple[Any, int]:
    if pos >= len(data):
        raise ProtocolError("binary header: truncated node (no tag byte)")
    tag = data[pos]
    pos += 1
    if tag == _B_NONE:
        return None, pos
    if tag == _B_FALSE:
        return False, pos
    if tag == _B_TRUE:
        return True, pos
    if tag == _B_INT:
        if pos + 8 > len(data):
            raise ProtocolError("binary header: truncated int node")
        return _I64.unpack_from(data, pos)[0], pos + 8
    if tag == _B_FLOAT:
        if pos + 8 > len(data):
            raise ProtocolError("binary header: truncated float node")
        return _F64.unpack_from(data, pos)[0], pos + 8
    if tag == _B_STR:
        if pos + 4 > len(data):
            raise ProtocolError("binary header: truncated string length")
        (n,) = _U32.unpack_from(data, pos)
        pos += 4
        if pos + n > len(data):
            raise ProtocolError(
                f"binary header: string of {n} bytes overruns the header")
        try:
            return data[pos:pos + n].decode("utf-8"), pos + n
        except UnicodeDecodeError as exc:
            raise ProtocolError(
                f"binary header: string is not valid utf-8 ({exc})") from exc
    if tag == _B_BYTES:
        if pos + 4 > len(data):
            raise ProtocolError("binary header: truncated blob index")
        (idx,) = _U32.unpack_from(data, pos)
        return bytes(_blob(blobs, idx)), pos + 4
    if tag in (_B_TUPLE, _B_LIST, _B_DICT):
        if pos + 4 > len(data):
            raise ProtocolError("binary header: truncated container count")
        (n,) = _U32.unpack_from(data, pos)
        pos += 4
        # Each element costs >= 1 byte, so a count beyond the remaining
        # header is a lie — fail fast instead of looping 4 billion times.
        if n > len(data) - pos:
            raise ProtocolError(
                f"binary header: container count {n} overruns the header")
        if tag == _B_DICT:
            items = {}
            for _ in range(n):
                k, pos = _bdec(data, pos, blobs)
                v, pos = _bdec(data, pos, blobs)
                try:
                    items[k] = v
                except TypeError as exc:
                    raise ProtocolError(
                        f"binary header: unhashable dict key ({exc})") from exc
            return items, pos
        vals = []
        for _ in range(n):
            v, pos = _bdec(data, pos, blobs)
            vals.append(v)
        return (tuple(vals) if tag == _B_TUPLE else vals), pos
    if tag == _B_ARRAY:
        if pos + 5 > len(data):
            raise ProtocolError("binary header: truncated array node")
        (idx,) = _U32.unpack_from(data, pos)
        dt_len = data[pos + 4]
        pos += 5
        if pos + dt_len + 1 > len(data):
            raise ProtocolError("binary header: truncated array dtype")
        try:
            dtype_name = data[pos:pos + dt_len].decode("ascii")
        except UnicodeDecodeError as exc:
            raise ProtocolError(
                f"binary header: array dtype is not ascii ({exc})") from exc
        pos += dt_len
        ndim = data[pos]
        pos += 1
        if pos + 4 * ndim > len(data):
            raise ProtocolError("binary header: truncated array dims")
        shape = list(struct.unpack_from(f">{ndim}I", data, pos)) if ndim \
            else []
        pos += 4 * ndim
        try:
            return _make_array(dtype_name, shape, _blob(blobs, idx)), pos
        except ProtocolError:
            raise
        except (TypeError, ValueError) as exc:
            raise ProtocolError(
                f"malformed codec node ({type(exc).__name__}: {exc})") from exc
    raise ProtocolError(f"unknown binary codec tag 0x{tag:02x}")


# ------------------------------------------------------------ frame assembly

def _frame_parts(obj: Any, codec: str = "json", ring=None,
                 shm_min: int = 0) -> tuple[list, int, int]:
    """Build one frame body as a list of parts; returns ``(parts, body
    length, shm_payload_bytes)``.

    ``ring`` (the connection's send ring) routes blobs of at least
    ``shm_min`` bytes through the shared-memory data plane; everything else
    — anything exceeding the ring's contiguity bound, and whatever would
    take this frame's span of the ring past its size — is inlined. The last
    rule keeps a frame larger than the ring from waiting on its own ack
    (the peer acks a frame only after it arrives). Ring allocation order
    equals frame order because each ring has exactly one producing thread
    (see :mod:`repro_torch.serving.shm`).
    """
    blobs: list = []
    if codec == "json":
        header = json.dumps(_enc(obj, blobs)).encode("utf-8")
        tag = CODEC_JSON
    elif codec == "binary":
        hparts: list[bytes] = []
        _benc(obj, hparts, blobs)
        header = b"".join(hparts)
        tag = CODEC_BINARY
    else:
        raise ValueError(f"unknown frame codec {codec!r}")
    parts = [bytes((tag,)), _U32.pack(len(header)), header,
             _U32.pack(len(blobs))]
    shm_bytes = 0
    first = span = None
    for b in blobs:
        n = len(b)
        if (ring is not None and shm_min <= n <= ring.max_blob
                and (span or 0) + 2 * n <= ring.size):
            pos = ring.alloc(n)
            ring.write(pos, b)
            first = pos if first is None else first
            span = pos + n - first
            parts.append(bytes((_PLACE_SHM,)))
            parts.append(_SHM_REF.pack(pos, n))
            shm_bytes += n
        else:
            parts.append(bytes((_PLACE_INLINE,)))
            parts.append(_U64.pack(n))
            parts.append(b)
    return parts, sum(len(p) for p in parts), shm_bytes


#: Parts at least this large are sent as they are; smaller ones are joined
#: first, so a frame of many small leaves is not many small sends.
_SEND_JOIN_BYTES = 1 << 20


def _send_parts(sock: socket.socket, parts: list) -> None:
    pending: list = []
    size = 0
    for p in parts:
        if len(p) >= _SEND_JOIN_BYTES:
            if pending:
                sock.sendall(b"".join(pending))
                pending, size = [], 0
            sock.sendall(p)
        else:
            pending.append(p)
            size += len(p)
            if size >= _SEND_JOIN_BYTES:
                sock.sendall(b"".join(pending))
                pending, size = [], 0
    if pending:
        sock.sendall(b"".join(pending))


def _decode_frame(data, ring=None) -> tuple[Any, int | None, int]:
    """Parse one frame body; returns ``(obj, shm_ack_end, shm_bytes)``.

    ``shm_ack_end`` is the highest absolute ring position this frame
    consumed (``None`` for a pure-TCP frame) — the receiver acks it back
    so the sender can reuse the span. Every malformed shape a peer could
    produce raises :class:`ProtocolError`.
    """
    if len(data) < 1 + _U32.size:
        raise ProtocolError("truncated frame: missing header length")
    tag = data[0]
    if tag not in (CODEC_JSON, CODEC_BINARY):
        raise ProtocolError(
            f"unknown frame codec tag 0x{tag:02x} (bad magic byte)")
    (hlen,) = _U32.unpack_from(data, 1)
    off = 1 + _U32.size
    if off + hlen > len(data):
        raise ProtocolError("truncated frame: header overruns body")
    view = memoryview(data)
    header_bytes = bytes(view[off:off + hlen])
    off += hlen
    if off + _U32.size > len(data):
        raise ProtocolError("truncated frame: missing blob count")
    (nblobs,) = _U32.unpack_from(data, off)
    off += _U32.size
    blobs: list = []
    ack_end: int | None = None
    shm_bytes = 0
    for _ in range(nblobs):
        if off + 1 > len(data):
            raise ProtocolError("truncated frame: missing blob placement")
        placement = data[off]
        off += 1
        if placement == _PLACE_INLINE:
            if off + _U64.size > len(data):
                raise ProtocolError("truncated frame: blob length")
            (blen,) = _U64.unpack_from(data, off)
            off += _U64.size
            if off + blen > len(data):
                raise ProtocolError("truncated frame: blob overruns body")
            blobs.append(view[off:off + blen])
            off += blen
        elif placement == _PLACE_SHM:
            if off + _SHM_REF.size > len(data):
                raise ProtocolError("truncated frame: shm blob reference")
            pos, blen = _SHM_REF.unpack_from(data, off)
            off += _SHM_REF.size
            if ring is None:
                raise ProtocolError(
                    "frame references a shm blob but this connection has "
                    "no ring attached")
            blobs.append(ring.read(pos, blen))
            shm_bytes += blen
            end = pos + blen
            ack_end = end if ack_end is None else max(ack_end, end)
        else:
            raise ProtocolError(f"unknown blob placement {placement!r}")
    if off != len(data):
        raise ProtocolError(
            f"frame has {len(data) - off} trailing bytes after the blob "
            "section")
    if tag == CODEC_JSON:
        try:
            header = json.loads(header_bytes.decode("utf-8"))
        except (ValueError, UnicodeDecodeError) as exc:
            raise ProtocolError(
                f"frame header is not valid JSON: {exc}") from exc
        try:
            return _dec(header, blobs), ack_end, shm_bytes
        except ProtocolError:
            raise
        except (KeyError, TypeError, ValueError, RecursionError) as exc:
            raise ProtocolError(
                f"malformed codec node ({type(exc).__name__}: {exc})") from exc
    try:
        obj, end_pos = _bdec(header_bytes, 0, blobs)
    except ProtocolError:
        raise
    except (struct.error, IndexError, TypeError, ValueError,
            RecursionError) as exc:
        raise ProtocolError(
            f"malformed codec node ({type(exc).__name__}: {exc})") from exc
    if end_pos != len(header_bytes):
        raise ProtocolError(
            f"binary header has {len(header_bytes) - end_pos} trailing bytes")
    return obj, ack_end, shm_bytes


def encode(obj: Any, codec: str = "json") -> bytes:
    """Serialize ``obj`` to a frame body (all blobs inlined — no ring)."""
    return b"".join(_frame_parts(obj, codec=codec)[0])


def decode(data: bytes) -> Any:
    """Inverse of :func:`encode`.

    Anything a peer could have actually put on the wire fails as
    :class:`ProtocolError` — malformed JSON, missing node keys, bogus
    dtypes, truncated binary nodes — never as a raw ``KeyError`` /
    ``struct.error`` from half-parsed bytes (the reader loops treat
    ``ProtocolError`` as a fatal connection error; an unexpected exception
    type would kill them silently). Frames carrying shm blob references
    require a connection with an attached ring and are rejected here.
    """
    return _decode_frame(data)[0]


# ------------------------------------------------------------------- framing

def _recv_exact(sock: socket.socket, n: int,
                deadline: float | None = None) -> bytearray:
    """Read exactly ``n`` bytes into one buffer; ``deadline``
    (``time.monotonic`` value) is an ABSOLUTE bound across all chunks — a
    peer trickling one byte per idle-timeout window cannot stretch it (each
    chunk's socket timeout is the *remaining* budget)."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        if deadline is not None:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise ProtocolError(f"deadline exceeded after {got}/{n} bytes")
            sock.settimeout(remaining)
        try:
            k = sock.recv_into(view[got:], min(n - got, 1 << 24))
        except socket.timeout:
            raise ProtocolError(
                f"deadline exceeded after {got}/{n} bytes") from None
        if not k:
            raise ConnectionClosed("peer closed the connection")
        got += k
    return buf


def send_msg(sock: socket.socket, obj: Any) -> int:
    """Encode + frame + send one message; returns bytes written."""
    parts, n, _ = _frame_parts(obj)
    cap = max_frame_bytes()
    if n > cap:
        raise ProtocolError(
            f"frame of {n} bytes exceeds the {cap}-byte cap "
            f"(raise {_MAX_FRAME_ENV} if this payload is legitimate)")
    _send_parts(sock, [_U64.pack(n)] + parts)
    return _U64.size + n


def recv_msg_sized(sock: socket.socket, cap: int | None = None,
                   deadline: float | None = None) -> tuple[Any, int]:
    """Receive one framed message; returns ``(obj, wire_bytes_consumed)``.

    The byte count is the real on-wire size (length prefix included), which
    is what :class:`RpcConnection` accounts — blocks; raises
    :class:`ConnectionClosed` on EOF and :class:`ProtocolError` on a frame
    announcing more than ``cap`` (default :func:`max_frame_bytes`).
    ``deadline`` bounds the whole receive absolutely (the pre-auth
    handshake path passes both).
    """
    (n,) = _U64.unpack(_recv_exact(sock, _U64.size, deadline))
    if cap is None:
        cap = max_frame_bytes()
    if n > cap:
        raise ProtocolError(
            f"peer announced a {n}-byte frame exceeding the {cap}-byte cap "
            f"({_MAX_FRAME_ENV}); refusing")
    return decode(_recv_exact(sock, n, deadline)), _U64.size + n


def recv_msg(sock: socket.socket) -> Any:
    """Receive + decode one framed message (blocks; raises ConnectionClosed on EOF)."""
    return recv_msg_sized(sock)[0]


class RpcConnection:
    """One socket shared by many in-flight requests.

    Writes are serialized under a lock held only around the ``sendall``
    (frames must not interleave, but encoding happens OUTSIDE the lock —
    a large frame's codec work never convoys other senders); reads are
    left to exactly one owner — either a caller that knows it is the only
    reader (:meth:`request`, the worker-side sync pattern) or a dedicated
    reader thread that matches replies to requests by ``id`` (the frontend
    pattern — see ``cluster._WorkerHandle``). Mixing both on one
    connection is a caller bug.

    The connection accounts real wire traffic in both directions:
    ``bytes_sent`` / ``bytes_received`` are on-wire byte totals (length
    prefixes included; shm data-plane bytes are tallied separately in
    ``shm_bytes_sent`` / ``shm_bytes_received``), ``messages_sent`` /
    ``messages_received`` count frames, and ``encode_seconds`` /
    ``decode_seconds`` accumulate codec time — the per-worker wire totals
    ``ClusterFrontend.stats()`` surfaces.

    When a shared-memory data plane is attached (:meth:`attach_rings`),
    the connection handles the transport's bookkeeping frames internally:
    :meth:`recv` acks consumed ring spans back to the peer and applies the
    peer's acks to the send ring without ever surfacing either to the
    caller.
    """

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self._wlock = threading.Lock()
        self._bytes_sent = 0
        self._bytes_received = 0
        self._messages_sent = 0
        self._messages_received = 0
        self._encode_seconds = 0.0
        self._decode_seconds = 0.0
        self._shm_bytes_sent = 0
        self._shm_bytes_received = 0
        self._send_ring = None
        self._recv_ring = None
        self._shm_min = _shm_min_bytes()

    def attach_rings(self, send_ring, recv_ring) -> None:
        """Arm the shared-memory data plane (both directions)."""
        self._send_ring = send_ring
        self._recv_ring = recv_ring

    @property
    def transport(self) -> str:
        return "shm" if self._send_ring is not None else "tcp"

    def send(self, obj: Any, codec: str = "json") -> None:
        sends = 1
        if _faults.ENABLED:
            # Chaos hook: the plan may kill this process, delay the send,
            # drop the frame on the floor (the peer never sees it — the
            # wire analogue of a lost packet burst), or duplicate it.
            action = _faults.on_point("send", _faults.frame_op(obj))
            if action == "drop":
                return
            if action == "dup":
                sends = 2
        t0 = time.perf_counter()
        ring = self._send_ring if codec == "binary" else None
        parts, n, shm_bytes = _frame_parts(obj, codec=codec, ring=ring,
                                           shm_min=self._shm_min)
        cap = max_frame_bytes()
        if n > cap:
            raise ProtocolError(
                f"frame of {n} bytes exceeds the {cap}-byte cap "
                f"(raise {_MAX_FRAME_ENV} if this payload is legitimate)")
        enc_s = time.perf_counter() - t0
        parts = [_U64.pack(n)] + parts
        with self._wlock:
            for _ in range(sends):
                _send_parts(self.sock, parts)
                self._bytes_sent += _U64.size + n
                self._messages_sent += 1
            self._encode_seconds += enc_s
            self._shm_bytes_sent += shm_bytes

    def recv(self, cap: int | None = None,
             deadline: float | None = None) -> Any:
        while True:
            (n,) = _U64.unpack(_recv_exact(self.sock, _U64.size, deadline))
            eff_cap = max_frame_bytes() if cap is None else cap
            if n > eff_cap:
                raise ProtocolError(
                    f"peer announced a {n}-byte frame exceeding the "
                    f"{eff_cap}-byte cap ({_MAX_FRAME_ENV}); refusing")
            data = _recv_exact(self.sock, n, deadline)
            t0 = time.perf_counter()
            msg, ack_end, shm_bytes = _decode_frame(data,
                                                    ring=self._recv_ring)
            self._decode_seconds += time.perf_counter() - t0
            self._bytes_received += _U64.size + n
            self._messages_received += 1
            self._shm_bytes_received += shm_bytes
            if ack_end is not None:
                # The blobs were copied out of the ring during decode;
                # release the span so the peer's next alloc can reuse it.
                try:
                    self.send({"op": "shm-ack", "pos": ack_end})
                except OSError:
                    pass        # connection is dying; the loop will notice
            if isinstance(msg, dict) and msg.get("op") == "shm-ack":
                ring, pos = self._send_ring, msg.get("pos")
                if ring is not None and isinstance(pos, int) and pos >= 0:
                    ring.ack(pos)
                continue        # transport bookkeeping, not a message
            if _faults.ENABLED:
                # Chaos hook (after decode, so a "drop" models a frame that
                # made it across the wire but was lost before the app saw
                # it — e.g. a result the frontend never resolves).
                action = _faults.on_point("recv", _faults.frame_op(msg))
                if action == "drop":
                    continue
            return msg

    def request(self, obj: Any) -> Any:
        """Sync send-then-recv for single-reader callers (no id matching)."""
        self.send(obj)
        return self.recv()

    @property
    def bytes_sent(self) -> int:
        return self._bytes_sent

    @property
    def bytes_received(self) -> int:
        return self._bytes_received

    @property
    def messages_sent(self) -> int:
        return self._messages_sent

    @property
    def messages_received(self) -> int:
        return self._messages_received

    def wire_stats(self) -> dict:
        """Snapshot of this connection's traffic totals (both directions)."""
        return {"bytes_sent": self._bytes_sent,
                "bytes_received": self._bytes_received,
                "messages_sent": self._messages_sent,
                "messages_received": self._messages_received,
                "encode_seconds": self._encode_seconds,
                "decode_seconds": self._decode_seconds,
                "shm_bytes_sent": self._shm_bytes_sent,
                "shm_bytes_received": self._shm_bytes_received,
                "transport": self.transport}

    def close(self) -> None:
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self.sock.close()
        # Closing the rings wakes any sender blocked in alloc() with a
        # ProtocolError, so a dead connection can never strand a
        # dispatcher thread waiting for an ack that will not come.
        for ring in (self._send_ring, self._recv_ring):
            if ring is not None:
                ring.close()
        self._send_ring = self._recv_ring = None


# ----------------------------------------------------------------- handshake

def client_handshake(conn: RpcConnection, token: str | None = None,
                     ) -> dict:
    """Open a fresh connection: send ``hello``, validate the ``hello-ack``.

    Must be the FIRST exchange on the connection (before any reader thread
    starts). Returns the ack — which carries whatever the listener chose to
    advertise (worker pid, port, device-topology fingerprint) — or raises
    :class:`AuthError` / :class:`ProtocolError` with the server's reason.
    """
    conn.send({"op": "hello", "proto": PROTOCOL_VERSION, "token": token})
    reply = conn.recv()
    if not isinstance(reply, dict):
        raise ProtocolError(f"handshake reply is not a message: {reply!r}")
    if reply.get("op") == "error":
        detail = reply.get("error", "handshake rejected")
        if reply.get("code") == "auth":
            raise AuthError(detail)
        raise ProtocolError(detail)
    if reply.get("op") != "hello-ack" or reply.get("proto") != PROTOCOL_VERSION:
        raise ProtocolError(f"unexpected handshake reply: {reply!r}")
    return reply


def server_handshake(conn: RpcConnection, token: str | None = None,
                     info: dict | None = None,
                     timeout: float | None = None) -> dict:
    """Validate the first frame of an accepted connection; ack or reject.

    ``token=None`` disables auth (the local-spawn case, where the frontend
    generated the token AND the worker — still checked for protocol
    version). On any failure the peer gets an ``error`` frame (``code:
    "auth"`` for token mismatches so the client can raise the right type)
    before this side raises; the caller should then drop the connection.
    ``info`` is advertised in the ack (pid, port, topology fingerprint).

    The pre-auth surface is hardened: the hello frame is capped at
    :data:`HELLO_MAX_BYTES` (an unauthenticated peer never gets a
    multi-GiB allocation), ``timeout`` is an ABSOLUTE deadline across the
    whole receive (a one-byte-per-idle-window trickler cannot stretch
    it), and the token comparison is timing-safe.
    """
    import hmac

    deadline = (time.monotonic() + timeout) if timeout is not None else None
    msg = conn.recv(cap=HELLO_MAX_BYTES, deadline=deadline)

    def _reject(code: str, detail: str) -> None:
        try:
            conn.send({"op": "error", "code": code, "error": detail})
        except OSError:
            pass
        raise (AuthError if code == "auth" else ProtocolError)(detail)

    if not isinstance(msg, dict) or msg.get("op") != "hello":
        _reject("proto", "expected a hello frame to open the connection")
    if msg.get("proto") != PROTOCOL_VERSION:
        _reject("proto", f"protocol version mismatch: peer speaks "
                f"{msg.get('proto')!r}, this side {PROTOCOL_VERSION}")
    if token is not None:
        peer = msg.get("token")
        if not isinstance(peer, str) or not hmac.compare_digest(
                peer.encode("utf-8"), token.encode("utf-8")):
            _reject("auth", "bad or missing auth token")
    conn.send({"op": "hello-ack", "proto": PROTOCOL_VERSION,
               **(info or {})})
    return msg


def connect(host: str, port: int, timeout: float | None = None
            ) -> RpcConnection:
    """TCP-connect to a worker's RPC port (``TCP_NODELAY`` — frames are small)."""
    sock = socket.create_connection((host, port), timeout=timeout)
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    sock.settimeout(None)
    return RpcConnection(sock)


def listener(host: str = "127.0.0.1", port: int = 0) -> socket.socket:
    """A listening socket; ``port=0`` lets the OS pick (read ``getsockname``)."""
    sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    sock.bind((host, port))
    sock.listen(16)
    return sock
