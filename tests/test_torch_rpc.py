"""The port's wire layer (``repro_torch.serving.rpc`` and ``shm``) against
``repro.serving.rpc``.

The reference's wire cases on the port — codec round trips on torch leaves
(bf16 and 0-d included), adversarial JSON and binary frames and headers,
frame caps, accounting, the handshake and its auth, the shared-memory ring,
the dispatcher's window and reply demux — and the two packages' frames held
against each other: the same inputs encode to the same bytes, and frames
written by either package decode in the other.
"""
import itertools
import json
import os
import socket
import struct
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.serving import rpc as jrpc  # noqa: E402
from repro_torch.core import topology_fingerprint  # noqa: E402
from repro_torch.serving import (ClusterError, ClusterRemoteError, ShmRing,  # noqa: E402
                                 rpc)
from repro_torch.serving.cluster import WorkerNode, _WorkerHandle, resolve_registry  # noqa: E402
from repro_torch.serving.demo import DEMO_REGISTRY  # noqa: E402
from repro_torch.serving.spawner import SpawnedWorker, parse_worker_spec  # noqa: E402

REGISTRY_SPEC = "repro_torch.serving.demo:DEMO_REGISTRY"


def _bf16(values) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.float32).to(torch.bfloat16)


# the same leaves, as torch tensors (the port) and as numpy / jax arrays (the
# reference): every dtype the wire names, bf16 and 0-d included
def _leaves(seed: int = 0):
    rng = np.random.default_rng(seed)
    f32 = rng.standard_normal((3, 4)).astype(np.float32)
    bf = np.asarray(jnp.asarray(rng.standard_normal((2, 5)), jnp.bfloat16))
    arrays = {
        "f32": f32, "bf16": bf, "i32_0d": np.array(7, np.int32),
        "i64": np.arange(5, dtype=np.int64), "f64": rng.standard_normal(3),
        "f16": rng.standard_normal((2, 2)).astype(np.float16),
        "u8": np.arange(6, dtype=np.uint8).reshape(2, 3), "i8": np.array([-3, 4], np.int8),
        "bool": np.array([True, False, True]), "empty": np.zeros((0, 3), np.float32),
    }
    tensors = {k: (torch.from_numpy(v.view(np.int16).copy()).view(torch.bfloat16)
                   if k == "bf16" else torch.from_numpy(np.array(v)))
               for k, v in arrays.items()}
    return tensors, arrays


def _frame_obj(leaves):
    """A submit_batch-shaped frame around ``leaves``: nested dicts, a list
    of per-layer caches, tuples, scalars and an artifact's raw bytes."""
    return {"op": "submit_batch", "id": 3, "entries": [
        {"id": 11, "tenant": "t0", "ttl": 2.5,
         "buffers": {"tokens": leaves["i32_0d"], "caches": [
             {"k": leaves["f32"], "v": (leaves["bf16"], leaves["bool"])},
             {"k": leaves["f16"], "v": (leaves["empty"], leaves["u8"])}],
             "pos": leaves["i64"], "x": [leaves["f64"], leaves["i8"]]}}],
        "artifact": b"\x00\x01binary\xff", "none": None, "flag": True,
        ("k", 1): "tuple-key", "neg": -(1 << 40)}


def _assert_same(torch_tree, np_tree):
    tl, ts = torch.utils._pytree.tree_flatten(torch_tree)
    nl, ns = torch.utils._pytree.tree_flatten(np_tree)
    assert ts == ns
    for t, n in zip(tl, nl):
        if isinstance(t, torch.Tensor):
            n = np.asarray(n)
            want = n.view(np.int16) if str(n.dtype) == "bfloat16" else n
            got = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
            assert tuple(t.shape) == n.shape and str(t.dtype) == f"torch.{n.dtype}"
            np.testing.assert_array_equal(got.numpy(), want)
        else:
            assert t == n


class TestRpcCodec:
    def _roundtrip(self, obj, codec="json"):
        return rpc.decode(rpc.encode(obj, codec))

    def test_scalars_and_containers(self):
        obj = {"op": "x", "id": 3, "none": None, "flag": True,
               "f": 2.5, "s": "text", "tup": (1, 2), "lst": [1, [2, 3]],
               ("k", 1): "tuple-key"}
        back = self._roundtrip(obj)
        assert back == obj
        assert isinstance(back["tup"], tuple)
        assert isinstance(back["lst"], list)

    @pytest.mark.parametrize("codec", ["json", "binary"])
    def test_array_dtypes_and_zero_d(self, codec):
        tensors, _ = _leaves()
        back = self._roundtrip(tensors, codec)
        for k, t in tensors.items():
            assert isinstance(back[k], torch.Tensor) and back[k].dtype == t.dtype
            assert back[k].shape == t.shape and back[k].device.type == "cpu"
            assert torch.equal(back[k], t)
        assert back["i32_0d"].shape == () and int(back["i32_0d"]) == 7

    def test_numpy_leaves_come_back_as_tensors(self):
        back = self._roundtrip({"s": np.float32(1.25), "a": np.arange(3.0)})
        assert back["s"].dtype == torch.float32 and float(back["s"]) == 1.25
        assert back["a"].dtype == torch.float64 and back["a"].tolist() == [0.0, 1.0, 2.0]

    def test_cuda_style_leaves_are_read_through_cpu(self):
        # a non-contiguous view and a tensor that needs grad encode as their
        # values (the codec takes .detach().cpu() and a contiguous copy)
        x = torch.arange(12.0).reshape(3, 4).t()
        w = torch.ones(2, requires_grad=True)
        back = self._roundtrip({"x": x, "w": w}, "binary")
        assert torch.equal(back["x"], x.contiguous()) and not back["w"].requires_grad

    def test_nested_pytree_and_bytes(self):
        obj = {"caches": [{"k": torch.ones((2, 2)), "v": (torch.zeros((1,)),)}],
               "artifact": b"\x00\x01binary\xff"}
        back = self._roundtrip(obj)
        assert back["artifact"] == b"\x00\x01binary\xff"
        assert torch.equal(back["caches"][0]["k"], torch.ones((2, 2)))
        assert isinstance(back["caches"][0]["v"], tuple)

    def test_decoded_arrays_are_writable_aligned_copies(self):
        data = rpc.encode({"x": torch.zeros((2,)), "b": _bf16([1.0, 2.0])}, "binary")
        back = rpc.decode(data)
        back["x"][0] = 1.0
        assert back["x"][0] == 1.0 and back["x"].data_ptr() % 16 == 0
        assert back["b"].dtype == torch.bfloat16 and back["b"].tolist() == [1.0, 2.0]

    def test_unencodable_rejected(self):
        with pytest.raises(TypeError, match="cannot encode"):
            rpc.encode({"fn": lambda: None})

    def test_truncated_frame_rejected(self):
        data = rpc.encode({"a": torch.ones((4,))})
        with pytest.raises(rpc.ProtocolError):
            rpc.decode(data[:8])


class TestBinaryCodec:
    """The hot-path codec is a bit-exact substitute for JSON framing."""

    def _roundtrip(self, obj):
        return rpc.decode(rpc.encode(obj, codec="binary"))

    def test_scalars_containers_and_tuple_keys(self):
        obj = {"op": "submit_batch", "id": 3, "none": None, "flag": True,
               "f": 2.5, "s": "text", "tup": (1, 2), "lst": [1, [2, 3]],
               ("k", 1): "tuple-key", "neg": -(1 << 40)}
        back = self._roundtrip(obj)
        assert back == obj
        assert isinstance(back["tup"], tuple)
        assert isinstance(back["lst"], list)

    def test_parity_with_json_codec_on_a_submit_frame(self):
        frame = {"op": "submit_batch", "entries": [
            {"id": 11, "tenant": "t", "buffers":
                {"x0": torch.arange(12, dtype=torch.float32).reshape(3, 4)}}]}
        via_bin = rpc.decode(rpc.encode(frame, codec="binary"))
        via_json = rpc.decode(rpc.encode(frame, codec="json"))
        assert torch.equal(via_bin["entries"][0]["buffers"]["x0"],
                           via_json["entries"][0]["buffers"]["x0"])
        assert via_bin["entries"][0]["id"] == via_json["entries"][0]["id"]
        assert len(rpc.encode(frame, codec="binary")) < len(rpc.encode(frame, codec="json"))

    def test_out_of_range_int_points_at_json(self):
        with pytest.raises(TypeError, match="64-bit"):
            rpc.encode({"n": 1 << 70}, codec="binary")

    def test_unencodable_rejected(self):
        with pytest.raises(TypeError, match="cannot encode"):
            rpc.encode({"fn": lambda: None}, codec="binary")


class TestFramesAcrossPackages:
    """The port's frames are the reference's, byte for byte."""

    @pytest.mark.parametrize("codec", ["json", "binary"])
    def test_same_inputs_encode_byte_identically(self, codec):
        tensors, arrays = _leaves(1)
        assert rpc.encode(_frame_obj(tensors), codec) == jrpc.encode(_frame_obj(arrays), codec)

    @pytest.mark.parametrize("codec", ["json", "binary"])
    def test_reference_frames_decode_in_the_port(self, codec):
        tensors, arrays = _leaves(2)
        _assert_same(rpc.decode(jrpc.encode(_frame_obj(arrays), codec)), _frame_obj(arrays))

    @pytest.mark.parametrize("codec", ["json", "binary"])
    def test_port_frames_decode_in_the_reference(self, codec):
        tensors, arrays = _leaves(3)
        back = jrpc.decode(rpc.encode(_frame_obj(tensors), codec))
        _assert_same(_frame_obj(tensors), back)

    def test_streams_interoperate_over_a_socket(self):
        # a reference connection talks to a port connection, both codecs
        sa, sb = socket.socketpair()
        ref, port = jrpc.RpcConnection(sa), rpc.RpcConnection(sb)
        try:
            tensors, arrays = _leaves(4)
            ref.send(_frame_obj(arrays), codec="binary")
            _assert_same(port.recv(), _frame_obj(arrays))
            port.send(_frame_obj(tensors))
            _assert_same(_frame_obj(tensors), ref.recv())
            assert ref.bytes_sent == port.bytes_received
            assert port.bytes_sent == ref.bytes_received
        finally:
            ref.close()
            port.close()

    def test_handshake_across_packages(self):
        sa, sb = socket.socketpair()
        ref, port = jrpc.RpcConnection(sa), rpc.RpcConnection(sb)
        try:
            t = threading.Thread(target=rpc.server_handshake, args=(port,),
                                 kwargs={"token": "t", "info": {"pid": 1}})
            t.start()
            ack = jrpc.client_handshake(ref, token="t")
            t.join(timeout=10)
            assert ack["op"] == "hello-ack" and ack["pid"] == 1
            assert rpc.PROTOCOL_VERSION == jrpc.PROTOCOL_VERSION
        finally:
            ref.close()
            port.close()

    def test_wire_errors_map_by_name(self):
        from repro_torch.serving import DeadlineExceeded, QueueFull, RateLimited
        for cls in (DeadlineExceeded, QueueFull, RateLimited):
            assert rpc.wire_error_class(f"{cls.__name__}: x") is cls
        assert rpc.wire_error_class("ValueError: x") is None


class TestFrameLargerThanTheRing:
    def test_blobs_past_the_ring_are_inlined_not_deadlocked(self):
        # one frame whose blobs add up to 3x the ring: the ring takes what
        # fits, the rest rides inline, and the frame arrives whole (waiting
        # for the frame's own ack would never end)
        sa, sb = socket.socketpair()
        a, b = rpc.RpcConnection(sa), rpc.RpcConnection(sb)
        tx, rx = ShmRing.create(1 << 16), ShmRing.create(1 << 16)
        peer_rx, peer_tx = ShmRing.attach(tx.name, tx.size), ShmRing.attach(rx.name, rx.size)
        a.attach_rings(send_ring=tx, recv_ring=rx)
        b.attach_rings(send_ring=peer_tx, recv_ring=peer_rx)
        try:
            leaves = [torch.full((4096,), float(i)) for i in range(12)]   # 16 KiB each
            a.send({"op": "big", "leaves": leaves}, codec="binary")
            got = b.recv()
            assert all(torch.equal(x, y) for x, y in zip(got["leaves"], leaves))
            ws = a.wire_stats()
            assert 0 < ws["shm_bytes_sent"] <= tx.size
            assert ws["bytes_sent"] > 12 * 16384 - ws["shm_bytes_sent"]
        finally:
            a.close()
            b.close()


def _frame(header_obj, blobs=()):
    """Hand-roll a v2 JSON frame body (adversarial tests build invalid ones).

    Layout: ``[1B tag 'J'][u32 hlen][header][u32 nblobs]`` then per blob
    ``[1B placement=inline][u64 len][bytes]``.
    """
    header = json.dumps(header_obj).encode("utf-8")
    parts = [b"J", struct.pack(">I", len(header)), header,
             struct.pack(">I", len(blobs))]
    for b in blobs:
        parts.append(b"\x00")
        parts.append(struct.pack(">Q", len(b)))
        parts.append(b)
    return b"".join(parts)


class TestRpcFramingAdversarial:
    """Bytes a peer could actually send must fail as ProtocolError — never
    as a numpy/json traceback from half-parsed attacker-controlled data."""

    def test_truncated_header_length(self):
        with pytest.raises(rpc.ProtocolError, match="missing header"):
            rpc.decode(b"\x00\x01")

    def test_header_overruns_body(self):
        with pytest.raises(rpc.ProtocolError, match="header overruns"):
            rpc.decode(b"J" + struct.pack(">I", 100) + b"{}")

    def test_bad_magic_tag_rejected(self):
        with pytest.raises(rpc.ProtocolError, match="codec tag"):
            rpc.decode(b"\x00" + struct.pack(">I", 2) + b"{}"
                       + struct.pack(">I", 0))

    def test_truncated_blob_length(self):
        good = _frame({"t": "b", "i": 0}, [b"payload"])
        with pytest.raises(rpc.ProtocolError, match="blob length"):
            rpc.decode(good[:-len(b"payload") - 4])   # cut mid length prefix

    def test_blob_overruns_body(self):
        good = _frame({"t": "b", "i": 0}, [b"payload"])
        with pytest.raises(rpc.ProtocolError, match="blob overruns"):
            rpc.decode(good[:-3])

    def test_blob_index_out_of_range(self):
        with pytest.raises(rpc.ProtocolError, match="out of range"):
            rpc.decode(_frame({"t": "b", "i": 7}, [b"x"]))

    def test_array_blob_shape_mismatch(self):
        # 3 bytes of data for a float32[4]: without validation this escapes
        # as a numpy frombuffer/reshape error deep in the codec.
        bad = _frame({"t": "a", "i": 0, "d": "float32", "s": [4]}, [b"abc"])
        with pytest.raises(rpc.ProtocolError, match="disagrees"):
            rpc.decode(bad)

    def test_array_negative_dim(self):
        # float32[-1] with 4 bytes would pass a naive size check (numpy
        # infers -1) and reshape attacker-chosen geometry.
        bad = _frame({"t": "a", "i": 0, "d": "float32", "s": [-1]},
                     [b"\x00" * 4])
        with pytest.raises(rpc.ProtocolError, match="invalid shape"):
            rpc.decode(bad)

    def test_unknown_node_type(self):
        with pytest.raises(rpc.ProtocolError, match="unknown codec node"):
            rpc.decode(_frame({"t": "zz", "v": 1}))

    def test_non_list_shape_rejected(self):
        bad = _frame({"t": "a", "i": 0, "d": "float32", "s": 1},
                     [b"\x00" * 4])
        with pytest.raises(rpc.ProtocolError, match="invalid shape"):
            rpc.decode(bad)

    def test_missing_node_keys_are_protocol_errors(self):
        # A node without "t"/"d"/"i" must not escape as KeyError from deep
        # inside the codec — the reader loops only treat ProtocolError (and
        # socket errors) as fatal-but-handled.
        with pytest.raises(rpc.ProtocolError, match="malformed codec"):
            rpc.decode(_frame({"v": 1}))
        with pytest.raises(rpc.ProtocolError, match="malformed codec"):
            rpc.decode(_frame({"t": "a", "i": 0, "s": [1]}, [b"\x00" * 4]))

    def test_bogus_dtype_is_protocol_error(self):
        bad = _frame({"t": "a", "i": 0, "d": "no-such-dtype", "s": [1]},
                     [b"\x00" * 4])
        with pytest.raises(rpc.ProtocolError, match="malformed codec"):
            rpc.decode(bad)

    def test_non_json_header_is_protocol_error(self):
        body = (b"J" + struct.pack(">I", 4) + b"\xff\xfe{{"
                + struct.pack(">I", 0))
        with pytest.raises(rpc.ProtocolError, match="not valid JSON"):
            rpc.decode(body)

    def test_protocol_error_mid_stream_fails_pending_futures(self):
        # A desynced frame on a live frontend connection must mark the
        # worker dead (failing in-flight futures fast), not kill the
        # reader thread silently with futures hung.
        import itertools

        from repro_torch.serving.cluster import _WorkerHandle
        from repro_torch.serving.spawner import SpawnedWorker

        sa, sb = socket.socketpair()
        handle = _WorkerHandle(
            0, SpawnedWorker(idx=0, kind="remote", address=("x", 1),
                             conn=rpc.RpcConnection(sa)),
            itertools.count(1), lambda idx: None)
        fut = handle.request_async({"op": "stats"})
        rpc.recv_msg(sb)                          # consume the request
        sb.sendall(struct.pack(">Q", rpc.max_frame_bytes() + 1))
        with pytest.raises(Exception, match="died"):
            fut.result(timeout=10)
        assert not handle.alive
        sb.close()
        handle.close()

    def test_oversized_length_prefix_refused(self):
        a, b = socket.socketpair()
        try:
            a.sendall(struct.pack(">Q", rpc.max_frame_bytes() + 1))
            with pytest.raises(rpc.ProtocolError, match="exceeding"):
                rpc.recv_msg(b)
        finally:
            a.close()
            b.close()

    def test_max_frame_env_caps_both_directions(self, monkeypatch):
        monkeypatch.setenv("REPRO_RPC_MAX_FRAME", "64")
        assert rpc.max_frame_bytes() == 64
        a, b = socket.socketpair()
        try:
            with pytest.raises(rpc.ProtocolError, match="exceeds"):
                rpc.send_msg(a, {"x": np.zeros(100, np.float32)})
            a.sendall(struct.pack(">Q", 65))
            with pytest.raises(rpc.ProtocolError, match="exceeding"):
                rpc.recv_msg(b)
        finally:
            a.close()
            b.close()

    def test_max_frame_env_invalid_is_loud(self, monkeypatch):
        # ProtocolError, not bare ValueError: the cap is read on wire
        # paths, and reader loops only treat ProtocolError as a handled
        # fatal error (futures fail fast instead of threads dying silent).
        monkeypatch.setenv("REPRO_RPC_MAX_FRAME", "not-a-number")
        with pytest.raises(rpc.ProtocolError, match="REPRO_RPC_MAX_FRAME"):
            rpc.max_frame_bytes()
        monkeypatch.setenv("REPRO_RPC_MAX_FRAME", "-1")
        with pytest.raises(rpc.ProtocolError, match="positive"):
            rpc.max_frame_bytes()

    def test_hello_frame_capped_preauth(self):
        # An unauthenticated peer's first frame is bounded by
        # HELLO_MAX_BYTES regardless of the (multi-GiB) general cap.
        sa, sb = socket.socketpair()
        a, b = rpc.RpcConnection(sa), rpc.RpcConnection(sb)
        try:
            a.send({"op": "hello", "proto": rpc.PROTOCOL_VERSION,
                    "token": "x" * (rpc.HELLO_MAX_BYTES + 1)})
            with pytest.raises(rpc.ProtocolError, match="exceeding"):
                rpc.server_handshake(b, token="t")
        finally:
            a.close()
            b.close()

    def test_handshake_deadline_is_absolute(self):
        # A trickler that sends nothing must be cut off by the deadline.
        sa, sb = socket.socketpair()
        b = rpc.RpcConnection(sb)
        try:
            t0 = time.monotonic()
            with pytest.raises(rpc.ProtocolError, match="deadline"):
                rpc.server_handshake(b, token="t", timeout=0.3)
            assert time.monotonic() - t0 < 5.0
        finally:
            sa.close()
            b.close()


class TestRpcAccounting:
    """recv() must account real wire bytes, not
    "1 per message", and both directions must be observable."""

    def test_bytes_received_matches_peer_bytes_sent(self):
        sa, sb = socket.socketpair()
        a, b = rpc.RpcConnection(sa), rpc.RpcConnection(sb)
        try:
            payload = {"op": "x", "arr": np.arange(32, dtype=np.float32),
                       "blob": b"\x00" * 100}
            a.send(payload)
            a.send({"op": "tiny"})
            got1, got2 = b.recv(), b.recv()
            assert got1["op"] == "x" and got2["op"] == "tiny"
            assert a.messages_sent == 2
            assert b.messages_received == 2
            # REAL byte symmetry: everything a put on the wire, b counted.
            assert a.bytes_sent == b.bytes_received
            assert b.bytes_received > 128 + 100     # not a message count
            ws = b.wire_stats()
            assert ws["bytes_sent"] == 0
            assert ws["bytes_received"] == b.bytes_received
            assert ws["messages_sent"] == 0
            assert ws["messages_received"] == 2
            assert ws["decode_seconds"] > 0.0
            assert ws["transport"] == "tcp"
            aw = a.wire_stats()
            assert aw["encode_seconds"] > 0.0
            assert aw["shm_bytes_sent"] == 0
        finally:
            a.close()
            b.close()


class TestRegistryResolution:
    def test_instance_passthrough(self):
        assert resolve_registry(DEMO_REGISTRY) is DEMO_REGISTRY

    def test_spec_string(self):
        assert resolve_registry(REGISTRY_SPEC) is DEMO_REGISTRY

    def test_bad_spec(self):
        with pytest.raises(ValueError, match="module:attr"):
            resolve_registry("not-a-spec")


class TestHandshakeAndAuth:
    @pytest.fixture()
    def node(self):
        node = WorkerNode(DEMO_REGISTRY, device="cpu", token="sekrit", max_batch=1)
        t = threading.Thread(target=node.serve_forever, daemon=True)
        t.start()
        yield node
        if not node._stop.is_set():
            conn = rpc.connect("127.0.0.1", node.port)
            rpc.client_handshake(conn, token="sekrit")
            conn.request({"op": "shutdown", "id": 0})
            conn.close()
        t.join(timeout=10)

    def test_good_token_handshake_advertises_identity(self, node):
        conn = rpc.connect("127.0.0.1", node.port)
        try:
            ack = rpc.client_handshake(conn, token="sekrit")
            assert ack["proto"] == rpc.PROTOCOL_VERSION
            assert ack["pid"] == os.getpid()       # in-process node
            assert ack["topology"] == topology_fingerprint("cpu")
            reply = conn.request({"op": "ping", "id": 1})
            assert reply["port"] == node.port
        finally:
            conn.close()

    def test_bad_token_rejected(self, node):
        conn = rpc.connect("127.0.0.1", node.port)
        try:
            with pytest.raises(rpc.AuthError, match="token"):
                rpc.client_handshake(conn, token="wrong")
        finally:
            conn.close()

    def test_missing_token_rejected(self, node):
        conn = rpc.connect("127.0.0.1", node.port)
        try:
            with pytest.raises(rpc.AuthError):
                rpc.client_handshake(conn, token=None)
        finally:
            conn.close()

    def test_protocol_version_mismatch_rejected(self, node):
        conn = rpc.connect("127.0.0.1", node.port)
        try:
            conn.send({"op": "hello", "proto": 99, "token": "sekrit"})
            reply = conn.recv()
            assert reply["op"] == "error" and reply["code"] == "proto"
        finally:
            conn.close()

    def test_rejected_connection_cannot_dispatch(self, node):
        # After a failed handshake the worker drops the socket: a follow-up
        # op must never reach the dispatcher.
        conn = rpc.connect("127.0.0.1", node.port)
        try:
            with pytest.raises(rpc.AuthError):
                rpc.client_handshake(conn, token="wrong")
            with pytest.raises((rpc.ConnectionClosed, OSError)):
                conn.send({"op": "stats", "id": 2})
                conn.recv()
        finally:
            conn.close()


class TestWorkerSpecParsing:
    def test_local_and_remote_specs(self):
        assert parse_worker_spec("local") is None
        assert parse_worker_spec(" LOCAL ") is None
        assert parse_worker_spec("10.0.0.5:7077") == ("10.0.0.5", 7077)
        assert parse_worker_spec("worker-3.fleet.internal:80") == \
            ("worker-3.fleet.internal", 80)

    @pytest.mark.parametrize("bad", ["justahost", ":1234x", "h:0", "h:99999",
                                     "h:", 7077, None])
    def test_bad_specs_fail_at_construction(self, bad):
        with pytest.raises(ValueError, match="worker spec"):
            parse_worker_spec(bad)


def _bin_frame(header, blobs=()):
    """Hand-roll a v2 binary frame body around a raw header byte string."""
    parts = [b"B", struct.pack(">I", len(header)), header,
             struct.pack(">I", len(blobs))]
    for b in blobs:
        parts.append(b"\x00")
        parts.append(struct.pack(">Q", len(b)))
        parts.append(b)
    return b"".join(parts)


class TestBinaryHeaderAdversarial:
    """Every malformed binary header a peer could send must surface as
    ProtocolError — never a struct.error / KeyError traceback."""

    def test_unknown_tag(self):
        with pytest.raises(rpc.ProtocolError, match="unknown binary codec"):
            rpc.decode(_bin_frame(b"\x7f"))

    def test_truncated_int_node(self):
        with pytest.raises(rpc.ProtocolError, match="truncated int"):
            rpc.decode(_bin_frame(b"\x03\x00\x00"))

    def test_string_overruns_header(self):
        header = b"\x05" + struct.pack(">I", 999) + b"ab"
        with pytest.raises(rpc.ProtocolError, match="overruns the header"):
            rpc.decode(_bin_frame(header))

    def test_string_invalid_utf8(self):
        header = b"\x05" + struct.pack(">I", 2) + b"\xff\xfe"
        with pytest.raises(rpc.ProtocolError, match="not valid utf-8"):
            rpc.decode(_bin_frame(header))

    def test_container_count_lies(self):
        header = b"\x08" + struct.pack(">I", 0xFFFF0000)
        with pytest.raises(rpc.ProtocolError, match="container count"):
            rpc.decode(_bin_frame(header))

    def test_blob_index_out_of_range(self):
        header = b"\x06" + struct.pack(">I", 3)
        with pytest.raises(rpc.ProtocolError, match="out of range"):
            rpc.decode(_bin_frame(header))

    def test_trailing_header_bytes(self):
        with pytest.raises(rpc.ProtocolError, match="trailing bytes"):
            rpc.decode(_bin_frame(b"\x00\x00"))

    def test_unhashable_dict_key(self):
        # {[]: None} — a list node in key position decodes but cannot hash
        header = (b"\x09" + struct.pack(">I", 1)
                  + b"\x08" + struct.pack(">I", 0) + b"\x00")
        with pytest.raises(rpc.ProtocolError, match="unhashable"):
            rpc.decode(_bin_frame(header))

    def test_bogus_array_dtype(self):
        dt = b"no-such"
        header = (b"\x0a" + struct.pack(">I", 0) + bytes([len(dt)]) + dt
                  + bytes([1]) + struct.pack(">I", 4))
        with pytest.raises(rpc.ProtocolError, match="malformed codec node"):
            rpc.decode(_bin_frame(header, blobs=(b"\x00" * 16,)))

    def test_array_blob_size_mismatch(self):
        dt = b"float32"
        header = (b"\x0a" + struct.pack(">I", 0) + bytes([len(dt)]) + dt
                  + bytes([1]) + struct.pack(">I", 4))
        with pytest.raises(rpc.ProtocolError, match="disagrees with"):
            rpc.decode(_bin_frame(header, blobs=(b"\x00" * 3,)))

    def test_shm_reference_without_a_ring(self):
        # placement=1 blob on a ring-less decode: clean refusal, no deref
        header = b"\x06" + struct.pack(">I", 0)
        body = (b"B" + struct.pack(">I", len(header)) + header
                + struct.pack(">I", 1) + b"\x01" + struct.pack(">QQ", 0, 16))
        with pytest.raises(rpc.ProtocolError, match="no ring attached"):
            rpc.decode(body)


# ---------------------------------------------------------------------------
# Shared-memory ring (no processes)
# ---------------------------------------------------------------------------

class TestShmRing:
    def test_roundtrip_attach_and_stats(self):
        ring = ShmRing.create(4096)
        try:
            pos = ring.alloc(100)
            ring.write(pos, b"x" * 100)
            assert ring.read(pos, 100) == b"x" * 100
            # a second attachment sees the same bytes (the cross-process
            # contract, exercised in-process)
            peer = ShmRing.attach(ring.name, ring.size)
            assert peer.read(pos, 100) == b"x" * 100
            peer.close()
            st = ring.stats()
            assert st["allocated"] == 100 and st["outstanding"] == 100
            ring.ack(pos + 100)
            assert ring.stats()["outstanding"] == 0
        finally:
            ring.close()

    def test_alloc_pads_to_segment_end_instead_of_wrapping(self):
        ring = ShmRing.create(4096)
        try:
            a = ring.alloc(1500)
            ring.ack(a + 1500)
            b = ring.alloc(1500)
            ring.ack(b + 1500)
            c = ring.alloc(1500)            # 3000 + 1500 > 4096: must pad
            assert c % ring.size == 0       # lands at the segment start
            ring.write(c, b"z" * 1500)
            assert ring.read(c, 1500) == b"z" * 1500
        finally:
            ring.close()

    def test_full_ring_blocks_until_peer_acks(self):
        ring = ShmRing.create(4096)
        try:
            first = ring.alloc(2000)
            ring.alloc(2000)
            released = threading.Event()

            def _late_ack():
                time.sleep(0.3)
                released.set()
                ring.ack(first + 2000)

            threading.Thread(target=_late_ack, daemon=True).start()
            t0 = time.monotonic()
            pos = ring.alloc(2000, timeout=30)   # blocks until the ack
            assert released.is_set()
            assert time.monotonic() - t0 >= 0.2
            assert pos % ring.size == 0
        finally:
            ring.close()

    def test_oversized_blob_is_a_value_error(self):
        ring = ShmRing.create(4096)
        try:
            with pytest.raises(ValueError, match="contiguity bound"):
                ring.alloc(3000)                 # > size // 2
        finally:
            ring.close()

    def test_reads_are_bounds_checked(self):
        ring = ShmRing.create(4096)
        try:
            with pytest.raises(rpc.ProtocolError, match="sane segment span"):
                ring.read(0, 10 ** 9)
            with pytest.raises(rpc.ProtocolError, match="sane segment span"):
                ring.read(-1, 4)
            with pytest.raises(rpc.ProtocolError, match="overruns"):
                ring.read(4090, 100)
        finally:
            ring.close()

    def test_closed_ring_fails_allocators(self):
        ring = ShmRing.create(4096)
        ring.close()
        with pytest.raises(rpc.ProtocolError, match="closed"):
            ring.alloc(16)


def _handle_pair(window=None):
    """A _WorkerHandle wired to a fake worker: the test drives the peer
    end of a socketpair with raw protocol frames."""
    sa, sb = socket.socketpair()
    deaths = []
    handle = _WorkerHandle(
        0,
        SpawnedWorker(idx=0, kind="remote", address=("fake", 0),
                      conn=rpc.RpcConnection(sa)),
        itertools.count(1), deaths.append, window=window)
    return handle, rpc.RpcConnection(sb), deaths


class TestDispatcherWirePath:
    def test_window_pressure_packs_and_replies_demux_out_of_order(self):
        h, peer, _ = _handle_pair(window=1)
        try:
            f1 = h.submit_async("t", {})
            frame1 = peer.recv()
            assert frame1["op"] == "submit_batch"
            assert len(frame1["entries"]) == 1
            # window=1 with frame1 unanswered: these five must queue, and
            # the dispatcher must NOT put another frame on the wire
            futs = [h.submit_async("t", {"n": np.float32(i)})
                    for i in range(5)]
            # poll (not a fixed sleep): wait until all five are queued,
            # then the window invariant — exactly one frame in flight —
            # must hold
            deadline = time.monotonic() + 30
            while h.dispatch_stats()["queued_entries"] < 5 \
                    and time.monotonic() < deadline:
                time.sleep(0.005)
            ds = h.dispatch_stats()
            assert ds["inflight_frames"] == 1
            assert ds["queued_entries"] == 5
            # answering frame1 frees the window slot -> the backlog goes
            # out pre-coalesced: five submissions, ONE frame
            peer.send({"op": "result_batch", "entries": [
                {"id": frame1["entries"][0]["id"], "out": {"ok": 1}}]},
                codec="binary")
            assert f1.result(30)["out"]["ok"] == 1
            frame2 = peer.recv()
            ids = [e["id"] for e in frame2["entries"]]
            assert len(ids) == 5
            # out-of-order completion: reply reversed, each future still
            # resolves to ITS entry by id
            peer.send({"op": "result_batch", "entries": [
                {"id": m, "out": {"echo": m}} for m in reversed(ids)]},
                codec="binary")
            for fut, mid in zip(futs, ids):
                got = fut.result(30)
                assert got["id"] == mid and got["out"]["echo"] == mid
            ds = h.dispatch_stats()
            assert ds["frames_sent"] == 2 and ds["entries_sent"] == 6
            assert ds["inflight_frames"] == 0 and ds["queued_entries"] == 0
            assert ds["entries_per_frame"] == 3.0
        finally:
            h.close()
            peer.close()

    def test_error_entries_fail_only_their_future(self):
        h, peer, _ = _handle_pair()
        try:
            f_ok = h.submit_async("t", {})
            f_bad = h.submit_async("t", {})
            got = []
            while sum(len(f["entries"]) for f in got) < 2:
                got.append(peer.recv())
            mids = [e["id"] for f in got for e in f["entries"]]
            peer.send({"op": "result_batch", "entries": [
                {"id": mids[0], "out": {"y": 1}},
                {"id": mids[1], "error": "KeyError: nope"}]}, codec="binary")
            assert f_ok.result(30)["out"]["y"] == 1
            with pytest.raises(ClusterRemoteError, match="nope"):
                f_bad.result(30)
            assert h.alive                  # a remote error is not a death
        finally:
            h.close()
            peer.close()

    def test_control_timeout_disowns_pending_and_is_counted(self):
        h, peer, _ = _handle_pair()
        try:
            with pytest.raises(ClusterError, match="no reply"):
                h.request({"op": "ping"}, timeout=0.3)
            # the fixed leak: the demux table must NOT retain the entry
            with h._lock:
                assert not h._pending
            assert h.dispatch_stats()["timeouts"] == 1
            # the late reply arrives anyway; the reader drops it silently
            late = peer.recv()
            peer.send({"op": "result", "id": late["id"], "pong": True})

            def _answer_next():
                msg = peer.recv()
                peer.send({"op": "result", "id": msg["id"], "pong": True})

            t = threading.Thread(target=_answer_next, daemon=True)
            t.start()
            # ...and the connection is still healthy for the next request
            assert h.request({"op": "ping"}, timeout=30)["pong"] is True
            t.join(timeout=10)
            assert h.alive
        finally:
            h.close()
            peer.close()


class TestShmSetupRefusal:
    """shm-setup is peer-controlled input: a bogus offer must be refused
    with a reason on a connection that stays fully usable."""

    def _spin_node(self, **kwargs):
        node = WorkerNode(DEMO_REGISTRY, device="cpu", max_batch=1, **kwargs)
        t = threading.Thread(target=node.serve_forever, daemon=True)
        t.start()
        return node, t

    def _shutdown(self, conn, t):
        conn.request({"op": "shutdown", "id": 99})
        conn.close()
        t.join(timeout=10)

    def test_unattachable_segments_refused_not_fatal(self):
        node, t = self._spin_node()
        conn = rpc.connect("127.0.0.1", node.port)
        try:
            rpc.client_handshake(conn)
            reply = conn.request({"op": "shm-setup", "id": 7,
                                  "tx": "repro-ring-no-such-segment",
                                  "rx": "repro-ring-no-such-segment",
                                  "size": 4096})
            assert reply["attached"] is False
            assert reply["reason"]
            # the refusal must not poison the connection
            assert conn.request({"op": "ping", "id": 8})["port"] == node.port
        finally:
            self._shutdown(conn, t)

    def test_tcp_pinned_node_refuses_real_segments(self):
        node, t = self._spin_node(transport="tcp")
        conn = rpc.connect("127.0.0.1", node.port)
        tx, rx = ShmRing.create(4096), ShmRing.create(4096)
        try:
            rpc.client_handshake(conn)
            reply = conn.request({"op": "shm-setup", "id": 7,
                                  "tx": tx.name, "rx": rx.name,
                                  "size": 4096})
            assert reply["attached"] is False
            assert "tcp" in reply["reason"]
        finally:
            tx.close()
            rx.close()
            self._shutdown(conn, t)
