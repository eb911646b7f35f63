"""The port's transport (``runtime/transport.py``) and the actors on it,
against the JAX package's.

The JAX package's ``test_transport_vectored.py`` cases against the port:
a vectored round trip over a socket pair, the payload landed in a
caller's buffer, the meta-aware allocator, plain and vectored frames
interleaved, a failed receive that releases the caller's buffer, authed
TCP, a bad token refused, the zero-copy gate off by default. Then the
``RSDL_TCP_STREAMS`` clamp; frames of plain objects, vectored frames and
``serialize_columns_vectored``, byte for byte the JAX package's; each
package's client authenticated by the other's server; and the actors on
TCP: calls, an out-of-band reply, a timed call, a wrong token. Every
comparison is of bytes, exactly.
"""

import asyncio
import mmap
import os
import socket
import tempfile
import threading

import numpy as np
import pytest

from ray_shuffling_data_loader_tpu.runtime import store as jax_store
from ray_shuffling_data_loader_tpu.runtime import transport as jax_transport
from ray_shuffling_data_loader_tpu_torch.runtime import store as port_store
from ray_shuffling_data_loader_tpu_torch.runtime import transport
from ray_shuffling_data_loader_tpu_torch.runtime.actor import ActorDiedError, spawn_actor

import torch_port_helpers as helpers


def _conn_pair(mod=transport):
    """Two connections over a socket pair (no handshake: unix sockets do
    not authenticate)."""
    a, b = socket.socketpair()
    out = []
    for sock, tag in ((a, "a"), (b, "b")):
        conn = mod.Connection.__new__(mod.Connection)
        conn.address, conn.sock = ("test", tag), sock
        out.append(conn)
    return out


def _send_in_thread(fn, *args):
    t = threading.Thread(target=fn, args=args)
    t.start()
    return t


def test_vectored_roundtrip_socketpair():
    ca, cb = _conn_pair()
    payloads = [b"hello-", np.arange(1000, dtype=np.int64), b"-tail"]
    t = _send_in_thread(ca.send_vectored, ("meta", 42), payloads)
    obj, view = cb.recv_frame()
    t.join()
    assert obj == ("meta", 42)
    assert bytes(view) == b"hello-" + np.arange(1000, dtype=np.int64).tobytes() + b"-tail"
    ca.close()
    cb.close()


def test_vectored_recv_into_caller_buffer():
    ca, cb = _conn_pair()
    data = np.random.default_rng(0).integers(0, 255, 4096).astype(np.uint8)
    got = {}

    def alloc(n):
        got["buf"] = bytearray(n)
        return got["buf"]

    t = _send_in_thread(ca.send_vectored, "m", [data])
    obj, view = cb.recv_frame(into=alloc)
    t.join()
    assert obj == "m" and bytes(got["buf"]) == data.tobytes()
    assert view.obj is not None  # a view of the caller's buffer
    ca.close()
    cb.close()


def test_vectored_recv_meta_aware_allocator():
    ca, cb = _conn_pair()
    seen = {}

    def alloc(n, obj):
        seen["n"], seen["obj"] = n, obj
        return bytearray(n)

    alloc.wants_meta = True
    t = _send_in_thread(ca.send_vectored, ({"stripe": [3, 7]}, "x"), [b"abcd"])
    _, view = cb.recv_frame(into=alloc)
    t.join()
    assert seen == {"n": 4, "obj": ({"stripe": [3, 7]}, "x")} and bytes(view) == b"abcd"
    ca.close()
    cb.close()


def test_plain_and_vectored_frames_interleave():
    ca, cb = _conn_pair()

    def send():
        ca.send({"plain": 1})
        ca.send_vectored("vec", [b"abc"])
        ca.send({"plain": 2})

    t = _send_in_thread(send)
    assert cb.recv() == {"plain": 1}
    obj, view = cb.recv_frame()
    assert obj == "vec" and bytes(view) == b"abc"
    assert cb.recv() == {"plain": 2}
    t.join()
    ca.close()
    cb.close()


def test_vectored_recv_failure_releases_buffer():
    """A peer that dies mid-payload: ``ConnectionError``, and the caller
    can close its mapping at once (no view of it survives)."""
    ca, cb = _conn_pair()
    header = transport.dumps(("meta", [1 << 20]))
    ca.sock.sendall(transport._LEN.pack(transport._VEC_FLAG | len(header)) + header + b"short")
    ca.close()
    with tempfile.TemporaryFile() as f:
        f.truncate(1 << 20)
        mm = mmap.mmap(f.fileno(), 1 << 20)
        try:
            with pytest.raises(ConnectionError):
                cb.recv_frame(into=lambda n: mm)
            mm.close()  # no BufferError
        finally:
            if not mm.closed:
                mm.close()
    cb.close()


def test_zerocopy_gate_default_off(monkeypatch):
    monkeypatch.delenv(transport.ENV_ZEROCOPY, raising=False)
    transport.refresh_zerocopy_from_env()
    assert transport.zerocopy_enabled() is False
    for value, want in (("1", True), ("on", True), ("0", False), ("junk", False)):
        monkeypatch.setenv(transport.ENV_ZEROCOPY, value)
        transport.refresh_zerocopy_from_env()
        assert transport.zerocopy_enabled() is want, value
    monkeypatch.delenv(transport.ENV_ZEROCOPY)
    transport.refresh_zerocopy_from_env()


def test_tcp_streams_clamp(monkeypatch):
    """1 by default; clamped to [1, 16]; junk gives 1; read once until a
    refresh."""
    monkeypatch.delenv(transport.ENV_TCP_STREAMS, raising=False)
    transport.refresh_tcp_streams_from_env()
    assert transport.tcp_streams() == 1
    for value, want in (("3", 3), ("99", 16), ("0", 1), ("-4", 1), ("junk", 1), ("", 1), ("16", 16)):
        monkeypatch.setenv(transport.ENV_TCP_STREAMS, value)
        transport.refresh_tcp_streams_from_env()
        assert transport.tcp_streams() == want, value
    monkeypatch.setenv(transport.ENV_TCP_STREAMS, "5")
    assert transport.tcp_streams() == 16  # cached
    monkeypatch.delenv(transport.ENV_TCP_STREAMS)
    transport.refresh_tcp_streams_from_env()


FRAME_OBJECTS = [
    None,
    ("ok", 3, {"a": [1, 2.5, "x"]}),
    (7, "fetch_vec", ("s-0011aabb", (0, 10)), {"stripe": (1, 4)}, False, None),
    {"nbytes": 12345, "stripe": [3, 9]},
]


@pytest.mark.parametrize("obj", FRAME_OBJECTS, ids=["none", "reply", "request", "meta"])
def test_frames_byte_identical_to_jax(obj):
    assert transport.dumps(obj) == jax_transport.dumps(obj)
    bufs = [b"abc", np.arange(9, dtype=np.int32), b""]
    port = b"".join(bytes(v) for v in transport.vectored_frames(obj, bufs))
    assert port == b"".join(bytes(v) for v in jax_transport.vectored_frames(obj, bufs))
    assert transport._VEC_FLAG == jax_transport._VEC_FLAG and transport._AUTH_MAGIC == jax_transport._AUTH_MAGIC


COLUMN_CASES = {
    "gaps": {"a": np.arange(7, dtype=np.int32), "b": np.arange(14, dtype=np.float64).reshape(7, 2),
             "c": (np.arange(7) % 2).astype(np.bool_)},
    "strided": {"k": np.arange(40, dtype=np.int64)[::2], "v": np.ones(20, np.float32)},
    "empty": {"e": np.zeros(0, np.int32)},
}


@pytest.mark.parametrize("layout", [None, {"kind": "device-batch", "batch": 4}], ids=["plain", "layout"])
@pytest.mark.parametrize("case", sorted(COLUMN_CASES))
def test_serialize_columns_vectored_equals_jax_bytes(case, layout):
    """The scatter-gather list joins to the port's and the JAX package's
    serialized segment, byte for byte."""
    cols = COLUMN_CASES[case]
    total, bufs = port_store.serialize_columns_vectored(cols, layout=layout)
    joined = b"".join(bytes(memoryview(b).cast("B")) for b in bufs)
    want = jax_store.serialize_columns(cols, layout=layout)
    assert total == len(want) and joined == want
    assert port_store.serialize_columns(cols, layout=layout) == want
    jtotal, jbufs = jax_store.serialize_columns_vectored(cols, layout=layout)
    assert jtotal == total and len(jbufs) == len(bufs)


class _TcpVecServer:
    """An asyncio TCP server of one package's transport (authenticated by
    ``start_server``) answering each request with one vectored reply."""

    def __init__(self, mod):
        self._mod = mod
        self._loop = None
        self._started = threading.Event()
        self.port = None
        threading.Thread(target=self._run, daemon=True).start()
        assert self._started.wait(10)

    def _run(self):
        mod = self._mod

        async def handler(reader, writer):
            try:
                while True:
                    req = await mod.read_frame(reader)
                    mod.write_frame_vectored(writer, ("echo", req), [b"PAYLOAD:", np.arange(64, dtype=np.int32)])
                    await writer.drain()
            except (asyncio.IncompleteReadError, ConnectionError, OSError):
                pass
            finally:
                writer.close()

        async def main():
            server = await mod.start_server(("tcp", "127.0.0.1", 0), handler)
            self.port = server.sockets[0].getsockname()[1]
            self._started.set()
            async with server:
                await asyncio.Event().wait()

        self._loop = asyncio.new_event_loop()
        try:
            self._loop.run_until_complete(main())
        except RuntimeError:
            pass

    def stop(self):
        self._loop.call_soon_threadsafe(self._loop.stop)


@pytest.fixture(params=["port", "jax"])
def vec_server(request, monkeypatch):
    monkeypatch.setenv("RSDL_CLUSTER_TOKEN", "vec-test-secret")
    server = _TcpVecServer(transport if request.param == "port" else jax_transport)
    yield server
    server.stop()


@pytest.mark.parametrize("client", ["port", "jax"])
def test_vectored_over_authed_tcp(vec_server, client):
    """Each package's client, authenticated by either package's server."""
    mod = transport if client == "port" else jax_transport
    conn = mod.Connection(("tcp", "127.0.0.1", vec_server.port))
    try:
        conn.send({"want": "vec"})
        obj, view = conn.recv_frame()
        assert obj == ("echo", {"want": "vec"})
        assert bytes(view) == b"PAYLOAD:" + np.arange(64, dtype=np.int32).tobytes()
    finally:
        conn.close()


def test_vectored_tcp_rejects_bad_token(vec_server, monkeypatch):
    """A peer with the wrong secret is dropped before a frame is read."""
    monkeypatch.setenv("RSDL_CLUSTER_TOKEN", "WRONG-secret")
    conn = transport.Connection(("tcp", "127.0.0.1", vec_server.port), timeout=10)
    try:
        with pytest.raises((ConnectionError, OSError)):
            conn.send({"want": "vec"})
            conn.recv_frame()
    finally:
        conn.close()


@pytest.fixture(scope="module")
def tcp_actor(tmp_path_factory):
    prev = os.environ.get("RSDL_CLUSTER_TOKEN")
    os.environ["RSDL_CLUSTER_TOKEN"] = "actor-test-secret"
    handle = spawn_actor(helpers.Blob, runtime_dir=str(tmp_path_factory.mktemp("tcp-actor")), host="127.0.0.1",
                         name="blob")
    try:
        yield handle
    finally:
        handle.terminate()
        if prev is None:
            os.environ.pop("RSDL_CLUSTER_TOKEN", None)
        else:
            os.environ["RSDL_CLUSTER_TOKEN"] = prev


def test_tcp_actor_calls(tcp_actor):
    """An actor on TCP: its bound port is a real one, and plain, timed,
    one-way and out-of-band calls work on it."""
    assert tcp_actor.address[0] == "tcp" and tcp_actor.address[2] > 0
    assert tcp_actor.call("echo", [1, "a"]) == [1, "a"]
    assert tcp_actor.call_with_timeout("echo", 5, timeout=10) == 5
    tcp_actor.call_oneway("echo", 1)
    for n in (0, 3, 100_000):
        meta, payload = tcp_actor.call_vectored("get", n)
        assert meta == {"n": n}
        assert bytes(payload) == b"head:" + np.arange(n, dtype=np.int64).tobytes()
    # An out-of-band reply to a plain call is read and dropped.
    assert tcp_actor.call("get", 5) == {"n": 5}
    assert tcp_actor.call("echo", "after") == "after"


def test_tcp_actor_refuses_wrong_token(tcp_actor, monkeypatch):
    """A caller with the wrong secret gets the retry-safe ActorDiedError,
    not a hang, and the actor goes on serving the others."""
    monkeypatch.setenv("RSDL_CLUSTER_TOKEN", "WRONG-secret")
    stranger = type(tcp_actor)(tcp_actor.address)
    with pytest.raises(ActorDiedError):
        stranger.call("echo", 1)
    with pytest.raises(ActorDiedError):
        stranger.call_with_timeout("echo", 1, timeout=10)
    assert not stranger.ping(timeout=5)
    monkeypatch.setenv("RSDL_CLUSTER_TOKEN", "actor-test-secret")
    assert tcp_actor.ping(timeout=5) and tcp_actor.call("echo", 2) == 2
