"""The actors' and the store servers' wire: length-prefixed pickle frames
over stream sockets.

Addresses are tagged tuples, ``("unix", path)`` on one host and ``("tcp",
host, port)`` between hosts, and the same frames run over both.

TCP security: frames are pickles, so accepting them from any peer would
run its code. Every TCP connection therefore starts with an HMAC
challenge: the server sends a random nonce, the client answers
``HMAC-SHA256(token, nonce)`` keyed by the cluster's secret
(``$RSDL_CLUSTER_TOKEN``, minted by ``init_cluster`` and carried in the
``tcp://host:port/<token>`` join address), and a peer whose answer does
not match is dropped before any pickle is read. The secret never crosses
the wire; holding it is the trust anchor, so run clusters on a private
network. Unix sockets rely on the 0o700 runtime directory instead.

Vectored frames carry bulk bytes outside the pickle: a pickled header
names the payload's sizes and the raw bytes follow, landed by the
receiver straight in a buffer it chooses (``recv_into`` an mmapped cache
file). ``RSDL_TCP_ZEROCOPY`` (default off) turns the store's fetches onto
them, and ``RSDL_TCP_STREAMS`` (1 to 16, default 1) stripes each such
fetch over that many connections.

The fault sites ``transport.send`` (before a frame is sent: the peer saw
nothing, so a retry is safe) and ``transport.recv`` fire here
(:mod:`.faults`).

This module imports the standard library only.
"""

from __future__ import annotations

import asyncio
import hmac
import os
import pickle
import socket
import struct
from typing import Any, Callable, List, Optional, Sequence, Tuple

_LEN = struct.Struct("<Q")
_AUTH_MAGIC = b"RSDLAUTH"
_NONCE_LEN = 16

# Vectored-frame marker: the top bit of the length prefix. When set, the
# remaining 63 bits are the length of a pickled ``(obj, [payload sizes])``
# header and ``sum(sizes)`` raw payload bytes follow the header directly —
# bulk data never transits pickle, and the receiver lands it straight in a
# caller-provided buffer (``recv_into`` an mmapped cache segment). Plain
# frames are unchanged, so the two framings interleave on one connection.
_VEC_FLAG = 1 << 63
# sendmsg iov count stays far below any IOV_MAX (Linux: 1024).
_SENDMSG_MAX_VECS = 512

# Data-plane socket buffer size. Default kernel buffers autotune from
# ~128 KB, which turns a multi-MB window transfer into dozens of
# event-loop ping-pongs; one setsockopt per connection avoids them, and
# the kernel clamps an over-ask to net.core.{r,w}mem_max.
_SOCK_BUF_BYTES = 4 << 20


def _tune_sock(sock: socket.socket) -> None:
    try:
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, _SOCK_BUF_BYTES)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, _SOCK_BUF_BYTES)
    except OSError:
        pass

ENV_ZEROCOPY = "RSDL_TCP_ZEROCOPY"
_zerocopy: Optional[bool] = None  # tri-state cache, like the telemetry gates

ENV_TCP_STREAMS = "RSDL_TCP_STREAMS"
_MAX_TCP_STREAMS = 16
_tcp_streams: Optional[int] = None


def zerocopy_enabled() -> bool:
    """Is the zero-copy vectored fetch plane on (``RSDL_TCP_ZEROCOPY``)?
    Off by default — the gated contract shared with the telemetry planes:
    when off, no vectored frame is ever requested and the legacy pickle
    path runs untouched. One cached boolean after the first read."""
    global _zerocopy
    if _zerocopy is None:
        _zerocopy = os.environ.get(ENV_ZEROCOPY, "").strip().lower() in (
            "1", "on", "true", "yes",
        )
    return _zerocopy


def refresh_zerocopy_from_env() -> None:
    """Forget the cached gate; next check re-reads the env (tests/bench)."""
    global _zerocopy
    _zerocopy = None


def tcp_streams() -> int:
    """Persistent connections per peer for striped zero-copy fetches
    (``RSDL_TCP_STREAMS``; default 1 = single-stream, the pre-striping
    wire behavior untouched). Clamped to [1, 16] — each stream costs a
    socket + HMAC handshake per peer, and recv parallelism past the
    core count buys nothing. Read once, like the zerocopy gate; only
    meaningful with ``RSDL_TCP_ZEROCOPY`` on (the legacy pickle path
    never stripes)."""
    global _tcp_streams
    if _tcp_streams is None:
        try:
            n = int(os.environ.get(ENV_TCP_STREAMS, "1").strip() or "1")
        except ValueError:
            n = 1
        _tcp_streams = max(1, min(_MAX_TCP_STREAMS, n))
    return _tcp_streams


def refresh_tcp_streams_from_env() -> None:
    """Forget the cached stream count; next check re-reads (tests/bench)."""
    global _tcp_streams
    _tcp_streams = None


class OutOfBand:
    """An actor-method result whose bulk payload rides outside the pickle
    frame: ``meta`` is pickled into the reply header, ``buffers`` are
    buffer-protocol objects (mmaps, numpy views) streamed verbatim after
    it. ``keepalive`` pins whatever owns the buffers' memory until the
    reply is written."""

    __slots__ = ("meta", "buffers", "keepalive")

    def __init__(self, meta: Any, buffers: Sequence, keepalive: Any = None):
        self.meta = meta
        self.buffers = list(buffers)
        self.keepalive = keepalive


# Address = ("unix", path) | ("tcp", host, port)
Address = Tuple


def cluster_token() -> Optional[bytes]:
    token = os.environ.get("RSDL_CLUSTER_TOKEN")
    return token.encode() if token else None


def _challenge() -> bytes:
    return _AUTH_MAGIC + os.urandom(_NONCE_LEN)


def _response(token: bytes, challenge: bytes) -> bytes:
    return hmac.new(token, challenge, "sha256").digest()


def _answer_challenge_sync(sock: socket.socket, token: bytes) -> None:
    """Client side, blocking socket: read the server's nonce, answer with
    the keyed digest."""
    challenge = _recv_exact_sock(sock, _LEN.size)
    (length,) = _LEN.unpack(challenge)
    if length != len(_AUTH_MAGIC) + _NONCE_LEN:
        raise ConnectionError("malformed auth challenge")
    blob = _recv_exact_sock(sock, length)
    if not blob.startswith(_AUTH_MAGIC):
        raise ConnectionError("malformed auth challenge")
    answer = _response(token, blob)
    sock.sendall(_LEN.pack(len(answer)) + answer)


def _recv_exact_sock(sock: socket.socket, n: int) -> bytes:
    chunks = []
    while n:
        chunk = sock.recv(min(n, 1 << 20))
        if not chunk:
            raise ConnectionError("connection closed by peer")
        chunks.append(chunk)
        n -= len(chunk)
    return b"".join(chunks)


def sendmsg_all(
    sock: socket.socket, views: Sequence, timeout_s: float = 120.0
) -> None:
    """``sendall`` over a scatter-gather list via ``sendmsg``, advancing
    across partial sends without coalescing buffers in user space. Works
    on blocking AND non-blocking sockets: on ``EAGAIN`` it waits for
    writability with ``select`` (bounded by ``timeout_s`` per wait) —
    the actor host calls this from an executor thread on a socket whose
    event loop owns the fd, so the socket's blocking mode must not be
    touched. ``sendmsg`` releases the GIL, so concurrent replies to
    different peers stream on different cores."""
    import select as _select

    # poll(), not select(): select raises ValueError for any fd >= 1024
    # (FD_SETSIZE) — easily exceeded on a serving host once striping
    # multiplies per-peer connections.
    poller = _select.poll()
    poller.register(sock.fileno(), _select.POLLOUT)
    queue = [memoryview(v).cast("B") for v in views if memoryview(v).nbytes]
    while queue:
        try:
            sent = sock.sendmsg(queue[:_SENDMSG_MAX_VECS])
        except InterruptedError:
            continue
        except BlockingIOError:
            if not poller.poll(timeout_s * 1000.0):
                raise ConnectionError(
                    f"peer stalled a vectored send > {timeout_s:.0f}s"
                ) from None
            continue
        while sent:
            head = queue[0]
            if sent >= head.nbytes:
                sent -= head.nbytes
                queue.pop(0)
            else:
                queue[0] = head[sent:]
                sent = 0


def dumps(obj: Any) -> bytes:
    return pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)


def vectored_frames(obj: Any, buffers: Sequence) -> List[memoryview]:
    """THE encoder of the vectored wire frame, as a scatter-gather list:
    ``[len|_VEC_FLAG][pickle((obj, sizes))][payload bytes...]``. Every
    sender (sync ``send_vectored``, asyncio ``write_frame_vectored``,
    the actor host's executor-thread reply) builds its frame here so the
    layout can never drift between them."""
    views = [memoryview(b).cast("B") for b in buffers]
    header = dumps((obj, [v.nbytes for v in views]))
    return [
        memoryview(_LEN.pack(_VEC_FLAG | len(header))),
        memoryview(header),
        *views,
    ]


loads = pickle.loads


# -- sync client side -------------------------------------------------------


def faults():
    """The fault plane (:mod:`.faults`), imported at the first site that
    asks, not with this module."""
    from . import faults as plane

    return plane


class Connection:
    """A blocking framed connection (one per calling thread)."""

    def __init__(self, address: Address, timeout: float = None):
        self.address = address
        if address[0] == "unix":
            self.sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            # Timeout must cover connect() too: a half-dead peer (host up,
            # process wedged) hangs the connect, not just the recv.
            if timeout is not None:
                self.sock.settimeout(timeout)
            self.sock.connect(address[1])
        elif address[0] == "tcp":
            self.sock = socket.create_connection(
                (address[1], address[2]), timeout=timeout
            )
            try:
                self.sock.setsockopt(
                    socket.IPPROTO_TCP, socket.TCP_NODELAY, 1
                )
                _tune_sock(self.sock)
                token = cluster_token()
                if token is not None:
                    # Don't hang forever on a server that never challenges.
                    self.sock.settimeout(30.0)
                    _answer_challenge_sync(self.sock, token)
                    self.sock.settimeout(timeout)
            except BaseException:
                # Auth/handshake failed: a retry loop in the actor layer
                # must not accumulate leaked fds until EMFILE.
                self.sock.close()
                raise
        else:
            raise ValueError(f"unknown address scheme: {address!r}")
        if timeout is not None:
            self.sock.settimeout(timeout)

    def send(self, obj: Any) -> None:
        if faults().enabled():
            faults().fire("transport.send")
        payload = dumps(obj)
        self.sock.sendall(_LEN.pack(len(payload)) + payload)

    def send_vectored(self, obj: Any, buffers: Sequence) -> None:
        """Send ``obj`` plus raw payload buffers as ONE vectored frame:
        header and payload hit the wire through a single ``sendmsg``
        scatter-gather call (no intermediate ``bytes`` join, no pickle of
        the payload). The receiver must use :meth:`recv_frame`.

        Today's production bulk flow is server->client (StoreServer
        replies via the asyncio :func:`write_frame_vectored`); this sync
        send side is the client->server half of the same framing —
        covered by the transport tests and reserved for a zero-copy put
        path."""
        if faults().enabled():
            faults().fire("transport.send")
        sendmsg_all(self.sock, vectored_frames(obj, buffers))

    def recv(self) -> Any:
        return self.recv_frame()[0]

    def recv_frame(
        self, into: Optional[Callable[[int], Any]] = None
    ) -> Tuple[Any, Optional[memoryview]]:
        """Read one frame. Plain frames return ``(obj, None)``. Vectored
        frames return ``(obj, payload_view)`` with the payload landed via
        ``recv_into`` in the buffer ``into(total_bytes)`` returns (an
        mmapped cache file on the fetch path) — or a throwaway bytearray
        when no allocator is given. An allocator carrying a truthy
        ``wants_meta`` attribute is called ``into(total_bytes, obj)``
        instead — the striped fetch plane needs the reply's stripe
        byte-range (carried in the header object) to hand back the right
        window of the shared destination mapping."""
        if faults().enabled():
            faults().fire("transport.recv")
        header = self._recv_exact(_LEN.size)
        (length,) = _LEN.unpack(header)
        if not length & _VEC_FLAG:
            return loads(self._recv_exact(length)), None
        obj, sizes = loads(self._recv_exact(length & ~_VEC_FLAG))
        total = int(sum(sizes))
        if into is None:
            raw = bytearray(total)
        elif getattr(into, "wants_meta", False):
            raw = into(total, obj)
        else:
            raw = into(total)
        # _recv_exact_into creates and RELEASES its own views: on a
        # mid-payload failure no memoryview over ``raw`` may survive
        # into the traceback — the fetch path's error cleanup closes the
        # underlying mmap, and a still-exported view would turn the
        # recoverable ConnectionError into BufferError at close().
        self._recv_exact_into(raw, total)
        return obj, memoryview(raw).cast("B")[:total]

    def _recv_exact(self, n: int) -> bytes:
        chunks = []
        while n:
            chunk = self.sock.recv(min(n, 1 << 20))
            if not chunk:
                raise ConnectionError("connection closed by peer")
            chunks.append(chunk)
            n -= len(chunk)
        return b"".join(chunks)

    def _recv_exact_into(self, buf, n: int) -> None:
        """Fill ``buf[:n]`` from the socket. The view over ``buf`` is
        released on EVERY exit path (the caller may need to close the
        buffer's mmap during exception cleanup — see recv_frame)."""
        view = memoryview(buf).cast("B")
        try:
            off = 0
            while off < n:
                got = self.sock.recv_into(view[off:n])
                if not got:
                    raise ConnectionError("connection closed by peer")
                off += got
        finally:
            view.release()

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


# -- asyncio side (used by actor servers and async clients) -----------------


async def read_frame(reader: asyncio.StreamReader) -> Any:
    header = await reader.readexactly(_LEN.size)
    (length,) = _LEN.unpack(header)
    if length & _VEC_FLAG:
        # Vectored frames only flow server -> sync fetch client; an actor
        # server (or the async demux client) receiving one is a protocol
        # violation — fail the connection rather than unpickle garbage.
        raise ConnectionError("unexpected vectored frame")
    return loads(await reader.readexactly(length))


def write_frame(writer: asyncio.StreamWriter, obj: Any) -> None:
    payload = dumps(obj)
    writer.write(_LEN.pack(len(payload)) + payload)


def write_frame_vectored(
    writer: asyncio.StreamWriter, obj: Any, buffers: Sequence
) -> None:
    """Server side of a vectored reply: pickled header, then each payload
    buffer written as-is (the transport sends what it can immediately and
    buffers only the remainder — no payload pickle, no join). Sources may
    be released once this returns: asyncio copies unsent tails."""
    for v in vectored_frames(obj, buffers):
        if v.nbytes:
            writer.write(v)


async def start_server(address: Address, handler):
    if address[0] == "unix":
        return await asyncio.start_unix_server(handler, path=address[1])
    elif address[0] == "tcp":
        token = cluster_token()

        async def tcp_handler(reader, writer):
            # Data-plane socket + write-buffer tuning: large socket
            # buffers (see _SOCK_BUF_BYTES) and a matching asyncio
            # write high-water mark, so a multi-MB vectored reply
            # drains in a few loop iterations instead of dozens.
            sock = writer.get_extra_info("socket")
            if sock is not None:
                _tune_sock(sock)
            try:
                writer.transport.set_write_buffer_limits(
                    high=_SOCK_BUF_BYTES
                )
            except (AttributeError, RuntimeError):
                pass
            # Gate BEFORE any pickle touches peer bytes: challenge the
            # peer with a nonce; the first frame back must be the keyed
            # digest. 10 s auth deadline so half-open peers can't pin
            # server tasks.
            if token is not None:
                try:
                    challenge = _challenge()
                    writer.write(_LEN.pack(len(challenge)) + challenge)
                    await writer.drain()
                    header = await asyncio.wait_for(
                        reader.readexactly(_LEN.size), 10.0
                    )
                    (length,) = _LEN.unpack(header)
                    if length > 4096:
                        raise ConnectionError("oversized auth frame")
                    blob = await asyncio.wait_for(
                        reader.readexactly(length), 10.0
                    )
                    expected = _response(token, challenge)
                    if not hmac.compare_digest(blob, expected):
                        raise ConnectionError("bad auth response")
                except (
                    asyncio.IncompleteReadError,
                    asyncio.TimeoutError,
                    ConnectionError,
                    OSError,
                ):
                    try:
                        writer.close()
                    except Exception:
                        pass
                    return
            await handler(reader, writer)

        return await asyncio.start_server(tcp_handler, address[1], address[2])
    raise ValueError(f"unknown address scheme: {address!r}")
