"""Named actors: one object served from its own spawned process.

``spawn_actor(cls, *args, name=..)`` starts a spawned process that builds
``cls(*args)`` and serves its methods with an asyncio server: on a unix
socket under the session directory, or with ``host=`` on TCP (the
multi-host control plane, :mod:`.cluster`). Every request runs as its own
loop task and ``async def`` methods are awaited there, so a call blocked
in an ``await`` (a queue ``get``) never stalls another caller's ``put``:
the concurrency model of an async actor. A named actor writes a record
(address and pid) into the session's registry directory;
:func:`connect_actor` resolves it with backoff, from any process of the
session, and in a cluster also through the head's registry.

Frames are :mod:`.transport`'s. Clients hold one blocking connection per
calling thread; ``call_oneway`` sends and does not wait for a reply. A
method may return a :class:`~.transport.OutOfBand`: its bulk buffers then
follow the reply's pickled header raw, sent from an executor thread, and
:meth:`ActorHandle.call_vectored` lands them in a buffer of the caller's.
Every request carries the caller's trace context (:func:`.telemetry.outbound`,
None while its planes are off); the host runs the dispatch in it under an
``actor:<method>`` span and spools its metrics after each dispatch.

This module imports the standard library only.
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import multiprocessing as mp
import os
import secrets
import signal
import socket
import sys
import threading
import time
import traceback
import weakref
from typing import Optional

from ray_shuffling_data_loader_tpu_torch import telemetry
from ray_shuffling_data_loader_tpu_torch.telemetry import _env

from . import transport
from .retry import call_policy, connect_policy
from .transport import Address


class ActorDiedError(Exception):
    """The actor's process cannot be reached (exited, never started, or
    its connection broke mid-call)."""


class RemoteError(Exception):
    """An actor method raised an exception that could not be sent back;
    carries the remote traceback."""


def _registry_dir(runtime_dir: str) -> str:
    return os.path.join(runtime_dir, "actors")


def _registry_path(runtime_dir: str, name: str) -> str:
    return os.path.join(_registry_dir(runtime_dir), f"{name}.json")


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    return True


def _sendmsg_on_fd(fd: int, frames) -> None:
    """:func:`transport.sendmsg_all` on a duplicate of the connection's
    descriptor. The event loop hands out its sockets as
    ``asyncio.trsock.TransportSocket``, which has no ``sendmsg`` (Python
    3.12), so the send goes through a socket object of its own over the
    same open file; the duplicate shares the loop's non-blocking mode,
    which the send's poll handles, and closing it leaves the loop's
    descriptor open."""
    raw = socket.socket(fileno=os.dup(fd))
    try:
        transport.sendmsg_all(raw, frames)
    finally:
        raw.close()


# -- telemetry ----------------------------------------------------------------


def _flush_telemetry_spools(maybe: bool = False) -> None:
    """The actor host's spool barrier, after a dispatch and at exit: the
    trace buffer when its module is loaded (never loaded, nothing
    buffered), the metrics snapshot only with metrics on (``maybe``: at
    most once a second), and at exit the profile (its sampler spools it
    once a second meanwhile); then the relay's kick, which wakes this
    host's shipper. Imports nothing while every plane is off."""
    for name in ("trace", "capacity") if maybe else ("trace", "capacity", "profiler"):
        mod = sys.modules.get(f"ray_shuffling_data_loader_tpu_torch.telemetry.{name}")
        if mod is not None:
            mod.safe_flush()
    if telemetry.metrics.enabled():
        if maybe:
            telemetry.export.maybe_flush()
        else:
            telemetry.export.safe_flush()
    if _env.relay_armed():
        try:
            from ray_shuffling_data_loader_tpu_torch.telemetry import relay

            relay.kick()
        except Exception:
            pass


# Virtual thread ids for traced dispatches: concurrent dispatches run on
# the one event-loop thread, so their spans overlap without nesting, which
# one Chrome-trace track cannot draw. Each traced dispatch in flight
# borrows an id from a free list (tracks = peak concurrency).
_VTID_BASE = 1 << 20
_vtid_lock = threading.Lock()
_vtid_free: list = []
_vtid_high = 0


def _acquire_vtid() -> int:
    global _vtid_high
    with _vtid_lock:
        if _vtid_free:
            return _vtid_free.pop()
        _vtid_high += 1
        tid = _VTID_BASE + _vtid_high
    telemetry.name_thread_track(tid, f"dispatch-{tid - _VTID_BASE}")
    return tid


def _release_vtid(tid: int) -> None:
    with _vtid_lock:
        _vtid_free.append(tid)


# -- server side ------------------------------------------------------------


class _ActorHost:
    """Serves one instance's methods inside the actor process."""

    def __init__(self, instance, address: Address):
        self.instance = instance
        self.address = address
        self._shutdown: Optional[asyncio.Event] = None
        self._server = None
        self._tasks: set = set()  # the loop holds tasks weakly
        self._inflight = 0
        # One reply lock per connection: an OutOfBand payload is written
        # by an executor thread on the raw descriptor, so every reply on
        # that connection, and its close, waits for it (a close mid-send
        # would free the descriptor under the thread).
        self._write_locks: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()

    def _writer_lock(self, writer) -> asyncio.Lock:
        lock = self._write_locks.get(writer)
        if lock is None:
            lock = self._write_locks[writer] = asyncio.Lock()
        return lock

    async def _send_out_of_band(self, writer, req_id, oob: transport.OutOfBand) -> None:
        """A vectored reply whose payload an executor thread sends straight
        on the connection (``sendmsg`` releases the GIL, so concurrent
        stripes of a striped fetch go out on several cores). Only once the
        transport's own buffer is empty: raw bytes must not overtake bytes
        the loop still holds."""
        sock = writer.get_extra_info("socket")
        if sock is None:
            transport.write_frame_vectored(writer, (req_id, "okv", oob.meta), oob.buffers)
            await writer.drain()
            return
        frames = transport.vectored_frames((req_id, "okv", oob.meta), oob.buffers)
        tr = writer.transport
        spins = 0
        deadline = time.monotonic() + 120.0
        while tr.get_write_buffer_size() > 0:
            if tr.is_closing():
                raise ConnectionError("connection closed mid-reply")
            if time.monotonic() > deadline:
                raise ConnectionError("peer stalled a buffered reply > 120s")
            await asyncio.sleep(0 if spins < 16 else 0.001)
            spins += 1
        await asyncio.get_running_loop().run_in_executor(None, _sendmsg_on_fd, sock.fileno(), frames)

    async def _handle_client(self, reader, writer):
        try:
            while True:
                try:
                    frame = await transport.read_frame(reader)
                except (asyncio.IncompleteReadError, ConnectionError):
                    break
                # A 5-tuple, or 6 with the caller's trace context (None
                # while the caller's telemetry planes are off).
                req_id, method, args, kwargs, oneway = frame[:5]
                trace_ctx = frame[5] if len(frame) > 5 else None
                # Each request is its own task: a blocked get on this
                # connection must not hold up the requests behind it.
                task = asyncio.get_running_loop().create_task(
                    self._dispatch(writer, req_id, method, args, kwargs, oneway, trace_ctx)
                )
                self._tasks.add(task)
                task.add_done_callback(self._tasks.discard)
        finally:
            async with self._writer_lock(writer):
                try:
                    writer.close()
                except Exception:
                    pass

    async def _reply(self, writer, frame) -> None:
        async with self._writer_lock(writer):
            transport.write_frame(writer, frame)
            await writer.drain()

    async def _dispatch(self, writer, req_id, method, args, kwargs, oneway, trace_ctx=None):
        self._inflight += 1
        try:
            await self._run_dispatch(writer, req_id, method, args, kwargs, oneway, trace_ctx)
        finally:
            # After each dispatch the metrics snapshot spools (at most once
            # a second); at quiescence the trace buffer drains too.
            self._inflight -= 1
            if telemetry.metrics.enabled() or self._inflight == 0:
                _flush_telemetry_spools(maybe=True)

    async def _run_dispatch(self, writer, req_id, method, args, kwargs, oneway, trace_ctx):
        try:
            if method == "__ping__":
                result = "pong"
            elif method == "__terminate__":
                result = None
                self._shutdown.set()
            else:
                faults = transport.faults()
                if faults.enabled():
                    # Liveness faults: ``kill`` ends the process at once,
                    # ``wedge`` blocks the event loop, so that pings go
                    # unanswered too.
                    faults.fire(f"actor.{type(self.instance).__name__}")
                # With a caller's context, the dispatch runs in it under an
                # ``actor:<method>`` span, awaits included (how long
                # new_epoch waited for admission), on a virtual track of
                # its own. Each dispatch is its own task with its own
                # contextvars, so a context held across an await does not
                # leak into another dispatch.
                fn = getattr(self.instance, method)
                vtid = _acquire_vtid() if trace_ctx is not None else None
                try:
                    with telemetry.propagated_span(
                        f"actor:{method}", trace_ctx, cat="actor", tid=vtid
                    ) if vtid is not None else contextlib.nullcontext():
                        result = fn(*args, **kwargs)
                        if asyncio.iscoroutine(result):
                            result = await result
                finally:
                    if vtid is not None:
                        _release_vtid(vtid)
            if oneway:
                return
            if isinstance(result, transport.OutOfBand):
                try:
                    async with self._writer_lock(writer):
                        await self._send_out_of_band(writer, req_id, result)
                except Exception:
                    # Part of the frame may be on the wire: the connection's
                    # framing is gone, so close it and let the caller fail
                    # into its ActorDiedError instead of reading garbage.
                    try:
                        writer.close()
                    except Exception:
                        pass
                return
            await self._reply(writer, (req_id, "ok", result))
        except Exception as exc:  # noqa: BLE001 -- the caller re-raises it
            if oneway:
                return
            tb = traceback.format_exc()
            try:
                await self._reply(writer, (req_id, "err", (exc, tb)))
            except Exception:
                # The exception did not pickle: send its text.
                try:
                    await self._reply(writer, (req_id, "err", (None, tb)))
                except Exception:
                    pass

    async def start(self):
        """Bind the server; a TCP port 0 becomes the port the system chose.
        Then the instance's ``setup()``, if it has one."""
        self._shutdown = asyncio.Event()
        self._server = await transport.start_server(self.address, self._handle_client)
        if self.address[0] == "tcp" and self.address[2] == 0:
            self.address = ("tcp", self.address[1], self._server.sockets[0].getsockname()[1])
        setup = getattr(self.instance, "setup", None)
        if setup is not None:
            result = setup()
            if asyncio.iscoroutine(result):
                await result

    async def wait_shutdown(self):
        await self._shutdown.wait()
        # Not ``async with``: its wait_closed() would wait for every
        # client to hang up. Open connections die with the loop.
        self._server.close()
        # The instance's ``teardown()`` (a host agent stops its pool).
        teardown = getattr(self.instance, "teardown", None)
        if teardown is not None:
            result = teardown()
            if asyncio.iscoroutine(result):
                await result


def _actor_main(cls, args, kwargs, address: Address, registry_path, ready_q, watch_parent: int):
    """Entry point of the actor's spawned process."""

    def _watch():
        # Daemonic children die with a parent that exits cleanly, not with
        # one that was killed; a non-daemonic one (a host agent, which
        # spawns its own pool) not even then.
        while True:
            time.sleep(1.0)
            if not _pid_alive(watch_parent):
                os._exit(0)

    threading.Thread(target=_watch, daemon=True).start()
    transport.faults().set_role("actor")
    if _env.read_flag("RSDL_PROFILE"):
        try:
            from ray_shuffling_data_loader_tpu_torch.telemetry import profiler

            profiler.start()
        except Exception:
            pass
    if telemetry.traced():
        telemetry.set_process_name(f"actor:{cls.__name__}-{os.getpid()}")
    try:
        host = _ActorHost(cls(*args, **kwargs), address)
    except Exception:
        ready_q.put(("err", traceback.format_exc()))
        return

    async def run():
        await host.start()  # bound before readiness is announced
        if registry_path is not None:
            tmp = registry_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump({"address": list(host.address), "pid": os.getpid()}, f)
            os.replace(tmp, registry_path)
        # The bound address travels back: a TCP port 0 became a real one.
        ready_q.put(("ok", list(host.address)))
        await host.wait_shutdown()

    try:
        asyncio.run(run())
    except KeyboardInterrupt:
        pass
    finally:
        # A graceful terminate ends here: this host's spans and final
        # metrics snapshot reach their spools before it exits.
        _flush_telemetry_spools()
        paths = [registry_path] + ([address[1]] if address[0] == "unix" else [])
        for path in paths:
            if path is not None:
                try:
                    os.unlink(path)
                except FileNotFoundError:
                    pass


# -- client side ------------------------------------------------------------


class ActorHandle:
    """Client proxy: ``call`` blocks for the result, ``call_oneway`` does
    not wait, ``call_vectored`` takes an out-of-band reply. Picklable:
    handles travel inside task arguments."""

    def __init__(self, address: Address, pid: Optional[int] = None, name: Optional[str] = None):
        self.address = tuple(address)
        self.pid = pid
        self.name = name
        self._local = threading.local()
        self._req_counter = 0
        self._counter_lock = threading.Lock()

    def __getstate__(self):
        return {"address": self.address, "pid": self.pid, "name": self.name}

    def __setstate__(self, state):
        self.__init__(state["address"], state["pid"], state["name"])

    def _label(self) -> str:
        return self.name or str(self.address)

    def _next_id(self) -> int:
        with self._counter_lock:
            self._req_counter += 1
            return self._req_counter

    def _conn(self) -> transport.Connection:
        conn = getattr(self._local, "conn", None)
        if conn is None:
            try:
                conn = transport.Connection(self.address)
            except OSError as e:  # ConnectionError and FileNotFoundError too
                raise ActorDiedError(f"cannot connect to actor {self._label()}: {e}") from e
            self._local.conn = conn
        return conn

    def _send_with_retry(self, req_id, method, args, kwargs, oneway) -> transport.Connection:
        """Send one request frame on this thread's connection, retrying a
        refused connect or a reset send (the request never ran then, so a
        retry cannot run it twice). A failure after the frame went out is
        the caller's: the method may have run."""
        policy = call_policy()
        last: Optional[Exception] = None
        for attempt, handle in policy.attempts(site="actor.send"):
            try:
                conn = self._conn()
                conn.send((req_id, method, args, kwargs, oneway, telemetry.outbound()))
                return conn
            except (ActorDiedError, OSError) as e:
                # A reset connection (a fault of ``transport.send`` among
                # them) is closed and dialled again.
                conn = getattr(self._local, "conn", None)
                if conn is not None:
                    conn.close()
                self._local.conn = None
                last = e
                if attempt < policy.max_attempts:
                    handle.backoff(str(e))
        raise ActorDiedError(
            f"cannot reach actor {self._label()} after {policy.max_attempts} attempts: {last}"
        ) from last

    def call(self, method: str, *args, **kwargs):
        # ``into`` is this client's: a remote keyword of that name fails
        # loudly (a duplicate keyword) instead of being taken for it.
        return self.call_vectored(method, *args, into=None, **kwargs)[0]

    def call_oneway(self, method: str, *args, **kwargs) -> None:
        self._send_with_retry(self._next_id(), method, args, kwargs, True)

    def call_vectored(self, method: str, *args, into=None, **kwargs):
        """Call a method whose reply may be an out-of-band frame. Returns
        ``(meta, payload_view)``, the payload landed in the buffer
        ``into(total_bytes)`` returns, or ``(result, None)`` for a plain
        reply. An allocator with a truthy ``wants_meta`` is called
        ``into(total_bytes, meta)``: a striped fetch places its window by
        the stripe range in the meta."""
        req_id = self._next_id()
        if into is not None and getattr(into, "wants_meta", False):
            user_into = into

            def _shim(total, frame):
                # frame is the whole (req_id, status, meta) reply.
                return user_into(total, frame[2])

            _shim.wants_meta = True
            into = _shim
        conn = self._send_with_retry(req_id, method, args, kwargs, False)
        try:
            while True:
                frame, payload = conn.recv_frame(into=into)
                resp_id, status, meta = frame
                if resp_id == req_id:
                    break
        except OSError as e:
            self._local.conn = None
            raise ActorDiedError(f"actor {self._label()} died mid-call: {e}") from e
        if status == "okv":
            return meta, payload
        if status == "ok":
            return meta, None
        exc, tb = meta
        if isinstance(exc, Exception):
            raise exc
        raise RemoteError(f"remote call {method} failed:\n{tb}")

    def call_with_timeout(self, method: str, *args, timeout: float = 30.0, **kwargs):
        """One call on a connection of its own with a timeout: control
        calls that must not hang on a half-dead host. A timeout or a
        broken connection raises :class:`ActorDiedError`."""
        try:
            conn = transport.Connection(self.address, timeout=timeout)
        except OSError as e:
            raise ActorDiedError(f"actor {self._label()} unreachable: {e}") from e
        try:
            conn.send((0, method, args, kwargs, False, telemetry.outbound()))
            while True:
                resp_id, status, payload = conn.recv()
                if resp_id == 0:
                    break
        except OSError as e:
            raise ActorDiedError(f"actor {self._label()} did not answer {method} within {timeout}s: {e}") from e
        finally:
            conn.close()
        if status == "ok":
            return payload
        exc, tb = payload
        if isinstance(exc, Exception):
            raise exc
        raise RemoteError(f"remote call {method} failed:\n{tb}")

    def ping(self, timeout: Optional[float] = None) -> bool:
        """On its own connection with a timeout: a wedged actor answers
        False instead of hanging the caller."""
        try:
            conn = transport.Connection(self.address, timeout=timeout)
        except OSError:
            return False
        try:
            conn.send((0, "__ping__", (), {}, False, None))
            _, status, payload = conn.recv()
            return status == "ok" and payload == "pong"
        except Exception:
            return False
        finally:
            conn.close()

    def wait_ready(self, timeout: float = 30.0) -> None:
        deadline = time.monotonic() + timeout
        delay = 0.005
        while not self.ping(timeout=min(2.0, timeout)):
            if time.monotonic() > deadline:
                raise ActorDiedError(f"actor {self._label()} not ready after {timeout}s")
            time.sleep(delay)
            delay = min(delay * 2, 0.25)

    def _alive(self) -> bool:
        proc = getattr(self, "_process", None)
        if proc is not None:  # our child: is_alive() also reaps it
            return proc.is_alive()
        return self.pid is not None and _pid_alive(self.pid)

    def terminate(self, force: bool = False, grace_period_s: float = 5.0) -> None:
        """Ask the actor to stop; after ``grace_period_s`` (or at once with
        ``force``) kill its process. A handle without a pid (an actor on
        another host) is only asked."""
        if not force:
            try:
                self.call("__terminate__")
            except (ActorDiedError, RemoteError):
                pass
            deadline = time.monotonic() + grace_period_s
            while self._alive() and time.monotonic() < deadline:
                time.sleep(0.02)
        if self._alive():
            try:
                os.kill(self.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            proc = getattr(self, "_process", None)
            if proc is not None:
                proc.join(timeout=grace_period_s)


# -- spawning and discovery -------------------------------------------------


def spawn_actor(
    cls,
    *args,
    name: Optional[str] = None,
    runtime_dir: str,
    host: Optional[str] = None,
    port: int = 0,
    daemon: bool = True,
    **kwargs,
) -> ActorHandle:
    """Start ``cls(*args, **kwargs)`` in a spawned process and return a
    handle once it serves: on TCP at ``host`` (port 0: one the system
    picks) when given, else on a unix socket in ``runtime_dir``.
    ``daemon=False`` is for an actor that spawns processes itself (a
    daemonic process may not); it still exits when its parent does. A
    name held by a live actor raises ``ValueError``; the record of a dead
    one is reclaimed."""
    os.makedirs(_registry_dir(runtime_dir), exist_ok=True)
    if host is not None:
        address: Address = ("tcp", host, port)
    else:
        address = ("unix", os.path.join(runtime_dir, f"a-{secrets.token_hex(4)}.sock"))
    registry_path = _registry_path(runtime_dir, name) if name is not None else None
    if registry_path is not None and os.path.exists(registry_path):
        stale = resolve_actor(name, runtime_dir)
        if stale is not None and stale.pid is not None and _pid_alive(stale.pid):
            raise ValueError(f"actor name {name!r} already registered")
        try:
            os.unlink(registry_path)
        except FileNotFoundError:
            pass
    ctx = mp.get_context("spawn")
    ready_q = ctx.Queue()
    proc = ctx.Process(
        target=_actor_main,
        args=(cls, args, kwargs, address, registry_path, ready_q, os.getpid()),
        daemon=daemon,
    )
    proc.start()
    deadline = time.monotonic() + float(os.environ.get("RSDL_SPAWN_READY_TIMEOUT_S", "120"))
    while True:
        try:
            status, payload = ready_q.get(timeout=0.2)
            break
        except Exception:  # queue.Empty
            if not proc.is_alive():
                raise RuntimeError(
                    f"actor {cls.__name__} exited during startup (exit code {proc.exitcode})"
                ) from None
            if time.monotonic() > deadline:
                proc.kill()
                proc.join(5)
                raise RuntimeError(f"actor {cls.__name__} did not announce readiness") from None
    if status != "ok":
        proc.join(5)
        raise RuntimeError(f"actor {cls.__name__} failed to start:\n{payload}")
    handle = ActorHandle(tuple(payload), pid=proc.pid, name=name)
    handle._process = proc
    return handle


def resolve_actor(name: str, runtime_dir: str) -> Optional[ActorHandle]:
    """The handle in ``name``'s registry record, or None."""
    try:
        with open(_registry_path(runtime_dir, name)) as f:
            record = json.load(f)
    except (FileNotFoundError, json.JSONDecodeError):
        return None
    return ActorHandle(tuple(record["address"]), pid=record.get("pid"), name=name)


def connect_actor(name: str, runtime_dir: str, num_retries: int = 5, fallback_resolver=None) -> ActorHandle:
    """A live named actor, retried with capped, jittered backoff while it
    is not registered or does not answer. ``fallback_resolver(name)`` is
    asked when the session's registry has no record (in a cluster: the
    head's registry)."""
    policy = connect_policy(num_retries)
    for attempt, handle in policy.attempts(site="connect_actor"):
        actor = resolve_actor(name, runtime_dir)
        if actor is None and fallback_resolver is not None:
            actor = fallback_resolver(name)
        if actor is not None and actor.ping(timeout=5.0):
            return actor
        if attempt < policy.max_attempts:
            handle.backoff(f"no live actor registered as {name!r}")
    raise ValueError(f"Unable to connect to actor {name!r} after {num_retries} retries")
