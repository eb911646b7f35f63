"""Named actors: one object served from its own spawned process.

``spawn_actor(cls, *args, name=..)`` starts a spawned process that builds
``cls(*args)`` and serves its methods on a unix socket under the session
directory with an asyncio server. Every request runs as its own loop task
and ``async def`` methods are awaited there, so a call blocked in an
``await`` (a queue ``get``) never stalls another caller's ``put``: the
concurrency model of an async actor. A named actor writes a record
(address and pid) into the session's registry directory;
:func:`connect_actor` resolves it with backoff, from any process of the
session.

Frames are length-prefixed pickles. Clients hold one blocking connection
per calling thread; ``call_oneway`` sends and does not wait for a reply.

This module imports the standard library only.
"""

from __future__ import annotations

import asyncio
import json
import multiprocessing as mp
import os
import pickle
import secrets
import signal
import socket
import struct
import threading
import time
import traceback
from typing import Optional, Tuple

from .retry import call_policy, connect_policy

Address = Tuple[str, str]  # ("unix", socket path)
_LEN = struct.Struct("<Q")


class ActorDiedError(Exception):
    """The actor's process cannot be reached (exited, or never started)."""


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


# -- framing ----------------------------------------------------------------


def _dumps(obj) -> bytes:
    payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    return _LEN.pack(len(payload)) + payload


async def _read_frame(reader: asyncio.StreamReader):
    (length,) = _LEN.unpack(await reader.readexactly(_LEN.size))
    return pickle.loads(await reader.readexactly(length))


class _Connection:
    """A blocking framed connection."""

    def __init__(self, address: Address, timeout: Optional[float] = None):
        self.sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        if timeout is not None:
            self.sock.settimeout(timeout)  # covers connect() too
        try:
            self.sock.connect(address[1])
        except BaseException:
            self.sock.close()
            raise

    def send(self, obj) -> None:
        self.sock.sendall(_dumps(obj))

    def recv(self):
        (length,) = _LEN.unpack(self._recv_exact(_LEN.size))
        return pickle.loads(self._recv_exact(length))

    def _recv_exact(self, n: int) -> bytes:
        chunks = []
        while n:
            chunk = self.sock.recv(min(n, 1 << 20))
            if not chunk:
                raise ConnectionError("connection closed by peer")
            chunks.append(chunk)
            n -= len(chunk)
        return b"".join(chunks)

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


# -- server side ------------------------------------------------------------


class _ActorHost:
    """Serves one instance's methods inside the actor process."""

    def __init__(self, instance, address: Address):
        self.instance = instance
        self.address = address
        self._shutdown: Optional[asyncio.Event] = None
        self._server = None
        self._tasks: set = set()  # the loop holds tasks weakly

    async def _handle_client(self, reader, writer):
        lock = asyncio.Lock()  # replies on one connection never interleave
        try:
            while True:
                try:
                    req_id, method, args, kwargs, oneway = await _read_frame(reader)
                except (asyncio.IncompleteReadError, ConnectionError):
                    break
                # Each request is its own task: a blocked get on this
                # connection must not hold up the requests behind it.
                task = asyncio.get_running_loop().create_task(
                    self._dispatch(writer, lock, req_id, method, args, kwargs, oneway)
                )
                self._tasks.add(task)
                task.add_done_callback(self._tasks.discard)
        finally:
            writer.close()

    async def _dispatch(self, writer, lock, req_id, method, args, kwargs, oneway):
        try:
            if method == "__ping__":
                result = "pong"
            elif method == "__terminate__":
                result = None
                self._shutdown.set()
            else:
                result = getattr(self.instance, method)(*args, **kwargs)
                if asyncio.iscoroutine(result):
                    result = await result
            reply = (req_id, "ok", result)
        except Exception as exc:  # noqa: BLE001 -- the caller re-raises it
            reply = (req_id, "err", (exc, traceback.format_exc()))
        if oneway:
            return
        try:
            frame = _dumps(reply)
        except Exception:  # the exception did not pickle: send its text
            frame = _dumps((req_id, "err", (None, reply[2][1] if reply[1] == "err" else traceback.format_exc())))
        async with lock:
            try:
                writer.write(frame)
                await writer.drain()
            except ConnectionError:
                pass

    async def start(self):
        self._shutdown = asyncio.Event()
        self._server = await asyncio.start_unix_server(self._handle_client, path=self.address[1])

    async def wait_shutdown(self):
        await self._shutdown.wait()
        # Not ``async with``: its wait_closed() would wait for every
        # client to hang up. Open connections die with the loop.
        self._server.close()


def _actor_main(cls, args, kwargs, address: Address, registry_path, ready_q, watch_parent: int):
    """Entry point of the actor's spawned process."""

    def _watch():
        # Daemonic children die with a parent that exits cleanly, not with
        # one that was killed.
        while True:
            time.sleep(1.0)
            if not _pid_alive(watch_parent):
                os._exit(0)

    threading.Thread(target=_watch, daemon=True).start()
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
        ready_q.put(("ok", list(host.address)))
        await host.wait_shutdown()

    try:
        asyncio.run(run())
    except KeyboardInterrupt:
        pass
    finally:
        for path in (registry_path, address[1]):
            if path is not None:
                try:
                    os.unlink(path)
                except FileNotFoundError:
                    pass


# -- client side ------------------------------------------------------------


class ActorHandle:
    """Client proxy: ``call`` blocks for the result, ``call_oneway`` does
    not wait. Picklable: handles travel inside task arguments."""

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

    def _send(self, req_id, method, args, kwargs, oneway) -> _Connection:
        """Send one request frame on this thread's connection, retrying a
        refused connect or a reset send (the request never ran then, so a
        retry cannot run it twice)."""
        policy = call_policy()
        last: Optional[Exception] = None
        for attempt, handle in policy.attempts():
            try:
                conn = getattr(self._local, "conn", None)
                if conn is None:
                    conn = self._local.conn = _Connection(self.address)
                conn.send((req_id, method, args, kwargs, oneway))
                return conn
            except OSError as e:  # ConnectionError and FileNotFoundError too
                self._local.conn = None
                last = e
                if attempt < policy.max_attempts:
                    handle.backoff()
        raise ActorDiedError(f"cannot reach actor {self._label()}: {last}") from last

    def call(self, method: str, *args, **kwargs):
        req_id = self._next_id()
        conn = self._send(req_id, method, args, kwargs, False)
        try:
            while True:
                resp_id, status, payload = conn.recv()
                if resp_id == req_id:
                    break
        except OSError as e:
            self._local.conn = None
            raise ActorDiedError(f"actor {self._label()} died mid-call: {e}") from e
        if status == "ok":
            return payload
        exc, tb = payload
        if isinstance(exc, Exception):
            raise exc
        raise RemoteError(f"remote call {method} failed:\n{tb}")

    def call_oneway(self, method: str, *args, **kwargs) -> None:
        self._send(self._next_id(), method, args, kwargs, True)

    def ping(self, timeout: Optional[float] = None) -> bool:
        """On its own connection with a timeout: a wedged actor answers
        False instead of hanging the caller."""
        try:
            conn = _Connection(self.address, timeout=timeout)
        except OSError:
            return False
        try:
            conn.send((0, "__ping__", (), {}, False))
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
        ``force``) kill its process."""
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


def spawn_actor(cls, *args, name: Optional[str] = None, runtime_dir: str, **kwargs) -> ActorHandle:
    """Start ``cls(*args, **kwargs)`` in a spawned process and return a
    handle once it serves. A name held by a live actor raises
    ``ValueError``; the record of a dead one is reclaimed."""
    os.makedirs(_registry_dir(runtime_dir), exist_ok=True)
    address: Address = ("unix", os.path.join(runtime_dir, f"a-{secrets.token_hex(4)}.sock"))
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
        daemon=True,
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


def connect_actor(name: str, runtime_dir: str, num_retries: int = 5) -> ActorHandle:
    """A live named actor, retried with capped, jittered backoff while it
    is not registered or does not answer."""
    policy = connect_policy(num_retries)
    for attempt, handle in policy.attempts():
        actor = resolve_actor(name, runtime_dir)
        if actor is not None and actor.ping(timeout=5.0):
            return actor
        if attempt < policy.max_attempts:
            handle.backoff()
    raise ValueError(f"Unable to connect to actor {name!r} after {num_retries} retries")
