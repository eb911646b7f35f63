"""The host runtime: a session of processes sharing a store and a registry.

* :mod:`.store`: the shared-memory columnar object store (data plane).
* :mod:`.tasks`: the spawned worker pool with futures (map and reduce).
* :mod:`.actor`: named actors in their own processes (the batch queue).

``init()`` creates a *session*, a runtime directory holding the actor
registry whose name prefixes every shared-memory segment, or joins an
existing one named by ``address=`` or by ``$RSDL_RUNTIME_DIR``: trainer
ranks launched with that variable exported join their launcher's session.
The creating process owns the session: its :func:`shutdown` stops the
pool and the actors it spawned, unlinks every segment and removes the
directory. Named actors are scoped to the session: their records live in
its directory.

This package imports numpy only: the spawned workers load it.
"""

from __future__ import annotations

import atexit
import os
import secrets
import shutil
import tempfile
import threading
from typing import Callable, List, Optional

from .actor import ActorDiedError, ActorHandle, RemoteError
from .actor import connect_actor as _connect_actor
from .actor import resolve_actor as _resolve_actor
from .actor import spawn_actor as _spawn_actor
from .store import ColumnBatch, ObjectLostError, ObjectRef, ObjectStore, StoreFullError, StoreStats
from .tasks import TaskError, TaskFuture, WorkerPool, wait

_ENV_DIR = "RSDL_RUNTIME_DIR"
# Marks a directory as a session of this package: the JAX package's
# runtime names its sessions with the same variable.
_MARKER = "torch-session"


class RuntimeContext:
    def __init__(self, runtime_dir: str, owner: bool, num_workers: int):
        self.runtime_dir = runtime_dir
        self.owner = owner
        self.session = os.path.basename(runtime_dir)
        self.store = ObjectStore(self.session, sessions_file=os.path.join(runtime_dir, "adopted-sessions"))
        self.num_workers = num_workers
        self._pool: Optional[WorkerPool] = None
        self._pool_lock = threading.Lock()
        self._owned_actors: List[ActorHandle] = []

    @property
    def pool(self) -> WorkerPool:
        """The worker pool, started at first use: ranks that only consume
        never start one. Its workers join this session. The host kernels
        (:mod:`..native`) are built first, unless switched off, so that the
        workers only load them."""
        with self._pool_lock:
            if self._pool is None:
                from ray_shuffling_data_loader_tpu_torch import native

                native.ensure_built()
                self._pool = WorkerPool(self.num_workers, env={_ENV_DIR: self.runtime_dir})
            return self._pool

    def shutdown(self) -> None:
        if self._pool is not None:
            self._pool.shutdown()
            self._pool = None
        for handle in self._owned_actors:
            try:
                handle.terminate(grace_period_s=2.0)
            except Exception:
                pass
        self._owned_actors.clear()
        if self.owner:
            self.store.cleanup()
            shutil.rmtree(self.runtime_dir, ignore_errors=True)


_context: Optional[RuntimeContext] = None
_context_lock = threading.Lock()


def _is_session(path: str) -> bool:
    return os.path.isfile(os.path.join(path, _MARKER))


def init(num_workers: Optional[int] = None, address: Optional[str] = None) -> RuntimeContext:
    """Create or join a session (a second call returns the first context).

    Args:
        num_workers: size of the worker pool (default: the host's cores).
        address: the runtime directory of a session to join. Without it,
            ``$RSDL_RUNTIME_DIR`` names the session to join when it is a
            session of this package, and otherwise a new session is made.
    """
    global _context
    with _context_lock:
        if _context is not None:
            return _context
        num_workers = max(1, num_workers or os.cpu_count() or 1)
        if address is not None:
            if not _is_session(address):
                raise ValueError(f"no runtime session at {address!r}")
        else:
            env = os.environ.get(_ENV_DIR)
            address = env if env and _is_session(env) else None
        if address is not None:
            ctx = RuntimeContext(address, owner=False, num_workers=num_workers)
        else:
            # Short: a unix socket path inside it is capped at ~107 bytes.
            runtime_dir = os.path.join(tempfile.gettempdir(), f"rsdl-{secrets.token_hex(4)}")
            os.makedirs(os.path.join(runtime_dir, "actors"))
            open(os.path.join(runtime_dir, _MARKER), "w").close()
            ctx = RuntimeContext(runtime_dir, owner=True, num_workers=num_workers)
        _context = ctx
        atexit.register(shutdown)
        return ctx


def is_initialized() -> bool:
    return _context is not None


def get_context() -> RuntimeContext:
    if _context is None:
        raise RuntimeError("runtime not initialized; call ray_shuffling_data_loader_tpu_torch.runtime.init() first")
    return _context


def ensure_initialized() -> RuntimeContext:
    return _context if _context is not None else init()


def shutdown() -> None:
    """Leave the session; its owner also ends it (pool, actors, segments,
    directory)."""
    global _context
    with _context_lock:
        ctx, _context = _context, None
    if ctx is not None:
        ctx.shutdown()


# -- the session's services -------------------------------------------------


def submit(fn: Callable, *args, **kwargs) -> TaskFuture:
    """Run ``fn(*args, **kwargs)`` in the session's worker pool."""
    return get_context().pool.submit(fn, *args, **kwargs)


def spawn_actor(cls, *args, name: Optional[str] = None, **kwargs) -> ActorHandle:
    """Start an actor owned by this process (it stops at this process's
    :func:`shutdown`); a named one is found session-wide by
    :func:`connect_actor`."""
    ctx = get_context()
    handle = _spawn_actor(cls, *args, name=name, runtime_dir=ctx.runtime_dir, **kwargs)
    ctx._owned_actors.append(handle)
    return handle


def connect_actor(name: str, num_retries: int = 5) -> ActorHandle:
    """The session's live actor ``name``, retried with backoff."""
    return _connect_actor(name, get_context().runtime_dir, num_retries=num_retries)


def resolve_actor(name: str) -> Optional[ActorHandle]:
    return _resolve_actor(name, get_context().runtime_dir)


def put_columns(columns) -> ObjectRef:
    return get_context().store.put_columns(columns)


def get_columns(ref: ObjectRef) -> ColumnBatch:
    return get_context().store.get_columns(ref)


def free(refs) -> None:
    get_context().store.free(refs)


def store_stats() -> StoreStats:
    return get_context().store.store_stats()


__all__ = [
    "ActorDiedError",
    "ActorHandle",
    "ColumnBatch",
    "ObjectLostError",
    "ObjectRef",
    "ObjectStore",
    "RemoteError",
    "RuntimeContext",
    "StoreFullError",
    "StoreStats",
    "TaskError",
    "TaskFuture",
    "WorkerPool",
    "connect_actor",
    "ensure_initialized",
    "free",
    "get_context",
    "get_columns",
    "init",
    "is_initialized",
    "put_columns",
    "resolve_actor",
    "shutdown",
    "spawn_actor",
    "store_stats",
    "submit",
    "wait",
]
