"""The host runtime: a session of processes sharing a store and a registry.

* :mod:`.store`: the shared-memory columnar object store (data plane).
* :mod:`.tasks`: the spawned worker pool with futures (map and reduce).
* :mod:`.actor`: named actors in their own processes (the batch queue).
* :mod:`.transport`: their wire, on unix sockets and authenticated TCP.
* :mod:`.cluster`: several hosts' sessions as one cluster.
* :mod:`.faults`: seeded fault injection (``RSDL_FAULTS``), loaded at its
  first use as ``runtime.faults``.
* :mod:`.elastic`: the autoscaler, the graceful drain and the tiered
  evictor (``RSDL_ELASTIC``), loaded only when asked for.
* :mod:`.service`: the multi-job shuffle service (``RSDL_SERVICE``): jobs,
  fair share, epoch admission and the content-keyed decode cache, loaded
  only when asked for. Under it, named actors are scoped to the ambient
  job (:func:`spawn_actor`, :func:`connect_actor`, :func:`resolve_actor`).

``init()`` creates a *session*, a runtime directory holding the actor
registry whose name prefixes every shared-memory segment, or joins an
existing one named by ``address=`` or by ``$RSDL_RUNTIME_DIR``: trainer
ranks launched with that variable exported join their launcher's session.
The creating process owns the session: its :func:`shutdown` stops the
pool and the actors it spawned, unlinks every segment and removes the
directory. Named actors are scoped to the session: their records live in
its directory.

**Clusters.** :func:`init_cluster` makes this session a cluster's head:
it mints ``$RSDL_CLUSTER_TOKEN``, starts the registry and this host's
agent and store server on TCP, and ``ctx.cluster.address``
(``tcp://host:port/<token>``) is what other hosts join with:
``init(address="tcp://...")`` or ``python -m
ray_shuffling_data_loader_tpu_torch.runtime.cluster join tcp://...``. A
joined session's tasks go to every host (:attr:`RuntimeContext.scheduler`),
its refs carry their owner, its named actors listen on TCP and are found
through the registry, and the processes that join it by directory (its
workers) read ``cluster.json`` there and get the same wiring.

**Telemetry.** With ``RSDL_METRICS`` on, a new session points the metrics
and event spools at ``<runtime_dir>/metrics`` and ``/events`` unless
``RSDL_METRICS_DIR`` and ``RSDL_EVENTS_DIR`` name others, and with
``RSDL_PROFILE`` set the profiles at ``<runtime_dir>/profiles`` unless
``RSDL_PROFILE_DIR`` names another. Every process that starts or joins a
session starts the sampling profiler under ``RSDL_PROFILE``; the owner
starts the obs server on ``RSDL_OBS_PORT``, the time-series sampler (and
the SLO engine its tick evaluates) with metrics on and ``RSDL_TS`` (or
``RSDL_OBS_PORT``) set, the elastic control loop (:mod:`.elastic`) under
``RSDL_ELASTIC``, and the relay under ``RSDL_RELAY``: the sink on a
cluster's head, the shipper on another host, with ``RSDL_RUNTIME_DIR``
exported so that every process of the session can wake it
(:func:`_start_planes`). :func:`shutdown` stops them, spools this
process's last metrics snapshot and profile and lets the shipper ship
once more while the directory exists.

This package imports numpy only: the spawned workers load it.
"""

from __future__ import annotations

import atexit
import json
# Imported before any ``atexit.register(shutdown)``: its exit hook, which
# joins the non-daemonic children (a cluster host's agent), then runs
# after ours, which stops them.
import multiprocessing.util  # noqa: F401
import os
import secrets
import shutil
import sys
import tempfile
import threading
from typing import Callable, List, Optional

from ray_shuffling_data_loader_tpu_torch.telemetry import _env
from ray_shuffling_data_loader_tpu_torch.telemetry import metrics as _metrics

from .actor import ActorDiedError, ActorHandle, RemoteError
from .actor import connect_actor as _connect_actor
from .actor import resolve_actor as _resolve_actor
from .actor import spawn_actor as _spawn_actor
from .store import ColumnBatch, ObjectCorruptError, ObjectLostError, ObjectRef, ObjectStore, StoreFullError, StoreStats
from .tasks import TaskError, TaskFuture, WorkerPool, wait

_ENV_DIR = "RSDL_RUNTIME_DIR"
# Marks a directory as a session of this package: the JAX package's
# runtime names its sessions with the same variable.
_MARKER = "torch-session"
# A cluster member's wiring, for the processes that join its session.
_CLUSTER_FILE = "cluster.json"


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
        self.cluster = None  # a ClusterClient once joined to a cluster
        self._owns_cluster_services = False
        self._owned_names: List[str] = []  # names registered cluster-wide
        self._spool_env = _arm_spools(runtime_dir)

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

    @property
    def scheduler(self):
        """Where the shuffle's tasks go: the cluster's scheduler when
        joined to one, else :attr:`pool` (the same ``submit`` and
        ``submit_local_to``). Under the multi-job service
        (``RSDL_SERVICE``, read before the import) it is wrapped for fair
        share across jobs (:func:`.service.wrap_scheduler`)."""
        base = self.cluster.scheduler() if self.cluster is not None else self.pool
        if os.environ.get("RSDL_SERVICE"):
            from .service import wrap_scheduler

            return wrap_scheduler(base)
        return base

    def shutdown(self) -> None:
        if self.owner:
            # The obs server and the sampler read the spools: they stop
            # before the spools go (the server's port is free for the next
            # session). Through sys.modules: a session that never served or
            # sampled imports nothing here.
            # The elastic loop reads the ledger and moves segments: it stops
            # before the pool and the segments go.
            # The service's fair-share wrappers hold the pool: they go too.
            for name in ("telemetry.obs_server", "telemetry.timeseries", "runtime.elastic", "runtime.service"):
                mod = sys.modules.get(f"ray_shuffling_data_loader_tpu_torch.{name}")
                if mod is not None:
                    mod.stop()
        if self.cluster is not None:
            for name in self._owned_names:
                self.cluster.unregister_named_actor(name)
            if self._owns_cluster_services:
                self.cluster.leave()
            self.cluster = None
        if self._pool is not None:
            self._pool.shutdown()
            self._pool = None
        for handle in self._owned_actors:
            try:
                handle.terminate(grace_period_s=2.0)
            except Exception:
                pass
        self._owned_actors.clear()
        # This process's last metrics snapshot, while the session's spool
        # directory still exists (a rank leaving the session included).
        if _metrics.enabled():
            try:
                from ray_shuffling_data_loader_tpu_torch.telemetry import export

                export.safe_flush()
            except Exception:
                pass
        # The profiler stops and spools its last aggregate, the same way.
        prof = sys.modules.get("ray_shuffling_data_loader_tpu_torch.telemetry.profiler")
        if prof is not None:
            prof.stop()
        # The relay stops after the pool's and the actors' last flushes and
        # this process's: the shipper's last ship carries them to the head
        # while the spools exist. Through sys.modules, as above.
        relay = sys.modules.get("ray_shuffling_data_loader_tpu_torch.telemetry.relay")
        if relay is not None:
            relay.stop()
        for key in self._spool_env:
            os.environ.pop(key, None)
        if self.owner:
            self.store.cleanup()
            shutil.rmtree(self.runtime_dir, ignore_errors=True)


def _arm_spools(runtime_dir: str) -> List[str]:
    """Point the armed planes' spools at the session where their variables
    are unset: with metrics on, the metrics and event spools
    (``<runtime_dir>/metrics``, ``/events``); with ``RSDL_PROFILE`` set,
    the profiles (``<runtime_dir>/profiles``). So the pool, the actors and
    this process spool to one place (the port's processes do not all carry
    ``RSDL_RUNTIME_DIR``). With the relay on (``RSDL_RELAY``), also
    ``RSDL_RUNTIME_DIR`` itself, this session's even where another was
    inherited: every process the session starts then finds the relay's
    wake file (:func:`.telemetry.relay.kick`). Returns the variables it
    set, which the session's end unsets."""
    spools = []
    if _metrics.enabled():
        spools += [("RSDL_METRICS_DIR", "metrics"), ("RSDL_EVENTS_DIR", "events")]
    if _env.read_flag("RSDL_PROFILE"):
        spools.append(("RSDL_PROFILE_DIR", "profiles"))
    armed = []
    for key, sub in spools:
        if not os.environ.get(key):
            os.environ[key] = os.path.join(runtime_dir, sub)
            armed.append(key)
    if _env.relay_armed() and os.environ.get(_ENV_DIR) != runtime_dir:
        os.environ[_ENV_DIR] = runtime_dir
        armed.append(_ENV_DIR)
    return armed


def _start_planes(ctx: RuntimeContext) -> None:
    """Start the session's planes, each gated on its variable before its
    import: the profiler in every process that starts or joins a session
    (``RSDL_PROFILE``); on the owner only, the obs server
    (``RSDL_OBS_PORT``), the time series with metrics on and
    ``RSDL_OBS_PORT`` or ``RSDL_TS`` set (and the SLO engine that its tick
    evaluates), the elastic control loop (``RSDL_ELASTIC``, with metrics
    on) and the relay (``RSDL_RELAY``: the sink on a cluster's head, the
    shipper on another host). A failed start is logged, never raised."""
    import logging

    if _env.read_flag("RSDL_PROFILE"):
        try:
            from ray_shuffling_data_loader_tpu_torch.telemetry import profiler

            profiler.start()
        except Exception:
            logging.getLogger(__name__).warning("profiler start failed", exc_info=True)
    if not ctx.owner:
        return
    if os.environ.get("RSDL_OBS_PORT"):
        try:
            from ray_shuffling_data_loader_tpu_torch.telemetry import obs_server

            obs_server.maybe_start()
        except Exception:
            logging.getLogger(__name__).warning("obs server start failed", exc_info=True)
    if _metrics.enabled() and (os.environ.get("RSDL_OBS_PORT") or os.environ.get("RSDL_TS")):
        try:
            from ray_shuffling_data_loader_tpu_torch.telemetry import timeseries

            if os.environ.get("RSDL_OBS_PORT") or timeseries.forced_on():
                # The tick finds the engine through sys.modules.
                from ray_shuffling_data_loader_tpu_torch.telemetry import slo  # noqa: F401

                timeseries.start()
        except Exception:
            logging.getLogger(__name__).warning("time-series sampler start failed", exc_info=True)
    # The elastic control plane (autoscaler, drain, evictor): with
    # RSDL_ELASTIC unset, no import, no thread, no ledger transition.
    if (os.environ.get("RSDL_ELASTIC") or "").strip().lower() not in ("", "off", "0", "false"):
        try:
            from . import elastic

            elastic.maybe_start(ctx)
        except Exception:
            logging.getLogger(__name__).warning("elastic control loop start failed", exc_info=True)
    if _env.relay_armed():
        try:
            from ray_shuffling_data_loader_tpu_torch.telemetry import relay

            relay.maybe_start(ctx)
        except Exception:
            logging.getLogger(__name__).warning("relay start failed", exc_info=True)


_context: Optional[RuntimeContext] = None
_context_lock = threading.Lock()


def _is_session(path: str) -> bool:
    return os.path.isfile(os.path.join(path, _MARKER))


def _new_session_dir() -> str:
    # Short: a unix socket path inside it is capped at ~107 bytes.
    runtime_dir = os.path.join(tempfile.gettempdir(), f"rsdl-{secrets.token_hex(4)}")
    os.makedirs(os.path.join(runtime_dir, "actors"))
    open(os.path.join(runtime_dir, _MARKER), "w").close()
    return runtime_dir


def _attach_cluster_client(ctx: RuntimeContext, record: dict, owns: bool):
    """Wire a :class:`.cluster.ClusterClient` from a ``cluster.json``
    record into ``ctx``: the registry, agent and store server handles and
    the store's hooks for foreign refs."""
    from .cluster import ClusterClient

    # Before the first TCP frame of a process that joined by directory.
    if record.get("token") and not os.environ.get("RSDL_CLUSTER_TOKEN"):
        os.environ["RSDL_CLUSTER_TOKEN"] = record["token"]
    client = ClusterClient(
        registry=ActorHandle(tuple(record["registry"])),
        host_id=record["host_id"],
        advertise_host=record["advertise"],
        agent=ActorHandle(tuple(record["agent"])),
        store_server=ActorHandle(tuple(record["store"])),
        is_head=record.get("is_head", False),
        registry_address=tuple(record["registry"])[1:],
    )
    ctx.cluster = client
    ctx._owns_cluster_services = owns
    ctx.store.owner_address = tuple(record["store"])
    ctx.store.remote_fetch = client.fetch_remote
    ctx.store.remote_fetch_into = client.fetch_remote_into
    ctx.store.remote_free = client.free_remote
    return client


def _bootstrap_cluster_host(ctx: RuntimeContext, registry: ActorHandle, advertise: str, num_workers: int,
                            is_head: bool) -> None:
    """Start this host's agent and store server, register the host, and
    write ``cluster.json`` so that the session's workers, which join it by
    directory, stamp their refs with this host's store and fetch foreign
    ones."""
    from .cluster import start_host_services

    agent, store_server = start_host_services(ctx.runtime_dir, num_workers, advertise)
    ctx._owned_actors += [agent, store_server]
    host_id = f"{advertise}:{ctx.session}"
    registry.call("register_host", host_id, list(agent.address), list(store_server.address), num_workers)
    record = {
        "registry": list(registry.address),
        "agent": list(agent.address),
        "store": list(store_server.address),
        "host_id": host_id,
        "advertise": advertise,
        "is_head": is_head,
        "token": os.environ.get("RSDL_CLUSTER_TOKEN"),
    }
    with open(os.path.join(ctx.runtime_dir, _CLUSTER_FILE), "w") as f:
        json.dump(record, f)
    _attach_cluster_client(ctx, record, owns=True)


def init(num_workers: Optional[int] = None, address: Optional[str] = None) -> RuntimeContext:
    """Create or join a session (a second call returns the first context).

    Args:
        num_workers: size of the worker pool (default: the host's cores).
        address: the runtime directory of a session to join, or
            ``tcp://host:port/<token>``, a cluster's head to join as a
            host: a new session of this process with its own agent and
            store server (:mod:`.cluster`). Without it,
            ``$RSDL_RUNTIME_DIR`` names the session to join when it is a
            session of this package, and otherwise a new session is made.
    """
    global _context
    with _context_lock:
        if _context is not None:
            return _context
        num_workers = max(1, num_workers or os.cpu_count() or 1)
        if address is not None and address.startswith("tcp://"):
            from .cluster import default_advertise_host, parse_cluster_address

            host, port, token = parse_cluster_address(address)
            if token:  # before the first TCP frame
                os.environ["RSDL_CLUSTER_TOKEN"] = token
            ctx = RuntimeContext(_new_session_dir(), owner=True, num_workers=num_workers)
            try:
                registry = ActorHandle(("tcp", host, port))
                registry.wait_ready()
                _bootstrap_cluster_host(ctx, registry, default_advertise_host(), num_workers, is_head=False)
            except BaseException:
                # A half-joined session must not stand as this process's.
                ctx.shutdown()
                raise
            _context = ctx
            atexit.register(shutdown)
            _start_planes(ctx)
            return ctx
        if address is not None:
            if not _is_session(address):
                raise ValueError(f"no runtime session at {address!r}")
        else:
            env = os.environ.get(_ENV_DIR)
            address = env if env and _is_session(env) else None
        if address is not None:
            ctx = RuntimeContext(address, owner=False, num_workers=num_workers)
            # A worker of a cluster host takes its host's wiring.
            cluster_file = os.path.join(address, _CLUSTER_FILE)
            if os.path.exists(cluster_file):
                with open(cluster_file) as f:
                    _attach_cluster_client(ctx, json.load(f), owns=False)
        else:
            ctx = RuntimeContext(_new_session_dir(), owner=True, num_workers=num_workers)
        _context = ctx
        atexit.register(shutdown)
        _start_planes(ctx)
        return ctx


def init_cluster(
    listen_host: str = "0.0.0.0",
    listen_port: int = 0,
    advertise_host: Optional[str] = None,
    num_workers: Optional[int] = None,
) -> RuntimeContext:
    """Make a new session a cluster's head: the registry on
    ``listen_host:listen_port`` (``0.0.0.0``: the advertised address; port
    0: one the system picks) and this host's agent and store server.
    ``RSDL_CLUSTER_TOKEN`` is minted first (when unset), so every TCP
    endpoint, and every process spawned after, holds it. Other hosts join
    with ``ctx.cluster.address``."""
    global _context
    from .cluster import ClusterRegistry, default_advertise_host

    with _context_lock:
        if _context is not None:
            raise RuntimeError("runtime already initialized")
        num_workers = max(1, num_workers or os.cpu_count() or 1)
        ctx = RuntimeContext(_new_session_dir(), owner=True, num_workers=num_workers)
        _context = ctx
        atexit.register(shutdown)
    try:
        os.environ.setdefault("RSDL_CLUSTER_TOKEN", secrets.token_hex(16))
        advertise = advertise_host or default_advertise_host()
        bind_host = advertise if listen_host == "0.0.0.0" else listen_host
        registry = _spawn_actor(ClusterRegistry, runtime_dir=ctx.runtime_dir, host=bind_host, port=listen_port)
        ctx._owned_actors.append(registry)
        _bootstrap_cluster_host(ctx, registry, advertise, num_workers, is_head=True)
        _start_planes(ctx)
    except BaseException:
        with _context_lock:
            _context = None
        ctx.shutdown()
        raise
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


def _scoped_actor_name(name: Optional[str]) -> Optional[str]:
    """``name`` scoped to the ambient job under the multi-job service
    (:func:`.service.scoped_name`): two jobs that name one queue get two
    actors. ``RSDL_SERVICE`` is read before the import."""
    if name is None or not os.environ.get("RSDL_SERVICE"):
        return name
    from .service import scoped_name

    return scoped_name(name)


def submit(fn: Callable, *args, **kwargs) -> TaskFuture:
    """Run ``fn(*args, **kwargs)`` on the session's scheduler: the worker
    pool, or in a cluster any host's."""
    return get_context().scheduler.submit(fn, *args, **kwargs)


def spawn_actor(cls, *args, name: Optional[str] = None, host_id: Optional[str] = None, **kwargs) -> ActorHandle:
    """Start an actor owned by this process (it stops at this process's
    :func:`shutdown`); a named one is found session-wide by
    :func:`connect_actor`. In a cluster the actor listens on TCP and a
    name is registered cluster-wide; ``host_id`` (one of
    :func:`cluster_hosts`) spawns it on that host, through its agent."""
    ctx = get_context()
    name = _scoped_actor_name(name)
    if host_id is not None:
        if ctx.cluster is None:
            raise ValueError("host_id placement requires cluster mode")
        if host_id != ctx.cluster.host_id:
            hosts = ctx.cluster.registry.call("hosts")
            info = hosts.get(host_id)
            if info is None:
                raise ValueError(f"unknown host_id {host_id!r}; cluster hosts: {sorted(hosts)}")
            agent = ActorHandle(tuple(info["agent"]))
            if not agent.ping(timeout=5.0):
                raise ActorDiedError(f"host {host_id!r} agent unreachable (ping timeout)")
            ready_s = float(os.environ.get("RSDL_SPAWN_READY_TIMEOUT_S", "120"))
            address, _ = agent.call_with_timeout("spawn_named_actor", cls, list(args), kwargs, name,
                                                 timeout=ready_s + 30.0)
            # No pid: it is another host's, never to be signalled here.
            handle = ActorHandle(tuple(address), pid=None, name=name)
            ctx._owned_actors.append(handle)
            if name is not None:
                ctx.cluster.register_named_actor(name, handle, host_id=host_id)
                ctx._owned_names.append(name)
            return handle
    if ctx.cluster is not None:
        kwargs.setdefault("host", ctx.cluster.advertise_host)
    handle = _spawn_actor(cls, *args, name=name, runtime_dir=ctx.runtime_dir, **kwargs)
    ctx._owned_actors.append(handle)
    if name is not None and ctx.cluster is not None:
        ctx.cluster.register_named_actor(name, handle)
        ctx._owned_names.append(name)
    return handle


def cluster_hosts() -> list:
    """The cluster's host ids, this host's first; empty outside a
    cluster."""
    ctx = get_context()
    if ctx.cluster is None:
        return []
    own = ctx.cluster.host_id
    return sorted(ctx.cluster.registry.call("hosts"), key=lambda h: (h != own, h))


def connect_actor(name: str, num_retries: int = 5) -> ActorHandle:
    """The live actor ``name``, retried with backoff: from the session's
    registry, else in a cluster the head's."""
    ctx = get_context()
    name = _scoped_actor_name(name)
    fallback = ctx.cluster.lookup_named_actor if ctx.cluster is not None else None
    return _connect_actor(name, ctx.runtime_dir, num_retries=num_retries, fallback_resolver=fallback)


def resolve_actor(name: str) -> Optional[ActorHandle]:
    ctx = get_context()
    name = _scoped_actor_name(name)
    handle = _resolve_actor(name, ctx.runtime_dir)
    if handle is None and ctx.cluster is not None:
        handle = ctx.cluster.lookup_named_actor(name)
    return handle


def put_columns(columns) -> ObjectRef:
    return get_context().store.put_columns(columns)


def get_columns(ref: ObjectRef) -> ColumnBatch:
    return get_context().store.get_columns(ref)


def free(refs) -> None:
    get_context().store.free(refs)


def store_stats() -> StoreStats:
    return get_context().store.store_stats()


def __getattr__(name):
    # ``runtime.faults`` is imported at its first use, not with the package.
    if name == "faults":
        import importlib

        return importlib.import_module(f"{__name__}.faults")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "ActorDiedError",
    "ActorHandle",
    "ColumnBatch",
    "ObjectCorruptError",
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
    "cluster_hosts",
    "connect_actor",
    "ensure_initialized",
    "free",
    "get_context",
    "get_columns",
    "init",
    "init_cluster",
    "is_initialized",
    "put_columns",
    "resolve_actor",
    "shutdown",
    "spawn_actor",
    "store_stats",
    "submit",
    "wait",
]
