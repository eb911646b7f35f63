"""The multi-host cluster plane: a registry, an agent and a store server on
every host, tasks over every host's pool, segments fetched across hosts.

One or more hosts (machines, or sessions with their own shared-memory
directories on one machine) form a cluster over authenticated TCP
(:mod:`.transport`):

* :class:`ClusterRegistry`, one actor on the head host: the cluster-wide
  names of actors and the table of member hosts.
* :class:`HostAgent`, one actor per host, owning that host's
  :class:`~.tasks.WorkerPool`: the head's :class:`ClusterScheduler` sends
  the shuffle's map and reduce tasks to the agents round-robin, and a
  reduce to the host that holds most of its input when one does.
* :class:`StoreServer`, one actor per host, serving the host's segments
  to the others. A reader whose directories lack a foreign ref's segment
  pulls the ref's window from its owner once and caches it
  (:meth:`.store.ObjectStore.get_columns`); with ``RSDL_TCP_ZEROCOPY`` the
  bytes come as vectored frames straight out of the owner's mapping,
  striped over ``RSDL_TCP_STREAMS`` connections (:func:`fetch_vec_striped`).

The head is ``runtime.init_cluster(...)``; another host joins with
``runtime.init(address="tcp://head:port/<token>")`` or::

    python -m ray_shuffling_data_loader_tpu_torch.runtime.cluster join tcp://head:port/<token> [--num-workers N]

Only :class:`~.store.ObjectRef` handles, stamped with their owner's store
address, cross the control plane; bulk bytes move host to host once, on
first use. A host that dies takes its segments with it: a fetch from an
owner that does not answer raises :class:`~.store.ObjectLostError` with
the object's id, which the shuffle re-makes from its lineage, and the
scheduler moves the dead agent's tasks to the others.

Agent evictions and task failovers count into ``recovery.agent_evictions``
and ``recovery.task_failover`` (with the ``agent.evicted`` and
``task.failover`` events), and a submit retried on a live agent into
``recovery.retries{site=agent.submit}``. The submitter's trace context
rides every agent call into the task's worker.

This module imports the standard library only (numpy through
:mod:`.store`): the host agents and their workers load it.
"""

from __future__ import annotations

import concurrent.futures
import os
import socket
import threading
import time
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple

from ray_shuffling_data_loader_tpu_torch import telemetry

from . import transport
from .actor import ActorDiedError, ActorHandle, spawn_actor
from .store import GrowingThreadPool, ObjectLostError, ObjectRef


def parse_cluster_address(address: str) -> Tuple[str, int, Optional[str]]:
    """``tcp://host:port[/token]`` -> ``(host, port, token)``: the one
    string an operator copies from the head to every other host."""
    if not address.startswith("tcp://"):
        raise ValueError(f"not a cluster address: {address!r}")
    rest = address[len("tcp://"):]
    token = None
    if "/" in rest:
        rest, token = rest.split("/", 1)
    host, _, port = rest.rpartition(":")
    return host, int(port), token or None


def format_cluster_address(host: str, port: int, token: Optional[str] = None) -> str:
    base = f"tcp://{host}:{port}"
    return f"{base}/{token}" if token else base


def default_advertise_host() -> str:
    """The address other hosts dial to reach this one:
    ``$RSDL_ADVERTISE_HOST``, else the address of the interface of the
    default route (a UDP socket's ``connect`` sends nothing), else
    127.0.0.1."""
    env = os.environ.get("RSDL_ADVERTISE_HOST")
    if env:
        return env
    try:
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        s.connect(("8.8.8.8", 80))
        host = s.getsockname()[0]
        s.close()
        return host
    except OSError:
        return "127.0.0.1"


# -- the registry (on the head host) -----------------------------------------


class ClusterRegistry:
    """Actor names and host membership, cluster-wide. A single-threaded
    asyncio actor: no locks."""

    def __init__(self):
        self._actors: Dict[str, Dict[str, Any]] = {}
        self._hosts: Dict[str, Dict[str, Any]] = {}

    def register_actor(self, name: str, address, pid: Optional[int], host_id: Optional[str] = None) -> None:
        """``host_id``: the host the actor runs on, so that the host's
        departure sweeps the name."""
        if name in self._actors:
            raise ValueError(f"actor name {name!r} already registered")
        self._actors[name] = {"address": list(address), "pid": pid, "host_id": host_id}

    def unregister_actor(self, name: str) -> None:
        self._actors.pop(name, None)

    def lookup_actor(self, name: str) -> Optional[Dict[str, Any]]:
        return self._actors.get(name)

    def register_host(self, host_id: str, agent_address, store_address, num_workers: int) -> None:
        """An upsert: a host's heartbeat re-admits it after an eviction."""
        self._hosts[host_id] = {
            "agent": list(agent_address),
            "store": list(store_address),
            "num_workers": num_workers,
            "joined_at": time.time(),
        }

    def unregister_host(self, host_id: str) -> None:
        """Drop the host and the actor names it strands: those recorded on
        it, and records without a host whose address is one of its
        services' (not every record on its IP: other sessions of the same
        machine keep theirs)."""
        record = self._hosts.pop(host_id, None)
        host_addrs = set()
        if record is not None:
            host_addrs = {tuple(record["agent"]), tuple(record["store"])}
        for name in [
            n for n, rec in self._actors.items()
            if rec.get("host_id") == host_id or (rec.get("host_id") is None and tuple(rec["address"]) in host_addrs)
        ]:
            self._actors.pop(name, None)

    def hosts(self) -> Dict[str, Dict[str, Any]]:
        return dict(self._hosts)


# -- the store server (on every host) ----------------------------------------


def _slice_buffers(bufs, lo: int, hi: int):
    """The views of scatter-gather ``bufs`` that cover bytes ``[lo, hi)``
    of their concatenation (cut at the edges, whole buffers as they are):
    a stripe's share, with no byte copied."""
    out = []
    pos = 0
    for b in bufs:
        view = memoryview(b).cast("B")
        n = view.nbytes
        start, stop = max(lo - pos, 0), min(hi - pos, n)
        if start < stop:
            out.append(view if (start, stop) == (0, n) else view[start:stop])
        pos += n
        if pos >= hi:
            break
    return out


def _check_object_id(object_id: str) -> None:
    # Object ids are ``<session>-<hex>``: refuse anything path-like.
    if "/" in object_id or object_id.startswith("."):
        raise ValueError(f"bad object id {object_id!r}")


class StoreServer:
    """Serves this host's segments to the other hosts.

    ``fetch`` returns a segment's bytes (the segment format, header and
    columns); a ``rows`` window is re-serialized alone, so that a reducer
    pulls its window of a map's output, not the whole output. ``fetch_vec``
    returns the same bytes as an out-of-band reply of views over the
    mapped segment, or one byte range of them (``stripe``)."""

    def __init__(self, shm_dir: str):
        from .store import _default_spill_dir

        self.shm_dir = shm_dir
        self.spill_dir = _default_spill_dir()
        self.served_count = 0
        self.served_bytes = 0
        # (path, rows) -> (total, buffers, keepalive): the stripes of one
        # fetch map the segment once. Segments never change once
        # published; a freed one is caught by the exists() probe.
        self._map_cache: Dict[Any, Any] = {}
        self._map_cache_cap = 8

    def _path(self, object_id: str) -> str:
        _check_object_id(object_id)
        path = os.path.join(self.shm_dir, object_id)
        if not os.path.exists(path):
            spath = os.path.join(self.spill_dir, object_id)
            if os.path.exists(spath):
                return spath
        return path

    def fetch(self, object_id: str, rows=None) -> bytes:
        path = self._path(object_id)
        if rows is None:
            with open(path, "rb") as f:
                data = f.read()
        else:
            from .store import map_segment_file, serialize_columns

            batch = map_segment_file(path, object_id).slice(int(rows[0]), int(rows[1]))
            data = serialize_columns(batch.columns, layout=batch.layout)
        self.served_count += 1
        self.served_bytes += len(data)
        return data

    def fetch_vec(self, object_id: str, rows=None, stripe=None) -> transport.OutOfBand:
        """:meth:`fetch`'s bytes as an out-of-band reply of views over the
        mapped segment (no copy, no pickle of the payload). ``stripe=(i,
        n)``: only bytes ``[i*total//n, (i+1)*total//n)``, the stripes
        tiling the unstriped reply. The meta is ``{"nbytes": total}`` and,
        for a stripe, ``"stripe": [lo, hi]``."""
        import mmap as _mmap

        from .store import map_segment_file, serialize_columns_vectored

        path = self._path(object_id)
        key = (path, None if rows is None else tuple(rows))
        cached = self._map_cache.get(key)
        if cached is not None and not os.path.exists(path):
            # Unlinked outside free(): the entry would pin its pages.
            self._map_cache.pop(key, None)
            cached = None
        if cached is not None:
            total, bufs, keepalive = cached
        elif rows is None:
            fd = os.open(path, os.O_RDONLY)
            try:
                size = os.fstat(fd).st_size
                mm = _mmap.mmap(fd, size, prot=_mmap.PROT_READ)
            finally:
                os.close(fd)
            total, bufs, keepalive = size, [memoryview(mm)], mm
        else:
            batch = map_segment_file(path, object_id).slice(int(rows[0]), int(rows[1]))
            total, bufs = serialize_columns_vectored(batch.columns, layout=batch.layout)
            keepalive = batch
        if cached is None:
            if len(self._map_cache) >= self._map_cache_cap:
                self._map_cache.pop(next(iter(self._map_cache)))
            self._map_cache[key] = (total, bufs, keepalive)
        meta = {"nbytes": total}
        if stripe is not None:
            i, n = int(stripe[0]), int(stripe[1])
            if not (0 < n and 0 <= i < n):
                raise ValueError(f"bad stripe {stripe!r}")
            lo, hi = i * total // n, (i + 1) * total // n
            bufs = _slice_buffers(bufs, lo, hi)
            meta["stripe"] = [lo, hi]
            self.served_bytes += hi - lo
            if i > 0:  # one fetch counted once, at its stripe 0
                return transport.OutOfBand(meta, bufs, keepalive=keepalive)
        else:
            self.served_bytes += total
        self.served_count += 1
        return transport.OutOfBand(meta, bufs, keepalive=keepalive)

    def fetch_stats(self) -> Dict[str, int]:
        """Fetches served to other hosts and their bytes."""
        return {"count": self.served_count, "bytes": self.served_bytes}

    def free(self, object_id: str) -> None:
        """Unlink a segment another host's reader freed; this host's
        capacity ledger notes the ``delete``."""
        from .store import _ledger_note

        try:
            path = self._path(object_id)
            for key in [k for k in self._map_cache if k[0] == path]:
                self._map_cache.pop(key, None)
            os.unlink(path)
        except (FileNotFoundError, ValueError):
            return
        _ledger_note("delete", object_id)

    def exists(self, object_id: str) -> bool:
        return os.path.exists(self._path(object_id))

    def list_segments(self, prefix: str) -> List[Tuple[str, int]]:
        """``(object_id, nbytes)`` of every published segment here whose
        id starts with ``prefix``."""
        return [(name, size) for name, size, _ in self.list_segment_links(prefix)]

    def list_segment_links(self, prefix: str) -> List[Tuple[str, int, int]]:
        """``(object_id, nbytes, inode)`` of every published link here whose
        id starts with ``prefix``: the links of one segment (the windows
        ``publish_slices`` made) share its inode, so that a drain copies
        the segment once."""
        out: Dict[str, Tuple[int, int]] = {}
        for d in (self.shm_dir, self.spill_dir):
            try:
                names = os.listdir(d)
            except FileNotFoundError:
                continue
            for name in names:
                if name.startswith(prefix) and not name.endswith(".tmp") and name not in out:
                    try:
                        st = os.stat(os.path.join(d, name))
                    except OSError:
                        continue
                    out[name] = (st.st_size, st.st_ino)
        return sorted((name, size, ino) for name, (size, ino) in out.items())

    def put_segment(self, object_id: str, data: bytes) -> bool:
        """Adopt a segment's bytes into this host's shm directory; an
        existing copy wins (ids name immutable content)."""
        _check_object_id(object_id)
        path = os.path.join(self.shm_dir, object_id)
        if os.path.exists(path):
            return False
        tmp = f"{path}.rehome-{os.getpid()}.tmp"
        try:
            with open(tmp, "wb") as f:
                f.write(data)
            os.rename(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except FileNotFoundError:
                pass
            raise
        return True


# -- the host agent (on every host) --------------------------------------------


class HostAgent:
    """Owns one host's worker pool and runs the tasks the head sends it.
    The pool starts at the first task (its workers join this host's
    session), after the host kernels are built, so that the workers only
    load them."""

    def __init__(self, runtime_dir: str, num_workers: int, advertise_host: Optional[str] = None):
        os.environ["RSDL_RUNTIME_DIR"] = runtime_dir
        self._runtime_dir = runtime_dir
        self._num_workers = num_workers
        self._advertise_host = advertise_host
        self._pool = None
        self._lock = threading.Lock()
        self._submitted = 0
        self._completed = 0
        self._spawned: List[ActorHandle] = []

    def _get_pool(self):
        from .tasks import WorkerPool

        with self._lock:
            if self._pool is None:
                from ray_shuffling_data_loader_tpu_torch import native

                native.ensure_built()
                self._pool = WorkerPool(self._num_workers, env={"RSDL_RUNTIME_DIR": self._runtime_dir})
            return self._pool

    async def submit(self, fn, args, kwargs):
        import asyncio

        self._submitted += 1
        fut = self._get_pool().submit(fn, *args, **kwargs)
        # The task's TaskError goes back to the caller as the reply.
        result = await asyncio.get_running_loop().run_in_executor(None, fut.result)
        self._completed += 1
        return result

    def num_workers(self) -> int:
        return self._num_workers

    async def spawn_named_actor(self, cls, args, kwargs, name=None):
        """Spawn an actor on this host for a caller on another (placement,
        ``runtime.spawn_actor(host_id=...)``); returns ``(address, pid)``.
        The bring-up waits in a thread, so that pings are answered
        meanwhile; the agent stops the actor at its teardown."""
        import asyncio

        def _do():
            return spawn_actor(cls, *args, runtime_dir=self._runtime_dir, host=self._advertise_host, **kwargs)

        handle = await asyncio.get_running_loop().run_in_executor(None, _do)
        if name is not None:
            handle.name = name
        with self._lock:
            self._spawned.append(handle)
        return list(handle.address), handle.pid

    def agent_stats(self) -> Dict[str, int]:
        return {"submitted": self._submitted, "completed": self._completed}

    def teardown(self) -> None:
        """Stop the pool and the placed actors before the process exits."""
        with self._lock:
            pool, self._pool = self._pool, None
            spawned, self._spawned = self._spawned, []
        for handle in spawned:
            try:
                handle.terminate(grace_period_s=2.0)
            except Exception:
                pass
        if pool is not None:
            pool.shutdown()


class PlacementProbe:
    """An actor that says where it runs: its session and pid."""

    def info(self) -> Dict[str, Any]:
        return {"runtime_dir": os.environ.get("RSDL_RUNTIME_DIR"), "pid": os.getpid()}


# -- fetching ----------------------------------------------------------------------


def fetch_vec_striped(handle: ActorHandle, object_id: str, rows, alloc, n_streams: int,
                      executor: concurrent.futures.Executor) -> None:
    """``n_streams`` concurrent ``fetch_vec`` calls, each pulling one byte
    range of the segment over a connection of its own and landing it by
    ``recv_into`` in its window of ONE destination, ``alloc(total)``
    (called once, by the first reply). Stripe 0 runs on the calling
    thread, the others on ``executor``. A stripe whose range does not fit
    its payload or the total raises ``ConnectionError`` before a byte of
    its payload is read (its connection is dropped); a broken connection
    raises :class:`ActorDiedError`: the retry-safe errors of a plain
    fetch."""
    lock = threading.Lock()
    state: Dict[str, Any] = {}

    def _window(nbytes: int, meta) -> memoryview:
        if not isinstance(meta, dict) or "nbytes" not in meta:
            raise ConnectionError(f"bad stripe reply meta: {meta!r}")
        total = int(meta["nbytes"])
        lo, hi = meta.get("stripe", (0, total))
        if hi - lo != nbytes or not (0 <= lo <= hi <= total):
            raise ConnectionError(f"stripe range {lo}-{hi} inconsistent with payload {nbytes} B / total {total} B")
        with lock:
            if "mm" not in state:
                state["total"] = total
                state["mm"] = alloc(total)
            elif state["total"] != total:
                raise ConnectionError(f"stripe total mismatch: {total} != {state['total']}")
            mm = state["mm"]
        return memoryview(mm)[lo:hi]

    _window.wants_meta = True

    def _pull(i: int) -> None:
        _, payload = handle.call_vectored("fetch_vec", object_id, rows, stripe=(i, n_streams), into=_window)
        if payload is not None:
            # Released now: the store closes the destination's mapping as
            # soon as the fetch returns.
            payload.release()

    futures = [executor.submit(_pull, i) for i in range(1, n_streams)]
    error: Optional[BaseException] = None
    try:
        _pull(0)
    except BaseException as exc:
        error = exc
    for fut in futures:
        try:
            fut.result()
        except BaseException as exc:
            error = error or exc
    if error is not None:
        raise error
    if "mm" not in state:
        raise ConnectionError("striped fetch produced no data")


# -- the scheduler ---------------------------------------------------------------


class ClusterTaskFuture(concurrent.futures.Future):
    """The future of a task sent to an agent: a ``concurrent.futures``
    future (the pool's :data:`~.tasks.TaskFuture`), settled from the
    scheduler thread's future."""

    def __init__(self, inner: concurrent.futures.Future):
        super().__init__()
        inner.add_done_callback(self._settle)

    def _settle(self, inner: concurrent.futures.Future) -> None:
        if inner.cancelled():  # its scheduler shut down first
            self.cancel()
            return
        exc = inner.exception()
        if exc is not None:
            self.set_exception(exc)
        else:
            self.set_result(inner.result())


# Draining addresses live in the module, not in a scheduler: a client
# rebuilds its scheduler when membership changes, and a draining host must
# stay draining across that.
_membership_lock = threading.Lock()
_draining_addrs: set = set()
_retired_addrs: List[str] = []
_RETIRED_CAP = 64
_live_scheduler = None  # a weakref to the newest scheduler, for /status


def _addr_str(address) -> str:
    try:
        return ":".join(str(p) for p in address)
    except TypeError:
        return str(address)


def reset_membership() -> None:
    """Forget drained and retired agents and the newest scheduler."""
    global _live_scheduler
    with _membership_lock:
        _draining_addrs.clear()
        del _retired_addrs[:]
        _live_scheduler = None


def membership_section() -> Dict[str, Any]:
    """The ``cluster`` section of the obs server's ``/status``: the newest
    scheduler's agents (address, draining, tasks in flight), the draining
    addresses and the recently retired agents. The scheduler is held by a
    weak reference: the server keeps none alive."""
    sched = _live_scheduler() if _live_scheduler is not None else None
    with _membership_lock:
        draining = {_addr_str(a) for a in _draining_addrs}
        retired = list(_retired_addrs)
    agents = sched.agent_rows() if sched is not None else []
    return {"agents": agents, "draining": sorted(draining), "retired": retired}


class ClusterScheduler:
    """Tasks over every host's agent: round-robin, or to the host holding
    most of a task's input (:meth:`submit_local_to`). The shuffle's stages
    are uniform and many, so round-robin keeps every host's pool fed with
    no load telemetry.

    An agent whose call fails is pinged on fresh connections with growing
    timeouts (5, 10, 20 s) before it is judged dead: a loaded host misses
    a short ping. An alive one gets the task again (tasks are idempotent
    over the store); a dead one leaves the rotation (``on_agent_dead``
    evicts its host from the registry) and the task goes to the next
    agent. With every agent dead a task raises :class:`ActorDiedError`.

    :meth:`add_agent` admits a host mid-run; :meth:`retire_agent` marks
    one draining (no new tasks; :meth:`in_flight_on` counts its running
    ones) and :meth:`remove_agent` takes it out."""

    def __init__(self, agents: List[ActorHandle], store_to_agent: Optional[Dict[Tuple, ActorHandle]] = None,
                 max_inflight: int = 64, width: Optional[int] = None):
        if not agents:
            raise ValueError("no host agents registered")
        self._agents = list(agents)
        # The cluster's workers: callers size submission windows by it.
        self.width = int(width) if width else len(agents)
        # Store-server address -> that host's agent: a ref's ``owner``
        # names the host that holds it.
        self._store_to_agent = {tuple(k): v for k, v in (store_to_agent or {}).items()}
        self._idx = 0
        self._lock = threading.Lock()
        self._inflight: Dict[Tuple, int] = {}
        self._added_widths: Dict[Tuple, int] = {}
        self.on_agent_dead: Optional[Callable[[ActorHandle], None]] = None
        # Agent calls block: each rides a thread; beyond the width tasks
        # queue in order.
        self._executor = concurrent.futures.ThreadPoolExecutor(max_workers=max_inflight,
                                                                thread_name_prefix="cluster-sched")
        global _live_scheduler
        with _membership_lock:
            _live_scheduler = weakref.ref(self)

    @property
    def agent_addresses(self) -> set:
        with self._lock:
            return {a.address for a in self._agents}

    def _next_agent(self) -> ActorHandle:
        with _membership_lock:
            draining = set(_draining_addrs)
        with self._lock:
            if not self._agents:
                raise ActorDiedError("every cluster host agent has died")
            # Draining agents take no new task, unless all are draining.
            candidates = [a for a in self._agents if a.address not in draining] or self._agents
            agent = candidates[self._idx % len(candidates)]
            self._idx += 1
            return agent

    def add_agent(self, agent: ActorHandle, store_address: Optional[Tuple] = None, num_workers: int = 1) -> bool:
        """Admit an agent (idempotent by address; un-drains it)."""
        with _membership_lock:
            _draining_addrs.discard(agent.address)
        with self._lock:
            if any(a.address == agent.address for a in self._agents):
                return False
            self._agents.append(agent)
            if store_address is not None:
                self._store_to_agent[tuple(store_address)] = agent
            share = max(1, int(num_workers))
            self._added_widths[tuple(agent.address)] = share
            self.width += share
        return True

    def set_membership(self, agents: List[ActorHandle], store_to_agent: Dict[Tuple, ActorHandle], width: int) -> None:
        """Take a new membership in place: an agent it lists joins (a handle
        already here is kept, with its tasks in flight), one it does not
        list leaves; a retired (drained) agent does not come back through a
        registry read that still lists it. An epoch holds its scheduler
        from its start, so the membership changes under it instead of a new
        scheduler taking over (which would refuse that epoch's later
        tasks)."""
        with _membership_lock:
            retired = set(_retired_addrs)
        with self._lock:
            have = {tuple(a.address): a for a in self._agents}
            self._agents = [have.get(tuple(a.address), a) for a in agents if _addr_str(a.address) not in retired]
            kept = {tuple(a.address) for a in self._agents}
            self._store_to_agent = {tuple(k): have.get(tuple(v.address), v) for k, v in store_to_agent.items()}
            for address in [a for a in self._added_widths if a not in kept]:
                del self._added_widths[address]
            self.width = max(1, int(width))

    def _find_agent(self, address) -> Optional[ActorHandle]:
        address = tuple(address)
        with self._lock:
            for a in self._agents:
                if tuple(a.address) == address:
                    return a
        return None

    def retire_agent(self, agent_or_address) -> Optional[ActorHandle]:
        """Mark an agent draining: no new tasks go to it."""
        address = tuple(getattr(agent_or_address, "address", agent_or_address))
        with _membership_lock:
            _draining_addrs.add(address)
        return self._find_agent(address)

    def remove_agent(self, agent_or_address) -> bool:
        """Take a retired agent out of the rotation (a planned exit: no
        failover)."""
        address = tuple(getattr(agent_or_address, "address", agent_or_address))
        with self._lock:
            before = len(self._agents)
            self._agents = [a for a in self._agents if tuple(a.address) != address]
            removed = len(self._agents) != before
            if removed:
                self.width = max(1, self.width - self._added_widths.pop(address, 0))
        with _membership_lock:
            _draining_addrs.discard(address)
            if removed:
                _retired_addrs.append(_addr_str(address))
                del _retired_addrs[:-_RETIRED_CAP]
        return removed

    def in_flight_on(self, agent_or_address) -> int:
        """Tasks running on one agent now."""
        address = tuple(getattr(agent_or_address, "address", agent_or_address))
        with self._lock:
            return self._inflight.get(address, 0)

    def _inflight_adjust(self, address, delta: int) -> None:
        with self._lock:
            count = self._inflight.get(address, 0) + delta
            if count > 0:
                self._inflight[address] = count
            else:
                self._inflight.pop(address, None)

    def agent_rows(self) -> List[Dict[str, Any]]:
        """One row per agent: address, draining, tasks in flight."""
        with _membership_lock:
            draining = set(_draining_addrs)
        with self._lock:
            return [
                {"address": _addr_str(a.address), "draining": a.address in draining,
                 "in_flight": self._inflight.get(a.address, 0)}
                for a in self._agents
            ]

    def _drop_agent(self, agent: ActorHandle) -> None:
        with self._lock:
            before = len(self._agents)
            self._agents = [a for a in self._agents if a.address != agent.address]
            removed = len(self._agents) != before
            if removed:
                self.width = max(1, self.width - self._added_widths.pop(tuple(agent.address), 0))
        with _membership_lock:
            _draining_addrs.discard(agent.address)
        if not removed:
            # Tasks racing to drop one dead agent: the callback fires once.
            return
        telemetry.metrics.safe_inc("recovery.agent_evictions")
        telemetry.emit_event("agent.evicted", agent=str(getattr(agent, "address", None)))
        if self.on_agent_dead is not None:
            try:
                self.on_agent_dead(agent)
            except Exception:
                pass

    def _submit_once(self, agent: ActorHandle, fn, args, kwargs):
        """``(True, result)``, or ``(False, None)`` once the agent is judged
        dead and dropped. Every broken connection is an ActorDiedError, so
        a failed call is confirmed by the ping ladder before the host is
        evicted."""
        self._inflight_adjust(agent.address, +1)
        try:
            return True, agent.call("submit", fn, args, kwargs)
        except ActorDiedError:
            for ping_timeout in (5.0, 10.0, 20.0):
                if agent.ping(timeout=ping_timeout):
                    try:
                        telemetry.metrics.safe_inc("recovery.retries", site="agent.submit")
                        return True, agent.call("submit", fn, args, kwargs)
                    except ActorDiedError:
                        pass
                    break
            self._drop_agent(agent)
            return False, None
        finally:
            self._inflight_adjust(agent.address, -1)

    def _run(self, fn, args, kwargs, trace_ctx=None):
        # At most one attempt per agent: each failure drops one, and an
        # empty rotation raises. ``trace_ctx`` is the submitter's context,
        # re-entered on this executor thread so the agent call carries it.
        with telemetry.scope(**(trace_ctx or {})):
            while True:
                agent = self._next_agent()
                ok, result = self._submit_once(agent, fn, args, kwargs)
                if ok:
                    return result
                telemetry.metrics.safe_inc("recovery.task_failover")
                telemetry.emit_event("task.failover", fn=getattr(fn, "__name__", "task"),
                                     agent=str(getattr(agent, "address", None)))

    def submit(self, fn: Callable, *args, **kwargs) -> ClusterTaskFuture:
        return ClusterTaskFuture(self._executor.submit(self._run, fn, args, kwargs, telemetry.outbound()))

    def _locality_agent(self, refs) -> Optional[ActorHandle]:
        """The live, undrained agent of the host owning the most of
        ``refs`` (window refs weigh by rows, whole segments by bytes), or
        None: no owners, an owner outside the cluster, or
        ``RSDL_DISABLE_LOCALITY`` set."""
        if os.environ.get("RSDL_DISABLE_LOCALITY"):
            return None
        weights: Dict[Tuple, int] = {}
        for ref in refs:
            owner = getattr(ref, "owner", None)
            if owner is None:
                continue
            rows = getattr(ref, "rows", None)
            w = int(rows[1]) - int(rows[0]) if rows is not None else max(1, int(getattr(ref, "nbytes", 1)))
            key = tuple(owner)
            weights[key] = weights.get(key, 0) + w
        if not weights:
            return None
        agent = self._store_to_agent.get(max(weights, key=weights.get))
        if agent is None:
            return None
        with _membership_lock:
            if agent.address in _draining_addrs:
                return None
        with self._lock:
            live = {a.address for a in self._agents}
        return agent if agent.address in live else None

    def _run_preferring(self, preferred, fn, args, kwargs, trace_ctx=None):
        with telemetry.scope(**(trace_ctx or {})):
            if preferred is not None:
                ok, result = self._submit_once(preferred, fn, args, kwargs)
                if ok:
                    return result
            return self._run(fn, args, kwargs)

    def submit_local_to(self, refs, fn: Callable, *args, **kwargs) -> ClusterTaskFuture:
        """Run the task on the host that holds most of ``refs`` (a reduce
        beside its partitions: round-robin would ship about (N-1)/N of
        their bytes across hosts), else round-robin."""
        preferred = self._locality_agent(refs)
        return ClusterTaskFuture(
            self._executor.submit(self._run_preferring, preferred, fn, args, kwargs, telemetry.outbound())
        )

    def shutdown(self, cancel: bool = True) -> None:
        # cancel=False: the tasks already sent still finish.
        self._executor.shutdown(wait=False, cancel_futures=cancel)


# -- a host's view of the cluster ------------------------------------------------------


class ClusterClient:
    """The registry, this host's agent and store server, and the store's
    hooks for foreign refs. Made by ``runtime.init_cluster`` (the head) or
    ``runtime.init("tcp://...")`` (another host)."""

    def __init__(self, registry: ActorHandle, host_id: str, advertise_host: str, agent: ActorHandle,
                 store_server: ActorHandle, is_head: bool, registry_address: Tuple[str, int]):
        self.registry = registry
        self.host_id = host_id
        self.advertise_host = advertise_host
        self.agent = agent
        self.store_server = store_server
        self.is_head = is_head
        self.address = format_cluster_address(*registry_address, token=os.environ.get("RSDL_CLUSTER_TOKEN"))
        self._scheduler: Optional[ClusterScheduler] = None
        self._scheduler_lock = threading.Lock()
        self._scheduler_read_ts = 0.0
        self._total_workers = 1
        self._peer_stores: Dict[Tuple, ActorHandle] = {}
        self._peer_lock = threading.Lock()
        self._dead_stores: set = set()  # owners that stopped answering
        # Stripes 1..n-1 of striped fetches; each thread keeps one
        # connection per peer.
        self._stripe_pool = GrowingThreadPool("store-stripe")
        # How often the scheduler re-reads membership (late joiners).
        self.membership_refresh_s = 5.0

    # -- the store's hooks ------------------------------------------------------

    def _peer_store(self, address: Tuple) -> ActorHandle:
        address = tuple(address)
        with self._peer_lock:
            handle = self._peer_stores.get(address)
            if handle is None:
                handle = self._peer_stores[address] = ActorHandle(address)
            return handle

    def _owner_lost(self, ref: ObjectRef, exc: Exception) -> ObjectLostError:
        """A fetch could not reach the owner: the object is lost to this
        reader (and the owner marked dead when a ping fails too)."""
        self.owner_alive(ref.owner)
        return ObjectLostError(ref.object_id, f"owner {_addr_str(ref.owner)} unreachable: {exc}")

    def owner_alive(self, owner) -> bool:
        """Does the store server at ``owner`` answer (a short ping; an
        owner seen dead stays dead)?"""
        owner = tuple(owner)
        with self._peer_lock:
            if owner in self._dead_stores:
                return False
        if self._peer_store(owner).ping(timeout=2.0):
            return True
        with self._peer_lock:
            self._dead_stores.add(owner)
        return False

    def fetch_remote(self, ref: ObjectRef) -> bytes:
        try:
            return self._peer_store(ref.owner).call("fetch", ref.object_id, ref.rows)
        except ActorDiedError as exc:
            raise self._owner_lost(ref, exc) from exc

    def _stripe_executor(self, streams: int):
        # Four concurrent windows' extra stripes, at most 16 threads.
        return self._stripe_pool.ensure(min(16, max(1, streams - 1) * 4))

    def fetch_remote_into(self, ref: ObjectRef, alloc) -> None:
        """The zero-copy fetch: the owner replies with a vectored frame
        whose payload lands by ``recv_into`` in ``alloc(total)``, striped
        over ``RSDL_TCP_STREAMS`` connections when that is above 1."""
        streams = transport.tcp_streams()
        try:
            if streams > 1:
                fetch_vec_striped(self._peer_store(ref.owner), ref.object_id, ref.rows, alloc, streams,
                                  self._stripe_executor(streams))
                return
            meta, payload = self._peer_store(ref.owner).call_vectored("fetch_vec", ref.object_id, ref.rows,
                                                                      into=alloc)
        except ActorDiedError as exc:
            raise self._owner_lost(ref, exc) from exc
        if payload is None:  # a plain reply: land it through the allocator
            view = memoryview(alloc(len(meta))).cast("B")
            view[: len(meta)] = meta
        else:
            payload.release()

    def retire_store(self, owner) -> None:
        """A drained host's store server: its live segments were copied to
        this host, so frees skip it and its refs read here or count as lost
        (:meth:`.elastic.ElasticController.drain_host`)."""
        with self._peer_lock:
            self._dead_stores.add(tuple(owner))

    def free_remote(self, ref: ObjectRef) -> None:
        with self._peer_lock:
            if tuple(ref.owner) in self._dead_stores:
                return  # its segments went with it
        try:
            self._peer_store(ref.owner).call_oneway("free", ref.object_id)
        except ActorDiedError:
            pass

    # -- the control plane ----------------------------------------------------------

    def _read_agents(self) -> Tuple[List[ActorHandle], Dict[Tuple, ActorHandle]]:
        hosts = self.registry.call("hosts")
        agents: List[ActorHandle] = []
        store_to_agent: Dict[Tuple, ActorHandle] = {}
        total_workers = 0
        for info in hosts.values():
            agent = self.agent if info["agent"] == list(self.agent.address) else ActorHandle(tuple(info["agent"]))
            agents.append(agent)
            store_to_agent[tuple(info["store"])] = agent
            total_workers += int(info.get("num_workers", 1))
        self._total_workers = max(1, total_workers)
        return agents, store_to_agent

    def _evict_host(self, agent: ActorHandle) -> None:
        """Take a dead agent's host out of the registry, so that the next
        rebuild does not bring it back."""
        try:
            for host_id, info in self.registry.call("hosts").items():
                if tuple(info["agent"]) == tuple(agent.address):
                    self.registry.call_oneway("unregister_host", host_id)
        except ActorDiedError:
            pass

    def scheduler(self) -> ClusterScheduler:
        """The cluster's scheduler. Membership is read again at most every
        ``membership_refresh_s``; when it changed, the scheduler takes the
        new membership in place (:meth:`ClusterScheduler.set_membership`):
        an epoch that holds it goes on submitting, to the new hosts too."""
        now = time.monotonic()
        with self._scheduler_lock:
            if self._scheduler is not None and now - self._scheduler_read_ts <= self.membership_refresh_s:
                return self._scheduler
            agents, store_to_agent = self._read_agents()
            self._scheduler_read_ts = now
            if self._scheduler is not None:
                if {a.address for a in agents} != self._scheduler.agent_addresses:
                    self._scheduler.set_membership(agents, store_to_agent, self._total_workers)
                return self._scheduler
            self._scheduler = ClusterScheduler(agents, store_to_agent, width=self._total_workers)
            self._scheduler.on_agent_dead = self._evict_host
            return self._scheduler

    def register_named_actor(self, name: str, handle: ActorHandle, host_id: Optional[str] = None) -> None:
        """Register ``name`` cluster-wide, on ``host_id`` (default this
        host). A name held by a dead actor is taken over."""
        if host_id is None:
            host_id = self.host_id
        try:
            self.registry.call("register_actor", name, list(handle.address), handle.pid, host_id)
        except ValueError:
            existing = self.lookup_named_actor(name)
            if existing is not None and existing.ping(timeout=2.0):
                raise
            self.registry.call("unregister_actor", name)
            self.registry.call("register_actor", name, list(handle.address), handle.pid, host_id)

    def unregister_named_actor(self, name: str) -> None:
        try:
            self.registry.call_oneway("unregister_actor", name)
        except ActorDiedError:
            pass

    def lookup_named_actor(self, name: str) -> Optional[ActorHandle]:
        record = self.registry.call("lookup_actor", name)
        if record is None:
            return None
        return ActorHandle(tuple(record["address"]), pid=record.get("pid"), name=name)

    def reregister(self) -> None:
        """Announce this host again (the heartbeat: re-admits a host that
        a false death verdict evicted)."""
        self.registry.call("register_host", self.host_id, list(self.agent.address),
                           list(self.store_server.address), self.agent.call("num_workers"))

    def leave(self) -> None:
        try:
            self.registry.call_oneway("unregister_host", self.host_id)
        except ActorDiedError:
            pass
        if self._scheduler is not None:
            self._scheduler.shutdown()
        self._stripe_pool.shutdown(wait=False)


# -- bootstrap (runtime.init, runtime.init_cluster) ----------------------------------


def start_host_services(runtime_dir: str, num_workers: int, advertise_host: str) -> Tuple[ActorHandle, ActorHandle]:
    """Spawn this host's agent and store server, both on TCP."""
    from .store import _default_shm_dir

    agent = spawn_actor(HostAgent, runtime_dir, num_workers, advertise_host, runtime_dir=runtime_dir,
                        host=advertise_host, daemon=False)  # it spawns its pool
    store_server = spawn_actor(StoreServer, _default_shm_dir(), runtime_dir=runtime_dir, host=advertise_host)
    return agent, store_server


def serve_forever(poll_s: float = 1.0, heartbeat_s: float = 10.0) -> None:
    """Block while this host serves; return once the registry stops
    answering (the head shut down). Re-registers every ``heartbeat_s``."""
    from . import get_context

    ctx = get_context()
    if ctx.cluster is None:
        raise RuntimeError("not joined to a cluster")
    last_beat = time.monotonic()
    while True:
        time.sleep(poll_s)
        if not ctx.cluster.registry.ping(timeout=5.0):
            return
        if time.monotonic() - last_beat >= heartbeat_s:
            last_beat = time.monotonic()
            try:
                ctx.cluster.reregister()
            except ActorDiedError:
                return


def _main(argv: List[str]) -> int:
    import argparse

    from . import init, shutdown

    parser = argparse.ArgumentParser(prog="python -m ray_shuffling_data_loader_tpu_torch.runtime.cluster")
    sub = parser.add_subparsers(dest="cmd", required=True)
    join = sub.add_parser("join", help="join a cluster as a worker host")
    join.add_argument("address", help="the head's address, tcp://host:port/token")
    join.add_argument("--num-workers", type=int, default=None)
    args = parser.parse_args(argv)
    if args.cmd == "join":
        ctx = init(address=args.address, num_workers=args.num_workers)
        print(f"[rsdl] host {ctx.cluster.host_id} joined {args.address}", flush=True)
        try:
            serve_forever()
        finally:
            shutdown()
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(_main(sys.argv[1:]))
