"""The relay: every host's telemetry spools, shipped to the head's.

Every plane folds file spools: the metrics snapshots (:mod:`.export`), the
event log (:mod:`.events`), the audit's records (:mod:`.audit`), the task
records (:mod:`.stragglers`), the capacity ledger (:mod:`.capacity`) and
the profiles (:mod:`.profiler`). A host that joined a cluster over TCP
spools under its own runtime directory, so without a shared filesystem
the head would see none of its records. The relay ships the files, so
every fold works unchanged across hosts:

* **Sink**, on the head's session owner: :class:`RelaySink`, served as an
  actor on the cluster's authenticated TCP transport and registered
  cluster-wide as :data:`SINK_ACTOR_NAME`. It writes what arrives under the
  head's own spools, named by host (``events-<host>-<pid>.ndjson`` still
  matches every reader's prefix and suffix), and stamps a metrics snapshot
  with its own clock (:func:`_restamp`).
* **Shipper**, on every other host's session owner: a thread that tails
  the host's spools and ships CRC-checked deltas. Append-only files
  (NDJSON) ship from byte cursors: the sink's ``hello`` says how much of
  each already landed, so a reconnect resumes without a duplicate;
  replaced files (metrics and profile JSON) ship whole when they change.
  Past ``RSDL_RELAY_MAX_LAG_BYTES`` behind, the shipper skips ahead to a
  line boundary and counts ``relay.dropped_bytes_total``. A spool
  directory the sink shares (the same device and inode) is skipped, not
  counted twice.

If the relay dies, the other host's sources go stale on ``/healthz``, the
audit's reconcile says incomplete (never a false mismatch), and the
shipper finds the sink again and resumes from its cursors.

``RSDL_RELAY`` (``auto``; off when unset, ``off``, ``0`` or ``false``) is
read before this module is imported: unset, no import, no thread, no
socket. Each process that flushes a spool calls :func:`kick` after the
flush (the task-done and actor barriers), and the shipper ships within
its poll interval, so a remote host's records reach the head at the
points a local one's do. The wake file is ``$RSDL_RUNTIME_DIR/relay/kick``;
with the relay on, the session exports that variable to every process it
starts (``runtime._arm_spools``).
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
import zlib
from typing import Any, Dict, Optional, Tuple

from ray_shuffling_data_loader_tpu_torch.telemetry import _env

ENV_RELAY = "RSDL_RELAY"
ENV_PERIOD = "RSDL_RELAY_PERIOD_S"
ENV_MAX_BATCH = "RSDL_RELAY_MAX_BATCH_BYTES"
ENV_MAX_LAG = "RSDL_RELAY_MAX_LAG_BYTES"
_RUNTIME_DIR_ENV = "RSDL_RUNTIME_DIR"

# The sink's cluster-wide name; a shipper looks it up again at every
# reconnect, so a restarted head is found.
SINK_ACTOR_NAME = "rsdl-relay-sink"

_DEFAULT_PERIOD_S = 0.5
_DEFAULT_MAX_BATCH = 4 * 1024 * 1024
_DEFAULT_MAX_LAG = 64 * 1024 * 1024

# A source host whose last ship is older than this is stale on /healthz
# (shippers ship every half second: silence means the host is gone).
_STALE_AFTER_S = 15.0

# The spools shipped: file prefix and suffix (the readers' filters) and
# how each ships. Append-only kinds ship byte deltas; replaced kinds
# (atomic os.replace of a JSON snapshot) ship whole when they change.
_KINDS: Dict[str, Tuple[str, str, str]] = {
    "metrics": ("metrics-", ".json", "replace"),
    "events": ("events-", ".ndjson", "append"),
    "audit": ("audit-", ".jsonl", "append"),
    "tasks": ("tasks-", ".ndjson", "append"),
    "capacity": ("ledger-", ".ndjson", "append"),
    "profiles": ("profile-", ".json", "replace"),
}


def enabled() -> bool:
    """Is ``RSDL_RELAY`` set to anything but off, 0 or false? Not cached:
    the session reads it once at its start."""
    return _env.relay_armed()


def _period_s() -> float:
    try:
        return max(0.05, float(os.environ.get(ENV_PERIOD, "")))
    except (TypeError, ValueError):
        return _DEFAULT_PERIOD_S


def _max_batch_bytes() -> int:
    try:
        return max(4096, int(os.environ.get(ENV_MAX_BATCH, "")))
    except (TypeError, ValueError):
        return _DEFAULT_MAX_BATCH


def _max_lag_bytes() -> int:
    try:
        return max(4096, int(os.environ.get(ENV_MAX_LAG, "")))
    except (TypeError, ValueError):
        return _DEFAULT_MAX_LAG


def _safe_host(host_id: str) -> str:
    """A host id (``advertise:session``) as part of a file name."""
    return re.sub(r"[^A-Za-z0-9._-]", "_", str(host_id)) or "host"


def _spool_dirs() -> Dict[str, Optional[str]]:
    """Each kind's spool directory as this process resolves it, through
    the port's own plane modules."""
    from ray_shuffling_data_loader_tpu_torch import telemetry

    out: Dict[str, Optional[str]] = {}
    for kind, module in (("metrics", "export"), ("events", "events"), ("audit", "audit"), ("tasks", "stragglers"),
                         ("capacity", "capacity"), ("profiles", "profiler")):
        try:
            out[kind] = getattr(telemetry, module).spool_dir()
        except Exception:
            out[kind] = None
    return out


def _dir_fingerprints(dirs: Optional[Dict[str, Optional[str]]] = None) -> Dict[str, Tuple[int, int]]:
    """``(st_dev, st_ino)`` of each existing spool directory: a shipper's
    directory that is the sink's would count every record twice."""
    out: Dict[str, Tuple[int, int]] = {}
    for kind, d in (dirs if dirs is not None else _spool_dirs()).items():
        if d and os.path.isdir(d):
            try:
                st = os.stat(d)
                out[kind] = (st.st_dev, st.st_ino)
            except OSError:
                pass
    return out


def _restamp(data: bytes, host_id: str, now: float) -> Tuple[bytes, Optional[float]]:
    """Stamp a relayed metrics snapshot with the sink's clock.

    ``export.load_records(max_age_s=)`` ages a record by its ``ts`` against
    the reader's clock, right only while both share a clock. So ``ts``
    becomes the arrival time (the producer's goes to ``producer_ts``): a
    source whose clock runs behind is not expired early, one whose clock
    runs ahead does not live forever once its ships stop. The source's
    host becomes the cluster's host id: a ``host=`` label of its own even
    on one machine, and the aggregate's guard against its own pid keeps
    off another host's records. Returns ``(blob, skew_seconds)``; what is
    not a JSON object passes through."""
    try:
        rec = json.loads(data.decode("utf-8"))
    except (UnicodeDecodeError, ValueError):
        return data, None
    if not isinstance(rec, dict):
        return data, None
    try:
        producer_ts = float(rec.get("ts", 0.0))
    except (TypeError, ValueError):
        producer_ts = 0.0
    rec["producer_ts"] = producer_ts
    rec["ts"] = now
    skew = (now - producer_ts) if producer_ts else None
    src = rec.get("source")
    if isinstance(src, dict):
        src = dict(src)
        src["host"] = host_id
        src["relayed"] = True
        rec["source"] = src
    return json.dumps(rec).encode("utf-8"), skew


def _count(name: str, value: float = 1.0) -> None:
    try:
        from ray_shuffling_data_loader_tpu_torch.telemetry import metrics

        if metrics.enabled():
            metrics.registry.counter(name).inc(value)
    except Exception:
        pass


class RelaySink:
    """The head's half: writes the shipped deltas under the head's spools.
    Its methods run on an actor host's event loop; its state is locked,
    since :func:`status_section` reads it from the HTTP server's threads.
    ``dirs`` stands in for the spool directories this process resolves
    (both halves in one process, in tests)."""

    def __init__(self, dirs: Optional[Dict[str, Optional[str]]] = None):
        self._lock = threading.Lock()
        self._hosts: Dict[str, Dict[str, Any]] = {}
        self._dirs_override = dirs

    def _dirs(self) -> Dict[str, Optional[str]]:
        if self._dirs_override is not None:
            return self._dirs_override
        return _spool_dirs()

    def hello(self, host_id: str, dir_ids: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """The handshake: the kinds to skip (a directory shared with the
        sink) and the byte cursors of this host's landed append files."""
        dirs = self._dirs()
        local = _dir_fingerprints(dirs)
        skip = [kind for kind, did in (dir_ids or {}).items() if did is not None and tuple(did) == local.get(kind)]
        safe = _safe_host(host_id)
        cursors: Dict[str, int] = {}
        for kind, (pre, suf, mode) in _KINDS.items():
            if mode != "append" or kind in skip:
                continue
            d = dirs.get(kind)
            if not d or not os.path.isdir(d):
                continue
            marker = f"{pre}{safe}-"
            try:
                names = os.listdir(d)
            except OSError:
                continue
            for fname in names:
                if not (fname.startswith(marker) and fname.endswith(suf)):
                    continue
                orig = pre + fname[len(marker):]
                try:
                    cursors[f"{kind}/{orig}"] = os.path.getsize(os.path.join(d, fname))
                except OSError:
                    pass
        now = time.time()
        with self._lock:
            rec = self._hosts.setdefault(host_id, {})
            rec.setdefault("ships", 0)
            rec.setdefault("bytes", 0)
            rec["hello_ts"] = now
            rec["last_ship_ts"] = now
            rec["skip"] = list(skip)
        return {"skip": skip, "cursors": cursors}

    def ship(self, host_id: str, items: Optional[list]) -> Dict[str, Dict[str, Any]]:
        """Land a batch of deltas. Each item's CRC is checked; an append
        lands at the sink's size (a gap answers ``want``, an overlap after
        a reconnect is trimmed, so NDJSON stays whole across ships cut
        mid-line); a replace lands atomically (a metrics snapshot
        restamped). An empty batch is a heartbeat: it refreshes the host's
        freshness."""
        now = time.time()
        dirs = self._dirs()
        safe = _safe_host(host_id)
        out: Dict[str, Dict[str, Any]] = {}
        shipped = 0
        skew: Optional[float] = None
        for item in items or []:
            kind = item.get("kind")
            name = item.get("name")
            key = f"{kind}/{name}"
            data = item.get("data") or b""
            if (zlib.crc32(data) & 0xFFFFFFFF) != item.get("crc"):
                out[key] = {"error": "crc"}
                _count("relay.crc_errors_total")
                continue
            spec = _KINDS.get(kind)
            d = dirs.get(kind)
            if (spec is None or not d or not isinstance(name, str) or os.path.basename(name) != name
                    or not name.startswith(spec[0]) or not name.endswith(spec[1])):
                # No home here (the audit off at the head) or a bad name:
                # acked, so the shipper moves on, and counted.
                out[key] = {"acked": int(item.get("offset", 0) or 0) + len(data)}
                _count("relay.unrouted_bytes_total", len(data))
                continue
            pre, _suf, mode = spec
            try:
                os.makedirs(d, exist_ok=True)
                target = os.path.join(d, f"{pre}{safe}-{name[len(pre):]}")
                if mode == "replace":
                    blob = data
                    if kind == "metrics":
                        blob, skew = _restamp(data, host_id, now)
                    tmp = f"{target}.tmp{os.getpid()}"
                    with open(tmp, "wb") as f:
                        f.write(blob)
                    os.replace(tmp, target)
                    out[key] = {"acked": len(data)}
                    shipped += len(data)
                else:
                    offset = int(item.get("offset", 0) or 0)
                    try:
                        cur = os.path.getsize(target)
                    except OSError:
                        cur = 0
                    if offset > cur:
                        out[key] = {"want": cur}
                        continue
                    if offset < cur:
                        data = data[cur - offset:]
                    if data:
                        with open(target, "ab") as f:
                            f.write(data)
                        shipped += len(data)
                    out[key] = {"acked": cur + len(data)}
            except OSError as exc:
                out[key] = {"error": str(exc)}
        with self._lock:
            rec = self._hosts.setdefault(host_id, {})
            rec["last_ship_ts"] = now
            rec["ships"] = rec.get("ships", 0) + 1
            rec["bytes"] = rec.get("bytes", 0) + shipped
            if skew is not None:
                rec["skew_s"] = skew
        try:
            from ray_shuffling_data_loader_tpu_torch.telemetry import metrics

            if metrics.enabled():
                reg = metrics.registry
                reg.counter("relay.ships_total", host=host_id).inc()
                reg.counter("relay.shipped_bytes_total", host=host_id).inc(shipped)
                if skew is not None:
                    reg.gauge("relay.skew_seconds", host=host_id).set(round(skew, 3))
        except Exception:
            pass
        return out

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            return {h: dict(rec) for h, rec in self._hosts.items()}


class _SinkServer:
    """A :class:`RelaySink` served as an actor (:class:`..runtime.actor._ActorHost`)
    on a daemon thread's event loop; the transport authenticates every
    connection with the cluster's token, as for any actor."""

    def __init__(self, bind_host: str, dirs: Optional[Dict[str, Optional[str]]] = None):
        self.sink = RelaySink(dirs)
        self.address: Optional[tuple] = None
        self._bind_host = bind_host
        self._loop = None
        self._host = None
        self._error: Optional[BaseException] = None
        self._ready = threading.Event()
        self._thread = threading.Thread(target=self._run, name="rsdl-relay-sink", daemon=True)

    def _run(self) -> None:
        import asyncio

        from ray_shuffling_data_loader_tpu_torch.runtime.actor import _ActorHost

        async def _main():
            host = _ActorHost(self.sink, ("tcp", self._bind_host, 0))
            try:
                await host.start()
            except BaseException as exc:
                self._error = exc
                self._ready.set()
                return
            self._host = host
            self._loop = asyncio.get_running_loop()
            self.address = tuple(host.address)
            self._ready.set()
            await host.wait_shutdown()

        asyncio.run(_main())

    def start(self, timeout: float = 10.0) -> None:
        self._thread.start()
        if not self._ready.wait(timeout) or self.address is None:
            raise RuntimeError(f"relay sink failed to start: {self._error!r}")

    def stop(self, timeout: float = 5.0) -> None:
        loop, host = self._loop, self._host
        if loop is not None and host is not None:
            try:
                loop.call_soon_threadsafe(host._shutdown.set)
            except RuntimeError:
                pass
        self._thread.join(timeout)


class _Shipper(threading.Thread):
    """The other hosts' half: tails this host's spools, ships the deltas.

    ``resolve_sink`` returns the sink's handle (the cluster's named-actor
    lookup, or a handle in tests); it is called again whenever the
    connection is lost, and the ``hello`` that follows resumes from the
    sink's cursors: a lost sink costs staleness, never a duplicate."""

    def __init__(self, host_id: str, runtime_dir: str, resolve_sink,
                 dirs: Optional[Dict[str, Optional[str]]] = None):
        super().__init__(name="rsdl-relay-shipper", daemon=True)
        self._host_id = host_id
        self._runtime_dir = runtime_dir
        self._resolve_sink = resolve_sink
        self._dirs_override = dirs
        # Not ``_stop``: that name is threading.Thread's own method, which
        # join() calls.
        self._halt = threading.Event()
        self._sink = None
        self._skip: set = set()
        self._cursors: Dict[Tuple[str, str], int] = {}
        # Offsets on the wire are the sink's: it appends only at its size.
        # A skip-ahead makes them differ from this host's, by the bytes
        # dropped from that file, kept here; the sink's files are named by
        # this host's session, which dies with this process.
        self._shift: Dict[Tuple[str, str], int] = {}
        self._replace_sig: Dict[Tuple[str, str], Tuple[int, int]] = {}
        self._last_kick_ns = 0
        self._last_own_flush = 0.0
        # Read by /healthz from other threads.
        self.lag_bytes = 0
        self.dropped_bytes = 0
        self.ship_errors = 0
        self.ships = 0
        self.shipped_bytes = 0
        self.last_ship_ts = 0.0

    def stop_and_join(self, timeout: float = 10.0) -> None:
        self._halt.set()
        self.join(timeout)

    def _local_dirs(self) -> Dict[str, Optional[str]]:
        if self._dirs_override is not None:
            return self._dirs_override
        return _spool_dirs()

    def run(self) -> None:
        period = _period_s()
        kick_path = _kick_path(self._runtime_dir)
        last_ship = 0.0
        while not self._halt.wait(0.05):
            kicked = False
            try:
                ns = os.stat(kick_path).st_mtime_ns
                if ns != self._last_kick_ns:
                    self._last_kick_ns = ns
                    kicked = True
            except OSError:
                pass
            now = time.monotonic()
            if kicked or now - last_ship >= period:
                last_ship = now
                self._cycle_guarded()
        # A last ship: what was written up to the stop reaches the head
        # before this host's directories go.
        self._cycle_guarded()

    def _cycle_guarded(self) -> None:
        try:
            self._ship_cycle()
        except Exception:
            # The sink is gone or the call failed: find it again next
            # cycle (this host's last ship ages at the head meanwhile).
            self._sink = None
            self.ship_errors += 1
            _count("relay.ship_errors_total")

    def _ensure_sink(self) -> bool:
        if self._sink is not None:
            return True
        try:
            handle = self._resolve_sink()
        except Exception:
            handle = None
        if handle is None:
            return False
        reply = handle.call_with_timeout("hello", self._host_id, _dir_fingerprints(self._local_dirs()), timeout=10.0)
        self._skip = set(reply.get("skip") or ())
        for key, size in (reply.get("cursors") or {}).items():
            kind, _, name = key.partition("/")
            k = (kind, name)
            self._cursors[k] = int(size) + self._shift.get(k, 0)
        self._sink = handle
        return True

    def _ship_cycle(self) -> None:
        if not self._ensure_sink():
            return
        budget = _max_batch_bytes()
        max_lag = _max_lag_bytes()
        dirs = self._local_dirs()
        items = []
        sigs: Dict[Tuple[str, str], Tuple[int, int]] = {}
        lag_total = 0
        for kind, (pre, suf, mode) in _KINDS.items():
            if kind in self._skip:
                continue
            d = dirs.get(kind)
            if not d or not os.path.isdir(d):
                continue
            try:
                names = sorted(os.listdir(d))
            except OSError:
                continue
            for fname in names:
                if not (fname.startswith(pre) and fname.endswith(suf)):
                    continue
                path = os.path.join(d, fname)
                key = (kind, fname)
                if mode == "append":
                    try:
                        size = os.path.getsize(path)
                    except OSError:
                        continue
                    cur = self._cursors.get(key, 0)
                    if size < cur:
                        cur = 0  # truncated behind us: from the start
                        self._shift.pop(key, None)
                    if size - cur > max_lag:
                        # Skip ahead to a line boundary and count it; the
                        # dropped bytes widen this file's shift, and the
                        # sink goes on appending where it was.
                        newcur = _line_boundary(path, size - max_lag)
                        if newcur > cur:
                            dropped = newcur - cur
                            self.dropped_bytes += dropped
                            self._shift[key] = self._shift.get(key, 0) + dropped
                            _count("relay.dropped_bytes_total", dropped)
                            self._emit_dropped(kind, fname, dropped)
                            cur = newcur
                    self._cursors[key] = cur
                    take = min(size - cur, budget)
                    if take <= 0:
                        lag_total += max(0, size - cur)
                        continue
                    try:
                        with open(path, "rb") as f:
                            f.seek(cur)
                            data = f.read(take)
                    except OSError:
                        continue
                    if not data:
                        continue
                    budget -= len(data)
                    lag_total += max(0, size - cur - len(data))
                    items.append({"kind": kind, "name": fname, "mode": "append",
                                  "offset": cur - self._shift.get(key, 0), "data": data,
                                  "crc": zlib.crc32(data) & 0xFFFFFFFF})
                else:
                    if budget <= 0:
                        continue
                    try:
                        st = os.stat(path)
                    except OSError:
                        continue
                    sig = (st.st_mtime_ns, st.st_size)
                    if self._replace_sig.get(key) == sig:
                        continue
                    try:
                        with open(path, "rb") as f:
                            data = f.read()
                    except OSError:
                        continue
                    budget -= len(data)
                    sigs[key] = sig
                    items.append({"kind": kind, "name": fname, "mode": "replace", "offset": 0, "data": data,
                                  "crc": zlib.crc32(data) & 0xFFFFFFFF})
        self.lag_bytes = lag_total
        self._set_gauge("relay.lag_bytes", float(lag_total))
        reply = self._sink.call_with_timeout("ship", self._host_id, items, timeout=30.0)
        self.last_ship_ts = time.time()
        self.ships += 1
        for item in items:
            key = (item["kind"], item["name"])
            res = (reply or {}).get(f"{item['kind']}/{item['name']}") or {}
            if item["mode"] == "append":
                shift = self._shift.get(key, 0)
                if "acked" in res:
                    self._cursors[key] = int(res["acked"]) + shift
                    self.shipped_bytes += len(item["data"])
                elif "want" in res:
                    self._cursors[key] = int(res["want"]) + shift
            elif "acked" in res and key in sigs:
                self._replace_sig[key] = sigs[key]
                self.shipped_bytes += len(item["data"])
        # This process's relay.* instruments spool too (at most once a
        # second), so the shipper's health travels the channel it runs.
        now = time.monotonic()
        if items and now - self._last_own_flush > 1.0:
            self._last_own_flush = now
            try:
                from ray_shuffling_data_loader_tpu_torch.telemetry import export

                export.maybe_flush()
            except Exception:
                pass

    def _emit_dropped(self, kind: str, fname: str, nbytes: int) -> None:
        try:
            from ray_shuffling_data_loader_tpu_torch.telemetry import events, metrics

            if metrics.enabled():
                events.emit("relay.dropped", spool=kind, file=fname, bytes=nbytes)
        except Exception:
            pass

    @staticmethod
    def _set_gauge(name: str, value: float) -> None:
        try:
            from ray_shuffling_data_loader_tpu_torch.telemetry import metrics

            if metrics.enabled():
                metrics.registry.gauge(name).set(value)
        except Exception:
            pass


def _line_boundary(path: str, target: int) -> int:
    """The first offset at or after ``target`` that starts a line: a skip
    ahead must not leave half a record."""
    target = max(0, target)
    try:
        with open(path, "rb") as f:
            f.seek(target)
            chunk = f.read(1 << 16)
    except OSError:
        return target
    nl = chunk.find(b"\n")
    return target + nl + 1 if nl >= 0 else target


def _kick_path(runtime_dir: str) -> str:
    return os.path.join(runtime_dir, "relay", "kick")


# -- the session's half --------------------------------------------------------

_lock = threading.Lock()
_sink_server: Optional[_SinkServer] = None
_shipper: Optional[_Shipper] = None

_KICK_MIN_INTERVAL_S = 0.05
_last_kick = 0.0


def maybe_start(ctx) -> None:
    """Start this host's half, once, on a session's owner (the session's
    workers spool under its directory, and its one shipper tails them
    all): the head serves the sink and registers its name, another host
    starts the shipper. A session outside a cluster has nothing to ship."""
    global _sink_server, _shipper
    if not enabled() or not getattr(ctx, "owner", False):
        return
    cluster = getattr(ctx, "cluster", None)
    if cluster is None:
        return
    with _lock:
        if cluster.is_head:
            if _sink_server is not None:
                return
            server = _SinkServer(cluster.advertise_host)
            server.start()
            from ray_shuffling_data_loader_tpu_torch.runtime.actor import ActorHandle

            try:
                cluster.register_named_actor(SINK_ACTOR_NAME, ActorHandle(server.address, pid=os.getpid()))
            except Exception:
                server.stop()
                raise
            ctx._owned_names.append(SINK_ACTOR_NAME)
            _sink_server = server
        else:
            if _shipper is not None:
                return
            shipper = _Shipper(cluster.host_id, ctx.runtime_dir, lambda: cluster.lookup_named_actor(SINK_ACTOR_NAME))
            shipper.start()
            _shipper = shipper


def stop() -> None:
    """Stop whichever half runs here. The shipper ships once more on its
    way out (the barriers flushed the spools), so what was written up to
    the end reaches the head before the session's directory goes."""
    global _sink_server, _shipper
    with _lock:
        shipper, _shipper = _shipper, None
        server, _sink_server = _sink_server, None
    if shipper is not None:
        shipper.stop_and_join()
    if server is not None:
        server.stop()


def kick() -> None:
    """Wake this host's shipper: touch ``$RSDL_RUNTIME_DIR/relay/kick``.
    Called after a spool flush at the task-done and actor barriers, from
    any process of the host; the shipper polls the file's mtime every
    50 ms. At most one touch per 50 ms; never raises; off a cluster the
    file is watched by no one."""
    global _last_kick
    now = time.monotonic()
    if now - _last_kick < _KICK_MIN_INTERVAL_S:
        return
    _last_kick = now
    runtime_dir = os.environ.get(_RUNTIME_DIR_ENV)
    if not runtime_dir:
        return
    path = _kick_path(runtime_dir)
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "ab"):
            pass
        os.utime(path, None)
    except OSError:
        pass


def status_section() -> Dict[str, Any]:
    """``/healthz``'s ``relay`` section: the half that runs here and, on
    the sink, each source host's freshness (a dead relay shows live)."""
    now = time.time()
    out: Dict[str, Any] = {"role": None, "hosts": {}}
    server = _sink_server
    if server is not None:
        out["role"] = "sink"
        out["address"] = list(server.address) if server.address else None
        for host_id, rec in server.sink.snapshot().items():
            age = now - float(rec.get("last_ship_ts", 0.0) or 0.0)
            out["hosts"][host_id] = {
                "age_s": round(age, 1),
                "stale": age > _STALE_AFTER_S,
                "ships": rec.get("ships", 0),
                "bytes": rec.get("bytes", 0),
                "skew_s": round(float(rec.get("skew_s", 0.0)), 3),
                "skipped_kinds": rec.get("skip", []),
            }
    shipper = _shipper
    if shipper is not None:
        out["role"] = "shipper"
        out["shipper"] = {
            "connected": shipper._sink is not None,
            "ships": shipper.ships,
            "shipped_bytes": shipper.shipped_bytes,
            "lag_bytes": shipper.lag_bytes,
            "dropped_bytes": shipper.dropped_bytes,
            "ship_errors": shipper.ship_errors,
            "last_ship_age_s": round(now - shipper.last_ship_ts, 1) if shipper.last_ship_ts else None,
        }
    return out


def publish_metrics() -> None:
    """The sink's freshness gauges per source host (on the time series'
    tick)."""
    server = _sink_server
    if server is None:
        return
    try:
        from ray_shuffling_data_loader_tpu_torch.telemetry import metrics

        if not metrics.enabled():
            return
        now = time.time()
        hosts = server.sink.snapshot()
        reg = metrics.registry
        reg.gauge("relay.sources").set(float(len(hosts)))
        for host_id, rec in hosts.items():
            age = now - float(rec.get("last_ship_ts", now) or now)
            reg.gauge("relay.last_ship_age_seconds", host=host_id).set(round(age, 1))
    except Exception:
        pass
