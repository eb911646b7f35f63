"""Shared-memory columnar object store: the data plane between processes.

Producers write columnar buffers into per-object segment files in a
shared-memory directory and pass only small :class:`ObjectRef` handles
through the task pool and the batch queue; readers map a segment and get
zero-copy numpy views. The store has no server process: the filesystem is
the index, and a session's segments share the prefix ``<session>-``, so
one sweep (:meth:`ObjectStore.cleanup`) reclaims everything it made.

Segment layout: a header (magic, meta length), a JSON meta blob naming
each column's dtype, shape and offset, then the columns, each starting on
a 64-byte boundary. Segments are created under a hidden ``.tmp`` name and
renamed when complete, so a reader never maps a half-written one.

**Budget.** A session's shared-memory residency is capped at
``capacity_bytes`` (:func:`_default_capacity_bytes`: 0.8 of the shm
filesystem by default). A segment that would take the session over it is
created in the disk-backed spill directory instead; readers find a
segment in either place. A resumed run re-attaches segments that a
preempted session left behind (:meth:`ObjectStore.adopt_session`): they
keep their old prefix and count towards the budget until they are swept
(:meth:`ObjectStore.cleanup` with ``session=``).

**Tier moves.** The elastic evictor (:mod:`.elastic`) moves a published
segment, all its hardlinked names together, between the tiers:
:meth:`ObjectStore.demote` to the spill directory, :meth:`ObjectStore.
promote` back within the budget, and :meth:`ObjectStore.drop_segments`
unlinks it for lineage to re-make. Each move notes a ``transition`` in the
capacity ledger and counts ``store.tier_moved_bytes_total{tier}``.

**Packed segments.** A segment may carry a layout descriptor in its meta.
A reducer that knows the trainer's staging layout writes its whole
batches as one column :data:`PACKED_COLUMN` of shape ``[n_batches, n_cols,
batch]`` int32, each batch one contiguous ``[n_cols, batch]`` block, float
columns as their bit patterns; :func:`iter_packed_batches` cuts it into
per-batch views whose ``.packed`` block is copied to the device in one
piece.

**Foreign refs.** In a cluster (:mod:`.cluster`) every ref carries its
``owner``, the store server of the host that made it. A reader whose own
directories lack a foreign ref's segment pulls just the ref's window from
the owner once, into a cache segment of its own session
(``<session>-cache-<id>[+w<lo>-<hi>]``), and maps that; :meth:`ObjectStore.
prefetch` starts such pulls on background threads, :meth:`ObjectStore.
drop_cache` drops a cache and keeps the owner's copy, and
:meth:`ObjectStore.free` of a foreign ref drops the cache and frees the
owner's copy. With ``RSDL_TCP_ZEROCOPY`` the bytes land straight in the
cache's mapping (:func:`serialize_columns_vectored` on the owner's side),
striped over ``RSDL_TCP_STREAMS`` connections.

With metrics on, a spill counts into ``store.spill_bytes_total`` (and the
``store.spill`` event), and each foreign window pulled into
``store.fetch_window_seconds`` and ``store.fetch_window_bytes``; every
publish, fetch, free, clean-up and read records an op in the capacity
ledger (:mod:`..telemetry.capacity`), with the shared decode cache's
segments under its ``cache`` tier.

This module imports numpy and the standard library only: the spawned task
workers load it.
"""

from __future__ import annotations

import errno
import json
import mmap
import os
import secrets
import struct
import threading
import time
from collections.abc import Mapping
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ray_shuffling_data_loader_tpu_torch.telemetry import metrics as _metrics

from . import transport as _transport

_MAGIC = b"RSDL1\x00"
_ALIGN = 64
_HEADER = struct.Struct("<6sI")  # magic, meta length


def _ledger_note(op: str, object_id: str, nbytes: int = 0, tier: Optional[str] = None, ids=None) -> None:
    """One op for the capacity ledger (:mod:`..telemetry.capacity`): with
    metrics off, one cached boolean, and the module is never imported;
    never raises."""
    if not _metrics.enabled():
        return
    try:
        from ray_shuffling_data_loader_tpu_torch.telemetry import capacity

        capacity.note(op, object_id, nbytes=nbytes, tier=tier, ids=ids)
    except Exception:
        pass


def _ledger_touch(object_id: str) -> None:
    """A read's stamp for the capacity ledger (rate-limited per id there);
    one cached boolean with metrics off."""
    if not _metrics.enabled():
        return
    try:
        from ray_shuffling_data_loader_tpu_torch.telemetry import capacity

        capacity.touch(object_id)
    except Exception:
        pass


def _default_shm_dir() -> str:
    """``$RSDL_SHM_DIR``, else ``/dev/shm``, else the temp dir."""
    d = os.environ.get("RSDL_SHM_DIR")
    if d:
        return d
    if os.path.isdir("/dev/shm"):
        return "/dev/shm"
    import tempfile

    return tempfile.gettempdir()


def _default_spill_dir() -> str:
    """``$RSDL_SPILL_DIR``, else ``rsdl-spill`` in the temp dir."""
    d = os.environ.get("RSDL_SPILL_DIR")
    if d:
        return d
    import tempfile

    return os.path.join(tempfile.gettempdir(), "rsdl-spill")


def _default_capacity_bytes(shm_dir: str) -> Optional[int]:
    """The session's shared-memory budget: ``$RSDL_STORE_CAPACITY_BYTES``
    (a value of 0 or less means no budget), else
    ``$RSDL_STORE_CAPACITY_FRACTION`` (default 0.8) of the size of the
    filesystem holding ``shm_dir``; None when that cannot be read."""
    env = os.environ.get("RSDL_STORE_CAPACITY_BYTES")
    if env:
        return int(env) if int(env) > 0 else None
    frac = float(os.environ.get("RSDL_STORE_CAPACITY_FRACTION", "0.8"))
    try:
        st = os.statvfs(shm_dir)
    except OSError:
        return None
    return int(st.f_blocks * st.f_frsize * frac)


_SPILL_EVENT_INTERVAL_S = 5.0
_spill_lock = threading.Lock()
_spill_event_last = float("-inf")
_spill_pending_bytes = 0
_spill_pending_events = 0


def _note_spill(nbytes: int) -> None:
    """A segment placed on disk: ``store.spill_bytes_total`` counts every
    byte, and at most one ``store.spill`` event per 5 s per process
    carries the bytes of the spills it folded (``events_folded``), so the
    event log still sums to the total. Cached booleans while metrics are
    off; never raises."""
    global _spill_event_last, _spill_pending_bytes, _spill_pending_events
    if not _metrics.enabled():
        return
    _metrics.safe_inc("store.spill_bytes_total", float(nbytes))
    now = time.monotonic()
    with _spill_lock:
        _spill_pending_bytes += int(nbytes)
        _spill_pending_events += 1
        if now - _spill_event_last < _SPILL_EVENT_INTERVAL_S:
            return
        _spill_event_last = now
        pending, _spill_pending_bytes = _spill_pending_bytes, 0
        folded, _spill_pending_events = _spill_pending_events, 0
    try:
        from ray_shuffling_data_loader_tpu_torch import telemetry

        telemetry.emit_event("store.spill", nbytes=int(pending), events_folded=int(folded))
    except Exception:
        pass


def fetch_window_depth(default: int = 8) -> int:
    """``RSDL_FETCH_WINDOW_DEPTH``: how many input windows a reduce keeps
    in flight (at least 1), else ``default`` when unset or malformed. The
    overlapped reduce defaults to 4 (it also bounds the windows cached at
    once), the delivery's prefetch to 8."""
    env = os.environ.get("RSDL_FETCH_WINDOW_DEPTH")
    if not env:
        return default
    try:
        return max(1, int(env))
    except ValueError:
        return default


class GrowingThreadPool:
    """A thread pool that widens on demand: the store's prefetch pool and
    the cluster client's stripe pool take the width of their widest
    caller. It grows by replacement; a replaced pool is retired, not shut
    down, so a submit racing the growth still runs."""

    def __init__(self, thread_name_prefix: str):
        self._prefix = thread_name_prefix
        self._lock = threading.Lock()
        self._pool = None
        self._retired: list = []
        self.width = 0

    def ensure(self, width: int) -> "GrowingThreadPool":
        """At least ``width`` threads wide; returns self."""
        import concurrent.futures

        with self._lock:
            if self._pool is None or width > self.width:
                if self._pool is not None:
                    self._retired.append(self._pool)
                self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=width,
                                                                   thread_name_prefix=self._prefix)
                self.width = width
        return self

    def submit(self, fn, *args, **kwargs):
        with self._lock:
            if self._pool is None:
                raise RuntimeError("GrowingThreadPool: ensure() not called")
            pool = self._pool
        return pool.submit(fn, *args, **kwargs)

    def shutdown(self, wait: bool = False) -> None:
        with self._lock:
            pools, self._retired = list(self._retired), []
            if self._pool is not None:
                pools.append(self._pool)
                self._pool = None
            self.width = 0
        for pool in pools:
            pool.shutdown(wait=wait)


def _align(n: int) -> int:
    return (n + _ALIGN - 1) // _ALIGN * _ALIGN


def _plan_layout(spec: Mapping[str, Tuple[Tuple[int, ...], np.dtype]], layout: Optional[dict] = None):
    """The one definition of the segment format for a ``{name: (shape,
    dtype)}`` spec: ``(per-column meta, meta blob, payload start, total
    bytes)``. ``layout``, a JSON-safe descriptor, rides in the meta."""
    meta: List[dict] = []
    offset = 0
    for name, (shape, dtype) in spec.items():
        dtype = np.dtype(dtype)
        nbytes = int(dtype.itemsize * int(np.prod(shape, dtype=np.int64)))
        offset = _align(offset)
        meta.append(
            {"name": name, "dtype": dtype.str, "shape": list(shape), "offset": offset, "nbytes": nbytes}
        )
        offset += nbytes
    head: Dict[str, object] = {"columns": meta}
    if layout is not None:
        head["layout"] = layout
    meta_blob = json.dumps(head).encode()
    payload_start = _align(_HEADER.size + len(meta_blob))
    return meta, meta_blob, payload_start, payload_start + _align(offset)


class ObjectLostError(FileNotFoundError):
    """A ref's segment is gone (freed, or its session cleaned up)."""

    def __init__(self, object_id: str, detail: str = ""):
        super().__init__(errno.ENOENT, f"store object {object_id!r} lost" + (f" ({detail})" if detail else ""))
        self.object_id = object_id
        self._detail = detail

    def __reduce__(self):
        return (type(self), (self.object_id, self._detail))


class ObjectCorruptError(ObjectLostError):
    """A segment exists but is not one (bad magic): recovered like a lost
    one."""

    def __init__(self, object_id: str, detail: str = "corrupt payload"):
        super().__init__(object_id, detail)


class StoreFullError(OSError):
    """The shared-memory directory has no room for a new segment."""

    def __init__(self, shm_dir: str, nbytes: int, free_bytes: int):
        super().__init__(
            errno.ENOSPC,
            f"object store full: a {nbytes} B segment does not fit in {shm_dir} "
            f"({free_bytes} B free); set RSDL_SHM_DIR to a larger directory",
        )
        self.shm_dir, self.nbytes, self.free_bytes = shm_dir, nbytes, free_bytes

    def __reduce__(self):
        return (type(self), (self.shm_dir, self.nbytes, self.free_bytes))


def free_bytes(path: str) -> int:
    """Bytes available to this user in the filesystem holding ``path``."""
    st = os.statvfs(path)
    return st.f_bavail * st.f_frsize


@dataclass(frozen=True)
class ObjectRef:
    """A small picklable handle to a segment. ``owner``: in a cluster, the
    store server of the host that made it (None on one host). ``rows``
    restricts it to a half-open row window: several refs may hardlink one
    segment (the map stage publishes its per-reducer partitions so), each
    ref owning its own link; the pages are reclaimed when the last link is
    freed."""

    object_id: str
    nbytes: int
    session: str = ""
    owner: Optional[Tuple] = None
    rows: Optional[Tuple[int, int]] = None


class ColumnBatch(Mapping):
    """Named equal-length numpy columns (``Mapping[str, np.ndarray]``),
    plain arrays or zero-copy views of a mapped segment, which the batch
    keeps alive. ``layout`` is the segment's layout descriptor, if any;
    ``packed`` is set on the per-batch views of a packed segment
    (:func:`iter_packed_batches`): the contiguous ``[n_cols, batch]`` int32
    block that the logical columns view."""

    def __init__(
        self,
        columns: Dict[str, np.ndarray],
        _keepalive=None,
        layout: Optional[dict] = None,
        packed: Optional[np.ndarray] = None,
    ):
        self._columns = columns
        self._keepalive = _keepalive
        self.layout = layout
        self.packed = packed
        lengths = {len(v) for v in columns.values()}
        if len(lengths) > 1:
            raise ValueError(f"ragged columns: {lengths}")
        self._num_rows = lengths.pop() if lengths else 0

    def __getitem__(self, key: str) -> np.ndarray:
        return self._columns[key]

    def __iter__(self) -> Iterator[str]:
        return iter(self._columns)

    def __len__(self) -> int:
        return len(self._columns)

    @property
    def num_rows(self) -> int:
        return self._num_rows

    @property
    def columns(self) -> Dict[str, np.ndarray]:
        return self._columns

    @property
    def nbytes(self) -> int:
        return sum(v.nbytes for v in self._columns.values())

    def slice(self, start: int, stop: int) -> "ColumnBatch":
        """Zero-copy row slice (the mapping stays alive with it). A packed
        segment slices along its batch axis, so its layout stays valid."""
        return ColumnBatch(
            {k: v[start:stop] for k, v in self._columns.items()}, _keepalive=self._keepalive, layout=self.layout
        )

    @staticmethod
    def concat(batches: Sequence[Optional["ColumnBatch"]]) -> "ColumnBatch":
        batches = [b for b in batches if b is not None and b.num_rows > 0]
        if not batches:
            return ColumnBatch({})
        if len(batches) == 1:
            return batches[0]
        return ColumnBatch({k: np.concatenate([b[k] for b in batches]) for k in batches[0]})


class PendingColumns:
    """An allocated, unpublished segment with writable column views, from
    :meth:`ObjectStore.create_columns`. Fill the views, then :meth:`seal`
    (one ref) or :meth:`publish_slices` (one hardlinked ref per row
    window); :meth:`abort` reclaims it and is a no-op after a publish.
    A publish records a ``create`` in the capacity ledger under
    ``ledger_tier`` (None: the tier the segment lies on)."""

    def __init__(self, store: "ObjectStore", object_id: str, tmp_path: str, path: str, nbytes: int, mm, views,
                 ledger_tier: Optional[str] = None):
        self._store = store
        self.object_id = object_id
        self._tmp = tmp_path
        self._path = path
        self.nbytes = nbytes
        self._mm = mm
        self.columns: Dict[str, np.ndarray] = views
        self._published = False
        self._ledger_tier = ledger_tier

    def seal(self) -> ObjectRef:
        assert not self._published, "already published"
        os.rename(self._tmp, self._path)
        self._published = True
        _ledger_note("create", self.object_id, self.nbytes, self._ledger_tier or self._store.tier_of(self._path))
        return ObjectRef(self.object_id, self.nbytes, self._store.session, owner=self._store.owner_address)

    def publish_slices(self, windows: Sequence[Tuple[int, int]]) -> List[ObjectRef]:
        assert not self._published, "already published"
        seg_dir = os.path.dirname(self._tmp)  # shm or spill: links stay beside it
        refs: List[ObjectRef] = []
        try:
            for start, stop in windows:
                link_id = self._store._new_object_id()
                os.link(self._tmp, os.path.join(seg_dir, link_id))
                refs.append(ObjectRef(link_id, self.nbytes, self._store.session, owner=self._store.owner_address,
                                      rows=(int(start), int(stop))))
        except BaseException:
            for ref in refs:  # no caller ever sees these links
                try:
                    os.unlink(os.path.join(seg_dir, ref.object_id))
                except FileNotFoundError:
                    pass
            raise
        os.unlink(self._tmp)
        self._published = True
        # One segment with every link: its bytes stay resident until the
        # last link goes, as the file system counts them.
        _ledger_note("create", self.object_id, self.nbytes, self._ledger_tier or self._store.tier_of(self._tmp),
                     ids=[r.object_id for r in refs])
        return refs

    def abort(self) -> None:
        if not self._published:
            try:
                os.unlink(self._tmp)
            except FileNotFoundError:
                pass
            self._published = True


def map_segment_file(path: str, object_id: str = "?", populate: bool = False) -> ColumnBatch:
    """mmap a published segment file into zero-copy column views.
    ``populate``: fill the mapping's page tables in the one call
    (``MAP_POPULATE``), for a reader that will read every byte, instead of
    one page fault per first touch."""
    fd = os.open(path, os.O_RDONLY)
    try:
        flags = mmap.MAP_SHARED | (getattr(mmap, "MAP_POPULATE", 0) if populate else 0)
        mm = mmap.mmap(fd, os.fstat(fd).st_size, flags=flags, prot=mmap.PROT_READ)
    finally:
        os.close(fd)
    magic, meta_len = _HEADER.unpack_from(mm, 0)
    if magic != _MAGIC:
        raise ValueError(f"corrupt object segment {object_id!r}")
    meta = json.loads(bytes(mm[_HEADER.size : _HEADER.size + meta_len]))
    payload_start = _align(_HEADER.size + meta_len)
    cols = {
        m["name"]: np.frombuffer(
            mm,
            dtype=np.dtype(m["dtype"]),
            count=int(np.prod(m["shape"], dtype=np.int64)) if m["shape"] else 1,
            offset=payload_start + m["offset"],
        ).reshape(m["shape"])
        for m in meta["columns"]
    }
    return ColumnBatch(cols, _keepalive=mm, layout=meta.get("layout"))


def serialize_columns(columns: Mapping[str, np.ndarray], layout: Optional[dict] = None) -> bytes:
    """The segment format of ``columns`` (stamped with ``layout``) as
    bytes: what :func:`map_segment_file` reads back."""
    cols = {k: np.ascontiguousarray(v) for k, v in columns.items()}
    meta, meta_blob, payload_start, total = _plan_layout({k: (v.shape, v.dtype) for k, v in cols.items()}, layout)
    out = bytearray(total)
    out[: _HEADER.size] = _HEADER.pack(_MAGIC, len(meta_blob))
    out[_HEADER.size : _HEADER.size + len(meta_blob)] = meta_blob
    view = np.frombuffer(out, dtype=np.uint8)
    for m, arr in zip(meta, cols.values()):
        start = payload_start + m["offset"]
        view[start : start + arr.nbytes] = arr.reshape(-1).view(np.uint8)
    return bytes(out)


_PAD64 = bytes(_ALIGN)


def serialize_columns_vectored(columns: Mapping[str, np.ndarray], layout: Optional[dict] = None) -> Tuple[int, List]:
    """``(total_bytes, buffers)``: :func:`serialize_columns`'s bytes as a
    scatter-gather list, without building them. The buffers are a header,
    the columns' own views and the alignment pads between them (each under
    64 bytes); the caller keeps the columns' mapping alive until they are
    sent."""
    cols = {k: (v if v.flags.c_contiguous else np.ascontiguousarray(v)) for k, v in columns.items()}
    meta, meta_blob, payload_start, total = _plan_layout({k: (v.shape, v.dtype) for k, v in cols.items()}, layout)
    head = bytearray(payload_start)
    head[: _HEADER.size] = _HEADER.pack(_MAGIC, len(meta_blob))
    head[_HEADER.size : _HEADER.size + len(meta_blob)] = meta_blob
    bufs: List = [head]
    pos = payload_start
    for m, arr in zip(meta, cols.values()):
        target = payload_start + m["offset"]
        if target > pos:
            bufs.append(_PAD64[: target - pos])
            pos = target
        if arr.nbytes:
            bufs.append(memoryview(arr).cast("B"))
            pos += arr.nbytes
    if total > pos:
        bufs.append(_PAD64[: total - pos])
    return total, bufs


# -- packed segments ------------------------------------------------------------

PACKED_COLUMN = "__packed__"
DEVICE_BATCH_KIND = "device-batch"


def is_device_batch(cb: ColumnBatch) -> bool:
    """Does ``cb`` hold a packed segment (whole batches in staging layout)?"""
    return cb.layout is not None and cb.layout.get("kind") == DEVICE_BATCH_KIND and PACKED_COLUMN in cb


class _LogicalColumns(Mapping):
    """The logical columns of a whole packed segment, each built on first
    access as one contiguous copy of its plane: the audit reads the key
    column alone."""

    def __init__(self, cb: ColumnBatch):
        self._mat = cb[PACKED_COLUMN]
        self._names = list(cb.layout["columns"])
        self._dtypes = [np.dtype(d) for d in cb.layout["dtypes"]]
        self._cache: Dict[str, np.ndarray] = {}

    def __getitem__(self, name: str) -> np.ndarray:
        out = self._cache.get(name)
        if out is None:
            try:
                i = self._names.index(name)
            except ValueError:
                raise KeyError(name) from None
            out = self._cache[name] = self._mat[:, i, :].reshape(-1).view(self._dtypes[i])
        return out

    def __iter__(self) -> Iterator[str]:
        return iter(self._names)

    def __len__(self) -> int:
        return len(self._names)


def logical_columns(cb: ColumnBatch) -> Mapping:
    """Name -> 1-D logical column of any batch: a columnar batch's own
    columns, or a packed segment's planes flattened on first access."""
    return _LogicalColumns(cb) if is_device_batch(cb) else cb.columns


def rows_of(cb: ColumnBatch) -> int:
    """Logical rows of any batch: a packed segment's batches times the
    batch size, or a columnar batch's rows."""
    if is_device_batch(cb):
        mat = cb[PACKED_COLUMN]
        return int(mat.shape[0]) * int(mat.shape[2])
    return cb.num_rows


def iter_packed_batches(cb: ColumnBatch) -> Iterator[ColumnBatch]:
    """A packed segment's batches as :class:`ColumnBatch` views: each
    logical column is row ``i`` of the batch's block, bit-viewed back to its
    dtype, and ``.packed`` is the whole ``[n_cols, batch]`` block. The views
    keep the segment's mapping alive."""
    lay = cb.layout or {}
    mat = cb[PACKED_COLUMN]
    names = lay["columns"]
    dtypes = [np.dtype(d) for d in lay["dtypes"]]
    for b in range(mat.shape[0]):
        block = mat[b]
        cols = {name: block[i].view(dt) for i, (name, dt) in enumerate(zip(names, dtypes))}
        yield ColumnBatch(cols, _keepalive=cb._keepalive, layout=lay, packed=block)


@dataclass
class StoreStats:
    """One session's residency: objects (every ref, hardlinks included) and
    bytes (once per physical segment), ``spill_bytes`` of them on disk."""

    num_objects: int = 0
    total_bytes: int = 0
    spill_bytes: int = 0


class ObjectStore:
    """The session's store over one shared-memory directory and its spill
    directory.

    ``capacity_bytes`` caps the session's shared-memory residency: a
    segment that would take the session over it is created in
    ``spill_dir``. None (no budget) when the budget cannot be read or the
    spill directory is the shm directory itself."""

    def __init__(self, session: str, shm_dir: Optional[str] = None, sessions_file: Optional[str] = None):
        self.session = session
        # The sessions whose segments this one adopted, one per line: a
        # file every process of the session reads.
        self._sessions_file = sessions_file
        self.shm_dir = shm_dir or _default_shm_dir()
        os.makedirs(self.shm_dir, exist_ok=True)
        self.capacity_bytes: Optional[int] = _default_capacity_bytes(self.shm_dir)
        self.spill_dir = _default_spill_dir()
        if os.path.realpath(self.spill_dir) == os.path.realpath(self.shm_dir):
            self.capacity_bytes = None
        # The session's shm bytes, rescanned at most every 0.2 s; creations
        # since the scan are added on top (frees are not subtracted: the
        # estimate errs high, and a segment spills a little early).
        self._scan_bytes = 0
        self._scan_adjust = 0
        self._scan_at = float("-inf")
        # The cluster's hooks (runtime.init when joined): refs made here
        # carry ``owner_address``; a foreign ref's bytes come through
        # ``remote_fetch(ref) -> bytes`` or, with the zero-copy plane,
        # ``remote_fetch_into(ref, alloc)``; ``remote_free(ref)`` frees
        # the owner's copy.
        self.owner_address: Optional[Tuple] = None
        self.remote_fetch = None
        self.remote_fetch_into = None
        self.remote_free = None
        self._foreign: set = set()  # cache names this process fetched
        self._prefetch_pool = GrowingThreadPool("store-prefetch")
        # Cache names freed or dropped in this process: a prefetch landing
        # after that discards its copy instead of orphaning it. Cleared
        # when it outgrows any window a prefetch could still be in flight.
        self._freed_caches: set = set()
        # Cache names a prefetch is pulling now -> its future: a reader of
        # the same window waits for it instead of fetching it again.
        self._pulling: Dict[str, object] = {}
        self._pulling_lock = threading.Lock()

    def _new_object_id(self) -> str:
        return f"{self.session}-{secrets.token_hex(8)}"

    def _path(self, object_id: str) -> str:
        return os.path.join(self.shm_dir, object_id)

    def adopted_sessions(self) -> List[str]:
        """The preempted sessions whose segments this session re-attached."""
        if self._sessions_file is None:
            return []
        try:
            with open(self._sessions_file) as f:
                return [line.strip() for line in f if line.strip()]
        except FileNotFoundError:
            return []

    def adopt_session(self, session: str) -> None:
        """Count ``session``'s surviving segments as this session's (the
        budget and :meth:`store_stats`) until :meth:`cleanup` sweeps it."""
        if self._sessions_file is None or session == self.session or session in self.adopted_sessions():
            return
        with open(self._sessions_file, "a") as f:
            f.write(session + "\n")

    def _session_files(
        self, directory: str, unfinished: bool = False, sessions: Optional[Sequence[str]] = None
    ) -> Iterator[Tuple[str, os.stat_result]]:
        """``(name, stat)`` of every published segment link of ``sessions``
        (default: this session and the ones it adopted) in ``directory``,
        and with ``unfinished`` of every segment still being written."""
        if sessions is None:
            sessions = [self.session, *self.adopted_sessions()]
        prefixes = tuple(f"{s}-" for s in sessions)
        try:
            names = os.listdir(directory)
        except FileNotFoundError:
            return
        for name in names:
            if name.startswith(prefixes) and (unfinished or not name.endswith(".tmp")):
                try:
                    yield name, os.stat(os.path.join(directory, name))
                except FileNotFoundError:
                    continue

    def _shm_session_bytes(self) -> int:
        """This session's shared-memory bytes (once per segment). The
        filesystem is the truth the session's processes share; racing
        workers may each overshoot the budget by one segment."""
        now = time.monotonic()
        if now - self._scan_at > 0.2:
            seen = {st.st_ino: st.st_size for _, st in self._session_files(self.shm_dir, unfinished=True)}
            self._scan_bytes, self._scan_adjust, self._scan_at = sum(seen.values()), 0, now
        return self._scan_bytes + self._scan_adjust

    def _placement_dir(self, nbytes: int) -> str:
        """Where a new segment of ``nbytes`` goes: the shm directory while
        the session stays within its budget, else the spill directory."""
        if self.capacity_bytes is not None and nbytes + self._shm_session_bytes() > self.capacity_bytes:
            os.makedirs(self.spill_dir, exist_ok=True)
            _note_spill(nbytes)
            return self.spill_dir
        self._scan_adjust += nbytes
        return self.shm_dir

    def tier_of(self, path: str) -> str:
        """The capacity ledger's tier of a segment path: ``spill`` in the
        spill directory, else ``shm``."""
        return "spill" if os.path.dirname(path) == self.spill_dir else "shm"

    def _find_segment(self, object_id: str) -> Optional[str]:
        """A published link's path, in the shm directory or the spill one."""
        for directory in (self.shm_dir, self.spill_dir):
            path = os.path.join(directory, object_id)
            if os.path.exists(path):
                return path
        return None

    # -- write path ---------------------------------------------------------

    def create_columns(
        self, spec: Mapping[str, Tuple[Tuple[int, ...], np.dtype]], layout: Optional[dict] = None,
        ledger_tier: Optional[str] = None,
    ) -> PendingColumns:
        """Allocate a segment for ``{name: (shape, dtype)}`` (stamped with
        ``layout``) and return its writable views. The pages are reserved up
        front: a segment that does not fit raises :class:`StoreFullError`
        here, not a bus error when a view is written. ``ledger_tier``: the
        capacity ledger's tier of its publish (``cache`` for the shared
        decode cache), not where it lies."""
        faults = _transport.faults()
        if faults.enabled():
            faults.fire("store.put")
        meta, meta_blob, payload_start, total = _plan_layout(spec, layout)
        object_id = self._new_object_id()
        directory = self._placement_dir(total)
        path = os.path.join(directory, object_id)
        tmp = path + ".tmp"
        fd = os.open(tmp, os.O_CREAT | os.O_EXCL | os.O_RDWR, 0o600)
        try:
            try:
                os.posix_fallocate(fd, 0, max(total, 1))
            except OSError as exc:
                os.unlink(tmp)
                if exc.errno in (errno.ENOSPC, errno.EFBIG):
                    raise StoreFullError(directory, total, free_bytes(directory)) from exc
                raise
            mm = mmap.mmap(fd, max(total, 1))
        finally:
            os.close(fd)
        mm[: _HEADER.size] = _HEADER.pack(_MAGIC, len(meta_blob))
        mm[_HEADER.size : _HEADER.size + len(meta_blob)] = meta_blob
        views = {
            m["name"]: np.frombuffer(
                mm,
                dtype=np.dtype(m["dtype"]),
                count=int(np.prod(m["shape"], dtype=np.int64)),
                offset=payload_start + m["offset"],
            ).reshape(m["shape"])
            for m in meta
        }
        return PendingColumns(self, object_id, tmp, path, total, mm, views, ledger_tier=ledger_tier)

    def put_columns(self, columns: Mapping[str, np.ndarray], ledger_tier: Optional[str] = None) -> ObjectRef:
        """Write a columnar batch as one segment; returns its ref.
        ``ledger_tier``: as :meth:`create_columns`'."""
        cols = {k: np.ascontiguousarray(v) for k, v in columns.items()}
        pending = self.create_columns({k: (v.shape, v.dtype) for k, v in cols.items()}, ledger_tier=ledger_tier)
        try:
            for k, v in cols.items():
                pending.columns[k][...] = v
            return pending.seal()
        finally:
            pending.abort()

    def put_bytes(self, data: bytes) -> ObjectRef:
        return self.put_columns({"__bytes__": np.frombuffer(data, np.uint8)})

    # -- read path ----------------------------------------------------------

    def get_columns(self, ref: ObjectRef, populate: bool = False) -> ColumnBatch:
        """Zero-copy views of a ref's segment (its row window, if any),
        mapped populated if asked (:func:`map_segment_file`). A foreign ref
        whose segment is not in this host's directories is pulled from its
        owner once (just its window) into a cache segment, which later
        reads map. A missing segment, or a foreign one whose owner cannot be
        reached, raises :class:`ObjectLostError`, one that is not a segment
        :class:`ObjectCorruptError`; both carry the object's id, which the
        shuffle's lineage re-makes. The ``store.get`` fault site fires
        ``lost`` and ``corrupt`` here."""
        faults = _transport.faults()
        if faults.enabled():
            kind = faults.should_fire("store.get")
            if kind == "lost":
                raise ObjectLostError(ref.object_id, "injected fault")
            if kind == "corrupt":
                raise ObjectCorruptError(ref.object_id, "injected fault")
        path = self._find_segment(ref.object_id)
        rows = ref.rows
        if path is None and self.is_foreign(ref):
            with self._pulling_lock:
                pull = self._pulling.get(self._cache_name(ref))
            if pull is not None:
                import concurrent.futures

                concurrent.futures.wait([pull])
            cache = self._find_cache(ref)
            if cache is None:
                cache = self._cache_path(ref)
                self._materialize_remote(ref, cache)
            path, rows = cache, None  # the cache holds just the window
        try:
            if path is None:
                raise FileNotFoundError(ref.object_id)
            batch = map_segment_file(path, ref.object_id, populate)
        except FileNotFoundError:
            raise ObjectLostError(ref.object_id, "no segment") from None
        except ValueError as exc:
            raise ObjectCorruptError(ref.object_id, str(exc)) from exc
        # The capacity ledger's last read of the segment: the ref's own id
        # (a foreign read warms the owner's segment) and, where it differs,
        # the cache segment's here.
        _ledger_touch(ref.object_id)
        base = os.path.basename(path)
        if base != ref.object_id:
            _ledger_touch(base)
        if rows is not None:
            batch = batch.slice(*rows)
        return batch

    def get_bytes(self, ref: ObjectRef) -> bytes:
        return self.get_columns(ref)["__bytes__"].tobytes()

    # -- foreign refs ---------------------------------------------------------

    def is_foreign(self, ref: ObjectRef) -> bool:
        """Was the ref made on another host of the cluster?"""
        return ref.owner is not None and tuple(ref.owner) != self.owner_address and self.remote_fetch is not None

    def needs_fetch(self, ref: ObjectRef) -> bool:
        """Would reading the ref now pull bytes from another host: foreign,
        not cached here, and its segment not in this host's directories
        (two sessions sharing one shm directory map each other's)? The
        overlapped reduce's ``auto`` asks this."""
        return self.is_foreign(ref) and self._find_cache(ref) is None and self._find_segment(ref.object_id) is None

    def _cache_name(self, ref: ObjectRef) -> str:
        # The READER session's prefix: every process of the session names
        # a cache alike, and the session's cleanup sweeps it.
        name = f"{self.session}-cache-{ref.object_id}"
        if ref.rows is not None:
            name = f"{name}+w{ref.rows[0]}-{ref.rows[1]}"
        return name

    def _cache_path(self, ref: ObjectRef) -> str:
        """Where a new cache goes, by the budget (``ref.nbytes``, the whole
        segment's size, errs high for a window)."""
        return os.path.join(self._placement_dir(ref.nbytes), self._cache_name(ref))

    def _find_cache(self, ref: ObjectRef) -> Optional[str]:
        name = self._cache_name(ref)
        for directory in (self.shm_dir, self.spill_dir):
            path = os.path.join(directory, name)
            if os.path.exists(path):
                return path
        return None

    def prefetch(self, refs, max_parallel: Optional[int] = None) -> List:
        """Start pulling the foreign refs among ``refs`` that need it into
        their caches on background threads (``max_parallel`` at once,
        default :func:`fetch_window_depth` of 8); returns the futures at
        once. The pool widens to the widest caller. A prefetch asked for
        a ref supersedes its freed mark. Errors are dropped here: the
        reading ``get_columns`` fetches again and raises."""
        foreign = [
            r for r in refs
            if isinstance(r, ObjectRef) and self.is_foreign(r) and self._find_cache(r) is None
            and self._find_segment(r.object_id) is None
        ]
        if not foreign:
            return []
        for ref in foreign:
            self._freed_caches.discard(self._cache_name(ref))
        if max_parallel is None:
            max_parallel = fetch_window_depth(default=8)
        pool = self._prefetch_pool.ensure(max_parallel)

        def _pull(ref: ObjectRef) -> None:
            try:
                _pull_once(ref)
            finally:
                # Under the lock: the submitter registers this pull first.
                with self._pulling_lock:
                    self._pulling.pop(self._cache_name(ref), None)

        def _pull_once(ref: ObjectRef) -> None:
            name = self._cache_name(ref)
            if name in self._freed_caches or self._find_cache(ref) is not None:
                return
            try:
                self._materialize_remote(ref, self._cache_path(ref))
            except Exception:
                return
            if name in self._freed_caches:
                # Freed while in flight: reclaim the orphaned copy.
                cache = self._find_cache(ref)
                if cache is not None:
                    try:
                        os.unlink(cache)
                    except FileNotFoundError:
                        pass
                    _ledger_note("delete", name)
                self._foreign.discard(name)

        futures = []
        with self._pulling_lock:
            for ref in foreign:
                name = self._cache_name(ref)
                if name not in self._pulling:
                    self._pulling[name] = pool.submit(_pull, ref)
                    futures.append(self._pulling[name])
        return futures

    def _materialize_remote(self, ref: ObjectRef, path: str) -> None:
        """Pull a foreign ref's window from its owner and publish it at
        ``path``: with ``RSDL_TCP_ZEROCOPY``, landed by ``recv_into`` in
        the mapped destination (striped with ``RSDL_TCP_STREAMS``), else
        as one bytes reply written out. Racing readers each write a tmp
        file of their own; the renames publish the same bytes."""
        t0 = time.perf_counter() if _metrics.enabled() else None
        tmp = f"{path}.fetch-{os.getpid()}-{secrets.token_hex(4)}"
        zerocopy = self.remote_fetch_into is not None and _transport.zerocopy_enabled()
        nbytes = 0
        if zerocopy:
            holder: Dict[str, mmap.mmap] = {}

            def _alloc(n: int):
                nonlocal nbytes
                nbytes = n
                fd = os.open(tmp, os.O_CREAT | os.O_EXCL | os.O_RDWR, 0o600)
                try:
                    os.ftruncate(fd, max(n, 1))
                    # Populated: the socket then writes into present pages
                    # instead of faulting each one in.
                    flags = mmap.MAP_SHARED | getattr(mmap, "MAP_POPULATE", 0)
                    mm = mmap.mmap(fd, max(n, 1), flags=flags)
                finally:
                    os.close(fd)
                holder["mm"] = mm
                return mm

            try:
                self.remote_fetch_into(ref, _alloc)
            except BaseException:
                try:
                    os.unlink(tmp)
                except FileNotFoundError:
                    pass
                raise
            finally:
                mm = holder.pop("mm", None)
                if mm is not None:
                    try:
                        mm.close()
                    except BufferError:
                        # A view still exported must not replace the fetch's
                        # own error; the mapping closes when it goes.
                        pass
        else:
            data = self.remote_fetch(ref)
            nbytes = len(data)
            with open(tmp, "wb") as f:
                f.write(data)
        os.rename(tmp, path)
        self._foreign.add(os.path.basename(path))
        _ledger_note("fetch", os.path.basename(path), nbytes, self.tier_of(path))
        if t0 is not None:
            # One window's latency and bytes, labelled with the framing
            # that served it and its striped streams (1 without zero-copy).
            try:
                zc = "1" if zerocopy else "0"
                streams = str(_transport.tcp_streams()) if zerocopy else "1"
                _metrics.registry.histogram("store.fetch_window_seconds", zerocopy=zc, streams=streams).observe(
                    time.perf_counter() - t0
                )
                _metrics.registry.counter("store.fetch_window_bytes", zerocopy=zc, streams=streams).inc(float(nbytes))
            except Exception:
                pass

    def _forget_cache(self, ref: ObjectRef) -> None:
        """Mark ``ref``'s cache freed (a late prefetch discards its copy)
        and unlink it."""
        if len(self._freed_caches) > 8192:
            self._freed_caches.clear()
        name = self._cache_name(ref)
        self._freed_caches.add(name)
        cache = self._find_cache(ref)
        if cache is not None:
            try:
                os.unlink(cache)
            except FileNotFoundError:
                pass
            _ledger_note("delete", name)
        self._foreign.discard(name)

    def drop_cache(self, refs) -> None:
        """Unlink this host's fetched copies of the foreign refs among
        ``refs``; the owners' segments stay, so the task that read them
        can run again (unlike :meth:`free`)."""
        if isinstance(refs, ObjectRef):
            refs = [refs]
        for ref in refs:
            if self.is_foreign(ref):
                self._forget_cache(ref)

    def exists(self, ref: ObjectRef) -> bool:
        """Is the ref's segment still published? A ref of another session
        (a preempted run's, re-attached on resume) resolves like one of
        this session's."""
        return self._find_segment(ref.object_id) is not None

    def free(self, refs) -> None:
        """Unlink each ref's link; of a foreign ref, also the cache here, the
        owner's link (through ``remote_free``) and a copy of its segment in
        this host's directories (re-homed by a drain). Mapped views stay
        valid until they are dropped; a segment's pages go with its last
        link."""
        if isinstance(refs, ObjectRef):
            refs = [refs]
        for ref in refs:
            if self.is_foreign(ref):
                self._forget_cache(ref)
                if self.remote_free is not None:
                    self.remote_free(ref)
                # A copy a drain re-homed here goes with it (elastic.py).
            path = self._find_segment(ref.object_id)
            if path is not None:
                try:
                    os.unlink(path)
                except FileNotFoundError:
                    pass
                _ledger_note("delete", ref.object_id)

    # -- tier moves (the elastic evictor's actuators) ----------------------------

    def _segment_links(self, ids) -> Dict[str, str]:
        """``{name: path}`` of every link name of one segment that resolves
        now (shm first, then spill)."""
        if isinstance(ids, str):
            ids = [ids]
        out: Dict[str, str] = {}
        for name in ids:
            path = self._find_segment(name)
            if path is not None:
                out[name] = path
        return out

    def _move_tier(self, ids, dst_dir: str, tier: str) -> int:
        """Move every link name of one segment to ``dst_dir``: copy the
        inode once under a ``.tmp`` name, rename it to the first name,
        hardlink the others to it, then unlink the sources. A reader racing
        the move still maps the old inode (its mapping outlives the unlink)
        or resolves the name again through :meth:`_find_segment`, which
        looks in both tiers. A failed link rolls the whole move back.
        Returns the bytes moved: 0 when the segment is gone or already lies
        in ``dst_dir``."""
        links = self._segment_links(ids)
        if not links:
            return 0
        if os.path.dirname(next(iter(links.values()))) == dst_dir:
            return 0
        os.makedirs(dst_dir, exist_ok=True)
        names = list(links)
        primary = names[0]
        # ".tmp": a crashed move leaves nothing that store_stats or a
        # drain's list_segments would take for a published segment.
        tmp = os.path.join(dst_dir, f"{primary}.move-{os.getpid()}-{secrets.token_hex(4)}.tmp")
        try:
            nbytes = os.path.getsize(links[primary])
            with open(links[primary], "rb") as src, open(tmp, "wb") as dst:
                import shutil

                shutil.copyfileobj(src, dst, length=1 << 20)
            os.rename(tmp, os.path.join(dst_dir, primary))
        except OSError:
            try:
                os.unlink(tmp)
            except FileNotFoundError:
                pass
            return 0
        for i, name in enumerate(names[1:], start=1):
            try:
                os.link(os.path.join(dst_dir, primary), os.path.join(dst_dir, name))
            except FileExistsError:
                pass
            except OSError:
                for done in names[: i + 1]:
                    try:
                        os.unlink(os.path.join(dst_dir, done))
                    except FileNotFoundError:
                        pass
                return 0
        for path in links.values():
            try:
                os.unlink(path)
            except FileNotFoundError:
                pass
        # The residency estimate between scans: a demotion frees budgeted
        # shm at once, a promotion fills it (else a burst of promotes inside
        # the scan window would each see the residency before the burst).
        if tier == "spill":
            self._scan_adjust -= nbytes
        else:
            self._scan_adjust += nbytes
        _ledger_note("transition", primary, nbytes, tier)
        _metrics.safe_inc("store.tier_moved_bytes_total", float(nbytes), tier=tier)
        return nbytes

    def demote(self, ids) -> int:
        """Move one segment (every hardlinked name in ``ids``) from shm to
        the spill directory, where it stays readable in place; the ledger
        notes the ``transition``. Returns the bytes moved."""
        return self._move_tier(ids, self.spill_dir, "spill")

    def promote(self, ids) -> int:
        """Move a spilled segment back to shm, only when it fits the
        session's budget: a promote must not make the pressure the evictor
        relieves. Returns the bytes moved."""
        links = self._segment_links(ids)
        if not links:
            return 0
        try:
            nbytes = os.path.getsize(next(iter(links.values())))
        except OSError:
            return 0
        if self.capacity_bytes is not None and nbytes + self._shm_session_bytes() > self.capacity_bytes:
            return 0
        return self._move_tier(ids, self.shm_dir, "shm")

    def drop_segments(self, ids) -> int:
        """Unlink one segment (every link name) from whichever tier holds
        it, noting a ``delete`` for each name: a later read raises
        :class:`ObjectLostError`, which the shuffle's lineage re-makes.
        Returns the bytes dropped."""
        links = self._segment_links(ids)
        if not links:
            return 0
        nbytes = 0
        try:
            nbytes = os.path.getsize(next(iter(links.values())))
        except OSError:
            pass
        for name, path in links.items():
            try:
                os.unlink(path)
            except FileNotFoundError:
                pass
            _ledger_note("delete", name)
        return nbytes

    def store_stats(self) -> StoreStats:
        stats = StoreStats()
        seen = set()
        for directory, spilled in ((self.shm_dir, False), (self.spill_dir, True)):
            for _, st in self._session_files(directory):
                stats.num_objects += 1
                if st.st_ino not in seen:
                    seen.add(st.st_ino)
                    stats.total_bytes += st.st_size
                    if spilled:
                        stats.spill_bytes += st.st_size
        return stats

    def cleanup(self, session: Optional[str] = None, keep: Sequence[str] = ()) -> None:
        """Unlink every segment of ``session`` (default: this one) in both
        directories, unfinished ones included, except the object ids in
        ``keep``. Sweeping an adopted session ends its adoption."""
        own = session is None or session == self.session
        session = self.session if session is None else session
        keep = set(keep)
        if own and not keep:
            # The capacity ledger's blanket op: everything live goes.
            _ledger_note("cleanup", session)
        for directory in (self.shm_dir, self.spill_dir):
            for name, _ in list(self._session_files(directory, unfinished=True, sessions=[session])):
                if name in keep:
                    continue
                try:
                    os.unlink(os.path.join(directory, name))
                except FileNotFoundError:
                    pass
                if not own or keep:
                    # One delete a name: sweeping another session leaves
                    # this one's fold alone, and a kept segment stays live.
                    _ledger_note("delete", name)
        adopted = self.adopted_sessions()
        if session in adopted and self._sessions_file is not None:
            with open(self._sessions_file, "w") as f:
                f.writelines(s + "\n" for s in adopted if s != session)
        if session == self.session:
            self._foreign.clear()
