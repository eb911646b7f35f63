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

This module imports numpy only: the spawned task workers load it.
"""

from __future__ import annotations

import errno
import json
import mmap
import os
import secrets
import struct
from collections.abc import Mapping
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

_MAGIC = b"RSDL1\x00"
_ALIGN = 64
_HEADER = struct.Struct("<6sI")  # magic, meta length


def _default_shm_dir() -> str:
    """``$RSDL_SHM_DIR``, else ``/dev/shm``, else the temp dir."""
    d = os.environ.get("RSDL_SHM_DIR")
    if d:
        return d
    if os.path.isdir("/dev/shm"):
        return "/dev/shm"
    import tempfile

    return tempfile.gettempdir()


def _align(n: int) -> int:
    return (n + _ALIGN - 1) // _ALIGN * _ALIGN


def _plan_layout(spec: Mapping[str, Tuple[Tuple[int, ...], np.dtype]]):
    """The one definition of the segment format for a ``{name: (shape,
    dtype)}`` spec: ``(per-column meta, meta blob, payload start, total
    bytes)``."""
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
    meta_blob = json.dumps({"columns": meta}).encode()
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
    """A small picklable handle to a segment. ``rows`` restricts it to a
    half-open row window: several refs may hardlink one segment (the map
    stage publishes its per-reducer partitions so), each ref owning its own
    link; the pages are reclaimed when the last link is freed."""

    object_id: str
    nbytes: int
    session: str = ""
    rows: Optional[Tuple[int, int]] = None


class ColumnBatch(Mapping):
    """Named equal-length numpy columns (``Mapping[str, np.ndarray]``),
    plain arrays or zero-copy views of a mapped segment, which the batch
    keeps alive."""

    def __init__(self, columns: Dict[str, np.ndarray], _keepalive=None):
        self._columns = columns
        self._keepalive = _keepalive
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
        """Zero-copy row slice (the mapping stays alive with it)."""
        return ColumnBatch({k: v[start:stop] for k, v in self._columns.items()}, _keepalive=self._keepalive)

    @staticmethod
    def concat(batches: Sequence[Optional["ColumnBatch"]]) -> "ColumnBatch":
        batches = [b for b in batches if b is not None and b.num_rows > 0]
        if not batches:
            return ColumnBatch({})
        if len(batches) == 1:
            return batches[0]
        return ColumnBatch({k: np.concatenate([b[k] for b in batches]) for k in batches[0]})

    @staticmethod
    def concat_take(batches: Sequence["ColumnBatch"], indices: np.ndarray, out: Dict[str, np.ndarray]) -> None:
        """``concat(batches).take(indices)`` into the preallocated ``out``
        views (a segment's): the reduce stage's gather."""
        batches = [b for b in batches if b.num_rows > 0]
        if batches:
            for k, dst in out.items():
                np.take(np.concatenate([b[k] for b in batches]), indices, axis=0, out=dst)


class PendingColumns:
    """An allocated, unpublished segment with writable column views, from
    :meth:`ObjectStore.create_columns`. Fill the views, then :meth:`seal`
    (one ref) or :meth:`publish_slices` (one hardlinked ref per row
    window); :meth:`abort` reclaims it and is a no-op after a publish."""

    def __init__(self, store: "ObjectStore", object_id: str, tmp_path: str, path: str, nbytes: int, mm, views):
        self._store = store
        self.object_id = object_id
        self._tmp = tmp_path
        self._path = path
        self.nbytes = nbytes
        self._mm = mm
        self.columns: Dict[str, np.ndarray] = views
        self._published = False

    def seal(self) -> ObjectRef:
        assert not self._published, "already published"
        os.rename(self._tmp, self._path)
        self._published = True
        return ObjectRef(self.object_id, self.nbytes, self._store.session)

    def publish_slices(self, windows: Sequence[Tuple[int, int]]) -> List[ObjectRef]:
        assert not self._published, "already published"
        refs: List[ObjectRef] = []
        try:
            for start, stop in windows:
                link_id = self._store._new_object_id()
                os.link(self._tmp, os.path.join(self._store.shm_dir, link_id))
                refs.append(ObjectRef(link_id, self.nbytes, self._store.session, (int(start), int(stop))))
        except BaseException:
            for ref in refs:  # no caller ever sees these links
                try:
                    os.unlink(os.path.join(self._store.shm_dir, ref.object_id))
                except FileNotFoundError:
                    pass
            raise
        os.unlink(self._tmp)
        self._published = True
        return refs

    def abort(self) -> None:
        if not self._published:
            try:
                os.unlink(self._tmp)
            except FileNotFoundError:
                pass
            self._published = True


def map_segment_file(path: str, object_id: str = "?") -> ColumnBatch:
    """mmap a published segment file into zero-copy column views."""
    fd = os.open(path, os.O_RDONLY)
    try:
        mm = mmap.mmap(fd, os.fstat(fd).st_size, prot=mmap.PROT_READ)
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
    return ColumnBatch(cols, _keepalive=mm)


def serialize_columns(columns: Mapping[str, np.ndarray]) -> bytes:
    """The segment format of ``columns`` as bytes: what
    :func:`map_segment_file` reads back."""
    cols = {k: np.ascontiguousarray(v) for k, v in columns.items()}
    meta, meta_blob, payload_start, total = _plan_layout({k: (v.shape, v.dtype) for k, v in cols.items()})
    out = bytearray(total)
    out[: _HEADER.size] = _HEADER.pack(_MAGIC, len(meta_blob))
    out[_HEADER.size : _HEADER.size + len(meta_blob)] = meta_blob
    view = np.frombuffer(out, dtype=np.uint8)
    for m, arr in zip(meta, cols.values()):
        start = payload_start + m["offset"]
        view[start : start + arr.nbytes] = arr.reshape(-1).view(np.uint8)
    return bytes(out)


@dataclass
class StoreStats:
    """One session's residency: objects (every ref, hardlinks included) and
    bytes (once per physical segment)."""

    num_objects: int = 0
    total_bytes: int = 0


class ObjectStore:
    """The session's store over one shared-memory directory."""

    def __init__(self, session: str, shm_dir: Optional[str] = None):
        self.session = session
        self.shm_dir = shm_dir or _default_shm_dir()
        os.makedirs(self.shm_dir, exist_ok=True)

    def _new_object_id(self) -> str:
        return f"{self.session}-{secrets.token_hex(8)}"

    def _path(self, object_id: str) -> str:
        return os.path.join(self.shm_dir, object_id)

    # -- write path ---------------------------------------------------------

    def create_columns(self, spec: Mapping[str, Tuple[Tuple[int, ...], np.dtype]]) -> PendingColumns:
        """Allocate a segment for ``{name: (shape, dtype)}`` and return its
        writable views. The pages are reserved up front: a segment that does
        not fit raises :class:`StoreFullError` here, not a bus error when a
        view is written."""
        meta, meta_blob, payload_start, total = _plan_layout(spec)
        object_id = self._new_object_id()
        path = self._path(object_id)
        tmp = path + ".tmp"
        fd = os.open(tmp, os.O_CREAT | os.O_EXCL | os.O_RDWR, 0o600)
        try:
            try:
                os.posix_fallocate(fd, 0, max(total, 1))
            except OSError as exc:
                os.unlink(tmp)
                if exc.errno in (errno.ENOSPC, errno.EFBIG):
                    raise StoreFullError(self.shm_dir, total, free_bytes(self.shm_dir)) from exc
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
        return PendingColumns(self, object_id, tmp, path, total, mm, views)

    def put_columns(self, columns: Mapping[str, np.ndarray]) -> ObjectRef:
        """Write a columnar batch as one segment; returns its ref."""
        cols = {k: np.ascontiguousarray(v) for k, v in columns.items()}
        pending = self.create_columns({k: (v.shape, v.dtype) for k, v in cols.items()})
        try:
            for k, v in cols.items():
                pending.columns[k][...] = v
            return pending.seal()
        finally:
            pending.abort()

    # -- read path ----------------------------------------------------------

    def get_columns(self, ref: ObjectRef) -> ColumnBatch:
        """Zero-copy views of a ref's segment (its row window, if any). A
        missing segment raises :class:`ObjectLostError`."""
        try:
            batch = map_segment_file(self._path(ref.object_id), ref.object_id)
        except FileNotFoundError:
            raise ObjectLostError(ref.object_id, "no segment") from None
        if ref.rows is not None:
            batch = batch.slice(*ref.rows)
        return batch

    def exists(self, ref: ObjectRef) -> bool:
        return os.path.exists(self._path(ref.object_id))

    def free(self, refs) -> None:
        """Unlink each ref's link. Mapped views stay valid until they are
        dropped; a segment's pages go with its last link."""
        if isinstance(refs, ObjectRef):
            refs = [refs]
        for ref in refs:
            try:
                os.unlink(self._path(ref.object_id))
            except FileNotFoundError:
                pass

    def store_stats(self) -> StoreStats:
        stats = StoreStats()
        prefix = f"{self.session}-"
        seen = set()
        try:
            names = os.listdir(self.shm_dir)
        except FileNotFoundError:
            return stats
        for name in names:
            if name.startswith(prefix) and not name.endswith(".tmp"):
                try:
                    st = os.stat(self._path(name))
                except FileNotFoundError:
                    continue
                stats.num_objects += 1
                if st.st_ino not in seen:
                    seen.add(st.st_ino)
                    stats.total_bytes += st.st_size
        return stats

    def cleanup(self) -> None:
        """Unlink every segment of this session, unfinished ones included."""
        prefix = f"{self.session}-"
        try:
            names = os.listdir(self.shm_dir)
        except FileNotFoundError:
            return
        for name in names:
            if name.startswith(prefix):
                try:
                    os.unlink(self._path(name))
                except FileNotFoundError:
                    pass
