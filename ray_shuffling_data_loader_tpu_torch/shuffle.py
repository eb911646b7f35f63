"""The per-epoch shuffle over Parquet files, and its delivery to a
:class:`BatchConsumer`.

For every epoch (the *mapreduce* schedule):

* each **map** task decodes one file, draws every row's reducer from a
  generator seeded by ``(seed, epoch, file_index)`` and groups the rows by
  reducer, stably (rows keep their file order within a reducer);
* each **reduce** task concatenates its partitions in file order and
  applies a permutation seeded by ``(seed, epoch, reducer)``;
* reducers are split into contiguous runs per trainer rank
  (``np.array_split``) and each rank receives its reducers' outputs in
  reducer order.

Maps and reduces run in the session's spawned worker pool. A map writes
its grouped rows into one shared-memory store segment and returns one
row-window ref per reducer; a reduce reads its windows by ref and writes
its permuted rows into a segment of its own, whose ref the shuffle hands
to the rank's consumer. Bulk data never passes through a pipe.

Three defaults change how, never what, an epoch delivers:

* **Decode cache** (``cache_decoded=None`` resolves through
  :func:`_decode_cache_auto`): the first epoch's maps also keep each
  file's decoded columns in a segment, and later maps partition from it
  instead of Parquet. The segments are freed when the run ends or fails.
* **Index schedule** (``RSDL_INDEX_SHUFFLE=auto|on|off``, decided per
  epoch by :func:`_index_schedule_allowed`): once every file is cached,
  a :func:`shuffle_plan` per file groups row *indices* by reducer, and a
  :func:`shuffle_gather_reduce` per reducer gathers its rows straight from
  the cached segments.
* **Packed outputs** (a consumer's ``device_layout``, unless
  ``RSDL_DEVICE_DIRECT=off``): a reducer that knows where its rows start
  in its rank's stream writes the whole batches of its interval as one
  packed segment in staging layout, between a head and a tail of plain
  columns (:class:`_PackedOutput`).

Given the same files, seed and reducer count, the row stream is the one
the JAX package's shuffle delivers under its default settings: the seeds,
the draws and the group-by order are the same, whichever schedule and
output form an epoch takes.

**Journal** (``RSDL_JOURNAL`` or ``shuffle(resume_from=)``,
:mod:`.runtime.journal`): the run's epoch window is journaled at the
barriers, and a later run resumes it: completed epochs skipped, stage
results re-attached while their segments survive (else run again from
the seed), the delivery cursor honoured. Off, the journal module is not
even imported.

A ``stats_collector`` (a :class:`~.stats.TrialStatsCollector` actor's
handle) hears, as the JAX package's does, each epoch's start and
admission wait, each task's start and duration, and each reducer output
delivered to a rank, and the run's end.

The device-resident loader's decode task, :func:`_decode_narrow_to_store`,
lives here too, so that the workers never import torch.

This module imports numpy and pyarrow only: the workers load it.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from ray_shuffling_data_loader_tpu_torch import runtime
from ray_shuffling_data_loader_tpu_torch.runtime import ColumnBatch, ObjectRef
from ray_shuffling_data_loader_tpu_torch.runtime.store import DEVICE_BATCH_KIND, PACKED_COLUMN

_INT32 = np.iinfo(np.int32)


class BatchConsumer:
    """What the shuffle delivers to: each reducer's output refs, in
    reducer order per rank, and the end of each rank's epoch."""

    def consume(self, rank: int, epoch: int, batches: List[ObjectRef]) -> None:
        """Take one reducer's output refs (one columnar segment, or a
        packed output's head, body and tail in delivery order)."""
        raise NotImplementedError

    def producer_done(self, rank: int, epoch: int) -> None:
        """Every batch of ``(epoch, rank)`` has been produced."""
        raise NotImplementedError

    def wait_until_ready(self, epoch: int) -> None:
        """Block until the consumer can admit ``epoch``."""
        raise NotImplementedError

    def wait_until_all_epochs_done(self) -> None:
        """Block until every batch of every epoch has been consumed."""
        raise NotImplementedError


def read_parquet_columns(
    filename: str, columns: Optional[Sequence[str]] = None, use_threads: bool = False
) -> ColumnBatch:
    """Decode a local Parquet file to contiguous numpy columns.

    ``columns``: decode only these (None: all); a name the file lacks
    raises Arrow's ``ArrowInvalid``, a ``ValueError``. ``use_threads``: let
    Arrow decode with its own threads. Off by default: the worker pool
    decodes one file per worker, and Arrow's threads on top of that
    oversubscribe a busy host."""
    import pyarrow.parquet as pq

    table = pq.read_table(
        filename, columns=None if columns is None else list(columns), use_threads=use_threads, memory_map=True
    )
    return ColumnBatch(
        {
            name: np.ascontiguousarray(col.to_numpy(zero_copy_only=False))
            for name, col in zip(table.column_names, table.columns)
        }
    )


def _arrow_decode_threads(stage_tasks: int) -> bool:
    """Should this worker's decode use Arrow's threads? Yes when the host
    has at least twice as many cores as the stage runs decodes at once
    (``min(stage_tasks, cores)``); Arrow's pool is then capped to this
    decode's share of the cores. Decided in the worker, from its own
    host's cores."""
    cores = os.cpu_count() or 1
    concurrent = min(max(1, stage_tasks), cores)
    if cores < 2 * concurrent:
        return False
    import pyarrow as pa

    pa.set_cpu_count(max(2, cores // concurrent))
    return True


def _decode_narrow_to_store(filename: str, columns: Sequence[str], stage_tasks: int = 0) -> ObjectRef:
    """Pool task of the device-resident loader's staging: decode
    ``columns`` of one file, narrow 64-bit columns to 32 bits and put them
    in the store. Returns the ref. ``stage_tasks``: the decodes the stage
    runs at once, from which the worker decides on Arrow's threads."""
    batch = read_parquet_columns(
        filename, columns=columns, use_threads=stage_tasks > 0 and _arrow_decode_threads(stage_tasks)
    )
    cols = {name: _narrow_column(name, batch.columns[name]) for name in columns}
    return runtime.ensure_initialized().store.put_columns(cols)


def narrowed_dtype(dtype) -> np.dtype:
    """The 32-bit dtype a column has after decode narrowing."""
    dtype = np.dtype(dtype)
    if dtype == np.int64:
        return np.dtype(np.int32)
    if dtype == np.float64:
        return np.dtype(np.float32)
    return dtype


def _narrow_column(name: str, v: np.ndarray) -> np.ndarray:
    """int64 -> int32, refusing values outside int32's range; float64 ->
    float32 (lossy by design)."""
    if v.dtype == np.int64:
        if v.size and (v.min() < _INT32.min or v.max() > _INT32.max):
            raise ValueError(
                f"narrow_to_32: column {name!r} has values outside int32 "
                "range; disable narrowing for this dataset"
            )
        return v.astype(np.int32)
    if v.dtype == np.float64:
        return v.astype(np.float32)
    return v


def _map_seed(seed: int, epoch: int, file_index: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence(entropy=seed, spawn_key=(0, epoch, file_index))
    )


def _reduce_seed(seed: int, epoch: int, reducer: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence(entropy=seed, spawn_key=(1, epoch, reducer))
    )


def shuffle_plan_spec() -> Tuple[str, int]:
    """``RSDL_SHUFFLE_PLAN`` parsed as the JAX package parses it:
    ``("rowwise", 0)`` when unset or ``rowwise``, ``("block", G)`` for
    ``block`` (G = 1) or ``block:G``; anything else raises ``ValueError``."""
    env = os.environ.get("RSDL_SHUFFLE_PLAN", "").strip().lower()
    if env in ("", "rowwise", "row", "off"):
        return ("rowwise", 0)
    if env == "block":
        return ("block", 1)
    if env.startswith("block:"):
        try:
            g = int(env.split(":", 1)[1])
        except ValueError:
            g = 0
        if g >= 1:
            return ("block", g)
    raise ValueError(
        f"RSDL_SHUFFLE_PLAN={env!r}: expected 'rowwise', 'block', or 'block:<G>' with integer G >= 1"
    )


def shuffle_plan_label() -> str:
    """The plan as the JAX package labels it (``rowwise`` or ``block:G``):
    part of a checkpoint cursor's and a journal run's stream identity."""
    family, g = shuffle_plan_spec()
    return family if family == "rowwise" else f"block:{g}"


def check_shuffle_plan() -> None:
    """Only the rowwise plan family is ported: ``RSDL_SHUFFLE_PLAN`` unset
    or ``rowwise`` passes, ``block[:G]`` raises ``NotImplementedError``,
    anything else ``ValueError``."""
    if shuffle_plan_spec()[0] == "block":
        raise NotImplementedError(
            f"RSDL_SHUFFLE_PLAN={shuffle_plan_label()!r}: the block plan family is not ported yet; only 'rowwise' is"
        )


def _file_assignment(
    seed: int, epoch: int, file_index: int, n: int, num_reducers: int
) -> np.ndarray:
    """Each row's reducer for one file: an independent seeded draw per row
    (the rowwise plan family)."""
    return _map_seed(seed, epoch, file_index).integers(num_reducers, size=n)


def _group_order(assignment: np.ndarray, num_reducers: int) -> Tuple[np.ndarray, np.ndarray]:
    """``(order, offsets)`` of a stable group-by: ``order`` lists row
    indices reducer by reducer, each reducer's rows in file order;
    reducer ``r`` owns ``order[offsets[r]:offsets[r + 1]]``."""
    # Narrow keys let numpy's stable sort take its radix path.
    key_dtype = np.uint8 if num_reducers <= 256 else np.uint16 if num_reducers <= 65536 else np.int64
    order = np.argsort(assignment.astype(key_dtype), kind="stable")
    offsets = np.zeros(num_reducers + 1, dtype=np.int64)
    np.cumsum(np.bincount(assignment, minlength=num_reducers), out=offsets[1:])
    return order, offsets


def shuffle_map(
    filename: str,
    file_index: int,
    num_reducers: int,
    epoch: int,
    seed: int,
    narrow_to_32: bool = False,
    cache_ref: Optional[ObjectRef] = None,
    publish_cache: bool = False,
    stats_collector=None,
):
    """Decode one file and group its rows by reducer straight into one
    store segment; returns one row-window ref per reducer (empty windows
    included when the file has few rows).

    ``cache_ref``: take the rows from this decode-cache segment instead of
    Parquet. ``publish_cache``: also write the decoded (and narrowed)
    columns once to a segment of their own and return ``(refs,
    cache_ref)``; a publish that does not fit returns a None cache ref,
    and the file is decoded again in later epochs."""
    if stats_collector is not None:
        stats_collector.call_oneway("map_start", epoch)
    start = time.perf_counter()
    store = runtime.ensure_initialized().store
    new_cache_ref = None
    if cache_ref is not None:
        batch = store.get_columns(cache_ref)
    else:
        batch = read_parquet_columns(filename)
        if narrow_to_32:
            batch = ColumnBatch({k: _narrow_column(k, v) for k, v in batch.columns.items()})
        if publish_cache:
            try:
                new_cache_ref = store.put_columns(batch.columns)
            except OSError:
                new_cache_ref = None
    end_read = time.perf_counter()
    assignment = _file_assignment(seed, epoch, file_index, batch.num_rows, num_reducers)
    order, offsets = _group_order(assignment, num_reducers)
    try:
        pending = store.create_columns({k: (v.shape, v.dtype) for k, v in batch.columns.items()})
        try:
            for k, v in batch.columns.items():
                np.take(v, order, axis=0, out=pending.columns[k])
            refs = pending.publish_slices(
                [(int(offsets[r]), int(offsets[r + 1])) for r in range(num_reducers)]
            )
        finally:
            pending.abort()  # reclaims the segment if anything above raised
    except BaseException:
        if new_cache_ref is not None:
            store.free(new_cache_ref)  # no caller will learn of it
        raise
    if stats_collector is not None:
        stats_collector.call_oneway("map_done", epoch, time.perf_counter() - start, end_read - start)
    return (refs, new_cache_ref) if publish_cache else refs


def shuffle_plan(
    file_index: int, num_reducers: int, epoch: int, seed: int, cache_ref: ObjectRef, stats_collector=None
) -> List[ObjectRef]:
    """The index schedule's map: the same seeded draw and stable grouping
    as :func:`shuffle_map`, over row indices only. Returns one ref per
    reducer over one ``{"idx"}`` segment: each reducer's row indices in the
    cached file, in file order, the rows the materialized map's partition
    would hold. Column data is not read."""
    if stats_collector is not None:
        stats_collector.call_oneway("map_start", epoch)
    start = time.perf_counter()
    store = runtime.ensure_initialized().store
    n = store.get_columns(cache_ref).num_rows
    end_read = time.perf_counter()
    assignment = _file_assignment(seed, epoch, file_index, n, num_reducers)
    order, offsets = _group_order(assignment, num_reducers)
    idx_dtype = np.int32 if n <= _INT32.max else np.int64
    pending = store.create_columns({"idx": ((n,), np.dtype(idx_dtype))})
    try:
        np.copyto(pending.columns["idx"], order, casting="same_kind")
        refs = pending.publish_slices(
            [(int(offsets[r]), int(offsets[r + 1])) for r in range(num_reducers)]
        )
    finally:
        pending.abort()
    if stats_collector is not None:
        stats_collector.call_oneway("map_done", epoch, time.perf_counter() - start, end_read - start)
    return refs


# -- packed outputs ------------------------------------------------------------
#
# A rank's batch grid is fixed: batch k covers rows [kB, (k+1)B) of the
# rank's stream. A reducer whose rows occupy [start, start + total) of that
# stream splits them into
#
#   head: rows [start, ceil(start / B) * B), the end of a batch that the
#         previous reducer began (plain columns);
#   body: the m whole batches inside the interval, as ONE segment of shape
#         [m, n_cols, B] int32, each batch a contiguous [n_cols, B] block
#         (float columns as bit patterns): what one host-to-device copy
#         stages, with no re-cut and no pack on the host;
#   tail: the rest, carried into the next reducer's first batch.
#
# The delivered stream is the one of columnar outputs: the grid is where
# the consumer's carry re-cut would have cut anyway.


class _PackedOutput:
    """The batch-aligned destination of one reduce task: head, body and
    tail segments over every column of the reducer's output, the
    requested staging columns first, so that the stream keeps the column
    set of columnar outputs."""

    def __init__(self, store, layout: dict, start: int, total: int, names: List[str],
                 col_dtypes: Dict[str, np.dtype]):
        self.B = B = int(layout["batch"])
        self.names = names = list(names)
        self.dtypes = [np.dtype(col_dtypes[n]) for n in names]
        self.ncols = len(names)
        self.total = int(total)
        self.h = h = min(total, (-int(start)) % B)
        self.m = m = (total - h) // B
        self.t = total - h - m * B
        self._store = store
        self._pendings: list = []
        # Three allocations in turn: if a later one fails, the earlier
        # unpublished segments are reclaimed here, as no caller holds this
        # object yet.
        try:
            self.head = self._remainder(h)
            descriptor = {
                "kind": DEVICE_BATCH_KIND,
                "batch": B,
                "columns": names,
                "dtypes": [d.str for d in self.dtypes],
            }
            self.body = store.create_columns({PACKED_COLUMN: ((m, self.ncols, B), np.dtype(np.int32))},
                                             layout=descriptor)
            self._pendings.append(self.body)
            self.mat = self.body.columns[PACKED_COLUMN]
            self.tail = self._remainder(self.t)
        except BaseException:
            self.abort()
            raise

    def _remainder(self, rows: int):
        if rows <= 0:
            return None
        pending = self._store.create_columns({n: ((rows,), d) for n, d in zip(self.names, self.dtypes)})
        self._pendings.append(pending)
        return pending

    def chunks(self):
        """``(lo, hi, {name: writable view})`` destinations of output rows
        ``[lo, hi)``, in output order. A body chunk's views are the rows of
        its block, bit-viewed back to the column dtypes."""
        if self.head is not None:
            yield 0, self.h, self.head.columns
        for b in range(self.m):
            lo = self.h + b * self.B
            yield lo, lo + self.B, {n: self.mat[b, i].view(dt) for i, (n, dt) in enumerate(zip(self.names, self.dtypes))}
        if self.tail is not None:
            yield self.h + self.m * self.B, self.total, self.tail.columns

    def seal(self) -> List[ObjectRef]:
        """Publish head, body and tail (those present) in delivery order."""
        return [p.seal() for p in (self.head, self.body, self.tail) if p is not None]

    def abort(self) -> None:
        for p in self._pendings:
            p.abort()


def _packed_output(store, pack, total: int, template) -> Optional[_PackedOutput]:
    """A :class:`_PackedOutput` when this reducer can pack: it was given
    ``pack = (rank-stream start, layout)``, every column is flat and 4 bytes
    wide, the requested columns exist, and the interval holds at least one
    whole aligned batch. Else None: the reducer writes one columnar segment
    (refs describe themselves, so a stream may mix both)."""
    if pack is None or total <= 0 or template is None:
        return None
    start, layout = pack
    try:
        B = int(layout["batch"])
        req = list(layout["columns"])
    except (KeyError, TypeError, ValueError):
        return None
    if B <= 0 or not req:
        return None
    all_names = list(template)
    if any(n not in all_names for n in req):
        return None
    names = req + [n for n in all_names if n not in req]
    col_dtypes: Dict[str, np.dtype] = {}
    for n in names:
        v = template[n]
        if v.dtype.itemsize != 4 or v.shape[1:] != ():
            return None
        col_dtypes[n] = v.dtype
    h = min(total, (-int(start)) % B)
    if (total - h) // B < 1:
        return None
    return _PackedOutput(store, layout, start, total, names, col_dtypes)


def _permuted_output(store, pack, template, source: Callable[[str], np.ndarray], perm: np.ndarray):
    """Write ``source(name)[perm]`` for every column of ``template``: into
    one columnar segment (returns its ref), or, when the reducer packs,
    into its head, body and tail (returns their refs)."""
    total = len(perm)
    packed = _packed_output(store, pack, total, template)
    if packed is None:
        pending = store.create_columns({k: ((total, *v.shape[1:]), v.dtype) for k, v in template.items()})
        try:
            for k, dst in pending.columns.items():
                np.take(source(k), perm, axis=0, out=dst)
            return pending.seal()
        finally:
            pending.abort()
    try:
        chunks = list(packed.chunks())
        for k in packed.names:
            src = source(k)
            for lo, hi, views in chunks:
                np.take(src, perm[lo:hi], out=views[k])
        return packed.seal()
    finally:
        packed.abort()


def shuffle_reduce(
    reduce_index: int, epoch: int, seed: int, part_refs: Sequence[ObjectRef], pack=None, stats_collector=None
) -> Union[ObjectRef, List[ObjectRef]]:
    """Concatenate this reducer's partitions in file order and permute them
    straight into the store; returns the output's ref, or with ``pack =
    (rank-stream start, layout)`` its head, body and tail refs
    (:class:`_PackedOutput`). The inputs stay: the epoch frees them once
    the result has landed."""
    if stats_collector is not None:
        stats_collector.call_oneway("reduce_start", epoch)
    start = time.perf_counter()
    store = runtime.ensure_initialized().store
    parts = [store.get_columns(r) for r in part_refs]
    perm = _reduce_seed(seed, epoch, reduce_index).permutation(sum(p.num_rows for p in parts))
    out = _permuted_output(store, pack, parts[0], lambda k: np.concatenate([p[k] for p in parts]), perm)
    if stats_collector is not None:
        stats_collector.call_oneway("reduce_done", epoch, time.perf_counter() - start)
    return out


def shuffle_gather_reduce(
    reduce_index: int,
    epoch: int,
    seed: int,
    idx_refs: Sequence[ObjectRef],
    cache_refs: Sequence[ObjectRef],
    pack=None,
    stats_collector=None,
) -> Union[ObjectRef, List[ObjectRef]]:
    """The index schedule's reduce: the same permutation as
    :func:`shuffle_reduce`, over rows gathered from the cached files
    (each file's index window, ascending, in file order), so the output is
    the materialized reducer's, bit for bit. Returns as
    :func:`shuffle_reduce` does."""
    if stats_collector is not None:
        stats_collector.call_oneway("reduce_start", epoch)
    start = time.perf_counter()
    store = runtime.ensure_initialized().store
    caches = [store.get_columns(r) for r in cache_refs]
    idx_parts = [store.get_columns(r)["idx"] for r in idx_refs]
    offsets = np.zeros(len(idx_parts) + 1, dtype=np.int64)
    np.cumsum([len(ix) for ix in idx_parts], out=offsets[1:])
    total = int(offsets[-1])
    perm = _reduce_seed(seed, epoch, reduce_index).permutation(total)
    template = caches[0]

    def source(k: str) -> np.ndarray:
        # One near-sequential take per file (its windows ascend), then the
        # permutation runs over this compact 1/R of the data.
        compact = np.empty((total, *template[k].shape[1:]), template[k].dtype)
        for i, (idx, cache) in enumerate(zip(idx_parts, caches)):
            np.take(cache[k], idx, axis=0, out=compact[offsets[i] : offsets[i + 1]])
        return compact

    out = _permuted_output(store, pack, template, source, perm)
    if stats_collector is not None:
        stats_collector.call_oneway("reduce_done", epoch, time.perf_counter() - start)
    return out


def _ref_window_rows(ref) -> Optional[int]:
    """Rows of a window ref; None for a ref over a whole segment."""
    rows = getattr(ref, "rows", None)
    if rows is None:
        return None
    return int(rows[1]) - int(rows[0])


def rank_of_reducers(num_reducers: int, num_trainers: int) -> np.ndarray:
    """The rank each reducer delivers to: contiguous runs of reducers."""
    return np.concatenate(
        [
            np.full(len(chunk), rank, dtype=np.int64)
            for rank, chunk in enumerate(
                np.array_split(np.arange(num_reducers), num_trainers)
            )
        ]
    )


def _pack_starts(partitions: List[List[ObjectRef]], rank_of: np.ndarray, device_layout: Optional[dict]) -> list:
    """Each reducer's ``(start in its rank's stream, layout)``, from the
    row counts its input windows carry; all None without a layout or when a
    window's count is unknown."""
    none = [None] * len(rank_of)
    if device_layout is None:
        return none
    at: Dict[int, int] = {}
    out = []
    for r, rank in enumerate(rank_of.tolist()):
        rows = [_ref_window_rows(parts[r]) for parts in partitions]
        if any(c is None for c in rows):
            return none
        out.append((at.get(rank, 0), device_layout))
        at[rank] = at.get(rank, 0) + sum(rows)
    return out


# -- the decode cache and the schedule policy -------------------------------------


class _DecodeCache:
    """The shuffle's registry of per-file decode-cache segments.

    The first epoch to map file ``i`` publishes its cache; a later epoch's
    map of that file waits on the publishing map and partitions from the
    segment. :meth:`free_all` frees every segment at the end of the run,
    failed or not."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._futs: dict = {}  # file index -> the publishing map's future

    def claim_or_wait(self, index: int) -> Tuple[Optional[ObjectRef], bool]:
        """``(cache_ref, publish)`` for file ``index``: the first caller
        gets ``(None, True)`` and publishes; later callers wait for that
        map and get ``(ref, False)``. A failed publish, or a publishing map
        that failed, means decoding again."""
        if not self.enabled:
            return None, False
        with self._lock:
            fut = self._futs.get(index)
            if fut is None:
                return None, True
        try:
            return fut.result()[1], False
        except Exception:
            return None, False

    def register(self, index: int, fut) -> None:
        with self._lock:
            self._futs[index] = fut

    def hot_refs(self, num_files: int) -> Optional[List[ObjectRef]]:
        """Every file's cache ref once its publishing map has resolved
        (waiting for those still running), else None: a file not yet
        published, or whose publish failed, keeps the epoch off the index
        schedule."""
        if not self.enabled:
            return None
        refs = []
        for i in range(num_files):
            with self._lock:
                fut = self._futs.get(i)
            if fut is None:
                return None
            try:
                ref = fut.result()[1]
            except Exception:
                return None
            if ref is None:
                return None
            refs.append(ref)
        return refs

    def free_all(self) -> None:
        """Free every published cache segment, waiting for the maps still
        publishing."""
        with self._lock:
            futs, self._futs = list(self._futs.values()), {}
        refs = []
        for fut in futs:
            try:
                ref = fut.result()[1]
            except Exception:
                continue
            if ref is not None:
                refs.append(ref)
        if refs:
            runtime.get_context().store.free(refs)


# Measured once per process: the host costs the schedule policy models,
# and the decoded-size estimates.
_PROBE_CACHE: Dict[Any, Any] = {}
_PROBE_LOCK = threading.Lock()
_PROBE_SMALL = 2 << 20  # a gather that stays in the caches
_PROBE_LARGE = 64 << 20  # a gather from DRAM


def _probed_host_costs() -> Dict[str, float]:
    """The host costs the index-schedule policy models with, measured once
    per process (about 0.2 s):

    * ``gather_small`` / ``gather_large``: bytes/s of a random-permutation
      row gather (``np.take``, the index schedule's hot operation) over a
      cache-resident and a DRAM-resident buffer;
    * ``copy``: bytes/s (read plus write) of the same take with sorted
      indices, the materialized schedule's sequential passes;
    * ``roundtrip``: seconds to publish, map and free one tiny segment, the
      per-object cost the materialized schedule pays files x reducers
      times an epoch."""
    with _PROBE_LOCK:
        hit = _PROBE_CACHE.get("costs")
        if hit is not None:
            return hit
        rng = np.random.default_rng(0)

        def gather_bps(nbytes: int) -> float:
            rows = nbytes // 8
            buf = np.arange(rows, dtype=np.int64)  # not zeros: no shared zero page
            idx = rng.permutation(rows)
            np.take(buf, idx[: 1 << 14])
            t0 = time.perf_counter()
            np.take(buf, idx)
            return buf.nbytes / max(1e-9, time.perf_counter() - t0)

        g_small, g_large = gather_bps(_PROBE_SMALL), gather_bps(_PROBE_LARGE)
        buf = np.arange(_PROBE_LARGE // 8, dtype=np.int64)
        t0 = time.perf_counter()
        np.take(buf, np.arange(len(buf)))
        copy = 2 * buf.nbytes / max(1e-9, time.perf_counter() - t0)
        store = runtime.get_context().store
        tiny = {"x": np.zeros(16, np.int64)}
        store.free(store.put_columns(tiny))  # warm
        t0 = time.perf_counter()
        ref = store.put_columns(tiny)
        store.get_columns(ref)
        store.free(ref)
        roundtrip = max(1e-5, time.perf_counter() - t0)
        costs = {"gather_small": float(g_small), "gather_large": float(g_large), "copy": float(copy),
                 "roundtrip": float(roundtrip)}
        _PROBE_CACHE["costs"] = costs
        return costs


def _gather_bw_for(cache_bytes: float) -> float:
    """Gather bytes/s at the dataset's cached size: the small figure below
    the small probe size, the large one above the large size, log-linear
    in between."""
    c = _probed_host_costs()
    lo, hi = float(_PROBE_SMALL), float(_PROBE_LARGE)
    if cache_bytes <= lo:
        return c["gather_small"]
    if cache_bytes >= hi:
        return c["gather_large"]
    frac = (np.log(cache_bytes) - np.log(lo)) / (np.log(hi) - np.log(lo))
    return float(np.exp((1 - frac) * np.log(c["gather_small"]) + frac * np.log(c["gather_large"])))


def _dataset_stats_task(filenames: List[str], narrow_to_32: bool) -> Tuple[float, int]:
    """Run in a worker: ``(decoded bytes per row, total rows)``, bytes per
    row from the schema of the first file's first batch (after
    narrowing), rows from every file's footer."""
    import pyarrow.parquet as pq

    pf = pq.ParquetFile(filenames[0])
    per_row = 0.0
    for batch in pf.iter_batches(batch_size=1 << 16):
        if batch.num_rows == 0:
            continue
        for col in batch.schema:
            dt = np.dtype(col.type.to_pandas_dtype())
            per_row += float((narrowed_dtype(dt) if narrow_to_32 else dt).itemsize)
        break
    if per_row == 0.0:
        raise OSError(f"empty sample from {filenames[0]}")
    total_rows = pf.metadata.num_rows + sum(pq.ParquetFile(f).metadata.num_rows for f in filenames[1:])
    return per_row, int(total_rows)


def _est_decoded_bytes(filenames: List[str], narrow_to_32: bool) -> float:
    """The dataset's decoded size: bytes per row times rows (from a worker,
    :func:`_dataset_stats_task`), plus 15 % headroom; cached per process.
    If that fails, the files' sizes times a fixed expansion (0.7 narrowed,
    1.3 not); an unreadable file raises ``OSError``."""
    if not filenames:
        return 0.0
    key = ("est", tuple(filenames), narrow_to_32)
    with _PROBE_LOCK:
        if key in _PROBE_CACHE:
            return _PROBE_CACHE[key]
    try:
        per_row, total_rows = runtime.get_context().pool.submit(
            _dataset_stats_task, list(filenames), narrow_to_32
        ).result()
        est = per_row * total_rows * 1.15
    except Exception:
        est = sum(os.path.getsize(f) for f in filenames) * (0.7 if narrow_to_32 else 1.3)
    with _PROBE_LOCK:
        _PROBE_CACHE[key] = est
    return est


def _decode_cache_auto(filenames: List[str], num_epochs: int, narrow_to_32: bool = False) -> bool:
    """``cache_decoded=None``: cache when at least two epochs read the
    files and the estimated decoded size is under 0.35 of the store's
    budget (room for it beside about two epochs in flight). Off when the
    store has no budget: nothing would absorb a wrong guess."""
    if num_epochs < 2:
        return False
    try:
        est = _est_decoded_bytes(filenames, narrow_to_32)
    except OSError:
        return False
    cap = runtime.get_context().store.capacity_bytes
    if cap is None:
        return False
    return est < 0.35 * cap


def _index_schedule_allowed(filenames: List[str], num_reducers: int, narrow_to_32: bool) -> bool:
    """May a cache-hot epoch take the index schedule?
    ``RSDL_INDEX_SHUFFLE=on|off`` decides; ``auto`` (the default) compares
    the two schedules' modelled epoch times on this host
    (:func:`_probed_host_costs`):

    * index: ``min(8, R) x cache / gather_bw``: R gathers, each touching a
      64-byte line per 8-byte element of its 1/R of the rows, at most the
      whole cache 8 times;
    * materialized: ``3 x cache / copy_bw`` (map partition, reduce
      permute, cache read) plus ``files x R`` store round trips;

    and takes the index schedule when it is no slower."""
    mode = os.environ.get("RSDL_INDEX_SHUFFLE", "auto").strip().lower()
    if mode in ("on", "1", "true"):
        return True
    if mode in ("off", "0", "false"):
        return False
    try:
        est_cache = _est_decoded_bytes(filenames, narrow_to_32)
    except OSError:
        return False
    costs = _probed_host_costs()
    gather_bw = _gather_bw_for(est_cache)
    if gather_bw <= 0 or costs["copy"] <= 0:
        return False
    t_index = min(8, num_reducers) * est_cache / gather_bw
    t_mat = 3.0 * est_cache / costs["copy"] + len(filenames) * num_reducers * costs["roundtrip"]
    return t_index <= t_mat


def device_direct_enabled() -> bool:
    """The ``RSDL_DEVICE_DIRECT`` kill switch: ``auto`` (the default)
    honours a consumer's layout request; ``off``, ``0`` or ``false``
    refuse it."""
    return os.environ.get("RSDL_DEVICE_DIRECT", "auto").strip().lower() not in ("off", "0", "false")


def _device_layout_allowed(device_layout: Optional[dict]) -> Optional[dict]:
    """The consumer's layout request, unless the kill switch is off."""
    if device_layout is None or not device_direct_enabled():
        return None
    return device_layout


# -- the epochs --------------------------------------------------------------------


class _Resolved:
    """A finished future's stand-in: a stage result re-attached from the
    journal."""

    def __init__(self, value):
        self._value = value

    def result(self, timeout=None):
        return self._value

    def done(self) -> bool:
        return True


def _journaled_refs(ref_dicts) -> Optional[List[ObjectRef]]:
    """The refs of one journaled stage result when every segment is still
    published, else None: the stage then runs again, with the same
    result."""
    from ray_shuffling_data_loader_tpu_torch.runtime import journal as jmod

    store = runtime.get_context().store
    refs = [jmod.ref_from_json(d) for d in ref_dicts or []]
    return refs if refs and all(store.exists(r) for r in refs) else None


def _journaled_ref_dicts(resume_state):
    """Every ref a folded journal names: map partitions, decode-cache
    segments, reduce outputs."""
    for st in resume_state.epochs.values():
        for m in st.maps.values():
            yield from m.get("refs") or []
            if m.get("cache_ref"):
                yield m["cache_ref"]
        for refs in st.reduces.values():
            yield from refs


def _preempted_sessions(resume_state) -> List[str]:
    """The sessions, other than this one, whose segments the journal names."""
    cur = runtime.get_context().store.session
    sessions = {resume_state.identity.get("session")}
    sessions.update(d.get("session") for d in _journaled_ref_dicts(resume_state))
    return sorted(s for s in sessions if s and s != cur)


def _adopt_preempted(resume_state) -> None:
    """At a resume's start: sweep the preempted sessions' segments that the
    journal does not name (a dead queue's batches, half-written segments)
    and count the rest towards this session's budget."""
    store = runtime.get_context().store
    named = {d["id"] for d in _journaled_ref_dicts(resume_state)}
    for session in _preempted_sessions(resume_state):
        store.cleanup(session=session, keep=named)
        store.adopt_session(session)


def _sweep_preempted(resume_state) -> None:
    """At a resumed run's end: whatever is left of the preempted sessions
    goes; a predecessor in this very session has its journaled refs that
    were not re-attached freed one by one."""
    from ray_shuffling_data_loader_tpu_torch.runtime import journal as jmod

    store = runtime.get_context().store
    for session in _preempted_sessions(resume_state):
        store.cleanup(session=session)
    if resume_state.identity.get("session") == store.session:
        store.free([jmod.ref_from_json(d) for d in _journaled_ref_dicts(resume_state)])


def _seed_decode_cache(decode_cache: "_DecodeCache", resume_state) -> None:
    """Re-attach the newest surviving decode-cache segment of each file."""
    from ray_shuffling_data_loader_tpu_torch.runtime import journal as jmod

    store = runtime.get_context().store
    best: Dict[int, ObjectRef] = {}
    for e in sorted(resume_state.epochs):
        for i, m in resume_state.epochs[e].maps.items():
            if m.get("cache_ref"):
                ref = jmod.ref_from_json(m["cache_ref"])
                if store.exists(ref):
                    best[int(i)] = ref
    for i, ref in best.items():
        decode_cache.register(i, _Resolved((None, ref)))


def _count(stats: Optional[Dict[str, Any]], key: str, n: int = 1) -> None:
    """Add to the run's resume counters (``stats["resume"]``)."""
    if stats is not None and n:
        counters = stats.setdefault("resume", {})
        counters[key] = counters.get(key, 0) + n


def _accepts_seq(consumer: BatchConsumer) -> bool:
    """Does the consumer take a reducer's ``seq`` (idempotent delivery)?"""
    import inspect

    try:
        return "seq" in inspect.signature(consumer.consume).parameters
    except (TypeError, ValueError):
        return False


def _reclaim(store, fut, unwrap: bool = False) -> None:
    """Free what a task of a failed epoch published, once it has ended."""
    try:
        out = fut.result()
    except Exception:
        return
    if unwrap:
        out = out[0]
    store.free(out if isinstance(out, (list, tuple)) else [out])


def shuffle_epoch(
    epoch: int,
    filenames: Sequence[str],
    batch_consumer: BatchConsumer,
    num_reducers: int,
    num_trainers: int,
    seed: int,
    narrow_to_32: bool = False,
    decode_cache: Optional[_DecodeCache] = None,
    schedule_log: Optional[list] = None,
    device_layout: Optional[dict] = None,
    stats: Optional[Dict[str, Any]] = None,
    stats_collector=None,
    journal=None,
    est=None,
) -> bool:
    """One epoch's maps and reduces in the session's worker pool; each
    reducer's output refs go to its rank in reducer order, then every rank
    gets its end-of-epoch signal. The epoch takes the index schedule when
    every file's cache is hot and :func:`_index_schedule_allowed` agrees
    (``schedule_log`` gets ``(epoch, "index" | "mapreduce")``). With a
    ``device_layout``, each reducer learns its start in its rank's stream
    and packs. Partitions are freed as their reducer lands, the consumer
    frees the outputs, and a failed epoch frees what its tasks published.
    ``stats["store_peak_bytes"]`` keeps the store's peak, sampled after
    the maps and after each reduce.

    ``journal`` (a :class:`~.runtime.journal.RunJournal`): append the
    epoch's barriers. ``est``: the epoch's journaled progress from a
    preempted run: a fully delivered epoch runs no task, a stage whose
    journaled segments survive is re-attached, and reducers below the
    delivery cursor are not delivered again. Returns False when a suspend
    request stopped the epoch (its running reduces journaled), else
    True."""
    if stats_collector is not None:
        stats_collector.call_oneway("epoch_start", epoch)
    ctx = runtime.ensure_initialized()
    store, pool = ctx.store, ctx.pool
    if decode_cache is None:
        decode_cache = _DecodeCache(enabled=False)
    cache_refs = (
        decode_cache.hot_refs(len(filenames))
        if decode_cache.enabled and _index_schedule_allowed(list(filenames), num_reducers, narrow_to_32)
        else None
    )
    schedule = "index" if cache_refs is not None else "mapreduce"
    if schedule_log is not None:
        schedule_log.append((epoch, schedule))
    jmod = None
    if journal is not None:
        from ray_shuffling_data_loader_tpu_torch.runtime import journal as jmod
    if est is not None and est.schedule is not None and est.schedule != schedule:
        # Stage results of the other schedule do not fit this one's tasks;
        # the cursor holds, as both schedules deliver the same stream.
        pruned = type(est)(est.epoch)
        pruned.schedule, pruned.delivered, pruned.rank_rows = schedule, est.delivered, dict(est.rank_rows)
        est = pruned
    cursor = est.delivered if est is not None else 0
    if journal is not None:
        journal.append("epoch", epoch=epoch, schedule=schedule)
    if est is not None and cursor >= num_reducers:
        # Delivered whole before the preemption: no map, no reduce.
        _count(stats, "epochs_skipped")
        for rank in range(num_trainers):
            batch_consumer.producer_done(rank, epoch)
        if journal is not None:
            journal.append("epoch-done", epoch=epoch)
        return True
    consume_seq = journal is not None and _accepts_seq(batch_consumer)

    def sample():
        if stats is not None:
            stats["store_peak_bytes"] = max(stats.get("store_peak_bytes", 0), store.store_stats().total_bytes)

    def attached(journaled, stage: str, expect: Optional[int] = None):
        """A journaled stage result whose segments all survive, else None
        (the stage runs again)."""
        if not journaled:
            return None
        refs = _journaled_refs(journaled)
        if refs is None or (expect is not None and len(refs) != expect):
            _count(stats, f"{stage}s_reexecuted")
            return None
        _count(stats, f"{stage}s_reattached")
        return refs

    map_futs, publishing, attached_maps = [], [], set()
    for file_index, filename in enumerate(filenames):
        refs = attached((est.maps.get(file_index) or {}).get("refs"), "map", num_reducers) if est else None
        if refs is not None:
            map_futs.append(_Resolved(refs))
            publishing.append(False)
            attached_maps.add(file_index)
            continue
        if schedule == "index":
            fut = pool.submit(
                shuffle_plan, file_index, num_reducers, epoch, seed, cache_refs[file_index], stats_collector
            )
            publish = False
        else:
            cache_ref, publish = decode_cache.claim_or_wait(file_index)
            fut = pool.submit(
                shuffle_map, filename, file_index, num_reducers, epoch, seed, narrow_to_32, cache_ref, publish,
                stats_collector,
            )
            if publish:
                decode_cache.register(file_index, fut)
        map_futs.append(fut)
        publishing.append(publish)
    partitions: List[List[ObjectRef]] = []
    reduce_futs: list = []
    delivered = 0
    completed = True
    try:
        for i, (fut, publish) in enumerate(zip(map_futs, publishing)):
            out = fut.result()
            partitions.append(out[0] if publish else out)
            if journal is not None and i not in attached_maps:
                rec = {"refs": [jmod.ref_to_json(x) for x in partitions[-1]]}
                if publish and out[1] is not None:
                    rec["cache_ref"] = jmod.ref_to_json(out[1])
                journal.append("map", epoch=epoch, file=i, **rec)
        sample()
        rank_of = rank_of_reducers(num_reducers, num_trainers)
        pack_for = _pack_starts(partitions, rank_of, device_layout)
        attached_reduces = set()
        for r in range(num_reducers):
            parts_r = [parts[r] for parts in partitions]
            refs = attached(est.reduces.get(r), "reduce") if est is not None and r >= cursor else None
            if r < cursor or refs is not None:
                # Delivered already, or its output survived: the inputs go.
                store.free(parts_r)
                reduce_futs.append(None if r < cursor else _Resolved(refs))
                if refs is not None:
                    attached_reduces.add(r)
            elif schedule == "index":
                reduce_futs.append(pool.submit(
                    shuffle_gather_reduce, r, epoch, seed, parts_r, cache_refs, pack_for[r], stats_collector
                ))
            else:
                reduce_futs.append(pool.submit(shuffle_reduce, r, epoch, seed, parts_r, pack_for[r], stats_collector))
        _count(stats, "reducers_skipped", cursor)
        delivered = cursor
        for r in range(cursor, num_reducers):
            fut = reduce_futs[r]
            if jmod is not None and jmod.suspend_requested():
                # The reducer just delivered was the quiesce window: journal
                # the outputs of the reduces still running, so that the
                # resume re-attaches them, and stop here.
                deadline = time.monotonic() + 60.0
                for r2 in range(r, num_reducers):
                    if r2 in attached_reduces:
                        continue
                    try:
                        out2 = reduce_futs[r2].result(timeout=max(0.0, deadline - time.monotonic()))
                    except Exception:
                        continue
                    out2 = out2 if isinstance(out2, list) else [out2]
                    journal.append("reduce", epoch=epoch, reducer=r2, refs=[jmod.ref_to_json(x) for x in out2])
                delivered = num_reducers
                completed = False
                break
            out = fut.result()
            out = out if isinstance(out, list) else [out]
            sample()
            if r not in attached_reduces:
                store.free([parts[r] for parts in partitions])
                if journal is not None:
                    journal.append("reduce", epoch=epoch, reducer=r, refs=[jmod.ref_to_json(x) for x in out])
            rank = int(rank_of[r])
            if consume_seq:
                batch_consumer.consume(rank, epoch, out, seq=r)
            else:
                batch_consumer.consume(rank, epoch, out)
            if journal is not None:
                rows = sum(_ref_window_rows(ref) or 0 for ref in out)
                journal.append("deliver", epoch=epoch, reducer=r, rank=rank, rows=int(rows), sampled=0)
            if stats_collector is not None:
                stats_collector.call_oneway("consume", rank, epoch, sum(ref.nbytes for ref in out))
            delivered = r + 1
    except BaseException:
        for fut in reduce_futs[delivered:]:
            if fut is not None and not isinstance(fut, _Resolved):
                _reclaim(store, fut)
        for fut, publish in zip(map_futs[len(partitions):], publishing[len(partitions):]):
            _reclaim(store, fut, unwrap=publish)  # its cache segment is the decode cache's
        raise
    finally:
        for parts in partitions:
            store.free(parts)
    for rank in range(num_trainers):
        batch_consumer.producer_done(rank, epoch)
    if journal is not None and completed:
        journal.append("epoch-done", epoch=epoch)
    return completed


def shuffle(
    filenames: Sequence[str],
    batch_consumer: BatchConsumer,
    num_epochs: int,
    num_reducers: int,
    num_trainers: int,
    seed: int = 0,
    start_epoch: int = 0,
    narrow_to_32: bool = False,
    cache_decoded: Optional[bool] = None,
    schedule_log: Optional[list] = None,
    device_layout: Optional[dict] = None,
    stats: Optional[Dict[str, Any]] = None,
    stats_collector=None,
    resume_from: Optional[str] = None,
) -> float:
    """Shuffle every epoch from ``start_epoch`` into ``batch_consumer``;
    each epoch first waits for the consumer to admit it. Returns the
    run's seconds.

    ``cache_decoded``: keep each file's decoded columns in the store after
    the first epoch, so later epochs skip Parquet (None: on when at least
    two epochs run and the estimate fits the store's budget,
    :func:`_decode_cache_auto`); a hot cache also lets later epochs take
    the index schedule. ``schedule_log``: each epoch appends ``(epoch,
    "index" | "mapreduce")``. ``device_layout``: a staging consumer's
    ``{"batch": B, "columns": [...]}``; reducers then pack their whole
    batches (unless ``RSDL_DEVICE_DIRECT=off``). ``stats``: the resolved
    ``cache_decoded``, the epoch in progress (``epoch``), each epoch's
    shuffle seconds (``epoch_shuffle_s``, admission excluded), the
    store's peak bytes, and on a journaled run its ``journal`` path and
    the ``resume`` counters (stages re-attached and re-executed, epochs
    and reducers skipped). ``stats_collector``: a
    :class:`~.stats.TrialStatsCollector` handle that hears the run's
    events (module docstring), ``trial_done`` with the run's seconds
    last.

    ``resume_from``: resume a preempted run from its journal: ``"auto"``
    (or ``RSDL_RESUME=auto``) finds the newest resumable run under
    ``RSDL_JOURNAL`` whose identity matches this call, ``"redeliver"``
    re-attaches as ``"auto"`` does but delivers the whole stream again
    (for a consumer that restarted), and a path names a journal file or
    directory, refused on a mismatch. With
    ``RSDL_JOURNAL`` set, every run journals its window, and on the main
    thread SIGTERM suspends it (:mod:`.runtime.journal`)."""
    check_shuffle_plan()
    start = time.perf_counter()
    filenames = list(filenames)
    device_layout = _device_layout_allowed(device_layout)
    # Imported only when asked for: with RSDL_JOURNAL unset and no
    # resume_from the journal module never loads and no handler is set.
    jmod = journal = resume_state = None
    if resume_from is not None or os.environ.get("RSDL_JOURNAL"):
        from ray_shuffling_data_loader_tpu_torch.runtime import journal as jmod

        identity = jmod.run_identity(
            filenames, num_epochs, num_reducers, num_trainers, seed, start_epoch, narrow_to_32,
            shuffle_plan_label(), None, device_layout,
        )
        resume_state, resume_mode = jmod.resolve_resume(resume_from, identity)
        if not jmod.enabled() and resume_state is None:
            jmod = None  # nothing to resume, nowhere to journal
    if jmod is not None:
        runtime.ensure_initialized()
        jmod.clear_suspend()
        journal = jmod.begin_run(identity, resume=resume_state, mode=resume_mode)
        jmod.install_sigterm_handler()
        if stats is not None:
            stats["journal"] = journal.path
            stats["resume"] = {"from_run": resume_state.run_id if resume_state else None, "mode": resume_mode}
        if resume_state is not None:
            _adopt_preempted(resume_state)
            restore = getattr(batch_consumer, "restore_delivery_cursors", None)
            cursors = {
                f"{e}/{rank}": st.delivered
                for e, st in resume_state.epochs.items() if st.delivered > 0 for rank in range(num_trainers)
            }
            if restore is not None and resume_mode == "cursor" and cursors:
                # A reducer that reached the queue between its publish and
                # its journal record is then dropped on re-publish.
                restore(cursors)
    if cache_decoded is None:
        cache_decoded = _decode_cache_auto(filenames, num_epochs - start_epoch, narrow_to_32)
    if stats is not None:
        stats["cache_decoded"] = cache_decoded
        stats.setdefault("epoch_shuffle_s", [])
    decode_cache = _DecodeCache(enabled=cache_decoded)
    if resume_state is not None and cache_decoded:
        _seed_decode_cache(decode_cache, resume_state)
    suspended = False
    try:
        try:
            for epoch in range(start_epoch, num_epochs):
                if jmod is not None and jmod.suspend_requested():
                    suspended = True
                    break
                if stats is not None:
                    stats["epoch"] = epoch
                throttle_start = time.perf_counter()
                batch_consumer.wait_until_ready(epoch)
                t0 = time.perf_counter()
                if stats_collector is not None:
                    stats_collector.call_oneway("epoch_throttle", epoch, t0 - throttle_start)
                est = resume_state.epochs.get(epoch) if resume_state is not None else None
                if not shuffle_epoch(
                    epoch, filenames, batch_consumer, num_reducers, num_trainers, seed,
                    narrow_to_32=narrow_to_32, decode_cache=decode_cache, schedule_log=schedule_log,
                    device_layout=device_layout, stats=stats, stats_collector=stats_collector,
                    journal=journal, est=est,
                ):
                    suspended = True
                    break
                if stats is not None:
                    stats["epoch_shuffle_s"].append(time.perf_counter() - t0)
        finally:
            if not suspended:
                # A suspended window keeps its segments for the resume.
                decode_cache.free_all()
        if suspended:
            journal.append("suspended")
            if jmod.suspend_should_exit():
                jmod.suspend_and_exit(journal)  # exits 0
            jmod.end_run(journal, status="suspended")
            raise jmod.RunSuspended(journal.path)
        batch_consumer.wait_until_all_epochs_done()
        if journal is not None:
            if resume_state is not None:
                _sweep_preempted(resume_state)
            jmod.end_run(journal)
    except BaseException as exc:
        if journal is not None and not isinstance(exc, jmod.RunSuspended):
            jmod.end_run(journal, status="failed")  # stays resumable
        raise
    duration = time.perf_counter() - start
    if stats_collector is not None:
        stats_collector.call_oneway("trial_done", duration)
    return duration
