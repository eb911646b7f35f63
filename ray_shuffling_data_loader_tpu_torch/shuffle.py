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

Maps and reduces run in the session's spawned worker pool, or in a
cluster on every host's (:attr:`.runtime.RuntimeContext.scheduler`; a
reduce, and a map over a cached decode, on the host that holds most of
its input). A map writes its grouped rows into one shared-memory store
segment and returns one row-window ref per reducer; a reduce reads its
windows by ref and writes its permuted rows into a segment of its own,
whose ref the shuffle hands to the rank's consumer. Bulk data never
passes through a pipe.

**Overlapped reduce** (``RSDL_REDUCE_FETCH_OVERLAP=auto|on|off``, resolved
by the epoch's driver and handed to every reduce): a reduce whose windows
live on other hosts inverts its permutation once and scatters each
window into its output as it arrives, while the next
``fetch_window_depth`` windows are being fetched
(:func:`_overlapped_reduce`); ``auto`` engages only when some window
would be fetched, so one host keeps the fused gather. The same bits
either way.

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

Two opt-in settings change what an epoch delivers or how it reads:

* **Plan family** (``RSDL_SHUFFLE_PLAN=rowwise|block[:G]``, resolved once
  by ``shuffle()`` and handed to every stage task): rowwise draws each row's
  reducer; a block plan deals runs of ``G`` consecutive row groups to
  reducers (:func:`_group_owners`), so a whole row group travels to one
  reducer. A different stream from rowwise, the same in every schedule.
* **Selective schedule** (``RSDL_SELECTIVE_READS=off|auto|on``, default
  off, :func:`selective_reads_decision`): no map writes anything; a
  :func:`shuffle_selective_plan` per file returns counts from the footer,
  and a :func:`shuffle_selective_reduce` per reducer decodes just the row
  groups that hold its rows. ``auto`` engages under a block plan only,
  where those selections are disjoint and each row group is decoded once
  an epoch.

The read plane decides what a run decodes and who decides it:

* **Decode pushdown** (``shuffle(columns=)``, ``RSDL_DECODE_PUSHDOWN``,
  :func:`_pushdown_columns`): every decode reads only the projection,
  and the stream holds exactly its columns.
* **Shared decode cache** (``RSDL_DECODE_CACHE_SHARED``): the decode
  cache outlives the run, for the next run over the same files.
* **Plan compiler** (``RSDL_PLAN=auto``, :mod:`.analysis.planner`): the
  plan family, the selective schedule, the projection and the tasks'
  threads, decided from the Parquet footers where the environment leaves
  them unset.

Given the same files, seed, reducer count and plan, the row stream is the
one the JAX package's shuffle delivers: the seeds, the draws and the
group-by order are the same, whichever schedule and output form an epoch
takes.

The host passes run the C++ kernels of :mod:`.native`: the map's group-by
scatter, the reduce's fused concat and gather, the index and selective
schedules' gathers, the narrowing and the schedule policy's probe. The
process that calls ``shuffle()`` builds them before its pool spawns and
tells each stage task whether to use them (``RSDL_DISABLE_NATIVE``
selects their plain numpy versions, bit for bit the same); each task
returns its calls of each, and
``shuffle(stats=)`` sums them (``native_calls``, ``plain_calls``).

**Stage recovery.** Every stage task may run up to
``RSDL_STAGE_MAX_ATTEMPTS`` times (:func:`.runtime.retry.stage_policy`,
default 3): a map, plan or reduce that fails (a crash, a worker that died,
a lost input) runs again with the same seeds and knobs, so its output is
the same bit for bit. A reduce whose input window is lost re-runs the map
that made it (the epoch's lineage; when a host died, every map of that
host feeding the reduce at once), the index schedule decodes a lost cache
segment again, and the selective schedule, whose inputs are the Parquet
files, resubmits. A task that fails every attempt fails its epoch with
:class:`StageFailedError`, after every rank got its end of the epoch.
The fault plane (:mod:`.runtime.faults`) fires ``task.map`` and
``task.reduce`` at each stage task's entry and exit and
``queue.producer`` before each delivery.

**Journal** (``RSDL_JOURNAL`` or ``shuffle(resume_from=)``,
:mod:`.runtime.journal`): the run's epoch window is journaled at the
barriers, and a later run resumes it: completed epochs skipped, stage
results re-attached while their segments survive (else run again from
the seed), the delivery cursor honoured. Off, the journal module is not
even imported.

**Audit** (``RSDL_AUDIT``, :mod:`.telemetry.audit`): each map, reduce
and delivery digests the key column of its rows, and at the run's end
``shuffle()`` reconciles the sides into one verdict per epoch, journaled
when the journal is on. Off, each hook is one cached boolean.

**Metrics and trace** (``RSDL_METRICS``, ``RSDL_TRACE``,
:mod:`.telemetry`): each stage task counts its tasks and rows
(``shuffle.map_*``, ``shuffle.reduce_*``), times its phases
(``shuffle.phase_seconds{phase,stage}``) and records its ``map`` or
``reduce`` span; the driver runs each epoch in the ``(epoch, schedule)``
trace context, with the ``epoch:admission``, ``deliver:wait-maps`` and
``deliver`` spans, the ``trial.*``, ``epoch.*``, ``plan.*``,
``stage.retry`` and ``recovery`` events, and the ``recovery.*`` counters.
Off, each site is one cached boolean, and the driver imports none of the
trace, export, events or phases modules.

A ``stats_collector`` (a :class:`~.stats.TrialStatsCollector` actor's
handle) hears, as the JAX package's does, each epoch's start and
admission wait, each task's start and duration, and each reducer output
delivered to a rank, and the run's end.

The device-resident loader's decode task, :func:`_decode_narrow_to_store`,
lives here too, so that the workers never import torch.

This module imports numpy and pyarrow only: the workers load it.
"""

from __future__ import annotations

import concurrent.futures as cf
import contextlib
import logging
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from ray_shuffling_data_loader_tpu_torch import native, runtime, telemetry
from ray_shuffling_data_loader_tpu_torch.runtime import ColumnBatch, ObjectRef, TaskError
from ray_shuffling_data_loader_tpu_torch.runtime.retry import stage_policy
from ray_shuffling_data_loader_tpu_torch.runtime.store import DEVICE_BATCH_KIND, PACKED_COLUMN
from ray_shuffling_data_loader_tpu_torch.telemetry import audit as _audit
from ray_shuffling_data_loader_tpu_torch.telemetry import metrics as _metrics

_INT32 = np.iinfo(np.int32)


class StageFailedError(TaskError):
    """A stage task failed every attempt of its budget
    (``RSDL_STAGE_MAX_ATTEMPTS``, default 3): what a poison task ends in,
    raised out of :func:`shuffle` and to the trainer iterating the
    dataset. ``stage`` is ``"map"``, ``"reduce"`` or
    ``"map-rematerialize"``."""

    def __init__(self, stage: str, epoch: int, attempts: int, message: str):
        super().__init__(message, error_type="StageFailedError")
        self.stage = stage
        self.epoch = epoch
        self.attempts = attempts

    def __reduce__(self):
        return (StageFailedError, (self.stage, self.epoch, self.attempts, self.args[0] if self.args else ""))


class BatchConsumer:
    """What the shuffle delivers to: each reducer's output refs, in
    reducer order per rank, and the end of each rank's epoch. A consumer
    may also define ``producer_failed(epoch, exc)``: a failing epoch calls
    it before it ends every rank's epoch."""

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


def _table_to_columns(table) -> Dict[str, np.ndarray]:
    return {name: np.ascontiguousarray(col.to_numpy(zero_copy_only=False))
            for name, col in zip(table.column_names, table.columns)}


def _np_dtype_of(field) -> Optional[np.dtype]:
    """The numpy dtype an Arrow field decodes to, or None when it has no
    fixed-width numeric one."""
    try:
        dt = np.dtype(field.type.to_pandas_dtype())
    except (TypeError, NotImplementedError):
        return None
    return dt if dt.kind in "fiub" else None


_RG_META_LOCK = threading.Lock()
_RG_META_CACHE: Dict[str, Tuple[int, ...]] = {}


def file_row_group_sizes(filename: str) -> List[int]:
    """Rows of each row group, from the Parquet footer, cached per
    process: the block plan reads every file's footer every epoch, and a
    run's files do not change."""
    with _RG_META_LOCK:
        hit = _RG_META_CACHE.get(filename)
    if hit is not None:
        return list(hit)
    import pyarrow.parquet as pq

    meta = pq.ParquetFile(filename, memory_map=True).metadata
    sizes = tuple(int(meta.row_group(g).num_rows) for g in range(meta.num_row_groups))
    with _RG_META_LOCK:
        _RG_META_CACHE[filename] = sizes
    return list(sizes)


def decode_rowgroup_threads(stage_tasks: int) -> int:
    """Threads for one decode of selected row groups
    (``RSDL_DECODE_ROWGROUPS``): 1 when unset or ``off``; ``auto``, this
    task's share of the cores (``cores // min(stage_tasks, cores)``) when
    the host has twice as many cores as the stage runs tasks, else 1;
    ``on``, that share but at least 2; an integer, that many."""
    env = os.environ.get("RSDL_DECODE_ROWGROUPS", "").strip().lower()
    if env in ("", "off", "0", "false"):
        return 1
    cores = os.cpu_count() or 1
    concurrent = min(max(1, stage_tasks), cores)
    fair = max(1, cores // concurrent)
    if env in ("on", "true"):
        return max(2, fair)
    if env != "auto":
        try:
            return max(1, int(env))
        except ValueError:
            pass
    return fair if cores >= 2 * concurrent else 1


def _decode_rowgroups_parallel(filename: str, names: List[str], sel: List[int], threads: int):
    """Decode row groups ``sel`` with ``threads`` threads striped over
    columns: each thread reads the whole selection of its columns on a
    reader of its own (Arrow decodes without the GIL) and converts them as
    the single read does, so the columns are the same bits. Striping by
    columns needs no assembly across threads, which striping by row groups
    would. None for a file of one column (nothing to stripe) or when a
    thread failed; the caller then reads in one go."""
    import pyarrow.parquet as pq

    if len(names) < 2:
        return None
    threads = min(threads, len(names))
    stripes = [names[k::threads] for k in range(threads)]
    results: Dict[str, np.ndarray] = {}
    errors: List[BaseException] = []

    def work(cols: List[str]) -> None:
        try:
            table = pq.ParquetFile(filename, memory_map=True).read_row_groups(sel, columns=cols, use_threads=False)
            results.update(_table_to_columns(table))
        except BaseException as exc:
            errors.append(exc)

    workers = [threading.Thread(target=work, args=(cols,), name="rsdl-decode-rg") for cols in stripes[1:]]
    for w in workers:
        w.start()
    work(stripes[0])
    for w in workers:
        w.join()
    if errors or set(results) != set(names):
        return None
    return {name: results[name] for name in names}


# What this process's Parquet decodes read since the stage wrapper last
# took the counts (:func:`_run_stage`): row groups, decoded bytes, and the
# decoded bytes the projection and the row-group selection left out.
_DECODE_COUNTS = {"rowgroups": 0, "bytes": 0, "bytes_pruned": 0}


def _count_decode(schema, group_rows: Sequence[int], sel: Sequence[int], proj: Optional[Sequence[str]]) -> None:
    """Add one decode to :data:`_DECODE_COUNTS`. Widths are the decoded
    ones before narrowing (8 bytes where a column has no fixed-width
    dtype), and the pruned bytes are the JAX package's
    ``shuffle.decode_bytes_pruned``: every row of each column left out,
    plus the projected columns of the rows in groups not selected."""
    total_rows = int(sum(group_rows))
    sel_rows = int(sum(group_rows[g] for g in sel))
    proj_bytes = pruned_col_bytes = 0
    for i in range(len(schema.names)):
        field = schema.field(i)
        dt = _np_dtype_of(field)
        width = dt.itemsize if dt is not None else 8
        if proj is not None and field.name not in proj:
            pruned_col_bytes += width
        else:
            proj_bytes += width
    _DECODE_COUNTS["rowgroups"] += len(sel)
    _DECODE_COUNTS["bytes"] += sel_rows * proj_bytes
    _DECODE_COUNTS["bytes_pruned"] += total_rows * pruned_col_bytes + (total_rows - sel_rows) * proj_bytes


def read_parquet_columns(
    filename: str,
    columns: Optional[Sequence[str]] = None,
    use_threads: bool = False,
    row_groups: Optional[Sequence[int]] = None,
    rowgroup_threads: int = 1,
    counted: bool = True,
    prof=None,
    metric_labels: Optional[Dict[str, str]] = None,
) -> ColumnBatch:
    """Decode a local Parquet file to contiguous numpy columns.

    ``columns``: decode only these, in this order (None: all); a name the
    file lacks raises a ``ValueError``, and so does a projection that
    selects no column. ``use_threads``: let Arrow
    decode with its own threads. Off by default: the worker pool decodes
    one file per worker, and Arrow's threads on top of that oversubscribe
    a busy host. ``row_groups``: decode only these row groups, in
    ascending order (the selective schedule's read): the same columns as
    the whole file's rows of those groups, as long as a column decodes to
    one dtype in every group. ``rowgroup_threads > 1``: decode them with
    :func:`_decode_rowgroups_parallel` (then ``use_threads`` is ignored).
    Every read adds to :data:`_DECODE_COUNTS`, but for ``counted=False``
    (the audit's key-only side read, whose cost is the audit's).

    ``prof``: the task's :func:`.telemetry.phases.stage_profiler` (None: a
    ``decode`` one), which times ``decode:io`` (open and footer) and
    ``decode:arrow``. ``metric_labels``: the caller's ``{schedule, plan}``
    on ``shuffle.decode_rowgroups`` and the pruned counters, as the JAX
    package labels them; the whole-file read counts neither, as there.

    With the audit armed, the audit key that :func:`_pushdown_columns`
    appends may be missing from the file: it is left out, and the audit
    warns and skips the file's digest. Any other missing name raises."""
    import pyarrow.parquet as pq

    if prof is None:
        prof = telemetry.stage_profiler("decode")
    simple = columns is None and row_groups is None and rowgroup_threads <= 1
    with contextlib.nullcontext() if simple else prof.phase("decode:io"):
        pf = pq.ParquetFile(filename, memory_map=True)
        schema = pf.schema_arrow
        group_rows = [int(pf.metadata.row_group(g).num_rows) for g in range(pf.metadata.num_row_groups)]
    if simple:
        if counted:
            _count_decode(schema, group_rows, range(len(group_rows)), None)
        with prof.phase("decode:arrow") as ph:
            table = pq.read_table(filename, use_threads=use_threads, memory_map=True)
            cols = _table_to_columns(table)
            ph.add_bytes(sum(v.nbytes for v in cols.values()))
        return ColumnBatch(cols)
    proj = None if columns is None else list(columns)
    if proj is not None:
        missing = [c for c in proj if c not in schema.names]
        if missing:
            tolerated = {_audit.key_column_name()} if _audit.enabled() else set()
            hard = [c for c in missing if c not in tolerated]
            if hard:
                raise ValueError(f"projected columns not in {filename!r} schema: {hard}")
            proj = [c for c in proj if c in schema.names]
        if not proj:
            raise ValueError(f"projection selects no columns of {filename!r} (requested {list(columns)!r})")
    names = list(schema.names) if proj is None else proj
    sel = list(range(len(group_rows))) if row_groups is None else sorted(int(g) for g in row_groups)
    if counted:
        before = _DECODE_COUNTS["bytes_pruned"]
        _count_decode(schema, group_rows, sel, proj)
        _note_pruned(group_rows, sel, _DECODE_COUNTS["bytes_pruned"] - before, metric_labels)
    _metrics.safe_inc("shuffle.decode_rowgroups", float(len(sel)), **(metric_labels or {}))
    with prof.phase("decode:arrow") as ph:
        cols = None
        if rowgroup_threads > 1 and sel:
            cols = _decode_rowgroups_parallel(filename, names, sel, rowgroup_threads)
        if cols is None:
            if sel:
                cols = _table_to_columns(pf.read_row_groups(sel, columns=names, use_threads=use_threads))
            else:
                # No group selected: empty columns of the schema's dtypes.
                cols = {}
                for name in names:
                    dt = _np_dtype_of(schema.field(name))
                    cols[name] = np.empty(0, dt if dt is not None else np.int64)
        ph.add_bytes(sum(v.nbytes for v in cols.values()))
    return ColumnBatch(cols)


def _note_pruned(group_rows: Sequence[int], sel: Sequence[int], bytes_pruned: int,
                 labels: Optional[Dict[str, str]]) -> None:
    """``shuffle.decode_rows_pruned`` and ``shuffle.decode_bytes_pruned``
    (each only when positive, labelled with the caller's ``{schedule,
    plan}``): the rows a selection skipped and the decoded bytes both
    prunes avoided, as :func:`_count_decode` counts them."""
    if not _metrics.enabled():
        return
    labels = labels or {}
    rows_pruned = int(sum(group_rows)) - int(sum(group_rows[g] for g in sel))
    if rows_pruned > 0:
        _metrics.safe_inc("shuffle.decode_rows_pruned", float(rows_pruned), **labels)
    if bytes_pruned > 0:
        _metrics.safe_inc("shuffle.decode_bytes_pruned", float(bytes_pruned), **labels)


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
    """Cast a 64-bit column to 32 bits: int64 -> int32 with the range check
    in the same pass (:func:`.native.narrow_i64_checked`), refusing values
    outside int32's range, which would wrap silently; float64 -> float32,
    lossy by design (:func:`.native.narrow`)."""
    if v.dtype == np.int64:
        out = native.narrow_i64_checked(v)
        if out is None:
            raise ValueError(
                f"narrow_to_32: column {name!r} has values outside int32 "
                "range; disable narrowing for this dataset"
            )
        return out
    if v.dtype == np.float64:
        return native.narrow(v, np.float32)
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


def _group_owners(
    seed: int, epoch: int, file_index: int, group_sizes: Sequence[int], num_reducers: int, granularity: int
) -> np.ndarray:
    """Each row group's reducer under a block plan: runs of
    ``granularity`` consecutive row groups form blocks, dealt to reducers
    round-robin from a seeded start and then shuffled with the file's
    generator, so reducers get block counts within one of each other and
    the extra blocks do not always land on the low reducers."""
    rng = _map_seed(seed, epoch, file_index)
    n_groups = len(group_sizes)
    n_blocks = -(-n_groups // granularity) if n_groups else 0
    if n_blocks == 0:
        return np.empty(0, dtype=np.int64)
    owners = (np.arange(n_blocks, dtype=np.int64) + int(rng.integers(num_reducers))) % num_reducers
    rng.shuffle(owners)
    return np.repeat(owners, granularity)[:n_groups]


def _label_of_plan(plan: Tuple[str, int]) -> str:
    """The label of a resolved plan (``rowwise`` or ``block:G``)."""
    family, granularity = plan
    return family if family == "rowwise" else f"block:{granularity}"


def _file_assignment(
    seed: int,
    epoch: int,
    file_index: int,
    n: int,
    num_reducers: int,
    filename: Optional[str] = None,
    plan: Optional[Tuple[str, int]] = None,
) -> np.ndarray:
    """Each row's reducer for one file: the one definition every schedule
    partitions with. Rowwise draws each row's reducer from the file's
    generator; a block plan gives every row of a row group its group's
    owner (:func:`_group_owners`, from the footer's row-group sizes of
    ``filename``; no data is read). ``plan``: ``shuffle()``'s resolved
    ``(family, granularity)`` (None: this process's environment, for
    direct callers)."""
    family, granularity = plan if plan is not None else shuffle_plan_spec()
    if family == "rowwise":
        return _map_seed(seed, epoch, file_index).integers(num_reducers, size=n)
    if filename is None:
        raise ValueError("block shuffle plan needs the source filename to read row-group sizes from the footer")
    sizes = np.asarray(file_row_group_sizes(filename), dtype=np.int64)
    if int(sizes.sum()) != int(n):
        raise ValueError(
            f"block shuffle plan: footer row count {int(sizes.sum())} != caller row count {n} for {filename!r} "
            "(stale decode cache or changed dataset)"
        )
    return np.repeat(_group_owners(seed, epoch, file_index, sizes, num_reducers, granularity), sizes)


def plan_is_prunable(plan: Optional[Tuple[str, int]] = None) -> bool:
    """Can a reducer skip a row group under this plan? Never under
    rowwise (every group holds rows of every reducer); always under a
    block plan. ``plan`` as for :func:`_file_assignment`."""
    family, _ = plan if plan is not None else shuffle_plan_spec()
    return family == "block"


# -- the plan compiler's hooks -------------------------------------------------


def _plan_enabled() -> bool:
    """Is the plan compiler on (``RSDL_PLAN=auto|on``)? Read before
    anything of it is imported: off, :mod:`.analysis.planner` and
    :mod:`.runtime.plan` never load."""
    return (os.environ.get("RSDL_PLAN") or "").strip().lower() in ("auto", "on", "1", "true")


# -- the live trial status ----------------------------------------------------
# The driver's view of the running (or last) trials: each one's shape, and
# each epoch's state, schedule and reducers delivered. The critical-path
# view reads its in-flight epochs, the run ledger its shape. It is keyed by
# the multi-job service's job: concurrent ``shuffle()`` calls each own an
# entry, and the eviction fence is the union of the running jobs' windows.
# A run outside a job has the one entry "_default" and the JAX package's
# single-job shape. A handful of updates an epoch, so it stays on.

_live_lock = threading.Lock()
_DEFAULT_JOB_KEY = "_default"
_live_jobs: Dict[str, Dict[str, Any]] = {}
# Each tracked job's delivered batches (object ids; see delivered_ids).
_delivered: Dict[str, set] = {}
_MAX_ENDED_JOBS = 8  # ended entries kept for /status's history


def _in_flight_of(status: Dict[str, Any]) -> List[int]:
    return sorted(int(e) for e, st in (status.get("epochs") or {}).items()
                  if st.get("state") not in ("done", "failed"))


def live_status() -> dict:
    """A JSON-safe snapshot of the current (or last) trial: ``running``,
    ``started_ts``, ``num_epochs``, ``num_files``, ``num_reducers``,
    ``num_trainers``, ``start_epoch``, each epoch's ``state`` (``pending``,
    ``waiting-admission``, ``admitted``, ``running``, ``done``, ``failed``
    or ``suspended``), ``schedule`` and ``delivered_reducers``, and the
    ``in_flight_epochs`` (neither done nor failed); ``ended_ts`` and
    ``error`` once it ended. With jobs of the multi-job service, the top
    level is the newest running job's, ``running`` is whether any job
    runs, ``in_flight_epochs`` is the union over the running jobs, and
    ``jobs`` holds each tracked job's view. The JAX package's shape."""
    with _live_lock:
        jobs: Dict[str, Dict[str, Any]] = {}
        for key, st in _live_jobs.items():
            top = {k: v for k, v in st.items() if k != "epochs"}
            top["epochs"] = {str(e): dict(es) for e, es in (st.get("epochs") or {}).items()}
            jobs[key] = top
    if not jobs:
        return {"epochs": {}, "in_flight_epochs": []}
    running = [k for k, st in jobs.items() if st.get("running")]
    primary = max(running or jobs, key=lambda k: float(jobs[k].get("started_ts") or 0.0))
    out = dict(jobs[primary])
    for st in jobs.values():
        st["in_flight_epochs"] = _in_flight_of(st)
    out["running"] = bool(running)
    out["in_flight_epochs"] = sorted({e for key in (running or [primary]) for e in jobs[key]["in_flight_epochs"]})
    if len(jobs) > 1 or primary != _DEFAULT_JOB_KEY:
        out["jobs"] = jobs
    return out


def protected_epochs() -> set:
    """The eviction fence: the epochs still in flight (admitted, not yet
    delivered and consumed), whose segments the elastic evictor may neither
    demote nor drop. It reads :func:`live_status`, so the fence and the obs
    plane's ``/status`` agree; with several jobs it is the union of the
    running jobs' windows. Between trials it is empty: whatever is still
    resident is cold and re-made from lineage, and an ended trial's epochs
    (a failed run's stay ``running``) must not stay fenced."""
    status = live_status()
    if not status.get("running"):
        return set()
    return set(status.get("in_flight_epochs") or [])


def delivered_ids() -> set:
    """The object ids of the batches the tracked trials delivered (every
    link of a reducer's output), over every job: one job's start never
    clears another's. Once in a consumer's hands a batch has no lineage: the
    elastic evictor may demote one (it stays readable) but never drops one.
    The fence (:func:`protected_epochs`) ends at an epoch's delivery, and
    its last batches may still wait in the queue then."""
    with _live_lock:
        return set().union(*_delivered.values())


def _status_begin_trial(num_epochs: int, num_files: int, num_reducers: int, num_trainers: int,
                        start_epoch: int, job: Optional[str] = None) -> None:
    key = job or _DEFAULT_JOB_KEY
    with _live_lock:
        if job is None:
            # A run outside a job owns the whole tracker.
            _live_jobs.clear()
            _delivered.clear()
        else:
            ended = sorted((k for k, st in _live_jobs.items() if not st.get("running")),
                           key=lambda k: float(_live_jobs[k].get("ended_ts") or 0.0))
            while len(ended) > _MAX_ENDED_JOBS:
                old = ended.pop(0)
                _live_jobs.pop(old, None)
                _delivered.pop(old, None)
        _live_jobs[key] = dict(running=True, job=key, started_ts=time.time(), num_epochs=num_epochs,
                               num_files=num_files, num_reducers=num_reducers, num_trainers=num_trainers,
                               start_epoch=start_epoch, epochs={})
        _delivered[key] = set()


def _status_epoch(epoch: int, delivered_inc: int = 0, job: Optional[str] = None, **kv) -> None:
    with _live_lock:
        status = _live_jobs.setdefault(job or _DEFAULT_JOB_KEY, {"epochs": {}})
        st = status.setdefault("epochs", {}).setdefault(int(epoch), {"state": "pending", "delivered_reducers": 0})
        if delivered_inc:
            st["delivered_reducers"] = st.get("delivered_reducers", 0) + delivered_inc
        st.update(kv)


def _status_delivered(refs, job: Optional[str] = None) -> None:
    with _live_lock:
        _delivered.setdefault(job or _DEFAULT_JOB_KEY, set()).update(
            ref.object_id for ref in refs if isinstance(ref, ObjectRef))


def _status_end_trial(error: Optional[str] = None, job: Optional[str] = None) -> None:
    with _live_lock:
        status = _live_jobs.setdefault(job or _DEFAULT_JOB_KEY, {"epochs": {}})
        status["running"] = False
        status["ended_ts"] = time.time()
        if error is not None:
            status["error"] = error[:300]


def _ledger_record(status: str, duration_s: Optional[float] = None, error: Optional[str] = None, plan=None,
                   job_id: Optional[str] = None, audit_verdicts=None) -> None:
    """Append the run's record to the run ledger (:mod:`.telemetry.runledger`).
    Reads ``RSDL_RUN_LEDGER`` before the import; a ledger that fails never
    changes the run's outcome (this runs on the failure paths too)."""
    if not os.environ.get("RSDL_RUN_LEDGER"):
        return
    try:
        from ray_shuffling_data_loader_tpu_torch.telemetry import runledger

        runledger.record_run(status, duration_s=duration_s, error=error,
                             plan_label=_label_of_plan(plan) if plan is not None else None, job_id=job_id,
                             audit_verdicts=audit_verdicts)
    except Exception:
        pass


def _clear_plan_state() -> None:
    """Unregister the finished run's plan, if the plan module is loaded
    (never the reason it loads)."""
    import sys

    mod = sys.modules.get("ray_shuffling_data_loader_tpu_torch.runtime.plan")
    if mod is not None:
        mod.set_current(None)


def _apply_task_knobs(knobs: Optional[dict]) -> None:
    """Apply a planned ``native_threads`` in the stage task's process
    (the host kernels read the process default). The other knobs are read
    where they are used."""
    if knobs and knobs.get("native_threads") is not None:
        native.set_num_threads(int(knobs["native_threads"]))


def _knob_decode_threads(knobs: Optional[dict], stage_tasks: int) -> int:
    """Threads for a task's decode: the planned
    ``decode_rowgroup_threads`` when the task was given one, else
    :func:`decode_rowgroup_threads`. Planned values come as arguments:
    a worker's environment dates from its spawn."""
    if knobs and knobs.get("decode_rowgroup_threads") is not None:
        return max(1, int(knobs["decode_rowgroup_threads"]))
    return decode_rowgroup_threads(stage_tasks)


def _stage_fault(stage: str, epoch: int, point: str, published: Sequence[Optional[ObjectRef]] = ()) -> None:
    """The ``task.map`` / ``task.reduce`` fault site at a stage task's entry
    or exit (:mod:`.runtime.faults`). An exit fault frees what the attempt
    published: its retry publishes the same rows again."""
    faults = runtime.faults
    if not faults.enabled():
        return
    try:
        faults.fire(f"task.{stage}", epoch=epoch, point=point)
    except BaseException:
        published = [r for r in published if r is not None]
        if published:
            runtime.get_context().store.free(published)
        raise


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
    plan: Optional[Tuple[str, int]] = None,
    columns: Optional[Sequence[str]] = None,
    knobs: Optional[dict] = None,
    stage_tasks: int = 1,
):
    """Decode one file and group its rows by reducer straight into one
    store segment (:func:`.native.group_rows_multi`, one stable counting
    scatter); returns one row-window ref per reducer (empty windows
    included when the file has few rows). ``plan``: ``shuffle()``'s resolved
    plan (:func:`_file_assignment`). ``columns``: the run's decode
    projection (:func:`_pushdown_columns`; None: every column): only these
    are decoded, partitioned and delivered. ``knobs``: the planned task
    knobs (:func:`_knob_decode_threads`, over ``stage_tasks`` maps).

    ``cache_ref``: take the rows from this decode-cache segment instead of
    Parquet. ``publish_cache``: also write the decoded (and narrowed)
    columns once to a segment of their own and return ``(refs,
    cache_ref)``; a publish that does not fit returns a None cache ref,
    and the file is decoded again in later epochs."""
    _stage_fault("map", epoch, "entry")
    if stats_collector is not None:
        stats_collector.call_oneway("map_start", epoch)
    start = time.perf_counter()
    wall0 = time.time()
    store = runtime.ensure_initialized().store
    prof = telemetry.stage_profiler("map", epoch=epoch, file=file_index)
    if plan is None:
        plan = shuffle_plan_spec()
    new_cache_ref = None
    if cache_ref is not None:
        with prof.phase("window-fetch") as ph:
            batch = store.get_columns(cache_ref)
            ph.add_bytes(batch.nbytes)
    else:
        batch = read_parquet_columns(filename, columns=columns,
                                     rowgroup_threads=_knob_decode_threads(knobs, stage_tasks), prof=prof,
                                     metric_labels={"schedule": "mapreduce", "plan": _label_of_plan(plan)})
        if narrow_to_32:
            with prof.phase("decode:narrow", nbytes=batch.nbytes):
                batch = ColumnBatch({k: _narrow_column(k, v) for k, v in batch.columns.items()})
        if publish_cache:
            with prof.phase("cache-publish", nbytes=batch.nbytes):
                try:
                    # The shared tier's segments account under the
                    # capacity ledger's "cache" tier.
                    new_cache_ref = store.put_columns(
                        batch.columns, ledger_tier="cache" if shared_decode_cache_enabled() else None)
                except OSError:
                    new_cache_ref = None
    end_read = time.perf_counter()
    n = batch.num_rows
    assignment = _file_assignment(seed, epoch, file_index, n, num_reducers, filename, plan)
    try:
        pending = store.create_columns({k: (v.shape, v.dtype) for k, v in batch.columns.items()})
        try:
            with prof.phase("partition-scatter", nbytes=batch.nbytes):
                _, offsets = native.group_rows_multi(batch.columns, assignment, num_reducers, out=pending.columns)
            with prof.phase("publish"):
                refs = pending.publish_slices(
                    [(int(offsets[r]), int(offsets[r + 1])) for r in range(num_reducers)]
                )
        finally:
            pending.abort()  # reclaims the segment if anything above raised
    except BaseException:
        if new_cache_ref is not None:
            store.free(new_cache_ref)  # no caller will learn of it
        raise
    if _audit.enabled():
        # The map side, with the rows this file sends each reducer from the
        # scatter's own offsets: one pass over the key column.
        _audit.record_map(epoch, file_index, batch.columns, per_reducer=np.diff(offsets))
    _metrics.safe_inc("shuffle.map_tasks")
    _metrics.safe_inc("shuffle.map_rows", float(n))
    duration = time.perf_counter() - start
    # Retroactive spans on the worker's timeline: the whole map and its read.
    if telemetry.traced():
        telemetry.record_span("map:read", wall0, end_read - start, cat="shuffle", epoch=epoch, file=file_index,
                              cached=cache_ref is not None)
        telemetry.record_span("map", wall0, duration, cat="shuffle", epoch=epoch, file=file_index, rows=n)
    if stats_collector is not None:
        stats_collector.call_oneway("map_done", epoch, duration, end_read - start)
    _stage_fault("map", epoch, "exit", [*refs, new_cache_ref])
    return (refs, new_cache_ref) if publish_cache else refs


def shuffle_plan(
    file_index: int,
    num_reducers: int,
    epoch: int,
    seed: int,
    cache_ref: ObjectRef,
    stats_collector=None,
    filename: Optional[str] = None,
    plan: Optional[Tuple[str, int]] = None,
) -> List[ObjectRef]:
    """The index schedule's map: the same seeded draw and stable grouping
    as :func:`shuffle_map`, over row indices only. Returns one ref per
    reducer over one ``{"idx"}`` segment: each reducer's row indices in the
    cached file, in file order, the rows the materialized map's partition
    would hold. Column data is not read. ``filename``: the file's path, for
    the footer a block plan reads; ``plan`` as for :func:`shuffle_map`."""
    _stage_fault("map", epoch, "entry")
    if stats_collector is not None:
        stats_collector.call_oneway("map_start", epoch)
    start = time.perf_counter()
    wall0 = time.time()
    store = runtime.ensure_initialized().store
    prof = telemetry.stage_profiler("plan", epoch=epoch, file=file_index)
    n = store.get_columns(cache_ref).num_rows
    end_read = time.perf_counter()
    with prof.phase("plan", nbytes=8 * n):
        assignment = _file_assignment(seed, epoch, file_index, n, num_reducers, filename, plan)
        order, offsets = native.group_order(assignment, num_reducers)
    if _audit.enabled():
        # The index schedule reads no column data; the map side of the
        # digest reads the key column from the cached segment, with the
        # plan's own counts.
        _audit.record_map(epoch, file_index, store.get_columns(cache_ref).columns, per_reducer=np.diff(offsets))
    idx_dtype = np.int32 if n <= _INT32.max else np.int64
    pending = store.create_columns({"idx": ((n,), np.dtype(idx_dtype))})
    try:
        with prof.phase("publish", nbytes=n * np.dtype(idx_dtype).itemsize):
            np.copyto(pending.columns["idx"], order, casting="same_kind")
            refs = pending.publish_slices(
                [(int(offsets[r]), int(offsets[r + 1])) for r in range(num_reducers)]
            )
    finally:
        pending.abort()
    _metrics.safe_inc("shuffle.map_tasks")
    _metrics.safe_inc("shuffle.map_rows", float(n))
    duration = time.perf_counter() - start
    if telemetry.traced():
        telemetry.record_span("map", wall0, duration, cat="shuffle", epoch=epoch, file=file_index, rows=n,
                              schedule="index")
    if stats_collector is not None:
        stats_collector.call_oneway("map_done", epoch, duration, end_read - start)
    _stage_fault("map", epoch, "exit", refs)
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

    def scatter(self, dest: np.ndarray, cols) -> None:
        """Place rows of ``cols`` at output positions ``dest`` (a slice of
        the inverted permutation, so distinct) in head, body and tail: the
        overlapped reduce's write, by :func:`.native.scatter`. A body row
        ``r`` of column ``i`` lies at ``(r // B) * (n_cols * B) + i * B +
        r % B`` of the flat packed body: one position array serves every
        column through a view that starts at ``i * B``."""
        B = self.B
        body_lo, body_hi = self.h, self.h + self.m * B

        def _sub(name, sel):
            src = cols[name]
            return src if sel is None else src[sel]

        if self.head is not None:
            mask = dest < body_lo
            if mask.any():
                sel = None if mask.all() else mask
                idx = dest if sel is None else dest[sel]
                for n in self.names:
                    native.scatter(_sub(n, sel), idx, self.head.columns[n])
        if self.m:
            mask = (dest >= body_lo) & (dest < body_hi)
            if mask.any():
                sel = None if mask.all() else mask
                rel = (dest if sel is None else dest[sel]) - body_lo
                pos = (rel // B) * (self.ncols * B) + rel % B
                flat = self.mat.reshape(-1)
                for i, n in enumerate(self.names):
                    src = _sub(n, sel)
                    if src.dtype != np.int32:
                        src = src.view(np.int32)
                    native.scatter(src, pos, flat[i * B:])
        if self.tail is not None:
            mask = dest >= body_hi
            if mask.any():
                sel = None if mask.all() else mask
                idx = (dest if sel is None else dest[sel]) - body_hi
                for n in self.names:
                    native.scatter(_sub(n, sel), idx, self.tail.columns[n])

    def key_column(self, name: str) -> np.ndarray:
        """The logical values of one column over head, body and tail (the
        audit's input): the body's plane of it flattened in one copy."""
        i = self.names.index(name)
        pieces = []
        if self.head is not None:
            pieces.append(self.head.columns[name])
        if self.m:
            pieces.append(self.mat[:, i, :].reshape(-1).view(self.dtypes[i]))
        if self.tail is not None:
            pieces.append(self.tail.columns[name])
        if not pieces:
            return np.empty(0, self.dtypes[i])
        return pieces[0] if len(pieces) == 1 else np.concatenate(pieces)

    def record_audit(self, epoch: int, reduce_index: int) -> None:
        key = _audit.key_column_name()
        _audit.record_reduce(epoch, reduce_index, {key: self.key_column(key)} if key in self.names else {})

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


def _gather(src, idx: np.ndarray, out: np.ndarray) -> None:
    """``src[idx]`` into ``out``: ``src`` one array (:func:`.native.take`)
    or the parts of one, in order (:func:`.native.take_multi`)."""
    if isinstance(src, list):
        native.take_multi(src, idx, out=out)
    else:
        native.take(src, idx, out=out)


def _permuted_output(store, pack, template, source: Callable[[str], Any], perm: np.ndarray, epoch: int,
                     reduce_index: int, prof):
    """Write ``source(name)[perm]`` for every column of ``template``
    (``source`` gives an array or the list of parts of one, see
    :func:`_gather`): into one columnar segment (returns its ref), or,
    when the reducer packs, into its head, body and tail (returns their
    refs). With the audit armed, the output is digested before it is
    published, as reducer ``reduce_index`` of ``epoch``. ``prof``: the
    task's stage profiler (the ``gather`` and ``publish`` phases)."""
    total = len(perm)
    packed = _packed_output(store, pack, total, template)
    if packed is None:
        pending = store.create_columns({k: ((total, *v.shape[1:]), v.dtype) for k, v in template.items()})
        try:
            with prof.phase("gather") as ph:
                for k, dst in pending.columns.items():
                    _gather(source(k), perm, dst)
                ph.add_bytes(2 * sum(v.nbytes for v in pending.columns.values()))
            if _audit.enabled():
                _audit.record_reduce(epoch, reduce_index, pending.columns)
            with prof.phase("publish"):
                return pending.seal()
        finally:
            pending.abort()
    try:
        chunks = list(packed.chunks())
        with prof.phase("gather") as ph:
            moved = 0
            for k in packed.names:
                src = source(k)
                for lo, hi, views in chunks:
                    _gather(src, perm[lo:hi], views[k])
                    moved += views[k].nbytes
            ph.add_bytes(2 * moved)
        if _audit.enabled():
            packed.record_audit(epoch, reduce_index)
        with prof.phase("publish"):
            return packed.seal()
    finally:
        packed.abort()


def _fetch_window_depth(knobs: Optional[dict] = None) -> int:
    """The windows the overlapped reduce keeps in flight ahead of its
    scatter: the planner's ``fetch_window_depth`` when the task was given
    one, else ``RSDL_FETCH_WINDOW_DEPTH``, default 4 (it also bounds the
    windows cached at once)."""
    if knobs and knobs.get("fetch_window_depth") is not None:
        return max(1, int(knobs["fetch_window_depth"]))
    from ray_shuffling_data_loader_tpu_torch.runtime.store import fetch_window_depth

    return fetch_window_depth(default=4)


def reduce_fetch_overlap_mode() -> str:
    """``RSDL_REDUCE_FETCH_OVERLAP``: ``on``, ``off`` or ``auto`` (the
    default, and any other value)."""
    mode = os.environ.get("RSDL_REDUCE_FETCH_OVERLAP", "auto").strip().lower()
    if mode in ("on", "1", "true"):
        return "on"
    if mode in ("off", "0", "false"):
        return "off"
    return "auto"


def _overlapped_reduce(store, part_refs: Sequence[ObjectRef], counts: List[int], reduce_index: int, epoch: int,
                       seed: int, pack, knobs: Optional[dict], prof):
    """The reduce with its fetches overlapped: windows ``i + 1 .. i +
    depth`` are fetched (the store's prefetch threads) while window ``i``
    is placed. The permutation is inverted once (``inv[perm] = arange``,
    by :func:`.native.scatter`), so window ``i``'s rows land at
    ``out[inv[off_i:off_i+1]]``: ``out[j] = concat[perm[j]]``, the fused
    path's bits. The read-ahead slides: once window ``i`` is mapped its
    cache is dropped (the mapping keeps its pages until it is placed) and
    window ``i + depth`` is asked for, so at most ``depth`` windows are
    cached at once. Returns the output's ref(s), as :func:`shuffle_reduce`.
    ``prof``: the reduce's stage profiler."""
    depth = _fetch_window_depth(knobs)
    store.prefetch(part_refs[:depth], max_parallel=depth)
    dst_off = np.zeros(len(counts) + 1, dtype=np.int64)
    np.cumsum(counts, out=dst_off[1:])
    total = int(dst_off[-1])
    with prof.phase("permute", nbytes=8 * total):
        perm = _reduce_seed(seed, epoch, reduce_index).permutation(total)
        inv = np.empty(total, dtype=np.int64)
        native.scatter(np.arange(total, dtype=np.int64), perm, inv)
    pending = packed = None
    allocated = False
    try:
        for i, ref in enumerate(part_refs):
            with prof.phase("window-fetch") as ph:
                part = store.get_columns(ref, populate=True)
                ph.add_bytes(part.nbytes)
            store.drop_cache([ref])
            if i + depth < len(part_refs):
                store.prefetch([part_refs[i + depth]])
            if not allocated:
                allocated = True
                packed = _packed_output(store, pack, total, part)
                if packed is None:
                    pending = store.create_columns({k: ((total, *v.shape[1:]), v.dtype) for k, v in part.items()})
            lo, hi = int(dst_off[i]), int(dst_off[i + 1])
            if hi > lo:
                with prof.phase("gather", nbytes=2 * part.nbytes):
                    dest = inv[lo:hi]
                    if packed is not None:
                        packed.scatter(dest, part)
                    else:
                        for k, dst in pending.columns.items():
                            native.scatter(part[k], dest, dst)
            del part
        if pending is None and packed is None:
            pending = store.create_columns({})
        if packed is not None:
            if _audit.enabled():
                packed.record_audit(epoch, reduce_index)
            with prof.phase("publish"):
                return packed.seal()
        if _audit.enabled():
            _audit.record_reduce(epoch, reduce_index, pending.columns)
        with prof.phase("publish"):
            return pending.seal()
    finally:
        if pending is not None:
            pending.abort()  # a no-op after the seal
        if packed is not None:
            packed.abort()


def shuffle_reduce(
    reduce_index: int, epoch: int, seed: int, part_refs: Sequence[ObjectRef], pack=None, stats_collector=None,
    knobs: Optional[dict] = None, overlap: Optional[str] = None,
) -> Union[ObjectRef, List[ObjectRef]]:
    """Permute this reducer's partitions, in file order, straight into the
    store: one fused concat and gather per column
    (:func:`.native.take_multi`), with no concatenated copy. Returns the
    output's ref, or with ``pack = (rank-stream start, layout)`` its head,
    body and tail refs (:class:`_PackedOutput`). The inputs stay: the
    epoch frees them once the result has landed; this host's fetched
    copies of foreign ones are dropped, failed or not.

    ``overlap``: the driver's ``RSDL_REDUCE_FETCH_OVERLAP`` (None: this
    process's); ``on``, or ``auto`` when some window would be fetched from
    another host, takes :func:`_overlapped_reduce` (window refs only).
    ``knobs``: the planner's, for its ``fetch_window_depth``."""
    _stage_fault("reduce", epoch, "entry")
    if stats_collector is not None:
        stats_collector.call_oneway("reduce_start", epoch)
    start = time.perf_counter()
    wall0 = time.time()
    store = runtime.ensure_initialized().store
    prof = telemetry.stage_profiler("reduce", epoch=epoch, reducer=reduce_index)
    mode = overlap or reduce_fetch_overlap_mode()
    counts = [_ref_window_rows(r) for r in part_refs]
    parts: list = []
    try:
        if (mode != "off" and all(c is not None for c in counts)
                and (mode == "on" or any(store.needs_fetch(r) for r in part_refs))):
            out = _overlapped_reduce(store, part_refs, counts, reduce_index, epoch, seed, pack, knobs, prof)
            total = sum(counts)
        else:
            # Mapped populated: the gather reads its partitions in a random
            # order, and first touches of pages in a random order cost more
            # than filling the page tables in one call (measured on the host
            # of an H100 machine, tools/torch_port_stage_profile.py).
            with prof.phase("window-fetch") as ph:
                parts = [store.get_columns(r, populate=True) for r in part_refs]
                ph.add_bytes(sum(p.nbytes for p in parts))
            total = sum(p.num_rows for p in parts)
            with prof.phase("permute", nbytes=8 * total):
                perm = _reduce_seed(seed, epoch, reduce_index).permutation(total)
            out = _permuted_output(store, pack, parts[0], lambda k: [p[k] for p in parts], perm, epoch,
                                   reduce_index, prof)
    finally:
        del parts  # the mappings go before their caches
        store.drop_cache(list(part_refs))
    _count_reduce(wall0, start, total, epoch, reduce_index, "mapreduce")
    if stats_collector is not None:
        stats_collector.call_oneway("reduce_done", epoch, time.perf_counter() - start)
    _stage_fault("reduce", epoch, "exit", out if isinstance(out, list) else [out])
    return out


def _count_reduce(wall0: float, start: float, rows: int, epoch: int, reduce_index: int, schedule: str) -> None:
    """A reduce's ``shuffle.reduce_tasks`` and ``shuffle.reduce_rows``, and
    its retroactive ``reduce`` span on the worker's timeline."""
    _metrics.safe_inc("shuffle.reduce_tasks")
    _metrics.safe_inc("shuffle.reduce_rows", float(rows))
    if telemetry.traced():
        telemetry.record_span("reduce", wall0, time.perf_counter() - start, cat="shuffle", epoch=epoch,
                              reducer=reduce_index, schedule=schedule)


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
    _stage_fault("reduce", epoch, "entry")
    if stats_collector is not None:
        stats_collector.call_oneway("reduce_start", epoch)
    start = time.perf_counter()
    wall0 = time.time()
    store = runtime.ensure_initialized().store
    prof = telemetry.stage_profiler("gather-reduce", epoch=epoch, reducer=reduce_index)
    try:
        with prof.phase("window-fetch") as ph:
            caches = [store.get_columns(r) for r in cache_refs]
            idx_parts = [store.get_columns(r)["idx"] for r in idx_refs]
            ph.add_bytes(sum(ix.nbytes for ix in idx_parts))
        offsets = np.zeros(len(idx_parts) + 1, dtype=np.int64)
        np.cumsum([len(ix) for ix in idx_parts], out=offsets[1:])
        total = int(offsets[-1])
        with prof.phase("permute", nbytes=8 * total):
            perm = _reduce_seed(seed, epoch, reduce_index).permutation(total)
        template = caches[0]

        def source(k: str) -> np.ndarray:
            # One near-sequential take per file (its windows ascend), then
            # the permutation runs over this compact 1/R of the data.
            compact = np.empty((total, *template[k].shape[1:]), template[k].dtype)
            for i, (idx, cache) in enumerate(zip(idx_parts, caches)):
                native.take(cache[k], idx, out=compact[offsets[i] : offsets[i + 1]])
            return compact

        out = _permuted_output(store, pack, template, source, perm, epoch, reduce_index, prof)
    finally:
        # Only the index windows' fetched copies go: the file caches serve
        # every epoch.
        caches = idx_parts = None
        store.drop_cache(list(idx_refs))
    _count_reduce(wall0, start, total, epoch, reduce_index, "index")
    if stats_collector is not None:
        stats_collector.call_oneway("reduce_done", epoch, time.perf_counter() - start)
    _stage_fault("reduce", epoch, "exit", out if isinstance(out, list) else [out])
    return out


# -- the selective schedule ----------------------------------------------------------


def selective_reads_decision(
    plan: Optional[Tuple[str, int]] = None, planned: Optional[bool] = None
) -> Tuple[bool, str]:
    """``(engage, reason)`` of ``RSDL_SELECTIVE_READS`` (default off) for
    the selective schedule. ``auto`` engages only under a prunable plan
    (:func:`plan_is_prunable`): under rowwise every reducer's selection
    holds every row group, so each file would be decoded about R times an
    epoch, and ``auto`` declines to the materialized schedule, saying so.
    ``on`` forces it under any plan; anything else is off. ``plan``: the
    ``shuffle()``'s resolved plan (None: this process's environment).
    ``planned``: the plan compiler's decision, taken only when the
    variable is unset, and then only under a prunable plan."""
    plan = plan if plan is not None else shuffle_plan_spec()
    label = _label_of_plan(plan)
    mode = os.environ.get("RSDL_SELECTIVE_READS", "").strip().lower()
    if mode == "" and planned is not None:
        if planned and plan_is_prunable(plan):
            return True, f"planned: engaged (plan={label})"
        if planned:
            return False, f"planned engage declined: plan {label} is not prunable"
        return False, "planned: off"
    if mode in ("1", "on", "true"):
        return True, f"forced on (plan={label})"
    if mode == "auto":
        if plan_is_prunable(plan):
            return True, f"auto: plan {label} is prunable (disjoint per-reducer row-group selections)"
        return False, (
            "auto declined: rowwise plan is not prunable — selective would re-read every row group ~R times; "
            "running the materialized schedule (set RSDL_SHUFFLE_PLAN=block to engage)"
        )
    return False, "off"


def shuffle_selective_plan(
    filename: str,
    file_index: int,
    num_reducers: int,
    epoch: int,
    seed: int,
    plan: Optional[Tuple[str, int]] = None,
    stats_collector=None,
    narrow_to_32: bool = False,
) -> List[int]:
    """The selective schedule's map: the seeded draw over the footer's row
    count, with no data read and nothing written to the store. Returns
    each reducer's rows from this file, for the delivery offsets and the
    packed outputs. With the audit armed it also decodes the audit key
    column alone, for the map side of the digest (``narrow_to_32``: as the
    reduce side narrows it)."""
    _stage_fault("map", epoch, "entry")
    if stats_collector is not None:
        stats_collector.call_oneway("map_start", epoch)
    start = time.perf_counter()
    wall0 = time.time()
    prof = telemetry.stage_profiler("plan", epoch=epoch, file=file_index)
    if plan is None:
        plan = shuffle_plan_spec()
    with prof.phase("decode:io"):
        n = sum(file_row_group_sizes(filename))
    end_read = time.perf_counter()
    with prof.phase("plan", nbytes=8 * n):
        assignment = _file_assignment(seed, epoch, file_index, n, num_reducers, filename, plan)
        counts = np.bincount(assignment, minlength=num_reducers)
    if _audit.enabled():
        try:
            # The key-only side read is the audit's cost: labelled so.
            kb = read_parquet_columns(filename, columns=[_audit.key_column_name()], counted=False, prof=prof,
                                      metric_labels={"schedule": "audit-key", "plan": _label_of_plan(plan)})
            # Digest what the reduce side delivers: narrowing changes a
            # float key's bits, and a map side digested wide would fail a
            # correct strict run.
            cols = {k: _narrow_column(k, v) if narrow_to_32 else v for k, v in kb.columns.items()}
        except Exception:
            cols = {}  # no key column: the audit warns once and skips
        _audit.record_map(epoch, file_index, cols, per_reducer=counts)
    _metrics.safe_inc("shuffle.map_tasks")
    _metrics.safe_inc("shuffle.map_rows", float(n))
    duration = time.perf_counter() - start
    if telemetry.traced():
        telemetry.record_span("map", wall0, duration, cat="shuffle", epoch=epoch, file=file_index, rows=n,
                              schedule="selective")
    if stats_collector is not None:
        stats_collector.call_oneway("map_done", epoch, duration, end_read - start)
    _stage_fault("map", epoch, "exit")
    return [int(c) for c in counts]


def selective_file_selection(
    filename: str,
    file_index: int,
    reduce_index: int,
    num_reducers: int,
    epoch: int,
    seed: int,
    plan: Optional[Tuple[str, int]] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """One file's read for one reducer: ``(row_groups, positions)``, the
    row groups that hold its rows under the seeded plan, and where each of
    its rows, in file order, lies in the decode of just those groups. The
    rows are those the materialized map gives this reducer
    (:func:`_file_assignment`); under a block plan the reducers'
    selections are disjoint."""
    sizes = np.asarray(file_row_group_sizes(filename), dtype=np.int64)
    assignment = _file_assignment(seed, epoch, file_index, int(sizes.sum()), num_reducers, filename, plan)
    mine = np.flatnonzero(assignment == reduce_index)
    offs = np.zeros(len(sizes) + 1, dtype=np.int64)
    np.cumsum(sizes, out=offs[1:])
    g_idx = np.searchsorted(offs, mine, side="right") - 1
    gsel = np.unique(g_idx)
    # Where each selected group starts in the selection's decode.
    base_of = np.zeros(len(sizes), dtype=np.int64)
    acc = 0
    for g in gsel:
        base_of[g] = acc
        acc += int(sizes[g])
    return gsel, base_of[g_idx] + (mine - offs[g_idx])


# (file index, row group) of each decode by this process's selective reduces
# since the stage wrapper last took them (:func:`_run_stage`).
_DECODED_ROWGROUPS: List[Tuple[int, int]] = []


def shuffle_selective_reduce(
    reduce_index: int,
    epoch: int,
    seed: int,
    filenames: Sequence[str],
    num_reducers: int,
    narrow_to_32: bool = False,
    pack=None,
    plan: Optional[Tuple[str, int]] = None,
    stats_collector=None,
    columns: Optional[Sequence[str]] = None,
    knobs: Optional[dict] = None,
) -> Union[ObjectRef, List[ObjectRef]]:
    """The selective schedule's reduce: decode only the row groups that
    hold this reducer's rows (:func:`selective_file_selection`), and of
    them only ``columns`` (the run's projection; None: every column),
    threaded by :func:`_knob_decode_threads`; gather its rows from each in file
    order (:func:`.native.take`) and apply :func:`shuffle_reduce`'s
    permutation, plain or packed: the materialized reducer's output, bit
    for bit, with nothing of the epoch in the store but the outputs.
    A column whose dtype depends on the selection (Arrow decodes an int64
    group with nulls as float64) raises."""
    _stage_fault("reduce", epoch, "entry")
    if stats_collector is not None:
        stats_collector.call_oneway("reduce_start", epoch)
    start = time.perf_counter()
    wall0 = time.time()
    store = runtime.ensure_initialized().store
    prof = telemetry.stage_profiler("selective-reduce", epoch=epoch, reducer=reduce_index)
    if plan is None:
        plan = shuffle_plan_spec()
    labels = {"schedule": "selective", "plan": _label_of_plan(plan)}
    with prof.phase("plan"):
        selections = [
            selective_file_selection(f, i, reduce_index, num_reducers, epoch, seed, plan)
            for i, f in enumerate(filenames)
        ]
    dst_off = np.zeros(len(selections) + 1, dtype=np.int64)
    np.cumsum([len(pos) for _, pos in selections], out=dst_off[1:])
    total = int(dst_off[-1])
    with prof.phase("permute", nbytes=8 * total):
        perm = _reduce_seed(seed, epoch, reduce_index).permutation(total)
    threads = _knob_decode_threads(knobs, num_reducers)
    compact: Optional[Dict[str, np.ndarray]] = None
    for i, (fname, (gsel, pos)) in enumerate(zip(filenames, selections)):
        groups = [int(g) for g in gsel]
        batch = read_parquet_columns(fname, columns=columns, row_groups=groups, rowgroup_threads=threads, prof=prof,
                                     metric_labels=labels)
        _DECODED_ROWGROUPS.extend((i, g) for g in groups)
        if narrow_to_32:
            with prof.phase("decode:narrow", nbytes=batch.nbytes):
                cols = {k: _narrow_column(k, v) for k, v in batch.columns.items()}
        else:
            cols = batch.columns
        if compact is None:
            compact = {k: np.empty((total, *v.shape[1:]), v.dtype) for k, v in cols.items()}
        for k, v in cols.items():
            if k not in compact or v.dtype != compact[k].dtype:
                raise ValueError(
                    f"selective schedule: file {fname!r} decoded column {k!r} as {v.dtype} where an earlier file "
                    f"decoded {compact[k].dtype if k in compact else 'absent'}: selection-dependent dtypes (nullable "
                    "columns) are not supported; run with RSDL_SELECTIVE_READS=off for this dataset"
                )
        lo, hi = int(dst_off[i]), int(dst_off[i + 1])
        if hi > lo:
            with prof.phase("gather") as ph:
                for k, v in cols.items():
                    native.take(v, pos, out=compact[k][lo:hi])
                ph.add_bytes(2 * sum(compact[k][lo:hi].nbytes for k in compact))
        del batch, cols
    compact = compact or {}
    out = _permuted_output(store, pack, compact, compact.__getitem__, perm, epoch, reduce_index, prof)
    _count_reduce(wall0, start, total, epoch, reduce_index, "selective")
    if stats_collector is not None:
        stats_collector.call_oneway("reduce_done", epoch, time.perf_counter() - start)
    _stage_fault("reduce", epoch, "exit", out if isinstance(out, list) else [out])
    return out


def _ref_window_rows(ref) -> Optional[int]:
    """Rows of a window ref; None for a ref over a whole segment."""
    rows = getattr(ref, "rows", None)
    if rows is None:
        return None
    return int(rows[1]) - int(rows[0])


def _audit_deliver(store, out_refs: List[ObjectRef], epoch: int, reducer: int, rank: int,
                   offsets: Dict[int, int]) -> List[ObjectRef]:
    """The delivery side of the audit: digest each piece of one reducer's
    output as it is about to reach the consumer, at the rank's running
    offset (``offsets``, updated). Also where the ``drop-row`` fault
    strikes: the last piece is republished, columnar, one row short, and
    the returned refs replace the real output, so that the defect reaches
    the consumer and must show at reconcile."""
    from ray_shuffling_data_loader_tpu_torch.runtime.store import logical_columns, rows_of

    out_refs = list(out_refs)
    try:
        if out_refs and _audit.take_fault("drop-row", epoch):
            cb = store.get_columns(out_refs[-1])
            nrows = rows_of(cb)
            if nrows > 0:
                cols = logical_columns(cb)
                dropped = store.put_columns({k: np.asarray(cols[k])[: nrows - 1] for k in cols})
                del cb, cols
                store.free(out_refs[-1])
                out_refs[-1] = dropped
            else:
                del cb
        for ref in out_refs:
            cb = store.get_columns(ref)
            offset = offsets.get(rank, 0)
            _audit.record_deliver(epoch, reducer, rank, logical_columns(cb), offset)
            offsets[rank] = offset + rows_of(cb)
            del cb
    except Exception:
        import logging

        logging.getLogger(__name__).warning("audit: delivery digest failed", exc_info=True)
    return out_refs


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


def _pack_starts_from_totals(totals, rank_of: np.ndarray, device_layout: Optional[dict]) -> list:
    """Each reducer's ``(start in its rank's stream, layout)`` from its
    row count; all None without a layout."""
    if device_layout is None:
        return [None] * len(rank_of)
    at: Dict[int, int] = {}
    out = []
    for total, rank in zip(np.asarray(totals).tolist(), rank_of.tolist()):
        out.append((at.get(rank, 0), device_layout))
        at[rank] = at.get(rank, 0) + int(total)
    return out


def _pack_starts(partitions: List[List[ObjectRef]], rank_of: np.ndarray, device_layout: Optional[dict]) -> list:
    """Each reducer's ``(start in its rank's stream, layout)``, from the
    row counts its input windows carry; all None without a layout or when a
    window's count is unknown."""
    totals = []
    for r in range(len(rank_of)):
        rows = [_ref_window_rows(parts[r]) for parts in partitions]
        if any(c is None for c in rows):
            return [None] * len(rank_of)
        totals.append(sum(rows))
    return _pack_starts_from_totals(totals, rank_of, device_layout)


# -- the decode cache, its shared tier, and the schedule policy ---------------------
#
# With RSDL_DECODE_CACHE_SHARED on, a run's decode-cache segments outlive
# it: at its end they are promoted into this process's registry, keyed by
# what they hold (session, file, projection, narrowing), and the next
# run over the same files starts cache-hot. Every claim checks that the
# segment still exists; one that was freed is decoded again, never handed
# out.

_SHARED_CACHE_LOCK = threading.Lock()
_SHARED_CACHE: Dict[tuple, ObjectRef] = {}


def shared_decode_cache_enabled() -> bool:
    """``RSDL_DECODE_CACHE_SHARED``: ``on``, ``1``, ``true`` or ``auto``
    arm the shared tier, ``off``, ``0``, ``false`` or ``no`` leave it off.
    Unset, it is off, but on under the multi-job service (``RSDL_SERVICE``,
    read before the import), whose jobs share decoded files."""
    raw = os.environ.get("RSDL_DECODE_CACHE_SHARED", "").strip().lower()
    if raw in ("1", "on", "true", "auto"):
        return True
    if raw in ("0", "off", "false", "no") or not os.environ.get("RSDL_SERVICE"):
        return False
    from ray_shuffling_data_loader_tpu_torch.runtime import service

    return service.enabled()


def _shared_cache_key(session: str, filename: str, columns: Optional[Sequence[str]], narrow: bool) -> tuple:
    """What one file's cache segment holds: the store session (refs belong
    to one), the file, the projection and the narrowing. Another
    projection or narrowing never reads this segment."""
    path = filename if "://" in filename else os.path.abspath(filename)
    return (session, path, None if columns is None else tuple(columns), bool(narrow))


def shared_decode_cache_clear(free: bool = False) -> None:
    """Drop every entry of the shared registry; ``free``: and free their
    segments."""
    with _SHARED_CACHE_LOCK:
        refs = list(_SHARED_CACHE.values())
        _SHARED_CACHE.clear()
    if free and refs:
        runtime.get_context().store.free(refs)


def _shared_cache_spared() -> set:
    """The object ids of the promoted segments, which outlive their run."""
    with _SHARED_CACHE_LOCK:
        return {ref.object_id for ref in _SHARED_CACHE.values()}


class _DecodeCache:
    """The shuffle's registry of per-file decode-cache segments.

    The first epoch to map file ``i`` publishes its cache; a later epoch's
    map of that file waits on the publishing map and partitions from the
    segment. :meth:`free_all` frees every segment at the end of the run,
    failed or not.

    ``shared_keys`` (one :func:`_shared_cache_key` per file) arms the
    shared tier: claims look in the process's registry first, and the
    resolved segments are promoted into it instead of freed.
    ``shared_hits`` counts the claims that found there a segment another
    run published.

    ``service_job`` (a job of the multi-job service) moves the shared tier
    into the service's registry, keyed by content (``shared_keys`` are then
    :func:`.runtime.service.cache_key` strings): a lookup claims the segment
    for the job, which fences it from the evictor while the job lives, and
    a publish is seen by every process of the session, so that a second job
    over the same files reads them decoded from its first epoch."""

    def __init__(self, enabled: bool, shared_keys: Optional[list] = None, service_job=None):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._futs: dict = {}  # file index -> the publishing map's future
        self._shared_keys = shared_keys
        self._service_job = service_job
        self.shared_hits = 0

    def _shared_get(self, index: int) -> Optional[ObjectRef]:
        """File ``index``'s segment from the shared registry while it
        exists; an entry whose segment is gone is dropped."""
        if self._shared_keys is None:
            return None
        key = self._shared_keys[index]
        if self._service_job is not None:
            from ray_shuffling_data_loader_tpu_torch.runtime import service

            return service.cache_lookup(key, job=self._service_job)
        with _SHARED_CACHE_LOCK:
            ref = _SHARED_CACHE.get(key)
        if ref is None:
            return None
        if runtime.get_context().store.exists(ref):
            return ref
        with _SHARED_CACHE_LOCK:
            if _SHARED_CACHE.get(key) is ref:
                del _SHARED_CACHE[key]
        return None

    def _share(self, index: int, ref: Optional[ObjectRef]) -> None:
        if self._shared_keys is None or ref is None:
            return
        if self._service_job is not None:
            from ray_shuffling_data_loader_tpu_torch.runtime import service

            service.cache_publish(self._shared_keys[index], ref, job=self._service_job)
        else:
            with _SHARED_CACHE_LOCK:
                _SHARED_CACHE[self._shared_keys[index]] = ref

    def claim_or_wait(self, index: int) -> Tuple[Optional[ObjectRef], bool]:
        """``(cache_ref, publish)`` for file ``index``: a live segment of
        the shared tier gives ``(ref, False)``; else the first caller
        gets ``(None, True)`` and publishes, and later callers wait for that
        map and get ``(ref, False)``. A failed publish, or a publishing map
        that failed, means decoding again."""
        if not self.enabled:
            return None, False
        ref = self._shared_get(index)
        if ref is not None:
            with self._lock:
                self.shared_hits += index not in self._futs
            return ref, False
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
        """Every file's cache ref, from the shared tier or once its
        publishing map has resolved (waiting for those still running),
        else None: a file not yet published, or whose publish failed,
        keeps the epoch off the index schedule. A published ref is
        promoted into the shared tier when it is armed."""
        if not self.enabled:
            return None
        refs = []
        hits = 0
        for i in range(num_files):
            ref = self._shared_get(i)
            with self._lock:
                fut = self._futs.get(i)
            if ref is not None:
                hits += fut is None
            else:
                if fut is None:
                    return None
                try:
                    ref = fut.result()[1]
                except Exception:
                    return None
                if ref is None:
                    return None
                self._share(i, ref)
            refs.append(ref)
        with self._lock:
            self.shared_hits += hits
        return refs

    def free_all(self) -> None:
        """Free every published cache segment, waiting for the maps still
        publishing; with the shared tier armed, promote them instead."""
        with self._lock:
            futs, self._futs = dict(self._futs), {}
        refs = []
        for index, fut in futs.items():
            try:
                ref = fut.result()[1]
            except Exception:
                continue
            if ref is None:
                continue
            if self._shared_keys is not None:
                self._share(index, ref)
            else:
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
      row gather (:func:`.native.take`, threaded, the index schedule's hot
      operation; numpy under ``RSDL_DISABLE_NATIVE``) over a
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
            native.take(buf, idx[: 1 << 14])
            t0 = time.perf_counter()
            native.take(buf, idx)
            return buf.nbytes / max(1e-9, time.perf_counter() - t0)

        g_small, g_large = gather_bps(_PROBE_SMALL), gather_bps(_PROBE_LARGE)
        buf = np.arange(_PROBE_LARGE // 8, dtype=np.int64)
        seq = np.arange(len(buf))
        t0 = time.perf_counter()
        native.take(buf, seq)
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


def _dataset_stats_task(
    filenames: List[str], narrow_to_32: bool, columns: Optional[Sequence[str]] = None
) -> Tuple[float, int]:
    """Run in a worker: ``(decoded bytes per row, total rows)``, bytes per
    row from the schema of the first file's first batch (after
    narrowing; of ``columns`` only, the run's projection, when given),
    rows from every file's footer."""
    import pyarrow.parquet as pq

    pf = pq.ParquetFile(filenames[0])
    per_row = 0.0
    wanted = None if columns is None else set(columns)
    for batch in pf.iter_batches(batch_size=1 << 16):
        if batch.num_rows == 0:
            continue
        for col in batch.schema:
            if wanted is not None and col.name not in wanted:
                continue
            dt = np.dtype(col.type.to_pandas_dtype())
            per_row += float((narrowed_dtype(dt) if narrow_to_32 else dt).itemsize)
        break
    if per_row == 0.0:
        raise OSError(f"empty sample from {filenames[0]}")
    total_rows = pf.metadata.num_rows + sum(pq.ParquetFile(f).metadata.num_rows for f in filenames[1:])
    return per_row, int(total_rows)


def _est_decoded_bytes(filenames: List[str], narrow_to_32: bool, columns: Optional[Sequence[str]] = None) -> float:
    """The dataset's decoded size (of ``columns`` only, when given): bytes
    per row times rows (from a worker, :func:`_dataset_stats_task`), plus
    15 % headroom; cached per process and projection. If that fails, the
    files' sizes times a fixed expansion (0.7 narrowed, 1.3 not); an
    unreadable file raises ``OSError``."""
    if not filenames:
        return 0.0
    key = ("est", tuple(filenames), narrow_to_32, None if columns is None else tuple(columns))
    with _PROBE_LOCK:
        if key in _PROBE_CACHE:
            return _PROBE_CACHE[key]
    try:
        per_row, total_rows = runtime.get_context().scheduler.submit(
            _dataset_stats_task, list(filenames), narrow_to_32, None if columns is None else list(columns)
        ).result()
        est = per_row * total_rows * 1.15
    except Exception:
        est = sum(os.path.getsize(f) for f in filenames) * (0.7 if narrow_to_32 else 1.3)
    with _PROBE_LOCK:
        _PROBE_CACHE[key] = est
    return est


def _decode_cache_auto(
    filenames: List[str], num_epochs: int, narrow_to_32: bool = False, columns: Optional[Sequence[str]] = None
) -> bool:
    """``cache_decoded=None``: cache when at least two epochs read the
    files and the estimated decoded size (of the projection ``columns``)
    is under 0.35 of the store's
    budget (room for it beside about two epochs in flight). Off when the
    store has no budget: nothing would absorb a wrong guess."""
    if num_epochs < 2:
        return False
    try:
        est = _est_decoded_bytes(filenames, narrow_to_32, columns)
    except OSError:
        return False
    cap = runtime.get_context().store.capacity_bytes
    if cap is None:
        return False
    return est < 0.35 * cap


def _index_schedule_allowed(
    filenames: List[str], num_reducers: int, narrow_to_32: bool, columns: Optional[Sequence[str]] = None
) -> bool:
    """May a cache-hot epoch take the index schedule?
    ``RSDL_INDEX_SHUFFLE=on|off`` decides; ``auto`` (the default) compares
    the two schedules' modelled epoch times on this host
    (:func:`_probed_host_costs`), for the cache of the projection
    ``columns``:

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
        est_cache = _est_decoded_bytes(filenames, narrow_to_32, columns)
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


def _pushdown_columns(device_layout: Optional[dict], columns: Optional[Sequence[str]]) -> Optional[List[str]]:
    """The run's decode projection, or None (decode every column): the one
    reader of ``RSDL_DECODE_PUSHDOWN``. ``off`` (``0``, ``false``): None.
    ``auto`` (the default): an explicit ``columns``. ``on`` (``1``,
    ``true``): also, without one, the staging layout's columns (the
    operator says that nothing else reads the stream). An empty request
    decodes everything; the result keeps its order with repeats
    dropped. With the audit armed, the audit key is appended."""
    mode = os.environ.get("RSDL_DECODE_PUSHDOWN", "auto").strip().lower()
    if mode in ("off", "0", "false"):
        return None
    need: Optional[List[str]] = None
    if columns is not None:
        need = [str(c) for c in columns]
    elif mode in ("on", "1", "true") and device_layout is not None:
        try:
            need = [str(c) for c in device_layout["columns"]]
        except (KeyError, TypeError):
            return None
    if not need:
        return None
    if _audit.enabled() and _audit.key_column_name() not in need:
        need = need + [_audit.key_column_name()]  # the digests keep folding
    seen: set = set()
    return [c for c in need if not (c in seen or seen.add(c))]


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
    were not re-attached freed one by one. Segments promoted into the
    shared decode-cache tier are spared."""
    from ray_shuffling_data_loader_tpu_torch.runtime import journal as jmod

    store = runtime.get_context().store
    spare = _shared_cache_spared()
    for session in _preempted_sessions(resume_state):
        store.cleanup(session=session, keep=spare)
    if resume_state.identity.get("session") == store.session:
        stale = [jmod.ref_from_json(d) for d in _journaled_ref_dicts(resume_state) if d["id"] not in spare]
        store.free(stale)
        if stale:
            _metrics.safe_inc("recovery.superseded_refs_freed", len(stale))


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
        _metrics.safe_inc("recovery.resume_refs_reattached", stage="decode-cache")


def _count(stats: Optional[Dict[str, Any]], key: str, n: int = 1) -> None:
    """Add to the run's resume counters (``stats["resume"]``)."""
    if stats is not None and n:
        counters = stats.setdefault("resume", {})
        counters[key] = counters.get(key, 0) + n


def _count_recovery(stats: Optional[Dict[str, Any]], epoch: int, key: str, stage: str, task: int,
                    exc: Optional[TaskError] = None) -> None:
    """Count a recovery in the run's ``stats``: ``stage_retries`` or
    ``rematerialized`` by stage, and one ``recovery_log`` entry (epoch,
    what, stage, the file or reducer, and a retry's error type:
    ``FaultInjected``, ``ObjectLostError``, ``WorkerDied``, ...). With
    metrics on, also ``recovery.<key>{stage}`` and a ``recovery`` event."""
    _metrics.safe_inc(f"recovery.{key}", stage=stage)
    telemetry.emit_event("recovery", counter=f"recovery.{key}", stage=stage)
    if stats is None:
        return
    counters = stats.setdefault(key, {})
    counters[stage] = counters.get(stage, 0) + 1
    entry = {"epoch": epoch, "what": key, "stage": stage, "task": task}
    if exc is not None:
        entry["error"] = exc.error_type or type(exc).__name__
    stats.setdefault("recovery_log", []).append(entry)


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


def _run_stage(fn: Callable, native_on: bool, knobs: Optional[dict], args: tuple):
    """Run one stage task in a worker with ``shuffle()``'s choice of host
    kernels and its planned task knobs (:func:`_apply_task_knobs`);
    returns ``(result, counts)``: the task's calls of each host
    kernel, run natively or by numpy, the row groups its selective
    decodes read, and its Parquet decodes' counts (:data:`_DECODE_COUNTS`)."""
    native.set_enabled(native_on)
    _apply_task_knobs(knobs)
    before = native.counts()
    del _DECODED_ROWGROUPS[:]
    _DECODE_COUNTS.update(dict.fromkeys(_DECODE_COUNTS, 0))
    try:
        out = fn(*args)
    finally:
        native.set_enabled(None)
    decoded = list(_DECODED_ROWGROUPS)
    del _DECODED_ROWGROUPS[:]
    return out, {**native.counts_since(before), "rowgroups": decoded, "decode": dict(_DECODE_COUNTS)}


class _StageTask:
    """:func:`_run_stage` of one stage function, as the pool runs it: named
    after that function, so that the pool's in-flight list and the
    worker's ``task:<name>`` span name the stage (``task:shuffle_map``),
    as the JAX package's do."""

    def __init__(self, fn: Callable):
        self.fn = fn
        self.__name__ = fn.__name__

    def __call__(self, native_on: bool, knobs: Optional[dict], args: tuple):
        return _run_stage(self.fn, native_on, knobs, args)


class _StageTally:
    """Sums the counts of an epoch's stage tasks into the run's
    ``stats``: ``native_calls`` and ``plain_calls`` per host kernel; per
    epoch the ``(file, row group)`` pairs that selective reduces
    decoded (``selective_rowgroups``), the row groups and bytes decoded
    from Parquet (``decode_rowgroups``, ``decode_bytes``); and the bytes
    the projection and the selections left out (``decode_bytes_pruned``,
    over the run)."""

    def __init__(self, stats: Optional[Dict[str, Any]], epoch: int):
        self.stats = stats if stats is not None else {}
        self.epoch = epoch
        self._lock = threading.Lock()

    def add(self, counts: dict) -> None:
        with self._lock:
            for key, name in (("native", "native_calls"), ("plain", "plain_calls")):
                total = self.stats.setdefault(name, dict.fromkeys(native.KERNELS, 0))
                for kernel, n in counts[key].items():
                    total[kernel] = total.get(kernel, 0) + n
            if counts["rowgroups"]:
                self.stats.setdefault("selective_rowgroups", {}).setdefault(self.epoch, []).extend(
                    counts["rowgroups"])
            decode = counts["decode"]
            for key, name in (("rowgroups", "decode_rowgroups"), ("bytes", "decode_bytes")):
                per_epoch = self.stats.setdefault(name, {})
                per_epoch[self.epoch] = per_epoch.get(self.epoch, 0) + decode[key]
            self.stats["decode_bytes_pruned"] = self.stats.get("decode_bytes_pruned", 0) + decode["bytes_pruned"]


class _LocalTo:
    """A scheduler whose ``submit`` is its locality submit for ``refs``:
    the task goes to the host that holds most of them."""

    def __init__(self, pool, refs: Sequence[ObjectRef]):
        self._pool, self._refs = pool, refs

    def submit(self, fn: Callable, *args, **kwargs):
        return self._pool.submit_local_to(self._refs, fn, *args, **kwargs)


def _submit_stage(pool, tally: _StageTally, native_on: bool, knobs: Optional[dict], fn: Callable, *args) -> cf.Future:
    """Submit ``fn(*args)`` through :func:`_run_stage`; the returned future
    resolves to ``fn``'s result, and its counts go to ``tally``."""
    inner = pool.submit(_StageTask(fn), native_on, knobs, args)
    outer: cf.Future = cf.Future()

    def done(f):
        try:
            out, counts = f.result()
        except BaseException as exc:
            outer.set_exception(exc)
            return
        tally.add(counts)
        outer.set_result(out)

    inner.add_done_callback(done)
    return outer


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
    plan: Optional[Tuple[str, int]] = None,
    native_on: Optional[bool] = None,
    columns: Optional[Sequence[str]] = None,
    knobs: Optional[dict] = None,
    job=None,
) -> bool:
    """One epoch's maps and reduces on the session's scheduler; each
    reducer's output refs go to its rank in reducer order, then every rank
    gets its end-of-epoch signal. The epoch takes the index schedule when
    every file's cache is hot and :func:`_index_schedule_allowed` agrees,
    else the selective schedule when :func:`selective_reads_decision`
    engages, else the materialized one (``schedule_log`` gets ``(epoch,
    "index" | "selective" | "mapreduce")``). With a ``device_layout``,
    each reducer learns its start in its rank's stream and packs.
    Partitions are freed as their reducer lands, the consumer frees the
    outputs, and a failed epoch frees what its tasks published.
    ``stats["store_peak_bytes"]`` keeps the store's peak, sampled after
    the maps and after each reduce; the stage tasks' host-kernel calls add
    to ``stats["native_calls"]`` and ``stats["plain_calls"]``.

    ``plan``: ``shuffle()``'s resolved plan (None: this process's
    environment); ``native_on``: whether the stage tasks run the host
    kernels (None: :func:`.native.enabled` here); ``columns``: the run's
    decode projection (:func:`_pushdown_columns`; None: every column);
    ``knobs``: the plan compiler's task knobs (None: none), whose
    ``selective`` decides the schedule where ``RSDL_SELECTIVE_READS`` is
    unset. All reach every task as arguments. ``job``: the multi-job
    service's job this epoch runs for (None: none), which keys its live
    status and its ``service.delivered_bytes``.

    ``journal`` (a :class:`~.runtime.journal.RunJournal`): append the
    epoch's barriers. ``est``: the epoch's journaled progress from a
    preempted run: a fully delivered epoch runs no task, a stage whose
    journaled segments survive is re-attached (a selective map's counts
    always are), and reducers below the delivery cursor are not delivered
    again. Returns False when a suspend request stopped the epoch (its
    running reduces journaled), else True."""
    if stats_collector is not None:
        stats_collector.call_oneway("epoch_start", epoch)
    jid = job.job_id if job is not None else None
    ctx = runtime.ensure_initialized()
    store, pool = ctx.store, ctx.scheduler
    if plan is None:
        plan = shuffle_plan_spec()
    if native_on is None:
        native_on = native.enabled()
    overlap = reduce_fetch_overlap_mode()
    tally = _StageTally(stats, epoch)

    def submit(fn, *args, local_to=None):
        target = pool if local_to is None else _LocalTo(pool, local_to)
        return _submit_stage(target, tally, native_on, knobs, fn, *args)

    if decode_cache is None:
        decode_cache = _DecodeCache(enabled=False)
    cache_refs = (
        decode_cache.hot_refs(len(filenames))
        if decode_cache.enabled and _index_schedule_allowed(list(filenames), num_reducers, narrow_to_32, columns)
        else None
    )
    if cache_refs is not None:
        schedule = "index"
    else:
        engage, reason = selective_reads_decision(plan, planned=(knobs or {}).get("selective"))
        schedule = "selective" if engage else "mapreduce"
        if stats is not None:
            stats["selective_reads"] = reason
    selective = schedule == "selective"
    if schedule_log is not None:
        schedule_log.append((epoch, schedule))
    jmod = None
    if journal is not None:
        from ray_shuffling_data_loader_tpu_torch.runtime import journal as jmod
    if est is not None and est.schedule is not None and est.schedule != schedule:
        # Stage results of another schedule do not fit this one's tasks;
        # the cursor holds, as every schedule delivers the same stream.
        pruned = type(est)(est.epoch)
        pruned.schedule, pruned.delivered, pruned.rank_rows = schedule, est.delivered, dict(est.rank_rows)
        est = pruned
    cursor = est.delivered if est is not None else 0
    _status_epoch(epoch, state="running", schedule=schedule, delivered_reducers=cursor, job=jid)
    if journal is not None:
        journal.append("epoch", epoch=epoch, schedule=schedule)
    telemetry.emit_event("epoch.start", epoch=epoch, schedule=schedule, files=len(filenames), reducers=num_reducers)
    if est is not None and cursor >= num_reducers:
        # Delivered whole before the preemption: no map, no reduce.
        _count(stats, "epochs_skipped")
        _metrics.safe_inc("recovery.resume_epochs_skipped")
        for rank in range(num_trainers):
            batch_consumer.producer_done(rank, epoch)
        if journal is not None:
            journal.append("epoch-done", epoch=epoch)
        _status_epoch(epoch, state="done", job=jid)
        telemetry.emit_event("epoch.done", epoch=epoch, _flush=True)
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
            if refs is None:
                _metrics.safe_inc("recovery.resume_reexecuted", stage=stage)
            return None
        _count(stats, f"{stage}s_reattached")
        _metrics.safe_inc(f"recovery.resume_{stage}_skipped")
        return refs

    def attached_map(file_index: int):
        """The journaled result of map ``file_index``, else None: a
        selective map's counts, or partitions whose segments survive."""
        m = (est.maps.get(file_index) or {}) if est is not None else {}
        if not selective:
            return attached(m.get("refs"), "map", num_reducers)
        counts = m.get("counts")
        if counts is None or len(counts) != num_reducers:
            return None
        _count(stats, "maps_reattached")
        _metrics.safe_inc("recovery.resume_map_skipped")
        return [int(c) for c in counts]

    # -- stage recovery ---------------------------------------------------------
    # Every stage task has a bounded re-execution budget (stage_policy). A
    # reduce that lost an input re-runs the map that made it (the lineage);
    # the index schedule's lost decode-cache segment is decoded again; a
    # task that fails every attempt fails the epoch with StageFailedError.
    policy = stage_policy()

    def resubmit_map(i: int, publish: bool = False):
        """A fresh attempt of map ``i``. A materialized map decodes from
        Parquet, never from a cache segment (which may be what was lost),
        and publishes again when the failed attempt was the file's
        publisher; the index schedule plans over the file's current
        cache segment."""
        if schedule == "index":
            return submit(shuffle_plan, i, num_reducers, epoch, seed, cache_refs[i], stats_collector, filenames[i],
                          plan, local_to=[cache_refs[i]])
        if selective:
            return submit(shuffle_selective_plan, filenames[i], i, num_reducers, epoch, seed, plan, stats_collector,
                          narrow_to_32)
        return submit(shuffle_map, filenames[i], i, num_reducers, epoch, seed, narrow_to_32, None, publish,
                      stats_collector, plan, columns, knobs, len(filenames))

    def settle_map(i: int, fut, again: Callable, stage: str, what: str):
        """A map task's result, its attempts bounded by the budget:
        ``again()`` submits the next attempt after a failure."""
        for attempt, backoff in policy.attempts(site="stage.map"):
            try:
                return fut.result()
            except TaskError as exc:
                if attempt >= policy.max_attempts:
                    raise StageFailedError(stage, epoch, attempt,
                                           f"{what} failed after {attempt} attempts:\n{exc}") from exc
                _count_recovery(stats, epoch, "stage_retries", "map", i, exc)
                telemetry.emit_event("stage.retry", stage="map", epoch=epoch, attempt=attempt, file=i,
                                     error=f"{exc.error_type or type(exc).__name__}")
                backoff.backoff(str(exc))
                recover_lost_cache(exc.lost_object_id)
                fut = again()
        raise AssertionError("unreachable: the stage budget has no attempt")

    def regenerate_cache(j: int) -> None:
        """The index schedule lost file ``j``'s decode-cache segment: decode
        it again and publish it, for this epoch's retries and for later
        epochs."""
        _count_recovery(stats, epoch, "rematerialized", "decode-cache", j)
        if telemetry.traced():
            telemetry.instant("recovery:rematerialize", cat="recovery", file=j, cache=True)

        def again():
            return submit(shuffle_map, filenames[j], j, num_reducers, epoch, seed, narrow_to_32, None, True,
                          stats_collector, plan, columns, knobs, len(filenames))

        part_refs, new_cache = settle_map(j, again(), again, "map-rematerialize",
                                          f"decode-cache regeneration of file {j}")
        if new_cache is None:
            raise StageFailedError("map-rematerialize", epoch, 1,
                                   f"decode-cache regeneration for file {j} published nothing (store full?)")
        # The index schedule takes no partitions; what is left of the lost
        # segment goes too.
        store.free([*part_refs, cache_refs[j]])
        cache_refs[j] = new_cache
        decode_cache.register(j, _Resolved((None, new_cache)))

    def recover_lost_cache(lost: Optional[str]) -> None:
        if lost is not None and schedule == "index":
            for j, ref in enumerate(cache_refs):
                if ref.object_id == lost:
                    regenerate_cache(j)
                    return

    def await_map(i: int, fut, publish: bool):
        """Map ``i``'s result, re-executed on failure up to the budget:
        ``(partitions, cache ref or None)``."""

        def again():
            fut = map_futs[i] = resubmit_map(i, publish)
            if publish:
                # Later epochs wait on the new publisher.
                decode_cache.register(i, fut)
            return fut

        out = settle_map(i, fut, again, "map", f"map task for file {i}")
        if publish and out[1] is not None:
            # Into the shared tier now, not at the run's end: a concurrent
            # job of the multi-job service over the same files reads it
            # mid-run. No-op without the shared tier; the first publisher's
            # segment stays.
            decode_cache._share(i, out[1])
        return (out[0], out[1]) if publish else (out, None)

    # Lineage: the map (file) that made each partition window. A window a
    # re-run map made for a reducer that did not take it waits in ``remade``
    # until that reducer lands, or the epoch ends.
    lineage: Dict[str, int] = {}
    remade: Dict[int, List[Optional[ObjectRef]]] = {}
    landed = set()  # reducers whose inputs were freed

    def owner_lost(ref: ObjectRef) -> bool:
        """Is ``ref``'s owner another host that no longer answers?"""
        owner = getattr(ref, "owner", None)
        cluster = runtime.get_context().cluster
        if owner is None or cluster is None or tuple(owner) == store.owner_address:
            return False
        return not cluster.owner_alive(owner)

    def rematerialize(r: int, refs_r: List[ObjectRef], lost: str) -> None:
        """Lineage re-execution for reducer ``r``: re-run the map that made
        the lost window (and, when its host died, every map of that host
        that feeds ``r``, all at once) and swap the new windows into
        ``refs_r``. The lost originals are freed at once."""
        files = [lineage[lost]]
        if owner_lost(refs_r[files[0]]):
            dead = tuple(refs_r[files[0]].owner)
            files += [k for k, ref in enumerate(refs_r)
                      if k != files[0] and ref.owner is not None and tuple(ref.owner) == dead]
        runs = {j: resubmit_map(j) for j in files if remade.get(j, [None] * num_reducers)[r] is None}
        for j, fut in runs.items():
            _count_recovery(stats, epoch, "rematerialized", "map", j)
            if telemetry.traced():
                telemetry.instant("recovery:rematerialize", cat="recovery", file=j, reducer=r)
            new = list(settle_map(j, fut, lambda j=j: resubmit_map(j), "map-rematerialize",
                                  f"lineage re-execution of file {j}"))
            stale = remade.get(j) or []
            # Windows of reducers that landed already are of no use.
            for k in landed:
                stale.append(new[k])
                new[k] = None
            store.free([w for w in stale if w is not None])
            remade[j] = new
        for j in files:
            window, remade[j][r] = remade[j][r], None
            store.free([refs_r[j]])
            lineage[window.object_id] = j
            refs_r[j] = window

    def free_inputs(r: int, refs_r: Optional[List[ObjectRef]] = None) -> None:
        """Reducer ``r`` landed: free its windows, the originals and the
        re-made ones."""
        landed.add(r)
        if selective:
            return
        refs = [parts[r] for parts in partitions] + list(refs_r or [])
        for windows in remade.values():
            if windows[r] is not None:
                refs.append(windows[r])
                windows[r] = None
        store.free(list({ref.object_id: ref for ref in refs}.values()))

    def submit_reduce(r: int, refs_r: Optional[List[ObjectRef]]):
        if schedule == "index":
            return submit(shuffle_gather_reduce, r, epoch, seed, refs_r, cache_refs, pack_for[r], stats_collector,
                          local_to=refs_r)
        if selective:
            return submit(shuffle_selective_reduce, r, epoch, seed, list(filenames), num_reducers, narrow_to_32,
                          pack_for[r], plan, stats_collector, columns, knobs)
        return submit(shuffle_reduce, r, epoch, seed, refs_r, pack_for[r], stats_collector, knobs, overlap,
                      local_to=refs_r)

    def await_reduce(r: int):
        """Reducer ``r``'s output, re-executed on failure up to the budget:
        a lost input is re-made from its lineage first (the selective
        schedule's inputs are Parquet files: a plain resubmit), a lost
        cache segment decoded again; returns the output and the inputs it
        read."""
        refs_r = None if selective else [parts[r] for parts in partitions]
        for attempt, backoff in policy.attempts(site="stage.reduce"):
            try:
                return reduce_futs[r].result(), refs_r
            except TaskError as exc:
                if attempt >= policy.max_attempts:
                    raise StageFailedError("reduce", epoch, attempt,
                                           f"reduce task {r} failed after {attempt} attempts:\n{exc}") from exc
                _count_recovery(stats, epoch, "stage_retries", "reduce", r, exc)
                telemetry.emit_event("stage.retry", stage="reduce", epoch=epoch, attempt=attempt, reducer=r,
                                     error=f"{exc.error_type or type(exc).__name__}")
                backoff.backoff(str(exc))
                lost = exc.lost_object_id
                if lost is not None and lost in lineage and not selective:
                    rematerialize(r, refs_r, lost)
                else:
                    recover_lost_cache(lost)
                reduce_futs[r] = submit_reduce(r, refs_r)
        raise AssertionError("unreachable: the stage budget has no attempt")

    try:
        with telemetry.scope(epoch=epoch, schedule=schedule):
            map_futs, publishing, attached_maps = [], [], set()
            for file_index, filename in enumerate(filenames):
                result = attached_map(file_index)
                if result is not None:
                    map_futs.append(_Resolved(result))
                    publishing.append(False)
                    attached_maps.add(file_index)
                    continue
                if schedule == "index":
                    fut = submit(
                        shuffle_plan, file_index, num_reducers, epoch, seed, cache_refs[file_index], stats_collector,
                        filename, plan, local_to=[cache_refs[file_index]],
                    )
                    publish = False
                elif selective:
                    fut = submit(shuffle_selective_plan, filename, file_index, num_reducers, epoch, seed, plan,
                                 stats_collector, narrow_to_32)
                    publish = False
                else:
                    cache_ref, publish = decode_cache.claim_or_wait(file_index)
                    fut = submit(
                        shuffle_map, filename, file_index, num_reducers, epoch, seed, narrow_to_32, cache_ref, publish,
                        stats_collector, plan, columns, knobs, len(filenames),
                        local_to=[cache_ref] if cache_ref is not None else None,
                    )
                    if publish:
                        decode_cache.register(file_index, fut)
                map_futs.append(fut)
                publishing.append(publish)
            # Per file: one window ref per reducer, or a selective map's counts.
            partitions: list = []
            reduce_futs: list = []
            pack_for: list = []
            delivered = 0
            completed = True
            try:
                with telemetry.span("deliver:wait-maps", cat="shuffle"):
                    for i, (fut, publish) in enumerate(zip(map_futs, publishing)):
                        parts_i, cache_ref = await_map(i, fut, publish)
                        partitions.append(parts_i)
                        if not selective:
                            lineage.update((ref.object_id, i) for ref in parts_i)
                        if journal is not None and i not in attached_maps:
                            # The task-done barrier: only the attempt that succeeded.
                            rec = ({"counts": list(parts_i)} if selective
                                   else {"refs": [jmod.ref_to_json(x) for x in parts_i]})
                            if cache_ref is not None:
                                rec["cache_ref"] = jmod.ref_to_json(cache_ref)
                            journal.append("map", epoch=epoch, file=i, **rec)
                sample()
                rank_of = rank_of_reducers(num_reducers, num_trainers)
                if selective:
                    totals = np.sum(np.asarray(partitions, dtype=np.int64).reshape(len(filenames), num_reducers),
                                    axis=0)
                    pack_for = _pack_starts_from_totals(totals, rank_of, device_layout)
                else:
                    pack_for = _pack_starts(partitions, rank_of, device_layout)
                attached_reduces = set()
                for r in range(num_reducers):
                    refs = attached(est.reduces.get(r), "reduce") if est is not None and r >= cursor else None
                    if r < cursor or refs is not None:
                        # Delivered already, or its output survived: the inputs go.
                        free_inputs(r)
                        reduce_futs.append(None if r < cursor else _Resolved(refs))
                        if refs is not None:
                            attached_reduces.add(r)
                    else:
                        reduce_futs.append(submit_reduce(r, None if selective else [parts[r] for parts in partitions]))
                _count(stats, "reducers_skipped", cursor)
                delivered = cursor
                # Each rank's rows delivered so far: the audit's stream offsets. A
                # resume starts from the journaled rows, so that the epoch's seq
                # digests fold on from where the preempted run stopped.
                audit_offsets: Dict[int, int] = dict(est.rank_rows) if est is not None else {}
                for r in range(cursor, num_reducers):
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
                    out, refs_r = await_reduce(r)
                    out = out if isinstance(out, list) else [out]
                    sample()
                    if r not in attached_reduces:
                        free_inputs(r, refs_r)
                        if journal is not None:
                            journal.append("reduce", epoch=epoch, reducer=r, refs=[jmod.ref_to_json(x) for x in out])
                    if runtime.faults.enabled():
                        # A stalled (or killed) delivery thread.
                        runtime.faults.fire("queue.producer", epoch=epoch)
                    rank = int(rank_of[r])
                    offset_before = audit_offsets.get(rank, 0)
                    if _audit.enabled():
                        out = _audit_deliver(store, out, epoch, r, rank, audit_offsets)
                    _status_delivered(out, job=jid)
                    with telemetry.span("deliver", cat="queue", rank=rank, reducer=r):
                        if consume_seq:
                            batch_consumer.consume(rank, epoch, out, seq=r)
                        else:
                            batch_consumer.consume(rank, epoch, out)
                    _status_epoch(epoch, delivered_inc=1, job=jid)
                    if jid is not None:
                        # The per-job delivery rate, in bytes: a whole-segment
                        # output has no row window to count without a read.
                        _metrics.safe_inc("service.delivered_bytes", float(sum(ref.nbytes for ref in out)), job=jid)
                    if journal is not None and journal.resume_pending:
                        # The resumed run's first delivery.
                        journal.resume_pending = False
                        jmod.set_resume_in_progress(False)
                    if journal is not None:
                        if _audit.enabled():
                            # Write-ahead: the digests are on the spool before the
                            # cursor says delivered; a crash between the two
                            # delivers this reducer again, which the reconcile's
                            # dedup absorbs.
                            _audit.safe_flush()
                            rows, sampled = audit_offsets.get(rank, 0) - offset_before, _audit.sample_count(epoch)
                        else:
                            rows, sampled = sum(_ref_window_rows(ref) or 0 for ref in out), 0
                            # The offsets fold with the audit off too: a later
                            # audited resume starts from them.
                            audit_offsets[rank] = offset_before + rows
                        journal.append("deliver", epoch=epoch, reducer=r, rank=rank, rows=int(rows),
                                       sampled=int(sampled))
                    if stats_collector is not None:
                        stats_collector.call_oneway("consume", rank, epoch, sum(ref.nbytes for ref in out))
                    delivered = r + 1
            except BaseException as exc:
                    # Every rank gets its end of the epoch, failed or not, so that no
                # consumer waits for batches that will not come; a consumer that
                # can hold the error hears it first.
                failed = getattr(batch_consumer, "producer_failed", None)
                if failed is not None:
                    failed(epoch, exc)
                for rank in range(num_trainers):
                    try:
                        batch_consumer.producer_done(rank, epoch)
                    except Exception:
                        pass
                for fut in reduce_futs[delivered:]:
                    if fut is not None and not isinstance(fut, _Resolved):
                        _reclaim(store, fut)
                if not selective:  # a selective map publishes nothing
                    for fut, publish in zip(map_futs[len(partitions):], publishing[len(partitions):]):
                        _reclaim(store, fut, unwrap=publish)  # its cache segment is the decode cache's
                raise
            finally:
                if not selective:
                    for parts in partitions:
                        store.free(parts)
                    store.free([w for windows in remade.values() for w in windows if w is not None])
            for rank in range(num_trainers):
                batch_consumer.producer_done(rank, epoch)
            if journal is not None and completed:
                journal.append("epoch-done", epoch=epoch)
    except BaseException as exc:
        _status_epoch(epoch, state="failed", job=jid)
        # Outside the epoch's context, as the JAX package emits it.
        telemetry.emit_event("epoch.failed", _flush=True, epoch=epoch, error=f"{type(exc).__name__}: {exc}"[:200])
        raise
    _status_epoch(epoch, state="done" if completed else "suspended", job=jid)
    if completed:
        telemetry.emit_event("epoch.done", epoch=epoch, _flush=True)
    return completed


def shuffle(
    filenames: Sequence[str],
    batch_consumer: BatchConsumer,
    num_epochs: int,
    num_reducers: int,
    num_trainers: int,
    seed: int = 0,
    stats_collector=None,
    start_epoch: int = 0,
    narrow_to_32: bool = False,
    cache_decoded: Optional[bool] = None,
    schedule_log: Optional[list] = None,
    device_layout: Optional[dict] = None,
    columns: Optional[Sequence[str]] = None,
    resume_from: Optional[str] = None,
    stats: Optional[Dict[str, Any]] = None,
) -> float:
    """Shuffle every epoch from ``start_epoch`` into ``batch_consumer``;
    each epoch first waits for the consumer to admit it. Returns the
    run's seconds. The parameters are the JAX package's, in its order,
    then the port's own ``stats``.

    ``stats_collector``: a
    :class:`~.stats.TrialStatsCollector` handle that hears the run's
    events (module docstring), ``trial_done`` with the run's seconds
    last. ``cache_decoded``: keep each file's decoded columns in the store after
    the first epoch, so later epochs skip Parquet (None: on when at least
    two epochs run and the estimate fits the store's budget,
    :func:`_decode_cache_auto`); a hot cache also lets later epochs take
    the index schedule. With ``RSDL_DECODE_CACHE_SHARED`` on, the cache
    outlives the run for the next one over the same files, projection and
    narrowing (:func:`shared_decode_cache_enabled`). ``schedule_log``:
    each epoch appends ``(epoch,
    "index" | "selective" | "mapreduce")``. ``device_layout``: a staging
    consumer's ``{"batch": B, "columns": [...]}``; reducers then pack their
    whole batches (unless ``RSDL_DEVICE_DIRECT=off``). ``columns``: decode
    only these columns; the stream then holds exactly them
    (:func:`_pushdown_columns` says when a projection applies, and
    ``RSDL_DECODE_PUSHDOWN=on`` also takes one from the layout).

    ``resume_from``: resume a preempted run from its journal: ``"auto"``
    (or ``RSDL_RESUME=auto``) finds the newest resumable run under
    ``RSDL_JOURNAL`` whose identity (the resolved projection included)
    matches this call, ``"redeliver"``
    re-attaches as ``"auto"`` does but delivers the whole stream again
    (for a consumer that restarted), and a path names a journal file or
    directory, refused on a mismatch. With
    ``RSDL_JOURNAL`` set, every run journals its window, and on the main
    thread SIGTERM suspends it (:mod:`.runtime.journal`).

    ``stats``: the resolved ``cache_decoded``, the resolved ``plan`` label
    and the ``selective_reads`` decision's reason, the resolved projection
    (``columns``), the epoch in progress
    (``epoch``), each epoch's shuffle seconds (``epoch_shuffle_s``,
    admission excluded), the store's peak bytes, the stage tasks'
    host-kernel calls (``native_calls``, ``plain_calls``: per kernel of
    :mod:`.native`), the row groups each selective epoch decoded
    (``selective_rowgroups``: epoch -> ``(file, row group)`` pairs), the
    row groups and bytes each epoch decoded from Parquet
    (``decode_rowgroups``, ``decode_bytes``: epoch -> count) and the bytes
    the projection and the selections spared (``decode_bytes_pruned``),
    the files whose cache came from the shared tier
    (``shared_cache_hits``), under the plan compiler its terms
    (``plan_terms``) and the re-planner's changes (``plan_replans``), and
    on a journaled run its ``journal`` path and the ``resume`` counters
    (stages re-attached and re-executed, epochs and reducers skipped),
    and with the audit armed the seconds of its reconcile
    (``audit_reconcile_s``; the verdicts are :func:`.telemetry.audit.verdicts`);
    its recoveries: ``stage_retries`` and ``rematerialized`` by stage, and
    the ``recovery_log`` (:func:`_count_recovery`).

    The plan (``RSDL_SHUFFLE_PLAN``) and the choice of host kernels
    (``RSDL_DISABLE_NATIVE``) are read here, once, and handed to every
    stage task; the kernels are built here if they are not yet. A
    malformed plan raises ``ValueError`` before any task starts. Under
    ``RSDL_PLAN=auto`` (or ``on``) the plan compiler
    (:func:`.analysis.planner.compile_plan`) decides the knobs the
    environment leaves unset: the plan, the selective schedule, the
    projection and the tasks' threads; :func:`.analysis.planner.replan`
    may change some between epochs.

    Under the multi-job service (``RSDL_SERVICE``) the call runs as a job:
    the ambient one (:func:`.runtime.service.job_context`), else one it
    registers and ends on return. The job keys the live status, the audit's
    digests, the journal's run identity (by name) and the ledger's
    attribution; the stage tasks take their fair share of the pool beside
    other jobs', each epoch after the first is admitted against the shared
    shm budget, and the decode cache is shared with other jobs by content.
    With ``RSDL_SERVICE`` unset none of this runs and the module is not
    imported."""
    service = job = None
    own_job = False
    if os.environ.get("RSDL_SERVICE"):
        from ray_shuffling_data_loader_tpu_torch.runtime import service

        if service.enabled():
            job = service.current_job()
            if job is None:
                job = service.register_job()
                own_job = True
    try:
        with service.job_context(job) if job is not None else contextlib.nullcontext():
            return _shuffle_impl(
                filenames, batch_consumer, num_epochs, num_reducers, num_trainers, seed=seed,
                stats_collector=stats_collector, start_epoch=start_epoch, narrow_to_32=narrow_to_32,
                cache_decoded=cache_decoded, schedule_log=schedule_log, device_layout=device_layout, columns=columns,
                resume_from=resume_from, stats=stats, job=job,
            )
    finally:
        if own_job:
            service.end_job(job)


def _shuffle_impl(
    filenames: Sequence[str],
    batch_consumer: BatchConsumer,
    num_epochs: int,
    num_reducers: int,
    num_trainers: int,
    seed: int = 0,
    stats_collector=None,
    start_epoch: int = 0,
    narrow_to_32: bool = False,
    cache_decoded: Optional[bool] = None,
    schedule_log: Optional[list] = None,
    device_layout: Optional[dict] = None,
    columns: Optional[Sequence[str]] = None,
    resume_from: Optional[str] = None,
    stats: Optional[Dict[str, Any]] = None,
    job=None,
) -> float:
    """:func:`shuffle`'s body; ``job``: the service's job, ambient already,
    or None."""
    jid = job.job_id if job is not None else None
    # The jobs whose records the audit reconciles: this one, or under a
    # journaled resume every attempt of the chain (a preempted attempt's
    # records carry its own id).
    audit_scope = jid
    plan = shuffle_plan_spec()
    native_on = native.enabled()
    if native_on:
        native.ensure_built()
    start = time.perf_counter()
    filenames = list(filenames)
    _status_begin_trial(num_epochs, len(filenames), num_reducers, num_trainers, start_epoch, job=jid)
    telemetry.emit_event("trial.start", epochs=num_epochs, files=len(filenames), reducers=num_reducers,
                         trainers=num_trainers, start_epoch=start_epoch)
    if os.environ.get("RSDL_OBS_PORT"):
        # The live trial on the obs server's /status; imported only when
        # the server is configured.
        try:
            from ray_shuffling_data_loader_tpu_torch.telemetry import obs_server

            obs_server.register_status_provider("shuffle", live_status)
        except Exception:
            pass
    device_layout = _device_layout_allowed(device_layout)
    rplan = planner = task_knobs = None
    if _plan_enabled():
        from ray_shuffling_data_loader_tpu_torch.analysis import planner
        from ray_shuffling_data_loader_tpu_torch.runtime import plan as plan_state

        runtime.ensure_initialized()
        rplan = planner.compile_plan(
            filenames, num_reducers=num_reducers, num_trainers=num_trainers, num_epochs=num_epochs,
            start_epoch=start_epoch, columns=columns, device_layout=device_layout, narrow_to_32=narrow_to_32,
            cache_decoded=cache_decoded,
        )
        plan = rplan.plan
        if columns is None and rplan.projection is not None:
            columns = list(rplan.projection)
        task_knobs = rplan.task_knobs()
        plan_state.set_current(rplan)
        telemetry.emit_event("plan.chosen", plan=_label_of_plan(plan), terms=rplan.terms_dict())
        _metrics.safe_inc("plan.compiled", plan=_label_of_plan(plan))
        if stats is not None:
            stats["plan_terms"] = rplan.terms_dict()
            stats["plan_replans"] = []
    columns = _pushdown_columns(device_layout, columns)
    # Imported only when asked for: with RSDL_JOURNAL unset and no
    # resume_from the journal module never loads and no handler is set.
    jmod = journal = resume_state = audit_verdicts = None
    try:
        if resume_from is not None or os.environ.get("RSDL_JOURNAL"):
            from ray_shuffling_data_loader_tpu_torch.runtime import journal as jmod

            if job is not None and job.name == "job":
                # The journal tells tenants apart by job name (an id changes
                # at every restart): two same-shaped tenants of the default
                # name in one journal directory would share an identity.
                logging.getLogger(__name__).warning(
                    "journaled service run with the default job name 'job': concurrent same-shaped tenants in this "
                    "journal dir would share a run identity; set RSDL_JOB_NAME (or register_job(name=...)) per "
                    "tenant")
            identity = jmod.run_identity(
                filenames, num_epochs, num_reducers, num_trainers, seed, start_epoch, narrow_to_32,
                _label_of_plan(plan), columns, device_layout, job=job.name if job is not None else None,
            )
            resume_state, resume_mode = jmod.resolve_resume(resume_from, identity)
            if jid is not None:
                # The ids of the resume chain ride the identity (not
                # validated), so that a twice-preempted run still folds its
                # first attempt's records.
                prev_jobs = [str(j) for j in (resume_state.identity.get("audit_jobs") or [])] if resume_state else []
                identity["audit_jobs"] = prev_jobs + [jid]
                if prev_jobs:
                    audit_scope = identity["audit_jobs"]
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
                journal.resume_pending = True
                jmod.set_resume_in_progress(True)
                _metrics.safe_inc("recovery.resume_runs")
                telemetry.emit_event("run.resumed", _flush=True, run_id=journal.run_id, from_run=resume_state.run_id,
                                     mode=resume_mode, epochs_with_progress=len(resume_state.epochs))
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
        if _audit.enabled():
            # Earlier runs' records would fold into this run's digests. A
            # resume keeps the spool, whose records of the preempted run are
            # this run's first half, and its rank-0 sample counts.
            _audit.begin_run(carry=resume_state is not None, job=jid)
            if resume_state is not None:
                for e, st in resume_state.epochs.items():
                    if st.sampled:
                        _audit.seed_sample_count(e, st.sampled)
        if cache_decoded is None:
            cache_decoded = _decode_cache_auto(filenames, num_epochs - start_epoch, narrow_to_32, columns)
        if stats is not None:
            stats["cache_decoded"] = cache_decoded
            stats["plan"] = _label_of_plan(plan)
            stats["columns"] = columns
            stats.setdefault("epoch_shuffle_s", [])
        shared_keys = None
        if cache_decoded and shared_decode_cache_enabled():
            if job is not None:
                # The service's content keys, in the session's registry:
                # another job over the same files (in any process of the
                # session) reads these segments, and its claims fence them
                # from the evictor.
                from ray_shuffling_data_loader_tpu_torch.runtime import service

                shared_keys = [service.cache_key(f, columns, narrow_to_32) for f in filenames]
            else:
                session = runtime.ensure_initialized().store.session
                with _SHARED_CACHE_LOCK:
                    # Entries of another session are unreachable: their
                    # segments went with that session's clean-up.
                    for key in [k for k in _SHARED_CACHE if k[0] != session]:
                        del _SHARED_CACHE[key]
                shared_keys = [_shared_cache_key(session, f, columns, narrow_to_32) for f in filenames]
        decode_cache = _DecodeCache(enabled=cache_decoded, shared_keys=shared_keys,
                                    service_job=job if shared_keys is not None else None)
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
                    _status_epoch(epoch, state="waiting-admission", job=jid)
                    if job is not None:
                        # The service's admission: a new window waits while
                        # the shared shm budget is over the watermark and
                        # another job is live, bounded. The port runs its
                        # epochs one after another, so the window still in
                        # flight is the previous epoch's, its batches in the
                        # consumer's queue: none before the run's first.
                        from ray_shuffling_data_loader_tpu_torch.runtime import service

                        service.admit_epoch(job, epoch, int(epoch > start_epoch))
                    with telemetry.scope(epoch=epoch), telemetry.span("epoch:admission", cat="queue"):
                        batch_consumer.wait_until_ready(epoch)
                    _status_epoch(epoch, state="admitted", job=jid)
                    t0 = time.perf_counter()
                    if stats_collector is not None:
                        stats_collector.call_oneway("epoch_throttle", epoch, t0 - throttle_start)
                    if rplan is not None and epoch > start_epoch:
                        changes = planner.replan(rplan, epoch=epoch)
                        if changes:
                            task_knobs = rplan.task_knobs()
                            if stats is not None:
                                stats["plan_replans"].extend({"epoch": epoch, **c} for c in changes)
                                stats["plan_terms"] = rplan.terms_dict()
                    est = resume_state.epochs.get(epoch) if resume_state is not None else None
                    if est is not None:
                        _metrics.safe_inc("recovery.resumed_epochs")
                    completed = shuffle_epoch(
                        epoch, filenames, batch_consumer, num_reducers, num_trainers, seed,
                        narrow_to_32=narrow_to_32, decode_cache=decode_cache, schedule_log=schedule_log,
                        device_layout=device_layout, stats=stats, stats_collector=stats_collector,
                        journal=journal, est=est, plan=plan, native_on=native_on, columns=columns, knobs=task_knobs,
                        job=job,
                    )
                    if stats is not None:
                        stats["shared_cache_hits"] = decode_cache.shared_hits
                    if not completed:
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
                telemetry.emit_event("run.suspended", _flush=True, run_id=journal.run_id, journal=journal.path)
                _metrics.safe_inc("recovery.suspended_runs")
                _status_end_trial(error="suspended", job=jid)
                # Before a suspend that exits the process.
                _ledger_record("suspended", duration_s=time.perf_counter() - start, plan=plan, job_id=jid)
                # No resume is in progress once the run is suspended.
                jmod.set_resume_in_progress(False)
                if jmod.suspend_should_exit():
                    jmod.suspend_and_exit(journal)  # exits 0
                jmod.end_run(journal, status="suspended")
                raise jmod.RunSuspended(journal.path)
            batch_consumer.wait_until_all_epochs_done()
            if _audit.enabled():
                # Every stage task flushed its records before its result
                # was seen (the task-done barrier) and the consumer acked
                # every batch: every side is in.
                t_audit = time.perf_counter()
                audit_verdicts = verdicts = _audit.reconcile(
                    range(start_epoch, num_epochs), stats_collector=stats_collector, plan_label=_label_of_plan(plan),
                    job=audit_scope,
                )
                if stats is not None:
                    stats["audit_reconcile_s"] = time.perf_counter() - t_audit
                if journal is not None:
                    # The verdicts are what a replay of an epoch is held to.
                    for v in verdicts:
                        journal.append("verdict", **v)
            if journal is not None:
                if resume_state is not None:
                    _sweep_preempted(resume_state)
                jmod.set_resume_in_progress(False)
                jmod.end_run(journal)
        except BaseException as exc:
            if journal is not None and not isinstance(exc, jmod.RunSuspended):
                jmod.set_resume_in_progress(False)
                jmod.end_run(journal, status="failed")  # stays resumable
            if not (jmod is not None and isinstance(exc, jmod.RunSuspended)):
                _status_end_trial(error=f"{type(exc).__name__}: {exc}", job=jid)
                telemetry.emit_event("trial.failed", _flush=True, error=f"{type(exc).__name__}: {exc}"[:200])
                _ledger_record("failed", duration_s=time.perf_counter() - start, error=f"{type(exc).__name__}: {exc}",
                               plan=plan, job_id=jid, audit_verdicts=audit_verdicts)
            raise
        _status_end_trial(job=jid)
        duration = time.perf_counter() - start
        telemetry.emit_event("trial.done", duration_s=round(duration, 3), _flush=True)
        # While the plan's terms are still registered: the record holds them.
        _ledger_record("done", duration_s=duration, plan=plan, job_id=jid, audit_verdicts=audit_verdicts)
    finally:
        _clear_plan_state()
    if stats_collector is not None:
        stats_collector.call_oneway("trial_done", duration)
    return duration
