"""The per-epoch map/reduce shuffle over Parquet files.

For every epoch:

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
its permuted rows into a segment of its own, whose ref the shuffle puts on
the rank's queue. Bulk data never passes through a pipe.

Given the same files, seed and reducer count, the row stream is the one
the JAX package's shuffle delivers under its default settings: the seeds,
the draws and the group-by order are the same.

This module imports numpy and pyarrow only: the workers load it.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ray_shuffling_data_loader_tpu_torch import runtime
from ray_shuffling_data_loader_tpu_torch.batch_queue import BatchQueue
from ray_shuffling_data_loader_tpu_torch.runtime import ColumnBatch, ObjectRef

_INT32 = np.iinfo(np.int32)


def read_parquet_columns(filename: str) -> ColumnBatch:
    """Decode a local Parquet file to contiguous numpy columns."""
    import pyarrow.parquet as pq

    table = pq.read_table(filename, use_threads=False, memory_map=True)
    return ColumnBatch(
        {
            name: np.ascontiguousarray(col.to_numpy(zero_copy_only=False))
            for name, col in zip(table.column_names, table.columns)
        }
    )


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


def check_shuffle_plan() -> None:
    """Only the rowwise plan family is ported: ``RSDL_SHUFFLE_PLAN`` unset
    or ``rowwise`` passes, ``block[:G]`` raises ``NotImplementedError``,
    anything else ``ValueError``."""
    env = os.environ.get("RSDL_SHUFFLE_PLAN", "").strip().lower()
    if env in ("", "rowwise", "row", "off"):
        return
    if env == "block" or env.startswith("block:"):
        raise NotImplementedError(
            f"RSDL_SHUFFLE_PLAN={env!r}: the block plan family is not "
            "ported yet; only 'rowwise' is"
        )
    raise ValueError(f"RSDL_SHUFFLE_PLAN={env!r}: expected 'rowwise' or 'block[:G]'")


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
) -> List[ObjectRef]:
    """Decode one file and group its rows by reducer straight into one
    store segment; returns one row-window ref per reducer (empty windows
    included when the file has few rows)."""
    batch = read_parquet_columns(filename)
    if narrow_to_32:
        batch = ColumnBatch({k: _narrow_column(k, v) for k, v in batch.columns.items()})
    assignment = _file_assignment(seed, epoch, file_index, batch.num_rows, num_reducers)
    order, offsets = _group_order(assignment, num_reducers)
    store = runtime.ensure_initialized().store
    pending = store.create_columns({k: (v.shape, v.dtype) for k, v in batch.columns.items()})
    try:
        for k, v in batch.columns.items():
            np.take(v, order, axis=0, out=pending.columns[k])
        return pending.publish_slices(
            [(int(offsets[r]), int(offsets[r + 1])) for r in range(num_reducers)]
        )
    finally:
        pending.abort()  # reclaims the segment if anything above raised


def shuffle_reduce(
    reduce_index: int, epoch: int, seed: int, part_refs: Sequence[ObjectRef]
) -> ObjectRef:
    """Concatenate this reducer's partitions in file order and permute them
    straight into one store segment; returns its ref. The inputs stay: the
    epoch frees them once the result has landed."""
    store = runtime.ensure_initialized().store
    parts = [store.get_columns(r) for r in part_refs]
    total = sum(p.num_rows for p in parts)
    perm = _reduce_seed(seed, epoch, reduce_index).permutation(total)
    template = parts[0]
    pending = store.create_columns({k: ((total, *v.shape[1:]), v.dtype) for k, v in template.items()})
    try:
        ColumnBatch.concat_take(parts, perm, out=pending.columns)
        return pending.seal()
    finally:
        pending.abort()


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


def shuffle_epoch(
    epoch: int,
    filenames: Sequence[str],
    batch_queue: BatchQueue,
    num_reducers: int,
    num_trainers: int,
    seed: int,
    narrow_to_32: bool = False,
    stats: Optional[Dict[str, int]] = None,
) -> None:
    """One epoch's maps and reduces in the session's worker pool; each
    reducer's output ref goes to its rank in reducer order, then every rank
    gets its end-of-epoch signal. Map partitions are freed as their reducer
    lands; the consumer frees the reducer's output. ``stats`` keeps the
    store's peak bytes, sampled after the maps and after each reduce."""
    ctx = runtime.ensure_initialized()
    store, pool = ctx.store, ctx.pool

    def sample():
        if stats is not None:
            stats["store_peak_bytes"] = max(stats.get("store_peak_bytes", 0), store.store_stats().total_bytes)

    map_futs = [
        pool.submit(shuffle_map, filename, file_index, num_reducers, epoch, seed, narrow_to_32)
        for file_index, filename in enumerate(filenames)
    ]
    partitions: List[List[ObjectRef]] = []
    try:
        for f in map_futs:
            partitions.append(f.result())
        sample()
        reduce_futs = [
            pool.submit(shuffle_reduce, r, epoch, seed, [parts[r] for parts in partitions])
            for r in range(num_reducers)
        ]
        rank_of = rank_of_reducers(num_reducers, num_trainers)
        for r, fut in enumerate(reduce_futs):
            out = fut.result()
            sample()
            store.free([parts[r] for parts in partitions])
            batch_queue.put_batch(int(rank_of[r]), epoch, [out])
    finally:
        # After a failure: the maps still running publish what this cannot
        # free, and the session's cleanup takes those.
        for parts in partitions:
            store.free(parts)
    for rank in range(num_trainers):
        batch_queue.producer_done(rank, epoch)


def shuffle(
    filenames: Sequence[str],
    batch_queue: BatchQueue,
    num_epochs: int,
    num_reducers: int,
    num_trainers: int,
    seed: int = 0,
    start_epoch: int = 0,
    narrow_to_32: bool = False,
    stats: Optional[Dict[str, int]] = None,
) -> None:
    """Shuffle every epoch from ``start_epoch``; each epoch first waits for
    the queue's epoch window to admit it. ``stats["epoch"]`` is the epoch
    in progress."""
    check_shuffle_plan()
    for epoch in range(start_epoch, num_epochs):
        if stats is not None:
            stats["epoch"] = epoch
        batch_queue.new_epoch(epoch)
        shuffle_epoch(
            epoch, filenames, batch_queue, num_reducers, num_trainers, seed,
            narrow_to_32=narrow_to_32, stats=stats,
        )
    batch_queue.wait_until_all_epochs_done()
