"""The shuffling dataset: exact-size host batches of every epoch's shuffle.

Rank 0 spawns the named batch queue actor, registering itself as its
producer, and runs the multi-epoch shuffle on a daemon thread, in the
caller's job of the multi-job service when there is one (the queue's name
is then scoped to it). Every other
rank, in the same process or in any other process of the session,
connects to the queue by name with retry. Each rank maps its reducer
outputs from the shared-memory store (zero copy), re-cuts them into
batches of exactly ``batch_size`` rows with a carry buffer, and acks what
it consumed so the epoch window can move on.

A packed reducer output (whole batches already cut at the rank's batch
grid, :func:`~.runtime.store.iter_packed_batches`) is yielded batch by
batch as zero-copy views; only the plain head and tail of a reducer's
interval go through the carry buffer.

With the audit armed (``RSDL_AUDIT``), each rank digests every queue
batch it reads back, before the re-cut: the consumed side of
:mod:`.telemetry.audit`.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Dict, Iterator, List, Optional

from ray_shuffling_data_loader_tpu_torch import runtime, telemetry
from ray_shuffling_data_loader_tpu_torch.batch_queue import DEFAULT_QUEUE_NAME, BatchQueue
from ray_shuffling_data_loader_tpu_torch.runtime import ColumnBatch, ObjectRef
from ray_shuffling_data_loader_tpu_torch.runtime.store import (
    is_device_batch,
    iter_packed_batches,
    logical_columns,
    rows_of,
)
from ray_shuffling_data_loader_tpu_torch.shuffle import BatchConsumer, shuffle
from ray_shuffling_data_loader_tpu_torch.telemetry._env import audit_plane as _audit

# Default reducer share of the host's cores.
REDUCER_CLUSTER_CORE_SHARE = 0.6


def default_num_reducers(num_trainers: int) -> int:
    return max(
        1, int(num_trainers * (os.cpu_count() or 1) * REDUCER_CLUSTER_CORE_SHARE)
    )


class CarryRebatcher:
    """The exact-``batch_size`` re-batching algebra.

    Reducer outputs arrive in arbitrary sizes; training wants exact batches
    with a carry buffer spanning output boundaries. ``skip_batches`` counts
    suppressed batches in yield order (the final partial counts as one).
    """

    def __init__(self, batch_size: int, skip_batches: int = 0):
        self.batch_size = batch_size
        self.to_skip = skip_batches
        self.buf: Optional[ColumnBatch] = None

    def feed(self, cb: ColumnBatch) -> Iterator[ColumnBatch]:
        """Yield every full batch completed by this reducer output."""
        batch_size = self.batch_size
        offset = batch_size - (self.buf.num_rows if self.buf else 0)
        # Top up the carry buffer with a front slice.
        self.buf = ColumnBatch.concat([self.buf, cb.slice(0, offset)])
        if self.buf.num_rows == batch_size:
            if self.to_skip > 0:
                self.to_skip -= 1
            else:
                yield self.buf
            self.buf = None
        # Whole batches straight from this output, then the short tail
        # into the carry buffer.
        start = min(offset, cb.num_rows)
        num_full = (cb.num_rows - start) // batch_size
        num_skipped = min(self.to_skip, num_full)
        self.to_skip -= num_skipped
        for i in range(num_skipped, num_full):
            lo = start + i * batch_size
            yield cb.slice(lo, lo + batch_size)
        tail = start + num_full * batch_size
        if tail < cb.num_rows:
            self.buf = cb.slice(tail, cb.num_rows)

    def finish(self, drop_last: bool) -> Optional[ColumnBatch]:
        """The final partial batch, unless dropped, skipped or empty."""
        buf, self.buf = self.buf, None
        if buf is not None and buf.num_rows > 0 and not drop_last:
            if self.to_skip > 0:
                self.to_skip -= 1
                return None
            return buf
        return None


class ShufflingDataset:
    """Iterates exact-``batch_size`` :class:`ColumnBatch`\\ es of a
    per-epoch shuffle. Call :meth:`set_epoch` before each epoch.

    Args:
        filenames: Parquet files.
        num_epochs, num_trainers, batch_size, rank: the run's shape.
        drop_last: drop the final partial batch of each epoch.
        num_reducers: reducer count (default: a share of the host's cores).
        max_concurrent_epochs: epochs shuffled ahead of training.
        seed: root seed of every epoch's permutations.
        queue_name: name of the batch queue actor the ranks share.
        start_epoch: first epoch to shuffle (resume; epochs stay absolute).
        narrow_to_32: cast 64-bit columns to 32 bits at decode.
        cache_decoded: keep each file's decoded columns in the store after
            the first epoch (None: decided by the shuffle's policy).
        device_layout: a staging consumer's ``{"batch": B, "columns":
            [...]}``: reducers then pack their whole batches, and this
            iterator yields those as views with ``.packed`` set.
        stats_collector: a :class:`~.stats.TrialStatsCollector` handle
            that rank 0's shuffle reports to.
    """

    def __init__(
        self,
        filenames: List[str],
        num_epochs: int,
        num_trainers: int,
        batch_size: int,
        rank: int,
        drop_last: bool = False,
        num_reducers: Optional[int] = None,
        max_concurrent_epochs: int = 2,
        seed: int = 0,
        queue_name: str = DEFAULT_QUEUE_NAME,
        start_epoch: int = 0,
        narrow_to_32: bool = False,
        cache_decoded: Optional[bool] = None,
        device_layout: Optional[dict] = None,
        stats_collector=None,
    ):
        runtime.ensure_initialized()
        if num_reducers is None:
            num_reducers = default_num_reducers(num_trainers)
        self._batch_size = batch_size
        self._num_epochs = num_epochs
        self._rank = rank
        self._drop_last = drop_last
        self._epoch: Optional[int] = None
        self._last_epoch: Optional[int] = None
        self._skip_batches = 0
        self._error: Optional[BaseException] = None
        self._failed_epoch: Optional[int] = None  # whose end the failing shuffle sent
        self._thread: Optional[threading.Thread] = None
        # Rank 0: the shuffle's stats (see ``shuffle``) and each epoch's
        # schedule.
        self.shuffle_stats: Dict[str, Any] = {}
        self.schedule_log: List[tuple] = []
        # The last epoch iterated: seconds of each get_batch call, and the
        # rows read from the store (before the re-cut).
        self.get_batch_s: List[float] = []
        self.rows_read = 0
        if rank != 0:
            self._batch_queue = BatchQueue(
                num_epochs, num_trainers, max_concurrent_epochs, name=queue_name, connect=True
            )
            return
        # The caller's job of the multi-job service (RSDL_SERVICE, read
        # before the import), for the driver thread below: the queue's scoped
        # name made here and the shuffle's job must agree. Never one
        # registered here: the ranks elsewhere could not learn its id.
        service_job = None
        if os.environ.get("RSDL_SERVICE"):
            from ray_shuffling_data_loader_tpu_torch.runtime import service

            if service.enabled():
                service_job = service.current_job()
        self._batch_queue = BatchQueue(num_epochs, num_trainers, max_concurrent_epochs, name=queue_name)
        self._batch_queue.ready()
        consumer = BatchConsumerQueue(self._batch_queue, on_failure=self._fail)

        def _drive():
            try:
                if service_job is not None:
                    service.set_current_job(service_job)
                shuffle(
                    filenames, consumer, num_epochs, num_reducers,
                    num_trainers, seed=seed, start_epoch=start_epoch,
                    narrow_to_32=narrow_to_32, cache_decoded=cache_decoded,
                    schedule_log=self.schedule_log, device_layout=device_layout,
                    stats=self.shuffle_stats, stats_collector=stats_collector,
                )
                # Every rank has acked the last epoch: nothing calls the
                # queue again, and its name is free for the next dataset.
                self._batch_queue.shutdown()
            except Exception as exc:  # raised on the consumer side
                self._fail(exc)
                # Unblock every rank waiting on an epoch that will not come:
                # the epochs before the failing one are fully signalled, and
                # a failing epoch signals its own end.
                first = self.shuffle_stats.get("epoch", start_epoch)
                if self._failed_epoch is not None:
                    first = self._failed_epoch + 1
                for epoch in range(first, num_epochs):
                    for r in range(num_trainers):
                        self._batch_queue.producer_done(r, epoch)

        self._thread = threading.Thread(target=_drive, name="shuffle-driver", daemon=True)
        self._thread.start()

    @property
    def batch_size(self) -> int:
        return self._batch_size

    def set_epoch(self, epoch: int, skip_batches: int = 0) -> None:
        """Select the epoch to iterate next. ``skip_batches`` resumes
        mid-epoch: the shuffle is deterministic per ``(seed, epoch)``, so
        suppressing the first ``skip_batches`` batches gives the stream an
        uninterrupted run would have produced from there."""
        self._epoch = epoch
        self._skip_batches = skip_batches

    def __iter__(self) -> Iterator[ColumnBatch]:
        if self._epoch is None or self._epoch == self._last_epoch:
            raise ValueError(
                "You must set the epoch on this dataset via set_epoch() at "
                "the beginning of each epoch, before iterating over this "
                "dataset."
            )
        epoch, rank = self._epoch, self._rank
        store = runtime.get_context().store
        rebatch = CarryRebatcher(self._batch_size, self._skip_batches)
        # The carry re-cut's own cost (the "rebatch" phase of stage
        # "staging"); a shared no-op while telemetry is off.
        prof = telemetry.stage_profiler("staging", epoch=epoch, rank=rank)

        def recut(cb):
            # Only the rebatcher's slicing is timed: the consumer runs
            # between the next() calls, outside the phase.
            feed = rebatch.feed(cb)
            while True:
                with prof.phase("rebatch"):
                    try:
                        out = next(feed)
                    except StopIteration:
                        return
                yield out

        self.get_batch_s = []
        self.rows_read = 0
        consumed_rows = 0  # the audit's offset in this rank's consumed stream
        is_done = False
        while not is_done:
            t0 = time.perf_counter()
            pending = self._batch_queue.get_batch(rank, epoch)
            self.get_batch_s.append(time.perf_counter() - t0)
            if pending[-1] is None:
                is_done = True
                pending.pop()
            num_outstanding = len(pending)
            # Pull the foreign refs of this get while the first is read
            # (a no-op when every ref is local).
            store.prefetch(pending)
            for ref in pending:
                # Every row is read: fill the page tables in one call, not
                # one fault per page inside the stager's copy.
                cb = store.get_columns(ref, populate=True)
                store.free(ref)  # the mapping outlives the unlink
                if _audit.enabled():
                    # What this rank read back through the queue and the
                    # store: a row lost or repeated after the delivery
                    # breaks delivered == consumed.
                    _audit.record_consume(epoch, rank, logical_columns(cb), consumed_rows)
                    consumed_rows += rows_of(cb)
                if not is_device_batch(cb):
                    self.rows_read += cb.num_rows
                    yield from recut(cb)
                elif cb.layout.get("batch") == self._batch_size and (rebatch.buf is None or rebatch.buf.num_rows == 0):
                    # Whole batches cut at this rank's grid: the carry is
                    # empty whenever one arrives, by construction.
                    for pb in iter_packed_batches(cb):
                        self.rows_read += pb.num_rows
                        if rebatch.to_skip > 0:
                            rebatch.to_skip -= 1
                        else:
                            yield pb
                else:
                    # Misaligned with this consumer: re-cut like any rows.
                    for pb in iter_packed_batches(cb):
                        self.rows_read += pb.num_rows
                        yield from recut(pb)
                del cb
            if num_outstanding:
                self._batch_queue.task_done(rank, epoch, num_outstanding)
        self._raise_if_failed()
        final = rebatch.finish(self._drop_last)
        if final is not None:
            yield final
        # Ack the end-of-epoch sentinel itself.
        self._batch_queue.task_done(rank, epoch, 1)
        self._last_epoch = epoch

    def join(self, timeout: Optional[float] = None) -> None:
        """Rank 0: wait until every rank has consumed the last epoch and
        the shuffle thread has ended; raises its error, if any. Not part
        of iteration: rank 0's stream may end before another rank's, and
        ranks that step together must not wait on each other there."""
        if self._thread is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():
                raise TimeoutError("the shuffle thread is still running")
        self._raise_if_failed()

    def _fail(self, exc: BaseException, epoch: Optional[int] = None) -> None:
        """Keep the shuffle's first error for the consumer side. A failing
        ``epoch`` hands it over before it ends the ranks' epoch, so that
        rank 0 raises it instead of ending the epoch short."""
        if self._error is None:
            self._error = exc
        if epoch is not None:
            self._failed_epoch = epoch

    def _raise_if_failed(self) -> None:
        """Raise the shuffle's own error (a ``StageFailedError`` for a
        poison task), as the JAX package's dataset does."""
        if self._error is not None:
            raise self._error


class BatchConsumerQueue(BatchConsumer):
    """The shuffle's consumer interface over a :class:`BatchQueue`.
    ``on_failure`` hears a failing epoch's error."""

    def __init__(self, batch_queue: BatchQueue, on_failure=None):
        self._batch_queue = batch_queue
        self._on_failure = on_failure

    def producer_failed(self, epoch: int, exc: BaseException) -> None:
        if self._on_failure is not None:
            self._on_failure(exc, epoch)

    def consume(self, rank: int, epoch: int, batches: List[ObjectRef], seq: Optional[int] = None) -> None:
        if self._batch_queue.put_batch(rank, epoch, batches, seq=seq) is False:
            # A re-publish the queue already holds: nothing will consume
            # these refs, so free them here.
            runtime.get_context().store.free(batches)

    def producer_done(self, rank: int, epoch: int) -> None:
        self._batch_queue.producer_done(rank, epoch)

    def restore_delivery_cursors(self, cursors: Dict[str, int]) -> None:
        """Seed the queue's delivery cursors from a journal."""
        self._batch_queue.restore_delivery_cursors(cursors)

    def wait_until_ready(self, epoch: int) -> None:
        self._batch_queue.new_epoch(epoch)

    def wait_until_all_epochs_done(self) -> None:
        self._batch_queue.wait_until_all_epochs_done()
