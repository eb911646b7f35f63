"""The cross-process batch queue: a named actor holding one FIFO per
``(epoch, rank)`` and the epoch window.

The shuffle (rank 0) spawns the queue actor and registers itself as
its producer. It puts each reducer's output ref on its rank's queue and
ends an epoch with a trailing ``None`` sentinel per rank
(:meth:`BatchQueue.producer_done`). Trainer ranks, in any process of the
session, connect to the actor by name; they block in
:meth:`BatchQueue.get_batch` and ack what they consumed with
:meth:`BatchQueue.task_done`. :meth:`BatchQueue.new_epoch` admits an epoch
while fewer than ``max_concurrent_epochs`` epochs are in flight, else it
waits until the oldest one is fully produced and fully acked.

A consumer blocked on an empty queue checks the producer's liveness every
``$RSDL_PRODUCER_LIVENESS_S`` seconds (default 2) and raises
:class:`ProducerDiedError` when it died mid-epoch, instead of hanging.

A journaled shuffle tags each reducer's publication with its reducer
index (``seq``). The actor keeps one delivery cursor per ``(epoch,
rank)``, the next ``seq`` it accepts, and drops a re-published reducer
below it whole (:meth:`BatchQueue.put_batch` returns False), so a
resumed producer never hands a trainer the same rows twice. A resumed
producer seeds the cursors from its journal
(:meth:`BatchQueue.restore_delivery_cursors`).

With ``RSDL_METRICS`` on, the creating process registers the actor's
depths as a metrics source (``queue.depth{epoch,rank}``,
``queue.depth.total``); :meth:`BatchQueue.shutdown` drops it and keeps
the last depths as gauges. A consumer that finds its producer dead emits
``producer.died``.

This module imports the standard library and the runtime only.
"""

from __future__ import annotations

import asyncio
import collections
import os
from typing import Any, Dict, List, Optional, Tuple

from ray_shuffling_data_loader_tpu_torch import runtime, telemetry
from ray_shuffling_data_loader_tpu_torch.runtime import ActorDiedError
from ray_shuffling_data_loader_tpu_torch.telemetry import metrics as _metrics

DEFAULT_QUEUE_NAME = "BatchQueue"


class Empty(Exception):
    pass


class Full(Exception):
    pass


class ProducerDiedError(Exception):
    """A blocked consumer found its queue empty and the producer dead: the
    epoch can never complete."""

    def __init__(self, epoch: int, rank: int):
        super().__init__(
            f"batch-queue producer died before finishing epoch {epoch} "
            f"(consumer rank {rank}); the epoch cannot complete"
        )
        self.epoch = epoch
        self.rank = rank

    def __reduce__(self):
        return (ProducerDiedError, (self.epoch, self.rank))


def _producer_died(epoch: int, rank: int) -> ProducerDiedError:
    """The consumer side detects a dead producer: the ``producer.died``
    event, and the error to raise."""
    telemetry.emit_event("producer.died", epoch=epoch, rank=rank)
    return ProducerDiedError(epoch, rank)


def _liveness_interval_s() -> float:
    """Seconds between a blocked consumer's liveness checks, at least
    50 ms (no busy loop against the actor)."""
    try:
        value = float(os.environ.get("RSDL_PRODUCER_LIVENESS_S", "2.0"))
    except ValueError:
        return 2.0
    return max(0.05, value)


class _QueueActor:
    """Server side, on the actor's single-threaded event loop: no locks."""

    def __init__(self, max_epochs: int, num_epochs: int, num_trainers: int, maxsize: int):
        self.max_epochs = max_epochs
        self.num_epochs = num_epochs
        self.num_trainers = num_trainers
        self.maxsize = maxsize
        self.curr_epochs: collections.deque = collections.deque()
        grid = lambda make: [[make() for _ in range(num_trainers)] for _ in range(num_epochs)]  # noqa: E731
        self.queues: List[List[asyncio.Queue]] = grid(lambda: asyncio.Queue(maxsize))
        self.producer_done_events: List[List[asyncio.Event]] = grid(asyncio.Event)
        # Set by every consume: a producer waiting for room in put_batch
        # wakes and checks again.
        self.space_events: List[List[asyncio.Event]] = grid(asyncio.Event)
        self._producer_pid: Optional[int] = None
        self._items_enqueued = 0
        # (epoch, rank) -> the next reducer seq this actor accepts.
        self._delivery_seq: Dict[Tuple[int, int], int] = {}
        self._republish_dropped = 0

    def register_producer(self, pid: int) -> None:
        self._producer_pid = int(pid)

    def producer_alive(self, epoch: int) -> bool:
        """Can ``epoch`` still complete? Yes once every rank's sentinel is
        in, with no producer registered, or while the producer lives."""
        if all(e.is_set() for e in self.producer_done_events[epoch]) or self._producer_pid is None:
            return True
        return _pid_alive(self._producer_pid)

    async def new_epoch(self, epoch: int) -> None:
        if len(self.curr_epochs) == self.max_epochs:
            first = self.curr_epochs.popleft()
            await asyncio.gather(*(e.wait() for e in self.producer_done_events[first]))
            await asyncio.gather(*(q.join() for q in self.queues[first]))
        self.curr_epochs.append(epoch)

    async def producer_done(self, rank: int, epoch: int) -> None:
        await self.queues[epoch][rank].put(None)
        self.producer_done_events[epoch][rank].set()

    async def wait_until_all_epochs_done(self) -> None:
        last = self.num_epochs - 1
        await asyncio.gather(*(e.wait() for e in self.producer_done_events[last]))
        await asyncio.gather(*(q.join() for q in self.queues[last]))

    def qsize(self, rank: int, epoch: int) -> int:
        return self.queues[epoch][rank].qsize()

    async def put_batch(self, rank, epoch, items, timeout=None, seq=None) -> bool:
        """All or nothing: wait for room for every item, then enqueue them
        with no await in between, so a timeout leaves the queue as it
        was. A ``seq`` below the ``(epoch, rank)`` cursor is a reducer
        that already landed: dropped, counted, and False returned."""
        key = (int(epoch), int(rank))
        if seq is not None and seq < self._delivery_seq.get(key, 0):
            self._republish_dropped += 1
            return False
        queue = self.queues[epoch][rank]
        items = list(items)
        if self.maxsize > 0 and len(items) > self.maxsize:
            raise Full(f"Cannot ever add {len(items)} items to a queue with maxsize {self.maxsize}.")
        loop = asyncio.get_running_loop()
        deadline = None if timeout is None else loop.time() + timeout
        space = self.space_events[epoch][rank]
        while self.maxsize > 0 and queue.qsize() + len(items) > self.maxsize:
            space.clear()  # armed together with the failed room check
            remaining = None if deadline is None else deadline - loop.time()
            if remaining is not None and remaining <= 0:
                raise Full
            try:
                await asyncio.wait_for(space.wait(), remaining)
            except asyncio.TimeoutError:
                raise Full from None
        for item in items:
            queue.put_nowait(item)
        self._items_enqueued += len(items)
        if seq is not None:  # only once the items landed
            self._delivery_seq[key] = seq + 1
        return True

    async def get_batch(self, rank, epoch, timeout=None) -> List[Any]:
        """Block for one item (``Empty`` after ``timeout``), then drain
        whatever else has arrived."""
        queue = self.queues[epoch][rank]
        try:
            batch = [await asyncio.wait_for(queue.get(), timeout)]
        except asyncio.TimeoutError:
            raise Empty from None
        while not queue.empty():
            batch.append(queue.get_nowait())
        self.space_events[epoch][rank].set()
        return batch

    def task_done(self, rank, epoch, num_items: int = 1) -> None:
        for _ in range(num_items):
            self.queues[epoch][rank].task_done()
        self.space_events[epoch][rank].set()

    def restore_delivery_cursors(self, cursors: Dict[str, int]) -> None:
        """Seed the cursors (``{"epoch/rank": seq}``) from a journal,
        max-merged: an actor that outlived its producer keeps cursors that
        went further."""
        for key, seq in cursors.items():
            e, r = key.split("/")
            k = (int(e), int(r))
            self._delivery_seq[k] = max(self._delivery_seq.get(k, 0), int(seq))

    def status_snapshot(self) -> Dict[str, Any]:
        """The window's live state: epochs in flight, queue depths of
        their ``(epoch, rank)`` queues, the producer's liveness, items
        enqueued and re-publishes dropped so far."""
        return {
            "in_flight_epochs": list(self.curr_epochs),
            "num_epochs": self.num_epochs,
            "num_trainers": self.num_trainers,
            "producer_pid": self._producer_pid,
            "producer_alive": self._producer_pid is None or _pid_alive(self._producer_pid),
            "items_enqueued_total": self._items_enqueued,
            "republish_dropped_total": self._republish_dropped,
            "depth_total": sum(q.qsize() for qs in self.queues for q in qs),
            "depths": {f"{e}/{r}": q.qsize() for e in self.curr_epochs for r, q in enumerate(self.queues[e])},
        }

    def metrics_snapshot(self) -> Dict[str, float]:
        """The depths in the metrics vocabulary, for the driver's sampler
        (a registered source): one ``queue.depth{epoch,rank}`` per queue of
        the epochs in flight, and the totals."""
        out: Dict[str, float] = {}
        for epoch in self.curr_epochs:
            for rank, q in enumerate(self.queues[epoch]):
                out[_metrics.format_key("queue.depth", {"epoch": epoch, "rank": rank})] = float(q.qsize())
        out["queue.depth.total"] = float(sum(q.qsize() for qs in self.queues for q in qs))
        out["queue.items_enqueued.total"] = float(self._items_enqueued)
        out["queue.republish_dropped.total"] = float(self._republish_dropped)
        return out


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    return True


class BatchQueue:
    """Client handle of the queue actor. Rank 0 creates the actor
    (``connect=False``, registering the calling process as its producer);
    other ranks connect to it by ``name`` with backoff (``connect=True``)."""

    def __init__(
        self,
        num_epochs: int,
        num_trainers: int,
        max_concurrent_epochs: int,
        maxsize: int = 0,
        name: Optional[str] = None,
        connect: bool = False,
        connect_retries: int = 5,
    ) -> None:
        runtime.ensure_initialized()
        self._metrics_source: Optional[str] = None
        if connect:
            if name is None:
                raise ValueError("connect=True needs the queue's name")
            self.actor = runtime.connect_actor(name, num_retries=connect_retries)
        else:
            self.actor = runtime.spawn_actor(
                _QueueActor, max_concurrent_epochs, num_epochs, num_trainers, maxsize, name=name
            )
            self.actor.call("register_producer", os.getpid())
            if _metrics.enabled():
                # The sampler pulls the actor's live depths into every
                # global snapshot; the source drops when the actor dies.
                actor = self.actor
                self._metrics_source = f"batch_queue:{name or DEFAULT_QUEUE_NAME}-{id(self)}"
                _metrics.register_source(self._metrics_source, lambda: actor.call("metrics_snapshot"))
            if os.environ.get("RSDL_OBS_PORT"):
                # The queue's window on the obs server's /status, asked on a
                # short timeout: a wedged actor slows one scrape and does not
                # hang the server's thread.
                try:
                    from ray_shuffling_data_loader_tpu_torch.telemetry import obs_server

                    status_actor = self.actor
                    obs_server.register_status_provider(
                        "batch_queue", lambda: status_actor.call_with_timeout("status_snapshot", timeout=2.0))
                except Exception:
                    pass

    def __getstate__(self):
        return {"actor": self.actor}

    def __setstate__(self, state):
        self.actor = state["actor"]
        self._metrics_source = None

    def ready(self) -> None:
        self.actor.wait_ready()

    def new_epoch(self, epoch: int) -> None:
        """Admit ``epoch``, blocking on the epoch window."""
        self.actor.call("new_epoch", epoch)

    def producer_done(self, rank: int, epoch: int) -> None:
        self.actor.call_oneway("producer_done", rank, epoch)

    def task_done(self, rank: int, epoch: int, num_items: int = 1) -> None:
        self.actor.call_oneway("task_done", rank, epoch, num_items)

    def wait_until_all_epochs_done(self) -> None:
        self.actor.call("wait_until_all_epochs_done")

    def qsize(self, rank: int, epoch: int) -> int:
        return self.actor.call("qsize", rank, epoch)

    def put_batch(self, rank, epoch, items, timeout=None, seq=None) -> bool:
        """Enqueue ``items`` together, waiting for room (``Full`` after
        ``timeout``). ``seq``: the reducer index of a journaled delivery;
        False means the actor dropped it as a re-publish, and the caller
        still owns the refs."""
        if timeout is not None and timeout < 0:
            raise ValueError("'timeout' must be a non-negative number")
        return self.actor.call("put_batch", rank, epoch, list(items), timeout, seq)

    def restore_delivery_cursors(self, cursors: Dict[str, int]) -> None:
        """Seed the actor's delivery cursors (``{"epoch/rank": seq}``)."""
        self.actor.call("restore_delivery_cursors", dict(cursors))

    def status_snapshot(self) -> Dict[str, Any]:
        return self.actor.call("status_snapshot")

    def get_batch(self, rank: int, epoch: int, timeout: Optional[float] = None) -> List[Any]:
        """Block for the next item, then take every item already there.
        With ``timeout``, raise ``Empty`` after it; without, wait in slices
        of the liveness interval, and a dead producer with the queue empty
        raises :class:`ProducerDiedError`. The queue actor dies with its
        producer's process, so losing the actor mid-wait means the same."""
        if timeout is not None:
            if timeout < 0:
                raise ValueError("'timeout' must be a non-negative number")
            return self.actor.call("get_batch", rank, epoch, timeout)
        interval = _liveness_interval_s()
        try:
            while True:
                try:
                    return self.actor.call("get_batch", rank, epoch, interval)
                except Empty:
                    if not self.actor.call("producer_alive", epoch):
                        raise _producer_died(epoch, rank) from None
        except ActorDiedError as exc:
            raise ProducerDiedError(epoch, rank) from exc

    def shutdown(self, force: bool = False, grace_period_s: float = 5.0) -> None:
        if os.environ.get("RSDL_OBS_PORT"):
            try:
                from ray_shuffling_data_loader_tpu_torch.telemetry import obs_server

                obs_server.unregister_status_provider("batch_queue")
            except Exception:
                pass
        if self._metrics_source is not None:
            _metrics.unregister_source(self._metrics_source)
            self._metrics_source = None
            if not force:
                # The dataset shuts its queue once the last epoch is acked,
                # before a run's final snapshot: the last depths stay as
                # gauges of this process.
                try:
                    for key, value in self.actor.call("metrics_snapshot").items():
                        _metrics.registry.gauge(key).set(value)
                except Exception:
                    pass
        if self.actor is not None:
            self.actor.terminate(force=force, grace_period_s=grace_period_s)
        self.actor = None


def connect_queue(name: str = DEFAULT_QUEUE_NAME, num_retries: int = 5) -> BatchQueue:
    """A handle of the queue ``name`` that rank 0 created, from any
    process of the session."""
    return BatchQueue(0, 0, 0, name=name, connect=True, connect_retries=num_retries)
