"""In-process batch queue: one FIFO per ``(epoch, rank)`` plus the epoch
window.

The shuffle driver puts each reducer's output on its rank's queue for the
epoch and ends the epoch with a trailing ``None`` sentinel per rank
(:meth:`BatchQueue.producer_done`). Trainers block in
:meth:`BatchQueue.get_batch` and ack what they consumed with
:meth:`BatchQueue.task_done`. :meth:`BatchQueue.new_epoch` is the only
backpressure: an epoch is admitted while fewer than
``max_concurrent_epochs`` epochs are in flight, else it waits until the
oldest one is fully produced and fully acked.

Queues are registered by name so that trainer ranks running as threads of
the same process can connect to the queue rank 0 created.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from typing import Any, Dict, List

DEFAULT_QUEUE_NAME = "BatchQueue"

_REGISTRY: Dict[str, "BatchQueue"] = {}
_REGISTRY_LOCK = threading.Lock()


class BatchQueue:
    def __init__(self, num_epochs: int, num_trainers: int, max_concurrent_epochs: int):
        self.num_epochs = num_epochs
        self.num_trainers = num_trainers
        self.max_epochs = max_concurrent_epochs
        self.curr_epochs: deque = deque()
        self.queues: List[List[queue.Queue]] = [
            [queue.Queue() for _ in range(num_trainers)] for _ in range(num_epochs)
        ]
        self.producer_done_events: List[List[threading.Event]] = [
            [threading.Event() for _ in range(num_trainers)] for _ in range(num_epochs)
        ]

    def new_epoch(self, epoch: int) -> None:
        """Admit ``epoch``; with the window full, first wait for the oldest
        in-flight epoch to be produced and acked in full."""
        if len(self.curr_epochs) == self.max_epochs:
            first = self.curr_epochs.popleft()
            for event in self.producer_done_events[first]:
                event.wait()
            for q in self.queues[first]:
                q.join()
        self.curr_epochs.append(epoch)

    def put_batch(self, rank: int, epoch: int, items: List[Any]) -> None:
        q = self.queues[epoch][rank]
        for item in items:
            q.put(item)

    def producer_done(self, rank: int, epoch: int) -> None:
        self.queues[epoch][rank].put(None)
        self.producer_done_events[epoch][rank].set()

    def get_batch(self, rank: int, epoch: int) -> List[Any]:
        """Block for one item, then drain whatever else has arrived."""
        q = self.queues[epoch][rank]
        items = [q.get()]
        while True:
            try:
                items.append(q.get_nowait())
            except queue.Empty:
                return items

    def task_done(self, rank: int, epoch: int, num_items: int = 1) -> None:
        q = self.queues[epoch][rank]
        for _ in range(num_items):
            q.task_done()

    def wait_until_all_epochs_done(self) -> None:
        last = self.num_epochs - 1
        for event in self.producer_done_events[last]:
            event.wait()
        for q in self.queues[last]:
            q.join()


def create_queue(
    name: str, num_epochs: int, num_trainers: int, max_concurrent_epochs: int
) -> BatchQueue:
    """Create and register the queue ``name`` (replacing a stale one)."""
    bq = BatchQueue(num_epochs, num_trainers, max_concurrent_epochs)
    with _REGISTRY_LOCK:
        _REGISTRY[name] = bq
    return bq


def connect_queue(name: str, timeout: float = 60.0) -> BatchQueue:
    """The queue ``name`` once rank 0 has created it."""
    deadline = time.monotonic() + timeout
    while True:
        with _REGISTRY_LOCK:
            bq = _REGISTRY.get(name)
        if bq is not None:
            return bq
        if time.monotonic() > deadline:
            raise TimeoutError(f"batch queue {name!r} was never created")
        time.sleep(0.01)
