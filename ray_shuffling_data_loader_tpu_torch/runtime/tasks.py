"""Task execution: a pool of spawned worker processes with futures and a
``wait`` primitive.

The pool is ``concurrent.futures.ProcessPoolExecutor`` on the ``spawn``
start method: a fresh interpreter inherits no CUDA state (a ``fork`` after
CUDA is initialised breaks CUDA in the child) and imports only what its
tasks need. A spawned child also runs the parent's ``__main__`` module
again under the name ``__mp_main__``, so a script that starts a pool keeps
its work under ``if __name__ == "__main__":``. Tasks are plain importable
functions; bulk data travels through the shared-memory store as
:class:`~.store.ObjectRef`. A worker that dies fails the pool's pending
futures with ``BrokenProcessPool``.

This module imports the standard library only.
"""

from __future__ import annotations

import concurrent.futures as cf
import multiprocessing as mp
import os
import sys
import threading
import time
import traceback
from typing import Callable, Dict, List, Optional, Sequence, Tuple

TaskFuture = cf.Future


class TaskError(Exception):
    """A task raised: carries the remote traceback and the remote
    exception's class name."""

    def __init__(self, message: str, error_type: Optional[str] = None):
        super().__init__(message)
        self.error_type = error_type

    def __reduce__(self):
        return (TaskError, (self.args[0] if self.args else "", self.error_type))


def _init_worker(env: Dict[str, str]) -> None:
    os.environ.update(env)
    parent = os.getppid()

    def watch_parent():
        # A pool owner killed without shutdown leaves no one to stop us.
        while os.getppid() == parent:
            time.sleep(1.0)
        os._exit(0)

    threading.Thread(target=watch_parent, daemon=True).start()


def _run_task(fn: Callable, args, kwargs):
    try:
        return fn(*args, **kwargs)
    except Exception as exc:
        raise TaskError(traceback.format_exc(), type(exc).__name__) from None
    finally:
        # The task-done spool barrier: the task's audit records are on the
        # spool before its result, or its failure, can be seen (a no-op
        # with the audit off). A worker whose tasks never loaded the audit
        # module has nothing buffered.
        audit = sys.modules.get("ray_shuffling_data_loader_tpu_torch.telemetry.audit")
        if audit is not None:
            audit.safe_flush()


def wait(
    futures: Sequence[TaskFuture], num_returns: int = 1, timeout: Optional[float] = None
) -> Tuple[List[TaskFuture], List[TaskFuture]]:
    """Block until ``num_returns`` futures are done (or ``timeout``);
    returns ``(done, pending)`` in submission order."""
    deadline = None if timeout is None else time.monotonic() + timeout
    while sum(f.done() for f in futures) < num_returns:
        remaining = None if deadline is None else deadline - time.monotonic()
        if remaining is not None and remaining <= 0:
            break
        cf.wait([f for f in futures if not f.done()], remaining, cf.FIRST_COMPLETED)
    done = [f.done() for f in futures]
    return [f for f, d in zip(futures, done) if d], [f for f, d in zip(futures, done) if not d]


class WorkerPool:
    """``num_workers`` spawned processes. ``env`` is set in each worker
    before its first task."""

    def __init__(self, num_workers: int, env: Optional[Dict[str, str]] = None):
        self.num_workers = num_workers
        t0 = time.perf_counter()
        self._executor = cf.ProcessPoolExecutor(
            num_workers, mp_context=mp.get_context("spawn"), initializer=_init_worker, initargs=(dict(env or {}),)
        )
        # Seconds from construction until one no-op per worker has run
        # (None until then): the executor starts a process per task while
        # none is idle, so this is the pool's start-up.
        self.ready_s: Optional[float] = None
        self.ready_at: Optional[float] = None  # the same moment, as ``time.time()``
        warm = [self._executor.submit(os.getpid) for _ in range(num_workers)]

        def ready(_):
            if all(f.done() for f in warm):
                self.ready_s = time.perf_counter() - t0
                self.ready_at = time.time()

        for f in warm:
            f.add_done_callback(ready)

    def submit(self, fn: Callable, *args, **kwargs) -> TaskFuture:
        return self._executor.submit(_run_task, fn, args, kwargs)

    def submit_local_to(self, refs, fn: Callable, *args, **kwargs) -> TaskFuture:
        """The cluster scheduler's locality submit
        (:meth:`.cluster.ClusterScheduler.submit_local_to`) on one host:
        every ref is local, so ``refs`` changes nothing."""
        return self.submit(fn, *args, **kwargs)

    def shutdown(self) -> None:
        self._executor.shutdown(wait=True, cancel_futures=True)
