"""Task execution: a pool of spawned worker processes with futures and a
``wait`` primitive.

Workers are started with the ``spawn`` method: a fresh interpreter inherits
no CUDA state (a ``fork`` after CUDA is initialised breaks CUDA in the
child) and imports only what its tasks need. A spawned child also runs the
parent's ``__main__`` module again under the name ``__mp_main__``, so a
script that starts a pool keeps its work under ``if __name__ ==
"__main__":``. Tasks are plain importable functions; bulk data travels
through the shared-memory store as :class:`~.store.ObjectRef`.

The workers take tasks from one shared queue and report on one result
pipe: a ``start`` message (task and pid) before a task runs, then its
result or its error. A collector thread settles the futures; a watchdog
thread fails the in-flight tasks of a worker that died (by the ``start``
messages, only that worker's, with a :class:`TaskError` naming its pid),
starts a worker in its place, and reaps workers that left cleanly
(:meth:`WorkerPool.retire_workers`). So a dead worker costs its task, and
the pool goes on serving.

Each task carries its submitter's trace context (:func:`_outbound_ctx`),
and its worker runs it under a ``task:<name>`` span in that context
while a telemetry plane is on. With metrics on, a task that returns
leaves a duration record for the straggler view (:func:`_record_task_done`),
and the pool feeds its in-flight tasks to it (:meth:`WorkerPool.in_flight`).
Before a worker reports a task done it flushes the telemetry spools
(:func:`_flush_telemetry_spools`). With ``RSDL_PROFILE`` set, each worker
runs the sampling profiler.

This module imports the standard library only.
"""

from __future__ import annotations

import concurrent.futures as cf
import multiprocessing as mp
import os
import pickle
import sys
import threading
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

TaskFuture = cf.Future

_WATCH_S = 0.25  # the watchdog's period


class TaskError(Exception):
    """A task failed: the remote traceback, the remote exception's class
    name (``WorkerDied`` when the worker died under it) and, when it died
    on a lost store object (``ObjectLostError``), that object's id, so that
    the shuffle can re-make exactly that object."""

    def __init__(self, message: str, error_type: Optional[str] = None, lost_object_id: Optional[str] = None):
        super().__init__(message)
        self.error_type = error_type
        self.lost_object_id = lost_object_id

    def __reduce__(self):
        # It crosses the actor wire (a host agent replies with it).
        return (TaskError, (self.args[0] if self.args else "", self.error_type, self.lost_object_id))


_TELEMETRY = "ray_shuffling_data_loader_tpu_torch.telemetry"


def _outbound_ctx():
    """The submitter's trace context, pickled beside the task, or None
    with no import when nothing can have produced one (the telemetry
    facade decides; see :func:`.telemetry.outbound`)."""
    from ray_shuffling_data_loader_tpu_torch import telemetry

    return telemetry.outbound()


def _record_task_done(fn, duration_s: float, trace_ctx) -> None:
    """One returned task's duration record for the straggler view, with
    the epoch and job of the context it ran in. Checks metrics before the
    import, so the disabled path never loads the stragglers module; never
    raises."""
    from ray_shuffling_data_loader_tpu_torch.telemetry import metrics

    if not metrics.enabled():
        return
    try:
        from ray_shuffling_data_loader_tpu_torch.telemetry import stragglers

        ctx = trace_ctx or {}
        stragglers.record_task(getattr(fn, "__name__", "task"), duration_s, epoch=ctx.get("epoch"), job=ctx.get("job"))
    except Exception:
        pass


def _flush_telemetry_spools() -> None:
    """The task-done spool barrier: a task's trace events, audit records,
    profile, metrics snapshot, events, duration record and capacity-ledger
    ops are on their spools before its result, or its failure, can be
    seen. Trace, audit and the profiler flush through ``sys.modules`` (a
    module never loaded has nothing buffered); the rest only with metrics
    on, so the disabled path imports nothing. Then the relay's kick."""
    for name in ("trace", "audit", "profiler"):
        mod = sys.modules.get(f"{_TELEMETRY}.{name}")
        if mod is not None:
            mod.safe_flush()
    from ray_shuffling_data_loader_tpu_torch.telemetry import metrics

    if metrics.enabled():
        try:
            from ray_shuffling_data_loader_tpu_torch.telemetry import capacity, events, export, stragglers

            export.safe_flush()
            events.safe_flush()
            stragglers.safe_flush()
            capacity.safe_flush()
        except Exception:
            pass
    # Wake this host's relay shipper, so that a joined host's records reach
    # the head at this barrier. RSDL_RELAY is read before the import.
    from ray_shuffling_data_loader_tpu_torch.telemetry import _env

    if _env.relay_armed():
        try:
            from ray_shuffling_data_loader_tpu_torch.telemetry import relay

            relay.kick()
        except Exception:
            pass


def _worker_main(task_q, result_q, env: Dict[str, str]) -> None:
    os.environ.update(env)
    from ray_shuffling_data_loader_tpu_torch import telemetry
    from ray_shuffling_data_loader_tpu_torch.telemetry import _env

    from . import faults

    faults.set_role("task")
    pid = os.getpid()
    # A spawned worker reads the flags from its environment; the trace
    # module loads only when tracing is on.
    trace_on = _env.read_flag("RSDL_TRACE")
    if trace_on:
        telemetry.set_process_name(f"task-worker-{pid}")
    instrumented = trace_on or telemetry.metrics.enabled()
    if _env.read_flag("RSDL_PROFILE"):
        try:
            from ray_shuffling_data_loader_tpu_torch.telemetry import profiler

            profiler.start()
        except Exception:
            pass
    parent = os.getppid()

    def watch_parent():
        # A pool owner killed without shutdown leaves no one to stop us.
        while os.getppid() == parent:
            time.sleep(1.0)
        os._exit(0)

    threading.Thread(target=watch_parent, daemon=True).start()
    result_q.put(("up", pid))
    while True:
        item = task_q.get()
        if item is None:  # a retirement or shutdown pill
            return
        task_id, blob = item
        # Written before the task runs (the result pipe is synchronous): a
        # worker that dies inside the task is known to have held it.
        result_q.put(("start", task_id, pid))
        try:
            fn, args, kwargs, trace_ctx = pickle.loads(blob)
            t0 = time.perf_counter()
            if instrumented or trace_ctx is not None:
                # Re-enter the submitter's context: the task's spans and
                # events carry its (trial, epoch, schedule).
                with telemetry.propagated_span(f"task:{getattr(fn, '__name__', 'task')}", trace_ctx):
                    result = fn(*args, **kwargs)
            else:
                result = fn(*args, **kwargs)
            _record_task_done(fn, time.perf_counter() - t0, trace_ctx)
            out = pickle.dumps(result)
            error = None
        except Exception as exc:
            out = None
            error = {"tb": traceback.format_exc(), "type": type(exc).__name__,
                     "lost": getattr(exc, "object_id", None)}
        _flush_telemetry_spools()
        result_q.put(("done", task_id, out, error))


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
    """``num_workers`` spawned processes on one task queue. ``env`` is set
    in each worker before its first task. :meth:`add_workers` and
    :meth:`retire_workers` change the membership while tasks run."""

    def __init__(self, num_workers: int, env: Optional[Dict[str, str]] = None):
        self._ctx = mp.get_context("spawn")
        self._task_q = self._ctx.Queue()
        # A SimpleQueue writes in the caller's thread: a ``start`` is in the
        # pipe before its task runs, even if the worker then dies at once.
        self._result_q = self._ctx.SimpleQueue()
        self._env = dict(env or {})
        self._lock = threading.Lock()
        self._procs: List[Any] = []
        self._futures: Dict[int, cf.Future] = {}
        self._running_on: Dict[int, int] = {}  # task id -> worker pid
        self._names: Dict[int, str] = {}  # task id -> function name
        self._started: Dict[int, float] = {}  # task id -> start, monotonic
        self._dead: set = set()  # pids of workers that died
        self._next_id = 0
        self._closed = False
        self.deaths = 0  # workers that died, each replaced
        # Seconds from construction until every first worker reported in
        # (None until then): the pool's start-up.
        self.ready_s: Optional[float] = None
        self.ready_at: Optional[float] = None  # the same moment, as ``time.time()``
        self._t0 = time.perf_counter()
        self._waiting_up = num_workers
        self._spawn(num_workers)
        self._collector = threading.Thread(target=self._collect, name="pool-collector", daemon=True)
        self._collector.start()
        self._watchdog = threading.Thread(target=self._watch, name="pool-watchdog", daemon=True)
        self._watchdog.start()
        # The straggler view's wedged-task feed: which task started when,
        # on which worker. Checks metrics before the import.
        self._inflight_name = f"pool-{id(self)}"
        from ray_shuffling_data_loader_tpu_torch.telemetry import metrics

        if metrics.enabled():
            try:
                from ray_shuffling_data_loader_tpu_torch.telemetry import stragglers

                stragglers.register_inflight_provider(self._inflight_name, self.in_flight)
            except Exception:
                pass

    @property
    def num_workers(self) -> int:
        with self._lock:
            return len(self._procs)

    @property
    def width(self) -> int:
        """The workers, as a cluster scheduler names its capacity (the
        elastic controller reads either)."""
        return self.num_workers

    def _spawn(self, n: int) -> None:
        procs = [self._ctx.Process(target=_worker_main, args=(self._task_q, self._result_q, self._env), daemon=True)
                 for _ in range(n)]
        for p in procs:
            p.start()
        with self._lock:
            self._procs.extend(procs)

    def _settle(self, settled) -> None:
        # Outside the lock: a future's callbacks run here.
        for fut, result, error in settled:
            if error is not None:
                fut.set_exception(error)
            else:
                fut.set_result(result)

    def _pop(self, task_id: int) -> Optional[cf.Future]:
        self._running_on.pop(task_id, None)
        self._started.pop(task_id, None)
        self._names.pop(task_id, None)
        return self._futures.pop(task_id, None)

    def _collect(self) -> None:
        while True:
            try:
                item = self._result_q.get()
            except (EOFError, OSError):
                return
            if item is None:
                return
            settled = []
            if item[0] == "up":
                with self._lock:
                    self._waiting_up -= 1
                    if self._waiting_up == 0 and self.ready_s is None:
                        self.ready_s = time.perf_counter() - self._t0
                        self.ready_at = time.time()
                continue
            if item[0] == "start":
                _, task_id, pid = item
                with self._lock:
                    if pid in self._dead:  # died before its start was read
                        fut = self._pop(task_id)
                        if fut is not None:
                            settled.append((fut, None, self._death_error(pid)))
                    elif task_id in self._futures:
                        self._running_on[task_id] = pid
                        self._started[task_id] = time.monotonic()
                self._settle(settled)
                continue
            _, task_id, out, error = item
            with self._lock:
                fut = self._pop(task_id)
            if fut is None:
                continue
            if error is not None:
                settled.append((fut, None, TaskError(error["tb"], error["type"], error["lost"])))
            else:
                try:
                    settled.append((fut, pickle.loads(out), None))
                except Exception as exc:  # a result that does not unpickle here
                    settled.append((fut, None, TaskError(traceback.format_exc(), type(exc).__name__)))
            self._settle(settled)

    @staticmethod
    def _death_error(pid: int) -> TaskError:
        return TaskError(f"worker process {pid} died while running this task", "WorkerDied")

    def _watch(self) -> None:
        while not self._closed:
            time.sleep(_WATCH_S)
            settled, replace = [], 0
            with self._lock:
                if self._closed:
                    return
                for p in [p for p in self._procs if not p.is_alive()]:
                    p.join(timeout=0.1)
                    self._procs.remove(p)
                    if p.exitcode == 0:
                        continue  # retired: it took a pill and left
                    self._dead.add(p.pid)
                    self.deaths += 1
                    replace += 1
                    for task_id in [t for t, pid in self._running_on.items() if pid == p.pid]:
                        fut = self._pop(task_id)
                        if fut is not None:
                            settled.append((fut, None, self._death_error(p.pid)))
            self._settle(settled)
            if replace:
                self._spawn(replace)

    # -- membership ---------------------------------------------------------------

    def add_workers(self, n: int) -> int:
        """Start ``n`` more workers on the task queue; returns the pool's
        size."""
        if not self._closed and n > 0:
            self._spawn(int(n))
        return self.num_workers

    def retire_workers(self, n: int, deadline_s: float = 10.0) -> List[int]:
        """Retire ``n`` workers (never the last): each pill queues behind
        the tasks already submitted and ends the worker that takes it, once
        its task is done. Waits up to ``deadline_s`` for the exits (the
        watchdog reaps later ones); returns the pids that left."""
        with self._lock:
            before = {p.pid for p in self._procs}
            n = min(int(n), len(before) - 1)
        if self._closed or n <= 0:
            return []
        for _ in range(n):
            self._task_q.put(None)
        deadline = time.monotonic() + max(0.0, deadline_s)
        while True:
            with self._lock:
                for p in [p for p in self._procs if not p.is_alive() and p.exitcode == 0]:
                    p.join(timeout=0.1)
                    self._procs.remove(p)
                retired = sorted(before - {p.pid for p in self._procs} - self._dead)
            if len(retired) >= n or time.monotonic() >= deadline:
                return retired
            time.sleep(0.05)

    def in_flight(self) -> List[Dict[str, Any]]:
        """One entry per started, unfinished task: its function's name, its
        worker's pid and its age in seconds."""
        now = time.monotonic()
        with self._lock:
            return [{"stage": self._names.get(t, "task"), "pid": pid, "age_s": now - self._started[t]}
                    for t, pid in self._running_on.items() if t in self._started]

    # -- tasks ------------------------------------------------------------------------

    def submit(self, fn: Callable, *args, **kwargs) -> TaskFuture:
        if self._closed:
            raise RuntimeError("worker pool is shut down")
        # Pickled here: an argument that does not pickle raises to the
        # caller, not in a feeder thread where it would be lost.
        blob = pickle.dumps((fn, args, kwargs, _outbound_ctx()))
        fut: cf.Future = cf.Future()
        fut.set_running_or_notify_cancel()
        with self._lock:
            task_id = self._next_id
            self._next_id += 1
            self._futures[task_id] = fut
            self._names[task_id] = getattr(fn, "__name__", "task")
        self._task_q.put((task_id, blob))
        return fut

    def submit_local_to(self, refs, fn: Callable, *args, **kwargs) -> TaskFuture:
        """The cluster scheduler's locality submit
        (:meth:`.cluster.ClusterScheduler.submit_local_to`) on one host:
        every ref is local, so ``refs`` changes nothing."""
        return self.submit(fn, *args, **kwargs)

    def shutdown(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            procs = list(self._procs)
        # Through sys.modules: a pool that never registered does not
        # import the straggler module to unregister.
        stragglers = sys.modules.get(f"{_TELEMETRY}.stragglers")
        if stragglers is not None:
            stragglers.unregister_inflight_provider(self._inflight_name)
        for _ in procs:
            self._task_q.put(None)
        for p in procs:
            p.join(timeout=2)
            if p.is_alive():
                p.terminate()
                p.join(timeout=2)
            if p.is_alive():  # one wedged in a system call survives SIGTERM
                p.kill()
                p.join()
        self._result_q.put(None)
        self._collector.join(timeout=5)
        with self._lock:
            futs = list(self._futures.values())
            self._futures.clear()
            self._running_on.clear()
        self._settle([(f, None, TaskError("worker pool shut down")) for f in futs])
        self._task_q.close()
        self._task_q.cancel_join_thread()
