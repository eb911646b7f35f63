"""Spans recorded into a per-process buffer, context propagated across
processes, and one Chrome-trace/Perfetto JSON merged from every process.

* **Off by default at the cost of one cached boolean.** Tracing is on
  when ``RSDL_TRACE`` is truthy; :func:`trace_span` and
  :func:`record_span` otherwise return a shared no-op object and read no
  clock.
* **A buffer per process, no daemon.** The driver, the pool's workers,
  the actor hosts and the trainer ranks each append events to a buffer
  and drain it to ``trace-<pid>.jsonl`` under ``RSDL_TRACE_DIR``, at 256
  events or after 1 s, and before a task reports done. Spawned processes
  inherit the directory through the environment, so :func:`enable` runs
  before ``runtime.init()``. :func:`trace_export` merges the spool into
  one Chrome-trace JSON that ``chrome://tracing`` and
  https://ui.perfetto.dev open.
* **Context is shipped explicitly.** ``(trial, epoch, schedule, ...)``
  lives in a context variable (:func:`context`, :func:`current_context`);
  the runtime ships the caller's :func:`outbound_context` with every task
  (``runtime/tasks.py``), actor call (``runtime/actor.py``) and cluster
  agent call, and the receiving side re-enters it in
  :func:`propagated_span`, so a reduce span on a pool worker carries the
  driver's epoch.

Timestamps are wall-clock microseconds (``time.time()``); durations are
``perf_counter`` differences. The event format is the JAX package's.

This module imports the standard library only.
"""

from __future__ import annotations

import atexit
import contextvars
import json
import os
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional, Tuple

from ray_shuffling_data_loader_tpu_torch.telemetry import _env

ENV_TRACE = "RSDL_TRACE"
ENV_TRACE_DIR = "RSDL_TRACE_DIR"
ENV_TRACE_BUFFER = "RSDL_TRACE_BUFFER"

# Flush policy for root spans: drain the buffer to the spool file when it
# holds this many events or this much time has passed — frequent enough
# that short-lived work is exportable promptly, rare enough that hot actor
# dispatch loops do not pay a file append per call. (Task workers
# additionally flush after every task, before reporting it done, so a
# task's spans are always on disk by the time its caller can observe the
# result — see runtime/tasks.py.)
_FLUSH_EVENTS = 256
_FLUSH_INTERVAL_S = 1.0

_lock = threading.RLock()
_enabled: Optional[bool] = None  # tri-state: None = not yet read from env
_events: List[dict] = []
_dropped = 0
_last_flush = 0.0
_atexit_registered = False
_process_name: Optional[str] = None
_process_meta_emitted = False
_threads_named: set = set()
_base_ctx: Dict[str, Any] = {}
_tls = threading.local()  # span depth only (flush heuristic)
# Context rides in a contextvar, NOT a thread-local: actor dispatches
# interleave as asyncio tasks on one event-loop thread, and each task gets
# its own copy of the contextvars Context — so a dispatch blocked for
# minutes inside context(epoch=N) cannot leak epoch=N into the spans of
# dispatches interleaved on the same thread. Plain threads see their own
# (initially empty) context, matching the old thread-local semantics.
_ctx_stack_var: "contextvars.ContextVar[Tuple[Dict[str, Any], ...]]" = (
    # rsdl-lint: disable=vocabulary-drift -- contextvar debug name,
    # not a Prometheus alias; never appears on a scrape
    contextvars.ContextVar("rsdl_trace_ctx", default=())
)


def enabled() -> bool:
    """Is tracing on in this process? Cached after the first env read."""
    global _enabled
    if _enabled is None:
        _enabled = _env.read_flag(ENV_TRACE)
    return _enabled


def enable(spool_dir: Optional[str] = None) -> None:
    """Turn tracing on for this process AND (via the environment) every
    process spawned after this call — call before ``runtime.init()`` so
    pool workers and actors inherit it. ``spool_dir`` is where each
    process drains its event buffer; without one, events stay in this
    process's memory and the export covers only this process."""
    global _enabled
    os.environ[ENV_TRACE] = "1"
    if spool_dir:
        os.makedirs(spool_dir, exist_ok=True)
        os.environ[ENV_TRACE_DIR] = spool_dir
    _enabled = True
    _register_atexit()


def disable() -> None:
    global _enabled
    os.environ.pop(ENV_TRACE, None)
    _enabled = False


def refresh_from_env() -> None:
    """Forget the cached enabled state and buffer limit; the next check
    re-reads the env (test harness hook — fixtures restore the env then
    call this)."""
    global _enabled, _max_events_cached, _service_armed_cached
    _enabled = None
    _max_events_cached = None
    _service_armed_cached = None
    import sys

    facade = sys.modules.get(__name__.rpartition(".")[0])
    if facade is not None:
        facade._trace_flag = None


def spool_dir() -> Optional[str]:
    return os.environ.get(ENV_TRACE_DIR) or None


_max_events_cached: Optional[int] = None


def _max_events() -> int:
    # Cached like the enabled flag: _record() calls this per event while
    # holding the lock, and an env read + int parse per span is real cost
    # on hot paths (actor dispatch, per-batch staging).
    global _max_events_cached
    if _max_events_cached is None:
        try:
            _max_events_cached = int(
                os.environ.get(ENV_TRACE_BUFFER, "200000")
            )
        except ValueError:
            _max_events_cached = 200_000
    return _max_events_cached


def dropped_events() -> int:
    return _dropped


def set_process_name(name: str) -> None:
    """Label this process in the exported trace (Perfetto's track group
    name). Re-emitted with the next recorded event."""
    global _process_name, _process_meta_emitted
    _process_name = name
    _process_meta_emitted = False


def reset_state() -> None:
    """Drop all buffered events, names, and base context (tests only)."""
    global _dropped, _process_meta_emitted
    with _lock:
        _events.clear()
        _threads_named.clear()
        _dropped = 0
        _process_meta_emitted = False
        _base_ctx.clear()


# ---------------------------------------------------------------------------
# Trace context (thread-local stack + process-wide base)
# ---------------------------------------------------------------------------


def current_context() -> Dict[str, Any]:
    """The merged trace context visible here: process-wide base
    (:func:`set_context`) overlaid by the :func:`context` stack of the
    current thread / asyncio task."""
    out = dict(_base_ctx)
    for entry in _ctx_stack_var.get():
        out.update(entry)
    return out


def set_context(**kv: Any) -> None:
    """Set process-wide base context (e.g. ``trial=0`` once per run).
    Written under ``_lock`` (rare, boundary-time call); readers snapshot
    without it — a torn read across two keys is harmless context, not
    data."""
    with _lock:
        _base_ctx.update(kv)


_service_armed_cached: Optional[bool] = None


def _service_armed() -> bool:
    """Is a multi-job service plane armed (``RSDL_SERVICE``)? One cached
    environment read, never an import: context propagation stays
    import-free on its hot path."""
    global _service_armed_cached
    if _service_armed_cached is None:
        raw = os.environ.get("RSDL_SERVICE", "").strip().lower()
        _service_armed_cached = raw not in ("", "off", "0", "false", "no")
    return _service_armed_cached


def outbound_context() -> Optional[Dict[str, Any]]:
    """The context to ship with a cross-process call, or None when there
    is nothing to ship (both telemetry halves off, or the merged context
    is empty): the one definition of what crosses the task, actor and
    cluster boundaries. The metrics half needs the (trial, epoch)
    identity too (events and task records attribute by epoch), so the
    context ships whenever either half is on. A multi-job service plane
    (``RSDL_SERVICE``) ships it even with both off, since its workers
    attribute audit digests to a job only through this context; with all
    three off this is one cached boolean check."""
    if not enabled():
        from ray_shuffling_data_loader_tpu_torch.telemetry import (
            metrics as _metrics,
        )

        if not _metrics.enabled() and not _service_armed():
            return None
    return current_context() or None


@contextmanager
def context(**kv: Any):
    """Push context keys for the dynamic extent of the block. Spans opened
    inside (on this thread) merge these into their args; the task/actor
    layers forward them across process boundaries."""
    if not kv:
        yield
        return
    entry = dict(kv)
    token = _ctx_stack_var.set(_ctx_stack_var.get() + (entry,))
    try:
        yield
    finally:
        try:
            _ctx_stack_var.reset(token)
        except ValueError:
            # Token minted in a different Context (a generator migrated
            # across tasks); drop the entry by identity instead.
            _ctx_stack_var.set(
                tuple(e for e in _ctx_stack_var.get() if e is not entry)
            )


# ---------------------------------------------------------------------------
# Recording
# ---------------------------------------------------------------------------


def _tid() -> int:
    return threading.get_native_id()


def _ensure_meta_locked(tid: int) -> None:
    global _process_meta_emitted
    pid = os.getpid()
    if not _process_meta_emitted:
        _events.append(
            {
                "name": "process_name",
                "ph": "M",
                "pid": pid,
                "tid": 0,
                "args": {"name": _process_name or f"py-{pid}"},
            }
        )
        _process_meta_emitted = True
    if tid not in _threads_named:
        _threads_named.add(tid)
        _events.append(
            {
                "name": "thread_name",
                "ph": "M",
                "pid": pid,
                "tid": tid,
                "args": {"name": threading.current_thread().name},
            }
        )


def _record(event: dict) -> None:
    global _dropped
    with _lock:
        if len(_events) >= _max_events():
            _dropped += 1
            return
        _ensure_meta_locked(event["tid"])
        _events.append(event)


def record_span(
    name: str,
    start_s: float,
    dur_s: float,
    cat: str = "rsdl",
    **args: Any,
) -> None:
    """Record a span retroactively from a wall-clock start and duration —
    for sites that already measured the interval (e.g. the consumer-stall
    accounting of the device stager)."""
    if not enabled():
        return
    merged = current_context()
    merged.update(args)
    _record(
        {
            "name": name,
            "cat": cat,
            "ph": "X",
            "ts": start_s * 1e6,
            "dur": max(0.0, dur_s) * 1e6,
            "pid": os.getpid(),
            "tid": _tid(),
            "args": merged,
        }
    )


def instant(name: str, cat: str = "rsdl", **args: Any) -> None:
    """Record an instant marker (a vertical tick on the timeline)."""
    if not enabled():
        return
    merged = current_context()
    merged.update(args)
    _record(
        {
            "name": name,
            "cat": cat,
            "ph": "i",
            "s": "t",
            "ts": time.time() * 1e6,
            "pid": os.getpid(),
            "tid": _tid(),
            "args": merged,
        }
    )


class Span:
    """A live span; use via ``with trace_span(...) as sp``. ``sp.set(k=v)``
    attaches attrs discovered mid-span. ``tid`` overrides the recorded
    thread id — for virtual tracks where slices on one real thread can
    overlap without nesting (asyncio-interleaved actor dispatches), which
    the Chrome-trace viewers cannot render on a single track."""

    __slots__ = ("name", "cat", "args", "_ts", "_t0", "_tid")

    def __init__(self, name: str, cat: str, args: Dict[str, Any],
                 tid: Optional[int] = None):
        self.name = name
        self.cat = cat
        self.args = args
        self._tid = tid

    def set(self, **kv: Any) -> None:
        self.args.update(kv)

    def __enter__(self) -> "Span":
        merged = current_context()
        merged.update(self.args)
        self.args = merged
        _tls.depth = getattr(_tls, "depth", 0) + 1
        self._ts = time.time()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        dur = time.perf_counter() - self._t0
        if exc_type is not None:
            self.args.setdefault("error", exc_type.__name__)
        _record(
            {
                "name": self.name,
                "cat": self.cat,
                "ph": "X",
                "ts": self._ts * 1e6,
                "dur": dur * 1e6,
                "pid": os.getpid(),
                "tid": self._tid if self._tid is not None else _tid(),
                "args": self.args,
            }
        )
        _tls.depth = max(0, getattr(_tls, "depth", 1) - 1)
        # Flush on ANY close (rate-limited inside _maybe_flush), not only
        # at depth 0: an async actor serving interleaved dispatches —
        # e.g. the batch queue under the PR-3 supervised consumer, which
        # keeps a get_batch dispatch span open almost continuously — may
        # never reach depth 0 mid-run, and gating on quiescence starved
        # its spool flushes until process exit (trace_export would miss
        # every span since the last lull). Events are only appended at
        # span close, so flushing mid-stack is always safe.
        _maybe_flush()
        return False


class _NullSpan:
    """Shared no-op stand-in returned while tracing is disabled."""

    __slots__ = ()

    def set(self, **kv: Any) -> None:
        pass

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NULL = _NullSpan()


def trace_span(name: str, cat: str = "rsdl", tid: Optional[int] = None,
               **args: Any):
    """Open a span covering the ``with`` block. When tracing is disabled
    this returns a shared no-op object — the disabled cost is one cached
    boolean check."""
    if not enabled():
        return _NULL
    _register_atexit()
    return Span(name, cat, args, tid=tid)


def name_thread_track(tid: int, name: str) -> None:
    """Label a (possibly virtual) thread track in the exported trace.
    First call per tid wins; later automatic naming is skipped."""
    if not enabled():
        return
    with _lock:
        if tid in _threads_named:
            return
        _threads_named.add(tid)
        _events.append(
            {
                "name": "thread_name",
                "ph": "M",
                "pid": os.getpid(),
                "tid": tid,
                "args": {"name": name},
            }
        )


@contextmanager
def propagated_span(name: str, ctx: Optional[Dict[str, Any]],
                    cat: str = "task", tid: Optional[int] = None):
    """Re-enter a remote caller's trace context and open a span — the
    receive side of cross-process propagation (task workers, actor
    dispatch). With tracing disabled no span opens, but a shipped
    context is still re-entered when present (the metrics half ships
    one for epoch attribution — see :func:`outbound_context`); with
    nothing shipped this is a no-op."""
    if not enabled():
        if ctx:
            with context(**ctx):
                yield
        else:
            yield
        return
    with context(**(ctx or {})):
        with trace_span(name, cat=cat, tid=tid):
            yield


# ---------------------------------------------------------------------------
# Flushing and export
# ---------------------------------------------------------------------------


def _register_atexit() -> None:
    global _atexit_registered
    if not _atexit_registered:
        _atexit_registered = True
        atexit.register(flush)


def flush() -> None:
    """Drain this process's buffer to its spool file. No-op without a
    spool directory (events then stay in memory for a local export)."""
    global _last_flush
    directory = spool_dir()
    if not directory:
        return
    with _lock:
        if not _events:
            return
        drained = list(_events)
        _events.clear()
        _last_flush = time.monotonic()
    try:
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory, f"trace-{os.getpid()}.jsonl")
        with open(path, "a") as f:
            for event in drained:
                f.write(json.dumps(event) + "\n")
    except OSError:
        # Telemetry must never sink the run; the drained events are lost.
        pass


def safe_flush() -> None:
    """Guarded flush for process-teardown paths (task done, actor exit):
    no-op when tracing is off, never raises — telemetry must not sink
    the exiting process."""
    if not enabled():
        return
    try:
        flush()
    except Exception:
        pass


def _maybe_flush() -> None:
    if spool_dir() is None:
        return
    with _lock:
        due = len(_events) >= _FLUSH_EVENTS or (
            _events
            and time.monotonic() - _last_flush > _FLUSH_INTERVAL_S
        )
    if due:
        flush()


def trace_export(path: str) -> str:
    """Merge this process's buffer and every spool file into ONE Chrome
    trace JSON at ``path`` (open with chrome://tracing or
    https://ui.perfetto.dev). Returns ``path``."""
    flush()
    events: List[dict] = []
    directory = spool_dir()
    if directory and os.path.isdir(directory):
        for fname in sorted(os.listdir(directory)):
            if not (fname.startswith("trace-") and fname.endswith(".jsonl")):
                continue
            try:
                with open(os.path.join(directory, fname)) as f:
                    for line in f:
                        line = line.strip()
                        if not line:
                            continue
                        try:
                            events.append(json.loads(line))
                        except ValueError:
                            continue  # torn concurrent append; skip
            except OSError:
                continue
    with _lock:
        events.extend(_events)  # no-spool mode: the local buffer
    # Metadata first, then chronological — what the viewers expect.
    events.sort(key=lambda e: (e.get("ph") != "M", e.get("ts", 0)))
    payload = {"traceEvents": events, "displayTimeUnit": "ms"}
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f)
    os.replace(tmp, path)
    return path
