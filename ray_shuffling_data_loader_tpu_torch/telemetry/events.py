"""The structured event log: discrete things that happened, as NDJSON.

Metrics say how much and how fast, the trace where the time went; the
event log records that a thing happened at a moment: an epoch started,
a map burned a retry, a host agent was evicted, the store spilled, a
producer died. Records are flat JSON objects::

    {"ts": 1722700000.1, "kind": "epoch.start", "role": "driver",
     "host": "host-1", "pid": 1234, "epoch": 3, "schedule": "index"}

``trial``, ``epoch`` and ``schedule`` come from the ambient trace context
(:func:`.trace.current_context`) where present; explicit fields win. The
role is the fault plane's process role.

Off with ``RSDL_METRICS``: :func:`telemetry.emit_event` (the facade every
wiring site calls) returns after one cached boolean and this module is
not imported. The buffer drains at 64 records, at exit, and before a task
reports done (``runtime/tasks.py``: a resolved future implies its events
are on the spool). Spool: ``RSDL_EVENTS_DIR``, else
``$RSDL_RUNTIME_DIR/events`` (one append-only ``events-<pid>.ndjson`` per
process); without either the records stay in the buffer (at most 4096).
The record format is the JAX package's.

This module imports the standard library only.
"""

from __future__ import annotations

import atexit
import json
import os
import socket
import threading
import time
from typing import Any, Dict, List, Optional

from ray_shuffling_data_loader_tpu_torch.telemetry import metrics as _metrics

ENV_EVENTS_DIR = "RSDL_EVENTS_DIR"
_RUNTIME_DIR_ENV = "RSDL_RUNTIME_DIR"

# The event vocabulary (the JAX package's). Not enforced —
# wiring sites may add kinds — but documenting it here keeps dashboards
# and the epoch-report join honest about what they can rely on.
KINDS = (
    "trial.start",      # shuffle() admitted a trial (driver)
    "trial.done",       # ... and finished cleanly
    "trial.failed",     # ... or raised
    "epoch.start",      # one epoch's pipeline kicked off (driver)
    "epoch.done",       # delivery finished for the epoch
    "epoch.failed",     # the epoch's delivery thread died
    "stage.retry",      # a map/reduce attempt failed and was re-executed
    "recovery",         # a recovery.* counter fired (rematerialize, ...)
    "task.failover",    # cluster scheduler moved a task off a dead host
    "agent.evicted",    # a host agent was dropped from the rotation
    "store.spill",      # the store placed a segment on disk (budget hit)
    "producer.died",    # consumer-side producer-liveness trip
    "straggler.wedged",  # the straggler detector flagged an in-flight task
    "alert.fired",      # an SLO rule's condition held for its for_s
    "alert.resolved",   # ... and later cleared (telemetry/slo.py)
    "run.suspended",    # a journaled run quiesced + exited (preemption
                        # notice; runtime/journal.py)
    "run.resumed",      # a fresh driver reconstructed a journaled
                        # epoch window (shuffle(resume_from=))
    "epoch.replayed",   # a replay re-ran a journaled epoch and
                        # compared digests
)

# Flush when the buffer reaches this many records (plus the explicit
# flush points: task-done, atexit, /events can read the live buffer).
_FLUSH_AT = 64
# Hard cap when no spool dir exists (flush cannot drain): drop the
# oldest records rather than grow without bound in a long-lived
# process that enabled metrics programmatically outside a session.
_MAX_BUFFER = 4096

_lock = threading.Lock()
_buffer: List[dict] = []
_atexit_registered = False


def enabled() -> bool:
    """Events ride the metrics half: one env gate (``RSDL_METRICS``)
    governs the whole live-observability plane."""
    return _metrics.enabled()


def spool_dir() -> Optional[str]:
    explicit = os.environ.get(ENV_EVENTS_DIR)
    if explicit:
        return explicit
    runtime_dir = os.environ.get(_RUNTIME_DIR_ENV)
    if runtime_dir:
        return os.path.join(runtime_dir, "events")
    return None


def _register_atexit() -> None:
    global _atexit_registered
    if not _atexit_registered:
        _atexit_registered = True
        atexit.register(safe_flush)


def emit(kind: str, **fields: Any) -> None:
    """Record one event. Ambient trace context (trial/epoch/schedule)
    is merged under explicit fields; identity (role/host/pid) is
    stamped per record so multi-process spools merge cleanly. Never
    raises into the caller's data path."""
    if not enabled():
        return
    try:
        from ray_shuffling_data_loader_tpu_torch.runtime import faults as _faults

        role = _faults.role()
    except Exception:
        role = "driver"
    rec: Dict[str, Any] = {
        "ts": time.time(),
        "kind": str(kind),
        "role": role,
        "host": socket.gethostname(),
        "pid": os.getpid(),
    }
    try:
        from ray_shuffling_data_loader_tpu_torch import telemetry as _t

        for key, value in (_t.current_context() or {}).items():
            if key not in fields:
                rec[key] = value
    except Exception:
        pass
    rec.update(fields)
    _register_atexit()
    with _lock:
        _buffer.append(rec)
        should_flush = len(_buffer) >= _FLUSH_AT
        if len(_buffer) > _MAX_BUFFER:
            del _buffer[: len(_buffer) - _MAX_BUFFER]
    if should_flush:
        safe_flush()


def flush() -> None:
    """Drain the local buffer to this process's spool file (append-only
    NDJSON). No-op without a spool directory — records then stay in the
    buffer for same-process queries."""
    directory = spool_dir()
    if not directory:
        return
    with _lock:
        if not _buffer:
            return
        drained = list(_buffer)
        _buffer.clear()
    try:
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory, f"events-{os.getpid()}.ndjson")
        with open(path, "a") as f:
            for rec in drained:
                f.write(json.dumps(rec, default=str) + "\n")
    except OSError:
        # The event log must never sink the run; the records are lost.
        pass


def safe_flush() -> None:
    """Guarded flush for teardown paths (task-done, atexit): no-op when
    off, never raises."""
    if not enabled():
        return
    try:
        flush()
    except Exception:
        pass


def load(
    since: Optional[float] = None,
    kind: Optional[str] = None,
    limit: Optional[int] = None,
    job: Optional[str] = None,
) -> List[dict]:
    """Every event from the spool plus the local buffer, sorted by
    timestamp. ``since`` filters to ``ts >= since``; ``kind`` to exact
    kind; ``job`` to events stamped with that tenant's job id (the
    ambient ``job_context`` field); ``limit`` keeps the *latest* N
    after filtering."""
    out: List[dict] = []
    directory = spool_dir()
    if directory and os.path.isdir(directory):
        for fname in sorted(os.listdir(directory)):
            if not (fname.startswith("events-")
                    and fname.endswith(".ndjson")):
                continue
            try:
                with open(os.path.join(directory, fname)) as f:
                    for line in f:
                        line = line.strip()
                        if not line:
                            continue
                        try:
                            rec = json.loads(line)
                        except ValueError:
                            continue  # torn append; skip the line
                        if isinstance(rec, dict) and "kind" in rec:
                            out.append(rec)
            except OSError:
                continue
    with _lock:
        out.extend(_buffer)
    if since is not None:
        out = [r for r in out if float(r.get("ts", 0.0)) >= since]
    if kind is not None:
        out = [r for r in out if r.get("kind") == kind]
    if job is not None:
        out = [r for r in out if r.get("job") == job]
    out.sort(key=lambda r: float(r.get("ts", 0.0)))
    if limit is not None and limit >= 0:
        out = out[-limit:]
    return out


def counts(records: Optional[List[dict]] = None) -> Dict[str, int]:
    """Per-kind event counts (over ``records`` or the full log)."""
    out: Dict[str, int] = {}
    for rec in (records if records is not None else load()):
        k = str(rec.get("kind", "unknown"))
        out[k] = out.get(k, 0) + 1
    return out


def reset(clear_spool: bool = False) -> None:
    """Drop the local buffer (tests and run boundaries); with
    ``clear_spool``, also unlink every spool file."""
    with _lock:
        _buffer.clear()
    if clear_spool:
        directory = spool_dir()
        if directory and os.path.isdir(directory):
            for fname in os.listdir(directory):
                if fname.startswith("events-") and fname.endswith(".ndjson"):
                    try:
                        os.unlink(os.path.join(directory, fname))
                    except OSError:
                        pass
