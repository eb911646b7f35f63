"""The port's telemetry planes, each off by default:

* :mod:`.metrics` (``RSDL_METRICS``): counters, gauges and histograms, a
  sampled timeline and the Prometheus text format; imported here, as it is
  the gate every other plane checks;
* :mod:`.trace` (``RSDL_TRACE``, ``RSDL_TRACE_DIR``): spans, context
  propagated across tasks, actors and hosts, and one Chrome/Perfetto JSON
  merged from every process (:func:`trace_export`);
* :mod:`.export`: every process's registry spooled and merged per kind;
* :mod:`.events`: the NDJSON event log (:func:`emit_event`);
* :mod:`.phases`: the per-phase cost inside a stage task;
* :mod:`.audit` (``RSDL_AUDIT``): the exactly-once digests of every side
  of the shuffle;
* :mod:`.stragglers`, :mod:`.critical`, :mod:`.capacity` (with
  ``RSDL_METRICS``): task records and the straggler view, the critical
  path of each epoch, the store's capacity ledger;
* :mod:`.timeseries` (``RSDL_TS``, or ``RSDL_OBS_PORT``, with metrics):
  the sampled history of the registry;
* :mod:`.profiler` (``RSDL_PROFILE``): a sampling profiler in every
  process;
* :mod:`.runledger` (``RSDL_RUN_LEDGER``): one record per finished run;
* :mod:`.slo` (with the time series): declarative alert rules;
* :mod:`.obs_server` (``RSDL_OBS_PORT``): the live HTTP endpoint;
* :mod:`.relay` (``RSDL_RELAY``): every host's spools shipped to the
  cluster's head.

Every plane but metrics resolves on first touch (PEP 562). A run with
every flag unset imports none of the others on the driver or on the
task-done path: wiring sites check :func:`metrics.enabled`
or ``sys.modules`` before any import. A worker's data path may import
:mod:`.phases` once, then pays one cached boolean per site.

Metric names, labels, event kinds, span names and record formats are the
JAX package's, letter for letter.

This package imports the standard library only; the audit module loads
numpy, for the pool workers that digest the map and reduce sides.
"""

import importlib
import sys
from typing import Any, Dict, Optional

from ray_shuffling_data_loader_tpu_torch.telemetry import _env
from ray_shuffling_data_loader_tpu_torch.telemetry import metrics  # noqa: F401

_TRACE_MODULE = f"{__name__}.trace"

# Names of telemetry.trace re-exported here, resolved on first touch and
# then cached in this module's globals.
_TRACE_NAMES = frozenset(
    (
        "ENV_TRACE",
        "ENV_TRACE_DIR",
        "Span",
        "context",
        "current_context",
        "disable",
        "dropped_events",
        "enable",
        "enabled",
        "flush",
        "instant",
        "name_thread_track",
        "outbound_context",
        "propagated_span",
        "record_span",
        "refresh_from_env",
        "reset_state",
        "safe_flush",
        "set_context",
        "set_process_name",
        "spool_dir",
        "trace_export",
        "trace_span",
    )
)

# Submodules resolved as attributes on first touch; the import system then
# binds each onto the package, and __getattr__ is not asked again.
_LAZY_SUBMODULES = frozenset(
    (
        "audit",
        "trace",
        "export",
        "events",
        "phases",
        "stragglers",
        "critical",
        "capacity",
        "timeseries",
        "profiler",
        "runledger",
        "slo",
        "obs_server",
    )
)


def __getattr__(name):
    if name in _TRACE_NAMES:
        from ray_shuffling_data_loader_tpu_torch.telemetry import trace

        value = getattr(trace, name)
        globals()[name] = value
        return value
    if name in _LAZY_SUBMODULES:
        return importlib.import_module(f"{__name__}.{name}")
    if name in ("metrics_snapshot", "metrics_dump"):
        value = metrics.global_snapshot if name == "metrics_snapshot" else metrics.dump_json
        globals()[name] = value
        return value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def emit_event(kind: str, _flush: bool = False, **fields) -> None:
    """Record one structured event (:mod:`.events`). With ``RSDL_METRICS``
    off this is one cached boolean and the events module is not imported.
    ``_flush=True`` drains the buffer to the spool at once (epoch and run
    boundaries). Never raises into the caller."""
    if not metrics.enabled():
        return
    try:
        from ray_shuffling_data_loader_tpu_torch.telemetry import events

        events.emit(kind, **fields)
        if _flush:
            events.safe_flush()
    except Exception:
        pass


# -- gates that import nothing while every plane is off ------------------------

_trace_flag: Optional[bool] = None  # RSDL_TRACE, read once while trace is not loaded


def traced() -> bool:
    """Is tracing on? :func:`.trace.enabled` once the trace module is
    loaded; before that, one cached read of ``RSDL_TRACE``, so the check
    imports nothing (:func:`.trace.refresh_from_env` clears the cache)."""
    global _trace_flag
    mod = sys.modules.get(_TRACE_MODULE)
    if mod is not None:
        return mod.enabled()
    if _trace_flag is None:
        _trace_flag = _env.read_flag("RSDL_TRACE")
    return _trace_flag


def active() -> bool:
    """Is the metrics or the trace half on in this process?"""
    return metrics.enabled() or traced()


def outbound() -> Optional[Dict[str, Any]]:
    """:func:`.trace.outbound_context`, or None without an import when no
    context can exist (the trace module, which holds it, never loaded) and
    metrics are off: what the task, actor and cluster layers ship."""
    if sys.modules.get(_TRACE_MODULE) is None and not metrics.enabled():
        return None
    from ray_shuffling_data_loader_tpu_torch.telemetry import trace

    return trace.outbound_context()


class _NullScope:
    """The shared no-op of :func:`scope`, :func:`span` and
    :func:`stage_profiler` (and of its phases) while every plane is off."""

    __slots__ = ()

    def set(self, **kv: Any) -> None:
        pass

    def phase(self, name: str, nbytes: Optional[int] = None) -> "_NullScope":
        return self

    def add_bytes(self, n: int) -> None:
        pass

    def totals(self) -> Dict[str, float]:
        return {}

    def wall(self) -> float:
        return 0.0

    def __enter__(self) -> "_NullScope":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NULL_SCOPE = _NullScope()


def scope(**kv: Any):
    """:func:`.trace.context` while a plane is on, else a shared no-op:
    the driver's epoch context at the cost of one cached boolean."""
    if not active():
        return _NULL_SCOPE
    from ray_shuffling_data_loader_tpu_torch.telemetry import trace

    return trace.context(**kv)


def span(name: str, cat: str = "rsdl", **args: Any):
    """:func:`.trace.trace_span` while tracing is on, else a shared no-op
    that imports nothing."""
    if not traced():
        return _NULL_SCOPE
    from ray_shuffling_data_loader_tpu_torch.telemetry import trace

    return trace.trace_span(name, cat=cat, **args)


_profile_flag: Optional[bool] = None  # RSDL_PROFILE, read once


def stage_profiler(stage: str, **args: Any):
    """:func:`.phases.stage_profiler` while a plane is on or
    ``RSDL_PROFILE`` is set, else the shared no-op, without importing the
    phases module."""
    global _profile_flag
    if _profile_flag is None:
        _profile_flag = _env.read_flag("RSDL_PROFILE")
    if not (_profile_flag or active()):
        return _NULL_SCOPE
    from ray_shuffling_data_loader_tpu_torch.telemetry import phases

    return phases.stage_profiler(stage, **args)
