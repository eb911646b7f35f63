"""The metrics registry across processes: a spool file per process and
their merge.

* **Spool.** Every process writes its registry's typed snapshot
  (:meth:`~.metrics.MetricsRegistry.typed_snapshot`: a flat float dict
  cannot be merged right), its source identity (role, host, pid) and a
  timestamp to one JSON file under ``$RSDL_RUNTIME_DIR/metrics``
  (``RSDL_METRICS_DIR`` overrides). Each flush replaces the file
  atomically: instruments are cumulative within a process, so its latest
  snapshot is the whole truth. Task workers flush before they report a
  task done (``runtime/tasks.py``), actor hosts after a dispatch (at most
  once a second) and at exit (``runtime/actor.py``), the driver's store
  sampler every period (``stats.py``) and the runtime at shutdown.
* **Merge.** :func:`aggregate` folds every spool record and the live
  local registry into one view: counters **sum** across sources, gauges
  keep the **latest by record timestamp**, histograms merge their
  components (count and sum add, min and max widen). ``per_source=True``
  adds each source's values as ``source=<role>-<pid>`` labelled series;
  ``max_age_s`` drops the records of sources that stopped flushing.

Off with the metrics half: with ``RSDL_METRICS`` unset, :func:`safe_flush`
is one cached boolean and no file is written. The merge reads files only,
never an actor, so it is safe on error paths. The record format and the
merge are the JAX package's, so either package aggregates the other's
spool.

This module imports the standard library only.
"""

from __future__ import annotations

import json
import os
import socket
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from ray_shuffling_data_loader_tpu_torch.telemetry import metrics as _metrics

ENV_METRICS_DIR = "RSDL_METRICS_DIR"
_RUNTIME_DIR_ENV = "RSDL_RUNTIME_DIR"

# Rate limit for maybe_flush (actor quiescence fires per dispatch lull;
# a file replace per lull would be real I/O on chatty actors).
_FLUSH_MIN_INTERVAL_S = 1.0

_flush_lock = threading.Lock()
_last_flush = 0.0


def spool_dir() -> Optional[str]:
    """Where this process spools its snapshots: ``RSDL_METRICS_DIR`` when
    set, else ``$RSDL_RUNTIME_DIR/metrics`` (every process joined to a
    runtime session carries that env var), else None (no spool — the
    local registry is the only view, fine for single-process use)."""
    explicit = os.environ.get(ENV_METRICS_DIR)
    if explicit:
        return explicit
    runtime_dir = os.environ.get(_RUNTIME_DIR_ENV)
    if runtime_dir:
        return os.path.join(runtime_dir, "metrics")
    return None


def source_identity() -> Dict[str, Any]:
    """This process's identity on its spool record: the fault plane's
    process role (``driver``, ``task``, ``actor``: the tag that
    ``RSDL_FAULTS`` ``/role`` filters match), hostname and pid, and the
    job the process works for when it has one."""
    try:
        from ray_shuffling_data_loader_tpu_torch.runtime import faults

        role = faults.role()
    except Exception:
        role = "driver"
    ident: Dict[str, Any] = {
        "role": role, "host": socket.gethostname(), "pid": os.getpid(),
    }
    job = os.environ.get("RSDL_JOB_ID") or None
    if job:
        ident["job"] = job
    return ident


def _spool_path(directory: str, ident: Dict[str, Any]) -> str:
    return os.path.join(
        directory, f"metrics-{ident['role']}-{ident['pid']}.json"
    )


def flush() -> Optional[str]:
    """Replace this process's spool file with the current typed registry
    snapshot. No-op (returns None) when metrics are off, no spool dir is
    configured, or the registry holds no instruments — so a metrics-on
    process with nothing to say leaves no file. Never raises into the
    caller's data path; returns the written path otherwise."""
    global _last_flush
    if not _metrics.enabled():
        return None
    directory = spool_dir()
    if not directory:
        return None
    typed = _metrics.registry.typed_snapshot()
    if not typed:
        return None
    ident = source_identity()
    record = {"source": ident, "ts": time.time(), "metrics": typed}
    path = _spool_path(directory, ident)
    tmp = f"{path}.tmp{os.getpid()}"
    try:
        os.makedirs(directory, exist_ok=True)
        with open(tmp, "w") as f:
            json.dump(record, f)
        os.replace(tmp, path)
    except OSError:
        # Telemetry must never sink the run (full disk, read-only spool).
        return None
    with _flush_lock:
        _last_flush = time.monotonic()
    return path


def maybe_flush() -> None:
    """Rate-limited :func:`flush` for chatty sites (actor dispatch
    quiescence): at most one file replace per
    ``_FLUSH_MIN_INTERVAL_S``."""
    if not _metrics.enabled():
        return
    with _flush_lock:
        if time.monotonic() - _last_flush < _FLUSH_MIN_INTERVAL_S:
            return
    try:
        flush()
    except Exception:
        pass


def safe_flush() -> None:
    """Guarded flush for process-teardown paths (task done, actor exit):
    no-op when metrics are off, never raises."""
    if not _metrics.enabled():
        return
    try:
        flush()
    except Exception:
        pass


def clear_spool() -> None:
    """Unlink every spool file (tests and explicit run boundaries; the
    spool is normally scoped by the per-session runtime dir, which the
    session owner removes on shutdown)."""
    directory = spool_dir()
    if not directory or not os.path.isdir(directory):
        return
    for fname in os.listdir(directory):
        if fname.startswith("metrics-") and fname.endswith(".json"):
            try:
                os.unlink(os.path.join(directory, fname))
            except OSError:
                pass


def load_records(max_age_s: Optional[float] = None) -> List[dict]:
    """Every parseable spool record, oldest-file-name first. With
    ``max_age_s``, records whose ``ts`` is older than ``now - max_age_s``
    are dropped (stale-source expiry: a process that stopped flushing —
    wedged, or from an abandoned run sharing the spool — no longer
    contributes). Comparing a record's ``ts`` against this process's
    clock is only sound when writer and reader share a clock (one host,
    or a spool whose records are restamped on arrival)."""
    out: List[dict] = []
    directory = spool_dir()
    if not directory or not os.path.isdir(directory):
        return out
    now = time.time()
    for fname in sorted(os.listdir(directory)):
        if not (fname.startswith("metrics-") and fname.endswith(".json")):
            continue
        try:
            with open(os.path.join(directory, fname)) as f:
                rec = json.load(f)
        except (OSError, ValueError):
            continue  # torn replace or foreign file; skip
        if not isinstance(rec, dict) or "metrics" not in rec:
            continue
        if (
            max_age_s is not None
            and now - float(rec.get("ts", 0.0)) > max_age_s
        ):
            continue
        out.append(rec)
    return out


# ---------------------------------------------------------------------------
# Merging
# ---------------------------------------------------------------------------


def _merge_entry(cur: Dict[str, Any], new: Dict[str, Any], ts: float) -> None:
    """Fold one typed metric entry into the accumulator, per-kind:
    counter sum, gauge latest-by-timestamp, histogram component merge.
    A kind conflict (one process registered ``x`` as a counter, another
    as a gauge) resolves latest-wins rather than corrupting either."""
    kind = new.get("kind")
    if kind != cur.get("kind"):
        if ts >= cur.get("_ts", 0.0):
            cur.clear()
            cur.update(new)
            cur["_ts"] = ts
        return
    if kind == "counter":
        cur["value"] = float(cur.get("value", 0.0)) + float(
            new.get("value", 0.0)
        )
    elif kind == "gauge":
        if ts >= cur.get("_ts", 0.0):
            cur["value"] = new.get("value", 0.0)
            cur["_ts"] = ts
    elif kind == "histogram":
        cur["count"] = int(cur.get("count", 0)) + int(new.get("count", 0))
        cur["sum"] = float(cur.get("sum", 0.0)) + float(new.get("sum", 0.0))
        for field, pick in (("min", min), ("max", max)):
            if field in new:
                cur[field] = (
                    pick(cur[field], new[field])
                    if field in cur
                    else new[field]
                )
    else:  # unknown kind from a newer writer: latest-wins
        if ts >= cur.get("_ts", 0.0):
            cur.clear()
            cur.update(new)
            cur["_ts"] = ts


def _with_source_label(
    key: str,
    source: str,
    job: Optional[str] = None,
    host: Optional[str] = None,
) -> str:
    """Inject ``source=<source>`` (plus the source's ``job=`` and
    ``host=`` identities, when it has them and the key does not already
    carry those labels) into a canonical snapshot key, keeping label
    order sorted (so the result matches :func:`.metrics.format_key`
    output) and any labeled-histogram name suffix in place. The host
    label keeps two hosts' per-source series apart even when their roles
    and pids collide."""
    brace, close = key.find("{"), key.rfind("}")
    if 0 <= brace < close:
        name, suffix = key[:brace], key[close + 1:]
        pairs = [
            tuple(part.partition("=")[::2])
            for part in key[brace + 1:close].split(",")
        ]
    else:
        name, suffix = key, ""
        pairs = []
    pairs.append(("source", source))
    if job and all(k != "job" for k, _ in pairs):
        pairs.append(("job", job))
    if host and all(k != "host" for k, _ in pairs):
        pairs.append(("host", host))
    inner = ",".join(f"{k}={v}" for k, v in sorted(pairs))
    return f"{name}{{{inner}}}{suffix}"


def labeled_sum(
    flat: Dict[str, float], name: str
) -> Tuple[float, Dict[str, float]]:
    """``(total, by_label)`` of a counter across its labeled series in a
    flat :func:`aggregate` view: the bare ``name`` entry plus every
    ``name{k=v,...}`` series (the :func:`.metrics.format_key` shape —
    this helper lives beside the key format so callers never re-parse
    it). ``by_label`` maps the ``{...}`` suffix to its value: the one
    definition of a label-aware counter total (the decode counters carry
    ``{schedule, plan}`` labels)."""
    total, by_label = 0.0, {}
    prefix = name + "{"
    for key, value in flat.items():
        if key == name:
            total += value
        elif key.startswith(prefix):
            total += value
            by_label[key[len(name):]] = value
    return total, by_label


def aggregate_typed(
    max_age_s: Optional[float] = None,
    include_local: bool = True,
    per_source: bool = False,
) -> Dict[str, Dict[str, Any]]:
    """Fold every spool record (plus the live local registry) into one
    kind-preserving view — the merge core behind :func:`aggregate`.
    Spool records written by THIS process are skipped when the live
    registry is included (the registry is the same data, fresher).
    Returns ``{key: {"kind": ..., ...}}``; per-source breakdown rides as
    ``source=<role>-<pid>`` labeled keys when requested."""
    merged: Dict[str, Dict[str, Any]] = {}
    me = source_identity()

    def fold(
        typed: Dict[str, Dict[str, Any]],
        ts: float,
        source: Optional[str],
        job: Optional[str] = None,
        host: Optional[str] = None,
    ) -> None:
        for key, entry in typed.items():
            cur = merged.get(key)
            if cur is None:
                merged[key] = {**entry, "_ts": ts}
            else:
                _merge_entry(cur, entry, ts)
            if per_source and source is not None:
                skey = _with_source_label(key, source, job=job, host=host)
                merged[skey] = {**entry, "_ts": ts}

    for rec in load_records(max_age_s=max_age_s):
        src = rec.get("source") or {}
        if (
            include_local
            and _metrics.enabled()
            and src.get("pid") == me["pid"]
            and src.get("host") == me["host"]
        ):
            continue  # the live registry below supersedes our own file
        label = f"{src.get('role', 'unknown')}-{src.get('pid', '0')}"
        fold(
            rec.get("metrics", {}), float(rec.get("ts", 0.0)), label,
            job=src.get("job"), host=src.get("host"),
        )
    if include_local and _metrics.enabled():
        local = _metrics.registry.typed_snapshot()
        if local:
            fold(
                local, time.time(), f"{me['role']}-{me['pid']}",
                job=me.get("job"), host=me["host"],
            )
    return merged


def flatten(typed: Dict[str, Dict[str, Any]]) -> Dict[str, float]:
    """A typed view flattened to the plain snapshot vocabulary
    (histograms expand to ``_count/_sum/_min/_max``, matching
    :meth:`~.metrics.Histogram.snapshot_into`)."""
    out: Dict[str, float] = {}
    for key, entry in typed.items():
        if entry.get("kind") == "histogram":
            out[f"{key}_count"] = float(entry.get("count", 0))
            out[f"{key}_sum"] = float(entry.get("sum", 0.0))
            if entry.get("count"):
                if "min" in entry:
                    out[f"{key}_min"] = float(entry["min"])
                if "max" in entry:
                    out[f"{key}_max"] = float(entry["max"])
        else:
            out[key] = float(entry.get("value", 0.0))
    return out


def kinds_of(typed: Dict[str, Dict[str, Any]]) -> Dict[str, str]:
    """The ``{key: kind}`` map of a typed view — feeds
    :func:`.metrics.to_prometheus_text`'s ``# TYPE`` lines."""
    return {key: entry.get("kind", "untyped") for key, entry in typed.items()}


def aggregate(
    max_age_s: Optional[float] = None,
    include_local: bool = True,
    per_source: bool = False,
) -> Dict[str, float]:
    """The cluster-aggregated flat snapshot: every process's spooled
    registry plus the local live one, merged with correct per-kind
    semantics: what a ``/metrics`` endpoint serves. A pure file read, no
    actor call, safe on error paths."""
    return flatten(
        aggregate_typed(
            max_age_s=max_age_s,
            include_local=include_local,
            per_source=per_source,
        )
    )


def prometheus_text(max_age_s: Optional[float] = None) -> str:
    """The aggregated view rendered as Prometheus exposition text with
    per-source breakdown and ``# TYPE`` lines — the ``/metrics`` body."""
    typed = aggregate_typed(max_age_s=max_age_s, per_source=True)
    return _metrics.to_prometheus_text(flatten(typed), kinds=kinds_of(typed))
