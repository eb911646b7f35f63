"""Per-task duration records and the straggler and skew view over them.

A few slow tasks, or one slow worker, hold a whole epoch back. This
module watches the task grain while the run goes on:

* **Records.** Every pool task that returns appends a flat record,
  ``(stage, host, pid, epoch, job, dur_s, nbytes, ts)``, from the
  worker's task-done path (``runtime/tasks.py``: flushed before the
  task is reported done, like the audit and metrics spools) into
  ``<metrics spool>/tasks/tasks-<pid>.ndjson``. A task that raised
  records nothing.
* **Detection.** :func:`analyze` folds every record and the live
  in-flight view (the worker pool registers a provider: which task
  functions started when, on which pid) into, per stage: count,
  median, p99, the **skew ratio** (p99 / median), the slowest host by
  mean duration, **flagged outliers** (tasks slower than ``k x`` the
  stage's median) and **wedged workers**: in-flight tasks already older
  than that budget, stuck now rather than slow in hindsight.
* **Surfacing.** :func:`publish_metrics` folds an analysis into the
  registry as ``straggler.*`` gauges (``rsdl_straggler_*`` on a
  scrape), refreshed on the time series' tick; :func:`status_section`
  is the trimmed view.

Every caller gates on ``RSDL_METRICS`` (one cached boolean) before it
imports this module, so a run with metrics off never loads it.

Knobs: ``RSDL_STRAGGLER_K`` (the outlier budget as a multiple of the
stage's median, default 4), ``RSDL_STRAGGLER_MIN_S`` (a floor, so that
millisecond medians do not flag everything, default 1 s).

The record format, the fold and the gauges are the JAX package's,
letter for letter. This module imports the standard library only.
"""

from __future__ import annotations

import json
import os
import socket
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from ray_shuffling_data_loader_tpu_torch.telemetry import export as _export
from ray_shuffling_data_loader_tpu_torch.telemetry import metrics as _metrics

ENV_STRAGGLER_K = "RSDL_STRAGGLER_K"
ENV_STRAGGLER_MIN_S = "RSDL_STRAGGLER_MIN_S"

# Task function -> stage name; other functions keep their own name as
# the stage.
STAGE_OF = {
    "shuffle_map": "map",
    "shuffle_plan": "plan",
    "shuffle_selective_plan": "plan",
    "shuffle_reduce": "reduce",
    "shuffle_gather_reduce": "gather-reduce",
    "shuffle_selective_reduce": "selective-reduce",
}

_FLAGGED_CAP = 16  # flagged-outlier rows kept per stage in the analysis

_lock = threading.Lock()
_records: List[dict] = []
_wedged_seen: set = set()  # (pid, stage) already event-logged as wedged

_inflight_lock = threading.Lock()
_inflight_providers: Dict[str, Callable[[], List[dict]]] = {}


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def budget_k() -> float:
    return max(1.0, _env_float(ENV_STRAGGLER_K, 4.0))


def budget_min_s() -> float:
    return max(0.0, _env_float(ENV_STRAGGLER_MIN_S, 1.0))


def stage_name(fn_name: str) -> str:
    return STAGE_OF.get(fn_name, fn_name)


def spool_dir() -> Optional[str]:
    """Task-record spool: a ``tasks/`` subdir of the metrics spool, so
    one ``RSDL_METRICS_DIR`` override relocates the whole plane."""
    directory = _export.spool_dir()
    if not directory:
        return None
    return os.path.join(directory, "tasks")


# ---------------------------------------------------------------------------
# Worker side: records
# ---------------------------------------------------------------------------


def record_task(
    fn_name: str,
    duration_s: float,
    nbytes: int = 0,
    epoch: Optional[int] = None,
    job: Optional[str] = None,
) -> None:
    """One completed task's record, buffered locally (the task-done
    flush drains it). Also observes ``task.duration_seconds{stage=}``
    so the cumulative distribution rides the ordinary metrics spool.
    ``job`` is the tenant a job-scoped context carries, so that a view
    can attribute per job. Caller gates on
    ``metrics.enabled()``; never raises."""
    try:
        stage = stage_name(fn_name)
        rec: Dict[str, Any] = {
            "ts": time.time(),
            "stage": stage,
            "host": socket.gethostname(),
            "pid": os.getpid(),
            "dur_s": float(duration_s),
        }
        if nbytes:
            rec["nbytes"] = int(nbytes)
        if epoch is not None:
            rec["epoch"] = int(epoch)
        if job is not None:
            rec["job"] = str(job)
        with _lock:
            _records.append(rec)
        _metrics.registry.histogram(
            "task.duration_seconds", stage=stage
        ).observe(float(duration_s))
    except Exception:
        pass


def flush() -> None:
    """Append the buffered records to this process's spool file. No-op
    without a spool dir (records stay local for same-process
    analysis)."""
    directory = spool_dir()
    if not directory:
        return
    with _lock:
        if not _records:
            return
        drained = list(_records)
        _records.clear()
    try:
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory, f"tasks-{os.getpid()}.ndjson")
        with open(path, "a") as f:
            for rec in drained:
                f.write(json.dumps(rec) + "\n")
    except OSError:
        pass  # never sink the run


def safe_flush() -> None:
    if not _metrics.enabled():
        return
    try:
        flush()
    except Exception:
        pass


# Per-file tail-read cache for the LIVE spool (the sampler tick calls
# analyze() every period; re-parsing the whole append-only history each
# tick would make the tick cost grow with run length). Keyed by path:
# [bytes consumed, parsed records]. Guarded by _cache_lock.
_read_cache: Dict[str, list] = {}
_cache_lock = threading.Lock()


def _read_file_records(fpath: str, use_cache: bool) -> List[dict]:
    cached = None
    if use_cache:
        with _cache_lock:
            cached = _read_cache.get(fpath)
    offset = cached[0] if cached else 0
    try:
        size = os.path.getsize(fpath)
        if cached and size < offset:
            cached, offset = None, 0  # truncated/replaced: re-read
        if cached and size == offset:
            return list(cached[1])
        new: List[dict] = []
        with open(fpath) as f:
            f.seek(offset)
            for line in f:
                if not line.endswith("\n"):
                    break  # torn tail mid-append; re-read next time
                offset += len(line.encode())
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if isinstance(rec, dict) and "dur_s" in rec:
                    new.append(rec)
    except OSError:
        return list(cached[1]) if cached else []
    records = (cached[1] if cached else []) + new
    if use_cache:
        with _cache_lock:
            _read_cache[fpath] = [offset, records]
    return list(records)


def load_records(path: Optional[str] = None) -> List[dict]:
    """Every spooled task record plus the local buffer. ``path``
    overrides the spool dir (post-hoc tools); it may be a directory of
    ``tasks-*.ndjson`` files or one NDJSON file. Live-spool reads are
    incremental: the spool files are append-only, so each file is
    tail-read from the last consumed offset."""
    out: List[dict] = []
    directory = path if path is not None else spool_dir()
    files: List[str] = []
    if directory:
        if os.path.isdir(directory):
            files = [
                os.path.join(directory, f)
                for f in sorted(os.listdir(directory))
                if f.startswith("tasks-") and f.endswith(".ndjson")
            ]
        elif os.path.isfile(directory):
            files = [directory]
    for fpath in files:
        out.extend(_read_file_records(fpath, use_cache=path is None))
    if path is None:
        with _lock:
            out.extend(_records)
    return out


def reset(clear_spool: bool = False) -> None:
    with _lock:
        _records.clear()
        _wedged_seen.clear()
    with _cache_lock:
        _read_cache.clear()
    if clear_spool:
        directory = spool_dir()
        if directory and os.path.isdir(directory):
            for fname in os.listdir(directory):
                if fname.startswith("tasks-") and fname.endswith(".ndjson"):
                    try:
                        os.unlink(os.path.join(directory, fname))
                    except OSError:
                        pass


# ---------------------------------------------------------------------------
# In-flight providers (the wedged-worker feed)
# ---------------------------------------------------------------------------


def register_inflight_provider(
    name: str, fn: Callable[[], List[dict]]
) -> None:
    """Register a callable returning the live in-flight task list:
    ``[{"stage", "pid", "age_s"}, ...]`` (the worker pool registers
    one per pool). Cheap dict set; re-use replaces."""
    with _inflight_lock:
        _inflight_providers[name] = fn


def unregister_inflight_provider(name: str) -> None:
    with _inflight_lock:
        _inflight_providers.pop(name, None)


def _in_flight() -> List[dict]:
    with _inflight_lock:
        providers = list(_inflight_providers.values())
    out: List[dict] = []
    for fn in providers:
        try:
            out.extend(fn() or [])
        except Exception:
            continue  # a dead pool must not break the page
    return out


# ---------------------------------------------------------------------------
# Driver side: analysis
# ---------------------------------------------------------------------------


def _quantile(sorted_vals: List[float], q: float) -> float:
    """Nearest-rank quantile over an already-sorted list."""
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, max(0, int(q * len(sorted_vals))))
    return sorted_vals[idx]


def analyze(
    records: Optional[List[dict]] = None,
    in_flight: Optional[List[dict]] = None,
    now: Optional[float] = None,
) -> Dict[str, Any]:
    """The full straggler/skew view. Pure fold over the records plus
    the in-flight list — no RPCs, safe on error paths."""
    now = time.time() if now is None else float(now)
    records = load_records() if records is None else records
    in_flight = _in_flight() if in_flight is None else in_flight
    k, floor_s = budget_k(), budget_min_s()

    by_stage: Dict[str, List[dict]] = {}
    for rec in records:
        by_stage.setdefault(str(rec.get("stage", "?")), []).append(rec)

    all_durs = sorted(float(r.get("dur_s", 0.0)) for r in records)
    overall_median = _quantile(all_durs, 0.5)

    stages: Dict[str, Any] = {}
    flagged: List[dict] = []
    for stage, recs in by_stage.items():
        durs = sorted(float(r.get("dur_s", 0.0)) for r in recs)
        median = _quantile(durs, 0.5)
        p99 = _quantile(durs, 0.99)
        hosts: Dict[str, Dict[str, float]] = {}
        for r in recs:
            h = str(r.get("host", "?"))
            agg = hosts.setdefault(h, {"count": 0.0, "sum": 0.0})
            agg["count"] += 1
            agg["sum"] += float(r.get("dur_s", 0.0))
        host_means = {
            h: agg["sum"] / agg["count"] for h, agg in hosts.items()
        }
        slowest_host = (
            max(host_means, key=host_means.get) if host_means else None
        )
        budget = max(floor_s, k * median)
        all_flagged = sorted(
            (r for r in recs if float(r.get("dur_s", 0.0)) > budget),
            key=lambda r: -float(r.get("dur_s", 0.0)),
        )
        stages[stage] = {
            "count": len(recs),
            "median_s": round(median, 6),
            "p99_s": round(p99, 6),
            "skew_ratio": round(p99 / median, 3) if median > 0 else None,
            "budget_s": round(budget, 6),
            "slowest_host": slowest_host,
            "host_mean_s": {
                h: round(m, 6) for h, m in sorted(host_means.items())
            },
            # True outlier count, then a bounded sample of the worst
            # rows — metrics/alerts key on the count, pages on the rows.
            "flagged_total": len(all_flagged),
            "flagged": all_flagged[:_FLAGGED_CAP],
        }
        flagged.extend(all_flagged)

    wedged: List[dict] = []
    for task in in_flight:
        stage = stage_name(str(task.get("stage", "?")))
        age = float(task.get("age_s", 0.0))
        median = stages.get(stage, {}).get("median_s") or overall_median
        budget = max(floor_s, k * float(median))
        if age > budget:
            wedged.append(
                {
                    "stage": stage,
                    "pid": task.get("pid"),
                    "host": task.get("host", socket.gethostname()),
                    "age_s": round(age, 3),
                    "budget_s": round(budget, 3),
                }
            )
    return {
        "ts": now,
        "tasks_total": len(records),
        "stages": stages,
        "flagged_total": len(flagged),
        "flagged": sorted(
            flagged, key=lambda r: -float(r.get("dur_s", 0.0))
        )[:_FLAGGED_CAP],
        "wedged": wedged,
        "in_flight": len(in_flight),
        "budget_k": k,
        "budget_min_s": floor_s,
    }


def publish_metrics(analysis: Optional[Dict[str, Any]] = None) -> None:
    """Fold an analysis into the registry as ``straggler.*`` gauges —
    ``rsdl_straggler_*`` on a Prometheus scrape, sampled into the
    timeseries ring by the sampler tick. Gauges, not counters: the
    analysis is a recomputed level."""
    if not _metrics.enabled():
        return
    try:
        analysis = analyze() if analysis is None else analysis
        reg = _metrics.registry
        for stage, st in analysis.get("stages", {}).items():
            if st.get("skew_ratio") is not None:
                reg.gauge("straggler.skew_ratio", stage=stage).set(
                    st["skew_ratio"]
                )
            reg.gauge("straggler.median_seconds", stage=stage).set(
                st.get("median_s", 0.0)
            )
            reg.gauge("straggler.p99_seconds", stage=stage).set(
                st.get("p99_s", 0.0)
            )
            reg.gauge("straggler.flagged_tasks", stage=stage).set(
                st.get("flagged_total", len(st.get("flagged", [])))
            )
        wedged = analysis.get("wedged", [])
        reg.gauge("straggler.wedged_tasks").set(len(wedged))
        current = {(t.get("pid"), t.get("stage")) for t in wedged}
        # Prune tags whose task left the in-flight set: the same worker
        # wedging AGAIN later must log a fresh event (one event per
        # stall episode, not one per pid forever). Only the time
        # series' tick thread calls this: _wedged_seen is its own.
        _wedged_seen.intersection_update(current)
        for task in wedged:
            tag = (task.get("pid"), task.get("stage"))
            if tag in _wedged_seen:
                continue  # one event per stuck task, not one per tick
            _wedged_seen.add(tag)
            from ray_shuffling_data_loader_tpu_torch import telemetry as _t

            _t.emit_event("straggler.wedged", **task)
    except Exception:
        pass


def status_section(limit: int = 8) -> Dict[str, Any]:
    """The trimmed view a status page embeds: :func:`analyze` without
    the per-stage outlier rows, at most ``limit`` flagged and wedged."""
    analysis = analyze()
    return {
        "tasks_total": analysis["tasks_total"],
        "stages": {
            stage: {
                k: v for k, v in st.items() if k not in ("flagged",)
            }
            for stage, st in analysis["stages"].items()
        },
        "flagged": analysis["flagged"][:limit],
        "wedged": analysis["wedged"][:limit],
    }
