"""The critical path of each epoch and the stalls by cause, while the
run goes on.

The workers' task records (:mod:`.stragglers`) are busy intervals: a
record of ``(stage, epoch, ts, dur_s)`` was busy over ``[ts - dur_s,
ts]``. This module folds them into per-epoch unions of busy intervals
per stage and decomposes each epoch:

* per-stage **busy time** (the union: overlapping tasks count once),
  the **overlap / sole-active / idle** sweep, and the **critical-path
  stage**: the one with the largest sole-active share, a tie going to
  the later stage of the pipeline;
* **stalls by cause** from the aggregated ``stall_seconds{cause=}``
  counters of every process's spool.

The interval core (:func:`merge_intervals`, :func:`active_profile`,
:func:`profile_epoch`, :func:`run_critical_path`) is unit-agnostic: a
report over trace spans in microseconds passes ``scale=1e6``.
:func:`analyze` is the live view the re-planner
(:func:`..analysis.planner._live_signals`) reads, and
:func:`publish_metrics` refreshes the ``critical.*`` gauges on the time
series' tick.

Callers gate on ``RSDL_METRICS``; a run with metrics off never imports
this module. The math, the rows and the gauges are the JAX package's,
letter for letter. Standard library and file reads only.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple

# No telemetry import at module level: the interval math stands alone,
# and the live half imports export, metrics and stragglers in the
# functions that need them.

# Canonical pipeline order for tie-breaks: backpressure propagates
# from the later stage, so a fully-pipelined tie names the later one.
# A trace's stage names (map/reduce/deliver/consume) and the task
# records' (map/plan/reduce/gather-reduce) are both here; unknown
# stages order after the known ones.
STAGE_ORDER = [
    "map", "plan", "reduce", "gather-reduce", "selective-reduce",
    "deliver", "consume",
]

Interval = Tuple[float, float]


def stage_rank(stage: str, order: Optional[List[str]] = None) -> int:
    order = STAGE_ORDER if order is None else order
    try:
        return order.index(stage)
    except ValueError:
        return len(order)


# ---------------------------------------------------------------------------
# Interval math (unit-agnostic: trace microseconds with scale=1e6, task
# records in seconds)
# ---------------------------------------------------------------------------


def merge_intervals(intervals: List[Interval]) -> List[Interval]:
    """Sorted union of possibly-overlapping intervals."""
    out: List[Interval] = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            if end > out[-1][1]:
                out[-1] = (out[-1][0], end)
        else:
            out.append((start, end))
    return out


def intervals_total(merged: List[Interval]) -> float:
    return sum(end - start for start, end in merged)


def active_profile(
    by_stage: Dict[str, List[Interval]]
) -> Dict[str, Any]:
    """Sweep the union of all stage boundaries and integrate: per-stage
    sole-active time, total >= 2-stages-overlap time, and any-active
    time — the decomposition the critical-path call keys on. Expects
    MERGED per-stage interval lists."""
    points = sorted(
        {t for ivs in by_stage.values() for iv in ivs for t in iv}
    )
    sole = {stage: 0.0 for stage in by_stage}
    overlap = 0.0
    any_active = 0.0
    for lo, hi in zip(points, points[1:]):
        if hi <= lo:
            continue
        active = [
            stage
            for stage, ivs in by_stage.items()
            if any(s <= lo and hi <= e for s, e in ivs)
        ]
        span = hi - lo
        if len(active) == 1:
            sole[active[0]] += span
        elif len(active) >= 2:
            overlap += span
        if active:
            any_active += span
    return {"sole": sole, "overlap": overlap, "any": any_active}


def profile_epoch(
    by_stage: Dict[str, List[Interval]],
    scale: float = 1.0,
    order: Optional[List[str]] = None,
) -> Dict[str, Any]:
    """One epoch's critical-path row from raw per-stage intervals:
    wall/idle/overlap seconds, per-stage busy + sole-active seconds,
    and the ``critical_path`` verdict — the stage with the largest
    SOLE-active time (the part of the epoch it alone kept the clock
    running; a stage fully hidden under another's overlap cannot be
    the bottleneck no matter how busy it was), ties toward the later
    pipeline stage. ``scale`` divides the input units into seconds
    (1e6 for Chrome-trace microseconds)."""
    merged = {
        stage: merge_intervals(ivs)
        for stage, ivs in by_stage.items()
        if ivs
    }
    if not merged:
        return {}
    lo = min(s for ivs in merged.values() for s, _ in ivs)
    hi = max(e for ivs in merged.values() for _, e in ivs)
    profile = active_profile(merged)
    row: Dict[str, Any] = {
        "wall_s": (hi - lo) / scale,
        "idle_s": (hi - lo - profile["any"]) / scale,
        "overlap_s": profile["overlap"] / scale,
    }
    present = sorted(merged, key=lambda s: stage_rank(s, order))
    for stage in present:
        row[f"{stage}_s"] = intervals_total(merged[stage]) / scale
        row[f"{stage}_sole_s"] = profile["sole"][stage] / scale
    row["critical_path"] = max(
        present,
        key=lambda s: (profile["sole"][s], stage_rank(s, order)),
    )
    any_s = profile["any"] / scale
    row["sole_share"] = {
        stage: (
            round((profile["sole"][stage] / scale) / any_s, 4)
            if any_s > 0
            else 0.0
        )
        for stage in present
    }
    return row


def run_critical_path(
    rows: List[Dict[str, Any]], order: Optional[List[str]] = None
) -> Optional[str]:
    """The run-level verdict: the stage most often on the per-epoch
    critical path (ties toward the later stage)."""
    crit = [r["critical_path"] for r in rows if r.get("critical_path")]
    if not crit:
        return None
    return max(
        set(crit), key=lambda s: (crit.count(s), stage_rank(s, order))
    )


# ---------------------------------------------------------------------------
# Live analyzer (driver side)
# ---------------------------------------------------------------------------


def intervals_from_task_records(
    records: List[dict],
) -> Dict[int, Dict[str, List[Interval]]]:
    """Per-epoch per-stage busy intervals from the straggler spool's
    task records: a record completed at ``ts`` after ``dur_s`` was
    busy over ``[ts - dur_s, ts]``. Records without an epoch cannot be
    attributed and are skipped."""
    out: Dict[int, Dict[str, List[Interval]]] = {}
    for rec in records:
        epoch = rec.get("epoch")
        if epoch is None:
            continue
        try:
            epoch = int(epoch)
        except (TypeError, ValueError):
            continue
        end = float(rec.get("ts", 0.0))
        dur = max(0.0, float(rec.get("dur_s", 0.0)))
        stage = str(rec.get("stage", "?"))
        out.setdefault(epoch, {}).setdefault(stage, []).append(
            (end - dur, end)
        )
    return out


def _stall_by_cause() -> Dict[str, float]:
    """Cluster-wide stall seconds by cause from the aggregated
    registry (``stall_seconds{cause=...}`` counters)."""
    out: Dict[str, float] = {}
    try:
        from ray_shuffling_data_loader_tpu_torch.telemetry import (
            export as _export,
        )

        flat = _export.aggregate()
    except Exception:
        return out
    prefix = "stall_seconds{"
    for key, value in flat.items():
        if key.startswith(prefix):
            for part in key[len(prefix):-1].split(","):
                k, _, v = part.partition("=")
                if k == "cause":
                    out[v] = out.get(v, 0.0) + float(value)
    return out


def _in_flight_epochs() -> List[int]:
    """The driver's live epoch window (``shuffle.live_status``), via
    ``sys.modules`` — no import cost on processes that never shuffle."""
    import sys as _sys

    shuffle_mod = _sys.modules.get("ray_shuffling_data_loader_tpu_torch.shuffle")
    if shuffle_mod is None:
        return []
    try:
        return [
            int(e)
            for e in shuffle_mod.live_status().get("in_flight_epochs") or []
        ]
    except Exception:
        return []


# Live per-epoch profile memo: {epoch: (interval count, row)}. Task
# records only append, so an epoch whose interval count is unchanged
# has an unchanged profile: each tick refolds only the epochs still
# receiving records, not the whole run. Used only on the live path
# (explicit ``records`` bypass it).
_profile_cache: Dict[int, Tuple[int, Dict[str, Any]]] = {}


def reset() -> None:
    _profile_cache.clear()
    _published_stages.clear()


def analyze(
    records: Optional[List[dict]] = None,
    now: Optional[float] = None,
) -> Dict[str, Any]:
    """The whole view: per-epoch rows (the interval core),
    the *current* epoch's verdict (the latest in-flight epoch with
    data, else the latest epoch seen), run-level critical path, and
    live stall-by-cause. Pure fold over the task-record spool — no
    RPCs, safe on error paths; completed epochs' profiles are
    memoized (see ``_profile_cache``)."""
    now = time.time() if now is None else float(now)
    live = records is None
    if live:
        from ray_shuffling_data_loader_tpu_torch.telemetry import (
            stragglers as _stragglers,
        )

        records = _stragglers.load_records()
    per_epoch = intervals_from_task_records(records)
    epochs: Dict[int, Dict[str, Any]] = {}
    for epoch in sorted(per_epoch):
        count = sum(len(ivs) for ivs in per_epoch[epoch].values())
        cached = _profile_cache.get(epoch) if live else None
        if cached is not None and cached[0] == count:
            row = dict(cached[1])
        else:
            row = profile_epoch(per_epoch[epoch])
            if row and live:
                _profile_cache[epoch] = (count, dict(row))
        if row:
            row["epoch"] = epoch
            epochs[epoch] = row
    rows = [epochs[e] for e in sorted(epochs)]
    in_flight = _in_flight_epochs()
    current_epoch: Optional[int] = None
    for e in sorted(in_flight, reverse=True):
        if e in epochs:
            current_epoch = e
            break
    if current_epoch is None and epochs:
        current_epoch = max(epochs)
    current: Dict[str, Any] = {"epoch": current_epoch}
    if current_epoch is not None:
        row = epochs[current_epoch]
        current["critical_path"] = row["critical_path"]
        current["sole_share"] = row["sole_share"]
    return {
        "ts": now,
        "tasks_total": len(records),
        "in_flight_epochs": in_flight,
        "current": current,
        "run_critical_path": run_critical_path(rows),
        "stall_by_cause": _stall_by_cause(),
        "epochs": rows,
    }


# Stage labels published last tick, so a stage that leaves the current
# epoch's view is zeroed instead of lingering at its old share.
_published_stages: set = set()


def publish_metrics(analysis: Optional[Dict[str, Any]] = None) -> None:
    """Fold an analysis into the registry as ``critical.*`` gauges —
    ``rsdl_critical_*`` on a scrape: the current epoch, a one-hot
    ``critical.path{stage=}`` (1 on the critical stage), and
    per-stage ``critical.sole_share{stage=}``. Gauges: the analysis
    is a recomputed level, refreshed by the sampler tick."""
    global _published_stages
    from ray_shuffling_data_loader_tpu_torch.telemetry import metrics as _metrics

    if not _metrics.enabled():
        return
    try:
        analysis = analyze() if analysis is None else analysis
        reg = _metrics.registry
        current = analysis.get("current") or {}
        epoch = current.get("epoch")
        if epoch is None:
            return
        reg.gauge("critical.epoch").set(float(epoch))
        shares = current.get("sole_share") or {}
        crit = current.get("critical_path")
        stages = set(shares)
        for stage in _published_stages - stages:
            reg.gauge("critical.sole_share", stage=stage).set(0.0)
            reg.gauge("critical.path", stage=stage).set(0.0)
        _published_stages = stages
        for stage, share in shares.items():
            reg.gauge("critical.sole_share", stage=stage).set(share)
            reg.gauge("critical.path", stage=stage).set(
                1.0 if stage == crit else 0.0
            )
    except Exception:
        pass


def status_section() -> Dict[str, Any]:
    """The trimmed view a status page embeds: the current epoch's
    verdict, the run's, the stalls by cause and the epochs seen."""
    analysis = analyze()
    return {
        "current": analysis.get("current"),
        "run_critical_path": analysis.get("run_critical_path"),
        "stall_by_cause": analysis.get("stall_by_cause"),
        "epochs_seen": len(analysis.get("epochs") or []),
    }
