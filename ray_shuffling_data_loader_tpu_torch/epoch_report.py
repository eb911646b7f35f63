#!/usr/bin/env python
"""Epoch critical-path report: trace + stats CSVs -> per-epoch breakdown.

Answers the operator question the raw artifacts only imply: **which
stage was the bottleneck this epoch?** Ingests the merged Chrome-trace
JSON (``telemetry.trace_export`` / ``bench.py --trace-out``) and
optionally the ``stats.process_stats`` CSVs and the bench result JSON,
then computes per epoch:

* the wall-clock **busy time per pipeline stage** — ``map``, ``reduce``,
  ``deliver`` (reducer-output handoff incl. queue backpressure), and
  ``consume`` (trainer-side ``stage:h2d`` staging) — as merged interval
  unions, so N overlapping map tasks count once;
* the **overlap** structure: how much of the epoch window had >= 2
  stages active (pipelining working) vs exactly one (that stage IS the
  critical path there) vs none (idle: admission throttle, scheduling
  gaps);
* the **critical-path stage**: the stage carrying the largest
  sole-active share of the epoch window (the time nothing else could
  hide), tie-broken toward the later pipeline stage;
* **stall attribution** from the trainer's ``stall`` spans
  (``cause=upstream|staging``) and the epoch CSV's admission-throttle
  column.

The temporal plane joins in when its artifacts are given:

* ``--events <file|dir>`` — the structured NDJSON event log
  (``$RSDL_RUNTIME_DIR/events`` / ``RSDL_EVENTS_DIR``): per-epoch
  retry/recovery event counts land on the epoch rows and the notable
  events (retries, failovers, spills, producer deaths) are listed
  with timestamps — "what happened when throughput dipped";
* ``--task-records <file|dir>`` — the straggler task-duration spool
  (``<metrics spool>/tasks``): a per-epoch **straggler table** (per
  stage: count, median, p99, skew ratio, slowest host, tasks flagged
  over ``k×`` median — ``--straggler-k``, default 4);
* ``--timeseries <file|dir>`` — the sampler's append-only NDJSON
  (``<metrics spool>/ts/timeseries.ndjson``): sample count/span and
  the map-rows rate envelope in the header;
* ``--capacity <file|dir>`` — the capacity-ledger spool
  (``<metrics spool>/capacity``): the per-(epoch, tier)
  residency/high-watermark table — which epochs held how many bytes
  where, folded by the same ``telemetry/capacity.py`` ledger the live
  ``/capacity`` endpoint serves;
* ``--profile <dir>`` — the sampling-profiler spool
  (``$RSDL_RUNTIME_DIR/profiles`` of per-process ``profile-*.json``
  aggregates): the merged hot-frames table (self seconds / share,
  per-stage attribution) joins the report, so "which stage stalled"
  and "which frame burned the time" land on the same page.

The interval-union / critical-path math itself is shared with the live
``/critical`` analyzer (``telemetry/critical.py``): the online verdict
and this report agree by construction.

With ``--baseline BENCH_rXX.json`` (either a raw ``bench.py`` JSON line
or the round-capture wrapper with a ``"parsed"`` field) the current
run's headline numbers (``--bench``, same shapes) gate a regression
check: exit **1** when throughput drops more than ``--threshold-pct``
(default 10) or stall% rises more than ``--stall-threshold-pts``
(default 10) — so a CI lane can fail on a real slowdown. Exit 2 on
usage errors, 3 when the inputs contain no per-epoch data (an empty
report must not read as a pass). The temporal artifacts follow the
zero-coverage audit rule: an artifact that was **never produced**
(path absent) is informational — noted, exit unaffected — but one
that is **present yet empty** exits 3, because "the plane was on and
recorded nothing" must not gate green.

Pure stdlib, no server. Example::

    python -m ray_shuffling_data_loader_tpu_torch.epoch_report \
        --trace /tmp/run.json --epoch-csv stats/epoch_stats.csv \
        --events /tmp/spool/events --task-records /tmp/spool/metrics/tasks \
        --capacity /tmp/spool/metrics --profile /tmp/spool/profiles

The flags, the output and the exit codes are the JAX package's
``tools/epoch_report.py``'s; the math is the port's own telemetry modules'
(:mod:`.telemetry.critical`, :mod:`.telemetry.capacity`,
:mod:`.telemetry.stragglers`, :mod:`.telemetry.profiler`, all standard
library only).
"""

from __future__ import annotations

import argparse
import csv
import json
import os as _os
import sys
from typing import Any, Dict, List, Optional, Tuple

from ray_shuffling_data_loader_tpu_torch.telemetry import capacity as _capacity
from ray_shuffling_data_loader_tpu_torch.telemetry import critical as _critical
from ray_shuffling_data_loader_tpu_torch.telemetry import profiler as _profiler
from ray_shuffling_data_loader_tpu_torch.telemetry import stragglers as _stragglers

# Span-name -> pipeline-stage mapping (docs/observability.md vocabulary).
# map:read is a sub-interval of map and deliver:wait-maps is bookkeeping,
# so neither contributes its own stage.
_SPAN_STAGE = {
    "map": "map",
    "reduce": "reduce",
    "deliver": "deliver",
    "stage:h2d": "consume",
}
STAGE_ORDER = ["map", "reduce", "deliver", "consume"]


def _load_json(path: Optional[str]) -> Optional[dict]:
    if not path:
        return None
    with open(path) as f:
        text = f.read().strip()
    # bench stdout may carry log lines around the one JSON line; take the
    # last line that parses as a JSON object.
    try:
        return json.loads(text)
    except ValueError:
        for line in reversed(text.splitlines()):
            line = line.strip()
            if line.startswith("{"):
                try:
                    return json.loads(line)
                except ValueError:
                    continue
    raise ValueError(f"{path}: no JSON object found")


def _load_csv(path: Optional[str]) -> List[Dict[str, str]]:
    if not path:
        return []
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def _load_ndjson(
    path: Optional[str], prefix: str, required_key: str
) -> Tuple[Optional[List[dict]], bool]:
    """Records from one NDJSON file or a spool directory of
    ``<prefix>*.ndjson`` files. Returns ``(records, present)`` —
    ``present=False`` means the artifact was never produced (path or
    matching files absent), which the exit-code policy treats as
    informational rather than a failure; an empty-but-present artifact
    returns ``([], True)``."""
    import os

    if not path:
        return None, False
    files: List[str] = []
    if os.path.isdir(path):
        files = [
            os.path.join(path, f)
            for f in sorted(os.listdir(path))
            if f.startswith(prefix) and f.endswith(".ndjson")
        ]
        if not files:
            return None, False
    elif os.path.isfile(path):
        files = [path]
    else:
        return None, False
    out: List[dict] = []
    for fpath in files:
        try:
            with open(fpath) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        continue  # torn append; skip
                    if isinstance(rec, dict) and required_key in rec:
                        out.append(rec)
        except OSError:
            continue
    out.sort(key=lambda r: float(r.get("ts", 0.0)))
    return out, True


def _bench_fields(obj: Optional[dict]) -> Dict[str, Any]:
    """Headline fields from a bench result JSON — accepts both the raw
    one-line shape and the round-capture wrapper (``{"parsed": {...}}``,
    the BENCH_rXX.json format)."""
    if not obj:
        return {}
    if isinstance(obj.get("parsed"), dict):
        obj = obj["parsed"]
    return {
        k: obj[k]
        for k in (
            "value", "stall_pct", "stall_upstream_pct", "stall_staging_pct",
            "total_s", "map_stage_s", "reduce_stage_s", "throttle_s",
            "backend", "error",
        )
        if k in obj
    }


def collect_epochs(events: List[dict]) -> Dict[int, Dict[str, Any]]:
    """Per-epoch stage intervals + stall attribution from trace events."""
    intervals: Dict[int, Dict[str, List[Tuple[float, float]]]] = {}
    stalls: Dict[int, Dict[str, float]] = {}
    for e in events:
        if e.get("ph") != "X":
            continue
        args = e.get("args") or {}
        epoch = args.get("epoch")
        if epoch is None:
            continue
        try:
            epoch = int(epoch)
        except (TypeError, ValueError):
            continue
        name = e.get("name")
        start = float(e.get("ts", 0.0))
        end = start + max(0.0, float(e.get("dur", 0.0)))
        stage = _SPAN_STAGE.get(name)
        if stage is not None:
            intervals.setdefault(epoch, {}).setdefault(stage, []).append(
                (start, end)
            )
        elif name == "stall":
            cause = str(args.get("cause", "unknown"))
            per = stalls.setdefault(epoch, {})
            per[cause] = per.get(cause, 0.0) + (end - start) / 1e6
    out: Dict[int, Dict[str, Any]] = {}
    for epoch, by_stage in intervals.items():
        row = _critical.profile_epoch(by_stage, scale=1e6)
        if not row:
            continue
        row["epoch"] = epoch
        for cause, secs in (stalls.get(epoch) or {}).items():
            row[f"stall_{cause}_s"] = secs
        out[epoch] = row
    return out


# Event kinds worth listing with timestamps in the report (the routine
# epoch/trial lifecycle markers only feed the per-epoch counts).
_NOTABLE_EVENT_KINDS = (
    "stage.retry", "recovery", "task.failover", "agent.evicted",
    "store.spill", "producer.died", "epoch.failed", "trial.failed",
    "straggler.wedged",
)


_quantile = _stragglers._quantile


def straggler_rows(
    task_records: List[dict], k: float
) -> List[Dict[str, Any]]:
    """The per-(epoch, stage) straggler table: count, median, p99, skew
    ratio, slowest host by mean duration, and how many tasks blew the
    ``k×median`` budget — the post-hoc twin of the live ``/stragglers``
    analysis (telemetry/stragglers.py)."""
    groups: Dict[Tuple[Any, str], List[dict]] = {}
    for rec in task_records:
        key = (rec.get("epoch", "-"), str(rec.get("stage", "?")))
        groups.setdefault(key, []).append(rec)
    rows: List[Dict[str, Any]] = []
    for (epoch, stage), recs in sorted(
        groups.items(), key=lambda kv: (str(kv[0][0]), kv[0][1])
    ):
        durs = sorted(float(r.get("dur_s", 0.0)) for r in recs)
        median = _quantile(durs, 0.5)
        p99 = _quantile(durs, 0.99)
        budget = k * median
        hosts: Dict[str, List[float]] = {}
        for r in recs:
            hosts.setdefault(str(r.get("host", "?")), []).append(
                float(r.get("dur_s", 0.0))
            )
        host_means = {h: sum(v) / len(v) for h, v in hosts.items()}
        flagged = [
            r for r in recs if float(r.get("dur_s", 0.0)) > budget
        ] if median > 0 else []
        rows.append(
            {
                "epoch": epoch,
                "stage": stage,
                "tasks": len(recs),
                "median_s": round(median, 4),
                "p99_s": round(p99, 4),
                "skew": round(p99 / median, 2) if median > 0 else None,
                "flagged": len(flagged),
                "slowest_host": (
                    max(host_means, key=host_means.get)
                    if host_means else None
                ),
                "flagged_tasks": sorted(
                    flagged, key=lambda r: -float(r.get("dur_s", 0.0))
                )[:8],
            }
        )
    return rows


def _join_events(
    epochs: Dict[int, Dict[str, Any]], event_records: List[dict]
) -> Dict[str, Any]:
    """Fold the event log into the per-epoch rows (retry/recovery
    counts) and return the run-level summary (counts by kind + the
    notable events, timestamped)."""
    by_kind: Dict[str, int] = {}
    notable: List[dict] = []
    for rec in event_records:
        kind = str(rec.get("kind", "unknown"))
        by_kind[kind] = by_kind.get(kind, 0) + 1
        epoch = rec.get("epoch")
        if epoch is not None:
            try:
                row = epochs.setdefault(
                    int(epoch), {"epoch": int(epoch)}
                )
            except (TypeError, ValueError):
                row = None
            if row is not None:
                if kind == "stage.retry":
                    row["retries"] = row.get("retries", 0) + 1
                elif kind in ("recovery", "task.failover"):
                    row["recoveries"] = row.get("recoveries", 0) + 1
        if kind in _NOTABLE_EVENT_KINDS:
            notable.append(rec)
    return {"by_kind": by_kind, "notable": notable[-40:]}


def _timeseries_summary(samples: List[dict]) -> Dict[str, Any]:
    """Header-level envelope of the sampler history: sample count,
    span, and the map-rows rate min/mean/max (the dip the events
    explain)."""
    out: Dict[str, Any] = {"samples": len(samples)}
    if not samples:
        return out
    ts0 = float(samples[0].get("ts", 0.0))
    ts1 = float(samples[-1].get("ts", 0.0))
    out["span_s"] = round(ts1 - ts0, 1)
    rates = []
    for s in samples:
        entry = (s.get("metrics") or {}).get("shuffle.map_rows")
        if entry and "rate" in entry:
            rates.append(float(entry["rate"]))
    if rates:
        out["map_rows_rate"] = {
            "min": round(min(rates), 2),
            "mean": round(sum(rates) / len(rates), 2),
            "max": round(max(rates), 2),
        }
    return out


def build_report(
    events: List[dict],
    epoch_rows: List[Dict[str, str]],
    trial_rows: List[Dict[str, str]],
    bench: Optional[dict],
    baseline: Optional[dict],
    threshold_pct: float,
    stall_threshold_pts: float,
    event_records: Optional[List[dict]] = None,
    task_records: Optional[List[dict]] = None,
    ts_samples: Optional[List[dict]] = None,
    capacity_records: Optional[List[dict]] = None,
    straggler_k: float = 4.0,
) -> Dict[str, Any]:
    epochs = collect_epochs(events)

    # Join the stats-CSV timings by epoch id — first trial only (the CSV
    # carries one row per (trial, epoch); later trials would overwrite).
    first_trial = next(
        (r.get("trial") for r in epoch_rows if r.get("epoch")), None
    )
    for r in epoch_rows:
        if r.get("trial") != first_trial or not r.get("epoch"):
            continue
        try:
            epoch = int(r["epoch"])
        except ValueError:
            continue
        row = epochs.setdefault(epoch, {"epoch": epoch})
        for src, dst in (
            ("duration", "epoch_s"),
            ("throttle_duration", "throttle_s"),
            ("map_stage_duration", "csv_map_s"),
            ("reduce_stage_duration", "csv_reduce_s"),
        ):
            try:
                row[dst] = float(r[src])
            except (KeyError, ValueError, TypeError):
                pass

    header: Dict[str, Any] = {}
    cur = _bench_fields(bench)
    base = _bench_fields(baseline)
    if cur:
        header.update(cur)
    events_summary = None
    if event_records is not None:
        events_summary = _join_events(epochs, event_records)
        header["events_by_kind"] = events_summary["by_kind"]
    if ts_samples is not None:
        header["timeseries"] = _timeseries_summary(ts_samples)
    if trial_rows:
        t = trial_rows[0]
        for k in ("duration", "num_rows", "num_epochs", "row_throughput"):
            if t.get(k):
                header.setdefault(k, t[k])
    rows = [epochs[e] for e in sorted(epochs)]
    if rows:
        totals = {
            s: sum(r.get(f"{s}_s", 0.0) for r in rows) for s in STAGE_ORDER
        }
        header["stage_totals_s"] = {
            s: round(v, 3) for s, v in totals.items() if v
        }
        # The run-level call: the stage most often on the critical
        # path across epochs (ties toward the later stage) — the same
        # fold the live /critical endpoint serves.
        run_crit = _critical.run_critical_path(rows)
        if run_crit is not None:
            header["critical_path"] = run_crit

    regressions: List[str] = []
    if base:
        bval, cval = base.get("value"), cur.get("value")
        if bval and cval is not None:
            drop_pct = 100.0 * (float(bval) - float(cval)) / float(bval)
            header["value_vs_baseline_pct"] = round(-drop_pct, 2)
            if drop_pct > threshold_pct:
                regressions.append(
                    f"value {cval} is {drop_pct:.1f}% below baseline "
                    f"{bval} (threshold {threshold_pct}%)"
                )
        bstall, cstall = base.get("stall_pct"), cur.get("stall_pct")
        if bstall is not None and cstall is not None:
            rise = float(cstall) - float(bstall)
            header["stall_vs_baseline_pts"] = round(rise, 2)
            if rise > stall_threshold_pts:
                regressions.append(
                    f"stall_pct {cstall} is {rise:.1f} pts above baseline "
                    f"{bstall} (threshold {stall_threshold_pts} pts)"
                )
    header["regressions"] = regressions
    report: Dict[str, Any] = {"header": header, "epochs": rows}
    if events_summary is not None:
        report["events"] = events_summary["notable"]
    if task_records is not None:
        report["stragglers"] = straggler_rows(task_records, straggler_k)
    if capacity_records is not None:
        report["capacity"] = capacity_rows(capacity_records)
    return report


def capacity_rows(capacity_records: List[dict]) -> List[Dict[str, Any]]:
    """The per-(epoch, tier) residency/watermark table from the
    capacity-ledger spool — the post-hoc twin of the live ``/capacity``
    view (the fold is telemetry/capacity.py's, shared)."""
    folded = _capacity.ledger(capacity_records)
    rows: List[Dict[str, Any]] = []
    for epoch in sorted(
        folded.get("epochs", {}), key=_capacity.epoch_sort_key
    ):
        for tier, cell in sorted(folded["epochs"][epoch].items()):
            rows.append(
                {
                    "epoch": epoch,
                    "tier": tier,
                    "resident_mb": round(
                        cell.get("resident_bytes", 0) / 1e6, 3
                    ),
                    "hwm_mb": round(cell.get("hwm_bytes", 0) / 1e6, 3),
                    "created_mb": round(
                        cell.get("created_bytes", 0) / 1e6, 3
                    ),
                    "fetched_mb": round(
                        cell.get("fetched_bytes", 0) / 1e6, 3
                    ),
                    "freed_mb": round(cell.get("freed_bytes", 0) / 1e6, 3),
                    "segments": cell.get("segments", 0),
                    "oldest_age_s": cell.get("oldest_age_s"),
                }
            )
    return rows


# ---------------------------------------------------------------------------
# Rendering
# ---------------------------------------------------------------------------


def _fmt(value: Any, width: int = 0) -> str:
    if value is None or value == "":
        out = "-"
    elif isinstance(value, float):
        out = f"{value:.4g}"
    else:
        out = str(value)
    return out.rjust(width) if width else out


_COLUMNS = [
    "epoch", "wall_s", "map_s", "reduce_s", "deliver_s", "consume_s",
    "overlap_s", "idle_s", "critical_path", "stall_upstream_s",
    "stall_staging_s", "throttle_s", "epoch_s", "retries", "recoveries",
]

_STRAGGLER_COLUMNS = [
    "epoch", "stage", "tasks", "median_s", "p99_s", "skew", "flagged",
    "slowest_host",
]

_CAPACITY_COLUMNS = [
    "epoch", "tier", "resident_mb", "hwm_mb", "created_mb", "fetched_mb",
    "freed_mb", "segments", "oldest_age_s",
]


def render(report: Dict[str, Any]) -> str:
    lines = ["epoch critical-path report"]
    for k, v in report["header"].items():
        if k == "regressions":
            continue
        lines.append(f"  {k}: {_fmt(v) if not isinstance(v, dict) else v}")
    rows = report["epochs"]
    if not rows:
        lines.append("  (no per-epoch data in the given inputs)")
    else:
        columns = [
            c
            for c in _COLUMNS
            if any(r.get(c) is not None for r in rows)
            or c in ("epoch", "critical_path")
        ]
        widths = {
            c: max(len(c), *(len(_fmt(r.get(c))) for r in rows))
            for c in columns
        }
        lines.append("")
        lines.append("  ".join(c.rjust(widths[c]) for c in columns))
        lines.append("  ".join("-" * widths[c] for c in columns))
        for r in rows:
            lines.append(
                "  ".join(_fmt(r.get(c), widths[c]) for c in columns)
            )
    straggler_table = report.get("stragglers")
    if straggler_table is not None:
        lines.append("")
        lines.append("straggler table (per epoch/stage)")
        if not straggler_table:
            lines.append("  (no task records)")
        else:
            widths = {
                c: max(
                    len(c),
                    *(len(_fmt(r.get(c))) for r in straggler_table),
                )
                for c in _STRAGGLER_COLUMNS
            }
            lines.append(
                "  ".join(c.rjust(widths[c]) for c in _STRAGGLER_COLUMNS)
            )
            lines.append(
                "  ".join("-" * widths[c] for c in _STRAGGLER_COLUMNS)
            )
            for r in straggler_table:
                lines.append(
                    "  ".join(
                        _fmt(r.get(c), widths[c])
                        for c in _STRAGGLER_COLUMNS
                    )
                )
                for t in r.get("flagged_tasks", []):
                    lines.append(
                        f"    STRAGGLER: host={t.get('host')} "
                        f"pid={t.get('pid')} dur={_fmt(t.get('dur_s'))}s "
                        f"(median {_fmt(r.get('median_s'))}s)"
                    )
    capacity_table = report.get("capacity")
    if capacity_table is not None:
        lines.append("")
        lines.append("capacity ledger (per epoch/tier)")
        if not capacity_table:
            lines.append("  (no ledger records)")
        else:
            widths = {
                c: max(
                    len(c),
                    *(len(_fmt(r.get(c))) for r in capacity_table),
                )
                for c in _CAPACITY_COLUMNS
            }
            lines.append(
                "  ".join(c.rjust(widths[c]) for c in _CAPACITY_COLUMNS)
            )
            lines.append(
                "  ".join("-" * widths[c] for c in _CAPACITY_COLUMNS)
            )
            for r in capacity_table:
                lines.append(
                    "  ".join(
                        _fmt(r.get(c), widths[c])
                        for c in _CAPACITY_COLUMNS
                    )
                )
    profile = report.get("profile")
    if profile is not None:
        lines.append("")
        lines.append(
            "hot frames (profile)  samples=%d sampled=%.1fs sources=%d"
            % (
                profile.get("samples", 0),
                profile.get("seconds", 0.0),
                profile.get("sources", 0),
            )
        )
        for row in profile.get("top", []):
            stages = ",".join(
                f"{k}={v:.1f}s"
                for k, v in (row.get("stages") or {}).items()
            )
            lines.append(
                f"  {row['self_s']:>7.1f}s {row['self_frac']:>6.1%}  "
                f"{row['frame']}" + (f"  [{stages}]" if stages else "")
            )
    notable = report.get("events")
    if notable:
        lines.append("")
        lines.append("notable events")
        import time as _time

        for rec in notable:
            stamp = _time.strftime(
                "%H:%M:%S", _time.localtime(float(rec.get("ts", 0.0)))
            )
            detail = " ".join(
                f"{k}={rec[k]}"
                for k in ("epoch", "stage", "attempt", "counter",
                          "error", "rank", "agent", "nbytes", "pid",
                          "age_s")
                if k in rec
            )
            lines.append(
                f"  {stamp}  {rec.get('kind', '?'):<18} {detail}"[:118]
            )
    for msg in report["header"].get("regressions", []):
        lines.append(f"REGRESSION: {msg}")
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    parser.add_argument(
        "--trace", help="merged Chrome-trace JSON (telemetry.trace_export)"
    )
    parser.add_argument("--epoch-csv", help="stats.py epoch_stats.csv")
    parser.add_argument("--trial-csv", help="stats.py trial_stats.csv")
    parser.add_argument(
        "--bench", help="current run's bench result JSON (bench.py stdout)"
    )
    parser.add_argument(
        "--baseline",
        help="baseline bench JSON (raw line or BENCH_rXX.json wrapper) "
        "to gate regressions against",
    )
    parser.add_argument(
        "--events",
        help="structured event-log NDJSON (file, or the events spool "
        "dir of events-*.ndjson) to join per epoch",
    )
    parser.add_argument(
        "--task-records",
        help="straggler task-duration NDJSON (file, or the "
        "<metrics spool>/tasks dir of tasks-*.ndjson) for the "
        "per-epoch straggler table",
    )
    parser.add_argument(
        "--timeseries",
        help="timeseries sampler NDJSON (file, or the dir holding "
        "ts/timeseries.ndjson) for the header rate envelope",
    )
    parser.add_argument(
        "--capacity",
        help="capacity-ledger NDJSON (file, or the <metrics spool>/"
        "capacity dir of ledger-*.ndjson) for the per-epoch "
        "residency/watermark table",
    )
    parser.add_argument(
        "--profile",
        help="sampling-profiler spool dir of profile-*.json "
        "per-process aggregates ($RSDL_RUNTIME_DIR/profiles) for "
        "the hot-frames table",
    )
    parser.add_argument(
        "--straggler-k", type=float, default=4.0,
        help="straggler budget: flag tasks slower than K x the "
        "(epoch, stage) median (default 4)",
    )
    parser.add_argument(
        "--job", default=None,
        help="multi-job service: restrict the events / "
        "task-records / capacity-ledger joins to ONE job (exact job "
        "id, or a substring matching it) so per-job views don't "
        "interleave concurrent tenants' same-numbered epochs",
    )
    parser.add_argument(
        "--threshold-pct", type=float, default=10.0,
        help="max tolerated throughput drop vs baseline (%%, default 10)",
    )
    parser.add_argument(
        "--stall-threshold-pts", type=float, default=10.0,
        help="max tolerated stall%% rise vs baseline (points, default 10)",
    )
    parser.add_argument(
        "--json", action="store_true",
        help="emit the report as JSON instead of a table",
    )
    args = parser.parse_args(argv)
    if not any((args.trace, args.epoch_csv, args.bench, args.events,
                args.task_records, args.timeseries, args.capacity,
                args.profile)):
        parser.print_usage(sys.stderr)
        print(
            "epoch_report: need at least one of --trace/--epoch-csv/"
            "--bench/--events/--task-records/--timeseries/--capacity/"
            "--profile",
            file=sys.stderr,
        )
        return 2
    # The temporal artifacts distinguish "never produced" (absent path:
    # the plane was off — informational) from "present but empty" (the
    # plane was on and recorded nothing: exit 3, the zero-coverage
    # rule). Resolve a --timeseries DIR to its ts/timeseries.ndjson.
    ts_path = args.timeseries
    if ts_path and not ts_path.endswith(".ndjson"):
        for candidate in (
            _os.path.join(ts_path, "ts", "timeseries.ndjson"),
            _os.path.join(ts_path, "timeseries.ndjson"),
        ):
            if _os.path.exists(candidate):
                ts_path = candidate
                break
    absent_notes: List[str] = []
    empty_present: List[str] = []

    def _temporal(path, prefix, required_key, label):
        records, present = _load_ndjson(path, prefix, required_key)
        if path and not present:
            absent_notes.append(
                f"note: no {label} present at {path} (plane off?) — "
                "informational"
            )
            return None
        if present and not records:
            empty_present.append(
                f"{label} at {path} is present but empty — the plane "
                "was on and recorded nothing"
            )
        return records

    def _job_filter(records):
        """Keep one tenant's records. Job-stamped records must match;
        unstamped ones (session-level ops — store samples, cleanup)
        are kept: dropping them would hide session-wide capacity."""
        if records is None or not args.job:
            return records
        return [
            r
            for r in records
            if "job" not in r or args.job in str(r.get("job"))
        ]

    event_records = _job_filter(
        _temporal(args.events, "events-", "kind", "events")
    )
    task_records = _job_filter(
        _temporal(args.task_records, "tasks-", "dur_s", "task records")
    )
    ts_samples = _temporal(
        ts_path, "timeseries", "metrics", "timeseries"
    )
    # A --capacity DIR may be the metrics spool itself; resolve to its
    # capacity/ subdir of ledger-*.ndjson when present.
    cap_path = args.capacity
    if cap_path and _os.path.isdir(cap_path):
        sub = _os.path.join(cap_path, "capacity")
        if _os.path.isdir(sub):
            cap_path = sub
    capacity_records = _job_filter(
        _temporal(cap_path, "ledger-", "op", "capacity ledger")
    )

    def _profile_join(path):
        """The profiler spool is per-process JSON aggregates
        (``profile-*.json``), not NDJSON, so it gets its own loader —
        same zero-coverage policy as ``_temporal``: spool never
        produced = note + informational, spool present with zero
        samples = the plane was armed and recorded nothing (exit 3)."""
        if not path:
            return None
        present = _os.path.isdir(path) and any(
            f.startswith("profile-") and f.endswith(".json")
            for f in _os.listdir(path)
        )
        if not present:
            absent_notes.append(
                f"note: no profile spool present at {path} "
                "(plane off?) — informational"
            )
            return None
        agg = _profiler.aggregate_profiles(
            records=_profiler.load_records(path)
        )
        if not agg["stacks"]:
            empty_present.append(
                f"profile spool at {path} is present but empty — the "
                "plane was on and recorded nothing"
            )
            return None
        return {
            "samples": agg["samples"],
            "seconds": round(agg["seconds"], 3),
            "sources": len(agg["sources"]),
            "top": _profiler.top_table(agg, n=5),
        }

    profile_view = _profile_join(args.profile)
    try:
        events: List[dict] = []
        if args.trace:
            payload = _load_json(args.trace) or {}
            events = payload.get("traceEvents") or []
        bench = _load_json(args.bench)
        report = build_report(
            events,
            _load_csv(args.epoch_csv),
            _load_csv(args.trial_csv),
            bench,
            _load_json(args.baseline),
            args.threshold_pct,
            args.stall_threshold_pts,
            event_records=event_records,
            task_records=task_records,
            ts_samples=ts_samples,
            capacity_records=capacity_records,
            straggler_k=args.straggler_k,
        )
    except (OSError, ValueError) as exc:
        print(f"epoch_report: {exc}", file=sys.stderr)
        return 2
    if profile_view is not None:
        report["profile"] = profile_view
    if args.json:
        print(json.dumps(report, indent=2, default=str))
    else:
        print(render(report))
    for note in absent_notes:
        print(f"epoch_report: {note}", file=sys.stderr)
    if report["header"].get("regressions"):
        return 1
    if empty_present:
        for msg in empty_present:
            print(f"epoch_report: {msg}", file=sys.stderr)
        return 3
    has_temporal = bool(
        event_records or task_records or ts_samples or capacity_records
        or profile_view
    )
    if (
        not report["epochs"]
        and not _bench_fields(bench)
        and not has_temporal
    ):
        # Nothing per-epoch AND no headline numbers: the inputs carried
        # zero signal — a gate must not go green on that.
        print(
            "epoch_report: no per-epoch data found in the given inputs",
            file=sys.stderr,
        )
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
