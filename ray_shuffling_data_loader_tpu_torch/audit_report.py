"""Audit report: audit verdicts joined with the trial and epoch stats.

Renders one per-epoch table from the artifacts a run leaves behind (any
subset works; more inputs give more columns):

* ``--bench bench.json``: a bench's one-line JSON result; its ``"audit"``
  summary is the first source of verdicts, and its headline fields (GB/s,
  stall %, backend) head the report;
* ``--metrics run.metrics.json``: a :func:`.telemetry.metrics.dump_json`
  artifact; the ``audit.*`` gauges and counters of its final snapshot are
  the verdicts when no summary is given, and their totals head the report;
* ``--trial-csv trial_stats.csv`` / ``--epoch-csv epoch_stats.csv``: the
  CSVs of :func:`.stats.process_stats`; epoch durations and stage times
  join the table by epoch, trial totals the header;
* ``--audit-json audit.json``: a bare :func:`.telemetry.audit.summary`
  dump.

Standard library only. Exit codes, for a CI gate: 0 when every reconciled
epoch passed, 1 on any digest mismatch, 2 on a usage error, 3 when there
are verdicts but none reconciled (a wrong audit key or an unshared spool:
no coverage is no pass). The flags, the output and the exit codes are the
JAX package's ``tools/audit_report.py``'s.

Usage::

    python -m ray_shuffling_data_loader_tpu_torch.audit_report \
        --audit-json audit.json --metrics run.metrics.json \
        --trial-csv stats/trial_stats.csv --epoch-csv stats/epoch_stats.csv
"""

from __future__ import annotations

import argparse
import csv
import json
import re
import sys
from typing import Any, Dict, List, Optional


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


_AUDIT_GAUGE = re.compile(r"^audit\.([a-z_]+)\{epoch=(\d+)\}$")


def verdicts_from_metrics(snapshot: Dict[str, float]) -> List[Dict[str, Any]]:
    """Reconstruct per-epoch rows from the ``audit.*`` registry keys in a
    metrics snapshot (the fallback when no bench/audit JSON embeds full
    verdicts — counters are totals, gauges are per-epoch)."""
    by_epoch: Dict[int, Dict[str, Any]] = {}
    for key, value in snapshot.items():
        m = _AUDIT_GAUGE.match(key)
        if not m:
            continue
        name, epoch = m.group(1), int(m.group(2))
        row = by_epoch.setdefault(epoch, {"epoch": epoch})
        if name == "epoch_ok":
            row["ok"] = bool(value)
        else:
            row[name] = value
    return [by_epoch[e] for e in sorted(by_epoch)]


def _fmt(value: Any, width: int = 0) -> str:
    if value is None or value == "":
        out = "-"
    elif isinstance(value, bool):
        out = "OK" if value else "MISMATCH"
    elif isinstance(value, float):
        out = f"{value:.4g}"
    else:
        out = str(value)
    return out.rjust(width) if width else out


def _table(rows: List[Dict[str, Any]], columns: List[str]) -> str:
    widths = {
        c: max(len(c), *(len(_fmt(r.get(c))) for r in rows)) for c in columns
    }
    header = "  ".join(c.rjust(widths[c]) for c in columns)
    rule = "  ".join("-" * widths[c] for c in columns)
    body = [
        "  ".join(_fmt(r.get(c), widths[c]) for c in columns) for r in rows
    ]
    return "\n".join([header, rule, *body])


def build_report(
    bench: Optional[dict],
    metrics: Optional[dict],
    audit_json: Optional[dict],
    trial_rows: List[Dict[str, str]],
    epoch_rows: List[Dict[str, str]],
) -> Dict[str, Any]:
    """Merge every input into ``{"header": {...}, "epochs": [...]}``."""
    audit = None
    for candidate in (
        audit_json,
        (bench or {}).get("audit"),
    ):
        if candidate and candidate.get("epochs"):
            audit = candidate
            break
    final_snapshot = (metrics or {}).get("final", {}) if metrics else {}
    epochs: List[Dict[str, Any]] = []
    if audit:
        epochs = [dict(v) for v in audit["epochs"]]
    elif final_snapshot:
        epochs = verdicts_from_metrics(final_snapshot)

    # Join per-epoch stats-CSV timings by epoch id — restricted to the
    # FIRST trial's rows (the CSV carries one row per (trial, epoch);
    # letting later trials overwrite would join another trial's timings
    # onto this run's verdicts).
    first_trial = next(
        (r.get("trial") for r in epoch_rows if r.get("epoch")), None
    )
    by_epoch = {
        int(r["epoch"]): r
        for r in epoch_rows
        if r.get("epoch") and r.get("trial") == first_trial
    }
    for row in epochs:
        stats_row = by_epoch.get(int(row["epoch"]))
        if stats_row:
            for src, dst in (
                ("duration", "epoch_s"),
                ("map_stage_duration", "map_s"),
                ("reduce_stage_duration", "reduce_s"),
                ("throttle_duration", "throttle_s"),
            ):
                try:
                    row[dst] = float(stats_row[src])
                except (KeyError, ValueError, TypeError):
                    pass

    header: Dict[str, Any] = {}
    if bench:
        for k in (
            "value", "unit", "vs_baseline", "stall_pct", "backend",
            "loader", "dataset_gb", "total_s", "error",
        ):
            if k in bench:
                header[k] = bench[k]
    if trial_rows:
        t = trial_rows[0]
        for k in (
            "duration", "num_rows", "num_epochs", "row_throughput",
            "audit_epochs_ok", "audit_mismatch_epochs",
        ):
            if t.get(k):
                header[k] = t[k]
    for k in (
        "audit.rows_mapped", "audit.rows_reduced", "audit.rows_delivered",
        "audit.digest_mismatch",
    ):
        if k in final_snapshot:
            header[k] = final_snapshot[k]
    mismatched = [r["epoch"] for r in epochs if r.get("ok") is False]
    # audit_ok stays None when no epoch actually reconciled (all-null
    # verdicts = zero audit coverage, which must not read as a pass).
    audited = [r for r in epochs if r.get("ok") is not None]
    header["audit_ok"] = (not mismatched) if audited else None
    if mismatched:
        header["mismatch_epochs"] = mismatched
    return {"header": header, "epochs": epochs}


_COLUMNS = [
    "epoch", "ok", "mismatch", "rows_mapped", "rows_reduced",
    "rows_delivered", "rows_consumed", "delivered_digest", "delivered_seq",
    "adjacent_pair_retention", "mean_normalized_displacement",
    "source_entropy_mean", "epoch_s", "map_s", "reduce_s", "throttle_s",
]


def render(report: Dict[str, Any]) -> str:
    lines = ["audit report"]
    for k, v in report["header"].items():
        lines.append(f"  {k}: {_fmt(v)}")
    epochs = report["epochs"]
    if not epochs:
        lines.append("  (no per-epoch audit verdicts in the given inputs)")
        return "\n".join(lines)
    columns = [
        c
        for c in _COLUMNS
        if any(r.get(c) not in (None, "", []) or c in ("epoch", "ok")
               for r in epochs)
    ]
    rows = [
        {
            **r,
            "mismatch": ",".join(r["mismatch"]) if r.get("mismatch") else "",
        }
        for r in epochs
    ]
    lines.append("")
    lines.append(_table(rows, columns))
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    parser.add_argument("--bench", help="bench result JSON (bench.py stdout)")
    parser.add_argument(
        "--metrics", help="metrics timeline/snapshot JSON (dump_json)"
    )
    parser.add_argument(
        "--audit-json", help="bare telemetry.audit.summary() JSON dump"
    )
    parser.add_argument("--trial-csv", help="stats.py trial_stats.csv")
    parser.add_argument("--epoch-csv", help="stats.py epoch_stats.csv")
    parser.add_argument(
        "--json", action="store_true",
        help="emit the merged report as JSON instead of a table",
    )
    args = parser.parse_args(argv)
    if not any(
        (args.bench, args.metrics, args.audit_json, args.trial_csv)
    ):
        parser.print_usage(sys.stderr)
        print(
            "audit_report: need at least one of --bench/--metrics/"
            "--audit-json/--trial-csv",
            file=sys.stderr,
        )
        return 2
    try:
        report = build_report(
            _load_json(args.bench),
            _load_json(args.metrics),
            _load_json(args.audit_json),
            _load_csv(args.trial_csv),
            _load_csv(args.epoch_csv),
        )
    except (OSError, ValueError) as exc:
        print(f"audit_report: {exc}", file=sys.stderr)
        return 2
    if args.json:
        print(json.dumps(report, indent=2, default=str))
    else:
        print(render(report))
    if report["header"].get("audit_ok") is False:
        return 1
    if report["epochs"] and report["header"].get("audit_ok") is None:
        # Verdicts exist but none reconciled: the audit ran with zero
        # coverage (typo'd RSDL_AUDIT_KEY, unshared spool). A gate must
        # not go green on that.
        print(
            "audit_report: no epoch was actually audited (every verdict "
            "is null) — zero coverage is not a pass",
            file=sys.stderr,
        )
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
