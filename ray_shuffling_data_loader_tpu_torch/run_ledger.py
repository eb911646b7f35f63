#!/usr/bin/env python
"""Query the durable run ledger (telemetry/runledger.py).

Subcommands::

    python -m ray_shuffling_data_loader_tpu_torch.run_ledger [--ledger PATH] list [--limit N] [--json]
    python -m ray_shuffling_data_loader_tpu_torch.run_ledger [--ledger PATH] show <id-or-index>
    python -m ray_shuffling_data_loader_tpu_torch.run_ledger [--ledger PATH] diff <base> <head>
    python -m ray_shuffling_data_loader_tpu_torch.run_ledger [--ledger PATH] --regress BASE..HEAD \
        [--drop-frac 0.2] [--stall-rise-frac 0.5]

Records are addressed by full id (``run-<hex>-<pid>``), unique id
prefix, or append-order index (``0`` oldest, ``-1`` newest). The
``--regress`` gate compares HEAD against BASE and exits **1** when
HEAD's throughput dropped by more than ``--drop-frac`` or its total
stall seconds rose by more than ``--stall-rise-frac`` (relative);
exit **3** when either record (or the ledger itself) is missing, so
CI can tell "regressed" from "nothing to compare". When both records
carry a ``profile`` digest, the verdict also NAMES the
frames whose self-time share moved most — where the regression went,
not just that it happened. The ledger path
comes from ``--ledger`` or ``RSDL_RUN_LEDGER`` (the writer's resolution,
:func:`.telemetry.runledger.ledger_path`). The flags, the output and the
exit codes are the JAX package's ``tools/run_ledger.py``'s.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Any, Dict, List, Optional

from ray_shuffling_data_loader_tpu_torch.telemetry import profiler, runledger


def _resolve(records: List[dict], ref: str) -> Optional[dict]:
    """Index (incl. negative), exact id, or unique id prefix."""
    try:
        return records[int(ref)]
    except (ValueError, IndexError):
        pass
    exact = [r for r in records if r.get("id") == ref]
    if exact:
        return exact[-1]
    prefixed = [r for r in records if str(r.get("id", "")).startswith(ref)]
    if len(prefixed) == 1:
        return prefixed[0]
    return None


def _throughput_of(rec: dict) -> Optional[float]:
    """The comparable throughput figure: rows/s (bench) wins over
    bytes/s (shuffle) — compare like with like."""
    tp = rec.get("throughput") or {}
    for key in ("rows_per_s", "bytes_per_s"):
        value = tp.get(key)
        if value:
            return float(value)
    return None


def _stall_total(rec: dict) -> float:
    return sum(float(v) for v in (rec.get("stall_by_cause") or {}).values())


def _fmt_ts(ts: Any) -> str:
    try:
        return time.strftime("%Y-%m-%d %H:%M:%S", time.localtime(float(ts)))
    except (TypeError, ValueError):
        return "?"


def _summary_row(idx: int, rec: dict) -> str:
    job = (rec.get("job") or {}).get("id") or "-"
    tp = _throughput_of(rec)
    return (
        f"{idx:>4}  {rec.get('id', '?'):<24} {_fmt_ts(rec.get('ts')):<19} "
        f"{rec.get('kind', '?'):<7} {rec.get('status', '?'):<9} "
        f"{job:<14} plan={rec.get('plan', '-'):<12} "
        f"dur={rec.get('duration_s', '-'):<8} "
        f"tp={('%.1f' % tp) if tp is not None else '-'} "
        f"stall={_stall_total(rec):.1f}s "
        f"alerts={sum((rec.get('alerts_fired') or {}).values())}"
    )


def cmd_list(records: List[dict], args) -> int:
    rows = records[-args.limit:] if args.limit else records
    offset = len(records) - len(rows)
    if args.json:
        print(json.dumps(rows, indent=2))
        return 0
    if not rows:
        print("ledger is empty")
        return 0
    for i, rec in enumerate(rows):
        print(_summary_row(offset + i, rec))
    return 0


def cmd_show(records: List[dict], args) -> int:
    rec = _resolve(records, args.ref)
    if rec is None:
        print(f"no record matches {args.ref!r}", file=sys.stderr)
        return 3
    print(json.dumps(rec, indent=2, sort_keys=True))
    return 0


def _diff_rows(base: dict, head: dict) -> List[str]:
    out: List[str] = []

    def row(label: str, b: Any, h: Any) -> None:
        if b != h:
            out.append(f"  {label:<22} {b!r:>14} -> {h!r}")

    row("status", base.get("status"), head.get("status"))
    row("plan", base.get("plan"), head.get("plan"))
    row("duration_s", base.get("duration_s"), head.get("duration_s"))
    row("throughput", _throughput_of(base), _throughput_of(head))
    row("stall_total_s", round(_stall_total(base), 3),
        round(_stall_total(head), 3))
    causes = set(base.get("stall_by_cause") or {}) \
        | set(head.get("stall_by_cause") or {})
    for cause in sorted(causes):
        row(f"stall[{cause}]",
            (base.get("stall_by_cause") or {}).get(cause, 0.0),
            (head.get("stall_by_cause") or {}).get(cause, 0.0))
    row("critical_path",
        (base.get("critical") or {}).get("run_critical_path"),
        (head.get("critical") or {}).get("run_critical_path"))
    row("audit_ok", (base.get("audit") or {}).get("ok"),
        (head.get("audit") or {}).get("ok"))
    row("alerts_fired", base.get("alerts_fired") or {},
        head.get("alerts_fired") or {})
    bknobs: Dict[str, str] = base.get("knobs") or {}
    hknobs: Dict[str, str] = head.get("knobs") or {}
    for knob in sorted(set(bknobs) | set(hknobs)):
        row(f"knob {knob}", bknobs.get(knob), hknobs.get(knob))
    bterms: Dict[str, dict] = base.get("plan_terms") or {}
    hterms: Dict[str, dict] = head.get("plan_terms") or {}
    for term in sorted(set(bterms) | set(hterms)):
        row(
            f"plan_term {term}",
            (bterms.get(term) or {}).get("value"),
            (hterms.get(term) or {}).get("value"),
        )
    return out


def cmd_diff(records: List[dict], args) -> int:
    base = _resolve(records, args.base)
    head = _resolve(records, args.head)
    if base is None or head is None:
        missing = args.base if base is None else args.head
        print(f"no record matches {missing!r}", file=sys.stderr)
        return 3
    print(f"base: {base.get('id')} ({_fmt_ts(base.get('ts'))})")
    print(f"head: {head.get('id')} ({_fmt_ts(head.get('ts'))})")
    rows = _diff_rows(base, head)
    if not rows:
        print("no differences in compared fields")
    else:
        for line in rows:
            print(line)
    return 0


def _profile_shift_lines(base: dict, head: dict) -> List[str]:
    """Human-readable profile-digest shift between two records (empty
    when either record lacks a ``profile`` section): the top frames
    whose SELF-time share grew or shrank, by name — fraction-based, so
    runs of different lengths compare meaningfully."""
    bprof, hprof = base.get("profile"), head.get("profile")
    if not bprof or not hprof:
        return []
    try:
        shift = profiler.diff_digests(bprof, hprof, n=3)
    except Exception:
        return []
    out: List[str] = []
    for row in shift.get("regressed", []):
        out.append(
            "profile: self-time share of %s rose %.1f%% -> %.1f%% "
            "(+%.1f points)" % (
                row["frame"], 100 * row["base_frac"],
                100 * row["head_frac"], 100 * row["delta_frac"],
            )
        )
    for row in shift.get("improved", []):
        out.append(
            "profile: self-time share of %s fell %.1f%% -> %.1f%%" % (
                row["frame"], 100 * row["base_frac"],
                100 * row["head_frac"],
            )
        )
    return out


def _plan_term_lines(base: dict, head: dict) -> List[str]:
    """Plan-compiler decision shifts between two records (empty when
    either lacks a ``plan_terms`` section): names the term
    whose effective value or provenance changed, so a throughput
    verdict can be attributed to the planner decision that moved."""
    bterms, hterms = base.get("plan_terms"), head.get("plan_terms")
    if not bterms or not hterms:
        return []
    out: List[str] = []
    for term in sorted(set(bterms) | set(hterms)):
        if term.startswith("_"):
            continue  # bookkeeping entries (_replans)
        b, h = bterms.get(term) or {}, hterms.get(term) or {}
        bval, hval = b.get("value"), h.get("value")
        bsrc, hsrc = b.get("source"), h.get("source")
        if bval != hval:
            out.append(
                f"plan: term {term} changed {bval!r} ({bsrc}) -> "
                f"{hval!r} ({hsrc})"
            )
        elif bsrc != hsrc:
            out.append(
                f"plan: term {term} kept value {hval!r} but its source "
                f"changed {bsrc} -> {hsrc}"
            )
    breplans = (bterms.get("_replans") or {}).get("value", 0)
    hreplans = (hterms.get("_replans") or {}).get("value", 0)
    if breplans != hreplans:
        out.append(
            f"plan: mid-run re-plans {breplans} -> {hreplans}"
        )
    return out


def cmd_regress(records: List[dict], args) -> int:
    spec = args.regress
    if ".." not in spec:
        print("--regress wants BASE..HEAD", file=sys.stderr)
        return 2
    base_ref, _, head_ref = spec.partition("..")
    base = _resolve(records, base_ref)
    head = _resolve(records, head_ref)
    if base is None or head is None:
        missing = base_ref if base is None else head_ref
        print(f"no record matches {missing!r}", file=sys.stderr)
        return 3
    failures: List[str] = []
    btp, htp = _throughput_of(base), _throughput_of(head)
    if btp and htp is not None:
        drop = (btp - htp) / btp
        if drop > args.drop_frac:
            failures.append(
                f"throughput dropped {drop:.1%} "
                f"({btp:.1f} -> {htp:.1f}, limit {args.drop_frac:.0%})"
            )
    bstall, hstall = _stall_total(base), _stall_total(head)
    if bstall > 0:
        rise = (hstall - bstall) / bstall
        if rise > args.stall_rise_frac:
            failures.append(
                f"stall seconds rose {rise:.1%} "
                f"({bstall:.1f}s -> {hstall:.1f}s, "
                f"limit {args.stall_rise_frac:.0%})"
            )
    elif hstall > 0 and btp and htp:
        # A base with zero recorded stall: any material stall showing
        # up in HEAD while throughput also moved is worth flagging.
        if (btp - htp) / btp > args.drop_frac:
            failures.append(
                f"stalls appeared ({hstall:.1f}s) alongside a "
                f"throughput drop"
            )
    if head.get("status") == "failed" and base.get("status") == "done":
        failures.append("head run failed where base succeeded")
    print(f"base: {base.get('id')}  head: {head.get('id')}")
    profile_lines = _profile_shift_lines(base, head)
    plan_lines = _plan_term_lines(base, head)
    if failures:
        for f in failures:
            print(f"REGRESSION: {f}")
        # When the gate trips, NAME the frame the time moved into, not
        # just that it moved; and the plan term that changed alongside
        # the throughput verdict.
        for line in profile_lines:
            print(line)
        for line in plan_lines:
            print(line)
        return 1
    for line in profile_lines:
        print(line)
    for line in plan_lines:
        print(line)
    print(
        f"ok: throughput {btp if btp is not None else '-'} -> "
        f"{htp if htp is not None else '-'}, "
        f"stall {bstall:.1f}s -> {hstall:.1f}s"
    )
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--ledger", default=None,
        help="ledger NDJSON path (default: RSDL_RUN_LEDGER resolution)",
    )
    parser.add_argument(
        "--regress", metavar="BASE..HEAD", default=None,
        help="exit 1 if HEAD regressed vs BASE beyond thresholds",
    )
    parser.add_argument("--drop-frac", type=float, default=0.2,
                        help="tolerated relative throughput drop")
    parser.add_argument("--stall-rise-frac", type=float, default=0.5,
                        help="tolerated relative stall-seconds rise")
    sub = parser.add_subparsers(dest="cmd")
    p_list = sub.add_parser("list", help="one line per record")
    p_list.add_argument("--limit", type=int, default=0)
    p_list.add_argument("--json", action="store_true")
    p_show = sub.add_parser("show", help="full record JSON")
    p_show.add_argument("ref")
    p_diff = sub.add_parser("diff", help="field-level comparison")
    p_diff.add_argument("base")
    p_diff.add_argument("head")
    args = parser.parse_args(argv)

    path = args.ledger if args.ledger else runledger.ledger_path()
    if path is None:
        print(
            "no ledger: pass --ledger or set RSDL_RUN_LEDGER",
            file=sys.stderr,
        )
        return 3
    records = runledger.read(path)
    if args.regress:
        if not records:
            print(f"ledger {path} is empty or missing", file=sys.stderr)
            return 3
        return cmd_regress(records, args)
    if args.cmd == "show":
        return cmd_show(records, args)
    if args.cmd == "diff":
        return cmd_diff(records, args)
    if args.cmd is None:
        args.limit, args.json = 0, False
    return cmd_list(records, args)


if __name__ == "__main__":
    sys.exit(main())
