#!/usr/bin/env python
"""CLI for the continuous profiling plane (telemetry/profiler.py).

Subcommands::

    python -m ray_shuffling_data_loader_tpu_torch.rsdl_prof top   [--dir DIR | --url URL] [--stage S] [--job J]
                                                             [--epoch E] [-n N] [--json]
    python -m ray_shuffling_data_loader_tpu_torch.rsdl_prof flame --out PAGE.html [--dir DIR | --url URL]
                                                             [--stage S] [--job J] [--epoch E]
    python -m ray_shuffling_data_loader_tpu_torch.rsdl_prof diff  BASE HEAD [--ledger PATH] [-n N] [--json]

``top`` prints the merged self/total frame table (per-stage
attribution included); ``flame`` writes the self-contained flamegraph
HTML page; ``diff`` is the differential profile — BASE and HEAD are
either two profile **spool directories** or, with ``--ledger``, two
run-ledger record refs (index, id, or unique id prefix) whose embedded
profile digests are compared. Diffs compare self-time *shares*, not
seconds, so runs of different lengths diff meaningfully.

Source resolution for top/flame: ``--url`` scrapes a live obs
endpoint's ``/profile``; ``--dir`` reads a spool directory; default is
this environment's spool (``RSDL_PROFILE_DIR`` /
``$RSDL_RUNTIME_DIR/profiles``). Exit 3 when no profile data exists at
the chosen source — "the plane was never on" is distinguishable from
an empty-but-armed run. The flags, the output and the exit codes are the
JAX package's ``tools/rsdl_prof.py``'s.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

from ray_shuffling_data_loader_tpu_torch.telemetry import profiler, runledger


def _fetch_url(url: str, args) -> dict:
    import urllib.parse
    import urllib.request

    params = {}
    for name in ("stage", "job", "epoch"):
        value = getattr(args, name, None)
        if value:
            params[name] = value
    query = ("?" + urllib.parse.urlencode(params)) if params else ""
    with urllib.request.urlopen(
        url.rstrip("/") + "/profile" + query, timeout=10
    ) as resp:
        return json.loads(resp.read().decode())


def _local_agg(args) -> dict:
    return profiler.aggregate_profiles(
        directory=getattr(args, "dir", None),
        stage=getattr(args, "stage", None),
        job=getattr(args, "job", None),
        epoch=getattr(args, "epoch", None),
    )


def _agg_of(args) -> dict:
    """An aggregate-shaped view from --url, --dir, or the ambient
    spool. A /profile body converts via its collapsed text? No — it
    already carries the top table; reuse it as-is for rendering by
    rebuilding stacks from the collapsed text."""
    url = getattr(args, "url", None)
    if url:
        body = _fetch_url(url, args)
        stacks = []
        for line in (body.get("collapsed") or "").splitlines():
            stack, _, count = line.rpartition(" ")
            if not stack:
                continue
            tags = {}
            if stack.startswith("stage:"):
                head, _, rest = stack.partition(";")
                tags["stage"] = head[len("stage:"):]
                stack = rest or head
            try:
                n = int(count)
            except ValueError:
                continue
            hz = float(body.get("hz") or 67.0)
            stacks.append({
                "stack": stack, "count": n, "seconds": n / hz,
                "tags": tags,
            })
        return {
            "sources": body.get("sources") or [],
            "samples": int(body.get("samples") or 0),
            "seconds": float(body.get("seconds") or 0.0),
            "stacks": stacks,
        }
    return _local_agg(args)


def cmd_top(args) -> int:
    agg = _agg_of(args)
    if not agg["stacks"]:
        print("no profile data (is RSDL_PROFILE set?)", file=sys.stderr)
        return 3
    rows = profiler.top_table(agg, n=args.n)
    if args.json:
        print(json.dumps({
            "samples": agg["samples"],
            "seconds": round(agg["seconds"], 3),
            "sources": len(agg["sources"]),
            "top": rows,
        }, indent=2))
        return 0
    print(
        f"{agg['samples']} samples, {agg['seconds']:.1f} sampled-seconds,"
        f" {len(agg['sources'])} sources"
    )
    print(f"{'SELF':>8} {'FRAC':>6} {'TOTAL':>8}  FRAME / stages")
    for row in rows:
        stages = ",".join(
            f"{k}={v:.1f}s" for k, v in row["stages"].items()
        )
        print(
            f"{row['self_s']:>7.1f}s {row['self_frac']:>6.1%} "
            f"{row['total_s']:>7.1f}s  {row['frame']}"
            + (f"  [{stages}]" if stages else "")
        )
    return 0


def cmd_flame(args) -> int:
    agg = _agg_of(args)
    if not agg["stacks"]:
        print("no profile data (is RSDL_PROFILE set?)", file=sys.stderr)
        return 3
    title = "rsdl profile"
    if args.stage:
        title += f" · stage={args.stage}"
    html = profiler.render_flame_html(agg, title=title)
    with open(args.out, "w") as f:
        f.write(html)
    print(f"wrote {args.out} ({len(html)} bytes, "
          f"{agg['samples']} samples)")
    return 0


def _digest_of_ref(path: str, ref: str) -> Optional[dict]:
    records = runledger.read(path)
    try:
        rec = records[int(ref)]
    except (ValueError, IndexError):
        matches = [
            r for r in records
            if str(r.get("id", "")).startswith(ref)
        ]
        rec = matches[0] if len(matches) == 1 else None
    if rec is None:
        return None
    return rec.get("profile")


def _digest_of_dir(directory: str) -> Optional[dict]:
    records = profiler.load_records(directory)
    if not records:
        return None
    return profiler.digest(records=records, n=50)


def cmd_diff(args) -> int:
    if args.ledger:
        base = _digest_of_ref(args.ledger, args.base)
        head = _digest_of_ref(args.ledger, args.head)
    else:
        base = _digest_of_dir(args.base)
        head = _digest_of_dir(args.head)
    if base is None or head is None:
        which = args.base if base is None else args.head
        print(f"no profile data for {which!r}", file=sys.stderr)
        return 3
    shift = profiler.diff_digests(base, head, n=args.n)
    if args.json:
        print(json.dumps(shift, indent=2))
        return 0
    if not shift["regressed"] and not shift["improved"]:
        print("no self-time share movement between BASE and HEAD")
        return 0
    for row in shift["regressed"]:
        print(
            f"+{100 * row['delta_frac']:5.1f}pp  {row['frame']}  "
            f"({100 * row['base_frac']:.1f}% -> "
            f"{100 * row['head_frac']:.1f}%)"
        )
    for row in shift["improved"]:
        print(
            f"{100 * row['delta_frac']:6.1f}pp  {row['frame']}  "
            f"({100 * row['base_frac']:.1f}% -> "
            f"{100 * row['head_frac']:.1f}%)"
        )
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        description=__doc__.splitlines()[0]
    )
    sub = parser.add_subparsers(dest="cmd", required=True)

    def _source_args(p):
        p.add_argument("--dir", default=None,
                       help="profile spool directory")
        p.add_argument("--url", default=None,
                       help="live obs endpoint base URL")
        p.add_argument("--stage", default=None)
        p.add_argument("--job", default=None)
        p.add_argument("--epoch", default=None)

    p_top = sub.add_parser("top", help="self/total frame table")
    _source_args(p_top)
    p_top.add_argument("-n", type=int, default=None)
    p_top.add_argument("--json", action="store_true")
    p_flame = sub.add_parser("flame", help="write flamegraph HTML")
    _source_args(p_flame)
    p_flame.add_argument("--out", required=True)
    p_diff = sub.add_parser("diff", help="differential profile")
    p_diff.add_argument("base")
    p_diff.add_argument("head")
    p_diff.add_argument("--ledger", default=None,
                        help="treat BASE/HEAD as run-ledger refs")
    p_diff.add_argument("-n", type=int, default=10)
    p_diff.add_argument("--json", action="store_true")
    args = parser.parse_args(argv)
    if args.cmd == "top":
        return cmd_top(args)
    if args.cmd == "flame":
        return cmd_flame(args)
    return cmd_diff(args)


if __name__ == "__main__":
    sys.exit(main())
