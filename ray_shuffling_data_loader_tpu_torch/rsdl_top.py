#!/usr/bin/env python
"""rsdl_top: live terminal dashboard for a running shuffle.

``top`` for the shuffle plane — polls the obs endpoint
(``RSDL_OBS_PORT``, :mod:`telemetry.obs_server`) and renders one
refreshing screen: epoch-window state, per-stage throughput sparklines
(from ``/timeseries`` rate series), queue depths, store residency,
the capacity ledger (per-tier/per-epoch residency + host headroom,
``/capacity``), the online critical-path verdict (``/critical``),
active SLO alerts with their recent transitions (``/alerts``),
recovery counters, stall attribution, the straggler/skew table, the
continuous profiler's hot-frames panel (top-5 self-time frames with
per-stage attribution, ``/profile`` — shown when ``RSDL_PROFILE`` is
armed), and the latest structured events. Pure stdlib, no curses —
ANSI clear + redraw, so it works over any ssh session.

Usage::

    RSDL_METRICS=1 RSDL_OBS_PORT=9100 python -m ray_shuffling_data_loader_tpu_torch.train_dlrm ... &
    python -m ray_shuffling_data_loader_tpu_torch.rsdl_top                # live, 2 s refresh
    python -m ray_shuffling_data_loader_tpu_torch.rsdl_top --once         # one frame (CI smoke)
    python -m ray_shuffling_data_loader_tpu_torch.rsdl_top --once --json  # machine-readable frame
    python -m ray_shuffling_data_loader_tpu_torch.rsdl_top --fleet        # per-tenant panel (/jobs)
    python -m ray_shuffling_data_loader_tpu_torch.rsdl_top --url http://host:9100 --interval 5

``--fleet`` swaps the single-trial dashboard for the
service-wide per-tenant table: one row per job with its epoch window,
delivered bytes + current rate, resident store bytes, decode-cache
claims, admission waits, fair-share vtime lag, and any SLO alerts
firing against the tenant.

Exit codes: 0 on a rendered frame, 1 when the endpoint is unreachable
(so ``--once`` doubles as an is-the-obs-plane-up gate). The flags, the
output and the exit codes are the JAX package's ``tools/rsdl_top.py``'s.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import urllib.error
import urllib.request
from typing import Any, Dict, List, Optional

SPARK_CHARS = "▁▂▃▄▅▆▇█"

# The rate series the throughput panel shows, in display order.
THROUGHPUT_SERIES = (
    ("map rows/s", "rsdl_shuffle_map_rows"),
    ("reduce rows/s", "rsdl_shuffle_reduce_rows"),
    ("h2d B/s", "rsdl_h2d_bytes"),
)


def _get_json(base: str, path: str, timeout: float = 5.0):
    with urllib.request.urlopen(base + path, timeout=timeout) as resp:
        return json.loads(resp.read().decode())


def sparkline(values: List[float], width: int = 40) -> str:
    """Unicode block sparkline of the trailing ``width`` values,
    normalized to the window's own max (an all-zero window renders
    flat)."""
    if not values:
        return ""
    values = values[-width:]
    peak = max(values)
    if peak <= 0:
        return SPARK_CHARS[0] * len(values)
    out = []
    for v in values:
        idx = int(round((len(SPARK_CHARS) - 1) * max(0.0, v) / peak))
        out.append(SPARK_CHARS[idx])
    return "".join(out)


def _fmt_bytes(num: Optional[float]) -> str:
    if num is None:
        return "-"
    num = float(num)
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(num) < 1024.0:
            return f"{num:.1f}{unit}"
        num /= 1024.0
    return f"{num:.1f}PiB"


def _fmt(value: Any) -> str:
    if value is None:
        return "-"
    if isinstance(value, float):
        return f"{value:.4g}"
    return str(value)


# ---------------------------------------------------------------------------
# Frame collection
# ---------------------------------------------------------------------------


def collect(base: str, window_s: float) -> Dict[str, Any]:
    """One dashboard frame's worth of endpoint data. Individual pages
    degrade to an ``error`` entry (the dashboard renders what it got)
    — only a fully unreachable endpoint raises."""
    frame: Dict[str, Any] = {"ts": time.time(), "url": base}
    # /status is the must-have page: let its failure propagate (the
    # caller maps it to exit 1).
    frame["status"] = _get_json(base, "/status")
    for key, path in (
        ("healthz", "/healthz"),
        ("timeseries", f"/timeseries?window={window_s:g}"),
        ("events", "/events?limit=12"),
        ("stragglers", "/stragglers"),
        ("capacity", "/capacity"),
        ("critical", "/critical"),
        ("alerts", "/alerts"),
        ("jobs", "/jobs"),
        ("profile", "/profile?top=5"),
    ):
        try:
            frame[key] = _get_json(base, path)
        except Exception as exc:
            frame[key] = {"error": f"{type(exc).__name__}: {exc}"[:200]}
    return frame


def _series_points(frame: dict, name: str) -> List[dict]:
    series = (frame.get("timeseries") or {}).get("series") or {}
    for key, points in series.items():
        base = key.split("{", 1)[0]
        if name in (key, base) or name == _prom_alias(base):
            return points
    return []


def _prom_alias(base: str) -> str:
    import re

    out = re.sub(r"[^a-zA-Z0-9_:]", "_", base)
    return out if out.startswith("rsdl_") else "rsdl_" + out


# ---------------------------------------------------------------------------
# Rendering
# ---------------------------------------------------------------------------


def _match_job(jobs: Dict[str, Any], wanted: str) -> Optional[str]:
    """Resolve a ``--job`` filter against the per-job map: exact id
    first, then unique substring (job names prefix the ids)."""
    if wanted in jobs:
        return wanted
    hits = [k for k in jobs if wanted in k]
    return hits[0] if len(hits) == 1 else None


def render(frame: Dict[str, Any]) -> str:
    status = frame.get("status") or {}
    healthz = frame.get("healthz") or {}
    lines: List[str] = []
    shuffle = (status.get("providers") or {}).get("shuffle") or {}
    job_filter = frame.get("job_filter")
    job_note = ""
    if job_filter:
        # Multi-job service: focus the trial panel on ONE
        # tenant's view instead of interleaving every job's epochs.
        jobs = shuffle.get("jobs") or {}
        key = _match_job(jobs, job_filter)
        if key is not None:
            shuffle = jobs[key]
            job_note = f"  job={key}"
        else:
            job_note = f"  job={job_filter}(no match)"
    epoch_window = (
        shuffle.get("in_flight_epochs")
        if job_filter
        else status.get("in_flight_epochs")
    ) or []
    lines.append(
        f"rsdl_top  {time.strftime('%H:%M:%S', time.localtime(frame['ts']))}"
        f"  {frame['url']}"
        f"  up={healthz.get('ok', '?')}"
        f"  uptime={_fmt(healthz.get('uptime_s'))}s"
        f"  trial_running={shuffle.get('running', '-')}"
        + job_note
    )
    service = (status.get("providers") or {}).get("service") or {}
    if service.get("jobs"):
        parts = []
        for rec in service["jobs"][-6:]:
            parts.append(
                f"{rec.get('job_id')}"
                f"[w={rec.get('weight')}"
                f",{'run' if rec.get('running') else 'done'}]"
            )
        lines.append("jobs     " + "  ".join(parts)[:115])
    epochs = shuffle.get("epochs") or {}
    parts = []
    for e in sorted(epochs, key=lambda x: int(x)):
        st = epochs[e]
        parts.append(
            f"e{e}:{st.get('state', '?')}"
            f"({st.get('delivered_reducers', 0)}"
            f"/{shuffle.get('num_reducers', '?')})"
        )
    lines.append(
        "epochs   in-flight=" + (str(epoch_window) if epoch_window else "[]")
        + ("  " + " ".join(parts) if parts else "")
    )

    # Federation freshness: per-source-host last-shipped age
    # from the relay sink — a dead remote relay reads STALE here live.
    relay = healthz.get("relay") or {}
    relay_hosts = relay.get("hosts") or {}
    if relay.get("role") or relay_hosts:
        parts = []
        for host_id in sorted(relay_hosts):
            rec = relay_hosts[host_id] or {}
            mark = (
                "STALE"
                if rec.get("stale")
                else f"{_fmt(rec.get('age_s'))}s"
            )
            parts.append(
                f"{host_id}:{mark}"
                f"/{_fmt_bytes(rec.get('bytes', 0))}"
            )
        lines.append(
            (
                f"relay    role={relay.get('role') or '-'}  "
                + ("  ".join(parts) if parts else "(no remote hosts)")
            )[:115]
        )

    # Throughput sparklines from /timeseries rate series.
    lines.append("")
    lines.append("throughput (rate over the window)")
    for label, name in THROUGHPUT_SERIES:
        points = _series_points(frame, name)
        rates = [float(p.get("rate", 0.0)) for p in points if "rate" in p]
        cur = rates[-1] if rates else None
        lines.append(
            f"  {label:>14}  {sparkline(rates):40s}  "
            f"{_fmt(cur) if cur is not None else '-'}"
        )

    # Queue depths + store residency.
    depths = status.get("queue_depths") or {}
    total = depths.get("queue.depth.total")
    lines.append("")
    lines.append(
        f"queue    total={_fmt(total)}  "
        + "  ".join(
            f"{k.split('{', 1)[1].rstrip('}')}: {int(v)}"
            for k, v in sorted(depths.items())
            if k != "queue.depth.total"
        )[:100]
    )
    store = status.get("store") or {}
    store_bytes = store.get("total_bytes") or store.get("shm_bytes")
    lines.append(
        "store    "
        f"objects={_fmt(store.get('objects'))}  "
        f"bytes={_fmt_bytes(store_bytes)}  "
        f"spill={_fmt_bytes(store.get('spill_bytes'))}"
    )

    # Recovery + stall attribution.
    recovery = status.get("recovery") or {}
    lines.append(
        "recovery "
        + (
            "  ".join(
                f"{k.replace('recovery.', '')}={int(v)}"
                for k, v in sorted(recovery.items())
            )
            if recovery
            else "(none)"
        )
    )

    # Capacity ledger: per-tier residency + host headroom.
    cap = frame.get("capacity") or {}
    totals = cap.get("totals") or {}
    host = cap.get("host") or {}
    shm_tot = (totals.get("shm") or {})
    spill_tot = (totals.get("spill") or {})
    frac = cap.get("shm_used_frac")
    lines.append(
        "capacity "
        f"shm={_fmt_bytes(shm_tot.get('resident_bytes'))}"
        f"({shm_tot.get('segments', 0)} seg)  "
        f"spill={_fmt_bytes(spill_tot.get('resident_bytes'))}"
        f"({spill_tot.get('segments', 0)} seg)  "
        f"used={'-' if frac is None else f'{100 * frac:.1f}%'}  "
        f"rss={_fmt_bytes(host.get('rss_bytes'))}  "
        f"shm_free={_fmt_bytes(host.get('shm_free_bytes'))}"
    )
    epochs_cap = cap.get("epochs") or {}
    if epochs_cap:
        parts = []
        # Numeric order, unknown-epoch bucket last — matches
        # telemetry/capacity.py's epoch_sort_key (this tool stays
        # stdlib-only, so the 2-line key is mirrored, not imported).
        for e in sorted(
            epochs_cap,
            key=lambda x: (0, int(x)) if x.lstrip("-").isdigit()
            else (1, 0),
        )[-6:]:
            tiers = epochs_cap[e]
            res = sum(
                c.get("resident_bytes", 0) for c in tiers.values()
            )
            parts.append(f"e{e}={_fmt_bytes(res)}")
        lines.append("  resident by epoch: " + "  ".join(parts))

    # Online critical path (shares of the current epoch's active time).
    crit = frame.get("critical") or {}
    current = crit.get("current") or {}
    shares = current.get("sole_share") or {}
    share_txt = "  ".join(
        f"{stage}={100 * share:.0f}%"
        for stage, share in sorted(
            shares.items(), key=lambda kv: -kv[1]
        )
    )
    lines.append(
        "critical "
        f"epoch={_fmt(current.get('epoch'))}  "
        f"path={current.get('critical_path') or '-'}  "
        f"run={crit.get('run_critical_path') or '-'}"
        + (f"  [{share_txt}]" if share_txt else "")
    )

    # Alerts: active first, then the recent transitions.
    alerts = frame.get("alerts") or {}
    active = alerts.get("active") or []
    lines.append(
        "alerts   "
        + (
            "ACTIVE: " + ", ".join(active)
            if active
            else f"(none active, {len(alerts.get('rules') or [])} rules)"
        )
    )
    for rec in (alerts.get("history") or [])[-4:]:
        stamp = time.strftime(
            "%H:%M:%S", time.localtime(float(rec.get("ts", 0.0)))
        )
        lines.append(
            f"  {stamp}  {rec.get('event', '?'):<9} {rec.get('rule')}"
            f"  value={_fmt(rec.get('value'))}"
        )

    # Stragglers.
    stragglers = frame.get("stragglers") or {}
    stages = stragglers.get("stages") or {}
    lines.append("")
    flagged_total = stragglers.get(
        "flagged_total", len(stragglers.get("flagged") or [])
    )
    lines.append(
        "stragglers  "
        f"tasks={_fmt(stragglers.get('tasks_total'))}  "
        f"wedged={len(stragglers.get('wedged') or [])}  "
        f"flagged={flagged_total}"
    )
    if stages:
        lines.append(
            "  stage          n    median_s      p99_s   skew  slowest_host"
        )
        for stage in sorted(stages):
            st = stages[stage]
            lines.append(
                f"  {stage:<12}{st.get('count', 0):>4}"
                f"{_fmt(st.get('median_s')):>12}"
                f"{_fmt(st.get('p99_s')):>11}"
                f"{_fmt(st.get('skew_ratio')):>7}"
                f"  {st.get('slowest_host') or '-'}"
            )
    for task in (stragglers.get("wedged") or [])[:4]:
        lines.append(
            f"  WEDGED: {task.get('stage')} pid={task.get('pid')} "
            f"age={_fmt(task.get('age_s'))}s "
            f"(budget {_fmt(task.get('budget_s'))}s)"
        )
    for task in (stragglers.get("flagged") or [])[:4]:
        lines.append(
            f"  slow: {task.get('stage')} host={task.get('host')} "
            f"pid={task.get('pid')} dur={_fmt(task.get('dur_s'))}s"
            + (f" epoch={task['epoch']}" if "epoch" in task else "")
        )

    # Hot frames: the continuous profiler's top self-time
    # frames with per-stage attribution — where the run's wall time
    # ACTUALLY goes, declared-instrumentation or not. Absent (not an
    # error) when the profiling plane is off.
    profile = frame.get("profile") or {}
    top_frames = profile.get("top") or []
    if top_frames:
        lines.append("")
        lines.append(
            "hot frames  "
            f"samples={_fmt(profile.get('samples'))}  "
            f"sampled={_fmt(profile.get('seconds'))}s  "
            f"hz={_fmt(profile.get('hz'))}  "
            f"sampler={'on' if profile.get('sampler_running') else 'off'}"
        )
        for row in top_frames[:5]:
            stages = ",".join(
                f"{k}={v:.1f}s" for k, v in (row.get("stages") or {}).items()
            )
            lines.append(
                f"  {row.get('self_s', 0.0):>6.1f}s "
                f"{row.get('self_frac', 0.0):>6.1%}  {row.get('frame')}"
                + (f"  [{stages}]" if stages else "")
            )

    # Events tail (job-filtered when --job is set: job-stamped records
    # must match; UNstamped ones are session-level — store/evictor/obs
    # — and stay visible, the same policy as epoch_report --job). The
    # by_kind header is recomputed from the filtered set so the counts
    # and the tail below them can never disagree.
    events = frame.get("events") or {}
    if job_filter:
        recs = [
            r
            for r in (events.get("events") or [])
            if "job" not in r or job_filter in str(r.get("job"))
        ]
        by_kind_f: Dict[str, int] = {}
        for r in recs:
            kind = str(r.get("kind", "?"))
            by_kind_f[kind] = by_kind_f.get(kind, 0) + 1
        events = dict(events, events=recs, by_kind=by_kind_f)
    lines.append("")
    by_kind = events.get("by_kind") or {}
    lines.append(
        "events   "
        + (
            "  ".join(f"{k}={v}" for k, v in sorted(by_kind.items()))[:110]
            if by_kind
            else "(none)"
        )
    )
    for rec in (events.get("events") or [])[-8:]:
        ts = time.strftime(
            "%H:%M:%S", time.localtime(float(rec.get("ts", 0.0)))
        )
        detail = " ".join(
            f"{k}={rec[k]}"
            for k in ("epoch", "stage", "schedule", "attempt", "error",
                      "counter", "rank", "duration_s")
            if k in rec
        )
        lines.append(f"  {ts}  {rec.get('kind', '?'):<18} {detail}"[:118])
    return "\n".join(lines)


def render_fleet(frame: Dict[str, Any]) -> str:
    """The ``--fleet`` panel: one row per tenant from ``/jobs``."""
    page = frame.get("jobs") or {}
    rows = page.get("jobs") or []
    healthz = frame.get("healthz") or {}
    lines: List[str] = []
    running = sum(1 for r in rows if r.get("running"))
    lines.append(
        "rsdl_top --fleet  "
        f"{time.strftime('%H:%M:%S', time.localtime(frame['ts']))}"
        f"  {frame['url']}"
        f"  up={healthz.get('ok', '?')}"
        f"  mode={page.get('service_mode') or '-'}"
        f"  jobs={len(rows)} ({running} running)"
    )
    if page.get("error"):
        lines.append(f"  /jobs error: {page['error']}")
        return "\n".join(lines)
    if not rows:
        lines.append("  (no tenants known to this session)")
        return "\n".join(lines)
    lines.append(
        "  job                    w  run  epochs   in-flight"
        "    delivered      rate  resident   cache  adm(n/s)"
        "   vlag  alerts"
    )
    for row in rows:
        jid = str(row.get("job_id", "?"))
        done = row.get("epochs_done")
        total = row.get("num_epochs")
        epochs = (
            f"{done}/{total}" if done is not None and total is not None
            else (str(done) if done is not None else "-")
        )
        window = row.get("in_flight_epochs")
        resident = row.get("resident_bytes") or {}
        resident_total = (
            sum(resident.values()) if isinstance(resident, dict) else None
        )
        adm = row.get("admission") or {}
        adm_txt = (
            f"{adm.get('waits', 0)}/{adm.get('wait_s', 0.0):.1f}s"
            if adm else "-"
        )
        alerts = row.get("active_alerts") or []
        lines.append(
            f"  {jid:<22}"
            f"{_fmt(row.get('weight')):>3}"
            f"{('yes' if row.get('running') else 'no'):>5}"
            f"{epochs:>8}"
            f"  {str(window if window else []):<10}"
            f"{_fmt_bytes(row.get('delivered_bytes')):>11}"
            f"{_fmt_bytes(row.get('delivered_rate_bps')) + '/s' if row.get('delivered_rate_bps') is not None else '-':>10}"
            f"{_fmt_bytes(resident_total):>10}"
            f"{_fmt(row.get('cache_claims')):>8}"
            f"{adm_txt:>10}"
            f"{_fmt(row.get('dispatch_vtime_lag')):>7}"
            f"  {'ALERT: ' + ','.join(alerts) if alerts else '-'}"
        )
        if row.get("error"):
            lines.append(f"      error: {str(row['error'])[:100]}")
    # The engine-wide view below the table: firing instances + history.
    alerts_page = frame.get("alerts") or {}
    active = alerts_page.get("active") or []
    if active:
        lines.append("  active alerts: " + ", ".join(active))
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# Main
# ---------------------------------------------------------------------------


def default_url() -> str:
    port = os.environ.get("RSDL_OBS_PORT", "").strip() or "9100"
    host = os.environ.get("RSDL_OBS_HOST", "").strip() or "127.0.0.1"
    if host == "0.0.0.0":
        host = "127.0.0.1"
    return f"http://{host}:{port}"


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    parser.add_argument(
        "--url",
        default=None,
        help="obs endpoint base URL (default: http://$RSDL_OBS_HOST"
        ":$RSDL_OBS_PORT, falling back to 127.0.0.1:9100)",
    )
    parser.add_argument(
        "--interval", type=float, default=2.0,
        help="refresh period in seconds (live mode; default 2)",
    )
    parser.add_argument(
        "--window", type=float, default=120.0,
        help="sparkline window in seconds (default 120)",
    )
    parser.add_argument(
        "--once", action="store_true",
        help="render one frame and exit (CI smoke / scripting)",
    )
    parser.add_argument(
        "--json", action="store_true",
        help="emit the raw frame as JSON instead of the dashboard",
    )
    parser.add_argument(
        "--fleet", action="store_true",
        help="render the service-wide per-tenant table (/jobs) instead "
        "of the single-trial dashboard",
    )
    parser.add_argument(
        "--job", default=None,
        help="focus on ONE service job (exact job id or unique "
        "substring): the trial panel shows that job's epochs and the "
        "events tail is filtered to it (multi-job service)",
    )
    args = parser.parse_args(argv)
    base = (args.url or default_url()).rstrip("/")

    while True:
        try:
            frame = collect(base, args.window)
            if args.job:
                frame["job_filter"] = args.job
        except (urllib.error.URLError, OSError, ValueError) as exc:
            print(f"rsdl_top: {base} unreachable: {exc}", file=sys.stderr)
            return 1
        if args.json:
            print(json.dumps(frame, default=str))
        else:
            if not args.once:
                # ANSI clear + home; keeps the frame flicker-free enough
                # without curses.
                sys.stdout.write("\x1b[2J\x1b[H")
            print(render_fleet(frame) if args.fleet else render(frame))
        if args.once:
            return 0
        try:
            time.sleep(max(0.2, args.interval))
        except KeyboardInterrupt:
            return 0


if __name__ == "__main__":
    sys.exit(main())
