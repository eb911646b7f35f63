"""The SLO engine: declarative alert rules over the aggregated registry.

Rules are flat JSON objects::

    {"name": "wedged_worker",          # unique; replaces a default
     "kind": "threshold",              # threshold | rate | absence
     "metric": "straggler.wedged_tasks",  # registry key, base name,
                                          # or rsdl_ Prometheus alias
     "op": ">", "value": 0,            # predicate against the value
     "window_s": 60,                   # rate: the ring's trailing window;
                                       # absence: the staleness bound
     "for_s": 0,                       # how long the condition must hold
     "only_in_flight": false,          # evaluate only while a trial runs
     "per_job": false,                 # one instance per live job
     "per_job_metric": null,           # the per-job instances' metric
                                       # (default: "metric")
     "field": "rate",                  # rate rules: the ring point's field
                                       # ("rate" | "window_mean")
     "severity": "warn"}               # a free-form label

* ``threshold``: the predicate over the current aggregated value
  (:func:`.export.aggregate`; the keys that match a base name are summed,
  so ``stall_seconds`` covers every ``cause=``).
* ``rate``: over the mean per-second rate in the trailing ``window_s`` of
  the time series' ring (:mod:`.timeseries`, counters already rates).
  ``fold="max-source"`` takes the worst source process instead of the sum.
* ``absence``: fires when the metric is missing from the aggregate, or
  (with ``window_s``) has no point in the ring within the window.

A ``per_job`` rule expands into one instance per live job each tick: the
service's registry when that module is loaded, else the shuffle's live
trial tracker (:func:`..shuffle.live_status`), else the ``job=`` labels of
the aggregate. Each instance reads ``per_job_metric`` restricted to its
job; with no live job the rule is one global instance.

``RSDL_SLO_RULES`` holds inline JSON (a rule or a list) or the path of a
JSON file. Its rules merge over :data:`DEFAULT_RULES` by name (the same
name replaces a default; ``"disabled": true`` removes it).

:func:`evaluate` runs on the time series' tick: a rule whose condition
held ``for_s`` goes ok -> pending -> firing, emits ``alert.fired``
(:mod:`.events`), adds one to ``alert.fired_total{rule=}`` and sets
``alert.active{rule=}`` to 1; when the condition clears it resolves
(``alert.resolved``, the gauge 0). ``/alerts`` (:mod:`.obs_server`) serves
every rule's state and the recent transitions.

Evaluated only from the time series' tick, which runs only with metrics
on; never imported while the planes are off. No RPC, never raises.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from ray_shuffling_data_loader_tpu_torch.telemetry import export as _export
from ray_shuffling_data_loader_tpu_torch.telemetry import metrics as _metrics
from ray_shuffling_data_loader_tpu_torch.telemetry import timeseries as _timeseries

ENV_SLO_RULES = "RSDL_SLO_RULES"
_PKG = "ray_shuffling_data_loader_tpu_torch"

_OPS = {
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
    "==": lambda a, b: a == b,
    "!=": lambda a, b: a != b,
}

# The default pack, the JAX package's rule for rule. Windows are
# conservative: a rule that cries wolf is worse than none.
DEFAULT_RULES: List[Dict[str, Any]] = [
    {
        # No reducer produced a row for a sustained window mid-trial: a
        # dead producer, a wedged window, retries spent. Per job: that
        # job's delivered bytes.
        "name": "producer_stalled",
        "kind": "rate",
        "metric": "shuffle.reduce_rows",
        "per_job": True,
        "per_job_metric": "service.delivered_bytes",
        "op": "==", "value": 0.0,
        "window_s": 30.0, "for_s": 15.0,
        "only_in_flight": True,
        "severity": "page",
    },
    {
        # A consumer stalled more than half its recent wall clock (both
        # causes, worst source: a sum would scale with the trainers).
        "name": "stall_over_budget",
        "kind": "rate",
        "metric": "stall_seconds",
        "per_job": True,
        "fold": "max-source",
        "op": ">", "value": 0.5,
        "window_s": 60.0, "for_s": 10.0,
        "only_in_flight": True,
        "severity": "warn",
    },
    {
        # The shm tier is near its budget: the next segments spill. Per
        # job: that job's share of the used budget.
        "name": "capacity_near_limit",
        "kind": "threshold",
        "metric": "capacity.shm_used_frac",
        "per_job": True,
        "per_job_metric": "capacity.job_shm_frac",
        "op": ">", "value": 0.9,
        "for_s": 0.0,
        "severity": "warn",
    },
    {
        # A task in flight past its wedge budget now.
        "name": "wedged_worker",
        "kind": "threshold",
        "metric": "straggler.wedged_tasks",
        "op": ">", "value": 0.0,
        "for_s": 0.0,
        "severity": "page",
    },
    {
        # The exactly-once reconcile found a digest mismatch.
        "name": "audit_mismatch",
        "kind": "threshold",
        "metric": "audit.digest_mismatch",
        "op": ">", "value": 0.0,
        "for_s": 0.0,
        "severity": "page",
    },
    {
        # The elastic plane's shm headroom (1 - the used fraction of the
        # store's budget) is nearly gone.
        "name": "headroom_low",
        "kind": "threshold",
        "metric": "elastic.shm_headroom_frac",
        "op": "<", "value": 0.1,
        "for_s": 0.0,
        "severity": "warn",
    },
    {
        # A graceful drain has waited on a host's in-flight tasks longer
        # than a healthy drain does.
        "name": "drain_stuck",
        "kind": "threshold",
        "metric": "elastic.drain_age_seconds",
        "op": ">", "value": 30.0,
        "for_s": 0.0,
        "severity": "page",
    },
    {
        # A journal resume started and no batch reached the consumer for
        # a sustained window.
        "name": "resume_stalled",
        "kind": "threshold",
        "metric": "recovery.resume_in_progress",
        "op": ">", "value": 0.0,
        "for_s": 60.0,
        "severity": "page",
    },
    {
        # A job's epochs wait long at the capacity admission gate (the
        # windowed mean of its recent waits).
        "name": "admission_wait_long",
        "kind": "rate",
        "metric": "service.admission_wait_seconds",
        "field": "window_mean",
        "op": ">", "value": 5.0,
        "window_s": 120.0, "for_s": 0.0,
        "per_job": True,
        "only_in_flight": True,
        "severity": "warn",
    },
    {
        # A job's fair-share virtual clock trails the most advanced one
        # while it still has queued tasks: it is starved.
        "name": "fair_share_starved",
        "kind": "threshold",
        "metric": "service.dispatch_vtime_lag",
        "op": ">", "value": 8.0,
        "for_s": 10.0,
        "per_job": True,
        "only_in_flight": True,
        "severity": "warn",
    },
    {
        # A relay shipper falls behind its spools (relay.lag_bytes); past
        # RSDL_RELAY_MAX_LAG_BYTES it drops records. A missing metric
        # never fires a threshold rule: relay-off sessions are untouched.
        "name": "relay_lagging",
        "kind": "threshold",
        "metric": "relay.lag_bytes",
        "op": ">", "value": 8.0 * 1024 * 1024,
        "for_s": 10.0,
        "severity": "warn",
    },
]

_HISTORY_CAP = 64

_lock = threading.Lock()
_rules_cache: Optional[List[Dict[str, Any]]] = None
# Instance state by rule name (global instances) or "rule|job".
_states: Dict[str, Dict[str, Any]] = {}
# Lifetime fire counts by instance key, apart from _states: a departed
# job's counts outlive its instance (the run ledger reads them at the end).
_fired_totals: Dict[str, int] = {}
_history: List[Dict[str, Any]] = []


def reset() -> None:
    """Drop the rule cache, every instance's state and the history; the
    next evaluation reads ``RSDL_SLO_RULES`` again."""
    global _rules_cache
    with _lock:
        _rules_cache = None
        _states.clear()
        _fired_totals.clear()
        _history.clear()


def _load_user_rules() -> List[Dict[str, Any]]:
    raw = os.environ.get(ENV_SLO_RULES, "").strip()
    if not raw:
        return []
    try:
        if raw.startswith("[") or raw.startswith("{"):
            parsed = json.loads(raw)
        else:
            with open(raw) as f:
                parsed = json.load(f)
    except (OSError, ValueError):
        import logging

        logging.getLogger(__name__).warning(
            "slo: cannot parse %s=%r; using the default rule pack only", ENV_SLO_RULES, raw[:120])
        return []
    if isinstance(parsed, dict):
        parsed = [parsed]
    return [r for r in parsed if isinstance(r, dict) and r.get("name")]


def rules() -> List[Dict[str, Any]]:
    """The rules in force: the default pack merged by name with
    ``RSDL_SLO_RULES``'s (the user's win, ``"disabled": true`` drops)."""
    global _rules_cache
    with _lock:
        if _rules_cache is not None:
            return list(_rules_cache)
    merged: Dict[str, Dict[str, Any]] = {r["name"]: dict(r) for r in DEFAULT_RULES}
    for rule in _load_user_rules():
        merged[str(rule["name"])] = dict(rule)
    out = [r for r in merged.values() if not r.get("disabled")]
    with _lock:
        _rules_cache = out
    return list(out)


# -- predicates --------------------------------------------------------------------


def _split_key(key: str) -> Tuple[str, Dict[str, str], str]:
    """``(base, labels, suffix)`` of a flat key: ``h{job=a}_sum`` ->
    ``("h", {"job": "a"}, "_sum")``."""
    brace, close = key.find("{"), key.rfind("}")
    if not (0 <= brace < close):
        return key, {}, ""
    labels: Dict[str, str] = {}
    for part in key[brace + 1:close].split(","):
        k, _, v = part.partition("=")
        labels[k] = v
    return key[:brace], labels, key[close + 1:]


def _metric_matches(key: str, name: str) -> bool:
    base, _labels, suffix = _split_key(key)
    if name in (key, base, base + suffix):
        return True
    # The Prometheus alias, with a histogram component's suffix too.
    if name == _timeseries._prom_name(base):
        return True
    return bool(suffix) and name == _timeseries._prom_name(base + suffix)


def _aggregate_value(name: str, flat: Optional[Dict[str, float]] = None,
                     job: Optional[str] = None) -> Optional[float]:
    """The sum of every aggregated key matching ``name``; None when none
    does. ``job`` keeps that job's ``job=`` series. Per-source keys are
    left out (they repeat the merged series), except as the fallback of a
    job filter that finds only the spool's job-stamped source keys."""
    if flat is None:
        try:
            flat = _export.aggregate(per_source=job is not None)
        except Exception:
            return None
    total: Optional[float] = None
    from_sources: Optional[float] = None
    for key, value in flat.items():
        if not _metric_matches(key, name):
            continue
        _base, labels, _suffix = _split_key(key)
        if job is not None and labels.get("job") != job:
            continue
        if "source" in labels:
            if job is not None:
                from_sources = (from_sources or 0.0) + float(value)
            continue
        total = (total or 0.0) + float(value)
    return total if total is not None else from_sources


def _source_of(key: str) -> Optional[str]:
    brace, close = key.find("{"), key.rfind("}")
    if not (0 <= brace < close):
        return None
    for part in key[brace + 1:close].split(","):
        k, _, v = part.partition("=")
        if k == "source":
            return v
    return None


def _window_rate(name: str, window_s: float, now: Optional[float] = None, fold: str = "sum",
                 job: Optional[str] = None, field: str = "rate") -> Optional[float]:
    """The mean of a ring field for ``name`` over the trailing window.
    ``fold="sum"``: each sample's matching keys summed, then the samples
    averaged; ``"max-source"``: that mean per source process, the worst
    returned. ``job`` keeps that job's series (the merged ones, else the
    job-stamped source ones). A ``rate`` field folds by sum, any other
    (``window_mean``) by max. None when the ring has no such point."""
    per_source = fold == "max-source"
    series = _timeseries.series(name=name, window_s=window_s, now=now, include_sources=per_source or job is not None,
                                job=job)
    # {group: {ts: value}}: merged keys under "", a group per source.
    base_groups: Dict[str, Dict[float, float]] = {}
    src_groups: Dict[str, Dict[float, float]] = {}
    for key, points in series.items():
        src = _source_of(key)
        by_ts = src_groups.setdefault(src, {}) if src is not None else base_groups.setdefault("", {})
        for p in points:
            if p.get(field) is None:
                continue
            ts = float(p["ts"])
            val = float(p[field])
            if field == "rate":
                by_ts[ts] = by_ts.get(ts, 0.0) + val
            else:
                by_ts[ts] = max(by_ts.get(ts, val), val)
    if per_source:
        groups = src_groups
    elif base_groups or job is None:
        # Merged series win; without a job, source series repeat them.
        groups = base_groups
    else:
        # Only job-stamped source series matched: one logical group.
        merged: Dict[float, float] = {}
        for by_ts in src_groups.values():
            for ts, val in by_ts.items():
                if field == "rate":
                    merged[ts] = merged.get(ts, 0.0) + val
                else:
                    merged[ts] = max(merged.get(ts, val), val)
        groups = {"": merged} if merged else {}
    means = [sum(by_ts.values()) / len(by_ts) for by_ts in groups.values() if by_ts]
    if not means:
        return None
    return max(means) if per_source else means[0]


def _metric_fresh_in_ring(name: str, window_s: float, now: Optional[float] = None, job: Optional[str] = None) -> bool:
    series = _timeseries.series(name=name, window_s=window_s, now=now, include_sources=job is not None, job=job)
    return any(points for points in series.values())


def _trial_in_flight(job: Optional[str] = None) -> bool:
    """Is a shuffle trial mid-flight (for ``job``, that job's own)? A job
    this process cannot see is not in flight."""
    shuffle_mod = sys.modules.get(f"{_PKG}.shuffle")
    if shuffle_mod is None:
        return False
    try:
        status = shuffle_mod.live_status()
        if job is None:
            return bool(status.get("running"))
        jobs = status.get("jobs") or {}
        if job in jobs:
            return bool(jobs[job].get("running"))
        return False
    except Exception:
        return False


def _live_job_ids(flat: Dict[str, float]) -> List[str]:
    """The jobs a ``per_job`` rule expands over: the service's registry
    when that module is loaded and on, else the shuffle's live trial
    tracker, else the ``job=`` labels of the aggregate. Empty: no jobs."""
    svc = sys.modules.get(f"{_PKG}.runtime.service")
    if svc is not None:
        try:
            if svc.enabled():
                return sorted(str(rec.get("job_id")) for rec in svc.jobs_snapshot()
                              if rec.get("job_id") and svc._record_live(rec))
        except Exception:
            pass
    shuffle_mod = sys.modules.get(f"{_PKG}.shuffle")
    if shuffle_mod is not None:
        try:
            jobs = shuffle_mod.live_status().get("jobs") or {}
            ids = sorted(j for j, st in jobs.items() if st.get("running") and j != "_default")
            if ids:
                return ids
        except Exception:
            pass
    ids = set()
    for key, value in flat.items():
        base, labels, _suffix = _split_key(key)
        if base.startswith("alert."):
            continue  # our own job-labelled gauges must not keep a job alive
        jid = labels.get("job")
        if jid and "source" not in labels and value:
            ids.add(jid)
    return sorted(ids)


def _condition(rule: Dict[str, Any], flat: Optional[Dict[str, float]], now: float,
               job: Optional[str] = None) -> Tuple[Optional[bool], Optional[float]]:
    """``(condition, value)`` of one instance; a condition of None is
    unknown (no data), which never fires a threshold or rate rule."""
    kind = str(rule.get("kind", "threshold"))
    if job is not None:
        metric = str(rule.get("per_job_metric") or rule.get("metric", ""))
    else:
        metric = str(rule.get("metric", ""))
    op = _OPS.get(str(rule.get("op", ">")))
    target = float(rule.get("value", 0.0))
    if kind == "absence":
        window_s = rule.get("window_s")
        value = _aggregate_value(metric, flat, job=job)
        if value is None:
            return True, None
        if window_s and not _metric_fresh_in_ring(metric, float(window_s), now=now, job=job):
            return True, value
        return False, value
    if op is None or not metric:
        return None, None
    if kind == "rate":
        rate = _window_rate(metric, float(rule.get("window_s", 60.0)), now=now, fold=str(rule.get("fold", "sum")),
                            job=job, field=str(rule.get("field", "rate")))
        if rate is None:
            return None, None
        return op(rate, target), rate
    value = _aggregate_value(metric, flat, job=job)
    if value is None:
        return None, None
    return op(value, target), value


# -- the state machine ----------------------------------------------------------


def _rule_row(rule: Dict[str, Any], state: Dict[str, Any]) -> Dict[str, Any]:
    """One ``/alerts`` row, the same from :func:`evaluate` and
    :func:`alerts_body`."""
    job = state.get("job")
    metric = rule.get("metric")
    if job is not None:
        metric = rule.get("per_job_metric") or metric
    return {
        "name": str(rule["name"]),
        "kind": rule.get("kind", "threshold"),
        "metric": metric,
        "job": job,
        "op": rule.get("op"),
        "threshold": rule.get("value"),
        "severity": rule.get("severity", "warn"),
        "state": state.get("state", "ok"),
        "active": state.get("state") == "firing",
        "value": state.get("value"),
        "since": state.get("since"),
        "fired_ts": state.get("fired_ts"),
        "resolved_ts": state.get("resolved_ts"),
        "fired_count": state.get("fired_count", 0),
    }


def _active_name(row: Dict[str, Any]) -> str:
    """The rule's name in the ``active`` list, ``rule|job`` for a per-job
    instance."""
    job = row.get("job")
    return f"{row['name']}|{job}" if job else str(row["name"])


def _emit(kind: str, rule: Dict[str, Any], state: Dict[str, Any]) -> None:
    try:
        from ray_shuffling_data_loader_tpu_torch import telemetry as _t

        metric = rule.get("metric")
        extra: Dict[str, Any] = {}
        if state.get("job"):
            extra["job"] = state["job"]
            metric = rule.get("per_job_metric") or metric
        _t.emit_event(kind, _flush=True, rule=rule["name"], severity=rule.get("severity", "warn"), metric=metric,
                      value=state.get("value"), threshold=rule.get("value"), **extra)
    except Exception:
        pass


def evaluate(now: Optional[float] = None) -> Dict[str, Any]:
    """One tick: every rule (a ``per_job`` one per live job) against the
    aggregate and the ring, each instance's ok -> pending -> firing ->
    resolved step, its events and gauges. Returns the ``/alerts`` body.
    Never raises."""
    now = time.time() if now is None else float(now)
    try:
        flat = _export.aggregate(per_source=True)
    except Exception:
        flat = {}
    in_flight = _trial_in_flight()
    jobs = _live_job_ids(flat)
    reg = _metrics.registry if _metrics.enabled() else None
    rows: List[Dict[str, Any]] = []
    seen_keys = set()
    for rule in rules():
        name = str(rule["name"])
        if rule.get("per_job") and jobs:
            instances: List[Tuple[str, Optional[str]]] = [(f"{name}|{j}", j) for j in jobs]
        else:
            instances = [(name, None)]
        for skey, job in instances:
            seen_keys.add(skey)
            with _lock:
                state = _states.setdefault(skey, {"state": "ok", "since": None, "fired_count": 0})
                if job is not None:
                    state["job"] = job
            try:
                if rule.get("only_in_flight") and not (in_flight if job is None else _trial_in_flight(job)):
                    cond, value = False, None
                else:
                    cond, value = _condition(rule, flat, now, job=job)
            except Exception:
                cond, value = None, None
            labels = {"rule": name}
            if job is not None:
                labels["job"] = job
            with _lock:
                state["value"] = value
                for_s = float(rule.get("for_s", 0.0))
                st = state["state"]
                if cond:
                    if st == "ok":
                        state["state"] = "pending"
                        state["since"] = now
                        st = "pending"
                    if st == "pending" and now - state["since"] >= for_s:
                        state["state"] = "firing"
                        state["fired_ts"] = now
                        state["fired_count"] += 1
                        _fired_totals[skey] = _fired_totals.get(skey, 0) + 1
                        entry = {"ts": now, "rule": name, "event": "fired", "value": value}
                        if job is not None:
                            entry["job"] = job
                        _history.append(entry)
                        del _history[:-_HISTORY_CAP]
                        _emit("alert.fired", rule, state)
                        if reg is not None:
                            reg.counter("alert.fired_total", **labels).inc()
                elif st == "firing":
                    state["state"] = "ok"
                    state["since"] = None
                    state["resolved_ts"] = now
                    entry = {"ts": now, "rule": name, "event": "resolved", "value": value}
                    if job is not None:
                        entry["job"] = job
                    _history.append(entry)
                    del _history[:-_HISTORY_CAP]
                    _emit("alert.resolved", rule, state)
                elif st == "pending":
                    state["state"] = "ok"
                    state["since"] = None
                if reg is not None:
                    reg.gauge("alert.active", **labels).set(1.0 if state["state"] == "firing" else 0.0)
                rows.append(_rule_row(rule, state))
    _drop_stale_instances(seen_keys, now, reg)
    with _lock:
        history = list(_history)
    return {
        "ts": now,
        "trial_in_flight": in_flight,
        "jobs": jobs,
        "rules": rows,
        "active": [_active_name(r) for r in rows if r["active"]],
        "history": history,
    }


def _drop_stale_instances(seen_keys, now, reg) -> None:
    """Retire the instances this tick did not evaluate (a job that left
    the live set, a global instance that per-job ones replaced). A firing
    one resolves on its way out; its lifetime count stays."""
    with _lock:
        stale = [(k, _states.pop(k)) for k in list(_states) if k not in seen_keys]
    by_name = {str(r["name"]): r for r in rules()}
    for key, state in stale:
        rname = key.split("|", 1)[0]
        labels = {"rule": rname}
        if state.get("job"):
            labels["job"] = state["job"]
        if state.get("state") == "firing":
            state["state"] = "ok"
            state["resolved_ts"] = now
            entry = {"ts": now, "rule": rname, "event": "resolved", "value": state.get("value")}
            if state.get("job"):
                entry["job"] = state["job"]
            with _lock:
                _history.append(entry)
                del _history[:-_HISTORY_CAP]
            _emit("alert.resolved", by_name.get(rname, {"name": rname}), state)
        if reg is not None:
            try:
                reg.gauge("alert.active", **labels).set(0.0)
            except Exception:
                pass


def alerts_body() -> Dict[str, Any]:
    """The ``/alerts`` page: the last evaluated state, without evaluating
    (the tick sets the cadence); one evaluation if there was none yet."""
    with _lock:
        evaluated = bool(_states)
        history = list(_history)
    if not evaluated:
        return evaluate()
    rows: List[Dict[str, Any]] = []
    for rule in rules():
        name = str(rule["name"])
        with _lock:
            keys = sorted(k for k in _states if k == name or k.startswith(name + "|")) or [name]
            states = [dict(_states.get(k) or {}) for k in keys]
        for state in states:
            rows.append(_rule_row(rule, state))
    return {
        "ts": time.time(),
        "rules": rows,
        "active": [_active_name(r) for r in rows if r["active"]],
        "history": history,
    }


def fired_counts() -> Dict[str, int]:
    """``{rule or rule|job: times fired}`` over the engine's life: what the
    run ledger records."""
    with _lock:
        return {key: int(n) for key, n in _fired_totals.items() if n}


def active_alerts_by_job() -> Dict[str, List[str]]:
    """``{job_id: [firing rules]}`` of the per-job instances (``/jobs``)."""
    out: Dict[str, List[str]] = {}
    with _lock:
        for key, state in _states.items():
            job = state.get("job")
            if job and state.get("state") == "firing":
                out.setdefault(job, []).append(key.split("|", 1)[0])
    return {job: sorted(names) for job, names in out.items()}


def status_section() -> Dict[str, Any]:
    """The part of ``/alerts`` that ``/status`` embeds."""
    body = alerts_body()
    return {"active": body["active"], "fired_counts": fired_counts(), "rules": len(body["rules"])}
