"""The live observability endpoint, on ``RSDL_OBS_PORT``.

One standard-library ``http.server`` on a daemon thread of the session's
owner, so that a running shuffle can be watched. With the variable unset
this module is not imported and no thread or socket exists: the runtime
reads it once, at the session's start.

Routes (``GET``):

* ``/metrics``: the aggregated registry (every process's spool and this
  process's registry, merged per kind by :mod:`.export`) as Prometheus
  text, with a per-source breakdown, and the server's own block:
  ``rsdl_up``, ``rsdl_obs_build_info`` (version, python, platform,
  session), ``rsdl_obs_uptime_seconds`` and
  ``rsdl_obs_scrape_duration_seconds``;
* ``/healthz``: liveness: the spool's sources (age, stale), the epoch
  window from the status providers and, with the relay loaded, its
  section (:mod:`.relay`);
* ``/`` and ``/status``: the operator's view: the providers' snapshots
  (the shuffle's live trial, the batch queue's window), the queue depths,
  the store, the ``recovery.*`` counters, the audit's latest verdicts, the
  stragglers, the events by kind, capacity, the critical path, the alerts,
  the cluster's membership and the jobs;
* ``/timeseries?name=&window=&step=&sources=&job=``: the time series' ring
  (:mod:`.timeseries`);
* ``/events?since=&kind=&limit=&job=``: the event log (:mod:`.events`);
* ``/stragglers``, ``/capacity``, ``/critical``, ``/alerts``: the views of
  :mod:`.stragglers`, :mod:`.capacity`, :mod:`.critical` and :mod:`.slo`;
* ``/profile?stage=&job=&epoch=&top=&collapsed=`` and ``/profile/flame``:
  the merged profiles (:mod:`.profiler`), as JSON, folded text or a
  flame graph page;
* ``/jobs``: one row per job, from the service's registry when that module
  is loaded, the live trial tracker, the ``job=`` series and the SLO
  engine's per-job instances.

A subsystem publishes its live state with
``register_status_provider(name, fn)``: ``fn() -> dict`` is called per
request, and one that raises shows its error in place of its snapshot.

``RSDL_OBS_HOST``: the bind address (default ``127.0.0.1``).
``RSDL_OBS_STALE_S``: leave out of ``/metrics`` and ``/status`` the
sources silent for longer (default: keep every source).
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from typing import Any, Callable, Dict, Optional

from ray_shuffling_data_loader_tpu_torch.telemetry import capacity as _capacity
from ray_shuffling_data_loader_tpu_torch.telemetry import critical as _critical
from ray_shuffling_data_loader_tpu_torch.telemetry import events as _events
from ray_shuffling_data_loader_tpu_torch.telemetry import export as _export
from ray_shuffling_data_loader_tpu_torch.telemetry import metrics as _metrics
from ray_shuffling_data_loader_tpu_torch.telemetry import slo as _slo
from ray_shuffling_data_loader_tpu_torch.telemetry import stragglers as _stragglers
from ray_shuffling_data_loader_tpu_torch.telemetry import timeseries as _timeseries

ENV_OBS_PORT = "RSDL_OBS_PORT"
ENV_OBS_HOST = "RSDL_OBS_HOST"
ENV_OBS_STALE_S = "RSDL_OBS_STALE_S"
_PKG = "ray_shuffling_data_loader_tpu_torch"

# A source silent this long is flagged stale on /healthz (flagged, not
# dropped: an idle worker flushes only at task boundaries).
_STALE_FLAG_S = 60.0

_lock = threading.Lock()
_server = None
_thread: Optional[threading.Thread] = None
_port: Optional[int] = None
_started_ts: Optional[float] = None

_providers: Dict[str, Callable[[], dict]] = {}
_providers_lock = threading.Lock()


def register_status_provider(name: str, fn: Callable[[], dict]) -> None:
    """Register (or replace) ``fn() -> dict``, served in ``/status`` under
    ``providers.<name>``, whether or not a server runs."""
    with _providers_lock:
        _providers[name] = fn


def unregister_status_provider(name: str) -> None:
    with _providers_lock:
        _providers.pop(name, None)


def _error(exc: BaseException) -> Dict[str, str]:
    return {"error": f"{type(exc).__name__}: {exc}"[:200]}


def _provider_snapshots() -> Dict[str, dict]:
    with _providers_lock:
        providers = list(_providers.items())
    out: Dict[str, dict] = {}
    for name, fn in providers:
        try:
            out[name] = fn()
        except Exception as exc:  # a broken provider must not fail the page
            out[name] = _error(exc)
    return out


def configured_port() -> Optional[int]:
    """``RSDL_OBS_PORT`` as a port, or None (unset, empty, not a number,
    or not positive)."""
    raw = os.environ.get(ENV_OBS_PORT, "").strip()
    if not raw:
        return None
    try:
        port = int(raw)
    except ValueError:
        return None
    return port if port > 0 else None


def running() -> bool:
    return _server is not None


def port() -> Optional[int]:
    """The bound port while running (``start(0)`` binds any)."""
    return _port


def _stale_cutoff() -> Optional[float]:
    raw = os.environ.get(ENV_OBS_STALE_S, "").strip()
    if not raw:
        return None
    try:
        value = float(raw)
    except ValueError:
        return None
    return value if value > 0 else None


# -- the pages -----------------------------------------------------------------


def _metrics_text() -> str:
    return _export.prometheus_text(max_age_s=_stale_cutoff())


def _self_metrics_text(scrape_s: float) -> str:
    """The server's own block, after every ``/metrics``: ``rsdl_up 1``
    (its absence is the alert), the build and session, the uptime and this
    scrape's seconds. Written here, not through the registry, so a server
    with metrics off reports itself too; with metrics on the scrape time
    also goes into ``obs.scrape_seconds``, which the time series keeps."""
    import platform as _platform

    if _metrics.enabled():
        try:
            _metrics.registry.histogram("obs.scrape_seconds").observe(scrape_s)
        except Exception:
            pass
    try:
        from ray_shuffling_data_loader_tpu_torch import __version__ as _version
    except Exception:
        _version = "unknown"
    session = ""
    runtime = sys.modules.get(f"{_PKG}.runtime")
    try:
        if runtime is not None and runtime.is_initialized():
            session = runtime.get_context().session
    except Exception:
        pass
    python = "%d.%d.%d" % sys.version_info[:3]
    uptime = round(time.time() - (_started_ts or time.time()), 1)
    return (
        "# TYPE rsdl_up gauge\n"
        "rsdl_up 1\n"
        "# TYPE rsdl_obs_build_info gauge\n"
        f'rsdl_obs_build_info{{version="{_version}",python="{python}",'
        f'platform="{_platform.system()}",session="{session}"}} 1\n'
        "# TYPE rsdl_obs_uptime_seconds gauge\n"
        f"rsdl_obs_uptime_seconds {uptime}\n"
        "# TYPE rsdl_obs_scrape_duration_seconds gauge\n"
        f"rsdl_obs_scrape_duration_seconds {scrape_s:.6f}\n"
    )


def _source_health() -> list:
    now = time.time()
    out = []
    for rec in _export.load_records():
        src = rec.get("source") or {}
        age = now - float(rec.get("ts", 0.0))
        out.append({"role": src.get("role"), "host": src.get("host"), "pid": src.get("pid"), "age_s": round(age, 1),
                    "stale": age > _STALE_FLAG_S})
    return out


def _in_flight_epochs(providers: Dict[str, dict]) -> list:
    """The union of the providers' epoch windows (the shuffle's and the
    queue's)."""
    epochs = set()
    for snap in providers.values():
        for e in snap.get("in_flight_epochs") or []:
            try:
                epochs.add(int(e))
            except (TypeError, ValueError):
                pass
    return sorted(epochs)


def _healthz_body() -> dict:
    providers = _provider_snapshots()
    shuffle_snap = providers.get("shuffle") or {}
    queue_snap = providers.get("batch_queue") or {}
    body = {
        "ok": True,
        "pid": os.getpid(),
        "uptime_s": round(time.time() - (_started_ts or time.time()), 1),
        "metrics_enabled": _metrics.enabled(),
        "sources": _source_health(),
        "providers": sorted(providers),
        "epoch_window": {"in_flight_epochs": _in_flight_epochs(providers),
                         "trial_running": shuffle_snap.get("running")},
        "producer_alive": queue_snap.get("producer_alive"),
    }
    # The relay's freshness, through sys.modules: a session that never
    # relayed does not load it to report its absence.
    relay_mod = sys.modules.get(f"{_PKG}.telemetry.relay")
    if relay_mod is not None:
        try:
            body["relay"] = relay_mod.status_section()
        except Exception as exc:
            body["relay"] = {"error": f"{type(exc).__name__}: {exc}"}
    return body


def _status_body() -> dict:
    providers = _provider_snapshots()
    flat = _export.aggregate(max_age_s=_stale_cutoff())
    status: Dict[str, Any] = {
        "ts": time.time(),
        "in_flight_epochs": _in_flight_epochs(providers),
        "providers": providers,
        "queue_depths": {k: v for k, v in flat.items() if k.startswith("queue.depth")},
        "recovery": {k: v for k, v in flat.items() if k.startswith("recovery.")},
    }
    # The store: this process's session's, else the sampler's gauges.
    runtime = sys.modules.get(f"{_PKG}.runtime")
    try:
        if runtime is not None and runtime.is_initialized():
            s = runtime.store_stats()
            status["store"] = {"objects": s.num_objects, "total_bytes": s.total_bytes, "spill_bytes": s.spill_bytes}
    except Exception:
        pass
    if "store" not in status:
        status["store"] = {"shm_bytes": flat.get("store.shm_bytes"), "spill_bytes": flat.get("store.spill_bytes"),
                           "objects": flat.get("store.objects")}
    try:
        from ray_shuffling_data_loader_tpu_torch.telemetry import audit as _audit

        verdicts = _audit.verdicts()
        if verdicts:
            known = [v["ok"] for v in verdicts if v.get("ok") is not None]
            status["audit"] = {"ok": all(known) if known else None, "verdicts": verdicts[-8:]}
    except Exception:
        pass
    try:
        status["stragglers"] = _stragglers.status_section()
    except Exception as exc:
        status["stragglers"] = _error(exc)
    try:
        records = _events.load()  # one read of the spool serves both
        status["events"] = {"by_kind": _events.counts(records), "latest": records[-8:]}
    except Exception as exc:
        status["events"] = _error(exc)
    for name, fn in (("capacity", _capacity.status_section), ("critical", _critical.status_section),
                     ("alerts", _slo.status_section)):
        try:
            status[name] = fn()
        except Exception as exc:
            status[name] = _error(exc)
    # The membership, through sys.modules: a one-host server does not load
    # the cluster plane.
    cluster_mod = sys.modules.get(f"{_PKG}.runtime.cluster")
    if cluster_mod is not None:
        try:
            status["cluster"] = cluster_mod.membership_section()
        except Exception as exc:
            status["cluster"] = _error(exc)
    else:
        status["cluster"] = {"agents": [], "draining": [], "retired": []}
    try:
        fleet_jobs = _jobs_body()["jobs"]
        status["fleet"] = {
            "jobs": len(fleet_jobs),
            "running": [{"job_id": row.get("job_id"), "name": row.get("name"),
                         "in_flight_epochs": row.get("in_flight_epochs"), "active_alerts": row.get("active_alerts")}
                        for row in fleet_jobs if row.get("running")],
        }
    except Exception as exc:
        status["fleet"] = _error(exc)
    return status


def _key_labels(key: str) -> Dict[str, str]:
    """The labels of a flat key (``name{k=v,...}``, ``name{k=v}_count``)."""
    brace = key.find("{")
    if brace < 0:
        return {}
    close = key.rfind("}")
    if close < brace:
        return {}
    out: Dict[str, str] = {}
    for part in key[brace + 1:close].split(","):
        k, _, v = part.partition("=")
        if k:
            out[k] = v
    return out


def _base_of(key: str) -> str:
    brace = key.find("{")
    return key if brace < 0 else key[:brace]


def _jobs_body() -> dict:
    """``/jobs``: a row a job, from the service's registry (when that
    module is loaded and on), the live trial tracker, the aggregate's
    ``job=`` series and the SLO engine's per-job instances."""
    providers = _provider_snapshots()
    flat = _export.aggregate(max_age_s=_stale_cutoff())
    jobs: Dict[str, Dict[str, Any]] = {}

    def entry(jid: str) -> Dict[str, Any]:
        return jobs.setdefault(jid, {"job_id": jid})

    service_mode = None
    svc = sys.modules.get(f"{_PKG}.runtime.service")
    if svc is not None:
        try:
            if svc.enabled():
                service_mode = svc.mode()
                claims = svc.job_cache_claims()
                for rec in svc.jobs_snapshot():
                    jid = str(rec.get("job_id"))
                    row = entry(jid)
                    row["name"] = rec.get("name")
                    row["weight"] = rec.get("weight")
                    row["pid"] = rec.get("pid")
                    row["created_ts"] = rec.get("created_ts")
                    row["running"] = bool(svc._record_live(rec))
                    row["cache_claims"] = claims.get(jid, 0)
        except Exception:
            pass
    # The trial tracker; with no service, its one job is "_default".
    shuffle_snap = providers.get("shuffle") or {}
    tracked = shuffle_snap.get("jobs")
    if not tracked and shuffle_snap.get("epochs") is not None:
        tracked = {"_default": shuffle_snap}
    for jid, snap in (tracked or {}).items():
        row = entry(str(jid))
        row.setdefault("running", bool(snap.get("running")))
        for field in ("num_epochs", "num_files", "num_reducers", "num_trainers", "start_epoch", "started_ts",
                      "ended_ts", "error"):
            if snap.get(field) is not None:
                row[field] = snap[field]
        epochs = snap.get("epochs") or {}
        row["in_flight_epochs"] = snap.get("in_flight_epochs") or []
        row["epochs_done"] = sum(1 for st in epochs.values() if st.get("state") == "done")
    # The job= series: delivered and resident bytes, admission waits, lag.
    for key, value in flat.items():
        labels = _key_labels(key)
        jid = labels.get("job")
        if not jid or "source" in labels:
            continue
        base = _base_of(key)
        row = entry(jid)
        try:
            value = float(value)
        except (TypeError, ValueError):
            continue
        if base == "service.delivered_bytes":
            row["delivered_bytes"] = row.get("delivered_bytes", 0) + int(value)
        elif base == "capacity.job_resident_bytes":
            tier = labels.get("tier")
            tiers = row.setdefault("resident_bytes", {})
            tiers[tier or "all"] = tiers.get(tier or "all", 0) + int(value)
        elif base == "service.dispatch_vtime_lag":
            row["dispatch_vtime_lag"] = value
        elif key.endswith("_count") and base.startswith("service.admission_wait_seconds"):
            row.setdefault("admission", {})["waits"] = int(value)
        elif key.endswith("_sum") and base.startswith("service.admission_wait_seconds"):
            row.setdefault("admission", {})["wait_s"] = round(value, 3)
    # The current delivery rate from the ring (none without a sampler).
    try:
        for key, points in _timeseries.series(name="service.delivered_bytes", include_sources=False).items():
            jid = _key_labels(key).get("job")
            if not jid or not points:
                continue
            rate = points[-1].get("rate")
            if rate is not None:
                entry(jid)["delivered_rate_bps"] = round(float(rate), 1)
    except Exception:
        pass
    try:
        for jid, names in _slo.active_alerts_by_job().items():
            entry(jid)["active_alerts"] = names
    except Exception:
        pass
    for row in jobs.values():
        row.setdefault("active_alerts", [])
        row.setdefault("running", False)
    order = sorted(jobs, key=lambda j: (float(jobs[j].get("created_ts") or jobs[j].get("started_ts") or 0.0), j))
    return {"ts": time.time(), "service_mode": service_mode, "jobs": [jobs[j] for j in order]}


def _qparam(params: Dict[str, list], name: str, cast, default=None):
    """The last value of a query parameter, cast; ``default`` when absent
    or malformed."""
    values = params.get(name)
    if not values or not values[-1]:
        return default
    try:
        return cast(values[-1])
    except (TypeError, ValueError):
        return default


def _timeseries_body(params: Dict[str, list]) -> dict:
    name = _qparam(params, "name", str)
    window_s = _qparam(params, "window", float)
    step_s = _qparam(params, "step", float)
    include_sources = bool(_qparam(params, "sources", int, 0))
    job = _qparam(params, "job", str)
    series = _timeseries.series(name=name, window_s=window_s, step_s=step_s, include_sources=include_sources, job=job)
    return {
        "name": name,
        "job": job,
        "window_s": window_s,
        "step_s": step_s,
        "period_s": _timeseries.period_s(),
        "sampler_running": _timeseries.running(),
        "samples": len(_timeseries.samples()),
        "series": series,
    }


def _events_body(params: Dict[str, list]) -> dict:
    since = _qparam(params, "since", float)
    kind = _qparam(params, "kind", str)
    limit = _qparam(params, "limit", int, 200)
    job = _qparam(params, "job", str)
    records = _events.load(since=since, kind=kind, limit=limit, job=job)
    return {"since": since, "kind": kind, "job": job, "count": len(records), "by_kind": _events.counts(records),
            "events": records}


def _profile_agg(params: Dict[str, list]):
    """The merged profiles; the profiler loads here, not with this module."""
    from ray_shuffling_data_loader_tpu_torch.telemetry import profiler as _prof

    agg = _prof.aggregate_profiles(stage=_qparam(params, "stage", str), job=_qparam(params, "job", str),
                                   epoch=_qparam(params, "epoch", str))
    return _prof, agg


def _profile_body(params: Dict[str, list]) -> dict:
    prof, agg = _profile_agg(params)
    top = _qparam(params, "top", int)
    return {
        "ts": time.time(),
        "stage": _qparam(params, "stage", str),
        "job": _qparam(params, "job", str),
        "epoch": _qparam(params, "epoch", str),
        "sampler_running": prof.running(),
        "hz": prof.hz(),
        "samples": agg["samples"],
        "seconds": round(agg["seconds"], 3),
        "sources": agg["sources"],
        "top": prof.top_table(agg, n=top),
        "collapsed": prof.collapsed_text(agg, tagged=True),
    }


# -- the server -------------------------------------------------------------------

_JSON_PAGES: Dict[str, Callable[[Dict[str, list]], Any]] = {
    "/healthz": lambda params: _healthz_body(),
    "/": lambda params: _status_body(),
    "/status": lambda params: _status_body(),
    "/timeseries": _timeseries_body,
    "/events": _events_body,
    "/stragglers": lambda params: _stragglers.analyze(),
    "/capacity": lambda params: _capacity.view(),
    "/critical": lambda params: _critical.analyze(),
    "/alerts": lambda params: _slo.alerts_body(),
    "/jobs": lambda params: _jobs_body(),
}


def _make_handler():
    from http.server import BaseHTTPRequestHandler

    class _Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # no line per request on stderr
            pass

        def _send(self, code: int, content_type: str, body: bytes) -> None:
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 -- the handler's contract
            from urllib.parse import parse_qs

            path, _, query = self.path.partition("?")
            params = parse_qs(query) if query else {}
            try:
                if path == "/metrics":
                    t0 = time.perf_counter()
                    body = _metrics_text()
                    body += _self_metrics_text(time.perf_counter() - t0)
                    self._send(200, "text/plain; version=0.0.4; charset=utf-8", body.encode())
                elif path in _JSON_PAGES:
                    self._send(200, "application/json", json.dumps(_JSON_PAGES[path](params), default=str).encode())
                elif path == "/profile":
                    if _qparam(params, "collapsed", int, 0):
                        prof, agg = _profile_agg(params)
                        self._send(200, "text/plain; charset=utf-8", prof.collapsed_text(agg, tagged=True).encode())
                    else:
                        self._send(200, "application/json", json.dumps(_profile_body(params), default=str).encode())
                elif path == "/profile/flame":
                    prof, agg = _profile_agg(params)
                    stage = _qparam(params, "stage", str)
                    title = "rsdl profile" + (f" · stage={stage}" if stage else "")
                    self._send(200, "text/html; charset=utf-8", prof.render_flame_html(agg, title=title).encode())
                else:
                    self._send(404, "text/plain", b"not found\n")
            except BrokenPipeError:
                pass
            except Exception as exc:  # the page failed: say so, keep serving
                try:
                    self._send(500, "text/plain", f"{type(exc).__name__}: {exc}\n".encode())
                except Exception:
                    pass

    return _Handler


def start(port_num: Optional[int] = None) -> int:
    """Bind and serve on a daemon thread; returns the bound port (0 binds
    any). A second call while running returns the running server's port."""
    global _server, _thread, _port, _started_ts
    from http.server import ThreadingHTTPServer

    with _lock:
        if _server is not None:
            return _port  # type: ignore[return-value]
        if port_num is None:
            port_num = configured_port()
        if port_num is None:
            raise ValueError(f"no port given and {ENV_OBS_PORT} not set")
        host = os.environ.get(ENV_OBS_HOST, "127.0.0.1")
        server = ThreadingHTTPServer((host, port_num), _make_handler())
        server.daemon_threads = True
        _server = server
        _port = server.server_address[1]
        _started_ts = time.time()
        _thread = threading.Thread(target=server.serve_forever, kwargs={"poll_interval": 0.25},
                                   name="rsdl-obs-server", daemon=True)
        _thread.start()
        return _port


def maybe_start() -> Optional[int]:
    """Start when ``RSDL_OBS_PORT`` names a port and none runs. A port
    that will not bind (two owners on one host under one environment)
    logs a warning and returns None: the session starts all the same."""
    if running():
        return _port
    port_num = configured_port()
    if port_num is None:
        return None
    try:
        return start(port_num)
    except OSError as exc:
        import logging

        logging.getLogger(__name__).warning(
            "obs server: cannot bind %s=%s (%s); endpoint disabled for this process", ENV_OBS_PORT, port_num, exc)
        return None


def stop() -> None:
    """Shut the server down and join its thread. The providers stay
    registered: their subsystems own them."""
    global _server, _thread, _port, _started_ts
    with _lock:
        server, _server = _server, None
        thread, _thread = _thread, None
        _port = None
        _started_ts = None
    if server is not None:
        try:
            server.shutdown()
            server.server_close()
        except Exception:
            pass
    if thread is not None:
        thread.join(timeout=5.0)
