"""The run ledger: one NDJSON record per finished run.

The session's planes (the metrics ring, the event spool) live under the
runtime directory and go with it. The question they cannot answer is
the one asked a week later: did last night's run regress against
Tuesday's? At the end of every ``shuffle()`` run (done, failed or
suspended) one self-contained JSON record is appended to an NDJSON file
under ``flock`` and ``fsync``:

* **identity**: run id, kind, host and pid, and the job (id and name)
  when one is set;
* **configuration**: the resolved plan and every ``RSDL_*`` knob set in
  the environment (from the knob registry,
  :mod:`..analysis.knob_registry`), overlaid with the plan compiler's
  effective values and terms;
* **outcome**: status, duration, error, throughput, and the epoch walls
  from the event log;
* **diagnosis**: stalls by cause, the critical path, the audit's
  verdicts, the capacity section, the SLO alerts that fired, and the
  profiler's digest.

Each section is read through ``sys.modules`` from the planes that are
armed: a run with the ledger on and metrics off records identity and
outcome only.

**Gate:** ``RSDL_RUN_LEDGER``. Unset, ``0``, ``off``, ``false`` or ``no``
leave it dark, and the module is never imported (``shuffle()`` checks
the variable first). ``1``, ``on``, ``true`` or ``auto`` append to
``$RSDL_RUNTIME_DIR/runs/ledger.ndjson`` (which goes with the session);
any other value is the path of a ledger that outlives it.

The record is the JAX package's, letter for letter. Standard library
only.
"""

from __future__ import annotations

import json
import os
import socket
import sys
import time
from typing import Any, Dict, List, Optional

ENV_LEDGER = "RSDL_RUN_LEDGER"
_RUNTIME_DIR_ENV = "RSDL_RUNTIME_DIR"
_OFF_VALUES = ("", "0", "off", "false", "no")
_AUTO_VALUES = ("1", "on", "true", "auto")


def enabled() -> bool:
    """One env check; no caching — the knob is read at run end, not in
    any hot loop."""
    return (os.environ.get(ENV_LEDGER) or "").strip().lower() \
        not in _OFF_VALUES


def ledger_path() -> Optional[str]:
    """Where records land: an *auto* value resolves under the runtime
    directory (session-scoped!); any other value is the explicit,
    durable path."""
    raw = (os.environ.get(ENV_LEDGER) or "").strip()
    if raw.lower() in _OFF_VALUES:
        return None
    if raw.lower() in _AUTO_VALUES:
        runtime_dir = os.environ.get(_RUNTIME_DIR_ENV) or _session_dir()
        base = runtime_dir if runtime_dir else "."
        return os.path.join(base, "runs", "ledger.ndjson")
    return raw


def _session_dir() -> Optional[str]:
    """The live session's runtime directory, through ``sys.modules``: the
    port's session owner does not export ``RSDL_RUNTIME_DIR``."""
    runtime = _module("runtime")
    try:
        if runtime is not None and runtime.is_initialized():
            return runtime.get_context().runtime_dir
    except Exception:
        pass
    return None


def _module(name: str):
    """A plane module only if some caller already armed + imported it:
    the ledger must never be the reason a gated plane loads."""
    return sys.modules.get("ray_shuffling_data_loader_tpu_torch." + name)


def _job_identity(job_id: Optional[str] = None) -> Optional[Dict[str, Any]]:
    svc = _module("runtime.service")
    if svc is not None:
        try:
            if svc.enabled():
                job = svc.current_job()
                if job is not None:
                    return {"id": str(job.job_id), "name": str(job.name)}
        except Exception:
            pass
    if job_id is not None:
        return {"id": str(job_id), "name": None}
    env_job = os.environ.get("RSDL_JOB_ID")
    if env_job:
        return {"id": env_job, "name": None}
    return None


def _knob_snapshot() -> Dict[str, str]:
    """Every registry-declared RSDL_* knob present in the environment
    (prefix families included), overlaid with the plan compiler's
    effective values for the knobs the environment left unset (so two
    runs with one environment and different plans differ here). Values
    set in the environment win: they are the operator's pins. Values are
    clipped: the ledger is a record, not a config store."""
    out: Dict[str, str] = {}
    try:
        from ray_shuffling_data_loader_tpu_torch.analysis.knob_registry import (
            KNOBS,
        )
    except Exception:
        return out
    env = os.environ
    for knob in KNOBS:
        if knob.prefix:
            for key in env:
                if key.startswith(knob.name):
                    out[key] = str(env[key])[:200]
        elif knob.name in env:
            out[knob.name] = str(env[knob.name])[:200]
    # Honesty about the gate itself even though it is what got us here.
    if ENV_LEDGER in env and ENV_LEDGER not in out:
        out[ENV_LEDGER] = str(env[ENV_LEDGER])[:200]
    planmod = _module("runtime.plan")
    if planmod is not None:
        try:
            for knob_name, value in planmod.effective_env().items():
                out.setdefault(knob_name, str(value)[:200])
        except Exception:
            pass
    return dict(sorted(out.items()))


def _flat_metrics() -> Dict[str, Any]:
    metrics = _module("telemetry.metrics")
    if metrics is None or not metrics.enabled():
        return {}
    try:
        from ray_shuffling_data_loader_tpu_torch.telemetry import export as _export

        return _export.aggregate()
    except Exception:
        return {}


def _labeled_sum(flat: Dict[str, Any], name: str, label: str) \
        -> Dict[str, float]:
    """Fold ``name{label=value,...}`` keys into {value: sum}."""
    out: Dict[str, float] = {}
    prefix = name + "{"
    for key, value in flat.items():
        if not key.startswith(prefix):
            continue
        for part in key[len(prefix):-1].split(","):
            k, _, v = part.partition("=")
            if k == label:
                try:
                    out[v] = out.get(v, 0.0) + float(value)
                except (TypeError, ValueError):
                    pass
    return out


def _throughput(flat: Dict[str, Any], duration_s: Optional[float]) \
        -> Dict[str, Any]:
    delivered = 0.0
    for key, value in flat.items():
        if key == "service.delivered_bytes" \
                or key.startswith("service.delivered_bytes{"):
            try:
                delivered += float(value)
            except (TypeError, ValueError):
                pass
    out: Dict[str, Any] = {}
    if delivered:
        out["delivered_bytes"] = int(delivered)
        if duration_s:
            out["bytes_per_s"] = round(delivered / duration_s, 1)
    return out


def _epoch_walls() -> List[Dict[str, Any]]:
    """Per-epoch wall seconds from the event log (epoch.start →
    epoch.done/epoch.failed pairs)."""
    events = _module("telemetry.events")
    if events is None or not events.enabled():
        return []
    try:
        starts: Dict[int, float] = {}
        rows: Dict[int, Dict[str, Any]] = {}
        for rec in events.load():
            kind = rec.get("kind")
            if kind not in ("epoch.start", "epoch.done", "epoch.failed"):
                continue
            try:
                epoch = int(rec.get("epoch"))
                ts = float(rec.get("ts"))
            except (TypeError, ValueError):
                continue
            if kind == "epoch.start":
                starts[epoch] = ts
            elif epoch in starts:
                rows[epoch] = {
                    "epoch": epoch,
                    "wall_s": round(ts - starts[epoch], 3),
                    "state": "done" if kind == "epoch.done" else "failed",
                }
        return [rows[e] for e in sorted(rows)]
    except Exception:
        return []


def _critical_section() -> Dict[str, Any]:
    critical = _module("telemetry.critical")
    if critical is None:
        return {}
    try:
        analysis = critical.analyze()
        return {
            "run_critical_path": analysis.get("run_critical_path"),
            "epochs": [
                {
                    "epoch": row.get("epoch"),
                    "critical_path": row.get("critical_path"),
                }
                for row in (analysis.get("epochs") or [])
            ],
        }
    except Exception:
        return {}


def _capacity_section() -> Dict[str, Any]:
    capacity = _module("telemetry.capacity")
    if capacity is None:
        return {}
    try:
        full = capacity.view()
        totals = full.get("totals") or {}
        out: Dict[str, Any] = {}
        if full.get("shm_used_frac") is not None:
            out["shm_used_frac"] = full["shm_used_frac"]
        try:
            out["shm_resident_bytes"] = capacity.shm_resident_bytes(totals)
        except Exception:
            pass
        spill = (totals.get("tiers") or {}).get("spill")
        if isinstance(spill, dict) and spill.get("resident_bytes"):
            out["spill_bytes"] = spill["resident_bytes"]
        # An all-zero snapshot (module imported but ledger empty) carries
        # no signal — degrade to absent like every other dark section.
        if not any(out.values()):
            return {}
        return out
    except Exception:
        return {}


def _alerts_section() -> Dict[str, int]:
    slo = _module("telemetry.slo")
    if slo is None:
        return {}
    try:
        return {k: v for k, v in slo.fired_counts().items() if v}
    except Exception:
        return {}


def _run_shape(job_id: Optional[str]) -> Dict[str, Any]:
    """Trial shape (epochs/files/reducers/trainers) from the live
    tracker — present whenever the record is written from the driver
    that ran the trial."""
    shuffle_mod = _module("shuffle")
    if shuffle_mod is None:
        return {}
    try:
        status = shuffle_mod.live_status()
        entry = None
        jobs = status.get("jobs")
        if job_id is not None and isinstance(jobs, dict):
            entry = jobs.get(job_id)
        if entry is None:
            entry = status
        out = {}
        for key in ("num_epochs", "num_files", "num_reducers",
                    "num_trainers", "start_epoch"):
            if entry.get(key) is not None:
                out[key] = entry[key]
        return out
    except Exception:
        return {}


def _profile_section() -> Optional[Dict[str, Any]]:
    """The profiler's digest: the top frames by self time with their
    stages, which names the frame a regression moved into. sys.modules
    only, like every section: a run that never profiled does not import
    the plane here."""
    profiler = _module("telemetry.profiler")
    if profiler is None:
        return None
    try:
        return profiler.digest()
    except Exception:
        return None


def build_record(
    status: str,
    *,
    kind: str = "shuffle",
    duration_s: Optional[float] = None,
    error: Optional[str] = None,
    plan_label: Optional[str] = None,
    job_id: Optional[str] = None,
    audit_verdicts: Optional[List[dict]] = None,
    extra: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """One self-contained ledger record; every telemetry-derived
    section degrades to absent when its plane is dark."""
    ts = time.time()
    job = _job_identity(job_id)
    flat = _flat_metrics()
    rec: Dict[str, Any] = {
        "id": f"run-{int(ts * 1000):x}-{os.getpid()}",
        "ts": round(ts, 3),
        "kind": kind,
        "status": status,
        "host": socket.gethostname(),
        "pid": os.getpid(),
    }
    if duration_s is not None:
        rec["duration_s"] = round(float(duration_s), 3)
    if error:
        rec["error"] = str(error)[:300]
    if job:
        rec["job"] = job
    if plan_label:
        rec["plan"] = plan_label
    shape = _run_shape(job["id"] if job else None)
    if shape:
        rec["run"] = shape
    knobs = _knob_snapshot()
    if knobs:
        rec["knobs"] = knobs
    planmod = _module("runtime.plan")
    if planmod is not None:
        # The plan compiler's per-term decisions: value, source (env,
        # planned or replanned) and the cost model's reason.
        try:
            plan_terms = planmod.current_terms()
            if plan_terms:
                rec["plan_terms"] = plan_terms
        except Exception:
            pass
    throughput = _throughput(flat, duration_s)
    if throughput:
        rec["throughput"] = throughput
    stalls = _labeled_sum(flat, "stall_seconds", "cause")
    if stalls:
        rec["stall_by_cause"] = {
            k: round(v, 3) for k, v in sorted(stalls.items())
        }
    epochs = _epoch_walls()
    if epochs:
        rec["epochs"] = epochs
    crit = _critical_section()
    if crit.get("run_critical_path") or crit.get("epochs"):
        rec["critical"] = crit
    if audit_verdicts is not None:
        rec["audit"] = {
            "ok": all(bool(v.get("ok")) for v in audit_verdicts),
            "verdicts": audit_verdicts,
        }
    cap = _capacity_section()
    if cap:
        rec["capacity"] = cap
    alerts = _alerts_section()
    if alerts:
        rec["alerts_fired"] = alerts
    profile = _profile_section()
    if profile:
        rec["profile"] = profile
    if extra:
        rec.update(extra)
    return rec


def append_record(record: Dict[str, Any]) -> Optional[str]:
    """Append one record (flock + fsync: concurrent drivers sharing an
    explicit ledger path interleave whole lines, and a record that
    ``append_record`` returned for survives the process dying next
    instruction). Returns the record id, or None when the plane is
    off."""
    path = ledger_path()
    if path is None:
        return None
    record = dict(record)
    record.setdefault(
        "id", f"run-{int(time.time() * 1000):x}-{os.getpid()}"
    )
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    line = json.dumps(record, default=str) + "\n"
    with open(path, "a") as f:
        try:
            import fcntl

            fcntl.flock(f.fileno(), fcntl.LOCK_EX)
        except Exception:
            pass
        try:
            f.write(line)
            f.flush()
            os.fsync(f.fileno())
        finally:
            try:
                import fcntl

                fcntl.flock(f.fileno(), fcntl.LOCK_UN)
            except Exception:
                pass
    return record["id"]


def record_run(status: str, **kwargs: Any) -> Optional[str]:
    """Build + append, swallowing everything: the ledger must never
    change a run's outcome (it sits on failure paths too)."""
    if not enabled():
        return None
    try:
        return append_record(build_record(status, **kwargs))
    except Exception:
        return None


def read(path: Optional[str] = None) -> List[Dict[str, Any]]:
    """Every record in the ledger, in append order; torn trailing
    lines (a crash mid-write on a non-flock filesystem) are skipped."""
    path = path if path is not None else ledger_path()
    out: List[Dict[str, Any]] = []
    if not path or not os.path.exists(path):
        return out
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if isinstance(rec, dict) and "id" in rec:
                out.append(rec)
    return out
