"""The time series of the aggregated metrics registry.

The metrics spools give cumulative values at one moment. This module
keeps their history: a sampler thread on the session's owner takes the
aggregated registry (:func:`.export.aggregate_typed`, per-source keys
included) every period into a fixed-size **ring**, with a view per kind:

* **counters** become *rates*, ``(cur - prev) / dt``; a decrease (a
  source restarted: a new pid, a cleared spool) counts as a restart from
  zero (``delta = cur``), as Prometheus ``rate()`` does, so no rate is
  ever negative;
* **gauges** keep their value at each sample;
* **histograms** keep their cumulative count, sum, min and max, and over
  each step the observation rate (``dcount / dt``) and the windowed
  mean (``dsum / dcount``).

Samples also append to ``<metrics spool>/ts/timeseries.ndjson``, so the
history outlives the sampler; :func:`load_persisted` reads it back and
:func:`series` queries the ring by name, window, step and job.

Each tick first refreshes the derived gauges of :mod:`.stragglers`,
:mod:`.capacity` and :mod:`.critical`, then samples.

Lifecycle: the session's owner starts the sampler when it starts up
with metrics on and ``RSDL_OBS_PORT`` set, or ``RSDL_TS=1``
(``runtime/__init__.py``), and stops it at shutdown. Off, there is no
thread, no file, and this module is never imported.

Knobs: ``RSDL_TS_PERIOD_S`` (the period, default 2 s, at least 0.1),
``RSDL_TS_SAMPLES`` (the ring's size, default 900: 30 min at 2 s).

Samples, rates and queries are the JAX package's, letter for letter.
Standard library only.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from typing import Any, Dict, List, Optional

from ray_shuffling_data_loader_tpu_torch.telemetry import export as _export
from ray_shuffling_data_loader_tpu_torch.telemetry import metrics as _metrics

_PKG = __name__.rpartition(".")[0]

ENV_TS = "RSDL_TS"
ENV_TS_PERIOD_S = "RSDL_TS_PERIOD_S"
ENV_TS_SAMPLES = "RSDL_TS_SAMPLES"

_DEFAULT_PERIOD_S = 2.0
_DEFAULT_SAMPLES = 900

_lock = threading.Lock()
_ring: List[dict] = []
_capacity: Optional[int] = None
_prev: Dict[str, Dict[str, float]] = {}  # key -> last cumulative components
_prev_ts: Optional[float] = None
_thread: Optional[threading.Thread] = None
_stop_event: Optional[threading.Event] = None
_persist_error = False


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def period_s() -> float:
    value = _env_float(ENV_TS_PERIOD_S, _DEFAULT_PERIOD_S)
    return max(0.1, value)


def capacity() -> int:
    global _capacity
    if _capacity is None:
        _capacity = max(2, int(_env_float(ENV_TS_SAMPLES, _DEFAULT_SAMPLES)))
    return _capacity


def persist_path() -> Optional[str]:
    """Where samples append: ``<metrics spool>/ts/timeseries.ndjson`` —
    riding the metrics spool dir keeps one ``RSDL_METRICS_DIR``
    override relocating the whole plane. None disables persistence."""
    directory = _export.spool_dir()
    if not directory:
        return None
    return os.path.join(directory, "ts", "timeseries.ndjson")


def reset(capacity_override: Optional[int] = None) -> None:
    """Drop the ring, rate state, and cached capacity (tests and run
    boundaries); ``capacity_override`` pins a small ring for
    wraparound tests."""
    global _capacity, _prev_ts, _persist_error
    with _lock:
        _ring.clear()
        _prev.clear()
        _prev_ts = None
        _capacity = capacity_override
        _persist_error = False


# ---------------------------------------------------------------------------
# Sampling
# ---------------------------------------------------------------------------


def _delta(cur: float, prev: float) -> float:
    """Counter delta with reset handling: a decrease means the merged
    source set restarted (pid change dropping a spool file, cleared
    spool) — count from zero, never negative."""
    return cur - prev if cur >= prev else cur


def _build_sample_locked(
    typed: Dict[str, Dict[str, Any]], now: float, dt: Optional[float]
) -> dict:
    """One sample of ``typed``, its rates derived against ``_prev``:
    :func:`sample_now` calls it under ``_lock``."""
    metrics_out: Dict[str, Dict[str, Any]] = {}
    for key, entry in typed.items():
        kind = entry.get("kind")
        if kind == "counter":
            value = float(entry.get("value", 0.0))
            out: Dict[str, Any] = {"kind": "counter", "value": value}
            prev = _prev.get(key)
            if prev is not None and dt:
                out["rate"] = max(0.0, _delta(value, prev["value"])) / dt
            _prev[key] = {"value": value}
            metrics_out[key] = out
        elif kind == "gauge":
            metrics_out[key] = {
                "kind": "gauge",
                "value": float(entry.get("value", 0.0)),
            }
        elif kind == "histogram":
            count = float(entry.get("count", 0))
            total = float(entry.get("sum", 0.0))
            out = {"kind": "histogram", "count": count, "sum": total}
            for field in ("min", "max"):
                if field in entry:
                    out[field] = float(entry[field])
            prev = _prev.get(key)
            if prev is not None and dt:
                dcount = max(0.0, _delta(count, prev["value"]))
                dsum = _delta(total, prev.get("sum", 0.0))
                out["rate"] = dcount / dt
                if dcount > 0:
                    out["window_mean"] = max(0.0, dsum) / dcount
            _prev[key] = {"value": count, "sum": total}
            metrics_out[key] = out
    return {"ts": now, "dt": dt, "metrics": metrics_out}


def _persist(sample: dict) -> None:
    global _persist_error
    if _persist_error:
        return  # one failure (full/readonly disk) disables, not spams
    path = persist_path()
    if not path:
        return
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "a") as f:
            f.write(json.dumps(sample) + "\n")
    except OSError:
        _persist_error = True


def sample_now(now: Optional[float] = None) -> dict:
    """Take one sample: aggregate the registry (spools + local), derive
    rates against the previous sample, append to the ring, persist.
    Returns the sample (tests assert on it directly)."""
    global _prev_ts
    now = time.time() if now is None else float(now)
    typed = _export.aggregate_typed(per_source=True)
    with _lock:
        dt = None if _prev_ts is None else max(1e-9, now - _prev_ts)
        sample = _build_sample_locked(typed, now, dt)
        _prev_ts = now
        _ring.append(sample)
        cap = capacity()
        while len(_ring) > cap:
            _ring.pop(0)
    _persist(sample)
    return sample


def samples() -> List[dict]:
    with _lock:
        return list(_ring)


def load_persisted(path: Optional[str] = None) -> List[dict]:
    """Samples from the append-only file (post-hoc tools running in a
    different process than the sampler). Torn tail lines are skipped."""
    path = path or persist_path()
    out: List[dict] = []
    if not path or not os.path.exists(path):
        return out
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if isinstance(rec, dict) and "metrics" in rec:
                    out.append(rec)
    except OSError:
        pass
    return out


# ---------------------------------------------------------------------------
# Query
# ---------------------------------------------------------------------------


_PROM_CACHE: Dict[str, str] = {}


def _prom_name(base: str) -> str:
    """The Prometheus-rendered name of a registry key's base name —
    accepted as a query alias, so that :func:`series` takes the names a
    Prometheus scrape shows."""
    cached = _PROM_CACHE.get(base)
    if cached is None:
        import re

        cached = re.sub(r"[^a-zA-Z0-9_:]", "_", base)
        if not cached.startswith("rsdl_"):
            cached = "rsdl_" + cached
        # rsdl-lint: disable=lock-discipline -- idempotent memo cache:
        # racing writers store the identical sanitized string; worst
        # case is one duplicate regex pass
        _PROM_CACHE[base] = cached
    return cached


def _key_base(key: str) -> str:
    brace = key.find("{")
    return key if brace < 0 else key[:brace]


def _key_matches(key: str, name: Optional[str]) -> bool:
    if not name:
        return True
    base = _key_base(key)
    return name == base or name == _prom_name(base) or name == key


def _key_label(key: str, label: str) -> Optional[str]:
    """The value of one label in a ``name{k=v,...}`` key, else None."""
    brace, close = key.find("{"), key.rfind("}")
    if not (0 <= brace < close):
        return None
    for part in key[brace + 1:close].split(","):
        k, _, v = part.partition("=")
        if k == label:
            return v
    return None


def series(
    name: Optional[str] = None,
    window_s: Optional[float] = None,
    step_s: Optional[float] = None,
    include_sources: bool = False,
    now: Optional[float] = None,
    job: Optional[str] = None,
) -> Dict[str, List[dict]]:
    """Per-key point lists from the ring: ``{key: [{"ts", "value",
    "rate", ...}, ...]}``. ``name`` matches the registry key base name
    OR its Prometheus alias (``shuffle.map_rows`` ==
    ``rsdl_shuffle_map_rows``); ``window_s`` keeps the trailing
    window; ``step_s`` downsamples to at most one point per step;
    ``job`` keeps only that tenant's ``job=``-labeled keys.
    ``source=``-labeled per-source keys are excluded unless asked for
    (they multiply the payload by the process count)."""
    now = time.time() if now is None else float(now)
    cutoff = None if not window_s else now - float(window_s)
    out: Dict[str, List[dict]] = {}
    last_kept: Dict[str, float] = {}
    for sample in samples():
        ts = float(sample.get("ts", 0.0))
        if cutoff is not None and ts < cutoff:
            continue
        for key, entry in sample.get("metrics", {}).items():
            if not include_sources and "source=" in key:
                continue
            if not _key_matches(key, name):
                continue
            if job is not None and _key_label(key, "job") != job:
                continue
            if step_s and key in last_kept and (
                ts - last_kept[key] < float(step_s)
            ):
                continue
            last_kept[key] = ts
            point = {"ts": ts}
            for field in ("value", "rate", "count", "sum",
                          "window_mean", "min", "max"):
                if field in entry:
                    point[field] = entry[field]
            out.setdefault(key, []).append(point)
    return out


# ---------------------------------------------------------------------------
# Sampler thread lifecycle
# ---------------------------------------------------------------------------


def running() -> bool:
    return _thread is not None and _thread.is_alive()


def start(period: Optional[float] = None) -> None:
    """Start the sampler daemon thread (idempotent). Call from the
    session owner only — one sampler per spool, like the obs server."""
    global _thread, _stop_event
    if not _metrics.enabled():
        return
    interval = period_s() if period is None else max(0.1, float(period))
    with _lock:
        if _thread is not None and _thread.is_alive():
            return
        stop_event = threading.Event()
        _stop_event = stop_event

        def _loop():
            while not stop_event.wait(interval):
                try:
                    # Refresh the derived-gauge planes first so the
                    # rsdl_straggler_* / rsdl_capacity_* /
                    # rsdl_critical_* gauges have history too (each
                    # plane is its own import so one failure cannot
                    # starve the others).
                    from ray_shuffling_data_loader_tpu_torch.telemetry import (
                        stragglers as _stragglers,
                    )

                    _stragglers.publish_metrics()
                except Exception:
                    pass
                try:
                    from ray_shuffling_data_loader_tpu_torch.telemetry import (
                        capacity as _capacity,
                    )

                    _capacity.safe_flush()  # driver-side ledger ops
                    _capacity.publish_metrics()
                except Exception:
                    pass
                try:
                    from ray_shuffling_data_loader_tpu_torch.telemetry import (
                        critical as _critical,
                    )

                    _critical.publish_metrics()
                except Exception:
                    pass
                try:
                    # The relay's freshness gauges, through sys.modules
                    # only: the sampler never imports the federation
                    # plane, which the port does not have yet.
                    _relay = sys.modules.get(f"{_PKG}.relay")
                    if _relay is not None:
                        _relay.publish_metrics()
                except Exception:
                    pass
                try:
                    sample_now()
                except Exception:
                    pass  # telemetry must never sink anything
                try:
                    # The alert engine reads the ring, so it evaluates
                    # after the fresh sample. Looked up in sys.modules,
                    # not imported: the port has no SLO engine yet, and
                    # an import that fails every tick is no gate.
                    _slo = sys.modules.get(f"{_PKG}.slo")
                    if _slo is not None:
                        _slo.evaluate()
                except Exception:
                    pass

        _thread = threading.Thread(
            target=_loop, name="rsdl-ts-sampler", daemon=True
        )
        _thread.start()


def stop() -> None:
    """Stop the sampler and join its thread (session shutdown, tests).
    The ring and persisted file stay — history outlives the sampler."""
    global _thread, _stop_event
    with _lock:
        thread, _thread = _thread, None
        stop_event, _stop_event = _stop_event, None
    if stop_event is not None:
        stop_event.set()
    if thread is not None:
        thread.join(timeout=5.0)


def forced_on() -> bool:
    """``RSDL_TS=1`` forces the sampler on without an obs port (headless
    history for a post-hoc epoch report)."""
    from ray_shuffling_data_loader_tpu_torch.telemetry import _env

    return _env.read_flag(ENV_TS)
