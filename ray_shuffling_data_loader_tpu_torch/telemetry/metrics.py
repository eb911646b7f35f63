"""Counters, gauges and histograms in one registry per process, with
sources from other processes, a sampled timeline, a JSON dump and the
Prometheus text format.

Off unless ``RSDL_METRICS`` is truthy: every wiring site checks
:func:`enabled` (one cached boolean) before it touches an instrument.
Instruments are lock-guarded floats keyed ``name{label=value,...}``
(:func:`format_key`). Values of other processes come in two ways: a
**source** (:func:`register_source`, a callable returning a flat
``{key: value}`` dict, e.g. over the queue actor's depths) merged by
:func:`global_snapshot` and dropped after ``_SOURCE_MAX_FAILURES`` failures
in a row; and the per-process spool of :mod:`.export`.

The store sampler of :mod:`..stats` (``ObjectStoreStatsCollector``) takes
a :func:`global_snapshot` every period, appends it to the :func:`timeline`,
forwards it to the ``TrialStatsCollector`` and logs a
:func:`progress_line`; :func:`dump_json` writes the timeline and a final
snapshot as one artifact.

The names, labels, key syntax and Prometheus text are the JAX package's,
byte for byte, so one scrape configuration and one dashboard read both:

====================================  =========  ===============================
key                                   kind       set by
====================================  =========  ===============================
``queue.depth{epoch=E,rank=R}``       gauge      batch-queue actor (source)
``queue.depth.total``                 gauge      batch-queue actor (source)
``store.shm_bytes``                   gauge      store sampler
``store.spill_bytes``                 gauge      store sampler
``store.objects``                     gauge      store sampler
``stall_seconds{cause=upstream}``     counter    device stager
``stall_seconds{cause=staging}``      counter    device stager
``h2d.bytes`` / ``h2d.batches``       counter    device stager
``shuffle.map_tasks`` / ``_rows``     counter    map tasks (spooled)
``shuffle.reduce_tasks`` / ``_rows``  counter    reduce tasks (spooled)
``shuffle.phase_seconds{phase,stage}`` histogram  :mod:`.phases`
``recovery.*``                        counter    stage recovery, retries
====================================  =========  ===============================

This module imports the standard library only.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from ray_shuffling_data_loader_tpu_torch.telemetry import _env

ENV_METRICS = "RSDL_METRICS"

# Cap for every sampled series (the local timeline AND the collector-actor
# copies in stats.py) — public so the bound stays one number everywhere.
MAX_TIMELINE_SAMPLES = 20_000

_enabled: Optional[bool] = None  # tri-state: None = not yet read from env


def enabled() -> bool:
    """Is the metrics half on in this process? Every instrumentation site
    checks this first, so disabled cost is one cached boolean check."""
    global _enabled
    if _enabled is None:
        _enabled = _env.read_flag(ENV_METRICS)
    return _enabled


def enable() -> None:
    """Turn metrics on for this process AND (via the environment) every
    process spawned after this call."""
    global _enabled
    os.environ[ENV_METRICS] = "1"
    _enabled = True


def disable() -> None:
    global _enabled
    os.environ.pop(ENV_METRICS, None)
    _enabled = False


def refresh_from_env() -> None:
    """Forget the cached enabled state; the next check re-reads the env
    (test harness hook)."""
    global _enabled
    _enabled = None


def format_key(name: str, labels: Optional[Dict[str, Any]] = None) -> str:
    """Flatten ``(name, labels)`` to the canonical snapshot key:
    ``name{k1=v1,k2=v2}`` with labels sorted by key; bare ``name`` when
    there are none."""
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


class Counter:
    """Monotonic accumulator (bytes moved, stall seconds, ...)."""

    __slots__ = ("key", "_value", "_lock")

    def __init__(self, key: str):
        self.key = key
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, value: float = 1.0) -> None:
        with self._lock:
            self._value += value

    @property
    def value(self) -> float:
        return self._value

    def snapshot_into(self, out: Dict[str, float]) -> None:
        out[self.key] = self._value


class Gauge:
    """Last-write-wins level (queue depth, shm residency, ...)."""

    __slots__ = ("key", "_value")

    def __init__(self, key: str):
        self.key = key
        self._value = 0.0

    def set(self, value: float) -> None:
        self._value = float(value)

    @property
    def value(self) -> float:
        return self._value

    def snapshot_into(self, out: Dict[str, float]) -> None:
        out[self.key] = self._value


class Histogram:
    """Streaming count/sum/min/max — enough to answer "how many, how big,
    how skewed" without bucket configuration."""

    __slots__ = ("key", "count", "sum", "min", "max", "_lock")

    def __init__(self, key: str):
        self.key = key
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        with self._lock:
            self.count += 1
            self.sum += value
            self.min = min(self.min, value)
            self.max = max(self.max, value)

    def snapshot_into(self, out: Dict[str, float]) -> None:
        with self._lock:  # consistent (count, sum, min, max) vs observe()
            count, total = self.count, self.sum
            lo, hi = self.min, self.max
        out[f"{self.key}_count"] = float(count)
        out[f"{self.key}_sum"] = total
        if count:
            out[f"{self.key}_min"] = lo
            out[f"{self.key}_max"] = hi


class MetricsRegistry:
    """Get-or-create instrument registry; instruments are singletons per
    ``(name, labels)`` so call sites can re-resolve them freely."""

    def __init__(self):
        self._lock = threading.Lock()
        self._instruments: Dict[str, Any] = {}

    def _get(self, cls, name: str, labels: Dict[str, Any]):
        key = format_key(name, labels)
        with self._lock:
            inst = self._instruments.get(key)
            if inst is None:
                inst = self._instruments[key] = cls(key)
            elif not isinstance(inst, cls):
                raise TypeError(
                    f"metric {key!r} already registered as "
                    f"{type(inst).__name__}, not {cls.__name__}"
                )
            return inst

    def counter(self, name: str, **labels: Any) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels: Any) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, **labels: Any) -> Histogram:
        return self._get(Histogram, name, labels)

    def snapshot(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        with self._lock:
            instruments = list(self._instruments.values())
        for inst in instruments:
            inst.snapshot_into(out)
        return out

    def kinds(self) -> Dict[str, str]:
        """``{instrument key: "counter"|"gauge"|"histogram"}`` — the
        metric-kind map the Prometheus exporter's ``# TYPE`` lines and
        the cross-process aggregator's merge semantics key on."""
        with self._lock:
            return {
                key: _KIND_NAME[type(inst)]
                for key, inst in self._instruments.items()
            }

    def typed_snapshot(self) -> Dict[str, Dict[str, Any]]:
        """Kind-preserving snapshot: ``{key: {"kind": ..., ...}}`` with
        counters/gauges carrying ``value`` and histograms their full
        ``count/sum/min/max`` state — the spool record format
        :mod:`.export` ships across processes (a flat float snapshot
        cannot be merged correctly: counters must sum, gauges must
        latest-win, histogram components must each merge their own
        way)."""
        with self._lock:
            instruments = list(self._instruments.values())
        out: Dict[str, Dict[str, Any]] = {}
        for inst in instruments:
            if isinstance(inst, Counter):
                out[inst.key] = {"kind": "counter", "value": inst.value}
            elif isinstance(inst, Gauge):
                out[inst.key] = {"kind": "gauge", "value": inst.value}
            else:
                with inst._lock:  # consistent component tuple
                    rec: Dict[str, Any] = {
                        "kind": "histogram",
                        "count": inst.count,
                        "sum": inst.sum,
                    }
                    if inst.count:
                        rec["min"] = inst.min
                        rec["max"] = inst.max
                out[inst.key] = rec
        return out

    def clear(self) -> None:
        with self._lock:
            self._instruments.clear()


_KIND_NAME = {Counter: "counter", Gauge: "gauge", Histogram: "histogram"}

registry = MetricsRegistry()


def safe_inc(name: str, value: float = 1.0, **labels: Any) -> None:
    """Increment a counter iff metrics are enabled, never raising into
    the caller — the ONE definition of the guarded-increment pattern the
    recovery/fault layers use from failure paths (where a telemetry
    error must not break recovery itself)."""
    try:
        if enabled():
            registry.counter(name, **labels).inc(value)
    except Exception:
        pass


# -- cross-process sources ---------------------------------------------------

_sources: Dict[str, Callable[[], Dict[str, float]]] = {}
_source_failures: Dict[str, int] = {}
_sources_lock = threading.Lock()
_SOURCE_MAX_FAILURES = 3


def register_source(name: str, fn: Callable[[], Dict[str, float]]) -> None:
    """Register a callable merged into every :func:`global_snapshot` (e.g.
    a closure over an actor handle returning its live gauges). Re-using a
    name replaces the previous source."""
    with _sources_lock:
        _sources[name] = fn
        _source_failures[name] = 0


def unregister_source(name: str) -> None:
    with _sources_lock:
        _sources.pop(name, None)
        _source_failures.pop(name, None)


def global_snapshot() -> Dict[str, float]:
    """The local registry plus every live source. A source that fails
    ``_SOURCE_MAX_FAILURES`` times in a row (its actor died) is dropped so
    dead endpoints don't slow the sampler forever."""
    out = registry.snapshot()
    with _sources_lock:
        sources = list(_sources.items())
    for name, fn in sources:
        try:
            values = fn()
        except Exception:
            with _sources_lock:
                _source_failures[name] = _source_failures.get(name, 0) + 1
                if _source_failures[name] >= _SOURCE_MAX_FAILURES:
                    _sources.pop(name, None)
                    _source_failures.pop(name, None)
            continue
        with _sources_lock:
            if name in _source_failures:
                _source_failures[name] = 0
        for key, value in (values or {}).items():
            out[key] = float(value)
    return out


# -- timeline + JSON dump ----------------------------------------------------

_timeline: "deque[Dict[str, Any]]" = deque(maxlen=MAX_TIMELINE_SAMPLES)
# Guards iteration (list(_timeline)) against a sampler thread appending
# concurrently — e.g. dump_json on the error path of a run whose sampler
# is still alive; unguarded, CPython raises "deque mutated during
# iteration" and the metrics artifact of exactly that failed run is lost.
_timeline_lock = threading.Lock()


def record_sample(values: Dict[str, float],
                  ts: Optional[float] = None) -> None:
    """Append one sampled snapshot to the in-memory series (bounded; the
    oldest samples roll off)."""
    sample = {"ts": ts if ts is not None else time.time(),
              "values": dict(values)}
    with _timeline_lock:
        _timeline.append(sample)


def timeline() -> List[Dict[str, Any]]:
    with _timeline_lock:
        return list(_timeline)


def dump_json(path: str, include_sources: bool = True) -> str:
    """Write the sampled series plus a final snapshot as one JSON
    artifact: ``{"samples": [{"ts", "values"}...], "final": {...}}``.

    ``include_sources=False`` restricts the final snapshot to this
    process's registry — for error paths where a registered source's
    actor may be wedged (not dead): a source call blocks on a reply with
    no timeout, and an artifact dump must never hang the process that is
    trying to report a failure. The sampled timeline is always local.
    """
    payload = {
        "generated_ts": time.time(),
        "samples": timeline(),
        "final": global_snapshot() if include_sources else registry.snapshot(),
    }
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f)
    os.replace(tmp, path)
    return path


_PROM_NAME_SAN = None  # compiled lazily; regex import stays off hot paths


def _prom_parts(key: str, value: float) -> Tuple[str, str, str]:
    """``(name, labels, rendered_value)`` for one snapshot key. Our
    canonical key syntax (``name{k1=v1,k2=v2}``, :func:`format_key`) maps
    1:1 onto the exposition format — names sanitized to the Prometheus
    charset and prefixed ``rsdl_`` (so a stock Prometheus scrapes them
    into their own namespace without relabeling), label values quoted
    and escaped."""
    global _PROM_NAME_SAN
    if _PROM_NAME_SAN is None:
        import re

        _PROM_NAME_SAN = re.compile(r"[^a-zA-Z0-9_:]")
    labels = ""
    name = key
    brace, close = key.find("{"), key.rfind("}")
    if 0 <= brace < close:
        # Labeled key — possibly with a suffix after the labels: a
        # labeled Histogram snapshots as "name{k=v}_count" etc.; the
        # suffix belongs to the metric NAME, not the labels.
        name = key[:brace] + key[close + 1:]
        inner = key[brace + 1:close]
        pairs = []
        for part in inner.split(","):
            k, _, v = part.partition("=")
            v = v.replace("\\", r"\\").replace('"', r"\"").replace(
                "\n", r"\n"
            )
            pairs.append(f'{_PROM_NAME_SAN.sub("_", k)}="{v}"')
        labels = "{" + ",".join(pairs) + "}"
    name = _PROM_NAME_SAN.sub("_", name)
    if not name.startswith("rsdl_"):
        name = "rsdl_" + name
    # Exact rendering: %g would truncate counters to 6 significant digits
    # (1_234_567 -> "1.23457e+06"), corrupting exact row/byte counts in
    # the export. Integral values render as integers; the rest use
    # repr's shortest round-trip form. Non-finite values (a source can
    # return anything) use the Prometheus literals instead of crashing
    # int(value).
    import math

    if not math.isfinite(value):
        rendered = "NaN" if math.isnan(value) else (
            "+Inf" if value > 0 else "-Inf"
        )
    elif value == int(value) and abs(value) < 2**63:
        rendered = str(int(value))
    else:
        rendered = repr(float(value))
    return name, labels, rendered


# Flat histogram-component suffixes and the Prometheus type each one
# scrapes correctly as (count/sum accumulate, min/max are levels).
_HIST_SUFFIX_TYPE = (
    ("_count", "counter"),
    ("_sum", "counter"),
    ("_min", "gauge"),
    ("_max", "gauge"),
)


def _prom_kind(key: str, kinds: Dict[str, str]) -> str:
    """The ``# TYPE`` keyword for one snapshot key given the instrument
    kind map (:meth:`MetricsRegistry.kinds` / the aggregator's merged
    kinds). Keys of unknown provenance (cross-process source values)
    stay ``untyped``."""
    kind = kinds.get(key)
    if kind in ("counter", "gauge"):
        return kind
    for suffix, mapped in _HIST_SUFFIX_TYPE:
        if key.endswith(suffix) and (
            kinds.get(key[: -len(suffix)]) == "histogram"
        ):
            return mapped
    return "untyped"


def to_prometheus_text(
    snapshot: Dict[str, float], kinds: Optional[Dict[str, str]] = None
) -> str:
    """Render a snapshot (:func:`global_snapshot` /
    :meth:`MetricsRegistry.snapshot` / :func:`.export.aggregate`) as
    Prometheus text exposition format — a plain function, no server:
    dump it next to the Chrome trace, serve it from the ``/metrics``
    endpoint, or pipe it to a pushgateway. Samples
    are grouped per metric name under ``# HELP``/``# TYPE`` headers and
    sorted, so the artifact is stable, diffable, and scrapeable by a
    stock Prometheus without relabeling. ``kinds`` maps instrument keys
    to their kind (defaults to this process's registry); keys it cannot
    resolve are emitted ``untyped``."""
    if kinds is None:
        kinds = registry.kinds()
    groups: Dict[str, List[Tuple[str, str, str]]] = {}
    for key in snapshot:
        name, labels, rendered = _prom_parts(key, float(snapshot[key]))
        groups.setdefault(name, []).append((labels, rendered, key))
    # The header and HELP text name the JAX package, as its exporter does:
    # the two packages' exports are the same bytes.
    lines = [
        "# Prometheus text format; generated by "
        "ray_shuffling_data_loader_tpu.telemetry.metrics"
    ]
    for name in sorted(groups):
        entries = sorted(groups[name])
        lines.append(
            f"# HELP {name} ray_shuffling_data_loader_tpu metric "
            f"{entries[0][2].split('{', 1)[0]}"
        )
        lines.append(f"# TYPE {name} {_prom_kind(entries[0][2], kinds)}")
        for labels, rendered, _key in entries:
            lines.append(f"{name}{labels} {rendered}")
    return "\n".join(lines) + "\n"


def reset() -> None:
    """Clear instruments, sources, and the timeline (tests only)."""
    registry.clear()
    with _sources_lock:
        _sources.clear()
        _source_failures.clear()
    with _timeline_lock:
        _timeline.clear()


# -- human-readable progress line --------------------------------------------


def _fmt_bytes(num: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(num) < 1024.0:
            return f"{num:.1f}{unit}"
        num /= 1024.0
    return f"{num:.1f}PiB"


def progress_line(values: Dict[str, float]) -> str:
    """One-line human summary of a snapshot — the periodic progress line
    the sampler logs (``shm= spill= queue= h2d= stall=``)."""
    up = values.get(format_key("stall_seconds", {"cause": "upstream"}), 0.0)
    staging = values.get(
        format_key("stall_seconds", {"cause": "staging"}), 0.0
    )
    parts = [
        f"shm={_fmt_bytes(values.get('store.shm_bytes', 0.0))}",
        f"spill={_fmt_bytes(values.get('store.spill_bytes', 0.0))}",
    ]
    depth = values.get("queue.depth.total")
    if depth is not None:
        parts.append(f"queue={int(depth)}")
    parts.append(f"h2d={_fmt_bytes(values.get('h2d.bytes', 0.0))}")
    parts.append(
        f"stall={up + staging:.2f}s"
        f" (upstream {up:.2f} / staging {staging:.2f})"
    )
    return "metrics: " + " ".join(parts)
