"""Shuffle and delivery statistics: the model, the collectors and the
report writers.

A copy of the JAX package's stats plane with the same field names and CSV
columns: a tree of per-trial, per-epoch and per-stage stats; the
:class:`TrialStatsCollector` actor that the shuffle's tasks and the
loaders report to; a store-utilization sampler thread; and
:func:`process_stats`, which writes the trial, epoch and consumer-timeline
CSVs.

With ``RSDL_METRICS`` on, the store sampler is also the live-metrics
sampler: every period it sets the ``store.*`` gauges, takes
:func:`.telemetry.metrics.global_snapshot`, records it in the timeline,
forwards it to the collector (``metrics_sample``, kept in the trial's
``metrics_samples``), spools the driver's registry and logs the progress
line. Remote ``stats_dir`` URIs are not ported: the CSVs go to a local
directory.

This module imports numpy only: the collector runs as an actor, and the
shuffle's workers call it.
"""

from __future__ import annotations

import asyncio
import csv
import logging
import os
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Deque, Dict, List, Optional, Sequence

import numpy as np

logger = logging.getLogger(__name__)

# The most samples a sampled series keeps (the JAX package's
# ``telemetry.metrics.MAX_TIMELINE_SAMPLES``).
MAX_TIMELINE_SAMPLES = 20_000


def _agg(values: Sequence[float]) -> Dict[str, float]:
    if not values:
        return {"avg": 0.0, "std": 0.0, "max": 0.0, "min": 0.0}
    arr = np.asarray(values, dtype=np.float64)
    return {
        "avg": float(arr.mean()),
        "std": float(arr.std()),
        "max": float(arr.max()),
        "min": float(arr.min()),
    }


@dataclass
class ConsumeRecord:
    """One reducer output delivered to a rank (a consumer-timeline row)."""

    rank: int
    epoch: int
    time_since_epoch_start: float
    nbytes: int


@dataclass
class EpochStats:
    """Per-epoch stage timings."""

    epoch: int
    start_time: float = 0.0
    duration: float = 0.0
    throttle_duration: float = 0.0  # epoch-window admission wait
    map_durations: List[float] = field(default_factory=list)
    map_read_durations: List[float] = field(default_factory=list)
    reduce_durations: List[float] = field(default_factory=list)
    consume_records: List[ConsumeRecord] = field(default_factory=list)
    # Stage windows: first task start -> last task done.
    map_stage_duration: float = 0.0
    reduce_stage_duration: float = 0.0

    def row(self, trial: int) -> Dict[str, float]:
        out = {
            "trial": trial,
            "epoch": self.epoch,
            "duration": self.duration,
            "throttle_duration": self.throttle_duration,
            "map_stage_duration": self.map_stage_duration,
            "reduce_stage_duration": self.reduce_stage_duration,
            "num_map_tasks": len(self.map_durations),
            "num_reduce_tasks": len(self.reduce_durations),
        }
        for k, v in _agg(self.map_durations).items():
            out[f"map_task_{k}"] = v
        for k, v in _agg(self.map_read_durations).items():
            out[f"map_read_{k}"] = v
        for k, v in _agg(self.reduce_durations).items():
            out[f"reduce_task_{k}"] = v
        for k, v in _agg([c.time_since_epoch_start for c in self.consume_records]).items():
            out[f"consume_time_{k}"] = v
        return out


@dataclass
class StoreSample:
    timestamp: float
    num_objects: int
    total_bytes: int
    # The part of total_bytes in the spill directory.
    spill_bytes: int = 0


@dataclass
class StagingStats:
    """A trainer's staging report (``HostToDeviceStats.as_dict()``)."""

    rank: int
    bytes_staged: int = 0
    batches_staged: int = 0
    put_dispatch_s: float = 0.0
    stall_s: float = 0.0
    stalls: int = 0
    # stall_s by cause: upstream (no host batch: epoch window or shuffle)
    # and staging (the host-to-device pipeline behind).
    stall_upstream_s: float = 0.0
    stall_staging_s: float = 0.0
    first_batch_s: float = 0.0
    peak_device_bytes_in_use: int = 0


@dataclass
class TrialStats:
    """Whole-trial stats."""

    trial: int = 0
    duration: float = 0.0
    num_rows: int = 0
    num_epochs: int = 0
    batch_size: int = 0
    num_trainers: int = 1
    # The workload's shape: the leading columns of the trial CSV.
    num_files: int = 0
    num_row_groups_per_file: int = 0
    num_reducers: int = 0
    max_concurrent_epochs: int = 0
    epochs: List[EpochStats] = field(default_factory=list)
    # Sampled series are rings: a long run must not grow the actor, and
    # every snapshot, without bound.
    store_samples: Deque[StoreSample] = field(default_factory=lambda: deque(maxlen=MAX_TIMELINE_SAMPLES))
    staging: List[StagingStats] = field(default_factory=list)
    # Live-metrics snapshots ({"ts", "values"}), from a sampler that
    # reports them.
    metrics_samples: Deque[Dict[str, Any]] = field(default_factory=lambda: deque(maxlen=MAX_TIMELINE_SAMPLES))
    # Per-epoch audit verdicts: digest equality and shuffle quality.
    audit_epochs: List[Dict[str, Any]] = field(default_factory=list)

    @property
    def row_throughput(self) -> float:
        return self.num_epochs * self.num_rows / self.duration if self.duration else 0.0

    @property
    def batch_throughput(self) -> float:
        return self.row_throughput / self.batch_size if self.batch_size else 0.0

    @property
    def per_trainer_batch_throughput(self) -> float:
        return self.batch_throughput / max(1, self.num_trainers)

    @property
    def max_store_bytes(self) -> int:
        return max((s.total_bytes for s in self.store_samples), default=0)

    @property
    def avg_store_bytes(self) -> float:
        if not self.store_samples:
            return 0.0
        return float(np.mean([s.total_bytes for s in self.store_samples]))

    @property
    def max_spill_bytes(self) -> int:
        return max((s.spill_bytes for s in self.store_samples), default=0)

    @property
    def max_shm_bytes(self) -> int:
        """Peak shared-memory residency: total minus what had spilled at
        that sample."""
        return max((s.total_bytes - s.spill_bytes for s in self.store_samples), default=0)

    @property
    def total_stall_s(self) -> float:
        return sum(s.stall_s for s in self.staging)

    @property
    def total_bytes_staged(self) -> int:
        return sum(s.bytes_staged for s in self.staging)

    def row(self) -> Dict[str, float]:
        """The trial-CSV row: the workload, throughputs, stage aggregates,
        then the staging, stall and audit columns."""
        out = {
            "num_files": self.num_files,
            "num_row_groups_per_file": self.num_row_groups_per_file,
            "num_reducers": self.num_reducers,
            "num_trainers": self.num_trainers,
            "num_epochs": self.num_epochs,
            "max_concurrent_epochs": self.max_concurrent_epochs,
            "trial": self.trial,
            "duration": self.duration,
            "num_rows": self.num_rows,
            "batch_size": self.batch_size,
            "row_throughput": self.row_throughput,
            "batch_throughput": self.batch_throughput,
            "batch_throughput_per_trainer": self.per_trainer_batch_throughput,
            "avg_object_store_utilization": self.avg_store_bytes,
            "max_object_store_utilization": self.max_store_bytes,
            "max_store_shm_bytes": self.max_shm_bytes,
            "max_store_spill_bytes": self.max_spill_bytes,
        }

        def put_agg(name: str, values: Sequence[float]) -> None:
            for k, v in _agg(values).items():
                out[f"{k}_{name}"] = v

        put_agg("epoch_duration", [e.duration for e in self.epochs])
        put_agg("map_stage_duration", [e.map_stage_duration for e in self.epochs])
        put_agg("reduce_stage_duration", [e.reduce_stage_duration for e in self.epochs])
        put_agg(
            "consume_stage_duration",
            [max((c.time_since_epoch_start for c in e.consume_records), default=0.0) for e in self.epochs],
        )
        put_agg("map_task_duration", [d for e in self.epochs for d in e.map_durations])
        put_agg("read_duration", [d for e in self.epochs for d in e.map_read_durations])
        put_agg("reduce_task_duration", [d for e in self.epochs for d in e.reduce_durations])
        put_agg("time_to_consume", [c.time_since_epoch_start for e in self.epochs for c in e.consume_records])

        put_dispatch_s = sum(s.put_dispatch_s for s in self.staging)
        out["total_bytes_staged"] = self.total_bytes_staged
        out["put_dispatch_s"] = put_dispatch_s
        out["h2d_gbps"] = self.total_bytes_staged / 1e9 / put_dispatch_s if put_dispatch_s > 0 else 0.0
        out["total_stall_s"] = self.total_stall_s
        out["stall_pct"] = (
            100.0 * self.total_stall_s / (self.duration * max(1, len(self.staging))) if self.duration else 0.0
        )
        out["peak_hbm_bytes"] = max((s.peak_device_bytes_in_use for s in self.staging), default=0)
        # Empty or zero when no audit ran, so that the schema is stable.
        out["audit_epochs_ok"] = sum(1 for v in self.audit_epochs if v.get("ok"))
        out["audit_mismatch_epochs"] = ";".join(
            str(v.get("epoch")) for v in self.audit_epochs if v.get("ok") is False
        )
        out["audit_rows_delivered"] = sum(int(v.get("rows_delivered") or 0) for v in self.audit_epochs)
        return out


class TrialStatsCollector:
    """Collects the per-stage timings that the shuffle's tasks and the
    loaders report.

    Run it as a named actor of the runtime (``runtime.spawn_actor(
    TrialStatsCollector, ...)``); tasks hold a picklable handle and report
    with ``call_oneway``, which does not wait for a reply. Stage windows
    are computed here, from first start to last done on this process's
    clock, so the tasks' clocks need not agree.
    """

    def __init__(
        self,
        num_epochs: int,
        num_maps_per_epoch: int,
        num_reduces_per_epoch: int,
        num_rows: int = 0,
        batch_size: int = 0,
        num_trainers: int = 1,
        trial: int = 0,
        num_row_groups_per_file: int = 0,
        max_concurrent_epochs: int = 0,
    ):
        self._num_maps = num_maps_per_epoch
        self._num_reduces = num_reduces_per_epoch
        self.stats = TrialStats(
            trial=trial,
            num_rows=num_rows,
            num_epochs=num_epochs,
            batch_size=batch_size,
            num_trainers=num_trainers,
            num_files=num_maps_per_epoch,
            num_row_groups_per_file=num_row_groups_per_file,
            num_reducers=num_reduces_per_epoch,
            max_concurrent_epochs=max_concurrent_epochs,
        )
        self._epochs: Dict[int, EpochStats] = {}
        self._map_first_start: Dict[int, float] = {}
        self._reduce_first_start: Dict[int, float] = {}
        self._done = asyncio.Event()

    def _epoch(self, epoch: int) -> EpochStats:
        if epoch not in self._epochs:
            self._epochs[epoch] = EpochStats(epoch=epoch)
        return self._epochs[epoch]

    # -- the producer's hooks (the shuffle and its tasks) ---------------------

    def epoch_start(self, epoch: int) -> None:
        self._epoch(epoch).start_time = time.time()

    def epoch_throttle(self, epoch: int, duration: float) -> None:
        self._epoch(epoch).throttle_duration = duration

    def map_start(self, epoch: int) -> None:
        self._map_first_start.setdefault(epoch, time.time())

    def map_done(self, epoch: int, duration: float, read_duration: float) -> None:
        e = self._epoch(epoch)
        e.map_durations.append(duration)
        e.map_read_durations.append(read_duration)
        if len(e.map_durations) == self._num_maps:
            e.map_stage_duration = time.time() - self._map_first_start.get(epoch, e.start_time or time.time())

    def reduce_start(self, epoch: int) -> None:
        self._reduce_first_start.setdefault(epoch, time.time())

    def reduce_done(self, epoch: int, duration: float) -> None:
        e = self._epoch(epoch)
        e.reduce_durations.append(duration)
        if len(e.reduce_durations) == self._num_reduces:
            e.reduce_stage_duration = time.time() - self._reduce_first_start.get(epoch, e.start_time or time.time())
            if e.start_time:
                e.duration = time.time() - e.start_time

    def consume(self, rank: int, epoch: int, nbytes: int = 0) -> None:
        e = self._epoch(epoch)
        e.consume_records.append(
            ConsumeRecord(
                rank=rank,
                epoch=epoch,
                time_since_epoch_start=time.time() - e.start_time if e.start_time else 0.0,
                nbytes=nbytes,
            )
        )

    # -- the trainer's hooks -------------------------------------------------

    def report_staging(self, rank: int, staging: Dict[str, float]) -> None:
        self.stats.staging.append(
            StagingStats(
                rank=rank,
                bytes_staged=int(staging.get("bytes_staged", 0)),
                batches_staged=int(staging.get("batches_staged", 0)),
                put_dispatch_s=float(staging.get("put_dispatch_s", 0.0)),
                stall_s=float(staging.get("stall_s", 0.0)),
                stalls=int(staging.get("stalls", 0)),
                stall_upstream_s=float(staging.get("stall_upstream_s", 0.0)),
                stall_staging_s=float(staging.get("stall_staging_s", 0.0)),
                first_batch_s=float(staging.get("first_batch_s", 0.0)),
                peak_device_bytes_in_use=int(staging.get("peak_device_bytes_in_use", 0)),
            )
        )

    def audit_epoch(self, epoch: int, verdict: Dict[str, Any]) -> None:
        """One epoch's audit verdict; it joins the trial CSV's audit
        columns."""
        self.stats.audit_epochs.append(dict(verdict))

    def metrics_sample(self, ts: float, values: Dict[str, float]) -> None:
        """One live-metrics snapshot (the series is bounded)."""
        self.stats.metrics_samples.append({"ts": ts, "values": values})

    def store_sample(self, num_objects: int, total_bytes: int, spill_bytes: int = 0) -> None:
        self.stats.store_samples.append(
            StoreSample(
                timestamp=time.time(),
                num_objects=num_objects,
                total_bytes=total_bytes,
                spill_bytes=spill_bytes,
            )
        )

    # -- completion ----------------------------------------------------------

    def trial_done(self, duration: float) -> None:
        self.stats.duration = duration
        self._done.set()

    def _counts_complete(self) -> bool:
        """Every expected report has landed. ``trial_done`` and the tasks'
        reports arrive on different connections, so completion is judged
        by count, not by the order of arrival."""
        if len(self._epochs) < self.stats.num_epochs:
            return False
        for e in self._epochs.values():
            if (
                len(e.map_durations) < self._num_maps
                or len(e.reduce_durations) < self._num_reduces
                or len(e.consume_records) < self._num_reduces
            ):
                return False
        return True

    def snapshot(self) -> TrialStats:
        """The stats so far, without waiting for completion (for callers
        that consume batches themselves and send no ``consume``)."""
        self.stats.epochs = [self._epochs[e] for e in sorted(self._epochs)]
        return self.stats

    async def get_stats(self, timeout: Optional[float] = None) -> TrialStats:
        """Wait for ``trial_done`` and every task's report, then return the
        whole stats tree."""

        async def _wait():
            await self._done.wait()
            while not self._counts_complete():
                await asyncio.sleep(0.02)

        await asyncio.wait_for(_wait(), timeout)
        self.stats.epochs = [self._epochs[e] for e in sorted(self._epochs)]
        return self.stats


class ObjectStoreStatsCollector:
    """Context manager that samples the session's store (objects, bytes,
    spilled bytes) on a daemon thread every ``sample_period_s`` and reports
    each sample to the collector actor (or only keeps it in ``samples``
    when ``collector`` is None); with metrics on, also the live-metrics
    sample (:meth:`_sample_metrics`)."""

    def __init__(self, collector=None, sample_period_s: float = 5.0):
        self._collector = collector
        self._period = sample_period_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.samples: List[StoreSample] = []

    def _sample_metrics(self, sample: StoreSample) -> None:
        from ray_shuffling_data_loader_tpu_torch.telemetry import export, metrics

        reg = metrics.registry
        reg.gauge("store.shm_bytes").set(sample.total_bytes - sample.spill_bytes)
        reg.gauge("store.spill_bytes").set(sample.spill_bytes)
        reg.gauge("store.objects").set(sample.num_objects)
        snap = metrics.global_snapshot()
        metrics.record_sample(snap, ts=sample.timestamp)
        if self._collector is not None:
            try:
                self._collector.call_oneway("metrics_sample", sample.timestamp, snap)
            except Exception:
                pass
        # The driver's registry spools each period, for the cross-process
        # aggregate.
        export.maybe_flush()
        logger.info(metrics.progress_line(snap))

    def _loop(self):
        from ray_shuffling_data_loader_tpu_torch import runtime
        from ray_shuffling_data_loader_tpu_torch.runtime import ActorDiedError
        from ray_shuffling_data_loader_tpu_torch.telemetry import metrics

        while not self._stop.wait(self._period):
            try:
                s = runtime.store_stats()
            except (RuntimeError, OSError):
                continue
            sample = StoreSample(
                timestamp=time.time(),
                num_objects=s.num_objects,
                total_bytes=s.total_bytes,
                spill_bytes=s.spill_bytes,
            )
            self.samples.append(sample)
            if self._collector is not None:
                try:
                    self._collector.call_oneway("store_sample", sample.num_objects, sample.total_bytes, sample.spill_bytes)
                except ActorDiedError:
                    pass  # the collector went away; keep sampling locally
            if metrics.enabled():
                try:
                    self._sample_metrics(sample)
                except Exception:
                    pass  # telemetry never sinks the sampler

    def __enter__(self):
        self._thread = threading.Thread(target=self._loop, name="store-stats", daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=2 * self._period)
        return False


def _write_rows(f, rows: List[Dict], write_header: bool) -> None:
    writer = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
    if write_header:
        writer.writeheader()
    writer.writerows(rows)


def _check_append_schema(header_line: str, rows: List[Dict], path: str) -> None:
    """Rows appended under an older header would shift every value after
    a schema change without an error; refuse instead."""
    existing = next(csv.reader([header_line])) if header_line.strip() else []
    current = list(rows[0].keys())
    if existing != current:
        diff = "existing header is empty"
        for i in range(max(len(existing), len(current))):
            a = existing[i] if i < len(existing) else "<missing>"
            b = current[i] if i < len(current) else "<missing>"
            if a != b:
                diff = f"first difference at column {i}: {a!r} vs {b!r}"
                break
        raise ValueError(
            f"cannot append to {path}: its header ({len(existing)} cols) "
            f"does not match the current stats schema ({len(current)} "
            f"cols; {diff}). The file predates a schema change — use "
            "overwrite_stats=True or a new stats dir."
        )


def _write_csv(path: str, rows: List[Dict], overwrite: bool) -> None:
    if not rows:
        return
    write_header = overwrite or not os.path.exists(path)
    if not write_header:
        with open(path, newline="") as f:
            _check_append_schema(f.readline(), rows, path)
    with open(path, "w" if overwrite else "a", newline="") as f:
        _write_rows(f, rows, write_header)


def process_stats(
    all_trial_stats: Sequence[TrialStats],
    stats_dir: str = ".",
    overwrite_stats: bool = True,
    trial_csv: str = "trial_stats.csv",
    epoch_csv: str = "epoch_stats.csv",
    consume_csv: str = "consume_timeline.csv",
) -> Dict[str, float]:
    """Write the trial, epoch and consumer-timeline CSVs under the local
    directory ``stats_dir`` and return the summary across trials (mean and
    standard deviation of the duration, mean throughputs)."""
    os.makedirs(stats_dir, exist_ok=True)
    trial_rows = [t.row() for t in all_trial_stats]
    epoch_rows = [e.row(t.trial) for t in all_trial_stats for e in t.epochs]
    consume_rows = [
        {
            "trial": t.trial,
            "epoch": c.epoch,
            "rank": c.rank,
            "time_since_epoch_start": c.time_since_epoch_start,
            "nbytes": c.nbytes,
        }
        for t in all_trial_stats
        for e in t.epochs
        for c in e.consume_records
    ]
    _write_csv(os.path.join(stats_dir, trial_csv), trial_rows, overwrite_stats)
    _write_csv(os.path.join(stats_dir, epoch_csv), epoch_rows, overwrite_stats)
    _write_csv(os.path.join(stats_dir, consume_csv), consume_rows, overwrite_stats)

    durations = [t.duration for t in all_trial_stats]
    return {
        "num_trials": len(all_trial_stats),
        "duration_mean": float(np.mean(durations)) if durations else 0.0,
        "duration_std": float(np.std(durations)) if durations else 0.0,
        "row_throughput_mean": float(np.mean([t.row_throughput for t in all_trial_stats]))
        if all_trial_stats
        else 0.0,
        "batch_throughput_mean": float(np.mean([t.batch_throughput for t in all_trial_stats]))
        if all_trial_stats
        else 0.0,
    }


def human_readable_big_num(num: float) -> str:
    for magnitude, suffix in ((12, "T"), (9, "B"), (6, "M"), (3, "K")):
        if abs(num) >= 10**magnitude:
            value = num / 10**magnitude
            return f"{value:.0f}{suffix}" if value == int(value) else f"{value:.1f}{suffix}"
    return f"{num:.0f}" if num == int(num) else f"{num:.1f}"


def human_readable_size(num: float, precision: int = 1) -> str:
    for unit in ("B", "KiB", "MiB", "GiB", "TiB", "PiB"):
        if abs(num) < 1024.0:
            return f"{num:.{precision}f} {unit}"
        num /= 1024.0
    return f"{num:.{precision}f} EiB"
