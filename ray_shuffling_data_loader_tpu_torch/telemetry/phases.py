"""Per-phase cost inside a stage task.

A stage task's whole duration says little about where it went. A
:class:`StageProfiler` times the named phases inside one task (decode,
partition-scatter, window-fetch, permute, gather, publish, and the
stager's pack, device_put and sync) and feeds both telemetry halves:

* **metrics**: one histogram per ``(stage, phase)``,
  ``shuffle.phase_seconds{phase=P,stage=S}``, and a byte counter
  ``shuffle.phase_bytes{phase=P,stage=S}`` when the phase reports the
  bytes it moved. A worker's observations reach the driver through the
  task-done spool (:mod:`.export`);
* **trace**: a retroactive span per phase (``map:decode:arrow``,
  ``reduce:gather``, ...) on the worker's timeline.

With both halves off and ``RSDL_PROFILE`` unset, :func:`stage_profiler`
returns a shared no-op object: one cached boolean per stage, nothing
allocated in the hot loops. A profiler belongs to the thread that runs
its task, and takes no lock.

This module imports the standard library only.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

from ray_shuffling_data_loader_tpu_torch.telemetry import _env
from ray_shuffling_data_loader_tpu_torch.telemetry import metrics as _metrics
from ray_shuffling_data_loader_tpu_torch.telemetry import trace as _trace

# Active-phase registry for a sampling profiler: thread
# ident -> (stage, phase, stage_args). A _Phase publishes itself here on
# enter and restores the previous entry on exit, so the profiler's
# sampler thread — which cannot read another thread's contextvars — can
# tag each sampled stack with the phase that thread is inside RIGHT NOW.
# Plain dict ops under the GIL; readers take a point-in-time copy.
_ACTIVE: Dict[int, Tuple[str, str, dict]] = {}

_profile_armed: Optional[bool] = None


def profile_armed() -> bool:
    """The cached ``RSDL_PROFILE`` flag: it arms phase tracking (real
    StageProfilers) for a sampling profiler without importing one."""
    global _profile_armed
    if _profile_armed is None:
        _profile_armed = _env.read_flag("RSDL_PROFILE")
    return _profile_armed


def refresh_from_env() -> None:
    global _profile_armed
    _profile_armed = None
    import sys

    facade = sys.modules.get(__name__.rpartition(".")[0])
    if facade is not None:
        facade._profile_flag = None

# The phase vocabulary (the JAX package's). Not enforced —
# new call sites may add phases — but keeping names here documents the
# metric series a dashboard can rely on.
PHASES = (
    # Decode sub-phases.
    "decode:io",         # Parquet open + footer/metadata parse
    "decode:arrow",      # decompress + decode + column assembly
    "decode:narrow",     # 64->32-bit cast passes (was "narrow")
    "cache-publish",     # decoded-columns cache segment write (map)
    "partition-scatter", # stable group-by-reducer scatter (map)
    "plan",              # index-only assignment + argsort (plan)
    "window-fetch",      # mapper-partition window mmap/DCN fetch (reduce)
    "permute",           # epoch permutation draw (reduce)
    "gather",            # concat-take / sparse gather passes (reduce)
    "publish",           # output segment seal / slice publish (all)
    # Staging sub-phases (stage="staging").
    "rebatch",           # carry-buffer re-cut of reducer outputs (host)
    "pack",              # host-side [n_cols, batch] pack / dtype convert
    "device_put",        # host-to-device copy dispatch
    "sync",              # on-device unpack dispatch (where a backed-up
                         # transfer queue would block the stager)
)


class _NullPhase:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def add_bytes(self, n: int) -> None:
        pass


class _NullProfiler:
    """Shared no-op stand-in while both telemetry halves are off."""

    __slots__ = ()

    def phase(self, name: str, nbytes: Optional[int] = None):
        return _NULL_PHASE

    def totals(self) -> Dict[str, float]:
        return {}

    def wall(self) -> float:
        return 0.0


_NULL_PHASE = _NullPhase()
_NULL = _NullProfiler()


class _Phase:
    """One timed phase; records into the owning profiler on exit."""

    __slots__ = ("_prof", "name", "nbytes", "_wall0", "_t0", "_prev")

    def __init__(self, prof: "StageProfiler", name: str,
                 nbytes: Optional[int]):
        self._prof = prof
        self.name = name
        self.nbytes = nbytes

    def add_bytes(self, n: int) -> None:
        """Report bytes discovered mid-phase (e.g. decode learns the
        batch size only after reading)."""
        self.nbytes = (self.nbytes or 0) + int(n)

    def __enter__(self) -> "_Phase":
        ident = threading.get_ident()
        self._prev = _ACTIVE.get(ident)
        # rsdl-lint: disable=lock-discipline -- keyed by this thread's
        # own ident: no two threads touch the same key, and the
        # profiler's cross-thread read takes a dict() copy
        _ACTIVE[ident] = (self._prof.stage, self.name, self._prof.args)
        self._wall0 = time.time()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        dur = time.perf_counter() - self._t0
        ident = threading.get_ident()
        if self._prev is None:
            # rsdl-lint: disable=lock-discipline -- this thread's own
            # ident key only (see __enter__)
            _ACTIVE.pop(ident, None)
        else:
            # rsdl-lint: disable=lock-discipline -- this thread's own
            # ident key only (see __enter__)
            _ACTIVE[ident] = self._prev  # nested phase: restore outer
        self._prof._record(self.name, self._wall0, dur, self.nbytes)
        return False


class StageProfiler:
    """Phase timer for one stage-task execution.

    Usage (inside a map/reduce task body)::

        prof = stage_profiler("reduce", epoch=epoch, reducer=r)
        with prof.phase("window-fetch", nbytes=total):
            ...
        with prof.phase("gather") as ph:
            ...
            ph.add_bytes(moved)

    Instruments resolve lazily per record (registry get-or-create is a
    dict hit); sub-spans are recorded retroactively so a phase costs two
    clock reads plus one histogram observe.
    """

    __slots__ = ("stage", "args", "_phases")

    def __init__(self, stage: str, **args):
        self.stage = stage
        self.args = args
        self._phases: List[Tuple[str, float]] = []

    def phase(self, name: str, nbytes: Optional[int] = None) -> _Phase:
        return _Phase(self, name, nbytes)

    def _record(self, name: str, wall0: float, dur: float,
                nbytes: Optional[int]) -> None:
        self._phases.append((name, dur))
        try:
            if _metrics.enabled():
                _metrics.registry.histogram(
                    "shuffle.phase_seconds", phase=name, stage=self.stage
                ).observe(dur)
                if nbytes:
                    _metrics.registry.counter(
                        "shuffle.phase_bytes", phase=name, stage=self.stage
                    ).inc(float(nbytes))
            if _trace.enabled():
                span_args = dict(self.args)
                if nbytes:
                    span_args["nbytes"] = int(nbytes)
                _trace.record_span(
                    f"{self.stage}:{name}", wall0, dur,
                    cat="shuffle-phase", **span_args,
                )
        except Exception:
            # Telemetry must never raise into a stage task body.
            pass

    def totals(self) -> Dict[str, float]:
        """Accumulated seconds per phase (a phase entered twice sums)."""
        out: Dict[str, float] = {}
        for name, dur in self._phases:
            out[name] = out.get(name, 0.0) + dur
        return out

    def wall(self) -> float:
        """Sum of all recorded phase durations."""
        return sum(d for _, d in self._phases)


def stage_profiler(stage: str, **args):
    """A :class:`StageProfiler` when either telemetry half is on — or
    the sampling profiler is armed (``RSDL_PROFILE``), which needs the
    active-phase registry populated even with metrics and trace off —
    else the shared no-op (the disabled path allocates nothing)."""
    if _metrics.enabled() or _trace.enabled() or profile_armed():
        return StageProfiler(stage, **args)
    return _NULL


def active_phases() -> Dict[int, Tuple[str, str, dict]]:
    """Point-in-time copy of the active-phase registry (profiler join,
    tests)."""
    return dict(_ACTIVE)
