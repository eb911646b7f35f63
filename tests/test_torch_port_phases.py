"""The port's phase profiler (the counterparts of ``tests/test_phases.py``):
one shared no-op with every plane off, phase timers that sum to the stage's
wall time, the ``shuffle.phase_seconds`` and ``shuffle.phase_bytes``
series, a repeated phase accumulating, the map task's phases against the
JAX package's, and the overlapped reduce equal to the fused one, its
windows timed one by one."""

import importlib
import time

import numpy as np
import pytest

from ray_shuffling_data_loader_tpu_torch import telemetry
from ray_shuffling_data_loader_tpu_torch.telemetry import metrics, phases, trace

ROOTS = {"jax": "ray_shuffling_data_loader_tpu", "port": "ray_shuffling_data_loader_tpu_torch"}


def _refresh():
    metrics.refresh_from_env()
    trace.refresh_from_env()
    phases.refresh_from_env()


@pytest.fixture
def telemetry_off(monkeypatch):
    for key in ("RSDL_METRICS", "RSDL_TRACE", "RSDL_PROFILE"):
        monkeypatch.delenv(key, raising=False)
    _refresh()
    yield
    monkeypatch.undo()
    _refresh()


@pytest.fixture
def metrics_on(monkeypatch):
    monkeypatch.setenv("RSDL_METRICS", "1")
    for key in ("RSDL_TRACE", "RSDL_PROFILE", "RSDL_METRICS_DIR"):
        monkeypatch.delenv(key, raising=False)
    _refresh()
    metrics.reset()
    yield
    metrics.reset()
    monkeypatch.undo()
    _refresh()


def test_disabled_returns_shared_noop(telemetry_off):
    before = set(metrics.registry.snapshot())
    p1 = phases.stage_profiler("map", epoch=0)
    p2 = phases.stage_profiler("reduce")
    assert p1 is p2 is phases._NULL
    # The facade's gate hands back its own shared no-op, without the module.
    assert telemetry.stage_profiler("map", epoch=0) is telemetry.stage_profiler("reduce")
    for prof in (p1, telemetry.stage_profiler("map")):
        with prof.phase("decode") as ph:
            ph.add_bytes(123)
        assert prof.totals() == {}
        assert prof.wall() == 0.0
    assert set(metrics.registry.snapshot()) == before


def test_phase_timers_sum_to_stage_wall(metrics_on):
    prof = telemetry.stage_profiler("map", epoch=1, file=0)
    assert isinstance(prof, phases.StageProfiler)
    t0 = time.perf_counter()
    with prof.phase("decode") as ph:
        time.sleep(0.02)
        ph.add_bytes(1000)
    with prof.phase("partition-scatter", nbytes=2000):
        time.sleep(0.03)
    wall = time.perf_counter() - t0
    totals = prof.totals()
    assert set(totals) == {"decode", "partition-scatter"}
    assert totals["decode"] >= 0.02
    assert totals["partition-scatter"] >= 0.03
    # Within the bookkeeping between the phases: 20 ms on a loaded host.
    assert abs(prof.wall() - wall) < 0.02
    assert prof.wall() == pytest.approx(sum(totals.values()))


def test_phase_metrics_series(metrics_on):
    prof = telemetry.stage_profiler("reduce", epoch=0, reducer=3)
    with prof.phase("gather", nbytes=500):
        pass
    with prof.phase("gather") as ph:
        ph.add_bytes(300)
    with prof.phase("publish"):
        pass
    snap = metrics.registry.snapshot()
    hkey = metrics.format_key("shuffle.phase_seconds", {"phase": "gather", "stage": "reduce"})
    assert snap[f"{hkey}_count"] == 2
    assert snap[metrics.format_key("shuffle.phase_bytes", {"phase": "gather", "stage": "reduce"})] == 800
    pkey = metrics.format_key("shuffle.phase_seconds", {"phase": "publish", "stage": "reduce"})
    assert snap[f"{pkey}_count"] == 1
    assert metrics.format_key("shuffle.phase_bytes", {"phase": "publish", "stage": "reduce"}) not in snap


def test_repeated_phase_accumulates(metrics_on):
    prof = telemetry.stage_profiler("reduce", epoch=0, reducer=0)
    for _ in range(4):
        with prof.phase("window-fetch", nbytes=10):
            pass
    assert list(prof.totals()) == ["window-fetch"]
    hkey = metrics.format_key("shuffle.phase_seconds", {"phase": "window-fetch", "stage": "reduce"})
    assert metrics.registry.snapshot()[f"{hkey}_count"] == 4


@pytest.fixture
def port_runtime():
    from ray_shuffling_data_loader_tpu_torch import runtime

    ctx = runtime.init(num_workers=1)
    yield ctx
    runtime.shutdown()


def test_shuffle_map_records_phases(port_runtime, local_runtime, metrics_on, tmp_path):
    """A map run in this process registers the map's phase series; the
    JAX package's map over the same file registers the same keys, kinds
    and bytes."""
    from ray_shuffling_data_loader_tpu_torch.data_generation import generate_data

    filenames, _ = generate_data(400, 1, 1, 0.0, str(tmp_path))
    out = {}
    for pkg, ctx in (("jax", local_runtime), ("port", port_runtime)):
        mod = importlib.import_module(f"{ROOTS[pkg]}.telemetry.metrics")
        mod.refresh_from_env()
        mod.reset()
        refs = importlib.import_module(f"{ROOTS[pkg]}.shuffle").shuffle_map(filenames[0], 0, 2, epoch=0, seed=1)
        ctx.store.free(refs)
        out[pkg] = (mod.registry.kinds(), {k: v for k, v in mod.registry.snapshot().items() if "phase_bytes" in k})
        mod.reset()
    kinds, phase_bytes = out["port"]
    snap_keys = set(kinds)
    for phase in ("decode:arrow", "partition-scatter", "publish"):
        assert metrics.format_key("shuffle.phase_seconds", {"phase": phase, "stage": "map"}) in snap_keys, phase
    assert phase_bytes[metrics.format_key("shuffle.phase_bytes", {"phase": "decode:arrow", "stage": "map"})] > 0
    assert out["port"] == out["jax"]


def test_overlapped_reduce_matches_fused(port_runtime, metrics_on, monkeypatch, tmp_path):
    """``RSDL_REDUCE_FETCH_OVERLAP=on`` (forced, local refs) gives the
    fused reduce's bits; its windows are timed one by one."""
    from ray_shuffling_data_loader_tpu_torch.data_generation import generate_data
    from ray_shuffling_data_loader_tpu_torch.shuffle import shuffle_map, shuffle_reduce

    filenames, _ = generate_data(1200, 3, 1, 0.0, str(tmp_path))
    store = port_runtime.store
    num_reducers = 4
    fetch_key = metrics.format_key("shuffle.phase_seconds", {"phase": "window-fetch", "stage": "reduce"})

    def reduce_all(mode):
        monkeypatch.setenv("RSDL_REDUCE_FETCH_OVERLAP", mode)
        metrics.reset()
        per_file = [shuffle_map(f, i, num_reducers, epoch=2, seed=9) for i, f in enumerate(filenames)]
        outs = []
        for r in range(num_reducers):
            out_ref = shuffle_reduce(r, epoch=2, seed=9, part_refs=[refs[r] for refs in per_file])
            outs.append({k: np.array(v) for k, v in store.get_columns(out_ref).items()})
            store.free(out_ref)
        for refs in per_file:
            store.free(refs)
        return outs, metrics.registry.snapshot()[f"{fetch_key}_count"]

    fused, fused_fetches = reduce_all("off")
    overlapped, overlapped_fetches = reduce_all("on")
    for a, b in zip(fused, overlapped):
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    assert fused_fetches == num_reducers  # one fetch phase of every window at once
    assert overlapped_fetches == num_reducers * len(filenames)  # one per window
