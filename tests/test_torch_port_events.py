"""The port's event log (the counterparts of ``tests/test_events.py``):
emit, flush, load and counts, the trace context riding the records, the
facade's no-op with metrics off, the flush before a task reports done, and
a torn tail line skipped. Then recovery against the JAX package: under one
seeded fault schedule (the decisions of ``test_torch_port_faults.py``),
both count the same ``recovery.stage_retries`` and
``recovery.rematerialized`` by stage and ``faults.injected`` by site and
kind, and log one ``stage.retry`` event per retry."""

import collections
import importlib
import os
import time

import pytest

from ray_shuffling_data_loader_tpu_torch import runtime, telemetry
from ray_shuffling_data_loader_tpu_torch.telemetry import events, metrics

ROOTS = {"jax": "ray_shuffling_data_loader_tpu", "port": "ray_shuffling_data_loader_tpu_torch"}
_ENV = ("RSDL_METRICS", "RSDL_METRICS_DIR", "RSDL_EVENTS_DIR", "RSDL_TRACE", "RSDL_TRACE_DIR", "RSDL_FAULTS",
        "RSDL_FAULTS_SEED", "RSDL_AUDIT", "RSDL_INDEX_SHUFFLE", "RSDL_SELECTIVE_READS", "RSDL_JOURNAL", "RSDL_PLAN",
        "RSDL_SHUFFLE_PLAN", "RSDL_STAGE_MAX_ATTEMPTS")


def _mod(pkg, name):
    return importlib.import_module(f"{ROOTS[pkg]}.{name}")


def _refresh(pkg):
    _mod(pkg, "telemetry.metrics").refresh_from_env()
    _mod(pkg, "telemetry.metrics").reset()
    _mod(pkg, "telemetry").refresh_from_env()
    _mod(pkg, "telemetry.events").reset()
    _mod(pkg, "runtime.faults").refresh_from_env()


@pytest.fixture
def events_env(monkeypatch, tmp_path):
    for key in _ENV:
        monkeypatch.delenv(key, raising=False)
    spool = str(tmp_path / "events-spool")
    monkeypatch.setenv("RSDL_METRICS", "1")
    monkeypatch.setenv("RSDL_METRICS_DIR", str(tmp_path / "metrics-spool"))
    monkeypatch.setenv("RSDL_EVENTS_DIR", spool)
    _refresh("port")
    events.reset(clear_spool=True)
    yield spool
    events.reset(clear_spool=True)
    monkeypatch.undo()
    _refresh("port")


def test_emit_flush_load_counts(events_env):
    events.emit("epoch.start", epoch=0, schedule="mapreduce")
    events.emit("epoch.done", epoch=0)
    events.emit("stage.retry", epoch=0, stage="map", attempt=1)
    assert [r["kind"] for r in events.load()] == ["epoch.start", "epoch.done", "stage.retry"]
    events.flush()
    assert os.listdir(events_env) == [f"events-{os.getpid()}.ndjson"]
    loaded = events.load()
    assert len(loaded) == 3
    assert loaded[0]["pid"] == os.getpid()
    assert loaded[0]["role"] == "driver"
    assert loaded[0]["schedule"] == "mapreduce"
    assert events.counts() == {"epoch.start": 1, "epoch.done": 1, "stage.retry": 1}


def test_load_filters(events_env):
    t0 = time.time()
    events.emit("a.one")
    events.emit("a.two")
    events.emit("a.two")
    assert [r["kind"] for r in events.load(kind="a.two")] == ["a.two", "a.two"]
    assert len(events.load(since=t0 - 1)) == 3
    assert events.load(since=time.time() + 60) == []
    assert len(events.load(limit=2)) == 2


def test_trace_context_rides_records(events_env):
    with telemetry.context(trial=1, epoch=5):
        events.emit("epoch.start")
        events.emit("epoch.start", epoch=6)  # an explicit field wins
    first, second = events.load()
    assert first["trial"] == 1 and first["epoch"] == 5
    assert second["epoch"] == 6


def test_facade_noop_when_metrics_off(events_env):
    metrics.disable()
    telemetry.emit_event("should.not.appear")
    events.emit("also.should.not.appear")
    metrics.enable()
    metrics.refresh_from_env()
    assert events.load() == []
    assert not os.path.isdir(events_env) or not os.listdir(events_env)


def test_event_flush_before_task_done(events_env):
    """A resolved task future implies the worker's events are on the
    spool: no sleep, no polling."""
    from torch_port_helpers import emitting_task

    ctx = runtime.init(num_workers=1)
    try:
        assert ctx.pool.submit(emitting_task, 21).result(timeout=120) == 42
        recs = events.load(kind="test.worker_event")
        assert len(recs) == 1
        assert recs[0]["payload"] == 21
        assert recs[0]["pid"] != os.getpid()
        assert recs[0]["role"] == "task"
    finally:
        runtime.shutdown()


def test_torn_tail_line_skipped(events_env):
    events.emit("whole.record")
    events.flush()
    with open(os.path.join(events_env, f"events-{os.getpid()}.ndjson"), "a") as f:
        f.write('{"kind": "torn.rec')  # a crash mid-append
    assert [r["kind"] for r in events.load()] == ["whole.record"]


# -- recovery against the JAX package ------------------------------------------------


NUM_FILES, ROWS_PER_FILE, NUM_REDUCERS, SEED = 4, 400, 4, 5


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Written in this process: no pool starts before a case arms its
    schedule."""
    from ray_shuffling_data_loader_tpu.data_generation import generate_file

    data = tmp_path_factory.mktemp("recovery-data")
    return [generate_file(i, i * ROWS_PER_FILE, ROWS_PER_FILE, 1, str(data))[0] for i in range(NUM_FILES)]


def _recovered_run(pkg, spool, files):
    """One 1-epoch shuffle of ``pkg`` in a one-worker session (the fault
    decisions then fall on the same invocations in both packages): the
    aggregated counters and the event log."""
    from torch_port_helpers import Drain

    rt = _mod(pkg, "runtime")
    rt.init(num_workers=1)
    try:
        _mod(pkg, "shuffle").shuffle(files, Drain(rt), 1, NUM_REDUCERS, 1, seed=SEED)
        export = _mod(pkg, "telemetry.export")
        flat = export.aggregate()
        logged = _mod(pkg, "telemetry.events").load()
    finally:
        rt.shutdown()
    sums = {name: export.labeled_sum(flat, name)
            for name in ("recovery.stage_retries", "recovery.rematerialized", "faults.injected")}
    return sums, logged


@pytest.mark.parametrize(
    "spec, seed, expect",
    [
        # The worker's first map fails at its entry: one map retry.
        ("task.map:crash-entry:1x1", 11, {"recovery.stage_retries": {"{stage=map}": 1.0},
                                          "faults.injected": {"{kind=crash,site=task.map}": 1.0}}),
        # The worker's first store read reports its object lost: a reduce
        # retries after its lineage re-made the map.
        ("store.get/task:lost:1x1", 17, {"recovery.stage_retries": {"{stage=reduce}": 1.0},
                                         "recovery.rematerialized": {"{stage=map}": 1.0},
                                         "faults.injected": {"{kind=lost,site=store.get}": 1.0}}),
    ],
)
def test_recovery_counts_equal_jax(monkeypatch, tmp_path, files, spec, seed, expect):
    for key in _ENV:
        monkeypatch.delenv(key, raising=False)
    out = {}
    for pkg in ROOTS:
        for key, value in {"RSDL_METRICS": "1", "RSDL_METRICS_DIR": str(tmp_path / pkg / "metrics"),
                           "RSDL_EVENTS_DIR": str(tmp_path / pkg / "events"), "RSDL_FAULTS": spec,
                           "RSDL_FAULTS_SEED": str(seed)}.items():
            monkeypatch.setenv(key, value)
        _refresh(pkg)
        try:
            out[pkg] = _recovered_run(pkg, tmp_path / pkg, files)
        finally:
            for key in _ENV:
                monkeypatch.delenv(key, raising=False)
            _refresh(pkg)
    (jsums, jlog), (psums, plog) = out["jax"], out["port"]
    assert psums == jsums
    for name in ("recovery.stage_retries", "recovery.rematerialized", "faults.injected"):
        assert psums[name][1] == expect.get(name, {}), name
    retries = sum(psums["recovery.stage_retries"][1].values())
    for logged in (jlog, plog):
        kinds = collections.Counter(e["kind"] for e in logged)
        assert kinds["stage.retry"] == retries
        assert kinds["recovery"] == retries + sum(psums["recovery.rematerialized"][1].values())
        assert kinds["epoch.done"] == 1
    stage_retry = lambda log: sorted((e["stage"], e["attempt"], e["error"]) for e in log if e["kind"] == "stage.retry")  # noqa: E731
    assert stage_retry(plog) == stage_retry(jlog)
