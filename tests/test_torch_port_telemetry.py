"""The port's metrics and trace planes against the JAX package's.

The counterparts of ``tests/test_telemetry.py``: span nesting and context
propagation (across the port's actor and task boundaries), the
Chrome-trace schema, the metrics registry, sources and Prometheus text,
and the end-to-end run whose trace shows map, reduce, admission and
staging spans of two overlapping epochs beside a metrics dump with
queue-depth and stall-by-cause series.

Then the parity checks, each package run after the other with spools of
its own and its cached flags refreshed in between (both read the same
``RSDL_*`` variables):

* the registry: one seeded sequence of counter, gauge and histogram
  operations through both, with labels that need sanitizing and
  histograms never observed: equal typed snapshots, byte-identical
  Prometheus text, equal progress lines;
* the export: spool records written by the JAX package's ``flush`` for
  several sources, loaded and merged by both;
* a delivery run with metrics and trace on (4096 rows, 2 files, 2
  reducers, 2 epochs, ``device="cpu"``): the same key stream, metric keys
  and kinds, deterministic counters, span multiset and event kinds;
* the gate: with every plane off a fresh interpreter's delivery run
  imports none of the plane modules (trace, export, events, phases, the
  straggler, critical-path, capacity, time-series, profiler and run-ledger
  planes, and the knob registry), in the driver or in a worker, and runs
  no sampler thread; with ``RSDL_METRICS=1`` both load the metrics and
  trace planes, the task records and the capacity ledger; with every gate
  on, every plane loads and the run leaves one ledger record.

Comparisons are exact unless a tolerance is stated."""

import collections
import contextlib
import importlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

ROOTS = {"jax": "ray_shuffling_data_loader_tpu", "port": "ray_shuffling_data_loader_tpu_torch"}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.dirname(os.path.abspath(__file__))
PLANE_ENV = ("RSDL_TRACE", "RSDL_METRICS", "RSDL_TRACE_DIR", "RSDL_METRICS_DIR", "RSDL_EVENTS_DIR",
             "RSDL_TRACE_BUFFER", "RSDL_PROFILE", "RSDL_INDEX_SHUFFLE", "RSDL_FAULTS", "RSDL_FAULTS_SEED",
             "RSDL_AUDIT", "RSDL_SELECTIVE_READS", "RSDL_SHUFFLE_PLAN", "RSDL_PLAN", "RSDL_JOURNAL")


def _mod(pkg, name):
    return importlib.import_module(f"{ROOTS[pkg]}.{name}")


def _refresh(pkg):
    """Forget ``pkg``'s cached plane flags and drop its buffers."""
    telemetry, metrics = _mod(pkg, "telemetry"), _mod(pkg, "telemetry.metrics")
    telemetry.refresh_from_env()
    metrics.refresh_from_env()
    _mod(pkg, "telemetry.phases").refresh_from_env()
    _mod(pkg, "runtime.faults").refresh_from_env()
    telemetry.reset_state()
    metrics.reset()
    _mod(pkg, "telemetry.events").reset()


@pytest.fixture
def planes(monkeypatch, tmp_path):
    """``planes(pkg, **env)``: a context with ``pkg``'s metrics and trace on,
    spooling under ``tmp_path/pkg``, its flags and buffers fresh; both
    packages are refreshed again when the test ends."""
    for key in PLANE_ENV:
        monkeypatch.delenv(key, raising=False)

    @contextlib.contextmanager
    def use(pkg, **env):
        spool = tmp_path / pkg
        values = {"RSDL_METRICS": "1", "RSDL_TRACE": "1", "RSDL_TRACE_DIR": str(spool / "trace"),
                  "RSDL_METRICS_DIR": str(spool / "metrics"), "RSDL_EVENTS_DIR": str(spool / "events"), **env}
        for key, value in values.items():
            monkeypatch.setenv(key, value)
        _refresh(pkg)
        try:
            yield spool
        finally:
            for key in values:
                monkeypatch.delenv(key, raising=False)
            _refresh(pkg)

    yield use
    monkeypatch.undo()
    for pkg in ROOTS:
        _refresh(pkg)


@pytest.fixture
def telemetry_on(planes):
    """The port's tracing and metrics on, spooling to a per-test dir."""
    with planes("port") as spool:
        yield str(spool / "trace")


@pytest.fixture
def traced_runtime(telemetry_on):
    """A port session made after the planes were armed, so that its workers
    and actors inherit them."""
    rt = _mod("port", "runtime")
    ctx = rt.init(num_workers=2)
    yield ctx
    rt.shutdown()


def _load_trace(path):
    with open(path) as f:
        payload = json.load(f)
    assert set(payload) >= {"traceEvents"}
    events = payload["traceEvents"]
    assert isinstance(events, list)
    for e in events:
        assert {"name", "ph", "pid", "tid"} <= set(e), e
        if e["ph"] == "X":
            assert "ts" in e and "dur" in e and e["dur"] >= 0, e
    return events


def _spans(events, name=None, cat=None):
    out = [e for e in events if e["ph"] == "X"]
    if name is not None:
        out = [e for e in out if e["name"] == name]
    if cat is not None:
        out = [e for e in out if e.get("cat") == cat]
    return out


# -- the tracing core ----------------------------------------------------------------


def test_disabled_tracing_is_noop(monkeypatch, tmp_path):
    from ray_shuffling_data_loader_tpu_torch import telemetry
    from ray_shuffling_data_loader_tpu_torch.telemetry import metrics

    for key in PLANE_ENV:
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setenv("RSDL_TRACE_DIR", str(tmp_path / "empty-spool"))
    _refresh("port")
    telemetry.disable()
    metrics.disable()
    telemetry.reset_state()
    try:
        # One shared null object: no allocation, no clock read.
        assert telemetry.trace_span("a") is telemetry.trace_span("b")
        assert telemetry.span("a") is telemetry.scope(epoch=1) is telemetry.stage_profiler("map")
        with telemetry.trace_span("a") as sp:
            sp.set(x=1)
        telemetry.record_span("late", 0.0, 1.0)
        telemetry.instant("tick")
        out = telemetry.trace_export(str(tmp_path / "t.json"))
        assert _load_trace(out) == []
        assert not metrics.enabled()
        assert telemetry.outbound() is None
    finally:
        monkeypatch.undo()
        _refresh("port")


def test_span_nesting_context_and_schema(telemetry_on, tmp_path):
    from ray_shuffling_data_loader_tpu_torch import telemetry

    with telemetry.context(trial=1):
        with telemetry.trace_span("outer", cat="t"):
            with telemetry.context(epoch=2):
                with telemetry.trace_span("inner", cat="t", extra="x"):
                    pass
    telemetry.record_span("retro", 100.0, 0.25, cat="t", epoch=9)
    telemetry.instant("tick", cat="t")
    events = _load_trace(telemetry.trace_export(str(tmp_path / "trace.json")))
    (outer,) = _spans(events, "outer")
    (inner,) = _spans(events, "inner")
    (retro,) = _spans(events, "retro")
    assert outer["args"]["trial"] == 1 and "epoch" not in outer["args"]
    assert inner["args"] == {"trial": 1, "epoch": 2, "extra": "x"}
    assert inner["tid"] == outer["tid"]
    assert inner["ts"] >= outer["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + 1  # 1 us: the clocks' rounding
    assert retro["ts"] == pytest.approx(100.0 * 1e6)
    assert retro["dur"] == pytest.approx(0.25 * 1e6)
    assert events[0]["ph"] == "M"
    assert any(e["ph"] == "i" and e["name"] == "tick" for e in events)


def test_span_error_attr_and_buffer_cap(telemetry_on, tmp_path, monkeypatch):
    from ray_shuffling_data_loader_tpu_torch import telemetry

    with pytest.raises(ValueError):
        with telemetry.trace_span("fails"):
            raise ValueError("boom")
    monkeypatch.setenv("RSDL_TRACE_BUFFER", "4")
    telemetry.refresh_from_env()  # the buffer limit is cached per process
    try:
        for i in range(32):
            telemetry.record_span(f"s{i}", 0.0, 0.1)
        assert telemetry.dropped_events() > 0
    finally:
        monkeypatch.delenv("RSDL_TRACE_BUFFER")
        telemetry.refresh_from_env()
    events = _load_trace(telemetry.trace_export(str(tmp_path / "t.json")))
    (failed,) = _spans(events, "fails")
    assert failed["args"]["error"] == "ValueError"


def test_context_propagates_across_actor_boundary(traced_runtime, tmp_path):
    from ray_shuffling_data_loader_tpu_torch import runtime, telemetry
    from torch_port_helpers import ProbeActor

    h = runtime.spawn_actor(ProbeActor)
    try:
        with telemetry.context(trial=7, epoch=3):
            remote_ctx = h.call("work", "t1")
    finally:
        h.terminate(grace_period_s=5.0)  # the actor flushes its spool at exit
    assert remote_ctx["trial"] == 7 and remote_ctx["epoch"] == 3
    events = _load_trace(telemetry.trace_export(str(tmp_path / "t.json")))
    (dispatch,) = _spans(events, "actor:work")
    (inner,) = _spans(events, "probe:inner")
    assert dispatch["args"]["trial"] == 7
    assert inner["args"]["trial"] == 7 and inner["args"]["epoch"] == 3
    assert dispatch["pid"] != os.getpid()
    assert inner["pid"] == dispatch["pid"]
    # The dispatch ran on a virtual track of its own, named dispatch-N.
    names = {e["tid"]: e["args"]["name"] for e in events if e["name"] == "thread_name"}
    assert names[dispatch["tid"]].startswith("dispatch-")


def test_context_propagates_across_task_boundary(traced_runtime, tmp_path):
    from ray_shuffling_data_loader_tpu_torch import runtime, telemetry
    from torch_port_helpers import probe_task

    with telemetry.context(trial=5, epoch=1):
        remote_ctx = runtime.submit(probe_task, "t2").result(timeout=60)
    assert remote_ctx["trial"] == 5 and remote_ctx["epoch"] == 1
    events = _load_trace(telemetry.trace_export(str(tmp_path / "t.json")))
    (wrapper,) = _spans(events, "task:probe_task")
    (inner,) = _spans(events, "probe:task-inner")
    assert wrapper["args"]["trial"] == 5
    assert inner["args"]["epoch"] == 1
    assert wrapper["pid"] != os.getpid()


# -- metrics -------------------------------------------------------------------------------


def test_metrics_snapshot_roundtrip(telemetry_on, tmp_path):
    from ray_shuffling_data_loader_tpu_torch.telemetry import metrics

    reg = metrics.registry
    reg.counter("h2d.bytes").inc(100)
    reg.counter("h2d.bytes").inc(28)
    reg.gauge("queue.depth", epoch=0, rank=1).set(4)
    reg.histogram("h2d.dispatch_seconds").observe(0.5)
    reg.histogram("h2d.dispatch_seconds").observe(1.5)
    metrics.register_source("ext", lambda: {"ext.value": 9.0})
    snap = metrics.global_snapshot()
    assert snap["h2d.bytes"] == 128.0
    assert snap[metrics.format_key("queue.depth", {"epoch": 0, "rank": 1})] == 4.0
    assert snap["h2d.dispatch_seconds_count"] == 2.0
    assert snap["h2d.dispatch_seconds_sum"] == 2.0
    assert snap["h2d.dispatch_seconds_min"] == 0.5
    assert snap["h2d.dispatch_seconds_max"] == 1.5
    assert snap["ext.value"] == 9.0
    metrics.record_sample(snap, ts=123.0)
    with open(metrics.dump_json(str(tmp_path / "metrics.json"))) as f:
        payload = json.load(f)
    assert payload["samples"][0]["ts"] == 123.0
    assert payload["samples"][0]["values"]["h2d.bytes"] == 128.0
    assert payload["final"]["ext.value"] == 9.0
    assert "shm=" in metrics.progress_line(snap)


def test_metrics_dead_source_dropped(telemetry_on):
    from ray_shuffling_data_loader_tpu_torch.telemetry import metrics

    calls = []

    def dead():
        calls.append(1)
        raise RuntimeError("actor died")

    metrics.register_source("dead", dead)
    for _ in range(5):
        metrics.global_snapshot()
    assert len(calls) == metrics._SOURCE_MAX_FAILURES == 3


def test_type_conflict_rejected(telemetry_on):
    from ray_shuffling_data_loader_tpu_torch.telemetry import metrics

    metrics.registry.counter("x.bytes")
    with pytest.raises(TypeError):
        metrics.registry.gauge("x.bytes")


def test_histogram_zero_observations(telemetry_on):
    from ray_shuffling_data_loader_tpu_torch.telemetry import metrics

    metrics.registry.histogram("empty.hist")
    snap = metrics.registry.snapshot()
    assert snap["empty.hist_count"] == 0.0
    assert snap["empty.hist_sum"] == 0.0
    assert "empty.hist_min" not in snap and "empty.hist_max" not in snap
    text = metrics.to_prometheus_text(snap)
    assert "inf" not in text and "nan" not in text


def test_register_source_name_collision_replaces(telemetry_on):
    from ray_shuffling_data_loader_tpu_torch.telemetry import metrics

    metrics.register_source("s", lambda: {"v": 1.0})
    assert metrics.global_snapshot()["v"] == 1.0

    def dying():
        raise RuntimeError("old actor died")

    metrics.register_source("s", dying)
    metrics.global_snapshot()
    metrics.global_snapshot()
    metrics.register_source("s", lambda: {"v": 3.0})
    for _ in range(5):
        assert metrics.global_snapshot()["v"] == 3.0


def test_refresh_from_env_toggles_midrun(telemetry_on, monkeypatch):
    from ray_shuffling_data_loader_tpu_torch.telemetry import metrics

    assert metrics.enabled()
    monkeypatch.delenv("RSDL_METRICS")
    metrics.refresh_from_env()
    assert not metrics.enabled()
    monkeypatch.setenv("RSDL_METRICS", "1")
    assert not metrics.enabled()  # the cached boolean holds until refreshed
    metrics.refresh_from_env()
    assert metrics.enabled()


def test_to_prometheus_text_format(telemetry_on):
    from ray_shuffling_data_loader_tpu_torch.telemetry import metrics

    reg = metrics.registry
    reg.counter("h2d.bytes").inc(128)
    reg.counter("big.rows").inc(1_234_567)
    reg.gauge("queue.depth", epoch=0, rank=1).set(4)
    reg.histogram("h2d.dispatch_seconds").observe(0.5)
    reg.histogram("queue.wait", epoch=2).observe(1.0)
    text = metrics.to_prometheus_text(metrics.global_snapshot())
    lines = text.splitlines()
    assert lines[0].startswith("#")
    assert "rsdl_h2d_bytes 128" in text
    assert 'rsdl_queue_depth{epoch="0",rank="1"} 4' in text
    assert "rsdl_h2d_dispatch_seconds_count 1" in text
    assert "rsdl_h2d_dispatch_seconds_sum 0.5" in text
    assert "rsdl_big_rows 1234567\n" in text
    assert 'rsdl_queue_wait_count{epoch="2"} 1' in text
    assert "# HELP rsdl_h2d_bytes " in text
    assert "# TYPE rsdl_h2d_bytes counter" in text
    assert "# TYPE rsdl_queue_depth gauge" in text
    assert "# TYPE rsdl_h2d_dispatch_seconds_count counter" in text
    assert "# TYPE rsdl_h2d_dispatch_seconds_min gauge" in text
    idx = lines.index("# TYPE rsdl_h2d_bytes counter")
    assert lines[idx + 1].startswith("rsdl_h2d_bytes ")
    assert metrics.to_prometheus_text({"weird": float("nan"), "hot": float("inf")}).count("NaN") == 1
    names = [ln.split(" ", 2)[2].split(" ")[0] for ln in lines if ln.startswith("# TYPE ")]
    assert names == sorted(names)


# -- end to end ------------------------------------------------------------------------------


def test_e2e_shuffle_trace_and_metrics(traced_runtime, tmp_path):
    """A CPU delivery run: a Chrome trace with map, reduce, admission and
    staging spans of two overlapping epochs, and a metrics dump with the
    queue-depth and stall-by-cause series, sampled by the store sampler
    and forwarded to the trial collector."""
    from ray_shuffling_data_loader_tpu_torch import runtime, telemetry
    from ray_shuffling_data_loader_tpu_torch.data_generation import LABEL_COLUMN, generate_data
    from ray_shuffling_data_loader_tpu_torch.device_dataset import DeviceShufflingDataset
    from ray_shuffling_data_loader_tpu_torch.stats import ObjectStoreStatsCollector, TrialStatsCollector
    from ray_shuffling_data_loader_tpu_torch.telemetry import metrics

    filenames, _ = generate_data(4096, 2, 1, 0.0, str(tmp_path / "data"))
    stats_actor = runtime.spawn_actor(TrialStatsCollector, 2, 2, 2)
    telemetry.set_context(trial=0)
    ds = DeviceShufflingDataset(filenames, num_epochs=2, num_trainers=1, batch_size=512, rank=0,
                                feature_columns=["key"], label_column=LABEL_COLUMN, num_reducers=2,
                                max_concurrent_epochs=2, queue_name="q-port-telemetry-e2e", seed=3, device="cpu")
    with ObjectStoreStatsCollector(stats_actor, sample_period_s=0.05):
        for epoch in range(2):
            ds.set_epoch(epoch)
            for _features, _label in ds:
                # A trainer slower than the shuffle (50 ms a step): the
                # shuffle runs an epoch ahead, inside the window of 2.
                time.sleep(0.05)
    events = _load_trace(telemetry.trace_export(str(tmp_path / "trace.json")))
    for name in ("map", "reduce", "stage:h2d"):
        assert {0, 1} <= {s["args"]["epoch"] for s in _spans(events, name)}, name
    admissions = _spans(events, "epoch:admission")
    assert {s["args"]["epoch"] for s in admissions} == {0, 1}
    assert {s["args"]["epoch"] for s in _spans(events, "actor:new_epoch")} == {0, 1}
    assert os.getpid() not in {s["pid"] for s in _spans(events, "map")}
    assert {s["pid"] for s in admissions} == {os.getpid()}
    e0_stage_end = max(s["ts"] + s["dur"] for s in _spans(events, "stage:h2d") if s["args"]["epoch"] == 0)
    e1_map_start = min(s["ts"] for s in _spans(events, "map") if s["args"]["epoch"] == 1)
    assert e1_map_start < e0_stage_end
    with open(metrics.dump_json(str(tmp_path / "metrics.json"))) as f:
        payload = json.load(f)
    final = payload["final"]
    assert "queue.depth.total" in final
    for cause in ("upstream", "staging"):
        assert metrics.format_key("stall_seconds", {"cause": cause}) in final
    assert final["h2d.batches"] == 16  # 2 epochs of 8 whole batches
    assert final["h2d.bytes"] > 0
    assert payload["samples"], "the sampler recorded no timeline point"
    assert any("queue.depth.total" in s["values"] for s in payload["samples"])
    collected = stats_actor.call("snapshot").metrics_samples
    assert collected and "queue.depth.total" in collected[-1]["values"]
    ds.join(timeout=60)
    stats_actor.terminate()


# -- parity with the JAX package --------------------------------------------------------


def _seeded_ops(seed):
    """A seeded sequence of registry operations: labels that need
    sanitizing, values of every kind, histograms never observed."""
    rng = np.random.default_rng(seed)
    labels = [{}, {"epoch": 0, "rank": 1}, {"site": "stage.map"}, {"kind": 'a"b\\c\nd'},
              {"weird-label.name": "x y", "stage": "gather-reduce"}, {"phase": "decode:arrow", "stage": "map"}]
    names = ["h2d.bytes", "queue.depth", "shuffle.phase_seconds", "recovery.retries", "store-shm.bytes", "x:y"]
    ops = []
    for i in range(200):
        kind = ("counter", "gauge", "histogram")[int(rng.integers(3))]
        name = f"{names[int(rng.integers(len(names)))]}.{kind}"
        value = float(rng.choice([0.0, 1.0, 1_234_567.0, float(rng.normal() * 1e3), 2.0 ** 70]))
        ops.append((kind, name, labels[int(rng.integers(len(labels)))], value, bool(rng.integers(4))))
    return ops


def _apply(reg, ops):
    for kind, name, labels, value, act in ops:
        inst = getattr(reg, kind)(name, **labels)
        if not act:
            continue  # registered, never touched: a histogram stays unobserved
        if kind == "counter":
            inst.inc(value)
        elif kind == "gauge":
            inst.set(value)
        else:
            inst.observe(value)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_registry_parity(planes, seed):
    ops = _seeded_ops(seed)
    out = {}
    for pkg in ROOTS:
        with planes(pkg):
            metrics = _mod(pkg, "telemetry.metrics")
            _apply(metrics.registry, ops)
            snap = metrics.registry.snapshot()
            snap.update({"store.shm_bytes": 3.0 * 2 ** 30, "queue.depth.total": 7.0,
                         metrics.format_key("stall_seconds", {"cause": "staging"}): 0.25})
            out[pkg] = (metrics.registry.typed_snapshot(), metrics.to_prometheus_text(snap),
                        metrics.progress_line(snap), metrics.registry.kinds())
    assert out["port"][0] == out["jax"][0]
    assert any(e.get("kind") == "histogram" and e["count"] == 0 for e in out["port"][0].values())
    assert out["port"][1] == out["jax"][1]
    assert out["port"][2] == out["jax"][2]
    assert out["port"][3] == out["jax"][3]


def test_export_parity(planes, tmp_path):
    """Spool records of four sources, written by the JAX package's flush,
    merge to the same view in both packages."""
    sources = [{"role": "driver", "host": "h1", "pid": 11}, {"role": "task", "host": "h1", "pid": 12},
               {"role": "task", "host": "h2", "pid": 14}, {"role": "actor", "host": "h2", "pid": 13, "job": "j"}]
    spool = tmp_path / "shared-metrics"
    with planes("jax", RSDL_METRICS_DIR=str(spool)):
        jexport, jmetrics = _mod("jax", "telemetry.export"), _mod("jax", "telemetry.metrics")
        identity = jexport.source_identity
        for i, ident in enumerate(sources):
            jmetrics.reset()
            reg = jmetrics.registry
            reg.counter("shuffle.map_rows").inc(100.0 * (i + 1))
            reg.counter("recovery.retries", site="stage.map").inc(i)
            reg.counter("recovery.retries", site="actor.send").inc(1)
            reg.gauge("queue.depth.total").set(float(i))
            reg.histogram("shuffle.phase_seconds", phase="gather", stage="reduce").observe(0.5 * (i + 1))
            reg.histogram("store.fetch_window_seconds")
            jexport.source_identity = lambda ident=ident: dict(ident)
            try:
                assert jexport.flush()
            finally:
                jexport.source_identity = identity
        jmetrics.reset()
    out = {}
    for pkg in ROOTS:
        with planes(pkg, RSDL_METRICS_DIR=str(spool)):
            export = _mod(pkg, "telemetry.export")
            records = export.load_records()
            typed = export.aggregate_typed()
            flat = export.flatten(typed)
            out[pkg] = (len(records), {k: {f: v for f, v in e.items() if f != "_ts"} for k, e in typed.items()},
                        export.labeled_sum(flat, "recovery.retries"), export.prometheus_text(),
                        export.kinds_of(typed))
    assert out["port"][0] == out["jax"][0] == len(sources)
    assert out["port"][1] == out["jax"][1]
    assert out["port"][2] == out["jax"][2] == (10.0, {"{site=stage.map}": 6.0, "{site=actor.send}": 4.0})
    assert out["port"][3] == out["jax"][3]
    assert "host=" in out["port"][3] and 'job="j"' in out["port"][3]
    assert out["port"][4] == out["jax"][4]


# The keys of a delivery run the comparison leaves out, each with its reason.
EXCLUDED_KEYS = {
    # The JAX package's straggler plane records every task's duration; the
    # port has not ported it yet (its next slice).
    "task.duration_seconds": "straggler plane, not in this slice",
    # The JAX stager unpacks on the device with a jitted computation; the
    # port's batches unpack into views with no kernel, so nothing to time.
    "shuffle.phase_seconds{phase=sync,stage=staging}": "the port's unpack is a view",
}
# Keys only the port's run has, each with its reason.
PORT_ONLY_KEYS = {
    # The port's dataset shuts its queue once the last epoch is acked, and
    # the queue keeps its last depths as gauges (the JAX queue outlives the
    # run, a source only).
    "queue.": "the queue's last depths, kept at its shutdown",
}
# Counters whose values depend on timing: compared by key and kind only.
TIMED_COUNTERS = ("stall_seconds",)
# Spans whose count depends on timing: a wait of the consumer on the ring.
TIMED_SPANS = ("stall", "staging:sync")


def _excluded(key):
    return any(key == k or key.startswith(k + "{") for k in EXCLUDED_KEYS)


def _delivery_run(pkg, spool, files):
    """The delivery-only run: every key in order, the aggregated typed
    metrics, the trace's events and the event log."""
    rt = _mod(pkg, "runtime")
    rt.init(num_workers=2)
    keys = []
    try:
        if pkg == "jax":
            from ray_shuffling_data_loader_tpu.jax_dataset import JaxShufflingDataset
            from ray_shuffling_data_loader_tpu.parallel import make_mesh

            ds = JaxShufflingDataset(files, num_epochs=2, num_trainers=1, batch_size=512, rank=0,
                                     feature_columns=["key"], label_column="labels", num_reducers=2,
                                     max_concurrent_epochs=2, mesh=make_mesh(model_parallelism=1),
                                     queue_name="q-parity-jax", seed=3)
        else:
            ds = _mod("port", "device_dataset").DeviceShufflingDataset(
                files, num_epochs=2, num_trainers=1, batch_size=512, rank=0, feature_columns=["key"],
                label_column="labels", num_reducers=2, max_concurrent_epochs=2, queue_name="q-parity-port",
                seed=3, device="cpu")
        for epoch in range(2):
            ds.set_epoch(epoch)
            for features, _label in ds:
                keys.extend(np.asarray(features["key"]).tolist())
        if pkg == "port":
            ds.join(timeout=60)
        typed = _mod(pkg, "telemetry.export").aggregate_typed()
        trace = _load_trace(_mod(pkg, "telemetry").trace_export(str(spool / "trace.json")))
        events = _mod(pkg, "telemetry.events").load()
    finally:
        rt.shutdown()
    return keys, typed, trace, events


def test_delivery_stream_parity_with_metrics_and_trace_on(planes, tmp_path):
    from ray_shuffling_data_loader_tpu_torch import runtime
    from ray_shuffling_data_loader_tpu_torch.data_generation import generate_data

    files, _ = generate_data(4096, 2, 1, 0.0, str(tmp_path / "data"), seed=3)
    runtime.shutdown()  # its pool spawned before the planes were armed
    out = {}
    for pkg in ROOTS:
        # The index schedule is pinned: "auto" decides from a probe of this host.
        with planes(pkg, RSDL_INDEX_SHUFFLE="on") as spool:
            out[pkg] = _delivery_run(pkg, spool, files)
    (jkeys, jtyped, jtrace, jevents), (pkeys, ptyped, ptrace, pevents) = out["jax"], out["port"]
    assert pkeys == jkeys and sorted(pkeys) == sorted(list(range(4096)) * 2)
    jkinds = {k: e["kind"] for k, e in jtyped.items() if not _excluded(k)}
    pkinds = {k: e["kind"] for k, e in ptyped.items() if not _excluded(k) and not k.startswith(tuple(PORT_ONLY_KEYS))}
    assert {k for k in ptyped if k.startswith(tuple(PORT_ONLY_KEYS))} >= {"queue.depth.total"}
    assert pkinds == jkinds
    for key in EXCLUDED_KEYS:  # each exclusion is of a key the JAX run has
        assert any(j == key or j.startswith(key + "{") for j in jtyped), key
    counters = [k for k, kind in pkinds.items() if kind == "counter" and not k.startswith(TIMED_COUNTERS)]
    assert {k: ptyped[k]["value"] for k in counters} == {k: jtyped[k]["value"] for k in counters}
    for key in ("shuffle.map_tasks", "shuffle.reduce_tasks", "h2d.batches"):
        assert ptyped[key]["value"] == {"shuffle.map_tasks": 4, "shuffle.reduce_tasks": 4, "h2d.batches": 16}[key]
    for pkg_typed in (jtyped, ptyped):
        assert pkg_typed["shuffle.map_rows"]["value"] == pkg_typed["shuffle.reduce_rows"]["value"] == 8192

    def multiset(trace):
        return collections.Counter((e["name"], e.get("cat"), e.get("args", {}).get("epoch"))
                                   for e in trace if e["ph"] in "Xi" and e["name"] not in TIMED_SPANS)

    assert multiset(ptrace) == multiset(jtrace)
    assert {("map", 0), ("map", 1), ("reduce", 0), ("reduce", 1), ("epoch:admission", 0), ("actor:new_epoch", 1),
            ("stage:h2d", 1)} <= {(n, ep) for n, _, ep in multiset(ptrace)}

    def fields(events):
        timing = ("ts", "pid", "host", "duration_s")
        return sorted(json.dumps({k: v for k, v in e.items() if k not in timing}, sort_keys=True) for e in events)

    assert fields(pevents) == fields(jevents)
    assert collections.Counter(e["kind"] for e in pevents) == {"trial.start": 1, "trial.done": 1,
                                                               "epoch.start": 2, "epoch.done": 2}


# -- the gate ------------------------------------------------------------------------------


GATE_SCRIPT = """
import json
import sys
sys.path.insert(0, {repo!r})
sys.path.insert(0, {tests!r})
import ray_shuffling_data_loader_tpu_torch as port
import torch_port_helpers

PLANES = [f"ray_shuffling_data_loader_tpu_torch.telemetry.{{m}}"
          for m in ("trace", "export", "events", "phases", "stragglers", "critical", "capacity", "timeseries",
                    "profiler", "runledger")] + ["ray_shuffling_data_loader_tpu_torch.analysis.knob_registry"]
SAMPLERS = ("rsdl-profiler", "rsdl-ts-sampler")

if __name__ == "__main__":
    port.runtime.init(num_workers=2)
    files, _ = port.generate_data(4096, 2, 1, 0.0, {data!r})
    ds = port.DeviceShufflingDataset(files, 2, 1, 512, 0, feature_columns=["key"], label_column=port.LABEL_COLUMN,
                                     num_reducers=2, device="cpu")
    batches = 0
    for epoch in range(2):
        ds.set_epoch(epoch)
        batches += sum(1 for _ in ds)
    ds.join(timeout=60)
    assert batches == 16, batches
    worker = port.runtime.get_context().pool.submit(torch_port_helpers.loaded_modules).result(timeout=60)
    import threading
    samplers = sorted(t.name for t in threading.enumerate() if t.name in SAMPLERS)
    port.runtime.shutdown()  # the task-done and shutdown paths ran too
    print("LOADED", json.dumps({{"driver": [m for m in PLANES if m in sys.modules],
                                "worker": [m for m in PLANES if m in worker], "samplers": samplers}}))
"""


def _gate_run(tmp_path, **env):
    path = tmp_path / "gate.py"
    path.write_text(GATE_SCRIPT.format(repo=REPO, tests=TESTS, data=str(tmp_path / "data")))
    base = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA", "RSDL_"))}
    out = subprocess.run([sys.executable, str(path)], capture_output=True, text=True, timeout=120,
                         env={**base, **env}, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr
    (line,) = [ln for ln in out.stdout.splitlines() if ln.startswith("LOADED ")]
    return json.loads(line[len("LOADED "):])


def _planes(*names):
    return [f"ray_shuffling_data_loader_tpu_torch.{'analysis' if n == 'knob_registry' else 'telemetry'}.{n}"
            for n in names]


def test_planes_off_import_nothing(tmp_path):
    """Every gate unset: no plane module, the knob registry included, in
    the driver or a worker, no sampler thread, no ledger file."""
    loaded = _gate_run(tmp_path)
    assert loaded == {"driver": [], "worker": [], "samplers": []}
    assert not (tmp_path / "runs").exists()


def test_planes_on_load_in_driver_and_worker(tmp_path):
    """Metrics on: the task records and the capacity ledger load with the
    metrics and trace planes, in the driver and a worker; the critical
    path, the time series, the profiler and the run ledger stay dark."""
    loaded = _gate_run(tmp_path, RSDL_METRICS="1")
    every = _planes("trace", "export", "events", "phases", "stragglers", "capacity")
    assert loaded == {"driver": every, "worker": every, "samplers": []}


def test_every_gate_on_loads_every_plane(tmp_path):
    """``RSDL_TS``, ``RSDL_PROFILE`` and ``RSDL_RUN_LEDGER`` too: the driver
    runs both samplers and loads every plane (the tick loads the critical
    path, the ledger the knob registry); a worker profiles as well."""
    loaded = _gate_run(tmp_path, RSDL_METRICS="1", RSDL_TS="1", RSDL_TS_PERIOD_S="0.1", RSDL_PROFILE="1",
                       RSDL_RUN_LEDGER=str(tmp_path / "runs.ndjson"))
    assert loaded["driver"] == _planes("trace", "export", "events", "phases", "stragglers", "critical", "capacity",
                                       "timeseries", "profiler", "runledger", "knob_registry")
    assert loaded["worker"] == _planes("trace", "export", "events", "phases", "stragglers", "capacity", "profiler")
    assert loaded["samplers"] == ["rsdl-profiler", "rsdl-ts-sampler"]
    with open(tmp_path / "runs.ndjson") as f:
        assert [json.loads(line)["status"] for line in f] == ["done"]
