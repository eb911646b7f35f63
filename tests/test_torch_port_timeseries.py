"""The port's time series against the JAX package's
``telemetry/timeseries.py``.

Parity: one seeded script of registry operations and spooled records of
other processes (a source that restarts with a lower count included),
sampled at injected times by each package in a spool of its own: equal
samples (values, rates, histogram windows), ``series`` under every
query (name and its Prometheus alias, window, step, per-source keys,
job) and the persisted NDJSON read back.

The port alone, as the JAX tests do: the ring's wraparound, a counter's
rate, a restart that never gives a negative rate, a histogram's window,
the persisted file, the sampler thread's start and stop, and no start
with metrics off; then the tick: it refreshes the straggler, capacity
and critical gauges before it samples, and calls an SLO engine only
through ``sys.modules`` (none is imported).

Comparisons are exact."""

import importlib
import json
import os
import socket
import sys
import threading
import time
import types

import numpy as np
import pytest

ROOTS = {"jax": "ray_shuffling_data_loader_tpu", "port": "ray_shuffling_data_loader_tpu_torch"}
ENV = ("RSDL_METRICS", "RSDL_METRICS_DIR", "RSDL_OBS_PORT", "RSDL_TS", "RSDL_TS_PERIOD_S", "RSDL_TS_SAMPLES",
       "RSDL_TRACE", "RSDL_PROFILE")


def _mod(pkg, name):
    return importlib.import_module(f"{ROOTS[pkg]}.{name}")


def _refresh():
    for pkg in ROOTS:
        _mod(pkg, "telemetry.metrics").refresh_from_env()
        _mod(pkg, "telemetry.metrics").reset()
        _mod(pkg, "telemetry.timeseries").stop()
        _mod(pkg, "telemetry.timeseries").reset()


@pytest.fixture
def env(monkeypatch, tmp_path):
    for key in ENV:
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setenv("RSDL_METRICS", "1")
    monkeypatch.setenv("RSDL_METRICS_DIR", str(tmp_path / "metrics"))
    _refresh()
    yield str(tmp_path / "metrics")
    monkeypatch.undo()
    _refresh()


def _write_record(spool, pid, role, typed):
    os.makedirs(spool, exist_ok=True)
    with open(os.path.join(spool, f"metrics-{role}-{pid}.json"), "w") as f:
        json.dump({"source": {"role": role, "host": socket.gethostname(), "pid": pid}, "ts": time.time(),
                   "metrics": typed}, f)


def _script(seed, steps=12):
    """Per step: local operations, spooled records of two task processes
    (the second restarts at step 6), and the sample's time."""
    rng = np.random.default_rng(seed)
    out, totals, t = [], {111: 0.0, 222: 0.0}, 1000.0
    for step in range(steps):
        ops = [("counter", "shuffle.map_rows", {}, float(rng.integers(0, 100))),
               ("counter", "shuffle.reduce_rows", {"job": f"j{step % 2}"}, float(rng.integers(0, 50))),
               ("gauge", "queue.depth", {"rank": "0"}, float(rng.integers(0, 9))),
               ("histogram", "lat", {}, float(rng.uniform(0, 2))), ("histogram", "lat", {}, float(rng.uniform(0, 2)))]
        for pid in totals:
            totals[pid] += float(rng.integers(1, 20))
        if step == 6:
            totals[222] = 3.0  # a restart: the merged count goes down
        records = {pid: {"shuffle.map_rows": {"kind": "counter", "value": v},
                         "task.wall": {"kind": "histogram", "count": int(v), "sum": v / 3, "min": 0.1, "max": 2.0}}
                   for pid, v in totals.items()}
        t += float(rng.uniform(0.5, 2.0))
        out.append((ops, records, t))
    return out


def _run(pkg, spool, script):
    metrics, ts = _mod(pkg, "telemetry.metrics"), _mod(pkg, "telemetry.timeseries")
    samples = []
    for ops, records, t in script:
        for kind, name, labels, value in ops:
            inst = getattr(metrics.registry, kind)(name, **labels)
            getattr(inst, {"counter": "inc", "gauge": "set", "histogram": "observe"}[kind])(value)
        for pid, typed in records.items():
            _write_record(spool, pid, "task", typed)
        samples.append(ts.sample_now(now=t))
    now = script[-1][2]
    queries = [ts.series(now=now), ts.series(name="rsdl_shuffle_map_rows", now=now),
               ts.series(name="shuffle.map_rows", include_sources=True, now=now),
               ts.series(name="lat", window_s=5.0, now=now), ts.series(step_s=3.0, now=now),
               ts.series(job="j1", now=now), ts.series(name="shuffle.reduce_rows{job=j0}", now=now)]
    return samples, queries, ts.samples(), ts.load_persisted()


@pytest.mark.parametrize("seed", [0, 1])
def test_samples_and_series_match_jax(env, monkeypatch, tmp_path, seed):
    monkeypatch.setenv("RSDL_TS_SAMPLES", "8")  # the ring wraps
    got = {}
    for pkg in ROOTS:
        spool = str(tmp_path / f"{pkg}-{seed}")
        monkeypatch.setenv("RSDL_METRICS_DIR", spool)
        _refresh()
        got[pkg] = _run(pkg, spool, _script(seed))

    def strip(samples):  # the local source's pid and host are this process's, in both
        return json.loads(json.dumps(samples))

    assert strip(got["port"]) == strip(got["jax"])
    samples = got["port"][0]
    assert all(e.get("rate", 0.0) >= 0 for s in samples for e in s["metrics"].values())
    assert len(got["port"][2]) == 8 and len(got["port"][3]) == 12


# -- the port alone ------------------------------------------------------------------


def test_ring_rates_and_restart(env):
    from ray_shuffling_data_loader_tpu_torch.telemetry import metrics, timeseries

    timeseries.reset(capacity_override=4)
    counter = metrics.registry.counter("rate.rows")
    counter.inc(10)
    first = timeseries.sample_now(now=1000.0)
    assert "rate" not in first["metrics"]["rate.rows"]
    counter.inc(10)
    assert timeseries.sample_now(now=1002.0)["metrics"]["rate.rows"]["rate"] == 5.0
    for i in range(5):
        timeseries.sample_now(now=1003.0 + i)
    assert [s["ts"] for s in timeseries.samples()] == [1004.0, 1005.0, 1006.0, 1007.0]
    # A restarted source lowers the merged count: counted from zero.
    timeseries.reset()
    _write_record(env, 111, "task", {"restart.rows": {"kind": "counter", "value": 100.0}})
    timeseries.sample_now(now=2000.0)
    os.unlink(os.path.join(env, "metrics-task-111.json"))
    _write_record(env, 222, "task", {"restart.rows": {"kind": "counter", "value": 6.0}})
    entry = timeseries.sample_now(now=2002.0)["metrics"]["restart.rows"]
    assert entry["value"] == 6.0 and entry["rate"] == 3.0


def test_histogram_window_and_persisted_file(env):
    from ray_shuffling_data_loader_tpu_torch.telemetry import metrics, timeseries

    hist = metrics.registry.histogram("lat")
    hist.observe(1.0)
    timeseries.sample_now(now=3000.0)
    hist.observe(3.0)
    hist.observe(5.0)
    entry = timeseries.sample_now(now=3002.0)["metrics"]["lat"]
    assert (entry["count"], entry["rate"], entry["window_mean"]) == (3, 1.0, 4.0)
    assert timeseries.persist_path() == os.path.join(env, "ts", "timeseries.ndjson")
    assert timeseries.load_persisted() == json.loads(json.dumps(timeseries.samples()))


def test_sampler_thread_lifecycle(env, monkeypatch):
    from ray_shuffling_data_loader_tpu_torch.telemetry import metrics, timeseries

    metrics.registry.counter("live.rows").inc(1)
    timeseries.start(period=0.05)
    timeseries.start(period=0.05)  # one sampler
    assert timeseries.running()
    assert sum(t.name == "rsdl-ts-sampler" for t in threading.enumerate()) == 1
    deadline = time.time() + 10
    while time.time() < deadline and len(timeseries.samples()) < 2:
        time.sleep(0.02)
    assert len(timeseries.samples()) >= 2
    timeseries.stop()
    assert not timeseries.running() and not any(t.name == "rsdl-ts-sampler" for t in threading.enumerate())
    monkeypatch.delenv("RSDL_METRICS")
    metrics.refresh_from_env()
    timeseries.start(period=0.05)
    assert not timeseries.running()


def test_tick_refreshes_derived_gauges_and_reads_slo_from_sys_modules(env, monkeypatch):
    """One tick: the straggler, capacity and critical gauges are in the
    sample it takes; an SLO engine is called only when one is loaded."""
    from ray_shuffling_data_loader_tpu_torch.telemetry import capacity, metrics, stragglers, timeseries

    slo_name = "ray_shuffling_data_loader_tpu_torch.telemetry.slo"
    # An earlier test of this process may have loaded the engine: the tick
    # is held to one where it is not loaded.
    monkeypatch.delitem(sys.modules, slo_name, raising=False)
    assert slo_name not in sys.modules
    stragglers.record_task("shuffle_map", 0.5, epoch=0)
    stragglers.record_task("shuffle_reduce", 0.25, epoch=0)
    capacity.note("create", "seg", nbytes=4096, tier="shm", epoch=0)
    evaluated = []
    timeseries.start(period=0.05)
    try:
        deadline = time.time() + 10
        while time.time() < deadline and not timeseries.samples():
            time.sleep(0.02)
        keys = set(timeseries.samples()[0]["metrics"])
        assert {"straggler.median_seconds{stage=map}", "capacity.resident_bytes{epoch=0,tier=shm}",
                "critical.epoch", "critical.path{stage=map}"} <= keys
        assert slo_name not in sys.modules
        monkeypatch.setitem(sys.modules, slo_name, types.SimpleNamespace(evaluate=lambda: evaluated.append(1)))
        n = len(timeseries.samples())
        while time.time() < deadline and (len(timeseries.samples()) < n + 2 or not evaluated):
            time.sleep(0.02)
        assert evaluated
    finally:
        timeseries.stop()
        stragglers.reset()
        capacity.reset()
    assert metrics.registry.snapshot()["capacity.resident_bytes{epoch=0,tier=shm}"] == 4096.0
