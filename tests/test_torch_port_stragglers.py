"""The port's straggler view against the JAX package's
``telemetry/stragglers.py``.

Parity: seeded task records (several stages, hosts and epochs, a few
outliers) and in-flight lists, with ``now`` injected, through both
modules' ``analyze``, under several outlier budgets; the same records
spooled once and read live by both (``load_records``, ``analyze``,
``status_section``) and folded into both registries (``publish_metrics``:
equal ``straggler.*`` gauges and ``straggler.wedged`` events).

The port alone, as the JAX tests do: skew, the slowest host and the
flagged outlier; a wedged in-flight task; the spool's round trip and its
tail read; the pool's records and in-flight feed; and the counterpart of
``test_chaos_wedge_flagged_live_and_in_report``: the port's seeded
``wedge`` fault on the first reduce of a warmed one-worker pool, flagged
live and afterwards by its own pid and stage.

Comparisons are exact."""

import importlib
import json
import os
import threading
import time

import numpy as np
import pytest

ROOTS = {"jax": "ray_shuffling_data_loader_tpu", "port": "ray_shuffling_data_loader_tpu_torch"}
ENV = ("RSDL_METRICS", "RSDL_METRICS_DIR", "RSDL_EVENTS_DIR", "RSDL_STRAGGLER_K", "RSDL_STRAGGLER_MIN_S",
       "RSDL_FAULTS", "RSDL_FAULTS_SEED", "RSDL_FAULTS_WEDGE_S", "RSDL_TRACE", "RSDL_PROFILE", "RSDL_TS")
FUNCTIONS = ("shuffle_map", "shuffle_reduce", "shuffle_plan", "shuffle_gather_reduce", "generate_file")
NOW = 1_800_000_000.0


def _mod(pkg, name):
    return importlib.import_module(f"{ROOTS[pkg]}.{name}")


def _refresh():
    for pkg in ROOTS:
        _mod(pkg, "telemetry.metrics").refresh_from_env()
        _mod(pkg, "telemetry.metrics").reset()
        _mod(pkg, "telemetry.events").reset()
        _mod(pkg, "telemetry.stragglers").reset()


@pytest.fixture
def spool(monkeypatch, tmp_path):
    """Metrics on in both packages, one metrics spool and one event spool
    under ``tmp_path``; both packages' state fresh, and again at the end."""
    for key in ENV:
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setenv("RSDL_METRICS", "1")
    monkeypatch.setenv("RSDL_METRICS_DIR", str(tmp_path / "metrics"))
    monkeypatch.setenv("RSDL_EVENTS_DIR", str(tmp_path / "events"))
    _refresh()
    yield str(tmp_path / "metrics")
    monkeypatch.undo()
    _refresh()
    _mod("port", "runtime.faults").refresh_from_env()


def _records(seed, n=120):
    """``n`` task records: stage of one of :data:`FUNCTIONS`' stages, host
    of three, epoch of three (some none), lognormal durations with a few
    slow ones."""
    rng = np.random.default_rng(seed)
    st = _mod("port", "telemetry.stragglers")
    out = []
    for i in range(n):
        dur = float(rng.lognormal(-2.0, 0.6))
        if rng.random() < 0.05:
            dur *= float(rng.uniform(20, 80))
        rec = {"ts": NOW - float(rng.uniform(0, 600)), "stage": st.stage_name(FUNCTIONS[int(rng.integers(5))]),
               "host": f"host{int(rng.integers(3))}", "pid": 1000 + int(rng.integers(8)), "dur_s": dur}
        if rng.random() < 0.5:
            rec["nbytes"] = int(rng.integers(1, 1 << 20))
        if rng.random() < 0.9:
            rec["epoch"] = int(rng.integers(3))
        out.append(rec)
    return out


def _in_flight(seed):
    rng = np.random.default_rng(seed + 100)
    return [{"stage": FUNCTIONS[int(rng.integers(5))], "pid": 2000 + i, "age_s": float(rng.uniform(0, 12))}
            for i in range(6)]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("budget", [{}, {"RSDL_STRAGGLER_K": "2", "RSDL_STRAGGLER_MIN_S": "0"},
                                    {"RSDL_STRAGGLER_K": "0.5", "RSDL_STRAGGLER_MIN_S": "3"}])
def test_analyze_matches_jax(spool, monkeypatch, seed, budget):
    for key, value in budget.items():
        monkeypatch.setenv(key, value)
    records, in_flight = _records(seed), _in_flight(seed)
    got = {pkg: _mod(pkg, "telemetry.stragglers").analyze(records=records, in_flight=in_flight, now=NOW)
           for pkg in ROOTS}
    assert got["port"] == got["jax"]
    assert got["port"]["tasks_total"] == len(records)


def _spool_records(directory, records):
    """Write ``records`` as two processes' task spools."""
    os.makedirs(os.path.join(directory, "tasks"), exist_ok=True)
    for pid, part in ((11, records[::2]), (12, records[1::2])):
        with open(os.path.join(directory, "tasks", f"tasks-{pid}.ndjson"), "w") as f:
            f.writelines(json.dumps(r) + "\n" for r in part)


def test_live_spool_views_match_jax(spool):
    records = _records(7)
    _spool_records(spool, records)
    in_flight = _in_flight(7)
    for pkg in ROOTS:
        _mod(pkg, "telemetry.stragglers").register_inflight_provider("test", lambda: in_flight)
    try:
        loaded = {pkg: _mod(pkg, "telemetry.stragglers").load_records() for pkg in ROOTS}
        assert loaded["port"] == loaded["jax"] and len(loaded["port"]) == len(records)
        views = {pkg: (_mod(pkg, "telemetry.stragglers").analyze(now=NOW),
                       _mod(pkg, "telemetry.stragglers").status_section(limit=3)) for pkg in ROOTS}
        assert views["port"][0] == views["jax"][0]
        assert views["port"][1] == views["jax"][1]
        assert views["port"][0]["in_flight"] == len(in_flight)
    finally:
        for pkg in ROOTS:
            _mod(pkg, "telemetry.stragglers").unregister_inflight_provider("test")


def test_publish_metrics_matches_jax(spool):
    records, in_flight = _records(3), _in_flight(3)
    gauges, wedged_events = {}, {}
    for pkg in ROOTS:
        st, metrics = _mod(pkg, "telemetry.stragglers"), _mod(pkg, "telemetry.metrics")
        analysis = st.analyze(records=records, in_flight=in_flight, now=NOW)
        st.publish_metrics(analysis)
        st.publish_metrics(analysis)  # a second tick: no second event per wedged task
        gauges[pkg] = {k: v for k, v in metrics.registry.snapshot().items() if k.startswith("straggler.")}
        events = _mod(pkg, "telemetry.events")
        events.flush()
        wedged_events[pkg] = sorted(json.dumps({k: v for k, v in e.items() if k not in ("ts", "pid", "host")},
                                               sort_keys=True)
                                    for e in events.load() if e["kind"] == "straggler.wedged")
        events.reset(clear_spool=True)
    assert gauges["port"] == gauges["jax"] and gauges["port"]["straggler.wedged_tasks"] > 0
    assert wedged_events["port"] == wedged_events["jax"] and wedged_events["port"]


# -- the port alone ------------------------------------------------------------------


def _rec(stage, dur, host="hostA", pid=1, epoch=0):
    return {"ts": NOW, "stage": stage, "host": host, "pid": pid, "epoch": epoch, "dur_s": dur}


def test_skew_slowest_host_and_outlier(spool):
    from ray_shuffling_data_loader_tpu_torch.telemetry import stragglers

    records = ([_rec("reduce", 0.1) for _ in range(8)] + [_rec("reduce", 0.12, host="hostB") for _ in range(7)]
               + [_rec("reduce", 6.0, host="hostB")] + [_rec("map", 0.05) for _ in range(4)])
    analysis = stragglers.analyze(records=records, in_flight=[])
    st = analysis["stages"]["reduce"]
    assert st["count"] == 16 and st["median_s"] == 0.12 and st["p99_s"] == 6.0 and st["skew_ratio"] == 50.0
    assert st["slowest_host"] == "hostB"
    assert [t["dur_s"] for t in st["flagged"]] == [6.0] and st["flagged_total"] == analysis["flagged_total"] == 1
    assert analysis["stages"]["map"]["flagged"] == [] and analysis["wedged"] == []


def test_wedged_from_in_flight(spool):
    from ray_shuffling_data_loader_tpu_torch.telemetry import stragglers

    in_flight = [{"stage": "shuffle_reduce", "pid": 999, "age_s": 30.0},
                 {"stage": "shuffle_reduce", "pid": 1000, "age_s": 0.05}]
    analysis = stragglers.analyze(records=[_rec("reduce", 0.1) for _ in range(8)], in_flight=in_flight)
    (wedged,) = analysis["wedged"]
    assert (wedged["stage"], wedged["pid"], wedged["age_s"]) == ("reduce", 999, 30.0)


def test_record_task_spool_round_trip_and_tail_read(spool):
    from ray_shuffling_data_loader_tpu_torch.telemetry import metrics, stragglers

    stragglers.record_task("shuffle_map", 0.25, epoch=3, nbytes=100)
    stragglers.flush()
    assert os.listdir(stragglers.spool_dir()) == [f"tasks-{os.getpid()}.ndjson"]
    (rec,) = stragglers.load_records()
    assert (rec["stage"], rec["epoch"], rec["nbytes"], rec["dur_s"]) == ("map", 3, 100, 0.25)
    assert metrics.registry.snapshot()["task.duration_seconds{stage=map}_count"] == 1.0
    # The live read resumes where it stopped: an append shows, nothing twice.
    stragglers.record_task("shuffle_reduce", 0.5, epoch=3)
    stragglers.flush()
    assert sorted(r["dur_s"] for r in stragglers.load_records()) == [0.25, 0.5]
    assert len(stragglers.load_records()) == 2


def test_pool_records_tasks_and_feeds_in_flight(spool):
    """A pool made with metrics on: a returned task leaves one record
    (stage, epoch from the context it ran in), a raised one none; its
    in-flight provider lists a running task and goes at shutdown."""
    import torch_port_helpers

    from ray_shuffling_data_loader_tpu_torch import telemetry
    from ray_shuffling_data_loader_tpu_torch.runtime.tasks import TaskError, WorkerPool
    from ray_shuffling_data_loader_tpu_torch.telemetry import stragglers

    pool = WorkerPool(1)
    try:
        with telemetry.scope(epoch=4):
            assert pool.submit(torch_port_helpers.square, 3).result(timeout=60) == 9
            with pytest.raises(TaskError):
                pool.submit(torch_port_helpers.fail, "no").result(timeout=60)
            slow = pool.submit(torch_port_helpers.sleep_then, 1, 1.5)
        deadline = time.monotonic() + 30
        while not stragglers._in_flight() and time.monotonic() < deadline:
            time.sleep(0.02)
        (running,) = stragglers._in_flight()
        assert running["stage"] == "sleep_then" and running["age_s"] >= 0
        assert slow.result(timeout=60) == 1
        recs = sorted(stragglers.load_records(), key=lambda r: r["stage"])
        assert [(r["stage"], r["epoch"]) for r in recs] == [("sleep_then", 4), ("square", 4)]
        assert recs[0]["dur_s"] >= 1.0 and recs[0]["pid"] == running["pid"]
    finally:
        pool.shutdown()
    assert stragglers._in_flight() == []


def test_wedged_reduce_flagged_live_and_after(spool, monkeypatch, tmp_path):
    """The port's seeded ``wedge`` on the first reduce of a one-worker pool
    (warmed first, so that no start-up task is in the view): flagged while
    it sleeps, by the worker's pid and the reduce stage, then a flagged
    reduce record of that pid; the run still delivers every row once."""
    import ray_shuffling_data_loader_tpu_torch as port
    from ray_shuffling_data_loader_tpu_torch.runtime import faults
    from ray_shuffling_data_loader_tpu_torch.shuffle import BatchConsumer, shuffle
    from ray_shuffling_data_loader_tpu_torch.telemetry import stragglers

    monkeypatch.setenv("RSDL_FAULTS", "task.reduce/task:wedge:1x1")
    monkeypatch.setenv("RSDL_FAULTS_SEED", "42")
    monkeypatch.setenv("RSDL_FAULTS_WEDGE_S", "4")
    faults.refresh_from_env()
    port.runtime.init(num_workers=1)
    try:
        files, _ = port.generate_data(2048, 2, 1, 0.0, str(tmp_path / "data"))
        ctx = port.runtime.get_context()
        worker = ctx.pool.submit(os.getpid).result(timeout=60)  # warm: the worker is up and imported

        class Consumer(BatchConsumer):
            def __init__(self):
                self.rows = 0

            def consume(self, rank, epoch, batches):
                self.rows += sum(port.runtime.get_columns(b).num_rows for b in batches)
                port.runtime.free(batches)

            def producer_done(self, rank, epoch):
                pass

            def wait_until_ready(self, epoch):
                pass

            def wait_until_all_epochs_done(self):
                pass

        consumer, errors = Consumer(), []

        def run():
            try:
                shuffle(files, consumer, num_epochs=1, num_reducers=3, num_trainers=1, seed=3, cache_decoded=False)
            except BaseException as exc:
                errors.append(exc)

        stragglers.reset(clear_spool=True)  # the view holds the shuffle's tasks only
        thread = threading.Thread(target=run, daemon=True)
        thread.start()
        live, deadline = None, time.monotonic() + 60
        while live is None and time.monotonic() < deadline:
            live = next((w for w in stragglers.analyze()["wedged"] if w["stage"] == "reduce"), None)
            time.sleep(0.05)
        thread.join(timeout=120)
        assert not thread.is_alive() and not errors, errors
        assert live is not None and live["pid"] == worker
        after = stragglers.analyze()
        assert any(t["stage"] == "reduce" and t["pid"] == worker and t["epoch"] == 0 for t in after["flagged"])
        assert after["stages"]["reduce"]["count"] == 3 and after["wedged"] == []
        assert consumer.rows == 2048
    finally:
        port.runtime.shutdown()
