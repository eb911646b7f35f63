"""The port's run ledger against the JAX package's
``telemetry/runledger.py``.

Parity: one state for both packages (a registry with stall and delivered
bytes counters, an event log with epoch walls, task records and ledger
ops in one metrics spool, profile records, a trial in the live tracker,
one host sample) and ``build_record`` in each: every section equal but
the run id, host, pid and time stamp; with every plane dark, the same
identity and outcome only.

The port alone, as the JAX tests do: the gate and the ledger's path (an
``auto`` ledger under the live session's directory), a disabled
``record_run``, the append and read round trip past a torn line,
concurrent appends, and ``shuffle()`` appending one ``done`` record (with
its shape, plan and, under the plan compiler, its terms) and one
``failed`` record for a poisoned run.

Comparisons are exact."""

import importlib
import json
import os
import socket
import sys
import threading

import pytest

ROOTS = {"jax": "ray_shuffling_data_loader_tpu", "port": "ray_shuffling_data_loader_tpu_torch"}
ENV = ("RSDL_RUN_LEDGER", "RSDL_RUNTIME_DIR", "RSDL_METRICS", "RSDL_METRICS_DIR", "RSDL_EVENTS_DIR", "RSDL_PROFILE",
       "RSDL_PROFILE_DIR", "RSDL_TRACE", "RSDL_TS", "RSDL_PLAN", "RSDL_FAULTS", "RSDL_FAULTS_SEED", "RSDL_JOB_ID",
       "RSDL_STAGE_MAX_ATTEMPTS")
HOST = {"rss_bytes": 1, "shm_free_bytes": 3_000_000}
IDENTITY = ("id", "ts", "host", "pid")


def _mod(pkg, name):
    return importlib.import_module(f"{ROOTS[pkg]}.{name}")


def _refresh():
    for pkg in ROOTS:
        _mod(pkg, "telemetry.metrics").refresh_from_env()
        _mod(pkg, "telemetry.metrics").reset()
        _mod(pkg, "telemetry.events").reset()
        for name in ("stragglers", "capacity", "critical"):
            _mod(pkg, f"telemetry.{name}").reset()
        _mod(pkg, "telemetry.profiler").reset()
        _mod(pkg, "telemetry.profiler").refresh_from_env()


@pytest.fixture
def clean(monkeypatch, tmp_path):
    for key in ENV:
        monkeypatch.delenv(key, raising=False)
    _refresh()
    yield tmp_path
    monkeypatch.undo()
    _refresh()
    _mod("port", "runtime.faults").refresh_from_env()


def _spool_state(tmp_path):
    """Files both packages read: task records and ledger ops in the
    metrics spool, epoch events, two processes' profiles."""
    metrics_dir, events_dir, prof_dir = (str(tmp_path / d) for d in ("metrics", "events", "profiles"))
    for sub in ("tasks", "capacity"):
        os.makedirs(os.path.join(metrics_dir, sub))
    tasks = [{"ts": 10.0 + e * 10 + i, "dur_s": 2.0 + i, "stage": s, "epoch": e, "host": "h", "pid": 7}
             for e in range(2) for i, s in enumerate(("map", "reduce", "map"))]
    with open(os.path.join(metrics_dir, "tasks", "tasks-7.ndjson"), "w") as f:
        f.writelines(json.dumps(r) + "\n" for r in tasks)
    ops = [{"ts": 1.0, "op": "create", "id": "a", "pid": 7, "nbytes": 500, "tier": "shm", "epoch": 0},
           {"ts": 2.0, "op": "create", "id": "b", "pid": 7, "nbytes": 300, "tier": "cache", "epoch": 0}]
    with open(os.path.join(metrics_dir, "capacity", "ledger-7.ndjson"), "w") as f:
        f.writelines(json.dumps(r) + "\n" for r in ops)
    os.makedirs(events_dir)
    events = [{"ts": 100.0, "kind": "epoch.start", "epoch": 0}, {"ts": 103.5, "kind": "epoch.done", "epoch": 0},
              {"ts": 104.0, "kind": "epoch.start", "epoch": 1}, {"ts": 104.25, "kind": "epoch.failed", "epoch": 1}]
    with open(os.path.join(events_dir, f"events-task-{os.getpid() + 1}.ndjson"), "w") as f:
        f.writelines(json.dumps({**e, "pid": 1, "host": socket.gethostname()}) + "\n" for e in events)
    os.makedirs(prof_dir)
    for pid, stage in ((8, "map"), (9, "staging")):
        rec = {"source": {"role": "task", "host": "h", "pid": pid}, "ts": 1.0, "t0": 0.0, "hz": 67.0, "samples": 30,
               "stacks": [{"stack": "thread:MainThread;a:f;b:g", "count": 20, "tags": {"stage": stage}},
                          {"stack": "thread:MainThread;a:f", "count": 10, "tags": {}}]}
        with open(os.path.join(prof_dir, f"profile-task-{pid}.json"), "w") as f:
            json.dump(rec, f)
    return metrics_dir, events_dir, prof_dir


def _isolate(monkeypatch):
    """Neither package's plan, SLO or service module counts, whatever an
    earlier test of this process loaded; both live trackers empty."""
    for pkg in ROOTS:
        for name in ("runtime.plan", "telemetry.slo", "runtime.service"):
            monkeypatch.delitem(sys.modules, f"{ROOTS[pkg]}.{name}", raising=False)
    monkeypatch.setattr(_mod("jax", "shuffle"), "_live_jobs", {})
    monkeypatch.setattr(_mod("port", "shuffle"), "_live_jobs", {})


def test_record_sections_match_jax(clean, monkeypatch):
    metrics_dir, events_dir, prof_dir = _spool_state(clean)
    for key, value in (("RSDL_METRICS", "1"), ("RSDL_METRICS_DIR", metrics_dir), ("RSDL_EVENTS_DIR", events_dir),
                       ("RSDL_PROFILE", "1"), ("RSDL_PROFILE_DIR", prof_dir),
                       ("RSDL_RUN_LEDGER", str(clean / "ledger.ndjson")), ("RSDL_STRAGGLER_K", "3")):
        monkeypatch.setenv(key, value)
    _refresh()
    _isolate(monkeypatch)
    records = {}
    for pkg in ROOTS:
        reg = _mod(pkg, "telemetry.metrics").registry
        reg.counter("stall_seconds", cause="upstream").inc(2.5)
        reg.counter("stall_seconds", cause="staging").inc(1.25)
        reg.counter("service.delivered_bytes", job="j-1").inc(1000)
        for name in ("events", "critical", "capacity", "profiler"):
            _mod(pkg, f"telemetry.{name}")  # loaded: the ledger reads what is loaded
        monkeypatch.setattr(_mod(pkg, "telemetry.capacity"), "host_sample", lambda: dict(HOST))
        _mod(pkg, "shuffle")._status_begin_trial(2, 3, 4, 1, 0)
        rl = _mod(pkg, "telemetry.runledger")
        records[pkg] = [rl.build_record("done", duration_s=10.0, plan_label="block:2", job_id="j-1",
                                        audit_verdicts=[{"epoch": 0, "ok": True}, {"epoch": 1, "ok": False}],
                                        extra={"note": "x"}),
                        rl.build_record("failed", kind="bench", error="e" * 400)]

    def strip(rec):
        return {k: v for k, v in rec.items() if k not in IDENTITY}

    for j, p in zip(records["jax"], records["port"]):
        assert strip(p) == strip(j)
    done = records["port"][0]
    assert {"knobs", "run", "throughput", "stall_by_cause", "epochs", "critical", "audit", "capacity",
            "profile"} <= set(done)
    assert done["epochs"] == [{"epoch": 0, "wall_s": 3.5, "state": "done"},
                              {"epoch": 1, "wall_s": 0.25, "state": "failed"}]
    assert done["capacity"] == {"shm_used_frac": round(800 / 3_000_800, 4), "shm_resident_bytes": 800}
    assert done["run"] == {"num_epochs": 2, "num_files": 3, "num_reducers": 4, "num_trainers": 1, "start_epoch": 0}


def test_dark_record_matches_jax(clean, monkeypatch):
    monkeypatch.setenv("RSDL_RUN_LEDGER", str(clean / "l.ndjson"))
    _refresh()
    _isolate(monkeypatch)
    got = {pkg: {k: v for k, v in _mod(pkg, "telemetry.runledger").build_record("failed", error="x" * 500).items()
                 if k not in IDENTITY} for pkg in ROOTS}
    assert got["port"] == got["jax"]
    assert set(got["port"]) == {"kind", "status", "error", "knobs"} and len(got["port"]["error"]) == 300


# -- the port alone ------------------------------------------------------------------


def test_gate_and_path(clean, monkeypatch):
    import ray_shuffling_data_loader_tpu_torch as port
    from ray_shuffling_data_loader_tpu_torch.telemetry import runledger

    for off in ("", "0", "off", "false", "no", "OFF"):
        monkeypatch.setenv("RSDL_RUN_LEDGER", off)
        assert not runledger.enabled() and runledger.ledger_path() is None
        assert runledger.record_run("done") is None
    monkeypatch.setenv("RSDL_RUN_LEDGER", "auto")
    monkeypatch.setenv("RSDL_RUNTIME_DIR", str(clean / "rt"))
    assert runledger.ledger_path() == str(clean / "rt" / "runs" / "ledger.ndjson")
    monkeypatch.delenv("RSDL_RUNTIME_DIR")
    assert runledger.ledger_path() == os.path.join(".", "runs", "ledger.ndjson")
    ctx = port.runtime.init(num_workers=1)  # the port's owner exports no RSDL_RUNTIME_DIR
    try:
        assert runledger.ledger_path() == os.path.join(ctx.runtime_dir, "runs", "ledger.ndjson")
    finally:
        port.runtime.shutdown()
    monkeypatch.setenv("RSDL_RUN_LEDGER", str(clean / "durable.ndjson"))
    assert runledger.ledger_path() == str(clean / "durable.ndjson")


def test_append_read_round_trip_and_concurrent_appends(clean, monkeypatch):
    from ray_shuffling_data_loader_tpu_torch.telemetry import runledger

    path = clean / "runs" / "ledger.ndjson"
    monkeypatch.setenv("RSDL_RUN_LEDGER", str(path))
    rid1 = runledger.append_record({"id": "run-aaa-1", "status": "done"})
    rid2 = runledger.record_run("failed", error="boom", kind="bench")
    with open(path, "a") as f:
        f.write('{"id": "run-torn')
    records = runledger.read(str(path))
    assert [r["id"] for r in records] == [rid1, rid2] and rid1 == "run-aaa-1"
    assert (records[1]["status"], records[1]["error"], records[1]["kind"]) == ("failed", "boom", "bench")
    assert records[1]["knobs"]["RSDL_RUN_LEDGER"] == str(path)
    other = clean / "many.ndjson"
    monkeypatch.setenv("RSDL_RUN_LEDGER", str(other))

    def spam(tag):
        for i in range(20):
            runledger.append_record({"id": f"run-{tag}-{i}", "status": "done", "blob": "x" * 4096})

    threads = [threading.Thread(target=spam, args=(t,)) for t in "abc"]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert len({r["id"] for r in runledger.read(str(other))}) == 60


class _Consumer:
    def consume(self, rank, epoch, batches):
        import ray_shuffling_data_loader_tpu_torch as port

        port.runtime.free(batches)

    def producer_done(self, rank, epoch):
        pass

    def wait_until_ready(self, epoch):
        pass

    def wait_until_all_epochs_done(self):
        pass


def test_shuffle_appends_one_record_per_run(clean, monkeypatch):
    """A planned run appends one ``done`` record with its shape, plan and
    terms; a poisoned run one ``failed`` record with the error."""
    import ray_shuffling_data_loader_tpu_torch as port
    from ray_shuffling_data_loader_tpu_torch.runtime import faults
    from ray_shuffling_data_loader_tpu_torch.shuffle import StageFailedError, shuffle
    from ray_shuffling_data_loader_tpu_torch.telemetry import runledger

    ledger = clean / "ledger.ndjson"
    monkeypatch.setenv("RSDL_RUN_LEDGER", str(ledger))
    monkeypatch.setenv("RSDL_PLAN", "auto")
    port.runtime.init(num_workers=1)
    try:
        files, _ = port.generate_data(512, 2, 1, 0.0, str(clean / "data"))
        shuffle(files, _Consumer(), num_epochs=2, num_reducers=2, num_trainers=1, seed=5)
        (rec,) = runledger.read(str(ledger))
        assert (rec["kind"], rec["status"], rec["plan"]) == ("shuffle", "done", "rowwise") and rec["duration_s"] > 0
        assert rec["run"] == {"num_epochs": 2, "num_files": 2, "num_reducers": 2, "num_trainers": 1,
                              "start_epoch": 0}
        assert rec["knobs"]["RSDL_RUN_LEDGER"] == str(ledger) and rec["plan_terms"]["plan"]["value"] == ["rowwise", 0]
    finally:
        port.runtime.shutdown()
    # The schedule is armed before the session: its workers read it at spawn.
    monkeypatch.setenv("RSDL_FAULTS", "task.map:crash-entry:1.0")
    monkeypatch.setenv("RSDL_STAGE_MAX_ATTEMPTS", "2")
    faults.refresh_from_env()
    port.runtime.init(num_workers=1)
    try:
        with pytest.raises(StageFailedError):
            shuffle(files, _Consumer(), num_epochs=1, num_reducers=2, num_trainers=1, seed=5)
    finally:
        port.runtime.shutdown()
    failed = runledger.read(str(ledger))[1]
    assert failed["status"] == "failed" and "StageFailedError" in failed["error"]
    assert failed["run"]["num_epochs"] == 1
