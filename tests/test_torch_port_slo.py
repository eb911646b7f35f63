"""The port's SLO engine against the JAX package's ``telemetry/slo.py``.

Parity: each scenario of ``tests/test_slo.py`` but the elastic one, as a
script of rules, registry operations, spooled records of other processes
and time-series samples at injected times, run through each package with
a spool of its own. Every evaluation's body (transitions, values, the
active list, the history), the events, the ``alert.*`` instruments, the
fire counts and the per-job alerts must be equal.

The port alone, as the JAX test does: a seeded ``wedge`` fault in a reduce
task fires the default ``wedged_worker`` alert live and resolves it once
the run drains, the audit ``ok`` throughout."""

import importlib
import json
import os
import socket
import threading
import time

import pytest

ROOTS = {"jax": "ray_shuffling_data_loader_tpu", "port": "ray_shuffling_data_loader_tpu_torch"}
ENV = ("RSDL_METRICS", "RSDL_METRICS_DIR", "RSDL_EVENTS_DIR", "RSDL_OBS_PORT", "RSDL_TS", "RSDL_SLO_RULES",
       "RSDL_FAULTS", "RSDL_FAULTS_SEED", "RSDL_FAULTS_WEDGE_S", "RSDL_STRAGGLER_K", "RSDL_STRAGGLER_MIN_S",
       "RSDL_AUDIT", "RSDL_AUDIT_DIR", "RSDL_TRACE", "RSDL_PROFILE", "RSDL_RELAY")


def _mod(pkg, name):
    return importlib.import_module(f"{ROOTS[pkg]}.{name}")


def _reset(pkg):
    _mod(pkg, "telemetry.metrics").refresh_from_env()
    _mod(pkg, "telemetry.timeseries").stop()
    for name in ("metrics", "timeseries", "events", "stragglers", "capacity", "critical", "slo"):
        _mod(pkg, f"telemetry.{name}").reset()


@pytest.fixture
def env(monkeypatch, tmp_path):
    for key in ENV:
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setenv("RSDL_METRICS", "1")
    for pkg in ROOTS:
        _reset(pkg)
    yield tmp_path
    monkeypatch.undo()
    for pkg in ROOTS:
        _reset(pkg)
    _mod("port", "runtime.faults").refresh_from_env()


def _write_record(spool, pid, typed):
    os.makedirs(spool, exist_ok=True)
    with open(os.path.join(spool, f"metrics-task-{pid}.json"), "w") as f:
        json.dump({"source": {"role": "task", "pid": pid, "host": socket.gethostname()}, "ts": time.time(),
                   "metrics": typed}, f)


def _stall(value):
    return {"stall_seconds{cause=upstream}": {"kind": "counter", "value": value}}


# Each scenario: steps of {"rules": [..]} (the user rules, then a reset),
# {"ops": [(kind, name, labels, value)]}, {"records": {pid: typed}},
# {"sample": t} (a time-series sample) and {"eval": now}.
SCENARIOS = {
    "threshold_fire_and_resolve": [
        {"rules": [dict(name="trip", kind="threshold", metric="x.level", op=">", value=10)]},
        {"ops": [("gauge", "x.level", {}, 5)]}, {"eval": 100.0},
        {"ops": [("gauge", "x.level", {}, 25)]}, {"eval": 101.0}, {"eval": 102.0},
        {"ops": [("gauge", "x.level", {}, 0)]}, {"eval": 103.0},
    ],
    "for_s_holds_before_firing": [
        {"rules": [dict(name="slowtrip", kind="threshold", metric="x.level", op=">", value=0, for_s=5.0)]},
        {"ops": [("gauge", "x.level", {}, 1)]}, {"eval": 100.0}, {"eval": 103.0}, {"eval": 105.5},
        {"rules": [dict(name="slowtrip", kind="threshold", metric="x.level", op=">", value=0, for_s=5.0)]},
        {"eval": 200.0}, {"ops": [("gauge", "x.level", {}, 0)]}, {"eval": 202.0},
        {"ops": [("gauge", "x.level", {}, 1)]}, {"eval": 203.0}, {"eval": 206.0}, {"eval": 208.5},
    ],
    "absence": [
        {"rules": [dict(name="missing", kind="absence", metric="heartbeat.count")]}, {"eval": 100.0},
        {"ops": [("counter", "heartbeat.count", {}, 1)]}, {"eval": 101.0},
        {"rules": [dict(name="fresh", kind="absence", metric="heartbeat.count", window_s=5.0)]}, {"eval": 102.0},
        {"sample": 110.0}, {"eval": 111.0}, {"eval": 120.0},
    ],
    "rate_over_ring_window": [
        {"rules": [dict(name="slow_rows", kind="rate", metric="y.rows", op="<", value=5.0, window_s=60.0)]},
        {"eval": 999.0}, {"ops": [("counter", "y.rows", {}, 100)]}, {"sample": 1000.0},
        {"ops": [("counter", "y.rows", {}, 2)]}, {"sample": 1002.0}, {"eval": 1002.5},
        {"ops": [("counter", "y.rows", {}, 200)]}, {"sample": 1004.0},
        {"rules": [dict(name="slow_rows", kind="rate", metric="y.rows", op="<", value=5.0, window_s=1.0)]},
        {"eval": 1004.5},
    ],
    "rate_fold_max_source": [
        {"records": {111: _stall(0.0), 222: _stall(0.0)}}, {"sample": 1000.0},
        {"records": {111: _stall(3.0), 222: _stall(3.0)}}, {"sample": 1010.0},
        {"rules": [dict(name="worst", kind="rate", metric="stall_seconds", op=">", value=0.5, window_s=60.0,
                        fold="max-source")]}, {"eval": 1010.5},
        {"rules": [dict(name="summed", kind="rate", metric="stall_seconds", op=">", value=0.5, window_s=60.0)]},
        {"eval": 1010.5},
    ],
    "user_rules_override_and_disable_defaults": [
        {"rules": [dict(name="wedged_worker", kind="threshold", metric="straggler.wedged_tasks", op=">", value=3),
                   dict(name="audit_mismatch", disabled=True),
                   dict(name="mine", kind="threshold", metric="z", op=">", value=0)]},
        {"ops": [("gauge", "straggler.wedged_tasks", {}, 2), ("gauge", "z", {}, 1)]}, {"eval": 50.0},
        {"ops": [("gauge", "straggler.wedged_tasks", {}, 4), ("gauge", "audit.digest_mismatch", {}, 1)]},
        {"eval": 51.0},
    ],
    "base_name_sums_labeled_series": [
        {"rules": [dict(name="sum", kind="threshold", metric="stall_seconds", op=">", value=10)]},
        {"ops": [("counter", "stall_seconds", {"cause": "upstream"}, 7),
                 ("counter", "stall_seconds", {"cause": "staging"}, 6)]}, {"eval": 100.0},
    ],
    "prom_alias": [
        {"rules": [dict(name="alias", kind="threshold", metric="rsdl_x_level", op=">", value=0)]},
        {"ops": [("gauge", "x.level", {}, 1)]}, {"eval": 100.0},
    ],
    "per_job_fires_only_the_stalled_job": [
        {"rules": [dict(name="deep", kind="threshold", metric="q.depth", op=">", value=5, per_job=True)]},
        {"ops": [("gauge", "q.depth", {"job": "a"}, 10), ("gauge", "q.depth", {"job": "b"}, 1)]}, {"eval": 100.0},
        {"ops": [("gauge", "q.depth", {"job": "a"}, 2)]}, {"eval": 101.0},
    ],
    "per_job_stale_instance_resolves_on_departure": [
        {"rules": [dict(name="deep", kind="threshold", metric="q.depth", op=">", value=5, per_job=True)]},
        {"ops": [("gauge", "q.depth", {"job": "a"}, 10), ("gauge", "q.depth", {"job": "b"}, 1)]}, {"eval": 100.0},
        {"ops": [("gauge", "q.depth", {"job": "a"}, 0)]}, {"eval": 101.0},
    ],
    "per_job_metric_points_at_job_series": [
        {"rules": [dict(name="mix", kind="threshold", metric="global.x", op=">", value=0, per_job=True,
                        per_job_metric="tenant.x")]},
        {"ops": [("gauge", "tenant.x", {"job": "a"}, 3), ("gauge", "tenant.x", {"job": "b"}, 0),
                 ("gauge", "tenant.busy", {"job": "b"}, 1), ("gauge", "global.x", {}, 99)]}, {"eval": 100.0},
    ],
    "per_job_degrades_to_global_without_jobs": [
        {"rules": [dict(name="deep", kind="threshold", metric="q.depth", op=">", value=5, per_job=True)]},
        {"ops": [("gauge", "q.depth", {}, 10)]}, {"eval": 100.0},
        {"ops": [("gauge", "q.depth", {"job": "a"}, 1)]}, {"eval": 101.0},
    ],
    "per_job_rate_window_mean": [
        {"rules": [dict(name="adm", kind="rate", metric="w.wait", op=">", value=5.0, window_s=120.0, per_job=True,
                        field="window_mean")]},
        {"ops": [("histogram", "w.wait", {"job": "a"}, 30.0), ("histogram", "w.wait", {"job": "b"}, 0.1)]},
        {"sample": 1000.0},
        {"ops": [("histogram", "w.wait", {"job": "a"}, 30.0), ("histogram", "w.wait", {"job": "b"}, 0.1)]},
        {"sample": 1010.0}, {"eval": 1010.5},
    ],
    "default_pack": [
        {"ops": [("gauge", "straggler.wedged_tasks", {}, 1), ("gauge", "capacity.shm_used_frac", {}, 0.95),
                 ("gauge", "relay.lag_bytes", {}, 9.0 * 1024 * 1024), ("gauge", "recovery.resume_in_progress", {}, 1),
                 ("gauge", "elastic.shm_headroom_frac", {}, 0.05), ("gauge", "elastic.drain_age_seconds", {}, 31)]},
        {"eval": 100.0}, {"eval": 111.0}, {"eval": 161.0},
        {"ops": [("gauge", "straggler.wedged_tasks", {}, 0), ("gauge", "elastic.shm_headroom_frac", {}, 0.5),
                 ("gauge", "elastic.drain_age_seconds", {}, 0)]}, {"eval": 162.0},
    ],
}


def _run(pkg, spool, steps, monkeypatch):
    metrics, ts, slo, events = (_mod(pkg, f"telemetry.{n}") for n in ("metrics", "timeseries", "slo", "events"))
    outs = []
    for step in steps:
        if "rules" in step:
            monkeypatch.setenv("RSDL_SLO_RULES", json.dumps(step["rules"]))
            slo.reset()
        for kind, name, labels, value in step.get("ops", ()):
            inst = getattr(metrics.registry, kind)(name, **labels)
            getattr(inst, {"counter": "inc", "gauge": "set", "histogram": "observe"}[kind])(value)
        for pid, typed in step.get("records", {}).items():
            _write_record(spool, pid, typed)
        if "sample" in step:
            ts.sample_now(now=step["sample"])
        if "eval" in step:
            outs.append(slo.evaluate(now=step["eval"]))
    logged = [{k: v for k, v in e.items() if k not in ("ts", "pid", "host")} for e in events.load()]
    alerts = {k: v for k, v in metrics.registry.snapshot().items() if k.startswith("alert.")}
    return json.loads(json.dumps({"evals": outs, "events": logged, "alerts": alerts, "fired": slo.fired_counts(),
                                  "by_job": slo.active_alerts_by_job(), "body": slo.alerts_body()["rules"],
                                  "status": slo.status_section(), "rules": slo.rules()}))


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_scenario_matches_jax(env, monkeypatch, scenario):
    got = {}
    for pkg in ROOTS:
        spool = str(env / f"{pkg}-metrics")
        monkeypatch.setenv("RSDL_METRICS_DIR", spool)
        monkeypatch.setenv("RSDL_EVENTS_DIR", str(env / f"{pkg}-events"))
        monkeypatch.delenv("RSDL_SLO_RULES", raising=False)
        _reset(pkg)
        got[pkg] = _run(pkg, spool, SCENARIOS[scenario], monkeypatch)
    assert got["port"] == got["jax"]
    assert got["port"]["evals"]


def test_default_pack_is_the_jax_package_s(env):
    port, jax = _mod("port", "telemetry.slo"), _mod("jax", "telemetry.slo")
    assert port.DEFAULT_RULES == jax.DEFAULT_RULES
    assert {r["name"] for r in port.rules()} >= {"producer_stalled", "stall_over_budget", "capacity_near_limit",
                                                  "wedged_worker", "audit_mismatch", "headroom_low", "drain_stuck"}


def test_rules_from_a_file_and_a_bad_value(env, monkeypatch, tmp_path):
    slo = _mod("port", "telemetry.slo")
    path = tmp_path / "rules.json"
    path.write_text(json.dumps({"name": "mine", "kind": "threshold", "metric": "z", "op": ">", "value": 0}))
    monkeypatch.setenv("RSDL_SLO_RULES", str(path))
    slo.reset()
    assert "mine" in {r["name"] for r in slo.rules()}
    monkeypatch.setenv("RSDL_SLO_RULES", "[not json")
    slo.reset()
    assert [r["name"] for r in slo.rules()] == [r["name"] for r in slo.DEFAULT_RULES]


# -- the port alone: a wedged reduce fires wedged_worker ---------------------------------


def test_chaos_wedge_fires_wedged_worker_alert(env, monkeypatch, tmp_path):
    """A seeded ``wedge`` in one reduce task: the straggler gauges feed the
    default ``wedged_worker`` rule, which fires while the task sleeps and
    resolves once the run drains; the audit stays ``ok``."""
    import ray_shuffling_data_loader_tpu_torch as port
    from ray_shuffling_data_loader_tpu_torch import runtime
    from ray_shuffling_data_loader_tpu_torch.runtime import faults
    from ray_shuffling_data_loader_tpu_torch.shuffle import BatchConsumer, shuffle
    from ray_shuffling_data_loader_tpu_torch.telemetry import audit, events, metrics, slo, stragglers

    # The data first, with the planes off: its tasks leave no records.
    monkeypatch.delenv("RSDL_METRICS")
    metrics.refresh_from_env()
    files, _ = port.generate_data(1024, 2, 1, 0.0, str(tmp_path / "data"), seed=0)
    runtime.shutdown()
    monkeypatch.setenv("RSDL_METRICS", "1")
    monkeypatch.setenv("RSDL_METRICS_DIR", str(tmp_path / "metrics"))
    monkeypatch.setenv("RSDL_EVENTS_DIR", str(tmp_path / "events"))
    monkeypatch.setenv("RSDL_FAULTS", "task.reduce/task:wedge:1x1")
    monkeypatch.setenv("RSDL_FAULTS_SEED", "42")
    monkeypatch.setenv("RSDL_FAULTS_WEDGE_S", "5")
    faults.refresh_from_env()
    _reset("port")
    # audit.enable writes these two; set first, the fixture's undo clears them.
    monkeypatch.setenv("RSDL_AUDIT", "1")
    monkeypatch.setenv("RSDL_AUDIT_DIR", str(tmp_path / "audit"))
    audit.enable(spool_dir=str(tmp_path / "audit"))
    # One worker: the x1 cap is per process, so one reduce wedges.
    runtime.init(num_workers=1)

    class _Consumer(BatchConsumer):
        def __init__(self):
            self.done = threading.Event()

        def consume(self, rank, epoch, batches):
            pass

        def producer_done(self, rank, epoch):
            self.done.set()

        def wait_until_ready(self, epoch):
            pass

        def wait_until_all_epochs_done(self):
            assert self.done.wait(timeout=120)

    errors = []

    def _run():
        try:
            shuffle(files, _Consumer(), num_epochs=1, num_reducers=4, num_trainers=1, seed=3)
        except BaseException as exc:
            errors.append(exc)

    thread = threading.Thread(target=_run, daemon=True)
    thread.start()
    try:
        fired, deadline = None, time.time() + 90
        while time.time() < deadline and fired is None:
            stragglers.publish_metrics()
            out = slo.evaluate()
            fired = next((r for r in out["rules"] if r["name"] == "wedged_worker" and r["active"]), None)
            time.sleep(0.05)
        assert fired is not None and fired["value"] >= 1.0, "wedged_worker never fired"
        assert metrics.registry.snapshot()["alert.active{rule=wedged_worker}"] == 1.0
        assert [e for e in events.load() if e["kind"] == "alert.fired" and e.get("rule") == "wedged_worker"]
        thread.join(timeout=120)
        assert not thread.is_alive() and not errors, errors
        resolved, deadline = False, time.time() + 60
        while time.time() < deadline and not resolved:
            stragglers.publish_metrics()
            resolved = "wedged_worker" not in slo.evaluate()["active"]
            time.sleep(0.05)
        assert resolved, "wedged_worker never resolved"
        assert [e for e in events.load() if e["kind"] == "alert.resolved" and e.get("rule") == "wedged_worker"]
        verdicts = audit.verdicts()
        assert verdicts and all(v["ok"] for v in verdicts)
        assert slo.fired_counts().get("wedged_worker") == 1
    finally:
        thread.join(timeout=5)
        runtime.shutdown()
        audit.disable()
        audit.reset()
