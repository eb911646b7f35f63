"""The port's obs server against the JAX package's ``telemetry/obs_server.py``.

Parity: the same seeded state goes into each package (its own spools: the
metrics records and the event log of other processes, their task records
and capacity ledger, their profiles; its registry, time-series ring, SLO
state, status providers and cluster scheduler), each package serves it on
loopback HTTP, and every route answers the same: the JSON pages equal
once the timestamps, pids, ages and session fields are taken out,
``/metrics`` byte for byte before the server's own block, the folded and
flame-graph profiles equal.

The port alone, as ``tests/test_obs.py`` does: the pages with a provider
that raises and a 404, the temporal and decision pages, the cluster's
membership, no server without ``RSDL_OBS_PORT``, and a live shuffle whose
``/status`` shows its epoch in flight and whose ``/metrics`` counts the
workers' rows."""

import importlib
import json
import os
import re
import socket
import threading
import time
import urllib.error
import urllib.request

import pytest

ROOTS = {"jax": "ray_shuffling_data_loader_tpu", "port": "ray_shuffling_data_loader_tpu_torch"}
ENV = ("RSDL_METRICS", "RSDL_METRICS_DIR", "RSDL_EVENTS_DIR", "RSDL_PROFILE", "RSDL_PROFILE_DIR", "RSDL_OBS_PORT",
       "RSDL_OBS_HOST", "RSDL_OBS_STALE_S", "RSDL_TS", "RSDL_SLO_RULES", "RSDL_TRACE", "RSDL_AUDIT", "RSDL_RELAY",
       "RSDL_RUN_LEDGER", "RSDL_SERVICE", "RSDL_STRAGGLER_K", "RSDL_STRAGGLER_MIN_S")
PLANES = ("metrics", "timeseries", "events", "stragglers", "capacity", "critical", "slo", "profiler")
# Fields that differ between two servings of one state: clocks, ages,
# process ids and the session.
VOLATILE = re.compile(r"^(ts|pid|uptime_s|started_ts|t0|seconds|hello_ts|rss_bytes|.*_free_bytes|(.*_)?age_s)$")


def _mod(pkg, name):
    return importlib.import_module(f"{ROOTS[pkg]}.{name}")


def _reset(pkg):
    _mod(pkg, "telemetry.metrics").refresh_from_env()
    _mod(pkg, "telemetry.timeseries").stop()
    for name in PLANES:
        _mod(pkg, f"telemetry.{name}").reset()
    _mod(pkg, "telemetry.obs_server").stop()


@pytest.fixture
def env(monkeypatch, tmp_path):
    for key in ENV:
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setenv("RSDL_METRICS", "1")
    for pkg in ROOTS:
        # Every module a page looks up through sys.modules, loaded in both
        # packages, with no state an earlier test left.
        for name in ("telemetry.relay", "runtime.cluster", "shuffle"):
            _mod(pkg, name)
        _mod(pkg, "runtime.cluster").reset_membership()
        _mod(pkg, "telemetry.audit").reset()
        monkeypatch.setattr(_mod(pkg, "telemetry.obs_server"), "_providers", {})
        _reset(pkg)
    monkeypatch.setattr(_mod("jax", "shuffle"), "_live_jobs", {})
    monkeypatch.setattr(_mod("port", "shuffle"), "_live_jobs", {})
    yield tmp_path
    monkeypatch.undo()
    for pkg in ROOTS:
        _mod(pkg, "runtime.cluster").reset_membership()
        _reset(pkg)


def _get(url, timeout=10):
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.status, resp.headers.get("Content-Type"), resp.read().decode()


def _strip(value):
    if isinstance(value, dict):
        return {k: _strip(v) for k, v in value.items() if not VOLATILE.match(str(k)) and k != "session"}
    if isinstance(value, list):
        return [_strip(v) for v in value]
    return value


def _ndjson(path, records):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.writelines(json.dumps(r) + "\n" for r in records)


class _Agent:
    def __init__(self, name):
        self.address = ("tcp", name, 1)


# The routes and what each answers.
ROUTES = ("/metrics", "/healthz", "/status", "/", "/timeseries?name=rsdl_shuffle_map_rows",
          "/timeseries?name=shuffle.reduce_rows&sources=1&window=30&step=1", "/timeseries?job=j1",
          "/events", "/events?kind=epoch.start&limit=5", "/events?since=1001.5&job=j1", "/stragglers", "/capacity",
          "/critical", "/alerts", "/profile", "/profile?stage=map&top=3", "/profile?collapsed=1", "/profile/flame",
          "/profile/flame?stage=map", "/jobs", "/nope")


def _seed(pkg, root, mp):
    """One seeded state, in ``pkg``'s spools under ``root``; ``mp`` sets the
    environment (a monkeypatch, undone after)."""
    host = socket.gethostname()
    metrics_dir, events_dir, prof_dir = (os.path.join(root, d) for d in ("metrics", "events", "profiles"))
    for key, value in (("RSDL_METRICS_DIR", metrics_dir), ("RSDL_EVENTS_DIR", events_dir), ("RSDL_PROFILE", "1"),
                       ("RSDL_PROFILE_DIR", prof_dir),
                       ("RSDL_SLO_RULES", json.dumps([{"name": "rows_moving", "kind": "threshold",
                                                       "metric": "shuffle.map_rows", "op": ">", "value": 0}]))):
        mp.setenv(key, value)
    _reset(pkg)
    metrics, ts, slo, events, obs = (_mod(pkg, f"telemetry.{n}") for n in ("metrics", "timeseries", "slo", "events",
                                                                            "obs_server"))
    reg = metrics.registry
    reg.counter("shuffle.map_rows").inc(100)
    reg.counter("shuffle.reduce_rows", job="j1").inc(40)
    reg.gauge("queue.depth", epoch="0", rank="0").set(3)
    reg.counter("recovery.stage_retries", stage="map").inc(2)
    reg.counter("stall_seconds", cause="upstream").inc(0.5)
    reg.histogram("lat").observe(0.25)
    os.makedirs(metrics_dir, exist_ok=True)
    for pid, rows in ((111, 500.0), (222, 300.0)):
        with open(os.path.join(metrics_dir, f"metrics-task-{pid}.json"), "w") as f:
            json.dump({"source": {"role": "task", "host": host, "pid": pid}, "ts": 1000.0 + pid,
                       "metrics": {"shuffle.map_rows": {"kind": "counter", "value": rows},
                                   "service.delivered_bytes{job=j1}": {"kind": "counter", "value": 4096.0},
                                   "task.wall": {"kind": "histogram", "count": 2, "sum": 1.5, "min": 0.5,
                                                 "max": 1.0}}}, f)
    ts.sample_now(now=1000.0)
    reg.counter("shuffle.map_rows").inc(100)
    ts.sample_now(now=1002.0)
    _ndjson(os.path.join(events_dir, "events-task-111.ndjson"),
            [{"ts": 1001.0, "kind": "epoch.start", "role": "task", "host": host, "pid": 111, "epoch": 0},
             {"ts": 1002.0, "kind": "stage.retry", "role": "task", "host": host, "pid": 111, "epoch": 0,
              "stage": "map", "job": "j1"},
             {"ts": 1003.0, "kind": "epoch.done", "role": "task", "host": host, "pid": 111, "epoch": 0}])
    _ndjson(os.path.join(metrics_dir, "tasks", "tasks-111.ndjson"),
            [{"ts": 1000.0 + 0.5 * i, "stage": stage, "host": host, "pid": 111, "dur_s": dur, "epoch": 0}
             for i, (stage, dur) in enumerate((("map", 0.4), ("map", 0.5), ("map", 3.0), ("reduce", 0.2),
                                               ("reduce", 0.3)))])
    _ndjson(os.path.join(metrics_dir, "capacity", "ledger-111.ndjson"),
            [{"ts": 1000.0, "op": "create", "id": "seg-a", "pid": 111, "nbytes": 4096, "tier": "shm", "epoch": 0},
             {"ts": 1001.0, "op": "create", "id": "seg-b", "pid": 111, "nbytes": 1024, "tier": "shm", "epoch": 1},
             {"ts": 1002.0, "op": "delete", "id": "seg-b", "pid": 111}])
    os.makedirs(prof_dir)
    for pid, stage in ((8, "map"), (9, "staging")):
        with open(os.path.join(prof_dir, f"profile-task-{pid}.json"), "w") as f:
            json.dump({"source": {"role": "task", "host": "h", "pid": pid}, "ts": 1.0, "t0": 0.0, "hz": 67.0,
                       "samples": 30, "stacks": [{"stack": "thread:MainThread;a:f;b:g", "count": 20,
                                                  "tags": {"stage": stage}},
                                                 {"stack": "thread:MainThread;a:f", "count": 10, "tags": {}}]}, f)
    slo.evaluate(now=1003.0)
    obs.register_status_provider("shuffle", lambda: {
        "running": True, "job": "_default", "started_ts": 990.0, "num_epochs": 2, "num_files": 4, "num_reducers": 2,
        "num_trainers": 1, "start_epoch": 0, "epochs": {"0": {"state": "done", "delivered_reducers": 2},
                                                        "1": {"state": "running", "delivered_reducers": 1}},
        "in_flight_epochs": [1]})
    obs.register_status_provider("batch_queue", lambda: {"in_flight_epochs": [1, 2], "producer_alive": True})
    obs.register_status_provider("broken", lambda: (_ for _ in ()).throw(RuntimeError("boom")))
    cluster = _mod(pkg, "runtime.cluster")
    sched = cluster.ClusterScheduler([_Agent("a"), _Agent("b"), _Agent("c")])
    sched.retire_agent(("tcp", "b", 1))
    sched.remove_agent(("tcp", "c", 1))
    return sched


def _serve(pkg, root, mp):
    sched = _seed(pkg, root, mp)
    obs = _mod(pkg, "telemetry.obs_server")
    port = obs.start(0)
    pages = {}
    try:
        for route in ROUTES:
            try:
                code, ctype, body = _get(f"http://127.0.0.1:{port}{route}")
            except urllib.error.HTTPError as err:
                code, ctype, body = err.code, err.headers.get("Content-Type"), err.read().decode()
            pages[route] = (code, ctype, body)
    finally:
        obs.stop()
        sched.shutdown()
    assert not obs.running()
    return pages


@pytest.fixture
def served(env, monkeypatch):
    got = {}
    for pkg in ROOTS:
        with monkeypatch.context() as mp:
            got[pkg] = _serve(pkg, str(env / pkg), mp)
        _reset(pkg)
    return got


@pytest.mark.parametrize("route", ROUTES)
def test_route_matches_jax(served, route):
    (jcode, jtype, jax_body), (pcode, ptype, port_body) = served["jax"][route], served["port"][route]
    assert (pcode, ptype) == (jcode, jtype)
    if route == "/metrics":
        # Byte for byte up to the server's own block, which both end with.
        cut = "# TYPE rsdl_up gauge\n"
        assert port_body.split(cut)[0] == jax_body.split(cut)[0]
        own = port_body.split(cut)[1]
        assert re.search(r'rsdl_obs_build_info\{version="0\.1\.0",python="[0-9.]+",platform="\w+",session=""\} 1',
                         own)
        assert "rsdl_up 1" in port_body and "rsdl_obs_scrape_duration_seconds " in own
    elif ptype == "application/json":
        assert _strip(json.loads(port_body)) == _strip(json.loads(jax_body))
    elif route.startswith("/profile/flame"):
        assert port_body.startswith("<!DOCTYPE html>") or port_body.lstrip().startswith("<")
        assert port_body == jax_body
    else:
        assert port_body == jax_body
    assert pcode == (404 if route == "/nope" else 200)


def test_seeded_pages_show_the_state(served):
    """What the seeded state must show, so the comparison above compares
    something."""
    pages = {r: (json.loads(b) if t == "application/json" else b) for r, (_, t, b) in served["port"].items()}
    assert "rsdl_shuffle_map_rows 1000" in pages["/metrics"] or "rsdl_shuffle_map_rows 1000.0" in pages["/metrics"]
    status = pages["/status"]
    assert status["in_flight_epochs"] == [1, 2] and "boom" in status["providers"]["broken"]["error"]
    assert status["alerts"]["active"] == ["rows_moving"]
    assert status["cluster"]["draining"] == ["tcp:b:1"] and status["cluster"]["retired"] == ["tcp:c:1"]
    assert {r["address"]: r["draining"] for r in status["cluster"]["agents"]} == {"tcp:a:1": False, "tcp:b:1": True}
    assert pages["/healthz"]["relay"] == {"role": None, "hosts": {}}
    assert pages["/stragglers"]["stages"]["map"]["count"] == 3
    assert pages["/capacity"]["epochs"]["0"]["shm"]["resident_bytes"] == 4096
    assert pages["/events?kind=epoch.start&limit=5"]["count"] == 1
    assert pages["/timeseries?name=rsdl_shuffle_map_rows"]["series"]["shuffle.map_rows"][-1]["rate"] == 50.0
    assert [j["job_id"] for j in pages["/jobs"]["jobs"]] == ["j1", "_default"] or pages["/jobs"]["jobs"]
    assert pages["/profile?stage=map&top=3"]["samples"] > 0


# -- the port alone ------------------------------------------------------------------


def test_pages_providers_and_404(env):
    from ray_shuffling_data_loader_tpu_torch.telemetry import metrics, obs_server

    metrics.registry.counter("page.hits").inc(3)
    port = obs_server.start(0)
    obs_server.register_status_provider("probe", lambda: {"in_flight_epochs": [3], "hello": 1})
    try:
        base = f"http://127.0.0.1:{port}"
        assert obs_server.start(0) == port  # one server
        health = json.loads(_get(base + "/healthz")[2])
        assert health["ok"] is True and health["epoch_window"]["in_flight_epochs"] == [3]
        assert "probe" in health["providers"]
        status = json.loads(_get(base + "/status")[2])
        assert status["providers"]["probe"]["hello"] == 1 and status["in_flight_epochs"] == [3] and "store" in status
        body = _get(base + "/metrics")[2]
        assert body.startswith("#") and "rsdl_page_hits 3" in body and "# TYPE rsdl_page_hits counter" in body
        assert all(len(line.rsplit(" ", 1)) == 2 for line in body.splitlines() if line and not line.startswith("#"))
        with pytest.raises(urllib.error.HTTPError) as err:
            _get(base + "/nope")
        assert err.value.code == 404
        obs_server.register_status_provider("broken", lambda: (_ for _ in ()).throw(RuntimeError("boom")))
        assert "boom" in json.loads(_get(base + "/status")[2])["providers"]["broken"]["error"]
    finally:
        obs_server.stop()
    assert not obs_server.running() and obs_server.port() is None


def test_temporal_and_decision_pages(env, tmp_path, monkeypatch):
    from ray_shuffling_data_loader_tpu_torch.telemetry import (capacity, events, metrics, obs_server, slo, stragglers,
                                                               timeseries)

    monkeypatch.setenv("RSDL_METRICS_DIR", str(tmp_path / "metrics"))
    counter = metrics.registry.counter("shuffle.map_rows")
    counter.inc(100)
    timeseries.sample_now(now=1000.0)
    counter.inc(100)
    timeseries.sample_now(now=1002.0)
    events.emit("epoch.start", epoch=0)
    stragglers.record_task("shuffle_map", 2.0, epoch=0)
    stragglers.record_task("shuffle_reduce", 0.25, epoch=0)
    capacity.note("create", "seg-a", nbytes=4096, tier="shm", epoch=0)
    port = obs_server.start(0)
    try:
        base = f"http://127.0.0.1:{port}"
        points = json.loads(_get(base + "/timeseries?name=rsdl_shuffle_map_rows")[2])["series"]["shuffle.map_rows"]
        assert points[-1]["value"] == 200.0 and points[-1]["rate"] == pytest.approx(50.0)
        ev = json.loads(_get(base + "/events?kind=epoch.start")[2])
        assert ev["count"] == 1 and ev["events"][0]["epoch"] == 0
        assert json.loads(_get(base + "/stragglers")[2])["stages"]["reduce"]["count"] == 1
        cap = json.loads(_get(base + "/capacity")[2])
        assert cap["epochs"]["0"]["shm"]["resident_bytes"] == 4096 and cap["host"].get("rss_bytes", 0) > 0
        crit = json.loads(_get(base + "/critical")[2])
        assert crit["current"]["epoch"] == 0 and crit["current"]["critical_path"] == "map"
        names = {r["name"] for r in json.loads(_get(base + "/alerts")[2])["rules"]}
        assert {"wedged_worker", "audit_mismatch", "headroom_low", "drain_stuck"} <= names
        status = json.loads(_get(base + "/status")[2])
        assert status["stragglers"]["tasks_total"] == 2 and status["events"]["by_kind"] == {"epoch.start": 1}
        assert status["capacity"]["totals"]["shm"]["resident_bytes"] == 4096
        assert status["critical"]["current"]["critical_path"] == "map" and status["alerts"]["active"] == []
        text = _get(base + "/metrics")[2]
        assert "rsdl_up 1" in text and 'rsdl_obs_build_info{version="0.1.0",' in text
        assert "rsdl_obs_scrape_duration_seconds " in text
        assert metrics.registry.snapshot()["obs.scrape_seconds_count"] == 1
        jobs = json.loads(_get(base + "/jobs")[2])
        assert jobs["service_mode"] is None
    finally:
        obs_server.stop()
        slo.reset()


def test_status_cluster_membership_section(env):
    from ray_shuffling_data_loader_tpu_torch.runtime import cluster
    from ray_shuffling_data_loader_tpu_torch.telemetry import obs_server

    sched = cluster.ClusterScheduler([_Agent("a"), _Agent("b"), _Agent("c")])
    port = obs_server.start(0)
    try:
        sched.retire_agent(("tcp", "b", 1))
        sched.remove_agent(("tcp", "c", 1))
        section = json.loads(_get(f"http://127.0.0.1:{port}/status")[2])["cluster"]
        rows = {r["address"]: r for r in section["agents"]}
        assert set(rows) == {"tcp:a:1", "tcp:b:1"}
        assert rows["tcp:a:1"]["draining"] is False and rows["tcp:b:1"]["draining"] is True
        assert rows["tcp:a:1"]["in_flight"] == 0
        assert section["draining"] == ["tcp:b:1"] and section["retired"] == ["tcp:c:1"]
        del sched  # a weak reference: the section then has no agents
        import gc

        gc.collect()
        assert json.loads(_get(f"http://127.0.0.1:{port}/status")[2])["cluster"]["agents"] == []
    finally:
        obs_server.stop()


def test_no_server_without_env(env):
    from ray_shuffling_data_loader_tpu_torch import runtime
    from ray_shuffling_data_loader_tpu_torch.telemetry import obs_server

    runtime.init(num_workers=1)
    try:
        assert not obs_server.running() and obs_server.maybe_start() is None
    finally:
        runtime.shutdown()


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_endpoint_mid_flight_shuffle(env, monkeypatch, tmp_path):
    """With ``RSDL_METRICS`` and ``RSDL_OBS_PORT`` set, the session serves;
    a running shuffle's epoch shows in flight on ``/status``, and after it
    ``/metrics`` counts every worker's rows, per source too."""
    import ray_shuffling_data_loader_tpu_torch as port_pkg
    from ray_shuffling_data_loader_tpu_torch import runtime
    from ray_shuffling_data_loader_tpu_torch.shuffle import BatchConsumer, shuffle
    from ray_shuffling_data_loader_tpu_torch.telemetry import export, metrics, obs_server

    monkeypatch.setenv("RSDL_METRICS_DIR", str(tmp_path / "metrics"))
    files, _ = port_pkg.generate_data(2048, 2, 1, 0.0, str(tmp_path / "data"), seed=0)
    runtime.shutdown()
    port = _free_port()
    monkeypatch.setenv("RSDL_OBS_PORT", str(port))
    runtime.init(num_workers=2)
    errors = []
    try:
        assert obs_server.running() and obs_server.port() == port

        class _SlowConsumer(BatchConsumer):
            def __init__(self):
                self.done = {e: threading.Event() for e in range(2)}

            def consume(self, rank, epoch, batches):
                time.sleep(0.15)

            def producer_done(self, rank, epoch):
                self.done[epoch].set()

            def wait_until_ready(self, epoch):
                pass

            def wait_until_all_epochs_done(self):
                for event in self.done.values():
                    assert event.wait(timeout=120)

        def _run():
            try:
                shuffle(files, _SlowConsumer(), num_epochs=2, num_reducers=2, num_trainers=1, seed=1)
            except BaseException as exc:
                errors.append(exc)

        thread = threading.Thread(target=_run, daemon=True)
        thread.start()
        base = f"http://127.0.0.1:{port}"
        mid, deadline = None, time.time() + 90
        while time.time() < deadline and mid is None:
            status = json.loads(_get(base + "/status")[2])
            mid = status if status["in_flight_epochs"] else None
            time.sleep(0.05)
        assert mid is not None, "no epoch ever in flight"
        assert mid["providers"]["shuffle"]["running"] is True
        thread.join(timeout=120)
        assert not thread.is_alive() and not errors, errors
        metrics.registry.counter("driver.trials").inc()
        export.flush()
        roles = [s["role"] for s in json.loads(_get(base + "/healthz")[2])["sources"]]
        assert "driver" in roles and "task" in roles
        text = _get(base + "/metrics")[2]
        merged = {line.rpartition(" ")[0]: float(line.rpartition(" ")[2]) for line in text.splitlines()
                  if line and not line.startswith("#")}
        assert merged["rsdl_shuffle_map_rows"] == merged["rsdl_shuffle_reduce_rows"] == 2048 * 2
        assert any(n.startswith("rsdl_shuffle_map_rows{") and "source=" in n for n in merged)
        assert json.loads(_get(base + "/status")[2])["in_flight_epochs"] == []
    finally:
        obs_server.unregister_status_provider("shuffle")
        runtime.shutdown()
    assert not obs_server.running()
