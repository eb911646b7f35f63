"""The observability planes' gate: a small shuffle run with the obs server
up, checked while it is in flight; the exit code is the gate.

    python -m ray_shuffling_data_loader_tpu_torch.obs_smoke
    python -m ray_shuffling_data_loader_tpu_torch.obs_smoke --federation

The default gate sets its ``RSDL_*`` variables before the runtime starts,
so that the spawned workers inherit them (``RSDL_METRICS``,
``RSDL_PROFILE``, ``RSDL_SERVICE`` and ``RSDL_TS_PERIOD_S`` only where
unset), and shuffles 2 files of 2048 rows for 3 epochs into 2 reducers
with a consumer that sleeps 0.2 s a batch. While the run is in flight:

1. ``/timeseries?name=rsdl_shuffle_map_rows`` serves a rate;
2. ``python -m ray_shuffling_data_loader_tpu_torch.rsdl_top --once
   --json`` renders a frame from the live server (exit 0, JSON);
3. ``/capacity`` shows store operations and per-epoch residency,
   ``/critical`` names a critical-path stage and ``/alerts`` lists the
   rule pack with the user rule ``smoke_trip`` (``RSDL_SLO_RULES``);
4. ``/jobs`` lists the run's tenant as running;
5. ``/profile`` merges the spools of at least 2 processes (the driver
   and the pool's workers) with self time in a shuffle stage's frame;
6. ``smoke_trip``, a threshold on the gauge ``obs.smoke_trip`` that this
   process sets to 1 and back to 0, fires and then resolves on
   ``/alerts``.

After the run ``/events`` holds ``epoch.start`` and ``epoch.done`` for
every epoch, one ``trial.done`` and the alert's ``alert.fired`` and
``alert.resolved``, ``/events?job=<the tenant>`` that tenant's events
only, and a job id that does not exist none.

``--federation`` gates the relay instead: a second host, a process that
imports only this package, joins the cluster with its own spool tree
(``RSDL_RUNTIME_DIR`` and ``RSDL_OBS_PORT`` left out of its environment)
under ``RSDL_RELAY=auto``, advertising ``RSDL_ADVERTISE_HOST`` (127.0.0.1
where unset, as the head does); while the same shuffle runs, ``/metrics``
must carry at least 2 ``host=`` labels and ``/healthz`` show the relay's
sink with sources, none stale.

Any miss exits non-zero. The checks, their order and the exit codes are
the JAX package's ``tools/obs_smoke.py``'s; this gate also fails at once,
rather than at the end of its wait, when the profiler's sampler is not
running in this process (``RSDL_PROFILE`` set off). The tool imports no
torch.
"""

from __future__ import annotations

import json
import os
import re
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPOCHS = 3


class GateError(AssertionError):
    """A check of the gate failed."""


def _check(cond, what) -> None:
    if not cond:
        raise GateError(what)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _files(data_dir: str) -> list:
    from ray_shuffling_data_loader_tpu_torch.data_generation import generate_file

    return [generate_file(i, i * 2048, 2048, 1, data_dir)[0] for i in range(2)]


def _wait_alert_state(get, rule, active, timeout_s=60.0) -> bool:
    """Poll ``/alerts`` until ``rule`` is active (or not); the sampler's
    tick evaluates the rules."""
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        for row in get("/alerts").get("rules", []):
            if row["name"] == rule and bool(row["active"]) == active:
                return True
        time.sleep(0.2)
    return False


def _midflight(get, base: str) -> dict:
    """The checks made while the shuffle runs; returns what the summary
    line prints and the tenant's job id."""
    deadline = time.time() + 120
    rate_seen = top_out = None
    while time.time() < deadline:
        series = get("/timeseries?name=rsdl_shuffle_map_rows").get("series") or {}
        rates = [p for pts in series.values() for p in pts if p.get("rate")]
        if rates:
            rate_seen = rates[-1]
            top_out = subprocess.run(
                [sys.executable, "-m", "ray_shuffling_data_loader_tpu_torch.rsdl_top", "--url", base, "--once",
                 "--json"],
                capture_output=True, text=True, cwd=_REPO, timeout=120,
            )
            break
        time.sleep(0.2)
    _check(rate_seen, "no non-empty rsdl_shuffle_map_rows rate series mid-flight")
    _check(top_out.returncode == 0, f"rsdl_top exited {top_out.returncode}: {top_out.stderr}")
    _check(json.loads(top_out.stdout)["status"] is not None, "rsdl_top's frame has no status")

    cap = get("/capacity")
    _check(cap.get("ops", 0) > 0, "capacity ledger saw no store ops")
    _check(cap.get("epochs"), "no per-epoch residency in /capacity")
    crit_deadline = time.time() + 60
    crit_path = None
    while time.time() < crit_deadline and crit_path is None:
        crit_path = (get("/critical").get("current") or {}).get("critical_path")
        if crit_path is None:
            time.sleep(0.2)
    _check(crit_path, "no critical-path verdict mid-flight")
    rule_names = {r["name"] for r in get("/alerts").get("rules", [])}
    _check({"wedged_worker", "smoke_trip"} <= rule_names, f"rule pack {sorted(rule_names)}")

    jobs_deadline = time.time() + 60
    job_id = None
    while time.time() < jobs_deadline and job_id is None:
        running = [r for r in get("/jobs").get("jobs") or [] if r.get("running")]
        if running:
            job_id = running[0]["job_id"]
        else:
            time.sleep(0.2)
    _check(job_id, "no running tenant on /jobs mid-flight")

    prof_deadline = time.time() + 60
    prof_procs = prof_staged = None
    while time.time() < prof_deadline:
        prof = get("/profile")
        _check(prof.get("sampler_running"), "the profiler's sampler is not running in the driver (RSDL_PROFILE)")
        procs = {(s.get("host"), s.get("pid")) for s in prof.get("sources") or [] if s.get("pid")}
        staged = [r for r in prof.get("top") or [] if any(v > 0 for v in (r.get("stages") or {}).values())]
        if len(procs) >= 2 and staged:
            prof_procs, prof_staged = len(procs), staged[0]
            break
        time.sleep(0.2)
    _check(prof_procs, "/profile never showed >=2 process sources plus a stage-attributed frame mid-flight")

    from ray_shuffling_data_loader_tpu_torch.telemetry import metrics

    metrics.registry.gauge("obs.smoke_trip").set(1)
    _check(_wait_alert_state(get, "smoke_trip", active=True), "smoke_trip never fired")
    metrics.registry.gauge("obs.smoke_trip").set(0)
    _check(_wait_alert_state(get, "smoke_trip", active=False), "smoke_trip never resolved")
    return {"rate": rate_seen["rate"], "critical": crit_path, "procs": prof_procs, "hot": prof_staged["frame"],
            "job_id": job_id}


def main() -> int:
    port = _free_port()
    os.environ.setdefault("RSDL_METRICS", "1")
    os.environ.setdefault("RSDL_PROFILE", "1")
    os.environ["RSDL_OBS_PORT"] = str(port)
    # A fast sampler: a short run still fills several ring entries.
    os.environ.setdefault("RSDL_TS_PERIOD_S", "0.2")
    # The shuffle registers itself as a tenant: /jobs and the job= filter
    # have a real job id.
    os.environ.setdefault("RSDL_SERVICE", "auto")
    # The rule that this process trips, beside the default pack.
    os.environ["RSDL_SLO_RULES"] = json.dumps(
        [{"name": "smoke_trip", "kind": "threshold", "metric": "obs.smoke_trip", "op": ">", "value": 0}]
    )
    from ray_shuffling_data_loader_tpu_torch import runtime
    from ray_shuffling_data_loader_tpu_torch.shuffle import BatchConsumer, shuffle

    files = _files(tempfile.mkdtemp(prefix="rsdl-obs-smoke-"))
    runtime.init(num_workers=2)
    # The consumer holds shuffle() open until the checks are done, so that
    # the tenant stays running on /jobs.
    release = threading.Event()

    class _Consumer(BatchConsumer):
        def __init__(self):
            self.done = threading.Event()

        def consume(self, rank, epoch, batches):
            time.sleep(0.2)  # keeps the run in flight for the checks

        def producer_done(self, rank, epoch):
            if epoch == EPOCHS - 1:
                self.done.set()

        def wait_until_ready(self, epoch):
            pass

        def wait_until_all_epochs_done(self):
            _check(self.done.wait(timeout=180), "the last epoch never finished")
            _check(release.wait(timeout=180), "the checks never released the run")

    errors = []

    def _run():
        try:
            shuffle(files, _Consumer(), num_epochs=EPOCHS, num_reducers=2, num_trainers=1, seed=7)
        except BaseException as exc:
            errors.append(exc)

    thread = threading.Thread(target=_run, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{port}"

    def get(path):
        with urllib.request.urlopen(base + path, timeout=10) as resp:
            return json.loads(resp.read().decode())

    try:
        seen = _midflight(get, base)
    finally:
        release.set()  # a failed check still lets the run end before the exit
        thread.join(timeout=180)
    _check(not thread.is_alive() and not errors, f"the shuffle failed: {errors}")
    kinds = get("/events")["by_kind"]
    _check(kinds.get("epoch.start", 0) >= EPOCHS and kinds.get("epoch.done", 0) >= EPOCHS
           and kinds.get("trial.done") == 1 and kinds.get("alert.fired", 0) >= 1
           and kinds.get("alert.resolved", 0) >= 1, f"events by kind {kinds}")
    job_events = get(f"/events?job={seen['job_id']}")
    _check(job_events["count"] > 0, "no events for the tenant's job id")
    _check(all(e.get("job") == seen["job_id"] for e in job_events["events"]),
           "job filter leaked other tenants' events")
    _check(get("/events?job=no-such-job")["count"] == 0, "a job id that does not exist has events")
    print("obs smoke ok: rate=%.1f rows/s, critical=%s, profile=%d procs (hot %s), events=%s"
          % (seen["rate"], seen["critical"], seen["procs"], seen["hot"], kinds))
    runtime.shutdown()
    return 0


_FED_WORKER_SCRIPT = r"""
import os, sys, time
sys.path.insert(0, sys.argv[1])
addr_file = sys.argv[2]
from ray_shuffling_data_loader_tpu_torch import runtime
from ray_shuffling_data_loader_tpu_torch.runtime import cluster

deadline = time.time() + 60
while not os.path.exists(addr_file):
    if time.time() > deadline:
        sys.exit(2)
    time.sleep(0.1)
with open(addr_file) as f:
    address = f.read().strip()
runtime.init(address=address, num_workers=2)
cluster.serve_forever()
runtime.shutdown()
"""


def federation_main() -> int:
    """The relay's gate (module docstring)."""
    port = _free_port()
    os.environ.setdefault("RSDL_METRICS", "1")
    os.environ["RSDL_RELAY"] = "auto"
    os.environ["RSDL_OBS_PORT"] = str(port)
    os.environ.setdefault("RSDL_TS_PERIOD_S", "0.2")
    # Both hosts on this machine: the joined one advertises loopback too,
    # rather than the default route's interface.
    os.environ.setdefault("RSDL_ADVERTISE_HOST", "127.0.0.1")
    from ray_shuffling_data_loader_tpu_torch import runtime
    from ray_shuffling_data_loader_tpu_torch.shuffle import BatchConsumer, shuffle

    ctx = runtime.init_cluster(advertise_host="127.0.0.1", num_workers=2)
    addr_file = os.path.join(tempfile.mkdtemp(prefix="rsdl-fed-smoke-"), "head_address")
    with open(addr_file + ".tmp", "w") as f:
        f.write(ctx.cluster.address)
    os.rename(addr_file + ".tmp", addr_file)
    # The joined host keeps its own spool tree: with this session's, its
    # files would federate through the file system, and the relay would
    # rightly skip them.
    worker_env = {k: v for k, v in os.environ.items() if k not in ("RSDL_RUNTIME_DIR", "RSDL_OBS_PORT")}
    worker = subprocess.Popen([sys.executable, "-c", _FED_WORKER_SCRIPT, _REPO, addr_file], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=worker_env)
    try:
        deadline = time.time() + 60
        while len(ctx.cluster.registry.call("hosts")) < 2:
            _check(time.time() < deadline, "worker host never joined")
            _check(worker.poll() is None, "worker died while joining")
            time.sleep(0.2)
        files = _files(tempfile.mkdtemp(prefix="rsdl-fed-data-"))

        class _Consumer(BatchConsumer):
            def consume(self, rank, epoch, batches):
                time.sleep(0.2)  # keeps the run in flight for the checks

            def producer_done(self, rank, epoch):
                pass

            def wait_until_ready(self, epoch):
                pass

            def wait_until_all_epochs_done(self):
                pass

        errors = []

        def _run():
            try:
                shuffle(files, _Consumer(), num_epochs=EPOCHS, num_reducers=2, num_trainers=1, seed=7)
            except BaseException as exc:
                errors.append(exc)

        thread = threading.Thread(target=_run, daemon=True)
        thread.start()
        base = f"http://127.0.0.1:{port}"

        def get_text(path):
            with urllib.request.urlopen(base + path, timeout=10) as r:
                return r.read().decode()

        deadline = time.time() + 120
        hosts_seen = set()
        while time.time() < deadline and thread.is_alive():
            hosts_seen = set(re.findall(r'host="([^"]+)"', get_text("/metrics")))
            if len(hosts_seen) >= 2:
                break
            time.sleep(0.3)
        _check(len(hosts_seen) >= 2, f"/metrics never federated >=2 hosts mid-flight: {sorted(hosts_seen)}")
        rl = json.loads(get_text("/healthz")).get("relay") or {}
        _check(rl.get("role") == "sink", f"relay {rl}")
        _check(rl.get("hosts"), "relay sink has no sources")
        _check(not any(rec.get("stale") for rec in rl["hosts"].values()), f"a stale relay source: {rl}")
        thread.join(timeout=180)
        _check(not thread.is_alive() and not errors, f"the shuffle failed: {errors}")
        print("federation smoke ok: hosts=%s, relay=%s" % (sorted(hosts_seen), rl["hosts"]))
        runtime.shutdown()
        return 0
    finally:
        worker.kill()
        worker.wait()


if __name__ == "__main__":
    sys.exit(federation_main() if "--federation" in sys.argv[1:] else main())
