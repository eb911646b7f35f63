"""The port's relay against the JAX package's ``telemetry/relay.py``.

Parity: the same inputs through both packages' pure halves give the same
bytes: a metrics snapshot restamped (a source clock behind, ahead, and a
payload that is not JSON), and a sink's replies and landed files under one
sequence of ships (a duplicate, a gap, an overlap, a bad CRC, bad names,
a kind with no home, a replaced snapshot) and ``hello`` (a shared
directory, the cursors).

The port alone, as ``tests/test_relay.py`` does: a shipper to a sink over
the authenticated TCP transport in one process (deltas, replaces, a
reconnect that duplicates nothing), its skip-ahead past the lag bound to a
line boundary, and its survival of the sink's death; the kick of a pool
worker and of an actor waking the shipper long before its period; no
relay, SLO engine or obs server, no thread and no wake file with every
variable unset; and two hosts on loopback, each session with spools of
its own, whose audit reconciles ``ok`` at the head through the relay."""

import importlib
import json
import os
import socket
import subprocess
import sys
import textwrap
import threading
import time
import urllib.request
import zlib

import pytest

ROOTS = {"jax": "ray_shuffling_data_loader_tpu", "port": "ray_shuffling_data_loader_tpu_torch"}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KINDS = ("metrics", "events", "audit", "tasks", "capacity", "profiles")


def _relay(pkg):
    return importlib.import_module(f"{ROOTS[pkg]}.telemetry.relay")


def _crc(data: bytes) -> int:
    return zlib.crc32(data) & 0xFFFFFFFF


def _item(kind, name, data, offset=0, mode="append", crc=None):
    return {"kind": kind, "name": name, "mode": mode, "offset": offset, "data": data,
            "crc": _crc(data) if crc is None else crc}


def _mkdirs(root, kinds=KINDS):
    out = {}
    for kind in kinds:
        d = os.path.join(str(root), kind)
        os.makedirs(d, exist_ok=True)
        out[kind] = d
    return out


def _tree(root):
    """Every file under ``root``: its path relative to ``root`` and its bytes."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            with open(os.path.join(d, f), "rb") as fh:
                out[os.path.relpath(os.path.join(d, f), root)] = fh.read()
    return out


@pytest.fixture
def clean(monkeypatch):
    for key in list(os.environ):
        if key.startswith("RSDL_"):
            monkeypatch.delenv(key)
    yield
    monkeypatch.undo()
    # What a test's session left in this process's planes.
    importlib.import_module(f"{ROOTS['port']}.telemetry.metrics").refresh_from_env()
    for name in ("metrics", "events", "stragglers", "capacity", "critical", "profiler"):
        importlib.import_module(f"{ROOTS['port']}.telemetry.{name}").reset()


# -- parity ------------------------------------------------------------------------------


@pytest.mark.parametrize("producer_offset_s", [-3600.0, 3600.0, 0.0])
def test_restamp_matches_jax(producer_offset_s):
    now = 1_700_000_000.0
    rec = {"source": {"role": "actor", "host": "wk", "pid": 7}, "ts": now + producer_offset_s,
           "metrics": {"x{}": {"kind": "counter", "value": 1.0}}}
    blob = json.dumps(rec).encode()
    got = {pkg: _relay(pkg)._restamp(blob, "10.0.0.2:abcd", now) for pkg in ROOTS}
    assert got["port"] == got["jax"]
    out = json.loads(got["port"][0])
    assert out["ts"] == now and out["producer_ts"] == now + producer_offset_s
    assert out["source"] == {"role": "actor", "host": "10.0.0.2:abcd", "pid": 7, "relayed": True}
    for payload in (b"\x00not-json", b"[1, 2]"):
        assert _relay("port")._restamp(payload, "h:1", now) == _relay("jax")._restamp(payload, "h:1", now) == (
            payload, None)


def _sink_script(pkg, root):
    """One sequence of ships and hellos through ``pkg``'s sink; its replies,
    snapshot and landed files."""
    relay = _relay(pkg)
    dirs = _mkdirs(os.path.join(root, "head"))
    sink = relay.RelaySink(dirs=dirs)
    host = "10.0.0.2:abcd"
    l1, l2 = b'{"n":1}\n', b'{"n":2}\n'
    snap = json.dumps({"source": {"role": "task", "host": "wk", "pid": 5}, "ts": 17.0,
                       "metrics": {"m{}": {"kind": "counter", "value": 3.0}}}).encode()
    ships = [
        [_item("events", "events-42.ndjson", l1)],
        [_item("events", "events-42.ndjson", l1)],  # a duplicate: trimmed
        [_item("events", "events-42.ndjson", l2, offset=100)],  # a gap: want
        [_item("events", "events-42.ndjson", l1 + l2)],  # an overlap: the tail lands
        [_item("events", "events-1.ndjson", b'{"a":1}\n', crc=123)],  # a bad CRC
        [_item("events", "../events-1.ndjson", b"x\n"), _item("events", "tasks-1.ndjson", b"y\n"),
         _item("nope", "nope-1.json", b"z\n")],  # bad names, a kind of none
        [_item("metrics", "metrics-task-5.json", snap, mode="replace"),
         _item("profiles", "profile-task-5.json", b'{"p": 1}', mode="replace"),
         _item("tasks", "tasks-77.ndjson", b"a\nb\n"), _item("capacity", "ledger-77.ndjson", b"c\n"),
         _item("audit", "audit-77.jsonl", b"d\n")],
        [],  # a heartbeat
    ]
    replies = []
    for items in ships:
        replies.append(sink.ship(host, items))
    worker = _mkdirs(os.path.join(root, "worker"))
    hellos = [sink.hello(host, relay._dir_fingerprints(dict(worker, events=dirs["events"]))),
              sink.hello(host, relay._dir_fingerprints(worker)), sink.hello("other:1", None)]
    homeless = relay.RelaySink(dirs=dict(dirs, audit=None)).ship("h:1", [_item("audit", "audit-1.jsonl", b"y\n")])
    files = _tree(os.path.join(root, "head"))
    metrics_file = "metrics/metrics-10.0.0.2_abcd-task-5.json"
    landed = json.loads(files.pop(metrics_file))
    assert landed["producer_ts"] == 17.0 and landed["source"]["relayed"] is True
    snapshot = {h: {k: v for k, v in rec.items() if not k.endswith("_ts") and k != "skew_s"}
                for h, rec in sink.snapshot().items()}
    return {"replies": replies, "hellos": hellos, "homeless": homeless, "files": files, "snapshot": snapshot,
            "metrics_keys": sorted(landed), "source": landed["source"]}


def test_sink_matches_jax(tmp_path):
    got = {pkg: _sink_script(pkg, str(tmp_path / pkg)) for pkg in ROOTS}
    assert got["port"] == got["jax"]
    port = got["port"]
    assert port["files"]["events/events-10.0.0.2_abcd-42.ndjson"] == b'{"n":1}\n{"n":2}\n'
    assert port["replies"][2] == {"events/events-42.ndjson": {"want": 8}}
    assert port["replies"][4] == {"events/events-1.ndjson": {"error": "crc"}}
    assert port["hellos"][0]["skip"] == ["events"] and port["hellos"][1]["skip"] == []
    assert port["hellos"][1]["cursors"] == {"events/events-42.ndjson": 16, "tasks/tasks-77.ndjson": 4,
                                            "capacity/ledger-77.ndjson": 2, "audit/audit-77.jsonl": 2}
    assert port["homeless"] == {"audit/audit-1.jsonl": {"acked": 2}}
    assert sorted(port["files"]) == ["audit/audit-10.0.0.2_abcd-77.jsonl", "capacity/ledger-10.0.0.2_abcd-77.ndjson",
                                     "events/events-10.0.0.2_abcd-42.ndjson",
                                     "profiles/profile-10.0.0.2_abcd-task-5.json",
                                     "tasks/tasks-10.0.0.2_abcd-77.ndjson"]


def test_knobs_and_names_match_jax(monkeypatch):
    port, jax = _relay("port"), _relay("jax")
    assert (port.SINK_ACTOR_NAME, port._KINDS, port._STALE_AFTER_S) == (jax.SINK_ACTOR_NAME, jax._KINDS,
                                                                        jax._STALE_AFTER_S)
    for mode in ("", "off", "0", "false", "auto", "1"):
        monkeypatch.setenv("RSDL_RELAY", mode)
        assert port.enabled() == jax.enabled()
    for value in ("", "x", "0.01", "2", "100000000"):
        for env in (port.ENV_PERIOD, port.ENV_MAX_BATCH, port.ENV_MAX_LAG):
            monkeypatch.setenv(env, value)
        assert (port._period_s(), port._max_batch_bytes(), port._max_lag_bytes()) == (
            jax._period_s(), jax._max_batch_bytes(), jax._max_lag_bytes())
    assert port._safe_host("10.0.0.2:ab/cd") == jax._safe_host("10.0.0.2:ab/cd") == "10.0.0.2_ab_cd"


# -- the port alone --------------------------------------------------------------------


def _shipper(relay, address, worker_dirs, host_id, runtime_dir="rt"):
    from ray_shuffling_data_loader_tpu_torch.runtime.actor import ActorHandle

    return relay._Shipper(host_id, runtime_dir, lambda: ActorHandle(address()), dirs=worker_dirs)


def test_shipper_end_to_end_over_tcp(tmp_path, clean):
    relay = _relay("port")
    sink_dirs, worker_dirs = _mkdirs(tmp_path / "head"), _mkdirs(tmp_path / "worker")
    host_id = "127.0.0.1:e2e0"
    ev = os.path.join(worker_dirs["events"], "events-11.ndjson")
    with open(ev, "w") as f:
        f.write('{"e":1}\n{"e":2}\n')
    with open(os.path.join(worker_dirs["metrics"], "metrics-task-11.json"), "w") as f:
        json.dump({"source": {"host": "wk", "pid": 11}, "ts": 1.0, "metrics": {}}, f)
    server = relay._SinkServer("127.0.0.1", dirs=sink_dirs)
    server.start()
    try:
        shipper = _shipper(relay, lambda: server.address, worker_dirs, host_id)
        shipper._ship_cycle()
        landed = os.path.join(sink_dirs["events"], "events-127.0.0.1_e2e0-11.ndjson")
        assert open(landed).read() == '{"e":1}\n{"e":2}\n'
        snap = json.load(open(os.path.join(sink_dirs["metrics"], "metrics-127.0.0.1_e2e0-task-11.json")))
        assert snap["source"]["host"] == host_id
        assert shipper.ships == 1 and shipper.shipped_bytes > 0 and shipper.lag_bytes == 0
        # One more line, the snapshot unchanged: only the line ships.
        with open(ev, "a") as f:
            f.write('{"e":3}\n')
        before = shipper.shipped_bytes
        shipper._ship_cycle()
        assert open(landed).read() == '{"e":1}\n{"e":2}\n{"e":3}\n'
        assert shipper.shipped_bytes - before == len('{"e":3}\n')
        # A new shipper (its cursors lost) resumes from the sink's.
        again = _shipper(relay, lambda: server.address, worker_dirs, host_id)
        again._ship_cycle()
        assert open(landed).read() == '{"e":1}\n{"e":2}\n{"e":3}\n' and again.ship_errors == 0
        assert list(server.sink.snapshot()) == [host_id]
    finally:
        server.stop()


def test_shipper_skips_ahead_to_a_line_boundary(tmp_path, clean, monkeypatch):
    relay = _relay("port")
    monkeypatch.setenv("RSDL_RELAY_MAX_LAG_BYTES", "8192")
    monkeypatch.setenv("RSDL_RELAY_MAX_BATCH_BYTES", "4096")
    sink_dirs, worker_dirs = _mkdirs(tmp_path / "head"), _mkdirs(tmp_path / "worker")
    src = os.path.join(worker_dirs["tasks"], "tasks-5.ndjson")
    with open(src, "w") as f:
        for i in range(1500):
            f.write(json.dumps({"i": i, "pad": "x" * 20}) + "\n")
    src_bytes = open(src, "rb").read()
    assert len(src_bytes) > 3 * 8192
    server = relay._SinkServer("127.0.0.1", dirs=sink_dirs)
    server.start()
    try:
        shipper = _shipper(relay, lambda: server.address, worker_dirs, "127.0.0.1:lag0")
        for _ in range(40):
            shipper._ship_cycle()
            if shipper.lag_bytes == 0 and shipper.ships > 1:
                break
        assert shipper.lag_bytes == 0 and shipper.dropped_bytes > 0
        landed = open(os.path.join(sink_dirs["tasks"], "tasks-127.0.0.1_lag0-5.ndjson"), "rb").read()
        dropped = len(src_bytes) - len(landed)
        assert dropped == shipper.dropped_bytes
        assert src_bytes[dropped:] == landed and src_bytes[dropped - 1:dropped] == b"\n"
        for line in landed.splitlines():
            json.loads(line)
    finally:
        server.stop()


def test_shipper_survives_the_sink_s_death(tmp_path, clean):
    relay = _relay("port")
    sink_dirs, worker_dirs = _mkdirs(tmp_path / "head"), _mkdirs(tmp_path / "worker")
    ev = os.path.join(worker_dirs["events"], "events-3.ndjson")
    with open(ev, "w") as f:
        f.write("a\n")
    current = {"server": relay._SinkServer("127.0.0.1", dirs=sink_dirs)}
    current["server"].start()
    shipper = _shipper(relay, lambda: current["server"].address, worker_dirs, "127.0.0.1:die0")
    shipper._ship_cycle()
    assert shipper.ships == 1
    current["server"].stop()
    with open(ev, "a") as f:
        f.write("b\n")
    shipper._cycle_guarded()  # counted, not raised
    assert shipper.ship_errors == 1 and shipper._sink is None
    current["server"] = relay._SinkServer("127.0.0.1", dirs=sink_dirs)
    current["server"].start()
    try:
        shipper._ship_cycle()
        assert open(os.path.join(sink_dirs["events"], "events-127.0.0.1_die0-3.ndjson")).read() == "a\nb\n"
    finally:
        current["server"].stop()


class Flusher:
    """An actor whose dispatch ends at the actor barrier (and its kick)."""

    def ping(self):
        return os.environ.get("RSDL_RUNTIME_DIR")


# The kick test's sink, in a process of its own with the relay off: a sink
# served in the session's own process would wake the shipper itself (its
# dispatches end at the actor barrier, which kicks).
SINK = r"""
import json, sys
sys.path.insert(0, {repo!r})
from ray_shuffling_data_loader_tpu_torch.telemetry import relay


def main():
    server = relay._SinkServer("127.0.0.1", dirs=json.loads(sys.argv[1]))
    server.start()
    print(json.dumps(list(server.address)), flush=True)
    sys.stdin.read()  # until the test closes it
    server.stop()


if __name__ == "__main__":
    main()
"""


def test_kick_of_a_worker_and_of_an_actor_wakes_the_shipper(tmp_path, clean, monkeypatch):
    """With the relay on, the session exports its directory to every
    process it starts: a pool worker's task-done barrier and an actor's
    dispatch barrier each touch the wake file, and the shipper ships at
    once, not after its 60 s period."""
    from ray_shuffling_data_loader_tpu_torch import runtime

    relay = _relay("port")
    sink_dirs, worker_dirs = _mkdirs(tmp_path / "head"), _mkdirs(tmp_path / "worker")
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA", "RSDL_"))}
    sink = subprocess.Popen([sys.executable, "-c", SINK.format(repo=REPO), json.dumps(sink_dirs)],
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True, env=env)
    monkeypatch.setenv("RSDL_RELAY", "auto")
    monkeypatch.setenv("RSDL_RELAY_PERIOD_S", "60")
    monkeypatch.setenv("RSDL_METRICS", "1")
    metrics = importlib.import_module(f"{ROOTS['port']}.telemetry.metrics")
    metrics.refresh_from_env()
    shipper = None
    try:
        address = tuple(json.loads(sink.stdout.readline()))
        ctx = runtime.init(num_workers=1)
        assert os.environ["RSDL_RUNTIME_DIR"] == ctx.runtime_dir
        shipper = _shipper(relay, lambda: address, worker_dirs, "127.0.0.1:kick0", runtime_dir=ctx.runtime_dir)
        shipper.start()

        def ships_past(n):
            deadline = time.monotonic() + 10
            while shipper.ships <= n and time.monotonic() < deadline:
                time.sleep(0.02)
            return shipper.ships

        assert ships_past(0) == 1  # the first, at the start
        time.sleep(0.5)
        assert shipper.ships == 1  # none more on its own
        # A pool worker's task: its barrier kicks.
        assert runtime.submit(os.getpid).result(timeout=60) != os.getpid()
        assert ships_past(1) > 1, "the worker's kick did not wake the shipper"
        # An actor's dispatch: its barrier kicks too.
        actor = runtime.spawn_actor(Flusher)
        n = shipper.ships
        assert actor.call("ping") == ctx.runtime_dir
        assert ships_past(n) > n, "the actor's kick did not wake the shipper"
        assert os.path.exists(os.path.join(ctx.runtime_dir, "relay", "kick"))
    finally:
        if shipper is not None:
            shipper.stop_and_join()
        runtime.shutdown()
        sink.stdin.close()
        sink.wait(timeout=30)
        metrics.refresh_from_env()
    assert "RSDL_RUNTIME_DIR" not in os.environ


def test_every_variable_unset_loads_no_new_plane(tmp_path):
    """A fresh interpreter with no ``RSDL_*`` runs a shuffle: no relay, SLO
    engine or obs server imported, no relay thread, no wake file."""
    script = textwrap.dedent(
        f"""
        import os, sys, threading
        sys.path.insert(0, {REPO!r})
        import ray_shuffling_data_loader_tpu_torch as port
        from ray_shuffling_data_loader_tpu_torch import runtime
        from ray_shuffling_data_loader_tpu_torch.shuffle import BatchConsumer, shuffle

        class C(BatchConsumer):
            def consume(self, rank, epoch, batches): pass
            def producer_done(self, rank, epoch): pass
            def wait_until_ready(self, epoch): pass
            def wait_until_all_epochs_done(self): pass

        def main():
            files, _ = port.generate_data(128, 1, 1, 0.0, {str(tmp_path / "data")!r})
            ctx = runtime.ensure_initialized()
            shuffle(files, C(), num_epochs=1, num_reducers=1, num_trainers=1, seed=1)
            threads = [t.name for t in threading.enumerate() if t.name.startswith(("rsdl-relay", "rsdl-obs"))]
            kicks = [d for d, _, fs in os.walk(ctx.runtime_dir) if "kick" in fs]
            runtime.shutdown()
            loaded = [m for m in ("relay", "slo", "obs_server")
                      if f"ray_shuffling_data_loader_tpu_torch.telemetry.{{m}}" in sys.modules]
            print("LOADED", loaded, "THREADS", threads, "KICKS", kicks, "ENV", "RSDL_RUNTIME_DIR" in os.environ)

        if __name__ == "__main__":
            main()
        """
    )
    path = tmp_path / "drive.py"
    path.write_text(script)
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA", "RSDL_"))}
    out = subprocess.run([sys.executable, str(path)], capture_output=True, text=True, timeout=120, env=env,
                         cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr
    assert "LOADED [] THREADS [] KICKS [] ENV False" in out.stdout, out.stdout
    assert not [d for d, _, fs in os.walk(tmp_path) if "kick" in fs]


# -- two hosts, a spool each -------------------------------------------------------------

HEAD = r"""
import json, os, sys, time, urllib.request
sys.path.insert(0, {repo!r})
import ray_shuffling_data_loader_tpu_torch as port
from ray_shuffling_data_loader_tpu_torch import runtime
from ray_shuffling_data_loader_tpu_torch.telemetry import audit, export, relay, stragglers


def fail(msg):
    print("VERDICT: FAIL " + msg, flush=True)
    runtime.shutdown()
    sys.exit(1)


def main():
    ctx = runtime.init_cluster(advertise_host="127.0.0.1", num_workers=2)
    with open({addr!r} + ".tmp", "w") as f:
        f.write(ctx.cluster.address)
    os.replace({addr!r} + ".tmp", {addr!r})
    deadline = time.time() + 40
    while len(runtime.cluster_hosts()) < 2:
        if time.time() > deadline:
            fail("the other host never joined")
        time.sleep(0.1)
    files, _ = port.generate_data(2000, 4, 1, 0.0, {data!r}, seed=0)
    ds = port.ShufflingDataset(files, num_epochs=2, num_trainers=1, batch_size=250, rank=0, num_reducers=4, seed=11,
                               queue_name="q-fed")
    for epoch in range(2):
        ds.set_epoch(epoch)
        keys = sorted(k for b in ds for k in b["key"].tolist())
        if keys != list(range(2000)):
            fail(f"epoch {{epoch}}: keys")
    spool = os.environ["RSDL_METRICS_DIR"]
    other = [h for h in runtime.cluster_hosts() if h != ctx.cluster.host_id][0]
    marker = relay._safe_host(other)

    def remote(d, prefix):
        return sorted(f for f in os.listdir(d) if f.startswith(prefix + marker)) if os.path.isdir(d) else []

    ok, deadline = False, time.time() + 30
    while time.time() < deadline and not ok:
        if remote(spool, "metrics-") and remote(os.path.join(spool, "tasks"), "tasks-") and remote(
                os.environ["RSDL_AUDIT_DIR"], "audit-") and remote(os.environ["RSDL_PROFILE_DIR"], "profile-"):
            verdicts = audit.reconcile(range(2))
            ok = len(verdicts) == 2 and all(v.get("ok") is True for v in verdicts)
        time.sleep(0.2)
    if not ok:
        fail("audit not ok: " + json.dumps(audit.summary()))
    hosts = {{str((r.get("source") or {{}}).get("host")) for r in export.load_records()}}
    relayed = [r for r in export.load_records() if (r.get("source") or {{}}).get("relayed")]
    if len(hosts) < 2 or not relayed:
        fail(f"metric sources {{hosts}}")
    task_dir = os.path.join(spool, "tasks")
    remote_lines = sum(1 for f in remote(task_dir, "tasks-") for ln in open(os.path.join(task_dir, f)) if ln.strip())
    if remote_lines <= 0 or stragglers.analyze()["tasks_total"] < remote_lines:
        fail(f"remote task records {{remote_lines}}")
    get = lambda p: json.loads(urllib.request.urlopen(f"http://127.0.0.1:{{os.environ['RSDL_OBS_PORT']}}{{p}}",
                                                      timeout=10).read())
    rl = get("/healthz").get("relay") or {{}}
    if rl.get("role") != "sink" or other not in rl.get("hosts", {{}}) or rl["hosts"][other]["stale"] or not rl[
            "hosts"][other]["bytes"]:
        fail(f"/healthz relay {{rl}}")
    if get("/stragglers").get("tasks_total", 0) < remote_lines or get("/critical").get("tasks_total", 0) < remote_lines:
        fail("/stragglers or /critical without the remote tasks")
    if len(get("/status")["cluster"]["agents"]) != 2:
        fail("membership")
    print(f"VERDICT: PASS remote task records {{remote_lines}}", flush=True)
    runtime.shutdown()


if __name__ == "__main__":
    main()
"""

JOINED = r"""
import os, sys, time
sys.path.insert(0, {repo!r})
from ray_shuffling_data_loader_tpu_torch import runtime
from ray_shuffling_data_loader_tpu_torch.runtime import cluster


def main():
    deadline = time.time() + 40
    while not os.path.exists({addr!r}):
        if time.time() > deadline:
            sys.exit(2)
        time.sleep(0.1)
    ctx = runtime.init(address=open({addr!r}).read().strip(), num_workers=2)
    print(f"joined {{ctx.cluster.host_id}}", flush=True)
    cluster.serve_forever(poll_s=0.5)
    runtime.shutdown()


if __name__ == "__main__":
    main()
"""


def test_two_hosts_with_a_spool_each(tmp_path):
    """A head and a joined host on loopback, 2 workers each, every spool of
    each session its own (its runtime directory, its audit spool, its
    shared memory): the head's audit reconciles both epochs ``ok`` (the
    joined host's map and reduce records reach it only through the relay),
    the aggregate holds both hosts' sources, the joined host's task
    records fold into ``/stragglers`` and ``/critical``, and ``/healthz``
    shows it fresh."""
    addr = str(tmp_path / "address")
    base = {k: v for k, v in os.environ.items() if not k.startswith(("RSDL_", "JAX", "XLA"))}
    common = dict(base, RSDL_ADVERTISE_HOST="127.0.0.1", RSDL_METRICS="1", RSDL_RELAY="auto", RSDL_AUDIT="1",
                  RSDL_PROFILE="1")
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    obs_port = probe.getsockname()[1]
    probe.close()
    envs, procs = {}, {}
    for name in ("head", "joined"):
        for d in ("audit", "spill"):
            os.makedirs(tmp_path / f"{d}-{name}")
        envs[name] = dict(common, RSDL_AUDIT_DIR=str(tmp_path / f"audit-{name}"),
                          RSDL_SHM_DIR=f"/dev/shm/rsdl-relay-test-{os.getpid()}-{name}",
                          RSDL_SPILL_DIR=str(tmp_path / f"spill-{name}"))
    envs["head"]["RSDL_OBS_PORT"] = str(obs_port)
    scripts = {"head": HEAD.format(repo=REPO, addr=addr, data=str(tmp_path / "data")),
               "joined": JOINED.format(repo=REPO, addr=addr)}
    logs = {}
    try:
        for name in ("head", "joined"):
            path = tmp_path / f"{name}.py"
            path.write_text(scripts[name])
            logs[name] = open(tmp_path / f"{name}.log", "w")
            procs[name] = subprocess.Popen([sys.executable, str(path)], stdout=logs[name], stderr=subprocess.STDOUT,
                                           env=envs[name], cwd=str(tmp_path))
        procs["head"].wait(timeout=110)
        procs["joined"].wait(timeout=10)  # it leaves once the head's registry is gone
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for f in logs.values():
            f.close()
        for name in ("head", "joined"):
            import shutil

            shutil.rmtree(envs[name]["RSDL_SHM_DIR"], ignore_errors=True)
    out = {name: (tmp_path / f"{name}.log").read_text() for name in ("head", "joined")}
    assert "VERDICT: PASS" in out["head"], out
    assert procs["head"].returncode == 0 and procs["joined"].returncode == 0, out
