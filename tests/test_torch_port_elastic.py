"""The port's elastic control plane (``runtime/elastic.py``), the store's
tier moves and the shuffle's eviction fence, against the JAX package's.

Parity (each package on a store, a scheduler and a spool of its own, the
same inputs; comparisons exact): the fence over the same trial states; the
evictor's passes over the same segments (epochs, sizes, hardlinked windows,
cache-tier segments, reads, budget and watermarks, seeded with numpy, the
capacity ledger's wall stamps from one counter in both), where each pass's
counts, the segments demoted and dropped in their order, the events, the
gauges and the ledger's fold must be equal; the drain on fake agents (a
clean handover, a crash mid-drain falling to the backstop); the membership
of the cluster scheduler; the store's shm -> spill -> shm -> spill -> drop
lifecycle fold by fold; the spill event's rate limit; and the SLO pack's
``headroom_low`` and ``drain_stuck`` over the controller's gauges.

The port alone, as the JAX tests do: the pool's membership, a re-homed
foreign ref read here with its owner gone, the chaos acceptance run (3
files x 300 rows, a seeded ``task.map`` crash, strict audit: a scale-up, a
drain crashed mid-way, demotion and drop of the decode cache with lineage
re-making it, the ledger at 0 after clean-up), the loop's start and stop
through the session, and the zero-overhead check in a fresh interpreter."""

import collections
import importlib
import os
import signal
import subprocess
import sys
import time
import types

import numpy as np
import pytest

ROOTS = {"jax": "ray_shuffling_data_loader_tpu", "port": "ray_shuffling_data_loader_tpu_torch"}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = ("RSDL_METRICS", "RSDL_METRICS_DIR", "RSDL_EVENTS_DIR", "RSDL_OBS_PORT", "RSDL_TS", "RSDL_ELASTIC",
       "RSDL_SHM_DIR", "RSDL_SPILL_DIR", "RSDL_STORE_CAPACITY_BYTES", "RSDL_STORE_CAPACITY_FRACTION", "RSDL_AUDIT",
       "RSDL_AUDIT_STRICT", "RSDL_AUDIT_DIR", "RSDL_FAULTS", "RSDL_FAULTS_SEED", "RSDL_DRAIN_DEADLINE_S",
       "RSDL_EVICT_HIGH_WATERMARK", "RSDL_EVICT_LOW_WATERMARK", "RSDL_EVICT_COOLDOWN_S", "RSDL_EVICT_DROP_AGE_S",
       "RSDL_ELASTIC_MAX_WORKERS", "RSDL_ELASTIC_PERIOD_S", "RSDL_TRACE", "RSDL_PROFILE", "RSDL_RELAY",
       "RSDL_SERVICE", "RSDL_DECODE_CACHE_SHARED", "RSDL_INDEX_SHUFFLE")


def _mod(pkg, name):
    return importlib.import_module(f"{ROOTS[pkg]}.{name}")


def _reset(pkg):
    _mod(pkg, "telemetry.metrics").refresh_from_env()
    _mod(pkg, "telemetry.metrics").reset()
    for name in ("capacity", "events", "slo", "timeseries"):
        _mod(pkg, f"telemetry.{name}").reset()
    _mod(pkg, "telemetry.trace").reset_state()
    _mod(pkg, "runtime.cluster").reset_membership()
    _mod(pkg, "runtime.elastic").stop()


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
        _mod(pkg, "telemetry.audit").refresh_from_env()
    _mod("port", "runtime.faults").refresh_from_env()


def _arm(pkg, tmp, monkeypatch, clock=True, **extra):
    """This package's spools, directories and knobs, the metrics flags
    refreshed and the ledger empty; with ``clock``, a clock of wall stamps
    for this process's ledger records (one counter, so that both packages'
    records carry the same stamps)."""
    base = tmp / pkg
    for key, sub in (("RSDL_METRICS_DIR", "metrics"), ("RSDL_EVENTS_DIR", "events"), ("RSDL_SHM_DIR", "shm"),
                     ("RSDL_SPILL_DIR", "spill")):
        monkeypatch.setenv(key, str(base / sub))
    for key, value in extra.items():
        monkeypatch.setenv(key, str(value))
    _reset(pkg)
    if not clock:
        return None
    clock = _Clock()
    monkeypatch.setattr(_mod(pkg, "telemetry.capacity"), "time", clock)
    return clock


class _Clock:
    """``time`` for the capacity module: ``time()`` counts up by 1 s a call,
    the rest is the real module's."""

    def __init__(self):
        self.t = 1_000_000.0

    def time(self):
        self.t += 1.0
        return self.t

    def __getattr__(self, name):
        return getattr(time, name)


def _bare_ctx(store, scheduler=None):
    """What a controller reads of a session: its store, scheduler and
    cluster."""
    return types.SimpleNamespace(store=store, scheduler=scheduler if scheduler is not None else
                                 types.SimpleNamespace(width=1), cluster=None, session=store.session,
                                 runtime_dir=None)


def _events(pkg, *kinds):
    return [{k: v for k, v in r.items() if k not in ("ts", "pid", "host", "source", "seq")}
            for r in _mod(pkg, "telemetry.events").load() if r.get("kind") in kinds]


def _snapshot(pkg, *prefixes):
    snap = _mod(pkg, "telemetry.metrics").registry.snapshot()
    return {k: v for k, v in snap.items() if k.startswith(prefixes)}


# -- gating ----------------------------------------------------------------------------


def test_mode_parsing(monkeypatch):
    for raw, want in (("", False), ("off", False), ("0", False), ("false", False), ("auto", True), ("on", True),
                      ("1", True), (" ON ", True)):
        monkeypatch.setenv("RSDL_ELASTIC", raw)
        got = {pkg: (_mod(pkg, "runtime.elastic").enabled(), _mod(pkg, "runtime.elastic").mode()) for pkg in ROOTS}
        assert got["port"] == got["jax"] and got["port"][0] is want, raw


def test_maybe_start_requires_metrics(monkeypatch):
    monkeypatch.setenv("RSDL_ELASTIC", "auto")
    monkeypatch.delenv("RSDL_METRICS", raising=False)
    elastic = _mod("port", "runtime.elastic")
    _mod("port", "telemetry.metrics").refresh_from_env()
    try:
        assert elastic.maybe_start() is False and not elastic.running()
        assert elastic.controller() is None and elastic.summary() == {}
        monkeypatch.setenv("RSDL_ELASTIC", "off")
        assert elastic.maybe_start() is False
    finally:
        monkeypatch.undo()
        _mod("port", "telemetry.metrics").refresh_from_env()


# -- the single host's actuators -----------------------------------------------------


def test_pool_add_and_graceful_retire(env):
    import torch_port_helpers as helpers

    pool = _mod("port", "runtime.tasks").WorkerPool(1)
    try:
        assert pool.submit(helpers.square, 3).result(timeout=60) == 9
        assert pool.add_workers(1) == 2 and pool.num_workers == 2
        # The pill queues behind the tasks already submitted: every future
        # settles, and the retired worker leaves cleanly.
        futs = [pool.submit(helpers.sleep_then, i, 0.2) for i in range(4)]
        retired = pool.retire_workers(1, deadline_s=30.0)
        assert len(retired) == 1
        assert [f.result(timeout=60) for f in futs] == [0, 1, 2, 3]
        assert pool.num_workers == 1
        assert pool.submit(helpers.square, 5).result(timeout=60) == 25
        assert pool.retire_workers(5, deadline_s=5.0) == [] and pool.num_workers == 1  # never below one
    finally:
        pool.shutdown()


def test_controller_scales_a_pool(env, tmp_path):
    """The single-host scale-up and scale-down on a pool through the
    controller: ``scale.up`` with the new width, ``scale.down`` with the
    retired pid, the counters, and the width never under the minimum."""
    pool = _mod("port", "runtime.tasks").WorkerPool(1)
    store = _mod("port", "runtime.store").ObjectStore("scalesess", shm_dir=str(tmp_path / "shm"))
    ctl = _mod("port", "runtime.elastic").ElasticController(_bare_ctx(store, pool))
    try:
        ctl.max_workers = 2
        assert ctl._scale_up(reason="test") and pool.num_workers == 2
        assert not ctl._scale_up(reason="test")  # at the maximum
        assert ctl._scale_down(share=0.0) and pool.num_workers == 1
        assert not ctl._scale_down(share=0.0)  # at the minimum
        up, down = _events("port", "scale.up"), _events("port", "scale.down")
        assert [e["workers"] for e in up] == [2] and up[0]["reason"] == "test"
        assert len(down) == 1 and len(down[0]["retired_pids"]) == 1 and down[0]["workers"] == 1
        assert _snapshot("port", "elastic.scale_events_total") == {
            "elastic.scale_events_total{direction=up}": 1.0, "elastic.scale_events_total{direction=down}": 1.0}
        assert ctl.summary() == {"scale_events": 2, "evicted_gb": 0.0, "drains": 0}
    finally:
        pool.shutdown()


# -- the cluster's membership and the drain -------------------------------------------


class FakeAgent:
    def __init__(self, name, alive=True):
        self.address = ("tcp", name, 1)
        self.alive = alive
        self.calls = 0

    def call(self, method, *args):
        self.calls += 1
        return "ok"

    def ping(self, timeout=None):
        return self.alive


def test_scheduler_add_retire_remove_membership(env):
    def script(pkg):
        cluster = _mod(pkg, "runtime.cluster")
        cluster.reset_membership()
        a, b = FakeAgent("a"), FakeAgent("b")
        sched = cluster.ClusterScheduler([a])
        out = []
        try:
            out.append((sched.add_agent(b, num_workers=2), sched.add_agent(b), sorted(sched.agent_addresses),
                        sched.width))
            sched.retire_agent(b)
            out.append(sorted({sched._next_agent().address for _ in range(8)}))
            sched.retire_agent(a)  # every agent draining: dispatch goes on
            out.append(sched._next_agent() is not None)
            sched.add_agent(b)  # re-admission clears the drain mark
            out.append(b.address in {sched._next_agent().address for _ in range(8)})
            out.append(cluster.membership_section())
            out.append((sched.remove_agent(a), cluster.membership_section(), sorted(sched.agent_addresses)))
            return out
        finally:
            sched.shutdown()

    got = {pkg: script(pkg) for pkg in ROOTS}
    assert got["port"] == got["jax"]
    port = got["port"]
    assert port[0] == (True, False, [("tcp", "a", 1), ("tcp", "b", 1)], 3)
    assert port[1] == [("tcp", "a", 1)] and port[2] and port[3]
    rows = {r["address"]: r for r in port[4]["agents"]}
    assert rows["tcp:a:1"]["draining"] is True and rows["tcp:b:1"]["draining"] is False
    assert port[5][0] and port[5][1]["retired"] == ["tcp:a:1"] and port[5][2] == [("tcp", "b", 1)]


def test_membership_changes_in_place(env):
    """A host that joins or leaves the registry mid-epoch (a scale-up, a
    drain) changes the scheduler the epoch holds, in place: the same
    scheduler takes the new hosts, keeps a staying agent's tasks in flight,
    and stays open."""
    cluster = _mod("port", "runtime.cluster")
    hosts = {"h0:s0": {"agent": ["tcp", "h0", 1], "store": ["tcp", "h0", 2], "num_workers": 2}}
    registry = types.SimpleNamespace(call=lambda method, *a: dict(hosts), call_oneway=lambda *a: None)
    me = FakeAgent("h0")
    client = cluster.ClusterClient(registry=registry, host_id="h0:s0", advertise_host="h0", agent=me,
                                   store_server=FakeAgent("s0"), is_head=True, registry_address=("h0", 9))
    client.membership_refresh_s = 0.0
    try:
        sched = client.scheduler()
        sched._inflight_adjust(me.address, +1)
        hosts["h1:s1"] = {"agent": ["tcp", "h1", 1], "store": ["tcp", "h1", 2], "num_workers": 3}
        assert client.scheduler() is sched
        assert sched.agent_addresses == {("tcp", "h0", 1), ("tcp", "h1", 1)} and sched.width == 5
        assert sched.in_flight_on(me) == 1 and sched._find_agent(me.address) is me
        assert sched._store_to_agent[("tcp", "h1", 2)].address == ("tcp", "h1", 1)
        del hosts["h0:s0"]
        assert client.scheduler() is sched and sched.agent_addresses == {("tcp", "h1", 1)} and sched.width == 3
        # A drained agent stays out while a registry read still lists it.
        hosts["h2:s2"] = {"agent": ["tcp", "h2", 1], "store": ["tcp", "h2", 2], "num_workers": 1}
        client.scheduler()
        sched.retire_agent(("tcp", "h2", 1))
        assert sched.remove_agent(("tcp", "h2", 1))
        assert client.scheduler() is sched and sched.agent_addresses == {("tcp", "h1", 1)}
        assert not sched._executor._shutdown  # it still takes tasks
    finally:
        client.leave()


def _drain_run(pkg, tmp, monkeypatch, victim_alive, in_flight):
    _arm(pkg, tmp, monkeypatch)
    cluster, elastic = _mod(pkg, "runtime.cluster"), _mod(pkg, "runtime.elastic")
    a, b = FakeAgent("a"), FakeAgent("b", alive=victim_alive)
    sched = cluster.ClusterScheduler([a, b])
    evicted = []
    sched.on_agent_dead = evicted.append
    store = _mod(pkg, "runtime.store").ObjectStore(f"drain{pkg}")
    ctl = elastic.ElasticController(_bare_ctx(store, sched))
    try:
        if in_flight:
            sched._inflight_adjust(b.address, +1)
        t0 = time.monotonic()
        outcome = ctl.drain_host(b, deadline_s=30.0)
        waited = time.monotonic() - t0
        snap = _snapshot(pkg, "elastic.", "recovery.")
        return {"outcome": outcome, "agents": sorted(sched.agent_addresses), "drains": ctl.drains,
                "evicted": [e is b for e in evicted],
                "events": [e["kind"] for e in _events(pkg, "scale.drain", "scale.drain_done", "scale.drain_backstop",
                                                        "agent.evicted")],
                "membership": cluster.membership_section(), "snapshot": snap, "summary": ctl.summary(),
                "waited_s": waited}
    finally:
        sched.shutdown()


def test_drain_host_clean_handover(env, monkeypatch):
    got = {pkg: _drain_run(pkg, env, monkeypatch, True, False) for pkg in ROOTS}
    for run in got.values():
        run.pop("waited_s")
    assert got["port"] == got["jax"]
    port = got["port"]
    assert port["outcome"] == "drained" and port["agents"] == [("tcp", "a", 1)] and port["drains"] == 1
    assert port["events"] == ["scale.drain", "scale.drain_done"]
    assert "tcp:b:1" in port["membership"]["retired"]
    # The drain's age is back at 0 once it completes.
    assert port["snapshot"]["elastic.drain_age_seconds"] == 0.0
    assert port["snapshot"]["elastic.drains_total"] == 1.0


def test_drain_backstop_on_crash_mid_drain(env, monkeypatch):
    """A host that dies while its tasks are waited out falls to the fault
    plane's failover (``_drop_agent``, ``agent.evicted``) at once: the ping
    sees the crash, no deadline is waited."""
    got = {pkg: _drain_run(pkg, env, monkeypatch, False, True) for pkg in ROOTS}
    assert got["port"]["waited_s"] < 10.0
    for run in got.values():
        run.pop("waited_s")
    assert got["port"] == got["jax"]
    port = got["port"]
    assert port["outcome"] == "backstop" and port["agents"] == [("tcp", "a", 1)] and port["evicted"] == [True]
    assert port["events"] == ["scale.drain", "scale.drain_backstop", "agent.evicted"]
    assert port["snapshot"]["recovery.agent_evictions"] == 1.0
    assert port["snapshot"]["elastic.drain_backstops_total"] == 1.0


# -- the fence -----------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(3))
def test_protected_epochs_match_jax(seed):
    rng = np.random.default_rng(seed)
    states = ("pending", "waiting-admission", "admitted", "running", "done", "failed", "suspended")
    plan = [(e, states[int(rng.integers(len(states)))]) for e in range(int(rng.integers(2, 6)))]
    got = {}
    for pkg in ROOTS:
        shuffle = _mod(pkg, "shuffle")
        seen = [shuffle.protected_epochs()]
        shuffle._status_begin_trial(len(plan), 3, 4, 1, 0)
        try:
            for epoch, state in plan:
                shuffle._status_epoch(epoch, state=state)
                seen.append(sorted(shuffle.protected_epochs()))
        finally:
            shuffle._status_end_trial()
        seen.append(sorted(shuffle.protected_epochs()))  # between trials: empty
        got[pkg] = seen
    assert got["port"] == got["jax"]
    assert got["port"][-1] == [] and got["port"][0] == set()


def test_protected_epochs_union_of_jobs(monkeypatch):
    """With several jobs the fence is the union of the running jobs'
    windows: the port's over the JAX package's live status of two jobs."""
    jax_shuffle, port_shuffle = _mod("jax", "shuffle"), _mod("port", "shuffle")
    jax_shuffle._status_begin_trial(3, 2, 2, 1, 0, job="j1")
    jax_shuffle._status_begin_trial(3, 2, 2, 1, 0, job="j2")
    try:
        jax_shuffle._status_epoch(0, state="running", job="j1")
        jax_shuffle._status_epoch(0, state="done", job="j2")
        jax_shuffle._status_epoch(1, state="running", job="j2")
        status = jax_shuffle.live_status()
        monkeypatch.setattr(port_shuffle, "live_status", lambda: status)
        assert port_shuffle.protected_epochs() == jax_shuffle.protected_epochs() == {0, 1}
    finally:
        for job in ("j1", "j2"):
            jax_shuffle._status_end_trial(job=job)
        jax_shuffle._live_jobs.clear()


# -- the evictor -----------------------------------------------------------------------


def _evict_run(pkg, tmp, monkeypatch, script, budget, **knobs):
    """Run ``script`` on this package's store and controller; returns what
    was observed. Steps: ``("put", label, epoch, rows, kind)`` (kind
    ``plain``, ``sliced`` or ``cache``), ``("read", label)``, ``("fence",
    epochs)``, ``("evict", now_offset, force, force_drop)``, ``("promote",
    label)``, ``("free", label)``."""
    clock = _arm(pkg, tmp, monkeypatch, RSDL_STORE_CAPACITY_BYTES=budget, RSDL_EVICT_COOLDOWN_S=0, **knobs)
    store_mod, trace = _mod(pkg, "runtime.store"), _mod(pkg, "telemetry.trace")
    shuffle, capacity = _mod(pkg, "shuffle"), _mod(pkg, "telemetry.capacity")
    store = store_mod.ObjectStore(f"evict{pkg}")
    ctl = _mod(pkg, "runtime.elastic").ElasticController(_bare_ctx(store))
    refs, labels, log, out = {}, {}, [], []

    def wrap(name):
        inner = getattr(store, name)

        def call(ids):
            ids = [ids] if isinstance(ids, str) else list(ids)
            moved = inner(ids)
            log.append((name, sorted(labels[i] for i in ids), moved))
            return moved

        setattr(store, name, call)

    for name in ("demote", "drop_segments"):
        wrap(name)
    fenced = False
    try:
        for step in script:
            kind = step[0]
            if kind == "put":
                _, label, epoch, rows, how = step
                ctx = trace.context(epoch=epoch) if epoch is not None else trace.context()
                with ctx:
                    if how == "sliced":
                        pending = store.create_columns({"a": ((rows,), np.int32)})
                        pending.columns["a"][...] = np.arange(rows, dtype=np.int32)
                        refs[label] = pending.publish_slices([(0, rows // 2), (rows // 2, rows)])
                    elif how == "cache":
                        pending = store.create_columns({"a": ((rows,), np.int32)}, ledger_tier="cache")
                        pending.columns["a"][...] = np.arange(rows, dtype=np.int32)
                        refs[label] = [pending.seal()]
                    else:
                        refs[label] = [store.put_columns({"a": np.arange(rows, dtype=np.int32)})]
                for ref in refs[label]:
                    labels[ref.object_id] = label
                out.append(("put", label, refs[label][0].nbytes,
                            store.tier_of(store._find_segment(refs[label][0].object_id))))
            elif kind == "read":
                ref = refs[step[1]][0]
                out.append(("read", step[1], int(store.get_columns(ref)["a"][1])))
            elif kind == "fence":
                shuffle._status_begin_trial(4, 1, 1, 1, 0)
                fenced = True
                for epoch in range(4):
                    shuffle._status_epoch(epoch, state="running" if epoch in step[1] else "done")
            elif kind == "evict":
                _, offset, force, force_drop = step
                stats = ctl.evict_once(now=clock.t + offset, force=force, force_drop=force_drop)
                out.append(("evict", stats))
            elif kind == "promote":
                out.append(("promote", step[1], store.promote([r.object_id for r in refs[step[1]]])))
            elif kind == "free":
                store.free(refs.pop(step[1]))
        tiers = {}
        for label, rs in refs.items():
            paths = [store._find_segment(r.object_id) for r in rs]
            tiers[label] = None if paths[0] is None else (store.tier_of(paths[0]), len({os.stat(p).st_ino
                                                                                         for p in paths if p}))
            for r in rs:
                if paths[0] is not None:
                    cb = store.get_columns(r)
                    assert cb.num_rows == (r.rows[1] - r.rows[0] if r.rows else cb.num_rows)
        fold = capacity.ledger(now=clock.t + 1.0)
        return {"out": out, "log": log, "tiers": tiers, "fold": {k: fold[k] for k in ("epochs", "totals",
                                                                                         "live_segments")},
                "events": _events(pkg, "evict.demote", "evict.drop"),
                "snapshot": _snapshot(pkg, "elastic.", "store.tier_moved"), "summary": ctl.summary(),
                "stats": store.store_stats(), "budget": store.capacity_bytes}
    finally:
        if fenced:
            shuffle._status_end_trial()
        store.cleanup()


def _parity(tmp, monkeypatch, script, budget, **knobs):
    got = {pkg: _evict_run(pkg, tmp, monkeypatch, script, budget, **knobs) for pkg in ROOTS}
    jax_stats, port_stats = got["jax"].pop("stats"), got["port"].pop("stats")
    assert vars(port_stats) == vars(jax_stats)
    assert got["port"] == got["jax"]
    return got["port"]


def test_evictor_demote_then_drop_with_fence(env, monkeypatch):
    script = [("put", "cold", 0, 4096, "plain"), ("put", "hot", 1, 4096, "plain"), ("fence", {1}),
              ("evict", 0.0, True, False), ("read", "cold"), ("evict", 0.0, False, True)]
    run = _parity(env, monkeypatch, script, 1 << 20)
    # The forced pass demoted the cold epoch alone (the fence holds epoch
    # 1), readable in place; the drop rung then removed it.
    assert run["out"][2] == ("evict", {"demoted": 1, "demoted_bytes": run["out"][0][2], "dropped": 0,
                                       "dropped_bytes": 0})
    assert run["out"][3] == ("read", "cold", 1)
    assert run["out"][4][1]["dropped"] == 1
    assert run["log"] == [("demote", ["cold"], run["out"][0][2]), ("drop_segments", ["cold"], run["out"][0][2])]
    assert run["tiers"] == {"cold": None, "hot": ("shm", 1)}
    assert run["fold"]["epochs"]["0"]["shm"]["resident_bytes"] == 0
    assert run["fold"]["epochs"]["0"]["spill"]["resident_bytes"] == 0
    assert run["fold"]["epochs"]["0"]["spill"]["hwm_bytes"] == run["out"][0][2]
    assert [e["kind"] for e in run["events"]] == ["evict.demote", "evict.drop"]
    assert run["summary"]["evicted_gb"] > 0


def test_evictor_pressure_watermarks(env, monkeypatch):
    """Without force the evictor acts only above the high watermark and
    demotes down to the low one; the windows of a sliced segment move
    together."""
    script = [("put", "small", 0, 100, "plain"), ("evict", 0.0, False, False)]
    script += [("put", f"sliced{i}", 0, 12000, "sliced") for i in range(4)]
    script += [("evict", 0.0, False, False)]
    run = _parity(env, monkeypatch, script, 200_000)
    assert run["out"][1] == ("evict", {"demoted": 0, "demoted_bytes": 0, "dropped": 0, "dropped_bytes": 0})
    assert run["out"][-1][1]["demoted"] >= 1
    assert run["fold"]["totals"]["shm"]["resident_bytes"] <= 0.6 * 200_000
    demoted = [labels[0] for op, labels, _ in run["log"] if op == "demote"]
    for label in demoted:
        assert run["tiers"][label] == ("spill", 1)  # both windows, one inode
    assert run["snapshot"]["store.tier_moved_bytes_total{tier=spill}"] == sum(m for _, _, m in run["log"])


def test_evictor_orders_by_last_touch(env, monkeypatch):
    """An older epoch read last stays; the newer, idle one goes first."""
    script = [("put", "old_hot", 0, 25_000, "plain"), ("put", "new_cold", 1, 25_000, "plain"),
              ("read", "old_hot"), ("evict", 0.0, False, False)]
    run = _parity(env, monkeypatch, script, 230_000)
    assert run["out"][-1][1]["demoted"] == 1
    assert run["tiers"] == {"old_hot": ("shm", 1), "new_cold": ("spill", 1)}


def test_evictor_cache_tier_drops_first(env, monkeypatch):
    """The cache tier is the first rung: its segment drops and that alone
    reaches the low watermark; the epoch's segment stays on shm."""
    script = [("put", "epoch_seg", 0, 25_000, "plain"), ("put", "cache_seg", 0, 25_000, "cache"),
              ("evict", 0.0, False, False)]
    run = _parity(env, monkeypatch, script, 230_000)
    assert run["out"][-1][1]["dropped"] == 1 and run["out"][-1][1]["demoted"] == 0
    assert run["tiers"] == {"epoch_seg": ("shm", 1), "cache_seg": None}
    assert run["fold"]["totals"]["cache"]["resident_bytes"] == 0


def test_evictor_one_pressured_pass_fires_both_rungs_at_drop_age_zero(env, monkeypatch):
    """With a drop age of 0 one unforced pass under pressure demotes the
    cold epoch's segments down to the low watermark and then drops them
    from spill: both events come from the one pass, and the fenced epoch
    stays on shm."""
    script = [("put", "cold_a", 0, 25_000, "plain"), ("put", "cold_b", 0, 25_000, "plain"),
              ("put", "hot", 1, 4096, "plain"), ("fence", {1}), ("evict", 0.0, False, False)]
    run = _parity(env, monkeypatch, script, 230_000, RSDL_EVICT_DROP_AGE_S=0)
    stats = run["out"][-1][1]
    assert stats["demoted"] >= 1 and stats["dropped"] == stats["demoted"]
    assert stats["dropped_bytes"] == stats["demoted_bytes"]
    assert [e["kind"] for e in run["events"]] == ["evict.demote", "evict.drop"]
    assert run["tiers"]["hot"] == ("shm", 1)
    assert [op for op, _, _ in run["log"]] == ["demote"] * stats["demoted"] + ["drop_segments"] * stats["dropped"]


def test_evictor_never_drops_a_delivered_batch(env, monkeypatch):
    """A delivered batch of an epoch out of the fence may be demoted (it
    stays readable) but no drop rung takes it, forced or not: the trainer
    may not have read it, and no lineage re-makes it. The decode cache's
    segment beside it drops."""
    clock = _arm("port", env, monkeypatch, RSDL_STORE_CAPACITY_BYTES=1 << 20)
    shuffle, trace = _mod("port", "shuffle"), _mod("port", "telemetry.trace")
    store = _mod("port", "runtime.store").ObjectStore("deliversess")
    ctl = _mod("port", "runtime.elastic").ElasticController(_bare_ctx(store))
    shuffle._status_begin_trial(2, 1, 1, 1, 0)
    try:
        with trace.context(epoch=0):
            cache = store.put_columns({"a": np.arange(1000, dtype=np.int32)})
            pending = store.create_columns({"a": ((1000,), np.int32)})
            pending.columns["a"][...] = np.arange(1000, dtype=np.int32)
            batch = pending.publish_slices([(0, 500), (500, 1000)])
        shuffle._status_delivered(batch)
        shuffle._status_epoch(0, state="done")
        shuffle._status_epoch(1, state="running")
        assert shuffle.delivered_ids() == {r.object_id for r in batch}
        assert ctl.evict_once(now=clock.t, force=True)["demoted"] == 2
        stats = ctl.evict_once(now=clock.t + 1000.0, force_drop=True)
        assert stats["dropped"] == 1 and stats["dropped_bytes"] == cache.nbytes
        assert store._find_segment(cache.object_id) is None
        assert [int(store.get_columns(r)["a"][-1]) for r in batch] == [499, 999]
        assert store.tier_of(store._find_segment(batch[0].object_id)) == "spill"
        shuffle._status_begin_trial(1, 1, 1, 1, 0)  # a new trial forgets them
        assert shuffle.delivered_ids() == set()
    finally:
        shuffle._status_end_trial()
        store.cleanup()


def _seeded_script(seed):
    """Segments of several epochs (and none), kinds and sizes; reads; a
    fence; pressure passes, a pass past the drop age and forced ones."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(8, 14))
    script, total = [], 0
    for i in range(n):
        epoch = None if rng.random() < 0.15 else int(rng.integers(4))
        rows = int(rng.integers(1000, 12000))
        how = ("plain", "sliced", "cache")[int(rng.choice(3, p=[0.6, 0.25, 0.15]))]
        script.append(("put", f"s{i}", epoch, rows, how))
        total += rows * 4 + 256
        if rng.random() < 0.3:
            script.append(("read", f"s{int(rng.integers(i + 1))}"))
    fence = {int(e) for e in rng.choice(4, size=int(rng.integers(0, 3)), replace=False)}
    script.append(("fence", fence))
    drop_age = float(rng.integers(3, 20))
    script += [("evict", 0.0, False, False), ("evict", drop_age + 50.0, False, False), ("promote", "s0"),
               ("evict", 0.0, bool(rng.random() < 0.5), False), ("evict", 0.0, False, True)]
    budget = int(total / rng.uniform(0.9, 1.3))
    high = round(float(rng.uniform(0.55, 0.9)), 3)
    return script, budget, {"RSDL_EVICT_HIGH_WATERMARK": high, "RSDL_EVICT_LOW_WATERMARK": round(high - 0.25, 3),
                            "RSDL_EVICT_DROP_AGE_S": drop_age}


@pytest.mark.parametrize("seed", range(4))
def test_evictor_seeded_passes_match_jax(env, monkeypatch, seed):
    script, budget, knobs = _seeded_script(seed)
    run = _parity(env, monkeypatch, script, budget, **knobs)
    assert any(op == "evict" and stats["demoted"] + stats["dropped"] for op, stats in
               [o for o in run["out"] if o[0] == "evict"])
    # A segment of no known epoch is never moved.
    unknown = {step[1] for step in script if step[0] == "put" and step[2] is None}
    assert not unknown & {label for _, labels, _ in run["log"] for label in labels}


# -- the store's tier moves --------------------------------------------------------------


def _lifecycle(pkg, tmp, monkeypatch):
    clock = _arm(pkg, tmp, monkeypatch)
    store_mod, trace, capacity = _mod(pkg, "runtime.store"), _mod(pkg, "telemetry.trace"), _mod(
        pkg, "telemetry.capacity")
    store = store_mod.ObjectStore(f"tier{pkg}")
    folds = []

    def fold():
        folded = capacity.ledger(now=clock.t)
        folds.append({k: folded[k] for k in ("epochs", "totals", "live_segments")})
        return folded

    try:
        with trace.context(epoch=3):
            ref = store.put_columns({"a": np.arange(256, dtype=np.int32)})
            pending = store.create_columns({"b": ((64,), np.int32)})
            sliced = pending.publish_slices([(0, 32), (32, 64)])
        link_ids = [r.object_id for r in sliced]
        fold()
        moves = [store.demote(ref.object_id)]
        fold()
        assert store.tier_of(store._find_segment(ref.object_id)) == "spill"
        assert store.get_columns(ref)["a"][11] == 11
        moves.append(store.promote(ref.object_id))
        fold()
        moves.append(store.demote(link_ids))
        assert [store.get_columns(r).num_rows for r in sliced] == [32, 32]
        fold()
        moves += [store.demote(ref.object_id), store.drop_segments(ref.object_id), store.drop_segments(link_ids)]
        fold()
        with pytest.raises(store_mod.ObjectLostError):
            store.get_columns(ref)
        return {"nbytes": (ref.nbytes, sliced[0].nbytes), "moves": moves, "folds": folds,
                "live": capacity.live_segments(), "snapshot": _snapshot(pkg, "store.tier_moved")}
    finally:
        store.cleanup()


def test_store_demote_promote_drop_real_lifecycle(env, monkeypatch):
    """Per-tier residency and high watermarks exact through shm -> spill ->
    shm -> spill -> drop, a hardlinked segment moving all its links."""
    got = {pkg: _lifecycle(pkg, env, monkeypatch) for pkg in ROOTS}
    assert got["port"] == got["jax"]
    run = got["port"]
    nbytes, sliced_bytes = run["nbytes"]
    assert run["moves"] == [nbytes, nbytes, sliced_bytes, nbytes, nbytes, sliced_bytes]
    f = run["folds"]
    assert f[0]["epochs"]["3"]["shm"]["resident_bytes"] == f[0]["epochs"]["3"]["shm"]["hwm_bytes"] == (
        nbytes + sliced_bytes)
    cell = f[1]["epochs"]["3"]
    assert cell["shm"]["resident_bytes"] == sliced_bytes and cell["shm"]["freed_bytes"] == 0
    assert cell["shm"]["hwm_bytes"] == nbytes + sliced_bytes and cell["spill"]["resident_bytes"] == nbytes
    assert f[2]["epochs"]["3"]["shm"]["resident_bytes"] == nbytes + sliced_bytes
    assert f[2]["epochs"]["3"]["spill"]["resident_bytes"] == 0 and f[2]["epochs"]["3"]["spill"]["hwm_bytes"] == nbytes
    assert f[3]["epochs"]["3"]["spill"]["resident_bytes"] == sliced_bytes
    assert f[3]["epochs"]["3"]["spill"]["segments"] == 1
    assert f[4]["totals"]["shm"]["resident_bytes"] == f[4]["totals"]["spill"]["resident_bytes"] == 0
    assert f[4]["live_segments"] == 0 and run["live"] == []
    assert run["snapshot"] == {"store.tier_moved_bytes_total{tier=spill}": float(2 * nbytes + sliced_bytes),
                               "store.tier_moved_bytes_total{tier=shm}": float(nbytes)}


def test_tier_moves_budget_and_unfinished_names(env, monkeypatch, tmp_path):
    """A promote past the budget moves nothing; each move corrects the
    residency estimate between scans (a demote frees, a promote fills);
    an in-flight copy (``.tmp``) is no segment to ``store_stats``,
    ``list_segments`` or ``_session_files``."""
    _arm("port", env, monkeypatch, RSDL_STORE_CAPACITY_BYTES=10_000)
    store_mod = _mod("port", "runtime.store")
    store = store_mod.ObjectStore("movesess")
    try:
        a = store.put_columns({"a": np.zeros(1000, np.int32)})
        b = store.put_columns({"a": np.zeros(1000, np.int32)})
        before = store._shm_session_bytes()
        assert store.demote(a.object_id) == a.nbytes
        assert store._shm_session_bytes() == before - a.nbytes  # inside the scan window
        c = store.put_columns({"a": np.zeros(1000, np.int32)})
        assert store.tier_of(store._find_segment(c.object_id)) == "shm"
        # a back on shm would pass the budget: refused, it stays spilled.
        assert store.promote(a.object_id) == 0
        assert store.tier_of(store._find_segment(a.object_id)) == "spill"
        store.free(c)
        store._scan_at = float("-inf")
        assert store.promote(a.object_id) == a.nbytes
        assert store._shm_session_bytes() == a.nbytes + b.nbytes
        assert store.promote(a.object_id) == 0 and store.demote("no-such-segment") == 0
        # A copy still being written, as _move_tier names it.
        tmp = os.path.join(store.spill_dir, f"{b.object_id}.move-1-abcd.tmp")
        with open(tmp, "wb") as f:
            f.write(b"x" * 4096)
        server = _mod("port", "runtime.cluster").StoreServer(store.shm_dir)
        assert {name for name, _ in server.list_segments("movesess-")} == {a.object_id, b.object_id}
        assert vars(store.store_stats()) == {"num_objects": 2, "total_bytes": a.nbytes + b.nbytes,
                                             "spill_bytes": 0}
        assert not any(n.endswith(".tmp") for n, _ in store._session_files(store.spill_dir))
        os.unlink(tmp)
    finally:
        store.cleanup()


def test_spill_volume_exact_under_rate_limit(env, monkeypatch):
    """The spill event's rate limit drops no byte: every spill counts into
    ``store.spill_bytes_total`` and the next event carries the bytes of the
    ones it folded (the port's ``_note_spill``, the JAX package's
    ``_emit_spill_event``)."""
    got = {}
    for pkg in ROOTS:
        _arm(pkg, env, monkeypatch)
        store_mod = _mod(pkg, "runtime.store")
        note = store_mod._note_spill if pkg == "port" else store_mod._emit_spill_event
        monkeypatch.setattr(store_mod, "_spill_event_last", 0.0)
        monkeypatch.setattr(store_mod, "_spill_pending_bytes", 0)
        monkeypatch.setattr(store_mod, "_spill_pending_events", 0)
        note(100)
        note(200)
        note(300)
        monkeypatch.setattr(store_mod, "_spill_event_last", 0.0)  # the interval opens
        note(400)
        spills = _events(pkg, "store.spill")
        got[pkg] = (_snapshot(pkg, "store.spill"), spills)
    assert got["port"] == got["jax"]
    snap, spills = got["port"]
    assert snap["store.spill_bytes_total"] == 1000.0
    assert [(s["nbytes"], s["events_folded"]) for s in spills] == [(100, 1), (900, 3)]


def test_rehomed_foreign_ref_reads_locally(env, monkeypatch, tmp_path):
    """A drain's re-home: the draining host's segments (its session's
    prefix) are copied into this store under their own ids, adopted, and
    noted as ``transition``s; a foreign ref of them then reads here with
    its owner gone (no fetch), and its free unlinks the copy."""
    _arm("port", env, monkeypatch)
    store_mod, cluster = _mod("port", "runtime.store"), _mod("port", "runtime.cluster")
    elastic, capacity = _mod("port", "runtime.elastic"), _mod("port", "telemetry.capacity")
    owner = store_mod.ObjectStore("ownersess", shm_dir=str(tmp_path / "owner-shm"))
    owner.owner_address = ("tcp", "owner", 1)
    server = cluster.StoreServer(owner.shm_dir)
    ref = owner.put_columns({"a": np.arange(5000, dtype=np.int32)})
    pending = owner.create_columns({"a": ((100,), np.int32)})
    pending.columns["a"][...] = np.arange(100, dtype=np.int32)
    windows = pending.publish_slices([(0, 40), (40, 100)])
    gone = owner.put_columns({"a": np.zeros(10, np.int32)})

    class Handle:  # the store server as its actor handle calls it
        def call(self, method, *args):
            if method == "fetch" and args[0] == gone.object_id:
                owner.free(gone)  # freed at its owner while the drain runs
            return getattr(server, method)(*args)

    reader = store_mod.ObjectStore("readsess", shm_dir=str(tmp_path / "reader-shm"),
                                   sessions_file=str(tmp_path / "adopted"))
    reader.owner_address = ("tcp", "reader", 1)
    fetched = []

    def dead_owner(r):
        fetched.append(r)
        raise store_mod.ObjectLostError(r.object_id, "owner gone")

    reader.remote_fetch = dead_owner
    reader.remote_free = lambda r: None
    registry = types.SimpleNamespace(call=lambda method, *a: {"ownerhost:ownersess": {
        "agent": ["tcp", "a", 1], "store": ["tcp", "owner", 1]}})
    ctx = types.SimpleNamespace(store=reader, scheduler=None, session="readsess", runtime_dir=None,
                                cluster=types.SimpleNamespace(registry=registry, _peer_store=lambda a: Handle()))
    ctl = elastic.ElasticController(ctx)
    try:
        moved = ctl._rehome_segments(FakeAgent("a"))
        assert moved == ref.nbytes + windows[0].nbytes  # the sliced segment's two names copied once
        assert reader.adopted_sessions() == ["ownersess"]
        assert reader.store_stats().num_objects == 3 and reader._find_segment(gone.object_id) is None
        assert vars(reader.store_stats())["total_bytes"] == moved
        paths = [reader._find_segment(w.object_id) for w in windows]
        assert os.stat(paths[0]).st_ino == os.stat(paths[1]).st_ino
        ops = [r for r in capacity.load_records() if r["op"] == "transition"]
        assert len(ops) == 2 and {r["tier"] for r in ops} == {"shm"}
        assert {r["id"] for r in ops} <= {ref.object_id, *(w.object_id for w in windows)}
        assert _events("port", "scale.rehomed")[0]["nbytes"] == moved
        owner.cleanup()  # the owner leaves
        assert reader.is_foreign(ref) and not reader.needs_fetch(ref)
        assert np.array_equal(reader.get_columns(ref)["a"], np.arange(5000, dtype=np.int32))
        assert [int(reader.get_columns(w)["a"][-1]) for w in windows] == [39, 99]
        assert fetched == []
        reader.free([ref, *windows])
        assert reader.store_stats().num_objects == 0
        assert ctl._rehome_segments(FakeAgent("a")) == 0  # nothing left to hand over
    finally:
        owner.cleanup()
        reader.cleanup()


def test_rehome_counts_arrivals_and_leaves_cache_copies(env, monkeypatch, tmp_path):
    """A re-home onto a host whose ledger never saw the segments created
    (each host spools its own): each copy notes a ``fetch`` of its bytes
    before its ``transition``, so that the ledger's residency by tier equals
    the store's through the frees. The draining host's copy of a segment of
    this host (``<session>-cache-<id>``, which no ref names) stays behind:
    copied, nothing would ever free it."""
    _arm("port", env, monkeypatch)
    store_mod, cluster = _mod("port", "runtime.store"), _mod("port", "runtime.cluster")
    elastic, capacity = _mod("port", "runtime.elastic"), _mod("port", "telemetry.capacity")
    owner = store_mod.ObjectStore("ownersess", shm_dir=str(tmp_path / "owner-shm"))
    server = cluster.StoreServer(owner.shm_dir)
    ref = owner.put_columns({"a": np.arange(5000, dtype=np.int32)})
    pending = owner.create_columns({"a": ((100,), np.int32)})
    windows = pending.publish_slices([(0, 40), (40, 100)])
    capacity.reset(clear_spool=True)  # the owner's creates are another host's records
    reader = store_mod.ObjectStore("readsess", shm_dir=str(tmp_path / "reader-shm"),
                                   sessions_file=str(tmp_path / "adopted"))
    mine = reader.put_columns({"a": np.arange(3000, dtype=np.int32)})
    copy_name = f"ownersess-cache-{mine.object_id}"  # as a read of it on the owner's host names it
    with open(reader._find_segment(mine.object_id), "rb") as src, open(os.path.join(owner.shm_dir, copy_name),
                                                                        "wb") as dst:
        dst.write(src.read())
    registry = types.SimpleNamespace(call=lambda method, *a: {"ownerhost:ownersess": {
        "agent": ["tcp", "a", 1], "store": ["tcp", "owner", 1]}})
    handle = types.SimpleNamespace(call=lambda method, *a: getattr(server, method)(*a))
    ctx = types.SimpleNamespace(store=reader, scheduler=None, session="readsess", runtime_dir=None,
                                cluster=types.SimpleNamespace(registry=registry, _peer_store=lambda a: handle))
    ctl = elastic.ElasticController(ctx)

    def tiers():
        totals, st = capacity.ledger()["totals"], reader.store_stats()
        return ((capacity.shm_resident_bytes(totals), totals["spill"]["resident_bytes"]),
                (st.total_bytes - st.spill_bytes, st.spill_bytes))

    try:
        moved = ctl._rehome_segments(FakeAgent("a"))
        assert moved == ref.nbytes + windows[0].nbytes
        assert reader._find_segment(copy_name) is None and reader.store_stats().num_objects == 4
        ops = [(r["op"], r["id"], r.get("nbytes")) for r in capacity.load_records() if r["op"] != "create"]
        assert [op for op, _, _ in ops] == ["fetch", "transition"] * 2
        assert sorted(n for op, _, n in ops if op == "fetch") == sorted([ref.nbytes, windows[0].nbytes])
        assert tiers() == ((moved + mine.nbytes, 0),) * 2
        assert ctl._rehome_segments(FakeAgent("a")) == 0  # nothing left to hand over
        reader.free([ref, windows[0]])
        assert tiers() == ((windows[0].nbytes + mine.nbytes, 0),) * 2  # one link of the sliced segment left
        reader.free([windows[1], mine])
        assert tiers() == ((0, 0),) * 2
    finally:
        owner.cleanup()
        reader.cleanup()


@pytest.mark.parametrize("when", ["copy", "unlink"])
def test_demote_racing_a_free_leaves_nothing(env, monkeypatch, when):
    """A free that lands while the evictor demotes the segment (during the
    copy, or after the copy is published and before the sources go) leaves
    no copy behind in the spill directory, and the ledger agrees."""
    _arm("port", env, monkeypatch)
    store_mod, capacity = _mod("port", "runtime.store"), _mod("port", "telemetry.capacity")
    store = store_mod.ObjectStore("racesess")
    pending = store.create_columns({"a": ((64,), np.int32)})
    windows = pending.publish_slices([(0, 32), (32, 64)])
    target = "copyfileobj" if when == "copy" else "link"
    module = __import__("shutil") if when == "copy" else os
    real = getattr(module, target)

    def racing(*args, **kwargs):
        store.free(windows)  # the reader frees both names
        return real(*args, **kwargs)

    monkeypatch.setattr(module, target, racing)
    try:
        moved = store.demote([w.object_id for w in windows])
        monkeypatch.setattr(module, target, real)
        assert moved == 0
        assert os.listdir(store.spill_dir) == [] and os.listdir(store.shm_dir) == []
        assert capacity.ledger()["live_segments"] == 0
        assert [r["op"] for r in capacity.load_records()] == ["create", "delete", "delete"]
    finally:
        monkeypatch.setattr(module, target, real)
        store.cleanup()


# -- the SLO pack over the controller's gauges ----------------------------------------------


def _slo_run(pkg, tmp, monkeypatch):
    _arm(pkg, tmp, monkeypatch, RSDL_STORE_CAPACITY_BYTES=16384)
    store_mod, trace, slo = _mod(pkg, "runtime.store"), _mod(pkg, "telemetry.trace"), _mod(pkg, "telemetry.slo")
    metrics = _mod(pkg, "telemetry.metrics")
    store = store_mod.ObjectStore(f"slo{pkg}")
    ctl = _mod(pkg, "runtime.elastic").ElasticController(_bare_ctx(store))
    out = []

    def evaluate(now):
        body = slo.evaluate(now=now)
        out.append((sorted(body["active"]), metrics.registry.snapshot().get("alert.active{rule=headroom_low}"),
                    metrics.registry.snapshot().get("alert.active{rule=drain_stuck}")))

    try:
        with trace.context(epoch=0):
            store.put_columns({"a": np.zeros(3800, np.int32)})  # about 15 KiB of the 16
        ctl.publish_gauges()
        out.append(round(metrics.registry.snapshot()["elastic.shm_headroom_frac"], 6))
        evaluate(100.0)
        out.append(ctl.evict_once(force=True))
        ctl.publish_gauges()
        evaluate(101.0)
        ctl._drain_started[("tcp", "w", 1)] = time.monotonic() - 60.0
        ctl.publish_gauges()
        evaluate(102.0)
        ctl._drain_started.clear()
        ctl.publish_gauges()
        evaluate(103.0)
        alerts = [(e["kind"], e.get("rule")) for e in _events(pkg, "alert.fired", "alert.resolved")]
        return {"out": out, "alerts": alerts}
    finally:
        store.cleanup()


def test_headroom_low_and_drain_stuck_fire_and_resolve(env, monkeypatch):
    got = {pkg: _slo_run(pkg, env, monkeypatch) for pkg in ROOTS}
    assert got["port"] == got["jax"]
    out = got["port"]["out"]
    assert out[0] < 0.1 and "headroom_low" in out[1][0] and out[1][1] == 1.0
    assert out[2]["demoted"] == 1 and "headroom_low" not in out[3][0]
    assert "drain_stuck" in out[4][0] and "drain_stuck" not in out[5][0]
    assert ("alert.resolved", "headroom_low") in got["port"]["alerts"]
    assert ("alert.resolved", "drain_stuck") in got["port"]["alerts"]


# -- the session's loop -------------------------------------------------------------------


def test_session_starts_and_stops_the_loop(env, monkeypatch):
    """``RSDL_ELASTIC=on`` with metrics: the session owner's start-up runs
    the loop (a thread ``rsdl-elastic`` ticking every period, publishing
    the gauges), and its shutdown stops it."""
    import threading

    _arm("port", env, monkeypatch, RSDL_ELASTIC="on", RSDL_ELASTIC_PERIOD_S="0.1")
    runtime, elastic = _mod("port", "runtime"), _mod("port", "runtime.elastic")
    runtime.init(num_workers=1)
    try:
        assert elastic.running() and elastic.period_s() == pytest.approx(0.1)
        ctl = elastic.controller()
        assert ctl is not None and ctl._ctx is runtime.get_context()
        assert ctl._sched_width() == 1 and runtime.get_context()._pool is None  # read without starting it
        deadline = time.monotonic() + 10
        while "elastic.workers" not in _snapshot("port", "elastic.") and time.monotonic() < deadline:
            time.sleep(0.05)
        assert _snapshot("port", "elastic.workers") == {"elastic.workers": 1.0}
    finally:
        runtime.shutdown()
    assert not elastic.running() and elastic.controller() is None
    assert not any(t.name == "rsdl-elastic" for t in threading.enumerate())


# -- the chaos acceptance run ----------------------------------------------------------------

NUM_FILES = 3
ROWS_PER_FILE = 300
TOTAL_ROWS = NUM_FILES * ROWS_PER_FILE


class CollectingConsumer:
    def __init__(self, store):
        self.store = store
        self.keys = collections.defaultdict(list)
        self.done = collections.defaultdict(bool)

    def consume(self, rank, epoch, batches):
        for ref in batches:
            self.keys[(epoch, rank)].extend(self.store.get_columns(ref)["key"].tolist())
            self.store.free(ref)

    def producer_done(self, rank, epoch):
        self.done[(epoch, rank)] = True

    def wait_until_ready(self, epoch):
        pass

    def wait_until_all_epochs_done(self):
        pass


def _counter(prefix):
    return sum(v for k, v in _mod("port", "telemetry.metrics").registry.snapshot().items() if k.startswith(prefix))


def test_chaos_scale_drain_evict_audit_ok(env, monkeypatch, tmp_path_factory):
    """Under a seeded fault schedule: a scale-up admits a new host agent, a
    drain meets a crash mid-way and falls to the failover, the decode
    cache's segments are demoted (still readable) and dropped, and the next
    epoch re-makes them from lineage; strict audit reconciles every epoch,
    and the ledger's residency is 0 after clean-up."""
    from ray_shuffling_data_loader_tpu_torch import runtime, telemetry
    from ray_shuffling_data_loader_tpu_torch.data_generation import generate_file
    from ray_shuffling_data_loader_tpu_torch.runtime import actor as actor_mod
    from ray_shuffling_data_loader_tpu_torch.runtime.cluster import ClusterScheduler, HostAgent
    from ray_shuffling_data_loader_tpu_torch.telemetry import audit, capacity

    shuffle = _mod("port", "shuffle")
    _arm("port", env, monkeypatch, RSDL_AUDIT=1, RSDL_AUDIT_STRICT=1, RSDL_AUDIT_DIR=env / "audit",
         RSDL_FAULTS="task.map/task:crash-entry:0.05x1", RSDL_FAULTS_SEED=31, RSDL_ELASTIC_MAX_WORKERS=8,
         clock=False)  # the workers stamp their records with the real clock
    audit.refresh_from_env()
    _mod("port", "runtime.faults").refresh_from_env()
    data_dir = tmp_path_factory.mktemp("elastic-chaos-data")
    files = [generate_file(i, i * ROWS_PER_FILE, ROWS_PER_FILE, 1, str(data_dir))[0] for i in range(NUM_FILES)]
    ctx = runtime.init(num_workers=2)
    audit.begin_run()
    agents = [actor_mod.spawn_actor(HostAgent, ctx.runtime_dir, 1, None, runtime_dir=ctx.runtime_dir, daemon=False)
              for _ in range(2)]
    sched = ClusterScheduler(list(agents), width=2)
    ctx.cluster = types.SimpleNamespace(scheduler=lambda: sched)
    ctl = _mod("port", "runtime.elastic").ElasticController(ctx)
    try:
        # (1) A scale-up: a new agent joins the rotation.
        assert ctl._scale_up(reason="test-forced")
        assert len(sched.agent_addresses) == 3 and ctl.scale_events == 1
        assert _events("port", "scale.up")[-1]["reason"] == "test-forced"
        added_host_id, added_agent = ctl._added_agents[-1]
        # The decode cache of every file, made under epoch 0's context.
        cache = shuffle._DecodeCache(enabled=True)
        cache_refs = []
        with telemetry.context(epoch=0):
            for i, fname in enumerate(files):
                refs, cref = shuffle.shuffle_map(fname, i, 4, epoch=0, seed=7, publish_cache=True)
                ctx.store.free(refs)
                assert cref is not None
                cache.register(i, shuffle._Resolved((None, cref)))
                cache_refs.append(cref)
        consumer = CollectingConsumer(ctx.store)

        def run_epoch(epoch):
            assert shuffle.shuffle_epoch(epoch, files, consumer, num_reducers=4, num_trainers=1, seed=7,
                                         decode_cache=cache)
            assert sorted(consumer.keys[(epoch, 0)]) == list(range(TOTAL_ROWS))

        run_epoch(0)
        # (2) The drain of the added agent, which dies with a task in flight.
        sched._inflight_adjust(added_agent.address, +1)
        os.kill(added_agent.pid, signal.SIGKILL)
        assert ctl.drain_host(added_agent, host_id=added_host_id, deadline_s=20.0) == "backstop"
        assert len(sched.agent_addresses) == 2
        assert _events("port", "scale.drain") and _events("port", "scale.drain_backstop")
        run_epoch(1)
        # (3) The epoch-0 caches, cold now: demoted, readable in place ...
        stats = ctl.evict_once(force=True)
        assert stats["demoted"] >= NUM_FILES
        for cref in cache_refs:
            path = ctx.store._find_segment(cref.object_id)
            assert path is not None and ctx.store.tier_of(path) == "spill"
            assert ctx.store.get_columns(cref).num_rows == ROWS_PER_FILE
        # ... then dropped: the next epoch's maps re-make them from Parquet.
        stats = ctl.evict_once(force_drop=True)
        assert stats["dropped"] >= NUM_FILES
        assert ctx.store._find_segment(cache_refs[0].object_id) is None
        retries = _counter("recovery.stage_retries")
        run_epoch(2)
        assert _counter("recovery.stage_retries") > retries
        verdicts = audit.reconcile([0, 1, 2])
        assert len(verdicts) == 3 and all(v["ok"] is True for v in verdicts), verdicts
        cache.free_all()
        ctx.store.cleanup()
        folded = capacity.ledger()
        assert folded["totals"]["shm"]["resident_bytes"] == folded["totals"]["spill"]["resident_bytes"] == 0
        assert folded["live_segments"] == 0
        summary = ctl.summary()
        assert summary["scale_events"] == 1 and summary["drains"] == 1 and summary["evicted_gb"] > 0
    finally:
        ctx.cluster = None
        sched.shutdown()
        for agent in agents:
            try:
                agent.terminate(grace_period_s=2.0)
            except Exception:
                pass
        runtime.shutdown()
        audit.reset()


# -- zero overhead -----------------------------------------------------------------------------

_ZERO_OVERHEAD_SCRIPT = r"""
import os, sys, threading
sys.path.insert(0, {repo!r})
os.environ["RSDL_METRICS"] = "1"  # metrics on; the elastic plane still must not load
import numpy as np
from ray_shuffling_data_loader_tpu_torch import runtime

ctx = runtime.init(num_workers=1)
ref = ctx.store.put_columns({{"a": np.arange(64, dtype=np.int32)}})
assert ctx.store.get_columns(ref)["a"][5] == 5
ctx.store.free(ref)
assert "ray_shuffling_data_loader_tpu_torch.runtime.elastic" not in sys.modules
assert not any(t.name == "rsdl-elastic" for t in threading.enumerate())
from ray_shuffling_data_loader_tpu_torch.telemetry import capacity
ops = {{r["op"] for r in capacity.load_records()}}
assert "transition" not in ops and "create" in ops, ops
runtime.shutdown()
assert "ray_shuffling_data_loader_tpu_torch.runtime.elastic" not in sys.modules
print("ELASTIC-ZERO-OVERHEAD-OK")
"""


def test_zero_overhead_when_elastic_unset():
    env = {k: v for k, v in os.environ.items() if not k.startswith(("RSDL_", "JAX", "XLA"))}
    proc = subprocess.run([sys.executable, "-c", _ZERO_OVERHEAD_SCRIPT.format(repo=REPO)], capture_output=True,
                          text=True, timeout=300, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert "ELASTIC-ZERO-OVERHEAD-OK" in proc.stdout
