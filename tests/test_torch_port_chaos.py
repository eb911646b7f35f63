"""Chaos runs of the port against the JAX package (the counterparts of
``tests/test_chaos.py``): each case arms one ``RSDL_FAULTS`` schedule and
seed, runs the JAX shuffle and then the port's, each in a session of its
own whose pool spawned after the schedule was armed, with the audit on
and strict, and holds both to the JAX package's fault-free key stream for
the seed (every key once, in the same delivery order) and to an ``ok``
verdict. Cases: a crashed map, a crashed reduce (at its exit: the audit's
dedup absorbs the attempt's records), a lost store object (lineage), a
lost decode-cache segment under the index schedule (and, the port alone,
every one dropped at once), a transport reset, a
dead-but-listed host agent, a poison map (``StageFailedError``, every
rank's end of epoch delivered), a killed pool worker, the selective
schedule's plain resubmit and a retried reduce under the overlapped
reduce.

Which worker runs which task differs between the packages' pools, so the
runs are compared on what they deliver, not on which task failed."""

import collections
import contextlib
import importlib
import os
import signal

import numpy as np
import pytest

from ray_shuffling_data_loader_tpu.data_generation import generate_file

NUM_FILES, ROWS_PER_FILE, NUM_REDUCERS, SEED = 4, 400, 4, 5
TOTAL_ROWS = NUM_FILES * ROWS_PER_FILE
PKGS = ("jax", "port")
KNOBS = ("RSDL_FAULTS", "RSDL_FAULTS_SEED", "RSDL_AUDIT", "RSDL_AUDIT_STRICT", "RSDL_AUDIT_DIR",
         "RSDL_INDEX_SHUFFLE", "RSDL_SELECTIVE_READS", "RSDL_REDUCE_FETCH_OVERLAP", "RSDL_STAGE_MAX_ATTEMPTS",
         "RSDL_JOURNAL", "RSDL_SHUFFLE_PLAN", "RSDL_PLAN", "RSDL_DECODE_PUSHDOWN", "RSDL_DEVICE_DIRECT")


def _mod(pkg, name):
    root = "ray_shuffling_data_loader_tpu" if pkg == "jax" else "ray_shuffling_data_loader_tpu_torch"
    return importlib.import_module(f"{root}.{name}")


def _refresh_planes():
    for pkg in PKGS:
        _mod(pkg, "telemetry.audit").refresh_from_env()
        _mod(pkg, "runtime.faults").refresh_from_env()


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Written in this process: no pool may start before a case arms its
    schedule."""
    data = tmp_path_factory.mktemp("chaos-data")
    return [generate_file(i, i * ROWS_PER_FILE, ROWS_PER_FILE, 1, str(data))[0] for i in range(NUM_FILES)]


@pytest.fixture
def chaos(monkeypatch, tmp_path):
    """``chaos.session(pkg, spec, seed, **env)``: a context with ``pkg``'s
    session, armed, audited and strict, its spool under ``tmp_path``."""
    for key in KNOBS:
        monkeypatch.delenv(key, raising=False)

    @contextlib.contextmanager
    def session(pkg, spec, seed=0, num_workers=2, **env):
        spool = tmp_path / f"spool-{pkg}"
        spool.mkdir(exist_ok=True)
        monkeypatch.setenv("RSDL_AUDIT", "1")
        monkeypatch.setenv("RSDL_AUDIT_STRICT", "1")
        monkeypatch.setenv("RSDL_AUDIT_DIR", str(spool))
        monkeypatch.setenv("RSDL_FAULTS_SEED", str(seed))
        if spec:
            monkeypatch.setenv("RSDL_FAULTS", spec)
        else:
            monkeypatch.delenv("RSDL_FAULTS", raising=False)
        for key, value in env.items():
            monkeypatch.setenv(key, value)
        _refresh_planes()
        _mod(pkg, "telemetry.audit").reset()
        rt = _mod(pkg, "runtime")
        ctx = rt.init(num_workers=num_workers)
        try:
            yield rt, ctx
        finally:
            rt.shutdown()
            for key in ("RSDL_FAULTS", *env):
                monkeypatch.delenv(key, raising=False)
            _refresh_planes()

    yield session
    monkeypatch.undo()
    for pkg in PKGS:
        _mod(pkg, "telemetry.audit").reset()
    _refresh_planes()


class Collecting:
    """Every key in delivery order per ``(epoch, rank)``, and each rank's
    end of epoch."""

    def __init__(self, rt):
        self.rt = rt
        self.keys = collections.defaultdict(list)
        self.done = collections.defaultdict(bool)

    def consume(self, rank, epoch, batches):
        store = self.rt.get_context().store
        for ref in batches:
            self.keys[(epoch, rank)].extend(np.asarray(store.get_columns(ref)["key"]).tolist())
            store.free(ref)

    def producer_done(self, rank, epoch):
        self.done[(epoch, rank)] = True

    def wait_until_ready(self, epoch):
        pass

    def wait_until_all_epochs_done(self):
        pass


@pytest.fixture(scope="module")
def reference(files, tmp_path_factory):
    """The JAX package's fault-free stream (1 epoch, 1 trainer)."""
    saved = {k: os.environ.pop(k, None) for k in KNOBS}
    _refresh_planes()
    rt = _mod("jax", "runtime")
    rt.init(num_workers=2)
    try:
        consumer = Collecting(rt)
        _mod("jax", "shuffle").shuffle(files, consumer, 1, NUM_REDUCERS, 1, seed=SEED)
    finally:
        rt.shutdown()
        for k, v in saved.items():
            if v is not None:
                os.environ[k] = v
        _refresh_planes()
    assert sorted(consumer.keys[(0, 0)]) == list(range(TOTAL_ROWS))
    return consumer.keys[(0, 0)]


def _run(chaos, pkg, files, spec, seed, stats=None, **env):
    """One audited 1-epoch shuffle of ``pkg`` under the schedule; returns
    the consumer, the verdicts and the session's pool deaths (port)."""
    with chaos(pkg, spec, seed, **env) as (rt, ctx):
        consumer = Collecting(rt)
        kwargs = {"stats": stats} if pkg == "port" else {}
        _mod(pkg, "shuffle").shuffle(files, consumer, 1, NUM_REDUCERS, 1, seed=SEED, **kwargs)
        verdicts = _mod(pkg, "telemetry.audit").verdicts()
        records = _mod(pkg, "telemetry.audit")._load_records()
        deaths = getattr(ctx._pool, "deaths", None)
        if pkg == "port":
            # A failed attempt's outputs are freed at once (the JAX
            # package's wait for the session's end).
            assert rt.store_stats().num_objects == 0
    return consumer, verdicts, records, deaths


def _held(consumer, verdicts, reference):
    assert consumer.done[(0, 0)]
    assert consumer.keys[(0, 0)] == reference
    assert [v["epoch"] for v in verdicts] == [0] and verdicts[0]["ok"] is True, verdicts
    assert verdicts[0]["rows_mapped"] == verdicts[0]["rows_reduced"] == verdicts[0]["rows_delivered"] == TOTAL_ROWS


def _both(chaos, files, reference, spec, seed, **env):
    """Both packages under the schedule; the port's stats and records."""
    for pkg in PKGS:
        stats = {} if pkg == "port" else None
        consumer, verdicts, records, deaths = _run(chaos, pkg, files, spec, seed, stats=stats, **env)
        _held(consumer, verdicts, reference)
    return stats, records, deaths


def _errors(stats, stage):
    """The error types of ``stage``'s retries, from the run's log."""
    return collections.Counter(e["error"] for e in stats.get("recovery_log", [])
                               if e["what"] == "stage_retries" and e["stage"] == stage)


def test_recovers_a_crashed_map(chaos, files, reference):
    stats, _, _ = _both(chaos, files, reference, "task.map:crash-entry:1x1", 11)
    assert stats["stage_retries"]["map"] >= 1
    assert _errors(stats, "map") == {"FaultInjected": stats["stage_retries"]["map"]}


def test_recovers_a_crashed_reduce_and_dedups_its_records(chaos, files, reference):
    # At the exit: the reducer's output and its digests are out when it
    # dies; the retry records them again, and the reconcile counts each
    # reducer once.
    stats, records, _ = _both(chaos, files, reference, "task.reduce:crash-exit:1x1", 13)
    assert stats["stage_retries"]["reduce"] >= 1
    reduce_recs = [r for r in records if r.get("side") == "reduce" and r.get("epoch") == 0]
    assert len(reduce_recs) == NUM_REDUCERS + stats["stage_retries"]["reduce"]
    assert len({r["reducer"] for r in reduce_recs}) == NUM_REDUCERS


def test_recovers_a_lost_store_object_from_lineage(chaos, files, reference):
    # Each worker's first store.get reports its object lost: a reduce's
    # first partition; the map that made it runs again.
    stats, _, _ = _both(chaos, files, reference, "store.get/task:lost:1x1", 17)
    assert stats["rematerialized"]["map"] >= 1
    assert set(_errors(stats, "reduce")) == {"ObjectLostError"}


def test_recovers_a_lost_decode_cache_under_the_index_schedule(chaos, files, reference):
    """The index schedule's lost cache segment is in no lineage: it is
    decoded again and published, and the epoch delivers its stream."""
    for pkg in PKGS:
        with chaos(pkg, "", 0, RSDL_INDEX_SHUFFLE="on") as (rt, ctx):
            shuffle_mod = _mod(pkg, "shuffle")
            audit = _mod(pkg, "telemetry.audit")
            audit.begin_run()
            cache = shuffle_mod._DecodeCache(enabled=True)
            resolved = shuffle_mod._ResolvedMapResult if pkg == "jax" else shuffle_mod._Resolved
            cache_refs = []
            for i, fname in enumerate(files):
                refs, cref = shuffle_mod.shuffle_map(fname, i, NUM_REDUCERS, epoch=0, seed=SEED, publish_cache=True)
                ctx.store.free(refs)
                cache.register(i, resolved((None, cref)))
                cache_refs.append(cref)
            os.unlink(ctx.store._find_segment(cache_refs[1].object_id))
            consumer, log, stats = Collecting(rt), [], {}
            if pkg == "jax":
                thread = shuffle_mod.shuffle_epoch(0, files, consumer, num_reducers=NUM_REDUCERS, num_trainers=1,
                                                   seed=SEED, decode_cache=cache, schedule_log=log)
                thread.join()
                assert thread.error is None, thread.error
            else:
                assert shuffle_mod.shuffle_epoch(0, files, consumer, NUM_REDUCERS, 1, SEED, decode_cache=cache,
                                                 schedule_log=log, stats=stats)
                assert stats["rematerialized"] == {"decode-cache": 1}
            assert log == [(0, "index")]
            _held(consumer, audit.reconcile([0]), reference)
            cache.free_all()
            assert rt.store_stats().num_objects == 0


def _port_index_epoch(chaos, files, reference, **env):
    """One index-schedule epoch of the port over a decode cache published
    beforehand: ``(stats, StageFailedError or None)``; a run that ends
    delivered the reference's stream."""
    with chaos("port", "", 0, RSDL_INDEX_SHUFFLE="on", **env) as (rt, ctx):
        shuffle_mod = _mod("port", "shuffle")
        audit = _mod("port", "telemetry.audit")
        audit.begin_run()
        cache = shuffle_mod._DecodeCache(enabled=True)
        for i, fname in enumerate(files):
            refs, cref = shuffle_mod.shuffle_map(fname, i, NUM_REDUCERS, epoch=0, seed=SEED, publish_cache=True)
            ctx.store.free(refs)
            cache.register(i, shuffle_mod._Resolved((None, cref)))
        consumer, log, stats, error = Collecting(rt), [], {}, None
        try:
            shuffle_mod.shuffle_epoch(0, files, consumer, NUM_REDUCERS, 1, SEED, decode_cache=cache,
                                      schedule_log=log, stats=stats)
        except shuffle_mod.StageFailedError as exc:
            error = exc
        cache.free_all()
        if error is None:
            assert log == [(0, "index")]
            _held(consumer, audit.reconcile([0]), reference)
            assert rt.store_stats().num_objects == 0
    return stats, error


def test_recovers_every_decode_cache_segment_dropped_at_once(chaos, files, reference, monkeypatch, tmp_path):
    """The elastic evictor drops every cold spilled segment of a pass at
    once, and an index-schedule reduce reads every file's cache segment:
    all four are lost between the plans and the reduces. The port decodes
    every lost segment again at the first failure, and a task's failure on
    a file's segment lost for the first time this epoch spends none of its
    3 attempts. (The JAX package decodes one segment an attempt, so four
    lost segments exhaust the budget: the port's deliberate difference.)"""
    import torch_port_helpers as helpers

    monkeypatch.setattr(_mod("port", "shuffle"), "shuffle_gather_reduce", helpers.dropping_gather_reduce)
    stats, error = _port_index_epoch(chaos, files, reference, RSDL_TEST_DROP_MARKER=str(tmp_path / "dropped"))
    assert error is None, error
    assert (tmp_path / "dropped").exists()
    assert stats["rematerialized"] == {"decode-cache": NUM_FILES}
    assert set(_errors(stats, "reduce")) == {"ObjectLostError"}


def test_rides_out_a_transport_reset(chaos, files, reference):
    # A reset before a driver-side send to the queue actor: the client's
    # send retry dials again.
    for pkg in PKGS:
        with chaos(pkg, "transport.send/driver:reset:1x1", 19) as (rt, ctx):
            ds = _mod(pkg, "dataset").ShufflingDataset(files, num_epochs=1, num_trainers=1, batch_size=200, rank=0,
                                                       num_reducers=NUM_REDUCERS, seed=SEED,
                                                       queue_name=f"chaos-reset-{pkg}")
            ds.set_epoch(0)
            keys = [k for b in ds for k in np.asarray(b["key"]).tolist()]
            if pkg == "port":
                ds.join(timeout=60)
            assert keys == reference
            verdicts = _mod(pkg, "telemetry.audit").verdicts()
            assert verdicts and verdicts[0]["ok"] is True, verdicts
            assert _mod(pkg, "runtime.faults").fired_counts()[("transport.send", "reset")] == 1


def test_a_dead_but_listed_host_agent_fails_over(chaos, files, reference):
    """Two host agents behind a scheduler, one SIGKILLed before the run (a
    preempted host still in the list): its tasks go to the survivor, and
    the dead one leaves the rotation."""
    for pkg in PKGS:
        with chaos(pkg, "", 0) as (rt, ctx):
            actor_mod = _mod(pkg, "runtime.actor")
            cluster = _mod(pkg, "runtime.cluster")
            agents = [actor_mod.spawn_actor(cluster.HostAgent, ctx.runtime_dir, 1, None, runtime_dir=ctx.runtime_dir,
                                            daemon=False) for _ in range(2)]
            victim, survivor = agents
            os.kill(victim.pid, signal.SIGKILL)
            sched = cluster.ClusterScheduler(agents, width=2)

            class _OneScheduler:
                def scheduler(self):
                    return sched

            ctx.cluster = _OneScheduler()
            try:
                consumer = Collecting(rt)
                _mod(pkg, "shuffle").shuffle(files, consumer, 1, NUM_REDUCERS, 1, seed=SEED)
                _held(consumer, _mod(pkg, "telemetry.audit").verdicts(), reference)
                assert sched.agent_addresses == {survivor.address}
            finally:
                ctx.cluster = None
                sched.shutdown()
                survivor.terminate(grace_period_s=2.0)


def test_a_poison_map_fails_the_epoch_with_stage_failed_error(chaos, files):
    for pkg in PKGS:
        with chaos(pkg, "task.map:crash-entry:1.0", 3, RSDL_STAGE_MAX_ATTEMPTS="3") as (rt, ctx):
            consumer = Collecting(rt)
            with pytest.raises(_mod(pkg, "shuffle").StageFailedError) as info:
                _mod(pkg, "shuffle").shuffle(files, consumer, 1, 2, 2, seed=SEED)
            err = info.value
            assert (err.stage, err.epoch, err.attempts) == ("map", 0, 3)
            assert "FaultInjected" in str(err) and err.error_type == "StageFailedError"
            # No rank waits for an epoch that will not come.
            assert consumer.done[(0, 0)] and consumer.done[(0, 1)]
            again = __import__("pickle").loads(__import__("pickle").dumps(err))
            assert (again.stage, again.epoch, again.attempts, str(again)) == ("map", 0, 3, str(err))


def test_a_killed_pool_worker_costs_its_task(chaos, files, reference):
    """Every worker dies as it starts its second reduce (seed 9 fires the
    kill at a worker's third invocation of the site); the port's pool fails
    only the dead worker's task and starts another worker, and the retry
    delivers the stream. The JAX pool starts none in its place, so with
    both of its workers dead it would wait for ever: the JAX package runs
    the case fault-free (the reference)."""
    stats = {}
    consumer, verdicts, _, deaths = _run(chaos, "port", files, "task.reduce/task:kill:0.5x1", 9, stats=stats)
    _held(consumer, verdicts, reference)
    assert deaths >= 1 and set(_errors(stats, "reduce")) == {"WorkerDied"}


def test_the_selective_schedule_resubmits_plainly(chaos, files, reference):
    # No partitions, so no lineage: its reduce reads Parquet again.
    stats, _, _ = _both(chaos, files, reference, "task.map:crash-entry:1x1,task.reduce:crash-exit:1x1", 23,
                        RSDL_SELECTIVE_READS="on")
    assert stats["stage_retries"]["map"] >= 1 and stats["stage_retries"]["reduce"] >= 1
    assert stats["selective_reads"].startswith("forced on") and "rematerialized" not in stats


def test_a_retried_reduce_under_the_overlapped_reduce(chaos, files, reference):
    # The overlapped reduce maps its windows one by one: a lost window and
    # a crash at the exit, each retried; the failed attempt's window caches
    # go with it.
    stats, _, _ = _both(chaos, files, reference, "store.get/task:lost:1x1,task.reduce:crash-exit:1x1", 29,
                        RSDL_REDUCE_FETCH_OVERLAP="on")
    assert stats["native_calls"]["scatter"] > 0
    assert stats["rematerialized"]["map"] >= 1
    assert {"ObjectLostError", "FaultInjected"} <= set(_errors(stats, "reduce"))


def test_the_journal_records_only_the_attempt_that_succeeded(chaos, files, reference, tmp_path):
    """Crashed maps and reduces under ``RSDL_JOURNAL``: each stage result is
    journaled once, the succeeding attempt's, and the run is done."""
    jmod = _mod("port", "runtime.journal")
    stats = {}
    consumer, verdicts, _, _ = _run(chaos, "port", files, "task.map:crash-exit:1x1,task.reduce:crash-exit:1x1", 31,
                                    stats=stats, RSDL_JOURNAL=str(tmp_path / "journal"))
    _held(consumer, verdicts, reference)
    assert stats["stage_retries"]["map"] >= 1 and stats["stage_retries"]["reduce"] >= 1
    with open(stats["journal"]) as f:
        recs = [__import__("json").loads(line) for line in f if line.strip()]
    maps = [(r["epoch"], r["file"]) for r in recs if r["kind"] == "map"]
    reduces = [(r["epoch"], r["reducer"]) for r in recs if r["kind"] == "reduce"]
    assert sorted(maps) == [(0, i) for i in range(NUM_FILES)]
    assert sorted(reduces) == [(0, r) for r in range(NUM_REDUCERS)]
    state = jmod.load_run(stats["journal"])
    assert state.done and state.verdicts[0]["ok"] is True


def test_the_trainer_sees_the_shuffle_s_own_error(chaos, files):
    """A poisoned epoch ends the trainer's loop with ``StageFailedError``
    (not a wrapper), rank 0's ``join`` raises it too, and the session's
    shutdown leaves no segment."""
    shuffle_mod = _mod("port", "shuffle")
    with chaos("port", "task.map:crash-entry:1.0", 3, RSDL_STAGE_MAX_ATTEMPTS="2") as (rt, ctx):
        ds = _mod("port", "device_dataset").DeviceShufflingDataset(
            files, num_epochs=2, num_trainers=1, batch_size=200, rank=0, feature_columns=["key"],
            label_column="labels", num_reducers=NUM_REDUCERS, seed=SEED, device="cpu", queue_name="chaos-poison")
        ds.set_epoch(0)
        with pytest.raises(shuffle_mod.StageFailedError) as info:
            for _ in ds:
                pass
        assert (info.value.stage, info.value.epoch, info.value.attempts) == ("map", 0, 2)
        with pytest.raises(shuffle_mod.StageFailedError):
            ds.join(timeout=60)
        store = ctx.store
    assert store.store_stats().num_objects == 0
