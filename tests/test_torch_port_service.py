"""The port's multi-job shuffle service (``runtime/service.py``), against the
JAX package's: a counterpart of each test of ``tests/test_service.py``, and
the port's own differences.

Units, held against the JAX module on the same inputs: the mode, scoped
names and content keys as strings; the fair-share release order on fake
pools for the same submissions, weights and completions (interleaving, a
sole tenant's flood, an ended job's queued tasks failing); the admission's
progress guarantees on a seeded capacity view; a dead pid's claims; a
resume chain folding into one reconcile.

Runs of the port (2 workers, 4 files x 400 rows, strict audit where the
JAX test has it): two concurrent jobs each deliver the JAX package's
service-off stream for their seed, exactly once, with ``ok`` verdicts of
their own; two same-name queues; a reducer crash in one job; a second job
cache-hot from epoch 0 (no row group decoded); ``/jobs``; the two jobs' SLO
instances; the service module never imported with ``RSDL_SERVICE`` unset.

The port's own: the per-job live tracker (a second job's start keeps the
first's fence and delivered ids), the proxy future under
``runtime.tasks.wait`` and ``add_done_callback``, a failed submit, the
audit's sole-tenant reset, the journal's job identity and the planes that
find the service through ``sys.modules``."""

import collections
import concurrent.futures as cf
import importlib
import json
import os
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest

from ray_shuffling_data_loader_tpu.data_generation import generate_file

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NUM_FILES, ROWS_PER_FILE, EPOCHS, NUM_REDUCERS = 4, 400, 2, 4
TOTAL_ROWS = NUM_FILES * ROWS_PER_FILE
KNOBS = ("RSDL_SERVICE", "RSDL_JOB_ID", "RSDL_JOB_NAME", "RSDL_JOB_WEIGHT", "RSDL_SERVICE_ADMIT_FRAC",
         "RSDL_SERVICE_ADMIT_TIMEOUT_S", "RSDL_AUDIT", "RSDL_AUDIT_STRICT", "RSDL_AUDIT_DIR", "RSDL_METRICS",
         "RSDL_METRICS_DIR", "RSDL_EVENTS_DIR", "RSDL_FAULTS", "RSDL_FAULTS_SEED", "RSDL_DECODE_CACHE_SHARED",
         "RSDL_OBS_PORT", "RSDL_SLO_RULES", "RSDL_TS", "RSDL_TRACE", "RSDL_JOURNAL", "RSDL_RESUME",
         "RSDL_INDEX_SHUFFLE", "RSDL_RUN_LEDGER", "RSDL_PROFILE")


def _mod(pkg, name):
    root = "ray_shuffling_data_loader_tpu" if pkg == "jax" else "ray_shuffling_data_loader_tpu_torch"
    return importlib.import_module(f"{root}.{name}")


def _refresh(pkg):
    _mod(pkg, "telemetry.audit").refresh_from_env()
    _mod(pkg, "telemetry.metrics").refresh_from_env()
    _mod(pkg, "telemetry.trace").refresh_from_env()
    _mod(pkg, "runtime.faults").refresh_from_env()


svc_jax = _mod("jax", "runtime.service")
svc = _mod("port", "runtime.service")
runtime = _mod("port", "runtime")
shuffle_mod = _mod("port", "shuffle")
audit = _mod("port", "telemetry.audit")
metrics = _mod("port", "telemetry.metrics")


@pytest.fixture(autouse=True)
def clean(monkeypatch):
    for key in KNOBS:
        monkeypatch.delenv(key, raising=False)
    for pkg in ("jax", "port"):
        _refresh(pkg)
        _mod(pkg, "runtime.service").reset_state()
    yield
    monkeypatch.undo()
    for pkg in ("jax", "port"):
        _mod(pkg, "runtime.service").reset_state()
        _refresh(pkg)
    audit.reset()


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Written in this process: a case's pool spawns after its knobs."""
    data = tmp_path_factory.mktemp("service-data")
    return [generate_file(i, i * ROWS_PER_FILE, ROWS_PER_FILE, 1, str(data))[0] for i in range(NUM_FILES)]


class Collecting:
    """Every key in delivery order per ``(epoch, rank)``; each rank's end of
    epoch."""

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


class Gated(Collecting):
    """Holds every epoch past the first at its admission until ``gate``."""

    def __init__(self, rt, gate):
        super().__init__(rt)
        self.gate = gate

    def wait_until_ready(self, epoch):
        if epoch > 0:
            assert self.gate.wait(timeout=180)


def _exactly_once(consumer, epochs=EPOCHS):
    for e in range(epochs):
        assert consumer.done[(e, 0)]
        assert sorted(consumer.keys[(e, 0)]) == list(range(TOTAL_ROWS))


@pytest.fixture(scope="module")
def jax_streams(files):
    """The JAX package's service-off stream of each seed the runs use: per
    seed, per epoch, every key in delivery order."""
    saved = {k: os.environ.pop(k, None) for k in KNOBS}
    _refresh("jax")
    rt = _mod("jax", "runtime")
    rt.init(num_workers=2)
    out = {}
    try:
        for seed in (3, 7, 9, 11, 13):
            consumer = Collecting(rt)
            _mod("jax", "shuffle").shuffle(files, consumer, EPOCHS, NUM_REDUCERS, 1, seed=seed)
            out[seed] = [consumer.keys[(e, 0)] for e in range(EPOCHS)]
    finally:
        rt.shutdown()
        for k, v in saved.items():
            if v is not None:
                os.environ[k] = v
        _refresh("jax")
    return out


@pytest.fixture
def session(monkeypatch, tmp_path):
    """``session(audit=True, **env)``: the service armed (with metrics, and
    the strict audit on one spool), then a port session of 2 workers that
    inherits it."""

    def arm(audit_on=True, **env):
        monkeypatch.setenv("RSDL_SERVICE", "auto")
        monkeypatch.setenv("RSDL_METRICS", "1")
        if audit_on:
            monkeypatch.setenv("RSDL_AUDIT", "1")
            monkeypatch.setenv("RSDL_AUDIT_STRICT", "1")
            monkeypatch.setenv("RSDL_AUDIT_DIR", str(tmp_path / "spool"))
        for key, value in env.items():
            monkeypatch.setenv(key, str(value))
        _refresh("port")
        audit.reset()
        metrics.registry.clear()
        return runtime.init(num_workers=2)

    yield arm
    runtime.shutdown()
    svc.reset_state()


def _run_job(name, files, seed, results, errors, consumer=None, weight=None, **kw):
    job = svc.register_job(name=name, weight=weight)
    try:
        with svc.job_context(job):
            consumer = consumer or Collecting(runtime)
            stats = {}
            shuffle_mod.shuffle(files, consumer, EPOCHS, NUM_REDUCERS, 1, seed=seed, stats=stats, **kw)
            results[name] = (job, consumer, stats)
    except BaseException as exc:  # raised by the test
        errors[name] = exc
    finally:
        svc.end_job(job)


def _two_jobs(files, specs, **kw):
    """Run ``(name, seed[, consumer])`` jobs on threads at once."""
    results, errors = {}, {}
    threads = [threading.Thread(target=_run_job, args=(spec[0], files, spec[1], results, errors, *spec[2:]),
                                kwargs=kw) for spec in specs]
    for t in threads:
        t.start()
    return threads, results, errors


# -- units: mode, scoping, content keys ----------------------------------------------


@pytest.mark.parametrize("value", [None, "", "off", "OFF", "0", "false", "no", "auto", " Auto ", "on"])
def test_mode_parsing(monkeypatch, value):
    if value is None:
        monkeypatch.delenv("RSDL_SERVICE", raising=False)
    else:
        monkeypatch.setenv("RSDL_SERVICE", value)
    assert (svc.mode(), svc.enabled()) == (svc_jax.mode(), svc_jax.enabled())


def test_scoped_name(monkeypatch):
    monkeypatch.setenv("RSDL_SERVICE", "auto")
    for mod in (svc, svc_jax):
        assert mod.current_job() is None
        assert mod.scoped_name("Q") == "Q"  # no ambient job
        job = mod.Job("j-1-0", "j", 1.0)
        with mod.job_context(job):
            scoped = mod.scoped_name("Q")
            assert scoped == "Q--j-1-0"
            assert mod.scoped_name(scoped) == scoped  # idempotent
        assert mod.scoped_name("Q") == "Q"  # the context restored
    monkeypatch.setenv("RSDL_SERVICE", "off")
    job = svc.Job("j-1-0", "j", 1.0)
    assert svc.scoped_name("Q", job) == svc_jax.scoped_name("Q", svc_jax.Job("j-1-0", "j", 1.0)) == "Q"
    monkeypatch.setenv("RSDL_JOB_ID", "env-job")
    monkeypatch.setenv("RSDL_SERVICE", "auto")
    assert svc.scoped_name("Q") == svc_jax.scoped_name("Q") == "Q--env-job"


def test_cache_key_content_identity(files):
    """Path, size, mtime, projection and narrowing: the port's keys are the
    JAX package's strings, and no two shapes collide."""
    cases = [(files[0], None, False), (files[0], ["key"], False), (files[0], None, True), (files[1], None, False),
             (files[0], ["key", "labels"], True), ("/no/such/file.parquet", None, False)]
    keys = [svc.cache_key(*c) for c in cases]
    assert keys == [svc_jax.cache_key(*c) for c in cases]
    assert len(set(keys)) == len(keys)
    assert keys[0] == svc.cache_key(files[0], None, False)


# -- units: fair share on fake pools ---------------------------------------------------


class _JaxFakeFuture:
    """The JAX test's inner future: manual completion, waiter hooks."""

    def __init__(self, tag):
        self.tag = tag
        self._event = threading.Event()
        self._waiters = []
        self._lock = threading.Lock()

    def complete(self):
        with self._lock:
            self._event.set()
            waiters, self._waiters = self._waiters, []
        for w in waiters:
            w.set()

    def done(self):
        return self._event.is_set()

    def result(self, timeout=None):
        assert self._event.wait(timeout)
        return self.tag

    def _add_waiter(self, event):
        with self._lock:
            if self._event.is_set():
                event.set()
            else:
                self._waiters.append(event)

    def _remove_waiter(self, event):
        with self._lock:
            if event in self._waiters:
                self._waiters.remove(event)


class _FakePool:
    """Width 2; records the release order; ``futures[tag]`` completes a
    task. The port's futures are ``concurrent.futures`` ones, the JAX
    package's its waiter-hook futures."""

    width = 2

    def __init__(self, pkg):
        self.pkg = pkg
        self.order = []
        self.futures = {}

    def submit(self, fn, *args, **kwargs):
        fut = _JaxFakeFuture(fn) if self.pkg == "jax" else cf.Future()
        self.order.append(fn)
        self.futures[fn] = fut
        return fut

    def submit_local_to(self, refs, fn, *args, **kwargs):
        return self.submit(fn, *args, **kwargs)

    def complete(self, tag):
        fut = self.futures[tag]
        if self.pkg == "jax":
            fut.complete()
        else:
            fut.set_result(tag)


def _wait_for(cond, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            return False
        time.sleep(0.01)
    return True


def _release_order(pkg, weights, counts):
    """Register one job a weight, submit each job's ``counts`` in turn,
    then complete the oldest unfinished released task, one at a time (each
    completion's release settled before the next), until every proxy is
    done. Returns the release order by job name."""
    mod = _mod(pkg, "runtime.service")
    pool = _FakePool(pkg)
    sched = mod.wrap_scheduler(pool)
    jobs = {name: mod.register_job(name=name, weight=w) for name, w in weights.items()}
    proxies = []
    try:
        for name, n in counts.items():
            with mod.job_context(jobs[name]):
                proxies += [sched.submit(f"{name}{i}") for i in range(n)]
        total = sum(counts.values())
        for completed in range(1, total + 1):
            pool.complete(pool.order[completed - 1])
            want = total if len(jobs) == 1 else min(total, completed + pool.width)
            assert _wait_for(lambda: len(pool.order) >= want), (pkg, pool.order)
        assert _wait_for(lambda: all(p.done() for p in proxies))
        assert sorted(p.result() for p in proxies) == sorted(pool.order)
        return [tag.rstrip("0123456789") for tag in pool.order]
    finally:
        for job in jobs.values():
            mod.end_job(job)
        mod.reset_state()


@pytest.mark.parametrize("weights,counts", [
    ({"A": 1.0, "B": 1.0}, {"A": 4, "B": 2}),
    ({"A": 2.0, "B": 1.0}, {"A": 8, "B": 6}),
    ({"A": 1.0, "B": 3.0}, {"A": 6, "B": 6}),
    ({"A": 1.0, "B": 1.0, "C": 2.0}, {"A": 5, "B": 3, "C": 7}),
])
def test_fair_share_release_order_matches_jax(monkeypatch, weights, counts):
    """Two or three registered jobs on a width-2 pool: the first flood is
    capped at the width, each freed slot goes to the smallest virtual
    clock, and the port releases the JAX package's job sequence."""
    monkeypatch.setenv("RSDL_SERVICE", "auto")
    port_order = _release_order("port", weights, counts)
    assert port_order == _release_order("jax", weights, counts)
    assert port_order[:2] == ["A", "A"]  # the cap holds from the first submission
    assert collections.Counter(port_order) == collections.Counter(counts)


def test_fair_share_interleaves_jobs(monkeypatch):
    """The JAX test's case: A's flood capped at the width, and the first
    slot a completion frees goes to B, not to A's backlog."""
    monkeypatch.setenv("RSDL_SERVICE", "auto")
    pool = _FakePool("port")
    sched = svc.FairShareScheduler(pool)
    job_a, job_b = svc.register_job(name="A"), svc.register_job(name="B")
    try:
        with svc.job_context(job_a):
            futs = [sched.submit(f"a{i}") for i in range(4)]
        assert pool.order == ["a0", "a1"]
        with svc.job_context(job_b):
            futs += [sched.submit(f"b{i}") for i in range(2)]
        assert pool.order == ["a0", "a1"]
        assert metrics.registry.snapshot().get("service.tasks_throttled") is None  # metrics off
        pool.complete("a0")
        assert pool.order[2] == "b0", pool.order
        for tag in ["a1", "b0", "a2", "b1", "a3"]:
            pool.complete(tag)
        assert all(f.done() for f in futs)
        assert sorted(pool.order) == sorted([f"a{i}" for i in range(4)] + ["b0", "b1"])
        assert sched.inflight() == {} and sched.queue_depths() == {}
    finally:
        svc.end_job(job_a)
        svc.end_job(job_b)


def test_fair_share_sole_tenant_floods(monkeypatch):
    """One job alone: every task goes straight to the pool, as with the
    service off; in both packages."""
    monkeypatch.setenv("RSDL_SERVICE", "auto")
    assert _release_order("port", {"S": 1.0}, {"S": 5}) == _release_order("jax", {"S": 1.0}, {"S": 5})
    pool = _FakePool("port")
    sched = svc.FairShareScheduler(pool)
    job = svc.register_job(name="S")
    try:
        with svc.job_context(job):
            futs = [sched.submit(f"s{i}") for i in range(5)]
        assert pool.order == [f"s{i}" for i in range(5)]
        for tag in list(pool.order):
            pool.complete(tag)
        assert [f.result() for f in futs] == pool.order
        # Outside a job a task is the pool's own future.
        assert sched.submit("free") is pool.futures["free"]
    finally:
        svc.end_job(job)


def test_ended_job_queued_tasks_fail_as_in_jax(monkeypatch):
    """An ended job's still-queued tasks fail with the JAX package's
    message; its released ones finish."""
    monkeypatch.setenv("RSDL_SERVICE", "auto")
    messages = {}
    for pkg in ("jax", "port"):
        mod = _mod(pkg, "runtime.service")
        pool = _FakePool(pkg)
        sched = mod.wrap_scheduler(pool)
        job_a, job_b = mod.register_job(name="A"), mod.register_job(name="B")
        try:
            with mod.job_context(job_a):
                futs = [sched.submit(f"a{i}") for i in range(4)]
            assert pool.order == ["a0", "a1"]
            mod.end_job(job_a)
            assert _wait_for(lambda: all(f.done() for f in futs[2:]))
            msgs = []
            for f in futs[2:]:
                with pytest.raises(RuntimeError) as info:
                    f.result(1)
                msgs.append(str(info.value))
            pool.complete("a0")
            pool.complete("a1")
            assert _wait_for(lambda: futs[0].done() and futs[1].done())
            assert [futs[0].result(1), futs[1].result(1)] == ["a0", "a1"]
            messages[pkg] = msgs
        finally:
            mod.end_job(job_b)
            mod.reset_state()
    assert messages["port"] == messages["jax"] == ["fair-share task dropped: job ended"] * 2


def test_fair_share_proxy_works_with_wait_and_callbacks(monkeypatch):
    """The proxy is a ``concurrent.futures`` future: ``runtime.tasks.wait``
    and ``add_done_callback`` (how the shuffle chains a stage) see it
    settle when its held task is released and finishes; a failed task's
    error reaches it, and a failed submit fails its proxy."""
    monkeypatch.setenv("RSDL_SERVICE", "auto")
    from ray_shuffling_data_loader_tpu_torch.runtime.tasks import wait

    pool = _FakePool("port")
    sched = svc.FairShareScheduler(pool)
    job_a, job_b = svc.register_job(name="A"), svc.register_job(name="B")
    try:
        with svc.job_context(job_a):
            futs = [sched.submit(f"a{i}") for i in range(3)]
        assert all(isinstance(f, cf.Future) for f in futs)
        seen = []
        futs[2].add_done_callback(lambda f: seen.append(f.result()))
        done, pending = wait(futs, num_returns=1, timeout=0.05)
        assert done == [] and pending == futs  # a2 is held back
        pool.complete("a0")  # releases a2
        assert pool.order == ["a0", "a1", "a2"]
        done, pending = wait(futs, num_returns=1, timeout=1)
        assert done == [futs[0]]
        pool.futures["a2"].set_exception(ValueError("boom"))
        with pytest.raises(ValueError, match="boom"):
            futs[2].result(1)
        assert seen == []  # the callback's result() raised inside it: nothing appended
        pool.complete("a1")
        done, _ = wait(futs, num_returns=3, timeout=1)
        assert done == futs

        class Broken(_FakePool):
            def submit(self, fn, *args, **kwargs):
                raise OSError("pool shut down")

        broken = svc.FairShareScheduler(Broken("port"))
        with svc.job_context(job_b):
            with pytest.raises(OSError):
                broken.submit("b0")
            assert broken.inflight() == {}
    finally:
        svc.end_job(job_a)
        svc.end_job(job_b)


def test_fair_share_under_thread_stress(monkeypatch):
    """Submitters of three jobs on six threads and completions on three
    others, with a short switch interval: every proxy settles with its own
    task's result, the released tasks never pass the width, and the
    scheduler ends with nothing queued or in flight."""
    monkeypatch.setenv("RSDL_SERVICE", "auto")
    lock = threading.Lock()
    live, peak, released, done = [0], [0], [], threading.Event()

    class CountingPool:
        width = 4

        def submit(self, fn, *args, **kwargs):
            fut = cf.Future()
            with lock:
                live[0] += 1
                peak[0] = max(peak[0], live[0])
                released.append((fn, fut))
            return fut

        def submit_local_to(self, refs, fn, *args, **kwargs):
            return self.submit(fn, *args, **kwargs)

    def completer():
        while not done.is_set():
            with lock:
                item = released.pop(0) if released else None
                if item is not None:
                    live[0] -= 1
            if item is None:
                time.sleep(0.0005)
            else:
                item[1].set_result(item[0])

    sched = svc.FairShareScheduler(CountingPool())
    jobs = [svc.register_job(name=f"s{i}", weight=w) for i, w in enumerate((1.0, 2.0, 3.0))]
    proxies, plock = [], threading.Lock()

    def submitter(job, tag):
        with svc.job_context(job):
            mine = [(f"{tag}-{i}", sched.submit(f"{tag}-{i}")) for i in range(60)]
        with plock:
            proxies.extend(mine)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=completer) for _ in range(3)]
        workers += [threading.Thread(target=submitter, args=(jobs[i % 3], f"t{i}")) for i in range(6)]
        for t in workers:
            t.start()
        assert _wait_for(lambda: len(proxies) == 360 and all(p.done() for _, p in proxies), timeout=60)
    finally:
        done.set()
        sys.setswitchinterval(interval)
        for t in workers:
            t.join(timeout=10)
        for job in jobs:
            svc.end_job(job)
    assert not any(t.is_alive() for t in workers)
    assert all(p.result(0) == tag for tag, p in proxies)
    assert peak[0] <= CountingPool.width
    assert sched.inflight() == {} and sched.queue_depths() == {} and sched._released == []


# -- units: admission, claims, audit chain -------------------------------------------


def test_admission_progress_guarantees(monkeypatch):
    """No window in flight, or a sole tenant: admitted at once; two live
    jobs over the watermark: a wait bounded by the timeout; under it: at
    once. The JAX package decides each case the same way."""
    monkeypatch.setenv("RSDL_SERVICE", "auto")
    monkeypatch.setenv("RSDL_METRICS", "1")
    monkeypatch.setenv("RSDL_SERVICE_ADMIT_TIMEOUT_S", "0.4")
    results = {}
    for pkg in ("port", "jax"):
        mod = _mod(pkg, "runtime.service")
        capacity = _mod(pkg, "telemetry.capacity")
        _refresh(pkg)
        monkeypatch.setattr(capacity, "view", lambda *a, **k: {"shm_used_frac": 0.99})
        job_a = mod.register_job(name="adm-a")
        try:
            sole = mod.admit_epoch(job_a, 0, in_flight=2)
            job_b = mod.register_job(name="adm-b")
            try:
                none_in_flight = mod.admit_epoch(job_a, 0, in_flight=0)
                pressed = mod.admit_epoch(job_a, 1, in_flight=1)
                monkeypatch.setattr(capacity, "view", lambda *a, **k: {"shm_used_frac": 0.1})
                relieved = mod.admit_epoch(job_a, 2, in_flight=1)
            finally:
                mod.end_job(job_b)
        finally:
            mod.end_job(job_a)
        snap = _mod(pkg, "telemetry.metrics").registry.snapshot()
        results[pkg] = (sole == 0.0, none_in_flight == 0.0, 0.3 <= pressed <= 2.0, relieved < 0.3,
                        snap.get(f"service.admission_timeouts{{job={job_a.job_id}}}"),
                        snap.get(f"service.admission_wait_seconds{{job={job_a.job_id}}}_count"))
    assert results["port"] == results["jax"] == (True, True, True, True, 1.0, 1.0)


def test_dead_job_claims_do_not_fence(session, files):
    """A driver killed before its ``end_job`` leaves a ``running`` record:
    its pid is dead, so its claims fence nothing and it is no tenant; a
    live job's claim fences."""
    ctx = session(audit_on=False)
    jobs_dir = os.path.join(ctx.runtime_dir, "service", "jobs")
    os.makedirs(jobs_dir, exist_ok=True)
    dead = {"job_id": "ghost-999999-0", "name": "ghost", "weight": 1.0, "pid": 999999, "created_ts": 0.0,
            "ended_ts": None, "running": True}
    with open(os.path.join(jobs_dir, "ghost-999999-0.json"), "w") as f:
        json.dump(dead, f)
    assert svc._record_live(dead) == svc_jax._record_live(dead) is False
    svc.cache_registry_clear()
    ref = ctx.store.put_columns({"key": np.arange(10, dtype=np.int64)})
    key = svc.cache_key(files[0], None, False)
    svc.cache_publish(key, ref, job=None)
    with svc._registry_locked() as data:
        data[key]["claims"] = {"ghost-999999-0": 0.0}
    svc._cache_mem.clear()
    assert svc.claimed_cache_ids() == set()
    job = svc.register_job(name="fence")
    try:
        assert svc.cache_lookup(key, job=job) == ref
        assert ref.object_id in svc.claimed_cache_ids()
        assert svc.job_cache_claims() == {"ghost-999999-0": 1, job.job_id: 1}
        assert svc.live_jobs_count() == 1  # the ghost is no tenant
    finally:
        svc.end_job(job)
    assert svc.claimed_cache_ids() == set()
    ctx.store.free(ref)
    assert svc.cache_lookup(key, job=None) is None  # a freed segment's entry goes
    with svc._registry_locked() as data:
        assert key not in data


def test_audit_reconcile_folds_resume_chain(monkeypatch, tmp_path):
    """A journaled resume changes the job id: a reconcile over the chain of
    ids folds the preempted attempt's records; over the newest alone it is
    incomplete. The port's verdicts are the JAX package's."""
    out = {}
    keys = np.arange(100, dtype=np.int64)
    for pkg in ("jax", "port"):
        aud = _mod(pkg, "telemetry.audit")
        tel = _mod(pkg, "telemetry")
        monkeypatch.setenv("RSDL_AUDIT", "1")
        monkeypatch.setenv("RSDL_AUDIT_DIR", str(tmp_path / f"spool-{pkg}"))
        aud.refresh_from_env()
        aud.reset(clear_spool=True)
        try:
            with tel.context(job="t-1-0"):
                aud.record_map(0, 0, {"key": keys})
                aud.record_reduce(0, 0, {"key": keys})
            with tel.context(job="t-2-0"):
                aud.record_deliver(0, 0, 0, {"key": keys}, offset=0)
            (v_new,) = aud.reconcile([0], job="t-2-0")
            (v_chain,) = aud.reconcile([0], job=["t-1-0", "t-2-0"])
            out[pkg] = (v_new["ok"] is True, v_chain["ok"], v_chain["job"], v_chain["rows_mapped"],
                        v_chain["rows_delivered"], v_chain["delivered_seq"])
        finally:
            aud.reset(clear_spool=True)
    assert out["port"] == out["jax"]
    assert out["port"][:5] == (False, True, "t-2-0", 100, 100)


# -- the port's own: the per-job tracker, the audit reset, the journal ---------------


def test_second_job_start_keeps_the_first_jobs_fence_and_delivered_ids():
    """Two jobs' trials in the tracker: the second's start leaves the first
    job's in-flight epochs fenced and its delivered batches guarded; the
    fence is the union of the running jobs'; an ended job leaves the fence
    and a run outside a job owns the tracker again."""
    ObjectRef = runtime.ObjectRef
    sm = shuffle_mod
    sm._live_jobs.clear()
    sm._delivered.clear()
    sm._status_begin_trial(2, 4, 4, 1, 0, job="a-1-0")
    sm._status_epoch(0, state="running", job="a-1-0")
    sm._status_delivered([ObjectRef("seg-a0", 8, "s")], job="a-1-0")
    sm._status_begin_trial(2, 4, 4, 1, 0, job="b-1-1")
    sm._status_epoch(1, state="admitted", job="b-1-1")
    sm._status_delivered([ObjectRef("seg-b1", 8, "s"), "not-a-ref"], job="b-1-1")
    assert sm.protected_epochs() == {0, 1}
    assert sm.delivered_ids() == {"seg-a0", "seg-b1"}
    status = sm.live_status()
    assert set(status["jobs"]) == {"a-1-0", "b-1-1"}
    assert status["jobs"]["a-1-0"]["in_flight_epochs"] == [0]
    assert status["job"] == "b-1-1" and status["running"]
    sm._status_epoch(0, state="done", job="a-1-0")
    sm._status_end_trial(job="a-1-0")
    assert sm.protected_epochs() == {1}
    sm._status_end_trial(job="b-1-1")
    assert sm.protected_epochs() == set()
    assert sm.delivered_ids() == {"seg-a0", "seg-b1"}
    sm._status_begin_trial(1, 4, 4, 1, 0)  # outside a job
    assert sm.delivered_ids() == set() and "jobs" not in sm.live_status()
    sm._status_end_trial()


def test_tracker_matches_jax_for_the_same_trials():
    """The same sequence of trial updates gives the JAX package's
    ``live_status`` (timestamps aside) and fence."""

    def drive(sm):
        sm._live_jobs.clear()
        sm._status_begin_trial(3, 4, 4, 1, 0, job="a-1-0")
        sm._status_epoch(0, state="running", schedule="mapreduce", job="a-1-0")
        sm._status_epoch(0, delivered_inc=1, job="a-1-0")
        sm._status_begin_trial(2, 4, 2, 1, 1, job="b-1-1")
        sm._status_epoch(1, state="waiting-admission", job="b-1-1")
        sm._status_epoch(0, state="done", job="a-1-0")
        sm._status_epoch(1, state="running", schedule="index", job="a-1-0")
        sm._status_end_trial(error="boom", job="b-1-1")
        status = sm.live_status()

        def strip(d):
            return {k: strip(v) if isinstance(v, dict) else v for k, v in d.items()
                    if k not in ("started_ts", "ended_ts")}

        return strip(status), sm.protected_epochs()

    assert drive(shuffle_mod) == drive(_mod("jax", "shuffle"))
    for sm in (shuffle_mod, _mod("jax", "shuffle")):
        sm._live_jobs.clear()


def test_begin_run_clears_a_sole_tenants_spool_and_keeps_a_concurrent_ones(session):
    """``begin_run(job=)`` runs the full reset for the session's only live
    job; with a second live job it keeps every record on the spool."""
    session()
    keys = np.arange(50, dtype=np.int64)
    tel = _mod("port", "telemetry")
    job_a = svc.register_job(name="a")
    try:
        with tel.context(job=job_a.job_id):
            audit.record_map(0, 0, {"key": keys})
        audit.flush()
        assert audit._load_records()
        audit.begin_run(job=job_a.job_id)  # the sole tenant
        assert audit._load_records() == []
        with tel.context(job=job_a.job_id):
            audit.record_map(0, 0, {"key": keys})
        audit.flush()
        job_b = svc.register_job(name="b")
        try:
            audit.begin_run(job=job_b.job_id)  # a's records stay
            recs = audit._load_records()
            assert len(recs) == 1 and recs[0].get("job") == job_a.job_id
        finally:
            svc.end_job(job_b)
    finally:
        svc.end_job(job_a)


def test_journal_identity_takes_the_job_name(files, monkeypatch):
    """``run_identity(job=)`` keys the validated identity by the job's name,
    as the JAX package's does; two names refuse each other's runs."""
    args = (files, 2, 4, 1, 7, 0, False, "rowwise", None, None)
    port_j, jax_j = _mod("port", "runtime.journal"), _mod("jax", "runtime.journal")
    ident = port_j.run_identity(*args, job="tenant-a")
    want = jax_j.run_identity(*args, job="tenant-a")
    drop = ("session", "runtime_dir", "shm_dir")
    assert {k: v for k, v in ident.items() if k not in drop} == {k: v for k, v in want.items() if k not in drop}
    port_j.validate_identity(ident, port_j.run_identity(*args, job="tenant-a"))
    with pytest.raises(ValueError, match="job"):
        port_j.validate_identity(ident, port_j.run_identity(*args, job="tenant-b"))
    assert "job" not in port_j.run_identity(*args)


# -- runs -----------------------------------------------------------------------------


def test_two_jobs_concurrent_audit_isolated(session, files, jax_streams):
    """Two concurrent jobs (the same files, seeds 7 and 9): each delivers
    the JAX package's service-off stream of its seed, key for key in order,
    exactly once, with strict per-job verdicts ``ok``; the fair share and
    the delivered-bytes counters saw both."""
    session()
    threads, results, errors = _two_jobs(files, [("ja", 7), ("jb", 9)])
    for t in threads:
        t.join(timeout=180)
    assert not errors, errors
    assert set(results) == {"ja", "jb"}
    snap = metrics.registry.snapshot()
    for name, seed in (("ja", 7), ("jb", 9)):
        job, consumer, _ = results[name]
        assert [consumer.keys[(e, 0)] for e in range(EPOCHS)] == jax_streams[seed]
        _exactly_once(consumer)
        verdicts = audit.reconcile(range(EPOCHS), job=job.job_id)
        assert [v["ok"] for v in verdicts] == [True] * EPOCHS
        assert {v["job"] for v in verdicts} == {job.job_id}
        assert snap[f"service.delivered_bytes{{job={job.job_id}}}"] > 0
    assert snap["service.jobs_registered"] == 2.0
    assert jax_streams[7] != jax_streams[9]


def test_two_jobs_status_and_fence(session, files):
    """While two jobs run, the tracker holds both and the fence is within
    their windows; after both end nothing is fenced."""
    session(audit_on=False)
    gate = threading.Event()
    threads, results, errors = _two_jobs(files, [("sa", 3, Gated(runtime, gate)), ("sb", 4, Gated(runtime, gate))])
    try:
        def running():
            return sorted(st["job"] for st in (shuffle_mod.live_status().get("jobs") or {}).values()
                          if st.get("running"))

        assert _wait_for(lambda: len(running()) == 2, timeout=60)
        status = shuffle_mod.live_status()
        assert status["running"] and [j.split("-")[0] for j in running()] == ["sa", "sb"]
        assert shuffle_mod.protected_epochs() <= {0, 1}
        assert {r["name"] for r in svc.jobs_snapshot() if r["running"]} == {"sa", "sb"}
    finally:
        gate.set()
        for t in threads:
            t.join(timeout=120)
    assert not errors, errors
    for _, consumer, _ in results.values():
        _exactly_once(consumer)
    assert shuffle_mod.protected_epochs() == set()
    assert svc.live_jobs_count() == 0


def test_two_same_name_queues_coexist(session):
    """Two jobs make a batch queue under one logical name: two actors, each
    with its job's items; connecting in a job finds that job's."""
    session(audit_on=False)
    BatchQueue = _mod("port", "batch_queue").BatchQueue
    job_a, job_b = svc.register_job(name="qa"), svc.register_job(name="qb")
    try:
        with svc.job_context(job_a):
            qa = BatchQueue(1, 1, 1, name="svc-queue")
            qa.ready()
        with svc.job_context(job_b):
            qb = BatchQueue(1, 1, 1, name="svc-queue")
            qb.ready()
        assert qa.actor.address != qb.actor.address
        assert (qa.actor.name, qb.actor.name) == (f"svc-queue--{job_a.job_id}", f"svc-queue--{job_b.job_id}")
        qa.new_epoch(0)
        qb.new_epoch(0)
        qa.put_batch(0, 0, ["from-a"])
        qb.put_batch(0, 0, ["from-b"])
        assert qa.get_batch(0, 0, timeout=5) == ["from-a"]
        assert qb.get_batch(0, 0, timeout=5) == ["from-b"]
        with svc.job_context(job_a):
            assert runtime.connect_actor("svc-queue").address == qa.actor.address
            assert runtime.resolve_actor("svc-queue").address == qa.actor.address
        assert runtime.resolve_actor("svc-queue") is None  # outside a job: no such name
        qa.shutdown(force=True)
        qb.shutdown(force=True)
    finally:
        svc.end_job(job_a)
        svc.end_job(job_b)


def test_two_tenants_datasets_under_one_queue_name(session, files, jax_streams):
    """Two tenants' ``DeviceShufflingDataset``\\ s (on the CPU), each made on
    its own thread inside its job's context under one logical queue name:
    rank 0 carries the caller's job to its shuffle-driver thread, and the
    stager its job to its thread, so the queues are the jobs' own, each
    tenant reads its seed's JAX stream, and its verdicts, ``ok`` under the
    strict audit, fold its consumed and staged rows."""
    session()
    port = importlib.import_module("ray_shuffling_data_loader_tpu_torch")
    features = [c for c in port.DATA_SPEC if c != port.LABEL_COLUMN]
    jobs = {name: svc.register_job(name=name) for name in ("da", "db")}
    keys, queues, errors = {}, {}, {}

    def tenant(name, seed):
        try:
            with svc.job_context(jobs[name]):
                ds = port.DeviceShufflingDataset(
                    files, EPOCHS, 1, 400, 0, feature_columns=[*features, port.KEY_COLUMN],
                    label_column=port.LABEL_COLUMN, num_reducers=NUM_REDUCERS, seed=seed, queue_name="tenants",
                    device="cpu")
                queues[name] = ds.dataset._batch_queue.actor.name
                for epoch in range(EPOCHS):
                    ds.set_epoch(epoch)
                    keys[(name, epoch)] = [k for feats, _ in ds for k in feats[port.KEY_COLUMN].tolist()]
                ds.join()
        except BaseException as exc:
            errors[name] = exc

    threads = [threading.Thread(target=tenant, args=args) for args in (("da", 7), ("db", 9))]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=180)
    finally:
        for job in jobs.values():
            svc.end_job(job)
    assert not errors, errors
    assert queues == {name: f"tenants--{job.job_id}" for name, job in jobs.items()}
    for name, seed in (("da", 7), ("db", 9)):
        assert [keys[(name, e)] for e in range(EPOCHS)] == jax_streams[seed]
        verdicts = audit.reconcile(range(EPOCHS), job=jobs[name].job_id)
        assert [v["ok"] for v in verdicts] == [True] * EPOCHS
        # The stager's thread read and staged for the tenant's job.
        assert [(v["rows_consumed"], v["rows_staged"]) for v in verdicts] == [(TOTAL_ROWS, TOTAL_ROWS)] * EPOCHS


@pytest.mark.parametrize("spec,seed", [("task.reduce/task:crash-exit:1x2", 23), ("store.get/task:lost:1x1", 17)])
def test_chaos_reducer_crash_isolated(session, files, jax_streams, spec, seed):
    """A capped schedule crashes the first reduce attempts, or loses each
    worker's first store read (a reduce's window, re-made from its map's
    lineage), of either job: the struck job recovers through its stage
    budget on the fair-share scheduler, in its own job's context, the other
    never notices, and both deliver their seed's JAX stream with strict
    verdicts ``ok``."""
    session(RSDL_FAULTS=spec, RSDL_FAULTS_SEED=str(seed))
    threads, results, errors = _two_jobs(files, [("ca", 11), ("cb", 13)])
    for t in threads:
        t.join(timeout=240)
    assert not errors, errors
    recovered = 0
    for name, job_seed in (("ca", 11), ("cb", 13)):
        job, consumer, stats = results[name]
        assert [consumer.keys[(e, 0)] for e in range(EPOCHS)] == jax_streams[job_seed]
        verdicts = audit.reconcile(range(EPOCHS), job=job.job_id)
        assert [v["ok"] for v in verdicts] == [True] * EPOCHS
        recovered += sum((stats.get("stage_retries") or {}).values())
        recovered += sum((stats.get("rematerialized") or {}).values())
    assert recovered >= 1


def test_cross_job_cache_hot(session, files):
    """Job 2 over the same files reads job 1's decoded segments from its
    first epoch: it decodes no row group, its lookups hit, its stream is
    job 1's for the same seed; the claims fence the segments while a job
    lives and go when both end. The schedule is forced (the host probe's
    choice is not what this is about)."""
    session(audit_on=False, RSDL_INDEX_SHUFFLE="on")
    svc.cache_registry_clear()
    log1, log2 = [], []
    job1 = svc.register_job(name="warm")
    job2 = None
    try:
        with svc.job_context(job1):
            c1, s1 = Collecting(runtime), {}
            shuffle_mod.shuffle(files, c1, EPOCHS, NUM_REDUCERS, 1, seed=7, cache_decoded=True, schedule_log=log1,
                                stats=s1)
        assert dict(log1) == {0: "mapreduce", 1: "index"}
        assert s1["decode_rowgroups"][0] == NUM_FILES and s1["decode_rowgroups"].get(1, 0) == 0
        assert len(svc.claimed_cache_ids()) == NUM_FILES
        job2 = svc.register_job(name="rider")
        with svc.job_context(job2):
            c2, s2 = Collecting(runtime), {}
            shuffle_mod.shuffle(files, c2, 1, NUM_REDUCERS, 1, seed=7, cache_decoded=True, schedule_log=log2,
                                stats=s2)
        assert s2["decode_rowgroups"].get(0, 0) == 0, s2["decode_rowgroups"]
        assert s2["shared_cache_hits"] == NUM_FILES
        assert dict(log2) == {0: "index"}
        assert metrics.registry.snapshot()[f"service.cache_hits{{job={job2.job_id}}}"] >= NUM_FILES
        assert c2.keys[(0, 0)] == c1.keys[(0, 0)]
        assert svc.job_cache_claims() == {job1.job_id: NUM_FILES, job2.job_id: NUM_FILES}
    finally:
        svc.end_job(job1)
        svc.end_job(job2)
    assert svc.claimed_cache_ids() == set()


def test_two_jobs_slo_fire_and_resolve_isolated(session, files, monkeypatch):
    """Job A's delivery stalls behind a gated consumer: the per-job
    ``producer_stalled`` instance fires for A alone and resolves once the
    gate opens; B never fires; both end with strict verdicts ``ok``."""
    slo = _mod("port", "telemetry.slo")
    timeseries = _mod("port", "telemetry.timeseries")
    events = _mod("port", "telemetry.events")
    monkeypatch.setenv("RSDL_SLO_RULES", json.dumps([
        {"name": "producer_stalled", "kind": "rate", "metric": "shuffle.reduce_rows", "per_job": True,
         "per_job_metric": "service.delivered_bytes", "op": "==", "value": 0.0, "window_s": 8.0, "for_s": 2.0,
         "only_in_flight": True, "severity": "page"},
    ]))
    session()
    events.reset()
    timeseries.reset()
    slo.reset()
    gate = threading.Event()
    ids = {}

    def run(name, seed, consumer):
        job = svc.register_job(name=name)
        ids[name] = job.job_id
        try:
            with svc.job_context(job):
                shuffle_mod.shuffle(files, consumer, EPOCHS, NUM_REDUCERS, 1, seed=seed)
                results[name] = (job, consumer)
        except BaseException as exc:
            errors[name] = exc
        finally:
            svc.end_job(job)

    results, errors = {}, {}
    threads = [threading.Thread(target=run, args=("sa", 7, Gated(runtime, gate))),
               threading.Thread(target=run, args=("sb", 9, Collecting(runtime)))]
    for t in threads:
        t.start()
    try:
        fired, saw_both = None, False
        deadline = time.time() + 150
        while time.time() < deadline and fired is None:
            timeseries.sample_now()
            out = slo.evaluate()
            saw_both = saw_both or set(ids.values()) <= set(out["jobs"])
            fired = next((a for a in out["active"] if a.startswith("producer_stalled|")), None)
            time.sleep(0.2)
        assert fired == f"producer_stalled|{ids['sa']}", (fired, ids)
        assert saw_both
        assert metrics.registry.snapshot()[f"alert.active{{job={ids['sa']},rule=producer_stalled}}"] == 1.0
        assert slo.active_alerts_by_job().get(ids["sa"]) == ["producer_stalled"]
        assert ids["sb"] not in slo.active_alerts_by_job()
        gate.set()
        resolved = False
        deadline = time.time() + 150
        while time.time() < deadline and not resolved:
            timeseries.sample_now()
            resolved = fired not in slo.evaluate()["active"]
            time.sleep(0.2)
        assert resolved
    finally:
        gate.set()
        for t in threads:
            t.join(timeout=240)
    assert not errors, errors
    for name in ("sa", "sb"):
        job, consumer = results[name]
        _exactly_once(consumer)
        assert [v["ok"] for v in audit.reconcile(range(EPOCHS), job=job.job_id)] == [True] * EPOCHS
    fired_events = [r for r in events.load() if r.get("kind") == "alert.fired"]
    assert any(r.get("job") == ids["sa"] and r.get("rule") == "producer_stalled" for r in fired_events)
    assert not [r for r in fired_events if r.get("job") == ids["sb"]]
    assert [r for r in events.load() if r.get("kind") == "alert.resolved" and r.get("job") == ids["sa"]]
    assert slo.fired_counts().get(f"producer_stalled|{ids['sa']}", 0) >= 1
    assert not [k for k in slo.fired_counts() if ids["sb"] in k]


def test_jobs_endpoint_lists_both_tenants(session, files, monkeypatch):
    """``/jobs`` with two tenants held mid-run: a row each (identity, the
    trial's shape, no alert, the claims column), ``/status`` has them in
    ``fleet`` and its ``service`` section; and the planes that look the
    service up (the profiler's and the run ledger's job identity, the
    SLO's tenants) find it."""
    obs_server = _mod("port", "telemetry.obs_server")
    session(audit_on=False)
    port_num = obs_server.start(0)
    monkeypatch.setenv("RSDL_OBS_PORT", str(port_num))

    def get(path):
        with urllib.request.urlopen(f"http://127.0.0.1:{port_num}{path}", timeout=10) as resp:
            return json.loads(resp.read().decode())

    gate = threading.Event()
    threads, results, errors = _two_jobs(files, [("fa", 3, Gated(runtime, gate)), ("fb", 4, Gated(runtime, gate))])
    try:
        ids = {}
        assert _wait_for(lambda: len([r for r in svc.jobs_snapshot() if r["running"]]) == 2, timeout=60)
        ids = {r["name"]: r["job_id"] for r in svc.jobs_snapshot()}
        body = None
        deadline = time.time() + 120
        while time.time() < deadline:
            body = get("/jobs")
            rows = {r["job_id"]: r for r in body["jobs"] if r.get("running")}
            if set(ids.values()) <= set(rows) and all(rows[j].get("num_epochs") for j in ids.values()):
                break
            time.sleep(0.2)
        assert body["service_mode"] == "auto"
        rows = {r["job_id"]: r for r in body["jobs"]}
        for name, jid in ids.items():
            row = rows[jid]
            assert (row["name"], row["running"], row["pid"], row["weight"]) == (name, True, os.getpid(), 1.0)
            assert (row["num_epochs"], row["num_reducers"], row["active_alerts"]) == (EPOCHS, NUM_REDUCERS, [])
            assert "cache_claims" in row
        status = get("/status")
        assert set(ids.values()) <= {r["job_id"] for r in status["fleet"]["running"]}
        assert {r["name"] for r in status["providers"]["service"]["jobs"]} == {"fa", "fb"}
        assert sorted(_mod("port", "telemetry.slo")._live_job_ids({})) == sorted(ids.values())
        job = svc.Job(ids["fa"], "fa", 1.0)
        with svc.job_context(job):
            assert _mod("port", "telemetry.profiler")._current_job_id() == ids["fa"]
            assert _mod("port", "telemetry.runledger")._job_identity() == {"id": ids["fa"], "name": "fa"}
    finally:
        gate.set()
        for t in threads:
            t.join(timeout=240)
        obs_server.stop()
    assert not errors, errors
    assert set(results) == {"fa", "fb"}


def test_a_shuffle_outside_a_job_runs_as_its_own(session, files, jax_streams, tmp_path, caplog):
    """Under the service a ``shuffle()`` called outside a job registers one
    (the default name ``job``), runs in it and ends it on return; journaled
    under that default name it warns, and its run identity carries the
    name, as the JAX package's does."""
    session(audit_on=False, RSDL_JOURNAL=str(tmp_path / "journal"))
    consumer, stats = Collecting(runtime), {}
    with caplog.at_level("WARNING"):
        shuffle_mod.shuffle(files, consumer, EPOCHS, NUM_REDUCERS, 1, seed=3, stats=stats)
    assert [consumer.keys[(e, 0)] for e in range(EPOCHS)] == jax_streams[3]
    assert "default job name 'job'" in caplog.text
    (rec,) = [r for r in svc.jobs_snapshot() if r["name"] == "job"]
    assert rec["running"] is False and svc.live_jobs_count() == 0
    assert shuffle_mod.live_status()["jobs"][rec["job_id"]]["running"] is False
    state = _mod("port", "runtime.journal").load_run(stats["journal"])
    assert state.identity["job"] == "job" and state.identity["audit_jobs"] == [rec["job_id"]]


def test_service_off_never_imports_the_plane():
    """``RSDL_SERVICE`` unset: a fresh interpreter through the gates (the
    session and its scheduler, the shared cache's parser, a batch queue, a
    shuffle) never loads the service module."""
    code = """
import os, sys, threading
for k in list(os.environ):
    if k.startswith("RSDL_"):
        del os.environ[k]
import importlib
import numpy as np
from ray_shuffling_data_loader_tpu_torch import runtime
sh = importlib.import_module("ray_shuffling_data_loader_tpu_torch.shuffle")
from ray_shuffling_data_loader_tpu_torch.batch_queue import BatchQueue
from ray_shuffling_data_loader_tpu_torch.data_generation import generate_file

if __name__ == "__main__":
    import tempfile
    d = tempfile.mkdtemp()
    files = [generate_file(i, i * 100, 100, 1, d)[0] for i in range(2)]
    ctx = runtime.init(num_workers=1)
    _ = ctx.scheduler
    assert not sh.shared_decode_cache_enabled()
    q = BatchQueue(1, 1, 1, name="zq")
    q.ready()
    q.shutdown(force=True)

    class C:
        def consume(self, rank, epoch, batches):
            runtime.get_context().store.free(batches)
        def producer_done(self, rank, epoch): pass
        def wait_until_ready(self, epoch): pass
        def wait_until_all_epochs_done(self): pass

    sh.shuffle(files, C(), 1, 2, 1, seed=0)
    runtime.shutdown()
    assert "ray_shuffling_data_loader_tpu_torch.runtime.service" not in sys.modules, "service imported"
    assert not [t for t in threading.enumerate() if "fair-share" in t.name]
    print("ZERO_OVERHEAD_OK")
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=180,
                         env={**os.environ, "PYTHONPATH": REPO, "JAX_PLATFORMS": "cpu"}, cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "ZERO_OVERHEAD_OK" in out.stdout
