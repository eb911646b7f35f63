"""The multi-job shuffle service: one shuffle plane, many jobs.

Concurrent :func:`~..shuffle.shuffle` calls of one session (distinct
datasets, seeds and epoch windows; threads of one driver, or drivers of
one session) each run as a **job** against the shared worker pool, and get:

* **job-scoped names**: named actors (the batch queue) carry the job id
  (:func:`scoped_name`), and so do the live trial tracker, the audit's
  digest records, the journal's run identity (by job name) and the
  capacity ledger, so two same-shaped jobs neither clobber each other's
  resources nor fold into each other's verdicts;
* **fair share** (:class:`FairShareScheduler`): stage tasks released from
  the backlogged job with the smallest virtual time, by weight, so that no
  job's flood starves another's tasks out of the pool;
* **epoch admission** (:func:`admit_epoch`): a new epoch window waits while
  the capacity ledger's shm fraction is over the watermark and another job
  is live, bounded;
* **a content-keyed decode cache** (:func:`cache_key`: file fingerprint,
  projection, narrowing) with per-job claims in a registry under the
  session's directory, so that a second job over the same Parquet files
  reads the first job's decoded segments from its first epoch, and the
  elastic evictor never drops a segment a live job claims
  (:func:`claimed_cache_ids`).

``RSDL_SERVICE=auto|off``. Unset, this module is never imported (every
import of it is behind a check of the variable), no thread starts, and the
single-job path is unchanged.

The port's proxy futures are ``concurrent.futures`` futures, as the pool's
are: a held task's proxy is resolved, and the next task released, from
its inner future's done callback, where the JAX package polls the futures
on a watcher thread. Names, events, counters, gauges and knobs are the JAX
package's. Standard library only.
"""

from __future__ import annotations

import concurrent.futures as cf
import contextlib
import itertools
import json
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence

from ray_shuffling_data_loader_tpu_torch import telemetry
from ray_shuffling_data_loader_tpu_torch.telemetry import metrics as _metrics

_ENV_MODE = "RSDL_SERVICE"
_ENV_JOB_ID = "RSDL_JOB_ID"
_ENV_JOB_NAME = "RSDL_JOB_NAME"
_ENV_JOB_WEIGHT = "RSDL_JOB_WEIGHT"
_ENV_ADMIT_FRAC = "RSDL_SERVICE_ADMIT_FRAC"
_ENV_ADMIT_TIMEOUT = "RSDL_SERVICE_ADMIT_TIMEOUT_S"

_OFF_VALUES = ("", "off", "0", "false", "no")


def mode() -> str:
    """``RSDL_SERVICE`` as parsed (``off`` when unset or off), read per
    call."""
    raw = os.environ.get(_ENV_MODE, "").strip().lower()
    return "off" if raw in _OFF_VALUES else raw


def enabled() -> bool:
    return mode() != "off"


# -- jobs ------------------------------------------------------------------------------


class Job:
    """One tenant: ``job_id`` (``name-pid-counter``, unique in the session)
    suffixes its scoped names; ``name`` is its stable identity (the
    journal's run identity); ``weight`` its fair share."""

    __slots__ = ("job_id", "name", "weight", "pid", "created_ts", "ended_ts")

    def __init__(self, job_id: str, name: str, weight: float):
        self.job_id = job_id
        self.name = name
        self.weight = float(weight)
        self.pid = os.getpid()
        self.created_ts = time.time()
        self.ended_ts: Optional[float] = None

    @property
    def running(self) -> bool:
        return self.ended_ts is None

    def to_dict(self) -> Dict[str, Any]:
        return {"job_id": self.job_id, "name": self.name, "weight": self.weight, "pid": self.pid,
                "created_ts": self.created_ts, "ended_ts": self.ended_ts, "running": self.running}


_jobs_lock = threading.Lock()
_jobs: Dict[str, Job] = {}
_job_counter = itertools.count()
_tls = threading.local()


def _default_weight() -> float:
    try:
        w = float(os.environ.get(_ENV_JOB_WEIGHT, "1.0"))
    except ValueError:
        w = 1.0
    return max(w, 0.001)  # a zero weight would starve the job


def _service_dir() -> Optional[str]:
    """``<runtime_dir>/service`` while a session is live, else None: the
    job records and the cache registry, seen by every process of the
    session."""
    from ray_shuffling_data_loader_tpu_torch import runtime

    if not runtime.is_initialized():
        return None
    try:
        return os.path.join(runtime.get_context().runtime_dir, "service")
    except Exception:
        return None


def _write_job_record(job: Job) -> None:
    base = _service_dir()
    if base is None:
        return
    try:
        jobs_dir = os.path.join(base, "jobs")
        os.makedirs(jobs_dir, exist_ok=True)
        path = os.path.join(jobs_dir, f"{job.job_id}.json")
        tmp = f"{path}.tmp-{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(job.to_dict(), f)
        os.replace(tmp, path)
    except OSError:
        pass


def register_job(name: Optional[str] = None, weight: Optional[float] = None) -> Job:
    """Register a tenant. ``name``: else ``RSDL_JOB_NAME``, else ``"job"``;
    ``weight``: else ``RSDL_JOB_WEIGHT``, else 1. Registers the ``service``
    section of ``/status`` when the obs server is configured."""
    name = (name or os.environ.get(_ENV_JOB_NAME) or "job").strip()
    weight = _default_weight() if weight is None else max(float(weight), 0.001)
    with _jobs_lock:
        job = Job(f"{name}-{os.getpid()}-{next(_job_counter)}", name, weight)
        _jobs[job.job_id] = job
    _write_job_record(job)
    _maybe_register_status_provider()
    _metrics.safe_inc("service.jobs_registered")
    telemetry.emit_event("job.registered", job=job.job_id, name=name, weight=weight)
    _set_active_gauge()
    return job


def end_job(job: Optional[Job]) -> None:
    """End a job: its cache claims go, and its tasks still queued for fair
    share fail (those in flight finish)."""
    if job is None or job.ended_ts is not None:
        return
    job.ended_ts = time.time()
    _write_job_record(job)
    release_claims(job.job_id)
    sched = _scheduler_singleton()
    if sched is not None:
        sched.forget_job(job.job_id)
    telemetry.emit_event("job.ended", job=job.job_id, name=job.name)
    _set_active_gauge()


def _set_active_gauge() -> None:
    try:
        if _metrics.enabled():
            _metrics.registry.gauge("service.jobs_active").set(float(len(active_jobs())))
    except Exception:
        pass


def active_jobs() -> List[Job]:
    with _jobs_lock:
        return [j for j in _jobs.values() if j.running]


def _record_live(rec: Dict[str, Any]) -> bool:
    """Is a job record live: ``running`` and its pid alive? A driver killed
    before its ``end_job`` leaves a ``running`` record, which must neither
    fence its cache claims nor count as a tenant. Every process that writes
    one is on this host (the records are in the session's directory)."""
    if not rec.get("running"):
        return False
    pid = rec.get("pid")
    if not pid:
        return False
    if int(pid) == os.getpid():
        return True
    try:
        os.kill(int(pid), 0)
        return True
    except ProcessLookupError:
        return False
    except OSError:
        return True  # alive, another user's


def live_jobs_count() -> int:
    """Running jobs across the session's processes: this process's and the
    live records of the others. Admission and the audit's spool reset key
    on it."""
    seen = {j.job_id for j in active_jobs()}
    for rec in jobs_snapshot():
        jid = rec.get("job_id")
        if jid not in seen and _record_live(rec):
            seen.add(jid)
    return len(seen)


def jobs_snapshot() -> List[Dict[str, Any]]:
    """Every job of the session: this process's, merged with the records
    other drivers wrote, oldest first."""
    with _jobs_lock:
        out = {j.job_id: j.to_dict() for j in _jobs.values()}
    base = _service_dir()
    if base is not None:
        jobs_dir = os.path.join(base, "jobs")
        try:
            names = os.listdir(jobs_dir)
        except OSError:
            names = []
        for fname in names:
            if not fname.endswith(".json"):
                continue
            try:
                with open(os.path.join(jobs_dir, fname)) as f:
                    rec = json.load(f)
            except (OSError, ValueError):
                continue
            out.setdefault(str(rec.get("job_id")), rec)
    return sorted(out.values(), key=lambda r: r.get("created_ts") or 0.0)


def current_job() -> Optional[Job]:
    """The ambient job: this thread's (:func:`job_context`,
    :func:`set_current_job`), else the process's from ``RSDL_JOB_ID`` (a
    rank spawned by a job's driver inherits it)."""
    job = getattr(_tls, "job", None)
    if job is not None:
        return job
    env_id = os.environ.get(_ENV_JOB_ID)
    if env_id:
        with _jobs_lock:
            job = _jobs.get(env_id)
            if job is None:
                job = _jobs[env_id] = Job(env_id, os.environ.get(_ENV_JOB_NAME) or env_id, _default_weight())
        return job
    return None


def set_current_job(job: Optional[Job]) -> None:
    _tls.job = job


@contextlib.contextmanager
def job_context(job: Optional[Job]):
    """``job`` ambient in the block: names made inside are scoped, and the
    trace context carries ``job=<id>`` (spans, events, audit digests and
    ledger ops, here and in the tasks the block submits)."""
    if job is None:
        yield
        return
    prev = getattr(_tls, "job", None)
    _tls.job = job
    try:
        with telemetry.context(job=job.job_id):
            yield
    finally:
        _tls.job = prev


def scoped_name(base: str, job: Optional[Job] = None) -> str:
    """``base--<job_id>`` for the ambient (or given) job with the service
    on, else ``base``; idempotent."""
    job = job if job is not None else current_job()
    if not enabled() or job is None or not base:
        return base
    suffix = f"--{job.job_id}"
    return base if base.endswith(suffix) else f"{base}{suffix}"


# -- fair share ------------------------------------------------------------------------


class FairShareScheduler:
    """Weighted interleaving of the jobs' stage tasks on one scheduler.

    Wraps the session's scheduler (the :class:`~.tasks.WorkerPool` or the
    cluster's, each with ``submit``, ``submit_local_to`` and ``width``). A
    task submitted outside a job goes straight through. A job's task gets a
    proxy future and queues; the backlogged job with the smallest virtual
    time (start-time fair queuing: a release advances its job's clock by
    ``1 / weight``, and a newly backlogged job starts at the smallest clock
    of those active) releases next, while the released, unfinished tasks
    number fewer than the width. So a weight-2 job releases twice for a
    weight-1 job's once, and a flooding job cannot starve another. A sole
    tenant has no cap: it floods the pool as with the service off.

    The proxy is a ``concurrent.futures.Future``: ``add_done_callback`` and
    :func:`~.tasks.wait` work on it. Its inner future's done callback
    resolves it and releases the next task."""

    def __init__(self, inner):
        self.inner = inner
        self._lock = threading.Lock()
        self._pending: Dict[str, deque] = {}
        self._weights: Dict[str, float] = {}
        self._inflight: Dict[str, int] = {}
        self._vtime: Dict[str, float] = {}
        self._released: List[tuple] = []  # (inner future, job id, proxy)
        self._closed = False
        self._lag_published: set = set()
        self._pumping = False  # a thread is releasing
        self._repump = False  # another pump asked it to look again

    @property
    def width(self) -> int:
        return max(1, int(getattr(self.inner, "width", 1)))

    def submit(self, fn: Callable, *args, **kwargs):
        return self._enqueue(lambda: self.inner.submit(fn, *args, **kwargs))

    def submit_local_to(self, refs, fn: Callable, *args, **kwargs):
        return self._enqueue(lambda: self.inner.submit_local_to(refs, fn, *args, **kwargs))

    def _enqueue(self, thunk: Callable[[], Any]):
        job = current_job()
        if job is None or not job.running:
            return thunk()
        proxy: cf.Future = cf.Future()
        proxy.set_running_or_notify_cancel()
        # The submitter's trace context, taken now: a held task is released
        # on another thread, whose submit would ship that thread's context
        # (and a worker's digests would fold jobless).
        try:
            ctx = telemetry.outbound() or {}
        except Exception:
            ctx = {}
        if ctx:
            inner_thunk = thunk

            def thunk(_run=inner_thunk, _ctx=ctx):
                with telemetry.context(**_ctx):
                    return _run()
        with self._lock:
            self._weights[job.job_id] = job.weight
            queue = self._pending.setdefault(job.job_id, deque())
            if not queue and not self._inflight.get(job.job_id):
                # Newly backlogged: from the smallest active clock, so that an
                # idle spell banks no credit.
                others = [self._vtime.get(j, 0.0)
                          for j in set(self._inflight) | {k for k, q in self._pending.items() if q and k != job.job_id}]
                self._vtime[job.job_id] = max(self._vtime.get(job.job_id, 0.0), min(others) if others else 0.0)
            queue.append((thunk, proxy))
        self._pump()
        return proxy

    def forget_job(self, job_id: str) -> None:
        """Drop an ended job's queue and clock; its queued proxies fail (left
        pending they would hang their waiters), its tasks in flight finish."""
        with self._lock:
            dropped = self._pending.pop(job_id, None)
            self._vtime.pop(job_id, None)
        for _thunk, proxy in dropped or ():
            _fail(proxy, "job ended")

    def _multi_tenant_locked(self) -> bool:
        """Two tenants or more: by the queues (tasks of two jobs pending or
        in flight), or by registration (two running jobs: the first
        submissions already shape to the share). This process's jobs only:
        a job of another driver submits to its own pool."""
        jobs = set(self._inflight) | {j for j, q in self._pending.items() if q}
        return len(jobs) > 1 or len(active_jobs()) > 1

    def _pump(self) -> None:
        """Release queued tasks while the cap allows, from the backlogged
        job of the smallest virtual time (ties: fewer in flight, then id).
        One thread releases at a time: a pump that finds another running
        asks it to look again, and the releasing thread stops only under
        the lock that such a request takes. The submits run outside the
        lock."""
        with self._lock:
            if self._pumping:
                self._repump = True
                return
            self._pumping = True
        try:
            while True:
                with self._lock:
                    queues = {j: q for j, q in self._pending.items() if q}
                    stop = self._closed or not queues
                    if not stop and self._multi_tenant_locked() and sum(self._inflight.values()) >= self.width:
                        _metrics.safe_inc("service.tasks_throttled")
                        stop = True
                    if stop:
                        self._publish_vtime_lag_locked()
                        if self._repump and not self._closed:
                            self._repump = False
                            continue
                        self._pumping = self._repump = False
                        return
                    job_id = min(queues, key=lambda j: (self._vtime.get(j, 0.0), self._inflight.get(j, 0), j))
                    self._vtime[job_id] = self._vtime.get(job_id, 0.0) + 1.0 / self._weights.get(job_id, 1.0)
                    thunk, proxy = queues[job_id].popleft()
                    self._inflight[job_id] = self._inflight.get(job_id, 0) + 1
                    self._publish_vtime_lag_locked()
                try:
                    inner = thunk()
                except BaseException as exc:
                    with self._lock:
                        self._dec_inflight_locked(job_id)
                    # The submitter holds the proxy already: fail it, or a
                    # waiter with no timeout hangs.
                    _fail(proxy, f"submit failed: {type(exc).__name__}: {exc}"[:200])
                    raise
                entry = (inner, job_id, proxy)
                with self._lock:
                    self._released.append(entry)
                # Runs here at once when the task is done already.
                inner.add_done_callback(lambda _f, entry=entry: self._on_done(entry))
        except BaseException:
            with self._lock:
                self._pumping = False
            raise

    def _on_done(self, entry: tuple) -> None:
        """A released task finished: settle its proxy, then release more. A
        raising submit (a pool shutting down) fails its own proxy only."""
        inner, job_id, proxy = entry
        with self._lock:
            self._dec_inflight_locked(job_id)
            try:
                self._released.remove(entry)
            except ValueError:
                pass
            self._publish_vtime_lag_locked()
        if inner.cancelled():
            proxy.set_exception(cf.CancelledError())
        elif inner.exception() is not None:
            proxy.set_exception(inner.exception())
        else:
            proxy.set_result(inner.result())
        try:
            self._pump()
        except Exception:
            pass

    def _publish_vtime_lag_locked(self) -> None:
        """``service.dispatch_vtime_lag{job=}``: how far each active job's
        clock trails the lead; 0 for a job with nothing queued, and for a
        job that left (a stale series would hold ``fair_share_starved``
        open). The caller holds the lock; metrics-gated, never raises."""
        if not _metrics.enabled():
            return
        try:
            reg = _metrics.registry
            active = set(self._inflight) | {j for j, q in self._pending.items() if q}
            lead = max((self._vtime.get(j, 0.0) for j in active), default=0.0)
            for job_id in active:
                lag = lead - self._vtime.get(job_id, 0.0) if self._pending.get(job_id) else 0.0
                reg.gauge("service.dispatch_vtime_lag", job=job_id).set(round(lag, 4))
            for job_id in self._lag_published - active:
                reg.gauge("service.dispatch_vtime_lag", job=job_id).set(0.0)
            self._lag_published = active
        except Exception:
            pass

    def _dec_inflight_locked(self, job_id: str) -> None:
        n = self._inflight.get(job_id, 0) - 1
        if n <= 0:
            self._inflight.pop(job_id, None)
        else:
            self._inflight[job_id] = n

    def stop(self) -> None:
        self._closed = True

    def queue_depths(self) -> Dict[str, int]:
        with self._lock:
            return {j: len(q) for j, q in self._pending.items() if q}

    def inflight(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._inflight)


def _fail(proxy: cf.Future, why: str) -> None:
    """Fail a held task's proxy (``fair-share task dropped: <why>``)."""
    try:
        proxy.set_exception(RuntimeError(f"fair-share task dropped: {why}"))
    except cf.InvalidStateError:
        pass


_sched_lock = threading.Lock()
_schedulers: Dict[int, FairShareScheduler] = {}


def wrap_scheduler(inner):
    """``inner`` wrapped for fair share (one wrapper per scheduler), or
    ``inner`` itself with the service off."""
    if not enabled() or isinstance(inner, FairShareScheduler):
        return inner
    with _sched_lock:
        sched = _schedulers.get(id(inner))
        if sched is None or sched.inner is not inner:
            sched = _schedulers[id(inner)] = FairShareScheduler(inner)
        return sched


def _scheduler_singleton() -> Optional[FairShareScheduler]:
    with _sched_lock:
        return next(iter(_schedulers.values()), None)


def stop() -> None:
    """The session's end (``runtime.shutdown``, through ``sys.modules``):
    stop and forget the schedulers."""
    with _sched_lock:
        scheds = list(_schedulers.values())
        _schedulers.clear()
    for sched in scheds:
        sched.stop()


# -- epoch admission -------------------------------------------------------------------


def _admit_frac() -> float:
    try:
        return float(os.environ.get(_ENV_ADMIT_FRAC, "0.85"))
    except ValueError:
        return 0.85


def _admit_timeout_s() -> float:
    try:
        return float(os.environ.get(_ENV_ADMIT_TIMEOUT, "30"))
    except ValueError:
        return 30.0


def admit_epoch(job: Job, epoch: int, in_flight: int) -> float:
    """Hold a new epoch window back while the capacity ledger's
    ``shm_used_frac`` is at or over ``RSDL_SERVICE_ADMIT_FRAC`` and another
    job is live in the session; returns the seconds waited. A job with no
    window in flight is admitted at once (its windows are what would free
    memory), so is a sole tenant, and no wait passes
    ``RSDL_SERVICE_ADMIT_TIMEOUT_S``: admission shapes, never deadlocks."""
    if job is None or in_flight <= 0 or live_jobs_count() <= 1:
        return 0.0
    if not _metrics.enabled():
        return 0.0  # no ledger, no signal
    from ray_shuffling_data_loader_tpu_torch.telemetry import capacity

    watermark = _admit_frac()
    deadline = time.monotonic() + _admit_timeout_s()
    t0 = time.monotonic()
    announced = False
    while True:
        try:
            frac = capacity.view().get("shm_used_frac")
        except Exception:
            frac = None
        if frac is None or float(frac) < watermark:
            break
        if time.monotonic() >= deadline:
            _metrics.safe_inc("service.admission_timeouts", job=job.job_id)
            break
        if not announced:
            announced = True
            telemetry.emit_event("service.admission_wait", job=job.job_id, epoch=epoch, shm_used_frac=float(frac))
        time.sleep(0.2)
    waited = time.monotonic() - t0
    if waited > 0.05:
        try:
            # A histogram: the SLO pack's admission_wait_long reads its
            # windowed mean per tenant, /jobs its count and sum.
            _metrics.registry.histogram("service.admission_wait_seconds", job=job.job_id).observe(waited)
        except Exception:
            pass
    return waited


# -- the content-keyed decode cache ----------------------------------------------------


def cache_key(filename: str, columns: Optional[Sequence[str]], narrow: bool) -> str:
    """One file's decoded columns by content: the file's path, size and
    mtime (a rewritten file never reads a stale segment), the projection
    and the narrowing. Jobs of one content key share one segment."""
    path = filename if "://" in filename else os.path.abspath(filename)
    try:
        st = os.stat(path)
        fp = f"{st.st_size}:{st.st_mtime_ns}"
    except OSError:
        fp = "?"
    proj = "*" if columns is None else ",".join(str(c) for c in columns)
    return f"{path}|{fp}|{proj}|{int(bool(narrow))}"


_cache_lock = threading.Lock()
_cache_mem: Dict[str, Dict[str, Any]] = {}  # this process's view


def _registry_paths() -> Optional[tuple]:
    base = _service_dir()
    if base is None:
        return None
    return os.path.join(base, "cache-registry.json"), os.path.join(base, "cache-registry.lock")


@contextlib.contextmanager
def _registry_locked():
    """The session's registry dict under an flock'd lock file, written back
    at the block's end; None without a session (this process's view
    only)."""
    paths = _registry_paths()
    if paths is None:
        yield None
        return
    import fcntl

    reg_path, lock_path = paths
    os.makedirs(os.path.dirname(reg_path), exist_ok=True)
    with open(lock_path, "a+") as lockf:
        fcntl.flock(lockf, fcntl.LOCK_EX)
        try:
            try:
                with open(reg_path) as f:
                    data = json.load(f)
            except (OSError, ValueError):
                data = {}
            yield data
            tmp = f"{reg_path}.tmp-{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(data, f)
            os.replace(tmp, reg_path)
        finally:
            fcntl.flock(lockf, fcntl.LOCK_UN)


def _ref_to_dict(ref) -> Dict[str, Any]:
    return {"id": ref.object_id, "nbytes": int(ref.nbytes), "session": ref.session,
            "owner": list(ref.owner) if ref.owner is not None else None,
            "rows": [int(ref.rows[0]), int(ref.rows[1])] if ref.rows is not None else None}


def _ref_from_dict(d: Dict[str, Any]):
    from ray_shuffling_data_loader_tpu_torch.runtime.store import ObjectRef

    return ObjectRef(object_id=str(d["id"]), nbytes=int(d.get("nbytes", 0)), session=str(d.get("session", "")),
                     owner=tuple(d["owner"]) if d.get("owner") else None,
                     rows=tuple(d["rows"]) if d.get("rows") else None)


def cache_publish(key: str, ref, job: Optional[Job] = None) -> None:
    """Publish one decoded file's segment under ``key``, claimed by the
    publishing job. The first publisher's segment stays, and a later one
    adds its claim to it. Never raises into the data path."""
    job = job if job is not None else current_job()
    try:
        entry = _ref_to_dict(ref)
        entry["claims"] = {job.job_id: time.time()} if job else {}
        with _cache_lock:
            _cache_mem[key] = entry
        with _registry_locked() as data:
            if data is not None:
                cur = data.get(key)
                if cur is not None and cur.get("id") != entry["id"]:
                    if job is not None:
                        cur.setdefault("claims", {})[job.job_id] = time.time()
                    with _cache_lock:
                        _cache_mem[key] = dict(cur)
                else:
                    entry["claims"] = {**((cur or {}).get("claims") or {}), **entry["claims"]}
                    data[key] = entry
    except Exception:
        pass


def cache_lookup(key: str, job: Optional[Job] = None):
    """The live shared segment of ``key`` (this session's, and still in the
    store), claimed for ``job``; else None, and a stale entry goes, so that
    the caller decodes."""
    from ray_shuffling_data_loader_tpu_torch import runtime

    job = job if job is not None else current_job()
    with _cache_lock:
        entry = _cache_mem.get(key)
    if entry is None:
        try:
            with _registry_locked() as data:
                entry = dict(data[key]) if data and key in data else None
        except Exception:
            entry = None
        if entry is not None:
            with _cache_lock:
                _cache_mem[key] = entry
    if entry is None:
        return None
    try:
        ctx = runtime.get_context()
        ref = _ref_from_dict(entry)
        if ref.session == ctx.store.session and ctx.store.exists(ref):
            if job is not None:
                claim_cache(key, job)
            _metrics.safe_inc("service.cache_hits", job=job.job_id if job else "none")
            return ref
    except Exception:
        pass
    _drop_cache_entry(key)
    return None


def claim_cache(key: str, job: Job) -> None:
    try:
        with _cache_lock:
            entry = _cache_mem.get(key)
            if entry is not None:
                claims = entry.setdefault("claims", {})
                if job.job_id in claims:
                    # One registry write a (job, key), not one a hit: a
                    # claim lasts while its job lives.
                    return
                claims[job.job_id] = time.time()
        with _registry_locked() as data:
            if data is not None and key in data:
                data[key].setdefault("claims", {})[job.job_id] = time.time()
    except Exception:
        pass


def release_claims(job_id: str) -> None:
    """Release every claim of ``job_id`` (its end): its segments are
    ordinary evictor candidates again."""
    try:
        with _cache_lock:
            for entry in _cache_mem.values():
                (entry.get("claims") or {}).pop(job_id, None)
        with _registry_locked() as data:
            for entry in (data or {}).values():
                (entry.get("claims") or {}).pop(job_id, None)
    except Exception:
        pass


def _registry_entries() -> List[Dict[str, Any]]:
    """The registry's entries, then this process's view's."""
    try:
        with _registry_locked() as data:
            entries = list((data or {}).values())
    except Exception:
        entries = []
    with _cache_lock:
        return entries + list(_cache_mem.values())


def claimed_cache_ids() -> set:
    """The object ids of the shared segments a live job claims: the elastic
    evictor's do-not-drop set. Live means a ``running`` record whose pid is
    alive: a killed driver's claims fence nothing."""
    live = {rec.get("job_id") for rec in jobs_snapshot() if _record_live(rec)}
    return {str(e["id"]) for e in _registry_entries() if e.get("id") and any(j in live for j in e.get("claims") or {})}


def job_cache_claims() -> Dict[str, int]:
    """``{job_id: shared entries claimed}``: the ``/jobs`` view's
    ``cache_claims``."""
    seen = set()
    out: Dict[str, int] = {}
    for entry in _registry_entries():
        oid = entry.get("id")
        if oid in seen:
            continue  # one entry, seen in both views
        seen.add(oid)
        for job_id in entry.get("claims") or {}:
            out[job_id] = out.get(job_id, 0) + 1
    return out


def _drop_cache_entry(key: str) -> None:
    try:
        with _cache_lock:
            _cache_mem.pop(key, None)
        with _registry_locked() as data:
            if data is not None:
                data.pop(key, None)
    except Exception:
        pass


def cache_registry_clear() -> None:
    """Drop every registry entry; the segments stay (the session's clean-up
    and the evictor own them)."""
    with _cache_lock:
        _cache_mem.clear()
    try:
        with _registry_locked() as data:
            if data is not None:
                data.clear()
    except Exception:
        pass


# -- observability ---------------------------------------------------------------------

_provider_registered = False


def _maybe_register_status_provider() -> None:
    global _provider_registered
    if _provider_registered or not os.environ.get("RSDL_OBS_PORT"):
        return
    try:
        from ray_shuffling_data_loader_tpu_torch.telemetry import obs_server

        obs_server.register_status_provider("service", status_section)
        _provider_registered = True
    except Exception:
        pass


def status_section() -> Dict[str, Any]:
    """``/status``'s ``service`` section: the jobs, the fair-share queues
    and the cache registry's size."""
    sched = _scheduler_singleton()
    try:
        with _registry_locked() as data:
            cache_entries = len(data or {})
    except Exception:
        cache_entries = len(_cache_mem)
    return {
        "mode": mode(),
        "jobs": jobs_snapshot(),
        "fair_share": {"queued": sched.queue_depths() if sched else {}, "in_flight": sched.inflight() if sched else {}},
        "cache_entries": cache_entries,
    }


def reset_state() -> None:
    """Forget the jobs, the schedulers and this process's cache view (the
    registry on disk is the session's)."""
    global _provider_registered
    stop()
    with _jobs_lock:
        _jobs.clear()
    with _cache_lock:
        _cache_mem.clear()
    _tls.job = None
    _provider_registered = False
