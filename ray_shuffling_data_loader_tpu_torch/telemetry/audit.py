"""The audit plane: exactly-once digests of every side of the shuffle,
and the shuffle's quality per epoch.

Off unless ``RSDL_AUDIT`` is truthy: every hook checks :func:`enabled`
(one cached boolean) first, so a run with the audit off does no digest
work. Armed, each side folds an order-invariant digest over the audit
key column (``RSDL_AUDIT_KEY``, default ``"key"``): per-row splitmix64
hashes combined by XOR and a wrapping sum, with a row count.

* **map**: each file's rows (:func:`record_map`, in the map task's
  worker; the index and selective schedules read the key alone);
* **reduce**: each reducer's permuted output (:func:`record_reduce`; of
  a packed output, its logical key column);
* **deliver**: each reducer output as handed to the consumer
  (:func:`record_deliver`, on the shuffle's delivery loop);
* **consume**: each queue batch as the trainer-side dataset reads it
  back, before the re-cut (:func:`record_consume`);
* **staged**: each post-re-cut batch the device dataset stages
  (:func:`record_staged`).

The digest is associative and blind to order, so *map == reduce ==
delivered* holds when every row survived exactly once, and
:func:`reconcile` names the epoch where it did not. Delivery and
consumption also fold an order-sensitive ``seq`` (each hash mixed with
its position in the rank's stream): with a fixed seed an epoch's
``delivered_seq`` is reproducible, which is what ``replay`` checks. From
a capped prefix of the rank-0 delivered keys (``RSDL_AUDIT_SAMPLE``)
each verdict also carries the shuffle's quality: adjacent pairs kept
from the previous epoch, the mean displacement, and each reducer's
entropy over source files.

Worker processes append their records to ``audit-<pid>.jsonl`` under
``RSDL_AUDIT_DIR``, flushed when a task ends and before its result can
be seen (:mod:`..runtime.tasks`); :func:`reconcile` in the driver folds
every spool with its own buffer. A verdict never raises by default;
``RSDL_AUDIT_STRICT=1`` turns a mismatch into :class:`AuditError`.

The math and the record format are the JAX package's
(``telemetry/audit.py``), bit for bit: either package reconciles the
other's spool, and a port run's verdicts equal the JAX package's for the
same run. This module imports numpy and the standard library only: the
pool workers load it, and they never load torch.
"""

from __future__ import annotations

import atexit
import json
import logging
import math
import os
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ray_shuffling_data_loader_tpu_torch.telemetry import _env

logger = logging.getLogger(__name__)

ENV_AUDIT = "RSDL_AUDIT"
ENV_AUDIT_DIR = "RSDL_AUDIT_DIR"
ENV_AUDIT_KEY = "RSDL_AUDIT_KEY"
ENV_AUDIT_SAMPLE = "RSDL_AUDIT_SAMPLE"
ENV_AUDIT_STRICT = "RSDL_AUDIT_STRICT"

DEFAULT_KEY_COLUMN = "key"
DEFAULT_SAMPLE_KEYS = 4096

_enabled: Optional[bool] = None  # None: not read from the environment yet

_lock = threading.Lock()
_records: List[dict] = []
_verdicts: List[dict] = []
_sample_counts: Dict[Tuple, int] = {}  # (job, epoch) -> sample keys taken
_faults: Dict[Tuple[str, int], int] = {}
_side_seconds: Dict[str, float] = {}  # side -> seconds this process spent digesting
_emitted_epochs: set = set()  # (job, epoch) pairs whose metrics were emitted
_atexit_registered = False
_warned_no_key = False


def _ambient_job() -> Optional[str]:
    """The job of the ambient trace context, read through ``sys.modules``:
    None (no import, no field) in a process that never entered a context
    carrying one."""
    import sys

    trace = sys.modules.get("ray_shuffling_data_loader_tpu_torch.telemetry.trace")
    if trace is None:
        return None
    try:
        job = trace.current_context().get("job")
    except Exception:
        return None
    return None if job is None else str(job)


class AuditError(AssertionError):
    """A reconciliation failed under ``RSDL_AUDIT_STRICT``."""


def enabled() -> bool:
    """Is the audit on in this process? Read from the environment once."""
    global _enabled
    if _enabled is None:
        _enabled = _env.read_flag(ENV_AUDIT)
    return _enabled


def enable(spool_dir: Optional[str] = None) -> None:
    """Arm the audit in this process and, through the environment, in every
    process spawned after this call: call it before ``runtime.init()`` so
    that the pool's workers inherit it. ``spool_dir``: where each process
    drains its records; without one, records stay in this process and a
    reconcile sees only them."""
    global _enabled
    os.environ[ENV_AUDIT] = "1"
    if spool_dir:
        os.makedirs(spool_dir, exist_ok=True)
        os.environ[ENV_AUDIT_DIR] = spool_dir
    _enabled = True
    _register_atexit()


def disable() -> None:
    global _enabled
    os.environ.pop(ENV_AUDIT, None)
    _enabled = False


def refresh_from_env() -> None:
    """Forget the cached state; the next :func:`enabled` reads the
    environment again."""
    global _enabled
    _enabled = None


def spool_dir() -> Optional[str]:
    return os.environ.get(ENV_AUDIT_DIR) or None


def key_column_name() -> str:
    return os.environ.get(ENV_AUDIT_KEY, DEFAULT_KEY_COLUMN)


def _sample_cap() -> int:
    try:
        return int(os.environ.get(ENV_AUDIT_SAMPLE, str(DEFAULT_SAMPLE_KEYS)))
    except ValueError:
        return DEFAULT_SAMPLE_KEYS


def strict() -> bool:
    return _env.read_flag(ENV_AUDIT_STRICT)


# -- the digest math (numpy, uint64 wrapping) ------------------------------------------

_GOLDEN = np.uint64(0x9E3779B97F4A7C15)
_MIX1 = np.uint64(0xBF58476D1CE4E5B9)
_MIX2 = np.uint64(0x94D049BB133111EB)
_U64 = np.uint64(0xFFFFFFFFFFFFFFFF)
# Positions hash in a domain of their own. With row-id keys (key == 0..N-1)
# a shared domain would make a row at its own index contribute mix(0), and
# a crossed swap of two keys the same value twice, cancelling under XOR: a
# sorted stream and its reversal would get the same seq.
_POS_SALT = np.uint64(0xD1B54A32D192ED03)


def _mix(z: np.ndarray) -> np.ndarray:
    """The splitmix64 finalizer."""
    with np.errstate(over="ignore"):
        z = (z ^ (z >> np.uint64(30))) * _MIX1
        z = (z ^ (z >> np.uint64(27))) * _MIX2
        return z ^ (z >> np.uint64(31))


def hash_keys(arr: np.ndarray) -> np.ndarray:
    """Each row's uint64 hash. Integers hash their 64-bit two's-complement
    bits, floats their float64 bits, so a key hashes the same before and
    after an int64 -> int32 narrowing."""
    a = np.asarray(arr)
    if a.dtype.kind == "f":
        bits = np.ascontiguousarray(a, dtype=np.float64).view(np.uint64)
    elif a.dtype.kind in "iub":
        bits = np.ascontiguousarray(a.astype(np.int64, copy=False)).view(np.uint64)
    else:
        raise TypeError(f"unsupported audit key dtype {a.dtype}")
    with np.errstate(over="ignore"):
        return _mix(bits + _GOLDEN)


class StreamDigest:
    """A streaming digest of key batches: ``count``, ``xor`` and ``sum``
    are blind to order and fold associatively, so the map side folded over
    files equals the reduce side folded over reducers exactly when every
    row survived once; ``seq`` mixes each hash with its position in the
    stream, so the same rows in another order give another ``seq``."""

    __slots__ = ("count", "xor", "sum", "seq")

    def __init__(self, count: int = 0, xor: int = 0, sum: int = 0, seq: int = 0):
        self.count = int(count)
        self.xor = int(xor)
        self.sum = int(sum)
        self.seq = int(seq)

    def update(self, keys: np.ndarray, offset: Optional[int] = None) -> None:
        """Fold one batch. ``offset``: the batch's first position in its
        stream (None leaves ``seq`` alone)."""
        h = hash_keys(keys)
        n = len(h)
        if n == 0:
            return
        self.count += n
        self.xor ^= int(np.bitwise_xor.reduce(h))
        with np.errstate(over="ignore"):
            self.sum = int((np.uint64(self.sum) + np.add.reduce(h, dtype=np.uint64)) & _U64)
            if offset is not None:
                pos = np.arange(offset, offset + n, dtype=np.uint64)
                self.seq ^= int(np.bitwise_xor.reduce(_mix(h ^ _mix(pos ^ _POS_SALT))))

    def merge(self, other: "StreamDigest") -> None:
        self.count += other.count
        self.xor ^= other.xor
        self.sum = (self.sum + other.sum) & int(_U64)
        self.seq ^= other.seq

    def coverage(self) -> Tuple[int, int, int]:
        """What is blind to order: equal tuples, the same multiset of rows."""
        return (self.count, self.xor, self.sum)

    def hex(self) -> str:
        return f"{self.xor:016x}:{self.sum:016x}"


# -- the records (the hooks call these with the audit on) ----------------------------------


def _keys_of(columns) -> Optional[np.ndarray]:
    """The key column of a batch, or None (warned once) when the batch has
    none or its dtype does not hash: the batch is then skipped."""
    global _warned_no_key
    name = key_column_name()
    try:
        keys = columns[name]
    except (KeyError, IndexError, TypeError):
        keys = None
    if keys is not None and np.asarray(keys).dtype.kind not in "fiub":
        keys = None
    if keys is None:
        if not _warned_no_key:
            _warned_no_key = True
            logger.warning("audit: key column %r not present (or not a numeric dtype); digests skipped for "
                           "batches without it (set %s)", name, ENV_AUDIT_KEY)
        return None
    return keys


def _append(record: dict) -> None:
    _register_atexit()
    with _lock:
        _records.append(record)


def _digest_record(side: str, epoch: int, columns, offset: Optional[int] = None, **extra: Any) -> Optional[dict]:
    """Fold one batch into one record and append it; None when the batch
    has no usable key."""
    keys = _keys_of(columns)
    if keys is None:
        return None
    t0 = time.perf_counter()
    d = StreamDigest()
    d.update(keys, offset=offset)
    rec: Dict[str, Any] = {"side": side, "epoch": int(epoch), "count": d.count, "xor": d.xor, "sum": d.sum, **extra}
    job = _ambient_job()
    if job is not None:
        rec["job"] = job
    if offset is not None:
        rec["offset"] = int(offset)
        rec["seq"] = d.seq
    _append(rec)
    with _lock:
        _side_seconds[side] = _side_seconds.get(side, 0.0) + time.perf_counter() - t0
    return rec


def record_map(epoch: int, file_index: int, columns, per_reducer=None) -> None:
    """One file's rows, with the rows it sends each reducer (the counts
    the map already has). Never raises into the data path."""
    try:
        extra: Dict[str, Any] = {"file": int(file_index)}
        if per_reducer is not None:
            extra["per_reducer"] = [int(c) for c in per_reducer]
        _digest_record("map", epoch, columns, **extra)
    except Exception:
        logger.warning("audit: map digest failed", exc_info=True)


def record_reduce(epoch: int, reducer: int, columns) -> None:
    """One reducer's permuted output."""
    try:
        _digest_record("reduce", epoch, columns, reducer=int(reducer))
    except Exception:
        logger.warning("audit: reduce digest failed", exc_info=True)


def record_deliver(epoch: int, reducer: int, rank: int, columns, offset: int) -> None:
    """One reducer output (or one piece of a packed one) as handed to the
    consumer; ``offset``: its first row's position in the rank's stream.
    Rank 0's records also carry the first keys of the epoch's stream, up to
    the sample cap per ``(job, epoch)``."""
    try:
        extra: Dict[str, Any] = {"reducer": int(reducer), "rank": int(rank)}
        keys = _keys_of(columns) if rank == 0 else None
        if keys is not None:
            # The sample is attached before the append: a record never
            # changes once a concurrent flush can see it.
            skey = (_ambient_job(), int(epoch))
            with _lock:
                taken = _sample_counts.get(skey, 0)
                want = _sample_cap() - taken
            if want > 0:
                sample = np.asarray(keys)[:want]
                extra["keys"] = [float(k) if isinstance(k, float) else int(k) for k in sample.tolist()]
                with _lock:
                    _sample_counts[skey] = taken + len(sample)
        _digest_record("deliver", epoch, columns, offset=offset, **extra)
    except Exception:
        logger.warning("audit: deliver digest failed", exc_info=True)


def record_consume(epoch: int, rank: int, columns, offset: int) -> None:
    """One queue batch as the trainer-side dataset read it back."""
    try:
        _digest_record("consume", epoch, columns, offset=offset, rank=int(rank))
    except Exception:
        logger.warning("audit: consume digest failed", exc_info=True)


def record_staged(epoch: int, rank: int, columns, offset: int) -> None:
    """One post-re-cut batch as the device dataset stages it. Recorded per
    batch, before the stager takes the next, so every record is in before
    the dataset's last acks let the driver reconcile. With ``drop_last``
    the tail differs from the delivered rows by design: reconcile compares
    the staged side only when the counts match."""
    try:
        _digest_record("staged", epoch, columns, offset=offset, rank=int(rank))
    except Exception:
        logger.warning("audit: staged digest failed", exc_info=True)


# -- the injected fault (tests only) ------------------------------------------------------


def inject_fault(kind: str, epoch: int, count: int = 1) -> None:
    """Arm a fault. ``"drop-row"``: the delivery drops the last row of
    ``count`` reducer outputs of ``epoch``, the defect a reconcile must
    catch."""
    with _lock:
        _faults[(kind, int(epoch))] = count


def take_fault(kind: str, epoch: int) -> bool:
    """Take one armed occurrence; False when none is armed."""
    with _lock:
        left = _faults.get((kind, int(epoch)), 0)
        if left <= 0:
            return False
        _faults[(kind, int(epoch))] = left - 1
        return True


def clear_faults() -> None:
    with _lock:
        _faults.clear()


def digest_seconds() -> Dict[str, float]:
    """Seconds this process spent digesting, per side, since the last
    :func:`reset` (the key column's read and the digest's fold; the
    sides of the pool's workers are counted in the workers)."""
    with _lock:
        return dict(_side_seconds)


# -- the spool and the run boundary ------------------------------------------------------


def _register_atexit() -> None:
    global _atexit_registered
    if not _atexit_registered:
        _atexit_registered = True
        atexit.register(flush)


def flush() -> None:
    """Drain this process's records to its spool file; nothing without a
    spool directory (the records then stay for a reconcile here)."""
    directory = spool_dir()
    if not directory:
        return
    with _lock:
        if not _records:
            return
        drained = list(_records)
        _records.clear()
    try:
        os.makedirs(directory, exist_ok=True)
        with open(os.path.join(directory, f"audit-{os.getpid()}.jsonl"), "a") as f:
            for rec in drained:
                f.write(json.dumps(rec) + "\n")
    except OSError:
        pass  # the audit never sinks the run; these records are lost


def safe_flush() -> None:
    """:func:`flush` for the task-done barrier: nothing with the audit off,
    and never raises."""
    if not enabled():
        return
    try:
        flush()
    except Exception:
        pass


def reset(clear_spool: bool = False) -> None:
    """Drop the buffered records, verdicts and sample counts; armed faults
    stay (:func:`clear_faults`). ``clear_spool``: also unlink every spool
    file."""
    with _lock:
        _records.clear()
        _verdicts.clear()
        _sample_counts.clear()
        _side_seconds.clear()
        _emitted_epochs.clear()
    if clear_spool:
        directory = spool_dir()
        if directory and os.path.isdir(directory):
            for fname in os.listdir(directory):
                if fname.startswith("audit-") and fname.endswith(".jsonl"):
                    try:
                        os.unlink(os.path.join(directory, fname))
                    except OSError:
                        pass


def begin_run(carry: bool = False, job: Optional[str] = None) -> None:
    """The start of one audited shuffle run (``shuffle()`` calls it): the
    records of earlier runs go, local and spooled, or they would fold into
    this run's digests. One audited run per spool directory at a time.

    ``carry`` (a journal resume): the spool stays, as the preempted run's
    records are the first half of this run's digests; the local state
    resets. ``job`` (a job of the multi-job service): a concurrent tenant's
    records share the buffer and the spool, so only this job's local state
    resets (its records carry its id, and its reconcile folds only them);
    but when the job is the session's only live one, the earlier jobs'
    records are dead, and the full reset runs, so that a service running
    its tenants one after another keeps a bounded spool."""
    if job is not None:
        if not carry:
            try:
                from ray_shuffling_data_loader_tpu_torch.runtime import service

                # <= 1: the job itself registered before its run began.
                if service.live_jobs_count() <= 1:
                    reset(clear_spool=True)
                    return
            except Exception:
                pass  # sole tenancy not proven: keep every record
        with _lock:
            _emitted_epochs.difference_update({k for k in _emitted_epochs if k[0] == job})
            for k in [k for k in _sample_counts if k[0] == job]:
                del _sample_counts[k]
        return
    reset(clear_spool=not carry)


def seed_sample_count(epoch: int, taken: int) -> None:
    """A resume's carry of the rank-0 sample: the journaled run already took
    ``taken`` keys of ``epoch`` (in its spooled records), so this process's
    cap starts there and the sample stays one capped prefix."""
    skey = (_ambient_job(), int(epoch))
    with _lock:
        _sample_counts[skey] = max(_sample_counts.get(skey, 0), int(taken))


def sample_count(epoch: int) -> int:
    """Sample keys taken so far of ``epoch`` (the journal's ``sampled``)."""
    with _lock:
        return _sample_counts.get((_ambient_job(), int(epoch)), 0)


def _load_records() -> List[dict]:
    """This process's buffer and every spool file's records."""
    with _lock:
        out = list(_records)
    directory = spool_dir()
    if directory and os.path.isdir(directory):
        for fname in sorted(os.listdir(directory)):
            if not (fname.startswith("audit-") and fname.endswith(".jsonl")):
                continue
            try:
                with open(os.path.join(directory, fname)) as f:
                    for line in f:
                        line = line.strip()
                        if not line:
                            continue
                        try:
                            out.append(json.loads(line))
                        except ValueError:
                            continue  # a torn concurrent append
            except OSError:
                continue
    return out


# -- reconciliation -------------------------------------------------------------------------

# One record per unit of work and side: a stage that ran twice (a retry, a
# resume's re-execution) may have spooled its record twice, and folding
# both would report a false mismatch on a run that delivered every row once.
_DEDUP_KEYS = {
    "map": ("file",),
    "reduce": ("reducer",),
    "deliver": ("rank", "reducer", "offset"),
    "consume": ("rank", "offset"),
    "staged": ("rank", "offset"),
}


def _dedup(side: str, recs: Sequence[dict]) -> List[dict]:
    fields = _DEDUP_KEYS[side]
    seen: Dict[tuple, dict] = {}
    for r in recs:
        seen.setdefault(tuple(r.get(f) for f in fields), r)
    return list(seen.values())


def _fold(recs: Sequence[dict]) -> StreamDigest:
    d = StreamDigest()
    for r in recs:
        d.merge(StreamDigest(r.get("count", 0), r.get("xor", 0), r.get("sum", 0), r.get("seq", 0)))
    return d


def _rank_mixed_seq(recs: Sequence[dict]) -> int:
    """The records' seq digests folded across ranks: each is mixed with its
    rank first, so that two ranks' streams cannot cancel."""
    out = np.uint64(0)
    for r in recs:
        with np.errstate(over="ignore"):
            out ^= _mix(np.uint64(r.get("seq", 0)) ^ _mix(np.uint64(r.get("rank", 0)) + _GOLDEN))
    return int(out)


def _adjacent_pairs(seq: Sequence) -> set:
    return {(seq[i], seq[i + 1]) for i in range(len(seq) - 1)}


def _quality(cur_sample: List, prev_sample: Optional[List]) -> Dict[str, Optional[float]]:
    out: Dict[str, Optional[float]] = {"adjacent_pair_retention": None, "mean_normalized_displacement": None}
    if prev_sample and len(cur_sample) > 1 and len(prev_sample) > 1:
        cur_pairs = _adjacent_pairs(cur_sample)
        out["adjacent_pair_retention"] = len(cur_pairs & _adjacent_pairs(prev_sample)) / max(1, len(cur_pairs))
        pos_prev = {k: i for i, k in enumerate(prev_sample)}
        disp = [abs(i - pos_prev[k]) for i, k in enumerate(cur_sample) if k in pos_prev]
        if disp:
            out["mean_normalized_displacement"] = float(np.mean(disp) / max(1, len(prev_sample)))
    return out


def _entropy(map_recs: Sequence[dict]) -> Dict[str, Optional[float]]:
    """Each reducer's entropy over its source files, over log(F): 1.0, every
    reducer draws evenly from every file; 0.0, a reducer fed by one file."""
    rows = [r["per_reducer"] for r in map_recs if r.get("per_reducer")]
    if not rows or len({len(r) for r in rows}) != 1:
        return {"source_entropy_mean": None, "source_entropy_min": None}
    mat = np.asarray(rows, dtype=np.float64)  # files x reducers
    num_files = mat.shape[0]
    if num_files < 2:
        return {"source_entropy_mean": 1.0, "source_entropy_min": 1.0}
    totals = mat.sum(axis=0)
    ents = []
    for r in range(mat.shape[1]):
        if totals[r] <= 0:
            continue
        p = mat[:, r] / totals[r]
        p = p[p > 0]
        ents.append(float(-(p * np.log(p)).sum() / math.log(num_files)))
    if not ents:
        return {"source_entropy_mean": None, "source_entropy_min": None}
    return {"source_entropy_mean": float(np.mean(ents)), "source_entropy_min": float(np.min(ents))}


def _emit_metrics(verdict: dict) -> None:
    """Fold one epoch's verdict into the ``audit.*`` series, once per
    ``(job, epoch)`` and only with metrics on. A job label rides only
    job-scoped runs; the quality gauges carry the run's plan."""
    from ray_shuffling_data_loader_tpu_torch.telemetry import metrics

    if not metrics.enabled():
        return
    epoch = verdict["epoch"]
    job = verdict.get("job")
    with _lock:
        if (job, epoch) in _emitted_epochs:
            return
        _emitted_epochs.add((job, epoch))
    jl: Dict[str, Any] = {"job": job} if job is not None else {}
    reg = metrics.registry
    reg.counter("audit.rows_mapped", **jl).inc(verdict["rows_mapped"])
    reg.counter("audit.rows_reduced", **jl).inc(verdict["rows_reduced"])
    reg.counter("audit.rows_delivered", **jl).inc(verdict["rows_delivered"])
    mism = reg.counter("audit.digest_mismatch", **jl)  # 0.0 on a clean run, not a missing key
    if verdict["ok"] is False:
        mism.inc()
    reg.gauge("audit.epoch_ok", epoch=epoch, **jl).set(1.0 if verdict["ok"] else 0.0)
    plan = verdict.get("plan") or "unknown"
    for name in ("adjacent_pair_retention", "mean_normalized_displacement", "source_entropy_mean",
                 "source_entropy_min"):
        value = verdict.get(name)
        if value is not None:
            reg.gauge(f"audit.{name}", epoch=epoch, plan=plan, **jl).set(value)


def reconcile(
    epochs: Optional[Sequence[int]] = None,
    stats_collector=None,
    plan_label: Optional[str] = None,
    job=None,
) -> List[dict]:
    """Fold every visible record into one verdict per epoch: map == reduce
    == delivered coverage, and consumed == delivered when every delivering
    rank also reported its consumption, and staged == delivered where the
    counts match; with the quality figures. Each verdict goes to
    ``stats_collector`` (``audit_epoch``); a mismatch is logged, and under
    ``RSDL_AUDIT_STRICT`` raises :class:`AuditError` naming the epochs.

    ``plan_label``: the run's resolved plan (``rowwise`` or ``block:G``),
    which the verdicts carry; None reads this process's environment
    (``unknown`` when that fails). ``job``: fold only one job's records; a
    sequence is one job's resume chain, and the verdicts carry its last
    id. None folds every record."""
    if plan_label is None:
        try:
            from ray_shuffling_data_loader_tpu_torch.shuffle import shuffle_plan_label

            plan_label = shuffle_plan_label()
        except Exception:
            plan_label = "unknown"
    flush()  # this process's records join the spool's
    recs = _load_records()
    if job is not None:
        if isinstance(job, str):
            wanted = {job}
        else:
            chain = [str(j) for j in job]
            wanted = set(chain)
            job = chain[-1]
        recs = [r for r in recs if r.get("job") in wanted]
    by_epoch: Dict[int, List[dict]] = {}
    for r in recs:
        by_epoch.setdefault(int(r.get("epoch", -1)), []).append(r)
    epoch_list = sorted(e for e in by_epoch if e >= 0) if epochs is None else sorted(set(int(e) for e in epochs))
    verdicts: List[dict] = []
    prev_sample: Optional[List] = None
    for epoch in epoch_list:
        erecs = by_epoch.get(epoch, [])
        sides = {
            side: _dedup(side, [r for r in erecs if r.get("side") == side])
            for side in ("map", "reduce", "deliver", "consume", "staged")
        }
        mapped, reduced, delivered = _fold(sides["map"]), _fold(sides["reduce"]), _fold(sides["deliver"])
        consumed, staged = _fold(sides["consume"]), _fold(sides["staged"])
        if not sides["map"] and not sides["reduce"]:
            # No worker-side record: nothing was audited, or the workers'
            # spool is not visible here. An incomplete audit, not a defect.
            incomplete: Dict[str, Any] = {"epoch": epoch, "ok": None}
            if not sides["deliver"]:
                incomplete.update(detail="no records", rows_mapped=0, rows_reduced=0, rows_delivered=0)
            else:
                incomplete.update(
                    detail="map/reduce records missing (is RSDL_AUDIT_DIR on a filesystem shared with the workers?)",
                    rows_mapped=0, rows_reduced=0, rows_delivered=delivered.count,
                )
            if job is not None:
                incomplete["job"] = job
            verdicts.append(incomplete)
            prev_sample = None
            continue
        mismatch: List[str] = []
        if reduced.coverage() != mapped.coverage():
            mismatch.append("reduce")
        if delivered.coverage() != reduced.coverage():
            mismatch.append("delivered")
        deliver_ranks = {r.get("rank") for r in sides["deliver"]}
        consume_ranks = {r.get("rank") for r in sides["consume"]}
        if sides["consume"] and consume_ranks >= deliver_ranks and consumed.coverage() != delivered.coverage():
            mismatch.append("consumed")
        if sides["staged"] and staged.count == delivered.count and staged.coverage() != delivered.coverage():
            mismatch.append("staged")
        sample: List = []
        for r in sorted(sides["deliver"], key=lambda r: (r.get("rank", 0), r.get("offset", 0))):
            if r.get("rank") == 0 and "keys" in r:
                sample.extend(r["keys"])
        verdict: Dict[str, Any] = {
            "epoch": epoch,
            "ok": not mismatch,
            "mismatch": mismatch,
            "rows_mapped": mapped.count,
            "rows_reduced": reduced.count,
            "rows_delivered": delivered.count,
            "rows_consumed": consumed.count if sides["consume"] else None,
            "rows_staged": staged.count if sides["staged"] else None,
            "map_digest": mapped.hex(),
            "reduce_digest": reduced.hex(),
            "delivered_digest": delivered.hex(),
            "delivered_seq": f"{_rank_mixed_seq(sides['deliver']):016x}",
            "consumed_digest": consumed.hex() if sides["consume"] else None,
            "plan": plan_label,
        }
        if job is not None:
            verdict["job"] = job
        verdict.update(_quality(sample, prev_sample))
        verdict.update(_entropy(sides["map"]))
        prev_sample = sample or None
        verdicts.append(verdict)
        _emit_metrics(verdict)
        if stats_collector is not None:
            try:
                stats_collector.call_oneway("audit_epoch", epoch, verdict)
            except Exception:
                pass
        if mismatch:
            logger.error(
                "audit: epoch %d digest mismatch at %s — mapped=%d reduced=%d delivered=%d (%s / %s / %s)",
                epoch, ",".join(mismatch), mapped.count, reduced.count, delivered.count,
                mapped.hex(), reduced.hex(), delivered.hex(),
            )
    with _lock:
        if job is None:
            _verdicts[:] = verdicts
        else:
            _verdicts[:] = [v for v in _verdicts if v.get("job") != job] + verdicts
    bad = [v["epoch"] for v in verdicts if v["ok"] is False]
    if bad and strict():
        raise AuditError(f"audit digest mismatch in epoch(s) {bad}; see verdicts")
    return verdicts


def verdicts() -> List[dict]:
    """The last reconcile's verdicts (copies)."""
    with _lock:
        return [dict(v) for v in _verdicts]


def summary(reconcile_if_needed: bool = True) -> dict:
    """The run's audit in one dict: ``ok``, the mismatched epochs, and the
    verdicts. ``ok`` is None unless some epoch reconciled: a run whose
    every verdict is ``ok: None`` (no key column, a spool the workers did
    not share) was not verified."""
    out = verdicts()
    if not out and reconcile_if_needed:
        try:
            out = reconcile()
        except AuditError:
            out = verdicts()
        except Exception:
            out = []
    audited = [v for v in out if v.get("ok") is not None]
    return {
        "ok": all(v["ok"] for v in audited) if audited else None,
        "mismatch_epochs": [v["epoch"] for v in out if v.get("ok") is False],
        "epochs": out,
    }
