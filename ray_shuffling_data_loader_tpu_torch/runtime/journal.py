"""The shuffle driver's write-ahead journal: its epoch window made
durable, so that a preempted driver resumes where it stopped.

* **Journal** (``RSDL_JOURNAL=<dir>``): one append-only NDJSON file per
  run. The run-identity header is written under a hidden ``.tmp`` name,
  fsynced and renamed, so a reader never sees half an identity; records
  are appended with flush and fsync at the shuffle's barriers: an epoch
  admitted (``epoch``), a map's or a reduce's result observed by the
  driver (``map``, ``reduce``), a reducer's output handed to the consumer
  (``deliver``, the delivery cursor), an epoch fully delivered
  (``epoch-done``), and the run's end (``suspended``, ``done``).

* **Resume** (``shuffle(resume_from=)`` or ``RSDL_RESUME``): a fresh
  session folds the journal (:func:`load_run`). Completed epochs are
  skipped whole; a journaled stage result whose segments survive
  (``store.exists``) is re-attached, else the stage runs again from the
  seed, with the same result; the delivery cursor skips reducers the
  consumer already had (``cursor`` mode). ``redeliver`` mode keeps the
  re-attach but forgets every delivery, for a consumer that restarted
  and needs the run's whole stream again to skip into: a trainer resuming
  from its checkpoint, whose queue ran ahead of it. Unlike the JAX
  package, which keeps skipping the epochs it journaled as delivered,
  this mode also delivers those again: their batches may have sat
  untrained in the dead consumer's queue.

* **Suspend** (SIGTERM): with the journal armed, ``shuffle()`` on the
  main thread installs a handler that takes the signal as a preemption
  notice: stop admitting epochs, finish the reducer being delivered,
  journal what is still running and the suspension, and exit 0 with the
  store's segments left for the resume. :func:`request_suspend` does the
  same from code and makes ``shuffle()`` raise :class:`RunSuspended`.

With ``RSDL_JOURNAL`` unset and no ``resume_from``, ``shuffle()`` never
imports this module, writes no file and installs no handler.

* **Audit** (``RSDL_AUDIT``, :mod:`..telemetry.audit`): a ``deliver``
  record carries the rows the audit digested for its rank and the rank-0
  sample keys taken so far (``rows``, ``sampled``), written after the
  delivery's digests reached the spool; a resume seeds the audit's stream
  offsets and sample count from them, and keeps the spool, so that its
  digests continue the preempted run's. At the run's end one ``verdict``
  record per epoch holds the reconcile's verdict, which ``replay`` holds
  a re-run of the epoch to.

The format is the JAX package's (its ``runtime/journal.py``), so that
either package folds the other's journal.

This module imports the standard library only.
"""

from __future__ import annotations

import json
import logging
import os
import secrets
import signal
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)

ENV_JOURNAL = "RSDL_JOURNAL"
ENV_RESUME = "RSDL_RESUME"
ENV_SYNC = "RSDL_JOURNAL_SYNC"

_FORMAT_V = 1

# Identity keys that say where the run happened, not what it delivers: a
# resumed run differs in all of them, so validation skips them. They stay
# recorded: re-attach needs the old session.
_INFORMATIONAL = {"run_id", "ts", "session", "runtime_dir", "shm_dir", "faults", "faults_seed", "audit_jobs"}


class RunSuspended(RuntimeError):
    """``shuffle()`` journaled its window and stopped instead of
    finishing (:func:`request_suspend`); the SIGTERM path exits 0 after
    the same steps."""

    def __init__(self, journal_path: str):
        super().__init__(f"run suspended; epoch window journaled at {journal_path} (resume with RSDL_RESUME=auto)")
        self.journal_path = journal_path


def journal_dir() -> Optional[str]:
    """The journal directory (``RSDL_JOURNAL``), or None when off."""
    return os.environ.get(ENV_JOURNAL) or None


def enabled() -> bool:
    return journal_dir() is not None


def _sync_enabled() -> bool:
    """fsync after every append (the default); ``RSDL_JOURNAL_SYNC=off``
    keeps only the flush."""
    return os.environ.get(ENV_SYNC, "").strip().lower() not in ("off", "0", "false")


# -- refs <-> JSON -------------------------------------------------------------


def ref_to_json(ref) -> dict:
    out: Dict[str, Any] = {"id": ref.object_id, "nbytes": int(ref.nbytes), "session": ref.session}
    if ref.owner is not None:
        out["owner"] = list(ref.owner)
    if ref.rows is not None:
        out["rows"] = [int(ref.rows[0]), int(ref.rows[1])]
    return out


def ref_from_json(d: dict):
    from ray_shuffling_data_loader_tpu_torch.runtime.store import ObjectRef

    return ObjectRef(
        object_id=str(d["id"]),
        nbytes=int(d.get("nbytes", 0)),
        session=str(d.get("session", "")),
        owner=tuple(d["owner"]) if d.get("owner") else None,
        rows=tuple(d["rows"]) if d.get("rows") else None,
    )


# -- run identity ----------------------------------------------------------------


def run_identity(
    filenames: List[str],
    num_epochs: int,
    num_reducers: int,
    num_trainers: int,
    seed: int,
    start_epoch: int,
    narrow_to_32: bool,
    plan: str,
    columns: Optional[List[str]],
    device_layout: Optional[dict],
    job: Optional[str] = None,
) -> dict:
    """What determines the delivered stream (validated on resume: a
    mismatch refuses, like ``BatchCursor.validate``), plus where the run
    happened (informational, for re-attach). ``job``: the multi-job
    service's job name (stable across restarts, unlike its id), validated:
    two same-shaped jobs in one journal directory each find their own
    run."""
    from ray_shuffling_data_loader_tpu_torch import runtime

    def _abs(f: str) -> str:
        return f if "://" in f else os.path.abspath(f)

    identity: Dict[str, Any] = {
        "v": _FORMAT_V,
        "seed": int(seed),
        "num_epochs": int(num_epochs),
        "num_reducers": int(num_reducers),
        "num_trainers": int(num_trainers),
        "start_epoch": int(start_epoch),
        "filenames": [_abs(f) for f in filenames],
        "narrow_to_32": bool(narrow_to_32),
        "plan": str(plan),
        "columns": list(columns) if columns is not None else None,
        "device_batch": int(device_layout["batch"]) if device_layout else None,
        "device_columns": [str(c) for c in device_layout["columns"]] if device_layout else None,
        "faults": os.environ.get("RSDL_FAULTS") or None,
        "faults_seed": os.environ.get("RSDL_FAULTS_SEED") or None,
    }
    if job is not None:
        identity["job"] = str(job)
    if runtime.is_initialized():
        ctx = runtime.get_context()
        identity["session"] = ctx.session
        identity["runtime_dir"] = ctx.runtime_dir
        identity["shm_dir"] = ctx.store.shm_dir
    return identity


def validate_identity(recorded: dict, current: dict) -> None:
    """Refuse a resume that would change the batch stream: every key but
    the informational ones must match."""
    keys = (set(recorded) | set(current)) - _INFORMATIONAL
    diff = {k: (recorded.get(k), current.get(k)) for k in sorted(keys) if recorded.get(k) != current.get(k)}
    if diff:
        raise ValueError(f"journal run identity does not match this shuffle call; resuming would change the batch stream: {diff}")


# -- the fold of one journal ------------------------------------------------------


class EpochState:
    """One epoch's journaled progress."""

    __slots__ = ("epoch", "schedule", "maps", "reduces", "delivered", "rank_rows", "sampled", "done")

    def __init__(self, epoch: int):
        self.epoch = int(epoch)
        self.schedule: Optional[str] = None
        # file index -> {"refs": [refdict] | None, "counts": [int] | None, "cache_ref": refdict | None}
        self.maps: Dict[int, dict] = {}
        # reducer -> its output refs (one columnar, or a packed head, body and tail)
        self.reduces: Dict[int, List[dict]] = {}
        self.delivered = 0  # the delivery cursor: reducers 0 .. delivered-1
        self.rank_rows: Dict[int, int] = {}  # rank -> rows delivered
        self.sampled = 0
        self.done = False


class RunState:
    """A journal folded: the identity and each epoch's progress."""

    def __init__(self, path: str, run_id: str, identity: dict):
        self.path = path
        self.run_id = run_id
        self.identity = identity
        self.epochs: Dict[int, EpochState] = {}
        self.done = False
        self.suspended = False
        self.superseded = False
        self.verdicts: Dict[int, dict] = {}

    def epoch(self, e: int) -> EpochState:
        return self.epochs.setdefault(int(e), EpochState(e))

    def resumable(self) -> bool:
        return not self.done and not self.superseded

    def apply(self, rec: dict) -> None:
        kind = rec.get("kind")
        if kind == "epoch":
            st = self.epoch(rec["epoch"])
            st.schedule = rec.get("schedule") or st.schedule
        elif kind == "map":
            self.epoch(rec["epoch"]).maps[int(rec["file"])] = {
                "refs": rec.get("refs"), "counts": rec.get("counts"), "cache_ref": rec.get("cache_ref"),
            }
        elif kind == "reduce":
            self.epoch(rec["epoch"]).reduces[int(rec["reducer"])] = list(rec.get("refs") or [])
        elif kind == "deliver":
            st = self.epoch(rec["epoch"])
            st.delivered = max(st.delivered, int(rec["reducer"]) + 1)  # delivery is reducer-ordered
            rank = int(rec.get("rank", 0))
            st.rank_rows[rank] = st.rank_rows.get(rank, 0) + int(rec.get("rows", 0))
            st.sampled = max(st.sampled, int(rec.get("sampled", 0)))
        elif kind == "epoch-done":
            self.epoch(rec["epoch"]).done = True
        elif kind == "verdict":
            self.verdicts[int(rec["epoch"])] = {k: v for k, v in rec.items() if k != "kind"}
        elif kind == "suspended":
            self.suspended = True
        elif kind == "done":
            self.done = True
        elif kind == "superseded":
            self.superseded = True

    def iter_records(self, carry_cursors: bool = True):
        """This state as journal records: what a resumed run writes first,
        so that its own journal resumes alone after a second preemption.
        ``carry_cursors=False`` (``redeliver``) leaves out the delivery
        cursors and the delivered epochs."""
        for e in sorted(self.epochs):
            st = self.epochs[e]
            if st.schedule is not None:
                yield {"kind": "epoch", "epoch": e, "schedule": st.schedule}
            for i in sorted(st.maps):
                m = st.maps[i]
                rec = {"kind": "map", "epoch": e, "file": i, "carried": 1}
                for key in ("refs", "counts", "cache_ref"):
                    if m.get(key) is not None:
                        rec[key] = m[key]
                yield rec
            for r in sorted(st.reduces):
                yield {"kind": "reduce", "epoch": e, "reducer": r, "refs": st.reduces[r], "carried": 1}
            if carry_cursors and st.delivered > 0:
                # One record per rank keeps the cursor and the rows.
                for rank, rows in sorted((dict(st.rank_rows) or {0: 0}).items()):
                    yield {"kind": "deliver", "epoch": e, "reducer": st.delivered - 1, "rank": rank,
                           "rows": int(rows), "sampled": st.sampled, "carried": 1}
            if carry_cursors and st.done:
                yield {"kind": "epoch-done", "epoch": e, "carried": 1}
        for e in sorted(self.verdicts):
            yield {"kind": "verdict", "carried": 1, **self.verdicts[e]}


def load_run(path: str) -> RunState:
    """Fold one journal. Its first record must be the identity header; a
    torn last line (a crash mid-append) is skipped."""
    state: Optional[RunState] = None
    with open(path) as f:
        for line in f:
            if not line.endswith("\n"):
                break
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if not isinstance(rec, dict):
                continue
            if state is None:
                if rec.get("kind") != "run":
                    raise ValueError(f"{path!r} is not a run journal (no identity header)")
                state = RunState(path, str(rec.get("run_id", "?")), dict(rec.get("identity") or {}))
                continue
            state.apply(rec)
    if state is None:
        raise ValueError(f"{path!r} is empty or torn before its header")
    return state


def _run_files(directory: str) -> List[str]:
    """The journals in ``directory``, newest first."""
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    out = [os.path.join(directory, n) for n in names if n.startswith("run-") and n.endswith(".ndjson")]

    def _mtime(p: str) -> float:
        try:
            return os.path.getmtime(p)
        except OSError:
            return 0.0

    out.sort(key=_mtime, reverse=True)
    return out


def find_resumable(directory: str, identity: dict) -> Optional[RunState]:
    """The newest run in ``directory`` that is neither done nor superseded
    and whose identity matches; others are skipped silently."""
    for path in _run_files(directory):
        try:
            state = load_run(path)
        except (OSError, ValueError):
            continue
        if not state.resumable():
            continue
        try:
            validate_identity(state.identity, identity)
        except ValueError:
            continue
        return state
    return None


def resolve_resume(resume_from: Optional[str], identity: dict) -> Tuple[Optional[RunState], str]:
    """``(state, mode)`` for one shuffle call. ``resume_from`` (a journal
    file or directory, ``"auto"`` or ``"redeliver"``) wins over
    ``RSDL_RESUME``. Discovery that finds nothing starts fresh; an
    explicit path whose identity does not match, or whose run is
    complete, raises. Modes: ``cursor`` and ``redeliver`` (module
    docstring)."""
    spec = str(resume_from if resume_from is not None else (os.environ.get(ENV_RESUME) or "")).strip()
    if not spec or spec.lower() in ("0", "off", "false"):
        return None, "cursor"
    low = spec.lower()
    if low in ("auto", "1", "on", "true", "cursor", "redeliver"):
        mode = "redeliver" if low == "redeliver" else "cursor"
        directory = journal_dir()
        if not directory or not os.path.isdir(directory):
            return None, mode
        state = find_resumable(directory, identity)
        if state is not None and mode == "redeliver":
            _zero_cursors(state)
        return state, mode
    path = spec
    if os.path.isdir(path):
        files = _run_files(path)
        if not files:
            raise ValueError(f"no run journals under {path!r}")
        path = files[0]
    state = load_run(path)
    validate_identity(state.identity, identity)
    if not state.resumable():
        raise ValueError(f"journal {path!r} records a completed (or superseded) run; nothing to resume")
    return state, "cursor"


def _zero_cursors(state: RunState) -> None:
    for st in state.epochs.values():
        st.delivered = 0
        st.rank_rows = {}
        st.sampled = 0
        st.done = False


# -- the writer ----------------------------------------------------------------------


class RunJournal:
    """The appender of one run's journal (thread-safe)."""

    def __init__(self, path: str, run_id: str):
        self.path = path
        self.run_id = run_id
        self._lock = threading.Lock()
        self._f = open(path, "a")
        self._sync = _sync_enabled()
        self._closed = False
        self.resume_pending = False  # a resume that has not delivered yet

    def append(self, kind: str, **fields: Any) -> None:
        rec = {"kind": kind, "ts": time.time(), **fields}
        try:
            with self._lock:
                if self._closed:
                    return
                self._f.write(json.dumps(rec) + "\n")
                self._f.flush()
                if self._sync:
                    os.fsync(self._f.fileno())
        except OSError:
            # A failed append only widens what a resume runs again.
            logger.warning("journal append failed", exc_info=True)

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            try:
                self._f.flush()
                if self._sync:
                    os.fsync(self._f.fileno())
            except OSError:
                pass
            self._f.close()


_current_lock = threading.Lock()
_current: Optional[RunJournal] = None


def current() -> Optional[RunJournal]:
    return _current


def current_run_id() -> Optional[str]:
    j = _current
    return j.run_id if j is not None else None


def begin_run(identity: dict, resume: Optional[RunState] = None, mode: str = "cursor") -> RunJournal:
    """Publish this run's journal atomically and make it current. With
    ``resume``, the predecessor's fold is carried in first and the
    predecessor is marked superseded, so that discovery finds this run."""
    global _current
    directory = journal_dir() or (os.path.dirname(resume.path) if resume is not None else None)
    if not directory:
        raise ValueError("RSDL_JOURNAL is not set")
    os.makedirs(directory, exist_ok=True)
    run_id = f"{int(time.time() * 1000):013d}-{os.getpid()}-{secrets.token_hex(3)}"
    path = os.path.join(directory, f"run-{run_id}.ndjson")
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(json.dumps({"kind": "run", "run_id": run_id, "ts": time.time(), "identity": identity}) + "\n")
        f.flush()
        os.fsync(f.fileno())
    os.rename(tmp, path)
    journal = RunJournal(path, run_id)
    if resume is not None:
        journal.append("resumed", from_run=resume.run_id)
        for rec in resume.iter_records(carry_cursors=(mode == "cursor")):
            journal.append(rec.pop("kind"), **rec)
        try:
            with open(resume.path, "a") as f:
                f.write(json.dumps({"kind": "superseded", "by": run_id, "ts": time.time()}) + "\n")
                f.flush()
                os.fsync(f.fileno())
        except OSError:
            logger.warning("could not mark %s superseded", resume.path, exc_info=True)
    with _current_lock:
        _current = journal
    return journal


def end_run(journal: RunJournal, status: str = "done") -> None:
    """Close a run; ``done`` also marks it complete (never resumed)."""
    global _current
    if status == "done":
        journal.append("done")
    journal.close()
    with _current_lock:
        if _current is journal:
            _current = None


# -- SIGTERM: suspend --------------------------------------------------------------

_suspend_event = threading.Event()
_suspend_exit = threading.Event()
_handler_installed = False
_prev_handler: Any = None


def install_sigterm_handler() -> None:
    """Install the preemption-notice handler, once. Only the main thread
    can (``signal.signal`` raises elsewhere, e.g. on the shuffle thread of
    a ``ShufflingDataset``); :func:`request_suspend` works anywhere."""
    global _handler_installed, _prev_handler
    if _handler_installed:
        return
    try:
        _prev_handler = signal.signal(signal.SIGTERM, _on_sigterm)
        _handler_installed = True
    except ValueError:
        logger.info("journal: not on the main thread; no SIGTERM suspend handler")


def _on_sigterm(signum, frame) -> None:
    if _current is not None:
        request_suspend(exit_process=True)  # the shuffle's loops act on it
        return
    prev = _prev_handler
    if callable(prev):
        prev(signum, frame)
    elif prev == signal.SIG_DFL:
        signal.signal(signal.SIGTERM, signal.SIG_DFL)
        os.kill(os.getpid(), signal.SIGTERM)


def request_suspend(exit_process: bool = False) -> None:
    """Ask the run in flight to suspend at its next barrier: it then
    exits 0 (``exit_process``, the SIGTERM path) or raises
    :class:`RunSuspended`."""
    if exit_process:
        _suspend_exit.set()
    _suspend_event.set()


def suspend_requested() -> bool:
    return _suspend_event.is_set()


def suspend_should_exit() -> bool:
    return _suspend_exit.is_set()


def clear_suspend() -> None:
    _suspend_event.clear()
    _suspend_exit.clear()


def suspend_and_exit(journal: RunJournal) -> None:
    """The end of the SIGTERM path: close the journal, drain the loaded
    telemetry spools (``os._exit`` runs no atexit hook), and leave
    with exit code 0 without tearing down, since the store's segments are
    the suspended window."""
    journal.close()
    for name in ("audit", "trace", "export", "events", "capacity", "stragglers"):
        mod = sys.modules.get(f"ray_shuffling_data_loader_tpu_torch.telemetry.{name}")
        if mod is not None:
            try:
                mod.safe_flush()
            except Exception:
                pass
    os._exit(0)


def set_resume_in_progress(active: bool) -> None:
    """The ``recovery.resume_in_progress`` gauge: 1 from a resume's start
    until the resumed run delivers its first reducer. A cached boolean
    while metrics are off; never raises."""
    try:
        from ray_shuffling_data_loader_tpu_torch.telemetry import metrics

        if metrics.enabled():
            metrics.registry.gauge("recovery.resume_in_progress").set(1.0 if active else 0.0)
    except Exception:
        pass
