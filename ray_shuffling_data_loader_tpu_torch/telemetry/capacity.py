"""The store's capacity ledger: who holds the bytes, per epoch and tier.

The store's own count (``store_stats``) says how many bytes it holds,
not whose they are: which epoch's segments are still resident, how old
they are, and on which tier. This ledger says that:

* **Records.** The store's segment lifecycle (``runtime/store.py``: a
  publish through ``seal`` or ``publish_slices``, a foreign window
  fetched into a cache segment, ``free``, ``drop_cache``, ``cleanup``
  and a read's ``touch``) appends flat ops, ``{"op": "create" | "fetch"
  | "delete" | "transition" | "cleanup" | "touch", "id", "ids",
  "nbytes", "tier", "epoch", "ts"}``, buffered in the process and
  flushed at the task-done barrier (``runtime/tasks.py``) into
  ``<metrics spool>/capacity/ledger-<pid>.ndjson``. A create takes its
  epoch from the ambient trace context; a delete carries only the id,
  and the fold resolves its bytes, tier and epoch from the create, so a
  process that frees another's segment need not know what it freed.
  The hardlinked window refs of ``publish_slices`` record one segment
  with every link id: its bytes stay resident until the last link
  goes, as the file system's own count does.
* **Fold.** :func:`ledger` replays the records in time order into a
  per-``(epoch, tier)`` view: resident bytes and segments now, bytes
  created, fetched and freed, each epoch's **high watermark** and the
  oldest live segment's age. ``transition`` moves a live segment
  between tiers (the store's tier moves emit it).
* **Host sampling.** :func:`host_sample`: this process's RSS and the
  shm and spill file systems' free bytes (``/proc`` and ``statvfs``).
* **Surfacing.** :func:`view` adds the host sample and ``shm_used_frac``
  (what the re-planner reads); :func:`publish_metrics` refreshes the
  ``capacity.*`` gauges on the time series' tick; :func:`status_section`
  is the trimmed view.

Tiers: ``shm``, ``spill``, and ``cache``: the shared decode cache's
segments, which live on shm but account apart.

The store hooks gate on ``RSDL_METRICS`` (one cached boolean) before
they import this module, so a run with metrics off never loads it and
writes no ledger. Records, fold and gauges are the JAX package's,
letter for letter. Standard library only.
"""

from __future__ import annotations

import atexit
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

# No telemetry import at module level: the fold stands alone, and the
# spool and gauge halves import export and metrics where they need them.

# "cache" is a logical tier: the shared decode cache's segments live on
# shm but account apart, so that a view tells the dataset's cache from
# epoch state (and the cache can be shed first: Parquet re-makes it).
TIERS = ("shm", "spill", "cache")

# The ops. "transition" is a tier move's; "touch" stamps a segment's
# last read (the store's ``get_columns``), the signal that orders cold
# segments.
OPS = ("create", "fetch", "delete", "transition", "cleanup", "touch")

_UNKNOWN_EPOCH = "-"

_lock = threading.Lock()
_records: List[dict] = []
_atexit_registered = False

# (epoch, tier) gauge label sets published last tick: a pair that
# drops out of the view (all segments freed) must be zeroed, not left
# showing its final residency forever.
_published_pairs: set = set()
_published_job_pairs: set = set()


def epoch_sort_key(epoch: Any) -> Tuple[int, int]:
    """The one sort key for ``"-"``-keyed epoch maps: numeric order,
    the unknown epoch last."""
    try:
        return (0, int(epoch))
    except (TypeError, ValueError):
        return (1, 0)


def spool_dir() -> Optional[str]:
    """Ledger spool: a ``capacity/`` subdir of the metrics spool, so
    one ``RSDL_METRICS_DIR`` override relocates the whole plane."""
    from ray_shuffling_data_loader_tpu_torch.telemetry import export as _export

    directory = _export.spool_dir()
    if not directory:
        return None
    return os.path.join(directory, "capacity")


def _register_atexit() -> None:
    global _atexit_registered
    if not _atexit_registered:
        _atexit_registered = True
        atexit.register(safe_flush)


def _ambient_epoch() -> Optional[int]:
    try:
        from ray_shuffling_data_loader_tpu_torch.telemetry import trace as _trace

        epoch = _trace.current_context().get("epoch")
        return None if epoch is None else int(epoch)
    except Exception:
        return None


def _ambient_job() -> Optional[str]:
    """The ambient job id of a job-scoped trace context, for per-job
    residency. None outside one (records then keep their single-job
    shape)."""
    try:
        from ray_shuffling_data_loader_tpu_torch.telemetry import trace as _trace

        job = _trace.current_context().get("job")
        return None if job is None else str(job)
    except Exception:
        return None


def note(
    op: str,
    object_id: str,
    nbytes: int = 0,
    tier: Optional[str] = None,
    ids: Optional[List[str]] = None,
    epoch: Optional[int] = None,
) -> None:
    """Record one ledger op. ``create``/``fetch`` carry bytes + tier
    (epoch defaults to the ambient trace context); ``delete`` needs
    only the id; ``transition`` carries the new tier. Caller gates on
    ``metrics.enabled()``; never raises."""
    try:
        rec: Dict[str, Any] = {
            "ts": time.time(),
            "op": str(op),
            "id": str(object_id),
            "pid": os.getpid(),
        }
        if nbytes:
            rec["nbytes"] = int(nbytes)
        if tier is not None:
            rec["tier"] = str(tier)
        if ids:
            rec["ids"] = [str(i) for i in ids]
        if op in ("create", "fetch"):
            if epoch is None:
                epoch = _ambient_epoch()
            if epoch is not None:
                rec["epoch"] = int(epoch)
            job = _ambient_job()
            if job is not None:
                rec["job"] = job
        _register_atexit()
        with _lock:
            _records.append(rec)
    except Exception:
        pass


# Per-id touch rate limit: a hot segment read in a tight loop must not
# grow the ledger linearly with reads — last-access resolution of a few
# seconds is ample for eviction ordering, and it bounds record volume
# at ~(live segments x runtime / interval) instead of O(reads).
_TOUCH_INTERVAL_S = 5.0
_touch_lock = threading.Lock()
_touch_last: Dict[str, float] = {}


def touch(object_id: str) -> None:
    """Record a read-access stamp for a segment (store read paths),
    rate-limited per id to one record per ``_TOUCH_INTERVAL_S``.
    Caller gates on ``metrics.enabled()``; never raises."""
    try:
        now = time.monotonic()
        with _touch_lock:
            last = _touch_last.get(object_id)
            if last is not None and now - last < _TOUCH_INTERVAL_S:
                return
            if len(_touch_last) > 65536:
                # Ids are never reused; entries only matter within the
                # interval — cap the map instead of leaking forever.
                _touch_last.clear()
            _touch_last[object_id] = now
        note("touch", object_id)
    except Exception:
        pass


def flush() -> None:
    """Append the buffered records to this process's spool file. No-op
    without a spool dir (records stay local for same-process folds)."""
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
        path = os.path.join(directory, f"ledger-{os.getpid()}.ndjson")
        with open(path, "a") as f:
            for rec in drained:
                f.write(json.dumps(rec) + "\n")
    except OSError:
        pass  # never sink the run


def safe_flush() -> None:
    from ray_shuffling_data_loader_tpu_torch.telemetry import metrics as _metrics

    if not _metrics.enabled():
        return
    try:
        flush()
    except Exception:
        pass


# Per-file tail-read cache for the live spool (the sampler folds every
# tick; the files are append-only) — same shape as the straggler
# spool's cache.
_read_cache: Dict[str, list] = {}
_cache_lock = threading.Lock()


def _read_file_records(fpath: str, use_cache: bool) -> List[dict]:
    cached = None
    if use_cache:
        with _cache_lock:
            cached = _read_cache.get(fpath)
    offset = cached[0] if cached else 0
    try:
        size = os.path.getsize(fpath)
        if cached and size < offset:
            cached, offset = None, 0  # truncated/replaced: re-read
        if cached and size == offset:
            return list(cached[1])
        new: List[dict] = []
        with open(fpath) as f:
            f.seek(offset)
            for line in f:
                if not line.endswith("\n"):
                    break  # torn tail mid-append; re-read next time
                offset += len(line.encode())
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if isinstance(rec, dict) and "op" in rec:
                    new.append(rec)
    except OSError:
        return list(cached[1]) if cached else []
    records = (cached[1] if cached else []) + new
    if use_cache:
        with _cache_lock:
            _read_cache[fpath] = [offset, records]
    return list(records)


def load_records(path: Optional[str] = None) -> List[dict]:
    """Every spooled ledger record plus the local buffer. ``path``
    overrides the spool dir (post-hoc tools); a directory reads its
    ``ledger-*.ndjson`` files, a file reads as one NDJSON."""
    out: List[dict] = []
    directory = path if path is not None else spool_dir()
    files: List[str] = []
    if directory:
        if os.path.isdir(directory):
            files = [
                os.path.join(directory, f)
                for f in sorted(os.listdir(directory))
                if f.startswith("ledger-") and f.endswith(".ndjson")
            ]
        elif os.path.isfile(directory):
            files = [directory]
    for fpath in files:
        out.extend(_read_file_records(fpath, use_cache=path is None))
    if path is None:
        with _lock:
            out.extend(_records)
    return out


def reset(clear_spool: bool = False) -> None:
    global _published_pairs, _published_job_pairs, _fold_cache
    with _lock:
        _records.clear()
        _published_pairs = set()
        _published_job_pairs = set()
        _fold_cache = None
    with _touch_lock:
        _touch_last.clear()
    with _cache_lock:
        _read_cache.clear()
    if clear_spool:
        directory = spool_dir()
        if directory and os.path.isdir(directory):
            for fname in os.listdir(directory):
                if fname.startswith("ledger-") and fname.endswith(".ndjson"):
                    try:
                        os.unlink(os.path.join(directory, fname))
                    except OSError:
                        pass


# ---------------------------------------------------------------------------
# Fold
# ---------------------------------------------------------------------------


class _Seg:
    __slots__ = (
        "nbytes", "tier", "epoch", "ts", "links", "last_touch", "job",
    )

    def __init__(self, nbytes, tier, epoch, ts, links, job=None):
        self.nbytes = nbytes
        self.tier = tier
        self.epoch = epoch
        self.ts = ts
        self.links = links
        self.last_touch = ts  # creation counts as the first access
        self.job = job  # the owning job, None outside a job


# Live-fold memo: (op count, folded view). Every view folds, and the op
# log only appends, so an
# unchanged count means an unchanged fold (ages are recomputed from
# `now` at read time via the cells' oldest_ts).
_fold_cache: Optional[Tuple[int, Dict[str, Any]]] = None


def ledger(
    records: Optional[List[dict]] = None, now: Optional[float] = None
) -> Dict[str, Any]:
    """Replay the ledger into the per-``(epoch, tier)`` view::

        {"epochs": {"3": {"shm": {"resident_bytes", "segments",
                                  "hwm_bytes", "created_bytes",
                                  "freed_bytes", "oldest_age_s"},
                          "spill": {...}}, ...},
         "totals": {"shm": {...}, "spill": {...}},
         "live_segments": N, "ops": N}

    Deletes resolve bytes/tier/epoch from the matching create (the
    freeing process need not know them); a hardlink-sliced segment
    stays resident until its last link is deleted; ``transition``
    moves a live segment between tiers (hwm accounted in the target);
    ``cleanup`` drops everything live at that point. Records from
    *unknown* epochs fold under ``"-"``. Live folds (no explicit
    ``records``) are memoized on the op count — the log is
    append-only, so the replay cost is paid once per new batch of ops,
    not once per page hit."""
    global _fold_cache
    now = time.time() if now is None else float(now)
    live = records is None
    if live:
        records = load_records()
        if _fold_cache is not None and _fold_cache[0] == len(records):
            return _with_ages(_fold_cache[1], now)
    folded = _fold(sorted(records, key=lambda r: float(r.get("ts", 0.0))))
    if live:
        _fold_cache = (len(records), folded)
    return _with_ages(folded, now)


def _with_ages(folded: Dict[str, Any], now: float) -> Dict[str, Any]:
    """A read-time copy of a fold with ``oldest_age_s`` derived from
    each cell's ``oldest_ts`` (the only now-dependent field, kept out
    of the memoized structure)."""
    epochs = {}
    for epoch, tiers in folded["epochs"].items():
        epochs[epoch] = {}
        for tier, cell in tiers.items():
            cell = dict(cell)
            oldest_ts = cell.pop("oldest_ts", None)
            if oldest_ts is not None:
                cell["oldest_age_s"] = round(now - oldest_ts, 3)
            epochs[epoch][tier] = cell
    out = dict(folded)
    out["epochs"] = epochs
    out["ts"] = now
    return out


def live_segments(
    records: Optional[List[dict]] = None,
) -> List[Dict[str, Any]]:
    """Every currently-live segment with its link ids, bytes, tier,
    epoch key, and creation ts: a tier mover's candidates, oldest
    first. Epochs use the same
    ``"-"``-keyed strings as the fold."""
    records = load_records() if records is None else records
    folded = _fold(
        sorted(records, key=lambda r: float(r.get("ts", 0.0))),
        want_segments=True,
    )
    return folded["segments"]


def _fold(
    records: List[dict], want_segments: bool = False
) -> Dict[str, Any]:

    segs: Dict[str, _Seg] = {}  # live segments by primary id
    by_link: Dict[str, str] = {}  # link id -> primary id
    resident: Dict[Tuple[str, str], int] = {}  # (epoch, tier) -> bytes
    counts: Dict[Tuple[str, str], int] = {}
    hwm: Dict[Tuple[str, str], int] = {}
    created: Dict[Tuple[str, str], int] = {}
    fetched: Dict[Tuple[str, str], int] = {}
    freed: Dict[Tuple[str, str], int] = {}

    def _epoch_key(rec) -> str:
        e = rec.get("epoch")
        return _UNKNOWN_EPOCH if e is None else str(e)

    def _add(seg: _Seg) -> None:
        key = (seg.epoch, seg.tier)
        resident[key] = resident.get(key, 0) + seg.nbytes
        counts[key] = counts.get(key, 0) + 1
        hwm[key] = max(hwm.get(key, 0), resident[key])

    def _sub(seg: _Seg) -> None:
        key = (seg.epoch, seg.tier)
        resident[key] = resident.get(key, 0) - seg.nbytes
        counts[key] = counts.get(key, 0) - 1
        freed[key] = freed.get(key, 0) + seg.nbytes

    def _drop(primary: str) -> None:
        seg = segs.pop(primary, None)
        if seg is None:
            return
        for link in seg.links:
            by_link.pop(link, None)
        _sub(seg)

    for rec in records:
        op = rec.get("op")
        rid = str(rec.get("id", ""))
        if op in ("create", "fetch"):
            tier = str(rec.get("tier") or "shm")
            nbytes = int(rec.get("nbytes", 0))
            seg = _Seg(
                nbytes,
                tier,
                _epoch_key(rec),
                float(rec.get("ts", 0.0)),
                set(rec.get("ids") or [rid]),
                job=rec.get("job"),
            )
            if rid in segs:  # duplicate create (retried task): replace
                _drop(rid)
            segs[rid] = seg
            for link in seg.links:
                by_link[link] = rid
            _add(seg)
            key = (seg.epoch, seg.tier)
            bucket = fetched if op == "fetch" else created
            bucket[key] = bucket.get(key, 0) + nbytes
        elif op == "delete":
            primary = by_link.get(rid)
            if primary is None:
                continue  # unknown id (foreign spool slice); ignore
            seg = segs[primary]
            seg.links.discard(rid)
            by_link.pop(rid, None)
            if not seg.links:
                segs.pop(primary, None)
                _sub(seg)
        elif op == "touch":
            primary = by_link.get(rid)
            if primary is None:
                continue  # unknown id (already freed, foreign); ignore
            seg = segs[primary]
            seg.last_touch = max(
                seg.last_touch, float(rec.get("ts", 0.0))
            )
        elif op == "transition":
            primary = by_link.get(rid)
            if primary is None:
                continue
            seg = segs[primary]
            new_tier = str(rec.get("tier") or seg.tier)
            if new_tier == seg.tier:
                continue
            _sub(seg)
            # A demotion is a move, not a free.
            freed[(seg.epoch, seg.tier)] -= seg.nbytes
            seg.tier = new_tier
            _add(seg)
        elif op == "cleanup":
            for primary in list(segs):
                _drop(primary)

    oldest: Dict[Tuple[str, str], float] = {}
    for seg in segs.values():
        key = (seg.epoch, seg.tier)
        oldest[key] = min(oldest.get(key, seg.ts), seg.ts)

    epochs: Dict[str, Dict[str, Any]] = {}
    totals: Dict[str, Dict[str, float]] = {
        t: {
            "resident_bytes": 0,
            "segments": 0,
            "created_bytes": 0,
            "fetched_bytes": 0,
            "freed_bytes": 0,
        }
        for t in TIERS
    }
    keys = (
        set(resident) | set(created) | set(fetched) | set(freed)
    )
    for epoch, tier in sorted(keys):
        cell = {
            "resident_bytes": int(resident.get((epoch, tier), 0)),
            "segments": int(counts.get((epoch, tier), 0)),
            "hwm_bytes": int(hwm.get((epoch, tier), 0)),
            "created_bytes": int(created.get((epoch, tier), 0)),
            "fetched_bytes": int(fetched.get((epoch, tier), 0)),
            "freed_bytes": int(freed.get((epoch, tier), 0)),
        }
        if (epoch, tier) in oldest:
            cell["oldest_ts"] = oldest[(epoch, tier)]
        epochs.setdefault(epoch, {})[tier] = cell
        if tier in totals:
            for field in totals[tier]:
                totals[tier][field] += cell.get(field, 0)
    # Per-job residency: who holds the budget. Only live
    # segments carry a job; single-job ledgers produce an empty map.
    jobs: Dict[str, Dict[str, Dict[str, int]]] = {}
    for seg in segs.values():
        if seg.job is None:
            continue
        cell = jobs.setdefault(str(seg.job), {}).setdefault(
            seg.tier, {"resident_bytes": 0, "segments": 0}
        )
        cell["resident_bytes"] += seg.nbytes
        cell["segments"] += 1

    out: Dict[str, Any] = {
        "epochs": epochs,
        "totals": totals,
        "jobs": jobs,
        "live_segments": len(segs),
        "ops": len(records),
    }
    if want_segments:
        out["segments"] = sorted(
            (
                {
                    "id": primary,
                    "ids": sorted(seg.links),
                    "nbytes": seg.nbytes,
                    "tier": seg.tier,
                    "epoch": seg.epoch,
                    "job": seg.job,
                    "ts": seg.ts,
                    "last_touch": seg.last_touch,
                }
                for primary, seg in segs.items()
            ),
            key=lambda s: s["ts"],
        )
    return out


# ---------------------------------------------------------------------------
# Host sampling
# ---------------------------------------------------------------------------


def _proc_rss_bytes() -> Optional[int]:
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        return pages * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        return None


def _store_dirs() -> Tuple[Optional[str], Optional[str], Optional[int]]:
    """(shm_dir, spill_dir, capacity_bytes) from the live runtime
    session when one exists here, else the store module's defaults —
    via ``sys.modules`` so a headless fold never imports the runtime."""
    import sys as _sys

    runtime = _sys.modules.get("ray_shuffling_data_loader_tpu_torch.runtime")
    try:
        if runtime is not None and runtime.is_initialized():
            store = runtime.get_context().store
            return store.shm_dir, store.spill_dir, store.capacity_bytes
    except Exception:
        pass
    store_mod = _sys.modules.get(
        "ray_shuffling_data_loader_tpu_torch.runtime.store"
    )
    if store_mod is not None:
        try:
            return (
                store_mod._default_shm_dir(),
                store_mod._default_spill_dir(),
                None,
            )
        except Exception:
            pass
    return None, None, None


def _fs_free_bytes(path: Optional[str]) -> Optional[int]:
    if not path:
        return None
    try:
        st = os.statvfs(path)
        return int(st.f_bavail * st.f_frsize)
    except OSError:
        return None


def host_sample() -> Dict[str, Any]:
    """Point-in-time host numbers: this process's RSS and the shm /
    spill filesystems' free bytes (plus the session budget when a
    runtime session is live here). Pure /proc + statvfs."""
    shm_dir, spill_dir, budget = _store_dirs()
    out: Dict[str, Any] = {}
    rss = _proc_rss_bytes()
    if rss is not None:
        out["rss_bytes"] = rss
    free = _fs_free_bytes(shm_dir)
    if free is not None:
        out["shm_free_bytes"] = free
    free = _fs_free_bytes(spill_dir)
    if free is not None:
        out["spill_free_bytes"] = free
    if budget:
        out["capacity_bytes"] = int(budget)
    return out


# ---------------------------------------------------------------------------
# Surfacing
# ---------------------------------------------------------------------------


def shm_resident_bytes(totals: Dict[str, Any]) -> int:
    """Bytes physically occupying shm: the shm tier PLUS the logical
    ``cache`` tier (shared decode-cache segments live on shm) — the
    one definition of the pressure numerator, for ``shm_used_frac``
    here and any watermark over it."""
    return int(
        (totals.get("shm") or {}).get("resident_bytes", 0)
        + (totals.get("cache") or {}).get("resident_bytes", 0)
    )


def view(
    records: Optional[List[dict]] = None, now: Optional[float] = None
) -> Dict[str, Any]:
    """The whole view: the ledger's fold, the host sample and
    ``shm_used_frac``, the share of the budget (or, without one, of the
    shm file system) resident on shm."""
    out = ledger(records=records, now=now)
    host = host_sample()
    out["host"] = host
    shm_resident = shm_resident_bytes(out["totals"])
    budget = host.get("capacity_bytes")
    if budget:
        out["shm_used_frac"] = round(shm_resident / budget, 4)
    else:
        # No explicit budget: fraction of the shm filesystem itself.
        free = host.get("shm_free_bytes")
        if free is not None and (shm_resident + free) > 0:
            out["shm_used_frac"] = round(
                shm_resident / (shm_resident + free), 4
            )
    return out


def publish_metrics(full: Optional[Dict[str, Any]] = None) -> None:
    """Fold a view into the registry as ``capacity.*`` gauges —
    ``rsdl_capacity_*`` on a scrape, sampled into the timeseries ring
    by the sampler tick. Gauges, not counters: the fold is a
    recomputed level. ``(epoch, tier)`` pairs that left the view are
    zeroed once so dead epochs don't linger at their last value."""
    global _published_pairs
    from ray_shuffling_data_loader_tpu_torch.telemetry import metrics as _metrics

    if not _metrics.enabled():
        return
    try:
        full = view() if full is None else full
        reg = _metrics.registry
        pairs = set()
        for epoch, tiers in full.get("epochs", {}).items():
            for tier, cell in tiers.items():
                pairs.add((epoch, tier))
                reg.gauge(
                    "capacity.resident_bytes", epoch=epoch, tier=tier
                ).set(cell.get("resident_bytes", 0))
                reg.gauge(
                    "capacity.segments", epoch=epoch, tier=tier
                ).set(cell.get("segments", 0))
                reg.gauge(
                    "capacity.hwm_bytes", epoch=epoch, tier=tier
                ).set(cell.get("hwm_bytes", 0))
                reg.gauge(
                    "capacity.oldest_age_seconds", epoch=epoch, tier=tier
                ).set(cell.get("oldest_age_s", 0.0))
        for epoch, tier in _published_pairs - pairs:
            for name in (
                "capacity.resident_bytes",
                "capacity.segments",
                "capacity.oldest_age_seconds",
            ):
                reg.gauge(name, epoch=epoch, tier=tier).set(0)
        # Only the time series' tick thread calls this: the previous
        # tick's pairs are its own.
        _published_pairs = pairs
        global _published_job_pairs
        job_pairs = set()
        # Each tenant's share of the used shm budget: shm_used_frac
        # scaled by the job's slice of total shm residency — the
        # per-job capacity_near_limit signal (a tenant holding >90% of
        # a near-full budget is the one to page).
        frac = full.get("shm_used_frac")
        shm_total = sum(
            (tiers.get("shm") or {}).get("resident_bytes", 0)
            for tiers in (full.get("jobs") or {}).values()
        )
        for jid, tiers in (full.get("jobs") or {}).items():
            for tier, cell in tiers.items():
                job_pairs.add((jid, tier))
                reg.gauge(
                    "capacity.job_resident_bytes", job=jid, tier=tier
                ).set(cell.get("resident_bytes", 0))
            if frac is not None and shm_total > 0:
                share = (
                    (tiers.get("shm") or {}).get("resident_bytes", 0)
                    / shm_total
                )
                reg.gauge("capacity.job_shm_frac", job=jid).set(
                    round(float(frac) * share, 4)
                )
        for jid, tier in _published_job_pairs - job_pairs:
            reg.gauge(
                "capacity.job_resident_bytes", job=jid, tier=tier
            ).set(0)
        for jid in (
            {j for j, _t in _published_job_pairs}
            - {j for j, _t in job_pairs}
        ):
            reg.gauge("capacity.job_shm_frac", job=jid).set(0)
        _published_job_pairs = job_pairs
        for tier in TIERS:
            tot = full.get("totals", {}).get(tier) or {}
            reg.gauge("capacity.tier_resident_bytes", tier=tier).set(
                tot.get("resident_bytes", 0)
            )
        host = full.get("host") or {}
        if "rss_bytes" in host:
            reg.gauge("capacity.host_rss_bytes").set(host["rss_bytes"])
        if "shm_free_bytes" in host:
            reg.gauge("capacity.fs_free_bytes", tier="shm").set(
                host["shm_free_bytes"]
            )
        if "spill_free_bytes" in host:
            reg.gauge("capacity.fs_free_bytes", tier="spill").set(
                host["spill_free_bytes"]
            )
        if "shm_used_frac" in full:
            reg.gauge("capacity.shm_used_frac").set(full["shm_used_frac"])
    except Exception:
        pass


def status_section(limit: int = 12) -> Dict[str, Any]:
    """The trimmed view a status page embeds: totals, host numbers, and
    the latest ``limit`` epochs' residency."""
    full = view()
    epochs = full.get("epochs", {})
    latest = sorted(epochs, key=epoch_sort_key)[-limit:]
    return {
        "totals": full.get("totals"),
        "host": full.get("host"),
        "shm_used_frac": full.get("shm_used_frac"),
        "live_segments": full.get("live_segments"),
        "jobs": full.get("jobs") or {},
        "epochs": {e: epochs[e] for e in latest},
    }
