"""A wall-clock sampling profiler that runs in every process of a
session.

Phases, spans and the critical path time the sites someone declared; a
bottleneck outside them stays dark. This plane samples every thread of
every process instead: the driver, the task workers and the actor hosts.

* A daemon thread (``rsdl-profiler``) samples ``sys._current_frames()``
  at ``RSDL_PROFILE_HZ`` (default 67 Hz, off-round so that it does not
  lock phase with work on whole seconds; clamped to [1, 500]). Each
  thread's stack folds into a **collapsed stack** (root first,
  ``frame;frame;...;leaf``, frames named ``module:function``) keyed with
  the sample's **tags**: the phase that thread has open (from
  :mod:`.phases`' active-phase registry: ``stage``, ``phase`` and the
  stage's ``epoch``) and the ambient ``trial``, ``epoch`` and ``job`` of
  the trace plane's base context.
* Each process spools its aggregate to one JSON file
  (``profile-<role>-<pid>.json`` under ``RSDL_PROFILE_DIR``, else
  ``$RSDL_RUNTIME_DIR/profiles``), replaced whole, with the metrics
  spool's source identity (role, host, pid, job). The sampler flushes
  about once a second; task workers flush before a task is reported
  done (``runtime/tasks.py``), actor hosts after a dispatch and at
  exit (``runtime/actor.py``), the session at shutdown.
* :func:`aggregate_profiles` merges the spool (and this process's live
  aggregate), filtered by ``stage``, ``job`` or ``epoch``;
  :func:`top_table` is the self/total table, :func:`collapsed_text` the
  folded text, :func:`render_flame_html` a self-contained flame graph
  page, and :func:`digest` the top frames by self time that the run
  ledger records; :func:`diff_digests` compares two digests.

Off unless ``RSDL_PROFILE`` is set: every site checks the variable (or
``sys.modules``) before it imports this module, so an unset run loads
no module, starts no thread and writes no file.

A sample's cost is bounded: frame names are memoized per code object,
a stack stops at ``_MAX_DEPTH`` frames, and the fold is one dict update
per thread. The profiler never samples its own thread.

Stacks, tags, spool records, tables and digests are the JAX package's,
letter for letter (frames of this package are named from its root).
Standard library only.
"""

from __future__ import annotations

import json
import os
import socket
import sys
import threading
import time
from typing import Any, Dict, Iterable, List, Optional, Tuple

from ray_shuffling_data_loader_tpu_torch.telemetry import _env

ENV_PROFILE = "RSDL_PROFILE"
ENV_PROFILE_HZ = "RSDL_PROFILE_HZ"
ENV_PROFILE_DIR = "RSDL_PROFILE_DIR"
ENV_PROFILE_TOP_N = "RSDL_PROFILE_TOP_N"
_RUNTIME_DIR_ENV = "RSDL_RUNTIME_DIR"

_DEFAULT_HZ = 67.0  # off-round: never phase-locks with 1 s periodic work
_MIN_HZ, _MAX_HZ = 1.0, 500.0
_MAX_DEPTH = 96
_FLUSH_INTERVAL_S = 1.0
_DEFAULT_TOP_N = 20

_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_enabled: Optional[bool] = None

_lock = threading.Lock()
# (tags_items, stack) -> sample count. tags_items is a sorted tuple of
# (key, value) string pairs so it hashes; stack is the collapsed string.
_agg: Dict[Tuple[Tuple[Tuple[str, str], ...], str], int] = {}
_samples = 0
_started_ts: Optional[float] = None
_thread: Optional[threading.Thread] = None
_stop_event: Optional[threading.Event] = None
_name_cache: Dict[Tuple[str, str], str] = {}


def enabled() -> bool:
    """Cached ``RSDL_PROFILE`` flag — the gate every wiring site checks
    (via the env var, BEFORE importing this module)."""
    global _enabled
    if _enabled is None:
        _enabled = _env.read_flag(ENV_PROFILE)
    return _enabled


def refresh_from_env() -> None:
    """Re-read the gate (tests that flip the env mid-process)."""
    global _enabled
    _enabled = None


def hz() -> float:
    """Sampling frequency, clamped to [1, 500] Hz — a typo'd
    ``RSDL_PROFILE_HZ=6700`` must degrade to "fast", not wedge every
    process in its own profiler."""
    raw = os.environ.get(ENV_PROFILE_HZ, "")
    try:
        value = float(raw) if raw else _DEFAULT_HZ
    except ValueError:
        value = _DEFAULT_HZ
    return min(_MAX_HZ, max(_MIN_HZ, value))


def top_n_default() -> int:
    raw = os.environ.get(ENV_PROFILE_TOP_N, "")
    try:
        value = int(raw) if raw else _DEFAULT_TOP_N
    except ValueError:
        value = _DEFAULT_TOP_N
    return max(1, value)


def spool_dir() -> Optional[str]:
    """Where this process spools: ``RSDL_PROFILE_DIR`` when set, else
    ``$RSDL_RUNTIME_DIR/profiles``, else None (no spool — the live
    in-process aggregate is the only view)."""
    explicit = os.environ.get(ENV_PROFILE_DIR)
    if explicit:
        return explicit
    runtime_dir = os.environ.get(_RUNTIME_DIR_ENV)
    if runtime_dir:
        return os.path.join(runtime_dir, "profiles")
    return None


def source_identity() -> Dict[str, Any]:
    """Role, host and pid (and the job, when there is one): the identity
    the metrics spool stamps (:mod:`.export`)."""
    try:
        from ray_shuffling_data_loader_tpu_torch.runtime import faults

        role = faults.role()
    except Exception:
        role = "driver"
    ident: Dict[str, Any] = {
        "role": role, "host": socket.gethostname(), "pid": os.getpid(),
    }
    job = _current_job_id()
    if job:
        ident["job"] = job
    return ident


def _current_job_id() -> Optional[str]:
    svc = sys.modules.get("ray_shuffling_data_loader_tpu_torch.runtime.service")
    if svc is not None:
        try:
            if svc.enabled():
                job = svc.current_job()
                if job is not None:
                    return str(job.job_id)
        except Exception:
            pass
    return os.environ.get("RSDL_JOB_ID") or None


# ---------------------------------------------------------------------------
# Sampling
# ---------------------------------------------------------------------------


def _frame_name(code) -> str:
    """``module:function`` for one code object, memoized. Package files
    render as their dotted path from the package root
    (``runtime.tasks:_worker_main``); everything else as the bare module
    basename (``threading:wait``) — short enough to read on a flame
    cell, unique enough to diff."""
    key = (code.co_filename, code.co_name)
    cached = _name_cache.get(key)
    if cached is not None:
        return cached
    filename = code.co_filename
    if filename.startswith(_PKG_ROOT):
        mod = filename[len(_PKG_ROOT):].lstrip(os.sep)
        if mod.endswith(".py"):
            mod = mod[:-3]
        mod = mod.replace(os.sep, ".")
        if mod.endswith(".__init__"):
            mod = mod[: -len(".__init__")]
    else:
        mod = os.path.basename(filename)
        if mod.endswith(".py"):
            mod = mod[:-3]
    name = f"{mod}:{code.co_name}"
    # rsdl-lint: disable=lock-discipline -- idempotent memo cache: racing
    # writers store the identical string; worst case one duplicate format
    _name_cache[key] = name
    return name


def _collapse(frame) -> str:
    """Fold one thread's frame chain into the root-first collapsed
    string (leaf last — the Brendan Gregg folded format)."""
    parts: List[str] = []
    depth = 0
    while frame is not None and depth < _MAX_DEPTH:
        parts.append(_frame_name(frame.f_code))
        frame = frame.f_back
        depth += 1
    parts.reverse()
    return ";".join(parts)


def _ambient_ctx() -> Dict[str, str]:
    """Process-wide trial/epoch/job fallback tags: the trace plane's
    base context (``set_context(trial=...)``) and the job identity.
    sys.modules only: tagging never imports a plane."""
    tags: Dict[str, str] = {}
    tr = sys.modules.get("ray_shuffling_data_loader_tpu_torch.telemetry.trace")
    if tr is not None:
        try:
            base = getattr(tr, "_base_ctx", None) or {}
            for key in ("trial", "epoch", "job"):
                if key in base:
                    tags[key] = str(base[key])
        except Exception:
            pass
    job = _current_job_id()
    if job:
        tags.setdefault("job", job)
    return tags


def _tick(now: Optional[float] = None) -> int:
    """Take one sample of every live thread (except the profiler's own)
    and fold into the aggregate. Returns the number of stacks folded
    (tests drive this directly)."""
    global _samples, _started_ts
    phases_active: Dict[int, tuple] = {}
    ph = sys.modules.get("ray_shuffling_data_loader_tpu_torch.telemetry.phases")
    if ph is not None:
        active = getattr(ph, "_ACTIVE", None)
        if active:
            phases_active = dict(active)
    ambient = _ambient_ctx()
    names = {t.ident: t.name for t in threading.enumerate()}
    me = threading.get_ident()
    folded = 0
    frames = sys._current_frames()
    try:
        items = list(frames.items())
    finally:
        del frames  # drop frame refs promptly
    with _lock:
        if _started_ts is None:
            _started_ts = time.time() if now is None else now
        for ident, frame in items:
            if ident == me:
                continue
            tags = dict(ambient)
            entry = phases_active.get(ident)
            if entry is not None:
                stage, phase, args = entry
                tags["stage"] = str(stage)
                tags["phase"] = str(phase)
                if "epoch" in args:
                    tags["epoch"] = str(args["epoch"])
            stack = (
                f"thread:{names.get(ident, ident)};{_collapse(frame)}"
            )
            key = (tuple(sorted(tags.items())), stack)
            _agg[key] = _agg.get(key, 0) + 1
            folded += 1
        _samples += 1
    del items
    return folded


def _loop(stop_event: threading.Event, period: float) -> None:
    next_flush = time.monotonic() + _FLUSH_INTERVAL_S
    while not stop_event.wait(period):
        try:
            _tick()
        except Exception:
            pass  # telemetry must never sink anything
        try:
            from ray_shuffling_data_loader_tpu_torch.telemetry import (
                metrics as _metrics,
            )

            if _metrics.enabled():
                _metrics.registry.counter("profiler.samples_total").inc()
        except Exception:
            pass
        if time.monotonic() >= next_flush:
            safe_flush()
            next_flush = time.monotonic() + _FLUSH_INTERVAL_S
    safe_flush()


# ---------------------------------------------------------------------------
# Lifecycle
# ---------------------------------------------------------------------------


def running() -> bool:
    return _thread is not None and _thread.is_alive()


def start(period: Optional[float] = None) -> None:
    """Start the sampler daemon thread (idempotent; one per process).
    No-op unless ``RSDL_PROFILE`` is set — callers gate on the env var
    first, so in a disabled process this function never even runs."""
    global _thread, _stop_event
    if not enabled():
        return
    interval = (1.0 / hz()) if period is None else max(0.002, float(period))
    with _lock:
        if _thread is not None and _thread.is_alive():
            return
        stop_event = threading.Event()
        _stop_event = stop_event
        _thread = threading.Thread(
            target=_loop, args=(stop_event, interval),
            name="rsdl-profiler", daemon=True,
        )
        _thread.start()


def stop() -> None:
    """Stop the sampler, join it, and flush the final aggregate (session
    shutdown, worker exit, tests). The spool file stays — the profile
    outlives the process."""
    global _thread, _stop_event
    with _lock:
        thread, _thread = _thread, None
        stop_event, _stop_event = _stop_event, None
    if stop_event is not None:
        stop_event.set()
    if thread is not None:
        thread.join(timeout=5.0)
    safe_flush()


def reset() -> None:
    """Drop the in-process aggregate (tests, run boundaries)."""
    global _samples, _started_ts
    with _lock:
        _agg.clear()
        _samples = 0
        _started_ts = None


# ---------------------------------------------------------------------------
# Spool
# ---------------------------------------------------------------------------


def _spool_path(directory: str, ident: Dict[str, Any]) -> str:
    return os.path.join(
        directory, f"profile-{ident['role']}-{ident['pid']}.json"
    )


def snapshot() -> dict:
    """The live local aggregate as one spool-shaped record."""
    with _lock:
        stacks = [
            {"stack": stack, "count": count, "tags": dict(tags)}
            for (tags, stack), count in _agg.items()
        ]
        samples = _samples
        t0 = _started_ts
    return {
        "source": source_identity(),
        "ts": time.time(),
        "t0": t0,
        "hz": hz(),
        "samples": samples,
        "stacks": stacks,
    }


def flush() -> Optional[str]:
    """Atomically replace this process's spool file with the current
    aggregate. None when there is nothing to say or nowhere to spool.
    Never raises into the caller (full disk, read-only spool)."""
    directory = spool_dir()
    if not directory:
        return None
    record = snapshot()
    if not record["samples"]:
        return None
    path = _spool_path(directory, record["source"])
    tmp = f"{path}.tmp{os.getpid()}"
    try:
        os.makedirs(directory, exist_ok=True)
        with open(tmp, "w") as f:
            json.dump(record, f)
        os.replace(tmp, path)
    except OSError:
        return None
    return path


def safe_flush() -> None:
    """Guarded :func:`flush` for teardown/barrier paths: no-op when the
    profiler is off, never raises."""
    if not enabled():
        return
    try:
        flush()
    except Exception:
        pass


def clear_spool(directory: Optional[str] = None) -> None:
    directory = directory or spool_dir()
    if not directory or not os.path.isdir(directory):
        return
    for fname in os.listdir(directory):
        if fname.startswith("profile-") and fname.endswith(".json"):
            try:
                os.unlink(os.path.join(directory, fname))
            except OSError:
                pass


def load_records(directory: Optional[str] = None) -> List[dict]:
    """Every parseable spool record in ``directory`` (default: this
    process's spool dir). Pure file read — no RPCs, safe anywhere."""
    directory = directory or spool_dir()
    out: List[dict] = []
    if not directory or not os.path.isdir(directory):
        return out
    for fname in sorted(os.listdir(directory)):
        if not (fname.startswith("profile-") and fname.endswith(".json")):
            continue
        try:
            with open(os.path.join(directory, fname)) as f:
                rec = json.load(f)
        except (OSError, ValueError):
            continue  # torn replace or foreign file
        if isinstance(rec, dict) and "stacks" in rec:
            out.append(rec)
    return out


# ---------------------------------------------------------------------------
# Aggregation / analysis (pure functions over records)
# ---------------------------------------------------------------------------


def _match(tags: Dict[str, str], source: Dict[str, Any],
           stage: Optional[str], job: Optional[str],
           epoch: Optional[str]) -> bool:
    if stage is not None and tags.get("stage") != stage:
        return False
    if job is not None:
        sample_job = tags.get("job") or str(source.get("job") or "")
        if sample_job != job:
            return False
    if epoch is not None and tags.get("epoch") != str(epoch):
        return False
    return True


def aggregate_profiles(
    directory: Optional[str] = None,
    records: Optional[Iterable[dict]] = None,
    include_local: bool = True,
    stage: Optional[str] = None,
    job: Optional[str] = None,
    epoch: Optional[str] = None,
) -> dict:
    """Merge spool records (plus the live local aggregate when this
    process profiles) into one view::

        {"sources": [ident, ...], "samples": N, "seconds": S,
         "stacks": [{"stack", "count", "seconds", "tags"}, ...]}

    Counts merge on ``(stack, tags)``; ``seconds`` converts each
    record's counts at ITS OWN sampling rate (``count / hz``) so mixed-
    Hz fleets merge correctly. ``stage=``/``job=``/``epoch=`` filter at
    sample granularity."""
    if records is None:
        records = load_records(directory)
        if include_local and enabled() and _samples:
            me = source_identity()
            records = [
                r for r in records
                if not (
                    (r.get("source") or {}).get("pid") == me["pid"]
                    and (r.get("source") or {}).get("host") == me["host"]
                )
            ]
            records.append(snapshot())
    merged: Dict[Tuple[Tuple[Tuple[str, str], ...], str],
                 Dict[str, float]] = {}
    sources: List[dict] = []
    total_samples = 0
    for rec in records:
        source = rec.get("source") or {}
        rec_hz = float(rec.get("hz") or _DEFAULT_HZ) or _DEFAULT_HZ
        sources.append(source)
        total_samples += int(rec.get("samples") or 0)
        for entry in rec.get("stacks", []):
            tags = {
                str(k): str(v)
                for k, v in (entry.get("tags") or {}).items()
            }
            if not _match(tags, source, stage, job, epoch):
                continue
            count = int(entry.get("count") or 0)
            key = (tuple(sorted(tags.items())), str(entry.get("stack")))
            cur = merged.get(key)
            if cur is None:
                merged[key] = {
                    "count": count, "seconds": count / rec_hz,
                }
            else:
                cur["count"] += count
                cur["seconds"] += count / rec_hz
    stacks = [
        {
            "stack": stack,
            "count": int(val["count"]),
            "seconds": val["seconds"],
            "tags": dict(tags),
        }
        for (tags, stack), val in merged.items()
    ]
    stacks.sort(key=lambda s: (-s["count"], s["stack"]))
    return {
        "sources": sources,
        "samples": total_samples,
        "seconds": sum(s["seconds"] for s in stacks),
        "stacks": stacks,
    }


def top_table(agg: dict, n: Optional[int] = None) -> List[dict]:
    """The top-N frames by **self** time from an
    :func:`aggregate_profiles` view. Self = samples where the frame is
    the leaf; total = samples where it appears anywhere (counted once
    per stack — recursion does not double-bill). Each row carries a
    per-stage self-seconds breakdown (what the digest records)::

        {"frame", "self_s", "total_s", "self_count", "total_count",
         "self_frac", "stages": {stage: self_s}}
    """
    n = top_n_default() if n is None else int(n)
    self_s: Dict[str, float] = {}
    self_n: Dict[str, int] = {}
    total_s: Dict[str, float] = {}
    total_n: Dict[str, int] = {}
    by_stage: Dict[str, Dict[str, float]] = {}
    wall = 0.0
    for entry in agg.get("stacks", []):
        frames = entry["stack"].split(";")
        count, secs = entry["count"], entry["seconds"]
        wall += secs
        leaf = frames[-1]
        self_s[leaf] = self_s.get(leaf, 0.0) + secs
        self_n[leaf] = self_n.get(leaf, 0) + count
        stage = (entry.get("tags") or {}).get("stage", "")
        if stage:
            row = by_stage.setdefault(leaf, {})
            row[stage] = row.get(stage, 0.0) + secs
        for frame in set(frames):
            total_s[frame] = total_s.get(frame, 0.0) + secs
            total_n[frame] = total_n.get(frame, 0) + count
    rows = []
    for frame, secs in sorted(
        self_s.items(), key=lambda kv: (-kv[1], kv[0])
    )[:n]:
        rows.append({
            "frame": frame,
            "self_s": secs,
            "total_s": total_s.get(frame, secs),
            "self_count": self_n.get(frame, 0),
            "total_count": total_n.get(frame, 0),
            "self_frac": (secs / wall) if wall else 0.0,
            "stages": {
                k: v for k, v in sorted(
                    by_stage.get(frame, {}).items(),
                    key=lambda kv: -kv[1],
                )
            },
        })
    return rows


def collapsed_text(agg: dict, tagged: bool = False) -> str:
    """The merged profile in folded-stack text (``stack count`` lines,
    mergeable by any flamegraph tool). ``tagged=True`` prefixes each
    stack with its ``stage:<s>`` segment so a flamegraph splits by
    shuffle stage."""
    lines = []
    for entry in agg.get("stacks", []):
        stack = entry["stack"]
        if tagged:
            stage = (entry.get("tags") or {}).get("stage")
            if stage:
                stack = f"stage:{stage};{stack}"
        lines.append(f"{stack} {entry['count']}")
    return "\n".join(lines) + ("\n" if lines else "")


def digest(
    directory: Optional[str] = None,
    records: Optional[Iterable[dict]] = None,
    n: Optional[int] = None,
) -> Optional[dict]:
    """The compact profile summary the run ledger embeds: top-N frames
    by self time (with per-stage attribution and self fractions —
    fractions, not seconds, so digests from runs of different lengths
    diff meaningfully) plus per-stage sampled seconds. None when no
    profile data exists (the ledger section stays absent, not empty)."""
    agg = aggregate_profiles(directory=directory, records=records)
    if not agg["stacks"]:
        return None
    stage_s: Dict[str, float] = {}
    for entry in agg["stacks"]:
        stage = (entry.get("tags") or {}).get("stage")
        if stage:
            stage_s[stage] = stage_s.get(stage, 0.0) + entry["seconds"]
    return {
        "hz": hz(),
        "samples": agg["samples"],
        "seconds": round(agg["seconds"], 3),
        "sources": len(agg["sources"]),
        "stages": {
            k: round(v, 3) for k, v in sorted(
                stage_s.items(), key=lambda kv: -kv[1]
            )
        },
        "top": [
            {
                "frame": row["frame"],
                "self_s": round(row["self_s"], 3),
                "self_frac": round(row["self_frac"], 4),
                "stage": next(iter(row["stages"]), None),
            }
            for row in top_table(agg, n=n)
        ],
    }


def diff_digests(base: dict, head: dict, n: int = 10,
                 min_delta: float = 0.01) -> dict:
    """Differential profile between two digests (or two
    :func:`top_table`-shaped row lists): per-frame **self-fraction**
    deltas, split into ``regressed`` (grew in head) and ``improved``
    (shrank), each sorted by magnitude. Fractions — not seconds — so a
    longer run does not read as a universal regression; shifts under
    ``min_delta`` (default one point) are sampling noise and dropped,
    so two clean runs diff to nothing."""
    def rows_of(d):
        rows = d.get("top", d) if isinstance(d, dict) else d
        return {
            r["frame"]: float(r.get("self_frac") or 0.0) for r in rows
        }

    base_rows, head_rows = rows_of(base), rows_of(head)
    deltas = []
    for frame in set(base_rows) | set(head_rows):
        delta = head_rows.get(frame, 0.0) - base_rows.get(frame, 0.0)
        deltas.append({
            "frame": frame,
            "base_frac": base_rows.get(frame, 0.0),
            "head_frac": head_rows.get(frame, 0.0),
            "delta_frac": delta,
        })
    regressed = sorted(
        (d for d in deltas if d["delta_frac"] >= min_delta),
        key=lambda d: -d["delta_frac"],
    )[:n]
    improved = sorted(
        (d for d in deltas if d["delta_frac"] <= -min_delta),
        key=lambda d: d["delta_frac"],
    )[:n]
    return {"regressed": regressed, "improved": improved}


# ---------------------------------------------------------------------------
# Flamegraph (stdlib-rendered, self-contained)
# ---------------------------------------------------------------------------


_FLAME_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>%(title)s</title>
<style>
 body { font: 12px monospace; background: #1b1b1b; color: #ddd;
        margin: 12px; }
 #meta { margin-bottom: 8px; color: #999; }
 .cell { position: absolute; height: 17px; overflow: hidden;
         white-space: nowrap; box-sizing: border-box; cursor: pointer;
         border: 1px solid #1b1b1b; border-radius: 2px;
         padding-left: 3px; color: #222; }
 .cell:hover { border-color: #fff; }
 #flame { position: relative; }
 #detail { margin-top: 8px; color: #e8c06a; min-height: 1.2em; }
</style></head><body>
<div id="meta">%(title)s &mdash; %(samples)d samples,
 %(seconds).1f sampled-seconds, %(sources)d sources.
 Click a cell to zoom; click the root row to reset.</div>
<div id="flame"></div><div id="detail"></div>
<script>
var root = %(tree)s;
var W = Math.max(400, document.body.clientWidth - 24);
var PALETTE = ["#e06c4f","#e0934f","#e0b84f","#c9e04f","#7fe04f",
               "#4fe0a2","#4fc9e0","#4f93e0","#8a7fe0","#c96ce0"];
function color(name) {
  var h = 0;
  for (var i = 0; i < name.length; i++)
    h = (h * 31 + name.charCodeAt(i)) >>> 0;
  return PALETTE[h %% PALETTE.length];
}
var flame = document.getElementById("flame");
var detail = document.getElementById("detail");
function render(focus) {
  flame.innerHTML = "";
  var depthMax = 0;
  function walk(node, x0, width, depth, inFocus) {
    if (width < 0.5) return;
    depthMax = Math.max(depthMax, depth);
    var div = document.createElement("div");
    div.className = "cell";
    div.style.left = x0 + "px";
    div.style.top = (depth * 18) + "px";
    div.style.width = Math.max(1, width - 1) + "px";
    div.style.background = inFocus ? color(node.n) : "#555";
    div.textContent = node.n;
    div.title = node.n + " \\u2014 " + node.v + " samples (" +
      (100 * node.v / root.v).toFixed(1) + "%% of run)";
    div.onclick = function (ev) {
      ev.stopPropagation();
      detail.textContent = div.title;
      render(node === focus ? root : node);
    };
    flame.appendChild(div);
    var nowFocus = inFocus || node === focus;
    var cx = x0;
    var kids = node.c || [];
    var kidSum = 0;
    for (var i = 0; i < kids.length; i++) kidSum += kids[i].v;
    for (var i = 0; i < kids.length; i++) {
      var kw = width * kids[i].v / Math.max(node.v, kidSum, 1);
      walk(kids[i], cx, kw, depth + 1, nowFocus);
      cx += kw;
    }
  }
  // When zoomed, the focused subtree takes the full width; its
  // ancestors render as full-width context rows above it.
  var chain = [];
  (function find(node, trail) {
    if (node === focus) { chain = trail.concat([node]); return true; }
    var kids = node.c || [];
    for (var i = 0; i < kids.length; i++)
      if (find(kids[i], trail.concat([node]))) return true;
    return false;
  })(root, []);
  if (!chain.length) chain = [root];
  for (var d = 0; d < chain.length - 1; d++) {
    var node = chain[d];
    var div = document.createElement("div");
    div.className = "cell";
    div.style.left = "0px";
    div.style.top = (d * 18) + "px";
    div.style.width = (W - 1) + "px";
    div.style.background = "#777";
    div.textContent = node.n;
    div.onclick = (function (n) { return function (ev) {
      ev.stopPropagation(); render(n === root ? root : n);
    }; })(node);
    flame.appendChild(div);
  }
  walk(chain[chain.length - 1], 0, W,
       chain.length - 1, focus === root);
  flame.style.height = ((depthMax + 1) * 18 + 4) + "px";
}
render(root);
</script></body></html>
"""


def _build_tree(agg: dict) -> dict:
    """Collapse the aggregate into the nested ``{n, v, c}`` tree the
    flame template renders. Stacks group under ``stage:<s>`` roots when
    tagged so one page shows where each shuffle stage burns."""
    root: Dict[str, Any] = {"n": "all", "v": 0, "kids": {}}
    for entry in agg.get("stacks", []):
        frames = entry["stack"].split(";")
        stage = (entry.get("tags") or {}).get("stage")
        if stage:
            frames = [f"stage:{stage}"] + frames
        count = entry["count"]
        node = root
        node["v"] += count
        for frame in frames:
            node = node["kids"].setdefault(
                frame, {"n": frame, "v": 0, "kids": {}}
            )
            node["v"] += count

    def freeze(node):
        out = {"n": node["n"], "v": node["v"]}
        kids = sorted(
            node["kids"].values(), key=lambda k: (-k["v"], k["n"])
        )
        if kids:
            out["c"] = [freeze(k) for k in kids]
        return out

    return freeze(root)


def render_flame_html(agg: dict, title: str = "rsdl profile") -> str:
    """A self-contained flamegraph HTML page for an
    :func:`aggregate_profiles` view — stdlib-rendered (the template is
    inline; no external scripts, fonts, or network)."""
    return _FLAME_TEMPLATE % {
        "title": title,
        "samples": int(agg.get("samples") or 0),
        "seconds": float(agg.get("seconds") or 0.0),
        "sources": len(agg.get("sources") or ()),
        "tree": json.dumps(_build_tree(agg)),
    }
