"""The shuffle's plan compiler and its re-planner between epochs.

:func:`compile_plan` runs once per ``shuffle()`` under ``RSDL_PLAN=auto``
(or ``on``), in the calling process. It reads the dataset's shape from
the Parquet footers alone (:func:`footer_stats`: row groups per file,
rows, the decoded width of a row) and resolves the knobs of
:data:`TERM_KNOBS` with a small cost model, into a
:class:`~..runtime.plan.ResolvedPlan`. A knob set in the environment
pins its term: the planner records the set value with ``source="env"``.
``shuffle()`` hands the effective values to the stage tasks as
arguments, so a planned run and the same knobs set by hand run alike.

:func:`replan` changes the terms that may change mid-run
(:data:`~..runtime.plan.MUTABLE_TERMS`) between epochs, from live
signals (:func:`_live_signals`): the capacity ledger's
``shm_used_frac`` and the current epoch's critical path and stalls, from
whichever of those planes a metered run loaded. Without them the
re-planner holds.

``shuffle()`` reads ``RSDL_PLAN`` before it imports this module.
"""

from __future__ import annotations

import os
import sys
from typing import Any, Dict, List, Optional, Sequence

from ray_shuffling_data_loader_tpu_torch import shuffle as sh
from ray_shuffling_data_loader_tpu_torch.runtime.plan import (
    MUTABLE_TERMS,
    SOURCE_ENV,
    SOURCE_PLANNED,
    SOURCE_REPLANNED,
    PlanTerm,
    ResolvedPlan,
)

# The knob each term owns.
TERM_KNOBS = {
    "plan": "RSDL_SHUFFLE_PLAN",
    "selective": "RSDL_SELECTIVE_READS",
    "columns": "RSDL_DECODE_PUSHDOWN",
    "decode_rowgroup_threads": "RSDL_DECODE_ROWGROUPS",
    "fetch_window_depth": "RSDL_FETCH_WINDOW_DEPTH",
    "native_threads": "RSDL_NATIVE_THREADS",
}

# The cost model's constants, the JAX package's.
QUALITY_BLOCKS_PER_FILE = 2  # a block plan needs blocks/file >= 2R
WINDOW_BUDGET_FRAC = 0.25  # the in-flight windows' share of the store budget
WINDOW_DEPTH_MIN = 1
WINDOW_DEPTH_MAX = 8
WINDOW_DEPTH_DEFAULT = 4
FOOTER_SAMPLE_CAP = 64  # footers read at most, strided over the files
DECODED_HEADROOM = 1.15  # as the decoded-size estimate's
SHM_HIGH_WATER = 0.85
SHM_HEADROOM = 0.5
NATIVE_THREADS_CAP = 8


def _env_set(name: str) -> bool:
    return bool((os.environ.get(name) or "").strip())


def _cores() -> int:
    return os.cpu_count() or 1


def footer_stats(
    filenames: Sequence[str], columns: Optional[Sequence[str]] = None, narrow_to_32: bool = False
) -> Dict[str, Any]:
    """The dataset's shape from Parquet footers and the schema, no data
    read: row groups per file (fewest, most), rows (scaled up from a
    strided sample of at most :data:`FOOTER_SAMPLE_CAP` files), the
    decoded bytes of a row (of ``columns`` when given, 8-byte columns
    counted as 4 when the run narrows) and the decoded-size estimate with
    its headroom. A footer that cannot be read leaves the figures None."""
    import pyarrow.parquet as pq

    files = list(filenames)
    stride = max(1, len(files) // FOOTER_SAMPLE_CAP)
    sampled = files[::stride][:FOOTER_SAMPLE_CAP]
    groups: List[int] = []
    rows_sampled = 0
    try:
        for f in sampled:
            sizes = sh.file_row_group_sizes(f)
            groups.append(len(sizes))
            rows_sampled += int(sum(sizes))
    except OSError:
        return {"files": len(files), "groups_min": None, "rows": None, "bytes_per_row": None,
                "est_decoded_bytes": None}
    rows_total = int(rows_sampled * (len(files) / max(1, len(sampled))))
    bytes_per_row: Optional[float] = None
    try:
        schema = pq.ParquetFile(sampled[0], memory_map=True).schema_arrow
        want = {str(c) for c in columns} if columns else None
        width = 0
        for fld in schema:
            if want is not None and fld.name not in want:
                continue
            dt = sh._np_dtype_of(fld)
            if dt is None:
                continue
            width += 4 if narrow_to_32 and dt.itemsize == 8 else dt.itemsize
        if width:
            bytes_per_row = float(width)
    except Exception:
        bytes_per_row = None
    return {
        "files": len(files),
        "files_sampled": len(sampled),
        "groups_min": min(groups) if groups else None,
        "groups_max": max(groups) if groups else None,
        "rows": rows_total,
        "bytes_per_row": bytes_per_row,
        "est_decoded_bytes": rows_total * bytes_per_row * DECODED_HEADROOM if bytes_per_row is not None else None,
    }


def _store_budget() -> Optional[int]:
    """The store's budget in bytes (None: no budget)."""
    try:
        from ray_shuffling_data_loader_tpu_torch import runtime

        return runtime.get_context().store.capacity_bytes
    except Exception:
        return None


def compile_plan(
    filenames: Sequence[str],
    *,
    num_reducers: int,
    num_trainers: int = 1,
    num_epochs: int = 1,
    start_epoch: int = 0,
    columns: Optional[Sequence[str]] = None,
    device_layout: Optional[dict] = None,
    narrow_to_32: bool = False,
    cache_decoded: bool = True,
) -> ResolvedPlan:
    """Resolve every planner-owned knob once. The terms:

    * ``plan``: ``block:G`` with ``G = groups_min // (2R)`` when every
      file has at least ``2R`` row groups (then ``ceil(g/G) >= 2R`` blocks
      a file), else ``rowwise``: fewer groups cannot give each reducer
      two blocks of a file at any granularity.
    * ``selective``: on when the plan is a block plan and the run will
      not keep a decode cache (``cache_decoded`` and
      :func:`~..shuffle._decode_cache_auto`): a cache decodes each file
      once for every epoch, which beats decoding selections every epoch.
    * ``columns``: the staging layout's columns, when a layout names them
      and neither the caller (``columns``) nor ``RSDL_DECODE_PUSHDOWN``
      decided the projection.
    * ``decode_rowgroup_threads``: the cores shared fairly over the wider
      of the two decode stages (files in a map stage, reducers in a
      selective one): ``cores // concurrent`` when the host has twice the
      cores, else 1.
    * ``fetch_window_depth``: the deepest window pipeline whose in-flight
      bytes (``R`` reducers × depth windows of ``est / (F·R)``) stay under
      :data:`WINDOW_BUDGET_FRAC` of the store budget, within [1, 8]. The
      port records this term, but nothing reads it yet: its consumer is
      the overlapped reduce, which the port does not have.
    * ``native_threads``: the host kernels' threads shared over the
      reducers that run at once, at most :data:`NATIVE_THREADS_CAP`.
    """
    files = list(filenames)
    R = max(1, int(num_reducers))
    cores = _cores()
    stats = footer_stats(files, columns=columns, narrow_to_32=narrow_to_32)
    budget = _store_budget()
    terms: Dict[str, PlanTerm] = {}

    def term(name, value, source, why):
        terms[name] = PlanTerm(name=name, knob=TERM_KNOBS[name], value=value, source=source, why=why)

    if _env_set("RSDL_SHUFFLE_PLAN"):
        plan = sh.shuffle_plan_spec()
        term("plan", plan, SOURCE_ENV, "pinned by RSDL_SHUFFLE_PLAN")
    else:
        g = stats.get("groups_min")
        bound = QUALITY_BLOCKS_PER_FILE * R
        if g is not None and g >= bound:
            G = max(1, g // bound)
            plan = ("block", G)
            term("plan", plan, SOURCE_PLANNED,
                 f"block:{G}: blocks/file {-(-g // G)} >= 2R={bound} (min {g} groups/file)")
        else:
            plan = ("rowwise", 0)
            term("plan", plan, SOURCE_PLANNED,
                 f"rowwise: min {g} groups/file cannot meet blocks/file >= 2R={bound} at any granularity")

    if _env_set("RSDL_SELECTIVE_READS"):
        engaged, reason = sh.selective_reads_decision(plan)
        term("selective", bool(engaged), SOURCE_ENV, reason)
    else:
        prunable = plan[0] == "block"
        cache_friendly = False
        if prunable and cache_decoded:
            try:
                cache_friendly = sh._decode_cache_auto(files, num_epochs - start_epoch, narrow_to_32, columns)
            except Exception:
                cache_friendly = False
        if not prunable:
            why = "declined: rowwise plan is not prunable (selective would re-read every group ~R times)"
        elif cache_friendly:
            why = ("declined: decoded dataset fits the cross-epoch decode cache — one decode amortized beats "
                   "per-epoch selective re-reads")
        else:
            why = "engaged: block plan prunes for real and the decoded dataset will not be cache-resident"
        term("selective", prunable and not cache_friendly, SOURCE_PLANNED, why)

    projection: Optional[List[str]] = None
    if _env_set("RSDL_DECODE_PUSHDOWN"):
        term("columns", None, SOURCE_ENV, "pinned by RSDL_DECODE_PUSHDOWN")
    elif columns is not None:
        term("columns", [str(c) for c in columns], SOURCE_ENV, "caller-provided projection")
    elif device_layout is not None and device_layout.get("columns"):
        projection = [str(c) for c in device_layout["columns"]]
        term("columns", list(projection), SOURCE_PLANNED, "staging layout proves the touchable column set")
    else:
        term("columns", None, SOURCE_PLANNED,
             "full decode: no layout or caller projection to prove the touchable set")

    decode_conc = min(cores, max(1, max(len(files), R)))
    if _env_set("RSDL_DECODE_ROWGROUPS"):
        term("decode_rowgroup_threads", sh.decode_rowgroup_threads(decode_conc), SOURCE_ENV,
             "pinned by RSDL_DECODE_ROWGROUPS")
    else:
        value = cores // decode_conc if cores >= 2 * decode_conc else 1
        term("decode_rowgroup_threads", max(1, value), SOURCE_PLANNED,
             f"fair share: {cores} cores / {decode_conc} concurrent decode tasks")

    if _env_set("RSDL_FETCH_WINDOW_DEPTH"):
        from ray_shuffling_data_loader_tpu_torch.runtime.store import fetch_window_depth

        term("fetch_window_depth", fetch_window_depth(default=4), SOURCE_ENV, "pinned by RSDL_FETCH_WINDOW_DEPTH")
    else:
        est = stats.get("est_decoded_bytes")
        if est and budget and files:
            window_bytes = max(1.0, est / (len(files) * R))
            conc_reducers = min(R, cores)
            depth = int((WINDOW_BUDGET_FRAC * budget) / (window_bytes * max(1, conc_reducers)))
            depth = max(WINDOW_DEPTH_MIN, min(WINDOW_DEPTH_MAX, depth))
            term("fetch_window_depth", depth, SOURCE_PLANNED,
                 f"{conc_reducers} reducers x depth windows of ~{int(window_bytes)}B within "
                 f"{WINDOW_BUDGET_FRAC:.0%} of the {budget}B budget")
        else:
            term("fetch_window_depth", WINDOW_DEPTH_DEFAULT, SOURCE_PLANNED,
                 "default: dataset size or store budget unknown")

    if _env_set("RSDL_NATIVE_THREADS"):
        from ray_shuffling_data_loader_tpu_torch import native

        term("native_threads", native.num_threads(), SOURCE_ENV, "pinned by RSDL_NATIVE_THREADS")
    else:
        conc_reducers = max(1, min(R, cores))
        value = max(1, min(NATIVE_THREADS_CAP, cores // conc_reducers))
        term("native_threads", value, SOURCE_PLANNED,
             f"fair share: {cores} cores / {conc_reducers} concurrent reducers, capped at {NATIVE_THREADS_CAP}")

    model = {"num_reducers": R, "num_trainers": int(num_trainers), "num_epochs": int(num_epochs), "cores": cores,
             "store_budget_bytes": budget, "stats": stats}
    return ResolvedPlan(plan=plan, projection=projection, terms=terms, model=model)


def _live_signals() -> Dict[str, Any]:
    """The live signals the re-planner reads, from the telemetry planes
    already loaded (``sys.modules`` only: the re-planner never loads a
    dark plane): the store's shared-memory share in use
    (``shm_used_frac``, :func:`..telemetry.capacity.view`), the current
    epoch's critical path and sole-active shares and the stalls by cause
    (:func:`..telemetry.critical.analyze`), and the time series' rates
    where it has any. A plane that is not loaded adds nothing; with none,
    the re-planner holds."""
    out: Dict[str, Any] = {}
    pkg = "ray_shuffling_data_loader_tpu_torch."
    capacity = sys.modules.get(pkg + "telemetry.capacity")
    if capacity is not None:
        try:
            out["shm_used_frac"] = (capacity.view() or {}).get("shm_used_frac")
        except Exception:
            pass
    critical = sys.modules.get(pkg + "telemetry.critical")
    if critical is not None:
        try:
            analysis = critical.analyze()
            current = analysis.get("current") or {}
            out["critical_path"] = current.get("critical_path")
            out["sole_share"] = current.get("sole_share")
            stalls = analysis.get("stall_by_cause") or {}
            if stalls:
                out["stall_by_cause"] = stalls
        except Exception:
            pass
    timeseries = sys.modules.get(pkg + "telemetry.timeseries")
    if timeseries is not None:
        try:
            rates = getattr(timeseries, "rates", None)
            if callable(rates):
                out["rates"] = rates()
        except Exception:
            pass
    return out


def replan(rplan: ResolvedPlan, *, epoch: int) -> List[Dict[str, Any]]:
    """Change the mutable terms between epochs from :func:`_live_signals`;
    returns the changes (``term``, ``before``, ``after``, ``reason``). The
    rules:

    * shared memory at or over :data:`SHM_HIGH_WATER`: halve the window
      depth, and engage selective under a block plan (no map then writes
      its partitions);
    * a reduce-bound epoch below :data:`SHM_HEADROOM`: double the depth,
      up to the cap;
    * a map-bound (decode-bound) epoch: double the decode threads, up to
      the cores.

    A term pinned by the environment is never changed. ``epoch``: the
    epoch about to start (the caller records it beside the changes)."""
    signals = _live_signals()
    if not signals:
        return []
    changes: List[Dict[str, Any]] = []

    def mutate(name: str, value: Any, reason: str) -> None:
        t = rplan.terms.get(name)
        if t is None or name not in MUTABLE_TERMS or t.source == SOURCE_ENV or t.value == value:
            return
        changes.append({"term": name, "before": t.value, "after": value, "reason": reason})
        t.value, t.source, t.why = value, SOURCE_REPLANNED, reason

    shm = signals.get("shm_used_frac")
    path = signals.get("critical_path")
    depth = rplan.term_value("fetch_window_depth")
    if shm is not None and shm >= SHM_HIGH_WATER:
        if isinstance(depth, int) and depth > WINDOW_DEPTH_MIN:
            mutate("fetch_window_depth", max(WINDOW_DEPTH_MIN, depth // 2),
                   f"shm {shm:.0%} >= {SHM_HIGH_WATER:.0%} watermark: shed in-flight window residency")
        if rplan.plan[0] == "block" and not rplan.term_value("selective"):
            mutate("selective", True,
                   f"shm {shm:.0%} >= {SHM_HIGH_WATER:.0%} watermark: selective schedule drops map materialization")
    elif path == "reduce" and (shm is None or shm < SHM_HEADROOM):
        if isinstance(depth, int) and depth < WINDOW_DEPTH_MAX:
            mutate("fetch_window_depth", min(WINDOW_DEPTH_MAX, depth * 2),
                   "reduce-dominant epoch with shm headroom: deepen the fetch pipeline")
    if path == "map":
        threads = rplan.term_value("decode_rowgroup_threads")
        cores = _cores()
        if isinstance(threads, int) and threads < cores:
            mutate("decode_rowgroup_threads", min(cores, threads * 2),
                   "map(decode)-dominant epoch: grant decode more of the idle cores")
    rplan.replans += len(changes)
    if changes:
        from ray_shuffling_data_loader_tpu_torch import telemetry

        for change in changes:
            telemetry.emit_event("plan.replanned", epoch=epoch, term=change["term"], before=str(change["before"]),
                                 after=str(change["after"]), reason=change["reason"])
            telemetry.metrics.safe_inc("plan.replans", term=change["term"])
    return changes
