"""Where a map/reduce epoch of the shuffle spends its time, against this
host's memory-bandwidth roofline.

    python -m ray_shuffling_data_loader_tpu_torch.shuffle_profile --gb 0.5 --files 8 --reducers 8 \\
        --epochs 3 [--narrow] [--schedule auto|index|mapreduce] [--out profile.json]
    python -m ray_shuffling_data_loader_tpu_torch.shuffle_profile --threads 1,2,4   # the host kernels alone
    python -m ray_shuffling_data_loader_tpu_torch.shuffle_profile --decode 1,2      # the Parquet decode alone

The pipeline profile runs the real shuffle (the spawned pool's workers,
the store, the schedule forced by ``--schedule`` through
``RSDL_INDEX_SHUFFLE``) on a cached dataset (``.bench_cache/`` at the
repo's root, or ``--data-dir``) with the per-phase profiler on
(``RSDL_METRICS``, :mod:`.telemetry.phases`), folds the workers' spools
with :func:`.telemetry.export.aggregate`, and prints:

* the phase-cost table: per ``(stage, phase)`` the task count, total and
  mean seconds, bytes moved and GB/s, and that rate's share of the
  single-core copy rate;
* the roofline line: that copy rate and the figures the schedule policy
  models with (:func:`.shuffle._probed_host_costs`);
* the schedule policy's terms and verdicts for the shape, and the
  schedules that ran.

An empty phase table (no phase metric reached the spools) fails with exit
code 1. ``--threads`` times the host kernels (:func:`.native.group_rows_multi`,
:func:`.native.scatter`, :func:`.native.take`) at the map and reduce
tasks' shapes per thread count against the N-thread copy rate.
``--decode`` times the legacy whole-file read and the row-group plan at
each thread count, full and projected, then one epoch of the selective
schedule's decodes under the ``rowwise`` and ``block:1`` plans with their
read amplification. The flags, tables, JSON keys and exit codes are the
JAX package's ``tools/shuffle_profile.py``'s. The tool imports no torch.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import re
import sys
import threading
import time
from typing import List, Optional

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BYTES_PER_ROW = 168  # DATA_SPEC's in-memory row

_KEY_RE = re.compile(
    r"^shuffle\.phase_(seconds|bytes)\{phase=(?P<phase>[^,}]+),"
    r"stage=(?P<stage>[^,}]+)\}(?P<suffix>_count|_sum|_min|_max)?$"
)


def _shuffle_module():
    # The package's root resolves names lazily; the module, not a function.
    return importlib.import_module("ray_shuffling_data_loader_tpu_torch.shuffle")


class _DrainConsumer:
    """Counts and frees the delivered reducer outputs, so that the store's
    residency stays flat and the phases measured are the stage tasks'."""

    def __init__(self):
        self.rows = 0
        self.nbytes = 0

    def consume(self, rank, epoch, batches):
        from ray_shuffling_data_loader_tpu_torch import runtime

        store = runtime.get_context().store
        for ref in batches:
            cb = store.get_columns(ref)
            self.rows += cb.num_rows
            self.nbytes += cb.nbytes
            del cb
            store.free(ref)

    def producer_done(self, rank, epoch):
        pass

    def wait_until_ready(self, epoch):
        pass

    def wait_until_all_epochs_done(self):
        pass


def _memcpy_gbps(nbytes: int = 256 << 20, repeats: int = 3) -> float:
    """The single-core copy rate (read plus write) in GB/s."""
    return _memcpy_gbps_mt(1, nbytes=nbytes, repeats=repeats)


def _memcpy_gbps_mt(threads: int, nbytes: int = 256 << 20, repeats: int = 3) -> float:
    """The N-core copy rate: ``threads`` concurrent ``np.copyto`` passes
    over disjoint buffers (numpy lets go of the GIL for large copies),
    read plus write, best of ``repeats``, in GB/s."""
    per = max(1 << 20, nbytes // threads)
    srcs = [np.arange(per // 8, dtype=np.int64) for _ in range(threads)]
    dsts = [np.empty_like(s) for s in srcs]
    for s, d in zip(srcs, dsts):
        np.copyto(d, s)  # touch every page first
    best = 0.0
    for _ in range(repeats):
        barrier = threading.Barrier(threads + 1)

        def _run(s, d):
            barrier.wait()
            np.copyto(d, s)

        workers = [threading.Thread(target=_run, args=(s, d)) for s, d in zip(srcs, dsts)]
        for w in workers:
            w.start()
        barrier.wait()
        t0 = time.perf_counter()
        for w in workers:
            w.join()
        dt = time.perf_counter() - t0
        best = max(best, 2 * sum(s.nbytes for s in srcs) / max(dt, 1e-9))
    return best / 1e9


def _best_s(fn, repeats: int = 5) -> float:
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def _write_out(path: Optional[str], result: dict, tag: str) -> None:
    if path:
        with open(path, "w") as f:
            json.dump(result, f, indent=2)
        print(f"[{tag}] wrote {path}", file=sys.stderr)


def run_threads_sweep(args, thread_counts: List[int]) -> int:
    """``--threads``: the map task's partition scatter and a reducer's
    permute scatter and gather, per thread count, against the N-thread
    copy rate, apart from the pipeline (no pool, no store)."""
    from ray_shuffling_data_loader_tpu_torch import native
    from ray_shuffling_data_loader_tpu_torch.data_generation import DATA_SPEC

    num_rows = max(1000, int(args.gb * 1e9) // BYTES_PER_ROW)
    task_rows = max(1, num_rows // args.files)
    rng = np.random.default_rng(0)
    # The narrowed map task's batch: every column 4 bytes wide.
    cols = {}
    for name, (low, high, dtype) in DATA_SPEC.items():
        if np.issubdtype(dtype, np.integer):
            cols[name] = rng.integers(low, high, task_rows, dtype=np.int64).astype(np.int32)
        else:
            cols[name] = rng.random(task_rows).astype(np.float32)
    cols["key"] = np.arange(task_rows, dtype=np.int32)
    batch_bytes = sum(v.nbytes for v in cols.values())
    assignment = rng.integers(0, args.reducers, size=task_rows)
    out = {k: np.empty_like(v) for k, v in cols.items()}
    # One reducer's output (the epoch's rows over the reducers), permuted.
    red_rows = max(1, num_rows // args.reducers)
    red_col = rng.integers(0, 1 << 30, size=red_rows).astype(np.int32)
    perm = rng.permutation(red_rows)
    red_out = np.empty_like(red_col)
    available = native.native_available()
    print(f"[sweep] map task: {task_rows} rows x {len(cols)} cols ({batch_bytes / 1e6:.0f} MB narrowed), "
          f"reducer output: {red_rows} rows; native={available}", file=sys.stderr)
    if not available:
        print("[sweep] WARNING: native kernels unavailable — numpy fallbacks ignore n_threads, the sweep will "
              "show no scaling", file=sys.stderr)

    sweep = []
    base = {}
    print()
    print(f"{'threads':>7} {'op':<18} {'GB/s':>7} {'x vs 1':>7} {'roofline GB/s':>13} {'%roof':>6}")
    for t in thread_counts:
        roof = _memcpy_gbps_mt(t)
        ops = {
            "partition-scatter": (
                2 * batch_bytes,
                lambda t=t: native.group_rows_multi(cols, assignment, args.reducers, out=out, n_threads=t),
            ),
            "permute-scatter": (2 * red_col.nbytes, lambda t=t: native.scatter(red_col, perm, red_out, n_threads=t)),
            "gather": (2 * red_col.nbytes, lambda t=t: native.take(red_col, perm, out=red_out, n_threads=t)),
        }
        for op, (nbytes, fn) in ops.items():
            gbps = nbytes / _best_s(fn) / 1e9
            base.setdefault(op, gbps)
            speedup = gbps / base[op]
            print(f"{t:>7d} {op:<18} {gbps:>7.2f} {speedup:>6.2f}x {roof:>13.2f} {100 * gbps / roof:>5.1f}%")
            sweep.append({"threads": t, "op": op, "gbps": round(gbps, 3), "speedup_vs_1": round(speedup, 3),
                          "memcpy_roofline_gbps": round(roof, 3), "roofline_frac": round(gbps / roof, 4)})
    result = {
        "mode": "threads-sweep",
        "shape": {"gb": args.gb, "files": args.files, "reducers": args.reducers, "task_rows": task_rows,
                  "batch_mb": round(batch_bytes / 1e6, 1)},
        "host_cpus": os.cpu_count(),
        "native": available,
        "sweep": sweep,
    }
    _write_out(args.out, result, "sweep")
    return 0


def run_decode_sweep(args, thread_counts: List[int]) -> int:
    """``--decode``: the Parquet decode alone, in this process. The legacy
    whole-file read, then the row-group plan (every group named) at each
    thread count, full and projected to a staging-like set of columns
    (its rows also give the bytes the projection never decoded); then one
    epoch of the selective schedule's decodes under the ``rowwise`` and
    ``block:1`` plans, from the reduce tasks' own planning
    (:func:`.shuffle.selective_file_selection`), with the row groups each
    reducer decoded and the read amplification."""
    from ray_shuffling_data_loader_tpu_torch import runtime
    from ray_shuffling_data_loader_tpu_torch.data_generation import cached_generate_data

    shuffle_mod = _shuffle_module()
    runtime.init(num_workers=2)
    num_rows = max(1000, int(args.gb * 1e9) // BYTES_PER_ROW)
    data_dir = args.data_dir or os.path.join(_REPO, ".bench_cache", f"decode_r{num_rows}_f{args.files}_g8")
    os.makedirs(data_dir, exist_ok=True)
    filenames, dataset_bytes = cached_generate_data(num_rows, args.files, 8, data_dir, seed=0)
    # The sweep runs in this process: the pool goes first, so that no idle
    # worker shares the cores it times.
    runtime.shutdown()
    proj = ["embeddings_name0", "one_hot0", "labels", "key"]
    projections = {"full": None, "projected": proj}
    print(f"[decode] dataset {dataset_bytes / 1e9:.2f} GB on disk, {num_rows} rows x {args.files} files, "
          f"{len(shuffle_mod.file_row_group_sizes(filenames[0]))} row groups/file", file=sys.stderr)
    print()
    print(f"{'threads':>7} {'projection':<10} {'decoded GB':>10} {'best s':>8} {'GB/s':>7} {'x vs 1':>7} "
          f"{'pruned GB':>10}")
    sweep = []
    base: dict = {}
    groups_of = {fname: list(range(len(shuffle_mod.file_row_group_sizes(fname)))) for fname in filenames}
    # pyarrow's whole-file read uses Arrow's IO threads even with
    # use_threads=False: it is no single-core figure, and stands apart.
    legacy = 0

    def _legacy():
        nonlocal legacy
        legacy = 0
        for fname in filenames:
            cb = shuffle_mod.read_parquet_columns(fname)
            legacy += cb.nbytes
            del cb

    lbest = _best_s(_legacy, repeats=5)
    print(f"{'-':>7} {'legacy':<10} {legacy / 1e9:>10.3f} {lbest:>8.3f} {legacy / lbest / 1e9:>7.2f} {'-':>7} "
          f"{0.0:>10.3f}")
    sweep.append({"threads": 0, "projection": "legacy-read-table", "decoded_gb": round(legacy / 1e9, 4),
                  "best_s": round(lbest, 4), "gbps": round(legacy / lbest / 1e9, 3)})
    for t in thread_counts:
        for label, cols in projections.items():
            decoded = 0

            def _run(cols=cols, t=t):
                nonlocal decoded
                decoded = 0
                for fname in filenames:
                    cb = shuffle_mod.read_parquet_columns(fname, columns=cols, row_groups=groups_of[fname],
                                                          rowgroup_threads=t)
                    decoded += cb.nbytes
                    del cb

            best = _best_s(_run, repeats=5)
            gbps = decoded / best / 1e9
            base.setdefault(label, gbps)
            # Pruned: the whole decode's bytes less the projection's.
            pruned = 0
            if cols is not None and "full" in base:
                pruned = max(0, int(sweep[0]["decoded_gb"] * 1e9 - decoded))
            row = {"threads": t, "projection": label, "decoded_gb": round(decoded / 1e9, 4),
                   "best_s": round(best, 4), "gbps": round(gbps, 3), "speedup_vs_1": round(gbps / base[label], 3),
                   "pruned_gb": round(pruned / 1e9, 4)}
            sweep.append(row)
            print(f"{t:>7d} {label:<10} {row['decoded_gb']:>10.3f} {best:>8.3f} {gbps:>7.2f} "
                  f"{row['speedup_vs_1']:>6.2f}x {row['pruned_gb']:>10.3f}")
    # One epoch of the selective schedule: rowwise re-reads a group for
    # about every reducer; block:1's selections are disjoint, each group
    # decoded once (amplification 1).
    phys_groups = sum(len(shuffle_mod.file_row_group_sizes(f)) for f in filenames)
    reducers = args.reducers
    full_bytes = sweep[0]["decoded_gb"] * 1e9
    selective_sweep = []
    print()
    print(f"{'plan':>9} {'decoded GB':>10} {'pruned GB':>10} {'groups':>7} {'amp':>6} {'best s':>8}  groups/reducer")
    for plan in (("rowwise", 0), ("block", 1)):
        label = plan[0] if plan[0] == "rowwise" else f"block:{plan[1]}"
        decoded = 0
        groups_per_reducer = [0] * reducers

        def _epoch(plan=plan):
            nonlocal decoded
            decoded = 0
            for r in range(reducers):
                groups_per_reducer[r] = 0
                for i, fname in enumerate(filenames):
                    gsel, _pos = shuffle_mod.selective_file_selection(fname, i, r, reducers, 0, 0, plan)
                    groups_per_reducer[r] += len(gsel)
                    cb = shuffle_mod.read_parquet_columns(fname, row_groups=[int(g) for g in gsel],
                                                          rowgroup_threads=1)
                    decoded += cb.nbytes
                    del cb

        best = _best_s(_epoch, repeats=3)
        groups_total = sum(groups_per_reducer)
        # Pruned against the worst case: every reducer decodes every file.
        pruned = max(0, int(reducers * full_bytes - decoded))
        row = {"plan": label, "decoded_gb": round(decoded / 1e9, 4), "pruned_gb": round(pruned / 1e9, 4),
               "groups_touched": groups_total, "groups_per_reducer": groups_per_reducer[:],
               "physical_groups": phys_groups, "amplification": round(groups_total / phys_groups, 3),
               "best_s": round(best, 4)}
        selective_sweep.append(row)
        print(f"{label:>9} {row['decoded_gb']:>10.3f} {row['pruned_gb']:>10.3f} {groups_total:>7d} "
              f"{row['amplification']:>5.2f}x {best:>8.3f}  {groups_per_reducer}")
    result = {
        "mode": "decode-sweep",
        "shape": {"gb": args.gb, "files": args.files, "rows": num_rows,
                  "row_groups_per_file": len(shuffle_mod.file_row_group_sizes(filenames[0])), "projection": proj},
        "host_cpus": os.cpu_count(),
        "dataset_disk_gb": round(dataset_bytes / 1e9, 3),
        "sweep": sweep,
        "selective_sweep": {"reducers": reducers, "physical_groups": phys_groups, "rows": selective_sweep},
    }
    _write_out(args.out, result, "decode")
    return 0


def _phase_table(flat: dict) -> dict:
    """``{(stage, phase): {count, total_s, bytes}}`` from an aggregated
    flat snapshot."""
    table: dict = {}
    for key, value in flat.items():
        m = _KEY_RE.match(key)
        if not m:
            continue
        entry = table.setdefault((m.group("stage"), m.group("phase")), {"count": 0, "total_s": 0.0, "bytes": 0.0})
        kind, suffix = m.group(1), m.group("suffix")
        if kind == "seconds" and suffix == "_count":
            entry["count"] = int(value)
        elif kind == "seconds" and suffix == "_sum":
            entry["total_s"] = float(value)
        elif kind == "bytes" and not suffix:
            entry["bytes"] = float(value)
    return table


def run_profile(args) -> int:
    """The pipeline profile (module docstring)."""
    if args.schedule != "auto":
        os.environ["RSDL_INDEX_SHUFFLE"] = "on" if args.schedule == "index" else "off"
    shuffle_mod = _shuffle_module()
    from ray_shuffling_data_loader_tpu_torch import runtime
    from ray_shuffling_data_loader_tpu_torch.data_generation import cached_generate_data
    from ray_shuffling_data_loader_tpu_torch.telemetry import export as _export

    num_rows = max(1000, int(args.gb * 1e9) // BYTES_PER_ROW)
    data_dir = args.data_dir or os.path.join(_REPO, ".bench_cache", f"profile_r{num_rows}_f{args.files}")
    os.makedirs(data_dir, exist_ok=True)
    filenames, dataset_bytes = cached_generate_data(num_rows, args.files, 2, data_dir, seed=0)
    print(f"[profile] dataset {dataset_bytes / 1e9:.2f} GB on disk, {num_rows} rows x {args.files} files",
          file=sys.stderr)

    ctx = runtime.init(num_workers=max(2, os.cpu_count() or 1))
    consumer = _DrainConsumer()
    schedule_log: list = []
    t0 = time.perf_counter()
    shuffle_mod.shuffle(list(filenames), consumer, num_epochs=args.epochs, num_reducers=args.reducers,
                        num_trainers=args.trainers, seed=0, narrow_to_32=args.narrow, schedule_log=schedule_log)
    wall_s = time.perf_counter() - t0
    pool = ctx.pool
    print(f"[profile] pool: {pool.num_workers} workers (os.cpu_count() {os.cpu_count()}), ready_s {pool.ready_s}",
          file=sys.stderr)

    flat = _export.aggregate()
    table = _phase_table(flat)
    copy_gbps = _memcpy_gbps()
    probed = shuffle_mod._probed_host_costs()

    est_cache = None
    try:
        est_cache = shuffle_mod._est_decoded_bytes(list(filenames), args.narrow)
    except OSError:
        pass
    cache_auto = shuffle_mod._decode_cache_auto(list(filenames), args.epochs, args.narrow)
    index_auto = shuffle_mod._index_schedule_allowed(list(filenames), args.reducers, args.narrow)
    policy = {
        "est_decoded_bytes": est_cache,
        "decode_cache_auto": bool(cache_auto),
        "index_schedule_auto": bool(index_auto),
        "probed_costs": {k: float(v) for k, v in probed.items()},
        "gather_bw_at_cache": shuffle_mod._gather_bw_for(est_cache) if est_cache else None,
        "schedules_run": [s for _, s in schedule_log],
    }

    rows = []
    print()
    print(f"{'stage':<14} {'phase':<18} {'n':>5} {'total s':>9} {'mean s':>8} {'GB':>8} {'GB/s':>7} {'%roofline':>9}")
    for stage, phase in sorted(table, key=lambda sp: -table[sp]["total_s"]):
        e = table[(stage, phase)]
        gb = e["bytes"] / 1e9
        gbps = gb / e["total_s"] if e["total_s"] > 0 else 0.0
        frac = 100.0 * gbps / copy_gbps if copy_gbps else 0.0
        mean = e["total_s"] / e["count"] if e["count"] else 0.0
        print(f"{stage:<14} {phase:<18} {e['count']:>5d} {e['total_s']:>9.2f} {mean:>8.3f} {gb:>8.2f} "
              f"{gbps:>7.2f} {frac:>8.1f}%")
        rows.append({"stage": stage, "phase": phase, "count": e["count"], "total_s": round(e["total_s"], 3),
                     "mean_s": round(mean, 4), "gb": round(gb, 3), "gbps": round(gbps, 3),
                     "roofline_frac": round(gbps / copy_gbps, 4) if copy_gbps else None})
    phase_total = sum(e["total_s"] for e in table.values())
    print(f"\n[profile] wall {wall_s:.1f}s; phase-accounted task time {phase_total:.1f}s across all workers; "
          f"delivered {consumer.nbytes / 1e9:.2f} GB ({consumer.rows} rows); pipeline "
          f"{consumer.nbytes / 1e9 / wall_s:.3f} GB/s")
    print(f"[profile] roofline: single-core memcpy {copy_gbps:.2f} GB/s (r+w); probe copy "
          f"{probed['copy'] / 1e9:.2f}, gather {probed['gather_small'] / 1e9:.2f} (cache-res) / "
          f"{probed['gather_large'] / 1e9:.2f} (DRAM) GB/s, store round-trip {probed['roundtrip'] * 1e3:.2f} ms")
    print(f"[profile] schedule policy: {json.dumps(policy)}")

    result = {
        "shape": {"gb": args.gb, "files": args.files, "reducers": args.reducers, "epochs": args.epochs,
                  "narrow": bool(args.narrow), "schedule_arg": args.schedule},
        "wall_s": round(wall_s, 2),
        "pipeline_gbps": round(consumer.nbytes / 1e9 / wall_s, 4),
        "delivered_gb": round(consumer.nbytes / 1e9, 3),
        "memcpy_roofline_gbps": round(copy_gbps, 3),
        "phases": rows,
        "policy": policy,
    }
    _write_out(args.out, result, "profile")
    runtime.shutdown()
    if not table:
        print("[profile] ERROR: no shuffle.phase_* metric reached the spools (is RSDL_METRICS off?)",
              file=sys.stderr)
        return 1
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--gb", type=float, default=0.5)
    parser.add_argument("--files", type=int, default=8)
    parser.add_argument("--reducers", type=int, default=8)
    parser.add_argument("--epochs", type=int, default=3)
    parser.add_argument("--trainers", type=int, default=1)
    parser.add_argument("--narrow", action="store_true")
    parser.add_argument("--schedule", choices=("auto", "index", "mapreduce"), default="auto",
                        help="force the steady-state schedule (sets RSDL_INDEX_SHUFFLE)")
    parser.add_argument("--data-dir", default=None,
                        help="dataset cache dir (default: .bench_cache/profile_* shape key)")
    parser.add_argument("--threads", default=None,
                        help="comma list of kernel thread counts (e.g. 1,2,4): run the ISOLATED kernel sweep "
                        "(partition scatter / permute scatter / gather at the bench task shape vs the N-core "
                        "memcpy roofline) instead of the pipeline profile")
    parser.add_argument("--decode", default=None,
                        help="comma list of decode thread counts (e.g. 1,2): run the ISOLATED Parquet decode "
                        "sweep (row-group-parallel plan, full vs projected decode, pruned bytes) instead of the "
                        "pipeline profile")
    parser.add_argument("--out", default=None, help="also dump JSON here")
    args = parser.parse_args(argv)
    # Before the runtime: the pool's workers inherit the environment.
    os.environ.setdefault("RSDL_METRICS", "1")
    if args.threads:
        return run_threads_sweep(args, [int(x) for x in args.threads.split(",") if x])
    if args.decode:
        return run_decode_sweep(args, [int(x) for x in args.decode.split(",") if x])
    return run_profile(args)


if __name__ == "__main__":
    sys.exit(main())
