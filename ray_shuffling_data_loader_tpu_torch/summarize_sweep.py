"""The multi-trainer sweep's Markdown table, from its per-configuration
results.

    python -m ray_shuffling_data_loader_tpu_torch.summarize_sweep

Reads every ``t<trainers>_r<reducers>.json`` summary under :data:`OUT`
(a ``process_stats`` summary: ``duration_mean``, ``row_throughput_mean``)
and the first row of each one's ``stats_t<T>_r<R>/trial_stats.csv``, and
prints one table row per configuration, sorted by trainers and reducers.
A missing figure prints as ``nan``. The table, the directory and the exit
code are the JAX package's ``tools/summarize_sweep.py``'s: :data:`OUT` is
the repo's ``tools/sweep_results``.
"""

from __future__ import annotations

import csv
import glob
import json
import os
import re
import sys

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools", "sweep_results")


def main() -> int:
    rows = []
    for path in sorted(glob.glob(os.path.join(OUT, "t*_r*.json"))):
        tag = os.path.basename(path)[:-5]
        m = re.match(r"t(\d+)_r(\d+)", tag)
        if not m:
            continue
        trainers, reducers = int(m.group(1)), int(m.group(2))
        with open(path) as f:
            summary = json.loads(f.read().strip() or "{}")
        trial_csv = os.path.join(OUT, f"stats_{tag}", "trial_stats.csv")
        extra = {}
        if os.path.exists(trial_csv):
            with open(trial_csv) as f:
                recs = list(csv.DictReader(f))
            if recs:
                r0 = recs[0]
                extra = {
                    "per_trainer": float(r0["batch_throughput_per_trainer"]),
                    "map_avg": float(r0["avg_map_stage_duration"]),
                    "reduce_avg": float(r0["avg_reduce_stage_duration"]),
                    "consume_avg": float(r0["avg_consume_stage_duration"]),
                    "store_peak_gb": float(r0["max_object_store_utilization"]) / 1e9,
                }
        rows.append((trainers, reducers, summary, extra))
    rows.sort(key=lambda r: (r[0], r[1]))
    print("| trainers | reducers | trial s | rows/s | batches/s/trainer "
          "| map avg s | reduce avg s | consume avg s | peak store GB |")
    print("|---|---|---|---|---|---|---|---|---|")
    for trainers, reducers, s, e in rows:
        print(
            f"| {trainers} | {reducers} "
            f"| {s.get('duration_mean', float('nan')):.0f} "
            f"| {s.get('row_throughput_mean', float('nan')):,.0f} "
            f"| {e.get('per_trainer', float('nan')):.3f} "
            f"| {e.get('map_avg', float('nan')):.1f} "
            f"| {e.get('reduce_avg', float('nan')):.1f} "
            f"| {e.get('consume_avg', float('nan')):.1f} "
            f"| {e.get('store_peak_gb', float('nan')):.1f} |"
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
