#!/usr/bin/env python3
"""Split the telemetry planes' cost on the port's delivery path: the
shuffle's seconds per epoch with every plane off, with metrics and trace
on, with the time series added, with the profiler added, and with every
plane on (``chip_smoke._planes_env``), in turns.

    python3 tools/torch_port_planes_cost.py [rounds]

Writes the Quick-start dataset (10^6 rows, 10 files, 5 row groups, seed
0) under ``build/planes_cost/data``, then for each of ``rounds`` rounds
(default 3) runs each configuration once, the order rotating a step each
round: a fresh session and pool, two epochs of delivery only through
``DeviceShufflingDataset`` on the GPU (``chip_smoke.cluster_run``: batch
65536, 8 reducers), every staged tensor held to the first run's. Prints
one ``COST`` line a run and one ``SUMMARY`` line a configuration (each
epoch's seconds, run by run). Prints the card's name and power limit
first. Needs a GPU.
"""

import os
import shutil
import statistics
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def configurations(spool: str) -> dict:
    import chip_smoke as cs

    every = cs._planes_env(spool)
    base = {k: every[k] for k in ("RSDL_METRICS", "RSDL_TRACE", "RSDL_TRACE_DIR", "RSDL_METRICS_DIR",
                                  "RSDL_EVENTS_DIR")}
    return {
        "off": {},
        "metrics+trace": base,
        "+timeseries": {**base, **{k: every[k] for k in ("RSDL_TS", "RSDL_TS_PERIOD_S")}},
        "+profiler": {**base, **{k: every[k] for k in ("RSDL_PROFILE", "RSDL_PROFILE_DIR")}},
        "all": every,
    }


def main(rounds: int) -> int:
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as cs
    import ray_shuffling_data_loader_tpu_torch as port

    if not torch.cuda.is_available():
        print("torch_port_planes_cost: no CUDA device is available", file=sys.stderr)
        return 2
    print(cs.smi_name_and_limit(), flush=True)
    work = os.path.join(ROOT, "build", "planes_cost")
    shutil.rmtree(work, ignore_errors=True)
    files, _ = port.generate_data(cs.NUM_ROWS, 10, 5, 0.0, os.path.join(work, "data"), seed=0)
    port.runtime.shutdown()
    names = list(configurations(work))
    seconds = {name: [] for name in names}
    first = None
    for r in range(rounds):
        for k in range(len(names)):
            name = names[(k + r) % len(names)]
            with cs._planes(port, configurations(os.path.join(work, f"{name}-{r}"))[name]):
                port.runtime.init()
                try:
                    cs.start_pool(port)
                    run = cs.cluster_run(torch, port, files, f"{name}-{r}", tag="cost")
                finally:
                    port.runtime.shutdown()
            if first is None:
                first = run["digests"]
            elif run["digests"] != first:
                raise AssertionError(f"{name} round {r}: staged tensors differ from the first run's")
            seconds[name].append(run["epoch_shuffle_s"])
            print(f"COST {name} round {r}: shuffle s per epoch {run['epoch_shuffle_s']!r}", flush=True)
    for name in names:
        runs = seconds[name]
        print(f"SUMMARY {name}: epoch 0 {[round(x[0], 4) for x in runs]} (median "
              f"{statistics.median(x[0] for x in runs):.4f}); epoch 1 {[round(x[1], 4) for x in runs]} (median "
              f"{statistics.median(x[1] for x in runs):.4f})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(int(sys.argv[1]) if len(sys.argv) > 1 else 3))
