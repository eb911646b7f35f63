#!/usr/bin/env python3
"""Repeat ``chip_smoke.py``'s single-rank DLRM slice to measure the spread
of its step median on one NVIDIA GPU, for one checkout of the repo.

    python3 tools/torch_port_slice_repeat.py <checkout root> <repeats>

Writes the Quick-start dataset (10^6 rows, 10 files, 5 row groups) under
``<root>/build/exp_data`` and runs ``train_slice`` of that checkout's
``chip_smoke.py`` ``<repeats>`` times in one session (2 epochs, batch
65536, 8 reducers each), printing one ``EXP`` line per repeat: the step
median, each epoch's wall and shuffle seconds with its schedule, and the
trainer's stall. Run a
parent and a change checkout in turns in one call to compare them; each run needs the card (it exits non-zero without one).
"""

import importlib.util
import os
import shutil
import sys


def main(root: str, reps: int) -> int:
    sys.path.insert(0, os.path.abspath(root))
    import torch

    spec = importlib.util.spec_from_file_location("chip_smoke_of_root", os.path.join(root, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import ray_shuffling_data_loader_tpu_torch as port

    data_dir = os.path.join(root, "build", "exp_data")
    shutil.rmtree(data_dir, ignore_errors=True)
    port.runtime.init()
    try:
        files, _ = port.generate_data(10**6, 10, 5, 0.0, data_dir, seed=0)
        for r in range(reps):
            out = smoke.train_slice(torch, port, files, 10**6, port.dlrm_for_data_spec(), f"dlrm-{r}")
            print(f"EXP {root} rep {r}: step median {out['step_ms_median']:.3f} ms, "
                  f"epochs {[round(e, 4) for e in out['epoch_s']]}, shuffle "
                  f"{out['delivery']['epoch_shuffle_s']!r} s per epoch ({out['delivery']['schedules']}), "
                  f"stall {out['staging']['stall_s']!r} s", flush=True)
    finally:
        port.runtime.shutdown()
        shutil.rmtree(data_dir, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], int(sys.argv[2])))
