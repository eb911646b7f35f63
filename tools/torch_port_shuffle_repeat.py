#!/usr/bin/env python3
"""Time the port's shuffle alone, with a consumer that frees each output as
it lands, for one checkout of the repo: the host side of delivery with no
trainer setting its pace.

    python3 tools/torch_port_shuffle_repeat.py <checkout root> <repeats> [ENV=VALUE ...]

Writes the Quick-start dataset (10^6 rows, 10 files, 5 row groups, seed 0)
under ``<root>/build/shuffle_data`` and runs ``shuffle()`` of that
checkout ``<repeats>`` times in one session (4 epochs, 8 reducers, one
rank, narrowed to 32 bits, the decode cache on), with the given
environment, printing one ``SHUFFLE`` line per repeat (each epoch's
seconds and schedule) and one ``STAGES`` line per epoch (the map and
reduce stages' seconds, first start to last end, and their tasks' median
ms, from a ``TrialStatsCollector``). Run a parent and a change checkout in turns in one
call to compare them; it needs no GPU.
"""

import os
import shutil
import sys


def main(root: str, reps: int, env: dict) -> int:
    sys.path.insert(0, os.path.abspath(root))
    os.environ.update(env)
    import numpy as np

    from ray_shuffling_data_loader_tpu_torch import runtime
    from ray_shuffling_data_loader_tpu_torch.data_generation import generate_data
    from ray_shuffling_data_loader_tpu_torch.shuffle import BatchConsumer, shuffle
    from ray_shuffling_data_loader_tpu_torch.stats import TrialStatsCollector

    class Drain(BatchConsumer):
        def consume(self, rank, epoch, batches):
            runtime.get_context().store.free(batches)

        def producer_done(self, rank, epoch):
            pass

        def wait_until_ready(self, epoch):
            pass

        def wait_until_all_epochs_done(self):
            pass

    data_dir = os.path.join(root, "build", "shuffle_data")
    shutil.rmtree(data_dir, ignore_errors=True)
    runtime.init()
    try:
        files, _ = generate_data(10**6, 10, 5, 0.0, data_dir, seed=0)
        for r in range(reps):
            stats, log = {}, []
            collector = runtime.spawn_actor(TrialStatsCollector, 4, len(files), 8, 10**6)
            shuffle(files, Drain(), 4, 8, 1, seed=0, narrow_to_32=True, cache_decoded=True, stats=stats,
                    schedule_log=log, stats_collector=collector)
            trial = collector.call("get_stats", 60)
            collector.terminate()
            label = " ".join(f"{k}={v}" for k, v in env.items()) or "defaults"
            print(f"SHUFFLE {root} {label} rep {r}: {stats['epoch_shuffle_s']!r} s per epoch "
                  f"({[s for _, s in log]})", flush=True)
            for e in trial.epochs:
                print(f"STAGES {root} {label} rep {r} epoch {e.epoch}: map stage {e.map_stage_duration:.4f} s "
                      f"(task median {np.median(e.map_durations) * 1e3:.1f} ms), reduce stage "
                      f"{e.reduce_stage_duration:.4f} s (task median {np.median(e.reduce_durations) * 1e3:.1f} ms)",
                      flush=True)
    finally:
        runtime.shutdown()
        shutil.rmtree(data_dir, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], int(sys.argv[2]), dict(a.split("=", 1) for a in sys.argv[3:])))
