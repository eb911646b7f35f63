#!/usr/bin/env python3
"""Time the port's map and reduce tasks of cache-hot epochs in the worker
pool, for one checkout of the repo, with the host kernels on and off and
the reduce's partitions mapped populated or not, in turns.

    python3 tools/torch_port_stage_profile.py <checkout root> [epochs]

Writes the Quick-start dataset (10^6 rows, 10 files, 5 row groups, seed 0)
under ``<root>/build/stage_data``, decodes each file once into the decode
cache, then runs ``epochs`` (default 6) cache-hot epochs of 10 maps and 8
reduces per mode in turns, each task timed inside its worker. Prints one
``STAGE`` line per mode: the median map and reduce task, and the median
wall of each stage. A checkout without host kernels (a parent) runs one
mode. It needs no GPU.
"""

import os
import sys
import time

# (label, host kernels on, the reduce's partitions mapped populated)
MODES = (("native, populated", True, True), ("numpy, populated", False, True),
         ("native, unpopulated", True, False), ("numpy, unpopulated", False, False))


def timed(native_on, populate, fn, *args):
    """Run ``fn(*args)`` in a worker as ``mode`` says; returns ``(result,
    seconds)``."""
    from ray_shuffling_data_loader_tpu_torch.runtime.store import ObjectStore

    try:
        from ray_shuffling_data_loader_tpu_torch import native

        native.set_enabled(native_on)
    except ImportError:  # a checkout from before the host kernels
        pass
    get_columns = ObjectStore.get_columns
    if not populate:
        ObjectStore.get_columns = lambda self, ref, populate=False: get_columns(self, ref, False)
    try:
        t0 = time.perf_counter()
        out = fn(*args)
        return out, time.perf_counter() - t0
    finally:
        ObjectStore.get_columns = get_columns


def main(root: str, epochs: int) -> int:
    sys.path.insert(0, os.path.abspath(root))
    import shutil

    import numpy as np

    import ray_shuffling_data_loader_tpu_torch.shuffle as S
    from ray_shuffling_data_loader_tpu_torch import runtime
    from ray_shuffling_data_loader_tpu_torch.data_generation import generate_data

    modes = MODES if os.path.isdir(os.path.join(root, "ray_shuffling_data_loader_tpu_torch", "native")) else (
        ("parent", True, True),)
    data_dir = os.path.join(root, "build", "stage_data")
    shutil.rmtree(data_dir, ignore_errors=True)
    ctx = runtime.init(8)
    store, pool = ctx.store, ctx.pool
    try:
        files, _ = generate_data(10**6, 10, 5, 0.0, data_dir, seed=0)
        first = [pool.submit(S.shuffle_map, f, i, 8, 0, 0, True, None, True).result() for i, f in enumerate(files)]
        caches = [cache for _, cache in first]
        for refs, _ in first:
            store.free(refs)
        res = {label: {"map": [], "reduce": [], "map_wall": [], "reduce_wall": []} for label, _, _ in modes}
        for epoch in range(1, epochs + 1):
            for label, native_on, populate in modes:
                t0 = time.perf_counter()
                maps = [pool.submit(timed, native_on, populate, S.shuffle_map, f, i, 8, epoch, 0, True, caches[i],
                                    False) for i, f in enumerate(files)]
                maps = [f.result() for f in maps]
                t1 = time.perf_counter()
                parts = [refs for refs, _ in maps]
                reds = [pool.submit(timed, native_on, populate, S.shuffle_reduce, r, epoch, 0,
                                    [p[r] for p in parts]) for r in range(8)]
                reds = [f.result() for f in reds]
                t2 = time.perf_counter()
                r = res[label]
                r["map"] += [s for _, s in maps]
                r["reduce"] += [s for _, s in reds]
                r["map_wall"].append(t1 - t0)
                r["reduce_wall"].append(t2 - t1)
                for p in parts:
                    store.free(p)
                for out, _ in reds:
                    store.free(out if isinstance(out, list) else [out])
        store.free(caches)
        for label, r in res.items():
            print(f"STAGE {root} {label}: map task median {np.median(r['map']) * 1e3:.1f} ms, reduce task median "
                  f"{np.median(r['reduce']) * 1e3:.1f} ms; map stage median {np.median(r['map_wall']) * 1e3:.1f} ms, "
                  f"reduce stage median {np.median(r['reduce_wall']) * 1e3:.1f} ms ({epochs} epochs)", flush=True)
    finally:
        runtime.shutdown()
        shutil.rmtree(data_dir, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], int(sys.argv[2]) if len(sys.argv) > 2 else 6))
