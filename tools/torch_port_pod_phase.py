#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s ``[pod]`` phase alone on the GPU: the pod
trainer (``pod.py --simulate-pod 4 --loader resident --backend gloo``) as
four processes on ``cuda:0``, in a couple of minutes instead of the whole
script's.

    python3 tools/torch_port_pod_phase.py [--out results.json]

Builds the kernels, holds K1 at a rank's shard ``(16384, 19, 32)`` against
its plain version, writes the Quick-start dataset (10^6 rows, 10 files, 5
row groups, seed 0) under ``build/pod_phase/data`` and runs
:func:`chip_smoke.phase_pod` with its ranks' files under
``build/pod_phase/pod``. Exits non-zero if any check fails. Prints the
card's name and power limit first.
"""

import argparse
import json
import os
import shutil
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="also write the phase's results as JSON here")
    args = parser.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as cs
    import ray_shuffling_data_loader_tpu_torch as port
    from ray_shuffling_data_loader_tpu_torch.ops.interaction import dot_interaction_reference, interaction_kernel

    if not torch.cuda.is_available():
        print("torch_port_pod_phase: no CUDA device is available", file=sys.stderr)
        return 2
    smi = cs.smi_name_and_limit()
    print(smi, flush=True)
    cs.phase_build()
    x = (torch.randn(cs.POD_SHAPE, device="cuda") / cs.POD_SHAPE[2] ** 0.5).to(torch.bfloat16)
    got, want = interaction_kernel(x, "mma"), dot_interaction_reference(x)
    torch.testing.assert_close(got.float(), want.float(), **cs.BF16_TOL)
    print(f"[kernel] interaction (mma) {cs.POD_SHAPE} bf16: max |kernel - plain| = "
          f"{(got.float() - want.float()).abs().max().item()!r}", flush=True)
    work = os.path.join(ROOT, "build", "pod_phase")
    shutil.rmtree(work, ignore_errors=True)
    data_dir = os.path.join(work, "data")
    t0 = time.perf_counter()
    files, _ = port.generate_data(cs.NUM_ROWS, 10, 5, 0.0, data_dir, seed=0)
    port.runtime.shutdown()  # the generation's session: the phase starts its own
    print(f"[pod] generated in {time.perf_counter() - t0:.1f} s", flush=True)
    os.makedirs(os.path.join(work, "pod"))
    try:
        res = cs.phase_pod(torch, files, data_dir, smi, os.path.join(work, "pod"))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f)
    print("pod phase ok", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
