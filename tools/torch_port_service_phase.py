#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s ``[service]`` phase alone on the GPU: two tenants'
DLRM trainers through one session of the multi-job service, in a few
minutes instead of the whole script's.

    python3 tools/torch_port_service_phase.py [--out results.json]

Builds the kernels, writes the Quick-start dataset (10^6 rows, 10 files,
5 row groups, seed 0) under ``build/service_phase/data``, trains the
deterministic DLRM slice on one host (the reference whose staged tensors and
losses the weight-2 tenant must equal, as the cluster phase's one-host run
is in the whole script), then runs :func:`chip_smoke.phase_service` (its
head process) with its spools under ``build/service_phase/service``. Exits
non-zero if any check fails. Prints the card's name and power limit first.
"""

import argparse
import copy
import json
import os
import shutil
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="also write the phase's results as JSON here")
    args = parser.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as cs
    import ray_shuffling_data_loader_tpu_torch as port

    if not torch.cuda.is_available():
        print("torch_port_service_phase: no CUDA device is available", file=sys.stderr)
        return 2
    print(cs.smi_name_and_limit(), flush=True)
    torch.use_deterministic_algorithms(True, warn_only=True)
    cs.phase_build()
    work = os.path.join(ROOT, "build", "service_phase")
    shutil.rmtree(work, ignore_errors=True)
    files, _ = port.generate_data(cs.NUM_ROWS, 10, 5, 0.0, os.path.join(work, "data"), seed=0)
    port.runtime.shutdown()  # the generation's session: the runs start their own
    model = port.dlrm_for_data_spec()  # this process's first model: the head's first
    init_state = copy.deepcopy(model.state_dict())
    port.runtime.init()
    try:
        cs.start_pool(port)
        reference = cs.cluster_run(torch, port, files, "reference", model, init_state)
    finally:
        port.runtime.shutdown()
    os.makedirs(os.path.join(work, "service"))
    try:
        res = cs.phase_service(torch, files, {"single": reference}, os.path.join(work, "service"))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f)
    print("service phase ok", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
