#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s ``[elastic]`` phase alone on the GPU: the elastic
control loop (evictor, drain, autoscaler) on two hosts under a store
budget, in a few minutes instead of the whole script's.

    python3 tools/torch_port_elastic_phase.py [--out results.json]

Builds the kernels, writes the Quick-start dataset (10^6 rows, 10 files,
5 row groups, seed 0) under ``build/elastic_phase/data``, trains the
deterministic DLRM slice on one host (the reference whose staged tensors
and losses the two-host run must equal, and whose store peak sizes the
budget), then runs :func:`chip_smoke.phase_elastic` (its head process and
a joined host) with its spools under ``build/elastic_phase/elastic``,
``--runs`` times (default 1; a failed run is reported and the next one
runs). Exits non-zero if any check of any run fails. Prints the card's
name and power limit first.
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
    parser.add_argument("--out", help="also write the phase's results as JSON here (a list, one per run)")
    parser.add_argument("--runs", type=int, default=1, help="how many times to run the phase")
    args = parser.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as cs
    import ray_shuffling_data_loader_tpu_torch as port

    if not torch.cuda.is_available():
        print("torch_port_elastic_phase: no CUDA device is available", file=sys.stderr)
        return 2
    print(cs.smi_name_and_limit(), flush=True)
    torch.use_deterministic_algorithms(True, warn_only=True)
    cs.phase_build()
    work = os.path.join(ROOT, "build", "elastic_phase")
    shutil.rmtree(work, ignore_errors=True)
    files, _ = port.generate_data(cs.NUM_ROWS, 10, 5, 0.0, os.path.join(work, "data"), seed=0)
    port.runtime.shutdown()  # the generation's session: the runs start their own
    model = port.dlrm_for_data_spec()
    init_state = copy.deepcopy(model.state_dict())
    port.runtime.init()
    try:
        cs.start_pool(port)
        reference = cs.cluster_run(torch, port, files, "reference", model, init_state)
    finally:
        port.runtime.shutdown()
    results, failed = [], 0
    try:
        for i in range(args.runs):
            run_dir = os.path.join(work, f"elastic{i}")
            os.makedirs(run_dir)
            try:
                results.append(cs.phase_elastic(torch, files, {"single": reference}, run_dir))
            except AssertionError as exc:
                failed += 1
                results.append({"error": str(exc)})
                print(f"elastic phase run {i} failed: {exc}", flush=True)
            finally:
                shutil.rmtree(run_dir, ignore_errors=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f)
    print(f"elastic phase: {args.runs - failed} of {args.runs} runs ok", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
