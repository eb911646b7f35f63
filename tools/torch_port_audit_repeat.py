#!/usr/bin/env python3
"""Measure what the audit plane costs on the port's DLRM slice on one
NVIDIA GPU: ``chip_smoke.py``'s single-rank DLRM slice with the audit off
and on, in turns (off, on, on, off per repeat), each in a session of its
own whose worker pool is up before the run starts.

    python3 tools/torch_port_audit_repeat.py <repeats>

Writes the Quick-start dataset (10^6 rows, 10 files, 5 row groups) under
``build/audit_repeat`` and prints one ``EXP`` line per run: the step
median, each epoch's wall and shuffle seconds, the stall share and, with
the audit on, the digest seconds of the trainer process's sides, the
spool's bytes and the reconcile's seconds. An audited run whose verdicts
are not all ``ok`` fails the script. Needs the card (it exits non-zero
without one).
"""

import json
import os
import shutil
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(reps: int) -> int:
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as smoke
    import ray_shuffling_data_loader_tpu_torch as port
    from ray_shuffling_data_loader_tpu_torch.telemetry import audit

    if not torch.cuda.is_available():
        print("torch_port_audit_repeat: no CUDA device is available", file=sys.stderr)
        return 2
    work = os.path.join(ROOT, "build", "audit_repeat")
    shutil.rmtree(work, ignore_errors=True)
    spool = os.path.join(work, "spool")
    port.runtime.init()
    try:
        files, _ = port.generate_data(10**6, 10, 5, 0.0, os.path.join(work, "data"), seed=0)
    finally:
        port.runtime.shutdown()
    try:
        for r in range(reps):
            for mode in ("off", "on", "on", "off"):
                env = {"RSDL_AUDIT": "1", "RSDL_AUDIT_DIR": spool} if mode == "on" else {}
                with smoke.environment(env, clear=smoke.AUDIT_KNOBS):
                    audit.refresh_from_env()
                    port.runtime.init()
                    try:
                        pool_s = smoke.start_pool(port)
                        out = smoke.train_slice(torch, port, files, 10**6, port.dlrm_for_data_spec(), f"{mode}-{r}")
                        line = {
                            "audit": mode, "rep": r, "pool_ready_s": pool_s, "step_ms_median": out["step_ms_median"],
                            "epoch_s": out["epoch_s"], "epoch_shuffle_s": out["delivery"]["epoch_shuffle_s"],
                            "stall_share": smoke.stall_share(out),
                        }
                        if mode == "on":
                            verdicts = audit.verdicts()
                            if len(verdicts) != 2 or not all(v["ok"] for v in verdicts):
                                raise AssertionError(f"audited run {r}: verdicts {verdicts}")
                            line.update(digest_s=audit.digest_seconds(), reconcile_s=out["audit_reconcile_s"],
                                        spool_bytes=sum(os.path.getsize(os.path.join(spool, f))
                                                        for f in os.listdir(spool)))
                        print("EXP " + json.dumps(line), flush=True)
                    finally:
                        port.runtime.shutdown()
                audit.refresh_from_env()
                audit.reset()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(smoke.smi_name_and_limit())
    return 0


if __name__ == "__main__":
    sys.exit(main(int(sys.argv[1])))
