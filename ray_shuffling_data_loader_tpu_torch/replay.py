"""Replay one journaled epoch and say whether it reproduces.

A run journaled under ``RSDL_JOURNAL`` (:mod:`.runtime.journal`) with the
audit armed records what decided its delivered stream (seed, plan,
topology, projection, layout) and, at its end, each epoch's audit
verdict, with the order-sensitive ``delivered_seq``. This re-runs epoch
N of it on a fresh session under the recorded identity, reconciles the
re-run's digests and compares them field by field with the journal:

* they match: exit 0 (the epoch reproduces);
* they differ: exit 1, the differing fields named in the report;
* a usage or journal error: exit 2.

Usage::

    python -m ray_shuffling_data_loader_tpu_torch.replay <journal-file-or-dir>
        [--epoch N] [--workers W] [--json OUT]

``--epoch`` defaults to every epoch with a verdict. The journal must be
of a completed run: a suspended run's journal has no verdict and exits
2; resume it first. A journal whose identity records a fault schedule
(``RSDL_FAULTS``, ``RSDL_FAULTS_SEED``) is replayed under that schedule,
armed again before the replay's session starts (and both cleared when
none was recorded): the recovered run delivered the fault-free stream,
and so must its replay. The replay never journals and never resumes. It reads journals of
either package: the format is the JAX package's (``tools/replay.py``).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
from typing import List, Optional

# The fields a replay must reproduce, in report order: ``delivered_seq``
# (the order-sensitive fold of every delivered row) first, then the
# coverage digests and row counts of the map and reduce sides.
_COMPARED = (
    "delivered_seq",
    "delivered_digest",
    "map_digest",
    "reduce_digest",
    "rows_mapped",
    "rows_reduced",
    "rows_delivered",
)


def _die(msg: str):
    print(f"replay: {msg}", file=sys.stderr)
    raise SystemExit(2)


def _load_state(path: str):
    from ray_shuffling_data_loader_tpu_torch.runtime import journal

    if os.path.isdir(path):
        files = journal._run_files(path)
        if not files:
            _die(f"no run journals under {path!r}")
        path = files[0]
    try:
        return journal.load_run(path)
    except (OSError, ValueError) as exc:
        _die(f"cannot load journal {path!r}: {exc}")


def _arm_recorded_env(identity: dict) -> None:
    """Set every knob that decides the stream to its recorded value, and
    make the replay a read-only re-run with a spool of its own."""
    os.environ["RSDL_SHUFFLE_PLAN"] = identity.get("plan") or "rowwise"
    for key, value in (("RSDL_FAULTS", identity.get("faults")), ("RSDL_FAULTS_SEED", identity.get("faults_seed"))):
        if value:
            os.environ[key] = str(value)
        else:
            os.environ.pop(key, None)
    for key in ("RSDL_JOURNAL", "RSDL_RESUME", "RSDL_AUDIT_STRICT"):
        os.environ.pop(key, None)
    os.environ["RSDL_AUDIT"] = "1"
    os.environ["RSDL_AUDIT_DIR"] = tempfile.mkdtemp(prefix="rsdl-replay-")


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("journal", help="journal file, or a journal dir (its newest run file is taken)")
    parser.add_argument("--epoch", type=int, default=None,
                        help="epoch to replay (default: every epoch the journal holds a verdict for)")
    parser.add_argument("--workers", type=int, default=2, help="pool workers of the replay's session")
    parser.add_argument("--json", dest="json_out", default=None, help="also write the report JSON here")
    args = parser.parse_args(argv)

    state = _load_state(args.journal)
    if not state.verdicts:
        _die(f"journal {state.path!r} holds no reconciled verdicts (suspended or failed run?): resume it to "
             "completion first, then replay the resumed run's journal")
    if args.epoch is not None:
        if args.epoch not in state.verdicts:
            _die(f"no journaled verdict for epoch {args.epoch} (have: {sorted(state.verdicts)})")
        epochs = [args.epoch]
    else:
        epochs = sorted(state.verdicts)
    identity = state.identity
    missing = [f for f in identity.get("filenames", []) if "://" not in f and not os.path.exists(f)]
    if missing:
        _die(f"recorded input files are gone: {missing[:3]}")
    _arm_recorded_env(identity)

    from ray_shuffling_data_loader_tpu_torch import runtime
    from ray_shuffling_data_loader_tpu_torch.runtime import faults
    from ray_shuffling_data_loader_tpu_torch.shuffle import BatchConsumer, shuffle
    from ray_shuffling_data_loader_tpu_torch.telemetry import audit

    audit.refresh_from_env()
    faults.refresh_from_env()
    device_layout = None
    if identity.get("device_batch"):
        device_layout = {"batch": int(identity["device_batch"]), "columns": list(identity.get("device_columns") or [])}

    class _Drain(BatchConsumer):
        def consume(self, rank, epoch, batches):
            runtime.get_context().store.free(batches)

        def producer_done(self, rank, epoch):
            pass

        def wait_until_ready(self, epoch):
            pass

        def wait_until_all_epochs_done(self):
            pass

    report = {"journal": state.path, "run_id": state.run_id, "epochs": {}, "ok": True,
              "faults": {"spec": os.environ.get("RSDL_FAULTS"), "seed": os.environ.get("RSDL_FAULTS_SEED")}}
    spool = audit.spool_dir()
    runtime.init(num_workers=args.workers)
    try:
        for epoch in epochs:
            shuffle(
                list(identity["filenames"]), _Drain(), num_epochs=epoch + 1,
                num_reducers=int(identity["num_reducers"]), num_trainers=int(identity["num_trainers"]),
                seed=int(identity["seed"]), start_epoch=epoch, narrow_to_32=bool(identity.get("narrow_to_32")),
                device_layout=device_layout, columns=identity.get("columns"),
            )
            verdicts = audit.verdicts()
            replayed = verdicts[0] if verdicts else {}
            recorded = state.verdicts[epoch]
            diverged = {
                f: {"recorded": recorded.get(f), "replayed": replayed.get(f)}
                for f in _COMPARED if recorded.get(f) != replayed.get(f)
            }
            ok = not diverged and replayed.get("ok") is True
            report["epochs"][str(epoch)] = {
                "ok": ok, "diverged": diverged, "delivered_seq": replayed.get("delivered_seq"),
                "audit_ok": replayed.get("ok"),
            }
            report["ok"] = report["ok"] and ok
    finally:
        # What fired in this process (the driver's sites); the workers'
        # fires end with them.
        report["faults"]["fired"] = {f"{site}:{kind}": n for (site, kind), n in sorted(faults.fired_counts().items())}
        runtime.shutdown()
        shutil.rmtree(spool, ignore_errors=True)
    out = json.dumps(report, indent=2)
    print(out)
    if args.json_out:
        with open(args.json_out, "w") as f:
            f.write(out + "\n")
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
