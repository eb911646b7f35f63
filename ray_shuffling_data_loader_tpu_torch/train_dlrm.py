"""End-to-end training: the DLRM (or the TabTransformer) on batches of a
per-epoch shuffle, with checkpoint and resume.

    python -m ray_shuffling_data_loader_tpu_torch.train_dlrm [--smoke]
        [--model dlrm|transformer] [--loader auto|resident|mapreduce]
        [--checkpoint-dir DIR [--checkpoint-every N]] [--device cuda|cpu]

The port of the JAX package's ``examples/train_dlrm.py``. It writes the
synthetic ``DATA_SPEC`` dataset once (reused while its shape matches),
shuffles it every epoch and trains one step per batch on ``cuda`` (the
CPU when ``--device cpu`` asks for it), reporting each epoch's batch
wait times, the trainer stall the loader exists to remove.
``--mock-train-step-time S`` sleeps instead of training, as the
reference's loader-only mode does.

``--loader``: ``mapreduce`` is the host shuffle
(:class:`~.device_dataset.DeviceShufflingDataset`), ``resident`` keeps
the dataset on the device and permutes it there
(:class:`~.resident.DeviceResidentShufflingDataset`), ``auto`` takes
the resident one when :func:`~.resident.fits_device` says it fits.

**Checkpoint and resume.** With ``--checkpoint-dir``, a checkpoint
(:class:`~.checkpoint.CheckpointManager`: the batch cursor, the model's
and Adam's state) is written every ``--checkpoint-every`` steps. A run
whose directory already holds one resumes from it: the cursor's loader
is used whatever ``--loader`` says (the two loaders deliver different
streams), a cursor of another stream (seed, batch size, reducers,
files, plan) is refused, and the run starts at the cursor's epoch,
skipping the batches already trained. Set ``RSDL_JOURNAL`` (and
``RSDL_RESUME=redeliver`` on the restart) to let the map/reduce loader's
shuffle re-attach what the preempted run had already computed
(:mod:`.runtime.journal`).

``--model-parallelism`` above 1, ``--grad-reduce mean|adasum`` and
``--grad-bf16`` are the JAX example's multi-device planes. One process
drives one card here, so the port has them only across processes, one
per rank (:mod:`.multirank`, with ``--model-parallelism M`` for the
vocab-sharded tables), and raises ``NotImplementedError`` here.

``--record DIR`` writes each trained step's ``key`` column
(``keys-<step>.npy``) and a line of ``steps.jsonl`` (step, epoch, batch,
loss), and the run ends with a ``RESULT {...}`` line of its figures.

A spawned pool runs the shuffle, so this module imports ``torch`` inside
its functions only.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time
from typing import List

_MULTIRANK = "one process drives one card; run the ranks as processes with python -m ray_shuffling_data_loader_tpu_torch.multirank"


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--num-rows", type=int, default=10**6)
    p.add_argument("--num-files", type=int, default=10)
    p.add_argument("--num-row-groups-per-file", type=int, default=5)
    p.add_argument("--batch-size", type=int, default=250_000)
    p.add_argument("--epochs", type=int, default=4)
    p.add_argument("--num-reducers", type=int, default=8)
    p.add_argument("--max-concurrent-epochs", type=int, default=2)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--data-dir", type=str, default="example_data")
    p.add_argument("--mock-train-step-time", type=float, default=None,
                   help="sleep this many seconds instead of a train step")
    p.add_argument("--model", choices=("dlrm", "transformer"), default="dlrm")
    p.add_argument("--embed-dim", type=int, default=32)
    p.add_argument("--vocab-cap", type=int, default=None, help="cap every table's rows (small runs)")
    p.add_argument("--learning-rate", type=float, default=1e-3)
    p.add_argument("--model-parallelism", type=int, default=1)
    p.add_argument("--checkpoint-dir", type=str, default=None,
                   help="checkpoint here; a run whose directory holds a checkpoint resumes from it")
    p.add_argument("--checkpoint-every", type=int, default=50, help="steps between checkpoints")
    p.add_argument("--loader", choices=("auto", "resident", "mapreduce"), default="auto")
    p.add_argument("--grad-reduce", choices=("pjit", "mean", "adasum"), default="pjit")
    p.add_argument("--grad-bf16", action="store_true")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--num-workers", type=int, default=None, help="shuffle worker processes")
    p.add_argument("--record", type=str, default=None, help="write each step's keys and loss here")
    p.add_argument("--smoke", action="store_true", help="a tiny workload (overrides the size knobs)")
    args = p.parse_args(argv)
    if args.grad_reduce != "pjit" and args.model_parallelism != 1:
        p.error("--grad-reduce mean/adasum requires --model-parallelism 1")
    if args.grad_bf16 and args.grad_reduce == "pjit":
        p.error("--grad-bf16 needs an explicit mode (--grad-reduce mean/adasum)")
    if args.smoke:
        args.num_rows = 50_000
        args.num_files = 4
        args.num_row_groups_per_file = 1
        args.batch_size = 4096
        args.epochs = 2
        args.num_reducers = 4
        args.embed_dim = 8
        args.vocab_cap = args.vocab_cap or 1000
        args.data_dir = os.path.join(args.data_dir, "smoke")
    return args


def get_data(args) -> List[str]:
    """The dataset's files: written once, then reused while the data
    directory's manifest names the same shape and seed and every file is
    there (:func:`.data_generation.cached_generate_data`)."""
    from ray_shuffling_data_loader_tpu_torch.data_generation import cached_files, cached_generate_data

    spec = (args.num_rows, args.num_files, args.num_row_groups_per_file, args.data_dir)
    hit = cached_files(*spec, seed=args.seed)
    if hit is not None:
        print(f"reusing {len(hit[0])} files in {args.data_dir}", flush=True)
        return [os.path.abspath(fn) for fn in hit[0]]
    t0 = time.perf_counter()
    filenames, num_bytes = cached_generate_data(*spec, seed=args.seed)
    print(f"generated {num_bytes / 1e9:.3f} GB in {time.perf_counter() - t0:.2f} s", flush=True)
    return [os.path.abspath(fn) for fn in filenames]


def main(argv=None) -> int:
    t_start = time.perf_counter()
    args = parse_args(argv)
    if args.model_parallelism != 1:
        raise NotImplementedError(
            f"--model-parallelism {args.model_parallelism}: {_MULTIRANK} --model-parallelism {args.model_parallelism}"
        )
    if args.grad_reduce != "pjit" or args.grad_bf16:
        raise NotImplementedError(
            f"--grad-reduce {args.grad_reduce}{' --grad-bf16' if args.grad_bf16 else ''}: {_MULTIRANK} --step psum"
        )

    import numpy as np
    import torch

    from ray_shuffling_data_loader_tpu_torch import ops, runtime
    from ray_shuffling_data_loader_tpu_torch.checkpoint import BatchCursor, CheckpointManager
    from ray_shuffling_data_loader_tpu_torch.data_generation import DATA_SPEC, KEY_COLUMN, LABEL_COLUMN
    from ray_shuffling_data_loader_tpu_torch.models import dlrm_for_data_spec, transformer_for_data_spec
    from ray_shuffling_data_loader_tpu_torch.parallel import make_optimizer, make_train_step
    from ray_shuffling_data_loader_tpu_torch.utils.device import resolve_device

    # Seconds from main()'s start to each stage of the start-up.
    startup = {"imports": time.perf_counter() - t_start}
    device = resolve_device(args.device)
    # bf16 on the card, as the JAX example's model; fp32 on the CPU.
    compute_dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    runtime.init(num_workers=args.num_workers)
    startup["session"] = time.perf_counter() - t_start
    ds = None
    try:
        os.makedirs(args.data_dir, exist_ok=True)
        filenames = get_data(args)
        startup["data"] = time.perf_counter() - t_start
        feature_columns = [c for c in DATA_SPEC if c != LABEL_COLUMN]
        if args.loader == "mapreduce":
            use_resident = False
        else:
            from ray_shuffling_data_loader_tpu_torch.resident import fits_device

            fits = fits_device(filenames, len(feature_columns) + 1, device=device, num_rows=args.num_rows)
            use_resident = args.loader == "resident" or fits
            if use_resident and not fits:
                print("note: --loader resident forced; the packed dataset may not fit the device budget", flush=True)

        factory = transformer_for_data_spec if args.model == "transformer" else dlrm_for_data_spec
        model = factory(embed_dim=args.embed_dim, vocab_cap=args.vocab_cap, compute_dtype=compute_dtype, device=device)
        optimizer = make_optimizer(model, lr=args.learning_rate)
        startup["model"] = time.perf_counter() - t_start

        mgr, stream_config, restore_s = None, None, None
        start_epoch, resume_skip, global_step = 0, 0, 0
        if args.checkpoint_dir:
            mgr = CheckpointManager(args.checkpoint_dir)
            stream_config = BatchCursor.stream_config(
                seed=args.seed, batch_size=args.batch_size, num_trainers=1, num_reducers=args.num_reducers,
                num_files=len(filenames), drop_last=True,
            )
            t0 = time.perf_counter()
            restored, cursor = mgr.restore(target={"model": model, "optimizer": optimizer}, device=device)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            if cursor is not None:
                restore_s = time.perf_counter() - t0
                # The two loaders deliver different streams: a resume keeps
                # the checkpoint's. A cursor without the key is map/reduce's.
                ckpt_loader = (cursor.config or {}).get("loader", "mapreduce")
                if args.loader not in ("auto", ckpt_loader):
                    raise SystemExit(
                        f"--loader {args.loader} conflicts with this checkpoint's batch stream "
                        f"(written under {ckpt_loader}); resume with --loader {ckpt_loader}"
                    )
                use_resident = ckpt_loader == "resident"
                if "loader" in (cursor.config or {}):
                    stream_config["loader"] = ckpt_loader
                cursor.validate(stream_config)
                start_epoch, resume_skip, global_step = cursor.epoch, cursor.batches_yielded, cursor.step
                print(f"resuming from step {global_step}: epoch {start_epoch}, skipping {resume_skip} "
                      f"trained batches (restore {restore_s:.3f} s)", flush=True)
            else:
                stream_config["loader"] = "resident" if use_resident else "mapreduce"
        startup["restore"] = time.perf_counter() - t_start
        print(f"loader: {'device-resident' if use_resident else 'map/reduce'}", flush=True)

        columns = [*feature_columns, KEY_COLUMN]
        if use_resident:
            from ray_shuffling_data_loader_tpu_torch.resident import DeviceResidentShufflingDataset

            ds = DeviceResidentShufflingDataset(
                filenames, args.epochs, args.batch_size, columns, LABEL_COLUMN, seed=args.seed, device=device,
                num_rows=args.num_rows,
            )
        else:
            from ray_shuffling_data_loader_tpu_torch.device_dataset import DeviceShufflingDataset

            ds = DeviceShufflingDataset(
                filenames, args.epochs, 1, args.batch_size, 0, columns, LABEL_COLUMN,
                num_reducers=args.num_reducers, max_concurrent_epochs=args.max_concurrent_epochs, seed=args.seed,
                device=device, start_epoch=start_epoch,
            )
        startup["dataset"] = time.perf_counter() - t_start
        step = make_train_step(model, optimizer)
        if args.record:
            os.makedirs(args.record, exist_ok=True)
        launches0 = (ops.interaction_kernel.launches, ops.interaction_kernel.mma_launches)
        ckpt_bytes, save_s, first_batch_s, first_batch_at = [], [], None, None
        all_waits: List[float] = []
        loss = float("nan")
        for epoch in range(start_epoch, args.epochs):
            skip = resume_skip if epoch == start_epoch else 0
            ds.set_epoch(epoch, skip_batches=skip)
            epoch_start = time.perf_counter()
            waits: List[float] = []
            num_batches = skip
            last_done = time.perf_counter()
            for features, labels in ds:
                if first_batch_s is None:
                    first_batch_s, first_batch_at = time.perf_counter() - t_start, time.time()
                    startup["first_batch"] = first_batch_s
                waits.append(time.perf_counter() - last_done)
                keys = features.pop(KEY_COLUMN)
                if args.mock_train_step_time is not None:
                    time.sleep(args.mock_train_step_time)
                else:
                    loss = float(step(features, labels)["loss"])
                num_batches += 1
                global_step += 1
                if args.record:
                    host_keys = keys.cpu().numpy()
                    np.save(os.path.join(args.record, f"keys-{global_step:06d}.npy"), host_keys)
                    with open(os.path.join(args.record, "steps.jsonl"), "a") as f:
                        f.write(json.dumps({
                            "step": global_step, "epoch": epoch, "batch": num_batches - 1, "loss": loss,
                            "keys_sha256": hashlib.sha256(host_keys.tobytes()).hexdigest(),
                        }) + "\n")
                if mgr is not None and global_step % args.checkpoint_every == 0:
                    t0 = time.perf_counter()
                    path = mgr.save(
                        global_step,
                        cursor=BatchCursor(epoch=epoch, batches_yielded=num_batches, config=stream_config),
                        state={"model": model.state_dict(), "optimizer": optimizer.state_dict()},
                    )
                    save_s.append(time.perf_counter() - t0)
                    ckpt_bytes.append(sum(os.path.getsize(os.path.join(path, n)) for n in os.listdir(path)))
                    print(f"checkpoint at step {global_step}: {ckpt_bytes[-1]} B in {save_s[-1]:.3f} s", flush=True)
                last_done = time.perf_counter()
            epoch_s = time.perf_counter() - epoch_start
            all_waits.extend(waits)
            if not waits:
                print(f"epoch {epoch}: 0 batches", flush=True)
                continue
            wt = np.asarray(waits)
            print(f"epoch {epoch}: {num_batches} batches in {epoch_s:.2f} s, loss={loss:.4f}, batch wait "
                  f"mean={wt.mean():.4f} s std={wt.std():.4f} max={wt.max():.4f} min={wt.min():.4f}", flush=True)
        if not use_resident:
            ds.join()
        if not all_waits:
            print("no batches were delivered; nothing to summarize", flush=True)
            return 1
        wt = np.asarray(all_waits)
        print(f"total: {len(all_waits)} batches; batch wait mean={wt.mean():.4f} s std={wt.std():.4f} "
              f"max={wt.max():.4f} min={wt.min():.4f}; stall {ds.stats.stall_s:.3f} s", flush=True)
        shuffle_stats = {} if use_resident else ds.dataset.shuffle_stats
        print("RESULT " + json.dumps({
            "loader": "resident" if use_resident else "mapreduce",
            "steps": global_step,
            "batches": len(all_waits),
            "loss": loss,
            "interaction_launches": ops.interaction_kernel.launches - launches0[0],
            "interaction_mma_launches": ops.interaction_kernel.mma_launches - launches0[1],
            "restore_s": restore_s,
            "first_batch_s": first_batch_s,
            "first_batch_at": first_batch_at,
            "startup_s": startup,
            "checkpoint_bytes": ckpt_bytes,
            "checkpoint_save_s": save_s,
            "stall_s": ds.stats.stall_s,
            "resume": shuffle_stats.get("resume"),
            "journal": shuffle_stats.get("journal"),
        }), flush=True)
        return 0
    finally:
        if ds is not None and hasattr(ds, "close"):
            ds.close()
        runtime.shutdown()


if __name__ == "__main__":
    sys.exit(main())
