"""Pod training: the DLRM over a pod's global batches, one process per rank.

    python -m ray_shuffling_data_loader_tpu_torch.pod --simulate-pod N --backend gloo
        [--loader mapreduce|resident] [--device cuda|cpu] [--out DIR]
    python -m ray_shuffling_data_loader_tpu_torch.pod --coordinator HOST:PORT --num-processes N
        --process-id I --backend gloo|nccl ...

The port of the JAX package's ``examples/train_dlrm_pod.py``; it takes
every flag of that script. Every process runs this module:

1. ``--coordinator``, ``--num-processes`` and ``--process-id`` start the
   ``torch.distributed`` world (``tcp://HOST:PORT``). The backend is
   explicit, as in :mod:`.multirank`: ``gloo`` where ranks share a device
   (their collectives go through host memory), ``nccl`` only with one
   device per rank. Rank ``r`` uses ``cuda:r % devices``.
2. Rank 0 brings up the shuffle runtime's cluster
   (:func:`~.runtime.init_cluster`, advertised on ``RSDL_ADVERTISE_HOST``
   when set), writes the dataset under ``--data-dir`` (default
   ``<rendezvous-dir>/data``; reused while its manifest matches) and
   publishes the cluster's address in the rendezvous directory under a
   name scoped by a nonce that it broadcasts, so that a previous run's
   file can never be joined. The other ranks join with
   ``runtime.init(address=...)``.
3. Every rank builds the DLRM (``--embed-dim``, ``--vocab-cap``; 0 for no
   cap: ``--embed-dim 32 --vocab-cap 0`` is ``dlrm_for_data_spec()``'s full
   width; bf16 on the card, fp32 on the CPU) from one seed, and trains it
   with Adam and the gradients' mean over the world: the explicit
   all-reduce of :func:`~.parallel.make_psum_train_step` with the resident
   loader (the reduction its fused epoch makes), ``DistributedDataParallel``
   with the map/reduce one.
4. ``--loader resident``: :func:`~.resident.fits_device` is voted over
   the world (``pod_consistent=True``, printed), and
   :class:`~.resident.DeviceResidentShufflingDataset` over the data mesh
   stages each rank's span; ``--batch-size`` is the global batch and each
   rank steps on its shard of it. Epochs from ``--fused-from-epoch`` on
   run as :func:`~.resident.make_fused_epoch`. ``--check-gather``
   delivers epoch 0 once more on the gather schedule, without training.
   ``--loader mapreduce``: each rank reads its trainer's shard through
   :class:`~.device_dataset.DeviceShufflingDataset` (``num_trainers`` =
   the world), ``--batch-size`` rows a rank, and the step's mean over the
   ranks is the JAX pod's global-array batch.
5. The ranks step in lockstep while every rank has a batch
   (:func:`~.parallel.ranks_with_batch`, the JAX script's
   ``_all_have_next``); batches past that are drained untrained. Each
   rank prints ``[pod] rank r: epoch e done, S steps, loss L``.

``--simulate-pod N`` launches the N processes on this host, all under one
deadline (``--timeout``). ``--out DIR`` writes each rank's delivered keys
(``rank<r>-epoch<e>.npy``, and ``rank<r>-gather-epoch0.npy``) and
``rank<r>.json``: losses, step seconds, K1's launches, staging, the
exchanges' and the collectives' seconds, the fused and the eager ms a
batch, seconds since spawn to each stage of the start-up, a digest of the
parameters. This module imports ``torch`` inside its functions only: a
rank's shuffle workers import ``__main__`` again.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import statistics
import subprocess
import sys
import time
from types import SimpleNamespace
from typing import List, Optional

# Torch-free at import, as this module must be.
from ray_shuffling_data_loader_tpu_torch.multirank import _digest, _free_port, wait_ranks


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    # The JAX script's flags, with its defaults.
    p.add_argument("--num-rows", type=int, default=200_000)
    p.add_argument("--num-files", type=int, default=8)
    p.add_argument("--batch-size", type=int, default=8_192,
                   help="resident: the global batch; mapreduce: each rank's")
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--num-reducers", type=int, default=8)
    p.add_argument("--embed-dim", type=int, default=16)
    p.add_argument("--vocab-cap", type=int, default=1000, help="cap every table's rows; 0: no cap")
    p.add_argument("--seed", type=int, default=29)
    p.add_argument("--rendezvous-dir", type=str, default="pod_rendezvous",
                   help="a directory every rank sees: the cluster's address and, by default, the data")
    p.add_argument("--coordinator", type=str, default=None, help="host:port of the torch.distributed rendezvous")
    p.add_argument("--num-processes", type=int, default=None, help="with --coordinator: the world's size")
    p.add_argument("--process-id", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--platform", choices=("cpu", "cuda", "gpu"), default=None,
                   help="the JAX script's name for --device ('gpu' is 'cuda')")
    p.add_argument("--simulate-pod", type=int, default=None, metavar="N",
                   help="launch N local processes with a local coordinator")
    p.add_argument("--loader", choices=("mapreduce", "resident"), default="mapreduce")
    # The port's own.
    p.add_argument("--backend", choices=("gloo", "nccl"),
                   help="required: nccl with one CUDA device per rank, gloo for ranks that share one")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--row-groups", type=int, default=2, help="row groups a file of the written dataset")
    p.add_argument("--data-dir", type=str, default=None, help="default: <rendezvous-dir>/data")
    p.add_argument("--num-workers", type=int, default=4, help="each rank's shuffle worker processes")
    p.add_argument("--fused-from-epoch", type=int, default=None,
                   help="resident: train the epochs from this one on with make_fused_epoch")
    p.add_argument("--check-gather", action="store_true",
                   help="resident: deliver epoch 0 again on the gather schedule, without training")
    p.add_argument("--out", type=str, default=None, help="write each rank's keys and figures here")
    p.add_argument("--timeout", type=float, default=900.0, help="seconds for the simulated pod")
    p.add_argument("--spawned-at", type=float, default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.platform is not None:
        args.device = "cpu" if args.platform == "cpu" else "cuda"
    if args.backend is None:
        p.error("--backend is required")
    if args.loader != "resident" and (args.fused_from_epoch is not None or args.check_gather):
        p.error("--fused-from-epoch and --check-gather need --loader resident")
    if args.coordinator is None and args.simulate_pod is None and (args.num_processes or 1) > 1:
        p.error("--num-processes above 1 needs --coordinator")
    return args


def _wait_for(path: str, timeout: float) -> str:
    deadline = time.time() + timeout
    while not os.path.exists(path):
        if time.time() > deadline:
            raise TimeoutError(f"rank 0 never published {path}")
        time.sleep(0.2)
    with open(path) as f:
        return f.read().strip()


def train_main(args) -> int:
    spawned_at = args.spawned_at if args.spawned_at is not None else time.time()
    startup = {}

    def mark(label: str) -> None:
        startup[label] = time.time() - spawned_at

    import numpy as np
    import torch

    import ray_shuffling_data_loader_tpu_torch as port
    from ray_shuffling_data_loader_tpu_torch import ops
    from ray_shuffling_data_loader_tpu_torch.parallel import (
        collectives,
        init_data_parallel,
        make_mesh,
        make_optimizer,
        make_psum_train_step,
        make_train_step,
        ranks_with_batch,
    )
    from ray_shuffling_data_loader_tpu_torch.resident import FUSED_WARMUP_STEPS
    from ray_shuffling_data_loader_tpu_torch.train_dlrm import get_data

    mark("imports")
    world = args.num_processes or 1
    rank = args.process_id or 0
    if args.device == "cuda":
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    coordinator = args.coordinator or f"localhost:{_free_port()}"
    init_data_parallel(rank, world, args.backend, f"tcp://{coordinator}")
    import torch.distributed as dist

    mesh = make_mesh(1)
    flag_device = device if args.backend == "nccl" else torch.device("cpu")
    mark("groups")

    # A persistent rendezvous directory may hold a previous run's address:
    # the name is scoped to this run by a nonce from rank 0.
    rdv = os.path.abspath(args.rendezvous_dir)
    os.makedirs(rdv, exist_ok=True)
    nonce = collectives.broadcast_int(random.randrange(2**31) if rank == 0 else 0, dist.group.WORLD)
    addr_file = os.path.join(rdv, f"cluster_address_{nonce}")
    data_dir = os.path.abspath(args.data_dir or os.path.join(rdv, "data"))
    shape = SimpleNamespace(num_rows=args.num_rows, num_files=args.num_files,
                            num_row_groups_per_file=args.row_groups, seed=args.seed, data_dir=data_dir)
    if rank == 0:
        if world > 1:
            ctx = port.runtime.init_cluster(advertise_host=os.environ.get("RSDL_ADVERTISE_HOST"),
                                            num_workers=args.num_workers)
        else:
            ctx = port.runtime.init(num_workers=args.num_workers)
        os.makedirs(data_dir, exist_ok=True)
        filenames = get_data(shape)
        num_bytes = sum(os.path.getsize(f) for f in filenames)
        if world > 1:
            with open(addr_file + ".tmp", "w") as f:
                f.write(ctx.cluster.address)
            os.rename(addr_file + ".tmp", addr_file)
        print(f"[pod] rank 0: cluster up, {num_bytes / 1e9:.2f} GB over {len(filenames)} files", flush=True)
    else:
        address = _wait_for(addr_file, 300)
        port.runtime.init(address=address, num_workers=args.num_workers)
        with open(os.path.join(data_dir, "manifest.json")) as f:
            filenames = [os.path.abspath(fn) for fn in json.load(f)["filenames"]]
    # One order on every rank: the resident loader maps row offsets from it.
    filenames = sorted(filenames)
    mark("runtime")

    # bf16 on the card, as the JAX example's model; fp32 on the CPU. One
    # seed gives every rank one initial state.
    compute_dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    torch.manual_seed(args.seed)
    model = port.dlrm_for_data_spec(embed_dim=args.embed_dim, vocab_cap=args.vocab_cap or None,
                                    compute_dtype=compute_dtype, device="cpu").to(device)
    fused_from = args.fused_from_epoch
    optimizer = make_optimizer(model, capturable=fused_from is not None and device.type == "cuda")
    if args.loader == "resident":
        # The explicit mean: the reduction that the fused epoch makes too.
        step = make_psum_train_step(model, optimizer, mesh.data_group)
    else:
        step = make_train_step(model, optimizer, mesh.data_group)
    mark("model")

    features = [c for c in port.DATA_SPEC if c != port.LABEL_COLUMN]
    columns = [*features, port.KEY_COLUMN]
    out = {"rank": rank, "world": world, "loader": args.loader, "device": str(device)}
    if args.loader == "resident":
        fits = port.fits_device(filenames, len(columns), device=device, mesh=mesh, pod_consistent=True)
        print(f"[pod] rank {rank}: fits_device (pod-consistent) {fits}", flush=True)
        t0 = time.perf_counter()
        ds = port.DeviceResidentShufflingDataset(
            filenames, args.epochs, args.batch_size, columns, port.LABEL_COLUMN, seed=args.seed, device=device,
            mesh=mesh,
        )
        out.update(fits_device=fits, materialize=ds._materialize, staging_s=time.perf_counter() - t0,
                   bytes_staged=ds.stats.bytes_staged, span_rows=ds._span)
    else:
        # Rank 0's dataset makes the queue that the others connect to.
        if rank != 0:
            dist.barrier()
        ds = port.DeviceShufflingDataset(
            filenames, args.epochs, world, args.batch_size, rank, feature_columns=columns,
            label_column=port.LABEL_COLUMN, num_reducers=args.num_reducers, seed=args.seed,
            queue_name="pod-queue", device=device,
        )
        if rank == 0 and world > 1:
            dist.barrier()
    mark("dataset")

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    ops.interaction_kernel.launches = ops.interaction_kernel.mma_launches = 0
    collectives.reset_comm_seconds()
    losses: List[List[float]] = []
    step_s: List[float] = []
    eager_s = fused_s = 0.0
    eager_steps = fused_steps = fused_launches = captured = per_step = 0
    fused_comm_s = 0.0
    run_fused = None
    steps_done = 0
    loss = float("nan")
    for epoch in range(args.epochs):
        ds.set_epoch(epoch)
        keys = []
        if fused_from is not None and epoch >= fused_from:
            if run_fused is None:
                before = ops.interaction_kernel.mma_launches
                t0 = time.perf_counter()
                run_fused = port.make_fused_epoch(ds, step)
                sync()
                out["capture_s"] = time.perf_counter() - t0
                # The wrappers count Python calls, and replays make none: the
                # warm-up's and the capture's calls, one step's each.
                captured = ops.interaction_kernel.mma_launches - before
                per_step = captured // (FUSED_WARMUP_STEPS + 1)
            comm0 = collectives.comm_seconds()
            t0 = time.perf_counter()
            epoch_losses = run_fused(epoch)
            sync()
            fused_s += time.perf_counter() - t0
            fused_comm_s += collectives.comm_seconds() - comm0
            steps = epoch_losses.numel()
            fused_steps += steps
            fused_launches += per_step * steps
            losses.append(epoch_losses.tolist())
            loss = losses[-1][-1] if steps else loss
            # The keys of the stream the fused epoch trained, as the iterator delivers it.
            keys = [f[port.KEY_COLUMN] for f, _ in ds]
            trained = len(keys)
        else:
            it = iter(ds)
            item = next(it, None)
            epoch_losses, steps = [], 0
            t_epoch = time.perf_counter()
            while ranks_with_batch(item is not None, mesh.data_group, flag_device) == world:
                if "first_step" not in startup:
                    mark("first_step")
                feats, labels = item
                keys.append(feats.pop(port.KEY_COLUMN))
                t0 = time.perf_counter()
                metrics = step(feats, labels)
                epoch_losses.append(metrics["loss"].item())
                step_s.append(time.perf_counter() - t0)
                steps += 1
                item = next(it, None)
            sync()
            eager_s += time.perf_counter() - t_epoch
            eager_steps += steps
            trained = len(keys)
            # What the lockstep left: delivered, counted, not trained.
            while item is not None:
                keys.append(item[0][port.KEY_COLUMN])
                item = next(it, None)
            losses.append(epoch_losses)
            loss = epoch_losses[-1] if steps else loss
        steps_done += steps
        got = torch.cat(keys).cpu().numpy() if keys else np.zeros(0, np.int32)
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            np.save(os.path.join(args.out, f"rank{rank}-epoch{epoch}.npy"), got)
        out.setdefault("epochs", []).append({"steps": steps, "batches": len(keys), "trained": trained,
                                             "keys": int(got.size)})
        print(f"[pod] rank {rank}: epoch {epoch} done, {steps} steps, loss {loss:.4f}", flush=True)
    mark("last_step")
    eager_launches = ops.interaction_kernel.mma_launches - captured
    if args.check_gather:
        gather = port.DeviceResidentShufflingDataset(
            filenames, args.epochs, args.batch_size, columns, port.LABEL_COLUMN, seed=args.seed, device=device,
            mesh=mesh, materialize_epoch=False,
        )
        gather.set_epoch(0)
        t0 = time.perf_counter()
        got = [f[port.KEY_COLUMN] for f, _ in gather]
        sync()
        out["gather"] = {"epoch_s": time.perf_counter() - t0, "exchange_s": gather.exchange_seconds.get(0),
                         "batches": len(got), "materialize": gather._materialize}
        if args.out:
            np.save(os.path.join(args.out, f"rank{rank}-gather-epoch0.npy"), torch.cat(got).cpu().numpy())
        gather.close()
    if args.loader == "mapreduce":
        ds.join()
    stats = ds.stats.as_dict()
    print(f"[pod] rank {rank}: {steps_done} steps total, {stats['bytes_staged'] / 1e9:.3f} GB staged, "
          f"stall {stats['stall_s']:.2f}s", flush=True)
    out.update(
        losses=losses,
        steps=steps_done,
        step_ms_median=statistics.median(step_s[1:] or step_s) * 1e3 if step_s else None,
        eager_ms_per_batch=eager_s / eager_steps * 1e3 if eager_steps else None,
        fused_ms_per_batch=fused_s / fused_steps * 1e3 if fused_steps else None,
        fused_comm_share=fused_comm_s / fused_s if fused_s else None,
        comm_s=collectives.comm_seconds(),
        exchange_s=getattr(ds, "exchange_seconds", None),
        launches={"interaction_mma": eager_launches + fused_launches, "eager": eager_launches,
                  "fused": fused_launches, "python_calls": ops.interaction_kernel.mma_launches,
                  "interaction_all_routes": ops.interaction_kernel.launches},
        stall_s=stats["stall_s"],
        params_sha256=_digest(model.state_dict()),
        peak_device_bytes=torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None,
    )
    if args.loader == "resident":
        ds.close()
    dist.barrier()  # every rank is done with the queue and the cluster before rank 0 stops them
    dist.destroy_process_group()
    port.runtime.shutdown()
    mark("teardown")
    out["startup_s"] = startup
    if args.out:
        with open(os.path.join(args.out, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    return 0


def simulate_pod(args, argv: List[str]) -> int:
    """The pod as ``args.simulate_pod`` processes of this module on this
    host, with a local coordinator, under one deadline; the worst exit
    code (124 when the deadline cut the run)."""
    rest, skip = [], False
    for arg in argv:  # the caller's flags, less --simulate-pod
        if skip:
            skip = False
        elif arg == "--simulate-pod":
            skip = True
        elif not arg.startswith("--simulate-pod="):
            rest.append(arg)
    coordinator = f"127.0.0.1:{_free_port()}"
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = os.pathsep.join(p for p in (root, os.environ.get("PYTHONPATH")) if p)
    env = dict(os.environ, RSDL_ADVERTISE_HOST="127.0.0.1", PYTHONPATH=path)
    env.pop("RSDL_RUNTIME_DIR", None)  # each rank has a session of its own
    n = args.simulate_pod
    procs = [
        subprocess.Popen([sys.executable, "-m", "ray_shuffling_data_loader_tpu_torch.pod", *rest,
                          "--coordinator", coordinator, "--num-processes", str(n), "--process-id", str(pid),
                          "--spawned-at", repr(time.time())], env=env)
        for pid in range(n)
    ]
    returncode, codes = wait_ranks(procs, args.timeout)
    if returncode:
        print(f"[pod] rank exit codes {codes}", file=sys.stderr, flush=True)
    return returncode


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parse_args(argv)
    if args.simulate_pod:
        return simulate_pod(args, argv)
    return train_main(args)


if __name__ == "__main__":
    sys.exit(main())
