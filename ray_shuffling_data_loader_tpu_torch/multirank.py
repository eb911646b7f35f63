"""Data-parallel (and model-parallel) DLRM training with one process per
trainer rank.

    python -m ray_shuffling_data_loader_tpu_torch.multirank --num-trainers N
        --backend gloo|nccl [--step ddp|psum] [--grad-reduce mean|adasum]
        [--grad-dtype bfloat16] [--model-parallelism M] [--epochs 2]
        [--batch-size 65536] [--max-steps S] [--device cuda|cpu]
        [--data-dir DIR]

The launcher creates the runtime session and writes the dataset (10^6 rows
in 10 Parquet files by default), then launches N × M rank processes with
``$RSDL_RUNTIME_DIR`` exported so that each joins the session. The ranks
form the ``(data, model)`` mesh of :func:`~.parallel.make_mesh`: rank
``r`` is data index ``r // M`` and model index ``r % M``. Each rank builds
the full-width ``dlrm_for_data_spec()`` on the host, keeps its shard of
the tall tables (:func:`~.parallel.shard_model`; with ``M`` = 1 nothing is
sharded), and trains with ``DistributedDataParallel`` over its data group
(``--step ddp``, mean) or, with ``M`` = 1 only, the explicit reduction of
``make_psum_train_step`` (``--step psum``, mean or Adasum, optionally bf16
on the wire). The shuffle has N trainers, one per data index: the lead of
each model group (model index 0) iterates trainer ``d``'s shard through
``DeviceShufflingDataset`` and broadcasts each staged batch to its model
peers, so that the whole group steps on one batch. Rank 0 spawns the
batch queue actor and runs the shuffle in its worker pool; the other leads
connect to the queue by name.

Shards differ in length (reducers split into contiguous runs). All ranks
keep stepping until the last data index runs out, so their collectives
stay matched: a rank whose shard is done steps on its last batch with its
loss weighted 0 (``idle``), and the gradient is the mean over the data
indices that brought a batch. Every delivered batch is trained; only
``--max-steps`` leaves the rest of a shard delivered and counted but
untrained.

The backend is always explicit: ``nccl`` with one CUDA device per rank,
``gloo`` where ranks share a device. Rank ``r`` uses ``cuda:r % devices``.

The launcher checks the run: every epoch delivers each key at most once
and each lead exactly its full batches, every peer trains its lead's
batches, every loss is finite, every rank logs the same loss at every
step (the global batch's), the replicated parameters are bit-identical
on every rank, each shard across its data group, and the gathered full
state on every rank. It returns the worst exit code of the ranks (a rank
that fails fails the run) and 1 if a check fails. Each rank reports its
start-up and shutdown as seconds since it was spawned (``startup_s``: to
its imports, the runtime joined, the process groups made, the model built
and sharded, the optimizer and the step made, the pool ready on rank 0,
the first batch, the last step, the report written and the teardown).
This module imports ``torch`` only inside the rank's functions: a rank
runs it as ``__main__``, and its spawned shuffle workers import
``__main__`` again.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import socket
import statistics
import subprocess
import sys
import time
from typing import Dict, List, Optional, Tuple

RANKS_DIR = "multirank"
QUEUE_NAME = "multirank-queue"


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--num-trainers", type=int, default=2, help="data indices: the shuffle's trainers")
    p.add_argument("--model-parallelism", type=int, default=1, help="ranks per model group (M)")
    p.add_argument("--vocab-shard-threshold", type=int, default=16_384,
                   help="tables with at least this many rows (and divisible by M) are sharded")
    p.add_argument("--backend", choices=("gloo", "nccl"),
                   help="required: nccl with one CUDA device per rank, gloo for ranks that share one")
    p.add_argument("--step", choices=("ddp", "psum"), default="ddp")
    p.add_argument("--grad-reduce", choices=("mean", "adasum"), default="mean")
    p.add_argument("--grad-dtype", choices=("bfloat16",), default=None)
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--batch-size", type=int, default=65536)
    p.add_argument("--max-steps", type=int, default=None, help="steps per epoch at most")
    p.add_argument("--num-rows", type=int, default=10**6)
    p.add_argument("--num-files", type=int, default=10)
    p.add_argument("--row-groups", type=int, default=5)
    p.add_argument("--num-reducers", type=int, default=8)
    p.add_argument("--num-workers", type=int, default=None, help="rank 0's shuffle worker processes")
    p.add_argument("--seed", type=int, default=0)
    # Full width by default; smaller for a quick run on the CPU.
    p.add_argument("--embed-dim", type=int, default=32)
    p.add_argument("--vocab-cap", type=int, default=None)
    p.add_argument("--compute-dtype", choices=("bfloat16", "float32"), default="bfloat16")
    p.add_argument("--data-dir", default="build/multirank_data")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--timeout", type=float, default=900.0, help="seconds for the whole run")
    # Set for the rank processes the launcher starts.
    p.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--spec", default=None, help=argparse.SUPPRESS)
    p.add_argument("--spawned-at", type=float, default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.rank is None and args.backend is None:  # a rank reads it from the spec
        p.error("--backend is required")
    if args.step == "ddp" and (args.grad_reduce != "mean" or args.grad_dtype):
        p.error("--grad-reduce adasum and --grad-dtype need --step psum")
    if args.model_parallelism < 1:
        p.error("--model-parallelism must be at least 1")
    if args.model_parallelism > 1 and args.step == "psum":
        p.error("--model-parallelism above 1 needs --step ddp: the explicit step requires replicated parameters")
    return args


# -- one rank -------------------------------------------------------------------


def _digest(state) -> str:
    """sha256 over ``state``'s names and bytes, in name order."""
    import torch

    digest = hashlib.sha256()
    for name, tensor in sorted(state.items()):
        digest.update(name.encode())
        digest.update(tensor.detach().cpu().contiguous().view(-1).view(torch.uint8).numpy().tobytes())
    return digest.hexdigest()


def _time_collective(fn, device, reps: int = 5) -> float:
    """Median seconds of ``fn()``, a collective every rank calls alike."""
    import torch

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    fn()
    times = []
    for _ in range(reps):
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def _share_batch(item, mesh, columns: List[str], batch_size: int, device, flag_device):
    """The lead's batch ``(features, labels)`` on every rank of its model
    group, or None on all of them when the lead has none: a flag and then
    the columns (``int32``; the ``float32`` label as its bits) in one
    ``[len(columns) + 1, batch_size]`` buffer, broadcast from the lead."""
    import torch
    import torch.distributed as dist

    lead = dist.get_global_rank(mesh.model_group, 0)
    flag = torch.tensor([item is not None], dtype=torch.int32, device=flag_device)
    dist.broadcast(flag, lead, group=mesh.model_group)
    if not flag.item():
        return None
    if mesh.is_lead:
        feats, labels = item
        bad = {c: feats[c].dtype for c in columns if feats[c].dtype != torch.int32}
        if bad or labels.dtype != torch.float32:
            raise TypeError(f"a shared batch holds int32 columns and a float32 label, got {bad} and {labels.dtype}")
        buf = torch.stack([*(feats[c] for c in columns), labels.view(torch.int32)])
    else:
        buf = torch.empty((len(columns) + 1, batch_size), dtype=torch.int32, device=device)
    dist.broadcast(buf, lead, group=mesh.model_group)
    if mesh.is_lead:
        return item
    return {c: buf[i] for i, c in enumerate(columns)}, buf[-1].view(torch.float32)


def run_rank(spec: dict, rank: int, spawned_at: float) -> int:
    """One trainer rank of the run ``spec`` (written by the launcher),
    spawned at ``spawned_at`` (``time.time()``)."""
    startup = {}

    def mark(label: str) -> None:
        startup[label] = time.time() - spawned_at

    import numpy as np
    import torch
    import torch.distributed as dist

    import ray_shuffling_data_loader_tpu_torch as port
    import ray_shuffling_data_loader_tpu_torch.ops as ops
    from ray_shuffling_data_loader_tpu_torch.convert import gather_state_dict
    from ray_shuffling_data_loader_tpu_torch.parallel import (
        adasum_reduce,
        init_data_parallel,
        make_mesh,
        make_optimizer,
        make_psum_train_step,
        make_train_step,
        ranks_with_batch,
        shard_model,
    )
    from ray_shuffling_data_loader_tpu_torch.parallel.sharded_embedding import sharded_tables
    from ray_shuffling_data_loader_tpu_torch.parallel.train import _flatten, _gathered_sum
    from ray_shuffling_data_loader_tpu_torch.runtime.store import free_bytes

    mark("imports")
    trainers, model_size = spec["num_trainers"], spec["model_parallelism"]
    world = trainers * model_size
    data_index = rank // model_size
    lead = rank % model_size == 0
    # Only a lead reads batches: its model peers never join the session.
    ctx = port.runtime.init(num_workers=spec["num_workers"]) if lead else None
    mark("runtime")
    if spec["device"] == "cuda":
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    init_data_parallel(rank, world, spec["backend"], spec["init_method"])
    mesh = make_mesh(model_size)
    group = mesh.data_group
    mark("groups")
    flag_device = device if spec["backend"] == "nccl" else torch.device("cpu")
    features = [c for c in port.DATA_SPEC if c != port.LABEL_COLUMN]
    columns = [*features, port.KEY_COLUMN]
    # Rank 0 spawns the queue actor and starts the shuffle; the other leads
    # connect once it exists. The model is built while the shuffle runs.
    if rank != 0:
        dist.barrier()
    ds = None
    if lead:
        ds = port.DeviceShufflingDataset(
            spec["filenames"], spec["epochs"], trainers, spec["batch_size"], data_index,
            feature_columns=columns, label_column=port.LABEL_COLUMN,
            num_reducers=spec["num_reducers"], seed=spec["seed"], queue_name=spec["queue_name"],
            device=device,
        )
    if rank == 0 and world > 1:
        dist.barrier()
    # Built on the host, so that a sharded table's full rows never reach the device.
    model = port.dlrm_for_data_spec(
        embed_dim=spec["embed_dim"], vocab_cap=spec["vocab_cap"],
        compute_dtype=getattr(torch, spec["compute_dtype"]), device="cpu",
    )
    shard_model(model, mesh, spec["vocab_shard_threshold"], device=device)
    sharded = sorted(f"{name}.weight" for name in sharded_tables(model))
    mark("model")
    optimizer = make_optimizer(model)
    mark("optimizer")
    grad_dtype = getattr(torch, spec["grad_dtype"]) if spec["grad_dtype"] else None
    if spec["step"] == "ddp":
        step = make_train_step(model, optimizer, group)
    else:
        step = make_psum_train_step(model, optimizer, group, grad_dtype=grad_dtype, grad_reduce=spec["grad_reduce"])
    mark("step_made")
    for fn in (ops.interaction_kernel, ops.flash_fwd_kernel, ops.flash_bwd_dkv_kernel, ops.flash_bwd_dq_kernel):
        fn.launches = fn.mma_launches = 0
    ops.flash_fwd_short_kernel.launches = ops.flash_bwd_short_kernel.launches = 0
    losses, step_s, epochs = [], [], []
    last = None  # the last batch trained: what the group steps on once its shard is done
    for epoch in range(spec["epochs"]):
        it = iter(())
        if lead:
            ds.set_epoch(epoch)
            it = iter(ds)
            stall0 = ds.stats.stall_s
        keys, steps, idle, drained = [], 0, 0, 0
        t_epoch = time.perf_counter()
        item = next(it, None)
        while spec["max_steps"] is None or steps < spec["max_steps"]:
            if model_size > 1:
                item = _share_batch(item, mesh, columns, spec["batch_size"], device, flag_device)
            if item is not None and "first_batch" not in startup:
                mark("first_batch")
            active = ranks_with_batch(item is not None, group, flag_device)
            if active == 0:
                break
            t0 = time.perf_counter()
            if item is not None:
                feats, labels = item
                keys.append(feats.pop(port.KEY_COLUMN))
                last = (feats, labels)
                out = step(feats, labels, active)
            else:
                if last is None:
                    raise RuntimeError(f"rank {rank} has no batch yet to take part in a step with")
                out = step(*last, active, idle=True)
                idle += 1
            losses.append(out["loss"].item())  # the global batch's: the same on every rank
            step_s.append(time.perf_counter() - t0)
            steps += 1
            item = None
            if spec["max_steps"] is None or steps < spec["max_steps"]:
                item = next(it, None)
        mark("last_step")
        trained = torch.cat(keys).cpu().numpy() if keys else np.zeros(0, np.int32)
        # Delivered, not trained: what --max-steps left of this lead's shard.
        rest = [] if item is None else [item]
        for feats, _ in [*rest, *it]:
            keys.append(feats[port.KEY_COLUMN])
            drained += 1
        wall = time.perf_counter() - t_epoch
        got = torch.cat(keys).cpu().numpy() if keys else np.zeros(0, np.int32)
        np.save(os.path.join(spec["out_dir"], f"rank{rank}-epoch{epoch}.npy"), got)
        record = {"steps": steps, "idle": idle, "drained": drained, "keys": int(got.size), "wall_s": wall,
                  "trained_keys_sha256": hashlib.sha256(trained.tobytes()).hexdigest()}
        if lead:
            host = ds.dataset
            record.update({
                "rows_read": host.rows_read, "stall_s": ds.stats.stall_s - stall0,
                "first_batch_s": ds.stats.first_batch_s, "get_batch_min_s": min(host.get_batch_s),
                "get_batch_median_s": statistics.median(host.get_batch_s),
            })
        epochs.append(record)
        read = f" of {record['rows_read']} rows read" if lead else ""
        print(f"[rank {rank}] epoch {epoch}: {steps} steps ({idle} idle), {drained} batches drained, "
              f"{got.size} keys{read}, {wall:.2f} s", flush=True)
    if lead:
        ds.join()
    # Stand-ins for the step's collectives, timed alone on buffers of the
    # same bytes on every rank: DDP's own all-reduce runs in buckets that
    # overlap the backward pass and is not timed apart from it, and the
    # lookup's sum runs inside the forward.
    buffers = _flatten([p.detach() for p in model.parameters()], grad_dtype)
    if spec["grad_reduce"] == "adasum":
        comm_s = _time_collective(lambda: adasum_reduce(buffers, group), device)
    elif grad_dtype is not None:
        comm_s = _time_collective(lambda: [_gathered_sum(b, group) for b in buffers], device)
    else:
        comm_s = _time_collective(lambda: [dist.all_reduce(b, group=group) for b in buffers], device)
    comm_bytes = sum(b.numel() * b.element_size() for b in buffers)
    lookup_s = lookup_bytes = None
    if sharded:
        partial = torch.zeros((spec["batch_size"], len(sharded), spec["embed_dim"]), device=device)
        lookup_s = _time_collective(lambda: dist.all_reduce(partial, group=mesh.model_group), device)
        lookup_bytes = partial.numel() * partial.element_size()
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
    state = model.state_dict()
    launches = {
        name: {"launches": fn.launches, "mma_launches": fn.mma_launches}
        for name, fn in (("interaction", ops.interaction_kernel), ("flash_fwd", ops.flash_fwd_kernel),
                         ("flash_bwd_dkv", ops.flash_bwd_dkv_kernel), ("flash_bwd_dq", ops.flash_bwd_dq_kernel))
    }
    launches["flash_fwd_short"] = {"launches": ops.flash_fwd_short_kernel.launches}  # one route
    launches["flash_bwd_short"] = {"launches": ops.flash_bwd_short_kernel.launches}  # one route
    result = {
        "rank": rank,
        "data_index": data_index,
        "model_index": mesh.model_index,
        "device": str(device),
        "steps": sum(e["steps"] for e in epochs),
        "losses": losses,
        "step_ms_median": statistics.median(step_s[1:] or step_s) * 1e3 if step_s else None,
        "step_ms_first": step_s[0] * 1e3 if step_s else None,
        "comm_ms": comm_s * 1e3,
        "comm_bytes": comm_bytes,
        "lookup_sum_ms": None if lookup_s is None else lookup_s * 1e3,
        "lookup_sum_bytes": lookup_bytes,
        "stall_share": sum(e["stall_s"] for e in epochs) / sum(e["wall_s"] for e in epochs) if lead else None,
        "epochs": epochs,
        "launches": launches,
        "sharded": sharded,
        "param_count": sum(p.numel() for p in model.parameters()),
        "param_bytes": sum(p.numel() * p.element_size() for p in model.parameters()),
        "replicated_sha256": _digest({k: v for k, v in state.items() if k not in sharded}),
        "shards_sha256": _digest({k: state[k] for k in sharded}),
        "params_sha256": _digest(gather_state_dict(model)),
        "pool_ready_s": ctx._pool.ready_s if ctx is not None and ctx._pool is not None else None,
        "shm_dir": ctx.store.shm_dir if ctx is not None else None,
        "shm_free_bytes": free_bytes(ctx.store.shm_dir) if ctx is not None else None,
        "store_peak_bytes": ds.dataset.shuffle_stats.get("store_peak_bytes") if lead else None,
        "peak_device_bytes": peak,
    }
    if ctx is not None and ctx._pool is not None and ctx._pool.ready_at is not None:
        startup["pool_ready"] = ctx._pool.ready_at - spawned_at
    mark("reported")  # the stand-ins timed, the state gathered and digested
    dist.barrier()  # every rank is done with the queue before rank 0 stops it
    dist.destroy_process_group()
    port.runtime.shutdown()
    mark("teardown")
    result["startup_s"] = startup
    with open(os.path.join(spec["out_dir"], f"rank{rank}.json"), "w") as f:
        json.dump(result, f)
    return 0


# -- the launcher -----------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def wait_ranks(procs: List[subprocess.Popen], timeout: float) -> Tuple[int, List[int]]:
    """Wait for the rank processes ``procs`` under one deadline of
    ``timeout`` seconds: ``(returncode, exit codes)``. A failed rank leaves
    the others blocked in a collective, so the first failure, or the
    deadline, kills the rest. The return code is the worst exit code, or
    124 when the deadline cut a run that had not failed."""
    deadline = time.monotonic() + timeout
    codes: List[Optional[int]] = [None] * len(procs)
    try:
        while any(c is None for c in codes):
            codes = [p.poll() for p in procs]
            if any(c not in (None, 0) for c in codes) or time.monotonic() > deadline:
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        codes = [p.wait() for p in procs]
    returncode = max(codes, key=abs)
    if returncode == 0 and time.monotonic() > deadline:
        returncode = 124
    return returncode, codes


def check(spec: dict, results: List[dict]) -> List[str]:
    """The run's failures: exactly once per epoch across the leads, each
    lead exactly its full batches, every batch trained (unless
    ``--max-steps`` cut the epoch) by every rank of its model group, finite
    losses, the same loss logged by every rank at every step, the
    replicated parameters equal on every rank, each shard across its data
    group, and the gathered state on every rank."""
    import numpy as np

    problems = []
    batch, model_size = spec["batch_size"], spec["model_parallelism"]
    leads = [res for res in results if res["rank"] % model_size == 0]
    for epoch in range(spec["epochs"]):
        keys = [np.load(os.path.join(spec["out_dir"], f"rank{res['rank']}-epoch{epoch}.npy")) for res in leads]
        union = np.concatenate(keys)
        rows = [res["epochs"][epoch]["rows_read"] for res in leads]
        if np.unique(union).size != union.size:
            problems.append(f"epoch {epoch}: {union.size - np.unique(union).size} keys delivered twice")
        if union.size and (union.min() < 0 or union.max() >= spec["num_rows"]):
            problems.append(f"epoch {epoch}: key out of range")
        if sum(rows) != spec["num_rows"]:
            problems.append(f"epoch {epoch}: ranks read {sum(rows)} rows, want {spec['num_rows']}")
        for res, k, n in zip(leads, keys, rows):
            if k.size != n // batch * batch:
                problems.append(f"epoch {epoch} rank {res['rank']}: {k.size} keys, want {n // batch * batch}")
            drained = res["epochs"][epoch]["drained"]
            if spec["max_steps"] is None and drained:
                problems.append(f"epoch {epoch} rank {res['rank']}: {drained} delivered batches not trained")
        for res in results:
            lead = results[res["rank"] - res["rank"] % model_size]
            if res["epochs"][epoch]["trained_keys_sha256"] != lead["epochs"][epoch]["trained_keys_sha256"]:
                problems.append(f"epoch {epoch} rank {res['rank']}: trained other batches than its lead")
    if not all(np.isfinite(res["losses"]).all() for res in results):
        problems.append("a loss is not finite")
    if any(res["losses"] != results[0]["losses"] for res in results):
        problems.append("ranks logged different losses")
    if len({res["replicated_sha256"] for res in results}) != 1:
        problems.append("ranks ended with different replicated parameters")
    for m in range(model_size):
        if len({res["shards_sha256"] for res in results if res["rank"] % model_size == m}) != 1:
            problems.append(f"model index {m}: its data group ended with different shards")
    if len({res["params_sha256"] for res in results}) != 1:
        problems.append("ranks gathered different parameters")
    if len({res["steps"] for res in results}) != 1:
        problems.append("ranks took different numbers of steps")
    return problems


def run(args: argparse.Namespace, filenames: Optional[List[str]] = None) -> Dict:
    """Drive one run: ``{"returncode", "ranks": [per-rank results],
    "problems": [...], "spec"}``. ``filenames`` reuses a written dataset of
    ``args.num_rows`` rows."""
    import ray_shuffling_data_loader_tpu_torch as port

    ctx = port.runtime.init()
    try:
        if filenames is None:
            filenames, _ = port.generate_data(
                args.num_rows, args.num_files, args.row_groups, 0.0, args.data_dir, seed=args.seed
            )
        out_dir = os.path.join(ctx.runtime_dir, RANKS_DIR)
        os.makedirs(out_dir, exist_ok=True)
        spec = {
            **{k: v for k, v in vars(args).items() if k not in ("rank", "spec", "spawned_at")},
            "num_workers": args.num_workers or os.cpu_count() or 1,
            "filenames": list(filenames),
            "init_method": f"tcp://localhost:{_free_port()}",
            "queue_name": QUEUE_NAME,
            "out_dir": out_dir,
        }
        spec_path = os.path.join(ctx.runtime_dir, "multirank.json")
        with open(spec_path, "w") as f:
            json.dump(spec, f)
        # The ranks import this package from where this process found it.
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        path = os.pathsep.join(p for p in (root, os.environ.get("PYTHONPATH")) if p)
        env = dict(os.environ, RSDL_RUNTIME_DIR=ctx.runtime_dir, PYTHONPATH=path)
        cmd = [sys.executable, "-m", "ray_shuffling_data_loader_tpu_torch.multirank", "--spec", spec_path]
        world = args.num_trainers * args.model_parallelism
        procs = [subprocess.Popen([*cmd, "--rank", str(r), "--spawned-at", repr(time.time())], env=env)
                 for r in range(world)]
        returncode, codes = wait_ranks(procs, args.timeout)
        results, problems = [], []
        if returncode == 0:
            for r in range(world):
                with open(os.path.join(out_dir, f"rank{r}.json")) as f:
                    results.append(json.load(f))
            problems = check(spec, results)
            if problems:
                returncode = 1
        else:
            problems = [f"rank exit codes {codes}"]
        return {"returncode": returncode, "ranks": results, "problems": problems, "spec": spec}
    finally:
        port.runtime.shutdown()


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.rank is not None:
        with open(args.spec) as f:
            return run_rank(json.load(f), args.rank, args.spawned_at)
    out = run(args)
    for res in out["ranks"]:
        print(f"[multirank] rank {res['rank']}: {res['steps']} steps, step median "
              f"{res['step_ms_median']!r} ms, collective {res['comm_ms']!r} ms for "
              f"{res['comm_bytes']} B, lookup sum {res['lookup_sum_ms']!r} ms for {res['lookup_sum_bytes']!r} B, "
              f"stall share {res['stall_share']!r}, start-up {res['startup_s']}", flush=True)
    for problem in out["problems"]:
        print(f"[multirank] FAILED: {problem}", file=sys.stderr, flush=True)
    return out["returncode"]


if __name__ == "__main__":
    sys.exit(main())
