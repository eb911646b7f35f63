"""Data-parallel DLRM training with one process per trainer rank.

    python -m ray_shuffling_data_loader_tpu_torch.multirank --num-trainers N
        --backend gloo|nccl [--step ddp|psum] [--grad-reduce mean|adasum]
        [--grad-dtype bfloat16] [--epochs 2] [--batch-size 65536]
        [--max-steps S] [--device cuda|cpu] [--data-dir DIR]

The launcher creates the runtime session and writes the dataset (10^6 rows
in 10 Parquet files by default), then launches N rank processes with
``$RSDL_RUNTIME_DIR`` exported so that each joins the session. Each rank
joins the data-parallel process group, builds the full-width
``dlrm_for_data_spec()`` (rank 0's weights are broadcast), iterates its
shard of every epoch through ``DeviceShufflingDataset`` and takes one
step per batch, with ``DistributedDataParallel`` (``--step ddp``, mean)
or the explicit reduction of ``make_psum_train_step`` (``--step psum``,
mean or Adasum, optionally bf16 on the wire). Rank 0 spawns the batch
queue actor and runs the shuffle in its worker pool; the other ranks
connect to the queue by name.

Ranks' shards differ in length (reducers split into contiguous runs). All
ranks keep stepping until the last one runs out, so their collectives stay
matched: a rank whose shard is done steps on its last batch with its loss
weighted 0 (``idle``), and the gradient is the mean over the ranks that
brought a batch. Every delivered batch is trained; only ``--max-steps``
leaves the rest of a shard delivered and counted but untrained.

The backend is always explicit: ``nccl`` with one CUDA device per rank,
``gloo`` where ranks share a device. Rank ``r`` uses ``cuda:r % devices``.

The launcher checks the run: every epoch delivers each key at most once
and each rank exactly its full batches, every loss is finite, every rank
logs the same loss at every step (the global batch's), and every rank
ends with the same parameters, bit for bit. It returns the worst exit
code of the ranks (a rank that fails fails the run) and 1 if a check
fails. This module imports ``torch`` only inside the rank's functions: a
rank runs it as ``__main__``, and its spawned shuffle workers import
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
from typing import Dict, List, Optional

RANKS_DIR = "multirank"
QUEUE_NAME = "multirank-queue"


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--num-trainers", type=int, default=2)
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
    args = p.parse_args(argv)
    if args.rank is None and args.backend is None:  # a rank reads it from the spec
        p.error("--backend is required")
    if args.step == "ddp" and (args.grad_reduce != "mean" or args.grad_dtype):
        p.error("--grad-reduce adasum and --grad-dtype need --step psum")
    return args


# -- one rank -------------------------------------------------------------------


def _param_digest(model) -> str:
    import torch

    digest = hashlib.sha256()
    for name, tensor in sorted(model.state_dict().items()):
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


def run_rank(spec: dict, rank: int) -> int:
    """One trainer rank of the run ``spec`` (written by the launcher)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    import ray_shuffling_data_loader_tpu_torch as port
    import ray_shuffling_data_loader_tpu_torch.ops as ops
    from ray_shuffling_data_loader_tpu_torch.parallel import (
        adasum_reduce,
        init_data_parallel,
        make_optimizer,
        make_psum_train_step,
        make_train_step,
        ranks_with_batch,
    )
    from ray_shuffling_data_loader_tpu_torch.parallel.train import _flatten, _gathered_sum
    from ray_shuffling_data_loader_tpu_torch.runtime.store import free_bytes

    world = spec["num_trainers"]
    ctx = port.runtime.init(num_workers=spec["num_workers"])
    if spec["device"] == "cuda":
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    group = init_data_parallel(rank, world, spec["backend"], spec["init_method"])
    flag_device = device if spec["backend"] == "nccl" else torch.device("cpu")
    features = [c for c in port.DATA_SPEC if c != port.LABEL_COLUMN]
    # Rank 0 spawns the queue actor and starts the shuffle; the others
    # connect once it exists. The model is built while the shuffle runs.
    if rank != 0:
        dist.barrier()
    ds = port.DeviceShufflingDataset(
        spec["filenames"], spec["epochs"], world, spec["batch_size"], rank,
        feature_columns=[*features, port.KEY_COLUMN], label_column=port.LABEL_COLUMN,
        num_reducers=spec["num_reducers"], seed=spec["seed"], queue_name=spec["queue_name"],
        device=device,
    )
    if rank == 0 and world > 1:
        dist.barrier()
    model = port.dlrm_for_data_spec(
        embed_dim=spec["embed_dim"], vocab_cap=spec["vocab_cap"],
        compute_dtype=getattr(torch, spec["compute_dtype"]), device=device,
    )
    optimizer = make_optimizer(model)
    grad_dtype = getattr(torch, spec["grad_dtype"]) if spec["grad_dtype"] else None
    if spec["step"] == "ddp":
        step = make_train_step(model, optimizer, group)
    else:
        step = make_psum_train_step(model, optimizer, group, grad_dtype=grad_dtype, grad_reduce=spec["grad_reduce"])
    for fn in (ops.interaction_kernel, ops.flash_fwd_kernel, ops.flash_bwd_dkv_kernel, ops.flash_bwd_dq_kernel):
        fn.launches = fn.mma_launches = 0
    losses, step_s, epochs = [], [], []
    last = None  # this rank's last batch: what it steps on once its shard is done
    for epoch in range(spec["epochs"]):
        ds.set_epoch(epoch)
        keys, steps, idle, drained = [], 0, 0, 0
        t_epoch = time.perf_counter()
        stall0 = ds.stats.stall_s
        it = iter(ds)
        item = next(it, None)
        while spec["max_steps"] is None or steps < spec["max_steps"]:
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
        # Delivered, not trained: what --max-steps left of this rank's shard.
        rest = [] if item is None else [item]
        for feats, _ in [*rest, *it]:
            keys.append(feats[port.KEY_COLUMN])
            drained += 1
        wall = time.perf_counter() - t_epoch
        got = torch.cat(keys).cpu().numpy() if keys else np.zeros(0, np.int32)
        np.save(os.path.join(spec["out_dir"], f"rank{rank}-epoch{epoch}.npy"), got)
        host = ds.dataset
        epochs.append({
            "steps": steps, "idle": idle, "drained": drained, "rows_read": host.rows_read, "keys": int(got.size),
            "wall_s": wall, "stall_s": ds.stats.stall_s - stall0, "first_batch_s": ds.stats.first_batch_s,
            "get_batch_min_s": min(host.get_batch_s), "get_batch_median_s": statistics.median(host.get_batch_s),
        })
        print(f"[rank {rank}] epoch {epoch}: {steps} steps ({idle} idle), {drained} batches drained, "
              f"{got.size} keys of {host.rows_read} rows read, {wall:.2f} s", flush=True)
    ds.join()
    # A stand-in for the step's collective, timed alone on buffers of the
    # same bytes on every rank: DDP's own all-reduce runs in buckets that
    # overlap the backward pass and is not timed apart from it.
    buffers = _flatten([p.detach() for p in model.parameters()], grad_dtype)
    if spec["grad_reduce"] == "adasum":
        comm_s = _time_collective(lambda: adasum_reduce(buffers, group), device)
    elif grad_dtype is not None:
        comm_s = _time_collective(lambda: [_gathered_sum(b, group) for b in buffers], device)
    else:
        comm_s = _time_collective(lambda: [dist.all_reduce(b, group=group) for b in buffers], device)
    comm_bytes = sum(b.numel() * b.element_size() for b in buffers)
    launches = {
        name: {"launches": fn.launches, "mma_launches": fn.mma_launches}
        for name, fn in (("interaction", ops.interaction_kernel), ("flash_fwd", ops.flash_fwd_kernel),
                         ("flash_bwd_dkv", ops.flash_bwd_dkv_kernel), ("flash_bwd_dq", ops.flash_bwd_dq_kernel))
    }
    result = {
        "rank": rank,
        "device": str(device),
        "steps": sum(e["steps"] for e in epochs),
        "losses": losses,
        "step_ms_median": statistics.median(step_s[1:] or step_s) * 1e3 if step_s else None,
        "step_ms_first": step_s[0] * 1e3 if step_s else None,
        "comm_ms": comm_s * 1e3,
        "comm_bytes": comm_bytes,
        "stall_share": sum(e["stall_s"] for e in epochs) / sum(e["wall_s"] for e in epochs),
        "epochs": epochs,
        "launches": launches,
        "params_sha256": _param_digest(model),
        "pool_ready_s": ctx._pool.ready_s if ctx._pool is not None else None,
        "shm_dir": ctx.store.shm_dir,
        "shm_free_bytes": free_bytes(ctx.store.shm_dir),
        "store_peak_bytes": ds.dataset.shuffle_stats.get("store_peak_bytes"),
        "peak_device_bytes": torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None,
    }
    with open(os.path.join(spec["out_dir"], f"rank{rank}.json"), "w") as f:
        json.dump(result, f)
    dist.barrier()  # every rank is done with the queue before rank 0 stops it
    dist.destroy_process_group()
    port.runtime.shutdown()
    return 0


# -- the launcher -----------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def check(spec: dict, results: List[dict]) -> List[str]:
    """The run's failures: exactly once per epoch across ranks, each rank
    exactly its full batches, every batch trained (unless ``--max-steps``
    cut the epoch), finite losses, the same loss logged by every rank at
    every step, equal parameters."""
    import numpy as np

    problems = []
    batch = spec["batch_size"]
    for epoch in range(spec["epochs"]):
        keys = [np.load(os.path.join(spec["out_dir"], f"rank{r}-epoch{epoch}.npy")) for r in range(len(results))]
        union = np.concatenate(keys)
        rows = [res["epochs"][epoch]["rows_read"] for res in results]
        if np.unique(union).size != union.size:
            problems.append(f"epoch {epoch}: {union.size - np.unique(union).size} keys delivered twice")
        if union.size and (union.min() < 0 or union.max() >= spec["num_rows"]):
            problems.append(f"epoch {epoch}: key out of range")
        if sum(rows) != spec["num_rows"]:
            problems.append(f"epoch {epoch}: ranks read {sum(rows)} rows, want {spec['num_rows']}")
        for r, (k, n) in enumerate(zip(keys, rows)):
            if k.size != n // batch * batch:
                problems.append(f"epoch {epoch} rank {r}: {k.size} keys, want {n // batch * batch}")
            drained = results[r]["epochs"][epoch]["drained"]
            if spec["max_steps"] is None and drained:
                problems.append(f"epoch {epoch} rank {r}: {drained} delivered batches not trained")
    if not all(np.isfinite(res["losses"]).all() for res in results):
        problems.append("a loss is not finite")
    if any(res["losses"] != results[0]["losses"] for res in results):
        problems.append("ranks logged different losses")
    if len({res["params_sha256"] for res in results}) != 1:
        problems.append("ranks ended with different parameters")
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
            **{k: v for k, v in vars(args).items() if k not in ("rank", "spec")},
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
        procs = [subprocess.Popen([*cmd, "--rank", str(r)], env=env) for r in range(args.num_trainers)]
        deadline = time.monotonic() + args.timeout
        codes: List[Optional[int]] = [None] * len(procs)
        try:
            while any(c is None for c in codes):
                codes = [p.poll() for p in procs]
                # A failed rank leaves the others blocked in a collective.
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
        results, problems = [], []
        if returncode == 0:
            for r in range(args.num_trainers):
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
            return run_rank(json.load(f), args.rank)
    out = run(args)
    for res in out["ranks"]:
        print(f"[multirank] rank {res['rank']}: {res['steps']} steps, step median "
              f"{res['step_ms_median']!r} ms, collective {res['comm_ms']!r} ms for "
              f"{res['comm_bytes']} B, stall share {res['stall_share']!r}", flush=True)
    for problem in out["problems"]:
        print(f"[multirank] FAILED: {problem}", file=sys.stderr, flush=True)
    return out["returncode"]


if __name__ == "__main__":
    sys.exit(main())
