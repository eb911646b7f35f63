"""Long-context training: the causal LM with sequence parallelism, one
process per rank.

    python -m ray_shuffling_data_loader_tpu_torch.train_long_context
        --backend gloo|nccl [--dp 2] [--sp 4] [--attention ring [ulysses dense]]
        [--batch 4] [--seq-len 512] [--vocab 64] [--embed-dim 64] [--layers 2]
        [--heads 4] [--steps 20] [--lr 3e-3] [--seed 0]
        [--compute-dtype bfloat16 [float32]] [--device cuda|cpu] [--init-state state.pt]

The port of the JAX package's long-context recipe
(``examples/train_long_context.py``), with its arguments and defaults. The
launcher spawns ``dp × sp`` ranks; rank ``r`` is data index ``r // sp`` and
sp index ``r % sp`` (:func:`~.parallel.make_sp_mesh`) and runs on
``cuda:r % devices`` unless ``--device cpu``. Every rank builds the same
global tokens, ``synthetic_tokens(batch, seq_len, vocab, seed)``, and keeps
its ``[data, sp]`` block: batch rows ``batch / dp`` of its data index,
positions ``seq_len / sp`` of its sp index. The parameters are replicated
(every rank builds the same seeded ``CausalLM``, or loads ``--init-state``).

Attention runs over the rank's sp group: ``ring``
(:func:`~.ops.make_ring_attention`), ``ulysses``
(:func:`~.ops.make_ulysses_attention`), both causal, or ``dense``, the
numerics baseline: q, k and v all-gathered over the group, dense causal
attention over the whole sequence, this rank's rows kept (the backward of
the gather is a reduce-scatter).

The loss is the global next-token loss: each chunk's last target is the
next chunk's first token, the last sp rank drops its final position, every
rank divides its sum by ``batch · (seq_len − 1)``, and the sums are
all-reduced over the world. Gradients of the replicated parameters are
summed over the world, then Adam steps. Several ``--attention`` and
``--compute-dtype`` values run one after another in the same ranks (paying
their start-up once), each from the same initial weights with a fresh
optimizer.

The launcher checks that every rank logged the same losses, that the
parameters are bit-identical on every rank at the end of each run, and
that each run's loss fell; it prints the losses and exits 1 otherwise.
Each rank reports its losses, step times, the host seconds of its
collectives per step (:func:`~.parallel.collectives.comm_seconds`), the
flash kernels' launches, its peak device bytes and its start-up (seconds
since spawn to imports, process groups, first model, first step). This
module imports ``torch`` only inside functions: the launcher runs without
it until it checks the device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from typing import Dict, List

ATTENTIONS = ("ring", "ulysses", "dense")
DTYPES = ("bfloat16", "float32")
FLASH_KERNELS = ("flash_fwd_kernel", "flash_bwd_dkv_kernel", "flash_bwd_dq_kernel")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dp", type=int, default=2, help="data-axis size")
    p.add_argument("--sp", type=int, default=4, help="sequence-axis size")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--seq-len", type=int, default=512)
    p.add_argument("--vocab", type=int, default=64)
    p.add_argument("--embed-dim", type=int, default=64)
    p.add_argument("--layers", type=int, default=2)
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--attention", nargs="+", choices=ATTENTIONS, default=["ring"],
                   help="one run per value, in order")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--compute-dtype", nargs="+", choices=DTYPES, default=["bfloat16"],
                   help="one run per value and attention")
    p.add_argument("--backend", choices=("gloo", "nccl"),
                   help="required: nccl with one CUDA device per rank, gloo for ranks that share one")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--init-state", default=None,
                   help="a CausalLM state_dict (torch.save) to start every run from")
    p.add_argument("--timeout", type=float, default=600.0, help="seconds for the whole run")
    # Set for the rank processes the launcher starts.
    p.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--spec", default=None, help=argparse.SUPPRESS)
    p.add_argument("--spawned-at", type=float, default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.rank is not None:
        return args
    if args.backend is None:
        p.error("--backend is required")
    if args.steps < 2:
        p.error("--steps must be >= 2 (the run asserts the loss falls)")
    if args.dp < 1 or args.sp < 1 or args.batch % args.dp or args.seq_len % args.sp:
        p.error(f"--batch {args.batch} and --seq-len {args.seq_len} must divide by --dp {args.dp} "
                f"and --sp {args.sp}")
    if "ulysses" in args.attention and args.heads % args.sp:
        p.error(f"ulysses attention needs --heads {args.heads} divisible by --sp {args.sp}")
    return args


# -- one rank -------------------------------------------------------------------


def attention_fn(kind: str, mesh):
    """The causal attention ``kind`` over ``mesh``'s sp group."""
    from ray_shuffling_data_loader_tpu_torch.ops import make_ring_attention, make_ulysses_attention

    if kind == "ring":
        return make_ring_attention(mesh.sp_group, causal=True)
    if kind == "ulysses":
        return make_ulysses_attention(mesh.sp_group, causal=True)
    if kind == "dense":
        return dense_attention(mesh.sp_group, mesh.sp_index)
    raise ValueError(f"attention must be one of {ATTENTIONS}, got {kind!r}")


def dense_attention(group, sp_index: int):
    """Dense causal attention over the whole sequence for this rank's rows:
    q, k and v all-gathered over ``group`` in one call."""
    import torch

    from ray_shuffling_data_loader_tpu_torch.ops import attention_reference
    from ray_shuffling_data_loader_tpu_torch.parallel.collectives import all_gather

    def dense(q, k, v):
        tl = q.shape[1]
        qkv = all_gather(torch.stack((q, k, v), dim=2), group, dim=1)
        out = attention_reference(*qkv.unbind(2), causal=True)
        return out[:, sp_index * tl:(sp_index + 1) * tl]

    return dense


def token_shard(tokens, mesh):
    """``(inputs, targets, start)``: this rank's ``[data, sp]`` block of the
    global ``tokens`` ``[B, T]``, the next token of each of its positions
    (one fewer on the last sp rank) and the block's first global position."""
    b, t = tokens.shape
    bl, tl = b // mesh.data_size, t // mesh.sp_size
    rows = slice(mesh.data_index * bl, (mesh.data_index + 1) * bl)
    start = mesh.sp_index * tl
    return tokens[rows, start:start + tl], tokens[rows, start + 1:start + tl + 1], start


def shard_loss(logits, targets, count: int):
    """This rank's share of the global next-token loss: the summed
    cross-entropy of its positions that have a target, over ``count`` (the
    global ``B · (T − 1)``)."""
    import torch.nn.functional as F

    n = targets.shape[1]
    logp = F.log_softmax(logits[:, :n], dim=-1)
    picked = logp.gather(-1, (targets % logits.shape[-1]).long()[..., None])
    return -picked.sum() / count


def _launches(ops) -> Dict[str, int]:
    counts = {}
    for name in FLASH_KERNELS:
        fn = getattr(ops, name)
        counts[name.removesuffix("_kernel")] = fn.launches
        counts[name.removesuffix("_kernel") + "_mma"] = fn.mma_launches
    return counts


def _train(spec, mesh, device, kind: str, dtype_name: str, tokens, init_state, mark) -> dict:
    """One run on this rank: ``spec["steps"]`` Adam steps of the attention
    ``kind`` in ``dtype_name``."""
    import torch
    import torch.distributed as dist

    import ray_shuffling_data_loader_tpu_torch.ops as ops
    from ray_shuffling_data_loader_tpu_torch.models import CausalLM
    from ray_shuffling_data_loader_tpu_torch.multirank import _digest
    from ray_shuffling_data_loader_tpu_torch.parallel import make_optimizer
    from ray_shuffling_data_loader_tpu_torch.parallel.collectives import all_reduce_, comm_seconds, reset_comm_seconds
    from ray_shuffling_data_loader_tpu_torch.parallel.train import _flatten, _unflatten_into

    model = CausalLM(
        spec["vocab"], spec["seq_len"], embed_dim=spec["embed_dim"], num_layers=spec["layers"],
        num_heads=spec["heads"], compute_dtype=getattr(torch, dtype_name), device=device,
        attention_fn=attention_fn(kind, mesh),
    )
    if init_state is not None:
        model.load_state_dict(init_state)
    mark("model")
    opt = make_optimizer(model, lr=spec["lr"])
    mark("optimizer")
    params = [p for p in model.parameters() if p.requires_grad]
    inputs, targets, start = token_shard(tokens, mesh)
    inputs, targets = inputs.to(device), targets.to(device)
    count = spec["batch"] * (spec["seq_len"] - 1)
    world = dist.group.WORLD
    for name in FLASH_KERNELS:
        getattr(ops, name).launches = getattr(ops, name).mma_launches = 0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    losses, step_s, comm_s = [], [], []
    for _ in range(spec["steps"]):
        reset_comm_seconds()
        t0 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        loss = shard_loss(model(inputs, start), targets, count)
        loss.backward()
        grads = [p.grad for p in params]
        buffers = _flatten(grads, None)
        for buf in buffers:
            all_reduce_(buf, world)
        _unflatten_into(buffers, grads, None)
        total = all_reduce_(loss.detach().clone(), world)
        opt.step()
        losses.append(total.item())
        step_s.append(time.perf_counter() - t0)
        comm_s.append(comm_seconds())
        mark("first_step")
    launches = _launches(ops)
    steps_ms = [s * 1e3 for s in step_s]
    return {
        "attention": kind,
        "compute_dtype": dtype_name,
        "losses": losses,
        "step_ms": steps_ms,
        "step_ms_median": statistics.median(steps_ms[1:]),
        "comm_ms": [c * 1e3 for c in comm_s],
        "comm_share": statistics.median(c / s for c, s in zip(comm_s[1:], step_s[1:])),
        "launches": launches,
        "peak_device_bytes": torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None,
        "params_sha256": _digest(model.state_dict()),
    }


def run_rank(spec: dict, rank: int, spawned_at: float) -> int:
    """One rank of the run ``spec`` (written by the launcher), spawned at
    ``spawned_at`` (``time.time()``)."""
    startup: Dict[str, float] = {}

    def mark(label: str) -> None:
        startup.setdefault(label, time.time() - spawned_at)

    import torch
    import torch.distributed as dist

    from ray_shuffling_data_loader_tpu_torch.models import synthetic_tokens
    from ray_shuffling_data_loader_tpu_torch.parallel import init_data_parallel, make_sp_mesh

    mark("imports")
    world = spec["dp"] * spec["sp"]
    if spec["device"] == "cuda":
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    init_data_parallel(rank, world, spec["backend"], spec["init_method"])
    mesh = make_sp_mesh(spec["sp"])
    mark("groups")
    tokens = torch.from_numpy(synthetic_tokens(spec["batch"], spec["seq_len"], spec["vocab"], seed=spec["seed"]))
    init_state = torch.load(spec["init_state"]) if spec["init_state"] else None
    runs = [_train(spec, mesh, device, kind, dtype, tokens, init_state, mark)
            for dtype in spec["compute_dtype"] for kind in spec["attention"]]
    mark("last_step")
    dist.barrier()
    dist.destroy_process_group()
    mark("teardown")
    result = {"rank": rank, "data_index": mesh.data_index, "sp_index": mesh.sp_index, "device": str(device),
              "runs": runs, "startup_s": startup}
    with open(os.path.join(spec["out_dir"], f"rank{rank}.json"), "w") as f:
        json.dump(result, f)
    return 0


# -- the launcher -----------------------------------------------------------------


def check(results: List[dict]) -> List[str]:
    """The run's failures: for each attention and dtype, ranks that logged
    other losses than rank 0, non-finite losses, a loss that did not fall,
    and parameters that differ between ranks."""
    import math

    problems = []
    for i, run in enumerate(results[0]["runs"]):
        label = f"{run['attention']} {run['compute_dtype']}"
        runs = [res["runs"][i] for res in results]
        if any(r["losses"] != run["losses"] for r in runs):
            problems.append(f"{label}: ranks logged different losses")
        if not all(math.isfinite(x) for x in run["losses"]):
            problems.append(f"{label}: a loss is not finite")
        elif not run["losses"][-1] < run["losses"][0]:
            problems.append(f"{label}: the loss did not fall: {run['losses'][0]!r} -> {run['losses'][-1]!r}")
        if len({r["params_sha256"] for r in runs}) != 1:
            problems.append(f"{label}: ranks ended with different parameters")
    return problems


def run(args: argparse.Namespace) -> Dict:
    """Drive one run: ``{"returncode", "ranks": [per-rank results],
    "problems": [...]}``. Raises ``RuntimeError`` before spawning when
    ``--device cuda`` finds no CUDA device."""
    from ray_shuffling_data_loader_tpu_torch.multirank import _free_port, wait_ranks

    if args.device == "cuda":
        from ray_shuffling_data_loader_tpu_torch.utils.device import resolve_device

        resolve_device("cuda")
    world = args.dp * args.sp
    with tempfile.TemporaryDirectory(prefix="train_long_context-") as out_dir:
        spec = {
            **{k: v for k, v in vars(args).items() if k not in ("rank", "spec", "spawned_at")},
            "init_method": f"tcp://localhost:{_free_port()}",
            "out_dir": out_dir,
        }
        spec_path = os.path.join(out_dir, "spec.json")
        with open(spec_path, "w") as f:
            json.dump(spec, f)
        # The ranks import this package from where this process found it.
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        path = os.pathsep.join(p for p in (root, os.environ.get("PYTHONPATH")) if p)
        env = dict(os.environ, PYTHONPATH=path)
        cmd = [sys.executable, "-m", "ray_shuffling_data_loader_tpu_torch.train_long_context", "--spec", spec_path]
        procs = [subprocess.Popen([*cmd, "--rank", str(r), "--spawned-at", repr(time.time())], env=env)
                 for r in range(world)]
        returncode, codes = wait_ranks(procs, args.timeout)
        results, problems = [], [f"rank exit codes {codes}"]
        if returncode == 0:
            for r in range(world):
                with open(os.path.join(out_dir, f"rank{r}.json")) as f:
                    results.append(json.load(f))
            problems = check(results)
            if problems:
                returncode = 1
    return {"returncode": returncode, "ranks": results, "problems": problems}


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.rank is not None:
        with open(args.spec) as f:
            return run_rank(json.load(f), args.rank, args.spawned_at)
    print(f"mesh: data {args.dp} x sp {args.sp}, seq {args.seq_len} -> {args.seq_len // args.sp} per rank",
          flush=True)
    out = run(args)
    if out["ranks"]:
        for i, res in enumerate(out["ranks"][0]["runs"]):
            losses = res["losses"]
            for step in range(0, len(losses), 5):
                print(f"step {step}: loss {losses[step]:.4f}", flush=True)
            print(f"{len(losses)} steps ({res['attention']} attention, {res['compute_dtype']}): loss "
                  f"{losses[0]:.4f} -> {losses[-1]:.4f}; step median {res['step_ms_median']:.2f} ms, "
                  f"collectives {res['comm_share']:.1%} of it; launches {res['launches']}", flush=True)
    for problem in out["problems"]:
        print(f"[train_long_context] FAILED: {problem}", file=sys.stderr, flush=True)
    return out["returncode"]


if __name__ == "__main__":
    sys.exit(main())
