#!/usr/bin/env python3
"""Where a train step of the PyTorch port's full-width DLRM or
TabTransformer spends its time on one NVIDIA GPU.

    python3 tools/torch_port_step_profile.py [--model dlrm|transformer]
        [--batch 65536] [--steps 20] [--compute bf16|fp32]
        [--trace build/step_trace.json]

Random ids and labels at the main path's batch (no loader: this isolates
the device step), the kernel path for the interaction and the flash
attention. Prints:

* the step's phases timed with CUDA events (forward, backward, Adam),
  medians over ``--steps`` steps after warm-up;
* a ``torch.profiler`` window over the same number of steps, read from its
  chrome trace: device time by kernel (top 25), grouped by kind, and
  grouped by the op that launched it (in the backward the autograd node,
  such as ``SelectBackward0``; in the forward and the optimizer the
  outermost op), and the device's busy share of the window's wall time;
* the card's name and power limit.

Exits 2 with no result when no CUDA device is present.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Kernel-name fragments -> kind, first match wins.
KINDS = [
    ("interaction", "interaction kernel"),
    ("flash_fwd_kernel", "flash forward kernel"),
    ("flash_bwd_dkv_kernel", "flash dK/dV kernel"),
    ("flash_bwd_dq_kernel", "flash dQ kernel"),
    ("embedding_backward", "embedding backward"),
    ("embedding_dense", "embedding backward"),
    ("index_put", "embedding backward"),
    ("scatter", "embedding backward"),
    ("sort", "embedding backward"),
    ("indexselect", "embedding forward"),
    ("index_select", "embedding forward"),
    ("gather", "embedding forward"),
    ("multi_tensor_apply", "adam"),
    ("adam", "adam"),
    ("gemm", "matmul"),
    ("sm90_xmma", "matmul"),
    ("cutlass", "matmul"),
    ("memset", "memset"),
    ("memcpy", "memcpy"),
    ("reduce", "reduction"),
]


def kind_of(name: str) -> str:
    low = name.lower()
    for frag, kind in KINDS:
        if frag in low:
            return kind
    return "elementwise/other"


def device_events(trace_path: str):
    """``[(kernel name, op, device us)]`` for every kernel, memset and copy
    in a chrome trace of the profiler. ``op`` is the op that launched it
    (linked by ``External id``), followed up that op's nesting on its
    thread to the autograd node running it (``bwd <node>``) or, outside
    the backward, to the outermost op (``fwd <op>``)."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    by_thread, by_ext = {}, {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in ("cpu_op", "user_annotation"):
            by_thread.setdefault((e["pid"], e["tid"]), []).append(e)
            if e["cat"] == "cpu_op":
                by_ext[e["args"].get("External id")] = e
    label = {}
    for ops in by_thread.values():
        ops.sort(key=lambda e: (e["ts"], -e["dur"]))
        stack = []  # enclosing ops, outermost first
        for e in ops:
            while stack and stack[-1]["ts"] + stack[-1]["dur"] < e["ts"]:
                stack.pop()
            name = e["name"]
            parent = label.get(id(stack[-1])) if stack else None
            if name.startswith("autograd::engine::evaluate_function: "):
                label[id(e)] = "bwd " + name.split(": ", 1)[1]
            elif parent is not None:
                label[id(e)] = parent
            elif e["cat"] == "cpu_op" and not name.startswith("ProfilerStep"):
                label[id(e)] = "fwd " + name
            stack.append(e)
    out = []
    for e in events:
        if e.get("cat") in ("kernel", "gpu_memset", "gpu_memcpy"):
            op = by_ext.get(e.get("args", {}).get("External id"))
            out.append((e["name"], label.get(id(op), "unattributed"), float(e["dur"])))
    return out


def totals(rows, key):
    """``[(key, device us, count)]`` summed over ``rows``, largest first."""
    acc = {}
    for row in rows:
        k = key(row)
        us, n = acc.get(k, (0.0, 0))
        acc[k] = (us + row[2], n + 1)
    return sorted(((k, us, n) for k, (us, n) in acc.items()), key=lambda r: -r[1])


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--model", choices=["dlrm", "transformer"], default="dlrm")
    parser.add_argument("--batch", type=int, default=65536)
    parser.add_argument("--steps", type=int, default=20)
    parser.add_argument("--warmup", type=int, default=5)
    parser.add_argument("--compute", choices=["bf16", "fp32"], default="bf16")
    parser.add_argument("--trace", help="write the chrome trace of the profiled window here "
                        "(default build/step_trace.json)")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import ray_shuffling_data_loader_tpu_torch as port

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    cdt = {"bf16": torch.bfloat16, "fp32": torch.float32}[args.compute]
    build = {"dlrm": port.dlrm_for_data_spec, "transformer": port.transformer_for_data_spec}
    model = build[args.model](compute_dtype=cdt)
    opt = port.make_optimizer(model)
    features = port.example_features(model, args.batch, seed=1)
    labels = torch.rand(args.batch, generator=torch.Generator().manual_seed(2)).to("cuda")

    def step():
        opt.zero_grad(set_to_none=True)
        loss = port.bce_loss(model(features), labels)
        loss.backward()
        opt.step()
        return loss

    for _ in range(args.warmup):
        step()
    torch.cuda.synchronize()

    # Phases with CUDA events.
    phases = {"forward": [], "backward": [], "adam": [], "step": []}
    for _ in range(args.steps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        opt.zero_grad(set_to_none=True)
        ev[0].record()
        loss = port.bce_loss(model(features), labels)
        ev[1].record()
        loss.backward()
        ev[2].record()
        opt.step()
        ev[3].record()
        torch.cuda.synchronize()
        phases["forward"].append(ev[0].elapsed_time(ev[1]))
        phases["backward"].append(ev[1].elapsed_time(ev[2]))
        phases["adam"].append(ev[2].elapsed_time(ev[3]))
        phases["step"].append(ev[0].elapsed_time(ev[3]))
    medians = {k: statistics.median(v) for k, v in phases.items()}
    print("[phases] median ms over", args.steps, "steps:", json.dumps(medians))

    # Host wall time of back-to-back steps, synchronised once at the end.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / args.steps * 1e3
    print(f"[wall] back-to-back step {wall_ms!r} ms")

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step()
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
    trace = args.trace or os.path.join(ROOT, "build", "step_trace.json")
    os.makedirs(os.path.dirname(os.path.abspath(trace)), exist_ok=True)
    prof.export_chrome_trace(trace)
    # Device times from the trace's kernel, memset and copy events (CUPTI's
    # own durations; one stream, so they never overlap).
    rows = device_events(trace)
    busy_us = sum(us for _, _, us in rows)
    n = args.steps
    print(f"[profile] window {window_us!r} us over {n} steps; device busy "
          f"{busy_us!r} us = {busy_us / window_us!r} of wall")
    # The profiler slows the host; the back-to-back step ran without it.
    print(f"[profile] device busy {busy_us / n / 1e3!r} ms per step = "
          f"{busy_us / n / 1e3 / wall_ms!r} of the back-to-back step")
    for kind, us, _ in totals(rows, lambda r: kind_of(r[0])):
        print(f"[profile] kind {kind}: {us / n!r} us/step ({us / busy_us:.3f} of busy)")
    for name, us, count in totals(rows, lambda r: r[0])[:25]:
        print(f"[profile] {us / n:10.1f} us/step  x{count / n:<6.1f} {name[:110]}")
    for op, us, count in totals(rows, lambda r: r[1])[:30]:
        print(f"[by op] {us / n:10.1f} us/step  x{count / n:<6.1f} {op}")
    print(f"[profile] model {args.model}, {args.compute} compute, batch {args.batch}")
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
