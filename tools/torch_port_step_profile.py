#!/usr/bin/env python3
"""Where a train step of the PyTorch port's full-width DLRM spends its time
on one NVIDIA GPU.

    python3 tools/torch_port_step_profile.py [--batch 65536] [--steps 20]
        [--compute bf16|fp32] [--trace build/step_trace.json]

Random ids and labels at the main path's batch (no loader: this isolates
the device step), the kernel path for the interaction. Prints:

* the step's phases timed with CUDA events (forward, backward, Adam),
  medians over ``--steps`` steps after warm-up;
* a ``torch.profiler`` window over the same number of steps: device time by
  kernel (top 25) and grouped by kind, and the device's busy share of the
  window's wall time;
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


def device_time_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch", type=int, default=65536)
    parser.add_argument("--steps", type=int, default=20)
    parser.add_argument("--warmup", type=int, default=5)
    parser.add_argument("--compute", choices=["bf16", "fp32"], default="bf16")
    parser.add_argument("--trace", help="write a chrome trace of the profiled window here")
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
    model = port.dlrm_for_data_spec(compute_dtype=cdt).to("cuda")
    opt = port.make_optimizer(model)
    features = port.example_features(model, args.batch, seed=1, device="cuda")
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
    if args.trace:
        os.makedirs(os.path.dirname(os.path.abspath(args.trace)), exist_ok=True)
        prof.export_chrome_trace(args.trace)
    rows = []
    for evt in prof.key_averages():
        if getattr(evt, "device_type", None) is not None and "CUDA" not in str(evt.device_type):
            continue
        # Ranges such as "Optimizer.step#Adam.step" span kernels counted
        # on their own rows.
        if getattr(evt, "is_user_annotation", False) or "#" in evt.key:
            continue
        us = device_time_us(evt)
        if us > 0:
            rows.append((us, evt.count, evt.key))
    rows.sort(reverse=True)
    busy_us = sum(us for us, _, _ in rows)
    print(f"[profile] window {window_us!r} us over {args.steps} steps; device busy "
          f"{busy_us!r} us = {busy_us / window_us!r} of wall")
    by_kind = {}
    for us, _, key in rows:
        by_kind[kind_of(key)] = by_kind.get(kind_of(key), 0.0) + us
    for kind, us in sorted(by_kind.items(), key=lambda kv: -kv[1]):
        print(f"[profile] kind {kind}: {us / args.steps!r} us/step ({us / busy_us:.3f} of busy)")
    for us, count, key in rows[:25]:
        print(f"[profile] {us / args.steps:10.1f} us/step  x{count // args.steps:<4d} {key[:110]}")
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
