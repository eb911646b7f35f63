#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py [--out result.json]

Phases, each of which fails the script (non-zero exit) on any error:

1. build: compile the port's CUDA kernel from its source
   (``ray_shuffling_data_loader_tpu_torch/ops/csrc/interaction.cu``) into
   ``build/kernels/``;
2. kernel: run the interaction kernel at the main path's shape
   ``(65536, 19, 32)`` bf16 and at a ragged ``(500, 27, 16)`` fp32, hold it
   against its plain PyTorch version, and time both beside the kernel's
   bound;
3. slice: write the README's Quick-start dataset (10^6 rows, 10 files,
   5 row groups each), shuffle it for 2 epochs through
   ``DeviceShufflingDataset`` on ``cuda`` (batch 65536, 8 reducers) and
   train the full-width ``dlrm_for_data_spec()`` on every batch. Each
   epoch must deliver every key at most once and exactly the full batches'
   worth, every loss must be finite, and the kernel's launch count over
   the phase must equal the number of steps;
4. parity: one batch through the trained module on ``cuda`` and through
   the same module with the same weights on the CPU, in fp32 with TF32
   off.

Prints a ``{"kernels": [...]}`` line, the card's name and power limit, and
as the last line ``{"ok": true, "device": {...}}``. Exits non-zero, with
no result, when no CUDA device is present.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import shutil
import statistics
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))

MAIN_SHAPE = (65536, 19, 32)
RAGGED_SHAPE = (500, 27, 16)
# bf16: kernel and plain version both sum in fp32 and round once to bf16,
# so a different summation order can move a result by at most one bf16
# step, which is at most 2**-7 of its value. Summing in bf16, or rounding
# twice, errs by several steps and fails.
BF16_TOL = dict(atol=1e-3, rtol=2**-7)
# fp32: the same 16-term dot products summed in another order.
FP32_TOL = dict(atol=1e-5, rtol=1e-5)
# Parity: the same fp32 module on two devices, TF32 off; the interaction
# and the matmuls sum in other orders (K up to 779).
PARITY_TOL = dict(atol=1e-4, rtol=1e-4)

# Device-memory rate of the H100 SXM (NVIDIA data sheet), bytes/s; another
# card's bounds use the rate of a device-to-device copy measured here.
H100_SXM_NAME = "H100 80GB HBM3"
H100_SXM_RATE = 3.35e12
BF16_PEAK = 989e12  # dense tensor-core rate, H100 SXM at 700 W
FP32_PEAK = 67e12


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_name_and_limit() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def memory_rate(torch, name: str):
    """``(bytes/s used for bounds, its source, measured copy rate)``."""
    n = 1 << 28  # 1 GiB of fp32
    a = torch.empty(n, device="cuda")
    b = torch.empty_like(a)
    for _ in range(3):
        b.copy_(a)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    reps = 10
    for _ in range(reps):
        b.copy_(a)
    end.record()
    torch.cuda.synchronize()
    measured = 2 * a.numel() * 4 * reps / (start.elapsed_time(end) / 1e3)
    del a, b
    if H100_SXM_NAME in name:
        return H100_SXM_RATE, f"data sheet ({H100_SXM_NAME})", measured
    return measured, "device-to-device copy", measured


def time_ms(torch, fn, *args, reps: int = 50) -> float:
    for _ in range(3):
        fn(*args)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_build():
    from ray_shuffling_data_loader_tpu_torch.ops import _build

    t0 = time.perf_counter()
    path = _build.build("interaction")
    log(f"[build] interaction in {time.perf_counter() - t0:.2f} s: "
        f"{os.path.relpath(path, ROOT)}")
    for line in _build.build_log("interaction").splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build] interaction: {line.strip()}")


def phase_kernel(torch, name: str) -> dict:
    from ray_shuffling_data_loader_tpu_torch.ops.interaction import (
        dot_interaction_reference,
        interaction_kernel,
        num_pairs,
    )

    # The plain version's fp32 Gram must not round its inputs to TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    errs = {}
    for shape, dtype, tol in (
        (MAIN_SHAPE, torch.bfloat16, BF16_TOL),
        (RAGGED_SHAPE, torch.float32, FP32_TOL),
    ):
        # Embedding-like values: the model's tables start at std 1/sqrt(D).
        x = (torch.randn(shape, device="cuda", generator=gen) / shape[2] ** 0.5).to(dtype)
        got = interaction_kernel(x)
        torch.cuda.synchronize()
        want = dot_interaction_reference(x)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        torch.testing.assert_close(got.float(), want.float(), **tol)
        errs[shape] = err
        log(f"[kernel] interaction {shape} {dtype}: max |kernel - plain| = {err!r} "
            f"(atol {tol['atol']}, rtol {tol['rtol']})")

    b, n, d = MAIN_SHAPE
    x = (torch.randn(MAIN_SHAPE, device="cuda", generator=gen) / d ** 0.5).to(torch.bfloat16)
    ms = time_ms(torch, interaction_kernel, x)
    plain_ms = time_ms(torch, dot_interaction_reference, x)
    rate, rate_src, measured = memory_rate(torch, name)
    nbytes = b * n * d * 2 + b * num_pairs(n) * 2
    ops = 2 * b * num_pairs(n) * d
    bytes_ms = nbytes / rate * 1e3
    ops_ms = ops / BF16_PEAK * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    log(f"[kernel] interaction {MAIN_SHAPE} bf16: kernel {ms!r} ms, plain {plain_ms!r} ms, "
        f"bound {bound_ms!r} ms ({nbytes} B at {rate:.4g} B/s from {rate_src}; "
        f"{ops} ops at bf16 peak {ops_ms!r} ms); measured copy rate {measured:.4g} B/s")
    return {
        "name": "interaction",
        "route": "cuda",
        "source": "ray_shuffling_data_loader_tpu_torch/ops/csrc/interaction.cu",
        "replaces": "ray_shuffling_data_loader_tpu/ops/interaction.py:68",
        "launches": None,
        "max_abs_err": errs[MAIN_SHAPE],
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        # No single PyTorch call computes the strict upper triangle of a
        # batched Gram (bmm plus a gather is two).
        "library_ms": None,
    }


def phase_slice(torch, data_dir: str) -> dict:
    import numpy as np

    import ray_shuffling_data_loader_tpu_torch as port
    from ray_shuffling_data_loader_tpu_torch.ops.interaction import interaction_kernel

    num_rows, batch_size, num_epochs = 10**6, 65536, 2
    port.runtime.init()
    try:
        t0 = time.perf_counter()
        filenames, nbytes = port.generate_data(num_rows, 10, 5, 0.0, data_dir, seed=0)
        log(f"[slice] generated {num_rows} rows ({nbytes} B) in {len(filenames)} files "
            f"in {time.perf_counter() - t0:.2f} s")
        feature_columns = [c for c in port.DATA_SPEC if c != port.LABEL_COLUMN]
        model = port.dlrm_for_data_spec().to("cuda")
        step = port.make_train_step(model, port.make_optimizer(model))
        ds = port.DeviceShufflingDataset(
            filenames, num_epochs=num_epochs, num_trainers=1, batch_size=batch_size,
            rank=0,
            # "key" rides along for the exactly-once check and is dropped
            # before the step.
            feature_columns=[*feature_columns, port.KEY_COLUMN],
            label_column=port.LABEL_COLUMN, num_reducers=8, seed=0, device="cuda",
        )
        interaction_kernel.launches = 0
        steps, step_s, losses, epoch_s = 0, [], [], []
        last = None
        for epoch in range(num_epochs):
            ds.set_epoch(epoch)
            keys = []
            t_epoch = time.perf_counter()
            for features, labels in ds:
                keys.append(features.pop(port.KEY_COLUMN))
                t0 = time.perf_counter()
                loss = step(features, labels)["loss"].item()
                step_s.append(time.perf_counter() - t0)
                losses.append(loss)
                steps += 1
                last = (features, labels)
            epoch_s.append(time.perf_counter() - t_epoch)
            got = torch.cat(keys).cpu().numpy()
            want_rows = (num_rows // batch_size) * batch_size
            if got.size != want_rows or np.unique(got).size != got.size:
                raise AssertionError(f"epoch {epoch}: {got.size} keys, "
                                     f"{np.unique(got).size} distinct; want {want_rows}")
            if got.min() < 0 or got.max() >= num_rows:
                raise AssertionError(f"epoch {epoch}: key out of range")
            log(f"[slice] epoch {epoch}: {got.size} distinct keys exactly once, "
                f"{len(keys)} steps, {epoch_s[-1]!r} s")
        launches = interaction_kernel.launches
        if not all(np.isfinite(losses)):
            raise AssertionError(f"non-finite loss: {losses}")
        if launches != steps:
            raise AssertionError(f"interaction launches {launches} != steps {steps}")
        stats = ds.stats.as_dict()
        median_ms = statistics.median(step_s[1:]) * 1e3
        log(f"[slice] {steps} steps, losses {losses[0]!r} -> {losses[-1]!r}; "
            f"step median {median_ms!r} ms (first {step_s[0] * 1e3!r} ms); "
            f"stall {stats['stall_s']!r} s (upstream {stats['stall_upstream_s']!r}, "
            f"staging {stats['stall_staging_s']!r}) over {stats['stalls']} stalls; "
            f"first batch {stats['first_batch_s']!r} s; epochs {epoch_s!r} s; "
            f"peak device memory {torch.cuda.max_memory_allocated()} B")
        return {
            "model": model,
            "batch": last,
            "launches": launches,
            "steps": steps,
            "step_ms_median": median_ms,
            "step_ms_first": step_s[0] * 1e3,
            "epoch_s": epoch_s,
            "losses": losses,
            "staging": stats,
        }
    finally:
        port.runtime.shutdown()


def phase_parity(torch, model, batch) -> float:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows = 8192
    features = {k: v[:rows] for k, v in batch[0].items()}
    model.compute_dtype = torch.float32
    with torch.no_grad():
        on_gpu = model(features).cpu()
        cpu_model = copy.deepcopy(model).to("cpu")
        on_cpu = cpu_model({k: v.cpu() for k, v in features.items()})
    err = (on_gpu - on_cpu).abs().max().item()
    torch.testing.assert_close(on_gpu, on_cpu, **PARITY_TOL)
    log(f"[parity] {rows} rows fp32, cuda vs cpu: max |diff| = {err!r} "
        f"(atol {PARITY_TOL['atol']}, rtol {PARITY_TOL['rtol']})")
    return err


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="also write the results as JSON here")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    name = torch.cuda.get_device_name(0)
    smi = smi_name_and_limit()
    log(f"[device] {name}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    data_dir = os.path.join(ROOT, "build", "smoke_data")
    t_start = time.perf_counter()
    try:
        phase_build()
        kernel = phase_kernel(torch, name)
        shutil.rmtree(data_dir, ignore_errors=True)
        try:
            sl = phase_slice(torch, data_dir)
        finally:
            shutil.rmtree(data_dir, ignore_errors=True)
        kernel["launches"] = sl["launches"]
        parity_err = phase_parity(torch, sl["model"], sl["batch"])
    except Exception:
        traceback.print_exc()
        print("chip_smoke: a phase failed", file=sys.stderr)
        return 1
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(
                {
                    "device": smi,
                    "kernels": [kernel],
                    "slice": {k: v for k, v in sl.items() if k not in ("model", "batch")},
                    "parity_max_abs_diff": parity_err,
                },
                f, indent=1,
            )
    print(json.dumps({"kernels": [kernel]}))
    print(smi)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
