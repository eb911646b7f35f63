#!/usr/bin/env python3
"""Time the short route's forward kernel (``ops/csrc/flash_fwd_short.cu``)
against variants of itself on one NVIDIA GPU, to see what holds it back.

    python3 tools/torch_port_short_fwd_variants.py [--shape 65536,19,4,8] [--out result.json]

At a bf16 ``[b, t, h, hd]`` shape the short route takes (default the
TabTransformer's), in one process on one card: the kernel as shipped,
through its wrapper, and the CUDA-core K2 it replaces; then the same
source compiled with one change each, called through ctypes on the same
inputs:

- ``staging_only``: no head is computed; the input rows still arrive by
  bulk copy, step by step, and the (stale) output rows still leave. Its
  time is the staging pipeline's alone.
- ``stages_3``, ``stages_4``: that many block steps in flight instead of 2.
- ``heads_4``, ``heads_16``: one (four) heads per warp and block step
  (4 or 16 heads a step where h is 4) instead of two.
- ``warps_8``: 8 warps of one head each, 8 heads a step.
- ``regs_56``: registers capped for 9 blocks of 4 warps an SM.
- ``p_hi_only``: P V with P's hi term alone (another function: the cost
  of the lo term, not held to the plain version).

Each is timed as ``chip_smoke.time_ms`` times a kernel (the card spins
while the host queues 50 calls), with its registers and spills from
``ptxas -v`` and the SASS instructions of its instantiation for the
shape's (hd, ceil(t / 8)) from ``cuobjdump -sass``, where the toolkit has
it; each variant that computes the same function is held to the plain
forward at ``chip_smoke``'s tolerances. Variants build under
``build/short_fwd_variants/``. Prints one line per kernel and, with
``--out``, writes them as JSON. Exits 2 without a card.
"""

import argparse
import concurrent.futures
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "ray_shuffling_data_loader_tpu_torch", "ops", "csrc")
SOURCE = "flash_fwd_short.cu"
# {name: ({text: replacement} over the source and its headers, holds the function)}
VARIANTS = {
    "staging_only": ({"hx < nrows * h; hx += warps) {": "hx < 0; hx += warps) {"}, False),
    "stages_3": ({"kStages = 2;": "kStages = 3;"}, True),
    "stages_4": ({"kStages = 2;": "kStages = 4;"}, True),
    "heads_4": ({"kStepHeads = 8;": "kStepHeads = 4;"}, True),
    "heads_16": ({"kStepHeads = 8;": "kStepHeads = 16;"}, True),
    "warps_8": ({"kMaxWarps = 4;": "kMaxWarps = 8;"}, True),
    "regs_56": ({"__launch_bounds__(kMaxWarps * 32)": "__launch_bounds__(kMaxWarps * 32, 9)"}, True),
    "p_hi_only": ({"            mma_bf16(o[mq][nt], pl, vb[kk][nt][0], vb[kk][nt][1]);\n": ""}, False),
}


def sass_instructions(lib_path: str, hd: int, nq: int):
    """Instructions of the kernel's ``<hd, nq>`` instantiation in the
    library's SASS, or None where ``cuobjdump`` is missing."""
    from ray_shuffling_data_loader_tpu_torch.ops import _build

    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    if not os.path.isfile(tool):
        return None
    sass = subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True, check=True).stdout
    tag = f"ILi{hd}ELi{nq}EE"
    count, inside = 0, False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = tag in line
        elif inside and re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+\S", line):
            count += 1
    return count


def ptxas_resources(log: str, hd: int, nq: int) -> dict:
    """Registers and spill-store bytes ``ptxas -v`` gave the kernel's
    ``<hd, nq>`` instantiation."""
    tag, inside, found = f"ILi{hd}ELi{nq}EE", False, {}
    for line in log.splitlines():
        if "Compiling entry function" in line:
            inside = tag in line
        elif inside and "spill stores" in line:
            found["spill_bytes"] = int(re.search(r"(\d+) bytes spill stores", line).group(1))
        elif inside and "Used" in line and "registers" in line:
            found["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
    return found


def build_variant(build, name: str, changes: dict) -> tuple:
    """``(library path, compiler log)`` of the shipped source with
    ``changes`` applied to it and its headers."""
    vdir = os.path.join(ROOT, "build", "short_fwd_variants", name)
    shutil.rmtree(vdir, ignore_errors=True)
    os.makedirs(vdir)
    files = [SOURCE] + sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    left = dict(changes)
    for fname in files:
        with open(os.path.join(CSRC, fname)) as f:
            text = f.read()
        for old, new in changes.items():
            if old in text:
                text = text.replace(old, new)
                left.pop(old, None)
        with open(os.path.join(vdir, fname), "w") as f:
            f.write(text)
    if left:
        raise RuntimeError(f"variant {name}: {list(left)} not found in {files}")
    lib_path = os.path.join(vdir, "flash_fwd_short.so")
    proc = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, os.path.join(vdir, SOURCE), "-o", lib_path],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"variant {name}: nvcc exited {proc.returncode}\n{proc.stdout}{proc.stderr}")
    return lib_path, proc.stdout + proc.stderr


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--shape", default="65536,19,4,8", help="b,t,h,hd (default the TabTransformer's)")
    parser.add_argument("--out", help="also write the results as JSON here")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_port_short_fwd_variants: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as smoke
    import ray_shuffling_data_loader_tpu_torch.ops as ops
    from ray_shuffling_data_loader_tpu_torch.ops import _build

    shape = tuple(int(x) for x in args.shape.split(","))
    b, t, h, hd = shape
    nq = (t + 7) // 8
    smi = smoke.smi_name_and_limit()
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(1)
    qkv, _ = smoke.flash_inputs(torch, shape, torch.bfloat16, gen)
    q, k, v = qkv.unbind(2)
    if not ops.short_fwd_supported(q, k, v):
        print(f"torch_port_short_fwd_variants: the short route does not take {shape}", file=sys.stderr)
        return 1
    want = ops.flash_forward_reference(q, k, v)
    tol = smoke.FLASH_TOL["bfloat16"]["out"]
    nbytes, nops = smoke.flash_work(shape, 2, False)["flash_fwd_short"]
    rate = smoke.H100_SXM_RATE if smoke.H100_SXM_NAME in smi else smoke.memory_rate(torch, smi)[0]
    bound_ms, bound_by = smoke.bound(nbytes, nops, rate, smoke.BF16_PEAK)
    results = {"device": smi, "shape": list(shape), "bound_ms": bound_ms, "bound_by": bound_by, "kernels": {}}
    out = torch.empty((b, t, h, hd), dtype=torch.bfloat16, device="cuda")
    m = torch.empty((b, h, t), dtype=torch.float32, device="cuda")
    l = torch.empty_like(m)
    raw = (q.data_ptr(), out.data_ptr(), m.data_ptr(), l.data_ptr(), q.stride(0), b, t, h, hd, 0,
           torch.cuda.current_stream().cuda_stream)

    def record(name, ms, **extra):
        results["kernels"][name] = dict(ms=ms, bound_share=bound_ms / ms, **extra)
        print(f"[short_fwd] {name} {list(shape)}: {ms!r} ms, {bound_ms / ms!r} of the {bound_ms!r} ms bound "
              f"({bound_by}) {extra or ''}; {smi}", flush=True)

    shipped = _build.build("flash_fwd_short")
    got = ops.flash_fwd_short_kernel(q, k, v)
    torch.cuda.synchronize()
    record("shipped", smoke.time_ms(torch, ops.flash_fwd_short_kernel, q, k, v),
           **ptxas_resources(_build.build_log("flash_fwd_short"), hd, nq),
           sass_instructions=sass_instructions(str(shipped), hd, nq),
           max_abs_err=smoke.compare(torch, "shipped", (
               ("out", got[0], want[0], tol), ("m", got[1], want[1], smoke.STATS_TOL),
               ("l", got[2], want[2], smoke.STATS_TOL))))
    record("simt_k2", smoke.time_ms(torch, ops.flash_fwd_kernel, q, k, v, False, "simt"))
    with concurrent.futures.ThreadPoolExecutor(len(VARIANTS)) as pool:  # one nvcc each, together
        built = dict(zip(VARIANTS, pool.map(build_variant, [_build] * len(VARIANTS), VARIANTS,
                                            [changes for changes, _ in VARIANTS.values()])))
    for name, (changes, same_function) in VARIANTS.items():
        lib_path, log = built[name]
        fn = ctypes.CDLL(lib_path).rsdl_flash_fwd_short
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int

        def call(fn=fn, name=name):
            rc = fn(*raw)
            if rc != 0:
                raise RuntimeError(f"variant {name}: CUDA error {rc}")

        extra = {**ptxas_resources(log, hd, nq), "sass_instructions": sass_instructions(lib_path, hd, nq)}
        if same_function:
            call()
            torch.cuda.synchronize()
            extra["max_abs_err"] = smoke.compare(torch, name, (
                ("out", out, want[0], tol), ("m", m, want[1], smoke.STATS_TOL), ("l", l, want[2], smoke.STATS_TOL),
            ))
        record(name, smoke.time_ms(torch, call), **extra)
    record("shipped_again", smoke.time_ms(torch, ops.flash_fwd_short_kernel, q, k, v))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
