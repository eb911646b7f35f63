#!/usr/bin/env python3
"""Is the embedding lookup's weight gradient the same bits on every call?

    python3 tools/torch_port_embedding_determinism.py [--batch 65536] [--dim 32] [--calls 10]

For tables of the DLRM's row counts (3 to 941,792) and one batch of random
ids, computes the weight gradient ``--calls`` times with each of
``F.embedding``'s backward as it runs by default, the same under
``torch.use_deterministic_algorithms(True)`` (what the port's sharded
models use for their replicated tables), ``index_put_(accumulate=True)``
and ``index_add_``, and prints how many distinct results each gave and its
ms per call. Needs a CUDA device: on the CPU every one of them is
deterministic.
"""

from __future__ import annotations

import argparse
import hashlib
import subprocess
import sys
import time

ROWS = (3, 6, 50, 201, 1216, 2385, 88999, 941792)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=65536)
    p.add_argument("--dim", type=int, default=32)
    p.add_argument("--calls", type=int, default=10)
    args = p.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 2

    def digest(t):
        return hashlib.sha256(t.detach().cpu().contiguous().view(-1).view(torch.uint8).numpy().tobytes()).hexdigest()

    def ms(fn, n=20):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3

    gen = torch.Generator(device="cuda").manual_seed(0)
    for rows in ROWS:
        idx = torch.randint(0, rows, (args.batch,), device="cuda", generator=gen)
        grad = torch.randn(args.batch, args.dim, device="cuda", generator=gen)

        def embedding():
            return torch.ops.aten.embedding_dense_backward(grad, idx, rows, -1, False)

        def index_put():
            return torch.zeros(rows, args.dim, device="cuda").index_put_((idx,), grad, accumulate=True)

        def index_add():
            return torch.zeros(rows, args.dim, device="cuda").index_add_(0, idx, grad)

        cases = {}
        for name, fn, deterministic in (("embedding", embedding, False), ("embedding, deterministic", embedding, True),
                                        ("index_put_", index_put, False), ("index_add_", index_add, False)):
            torch.use_deterministic_algorithms(deterministic)
            try:
                cases[name] = (len({digest(fn()) for _ in range(args.calls)}), ms(fn))
            finally:
                torch.use_deterministic_algorithms(False)
        print(f"[embedding-determinism] {rows} rows, batch {args.batch}: " + "; ".join(
            f"{name} {distinct} distinct in {args.calls}, {t!r} ms" for name, (distinct, t) in cases.items()),
            flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}; {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
