#!/usr/bin/env python
"""rsdl-lint — the invariant-enforcing static analyzer of the port.

Runs the AST checkers in ``ray_shuffling_data_loader_tpu_torch/analysis``
over the port's files in the repo (or ``--root DIR`` for a fixture tree)
and exit-codes on the findings:

    $ python -m ray_shuffling_data_loader_tpu_torch.rsdl_lint           # human output
    $ python -m ray_shuffling_data_loader_tpu_torch.rsdl_lint --json    # machine output
    $ python -m ray_shuffling_data_loader_tpu_torch.rsdl_lint --explain gate-integrity
    $ python -m ray_shuffling_data_loader_tpu_torch.rsdl_lint --select knob-registry,vocabulary-drift

It scans the package, ``chip_smoke.py``, ``tools/torch_port_*.py``,
``tests/test_torch_*.py`` and ``tests/torch_port_helpers.py``
(:mod:`.analysis.project`). Exit codes: 0 clean, 1 findings, 3 internal
crash (argparse usage errors keep their conventional 2). The flags, the
output and the ``--json`` payload are the JAX package's
``tools/rsdl_lint.py``'s.

Suppressions are per-line with a REQUIRED reason::

    FOO.update(x)  # rsdl-lint: disable=lock-discipline -- written once
                   # at import time, readers start after init()

Standard library only: the lint starts neither torch nor CUDA.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from ray_shuffling_data_loader_tpu_torch.analysis import (
    Project,
    all_checkers,
    get_checker,
    run_checks,
)
from ray_shuffling_data_loader_tpu_torch.analysis.core import LintCrash

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

JSON_VERSION = 1


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="rsdl_lint", description=__doc__.splitlines()[0]
    )
    parser.add_argument(
        "--root",
        default=_REPO_ROOT,
        help="repo root to lint (default: the checkout holding this package)",
    )
    parser.add_argument(
        "--json",
        action="store_true",
        dest="as_json",
        help="machine-readable output",
    )
    parser.add_argument(
        "--explain",
        metavar="CHECK",
        help="print what a checker enforces and how to fix/register, "
        "then exit 0",
    )
    parser.add_argument(
        "--select",
        metavar="CHECKS",
        help="comma-separated subset of checkers to run",
    )
    parser.add_argument(
        "--list-checks",
        action="store_true",
        help="list checker names and exit",
    )
    parser.add_argument(
        "--show-suppressed",
        action="store_true",
        help="also print suppressed findings (never affect the exit code)",
    )
    args = parser.parse_args(argv)

    if args.list_checks:
        for name in all_checkers():
            print(name)
        return 0

    if args.explain:
        entry = get_checker(args.explain)
        if entry is None:
            print(
                f"unknown checker {args.explain!r}; known: "
                f"{', '.join(all_checkers() + ['bad-suppression'])}",
                file=sys.stderr,
            )
            return 2
        print(entry[1])
        return 0

    select = (
        [s.strip() for s in args.select.split(",") if s.strip()]
        if args.select
        else None
    )
    project = Project(root=os.path.abspath(args.root))
    findings = run_checks(project, select=select)
    active = [f for f in findings if not f.suppressed]
    suppressed = [f for f in findings if f.suppressed]

    if args.as_json:
        payload = {
            "version": JSON_VERSION,
            "root": project.root,
            "checks": select or all_checkers(),
            "counts": {
                "active": len(active),
                "suppressed": len(suppressed),
            },
            "findings": [f.to_json() for f in findings],
        }
        print(json.dumps(payload, indent=2, sort_keys=True))
    else:
        for f in active:
            print(f"{f.location()}: [{f.check}] {f.message}")
        if args.show_suppressed:
            for f in suppressed:
                print(
                    f"{f.location()}: [{f.check}] suppressed "
                    f"({f.suppress_reason}): {f.message}"
                )
        print(
            f"rsdl-lint: {len(active)} finding(s), "
            f"{len(suppressed)} suppressed"
        )
    return 1 if active else 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SystemExit:
        raise
    except LintCrash as exc:
        print(f"rsdl-lint: internal error: {exc}", file=sys.stderr)
        sys.exit(3)
    except Exception:
        import traceback

        traceback.print_exc()
        print("rsdl-lint: internal error (crash)", file=sys.stderr)
        sys.exit(3)
