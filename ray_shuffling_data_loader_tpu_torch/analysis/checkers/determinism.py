"""determinism-hygiene: plan- and digest-affecting modules stay seeded.

The resume/replay contract (docs/robustness.md) is that a fixed seed
reproduces the delivered stream bit-identically — which dies the moment
a shuffle-plan, journal, audit, or checkpoint code path draws from an
unseeded RNG or derives a seed from the clock. Inside
``DETERMINISM_MODULES`` this checker flags:

* the global stdlib RNG: ``random.random()``, ``random.shuffle()``, ...
  (a seeded ``random.Random(seed)`` instance is fine);
* the legacy global numpy RNG: ``np.random.rand/permutation/...``;
* unseeded generator construction: ``np.random.default_rng()`` /
  ``np.random.Generator(...)`` / ``random.Random()`` with no arguments;
* time/uuid-derived seeding: ``time.time()``/``time.time_ns()``/
  ``datetime.now()``/``uuid.uuid4()`` as an argument to anything
  seed/rng-named, or assigned to a ``*seed*`` variable.

Wall-clock *timestamps* (journal record ts, metrics) are fine — they
are identity/observability, not plan input — so bare ``time.time()``
is not flagged outside seeding positions. Modules outside the scope
(e.g. retry jitter) are intentionally unchecked.
"""

from __future__ import annotations

import ast
from typing import List, Optional

from ray_shuffling_data_loader_tpu_torch.analysis.core import (
    Finding,
    dotted_name,
)
from ray_shuffling_data_loader_tpu_torch.analysis.project import (
    DETERMINISM_MODULES,
    Project,
)

EXPLAIN = """\
determinism-hygiene: seeded-or-nothing in plan/digest code.

Shuffle plans, the journal, audit digests, and checkpoint cursors must
be pure functions of (seed, inputs): resume/replay proves equivalence
by comparing order-sensitive digests across runs. This checker flags
unseeded RNG use (global random/np.random, argless default_rng/Random)
and time-derived seeding inside those modules. Fix by threading the
plan seed (derive per-use streams with splitmix64/fold_in, the repo
idiom); if a use is genuinely non-plan (e.g. jitter on a retry that
never touches data order), move it out of scope or suppress with a
reason."""

GLOBAL_RANDOM_FNS = {
    "random",
    "randint",
    "randrange",
    "shuffle",
    "sample",
    "choice",
    "choices",
    "uniform",
    "getrandbits",
    "gauss",
    "normalvariate",
    "seed",
}
NP_GLOBAL_FNS = {
    "rand",
    "randn",
    "randint",
    "random",
    "random_sample",
    "shuffle",
    "permutation",
    "choice",
    "seed",
    "standard_normal",
    "uniform",
}
TIME_SOURCES = {
    "time.time",
    "time.time_ns",
    "time.monotonic",
    "time.perf_counter",
    "datetime.now",
    "datetime.utcnow",
    "datetime.datetime.now",
    "datetime.datetime.utcnow",
    "uuid.uuid4",
    "uuid.uuid1",
}
SEEDY = ("seed", "rng", "random")


def _is_time_call(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Call):
        name = dotted_name(node.func)
        if name in TIME_SOURCES:
            return name
    return None


def check(project: Project) -> List[Finding]:
    findings: List[Finding] = []
    for mod, src in sorted(project.by_module().items()):
        if mod not in DETERMINISM_MODULES:
            continue
        tree = src.tree
        if tree is None:
            continue
        for node in ast.walk(tree):
            if isinstance(node, ast.Call):
                name = dotted_name(node.func) or ""
                parts = name.split(".")
                leaf = parts[-1]
                # global stdlib RNG: random.shuffle(...), etc.
                if (
                    len(parts) == 2
                    and parts[0] == "random"
                    and leaf in GLOBAL_RANDOM_FNS
                ):
                    findings.append(
                        Finding(
                            check="determinism-hygiene",
                            path=src.path,
                            line=node.lineno,
                            message=(
                                f"unseeded global RNG call {name}() in a "
                                "plan/digest-affecting module; use a "
                                "seeded random.Random / splitmix64 stream"
                            ),
                        )
                    )
                # legacy global numpy RNG: np.random.permutation(...)
                elif (
                    len(parts) >= 2
                    and parts[-2] == "random"
                    and parts[0] in ("np", "numpy")
                    and leaf in NP_GLOBAL_FNS
                ):
                    findings.append(
                        Finding(
                            check="determinism-hygiene",
                            path=src.path,
                            line=node.lineno,
                            message=(
                                f"global numpy RNG call {name}() in a "
                                "plan/digest-affecting module; use "
                                "np.random.Generator(np.random.PCG64("
                                "seed)) / default_rng(seed)"
                            ),
                        )
                    )
                # unseeded generator construction
                elif leaf in ("default_rng", "Random", "Generator") and (
                    not node.args and not node.keywords
                ):
                    findings.append(
                        Finding(
                            check="determinism-hygiene",
                            path=src.path,
                            line=node.lineno,
                            message=(
                                f"{name}() constructed without a seed in "
                                "a plan/digest-affecting module"
                            ),
                        )
                    )
                # time-derived seeding: seed-ish callee with a clock arg
                elif any(s in name.lower() for s in SEEDY):
                    for arg in list(node.args) + [
                        kw.value for kw in node.keywords
                    ]:
                        t = _is_time_call(arg)
                        if t is not None:
                            findings.append(
                                Finding(
                                    check="determinism-hygiene",
                                    path=src.path,
                                    line=node.lineno,
                                    message=(
                                        f"time-derived seed: {t}() passed "
                                        f"to {name}() in a plan/digest-"
                                        "affecting module"
                                    ),
                                )
                            )
            elif isinstance(node, ast.Assign):
                t = _is_time_call(node.value)
                if t is None:
                    continue
                for tgt in node.targets:
                    if (
                        isinstance(tgt, ast.Name)
                        and "seed" in tgt.id.lower()
                    ):
                        findings.append(
                            Finding(
                                check="determinism-hygiene",
                                path=src.path,
                                line=node.lineno,
                                message=(
                                    f"time-derived seed: {tgt.id} = {t}() "
                                    "in a plan/digest-affecting module"
                                ),
                            )
                        )
    return findings
