"""Checker registry: name -> (runner, explain text).

Each checker is a function ``(project: Project) -> List[Finding]``. The
CLI composes them, applies per-line suppressions, and exit-codes on what
survives. The six checkers and their findings are the JAX package's,
held to it fixture by fixture in ``tests/test_torch_port_lint.py``;
adding one means adding it to both packages.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ray_shuffling_data_loader_tpu_torch.analysis.core import (
    Finding,
    LintCrash,
    apply_suppressions,
    suppression_findings,
)
from ray_shuffling_data_loader_tpu_torch.analysis.project import Project

from ray_shuffling_data_loader_tpu_torch.analysis.checkers import (  # noqa: E402
    barriers,
    determinism,
    gates,
    knobs,
    locks,
    vocab,
)

Checker = Callable[[Project], List[Finding]]

_REGISTRY: Dict[str, Tuple[Checker, str]] = {
    "gate-integrity": (gates.check, gates.EXPLAIN),
    "knob-registry": (knobs.check, knobs.EXPLAIN),
    "vocabulary-drift": (vocab.check, vocab.EXPLAIN),
    "determinism-hygiene": (determinism.check, determinism.EXPLAIN),
    "lock-discipline": (locks.check, locks.EXPLAIN),
    "barrier-order": (barriers.check, barriers.EXPLAIN),
}

BAD_SUPPRESSION_EXPLAIN = """\
bad-suppression: a `# rsdl-lint: disable=CHECK` comment with no reason.
Suppressions are part of the audit trail: every one must say WHY the
finding is safe to ignore at that line —
    # rsdl-lint: disable=lock-discipline -- registered before any
    # worker thread starts
A reasonless disable is reported instead of honored."""


def all_checkers() -> List[str]:
    return list(_REGISTRY)


def get_checker(name: str) -> Optional[Tuple[Checker, str]]:
    if name == "bad-suppression":
        return (lambda project: [], BAD_SUPPRESSION_EXPLAIN)
    return _REGISTRY.get(name)


def run_checks(
    project: Project, select: Optional[Sequence[str]] = None
) -> List[Finding]:
    """Run the selected (default: all) checkers plus suppression-syntax
    validation; return findings with suppressions applied, sorted by
    location. Checker crashes surface as :class:`LintCrash`."""
    names = list(select) if select else all_checkers()
    # bad-suppression is selectable but has no runner: the suppression
    # validation below always runs, so selecting it alone just scopes
    # the output to those findings.
    names = [n for n in names if n != "bad-suppression"]
    unknown = [n for n in names if n not in _REGISTRY]
    if unknown:
        raise LintCrash(f"unknown checker(s): {', '.join(unknown)}")
    findings: List[Finding] = []
    for name in names:
        runner, _ = _REGISTRY[name]
        try:
            found = runner(project)
        except LintCrash:
            raise
        except Exception as exc:  # checker bug -> crash, not "clean"
            raise LintCrash(f"checker {name} crashed: {exc!r}") from exc
        for f in found:
            if f.check != name:
                f.check = name
        findings.extend(found)
    for src in project.sources.values():
        findings.extend(suppression_findings(src))
        if src.tree is None:  # forces the parse; None == syntax error
            raise LintCrash(f"{src.path}: unparseable: {src.parse_error}")
    findings = apply_suppressions(findings, project.sources)
    findings.sort(key=lambda f: (f.path, f.line, f.check, f.message))
    return findings
