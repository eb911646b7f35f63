"""vocabulary-drift: emitted metric names, ``rsdl_`` Prometheus
aliases, and event kinds must appear in ``docs/observability.md``.

Harvest sites:

* metric registrations — first literal argument of
  ``.counter(...)`` / ``.gauge(...)`` / ``.histogram(...)`` calls on a
  metrics-ish receiver (``metrics``/``_metrics``/``registry()``/...)
  and of ``safe_inc(...)`` calls;
* event kinds — first literal argument of ``emit_event(...)`` /
  ``events.emit(...)``;
* Prometheus aliases — string literals matching ``rsdl_[a-z0-9_]+``
  anywhere in package/tools code (the alias mapping is mechanical, so a
  hand-written alias in a tool is a vocabulary commitment too).

f-string names (``f"audit.{field}"``) are dynamic families; their
documented form carries the prose, so they are skipped here.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Set, Tuple

from ray_shuffling_data_loader_tpu_torch.analysis.core import (
    Finding,
    const_str,
    dotted_name,
)
from ray_shuffling_data_loader_tpu_torch.analysis.project import (
    OBSERVABILITY_DOC,
    PACKAGE,
    Project,
)

EXPLAIN = """\
vocabulary-drift: the observable surface is documented, mechanically.

Operators alert on metric names and event kinds; a renamed counter or a
new undocumented event kind silently breaks dashboards. This checker
harvests every literal metric registration (.counter/.gauge/.histogram/
safe_inc), every emit_event/events.emit kind, and every literal rsdl_*
Prometheus alias from package + tools code, and requires each token to
appear in docs/observability.md.

Registering a new metric or event kind: emit it AND add it to the right
vocabulary table in docs/observability.md in the same change. Dynamic
(f-string) families are exempt here — document the family's base name
where its prose lives."""

METRIC_RECEIVER_HINTS = ("metrics", "registry", "reg")
METRIC_FNS = {"counter", "gauge", "histogram"}
NAME_OK_RE = re.compile(r"^[a-z0-9_]+(\.[a-z0-9_]+)+$")
EVENT_OK_RE = re.compile(r"^[a-z0-9_]+(\.[a-z0-9_]+)?$")
ALIAS_RE = re.compile(r"^rsdl_[a-z0-9_]+$")

# Alias-looking literals that are infrastructure, not vocabulary.
ALIAS_IGNORE = {"rsdl_lint", "rsdl_top", "rsdl_profile"}


def _metric_receiver(call: ast.Call) -> bool:
    func = call.func
    if not isinstance(func, ast.Attribute):
        return False
    base = func.value
    text = dotted_name(base)
    if text is None and isinstance(base, ast.Call):
        text = dotted_name(base.func)
    if text is None:
        return False
    leaf = text.rsplit(".", 1)[-1].lstrip("_").lower()
    return any(h in leaf for h in METRIC_RECEIVER_HINTS)


def harvest(
    project: Project,
) -> List[Tuple[str, str, str, int]]:
    """(kind, token, path, line) for every vocabulary commitment.
    kind: 'metric' | 'event' | 'alias'."""
    out: List[Tuple[str, str, str, int]] = []
    for src in project.sources.values():
        top = src.path.split("/", 1)[0]
        if top not in (PACKAGE, "tools") and src.path != "chip_smoke.py":
            continue
        tree = src.tree
        if tree is None:
            continue
        for node in ast.walk(tree):
            if isinstance(node, ast.Call):
                fn = dotted_name(node.func)
                leaf = fn.rsplit(".", 1)[-1] if fn else None
                first = const_str(node.args[0]) if node.args else None
                if first is None:
                    continue
                if leaf in METRIC_FNS and _metric_receiver(node):
                    if NAME_OK_RE.match(first) or "_" in first:
                        out.append(("metric", first, src.path, node.lineno))
                elif leaf == "safe_inc":
                    out.append(("metric", first, src.path, node.lineno))
                elif leaf == "emit_event" or (
                    fn in ("events.emit",)
                    or (fn or "").endswith(".events.emit")
                ):
                    if EVENT_OK_RE.match(first) and "." in first:
                        out.append(("event", first, src.path, node.lineno))
            elif isinstance(node, ast.Constant) and isinstance(
                node.value, str
            ):
                if ALIAS_RE.match(node.value) and (
                    node.value not in ALIAS_IGNORE
                ):
                    out.append(
                        ("alias", node.value, src.path, node.lineno)
                    )
    return out


def check(project: Project) -> List[Finding]:
    doc = project.doc_text(OBSERVABILITY_DOC)
    if doc is None:
        return [
            Finding(
                check="vocabulary-drift",
                path=OBSERVABILITY_DOC,
                line=1,
                message=f"{OBSERVABILITY_DOC} is missing",
            )
        ]
    doc_words: Set[str] = set(re.findall(r"[A-Za-z0-9_.`]+", doc))
    doc_words |= {w.strip("`") for w in doc_words}
    # Expand the doc's alternation shorthand: `trial.start/done/failed`
    # documents trial.start, trial.done, AND trial.failed.
    for m in re.finditer(
        r"\b([a-z0-9_]+)\.([a-z0-9_]+)((?:/[a-z0-9_]+)+)", doc
    ):
        head = m.group(1)
        for tail in [m.group(2)] + m.group(3).lstrip("/").split("/"):
            doc_words.add(f"{head}.{tail}")

    findings: List[Finding] = []
    reported: Dict[Tuple[str, str], bool] = {}
    for kind, token, path, line in harvest(project):
        # Whole-token match ONLY: the tokenizer already splits at `{`
        # (so `queue.depth{epoch=E}` documents queue.depth) and the
        # alternation expansion covers `trial.start/done/failed`. A raw
        # substring fallback would let any prefix of a documented name
        # (e.g. a rename to `queue.dep`) pass silently.
        if token in doc_words:
            continue
        key = (kind, token)
        if key in reported:
            continue
        reported[key] = True
        what = {
            "metric": "metric name",
            "event": "event kind",
            "alias": "Prometheus alias",
        }[kind]
        findings.append(
            Finding(
                check="vocabulary-drift",
                path=path,
                line=line,
                message=(
                    f"emitted {what} '{token}' is not documented in "
                    f"{OBSERVABILITY_DOC}: add it to the vocabulary "
                    "tables (see --explain vocabulary-drift)"
                ),
            )
        )
    return findings
