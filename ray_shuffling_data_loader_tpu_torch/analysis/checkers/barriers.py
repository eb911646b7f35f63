"""barrier-order: spool flushes precede task-done / quiesce signaling.

The repo's observability contract is *"a resolved future implies its
worker-side records are on disk"*: the task worker flushes every spool
(trace, audit, metrics registry, events, stragglers, capacity) strictly
before putting the ``("done", ...)`` record on the result queue, and an
actor host flushes before deregistering itself. The owner-side
reconciler, the cluster metrics aggregator, and the straggler detector
all assume that ordering. This checker enforces it intra-function in
``runtime/tasks.py`` and ``runtime/actor.py``:

* any ``<queue>.put(("done", ...))`` call must be preceded, within the
  same enclosing statement block, by a flush call
  (``_flush_telemetry_spools`` / ``safe_flush`` / ``maybe_flush``);
* any ``os.unlink/os.remove`` of a ``*registry*`` path (actor
  deregistration — the moment the world may stop waiting for this
  process) must be preceded in its block by a flush call.
"""

from __future__ import annotations

import ast
from typing import List, Optional

from ray_shuffling_data_loader_tpu_torch.analysis.core import (
    Finding,
    const_str,
    dotted_name,
)
from ray_shuffling_data_loader_tpu_torch.analysis.project import (
    BARRIER_MODULES,
    FLUSH_CALL_NAMES,
    Project,
)

EXPLAIN = """\
barrier-order: flush-before-done, structurally.

Task workers must drain their telemetry spools BEFORE reporting a task
done, and actor hosts before deregistering: every consumer of the
spools (audit reconciler, metrics aggregation, straggler records)
relies on "future resolved => records visible". The checker walks
runtime/tasks.py and runtime/actor.py and requires a flush call
(_flush_telemetry_spools / safe_flush / maybe_flush) earlier in the
same statement block as each done-put / registry-unlink.

If you add a new completion signal (a new queue message, a new
deregistration path), flush first — or extend FLUSH_CALL_NAMES /
this checker if the flush moved behind a helper."""


def _is_flush_call(node: ast.AST) -> bool:
    if not isinstance(node, ast.Expr) or not isinstance(
        node.value, ast.Call
    ):
        return False
    name = dotted_name(node.value.func) or ""
    return name.rsplit(".", 1)[-1] in FLUSH_CALL_NAMES


def _done_put(node: ast.AST) -> Optional[int]:
    """lineno if the statement is ``something.put(("done", ...))``."""
    if not isinstance(node, ast.Expr) or not isinstance(
        node.value, ast.Call
    ):
        return None
    call = node.value
    if not isinstance(call.func, ast.Attribute) or call.func.attr != "put":
        return None
    if not call.args:
        return None
    arg = call.args[0]
    if isinstance(arg, ast.Tuple) and arg.elts:
        if const_str(arg.elts[0]) == "done":
            return node.lineno
    return None


def _registry_unlink(node: ast.AST) -> Optional[int]:
    if not isinstance(node, ast.Expr) or not isinstance(
        node.value, ast.Call
    ):
        return None
    call = node.value
    name = dotted_name(call.func) or ""
    if name not in ("os.unlink", "os.remove"):
        return None
    if call.args:
        arg = call.args[0]
        text = dotted_name(arg) or (
            arg.id if isinstance(arg, ast.Name) else ""
        ) or ""
        if isinstance(arg, ast.Name):
            text = arg.id
        if "registry" in text.lower():
            return node.lineno
    return None


def _scan_block(body: List[ast.stmt], path: str, findings: List[Finding],
                flush_seen_above: bool) -> None:
    """Walk one statement list in order, recursing into compound
    statements; a flush earlier in THIS block (or an enclosing one)
    satisfies signals later in the block."""
    flushed = flush_seen_above
    for stmt in body:
        signal_line = _done_put(stmt)
        kind = "task-done put"
        if signal_line is None:
            signal_line = _registry_unlink(stmt)
            kind = "actor deregistration (registry unlink)"
        if signal_line is not None and not flushed:
            findings.append(
                Finding(
                    check="barrier-order",
                    path=path,
                    line=signal_line,
                    message=(
                        f"{kind} with no preceding telemetry spool flush "
                        "in this block; call _flush_telemetry_spools()/"
                        "safe_flush() first (resolved future => records "
                        "on disk)"
                    ),
                )
            )
        if _is_flush_call(stmt):
            flushed = True
        # Recurse into nested blocks with the current flush state —
        # but NOT into nested defs (ast.walk hands those to their own
        # scan with a fresh state).
        if isinstance(
            stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
        ):
            continue
        for attr in ("body", "orelse", "finalbody"):
            sub = getattr(stmt, attr, None)
            if sub:
                _scan_block(sub, path, findings, flushed)
        for handler in getattr(stmt, "handlers", []) or []:
            _scan_block(handler.body, path, findings, flushed)


def check(project: Project) -> List[Finding]:
    findings: List[Finding] = []
    by_module = project.by_module()
    for mod in sorted(BARRIER_MODULES):
        src = by_module.get(mod)
        if src is None:
            continue
        tree = src.tree
        if tree is None:
            continue
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                _scan_block(node.body, src.path, findings, False)
    return findings
