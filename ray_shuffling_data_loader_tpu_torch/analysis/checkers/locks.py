"""lock-discipline: heuristics over module-level mutable state and lock
acquisition order.

Two sub-checks, both scoped to *threaded package modules* (a module
that imports ``threading``; pure-sequential helpers are exempt):

1. **off-lock mutation** — a module-level mutable container (``X = {}``
   / ``[]`` / ``set()`` / ``deque()``) mutated from inside a function
   (``X[k] = v``, ``X.append(...)``, ``global X`` reassignment) with no
   enclosing ``with <lock>`` and no lock ``.acquire()`` in the same
   function. Registration tables touched only at import time are the
   classic false positive — that is what the suppression-with-reason
   mechanism is for, and the reason documents the threading argument.
2. **inconsistent acquisition order** — nested ``with``-acquisitions of
   two named locks observed in both orders across one module is the
   textbook deadlock precondition; the second order is flagged.

Lock-ish names: any name/attribute whose final component contains
``lock``, ``mutex``, or ``cond`` (case-insensitive).
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from ray_shuffling_data_loader_tpu_torch.analysis.core import (
    Finding,
    dotted_name,
)
from ray_shuffling_data_loader_tpu_torch.analysis.project import Project

EXPLAIN = """\
lock-discipline: shared state in threaded modules is lock-protected and
locks are ordered.

(1) module-level mutable containers mutated from functions in modules
that run threads must hold a lock at the mutation site (a `with
<lock>:` ancestor or an `.acquire()` in the same function). If the
mutation is provably single-threaded (import time, process entrypoint
before threads start), suppress with that reason — the reason IS the
documentation.
(2) two locks entered in nested `with` blocks in both orders in one
module can deadlock; pick one order and stick to it.

Conventions the checker honors: a function named `*_locked` is called
with the module lock held (the name is the contract), and a function
containing an explicit `.acquire()` manages its lock by hand.

Heuristic by design: it cannot see cross-module locking protocols.
Keep module-level mutable state behind small accessor functions that
own one lock — the pattern the telemetry registries use."""

MUTABLE_CTORS = {"dict", "list", "set", "deque", "defaultdict", "OrderedDict"}
MUTATING_METHODS = {
    "append",
    "add",
    "update",
    "pop",
    "popitem",
    "clear",
    "remove",
    "discard",
    "extend",
    "insert",
    "setdefault",
    "appendleft",
}
LOCKISH = ("lock", "mutex", "cond")


def _is_lockish(name: Optional[str]) -> bool:
    if not name:
        return False
    leaf = name.rsplit(".", 1)[-1].lower()
    return any(k in leaf for k in LOCKISH)


def _module_mutables(tree: ast.Module) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for node in tree.body:
        targets = []
        value = None
        if isinstance(node, ast.Assign):
            targets, value = node.targets, node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets, value = [node.target], node.value
        if value is None:
            continue
        is_mut = isinstance(value, (ast.Dict, ast.List, ast.Set)) or (
            isinstance(value, ast.Call)
            and (dotted_name(value.func) or "").rsplit(".", 1)[-1]
            in MUTABLE_CTORS
        )
        if not is_mut:
            continue
        for tgt in targets:
            if isinstance(tgt, ast.Name):
                out[tgt.id] = node.lineno
    return out


def _uses_threads(tree: ast.Module) -> bool:
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            if any(a.name == "threading" for a in node.names):
                return True
        elif isinstance(node, ast.ImportFrom):
            if node.module == "threading":
                return True
    return False


class _FuncScanner(ast.NodeVisitor):
    """Per-function: mutations of module globals + lock context depth."""

    def __init__(self, mutables: Set[str]):
        self.mutables = mutables
        self.findings: List[Tuple[str, int]] = []  # (name, line)
        self._lock_depth = 0
        self.saw_acquire = False
        self.declared_global: Set[str] = set()

    def visit_Global(self, node: ast.Global) -> None:
        self.declared_global.update(node.names)

    def visit_With(self, node: ast.With) -> None:
        self._with(node)

    def visit_AsyncWith(self, node: ast.AsyncWith) -> None:
        self._with(node)

    def _with(self, node) -> None:
        lockish = any(
            _is_lockish(dotted_name(item.context_expr))
            or (
                isinstance(item.context_expr, ast.Call)
                and _is_lockish(dotted_name(item.context_expr.func))
            )
            for item in node.items
        )
        if lockish:
            self._lock_depth += 1
        for child in node.body:
            self.visit(child)
        if lockish:
            self._lock_depth -= 1

    def visit_Call(self, node: ast.Call) -> None:
        name = dotted_name(node.func)
        if name and name.endswith(".acquire"):
            self.saw_acquire = True
        if self._lock_depth == 0 and isinstance(node.func, ast.Attribute):
            base = node.func.value
            if (
                isinstance(base, ast.Name)
                and base.id in self.mutables
                and node.func.attr in MUTATING_METHODS
            ):
                self.findings.append((base.id, node.lineno))
        self.generic_visit(node)

    def _record_store(self, target: ast.AST, lineno: int) -> None:
        if isinstance(target, ast.Subscript) and isinstance(
            target.value, ast.Name
        ):
            if target.value.id in self.mutables:
                self.findings.append((target.value.id, lineno))
        elif isinstance(target, ast.Name):
            if (
                target.id in self.mutables
                and target.id in self.declared_global
            ):
                self.findings.append((target.id, lineno))

    def visit_Assign(self, node: ast.Assign) -> None:
        if self._lock_depth == 0:
            for tgt in node.targets:
                self._record_store(tgt, node.lineno)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        if self._lock_depth == 0:
            self._record_store(node.target, node.lineno)
        self.generic_visit(node)

    def visit_Delete(self, node: ast.Delete) -> None:
        if self._lock_depth == 0:
            for tgt in node.targets:
                self._record_store(tgt, node.lineno)
        self.generic_visit(node)

    # Do not descend into nested defs: they get their own scan.
    def visit_FunctionDef(self, node):  # noqa: D102
        pass

    def visit_AsyncFunctionDef(self, node):  # noqa: D102
        pass


def _lock_orders(
    tree: ast.Module,
) -> List[Tuple[str, str, int]]:
    """(outer, inner, line-of-inner) pairs from nested with-acquisitions."""
    pairs: List[Tuple[str, str, int]] = []

    def lock_names(node) -> List[str]:
        out = []
        for item in node.items:
            name = dotted_name(item.context_expr)
            if name is None and isinstance(item.context_expr, ast.Call):
                name = dotted_name(item.context_expr.func)
            if _is_lockish(name):
                out.append(name.rsplit(".", 1)[-1])
        return out

    def walk(node, held: List[str]):
        if isinstance(node, (ast.With, ast.AsyncWith)):
            names = lock_names(node)
            for n in names:
                for h in held:
                    if h != n:
                        pairs.append((h, n, node.lineno))
            held = held + names
        for child in ast.iter_child_nodes(node):
            walk(child, held)

    walk(tree, [])
    return pairs


def check(project: Project) -> List[Finding]:
    findings: List[Finding] = []
    for mod, src in sorted(project.by_module().items()):
        tree = src.tree
        if tree is None or not isinstance(tree, ast.Module):
            continue
        if not _uses_threads(tree):
            continue
        mutables = _module_mutables(tree)
        if mutables:
            has_lock = any(
                _is_lockish(n) for n in _module_level_names(tree)
            )
            for node in tree.body:
                for fn in _functions_in(node):
                    # Repo convention: a ``*_locked`` function is called
                    # with the module lock already held (the name IS the
                    # contract) — its mutations are covered.
                    if fn.name.endswith("_locked"):
                        continue
                    scanner = _FuncScanner(set(mutables))
                    scanner.declared_global = set()
                    for child in fn.body:
                        scanner.visit(child)
                    if scanner.saw_acquire:
                        continue
                    for name, line in scanner.findings:
                        qualifier = (
                            "no module lock exists"
                            if not has_lock
                            else "not under any lock"
                        )
                        findings.append(
                            Finding(
                                check="lock-discipline",
                                path=src.path,
                                line=line,
                                message=(
                                    f"module-level mutable '{name}' "
                                    f"mutated in {fn.name}() "
                                    f"({qualifier}) in a threaded "
                                    "module; hold a lock or suppress "
                                    "with the single-threaded argument"
                                ),
                            )
                        )
        # acquisition order
        order_seen: Dict[Tuple[str, str], int] = {}
        for outer, inner, line in _lock_orders(tree):
            order_seen.setdefault((outer, inner), line)
        for (a, b), line in sorted(order_seen.items()):
            if (b, a) in order_seen and a < b:
                findings.append(
                    Finding(
                        check="lock-discipline",
                        path=src.path,
                        line=max(line, order_seen[(b, a)]),
                        message=(
                            f"locks '{a}' and '{b}' are acquired in both "
                            "orders in this module (deadlock "
                            "precondition); pick one order"
                        ),
                    )
                )
    return findings


def _module_level_names(tree: ast.Module) -> List[str]:
    out = []
    for node in tree.body:
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    out.append(tgt.id)
        elif isinstance(node, ast.AnnAssign) and isinstance(
            node.target, ast.Name
        ):
            out.append(node.target.id)
    return out


def _functions_in(node):
    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
        yield node
        for child in node.body:
            yield from _functions_in(child)
    elif isinstance(node, ast.ClassDef):
        for child in node.body:
            yield from _functions_in(child)
