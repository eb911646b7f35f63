"""gate-integrity: env-gated planes stay off the module-level import
graph of the core data-path modules.

Builds the package's import graph with each edge classified as
*module-level* (executes when the importer is imported: top-level
``import``/``from`` statements, including ones inside module-level
``if``/``try`` blocks, plus the implicit parent-package edge Python adds
for every submodule import) or *lazy* (inside a function body,
``if TYPE_CHECKING:``, ``importlib.import_module``/``sys.modules`` in a
function — all fine). It then walks module-level edges from every core
module; any gated plane reached that way is a violation, reported at the
import statement that crosses into the plane.

The walk does not continue *through* a gated plane: planes may import
each other freely (e.g. ``phases`` -> ``trace``) because reaching the
first plane already requires passing a gate.
"""

from __future__ import annotations

import ast
from collections import deque
from typing import Dict, List, Set, Tuple

from ray_shuffling_data_loader_tpu_torch.analysis.core import (
    Finding,
    SourceFile,
    is_type_checking_if,
)
from ray_shuffling_data_loader_tpu_torch.analysis.project import (
    CORE_MODULES,
    GATED_PLANES,
    PACKAGE,
    Project,
)

EXPLAIN = """\
gate-integrity: the zero-overhead-off contract, structurally.

Env-gated planes (telemetry/{timeseries,events,stragglers,capacity,
critical,slo,export,audit,trace,phases,obs_server,runledger,profiler,
relay}, runtime/{journal,faults,elastic,service,plan},
analysis/planner) cost nothing when their gates are unset — which is
only true if importing a core data-path module (shuffle, dataset,
device_dataset, batch_queue, checkpoint, runtime/{tasks,actor,store,
transport,cluster}) never executes a plane's module body. This checker
builds the import graph and flags any module-level import path from a
core module into a gated plane.

Fix patterns (in preference order):
  * gate-then-import at the call site:
        if metrics.enabled():
            from ray_shuffling_data_loader_tpu_torch.telemetry import events
  * a gated proxy for hot attribute-style sites, whose enabled() is
    one cached boolean and whose other attributes import the plane:
        from ray_shuffling_data_loader_tpu_torch.telemetry._env import (
            audit_plane as _audit,
        )
  * PEP 562 module __getattr__ for facade re-exports (see
    telemetry/__init__.py)
  * sys.modules.get(...) when the module must only be touched if some
    other path already loaded it (shutdown hooks).
The runtime twin of this structural check is the fresh-interpreter
probe in tests/test_torch_port_lint.py: with every RSDL_* unset, a
submit/result/shutdown cycle leaves trace, audit, export and faults
unimported."""


def _resolve_relative(module: str, is_pkg_init: bool, node: ast.ImportFrom):
    """Absolute module named by a ``from ... import`` statement."""
    if node.level == 0:
        return node.module
    # Package of the importing module.
    parts = module.split(".")
    if not is_pkg_init:
        parts = parts[:-1]
    up = node.level - 1
    if up:
        parts = parts[:-up] if up < len(parts) else []
    base = ".".join(parts)
    if node.module:
        return f"{base}.{node.module}" if base else node.module
    return base or None


def _collect_module_edges(
    src: SourceFile, known_modules: Set[str]
) -> List[Tuple[str, int]]:
    """(target_module, lineno) for every import that executes at module
    import time. Imports inside function bodies are lazy by definition;
    module-level ``if``/``try``/``with`` bodies still execute eagerly —
    except ``if TYPE_CHECKING:``."""
    tree = src.tree
    if tree is None:
        return []
    is_pkg_init = src.path.endswith("__init__.py")
    edges: List[Tuple[str, int]] = []

    def visit_block(body):
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                # Class bodies DO execute at import time.
                if isinstance(node, ast.ClassDef):
                    visit_block(node.body)
                continue
            if isinstance(node, ast.Import):
                for alias in node.names:
                    edges.append((alias.name, node.lineno))
            elif isinstance(node, ast.ImportFrom):
                base = _resolve_relative(src.module, is_pkg_init, node)
                if base is None:
                    continue
                edges.append((base, node.lineno))
                for alias in node.names:
                    cand = f"{base}.{alias.name}"
                    if cand in known_modules:
                        edges.append((cand, node.lineno))
            elif isinstance(node, ast.If):
                if is_type_checking_if(node):
                    continue
                visit_block(node.body)
                visit_block(node.orelse)
            elif isinstance(node, ast.Try):
                visit_block(node.body)
                for h in node.handlers:
                    visit_block(h.body)
                visit_block(node.orelse)
                visit_block(node.finalbody)
            elif isinstance(node, (ast.With, ast.AsyncWith)):
                visit_block(node.body)
            elif isinstance(node, (ast.For, ast.AsyncFor, ast.While)):
                visit_block(node.body)
                visit_block(node.orelse)
    visit_block(tree.body)

    # Implicit parent-package edges: importing a.b.c executes a and a.b.
    mod = src.module
    parts = mod.split(".")
    for i in range(1, len(parts)):
        parent = ".".join(parts[:i])
        if parent in known_modules and parent != mod:
            edges.append((parent, 1))
    return edges


def check(project: Project) -> List[Finding]:
    by_module = project.by_module()
    known = set(by_module)
    core = {m for m in CORE_MODULES if m in known}
    planes = {p for p in GATED_PLANES if p in known}

    # module -> [(target, lineno)] restricted to in-package targets
    graph: Dict[str, List[Tuple[str, int]]] = {}
    for mod, src in by_module.items():
        tgts = []
        for name, lineno in _collect_module_edges(src, known):
            if name is None or not name.startswith(PACKAGE):
                continue
            # Normalize "from pkg.sub import x" where x is not a module:
            # the executed module is pkg.sub itself.
            while name not in known and "." in name:
                name = name.rsplit(".", 1)[0]
            if name in known and name != mod:
                tgts.append((name, lineno))
        graph[mod] = tgts

    # BFS along module-level edges from the cores; do not expand planes.
    reachable: Set[str] = set()
    origin: Dict[str, str] = {}  # module -> a core module that reaches it
    queue = deque()
    for c in core:
        reachable.add(c)
        origin[c] = c
        queue.append(c)
    while queue:
        mod = queue.popleft()
        if mod in planes:
            continue
        for tgt, _ in graph.get(mod, ()):
            if tgt not in reachable:
                reachable.add(tgt)
                origin[tgt] = origin[mod]
                queue.append(tgt)

    findings: List[Finding] = []
    seen: Set[Tuple[str, int, str]] = set()
    for mod in sorted(reachable):
        if mod in planes:
            continue  # flagged at the edge below
        for tgt, lineno in graph.get(mod, ()):
            if tgt not in planes:
                continue
            src = by_module[mod]
            key = (src.path, lineno, tgt)
            if key in seen:
                continue
            seen.add(key)
            via = (
                ""
                if mod == origin[mod]
                else f" (reached from core module {origin[mod]})"
            )
            findings.append(
                Finding(
                    check="gate-integrity",
                    path=src.path,
                    line=lineno,
                    message=(
                        f"module-level import of env-gated plane '{tgt}' "
                        f"from '{mod}'{via}; gate it behind a "
                        "function-level lazy import (see --explain "
                        "gate-integrity)"
                    ),
                )
            )
    return findings
