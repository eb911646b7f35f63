"""knob-registry: every ``RSDL_*`` env read is declared; every public
knob is documented.

Harvest covers the idioms this codebase actually uses:

* direct reads/writes — ``os.environ.get/pop/setdefault``,
  ``os.environ[...]``, ``os.getenv`` — with a literal name or a
  module-level ``ENV_X = "RSDL_..."`` constant;
* f-string names (``os.environ.get(f"RSDL_T_{rank}")``) harvested as a
  prefix read;
* reader helpers: any package function whose body reads the environment
  through one of its parameters (``_env.read_flag``, ``retry``'s
  ``_env_int``/``_env_float``, ...) is discovered in a first pass, and
  its call sites with literal knob arguments are harvested in a second.

Checks, both directions ("registry and TUNING.md agree exactly"):
  1. every harvested read matches a registry entry (exact or declared
     prefix) — else *undeclared read*;
  2. every ``public`` registry knob appears in ``docs/TUNING.md`` —
     else *undocumented public knob* (``internal`` knobs may be
     documented but are not required to be);
  3. every ``RSDL_*`` token in ``docs/TUNING.md`` is a registry entry —
     else *documented but undeclared* (doc drift in the other
     direction);
  4. duplicate registry declarations;
  5. planner/registry agreement: every knob the plan
     compiler's ``TERM_KNOBS`` names is a registry entry flagged
     ``planned=True``, and every ``planned=True`` entry appears in
     ``TERM_KNOBS`` — the cost model and the registry cannot drift.
     Skipped when the project has no ``analysis/planner.py`` (fixture
     mini-repos share the global registry).
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Set, Tuple

from ray_shuffling_data_loader_tpu_torch.analysis.core import (
    Finding,
    const_str,
    dotted_name,
    module_constants,
)
from ray_shuffling_data_loader_tpu_torch.analysis.project import (
    TUNING_DOC,
    Project,
)
from ray_shuffling_data_loader_tpu_torch.analysis import knob_registry

EXPLAIN = """\
knob-registry: the RSDL_* env surface is a declared, documented API.

Every `os.environ`/`os.getenv` read of an RSDL_* name must appear in the
central registry (analysis/knob_registry.py: name, kind, default,
public|internal) and every PUBLIC knob must appear in docs/TUNING.md;
every RSDL_* token TUNING.md mentions must be a registry entry. So an
undeclared read, an undocumented public knob, and a documented-but-
deleted knob all fail CI instead of drifting.

Registering a new knob: add a Knob(...) entry to knob_registry.py; if
scope="public", add a row to the right docs/TUNING.md table. Families
read with dynamic suffixes (RSDL_T_*, RSDL_MP_*) are prefix entries.
The doc side matches on the token, so `RSDL_T_*` in the doc covers a
prefix entry named RSDL_T_."""

KNOB_RE = re.compile(r"RSDL_[A-Z0-9_]*")
ENV_READ_ATTRS = {"get", "pop", "setdefault"}


def _env_name_node(call: ast.Call) -> Optional[ast.AST]:
    """The name argument if ``call`` is an env access
    (``os.environ.get/pop/setdefault`` or ``os.getenv``)."""
    fn = dotted_name(call.func)
    if fn is None or not call.args:
        return None
    if fn in ("os.getenv", "getenv"):
        return call.args[0]
    if isinstance(call.func, ast.Attribute) and (
        call.func.attr in ENV_READ_ATTRS
    ):
        if _is_environ(call.func.value):
            return call.args[0]
    return None


def _is_environ(node: ast.AST) -> bool:
    name = dotted_name(node)
    return name is not None and (
        name == "environ" or name.endswith(".environ")
    )


def _literal_or_const(
    node: ast.AST, consts: Dict[str, str]
) -> Tuple[Optional[str], bool]:
    """(name, is_prefix): resolve a knob-name expression. f-strings with
    a literal head resolve to (head, True)."""
    s = const_str(node)
    if s is not None:
        return s, False
    if isinstance(node, ast.Name) and node.id in consts:
        return consts[node.id], False
    if isinstance(node, ast.JoinedStr) and node.values:
        head = const_str(node.values[0])
        if head is not None:
            return head, True
    return None, False


def _find_reader_helpers(project: Project) -> Dict[str, int]:
    """{function name: parameter index} for package functions that read
    the environment through a parameter."""
    helpers: Dict[str, int] = {}
    for src in project.package_sources():
        tree = src.tree
        if tree is None:
            continue
        for node in ast.walk(tree):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            params = [a.arg for a in node.args.args]
            for sub in ast.walk(node):
                name_node = None
                if isinstance(sub, ast.Call):
                    name_node = _env_name_node(sub)
                elif isinstance(sub, ast.Subscript) and _is_environ(sub.value):
                    name_node = sub.slice
                if isinstance(name_node, ast.Name) and name_node.id in params:
                    helpers[node.name] = params.index(name_node.id)
                    break
    return helpers


def harvest_reads(project: Project) -> List[Tuple[str, str, int, bool]]:
    """All RSDL_* env accesses: (name, path, line, is_prefix)."""
    helpers = _find_reader_helpers(project)
    out: List[Tuple[str, str, int, bool]] = []

    def record(name_node, consts, path, lineno):
        name, is_prefix = _literal_or_const(name_node, consts)
        if name and name.startswith("RSDL_"):
            out.append((name, path, lineno, is_prefix))

    for src in project.sources.values():
        tree = src.tree
        if tree is None:
            continue
        consts = module_constants(tree)
        for node in ast.walk(tree):
            if isinstance(node, ast.Call):
                name_node = _env_name_node(node)
                if name_node is not None:
                    record(name_node, consts, src.path, node.lineno)
                    continue
                fn = dotted_name(node.func)
                if fn is not None:
                    tail = fn.rsplit(".", 1)[-1]
                    idx = helpers.get(tail)
                    if idx is not None and idx < len(node.args):
                        record(node.args[idx], consts, src.path, node.lineno)
            elif isinstance(node, ast.Subscript) and _is_environ(node.value):
                record(node.slice, consts, src.path, node.lineno)
    return out


def _registry_lines(project: Project) -> Dict[str, int]:
    """Declaration line per knob name, for finding locations."""
    import ray_shuffling_data_loader_tpu_torch.analysis.knob_registry as kr

    path = kr.__file__
    lines: Dict[str, int] = {}
    try:
        with open(path, "r", encoding="utf-8") as f:
            for i, line in enumerate(f, 1):
                for m in re.finditer(r'"(RSDL_[A-Z0-9_]*)"', line):
                    lines.setdefault(m.group(1), i)
    except OSError:
        pass
    return lines


def _registry_relpath(project: Project) -> str:
    import os

    import ray_shuffling_data_loader_tpu_torch.analysis.knob_registry as kr

    try:
        rel = os.path.relpath(kr.__file__, project.root)
        if not rel.startswith(".."):
            return rel.replace(os.sep, "/")
    except ValueError:
        pass
    return "ray_shuffling_data_loader_tpu_torch/analysis/knob_registry.py"


PLANNER_RELPATH = "ray_shuffling_data_loader_tpu_torch/analysis/planner.py"


def _harvest_term_knobs(project: Project) -> Optional[Dict[str, Tuple[str, int]]]:
    """The planner's module-level ``TERM_KNOBS`` dict literal as
    {term: (knob, lineno)}, or None when the project carries no
    planner source (fixture mini-repos)."""
    src = project.sources.get(PLANNER_RELPATH)
    if src is None or src.tree is None:
        return None
    for node in src.tree.body:
        if not isinstance(node, ast.Assign):
            continue
        if not any(
            isinstance(t, ast.Name) and t.id == "TERM_KNOBS"
            for t in node.targets
        ):
            continue
        if not isinstance(node.value, ast.Dict):
            return {}
        out: Dict[str, Tuple[str, int]] = {}
        for k, v in zip(node.value.keys, node.value.values):
            term = const_str(k)
            knob = const_str(v)
            if term is not None and knob is not None:
                out[term] = (knob, v.lineno)
        return out
    return None


def check(project: Project) -> List[Finding]:
    registry = knob_registry.registry_for(project)
    findings: List[Finding] = []
    reg_path = _registry_relpath(project)
    reg_lines = _registry_lines(project)

    # 4. duplicate declarations
    seen: Set[str] = set()
    for knob in registry.knobs:
        if knob.name in seen:
            findings.append(
                Finding(
                    check="knob-registry",
                    path=reg_path,
                    line=reg_lines.get(knob.name, 1),
                    message=f"duplicate registry entry {knob.name}",
                )
            )
        seen.add(knob.name)

    # 1. undeclared reads
    for name, path, line, is_prefix in harvest_reads(project):
        if registry.lookup(name, is_prefix=is_prefix) is None:
            how = "prefix read" if is_prefix else "read"
            findings.append(
                Finding(
                    check="knob-registry",
                    path=path,
                    line=line,
                    message=(
                        f"undeclared env {how} {name}"
                        f"{'*' if is_prefix else ''}: add a Knob entry to "
                        "analysis/knob_registry.py (and a docs/TUNING.md "
                        "row if public)"
                    ),
                )
            )

    doc = project.doc_text(TUNING_DOC)
    doc_tokens: Set[str] = set()
    doc_token_lines: Dict[str, int] = {}
    if doc is not None:
        for i, line in enumerate(doc.splitlines(), 1):
            for m in KNOB_RE.finditer(line):
                tok = m.group(0)
                doc_tokens.add(tok)
                doc_token_lines.setdefault(tok, i)

    # 2. undocumented public knobs
    if doc is not None:
        for knob in registry.knobs:
            if knob.scope != "public":
                continue
            token = knob.name
            if token in doc_tokens:
                continue
            if knob.prefix and any(
                t.startswith(knob.name) for t in doc_tokens
            ):
                continue
            findings.append(
                Finding(
                    check="knob-registry",
                    path=reg_path,
                    line=reg_lines.get(knob.name, 1),
                    message=(
                        f"public knob {knob.name}"
                        f"{'*' if knob.prefix else ''} is not documented "
                        f"in {TUNING_DOC}"
                    ),
                )
            )

    # 5. planner <-> registry agreement
    term_knobs = _harvest_term_knobs(project)
    if term_knobs is not None:
        emitted = {knob for knob, _ in term_knobs.values()}
        for term, (knob, line) in sorted(term_knobs.items()):
            entry = registry.lookup(knob)
            if entry is None:
                findings.append(
                    Finding(
                        check="knob-registry",
                        path=PLANNER_RELPATH,
                        line=line,
                        message=(
                            f"planner term {term!r} names {knob}, which "
                            "is not a registry entry"
                        ),
                    )
                )
            elif not entry.planned:
                findings.append(
                    Finding(
                        check="knob-registry",
                        path=PLANNER_RELPATH,
                        line=line,
                        message=(
                            f"planner term {term!r} names {knob}, which "
                            "is not flagged planned=True in the registry"
                        ),
                    )
                )
        for knob in registry.knobs:
            if knob.planned and knob.name not in emitted:
                findings.append(
                    Finding(
                        check="knob-registry",
                        path=reg_path,
                        line=reg_lines.get(knob.name, 1),
                        message=(
                            f"registry flags {knob.name} planned=True but "
                            "the planner's TERM_KNOBS emits no such term"
                        ),
                    )
                )

    # 3. documented-but-undeclared tokens
    if doc is not None:
        for tok in sorted(doc_tokens):
            # `RSDL_T_*` in the doc renders as token RSDL_T_ (the *
            # falls outside the match) -> prefix lookup.
            if registry.lookup(tok, is_prefix=tok.endswith("_")) is not None:
                continue
            findings.append(
                Finding(
                    check="knob-registry",
                    path=TUNING_DOC,
                    line=doc_token_lines.get(tok, 1),
                    message=(
                        f"{TUNING_DOC} documents {tok} but the registry "
                        "has no such knob (stale doc, or add the entry)"
                    ),
                )
            )
    return findings
