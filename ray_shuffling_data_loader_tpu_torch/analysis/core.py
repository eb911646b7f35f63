"""Shared lint machinery: findings, suppressions, parsed sources.

A :class:`Finding` is one violation at one location. Suppressions are
per-line comments with a *required* written reason::

    risky_call()  # rsdl-lint: disable=lock-discipline -- init-time only,
                  # no thread is alive yet

(the reason follows ``--``; a bare ``disable=`` with no reason is itself
a finding, ``bad-suppression`` — the policy is "suppressed WITH a
reason", never silently). A suppression names one or more
comma-separated checks, or ``all``. It applies to findings anchored on
its own line, or — when written as a standalone comment block — to the
first code line directly below it.
"""

from __future__ import annotations

import ast
import re
import tokenize
from dataclasses import dataclass, field
from io import StringIO
from typing import Dict, Iterable, List, Optional, Tuple

SUPPRESS_RE = re.compile(
    r"#\s*rsdl-lint:\s*disable=([A-Za-z0-9_,\- ]+?)"
    r"(?:\s*--\s*(?P<reason>.+?))?\s*$"
)


class LintCrash(Exception):
    """Internal lint failure (exit code 3, never 1): a checker bug or an
    unreadable tree must be distinguishable from real findings."""


@dataclass
class Finding:
    check: str
    path: str  # repo-root-relative, '/'-separated
    line: int
    message: str
    col: int = 0
    suppressed: bool = False
    suppress_reason: Optional[str] = None

    def location(self) -> str:
        return f"{self.path}:{self.line}"

    def to_json(self) -> Dict[str, object]:
        out: Dict[str, object] = {
            "check": self.check,
            "path": self.path,
            "line": self.line,
            "col": self.col,
            "message": self.message,
        }
        if self.suppressed:
            out["suppressed"] = True
            out["suppress_reason"] = self.suppress_reason
        return out

    @classmethod
    def from_json(cls, obj: Dict[str, object]) -> "Finding":
        return cls(
            check=str(obj["check"]),
            path=str(obj["path"]),
            line=int(obj["line"]),  # type: ignore[arg-type]
            col=int(obj.get("col", 0)),  # type: ignore[arg-type]
            message=str(obj["message"]),
            suppressed=bool(obj.get("suppressed", False)),
            suppress_reason=(
                str(obj["suppress_reason"])
                if obj.get("suppress_reason") is not None
                else None
            ),
        )


@dataclass
class Suppression:
    line: int
    checks: Tuple[str, ...]  # lowercase check names, or ("all",)
    reason: Optional[str]

    def covers(self, check: str) -> bool:
        return "all" in self.checks or check in self.checks


@dataclass
class SourceFile:
    """One parsed Python file: text, AST, and its suppression comments."""

    path: str  # repo-root-relative
    abspath: str
    text: str
    module: Optional[str] = None  # dotted module name, None outside pkgs
    _tree: Optional[ast.AST] = field(default=None, repr=False)
    _suppressions: Optional[Dict[int, List[Suppression]]] = field(
        default=None, repr=False
    )
    parse_error: Optional[str] = field(default=None, repr=False)

    @property
    def tree(self) -> Optional[ast.AST]:
        if self._tree is None and self.parse_error is None:
            try:
                self._tree = ast.parse(self.text, filename=self.path)
            except SyntaxError as exc:
                self.parse_error = f"{exc.msg} (line {exc.lineno})"
        return self._tree

    @property
    def suppressions(self) -> Dict[int, List[Suppression]]:
        if self._suppressions is None:
            self._suppressions = _parse_suppressions(self.text)
        return self._suppressions

    def lines(self) -> List[str]:
        return self.text.splitlines()


def _parse_suppressions(text: str) -> Dict[int, List[Suppression]]:
    """Tokenize so string literals containing the marker don't count."""
    out: Dict[int, List[Suppression]] = {}
    try:
        tokens = tokenize.generate_tokens(StringIO(text).readline)
        comments = [
            (tok.start[0], tok.string)
            for tok in tokens
            if tok.type == tokenize.COMMENT
        ]
    except (tokenize.TokenError, IndentationError, SyntaxError):
        # Fall back to a line scan; a malformed file will surface its
        # own parse error elsewhere.
        comments = [
            (i + 1, line[line.index("#"):])
            for i, line in enumerate(text.splitlines())
            if "#" in line
        ]
    for lineno, comment in comments:
        m = SUPPRESS_RE.search(comment)
        if not m:
            continue
        checks = tuple(
            c.strip().lower() for c in m.group(1).split(",") if c.strip()
        )
        reason = m.group("reason")
        out.setdefault(lineno, []).append(
            Suppression(line=lineno, checks=checks, reason=reason)
        )
    return out


def suppression_findings(src: SourceFile) -> List[Finding]:
    """Reason-less suppressions are violations in their own right."""
    findings = []
    for lineno, sups in sorted(src.suppressions.items()):
        for sup in sups:
            if not sup.reason:
                findings.append(
                    Finding(
                        check="bad-suppression",
                        path=src.path,
                        line=lineno,
                        message=(
                            "suppression without a reason: write "
                            "'# rsdl-lint: disable=CHECK -- <why this is "
                            "safe here>'"
                        ),
                    )
                )
    return findings


def _candidate_lines(src: SourceFile, line: int) -> Iterable[int]:
    """The finding's own line, plus any immediately-preceding run of
    pure comment lines (the standalone-comment suppression form)."""
    yield line
    lines = src.lines()
    i = line - 1  # 1-based -> the line above, 0-indexed: lines[i - 1]
    while i >= 1:
        stripped = lines[i - 1].strip()
        if stripped.startswith("#"):
            yield i
            i -= 1
        else:
            break


def apply_suppressions(
    findings: Iterable[Finding], sources: Dict[str, SourceFile]
) -> List[Finding]:
    """Mark findings covered by a suppression (with a reason) on the
    same line or in the comment block directly above it."""
    out = []
    for f in findings:
        src = sources.get(f.path)
        if src is not None:
            done = False
            for lineno in _candidate_lines(src, f.line):
                for sup in src.suppressions.get(lineno, []):
                    if sup.reason and sup.covers(f.check):
                        f.suppressed = True
                        f.suppress_reason = sup.reason
                        done = True
                        break
                if done:
                    break
        out.append(f)
    return out


# ---------------------------------------------------------------------------
# Small AST helpers shared by checkers
# ---------------------------------------------------------------------------


def dotted_name(node: ast.AST) -> Optional[str]:
    """'os.environ.get' for nested Attribute/Name chains, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def const_str(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def module_constants(tree: ast.AST) -> Dict[str, str]:
    """Module-level ``NAME = "literal"`` string constants (the
    ``ENV_FAULTS = "RSDL_FAULTS"`` idiom)."""
    out: Dict[str, str] = {}
    for node in getattr(tree, "body", []):
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            tgt = node.targets[0]
            val = const_str(node.value)
            if isinstance(tgt, ast.Name) and val is not None:
                out[tgt.id] = val
    return out


def iter_function_defs(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def is_type_checking_if(node: ast.AST) -> bool:
    """``if TYPE_CHECKING:`` / ``if typing.TYPE_CHECKING:`` blocks run
    never at runtime — imports inside them are not real edges."""
    if not isinstance(node, ast.If):
        return False
    test = node.test
    return (
        isinstance(test, ast.Name) and test.id == "TYPE_CHECKING"
    ) or (
        isinstance(test, ast.Attribute) and test.attr == "TYPE_CHECKING"
    )
