"""The repo model the checkers share: file discovery, module naming,
and the invariant configuration (which modules are core, which are
gated planes, where the docs live).

Everything is expressed relative to a *root* directory so the same
checkers run against this repo and against the fixture mini-repos the
test suite builds in a tmp dir.

The scope is what belongs to the port: its package, ``chip_smoke.py``,
``tools/torch_port_*.py``, ``tests/test_torch_*.py`` and
``tests/torch_port_helpers.py``. The configuration sets are the JAX
package's, module for module, and two modules of the port's own join
them: ``utils.prng`` (the epoch permutation the JAX package draws from
``jax.random``) the determinism set, ``device_dataset`` (the delivery to
the card, which every trainer imports beside ``dataset``) the core set.
The docs are the JAX package's, read and never written: the port reads
no knob and emits no metric of its own.
"""

from __future__ import annotations

import fnmatch
import os
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional

from ray_shuffling_data_loader_tpu_torch.analysis.core import SourceFile

PACKAGE = "ray_shuffling_data_loader_tpu_torch"

# Directories (relative to root) whose .py files are scanned, each with
# the file-name patterns it contributes (None: every .py file). Order is
# presentation order only.
CODE_DIRS = (
    (PACKAGE, None),
    ("tools", ("torch_port_*.py",)),
    ("tests", ("test_torch_*.py", "torch_port_helpers.py")),
)
CODE_FILES = ("chip_smoke.py",)
SKIP_DIR_NAMES = {"__pycache__", ".git", "build", "dist"}
# The analysis package lints itself: its sources are scanned like any
# other (suppression-syntax validation included). Checkers whose scope
# is module-name-keyed (determinism, barriers) never match it; the
# graph/harvest checkers treat it as ordinary non-core code.

# --- gate-integrity configuration ------------------------------------------

# Env-gated planes: importing a core module must not execute these
# module bodies. (metrics/_env are NOT here: they ARE the cached-boolean
# gate every site checks, deliberately cheap and eagerly importable.)
GATED_PLANES = {
    f"{PACKAGE}.telemetry.{m}"
    for m in (
        "timeseries",
        "events",
        "stragglers",
        "capacity",
        "critical",
        "slo",
        "export",
        "audit",
        "trace",
        "phases",
        "obs_server",
        "runledger",
        "profiler",
        "relay",
    )
} | {
    f"{PACKAGE}.runtime.{m}"
    for m in ("journal", "faults", "elastic", "service", "plan")
} | {
    # Self-tuning plan compiler: RSDL_PLAN=auto|on.
    f"{PACKAGE}.analysis.planner",
}

# Core data-path modules: the zero-overhead-off contract is theirs.
CORE_MODULES = {
    f"{PACKAGE}.shuffle",
    f"{PACKAGE}.dataset",
    f"{PACKAGE}.batch_queue",
    f"{PACKAGE}.checkpoint",
    f"{PACKAGE}.runtime.tasks",
    f"{PACKAGE}.runtime.actor",
    f"{PACKAGE}.runtime.store",
    f"{PACKAGE}.runtime.transport",
    f"{PACKAGE}.runtime.cluster",
    # The delivery to the card (the counterpart of jax_dataset), which
    # every trainer of the port imports beside dataset.
    f"{PACKAGE}.device_dataset",
}

# --- determinism-hygiene configuration -------------------------------------

# Plan- or digest-affecting modules: anything nondeterministic here can
# break the bit-identical resume/replay digest contract.
DETERMINISM_MODULES = {
    f"{PACKAGE}.shuffle",
    f"{PACKAGE}.checkpoint",
    f"{PACKAGE}.utils",  # plan-family parsing / decode-plan resolution
    # The resident loader's epoch permutation, which the JAX package
    # draws from jax.random.
    f"{PACKAGE}.utils.prng",
    f"{PACKAGE}.runtime.journal",
    f"{PACKAGE}.telemetry.audit",
}

# --- barrier-order configuration -------------------------------------------

# Files whose task-done / quiesce signaling must be preceded by spool
# flushes (module names; the checker matches per enclosing function).
BARRIER_MODULES = {
    f"{PACKAGE}.runtime.tasks",
    f"{PACKAGE}.runtime.actor",
}
FLUSH_CALL_NAMES = {
    "_flush_telemetry_spools",
    "safe_flush",
    "maybe_flush",
}

# --- docs -------------------------------------------------------------------

TUNING_DOC = os.path.join("docs", "TUNING.md")
OBSERVABILITY_DOC = os.path.join("docs", "observability.md")


@dataclass
class Project:
    root: str
    _sources: Optional[Dict[str, SourceFile]] = field(
        default=None, repr=False
    )
    _docs: Dict[str, Optional[str]] = field(default_factory=dict, repr=False)

    # -- discovery -----------------------------------------------------------

    def _iter_paths(self) -> Iterator[str]:
        for name in CODE_FILES:
            p = os.path.join(self.root, name)
            if os.path.isfile(p):
                yield p
        for d, patterns in CODE_DIRS:
            top = os.path.join(self.root, d)
            if not os.path.isdir(top):
                continue
            for dirpath, dirnames, filenames in os.walk(top):
                dirnames[:] = sorted(
                    n for n in dirnames if n not in SKIP_DIR_NAMES
                )
                for fn in sorted(filenames):
                    if fn.endswith(".py") and (
                        patterns is None
                        or any(fnmatch.fnmatch(fn, p) for p in patterns)
                    ):
                        yield os.path.join(dirpath, fn)

    def relpath(self, abspath: str) -> str:
        return os.path.relpath(abspath, self.root).replace(os.sep, "/")

    def module_name(self, relpath: str) -> Optional[str]:
        """Dotted module name for package files, None for scripts."""
        parts = relpath.split("/")
        if parts[0] != PACKAGE:
            return None
        if parts[-1] == "__init__.py":
            parts = parts[:-1]
        else:
            parts[-1] = parts[-1][: -len(".py")]
        return ".".join(parts)

    @property
    def sources(self) -> Dict[str, SourceFile]:
        if self._sources is None:
            out: Dict[str, SourceFile] = {}
            for abspath in self._iter_paths():
                rel = self.relpath(abspath)
                try:
                    with open(abspath, "r", encoding="utf-8") as f:
                        text = f.read()
                except OSError:
                    continue
                out[rel] = SourceFile(
                    path=rel,
                    abspath=abspath,
                    text=text,
                    module=self.module_name(rel),
                )
            self._sources = out
        return self._sources

    def package_sources(self) -> List[SourceFile]:
        return [s for s in self.sources.values() if s.module is not None]

    def by_module(self) -> Dict[str, SourceFile]:
        return {
            s.module: s for s in self.sources.values() if s.module is not None
        }

    def doc_text(self, relpath: str) -> Optional[str]:
        key = relpath.replace(os.sep, "/")
        if key not in self._docs:
            p = os.path.join(self.root, relpath)
            try:
                with open(p, "r", encoding="utf-8") as f:
                    self._docs[key] = f.read()
            except OSError:
                self._docs[key] = None
        return self._docs[key]
