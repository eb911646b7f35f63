"""Analyses of the port that run apart from a shuffle.

* :mod:`.planner`, the plan compiler: a gated plane, imported only when
  ``RSDL_PLAN`` asks for it;
* rsdl-lint, the invariant-enforcing static analysis: :mod:`.core`
  (findings, suppressions, parsed sources), :mod:`.project` (the port's
  scope and its configuration sets) and the six checkers in
  :mod:`.checkers`, run by :mod:`..rsdl_lint`.

========================  ===================================================
checker                   invariant
========================  ===================================================
``gate-integrity``        env-gated planes are reachable from core
                          data-path modules only through function-level
                          lazy imports, gated proxies or ``sys.modules``
                          lookups, never module-level imports
``knob-registry``         every ``RSDL_*`` env read is declared in
                          :mod:`.knob_registry` and every public knob is
                          documented in ``docs/TUNING.md``
``vocabulary-drift``      metric names, ``rsdl_`` Prometheus aliases, and
                          event kinds emitted by code appear in
                          ``docs/observability.md``
``determinism-hygiene``   no unseeded ``random``/``np.random``/time-derived
                          seeding in plan- or digest-affecting modules
``lock-discipline``       module-level mutable state mutated off-lock in
                          threaded modules; inconsistent lock-acquisition
                          order across ``with`` statements
``barrier-order``         spool flushes precede task-done / quiesce
                          signaling in ``runtime/tasks.py`` and
                          ``runtime/actor.py``
========================  ===================================================

Suppressions are per line, with a required reason:
``# rsdl-lint: disable=CHECK -- reason``.

The names below resolve on first touch (PEP 562), unlike the JAX
package's ``analysis/__init__``, which imports the checkers eagerly: so
importing the planner loads no checker. Everything here is standard
library only and loads no ``torch``.
"""

import importlib

_EXPORTS = {
    "Finding": "core",
    "LintCrash": "core",
    "Project": "project",
    "all_checkers": "checkers",
    "get_checker": "checkers",
    "run_checks": "checkers",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{module}"), name)
    globals()[name] = value
    return value
