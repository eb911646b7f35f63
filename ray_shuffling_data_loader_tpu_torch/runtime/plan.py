"""A resolved shuffle plan: what :mod:`..analysis.planner` compiles.

A :class:`ResolvedPlan` holds one :class:`PlanTerm` per knob the planner
owns: the effective value, where it came from (``env``: an operator set
the knob, and the planner keeps it; ``planned``: the cost model chose
it; ``replanned``: the re-planner changed it between epochs) and why.
``shuffle()`` takes the plan family and the projection from it, and
hands :meth:`ResolvedPlan.task_knobs` to every stage task as an argument.

The plan of the run in progress is registered here (:func:`set_current`)
and cleared when the run ends.

``shuffle()`` imports this module only under ``RSDL_PLAN=auto|on``.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

ENV_PLAN = "RSDL_PLAN"

SOURCE_ENV = "env"
SOURCE_PLANNED = "planned"
SOURCE_REPLANNED = "replanned"

# Terms the re-planner may change between epochs. None changes the
# delivered stream: thread counts and the window depth change only how
# the work runs, and every schedule delivers the same stream.
MUTABLE_TERMS = ("fetch_window_depth", "decode_rowgroup_threads", "selective")


@dataclass
class PlanTerm:
    """One knob's effective value and its provenance."""

    name: str
    knob: str
    value: Any
    source: str
    why: str = ""

    def as_dict(self) -> Dict[str, Any]:
        value = list(self.value) if isinstance(self.value, tuple) else self.value
        return {"value": value, "source": self.source, "knob": self.knob, "why": self.why}


@dataclass
class ResolvedPlan:
    """Every planner-owned knob, resolved once by the process that calls
    ``shuffle()``. ``plan``: the ``(family, granularity)`` every schedule
    assigns rows with; ``projection``: the planned decode projection
    (None: the caller's or none)."""

    plan: Tuple[str, int]
    projection: Optional[List[str]]
    terms: Dict[str, PlanTerm]
    model: Dict[str, Any] = field(default_factory=dict)
    replans: int = 0

    def term_value(self, name: str) -> Any:
        t = self.terms.get(name)
        return t.value if t is not None else None

    def task_knobs(self) -> Dict[str, Any]:
        """The plain dict the stage tasks take (workers never import this
        module): the decode, window and kernel thread values and the
        selective decision, those that are set."""
        out: Dict[str, Any] = {}
        for name in ("decode_rowgroup_threads", "fetch_window_depth", "native_threads", "selective"):
            value = self.term_value(name)
            if value is not None:
                out[name] = value
        return out

    def terms_dict(self) -> Dict[str, Dict[str, Any]]:
        """Every term as JSON-ready dicts, by name."""
        return {name: t.as_dict() for name, t in sorted(self.terms.items())}

    def effective_env(self) -> Dict[str, str]:
        """``{knob: value}`` of each term with a value: the environment that
        runs the same plan by hand."""
        out: Dict[str, str] = {}
        for t in self.terms.values():
            if t.value is None:
                continue
            if t.name == "plan":
                family, granularity = self.plan
                out[t.knob] = family if family == "rowwise" else f"block:{granularity}"
            elif t.name == "selective":
                out[t.knob] = "on" if t.value else "off"
            elif t.name == "columns":
                out[t.knob] = "planned:" + ",".join(map(str, t.value))
            else:
                out[t.knob] = str(t.value)
        return out


_lock = threading.Lock()
_current: Optional[ResolvedPlan] = None


def set_current(rplan: Optional[ResolvedPlan]) -> None:
    global _current
    with _lock:
        _current = rplan


def current() -> Optional[ResolvedPlan]:
    with _lock:
        return _current


def current_terms() -> Optional[Dict[str, Dict[str, Any]]]:
    """The run in progress's terms (with ``_replans`` once the re-planner
    changed one), or None."""
    rplan = current()
    if rplan is None:
        return None
    terms = rplan.terms_dict()
    if rplan.replans:
        terms["_replans"] = {"value": rplan.replans}
    return terms


def effective_env() -> Dict[str, str]:
    rplan = current()
    return rplan.effective_env() if rplan is not None else {}
