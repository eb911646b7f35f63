"""Seeded fault injection: named sites in the runtime fire scripted faults,
so that the recovery paths run and a chaos run replays bit for bit.

The sites: ``transport.send`` and ``transport.recv`` (a framed
connection), ``store.put`` and ``store.get`` (a segment's creation and
mapping), ``task.map`` and ``task.reduce`` (every stage task's entry and
exit), ``actor.<Class>`` (an actor's dispatch of a method) and
``queue.producer`` (the shuffle's delivery of one reducer).

``RSDL_FAULTS`` holds comma-separated rules
``site[/role]:kind:prob[@epoch][xN]``:

* ``/role``: fire only in processes of that role, ``driver`` (any
  process that set no other), ``task`` (pool workers) or ``actor``
  (actor processes);
* ``kind``: ``crash``, ``crash-entry``, ``crash-exit`` (raise
  :class:`FaultInjected`; the suffixed kinds only at that point of a
  stage task), ``reset`` (``ConnectionResetError``), ``delay`` and
  ``stall`` (sleep ``RSDL_FAULTS_DELAY_S``, default 0.05), ``lost`` and
  ``corrupt`` (the store's sites raise ``ObjectLostError`` /
  ``ObjectCorruptError``), ``fail`` (``OSError``), ``kill``
  (``os._exit``) and ``wedge`` (sleep ``RSDL_FAULTS_WEDGE_S``, default
  30);
* ``prob``: the chance in (0, 1] that one invocation of the site fires;
* ``@epoch``: only in that epoch (sites that know theirs);
* ``xN``: at most N times in one process.

Whether invocation ``i`` of a site fires is a pure function of
``(RSDL_FAULTS_SEED, site, kind, i)`` (splitmix64), the JAX package's,
decision for decision: a fixed seed replays the same schedule in each
process. Which worker runs which task is not fixed, so two runs under one
schedule are held to what they deliver, not to which task failed.

Every fire counts into ``faults.injected{site,kind}`` while metrics are
on. With ``RSDL_FAULTS`` unset a site costs one cached boolean
(:func:`enabled`). This module imports the standard library only.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)

ENV_FAULTS = "RSDL_FAULTS"
ENV_SEED = "RSDL_FAULTS_SEED"
ENV_DELAY_S = "RSDL_FAULTS_DELAY_S"
ENV_WEDGE_S = "RSDL_FAULTS_WEDGE_S"

KINDS = frozenset(
    ("crash", "crash-entry", "crash-exit", "reset", "delay", "stall", "lost", "corrupt", "fail", "kill", "wedge")
)

_enabled: Optional[bool] = None  # None: the environment not read yet
_lock = threading.Lock()
_rules: Optional[List["Rule"]] = None
_invocations: Dict[str, int] = {}  # site -> invocations in this process
_fired: Dict[Tuple[str, str], int] = {}  # (site, base kind) -> fires
_role = "driver"


class FaultInjected(RuntimeError):
    """An injected crash. It subclasses no error of the domain, so a path
    that recovers from it recovers from any crash of a task."""

    def __init__(self, site: str, kind: str):
        super().__init__(f"injected fault at {site} ({kind})")
        self.site = site
        self.kind = kind

    def __reduce__(self):
        return (FaultInjected, (self.site, self.kind))


@dataclass
class Rule:
    site: str
    kind: str
    prob: float
    role: Optional[str] = None
    epoch: Optional[int] = None
    max_fires: Optional[int] = None
    fired: int = 0


def enabled() -> bool:
    """Is a schedule armed in this process? Read once from the
    environment, then cached."""
    global _enabled
    if _enabled is None:
        _enabled = bool(os.environ.get(ENV_FAULTS, "").strip())
    return _enabled


def refresh_from_env() -> None:
    """Forget the cached schedule, counts and fires; the next site reads
    the environment again."""
    global _enabled, _rules
    with _lock:
        _enabled = None
        _rules = None
        _invocations.clear()
        _fired.clear()


def reset() -> None:
    """Disarm: drop ``RSDL_FAULTS`` and every cached state."""
    os.environ.pop(ENV_FAULTS, None)
    refresh_from_env()


def configure(spec: str, seed: Optional[int] = None) -> None:
    """Arm ``spec`` in this process and, through the environment, in every
    process spawned after (so before the worker pool starts). A malformed
    spec raises here."""
    parse_spec(spec)
    os.environ[ENV_FAULTS] = spec
    if seed is not None:
        os.environ[ENV_SEED] = str(int(seed))
    refresh_from_env()


def set_role(role: str) -> None:
    """This process's role for the rules' ``/role`` filter: the pool's
    workers set ``task``, the actor processes ``actor``."""
    global _role
    _role = role


def role() -> str:
    return _role


def parse_spec(spec: str) -> List[Rule]:
    """``site[/role]:kind:prob[@epoch][xN],...`` -> rules; a malformed entry
    raises ``ValueError``."""
    rules: List[Rule] = []
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        parts = entry.split(":")
        if len(parts) != 3:
            raise ValueError(f"bad fault rule {entry!r}: want site[/role]:kind:prob[@epoch][xN]")
        site, kind, tail = parts
        rule_role = None
        if "/" in site:
            site, rule_role = site.split("/", 1)
        if kind not in KINDS:
            raise ValueError(f"bad fault kind {kind!r} in {entry!r}; known: {sorted(KINDS)}")
        epoch = max_fires = None
        if "x" in tail:
            tail, count = tail.rsplit("x", 1)
            max_fires = int(count)
        if "@" in tail:
            tail, at = tail.split("@", 1)
            epoch = int(at)
        prob = float(tail)
        if not 0.0 < prob <= 1.0:
            raise ValueError(f"bad fault prob {prob!r} in {entry!r}")
        rules.append(Rule(site, kind, prob, rule_role, epoch, max_fires))
    return rules


def _get_rules() -> List[Rule]:
    global _rules
    with _lock:
        if _rules is None:
            spec = os.environ.get(ENV_FAULTS, "")
            try:
                _rules = parse_spec(spec)
            except ValueError:
                # A spawned process must not fail its tasks over a typo that
                # configure() already refused in the driver.
                logger.error("faults: %s=%r does not parse; injection off", ENV_FAULTS, spec)
                _rules = []
        return _rules


def _seed() -> int:
    try:
        return int(os.environ.get(ENV_SEED, "0"))
    except ValueError:
        return 0


_MASK = (1 << 64) - 1


def _splitmix64(z: int) -> int:
    z = (z + 0x9E3779B97F4A7C15) & _MASK
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK
    return (z ^ (z >> 31)) & _MASK


def _decision(seed: int, site: str, kind: str, invocation: int) -> float:
    """A uniform draw in [0, 1) from ``(seed, site, kind, invocation)``."""
    h = seed & _MASK
    for token in (site, kind):
        for ch in token.encode():
            h = _splitmix64(h ^ ch)
    return _splitmix64(h ^ invocation) / float(1 << 64)


def _base_kind(kind: str) -> str:
    return kind.split("-", 1)[0]


def should_fire(site: str, epoch: Optional[int] = None, point: Optional[str] = None) -> Optional[str]:
    """Count one invocation of ``site`` and return the base kind of the
    first rule that fires there (``crash``, ``lost``, ...), or None. A
    ``-entry``/``-exit`` kind fires only at that ``point``."""
    if not enabled():
        return None
    rules = _get_rules()
    if not rules:
        return None
    with _lock:
        inv = _invocations.get(site, 0)
        _invocations[site] = inv + 1
    for rule in rules:
        if rule.site != site or (rule.role is not None and rule.role != _role):
            continue
        if rule.epoch is not None and rule.epoch != epoch:
            continue
        if "-" in rule.kind and rule.kind.split("-", 1)[1] != point:
            continue
        if rule.prob < 1.0 and _decision(_seed(), site, rule.kind, inv) >= rule.prob:
            continue
        kind = _base_kind(rule.kind)
        with _lock:
            # The cap is checked and taken at once: threads of one process
            # must not fire an xN rule N + 1 times.
            if rule.max_fires is not None and rule.fired >= rule.max_fires:
                continue
            rule.fired += 1
            _fired[(site, kind)] = _fired.get((site, kind), 0) + 1
        logger.warning("faults: injecting %s at %s (epoch=%s, pid=%d, role=%s)", kind, site, epoch, os.getpid(), _role)
        _count_fired(site, kind)
        return kind
    return None


def _count_fired(site: str, kind: str) -> None:
    """``faults.injected{site,kind}`` (a cached boolean while metrics are
    off; never raises)."""
    try:
        from ray_shuffling_data_loader_tpu_torch.telemetry import metrics

        metrics.safe_inc("faults.injected", site=site, kind=kind)
    except Exception:
        pass


def _env_seconds(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


def fire(site: str, epoch: Optional[int] = None, point: Optional[str] = None) -> None:
    """Decide and act: raise, sleep or exit as the firing rule's kind says.
    Callers check :func:`enabled` first. The store's ``lost`` and
    ``corrupt`` act in the store (:func:`should_fire`); reaching here, they
    crash, so a rule on the wrong site is loud."""
    kind = should_fire(site, epoch=epoch, point=point)
    if kind is None:
        return
    if kind in ("crash", "lost", "corrupt"):
        raise FaultInjected(site, kind)
    if kind == "reset":
        raise ConnectionResetError(f"injected connection reset at {site}")
    if kind == "fail":
        raise OSError(f"injected failure at {site}")
    if kind in ("delay", "stall"):
        time.sleep(_env_seconds(ENV_DELAY_S, 0.05))
    elif kind == "wedge":
        time.sleep(_env_seconds(ENV_WEDGE_S, 30.0))
    elif kind == "kill":
        # No atexit, no flush: supervision must cope with a process that
        # vanishes.
        os._exit(17)


def fired_counts() -> Dict[Tuple[str, str], int]:
    """``(site, base kind) -> fires`` in this process."""
    with _lock:
        return dict(_fired)
