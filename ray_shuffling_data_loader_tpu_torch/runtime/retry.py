"""The runtime's retry policies: bounded exponential backoff with jitter,
so that N trainer ranks dialling one queue actor spread out instead of
retrying in lockstep, and the shuffle's stage tasks re-execute a bounded
number of times (:func:`stage_policy`). Each backoff counts into
``recovery.retries{site}`` and marks a ``recovery:retry`` instant on the
trace.

This module imports the standard library only.
"""

from __future__ import annotations

import os
import random
import time
from dataclasses import dataclass
from typing import Iterator, Optional, Tuple


@dataclass(frozen=True)
class RetryPolicy:
    """``max_attempts`` counts the first try. Each delay is
    ``base * multiplier**(attempt - 1)`` capped at ``max_delay_s``, its
    ``jitter`` fraction drawn at random; ``deadline_s`` bounds the whole
    sequence."""

    max_attempts: int = 5
    base_delay_s: float = 0.05
    max_delay_s: float = 2.0
    multiplier: float = 2.0
    jitter: float = 0.5
    deadline_s: Optional[float] = None

    def delay(self, attempt: int) -> float:
        d = min(self.max_delay_s, self.base_delay_s * self.multiplier ** max(0, attempt - 1))
        return d * (1.0 - self.jitter) + random.random() * self.jitter * d

    def attempts(self, site: str = "") -> Iterator[Tuple[int, "_Attempt"]]:
        """``(attempt, handle)`` pairs, attempts numbered from 1; after a
        failure call ``handle.backoff()`` to sleep before the next attempt.
        ``site`` names the caller: each backoff adds to
        ``recovery.retries{site}`` and marks a ``recovery:retry`` instant."""
        deadline = None if self.deadline_s is None else time.monotonic() + self.deadline_s
        for attempt in range(1, self.max_attempts + 1):
            yield attempt, _Attempt(self, attempt, deadline, site)
            if deadline is not None and time.monotonic() >= deadline:
                return


def _observe_retry(site: str, attempt: int, error: str) -> None:
    """``recovery.retries{site}`` and a ``recovery:retry`` instant, each
    a cached boolean while its telemetry half is off. Never raises into
    the retry loop."""
    try:
        from ray_shuffling_data_loader_tpu_torch import telemetry

        telemetry.metrics.safe_inc("recovery.retries", site=site)
        if telemetry.traced():
            telemetry.instant("recovery:retry", cat="recovery", site=site, attempt=attempt, error=error[:200])
    except Exception:
        pass


class _Attempt:
    __slots__ = ("_policy", "_attempt", "_deadline", "_site")

    def __init__(self, policy: RetryPolicy, attempt: int, deadline: Optional[float], site: str = ""):
        self._policy = policy
        self._attempt = attempt
        self._deadline = deadline
        self._site = site

    def backoff(self, error: str = "") -> None:
        _observe_retry(self._site, self._attempt, error)
        d = self._policy.delay(self._attempt)
        if self._deadline is not None:
            d = min(d, max(0.0, self._deadline - time.monotonic()))
        if d > 0:
            time.sleep(d)


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


def connect_policy(num_retries: int) -> RetryPolicy:
    """Discovery of a named actor: from 0.5 s, capped at
    ``$RSDL_CONNECT_MAX_BACKOFF_S`` (default 5 s), 50 % jitter."""
    return RetryPolicy(
        max_attempts=max(1, num_retries),
        base_delay_s=0.5,
        max_delay_s=_env_float("RSDL_CONNECT_MAX_BACKOFF_S", 5.0),
    )


_CALL_POLICY: Optional[RetryPolicy] = None


def call_policy() -> RetryPolicy:
    """Sending one call: rides out a connection reset, not a dead actor
    (``$RSDL_CALL_RETRIES`` attempts, default 3, within
    ``$RSDL_CALL_DEADLINE_S``, default 10 s). Read once per process: it
    sits on every queue call."""
    global _CALL_POLICY
    if _CALL_POLICY is None:
        _CALL_POLICY = RetryPolicy(
            max_attempts=_env_int("RSDL_CALL_RETRIES", 3),
            base_delay_s=0.05,
            max_delay_s=0.5,
            deadline_s=_env_float("RSDL_CALL_DEADLINE_S", 10.0),
        )
    return _CALL_POLICY


def refresh_policies() -> None:
    """Forget the cached policies; the next use reads the environment."""
    global _CALL_POLICY
    _CALL_POLICY = None


def stage_policy() -> RetryPolicy:
    """A shuffle stage task's re-execution budget:
    ``$RSDL_STAGE_MAX_ATTEMPTS`` attempts (default 3, the first included)
    from 0.05 s, capped at 1 s. A task that fails every attempt fails its
    epoch with ``StageFailedError``. Read at every epoch."""
    return RetryPolicy(max_attempts=_env_int("RSDL_STAGE_MAX_ATTEMPTS", 3), base_delay_s=0.05, max_delay_s=1.0)
