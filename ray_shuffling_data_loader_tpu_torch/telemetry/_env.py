"""The one definition of a truthy telemetry flag."""

import os

TRUTHY = ("1", "on", "true", "yes")


def read_flag(name: str) -> bool:
    return os.environ.get(name, "").strip().lower() in TRUTHY


def relay_armed() -> bool:
    """Is the relay (``RSDL_RELAY``) on: set, and not off, 0 or false?
    Read before :mod:`.relay` is imported."""
    mode = os.environ.get("RSDL_RELAY", "").strip().lower()
    return bool(mode) and mode not in ("off", "0", "false")
