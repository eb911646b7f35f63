"""The one definition of a truthy telemetry flag."""

import os

TRUTHY = ("1", "on", "true", "yes")


def read_flag(name: str) -> bool:
    return os.environ.get(name, "").strip().lower() in TRUTHY
