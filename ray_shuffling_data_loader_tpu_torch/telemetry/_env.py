"""The one definition of a truthy telemetry flag, and the audit's gate.

:data:`audit_plane` is how the core data path (``shuffle``, ``dataset``,
``device_dataset``) reaches :mod:`.audit`: its ``enabled()`` is one
cached boolean, shared with the audit module, and imports nothing; any
other attribute imports the audit plane on first use. So a process
with the audit off never loads it.
"""

import os
from typing import Optional

TRUTHY = ("1", "on", "true", "yes")


def read_flag(name: str) -> bool:
    return os.environ.get(name, "").strip().lower() in TRUTHY


def relay_armed() -> bool:
    """Is the relay (``RSDL_RELAY``) on: set, and not off, 0 or false?
    Read before :mod:`.relay` is imported."""
    mode = os.environ.get("RSDL_RELAY", "").strip().lower()
    return bool(mode) and mode not in ("off", "0", "false")


# RSDL_AUDIT, read once; None: not read yet. :func:`.audit.enable`,
# :func:`.audit.disable` and :func:`.audit.refresh_from_env` set it.
audit_flag: Optional[bool] = None


def audit_enabled() -> bool:
    """Is the audit on in this process? One cached boolean."""
    global audit_flag
    if audit_flag is None:
        audit_flag = read_flag("RSDL_AUDIT")
    return audit_flag


class _AuditPlane:
    """:mod:`.audit` behind its gate: ``enabled`` is :func:`audit_enabled`;
    every other attribute is the audit module's, imported on first use."""

    __slots__ = ()

    enabled = staticmethod(audit_enabled)

    def __getattr__(self, name: str):
        from ray_shuffling_data_loader_tpu_torch.telemetry import audit

        return getattr(audit, name)


audit_plane = _AuditPlane()
