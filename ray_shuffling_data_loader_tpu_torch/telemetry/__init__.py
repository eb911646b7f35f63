"""The port's telemetry planes. One is ported so far: :mod:`.audit`
(``RSDL_AUDIT``), the exactly-once digests of every side of the shuffle.

Submodules resolve on first use (PEP 562), so importing this package
loads nothing but the standard library; the audit module itself loads
numpy only, for the pool workers that digest the map and reduce sides.
"""

import importlib

_LAZY_SUBMODULES = frozenset(("audit",))


def __getattr__(name):
    if name in _LAZY_SUBMODULES:
        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
