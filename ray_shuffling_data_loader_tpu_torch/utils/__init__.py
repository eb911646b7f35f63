"""Shared utilities: the device rule, the epoch permutation, Arrow's decode
threads and dataset paths (local or URI).

This module imports the standard library only: the shuffle's spawned
workers resolve dataset URIs through it and never load ``torch``.
``epoch_permutation`` and ``resolve_device``, which need ``torch``, resolve
on first use (PEP 562).
"""

import importlib
import os

_LAZY = {"epoch_permutation": "prng", "resolve_device": "device"}


def __getattr__(name):
    if name not in _LAZY:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{_LAZY[name]}"), name)
    globals()[name] = value
    return value


def decode_use_threads(num_concurrent_tasks: int) -> bool:
    """Should one Parquet decode use Arrow's own thread pool? Yes when the
    host has at least twice as many cores as decodes run at once: the
    worker pool already decodes one file per worker, and Arrow's threads on
    a saturated host oversubscribe it. ``RSDL_DECODE_THREADS=on|off``
    overrides."""
    env = os.environ.get("RSDL_DECODE_THREADS", "").lower()
    if env in ("on", "1", "true"):
        return True
    if env in ("off", "0", "false"):
        return False
    return (os.cpu_count() or 1) >= 2 * max(1, num_concurrent_tasks)


def arrow_decode_threads(stage_tasks: int) -> bool:
    """The decision of :func:`decode_use_threads` for one decode task,
    taken in the worker that decodes, from its own host's cores:
    ``stage_tasks`` decodes in the stage run at most ``min(stage_tasks,
    cores)`` at once here. When threads engage, Arrow's process-wide pool
    is capped to this task's share of the cores (``cores // concurrent``);
    a worker runs one task at a time, so the cap is its own."""
    cores = os.cpu_count() or 1
    concurrent = min(max(1, stage_tasks), cores)
    if not decode_use_threads(concurrent):
        return False
    import pyarrow as pa

    pa.set_cpu_count(max(2, cores // concurrent))
    return True


def is_remote_path(path: str) -> bool:
    """True for a URI (``file://``, ``s3://``, ``memory://``, ...): one
    definition for the Parquet readers and writers and the stats writer."""
    return "://" in path


# Schemes pyarrow's own C++ filesystems serve: no Python dependency, and
# reads without a copy through Python. ``file://`` is pyarrow's
# LocalFileSystem too. Every other scheme goes through fsspec.
_PYARROW_NATIVE_SCHEMES = ("s3", "gs", "gcs", "hdfs", "viewfs")


def _fsspec_for(scheme: str):
    """fsspec, imported on first need: only a scheme that neither pyarrow
    nor the local filesystem serves needs it. Missing, the error names the
    scheme."""
    try:
        import fsspec
    except ImportError as exc:
        raise ImportError(
            f"{scheme}:// paths need fsspec, which is not installed "
            "(file:// and the s3, gs, gcs, hdfs and viewfs schemes do not)"
        ) from exc
    return fsspec


def parquet_filesystem(path: str):
    """``(filesystem, path within it)`` for pyarrow's readers and writers
    (``pq.ParquetFile(rel, filesystem=fs)``, ``pq.write_table(...,
    filesystem=fs)``).

    A local path gives ``(None, path)``: pyarrow then maps the file.
    ``file://`` gives pyarrow's ``LocalFileSystem`` and the path without the
    scheme (the same bytes as the local path, read without a map); ``s3``,
    ``gs``, ``gcs``, ``hdfs`` and ``viewfs`` pyarrow's native filesystems;
    any other scheme (``memory://``, ``http://``, ...) an fsspec filesystem
    wrapped for pyarrow. A URI never falls back to a local read."""
    if not is_remote_path(path):
        return None, path
    from pyarrow import fs as pafs

    scheme = path.split("://", 1)[0]
    if scheme in _PYARROW_NATIVE_SCHEMES or scheme == "file":
        return pafs.FileSystem.from_uri(path)
    fs, rel = _fsspec_for(scheme).core.url_to_fs(path)
    return pafs.PyFileSystem(pafs.FSSpecHandler(fs)), rel


__all__ = [
    "arrow_decode_threads",
    "decode_use_threads",
    "epoch_permutation",
    "is_remote_path",
    "parquet_filesystem",
    "resolve_device",
]
