"""Host runtime for the port: columnar batches and a task pool.

The shuffle's stages are Parquet decode (pyarrow releases the GIL) and
large numpy gathers (numpy releases the GIL), so a thread pool serves them
without spawned worker processes. :class:`ColumnBatch` is the unit every
stage passes along: named, equal-length, contiguous numpy columns.
"""

from __future__ import annotations

import os
import threading
from collections.abc import Mapping
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Optional, Sequence

import numpy as np


class ColumnBatch(Mapping):
    """Named equal-length numpy columns (``Mapping[str, np.ndarray]``)."""

    def __init__(self, columns: Dict[str, np.ndarray]):
        self._columns = columns
        lengths = {len(v) for v in columns.values()}
        if len(lengths) > 1:
            raise ValueError(f"ragged columns: {lengths}")
        self._num_rows = lengths.pop() if lengths else 0

    def __getitem__(self, key: str) -> np.ndarray:
        return self._columns[key]

    def __iter__(self) -> Iterator[str]:
        return iter(self._columns)

    def __len__(self) -> int:
        return len(self._columns)

    @property
    def num_rows(self) -> int:
        return self._num_rows

    @property
    def columns(self) -> Dict[str, np.ndarray]:
        return self._columns

    @property
    def nbytes(self) -> int:
        return sum(v.nbytes for v in self._columns.values())

    def take(self, indices: np.ndarray) -> "ColumnBatch":
        return ColumnBatch({k: v[indices] for k, v in self._columns.items()})

    def slice(self, start: int, stop: int) -> "ColumnBatch":
        """Zero-copy row slice."""
        return ColumnBatch({k: v[start:stop] for k, v in self._columns.items()})

    @staticmethod
    def concat(batches: Sequence[Optional["ColumnBatch"]]) -> "ColumnBatch":
        batches = [b for b in batches if b is not None and b.num_rows > 0]
        if not batches:
            return ColumnBatch({})
        if len(batches) == 1:
            return batches[0]
        return ColumnBatch(
            {k: np.concatenate([b[k] for b in batches]) for k in batches[0]}
        )

    @staticmethod
    def concat_take(
        batches: Sequence[Optional["ColumnBatch"]], indices: np.ndarray
    ) -> "ColumnBatch":
        """``concat(batches).take(indices)``: the reduce stage's gather."""
        batches = [b for b in batches if b is not None and b.num_rows > 0]
        if not batches:
            return ColumnBatch({})
        return ColumnBatch(
            {
                k: np.concatenate([b[k] for b in batches])[indices]
                for k in batches[0]
            }
        )


class RuntimeContext:
    def __init__(self, num_workers: int):
        self.num_workers = num_workers
        self.pool = ThreadPoolExecutor(
            max_workers=num_workers, thread_name_prefix="rsdl-task"
        )


_LOCK = threading.Lock()
_CTX: Optional[RuntimeContext] = None


def init(num_workers: Optional[int] = None) -> RuntimeContext:
    """Start the task pool (idempotent: a second call returns the first
    context)."""
    global _CTX
    with _LOCK:
        if _CTX is None:
            _CTX = RuntimeContext(max(1, num_workers or os.cpu_count() or 1))
        return _CTX


def ensure_initialized() -> RuntimeContext:
    return _CTX if _CTX is not None else init()


def shutdown() -> None:
    """Stop the pool, waiting for running tasks."""
    global _CTX
    with _LOCK:
        ctx, _CTX = _CTX, None
    if ctx is not None:
        ctx.pool.shutdown(wait=True, cancel_futures=True)


__all__ = [
    "ColumnBatch",
    "RuntimeContext",
    "ensure_initialized",
    "init",
    "shutdown",
]
