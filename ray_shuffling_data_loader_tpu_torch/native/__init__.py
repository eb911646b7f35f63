"""The shuffle's host kernels (``kernels.cc``, C++) through ctypes.

The hot host passes of the shuffle: permutation gathers (:func:`take`),
the reduce's fused concat and gather (:func:`take_multi`), the map's
stable group-by scatter (:func:`group_rows_multi`), the scatter that
inverts a gather (:func:`scatter`) and the narrowing casts
(:func:`narrow_i64_checked`, :func:`narrow`). Each wrapper has the JAX
package's name and semantics (numpy's index rules included), and a plain
numpy version beside it (``*_plain``), which computes the same bits.

The library builds at first use with ``g++ -O3 -std=c++17 -shared -fPIC
-pthread`` into the directory of :func:`.._build.build_dir`; its file name
carries a hash of the source and the flags. A build that fails raises a
``RuntimeError`` naming g++ and its output: there is no silent fallback.
``RSDL_DISABLE_NATIVE`` (any non-empty value, as in the JAX package)
selects the plain versions instead, and nothing is built. The shuffle
resolves that choice in its own process and hands it to every stage task
(:func:`set_enabled`), since a worker's environment dates from its spawn.

A wrapper still takes numpy for one call when the kernel cannot take its
inputs (a non-contiguous array, non-integer or negative indices, parts
of mixed dtypes). Every call is counted per process and per kernel, as
run by the kernel or by numpy (:func:`counts`); a call with nothing to do
is not counted.

``RSDL_NATIVE_THREADS`` sets the kernels' thread count (default
``min(8, cores)``), read once per process. The C side gives a call at
most one thread per ``_MIN_ROWS_PER_THREAD`` rows.

This package imports numpy and the standard library only: the shuffle's
spawned workers load it and never import torch.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import threading
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np

from ray_shuffling_data_loader_tpu_torch._build import build_dir, compile_library

SOURCE = Path(__file__).resolve().parent / "kernels.cc"
CXX = "g++"
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread"]
ABI_VERSION = 5
ENV_THREADS = "RSDL_NATIVE_THREADS"
ENV_DISABLE = "RSDL_DISABLE_NATIVE"
KERNELS = ("take", "take_multi", "scatter", "narrow", "group_rows")

# One thread per this many rows at most, shared with kernels.cc's
# parallel_for: below it a thread's spawn costs about what its slice of a
# memory-bound loop saves.
_MIN_ROWS_PER_THREAD = 1 << 19


# -- threads ---------------------------------------------------------------------


def _threads_from_env() -> int:
    """``RSDL_NATIVE_THREADS`` when it parses (at least 1), else
    ``min(8, cores)``: gathers are memory-bound, and a few threads fill
    the memory bus."""
    env = os.environ.get(ENV_THREADS, "").strip()
    if env:
        try:
            return max(1, int(env))
        except ValueError:
            pass
    return max(1, min(8, os.cpu_count() or 1))


_NUM_THREADS = _threads_from_env()


def num_threads() -> int:
    """The process's default kernel thread count."""
    return _NUM_THREADS


def refresh_threads_from_env() -> None:
    """Read ``RSDL_NATIVE_THREADS`` again."""
    global _NUM_THREADS
    _NUM_THREADS = _threads_from_env()


def set_num_threads(n: Optional[int]) -> None:
    """Set the process's default kernel thread count (None: no change)."""
    global _NUM_THREADS
    if n is not None:
        _NUM_THREADS = max(1, int(n))


def _resolve_threads(n_threads: Optional[int]) -> int:
    return _NUM_THREADS if n_threads is None else max(1, int(n_threads))


# -- on or off, build and load ------------------------------------------------------

_ENABLED: Optional[bool] = None  # None: from the environment
_LIB: Optional[ctypes.CDLL] = None
_LIB_LOCK = threading.Lock()


def enabled() -> bool:
    """Do the wrappers run the kernels? Off when ``RSDL_DISABLE_NATIVE``
    is set (and not empty), unless :func:`set_enabled` decided."""
    if _ENABLED is not None:
        return _ENABLED
    return not os.environ.get(ENV_DISABLE)


def set_enabled(flag: Optional[bool]) -> None:
    """Decide for this process (None: follow ``RSDL_DISABLE_NATIVE``)."""
    global _ENABLED
    _ENABLED = None if flag is None else bool(flag)


def library_path(directory: Optional[Path] = None) -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return Path(directory or build_dir()) / f"librsdl_native-{digest.hexdigest()[:16]}.so"


def build(cxx: Optional[str] = None, directory: Optional[Path] = None) -> Path:
    """Build the library unless it is built already; returns its path.
    ``cxx`` and ``directory`` override the compiler (:data:`CXX`) and the
    build directory."""
    target = library_path(directory)
    if target.is_file():
        return target
    return compile_library([cxx or CXX, *CXX_FLAGS, str(SOURCE)], target, "g++")


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    i64, cint, p = ctypes.c_int64, ctypes.c_int, ctypes.c_void_p
    lib.rsdl_take.argtypes = [p, p, p, i64, i64, i64, cint]
    lib.rsdl_take.restype = cint
    lib.rsdl_take_multi.argtypes = [p, p, i64, p, p, i64, i64, cint]
    lib.rsdl_take_multi.restype = cint
    lib.rsdl_cast_i64_i32.argtypes = [p, p, i64, cint]
    lib.rsdl_cast_i64_i32.restype = None
    lib.rsdl_cast_i64_i32_checked.argtypes = [p, p, i64, cint]
    lib.rsdl_cast_i64_i32_checked.restype = cint
    lib.rsdl_cast_f64_f32.argtypes = [p, p, i64, cint]
    lib.rsdl_cast_f64_f32.restype = None
    lib.rsdl_scatter.argtypes = [p, p, p, i64, i64, i64, cint]
    lib.rsdl_scatter.restype = cint
    lib.rsdl_group_rows.argtypes = [p, p, p, i64, i64, p]
    lib.rsdl_group_rows.restype = None
    lib.rsdl_group_plan.argtypes = [p, i64, i64, cint, p, p]
    lib.rsdl_group_plan.restype = None
    lib.rsdl_group_rows_multi_mt.argtypes = [p, p, p, i64, p, i64, p, cint, i64]
    lib.rsdl_group_rows_multi_mt.restype = None
    lib.rsdl_abi_version.restype = cint
    return lib


def load() -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            lib = _declare(ctypes.CDLL(str(build())))
            if lib.rsdl_abi_version() != ABI_VERSION:
                raise RuntimeError(f"{library_path()}: ABI {lib.rsdl_abi_version()}, want {ABI_VERSION}")
            _LIB = lib
        return _LIB


def ensure_built() -> None:
    """Build and load the library now, unless the plain versions were
    chosen: the process that owns a worker pool calls it before the pool
    spawns, so that the workers only load it and a failed build raises
    there."""
    if enabled():
        load()


def _native() -> Optional[ctypes.CDLL]:
    if not enabled():
        return None
    return _LIB if _LIB is not None else load()


# -- counts ------------------------------------------------------------------------

_COUNTS = {"native": dict.fromkeys(KERNELS, 0), "plain": dict.fromkeys(KERNELS, 0)}
_COUNTS_LOCK = threading.Lock()


def _count(kernel: str, ran_native: bool) -> None:
    with _COUNTS_LOCK:
        _COUNTS["native" if ran_native else "plain"][kernel] += 1


def counts() -> Dict[str, Dict[str, int]]:
    """This process's calls so far: ``{"native": {kernel: n}, "plain":
    {kernel: n}}``."""
    with _COUNTS_LOCK:
        return {k: dict(v) for k, v in _COUNTS.items()}


def counts_since(before: Dict[str, Dict[str, int]]) -> Dict[str, Dict[str, int]]:
    """The calls made since the snapshot ``before`` (:func:`counts`)."""
    now = counts()
    return {k: {name: now[k][name] - before[k][name] for name in KERNELS} for k in now}


def reset_counts() -> None:
    with _COUNTS_LOCK:
        for v in _COUNTS.values():
            v.update(dict.fromkeys(KERNELS, 0))


# -- helpers -----------------------------------------------------------------------


# The wrappers run once per column of every map and reduce, on as few as a
# few thousand rows: their Python work is kept to plain attribute reads.


def _ptr(arr: np.ndarray) -> int:
    return arr.ctypes.data


def _rows_contig(arr: np.ndarray) -> Optional[int]:
    """Bytes per row (one index-0 slice) if ``arr`` is C-contiguous."""
    if not arr.flags.c_contiguous:
        return None
    return arr.dtype.itemsize * math.prod(arr.shape[1:])


def _check_bounds(idx: np.ndarray, n: int) -> bool:
    """True if ``idx`` is integer, non-empty and in ``[0, n)``; raises
    ``IndexError`` as numpy does when an index falls outside ``[-n, n)``.
    Negative and non-integer indices return False: numpy takes them."""
    if len(idx) == 0 or not _is_int(idx):
        return False
    lo, hi = int(idx.min()), int(idx.max())
    if hi >= n or lo < -n:
        raise IndexError(f"index out of bounds for axis 0 with size {n}: [{lo}, {hi}]")
    return lo >= 0


def _out_ok(out: Optional[np.ndarray], shape, dtype) -> bool:
    """False without ``out``; True when ``out`` can take the result; raises
    ``ValueError`` otherwise: a destination the result does not fit is a
    caller's fault, and writing a fresh array instead would leave a store
    segment untouched."""
    if out is None:
        return False
    if out.shape != tuple(shape) or out.dtype != dtype or not out.flags.c_contiguous or not out.flags.writeable:
        raise ValueError(
            f"out= mismatch: need {tuple(shape)} {dtype} C-contiguous writable, got {out.shape} {out.dtype} "
            f"(contig={out.flags.c_contiguous}, writable={out.flags.writeable})"
        )
    return True


def _is_int(idx: np.ndarray) -> bool:
    return idx.dtype.kind in "iu"


# -- take --------------------------------------------------------------------------


def take_plain(arr: np.ndarray, idx, out: Optional[np.ndarray] = None) -> np.ndarray:
    """The plain version of :func:`take`."""
    idx_arr = np.asarray(idx)
    if _out_ok(out, (len(idx_arr), *arr.shape[1:]), arr.dtype):
        np.take(arr, idx_arr, axis=0, out=out)
        return out
    return arr[idx]


def take(arr: np.ndarray, idx, out: Optional[np.ndarray] = None, n_threads: Optional[int] = None) -> np.ndarray:
    """``arr[idx]`` along axis 0, threaded (``rsdl_take``). ``out``: a
    destination to gather into (a writable store-segment view). The
    kernel checks bounds as it goes; on an index outside ``[0, n)`` the
    call re-derives numpy's answer: ``IndexError`` (``out`` zeroed
    again), or numpy's gather for negative indices."""
    idx_arr = np.asarray(idx)
    shape = (len(idx_arr), *arr.shape[1:])
    row_bytes = _rows_contig(arr)
    if len(idx_arr) == 0 or arr.size == 0 or row_bytes is None or not _is_int(idx_arr):
        if len(idx_arr) and arr.size:
            _count("take", False)
        return take_plain(arr, idx, out)
    lib = _native()
    if lib is None:
        _count("take", False)
        return take_plain(arr, idx, out)
    idx_c = np.ascontiguousarray(idx_arr, dtype=np.int64)
    if not _out_ok(out, shape, arr.dtype):
        out = np.empty(shape, dtype=arr.dtype)
    rc = lib.rsdl_take(_ptr(arr), _ptr(out), _ptr(idx_c), len(idx_c), row_bytes, len(arr),
                       _resolve_threads(n_threads))
    if rc == 0:
        _count("take", True)
        return out
    try:
        _check_bounds(idx_arr, len(arr))
    except IndexError:
        out[...] = 0  # the kernel may have written part of it
        raise
    _count("take", False)
    np.take(arr, idx_arr, axis=0, out=out)
    return out


# -- take_multi --------------------------------------------------------------------


def _take_multi_sparse(parts: Sequence[np.ndarray], idx: np.ndarray, out: Optional[np.ndarray]) -> np.ndarray:
    """A gather of few rows from many parts in numpy without the concat:
    ``idx`` split by part (one ``searchsorted`` over the part offsets),
    each part's rows put in place."""
    offsets = np.zeros(len(parts) + 1, dtype=np.int64)
    np.cumsum([len(p) for p in parts], out=offsets[1:])
    idx = idx.astype(np.int64, copy=False)
    shape = (len(idx), *parts[0].shape[1:])
    if not _out_ok(out, shape, parts[0].dtype):
        out = np.empty(shape, dtype=parts[0].dtype)
    part_id = np.searchsorted(offsets, idx, side="right") - 1
    local = idx - offsets[part_id]
    for p in range(len(parts)):
        sel = np.nonzero(part_id == p)[0]
        if len(sel):
            out[sel] = parts[p][local[sel]]
    return out


def take_multi_plain(parts: Sequence[np.ndarray], idx, out: Optional[np.ndarray] = None) -> np.ndarray:
    """The plain version of :func:`take_multi`: the sparse form when
    ``idx`` takes under half the rows of several parts of one dtype, else
    the concat and one gather."""
    if not parts:
        raise ValueError("need at least one part to concatenate")
    template = parts[0]
    parts = [p for p in parts if len(p)]
    if not parts:
        return template[idx]
    idx_arr = np.asarray(idx)
    total = sum(len(p) for p in parts)
    compat = all(p.dtype == parts[0].dtype and p.shape[1:] == parts[0].shape[1:] for p in parts)
    sparse = compat and len(parts) > 1 and 2 * len(idx_arr) < total
    in_bounds = _check_bounds(idx_arr, total)
    if sparse and in_bounds:
        return _take_multi_sparse(parts, idx_arr, out)
    base = parts[0] if len(parts) == 1 else np.concatenate(parts)
    return take_plain(base, idx, out)


def take_multi(parts: Sequence[np.ndarray], idx, out: Optional[np.ndarray] = None,
               n_threads: Optional[int] = None) -> np.ndarray:
    """``np.concatenate(parts)[idx]`` in one pass, without the concat
    (``rsdl_take_multi``): the reduce's gather over its partitions.
    ``out`` and the index rules as for :func:`take`. Parts of mixed
    dtypes or shapes take numpy's concat, which promotes."""
    if not parts:
        raise ValueError("need at least one part to concatenate")
    live = [p for p in parts if len(p)]
    idx_arr = np.asarray(idx)
    if not live or len(idx_arr) == 0:
        return take_multi_plain(parts, idx, out)
    row_bytes = _rows_contig(live[0])
    same = all(
        _rows_contig(p) == row_bytes and p.dtype == live[0].dtype and p.shape[1:] == live[0].shape[1:] for p in live
    )
    lib = _native() if row_bytes is not None and same and _is_int(idx_arr) else None
    if lib is None:
        _count("take_multi", False)
        return take_multi_plain(parts, idx, out)
    offsets = np.zeros(len(live) + 1, dtype=np.int64)
    np.cumsum([len(p) for p in live], out=offsets[1:])
    ptrs = (ctypes.c_void_p * len(live))(*[_ptr(p) for p in live])
    idx_c = np.ascontiguousarray(idx_arr, dtype=np.int64)
    shape = (len(idx_c), *live[0].shape[1:])
    if not _out_ok(out, shape, live[0].dtype):
        out = np.empty(shape, dtype=live[0].dtype)
    rc = lib.rsdl_take_multi(ptrs, _ptr(offsets), len(live), _ptr(out), _ptr(idx_c), len(idx_c), row_bytes,
                             _resolve_threads(n_threads))
    if rc == 0:
        _count("take_multi", True)
        return out
    try:
        _check_bounds(idx_arr, int(offsets[-1]))
    except IndexError:
        out[...] = 0
        raise
    _count("take_multi", False)
    np.take(np.concatenate(live), idx_arr, axis=0, out=out)
    return out


# -- scatter -----------------------------------------------------------------------


def scatter_plain(src: np.ndarray, idx, out: np.ndarray) -> np.ndarray:
    """The plain version of :func:`scatter`."""
    src, idx_arr = np.asarray(src), np.asarray(idx)
    if len(src) != len(idx_arr):
        raise ValueError(f"scatter length mismatch: {len(src)} rows vs {len(idx_arr)} indices")
    out[idx_arr] = src
    return out


def scatter(src: np.ndarray, idx, out: np.ndarray, n_threads: Optional[int] = None) -> np.ndarray:
    """``out[idx] = src`` along axis 0, threaded (``rsdl_scatter``), the
    inverse of :func:`take`. ``idx`` must not repeat a row (threads would
    race for it). Out-of-range indices raise ``IndexError`` as in numpy
    (rows already written keep their values); negative ones take numpy."""
    src, idx_arr = np.asarray(src), np.asarray(idx)
    if len(src) != len(idx_arr):
        raise ValueError(f"scatter length mismatch: {len(src)} rows vs {len(idx_arr)} indices")
    if src.size == 0:
        return scatter_plain(src, idx_arr, out)
    row_bytes = _rows_contig(src)
    fits = (
        row_bytes is not None and row_bytes == _rows_contig(out) and src.dtype == out.dtype
        and src.shape[1:] == out.shape[1:] and out.flags.writeable and _is_int(idx_arr)
    )
    lib = _native() if fits else None
    if lib is None:
        _count("scatter", False)
        return scatter_plain(src, idx_arr, out)
    idx_c = np.ascontiguousarray(idx_arr, dtype=np.int64)
    rc = lib.rsdl_scatter(_ptr(src), _ptr(out), _ptr(idx_c), len(idx_c), row_bytes, len(out),
                          _resolve_threads(n_threads))
    if rc == 0:
        _count("scatter", True)
        return out
    _check_bounds(idx_arr, len(out))
    _count("scatter", False)
    out[idx_arr] = src
    return out


# -- narrowing ---------------------------------------------------------------------

_I32 = np.iinfo(np.int32)


def narrow_i64_checked_plain(arr: np.ndarray) -> Optional[np.ndarray]:
    """The plain version of :func:`narrow_i64_checked` (three passes)."""
    if arr.size and (arr.max() > _I32.max or arr.min() < _I32.min):
        return None
    return arr.astype(np.int32)


def narrow_i64_checked(arr: np.ndarray, n_threads: Optional[int] = None) -> Optional[np.ndarray]:
    """``int64 -> int32`` with the range check in the same pass
    (``rsdl_cast_i64_i32_checked``): the int32 array, or None when a value
    falls outside int32's range."""
    if arr.dtype != np.int64:
        raise TypeError(f"narrow_i64_checked expects int64, got {arr.dtype}")
    if arr.size == 0:
        return arr.astype(np.int32)
    lib = _native() if arr.flags.c_contiguous else None
    if lib is None:
        _count("narrow", False)
        return narrow_i64_checked_plain(arr)
    out = np.empty(arr.shape, dtype=np.int32)
    ok = lib.rsdl_cast_i64_i32_checked(_ptr(arr), _ptr(out), arr.size, _resolve_threads(n_threads))
    _count("narrow", True)
    return out if ok else None


def narrow_plain(arr: np.ndarray, dtype) -> np.ndarray:
    """The plain version of :func:`narrow`."""
    dtype = np.dtype(dtype)
    return arr if arr.dtype == dtype else arr.astype(dtype)


def narrow(arr: np.ndarray, dtype, n_threads: Optional[int] = None) -> np.ndarray:
    """``arr.astype(dtype)``, unchecked, through the kernels for int64 ->
    int32 and float64 -> float32 (``rsdl_cast_i64_i32``,
    ``rsdl_cast_f64_f32``); ``arr`` itself when it has the dtype."""
    dtype = np.dtype(dtype)
    if arr.dtype == dtype:
        return arr
    if arr.size == 0:
        return arr.astype(dtype)
    fn = None
    if arr.flags.c_contiguous:
        if arr.dtype == np.int64 and dtype == np.int32:
            # rsdl-lint: disable=vocabulary-drift -- a C symbol of the built library, not a metric
            fn = "rsdl_cast_i64_i32"
        elif arr.dtype == np.float64 and dtype == np.float32:
            # rsdl-lint: disable=vocabulary-drift -- a C symbol of the built library, not a metric
            fn = "rsdl_cast_f64_f32"
    lib = _native() if fn is not None else None
    if lib is None:
        _count("narrow", False)
        return narrow_plain(arr, dtype)
    out = np.empty(arr.shape, dtype=dtype)
    getattr(lib, fn)(_ptr(arr), _ptr(out), arr.size, _resolve_threads(n_threads))
    _count("narrow", True)
    return out


# -- group-by ----------------------------------------------------------------------


def _group_offsets(assignment: np.ndarray, num_groups: int) -> np.ndarray:
    if len(assignment) and (int(assignment.min()) < 0 or int(assignment.max()) >= num_groups):
        raise ValueError(
            f"assignment values must be in [0, {num_groups}); got [{assignment.min()}, {assignment.max()}]"
        )
    offsets = np.zeros(num_groups + 1, dtype=np.int64)
    np.cumsum(np.bincount(assignment, minlength=num_groups), out=offsets[1:])
    return offsets


def _destination(out: Optional[dict], name: str) -> Optional[np.ndarray]:
    if out is None:
        return None
    if name not in out:
        raise KeyError(f"out= missing destination for column {name!r}")
    return out[name]


def group_order(assignment, num_groups: int):
    """``(order, offsets)`` of a stable group-by, in numpy: ``order`` lists
    row indices group by group, each group's rows in input order; group
    ``g`` owns ``order[offsets[g]:offsets[g + 1]]``. The index schedule's
    map, which groups indices only, and :func:`group_rows_multi_plain`."""
    assignment = np.asarray(assignment)
    offsets = _group_offsets(assignment, num_groups)
    # Narrow keys let numpy's stable sort take its radix path.
    key = np.uint8 if num_groups <= 256 else np.uint16 if num_groups <= 65536 else np.int64
    return np.argsort(assignment.astype(key), kind="stable"), offsets


def group_rows_multi_plain(columns: dict, assignment, num_groups: int, out: Optional[dict] = None):
    """The plain version of :func:`group_rows_multi`: one stable argsort
    of the assignment (:func:`group_order`), then one gather per column."""
    order, offsets = group_order(assignment, num_groups)
    result = {}
    for name, v in columns.items():
        dst = _destination(out, name)
        if _out_ok(dst, v.shape, v.dtype):
            np.take(v, order, axis=0, out=dst)
            result[name] = dst
        else:
            result[name] = v[order]
    return result, offsets


def group_rows_multi(columns: dict, assignment, num_groups: int, out: Optional[dict] = None,
                     n_threads: Optional[int] = None):
    """Stable group-by of equal-length columns by one ``assignment``:
    ``(grouped, offsets)``, group ``g`` at rows ``offsets[g]:offsets[g +
    1]`` of every column, in input order within a group. One counting
    scatter per column (``rsdl_group_rows``), or with two or more threads'
    worth of rows the two-pass parallel scatter (``rsdl_group_plan`` +
    ``rsdl_group_rows_multi_mt``: per-thread histograms, a (thread, group)
    prefix sum, then every column in one call), bit-identical to the
    serial one. ``out``: destinations per column (writable store-segment
    views), the map's only full pass over its data."""
    arrs = list(columns.values())
    assignment = np.asarray(assignment)
    if not arrs or arrs[0].size == 0:
        return group_rows_multi_plain(columns, assignment, num_groups, out)
    lib = _native() if all(_rows_contig(a) is not None for a in arrs) else None
    if lib is None:
        _count("group_rows", False)
        return group_rows_multi_plain(columns, assignment, num_groups, out)
    offsets = _group_offsets(assignment, num_groups)
    assignment = np.ascontiguousarray(assignment, dtype=np.int32)
    n = len(assignment)
    threads = min(_resolve_threads(n_threads), max(1, n // _MIN_ROWS_PER_THREAD))
    dsts = {}
    for name, arr in columns.items():
        dst = _destination(out, name)
        dsts[name] = dst if _out_ok(dst, arr.shape, arr.dtype) else np.empty_like(arr)
    if threads > 1:
        plan = np.empty(threads * num_groups, dtype=np.int64)
        starts = np.ascontiguousarray(offsets[:num_groups])
        lib.rsdl_group_plan(_ptr(assignment), n, num_groups, threads, _ptr(starts), _ptr(plan))
        names = list(columns)
        srcs = (ctypes.c_void_p * len(names))(*[_ptr(columns[k]) for k in names])
        dst_ptrs = (ctypes.c_void_p * len(names))(*[_ptr(dsts[k]) for k in names])
        itemsizes = np.array([_rows_contig(columns[k]) for k in names], dtype=np.int64)
        lib.rsdl_group_rows_multi_mt(srcs, dst_ptrs, _ptr(itemsizes), len(names), _ptr(assignment), n, _ptr(plan),
                                     threads, num_groups)
    else:
        for name, arr in columns.items():
            cursors = offsets[:num_groups].copy()  # the kernel advances them
            lib.rsdl_group_rows(_ptr(arr), _ptr(dsts[name]), _ptr(assignment), len(arr), _rows_contig(arr),
                                _ptr(cursors))
    _count("group_rows", True)
    return dsts, offsets


def group_rows(arr: np.ndarray, assignment, num_groups: int, n_threads: Optional[int] = None):
    """:func:`group_rows_multi` of one array: ``(grouped, offsets)``."""
    grouped, offsets = group_rows_multi({"": arr}, assignment, num_groups, n_threads=n_threads)
    return grouped[""], offsets


def native_available() -> bool:
    """Is the kernels' library loaded or loadable (and not switched off)?
    Builds it if needed; a failed build raises."""
    return _native() is not None
