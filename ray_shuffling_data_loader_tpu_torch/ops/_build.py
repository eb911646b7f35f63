"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library
with a plain C interface, in the directory of :func:`.._build.build_dir`.
A library's file name carries a hash of its source, the shared headers and
the flags, so a build happens only when one of them changes. A missing
``nvcc``, a failed build or a failed load raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import threading
from pathlib import Path
from typing import Dict

from ray_shuffling_data_loader_tpu_torch._build import build_dir, compile_library

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = build_dir()
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
    # Registers, shared memory and spills of each kernel, kept in the log.
    "-Xptxas", "-v",
]

_LOCK = threading.Lock()
_LOADED: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for candidate in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if candidate and os.path.isfile(candidate):
            return candidate
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    if not src.is_file():
        raise FileNotFoundError(f"no kernel source {src}")
    digest = hashlib.sha256()
    for path in [src, *sorted(CSRC.glob("*.cuh"))]:
        digest.update(path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build_log(name: str) -> str:
    """The compiler's output of the last build of ``name`` ("" if none)."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.is_file() else ""


def build(name: str) -> Path:
    """Build kernel ``name`` unless it is built already. Returns its
    library path."""
    target = library_path(name)
    if target.is_file():
        return target
    return compile_library([nvcc_path(), *NVCC_FLAGS, str(CSRC / f"{name}.cu")], target, "nvcc")


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            path = build(name)
            lib = ctypes.CDLL(str(path))
            _LOADED[name] = lib
        return lib
