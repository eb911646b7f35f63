"""Where the port's compiled libraries go, and how one is built.

The CUDA kernels (:mod:`.ops._build`, ``nvcc``) and the host kernels
(:mod:`.native`, ``g++``) both build at first use into one directory: in a
checkout, ``build/kernels/`` at its root; in an installed package,
``$XDG_CACHE_HOME`` (default ``~/.cache``)
``/ray_shuffling_data_loader_tpu_torch/kernels``. A library's file name
carries a hash of its sources and flags, so a build happens only when one
of them changes, and it is published by an atomic rename, so processes
that build at once never load a half-written file.

This module imports the standard library only: the shuffle's spawned
workers load it through :mod:`.native` and never import torch.
"""

from __future__ import annotations

import os
import subprocess
from pathlib import Path
from typing import Sequence


def build_dir() -> Path:
    root = Path(__file__).resolve().parents[1]
    if (root / "pyproject.toml").is_file():
        return root / "build" / "kernels"
    cache = os.environ.get("XDG_CACHE_HOME") or os.path.join(Path.home(), ".cache")
    return Path(cache) / "ray_shuffling_data_loader_tpu_torch" / "kernels"


def compile_library(cmd: Sequence[str], target: Path, tool: str) -> Path:
    """Run ``cmd`` with ``-o`` a temporary file beside ``target``, keep the
    compiler's output in ``target`` with the suffix ``.log``, and rename
    the result to ``target``. A compiler that cannot be started or that
    fails raises ``RuntimeError`` naming ``tool`` and its output."""
    target.parent.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    try:
        proc = subprocess.run([*cmd, "-o", str(tmp)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    except OSError as exc:
        raise RuntimeError(f"{tool} build of {target.name} failed: cannot run {cmd[0]!r}: {exc}") from exc
    target.with_suffix(".log").write_text(proc.stdout)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{tool} build of {target.name} failed: {tool} exited {proc.returncode}\n{proc.stdout}")
    os.replace(tmp, target)
    return target
