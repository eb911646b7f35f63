"""Device selection for the port's entry points.

Every entry point runs on the GPU unless its caller names another device.
There is no silent fallback: with no usable CUDA device the default raises,
and the CPU is reached only by asking for it (``device="cpu"``), as the
tests do.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``cuda``; a CUDA device with no GPU present raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU explicitly"
        )
    return dev
