"""The data-parallel process group: the port's ``data`` mesh axis.

Each trainer rank is one process. :func:`init_data_parallel` joins the
ranks into one ``torch.distributed`` group over which the gradients are
reduced. The backend is always the caller's choice: ``"nccl"`` with one
CUDA device per rank, ``"gloo"`` where ranks share a device (NCCL refuses
two ranks on one device; gloo carries CUDA tensors through host memory)
or run on the CPU.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

DATA_AXIS = "data"
BACKENDS = ("nccl", "gloo")


def init_data_parallel(rank: int, world_size: int, backend: str, init_method: str):
    """Join rank ``rank`` of ``world_size`` into the data-parallel group
    and return it (the default group).

    ``init_method`` is the rendezvous, e.g. ``tcp://localhost:<port>``.
    With ``"nccl"`` the ranks must not outnumber the host's CUDA devices:
    a run that would put two ranks on one device raises ``ValueError``
    before any process group is made.
    """
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    devices = torch.cuda.device_count()
    if backend == "nccl" and world_size > devices:
        raise ValueError(
            f"backend 'nccl' needs one CUDA device per rank, but {world_size} ranks "
            f"share {devices} device(s) on this host; pass backend='gloo' for "
            "ranks that share a device"
        )
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world_size)
    return dist.group.WORLD
