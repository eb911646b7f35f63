"""The ranks' process groups: the port's ``(data, model)`` mesh.

Each trainer rank is one process. :func:`init_data_parallel` joins the
ranks into one ``torch.distributed`` world. The backend is always the
caller's choice: ``"nccl"`` with one CUDA device per rank, ``"gloo"``
where ranks share a device (NCCL refuses two ranks on one device; gloo
carries CUDA tensors through host memory) or run on the CPU.

:func:`make_mesh` lays the world out as the JAX package's ``(data,
model)`` grid: rank ``r`` is data index ``r // M`` and model index
``r % M``. Gradients are reduced over the ``data`` group (the ranks that
hold the same rows of every table); the tall embedding tables that
:func:`param_spec` selects are split by rows over the ``model`` group (the
ranks that see the same batch). :func:`make_sp_mesh` lays it out as the
``(data, sp)`` grid of sequence parallelism the same way.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"
BACKENDS = ("nccl", "gloo")

# Embedding tables at least this tall get their vocab dim sharded over
# MODEL_AXIS; everything smaller replicates.
DEFAULT_VOCAB_SHARD_THRESHOLD = 16_384


def init_data_parallel(rank: int, world_size: int, backend: str, init_method: str):
    """Join rank ``rank`` of ``world_size`` into the world and return it
    (the default group).

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


@dataclass(frozen=True)
class Mesh:
    """One rank's place in the ``(data, model)`` grid and its two groups.

    ``data_group`` holds the ranks of model index ``model_index`` (the
    world when ``model_size`` is 1); ``model_group`` the ranks of data
    index ``data_index`` (None when ``model_size`` is 1)."""

    data_index: int
    model_index: int
    data_size: int
    model_size: int
    data_group: Any
    model_group: Optional[Any]

    @property
    def is_lead(self) -> bool:
        """The first rank of its model group: the one that reads the batch."""
        return self.model_index == 0


def _grid(inner: int, world: Optional[int], what: str) -> Tuple[int, int, int, int, Any, Optional[Any]]:
    """Rank ``r``'s place in a ``(outer, inner)`` grid of the initialised
    world, ``r = outer_index * inner + inner_index``, and its two groups:
    ``(outer_index, inner_index, outer_size, inner_size, outer_group,
    inner_group)``. The outer group holds the ranks of this inner index,
    the inner group those of this outer index. Every rank makes every
    group, in the same order, as ``dist.new_group`` requires; with
    ``inner`` 1 the outer group is the world and no group is made.
    ``what`` names ``inner`` in the error raised when it does not divide
    the world."""
    if world is None:
        world = dist.get_world_size()
    if inner < 1 or world % inner != 0:
        raise ValueError(f"{what}={inner} does not divide world size {world}")
    i_size, o_size = inner, world // inner
    o, i = divmod(dist.get_rank(), i_size)
    if i_size == 1:
        return o, 0, o_size, 1, dist.group.WORLD, None
    outer_group = inner_group = None
    for j in range(i_size):  # ranks with inner index j
        group = dist.new_group([n * i_size + j for n in range(o_size)])
        if j == i:
            outer_group = group
    for n in range(o_size):  # ranks with outer index n
        group = dist.new_group([n * i_size + j for j in range(i_size)])
        if n == o:
            inner_group = group
    return o, i, o_size, i_size, outer_group, inner_group


def make_mesh(model_parallelism: int = 1, world: Optional[int] = None) -> Mesh:
    """This rank's :class:`Mesh` over the initialised world of ``world``
    ranks (default: its size).

    ``model_parallelism`` must divide the world; the data axis takes the
    rest. Every rank makes every group, in the same order, as
    ``dist.new_group`` requires. ``model_parallelism=1`` is pure data
    parallelism over the world and makes no group."""
    return Mesh(*_grid(model_parallelism, world, "model_parallelism"))


@dataclass(frozen=True)
class SequenceMesh:
    """One rank's place in the ``(data, sp)`` grid of sequence parallelism:
    the batch splits over the data axis, the sequence over the ``sp`` axis.
    ``sp_group`` holds the ranks of data index ``data_index``, which hold
    one batch shard's sequence chunks in sp order (None when ``sp_size``
    is 1: the rank alone)."""

    data_index: int
    sp_index: int
    data_size: int
    sp_size: int
    sp_group: Optional[Any]


def make_sp_mesh(sp: int, world: Optional[int] = None) -> SequenceMesh:
    """This rank's :class:`SequenceMesh` over the initialised world: rank
    ``r`` is data index ``r // sp`` and sp index ``r % sp``, as the JAX
    package's ``devices.reshape(dp, sp)``. ``sp`` must divide the world."""
    d, s, d_size, s_size, _, sp_group = _grid(sp, world, "sp")
    return SequenceMesh(d, s, d_size, s_size, sp_group)


def param_spec(
    shape: Tuple[int, ...],
    model_size: int,
    vocab_shard_threshold: int = DEFAULT_VOCAB_SHARD_THRESHOLD,
) -> Tuple[Optional[str], ...]:
    """The JAX package's sharding rule for one parameter of ``shape`` (in
    the JAX package's layout), as a partition spec: ``(MODEL_AXIS, None)``
    for a 2-D array whose leading (vocab) dimension is at least
    ``vocab_shard_threshold`` and divisible by ``model_size`` > 1, else
    ``()`` (replicated)."""
    if (
        len(shape) == 2
        and shape[0] >= vocab_shard_threshold
        and shape[0] % model_size == 0
        and model_size > 1
    ):
        return (MODEL_AXIS, None)
    return ()
