"""Collectives over a ``torch.distributed`` group, staged through pinned
host memory where the backend needs it.

gloo's point-to-point calls take host tensors only, and ranks that share
one CUDA device must use gloo (NCCL refuses two ranks on one device). So
on a gloo group every call here copies CUDA tensors into cached pinned
host buffers, runs the collective on those, and copies the result back;
on NCCL, and for CPU tensors, the tensors go to the collective as they
are.

* :func:`p2p`: one batch of sends and receives (the Adasum butterfly, the
  ring's K/V rotation);
* :func:`all_reduce_`: an in-place sum (gloo reduces CUDA tensors
  itself);
* :func:`all_to_all`: the tiled all-to-all of Ulysses sequence
  parallelism, differentiable (its backward is the inverse all-to-all);
* :func:`all_gather`: a concatenation along one dim of every rank's
  tensor, differentiable (its backward is a reduce-scatter: the sum over
  the group of the gradient's chunks, in group-rank order);
* :func:`all_to_all_uneven`: rows of different counts to each rank, the
  counts exchanged first (the pod's resident loader hands each data index
  its rows of an epoch or of a batch with it);
* :func:`all_gather_ints`, :func:`broadcast_int`: a few integers of
  control (digests, votes, a decision) over the group.

``group=None`` stands for a group of this rank alone (no communication),
never for the world. :func:`comm_seconds` reads the host seconds spent in
these calls since :func:`reset_comm_seconds`; with CUDA tensors each call
first waits for the device, so the clock holds the collective alone.
"""

from __future__ import annotations

import math
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

_PINNED: Dict[tuple, torch.Tensor] = {}
_CLOCK = {"seconds": 0.0}


def comm_seconds() -> float:
    """Host seconds spent in this module's collectives since the last
    :func:`reset_comm_seconds`."""
    return _CLOCK["seconds"]


def reset_comm_seconds() -> None:
    _CLOCK["seconds"] = 0.0


class _timed:
    """Adds the seconds of its block to the module's clock; waits for the
    device first when ``like`` is a CUDA tensor."""

    def __init__(self, like: torch.Tensor):
        self.cuda = like.is_cuda

    def __enter__(self):
        if self.cuda:
            torch.cuda.synchronize()
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        _CLOCK["seconds"] += time.perf_counter() - self.t0


def group_size_rank(group) -> Tuple[int, int]:
    """``(size, rank)`` of ``group``; ``(1, 0)`` for None (this rank alone)."""
    if group is None:
        return 1, 0
    return dist.get_world_size(group), dist.get_rank(group)


def host_buffer(like: torch.Tensor, slot: str) -> torch.Tensor:
    """A cached pinned host buffer with ``like``'s shape and dtype (one per
    slot, element count and dtype)."""
    key = (slot, like.numel(), like.dtype)
    buf = _PINNED.get(key)
    if buf is None:
        buf = _PINNED[key] = torch.empty(like.numel(), dtype=like.dtype, pin_memory=True)
    return buf.view(like.shape)


def _staged(group, like: torch.Tensor) -> bool:
    return dist.get_backend(group) == "gloo" and like.is_cuda


def _pinned_prefix(slot: str, numel: int, dtype: torch.dtype) -> torch.Tensor:
    """The first ``numel`` elements of a cached pinned host buffer (one per
    slot and dtype, grown to the largest request): collectives whose sizes
    change from call to call reuse one buffer instead of caching one per
    size."""
    key = (slot, dtype)
    buf = _PINNED.get(key)
    if buf is None or buf.numel() < numel:
        buf = _PINNED[key] = torch.empty(max(1, numel), dtype=dtype, pin_memory=True)
    return buf[:numel]


def _control_device(group) -> torch.device:
    """Where a small control tensor travels: this process's current CUDA
    device under NCCL, the host under gloo."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def p2p(buffers: List[torch.Tensor], group, send_to: Optional[int], recv_from: Optional[int]):
    """Send ``buffers`` to group rank ``send_to`` and/or receive the same
    shapes from ``recv_from``, as one batch of point-to-point operations;
    returns the received list (or None)."""
    staged = _staged(group, buffers[0])
    ops, received = [], []
    with _timed(buffers[0]):
        for i, buf in enumerate(buffers):
            if send_to is not None:
                src = host_buffer(buf, f"send{i}").copy_(buf) if staged else buf.contiguous()
                ops.append(dist.P2POp(dist.isend, src, dist.get_global_rank(group, send_to), group))
            if recv_from is not None:
                dst = (host_buffer(buf, f"recv{i}") if staged
                       else torch.empty(buf.shape, dtype=buf.dtype, device=buf.device))
                ops.append(dist.P2POp(dist.irecv, dst, dist.get_global_rank(group, recv_from), group))
                received.append(dst)
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        if recv_from is None:
            return None
        return [r.to(b.device) for r, b in zip(received, buffers)] if staged else received


def all_reduce_(tensor: torch.Tensor, group) -> torch.Tensor:
    """Sum ``tensor`` over ``group`` in place (gloo reduces CUDA tensors
    itself) and return it."""
    if group is not None:
        with _timed(tensor):
            dist.all_reduce(tensor, group=group)
    return tensor


def _all_to_all(x: torch.Tensor, group, split_dim: int, concat_dim: int) -> torch.Tensor:
    """Tiled all-to-all: ``x`` splits into ``p`` equal chunks along
    ``split_dim``, chunk ``j`` goes to group rank ``j``, and the chunks
    received are concatenated along ``concat_dim`` in group-rank order."""
    p, _ = group_size_rank(group)
    if p == 1:
        return x
    if x.shape[split_dim] % p:
        raise ValueError(f"all_to_all: dim {split_dim} of {tuple(x.shape)} does not split into {p} chunks")
    send = torch.stack(x.chunk(p, split_dim))
    with _timed(x):
        if _staged(group, x):
            host_send = host_buffer(send, "a2a_send").copy_(send)
            host_recv = host_buffer(send, "a2a_recv")
            dist.all_to_all_single(host_recv, host_send, group=group)
            recv = host_recv.to(x.device)
        else:
            recv = torch.empty_like(send)
            dist.all_to_all_single(recv, send, group=group)
    return torch.cat(recv.unbind(0), dim=concat_dim)


def _all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in group-rank order."""
    p, _ = group_size_rank(group)
    if p == 1:
        return x
    x = x.contiguous()
    with _timed(x):
        if _staged(group, x):
            parts = [host_buffer(x, f"gather{j}") for j in range(p)]
            dist.all_gather(parts, host_buffer(x, "gather_send").copy_(x), group=group)
            parts = [part.to(x.device) for part in parts]
        else:
            parts = [torch.empty_like(x) for _ in range(p)]
            dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def all_to_all_uneven(x: torch.Tensor, send_counts: Sequence[int], group) -> Tuple[torch.Tensor, List[int]]:
    """Uneven all-to-all along dim 0: the first ``send_counts[0]`` rows of
    ``x`` go to group rank 0, the next ``send_counts[1]`` to rank 1, and so
    on. The counts go first, in an all-to-all of their own, so that each
    rank learns what it receives. Returns ``(received, recv_counts)``: the
    rows received, concatenated in group-rank order, and how many came from
    each rank. ``x`` keeps its other dims and its dtype."""
    p, _ = group_size_rank(group)
    if len(send_counts) != p or sum(send_counts) != x.shape[0]:
        raise ValueError(f"all_to_all_uneven: send counts {list(send_counts)} for {x.shape[0]} rows over {p} ranks")
    if p == 1:
        return x, [x.shape[0]]
    x = x.contiguous()
    row = math.prod(x.shape[1:])
    with _timed(x):
        counts = torch.tensor(list(send_counts), dtype=torch.int64, device=_control_device(group))
        got = torch.empty_like(counts)
        dist.all_to_all_single(got, counts, group=group)
        recv_counts = got.tolist()
        shape = (sum(recv_counts), *x.shape[1:])
        if _staged(group, x):
            send = _pinned_prefix("a2av_send", x.numel(), x.dtype).view(x.shape).copy_(x)
            recv = _pinned_prefix("a2av_recv", shape[0] * row, x.dtype).view(shape)
            dist.all_to_all_single(recv, send, recv_counts, list(send_counts), group=group)
            recv = recv.to(x.device)
        else:
            recv = torch.empty(shape, dtype=x.dtype, device=x.device)
            dist.all_to_all_single(recv, x, recv_counts, list(send_counts), group=group)
    return recv, recv_counts


def all_gather_ints(values: Sequence[int], group) -> List[List[int]]:
    """Every rank's ``values`` (int64s, one length on every rank), in
    group-rank order."""
    x = torch.tensor(list(values), dtype=torch.int64, device=_control_device(group))
    p, _ = group_size_rank(group)
    if p == 1:
        return [x.tolist()]
    parts = [torch.empty_like(x) for _ in range(p)]
    dist.all_gather(parts, x, group=group)
    return [part.tolist() for part in parts]


def broadcast_int(value: int, group, src: int = 0) -> int:
    """Group rank ``src``'s ``value`` on every rank of ``group``."""
    if group is None:
        return int(value)
    x = torch.tensor([int(value)], dtype=torch.int64, device=_control_device(group))
    dist.broadcast(x, dist.get_global_rank(group, src), group=group)
    return int(x.item())


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_dim: int, concat_dim: int):
        ctx.group, ctx.split_dim, ctx.concat_dim = group, split_dim, concat_dim
        return _all_to_all(x, group, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, grad):
        return _all_to_all(grad, ctx.group, ctx.concat_dim, ctx.split_dim), None, None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim: int):
        ctx.group, ctx.dim = group, dim
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, grad):
        # Reduce-scatter: chunk j of every rank's gradient goes to rank j,
        # which sums what it receives in group-rank order.
        p, _ = group_size_rank(ctx.group)
        if p == 1:
            return grad, None, None
        received = _all_to_all(grad, ctx.group, ctx.dim, 0)
        parts = received.chunk(p, 0)
        total = parts[0].clone()
        for part in parts[1:]:
            total += part
        return total, None, None


def all_to_all(x: torch.Tensor, group, split_dim: int, concat_dim: int) -> torch.Tensor:
    """Differentiable tiled all-to-all (as ``lax.all_to_all(...,
    tiled=True)``): ``x`` splits into ``p`` chunks along ``split_dim``,
    chunk ``j`` goes to group rank ``j``, and the received chunks are
    concatenated along ``concat_dim`` in group-rank order. The backward is
    the inverse all-to-all. Raises ``ValueError`` when ``split_dim`` does
    not divide by the group's size."""
    return _AllToAll.apply(x, group, split_dim, concat_dim)


def all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Differentiable all-gather: every rank's ``x`` (one shape) concatenated
    along ``dim`` in group-rank order. The backward is a reduce-scatter."""
    return _AllGather.apply(x, group, dim)
