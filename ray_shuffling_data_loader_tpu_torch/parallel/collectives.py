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
  the group of the gradient's chunks, in group-rank order).

``group=None`` stands for a group of this rank alone (no communication),
never for the world. :func:`comm_seconds` reads the host seconds spent in
these calls since :func:`reset_comm_seconds`; with CUDA tensors each call
first waits for the device, so the clock holds the collective alone.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

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
