"""Train steps: BCE on the float label, Adam; on one device or
data-parallel over a ``torch.distributed`` group.

``torch.optim.Adam`` with betas (0.9, 0.999) and eps 1e-8 makes the same
update as ``optax.adam``: ``lr * m̂ / (sqrt(v̂) + eps)`` with bias-corrected
moments.

The gradient plane has two forms, as in the JAX package:

* :func:`make_train_step` with a group wraps the model in
  ``DistributedDataParallel``, whose bucketed all-reduce overlaps the
  backward pass (the counterpart of the jitted step on a data-only mesh);
* :func:`make_psum_train_step` reduces explicitly after ``backward()``:
  the mean (an all-reduce sum over the world size) or Adasum
  (:func:`adasum_reduce`), optionally in a narrower dtype on the wire.

Over a ``(data, model)`` mesh (:func:`~.mesh.make_mesh`),
:func:`shard_model` cuts the tall embedding tables to this rank's rows
(the counterpart of the JAX package's sharded ``init_state``) and
:func:`make_train_step` reduces over the mesh's data group.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ray_shuffling_data_loader_tpu_torch.parallel.collectives import p2p
from ray_shuffling_data_loader_tpu_torch.parallel.mesh import DEFAULT_VOCAB_SHARD_THRESHOLD, Mesh
from ray_shuffling_data_loader_tpu_torch.parallel.sharded_embedding import ShardedEmbedding, model_mesh, shard_rows

Step = Callable[..., Dict[str, torch.Tensor]]


def bce_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean sigmoid binary cross-entropy with soft targets."""
    labels = labels.to(logits.dtype)
    return -torch.mean(
        labels * F.logsigmoid(logits) + (1.0 - labels) * F.logsigmoid(-logits)
    )


def make_optimizer(model: nn.Module, lr: float = 1e-3, capturable: bool = False) -> torch.optim.Optimizer:
    """Adam as ``optax.adam``. ``capturable``: keep the step count on the
    device, so that a CUDA graph can capture the update (the fused epoch
    of :func:`~..resident.make_fused_epoch` needs it).

    On the CPU the update runs in Adam's fused kernel. The per-tensor
    update takes its square root from MKL's vector math, whose bits depend
    on the code path MKL picks in each process, and whose first call in a
    process can come out inexact while other threads start running ATen
    ops: data-parallel ranks then end with different parameters. The
    fused kernel rounds each operation exactly on any host."""
    fused = True if _device_of(model).type == "cpu" else None
    return torch.optim.Adam(
        model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8, capturable=capturable, fused=fused
    )


def _device_of(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def shard_model(
    model: nn.Module,
    mesh: Mesh,
    vocab_shard_threshold: Optional[int] = None,
    device: Optional[torch.device] = None,
) -> nn.Module:
    """Replace each embedding table that the JAX package's rule selects
    (:func:`~..convert.sharded_names`: at least ``vocab_shard_threshold``
    rows, default 16,384, divisible by the model size) by this rank's
    :class:`~.sharded_embedding.ShardedEmbedding` of it, then move the
    model to ``device``. Build the model on the host: its full tables then
    never reach the device, and only the shards (and, once the optimizer
    is made, their moments) live there. A rule that selects anything but
    a table raises ``NotImplementedError``. Returns the model."""
    from ray_shuffling_data_loader_tpu_torch.convert import sharded_names

    threshold = DEFAULT_VOCAB_SHARD_THRESHOLD if vocab_shard_threshold is None else vocab_shard_threshold
    shapes = [(name, p.shape) for name, p in model.named_parameters()]
    for name in sharded_names(shapes, mesh.model_size, threshold):
        parent, col, _ = name.split(".")
        tables = model.get_submodule(parent)
        weight = tables[col].weight.detach()
        tables[col] = ShardedEmbedding(shard_rows(weight, mesh.model_index, mesh.model_size), weight.shape[0], mesh)
    return model if device is None else model.to(device)


def make_train_step(model: nn.Module, optimizer: torch.optim.Optimizer, group=None) -> Step:
    """``step(features, labels, ranks_active=None, idle=False) -> {"loss"}``:
    one forward, backward and optimizer update. The loss comes back as a
    detached device tensor, so the step does not wait for the device.

    With ``group``, the model is wrapped in ``DistributedDataParallel``
    over it: rank 0's weights are broadcast at construction, and every
    rank applies the same mean gradient. The loss is the global batch's,
    as the explicit step's and the JAX package's data-parallel step's: the
    ranks' losses (0 from an idle rank) all-reduced over the group and
    divided by ``ranks_active``, the same on every rank.
    Ranks whose shards differ in length keep stepping together until the
    last one runs out (see :func:`ranks_with_batch`): ``ranks_active`` is
    how many ranks bring a batch to this step, and a rank whose shard has
    run out passes ``idle=True`` with a batch it already trained. Its loss
    is weighted 0, so it adds nothing to the gradient but takes part in
    DDP's all-reduce and makes the same update; the others weight theirs
    by ``world / ranks_active``, so the gradient is the mean over the
    ranks that brought a batch.

    A model sharded by :func:`shard_model` takes its mesh's data group (the
    ranks that hold the same rows): any other group raises ``ValueError``,
    since it would average different shards together.

    The step carries its ``model``, ``optimizer`` and ``group`` as
    attributes."""
    net: nn.Module = model
    world = 1
    mesh = model_mesh(model)
    if mesh is not None and group is not mesh.data_group:
        raise ValueError("a model with sharded tables reduces its gradients over its mesh's data group; "
                         "pass group=mesh.data_group")
    if group is not None:
        device = _device_of(model)
        net = nn.parallel.DistributedDataParallel(
            model,
            device_ids=[device] if device.type == "cuda" else None,
            process_group=group,
        )
        world = dist.get_world_size(group)

    def step(
        features: Dict[str, torch.Tensor], labels: torch.Tensor, ranks_active: Optional[int] = None, idle: bool = False
    ) -> Dict[str, torch.Tensor]:
        active = world if ranks_active is None else ranks_active
        optimizer.zero_grad(set_to_none=True)
        loss = bce_loss(net(features), labels)
        weight = 0.0 if idle else world / active
        (loss if weight == 1.0 else loss * weight).backward()
        optimizer.step()
        if group is None:
            return {"loss": loss.detach()}
        total = torch.zeros_like(loss) if idle else loss.detach().clone()
        dist.all_reduce(total, group=group)
        return {"loss": total.div_(active)}

    step.model, step.optimizer, step.group = model, optimizer, group
    return step


def broadcast_parameters(model: nn.Module, group, src: int = 0) -> None:
    """Give every rank rank ``src``'s parameters and buffers."""
    with torch.no_grad():
        for tensor in model.state_dict().values():
            dist.broadcast(tensor, src, group=group)


def ranks_with_batch(has_batch: bool, group, device: torch.device) -> int:
    """How many ranks of ``group`` still have a batch for this step. Ranks
    step together while it is above 0, so their collectives stay matched
    and no delivered batch goes untrained. ``device`` is where the count
    travels (``cuda`` for NCCL)."""
    count = torch.tensor([1 if has_batch else 0], dtype=torch.int32, device=device)
    dist.all_reduce(count, group=group)
    return int(count.item())


# -- the explicit gradient plane ----------------------------------------------


def _flatten(tensors: Sequence[torch.Tensor], dtype: Optional[torch.dtype]) -> List[torch.Tensor]:
    """One flat buffer per dtype (``dtype`` casts them all to one), in
    first-seen order: one collective per buffer instead of one per
    tensor."""
    groups: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        groups.setdefault(dtype or t.dtype, []).append(t)
    return [torch.cat([t.reshape(-1).to(dt) for t in ts]) for dt, ts in groups.items()]


def _unflatten_into(buffers: Sequence[torch.Tensor], tensors: Sequence[torch.Tensor], dtype) -> None:
    """Copy the flat ``buffers`` back into ``tensors`` (in their dtypes)."""
    offsets: Dict[torch.dtype, int] = {}
    by_dtype = {buf.dtype: buf for buf in buffers}
    for t in tensors:
        dt = dtype or t.dtype
        at = offsets.get(dt, 0)
        t.copy_(by_dtype[dt][at : at + t.numel()].view_as(t))
        offsets[dt] = at + t.numel()


def _tree_dot(a: Sequence[torch.Tensor], b: Sequence[torch.Tensor]) -> torch.Tensor:
    """fp32 inner product of two gradient lists, summed over all of them."""
    return sum(torch.dot(x.float(), y.float()) for x, y in zip(a, b))


def _adasum_coefficients(a: Sequence[torch.Tensor], b: Sequence[torch.Tensor]) -> torch.Tensor:
    """``[ca, cb]`` of the symmetric Adasum operator (Maleki et al., 2020):

        adasum(a, b) = (1 - a.b / 2|a|^2) a + (1 - a.b / 2|b|^2) b = ca a + cb b

    Orthogonal gradients add; equal ones return themselves. The dot
    products run in fp32 over the whole lists."""
    dot, na, nb = _tree_dot(a, b), _tree_dot(a, a), _tree_dot(b, b)
    zero = torch.zeros((), dtype=torch.float32, device=dot.device)
    ca = 1.0 - torch.where(na > 0, dot / (2.0 * na), zero)
    cb = 1.0 - torch.where(nb > 0, dot / (2.0 * nb), zero)
    return torch.stack([ca, cb])


def _adasum_apply(a: Sequence[torch.Tensor], b: Sequence[torch.Tensor], coeffs: torch.Tensor) -> List[torch.Tensor]:
    """``ca a + cb b`` in fp32, each tensor back in its dtype. The two
    scalings are separate multiplications (no fused multiply-add favours
    one side) and the sum commutes, so a partner holding ``(b, a)`` and
    the coefficients swapped computes the same bits."""
    ca, cb = coeffs[0], coeffs[1]
    return [(x.float() * ca + y.float() * cb).to(x.dtype) for x, y in zip(a, b)]


def adasum_reduce(grads: List[torch.Tensor], group) -> List[torch.Tensor]:
    """All-reduce the gradient list ``grads`` (flat buffers, typically one
    per dtype) across ``group`` with Adasum; every rank gets the same
    result.

    A butterfly: ``log2(p)`` rounds in which rank ``i`` exchanges with
    ``i ^ 2^r`` and both apply the Adasum operator
    (:func:`_adasum_coefficients`), over the largest
    power of two ``p`` not above the world size ``n``. With ``n`` not a
    power of two, each rank ``p + j`` first folds its gradients into rank
    ``j`` (one combine there), sits out the butterfly, and receives the
    result at the end. Adasum is not associative, so this grouping is part
    of the operator: the same as the JAX package's ``adasum_reduce``."""
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    pow2 = 1 << (n.bit_length() - 1)
    rem = n - pow2
    if me >= pow2:  # the remainder: fold in, then wait for the result
        p2p(grads, group, send_to=me - pow2, recv_from=None)
        return p2p(grads, group, send_to=None, recv_from=me - pow2)
    if me < rem:
        other = p2p(grads, group, send_to=None, recv_from=pow2 + me)
        grads = _adasum_apply(grads, other, _adasum_coefficients(grads, other))
    for r in range(pow2.bit_length() - 1):
        partner = me ^ (1 << r)
        other = p2p(grads, group, send_to=partner, recv_from=partner)
        # Two processes may round the same dot products differently (a CPU
        # BLAS picks its thread count at run time), and then the ranks
        # would diverge: the lower rank's coefficients serve both.
        if me < partner:
            coeffs = _adasum_coefficients(grads, other)
            p2p([coeffs], group, send_to=partner, recv_from=None)
        else:
            slot = torch.empty(2, dtype=torch.float32, device=grads[0].device)
            coeffs = p2p([slot], group, send_to=None, recv_from=partner)[0].flip(0)
        grads = _adasum_apply(grads, other, coeffs)
    if me < rem:
        p2p(grads, group, send_to=pow2 + me, recv_from=None)
    return grads


def _gathered_sum(buf: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group`` of a narrow (e.g. bf16) buffer, rounded to its
    dtype once: every rank's buffer is gathered as it is, so the wire
    carries the narrow dtype, and summed in fp32 in rank order. A ring
    all-reduce in the narrow dtype would round at every hop, in an order
    that differs from chunk to chunk; this is the sum JAX's ``pmean``
    rounds."""
    parts = [torch.empty_like(buf) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, buf, group=group)
    total = parts[0].float()
    for part in parts[1:]:
        total += part
    return total.to(buf.dtype)


def make_psum_train_step(
    model: nn.Module,
    optimizer: torch.optim.Optimizer,
    group,
    grad_dtype: Optional[torch.dtype] = None,
    grad_reduce: str = "mean",
) -> Step:
    """``step(features, labels, ranks_active=None, idle=False) -> {"loss"}``
    with the gradients reduced explicitly over ``group`` after
    ``backward()``.

    ``grad_reduce``: ``"mean"`` (an all-reduce sum divided by the number
    of ranks that brought a batch) or ``"adasum"`` (:func:`adasum_reduce`).
    The gradients are first flattened into one buffer per dtype.
    ``grad_dtype`` (e.g. ``torch.bfloat16``) is the dtype on the wire only:
    the gradients are cast down before the collective and back after, and
    the parameters keep their dtype. The mean then gathers the narrow
    buffers and sums them in fp32 (:func:`_gathered_sum`), rounding once. The loss returned is the mean over the
    ranks that brought a batch. Rank 0's weights are broadcast when the
    step is made.

    ``ranks_active`` and ``idle`` are as in :func:`make_train_step`: an idle
    rank's gradients are zeros, which the mean does not count and Adasum
    leaves out exactly (``adasum(g, 0) == g``). The step carries its
    ``model``, ``optimizer``, ``group``, ``grad_reduce`` and ``grad_dtype``
    as attributes."""
    if grad_reduce not in ("mean", "adasum"):
        raise ValueError(f"grad_reduce must be 'mean' or 'adasum', got {grad_reduce!r}")
    if group is None:
        raise ValueError("make_psum_train_step needs a process group; see init_data_parallel")
    if model_mesh(model) is not None:
        raise ValueError("make_psum_train_step requires replicated parameters; a model with sharded tables "
                         "trains with make_train_step")
    world = dist.get_world_size(group)
    broadcast_parameters(model, group)
    params = [p for p in model.parameters() if p.requires_grad]

    def step(
        features: Dict[str, torch.Tensor], labels: torch.Tensor, ranks_active: Optional[int] = None, idle: bool = False
    ) -> Dict[str, torch.Tensor]:
        active = world if ranks_active is None else ranks_active
        optimizer.zero_grad(set_to_none=True)
        loss = bce_loss(model(features), labels)
        (loss * 0.0 if idle else loss).backward()
        grads = [p.grad for p in params]
        buffers = _flatten(grads, grad_dtype)
        if grad_reduce == "adasum":
            buffers = adasum_reduce(buffers, group)
        elif grad_dtype is None:
            for buf in buffers:
                dist.all_reduce(buf, group=group)
                buf.div_(active)
        else:
            buffers = [_gathered_sum(buf, group).div_(active) for buf in buffers]
        _unflatten_into(buffers, grads, grad_dtype)
        mean_loss = torch.zeros_like(loss) if idle else loss.detach().clone()
        dist.all_reduce(mean_loss, group=group)
        optimizer.step()
        return {"loss": mean_loss.div_(active)}

    step.model, step.optimizer, step.group = model, optimizer, group
    step.grad_reduce, step.grad_dtype = grad_reduce, grad_dtype
    return step
