"""Embedding tables split by rows over the model group.

A table of ``vocab`` rows sharded over ``M`` ranks keeps rows ``[m·V/M,
(m+1)·V/M)`` on model index ``m`` (:class:`ShardedEmbedding`). A lookup
gives each id's row where this rank owns it and zeros elsewhere; the
partial results of every sharded table of a model are then summed over
the model group in one all-reduce. That is the masked gather and
all-reduce XLA emits for a gather whose operand is sharded by rows. Each
element of the sum has exactly one nonzero term, so it is exact in any
dtype, and the result equals the unsharded lookup bit for bit.

The sum's backward is the identity (:class:`_ModelGroupSum`): everything
after it is computed alike on every model peer, so each peer already holds
the whole gradient of the summed rows, and its shard's gradient is that
gradient at the rows it owns. (``torch.distributed.nn``'s all-reduce
reduces again in its backward, which would scale the shards' gradients by
``M``.)

Model peers reduce their gradients over different data groups, so a
replicated parameter stays the same on all of them only if each peer
computes its gradient to the same bits. ``F.embedding``'s backward on
CUDA does not: it sums the rows of an id repeated a few hundred times (a
table of up to a few hundred rows at batch 65,536) in an order that
changes from call to call. In a sharded model the replicated tables
therefore take their gradient from :class:`_FixedOrderLookup`.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ray_shuffling_data_loader_tpu_torch.parallel.mesh import Mesh


def shard_rows(table: torch.Tensor, model_index: int, model_size: int) -> torch.Tensor:
    """A copy of model index ``model_index``'s rows of ``table``: ``[m·V/M,
    (m+1)·V/M)`` of its ``V`` rows."""
    rows = table.shape[0] // model_size
    return table[model_index * rows : (model_index + 1) * rows].clone()


class ShardedEmbedding(nn.Module):
    """This rank's rows of a ``vocab × dim`` table: ``weight`` holds rows
    ``[offset, offset + vocab / M)``, ``offset = model_index · vocab / M``.
    Its ``state_dict`` key is ``weight``, as ``nn.Embedding``'s."""

    def __init__(self, shard: torch.Tensor, vocab: int, mesh: Mesh):
        super().__init__()
        rows = vocab // mesh.model_size
        if vocab % mesh.model_size or shard.shape[0] != rows:
            raise ValueError(f"a shard of {vocab} rows over {mesh.model_size} ranks has {rows} rows, "
                             f"got {shard.shape[0]}")
        self.weight = nn.Parameter(shard)
        self.vocab = vocab
        self.offset = mesh.model_index * rows
        self.mesh = mesh

    def partial(self, idx: torch.Tensor) -> torch.Tensor:
        """``[B, dim]``: the rows of the ids ``idx`` (already in ``[0,
        vocab)``) that this rank owns, zeros for the others."""
        local = idx - self.offset
        owned = (local >= 0) & (local < self.weight.shape[0])
        rows = F.embedding(torch.where(owned, local, 0), self.weight)
        return torch.where(owned[:, None], rows, 0.0)


class _FixedOrderLookup(torch.autograd.Function):
    """``F.embedding`` whose weight gradient is summed in the same order on
    every call: the backward runs under
    ``torch.use_deterministic_algorithms``."""

    @staticmethod
    def forward(ctx, idx: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(idx)
        ctx.rows = weight.shape[0]
        return F.embedding(idx, weight)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        (idx,) = ctx.saved_tensors
        mode = torch.are_deterministic_algorithms_enabled()
        warn_only = torch.is_deterministic_algorithms_warn_only_enabled()
        torch.use_deterministic_algorithms(True)
        try:
            grad_weight = torch.ops.aten.embedding_dense_backward(grad, idx, ctx.rows, -1, False)
        finally:
            torch.use_deterministic_algorithms(mode, warn_only=warn_only)
        return None, grad_weight


class _ModelGroupSum(torch.autograd.Function):
    """All-reduce (sum) over ``group`` forward, identity backward."""

    @staticmethod
    def forward(ctx, partial: torch.Tensor, group) -> torch.Tensor:
        total = partial.clone()
        dist.all_reduce(total, group=group)
        return total

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return grad, None


def embed_columns(
    tables: Mapping[str, nn.Module],
    columns: Sequence[str],
    vocab_sizes: Mapping[str, int],
    features: Dict[str, torch.Tensor],
) -> List[torch.Tensor]:
    """Each column's ``[B, dim]`` rows, in ``columns`` order, in the tables'
    dtype: ids folded into the table with ``% vocab``, looked up in an
    ``nn.Embedding`` directly, or in a :class:`ShardedEmbedding` as its
    partial result, all of which are summed over the model group in one
    collective. Where any table is sharded, the others are looked up
    through :class:`_FixedOrderLookup`."""
    rows: Dict[str, torch.Tensor] = {}
    partial: Dict[str, torch.Tensor] = {}
    sharded = any(isinstance(tables[col], ShardedEmbedding) for col in columns)
    for col in columns:
        idx = (features[col].reshape(-1) % vocab_sizes[col]).long()
        table = tables[col]
        if isinstance(table, ShardedEmbedding):
            partial[col] = table.partial(idx)
        elif sharded:
            rows[col] = _FixedOrderLookup.apply(idx, table.weight)
        else:
            rows[col] = F.embedding(idx, table.weight)
    if partial:
        group = tables[next(iter(partial))].mesh.model_group
        summed = _ModelGroupSum.apply(torch.stack(list(partial.values()), dim=1), group)
        rows.update((col, summed[:, i]) for i, col in enumerate(partial))
    return [rows[col] for col in columns]


def sharded_tables(model: nn.Module) -> Dict[str, ShardedEmbedding]:
    """The model's sharded tables by module name (e.g.
    ``embeddings.embeddings_name12``), in module order: the same on every
    rank of a mesh."""
    return {name: mod for name, mod in model.named_modules() if isinstance(mod, ShardedEmbedding)}


def model_mesh(model: nn.Module) -> Optional[Mesh]:
    """The mesh the model's tables are sharded over, or None."""
    return next((t.mesh for t in sharded_tables(model).values()), None)
