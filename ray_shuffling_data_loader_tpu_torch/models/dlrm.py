"""The flagship model: a DLRM-style recommender over the ``DATA_SPEC``
columns.

* one embedding table per column, taken in ``sorted()`` column-name order
  (so ``embeddings_name10`` follows ``embeddings_name1``), ids folded into
  the table with ``% vocab``; a table may be sharded by rows over a model
  group (:func:`~..parallel.shard_model`);
* the ``[B, 19, D]`` stack and its pairwise dot interaction
  (:func:`~..ops.dot_interaction`, the CUDA kernel on the GPU);
* a top MLP over ``[stack, interaction]`` that computes in ``compute_dtype``
  (bfloat16 by default) with float32 parameters, and float32 logits.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ray_shuffling_data_loader_tpu_torch.ops import dot_interaction, num_pairs
from ray_shuffling_data_loader_tpu_torch.parallel.sharded_embedding import embed_columns
from ray_shuffling_data_loader_tpu_torch.utils.device import DeviceLike, resolve_device


class TabularDLRM(nn.Module):
    """DLRM over named categorical columns.

    Args:
        vocab_sizes: column name -> table rows.
        embed_dim: embedding width, shared by all tables.
        top_mlp: hidden widths of the top MLP (a width-1 logit layer
            follows).
        compute_dtype: dtype of the activations and matmuls.

    The initial weights come from a generator seeded with 0.
    """

    def __init__(
        self,
        vocab_sizes: Dict[str, int],
        embed_dim: int = 32,
        top_mlp: Sequence[int] = (256, 128, 64),
        compute_dtype: torch.dtype = torch.bfloat16,
    ):
        super().__init__()
        self.vocab_sizes = dict(vocab_sizes)
        self.columns = sorted(self.vocab_sizes)
        self.embed_dim = embed_dim
        self.compute_dtype = compute_dtype
        gen = torch.Generator().manual_seed(0)
        self.embeddings = nn.ModuleDict()
        for col in self.columns:
            table = nn.Embedding(self.vocab_sizes[col], embed_dim)
            nn.init.normal_(table.weight, std=1.0 / math.sqrt(embed_dim), generator=gen)
            self.embeddings[col] = table
        n = len(self.columns)
        widths = [n * embed_dim + num_pairs(n), *top_mlp, 1]
        self.mlp = nn.ModuleList()
        for fan_in, fan_out in zip(widths[:-1], widths[1:]):
            layer = nn.Linear(fan_in, fan_out)
            nn.init.normal_(layer.weight, std=1.0 / math.sqrt(fan_in), generator=gen)
            nn.init.zeros_(layer.bias)
            self.mlp.append(layer)

    def forward(self, features: Dict[str, torch.Tensor]) -> torch.Tensor:
        """``features``: column -> integer ``[B]`` ids. Returns float32
        ``[B]`` logits."""
        embeds = embed_columns(self.embeddings, self.columns, self.vocab_sizes, features)
        stacked = torch.stack([e.to(self.compute_dtype) for e in embeds], dim=1)  # [B, N, D]
        inter = dot_interaction(stacked)
        x = torch.cat([stacked.reshape(stacked.shape[0], -1), inter], dim=-1)
        cdt = self.compute_dtype
        for i, layer in enumerate(self.mlp):
            x = F.linear(x, layer.weight.to(cdt), layer.bias.to(cdt))
            if i < len(self.mlp) - 1:
                x = F.relu(x)
        return x.reshape(-1).float()


def dlrm_for_data_spec(
    embed_dim: int = 32,
    top_mlp: Sequence[int] = (256, 128, 64),
    vocab_cap: Optional[int] = None,
    compute_dtype: torch.dtype = torch.bfloat16,
    device: DeviceLike = None,
) -> TabularDLRM:
    """The flagship model for the ``DATA_SPEC`` cardinalities, on
    ``device`` (default ``cuda``); ``vocab_cap`` shrinks the tables for
    small runs."""
    from ray_shuffling_data_loader_tpu_torch.data_generation import (
        DATA_SPEC,
        LABEL_COLUMN,
    )

    vocab_sizes = {
        col: int(min(high, vocab_cap) if vocab_cap else high)
        for col, (low, high, dtype) in DATA_SPEC.items()
        if col != LABEL_COLUMN
    }
    return TabularDLRM(
        vocab_sizes,
        embed_dim=embed_dim,
        top_mlp=tuple(top_mlp),
        compute_dtype=compute_dtype,
    ).to(resolve_device(device))


def example_features(
    model: nn.Module, batch_size: int, seed: int = 0, device: DeviceLike = None
) -> Dict[str, torch.Tensor]:
    """A random batch of int32 ids matching the model's columns, built on
    the host and moved to ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    return {
        col: torch.from_numpy(rng.integers(0, size, batch_size, dtype=np.int32)).to(dev)
        for col, size in model.vocab_sizes.items()
    }
