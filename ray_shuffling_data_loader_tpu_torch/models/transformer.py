"""Second model family: a transformer encoder over one token per
``DATA_SPEC`` column (TabTransformer-style), with the DLRM's contract:
features of integer ``[B]`` ids in, float32 ``[B]`` logits out, so it drops
into :func:`~..parallel.make_train_step` and every loader unchanged.

* one embedding table per column, in ``sorted()`` column-name order, ids
  folded in with ``% vocab``; a learned per-column embedding is added in
  float32 before the cast to ``compute_dtype``;
* ``num_layers`` pre-norm :class:`EncoderBlock` s whose attention is
  :func:`~..ops.flash_attention_qkv` (the CUDA kernels on the GPU), or
  the pluggable ``attention_fn(q, k, v) -> out`` over ``[batch, seq,
  heads, head_dim]`` (e.g. :func:`~..ops.make_ring_attention`'s);
* a final LayerNorm, a mean over the tokens and a width-1 ``head``.

The numerics follow flax's defaults, which the JAX package's model uses:
LayerNorm with epsilon 1e-6 and float32 statistics (variance as
``E[x²] − E[x]²``), the tanh form of GELU, and dense layers that cast
input, weight and bias to the compute dtype.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ray_shuffling_data_loader_tpu_torch.ops import flash_attention_qkv
from ray_shuffling_data_loader_tpu_torch.parallel.sharded_embedding import embed_columns
from ray_shuffling_data_loader_tpu_torch.utils.device import DeviceLike, resolve_device

LN_EPS = 1e-6  # flax's LayerNorm epsilon
MLP_RATIO = 4  # the MLP's hidden width over the token width


class LayerNorm(nn.Module):
    """LayerNorm over the last dim as flax computes it: statistics in
    float32, ``(x − mean) · rsqrt(var + LN_EPS) · weight + bias``, then a
    cast back to the input's dtype."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        mean = x32.mean(dim=-1, keepdim=True)
        var = ((x32 * x32).mean(dim=-1, keepdim=True) - mean * mean).clamp_min(0.0)
        y = (x32 - mean) * (torch.rsqrt(var + LN_EPS) * self.weight) + self.bias
        return y.to(x.dtype)


def dense(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``layer`` applied in ``dtype``: input, weight and bias cast first."""
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


def init_linear(layer: nn.Linear, gen: torch.Generator) -> nn.Linear:
    """Normal weights of std 1/sqrt(fan_in), zero bias."""
    nn.init.normal_(layer.weight, std=1.0 / math.sqrt(layer.in_features), generator=gen)
    nn.init.zeros_(layer.bias)
    return layer


class EncoderBlock(nn.Module):
    """Pre-norm transformer block over ``[batch, seq, dim]``, computing in
    the dtype of its input. ``causal`` masks attention to earlier tokens;
    ``generator`` draws the initial weights. ``attention_fn(q, k, v) ->
    out`` over ``[batch, seq, heads, head_dim]`` replaces the packed flash
    attention (and must mask causally itself where it should)."""

    def __init__(
        self,
        embed_dim: int,
        num_heads: int,
        causal: bool,
        generator: torch.Generator,
        attention_fn: Optional[Callable] = None,
    ):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} not divisible by num_heads {num_heads}")
        self.num_heads = num_heads
        self.causal = causal
        self.attention_fn = attention_fn
        self.ln_attn = LayerNorm(embed_dim)
        self.qkv = init_linear(nn.Linear(embed_dim, 3 * embed_dim), generator)
        self.proj = init_linear(nn.Linear(embed_dim, embed_dim), generator)
        self.ln_mlp = LayerNorm(embed_dim)
        self.mlp_up = init_linear(nn.Linear(embed_dim, MLP_RATIO * embed_dim), generator)
        self.mlp_down = init_linear(nn.Linear(MLP_RATIO * embed_dim, embed_dim), generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, d = x.shape
        cdt = x.dtype
        h = self.ln_attn(x)
        qkv = dense(self.qkv, h, cdt).reshape(b, t, 3, self.num_heads, d // self.num_heads)
        if self.attention_fn is None:
            attn = flash_attention_qkv(qkv, self.causal)
        else:
            attn = self.attention_fn(*qkv.unbind(2))
        x = x + dense(self.proj, attn.reshape(b, t, d), cdt)
        h = self.ln_mlp(x)
        h = F.gelu(dense(self.mlp_up, h, cdt), approximate="tanh")
        return x + dense(self.mlp_down, h, cdt)


class TabTransformer(nn.Module):
    """Transformer encoder over one token per categorical column.

    Args:
        vocab_sizes: column name -> table rows.
        embed_dim: token width.
        num_layers, num_heads: the encoder's shape.
        compute_dtype: dtype of the activations and matmuls.
        attention_fn: the blocks' attention (None: flash attention).

    The initial weights come from a generator seeded with 0.
    """

    def __init__(
        self,
        vocab_sizes: Dict[str, int],
        embed_dim: int = 32,
        num_layers: int = 2,
        num_heads: int = 4,
        compute_dtype: torch.dtype = torch.bfloat16,
        attention_fn: Optional[Callable] = None,
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
        self.col_embed = nn.Parameter(
            torch.empty(len(self.columns), embed_dim).normal_(std=0.02, generator=gen)
        )
        self.blocks = nn.ModuleList(
            EncoderBlock(embed_dim, num_heads, causal=False, generator=gen, attention_fn=attention_fn)
            for _ in range(num_layers)
        )
        self.ln_out = LayerNorm(embed_dim)
        self.head = init_linear(nn.Linear(embed_dim, 1), gen)

    def forward(self, features: Dict[str, torch.Tensor]) -> torch.Tensor:
        """``features``: column -> integer ``[B]`` ids. Returns float32
        ``[B]`` logits."""
        tokens = embed_columns(self.embeddings, self.columns, self.vocab_sizes, features)
        x = (torch.stack(tokens, dim=1) + self.col_embed[None]).to(self.compute_dtype)
        for block in self.blocks:
            x = block(x)
        pooled = self.ln_out(x).mean(dim=1)
        return dense(self.head, pooled, self.compute_dtype).reshape(-1).float()


def transformer_for_data_spec(
    embed_dim: int = 32,
    num_layers: int = 2,
    num_heads: int = 4,
    vocab_cap: Optional[int] = None,
    compute_dtype: torch.dtype = torch.bfloat16,
    device: DeviceLike = None,
    attention_fn: Optional[Callable] = None,
) -> TabTransformer:
    """The TabTransformer for the ``DATA_SPEC`` cardinalities, on ``device``
    (default ``cuda``); ``vocab_cap`` shrinks the tables for small runs;
    ``attention_fn`` as for :class:`TabTransformer`."""
    from ray_shuffling_data_loader_tpu_torch.data_generation import (
        DATA_SPEC,
        LABEL_COLUMN,
    )

    vocab_sizes = {
        col: int(min(high, vocab_cap) if vocab_cap else high)
        for col, (low, high, dtype) in DATA_SPEC.items()
        if col != LABEL_COLUMN
    }
    return TabTransformer(
        vocab_sizes,
        embed_dim=embed_dim,
        num_layers=num_layers,
        num_heads=num_heads,
        compute_dtype=compute_dtype,
        attention_fn=attention_fn,
    ).to(resolve_device(device))
