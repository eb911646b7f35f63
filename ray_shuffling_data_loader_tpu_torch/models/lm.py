"""The long-context model family: a causal transformer LM over int32
token ids, ``tokens [batch, seq] -> logits [batch, seq, vocab]``.

Token and position embeddings are added in float32 before the cast to
``compute_dtype``; the blocks are the TabTransformer's
:class:`~.transformer.EncoderBlock` with causal flash attention (the CUDA
kernels on the GPU) or a causal ``attention_fn`` (ring or Ulysses
attention over a sequence-parallel group, :mod:`~..ops.ring_attention`);
the readout is tied to the token embedding and taken in float32.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ray_shuffling_data_loader_tpu_torch.models.transformer import EncoderBlock, LayerNorm
from ray_shuffling_data_loader_tpu_torch.utils.device import DeviceLike, resolve_device


class CausalLM(nn.Module):
    """Next-token transformer, built on ``device`` (default ``cuda``). The
    initial weights come from a generator seeded with 0. ``attention_fn(q,
    k, v) -> out`` must mask causally (None: causal flash attention)."""

    def __init__(
        self,
        vocab_size: int,
        max_seq_len: int,
        embed_dim: int = 64,
        num_layers: int = 2,
        num_heads: int = 4,
        compute_dtype: torch.dtype = torch.bfloat16,
        device: DeviceLike = None,
        attention_fn: Optional[Callable] = None,
    ):
        super().__init__()
        dev = resolve_device(device)
        self.vocab_size = vocab_size
        self.max_seq_len = max_seq_len
        self.compute_dtype = compute_dtype
        gen = torch.Generator().manual_seed(0)
        self.token_embed = nn.Parameter(torch.empty(vocab_size, embed_dim).normal_(std=0.02, generator=gen))
        self.pos_embed = nn.Parameter(torch.empty(max_seq_len, embed_dim).normal_(std=0.02, generator=gen))
        self.blocks = nn.ModuleList(
            EncoderBlock(embed_dim, num_heads, causal=True, generator=gen, attention_fn=attention_fn)
            for _ in range(num_layers)
        )
        self.ln_out = LayerNorm(embed_dim)
        self.to(dev)

    def forward(self, tokens: torch.Tensor, start: int = 0) -> torch.Tensor:
        """``tokens [batch, t] -> logits [batch, t, vocab]``. ``start`` is the
        global position of ``tokens[:, 0]``: a rank of a sequence-parallel
        group holds the chunk that starts there."""
        t = tokens.shape[1]
        x = F.embedding((tokens % self.vocab_size).long(), self.token_embed)
        x = (x + self.pos_embed[None, start:start + t]).to(self.compute_dtype)
        for block in self.blocks:
            x = block(x)
        x = self.ln_out(x)
        # Weight-tied readout in float32.
        return torch.einsum("btd,vd->btv", x.float(), self.token_embed)


def next_token_loss(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy of predicting token ``t+1`` from position ``t``;
    targets fold into the vocab as the model's inputs do (``% vocab``)."""
    logp = F.log_softmax(logits[:, :-1], dim=-1)
    targets = (tokens[:, 1:] % logits.shape[-1]).long()
    return -logp.gather(-1, targets[..., None]).mean()


def synthetic_tokens(
    batch: int, seq_len: int, vocab: int, seed: int = 0
) -> np.ndarray:
    """Learnable synthetic stream: a periodic pattern with per-sample
    phase plus light noise — next-token loss genuinely falls."""
    rng = np.random.default_rng(seed)
    period = min(vocab, 17)
    phase = rng.integers(0, period, (batch, 1))
    base = (np.arange(seq_len)[None, :] + phase) % period
    noise = rng.integers(0, vocab, (batch, seq_len))
    use_noise = rng.random((batch, seq_len)) < 0.05
    return np.where(use_noise, noise, base).astype(np.int32)
