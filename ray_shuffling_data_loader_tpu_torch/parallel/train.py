"""The single-device train step: BCE on the float label, Adam.

``torch.optim.Adam`` with betas (0.9, 0.999) and eps 1e-8 makes the same
update as ``optax.adam``: ``lr * m̂ / (sqrt(v̂) + eps)`` with bias-corrected
moments.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn.functional as F
from torch import nn


def bce_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean sigmoid binary cross-entropy with soft targets."""
    labels = labels.to(logits.dtype)
    return -torch.mean(
        labels * F.logsigmoid(logits) + (1.0 - labels) * F.logsigmoid(-logits)
    )


def make_optimizer(model: nn.Module, lr: float = 1e-3) -> torch.optim.Optimizer:
    return torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)


def make_train_step(
    model: nn.Module, optimizer: torch.optim.Optimizer
) -> Callable[[Dict[str, torch.Tensor], torch.Tensor], Dict[str, torch.Tensor]]:
    """``step(features, labels) -> {"loss"}``: one forward, backward and
    optimizer update. The loss comes back as a detached device tensor, so
    the step does not wait for the device."""

    def step(features: Dict[str, torch.Tensor], labels: torch.Tensor) -> Dict[str, torch.Tensor]:
        optimizer.zero_grad(set_to_none=True)
        loss = bce_loss(model(features), labels)
        loss.backward()
        optimizer.step()
        return {"loss": loss.detach()}

    return step
