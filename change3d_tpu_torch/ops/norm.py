"""Eval-mode batch norm (counterpart of ``change3d_tpu/ops/norm.py``).

Only running statistics are used; batch statistics and their torch-momentum
update arrive with the training slice, so ``train()`` mode raises.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn


class BatchNorm(nn.Module):
    """Channel-last BN over all leading axes. Parameters ``scale``/``bias``,
    buffers ``mean``/``var`` (the JAX variable names)."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("mean", torch.zeros(num_features))
        self.register_buffer("var", torch.ones(num_features))

    def folded(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """fp32 per-channel (a, b) with y = x * a + b."""
        a = self.scale.float() * torch.rsqrt(self.var.float() + self.eps)
        return a, self.bias.float() - self.mean.float() * a

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise NotImplementedError(
                "BatchNorm batch statistics arrive with the BCD train-step slice; call .eval()"
            )
        # a/b are folded in fp32, then applied in the activation dtype.
        a, b = self.folded()
        return x * a.to(x.dtype) + b.to(x.dtype)
