"""BCD loss (counterpart of ``change3d_tpu/train/losses.py:bce_dice_loss``),
computed in fp32. The SCD/BDA/CC losses arrive with their slices."""

from __future__ import annotations

import torch

_EPS = 1e-5


def bce_dice_loss(probs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """BCE + (1 - Dice) on sigmoid outputs, probabilities clipped to
    [1e-7, 1 - 1e-7]. probs: [B,H,W,1] in (0,1); targets: same shape {0,1}."""
    p = torch.clamp(probs.float(), 1e-7, 1.0 - 1e-7)
    t = targets.float()
    bce = -torch.mean(t * torch.log(p) + (1.0 - t) * torch.log(1.0 - p))
    inter = torch.sum(p * t)
    dice = (2.0 * inter + _EPS) / (torch.sum(p) + torch.sum(t) + _EPS)
    return bce + 1.0 - dice
