"""torch Adam with coupled L2 decay (counterpart of
``change3d_tpu/train/optim.py:torch_adam``): the decay is added to the
gradient before the moments, betas (0.9, 0.99), eps 1e-8 outside the square
root — exactly ``torch.optim.Adam(weight_decay=...)``. The learning rate is
set from the schedule before each step (``set_lr``). The CC-only
``per_subtree_lr`` and ``freeze_subtree`` arrive with the CC slice."""

from __future__ import annotations

from typing import Iterable

import torch


def torch_adam(params: Iterable[torch.nn.Parameter], *, lr: float = 0.0, b1: float = 0.9,
               b2: float = 0.99, eps: float = 1e-8, weight_decay: float = 0.0) -> torch.optim.Adam:
    return torch.optim.Adam(params, lr=lr, betas=(b1, b2), eps=eps, weight_decay=weight_decay)


def set_lr(opt: torch.optim.Optimizer, lr: float) -> None:
    for group in opt.param_groups:
        group["lr"] = lr
