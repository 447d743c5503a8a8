"""BCD train and eval steps (counterpart of ``change3d_tpu/train/engine.py``).

``train_step`` runs the forward in ``train()`` mode (batch-statistics BN,
every block on plain ops, as JAX trains), the BCEDice loss in fp32,
backward and the torch-Adam step at ``schedule(step)``. ``eval_step`` runs
the model in ``eval()`` mode under ``torch.no_grad()``, so the fused CUDA
blocks carry the backbone on the card. Both return the loss and the 2x2
confusion matrix as device tensors: nothing syncs with the host per step.

With ``compute_dtype`` the images enter the model in that dtype; the
parameters stay fp32 and each op casts them to the activation dtype, BN
statistics stay fp32.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from change3d_tpu_torch.metrics.confusion import confusion_matrix
from change3d_tpu_torch.train.losses import bce_dice_loss
from change3d_tpu_torch.train.optim import set_lr


def _valid_gt(batch: Dict[str, torch.Tensor], gt: torch.Tensor) -> torch.Tensor:
    """gt -> -1 on padded samples (``valid`` false), which the confusion
    matrix ignores."""
    valid = batch.get("valid")
    if valid is None:
        return gt
    shape = (gt.shape[0],) + (1,) * (gt.dim() - 1)
    return torch.where(valid.reshape(shape), gt, -1)


def _forward(model, batch, compute_dtype):
    pre, post = batch["pre"], batch["post"]
    if compute_dtype is not None:
        pre, post = pre.to(compute_dtype), post.to(compute_dtype)
    return model(pre, post)


def _bcd_loss_metrics(outputs, batch):
    probs = outputs["change"]
    loss = bce_dice_loss(probs, batch["label"].float())
    with torch.no_grad():
        pred = (probs > 0.5).long()
        cm = confusion_matrix(_valid_gt(batch, batch["label"]), pred, 2)
    return loss, cm


def train_step(model: torch.nn.Module, opt: torch.optim.Optimizer,
               schedule: Callable[[int], float], batch: Dict[str, torch.Tensor], step: int, *,
               compute_dtype: Optional[torch.dtype] = None) -> Dict[str, torch.Tensor]:
    """One optimizer step at learning rate ``schedule(step)``; ``step`` is
    the number of steps already taken. Returns {'loss', 'cm'} on the device."""
    model.train()
    set_lr(opt, schedule(step))
    opt.zero_grad(set_to_none=True)
    loss, cm = _bcd_loss_metrics(_forward(model, batch, compute_dtype), batch)
    loss.backward()
    opt.step()
    return {"loss": loss.detach(), "cm": cm}


@torch.no_grad()
def eval_step(model: torch.nn.Module, batch: Dict[str, torch.Tensor], *,
              compute_dtype: Optional[torch.dtype] = None) -> Dict[str, torch.Tensor]:
    """Eval-mode forward; padded samples are masked out of the confusion
    matrix (the loss averages over the whole batch, as in JAX)."""
    model.eval()
    loss, cm = _bcd_loss_metrics(_forward(model, batch, compute_dtype), batch)
    return {"loss": loss, "cm": cm}
