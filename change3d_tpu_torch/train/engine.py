"""Train and eval steps (counterpart of ``change3d_tpu/train/engine.py``)
for BCD, SCD, BDA and CC.

``train_step`` runs the forward in ``train()`` mode (batch-statistics BN,
every block on plain ops, as JAX trains), the task's loss in fp32,
backward and the torch-Adam step at ``schedule(step)``. ``eval_step`` runs
the model in ``eval()`` mode under ``torch.no_grad()``, so the fused CUDA
blocks carry the backbone on the card. Both return the loss and the task's
metrics as device tensors, so nothing syncs with the host per step:

  BCD: {'cm'}                              2x2 [gt, pred]
  SCD: {'cm', 'acc_correct', 'acc_total'}  KxK [pred, label] over pre and post
  BDA: {'loc_cm', 'cls_cm'}                2x2 and KxK [gt, pred]
  CC:  {'top1'}                            teacher-forced token accuracy, %

The losses are JAX's: BCD BCEDice; SCD 0.5 (CE_pre + CE_post) + BCEDice
(change) + change similarity, CE ignoring class 0 over changed pixels;
BDA CE(loc * cls, ignore 0) + BCEDice(loc); CC the teacher-forced caption CE
(padding ignored). CC's caption decoder draws its train-mode dropout from
the ``generator`` passed to ``train_step``.

With ``compute_dtype`` the images enter the model in that dtype; the
parameters stay fp32 and each op casts them to the activation dtype, BN
statistics stay fp32.

Under a process group of more than one process each process holds its slice
of the global batch and both steps are the global batch's, as JAX's step
over a sharded batch is: BN statistics and the losses are summed over the
processes (``ops/norm.py``, ``train/losses.py``), so every process
backpropagates the same global loss; the gradients are then averaged over
the processes in flat all-reduces of at most ``GRAD_BUCKET_BYTES`` (each
process's gradient is the world size times its share, see
``all_reduce_sum``), so parameters and Adam state stay equal on every
process. The count metrics (confusion matrices, SCD's accuracy counts) are
summed over the processes; CC's top-1 is global already.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Tuple, Union

import torch

from change3d_tpu_torch.metrics.confusion import confusion_matrix
from change3d_tpu_torch.models.trainer import Task
from change3d_tpu_torch.parallel import distributed
from change3d_tpu_torch.train.losses import (
    bce_dice_loss,
    caption_cross_entropy,
    caption_top_k_accuracy,
    change_similarity_loss,
    cross_entropy_2d,
)
from change3d_tpu_torch.train.optim import set_lr

Metrics = Dict[str, torch.Tensor]

GRAD_BUCKET_BYTES = 32 << 20
# Metrics that are counts over the batch: summed over the processes.
_COUNT_METRICS = ("cm", "acc_correct", "acc_total", "loc_cm", "cls_cm")


def _valid_gt(batch: Dict[str, torch.Tensor], gt: torch.Tensor) -> torch.Tensor:
    """gt -> -1 on padded samples (``valid`` false), which the confusion
    matrix ignores in its first argument."""
    valid = batch.get("valid")
    if valid is None:
        return gt
    shape = (gt.shape[0],) + (1,) * (gt.dim() - 1)
    return torch.where(valid.reshape(shape), gt, -1)


def _forward(model, batch, compute_dtype, generator=None):
    pre, post = batch["pre"], batch["post"]
    if compute_dtype is not None:
        pre, post = pre.to(compute_dtype), post.to(compute_dtype)
    if model.task == Task.CC:
        return model(pre, post, batch["caption"], generator=generator)
    return model(pre, post)


def _bcd_loss_metrics(outputs, batch) -> Tuple[torch.Tensor, Metrics]:
    probs = outputs["change"]
    loss = bce_dice_loss(probs, batch["label"].float())
    with torch.no_grad():
        pred = (probs > 0.5).long()
        cm = confusion_matrix(_valid_gt(batch, batch["label"]), pred, 2)
    return loss, {"cm": cm}


def _scd_loss_metrics(outputs, batch) -> Tuple[torch.Tensor, Metrics]:
    label = batch["label"].long()  # [B,H,W,3]: (label1, label2, change)
    change = label[..., 2]
    pre_label, post_label = label[..., 0] * change, label[..., 1] * change
    seg = (cross_entropy_2d(outputs["pre"], pre_label, ignore_index=0)
           + cross_entropy_2d(outputs["post"], post_label, ignore_index=0))
    binary = bce_dice_loss(outputs["change"], change[..., None].float())
    sim = change_similarity_loss(outputs["pre"][..., 1:], outputs["post"][..., 1:], change)
    loss = 0.5 * seg + binary + sim
    with torch.no_grad():
        k = outputs["pre"].shape[-1]
        change_pred = (outputs["change"][..., 0] > 0.5).long()
        pre_pred = torch.argmax(outputs["pre"], dim=-1) * change_pred
        post_pred = torch.argmax(outputs["post"], dim=-1) * change_pred
        # hist[pred, label]: padded samples go out through pred = -1.
        pre_pr, post_pr = _valid_gt(batch, pre_pred), _valid_gt(batch, post_pred)
        cm = confusion_matrix(pre_pr, pre_label, k) + confusion_matrix(post_pr, post_label, k)
        valid_px = pre_pr >= 0
        correct = (((pre_pred == pre_label) & valid_px).sum()
                   + ((post_pred == post_label) & valid_px).sum())
        total = 2 * valid_px.sum()
    return loss, {"cm": cm, "acc_correct": correct, "acc_total": total}


def _bda_loss_metrics(outputs, batch) -> Tuple[torch.Tensor, Metrics]:
    label = batch["label"].long()  # [B,H,W,2]: (loc, cls)
    label_loc = label[..., 0]
    label_cls = label[..., 0] * label[..., 1]
    seg = cross_entropy_2d(outputs["cls"], label_cls, ignore_index=0)
    loss = seg + bce_dice_loss(outputs["loc"], label_loc[..., None].float())
    with torch.no_grad():
        k = outputs["cls"].shape[-1]
        loc_pred = (outputs["loc"][..., 0] > 0.5).long()
        loc_cm = confusion_matrix(_valid_gt(batch, torch.clamp(label_loc, max=1)), loc_pred, 2)
        # Damage classes count only where a building is (loc > 0).
        cls_gt = _valid_gt(batch, torch.where(label_loc > 0, label_cls, -1))
        cls_cm = confusion_matrix(cls_gt, torch.argmax(outputs["cls"], dim=-1), k)
    return loss, {"loc_cm": loc_cm, "cls_cm": cls_cm}


def _cc_loss_metrics(outputs, batch) -> Tuple[torch.Tensor, Metrics]:
    logits = outputs["logits"]
    loss = caption_cross_entropy(logits, batch["caption"], batch["length"], ignore_index=0)
    with torch.no_grad():
        top1 = caption_top_k_accuracy(logits, batch["caption"], batch["length"], k=1)
    return loss, {"top1": top1}


_TASK_FNS = {Task.BCD: _bcd_loss_metrics, Task.SCD: _scd_loss_metrics,
             Task.BDA: _bda_loss_metrics, Task.CC: _cc_loss_metrics}


def average_gradients(model: torch.nn.Module) -> None:
    """Replace every gradient by its mean over the processes, in flat
    all-reduces of at most GRAD_BUCKET_BYTES of one dtype; a no-op alone."""
    world = distributed.world_size()
    if world == 1:
        return
    buckets, size = [[]], 0
    for p in model.parameters():
        if p.grad is None:
            continue
        nbytes = p.grad.numel() * p.grad.element_size()
        if buckets[-1] and size + nbytes > GRAD_BUCKET_BYTES:
            buckets.append([])
            size = 0
        buckets[-1].append(p.grad)
        size += nbytes
    for bucket in buckets:
        distributed.reduce_sum_(bucket)
        for g in bucket:
            g.div_(world)


def _sum_counts(metrics: Metrics) -> Metrics:
    """The count metrics summed over the processes (one all-reduce)."""
    distributed.reduce_sum_([metrics[k] for k in _COUNT_METRICS if k in metrics])
    return metrics


def train_step(model: torch.nn.Module, opt: torch.optim.Optimizer,
               schedule: Callable[[int], Union[float, Mapping[str, float]]],
               batch: Dict[str, torch.Tensor], step: int, *,
               compute_dtype: Optional[torch.dtype] = None,
               generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
    """One optimizer step at learning rate ``schedule(step)`` (one rate, or
    one per parameter-group name); ``step`` is the number of steps already
    taken. ``generator`` (on the model's device) feeds CC's dropout.
    Returns the loss and the task's metrics on the device."""
    model.train()
    set_lr(opt, schedule(step))
    opt.zero_grad(set_to_none=True)
    outputs = _forward(model, batch, compute_dtype, generator)
    loss, metrics = _TASK_FNS[model.task](outputs, batch)
    loss.backward()
    average_gradients(model)
    opt.step()
    return dict(_sum_counts(metrics), loss=loss.detach())


@torch.no_grad()
def eval_step(model: torch.nn.Module, batch: Dict[str, torch.Tensor], *,
              compute_dtype: Optional[torch.dtype] = None) -> Dict[str, torch.Tensor]:
    """Eval-mode forward; padded samples are masked out of the metrics (the
    loss averages over the whole batch, as in JAX)."""
    model.eval()
    loss, metrics = _TASK_FNS[model.task](_forward(model, batch, compute_dtype), batch)
    return dict(_sum_counts(metrics), loss=loss)
