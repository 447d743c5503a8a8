"""Losses (counterpart of ``change3d_tpu/train/losses.py``), all reductions
in fp32: BCD's ``bce_dice_loss``, SCD/BDA's ``cross_entropy_2d`` and
``change_similarity_loss``, and CC's ``caption_cross_entropy`` with its
``caption_top_k_accuracy``.

Each is a ratio of sums over the batch. Under a process group of more than
one process the sums (and the counts that depend on the data) are summed
over the processes (``_global``), so every process holds the global batch's
value, as the JAX step over a sharded batch computes it; alone they are the
batch's own."""

from __future__ import annotations

import torch

from change3d_tpu_torch.parallel import distributed

_EPS = 1e-5


def _global(*terms: torch.Tensor):
    """The scalar terms summed over the processes (in fp64, one all-reduce,
    differentiable), back in fp32; alone, the terms themselves."""
    if distributed.world_size() == 1:
        return terms
    summed = distributed.all_reduce_sum(torch.stack([t.double() for t in terms])).float()
    return tuple(summed.unbind())


def bce_dice_loss(probs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """BCE + (1 - Dice) on sigmoid outputs, probabilities clipped to
    [1e-7, 1 - 1e-7]. probs: [B,H,W,1] in (0,1); targets: same shape {0,1}."""
    p = torch.clamp(probs.float(), 1e-7, 1.0 - 1e-7)
    t = targets.float()
    n = p.numel() * distributed.world_size()
    bce_sum, inter, p_sum, t_sum = _global(
        torch.sum(t * torch.log(p) + (1.0 - t) * torch.log(1.0 - p)),
        torch.sum(p * t), torch.sum(p), torch.sum(t))
    dice = (2.0 * inter + _EPS) / (p_sum + t_sum + _EPS)
    return -bce_sum / n + 1.0 - dice


def cross_entropy_2d(logits: torch.Tensor, targets: torch.Tensor, *,
                     ignore_index: int = -1) -> torch.Tensor:
    """NLL of log_softmax, mean over the pixels whose target is not
    ``ignore_index``. logits: [B,H,W,C]; targets: [B,H,W] int.

    The mean is written out because a batch with no valid pixel must give 0,
    as in JAX (sum / max(count, 1)); ``F.cross_entropy(ignore_index=...)``
    gives nan there, and SCD meets such a batch whenever it has no changed
    pixel."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    t = targets.long()
    valid = t != ignore_index
    picked = torch.gather(logp, -1, torch.where(valid, t, 0)[..., None])[..., 0]
    loss_sum, count = _global(-torch.sum(torch.where(valid, picked, 0.0)), valid.sum().float())
    return loss_sum / torch.clamp(count, min=1)


def change_similarity_loss(logits1: torch.Tensor, logits2: torch.Tensor,
                           label_change: torch.Tensor) -> torch.Tensor:
    """CosineEmbeddingLoss(margin=0) between the softmaxed class maps:
    unchanged pixels pull the two distributions together (1 - cos), changed
    pixels push them apart (max(0, cos)). logits1/2: [B,H,W,C];
    label_change: [B,H,W] (or [B,H,W,1]) in {0,1}."""
    p1 = torch.softmax(logits1.float(), dim=-1)
    p2 = torch.softmax(logits2.float(), dim=-1)
    num = torch.sum(p1 * p2, dim=-1)
    cos = num / torch.clamp(torch.linalg.vector_norm(p1, dim=-1)
                            * torch.linalg.vector_norm(p2, dim=-1), min=1e-8)
    change = label_change[..., 0] if label_change.dim() == cos.dim() + 1 else label_change
    per_pixel = torch.where(change.bool(), torch.clamp(cos, min=0.0), 1.0 - cos)
    (total,) = _global(torch.sum(per_pixel))
    return total / (per_pixel.numel() * distributed.world_size())


def caption_cross_entropy(logits: torch.Tensor, captions: torch.Tensor, lengths: torch.Tensor, *,
                          ignore_index: int = 0) -> torch.Tensor:
    """Teacher-forced caption CE over the first ``length - 1`` target
    positions whose target is not ``ignore_index`` (packed-sequence CE).
    logits: [B, L, V] (position t predicts caption[t + 1]); captions: [B, L];
    lengths: [B] true lengths, <start> and <end> included."""
    targets = captions[:, 1:].long()
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    picked = torch.gather(logp, -1, targets[..., None])[..., 0]
    pos = torch.arange(targets.shape[1], device=targets.device)[None, :]
    valid = (pos < (lengths[:, None] - 1)) & (targets != ignore_index)
    loss_sum, count = _global(-torch.sum(torch.where(valid, picked, 0.0)), valid.sum().float())
    return loss_sum / torch.clamp(count, min=1)


def caption_top_k_accuracy(logits: torch.Tensor, captions: torch.Tensor, lengths: torch.Tensor,
                           k: int = 1) -> torch.Tensor:
    """Top-k token accuracy in percent over the positions < length - 1
    (padding targets included, as JAX counts them)."""
    targets = captions[:, 1:].long()
    pos = torch.arange(targets.shape[1], device=targets.device)[None, :]
    valid = pos < (lengths[:, None] - 1)
    # Ties rank by lower index, as jax.lax.top_k ranks them.
    topk = torch.sort(logits[:, :-1], dim=-1, descending=True, stable=True).indices[..., :k]
    hit = (topk == targets[..., None]).any(-1)
    hits, count = _global((hit & valid).sum().float(), valid.sum().float())
    return 100.0 * hits / torch.clamp(count, min=1)
