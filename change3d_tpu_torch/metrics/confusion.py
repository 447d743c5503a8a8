"""Detection metrics (counterpart of ``change3d_tpu/metrics/confusion.py``):
the confusion matrix on the device, the scores on the host.

The binary scores (Kappa/IoU/F1/OA/recall/precision) use the JAX package's
formulas; SCD/BDA scores arrive with their slice.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

import numpy as np
import torch

_EPS32 = float(np.finfo(np.float32).eps)


def confusion_matrix(gt: torch.Tensor, pred: torch.Tensor, num_classes: int) -> torch.Tensor:
    """[K, K] confusion matrix (rows = gt, cols = pred), fp32, on the
    tensors' device. Pixels with gt outside [0, K) are ignored; pred is
    clipped into [0, K).

    A bincount of gt * K + pred, done as an int64 ``index_add_`` so that it
    needs no host sync on the card (``torch.bincount`` reads the maximum on
    the host there); the counts are exact."""
    gt = gt.reshape(-1).long()
    pred = pred.reshape(-1).long()
    valid = (gt >= 0) & (gt < num_classes)
    idx = torch.where(valid, gt, 0) * num_classes + pred.clamp(0, num_classes - 1)
    counts = torch.zeros(num_classes * num_classes, dtype=torch.int64, device=gt.device)
    counts.index_add_(0, idx, valid.long())
    return counts.reshape(num_classes, num_classes).float()


def binary_change_scores(cm: np.ndarray) -> Dict[str, float]:
    """Scores of a 2x2 matrix (rows = gt, cols = pred)."""
    cm = np.asarray(cm, np.float64)
    tp, fn, fp, tn = cm[1, 1], cm[1, 0], cm[0, 1], cm[0, 0]
    oa = (tp + tn) / (tp + fn + fp + tn + _EPS32)
    recall = tp / (tp + fn + _EPS32)
    precision = tp / (tp + fp + _EPS32)
    f1 = 2 * recall * precision / (recall + precision + _EPS32)
    iou = tp / (tp + fp + fn + _EPS32)
    pre = ((tp + fn) * (tp + fp) + (tn + fp) * (tn + fn)) / (tp + fp + tn + fn) ** 2
    kappa = (oa - pre) / (1 - pre)
    return {
        "Kappa": kappa, "IoU": iou, "F1": f1, "OA": oa,
        "recall": recall, "precision": precision, "Pre": pre,
    }


@dataclass
class BinaryChangeMeter:
    """Host-side accumulator over per-step confusion matrices."""

    cm: np.ndarray = field(default_factory=lambda: np.zeros((2, 2), np.float64))

    def update(self, cm_step) -> None:
        if isinstance(cm_step, torch.Tensor):
            cm_step = cm_step.cpu().numpy()
        self.cm += np.asarray(cm_step, np.float64)

    def scores(self) -> Dict[str, float]:
        return binary_change_scores(self.cm)
