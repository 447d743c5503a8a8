"""Detection metrics (counterpart of ``change3d_tpu/metrics/confusion.py``):
the confusion matrix on the device, the scores on the host.

The scores use the JAX package's formulas: binary (Kappa/IoU/F1/OA/recall/
precision) for BCD, Fscd/mIoU/SeK for SCD, and loc F1, per-damage-class F1
and their 0.3/0.7 mix for BDA. The meters add the per-step matrices on the
host.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict

import numpy as np
import torch

_EPS32 = float(np.finfo(np.float32).eps)


def confusion_matrix(gt: torch.Tensor, pred: torch.Tensor, num_classes: int) -> torch.Tensor:
    """[K, K] confusion matrix (rows = gt, cols = pred), fp32, on the
    tensors' device. Pixels with gt outside [0, K) are ignored; pred is
    clipped into [0, K). Only the first argument masks, so SCD, whose
    matrix is hist[pred, label] with padded samples sent to pred = -1,
    passes the prediction first.

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


def _cal_kappa(hist: np.ndarray) -> float:
    if hist.sum() == 0:
        return 0.0
    po = np.diag(hist).sum() / hist.sum()
    pe = np.matmul(hist.sum(1), hist.sum(0).T) / hist.sum() ** 2
    if pe == 1:
        return 0.0
    return (po - pe) / (1 - pe)


def scd_scores(hist: np.ndarray) -> Dict[str, float]:
    """Fscd / mIoU / SeK from the KxK semantic-change hist [pred, label]."""
    hist = np.asarray(hist, np.float64)
    hist_fg = hist[1:, 1:]
    c2hist = np.zeros((2, 2))
    c2hist[0][0] = hist[0][0]
    c2hist[0][1] = hist.sum(1)[0] - hist[0][0]
    c2hist[1][0] = hist.sum(0)[0] - hist[0][0]
    c2hist[1][1] = hist_fg.sum()
    hist_n0 = hist.copy()
    hist_n0[0][0] = 0
    kappa_n0 = _cal_kappa(hist_n0)
    iu = np.diag(c2hist) / (c2hist.sum(1) + c2hist.sum(0) - np.diag(c2hist))
    iou_fg = iu[1]
    iou_mean = (iu[0] + iu[1]) / 2
    sek = (kappa_n0 * math.exp(iou_fg)) / math.e
    pixel_sum = hist.sum()
    change_pred_sum = pixel_sum - hist.sum(1)[0].sum()
    change_label_sum = pixel_sum - hist.sum(0)[0].sum()
    sc_tp = np.diag(hist[1:, 1:]).sum()
    sc_precision = sc_tp / max(change_pred_sum, 1e-10)
    sc_recall = sc_tp / max(change_label_sum, 1e-10)
    if sc_precision <= 0 or sc_recall <= 0:
        fscd = 0.0
    else:
        fscd = 2.0 / (1.0 / sc_precision + 1.0 / sc_recall)
    return {"Fscd": fscd, "IoU_mean": iou_mean, "Sek": sek}


def bda_scores(loc_cm: np.ndarray, cls_cm: np.ndarray) -> Dict[str, float]:
    """xBD scoring: loc F1 (binary), per-damage-class F1 (classes 1..K-1),
    overall = 0.3 * loc F1 + 0.7 * harmonic mean of the damage F1s."""
    loc_cm = np.asarray(loc_cm, np.float64)
    cls_cm = np.asarray(cls_cm, np.float64)
    rec = loc_cm[1, 1] / max(loc_cm[1, 0] + loc_cm[1, 1], 1e-10)
    pre = loc_cm[1, 1] / max(loc_cm[0, 1] + loc_cm[1, 1], 1e-10)
    loc_f1 = 2 * rec * pre / max(rec + pre, 1e-10)
    tps = np.diag(cls_cm)[1:]
    fns = cls_cm.sum(1)[1:] - tps
    fps = cls_cm.sum(0)[1:] - tps
    precisions = tps / (tps + fps + 1e-7)
    recalls = tps / (tps + fns + 1e-7)
    f1s = 2 * precisions * recalls / (precisions + recalls + 1e-7)
    harmonic = len(f1s) / np.sum(1.0 / np.maximum(f1s, 1e-12))
    overall = 0.3 * loc_f1 + 0.7 * harmonic
    out = {"loc_f1": loc_f1, "harmonic_mean_f1": harmonic, "overall_f1": overall}
    for i, f in enumerate(f1s):
        out[f"damage_f1_class{i + 1}"] = float(f)
    return out


def _host(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.cpu().numpy()
    return np.asarray(v, np.float64)


@dataclass
class BinaryChangeMeter:
    """Host-side accumulator over per-step confusion matrices."""

    cm: np.ndarray = field(default_factory=lambda: np.zeros((2, 2), np.float64))

    def update(self, cm_step) -> None:
        self.cm += _host(cm_step)

    def scores(self) -> Dict[str, float]:
        return binary_change_scores(self.cm)


@dataclass
class SCDMeter:
    """The SCD hist and pixel accuracy over per-step device values."""

    num_classes: int = 6
    cm: np.ndarray = None  # type: ignore[assignment]
    acc_correct: float = 0.0
    acc_total: float = 0.0

    def __post_init__(self):
        if self.cm is None:
            self.cm = np.zeros((self.num_classes, self.num_classes), np.float64)

    def update(self, cm_step, correct=0.0, total=0.0) -> None:
        self.cm += _host(cm_step)
        self.acc_correct += float(correct)
        self.acc_total += float(total)

    def scores(self) -> Dict[str, float]:
        out = scd_scores(self.cm)
        if self.acc_total > 0:
            out["acc"] = self.acc_correct / self.acc_total
        return out


@dataclass
class BDAMeter:
    """The BDA localisation and damage-class matrices over per-step values."""

    num_classes: int = 5
    loc_cm: np.ndarray = None  # type: ignore[assignment]
    cls_cm: np.ndarray = None  # type: ignore[assignment]

    def __post_init__(self):
        if self.loc_cm is None:
            self.loc_cm = np.zeros((2, 2), np.float64)
        if self.cls_cm is None:
            self.cls_cm = np.zeros((self.num_classes, self.num_classes), np.float64)

    def update(self, loc_cm_step, cls_cm_step) -> None:
        self.loc_cm += _host(loc_cm_step)
        self.cls_cm += _host(cls_cm_step)

    def scores(self) -> Dict[str, float]:
        return bda_scores(self.loc_cm, self.cls_cm)
