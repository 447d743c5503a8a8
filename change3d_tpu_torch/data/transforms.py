"""Host-side detection augmentation (counterpart of
``change3d_tpu/data/transforms.py``), channel-last numpy in and out.

normalize(/255, mean .5, std .5) -> resize to (W, H) -> random crop-resize
(crop_area = int(7/224*W), p=.5) -> random vertical and horizontal flips
(p=.5 each) -> random pre/post exchange (p=.5). The labels by task:

- BCD binarises its mask with ceil(label/255);
- SCD ([label1, label2, change]) swaps label1 and label2 on an exchange and
  keeps change;
- BDA ([loc, cls]) leaves its labels alone on an exchange.

The draws come from the caller's ``np.random.Generator`` in the JAX
pipeline's order, so the same generator gives the same sample.

The resizes run through ``torch.nn.functional.interpolate`` on the CPU:
``bilinear`` with ``align_corners=False`` for images and ``nearest`` for
labels follow cv2's INTER_LINEAR (half-pixel centres, edge clamp, no
antialiasing) and INTER_NEAREST (floor(dst * src/dst)) sampling rules;
multi-channel labels resize channel by channel with ``nearest``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def eval_normalize(img: np.ndarray) -> np.ndarray:
    """(/255, mean .5, std .5) without a resize: uint8 HWC -> float32."""
    return (img.astype(np.float32) / 255.0 - 0.5) / 0.5


def resize(img: np.ndarray, width: int, height: int, *, nearest: bool = False) -> np.ndarray:
    """[H, W] or [H, W, C] float32 -> the same at (height, width)."""
    t = torch.from_numpy(np.ascontiguousarray(img, np.float32))
    t = t[None, None] if img.ndim == 2 else t.permute(2, 0, 1)[None]
    if nearest:
        out = F.interpolate(t, size=(height, width), mode="nearest")
    else:
        out = F.interpolate(t, size=(height, width), mode="bilinear", align_corners=False)
    out = out[0, 0] if img.ndim == 2 else out[0].permute(1, 2, 0)
    return out.contiguous().numpy()


TASKS = ("bcd", "scd", "bda")


@dataclass
class TransformPipeline:
    """The augmentation pipeline of one detection task (``TASKS``);
    ``train=False`` only normalises and resizes."""

    width: int = 256
    height: int = 256
    task: str = "bcd"
    train: bool = True
    mean: float = 0.5
    std: float = 0.5

    def __post_init__(self):
        if self.task not in TASKS:
            raise ValueError(f"task {self.task!r}: one of {TASKS}")
        self.crop_area = int(7.0 / 224.0 * self.width)

    def __call__(self, image: np.ndarray, label: np.ndarray,
                 rng: Optional[np.random.Generator] = None) -> Tuple[np.ndarray, np.ndarray]:
        """image: [H, W, 6] uint8 (pre|post); label: [H, W] (BCD) or
        [H, W, C] (SCD: 3, BDA: 2) integers.

        Returns (image float32 [H, W, 6], label int32 [H, W, C'])."""
        rng = rng or np.random.default_rng()
        image = image.astype(np.float32) / 255.0
        if self.task == "bcd":
            label = np.ceil(label.astype(np.float32) / 255.0)
        image = (image - self.mean) / self.std
        label = label.astype(np.float32)

        if image.shape[0] != self.height or image.shape[1] != self.width:
            image = resize(image, self.width, self.height)
            label = resize(label, self.width, self.height, nearest=True)

        if self.train:
            if rng.random() < 0.5 and self.crop_area > 0:
                h, w = image.shape[:2]
                x1 = int(rng.integers(0, self.crop_area + 1))
                y1 = int(rng.integers(0, self.crop_area + 1))
                image = resize(image[y1:h - y1, x1:w - x1], w, h)
                label = resize(label[y1:h - y1, x1:w - x1], w, h, nearest=True)
            if rng.random() < 0.5:
                image = image[::-1].copy()
                label = label[::-1].copy()
            if rng.random() < 0.5:
                image = image[:, ::-1].copy()
                label = label[:, ::-1].copy()
            if rng.random() < 0.5:
                image = np.concatenate([image[:, :, 3:6], image[:, :, 0:3]], axis=2)
                if self.task == "scd":
                    label = label[..., [1, 0, 2]]

        if label.ndim == 2:
            label = label[..., None]
        return image.astype(np.float32), label.astype(np.int32)


def make_transform_pipelines(task: str, width: int = 256,
                             height: int = 256) -> Tuple[TransformPipeline, TransformPipeline]:
    """(train, eval) pipelines."""
    return (TransformPipeline(width, height, task, train=True),
            TransformPipeline(width, height, task, train=False))
