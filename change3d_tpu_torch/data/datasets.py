"""BCD dataset reader (counterpart of ``change3d_tpu/data/datasets.py:BCDDataset``).

Layout ``{root}/{split}/{t1,t2,label}/<name>`` (LEVIR-CD / WHU-CD / CLCD),
images in RGB order, masks gray, read through ``data/png.py``. Every file is
checked up front. SCD/BDA/CC readers arrive with their slices.
"""

from __future__ import annotations

import os
from os.path import join as osp
from typing import Optional

import numpy as np

from change3d_tpu_torch.data.png import imread_gray, imread_rgb
from change3d_tpu_torch.data.transforms import TransformPipeline


class BCDDataset:
    def __init__(self, file_root: str, split: str, transform: Optional[TransformPipeline] = None):
        if not os.path.exists(file_root):
            raise FileNotFoundError(file_root)
        files = sorted(os.listdir(osp(file_root, split, "label")))
        self.pre_images = [osp(file_root, split, "t1", f) for f in files]
        self.post_images = [osp(file_root, split, "t2", f) for f in files]
        self.labels = [osp(file_root, split, "label", f) for f in files]
        self.transform = transform
        for paths in (self.pre_images, self.post_images, self.labels):
            for p in paths:
                if not os.path.exists(p):
                    raise FileNotFoundError(p)

    def __len__(self) -> int:
        return len(self.pre_images)

    def __getitem__(self, idx: int, rng: Optional[np.random.Generator] = None):
        img = np.concatenate([imread_rgb(self.pre_images[idx]),
                              imread_rgb(self.post_images[idx])], axis=2)
        label = imread_gray(self.labels[idx])
        if self.transform is not None:
            return self.transform(img, label, rng)
        return img, label
