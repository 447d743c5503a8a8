"""Detection dataset readers (counterpart of ``change3d_tpu/data/datasets.py``),
read through ``data/png.py``; every file is checked up front.

  BCD  {root}/{split}/{t1,t2,label}/<name>            (LEVIR-CD / WHU-CD / CLCD)
  SCD  {root}/{split}/{t1,t2,label1,label2,change}/<name>           (SECOND)
  BDA  {root}/{split}/{t1,t2,label1,label2}; the label files' names rewrite
       'disaster' to 'disaster_target'                                 (xBD)

  CC   {root}/{SPLIT}_IMAGES_{ds}.hdf5 ([N, 2, 3, H, W] uint8, read by
       data/hdf5.py) +
       {SPLIT}_CAPTIONS_{ds}.json + {SPLIT}_CAPLENS_{ds}.json, 5 captions
       per image                                          (LEVIR-CC / DUBAI-CC)

Images come in RGB order, except BDA's, which the JAX package reads in BGR
(as the reference reads xBD with cv2 and trains on BGR). Labels are gray:
BCD one mask [H, W], SCD [label1, label2, change], BDA [loc, cls].
"""

from __future__ import annotations

import json
import os
from os.path import join as osp
from typing import List, Optional

import numpy as np

from change3d_tpu_torch.data import hdf5
from change3d_tpu_torch.data.png import imread_gray, imread_rgb
from change3d_tpu_torch.data.transforms import TransformPipeline


class _PairDataset:
    """Pairs from ``t1``/``t2`` and one or more label directories."""

    bgr = False

    def __init__(self, file_root: str, split: str, transform: Optional[TransformPipeline],
                 names: List[str], label_dirs: List[str], label_name=lambda f: f):
        if not os.path.exists(file_root):
            raise FileNotFoundError(file_root)
        self.pre_images = [osp(file_root, split, "t1", f) for f in names]
        self.post_images = [osp(file_root, split, "t2", f) for f in names]
        self.label_paths = [[osp(file_root, split, d, label_name(f)) for f in names]
                            for d in label_dirs]
        self.transform = transform
        for paths in [self.pre_images, self.post_images] + self.label_paths:
            for p in paths:
                if not os.path.exists(p):
                    raise FileNotFoundError(p)

    def __len__(self) -> int:
        return len(self.pre_images)

    def _image(self, path: str) -> np.ndarray:
        img = imread_rgb(path)
        return np.ascontiguousarray(img[..., ::-1]) if self.bgr else img

    def __getitem__(self, idx: int, rng: Optional[np.random.Generator] = None):
        img = np.concatenate([self._image(self.pre_images[idx]),
                              self._image(self.post_images[idx])], axis=2)
        labels = [imread_gray(paths[idx]) for paths in self.label_paths]
        label = labels[0] if len(labels) == 1 else np.stack(labels, axis=-1)
        if self.transform is not None:
            return self.transform(img, label, rng)
        return img, label


class BCDDataset(_PairDataset):
    """Binary change detection: one mask per pair."""

    def __init__(self, file_root: str, split: str, transform: Optional[TransformPipeline] = None):
        names = sorted(os.listdir(osp(file_root, split, "label")))
        super().__init__(file_root, split, transform, names, ["label"])


class SCDDataset(_PairDataset):
    """Semantic change detection: label channels [label1, label2, change]."""

    def __init__(self, file_root: str, split: str, transform: Optional[TransformPipeline] = None):
        names = sorted(os.listdir(osp(file_root, split, "label1")))
        super().__init__(file_root, split, transform, names, ["label1", "label2", "change"])


class BDADataset(_PairDataset):
    """Building damage assessment: label channels [loc, cls], images BGR."""

    bgr = True

    def __init__(self, file_root: str, split: str, transform: Optional[TransformPipeline] = None):
        names = sorted(os.listdir(osp(file_root, split, "t1")))
        super().__init__(file_root, split, transform, names, ["label1", "label2"],
                         label_name=lambda f: f.replace("disaster", "disaster_target"))


DATASETS = {"bcd": BCDDataset, "scd": SCDDataset, "bda": BDADataset}


class CaptionDataset:
    """LEVIR-CC / DUBAI-CC captions: one sample per caption row, images
    normalised with ImageNet's mean and std; training swaps the pair with
    p = 0.3 (a draw from the sample's generator). Eval splits add the
    image's ``all_captions`` [cpi, L].

    The HDF5 images are read by ``data/hdf5.py`` (no h5py). The dataset
    keeps only where they lie, and maps the file on first access in each
    process: a pickled dataset (a loader's worker processes) carries no
    image bytes, and an item reads one image."""

    MEAN = np.array([0.485, 0.456, 0.406], np.float32)
    STD = np.array([0.229, 0.224, 0.225], np.float32)

    def __init__(self, file_root: str, dataset: str, split: str):
        self.split = split.upper()
        self.location, attrs = hdf5.read_file(
            osp(file_root, f"{self.split}_IMAGES_{dataset}.hdf5"))
        self._images = None
        with open(osp(file_root, f"{self.split}_CAPTIONS_{dataset}.json")) as f:
            self.captions = json.load(f)
        with open(osp(file_root, f"{self.split}_CAPLENS_{dataset}.json")) as f:
            self.caplens = json.load(f)
        self.cpi = int(attrs.get("captions_per_image", 5))

    @property
    def images(self) -> np.ndarray:
        """[N, 2, 3, H, W] uint8, mapped on first use."""
        if self._images is None:
            self._images = self.location.map()
        return self._images

    def __getstate__(self):
        return {**self.__dict__, "_images": None}

    def __len__(self) -> int:
        return len(self.captions)

    def __getitem__(self, idx: int, rng: Optional[np.random.Generator] = None):
        rng = rng or np.random.default_rng()
        img_idx = idx // self.cpi
        img = np.asarray(self.images[img_idx], np.float32) / 255.0  # [2, 3, H, W]
        img = (img.transpose(0, 2, 3, 1) - self.MEAN) / self.STD
        if self.split == "TRAIN" and rng.random() < 0.3:
            img = img[::-1].copy()
        out = {"pre": img[0], "post": img[1], "caption": np.asarray(self.captions[idx], np.int32),
               "length": int(np.asarray(self.caplens[idx]).reshape(-1)[0])}
        if self.split != "TRAIN":
            start = img_idx * self.cpi
            out["all_captions"] = np.asarray(self.captions[start:start + self.cpi], np.int32)
        return out

    def close(self) -> None:
        """Drops the map (a later item maps the file again)."""
        self._images = None
