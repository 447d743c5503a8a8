"""Detection eval normalization (the port's own copy of
``change3d_tpu/data/transforms.py:eval_normalize``)."""

from __future__ import annotations

import numpy as np


def eval_normalize(img: np.ndarray) -> np.ndarray:
    """(/255, mean .5, std .5) without a resize: uint8 HWC -> float32."""
    return (img.astype(np.float32) / 255.0 - 0.5) / 0.5
