"""Serving forward (counterpart of ``change3d_tpu/inference.py``).

``Predictor`` wraps a Change3D module on one device: numpy images in, numpy
masks out. Eval-mode BN runs from running statistics, so results do not
depend on the batch. ``predict_u8`` keeps the whole pipeline on the device:
uint8 pixels up, hardened (and bitpacked) masks down. The heads by task
(``models/trainer.py``): BCD 'change'; SCD 'pre', 'post' (classes) and
'change'; BDA 'cls' (classes) and 'loc'.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from change3d_tpu_torch.device import resolve_device
from change3d_tpu_torch.models.trainer import Change3D

_CLASS_KEYS = ("pre", "post", "cls")
_BINARY_KEYS = ("change", "loc")


def postprocess_probs(out: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Raw head outputs -> soft maps as float32 numpy: binary heads pass
    through (sigmoid is in-model), class heads softmax to probabilities."""
    result = {}
    for key, val in out.items():
        val = val.float().cpu().numpy()
        if key in _CLASS_KEYS:
            e = np.exp(val - val.max(-1, keepdims=True))
            val = e / e.sum(-1, keepdims=True)
        result[key] = val
    return result


class Predictor:
    def __init__(self, model: Change3D, *, compute_dtype: torch.dtype = torch.bfloat16,
                 device="cuda"):
        """Runs ``model`` in eval mode on ``device`` (CUDA by default; raises
        without a card unless ``device="cpu"``) with activations in
        ``compute_dtype``."""
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.compute_dtype = compute_dtype
        pows = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.int32)
        self._pows = pows.to(self.device)

    def _put(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    @torch.inference_mode()
    def _forward(self, pre: torch.Tensor, post: torch.Tensor) -> Dict[str, torch.Tensor]:
        return self.model(pre.to(self.compute_dtype), post.to(self.compute_dtype))

    def predict_probs(self, pre: np.ndarray, post: np.ndarray) -> Dict[str, np.ndarray]:
        """Soft maps: binary heads ('change', 'loc') as sigmoid
        probabilities [B,H,W,1], class heads ('pre', 'post', 'cls') as
        softmax probabilities [B,H,W,C]."""
        return postprocess_probs(self._forward(self._put(pre), self._put(post)))

    @staticmethod
    def harden(probs: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """Soft maps -> decisions: binary heads thresholded at 0.5, class
        heads argmaxed."""
        result = {}
        for key, val in probs.items():
            if key in _BINARY_KEYS:
                result[key] = val[..., 0] > 0.5
            elif key in _CLASS_KEYS:
                result[key] = val.argmax(-1)
            else:
                result[key] = val
        return result

    def predict(self, pre: np.ndarray, post: np.ndarray) -> Dict[str, np.ndarray]:
        """pre/post: [B,H,W,3] normalized float images. Returns per-task
        masks: BCD {'change': bool}; SCD {'pre', 'post': class ids,
        'change': bool}; BDA {'cls': class ids, 'loc': bool}."""
        return self.harden(self.predict_probs(pre, post))

    @torch.inference_mode()
    def predict_u8_device(self, pre: torch.Tensor, post: torch.Tensor) -> Dict[str, torch.Tensor]:
        """uint8 [B,H,W,3] device tensors -> hardened masks on the device.
        Class maps come back as uint8 argmax ids; binary masks bitpacked
        (uint8, 8 pixels per byte, np.unpackbits order) when the width is a
        multiple of 8."""

        def norm(a):
            # fp32 first with eval_normalize's op sequence, then the cast: the
            # model sees the same inputs as on the host-normalized float path.
            return ((a.float() / 255.0 - 0.5) / 0.5).to(self.compute_dtype)

        out = self.model(norm(pre), norm(post))
        hard = {}
        for key, val in out.items():
            if key in _BINARY_KEYS:
                mask = val[..., 0] > 0.5
                b, h, w = mask.shape
                if w % 8 == 0:
                    grouped = mask.reshape(b, h, w // 8, 8).to(torch.int32)
                    mask = (grouped * self._pows).sum(-1).to(torch.uint8)
                hard[key] = mask
            elif key in _CLASS_KEYS:
                hard[key] = torch.argmax(val, dim=-1).to(torch.uint8)
            else:
                hard[key] = val
        return hard

    def predict_u8(self, pre: np.ndarray, post: np.ndarray) -> Dict[str, np.ndarray]:
        """Raw [B,H,W,3] uint8 in, hardened masks out (the same decisions as
        :meth:`predict` on eval-normalized floats): bool binary masks and
        uint8 class ids, keyed as in :meth:`predict`."""
        out = self.predict_u8_device(self._put(pre), self._put(post))
        w = pre.shape[2]
        fetched = {}
        for key, val in out.items():
            arr = val.cpu().numpy()
            if key in _BINARY_KEYS and w % 8 == 0:
                arr = np.unpackbits(arr, axis=-1).astype(bool)[..., :w]
            fetched[key] = arr
        return fetched
