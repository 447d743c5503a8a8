"""Task-level model assembly (counterpart of ``change3d_tpu/models/trainer.py``).

The encoder with N perception frames, then per-task ChangeDecoder heads on
the per-frame taps:

  BCD (N=1, T=3): frame 0 -> ``decoder`` (sigmoid)   -> {'change'}
  SCD (N=3, T=5): frames (0, 1, 2) -> ``decoder_pre`` / ``decoder_change``
                  (sigmoid) / ``decoder_post``       -> {'pre', 'change', 'post'}
  BDA (N=2, T=4): frames (0, 1) -> ``decoder_cls`` / ``decoder_loc``
                  (sigmoid)                          -> {'cls', 'loc'}

Class heads give logits [B, H, W, num_classes], binary heads probabilities
[B, H, W, 1]. The attribute names are the JAX package's, so
``checkpoint/convert.py:from_jax_variables`` bridges the trees unchanged.
CC arrives with its slice.
"""

from __future__ import annotations

import enum
from typing import Dict, Optional

import torch
from torch import nn

from change3d_tpu_torch.device import resolve_device
from change3d_tpu_torch.models.change_decoder import ChangeDecoder
from change3d_tpu_torch.models.encoder import Encoder, tap_dims
from change3d_tpu_torch.models.x3d import X3DConfig, x3d_l_config


class Task(str, enum.Enum):
    BCD = "bcd"
    SCD = "scd"
    BDA = "bda"
    CC = "cc"


PERCEPTION_FRAMES = {Task.BCD: 1, Task.SCD: 3, Task.BDA: 2, Task.CC: 1}

_LATER_SLICE = {Task.CC: "the CC slice"}


class Change3D(nn.Module):
    """The Change3D model, built from ``generator`` (or ``seed``) on the CPU
    and moved to ``device`` (CUDA by default; raises without a card unless
    ``device="cpu"``). Parameters stay fp32; each op casts them to the
    activation dtype."""

    def __init__(self, task: Task, num_classes: int = 1, in_height: int = 256,
                 in_width: int = 256, backbone_cfg: Optional[X3DConfig] = None, *,
                 device="cuda", generator: Optional[torch.Generator] = None, seed: int = 0):
        super().__init__()
        task = Task(task)
        if task in _LATER_SLICE:
            raise NotImplementedError(f"{task.value} arrives with {_LATER_SLICE[task]}")
        dev = resolve_device(device)
        generator = generator or torch.Generator().manual_seed(seed)
        cfg = backbone_cfg or x3d_l_config()
        self.task, self.num_classes = task, num_classes
        self.in_height, self.in_width = in_height, in_width
        self.backbone_cfg = cfg
        self.encoder = Encoder(PERCEPTION_FRAMES[task], in_height, in_width, cfg,
                               generator=generator)
        dims = tap_dims(cfg)
        classes = lambda: ChangeDecoder(num_classes, in_dims=dims, generator=generator)
        binary = lambda: ChangeDecoder(1, has_sigmoid=True, in_dims=dims, generator=generator)
        if task == Task.BCD:
            self.decoder = binary()
        elif task == Task.SCD:
            self.decoder_pre, self.decoder_post, self.decoder_change = classes(), classes(), binary()
        else:
            self.decoder_cls, self.decoder_loc = classes(), binary()
        self.to(dev)

    def forward(self, pre: torch.Tensor, post: torch.Tensor) -> Dict[str, torch.Tensor]:
        """pre/post: [B, H, W, 3] normalized images. Returns the task's
        outputs (module docstring)."""
        taps = self.encoder(pre, post)
        frame = lambda i: [stage[i] for stage in taps]
        if self.task == Task.BCD:
            return {"change": self.decoder(frame(0))}
        if self.task == Task.SCD:
            return {"pre": self.decoder_pre(frame(0)), "post": self.decoder_post(frame(2)),
                    "change": self.decoder_change(frame(1))}
        return {"cls": self.decoder_cls(frame(0)), "loc": self.decoder_loc(frame(1))}
