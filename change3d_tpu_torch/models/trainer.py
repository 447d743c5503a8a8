"""Task-level model assembly (counterpart of ``change3d_tpu/models/trainer.py``).

This slice builds the BCD model: encoder with one perception frame + one
binary ChangeDecoder on frame 0 of every tap -> sigmoid mask [B, H, W, 1].
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

_LATER_SLICE = {
    Task.SCD: "the SCD/BDA slice",
    Task.BDA: "the SCD/BDA slice",
    Task.CC: "the CC slice",
}


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
        if task != Task.BCD:
            raise NotImplementedError(f"{task.value} arrives with {_LATER_SLICE[task]}")
        dev = resolve_device(device)
        generator = generator or torch.Generator().manual_seed(seed)
        cfg = backbone_cfg or x3d_l_config()
        self.task, self.num_classes = task, num_classes
        self.in_height, self.in_width = in_height, in_width
        self.backbone_cfg = cfg
        self.encoder = Encoder(PERCEPTION_FRAMES[task], in_height, in_width, cfg,
                               generator=generator)
        self.decoder = ChangeDecoder(1, has_sigmoid=True, in_dims=tap_dims(cfg),
                                     generator=generator)
        self.to(dev)

    def forward(self, pre: torch.Tensor, post: torch.Tensor) -> Dict[str, torch.Tensor]:
        """pre/post: [B, H, W, 3] normalized images. Returns {'change': [B,H,W,1]}."""
        taps = self.encoder(pre, post)
        return {"change": self.decoder([stage[0] for stage in taps])}
