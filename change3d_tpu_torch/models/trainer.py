"""Task-level model assembly (counterpart of ``change3d_tpu/models/trainer.py``).

The encoder with N perception frames, then per-task ChangeDecoder heads on
the per-frame taps:

  BCD (N=1, T=3): frame 0 -> ``decoder`` (sigmoid)   -> {'change'}
  SCD (N=3, T=5): frames (0, 1, 2) -> ``decoder_pre`` / ``decoder_change``
                  (sigmoid) / ``decoder_post``       -> {'pre', 'change', 'post'}
  BDA (N=2, T=4): frames (0, 1) -> ``decoder_cls`` / ``decoder_loc``
                  (sigmoid)                          -> {'cls', 'loc'}
  CC  (N=1, T=3): the stage-4 feature of frame 1, flattened to the image
                  memory [B, h*w, C4] -> ``decoder`` (CaptionDecoder)
                                                     -> {'memory'[, 'logits']}

Class heads give logits [B, H, W, num_classes], binary heads probabilities
[B, H, W, 1], the caption decoder teacher-forced logits [B, L, vocab]. The
attribute names are the JAX package's, so
``checkpoint/convert.py:from_jax_variables`` bridges the trees unchanged.
"""

from __future__ import annotations

import enum
from typing import Dict, Optional

import torch
from torch import nn

from change3d_tpu_torch.device import resolve_device
from change3d_tpu_torch.models.caption_decoder import CaptionDecoder
from change3d_tpu_torch.models.change_decoder import ChangeDecoder
from change3d_tpu_torch.models.encoder import Encoder, tap_dims
from change3d_tpu_torch.models.x3d import X3DConfig, x3d_l_config


class Task(str, enum.Enum):
    BCD = "bcd"
    SCD = "scd"
    BDA = "bda"
    CC = "cc"


PERCEPTION_FRAMES = {Task.BCD: 1, Task.SCD: 3, Task.BDA: 2, Task.CC: 1}


class Change3D(nn.Module):
    """The Change3D model, built from ``generator`` (or ``seed``) on the CPU
    and moved to ``device`` (CUDA by default; raises without a card unless
    ``device="cpu"``). Parameters stay fp32; each op casts them to the
    activation dtype."""

    def __init__(self, task: Task, num_classes: int = 1, in_height: int = 256,
                 in_width: int = 256, backbone_cfg: Optional[X3DConfig] = None, *,
                 vocab_size: int = 0, embed_dim: int = 192, num_heads: int = 8,
                 num_layers: int = 3, dropout: float = 0.1,
                 device="cuda", generator: Optional[torch.Generator] = None, seed: int = 0):
        """``vocab_size`` .. ``dropout`` configure the CC caption decoder."""
        super().__init__()
        task = Task(task)
        dev = resolve_device(device)
        generator = generator or torch.Generator().manual_seed(seed)
        cfg = backbone_cfg or x3d_l_config()
        self.task, self.num_classes = task, num_classes
        self.in_height, self.in_width = in_height, in_width
        self.backbone_cfg = cfg
        self.encoder = Encoder(PERCEPTION_FRAMES[task], in_height, in_width, cfg,
                               generator=generator, output_final=task == Task.CC)
        dims = tap_dims(cfg)
        classes = lambda: ChangeDecoder(num_classes, in_dims=dims, generator=generator)
        binary = lambda: ChangeDecoder(1, has_sigmoid=True, in_dims=dims, generator=generator)
        if task == Task.BCD:
            self.decoder = binary()
        elif task == Task.SCD:
            self.decoder_pre, self.decoder_post, self.decoder_change = classes(), classes(), binary()
        elif task == Task.BDA:
            self.decoder_cls, self.decoder_loc = classes(), binary()
        else:
            if vocab_size <= 0:
                raise ValueError("CC needs vocab_size > 0")
            self.decoder = CaptionDecoder(vocab_size, embed_dim, num_heads, num_layers, dropout,
                                          generator=generator)
        self.to(dev)

    def forward(self, pre: torch.Tensor, post: torch.Tensor,
                captions: Optional[torch.Tensor] = None, *,
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """pre/post: [B, H, W, 3] normalized images; CC also takes
        ``captions`` [B, L] (teacher forcing) and the dropout ``generator``.
        Returns the task's outputs (module docstring)."""
        if self.task == Task.CC:
            feat = self.encoder(pre, post)
            b, h, w, c = feat.shape
            out = {"memory": feat.reshape(b, h * w, c)}
            if captions is not None:
                out["logits"] = self.decoder(out["memory"], captions, generator=generator)
            return out
        return self.heads(self.encoder(pre, post))

    def heads(self, taps) -> Dict[str, torch.Tensor]:
        """The detection heads (BCD, SCD, BDA) over the encoder's taps: 4
        stages x N per-frame features. Returns the task's outputs (module
        docstring)."""
        frame = lambda i: [stage[i] for stage in taps]
        if self.task == Task.BCD:
            return {"change": self.decoder(frame(0))}
        if self.task == Task.SCD:
            return {"pre": self.decoder_pre(frame(0)), "post": self.decoder_post(frame(2)),
                    "change": self.decoder_change(frame(1))}
        if self.task == Task.BDA:
            return {"cls": self.decoder_cls(frame(0)), "loc": self.decoder_loc(frame(1))}
        raise ValueError("CC has no detection heads")

    # -- the caption decode surface (CC) --------------------------------------

    def decode_captions(self, tokens: torch.Tensor, memory: torch.Tensor) -> torch.Tensor:
        """Full-prefix re-decode for beam search: logits [B, L, vocab]."""
        return self.decoder.decode(tokens, memory)

    def init_decode_cache(self, batch: int, max_len: int, dtype=None):
        return self.decoder.init_decode_cache(batch, max_len, dtype)

    def precompute_memory_kv(self, memory: torch.Tensor):
        return self.decoder.precompute_memory_kv(memory)

    def decode_captions_step(self, tokens_t, memory_kv, cache, pos):
        return self.decoder.decode_step(tokens_t, memory_kv, cache, pos)
