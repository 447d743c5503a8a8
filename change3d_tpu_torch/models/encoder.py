"""Change3D encoder (counterpart of ``change3d_tpu/models/encoder.py``):
perception frames + X3D + temporal-difference enhancement.

pre, N learned perception frames and post form a [B, N+2, H, W, 3] clip.
After each of blocks 0..3 (stem..stage3), |pre - post| at that scale goes
through a per-stage 1x1 conv + ReLU and is added to the middle frame. The
taps are the features at temporal indices 1..N.

With ``output_final`` (the CC encoder) the backbone has stage 4 and the
encoder runs blocks 0..4 without enhancement, returning the stage-4 feature
of frame N. It builds no ``fc0..fc3``: the JAX CC tree has none, since its
enhancement convs are never called on that path.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from change3d_tpu_torch.init import normal_init, torch_conv_kernel_init
from change3d_tpu_torch.models.x3d import X3D, X3DConfig, x3d_l_config
from change3d_tpu_torch.ops.layers import pointwise_conv3d

# Channel dims of the four taps (stem, stage1..3) for X3D-L.
EMBED_DIMS = (24, 24, 48, 96)


def tap_dims(cfg: X3DConfig):
    """Channel dims at the four tap points for an arbitrary backbone config."""
    return (cfg.stem_dim_out,) + tuple(cfg.stage_dims[:3])


class EnhanceFC(nn.Module):
    """Bias-free 1x1 conv ([in, out] matrix) + ReLU."""

    def __init__(self, dim: int, generator: torch.Generator):
        super().__init__()
        self.conv = nn.Parameter(torch_conv_kernel_init(generator, (dim, dim), dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(pointwise_conv3d(x, self.conv))


class Encoder(nn.Module):
    def __init__(self, num_perception_frames: int, in_height: int = 256, in_width: int = 256,
                 cfg: Optional[X3DConfig] = None, *, generator: torch.Generator,
                 output_final: bool = False):
        super().__init__()
        cfg = cfg or x3d_l_config()
        self.num_perception_frames = num_perception_frames
        self.output_final = output_final
        self.x3d = X3D(cfg, num_stages=4 if output_final else 3, generator=generator)
        self.perception_frames = nn.Parameter(
            normal_init(generator, (1, num_perception_frames, in_height, in_width, 3))
        )
        if not output_final:
            for i, dim in enumerate(tap_dims(cfg)):
                self.add_module(f"fc{i}", EnhanceFC(dim, generator))

    def _stack_frames(self, pre: torch.Tensor, post: torch.Tensor) -> torch.Tensor:
        percep = self.perception_frames.to(pre.dtype).expand(
            (pre.shape[0],) + tuple(self.perception_frames.shape[1:])
        )
        return torch.cat([pre[:, None], percep, post[:, None]], dim=1)

    def _enhance(self, x: torch.Tensor, stage: int) -> torch.Tensor:
        n = self.num_perception_frames
        middle = x.shape[1] // 2
        enh = getattr(self, f"fc{stage}")(torch.abs(x[:, 0] - x[:, n + 1]))
        x = x.clone()
        x[:, middle] += enh
        return x

    def forward(self, pre: torch.Tensor, post: torch.Tensor):
        """pre/post: [B, H, W, 3]. Returns 4 stages x N per-frame features
        [B, H', W', C'] at strides 1, 2, 4, 8; with ``output_final`` the
        stage-4 feature of frame N, [B, H/16, W/16, C4]."""
        x = self._stack_frames(pre, post)
        if self.output_final:
            for i in range(5):
                x = self.x3d.run_block(i, x)
            return x[:, self.num_perception_frames]
        taps = []
        for i in range(4):
            x = self._enhance(self.x3d.run_block(i, x), i)
            taps.append([x[:, idx + 1] for idx in range(self.num_perception_frames)])
        return taps
