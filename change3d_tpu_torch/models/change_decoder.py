"""FPN-style dense decoder (counterpart of
``change3d_tpu/models/change_decoder.py``): three (1x1 conv ->
ConvTranspose2d k4 s2 p1) up-blocks with additive skips, then a 3x3 conv
(+ sigmoid for binary heads). Conv2d weights get kaiming-normal init, the
transposed convs torch's default init."""

from __future__ import annotations

from typing import List, Sequence

import torch
from torch import nn

from change3d_tpu_torch.init import (
    kaiming_normal_relu_init,
    torch_conv_bias_init,
    torch_conv_kernel_init,
)
from change3d_tpu_torch.ops.layers import conv2d, conv_transpose2d


class UpBlock(nn.Module):
    """Bias-free 1x1 channel-reduce conv, then a 2x transposed conv with bias."""

    def __init__(self, c_in: int, c_out: int, generator: torch.Generator):
        super().__init__()
        self.reduce = nn.Parameter(kaiming_normal_relu_init(generator, (c_out, c_in, 1, 1), c_in))
        # torch's ConvTranspose2d fan_in is C_out * k * k, computed on its
        # (in, out, kh, kw) weight.
        fan_in = c_out * 16
        self.up = nn.Parameter(torch_conv_kernel_init(generator, (c_out, c_out, 4, 4), fan_in))
        self.up_bias = nn.Parameter(torch_conv_bias_init(generator, (c_out,), fan_in))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_transpose2d(conv2d(x, self.reduce), self.up, self.up_bias, stride=2, padding=1)


class ChangeDecoder(nn.Module):
    def __init__(self, num_classes: int, has_sigmoid: bool = False,
                 in_dims: Sequence[int] = (24, 24, 48, 96), *, generator: torch.Generator):
        super().__init__()
        d1, d2, d3, d4 = in_dims
        self.has_sigmoid = has_sigmoid
        self.up_c4 = UpBlock(d4, d3, generator)
        self.up_c3 = UpBlock(d3, d2, generator)
        self.up_c2 = UpBlock(d2, d1, generator)
        out_c = 1 if has_sigmoid else num_classes
        self.final = nn.Parameter(kaiming_normal_relu_init(generator, (out_c, d1, 3, 3), d1 * 9))

    def forward(self, feats: List[torch.Tensor]) -> torch.Tensor:
        """feats: [c1, c2, c3, c4] NHWC at strides 1, 2, 4, 8. Returns
        [B, H, W, num_classes] logits (or sigmoid probabilities)."""
        c1, c2, c3, c4 = feats
        c3f = c3 + self.up_c4(c4)
        c2f = c2 + self.up_c3(c3f)
        c1f = c1 + self.up_c2(c2f)
        pred = conv2d(c1f, self.final, padding=(1, 1))
        return torch.sigmoid(pred) if self.has_sigmoid else pred
