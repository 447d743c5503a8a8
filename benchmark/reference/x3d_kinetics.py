"""Plain fp32 reference of X3D-L as a Kinetics-400 video classifier.

Written from the published description (Feichtenhofer, "X3D: Expanding
Architectures for Efficient Video Recognition", CVPR 2020; pytorchvideo's
``create_x3d`` and its ``x3d_l`` model-zoo entry): uint8 clips normalised
by x / 255, mean 0.45 and std 0.225 on every channel; the stem (a 1x3x3
conv at stride (1, 2, 2), then a depthwise 5x1x1 temporal conv, BN, ReLU);
four stages of bottleneck res-blocks (1x1x1 conv_a, BN, ReLU; depthwise
3x3x3 conv_b, stride 2 on block 0, BN; squeeze-excite on even blocks;
swish; 1x1x1 conv_c, BN; a strided 1x1x1 projection shortcut on block 0,
its BN where the width changes; ReLU of the sum); and the head: pre_conv
1x1x1, BN, ReLU, the mean over (T, H, W), post_conv 1x1x1, ReLU, then the
linear projection to the classes. It reuses the Change3D reference's
products, eval BN and block arithmetic (``change3d.py``) under the bare
X3D state_dict names (``stem.*``, ``stage{i}.block{j}.*``, ``head.*``) and
imports nothing of the program and nothing of JAX.

Departures from pytorchvideo: eval BN from running statistics as one scale
and shift; the logits are returned before the softmax that pytorchvideo's
head applies at eval; no dropout (eval); the head's mean over (T, H, W)
stands for its AvgPool3d of (16, 10, 10), which at 16 x 312^2 covers the
whole stage-4 output, and the final mean over the pooled positions is then
the identity; activations in PyTorch's channel-first layout.

Parameters are one flat dict (``param_spec``, drawn by ``make_params`` with
``change3d.make_params``' rules). ``quant="fp8"`` rounds both operands of
every product to float8 e4m3 (``change3d.Ops``): the lower-precision
control of the bf16 cell. Building a reference turns TF32 off, so fp32
products run in fp32 on the card.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch

from benchmark.reference import change3d
from benchmark.reference.change3d import Change3DRef, Params, round_width

MEAN, STD = 0.45, 0.225


def param_spec(cfg: dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, rule) of every parameter and BN statistic (rules as in
    ``change3d.param_spec``): the stem, the four stages, the head."""
    spec = []
    add = lambda name, shape, rule: spec.append((name, tuple(shape), rule))

    def bn(prefix, c):
        for part in ("scale", "bias", "mean", "var"):
            add(f"{prefix}.{part}", (c,), f"bn_{part}")

    c0 = cfg["stem_dim"]
    add("stem.conv_s", (c0, 3, 1, 3, 3), "fan")
    add("stem.conv_t", (c0, 1, 5, 1, 1), "fan")
    bn("stem.bn", c0)
    for s, depth, d_in, inner, d_out in change3d.stage_plan(cfg):
        se_dim = round_width(inner, cfg["se_ratio"])
        for b in range(depth):
            p = f"stage{s + 1}.block{b}"
            din = d_in if b == 0 else d_out
            if b == 0:
                add(f"{p}.proj", (din, d_out), "fan")
                if din != d_out:
                    bn(f"{p}.proj_bn", d_out)
            add(f"{p}.bottleneck.conv_a", (din, inner), "fan")
            bn(f"{p}.bottleneck.bn_a", inner)
            add(f"{p}.bottleneck.conv_b", (inner, 1, 3, 3, 3), "fan")
            bn(f"{p}.bottleneck.bn_b", inner)
            if b % 2 == 0:
                add(f"{p}.bottleneck.se.w_reduce", (inner, se_dim), "fan")
                add(f"{p}.bottleneck.se.b_reduce", (se_dim,), "bias")
                add(f"{p}.bottleneck.se.w_expand", (se_dim, inner), "fan")
                add(f"{p}.bottleneck.se.b_expand", (inner,), "bias")
            add(f"{p}.bottleneck.conv_c", (inner, d_out), "fan")
            bn(f"{p}.bottleneck.bn_c", d_out)
    c4, inner4, head = cfg["stage_dims"][-1], cfg["stage_inner_dims"][-1], cfg["head_dim_out"]
    add("head.pre_conv", (c4, inner4), "fan")
    bn("head.pre_bn", inner4)
    add("head.post_conv", (inner4, head), "fan")
    add("head.proj_w", (head, cfg["num_classes"]), "fan")
    add("head.proj_b", (cfg["num_classes"],), "bias")
    return spec


def make_params(cfg: dict, seed: int, device) -> Params:
    """Every parameter and BN statistic from ``seed`` in two draws on
    ``device``, fp32, by ``change3d.make_params``' rules: 'fan' kernels
    uniform within sqrt(3 / fan_in), so each product keeps unit variance
    and the logits spread over the classes; BN scales 1 +- 0.1, biases and
    running means within 0.1, running variances 1 +- 0.25."""
    spec = param_spec(cfg)
    sizes = [math.prod(shape) for _, shape, _ in spec]
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    u = torch.rand(sum(sizes), generator=gen, device=device) * 2.0 - 1.0
    params, off = {}, 0
    for (name, shape, rule), size in zip(spec, sizes):
        a = u[off:off + size].view(shape)
        off += size
        if rule == "fan":
            fan_in = shape[0] if len(shape) == 2 else size // shape[0]
            params[name] = a * math.sqrt(3.0 / fan_in)
        else:
            params[name] = {"bn_scale": 1.0 + 0.1 * a, "bn_bias": 0.1 * a, "bn_mean": 0.1 * a,
                            "bn_var": 1.0 + 0.25 * a, "bias": 0.05 * a}[rule]
    return params


def normalize_u8(clips: torch.Tensor) -> torch.Tensor:
    """uint8 [B, T, H, W, 3] -> fp32 (x / 255 - 0.45) / 0.225."""
    return (clips.float() / 255.0 - MEAN) / STD


class KineticsRef(Change3DRef):
    """The eval forward of the classifier over a params dict."""

    def __init__(self, cfg: dict, params: Params, *, quant: Optional[str] = None):
        change3d.no_tf32()
        super().__init__(cfg, params, quant=quant)

    def stem(self, x):
        x = self.ops.conv3d(x, self.p["stem.conv_s"], stride=tuple(self.cfg["stem_stride"]),
                            padding=(0, 1, 1))
        x = self.ops.conv3d(x, self.p["stem.conv_t"], padding=(2, 0, 0), groups=x.shape[1])
        return torch.relu(self.bn(x, "stem.bn"))

    def stage(self, x, s: int):
        for b in range(self.cfg["stage_depths"][s]):
            x = self.block(x, f"stage{s + 1}.block{b}", 2 if b == 0 else 1)
        return x

    def features(self, x):
        """Normalised [B, T, H, W, 3] clips -> stage 4's [B, C, T, h, w]."""
        x = self.stem(x.permute(0, 4, 1, 2, 3))
        for s in range(self.cfg["num_stages"]):
            x = self.stage(x, s)
        return x

    def head(self, x):
        p, o = self.p, self.ops
        x = torch.relu(self.bn(o.pointwise(x, p["head.pre_conv"]), "head.pre_bn"))
        x = torch.relu(o.pointwise(x.mean(dim=(2, 3, 4), keepdim=True), p["head.post_conv"]))
        return o.matmul(x.flatten(1), p["head.proj_w"]) + p["head.proj_b"]

    def logits(self, clips):
        """Normalised [B, T, H, W, 3] clips -> logits [B, num_classes]."""
        return self.head(self.features(clips))
