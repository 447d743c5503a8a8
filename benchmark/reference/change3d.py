"""Plain fp32 reference of the Change3D models the benchmark runs.

Written from the published description (Change3D, CVPR 2025: the pair and
N learned perception frames as a clip through X3D-L, with a temporal
difference added to the middle frame after the stem and stages 1-3; the FPN
change decoder; the transformer caption decoder over the stage-4 memory)
and the configuration files beside the benchmark. It imports nothing of the
program and nothing of JAX: torch.nn.functional only, activations in
PyTorch's channel-first layout ([B, C, T, H, W]), TF32 off.

Parameters are one flat dict under the names the program's ``state_dict``
uses (the benchmark makes the values from the seed and hands the same dict
to both sides). ``param_spec`` lists every name with its shape and the rule
its values are drawn by.

``quant="fp8"`` rounds both operands of every convolution and matrix
product to float8 e4m3 (one scale per tensor, fp32 accumulation): the
lower-precision control of a bf16 cell.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]

MEAN_IMAGENET = (0.485, 0.456, 0.406)
STD_IMAGENET = (0.229, 0.224, 0.225)


def no_tf32() -> None:
    """fp32 products in fp32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def round_width(width: float, multiplier: float, min_width: int = 8, divisor: int = 8) -> int:
    """X3D's width rounding (pytorchvideo): to a multiple of 8, at least 8,
    and not below 0.9 of the product."""
    width *= multiplier
    out = max(min_width, int(width + divisor / 2) // divisor * divisor)
    if out < 0.9 * width:
        out += divisor
    return int(out)


def _q8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under one per-tensor scale."""
    scale = x.abs().amax().clamp_min(1e-12) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class Ops:
    """The products of the model, in fp32 or with fp8-rounded operands."""

    def __init__(self, quant: Optional[str] = None):
        if quant not in (None, "fp8"):
            raise ValueError(f"quant {quant!r}: None or 'fp8'")
        self.q = _q8 if quant else (lambda t: t)

    def conv3d(self, x, w, stride=1, padding=0, groups=1):
        return F.conv3d(self.q(x), self.q(w), stride=stride, padding=padding, groups=groups)

    def pointwise(self, x, w):
        """[B, Ci, T, H, W] by an [Ci, Co] matrix."""
        return F.conv3d(self.q(x), self.q(w).t()[:, :, None, None, None])

    def conv2d(self, x, w, padding=0):
        return F.conv2d(self.q(x), self.q(w), padding=padding)

    def conv_transpose2d(self, x, w, b):
        return F.conv_transpose2d(self.q(x), self.q(w), b, stride=2, padding=1)

    def matmul(self, a, b):
        return self.q(a) @ self.q(b)


# -- parameters -----------------------------------------------------------


def stage_plan(cfg: dict) -> List[Tuple[int, int, int, int, int]]:
    """(stage, depth, dim_in, dim_inner, dim_out) of each stage run."""
    dims_in = [cfg["stem_dim"]] + list(cfg["stage_dims"][:-1])
    return [(s, cfg["stage_depths"][s], dims_in[s], cfg["stage_inner_dims"][s],
             cfg["stage_dims"][s]) for s in range(cfg["num_stages"])]


def param_spec(cfg: dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, rule) of every parameter and BN statistic. Rules:
    'fan' uniform within sqrt(3/fan_in), unit variance through a product
    (fan_in: rows of a matrix, or all but the first axis of a kernel);
    'bn_scale', 'bn_bias', 'bn_mean', 'bn_var', 'bias', 'ln_scale',
    'ln_bias'; 'normal' N(0, 1)."""
    spec = []
    add = lambda name, shape, rule: spec.append((name, tuple(shape), rule))

    def bn(prefix, c):
        for part in ("scale", "bias", "mean", "var"):
            add(f"{prefix}.{part}", (c,), f"bn_{part}")

    size, c0 = cfg["image_size"], cfg["stem_dim"]
    add("encoder.perception_frames", (1, cfg["perception_frames"], size, size, 3), "normal")
    x3d = "encoder.x3d"
    add(f"{x3d}.stem.conv_s", (c0, 3, 1, 3, 3), "fan")
    add(f"{x3d}.stem.conv_t", (c0, 1, 5, 1, 1), "fan")
    bn(f"{x3d}.stem.bn", c0)
    for s, depth, d_in, inner, d_out in stage_plan(cfg):
        se_dim = round_width(inner, cfg["se_ratio"])
        for b in range(depth):
            p = f"{x3d}.stage{s + 1}.block{b}"
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
    if cfg["task"] == "cc":
        e, v = cfg["embed_dim"], cfg["vocab_size"]
        add("decoder.vocab_embedding", (v, e), "fan")
        for i in range(cfg["num_layers"]):
            for attn in ("self_attn", "cross_attn"):
                add(f"decoder.layer{i}.{attn}.in_proj_w", (e, 3 * e), "fan")
                add(f"decoder.layer{i}.{attn}.in_proj_b", (3 * e,), "bias")
                add(f"decoder.layer{i}.{attn}.out_w", (e, e), "fan")
                add(f"decoder.layer{i}.{attn}.out_b", (e,), "bias")
            for norm in ("norm1", "norm2"):
                add(f"decoder.layer{i}.{norm}.scale", (e,), "ln_scale")
                add(f"decoder.layer{i}.{norm}.bias", (e,), "ln_bias")
        add("decoder.out_w", (e, v), "fan")
        add("decoder.out_b", (v,), "bias")
        return spec
    taps = [c0] + list(cfg["stage_dims"][:3])
    for i, c in enumerate(taps):
        add(f"encoder.fc{i}.conv", (c, c), "fan")
    d1, d2, d3, d4 = taps
    for name, c_in, c_out in (("up_c4", d4, d3), ("up_c3", d3, d2), ("up_c2", d2, d1)):
        add(f"decoder.{name}.reduce", (c_out, c_in, 1, 1), "fan")
        add(f"decoder.{name}.up", (c_out, c_out, 4, 4), "fan")
        add(f"decoder.{name}.up_bias", (c_out,), "bias")
    add("decoder.final", (cfg["num_classes"], d1, 3, 3), "fan")
    return spec


def make_params(cfg: dict, seed: int, device) -> Params:
    """Every parameter and BN statistic from ``seed`` in two draws on
    ``device`` (one uniform, one normal), fp32, cut into leaves."""
    spec = param_spec(cfg)
    sizes = [math.prod(shape) for _, shape, _ in spec]
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    u = torch.rand(sum(sizes), generator=gen, device=device) * 2.0 - 1.0
    n = torch.randn(sum(sizes), generator=gen, device=device)
    params, off = {}, 0
    for (name, shape, rule), size in zip(spec, sizes):
        a, z = u[off:off + size].view(shape), n[off:off + size].view(shape)
        off += size
        if rule == "fan":
            fan_in = shape[0] if len(shape) == 2 else size // shape[0]
            t = a * math.sqrt(3.0 / fan_in)
        elif rule in ("bn_scale", "ln_scale"):
            t = 1.0 + 0.1 * a
        elif rule in ("bn_bias", "bn_mean", "ln_bias"):
            t = 0.1 * a
        elif rule == "bn_var":
            t = 1.0 + 0.25 * a
        elif rule == "bias":
            t = 0.05 * a
        else:
            t = z
        params[name] = t
    if "end_token_bias" in cfg:
        # Random decoders end captions at lengths that depend on the seed;
        # this bias keeps <end> from being chosen, so every seed decodes
        # the same number of steps.
        params["decoder.out_b"][cfg["end_token"]] = cfg["end_token_bias"]
    return params


# -- forward --------------------------------------------------------------


class Change3DRef:
    """The eval forward and, for CC, the teacher-forced caption logits, over
    a params dict."""

    def __init__(self, cfg: dict, params: Params, *, quant: Optional[str] = None):
        self.cfg, self.p, self.ops, self.eps = cfg, params, Ops(quant), cfg["bn_eps"]

    def bn(self, x: torch.Tensor, prefix: str) -> torch.Tensor:
        p, shape = self.p, (1, -1) + (1,) * (x.dim() - 2)
        mean, var = p[f"{prefix}.mean"], p[f"{prefix}.var"]
        a = p[f"{prefix}.scale"] * torch.rsqrt(var + self.eps)
        b = p[f"{prefix}.bias"] - mean * a
        return x * a.view(shape) + b.view(shape)

    def stem(self, x):
        pre = "encoder.x3d.stem"
        x = self.ops.conv3d(x, self.p[f"{pre}.conv_s"], padding=(0, 1, 1))
        x = self.ops.conv3d(x, self.p[f"{pre}.conv_t"], padding=(2, 0, 0), groups=x.shape[1])
        return torch.relu(self.bn(x, f"{pre}.bn"))

    def block(self, x, prefix: str, stride: int):
        p, o = self.p, self.ops
        h = torch.relu(self.bn(o.pointwise(x, p[f"{prefix}.bottleneck.conv_a"]),
                               f"{prefix}.bottleneck.bn_a"))
        h = o.conv3d(h, p[f"{prefix}.bottleneck.conv_b"], stride=(1, stride, stride),
                     padding=1, groups=h.shape[1])
        h = self.bn(h, f"{prefix}.bottleneck.bn_b")
        se = f"{prefix}.bottleneck.se"
        if f"{se}.w_reduce" in p:
            s = h.mean(dim=(2, 3, 4))
            s = torch.relu(o.matmul(s, p[f"{se}.w_reduce"]) + p[f"{se}.b_reduce"])
            g = torch.sigmoid(o.matmul(s, p[f"{se}.w_expand"]) + p[f"{se}.b_expand"])
            h = h * g[:, :, None, None, None]
        h = h * torch.sigmoid(h)
        h = self.bn(o.pointwise(h, p[f"{prefix}.bottleneck.conv_c"]), f"{prefix}.bottleneck.bn_c")
        short = x
        if f"{prefix}.proj" in p:
            short = o.pointwise(x[:, :, :, ::stride, ::stride], p[f"{prefix}.proj"])
            if f"{prefix}.proj_bn.scale" in p:
                short = self.bn(short, f"{prefix}.proj_bn")
        return torch.relu(short + h)

    def stage(self, x, s: int):
        for b in range(self.cfg["stage_depths"][s]):
            x = self.block(x, f"encoder.x3d.stage{s + 1}.block{b}", 2 if b == 0 else 1)
        return x

    def clip(self, pre, post):
        """[B, H, W, 3] normalised images -> the [B, 3, N+2, H, W] clip."""
        frames = self.p["encoder.perception_frames"].expand(pre.shape[0], -1, -1, -1, -1)
        x = torch.cat([pre[:, None], frames, post[:, None]], dim=1)
        return x.permute(0, 4, 1, 2, 3)

    def taps(self, pre, post) -> List[torch.Tensor]:
        """Detection: the first perception frame's features after the stem
        and stages 1-3, each enhanced by the pair's difference."""
        x, taps, n = self.clip(pre, post), [], self.cfg["perception_frames"]
        for i in range(4):
            x = self.stem(x) if i == 0 else self.stage(x, i - 1)
            diff = (x[:, :, 0] - x[:, :, n + 1]).abs()
            enh = torch.relu(self.ops.pointwise(diff[:, :, None], self.p[f"encoder.fc{i}.conv"]))
            mid = x.shape[2] // 2
            x = torch.cat([x[:, :, :mid], x[:, :, mid:mid + 1] + enh, x[:, :, mid + 1:]], dim=2)
            taps.append(x[:, :, 1])
        return taps

    def change_logits(self, pre, post) -> torch.Tensor:
        """BCD: the change head's logits [B, H, W] (before the sigmoid)."""
        p, o = self.p, self.ops
        c1, c2, c3, c4 = self.taps(pre, post)

        def up(x, name):
            d = f"decoder.{name}"
            x = o.conv2d(x, p[f"{d}.reduce"])
            return o.conv_transpose2d(x, p[f"{d}.up"], p[f"{d}.up_bias"])

        c3 = c3 + up(c4, "up_c4")
        c2 = c2 + up(c3, "up_c3")
        c1 = c1 + up(c2, "up_c2")
        return o.conv2d(c1, p["decoder.final"], padding=1)[:, 0]

    def memory(self, pre, post) -> torch.Tensor:
        """CC: the stage-4 feature of the perception frame, [B, h*w, C]."""
        x = self.stem(self.clip(pre, post))
        for s in range(self.cfg["num_stages"]):
            x = self.stage(x, s)
        f = x[:, :, self.cfg["perception_frames"]]
        return f.flatten(2).transpose(1, 2)

    def _attn(self, q_in, kv_in, prefix, mask=None):
        p, o, e = self.p, self.ops, self.cfg["embed_dim"]
        h = self.cfg["num_heads"]
        w, b = p[f"{prefix}.in_proj_w"], p[f"{prefix}.in_proj_b"]
        q = o.matmul(q_in, w[:, :e]) + b[:e]
        k = o.matmul(kv_in, w[:, e:2 * e]) + b[e:2 * e]
        v = o.matmul(kv_in, w[:, 2 * e:]) + b[2 * e:]
        split = lambda t: t.reshape(t.shape[0], t.shape[1], h, e // h).transpose(1, 2)
        q, k, v = split(q), split(k), split(v)
        logits = o.matmul(q, k.transpose(-1, -2)) / math.sqrt(e // h)
        if mask is not None:
            logits = logits + mask
        out = o.matmul(torch.softmax(logits, dim=-1), v)
        out = out.transpose(1, 2).reshape(q_in.shape[0], q_in.shape[1], e)
        return o.matmul(out, p[f"{prefix}.out_w"]) + p[f"{prefix}.out_b"]

    def _ln(self, x, prefix):
        return F.layer_norm(x, x.shape[-1:], self.p[f"{prefix}.scale"], self.p[f"{prefix}.bias"],
                            1e-5)

    def caption_logits(self, memory: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        """Teacher-forced logits [B, L, V] of tokens [B, L] over memory:
        position t scores token t + 1."""
        p, e = self.p, self.cfg["embed_dim"]
        length = tokens.shape[1]
        pos = torch.arange(length, dtype=torch.float32, device=tokens.device)[:, None]
        div = torch.exp(torch.arange(0, e, 2, dtype=torch.float32, device=tokens.device)
                        * (-math.log(10000.0) / e))
        pe = torch.zeros(length, e, device=tokens.device)
        pe[:, 0::2], pe[:, 1::2] = torch.sin(pos * div), torch.cos(pos * div)
        x = p["decoder.vocab_embedding"][tokens] + pe
        mask = torch.triu(torch.full((length, length), float("-inf"), device=tokens.device), 1)
        for i in range(self.cfg["num_layers"]):
            d = f"decoder.layer{i}"
            x = self._ln(x + self._attn(x, x, f"{d}.self_attn", mask), f"{d}.norm1")
            x = self._ln(x + self._attn(x, memory, f"{d}.cross_attn"), f"{d}.norm2")
        return self.ops.matmul(x, p["decoder.out_w"]) + p["decoder.out_b"]


def normalize_u8(x: torch.Tensor, task: str) -> torch.Tensor:
    """uint8 [B, H, W, 3] -> the model's fp32 input: (x/255 - 0.5)/0.5 for
    detection, ImageNet's mean and std for captioning."""
    x = x.float() / 255.0
    if task == "cc":
        mean = torch.tensor(MEAN_IMAGENET, device=x.device)
        std = torch.tensor(STD_IMAGENET, device=x.device)
        return (x - mean) / std
    return (x - 0.5) / 0.5
