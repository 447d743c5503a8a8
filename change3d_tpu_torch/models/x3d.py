"""X3D video backbone (counterpart of ``change3d_tpu/models/x3d.py``).

Same architecture: spatial-first stride-1 stem, stages of bottleneck
res-blocks with stride 2 and a projection shortcut on block 0, SE on
even-indexed blocks, the shortcut BN only where dims change. Activations
are [B, T, H, W, C]. Stages are plain loops over ``block{j}`` (no scan).

With ``fused_inference`` (the default here) every stride-1, dim-preserving
block runs at eval as the fused CUDA kernel (``ops/fused_block.py``); there
is no shared-memory gate: the kernel tiles H and W at any size, and T
where a whole clip's tile does not fit (``plan_block``: 16-frame clips at
stages 3 and 4 take T-tiles with a one-frame halo). The stem's temporal
conv and every unfused block's depthwise conv run the channels-last CUDA
kernel of ``ops/depthwise_conv.py`` whenever no gradient is taken
(``ops/layers.depthwise_conv3d``).

``X3D(cfg, head=True)`` adds the Kinetics classifier head (``X3DHead``) and
``forward(x, classify=True)`` returns its logits (``head(features(x))``);
``x3d_classifier`` builds it on the card (or ``device="cpu"``): variant
"m" is ``x3d_m_config()`` (X3D-M, and X3D-S / XS, which share its weights
at other clip sizes), "l" is X3D-L as Kinetics-400 runs it (the
``X3D_L.pyth`` network: ``x3d_l_config`` with the stock (1, 2, 2) stem
stride, 16 x 312^2 clips). No Change3D model builds a head, so their
state_dict keys do not change.

``quantized_eval`` runs each bottleneck's two pointwise convs at eval as
int8 products (``ops/quant.py``) and turns fusion off, as in JAX; training
ignores it. ``quant_mode``: 'dynamic' (per-sample scales), 'calibrate' (an
fp32 pass recording each site's max-abs into ``amax_a`` / ``amax_c``) or
'static' (the recorded ranges). The int8 weights are quantised once from
the fp32 parameters and cached per module in non-persistent buffers,
re-made when a parameter changes (its version or storage); ``amax_*`` are
non-persistent too, so a quantised model loads an unquantised state_dict
unchanged. ``remat`` recomputes each (non-SE, SE) block pair after block 0
in the backward (``torch.utils.checkpoint``), as JAX's ``nn.remat`` of the
scanned pairs does; BN's running statistics move once
(``ops/norm.recomputing``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from change3d_tpu_torch.device import resolve_device
from change3d_tpu_torch.init import torch_conv_kernel_init
from change3d_tpu_torch.ops import quant
from change3d_tpu_torch.ops.attention import dropout
from change3d_tpu_torch.ops.fused_block import fused_bottleneck_block
from change3d_tpu_torch.ops.layers import (
    conv3d,
    depthwise_conv3d,
    linear,
    pointwise_conv3d,
    squeeze_excite_3d,
    swish,
)
from change3d_tpu_torch.ops.norm import BatchNorm, InferenceCache, recomputing


def round_width(width, multiplier, min_width: int = 8, divisor: int = 8) -> int:
    """Divisor-8 width rounding with the 0.9 guard (pytorchvideo semantics)."""
    if not multiplier:
        return width
    width *= multiplier
    min_width = min_width or divisor
    width_out = max(min_width, int(width + divisor / 2) // divisor * divisor)
    if width_out < 0.9 * width:
        width_out += divisor
    return int(width_out)


def round_repeats(repeats: int, multiplier: float) -> int:
    if not multiplier:
        return repeats
    return int(math.ceil(multiplier * repeats))


@dataclass(frozen=True)
class X3DConfig:
    """Derived X3D architecture description."""

    in_channels: int = 3
    stem_dim_out: int = 24
    stage_dims: Tuple[int, ...] = (24, 48, 96, 192)
    stage_inner_dims: Tuple[int, ...] = (54, 108, 216, 432)
    stage_depths: Tuple[int, ...] = (5, 10, 25, 15)
    stage_spatial_stride: Tuple[int, ...] = (2, 2, 2, 2)
    stage_temporal_stride: Tuple[int, ...] = (1, 1, 1, 1)
    stem_conv_stride: Tuple[int, int, int] = (1, 1, 1)
    se_ratio: float = 0.0625
    bn_eps: float = 1e-5
    # Kinetics classifier head (X3D(cfg, head=True)); no Change3D task runs it.
    head_dim_out: int = 2048
    num_classes: int = 400
    dropout_rate: float = 0.5
    # Run every stride-1, dim-preserving block at eval as the fused kernel.
    fused_inference: bool = True
    # Recompute the block pairs in the backward (training memory).
    remat: bool = False
    # int8 pointwise convs at eval (fusion off): quant_mode 'dynamic',
    # 'calibrate' or 'static'.
    quantized_eval: bool = False
    quant_mode: str = "dynamic"

    def se_reduced_dim(self, stage_idx: int) -> int:
        return round_width(self.stage_inner_dims[stage_idx], self.se_ratio)


def x3d_config(
    width_factor: float = 2.0,
    depth_factor: float = 2.2,
    bottleneck_factor: float = 2.25,
    stem_dim_in: int = 12,
    base_depths: Tuple[int, ...] = (1, 2, 5, 3),
    stem_conv_stride: Tuple[int, int, int] = (1, 1, 1),
    **overrides,
) -> X3DConfig:
    """Generic X3D family builder: widths double per stage with divisor-8
    rounding, depths are ``round_repeats`` of the base [1, 2, 5, 3]."""
    dims, inners, depths = [], [], []
    d = stem_dim_in
    for i in range(4):
        if i > 0:
            d = round_width(d, 2.0, divisor=8)
        dim_out = round_width(d, width_factor)
        dims.append(dim_out)
        inners.append(int(bottleneck_factor * dim_out))
        depths.append(round_repeats(base_depths[i], depth_factor))
    return X3DConfig(
        stem_dim_out=round_width(stem_dim_in, width_factor),
        stage_dims=tuple(dims),
        stage_inner_dims=tuple(inners),
        stage_depths=tuple(depths),
        stem_conv_stride=stem_conv_stride,
        **overrides,
    )


def x3d_l_config(**overrides) -> X3DConfig:
    """X3D-L as Change3D instantiates it: width 2.0, depth 5.0, bottleneck
    2.25, stem stride (1, 1, 1)."""
    return x3d_config(width_factor=2.0, depth_factor=5.0, **overrides)


def x3d_m_config(**overrides) -> X3DConfig:
    """X3D-M (and X3D-S / XS, which share its weights and differ only in
    clip size: 16 x 224^2, 13 x 160^2, 4 x 160^2): width 2.0, depth 2.2,
    bottleneck 2.25, the stock (1, 2, 2) stem stride."""
    return x3d_config(width_factor=2.0, depth_factor=2.2, stem_conv_stride=(1, 2, 2),
                      **overrides)


class X3DStem(nn.Module):
    """Spatial 1x3x3 conv -> depthwise temporal 5x1x1 conv -> BN -> ReLU."""

    def __init__(self, cfg: X3DConfig, generator: torch.Generator):
        super().__init__()
        self.cfg = cfg
        c, c_in = cfg.stem_dim_out, cfg.in_channels
        self.conv_s = nn.Parameter(torch_conv_kernel_init(generator, (c, c_in, 1, 3, 3), c_in * 9))
        self.conv_t = nn.Parameter(torch_conv_kernel_init(generator, (c, 1, 5, 1, 1), 5))
        self.bn = BatchNorm(c, cfg.bn_eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        st, ss = self.cfg.stem_conv_stride[0], self.cfg.stem_conv_stride[1]
        x = conv3d(x, self.conv_s, stride=(1, ss, ss), padding=(0, 1, 1))
        x = depthwise_conv3d(x, self.conv_t, stride=(st, 1, 1), padding=(2, 0, 0))
        return torch.relu(self.bn(x))


class SqueezeExcite(nn.Module):
    """pool -> fc reduce -> ReLU -> fc expand -> sigmoid -> scale; the two
    fcs are [in, out] matrices with biases."""

    def __init__(self, dim: int, reduced_dim: int, generator: torch.Generator):
        super().__init__()
        self.w_reduce = nn.Parameter(torch_conv_kernel_init(generator, (dim, reduced_dim), dim))
        self.b_reduce = nn.Parameter(torch.zeros(reduced_dim))
        self.w_expand = nn.Parameter(torch_conv_kernel_init(generator, (reduced_dim, dim), reduced_dim))
        self.b_expand = nn.Parameter(torch.zeros(dim))

    def weights(self) -> tuple:
        return self.w_reduce, self.b_reduce, self.w_expand, self.b_expand

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return squeeze_excite_3d(x, *self.weights())


class X3DBottleneck(nn.Module):
    """conv_a 1x1x1 -> BN/ReLU -> conv_b depthwise 3x3x3 (stride) -> BN ->
    [SE] -> swish -> conv_c 1x1x1 -> BN. ``quant_mode`` (None: fp convs)
    quantises conv_a and conv_c at eval."""

    QUANT_MODES = ("dynamic", "calibrate", "static")

    def __init__(self, dim_in, dim_inner, dim_out, stride, se_reduced_dim, eps, generator,
                 quant_mode: Optional[str] = None):
        super().__init__()
        self.stride = tuple(stride)
        self.conv_a = nn.Parameter(torch_conv_kernel_init(generator, (dim_in, dim_inner), dim_in))
        self.bn_a = BatchNorm(dim_inner, eps)
        self.conv_b = nn.Parameter(torch_conv_kernel_init(generator, (dim_inner, 1, 3, 3, 3), 27))
        self.bn_b = BatchNorm(dim_inner, eps)
        self.se: Optional[SqueezeExcite] = (
            SqueezeExcite(dim_inner, se_reduced_dim, generator) if se_reduced_dim > 0 else None
        )
        self.conv_c = nn.Parameter(torch_conv_kernel_init(generator, (dim_inner, dim_out), dim_inner))
        self.bn_c = BatchNorm(dim_out, eps)
        if quant_mode not in (None,) + self.QUANT_MODES:
            raise ValueError(f"quant_mode {quant_mode!r}: one of {self.QUANT_MODES}")
        self.quant_mode = quant_mode
        self._fused_weights = InferenceCache()
        self._int8_keys = {}
        for site in ("a", "c") if quant_mode else ():
            self.register_buffer(f"conv_{site}_q", torch.empty(0, dtype=torch.int8),
                                 persistent=False)
            self.register_buffer(f"conv_{site}_scale", torch.empty(0), persistent=False)
            if quant_mode != "dynamic":
                # NaN until calibrated: a static forward without ranges is NaN.
                self.register_buffer(f"amax_{site}", torch.tensor(float("nan")),
                                     persistent=False)

    def int8_weight(self, site: str) -> quant.Int8Weight:
        """conv_{site} quantised (``quant.prepare_weight``), re-made when the
        parameter changed since; under torch.export the cached one as is."""
        w = getattr(self, f"conv_{site}")
        if not torch.compiler.is_compiling():
            key = (w._version, w.data_ptr())
            if self._int8_keys.get(site) != key:
                prepared = quant.prepare_weight(w.detach())
                setattr(self, f"conv_{site}_q", prepared.q)
                setattr(self, f"conv_{site}_scale", prepared.scale)
                self._int8_keys[site] = key
        return quant.Int8Weight(getattr(self, f"conv_{site}_q"),
                                getattr(self, f"conv_{site}_scale"), w.shape[1])

    def _pointwise(self, x: torch.Tensor, site: str) -> torch.Tensor:
        mode = None if self.training else self.quant_mode
        w = getattr(self, f"conv_{site}")
        if mode == "dynamic":
            return quant.pointwise_conv3d_int8(x, self.int8_weight(site))
        if mode == "static":
            return quant.pointwise_conv3d_int8_static(x, self.int8_weight(site),
                                                      getattr(self, f"amax_{site}"))
        if mode == "calibrate":
            amax = getattr(self, f"amax_{site}")
            amax.copy_(torch.maximum(amax, quant.batch_amax(x)))
        return pointwise_conv3d(x, w)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.bn_a(self._pointwise(x, "a")))
        x = self.bn_b(depthwise_conv3d(x, self.conv_b, stride=self.stride, padding=(1, 1, 1)))
        if self.se is not None:
            x = self.se(x)
        x = swish(x)
        return self.bn_c(self._pointwise(x, "c"))

    def fused_residual(self, x: torch.Tensor) -> torch.Tensor:
        """relu(x + self(x)) as one fused block (eval, stride 1, dim-preserving).
        The kernels' weights (conv_a and conv_c in x's dtype, the depthwise
        taps as a contiguous [3, 3, 3, Ci]) and the folded BNs are kept
        while their sources are unchanged (``InferenceCache``)."""
        a_a, b_a = self.bn_a.folded()
        a_b, b_b = self.bn_b.folded()
        a_c, b_c = self.bn_c.folded()
        w_a, w_dw, w_c = self._fused_weights.get(
            lambda: (self.conv_a.to(x.dtype), self.conv_b[:, 0].permute(1, 2, 3, 0).contiguous(),
                     self.conv_c.to(x.dtype)),
            (self.conv_a, self.conv_b, self.conv_c), x.dtype)
        se = None if self.se is None else self.se.weights()
        return fused_bottleneck_block(x, w_a, a_a, b_a, w_dw, a_b, b_b, w_c, a_c, b_c, se)


def prepare_int8(model: nn.Module) -> None:
    """Quantise the weights of every int8 bottleneck of ``model`` now (a
    trace such as torch.export uses the cached ones as they are); raises
    on a static site without calibrated ranges."""
    for name, m in model.named_modules():
        if isinstance(m, X3DBottleneck) and m.quant_mode:
            if m.quant_mode == "static" and bool(torch.isnan(m.amax_a) | torch.isnan(m.amax_c)):
                raise ValueError(f"static quant_mode needs calibrated scales ({name} has none): "
                                 "run calibrate_quant_scales(model, batches) first")
            m.int8_weight("a")
            m.int8_weight("c")


class X3DResBlock(nn.Module):
    """relu(shortcut(x) + bottleneck(x)). The projection shortcut (strided
    1x1x1 conv, an [in, out] matrix) exists when dims differ or the block
    strides; its BN only when dims differ."""

    def __init__(self, dim_in, dim_inner, dim_out, stride, se_reduced_dim, cfg: X3DConfig,
                 generator):
        super().__init__()
        self.stride = tuple(stride)
        self.fusable = (cfg.fused_inference and not cfg.quantized_eval
                        and self.stride == (1, 1, 1) and dim_in == dim_out)
        self.proj = self.proj_bn = None
        if dim_in != dim_out or any(s > 1 for s in self.stride):
            self.proj = nn.Parameter(torch_conv_kernel_init(generator, (dim_in, dim_out), dim_in))
            if dim_in != dim_out:
                self.proj_bn = BatchNorm(dim_out, cfg.bn_eps)
        self.bottleneck = X3DBottleneck(
            dim_in, dim_inner, dim_out, stride, se_reduced_dim, cfg.bn_eps, generator,
            quant_mode=cfg.quant_mode if cfg.quantized_eval else None,
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fusable and not self.training:
            return self.bottleneck.fused_residual(x)
        shortcut = x
        if self.proj is not None:
            st, sh, sw = self.stride
            shortcut = pointwise_conv3d(x[:, ::st, ::sh, ::sw], self.proj)
            if self.proj_bn is not None:
                shortcut = self.proj_bn(shortcut)
        return torch.relu(shortcut + self.bottleneck(x))


class X3DStage(nn.Module):
    """Res blocks ``block0 .. block{depth-1}``: stride and dim change on
    block 0, SE on even-indexed blocks. With ``cfg.remat`` each pair
    (block 2p+1, block 2p+2) is recomputed in the backward; block 0 and a
    trailing odd block are not."""

    def __init__(self, cfg: X3DConfig, stage_idx: int, dim_in: int, generator):
        super().__init__()
        i = stage_idx
        dim_out, dim_inner = cfg.stage_dims[i], cfg.stage_inner_dims[i]
        first_stride = (
            cfg.stage_temporal_stride[i], cfg.stage_spatial_stride[i], cfg.stage_spatial_stride[i]
        )
        self.depth = cfg.stage_depths[i]
        self.remat = cfg.remat
        for b in range(self.depth):
            self.add_module(f"block{b}", X3DResBlock(
                dim_in if b == 0 else dim_out, dim_inner, dim_out,
                first_stride if b == 0 else (1, 1, 1),
                cfg.se_reduced_dim(i) if (b + 1) % 2 else 0,
                cfg, generator,
            ))

    def _pair(self, x: torch.Tensor, b: int) -> torch.Tensor:
        return getattr(self, f"block{b + 1}")(getattr(self, f"block{b}")(x))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = 0
        if self.remat and self.training and torch.is_grad_enabled():
            x = self.block0(x)
            for b in range(1, self.depth - 1, 2):
                x = checkpoint(self._pair, x, b, use_reentrant=False,
                               context_fn=recomputing.contexts)
            b = self.depth - (self.depth - 1) % 2
        for j in range(b, self.depth):
            x = getattr(self, f"block{j}")(x)
        return x


class X3DHead(nn.Module):
    """Kinetics classifier: 1x1x1 conv -> BN -> ReLU -> fp32 mean over
    (T, H, W) -> 1x1x1 conv -> ReLU -> dropout (train only) -> linear ->
    mean, [B, num_classes]. Names are the JAX variable names."""

    def __init__(self, cfg: X3DConfig, generator: torch.Generator):
        super().__init__()
        dim_in, dim_inner, dim_out = cfg.stage_dims[-1], cfg.stage_inner_dims[-1], cfg.head_dim_out
        self.dropout_rate = cfg.dropout_rate
        self.pre_conv = nn.Parameter(torch_conv_kernel_init(generator, (dim_in, dim_inner), dim_in))
        self.pre_bn = BatchNorm(dim_inner, cfg.bn_eps)
        self.post_conv = nn.Parameter(
            torch_conv_kernel_init(generator, (dim_inner, dim_out), dim_inner))
        self.proj_w = nn.Parameter(
            torch_conv_kernel_init(generator, (dim_out, cfg.num_classes), dim_out))
        self.proj_b = nn.Parameter(torch.zeros(cfg.num_classes))

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """x: stage-4 features [B, T, H, W, C]; ``generator`` draws the
        dropout mask in train mode."""
        x = torch.relu(self.pre_bn(pointwise_conv3d(x, self.pre_conv)))
        x = x.float().mean(dim=(1, 2, 3), keepdim=True).to(x.dtype)
        x = torch.relu(pointwise_conv3d(x, self.post_conv))
        if self.training:
            x = dropout(x, self.dropout_rate, generator)
        return linear(x, self.proj_w, self.proj_b).mean(dim=(1, 2, 3))


class X3D(nn.Module):
    """Stem + the first ``num_stages`` stages, with per-block access
    (``run_block``) for the Encoder's taps. Detection tasks build 3 stages.
    ``head`` adds the Kinetics classifier (all 4 stages)."""

    def __init__(self, cfg: Optional[X3DConfig] = None, *, num_stages: int = 4,
                 head: bool = False, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg or x3d_l_config()
        if head and num_stages != 4:
            raise ValueError(f"the Kinetics head needs all 4 stages, got num_stages={num_stages}")
        generator = generator or torch.Generator().manual_seed(0)
        self.stem = X3DStem(self.cfg, generator)
        dims_in = (self.cfg.stem_dim_out,) + tuple(self.cfg.stage_dims[:-1])
        self.num_stages = num_stages
        for i in range(num_stages):
            self.add_module(f"stage{i + 1}", X3DStage(self.cfg, i, dims_in[i], generator))
        self.head = X3DHead(self.cfg, generator) if head else None

    def run_block(self, i: int, x: torch.Tensor) -> torch.Tensor:
        """Block i of [stem, stage1, ..., stage{num_stages}]."""
        if i == 0:
            return self.stem(x)
        return getattr(self, f"stage{i}")(x)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """x: [B, T, H, W, 3] clips -> the last stage's features."""
        for i in range(self.num_stages + 1):
            x = self.run_block(i, x)
        return x

    def forward(self, x: torch.Tensor, classify: bool = False, *,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x: [B, T, H, W, 3] clips. The last stage's features, or with
        ``classify`` the head's logits [B, num_classes] (``generator``: the
        head's dropout in train mode)."""
        x = self.features(x)
        if not classify:
            return x
        if self.head is None:
            raise ValueError("classify=True needs the Kinetics head: build X3D(cfg, head=True)")
        return self.head(x, generator)


def x3d_classifier(variant: str = "m", *, device="cuda", seed: int = 0) -> X3D:
    """A Kinetics video classifier in eval mode, ``X3D(cfg, head=True)`` with
    weights drawn from ``seed``, on ``device``: the card unless the caller
    asks for the CPU. ``variant`` "m": ``x3d_m_config()``; "l": X3D-L at the
    (1, 2, 2) stem stride of its Kinetics checkpoint (Change3D's X3D-L keeps
    stride 1). Call it as ``model(clip, classify=True)`` on [B, T, H, W, 3]
    clips."""
    if variant not in ("m", "l"):
        raise ValueError(f"X3D classifier variant {variant!r}: 'm' or 'l'")
    cfg = x3d_m_config() if variant == "m" else x3d_l_config(stem_conv_stride=(1, 2, 2))
    dev = resolve_device(device)
    return X3D(cfg, head=True, generator=torch.Generator().manual_seed(seed)).to(dev).eval()
