"""Post-training int8 quantisation of the eval forward (counterpart of
``change3d_tpu/ops/quant.py``).

Symmetric quantisation of the X3D bottleneck's two pointwise convs:

- weights: per-output-channel int8 with fp32 scales, from the fp32
  parameters (``quantize_weight``; the model caches them, ``models/x3d.py``);
- activations, two regimes:
  * dynamic: one scale per sample over T*H*W*C, from the tensor's max-abs
    (``quantize_act``);
  * static: one scale per site from a calibrated max-abs
    (``quantize_act_static``, ranges recorded by ``batch_amax`` in an fp32
    calibration pass, ``inference.calibrate_quant_scales``); values beyond
    it saturate.

The op order is JAX's, so the int8 values are the same: fp32, divide by
the scale, round half to even, clip to +-127; the int32 product is
rescaled as ``y.float() * (xs * ws)`` and cast back to the activation dtype.

The int8 x int8 -> int32 product is ``int8_matmul``: ``torch._int_mm``
(cuBLASLt's int8 tensor-core GEMM on the card). What cuBLASLt takes on the
H100 (torch 2.11 + CUDA 12.8, ``tools/probe_int_mm.py``): K and N
multiples of 8, and, with the kernel row-major [K, N], rows a multiple of
32; a column-major kernel takes any row count but is refused
(CUBLAS_STATUS_NOT_SUPPORTED) at 98,304 rows or more for K 48, 96 or 112 with
N 56 or 216, stage 3's first product at batch 8 among them. So the kernel
is row-major, K is zero-padded (exact), N padded and sliced off, and each
sample's rows padded to a multiple of 32 (none at 256², where T*H*W is
one already). The padding is done on every device, so the CPU tests run
the card's, and it is static: under ``torch.export`` with a symbolic batch
it depends only on the per-sample shape. ``int8_matmul.launches`` counts
the products.

``conv2d_int8`` / ``conv2d_int8_static`` of the JAX module serve only its
time-packed path (``ops/packed.py``), which is never ported, and are not
ported either.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

# Keeps a zero tensor's scale from dividing by zero (JAX's _EPS).
_EPS = 1e-12
# torch._int_mm on the card: K and N multiples of 8, rows of 32.
_ALIGN, _ROW_ALIGN = 8, 32


def _round_up(n: int, k: int) -> int:
    return -(-n // k) * k


def quantize_weight(w: torch.Tensor, *, channel_axis: int = -1
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8 quantisation of a kernel: (int8
    kernel, fp32 scale shaped to broadcast along ``channel_axis``), with
    ``w ~= q * scale``."""
    w = w.float()
    axis = channel_axis % w.dim()
    amax = w.abs().amax(dim=tuple(a for a in range(w.dim()) if a != axis), keepdim=True)
    scale = torch.clamp_min(amax, _EPS) / 127.0
    return torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8), scale


def quantize_act(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantisation with one scale per sample (axis 0):
    (int8 tensor, fp32 scale [B, 1, ..., 1])."""
    x = x.float()
    amax = x.abs().amax(dim=tuple(range(1, x.dim())), keepdim=True)
    scale = torch.clamp_min(amax, _EPS) / 127.0
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8), scale


def quantize_act_static(x: torch.Tensor, amax: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantisation with a calibrated range ``amax`` (an fp32
    scalar): (int8 tensor, fp32 scalar scale); out-of-range values
    saturate."""
    scale = torch.clamp_min(amax.float(), _EPS) / 127.0
    return torch.clamp(torch.round(x.float() / scale), -127, 127).to(torch.int8), scale


def batch_amax(x: torch.Tensor) -> torch.Tensor:
    """The whole tensor's max-abs as an fp32 scalar (the calibration
    statistic)."""
    return x.float().abs().amax()


class Int8Weight(NamedTuple):
    """A pointwise kernel [C_in, C_out] quantised for ``int8_matmul``: the
    int8 kernel padded to [K, N] (multiples of 8, contiguous), its
    per-output-channel fp32 scale [C_out], and C_out."""

    q: torch.Tensor
    scale: torch.Tensor
    n: int


def prepare_weight(kernel: torch.Tensor) -> Int8Weight:
    """Quantise a pointwise kernel [C_in, C_out] from its fp32 values."""
    q, scale = quantize_weight(kernel, channel_axis=1)
    k, n = q.shape
    q = F.pad(q, (0, _round_up(n, _ALIGN) - n, 0, _round_up(k, _ALIGN) - k))
    return Int8Weight(q.contiguous(), scale[0], n)


def int8_matmul(xq: torch.Tensor, w: Int8Weight, *, rows_per_sample: int) -> torch.Tensor:
    """int8 [M, K] (M a multiple of ``rows_per_sample``) x the prepared
    kernel -> exact int32 [M, C_out]. K is zero-padded to the kernel's and
    each sample's rows to a multiple of 32; the padding is sliced off."""
    m, k = xq.shape
    r = rows_per_sample
    extra = _round_up(r, _ROW_ALIGN) - r
    kp = w.q.shape[0]
    if extra:
        xq = F.pad(xq.reshape(-1, r, k), (0, kp - k, 0, extra)).reshape(-1, kp)
    else:
        xq = F.pad(xq, (0, kp - k))
    int8_matmul.launches += 1
    y = torch._int_mm(xq, w.q)
    if extra:
        y = y.reshape(-1, r + extra, y.shape[1])[:, :r].reshape(m, -1)
    return y[:, :w.n]


int8_matmul.launches = 0


def _rescaled_product(x: torch.Tensor, xq: torch.Tensor, xs: torch.Tensor,
                      w: Int8Weight) -> torch.Tensor:
    rows = math.prod(x.shape[1:-1])
    y = int8_matmul(xq.reshape(-1, x.shape[-1]), w, rows_per_sample=rows)
    y = y.reshape(x.shape[:-1] + (w.n,))
    return (y.float() * (xs * w.scale)).to(x.dtype)


def pointwise_conv3d_int8(x: torch.Tensor, w: Int8Weight) -> torch.Tensor:
    """int8 1x1x1 conv with per-sample activation scales: x [B, ..., C_in]
    -> [B, ..., C_out] in x's dtype (drop-in for ``layers.pointwise_conv3d``
    at eval)."""
    xq, xs = quantize_act(x)
    return _rescaled_product(x, xq, xs, w)


def pointwise_conv3d_int8_static(x: torch.Tensor, w: Int8Weight,
                                 amax: torch.Tensor) -> torch.Tensor:
    """``pointwise_conv3d_int8`` with the calibrated range ``amax``."""
    xq, xs = quantize_act_static(x, amax)
    return _rescaled_product(x, xq, xs, w)
