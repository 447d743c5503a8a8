"""Parameter initializers with PyTorch's distributions, drawn from an
explicit ``torch.Generator`` (same semantics as ``change3d_tpu/init.py``).

The caller passes ``fan_in`` explicitly because the port stores weights in
several layouts; it is always input channels times the receptive field, as
torch computes it on its own (out, in, ...spatial) weights.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch


def _uniform(generator: torch.Generator, shape: Sequence[int], bound: float) -> torch.Tensor:
    return (torch.rand(tuple(shape), generator=generator) * 2.0 - 1.0) * bound


def torch_conv_kernel_init(generator, shape, fan_in: int) -> torch.Tensor:
    """torch default conv init: kaiming_uniform(a=sqrt(5)) == U(+-sqrt(1/fan_in))."""
    return _uniform(generator, shape, math.sqrt(1.0 / fan_in) if fan_in > 0 else 0.0)


def torch_conv_bias_init(generator, shape, fan_in: int) -> torch.Tensor:
    """torch default conv bias init: U(+-sqrt(1/fan_in)), the kernel's bound."""
    return torch_conv_kernel_init(generator, shape, fan_in)


def kaiming_normal_relu_init(generator, shape, fan_in: int) -> torch.Tensor:
    """kaiming_normal(mode=fan_in, nonlinearity=relu): std = sqrt(2 / fan_in)."""
    std = math.sqrt(2.0 / fan_in) if fan_in > 0 else 0.0
    return torch.randn(tuple(shape), generator=generator) * std


def normal_init(generator, shape) -> torch.Tensor:
    return torch.randn(tuple(shape), generator=generator)


def uniform_init(generator, shape, scale: float) -> torch.Tensor:
    """U(-scale, scale)."""
    return _uniform(generator, shape, scale)


def xavier_uniform_init(generator, shape, fan_in: int, fan_out: int) -> torch.Tensor:
    """Xavier/Glorot uniform: U(+-sqrt(6 / (fan_in + fan_out)))."""
    return _uniform(generator, shape, math.sqrt(6.0 / (fan_in + fan_out)))
