"""Compute primitives on [B, T, H, W, C] / [B, H, W, C] activations.

Counterparts of ``change3d_tpu/ops/layers.py``. Kernels are in PyTorch's
layouts (conv3d: (O, I/groups, kt, kh, kw); conv2d: (O, I, kh, kw);
conv_transpose2d: (I, O, kh, kw), not flipped); 1x1x1 convs take an [I, O]
matrix and run as a matmul on the channel axis. Each op casts its weights to
the activation dtype, as the JAX ops do.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from change3d_tpu_torch.ops import depthwise_conv


def conv3d(
    x: torch.Tensor,
    kernel: torch.Tensor,
    *,
    stride: Sequence[int] = (1, 1, 1),
    padding: Sequence[int] = (0, 0, 0),
    groups: int = 1,
) -> torch.Tensor:
    """3D convolution. x: [B,T,H,W,C_in], kernel: [C_out, C_in/groups, kt, kh, kw]."""
    y = F.conv3d(
        x.permute(0, 4, 1, 2, 3), kernel.to(x.dtype),
        stride=tuple(stride), padding=tuple(padding), groups=groups,
    )
    return y.permute(0, 2, 3, 4, 1).contiguous()


def pointwise_conv3d(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """1x1x1 conv as a matmul. x: [..., C_in], kernel: [C_in, C_out].

    fp32 inputs multiply in full fp32 (TF32 is off, ``device.resolve_device``);
    bf16 products accumulate in fp32 and round once to bf16 on the way out,
    as ``preferred_element_type=f32`` followed by a cast does in JAX.
    """
    return torch.matmul(x, kernel.to(x.dtype))


def depthwise_conv3d(
    x: torch.Tensor,
    kernel: torch.Tensor,
    *,
    stride: Sequence[int] = (1, 1, 1),
    padding: Sequence[int] = (1, 1, 1),
) -> torch.Tensor:
    """Channelwise 3D conv. x: [B,T,H,W,C], kernel: [C, 1, kt, kh, kw].

    With no gradient to take (grad mode off, or neither x nor the kernel
    requiring one) this is the custom op ``c3d::depthwise_conv3d``
    (``ops/depthwise_conv.py``): the CUDA kernel for a CUDA x, the plain
    version for a CPU one. Otherwise ``F.conv3d(groups=C)``, since the
    kernel has no backward."""
    if torch.is_grad_enabled() and (x.requires_grad or kernel.requires_grad):
        return conv3d(x, kernel, stride=stride, padding=padding, groups=x.shape[-1])
    return depthwise_conv.depthwise_conv3d(x, kernel, stride=stride, padding=padding)


def conv2d(
    x: torch.Tensor,
    kernel: torch.Tensor,
    *,
    stride: Sequence[int] = (1, 1),
    padding: Sequence[int] = (0, 0),
) -> torch.Tensor:
    """2D convolution. x: [B,H,W,C_in], kernel: [C_out, C_in, kh, kw]."""
    if kernel.shape[2] == 1 and kernel.shape[3] == 1 and tuple(stride) == (1, 1):
        return pointwise_conv3d(x, kernel[:, :, 0, 0].t())
    y = F.conv2d(
        x.permute(0, 3, 1, 2), kernel.to(x.dtype), stride=tuple(stride), padding=tuple(padding)
    )
    return y.permute(0, 2, 3, 1).contiguous()


def conv_transpose2d(
    x: torch.Tensor,
    kernel: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    stride: int = 2,
    padding: int = 1,
) -> torch.Tensor:
    """PyTorch ConvTranspose2d. x: [B,H,W,C_in], kernel: [C_in, C_out, kh, kw]
    as torch stores it (not flipped)."""
    y = F.conv_transpose2d(
        x.permute(0, 3, 1, 2), kernel.to(x.dtype),
        None if bias is None else bias.to(x.dtype), stride=stride, padding=padding,
    )
    return y.permute(0, 2, 3, 1).contiguous()


def linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: [..., in], w: [in, out]. The product accumulates in fp32 and is
    rounded to x's dtype before the bias is added in that dtype, as JAX's
    ``dot_general(preferred_element_type=f32).astype(x.dtype) + b``."""
    y = torch.matmul(x, w.to(x.dtype))
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def se_gate(
    mean: torch.Tensor,
    w_reduce: torch.Tensor,
    b_reduce: torch.Tensor,
    w_expand: torch.Tensor,
    b_expand: torch.Tensor,
) -> torch.Tensor:
    """The SE excitation on an fp32 [B, C] squeeze: fc -> ReLU -> fc -> sigmoid."""
    h = torch.relu(mean @ w_reduce.float() + b_reduce.float())
    return torch.sigmoid(h @ w_expand.float() + b_expand.float())


def squeeze_excite_3d(
    x: torch.Tensor,
    w_reduce: torch.Tensor,
    b_reduce: torch.Tensor,
    w_expand: torch.Tensor,
    b_expand: torch.Tensor,
) -> torch.Tensor:
    """Squeeze-and-Excitation over (T, H, W); the squeeze runs in fp32.

    x: [B,T,H,W,C]; w_reduce: [C, C_r]; w_expand: [C_r, C].
    """
    gate = se_gate(x.float().mean(dim=(1, 2, 3)), w_reduce, b_reduce, w_expand, b_expand)
    return x * gate[:, None, None, None, :].to(x.dtype)
