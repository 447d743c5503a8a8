"""Depthwise (channelwise) 3D convolution on channels-last activations
(inference): the CUDA kernel, its plain PyTorch version, and the custom op
``c3d::depthwise_conv3d`` that dispatches between them.

x [B, T, H, W, C] and a kernel [C, 1, kt, kh, kw] (PyTorch's grouped conv3d
layout) give [B, T', H', W', C], with any kernel size, stride and zero
padding. The weights are rounded to x's dtype, the products summed in fp32
and rounded once: ``conv3d(groups=C)`` as ``ops/layers.py`` computes it.

The op's CPU kernel is the plain version (``depthwise_conv3d_reference``:
permute, ``F.conv3d(groups=C)``, permute); its CUDA kernel launches
``csrc/depthwise_conv3d.cu`` on x's card and current stream, or raises
(non-contiguous x, a dtype other than fp32 or bf16, a shape no plan takes)
and counts its launches in ``depthwise_conv3d.launches``. The fake kernel
gives the output's shape, so ``torch.export`` keeps one graph node per
launch (``export.py``). The op has no backward: ``ops/layers.py`` routes a
call that needs a gradient to ``F.conv3d`` instead.

The kernel replaces cuDNN's grouped conv3d, which runs one launch per
channel with a layout conversion around each (X3D-L's stem and strided
block-0 convs took 64% of a BCD forward's device time on the H100 that way).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.flop_counter import register_flop_formula

from change3d_tpu_torch.ops import cuda_build

# Shared memory and threads a block may take: two blocks fit an SM.
SMEM_TARGET = 100 * 1024
MAX_THREADS = 512
# The shortest run of a pixel's channels worth staging as a chunk of channels.
MIN_SEGMENT = 64
# Blocks with fewer threads than this are a last resort.
MIN_THREADS = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def out_size(n: int, k: int, s: int, p: int) -> int:
    """Output length of a convolution of size k, stride s, padding p over n."""
    return (n + 2 * p - k) // s + 1


def vector_width(c: int, itemsize: int) -> int:
    """Channels a thread owns: the widest of 8, 4, 2, 1 that divides C and
    fits 16 bytes (8 bf16 or 4 fp32 where C allows)."""
    return next(v for v in (8, 4, 2, 1) if v * itemsize <= 16 and c % v == 0)


def _row_bytes(iw: int, cc: int, itemsize: int) -> int:
    """A staged row's bytes: iw pixels of cc channels rounded up to 16, and
    16 more for the row's offset modulo 16 (csrc/depthwise_conv3d.cu)."""
    return _ceil(iw * cc * itemsize, 16) * 16 + 16


def _chunks(c: int, vec: int, itemsize: int):
    """Channels per block: all of C, then (where a pixel's channels can be
    staged in pieces of the thread's vector, at least 4 bytes) ceil(C / n)
    rounded up to the vector, no shorter than MIN_SEGMENT bytes."""
    yield c
    if vec * itemsize < 4:
        return
    seen = {c}
    for n in range(2, c // vec + 1):
        cc = _ceil(_ceil(c, n), vec) * vec
        if cc * itemsize < MIN_SEGMENT:
            return
        if cc not in seen:
            seen.add(cc)
            yield cc


def _tiles(n: int):
    """Tile sides: powers of two up to the first that covers n."""
    side = 1
    while True:
        yield side
        if side >= n:
            return
        side *= 2


class DwPlan(NamedTuple):
    """How the kernel covers one call: ``vec`` channels per thread, blocks of
    ``tt`` output frames x ``oh`` x ``ow`` output pixels x ``cc`` channels,
    ``threads`` per block, the block's shared-memory bytes, and the blocks
    per sample."""

    vec: int
    tt: int
    oh: int
    ow: int
    cc: int
    threads: int
    smem: int
    blocks: int


def plan_depthwise(t: int, h: int, w: int, c: int, kernel_size: Sequence[int],
                   stride: Sequence[int], padding: Sequence[int], itemsize: int) -> DwPlan:
    """The kernel's plan for one call.

    Among the tiles whose block fits MAX_THREADS threads (one per output
    pixel and vector of channels) and SMEM_TARGET bytes (the staged input
    tile with its halo, the frames its outputs read clipped to the clip,
    and the taps' fp32 weights), the one that stages the fewest bytes over
    the whole call (halo and weights read again by each block), preferring
    blocks of MIN_THREADS threads or more; ties go to more threads.
    """
    kt, kh, kw = kernel_size
    st, sh, sw = stride
    pt, ph, pw = padding
    to, ho, wo = out_size(t, kt, st, pt), out_size(h, kh, sh, ph), out_size(w, kw, sw, pw)
    if min(to, ho, wo) < 1:
        raise ValueError(f"no output: T, H, W = {(t, h, w)}, kernel {tuple(kernel_size)}, "
                         f"stride {tuple(stride)}, padding {tuple(padding)}")
    vec = vector_width(c, itemsize)
    taps = kt * kh * kw
    best, best_key = None, None
    for tt in sorted({_ceil(to, n) for n in range(1, to + 1)}, reverse=True):
        nf = min((tt - 1) * st + kt, t)
        for oh in _tiles(ho):
            for ow in _tiles(wo):
                ih, iw = (oh - 1) * sh + kh, (ow - 1) * sw + kw
                for cc in _chunks(c, vec, itemsize):
                    threads = oh * ow * (cc // vec)
                    smem = nf * ih * _row_bytes(iw, cc, itemsize) + taps * cc * 4
                    if threads > MAX_THREADS or smem > SMEM_TARGET:
                        continue
                    blocks = _ceil(to, tt) * _ceil(ho, oh) * _ceil(wo, ow) * _ceil(c, cc)
                    staged = blocks * (nf * ih * iw * cc * itemsize + taps * cc * 4)
                    key = (threads < MIN_THREADS, staged, -threads)
                    if best_key is None or key < best_key:
                        best, best_key = DwPlan(vec, tt, oh, ow, cc, threads, smem, blocks), key
    if best is None:
        raise ValueError(f"no depthwise tile fits {MAX_THREADS} threads and {SMEM_TARGET} B of "
                         f"shared memory for T={t} H={h} W={w} C={c} kernel "
                         f"{tuple(kernel_size)} ({itemsize}-byte elements)")
    return best


_launch_plan = functools.lru_cache(maxsize=None)(plan_depthwise)


def depthwise_conv3d_reference(x: torch.Tensor, kernel: torch.Tensor, stride: Sequence[int],
                               padding: Sequence[int]) -> torch.Tensor:
    """Plain version: ``F.conv3d(groups=C)`` on [B, C, T, H, W], the weights
    cast to x's dtype, back to [B, T', H', W', C] contiguous."""
    y = F.conv3d(x.permute(0, 4, 1, 2, 3), kernel.to(x.dtype), stride=tuple(stride),
                 padding=tuple(padding), groups=x.shape[-1])
    return y.permute(0, 2, 3, 4, 1).contiguous()


def _out_shape(x, kernel, stride, padding) -> Tuple:
    b, t, h, w, c = x.shape
    kt, kh, kw = kernel.shape[2:]
    return (b, out_size(t, kt, stride[0], padding[0]), out_size(h, kh, stride[1], padding[1]),
            out_size(w, kw, stride[2], padding[2]), c)


_SCHEMA = "(Tensor x, Tensor kernel, int[] stride, int[] padding) -> Tensor"


_op = torch.library.custom_op("c3d::depthwise_conv3d", depthwise_conv3d_reference,
                              mutates_args=(), device_types="cpu", schema=_SCHEMA)


@_op.register_kernel("cuda")
def _cuda(x, kernel, stride, padding):
    if x.dtype not in _DTYPES:
        raise TypeError(f"depthwise_conv3d takes float32 or bfloat16, got {x.dtype}")
    if x.dim() != 5 or kernel.dim() != 5 or tuple(kernel.shape[:2]) != (x.shape[-1], 1):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)} [B,T,H,W,C], kernel "
                         f"{tuple(kernel.shape)} [C,1,kt,kh,kw]")
    if len(stride) != 3 or len(padding) != 3:
        raise ValueError(f"stride {stride} and padding {padding} take three values each")
    if not x.is_contiguous():
        raise ValueError("depthwise_conv3d takes a contiguous [B,T,H,W,C] x")
    b, t, h, w, c = x.shape
    ks = tuple(kernel.shape[2:])
    plan = _launch_plan(t, h, w, c, ks, tuple(stride), tuple(padding), x.element_size())
    x = cuda_build.aligned(x)
    wt = cuda_build.aligned(kernel.to(device=x.device, dtype=torch.float32))
    out = torch.empty(_out_shape(x, kernel, stride, padding), device=x.device, dtype=x.dtype)
    lib = cuda_build.load("depthwise_conv3d")
    with torch.cuda.device(x.device):
        err = lib.c3d_depthwise_conv3d(
            _DTYPES[x.dtype], x.data_ptr(), wt.data_ptr(), out.data_ptr(), b, t, h, w, c,
            *ks, *stride, *padding, plan.vec, plan.tt, plan.oh, plan.ow, plan.cc, plan.smem,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    cuda_build.check(lib, err, "depthwise_conv3d")
    depthwise_conv3d.launches += 1
    return out


@_op.register_fake
def _fake(x, kernel, stride, padding):
    return x.new_empty(_out_shape(x, kernel, stride, padding))


@register_flop_formula(torch.ops.c3d.depthwise_conv3d)
def _flops(x_shape, kernel_shape, stride, padding, *, out_shape=None, **kwargs) -> int:
    """FlopCounterMode's count for conv3d(groups=C): two per tap and output."""
    return 2 * out_shape[0] * out_shape[1] * out_shape[2] * out_shape[3] * out_shape[4] * (
        kernel_shape[2] * kernel_shape[3] * kernel_shape[4])


def depthwise_conv3d(x: torch.Tensor, kernel: torch.Tensor, *, stride: Sequence[int] = (1, 1, 1),
                     padding: Sequence[int] = (1, 1, 1)) -> torch.Tensor:
    """x [B,T,H,W,C], kernel [C,1,kt,kh,kw] -> [B,T',H',W',C]
    (``c3d::depthwise_conv3d``; no backward)."""
    return _op(x, kernel, [int(s) for s in stride], [int(p) for p in padding])


depthwise_conv3d.launches = 0
