"""Work of the X3D-L Kinetics classifier from its shapes alone, under
``flops.py``'s FLOP convention and fused-block bound.

Sizes follow the convolutions themselves: the stem's 3x3 conv at stride 2
and each stage's strided block 0 give ceil(n / 2) (312 -> 156 -> 78 -> 39 ->
20 -> 10), where ``flops.blocks`` halves with floor and counts a strided
block's conv_a at twice its output size. The head adds pre_conv at stage
4's size, post_conv and the projection once a clip.
"""

from __future__ import annotations

from typing import List, Tuple

from benchmark.reference.change3d import round_width, stage_plan
from benchmark.work import flops


def _half(n: int, stride: int) -> int:
    """Output size of a 3-tap conv with padding 1 at ``stride``."""
    return (n - 1) // stride + 1


def blocks(cfg: dict) -> List[Tuple[flops.Block, int]]:
    """(block at one clip, its input height and width) of every res-block."""
    t, h = cfg["frames"], _half(cfg["crop"], cfg["stem_stride"][1])
    out = []
    for s, depth, d_in, inner, d_out in stage_plan(cfg):
        se = round_width(inner, cfg["se_ratio"])
        for b in range(depth):
            stride = 2 if b == 0 else 1
            h_in, h = h, _half(h, stride)
            out.append((flops.Block(t, h, h, d_in if b == 0 else d_out, inner, d_out, stride,
                                    se if b % 2 == 0 else 0), h_in))
    return out


def block_flops(b: flops.Block, h_in: int) -> float:
    """``flops.block_flops`` with conv_a at the block's real input size."""
    return flops.block_flops(b) + 2.0 * b.t * (h_in ** 2 - (b.h * b.stride) ** 2) * (
        b.c_in * b.c_inner)


def stem_flops(cfg: dict) -> float:
    """The 1x3x3 conv over 3 channels and the 5-tap temporal conv, at the
    stem's output size."""
    h = _half(cfg["crop"], cfg["stem_stride"][1])
    return 2.0 * cfg["frames"] * h * h * cfg["stem_dim"] * (3 * 9 + 5)


def head_flops(cfg: dict) -> float:
    """pre_conv over stage 4's output, then post_conv and the projection on
    the pooled vector."""
    b = blocks(cfg)[-1][0]
    inner, head = cfg["stage_inner_dims"][-1], cfg["head_dim_out"]
    return 2.0 * (b.t * b.h * b.w * b.c_out * inner + inner * head + head * cfg["num_classes"])


def clip_flops(cfg: dict) -> float:
    """One clip through the classifier."""
    return stem_flops(cfg) + sum(block_flops(b, h) for b, h in blocks(cfg)) + head_flops(cfg)


def fused_blocks(cfg: dict) -> List[flops.Block]:
    """The blocks the program runs fused at eval: stride 1, dims kept."""
    return [b for b, _ in blocks(cfg) if b.stride == 1 and b.c_in == b.c_out]


def fused_least_s(cfg: dict, batch: int) -> float:
    """Least seconds of every fused block of one forward over ``batch``."""
    return sum(max(flops.fused_block_least_s(b, batch).values()) for b in fused_blocks(cfg))
