"""Work of the benchmark's models from their shapes alone.

FLOPs follow ``torch.utils.flop_counter.FlopCounterMode``'s convention (the
count the program's ``utils/model_info.py`` reports): 2 per multiply-add,
matrix products and convolutions only, every kernel tap of every output
counted (taps on zero padding too), a transposed convolution as every
input-by-kernel product; elementwise work (BN, activations, pooling,
softmax, LayerNorm, the pair's difference) is left out. A CPU test holds
these sums against the counter over the plain reference.

The fused blocks' least time follows the bound rule of the port's kernel
table: for each stride-1, dim-preserving X3D block, the largest of its bytes
at the card's bandwidth (input read once, output written once, weights
once), its two 1x1 products at the bf16 tensor-core peak, and its 27
depthwise taps per output at the fp32 peak; the SE gate's sums are counted
once, with no recompute and no halo.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple

from benchmark.reference.change3d import round_width, stage_plan
from benchmark.work.peaks import H100


class Block(NamedTuple):
    """One X3D res-block at one sample: frames, output height and width,
    input, inner and output channels, spatial stride, SE width (0: none)."""

    t: int
    h: int
    w: int
    c_in: int
    c_inner: int
    c_out: int
    stride: int
    se: int


def blocks(cfg: dict) -> List[Block]:
    """Every res-block of the encoder's stages, in order, at one sample."""
    t = cfg["perception_frames"] + 2
    h = cfg["image_size"]
    out = []
    for s, depth, d_in, inner, d_out in stage_plan(cfg):
        h //= 2
        se = round_width(inner, cfg["se_ratio"])
        for b in range(depth):
            out.append(Block(t, h, h, d_in if b == 0 else d_out, inner, d_out,
                             2 if b == 0 else 1, se if b % 2 == 0 else 0))
    return out


def block_flops(b: Block) -> float:
    n_out, n_in = b.t * b.h * b.w, b.t * (b.h * b.stride) * (b.w * b.stride)
    f = 2.0 * n_in * b.c_in * b.c_inner            # conv_a at the input's size
    f += 2.0 * n_out * b.c_inner * 27              # depthwise 3x3x3
    f += 2.0 * n_out * b.c_inner * b.c_out         # conv_c
    if b.se:
        f += 2.0 * 2 * b.c_inner * b.se            # the SE gate's two products
    if b.stride > 1 or b.c_in != b.c_out:
        f += 2.0 * n_out * b.c_in * b.c_out        # projection shortcut
    return f


def stem_flops(cfg: dict) -> float:
    t, h, c = cfg["perception_frames"] + 2, cfg["image_size"], cfg["stem_dim"]
    return 2.0 * t * h * h * c * (3 * 9 + 5)


def encoder_flops(cfg: dict) -> float:
    """Stem, stages and (detection) the four difference convs, per pair."""
    f = stem_flops(cfg) + sum(block_flops(b) for b in blocks(cfg))
    if cfg["task"] != "cc":
        h = cfg["image_size"]
        for i, c in enumerate([cfg["stem_dim"]] + list(cfg["stage_dims"][:3])):
            f += 2.0 * (h >> i) ** 2 * c * c
    return f


def change_decoder_flops(cfg: dict) -> float:
    """The FPN change head per pair: three (1x1 reduce, 4x4 transposed
    stride-2 conv) up-blocks and the 3x3 output conv."""
    h = cfg["image_size"]
    d1, d2, d3, d4 = [cfg["stem_dim"]] + list(cfg["stage_dims"][:3])
    f = 0.0
    for i, (c_in, c_out) in enumerate(((d4, d3), (d3, d2), (d2, d1))):
        hin = h >> (3 - i)
        f += 2.0 * hin * hin * c_in * c_out          # reduce
        f += 2.0 * hin * hin * c_out * c_out * 16    # transposed conv
    return f + 2.0 * h * h * d1 * cfg["num_classes"] * 9


def detection_flops(cfg: dict) -> float:
    """One pair through the BCD forward."""
    return encoder_flops(cfg) + change_decoder_flops(cfg)


def memory_tokens(cfg: dict) -> int:
    return (cfg["image_size"] >> cfg["num_stages"]) ** 2


def caption_memory_kv_flops(cfg: dict) -> float:
    """Each layer's cross-attention keys and values, projected once per
    decode, per pair."""
    e = cfg["embed_dim"]
    return cfg["num_layers"] * 2 * 2.0 * memory_tokens(cfg) * e * e


def caption_step_flops(cfg: dict, cache_len: int) -> float:
    """One KV-cached decode step of one row: per layer the new token's q, k,
    v and output projections of self- and cross-attention, attention over
    the ``cache_len`` cached columns (all of them, masked or not) and over
    the memory; then the vocabulary projection."""
    e, s = cfg["embed_dim"], memory_tokens(cfg)
    per_layer = 2.0 * e * e * 4 + 2.0 * 2 * e * cache_len + 2.0 * e * e * 2 + 2.0 * 2 * e * s
    return cfg["num_layers"] * per_layer + 2.0 * e * cfg["vocab_size"]


def fused_blocks(cfg: dict) -> List[Block]:
    """The blocks the program runs fused at eval: stride 1, dims kept."""
    return [b for b in blocks(cfg) if b.stride == 1 and b.c_in == b.c_out]


def fused_block_least_s(b: Block, batch: int, act_bytes: int = 2) -> Dict[str, float]:
    """Least seconds of one fused block over ``batch`` samples, by bound."""
    n = batch * b.t * b.h * b.w
    weights = (2 * b.c_in * b.c_inner * act_bytes + 27 * b.c_inner * 4
               + 2 * b.c_inner * b.se * 4 + 6 * b.c_inner * 4)
    return {"bytes": (2 * n * b.c_in * act_bytes + weights) / H100["hbm_bytes_per_s"],
            "tensor": 4.0 * n * b.c_in * b.c_inner / H100["bf16_flops_per_s"],
            "fp32": 2.0 * 27 * n * b.c_inner / H100["fp32_flops_per_s"]}


def fused_least_s(cfg: dict, batch: int) -> float:
    """Least seconds of every fused block of one forward over ``batch``."""
    return sum(max(fused_block_least_s(b, batch).values()) for b in fused_blocks(cfg))
