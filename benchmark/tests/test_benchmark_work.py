"""The work counted from shapes (benchmark/work) against torch's
FlopCounterMode over the plain reference, and the fused blocks' bound
against the port's kernel table."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.benchlib.manifest import Cell
from benchmark.reference.change3d import Change3DRef, make_params
from benchmark.work import flops


def _cfg(name, **kw):
    cfg = Cell(name).config
    cfg.update(kw)
    return cfg


def _counted(fn) -> float:
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        fn()
    return float(counter.get_total_flops())


@pytest.mark.parametrize("name,size", [("bcd-predict-b16", 64), ("cc-caption-b16", 64),
                                       ("bcd-predict-b16", 32)])
def test_forward_flops_match_the_counter(name, size):
    cfg = _cfg(name, image_size=size)
    ref = Change3DRef(cfg, make_params(cfg, 5, "cpu"))
    x = torch.zeros(1, size, size, 3)
    if cfg["task"] == "cc":
        counted = _counted(lambda: ref.memory(x, x))
        assert counted == flops.encoder_flops(cfg)
    else:
        assert _counted(lambda: ref.change_logits(x, x)) == flops.detection_flops(cfg)


def test_caption_step_flops_match_the_counter_over_the_program_step():
    from change3d_tpu_torch.models.caption_decoder import CaptionDecoder

    cfg = _cfg("cc-caption-b16", image_size=64)
    dec = CaptionDecoder(cfg["vocab_size"], cfg["embed_dim"], cfg["num_heads"],
                         cfg["num_layers"], generator=torch.Generator().manual_seed(0)).eval()
    s = flops.memory_tokens(cfg)
    memory = torch.zeros(3, s, cfg["embed_dim"])
    assert _counted(lambda: dec.precompute_memory_kv(memory)) == 3 * flops.caption_memory_kv_flops(
        cfg)
    kv = dec.precompute_memory_kv(memory)
    cache = dec.init_decode_cache(3, 52)
    tokens = torch.zeros(3, dtype=torch.long)
    assert _counted(lambda: dec.decode_step(tokens, kv, cache, 4)) == 3 * flops.caption_step_flops(
        cfg, 52)


def test_fused_blocks_and_their_bound():
    bcd, cc = _cfg("bcd-predict-b16"), _cfg("cc-caption-b16")
    # 37 fused launches per detection forward, 51 per caption encoder.
    assert len(flops.fused_blocks(bcd)) == 37 and len(flops.fused_blocks(cc)) == 51
    # The port's kernel table: bound 0.248 ms per BCD forward at batch 8, and
    # stage 1's row (0.0171 ms, the fp32 taps) per launch.
    assert flops.fused_least_s(bcd, 8) == pytest.approx(0.248e-3, rel=0.01)
    stage1 = flops.fused_blocks(bcd)[0]
    least = flops.fused_block_least_s(stage1, 8)
    assert max(least, key=least.get) == "fp32"
    assert least["fp32"] == pytest.approx(0.0171e-3, rel=0.01)
